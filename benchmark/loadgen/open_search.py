"""Open-loop search: ``POST /indexes/{i}/search`` at arrival times fixed in
advance (a Poisson process of ``rate`` per second, conditioned on its
count), whatever the server's pace. A dispatcher sleeps until each due
time and hands the request to a pool of ``max_in_flight`` sender threads;
each search is timed from its due time, so a stall also counts against
the searches queued behind it, and the dispatcher's lateness is kept.

Results: per search [query, due_s, sent_s, done_s, status, hit ids, hit
scores, server timers], seconds from the window's start.
"""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import common
from reference import corpus

# warm-up queries take query numbers from here on
WARMUP_QUERIES = 10 ** 7


def main():
    spec = common.read_spec()
    traffic = spec["traffic"]
    words = corpus.words(spec["seed"], spec["vocabulary_words"])
    path = f"/indexes/{spec['index']}/search" + \
        ("?telemetry=true" if spec["telemetry"] else "")
    due = corpus.arrivals(spec["seed"], traffic["rate"], spec["seconds"])

    def body(k: int) -> bytes:
        return json.dumps(dict(traffic["search"],
                               q=corpus.query(spec["seed"], k, words,
                                              traffic["queries"]))).encode()

    bodies = [body(k) for k in range(len(due))]
    client = common.Client(spec["port"], timeout=traffic["request_timeout_s"])

    def send(data: bytes) -> tuple:
        try:
            status, answer = client.post(path, data)
        except OSError:
            status, answer = 599, None
        ids, scores = [], []
        if status == 200 and isinstance(answer, dict):
            for hit in answer.get("hits", []):
                ids.append(hit.get("_id"))
                scores.append(hit.get("_score"))
        return status, ids, scores, common.telemetry(answer)

    warm = []

    def warm_round():
        first = WARMUP_QUERIES + len(warm)
        warm.extend([send(body(first + k))[0]
                     for k in range(traffic["warmup_requests"])])

    warm_round()
    common.handshake(warm_round)
    records = [None] * len(due)
    pool = ThreadPoolExecutor(max_workers=traffic["max_in_flight"])
    t0, wall0 = common.start()

    def run(k: int):
        sent = time.perf_counter() - t0
        status, ids, scores, timers = send(bodies[k])
        records[k] = [k, float(due[k]), sent, time.perf_counter() - t0,
                      status, ids, scores, timers]

    for k, at in enumerate(due):
        delay = t0 + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        pool.submit(run, k)
    time.sleep(max(0.0, t0 + spec["seconds"] - time.perf_counter()))
    print("END", flush=True)
    pool.shutdown(wait=True)
    common.finish({"kind": "open_search", "t0_wall": wall0,
                   "seconds": spec["seconds"], "requests": records,
                   "warmup_failed": sum(s != 200 for s in warm)})


if __name__ == "__main__":
    threading.current_thread().name = "dispatcher"
    main()
