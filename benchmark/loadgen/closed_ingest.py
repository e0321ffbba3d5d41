"""Closed-loop bulk ingest: ``clients`` threads, each sending
``POST /indexes/{i}/documents`` with ``docs_per_request`` new documents
and waiting for the reply before its next. Requests take documents in
order (request r holds documents r x n ... r x n + n - 1), so the same
seed sends the same documents.

Image documents point at a localhost HTTP server in this process that
serves the pool's JPEGs from memory; every document has a URL of its own.

Results: per request [client, sent_s, done_s, first_doc, n_docs, status,
failed positions, server timers], seconds from the window's start; the
requests of the ramp before it have negative times.
"""

import json
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import common
from reference import corpus, images

# warm-up requests take document numbers from this request on
WARMUP_REQUESTS = 10 ** 7


def image_server(seed: int, pool: int):
    """The pool's JPEGs behind http://127.0.0.1:<port>/<seed>/<doc>/<i>.jpg."""
    with ThreadPoolExecutor(max_workers=4) as workers:
        blobs = list(workers.map(lambda i: images.jpeg(seed, i), range(pool)))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            try:
                index = int(self.path.rsplit("/", 1)[1].split(".")[0])
                body = blobs[index]
            except (ValueError, IndexError):
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def main():
    spec = common.read_spec()
    traffic = spec["traffic"]
    words = corpus.words(spec["seed"], spec["vocabulary_words"])
    n = traffic["docs_per_request"]
    image_srv, base_url = None, ""
    if traffic["documents"]["kind"] == "image_caption":
        image_srv, base_url = image_server(spec["seed"],
                                           traffic["documents"]["image_pool"])
    path = f"/indexes/{spec['index']}/documents" + \
        ("?telemetry=true" if spec["telemetry"] else "")
    fields = traffic["tensor_fields"]

    def body(r: int) -> bytes:
        docs = [common.make_document(spec, words, r * n + j, base_url)
                for j in range(n)]
        return json.dumps({"documents": docs,
                           "tensorFields": fields}).encode()

    # the window's first requests, built while the warm-up runs
    bodies = queue.Queue()
    prebuild = threading.Thread(target=lambda: [
        bodies.put((r, body(r))) for r in range(traffic["prebuilt_requests"])])
    prebuild.start()
    next_request = [traffic["prebuilt_requests"]]
    lock = threading.Lock()

    def take():
        try:
            return bodies.get_nowait()
        except queue.Empty:
            with lock:
                r = next_request[0]
                next_request[0] += 1
            return r, body(r)

    client = common.Client(spec["port"], timeout=traffic["request_timeout_s"])

    def send(data: bytes) -> tuple:
        """(status, failed positions, server timers) of one request."""
        try:
            status, answer = client.post(path, data)
        except OSError as e:
            status, answer = 599, {"error": str(e)}
        failed = list(range(n))
        if status == 200 and isinstance(answer, dict):
            items = answer.get("items", [])
            failed = [j for j, item in enumerate(items)
                      if item.get("status", 200) >= 400 or "error" in item]
            failed += list(range(len(items), n))
        return status, failed, common.telemetry(answer)

    # set-up: rounds of the same mix, as many clients at once, from
    # documents the window never sends; the first request alone, as it
    # loads the model
    rounds = [0]
    latency = []

    def warm_one(r: int) -> int:
        sent = time.perf_counter()
        failed = len(send(body(WARMUP_REQUESTS + r))[1])
        latency.append(time.perf_counter() - sent)
        return failed

    def warm() -> int:
        count = traffic["warmup_requests"]
        numbers = list(range(rounds[0] * count, (rounds[0] + 1) * count))
        failed = 0
        if rounds[0] == 0:
            failed = len(send(body(WARMUP_REQUESTS + numbers.pop(0)))[1])
        rounds[0] += 1
        del latency[:]
        with ThreadPoolExecutor(max_workers=traffic["clients"]) as pool:
            return failed + sum(pool.map(warm_one, numbers))

    warm_failed = [warm()]
    common.handshake(lambda: warm_failed.append(warm()))
    prebuild.join()

    # the clients start a mean request apart over one request's time, and
    # the window opens once each has had an answer, so that it starts
    # with their requests spread as they run on, not all sent at once
    clients = traffic["clients"]
    stagger = sum(latency) / max(1, len(latency)) / clients
    records, answered = [], set()
    ramped = threading.Event()
    end = [float("inf")]

    def run(c: int):
        time.sleep(c * stagger)
        while time.perf_counter() < end[0]:
            r, data = take()
            sent = time.perf_counter()
            status, failed, timers = send(data)
            records.append([c, sent, time.perf_counter(), r * n, n,
                            status, failed, timers])
            answered.add(c)
            if len(answered) == clients:
                ramped.set()

    threads = [threading.Thread(target=run, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    ramped.wait(timeout=traffic["request_timeout_s"])
    t0, wall0 = common.start()
    end[0] = t0 + spec["seconds"]
    time.sleep(max(0.0, end[0] - time.perf_counter()))
    print("END", flush=True)
    for t in threads:
        t.join()
    for record in records:
        record[1] -= t0
        record[2] -= t0
    if image_srv is not None:
        image_srv.shutdown()
    common.finish({"kind": "closed_ingest", "t0_wall": wall0,
                   "base_url": base_url,
                   "seconds": spec["seconds"], "requests": records,
                   "warmup_failed_docs": sum(warm_failed),
                   "warmup_rounds": rounds[0], "stagger_s": stagger,
                   "built_in_window": next_request[0] -
                   traffic["prebuilt_requests"]})


if __name__ == "__main__":
    main()
