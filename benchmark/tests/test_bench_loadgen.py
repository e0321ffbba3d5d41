"""The load generators against a stub server: the open loop times each
search from its due time (a stall counts against the searches behind it)
and keeps its lateness; the closed loop counts a request's refused
documents as failed."""

import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from conftest import BENCH

STALL_S = 0.4


def stub_server(handle):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            answer = json.dumps(handle(body)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(answer)))
            self.end_headers()
            self.wfile.write(answer)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def drive(generator: str, spec: dict, tmp_path, rounds: int = 1) -> dict:
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    child = subprocess.Popen(
        [sys.executable, os.path.join(BENCH, "loadgen", f"{generator}.py"),
         str(path)], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    for word in ["WARM"] * (rounds - 1) + ["GO"]:
        assert child.stdout.readline().strip() == "READY"
        child.stdin.write(word + "\n")
        child.stdin.flush()
    assert child.stdout.readline().strip() == "START"
    assert child.stdout.readline().strip() == "END"
    results = json.loads(child.stdout.readline())
    assert child.wait(timeout=60) == 0
    return results


def test_open_loop_times_from_the_due_time(tmp_path):
    seen = []

    def handle(body):
        seen.append(time.perf_counter())
        if len(seen) == 1 + 3:   # the first search after the warm-up stalls
            time.sleep(STALL_S)
        return {"hits": [{"_id": "a", "_score": 0.5}]}

    server = stub_server(handle)
    spec = {"port": server.server_address[1], "index": "x", "seed": 5,
            "seconds": 1.0, "vocabulary_words": 50, "telemetry": False,
            "traffic": {"rate": 20, "max_in_flight": 1, "warmup_requests": 3,
                        "request_timeout_s": 10,
                        "queries": {"query_lognormal": [1.8, 0.45],
                                    "query_words": [3, 16]},
                        "search": {"searchMethod": "TENSOR", "limit": 10}}}
    try:
        results = drive("open_search", spec, tmp_path)
    finally:
        server.shutdown()
    records = results["requests"]
    assert len(records) == 20
    first = records[0]
    behind = [r for r in records[1:] if r[1] < first[1] + STALL_S - 0.05]
    assert behind, "no search was due during the stall"
    for k, due, sent, done, status, ids, scores, timers in behind:
        # queued behind the stall: sent late, and the latency counts it
        assert sent - due > 0.05
        assert done - due >= first[1] + STALL_S - due - 0.01
    assert all(r[4] == 200 and r[5] == ["a"] for r in records)


def test_closed_loop_counts_refused_documents(tmp_path):
    def handle(body):
        docs = body["documents"]
        items = [{"_id": d["_id"], "status": 200} for d in docs]
        items[1] = {"_id": docs[1]["_id"], "status": 400, "error": "refused"}
        return {"errors": True, "items": items}

    server = stub_server(handle)
    spec = {"port": server.server_address[1], "index": "x", "seed": 5,
            "seconds": 0.5, "vocabulary_words": 50, "telemetry": False,
            "traffic": {"clients": 2, "docs_per_request": 4,
                        "tensor_fields": ["title", "body"],
                        "prebuilt_requests": 2, "warmup_requests": 2,
                        "request_timeout_s": 10,
                        "documents": {"kind": "text", "id_prefix": "d",
                                      "title_words": [4, 12],
                                      "body_lognormal": [4.1, 0.45],
                                      "body_clip": [16, 512],
                                      "sentence_words": [6, 30]}}}
    try:
        results = drive("closed_ingest", spec, tmp_path, rounds=2)
    finally:
        server.shutdown()
    # two warm-up rounds of two requests, one document refused in each
    assert results["warmup_rounds"] == 2
    assert results["warmup_failed_docs"] == 4
    requests = results["requests"]
    assert requests and all(r[6] == [1] and r[4] == 4 for r in requests)
    firsts = sorted(r[3] for r in requests)
    assert firsts == list(range(0, 4 * len(requests), 4))
    # the window opens once every client has had an answer: each client's
    # first request is the ramp's, sent a stagger apart, before it
    for c in (0, 1):
        first = min((r for r in requests if r[0] == c), key=lambda r: r[1])
        assert first[2] <= 0
    starts = sorted(min(r[1] for r in requests if r[0] == c) for c in (0, 1))
    assert starts[1] - starts[0] >= 0.9 * results["stagger_s"]
