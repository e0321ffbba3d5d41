"""What the load generators share: the handshake with the harness, one
keep-alive connection per client thread, and the documents of a traffic
mix by number.

A generator is a child process of the run, started as
``python benchmark/loadgen/<kind>.py SPEC_FILE``. It prepares its inputs,
sends a round of warm-up requests and prints ``READY``; on ``WARM`` it
sends another round and prints ``READY`` again (the run asks for rounds
until one captures no new graph in the server). On ``GO`` it starts its
load, prints ``START`` when the window opens, measures for ``seconds``,
prints ``END`` when the window closes, waits for the requests still out,
and prints one JSON line of results.
"""

import http.client
import json
import os
import sys
import threading
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import corpus  # noqa: E402


def read_spec() -> dict:
    with open(sys.argv[1]) as f:
        return json.load(f)


def handshake(warm) -> None:
    """READY after each warm-up round; ``warm()`` runs the next round on
    WARM, and GO returns."""
    while True:
        print("READY", flush=True)
        line = sys.stdin.readline().strip()
        if line == "GO":
            return
        if line != "WARM":
            raise SystemExit(f"expected WARM or GO, got {line!r}")
        warm()


def start() -> tuple:
    """Opens the window: START to the run; (perf_counter, wall) now."""
    t0, wall0 = time.perf_counter(), time.time()
    print("START", flush=True)
    return t0, wall0


def finish(results: dict) -> None:
    print(json.dumps(results, separators=(",", ":")), flush=True)


class Client:
    """One keep-alive HTTP connection per thread to the server."""

    def __init__(self, port: int, timeout: float):
        self.port, self.timeout = port, timeout
        self.local = threading.local()

    def post(self, path: str, body: bytes):
        """(status, decoded answer or None)."""
        for attempt in (0, 1):
            conn = getattr(self.local, "conn", None)
            if conn is None:
                conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                  timeout=self.timeout)
                self.local.conn = conn
            try:
                conn.request("POST", path, body=body,
                             headers={"Content-Type": "application/json"})
                response = conn.getresponse()
                raw = response.read()
                try:
                    answer = json.loads(raw) if raw else None
                except ValueError:
                    answer = None
                return response.status, answer
            except (http.client.HTTPException, ConnectionError, OSError):
                conn.close()
                self.local.conn = None
                if attempt:
                    raise
        raise AssertionError("unreachable")


def make_document(spec: dict, words: list, k: int, image_url: str = ""):
    """Document ``k`` of the mix ``spec["traffic"]["documents"]``."""
    docs = spec["traffic"]["documents"]
    if docs["kind"] == "text":
        return corpus.text_document(spec["seed"], k, words, docs)
    if docs["kind"] == "image_caption":
        return corpus.image_document(spec["seed"], k, words, docs, image_url)
    raise ValueError(f"unknown document kind {docs['kind']}")


def telemetry(answer) -> dict:
    """The server's timers of one answer (``?telemetry=true``), or {}."""
    if isinstance(answer, dict):
        return answer.get("telemetry", {}).get("timesMs", {})
    return {}
