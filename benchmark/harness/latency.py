"""Latency of the open loop's searches, as the end-to-end metrics take it."""

import numpy as np

# MARQO_SEARCH_TIMEOUT_MS: a failed search enters the tail at this
FAILED_MS = 1000.0


def search_latencies_ms(window) -> list:
    out = []
    for k, due, sent, done, status, ids, scores, timers in window.in_window():
        out.append((done - due) * 1e3 if status == 200 else FAILED_MS)
    return out


def percentile(values, q: float):
    return float(np.percentile(values, q)) if values else None
