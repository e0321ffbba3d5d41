"""Median of the server's ``search.vector.engine`` timer: the engine's
HNSW search over both fields and the hits' assembly."""

from harness.window import median


def read(window):
    return median(window.timers("search.vector.engine"))
