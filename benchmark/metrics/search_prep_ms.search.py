"""Median of the server's ``search.vector.processing_before_engine``
timer: the query's trip through tensor_search and inference (its
embedding) before the engine."""

from harness.window import median


def read(window):
    return median(window.timers("search.vector.processing_before_engine"))
