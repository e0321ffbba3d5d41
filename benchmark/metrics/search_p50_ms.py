"""Median latency of every search due in the window, from its due time on
the arrival schedule; a failed search counts as the search timeout."""

from harness.latency import search_latencies_ms, percentile


def read(window):
    return percentile(search_latencies_ms(window), 50)
