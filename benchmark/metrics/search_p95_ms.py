"""95th percentile of the same latencies as ``search_p50_ms``."""

from harness.latency import search_latencies_ms, percentile


def read(window):
    return percentile(search_latencies_ms(window), 95)
