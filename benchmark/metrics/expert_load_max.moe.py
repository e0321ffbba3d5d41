"""How evenly the router spreads tokens: over the traced adds inside the
window, the tokens routed to the busiest (MoE layer, routed expert) over
the mean of all of them (1.0 is even). Read from the program's count log
(``marqo_tpu_torch.api.telemetry.counts("moe.expert_tokens")``: per
traced add, each (layer, expert)'s tokens, read from the device at the
add's device wait); None where the program keeps no such log."""

import numpy as np

from harness import spans


def read(window):
    try:
        from marqo_tpu_torch.api import telemetry
    except ImportError:
        return None
    counts = getattr(telemetry, "counts", None)
    trace = window.trace
    if counts is None or trace is None or \
            not (trace.device_ops or trace.host_ops):
        return None
    first, last = spans.bounds(trace)
    entries = [e.values for e in counts("moe.expert_tokens")
               if first <= e.time_ns <= last]
    if not entries:
        return None
    total = np.sum(entries, axis=0).astype(np.float64)
    if not total.sum():
        return None
    return float(total.max() / total.mean())
