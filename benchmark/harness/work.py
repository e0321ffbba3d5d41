"""Work that the window's acknowledged documents need, at published
widths, from the reference's own chunks and token counts (never the
program's buckets or padding), as shares of the card's peak and of the
attention kernels' time."""

import re

from reference.bounds import PEAK_BF16_FLOPS


def _work(window) -> tuple:
    reference = window.reference()
    fields = window.traffic["tensor_fields"]
    ops = attention_s = 0.0
    for k in window.acknowledged():
        o, a = reference.work(window.document(k), fields)
        ops += o
        attention_s += a
    return ops, attention_s


def model_share(window):
    """Per cent of the bf16 peak over the window's seconds."""
    ops, _ = _work(window)
    return 100.0 * ops / (window.seconds * PEAK_BF16_FLOPS) if ops else None


def attention_share(window, patterns):
    """Per cent of the attention kernels' device time that their least time
    is. A trace in which no kernel matches ``patterns`` is an error."""
    if window.trace is None or not window.trace.device_ops:
        return None
    matcher = re.compile("|".join(patterns))
    kernel_s = sum(s for name, s in window.trace.seconds_by_name().items()
                   if matcher.search(name))
    if not kernel_s:
        raise RuntimeError(f"no device operation matches {patterns} in the "
                           f"trace")
    _, attention_s = _work(window)
    return 100.0 * attention_s / kernel_s
