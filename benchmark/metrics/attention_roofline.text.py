"""Attention's share of its roofline: the least time the card could take
for the attention that the window's acknowledged documents need (each
chunk's unmasked attention at published widths, by the copied
``attention_bound``), over the device time of the attention kernels in the
trace. The kernels are the hand-written attention tile loops (B1, B2)."""

from harness.work import attention_share

KERNELS = (r"attention_sm90_kernel", r"attention_tile_kernel")


def read(window):
    return attention_share(window, KERNELS)
