"""Attention's share of its roofline in the image tower: the least time
the card could take for the attention of the window's acknowledged images
(ViT-L/14's 257 tokens, by the copied ``attention_bound``), over the
device time of the fused attention kernels (B2) in the trace. The caption
tower's causal attention runs in plain PyTorch and is not counted."""

from harness.work import attention_share

KERNELS = (r"attention_sm90_kernel", r"attention_tile_kernel")


def read(window):
    return attention_share(window, KERNELS)
