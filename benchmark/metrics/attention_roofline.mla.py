"""Latent attention's share of its roofline: the least time the card could
take for the causal attention the window's acknowledged documents need
(each chunk's, per layer, at 16 heads, q/k head dim 192 and v head dim 128:
q, k, v and the output moved once against the S(S+1)/2 pairs' two
products, the larger), over the device time of kernel B1's causal
instances in the trace. No matching kernel is an error."""

from harness.work import attention_share

KERNELS = (r"CausalSegmentMask", r"CausalPaddingMask")


def read(window):
    return attention_share(window, KERNELS)
