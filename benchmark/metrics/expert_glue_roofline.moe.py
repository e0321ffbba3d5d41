"""The expert layer's elementwise passes' share of their roofline: for each
add completed in the window, the least bytes the SwiGLU and combine passes
must move for its acknowledged documents' real tokens at the published
widths, over 3.35 TB/s, summed, over the device time of the two passes'
kernels in the trace (``moe_swiglu_kernel``, ``moe_combine_kernel``,
matched by name).

A real token's bytes, in bf16: in each MoE layer its k routed SwiGLU rows
(gate and up read, the product written: 3 F values each), the shared
experts' SwiGLU row (3 n_shared F values), and its combine (k rows of H
read, its int32 rows and fp32 weights read, H written); in each dense
layer its SwiGLU row (3 intermediate values). Pad tokens count nothing, so
the share stays under 100% whatever the passes do with them. Tokens are
counted through the reference's per-chunk lengths, as ``expert_work``
counts them. None where the trace holds no such kernel (a program without
the passes)."""

import re

from reference.bounds import PEAK_BYTES_PER_S

KERNELS = re.compile(r"moe_swiglu_kernel|moe_combine_kernel")


def token_bytes(c: dict) -> float:
    """The passes' least bytes for one real token through the model."""
    H, F, k = c["hidden_size"], c["moe_intermediate_size"], \
        c["num_experts_per_tok"]
    shared = (c.get("n_shared_experts") or 0) * F
    dense = c["first_k_dense_replace"]
    moe_layers = c["num_hidden_layers"] - dense
    swiglu = 2 * 3 * (k * F + shared)
    combine = 2 * (k + 1) * H + 8 * k
    return moe_layers * (swiglu + combine) + \
        dense * 2 * 3 * c["intermediate_size"]


def read(window):
    trace = window.trace
    if trace is None or not trace.device_ops:
        return None
    kernel_s = sum(s for name, s in trace.seconds_by_name().items()
                   if KERNELS.search(name))
    if not kernel_s:
        return None
    reference = window.reference()
    fields = window.traffic["tensor_fields"]
    per_token = token_bytes(reference.c)
    tokens = sum(sum(reference._lengths(window.document(k), fields))
                 for k in window.acknowledged())
    return 100.0 * tokens * per_token / PEAK_BYTES_PER_S / kernel_s
