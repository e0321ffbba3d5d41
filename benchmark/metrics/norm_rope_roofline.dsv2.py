"""DeepSeek-V2's norm and RoPE passes' share of their roofline: for each add
completed in the window, the least bytes the passes must move for its
acknowledged documents' real tokens at the published widths, over 3.35
TB/s, summed, over the device time of the two passes' kernels in the trace
(``marqo_decoder::add_rms_norm_kernel``, ``marqo_decoder::mla_rope_kernel``,
matched by name).

A real token's bytes, in bf16, through L layers of hidden H, N heads, a
latent of width R, q/k no-RoPE and RoPE widths n and r:
- the norms over H: 2 L - 1 that read the stream and the branch output
  and write the sum and the normed row (8 H: layer 0's post norm, layers
  1 to L - 1's input and post norms), layer 0's input norm (4 H: read,
  write), the final norm, whose sum nothing reads (6 H): 434 H at L = 27;
- the latent norm, each layer: R read and written;
- RoPE and k, each layer: q's RoPE part read and written (N r each way),
  the no-RoPE keys read (N n), the shared RoPE key read (r), k written
  (N (n + r)).
Pad tokens count nothing, so the share stays under 100% whatever the
passes do with them. Tokens are counted through the reference's per-chunk
lengths, as ``expert_work`` counts them. None where the trace holds no such
kernel (a program without the passes)."""

import re

from reference.bounds import PEAK_BYTES_PER_S

KERNELS = re.compile(r"marqo_decoder::(add_rms_norm|mla_rope)_kernel")


def token_bytes(c: dict) -> float:
    """The passes' least bytes for one real token through the model."""
    H, L, N = c["hidden_size"], c["num_hidden_layers"], \
        c["num_attention_heads"]
    R, n, r = c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    norms = 2 * H * ((2 * L - 1) * 4 + 2 + 3)
    latent = L * 2 * 2 * R
    rope = L * 2 * (2 * N * r + N * n + r + N * (n + r))
    return norms + latent + rope


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
