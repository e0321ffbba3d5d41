"""int8 quantized linear layers (W8A8) for the encoder (port of
marqo_tpu/ops/quant.py).

Scheme: per-output-channel symmetric weight scales (static, at load) ×
per-token dynamic activation scales (absmax); the int8 product accumulates
in int32 and a dequantizing fp32 epilogue follows. Opt-in via model
properties (``quantize: true``) or ``MARQO_TPU_QUANTIZE=int8``; the default
path stays bf16.

Weights keep ``nn.Linear``'s (out, in) layout here, where the JAX package
stores (in, out): the per-output-channel absmax runs over ``in``, which is
the last dim of (out, in) and of stacked (L, out, in) weights (axis 0 and 1
in the JAX layouts). Scales come back as (out,) and (L, out).

``int8_linear`` is kernel B3 (ops/quant_matmul.py): the hand-written CUDA
kernels on a CUDA device, their plain twin on the CPU.
"""

from typing import Tuple

import torch

from marqo_tpu_torch.ops.quant_matmul import (quantize_rows, w8a8_matmul,
                                              w8a8_matmul_reference)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weights → (out, in) int8 values + (out,) fp32 scales."""
    q, scale = quantize_rows(w.float())
    return q, scale[:, 0]


def quantize_stacked_weight(w: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, out, in) stacked layer weights → (L, out, in) int8 + (L, out)
    scales."""
    q, scale = quantize_rows(w.float())
    return q, scale[..., 0]


def _quantize_activations(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., in) activations → int8 + per-token scales (..., 1)."""
    return quantize_rows(x.float())


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ w_q (out, in)ᵀ with the dequantizing epilogue →
    (..., out) in x's dtype. ``bias`` is widened to fp32 (the JAX package
    casts it to the compute dtype first; pass it in that dtype)."""
    return _linear(w8a8_matmul, x, w_q, w_scale, bias)


def int8_linear_reference(x: torch.Tensor, w_q: torch.Tensor,
                          w_scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """``int8_linear`` on B3's plain twin, on any device."""
    return _linear(w8a8_matmul_reference, x, w_q, w_scale, bias)


def _linear(matmul, x, w_q, w_scale, bias) -> torch.Tensor:
    K, N = x.shape[-1], w_q.shape[0]
    out = matmul(x.reshape(-1, K).contiguous(), w_q, w_scale.float(),
                 bias.float())
    return out.reshape(*x.shape[:-1], N)
