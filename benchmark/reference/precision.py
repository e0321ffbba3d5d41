"""The precision a reference forward computes its matrix products in.

"float32" is the reference: float32 with TF32 off. "fp8" is the control a
step below bfloat16: both operands of every matrix product rounded to
float8 e4m3, the weight scaled per output row and the activation per
token, each so that its largest magnitude maps to e4m3's largest (448),
then multiplied in float32.
"""

import torch

E4M3_MAX = 448.0


def float32_only() -> None:
    """Keeps float32 products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
           precision: str = "float32") -> torch.Tensor:
    """x (..., in) by weight (out, in), plus bias."""
    if precision == "fp8":
        x, weight = _fp8(x), _fp8(weight)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision}")
    out = x @ weight.T
    return out if bias is None else out + bias
