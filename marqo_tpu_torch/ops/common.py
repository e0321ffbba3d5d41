"""Shared elementwise / normalization ops for encoders (port of
marqo_tpu/ops/common.py).

LayerNorm statistics, pooling and L2 normalization run in fp32 whatever
the compute dtype (bf16 on the tensor cores), as in the JAX package.
"""

import contextlib
import threading

import torch
import torch.nn.functional as F

_fp32_conv_lock = threading.Lock()
_fp32_conv_state = {"depth": 0, "saved": None}


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in full fp32 while the block runs. PyTorch lets
    cuDNN use TF32 by default, whose 10-bit mantissa moves the fp32
    detectors' outputs past the 1e-3 their fp32 reference holds them to.
    The flag is process-wide: blocks in concurrent threads count themselves
    in, and the last one out restores the setting the first one found."""
    with _fp32_conv_lock:
        if _fp32_conv_state["depth"] == 0:
            _fp32_conv_state["saved"] = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _fp32_conv_state["depth"] += 1
    try:
        yield
    finally:
        with _fp32_conv_lock:
            _fp32_conv_state["depth"] -= 1
            if _fp32_conv_state["depth"] == 0:
                torch.backends.cudnn.allow_tf32 = _fp32_conv_state["saved"]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics: torch's fused
    kernel accumulates bf16 inputs in fp32 and normalizes in fp32 before
    the cast back, in one pass over the activations."""
    return F.layer_norm(x, x.shape[-1:], scale.to(x.dtype),
                        bias.to(x.dtype), eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — matches HF BERT's default ``gelu`` activation."""
    return F.gelu(x, approximate="none")


ACTIVATIONS = {
    "gelu": gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "tanh": torch.tanh,
}


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize in fp32 (embedding outputs must be stable across dtypes)."""
    x32 = x.float()
    norm = torch.linalg.vector_norm(x32, dim=dim, keepdim=True)
    return x32 / norm.clamp_min(eps)


def masked_mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean-pool token states with an attention mask.

    Parity: reference HuggingFaceModel mean pooling
    (core/inference/embedding_models/hugging_face_model.py:163-210).

    hidden: (B, S, H); mask: (B, S) with 1 for real tokens.
    """
    m = mask.float().unsqueeze(-1)
    summed = (hidden.float() * m).sum(dim=1)
    counts = m.sum(dim=1).clamp_min(1e-9)
    return summed / counts


def cls_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """CLS pooling (first token)."""
    del mask
    return hidden[:, 0, :].float()
