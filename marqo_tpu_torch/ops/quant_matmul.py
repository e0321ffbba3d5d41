"""Fused W8A8 linear layer (kernel B3): the hand-written CUDA kernels
(``csrc/w8a8_matmul.cu``) and their plain PyTorch twin.

Port of marqo_tpu/ops/quant_matmul.py, whose Pallas TPU kernel
``_w8a8_kernel`` this replaces. For x (M, K) fp32 or bf16, w_q (N, K) int8
in ``nn.Linear``'s (out, in) layout, w_scale (N,) fp32 and bias (N,) fp32:
each row of x is quantized by its absmax over the whole row
(x_scale = max(absmax / 127, 1e-8), x_q = clip(round(x / x_scale), ±127),
rounding half to even), the int8 product accumulates exactly in int32, and
the fp32 epilogue is (acc · x_scale) · w_scale + bias, written in x's dtype.
The kernels round every step as the twin does, so their output equals the
twin's bit for bit.

The TPU kernel's tiling rule (M % 256, N % 512) is gone: the CUDA kernels
mask their own edges, so M and N are any positive size and K any multiple
of 16 up to ``MAX_K`` (127 · 127 · 131072 < 2³¹, so the int32 sum cannot
overflow). The quantized encoder pads a K that is not a multiple of 16
with zero columns when it loads (models/bert.py ``Int8Linear``). The CUDA path is two launches, a one-read row quantizer then
the int8 GEMM on Hopper's warpgroup MMA fed by TMA, with the quantized rows
in scratch the wrapper allocates.

Routing: a tensor on the CPU takes the plain twin; a tensor on a CUDA
device launches the kernels or raises. ``LAUNCHES["w8a8"]`` counts kernel
launches (one per call, for the pair).
"""

from typing import Tuple

import torch

from marqo_tpu_torch.ops import _build, launches

MAX_K = 131072
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches (plain ints; the twin never counts; ops/launches.py adds
# to them, replays of a CUDA graph too)
LAUNCHES = {"w8a8": 0}


def quantize_rows(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last dim of an fp32 tensor:
    (..., K) → (..., K) int8 values and (..., 1) fp32 scales.

    127 is a tensor, not a Python scalar: on a CUDA device torch divides by
    a scalar as a multiply by its reciprocal, which can round the scale one
    ulp away from the true quotient that the kernel and the JAX package
    compute."""
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax / torch.full_like(absmax, 127.0), 1e-8)
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x (M, K) float → (M, N) in x's dtype. w_q (N, K) int8, w_scale (N,)
    fp32, bias (N,) fp32."""
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, w_q, w_scale, bias)
    return _launch(x, w_q, w_scale, bias)


def check_kernel_inputs(x, w_q, w_scale, bias) -> None:
    """Raise ValueError unless the kernel takes these tensors (device
    aside): fp32/bf16 x (M, K), int8 w_q (N, K), fp32 w_scale and bias
    (N,), all contiguous and 16-byte aligned, M >= 1, N >= 1, K a multiple
    of 16 up to MAX_K."""
    if x.dtype not in DTYPES:
        raise ValueError(f"w8a8 matmul: x must be fp32 or bf16, got "
                         f"{x.dtype}")
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"w8a8 matmul: x and w_q must be 2-D, got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}")
    M, K = x.shape
    N = w_q.shape[0]
    if w_q.dtype != torch.int8 or w_q.shape[1] != K:
        raise ValueError(f"w8a8 matmul: w_q must be int8 (N, {K}), got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (N,):
            raise ValueError(f"w8a8 matmul: {name} must be fp32 ({N},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if M < 1 or N < 1 or K < 16 or K % 16 or K > MAX_K:
        raise ValueError(f"w8a8 matmul: M={M}, N={N} (each >= 1), K={K} (a "
                         f"multiple of 16 up to {MAX_K}) not supported")
    tensors = (x, w_q, w_scale, bias)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("w8a8 matmul: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("w8a8 matmul: inputs must be 16-byte aligned")


def _launch(x, w_q, w_scale, bias) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"w8a8 matmul: unsupported device {x.device}")
    if any(t.device != x.device for t in (w_q, w_scale, bias)):
        raise ValueError("w8a8 matmul: x, w_q, w_scale and bias must share "
                         "a device")
    check_kernel_inputs(x, w_q, w_scale, bias)
    M, K = x.shape
    N = w_q.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    # the quantized rows (M, K) int8, then their (M,) fp32 scales, in one
    # allocation (at a query's size allocations are a large part of a
    # call's host time); M K is a multiple of 16, so the scales stay
    # 16-byte aligned
    scratch = torch.empty((M * K + 4 * M,), dtype=torch.uint8,
                          device=x.device)
    x_q = scratch.data_ptr()
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.marqo_w8a8_matmul(
            x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), x_q, x_q + M * K, M, K, N,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a8 matmul kernel launch failed: CUDA error "
                           f"{err}")
    launches.count(launches.Launch(LAUNCHES, "w8a8", None, None,
                                   "w8a8_matmul", (M, K, N)))
    return out


# --- plain twin ---------------------------------------------------------------

def w8a8_matmul_reference(x, w_q, w_scale, bias) -> torch.Tensor:
    """Plain PyTorch twin of the kernels. The int8 product runs in float64,
    which holds these integer sums exactly (torch's int8 matmul would wrap
    around in int8), then the epilogue runs in fp32 in the kernel's
    order."""
    x_q, x_scale = quantize_rows(x.float())
    acc = (x_q.double() @ w_q.double().T).float()
    return (acc * x_scale * w_scale + bias).to(x.dtype)
