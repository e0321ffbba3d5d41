"""Masked softmax attention for encoder stacks: the hand-written CUDA kernel
(``csrc/masked_attention.cu``) and its plain PyTorch twin.

Port of marqo_tpu/ops/flash_attention.py, whose Pallas TPU kernel
``_attention_kernel`` this kernel replaces. Masking is computed in-kernel
from compact inputs:

  - padding mask (B, S): ragged batches; key j is allowed iff mask[j] > 0
  - segment ids (B, S): packed batches (ops/packing.py); block-diagonal,
    key j is allowed iff seg[i] == seg[j] and seg[j] > 0
  - either with ``causal=True`` (decoder embedders): key j is also
    disallowed where j > i, so a packed segment is causal inside itself and
    a right-padded row causal over its tokens. The causal instances take
    DeepSeek-V2's latent attention widths alone (``CAUSAL_HEAD_DIMS``: q and
    k 192, v 128, so the output is (B, N, S, 128)), on the mma.sync loop in
    bf16 and the FMA loop in fp32; the caller may give the softmax
    ``scale`` (YaRN scales it).

Scores are q.k^T / sqrt(D) in fp32, disallowed scores are the finite
-1e9 (a fully masked row averages V uniformly, never NaN), softmax runs in
fp32 and probs.v accumulates in fp32; output is in the input dtype.

On Hopper the TPU kernel's one-program-per-(batch, head) design does not
fit: its (S, S) fp32 score tile is 1 MB at S = 512, against 227 KB of
shared memory per block. The CUDA kernel tiles queries by 64 or 128 and
loops over 64-key tiles with an online softmax, so shared memory stays at
the tile size and scores never reach device memory. Three tile loops:
bf16 on Hopper's warpgroup MMA fed by TMA (``"wgmma"``,
csrc/attention_tile_sm90.cuh) or on mma.sync fed by cp.async
(``"mma_sync"``, csrc/attention_tile.cuh), both skipping key tiles the
mask rules out; fp32 on an exact FMA loop (``"fma"``). ``tile_loop`` picks
one from the shape.

Layout: q, k and v may be any (B, N, S, D) views whose last axis is
contiguous, such as the projections' ``x.view(B, S, N, D).transpose(1,
2)``; the kernel reads them through their strides and writes its output
as a (B, N, S, D) view of a (B, S, N, D) tensor, so the caller's
``ctx.transpose(1, 2).reshape(B, S, H)`` is a view, not a copy.

Routing: a tensor on the CPU takes the plain twin; a tensor on a CUDA
device launches the kernel or raises. ``LAUNCHES`` counts kernel
launches per mode, ``LOOP_LAUNCHES`` per tile loop.
"""

import ctypes
import math

import torch

from marqo_tpu_torch.ops import _build, launches

_MASKED_SCORE = -1e9  # finite: fully masked rows softmax to uniform

MAX_SEQ_LEN = 512
# every multiple of 8 up to 128, as ops/fused_attention.py's kernel
HEAD_DIMS = tuple(range(8, 129, 8))
# the causal modes' (q/k, v) head dims (csrc/masked_attention.cu)
CAUSAL_HEAD_DIMS = ((192, 128),)
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches per mask mode, and per tile loop (plain ints; the twin
# never counts; ops/launches.py adds to them, replays of a CUDA graph too)
LAUNCHES = {"padding": 0, "segment": 0, "padding_causal": 0,
            "segment_causal": 0}
LOOP_LAUNCHES = {"wgmma": 0, "mma_sync": 0, "fma": 0}

# the C entry points' codes of the tile loops (csrc/attention_tile_sm90.cuh
# `Loop`), and the loops each dtype may run
LOOP_CODES = {"fma": 0, "mma_sync": 1, "wgmma": 2}
DTYPE_LOOPS = {torch.float32: ("fma",),
               torch.bfloat16: ("wgmma", "mma_sync")}
# bf16 keeps the mma.sync loop where the card showed it faster than the
# wgmma loop (scripts/tune_attention.py on an H100, PERF.md section 6):
# up to this many tokens, by the largest head dim of each class. Past them
# a 64-row wgmma tile has enough work; below them it is mostly idle.
MMA_SYNC_SEQ_LEN = ((32, 32), (64, 16), (128, 64))


def tile_loop(seq_len: int, head_dim: int, dtype: torch.dtype) -> str:
    """The tile loop that serves a (S, D, dtype) call of either attention
    kernel: fp32 the exact FMA loop; bf16 the wgmma loop, except where the
    card showed the mma.sync loop faster: S <= 32 at D <= 32, S <= 16 at
    D <= 64 and S <= 64 at D <= 128 (MMA_SYNC_SEQ_LEN)."""
    if dtype != torch.bfloat16:
        return "fma"
    limit = next(s for d, s in MMA_SYNC_SEQ_LEN if head_dim <= d)
    return "mma_sync" if seq_len <= limit else "wgmma"


def check_loop(name: str, loop: str, dtype: torch.dtype) -> None:
    """Raise ValueError unless ``dtype`` may run the tile loop ``loop``."""
    if loop not in DTYPE_LOOPS.get(dtype, ()):
        raise ValueError(f"{name}: the {loop!r} tile loop does not take "
                         f"{dtype} (it takes {DTYPE_LOOPS.get(dtype, ())})")


def attention_padding(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pad_mask: torch.Tensor, causal: bool = False,
                      scale: float = None) -> torch.Tensor:
    """q, k, v: (B, N, S, D); pad_mask: (B, S), 1 = real token; causal:
    keys after the query disallowed too (rows right-padded)."""
    if q.device.type == "cpu":
        return attention_padding_reference(q, k, v, pad_mask, causal, scale)
    if causal:
        return _launch_causal(q, k, v, pad_mask, "padding", scale)
    return _launch(q, k, v, pad_mask, "padding")


def attention_segment(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: torch.Tensor, causal: bool = False,
                      scale: float = None) -> torch.Tensor:
    """q, k, v: (B, N, S, D); segment_ids: (B, S), 0 = padding; causal:
    causal inside each segment."""
    if q.device.type == "cpu":
        return attention_segment_reference(q, k, v, segment_ids, causal,
                                           scale)
    if causal:
        return _launch_causal(q, k, v, segment_ids, "segment", scale)
    return _launch(q, k, v, segment_ids, "segment")


def check_layout(name: str, q, k, v) -> None:
    """Raise ValueError unless the attention kernels can read q, k, v as
    they lie: the last axis contiguous (stride 1), the stride of every other
    axis longer than 1 a multiple of 8 elements, and each data pointer
    16-byte aligned (the kernels copy rows in 16-byte pieces)."""
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {label} must be contiguous in its "
                             f"last axis, got strides {t.stride()}")
        if any(size > 1 and stride % 8 for size, stride in
               zip(t.shape[:-1], t.stride()[:-1])):
            raise ValueError(f"{name}: {label}'s strides {t.stride()} must "
                             f"be multiples of 8 elements")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def kernel_output(q, v_head_dim: int = None) -> torch.Tensor:
    """The kernels' output for q's (B, N, S, D) shape (D the v head dim
    where given): a (B, N, S, D) view of a new (B, S, N, D) tensor, the
    layout the next projection reads."""
    B, N, S, D = q.shape
    D = D if v_head_dim is None else v_head_dim
    return torch.empty(B, S, N, D, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def kernel_strides(q, k, v, out):
    """The C entry points' strides: a host array of the batch, head and
    token element strides of q, k, v and out, in that order."""
    values = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def check_kernel_inputs(q, k, v, mask) -> None:
    """Raise ValueError unless the kernel takes these tensors (device
    aside): fp32/bf16 q, k, v of one (B, N, S, D) shape with S <=
    MAX_SEQ_LEN and D in HEAD_DIMS, laid out as ``check_layout`` asks, and
    a (B, S) mask."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"masked attention: q, k, v must all be fp32 or "
                         f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"masked attention: q, k, v must share one "
                         f"(B, N, S, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, S, D = q.shape
    if tuple(mask.shape) != (B, S):
        raise ValueError(f"masked attention: mask must be {(B, S)}, got "
                         f"{tuple(mask.shape)}")
    if S > MAX_SEQ_LEN or D not in HEAD_DIMS:
        raise ValueError(f"masked attention: S={S} (max {MAX_SEQ_LEN}), "
                         f"D={D} (a multiple of 8 up to 128) not supported")
    check_layout("masked attention", q, k, v)


def _launch(q, k, v, mask, mode: str, loop=None) -> torch.Tensor:
    """Launch the kernel on the tile loop ``tile_loop`` picks, or on
    ``loop`` where the caller names one (the card tests and the smoke's
    timing hold both bf16 loops against the twin)."""
    if q.device.type != "cuda":
        raise ValueError(f"masked attention: unsupported device {q.device}")
    if any(t.device != q.device for t in (k, v, mask)):
        raise ValueError("masked attention: q, k, v and mask must share a "
                         "device")
    check_kernel_inputs(q, k, v, mask)
    B, N, S, D = q.shape
    loop = tile_loop(S, D, q.dtype) if loop is None else loop
    check_loop("masked attention", loop, q.dtype)
    mask = mask.to(torch.int32).contiguous()
    out = kernel_output(q)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.marqo_masked_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), B, N, S, D, int(mode == "segment"),
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
            kernel_strides(q, k, v, out), LOOP_CODES[loop],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked attention kernel launch failed: CUDA "
                           f"error {err}")
    launches.count(launches.Launch(LAUNCHES, mode, LOOP_LAUNCHES, loop,
                                   f"masked_attention_{mode}",
                                   tuple(q.shape)))
    return out


def _launch_causal(q, k, v, mask, mode: str, scale=None) -> torch.Tensor:
    """Launch a causal instance: (B, N, S, 192) q and k, (B, N, S, 128) v,
    bf16 on the mma.sync loop, fp32 on the FMA loop."""
    if any(t.device != q.device for t in (k, v, mask)):
        raise ValueError("masked attention: q, k, v and mask must share a "
                         "device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"masked attention: q, k, v must all be fp32 or "
                         f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"masked attention: q and k must share one "
                         f"(B, N, S, D) shape and v its (B, N, S), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, N, S, D = q.shape
    Dv = v.shape[-1]
    if (D, Dv) not in CAUSAL_HEAD_DIMS or S > MAX_SEQ_LEN:
        raise ValueError(f"masked attention: causal modes take (q/k, v) "
                         f"head dims {CAUSAL_HEAD_DIMS} and S <= "
                         f"{MAX_SEQ_LEN}, got ({D}, {Dv}), S={S}")
    if tuple(mask.shape) != (B, S):
        raise ValueError(f"masked attention: mask must be {(B, S)}, got "
                         f"{tuple(mask.shape)}")
    check_layout("masked attention", q, k, v)
    loop = "mma_sync" if q.dtype == torch.bfloat16 else "fma"
    mask = mask.to(torch.int32).contiguous()
    out = kernel_output(q, Dv)
    if out.numel() == 0:
        return out
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.marqo_masked_attention_causal(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), B, N, S, D, Dv, int(mode == "segment"),
            int(q.dtype == torch.bfloat16), scale,
            kernel_strides(q, k, v, out), LOOP_CODES[loop],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked attention kernel launch failed: CUDA "
                           f"error {err}")
    launches.count(launches.Launch(LAUNCHES, f"{mode}_causal", LOOP_LAUNCHES,
                                   loop, f"masked_attention_{mode}_causal",
                                   tuple(q.shape)))
    return out


# --- plain twin ---------------------------------------------------------------

def softmax_attention(q, k, v, allowed=None, scale=None) -> torch.Tensor:
    """softmax(q.k^T * scale) v, the scale 1/sqrt(D) unless given, with
    fp32 scores and softmax; keys where the boolean ``allowed`` (broadcast
    to the scores) is False get -1e9. The plain twin of this module's
    kernel and of ops/fused_attention.py's."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if allowed is not None:
        scores = scores.masked_fill(~allowed, _MASKED_SCORE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _causal(allowed: torch.Tensor, S: int) -> torch.Tensor:
    """``allowed`` (B, 1 or S, S) with keys after the query disallowed."""
    return allowed & torch.ones(S, S, dtype=torch.bool,
                                device=allowed.device).tril()


def attention_padding_reference(q, k, v, pad_mask, causal=False,
                                scale=None) -> torch.Tensor:
    """Plain PyTorch twin of the padding-mode kernel."""
    allowed = (pad_mask > 0)[:, None, :]
    if causal:
        allowed = _causal(allowed, q.shape[2])
    return softmax_attention(q, k, v, allowed[:, None], scale)


def attention_segment_reference(q, k, v, segment_ids, causal=False,
                                scale=None) -> torch.Tensor:
    """Plain PyTorch twin of the segment-mode kernel."""
    seg = segment_ids
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    if causal:
        allowed = _causal(allowed, q.shape[2])
    return softmax_attention(q, k, v, allowed[:, None], scale)
