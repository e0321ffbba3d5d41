"""Flash attention for the ViT towers and the encoder's "flash" path: the
hand-written CUDA kernel (``csrc/fused_attention.cu``) and its plain
PyTorch twin.

Port of marqo_tpu/ops/fused_attention.py, whose ``fused_attention`` runs
JAX's library Pallas TPU flash kernel. Two modes:

  - no mask: every key is allowed (the ViT image towers), any S;
  - segment ids (B, S): key j is allowed iff seg[i] == seg[j], with 0 a
    segment like any other. A ``pad_mask`` (B, S) becomes ids {0, 1}, so
    pad rows attend to each other; callers discard them.

q is unscaled: 1/sqrt(D) is applied inside, scores, softmax and the P.V
accumulation run in fp32, and the output is in the input dtype. Every query
sees at least its own key, so every output row is defined.

Layout: as ops/flash_attention.py's kernel, q, k and v may be any
(B, N, S, D) views with a contiguous last axis (the projections'
``x.view(B, S, N, D).transpose(1, 2)``), and the output is a (B, N, S, D)
view of a (B, S, N, D) tensor.

Not ported: the ``interpret`` argument, ``supports()`` (its S % 128 rule is
a TPU tiling limit; the CUDA kernel masks its own ragged edge) and
``flash_enabled()`` (the MARQO_TPU_FUSED_ATTENTION gate): on a CUDA device
the kernel is the ViT towers' attention.

Tile loops: as ops/flash_attention.py's kernel, bf16 on the wgmma or the
mma.sync loop and fp32 on the FMA loop, by the same ``tile_loop`` rule.

Routing: a tensor on the CPU takes the plain twin; a tensor on a CUDA
device launches the kernel or raises. ``LAUNCHES`` counts kernel launches
per mode (a ``pad_mask`` runs the segment mode), ``LOOP_LAUNCHES`` per
tile loop.
"""

import math
from typing import Optional

import torch

from marqo_tpu_torch.ops import _build, launches
from marqo_tpu_torch.ops.flash_attention import (LOOP_CODES, check_layout,
                                                 check_loop, kernel_output,
                                                 kernel_strides,
                                                 softmax_attention,
                                                 tile_loop)

HEAD_DIMS = tuple(range(8, 129, 8))
DTYPES = (torch.float32, torch.bfloat16)
# the kernel's batch rides on grid.z (every tile loop of
# csrc/attention_tile.cuh and attention_tile_sm90.cuh), whose CUDA limit is
# 65535 blocks
MAX_BATCH = 65535

# kernel launches per mode, and per tile loop (plain ints; the twin never
# counts; ops/launches.py adds to them, replays of a CUDA graph too)
LAUNCHES = {"nomask": 0, "segment": 0}
LOOP_LAUNCHES = {"wgmma": 0, "mma_sync": 0, "fma": 0}


def _segment_ids(pad_mask, segment_ids) -> Optional[torch.Tensor]:
    if segment_ids is not None:
        return segment_ids
    if pad_mask is not None:
        # padding is segment masking with ids {0, 1}
        return (pad_mask > 0).to(torch.int32)
    return None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q, k, v: (B, N, S, D), q unscaled. At most one of pad_mask (B, S)
    0/1 and segment_ids (B, S) int; segment_ids wins if both are given."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, pad_mask, segment_ids)
    return _launch(q, k, v, _segment_ids(pad_mask, segment_ids))


def check_kernel_inputs(q, k, v, segment_ids=None) -> None:
    """Raise ValueError unless the kernel takes these tensors (device
    aside): fp32/bf16 q, k, v of one (B, N, S, D) shape with B <=
    MAX_BATCH, S >= 1 and D in HEAD_DIMS, laid out as ``check_layout`` asks,
    and (B, S) segment ids if any."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused attention: q, k, v must all be fp32 or "
                         f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused attention: q, k, v must share one "
                         f"(B, N, S, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, S, D = q.shape
    if B > MAX_BATCH:
        raise ValueError(f"fused attention: B={B} exceeds the kernel's "
                         f"batch limit of {MAX_BATCH} (grid.z)")
    if S < 1 or D not in HEAD_DIMS:
        raise ValueError(f"fused attention: S={S} (at least 1), D={D} (a "
                         f"multiple of 8 up to 128) not supported")
    if segment_ids is not None and tuple(segment_ids.shape) != (B, S):
        raise ValueError(f"fused attention: segment ids must be {(B, S)}, "
                         f"got {tuple(segment_ids.shape)}")
    check_layout("fused attention", q, k, v)


def _launch(q, k, v, ids, loop=None) -> torch.Tensor:
    """Launch the kernel on the tile loop ``tile_loop`` picks, or on
    ``loop`` where the caller names one."""
    if q.device.type != "cuda":
        raise ValueError(f"fused attention: unsupported device {q.device}")
    if any(t.device != q.device for t in (k, v) + (() if ids is None
                                                   else (ids,))):
        raise ValueError("fused attention: q, k, v and segment ids must "
                         "share a device")
    check_kernel_inputs(q, k, v, ids)
    B, N, S, D = q.shape
    loop = tile_loop(S, D, q.dtype) if loop is None else loop
    check_loop("fused attention", loop, q.dtype)
    if ids is not None:
        ids = ids.to(torch.int32).contiguous()
    out = kernel_output(q)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.marqo_fused_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if ids is None else ids.data_ptr(), out.data_ptr(),
            B, N, S, D, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
            kernel_strides(q, k, v, out), LOOP_CODES[loop],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused attention kernel launch failed: CUDA "
                           f"error {err}")
    mode = "nomask" if ids is None else "segment"
    launches.count(launches.Launch(LAUNCHES, mode, LOOP_LAUNCHES, loop,
                                   f"fused_attention_{mode}",
                                   tuple(q.shape)))
    return out


# --- plain twin --------------------------------------------------------------

def fused_attention_reference(q, k, v, pad_mask=None,
                              segment_ids=None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, with fused_attention's signature."""
    ids = _segment_ids(pad_mask, segment_ids)
    if ids is None:
        return softmax_attention(q, k, v)
    allowed = ids[:, :, None] == ids[:, None, :]
    return softmax_attention(q, k, v, allowed[:, None])
