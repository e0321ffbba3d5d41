"""The routed experts of a mixture of experts (DeepSeek-V2's MoE): route,
permute, a grouped GEMM over the experts, and a weighted combine. The
shared experts, which every token passes, are a dense SwiGLU beside this
layer (models/deepseek_v2.py ``MoE``).

It replaces no TPU kernel: the JAX package has no mixture of experts. It
was added for decoder embedders (models/deepseek_v2.py), whose expert
layer does most of a forward's operations.

One call over T tokens (every token of a forward's static rows):

1. Route: router logits in fp32, a softmax over the routed experts and the
   greedy top k (weights renormalised only where asked, times a scale).
2. Permute: each token goes to its k routed experts, so T x k rows. Pad
   tokens go to a group past the last, which no GEMM computes. A stable
   sort by group gives the static row buffer's order; each expert's size
   and its end offset are computed on the device, so nothing reads back
   to the host and a CUDA graph captures the whole layer.
3. Gate and up fused: one grouped GEMM of the rows by each expert's
   (2F, H) weight, then ``swiglu`` (silu(gate) * up) over the real rows
   only, then one grouped GEMM by each expert's (H, F) down weight.
4. ``combine``: each token's k rows read where they lie in expert order
   and summed with its fp32 weights (fp32 accumulation); pad tokens
   written as zeros, their rows never read.

The grouped GEMM: on a CUDA device ``torch._grouped_mm`` (bf16, sm90: one
launch over all groups, the groups' end offsets read on the device); on
the CPU its twin, a loop over the groups (``grouped_mm_reference``). What
bounds it on the card: at a request's ~16k tokens the operations (a
layer's routed experts do ~0.1 GFLOP a token against 1.1 GB of their
weights read once: compute-bound above ~3k tokens a forward, weight-bound
below).

``swiglu`` and ``combine``: on a CUDA device the hand-written passes of
``csrc/moe_glue.cu`` (bf16 alone, the model's compute dtype; bytes-bound:
each reads every real row once, 16-byte vectors, fp32 in registers, one
rounding); on the CPU their twins
(``swiglu_reference``, ``combine_reference``), the plain PyTorch
composition the passes replace. ``swiglu`` also serves the dense SwiGLUs
(models/deepseek_v2.py ``DenseMLP``), without a row count. ``LAUNCHES``
counts each kernel's launches, replays of a CUDA graph included
(ops/launches.py).

``counts``, where given, is an (experts,) int64 device tensor: each routed
expert's real tokens are added to it on the device (the ``moe.expert_tokens``
counter, read by the model's owner at a traced request's device wait).
"""

import torch

from marqo_tpu_torch.ops import _build, launches

LAUNCHES = {"grouped_mm": 0, "swiglu": 0, "combine": 0}
# what the passes take: bf16 in 16-byte vectors of 8, a token's k rows all
# in flight at once (csrc/moe_glue.cu kMaxTopK)
VALUES_A_VECTOR = 8
MAX_TOP_K = 8


def route(x: torch.Tensor, router: torch.Tensor, top_k: int,
          norm_topk_prob: bool = False, scale: float = 1.0):
    """(weights (T, k) fp32, experts (T, k) int64) of x (T, H) by the
    router's (E, H) weight: fp32 logits, softmax, greedy top k."""
    logits = x.float() @ router.float().T
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        weights = weights / weights.sum(-1, keepdim=True)
    return weights * scale, experts


def grouped_mm(rows: torch.Tensor, weight: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """rows (M, K) sorted by group, weight (G, N, K), offsets (G,) int32
    the groups' end rows -> (M, N): each group's rows by its weight
    transposed; rows past the last offset are not computed (their values
    are undefined). The kernel on a CUDA device, the twin on the CPU."""
    if rows.device.type == "cpu":
        return grouped_mm_reference(rows, weight, offsets)
    out = torch._grouped_mm(rows, weight.transpose(1, 2), offs=offsets)
    launches.count(launches.Launch(LAUNCHES, "grouped_mm", None, None,
                                   "grouped_mm", (rows.shape[0],
                                                  weight.shape[2],
                                                  weight.shape[1])))
    return out


def grouped_mm_reference(rows: torch.Tensor, weight: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """The plain twin of ``grouped_mm``: a loop over the groups (rows past
    the last offset are zeros)."""
    out = rows.new_zeros((rows.shape[0], weight.shape[1]))
    start = 0
    for g, end in enumerate(offsets.tolist()):
        if end > start:
            out[start:end] = rows[start:end] @ weight[g].T
        start = end
    return out


def check_swiglu_inputs(h: torch.Tensor, count=None) -> None:
    """Raise ValueError unless the SwiGLU kernel takes these tensors
    (device aside): h bf16 (..., 2W) with at least one row, contiguous and
    16-byte aligned, W a multiple of 8; count None or one int32 value on
    h's device."""
    if h.dtype != torch.bfloat16:
        raise ValueError(f"moe swiglu: h must be bf16, got {h.dtype}")
    if h.dim() < 2 or h.numel() == 0 or h.shape[-1] % (2 * VALUES_A_VECTOR):
        raise ValueError(f"moe swiglu: h must be (..., 2W) with rows and W a "
                         f"multiple of {VALUES_A_VECTOR}, got "
                         f"{tuple(h.shape)}")
    if not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError("moe swiglu: h must be contiguous and 16-byte "
                         "aligned")
    if count is not None and (count.dtype != torch.int32 or
                              count.numel() != 1 or
                              count.device != h.device):
        raise ValueError(f"moe swiglu: count must be one int32 value on "
                         f"{h.device}, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}")


def swiglu(h: torch.Tensor, count: torch.Tensor = None) -> torch.Tensor:
    """h (..., 2W) rows [gate | up] -> (..., W) silu(gate) * up in h's
    dtype (bf16 on the card). ``count``, where given, is one int32 value on h's device, the
    rows to compute (the routed groups' last end offset): on the card rows
    past it are neither read nor written (their values are undefined). The
    kernel on a CUDA device, the twin on the CPU."""
    if h.device.type == "cpu":
        return swiglu_reference(h)
    if h.device.type != "cuda":
        raise ValueError(f"moe swiglu: unsupported device {h.device}")
    check_swiglu_inputs(h, count)
    W = h.shape[-1] // 2
    rows = h.numel() // (2 * W)
    act = torch.empty(h.shape[:-1] + (W,), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        err = _build.load_library().marqo_moe_swiglu(
            h.data_ptr(), act.data_ptr(), rows, W,
            None if count is None else count.data_ptr(),
            torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe swiglu kernel launch failed: CUDA error "
                           f"{err}")
    launches.count(launches.Launch(LAUNCHES, "swiglu", None, None,
                                   "moe_swiglu", (rows, W)))
    return act


def swiglu_reference(h: torch.Tensor) -> torch.Tensor:
    """The plain twin of ``swiglu``, every row: SiLU of the gate half, then
    the product with the up half, each rounded to h's dtype."""
    gate, up = h.chunk(2, dim=-1)
    return torch.nn.functional.silu(gate).mul_(up)


def check_combine_inputs(y: torch.Tensor, back: torch.Tensor,
                         weights: torch.Tensor, valid: torch.Tensor) -> None:
    """Raise ValueError unless the combine kernel takes these tensors
    (device aside): y bf16 (T k, H), H a multiple of 8; back int32 and
    weights fp32 (T, k), 1 <= k <= MAX_TOP_K; valid bool (T,); all on one
    device and contiguous, y 16-byte aligned; T >= 1."""
    if y.dtype != torch.bfloat16:
        raise ValueError(f"moe combine: y must be bf16, got {y.dtype}")
    if back.dim() != 2 or back.numel() == 0 or back.shape[1] > MAX_TOP_K:
        raise ValueError(f"moe combine: back must be (T, k) with T >= 1 and "
                         f"1 <= k <= {MAX_TOP_K}, got {tuple(back.shape)}")
    T, k = back.shape
    if y.dim() != 2 or y.shape[0] != T * k or y.shape[1] % VALUES_A_VECTOR:
        raise ValueError(f"moe combine: y must be ({T * k}, H), H a multiple "
                         f"of {VALUES_A_VECTOR}, got {tuple(y.shape)}")
    for name, t, dtype, shape in (("back", back, torch.int32, (T, k)),
                                  ("weights", weights, torch.float32, (T, k)),
                                  ("valid", valid, torch.bool, (T,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"moe combine: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    tensors = (y, back, weights, valid)
    if any(t.device != y.device for t in tensors):
        raise ValueError("moe combine: y, back, weights and valid must share "
                         "a device")
    if not all(t.is_contiguous() for t in tensors) or y.data_ptr() % 16:
        raise ValueError("moe combine: inputs must be contiguous, y 16-byte "
                         "aligned")


def combine(y: torch.Tensor, back: torch.Tensor, weights: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """y (T k, H) in expert order, back (T, k) int32 the rows of y of each
    token's experts, weights (T, k) fp32, valid (T,) bool -> (T, H) in y's
    dtype (bf16 on the card): each valid token's rows summed with its weights, a pad token 0
    (its rows never read). The kernel on a CUDA device, the twin on the
    CPU."""
    if y.device.type == "cpu":
        return combine_reference(y, back, weights, valid)
    if y.device.type != "cuda":
        raise ValueError(f"moe combine: unsupported device {y.device}")
    check_combine_inputs(y, back, weights, valid)
    T, k = back.shape
    H = y.shape[1]
    out = torch.empty((T, H), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        err = _build.load_library().marqo_moe_combine(
            y.data_ptr(), back.data_ptr(), weights.data_ptr(),
            valid.data_ptr(), out.data_ptr(), T, k, H,
            torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe combine kernel launch failed: CUDA error "
                           f"{err}")
    launches.count(launches.Launch(LAUNCHES, "combine", None, None,
                                   "moe_combine", (T, k, H)))
    return out


def combine_reference(y: torch.Tensor, back: torch.Tensor,
                      weights: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """The plain twin of ``combine``: the rows gathered into token order,
    a batched (1, k) x (k, H) product with the weights in y's dtype, pad
    tokens zeroed."""
    T, k = back.shape
    rows = y[back.reshape(-1).long()].view(T, k, y.shape[1])
    out = torch.bmm(weights.to(y.dtype)[:, None, :], rows).view(T, -1)
    return torch.where(valid[:, None], out, out.new_zeros(()))


def expert_layer(x: torch.Tensor, valid: torch.Tensor, router: torch.Tensor,
                 gate_up: torch.Tensor, down: torch.Tensor, top_k: int,
                 norm_topk_prob: bool = False, scale: float = 1.0,
                 counts: torch.Tensor = None) -> torch.Tensor:
    """x (T, H) in the compute dtype; valid (T,) bool, False for pad tokens
    (routed nowhere, output 0); router (E, H); gate_up (E, 2F, H) and down
    (E, H, F) of the E routed experts, each gate_up's rows [gate; up].
    Returns (T, H)."""
    T = x.shape[0]
    E = router.shape[0]
    weights, experts = route(x, router, top_k, norm_topk_prob, scale)
    # pad tokens to group E, past every GEMM
    groups = torch.where(valid[:, None], experts, E).reshape(-1)
    sizes = torch.zeros(E + 1, dtype=torch.int32, device=x.device)
    sizes.index_add_(0, groups, torch.ones_like(groups, dtype=torch.int32))
    if counts is not None:
        counts.add_(sizes[:E])
    offsets = torch.cumsum(sizes[:E], 0, dtype=torch.int32)
    order = torch.argsort(groups, stable=True)
    # each intermediate is dropped as soon as it is used: at a forward's
    # tens of thousands of tokens each is a GB or more, and a CUDA graph's
    # pool keeps the peak
    h = grouped_mm(x[order // top_k], gate_up, offsets)
    act = swiglu(h, offsets[-1:])
    del h
    y = grouped_mm(act, down, offsets)
    del act
    return combine(y, back_rows(order).view(T, top_k), weights, valid)


def back_rows(order: torch.Tensor) -> torch.Tensor:
    """The inverse of the permutation ``order`` (expert order's row i is
    row order[i] of the (T x k) grid) as int32: row j of the grid lies at
    row back[j] in expert order."""
    back = torch.empty_like(order, dtype=torch.int32)
    back[order] = torch.arange(order.numel(), dtype=torch.int32,
                               device=order.device)
    return back
