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
   (2F, H) weight, then silu(gate) * up, then one grouped GEMM by each
   expert's (H, F) down weight.
4. Combine: each token's rows gathered back and summed with its weights
   (a batched (1, k) x (k, H) product, fp32 accumulation), pad tokens
   zeroed.

The grouped GEMM: on a CUDA device ``torch._grouped_mm`` (bf16, sm90: one
launch over all groups, the groups' end offsets read on the device); on
the CPU its twin, a loop over the groups (``grouped_mm_reference``). What
bounds it on the card: at a request's ~16k tokens the operations (a
layer's routed experts do ~0.1 GFLOP a token against 1.1 GB of their
weights read once: compute-bound above ~3k tokens a forward, weight-bound
below). ``LAUNCHES`` counts grouped GEMM launches, replays of a CUDA graph
included (ops/launches.py).

``counts``, where given, is an (experts,) int64 device tensor: each routed
expert's real tokens are added to it on the device (the ``moe.expert_tokens``
counter, read by the model's owner at a traced request's device wait).
"""

import torch

from marqo_tpu_torch.ops import launches

LAUNCHES = {"grouped_mm": 0}


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


def expert_layer(x: torch.Tensor, valid: torch.Tensor, router: torch.Tensor,
                 gate_up: torch.Tensor, down: torch.Tensor, top_k: int,
                 norm_topk_prob: bool = False, scale: float = 1.0,
                 counts: torch.Tensor = None) -> torch.Tensor:
    """x (T, H) in the compute dtype; valid (T,) bool, False for pad tokens
    (routed nowhere, output 0); router (E, H); gate_up (E, 2F, H) and down
    (E, H, F) of the E routed experts, each gate_up's rows [gate; up].
    Returns (T, H)."""
    T, H = x.shape
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
    gate, up = h.chunk(2, dim=-1)
    act = torch.nn.functional.silu(gate).mul_(up)
    del h, gate, up
    y = grouped_mm(act, down, offsets)
    del act
    # back to token order: row order[i] of the (T x k) grid is y[i]
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=x.device)
    y = y[back].view(T, top_k, H)
    out = torch.bmm(weights.to(y.dtype)[:, None, :], y).view(T, H)
    return torch.where(valid[:, None], out, out.new_zeros(()))
