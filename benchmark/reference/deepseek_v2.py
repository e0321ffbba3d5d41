"""DeepSeek-V2 (``deepseek_v2``) as a mean-pooled text embedder, in plain
float32 torch: the plain reference of the port's decoder embedder.

The forward follows the published modelling code (DeepSeek's
``modeling_deepseek.py``, which transformers' ``DeepseekV2Model`` ports):

- token embeddings, then per layer a pre-norm block: RMSNorm, latent
  attention (MLA), a residual; RMSNorm, the feed-forward, a residual; a
  final RMSNorm. RMSNorm is x / sqrt(mean(x^2) + eps) times its scale.
- MLA without a query LoRA: ``q_proj`` gives per head a no-RoPE part
  (``qk_nope_head_dim``) and a RoPE part (``qk_rope_head_dim``);
  ``kv_a_proj_with_mqa`` gives a latent (``kv_lora_rank``), RMSNorm'd by
  ``kv_a_layernorm``, and one RoPE key shared by every head; ``kv_b_proj``
  maps the latent to each head's no-RoPE key and its value
  (``v_head_dim``); causal softmax attention; ``o_proj``.
- RoPE on interleaved pairs (x[2i], x[2i+1]) at YaRN's frequencies
  (``rope_scaling``: factor, original length, beta_fast, beta_slow); the
  cos/sin scale is mscale(factor, mscale) / mscale(factor, mscale_all_dim)
  and the softmax scale qk_head_dim^-1/2 times mscale(factor,
  mscale_all_dim)^2, mscale(s, m) = 0.1 m ln s + 1.
- Feed-forward: a SwiGLU (down(silu(gate x) * up x)) of
  ``intermediate_size`` in the first ``first_k_dense_replace`` layers; after
  them a mixture of experts: router logits in float32, a softmax over the
  ``n_routed_experts``, the greedy top ``num_experts_per_tok`` (weights
  times ``routed_scaling_factor``, renormalised only with
  ``norm_topk_prob``), each routed expert a SwiGLU of
  ``moe_intermediate_size``, plus the shared experts as one SwiGLU of
  ``moe_intermediate_size * n_shared_experts``.
- The embedder: the mean of the final hidden states over the real tokens,
  L2-normalised (Marqo's mean pooling). The LM head is not used.

Departures, each deliberate:

- transformers' ``DeepseekV2Attention`` (4.57) scales the softmax by
  qk_head_dim^-1/2 alone; DeepSeek's own code, and this file, multiply it
  by mscale(factor, mscale_all_dim)^2 (1.2608^2 at DeepSeek-V2-Lite's
  factor 40 and mscale_all_dim 0.707). The test that holds this file to
  transformers sets that scale on transformers' modules.
- Only ``topk_method`` "greedy" (DeepSeek-V2-Lite's) is implemented; the
  group-limited routing of the larger DeepSeek-V2 raises.
- ``precision="fp8"`` (the benchmark's control, a step below bf16) rounds
  both operands of every linear layer to float8 e4m3, the weight per
  output row and the activation per token, each scaled so that its largest
  magnitude maps to 448, then multiplies in float32.

No kernel, cache, packing or batching: ``encode`` runs a padded batch
layer by layer, reading each layer's tensors from the checkpoint's
safetensors shards as it comes to it (``Weights``), so that the whole
model never sits on the device in float32. It imports only torch,
safetensors and the standard library.

Counts at published widths (2 operations a multiply-add): ``flops`` of one
forward over n tokens; ``expert_flops`` of the expert layers alone
(routed, and shared unless asked otherwise); ``expert_weight_bytes`` of
the experts' weights in bf16; ``attention_bound_s`` of one chunk's causal
attention on the card.
"""

import json
import math
import os

import torch

E4M3_MAX = 448.0
# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def float32_only() -> None:
    """Keeps float32 products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def read_config(directory: str) -> dict:
    with open(os.path.join(directory, "config.json")) as f:
        return json.load(f)


# --- the arithmetic ------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, weight: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    """x (..., in) by weight (out, in)."""
    if precision == "fp8":
        x, weight = _fp8(x), _fp8(weight)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision}")
    return x @ weight.T


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def swiglu(x, gate, up, down, precision: str = "float32") -> torch.Tensor:
    return linear(torch.nn.functional.silu(linear(x, gate, precision))
                  * linear(x, up, precision), down, precision)


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn(c: dict) -> tuple:
    """(inverse frequencies (rope_dim / 2,), cos/sin scale, softmax scale)."""
    dim, base = c["qk_rope_head_dim"], c["rope_theta"]
    qk_head_dim = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    s = c.get("rope_scaling")
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    if not s:
        return 1.0 / pos_freqs, 1.0, qk_head_dim ** -0.5
    factor = s["factor"]
    original = s.get("original_max_position_embeddings") or \
        c["max_position_embeddings"]
    beta_fast, beta_slow = s.get("beta_fast") or 32, s.get("beta_slow") or 1

    def correction_dim(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))) / \
            (2 * math.log(base))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) /
            (high - low)).clamp(0, 1)
    extrapolation = 1 - ramp
    inv_freq = (1.0 / (factor * pos_freqs)) * (1 - extrapolation) + \
        (1.0 / pos_freqs) * extrapolation
    m, m_all = s.get("mscale"), s.get("mscale_all_dim")
    cos_scale = _mscale(factor, m) / _mscale(factor, m_all) if m and m_all \
        else _mscale(factor, 1.0)
    softmax_scale = qk_head_dim ** -0.5
    if m_all:
        softmax_scale *= _mscale(factor, m_all) ** 2
    return inv_freq, cos_scale, softmax_scale


def rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
         cos_scale: float) -> torch.Tensor:
    """x (B, heads, S, d) rotated by its (B, S) positions, on interleaved
    pairs (x[2i], x[2i+1])."""
    angles = positions[:, None, :, None].double() * inv_freq.to(x.device)
    cos = (torch.cos(angles) * cos_scale).float()
    sin = (torch.sin(angles) * cos_scale).float()
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, even * sin + odd * cos],
                       dim=-1).flatten(-2)


def attention(p: dict, c: dict, x: torch.Tensor, positions: torch.Tensor,
              allowed: torch.Tensor, precision: str = "float32"
              ) -> torch.Tensor:
    """Latent attention of x (B, S, H); ``allowed`` (B, S, S) the keys each
    query may attend to."""
    B, S, _ = x.shape
    N = c["num_attention_heads"]
    nope, rd = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    dv, rank = c["v_head_dim"], c["kv_lora_rank"]
    inv_freq, cos_scale, scale = yarn(c)
    q = linear(x, p["self_attn.q_proj.weight"], precision)
    q = q.view(B, S, N, nope + rd).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kv = linear(x, p["self_attn.kv_a_proj_with_mqa.weight"], precision)
    latent, k_rope = kv[..., :rank], kv[..., rank:]
    latent = rms_norm(latent, p["self_attn.kv_a_layernorm.weight"],
                      c["rms_norm_eps"])
    kv = linear(latent, p["self_attn.kv_b_proj.weight"], precision)
    kv = kv.view(B, S, N, nope + dv).transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_rope = rope(q_rope, positions, inv_freq, cos_scale)
    k_rope = rope(k_rope[:, None], positions, inv_freq, cos_scale)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, N, S, rd)], dim=-1)
    scores = (q @ k.transpose(-1, -2)) * scale
    scores = scores.masked_fill(~allowed[:, None], -1e30)
    ctx = (scores.softmax(-1) @ v).transpose(1, 2).reshape(B, S, N * dv)
    return linear(ctx, p["self_attn.o_proj.weight"], precision)


def experts(p: dict, c: dict, x: torch.Tensor,
            precision: str = "float32") -> torch.Tensor:
    """The mixture of experts over x (T, H): each routed expert on the
    tokens routed to it, weighted, plus the shared experts."""
    if c.get("topk_method", "greedy") != "greedy":
        raise NotImplementedError(f"topk_method {c['topk_method']}")
    logits = linear(x, p["mlp.gate.weight"], precision)
    scores = logits.softmax(-1)
    weights, chosen = torch.topk(scores, c["num_experts_per_tok"], dim=-1)
    if c.get("norm_topk_prob"):
        weights = weights / weights.sum(-1, keepdim=True)
    weights = weights * c.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        token, slot = (chosen == e).nonzero(as_tuple=True)
        if token.numel() == 0:
            continue
        pre = f"mlp.experts.{e}."
        y = swiglu(x[token], p[pre + "gate_proj.weight"],
                   p[pre + "up_proj.weight"], p[pre + "down_proj.weight"],
                   precision)
        out.index_add_(0, token, y * weights[token, slot][:, None])
    if c.get("n_shared_experts"):
        out = out + swiglu(x, p["mlp.shared_experts.gate_proj.weight"],
                           p["mlp.shared_experts.up_proj.weight"],
                           p["mlp.shared_experts.down_proj.weight"],
                           precision)
    return out


def block(p: dict, c: dict, i: int, x: torch.Tensor, positions, allowed,
          precision: str = "float32") -> torch.Tensor:
    eps = c["rms_norm_eps"]
    x = x + attention(p, c, rms_norm(x, p["input_layernorm.weight"], eps),
                      positions, allowed, precision)
    h = rms_norm(x, p["post_attention_layernorm.weight"], eps)
    if i < c["first_k_dense_replace"]:
        h = swiglu(h, p["mlp.gate_proj.weight"], p["mlp.up_proj.weight"],
                   p["mlp.down_proj.weight"], precision)
    else:
        B, S, H = h.shape
        h = experts(p, c, h.reshape(B * S, H), precision).view(B, S, H)
    return x + h


class Weights:
    """The checkpoint's tensors in float32 on ``device``, read when asked:
    from ``model.safetensors.index.json`` and its shards, or from one
    ``model.safetensors``. Names may carry a ``model.`` prefix. With
    ``keep`` each tensor read stays on the device in its stored dtype (the
    next pass reads no file) while ``KEEP_FREE`` bytes stay free on a CUDA
    device, and is cast to float32 where it is used."""

    KEEP_FREE = 8 * 2 ** 30

    def __init__(self, directory: str, device, keep: bool = False):
        self.directory, self.device = directory, device
        self.kept = {} if keep else None
        index = os.path.join(directory, "model.safetensors.index.json")
        if os.path.isfile(index):
            with open(index) as f:
                files = json.load(f)["weight_map"]
        else:
            from safetensors import safe_open
            path = os.path.join(directory, "model.safetensors")
            with safe_open(path, "pt") as f:
                files = {name: "model.safetensors" for name in f.keys()}
        self.files = {}
        for name, file in files.items():
            short = name[len("model."):] if name.startswith("model.") else name
            self.files[short] = (name, file)

    def tensors(self, prefix: str) -> dict:
        """{name less ``prefix``: float32 tensor} of every tensor under
        ``prefix``."""
        stored = None if self.kept is None else self.kept.get(prefix)
        if stored is None:
            stored = self._read(prefix)
            if self.kept is not None and self._room():
                self.kept[prefix] = stored
        return {name: t.float() for name, t in stored.items()}

    def _room(self) -> bool:
        device = torch.device(self.device)
        return device.type != "cuda" or \
            torch.cuda.mem_get_info(device)[0] > self.KEEP_FREE

    def _read(self, prefix: str) -> dict:
        from safetensors import safe_open
        wanted = [k for k in self.files if k.startswith(prefix)]
        by_file = {}
        for short in wanted:
            name, file = self.files[short]
            by_file.setdefault(file, []).append((short, name))
        out = {}
        for file, names in by_file.items():
            with safe_open(os.path.join(self.directory, file), "pt") as f:
                for short, name in names:
                    out[short[len(prefix):]] = f.get_tensor(name).to(
                        self.device)
        return out


def encode(weights: Weights, c: dict, ids: torch.Tensor, mask: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    """(B, S) token ids, right-padded, and their 0/1 mask -> (B, hidden)
    unit vectors: the mean of the final hidden states over the real
    tokens."""
    device = weights.device
    ids, mask = ids.to(device), mask.to(device)
    B, S = ids.shape
    x = weights.tensors("embed_tokens.")["weight"][ids]
    positions = torch.arange(S, device=device).expand(B, S)
    causal = torch.ones(S, S, dtype=torch.bool, device=device).tril()
    allowed = causal[None] & (mask[:, None, :] > 0)
    for i in range(c["num_hidden_layers"]):
        p = weights.tensors(f"layers.{i}.")
        x = block(p, c, i, x, positions, allowed, precision)
        del p
    x = rms_norm(x, weights.tensors("norm.")["weight"], c["rms_norm_eps"])
    m = mask.float()[..., None]
    pooled = (x * m).sum(1) / m.sum(1).clamp_min(1.0)
    return torch.nn.functional.normalize(pooled, dim=-1)


# --- counts at published widths --------------------------------------------------

def expert_flops(c: dict, n: int, shared: bool = True) -> float:
    """Operations of the expert layers over n tokens: each token through
    its routed experts, and the shared ones where ``shared``, in every MoE
    layer."""
    H, F = c["hidden_size"], c["moe_intermediate_size"]
    experts = c["num_experts_per_tok"] + \
        ((c.get("n_shared_experts") or 0) if shared else 0)
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    return 2.0 * moe_layers * n * experts * 3 * H * F


def expert_weight_bytes(c: dict, shared: bool = True) -> float:
    """Bytes of every routed expert's weights, and the shared ones' where
    ``shared``, in bf16."""
    H, F = c["hidden_size"], c["moe_intermediate_size"]
    experts = c["n_routed_experts"] + \
        ((c.get("n_shared_experts") or 0) if shared else 0)
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    return 2.0 * moe_layers * experts * 3 * H * F


def flops(c: dict, n: int) -> float:
    """Activated operations of one forward over n tokens: the attention
    projections, causal attention's S(S+1)/2 query-key pairs, the dense
    feed-forward, the router, and the routed and shared experts."""
    H, N = c["hidden_size"], c["num_attention_heads"]
    nope, rd = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    dv, rank = c["v_head_dim"], c["kv_lora_rank"]
    projections = H * N * (nope + rd) + H * (rank + rd) + \
        rank * N * (nope + dv) + N * dv * H
    pairs = n * (n + 1) / 2
    attention_ops = 2.0 * pairs * N * (nope + rd + dv)
    dense = c["first_k_dense_replace"]
    moe = c["num_hidden_layers"] - dense
    per_layer = 2.0 * n * projections + attention_ops
    total = c["num_hidden_layers"] * per_layer
    total += 2.0 * dense * n * 3 * H * c["intermediate_size"]
    total += 2.0 * moe * n * H * c["n_routed_experts"]
    return total + expert_flops(c, n)


def attention_bound_s(c: dict, n: int) -> float:
    """The least time of one chunk's causal latent attention in one layer
    in bf16: q, k (qk_head_dim) and v, out (v_head_dim) moved once against
    the S(S+1)/2 pairs' two products, whichever is larger."""
    N = c["num_attention_heads"]
    dqk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    dv = c["v_head_dim"]
    bytes_moved = 2.0 * n * N * (2 * dqk + 2 * dv)
    operations = 2.0 * (n * (n + 1) / 2) * N * (dqk + dv)
    return max(bytes_moved / PEAK_BYTES_PER_S, operations / PEAK_BF16_FLOPS)
