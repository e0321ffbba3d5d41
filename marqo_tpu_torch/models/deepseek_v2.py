"""DeepSeek-V2 (``deepseek_v2``) as a mean-pooled text embedder, in PyTorch.

Marqo users serve a decoder LLM fine-tuned as an embedder as they load any
HF checkpoint: type ``hf``, ``localpath``, mean pooling. This module is
that model for the ``deepseek_v2`` architecture (DeepSeek-V2-Lite:
hidden 2048, 27 layers, latent attention, 64 routed experts and 2 shared
ones after one dense layer); the JAX package has no counterpart. Its
equations are those of tests/reference/deepseek_v2.py, the plain float32
reference it is held to:

- pre-norm blocks with RMSNorm (statistics in fp32, as transformers
  normalises in fp32 and scales in the input dtype);
- latent attention (MLA) without a query LoRA: per head a 128-wide no-RoPE
  and a 64-wide RoPE query part; a 512-wide latent, RMSNorm'd, and one
  RoPE key shared by the heads; ``kv_b_proj`` gives each head's no-RoPE
  key and its 128-wide value. RoPE on interleaved pairs at YaRN's
  frequencies, its tables and rotation in fp32; the softmax scale is
  qk_head_dim^-1/2 times YaRN's mscale^2 (DeepSeek's own code). Attention
  is kernel B1's causal mode (ops/flash_attention.py) at q/k head dim 192
  and v head dim 128: causal inside each segment on the packed path,
  causal over the right-padded row on the padded one; the plain twin on
  the CPU;
- the first ``first_k_dense_replace`` layers a SwiGLU, the others the
  routed experts of ops/moe.py (router over every routed expert, a grouped
  GEMM, a weighted combine; pad tokens are routed nowhere) plus the shared
  experts as one dense SwiGLU of width n_shared x F;
- the mean of the final hidden states over the real tokens (pad tokens
  pooled out), in fp32; normalised by the caller.

One ``nn.Module`` whose dtype is the compute dtype (bf16 on the card). The
model keeps ``expert_tokens``, an (MoE layers, routed experts) int64
buffer on its device to which every forward adds each expert's real
tokens (inside a CUDA graph too); its owner reads it at a traced request's
device wait (inference/loaders.py).

Weights come from an HF checkpoint's state dict, tensor by tensor straight
into the model's parameters on its device (``load_tensors``), so a model
of 31 GB never sits in host memory whole. The LM head, which an embedder
drops, is not read.
"""

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Tuple

import torch
import torch.nn as nn

from marqo_tpu_torch.models.bert import empty_module
from marqo_tpu_torch.ops import flash_attention, moe
from marqo_tpu_torch.ops.common import l2_normalize, masked_mean_pool


@dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 163840
    # rope_scaling's items, sorted (hashable: the config keys CUDA graphs)
    rope_scaling: Tuple[Tuple[str, object], ...] = ()
    normalize: bool = False

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace


def config_from_hf(hf: dict) -> DeepseekV2Config:
    """The config of an HF ``deepseek_v2`` config.json (a dict). Raises
    ValueError for what this module does not compute: a query LoRA, or
    routing other than greedy top-k over a softmax."""
    if hf.get("q_lora_rank") is not None:
        raise ValueError("deepseek_v2: a query LoRA (q_lora_rank) is not "
                         "supported")
    if hf.get("topk_method", "greedy") != "greedy" or \
            hf.get("scoring_func", "softmax") != "softmax":
        raise ValueError(f"deepseek_v2: routing {hf.get('topk_method')} / "
                         f"{hf.get('scoring_func')} is not supported (greedy "
                         f"softmax only)")
    scaling = hf.get("rope_scaling") or {}
    return DeepseekV2Config(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        qk_nope_head_dim=hf["qk_nope_head_dim"],
        qk_rope_head_dim=hf["qk_rope_head_dim"],
        v_head_dim=hf["v_head_dim"], kv_lora_rank=hf["kv_lora_rank"],
        intermediate_size=hf["intermediate_size"],
        moe_intermediate_size=hf["moe_intermediate_size"],
        n_routed_experts=hf["n_routed_experts"],
        n_shared_experts=hf.get("n_shared_experts") or 0,
        num_experts_per_tok=hf["num_experts_per_tok"],
        first_k_dense_replace=hf.get("first_k_dense_replace", 0),
        norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
        routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        max_position_embeddings=hf.get("max_position_embeddings", 163840),
        rope_scaling=tuple(sorted(scaling.items())))


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn(config: DeepseekV2Config, device="cpu") -> tuple:
    """(inverse frequencies (rope dim / 2,) fp32 on ``device``, cos/sin
    scale, softmax scale): YaRN as DeepSeek's code and transformers compute
    it. Made on the device, so that a CUDA graph's capture holds them."""
    dim, base = config.qk_rope_head_dim, config.rope_theta
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                      device=device) / dim)
    s = dict(config.rope_scaling)
    softmax_scale = config.qk_head_dim ** -0.5
    if not s:
        return (1.0 / pos_freqs).float(), 1.0, softmax_scale
    factor = s["factor"]
    original = s.get("original_max_position_embeddings") or \
        config.max_position_embeddings
    beta_fast, beta_slow = s.get("beta_fast") or 32, s.get("beta_slow") or 1

    def correction_dim(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))) / \
            (2 * math.log(base))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device)
             - low) / (high - low)).clamp(0, 1)
    inv_freq = (1.0 / (factor * pos_freqs)) * ramp + \
        (1.0 / pos_freqs) * (1 - ramp)
    m, m_all = s.get("mscale"), s.get("mscale_all_dim")
    cos_scale = _mscale(factor, m) / _mscale(factor, m_all) if m and m_all \
        else _mscale(factor, 1.0)
    if m_all:
        softmax_scale *= _mscale(factor, m_all) ** 2
    return inv_freq.float(), cos_scale, softmax_scale


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics, scaled in x's dtype."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return scale * normed.to(x.dtype)


def rope_tables(positions: torch.Tensor, config: DeepseekV2Config):
    """(cos, sin) fp32 of (B, S) positions: (B, S, 1, rope dim / 2)."""
    inv_freq, cos_scale, _ = yarn(config, positions.device)
    angles = positions.float()[..., None] * inv_freq
    return ((torch.cos(angles) * cos_scale)[:, :, None],
            (torch.sin(angles) * cos_scale)[:, :, None])


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x (..., d) rotated on interleaved pairs in fp32, in x's dtype."""
    x32 = x.float()
    even, odd = x32[..., 0::2], x32[..., 1::2]
    return torch.stack([even * cos - odd * sin, even * sin + odd * cos],
                       dim=-1).flatten(-2).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, c: DeepseekV2Config):
        super().__init__()
        H, N = c.hidden_size, c.num_heads
        self.q_proj = nn.Linear(H, N * c.qk_head_dim, bias=False)
        self.kv_a = nn.Linear(H, c.kv_lora_rank + c.qk_rope_head_dim,
                              bias=False)
        self.kv_a_norm = nn.Parameter(torch.empty(c.kv_lora_rank))
        self.kv_b = nn.Linear(c.kv_lora_rank,
                              N * (c.qk_nope_head_dim + c.v_head_dim),
                              bias=False)
        self.o_proj = nn.Linear(N * c.v_head_dim, H, bias=False)

    def forward(self, x, c: DeepseekV2Config, rope, attend) -> torch.Tensor:
        B, S, _ = x.shape
        N, nope, rd = c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        q = self.q_proj(x).view(B, S, N, nope + rd)
        kv = self.kv_a(x)
        latent = rms_norm(kv[..., :c.kv_lora_rank], self.kv_a_norm,
                          c.rms_norm_eps)
        kv_b = self.kv_b(latent).view(B, S, N, nope + c.v_head_dim)
        k = torch.empty_like(q)
        k[..., :nope] = kv_b[..., :nope]
        k[..., nope:] = rotate(kv[..., None, c.kv_lora_rank:], *rope)
        q[..., nope:] = rotate(q[..., nope:], *rope)
        ctx = attend(q.transpose(1, 2), k.transpose(1, 2),
                     kv_b[..., nope:].transpose(1, 2))
        return self.o_proj(ctx.transpose(1, 2).reshape(B, S, -1))


class DenseMLP(nn.Module):
    """A SwiGLU; ``gate_up`` holds [gate; up] rows."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_up = nn.Linear(hidden, 2 * width, bias=False)
        self.down = nn.Linear(width, hidden, bias=False)

    def forward(self, x, valid=None, counts=None) -> torch.Tensor:
        gate, up = self.gate_up(x).chunk(2, dim=-1)
        return self.down(nn.functional.silu(gate) * up)


class MoE(nn.Module):
    """The router and the routed experts' weights stacked for the grouped
    GEMM, and the shared experts as one SwiGLU of width
    ``n_shared_experts`` x ``moe_intermediate_size`` (None without)."""

    def __init__(self, c: DeepseekV2Config):
        super().__init__()
        H, F, E = c.hidden_size, c.moe_intermediate_size, c.n_routed_experts
        self.config = c
        self.router = nn.Parameter(torch.empty(E, H))
        self.gate_up = nn.Parameter(torch.empty(E, 2 * F, H))
        self.down = nn.Parameter(torch.empty(E, H, F))
        self.shared = DenseMLP(H, c.n_shared_experts * F) \
            if c.n_shared_experts else None

    def forward(self, x, valid, counts=None) -> torch.Tensor:
        c = self.config
        B, S, H = x.shape
        out = moe.expert_layer(
            x.reshape(B * S, H), valid.reshape(B * S), self.router,
            self.gate_up, self.down, c.num_experts_per_tok,
            c.norm_topk_prob, c.routed_scaling_factor, counts).view(B, S, H)
        return out if self.shared is None else out + self.shared(x)


class DecoderLayer(nn.Module):
    def __init__(self, c: DeepseekV2Config, index: int):
        super().__init__()
        self.input_norm = nn.Parameter(torch.empty(c.hidden_size))
        self.attn = Attention(c)
        self.post_norm = nn.Parameter(torch.empty(c.hidden_size))
        self.mlp = DenseMLP(c.hidden_size, c.intermediate_size) \
            if index < c.first_k_dense_replace else MoE(c)

    def forward(self, x, c, rope, attend, valid, counts) -> torch.Tensor:
        eps = c.rms_norm_eps
        x = x + self.attn(rms_norm(x, self.input_norm, eps), c, rope, attend)
        return x + self.mlp(rms_norm(x, self.post_norm, eps), valid, counts)


class DeepseekV2Encoder(nn.Module):
    def __init__(self, config: DeepseekV2Config):
        super().__init__()
        self.config = config
        self.embed = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            DecoderLayer(config, i) for i in range(config.num_layers))
        self.norm = nn.Parameter(torch.empty(config.hidden_size))
        self.register_buffer("expert_tokens", torch.zeros(
            (config.moe_layers, config.n_routed_experts), dtype=torch.int64),
            persistent=False)

    def hidden(self, input_ids, positions, valid, attend) -> torch.Tensor:
        """Final hidden states (B, S, H) of the rows."""
        c = self.config
        x = self.embed(input_ids.long())
        rope = rope_tables(positions, c)
        for i, layer in enumerate(self.layers):
            j = i - c.first_k_dense_replace
            counts = self.expert_tokens[j] if j >= 0 else None
            x = layer(x, c, rope, attend, valid, counts)
        return rms_norm(x, self.norm, c.rms_norm_eps)


def _finish(pooled: torch.Tensor, config: DeepseekV2Config) -> torch.Tensor:
    return l2_normalize(pooled) if config.normalize else pooled.float()


def encode_tokens(model: DeepseekV2Encoder, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor) -> torch.Tensor:
    """Right-padded (B, S) rows -> (B, H) fp32 mean-pooled embeddings;
    attention causal over each row's real tokens."""
    c = model.config
    scale = yarn(c)[2]
    B, S = input_ids.shape
    positions = torch.arange(S, device=input_ids.device).expand(B, S)

    def attend(q, k, v):
        return flash_attention.attention_padding(
            q, k, v, attention_mask, causal=True, scale=scale)

    x = model.hidden(input_ids, positions, attention_mask > 0, attend)
    return _finish(masked_mean_pool(x, attention_mask), c)


def encode_tokens_packed(model: DeepseekV2Encoder, input_ids: torch.Tensor,
                         segment_ids: torch.Tensor, positions: torch.Tensor,
                         seq_index: torch.Tensor,
                         num_sequences: int) -> torch.Tensor:
    """Packed rows (ops/packing.py: positions restart per sequence) ->
    (num_sequences, H) fp32 mean-pooled embeddings; attention causal inside
    each segment."""
    c = model.config
    scale = yarn(c)[2]

    def attend(q, k, v):
        return flash_attention.attention_segment(
            q, k, v, segment_ids, causal=True, scale=scale)

    x = model.hidden(input_ids, positions, segment_ids > 0, attend)
    B, S, H = x.shape
    flat = x.reshape(B * S, H).float()
    index = seq_index.reshape(B * S).long()
    index = torch.where(index < 0, num_sequences, index)
    weights = (segment_ids.reshape(B * S) > 0).float()
    sums = flat.new_zeros((num_sequences + 1, H))
    sums.index_add_(0, index, flat * weights[:, None])
    counts = weights.new_zeros(num_sequences + 1)
    counts.index_add_(0, index, weights)
    return _finish(sums[:-1] / counts[:-1, None].clamp_min(1e-9), c)


# --- weights -------------------------------------------------------------------

def empty_model(config: DeepseekV2Config, dtype, device) -> DeepseekV2Encoder:
    """The model with uninitialised parameters on ``device`` in ``dtype``
    (the expert-token counts zeroed)."""
    model = empty_module(lambda: DeepseekV2Encoder(config), dtype, device)
    model.expert_tokens = torch.zeros_like(model.expert_tokens,
                                           dtype=torch.int64)
    return model


def _target(model: DeepseekV2Encoder, name: str):
    """The parameter view a checkpoint tensor ``name`` (``model.`` prefix
    dropped) fills, or None for one the embedder does not read (the LM
    head)."""
    parts = name.split(".")
    if name == "embed_tokens.weight":
        return model.embed.weight
    if name == "norm.weight":
        return model.norm
    if parts[0] != "layers":
        return None
    layer = model.layers[int(parts[1])]
    rest = ".".join(parts[2:])
    simple = {
        "input_layernorm.weight": layer.input_norm,
        "post_attention_layernorm.weight": layer.post_norm,
        "self_attn.q_proj.weight": layer.attn.q_proj.weight,
        "self_attn.kv_a_proj_with_mqa.weight": layer.attn.kv_a.weight,
        "self_attn.kv_a_layernorm.weight": layer.attn.kv_a_norm,
        "self_attn.kv_b_proj.weight": layer.attn.kv_b.weight,
        "self_attn.o_proj.weight": layer.attn.o_proj.weight,
    }
    if rest in simple:
        return simple[rest]
    mlp = layer.mlp
    if rest == "mlp.gate.weight":
        return mlp.router
    if parts[2:4] == ["mlp", "experts"]:
        e, proj = int(parts[4]), parts[5]
        F = model.config.moe_intermediate_size
        return {"gate_proj": mlp.gate_up[e, :F], "up_proj": mlp.gate_up[e, F:],
                "down_proj": mlp.down[e]}[proj]
    # the dense layer's SwiGLU and the MoE layers' shared one
    if isinstance(mlp, DenseMLP):
        swiglu, proj = mlp, parts[3]
    elif parts[2:4] == ["mlp", "shared_experts"] and mlp.shared is not None:
        swiglu, proj = mlp.shared, parts[4]
    else:
        raise KeyError(f"deepseek_v2: unknown checkpoint tensor {name}")
    gate, up = swiglu.gate_up.weight.chunk(2)
    return {"gate_proj": gate, "up_proj": up,
            "down_proj": swiglu.down.weight}[proj]


@torch.no_grad()
def load_tensors(model: DeepseekV2Encoder,
                 tensors: Iterable[Tuple[str, Callable[[], torch.Tensor]]]
                 ) -> DeepseekV2Encoder:
    """Fill ``model`` from (name, read) pairs of an HF state dict, one
    tensor at a time: each read, copied into its parameter on the model's
    device, then dropped. Raises if a parameter was never filled or a
    tensor has another shape."""
    filled = set()
    for name, read in tensors:
        short = name[len("model."):] if name.startswith("model.") else name
        target = _target(model, short)
        if target is None:
            continue
        value = read()
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{name}: expected {tuple(target.shape)}, "
                             f"got {tuple(value.shape)}")
        target.copy_(value)
        filled.add(short)
    expected = {n for n in _checkpoint_names(model.config)}
    missing = expected - filled
    if missing:
        raise KeyError(f"deepseek_v2 weights missing: {sorted(missing)[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return model


def _checkpoint_names(c: DeepseekV2Config) -> list:
    """Every checkpoint tensor the embedder reads (``model.`` dropped)."""
    names = ["embed_tokens.weight", "norm.weight"]
    for i in range(c.num_layers):
        pre = f"layers.{i}."
        names += [pre + n for n in (
            "input_layernorm.weight", "post_attention_layernorm.weight",
            "self_attn.q_proj.weight", "self_attn.kv_a_proj_with_mqa.weight",
            "self_attn.kv_a_layernorm.weight", "self_attn.kv_b_proj.weight",
            "self_attn.o_proj.weight")]
        projections = ("gate_proj", "up_proj", "down_proj")
        if i < c.first_k_dense_replace:
            names += [f"{pre}mlp.{p}.weight" for p in projections]
            continue
        names.append(pre + "mlp.gate.weight")
        names += [f"{pre}mlp.experts.{e}.{p}.weight"
                  for e in range(c.n_routed_experts) for p in projections]
        if c.n_shared_experts:
            names += [f"{pre}mlp.shared_experts.{p}.weight"
                      for p in projections]
    return names
