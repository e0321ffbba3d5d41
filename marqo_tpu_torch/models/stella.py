"""Stella text encoder (GTE-v1.5 "NewModel" backbone) in PyTorch (port of
marqo_tpu/models/stella.py).

Parity target: the reference loads `Marqo/dunzhang-stella_en_400M_v5` as
type `hf_stella` with trust_remote_code
(reference model_registry.py:898-904, 2144;
core/inference/embedding_models/hugging_face_stella_model.py:9-23). The
remote code is the Alibaba GTE-en-v1.5 "new" architecture, which differs
from BERT in three ways:

  1. rotary position embeddings (RoPE) instead of learned absolute
     positions (no position-embedding table; rope_theta sets the base),
  2. a gated MLP: ``down(act(gate(x)) * up(x))`` with a packed
     ``up_gate_proj`` weight ([UP; GATE] rows), instead of the 2-layer GELU
     MLP,
  3. packed ``qkv_proj`` attention weights.

It keeps BERT's post-LayerNorm residual layout. Stella adds a linear
projection head (``vector_linear``, the checkpoint's ``2_Dense_<dims>``
module) applied after mean pooling.

One ``nn.Module`` whose dtype is the compute dtype; LayerNorm and pooling
statistics and the projection head run in fp32, and the RoPE tables are
fp32, cast to the compute dtype before the product (as the JAX package
does). Attention is kernel B1's padding mode (ops/flash_attention.py): the
CUDA kernel on a CUDA device, its plain twin on the CPU. Real-weight
loading requires the checkpoint on disk (no hub egress here).
"""

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.ops import flash_attention
from marqo_tpu_torch.ops.common import (ACTIVATIONS, l2_normalize,
                                        layer_norm, masked_mean_pool)


@dataclass(frozen=True)
class StellaConfig:
    vocab_size: int = 30528
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 8192
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    rope_theta: float = 160000.0
    projection_dim: int = 1024  # vector_linear output width
    normalize: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def stella_400m_config(projection_dim: int = 1024) -> StellaConfig:
    """dunzhang/stella_en_400M_v5: GTE-large-en-v1.5 backbone (1024h/24L/
    16 heads/4096 ffn ≈ 434M params) + the requested projection head."""
    return StellaConfig(projection_dim=projection_dim)


def rope_tables(seq_len: int, head_dim: int, theta: float, device):
    """(seq, head_dim/2) fp32 cos/sin tables."""
    positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                    device=device) / head_dim)
    angles = positions[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, N, S, D) with D even; rotate-half convention (pairs are
    (x[..., :D/2], x[..., D/2:]), matching HF rotary implementations)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class StellaLayer(nn.Module):
    """One post-LN block: packed qkv with RoPE, gated MLP."""

    def __init__(self, config: StellaConfig):
        super().__init__()
        H, I = config.hidden_size, config.intermediate_size
        self.config = config
        self.qkv = nn.Linear(H, 3 * H)
        self.o = nn.Linear(H, H)
        self.attn_ln = nn.LayerNorm(H)
        self.up_gate = nn.Linear(H, 2 * I, bias=False)
        self.down = nn.Linear(I, H)
        self.mlp_ln = nn.LayerNorm(H)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor,
                rope) -> torch.Tensor:
        config = self.config
        B, S, H = x.shape
        N, D = config.num_heads, config.head_dim
        cos, sin = rope

        def heads(t):
            return t.reshape(B, S, N, D).transpose(1, 2)

        # RoPE writes new q and k; v stays a view of the fused projection
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = apply_rope(heads(q), cos, sin)
        k = apply_rope(heads(k), cos, sin)
        ctx = flash_attention.attention_padding(q, k, heads(v),
                                                attention_mask)
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        eps = config.layer_norm_eps
        x = layer_norm(x + self.o(ctx), self.attn_ln.weight,
                       self.attn_ln.bias, eps)
        up, gate = self.up_gate(x).chunk(2, dim=-1)
        h = ACTIVATIONS[config.hidden_act](gate) * up
        return layer_norm(x + self.down(h), self.mlp_ln.weight,
                          self.mlp_ln.bias, eps)


class StellaEncoder(nn.Module):
    """Embeddings (word + token type, no positions), the layers and the
    projection head; the module's dtype is the compute dtype."""

    def __init__(self, config: StellaConfig):
        super().__init__()
        H = config.hidden_size
        self.config = config
        self.word = nn.Embedding(config.vocab_size, H)
        self.token_type = nn.Embedding(config.type_vocab_size, H)
        self.ln = nn.LayerNorm(H)
        self.layers = nn.ModuleList(
            StellaLayer(config) for _ in range(config.num_layers))
        self.projection = nn.Linear(H, config.projection_dim)


def encode_tokens(model: StellaEncoder, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor) -> torch.Tensor:
    """Token ids → pooled, projected, (optionally) normalized fp32
    embeddings of shape (B, projection_dim)."""
    config = model.config
    input_ids = input_ids.long()
    x = model.word(input_ids) + model.token_type(torch.zeros_like(input_ids))
    x = layer_norm(x, model.ln.weight, model.ln.bias, config.layer_norm_eps)
    rope = rope_tables(input_ids.shape[1], config.head_dim,
                       config.rope_theta, input_ids.device)
    for layer in model.layers:
        x = layer(x, attention_mask, rope)
    pooled = masked_mean_pool(x, attention_mask)  # fp32
    pooled = pooled @ model.projection.weight.float().T + \
        model.projection.bias.float()
    if config.normalize:
        pooled = l2_normalize(pooled)
    return pooled.float()


# --- init + conversion -------------------------------------------------------

def init_stella(config: StellaConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> StellaEncoder:
    """Random-init model (normal(0, 0.02) weights and embeddings, zero
    biases, unit LayerNorm scales), drawn from ``generator`` on
    ``device``."""
    return random_init(empty_module(lambda: StellaEncoder(config), dtype,
                                    device), generator)


# this module's per-layer names ← GTE "NewModel" state-dict names
_HF_LAYER = {
    "qkv.weight": "attention.qkv_proj.weight",
    "qkv.bias": "attention.qkv_proj.bias",
    "o.weight": "attention.o_proj.weight",
    "o.bias": "attention.o_proj.bias",
    "attn_ln.weight": "attn_ln.weight", "attn_ln.bias": "attn_ln.bias",
    "up_gate.weight": "mlp.up_gate_proj.weight",
    "down.weight": "mlp.down_proj.weight", "down.bias": "mlp.down_proj.bias",
    "mlp_ln.weight": "mlp_ln.weight", "mlp_ln.bias": "mlp_ln.bias",
}


def _build(config: StellaConfig, values: dict, dtype,
           device) -> StellaEncoder:
    config = replace(config, type_vocab_size=int(
        values["token_type.weight"].shape[0]))
    return fill_parameters(
        empty_module(lambda: StellaEncoder(config), dtype, device), values)


def params_from_torch_state_dict(state_dict, config: StellaConfig,
                                 dtype=torch.float32, device="cuda",
                                 vector_linear: dict = None
                                 ) -> StellaEncoder:
    """A model holding a GTE-v1.5/"NewModel" torch state dict.

    Handles the remote-code naming (`new.encoder.layer.{i}.attention.
    qkv_proj`, `mlp.up_gate_proj`, `attn_ln`, `mlp_ln`); torch's (out, in)
    layout is this module's own. The checkpoint packs up_gate_proj as
    [UP; GATE] rows — kept in that order. `vector_linear` is the stella
    `2_Dense_<dims>` head ({"weight", "bias"}); identity when absent."""
    sd = {}
    for key, tensor in state_dict.items():
        for prefix in ("new.", "model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        sd[key] = torch.as_tensor(tensor).detach().cpu()
    H, P = config.hidden_size, config.projection_dim
    values = {
        "word.weight": sd["embeddings.word_embeddings.weight"],
        "token_type.weight": sd.get(
            "embeddings.token_type_embeddings.weight", torch.zeros((1, H))),
        "ln.weight": sd["embeddings.LayerNorm.weight"],
        "ln.bias": sd["embeddings.LayerNorm.bias"],
    }
    for i in range(config.num_layers):
        for name, hf in _HF_LAYER.items():
            values[f"layers.{i}.{name}"] = sd[f"encoder.layer.{i}.{hf}"]
    if vector_linear is not None:
        values["projection.weight"] = torch.as_tensor(vector_linear["weight"])
        values["projection.bias"] = torch.as_tensor(vector_linear["bias"])
    else:  # no head shipped: identity projection
        values["projection.weight"] = torch.eye(P, H)
        values["projection.bias"] = torch.zeros(P)
    return _build(config, values, dtype, device)


# this module's per-layer names ← marqo_tpu stacked pytree keys ((in, out)
# weights transpose)
_JAX_LAYER = {
    "qkv.weight": ("qkv_w", True), "qkv.bias": ("qkv_b", False),
    "o.weight": ("o_w", True), "o.bias": ("o_b", False),
    "attn_ln.weight": ("attn_ln_scale", False),
    "attn_ln.bias": ("attn_ln_bias", False),
    "up_gate.weight": ("up_gate_w", True),
    "down.weight": ("down_w", True), "down.bias": ("down_b", False),
    "mlp_ln.weight": ("mlp_ln_scale", False),
    "mlp_ln.bias": ("mlp_ln_bias", False),
}


def params_from_jax(params_numpy: dict, config: StellaConfig,
                    dtype=torch.float32, device="cuda") -> StellaEncoder:
    """A model holding marqo_tpu's Stella pytree, given as numpy arrays
    ({"embeddings", "layers" (stacked), "head"})."""
    emb, layers, head = (params_numpy["embeddings"], params_numpy["layers"],
                         params_numpy["head"])
    values = {
        "word.weight": emb["word"], "token_type.weight": emb["token_type"],
        "ln.weight": emb["ln_scale"], "ln.bias": emb["ln_bias"],
        "projection.weight": np.asarray(head["proj_w"]).T,
        "projection.bias": head["proj_b"],
    }
    for i in range(config.num_layers):
        for name, (key, transpose) in _JAX_LAYER.items():
            value = np.asarray(layers[key][i])
            values[f"layers.{i}.{name}"] = value.T if transpose else value
    return _build(config, values, dtype, device)
