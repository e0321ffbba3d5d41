"""BERT-family text encoder in PyTorch (port of marqo_tpu/models/bert.py).

Covers the reference's HF text-model families (e5, SBERT/MiniLM, BGE,
multilingual-e5 / XLM-R — reference src/marqo/core/inference/
embedding_models/hugging_face_model.py:24-220 and sbert_utils.py): a post-LN
transformer encoder with absolute position embeddings, followed by
cls/mean pooling and L2 normalization.

The encoder is an ``nn.Module`` whose dtype is the compute dtype (bf16 when
serving); LayerNorm, softmax and pooling statistics run in fp32
(ops/common.py). Attention goes through ops/flash_attention.py (or, with
``attention_impl="flash"``, ops/fused_attention.py): the hand-written CUDA
kernel on a CUDA device, its plain twin on the CPU. The
linear layers are plain ``nn.Linear`` matmuls. It only serves: no autograd.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.ops import flash_attention, fused_attention
from marqo_tpu_torch.ops.common import (ACTIVATIONS, cls_pool, l2_normalize,
                                        layer_norm, masked_mean_pool)


@dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    pooling: str = "mean"  # "mean" | "cls"
    normalize: bool = True
    # XLM-R/RoBERTa offset position ids by pad_token_id+1 (padding_idx=1)
    position_offset: int = 0
    # "kernel": ops/flash_attention.py wrappers (CUDA kernel B1 on a CUDA
    # device, plain twin on the CPU); "flash": ops/fused_attention.py (CUDA
    # kernel B2; pad rows attend to each other); "plain": always B1's twin
    attention_impl: str = "kernel"
    # W8A8 int8 linear layers: not ported yet
    quantize: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


_ATTENTION = {
    ("kernel", "padding"): flash_attention.attention_padding,
    ("kernel", "segment"): flash_attention.attention_segment,
    ("plain", "padding"): flash_attention.attention_padding_reference,
    ("plain", "segment"): flash_attention.attention_segment_reference,
    ("flash", "padding"): lambda q, k, v, mask:
        fused_attention.fused_attention(q, k, v, pad_mask=mask),
    ("flash", "segment"): lambda q, k, v, segment_ids:
        fused_attention.fused_attention(q, k, v, segment_ids=segment_ids),
}


class Embeddings(nn.Module):
    def __init__(self, config: TextEncoderConfig):
        super().__init__()
        H = config.hidden_size
        self.word = nn.Embedding(config.vocab_size, H)
        self.position = nn.Embedding(config.max_position_embeddings, H)
        self.token_type = nn.Embedding(config.type_vocab_size, H)
        self.ln = nn.LayerNorm(H)
        self.eps = config.layer_norm_eps

    def forward(self, input_ids, positions, token_type_ids) -> torch.Tensor:
        x = self.word(input_ids) + self.position(positions) + \
            self.token_type(token_type_ids)
        return layer_norm(x, self.ln.weight, self.ln.bias, self.eps)


class EncoderLayer(nn.Module):
    """One post-LN transformer block (marqo_tpu bert.py `_encoder_layer`)."""

    def __init__(self, config: TextEncoderConfig):
        super().__init__()
        H, I = config.hidden_size, config.intermediate_size
        self.config = config
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)
        self.attn_out = nn.Linear(H, H)
        self.attn_ln = nn.LayerNorm(H)
        self.ffn_in = nn.Linear(H, I)
        self.ffn_out = nn.Linear(I, H)
        self.ffn_ln = nn.LayerNorm(H)

    def forward(self, x: torch.Tensor, attend,
                mask_data: torch.Tensor) -> torch.Tensor:
        """x: (B, S, H); ``attend(q, k, v, mask_data)`` is one of the
        ``_ATTENTION`` entries for ``mask_data``'s mode."""
        config = self.config
        B, S, H = x.shape
        N, D = config.num_heads, config.head_dim

        def heads(t):
            return t.view(B, S, N, D).transpose(1, 2).contiguous()

        q = heads(self.query(x))
        k = heads(self.key(x))
        v = heads(self.value(x))
        ctx = attend(q, k, v, mask_data)
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        eps = config.layer_norm_eps
        x = layer_norm(x + self.attn_out(ctx), self.attn_ln.weight,
                       self.attn_ln.bias, eps)
        h = ACTIVATIONS[config.hidden_act](self.ffn_in(x))
        return layer_norm(x + self.ffn_out(h), self.ffn_ln.weight,
                          self.ffn_ln.bias, eps)


class TextEncoder(nn.Module):
    """Embeddings + encoder layers; the module's dtype is the compute dtype."""

    def __init__(self, config: TextEncoderConfig):
        super().__init__()
        if config.quantize:
            raise NotImplementedError("int8 path: ROADMAP A4")
        self.config = config
        self.embeddings = Embeddings(config)
        self.layers = nn.ModuleList(
            EncoderLayer(config) for _ in range(config.num_layers))

    def run_layers(self, x: torch.Tensor, mode: str,
                   mask_data: torch.Tensor) -> torch.Tensor:
        """mode "padding" with a (B, S) 0/1 mask, or "segment" with (B, S)
        segment ids (0 = padding)."""
        attend = _ATTENTION[(self.config.attention_impl, mode)]
        for layer in self.layers:
            x = layer(x, attend, mask_data)
        return x


def _empty_encoder(config: TextEncoderConfig, dtype,
                   device) -> TextEncoder:
    """An encoder with uninitialised storage on ``device`` (no random
    init work; every caller fills all parameters)."""
    with torch.device("meta"):
        encoder = TextEncoder(config)
    return encoder.to_empty(device=device).to(dtype).eval().requires_grad_(False)


@torch.no_grad()
def fill_parameters(module: nn.Module, values: dict) -> nn.Module:
    """Copy ``values`` (name → array or tensor) into every parameter of
    ``module``; raise if one is missing or has another shape."""
    params = dict(module.named_parameters())
    missing = set(params) - set(values)
    if missing:
        raise KeyError(f"weights missing: {sorted(missing)}")
    for name, param in params.items():
        value = values[name]
        value = value.float() if torch.is_tensor(value) else \
            torch.from_numpy(np.array(value, dtype=np.float32))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: expected {tuple(param.shape)}, got "
                             f"{tuple(value.shape)}")
        param.copy_(value)
    return module


def init_encoder(config: TextEncoderConfig, generator: torch.Generator,
                 dtype=torch.float32, device="cpu") -> TextEncoder:
    """Random-init encoder (normal(0, 0.02) weights, zero biases, unit
    LayerNorm scales), drawn from ``generator`` on ``device``."""
    encoder = _empty_encoder(config, dtype, device)
    with torch.no_grad():
        for name, param in encoder.named_parameters():
            if name.endswith("ln.weight"):
                param.fill_(1.0)
            elif name.endswith("bias"):
                param.zero_()
            else:
                param.copy_(torch.randn(param.shape, generator=generator,
                                        device=param.device) * 0.02)
    return encoder


def encode_tokens(encoder: TextEncoder, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor,
                  token_type_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Full forward: token ids → pooled, (optionally) L2-normalized fp32
    embeddings of shape (B, H)."""
    config = encoder.config
    input_ids = input_ids.long()
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    positions = torch.arange(input_ids.shape[1], device=input_ids.device)
    x = encoder.embeddings(input_ids,
                           (positions + config.position_offset)[None, :],
                           token_type_ids.long())
    x = encoder.run_layers(x, "padding", attention_mask)
    if config.pooling == "cls":
        pooled = cls_pool(x, attention_mask)
    else:
        pooled = masked_mean_pool(x, attention_mask)
    if config.normalize:
        pooled = l2_normalize(pooled)
    return pooled


def encode_tokens_packed(encoder: TextEncoder, input_ids: torch.Tensor,
                         segment_ids: torch.Tensor, positions: torch.Tensor,
                         seq_index: torch.Tensor, num_sequences: int
                         ) -> torch.Tensor:
    """Packed forward (ops/packing.py): multiple documents per row with
    block-diagonal attention by segment and segment-sum pooling.

    Returns (num_sequences, H) fp32 pooled embeddings.
    """
    config = encoder.config
    input_ids = input_ids.long()
    B, S = input_ids.shape
    x = encoder.embeddings(input_ids,
                           positions.long() + config.position_offset,
                           torch.zeros_like(input_ids))
    # block-diagonal attention: tokens attend only within their segment
    x = encoder.run_layers(x, "segment", segment_ids)

    # segment pooling over the flattened token stream; pad tokens
    # (seq_index == -1) route to a trash row
    flat_h = x.reshape(B * S, -1).float()
    flat_idx = seq_index.reshape(B * S).long()
    flat_idx = torch.where(flat_idx < 0, num_sequences, flat_idx)
    real = segment_ids.reshape(B * S) > 0
    if config.pooling == "cls":
        weights = ((positions.reshape(B * S) == 0) & real).float()
    else:
        weights = real.float()
    sums = flat_h.new_zeros((num_sequences + 1, flat_h.shape[1]))
    sums.index_add_(0, flat_idx, flat_h * weights[:, None])
    counts = weights.new_zeros(num_sequences + 1)
    counts.index_add_(0, flat_idx, weights)
    pooled = sums[:num_sequences] / counts[:num_sequences, None].clamp_min(
        1e-9)
    if config.normalize:
        pooled = l2_normalize(pooled)
    return pooled


def config_from_hf(hf_config) -> TextEncoderConfig:
    """Build a TextEncoderConfig from a transformers Bert/Roberta/XLM-R config."""
    model_type = getattr(hf_config, "model_type", "bert")
    offset = 0
    if model_type in ("roberta", "xlm-roberta"):
        offset = hf_config.pad_token_id + 1
    return TextEncoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=getattr(hf_config, "type_vocab_size", 1) or 1,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_act=hf_config.hidden_act,
        position_offset=offset,
    )


# this module's parameter names ← HF Bert/Roberta state-dict names
_HF_EMBEDDINGS = {
    "embeddings.word.weight": "embeddings.word_embeddings.weight",
    "embeddings.position.weight": "embeddings.position_embeddings.weight",
    "embeddings.ln.weight": "embeddings.LayerNorm.weight",
    "embeddings.ln.bias": "embeddings.LayerNorm.bias",
}
_HF_LAYER = {
    "query": "attention.self.query",
    "key": "attention.self.key",
    "value": "attention.self.value",
    "attn_out": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "ffn_in": "intermediate.dense",
    "ffn_out": "output.dense",
    "ffn_ln": "output.LayerNorm",
}


def params_from_torch_state_dict(state_dict, config: TextEncoderConfig,
                                 dtype=torch.float32,
                                 device="cpu") -> TextEncoder:
    """An encoder holding an HF Bert/Roberta-style ``state_dict``.

    Handles both bare-model keys (``embeddings.…``) and prefixed
    (``bert.embeddings.…`` / ``roberta.…``). torch's (out, in) linear
    layout is this module's own, so weights copy as they are.
    """
    sd = {}
    for key, tensor in state_dict.items():
        for prefix in ("bert.", "roberta.", "model.", "xlm-roberta."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        sd[key] = torch.as_tensor(tensor).detach().cpu()

    values = {name: sd[hf] for name, hf in _HF_EMBEDDINGS.items()}
    values["embeddings.token_type.weight"] = sd.get(
        "embeddings.token_type_embeddings.weight",
        torch.zeros((1, config.hidden_size)))
    for i in range(config.num_layers):
        for name, hf in _HF_LAYER.items():
            for kind in ("weight", "bias"):
                values[f"layers.{i}.{name}.{kind}"] = \
                    sd[f"encoder.layer.{i}.{hf}.{kind}"]
    config = _with_type_vocab(config, values["embeddings.token_type.weight"])
    return fill_parameters(_empty_encoder(config, dtype, device), values)


# this module's per-layer parameter names ← marqo_tpu stacked pytree keys
# (weights stored (in, out) there, so they transpose)
_JAX_LAYER = {
    "query": ("q_w", "q_b"), "key": ("k_w", "k_b"), "value": ("v_w", "v_b"),
    "attn_out": ("o_w", "o_b"),
    "attn_ln": ("attn_ln_scale", "attn_ln_bias"),
    "ffn_in": ("ffn_w1", "ffn_b1"), "ffn_out": ("ffn_w2", "ffn_b2"),
    "ffn_ln": ("ffn_ln_scale", "ffn_ln_bias"),
}


def params_from_jax(params_numpy: dict, config: TextEncoderConfig,
                    dtype=torch.float32, device="cpu") -> TextEncoder:
    """An encoder holding marqo_tpu's parameter pytree, given as numpy
    arrays ({"embeddings": {...}, "layers": {...}} with stacked layers)."""
    emb, layers = params_numpy["embeddings"], params_numpy["layers"]
    values = {
        "embeddings.word.weight": emb["word"],
        "embeddings.position.weight": emb["position"],
        "embeddings.token_type.weight": emb["token_type"],
        "embeddings.ln.weight": emb["ln_scale"],
        "embeddings.ln.bias": emb["ln_bias"],
    }
    for i in range(config.num_layers):
        for name, (w, b) in _JAX_LAYER.items():
            # .T turns (in, out) into (out, in); 1-D LayerNorm scales pass
            values[f"layers.{i}.{name}.weight"] = np.asarray(layers[w][i]).T
            values[f"layers.{i}.{name}.bias"] = layers[b][i]
    config = _with_type_vocab(config, values["embeddings.token_type.weight"])
    return fill_parameters(_empty_encoder(config, dtype, device), values)


def _with_type_vocab(config: TextEncoderConfig, table) -> TextEncoderConfig:
    """Size the token-type table to the checkpoint's (1 when absent)."""
    from dataclasses import replace
    return replace(config, type_vocab_size=int(table.shape[0]))
