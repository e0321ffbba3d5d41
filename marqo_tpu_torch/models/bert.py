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
kernel on a CUDA device, its plain twin on the CPU. The linear layers are
plain ``nn.Linear`` matmuls, or, with ``quantize=True``, ``Int8Linear``
(W8A8, ops/quant.py: CUDA kernel B3 on a CUDA device, its plain twin on the
CPU), where one (3H, H) layer computes q, k and v. The kernels have no
autograd formula: the float encoder trains on the plain twins
(parallel/train_step.py), and the int8 encoder only serves.

The builders (``init_encoder``, ``params_from_torch_state_dict``,
``params_from_jax``) put the encoder on the card unless the caller names
another device, and return it quantized when ``config.quantize`` is set.
"""

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from marqo_tpu_torch.core.exceptions import ModelLoadError
from marqo_tpu_torch.ops import flash_attention, fused_attention
from marqo_tpu_torch.ops.common import (ACTIVATIONS, cls_pool, l2_normalize,
                                        layer_norm, masked_mean_pool)
from marqo_tpu_torch.ops.quant import (int8_linear, int8_linear_reference,
                                       quantize_weight)
from marqo_tpu_torch.ops.quant_matmul import MAX_K


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
    # W8A8 int8 linear layers (ops/quant.py, kernel B3): opt-in
    quantize: bool = False
    # with quantize: "kernel" runs int8_linear (CUDA kernel B3 on a CUDA
    # device, its plain twin on the CPU); "plain" always B3's twin
    linear_impl: str = "kernel"

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


def kernel_k(in_features: int) -> int:
    """The int8 layers' K: ``in_features`` rounded up to the multiple of 16
    that kernel B3 takes. The padding columns are zeros, which change
    neither a row's absmax nor its int32 sum, so the output is the same bit
    for bit."""
    return -(-in_features // 16) * 16


class Int8Linear(nn.Module):
    """A W8A8 linear layer: int8 weights in ``nn.Linear``'s (out, in)
    layout with per-output-channel fp32 scales, and the bias in the compute
    dtype (buffers: nothing here trains). ``forward`` is
    ops/quant.py ``int8_linear`` (``impl="plain"``: its twin), so the
    output is in the input's dtype. The weights hold ``kernel_k(in)``
    columns, zero past ``in``, and ``forward`` pads x to match."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.register_buffer(
            "weight_q", torch.empty(out_features, kernel_k(in_features),
                                    dtype=torch.int8))
        self.register_buffer("weight_scale",
                             torch.empty(out_features, dtype=torch.float32))
        self.register_buffer("bias", torch.empty(out_features))

    @classmethod
    @torch.no_grad()
    def from_weight(cls, weight: torch.Tensor,
                    bias: torch.Tensor) -> "Int8Linear":
        """Quantize the (out, in) ``weight`` as it is held (in the compute
        dtype, as the JAX loader quantizes after its cast); keep ``bias``."""
        out_features, in_features = weight.shape
        with torch.device("meta"):
            module = cls(in_features, out_features)
        module.weight_q, module.weight_scale = quantize_weight(
            F.pad(weight, (0, kernel_k(in_features) - in_features)))
        module.bias = bias.detach().clone()
        return module

    def forward(self, x: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
        linear = int8_linear if impl == "kernel" else int8_linear_reference
        pad = self.weight_q.shape[1] - x.shape[-1]
        if pad:
            x = F.pad(x, (0, pad))
        return linear(x, self.weight_q, self.weight_scale, self.bias)


def check_kernel_shapes(config, device) -> None:
    """The load-time rule of the CUDA kernels: raise ModelLoadError, naming
    the head dim or the width, where no kernel takes the shapes of an
    encoder ``config`` (TextEncoderConfig, or any config with
    ``hidden_size`` and ``num_heads``) on ``device``, so such a model is
    refused when it loads, never at a launch. On CUDA, attention runs
    kernel B1 or B2, which take head dims that are multiples of 8 up to
    128, and a quantized encoder's linear layers run kernel B3, which takes
    K up to ``MAX_K``. The JAX package's default einsum attention takes any
    head dim; on the CPU the plain twins take any shape here too."""
    if torch.device(device).type != "cuda":
        return
    H, N = config.hidden_size, config.num_heads
    if getattr(config, "attention_impl", "kernel") != "plain" and (
            H % N or H // N not in flash_attention.HEAD_DIMS):
        raise ModelLoadError(
            f"hidden size {H} over {N} heads gives head dim {H / N:g}, which "
            f"no attention kernel of marqo_tpu_torch takes on CUDA (a "
            f"multiple of 8 up to 128)")
    if getattr(config, "quantize", False) and \
            getattr(config, "linear_impl", "kernel") != "plain":
        widest = max(H, config.intermediate_size)
        if kernel_k(widest) > MAX_K:
            raise ModelLoadError(
                f"width {widest} is more than the int8 kernel's K (up to "
                f"{MAX_K}) on CUDA")


# the float encoder's q, k and v projections, which quantize=True packs
# into one (3H, H) Int8Linear "qkv" whose rows are query, key, value: the
# weights are quantized per output row and every row of x has one scale, so
# its output equals the three separate int8 layers' bit for bit
QKV = ("query", "key", "value")
# a block's linear layers once quantize=True made them Int8Linear
QUANTIZED_LINEARS = ("qkv", "attn_out", "ffn_in", "ffn_out")


class EncoderLayer(nn.Module):
    """One post-LN transformer block (marqo_tpu bert.py `_encoder_layer`)."""

    def __init__(self, config: TextEncoderConfig):
        super().__init__()
        H, I = config.hidden_size, config.intermediate_size
        self.config = config
        linear = Int8Linear if config.quantize else nn.Linear
        if config.quantize:
            self.qkv = Int8Linear(H, 3 * H)
        else:
            self.query = nn.Linear(H, H)
            self.key = nn.Linear(H, H)
            self.value = nn.Linear(H, H)
        self.attn_out = linear(H, H)
        self.attn_ln = nn.LayerNorm(H)
        self.ffn_in = linear(H, I)
        self.ffn_out = linear(I, H)
        self.ffn_ln = nn.LayerNorm(H)

    def forward(self, x: torch.Tensor, attend, mask_data: torch.Tensor,
                linear_impl: str = "kernel") -> torch.Tensor:
        """x: (B, S, H); ``attend(q, k, v, mask_data)`` is one of the
        ``_ATTENTION`` entries for ``mask_data``'s mode; ``linear_impl``
        picks the int8 layers' kernel or twin when quantized."""
        config = self.config
        B, S, H = x.shape
        N, D = config.num_heads, config.head_dim

        def linear(name, t):
            module = getattr(self, name)
            if isinstance(module, Int8Linear):
                return module(t, linear_impl)
            return module(t)

        def heads(t):
            # a view: the kernels read the projection's layout by strides
            return t.view(B, S, N, D).transpose(1, 2)

        if config.quantize:
            # views of the packed (B, S, 3, N, D) output: S-stride 3H
            qkv = linear("qkv", x).view(B, S, 3, N, D)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = (heads(linear(name, x)) for name in QKV)
        ctx = attend(q, k, v, mask_data)
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        eps = config.layer_norm_eps
        x = layer_norm(x + linear("attn_out", ctx), self.attn_ln.weight,
                       self.attn_ln.bias, eps)
        h = ACTIVATIONS[config.hidden_act](linear("ffn_in", x))
        return layer_norm(x + linear("ffn_out", h), self.ffn_ln.weight,
                          self.ffn_ln.bias, eps)


class TextEncoder(nn.Module):
    """Embeddings + encoder layers; the module's dtype is the compute dtype."""

    def __init__(self, config: TextEncoderConfig):
        super().__init__()
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
            x = layer(x, attend, mask_data, self.config.linear_impl)
        return x


def empty_module(build: Callable[[], nn.Module], dtype,
                 device) -> nn.Module:
    """``build()`` with uninitialised storage on ``device`` in ``dtype``,
    in eval mode and without gradients (no random init work: every caller
    fills all parameters and buffers)."""
    with torch.device("meta"):
        module = build()
    return module.to_empty(device=device).to(dtype).eval().requires_grad_(
        False)


@torch.no_grad()
def random_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The package's random init, in place: LayerNorm scales 1, biases 0,
    every other parameter (weights, embeddings) normal(0, 0.02) drawn from
    ``generator`` in parameter order."""
    layer_norms = {id(p) for m in module.modules()
                   if isinstance(m, nn.LayerNorm) for p in m.parameters()}
    for name, param in module.named_parameters():
        if id(param) in layer_norms:
            param.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            param.zero_()
        else:
            param.copy_(torch.randn(param.shape, generator=generator,
                                    device=param.device) * 0.02)
    return module


def linear_layer(weight, bias, dtype, device) -> nn.Linear:
    """An ``nn.Linear`` holding (out, in) ``weight`` and ``bias`` (None:
    a layer without bias)."""
    out_features, in_features = weight.shape
    layer = empty_module(lambda: nn.Linear(in_features, out_features,
                                           bias=bias is not None),
                         dtype, device)
    values = {"weight": weight}
    if bias is not None:
        values["bias"] = bias
    return fill_parameters(layer, values)


def _empty_encoder(config: TextEncoderConfig, dtype,
                   device) -> TextEncoder:
    """An encoder with uninitialised storage on ``device``. Int8Linear
    scales stay fp32 through the cast to ``dtype``."""
    encoder = empty_module(lambda: TextEncoder(config), dtype, device)
    for module in encoder.modules():
        if isinstance(module, Int8Linear):
            module.weight_scale = module.weight_scale.float()
    return encoder


def tree_values(tree, prefix: str = "") -> dict:
    """The leaves of a nested dict/list tree by dotted path: the names
    ``named_parameters`` gives a module whose attributes mirror the tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    values = {}
    for key, value in items:
        values.update(tree_values(value, f"{prefix}{key}."))
    return values


@torch.no_grad()
def fill_parameters(module: nn.Module, values: dict) -> nn.Module:
    """Copy ``values`` (name → array or tensor) into every parameter and
    buffer of ``module``, each cast to its own dtype; raise if one is
    missing or has another shape."""
    tensors = {**dict(module.named_parameters()),
               **dict(module.named_buffers())}
    missing = set(tensors) - set(values)
    if missing:
        raise KeyError(f"weights missing: {sorted(missing)}")
    for name, tensor in tensors.items():
        value = values[name]
        value = value.float() if torch.is_tensor(value) else \
            torch.from_numpy(np.array(value, dtype=np.float32))
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{name}: expected {tuple(tensor.shape)}, got "
                             f"{tuple(value.shape)}")
        tensor.copy_(value)
    return module


@torch.no_grad()
def quantize_encoder(encoder: TextEncoder) -> TextEncoder:
    """Replace the linear layers of every block with ``Int8Linear`` (int8
    values + per-output-channel scales of the weights as held, in the
    compute dtype), in place; q, k and v become one ``qkv`` layer of their
    concatenated weights and biases. The counterpart of marqo_tpu
    ``quantize_encoder_params``. Returns ``encoder`` with quantize=True in
    its config."""
    if encoder.config.quantize:
        return encoder
    encoder.config = replace(encoder.config, quantize=True)
    for layer in encoder.layers:
        layer.config = encoder.config
        projections = [getattr(layer, name) for name in QKV]
        layer.qkv = Int8Linear.from_weight(
            torch.cat([p.weight for p in projections]),
            torch.cat([p.bias for p in projections]))
        for name in QKV:
            delattr(layer, name)
        for name in QUANTIZED_LINEARS[1:]:
            linear = getattr(layer, name)
            setattr(layer, name,
                    Int8Linear.from_weight(linear.weight, linear.bias))
    return encoder


def _float_config(config: TextEncoderConfig) -> TextEncoderConfig:
    """The builders make the float encoder first and quantize it last."""
    return replace(config, quantize=False)


def _quantized_if_asked(encoder: TextEncoder,
                        config: TextEncoderConfig) -> TextEncoder:
    return quantize_encoder(encoder) if config.quantize else encoder


def init_encoder(config: TextEncoderConfig, generator: torch.Generator,
                 dtype=torch.float32, device="cuda") -> TextEncoder:
    """Random-init encoder (normal(0, 0.02) weights, zero biases, unit
    LayerNorm scales), drawn from ``generator`` on ``device``; quantized
    after the cast to ``dtype`` when ``config.quantize``."""
    encoder = random_init(_empty_encoder(_float_config(config), dtype,
                                         device), generator)
    return _quantized_if_asked(encoder, config)


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
    return pool_segment_sums(
        *packed_segment_sums(encoder, input_ids, segment_ids, positions,
                             seq_index, num_sequences), encoder.config)


def packed_segment_sums(encoder: TextEncoder, input_ids: torch.Tensor,
                        segment_ids: torch.Tensor, positions: torch.Tensor,
                        seq_index: torch.Tensor, num_sequences: int):
    """The packed rows through the encoder, then each sequence's pooling
    sum and weight, indexed by ``seq_index`` over the whole packed batch:
    (num_sequences + 1, H) fp32 sums and (num_sequences + 1,) counts, the
    last row the pad tokens' trash row. Packing never splits a sequence
    across rows, so any split of the rows gives partial sums that add up
    to the whole batch's (the data-parallel path, parallel/serving.py)."""
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
    return sums, counts


def pool_segment_sums(sums: torch.Tensor, counts: torch.Tensor,
                      config: TextEncoderConfig) -> torch.Tensor:
    """``packed_segment_sums``' sums and counts → (num_sequences, H) fp32
    pooled (and, with ``config.normalize``, L2-normalized) embeddings."""
    pooled = sums[:-1] / counts[:-1, None].clamp_min(1e-9)
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
                                 device="cuda") -> TextEncoder:
    """An encoder holding an HF Bert/Roberta-style ``state_dict``.

    Handles both bare-model keys (``embeddings.…``) and prefixed
    (``bert.embeddings.…`` / ``roberta.…``). torch's (out, in) linear
    layout is this module's own, so weights copy as they are. Quantized
    after the cast to ``dtype`` when ``config.quantize``.
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
    float_config = _with_type_vocab(_float_config(config),
                                    values["embeddings.token_type.weight"])
    encoder = fill_parameters(_empty_encoder(float_config, dtype, device),
                              values)
    return _quantized_if_asked(encoder, config)


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
                    dtype=torch.float32, device="cuda") -> TextEncoder:
    """An encoder holding marqo_tpu's parameter pytree, given as numpy
    arrays ({"embeddings": {...}, "layers": {...}} with stacked layers).

    A quantized pytree (marqo_tpu ``quantize_encoder_params``: ``*_q``
    (L, in, out) int8 and ``*_s`` (L, 1, out) fp32 in place of the six
    linear weights) fills ``Int8Linear`` buffers as they are, transposed to
    (out, in) and (out,), q, k and v concatenated into ``qkv``; an
    unquantized one is quantized after the cast to ``dtype`` when
    ``config.quantize``."""
    emb, layers = params_numpy["embeddings"], params_numpy["layers"]
    quantized = "q_w_q" in layers
    values = {
        "embeddings.word.weight": emb["word"],
        "embeddings.position.weight": emb["position"],
        "embeddings.token_type.weight": emb["token_type"],
        "embeddings.ln.weight": emb["ln_scale"],
        "embeddings.ln.bias": emb["ln_bias"],
    }
    for i in range(config.num_layers):
        if quantized:
            keys = [_JAX_LAYER[name] for name in QKV]
            values[f"layers.{i}.qkv.weight_q"] = _kernel_k_columns(
                np.concatenate([np.asarray(layers[w + "_q"][i]).T
                                for w, _ in keys]))
            values[f"layers.{i}.qkv.weight_scale"] = np.concatenate(
                [np.asarray(layers[w + "_s"][i])[0] for w, _ in keys])
            values[f"layers.{i}.qkv.bias"] = np.concatenate(
                [np.asarray(layers[b][i]) for _, b in keys])
        for name, (w, b) in _JAX_LAYER.items():
            if quantized and name in QKV:
                continue
            values[f"layers.{i}.{name}.bias"] = layers[b][i]
            if quantized and name in QUANTIZED_LINEARS:
                values[f"layers.{i}.{name}.weight_q"] = _kernel_k_columns(
                    np.asarray(layers[w + "_q"][i]).T)
                values[f"layers.{i}.{name}.weight_scale"] = \
                    np.asarray(layers[w + "_s"][i])[0]
            else:
                # .T turns (in, out) into (out, in); 1-D LayerNorm scales
                # pass
                values[f"layers.{i}.{name}.weight"] = \
                    np.asarray(layers[w][i]).T
    build_config = _with_type_vocab(replace(config, quantize=quantized),
                                    values["embeddings.token_type.weight"])
    encoder = fill_parameters(_empty_encoder(build_config, dtype, device),
                              values)
    return _quantized_if_asked(encoder, config)


def _kernel_k_columns(w_q: np.ndarray) -> np.ndarray:
    """(out, in) int8 weights padded with zero columns to ``kernel_k(in)``,
    as ``Int8Linear`` holds them."""
    return np.pad(w_q, ((0, 0), (0, kernel_k(w_q.shape[1]) - w_q.shape[1])))


def _with_type_vocab(config: TextEncoderConfig, table) -> TextEncoderConfig:
    """Size the token-type table to the checkpoint's (1 when absent)."""
    return replace(config, type_vocab_size=int(table.shape[0]))
