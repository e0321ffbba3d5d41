"""CoCa (Contrastive Captioner) in PyTorch (port of marqo_tpu/models/coca.py).

The reference serves open_clip CoCa checkpoints (`coca_ViT-B-32`,
`coca_ViT-L-14`; model_registry.py open_clip section) through its OPEN_CLIP
wrapper (core/inference/embedding_models/open_clip_model.py:28) — for
embeddings it calls encode_text/encode_image only, but the checkpoint (and
the architecture) carries a third tower, the multimodal text decoder, used
for caption generation. All three towers are here, so the full open_clip
CoCa state dict converts:

  - Text tower: causal transformer with a learned CLS embedding appended
    at the END of the sequence (open_clip TextTransformer embed_cls=True):
    the CLS row attends every non-pad position, with open_clip's
    left-shifted non-pad pattern; pooling takes the CLS output, applies
    ln_final AFTER pooling, then projects. Plain torch (the mask is neither
    padding nor segments), as models/clip.py's causal text tower.
  - Vision tower: standard pre-LN ViT whose blocks run
    ops/fused_attention.py's no-mask mode (CUDA kernel B2 on a CUDA device,
    its plain twin on the CPU; ``attention_impl="plain"`` selects the
    twin), then an attentional pooler (n_queries learned queries
    cross-attend the patch grid, mapping vision width → embed dim),
    ln_post, contrastive embedding = query 0 @ proj; queries 1.. are the
    caption tokens fed to the decoder. The pooler is plain torch: its
    queries and keys differ in number (B2 takes one S for both), and the
    JAX package computes it in XLA.
  - Multimodal decoder: per layer, causal self-attention over text tokens
    followed by cross-attention onto the pooled image tokens; ln_final and
    a projection to vocab logits (open_clip MultimodalTransformer). Plain
    torch, as in the JAX package.

The module's dtype is the compute dtype; LayerNorm statistics, the pooled
projections and the logits run in fp32. The plain attention computes the
scores in the compute dtype, then scales and softmaxes in fp32, as the JAX
package's ``_attention``; kernel B2 computes the vision blocks' scores in
fp32 (ROADMAP §C). The converter returns the JAX package's layout as numpy
float32, and ``params_from_jax`` builds the module from that layout.
"""

import math
from dataclasses import dataclass, replace
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.core.exceptions import ModelLoadError, VectoriseError
from marqo_tpu_torch.inference.batching import tower_encode
from marqo_tpu_torch.inference.graphs import EncoderGraphs
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.models.clip import (_VISION_ATTENTION, PreNormBlock,
                                         _f32, _numpy_state_dict,
                                         _pixel_stats, block_values,
                                         convert_open_clip_resblocks,
                                         load_open_clip_state, random_seed)
from marqo_tpu_torch.ops.common import ACTIVATIONS, layer_norm
from marqo_tpu_torch.parallel.serving import put_params, replicas


@dataclass(frozen=True)
class CoCaTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    context_length: int = 76      # CLS appended → 77 positions
    embed_dim: int = 512          # contrastive latent
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    pad_id: int = 0


@dataclass(frozen=True)
class CoCaVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    embed_dim: int = 512          # attn-pool output dim == contrastive dim
    n_queries: int = 256          # attentional pooler queries
    pooler_heads: int = 8
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    # "kernel": ops/fused_attention.py (CUDA kernel B2 on a CUDA device,
    # plain twin on the CPU); "plain": always the plain twin
    attention_impl: str = "kernel"


@dataclass(frozen=True)
class CoCaDecoderConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    context_length: int = 76
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5


# --- building blocks ---------------------------------------------------------

def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, Sq, D) queries over (B, N, Sk, D) keys, as the JAX package's
    ``_attention``: scores in the input dtype, then fp32 over sqrt(D), an
    additive (B, Sq, Sk) ``bias`` and the softmax, probabilities back in the
    input dtype for P.V."""
    D = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(D)
    if bias is not None:
        scores = scores + bias[:, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _causal_bias(T: int, device) -> torch.Tensor:
    """(T, T): 0 on and below the diagonal, -inf above."""
    return torch.full((T, T), float("-inf"), device=device).triu(1)


class CrossBlock(nn.Module):
    """Pre-LN residual cross-attention block (open_clip
    ResidualAttentionBlock(is_cross_attention=True): ln_1 on queries,
    ln_1_kv on the image tokens)."""

    def __init__(self, hidden: int, intermediate: int, num_heads: int,
                 act: str, eps: float):
        super().__init__()
        self.num_heads, self.act, self.eps = num_heads, act, eps
        self.ln1 = nn.LayerNorm(hidden)
        self.ln1kv = nn.LayerNorm(hidden)
        self.q = nn.Linear(hidden, hidden)
        self.k = nn.Linear(hidden, hidden)
        self.v = nn.Linear(hidden, hidden)
        self.o = nn.Linear(hidden, hidden)
        self.ln2 = nn.LayerNorm(hidden)
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        B, S, H = x.shape
        N = self.num_heads

        def heads(t):
            return t.view(B, -1, N, H // N).transpose(1, 2)

        hq = layer_norm(x, self.ln1.weight, self.ln1.bias, self.eps)
        hk = layer_norm(kv, self.ln1kv.weight, self.ln1kv.bias, self.eps)
        ctx = plain_attention(heads(self.q(hq)), heads(self.k(hk)),
                              heads(self.v(hk)))
        x = x + self.o(ctx.transpose(1, 2).reshape(B, S, H))
        h = layer_norm(x, self.ln2.weight, self.ln2.bias, self.eps)
        return x + self.fc2(ACTIVATIONS[self.act](self.fc1(h)))


def _self_blocks(config) -> nn.ModuleList:
    return nn.ModuleList(
        PreNormBlock(config.hidden_size, config.intermediate_size,
                     config.num_heads, config.hidden_act,
                     config.layer_norm_eps)
        for _ in range(config.num_layers))


# --- towers ------------------------------------------------------------------

class CoCaTextTower(nn.Module):
    def __init__(self, config: CoCaTextConfig):
        super().__init__()
        H = config.hidden_size
        self.config = config
        self.token_embedding = nn.Parameter(torch.empty(config.vocab_size, H))
        self.position_embedding = nn.Parameter(
            torch.empty(config.context_length + 1, H))
        self.cls_emb = nn.Parameter(torch.empty(H))
        self.layers = _self_blocks(config)
        self.final_ln = nn.LayerNorm(H)
        # (in, out), applied in fp32
        self.text_projection = nn.Parameter(torch.empty(H, config.embed_dim))

    def forward(self, input_ids: torch.Tensor, return_tokens: bool = False):
        """(B, S ≤ context_length) int → (B, embed_dim) fp32
        (unnormalized); with ``return_tokens`` also the (B, S, H) per-token
        outputs (the decoder's input)."""
        config = self.config
        input_ids = input_ids.long()
        B, S = input_ids.shape
        x = self.token_embedding[input_ids]
        cls = self.cls_emb.expand(B, 1, config.hidden_size)
        x = torch.cat([x, cls], dim=1) + self.position_embedding[:S + 1][None]
        # additive mask: causal everywhere; the CLS (last) row masks
        # padding. open_clip build_cls_mask LEFT-pads the non-pad pattern by
        # one (key 0 always attendable, key j gated by non_pad[j-1]) —
        # replicated exactly, since the pretrained weights saw this mask
        T = S + 1
        bias = _causal_bias(T, x.device).expand(B, T, T).clone()
        non_pad = input_ids != config.pad_id
        bias[:, -1, 0] = 0.0
        bias[:, -1, 1:] = torch.where(non_pad, 0.0, float("-inf"))

        def attend(q, k, v):
            return plain_attention(q, k, v, bias)

        for layer in self.layers:
            x = layer(x, attend)
        pooled = layer_norm(x[:, -1].float(), self.final_ln.weight,
                            self.final_ln.bias, config.layer_norm_eps)
        latent = pooled @ self.text_projection.float()
        if return_tokens:
            return latent, x[:, :-1]
        return latent


class AttentionalPooler(nn.Module):
    """open_clip AttentionalPooler: learned queries cross-attend the patch
    sequence; kdim (vision width) ≠ d_model (embed dim). Plain torch."""

    def __init__(self, config: CoCaVisionConfig):
        super().__init__()
        Hv, D = config.hidden_size, config.embed_dim
        self.config = config
        self.query = nn.Parameter(torch.empty(config.n_queries, D))
        self.ln_q = nn.LayerNorm(D)
        self.ln_k = nn.LayerNorm(Hv)
        self.q = nn.Linear(D, D)
        self.k = nn.Linear(Hv, D)
        self.v = nn.Linear(Hv, D)
        self.o = nn.Linear(D, D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        config = self.config
        B, N = x.shape[0], config.pooler_heads
        D = config.embed_dim
        eps = config.layer_norm_eps
        xk = layer_norm(x, self.ln_k.weight, self.ln_k.bias, eps)
        q0 = layer_norm(self.query, self.ln_q.weight, self.ln_q.bias, eps)
        q = q0.expand(B, *q0.shape).to(x.dtype)

        def heads(t):
            return t.view(B, -1, N, D // N).transpose(1, 2)

        ctx = plain_attention(heads(self.q(q)), heads(self.k(xk)),
                              heads(self.v(xk)))
        return self.o(ctx.transpose(1, 2).reshape(B, -1, D))


class CoCaVisionTower(nn.Module):
    def __init__(self, config: CoCaVisionConfig):
        super().__init__()
        H, p, D = config.hidden_size, config.patch_size, config.embed_dim
        n_patches = (config.image_size // p) ** 2
        self.config = config
        # (p*p*3, H) over patches laid out (p, p, 3)
        self.patch_embedding = nn.Parameter(torch.empty(p * p * 3, H))
        self.class_embedding = nn.Parameter(torch.empty(H))
        self.position_embedding = nn.Parameter(torch.empty(n_patches + 1, H))
        self.pre_ln = nn.LayerNorm(H)
        self.layers = _self_blocks(config)
        self.attn_pool = AttentionalPooler(config)
        self.post_ln = nn.LayerNorm(D)
        # (in, out), applied in fp32
        self.proj = nn.Parameter(torch.empty(D, D))

    def forward(self, pixels_u8: torch.Tensor, return_tokens: bool = False):
        """(B, size, size, 3) uint8 → (B, embed_dim) fp32 (unnormalized);
        with ``return_tokens`` also the (B, n_queries - 1, embed_dim)
        caption tokens (post ln_post, fp32)."""
        config = self.config
        B = pixels_u8.shape[0]
        n, p = config.image_size // config.patch_size, config.patch_size
        mean, std = _pixel_stats(pixels_u8.device)
        x = (pixels_u8.float() / 255.0 - mean) / std
        x = x.reshape(B, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(
            B, n * n, p * p * 3)
        weight = self.patch_embedding
        x = torch.matmul(x.to(weight.dtype), weight)
        cls = self.class_embedding.expand(B, 1, config.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        x = layer_norm(x, self.pre_ln.weight, self.pre_ln.bias,
                       config.layer_norm_eps)
        attend = _VISION_ATTENTION[config.attention_impl]
        for layer in self.layers:
            x = layer(x, attend)
        pooled = layer_norm(self.attn_pool(x).float(), self.post_ln.weight,
                            self.post_ln.bias, config.layer_norm_eps)
        latent = pooled[:, 0] @ self.proj.float()
        if return_tokens:
            return latent, pooled[:, 1:]
        return latent


class CoCaDecoder(nn.Module):
    def __init__(self, config: CoCaDecoderConfig):
        super().__init__()
        H = config.hidden_size
        self.config = config
        self.layers = _self_blocks(config)
        self.cross_layers = nn.ModuleList(
            CrossBlock(H, config.intermediate_size, config.num_heads,
                       config.hidden_act, config.layer_norm_eps)
            for _ in range(config.num_layers))
        self.final_ln = nn.LayerNorm(H)
        # (in, out), applied in fp32
        self.vocab_projection = nn.Parameter(
            torch.empty(H, config.vocab_size))

    def forward(self, token_embs: torch.Tensor,
                image_tokens: torch.Tensor) -> torch.Tensor:
        """token_embs (B, S, H): the text tower's per-token outputs
        (pre-ln_final); image_tokens (B, n_queries - 1, H): the pooled
        caption queries (post ln_post) → (B, S, vocab_size) fp32 logits."""
        dtype = self.vocab_projection.dtype
        x, kv = token_embs.to(dtype), image_tokens.to(dtype)
        B, S, _ = x.shape
        bias = _causal_bias(S, x.device).expand(B, S, S)

        def attend(q, k, v):
            return plain_attention(q, k, v, bias)

        for layer, cross in zip(self.layers, self.cross_layers):
            x = cross(layer(x, attend), kv)
        x = layer_norm(x.float(), self.final_ln.weight, self.final_ln.bias,
                       self.config.layer_norm_eps)
        return x @ self.vocab_projection.float()


class CoCaEncoder(nn.Module):
    """The three towers; the module's dtype is the compute dtype."""

    def __init__(self, text_config: CoCaTextConfig,
                 vision_config: CoCaVisionConfig,
                 decoder_config: CoCaDecoderConfig):
        super().__init__()
        self.text = CoCaTextTower(text_config)
        self.vision = CoCaVisionTower(vision_config)
        self.decoder = CoCaDecoder(decoder_config)


def encode_coca_text(model: CoCaEncoder, input_ids: torch.Tensor,
                     return_tokens: bool = False):
    """(B, S ≤ context_length) int → (B, embed_dim) fp32 (unnormalized)."""
    return model.text(input_ids, return_tokens)


def encode_coca_image(model: CoCaEncoder, pixels_u8: torch.Tensor,
                      return_tokens: bool = False):
    """(B, size, size, 3) uint8 → (B, embed_dim) fp32 (unnormalized)."""
    return model.vision(pixels_u8, return_tokens)


def coca_decode_logits(model: CoCaEncoder, token_embs: torch.Tensor,
                       image_tokens: torch.Tensor) -> torch.Tensor:
    """Caption logits (open_clip MultimodalTransformer.forward) →
    (B, S, vocab_size) fp32."""
    return model.decoder(token_embs, image_tokens)


# --- init + conversion -------------------------------------------------------

def init_coca_params(text_config: CoCaTextConfig,
                     vision_config: CoCaVisionConfig,
                     decoder_config: CoCaDecoderConfig,
                     generator: torch.Generator, dtype=torch.float32,
                     device="cuda") -> CoCaEncoder:
    """Random-init model (normal(0, 0.02) weights, embeddings and queries,
    zero biases, unit LayerNorm scales), drawn from ``generator`` on
    ``device``."""
    return random_init(empty_module(
        lambda: CoCaEncoder(text_config, vision_config, decoder_config),
        dtype, device), generator)


def params_from_open_clip_coca(state_dict, text_config: CoCaTextConfig,
                               vision_config: CoCaVisionConfig,
                               decoder_config: CoCaDecoderConfig) -> dict:
    """Convert an open_clip CoCa state dict (coca_model.py naming: text.*,
    visual.* incl. visual.attn_pool.*, text_decoder.*) into the JAX
    package's layout (numpy float32)."""
    sd = _numpy_state_dict(state_dict)

    def cross_blocks(prefix, L):
        out = convert_open_clip_resblocks(sd, prefix, L)
        out["ln1kv_scale"] = _f32(np.stack(
            [sd[f"{prefix}.{i}.ln_1_kv.weight"] for i in range(L)]))
        out["ln1kv_bias"] = _f32(np.stack(
            [sd[f"{prefix}.{i}.ln_1_kv.bias"] for i in range(L)]))
        return out

    conv = sd["visual.conv1.weight"]  # (Hv, 3, p, p)
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0])
    # AttentionalPooler with kdim≠embed_dim stores separate q/k/v weights
    pool = "visual.attn_pool"
    qb, kb, vb = np.split(sd[f"{pool}.attn.in_proj_bias"], 3, axis=0)
    return {
        "text": {
            "token_embedding": _f32(sd["text.token_embedding.weight"]),
            "position_embedding": _f32(sd["text.positional_embedding"]),
            "cls_emb": _f32(sd["text.cls_emb"].reshape(-1)),
            "layers": convert_open_clip_resblocks(
                sd, "text.transformer.resblocks", text_config.num_layers),
            "final_ln_scale": _f32(sd["text.ln_final.weight"]),
            "final_ln_bias": _f32(sd["text.ln_final.bias"]),
            "text_projection": _f32(sd["text.text_projection"]),
        },
        "vision": {
            "patch_embedding": _f32(patch_w),
            "class_embedding": _f32(sd["visual.class_embedding"]),
            "position_embedding": _f32(sd["visual.positional_embedding"]),
            "pre_ln_scale": _f32(sd["visual.ln_pre.weight"]),
            "pre_ln_bias": _f32(sd["visual.ln_pre.bias"]),
            "layers": convert_open_clip_resblocks(
                sd, "visual.transformer.resblocks", vision_config.num_layers),
            "attn_pool": {
                "query": _f32(sd[f"{pool}.query"]),
                "ln_q_scale": _f32(sd[f"{pool}.ln_q.weight"]),
                "ln_q_bias": _f32(sd[f"{pool}.ln_q.bias"]),
                "ln_k_scale": _f32(sd[f"{pool}.ln_k.weight"]),
                "ln_k_bias": _f32(sd[f"{pool}.ln_k.bias"]),
                "q_w": _f32(sd[f"{pool}.attn.q_proj_weight"].T),
                "q_b": _f32(qb),
                "k_w": _f32(sd[f"{pool}.attn.k_proj_weight"].T),
                "k_b": _f32(kb),
                "v_w": _f32(sd[f"{pool}.attn.v_proj_weight"].T),
                "v_b": _f32(vb),
                "o_w": _f32(sd[f"{pool}.attn.out_proj.weight"].T),
                "o_b": _f32(sd[f"{pool}.attn.out_proj.bias"]),
            },
            "post_ln_scale": _f32(sd["visual.ln_post.weight"]),
            "post_ln_bias": _f32(sd["visual.ln_post.bias"]),
            "proj": _f32(sd["visual.proj"]),
        },
        "decoder": {
            "self_layers": convert_open_clip_resblocks(
                sd, "text_decoder.resblocks", decoder_config.num_layers),
            "cross_layers": cross_blocks("text_decoder.cross_attn",
                                         decoder_config.num_layers),
            "final_ln_scale": _f32(sd["text_decoder.ln_final.weight"]),
            "final_ln_bias": _f32(sd["text_decoder.ln_final.bias"]),
            "vocab_projection": _f32(sd["text_decoder.text_projection"]),
        },
    }


def _values(params: dict, text_config: CoCaTextConfig,
            vision_config: CoCaVisionConfig,
            decoder_config: CoCaDecoderConfig) -> dict:
    """Every parameter of a ``CoCaEncoder``, by name, from the JAX
    package's layout (numpy arrays; weights (in, out) there, so the
    nn.Linear ones transpose)."""
    text, vision, dec = params["text"], params["vision"], params["decoder"]
    ap = vision["attn_pool"]
    values = {
        "text.token_embedding": text["token_embedding"],
        "text.position_embedding": text["position_embedding"],
        "text.cls_emb": text["cls_emb"],
        "text.final_ln.weight": text["final_ln_scale"],
        "text.final_ln.bias": text["final_ln_bias"],
        "text.text_projection": text["text_projection"],
        **block_values("text.", text, text_config.num_layers),
        "vision.patch_embedding": vision["patch_embedding"],
        "vision.class_embedding": vision["class_embedding"],
        "vision.position_embedding": vision["position_embedding"],
        "vision.pre_ln.weight": vision["pre_ln_scale"],
        "vision.pre_ln.bias": vision["pre_ln_bias"],
        **block_values("vision.", vision, vision_config.num_layers),
        "vision.attn_pool.query": ap["query"],
        "vision.attn_pool.ln_q.weight": ap["ln_q_scale"],
        "vision.attn_pool.ln_q.bias": ap["ln_q_bias"],
        "vision.attn_pool.ln_k.weight": ap["ln_k_scale"],
        "vision.attn_pool.ln_k.bias": ap["ln_k_bias"],
        "vision.post_ln.weight": vision["post_ln_scale"],
        "vision.post_ln.bias": vision["post_ln_bias"],
        "vision.proj": vision["proj"],
        **block_values("decoder.", {"layers": dec["self_layers"]},
                       decoder_config.num_layers),
        **block_values("decoder.cross_", {"layers": dec["cross_layers"]},
                       decoder_config.num_layers),
        "decoder.final_ln.weight": dec["final_ln_scale"],
        "decoder.final_ln.bias": dec["final_ln_bias"],
        "decoder.vocab_projection": dec["vocab_projection"],
    }
    for name in ("q", "k", "v", "o"):
        values[f"vision.attn_pool.{name}.weight"] = np.asarray(
            ap[f"{name}_w"]).T
        values[f"vision.attn_pool.{name}.bias"] = ap[f"{name}_b"]
    for i in range(decoder_config.num_layers):
        values[f"decoder.cross_layers.{i}.ln1kv.weight"] = \
            dec["cross_layers"]["ln1kv_scale"][i]
        values[f"decoder.cross_layers.{i}.ln1kv.bias"] = \
            dec["cross_layers"]["ln1kv_bias"][i]
    return values


def params_from_jax(params_numpy: dict, text_config: CoCaTextConfig,
                    vision_config: CoCaVisionConfig,
                    decoder_config: CoCaDecoderConfig, dtype=torch.float32,
                    device="cuda") -> CoCaEncoder:
    """A model holding parameters in the JAX package's layout, given as
    numpy arrays ({"text", "vision", "decoder"} with stacked layers): the
    JAX package's own params, or the converter's output above."""
    model = empty_module(
        lambda: CoCaEncoder(text_config, vision_config, decoder_config),
        dtype, device)
    return fill_parameters(model, _values(params_numpy, text_config,
                                          vision_config, decoder_config))


# --- model wrapper -----------------------------------------------------------

def coca_vit_b32_configs(embed_dim: int = 512):
    """open_clip coca_ViT-B-32 model config (open_clip
    model_configs/coca_ViT-B-32.json)."""
    text = CoCaTextConfig(embed_dim=embed_dim)
    vision = CoCaVisionConfig(embed_dim=embed_dim)
    dec = CoCaDecoderConfig()
    return text, vision, dec


def coca_vit_l14_configs(embed_dim: int = 768):
    """open_clip coca_ViT-L-14 model config."""
    text = CoCaTextConfig(hidden_size=768, num_heads=12,
                          intermediate_size=3072, embed_dim=embed_dim)
    vision = CoCaVisionConfig(patch_size=14, hidden_size=1024,
                              num_layers=24, num_heads=16,
                              intermediate_size=4096, embed_dim=embed_dim)
    dec = CoCaDecoderConfig(hidden_size=768, num_heads=12,
                            intermediate_size=3072)
    return text, vision, dec


class TorchCoCaModel:
    """CoCa wrapper (reference JaxCoCaModel): text + image embedding via
    the contrastive latents (what the reference's OPEN_CLIP.encode does for
    coca_* names), plus the caption decoder: teacher-forced logits and
    greedy caption ids. One device per model."""

    compute_dtype = torch.bfloat16

    def __init__(self, model_name: str, properties: dict, device: Device,
                 model_auth=None):
        self.model_name = model_name
        self.properties = dict(properties or {})
        self.device = device
        self.model_auth = model_auth
        self.loaded = False
        self.encoder: Optional[CoCaEncoder] = None
        self.text_config: Optional[CoCaTextConfig] = None
        self.vision_config: Optional[CoCaVisionConfig] = None
        self.decoder_config: Optional[CoCaDecoderConfig] = None
        self.tokenizer = None
        self._device = torch.device(
            "cuda" if device == Device.CUDA else "cpu")
        self._param_bytes = 0
        self.graphs = EncoderGraphs(self._device)

    @property
    def dimensions(self) -> int:
        return int(self.properties.get("dimensions", 0)) or \
            (self.text_config.embed_dim if self.text_config else 0)

    def _configs_for_name(self):
        name = self.properties.get("name", self.model_name)
        dims = int(self.properties.get("dimensions", 512))
        if "ViT-L-14" in name:
            return coca_vit_l14_configs(dims)
        return coca_vit_b32_configs(dims)

    def load(self) -> None:
        if self.properties.get("localpath"):
            self._load_from_checkpoint(self.properties["localpath"])
        elif self.properties.get("random_init"):
            self._load_random_init()
        else:
            raise ModelLoadError(
                f"CoCa model `{self.model_name}` requires an open_clip "
                "checkpoint: provide model_properties.localpath (a .pt/.bin "
                "state dict or directory) or a model_location.")
        self.encoder = put_params(self, self.encoder)
        self.loaded = True
        self._param_bytes = sum(t.numel() * t.element_size()
                                for t in self.encoder.parameters())

    def _load_from_checkpoint(self, path: str) -> None:
        self.text_config, self.vision_config, self.decoder_config = \
            self._configs_for_name()
        params = params_from_open_clip_coca(
            load_open_clip_state(path), self.text_config, self.vision_config,
            self.decoder_config)
        self.encoder = params_from_jax(params, self.text_config,
                                       self.vision_config,
                                       self.decoder_config,
                                       dtype=self.compute_dtype,
                                       device=self._device)
        self._init_tokenizer(checkpoint=path)

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        dims = int(self.properties.get("dimensions", 64))
        # open_clip CoCa ties embed_dim == text width == decoder width (the
        # attn-pooled image tokens feed the decoder cross-attention raw)
        self.text_config = CoCaTextConfig(
            vocab_size=int(arch.get("vocab_size", 1024)),
            hidden_size=int(arch.get("text_hidden_size", dims)),
            num_layers=int(arch.get("text_layers", 2)),
            num_heads=int(arch.get("text_heads", 2)),
            intermediate_size=int(arch.get("text_intermediate", 128)),
            context_length=int(arch.get("context_length", 76)),
            embed_dim=dims)
        self.vision_config = CoCaVisionConfig(
            image_size=int(self.properties.get("image_size", 224)),
            patch_size=int(arch.get("patch_size", 32)),
            hidden_size=int(arch.get("vision_hidden_size", 64)),
            num_layers=int(arch.get("vision_layers", 2)),
            num_heads=int(arch.get("vision_heads", 2)),
            intermediate_size=int(arch.get("vision_intermediate", 128)),
            embed_dim=dims,
            n_queries=int(arch.get("n_queries", 16)),
            pooler_heads=int(arch.get("pooler_heads", 2)))
        self.decoder_config = CoCaDecoderConfig(
            vocab_size=self.text_config.vocab_size,
            hidden_size=self.text_config.hidden_size,
            num_layers=int(arch.get("decoder_layers", 2)),
            num_heads=self.text_config.num_heads,
            intermediate_size=self.text_config.intermediate_size,
            context_length=self.text_config.context_length)
        generator = torch.Generator(device=self._device).manual_seed(
            random_seed(self.model_name))
        self.encoder = init_coca_params(
            self.text_config, self.vision_config, self.decoder_config,
            generator, dtype=self.compute_dtype, device=self._device)
        self._init_tokenizer()

    def _init_tokenizer(self, checkpoint: str = None) -> None:
        from marqo_tpu_torch.models.tokenizer import resolve_model_tokenizer
        self.tokenizer = resolve_model_tokenizer(
            self.properties, max_length=self.text_config.context_length,
            checkpoint_path=checkpoint,
            allow_test=bool(self.properties.get("random_init")))

    def set_attention_impl(self, impl: str) -> None:
        """"kernel" (B2 on a CUDA device) or "plain" (its twin) for the
        vision tower's blocks (the text tower, the pooler and the decoder
        are plain torch)."""
        for encoder in replicas(self):
            encoder.vision.config = replace(encoder.vision.config,
                                            attention_impl=impl)

    # -- encoding ------------------------------------------------------------

    def encode(self, contents: List[Any], normalize: bool = True,
               modality: Modality = Modality.TEXT) -> np.ndarray:
        if modality == Modality.TEXT:
            out = self._encode_text([str(c) for c in contents])
        elif modality == Modality.IMAGE:
            out = self._encode_images(contents)
        else:
            raise VectoriseError(
                f"Model `{self.model_name}` does not support modality "
                f"{modality.value}")
        if normalize:
            out = out / np.maximum(
                np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
        return out.astype(np.float32)

    def _run(self, array: np.ndarray, tower: str) -> np.ndarray:
        """The ``tower`` ("text" or "vision") of this model's encoder over
        ``array`` in batch buckets: on CUDA one graph per bucket, under a
        serving mesh split across its data-parallel groups. The caption
        decoder below stays eager."""
        return tower_encode(self, array, tower)

    def _tokenize(self, texts: List[str]) -> np.ndarray:
        batch = self.tokenizer.encode_batch(
            texts, pad_to=self.text_config.context_length)
        return (batch["input_ids"] % self.text_config.vocab_size).astype(
            np.int32)

    def _encode_text(self, texts: List[str]) -> np.ndarray:
        return self._run(self._tokenize(texts), "text")

    def _preprocess_host(self, content) -> np.ndarray:
        """CLIP's preprocessing (shorter-side bicubic resize, centre crop),
        as the reference wrapper's."""
        from marqo_tpu_torch.models.clip import TorchCLIPModel
        return TorchCLIPModel._preprocess_host(self, content)

    def _pixels(self, images: List[Any]) -> torch.Tensor:
        return torch.from_numpy(np.stack(
            [self._preprocess_host(c) for c in images])).to(self._device)

    def _encode_images(self, contents: List[Any]) -> np.ndarray:
        pixels = np.stack([self._preprocess_host(c) for c in contents])
        return self._run(pixels, "vision")

    def caption_logits(self, texts: List[str],
                       images: List[Any]) -> np.ndarray:
        """Teacher-forced caption logits for (text, image) pairs — the
        decoder forward that makes the third tower loadable/testable."""
        ids = torch.from_numpy(self._tokenize(texts)).to(self._device)
        with torch.inference_mode():
            _, token_embs = encode_coca_text(self.encoder, ids,
                                             return_tokens=True)
            _, image_tokens = encode_coca_image(
                self.encoder, self._pixels(images), return_tokens=True)
            logits = coca_decode_logits(self.encoder, token_embs,
                                        image_tokens)
        return logits.cpu().numpy()

    def generate_caption_ids(self, images: List[Any], max_len: int = 16,
                             sot_id: int = 1,
                             eos_id: Optional[int] = None) -> List[List[int]]:
        """Greedy caption decoding (open_clip CoCa.generate with
        generation_type='top_k', k=1): start from <sot>, feed the growing
        prefix through the text tower + multimodal decoder, take the
        argmax next token, stop at <eos> or max_len. A host loop, as the
        JAX package's, with its stopping rules."""
        with torch.inference_mode():
            _, image_tokens = encode_coca_image(
                self.encoder, self._pixels(images), return_tokens=True)
            B = len(images)
            seqs = [[sot_id] for _ in range(B)]
            finished = [False] * B
            for _ in range(max_len - 1):
                ids = np.asarray(seqs, dtype=np.int32)
                _, token_embs = encode_coca_text(
                    self.encoder, torch.from_numpy(ids).to(self._device),
                    return_tokens=True)
                logits = coca_decode_logits(self.encoder, token_embs,
                                            image_tokens)
                next_ids = logits[:, -1, :].argmax(dim=-1).cpu().numpy()
                for b in range(B):
                    tok = int(next_ids[b])
                    if finished[b]:
                        tok = eos_id if eos_id is not None else tok
                    seqs[b].append(tok)
                    if eos_id is not None and tok == eos_id:
                        finished[b] = True
                if eos_id is not None and all(finished):
                    break
                if ids.shape[1] + 1 >= self.text_config.context_length:
                    break
        return seqs

    def memory_bytes(self) -> int:
        return self._param_bytes
