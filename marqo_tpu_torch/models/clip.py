"""CLIP-family models (text + vision towers) in PyTorch (port of
marqo_tpu/models/clip.py).

Covers openai CLIP and open_clip ViT checkpoints (reference
clip_utils.py:295, open_clip_model.py:28) as one ``nn.Module``:

  - Vision tower: ViT with the patch embedding as one matmul over unfolded
    (p, p, 3) patches (stride == patch size, so a reshape and no conv),
    class token, pre-LN blocks, post-LN on the class token, projection.
    Attention is ops/fused_attention.py's no-mask mode (CUDA kernel B2 on a
    CUDA device, its plain twin on the CPU) over the real tokens: unlike the
    JAX package, the token axis is not padded to a multiple of 8 (that
    padding served the TPU's tiling; the kernel masks its own ragged edge).
  - Text tower: causal pre-LN transformer in plain torch (a -1e9
    upper-triangle bias, as the reference computes it in XLA), final LN and
    projection at the first EOS token.
  - Preprocessing: the host decodes, EXIF-orients, resizes and crops with
    PIL in uint8; normalize and the patch embedding run on the device, so
    pixels cross to the card once as uint8.

The module's dtype is the compute dtype (bf16 when serving); LayerNorm
statistics and the final projection run in fp32. Checkpoint converters
(HF CLIPModel, openai/open_clip naming) return the JAX package's parameter
layout as numpy arrays: (in, out) weights, stacked (L, ...) layers and a
(p*p*3, H) patch embedding. ``params_from_jax`` builds the module from that
layout, so both packages load one checkpoint through the same arrays.
"""

import functools
import hashlib
import math
from dataclasses import dataclass
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
from marqo_tpu_torch.ops import fused_attention
from marqo_tpu_torch.ops.common import ACTIVATIONS, layer_norm
from marqo_tpu_torch.ops.image_ops import CLIP_MEAN, CLIP_STD, host_decode
from marqo_tpu_torch.parallel.serving import put_params


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    max_positions: int = 77
    projection_dim: int = 512
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    # "kernel": ops/fused_attention.py (CUDA kernel B2 on a CUDA device,
    # plain twin on the CPU); "plain": always the plain twin
    attention_impl: str = "kernel"


# --- attention ---------------------------------------------------------------

def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """The text tower's attention, as the reference computes it: scores in
    the compute dtype, a -1e9 upper-triangle bias and the softmax in fp32,
    probs back in the compute dtype before P.V."""
    S, D = q.shape[-2], q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    bias = torch.full((S, S), -1e9, device=q.device).triu(1)
    probs = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


_VISION_ATTENTION = {
    "kernel": fused_attention.fused_attention,
    "plain": fused_attention.fused_attention_reference,
}


# --- modules -----------------------------------------------------------------

class PreNormBlock(nn.Module):
    """One pre-LN transformer block (marqo_tpu clip.py `_prenorm_block`)."""

    def __init__(self, hidden: int, intermediate: int, num_heads: int,
                 act: str, eps: float):
        super().__init__()
        self.num_heads, self.act, self.eps = num_heads, act, eps
        self.ln1 = nn.LayerNorm(hidden)
        self.q = nn.Linear(hidden, hidden)
        self.k = nn.Linear(hidden, hidden)
        self.v = nn.Linear(hidden, hidden)
        self.o = nn.Linear(hidden, hidden)
        self.ln2 = nn.LayerNorm(hidden)
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x: torch.Tensor, attend) -> torch.Tensor:
        """x: (B, S, H); ``attend(q, k, v)`` on (B, N, S, D) heads."""
        B, S, H = x.shape
        N = self.num_heads
        h = layer_norm(x, self.ln1.weight, self.ln1.bias, self.eps)

        def heads(t):
            # a view: the kernels read the projection's layout by strides
            return t.view(B, S, N, H // N).transpose(1, 2)

        ctx = attend(heads(self.q(h)), heads(self.k(h)), heads(self.v(h)))
        x = x + self.o(ctx.transpose(1, 2).reshape(B, S, H))
        h = layer_norm(x, self.ln2.weight, self.ln2.bias, self.eps)
        return x + self.fc2(ACTIVATIONS[self.act](self.fc1(h)))


def _blocks(config) -> nn.ModuleList:
    return nn.ModuleList(
        PreNormBlock(config.hidden_size, config.intermediate_size,
                     config.num_heads, config.hidden_act,
                     config.layer_norm_eps)
        for _ in range(config.num_layers))


class CLIPTextTower(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        H = config.hidden_size
        self.config = config
        self.token_embedding = nn.Parameter(torch.empty(config.vocab_size, H))
        self.position_embedding = nn.Parameter(
            torch.empty(config.max_positions, H))
        self.layers = _blocks(config)
        self.final_ln = nn.LayerNorm(H)
        # (in, out), applied in fp32
        self.projection = nn.Parameter(torch.empty(H, config.projection_dim))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        config = self.config
        input_ids = input_ids.long()
        B, S = input_ids.shape
        x = self.token_embedding[input_ids] + self.position_embedding[:S][None]
        for layer in self.layers:
            x = layer(x, causal_attention)
        # EOS pooling at the first eos_token_id (HF CLIP; openai's argmax of
        # the ids is the same for standard tokenizers, where EOS is the max)
        eos_pos = (input_ids == config.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(B, device=x.device), eos_pos]
        pooled = layer_norm(pooled, self.final_ln.weight, self.final_ln.bias,
                            config.layer_norm_eps).float()
        return pooled @ self.projection.float()


@functools.lru_cache(maxsize=None)
def _pixel_stats(device: torch.device):
    """CLIP_MEAN and CLIP_STD as fp32 tensors on ``device``, made once per
    device rather than copied from the host on every batch."""
    with torch.inference_mode(False):
        return (torch.tensor(CLIP_MEAN, device=device),
                torch.tensor(CLIP_STD, device=device))


class CLIPVisionTower(nn.Module):
    def __init__(self, config: CLIPVisionConfig, pre_ln: bool = True):
        super().__init__()
        H, p = config.hidden_size, config.patch_size
        n_patches = (config.image_size // p) ** 2
        self.config = config
        # (p*p*3, H) over patches laid out (p, p, 3)
        self.patch_embedding = nn.Parameter(torch.empty(p * p * 3, H))
        self.class_embedding = nn.Parameter(torch.empty(H))
        self.position_embedding = nn.Parameter(torch.empty(n_patches + 1, H))
        self.pre_ln = nn.LayerNorm(H) if pre_ln else None
        self.layers = _blocks(config)
        self.post_ln = nn.LayerNorm(H)
        self.projection = nn.Parameter(torch.empty(H, config.projection_dim))

    def forward(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        config = self.config
        x = self.tokens(pixels_u8)
        pooled = layer_norm(x[:, 0], self.post_ln.weight, self.post_ln.bias,
                            config.layer_norm_eps).float()
        return pooled @ self.projection.float()

    def tokens(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """(B, size, size, 3) uint8 → (B, S, H): every token after the
        blocks, before the post-LN (OWL-ViT reads them all)."""
        config = self.config
        B = pixels_u8.shape[0]
        size, patch = config.image_size, config.patch_size
        n_side = size // patch
        mean, std = _pixel_stats(pixels_u8.device)
        x = (pixels_u8.float() / 255.0 - mean) / std
        # unfold into patches: (B, n, p*p*3); stride == kernel, so a reshape
        x = x.reshape(B, n_side, patch, n_side, patch, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, n_side * n_side,
                                                patch * patch * 3)
        weight = self.patch_embedding
        x = torch.matmul(x.to(weight.dtype), weight)
        cls = self.class_embedding.expand(B, 1, config.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        if self.pre_ln is not None:
            x = layer_norm(x, self.pre_ln.weight, self.pre_ln.bias,
                           config.layer_norm_eps)
        attend = _VISION_ATTENTION[config.attention_impl]
        for layer in self.layers:
            x = layer(x, attend)
        return x


class CLIPEncoder(nn.Module):
    """Both towers; the module's dtype is the compute dtype."""

    def __init__(self, text_config: CLIPTextConfig,
                 vision_config: CLIPVisionConfig, pre_ln: bool = True):
        super().__init__()
        self.text = CLIPTextTower(text_config)
        self.vision = CLIPVisionTower(vision_config, pre_ln)


def encode_clip_text(model: CLIPEncoder,
                     input_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) int → (B, projection_dim) fp32 (unnormalized)."""
    return model.text(input_ids)


def encode_clip_image(model: CLIPEncoder,
                      pixels_u8: torch.Tensor) -> torch.Tensor:
    """(B, size, size, 3) uint8 → (B, projection_dim) fp32 (unnormalized)."""
    return model.vision(pixels_u8)


# --- init + conversion -------------------------------------------------------

def _empty_clip(text_config, vision_config, dtype, device,
                pre_ln: bool = True) -> CLIPEncoder:
    """A model with uninitialised storage on ``device`` (every caller fills
    all parameters)."""
    return empty_module(
        lambda: CLIPEncoder(text_config, vision_config, pre_ln), dtype, device)


def init_clip_params(text_config: CLIPTextConfig,
                     vision_config: CLIPVisionConfig,
                     generator: torch.Generator, dtype=torch.float32,
                     device="cuda") -> CLIPEncoder:
    """Random-init model (normal(0, 0.02) weights and embeddings, zero
    biases, unit LayerNorm scales), drawn from ``generator`` on
    ``device``."""
    return random_init(_empty_clip(text_config, vision_config, dtype,
                                   device), generator)


def init_vision_tower(vision_config: CLIPVisionConfig,
                      generator: torch.Generator, dtype=torch.float32,
                      device="cuda") -> CLIPVisionTower:
    """The vision tower alone, initialised as ``init_clip_params`` does."""
    return random_init(empty_module(lambda: CLIPVisionTower(vision_config),
                                    dtype, device), generator)


def _numpy_state_dict(state_dict) -> dict:
    return {k: (v.detach().cpu().float().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in state_dict.items()}


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def params_from_hf_clip(state_dict, text_config: CLIPTextConfig,
                        vision_config: CLIPVisionConfig) -> dict:
    """Convert an HF transformers CLIPModel state_dict into the JAX
    package's layout (numpy float32)."""
    sd = _numpy_state_dict(state_dict)

    def stack(prefix, name, L, transpose=False):
        arrs = []
        for i in range(L):
            a = sd[f"{prefix}.{i}.{name}"]
            arrs.append(a.T if transpose else a)
        return _f32(np.stack(arrs))

    def blocks(prefix, L):
        return {
            "q_w": stack(prefix, "self_attn.q_proj.weight", L, True),
            "q_b": stack(prefix, "self_attn.q_proj.bias", L),
            "k_w": stack(prefix, "self_attn.k_proj.weight", L, True),
            "k_b": stack(prefix, "self_attn.k_proj.bias", L),
            "v_w": stack(prefix, "self_attn.v_proj.weight", L, True),
            "v_b": stack(prefix, "self_attn.v_proj.bias", L),
            "o_w": stack(prefix, "self_attn.out_proj.weight", L, True),
            "o_b": stack(prefix, "self_attn.out_proj.bias", L),
            "ln1_scale": stack(prefix, "layer_norm1.weight", L),
            "ln1_bias": stack(prefix, "layer_norm1.bias", L),
            "mlp_w1": stack(prefix, "mlp.fc1.weight", L, True),
            "mlp_b1": stack(prefix, "mlp.fc1.bias", L),
            "mlp_w2": stack(prefix, "mlp.fc2.weight", L, True),
            "mlp_b2": stack(prefix, "mlp.fc2.bias", L),
            "ln2_scale": stack(prefix, "layer_norm2.weight", L),
            "ln2_bias": stack(prefix, "layer_norm2.bias", L),
        }

    # HF stores patch conv as (H, 3, p, p); the layout here is (p*p*3, H)
    # over patches laid out (p, p, 3)
    conv = sd["vision_model.embeddings.patch_embedding.weight"]
    H = conv.shape[0]
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, H)

    # pre-LN key: HF ships the typo'd name "pre_layrnorm"
    pre_ln_w = sd.get("vision_model.pre_layrnorm.weight",
                      sd.get("vision_model.pre_layernorm.weight"))
    pre_ln_b = sd.get("vision_model.pre_layrnorm.bias",
                      sd.get("vision_model.pre_layernorm.bias"))

    params = {
        "text": {
            "token_embedding": _f32(
                sd["text_model.embeddings.token_embedding.weight"]),
            "position_embedding": _f32(
                sd["text_model.embeddings.position_embedding.weight"]),
            "layers": blocks("text_model.encoder.layers",
                             text_config.num_layers),
            "final_ln_scale": _f32(sd["text_model.final_layer_norm.weight"]),
            "final_ln_bias": _f32(sd["text_model.final_layer_norm.bias"]),
            "text_projection": _f32(sd["text_projection.weight"].T),
        },
        "vision": {
            "patch_embedding": _f32(patch_w),
            "class_embedding": _f32(
                sd["vision_model.embeddings.class_embedding"]),
            "position_embedding": _f32(
                sd["vision_model.embeddings.position_embedding.weight"]),
            "layers": blocks("vision_model.encoder.layers",
                             vision_config.num_layers),
            "post_ln_scale": _f32(sd["vision_model.post_layernorm.weight"]),
            "post_ln_bias": _f32(sd["vision_model.post_layernorm.bias"]),
            "visual_projection": _f32(sd["visual_projection.weight"].T),
        },
    }
    if pre_ln_w is not None:
        params["vision"]["pre_ln_scale"] = _f32(pre_ln_w)
        params["vision"]["pre_ln_bias"] = _f32(pre_ln_b)
    return params


def convert_open_clip_resblocks(sd: dict, prefix: str, L: int) -> dict:
    """Stack L open_clip ResidualAttentionBlocks ({prefix}.{i}.attn with
    fused in_proj, ln_1/ln_2, mlp.c_fc/c_proj) into the stacked layer
    layout (numpy float32)."""
    out = {k: [] for k in ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b",
                           "o_w", "o_b", "ln1_scale", "ln1_bias",
                           "ln2_scale", "ln2_bias", "mlp_w1", "mlp_b1",
                           "mlp_w2", "mlp_b2")}
    for i in range(L):
        base = f"{prefix}.{i}"
        in_w = sd[f"{base}.attn.in_proj_weight"]  # (3H, H)
        in_b = sd[f"{base}.attn.in_proj_bias"]
        qw, kw, vw = np.split(in_w, 3, axis=0)
        qb, kb, vb = np.split(in_b, 3, axis=0)
        out["q_w"].append(qw.T); out["q_b"].append(qb)
        out["k_w"].append(kw.T); out["k_b"].append(kb)
        out["v_w"].append(vw.T); out["v_b"].append(vb)
        out["o_w"].append(sd[f"{base}.attn.out_proj.weight"].T)
        out["o_b"].append(sd[f"{base}.attn.out_proj.bias"])
        out["ln1_scale"].append(sd[f"{base}.ln_1.weight"])
        out["ln1_bias"].append(sd[f"{base}.ln_1.bias"])
        out["mlp_w1"].append(sd[f"{base}.mlp.c_fc.weight"].T)
        out["mlp_b1"].append(sd[f"{base}.mlp.c_fc.bias"])
        out["mlp_w2"].append(sd[f"{base}.mlp.c_proj.weight"].T)
        out["mlp_b2"].append(sd[f"{base}.mlp.c_proj.bias"])
        out["ln2_scale"].append(sd[f"{base}.ln_2.weight"])
        out["ln2_bias"].append(sd[f"{base}.ln_2.bias"])
    return {k: _f32(np.stack(v)) for k, v in out.items()}


def params_from_open_clip(state_dict, text_config: CLIPTextConfig,
                          vision_config: CLIPVisionConfig) -> dict:
    """Convert openai-CLIP / open_clip state-dict naming
    (visual.transformer.resblocks.*, in_proj_weight fused QKV) into the JAX
    package's layout (numpy float32). Projections are already (in, out)."""
    sd = _numpy_state_dict(state_dict)
    return {"text": open_clip_text(sd, text_config.num_layers),
            "vision": open_clip_vision(sd, vision_config)}


def open_clip_text(sd: dict, num_layers: int) -> dict:
    """The text half of an openai/open_clip state dict (numpy arrays:
    token_embedding, positional_embedding, transformer.resblocks, ln_final,
    text_projection) in the JAX package's layout; the ResNet and ConvNeXt
    CLIP checkpoints carry the same text half."""
    return {
        "token_embedding": _f32(sd["token_embedding.weight"]),
        "position_embedding": _f32(sd["positional_embedding"]),
        "layers": convert_open_clip_resblocks(sd, "transformer.resblocks",
                                              num_layers),
        "final_ln_scale": _f32(sd["ln_final.weight"]),
        "final_ln_bias": _f32(sd["ln_final.bias"]),
        "text_projection": _f32(sd["text_projection"]),
    }


def open_clip_vision(sd: dict, vision_config: CLIPVisionConfig) -> dict:
    """The vision half of an openai/open_clip state dict (numpy arrays:
    visual.conv1, class_embedding, positional_embedding, ln_pre,
    transformer.resblocks, ln_post, proj) in the JAX package's layout."""
    conv = sd["visual.conv1.weight"]  # (H, 3, p, p)
    H = conv.shape[0]
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, H)
    return {
        "patch_embedding": _f32(patch_w),
        "class_embedding": _f32(sd["visual.class_embedding"]),
        "position_embedding": _f32(sd["visual.positional_embedding"]),
        "pre_ln_scale": _f32(sd["visual.ln_pre.weight"]),
        "pre_ln_bias": _f32(sd["visual.ln_pre.bias"]),
        "layers": convert_open_clip_resblocks(
            sd, "visual.transformer.resblocks", vision_config.num_layers),
        "post_ln_scale": _f32(sd["visual.ln_post.weight"]),
        "post_ln_bias": _f32(sd["visual.ln_post.bias"]),
        "visual_projection": _f32(sd["visual.proj"]),
    }


# this module's block parameter names ← the stacked layer keys
_JAX_BLOCK = {
    "q": ("q_w", "q_b"), "k": ("k_w", "k_b"), "v": ("v_w", "v_b"),
    "o": ("o_w", "o_b"), "ln1": ("ln1_scale", "ln1_bias"),
    "ln2": ("ln2_scale", "ln2_bias"), "fc1": ("mlp_w1", "mlp_b1"),
    "fc2": ("mlp_w2", "mlp_b2"),
}


def params_from_jax(params_numpy: dict, text_config: CLIPTextConfig,
                    vision_config: CLIPVisionConfig, dtype=torch.float32,
                    device="cuda") -> CLIPEncoder:
    """A model holding parameters in the JAX package's layout, given as
    numpy arrays ({"text": {...}, "vision": {...}} with stacked layers):
    the JAX package's own params, or a converter's output above."""
    text, vision = params_numpy["text"], params_numpy["vision"]
    values = {
        **text_values("text.", text, text_config.num_layers),
        **_vision_values("vision.", vision, vision_config.num_layers),
    }
    model = _empty_clip(text_config, vision_config, dtype, device,
                        "pre_ln_scale" in vision)
    return fill_parameters(model, values)


def vision_tower_from_jax(vision_numpy: dict,
                          vision_config: CLIPVisionConfig,
                          dtype=torch.float32,
                          device="cuda") -> CLIPVisionTower:
    """The vision tower alone, from the ``"vision"`` part of the JAX
    package's layout (numpy arrays)."""
    tower = empty_module(
        lambda: CLIPVisionTower(vision_config,
                                pre_ln="pre_ln_scale" in vision_numpy),
        dtype, device)
    return fill_parameters(
        tower, _vision_values("", vision_numpy, vision_config.num_layers))


def text_values(prefix: str, text: dict, L: int) -> dict:
    """The values of a ``CLIPTextTower`` under ``prefix``, from the
    ``"text"`` part of the JAX package's layout (numpy arrays)."""
    return {
        f"{prefix}token_embedding": text["token_embedding"],
        f"{prefix}position_embedding": text["position_embedding"],
        f"{prefix}final_ln.weight": text["final_ln_scale"],
        f"{prefix}final_ln.bias": text["final_ln_bias"],
        f"{prefix}projection": text["text_projection"],
        **block_values(prefix, text, L),
    }


def block_values(prefix: str, tree: dict, L: int) -> dict:
    """The values of L ``PreNormBlock``s under ``{prefix}layers.``, from
    the stacked layer keys of ``tree["layers"]`` (numpy arrays)."""
    values = {}
    for i in range(L):
        for name, (w, b) in _JAX_BLOCK.items():
            # .T turns (in, out) into nn.Linear's (out, in); 1-D LayerNorm
            # scales pass as they are
            values[f"{prefix}layers.{i}.{name}.weight"] = \
                np.asarray(tree["layers"][w][i]).T
            values[f"{prefix}layers.{i}.{name}.bias"] = tree["layers"][b][i]
    return values


def _vision_values(prefix: str, vision: dict, L: int) -> dict:
    values = {
        f"{prefix}patch_embedding": vision["patch_embedding"],
        f"{prefix}class_embedding": vision["class_embedding"],
        f"{prefix}position_embedding": vision["position_embedding"],
        f"{prefix}post_ln.weight": vision["post_ln_scale"],
        f"{prefix}post_ln.bias": vision["post_ln_bias"],
        f"{prefix}projection": vision["visual_projection"],
        **block_values(prefix, vision, L),
    }
    if "pre_ln_scale" in vision:
        values[f"{prefix}pre_ln.weight"] = vision["pre_ln_scale"]
        values[f"{prefix}pre_ln.bias"] = vision["pre_ln_bias"]
    return values


def load_open_clip_state(path: str, family: str = "open_clip",
                         weights_only: bool = True) -> dict:
    """An open_clip checkpoint's state dict from a file or a directory
    holding one, without a ``module.`` prefix (a jit-archived openai
    checkpoint, loaded with ``weights_only=False``, gives its
    ``state_dict()``)."""
    import os

    from marqo_tpu_torch.inference.checkpoint_load import \
        load_torch_checkpoint
    if os.path.isdir(path):
        for fname in ("open_clip_pytorch_model.bin", "pytorch_model.bin",
                      "model.pt"):
            candidate = os.path.join(path, fname)
            if os.path.isfile(candidate):
                path = candidate
                break
    state = load_torch_checkpoint(path, family=family,
                                  weights_only=weights_only)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def random_seed(model_name: str) -> int:
    """The random-init seed of a model name, as every wrapper derives it."""
    return int.from_bytes(hashlib.sha256(model_name.encode()).digest()[:4],
                          "little")


# --- model wrapper -----------------------------------------------------------

# registry name → HF hub repo for the openai CLIP family
_OPENAI_HF_REPOS = {
    "ViT-B/32": "openai/clip-vit-base-patch32",
    "ViT-B/16": "openai/clip-vit-base-patch16",
    "ViT-L/14": "openai/clip-vit-large-patch14",
    "ViT-L/14@336px": "openai/clip-vit-large-patch14-336",
}


class TorchCLIPModel:
    """CLIP wrapper with text + image encode (reference CLIP class,
    clip_utils.py:295; open_clip class, open_clip_model.py:28). Under the
    serving mesh (parallel/serving.py) the encoder replicates on each
    data-parallel group and every batch bucket splits across the groups;
    without one it runs on its one device."""

    compute_dtype = torch.bfloat16

    def __init__(self, model_name: str, properties: dict, device: Device,
                 model_auth=None):
        self.model_name = model_name
        self.properties = dict(properties or {})
        self.device = device
        self.model_auth = model_auth
        self.loaded = False
        self.encoder: Optional[CLIPEncoder] = None
        self.text_config: Optional[CLIPTextConfig] = None
        self.vision_config: Optional[CLIPVisionConfig] = None
        self.tokenizer = None
        self._device = torch.device(
            "cuda" if device == Device.CUDA else "cpu")
        self._param_bytes = 0
        self.graphs = EncoderGraphs(self._device)

    @property
    def dimensions(self) -> int:
        return int(self.properties.get("dimensions", 0)) or \
            (self.text_config.projection_dim if self.text_config else 0)

    def load(self) -> None:
        if self.properties.get("localpath"):
            self._load_from_hf_dir(self.properties["localpath"])
        elif self.properties.get("random_init"):
            self._load_random_init()
        else:
            repo = _OPENAI_HF_REPOS.get(
                self.model_name, self.properties.get("name", self.model_name))
            try:
                self._load_from_hf_dir(repo)
            except Exception as e:
                raise ModelLoadError(
                    f"Could not load CLIP model `{self.model_name}` from "
                    f"`{repo}`: {e}. If running offline, provide "
                    f"model_properties.localpath.", cause=e)
        self.encoder = put_params(self, self.encoder)
        self.loaded = True
        self._param_bytes = sum(p.numel() * p.element_size()
                                for p in self.encoder.parameters())

    def _load_from_hf_dir(self, repo_or_path: str) -> None:
        from transformers import CLIPConfig, CLIPModel, CLIPTokenizerFast
        hf_config = CLIPConfig.from_pretrained(repo_or_path)
        self.text_config = CLIPTextConfig(
            vocab_size=hf_config.text_config.vocab_size,
            hidden_size=hf_config.text_config.hidden_size,
            num_layers=hf_config.text_config.num_hidden_layers,
            num_heads=hf_config.text_config.num_attention_heads,
            intermediate_size=hf_config.text_config.intermediate_size,
            max_positions=hf_config.text_config.max_position_embeddings,
            projection_dim=hf_config.projection_dim,
            hidden_act=hf_config.text_config.hidden_act,
            eos_token_id=hf_config.text_config.eos_token_id,
        )
        self.vision_config = CLIPVisionConfig(
            image_size=hf_config.vision_config.image_size,
            patch_size=hf_config.vision_config.patch_size,
            hidden_size=hf_config.vision_config.hidden_size,
            num_layers=hf_config.vision_config.num_hidden_layers,
            num_heads=hf_config.vision_config.num_attention_heads,
            intermediate_size=hf_config.vision_config.intermediate_size,
            projection_dim=hf_config.projection_dim,
            hidden_act=hf_config.vision_config.hidden_act,
        )
        torch_model = CLIPModel.from_pretrained(repo_or_path)
        self.encoder = params_from_jax(
            params_from_hf_clip(torch_model.state_dict(), self.text_config,
                                self.vision_config),
            self.text_config, self.vision_config, dtype=self.compute_dtype,
            device=self._device)
        del torch_model
        self.tokenizer = CLIPTokenizerFast.from_pretrained(repo_or_path)

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        proj = int(self.properties.get("dimensions", 512))
        self.text_config = CLIPTextConfig(
            vocab_size=int(arch.get("vocab_size", 1024)),
            hidden_size=int(arch.get("text_hidden_size", 64)),
            num_layers=int(arch.get("text_layers", 2)),
            num_heads=int(arch.get("text_heads", 2)),
            intermediate_size=int(arch.get("text_intermediate", 128)),
            projection_dim=proj,
            eos_token_id=int(arch.get("vocab_size", 1024)) - 1,
        )
        self.vision_config = CLIPVisionConfig(
            image_size=int(self.properties.get("image_size", 224)),
            patch_size=int(arch.get("patch_size", 32)),
            hidden_size=int(arch.get("vision_hidden_size", 64)),
            num_layers=int(arch.get("vision_layers", 2)),
            num_heads=int(arch.get("vision_heads", 2)),
            intermediate_size=int(arch.get("vision_intermediate", 128)),
            projection_dim=proj,
        )
        generator = torch.Generator(device=self._device).manual_seed(
            random_seed(self.model_name))
        self.encoder = init_clip_params(self.text_config, self.vision_config,
                                        generator, dtype=self.compute_dtype,
                                        device=self._device)
        from marqo_tpu_torch.models.tokenizer import TextTokenizer
        self.tokenizer = TextTokenizer.build_test_wordpiece(
            max_length=self.text_config.max_positions)

    # -- encoding ------------------------------------------------------------

    def _tokenize(self, texts: List[str]) -> np.ndarray:
        max_len = self.text_config.max_positions
        from marqo_tpu_torch.models.tokenizer import TextTokenizer
        if isinstance(self.tokenizer, TextTokenizer):
            batch = self.tokenizer.encode_batch(texts, pad_to=max_len)
            ids = batch["input_ids"] % self.text_config.vocab_size
            # mark EOS at the end of each sequence for pooling
            for i, L in enumerate(batch["lengths"]):
                ids[i, min(L, max_len) - 1] = self.text_config.eos_token_id
            return ids.astype(np.int32)
        enc = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=max_len, return_tensors="np")
        return enc["input_ids"].astype(np.int32)

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

    def _run(self, array: np.ndarray, tower: str, pad_value=0) -> np.ndarray:
        """The ``tower`` ("text" or "vision") of this model's encoder over
        ``array`` in batch buckets, the short last bucket filled with
        ``pad_value`` (a scalar or one row); one device-to-host copy. On
        CUDA the tower replays one graph per bucket (inference/graphs.py),
        in every subclass: the ResNet and ConvNeXt towers and the HF
        composite's too."""
        return tower_encode(self, array, tower, pad_value)

    def _encode_text(self, texts: List[str]) -> np.ndarray:
        ids = self._tokenize(texts)
        # pad rows: all zeros with EOS in the last position
        pad_row = np.zeros(ids.shape[1], dtype=np.int32)
        pad_row[-1] = self.text_config.eos_token_id
        return self._run(ids, "text", pad_row)

    def _preprocess_host(self, content) -> np.ndarray:
        """decode → EXIF → shorter-side bicubic resize → center crop, all in
        uint8 on host (exact torchvision/PIL parity); returns
        (size, size, 3) uint8."""
        from PIL import Image
        size = self.vision_config.image_size
        arr = host_decode(content)
        img = Image.fromarray(arr)
        w, h = img.size
        if w <= h:
            new_w, new_h = size, max(1, int(round(h * size / w)))
        else:
            new_w, new_h = max(1, int(round(w * size / h))), size
        img = img.resize((new_w, new_h), Image.BICUBIC)
        left = (new_w - size) // 2
        top = (new_h - size) // 2
        img = img.crop((left, top, left + size, top + size))
        return np.asarray(img, dtype=np.uint8)

    def _encode_images(self, contents: List[Any]) -> np.ndarray:
        pixels = np.stack([self._preprocess_host(c) for c in contents])
        return self._run(pixels, "vision")

    def memory_bytes(self) -> int:
        return self._param_bytes

    def warmup(self, images: int = 16) -> int:
        """Encode the image buckets of 1 and ``images`` and the text buckets
        of as many captions once each: on CUDA that captures the towers'
        graphs, so serving never pays a capture (elsewhere it is an eager
        warm run). Returns #buckets run."""
        size = self.vision_config.image_size
        for n in (1, images):
            self._run(np.zeros((n, size, size, 3), dtype=np.uint8),
                      "vision")
            self._encode_text(["a photo"] * n)
        return 4
