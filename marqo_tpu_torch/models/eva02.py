"""EVA02-CLIP in PyTorch (port of marqo_tpu/models/eva02.py): a RoPE +
SwiGLU vision trunk with a standard CLIP text tower.

Parity target: the reference serves EVA02 checkpoints through open_clip's
timm trunk (model_registry.py open_clip section: EVA02-B-16 / EVA02-L-14 /
EVA02-L-14-336). The vision trunk follows the EVA-02 paper
(arXiv:2303.11331) and timm's ``eva.py`` block layout:

  - patch embedding with a bias (stride == patch, so a matmul over unfolded
    (p, p, 3) patches), class token, learned absolute position embeddings;
  - per-layer 2D axial rotary embeddings on q and k of every patch token
    (the class token is NOT rotated), GPT-NeoX-style interleaved pairs
    with axial y/x frequency bands (timm RotaryEmbeddingCat);
  - attention with q and v biases and NO k bias, on ops/fused_attention.py's
    no-mask mode (CUDA kernel B2 on a CUDA device, its plain twin on the
    CPU; ``attention_impl="plain"`` selects the twin) over the rotated q, k
    and v in the projections' (B, S, N, D) layout;
  - SwiGLU FFN with an inner LayerNorm before the down-projection
    (timm ``SwiGLU``: fc2(norm(silu(fc1_g(x)) * fc1_x(x))));
  - final LayerNorm, class-token pooling, a linear head (fp32).

The text tower is models/clip.py's (causal, plain torch). The module's
dtype is the compute dtype (the RoPE table's too: the JAX package casts its
fp32 table to the compute dtype at use). Kernel B2 computes the scores in
fp32 from the compute-dtype q and k, where the JAX package rounds them to
the compute dtype first (ROADMAP §C).

OFFLINE-VERIFICATION STATUS: as in the JAX package, the checkpoint KEY
MAPPING cannot be verified against a real EVA02 state dict (timm and
open_clip are not installed), so loading real weights requires
MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE and logs a warning naming exactly
what is unverified.
"""

from dataclasses import dataclass, replace
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.core.exceptions import ModelLoadError, VectoriseError
from marqo_tpu_torch.inference.batching import tower_encode
from marqo_tpu_torch.inference.graphs import EncoderGraphs
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.logging import get_logger
from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.models.clip import (_VISION_ATTENTION, CLIPTextConfig,
                                         CLIPTextTower, _f32, _pixel_stats,
                                         _numpy_state_dict,
                                         convert_open_clip_resblocks,
                                         load_open_clip_state, random_seed,
                                         text_values)
from marqo_tpu_torch.ops.common import layer_norm
from marqo_tpu_torch.parallel.serving import put_params, replicas

logger = get_logger(__name__)


@dataclass(frozen=True)
class EVA02VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    swiglu_hidden: int = 2730  # EVA02 mlp_ratio 4*2/3
    embed_dim: int = 768
    layer_norm_eps: float = 1e-6
    rope_temperature: float = 100.0
    # "kernel": ops/fused_attention.py (CUDA kernel B2 on a CUDA device,
    # plain twin on the CPU); "plain": always the plain twin
    attention_impl: str = "kernel"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


# open_clip model configs for the registry names (width, layers, heads,
# patch, swiglu hidden, embed) + text tower (width, layers, heads, mlp)
EVA02_ARCHS = {
    "EVA02-B-16": ((768, 12, 12, 16, 2048, 512), (512, 12, 8, 2048)),
    "EVA02-L-14-336": ((1024, 24, 16, 14, 2730, 768), (768, 12, 12, 3072)),
    "EVA02-L-14": ((1024, 24, 16, 14, 2730, 768), (768, 12, 12, 3072)),
}


def rope_2d_freqs(grid_side: int, head_dim: int,
                  temperature: float = 100.0) -> np.ndarray:
    """Axial 2D rotary sin/cos table for a (grid, grid) patch grid.

    Returns (grid², head_dim * 2): [sin | cos], each half laid out as
    interleaved axial bands [y-bands repeated 2x, x-bands repeated 2x]
    (timm RotaryEmbeddingCat with in_pixels=False)."""
    num_bands = head_dim // 4
    exponent = np.arange(num_bands, dtype=np.float64) / num_bands
    inv_freq = 1.0 / (temperature ** exponent)
    t = np.arange(grid_side, dtype=np.float64)
    per_axis = np.outer(t, inv_freq)                      # (S, bands)
    ys = np.repeat(per_axis[:, None, :], grid_side, 1)    # (S, S, bands) y
    xs = np.repeat(per_axis[None, :, :], grid_side, 0)    # (S, S, bands) x
    freqs = np.concatenate([ys, xs], axis=-1).reshape(grid_side ** 2,
                                                      head_dim // 2)
    freqs = np.repeat(freqs, 2, axis=-1)                  # interleave pairs
    return np.concatenate([np.sin(freqs), np.cos(freqs)],
                          axis=-1).astype(np.float32)


def _rot(x: torch.Tensor) -> torch.Tensor:
    """GPT-NeoX interleaved rotation: (-x1, x0, -x3, x2, ...)."""
    x0 = x[..., 0::2]
    x1 = x[..., 1::2]
    return torch.stack([-x1, x0], dim=-1).reshape(x.shape)


def _apply_rope(x: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); sin/cos broadcast against it ((S, D) for a
    (B, N, S, D) x)."""
    return x * cos + _rot(x) * sin


class EVA02Block(nn.Module):
    """One EVA02 block (marqo_tpu eva02.py ``_eva_block``)."""

    def __init__(self, config: EVA02VisionConfig):
        super().__init__()
        H, I = config.hidden_size, config.swiglu_hidden
        self.num_heads, self.eps = config.num_heads, config.layer_norm_eps
        self.ln1 = nn.LayerNorm(H)
        self.q = nn.Linear(H, H)
        self.k = nn.Linear(H, H, bias=False)  # EVA: no k bias
        self.v = nn.Linear(H, H)
        self.o = nn.Linear(H, H)
        self.ln2 = nn.LayerNorm(H)
        self.w1_gate = nn.Linear(H, I)
        self.w1_val = nn.Linear(H, I)
        self.ffn_ln = nn.LayerNorm(I)
        self.w2 = nn.Linear(I, H)

    def forward(self, x: torch.Tensor, rope_sin: torch.Tensor,
                rope_cos: torch.Tensor, attend) -> torch.Tensor:
        """x: (B, S, H) with x[:, 0] the class token; rope_sin/cos
        (S - 1, D) in x's dtype; ``attend(q, k, v)`` on (B, N, S, D)."""
        B, S, H = x.shape
        N = self.num_heads
        D = H // N
        h = layer_norm(x, self.ln1.weight, self.ln1.bias, self.eps)

        def rotated(t):
            # rotate the patch tokens in the projection's (B, S, N, D)
            # layout, then view it as (B, N, S, D) for the kernel
            t = t.view(B, S, N, D)
            patches = _apply_rope(t[:, 1:], rope_sin[:, None],
                                  rope_cos[:, None])
            return torch.cat([t[:, :1], patches], dim=1).transpose(1, 2)

        v = self.v(h).view(B, S, N, D).transpose(1, 2)
        ctx = attend(rotated(self.q(h)), rotated(self.k(h)), v)
        x = x + self.o(ctx.transpose(1, 2).reshape(B, S, H))
        h = layer_norm(x, self.ln2.weight, self.ln2.bias, self.eps)
        inner = torch.nn.functional.silu(self.w1_gate(h)) * self.w1_val(h)
        inner = layer_norm(inner, self.ffn_ln.weight, self.ffn_ln.bias,
                           self.eps)
        return x + self.w2(inner)


class EVA02VisionTower(nn.Module):
    def __init__(self, config: EVA02VisionConfig):
        super().__init__()
        H, p = config.hidden_size, config.patch_size
        D = H // config.num_heads
        self.config = config
        # (p*p*3, H) over patches laid out (p, p, 3)
        self.patch_embedding = nn.Parameter(torch.empty(p * p * 3, H))
        self.patch_bias = nn.Parameter(torch.empty(H))
        self.class_embedding = nn.Parameter(torch.empty(H))
        self.position_embedding = nn.Parameter(
            torch.empty(config.grid ** 2 + 1, H))
        # (grid², 2D) [sin | cos] in the module's dtype: the JAX package
        # casts its fp32 table to the compute dtype at use, one rounding
        self.register_buffer("rope_table",
                             torch.empty(config.grid ** 2, 2 * D))
        self.layers = nn.ModuleList(EVA02Block(config)
                                    for _ in range(config.num_layers))
        self.final_ln = nn.LayerNorm(H)
        # (in, out), applied in fp32
        self.head_w = nn.Parameter(torch.empty(H, config.embed_dim))

    def forward(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """(B, size, size, 3) uint8 → (B, embed_dim) fp32 (unnormalized)."""
        config = self.config
        B, n, p = pixels_u8.shape[0], config.grid, config.patch_size
        mean, std = _pixel_stats(pixels_u8.device)
        x = (pixels_u8.float() / 255.0 - mean) / std
        x = x.reshape(B, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(
            B, n * n, p * p * 3)
        weight = self.patch_embedding
        x = torch.matmul(x.to(weight.dtype), weight) + self.patch_bias
        cls = self.class_embedding.expand(B, 1, config.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        D = config.hidden_size // config.num_heads
        rope_sin = self.rope_table[:, :D].to(x.dtype)
        rope_cos = self.rope_table[:, D:].to(x.dtype)
        attend = _VISION_ATTENTION[config.attention_impl]
        for layer in self.layers:
            x = layer(x, rope_sin, rope_cos, attend)
        x = layer_norm(x.float(), self.final_ln.weight, self.final_ln.bias,
                       config.layer_norm_eps)
        # class-token pooling (timm global_pool='token')
        return x[:, 0] @ self.head_w.float()


class EVA02Encoder(nn.Module):
    """Both towers; the module's dtype is the compute dtype."""

    def __init__(self, text_config: CLIPTextConfig,
                 vision_config: EVA02VisionConfig):
        super().__init__()
        self.text = CLIPTextTower(text_config)
        self.vision = EVA02VisionTower(vision_config)


def encode_eva02_image(model: EVA02Encoder,
                       pixels_u8: torch.Tensor) -> torch.Tensor:
    """(B, size, size, 3) uint8 → (B, embed_dim) fp32 (unnormalized)."""
    return model.vision(pixels_u8)


def encode_eva02_text(model: EVA02Encoder,
                      input_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) int → (B, projection_dim) fp32 (unnormalized)."""
    return model.text(input_ids)


# --- init / conversion -------------------------------------------------------

def _rope_table(config: EVA02VisionConfig) -> np.ndarray:
    return rope_2d_freqs(config.grid, config.hidden_size // config.num_heads,
                         config.rope_temperature)


def init_eva02_params(text_config: CLIPTextConfig,
                      vision_config: EVA02VisionConfig,
                      generator: torch.Generator, dtype=torch.float32,
                      device="cuda") -> EVA02Encoder:
    """Random-init model (normal(0, 0.02) weights and embeddings, zero
    biases, unit LayerNorm scales), drawn from ``generator`` on ``device``;
    the RoPE table from ``rope_2d_freqs``."""
    model = random_init(empty_module(
        lambda: EVA02Encoder(text_config, vision_config), dtype, device),
        generator)
    with torch.no_grad():
        model.vision.rope_table.copy_(torch.from_numpy(
            _rope_table(vision_config)))
    return model


def params_from_open_clip_eva02(state_dict, text_config: CLIPTextConfig,
                                vision_config: EVA02VisionConfig) -> dict:
    """Convert an open_clip EVA02 state dict (timm trunk under
    ``visual.trunk.*``) into the JAX package's layout (numpy float32).

    UNVERIFIED MAPPING: timm/open_clip are not installed here, so the key
    names below follow timm eva.py's published layout but cannot be
    diff-tested against a real checkpoint offline. Guarded by
    MARQO_ALLOW_UNVERIFIED_CONVERSION at the caller.
    """
    sd = _numpy_state_dict(state_dict)

    def get(*names):
        for name in names:
            if name in sd:
                return sd[name]
        raise ModelLoadError(
            f"EVA02 conversion: none of {names} found in checkpoint "
            f"(unverified mapping — see models/eva02.py)")

    V = "visual.trunk."
    L = vision_config.num_layers
    H = vision_config.hidden_size

    def stacked(fmt, transpose=False, optional_zero=None):
        mats = []
        for i in range(L):
            key = fmt.format(i=i)
            if key not in sd and optional_zero is not None:
                mats.append(np.zeros(optional_zero, np.float32))
                continue
            mats.append(sd[key].T if transpose else sd[key])
        return _f32(np.stack(mats))

    # timm SwiGLU: fc1_g / fc1_x / norm / fc2
    layers = {
        "q_w": stacked(V + "blocks.{i}.attn.q_proj.weight", transpose=True),
        "q_b": stacked(V + "blocks.{i}.attn.q_bias", optional_zero=(H,)),
        "k_w": stacked(V + "blocks.{i}.attn.k_proj.weight", transpose=True),
        "v_w": stacked(V + "blocks.{i}.attn.v_proj.weight", transpose=True),
        "v_b": stacked(V + "blocks.{i}.attn.v_bias", optional_zero=(H,)),
        "o_w": stacked(V + "blocks.{i}.attn.proj.weight", transpose=True),
        "o_b": stacked(V + "blocks.{i}.attn.proj.bias"),
        "ln1_scale": stacked(V + "blocks.{i}.norm1.weight"),
        "ln1_bias": stacked(V + "blocks.{i}.norm1.bias"),
        "ln2_scale": stacked(V + "blocks.{i}.norm2.weight"),
        "ln2_bias": stacked(V + "blocks.{i}.norm2.bias"),
        "w1_gate": stacked(V + "blocks.{i}.mlp.fc1_g.weight", transpose=True),
        "b1_gate": stacked(V + "blocks.{i}.mlp.fc1_g.bias"),
        "w1_val": stacked(V + "blocks.{i}.mlp.fc1_x.weight", transpose=True),
        "b1_val": stacked(V + "blocks.{i}.mlp.fc1_x.bias"),
        "ffn_ln_scale": stacked(V + "blocks.{i}.mlp.norm.weight"),
        "ffn_ln_bias": stacked(V + "blocks.{i}.mlp.norm.bias"),
        "w2": stacked(V + "blocks.{i}.mlp.fc2.weight", transpose=True),
        "b2": stacked(V + "blocks.{i}.mlp.fc2.bias"),
    }
    patch = vision_config.patch_size
    # conv (H, 3, p, p) → matmul over unfolded (p, p, 3) patches
    patch_w = get(V + "patch_embed.proj.weight").transpose(2, 3, 1, 0)
    vision = {
        "patch_embedding": _f32(patch_w.reshape(patch * patch * 3, H)),
        "patch_bias": _f32(get(V + "patch_embed.proj.bias")),
        "class_embedding": _f32(get(V + "cls_token")).reshape(H),
        "position_embedding": _f32(get(V + "pos_embed")).reshape(-1, H),
        "rope_table": _rope_table(vision_config),
        "layers": layers,
        "final_ln_scale": _f32(get(V + "norm.weight", V + "fc_norm.weight")),
        "final_ln_bias": _f32(get(V + "norm.bias", V + "fc_norm.bias")),
        "head_w": _f32(get(V + "head.weight", "visual.head.proj.weight").T),
    }

    # text tower: standard open_clip CLIP text transformer
    text_prefix = ("text.transformer.resblocks"
                   if "text.transformer.resblocks.0.attn.in_proj_weight"
                   in sd else "transformer.resblocks")
    tp = "text." if text_prefix.startswith("text.") else ""
    text = {
        "token_embedding": _f32(sd[tp + "token_embedding.weight"]),
        "position_embedding": _f32(sd[tp + "positional_embedding"]),
        "layers": convert_open_clip_resblocks(sd, text_prefix,
                                              text_config.num_layers),
        "final_ln_scale": _f32(sd[tp + "ln_final.weight"]),
        "final_ln_bias": _f32(sd[tp + "ln_final.bias"]),
        "text_projection": _f32(sd[tp + "text_projection"]),
    }
    return {"vision": vision, "text": text}


# this module's block parameter names ← the stacked EVA02 layer keys (k has
# no bias)
_EVA_BLOCK = {
    "q": ("q_w", "q_b"), "k": ("k_w", None), "v": ("v_w", "v_b"),
    "o": ("o_w", "o_b"), "ln1": ("ln1_scale", "ln1_bias"),
    "ln2": ("ln2_scale", "ln2_bias"), "w1_gate": ("w1_gate", "b1_gate"),
    "w1_val": ("w1_val", "b1_val"), "ffn_ln": ("ffn_ln_scale", "ffn_ln_bias"),
    "w2": ("w2", "b2"),
}


def vision_values(prefix: str, vision: dict, L: int) -> dict:
    """The values of an ``EVA02VisionTower`` under ``prefix``, from the
    ``"vision"`` part of the JAX package's layout (numpy arrays; weights
    (in, out) there, so they transpose)."""
    values = {
        f"{prefix}patch_embedding": vision["patch_embedding"],
        f"{prefix}patch_bias": vision["patch_bias"],
        f"{prefix}class_embedding": vision["class_embedding"],
        f"{prefix}position_embedding": vision["position_embedding"],
        f"{prefix}rope_table": vision["rope_table"],
        f"{prefix}final_ln.weight": vision["final_ln_scale"],
        f"{prefix}final_ln.bias": vision["final_ln_bias"],
        f"{prefix}head_w": vision["head_w"],
    }
    for i in range(L):
        for name, (w, b) in _EVA_BLOCK.items():
            values[f"{prefix}layers.{i}.{name}.weight"] = \
                np.asarray(vision["layers"][w][i]).T
            if b is not None:
                values[f"{prefix}layers.{i}.{name}.bias"] = \
                    vision["layers"][b][i]
    return values


def params_from_jax(params_numpy: dict, text_config: CLIPTextConfig,
                    vision_config: EVA02VisionConfig, dtype=torch.float32,
                    device="cuda") -> EVA02Encoder:
    """A model holding parameters in the JAX package's layout, given as
    numpy arrays ({"text": {...}, "vision": {...}} with stacked layers):
    the JAX package's own params, or the converter's output above."""
    model = empty_module(lambda: EVA02Encoder(text_config, vision_config),
                         dtype, device)
    return fill_parameters(model, {
        **text_values("text.", params_numpy["text"], text_config.num_layers),
        **vision_values("vision.", params_numpy["vision"],
                        vision_config.num_layers)})


# --- wrapper -----------------------------------------------------------------

class TorchEVA02Model:
    """EVA02-CLIP wrapper (text + image embedding; reference JaxEVA02Model).

    Real-checkpoint loading requires MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE
    (the timm key mapping is not offline-verifiable — see module docstring).
    """

    compute_dtype = torch.bfloat16

    def __init__(self, model_name: str, properties: dict, device: Device,
                 model_auth=None):
        self.model_name = model_name
        self.properties = dict(properties or {})
        self.device = device
        self.model_auth = model_auth
        self.loaded = False
        self.encoder: Optional[EVA02Encoder] = None
        self.text_config: Optional[CLIPTextConfig] = None
        self.vision_config: Optional[EVA02VisionConfig] = None
        self.tokenizer = None
        self._device = torch.device(
            "cuda" if device == Device.CUDA else "cpu")
        self._param_bytes = 0
        self.graphs = EncoderGraphs(self._device)

    @property
    def dimensions(self) -> int:
        return int(self.properties.get("dimensions", 0)) or \
            (self.vision_config.embed_dim if self.vision_config else 0)

    def _configs_for_name(self):
        name = self.properties.get("name", self.model_name)
        for token, (vis, txt) in EVA02_ARCHS.items():
            if token in name:
                w, L, h, patch, swiglu, embed = vis
                tw, tL, th, tmlp = txt
                image = 336 if "336" in token else int(
                    self.properties.get("image_size", 224))
                return (CLIPTextConfig(hidden_size=tw, num_layers=tL,
                                       num_heads=th, intermediate_size=tmlp,
                                       projection_dim=embed,
                                       hidden_act="gelu"),
                        EVA02VisionConfig(image_size=image, patch_size=patch,
                                          hidden_size=w, num_layers=L,
                                          num_heads=h, swiglu_hidden=swiglu,
                                          embed_dim=embed))
        return (CLIPTextConfig(projection_dim=512, hidden_act="gelu"),
                EVA02VisionConfig(embed_dim=512))

    def load(self) -> None:
        if self.properties.get("localpath") or \
                self.properties.get("model_location"):
            from marqo_tpu_torch.api import configs
            allow = str(configs.read_env_vars_and_defaults(
                "MARQO_ALLOW_UNVERIFIED_CONVERSION") or "").upper() == "TRUE"
            if not allow:
                raise ModelLoadError(
                    f"EVA02 model `{self.model_name}`: the timm checkpoint "
                    "key mapping cannot be verified offline (timm/open_clip "
                    "not installed). Set "
                    "MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE to load anyway "
                    "(block math is parity-tested; the KEY MAPPING is the "
                    "unverified part), or use a ViT/SigLIP CLIP model.")
            logger.warning(
                f"Loading EVA02 model `{self.model_name}` with UNVERIFIED "
                "checkpoint conversion: timm key layout and RoPE band "
                "convention assumed from published sources, not diff-tested "
                "against timm (MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE).")
            self._load_from_checkpoint()
        elif self.properties.get("random_init"):
            self._load_random_init()
        else:
            raise ModelLoadError(
                f"EVA02 model `{self.model_name}` requires an open_clip "
                "checkpoint: provide model_properties.localpath or a "
                "model_location (and MARQO_ALLOW_UNVERIFIED_CONVERSION).")
        self.encoder = put_params(self, self.encoder)
        self.loaded = True
        self._param_bytes = sum(
            t.numel() * t.element_size()
            for t in (*self.encoder.parameters(), *self.encoder.buffers()))

    def _load_from_checkpoint(self) -> None:
        path = self.properties.get("localpath")
        if not path and self.properties.get("model_location"):
            from marqo_tpu_torch.inference.model_download import (
                auth_for_location, download_model)
            loc = self.properties["model_location"]
            path = download_model(
                repo_location=loc,
                auth=auth_for_location(loc, self.model_auth))
        self.text_config, self.vision_config = self._configs_for_name()
        params = params_from_open_clip_eva02(
            load_open_clip_state(path), self.text_config, self.vision_config)
        self.encoder = params_from_jax(params, self.text_config,
                                       self.vision_config,
                                       dtype=self.compute_dtype,
                                       device=self._device)
        self._init_tokenizer()

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        embed = int(self.properties.get("dimensions", 64))
        self.text_config = CLIPTextConfig(
            vocab_size=int(arch.get("vocab_size", 1024)),
            hidden_size=int(arch.get("text_hidden_size", 32)),
            num_layers=int(arch.get("text_layers", 2)),
            num_heads=int(arch.get("text_heads", 2)),
            intermediate_size=int(arch.get("text_intermediate", 64)),
            projection_dim=embed, hidden_act="gelu",
            eos_token_id=int(arch.get("vocab_size", 1024)) - 1)
        self.vision_config = EVA02VisionConfig(
            image_size=int(self.properties.get("image_size", 32)),
            patch_size=int(arch.get("patch_size", 16)),
            hidden_size=int(arch.get("vision_hidden_size", 32)),
            num_layers=int(arch.get("vision_layers", 2)),
            num_heads=int(arch.get("vision_heads", 2)),
            swiglu_hidden=int(arch.get("swiglu_hidden", 48)),
            embed_dim=embed)
        generator = torch.Generator(device=self._device).manual_seed(
            random_seed(self.model_name))
        self.encoder = init_eva02_params(self.text_config, self.vision_config,
                                         generator, dtype=self.compute_dtype,
                                         device=self._device)
        self._init_tokenizer()

    def _init_tokenizer(self) -> None:
        from marqo_tpu_torch.models.tokenizer import TextTokenizer
        self.tokenizer = TextTokenizer.build_test_wordpiece(
            max_length=self.text_config.max_positions)

    def set_attention_impl(self, impl: str) -> None:
        """"kernel" (B2 on a CUDA device) or "plain" (its twin) for the
        vision tower (the text tower is causal, in plain torch)."""
        for encoder in replicas(self):
            encoder.vision.config = replace(encoder.vision.config,
                                            attention_impl=impl)

    # encode paths reuse the CLIP wrapper's host preprocessing and tokenizing
    def _tokenize(self, texts: List[str]) -> np.ndarray:
        from marqo_tpu_torch.models.clip import TorchCLIPModel
        return TorchCLIPModel._tokenize(self, texts)

    def _preprocess_host(self, content) -> np.ndarray:
        from marqo_tpu_torch.models.clip import TorchCLIPModel
        return TorchCLIPModel._preprocess_host(self, content)

    def _run(self, array: np.ndarray, tower: str) -> np.ndarray:
        """The ``tower`` ("text" or "vision") of this model's encoder over
        ``array`` in batch buckets: on CUDA one graph per bucket (the RoPE
        tables are buffers, read by the capture in place), under a serving
        mesh split across its data-parallel groups."""
        return tower_encode(self, array, tower)

    def encode(self, contents: List[Any], normalize: bool = True,
               modality: Modality = Modality.TEXT) -> np.ndarray:
        if modality == Modality.TEXT:
            out = self._run(self._tokenize([str(c) for c in contents]),
                            "text")
        elif modality == Modality.IMAGE:
            pixels = np.stack([self._preprocess_host(c) for c in contents])
            out = self._run(pixels, "vision")
        else:
            raise VectoriseError(
                f"Model `{self.model_name}` does not support modality "
                f"{modality.value}")
        out = np.asarray(out, dtype=np.float32)
        if normalize:
            out = out / np.maximum(
                np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
        return out

    def memory_bytes(self) -> int:
        return self._param_bytes
