"""SigLIP (sigmoid-loss CLIP) in PyTorch (port of marqo_tpu/models/siglip.py).

Serves the open_clip SigLIP checkpoints (ViT-B-16-SigLIP{,-256,-384,-512},
ViT-L-16-SigLIP-{256,384}, ViT-SO400M-14-SigLIP{,-384}, and the product's
Marqo/marqo-fashionSigLIP, a ViT-B-16-SigLIP). Both towers differ from
CLIP's (models/clip.py):

  - Vision (timm ``vit_*_siglip``): patch embedding with a bias and NO
    class token; when the image size is not a multiple of the patch size
    the remainder is dropped, as the stride-p conv does (SO400M-14 at 384
    px: a 27 x 27 grid over 378 px); pre-LN blocks (LayerNorm eps 1e-6,
    exact GELU), a final LayerNorm, then the latent attention pool (one
    learned query cross-attends the grid, ``out = o + MLP(LN(o))``); no
    projection.
  - Text (open_clip TextTransformer): NO causal mask, padded to the full
    context length, the final LayerNorm then pooling at the LAST position,
    a linear projection with a bias.
  - Preprocessing: a square bicubic resize with no crop, mean and std 0.5.

Both towers' blocks are unmasked attention: ops/fused_attention.py's
no-mask mode (CUDA kernel B2 on a CUDA device, its plain twin on the CPU;
``attention_impl="plain"`` selects the twin). The latent pool's one query
stays plain torch, as the JAX package computes it in XLA. The module's
dtype is the compute dtype; LayerNorm statistics, the text pooling and
projection run in fp32. The converter returns the JAX package's layout as
numpy float32, and ``params_from_jax`` builds the module from that layout.
"""

import math
from dataclasses import dataclass, replace
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from marqo_tpu_torch.core.exceptions import ModelLoadError, VectoriseError
from marqo_tpu_torch.inference.batching import tower_encode
from marqo_tpu_torch.inference.graphs import EncoderGraphs
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.models.clip import (_VISION_ATTENTION, _blocks, _f32,
                                         _numpy_state_dict, block_values,
                                         convert_open_clip_resblocks,
                                         load_open_clip_state, random_seed)
from marqo_tpu_torch.ops.common import ACTIVATIONS, layer_norm
from marqo_tpu_torch.parallel.serving import put_params, replicas

SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class SigLIPTextConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    context_length: int = 64
    embed_dim: int = 768
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6
    # "kernel": ops/fused_attention.py (CUDA kernel B2 on a CUDA device,
    # plain twin on the CPU); "plain": always the plain twin
    attention_impl: str = "kernel"


@dataclass(frozen=True)
class SigLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6
    attention_impl: str = "kernel"

    @property
    def grid(self) -> int:
        """Patches a side: the remainder of image_size is dropped."""
        return self.image_size // self.patch_size


def single_query_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """(B, Sq, H) queries over (B, Sk, H) keys, unmasked, as the JAX
    package's ``_mha``: scores in the input dtype, then fp32 over sqrt(D)
    and the softmax, probabilities back in the input dtype for P.V."""
    B, Sq, H = q.shape
    D = H // num_heads

    def heads(t):
        return t.reshape(B, -1, num_heads, D).transpose(1, 2)

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)).float()
    probs = torch.softmax(scores / math.sqrt(D), dim=-1).to(q.dtype)
    return torch.matmul(probs, heads(v)).transpose(1, 2).reshape(B, Sq, H)


class SigLIPTextTower(nn.Module):
    def __init__(self, config: SigLIPTextConfig):
        super().__init__()
        H = config.hidden_size
        self.config = config
        self.token_embedding = nn.Parameter(torch.empty(config.vocab_size, H))
        self.position_embedding = nn.Parameter(
            torch.empty(config.context_length, H))
        self.layers = _blocks(config)
        self.final_ln = nn.LayerNorm(H)
        self.projection = nn.Linear(H, config.embed_dim)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S) int → (B, embed_dim) fp32 (unnormalized)."""
        config = self.config
        S = input_ids.shape[1]
        x = self.token_embedding[input_ids.long()] + \
            self.position_embedding[:S][None]
        attend = _VISION_ATTENTION[config.attention_impl]
        for layer in self.layers:
            x = layer(x, attend)
        x = layer_norm(x.float(), self.final_ln.weight, self.final_ln.bias,
                       config.layer_norm_eps)
        return F.linear(x[:, -1], self.projection.weight.float(),
                        self.projection.bias.float())


class LatentAttentionPool(nn.Module):
    """timm AttentionPoolLatent with one latent query: attention of the
    latent over the grid, the output projection, then ``o + MLP(LN(o))``.
    Plain torch (one query; the JAX package computes it in XLA)."""

    def __init__(self, config: SigLIPVisionConfig):
        super().__init__()
        H, I = config.hidden_size, config.intermediate_size
        self.config = config
        self.latent = nn.Parameter(torch.empty(1, H))
        self.q = nn.Linear(H, H)
        self.k = nn.Linear(H, H)
        self.v = nn.Linear(H, H)
        self.o = nn.Linear(H, H)
        self.norm = nn.LayerNorm(H)
        self.fc1 = nn.Linear(H, I)
        self.fc2 = nn.Linear(I, H)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        config = self.config
        B = x.shape[0]
        latent = self.latent.expand(B, 1, config.hidden_size)
        o = single_query_attention(self.q(latent), self.k(x), self.v(x),
                                   config.num_heads)
        o = self.o(o)
        h = layer_norm(o.float(), self.norm.weight, self.norm.bias,
                       config.layer_norm_eps).to(o.dtype)
        h = self.fc2(ACTIVATIONS[config.hidden_act](self.fc1(h)))
        return (o + h)[:, 0].float()


class SigLIPVisionTower(nn.Module):
    def __init__(self, config: SigLIPVisionConfig):
        super().__init__()
        H, p = config.hidden_size, config.patch_size
        self.config = config
        # (p*p*3, H) over patches laid out (p, p, 3)
        self.patch_embedding = nn.Parameter(torch.empty(p * p * 3, H))
        self.patch_bias = nn.Parameter(torch.empty(H))
        self.position_embedding = nn.Parameter(
            torch.empty(config.grid ** 2, H))
        self.layers = _blocks(config)
        self.final_ln = nn.LayerNorm(H)
        self.attn_pool = LatentAttentionPool(config)

    def forward(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """(B, size, size, 3) uint8 → (B, hidden_size) fp32
        (unnormalized)."""
        config = self.config
        B, n, p = pixels_u8.shape[0], config.grid, config.patch_size
        x = (pixels_u8.float() / 255.0 - SIGLIP_MEAN[0]) / SIGLIP_STD[0]
        # the stride-p conv's grid: drop the remainder of the image
        x = x[:, :n * p, :n * p]
        x = x.reshape(B, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(
            B, n * n, p * p * 3)
        weight = self.patch_embedding
        x = torch.matmul(x.to(weight.dtype), weight) + self.patch_bias
        x = x + self.position_embedding[None]
        attend = _VISION_ATTENTION[config.attention_impl]
        for layer in self.layers:
            x = layer(x, attend)
        x = layer_norm(x, self.final_ln.weight, self.final_ln.bias,
                       config.layer_norm_eps)
        return self.attn_pool(x)


class SigLIPEncoder(nn.Module):
    """Both towers; the module's dtype is the compute dtype."""

    def __init__(self, text_config: SigLIPTextConfig,
                 vision_config: SigLIPVisionConfig):
        super().__init__()
        self.text = SigLIPTextTower(text_config)
        self.vision = SigLIPVisionTower(vision_config)


def encode_siglip_text(model: SigLIPEncoder,
                       input_ids: torch.Tensor) -> torch.Tensor:
    """(B, context_length) int → (B, embed_dim) fp32 (unnormalized)."""
    return model.text(input_ids)


def encode_siglip_image(model: SigLIPEncoder,
                        pixels_u8: torch.Tensor) -> torch.Tensor:
    """(B, size, size, 3) uint8 → (B, hidden_size) fp32 (unnormalized)."""
    return model.vision(pixels_u8)


# --- init + conversion -------------------------------------------------------

def init_siglip_params(text_config: SigLIPTextConfig,
                       vision_config: SigLIPVisionConfig,
                       generator: torch.Generator, dtype=torch.float32,
                       device="cuda") -> SigLIPEncoder:
    """Random-init model (normal(0, 0.02) weights, embeddings and latent,
    zero biases, unit LayerNorm scales), drawn from ``generator`` on
    ``device``."""
    return random_init(empty_module(
        lambda: SigLIPEncoder(text_config, vision_config), dtype, device),
        generator)


def _timm_blocks(sd: dict, prefix: str, L: int) -> dict:
    """Stack L timm ViT blocks ({prefix}.{i}: norm1/norm2, attn.qkv fused,
    attn.proj, mlp.fc1/fc2) into the stacked layer layout (numpy
    float32)."""
    out = {k: [] for k in ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b",
                           "o_w", "o_b", "ln1_scale", "ln1_bias",
                           "ln2_scale", "ln2_bias", "mlp_w1", "mlp_b1",
                           "mlp_w2", "mlp_b2")}
    for i in range(L):
        base = f"{prefix}.{i}"
        qw, kw, vw = np.split(sd[f"{base}.attn.qkv.weight"], 3, axis=0)
        qb, kb, vb = np.split(sd[f"{base}.attn.qkv.bias"], 3, axis=0)
        for name, w, b in (("q", qw, qb), ("k", kw, kb), ("v", vw, vb)):
            out[f"{name}_w"].append(w.T)
            out[f"{name}_b"].append(b)
        out["o_w"].append(sd[f"{base}.attn.proj.weight"].T)
        out["o_b"].append(sd[f"{base}.attn.proj.bias"])
        out["ln1_scale"].append(sd[f"{base}.norm1.weight"])
        out["ln1_bias"].append(sd[f"{base}.norm1.bias"])
        out["mlp_w1"].append(sd[f"{base}.mlp.fc1.weight"].T)
        out["mlp_b1"].append(sd[f"{base}.mlp.fc1.bias"])
        out["mlp_w2"].append(sd[f"{base}.mlp.fc2.weight"].T)
        out["mlp_b2"].append(sd[f"{base}.mlp.fc2.bias"])
        out["ln2_scale"].append(sd[f"{base}.norm2.weight"])
        out["ln2_bias"].append(sd[f"{base}.norm2.bias"])
    return {k: _f32(np.stack(v)) for k, v in out.items()}


def params_from_open_clip_siglip(state_dict, text_config: SigLIPTextConfig,
                                 vision_config: SigLIPVisionConfig,
                                 vision_only: bool = False) -> dict:
    """Convert an open_clip SigLIP state dict (text.* open_clip naming;
    visual.trunk.* timm naming with the attn_pool head) into the JAX
    package's layout (numpy float32). ``vision_only`` skips the text half
    (NLLB-SigLIP pairs this trunk with an M2M-100 text tower,
    models/nllb_siglip.py) and returns None for it."""
    sd = _numpy_state_dict(state_dict)
    trunk = "visual.trunk"
    conv = sd[f"{trunk}.patch_embed.proj.weight"]  # (Hv, 3, p, p)
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0])
    pos = sd[f"{trunk}.pos_embed"]
    if pos.ndim == 3:  # timm stores (1, n, H)
        pos = pos[0]
    ap = f"{trunk}.attn_pool"
    kw, vw = np.split(sd[f"{ap}.kv.weight"], 2, axis=0)  # (2H, H)
    kb, vb = np.split(sd[f"{ap}.kv.bias"], 2, axis=0)
    latent = sd[f"{ap}.latent"]
    if latent.ndim == 3:  # (1, 1, H)
        latent = latent[0]
    text = None
    if not vision_only:
        text = {
            "token_embedding": _f32(sd["text.token_embedding.weight"]),
            "position_embedding": _f32(sd["text.positional_embedding"]),
            "layers": convert_open_clip_resblocks(
                sd, "text.transformer.resblocks", text_config.num_layers),
            "final_ln_scale": _f32(sd["text.ln_final.weight"]),
            "final_ln_bias": _f32(sd["text.ln_final.bias"]),
            # proj_bias=True: a Linear, weight stored (out, in)
            "proj_w": _f32(sd["text.text_projection.weight"].T),
            "proj_b": _f32(sd["text.text_projection.bias"]),
        }
    return {
        "text": text,
        "vision": {
            "patch_embedding": _f32(patch_w),
            "patch_bias": _f32(sd[f"{trunk}.patch_embed.proj.bias"]),
            "position_embedding": _f32(pos),
            "layers": _timm_blocks(sd, f"{trunk}.blocks",
                                   vision_config.num_layers),
            "final_ln_scale": _f32(sd[f"{trunk}.norm.weight"]),
            "final_ln_bias": _f32(sd[f"{trunk}.norm.bias"]),
            "attn_pool": {
                "latent": _f32(latent),
                "q_w": _f32(sd[f"{ap}.q.weight"].T),
                "q_b": _f32(sd[f"{ap}.q.bias"]),
                "k_w": _f32(kw.T), "k_b": _f32(kb),
                "v_w": _f32(vw.T), "v_b": _f32(vb),
                "o_w": _f32(sd[f"{ap}.proj.weight"].T),
                "o_b": _f32(sd[f"{ap}.proj.bias"]),
                "norm_scale": _f32(sd[f"{ap}.norm.weight"]),
                "norm_bias": _f32(sd[f"{ap}.norm.bias"]),
                "mlp_w1": _f32(sd[f"{ap}.mlp.fc1.weight"].T),
                "mlp_b1": _f32(sd[f"{ap}.mlp.fc1.bias"]),
                "mlp_w2": _f32(sd[f"{ap}.mlp.fc2.weight"].T),
                "mlp_b2": _f32(sd[f"{ap}.mlp.fc2.bias"]),
            },
        },
    }


def text_values(prefix: str, text: dict, L: int) -> dict:
    """The values of a ``SigLIPTextTower`` under ``prefix``, from the
    ``"text"`` part of the JAX package's layout (numpy arrays; weights
    (in, out) there, so they transpose)."""
    return {
        f"{prefix}token_embedding": text["token_embedding"],
        f"{prefix}position_embedding": text["position_embedding"],
        f"{prefix}final_ln.weight": text["final_ln_scale"],
        f"{prefix}final_ln.bias": text["final_ln_bias"],
        f"{prefix}projection.weight": np.asarray(text["proj_w"]).T,
        f"{prefix}projection.bias": text["proj_b"],
        **block_values(prefix, text, L),
    }


def vision_values(prefix: str, vision: dict, L: int) -> dict:
    """The values of a ``SigLIPVisionTower`` under ``prefix``, from the
    ``"vision"`` part of the JAX package's layout (numpy arrays)."""
    ap = vision["attn_pool"]
    values = {
        f"{prefix}patch_embedding": vision["patch_embedding"],
        f"{prefix}patch_bias": vision["patch_bias"],
        f"{prefix}position_embedding": vision["position_embedding"],
        f"{prefix}final_ln.weight": vision["final_ln_scale"],
        f"{prefix}final_ln.bias": vision["final_ln_bias"],
        f"{prefix}attn_pool.latent": ap["latent"],
        f"{prefix}attn_pool.norm.weight": ap["norm_scale"],
        f"{prefix}attn_pool.norm.bias": ap["norm_bias"],
        **block_values(prefix, vision, L),
    }
    for name, (w, b) in (("q", ("q_w", "q_b")), ("k", ("k_w", "k_b")),
                         ("v", ("v_w", "v_b")), ("o", ("o_w", "o_b")),
                         ("fc1", ("mlp_w1", "mlp_b1")),
                         ("fc2", ("mlp_w2", "mlp_b2"))):
        values[f"{prefix}attn_pool.{name}.weight"] = np.asarray(ap[w]).T
        values[f"{prefix}attn_pool.{name}.bias"] = ap[b]
    return values


def params_from_jax(params_numpy: dict, text_config: SigLIPTextConfig,
                    vision_config: SigLIPVisionConfig, dtype=torch.float32,
                    device="cuda") -> SigLIPEncoder:
    """A model holding parameters in the JAX package's layout, given as
    numpy arrays ({"text": {...}, "vision": {...}} with stacked layers):
    the JAX package's own params, or the converter's output above."""
    model = empty_module(lambda: SigLIPEncoder(text_config, vision_config),
                         dtype, device)
    return fill_parameters(model, {
        **text_values("text.", params_numpy["text"], text_config.num_layers),
        **vision_values("vision.", params_numpy["vision"],
                        vision_config.num_layers)})


# --- wrapper -----------------------------------------------------------------

_SIGLIP_ARCHS = {
    # registry arch token → (vision (w, L, heads, mlp, patch),
    #                        text (w, L, heads, mlp))
    "ViT-B-16-SigLIP": ((768, 12, 12, 3072, 16), (768, 12, 12, 3072)),
    "ViT-L-16-SigLIP": ((1024, 24, 16, 4096, 16), (1024, 24, 16, 4096)),
    "ViT-SO400M-14-SigLIP": ((1152, 27, 16, 4304, 14),
                             (1152, 27, 16, 4304)),
}


class TorchSigLIPModel:
    """SigLIP wrapper with text + image encode (reference JaxSigLIPModel).
    One device per model."""

    compute_dtype = torch.bfloat16

    def __init__(self, model_name: str, properties: dict, device: Device,
                 model_auth=None):
        self.model_name = model_name
        self.properties = dict(properties or {})
        self.device = device
        self.model_auth = model_auth
        self.loaded = False
        self.encoder: Optional[SigLIPEncoder] = None
        self.text_config: Optional[SigLIPTextConfig] = None
        self.vision_config: Optional[SigLIPVisionConfig] = None
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
        image_size = int(self.properties.get("image_size", 224))
        for token, (vis, txt) in _SIGLIP_ARCHS.items():
            if token in name:
                w, L, h, mlp, patch = vis
                tw, tL, th, tmlp = txt
                return (SigLIPTextConfig(hidden_size=tw, num_layers=tL,
                                         num_heads=th,
                                         intermediate_size=tmlp,
                                         embed_dim=w),
                        SigLIPVisionConfig(image_size=image_size,
                                           patch_size=patch, hidden_size=w,
                                           num_layers=L, num_heads=h,
                                           intermediate_size=mlp))
        return (SigLIPTextConfig(),
                SigLIPVisionConfig(image_size=image_size))

    def load(self) -> None:
        if self.properties.get("localpath"):
            self._load_from_checkpoint(self.properties["localpath"])
        elif self.properties.get("random_init"):
            self._load_random_init()
        else:
            raise ModelLoadError(
                f"SigLIP model `{self.model_name}` requires an open_clip "
                "checkpoint: provide model_properties.localpath or a "
                "model_location.")
        self._loaded()

    def _loaded(self) -> None:
        self.encoder = put_params(self, self.encoder)
        self.loaded = True
        self._param_bytes = sum(
            t.numel() * t.element_size()
            for t in (*self.encoder.parameters(), *self.encoder.buffers()))

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self._device).manual_seed(
            random_seed(self.model_name))

    def _load_from_checkpoint(self, path: str) -> None:
        self.text_config, self.vision_config = self._configs_for_name()
        params = params_from_open_clip_siglip(
            load_open_clip_state(path), self.text_config, self.vision_config)
        self.encoder = params_from_jax(params, self.text_config,
                                       self.vision_config,
                                       dtype=self.compute_dtype,
                                       device=self._device)
        self._init_tokenizer(checkpoint=path)

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        dims = int(self.properties.get("dimensions", 64))
        self.text_config = SigLIPTextConfig(
            vocab_size=int(arch.get("vocab_size", 1024)),
            hidden_size=dims,
            num_layers=int(arch.get("text_layers", 2)),
            num_heads=int(arch.get("text_heads", 2)),
            intermediate_size=int(arch.get("text_intermediate", 128)),
            context_length=int(arch.get("context_length", 64)),
            embed_dim=dims)
        self.vision_config = SigLIPVisionConfig(
            image_size=int(self.properties.get("image_size", 224)),
            patch_size=int(arch.get("patch_size", 32)),
            hidden_size=dims,
            num_layers=int(arch.get("vision_layers", 2)),
            num_heads=int(arch.get("vision_heads", 2)),
            intermediate_size=int(arch.get("vision_intermediate", 128)))
        self.encoder = init_siglip_params(
            self.text_config, self.vision_config, self._generator(),
            dtype=self.compute_dtype, device=self._device)
        self._init_tokenizer()

    def _init_tokenizer(self, checkpoint: str = None) -> None:
        from marqo_tpu_torch.models.tokenizer import resolve_model_tokenizer
        self.tokenizer = resolve_model_tokenizer(
            self.properties, max_length=self.text_config.context_length,
            checkpoint_path=checkpoint,
            allow_test=bool(self.properties.get("random_init")))

    def set_attention_impl(self, impl: str) -> None:
        """"kernel" (B2 on a CUDA device) or "plain" (its twin) for both
        towers."""
        for encoder in replicas(self):
            for tower in (encoder.text, encoder.vision):
                tower.config = replace(tower.config, attention_impl=impl)

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

    def _run(self, array: np.ndarray, tower: str,
             pad_value=0) -> np.ndarray:
        """The ``tower`` ("text" or "vision") of this model's encoder over
        ``array`` in batch buckets: on CUDA one graph per bucket (and per
        text length, NLLB-SigLIP's texts being padded to their batch's
        longest), under a serving mesh split across its data-parallel
        groups; one device-to-host copy."""
        return tower_encode(self, array, tower, pad_value)

    def _tokenize(self, texts: List[str]) -> np.ndarray:
        # SigLIP pools the LAST position: pad to the full context length
        batch = self.tokenizer.encode_batch(
            texts, pad_to=self.text_config.context_length)
        return (batch["input_ids"] % self.text_config.vocab_size).astype(
            np.int32)

    def _encode_text(self, texts: List[str]) -> np.ndarray:
        return self._run(self._tokenize(texts), "text")

    def _preprocess_host(self, content) -> np.ndarray:
        """SigLIP preprocessing: a square bicubic resize (no crop), in uint8
        on the host; mean and std 0.5 run on the device."""
        from PIL import Image

        from marqo_tpu_torch.ops.image_ops import host_decode
        size = self.vision_config.image_size
        image = Image.fromarray(host_decode(content)).resize(
            (size, size), Image.BICUBIC)
        return np.asarray(image, dtype=np.uint8)

    def _encode_images(self, contents: List[Any]) -> np.ndarray:
        pixels = np.stack([self._preprocess_host(c) for c in contents])
        return self._run(pixels, "vision")

    def memory_bytes(self) -> int:
        return self._param_bytes
