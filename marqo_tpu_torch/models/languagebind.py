"""LanguageBind-class multimodal model in PyTorch (port of
marqo_tpu/models/languagebind.py): text / image / audio / video towers
embedding into one space.

Parity: reference s2_inference/languagebind/ (~3,100 LoC vendored torch:
per-modality CLIP-ViT towers bound to one text encoder,
multimodal_model_load.py:52,204), built here from models/clip.py's blocks:

  - text:  CLIP text transformer (causal, plain torch)
  - image: CLIP ViT
  - audio: ViT over log-mel spectrograms (ops/audio_ops.py) —
    CLAP/LanguageBind-audio shape
  - video: the LanguageBind video tower (temporal attention over the frames
    in every layer) when converted video weights are loaded; otherwise the
    mean of the frames' image embeddings

Every unmasked self-attention of the image, audio and video towers (the
video tower's temporal attention over T frames too) runs
ops/fused_attention.py's no-mask mode: CUDA kernel B2 on a CUDA device, its
plain twin on the CPU (``attention_impl="plain"`` selects the twin). The
JAX package scales q.k in the compute dtype before its fp32 softmax; B2
computes the scores in fp32 (ROADMAP §C). The module's dtype is the compute
dtype; LayerNorm statistics and the projections run in fp32.

The JAX package compiles each tower once per batch shape
(``encode_clip_text_jit``, ``encode_clip_image_jit``,
``encode_audio_tower_jit``, ``encode_video_tower_jit``); on CUDA the wrapper
replays one CUDA graph per (tower, dtype, config, batch shape), captured at
its first use (inference/graphs.py), on its one device with or without a
serving mesh.

Real LanguageBind checkpoints require hub access; offline deployments use
random-init (tests) or local converted checkpoints (``localpaths``).
"""

from dataclasses import dataclass, replace
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.core.exceptions import ModelLoadError, VectoriseError
from marqo_tpu_torch.inference import batching
from marqo_tpu_torch.inference.graphs import EncoderGraphs
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.models.clip import (_VISION_ATTENTION, CLIPTextConfig,
                                         CLIPTextTower, CLIPVisionConfig,
                                         CLIPVisionTower, _blocks, _f32,
                                         _pixel_stats, _vision_values,
                                         block_values, params_from_hf_clip,
                                         random_seed, text_values)
from marqo_tpu_torch.ops.audio_ops import (N_MELS, load_wav,
                                           log_mel_spectrogram,
                                           mel_filterbank)
from marqo_tpu_torch.ops.common import layer_norm


@dataclass(frozen=True)
class AudioTowerConfig:
    n_mels: int = N_MELS
    n_frames: int = 1000  # 10 s at 10 ms hop
    patch_size: int = 16
    # LanguageBind audio checkpoints patch 3-channel spectrograms
    channels: int = 1
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    # "kernel": ops/fused_attention.py (CUDA kernel B2 on a CUDA device,
    # plain twin on the CPU); "plain": always the plain twin
    attention_impl: str = "kernel"

    @property
    def n_tokens(self) -> int:
        return (self.n_mels // self.patch_size) * \
            (self.n_frames // self.patch_size)


@dataclass(frozen=True)
class VideoTowerConfig:
    """LanguageBind video tower (reference languagebind/video/
    modeling_video.py): a CLIP ViT whose every encoder layer first runs
    TEMPORAL attention — tokens reshaped (B·T, N, D) → (B·N, T, D), a
    per-layer temporal position embedding added, a dedicated pre-LN
    attention over the frame axis, residual — then the standard spatial
    CLIP block. Pooled output is the per-frame CLS after post-LN, meaned
    over frames (modeling_video.py:768-771)."""
    image_size: int = 224
    patch_size: int = 14      # LanguageBind_Video is ViT-L/14
    num_frames: int = 8
    add_time_attn: bool = True
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    attention_impl: str = "kernel"


# --- towers ------------------------------------------------------------------

class TemporalBlock(nn.Module):
    """One layer's temporal attention (modeling_video.py:170-190): the
    per-layer temporal embedding, a pre-LN attention over the frames, the
    residual."""

    def __init__(self, config: VideoTowerConfig):
        super().__init__()
        H = config.hidden_size
        self.num_heads, self.eps = config.num_heads, config.layer_norm_eps
        self.embedding = nn.Parameter(torch.empty(config.num_frames, H))
        self.ln = nn.LayerNorm(H)
        self.q = nn.Linear(H, H)
        self.k = nn.Linear(H, H)
        self.v = nn.Linear(H, H)
        self.o = nn.Linear(H, H)

    def forward(self, x: torch.Tensor, attend) -> torch.Tensor:
        """x: (B·N, T, H) → (B·N, T, H)."""
        BN, T, H = x.shape
        N = self.num_heads
        x = x + self.embedding[:T][None]
        h = layer_norm(x, self.ln.weight, self.ln.bias, self.eps)

        def heads(t):
            return t.view(BN, T, N, H // N).transpose(1, 2)

        ctx = attend(heads(self.q(h)), heads(self.k(h)), heads(self.v(h)))
        return x + self.o(ctx.transpose(1, 2).reshape(BN, T, H))


class VideoTower(nn.Module):
    def __init__(self, config: VideoTowerConfig):
        super().__init__()
        H, p = config.hidden_size, config.patch_size
        n_patches = (config.image_size // p) ** 2
        self.config = config
        self.patch_embedding = nn.Parameter(torch.empty(p * p * 3, H))
        self.class_embedding = nn.Parameter(torch.empty(H))
        self.position_embedding = nn.Parameter(torch.empty(n_patches + 1, H))
        self.pre_ln = nn.LayerNorm(H)
        self.layers = _blocks(config)
        self.temporal = nn.ModuleList(
            TemporalBlock(config) for _ in range(config.num_layers)
        ) if config.add_time_attn else None
        self.post_ln = nn.LayerNorm(H)
        self.projection = nn.Parameter(torch.empty(H, config.projection_dim))

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """(B, T, size, size, 3) uint8 → (B, projection_dim) fp32."""
        config = self.config
        B, T = frames_u8.shape[:2]
        n, p = config.image_size // config.patch_size, config.patch_size
        H = config.hidden_size
        mean, std = _pixel_stats(frames_u8.device)
        x = (frames_u8.float() / 255.0 - mean) / std
        x = x.reshape(B * T, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(
            B * T, n * n, p * p * 3)
        weight = self.patch_embedding
        x = torch.matmul(x.to(weight.dtype), weight)
        cls = self.class_embedding.expand(B * T, 1, H)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        x = layer_norm(x, self.pre_ln.weight, self.pre_ln.bias,
                       config.layer_norm_eps)
        N = x.shape[1]
        attend = _VISION_ATTENTION[config.attention_impl]
        for i, layer in enumerate(self.layers):
            if self.temporal is not None:
                # (B·T, N, H) → (B·N, T, H): attend across frames per token
                ht = x.view(B, T, N, H).transpose(1, 2).reshape(B * N, T, H)
                ht = self.temporal[i](ht, attend)
                x = ht.view(B, N, T, H).transpose(1, 2).reshape(B * T, N, H)
            x = layer(x, attend)
        pooled = layer_norm(x[:, 0], self.post_ln.weight, self.post_ln.bias,
                            config.layer_norm_eps).float()
        pooled = pooled.view(B, T, H).mean(dim=1)
        return pooled @ self.projection.float()


class AudioTower(nn.Module):
    def __init__(self, config: AudioTowerConfig):
        super().__init__()
        H, p = config.hidden_size, config.patch_size
        self.config = config
        self.patch_embedding = nn.Parameter(
            torch.empty(p * p * config.channels, H))
        self.class_embedding = nn.Parameter(torch.empty(H))
        self.position_embedding = nn.Parameter(
            torch.empty(config.n_tokens + 1, H))
        self.layers = _blocks(config)
        self.post_ln = nn.LayerNorm(H)
        self.projection = nn.Parameter(torch.empty(H, config.projection_dim))

    def forward(self, logmels: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, n_frames) log-mel → (B, projection_dim) fp32. With
        ``channels=3`` (LanguageBind audio checkpoints treat the spectrogram
        as a 3-channel image) the mel map is repeated across channels."""
        config = self.config
        B, p = logmels.shape[0], config.patch_size
        gm, gf = config.n_mels // p, config.n_frames // p
        x = logmels[:, :gm * p, :gf * p]
        x = x.reshape(B, gm, p, gf, p).permute(0, 1, 3, 2, 4).reshape(
            B, gm * gf, p * p)
        if config.channels == 3:
            x = x.reshape(B, gm * gf, p * p, 1).expand(
                B, gm * gf, p * p, 3).reshape(B, gm * gf, p * p * 3)
        weight = self.patch_embedding
        x = torch.matmul(x.to(weight.dtype), weight)
        cls = self.class_embedding.expand(B, 1, config.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        attend = _VISION_ATTENTION[config.attention_impl]
        for layer in self.layers:
            x = layer(x, attend)
        pooled = layer_norm(x[:, 0], self.post_ln.weight, self.post_ln.bias,
                            config.layer_norm_eps).float()
        return pooled @ self.projection.float()


def encode_video_tower(tower: VideoTower,
                       frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, T, size, size, 3) uint8 → (B, projection_dim) fp32."""
    return tower(frames_u8)


def encode_audio_tower(tower: AudioTower,
                       logmels: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, n_frames) log-mel → (B, projection_dim) fp32."""
    return tower(logmels)


# --- init + conversion -------------------------------------------------------

def init_video_tower(config: VideoTowerConfig, generator: torch.Generator,
                     dtype=torch.float32, device="cuda") -> VideoTower:
    """Random-init video tower (normal(0, 0.02) weights and embeddings,
    zero biases, unit LayerNorm scales), drawn from ``generator``."""
    return random_init(empty_module(lambda: VideoTower(config), dtype,
                                    device), generator)


def init_audio_tower(config: AudioTowerConfig, generator: torch.Generator,
                     dtype=torch.float32, device="cuda") -> AudioTower:
    """Random-init audio tower, as ``init_video_tower``."""
    return random_init(empty_module(lambda: AudioTower(config), dtype,
                                    device), generator)


def params_from_languagebind_video(state_dict,
                                   config: VideoTowerConfig) -> dict:
    """Convert a LanguageBindVideo state dict (HF CLIP vision naming plus
    per-layer `temporal_attn`/`temporal_layer_norm1`/`temporal_embedding`,
    reference modeling_video.py:170-190) into the JAX package's video-tower
    layout (numpy float32)."""
    sd = {}
    for key, value in state_dict.items():
        for prefix in ("vision_model.", "model.vision_model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        sd[key] = (value.detach().cpu().float().numpy()
                   if torch.is_tensor(value) else np.asarray(value))
    L, H = config.num_layers, config.hidden_size

    conv = sd["embeddings.patch_embedding.weight"]
    if conv.ndim == 5:  # 3D tube conv (tube_size 1): (H, 3, 1, p, p)
        conv = conv[:, :, 0]
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, H)

    def stack(fmt, transpose=False):
        arrs = []
        for i in range(L):
            a = sd[fmt.format(i=i)]
            arrs.append(a.T if transpose else a)
        return _f32(np.stack(arrs))

    p = "encoder.layers.{i}."
    layers = {
        "q_w": stack(p + "self_attn.q_proj.weight", True),
        "q_b": stack(p + "self_attn.q_proj.bias"),
        "k_w": stack(p + "self_attn.k_proj.weight", True),
        "k_b": stack(p + "self_attn.k_proj.bias"),
        "v_w": stack(p + "self_attn.v_proj.weight", True),
        "v_b": stack(p + "self_attn.v_proj.bias"),
        "o_w": stack(p + "self_attn.out_proj.weight", True),
        "o_b": stack(p + "self_attn.out_proj.bias"),
        "ln1_scale": stack(p + "layer_norm1.weight"),
        "ln1_bias": stack(p + "layer_norm1.bias"),
        "mlp_w1": stack(p + "mlp.fc1.weight", True),
        "mlp_b1": stack(p + "mlp.fc1.bias"),
        "mlp_w2": stack(p + "mlp.fc2.weight", True),
        "mlp_b2": stack(p + "mlp.fc2.bias"),
        "ln2_scale": stack(p + "layer_norm2.weight"),
        "ln2_bias": stack(p + "layer_norm2.bias"),
    }
    projection = state_dict["visual_projection.weight"]
    projection = (projection.detach().cpu().float().numpy()
                  if torch.is_tensor(projection) else np.asarray(projection))
    params = {
        "patch_embedding": _f32(patch_w),
        "class_embedding": _f32(
            sd["embeddings.class_embedding"].reshape(-1)[:H]),
        "position_embedding": _f32(
            sd["embeddings.position_embedding.weight"]),
        "pre_ln_scale": _f32(sd.get("pre_layrnorm.weight",
                                    sd.get("pre_layernorm.weight"))),
        "pre_ln_bias": _f32(sd.get("pre_layrnorm.bias",
                                   sd.get("pre_layernorm.bias"))),
        "layers": layers,
        "post_ln_scale": _f32(sd["post_layernorm.weight"]),
        "post_ln_bias": _f32(sd["post_layernorm.bias"]),
        "projection": _f32(projection.T),
    }
    if config.add_time_attn:
        params["temporal"] = {
            "embedding": stack(p + "temporal_embedding")[:, 0],
            "q_w": stack(p + "temporal_attn.q_proj.weight", True),
            "q_b": stack(p + "temporal_attn.q_proj.bias"),
            "k_w": stack(p + "temporal_attn.k_proj.weight", True),
            "k_b": stack(p + "temporal_attn.k_proj.bias"),
            "v_w": stack(p + "temporal_attn.v_proj.weight", True),
            "v_b": stack(p + "temporal_attn.v_proj.bias"),
            "o_w": stack(p + "temporal_attn.out_proj.weight", True),
            "o_b": stack(p + "temporal_attn.out_proj.bias"),
            "ln_scale": stack(p + "temporal_layer_norm1.weight"),
            "ln_bias": stack(p + "temporal_layer_norm1.bias"),
        }
    return params


def _tower_values(prefix: str, tree: dict, L: int) -> dict:
    """The values an audio or video tower shares, from its part of the JAX
    package's layout (numpy arrays)."""
    values = {
        f"{prefix}patch_embedding": tree["patch_embedding"],
        f"{prefix}class_embedding": tree["class_embedding"],
        f"{prefix}position_embedding": tree["position_embedding"],
        f"{prefix}post_ln.weight": tree["post_ln_scale"],
        f"{prefix}post_ln.bias": tree["post_ln_bias"],
        f"{prefix}projection": tree["projection"],
        **block_values(prefix, tree, L),
    }
    if "pre_ln_scale" in tree:
        values[f"{prefix}pre_ln.weight"] = tree["pre_ln_scale"]
        values[f"{prefix}pre_ln.bias"] = tree["pre_ln_bias"]
    if "temporal" in tree:
        tp = tree["temporal"]
        for i in range(L):
            base = f"{prefix}temporal.{i}"
            values[f"{base}.embedding"] = tp["embedding"][i]
            values[f"{base}.ln.weight"] = tp["ln_scale"][i]
            values[f"{base}.ln.bias"] = tp["ln_bias"][i]
            for name in ("q", "k", "v", "o"):
                values[f"{base}.{name}.weight"] = np.asarray(
                    tp[f"{name}_w"][i]).T
                values[f"{base}.{name}.bias"] = tp[f"{name}_b"][i]
    return values


def video_tower_from_jax(params_numpy: dict, config: VideoTowerConfig,
                         dtype=torch.float32, device="cuda") -> VideoTower:
    """A video tower holding parameters in the JAX package's layout (numpy
    arrays): ``init_video_tower``'s pytree there, or the converter's output
    above."""
    tower = empty_module(lambda: VideoTower(config), dtype, device)
    return fill_parameters(tower, _tower_values("", params_numpy,
                                                config.num_layers))


def audio_tower_from_jax(params_numpy: dict, config: AudioTowerConfig,
                         dtype=torch.float32, device="cuda") -> AudioTower:
    """An audio tower holding parameters in the JAX package's layout."""
    tower = empty_module(lambda: AudioTower(config), dtype, device)
    return fill_parameters(tower, _tower_values("", params_numpy,
                                                config.num_layers))


class LanguageBindEncoder(nn.Module):
    """The towers this model has (None where a modality has none); the
    module's dtype is the compute dtype."""

    def __init__(self, text=None, vision=None, audio=None, video=None):
        super().__init__()
        self.text, self.vision, self.audio, self.video = \
            text, vision, audio, video


def params_from_jax(params_numpy: dict, text_config: CLIPTextConfig,
                    vision_config: Optional[CLIPVisionConfig] = None,
                    audio_config: Optional[AudioTowerConfig] = None,
                    video_config: Optional[VideoTowerConfig] = None,
                    dtype=torch.float32,
                    device="cuda") -> LanguageBindEncoder:
    """The towers held in the JAX package's layout ({"text", "vision",
    "audio", "video"}, each optional), given as numpy arrays."""
    towers = {}
    if "text" in params_numpy:
        towers["text"] = fill_parameters(
            empty_module(lambda: CLIPTextTower(text_config), dtype, device),
            text_values("", params_numpy["text"], text_config.num_layers))
    if "vision" in params_numpy:
        vision = params_numpy["vision"]
        towers["vision"] = fill_parameters(
            empty_module(lambda: CLIPVisionTower(
                vision_config, pre_ln="pre_ln_scale" in vision), dtype,
                device),
            _vision_values("", vision, vision_config.num_layers))
    if "audio" in params_numpy:
        towers["audio"] = audio_tower_from_jax(
            params_numpy["audio"], audio_config, dtype, device)
    if "video" in params_numpy:
        towers["video"] = video_tower_from_jax(
            params_numpy["video"], video_config, dtype, device)
    return LanguageBindEncoder(**towers)


# --- wrapper -----------------------------------------------------------------

# the graphs' tower names → LanguageBindEncoder's attributes
TOWERS = {"text": "text", "image": "vision", "audio": "audio",
          "video": "video"}


class TorchLanguageBindModel:
    """Multi-tower wrapper (loader type ``languagebind``; reference
    JaxLanguageBindModel). One device per model."""

    compute_dtype = torch.bfloat16

    def __init__(self, model_name: str, properties: dict, device: Device,
                 model_auth=None):
        self.model_name = model_name
        self.properties = dict(properties or {})
        self.device = device
        self.model_auth = model_auth
        self.loaded = False
        self.supported = set(self.properties.get(
            "supported_modalities",
            ["language", "image", "audio", "video"]))
        self.encoder: Optional[LanguageBindEncoder] = None
        self.text_config: Optional[CLIPTextConfig] = None
        self.vision_config: Optional[CLIPVisionConfig] = None
        self.audio_config: Optional[AudioTowerConfig] = None
        self.video_config: Optional[VideoTowerConfig] = None
        self.tokenizer = None
        self._hf_tokenizer = False
        self._mel_fb = None
        self._device = torch.device(
            "cuda" if device == Device.CUDA else "cpu")
        self._param_bytes = 0
        self.graphs = EncoderGraphs(self._device)
        # each tower name's module when its graphs were captured
        self._captured = {}

    @property
    def dimensions(self) -> int:
        return int(self.properties.get("dimensions", 768))

    def load(self) -> None:
        if self.properties.get("localpaths"):
            self._load_from_checkpoints(self.properties["localpaths"])
        elif not self.properties.get("random_init"):
            raise ModelLoadError(
                f"LanguageBind checkpoints for `{self.model_name}` require "
                f"HF hub access, unavailable in this deployment. Provide "
                f"model_properties.localpaths "
                f"({{'image'|'video'|'audio': checkpoint dir}}) or "
                f"random_init for synthetic-weight mode.")
        else:
            self._load_random_init()
        self.loaded = True
        self._param_bytes = sum(t.numel() * t.element_size()
                                for t in self.encoder.parameters())

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        proj = self.dimensions
        hidden = int(arch.get("hidden_size", 64))
        layers = int(arch.get("num_layers", 2))
        heads = int(arch.get("num_heads", 2))
        inter = int(arch.get("intermediate_size", 128))
        self.text_config = CLIPTextConfig(
            vocab_size=int(arch.get("vocab_size", 1024)),
            hidden_size=hidden, num_layers=layers, num_heads=heads,
            intermediate_size=inter, projection_dim=proj,
            eos_token_id=int(arch.get("vocab_size", 1024)) - 1)
        self.vision_config = CLIPVisionConfig(
            image_size=int(self.properties.get("image_size", 224)),
            patch_size=int(arch.get("patch_size", 32)),
            hidden_size=hidden, num_layers=layers, num_heads=heads,
            intermediate_size=inter, projection_dim=proj)
        self.audio_config = AudioTowerConfig(
            n_frames=int(arch.get("audio_frames", 992)),
            patch_size=int(arch.get("audio_patch", 16)),
            hidden_size=hidden, num_layers=layers, num_heads=heads,
            intermediate_size=inter, projection_dim=proj)
        generator = torch.Generator(device=self._device).manual_seed(
            random_seed(self.model_name))
        text_config, vision_config, audio_config = \
            self.text_config, self.vision_config, self.audio_config
        self.encoder = random_init(empty_module(
            lambda: LanguageBindEncoder(
                text=CLIPTextTower(text_config),
                vision=CLIPVisionTower(vision_config),
                audio=AudioTower(audio_config)),
            self.compute_dtype, self._device), generator)
        self._mel_fb = torch.from_numpy(mel_filterbank()).to(self._device)
        from marqo_tpu_torch.models.tokenizer import TextTokenizer
        self.tokenizer = TextTokenizer.build_test_wordpiece(
            max_length=self.text_config.max_positions)

    def _load_from_checkpoints(self, localpaths: dict) -> None:
        """Load converted LanguageBind per-modality checkpoints (each dir is
        one vendored-model HF checkpoint: LanguageBind_Image / _Video /
        _Audio — reference multimodal_model_load.py loads the same set).
        The text tower ships inside every modality checkpoint; the first
        one provided supplies it. The same walk as the JAX package's, into
        its layout, then the towers from it."""
        from transformers import AutoConfig

        from marqo_tpu_torch.inference.loaders import _load_state_dict
        proj = self.dimensions
        params = {}
        text_loaded = False
        for modality, path in localpaths.items():
            hf_cfg = AutoConfig.from_pretrained(path)
            vision_cfg = getattr(hf_cfg, "vision_config", hf_cfg)
            text_cfg = getattr(hf_cfg, "text_config", None)
            state = _load_state_dict(path)
            if modality == "video":
                self.video_config = VideoTowerConfig(
                    image_size=vision_cfg.image_size,
                    patch_size=vision_cfg.patch_size,
                    num_frames=getattr(vision_cfg, "num_frames", 8),
                    add_time_attn=getattr(vision_cfg, "add_time_attn", True),
                    hidden_size=vision_cfg.hidden_size,
                    num_layers=vision_cfg.num_hidden_layers,
                    num_heads=vision_cfg.num_attention_heads,
                    intermediate_size=vision_cfg.intermediate_size,
                    projection_dim=proj)
                params["video"] = params_from_languagebind_video(
                    state, self.video_config)
            elif modality == "audio":
                mels = int(getattr(vision_cfg, "num_mel_bins", 112) or 112)
                frames = int(getattr(vision_cfg, "target_length", 1008)
                             or 1008)
                self.audio_config = AudioTowerConfig(
                    n_mels=mels, n_frames=frames,
                    patch_size=vision_cfg.patch_size, channels=3,
                    hidden_size=vision_cfg.hidden_size,
                    num_layers=vision_cfg.num_hidden_layers,
                    num_heads=vision_cfg.num_attention_heads,
                    intermediate_size=vision_cfg.intermediate_size,
                    projection_dim=proj)
                # audio ckpt = CLIP-vision naming over spectrogram "images"
                audio_cfg = VideoTowerConfig(
                    image_size=vision_cfg.image_size,
                    patch_size=vision_cfg.patch_size, add_time_attn=False,
                    hidden_size=vision_cfg.hidden_size,
                    num_layers=vision_cfg.num_hidden_layers,
                    num_heads=vision_cfg.num_attention_heads,
                    intermediate_size=vision_cfg.intermediate_size,
                    projection_dim=proj)
                converted = params_from_languagebind_video(state, audio_cfg)
                converted.pop("pre_ln_scale", None)
                converted.pop("pre_ln_bias", None)
                params["audio"] = converted
            else:  # image (plain CLIP tower)
                self.vision_config = CLIPVisionConfig(
                    image_size=vision_cfg.image_size,
                    patch_size=vision_cfg.patch_size,
                    hidden_size=vision_cfg.hidden_size,
                    num_layers=vision_cfg.num_hidden_layers,
                    num_heads=vision_cfg.num_attention_heads,
                    intermediate_size=vision_cfg.intermediate_size,
                    projection_dim=proj)
            if text_cfg is not None and not text_loaded:
                self.text_config = CLIPTextConfig(
                    vocab_size=text_cfg.vocab_size,
                    hidden_size=text_cfg.hidden_size,
                    num_layers=text_cfg.num_hidden_layers,
                    num_heads=text_cfg.num_attention_heads,
                    intermediate_size=text_cfg.intermediate_size,
                    max_positions=text_cfg.max_position_embeddings,
                    projection_dim=proj,
                    eos_token_id=text_cfg.eos_token_id)
                vc = self.vision_config or CLIPVisionConfig(
                    image_size=vision_cfg.image_size,
                    patch_size=vision_cfg.patch_size,
                    hidden_size=vision_cfg.hidden_size,
                    num_layers=vision_cfg.num_hidden_layers,
                    num_heads=vision_cfg.num_attention_heads,
                    intermediate_size=vision_cfg.intermediate_size,
                    projection_dim=proj)
                if modality == "image":
                    both = params_from_hf_clip(state, self.text_config, vc)
                    params["text"] = both["text"]
                    params["vision"] = both["vision"]
                else:  # text tower only from an a/v checkpoint
                    both = params_from_hf_clip(
                        {k: v for k, v in state.items()
                         if k.startswith(("text_model.", "text_projection.",
                                          # the converter's vision keys,
                                          # from the checkpoint's own tower
                                          "vision_model.",
                                          "visual_projection."))},
                        self.text_config, vc)
                    params["text"] = both["text"]
                text_loaded = True
        self.encoder = params_from_jax(
            params, self.text_config, self.vision_config, self.audio_config,
            self.video_config, dtype=self.compute_dtype, device=self._device)
        first = next(iter(localpaths.values()))
        try:
            from transformers import CLIPTokenizerFast
            self.tokenizer = CLIPTokenizerFast.from_pretrained(first)
            self._hf_tokenizer = True
        except Exception as e:
            from marqo_tpu_torch.logging import get_logger
            get_logger(__name__).warning(
                f"Checkpoint dir has no usable tokenizer assets ({e}); "
                "falling back to the built-in wordpiece — text embeddings "
                "will NOT match the original checkpoint's tokenizer")
            from marqo_tpu_torch.models.tokenizer import TextTokenizer
            self.tokenizer = TextTokenizer.build_test_wordpiece(
                max_length=self.text_config.max_positions)
            self._hf_tokenizer = False
        self._mel_fb = torch.from_numpy(mel_filterbank(n_mels=(
            self.audio_config or AudioTowerConfig()).n_mels)).to(self._device)

    def set_attention_impl(self, impl: str) -> None:
        """"kernel" (B2 on a CUDA device) or "plain" (its twin) for the
        image, audio and video towers (the text tower is causal, in plain
        torch)."""
        for tower in (self.encoder.vision, self.encoder.audio,
                      self.encoder.video):
            if tower is not None:
                tower.config = replace(tower.config, attention_impl=impl)

    # -- encoding -----------------------------------------------------------

    def encode(self, contents: List[Any], normalize: bool = True,
               modality: Modality = Modality.TEXT) -> np.ndarray:
        if modality == Modality.TEXT:
            out = self._encode_text([str(c) for c in contents])
        elif modality == Modality.IMAGE and "image" in self.supported:
            out = self._encode_images(contents)
        elif modality == Modality.AUDIO and "audio" in self.supported:
            out = self._encode_audio(contents)
        elif modality == Modality.VIDEO and "video" in self.supported:
            out = self._encode_video(contents)
        else:
            raise VectoriseError(
                f"Model `{self.model_name}` does not support modality "
                f"{modality.value}")
        if normalize:
            out = out / np.maximum(
                np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
        return out.astype(np.float32)

    def _run(self, name: str, array: np.ndarray) -> np.ndarray:
        """The tower ``name`` ("text", "image", "audio" or "video") over
        the whole batch on this model's device: on CUDA the replay of this
        model's graph of (tower, dtype, the tower's config, the batch's
        shape), captured at the key's first use; on the CPU the eager
        forward. The model stays on that device under a serving mesh: the
        JAX package feeds every tower from the model's one device
        (marqo_tpu/models/languagebind.py ``_encode_text`` and the other
        modalities), so a replica elsewhere would compute nothing."""
        tower = getattr(self.encoder, TOWERS[name])
        graphs = batching.card_graphs(self.graphs)
        if graphs is None:
            with torch.inference_mode():
                return tower(torch.from_numpy(array).to(self._device)
                             ).cpu().numpy()
        if self._captured.get(name) is not tower:
            # a tower assigned anew: its name's graphs replay the old
            # module's weights through the capture's pointers
            graphs.forget(name)
            self._captured[name] = tower
        out = graphs.run(name, self.compute_dtype, tower, array,
                         static=(tower.config,))
        with torch.inference_mode():
            return out.cpu().numpy()

    def _encode_text(self, texts: List[str]) -> np.ndarray:
        return self._run("text", self._tokenize(texts))

    def _tokenize(self, texts: List[str]) -> np.ndarray:
        """(B, max_positions) int32 ids, each text ending at the EOS the
        text tower pools at."""
        max_len = self.text_config.max_positions
        if self._hf_tokenizer:
            enc = self.tokenizer(texts, padding="max_length", truncation=True,
                                 max_length=max_len, return_tensors="np")
            ids = enc["input_ids"].astype(np.int32)
        else:
            batch = self.tokenizer.encode_batch(texts, pad_to=max_len)
            ids = (batch["input_ids"] %
                   self.text_config.vocab_size).astype(np.int32)
            for i, L in enumerate(batch["lengths"]):
                ids[i, min(L, max_len) - 1] = self.text_config.eos_token_id
        return ids

    @staticmethod
    def _square(array: np.ndarray, size: int) -> np.ndarray:
        """A square bicubic resize with no crop, in uint8 on the host."""
        from PIL import Image
        image = Image.fromarray(array).resize((size, size), Image.BICUBIC)
        return np.asarray(image, dtype=np.uint8)

    def _encode_images(self, contents: List[Any]) -> np.ndarray:
        from marqo_tpu_torch.ops.image_ops import host_decode
        size = self.vision_config.image_size
        return self._run("image", np.stack(
            [self._square(host_decode(c), size) for c in contents]))

    def _prep_audio(self, content) -> np.ndarray:
        """content: waveform ndarray / wav bytes / path → (mels, frames)."""
        if isinstance(content, np.ndarray) and content.ndim == 1:
            wav = content.astype(np.float32)
        elif isinstance(content, (str, bytes)):
            wav = load_wav(content)
        else:
            raise VectoriseError(
                f"Unsupported audio content type {type(content)}")
        with torch.inference_mode():
            logmel = log_mel_spectrogram(
                torch.from_numpy(wav).to(self._device), self._mel_fb,
                self.audio_config.n_frames)
            return logmel.cpu().numpy()

    def _encode_audio(self, contents: List[Any]) -> np.ndarray:
        mels = np.stack([self._prep_audio(c) for c in contents])
        return self._run("audio", mels)

    def _encode_video(self, contents: List[Any]) -> np.ndarray:
        """Video embedding. With converted LanguageBind weights the
        temporal-attention tower runs, one video per call (B·257 rows of
        temporal attention stay far inside B2's batch limit); the
        random-init multi-tower fallback means frame embeddings (close
        ordering, no temporal weights to honor)."""
        use_tower = self.encoder.video is not None
        outs = []
        for frames in contents:
            if isinstance(frames, np.ndarray) and frames.ndim == 3:
                frames = [frames]
            if not isinstance(frames, (list, tuple)) or not frames:
                raise VectoriseError(
                    "Video content must be a non-empty list of frames")
            if use_tower:
                size = self.video_config.image_size
                T = self.video_config.num_frames
                frames = list(frames)[:T]
                while len(frames) < T:  # pad by repeating the last frame
                    frames.append(frames[-1])
                pixels = np.stack([self._square(np.asarray(f), size)
                                   for f in frames])
                outs.append(self._run("video", pixels[None])[0])
            else:
                frame_embs = self._encode_images(list(frames))
                outs.append(frame_embs.mean(axis=0))
        return np.stack(outs)

    def memory_bytes(self) -> int:
        return self._param_bytes
