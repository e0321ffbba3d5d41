"""ResNet-CLIP (openai RN50/RN101/RN50x4/x16/x64) in PyTorch (port of
marqo_tpu/models/resnet_clip.py).

The vision tower is openai CLIP's "ModifiedResNet": a stem of three 3x3
convs then a 2x2 avgpool; bottleneck stages whose stride-2 path is an
avgpool BEFORE the 1x1 conv3 (anti-aliased downsampling), with the identity
branch avgpooled in fp32 before its 1x1 conv; and a 2-D attention pool
whose single query is the mean token prepended to the grid. The text tower
is the CLIP text transformer of models/clip.py (quick_gelu).

The tower runs NCHW with torch's conv weights (O, I, kh, kw); the JAX
package runs NHWC with HWIO weights, and ``params_from_jax`` turns those
into OIHW. Each conv runs in the compute dtype; its output goes to fp32 for
the inference-form BatchNorm (running statistics), and activations between
convs stay fp32, as in the JAX package. The attention pool runs entirely in
fp32, in plain torch (one query; the JAX package computes it in XLA).
Convolutions go to ``F.conv2d``, as the JAX package leaves them to XLA: no
kernel of this package runs in this tower.
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from marqo_tpu_torch.core.exceptions import ModelLoadError
from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextTower,
                                         TorchCLIPModel, _f32,
                                         _numpy_state_dict, _pixel_stats,
                                         load_open_clip_state, open_clip_text,
                                         random_seed, text_values)
from marqo_tpu_torch.parallel.serving import put_params


@dataclass(frozen=True)
class ResNetVisionConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)   # RN50
    width: int = 64
    image_size: int = 224
    output_dim: int = 1024
    heads: int = 32                          # attnpool heads = embed // 64
    bn_eps: float = 1e-5


# --- modules -----------------------------------------------------------------

def conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    """A bias-free conv in the weight's dtype (the compute dtype)."""
    return F.conv2d(x.to(weight.dtype), weight, stride=stride,
                    padding=padding)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm: running statistics, the result in fp32. The
    scale ``weight / sqrt(var + eps)`` is computed in the module's dtype
    and then widened, as the JAX package computes it from its params."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.mean = nn.Parameter(torch.empty(channels))
        self.var = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        scale = (self.weight / torch.sqrt(self.var + eps)).float()
        shift = self.bias - self.mean.float() * scale
        return x.float() * scale[:, None, None] + shift[:, None, None]


def _conv_weight(cout: int, cin: int, k: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(cout, cin, k, k))


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv_weight(planes, inplanes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv_weight(planes, planes, 3)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv_weight(planes * 4, planes, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = stride > 1 or inplanes != planes * 4
        if self.downsample:
            self.down_conv = _conv_weight(planes * 4, inplanes, 1)
            self.down_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        """x: (B, C, H, W) fp32 → fp32."""
        out = F.relu(self.bn1(conv(x, self.conv1), eps))
        out = F.relu(self.bn2(conv(out, self.conv2, padding=1), eps))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(conv(out, self.conv3), eps)
        identity = x.float()
        if self.downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.down_bn(conv(identity, self.down_conv), eps)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """The grid's mean token prepended to the grid, plus positions; one
    query (the mean token) over all tokens, scores divided by sqrt(D)
    after q.k; the output projection. All in fp32."""

    def __init__(self, spacial: int, embed: int, output_dim: int,
                 heads: int):
        super().__init__()
        self.heads = heads
        self.pos = nn.Parameter(torch.empty(spacial * spacial + 1, embed))
        self.q = nn.Linear(embed, embed)
        self.k = nn.Linear(embed, embed)
        self.v = nn.Linear(embed, embed)
        self.c = nn.Linear(embed, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) → (B, output_dim) fp32."""
        B, C = x.shape[:2]
        tokens = x.float().flatten(2).transpose(1, 2)          # (B, HW, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.pos.float()[None]

        def linear(layer, t):
            return F.linear(t, layer.weight.float(), layer.bias.float())

        N, D = self.heads, C // self.heads

        def heads(t):
            return t.reshape(B, -1, N, D).transpose(1, 2)

        q = heads(linear(self.q, tokens[:, :1]))
        k, v = heads(linear(self.k, tokens)), heads(linear(self.v, tokens))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
        o = torch.matmul(torch.softmax(scores, dim=-1), v)
        return linear(self.c, o.transpose(1, 2).reshape(B, C))


class ResNetVisionTower(nn.Module):
    def __init__(self, config: ResNetVisionConfig):
        super().__init__()
        w = config.width
        self.config = config
        self.stem_conv1 = _conv_weight(w // 2, 3, 3)
        self.stem_bn1 = FrozenBatchNorm(w // 2)
        self.stem_conv2 = _conv_weight(w // 2, w // 2, 3)
        self.stem_bn2 = FrozenBatchNorm(w // 2)
        self.stem_conv3 = _conv_weight(w, w // 2, 3)
        self.stem_bn3 = FrozenBatchNorm(w)
        self.stages = nn.ModuleList()
        inplanes = w
        for si, n_blocks in enumerate(config.layers):
            planes = w * 2 ** si
            stage = nn.ModuleList()
            for bi in range(n_blocks):
                stage.append(Bottleneck(inplanes, planes,
                                        2 if si > 0 and bi == 0 else 1))
                inplanes = planes * 4
            self.stages.append(stage)
        self.attnpool = AttentionPool2d(config.image_size // 32, w * 32,
                                        config.output_dim, config.heads)

    def forward(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """(B, size, size, 3) uint8 → (B, output_dim) fp32
        (unnormalized)."""
        eps = self.config.bn_eps
        mean, std = _pixel_stats(pixels_u8.device)
        x = ((pixels_u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn1(conv(x, self.stem_conv1, stride=2,
                                      padding=1), eps))
        x = F.relu(self.stem_bn2(conv(x, self.stem_conv2, padding=1), eps))
        x = F.relu(self.stem_bn3(conv(x, self.stem_conv3, padding=1), eps))
        x = F.avg_pool2d(x, 2)
        for stage in self.stages:
            for block in stage:
                x = block(x, eps)
        return self.attnpool(x)


class ResNetCLIP(nn.Module):
    """The CLIP text tower and the ModifiedResNet vision tower; the
    module's dtype is the compute dtype."""

    def __init__(self, text_config: CLIPTextConfig,
                 vision_config: ResNetVisionConfig):
        super().__init__()
        self.text = CLIPTextTower(text_config)
        self.vision = ResNetVisionTower(vision_config)


def encode_resnet_clip_image(model: ResNetCLIP,
                             pixels_u8: torch.Tensor) -> torch.Tensor:
    """(B, size, size, 3) uint8 → (B, output_dim) fp32 (unnormalized)."""
    return model.vision(pixels_u8)


# --- init + conversion -------------------------------------------------------

@torch.no_grad()
def init_resnet_clip_params(text_config: CLIPTextConfig,
                            vision_config: ResNetVisionConfig,
                            generator: torch.Generator, dtype=torch.float32,
                            device="cuda") -> ResNetCLIP:
    """Random-init model as the JAX package draws its (test mode): conv
    weights, attention-pool weights and positions normal / sqrt(fan_in),
    BatchNorm the identity (scale 1, bias 0, mean 0, var 1), zero biases;
    the text tower as ``models/clip.py init_clip_params`` (normal(0,
    0.02), unit LayerNorms); all from ``generator`` on ``device``."""
    model = empty_module(lambda: ResNetCLIP(text_config, vision_config),
                         dtype, device)
    random_init(model.text, generator)
    identity = {"weight": 1.0, "bias": 0.0, "mean": 0.0, "var": 1.0}
    for module in model.vision.modules():
        if isinstance(module, FrozenBatchNorm):
            for name, value in identity.items():
                getattr(module, name).fill_(value)
    for name, param in model.vision.named_parameters():
        if name.startswith("attnpool.") and name.endswith("bias"):
            param.zero_()
        elif param.dim() > 1:
            # (O, I, kh, kw) convs, (out, in) linears, (S, embed) positions
            fan_in = int(np.prod(param.shape[1:]))
            param.copy_(torch.randn(param.shape, generator=generator,
                                    device=param.device) / math.sqrt(fan_in))
    return model


def resnet_vision_params_from_torch(sd_np: dict, config: ResNetVisionConfig,
                                    prefix: str = "visual.") -> dict:
    """Convert an openai/open_clip ModifiedResNet state dict (numpy values;
    keys visual.conv1..., visual.layer{1-4}.{i}..., visual.attnpool...)
    into the JAX package's layout (numpy float32, HWIO convs)."""
    def cw(key):  # torch conv (O, I, kh, kw) → HWIO
        return _f32(sd_np[prefix + key].transpose(2, 3, 1, 0))

    def bn(dst, dprefix, key):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            dst[f"{dprefix}_{ours}"] = _f32(sd_np[f"{prefix}{key}.{theirs}"])

    stem = {f"conv{i}_w": cw(f"conv{i}.weight") for i in (1, 2, 3)}
    for i in (1, 2, 3):
        bn(stem, f"bn{i}", f"bn{i}")
    stages = []
    for si, n_blocks in enumerate(config.layers):
        stage = []
        for bi in range(n_blocks):
            base = f"layer{si + 1}.{bi}"
            bp = {f"conv{i}_w": cw(f"{base}.conv{i}.weight")
                  for i in (1, 2, 3)}
            for i in (1, 2, 3):
                bn(bp, f"bn{i}", f"{base}.bn{i}")
            if f"{prefix}{base}.downsample.0.weight" in sd_np:
                bp["down_conv_w"] = cw(f"{base}.downsample.0.weight")
                bn(bp, "down_bn", f"{base}.downsample.1")
            stage.append(bp)
        stages.append(stage)
    ap = {"pos": _f32(sd_np[prefix + "attnpool.positional_embedding"])}
    for name in ("q", "k", "v", "c"):
        ap[f"{name}_w"] = _f32(sd_np[f"{prefix}attnpool.{name}_proj.weight"].T)
        ap[f"{name}_b"] = _f32(sd_np[f"{prefix}attnpool.{name}_proj.bias"])
    return {"vision": {"stem": stem, "stages": stages, "attnpool": ap}}


def _oihw(hwio) -> np.ndarray:
    return np.asarray(hwio).transpose(3, 2, 0, 1)


def _bn_values(prefix: str, tree: dict, name: str) -> dict:
    return {f"{prefix}.{ours}": tree[f"{name}_{theirs}"]
            for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                                 ("mean", "mean"), ("var", "var"))}


def vision_values(prefix: str, vision: dict) -> dict:
    """The values of a ``ResNetVisionTower`` under ``prefix``, from the
    ``"vision"`` part of the JAX package's layout (numpy arrays; HWIO convs
    become OIHW, (in, out) weights (out, in))."""
    stem = vision["stem"]
    values = {}
    for i in (1, 2, 3):
        values[f"{prefix}stem_conv{i}"] = _oihw(stem[f"conv{i}_w"])
        values.update(_bn_values(f"{prefix}stem_bn{i}", stem, f"bn{i}"))
    for si, stage in enumerate(vision["stages"]):
        for bi, bp in enumerate(stage):
            base = f"{prefix}stages.{si}.{bi}"
            for i in (1, 2, 3):
                values[f"{base}.conv{i}"] = _oihw(bp[f"conv{i}_w"])
                values.update(_bn_values(f"{base}.bn{i}", bp, f"bn{i}"))
            if "down_conv_w" in bp:
                values[f"{base}.down_conv"] = _oihw(bp["down_conv_w"])
                values.update(_bn_values(f"{base}.down_bn", bp, "down_bn"))
    ap = vision["attnpool"]
    values[f"{prefix}attnpool.pos"] = ap["pos"]
    for name in ("q", "k", "v", "c"):
        values[f"{prefix}attnpool.{name}.weight"] = np.asarray(
            ap[f"{name}_w"]).T
        values[f"{prefix}attnpool.{name}.bias"] = ap[f"{name}_b"]
    return values


def params_from_jax(params_numpy: dict, text_config: CLIPTextConfig,
                    vision_config: ResNetVisionConfig, dtype=torch.float32,
                    device="cuda") -> ResNetCLIP:
    """A model holding parameters in the JAX package's layout, given as
    numpy arrays ({"text": {...}, "vision": {"stem", "stages",
    "attnpool"}}): the JAX package's own params, or the converters'
    output."""
    model = empty_module(lambda: ResNetCLIP(text_config, vision_config),
                         dtype, device)
    return fill_parameters(model, {
        **text_values("text.", params_numpy["text"], text_config.num_layers),
        **vision_values("vision.", params_numpy["vision"])})


# registry arch name → config
RESNET_CONFIGS = {
    "RN50": ResNetVisionConfig((3, 4, 6, 3), 64, 224, 1024, 32),
    "RN101": ResNetVisionConfig((3, 4, 23, 3), 64, 224, 512, 32),
    "RN50x4": ResNetVisionConfig((4, 6, 10, 6), 80, 288, 640, 40),
    "RN50x16": ResNetVisionConfig((6, 8, 18, 8), 96, 384, 768, 48),
    "RN50x64": ResNetVisionConfig((3, 15, 36, 10), 128, 448, 1024, 64),
}


class ConvCLIPModel(TorchCLIPModel):
    """A CLIP wrapper whose vision tower is a convnet (ResNet-CLIP here,
    ConvNeXt-CLIP in models/convnext_clip.py): the dimensions are the
    vision tower's output, weights load from an openai/open_clip
    checkpoint or at random, and the tokenizer resolves as the reference's
    does. Text tokenizing and encoding, and the image preprocessing
    (shorter-side resize, centre crop) are ``TorchCLIPModel``'s. A subclass
    gives ``family`` and ``_load_from_checkpoint`` / ``_load_random_init``."""

    family = ""

    @property
    def dimensions(self) -> int:
        return int(self.properties.get("dimensions", 0)) or \
            (self.vision_config.output_dim if self.vision_config else 0)

    def load(self) -> None:
        if self.properties.get("localpath"):
            self._load_from_checkpoint(self.properties["localpath"])
        elif self.properties.get("random_init"):
            self._load_random_init()
        else:
            raise ModelLoadError(
                f"{self.family} model `{self.model_name}` requires an "
                "openai/open_clip checkpoint: provide "
                "model_properties.localpath or a model_location.")
        self.encoder = put_params(self, self.encoder)
        self.loaded = True
        self._param_bytes = sum(p.numel() * p.element_size()
                                for p in self.encoder.parameters())

    def _random_text_config(self, dims: int) -> CLIPTextConfig:
        """The random-init text tower, from ``architecture``."""
        arch = self.properties.get("architecture", {})
        return CLIPTextConfig(
            vocab_size=int(arch.get("vocab_size", 1024)),
            hidden_size=int(arch.get("text_hidden_size", 64)),
            num_layers=int(arch.get("text_layers", 2)),
            num_heads=int(arch.get("text_heads", 2)),
            intermediate_size=int(arch.get("text_intermediate", 128)),
            projection_dim=dims,
            eos_token_id=int(arch.get("vocab_size", 1024)) - 1)

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self._device).manual_seed(
            random_seed(self.model_name))

    def _init_tokenizer(self, checkpoint: str = None) -> None:
        from marqo_tpu_torch.models.tokenizer import resolve_model_tokenizer
        self.tokenizer = resolve_model_tokenizer(
            self.properties, max_length=self.text_config.max_positions,
            checkpoint_path=checkpoint,
            allow_test=bool(self.properties.get("random_init")))


class TorchResNetCLIPModel(ConvCLIPModel):
    """RN-family CLIP wrapper (reference JaxResNetCLIPModel): the
    ModifiedResNet vision tower and the CLIP text tower."""

    family = "ResNet-CLIP"
    # text tower shapes paired with each RN vision tower (open_clip
    # model_configs/RN*.json)
    _TEXT = {
        "RN50": (512, 12, 8, 2048),
        "RN101": (512, 12, 8, 2048),
        "RN50x4": (640, 12, 10, 2560),
        "RN50x16": (768, 12, 12, 3072),
        "RN50x64": (1024, 12, 16, 4096),
    }

    def _arch_token(self) -> str:
        name = self.properties.get("name", self.model_name)
        for token in ("RN50x64", "RN50x16", "RN50x4", "RN101", "RN50"):
            if token in name:
                return token
        return "RN50"

    def _load_from_checkpoint(self, path: str) -> None:
        self.vision_config = RESNET_CONFIGS[self._arch_token()]
        w, L, h, mlp = self._TEXT[self._arch_token()]
        # all RN-family pretrains are openai checkpoints: quick_gelu
        self.text_config = CLIPTextConfig(
            hidden_size=w, num_layers=L, num_heads=h, intermediate_size=mlp,
            projection_dim=self.vision_config.output_dim,
            hidden_act="quick_gelu")
        sd = _numpy_state_dict(load_open_clip_state(path, family="clip",
                                                    weights_only=False))
        self.encoder = params_from_jax(
            {"text": open_clip_text(sd, L),
             "vision": resnet_vision_params_from_torch(
                 sd, self.vision_config)["vision"]},
            self.text_config, self.vision_config, dtype=self.compute_dtype,
            device=self._device)
        self._init_tokenizer(checkpoint=path)

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        dims = int(self.properties.get("dimensions", 64))
        self.vision_config = ResNetVisionConfig(
            layers=tuple(arch.get("layers", (1, 1, 1, 1))),
            width=int(arch.get("width", 16)),
            image_size=int(self.properties.get("image_size", 64)),
            output_dim=dims, heads=int(arch.get("heads", 2)))
        self.text_config = self._random_text_config(dims)
        self.encoder = init_resnet_clip_params(
            self.text_config, self.vision_config, self._generator(),
            dtype=self.compute_dtype, device=self._device)
        self._init_tokenizer()
