"""ConvNeXt-CLIP (open_clip convnext_base{,_w,_w_320}, convnext_large_d{,_320},
convnext_xxlarge) in PyTorch (port of marqo_tpu/models/convnext_clip.py).

The vision tower is a timm ConvNeXt trunk wrapped by open_clip's TimmModel:
a 4x4 stride-4 stem conv then LayerNorm; stages that downsample with
LayerNorm then a 2x2 stride-2 conv; blocks of a 7x7 depthwise conv
(``groups=C``), a channels-last LayerNorm, an exact-GELU MLP (4x) and the
``gamma`` layer scale on the residual; then a global mean, LayerNorm and
EITHER a linear head (convnext_base*) OR an MLP head fc1-GELU-fc2
(convnext_large_d*, xxlarge): the parameters decide, as in the JAX package.
The text tower is the CLIP text transformer of models/clip.py.

Activations stay channels-last (B, H, W, C), as the JAX package holds
them; each conv runs ``F.conv2d`` on the NCHW view of them, with torch's
(O, I, kh, kw) weights (``params_from_jax`` turns the JAX package's HWIO
into OIHW). Convolutions, LayerNorms and matmuls go to torch, as the JAX
package leaves them to XLA: no kernel of this package runs in this tower.
The module's dtype is the compute dtype; LayerNorm statistics and the head
run in fp32.
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextTower, _f32,
                                         _numpy_state_dict, _pixel_stats,
                                         load_open_clip_state, open_clip_text,
                                         text_values)
from marqo_tpu_torch.models.resnet_clip import ConvCLIPModel
from marqo_tpu_torch.ops.common import gelu, layer_norm


@dataclass(frozen=True)
class ConvNextVisionConfig:
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    dims: Tuple[int, ...] = (128, 256, 512, 1024)   # convnext_base
    image_size: int = 256
    output_dim: int = 640
    layer_norm_eps: float = 1e-6


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              stride: int = 1, padding: int = 0,
              groups: int = 1) -> torch.Tensor:
    """A conv of channels-last x (B, H, W, C) with (O, I, kh, kw) weights,
    in the weight's dtype; the output channels-last too."""
    out = F.conv2d(x.to(weight.dtype).permute(0, 3, 1, 2), weight, bias,
                   stride=stride, padding=padding, groups=groups)
    return out.permute(0, 2, 3, 1)


class ConvNextBlock(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.dw_weight = nn.Parameter(torch.empty(dim, 1, 7, 7))
        self.dw_bias = nn.Parameter(torch.empty(dim))
        self.norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(x, self.dw_weight, self.dw_bias, padding=3,
                      groups=x.shape[-1])
        h = layer_norm(h.float(), self.norm.weight, self.norm.bias,
                       self.eps).to(x.dtype)
        h = self.fc2(gelu(self.fc1(h)))
        return x + (self.gamma * h).to(x.dtype)


class ConvNextStage(nn.Module):
    def __init__(self, previous: int, dim: int, depth: int, eps: float,
                 downsample: bool):
        super().__init__()
        self.eps = eps
        if downsample:
            self.down_norm = nn.LayerNorm(previous)
            self.down_weight = nn.Parameter(torch.empty(dim, previous, 2, 2))
            self.down_bias = nn.Parameter(torch.empty(dim))
        self.downsample = downsample
        self.blocks = nn.ModuleList(ConvNextBlock(dim, eps)
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            x = layer_norm(x.float(), self.down_norm.weight,
                           self.down_norm.bias, self.eps).to(x.dtype)
            x = conv_nhwc(x, self.down_weight, self.down_bias, stride=2)
        for block in self.blocks:
            x = block(x)
        return x


class ConvNextVisionTower(nn.Module):
    """``head_hidden`` 0: the linear head; else the MLP head's width."""

    def __init__(self, config: ConvNextVisionConfig, head_hidden: int = 0):
        super().__init__()
        dims, eps = config.dims, config.layer_norm_eps
        self.config = config
        self.stem_weight = nn.Parameter(torch.empty(dims[0], 3, 4, 4))
        self.stem_bias = nn.Parameter(torch.empty(dims[0]))
        self.stem_norm = nn.LayerNorm(dims[0])
        self.stages = nn.ModuleList(
            ConvNextStage(dims[max(si - 1, 0)], dims[si], depth, eps, si > 0)
            for si, depth in enumerate(config.depths))
        self.head_norm = nn.LayerNorm(dims[-1])
        self.head_hidden = head_hidden
        if head_hidden:
            self.head_fc1 = nn.Linear(dims[-1], head_hidden)
            self.head_fc2 = nn.Linear(head_hidden, config.output_dim)
        else:
            self.head_proj = nn.Linear(dims[-1], config.output_dim)

    def forward(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """(B, size, size, 3) uint8 → (B, output_dim) fp32
        (unnormalized)."""
        eps = self.config.layer_norm_eps
        mean, std = _pixel_stats(pixels_u8.device)
        x = (pixels_u8.float() / 255.0 - mean) / std
        x = conv_nhwc(x, self.stem_weight, self.stem_bias, stride=4)
        x = layer_norm(x.float(), self.stem_norm.weight, self.stem_norm.bias,
                       eps).to(self.stem_weight.dtype)
        for stage in self.stages:
            x = stage(x)
        pooled = layer_norm(x.float().mean(dim=(1, 2)), self.head_norm.weight,
                            self.head_norm.bias, eps)

        def linear(layer, t):
            return F.linear(t, layer.weight.float(), layer.bias.float())

        if self.head_hidden:
            return linear(self.head_fc2, gelu(linear(self.head_fc1, pooled)))
        return linear(self.head_proj, pooled)


class ConvNextCLIP(nn.Module):
    """The CLIP text tower and the ConvNeXt vision tower; the module's
    dtype is the compute dtype."""

    def __init__(self, text_config: CLIPTextConfig,
                 vision_config: ConvNextVisionConfig, head_hidden: int = 0):
        super().__init__()
        self.text = CLIPTextTower(text_config)
        self.vision = ConvNextVisionTower(vision_config, head_hidden)


def encode_convnext_clip_image(model: ConvNextCLIP,
                               pixels_u8: torch.Tensor) -> torch.Tensor:
    """(B, size, size, 3) uint8 → (B, output_dim) fp32 (unnormalized)."""
    return model.vision(pixels_u8)


# --- init + conversion -------------------------------------------------------

@torch.no_grad()
def init_convnext_clip_params(text_config: CLIPTextConfig,
                              vision_config: ConvNextVisionConfig,
                              generator: torch.Generator, dtype=torch.float32,
                              device="cuda") -> ConvNextCLIP:
    """Random-init model (linear head) as the JAX package draws its:
    conv and linear weights normal / sqrt(fan_in), ``gamma`` 1e-6, zero
    biases, unit LayerNorms; the text tower as ``models/clip.py
    init_clip_params``; all from ``generator`` on ``device``."""
    model = empty_module(lambda: ConvNextCLIP(text_config, vision_config),
                         dtype, device)
    random_init(model, generator)
    for name, param in model.vision.named_parameters():
        if name.endswith("gamma"):
            param.fill_(1e-6)
        elif param.dim() > 1:
            # (O, I, kh, kw) convs (depthwise: I = 1), (out, in) linears
            fan_in = int(np.prod(param.shape[1:]))
            param.copy_(torch.randn(param.shape, generator=generator,
                                    device=param.device) / math.sqrt(fan_in))
    return model


def convnext_vision_params_from_torch(sd_np: dict,
                                      config: ConvNextVisionConfig,
                                      prefix: str = "visual.") -> dict:
    """Convert an open_clip TimmModel(convnext) state dict (trunk.* timm
    naming: stem.0/1, stages.{s}.downsample.0/1, stages.{s}.blocks.{b}.
    conv_dw/norm/mlp.fc1/mlp.fc2/gamma, head.norm or norm_pre; head.proj or
    head.mlp.fc1/fc2 open_clip naming) into the JAX package's layout (numpy
    float32, HWIO convs)."""
    t = prefix + "trunk."

    def cw(key):  # torch conv (O, I, kh, kw) → HWIO
        return _f32(sd_np[key].transpose(2, 3, 1, 0))

    stem = {"conv_w": cw(t + "stem.0.weight"),
            "conv_b": _f32(sd_np[t + "stem.0.bias"]),
            "norm_scale": _f32(sd_np[t + "stem.1.weight"]),
            "norm_bias": _f32(sd_np[t + "stem.1.bias"])}
    stages = []
    for si, depth in enumerate(config.depths):
        base = t + f"stages.{si}."
        stage = {"blocks": []}
        if si > 0:
            stage["down_norm_scale"] = _f32(sd_np[base + "downsample.0.weight"])
            stage["down_norm_bias"] = _f32(sd_np[base + "downsample.0.bias"])
            stage["down_conv_w"] = cw(base + "downsample.1.weight")
            stage["down_conv_b"] = _f32(sd_np[base + "downsample.1.bias"])
        for bi in range(depth):
            bb = base + f"blocks.{bi}."
            stage["blocks"].append({
                "dw_w": cw(bb + "conv_dw.weight"),  # (C, 1, 7, 7) → (7,7,1,C)
                "dw_b": _f32(sd_np[bb + "conv_dw.bias"]),
                "norm_scale": _f32(sd_np[bb + "norm.weight"]),
                "norm_bias": _f32(sd_np[bb + "norm.bias"]),
                "mlp_w1": _f32(sd_np[bb + "mlp.fc1.weight"].T),
                "mlp_b1": _f32(sd_np[bb + "mlp.fc1.bias"]),
                "mlp_w2": _f32(sd_np[bb + "mlp.fc2.weight"].T),
                "mlp_b2": _f32(sd_np[bb + "mlp.fc2.bias"]),
                "gamma": _f32(sd_np[bb + "gamma"]),
            })
        stages.append(stage)
    # timm puts the final norm in head.norm when global_pool precedes it
    nk = t + ("head.norm.weight" if t + "head.norm.weight" in sd_np
              else "norm_pre.weight")
    head = {"norm_scale": _f32(sd_np[nk]),
            "norm_bias": _f32(sd_np[nk.replace(".weight", ".bias")])}
    if prefix + "head.mlp.fc1.weight" in sd_np:
        # open_clip timm_proj='mlp' (convnext_large_d*/xxlarge configs)
        for i in (1, 2):
            head[f"mlp_w{i}"] = _f32(
                sd_np[prefix + f"head.mlp.fc{i}.weight"].T)
            head[f"mlp_b{i}"] = _f32(sd_np[prefix + f"head.mlp.fc{i}.bias"])
    else:
        head["proj_w"] = _f32(sd_np[prefix + "head.proj.weight"].T)
        head["proj_b"] = _f32(sd_np[prefix + "head.proj.bias"])
    return {"vision": {"stem": stem, "stages": stages, "head": head}}


def _oihw(hwio) -> np.ndarray:
    return np.asarray(hwio).transpose(3, 2, 0, 1)


def head_hidden(vision: dict) -> int:
    """The MLP head's width in the JAX package's vision layout, 0 for the
    linear head."""
    head = vision["head"]
    return int(np.shape(head["mlp_w1"])[1]) if "mlp_w1" in head else 0


def vision_values(prefix: str, vision: dict) -> dict:
    """The values of a ``ConvNextVisionTower`` under ``prefix``, from the
    ``"vision"`` part of the JAX package's layout (numpy arrays; HWIO convs
    become OIHW, (in, out) weights (out, in))."""
    stem, head = vision["stem"], vision["head"]
    values = {f"{prefix}stem_weight": _oihw(stem["conv_w"]),
              f"{prefix}stem_bias": stem["conv_b"],
              f"{prefix}stem_norm.weight": stem["norm_scale"],
              f"{prefix}stem_norm.bias": stem["norm_bias"],
              f"{prefix}head_norm.weight": head["norm_scale"],
              f"{prefix}head_norm.bias": head["norm_bias"]}
    for si, stage in enumerate(vision["stages"]):
        base = f"{prefix}stages.{si}."
        if "down_conv_w" in stage:
            values[base + "down_norm.weight"] = stage["down_norm_scale"]
            values[base + "down_norm.bias"] = stage["down_norm_bias"]
            values[base + "down_weight"] = _oihw(stage["down_conv_w"])
            values[base + "down_bias"] = stage["down_conv_b"]
        for bi, bp in enumerate(stage["blocks"]):
            bb = f"{base}blocks.{bi}."
            values.update({
                bb + "dw_weight": _oihw(bp["dw_w"]),
                bb + "dw_bias": bp["dw_b"],
                bb + "norm.weight": bp["norm_scale"],
                bb + "norm.bias": bp["norm_bias"],
                bb + "fc1.weight": np.asarray(bp["mlp_w1"]).T,
                bb + "fc1.bias": bp["mlp_b1"],
                bb + "fc2.weight": np.asarray(bp["mlp_w2"]).T,
                bb + "fc2.bias": bp["mlp_b2"],
                bb + "gamma": bp["gamma"]})
    layers = (("head_fc1", "mlp_w1", "mlp_b1"),
              ("head_fc2", "mlp_w2", "mlp_b2")) if "mlp_w1" in head else \
        (("head_proj", "proj_w", "proj_b"),)
    for name, w, b in layers:
        values[f"{prefix}{name}.weight"] = np.asarray(head[w]).T
        values[f"{prefix}{name}.bias"] = head[b]
    return values


def params_from_jax(params_numpy: dict, text_config: CLIPTextConfig,
                    vision_config: ConvNextVisionConfig, dtype=torch.float32,
                    device="cuda") -> ConvNextCLIP:
    """A model holding parameters in the JAX package's layout, given as
    numpy arrays ({"text": {...}, "vision": {"stem", "stages", "head"}}):
    the JAX package's own params, or the converters' output. The head's
    keys pick the linear or the MLP head."""
    vision = params_numpy["vision"]
    model = empty_module(lambda: ConvNextCLIP(text_config, vision_config,
                                              head_hidden(vision)),
                         dtype, device)
    return fill_parameters(model, {
        **text_values("text.", params_numpy["text"], text_config.num_layers),
        **vision_values("vision.", vision)})


CONVNEXT_CONFIGS = {
    "convnext_base_w_320": ConvNextVisionConfig(
        (3, 3, 27, 3), (128, 256, 512, 1024), 320, 640),
    "convnext_base_w": ConvNextVisionConfig(
        (3, 3, 27, 3), (128, 256, 512, 1024), 256, 640),
    "convnext_base": ConvNextVisionConfig(
        (3, 3, 27, 3), (128, 256, 512, 1024), 224, 512),
    "convnext_large_d_320": ConvNextVisionConfig(
        (3, 3, 27, 3), (192, 384, 768, 1536), 320, 768),
    "convnext_large_d": ConvNextVisionConfig(
        (3, 3, 27, 3), (192, 384, 768, 1536), 256, 768),
    "convnext_xxlarge": ConvNextVisionConfig(
        (3, 4, 30, 3), (384, 768, 1536, 3072), 256, 1024),
}

# text tower shapes per family (open_clip model_configs/convnext_*.json)
CONVNEXT_TEXT = {
    "convnext_base": (512, 12, 8, 2048),
    "convnext_base_w": (640, 12, 10, 2560),
    "convnext_base_w_320": (640, 12, 10, 2560),
    "convnext_large_d": (768, 16, 12, 3072),
    "convnext_large_d_320": (768, 16, 12, 3072),
    "convnext_xxlarge": (1024, 24, 16, 4096),
}


class TorchConvNextCLIPModel(ConvCLIPModel):
    """ConvNeXt-CLIP wrapper (reference JaxConvNextCLIPModel): the timm
    ConvNeXt vision trunk and the CLIP text tower."""

    family = "ConvNeXt-CLIP"

    def _arch_token(self) -> str:
        name = self.properties.get("name", self.model_name)
        for token in sorted(CONVNEXT_CONFIGS, key=len, reverse=True):
            if token in name:
                return token
        return "convnext_base"

    def _load_from_checkpoint(self, path: str) -> None:
        token = self._arch_token()
        self.vision_config = CONVNEXT_CONFIGS[token]
        w, L, h, mlp = CONVNEXT_TEXT[token]
        self.text_config = CLIPTextConfig(
            hidden_size=w, num_layers=L, num_heads=h, intermediate_size=mlp,
            projection_dim=self.vision_config.output_dim, hidden_act="gelu")
        sd = _numpy_state_dict(load_open_clip_state(path))
        self.encoder = params_from_jax(
            {"text": open_clip_text(sd, L),
             "vision": convnext_vision_params_from_torch(
                 sd, self.vision_config)["vision"]},
            self.text_config, self.vision_config, dtype=self.compute_dtype,
            device=self._device)
        self._init_tokenizer(checkpoint=path)

    def _load_random_init(self) -> None:
        arch = self.properties.get("architecture", {})
        dims = int(self.properties.get("dimensions", 24))
        self.vision_config = ConvNextVisionConfig(
            depths=tuple(arch.get("depths", (1, 1, 1, 1))),
            dims=tuple(arch.get("dims", (8, 16, 32, 64))),
            image_size=int(self.properties.get("image_size", 64)),
            output_dim=dims)
        self.text_config = self._random_text_config(dims)
        self.encoder = init_convnext_clip_params(
            self.text_config, self.vision_config, self._generator(),
            dtype=self.compute_dtype, device=self._device)
        self._init_tokenizer()
