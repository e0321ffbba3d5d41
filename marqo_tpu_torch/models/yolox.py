"""YOLOX-S object detector in PyTorch: the marqo-yolo patcher (port of
marqo_tpu/models/yolox.py).

The reference's `marqo-yolo` / `yolox` patch methods run the
Marqo/marqo-yolo-v2 yolox_s.onnx export through onnxruntime
(processing/yolox_utils.py:36-166, PatchifyYolox image.py:411-445). This is
the same architecture: CSPDarknet-S backbone (Focus stem, CSP layers, SPP),
PAFPN neck, decoupled heads over strides 8/16/32.

The module runs NCHW with OIHW conv weights; the JAX package runs NHWC with
HWIO weights, and ``params_from_jax`` transposes them. Every channel concat
of the JAX package (its last axis) is dim 1 here, operands in the same
order. Convolutions go to ``F.conv2d`` and pools to ``F.max_pool2d``, as the
JAX package leaves them to XLA: no kernel of this package runs here. The
forward runs cuDNN with TF32 off (``fp32_convolutions``): with it on, as
PyTorch's default has it, the outputs leave the fp32 reference's 1e-3.

Output (the ONNX export's, consumed by the reference's demo_postprocess,
yolox_utils.py:90-121): (B, N, 5 + num_classes) fp32 with RAW xy/wh per
anchor cell, then SIGMOIDED objectness and class scores, levels 8/16/32 in
that order; ``decode_outputs`` is the numpy grid decode.

Weights: the reference ships ONNX only; random init exercises the full
graph. The module attributes mirror the JAX package's parameter tree, so
``params_from_jax`` fills them by path.
"""

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         tree_values)
from marqo_tpu_torch.ops.common import fp32_convolutions

BN_EPS = 1e-3


@dataclass(frozen=True)
class YoloxConfig:
    num_classes: int = 80
    width: float = 0.50   # yolox-s
    depth: float = 0.33
    input_size: int = 384  # reference PatchifyYolox input_shape (384, 384)

    def ch(self, base: int) -> int:
        return int(base * self.width)

    def n(self, base: int) -> int:
        return max(1, round(base * self.depth))


class ConvBN(nn.Module):
    """Conv + BatchNorm(inference) + SiLU (YOLOX BaseConv). The BatchNorm is
    folded into a scale and a shift at call time, as the JAX package does."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bn_scale = nn.Parameter(torch.empty(cout))
        self.bn_bias = nn.Parameter(torch.empty(cout))
        self.bn_mean = nn.Parameter(torch.empty(cout))
        self.bn_var = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor, stride: int = 1,
                act: bool = True) -> torch.Tensor:
        k = self.w.shape[-1]
        x = F.conv2d(x, self.w.to(x.dtype), stride=stride,
                     padding=(k - 1) // 2)
        std = torch.sqrt(self.bn_var + BN_EPS)
        scale = (self.bn_scale / std).to(x.dtype)
        shift = (self.bn_bias - self.bn_mean * self.bn_scale / std).to(
            x.dtype)
        x = x * scale[:, None, None] + shift[:, None, None]
        return F.silu(x) if act else x


class Bottleneck(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = ConvBN(channels, channels, 1)
        self.conv2 = ConvBN(channels, channels, 3)

    def forward(self, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return x + y if shortcut else y


class CSPLayer(nn.Module):
    """Split, n bottlenecks on one branch, concat, fuse."""

    def __init__(self, cin: int, cout: int, n: int, expansion: float = 0.5):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = ConvBN(cin, hidden, 1)
        self.conv2 = ConvBN(cin, hidden, 1)
        self.conv3 = ConvBN(2 * hidden, cout, 1)
        self.blocks = nn.ModuleList(Bottleneck(hidden) for _ in range(n))

    def forward(self, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
        a = self.conv1(x)
        b = self.conv2(x)
        for block in self.blocks:
            a = block(a, shortcut)
        return self.conv3(torch.cat([a, b], dim=1))


class SPPBottleneck(nn.Module):
    """x and its 5/9/13 max pools (stride 1, -inf padding), concatenated
    in that order."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = ConvBN(channels, channels // 2, 1)
        self.conv2 = ConvBN(channels * 2, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        pools = [x] + [spp_pool(x, k) for k in (5, 9, 13)]
        return self.conv2(torch.cat(pools, dim=1))


def spp_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool at stride 1 over a -inf padding of k // 2 (the JAX
    package's reduce_window)."""
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


def focus_slices(x: torch.Tensor) -> torch.Tensor:
    """The Focus stem's 2x2 space-to-depth: (B, C, H, W) → (B, 4C, H/2,
    W/2), slices in the JAX package's channel order (top-left, bottom-left,
    top-right, bottom-right)."""
    tl = x[:, :, ::2, ::2]
    bl = x[:, :, 1::2, ::2]
    tr = x[:, :, ::2, 1::2]
    br = x[:, :, 1::2, 1::2]
    return torch.cat([tl, bl, tr, br], dim=1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 (jax.image.resize "nearest" at exactly twice the size)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _head(cin: int, width: int, num_classes: int) -> nn.ModuleDict:
    return nn.ModuleDict({
        "stem": ConvBN(cin, width, 1),
        "cls1": ConvBN(width, width, 3), "cls2": ConvBN(width, width, 3),
        "reg1": ConvBN(width, width, 3), "reg2": ConvBN(width, width, 3),
        "cls_pred": ConvBN(width, num_classes, 1),
        "reg_pred": ConvBN(width, 4, 1),
        "obj_pred": ConvBN(width, 1, 1),
    })


class YOLOX(nn.Module):
    def __init__(self, config: YoloxConfig):
        super().__init__()
        self.config = config
        c, n = config.ch, config.n
        self.backbone = nn.ModuleDict({
            "stem": nn.ModuleDict({"conv": ConvBN(12, c(64), 3)}),
            "dark2_conv": ConvBN(c(64), c(128), 3),
            "dark2_csp": CSPLayer(c(128), c(128), n(3)),
            "dark3_conv": ConvBN(c(128), c(256), 3),
            "dark3_csp": CSPLayer(c(256), c(256), n(9)),
            "dark4_conv": ConvBN(c(256), c(512), 3),
            "dark4_csp": CSPLayer(c(512), c(512), n(9)),
            "dark5_conv": ConvBN(c(512), c(1024), 3),
            "dark5_spp": SPPBottleneck(c(1024)),
            "dark5_csp": CSPLayer(c(1024), c(1024), n(3)),
        })
        self.neck = nn.ModuleDict({
            "lateral0": ConvBN(c(1024), c(512), 1),
            "c3_p4": CSPLayer(c(1024), c(512), n(3)),
            "reduce1": ConvBN(c(512), c(256), 1),
            "c3_p3": CSPLayer(c(512), c(256), n(3)),
            "bu2": ConvBN(c(256), c(256), 3),
            "c3_n3": CSPLayer(c(512), c(512), n(3)),
            "bu1": ConvBN(c(512), c(512), 3),
            "c3_n4": CSPLayer(c(1024), c(1024), n(3)),
        })
        self.heads = nn.ModuleList(_head(cin, c(256), config.num_classes)
                                   for cin in (c(256), c(512), c(1024)))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) float (YOLOX convention: raw 0-255 BGR, already
        letterboxed) → (B, N, 5 + num_classes) fp32: raw xy/wh per anchor
        with sigmoided objectness and class scores."""
        with fp32_convolutions():
            return self._forward(pixels)

    def _forward(self, pixels: torch.Tensor):
        """``forward`` under the process's own cuDNN settings."""
        bb, neck = self.backbone, self.neck
        x = pixels.permute(0, 3, 1, 2).to(self.backbone.stem.conv.w.dtype)
        x = bb.stem.conv(focus_slices(x))
        x = bb.dark2_conv(x, stride=2)
        x = bb.dark2_csp(x, shortcut=True)
        x = bb.dark3_conv(x, stride=2)
        d3 = bb.dark3_csp(x, shortcut=True)
        x = bb.dark4_conv(d3, stride=2)
        d4 = bb.dark4_csp(x, shortcut=True)
        x = bb.dark5_conv(d4, stride=2)
        x = bb.dark5_spp(x)
        d5 = bb.dark5_csp(x, shortcut=False)

        # PAFPN
        lat0 = neck.lateral0(d5)
        p4 = neck.c3_p4(torch.cat([upsample2(lat0), d4], dim=1),
                        shortcut=False)
        red1 = neck.reduce1(p4)
        out8 = neck.c3_p3(torch.cat([upsample2(red1), d3], dim=1),
                          shortcut=False)
        bu2 = neck.bu2(out8, stride=2)
        out16 = neck.c3_n3(torch.cat([bu2, red1], dim=1), shortcut=False)
        bu1 = neck.bu1(out16, stride=2)
        out32 = neck.c3_n4(torch.cat([bu1, lat0], dim=1), shortcut=False)

        outputs = []
        for feat, head in zip((out8, out16, out32), self.heads):
            stem = head.stem(feat)
            cls_feat = head.cls2(head.cls1(stem))
            reg_feat = head.reg2(head.reg1(stem))
            cls_out = torch.sigmoid(head.cls_pred(cls_feat, act=False))
            reg_out = head.reg_pred(reg_feat, act=False)
            obj_out = torch.sigmoid(head.obj_pred(reg_feat, act=False))
            level = torch.cat([reg_out, obj_out, cls_out], dim=1)
            B, C = level.shape[:2]
            # NHWC order of the anchors, as the export lays them out
            outputs.append(level.permute(0, 2, 3, 1).reshape(B, -1, C))
        return torch.cat(outputs, dim=1).float()


# --- init + conversion -------------------------------------------------------

@torch.no_grad()
def init_params(config: YoloxConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> YOLOX:
    """Random-init model as the JAX package draws it: conv weights
    normal * sqrt(2 / fan_in), BatchNorm the identity (scale 1, bias 0,
    mean 0, var 1); drawn from ``generator`` on ``device``."""
    model = empty_module(lambda: YOLOX(config), dtype, device)
    for module in model.modules():
        if isinstance(module, ConvBN):
            fan_in = int(np.prod(module.w.shape[1:]))
            module.w.copy_(torch.randn(module.w.shape, generator=generator,
                                       device=module.w.device) *
                           math.sqrt(2.0 / fan_in))
            module.bn_scale.fill_(1.0)
            module.bn_bias.zero_()
            module.bn_mean.zero_()
            module.bn_var.fill_(1.0)
    return model


def params_from_jax(params_numpy: dict, config: YoloxConfig,
                    dtype=torch.float32, device="cuda") -> YOLOX:
    """A model holding the JAX package's parameters (numpy arrays of its
    tree: HWIO conv weights become OIHW)."""
    values = {name: (np.asarray(a).transpose(3, 2, 0, 1)
                     if np.ndim(a) == 4 else a)
              for name, a in tree_values(params_numpy).items()}
    return fill_parameters(
        empty_module(lambda: YOLOX(config), dtype, device), values)


def decode_outputs(outputs: np.ndarray, img_size: Tuple[int, int]
                   ) -> np.ndarray:
    """Grid decode — numerically identical to the reference's
    demo_postprocess (yolox_utils.py:90-121): xy = (raw + grid) * stride,
    wh = exp(raw) * stride, strides 8/16/32."""
    grids: List[np.ndarray] = []
    expanded: List[np.ndarray] = []
    for stride in (8, 16, 32):
        hsize, wsize = img_size[0] // stride, img_size[1] // stride
        xv, yv = np.meshgrid(np.arange(wsize), np.arange(hsize))
        grid = np.stack((xv, yv), 2).reshape(1, -1, 2)
        grids.append(grid)
        expanded.append(np.full((*grid.shape[:2], 1), stride))
    grid = np.concatenate(grids, 1)
    strides = np.concatenate(expanded, 1)
    outputs = outputs.copy()
    outputs[..., :2] = (outputs[..., :2] + grid) * strides
    # clip keeps exp finite in float32 (only reachable with synthetic
    # weights; real logits are far below 80)
    outputs[..., 2:4] = np.exp(np.minimum(outputs[..., 2:4], 80.0)) * strides
    return outputs
