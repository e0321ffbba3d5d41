"""Faster R-CNN region proposer (ResNet-50 FPN + RPN) in PyTorch: the
`frcnn` patch method's detector (port of marqo_tpu/models/frcnn.py).

The reference's frcnn patcher runs torchvision's fasterrcnn_resnet50_fpn
and keeps its boxes and scores for class-agnostic patching (reference
processing/pytorch_utils.py load_pytorch, PatchifyPytorch
image.py:379-409). Class-agnostic regions come from the proposal stage:
ResNet-50 backbone → FPN P2–P6 → RPN objectness and box deltas over
anchors, ranked by objectness (the ROI head's class scores are discarded
by class-agnostic patching anyway).

The module runs NCHW with OIHW conv weights (the JAX package: NHWC, HWIO;
``params_from_jax`` transposes them) and returns each level's outputs in
the JAX package's NHWC layout, which ``decode_proposals`` reads.
Convolutions, pools and the nearest x2 upsampling are torch library calls,
as the JAX package leaves them to XLA: no kernel of this package runs here.
The forward runs cuDNN with TF32 off (``fp32_convolutions``): with it on,
as PyTorch's default has it, the outputs leave the fp32 reference's 1e-3.

Weights: torchvision checkpoints cannot be fetched offline; random init
(MARQO_PATCH_MODELS_RANDOM_INIT=TRUE) runs the full graph. The module
attributes mirror the JAX package's parameter tree.
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


@dataclass(frozen=True)
class FrcnnConfig:
    input_size: int = 384          # reference PatchifyPytorch input_shape
    fpn_channels: int = 256
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # torchvision anchor sizes per FPN level P2..P6
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    width: float = 1.0             # resnet-50 channel multiplier

    def ch(self, base: int) -> int:
        return max(8, int(base * self.width))


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ConvAffine(nn.Module):
    """Conv, a per-channel scale and bias (frozen BatchNorm), ReLU."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin, k, k))
        self.scale = nn.Parameter(torch.empty(cout))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor, stride: int = 1,
                relu: bool = True) -> torch.Tensor:
        k = self.w.shape[-1]
        x = F.conv2d(x, self.w.to(x.dtype), stride=stride,
                     padding=(k - 1) // 2)
        x = x * self.scale.to(x.dtype)[:, None, None] + \
            self.bias.to(x.dtype)[:, None, None]
        return F.relu(x) if relu else x


class Bottleneck(nn.Module):
    """ResNet bottleneck 1x1 → 3x3 → 1x1 with a projection shortcut on the
    first block of a stage."""

    def __init__(self, cin: int, mid: int, cout: int, down: bool):
        super().__init__()
        self.conv1 = ConvAffine(cin, mid, 1)
        self.conv2 = ConvAffine(mid, mid, 3)
        self.conv3 = ConvAffine(mid, cout, 1)
        self.down = ConvAffine(cin, cout, 1) if down else None

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        out = self.conv1(x)
        out = self.conv2(out, stride=stride)
        out = self.conv3(out, relu=False)
        shortcut = x
        if self.down is not None:
            shortcut = self.down(x, stride=stride, relu=False)
        return F.relu(out + shortcut)


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool, padding 1 filled with -inf (the JAX package's
    reduce_window)."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 (jax.image.resize "nearest" at exactly twice the size)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FasterRCNNProposer(nn.Module):
    def __init__(self, config: FrcnnConfig):
        super().__init__()
        self.config = config
        c = config.ch
        # resnet-50 stages: (blocks, mid, out)
        stages = [(3, c(64), c(256)), (4, c(128), c(512)),
                  (6, c(256), c(1024)), (3, c(512), c(2048))]
        backbone = {"stem": ConvAffine(3, c(64), 7)}
        cin = c(64)
        for s, (n, mid, cout) in enumerate(stages):
            backbone[f"stage{s + 2}"] = nn.ModuleList(
                Bottleneck(cin if b == 0 else cout, mid, cout, down=(b == 0))
                for b in range(n))
            cin = cout
        self.backbone = nn.ModuleDict(backbone)
        width = config.fpn_channels
        fpn = {}
        for level, cc in zip((2, 3, 4, 5), (c(256), c(512), c(1024),
                                             c(2048))):
            fpn[f"lateral{level}"] = ConvAffine(cc, width, 1)
            fpn[f"output{level}"] = ConvAffine(width, width, 3)
        self.fpn = nn.ModuleDict(fpn)
        A = len(config.anchor_ratios)
        self.rpn = nn.ModuleDict({
            "conv": ConvAffine(width, width, 3),
            "objectness": ConvAffine(width, A, 1),
            "deltas": ConvAffine(width, 4 * A, 1),
        })

    def forward(self, pixels: torch.Tensor
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(B, S, S, 3) float normalized → per FPN level P2..P6
        (objectness logits (B, H, W, A), box deltas (B, H, W, 4A)), NHWC
        as the JAX package returns them."""
        with fp32_convolutions():
            return self._forward(pixels)

    def _forward(self, pixels: torch.Tensor):
        """``forward`` under the process's own cuDNN settings."""
        bb = self.backbone
        x = pixels.permute(0, 3, 1, 2).to(bb.stem.w.dtype)
        x = stem_pool(bb.stem(x, stride=2))
        feats = {}
        for s in (2, 3, 4, 5):
            for i, block in enumerate(bb[f"stage{s}"]):
                x = block(x, stride=2 if (i == 0 and s > 2) else 1)
            feats[s] = x
        fpn = self.fpn
        p5 = fpn.lateral5(feats[5], relu=False)
        p4 = fpn.lateral4(feats[4], relu=False) + upsample2(p5)
        p3 = fpn.lateral3(feats[3], relu=False) + upsample2(p4)
        p2 = fpn.lateral2(feats[2], relu=False) + upsample2(p3)
        levels = [fpn.output2(p2, relu=False), fpn.output3(p3, relu=False),
                  fpn.output4(p4, relu=False), fpn.output5(p5, relu=False)]
        # P6: stride-2 max pool of P5 (torchvision LastLevelMaxPool)
        levels.append(F.max_pool2d(levels[-1], kernel_size=1, stride=2))
        rpn = self.rpn
        outputs = []
        for feat in levels:
            h = rpn.conv(feat)
            outputs.append(
                (rpn.objectness(h, relu=False).permute(0, 2, 3, 1),
                 rpn.deltas(h, relu=False).permute(0, 2, 3, 1)))
        return outputs


# --- init + conversion -------------------------------------------------------

@torch.no_grad()
def init_params(config: FrcnnConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> FasterRCNNProposer:
    """Random-init model as the JAX package draws it: conv weights
    normal * sqrt(2 / fan_in), scale 1, bias 0; drawn from ``generator``
    on ``device``."""
    model = empty_module(lambda: FasterRCNNProposer(config), dtype, device)
    for module in model.modules():
        if isinstance(module, ConvAffine):
            fan_in = int(np.prod(module.w.shape[1:]))
            module.w.copy_(torch.randn(module.w.shape, generator=generator,
                                       device=module.w.device) *
                           math.sqrt(2.0 / fan_in))
            module.scale.fill_(1.0)
            module.bias.zero_()
    return model


def params_from_jax(params_numpy: dict, config: FrcnnConfig,
                    dtype=torch.float32, device="cuda"
                    ) -> FasterRCNNProposer:
    """A model holding the JAX package's parameters (numpy arrays of its
    tree: HWIO conv weights become OIHW)."""
    values = {name: (np.asarray(a).transpose(3, 2, 0, 1)
                     if np.ndim(a) == 4 else a)
              for name, a in tree_values(params_numpy).items()}
    return fill_parameters(
        empty_module(lambda: FasterRCNNProposer(config), dtype, device),
        values)


def flatten_levels(levels) -> torch.Tensor:
    """``FasterRCNNProposer.forward``'s level outputs as one flat tensor:
    each level's objectness, then its deltas, P2..P6 (``level_shapes``
    splits it)."""
    return torch.cat([t.reshape(-1) for level in levels for t in level])


def level_shapes(config: FrcnnConfig, batch: int = 1) -> list:
    """The shapes ``FasterRCNNProposer.forward`` returns at
    ``config.input_size``: per level P2..P6 (stride 4 to 64), (objectness,
    deltas)."""
    A = len(config.anchor_ratios)
    sides = [config.input_size // 4 // 2 ** level
             for level in range(len(config.anchor_sizes))]
    return [((batch, side, side, A), (batch, side, side, 4 * A))
            for side in sides]


def split_levels(flat, config: FrcnnConfig) -> list:
    """``flatten_levels``' one vector (numpy or torch, batch of one) back
    into per level (objectness, deltas) of ``level_shapes``."""
    levels, start = [], 0
    for shapes in level_shapes(config):
        pair = []
        for shape in shapes:
            n = int(np.prod(shape))
            pair.append(flat[start:start + n].reshape(shape))
            start += n
        levels.append(pair)
    return levels


def decode_proposals(outputs, config: FrcnnConfig
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Anchors + deltas → (N, 4) xyxy proposals and (N,) objectness scores
    for image 0 (torchvision RPN decode: dx,dy scale the anchor center,
    dw,dh exponentiate its size)."""
    boxes, scores = [], []
    for (obj, deltas), size in zip(outputs, config.anchor_sizes):
        obj = np.asarray(obj)[0]
        deltas = np.asarray(deltas)[0]
        H, W, A = obj.shape
        stride = config.input_size / H
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        cx = (xs + 0.5) * stride
        cy = (ys + 0.5) * stride
        for a, ratio in enumerate(config.anchor_ratios):
            aw = size * np.sqrt(1.0 / ratio)
            ah = size * np.sqrt(ratio)
            d = deltas[:, :, 4 * a:4 * a + 4]
            pcx = cx + d[:, :, 0] * aw
            pcy = cy + d[:, :, 1] * ah
            pw = aw * np.exp(np.minimum(d[:, :, 2], 4.0))
            ph = ah * np.exp(np.minimum(d[:, :, 3], 4.0))
            level_boxes = np.stack([pcx - pw / 2, pcy - ph / 2,
                                    pcx + pw / 2, pcy + ph / 2], axis=-1)
            boxes.append(level_boxes.reshape(-1, 4))
            # clamp logits before sigmoid: raw RPN objectness can be very
            # negative and np.exp(-x) would overflow (harmless but noisy)
            logit = np.clip(obj[:, :, a].reshape(-1), -30.0, 30.0)
            scores.append(1.0 / (1.0 + np.exp(-logit)))
    return np.concatenate(boxes, axis=0), np.concatenate(scores, axis=0)
