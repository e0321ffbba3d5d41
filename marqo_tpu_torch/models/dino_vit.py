"""DINO self-supervised ViT in PyTorch: attention-map patching (port of
marqo_tpu/models/dino_vit.py).

The dino-v1/dino-v2 patch methods read the LAST block's CLS→patch
self-attention per head (reference DINO_utils.py:87-126 DINO_inference /
model.get_last_selfattention); inference/image_patching.py upsamples the
maps to pixels and thresholds them into class-less boxes.

Architecture: pre-LN ViT (patch embedding as one matmul over unfolded
patches → CLS + learned positions → blocks), gelu MLP. Blocks 1..L-1 are
models/clip.py's ``PreNormBlock`` on its vision attention (CUDA kernel B2's
no-mask mode on a CUDA device, its plain twin on the CPU). The last block
is cut short: only the CLS query row of its attention is read, so it runs
in plain torch as a (B, N, 1, S) product that rounds as the JAX package
does (scores in the compute dtype, times 1/sqrt(D) in the compute dtype,
then the softmax in fp32). B2 returns no probabilities, and its fp32
scores would move the Otsu thresholds downstream.

Checkpoints: facebookresearch/dino naming (``blocks.N.attn.qkv`` packed,
``patch_embed.proj``, ``cls_token``, ``pos_embed``) through
``params_from_dino_state_dict`` into the JAX package's layout (numpy), then
``params_from_jax``; ``init_params`` draws random weights for tests.
"""

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.models.clip import (_VISION_ATTENTION, PreNormBlock,
                                         _f32, _numpy_state_dict,
                                         block_values)
from marqo_tpu_torch.ops.common import layer_norm

# torchvision ImageNet normalization (reference DINO_utils.py:77-79)
DINO_MEAN = (0.485, 0.456, 0.406)
DINO_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class DinoViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 384       # vit_small
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6
    # "kernel": models/clip.py's vision attention (B2 on a CUDA device);
    # "plain": always the plain twin
    attention_impl: str = "kernel"

    @property
    def intermediate_size(self) -> int:
        return self.hidden_size * self.mlp_ratio

    @staticmethod
    def vit_small(patch_size: int = 16) -> "DinoViTConfig":
        return DinoViTConfig(patch_size=patch_size)

    @staticmethod
    def vit_base(patch_size: int = 16) -> "DinoViTConfig":
        return DinoViTConfig(patch_size=patch_size, hidden_size=768,
                             num_heads=12)


def cls_attention(q_cls: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, N, 1, D) and (B, N, S, D) in the compute dtype → (B, N, S) fp32:
    the CLS query's softmax over the keys, rounded as the JAX package rounds
    the whole score matrix (q.k and the 1/sqrt(D) scale in the compute
    dtype, the softmax in fp32)."""
    scale = float(1.0 / torch.tensor(math.sqrt(q_cls.shape[-1])).to(
        q_cls.dtype))
    scores = (torch.matmul(q_cls, k.transpose(-1, -2)) * scale).float()
    return torch.softmax(scores, dim=-1)[:, :, 0]


@functools.lru_cache(maxsize=None)
def _pixel_stats(device: torch.device):
    """DINO_MEAN and DINO_STD as fp32 tensors on ``device``, made once per
    device."""
    with torch.inference_mode(False):
        return (torch.tensor(DINO_MEAN, device=device),
                torch.tensor(DINO_STD, device=device))


class DinoViT(nn.Module):
    """The ViT; the module's dtype is the compute dtype."""

    def __init__(self, config: DinoViTConfig):
        super().__init__()
        H, p = config.hidden_size, config.patch_size
        n_patches = (config.image_size // p) ** 2
        self.config = config
        # (p*p*3, H) over patches laid out (p, p, 3)
        self.patch_embedding = nn.Parameter(torch.empty(p * p * 3, H))
        self.patch_bias = nn.Parameter(torch.empty(H))
        self.cls_token = nn.Parameter(torch.empty(H))
        self.position_embedding = nn.Parameter(torch.empty(n_patches + 1, H))
        self.layers = nn.ModuleList(
            PreNormBlock(H, config.intermediate_size, config.num_heads,
                         "gelu", config.layer_norm_eps)
            for _ in range(config.num_layers))
        # carried for the checkpoint; the last attention map precedes it
        self.final_ln = nn.LayerNorm(H)

    def last_selfattention(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """(B, size, size, 3) uint8 → (B, num_heads, n_side, n_side) fp32:
        the last block's CLS→patch attention per head on the patch grid
        (reference DINO_inference keeps attentions[0, :, 0, 1:])."""
        config = self.config
        B = pixels_u8.shape[0]
        size, patch = config.image_size, config.patch_size
        n_side = size // patch
        H, N = config.hidden_size, config.num_heads
        D = H // N

        mean, std = _pixel_stats(pixels_u8.device)
        x = (pixels_u8.float() / 255.0 - mean) / std
        x = x.reshape(B, n_side, patch, n_side, patch, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, n_side * n_side,
                                                patch * patch * 3)
        weight = self.patch_embedding
        x = torch.matmul(x.to(weight.dtype), weight) + self.patch_bias
        cls = self.cls_token.expand(B, 1, H)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]

        attend = _VISION_ATTENTION[config.attention_impl]
        for layer in self.layers[:-1]:
            x = layer(x, attend)

        last = self.layers[-1]
        h = layer_norm(x, last.ln1.weight, last.ln1.bias,
                       config.layer_norm_eps)
        S = h.shape[1]
        q_cls = last.q(h[:, :1]).view(B, 1, N, D).transpose(1, 2)
        k = last.k(h).view(B, S, N, D).transpose(1, 2)
        probs = cls_attention(q_cls, k)
        return probs[:, :, 1:].reshape(B, N, n_side, n_side)


# --- init + conversion -------------------------------------------------------

def init_params(config: DinoViTConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> DinoViT:
    """Random-init model (normal(0, 0.02) weights and embeddings, zero
    biases, unit LayerNorm scales), drawn from ``generator`` on
    ``device``."""
    return random_init(empty_module(lambda: DinoViT(config), dtype, device),
                       generator)


def params_from_dino_state_dict(state_dict, config: DinoViTConfig) -> dict:
    """Convert a facebookresearch/dino ViT state dict (packed qkv) into the
    JAX package's layout (numpy float32)."""
    sd = _numpy_state_dict(state_dict)
    H = config.hidden_size
    L = config.num_layers

    conv = sd["patch_embed.proj.weight"]  # (H, 3, p, p)
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, H)

    def stack(fmt, transpose=False, split=None):
        arrs = []
        for i in range(L):
            a = sd[fmt.format(i=i)]
            if split is not None:  # packed qkv: rows [q; k; v]
                a = np.split(a, 3, axis=0)[split]
            arrs.append(a.T if transpose else a)
        return _f32(np.stack(arrs))

    p = "blocks.{i}."
    layers = {
        "q_w": stack(p + "attn.qkv.weight", True, split=0),
        "q_b": stack(p + "attn.qkv.bias", split=0),
        "k_w": stack(p + "attn.qkv.weight", True, split=1),
        "k_b": stack(p + "attn.qkv.bias", split=1),
        "v_w": stack(p + "attn.qkv.weight", True, split=2),
        "v_b": stack(p + "attn.qkv.bias", split=2),
        "o_w": stack(p + "attn.proj.weight", True),
        "o_b": stack(p + "attn.proj.bias"),
        "ln1_scale": stack(p + "norm1.weight"),
        "ln1_bias": stack(p + "norm1.bias"),
        "mlp_w1": stack(p + "mlp.fc1.weight", True),
        "mlp_b1": stack(p + "mlp.fc1.bias"),
        "mlp_w2": stack(p + "mlp.fc2.weight", True),
        "mlp_b2": stack(p + "mlp.fc2.bias"),
        "ln2_scale": stack(p + "norm2.weight"),
        "ln2_bias": stack(p + "norm2.bias"),
    }
    return {
        "patch_embedding": _f32(patch_w),
        "patch_bias": _f32(sd["patch_embed.proj.bias"]),
        "cls_token": _f32(sd["cls_token"].reshape(-1)),
        "position_embedding": _f32(sd["pos_embed"][0]),
        "layers": layers,
        "final_ln_scale": _f32(sd["norm.weight"]),
        "final_ln_bias": _f32(sd["norm.bias"]),
    }


def params_from_jax(params_numpy: dict, config: DinoViTConfig,
                    dtype=torch.float32, device="cuda") -> DinoViT:
    """A model holding parameters in the JAX package's layout, given as
    numpy arrays: the JAX package's own params, or
    ``params_from_dino_state_dict``'s output."""
    model = empty_module(lambda: DinoViT(config), dtype, device)
    return fill_parameters(model, {
        "patch_embedding": params_numpy["patch_embedding"],
        "patch_bias": params_numpy["patch_bias"],
        "cls_token": params_numpy["cls_token"],
        "position_embedding": params_numpy["position_embedding"],
        "final_ln.weight": params_numpy["final_ln_scale"],
        "final_ln.bias": params_numpy["final_ln_bias"],
        **block_values("", params_numpy, config.num_layers)})


def model_from_dino_state_dict(state_dict, config: DinoViTConfig,
                               dtype=torch.float32,
                               device="cuda") -> DinoViT:
    """The module from a facebookresearch/dino ViT state dict."""
    return params_from_jax(params_from_dino_state_dict(state_dict, config),
                           config, dtype=dtype, device=device)
