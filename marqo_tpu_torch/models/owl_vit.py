"""OWL-ViT open-vocabulary detector in PyTorch: the image reranker's scoring
model (port of marqo_tpu/models/owl_vit.py).

The reference reranks image results with OWL-ViT
(s2_inference/reranking/rerank.py:12-54 dispatches on 'owl' in the model
name; cross_encoders.py:341-461 ReRankerOwl runs google/owlvit-* per hit
and overwrites ``_score``/``_highlights`` with the best box's score and
its rescaled box).

Architecture (transformers OwlViTForObjectDetection):
  - CLIP text tower (causal, EOS-pooled, text projection) → query embeds;
    models/clip.py's ``CLIPTextTower`` in plain torch;
  - CLIP vision tower (models/clip.py's ``CLIPVisionTower.tokens``: its
    blocks run CUDA kernel B2's no-mask mode on a CUDA device, the plain
    twin on the CPU), over the real 577 tokens of a 768 px image at patch
    32: unlike the JAX package, the token axis is not padded to a multiple
    of 8; then a post-LN over ALL tokens, the patch tokens multiplied by
    the class token, and a merge LayerNorm → per-patch features;
  - class head, fp32: dense0 → cosine logits against the L2-normalized
    queries, plus shift(feats), times elu(scale(feats)) + 1;
  - box head, fp32: a 3-layer exact-GELU MLP plus the grid's logit bias →
    sigmoid cxcywh boxes.
The heads run in plain torch (the JAX package computes them in XLA).

``params_from_hf_owlvit`` converts a transformers checkpoint into the JAX
package's layout (numpy), and ``params_from_jax`` builds the module from
that layout.
"""

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from marqo_tpu_torch.models.bert import (empty_module, fill_parameters,
                                         random_init)
from marqo_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextTower,
                                         CLIPVisionConfig, CLIPVisionTower,
                                         _f32, _numpy_state_dict,
                                         _vision_values, params_from_hf_clip,
                                         text_values)
from marqo_tpu_torch.ops.common import layer_norm


@dataclass(frozen=True)
class OwlViTConfig:
    text: CLIPTextConfig
    vision: CLIPVisionConfig

    @staticmethod
    def base_patch32() -> "OwlViTConfig":
        # google/owlvit-base-patch32: 768px images, 24x24 patch grid
        return OwlViTConfig(
            text=CLIPTextConfig(vocab_size=49408, hidden_size=512,
                                num_layers=12, num_heads=8,
                                intermediate_size=2048, max_positions=16,
                                projection_dim=512),
            vision=CLIPVisionConfig(image_size=768, patch_size=32,
                                    hidden_size=768, num_layers=12,
                                    num_heads=12, intermediate_size=3072,
                                    projection_dim=512))


class OwlViT(nn.Module):
    """Both towers, the merge LayerNorm and the two heads; the module's
    dtype is the compute dtype (the heads compute in fp32)."""

    def __init__(self, config: OwlViTConfig):
        super().__init__()
        self.config = config
        Hv, P = config.vision.hidden_size, config.text.projection_dim
        self.text = CLIPTextTower(config.text)
        self.vision = CLIPVisionTower(config.vision)
        self.merge_ln = nn.LayerNorm(Hv)
        self.class_head = nn.ModuleDict({
            "dense0": nn.Linear(Hv, P), "shift": nn.Linear(Hv, 1),
            "scale": nn.Linear(Hv, 1)})
        self.box_head = nn.ModuleDict({
            "dense0": nn.Linear(Hv, Hv), "dense1": nn.Linear(Hv, Hv),
            "dense2": nn.Linear(Hv, 4)})


def compute_box_bias(n_side: int) -> torch.Tensor:
    """(P, 4) fp32 logit bias anchoring each patch's box to its grid cell
    (transformers OwlViT compute_box_bias / normalize_grid_corner_coords:
    centers at (i+1)/n with 1/n sizes, in logit space)."""
    coords = np.stack(np.meshgrid(np.arange(1, n_side + 1),
                                  np.arange(1, n_side + 1)),
                      axis=-1).astype(np.float32) / n_side
    coords = coords.reshape(-1, 2)
    coords = np.clip(coords, 0.0, 1.0)
    coord_bias = np.log(coords + 1e-4) - np.log1p(-coords + 1e-4)
    sizes = np.full_like(coords, 1.0 / n_side)
    size_bias = np.log(sizes + 1e-4) - np.log1p(-sizes + 1e-4)
    return torch.from_numpy(np.concatenate([coord_bias, size_bias], axis=-1))


@functools.lru_cache(maxsize=None)
def _box_bias(n_side: int, device: torch.device) -> torch.Tensor:
    """``compute_box_bias`` on ``device``, made once per grid and device."""
    with torch.inference_mode(False):
        return compute_box_bias(n_side).to(device)


def _image_features(model: OwlViT, pixels_u8: torch.Tensor) -> torch.Tensor:
    """(B, size, size, 3) uint8 → (B, P, H) merged per-patch features in the
    compute dtype."""
    vision = model.vision
    eps = vision.config.layer_norm_eps
    x = vision.tokens(pixels_u8)
    # post-LN over ALL tokens, patch tokens gated by the class token, then
    # the merge LayerNorm (transformers OwlViTModel.image_embedder)
    x = layer_norm(x, vision.post_ln.weight, vision.post_ln.bias, eps)
    feats = x[:, 1:, :] * x[:, :1, :]
    return layer_norm(feats, model.merge_ln.weight, model.merge_ln.bias, eps)


def _linear32(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.float(), layer.bias.float())


def detect(model: OwlViT, pixels_u8: torch.Tensor, input_ids: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, P, Q) fp32, boxes (B, P, 4) cxcywh in [0, 1]);
    the Q queries are shared by every image (the reranking shape).

    transformers OwlViTForObjectDetection forward: class_predictor cosine
    logits with per-patch shift/scale; box_predictor MLP + grid bias."""
    vision = model.config.vision
    feats32 = _image_features(model, pixels_u8).float()

    # queries: (Q, proj) via the CLIP text tower, L2-normalized
    query = model.text(input_ids)
    query = query / torch.linalg.vector_norm(
        query, dim=-1, keepdim=True).clamp_min(1e-6)

    ch = model.class_head
    class_embeds = _linear32(ch.dense0, feats32)
    class_embeds = class_embeds / torch.linalg.vector_norm(
        class_embeds, dim=-1, keepdim=True).clamp_min(1e-6)
    logits = torch.einsum("bpd,qd->bpq", class_embeds, query)
    shift = _linear32(ch.shift, feats32)
    scale = F.elu(_linear32(ch.scale, feats32)) + 1.0
    logits = (logits + shift) * scale

    bh = model.box_head
    h = F.gelu(_linear32(bh.dense0, feats32), approximate="none")
    h = F.gelu(_linear32(bh.dense1, h), approximate="none")
    raw = _linear32(bh.dense2, h)
    n_side = vision.image_size // vision.patch_size
    boxes = torch.sigmoid(raw + _box_bias(n_side, raw.device)[None])
    return logits, boxes


# --- init + conversion -------------------------------------------------------

def init_owl_params(config: OwlViTConfig, generator: torch.Generator,
                    dtype=torch.float32, device="cuda") -> OwlViT:
    """Random-init model (normal(0, 0.02) weights and embeddings, zero
    biases, unit LayerNorm scales), drawn from ``generator`` on
    ``device``."""
    return random_init(empty_module(lambda: OwlViT(config), dtype, device),
                       generator)


def params_from_hf_owlvit(state_dict, config: OwlViTConfig) -> dict:
    """Convert a transformers OwlViTForObjectDetection state_dict into the
    JAX package's layout (numpy float32)."""
    sd = {}
    for key, value in _numpy_state_dict(state_dict).items():
        if key.startswith("owlvit."):
            key = key[len("owlvit."):]
        sd[key] = value
    params = params_from_hf_clip(sd, config.text, config.vision)

    def arr(name, transpose=False):
        a = sd[name]
        return _f32(a.T if transpose else a)

    params["merge_ln_scale"] = arr("layer_norm.weight")
    params["merge_ln_bias"] = arr("layer_norm.bias")
    params["class_head"] = {
        "dense0_w": arr("class_head.dense0.weight", True),
        "dense0_b": arr("class_head.dense0.bias"),
        "shift_w": arr("class_head.logit_shift.weight", True),
        "shift_b": arr("class_head.logit_shift.bias"),
        "scale_w": arr("class_head.logit_scale.weight", True),
        "scale_b": arr("class_head.logit_scale.bias"),
    }
    params["box_head"] = {
        "w0": arr("box_head.dense0.weight", True),
        "b0": arr("box_head.dense0.bias"),
        "w1": arr("box_head.dense1.weight", True),
        "b1": arr("box_head.dense1.bias"),
        "w2": arr("box_head.dense2.weight", True),
        "b2": arr("box_head.dense2.bias"),
    }
    return params


def params_from_jax(params_numpy: dict, config: OwlViTConfig,
                    dtype=torch.float32, device="cuda") -> OwlViT:
    """A model holding parameters in the JAX package's layout, given as
    numpy arrays: the JAX package's own params, or
    ``params_from_hf_owlvit``'s output. (in, out) weights become
    ``nn.Linear``'s (out, in)."""
    ch, bh = params_numpy["class_head"], params_numpy["box_head"]
    values = {
        **text_values("text.", params_numpy["text"], config.text.num_layers),
        **_vision_values("vision.", params_numpy["vision"],
                         config.vision.num_layers),
        "merge_ln.weight": params_numpy["merge_ln_scale"],
        "merge_ln.bias": params_numpy["merge_ln_bias"],
    }
    for name, w, b in (("class_head.dense0", "dense0_w", "dense0_b"),
                       ("class_head.shift", "shift_w", "shift_b"),
                       ("class_head.scale", "scale_w", "scale_b")):
        values[f"{name}.weight"] = np.asarray(ch[w]).T
        values[f"{name}.bias"] = ch[b]
    for i in range(3):
        values[f"box_head.dense{i}.weight"] = np.asarray(bh[f"w{i}"]).T
        values[f"box_head.dense{i}.bias"] = bh[f"b{i}"]
    model = empty_module(lambda: OwlViT(config), dtype, device)
    return fill_parameters(model, values)


def model_from_hf_owlvit(state_dict, config: OwlViTConfig,
                         dtype=torch.float32, device="cuda") -> OwlViT:
    """The module from a transformers OwlViTForObjectDetection
    state_dict."""
    return params_from_jax(params_from_hf_owlvit(state_dict, config), config,
                           dtype=dtype, device=device)
