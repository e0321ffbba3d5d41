"""Plain CLIP towers (open_clip ViT-L-14), in float32.

Vision (Dosovitskiy et al. 2021; Radford et al. 2021): a patch convolution
without bias, the class token, learned positions, a layer norm, pre-norm
blocks (attention, then an erf-GELU MLP), a layer norm on the class token
and the projection. Text: token and position embeddings, pre-norm blocks
under a causal mask, a final layer norm at the first end token and the
projection. Both outputs are L2-normalised. Reads an HF-format
``CLIPModel`` state dict; no cache, no batching, no kernels.
"""

import math

import torch

from reference.precision import linear

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def load(state_dict: dict, device) -> dict:
    return {k: v.to(device=device, dtype=torch.float32)
            for k, v in state_dict.items()}


def _ln(x, p, name, eps):
    return torch.nn.functional.layer_norm(
        x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def _blocks(x, p, prefix, layers, heads, eps, causal, precision):
    B, S, H = x.shape
    D = H // heads
    bias = None
    if causal:
        bias = torch.full((S, S), -1e30, device=x.device).triu(1)
    for i in range(layers):
        pre = f"{prefix}.{i}."

        def dense(h, name):
            return linear(h, p[pre + name + ".weight"], p[pre + name + ".bias"],
                          precision)

        def split(h):
            return h.view(B, S, heads, D).transpose(1, 2)

        h = _ln(x, p, pre + "layer_norm1", eps)
        q, k, v = (split(dense(h, f"self_attn.{n}_proj")) for n in "qkv")
        scores = q @ k.transpose(-1, -2) / math.sqrt(D)
        if bias is not None:
            scores = scores + bias
        ctx = (scores.softmax(-1) @ v).transpose(1, 2).reshape(B, S, H)
        x = x + dense(ctx, "self_attn.out_proj")
        h = _ln(x, p, pre + "layer_norm2", eps)
        h = torch.nn.functional.gelu(dense(h, "mlp.fc1"))
        x = x + dense(h, "mlp.fc2")
    return x


def encode_images(p: dict, config: dict, pixels: torch.Tensor,
                  precision: str = "float32") -> torch.Tensor:
    """(B, 3, size, size) normalised pixels -> (B, embed_dim) unit vectors."""
    vision = config["vision_cfg"]
    width, patch = vision["width"], vision["patch_size"]
    eps = config["layer_norm_eps"]
    w = p["vision_model.embeddings.patch_embedding.weight"]
    B = pixels.shape[0]
    grid = pixels.shape[-1] // patch
    cols = pixels.view(B, 3, grid, patch, grid, patch).permute(
        0, 2, 4, 1, 3, 5).reshape(B, grid * grid, 3 * patch * patch)
    x = linear(cols, w.reshape(width, -1), None, precision)
    cls = p["vision_model.embeddings.class_embedding"].expand(B, 1, width)
    x = torch.cat([cls, x], dim=1) + \
        p["vision_model.embeddings.position_embedding.weight"][None]
    x = _ln(x, p, "vision_model.pre_layrnorm", eps)
    x = _blocks(x, p, "vision_model.encoder.layers", vision["layers"],
                width // vision["head_width"], eps, False, precision)
    pooled = _ln(x[:, 0], p, "vision_model.post_layernorm", eps)
    out = linear(pooled, p["visual_projection.weight"], None, precision)
    return torch.nn.functional.normalize(out, dim=-1)


def encode_texts(p: dict, config: dict, ids: torch.Tensor, eos_id: int,
                 precision: str = "float32") -> torch.Tensor:
    """(B, context) ids, each with an end token -> (B, embed_dim) unit
    vectors."""
    text = config["text_cfg"]
    eps = config["layer_norm_eps"]
    B, S = ids.shape
    x = (p["text_model.embeddings.token_embedding.weight"][ids]
         + p["text_model.embeddings.position_embedding.weight"][:S][None])
    x = _blocks(x, p, "text_model.encoder.layers", text["layers"],
                text["heads"], eps, True, precision)
    end = (ids == eos_id).int().argmax(dim=-1)
    pooled = _ln(x[torch.arange(B, device=x.device), end], p,
                 "text_model.final_layer_norm", eps)
    out = linear(pooled, p["text_projection.weight"], None, precision)
    return torch.nn.functional.normalize(out, dim=-1)


def _tower_flops(layers: int, width: int, mlp: int, length: int,
                 attended_pairs: float) -> float:
    per_layer = 2 * length * (4 * width * width + 2 * width * mlp) + \
        4 * attended_pairs * width
    return layers * per_layer


def image_flops(config: dict) -> float:
    """Model operations of the vision tower on one image (a multiply-add
    is 2): the patch embedding, the blocks and the projection."""
    v = config["vision_cfg"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    width = v["width"]
    return float(2 * n * 3 * v["patch_size"] ** 2 * width
                 + _tower_flops(v["layers"], width, int(width * v["mlp_ratio"]),
                                n + 1, (n + 1) ** 2)
                 + 2 * width * config["embed_dim"])


def text_flops(config: dict, length: int) -> float:
    """Model operations of the text tower over the ``length`` tokens up to
    and with the end token: causal attention attends to half the pairs,
    and no later token changes the end token's output."""
    t = config["text_cfg"]
    width = t["width"]
    return float(_tower_flops(t["layers"], width, int(width * t["mlp_ratio"]),
                              length, length * (length + 1) / 2)
                 + 2 * width * config["embed_dim"])
