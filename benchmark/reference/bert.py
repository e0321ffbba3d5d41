"""A plain BERT encoder with mean pooling (e5-base-v2), in float32.

Post-layer-norm BERT as published (Devlin et al. 2019; transformers'
``BertModel``): word, position and token-type embeddings, a layer norm,
then per layer self-attention over the unpadded keys, a residual and a
layer norm, an erf-GELU feed-forward, a residual and a layer norm. The
sentence vector is the mean over the real tokens, L2-normalised. Reads an
HF-format state dict; no cache, no packing, no kernels.
"""

import math

import torch

from reference.precision import linear


def load(state_dict: dict, device) -> dict:
    """float32 copies on ``device`` of the tensors, "bert." prefix dropped."""
    out = {}
    for key, value in state_dict.items():
        key = key[len("bert."):] if key.startswith("bert.") else key
        out[key] = value.to(device=device, dtype=torch.float32)
    return out


def _layer_norm(x, p, name, eps):
    return torch.nn.functional.layer_norm(
        x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def encode(p: dict, config: dict, ids: torch.Tensor, mask: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    """(B, S) token ids and 0/1 mask -> (B, hidden) unit vectors."""
    B, S = ids.shape
    H, N = config["hidden_size"], config["num_attention_heads"]
    D, eps = H // N, config["layer_norm_eps"]
    x = (p["embeddings.word_embeddings.weight"][ids]
         + p["embeddings.position_embeddings.weight"][:S][None]
         + p["embeddings.token_type_embeddings.weight"][0])
    x = _layer_norm(x, p, "embeddings.LayerNorm", eps)
    key_bias = (1.0 - mask[:, None, None, :].float()) * -1e30
    for i in range(config["num_hidden_layers"]):
        pre = f"encoder.layer.{i}."

        def dense(h, name):
            return linear(h, p[pre + name + ".weight"], p[pre + name + ".bias"],
                          precision)

        def heads(h):
            return h.view(B, S, N, D).transpose(1, 2)

        q = heads(dense(x, "attention.self.query"))
        k = heads(dense(x, "attention.self.key"))
        v = heads(dense(x, "attention.self.value"))
        scores = q @ k.transpose(-1, -2) / math.sqrt(D) + key_bias
        ctx = (scores.softmax(-1) @ v).transpose(1, 2).reshape(B, S, H)
        x = _layer_norm(x + dense(ctx, "attention.output.dense"), p,
                        pre + "attention.output.LayerNorm", eps)
        h = torch.nn.functional.gelu(dense(x, "intermediate.dense"))
        x = _layer_norm(x + dense(h, "output.dense"), p,
                        pre + "output.LayerNorm", eps)
    m = mask.float()[..., None]
    pooled = (x * m).sum(1) / m.sum(1).clamp_min(1.0)
    return torch.nn.functional.normalize(pooled, dim=-1)


def flops(config: dict, length: int) -> float:
    """Model operations of one forward over ``length`` tokens (a
    multiply-add is 2): the six linear layers and attention's two
    products, per layer."""
    H, F = config["hidden_size"], config["intermediate_size"]
    per_layer = 2 * length * (4 * H * H + 2 * H * F) + 4 * length * length * H
    return float(config["num_hidden_layers"] * per_layer)
