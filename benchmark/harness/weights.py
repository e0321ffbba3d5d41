"""Random weights made on the card from the seed, in a few large calls, in
the served dtype (bf16), and written as one safetensors file.

Every matrix, bias and embedding is N(0, 0.02^2); a layer norm's scale is
1 + 0.02 n and its shift 0.02 n. Names whose last part is ``weight`` under
a ``LayerNorm``/``layer_norm``/``layrnorm``/``layernorm`` module are the
scales.
"""

import math
import os

NORM_PARTS = ("LayerNorm", "layer_norm", "layrnorm", "layernorm")


def _is_norm_scale(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] == "weight" and any(p in parts[-2] for p in NORM_PARTS)


def draw(shapes, seed: int, device) -> dict:
    """{name: bf16 tensor on the host} for ``shapes`` [(name, shape)]."""
    import torch
    sizes = [math.prod(shape) for _, shape in shapes]
    generator = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=torch.bfloat16).mul_(0.02)
    host = flat.cpu()
    out, start = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        tensor = host[start:start + size].view(shape).clone()
        if _is_norm_scale(name):
            tensor += 1
        out[name] = tensor
        start += size
    return out


def save(state_dict: dict, directory: str) -> None:
    from safetensors.torch import save_file
    save_file(state_dict, os.path.join(directory, "model.safetensors"),
              metadata={"format": "pt"})
