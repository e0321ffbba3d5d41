"""Device mesh and sharding layout for multi-device serving and fine-tuning
(port of marqo_tpu/parallel/mesh.py).

A (dp, tp) grid of ``torch.device``s in one process:

  - ``dp`` (data parallel): batches of documents or queries split across
    the groups, one replica of the model per group;
  - ``tp`` (tensor parallel): the BERT encoder's attention heads and FFN
    columns split across the devices of a group, Megatron style
    (parallel/encode.py), with the partial products summed on the group's
    first device where the JAX package lets XLA insert a psum.

A device may repeat in the grid: a *virtual* mesh, which runs every shard
on one card (the counterpart of the JAX tests' virtual CPU devices).
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.api import configs

AXIS_DP = "dp"
AXIS_TP = "tp"


class Mesh:
    """A (dp, tp) array of devices: row g is data-parallel group g, whose
    first device leads it; ``devices[0, 0]`` leads the mesh."""

    def __init__(self, devices: Sequence[torch.device], dp: int, tp: int):
        self.devices = np.empty((dp, tp), dtype=object)
        for i, device in enumerate(devices):
            self.devices[i // tp, i % tp] = torch.device(device)
        self.shape = {AXIS_DP: dp, AXIS_TP: tp}

    @property
    def lead(self) -> torch.device:
        return self.devices[0, 0]

    def groups(self) -> list:
        """The data-parallel groups, each the tuple of its tp devices."""
        return [tuple(row) for row in self.devices]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def mesh_shape_from_env() -> Optional[Tuple[int, int]]:
    """MARQO_TPU_MESH_SHAPE ("dp,tp"), or None when unset."""
    env = configs.read_env_vars_and_defaults("MARQO_TPU_MESH_SHAPE")
    if not env:
        return None
    dp, tp = (int(x) for x in str(env).split(","))
    return dp, tp


def create_mesh(devices: Optional[Sequence[torch.device]] = None,
                shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """Build a (dp, tp) mesh over ``devices`` (default: every CUDA device).
    ``shape`` defaults to MARQO_TPU_MESH_SHAPE or all-data-parallel
    (n, 1). A device listed more than once gives a virtual mesh."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if shape is None:
        shape = mesh_shape_from_env() or (n, 1)
    dp, tp = shape
    if dp * tp != n:
        raise ValueError(f"Mesh shape {shape} does not match {n} devices")
    return Mesh(devices, dp, tp)


def batch_spec() -> int:
    """Activations: the dim that splits over dp (the batch); everything
    else follows the tp rules of ``encoder_param_specs``."""
    return 0


# an EncoderLayer's parameters → the dim split over tp (nn.Linear holds
# (out, in), the JAX package (in, out), so the dims are flipped against
# its PartitionSpecs): q, k, v and ffn_in split their output features,
# attn_out and ffn_out their input features, so each block needs one sum
# over the tp group per residual branch; their biases and LayerNorms
# replicate
_LAYER_SPECS = {
    "query.weight": 0, "query.bias": 0,
    "key.weight": 0, "key.bias": 0,
    "value.weight": 0, "value.bias": 0,
    "attn_out.weight": 1, "attn_out.bias": None,
    "attn_ln.weight": None, "attn_ln.bias": None,
    "ffn_in.weight": 0, "ffn_in.bias": 0,
    "ffn_out.weight": 1, "ffn_out.bias": None,
    "ffn_ln.weight": None, "ffn_ln.bias": None,
}


def encoder_param_specs(encoder: nn.Module) -> dict:
    """For each parameter of the float BERT encoder (models/bert.py
    ``TextEncoder``), by name, the dim that splits over tp, or None where
    it replicates (embeddings, LayerNorms, the output biases). Raises
    KeyError for a parameter outside that layout (an int8 encoder holds
    buffers and a packed ``qkv``; other architectures other names)."""
    specs = {}
    for name, _ in (*encoder.named_parameters(), *encoder.named_buffers()):
        if name.startswith("embeddings."):
            specs[name] = None
            continue
        prefix, _, rest = name.split(".", 2)
        if prefix != "layers" or rest not in _LAYER_SPECS:
            raise KeyError(f"{name} is not a parameter of the BERT layout")
        specs[name] = _LAYER_SPECS[rest]
    if not specs:
        raise KeyError("the module has no parameters")
    return specs


def check_tp_divides(config, tp: int) -> None:
    """Tensor parallelism splits whole heads and equal FFN slices: raise
    ValueError unless ``tp`` divides both."""
    if config.num_heads % tp or config.intermediate_size % tp:
        raise ValueError(
            f"tensor parallelism {tp} does not divide {config.num_heads} "
            f"heads and an FFN of {config.intermediate_size}")


def shard_tensors(params: dict, specs: dict, devices: Sequence[torch.device],
                  dtype: Optional[torch.dtype] = None) -> dict:
    """The tensors of a tp group's shards: ``params`` (name → tensor) split
    by ``specs`` into ``len(devices)`` contiguous parts, part r moved to
    ``devices[r]`` (and cast to ``dtype``), under the names
    ``shards.{r}.{name}``. A replicated tensor is moved once per device.
    Slicing, casting and moving are differentiable, and on a device the
    tensor is already on, in its own dtype, they return views: no copy."""
    tp = len(devices)
    moved = {}
    out = {}
    for r, device in enumerate(devices):
        for name, tensor in params.items():
            dim = specs[name]
            key = (name, device, None if dim is None else r)
            if key not in moved:
                part = tensor if dim is None else tensor.chunk(tp, dim)[r]
                moved[key] = part.to(device=device,
                                     dtype=dtype or part.dtype)
            out[f"shards.{r}.{name}"] = moved[key]
    return out


def shard_params(encoder: nn.Module, mesh: Mesh) -> list:
    """The float BERT encoder over ``mesh``: one ``ShardedTextEncoder``
    per data-parallel group (its tp shards on the group's devices); groups
    on the same devices share one."""
    from marqo_tpu_torch.parallel.encode import ShardedTextEncoder
    built = {}
    for group in mesh.groups():
        if group not in built:
            built[group] = ShardedTextEncoder.from_encoder(encoder, group)
    return [built[group] for group in mesh.groups()]


def split_batch(mesh: Mesh, *arrays) -> list:
    """Split each array's batch dim (``batch_spec``) into dp equal parts
    and move part g to group g's first device: one tuple of tensors per
    group. Raises ValueError when dp does not divide the batch (callers
    round their buckets with parallel/serving.py ``round_up_to_dp``)."""
    dp = mesh.shape[AXIS_DP]
    dim = batch_spec()
    tensors = [torch.as_tensor(np.ascontiguousarray(a))
               if isinstance(a, np.ndarray) else a for a in arrays]
    for t in tensors:
        if t.shape[dim] % dp:
            raise ValueError(f"a batch of {t.shape[dim]} does not split "
                             f"over {dp} data-parallel groups")
    parts = [t.chunk(dp, dim) for t in tensors]
    return [tuple(p[g].to(group[0]) for p in parts)
            for g, group in enumerate(mesh.groups())]
