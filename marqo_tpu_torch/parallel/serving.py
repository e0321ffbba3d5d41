"""Process-wide serving mesh: multi-device data-parallel inference (port of
marqo_tpu/parallel/serving.py).

When the process sees more than one CUDA device, every loaded embedding
model places a replica of its module on each data-parallel group of a
(dp, tp) mesh (parallel/mesh.py) and splits each encode batch across the
groups, so ``vectorise()`` / ``add_documents`` / ``search`` use every
device. The float BERT encoder also splits its heads and FFN over each
group's tp devices (parallel/encode.py); every other module replicates
whole. Everything runs in one process: a group's launches are issued in
turn from the caller's thread, and the outputs are gathered on the mesh's
lead device.

Activation:
  - auto: more than one CUDA device;
  - MARQO_TPU_SERVING_MESH=TRUE forces it on. With fewer devices than
    MARQO_TPU_MESH_SHAPE asks for, the mesh cycles over the devices there
    are: a virtual mesh (one card repeated; on a host without CUDA, the
    CPU repeated, as the tests run it);
  - MARQO_TPU_SERVING_MESH=FALSE forces single-device serving.
Mesh shape comes from MARQO_TPU_MESH_SHAPE ("dp,tp"), default all-dp.
"""

import copy
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from marqo_tpu_torch.api import configs
from marqo_tpu_torch.logging import get_logger
from marqo_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_TP, Mesh,
                                           create_mesh, mesh_shape_from_env,
                                           shard_params, split_batch)

logger = get_logger(__name__)

_mesh_lock = threading.Lock()
_mesh: Optional[Mesh] = None
_mesh_resolved = False


def serving_mesh() -> Optional[Mesh]:
    """The process-wide serving mesh, or None for single-device serving."""
    global _mesh, _mesh_resolved
    if _mesh_resolved:
        return _mesh
    with _mesh_lock:
        if _mesh_resolved:
            return _mesh
        _mesh = _build_mesh()
        _mesh_resolved = True
        return _mesh


def _build_mesh() -> Optional[Mesh]:
    forced = configs.read_env_vars_and_defaults("MARQO_TPU_SERVING_MESH")
    forced = None if forced is None else str(forced).upper()
    if forced == "FALSE":
        return None
    if torch.cuda.is_available():
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    shape = mesh_shape_from_env()
    if forced == "TRUE" and shape is not None and \
            shape[0] * shape[1] > len(devices):
        # a virtual mesh: the devices there are, each repeated
        if (shape[0] * shape[1]) % len(devices):
            raise ValueError(f"Mesh shape {shape} does not cycle evenly "
                             f"over {len(devices)} devices")
        logger.warning(
            f"MARQO_TPU_SERVING_MESH=TRUE asks for a {shape} mesh over "
            f"{len(devices)} device(s): a virtual mesh, each device "
            f"repeated, which serves slower than one device would")
        devices = [devices[i % len(devices)]
                   for i in range(shape[0] * shape[1])]
    if len(devices) < 2:
        return None
    if devices[0].type == "cpu" and forced != "TRUE":
        # the CPU: only shard when a test explicitly asks
        return None
    mesh = create_mesh(devices, shape)
    logger.info(f"Serving mesh active: {mesh.shape} over "
                f"{len(set(devices))} {devices[0].type} device(s)")
    return mesh


def reset_serving_mesh() -> None:
    """Drop the cached mesh (tests toggle MARQO_TPU_SERVING_MESH)."""
    global _mesh, _mesh_resolved
    with _mesh_lock:
        _mesh = None
        _mesh_resolved = False


def dp_size(mesh: Mesh) -> int:
    return mesh.shape[AXIS_DP]


def indexed_device(device) -> torch.device:
    """``device`` with its index: the wrappers serve on
    ``torch.device("cuda")``, which never equals the mesh's ``cuda:i``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def place_params(module: nn.Module, mesh: Mesh) -> list:
    """One replica of ``module`` per data-parallel group, on the group's
    first device (the same object where that device is ``module``'s own).

    The float BERT encoder (models/bert.py ``TextEncoder`` without
    ``quantize``) splits over each group's tp devices when tp > 1
    (parallel/mesh.py ``shard_params``); any other module replicates whole:
    the int8 encoder, Stella and every CLIP-family tower. That is the JAX
    package's replicated fallback, chosen here by type."""
    from marqo_tpu_torch.models.bert import TextEncoder
    if mesh.shape[AXIS_TP] > 1 and type(module) is TextEncoder and \
            not module.config.quantize:
        return shard_params(module, mesh)
    built = {next(module.parameters()).device: module}
    replicas = []
    for group in mesh.groups():
        if group[0] not in built:
            built[group[0]] = copy.deepcopy(module).to(group[0])
        replicas.append(built[group[0]])
    return replicas


_UNRESOLVED = object()


def model_mesh(model) -> Optional[Mesh]:
    """Resolve (and cache on the model) the serving mesh for any wrapper:
    the process mesh applies when it spans the model's device. Lets every
    model family join multi-device serving without each __init__ knowing
    about meshes."""
    mesh = getattr(model, "_mesh", _UNRESOLVED)
    if mesh is _UNRESOLVED:
        mesh = serving_mesh()
        if mesh is not None and indexed_device(model._device) not in \
                set(mesh.devices.flat):
            mesh = None
        model._mesh = mesh
    return mesh


def put_params(model, module: nn.Module) -> nn.Module:
    """Module placement for a wrapper: over the serving mesh when active
    (the replicas kept on the model, the lead group's returned), else
    ``module`` as it is, on the model's device."""
    mesh = model_mesh(model)
    if mesh is None:
        return module
    model._replicas = place_params(module, mesh)
    return model._replicas[0]


def replicas(model) -> list:
    """The model's modules: one per data-parallel group under a mesh, else
    its one ``encoder``."""
    if model_mesh(model) is None:
        return [model.encoder]
    return model._replicas


def map_data_parallel(model, fn: Callable, *host_arrays) -> list:
    """``fn(module, *tensors)`` over the model's data-parallel groups:
    each array's leading axis split into dp equal parts, part g on group
    g's device through its replica, launches issued in turn from this
    thread; the outputs (tensors or tuples of them) come back on the lead
    device, in group order. Without a mesh: one call on the model's
    device with the whole arrays."""
    mesh = model_mesh(model)
    if mesh is None:
        return [fn(model.encoder, *(_to(a, model._device)
                                    for a in host_arrays))]
    outs = [fn(replica, *parts) for replica, parts in
            zip(model._replicas, split_batch(mesh, *host_arrays))]
    return [_to(out, mesh.lead) for out in outs]


def run_data_parallel(model, fn: Callable, *host_arrays) -> torch.Tensor:
    """``map_data_parallel``'s outputs concatenated on the lead device."""
    outs = map_data_parallel(model, fn, *host_arrays)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _to(value, device: torch.device):
    if isinstance(value, tuple):
        return tuple(_to(v, device) for v in value)
    if torch.is_tensor(value):
        return value.to(device)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device)


def round_up_to_dp(bucket: int, mesh: Optional[Mesh]) -> int:
    """Batch buckets must divide across dp. Buckets are powers of two, and
    so are the usual dp degrees, so any bucket ≥ dp already divides;
    smaller buckets (query path, batch 1) round up to one row per group."""
    if mesh is None:
        return bucket
    dp = dp_size(mesh)
    if bucket % dp == 0:
        return bucket
    return ((bucket + dp - 1) // dp) * dp
