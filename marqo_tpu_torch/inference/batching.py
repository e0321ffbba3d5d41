"""(batch, seq) bucketing of encoder batches.

Port of marqo_tpu/inference/batching.py, which padded every encode to a
bucket from a small fixed grid so that XLA compiled each shape once. The
port keeps the same grid (same env vars), so both packages run the same
shapes: large batches fill the device, and the kernels see a bounded set
of shapes. This replaces the reference's fixed torch batch=16 loop
(s2_inference.py:123-158, MARQO_MAX_VECTORISE_BATCH_SIZE).
"""

from typing import Iterator, List, Sequence, Tuple

from marqo_tpu_torch.api import configs


def _buckets(var: str) -> List[int]:
    vals = [int(v) for v in configs.read_env_vars_and_defaults_list(var)]
    return sorted(set(vals))


def seq_buckets() -> List[int]:
    return _buckets("MARQO_TPU_COMPILE_BUCKETS")


def batch_buckets() -> List[int]:
    return _buckets("MARQO_TPU_BATCH_BUCKETS")


def pick_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ value (largest bucket if value exceeds all)."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def pick_seq_bucket(max_len: int) -> int:
    return pick_bucket(max_len, seq_buckets())


def pick_batch_bucket(n: int) -> int:
    return pick_bucket(n, batch_buckets())


def row_buckets() -> List[int]:
    """Row-count grid for sequence-packed batches (ops/packing.py). Packed
    row counts track the token mass of a request, which varies batch to
    batch; padding rows to a coarse ladder (≤ ~15% waste) keeps the XLA
    compile cache hot in steady state instead of recompiling per row count."""
    return _buckets("MARQO_TPU_ROW_BUCKETS")


def pick_row_bucket(n: int) -> int:
    """Smallest ladder entry ≥ n; beyond the ladder, the next multiple of
    the top entry (NEVER clamps — a packed batch sized by this must hold
    every row, matching ops/packing.py's overflow rule)."""
    ladder = row_buckets()
    top = ladder[-1]
    if n > top:
        return ((n + top - 1) // top) * top
    return pick_bucket(n, ladder)


def graphs_for(model):
    """The model's CUDA graphs (inference/graphs.py ``EncoderGraphs``, its
    ``graphs``) where its batches replay them: a model on a CUDA device
    without a serving mesh. None elsewhere: on the CPU, and under a serving
    mesh, batches run the eager forward."""
    from marqo_tpu_torch.parallel.serving import model_mesh
    if model._device.type != "cuda" or model_mesh(model) is not None:
        return None
    return model.graphs


def card_graphs(graphs):
    """``graphs`` (an ``EncoderGraphs``) where it lives on a CUDA device,
    else None: ``graphs_for``'s rule for the callers that hold one module
    outside the serving mesh: the DINO, YOLOX and Faster R-CNN patchers,
    the cross-encoder and OWL rerankers, and LanguageBind, which stays on
    its one device under a mesh."""
    return graphs if graphs.device.type == "cuda" else None


def tower_encode(model, array, tower: str, pad_value=0):
    """``model.encoder``'s ``tower`` ("text" or "vision") over ``array`` in
    batch buckets (``batched_device_encode``), each bucket through the
    model's graph of the tower keyed by the tower's config: the CLIP-family
    wrappers' ``_run``."""
    import torch
    module = getattr(model.encoder, tower)
    with torch.inference_mode():
        return batched_device_encode(
            model, array, lambda encoder, x: getattr(encoder, tower)(x),
            pad_value, graph=tower, static=(module.config,))


def batched_device_encode(model, array, forward, pad_value=0, graph=None,
                          static=()):
    """Pad ``array`` rows to batch buckets (``pad_value``: a scalar or one
    row), launch EVERY device batch through ``forward(module, padded)``
    with ``model``'s module, then copy all outputs to the host at once
    (launches are asynchronous, so batch i+1's host-side padding overlaps
    batch i's compute — the ingest-path pattern from
    loaders._dispatch_padded). With a tower name ``graph`` (and the
    ``static`` values the forward depends on), each batch replays the
    model's CUDA graph of (tower, bucket shape) where ``graphs_for`` gives
    one; without, or where it gives none, the forward runs eagerly. Under a
    serving mesh each bucket rounds up to a dp multiple and splits across
    the data-parallel groups, each through its replica
    (parallel/serving.py). Returns the concatenated rows as numpy."""
    import numpy as np
    import torch

    from marqo_tpu_torch.parallel.serving import (model_mesh, round_up_to_dp,
                                                  run_data_parallel)
    graphs = graphs_for(model) if graph is not None else None
    n = array.shape[0]
    bucket = round_up_to_dp(pick_batch_bucket(n), model_mesh(model))
    pending = []
    start = 0
    while start < n:
        size = min(bucket, n - start)
        padded = np.full((bucket,) + array.shape[1:], pad_value,
                         dtype=array.dtype)
        padded[:size] = array[start:start + size]
        if graphs is None:
            out = run_data_parallel(model, forward, padded)
        else:
            out = graphs.run(graph, model.compute_dtype,
                             lambda x: forward(model.encoder, x), padded,
                             static=static)
        pending.append((out, size))
        start += size
    # one device-to-host copy after all launches
    return torch.cat([out[:size] for out, size in pending]).cpu().numpy()


def iter_batches(n_items: int, max_batch: int) -> Iterator[Tuple[int, int]]:
    """Yield (start, size) chunks of at most max_batch items."""
    start = 0
    while start < n_items:
        size = min(max_batch, n_items - start)
        yield start, size
        start += size


def generate_batches(seq: List, batch_size: int) -> Iterator[List]:
    """Parity helper (reference tensor_search/utils.py:334 generate_batches)."""
    if batch_size <= 0:
        from marqo_tpu_torch.exceptions import InvalidArgumentError
        raise InvalidArgumentError("Batch size must be greater than 0")
    for start, size in iter_batches(len(seq), batch_size):
        yield seq[start:start + size]
