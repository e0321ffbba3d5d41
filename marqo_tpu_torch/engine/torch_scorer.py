"""Exact vector scoring on the CUDA device for the store engine (port of
marqo_tpu/engine/jax_scorer.py, in plain PyTorch).

The exact (``approximate=False``) path scores every chunk; numpy on the
API host's CPU tops out around 1 GFLOP/s, while one device matmul covers
millions of vectors per query. The field matrix is cached on the device
(re-uploaded only after mutations) and ``torch.topk`` runs there, so only
k ids/scores return to the host.

Used when the corpus is large enough to amortize the launch and a CUDA
device is present; otherwise ``top_k`` returns None and the store scores
with numpy. A device error raises: there is no silent numpy fallback.

Bring-up. Importing torch, CUDA's context, the upload and the first scan's
kernels take seconds, more than a search's deadline, so no search pays
for them (the JAX package brings its device up inside the search,
jax_scorer.py:56, :65-67). An engine that restores a field of
MIN_ROWS_FOR_DEVICE rows or more brings the device up before it serves
(``bring_up_engine``, called by engine/wal.py), and the write that first
takes a field there starts it in a daemon thread (``bring_up_field``,
called by engine/store.py). A search that needs the device meanwhile
waits for it: it never scores with numpy in that window, since fp32 ranks
rows differently from bf16 and results would depend on timing. A field
under the threshold never imports torch.
"""

import threading
import time
from typing import Optional, Tuple

import numpy as np

from marqo_tpu_torch.logging import get_logger

logger = get_logger(__name__)

# below this row count numpy wins (a device round trip ≈ ms)
MIN_ROWS_FOR_DEVICE = 50_000
_MAX_K = 4096
# the k of a search at the API's default limit of 10 (engine/store.py
# asks for max(max_hits * 4, 64)): the bring-up's scan loads its kernels
_WARM_K = 64

METRICS = ("dotproduct", "euclidean", "angular", "prenormalized-angular")


def device_available() -> bool:
    import torch
    return torch.cuda.is_available()


def default_device() -> Optional[str]:
    """The device an engine scans on: CUDA where there is one, else None
    (the store scores with numpy, as the reference does without an
    accelerator)."""
    return "cuda" if device_available() else None


def bring_up_field(field, wait: bool) -> None:
    """Brings the device up for one of the store's field matrices
    (engine/store.py ``_FieldTensors``) once it holds MIN_ROWS_FOR_DEVICE
    rows of a metric the device scores; returns before torch is imported
    below that. ``wait=False`` starts it in a daemon thread."""
    if field._n < MIN_ROWS_FOR_DEVICE or field.metric not in METRICS:
        return
    if field._device_scorer is None:
        field._device_scorer = TorchExactScorer(field.metric)
    field._device_scorer.bring_up(field._store[:field._n], field._version,
                                  wait)


def bring_up_engine(engine) -> None:
    """Brings the device up, and uploads the matrix, for every field of
    ``engine`` at MIN_ROWS_FOR_DEVICE rows or more. engine/wal.py calls it
    after the restore and the WAL's replay, before the server binds its
    port. Raises if the bring-up fails, so the engine does not start."""
    for name in engine.list_indexes():
        for shard in engine._shards(name):
            with shard.lock:
                for field in shard.tensors.values():
                    bring_up_field(field, wait=True)


def score_matrix(m, q, metric: str):
    """Closeness of every row of ``m`` (N, d) to ``q`` (d,), as fp32 (N,),
    matching the numpy exact path's closeness per metric."""
    import torch
    if metric == "dotproduct":
        return (m @ q).float()
    if metric == "euclidean":
        d2 = (m.float() - q.float()[None]).square().sum(dim=1)
        return 1.0 / (1.0 + d2.sqrt())
    if metric == "angular":
        # true angle on possibly non-unit vectors (closeness 1/(1+arccos))
        mf, qf = m.float(), q.float()
        mn = torch.linalg.vector_norm(mf, dim=1).clamp_min(1e-12)
        qn = torch.linalg.vector_norm(qf).clamp_min(1e-12)
        cos = ((mf @ qf) / (mn * qn)).clamp(-1.0, 1.0)
        return 1.0 / (1.0 + torch.arccos(cos))
    if metric == "prenormalized-angular":  # unit vectors by contract
        return 1.0 / (2.0 - (m @ q).float())
    raise ValueError(f"no device scoring for metric `{metric}`")


class TorchExactScorer:
    """Device-resident (N, d) bf16 matrix with top-k closeness scoring.

    Callers serialize their calls on one scorer (the store holds the shard
    lock); the bring-up thread is the one exception, and every caller
    joins it before it touches the matrix."""

    def __init__(self, metric: str = "prenormalized-angular"):
        self.metric = metric
        self._device_matrix = None
        self._version = -1
        self._device = None      # set once the bring-up has finished
        self._started = False    # a bring-up ran, or runs in _thread
        self._thread = None
        self._error = None       # the bring-up thread's, for its joiner

    def _ensure(self, matrix: np.ndarray, version: int, device):
        import torch
        if self._device_matrix is None or self._version != version:
            self._device_matrix = torch.from_numpy(
                np.asarray(matrix, dtype=np.float32)).to(
                    device=device, dtype=torch.bfloat16)
            self._version = version

    def bring_up(self, matrix: np.ndarray, version: int, wait: bool) -> None:
        """Brings the default device up once: CUDA's context, ``matrix``
        uploaded at ``version`` and one scan, so that every kernel a search
        launches is loaded. ``wait=False`` runs it in a daemon thread;
        ``wait=True`` waits for it and raises what it raised. Without CUDA
        the device stays None and ``top_k`` declines."""
        if not self._started:
            self._started = True
            if wait:
                self._run(matrix, version)
            else:
                self._thread = threading.Thread(
                    target=self._run, args=(matrix, version), daemon=True,
                    name="exact-scan-bring-up")
                self._thread.start()
        if wait:
            thread, self._thread = self._thread, None
            if thread is not None:
                thread.join()
            if self._error is not None:
                # the next caller tries again
                error, self._error, self._started = self._error, None, False
                raise error

    def _run(self, matrix: np.ndarray, version: int) -> None:
        try:
            self._bring_up(matrix, version)
        except Exception as e:  # raised again in bring_up(wait=True)
            logger.exception(f"Exact scan: device bring-up failed for "
                             f"{matrix.shape[0]} rows")
            self._error = e

    def _bring_up(self, matrix: np.ndarray, version: int) -> None:
        start = time.perf_counter()
        device = default_device()
        if device is None:
            return
        import torch

        def synchronize():
            if device == "cuda":
                torch.cuda.synchronize()
            return time.perf_counter()

        loaded = time.perf_counter()
        torch.empty(1, device=device)  # the context
        context = synchronize()
        self._ensure(matrix, version, device)
        upload = synchronize()
        n, d = matrix.shape
        self._scan(np.zeros(d, np.float32), np.ones(n, dtype=bool),
                   min(_WARM_K, n), device)
        scan = synchronize()
        self._device = device
        logger.info(
            f"Exact scan up on {device}: {n} x {d} {self.metric} rows in "
            f"{(scan - start) * 1e3:.1f} ms (torch and CUDA init "
            f"{(loaded - start) * 1e3:.1f} ms, context "
            f"{(context - loaded) * 1e3:.1f} ms, upload "
            f"{(upload - context) * 1e3:.1f} ms, first scan "
            f"{(scan - upload) * 1e3:.1f} ms)")

    def _scan(self, query: np.ndarray, valid_mask: np.ndarray, k: int,
              device) -> Tuple[np.ndarray, np.ndarray]:
        import torch
        q = torch.from_numpy(np.asarray(query, dtype=np.float32)).to(
            device=device, dtype=torch.bfloat16)
        valid = torch.from_numpy(np.asarray(valid_mask, dtype=bool)).to(device)
        with torch.inference_mode():
            s = score_matrix(self._device_matrix, q, self.metric)
            s = s.masked_fill(~valid, float("-inf"))
            scores, idx = torch.topk(s, k)
            return scores.cpu().numpy(), idx.cpu().numpy()

    def top_k(self, matrix: np.ndarray, version: int, query: np.ndarray,
              k: int, valid_mask: np.ndarray, device: Optional[str] = None
              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Returns (row_indices, closeness_scores) of the top-k valid rows,
        or None when the device path shouldn't be used. ``device`` defaults
        to the CUDA device (None back when there is none), brought up by
        ``bring_up``: a search waits for a bring-up in flight, and brings
        the device up itself only if nothing did before. A corpus under
        MIN_ROWS_FOR_DEVICE returns None before torch is imported, as the
        JAX package's scorer checks the rows before it imports jax: an
        engine process serving small indexes never initializes CUDA."""
        if matrix.shape[0] < MIN_ROWS_FOR_DEVICE:
            return None
        if self.metric not in METRICS:
            # hamming/geodegrees: no device scoring — the numpy exact path
            # scores them
            return None
        if device is None:
            self.bring_up(matrix, version, wait=True)
            device = self._device
            if device is None:
                return None
        self._ensure(matrix, version, device)
        k = min(k, _MAX_K, matrix.shape[0])
        scores, idx = self._scan(query, valid_mask, k, device)
        keep = np.isfinite(scores)
        return idx[keep], scores[keep]
