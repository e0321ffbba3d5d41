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
"""

from typing import Optional, Tuple

import numpy as np

# below this row count numpy wins (a device round trip ≈ ms)
MIN_ROWS_FOR_DEVICE = 50_000
_MAX_K = 4096

METRICS = ("dotproduct", "euclidean", "angular", "prenormalized-angular")


def device_available() -> bool:
    import torch
    return torch.cuda.is_available()


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
    """Device-resident (N, d) bf16 matrix with top-k closeness scoring."""

    def __init__(self, metric: str = "prenormalized-angular"):
        self.metric = metric
        self._device_matrix = None
        self._version = -1

    def _ensure(self, matrix: np.ndarray, version: int, device):
        import torch
        if self._device_matrix is None or self._version != version:
            self._device_matrix = torch.from_numpy(
                np.asarray(matrix, dtype=np.float32)).to(
                    device=device, dtype=torch.bfloat16)
            self._version = version

    def top_k(self, matrix: np.ndarray, version: int, query: np.ndarray,
              k: int, valid_mask: np.ndarray, device: Optional[str] = None
              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Returns (row_indices, closeness_scores) of the top-k valid rows,
        or None when the device path shouldn't be used. ``device`` defaults
        to the CUDA device (None back when there is none). A corpus under
        MIN_ROWS_FOR_DEVICE returns None before torch is imported, as the
        JAX package's scorer checks the rows before it imports jax: an
        engine process serving small indexes never initializes CUDA."""
        if matrix.shape[0] < MIN_ROWS_FOR_DEVICE:
            return None
        if self.metric not in METRICS:
            # hamming/geodegrees: no device scoring — the numpy exact path
            # scores them
            return None
        import torch
        if device is None:
            if not device_available():
                return None
            device = "cuda"
        self._ensure(matrix, version, device)
        k = min(k, _MAX_K, matrix.shape[0])
        q = torch.from_numpy(np.asarray(query, dtype=np.float32)).to(
            device=device, dtype=torch.bfloat16)
        valid = torch.from_numpy(np.asarray(valid_mask, dtype=bool)).to(device)
        with torch.inference_mode():
            s = score_matrix(self._device_matrix, q, self.metric)
            s = s.masked_fill(~valid, float("-inf"))
            scores, idx = torch.topk(s, k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        keep = np.isfinite(scores)
        return idx[keep], scores[keep]
