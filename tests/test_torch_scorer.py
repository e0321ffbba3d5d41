"""engine/torch_scorer.py against the store's numpy exact path
(engine/store.py ``closeness``), for the four metrics it scores, and its
refusal of hamming/geodegrees.

The scorer keeps the matrix in bf16, so the numpy reference scores the
same bf16-rounded rows and query; the planted top rows are separated by
far more than bf16's error, so their order is exact.
"""

import numpy as np
import pytest
import torch

from marqo_tpu_torch.engine import torch_scorer
from marqo_tpu_torch.engine.store import closeness

N, D, K = torch_scorer.MIN_ROWS_FOR_DEVICE, 16, 8


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    query = rng.standard_normal(D).astype(np.float32)
    query /= np.linalg.norm(query)
    matrix = rng.standard_normal((N, D)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    # plant rows near the query at clearly increasing distances
    planted = rng.choice(N, 12, replace=False)
    for rank, row in enumerate(planted):
        noise = rng.standard_normal(D).astype(np.float32)
        vec = query + (0.05 + 0.12 * rank) * noise / np.linalg.norm(noise)
        matrix[row] = vec / np.linalg.norm(vec)
    valid = np.ones(N, dtype=bool)
    valid[planted[2]] = False  # a deleted row never comes back
    valid[rng.choice(N, 500, replace=False)] = False
    valid[planted[:2]] = True
    return _bf16(matrix), _bf16(query), valid


@pytest.mark.parametrize("metric", torch_scorer.METRICS)
def test_top_k_matches_numpy_exact_path(corpus, metric):
    matrix, query, valid = corpus
    scorer = torch_scorer.TorchExactScorer(metric)
    idx, scores = scorer.top_k(matrix, 1, query, K, valid, device="cpu")
    ref_all = closeness(metric, query, matrix)
    ref_all = np.where(valid, ref_all, -np.inf)
    ref_idx = np.argsort(-ref_all, kind="stable")[:K]
    assert list(idx) == list(ref_idx)
    np.testing.assert_allclose(scores, ref_all[ref_idx], rtol=1e-2)
    assert valid[idx].all()


def test_matrix_is_cached_per_version(corpus):
    matrix, query, valid = corpus
    scorer = torch_scorer.TorchExactScorer("dotproduct")
    scorer.top_k(matrix, 7, query, K, valid, device="cpu")
    cached = scorer._device_matrix
    scorer.top_k(matrix, 7, query, K, valid, device="cpu")
    assert scorer._device_matrix is cached
    scorer.top_k(matrix, 8, query, K, valid, device="cpu")
    assert scorer._device_matrix is not cached


@pytest.mark.parametrize("metric", ["hamming", "geodegrees"])
def test_refuses_metrics_without_device_scoring(corpus, metric):
    matrix, query, valid = corpus
    scorer = torch_scorer.TorchExactScorer(metric)
    assert scorer.top_k(matrix, 1, query, K, valid, device="cpu") is None
    with pytest.raises(ValueError):
        torch_scorer.score_matrix(torch.zeros(2, D), torch.zeros(D), metric)


def test_small_corpus_stays_on_numpy(corpus):
    matrix, query, valid = corpus
    scorer = torch_scorer.TorchExactScorer("dotproduct")
    n = torch_scorer.MIN_ROWS_FOR_DEVICE - 1
    assert scorer.top_k(matrix[:n], 1, query, K, valid[:n],
                        device="cpu") is None


def test_small_corpus_declines_before_asking_for_a_device(corpus,
                                                         monkeypatch):
    """Under MIN_ROWS_FOR_DEVICE the scorer declines before it looks for a
    device, as the JAX package's scorer does (marqo_tpu/engine/
    jax_scorer.py:56): an engine process serving small indexes never
    imports torch or initializes CUDA for a search."""
    matrix, query, valid = corpus
    asked = []
    monkeypatch.setattr(torch_scorer, "device_available",
                        lambda: asked.append(True) or True)
    scorer = torch_scorer.TorchExactScorer("dotproduct")
    n = torch_scorer.MIN_ROWS_FOR_DEVICE - 1
    assert scorer.top_k(matrix[:n], 1, query, K, valid[:n]) is None
    assert scorer.top_k(matrix, 1, query, K, valid, device="cpu") is not None
    assert not asked


def test_default_device_is_cuda_only(corpus, monkeypatch):
    """Without a CUDA device the scorer declines (the store scores with
    numpy); it never picks the CPU by itself."""
    matrix, query, valid = corpus
    monkeypatch.setattr(torch_scorer, "device_available", lambda: False)
    scorer = torch_scorer.TorchExactScorer("dotproduct")
    assert scorer.top_k(matrix, 1, query, K, valid) is None


def test_k_is_capped():
    assert torch_scorer._MAX_K == 4096
    assert torch_scorer.MIN_ROWS_FOR_DEVICE == 50_000
