"""engine/torch_scorer.py against the store's numpy exact path
(engine/store.py ``closeness``) and against the JAX package's scorer, for
the four metrics it scores, and its refusal of hamming/geodegrees; and
fault C4's repair: the engine brings the device up at restore or at the
write that crosses MIN_ROWS_FOR_DEVICE, never inside a search.

The scorer keeps the matrix in bf16, so the numpy reference scores the
same bf16-rounded rows and query; the planted top rows are separated by
far more than bf16's error, so their order is exact.
"""

import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from marqo_tpu_torch.engine import torch_scorer
from marqo_tpu_torch.engine.store import closeness

N, D, K = torch_scorer.MIN_ROWS_FOR_DEVICE, 16, 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# --- the scorer against the JAX package's -----------------------------------

JAX_ROWS, JAX_DIMS, JAX_K = 60_000, 64, 100


def assert_same_top_k(ids, scores, ref_ids, ref_scores):
    """Rank by rank, ``scores`` within 2^-7 |score| (two bf16 ulps) of
    ``ref_scores``; the ids equal except where rows' scores tie within that
    margin: a swap of two tied rows, or a row dropped at the k-th score."""
    assert len(ids) == len(ref_ids)
    margin = 2.0 ** -7 * np.abs(ref_scores)
    assert np.all(np.abs(scores - ref_scores) <= margin)
    position = {int(row): i for i, row in enumerate(ids)}
    for i, row in enumerate(ref_ids):
        if ids[i] == row:
            continue
        if int(row) in position:
            assert abs(scores[position[int(row)]] - scores[i]) <= margin[i]
        else:
            assert ref_scores[i] - scores[-1] <= margin[i]


@pytest.fixture(scope="module")
def jax_corpus():
    rng = np.random.default_rng(13)
    matrix = rng.standard_normal((JAX_ROWS, JAX_DIMS)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    query = rng.standard_normal(JAX_DIMS).astype(np.float32)
    query /= np.linalg.norm(query)
    valid = rng.random(JAX_ROWS) >= 0.1
    return matrix, query, valid


@pytest.mark.parametrize("metric", torch_scorer.METRICS)
def test_top_k_matches_the_jax_scorer(jax_corpus, metric, monkeypatch):
    """The JAX package's scorer on its CPU device (its device check
    patched, here only) against this one's on the CPU: 60,000 unit rows of
    64 dims, 10% of them deleted, k = 100."""
    from marqo_tpu.engine import jax_scorer
    monkeypatch.setattr(jax_scorer, "device_available", lambda: True)
    matrix, query, valid = jax_corpus
    ref = jax_scorer.JaxExactScorer(metric).top_k(matrix, 1, query, JAX_K,
                                                  valid)
    assert ref is not None
    ids, scores = torch_scorer.TorchExactScorer(metric).top_k(
        matrix, 1, query, JAX_K, valid, device="cpu")
    assert valid[ids].all()
    assert_same_top_k(ids, scores, *ref)


# --- fault C4: the device comes up at restore or at the crossing -----------

THRESHOLD, DIMS, INDEX = 64, 16, "c4"


@pytest.fixture
def cpu_device(monkeypatch):
    """A threshold of 64 rows, and the CPU as the engine's device."""
    monkeypatch.setattr(torch_scorer, "MIN_ROWS_FOR_DEVICE", THRESHOLD)
    monkeypatch.setattr(torch_scorer, "default_device", lambda: "cpu")


def _rows(n, seed=5):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, DIMS)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def _feed(engine, rows, start=0):
    for i, row in enumerate(rows, start):
        engine.feed(INDEX, f"d{i}", {"text": f"doc {i}"},
                    {"text": {"chunks": [f"doc {i}"], "embeddings": [row]}})


def _engine(rows):
    from marqo_tpu_torch.engine.descriptor import IndexDescriptor
    from marqo_tpu_torch.engine.store import StoreEngine
    engine = StoreEngine()
    engine.create_index(IndexDescriptor(name=INDEX, model_dimensions=DIMS))
    _feed(engine, rows)
    return engine


def _field(engine):
    return engine._shards(INDEX)[0].tensors["text"]


def _exact_search(engine, query):
    hits = engine.query_tensor(INDEX, query, limit=5, approximate=False).hits
    return [(h.doc_id, h.score) for h in hits]


def _device_answer(rows, query):
    """The device path's hits: bf16 rows, closeness as the scan's."""
    ids, scores = torch_scorer.TorchExactScorer().top_k(
        rows, 0, query, 64, np.ones(len(rows), dtype=bool), device="cpu")
    return [(f"d{i}", float(s)) for i, s in zip(ids[:5], scores[:5])]


@pytest.fixture
def no_numpy_scan(monkeypatch):
    """The store's numpy exact path raises if it scores."""
    from marqo_tpu_torch.engine import store

    def closeness(*args):
        raise AssertionError("the numpy exact path scored")
    monkeypatch.setattr(store, "closeness", closeness)


@pytest.fixture
def durability(tmp_path):
    """setup_engine_durability over tmp_path; unregisters it after."""
    from marqo_tpu_torch.engine import wal as wal_module
    opened = []

    def setup(engine):
        opened.append(wal_module.setup_engine_durability(
            engine, str(tmp_path), snapshot_interval_s=3600))
    yield setup
    with wal_module._ACTIVE_LOCK:
        wal_module._ACTIVE.pop(str(tmp_path / "engine_data"), None)
    for wal in opened:
        if wal is not None:
            wal.close()


def _spy_bring_up(monkeypatch, before=None):
    """Records each bring-up's thread; ``before`` runs first in it."""
    calls = []
    real = torch_scorer.TorchExactScorer._bring_up

    def spy(self, matrix, version):
        calls.append(threading.current_thread().name)
        if before is not None:
            before()
        real(self, matrix, version)
    monkeypatch.setattr(torch_scorer.TorchExactScorer, "_bring_up", spy)
    return calls


def test_restore_brings_the_device_up_before_the_first_search(
        cpu_device, no_numpy_scan, durability, tmp_path, monkeypatch):
    """A field restored at the threshold or over it comes up (context,
    upload, one scan) inside setup_engine_durability, which the engine
    server runs before it binds its port; the first search neither brings
    it up nor uploads, and answers from the device scan."""
    rows = _rows(THRESHOLD + 16)
    _engine(rows).snapshot(str(tmp_path / "engine_data"))
    calls = _spy_bring_up(monkeypatch)
    from marqo_tpu_torch.engine.store import StoreEngine
    engine = StoreEngine()
    durability(engine)
    scorer = _field(engine)._device_scorer
    assert calls == [threading.current_thread().name]
    assert scorer._device == "cpu" and scorer._thread is None
    uploaded = scorer._device_matrix
    assert tuple(uploaded.shape) == rows.shape
    query = rows[3]
    assert _exact_search(engine, query) == _device_answer(rows, query)
    assert len(calls) == 1 and scorer._device_matrix is uploaded


def test_write_crossing_the_threshold_starts_the_bring_up_and_returns(
        cpu_device, no_numpy_scan, monkeypatch):
    """The write that takes a field to the threshold starts the bring-up
    in a daemon thread and returns while it runs; a search meanwhile waits
    for it and answers from the device scan, never from numpy."""
    started, release = threading.Event(), threading.Event()

    def hold():
        started.set()
        assert release.wait(30)
    calls = _spy_bring_up(monkeypatch, before=hold)
    rows = _rows(THRESHOLD + 8)
    engine = _engine(rows[:THRESHOLD - 1])
    assert not calls
    _feed(engine, rows[THRESHOLD - 1:THRESHOLD], start=THRESHOLD - 1)
    assert started.wait(30)
    scorer = _field(engine)._device_scorer
    assert calls == ["exact-scan-bring-up"]
    assert scorer._thread.is_alive() and scorer._device is None
    # more writes while it runs
    _feed(engine, rows[THRESHOLD:], start=THRESHOLD)
    answers = []
    search = threading.Thread(
        target=lambda: answers.append(_exact_search(engine, rows[70])))
    search.start()
    search.join(0.5)
    assert search.is_alive() and not answers
    release.set()
    search.join(60)
    assert not search.is_alive()
    assert answers == [_device_answer(rows, rows[70])]
    assert len(calls) == 1 and scorer._device == "cpu"


@pytest.mark.parametrize("where", ["restore", "crossing"])
def test_failed_bring_up_raises(where, cpu_device, durability, tmp_path,
                                monkeypatch, caplog):
    """Where the device is there but its bring-up fails, the error is
    logged and raised: at restore the engine's start fails; after a
    crossing write, the search that needs the device raises. No numpy
    answer stands in."""
    def broken(self, matrix, version, device):
        raise RuntimeError("no context")
    monkeypatch.setattr(torch_scorer.TorchExactScorer, "_ensure", broken)
    # the package's loggers do not propagate to the root
    monkeypatch.setattr(torch_scorer.logger, "handlers", [caplog.handler])
    rows = _rows(THRESHOLD + 4)
    if where == "restore":
        _engine(rows).snapshot(str(tmp_path / "engine_data"))
        from marqo_tpu_torch.engine.store import StoreEngine
        with pytest.raises(RuntimeError, match="no context"):
            durability(StoreEngine())
    else:
        engine = _engine(rows)
        with pytest.raises(RuntimeError, match="no context"):
            _exact_search(engine, rows[0])
    assert "device bring-up failed" in caplog.text


def test_no_cuda_engine_starts_and_scores_with_numpy(durability, tmp_path,
                                                     monkeypatch):
    """A host without CUDA keeps the reference's behaviour: the restore
    brings nothing up and the numpy exact path scores."""
    monkeypatch.setattr(torch_scorer, "MIN_ROWS_FOR_DEVICE", THRESHOLD)
    monkeypatch.setattr(torch_scorer, "device_available", lambda: False)
    rows = _rows(THRESHOLD + 4)
    _engine(rows).snapshot(str(tmp_path / "engine_data"))
    from marqo_tpu_torch.engine.store import StoreEngine, closeness
    engine = StoreEngine()
    durability(engine)
    assert _field(engine)._device_scorer._device is None
    query = rows[9]
    scores = closeness("prenormalized-angular", query, rows)
    top = np.argsort(-scores, kind="stable")[:5]
    assert _exact_search(engine, query) == [(f"d{i}", float(scores[i]))
                                            for i in top]


def test_engine_under_the_threshold_never_imports_torch(tmp_path):
    """An engine whose fields stay under MIN_ROWS_FOR_DEVICE restores,
    takes writes and answers exact searches without importing torch."""
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        from marqo_tpu_torch.engine.descriptor import IndexDescriptor
        from marqo_tpu_torch.engine.store import StoreEngine
        from marqo_tpu_torch.engine.wal import setup_engine_durability
        rng = np.random.default_rng(0)

        def feed(engine, start, n):
            for i in range(start, start + n):
                engine.feed("small", f"d{{i}}", {{"text": "doc"}}, {{
                    "text": {{"chunks": ["doc"], "embeddings":
                              [rng.standard_normal(8).astype(np.float32)]}}}})

        engine = StoreEngine()
        setup_engine_durability(engine, {str(tmp_path)!r},
                                snapshot_interval_s=3600)
        engine.create_index(IndexDescriptor(name="small", model_dimensions=8))
        feed(engine, 0, 300)
        engine.snapshot({str(tmp_path / "engine_data")!r})
        restarted = StoreEngine()
        setup_engine_durability(restarted, {str(tmp_path)!r},
                                snapshot_interval_s=3600)
        feed(restarted, 300, 20)
        hits = restarted.query_tensor("small", np.ones(8), limit=5,
                                      approximate=False).hits
        assert len(hits) == 5 and restarted.vector_count("small") == 320
        assert "torch" not in sys.modules, "torch was imported"
    """)
    result = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
