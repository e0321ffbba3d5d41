"""Multi-device SERVING path of marqo_tpu_torch (parallel/serving.py; port
of tests/test_multichip_serving.py): the product encode stack —
vectorise(), add_documents, search — over a forced (4, 2) mesh of the CPU
repeated 8 times, with embeddings equal to single-device serving.

Tolerances are the JAX file's: 2e-2 on bf16 unit vectors, scores within
2e-3. The float BERT encoder splits its heads and FFN over tp 2; the CLIP
towers, SigLIP and the int8 encoder replicate over dp 4.
"""

import numpy as np
import pytest

from marqo_tpu_torch.inference import vectorise as inference
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.parallel.encode import ShardedTextEncoder
from marqo_tpu_torch.parallel.serving import (model_mesh, reset_serving_mesh,
                                              round_up_to_dp, serving_mesh)

SHAPE = {"dp": 4, "tp": 2}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """This host has no CUDA device: the port serves on the CPU on
    purpose, and the mesh's devices are the CPU repeated."""
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
    monkeypatch.setenv("MARQO_TPU_MESH_SHAPE", "4,2")
    monkeypatch.delenv("MARQO_TPU_SERVING_MESH", raising=False)


@pytest.fixture
def mesh_on(monkeypatch):
    """Force the serving mesh: (4, 2) over the CPU repeated 8 times."""
    inference.clear_loaded_models()
    reset_serving_mesh()
    monkeypatch.setenv("MARQO_TPU_SERVING_MESH", "TRUE")
    yield serving_mesh()
    inference.clear_loaded_models()
    reset_serving_mesh()


@pytest.fixture
def mesh_off():
    inference.clear_loaded_models()
    reset_serving_mesh()
    yield
    inference.clear_loaded_models()
    reset_serving_mesh()


def _with_mesh(monkeypatch, run):
    """``run()`` once more with the serving mesh forced on."""
    inference.clear_loaded_models()
    reset_serving_mesh()
    monkeypatch.setenv("MARQO_TPU_SERVING_MESH", "TRUE")
    try:
        return run()
    finally:
        monkeypatch.delenv("MARQO_TPU_SERVING_MESH")
        inference.clear_loaded_models()
        reset_serving_mesh()


TEXTS = [f"document number {i} about topic {i % 5}" for i in range(19)]


def _load(props):
    from marqo_tpu_torch.inference.loaders import load_model
    return load_model("serve-test", props, Device.CPU)


def _encode_texts(model_props, texts):
    model = _load(model_props)
    return model, np.asarray(model.encode(texts, normalize=True))


TINY_BERT = {
    "name": "serve-test", "dimensions": 32, "tokens": 64, "type": "hf",
    "random_init": True, "pooling_method": "mean",
    "architecture": {"vocab_size": 512, "hidden_size": 32, "num_layers": 2,
                     "num_heads": 2, "intermediate_size": 64},
}


class TestServingMeshActivation:
    def test_mesh_off_by_default_on_cpu(self, mesh_off):
        assert serving_mesh() is None

    def test_forced_mesh_spans_its_shape(self, mesh_on):
        mesh = mesh_on
        assert mesh is not None and mesh.shape == SHAPE
        assert mesh.devices.size == 8
        assert {d.type for d in mesh.devices.flat} == {"cpu"}

    def test_force_off(self, monkeypatch, mesh_off):
        monkeypatch.setenv("MARQO_TPU_SERVING_MESH", "FALSE")
        assert serving_mesh() is None

    def test_virtual_mesh_warns(self, mesh_off, monkeypatch):
        """A forced mesh larger than the devices there are cycles over
        them, and says so at WARNING (it serves slower than one device)."""
        import logging
        records = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = records.append
        logger = logging.getLogger("marqo_tpu_torch.parallel.serving")
        logger.addHandler(handler)
        monkeypatch.setenv("MARQO_TPU_SERVING_MESH", "TRUE")
        try:
            assert serving_mesh().shape == SHAPE
        finally:
            logger.removeHandler(handler)
        assert any("virtual mesh" in r.getMessage() for r in records)

    def test_round_up_to_dp(self, mesh_on):
        assert round_up_to_dp(1, mesh_on) == 4
        assert round_up_to_dp(6, mesh_on) == 8
        assert round_up_to_dp(8, mesh_on) == 8
        assert round_up_to_dp(256, mesh_on) == 256
        assert round_up_to_dp(3, None) == 3


class TestShardedTextServing:
    def test_params_actually_sharded(self, mesh_on):
        model, _ = _encode_texts(TINY_BERT, TEXTS[:4])
        assert model_mesh(model) is mesh_on
        assert isinstance(model.encoder, ShardedTextEncoder)
        assert len(model._replicas) == 4
        # one device repeated: the dp groups share one set of tp shards
        assert all(r is model.encoder for r in model._replicas)
        layer = model.encoder.shards[1].layers[0]
        assert tuple(layer.query.weight.shape) == (16, 32)
        assert tuple(layer.ffn_out.weight.shape) == (32, 32)

    def test_encode_matches_single_device(self, mesh_off, monkeypatch):
        single, ref = _encode_texts(TINY_BERT, TEXTS)
        assert model_mesh(single) is None
        assert not hasattr(single, "_replicas")
        model, out = _with_mesh(monkeypatch,
                                lambda: _encode_texts(TINY_BERT, TEXTS))
        assert model._mesh is not None
        np.testing.assert_allclose(out, ref, atol=2e-2)
        # embeddings are unit-normalized and deterministic
        np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0,
                                   atol=1e-5)

    def test_packed_dispatch_matches_single_device(self, mesh_off,
                                                   monkeypatch):
        """Ragged texts pack (density < 0.75): the packed rows split over
        dp and the pooling sums add up on the lead device."""
        texts = [" ".join(["long"] * 50)] + [f"short {i}" for i in
                                             range(14)]

        def run():
            model = _load(TINY_BERT)
            packed = []
            dispatch = model._dispatch_packed
            model._dispatch_packed = lambda *a: packed.append(1) or \
                dispatch(*a)
            return model, packed, np.asarray(model.encode(texts))

        _, packed_single, ref = run()
        model, packed, out = _with_mesh(monkeypatch, run)
        assert packed_single and packed and model._mesh is not None
        np.testing.assert_allclose(out, ref, atol=2e-2)

    def test_batch_one_query_path(self, mesh_on):
        """Batch-1 (query path) must still work: bucket rounds 1 → dp."""
        model, out = _encode_texts(TINY_BERT, ["a single query"])
        assert out.shape == (1, 32)
        assert np.isfinite(out).all()
        assert model.warmup([[1, 8]]) == 1

    def test_int8_encoder_replicates_and_matches_single_device(
            self, mesh_off, monkeypatch):
        props = {**TINY_BERT, "quantize": True}
        _, ref = _encode_texts(props, TEXTS)
        model, out = _with_mesh(monkeypatch,
                                lambda: _encode_texts(props, TEXTS))
        assert model.config.quantize
        assert not isinstance(model.encoder, ShardedTextEncoder)
        assert all(r is model.encoder for r in model._replicas)
        np.testing.assert_allclose(out, ref, atol=2e-2)


class TestShardedClipServing:
    CLIP_PROPS = {
        "name": "serve-clip", "dimensions": 16, "type": "clip",
        "random_init": True, "image_size": 32,
        "architecture": {"vocab_size": 256, "text_hidden_size": 32,
                         "text_layers": 1, "text_heads": 2,
                         "text_intermediate": 64, "patch_size": 16,
                         "vision_hidden_size": 32, "vision_layers": 1,
                         "vision_heads": 2, "vision_intermediate": 64},
    }

    def _images(self, n=5):
        rng = np.random.default_rng(0)
        return [rng.integers(0, 255, (40, 40, 3)).astype(np.uint8)
                for _ in range(n)]

    def test_image_encode_matches_single_device(self, mesh_off,
                                                monkeypatch):
        from marqo_tpu_torch.models.clip import TorchCLIPModel
        imgs = self._images()

        def run():
            model = TorchCLIPModel("serve-clip", self.CLIP_PROPS, Device.CPU)
            model.load()
            return model, np.asarray(model.encode(imgs,
                                                  modality=Modality.IMAGE))

        _, ref = run()
        model, out = _with_mesh(monkeypatch, run)
        assert model._mesh is not None and len(model._replicas) == 4
        np.testing.assert_allclose(out, ref, atol=2e-2)


class TestLanguageBindStaysOnOneDevice:
    """LanguageBind feeds every tower from the model's one device, as the
    JAX package does, so it holds no replicas under the mesh."""

    PROPS = {"name": "serve-languagebind", "type": "languagebind",
             "dimensions": 24, "random_init": True, "image_size": 32,
             "architecture": {"patch_size": 8, "vocab_size": 64},
             "supported_modalities": ["language", "image"]}

    def test_no_replicas_and_same_vectors(self, mesh_off, monkeypatch):
        from marqo_tpu_torch.models.languagebind import \
            TorchLanguageBindModel
        imgs = TestShardedClipServing._images(None, 3)

        def run():
            model = TorchLanguageBindModel("serve-languagebind", self.PROPS,
                                           Device.CPU)
            model.load()
            return model, np.asarray(model.encode(
                imgs, modality=Modality.IMAGE))

        _, ref = run()
        model, out = _with_mesh(monkeypatch, run)
        assert not hasattr(model, "_replicas")
        np.testing.assert_array_equal(out, ref)


class TestWholeFamilyMeshCoverage:
    """Every CLIP-family wrapper joins the mesh through put_params and the
    shared batched dispatcher (inference/batching.py)."""

    SIGLIP_PROPS = {
        "name": "serve-siglip", "dimensions": 32, "type": "open_clip",
        "random_init": True, "image_size": 32,
        "architecture": {"vocab_size": 256, "text_layers": 1,
                         "text_heads": 2, "patch_size": 16,
                         "vision_layers": 1, "vision_heads": 2},
    }

    def test_siglip_text_matches_single_device(self, mesh_off, monkeypatch):
        from marqo_tpu_torch.models.siglip import TorchSigLIPModel
        texts = ["hello world", "quick brown fox", "third document"]

        def run():
            model = TorchSigLIPModel("serve-siglip", self.SIGLIP_PROPS,
                                     Device.CPU)
            model.load()
            return model, np.asarray(model.encode(texts,
                                                  modality=Modality.TEXT))

        _, ref = run()
        model, out = _with_mesh(monkeypatch, run)
        assert model_mesh(model) is not None
        np.testing.assert_allclose(out, ref, atol=2e-2)


class TestOrchestrationOverMesh:
    """The REAL add_documents/search orchestration over the mesh."""

    def _run(self, index):
        from marqo_tpu_torch.api.models.index_settings import IndexSettings
        from marqo_tpu_torch.config import Config
        from marqo_tpu_torch.core.models.add_docs_params import \
            AddDocsParams
        from marqo_tpu_torch.tensor_search import tensor_search
        cfg = Config()
        cfg.index_management.bootstrap()
        cfg.index_management.create_index(
            IndexSettings(model="test").to_marqo_index(index))
        cfg.index_meta_cache.populate()
        try:
            docs = [{"_id": f"d{i}", "text": t}
                    for i, t in enumerate(TEXTS)]
            res = tensor_search.add_documents(cfg, AddDocsParams(
                index_name=index, docs=docs, tensor_fields=["text"],
                device="cpu"))
            out = tensor_search.search(cfg, index, text="topic 3 document")
            return res, out
        finally:
            cfg.index_meta_cache.stop_refresh_thread()

    def test_add_documents_and_search(self, mesh_on, monkeypatch):
        monkeypatch.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
        res, out = self._run("mesh-index")
        assert res["errors"] is False, res
        # the loaded model must actually be on the mesh
        entries = list(inference._available_models.values())
        assert entries and entries[0]["model"]._mesh is not None
        assert isinstance(entries[0]["model"].encoder, ShardedTextEncoder)
        assert len(out["hits"]) > 0
        assert {h["_id"] for h in out["hits"]} <= \
            {f"d{i}" for i in range(len(TEXTS))}

    def test_search_results_match_single_device(self, mesh_on,
                                                monkeypatch):
        monkeypatch.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
        _, sharded = self._run("par-index")
        inference.clear_loaded_models()
        reset_serving_mesh()
        monkeypatch.setenv("MARQO_TPU_SERVING_MESH", "FALSE")
        _, single = self._run("par-index")
        sharded = [(h["_id"], h["_score"]) for h in sharded["hits"]]
        single = [(h["_id"], h["_score"]) for h in single["hits"]]
        assert [x[0] for x in sharded] == [x[0] for x in single]
        for (_, a), (_, b) in zip(sharded, single):
            assert abs(a - b) < 2e-3
