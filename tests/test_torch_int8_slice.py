"""The int8 (W8A8) text search slice, end to end, in both packages at once.

The checkpoint of tests/test_torch_slice.py (a small random-init HF BERT
saved to disk) backs an index with ``modelProperties.quantize: true`` in the
JAX package's HTTP server and in marqo_tpu_torch's, both started in-process.
Both wrappers run in fp32, where the int8 path of the two packages is the
same arithmetic (the port's B3 twin equals JAX's ``int8_linear`` bit for
bit, tests/test_torch_quant.py): /embed vectors agree to cosine 1 - 1e-5,
TENSOR and HYBRID searches return the same hit ids in the same order with
scores within 1e-4. A second index shows that MARQO_TPU_QUANTIZE=int8 turns
the path on without the property.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.inference.loaders import JaxHFTextModel
from marqo_tpu_torch.inference.loaders import TorchHFTextModel
from marqo_tpu_torch.models.bert import Int8Linear
from tests.test_torch_slice import (DOCS, MODEL_PROPERTIES, QUERIES,
                                    _cosine, _Server, checkpoint)  # noqa: F401

INT8_PROPERTIES = dict(MODEL_PROPERTIES, quantize=True)


def _torch_models():
    from marqo_tpu_torch.inference import vectorise
    return [entry["model"] for entry in vectorise._available_models.values()]


@pytest.fixture(scope="module")
def servers(checkpoint):  # noqa: F811
    from marqo_tpu_torch.inference import vectorise as torch_vectorise
    # the tests count the models these servers load: none left by an
    # earlier test in this process
    torch_vectorise.clear_loaded_models()
    servers = {}
    with pytest.MonkeyPatch.context() as env:
        env.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
        # no CUDA device here: the port serves on the CPU only when asked
        env.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
        env.setattr(JaxHFTextModel, "compute_dtype", jnp.float32)
        env.setattr(TorchHFTextModel, "compute_dtype", torch.float32)
        try:
            for package in ("marqo_tpu", "marqo_tpu_torch"):
                server = _Server(package)
                servers[package] = server
                props = dict(INT8_PROPERTIES, localpath=checkpoint)
                server.req("POST", "/indexes/int8",
                           {"model": "int8-bert", "modelProperties": props})
                res = server.req("POST", "/indexes/int8/documents",
                                 {"documents": DOCS, "tensorFields": ["text"]})
                assert res["errors"] is False, res
            yield servers
        finally:
            for server in servers.values():
                server.close()
            from marqo_tpu.inference import vectorise as jax_vectorise
            jax_vectorise.clear_loaded_models()
            torch_vectorise.clear_loaded_models()


def test_the_port_serves_the_int8_encoder(servers):
    models = [m for m in _torch_models() if isinstance(m, TorchHFTextModel)]
    assert models and all(m.config.quantize for m in models)
    layer = models[0].encoder.layers[0]
    assert isinstance(layer.ffn_in, Int8Linear)
    assert layer.ffn_in.weight_q.dtype == torch.int8
    # q, k and v in one packed (3H, H) int8 layer
    H = models[0].encoder.config.hidden_size
    assert isinstance(layer.qkv, Int8Linear)
    assert tuple(layer.qkv.weight_q.shape) == (3 * H, H)
    assert not hasattr(layer, "query")
    # memory_bytes counts the int8 weights and their scales
    assert models[0].memory_bytes() == sum(
        t.numel() * t.element_size()
        for t in (*models[0].encoder.parameters(),
                  *models[0].encoder.buffers()))


def test_embed_vectors_agree(servers):
    content = [d["text"] for d in DOCS[:4]] + QUERIES[:2]
    out = {p: s.req("POST", "/indexes/int8/embed", {"content": content})
           for p, s in servers.items()}
    ref, port = out["marqo_tpu"]["embeddings"], \
        out["marqo_tpu_torch"]["embeddings"]
    assert len(ref) == len(port) == len(content)
    for a, b in zip(ref, port):
        assert _cosine(a, b) > 1 - 1e-5


@pytest.mark.parametrize("method", ["TENSOR", "HYBRID"])
@pytest.mark.parametrize("query", QUERIES)
def test_search_hits_and_scores_agree(servers, method, query):
    body = {"q": query, "searchMethod": method, "limit": len(DOCS)}
    res = {p: s.req("POST", "/indexes/int8/search", body)
           for p, s in servers.items()}
    ref = [(h["_id"], h["_score"]) for h in res["marqo_tpu"]["hits"]]
    port = [(h["_id"], h["_score"]) for h in res["marqo_tpu_torch"]["hits"]]
    assert ref and [i for i, _ in port] == [i for i, _ in ref]
    np.testing.assert_allclose([s for _, s in port], [s for _, s in ref],
                               atol=1e-4)


def test_env_variable_turns_the_int8_path_on(servers, checkpoint,  # noqa: F811
                                             monkeypatch):
    """MARQO_TPU_QUANTIZE=int8 with no ``quantize`` property: the port's
    index serves the int8 encoder, and its vectors equal those of the
    index that asked by property."""
    monkeypatch.setenv("MARQO_TPU_QUANTIZE", "int8")
    server = servers["marqo_tpu_torch"]
    props = dict(MODEL_PROPERTIES, localpath=checkpoint)
    server.req("POST", "/indexes/int8env",
               {"model": "int8-bert-env", "modelProperties": props})
    content = [d["text"] for d in DOCS[:3]]
    by_env = server.req("POST", "/indexes/int8env/embed",
                        {"content": content})["embeddings"]
    by_property = server.req("POST", "/indexes/int8/embed",
                             {"content": content})["embeddings"]
    np.testing.assert_array_equal(np.asarray(by_env),
                                  np.asarray(by_property))
    models = [m for m in _torch_models() if isinstance(m, TorchHFTextModel)
              and "quantize" not in m.properties]
    assert models and all(m.config.quantize for m in models)
