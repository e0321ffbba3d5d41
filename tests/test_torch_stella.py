"""marqo_tpu_torch's Stella encoder (models/stella.py, ``hf_stella``)
against marqo_tpu's.

The same weights go to both: marqo_tpu's pytree through ``params_from_jax``,
or one GTE-style "NewModel" state dict (tests/test_stella_parity.py's torch
mirror) through each package's converter, with and without the
``2_Dense_<dims>`` head. Inputs come from a numpy seed. Tolerances are the
JAX package's own: fp32 cosine > 1 - 1e-5, bf16 within 1e-3 cosine. An
``hf_stella`` random-init index serves over the port's HTTP app.
"""

import json
import urllib.request
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import stella as jstella
from marqo_tpu_torch.inference.loaders import (TorchStellaModel,
                                               resolve_model_class)
from marqo_tpu_torch.models import stella as tstella
from tests.test_stella_parity import TorchStellaMirror

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=96, projection_dim=48, rope_theta=1000.0)


def _configs(**overrides):
    fields = dict(SMALL, **overrides)
    return jstella.StellaConfig(**fields), tstella.StellaConfig(**fields)


def _inputs(B=5, S=24, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, S + 1, B)
    lengths[0] = S
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(2, vocab, (B, S)) * mask).astype(np.int32)
    return ids, mask


def _cosines(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def shared():
    jconfig, tconfig = _configs()
    params = jstella.init_params(jconfig, jax.random.PRNGKey(0))
    numpy_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jconfig, tconfig, params, numpy_params


@pytest.mark.parametrize("normalize", [True, False])
def test_encode_tokens_fp32_matches_jax(shared, normalize):
    jconfig, tconfig, params, numpy_params = shared
    jconfig = replace(jconfig, normalize=normalize)
    tconfig = replace(tconfig, normalize=normalize)
    ids, mask = _inputs()
    ref = jstella.encode_tokens(params, jnp.asarray(ids), jnp.asarray(mask),
                                jconfig, compute_dtype=jnp.float32)
    model = tstella.params_from_jax(numpy_params, tconfig, device="cpu")
    out = tstella.encode_tokens(model, torch.from_numpy(ids),
                                torch.from_numpy(mask))
    assert out.dtype == torch.float32 and tuple(out.shape) == (5, 48)
    assert (_cosines(out.numpy(), ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_encode_tokens_bf16_matches_jax(shared):
    jconfig, tconfig, params, numpy_params = shared
    ids, mask = _inputs(seed=1)
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    ref = jstella.encode_tokens(params16, jnp.asarray(ids),
                                jnp.asarray(mask), jconfig,
                                compute_dtype=jnp.bfloat16)
    model = tstella.params_from_jax(numpy_params, tconfig,
                                    dtype=torch.bfloat16, device="cpu")
    out = tstella.encode_tokens(model, torch.from_numpy(ids),
                                torch.from_numpy(mask))
    assert out.dtype == torch.float32
    assert (_cosines(out.numpy(), ref) > 1 - 1e-3).all()


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    jcos, jsin = jstella._rope_tables(7, 16, 10000.0)
    ref = jstella._apply_rope(jnp.asarray(x), jcos, jsin)
    cos, sin = tstella.rope_tables(7, 16, 10000.0, "cpu")
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    out = tstella.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("with_head", [True, False])
def test_converter_matches_jax_on_a_gte_state_dict(with_head):
    """A random-init GTE "NewModel" state dict (the JAX package's torch
    mirror), with the 2_Dense head or without it (identity projection)."""
    projection = 48 if with_head else 64
    jconfig, tconfig = _configs(type_vocab_size=1,
                                projection_dim=projection)
    torch.manual_seed(3)
    mirror = TorchStellaMirror(jconfig).eval()
    sd = {k: v.detach() for k, v in mirror.state_dict_newmodel().items()}
    head = ({"weight": mirror.proj.weight.detach(),
             "bias": mirror.proj.bias.detach()} if with_head else None)
    jparams = jstella.params_from_torch_state_dict(sd, jconfig,
                                                   vector_linear=head)
    model = tstella.params_from_torch_state_dict(sd, tconfig, device="cpu",
                                                 vector_linear=head)
    ids, mask = _inputs(seed=4)
    ref = jstella.encode_tokens(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                jconfig, compute_dtype=jnp.float32)
    out = tstella.encode_tokens(model, torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
    assert out.shape == (5, projection)
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    if with_head:  # and against the mirror's own forward
        with torch.no_grad():
            mirror_out = mirror(torch.from_numpy(ids).long(),
                                torch.from_numpy(mask).long())
        assert (_cosines(out, mirror_out.numpy()) > 1 - 1e-5).all()


def test_init_stella_is_seeded():
    _, tconfig = _configs()
    a = tstella.init_stella(tconfig, torch.Generator().manual_seed(1),
                            device="cpu")
    b = tstella.init_stella(tconfig, torch.Generator().manual_seed(1),
                            device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert tuple(a.layers[0].up_gate.weight.shape) == (2 * 96, 64)
    assert a.layers[0].up_gate.bias is None


def test_hf_stella_dispatches_to_the_port():
    assert resolve_model_class(
        "Marqo/dunzhang-stella_en_400M_v5", {"type": "hf_stella"}) is \
        TorchStellaModel


def test_hf_stella_index_serves_over_http(monkeypatch):
    from marqo_tpu_torch.api.app import build_app, generate_config, on_start
    from marqo_tpu_torch.api.http_framework import serve
    from marqo_tpu_torch.inference import vectorise
    monkeypatch.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
    # no CUDA device here: the port serves on the CPU only when asked
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
    config = generate_config()
    on_start(config)
    server = serve(build_app(config), host="127.0.0.1", port=0,
                   background=True)
    port = server.server_address[1]

    def req(method, path, body=None):
        r = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=300) as resp:
            return json.load(resp)

    try:
        props = {"type": "hf_stella", "random_init": True, "dimensions": 24,
                 "tokens": 64, "architecture": {
                     "vocab_size": 128, "hidden_size": 32, "num_layers": 2,
                     "num_heads": 2, "intermediate_size": 64}}
        req("POST", "/indexes/stella",
            {"model": "tiny-stella", "modelProperties": props})
        docs = [{"_id": str(i), "text": t} for i, t in enumerate(
            ["abc cab bca", "def fed edf", "ghi hig igh", "jkl lkj kjl"])]
        res = req("POST", "/indexes/stella/documents",
                  {"documents": docs, "tensorFields": ["text"]})
        assert res["errors"] is False, res
        hits = req("POST", "/indexes/stella/search",
                   {"q": "def fed edf", "limit": 4})["hits"]
        assert hits[0]["_id"] == "1"
        emb = req("POST", "/indexes/stella/embed",
                  {"content": ["abc"]})["embeddings"]
        assert len(emb[0]) == 24
        models = [e["model"] for e in vectorise._available_models.values()]
        assert any(isinstance(m, TorchStellaModel) for m in models)
    finally:
        server.shutdown()
        server.server_close()
        config.index_meta_cache.stop_refresh_thread()
        vectorise.clear_loaded_models()
