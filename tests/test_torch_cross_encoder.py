"""marqo_tpu_torch's cross-encoder reranker (models/cross_encoder.py and the
cross-encoder leg of inference/rerank.py) against marqo_tpu's.

The same weights go to both packages: marqo_tpu's parameter pytree through
``params_from_jax``, or one random-init HF BertForSequenceClassification
checkpoint on disk loaded by each package's wrapper. Inputs come from a
numpy seed. Both run in fp32 here: scores agree within atol 1e-5 (the
packages' BERT encoders agree to 1e-5, tests/test_torch_bert.py), and
reranked hits come back in the same order. The rest mirrors
tests/test_reranker.py on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.inference import rerank as jrerank
from marqo_tpu.models import bert as jbert
from marqo_tpu.models import cross_encoder as jce
from marqo_tpu_torch.core.exceptions import InvalidArgumentError
from marqo_tpu_torch.inference import rerank as trerank
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.models import bert as tbert
from marqo_tpu_torch.models import cross_encoder as tce

PROPS = {"random_init": True}
SMALL = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64)
HITS = [{"_id": "a", "title": "red apple pie", "_score": 0.1},
        {"_id": "b", "title": "green pear tart", "_score": 0.9},
        {"_id": "c", "title": "apple and pear crumble", "_score": 0.5},
        {"_id": "d", "title": "blue car", "_score": 0.4}]


@pytest.fixture(autouse=True)
def clean():
    trerank.clear_rerankers()
    jrerank.clear_rerankers()
    yield
    trerank.clear_rerankers()
    jrerank.clear_rerankers()


def _pair_inputs(B=5, S=24, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, S + 1, B)
    lengths[0] = S
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(5, SMALL["vocab_size"], (B, S)) * mask).astype(
        np.int32)
    split = rng.integers(2, lengths)
    types = ((np.arange(S)[None] >= split[:, None]) & (mask > 0)).astype(
        np.int32)
    return ids, mask, types


def test_scores_match_jax_on_shared_weights():
    config = jce._no_pool_config(jbert.TextEncoderConfig(**SMALL))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    H = config.hidden_size
    params = {"encoder": jbert.init_params(config, keys[0]),
              "pooler_w": jax.random.normal(keys[1], (H, H)) * 0.05,
              "pooler_b": jax.random.normal(keys[2], (H,)) * 0.05,
              "classifier_w": jax.random.normal(keys[1], (H, 1)) * 0.05,
              "classifier_b": jnp.full((1,), 0.3)}
    ids, mask, types = _pair_inputs()
    ref = np.asarray(jce.cross_encoder_scores(
        params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types),
        config, compute_dtype=jnp.float32))
    model = tce.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params),
        tce._no_pool_config(tbert.TextEncoderConfig(**SMALL)),
        device="cpu")
    out = tce.cross_encoder_scores(model, *map(torch.from_numpy,
                                               (ids, mask, types)))
    assert out.dtype == torch.float32 and tuple(out.shape) == (5,)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A random-init HF BertForSequenceClassification (one logit) with the
    test WordPiece tokenizer, saved as a hub checkpoint would be."""
    transformers = pytest.importorskip("transformers")
    from marqo_tpu_torch.models.tokenizer import TextTokenizer
    path = tmp_path_factory.mktemp("cross-encoder")
    tokenizer = TextTokenizer.build_test_wordpiece()
    torch.manual_seed(0)
    config = transformers.BertConfig(
        vocab_size=tokenizer._tok.get_vocab_size(), hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=128, num_labels=1)
    model = transformers.BertForSequenceClassification(config).eval()
    with torch.no_grad():  # a head whose logits spread the hits apart
        model.classifier.weight.normal_(0, 1.0)
    model.save_pretrained(str(path))
    tokenizer._tok.save(str(path / "tokenizer.json"))
    return str(path)


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(jce.JaxCrossEncoder, "compute_dtype", jnp.float32)
    monkeypatch.setattr(tce.TorchCrossEncoder, "compute_dtype",
                        torch.float32)


def test_checkpoint_scores_match_jax(checkpoint, fp32):
    """One HF checkpoint through both packages' converters and wrappers."""
    from marqo_tpu.inference.types import Device as JaxDevice
    texts = [h["title"] for h in HITS] + ["pear", "a long " * 20 + "text"]
    jmodel = jce.JaxCrossEncoder(checkpoint, JaxDevice.CPU)
    jmodel.load()
    tmodel = tce.TorchCrossEncoder(checkpoint, Device.CPU)
    tmodel.load()
    assert tmodel.model.pooler.weight.dtype == torch.float32
    ref = jmodel.score("apple pear", texts)
    out = tmodel.score("apple pear", texts)
    assert out.dtype == np.float32 and out.shape == (len(texts),)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_checkpoint_converter_matches_hf_logits(checkpoint):
    """The port's converter against transformers' own forward."""
    from transformers import BertForSequenceClassification
    hf = BertForSequenceClassification.from_pretrained(checkpoint).eval()
    model = tce.params_from_torch_state_dict(
        hf.state_dict(), tce._no_pool_config(tbert.config_from_hf(hf.config)),
        device="cpu")
    rng = np.random.default_rng(1)
    ids = rng.integers(5, hf.config.vocab_size, (3, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    types = np.zeros_like(ids)
    types[:, 8:] = 1
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask).long(),
                 token_type_ids=torch.from_numpy(types).long()).logits[:, 0]
    out = tce.cross_encoder_scores(model, *map(torch.from_numpy,
                                               (ids, mask, types)))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_rerank_reorders_hits_as_jax_does(checkpoint, fp32):
    results = {}
    for package, module in (("jax", jrerank), ("torch", trerank)):
        result = {"hits": [dict(h) for h in HITS]}
        module.rerank_search_results(result, "apple pear", checkpoint,
                                     device="cpu",
                                     searchable_attributes=["title"])
        results[package] = result["hits"]
    order = [h["_id"] for h in results["torch"]]
    assert order == [h["_id"] for h in results["jax"]]
    assert order != [h["_id"] for h in HITS]
    np.testing.assert_allclose([h["_score"] for h in results["torch"]],
                               [h["_score"] for h in results["jax"]],
                               atol=1e-5)


def test_reranker_is_cached_per_name_and_device():
    a = trerank._get_reranker("test-reranker", Device.CPU, PROPS)
    b = trerank._get_reranker("test-reranker", Device.CPU, PROPS)
    assert a is b and isinstance(a, tce.TorchCrossEncoder)
    assert a.model.encoder.embeddings.word.weight.device.type == "cpu"


def test_random_init_scores_shape_and_determinism():
    model = tce.TorchCrossEncoder("test-reranker", Device.CPU, PROPS)
    model.load()
    scores = model.score("red apple", ["a red apple", "a green pear",
                                       "a blue car"])
    assert scores.shape == (3,)
    again = model.score("red apple", ["a red apple"])
    assert abs(scores[0] - again[0]) < 1e-2
    assert model.score("q", []).shape == (0,)


def test_rerank_overwrites_scores_and_sorts():
    result = {"hits": [dict(h) for h in HITS[:2]]}
    trerank.rerank_search_results(result, "red apple", "test-reranker",
                                  device="cpu",
                                  searchable_attributes=["title"],
                                  properties=PROPS)
    scores = [h["_score"] for h in result["hits"]]
    assert scores == sorted(scores, reverse=True)
    assert set(scores) != {0.1, 0.9}


def test_skips_when_no_hit_has_the_field():
    result = {"hits": [{"_id": "a", "other": "x", "_score": 0.7}]}
    trerank.rerank_search_results(result, "q", "test-reranker", device="cpu",
                                  searchable_attributes=["title"],
                                  properties=PROPS)
    assert result["hits"][0]["_score"] == 0.7


def test_owl_reranker_is_not_ported_yet(tmp_path):
    """The OWL-ViT leg reranks (the name is from before models/owl_vit.py
    was ported): image hits get a box score and a highlight, a missing
    image scores 0. A query that is not a string is refused."""
    from PIL import Image
    path = tmp_path / "a.png"
    Image.new("RGB", (48, 32), (200, 40, 40)).save(path)
    props = {"random_init": True,
             "architecture": {"hidden_size": 32, "layers": 1, "heads": 2,
                              "image_size": 32, "patch_size": 16}}
    result = {"hits": [{"_id": "a", "image": str(path)},
                       {"_id": "b", "image": "/nowhere.png"}]}
    trerank.rerank_search_results(result, "q", "owl/ViT-B/32", device="cpu",
                                  searchable_attributes=["image"],
                                  properties=props)
    trerank.clear_rerankers()
    hits = {h["_id"]: h for h in result["hits"]}
    assert 0 < hits["a"]["_score"] < 1 and hits["b"]["_score"] == 0.0
    x1, y1, x2, y2 = hits["a"]["_highlights"][0]["image"]
    assert 0 <= x1 <= x2 <= 48 and 0 <= y1 <= y2 <= 32
    with pytest.raises(InvalidArgumentError):
        trerank.rerank_search_results(result, ["not", "a", "string"],
                                      "test-reranker", device="cpu")


@pytest.fixture
def search_config(monkeypatch):
    """A fresh in-process config with a ``test``-model index on the CPU."""
    # no CUDA device here: the port serves on the CPU only when asked
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
    from marqo_tpu_torch.api.models.index_settings import IndexSettings
    from marqo_tpu_torch.config import Config
    from marqo_tpu_torch.inference import vectorise
    vectorise.clear_loaded_models()
    cfg = Config()
    cfg.index_management.bootstrap()
    cfg.index_management.create_index(
        IndexSettings(model="test").to_marqo_index("rr-index"))
    cfg.index_meta_cache.populate()
    yield cfg
    vectorise.clear_loaded_models()


def test_search_with_reranker_end_to_end(search_config):
    """As tests/test_reranker.py:96-115, on the port."""
    from marqo_tpu_torch.core.models.add_docs_params import AddDocsParams
    from marqo_tpu_torch.tensor_search import tensor_search
    tensor_search.add_documents(search_config, AddDocsParams(
        index_name="rr-index",
        docs=[{"_id": "1", "title": "red apple"},
              {"_id": "2", "title": "green pear"},
              {"_id": "3", "title": "blue car"}],
        tensor_fields=["title"]))
    res = tensor_search.search(
        search_config, "rr-index", text="apple",
        searchable_attributes=["title"], reranker="test-reranker",
        reranker_properties=PROPS)
    assert len(res["hits"]) == 3
    scores = [h["_score"] for h in res["hits"]]
    assert scores == sorted(scores, reverse=True)
    model = trerank._get_reranker("test-reranker", Device.CPU, PROPS)
    direct = model.score("apple", [h["title"] for h in res["hits"]])
    np.testing.assert_allclose(scores, direct, atol=1e-6)


def test_search_layer_rejects_none_searchable_attributes(search_config):
    from marqo_tpu_torch.api import exceptions as api_exceptions
    from marqo_tpu_torch.tensor_search import tensor_search
    with pytest.raises(api_exceptions.InvalidArgError,
                       match="cannot be None when re-ranking"):
        tensor_search.search(search_config, "rr-index", text="q",
                             reranker="test-reranker",
                             reranker_properties=PROPS)
