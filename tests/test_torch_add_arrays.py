"""The port's add path hands embeddings from the encoder to the store as
float32 arrays on one synchronous path, plan, vectorise, feed
(marqo_tpu_torch/core/add_documents.py,
marqo_tpu_torch/inference/vectorise.py), on the CPU with the tiny `test`
encoder, at a small request and at 264 documents (above the encoder's top
batch bucket, with MARQO_MAX_ADD_DOCS_COUNT raised to take it):

(a) ``_vectorise_plans`` returns each field's rows as one C-contiguous
    float32 ``(chunks, dim)`` array, and the store holds the very bits that
    the one ``vectorise`` call of the add answered;
(b) ``vectorise`` answers one C-contiguous float32 ``(n, dim)`` array; the
    inference cache stores a float32 row a text and its hits equal the
    misses' rows bit for bit; a 1-D encoder output is one row;
(c) a poisoned document under PER_DOCUMENT and PER_FIELD: the healthy
    documents' stored rows equal a clean add's, the poisoned one's are
    absent; a multimodal field's combined vector equals the arithmetic on
    ``vectorise``'s rows;
(d) over HTTP, ``/embed``'s vector and the vector ``/search`` hands the
    engine are the query arithmetic on the rows ``vectorise`` answers for
    the same text, bit for bit, served from the cache or not.
"""

import json

import numpy as np
import pytest

from marqo_tpu_torch.api.models.index_settings import IndexSettings
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.core.add_documents import AddDocumentsHandler
from marqo_tpu_torch.core.models.add_docs_params import (
    AddDocsParams, BatchVectorisationMode)
from marqo_tpu_torch.engine.store import StoreEngine
from marqo_tpu_torch.inference import vectorise as inference
from marqo_tpu_torch.tensor_search import tensor_search

INDEX = "arrays"
SENTENCES = [f"Sentence {i} of the corpus, about topic {i * 7 % 11}."
             for i in range(64)]


def _docs(n, first=0):
    """Documents whose bodies split into 1-4 chunks (two sentences a
    chunk), every sentence distinct."""
    docs = []
    for d in range(first, first + n):
        count = 1 + d % 4  # chunks: a sentence and "Doc d." a chunk
        body = " ".join(SENTENCES[(d * 5 + k) % len(SENTENCES)] +
                        f" Doc {d}." for k in range(count))
        docs.append({"_id": f"doc{d}", "title": f"Title of document {d}",
                     "body": body})
    return docs


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """This host has no CUDA device: the port serves on the CPU on
    purpose."""
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")


@pytest.fixture
def config():
    inference.clear_loaded_models()
    inference.clear_inference_cache()
    cfg = Config()
    cfg.index_management.bootstrap()
    cfg.index_management.create_index(
        IndexSettings(model="test").to_marqo_index(INDEX))
    cfg.index_management.create_index(
        IndexSettings(model="test").to_marqo_index(INDEX + "-clean"))
    cfg.index_meta_cache.populate()
    yield cfg
    inference.clear_loaded_models()
    inference.clear_inference_cache()


def _add(cfg, docs, index=INDEX, **kwargs):
    params = AddDocsParams(
        index_name=index, docs=docs,
        tensor_fields=kwargs.pop("tensor_fields", ["title", "body"]),
        **kwargs)
    return tensor_search.add_documents(cfg, params)


def _stored(cfg, doc_id, index=INDEX):
    """{field: (chunks, float32 rows)} as the store holds them."""
    return {field: ([e["chunk"] for e in entries],
                    np.asarray([e["embedding"] for e in entries],
                               dtype=np.float32))
            for field, entries in
            cfg.engine.get_tensors(index, doc_id).items()}


def _bits(rows):
    return np.ascontiguousarray(rows, dtype=np.float32).view(np.uint32)


def _record_vectorise(monkeypatch):
    """Spies on ``vectorise``: each call's contents and the rows it
    answered."""
    calls = []
    real = inference.vectorise

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((list(kwargs["content"]), out))
        return out

    monkeypatch.setattr(inference, "vectorise", spy)
    return calls


def _record_scatter(monkeypatch):
    """What each ``_vectorise_plans`` hands the feed."""
    scattered = []
    real = AddDocumentsHandler._vectorise_plans

    def recording(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        scattered.append(out)
        return out

    monkeypatch.setattr(AddDocumentsHandler, "_vectorise_plans", recording)
    return scattered


def _request_of(monkeypatch, n):
    """Lets a request carry ``n`` documents."""
    if n > 128:
        monkeypatch.setenv("MARQO_MAX_ADD_DOCS_COUNT", str(n))


# --- (a) the array path ------------------------------------------------------

@pytest.mark.parametrize("docs", [8, 264])
def test_the_store_holds_the_encoders_rows_bit_for_bit(config, monkeypatch,
                                                       docs):
    _request_of(monkeypatch, docs)
    docs = _docs(docs)
    calls = _record_vectorise(monkeypatch)
    scattered = _record_scatter(monkeypatch)
    res = _add(config, docs)
    assert res["errors"] is False, res["items"]
    monkeypatch.undo()
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")

    # one vectorise call, one scatter, whatever the request's size
    assert len(calls) == len(scattered) == 1
    (contents, out), = calls
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert out.shape == (len(contents), 16)
    chunk_counts = set()
    for (doc_id, field), rows in scattered[0].items():
        assert isinstance(rows, np.ndarray), (doc_id, field)
        assert rows.dtype == np.float32 and rows.flags.c_contiguous
        chunks, stored = _stored(config, doc_id)[field]
        assert rows.shape == (len(chunks), 16)
        assert np.array_equal(_bits(rows), _bits(stored))
        chunk_counts.add(len(chunks))
    assert chunk_counts == {1, 2, 3, 4}

    # each text's row as the call answered it, in the store
    row_of = {text: out[i] for i, text in enumerate(contents)}
    assert len(row_of) == len(contents)  # every text distinct
    for doc in docs:
        for field in ("title", "body"):
            chunks, stored = _stored(config, doc["_id"])[field]
            for chunk, row in zip(chunks, stored):
                assert np.array_equal(_bits(row), _bits(row_of.pop(chunk)))
    assert not row_of  # every text of the call was stored


# --- (b) the contract of vectorise -------------------------------------------

def test_vectorise_answers_one_float32_array(config):
    texts = ["one short text", "a second, somewhat longer text to embed",
             "three"]
    rows = inference.vectorise("test", texts, device="cpu")
    assert isinstance(rows, np.ndarray)
    assert rows.dtype == np.float32 and rows.shape == (3, 16)
    assert rows.flags.c_contiguous
    one = inference.vectorise("test", "three", device="cpu")
    assert one.dtype == np.float32 and one.shape == (1, 16)
    assert one.flags.c_contiguous


def test_the_cache_stores_float32_rows_and_serves_them(config, monkeypatch):
    monkeypatch.setenv("MARQO_INFERENCE_CACHE_SIZE", "10")
    inference.clear_inference_cache()
    texts = ["cached text", "another cached text"]
    first = inference.vectorise("test", texts, device="cpu",
                                enable_cache=True)
    cache = inference._get_inference_cache()
    assert cache.enabled
    (key,) = {k for k in inference._available_models}
    for text, row in zip(texts, first):
        hit = cache.get(key, text)
        assert isinstance(hit, np.ndarray)
        assert hit.dtype == np.float32 and hit.shape == (16,)
        assert np.array_equal(_bits(hit), _bits(row))
        # a copy of its row: an entry holds no whole batch alive
        assert hit.base is None and not np.shares_memory(hit, first)
    # hits with a miss between them
    mixed = [texts[0], "not cached yet", texts[1]]
    rows = inference.vectorise("test", mixed, device="cpu",
                               enable_cache=True)
    assert rows.dtype == np.float32 and rows.shape == (3, 16)
    assert rows.flags.c_contiguous
    assert np.array_equal(_bits(rows[[0, 2]]), _bits(first))
    uncached = inference.vectorise("test", ["not cached yet"], device="cpu")
    assert np.array_equal(_bits(rows[1]), _bits(uncached[0]))
    every_hit = inference.vectorise("test", texts, device="cpu",
                                    enable_cache=True)
    assert np.array_equal(_bits(every_hit), _bits(first))


def test_a_1d_encoder_output_is_one_row(config):
    inference.vectorise("test", ["load"], device="cpu")
    (entry,) = inference._available_models.values()
    model = entry["model"]
    vector = np.arange(16, dtype=np.float32) / 16
    model.encode = lambda contents, **kwargs: vector
    try:
        rows = inference.vectorise("test", ["x"], device="cpu")
        assert rows.shape == (1, 16) and rows.dtype == np.float32
        assert np.array_equal(rows[0], vector)
    finally:
        del model.encode


# --- (c) isolation on the array path -----------------------------------------

def _poison(monkeypatch):
    """vectorise fails on any batch holding POISON."""
    real = inference.vectorise

    def poisoned(*args, **kwargs):
        if any("POISON" in str(c) for c in kwargs["content"]):
            raise RuntimeError("poisoned content")
        return real(*args, **kwargs)

    monkeypatch.setattr(inference, "vectorise", poisoned)


@pytest.mark.parametrize("docs", [6, 130])
@pytest.mark.parametrize("mode", [BatchVectorisationMode.PER_DOCUMENT,
                                  BatchVectorisationMode.PER_FIELD])
def test_a_poisoned_document_fails_alone(config, monkeypatch, mode, docs):
    _request_of(monkeypatch, docs)
    healthy = _docs(docs - 1)
    poisoned = {"_id": "bad", "title": "a fine title",
                "body": "A fine sentence. Then POISON in the second."}
    docs = healthy[:2] + [poisoned] + healthy[2:]
    _poison(monkeypatch)
    res = _add(config, docs, batch_vectorisation_mode=mode)
    statuses = {item["_id"]: item["status"] for item in res["items"]}
    assert res["errors"] is True
    assert statuses.pop("bad") != 200
    assert set(statuses.values()) == {200}
    assert len(statuses) == len(healthy)
    assert config.engine.get_tensors(INDEX, "bad") == {}

    # a clean add of the healthy documents: one batched call, against the
    # poisoned add's one document (or field) a call
    clean = _add(config, healthy, index=INDEX + "-clean",
                 batch_vectorisation_mode=mode)
    assert clean["errors"] is False
    for doc in healthy:
        got, want = _stored(config, doc["_id"]), \
            _stored(config, doc["_id"], INDEX + "-clean")
        assert set(got) == set(want) == {"title", "body"}
        for field in want:
            assert got[field][0] == want[field][0]
            assert np.array_equal(_bits(got[field][1]), _bits(want[field][1]))


@pytest.mark.parametrize("docs", [3, 264])
def test_a_request_of_poisoned_documents_alone_fails_each(config,
                                                          monkeypatch,
                                                          docs):
    _request_of(monkeypatch, docs)
    _poison(monkeypatch)
    docs = [{"_id": f"bad{i}", "title": f"POISON {i}"} for i in range(docs)]
    res = _add(config, docs)
    assert res["errors"] is True
    assert [item["status"] for item in res["items"]] == [500] * len(docs)
    assert config.engine.doc_count(INDEX) == 0


def test_a_multimodal_field_combines_as_the_list_path_did(config):
    weights = {"title": 0.7, "body": 0.3}
    docs = [{"_id": "mm", "title": "red apple", "body": "green pear"},
            {"_id": "other", "title": "a filler title",
             "body": "A filler body. With two sentences."}]
    res = _add(config, docs, tensor_fields=["combo", "body"],
               mappings={"combo": {"type": "multimodal_combination",
                                   "weights": weights}})
    assert res["errors"] is False, res["items"]
    chunks, stored = _stored(config, "mm")["combo"]
    assert stored.shape == (1, 16)

    # the combine's arithmetic on vectorise's rows: each child's row, a
    # float32 mean of its rows, the weighted mean, then the norm
    acc, n = None, 0
    for child, content in (("title", "red apple"), ("body", "green pear")):
        row = inference.vectorise("test", [content], device="cpu")[0]
        vec = np.mean(row[None, :], axis=0)
        acc = vec * weights[child] if acc is None \
            else acc + vec * weights[child]
        n += 1
    acc = acc / n
    acc = acc / float(np.linalg.norm(acc))
    assert np.array_equal(_bits(stored[0]), _bits(acc))


# --- (d) the rows over HTTP --------------------------------------------------

@pytest.fixture
def app(monkeypatch):
    from marqo_tpu_torch.api.app import build_app, on_start
    monkeypatch.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
    inference.clear_loaded_models()
    cfg = Config()
    on_start(cfg)
    app = build_app(cfg)
    _call(app, "POST", f"/indexes/{INDEX}", {"model": "test"})
    yield app
    cfg.index_meta_cache.stop_refresh_thread()
    inference.clear_loaded_models()


def _call(app, method, path, body=None):
    response = app.dispatch(method, path,
                            json.dumps(body).encode() if body else b"", {})
    assert response.status == 200, (response.status, response.body)
    return response.body


@pytest.mark.parametrize("query", [
    "topic three", {"first query": 1.0, "second query": 0.5}],
    ids=["text", "weighted"])
def test_search_and_embed_answer_the_rows_vectorise_answers(app, monkeypatch,
                                                            query):
    monkeypatch.setenv("MARQO_INFERENCE_CACHE_SIZE", "10")
    inference.clear_inference_cache()
    body = _call(app, "POST", f"/indexes/{INDEX}/documents?telemetry=true",
                 {"documents": _docs(6), "tensorFields": ["title", "body"]})
    assert body["errors"] is False
    assert "inference.to_lists" in body["telemetry"]["timesMs"]
    weighted = {query: 1.0} if isinstance(query, str) else query
    vectorise = inference.vectorise
    calls = _record_vectorise(monkeypatch)
    handed = []  # the vector each search hands the engine
    query_tensor = StoreEngine.query_tensor

    def watched(self, index_name, vector, *args, **kwargs):
        handed.append(list(vector))
        return query_tensor(self, index_name, vector, *args, **kwargs)

    monkeypatch.setattr(StoreEngine, "query_tensor", watched)

    # a miss of the inference cache, then a hit
    hits = []
    for counter in ("inference_cache.misses", "inference_cache.hits"):
        body = _call(app, "POST", f"/indexes/{INDEX}/search?telemetry=true",
                     {"q": query})
        assert body["telemetry"]["counter"][counter] == len(weighted)
        assert body["hits"]
        hits.append([(h["_id"], h["_score"]) for h in body["hits"]])
    embedded = _call(app, "POST", f"/indexes/{INDEX}/embed",
                     {"content": query})["embeddings"]

    assert len(calls) == 3
    contents, rows = calls[0]
    assert contents == list(weighted)
    for again, answered in calls[1:]:
        assert again == contents
        assert np.array_equal(_bits(answered), _bits(rows))
    fresh = vectorise("test", contents, device="cpu")
    assert np.array_equal(_bits(fresh), _bits(rows))
    # the query arithmetic of compute_query_vector on those rows
    acc = np.zeros(16, dtype=np.float32)
    for row, weight in zip(rows, weighted.values()):
        acc += row * weight
    if len(weighted) > 1:
        acc = acc / len(weighted)
    want = (acc / float(np.linalg.norm(acc))).tolist()
    assert handed == [want, want]
    assert hits[0] == hits[1]
    assert embedded == [want]
