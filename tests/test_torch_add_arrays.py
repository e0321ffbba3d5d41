"""The port's add path hands embeddings from the encoder to the store as
float32 arrays (marqo_tpu_torch/core/add_documents.py,
marqo_tpu_torch/inference/vectorise.py), on the CPU with the tiny `test`
encoder:

(a) ``_vectorise_plans`` returns each field's rows as one C-contiguous
    float32 ``(chunks, dim)`` array, and the store holds the very bits that
    ``vectorise`` returns for the same texts: on the synchronous path and
    on the pipeline's;
(b) ``vectorise`` keeps its list contract without ``as_array``; with it,
    the same rows as one float32 array, bit for bit; the inference cache
    stores and serves lists; a 1-D encoder output is one row in both forms;
(c) a poisoned document under PER_DOCUMENT and PER_FIELD, synchronous and
    pipelined: the healthy documents' stored rows equal a clean add's, the
    poisoned one's are absent; a multimodal field's combined vector equals
    the list path's arithmetic;
(d) ``inference.rows_listed`` counts the rows turned into lists: none in a
    traced add, one a search query.
"""

import json

import numpy as np
import pytest

from marqo_tpu_torch.api.models.index_settings import IndexSettings
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.core.add_documents import AddDocumentsHandler
from marqo_tpu_torch.core.models.add_docs_params import (
    AddDocsParams, BatchVectorisationMode)
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
    """Spies on both of the add path's entry points: each call's contents
    and the rows it answered, and whether it asked for an array."""
    calls = []
    sync, dispatch = inference.vectorise, inference.vectorise_async

    def spy_sync(*args, **kwargs):
        out = sync(*args, **kwargs)
        calls.append((list(kwargs["content"]), kwargs.get("as_array"), out))
        return out

    def spy_async(*args, **kwargs):
        resolve = dispatch(*args, **kwargs)

        def resolved():
            out = resolve()
            calls.append((list(kwargs["content"]), kwargs.get("as_array"),
                          out))
            return out
        return resolved

    monkeypatch.setattr(inference, "vectorise", spy_sync)
    monkeypatch.setattr(inference, "vectorise_async", spy_async)
    return calls


def _record_scatter(monkeypatch):
    """What each ``_vectorise_plans_async`` resolve hands the feed."""
    scattered = []
    original = AddDocumentsHandler._vectorise_plans_async

    def recording(self, *args, **kwargs):
        resolve = original(self, *args, **kwargs)

        def resolved():
            out = resolve()
            scattered.append(out)
            return out
        return resolved

    monkeypatch.setattr(AddDocumentsHandler, "_vectorise_plans_async",
                        recording)
    return scattered


# --- (a) the array path, synchronous and pipelined ---------------------------

@pytest.mark.parametrize("sub_batch", [None, 3])
def test_the_store_holds_the_encoders_rows_bit_for_bit(config, monkeypatch,
                                                       sub_batch):
    if sub_batch is not None:
        monkeypatch.setenv("MARQO_TPU_INGEST_PIPELINE_SUB_BATCH",
                           str(sub_batch))
    docs = _docs(8)
    calls = _record_vectorise(monkeypatch)
    scattered = _record_scatter(monkeypatch)
    res = _add(config, docs)
    assert res["errors"] is False, res["items"]
    monkeypatch.undo()
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")

    # the synchronous path makes one call; the pipeline one per sub-batch
    assert len(calls) == (1 if sub_batch is None else 3)
    assert len(scattered) == len(calls)
    for _contents, as_array, out in calls:
        assert as_array is True
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
    chunk_counts = set()
    for fields in scattered:
        for (doc_id, field), rows in fields.items():
            assert isinstance(rows, np.ndarray), (doc_id, field)
            assert rows.dtype == np.float32 and rows.flags.c_contiguous
            chunks, stored = _stored(config, doc_id)[field]
            assert rows.shape == (len(chunks), 16)
            assert np.array_equal(_bits(rows), _bits(stored))
            chunk_counts.add(len(chunks))
    assert chunk_counts == {1, 2, 3, 4}

    # each call's texts, vectorised again in the list form
    for contents, _as_array, _out in calls:
        reference = np.asarray(inference.vectorise(
            "test", contents, device="cpu"), dtype=np.float32)
        row_of = {text: reference[i] for i, text in enumerate(contents)}
        for doc in docs:
            for field in ("title", "body"):
                chunks, stored = _stored(config, doc["_id"])[field]
                for chunk, row in zip(chunks, stored):
                    if chunk in row_of:
                        assert np.array_equal(_bits(row),
                                              _bits(row_of.pop(chunk)))
        assert not row_of  # every text of the call was stored


# --- (b) the contract of vectorise -------------------------------------------

def test_vectorise_answers_lists_and_with_as_array_the_same_rows(config):
    texts = ["one short text", "a second, somewhat longer text to embed",
             "three"]
    listed = inference.vectorise("test", texts, device="cpu")
    assert isinstance(listed, list) and len(listed) == 3
    assert all(isinstance(row, list) and len(row) == 16 and
               all(type(x) is float for x in row) for row in listed)
    rows = inference.vectorise("test", texts, device="cpu", as_array=True)
    assert isinstance(rows, np.ndarray)
    assert rows.dtype == np.float32 and rows.shape == (3, 16)
    assert np.array_equal(_bits(rows), _bits(listed))
    resolve = inference.vectorise_async("test", texts, device="cpu",
                                        as_array=True)
    assert np.array_equal(_bits(resolve()), _bits(listed))
    assert inference.vectorise_async("test", texts, device="cpu")() == listed


def test_the_cache_stores_and_serves_lists(config, monkeypatch):
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
        assert isinstance(hit, list) and hit == row
    # hits, a miss between them, in both forms
    mixed = [texts[0], "not cached yet", texts[1]]
    listed = inference.vectorise("test", mixed, device="cpu",
                                 enable_cache=True)
    assert listed[0] == first[0] and listed[2] == first[1]
    assert all(isinstance(row, list) for row in listed)
    rows = inference.vectorise("test", mixed, device="cpu",
                               enable_cache=True, as_array=True)
    assert rows.dtype == np.float32 and rows.shape == (3, 16)
    assert np.array_equal(_bits(rows), _bits(listed))
    every_hit = inference.vectorise_async("test", texts, device="cpu",
                                          enable_cache=True, as_array=True)
    assert np.array_equal(_bits(every_hit()), _bits(first))


def test_a_1d_encoder_output_is_one_row_in_both_forms(config):
    inference.vectorise("test", ["load"], device="cpu")
    (entry,) = inference._available_models.values()
    model = entry["model"]
    vector = np.arange(16, dtype=np.float32) / 16
    model.encode = lambda contents, **kwargs: vector
    model.encode_async = lambda contents, **kwargs: (lambda: vector)
    try:
        listed = inference.vectorise("test", ["x"], device="cpu")
        assert listed == [vector.tolist()]
        rows = inference.vectorise("test", ["x"], device="cpu",
                                   as_array=True)
        assert rows.shape == (1, 16) and np.array_equal(rows[0], vector)
        assert inference.vectorise_async("test", ["x"], device="cpu")() == \
            [vector.tolist()]
        rows = inference.vectorise_async("test", ["x"], device="cpu",
                                         as_array=True)()
        assert rows.shape == (1, 16) and np.array_equal(rows[0], vector)
    finally:
        del model.encode, model.encode_async


def test_a_patched_vectorise_that_answers_lists_still_feeds(config,
                                                            monkeypatch):
    real = inference.vectorise

    def as_lists(*args, **kwargs):
        kwargs.pop("as_array", None)
        return real(*args, **kwargs)

    monkeypatch.setattr(inference, "vectorise", as_lists)
    docs = _docs(3)
    assert _add(config, docs)["errors"] is False
    monkeypatch.setattr(inference, "vectorise", real)
    assert _add(config, docs, index=INDEX + "-clean")["errors"] is False
    for doc in docs:
        listed, clean = _stored(config, doc["_id"]), \
            _stored(config, doc["_id"], INDEX + "-clean")
        for field in ("title", "body"):
            assert listed[field][0] == clean[field][0]
            assert np.array_equal(_bits(listed[field][1]),
                                  _bits(clean[field][1]))


# --- (c) isolation on the array path -----------------------------------------

def _poison(monkeypatch):
    """vectorise and vectorise_async fail on any batch holding POISON."""
    sync, dispatch = inference.vectorise, inference.vectorise_async

    def check(kwargs):
        if any("POISON" in str(c) for c in kwargs["content"]):
            raise RuntimeError("poisoned content")

    def poisoned_sync(*args, **kwargs):
        check(kwargs)
        return sync(*args, **kwargs)

    def poisoned_async(*args, **kwargs):
        check(kwargs)
        return dispatch(*args, **kwargs)

    monkeypatch.setattr(inference, "vectorise", poisoned_sync)
    monkeypatch.setattr(inference, "vectorise_async", poisoned_async)


@pytest.mark.parametrize("sub_batch", [None, 2])
@pytest.mark.parametrize("mode", [BatchVectorisationMode.PER_DOCUMENT,
                                  BatchVectorisationMode.PER_FIELD])
def test_a_poisoned_document_fails_alone(config, monkeypatch, mode,
                                         sub_batch):
    if sub_batch is not None:
        monkeypatch.setenv("MARQO_TPU_INGEST_PIPELINE_SUB_BATCH",
                           str(sub_batch))
    healthy = _docs(5)
    poisoned = {"_id": "bad", "title": "a fine title",
                "body": "A fine sentence. Then POISON in the second."}
    docs = healthy[:2] + [poisoned] + healthy[2:]
    _poison(monkeypatch)
    res = _add(config, docs, batch_vectorisation_mode=mode)
    statuses = {item["_id"]: item["status"] for item in res["items"]}
    assert res["errors"] is True
    assert statuses.pop("bad") != 200
    assert set(statuses.values()) == {200}
    assert config.engine.get_tensors(INDEX, "bad") == {}

    # a clean add of the healthy documents, through the same isolation
    # path's groups: one document (or field) a call
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


@pytest.mark.parametrize("sub_batch", [None, 2])
def test_a_request_of_poisoned_documents_alone_fails_each(config,
                                                          monkeypatch,
                                                          sub_batch):
    if sub_batch is not None:
        monkeypatch.setenv("MARQO_TPU_INGEST_PIPELINE_SUB_BATCH",
                           str(sub_batch))
    _poison(monkeypatch)
    docs = [{"_id": f"bad{i}", "title": f"POISON {i}"} for i in range(3)]
    res = _add(config, docs)
    assert res["errors"] is True
    assert [item["status"] for item in res["items"]] == [500] * 3
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

    # the list path's arithmetic: each child's row from the list form, a
    # float32 mean of its rows, the weighted mean, then the norm
    acc, n = None, 0
    for child, content in (("title", "red apple"), ("body", "green pear")):
        row = inference.vectorise("test", [content], device="cpu")[0]
        vec = np.mean(np.asarray([row], dtype=np.float32), axis=0)
        acc = vec * weights[child] if acc is None \
            else acc + vec * weights[child]
        n += 1
    acc = acc / n
    acc = acc / float(np.linalg.norm(acc))
    assert np.array_equal(_bits(stored[0]), _bits(acc))


# --- (d) inference.rows_listed ----------------------------------------------

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


@pytest.mark.parametrize("sub_batch", [None, 2])
def test_rows_listed_is_zero_in_an_add_and_one_a_query(app, monkeypatch,
                                                       sub_batch):
    if sub_batch is not None:
        monkeypatch.setenv("MARQO_TPU_INGEST_PIPELINE_SUB_BATCH",
                           str(sub_batch))
    body = _call(app, "POST", f"/indexes/{INDEX}/documents?telemetry=true",
                 {"documents": _docs(6), "tensorFields": ["title", "body"]})
    assert body["errors"] is False
    assert "inference.to_lists" in body["telemetry"]["timesMs"]
    assert body["telemetry"].get("counter", {}).get(
        "inference.rows_listed", 0) == 0
    for query in ("topic three", "document five"):
        body = _call(app, "POST", f"/indexes/{INDEX}/search?telemetry=true",
                     {"q": query})
        assert body["hits"]
        assert body["telemetry"]["counter"]["inference.rows_listed"] == 1
    body = _call(app, "POST", f"/indexes/{INDEX}/search?telemetry=true",
                 {"q": {"first query": 1.0, "second query": 0.5}})
    assert body["telemetry"]["counter"]["inference.rows_listed"] == 2
