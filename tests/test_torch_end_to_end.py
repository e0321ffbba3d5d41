"""End-to-end integration tests of marqo_tpu_torch (port of
tests/test_end_to_end.py): create index → add documents → search →
get/delete. Uses the tiny real `test` torch encoder (reference strategy:
cheap deterministic models for orchestration tests, SURVEY.md §4), on the
CPU."""

import pytest

from marqo_tpu_torch.api.models.index_settings import IndexSettings
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.core.models.add_docs_params import AddDocsParams
from marqo_tpu_torch.inference import vectorise as inference
from marqo_tpu_torch.tensor_search import tensor_search

DOCS = [
    {"_id": "d1", "title": "The red apple",
     "description": "A crisp red apple grown in the orchard. Quite tasty."},
    {"_id": "d2", "title": "Green pear",
     "description": "A juicy green pear from the valley."},
    {"_id": "d3", "title": "Fast red car",
     "description": "A speedy vehicle painted bright red.", "price": 30000},
]


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """This host has no CUDA device: the port serves on the CPU on
    purpose."""
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")


@pytest.fixture
def config():
    inference.clear_loaded_models()
    cfg = Config()
    cfg.index_management.bootstrap()
    settings = IndexSettings(model="test")
    cfg.index_management.create_index(settings.to_marqo_index("my-index"))
    cfg.index_meta_cache.populate()
    yield cfg
    inference.clear_loaded_models()


def _add_docs(cfg, docs=DOCS, **kwargs):
    params = AddDocsParams(index_name="my-index", docs=docs,
                           tensor_fields=kwargs.pop(
                               "tensor_fields", ["title", "description"]),
                           **kwargs)
    return tensor_search.add_documents(cfg, params)


class TestAddDocuments:
    def test_add_and_count(self, config):
        res = _add_docs(config)
        assert res["errors"] is False
        assert all(i["status"] == 200 for i in res["items"])
        assert config.engine.doc_count("my-index") == 3

    def test_per_doc_error_isolation(self, config):
        docs = [{"_id": "ok1", "title": "fine"},
                {"_id": 123, "title": "bad id"},
                {"_id": "ok2", "title": "also fine"}]
        res = _add_docs(config, docs=docs)
        assert res["errors"] is True
        statuses = {i["_id"]: i["status"] for i in res["items"]}
        assert statuses["ok1"] == 200 and statuses["ok2"] == 200
        assert any(i["status"] == 400 for i in res["items"])
        assert config.engine.doc_count("my-index") == 2

    def test_duplicate_id_last_wins(self, config):
        docs = [{"_id": "dup", "title": "first version"},
                {"_id": "dup", "title": "second version"}]
        res = _add_docs(config, docs=docs)
        assert config.engine.doc_count("my-index") == 1
        doc = tensor_search.get_document_by_id(config, "my-index", "dup")
        assert doc["title"] == "second version"

    def test_missing_tensor_fields_param_raises(self, config):
        # request-level 400 (reference unstructured_validation.py:118-121)
        from marqo_tpu_torch.core.exceptions import InvalidArgumentError
        params = AddDocsParams(index_name="my-index",
                               docs=[{"_id": "x", "title": "y"}])
        with pytest.raises(InvalidArgumentError) as exc:
            tensor_search.add_documents(config, params)
        assert "tensor_fields must be explicitly provided" in str(exc.value)

    def test_auto_id_generated(self, config):
        res = _add_docs(config, docs=[{"title": "no id here"}])
        assert res["items"][0]["status"] == 200
        assert len(res["items"][0]["_id"]) > 10

    def test_custom_vector_field(self, config):
        dims = 16
        vec = [1.0] + [0.0] * (dims - 1)
        docs = [{"_id": "cv", "my_vec": {"content": "hand-made",
                                         "vector": vec}}]
        res = _add_docs(config, docs=docs, tensor_fields=["my_vec"],
                        mappings={"my_vec": {"type": "custom_vector"}})
        assert res["errors"] is False
        search_res = tensor_search.search(
            config, "my-index", context={"tensor": [{"vector": vec,
                                                     "weight": 1.0}]})
        assert search_res["hits"][0]["_id"] == "cv"
        assert search_res["hits"][0]["_score"] > 0.99

    def test_multimodal_combination_field(self, config):
        docs = [{"_id": "mm", "t1": "red apple", "t2": "green pear"}]
        res = _add_docs(
            config, docs=docs, tensor_fields=["combo"],
            mappings={"combo": {"type": "multimodal_combination",
                                "weights": {"t1": 0.7, "t2": 0.3}}})
        assert res["errors"] is False, res["items"]
        assert config.engine.vector_count("my-index") == 1

    def test_use_existing_tensors(self, config):
        _add_docs(config)
        calls = []
        orig = inference.vectorise

        def spy(*args, **kwargs):
            calls.append(kwargs.get("content") or args[1])
            return orig(*args, **kwargs)

        inference.vectorise, tensor_search.inference.vectorise = spy, spy
        try:
            from marqo_tpu_torch.core import add_documents as ad
            orig_ad = ad.inference.vectorise
            ad.inference.vectorise = spy
            try:
                res = _add_docs(config, docs=[DOCS[0]],
                                use_existing_tensors=True)
            finally:
                ad.inference.vectorise = orig_ad
        finally:
            inference.vectorise = orig
            tensor_search.inference.vectorise = orig
        assert res["errors"] is False
        assert calls == []  # nothing re-embedded: content unchanged


class TestSearch:
    def test_tensor_search_self_retrieval(self, config):
        _add_docs(config)
        res = tensor_search.search(config, "my-index",
                                   text="A crisp red apple grown in the orchard. Quite tasty.")
        assert res["hits"][0]["_id"] == "d1"
        assert "processingTimeMs" in res
        assert res["hits"][0]["_highlights"]

    def test_lexical_search(self, config):
        _add_docs(config)
        res = tensor_search.search(config, "my-index", text="juicy pear",
                                   search_method="LEXICAL")
        assert res["hits"][0]["_id"] == "d2"

    def test_lexical_required_phrase(self, config):
        _add_docs(config)
        res = tensor_search.search(config, "my-index",
                                   text='red "speedy vehicle"',
                                   search_method="LEXICAL")
        assert [h["_id"] for h in res["hits"]] == ["d3"]

    def test_hybrid_search(self, config):
        _add_docs(config)
        res = tensor_search.search(config, "my-index", text="red apple",
                                   search_method="HYBRID")
        assert len(res["hits"]) > 0
        top = res["hits"][0]
        assert "_tensor_score" in top or "_lexical_score" in top

    def test_filter_string(self, config):
        _add_docs(config)
        res = tensor_search.search(config, "my-index", text="red",
                                   filter="price:[20000 TO 40000]")
        assert [h["_id"] for h in res["hits"]] == ["d3"]

    def test_weighted_multi_query(self, config):
        _add_docs(config)
        res = tensor_search.search(
            config, "my-index",
            text={"red apple": 1.0, "green pear": -0.3})
        assert len(res["hits"]) == 3

    def test_searchable_attributes(self, config):
        _add_docs(config)
        res = tensor_search.search(config, "my-index", text="pear",
                                   search_method="LEXICAL",
                                   searchable_attributes=["title"])
        assert [h["_id"] for h in res["hits"]] == ["d2"]

    def test_attributes_to_retrieve(self, config):
        _add_docs(config)
        res = tensor_search.search(config, "my-index", text="apple",
                                   attributes_to_retrieve=["title"])
        hit = res["hits"][0]
        assert "description" not in hit
        assert "title" in hit and "_id" in hit and "_score" in hit

    def test_limit_validation(self, config):
        with pytest.raises(Exception):
            tensor_search.search(config, "my-index", text="x", limit=0)
        with pytest.raises(Exception):
            tensor_search.search(config, "my-index", text="x", limit=100000)

    def test_score_modifiers(self, config):
        _add_docs(config)
        res = tensor_search.search(
            config, "my-index", text="red",
            score_modifiers={"add_to_score": [{"field_name": "price",
                                               "weight": 1.0}]})
        assert res["hits"][0]["_id"] == "d3"


class TestDocumentOps:
    def test_get_document(self, config):
        _add_docs(config)
        doc = tensor_search.get_document_by_id(config, "my-index", "d1")
        assert doc["title"] == "The red apple"

    def test_get_document_with_vectors(self, config):
        _add_docs(config)
        doc = tensor_search.get_document_by_id(config, "my-index", "d1",
                                               show_vectors=True)
        assert len(doc["_tensor_facets"]) >= 2  # title + description chunks

    def test_get_documents_batch(self, config):
        _add_docs(config)
        res = tensor_search.get_documents_by_ids(
            config, "my-index", ["d1", "missing", "d2"])
        found = {r["_id"]: r["_found"] for r in res["results"]}
        assert found == {"d1": True, "missing": False, "d2": True}

    def test_delete_documents(self, config):
        _add_docs(config)
        res = tensor_search.delete_documents(config, "my-index",
                                             ["d1", "missing"])
        # missing ids count as deleted (Vespa-200 semantics,
        # reference test_delete_documents.py:234-245)
        assert res["details"]["deletedDocuments"] == 2
        assert config.engine.doc_count("my-index") == 2


class TestSemiStructuredSchemaGrowth:
    def test_fields_grow_on_add(self, config):
        _add_docs(config)
        index = config.index_management.get_index("my-index")
        assert {f.name for f in index.lexical_fields} >= {"title", "description"}
        assert {tf.name for tf in index.tensor_fields} == {"title", "description"}
        assert index.version == 2

    def test_no_update_when_no_new_fields(self, config):
        _add_docs(config)
        v1 = config.index_management.get_index("my-index").version
        _add_docs(config, docs=[{"_id": "d9", "title": "another one",
                                 "description": "more text"}])
        assert config.index_management.get_index("my-index").version == v1


class TestItemOrdering:
    def test_items_in_request_order(self, config):
        """Response items preserve the request's document order even when
        failures interleave (reference response shape)."""
        docs = [{"_id": "ok0", "title": "a"},
                {"_id": 123, "title": "bad id"},
                {"_id": "ok1", "title": "b"},
                {"_id": "", "title": "empty id"},
                {"_id": "ok2", "title": "c"}]
        res = _add_docs(config, docs=docs)
        statuses = [i["status"] for i in res["items"]]
        assert statuses == [200, 400, 200, 400, 200]
        assert [i["_id"] for i in res["items"] if i["status"] == 200] == \
            ["ok0", "ok1", "ok2"]


class TestIdTensorFieldRejected:
    def test_id_cannot_be_tensor_field(self, config):
        """reference unstructured_validation.py:122-123 — request-level 400
        (previously the _id string was silently vectorised)."""
        from marqo_tpu_torch.core.exceptions import InvalidArgumentError
        with pytest.raises(InvalidArgumentError,
                           match="`_id` field cannot be a tensor field"):
            _add_docs(config, docs=[{"_id": "x", "title": "hi"}],
                      tensor_fields=["_id", "title"])


class TestMultimodalConflicts:
    def test_direct_value_for_multimodal_field_rejected(self, config):
        """reference unstructured_validation.py:106-110: a doc may not carry
        a direct value for a field declared multimodal in mappings."""
        res = _add_docs(
            config,
            docs=[{"_id": "c1", "combo": "direct", "s1": "hello"},
                  {"_id": "c2", "s1": "fine"}],
            tensor_fields=["combo"],
            mappings={"combo": {"type": "multimodal_combination",
                                "weights": {"s1": 1.0}}})
        assert res["errors"] is True
        items = {i["_id"]: i for i in res["items"]}
        assert items["c1"]["status"] == 400
        assert "conflicting fields" in items["c1"]["error"]
        assert items["c2"]["status"] == 200  # per-doc isolation
