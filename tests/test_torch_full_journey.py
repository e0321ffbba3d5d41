"""Full-journey smoke over marqo_tpu_torch's real HTTP server (port of
tests/test_full_journey.py): the README quick-start flow plus DDL, mixed
search methods, recommend, embed, partial updates, stats, settings history,
model ops — one continuous scenario, on the CPU. The tests run in order and
each builds on the last. The server takes a free port (the JAX package's
test holds a fixed one, and the two files may run at once)."""

import pytest

import httpx

from marqo_tpu_torch.api.app import build_app, on_start
from marqo_tpu_torch.api.http_framework import serve
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.inference import vectorise as inference


@pytest.fixture(scope="module")
def base_url(tmp_path_factory):
    with pytest.MonkeyPatch.context() as env:
        env.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
        env.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
        inference.clear_loaded_models()
        config = Config()
        on_start(config)
        server = serve(build_app(config), host="127.0.0.1", port=0,
                       background=True)
        yield f"http://127.0.0.1:{server.server_address[1]}"
        server.shutdown()
        server.server_close()
        config.index_meta_cache.stop_refresh_thread()
        inference.clear_loaded_models()


@pytest.fixture(scope="module")
def http(base_url):
    with httpx.Client(base_url=base_url, timeout=60) as client:
        yield client


class TestFullJourney:
    def test_01_quickstart_flow(self, http):
        assert http.get("/health").json()["status"] == "green"
        r = http.post("/indexes/movies", json={"model": "test"})
        assert r.status_code == 200
        r = http.post("/indexes/movies/documents", json={
            "documents": [
                {"_id": "m1", "Title": "The Travels of Marco Polo",
                 "Description": "A 13th-century travelogue", "year": 1300},
                {"_id": "m2", "Title": "Extravehicular Mobility Unit",
                 "Description": "A spacesuit for astronauts", "year": 1981},
            ],
            "tensorFields": ["Title", "Description"]})
        assert r.status_code == 200 and r.json()["errors"] is False

        for method in ("TENSOR", "LEXICAL", "HYBRID"):
            r = http.post("/indexes/movies/search",
                          json={"q": "spacesuit astronaut",
                                "searchMethod": method})
            assert r.status_code == 200, (method, r.text)
            if method != "TENSOR":
                assert r.json()["hits"][0]["_id"] == "m2"

        r = http.post("/indexes/movies/search",
                      json={"q": "travelogue", "searchMethod": "LEXICAL",
                            "filter": "year:[1200 TO 1400]"})
        assert [h["_id"] for h in r.json()["hits"]] == ["m1"]

    def test_02_recommend_and_embed(self, http):
        r = http.post("/indexes/movies/recommend",
                      json={"documents": ["m1"], "limit": 5})
        assert r.status_code == 200
        assert "m1" not in [h["_id"] for h in r.json()["hits"]]
        r = http.post("/indexes/movies/embed",
                      json={"content": ["hello", {"a": 0.5, "b": 0.5}]})
        assert r.status_code == 200
        assert len(r.json()["embeddings"]) == 2

    def test_03_stats_settings_history(self, http):
        stats = http.get("/indexes/movies/stats").json()
        assert stats["numberOfDocuments"] == 2
        assert stats["numberOfVectors"] >= 4
        settings = http.get("/indexes/movies/settings").json()
        assert settings["model"] == "test"
        history = http.get("/indexes/movies/settings/history").json()
        # semi-structured growth during add-docs created ≥1 prior version
        assert len(history["history"]) >= 1

    def test_04_document_lifecycle(self, http):
        r = http.get("/indexes/movies/documents/m1",
                     params={"expose_facets": "true"})
        assert r.status_code == 200
        assert len(r.json()["_tensor_facets"]) >= 2
        r = http.post("/indexes/movies/documents/delete-batch",
                      json=["m2", "ghost"])
        body = r.json()
        # missing ids count as deleted (Vespa-200 semantics, reference
        # test_delete_documents.py:234-245)
        assert body["details"]["deletedDocuments"] == 2
        assert http.get("/indexes/movies/stats").json()[
            "numberOfDocuments"] == 1

    def test_05_models_and_teardown(self, http):
        models = http.get("/models").json()["models"]
        assert any(m["model_name"] == "test" for m in models)
        r = http.delete("/models", params={"model_name": "test",
                                           "model_device": "cpu"})
        assert r.status_code == 200
        assert http.delete("/indexes/movies").status_code == 200
        assert http.get("/indexes/movies/stats").status_code == 404
