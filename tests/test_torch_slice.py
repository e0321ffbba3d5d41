"""The text search slice, end to end, in both packages at once.

One small random-init HF BERT checkpoint (``save_pretrained`` plus a
``tokenizer.json`` from ``build_test_wordpiece``) backs an index in the JAX
package's HTTP server and in marqo_tpu_torch's, both started in-process.
The same documents go in and the same queries run against both. Both
compute in bf16, so: /embed vectors agree to cosine 1e-3, scores agree
within 1e-3, and the top-5 hit ids agree up to hits that bf16 cannot
separate (reference scores within that tolerance).
"""

import json
import urllib.request

import numpy as np
import pytest

MODEL_PROPERTIES = {"type": "hf", "dimensions": 64, "tokens": 128,
                    "pooling_method": "mean"}

# well-separated documents: disjoint letter sets, so the char-level test
# WordPiece gives them disjoint token ids
DOCS = [
    {"_id": "abc", "text": "abc cab bca acb abcab"},
    {"_id": "def", "text": "def fed edf fde defed"},
    {"_id": "ghi", "text": "ghi hig igh ghigh"},
    {"_id": "jkl", "text": "jkl lkj kjl jlk jkljk lkjlk"},
    {"_id": "mno", "text": "mno onm nmo mnomn"},
    {"_id": "pqr", "text": "pqr rqp qrp pqrqp"},
    {"_id": "stu", "text": "stu uts tsu stust utsut"},
    {"_id": "vwx", "text": "vwx xwv wvx vwxvw"},
    {"_id": "yz0", "text": "yz0 0zy zy0 yz0yz 0zy0z"},
    {"_id": "123", "text": "123 321 213 12312"},
    {"_id": "456", "text": "456 654 546 45645 65465"},
    {"_id": "789", "text": "789 987 879 78978"},
]
QUERIES = ["abc cab", "fed edf", "ghi hig", "mno onm", "stu uts",
           "yz0 0zy", "456 654", "a d g j m"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    import torch

    from marqo_tpu.models.tokenizer import TextTokenizer
    path = tmp_path_factory.mktemp("slice-bert")
    tokenizer = TextTokenizer.build_test_wordpiece()
    torch.manual_seed(0)
    config = transformers.BertConfig(
        vocab_size=tokenizer._tok.get_vocab_size(), hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=128)
    transformers.BertModel(config).save_pretrained(str(path))
    tokenizer._tok.save(str(path / "tokenizer.json"))
    return str(path)


class _Server:
    def __init__(self, package: str):
        import importlib
        app_mod = importlib.import_module(f"{package}.api.app")
        framework = importlib.import_module(f"{package}.api.http_framework")
        self.config = app_mod.generate_config()
        app_mod.on_start(self.config)
        self.server = framework.serve(app_mod.build_app(self.config),
                                      host="127.0.0.1", port=0,
                                      background=True)
        self.port = self.server.server_address[1]

    def req(self, method, path, body=None):
        r = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=300) as resp:
            return json.load(resp)

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture(scope="module")
def servers(checkpoint):
    servers = {}
    with pytest.MonkeyPatch.context() as env:
        env.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
        # no CUDA device here: the port serves on the CPU only when asked
        env.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
        try:
            for package in ("marqo_tpu", "marqo_tpu_torch"):
                server = _Server(package)
                servers[package] = server
                props = dict(MODEL_PROPERTIES, localpath=checkpoint)
                server.req("POST", "/indexes/slice",
                           {"model": "slice-bert", "modelProperties": props})
                res = server.req("POST", "/indexes/slice/documents",
                                 {"documents": DOCS, "tensorFields": ["text"]})
                assert res["errors"] is False, res
            yield servers
        finally:
            for server in servers.values():
                server.close()
            from marqo_tpu.inference import vectorise as jax_vectorise
            from marqo_tpu_torch.inference import vectorise as torch_vectorise
            jax_vectorise.clear_loaded_models()
            torch_vectorise.clear_loaded_models()


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_embed_vectors_agree(servers):
    content = [d["text"] for d in DOCS[:4]] + QUERIES[:2]
    out = {p: s.req("POST", "/indexes/slice/embed", {"content": content})
           for p, s in servers.items()}
    ref, port = out["marqo_tpu"]["embeddings"], \
        out["marqo_tpu_torch"]["embeddings"]
    assert len(ref) == len(port) == len(content)
    for a, b in zip(ref, port):
        assert len(b) == 64
        assert _cosine(a, b) > 1 - 1e-3


@pytest.mark.parametrize("method", ["TENSOR", "HYBRID"])
@pytest.mark.parametrize("query", QUERIES)
def test_search_hits_and_scores_agree(servers, method, query):
    """Every document comes back from both, each with the same score to
    1e-3, and the top 5 agree. A random-init encoder places some documents
    closer together than bf16 can separate, so two hits whose reference
    scores are within that tolerance may trade places; every pair
    separated by more keeps its order."""
    body = {"q": query, "searchMethod": method, "limit": len(DOCS)}
    res = {p: s.req("POST", "/indexes/slice/search", body)
           for p, s in servers.items()}
    ref = {h["_id"]: h["_score"] for h in res["marqo_tpu"]["hits"]}
    port = {h["_id"]: h["_score"] for h in res["marqo_tpu_torch"]["hits"]}
    assert len(ref) > 0 and set(port) == set(ref)
    for doc_id, score in ref.items():
        assert abs(port[doc_id] - score) <= 1e-3, (doc_id, port[doc_id], score)
    order = [h["_id"] for h in res["marqo_tpu_torch"]["hits"]]
    for i, a in enumerate(order):
        for b in order[i + 1:]:
            # the port ranks a above b: the reference must not rank b
            # clearly above a
            assert ref[b] - ref[a] <= 1e-3, (a, b, ref[a], ref[b])
    top5 = [h["_id"] for h in res["marqo_tpu"]["hits"][:5]]
    fifth = ref[top5[-1]]
    assert set(order[:5]) - set(top5) <= {
        d for d, s in ref.items() if fifth - s <= 1e-3}


def test_both_packages_stored_the_same_documents(servers):
    for server in servers.values():
        stats = server.req("GET", "/indexes/slice/stats")
        assert stats["numberOfDocuments"] == len(DOCS)
