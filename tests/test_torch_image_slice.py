"""The text-and-image search slice, end to end, in both packages at once.

One small random-init HF CLIP checkpoint (``CLIPModel.save_pretrained``
plus a byte-level ``vocab.json`` with no merges, so the CLIP tokenizer
loads offline) backs an index with ``treatUrlsAndPointersAsImages`` in the
JAX package's HTTP server and in marqo_tpu_torch's, both started
in-process. Documents carry an image path (a PNG made from a numpy seed),
a caption and a ``multimodal_combination`` field. Queries search by text,
by an image path and by a weighted image-and-text query.

Both packages serve CLIP in bf16, but XLA and torch round bf16 at
different points (XLA rounds a matmul and then its bias add; torch fuses
them), and one EOS-pooled token carries that noise into every score: with
each vector at cosine 1 - 5e-5 between the packages, scores still differ
by up to ~1.3e-3. So the slice runs both packages' CLIP wrappers in fp32,
where a difference is the port's own: /embed vectors agree to cosine 1e-3,
scores agree within 1e-3, hit order agrees up to hits within that
tolerance, and an image query finds its own document first. bf16 is held
at tower level (tests/test_torch_clip.py) and on the card.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models.clip import JaxCLIPModel
from marqo_tpu_torch.models.clip import TorchCLIPModel
from tests.test_torch_slice import _cosine, _Server

DIMS = 24
N_DOCS = 8
COLORS = ["red", "green", "blue", "yellow", "purple", "orange", "white",
          "black"]


def _write_tokenizer(path):
    """A byte-level BPE vocabulary with no merges: every byte symbol, the
    same with the end-of-word mark, and the two special tokens (514 ids;
    <|endoftext|> is 513)."""
    from transformers.models.clip.tokenization_clip import bytes_to_unicode
    symbols = list(bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols)}
    vocab.update({s + "</w>": len(symbols) + i for i, s in enumerate(symbols)})
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n")
    return len(vocab)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    path = tmp_path_factory.mktemp("slice-clip")
    vocab_size = _write_tokenizer(path)
    assert vocab_size == 514
    torch.manual_seed(0)
    config = transformers.CLIPConfig(
        text_config={"vocab_size": vocab_size, "hidden_size": 32,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "intermediate_size": 64, "max_position_embeddings": 32,
                     "bos_token_id": 512, "eos_token_id": 513,
                     "pad_token_id": 513},
        vision_config={"image_size": 32, "patch_size": 8, "hidden_size": 32,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "intermediate_size": 64},
        projection_dim=DIMS)
    transformers.CLIPModel(config).save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """PNGs from a numpy seed: a colour field under a gradient and noise,
    in several sizes and both orientations."""
    from PIL import Image
    path = tmp_path_factory.mktemp("slice-images")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(N_DOCS):
        h, w = (40 + 8 * i, 56) if i % 2 else (48, 36 + 10 * i)
        base = rng.integers(0, 256, size=3)
        ramp = np.linspace(0, 1, w)[None, :, None] * rng.integers(
            -120, 120, size=3)
        noise = rng.normal(0, 25, size=(h, w, 3))
        pixels = np.clip(base + ramp + noise, 0, 255).astype(np.uint8)
        paths.append(str(path / f"img{i}.png"))
        Image.fromarray(pixels).save(paths[-1])
    return paths


@pytest.fixture(scope="module")
def servers(checkpoint, images):
    servers = {}
    docs = [{"_id": f"d{i}", "image": images[i],
             "caption": f"a {COLORS[i]} picture"} for i in range(N_DOCS)]
    with pytest.MonkeyPatch.context() as env:
        env.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
        # no CUDA device here: the port serves on the CPU only when asked
        env.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
        env.setattr(JaxCLIPModel, "compute_dtype", jnp.float32)
        env.setattr(TorchCLIPModel, "compute_dtype", torch.float32)
        try:
            for package in ("marqo_tpu", "marqo_tpu_torch"):
                server = _Server(package)
                servers[package] = server
                server.req("POST", "/indexes/slice", {
                    "model": "slice-clip",
                    "modelProperties": {"type": "clip", "dimensions": DIMS,
                                        "localpath": checkpoint},
                    "treatUrlsAndPointersAsImages": True})
                res = server.req("POST", "/indexes/slice/documents", {
                    "documents": docs,
                    "tensorFields": ["image", "caption", "combo"],
                    "mappings": {"combo": {
                        "type": "multimodal_combination",
                        "weights": {"image": 0.7, "caption": 0.3}}}})
                assert res["errors"] is False, res
            yield servers
        finally:
            for server in servers.values():
                server.close()
            from marqo_tpu.inference import vectorise as jax_vectorise
            from marqo_tpu_torch.inference import vectorise as torch_vectorise
            jax_vectorise.clear_loaded_models()
            torch_vectorise.clear_loaded_models()


def _both(servers, path, body):
    return {p: s.req("POST", path, body) for p, s in servers.items()}


def test_embed_image_and_text_agree(servers, images):
    content = [images[0], images[5], "a red picture", "some caption"]
    out = _both(servers, "/indexes/slice/embed", {"content": content})
    ref, port = out["marqo_tpu"]["embeddings"], \
        out["marqo_tpu_torch"]["embeddings"]
    assert len(ref) == len(port) == len(content)
    for a, b in zip(ref, port):
        assert len(b) == DIMS
        assert abs(np.linalg.norm(b) - 1) < 1e-3
        assert _cosine(a, b) > 1 - 1e-3
    # an image path is embedded as an image, not as its text
    assert _cosine(port[0], port[2]) < 1 - 1e-3


def _queries(images):
    return {"text": "a green picture",
            "image": images[3],
            "weighted": {images[6]: 1.0, "a white picture": 0.1}}


@pytest.mark.parametrize("kind", ["text", "image", "weighted"])
def test_search_hits_and_scores_agree(servers, images, kind):
    """Every document comes back from both, each with the same score to
    1e-3, and hits the port ranks in some order are not clearly in the
    other order in the reference. An image query finds its own document
    first."""
    query = _queries(images)[kind]
    res = _both(servers, "/indexes/slice/search",
                {"q": query, "searchMethod": "TENSOR", "limit": N_DOCS})
    ref = {h["_id"]: h["_score"] for h in res["marqo_tpu"]["hits"]}
    port = {h["_id"]: h["_score"] for h in res["marqo_tpu_torch"]["hits"]}
    assert len(ref) == N_DOCS and set(port) == set(ref)
    for doc_id, score in ref.items():
        assert abs(port[doc_id] - score) <= 1e-3, (doc_id, port[doc_id], score)
    order = [h["_id"] for h in res["marqo_tpu_torch"]["hits"]]
    for i, a in enumerate(order):
        for b in order[i + 1:]:
            assert ref[b] - ref[a] <= 1e-3, (a, b, ref[a], ref[b])
    if kind == "image":
        assert order[0] == res["marqo_tpu"]["hits"][0]["_id"] == "d3"
    if kind == "weighted":
        assert order[0] == res["marqo_tpu"]["hits"][0]["_id"] == "d6"


def test_both_packages_stored_the_same_documents(servers):
    for server in servers.values():
        stats = server.req("GET", "/indexes/slice/stats")
        assert stats["numberOfDocuments"] == N_DOCS
        # image, caption and combination vectors for every document
        assert stats["numberOfVectors"] == 3 * N_DOCS
