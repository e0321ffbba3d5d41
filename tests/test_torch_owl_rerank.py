"""The OWL-ViT image reranker end to end, through marqo_tpu_torch's and
marqo_tpu's ``rerank_search_results`` on the same weights, on the CPU.

Each package draws its own random OWL-ViT weights, so the port's reranker
here holds marqo_tpu's (bf16), carried across with ``params_from_jax``.
Both compute in bf16. Tolerances: the same hit order, scores within 1e-3,
highlight boxes within 1 px; a missing image scores 0 and a hit without
the attribute is removed, in both.
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from marqo_tpu.inference import rerank as jrerank
from marqo_tpu.inference.types import Device as JaxDevice
from marqo_tpu_torch.inference import rerank as trerank
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.models import owl_vit as towl

OWL_NAME = "owl/ViT-B/32"
OWL_PROPS = {"random_init": True,
             "architecture": {"hidden_size": 32, "layers": 2, "heads": 2,
                              "image_size": 32, "patch_size": 8}}


def _write_images(directory, n):
    rng = np.random.default_rng(10)
    paths = []
    for i in range(n):
        h, w = (180, 300) if i % 2 == 0 else (200, 150)
        pixels = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        path = directory / f"img{i}.png"
        Image.fromarray(pixels).save(path)
        paths.append(str(path))
    return paths


@pytest.fixture
def owl_pair():
    """Both packages' random-init OWL rerankers at a tiny width, the port's
    holding marqo_tpu's bf16 weights."""
    jrerank.clear_rerankers()
    trerank.clear_rerankers()
    jax_model = jrerank._get_reranker(OWL_NAME, JaxDevice.CPU, OWL_PROPS)
    port = trerank._get_reranker(OWL_NAME, Device.CPU, OWL_PROPS)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jax_model.params)
    port.model = towl.params_from_jax(params, port.config,
                                      dtype=torch.bfloat16, device="cpu")
    yield jax_model, port
    jrerank.clear_rerankers()
    trerank.clear_rerankers()


def _hits(paths):
    hits = [{"_id": f"h{i}", "image": p, "_score": 1.0 - 0.1 * i}
            for i, p in enumerate(paths)]
    hits.append({"_id": "missing", "image": "/nonexistent/gone.png",
                 "_score": 0.05})
    hits.append({"_id": "textonly", "title": "no image here",
                 "_score": 0.01})
    return {"hits": hits}


def test_owl_rerank_matches_jax(owl_pair, tmp_path):
    paths = _write_images(tmp_path, n=5)
    ours, theirs = _hits(paths), _hits(paths)
    for package, result in ((trerank, ours), (jrerank, theirs)):
        package.rerank_search_results(result, "a bright blob", OWL_NAME,
                                      device="cpu",
                                      searchable_attributes=["image"],
                                      properties=OWL_PROPS)
    assert [h["_id"] for h in ours["hits"]] == \
        [h["_id"] for h in theirs["hits"]]
    # a hit without the attribute is removed; a missing image scores 0
    assert "textonly" not in {h["_id"] for h in ours["hits"]}
    missing = next(h for h in ours["hits"] if h["_id"] == "missing")
    assert missing["_score"] == 0.0 and "_highlights" not in missing
    for hit, jhit in zip(ours["hits"], theirs["hits"]):
        assert abs(hit["_score"] - jhit["_score"]) <= 1e-3
        if hit["_id"] == "missing":
            continue
        assert 0.0 <= hit["_score"] <= 1.0
        box = hit["_highlights"][0]["image"]
        jbox = jhit["_highlights"][0]["image"]
        assert np.abs(np.subtract(box, jbox)).max() <= 1.0


def test_owl_reranker_loads_on_the_port():
    trerank.clear_rerankers()
    model = trerank._get_reranker(OWL_NAME, Device.CPU, OWL_PROPS)
    assert isinstance(model, trerank.TorchOwlReranker)
    assert next(model.model.parameters()).dtype == torch.bfloat16
    out = model.score_images("a query", ["/nonexistent/x.png"])
    assert "error" in out[0]
    trerank.clear_rerankers()
