"""End-to-end add_documents + search in marqo_tpu_torch, on the CPU (port of
tests/test_new_families_e2e.py), through the orchestration with each
NEW CLIP-family architecture (CoCa / SigLIP / ResNet / ConvNeXt / M-CLIP /
roberta composite) as the index model — validates loader dispatch,
dimension plumbing, multimodal (text+image) ingest, and tensor search, not
just the tower math (which the per-family parity tests cover)."""

import numpy as np
import pytest
from PIL import Image

from marqo_tpu_torch.api.models.index_settings import IndexSettings
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.core.models.add_docs_params import AddDocsParams
from marqo_tpu_torch.inference import vectorise as inference
from marqo_tpu_torch.tensor_search import tensor_search

FAMILIES = {
    "open_clip/coca_ViT-B-32/laion2b_s13b_b90k": {
        "type": "open_clip", "dimensions": 16, "random_init": True,
        "image_size": 32,
        "architecture": {"patch_size": 16, "vocab_size": 64},
        "name": "open_clip/coca_ViT-B-32/laion2b_s13b_b90k"},
    "open_clip/ViT-B-16-SigLIP/webli": {
        "type": "open_clip", "dimensions": 16, "random_init": True,
        "image_size": 32,
        "architecture": {"patch_size": 16, "vocab_size": 64},
        "name": "open_clip/ViT-B-16-SigLIP/webli"},
    "open_clip/RN50/openai": {
        "type": "open_clip", "dimensions": 16, "random_init": True,
        "image_size": 64,
        "architecture": {"width": 16, "vocab_size": 64, "heads": 2},
        "name": "open_clip/RN50/openai"},
    "open_clip/convnext_base_w/laion2b_s13b_b82k": {
        "type": "open_clip", "dimensions": 16, "random_init": True,
        "image_size": 64, "architecture": {"vocab_size": 64},
        "name": "open_clip/convnext_base_w/laion2b_s13b_b82k"},
    "multilingual-clip/XLM-R Large Vit-B/32": {
        # explicit model_size: the type-level pre-load estimate (5 GiB,
        # reference constants.py:12) exceeds the 4 GiB CPU default and
        # would 409 — exactly as the reference would for a real M-CLIP on
        # default settings; this tiny random-init tower is ~MBs
        "type": "multilingual_clip", "dimensions": 16, "random_init": True,
        "model_size": 0.1,
        "image_size": 32,
        "architecture": {"patch_size": 16, "vocab_size": 64},
        "name": "multilingual-clip/XLM-R Large Vit-B/32"},
    "open_clip/roberta-ViT-B-32/laion2b_s12b_b32k": {
        "type": "open_clip", "dimensions": 16, "random_init": True,
        "image_size": 32,
        "architecture": {"patch_size": 16, "vocab_size": 64},
        "name": "open_clip/roberta-ViT-B-32/laion2b_s12b_b32k"},
}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """This host has no CUDA device: the port serves on the CPU on
    purpose."""
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("imgs") / "green.png"
    Image.new("RGB", (48, 40), color=(20, 230, 20)).save(p)
    return str(p)


@pytest.mark.parametrize("model_name", list(FAMILIES))
def test_family_end_to_end(model_name, image_path):
    inference.clear_loaded_models()
    cfg = Config()
    cfg.index_management.bootstrap()
    settings = IndexSettings(model=model_name,
                             modelProperties=FAMILIES[model_name],
                             treatUrlsAndPointersAsImages=True)
    cfg.index_management.create_index(settings.to_marqo_index("fam-index"))
    cfg.index_meta_cache.populate()
    try:
        docs = [
            {"_id": "t1", "caption": "a bright green field"},
            {"_id": "t2", "caption": "city lights at night"},
            {"_id": "img", "caption": image_path},
        ]
        res = tensor_search.add_documents(cfg, AddDocsParams(
            index_name="fam-index", docs=docs, tensor_fields=["caption"]))
        assert res["errors"] is False, res
        out = tensor_search.search(cfg, index_name="fam-index",
                                   text="green field", limit=3)
        assert len(out["hits"]) == 3
        for hit in out["hits"]:
            assert np.isfinite(hit["_score"])
        # image doc got vectorised through the vision tower
        got = tensor_search.get_document_by_id(cfg, "fam-index", "img",
                                               show_vectors=True)
        facets = got["_tensor_facets"]
        assert len(facets) == 1
        assert len(facets[0]["_embedding"]) == 16
    finally:
        cfg.index_management.delete_index_by_name("fam-index")
        cfg.index_meta_cache.stop_refresh_thread()
        inference.clear_loaded_models()
