"""Documents with an image field added to an index whose
``imagePreprocessing.patchMethod`` is each detector method, through
marqo_tpu_torch's and marqo_tpu's in-process ``add_documents``, with the
port's patchers holding the JAX patchers' weights
(tests/test_torch_patching_e2e.py's ``_patcher_pair``; DINO's maps in fp32
in both packages). Both packages give the same statuses and the same chunk
strings per document; a missing image fails only its own document.
"""

import pytest
from PIL import Image

from marqo_tpu.api.models.index_settings import \
    IndexSettings as JaxIndexSettings
from marqo_tpu.config import Config as JaxConfig
from marqo_tpu.core.models.add_docs_params import \
    AddDocsParams as JaxAddDocsParams
from marqo_tpu.inference import vectorise as jvectorise
from marqo_tpu.tensor_search import tensor_search as jsearch
from marqo_tpu_torch.api.models.index_settings import IndexSettings
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.core.models.add_docs_params import AddDocsParams
from marqo_tpu_torch.inference import vectorise as tvectorise
from marqo_tpu_torch.tensor_search import tensor_search as tsearch
from tests.test_torch_patching_e2e import (_image, _patcher_pair,  # noqa: F401
                                           environment, fp32_dino)

# the index settings' patchMethod values (yolox is chunk_image's alias)
INDEX_METHODS = ("dino-v1", "dino-v2", "marqo-yolo", "frcnn")
CLIP_PROPS = {"type": "clip", "dimensions": 24, "random_init": True,
              "image_size": 32, "architecture": {"patch_size": 8}}


def _write_images(directory, n=3):
    paths = []
    for i in range(n):
        h, w = (180, 300) if i % 2 == 0 else (200, 150)
        path = directory / f"img{i}.png"
        Image.fromarray(_image(10 + i, h, w)).save(path)
        paths.append(str(path))
    return paths


def _add(package, method, paths):
    """Create an index with ``method`` in one package, add one document
    per image and a bad pointer; return statuses and chunks per doc."""
    (config_cls, settings_cls, params_cls, search, vectorise) = package
    vectorise.clear_loaded_models()
    config = config_cls()
    config.index_management.bootstrap()
    settings = settings_cls(model="my-test-clip", modelProperties=CLIP_PROPS,
                            treatUrlsAndPointersAsImages=True,
                            treatUrlsAndPointersAsMedia=True,
                            imagePreprocessing={"patchMethod": method})
    config.index_management.create_index(settings.to_marqo_index("patched"))
    config.index_meta_cache.populate()
    docs = [{"_id": f"d{i}", "img": p} for i, p in enumerate(paths)]
    docs.append({"_id": "bad", "img": "/nonexistent/missing.png"})
    res = search.add_documents(config, params_cls(
        index_name="patched", docs=docs, tensor_fields=["img"]))
    statuses = {item["_id"]: item["status"] for item in res["items"]}
    chunks = {}
    for doc in docs[:-1]:
        facets = search.get_document_by_id(config, "patched", doc["_id"],
                                           show_vectors=True)
        chunks[doc["_id"]] = [f["img"] for f in facets["_tensor_facets"]]
    vectors = config.engine.vector_count("patched")
    vectorise.clear_loaded_models()
    return statuses, chunks, vectors


@pytest.mark.parametrize("method", INDEX_METHODS)
def test_add_documents_matches_jax(method, fp32_dino, tmp_path):
    _patcher_pair(method)
    paths = _write_images(tmp_path)
    port = _add((Config, IndexSettings, AddDocsParams, tsearch,
                 tvectorise), method, paths)
    theirs = _add((JaxConfig, JaxIndexSettings, JaxAddDocsParams, jsearch,
                   jvectorise), method, paths)
    assert port == theirs
    statuses, chunks, vectors = port
    assert statuses == {"d0": 200, "d1": 200, "d2": 200, "bad": 400}
    assert vectors == sum(len(c) for c in chunks.values())
    for doc_chunks in chunks.values():
        assert len(doc_chunks) >= 1
