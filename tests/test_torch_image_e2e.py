"""Image ingestion + image search end-to-end with a tiny random-init CLIP,
in marqo_tpu_torch on the CPU (port of tests/test_image_e2e.py)."""

import numpy as np
import pytest
from PIL import Image

from marqo_tpu_torch.api.models.index_settings import IndexSettings
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.core.models.add_docs_params import AddDocsParams
from marqo_tpu_torch.inference import vectorise as inference
from marqo_tpu_torch.tensor_search import tensor_search
from marqo_tpu_torch.tensor_search.add_docs import (infer_modality,
                                              is_media_pointer)
from marqo_tpu_torch.inference.types import Modality

CLIP_PROPS = {
    "type": "clip", "dimensions": 24, "random_init": True, "image_size": 32,
    "architecture": {"patch_size": 8},
}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """This host has no CUDA device: the port serves on the CPU on
    purpose."""
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")


@pytest.fixture
def images(tmp_path):
    paths = {}
    for name, color in [("red", (230, 20, 20)), ("green", (20, 230, 20)),
                        ("blue", (20, 20, 230))]:
        img = Image.new("RGB", (64, 48), color=color)
        p = tmp_path / f"{name}.png"
        img.save(p)
        paths[name] = str(p)
    return paths


@pytest.fixture
def config():
    inference.clear_loaded_models()
    cfg = Config()
    cfg.index_management.bootstrap()
    settings = IndexSettings(model="my-test-clip",
                             modelProperties=CLIP_PROPS,
                             treatUrlsAndPointersAsImages=True,
                             treatUrlsAndPointersAsMedia=True)
    cfg.index_management.create_index(settings.to_marqo_index("img-index"))
    cfg.index_meta_cache.populate()
    yield cfg
    inference.clear_loaded_models()


class TestModalityInference:
    def test_pointers(self):
        assert is_media_pointer("http://x.com/a.png")
        assert is_media_pointer("/tmp/photo.jpeg")
        assert not is_media_pointer("just some text")
        assert infer_modality("a.png") == Modality.IMAGE
        assert infer_modality("a.mp4") == Modality.VIDEO
        assert infer_modality("a.wav") == Modality.AUDIO
        assert infer_modality("hello world") == Modality.TEXT

    def test_magic_bytes(self):
        assert infer_modality(b"\x89PNG\r\n") == Modality.IMAGE
        assert infer_modality(b"\xff\xd8\xffdata") == Modality.IMAGE
        assert infer_modality(b"plain text bytes") == Modality.TEXT


class TestImageIngest:
    def test_add_image_docs(self, config, images):
        docs = [{"_id": k, "img": v, "caption": f"a {k} image"}
                for k, v in images.items()]
        res = tensor_search.add_documents(config, AddDocsParams(
            index_name="img-index", docs=docs,
            tensor_fields=["img", "caption"]))
        assert res["errors"] is False, res["items"]
        assert config.engine.doc_count("img-index") == 3
        # 1 image vector + 1 caption vector per doc
        assert config.engine.vector_count("img-index") == 6

    def test_bad_image_fails_only_that_doc(self, config, images):
        docs = [{"_id": "good", "img": images["red"]},
                {"_id": "bad", "img": "/nonexistent/missing.png"}]
        res = tensor_search.add_documents(config, AddDocsParams(
            index_name="img-index", docs=docs, tensor_fields=["img"]))
        assert res["errors"] is True
        statuses = {i["_id"]: i["status"] for i in res["items"]}
        assert statuses["good"] == 200
        assert statuses["bad"] == 400

    def test_image_search_by_image(self, config, images):
        docs = [{"_id": k, "img": v} for k, v in images.items()]
        tensor_search.add_documents(config, AddDocsParams(
            index_name="img-index", docs=docs, tensor_fields=["img"]))
        res = tensor_search.search(config, "img-index", text=images["red"])
        assert res["hits"][0]["_id"] == "red"
        assert res["hits"][0]["_score"] > res["hits"][-1]["_score"]

    def test_weighted_text_image_query(self, config, images):
        docs = [{"_id": k, "img": v} for k, v in images.items()]
        tensor_search.add_documents(config, AddDocsParams(
            index_name="img-index", docs=docs, tensor_fields=["img"]))
        res = tensor_search.search(
            config, "img-index",
            text={images["blue"]: 1.0, "some text": 0.1})
        assert res["hits"][0]["_id"] == "blue"

    def test_multimodal_image_text_combo(self, config, images):
        docs = [{"_id": "combo", "photo": images["red"],
                 "caption": "a red image"}]
        res = tensor_search.add_documents(config, AddDocsParams(
            index_name="img-index", docs=docs, tensor_fields=["both"],
            mappings={"both": {"type": "multimodal_combination",
                               "weights": {"photo": 0.6, "caption": 0.4}}}))
        assert res["errors"] is False, res["items"]
        assert config.engine.vector_count("img-index") == 1


class TestImagePatching:
    def test_simple_patch_method(self, images):
        inference.clear_loaded_models()
        cfg = Config()
        cfg.index_management.bootstrap()
        settings = IndexSettings(
            model="my-test-clip", modelProperties=CLIP_PROPS,
            treatUrlsAndPointersAsImages=True,
            treatUrlsAndPointersAsMedia=True,
            imagePreprocessing={"patchMethod": "simple"})
        cfg.index_management.create_index(settings.to_marqo_index("patch-idx"))
        cfg.index_meta_cache.populate()
        res = tensor_search.add_documents(cfg, AddDocsParams(
            index_name="patch-idx", docs=[{"_id": "p1", "img": images["red"]}],
            tensor_fields=["img"]))
        assert res["errors"] is False, res["items"]
        # 3x3 grid + whole image = 10 patches
        assert cfg.engine.vector_count("patch-idx") == 10
        facets = tensor_search.get_document_by_id(
            cfg, "patch-idx", "p1", show_vectors=True)["_tensor_facets"]
        assert len(facets) == 10
        inference.clear_loaded_models()

    def test_chunk_image_unit(self):
        from marqo_tpu_torch.inference.image_patching import chunk_image
        img = np.zeros((90, 120, 3), dtype=np.uint8)
        patches, chunks = chunk_image(img, "simple")
        assert len(patches) == 10
        assert chunks[0] == "[0, 0, 120, 90]"
        patches_o, _ = chunk_image(img, "overlap")
        assert len(patches_o) > 10


class TestStructuredImagePointer:
    def test_image_pointer_field_type(self, images):
        """Structured indexes embed ImagePointer fields visually
        (reference FieldType.ImagePointer)."""
        from marqo_tpu_torch.api.models.index_settings import (FieldRequest,
                                                         IndexSettings)
        from marqo_tpu_torch.core.models.marqo_index import FieldType, IndexType
        inference.clear_loaded_models()
        cfg = Config()
        cfg.index_management.bootstrap()
        settings = IndexSettings(
            type=IndexType.Structured, model="my-test-clip",
            modelProperties=CLIP_PROPS,
            allFields=[FieldRequest(name="img", type=FieldType.ImagePointer),
                       FieldRequest(name="caption", type=FieldType.Text)],
            tensorFields=["img", "caption"])
        cfg.index_management.create_index(settings.to_marqo_index("s-img"))
        cfg.index_meta_cache.populate()
        res = tensor_search.add_documents(cfg, AddDocsParams(
            index_name="s-img",
            docs=[{"_id": k, "img": v, "caption": f"{k} image"}
                  for k, v in images.items()]))
        assert res["errors"] is False, res["items"]
        # a structured index embeds a query path as TEXT in both packages
        # (treat_urls_and_pointers_as_images is an unstructured setting), so
        # the JAX package's top hit for it rests on its random weights
        # (ROADMAP C3): the query here is the green image's own embedding
        green = inference.vectorise(
            model_name="my-test-clip", model_properties=CLIP_PROPS,
            content=[images["green"]], modality=Modality.IMAGE)[0]
        out = tensor_search.search(
            cfg, "s-img", searchable_attributes=["img"],
            context={"tensor": [{"vector": list(map(float, green)),
                                 "weight": 1.0}]})
        assert out["hits"][0]["_id"] == "green"
        assert out["hits"][0]["_score"] > 0.999
        out = tensor_search.search(cfg, "s-img", text=images["green"],
                                   searchable_attributes=["img"])
        assert len(out["hits"]) == 3
        inference.clear_loaded_models()


class TestMediaDownloadHeadersOnSearch:
    def test_query_image_url_sent_with_headers(self, config):
        """Search with an image-URL query passes mediaDownloadHeaders to
        the fetch (reference test_image_download_headers.py:60
        test_img_download_search) — a 401-unless-authorized server only
        serves the query image when the header arrives."""
        import io
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from PIL import Image as PILImage

        buf = io.BytesIO()
        PILImage.new("RGB", (32, 32), color=(200, 30, 30)).save(buf, "PNG")
        png = buf.getvalue()
        seen = {}

        class AuthImage(BaseHTTPRequestHandler):
            def do_GET(self):
                seen["auth"] = self.headers.get("Authorization")
                if self.headers.get("Authorization") != "token s3cret":
                    self.send_response(401)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.end_headers()
                self.wfile.write(png)

            def log_message(self, *a):
                pass

        server = ThreadingHTTPServer(("127.0.0.1", 0), AuthImage)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/q.png"
            tensor_search.add_documents(config, AddDocsParams(
                index_name="img-index",
                docs=[{"_id": "d1", "caption": "a text doc"}],
                tensor_fields=["caption"]))
            res = tensor_search.search(
                config, index_name="img-index", text=url, limit=1,
                media_download_headers={"Authorization": "token s3cret"})
            assert seen["auth"] == "token s3cret"
            assert len(res["hits"]) == 1
            # without the header the fetch must fail (401)
            with pytest.raises(Exception):
                tensor_search.search(config, index_name="img-index",
                                     text=url, limit=1)
        finally:
            server.shutdown()


class TestMediaDownloadHeadersOnAddDocs:
    def test_add_docs_image_url_sent_with_headers(self, config):
        """add_documents passes mediaDownloadHeaders to every image fetch
        (reference test_image_download_headers.py:92
        test_img_download_add_docs)."""
        import io
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from PIL import Image as PILImage

        buf = io.BytesIO()
        PILImage.new("RGB", (32, 32), color=(30, 200, 30)).save(buf, "PNG")
        png = buf.getvalue()
        seen = {}

        class AuthImage(BaseHTTPRequestHandler):
            def do_GET(self):
                seen["auth"] = self.headers.get("Authorization")
                if self.headers.get("Authorization") != \
                        "some secret key blah":
                    self.send_response(401)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.end_headers()
                self.wfile.write(png)

            def log_message(self, *a):
                pass

        server = ThreadingHTTPServer(("127.0.0.1", 0), AuthImage)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/img.png"
            res = tensor_search.add_documents(config, AddDocsParams(
                index_name="img-index",
                docs=[{"_id": "1", "image": url}],
                tensor_fields=["image"],
                media_download_headers={
                    "Authorization": "some secret key blah"}))
            assert res["errors"] is False, res["items"]
            assert seen["auth"] == "some secret key blah"
            # without the header the doc fails per-item (401 fetch)
            res = tensor_search.add_documents(config, AddDocsParams(
                index_name="img-index",
                docs=[{"_id": "2", "image": url}],
                tensor_fields=["image"]))
            assert res["errors"] is True
            assert res["items"][0]["status"] >= 400
        finally:
            server.shutdown()
