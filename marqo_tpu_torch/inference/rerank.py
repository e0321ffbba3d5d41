"""Post-search reranking.

Parity: reference s2_inference/reranking/rerank.py:12-54 — rerank mutates
the search result in place, overwriting ``_score`` with the reranker
relevance and re-sorting; requires ``searchable_attributes`` so it knows
which fields carry the content (same constraint as the reference). Model
names containing 'owl' dispatch to the OWL-ViT IMAGE reranker
(cross_encoders.py:341-461 ReRankerOwl): the named attribute must hold an
image pointer, each hit is re-scored by its best query-matching box, and
the highlight becomes that box's corners in original-image pixels.
Everything else goes to the text cross-encoder. Reranker model cache
mirrors the embedding-model cache keying.
"""

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from marqo_tpu_torch.core.exceptions import (InvalidArgumentError, ModelLoadError,
                                       RerankerError, RerankerNameError)
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.models.cross_encoder import TorchCrossEncoder

_rerankers: Dict[str, object] = {}
_lock = threading.Lock()

# reference registers the ms-marco cross-encoder family
KNOWN_RERANKERS = {
    "cross-encoder/ms-marco-MiniLM-L-6-v2",
    "cross-encoder/ms-marco-MiniLM-L-12-v2",
    "cross-encoder/ms-marco-TinyBERT-L-2-v2",
    "cross-encoder/ms-marco-TinyBERT-L-4",
    "cross-encoder/ms-marco-TinyBERT-L-6",
}

# reference ReRankerOwl._get_model_mapping (cross_encoders.py:366-375)
OWL_MODEL_MAP = {
    "google/owlvit-base-patch32": "google/owlvit-base-patch32",
    "google/owlvit-base-patch16": "google/owlvit-base-patch16",
    "google/owlvit-large-patch14": "google/owlvit-large-patch14",
    "owl/ViT-B/32": "google/owlvit-base-patch32",
    "owl/ViT-B/16": "google/owlvit-base-patch16",
    "owl/ViT-L/14": "google/owlvit-large-patch14",
}


def owl_detections(model, pixels, ids):
    """OWL-ViT's ``detect`` as one tensor, (B, P, 5) fp32: each patch's
    probability for the query, then its cxcywh box in [0, 1]."""
    import torch

    from marqo_tpu_torch.models.owl_vit import detect
    logits, boxes = detect(model, pixels, ids)
    return torch.cat([torch.sigmoid(logits[..., :1]), boxes], dim=-1)


class TorchOwlReranker:
    """OWL-ViT image reranker (models/owl_vit.py) on one device, in bf16.
    Scores each hit's image by its best box for the query; highlight = that
    box in original-image pixel corners (reference sort_owl_boxes_scores +
    rescale_box). On CUDA each scoring call replays one CUDA graph per hit
    count (inference/graphs.py), captured at the count's first call."""

    def __init__(self, model_name: str, device: Device,
                 properties: Optional[dict] = None):
        import torch

        from marqo_tpu_torch.inference.graphs import EncoderGraphs
        from marqo_tpu_torch.models.owl_vit import OwlViTConfig
        self.model_name = model_name
        self.properties = dict(properties or {})
        self.device = device
        self._device = torch.device(
            "cuda" if device == Device.CUDA else "cpu")
        self.config: Optional[OwlViTConfig] = None
        self.model = None
        self.tokenizer = None
        self.graphs = EncoderGraphs(self._device)

    def load(self) -> None:
        import torch

        from marqo_tpu_torch.models.owl_vit import (OwlViTConfig, init_owl_params,
                                                    model_from_hf_owlvit)
        localpath = self.properties.get("localpath")
        if self.model_name not in OWL_MODEL_MAP and not localpath:
            # reference RerankerNameError (cross_encoders.py:363-364)
            raise InvalidArgumentError(
                f"could not find model_name={self.model_name} in mappings "
                f"{list(OWL_MODEL_MAP.keys())}")
        repo = OWL_MODEL_MAP.get(self.model_name, self.model_name)
        if self.properties.get("random_init"):
            arch = self.properties.get("architecture", {})
            from marqo_tpu_torch.models.clip import (CLIPTextConfig,
                                               CLIPVisionConfig)
            hidden = int(arch.get("hidden_size", 32))
            self.config = OwlViTConfig(
                text=CLIPTextConfig(
                    vocab_size=int(arch.get("vocab_size", 1024)),
                    hidden_size=hidden, num_layers=int(arch.get("layers", 2)),
                    num_heads=int(arch.get("heads", 2)),
                    intermediate_size=2 * hidden, max_positions=16,
                    projection_dim=hidden,
                    eos_token_id=int(arch.get("vocab_size", 1024)) - 1),
                vision=CLIPVisionConfig(
                    image_size=int(arch.get("image_size", 32)),
                    patch_size=int(arch.get("patch_size", 8)),
                    hidden_size=hidden, num_layers=int(arch.get("layers", 2)),
                    num_heads=int(arch.get("heads", 2)),
                    intermediate_size=2 * hidden, projection_dim=hidden))
            seed = int.from_bytes(hashlib.sha256(
                self.model_name.encode()).digest()[:4], "little")
            generator = torch.Generator(device=self._device).manual_seed(seed)
            self.model = init_owl_params(self.config, generator,
                                         dtype=torch.bfloat16,
                                         device=self._device)
            from marqo_tpu_torch.models.tokenizer import TextTokenizer
            self.tokenizer = TextTokenizer.build_test_wordpiece(max_length=16)
            self._tokenize = self._tokenize_wordpiece
            return
        try:
            from transformers import (CLIPTokenizerFast,
                                      OwlViTConfig as HFOwlConfig,
                                      OwlViTForObjectDetection)
            source = localpath or repo
            hf_cfg = HFOwlConfig.from_pretrained(source)
            from marqo_tpu_torch.models.clip import (CLIPTextConfig,
                                               CLIPVisionConfig)
            self.config = OwlViTConfig(
                text=CLIPTextConfig(
                    vocab_size=hf_cfg.text_config.vocab_size,
                    hidden_size=hf_cfg.text_config.hidden_size,
                    num_layers=hf_cfg.text_config.num_hidden_layers,
                    num_heads=hf_cfg.text_config.num_attention_heads,
                    intermediate_size=hf_cfg.text_config.intermediate_size,
                    max_positions=hf_cfg.text_config.max_position_embeddings,
                    projection_dim=hf_cfg.projection_dim,
                    eos_token_id=hf_cfg.text_config.eos_token_id),
                vision=CLIPVisionConfig(
                    image_size=hf_cfg.vision_config.image_size,
                    patch_size=hf_cfg.vision_config.patch_size,
                    hidden_size=hf_cfg.vision_config.hidden_size,
                    num_layers=hf_cfg.vision_config.num_hidden_layers,
                    num_heads=hf_cfg.vision_config.num_attention_heads,
                    intermediate_size=hf_cfg.vision_config.intermediate_size,
                    projection_dim=hf_cfg.projection_dim))
            torch_model = OwlViTForObjectDetection.from_pretrained(source)
            self.model = model_from_hf_owlvit(
                torch_model.state_dict(), self.config, dtype=torch.bfloat16,
                device=self._device)
            del torch_model
            tok = CLIPTokenizerFast.from_pretrained(source)
            self._clip_tok = tok
            self._tokenize = self._tokenize_clip
        except Exception as e:
            raise ModelLoadError(
                f"Could not load OWL-ViT reranker `{self.model_name}` from "
                f"`{localpath or repo}`: {e}. If running offline, provide "
                f"model_properties.localpath.", cause=e)

    def _tokenize_clip(self, texts: List[str]) -> np.ndarray:
        enc = self._clip_tok(texts, padding="max_length", truncation=True,
                             max_length=self.config.text.max_positions,
                             return_tensors="np")
        return enc["input_ids"].astype(np.int32)

    def _tokenize_wordpiece(self, texts: List[str]) -> np.ndarray:
        batch = self.tokenizer.encode_batch(
            texts, pad_to=self.config.text.max_positions)
        return np.asarray(batch["input_ids"], dtype=np.int32)

    def _load_image(self, pointer) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Decode + squash-resize to the model's square input (reference
        ReRankerOwl.load_images resizes to a fixed size, no crop). Returns
        (uint8 array, (orig_w, orig_h))."""
        from PIL import Image

        from marqo_tpu_torch.ops.image_ops import host_decode
        arr = host_decode(pointer)
        img = Image.fromarray(arr)
        orig = img.size
        size = self.config.vision.image_size
        img = img.resize((size, size), Image.BICUBIC)
        return np.asarray(img, dtype=np.uint8), orig

    def detections(self, pixels: np.ndarray, ids: np.ndarray):
        """(B, size, size, 3) uint8 images and (1, L) query ids → (B, P, 5)
        fp32 on the device: each patch's query probability, then its
        cxcywh box in [0, 1]. On CUDA the replay of this reranker's graph
        of the batch's image count, captured at the count's first call."""
        import torch

        from marqo_tpu_torch.inference import batching
        model = self.model
        graphs = batching.card_graphs(self.graphs)
        if graphs is None:
            with torch.inference_mode():
                return owl_detections(
                    model, torch.from_numpy(pixels).to(self._device),
                    torch.from_numpy(ids).to(self._device))
        return graphs.run(
            "detect", model.merge_ln.weight.dtype,
            lambda pixels, ids: owl_detections(model, pixels, ids), pixels,
            ids, static=(model.text.config, model.vision.config))

    def score_images(self, query: str, pointers: List) -> List[dict]:
        """Per image: {'score': best box score, 'box': [x1,y1,x2,y2] in
        original pixels, 'boxes'/'scores': top-k lists} — or {'error'}."""
        ids = self._tokenize([query])
        loaded, sizes, index = [], [], []
        results: List[Optional[dict]] = [None] * len(pointers)
        for i, pointer in enumerate(pointers):
            try:
                pixels, orig = self._load_image(pointer)
                loaded.append(pixels)
                sizes.append(orig)
                index.append(i)
            except Exception as e:
                results[i] = {"error": str(e)}
        if loaded:
            # (B, P) probabilities and (B, P, 4) cxcywh boxes in [0,1], in
            # one copy back to the host
            best = self.detections(np.stack(loaded), ids).cpu().numpy()
            probs, boxes = best[..., 0], best[..., 1:]
            for row, i in enumerate(index):
                best = int(np.argmax(probs[row]))
                cx, cy, w, h = boxes[row, best]
                ow, oh = sizes[row]
                corners = [float(max(0, (cx - w / 2)) * ow),
                           float(max(0, (cy - h / 2)) * oh),
                           float(min(1, (cx + w / 2)) * ow),
                           float(min(1, (cy + h / 2)) * oh)]
                results[i] = {"score": float(probs[row, best]),
                              "box": corners}
        return results  # type: ignore[return-value]


def _get_reranker(model_name: str, device: Device,
                  properties: Optional[dict] = None):
    key = f"{model_name}||{device.value}"
    with _lock:
        if key not in _rerankers:
            if "owl" in model_name.lower():
                model: object = TorchOwlReranker(model_name, device, properties)
            else:
                model = TorchCrossEncoder(model_name, device, properties)
            model.load()
            _rerankers[key] = model
        return _rerankers[key]


def clear_rerankers() -> None:
    _rerankers.clear()


def _check_searchable_fields_in_results(search_result: dict,
                                        searchable_fields) -> bool:
    """None is allowed (text rerankers concat all fields); otherwise at
    least one hit must carry one of the fields, else reranking is
    SKIPPED silently (reference rerank.py:27-31, 57-72)."""
    if searchable_fields is None:
        return True
    return any(any(s in hit for s in searchable_fields)
               for hit in search_result.get("hits", []))


def rerank_search_results(search_result: dict, query: str, model_name: str,
                          device: Optional[str] = None,
                          searchable_attributes: Optional[List[str]] = None,
                          properties: Optional[dict] = None) -> None:
    """Re-scores ``search_result['hits']`` in place (reference
    rerank.py:12-54: no-hit-has-the-field skips reranking; owl requires
    a non-empty searchable_attributes list and reranks over the FIRST
    attribute only; text rerankers accept None = all fields)."""
    if not isinstance(query, str):
        raise InvalidArgumentError(
            "Re-ranking requires a string query")
    if not _check_searchable_fields_in_results(search_result,
                                               searchable_attributes):
        return
    hits = search_result.get("hits", [])
    if not hits:
        return
    if "owl" in model_name.lower():
        if searchable_attributes in (None, [], (), ""):
            # reference rerank.py:34-36 exact wording
            raise RerankerError(
                f"found searchable_attributes={searchable_attributes} but "
                f"expected list of strings for {model_name}")
        try:
            _rerank_images(search_result, query, model_name, device,
                           [searchable_attributes[0]], properties)
        except RerankerError:
            raise
        except (ModelLoadError, InvalidArgumentError) as e:
            # reference rerank.py:44-45 wraps loader errors
            raise RerankerError(str(e)) from e
        return
    model = _get_reranker(model_name, Device.normalize(device), properties)
    texts = []
    for hit in hits:
        attrs = searchable_attributes if searchable_attributes is not None \
            else [k for k in hit if not k.startswith("_")]
        parts = [str(hit[attr]) for attr in attrs
                 if attr in hit and isinstance(hit.get(attr), (str, int, float))]
        texts.append(" ".join(parts) if parts else "")
    scores = model.score(query, texts)
    for hit, score in zip(hits, scores):
        hit["_score"] = float(score)
    hits.sort(key=lambda h: -h["_score"])


def _rerank_images(search_result: dict, query: str, model_name: str,
                   device: Optional[str],
                   searchable_attributes: List[str],
                   properties: Optional[dict]) -> None:
    """OWL-ViT image leg. Hits WITHOUT the image attribute are REMOVED
    from the reranked results (reference ReRankerOwl formats only rows
    carrying the field and merges back on it —
    test_reranking_images_owl_inconsistent asserts N_out == N_in)."""
    if model_name not in OWL_MODEL_MAP:
        # reference cross_encoders.py:364 exact wording
        raise RerankerNameError(
            f"could not find model_name={model_name} in mappings "
            f"{list(OWL_MODEL_MAP.keys())}")
    attribute = searchable_attributes[0]
    hits = search_result["hits"]
    model = _get_reranker(model_name, Device.normalize(device), properties)
    pointers = [hit.get(attribute) for hit in hits]
    scorable = [i for i, p in enumerate(pointers) if isinstance(p, str)]
    outcomes = model.score_images(query, [pointers[i] for i in scorable])
    kept = []
    for i, outcome in zip(scorable, outcomes):
        if outcome.get("error"):
            hits[i]["_score"] = 0.0
        else:
            hits[i]["_score"] = outcome["score"]
            hits[i]["_highlights"] = [{attribute: outcome["box"]}]
        kept.append(hits[i])
    kept.sort(key=lambda h: -h.get("_score", 0.0))
    search_result["hits"] = kept
