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
mirrors the embedding-model cache keying. The OWL-ViT model is not ported
to this package yet: loading it raises ModelLoadError.
"""

import threading
from typing import Dict, List, Optional

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


def _get_reranker(model_name: str, device: Device,
                  properties: Optional[dict] = None):
    if "owl" in model_name.lower():
        raise ModelLoadError(
            f"OWL-ViT image reranker `{model_name}` is not yet ported to "
            f"marqo_tpu_torch (ROADMAP A9)")
    key = f"{model_name}||{device.value}"
    with _lock:
        if key not in _rerankers:
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
