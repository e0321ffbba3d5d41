"""Add-documents pipeline (the ingest hot path).

Parity: reference core/vespa_index/add_documents_handler.py:105-424 (template
method: reversed dedup → per-doc validation → tensor-field collection →
use_existing_tensors → chunk → vectorise → feed → per-doc response) +
core/inference/tensor_fields_container.py (chunkers/vectorisers, multimodal
combination, custom-vector passthrough) + the per-index-type handlers
(structured validates declared fields; semi-structured grows the schema
before persisting, semi_structured_add_document_handler.py:31-119).

TPU shape: all chunks of a batch are vectorised in one bucketed call
(PER_BATCH mode — the reference's fastest strategy) so the encoder sees
large dense batches.
"""

import json
import time
import uuid
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from marqo_tpu_torch.api import configs
from marqo_tpu_torch.api import exceptions as api_exceptions
from marqo_tpu_torch.api import telemetry
from marqo_tpu_torch.api.telemetry import RequestMetricsStore
from marqo_tpu_torch.core import constants
from marqo_tpu_torch.core.exceptions import InvalidArgumentError, VectoriseError
from marqo_tpu_torch.core.models.add_docs_params import (AddDocsParams,
                                                   BatchVectorisationMode)
from marqo_tpu_torch.core.models.marqo_index import (Field, FieldType, MarqoIndex,
                                               SemiStructuredMarqoIndex,
                                               StructuredMarqoIndex,
                                               TensorField,
                                               validate_field_name)
from marqo_tpu_torch.engine.store import StoreEngine
from marqo_tpu_torch.inference import vectorise as inference
from marqo_tpu_torch.inference.text_chunker import chunk_text
from marqo_tpu_torch.inference.types import Modality
from marqo_tpu_torch.logging import get_logger

logger = get_logger(__name__)


class DocError(Exception):
    def __init__(self, message: str, status: int = 400,
                 code: str = "invalid_argument"):
        self.message = message
        self.status = status
        self.code = code
        super().__init__(message)


class AddDocumentsResponseCollector:
    """Per-document success/error accumulation — one bad document never
    fails the batch (reference add_documents_handler.py:27-102)."""

    def __init__(self):
        self.start = time.perf_counter()
        self.items: List[dict] = []
        self.errors = False

    def collect_error(self, doc_id: Optional[str], error: DocError,
                      position: Optional[int] = None) -> None:
        self.errors = True
        self.items.append({
            "_id": doc_id or "",
            "status": error.status,
            "error": error.message,
            "message": error.message,
            "code": error.code,
            "_position": position,
        })

    def collect_success(self, doc_id: str,
                        position: Optional[int] = None) -> None:
        self.items.append({"_id": doc_id, "status": 200,
                           "_position": position})

    def to_response(self, index_name: str) -> dict:
        # items come back in REQUEST order (reference response shape);
        # entries without a known position sort last, stably
        indexed = sorted(
            enumerate(self.items),
            key=lambda pair: (pair[1]["_position"] is None,
                              pair[1]["_position"]
                              if pair[1]["_position"] is not None else 0,
                              pair[0]))
        items = []
        for _, item in indexed:
            item = dict(item)
            item.pop("_position", None)
            items.append(item)
        return {
            "errors": self.errors,
            "processingTimeMs": (time.perf_counter() - self.start) * 1000,
            "index_name": index_name,
            "items": items,
        }


def _validate_doc(doc: Any) -> Dict[str, Any]:
    """Delegates to the centralized validate_doc so the per-item error
    messages match the reference exactly (validation.py:315-344, surfaced
    per-doc as items with code doc_too_large/invalid_argument —
    test_add_documents_handler.py:161-219)."""
    from marqo_tpu_torch.tensor_search import validation as ts_validation
    try:
        return ts_validation.validate_doc(doc)
    except api_exceptions.DocTooLargeError as e:
        raise DocError(e.message, code="doc_too_large") from e
    except api_exceptions.InvalidArgError as e:
        raise DocError(e.message, code="invalid_argument") from e


def _validate_id(doc_id: Any) -> str:
    from marqo_tpu_torch.tensor_search import validation as ts_validation
    try:
        ts_validation.validate_id(doc_id)
    except api_exceptions.InvalidDocumentIdError as e:
        raise DocError(e.message, code="invalid_document_id") from e
    # NB: '/' is allowed — reference validate_id (validation.py:347-362)
    # only checks string type + non-empty; test_add_documents_id_image_url
    # uses a URL as an _id
    return doc_id


_ALLOWED_VALUE_TYPES = (str, int, float, bool, list, dict)


def _validate_field_value(field: str, value: Any) -> None:
    if not isinstance(value, _ALLOWED_VALUE_TYPES):
        raise DocError(
            f"Field `{field}` has unsupported type `{type(value).__name__}`")
    if isinstance(value, int) and not isinstance(value, bool) and             not (-(2 ** 63) <= value < 2 ** 63):
        # Vespa long fields are int64; overlarge python ints must fail the
        # document (reference test_supported_large_integer_and_float_number)
        raise DocError(
            f"Field `{field}`: integer value {value} is outside the "
            f"representable long (int64) range")
    if isinstance(value, list):
        # homogeneous int/float/string lists (reference
        # unstructured_add_document_handler.py:102-107 list_types_valid)
        types = {type(v) for v in value}
        if (any(isinstance(v, bool) or
                not isinstance(v, (int, float, str)) for v in value)
                or len(types) > 1):
            raise DocError(
                f"Field content '{value}' of type list is not of valid "
                f"content type! All list elements must be of the same "
                f"type and that type must be int, float or string")
    if isinstance(value, dict):
        # allowed: custom_vector content, multimodal sub-dict, map<text,number>
        pass


def _validate_map_numeric_field(field_content: dict) -> None:
    """Non-mapped dict fields are map<text, number> score-modifier maps:
    one level deep, string keys, int/float values (reference
    validation.py:419-457 validate_map_numeric_field, exact messages)."""
    if any(isinstance(v, dict) for v in field_content.values()):
        raise DocError(
            "Nested dictionaries are not allowed in map fields. Each value "
            "must be a single int, float, or double.")
    for key, value in field_content.items():
        if not isinstance(key, str):
            raise DocError(
                f"Key '{key}' in map field is not a string. All keys must "
                f"be strings.")
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise DocError(
                f"Value '{value}' for key '{key}' in map field is not of "
                f"type int or float. If you are using an unstructured index "
                f"and attempting to index another type of object field "
                f"(e.g. custom_vector field), please use the 'mappings' "
                f"object.")


def _row_ranges(slots) -> Dict[Tuple[str, str], Tuple[int, int]]:
    """{(doc_id, field): (start, stop)} of ``slots`` ((doc_id, field, row)
    in encode order). The collection appends each key's rows in one run,
    so a key's rows are the slots from its first to its last."""
    ranges: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for i, (doc_id, field, row) in enumerate(slots):
        key = (doc_id, field)
        start = ranges[key][0] if key in ranges else i
        if row != i - start:
            raise RuntimeError(f"rows of {key} are not consecutive slots")
        ranges[key] = (start, i + 1)
    return ranges


class SemiStructuredFieldCountConfig:
    """Per-kind dynamic-field limits for semi-structured indexes
    (reference semi_structured_add_document_handler.py:23-28 — defaults
    read from MARQO_MAX_{LEXICAL,TENSOR}_FIELD_COUNT_UNSTRUCTURED)."""

    def __init__(self, max_lexical_field_count: Optional[int] = None,
                 max_tensor_field_count: Optional[int] = None):
        self.max_lexical_field_count = (
            max_lexical_field_count if max_lexical_field_count is not None
            else configs.read_env_vars_and_defaults_ints(
                "MARQO_MAX_LEXICAL_FIELD_COUNT_UNSTRUCTURED"))
        self.max_tensor_field_count = (
            max_tensor_field_count if max_tensor_field_count is not None
            else configs.read_env_vars_and_defaults_ints(
                "MARQO_MAX_TENSOR_FIELD_COUNT_UNSTRUCTURED"))


class AddDocumentsHandler:
    """One handler instance per request."""

    def __init__(self, index: MarqoIndex, engine: StoreEngine,
                 params: AddDocsParams, index_management=None,
                 meta_cache=None, field_count_config=None):
        self.index = index
        self.engine = engine
        self.params = params
        self.index_management = index_management
        self.meta_cache = meta_cache
        self.field_count_config = (field_count_config or
                                   SemiStructuredFieldCountConfig())
        self.mappings = dict(params.mappings or {})
        # structured indexes declare custom_vector / multimodal fields by
        # TYPE in the index settings, not via request mappings (reference
        # structured add-docs: field type drives handling) — synthesize
        # the equivalent mappings so one planning path serves both
        if isinstance(index, StructuredMarqoIndex):
            from marqo_tpu_torch.core.models.marqo_index import FieldType
            for field in index.fields:
                if field.name in self.mappings:
                    continue
                if field.type == FieldType.CustomVector:
                    self.mappings[field.name] = {"type": "custom_vector"}
                elif field.type == FieldType.MultimodalCombination:
                    self.mappings[field.name] = {
                        "type": "multimodal_combination",
                        "weights": dict(field.dependent_fields or {})}
        self._positions: Dict[str, int] = {}
        # docs whose _id was generated report id "" in error items
        # (reference AddDocumentsResponseCollector, test_add_documents_
        # handler.py:405-414: a generated id is never revealed on failure)
        self._generated_ids: set = set()

    # -- tensor field resolution --

    def _tensor_field_names(self, doc: dict) -> List[str]:
        if isinstance(self.index, StructuredMarqoIndex):
            if self.params.tensor_fields is not None:
                # unreachable via add_documents() (request-level gate
                # above, reference structured_add_document_handler.py:48)
                raise DocError(
                    "Cannot specify 'tensorFields' when adding documents to a "
                    "structured index. Tensor fields are defined in the index "
                    "settings.")
            return [tf.name for tf in self.index.tensor_fields if tf.name in doc
                    or tf.name in self.mappings]
        if self.params.tensor_fields is None:
            # unreachable via add_documents() (request-level gate above)
            raise DocError(
                "tensor_fields must be explicitly provided as a list for "
                "unstructured index. If you don't want to vectorise any "
                "field, please provide an empty list [].")
        return [f for f in self.params.tensor_fields
                if f in doc or f in self.mappings]

    # reference structured_vespa_index.py:18-39 _MARQO_TO_PYTHON_TYPE_MAP;
    # custom_vector/multimodal are omitted here because the RAW document
    # form is a dict validated by _plan_field (the reference checks the
    # converted form post-vectorise)
    _MARQO_TO_PYTHON_TYPE = {
        "text": str, "bool": bool, "int": int, "long": int,
        "float": (float, int), "double": (float, int),
        "array<text>": (list, str), "array<int>": (list, int),
        "array<float>": (list, (float, int)), "array<long>": (list, int),
        "array<double>": (list, (float, int)),
        "image_pointer": str, "video_pointer": str, "audio_pointer": str,
        "map<text, int>": (dict, int), "map<text, float>": (dict, float),
        "map<text, double>": (dict, float), "map<text, long>": (dict, int),
    }

    def _validate_structured_fields(self, doc: dict) -> None:
        if not isinstance(self.index, StructuredMarqoIndex):
            return
        field_map = self.index.field_map
        for field in doc:
            if field == constants.MARQO_DOC_ID:
                continue
            if field not in field_map:
                raise DocError(
                    f"Field `{field}` is not a valid field for structured "
                    f"index {self.index.name}. Valid fields are: "
                    f"{', '.join(sorted(field_map))}")
            self._verify_marqo_field_type(field, doc[field],
                                          field_map[field].type)

    def _verify_marqo_field_type(self, field: str, value, marqo_type) -> None:
        """Declared-type value check with the reference's exact messages
        (structured_vespa_index.py:873-890 _verify_marqo_field_type)."""
        type_value = getattr(marqo_type, "value", str(marqo_type))
        python_type = self._MARQO_TO_PYTHON_TYPE.get(type_value)
        if python_type is None:
            return  # custom_vector / multimodal: validated in _plan_field
        if isinstance(python_type, tuple) and python_type[0] in (list, dict):
            # inner types are only enforced for list values; map<...>
            # dict VALUES are validated by validate_map_numeric_field
            # (reference structured_vespa_index.py:877-881)
            container, inner = python_type
            if not isinstance(value, container) or (
                    isinstance(value, list)
                    and not all(isinstance(v, inner) for v in value)):
                raise DocError(
                    f"Invalid value {value} for a list field {field} with "
                    f"Marqo type {type_value}. All list elements must be "
                    f"the same valid type ")
        elif not isinstance(value, python_type):
            raise DocError(
                f"Invalid value {value} for field {field} with Marqo type "
                f"{type_value}. Expected a value of type {python_type}, "
                f"but found {type(value)}")
        values = value if isinstance(value, list) else \
            list(value.values()) if isinstance(value, dict) else [value]
        for v in values:
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._verify_numeric_range(v, type_value)

    # Vespa-representable numeric ranges (reference
    # structured_vespa_index.py:50-58, 908-930 — int min is -2^31+1 to
    # support filtering; float is fp32; long is int64; double unchecked)
    _MAX_FLOAT, _MIN_FLOAT = 3.4028235e38, -3.4028235e38
    _MAX_INT, _MIN_INT = 2147483647, -2147483647
    _MAX_LONG, _MIN_LONG = 2 ** 63 - 1, -(2 ** 63)

    def _verify_numeric_range(self, value, type_value: str) -> None:
        base = type_value.split("<")[-1].rstrip(">").split(", ")[-1]
        if base == "float" and not (
                self._MIN_FLOAT <= value <= self._MAX_FLOAT):
            raise DocError(
                f"Invalid value {value} for float field. Expected a value "
                f"in the range [{self._MIN_FLOAT}, {self._MAX_FLOAT}], but "
                f"found {value}. If you wish to store a value outside of "
                f"this range, create a field with type 'double' ")
        if base == "int" and not (self._MIN_INT <= value <= self._MAX_INT):
            raise DocError(
                f"Invalid value {value} for int field. Expected a value in "
                f"the range [{self._MIN_INT}, {self._MAX_INT}], but found "
                f"{value}. If you wish to store a value outside of this "
                f"range, create a field with type 'long' or 'double' ")
        if base == "long" and not (
                self._MIN_LONG <= value <= self._MAX_LONG):
            raise DocError(
                f"Invalid value {value} for long field. Expected a value in "
                f"the range [{self._MIN_LONG}, {self._MAX_LONG}], but found "
                f"{value}. If you wish to store a value outside of this "
                f"range, create a field with type 'double' ")

    def _round_structured_floats(self, fields: dict) -> None:
        """Float-typed structured fields are fp32 in Vespa; values round
        on store (reference test_long_double_numeric_values_edge_case:
        1e-50 comes back as 0)."""
        if not isinstance(self.index, StructuredMarqoIndex):
            return
        field_map = self.index.field_map
        for field, value in fields.items():
            marqo_field = field_map.get(field)
            if marqo_field is None:
                continue
            type_value = getattr(marqo_field.type, "value", "")
            if type_value == "float" and isinstance(value, float):
                fields[field] = self._fp32(value)
            elif type_value == "array<float>" and isinstance(value, list):
                fields[field] = [self._fp32(v) if isinstance(v, float)
                                 else v for v in value]
            elif type_value == "map<text, float>" and \
                    isinstance(value, dict):
                fields[field] = {k: self._fp32(v) if isinstance(v, float)
                                 else v for k, v in value.items()}

    @staticmethod
    def _fp32(value: float) -> float:
        # shortest-repr roundtrip like Vespa's JSON render of an fp32:
        # 3.4028235e38 stays 3.4028235e38 (not ...4663852886e38), 1e-50
        # underflows to 0.0 (str(), not repr() — numpy 2.x repr is
        # "np.float32(x)")
        return float(str(np.float32(value)))

    # -- chunk + vectorise planning --

    def _plan_field(self, doc: dict, field: str) -> Optional[dict]:
        """Returns a vectorisation plan for (doc, field):
        {"kind": "text"|"custom"|"multimodal", "chunks": [stored chunk str],
         "to_embed": [prefixed content], "vectors": optional ready vectors}
        """
        mapping = self.mappings.get(field)
        if mapping and mapping.get("type") == "custom_vector":
            if field not in doc:
                # a mapping declares how the field is handled WHEN present;
                # docs without it are valid (reference test_filtering adds
                # custom_vector mappings with most docs lacking the field)
                return None
            value = doc.get(field)
            if not isinstance(value, dict) or "vector" not in value:
                raise DocError(
                    f"Field `{field}` is a custom_vector field and must be a "
                    f"dict with 'vector' (and optional 'content')")
            # strict schema (reference CustomVectorFieldContent pydantic,
            # test_invalid_custom_vector_field_content): only
            # content/vector keys; content must be a string; vector a
            # list of numbers of the index dimension
            extra = set(value) - {"content", "vector"}
            if extra:
                raise DocError(
                    f"Field `{field}`: unexpected keys in custom_vector "
                    f"content: {sorted(extra)}")
            content = value.get("content")
            if content is None:
                content = ""
            if not isinstance(content, str):
                raise DocError(
                    f"Field `{field}`: custom_vector 'content' must be a "
                    f"string, got `{type(content).__name__}`")
            vector = value["vector"]
            dims = self.index.model.get_dimension()
            if (not isinstance(vector, list) or len(vector) != dims
                    or not all(isinstance(v, (int, float))
                               and not isinstance(v, bool)
                               for v in vector)):
                raise DocError(
                    f"Custom vector for field `{field}` must be a list of "
                    f"{dims} floats")
            vec = np.asarray(vector, dtype=np.float32)
            if self.index.normalize_embeddings:
                norm = float(np.linalg.norm(vec))
                if norm == 0:
                    raise DocError(
                        f"Field {field} has zero magnitude vector, "
                        f"cannot normalize.")
                vec = vec / norm
            return {"kind": "custom", "chunks": [content],
                    "vectors": vec[None, :], "content_key": content}

        if mapping and mapping.get("type") == "multimodal_combination":
            if field in doc:
                # reference unstructured_validation.py:106-110 — a document
                # may not carry a direct value for a multimodal field
                raise DocError(
                    f"Document and mappings object have conflicting fields: "
                    f"{{'{field}'}}")
            weights: Dict[str, float] = mapping["weights"]
            sub_content = {}
            for child, _w in weights.items():
                if child in doc:
                    value = doc[child]
                    if not isinstance(value, str):
                        # reference unstructured_validation.py:99-103
                        raise DocError(
                            f"Multimodal subfields must be strings "
                            f"representing text or image pointer, received "
                            f"{child}:{value}, which is of type "
                            f"{type(value).__name__}")
                    sub_content[child] = value
            if not sub_content:
                return None
            return {"kind": "multimodal", "weights": weights,
                    "sub_content": sub_content,
                    "chunks": [json.dumps(sub_content)]}

        value = doc.get(field)
        if value is None:
            return None
        if not isinstance(value, str):
            # reference tensor_fields_container.py:509-512 wording
            raise DocError(
                f"Invalid type {type(value)} for tensor field {field}")
        if self._treats_as_media(field, value):
            if isinstance(self.index, StructuredMarqoIndex):
                # the DECLARED pointer type routes the pipeline (reference
                # chunker-by-FieldType): an image_pointer whose URL sniffs
                # as video must still be processed as an image — and
                # surface an image-decode error — not silently re-routed
                declared = self.index.field_map[field].type
                kind = {FieldType.ImagePointer: "image",
                        FieldType.AudioPointer: "audio",
                        FieldType.VideoPointer: "video"}[declared]
                return {"kind": kind, "pointer": value, "chunks": [value]}
            from marqo_tpu_torch.tensor_search.add_docs import infer_modality
            modality = infer_modality(value)
            if modality == Modality.AUDIO:
                return {"kind": "audio", "pointer": value, "chunks": [value]}
            if modality == Modality.VIDEO:
                return {"kind": "video", "pointer": value, "chunks": [value]}
            return {"kind": "image", "pointer": value, "chunks": [value]}
        chunks = chunk_text(value, self.index.text_preprocessing)
        if not chunks:
            return None
        return {"kind": "text", "chunks": chunks, "content_key": value}

    def _child_media_modality(self, child_field: str, content: str):
        """Modality a multimodal SUBFIELD embeds as, or None for text.

        Structured: the DECLARED child field type decides (reference
        chunks subfields by FieldType — an image_pointer child must hit
        the image tower regardless of treat-flags, which structured
        indexes don't even define). Unstructured: the
        treat_urls_and_pointers flags gate content sniffing, exactly like
        top-level fields."""
        from marqo_tpu_torch.tensor_search.add_docs import (infer_modality,
                                                      is_media_pointer)
        if isinstance(self.index, StructuredMarqoIndex):
            declared = self.index.field_map.get(child_field)
            if declared is None:
                return None
            return {FieldType.ImagePointer: Modality.IMAGE,
                    FieldType.AudioPointer: Modality.AUDIO,
                    FieldType.VideoPointer: Modality.VIDEO}.get(declared.type)
        treat_images = getattr(self.index,
                               "treat_urls_and_pointers_as_images", False)
        treat_media = bool(getattr(self.index,
                                   "treat_urls_and_pointers_as_media",
                                   False))
        if not (treat_images or treat_media) or not is_media_pointer(content):
            return None  # never sniff on a URL-as-text index
        modality = infer_modality(content)
        if modality == Modality.IMAGE and treat_images:
            return Modality.IMAGE
        if modality in (Modality.AUDIO, Modality.VIDEO) and treat_media:
            return modality
        return None

    def _treats_as_media(self, field: str, value: str) -> bool:
        """Is this string field a media pointer to be embedded as
        image/audio/video? (reference: treat_urls_and_pointers_as_images /
        _as_media for unstructured, pointer field types for structured)."""
        from marqo_tpu_torch.tensor_search.add_docs import (infer_modality,
                                                      is_media_pointer)
        if isinstance(self.index, StructuredMarqoIndex):
            declared = self.index.field_map.get(field)
            return declared is not None and declared.type in (
                FieldType.ImagePointer, FieldType.VideoPointer,
                FieldType.AudioPointer)
        treat_images = getattr(self.index,
                               "treat_urls_and_pointers_as_images", False)
        treat_media = bool(getattr(self.index,
                                   "treat_urls_and_pointers_as_media",
                                   False))
        if not (treat_images or treat_media):
            # URL-as-text index: never classify (infer_modality may
            # sample-fetch extension-less URLs — reference only sniffs
            # when URLs are treated as media)
            return False
        if not is_media_pointer(value):
            return False
        modality = infer_modality(value)
        if modality == Modality.IMAGE:
            return treat_images
        if modality in (Modality.AUDIO, Modality.VIDEO):
            return treat_media
        return False

    # -- main entry --

    def add_documents(self) -> dict:
        collector = AddDocumentsResponseCollector()
        if isinstance(self.index, StructuredMarqoIndex) and \
                self.params.tensor_fields is not None:
            # reference structured_add_document_handler.py:48-51 —
            # request-level 400 before any per-doc processing (NOT one
            # error item per document inside a 200)
            raise InvalidArgumentError(
                "Cannot specify 'tensorFields' when adding documents to a "
                "structured index. Tensor fields are defined in the index "
                "settings.")
        if not isinstance(self.index, StructuredMarqoIndex) and \
                self.params.tensor_fields is None:
            # reference unstructured_validation.py:118-121 — request-level
            # 400 with exact wording (the reference validates before any
            # per-doc processing)
            raise InvalidArgumentError(
                "tensor_fields must be explicitly provided as a list for "
                "unstructured index. If you don't want to vectorise any "
                "field, please provide an empty list [].")
        if self.params.tensor_fields and \
                constants.MARQO_DOC_ID in self.params.tensor_fields:
            # reference unstructured_validation.py:122-123 — request-level 400
            raise InvalidArgumentError(
                "`_id` field cannot be a tensor field.")
        # (doc-count limits are enforced at AddDocsParams construction —
        # reference add_docs_params.py:78-94 validate_docs)

        # the stage spans time traced requests alone (api/telemetry.py)
        traced = telemetry.traced()
        if traced:
            traced.start("add_documents.plan")
        # reversed-iteration dedup: the LAST occurrence of an _id wins
        # (reference add_documents_handler.py:140-157)
        seen_ids = set()
        docs_to_process: List[Tuple[int, Optional[str], dict]] = []
        for position in range(len(self.params.docs) - 1, -1, -1):
            raw = self.params.docs[position]
            doc_id = None
            try:
                doc = _validate_doc(raw)
                if constants.MARQO_DOC_ID in doc:
                    doc_id = _validate_id(doc[constants.MARQO_DOC_ID])
                    if doc_id in seen_ids:
                        continue  # duplicate: silently superseded
                    seen_ids.add(doc_id)
                docs_to_process.append((position, doc_id, doc))
            except DocError as e:
                # only echo a usable string id; invalid ids report ""
                # (reference test_add_documents_handler.py:207-210)
                raw_id = raw.get("_id") if isinstance(raw, dict) else None
                collector.collect_error(
                    doc_id or (raw_id if isinstance(raw_id, str) else None),
                    e, position=position)
        docs_to_process.reverse()  # restore request order

        # plan: validate fields, chunk, gather embedding work
        plans: List[Tuple[str, dict, Dict[str, dict]]] = []
        existing_tensors: Dict[str, Dict[str, list]] = {}
        # per-request state initialized in __init__ (one handler instance
        # per request); _existing_multimodal_params is the only field not
        # set there because it only exists during add_documents
        self._existing_multimodal_params: Dict[str, dict] = {}
        for _pos, doc_id, doc in docs_to_process:
            try:
                self._validate_structured_fields(doc)
                assigned_id = doc_id or str(uuid.uuid4())
                if doc_id is None:
                    self._generated_ids.add(assigned_id)
                fields = {k: v for k, v in doc.items()
                          if k != constants.MARQO_DOC_ID}
                for field, value in fields.items():
                    if not isinstance(self.index, StructuredMarqoIndex):
                        try:
                            validate_field_name(field)
                        except ValueError as e:
                            raise DocError(str(e), code="invalid_field_name")
                    _validate_field_value(field, value)
                    if isinstance(value, dict) and \
                            field not in self.mappings:
                        # non-mapped dict fields must be numeric maps
                        # (reference validation.py:419-457
                        # validate_map_numeric_field)
                        _validate_map_numeric_field(value)
                field_plans = {}
                for field in self._tensor_field_names(doc):
                    plan = self._plan_field(doc, field)
                    if plan is not None:
                        field_plans[field] = plan
                if self.params.use_existing_tensors and doc_id:
                    existing_tensors[assigned_id] = self.engine.get_tensors(
                        self.index.schema_name, doc_id)
                    stored_doc = self.engine.get(
                        self.index.schema_name, doc_id) or {}
                    self._existing_multimodal_params[assigned_id] = \
                        stored_doc.get(
                            constants.MARQO_DOC_MULTIMODAL_PARAMS, {})
                plans.append((assigned_id, doc, field_plans))
                self._positions[assigned_id] = _pos
            except DocError as e:
                collector.collect_error(doc_id, e, position=_pos)
        if traced:
            traced.stop("add_documents.plan")

        # vectorise: one large device batch regardless of mode; the
        # batch_vectorisation_mode governs failure isolation (see
        # _encode_with_isolation)
        metrics = RequestMetricsStore.for_request()
        with metrics.time("add_documents.vectorise"):
            embeddings = self._vectorise_plans(plans, existing_tensors,
                                               collector)
        # semi-structured: grow the schema for new fields BEFORE
        # persisting (reference
        # semi_structured_add_document_handler.py:66-74)
        self._maybe_grow_semi_structured_schema(plans)
        metrics.start("add_documents.engine._bulk")
        self._feed_plans(plans, embeddings, collector)
        metrics.stop("add_documents.engine._bulk")
        return collector.to_response(self.index.name)

    def _error_id(self, assigned_id: str) -> str:
        """Generated ids are masked to "" in error items (reference
        test_add_documents_handler.py:405-414); success items keep them."""
        gen = getattr(self, "_generated_ids", None)
        return "" if gen and assigned_id in gen else assigned_id

    def _feed_plans(self, plans, embeddings, collector) -> None:
        for assigned_id, doc, field_plans in plans:
            try:
                tensors = {}
                for field, plan in field_plans.items():
                    vectors = embeddings.get((assigned_id, field))
                    if vectors is None:
                        continue
                    tensors[field] = {"chunks": plan["chunks"],
                                      "embeddings": vectors}
                fields = {k: v for k, v in doc.items()
                          if k != constants.MARQO_DOC_ID}
                # custom_vector fields store their content string
                for field, plan in field_plans.items():
                    if plan["kind"] == "custom" and field in fields:
                        fields[field] = plan["chunks"][0]
                # persist multimodal weights so useExistingTensors can
                # verify them on re-add (reference VESPA_DOC_MULTIMODAL_
                # PARAMS, unstructured_vespa_index/common.py:23); stripped
                # from all read paths
                mm_params = {
                    field: {"weights": plan["weights"]}
                    for field, plan in field_plans.items()
                    if plan["kind"] == "multimodal"}
                if mm_params:
                    fields[constants.MARQO_DOC_MULTIMODAL_PARAMS] = mm_params
                self._round_structured_floats(fields)
                self.engine.feed(self.index.schema_name, assigned_id, fields,
                                 tensors)
                collector.collect_success(
                    assigned_id, position=self._positions.get(assigned_id))
            except Exception as e:
                status, code, message = 500, "backend_error", str(e)
                from marqo_tpu_torch.core.exceptions import EngineOutOfSpaceError
                from marqo_tpu_torch.engine.client import (
                    EngineHTTPError, translate_engine_document_response)
                if isinstance(e, EngineHTTPError):
                    # remote-shard statuses translate per document
                    # (reference vespa_client.py:579-607 matrix)
                    status, message = translate_engine_document_response(
                        e.status, e.body)
                elif isinstance(e, EngineOutOfSpaceError):
                    # in-process feed-block takes the same 507 row of the
                    # translate matrix as a remote shard's 507
                    status, message = translate_engine_document_response(507)
                collector.collect_error(
                    self._error_id(assigned_id),
                    DocError(message, status=status, code=code),
                    position=self._positions.get(assigned_id))

    def _vectorise_plans(self, plans, existing_tensors, collector):
        """Run one batched vectorise over all pending chunks; returns
        {(doc_id, field): (n, dim) float32 rows}; encode failures are
        isolated per the request's batch_vectorisation_mode
        (_encode_with_isolation). ``plans`` is filtered in place for docs
        that fail during collection or encode."""
        chunk_prefix = self.index.model.get_text_chunk_prefix(
            self.params.text_chunk_prefix)
        to_embed: List[str] = []
        slots: List[Tuple[str, str, int]] = []  # (doc_id, field, row-in-field)
        to_embed_images: List[Any] = []
        image_slots: List[Tuple[str, str, int]] = []
        to_embed_audio: List[Any] = []
        audio_slots: List[Tuple[str, str, int]] = []
        to_embed_video: List[Any] = []
        video_slots: List[Tuple[str, str, int]] = []
        ready: Dict[Tuple[str, str], np.ndarray] = {}
        counts: Dict[Tuple[str, str], int] = defaultdict(int)

        # threaded download of all image pointers in the batch
        # (reference _download_media_contents, add_documents_handler.py:375)
        images, failed_docs = self._download_images(plans, collector)
        plans[:] = [p for p in plans if p[0] not in failed_docs]

        def _is_image_child(child: str, content: str) -> bool:
            return self._child_media_modality(child, content) == \
                Modality.IMAGE

        def _av_child_modality(child: str, content: str):
            """AUDIO/VIDEO when the subfield should be embedded as media,
            else None (reference supports audio/video multimodal
            subfields, tensor_fields_container.py:245-248: they chunk like
            top-level fields and their subfield embedding is the mean of
            clip embeddings)."""
            modality = self._child_media_modality(child, content)
            return modality if modality in (Modality.AUDIO,
                                            Modality.VIDEO) else None

        for assigned_id, _doc, field_plans in plans:
            reuse = existing_tensors.get(assigned_id, {})
            for field, plan in field_plans.items():
                if plan["kind"] == "custom":
                    ready[(assigned_id, field)] = plan["vectors"]
                    continue
                if plan["kind"] == "image":
                    image = images[plan["pointer"]]
                    patches, chunk_strs = self._patchify(image, plan["pointer"])
                    plan["chunks"] = chunk_strs
                    for patch in patches:
                        image_slots.append((assigned_id, field,
                                            counts[(assigned_id, field)]))
                        counts[(assigned_id, field)] += 1
                        to_embed_images.append(patch)
                    continue
                if plan["kind"] == "audio":
                    try:
                        pieces, chunk_strs = self._chunk_audio(plan["pointer"])
                    except Exception as e:
                        collector.collect_error(self._error_id(assigned_id), DocError(
                            f"Could not process audio "
                            f"`{plan['pointer']}`: {e}"),
                            position=self._positions.get(assigned_id))
                        failed_docs.add(assigned_id)
                        continue
                    plan["chunks"] = chunk_strs
                    for piece in pieces:
                        audio_slots.append((assigned_id, field,
                                            counts[(assigned_id, field)]))
                        counts[(assigned_id, field)] += 1
                        to_embed_audio.append(piece)
                    continue
                if plan["kind"] == "video":
                    try:
                        clips, chunk_strs = self._chunk_video(plan["pointer"])
                    except Exception as e:
                        collector.collect_error(self._error_id(assigned_id), DocError(
                            f"Could not process video "
                            f"`{plan['pointer']}`: {e}"),
                            position=self._positions.get(assigned_id))
                        failed_docs.add(assigned_id)
                        continue
                    plan["chunks"] = chunk_strs
                    for clip in clips:
                        video_slots.append((assigned_id, field,
                                            counts[(assigned_id, field)]))
                        counts[(assigned_id, field)] += 1
                        to_embed_video.append(clip)
                    continue
                if plan["kind"] == "multimodal":
                    # reuse the stored combined embedding when the subfield
                    # content AND weights are unchanged (reference
                    # tensor_fields_container.py populate_tensor_from_
                    # existing_docs: multimodal fields reuse only on exact
                    # type+weights+subfield match)
                    if field in reuse:
                        stored = reuse[field]
                        stored_weights = self._existing_multimodal_params \
                            .get(assigned_id, {}).get(field, {}) \
                            .get("weights")
                        if [e["chunk"] for e in stored] == plan["chunks"] \
                                and stored_weights == plan["weights"]:
                            ready[(assigned_id, field)] = np.asarray(
                                [e["embedding"] for e in stored],
                                dtype=np.float32)
                            continue
                    # children embedded individually then combined
                    child_failed = False
                    for child, content in plan["sub_content"].items():
                        av = _av_child_modality(child, content)
                        if _is_image_child(child, content):
                            image_slots.append(
                                (assigned_id, field + "::" + child, 0))
                            to_embed_images.append(images[content])
                        elif av is not None:
                            # audio/video subfields chunk like top-level
                            # fields; their embedding is the clip mean
                            # (combine step averages the child's rows)
                            try:
                                if av == Modality.AUDIO:
                                    pieces, _ = self._chunk_audio(content)
                                else:
                                    pieces, _ = self._chunk_video(content)
                            except Exception as e:
                                collector.collect_error(
                                    self._error_id(assigned_id), DocError(
                                        f"Could not process "
                                        f"{av.value} `{content}`: {e}"),
                                    position=self._positions.get(assigned_id))
                                failed_docs.add(assigned_id)
                                child_failed = True
                                break
                            target = (to_embed_audio if av == Modality.AUDIO
                                      else to_embed_video)
                            target_slots = (audio_slots
                                            if av == Modality.AUDIO
                                            else video_slots)
                            for i, piece in enumerate(pieces):
                                target_slots.append(
                                    (assigned_id, field + "::" + child, i))
                                target.append(piece)
                        else:
                            slots.append((assigned_id, field + "::" + child, 0))
                            to_embed.append(chunk_prefix + content)
                    if child_failed:
                        continue
                    continue
                # text: reuse identical existing chunks when requested
                if field in reuse:
                    stored = reuse[field]
                    stored_chunks = [e["chunk"] for e in stored]
                    if stored_chunks == plan["chunks"]:
                        ready[(assigned_id, field)] = np.asarray(
                            [e["embedding"] for e in stored], dtype=np.float32)
                        continue
                for chunk in plan["chunks"]:
                    slots.append((assigned_id, field,
                                  counts[(assigned_id, field)]))
                    counts[(assigned_id, field)] += 1
                    to_embed.append(chunk_prefix + chunk)

        # drop docs whose media chunking failed mid-collection (any stray
        # embeddings they queued are computed but never consumed)
        plans[:] = [p for p in plans if p[0] not in failed_docs]

        common = dict(
            model_name=self.index.model.name,
            model_properties=(self.index.model.properties
                              if self.index.model.custom else None),
            device=self.params.device,
            normalize_embeddings=self.index.normalize_embeddings,
            model_auth=self.params.model_auth)
        modal_inputs = {
            Modality.TEXT: (to_embed, slots),
            Modality.IMAGE: (to_embed_images, image_slots),
            Modality.AUDIO: (to_embed_audio, audio_slots),
            Modality.VIDEO: (to_embed_video, video_slots),
        }
        encoded, encode_failed = self._encode_with_isolation(
            modal_inputs, common, collector)
        if encode_failed:
            failed_docs.update(encode_failed)
            plans[:] = [p for p in plans if p[0] not in failed_docs]
        # scatter into the per-field arrays the feed takes: each
        # (doc, field) key's rows are consecutive slots of its
        # modality's array, so its rows are one slice of it (the store
        # copies what it keeps)
        traced = telemetry.traced()
        if traced:
            traced.start("inference.to_lists")
        rows: Dict[Tuple[str, str], np.ndarray] = {}
        for modality, (_contents, mslots) in modal_inputs.items():
            vectors = encoded[modality]
            if vectors is None:
                continue  # no contents, or every one of its docs failed
            for key, (start, stop) in _row_ranges(mslots).items():
                rows[key] = vectors[start:stop]

        result: Dict[Tuple[str, str], np.ndarray] = dict(ready)
        # combine multimodal children
        for assigned_id, _doc, field_plans in plans:
            for field, plan in field_plans.items():
                if plan["kind"] == "multimodal":
                    if (assigned_id, field) in ready:
                        continue  # reused stored embedding; no child slots
                    weights = plan["weights"]
                    acc = None
                    n_children = 0
                    for child, content in plan["sub_content"].items():
                        child_rows = rows.pop(
                            (assigned_id, field + "::" + child), None)
                        if child_rows is None:
                            # a child that produced ZERO chunks (e.g.
                            # a degenerate/empty waveform chunks to
                            # []) simply contributes nothing — the
                            # combine runs over present subfields, it
                            # must not KeyError the whole batch
                            continue
                        # multi-row children (audio/video clips) use
                        # the clip-mean as the subfield embedding
                        # (reference tensor_fields_container.py:320-323)
                        vec = np.mean(child_rows, axis=0)
                        w = float(weights[child])
                        acc = vec * w if acc is None else acc + vec * w
                        n_children += 1
                    if acc is None:
                        continue
                    # weighted MEAN over present subfields, not sum
                    # (reference tensor_fields_container.py:355-360:
                    # np.mean([v_i * w_i]); verified by the active
                    # test_multimodal_tensor_combination_tensor_value)
                    acc = acc / n_children
                    if self.index.normalize_embeddings:
                        norm = float(np.linalg.norm(acc))
                        if norm > 0:
                            acc = acc / norm
                    result[(assigned_id, field)] = acc[None, :]
                elif plan["kind"] in ("image", "audio", "video",
                                      "text") and \
                        (assigned_id, field) in rows:
                    result[(assigned_id, field)] = rows.pop(
                        (assigned_id, field))
        if traced:
            traced.stop("inference.to_lists")
        return result

    def _encode_with_isolation(self, modal_inputs, common, collector):
        """Batched encode with the reference's per-mode error isolation
        (reference add_documents_handler.py:264-373, add_docs_params.py:62).

        TPU-first shape: EVERY mode first tries one large device batch per
        modality — big dense batches are the whole point of the TPU design,
        and the reference's per-field/per-doc model calls would starve the
        MXU. The batching modes differ only in how a FAILURE is handled:

        - PER_BATCH: the whole request fails with InternalError (reference
          handler raises InternalError, add_documents_handler.py:367-372).
        - PER_DOCUMENT (default) / PER_FIELD: re-encode per document (or
          per field) so only the poisoned documents fail; every other doc
          keeps its vectors. A field failure fails its whole document in
          both modes, matching the reference's remove_doc semantics.

        Returns ({modality: (n, dim) float32 rows aligned with contents,
        or None for a modality without contents}, failed_doc_ids); failed
        docs' rows are left as zeros and never fed.
        Documents with no tensor chunks are never failed by a model error —
        they proceed to the feed stage regardless.
        """
        results = {}
        try:
            for modality, (contents, _slots) in modal_inputs.items():
                results[modality] = (
                    inference.vectorise(content=contents, modality=modality,
                                        **common)
                    if contents else None)
            return results, set()
        except Exception as e:
            if self.params.batch_vectorisation_mode == \
                    BatchVectorisationMode.PER_BATCH:
                from marqo_tpu_torch.api.exceptions import InternalError
                raise InternalError(
                    f"Encountered problem when vectorising batch of "
                    f"documents. Reason: {e}") from e
            logger.warning(
                f"Batched vectorisation failed ({e}); re-encoding "
                f"{self.params.batch_vectorisation_mode.value} to isolate "
                f"the failure")

        per_field = (self.params.batch_vectorisation_mode ==
                     BatchVectorisationMode.PER_FIELD)

        def key_of(slot):
            doc_id, field, _row = slot
            # multimodal children slots are named `field::child`; isolate at
            # the parent-field level
            return (doc_id, field.split("::", 1)[0]) if per_field else doc_id

        group_keys: List[Any] = []
        seen_keys = set()
        for _modality, (_contents, mslots) in modal_inputs.items():
            for slot in mslots:
                key = key_of(slot)
                if key not in seen_keys:
                    seen_keys.add(key)
                    group_keys.append(key)

        results = {m: None for m in modal_inputs}
        failed: set = set()
        for key in group_keys:
            doc_id = key[0] if per_field else key
            if doc_id in failed:
                continue  # reference: a field failure removes its whole doc
            try:
                for modality, (contents, mslots) in modal_inputs.items():
                    idxs = [i for i, s in enumerate(mslots)
                            if key_of(s) == key]
                    if not idxs:
                        continue
                    vecs = inference.vectorise(
                        content=[contents[i] for i in idxs],
                        modality=modality, **common)
                    if results[modality] is None:
                        results[modality] = np.zeros(
                            (len(contents), vecs.shape[1]), dtype=np.float32)
                    results[modality][idxs] = vecs
            except VectoriseError as e:
                # invalid inputs to vectorise (e.g. no_model) are the
                # user's error: 400/invalid_argument per item (reference
                # test_no_model.py:130-134)
                failed.add(doc_id)
                collector.collect_error(
                    self._error_id(doc_id),
                    DocError(str(e), status=400, code="invalid_argument"),
                    position=self._positions.get(doc_id))
            except Exception as e:
                failed.add(doc_id)
                collector.collect_error(
                    self._error_id(doc_id),
                    DocError(f"Error vectorising content: {e}", status=500,
                             code="vectorise_error"),
                    position=self._positions.get(doc_id))
        return results, failed

    def _download_images(self, plans, collector):
        """Threaded fetch of every image pointer in the batch; docs whose
        media fail to download are failed individually."""
        from marqo_tpu_torch.tensor_search.add_docs import (
            threaded_download_and_preprocess_content)
        pointers: List[str] = []
        pointer_docs: Dict[str, List[str]] = defaultdict(list)
        for assigned_id, _doc, field_plans in plans:
            for field, plan in field_plans.items():
                if plan["kind"] == "image":
                    pointers.append(plan["pointer"])
                    pointer_docs[plan["pointer"]].append(assigned_id)
                elif plan["kind"] == "multimodal":
                    # same structured-declared-type / unstructured-flag
                    # rule the embed step uses — a child that will embed
                    # as an image must be in the download map
                    for child, content in plan["sub_content"].items():
                        if self._child_media_modality(child, content) == \
                                Modality.IMAGE:
                            pointers.append(content)
                            pointer_docs[content].append(assigned_id)
        if not pointers:
            return {}, set()
        from marqo_tpu_torch.tensor_search.add_docs import _determine_thread_count
        images, errors = threaded_download_and_preprocess_content(
            pointers, modality=Modality.IMAGE,
            media_download_headers=self.params.media_download_headers,
            thread_count=_determine_thread_count(self.index, self.params))
        failed_docs = set()
        for pointer, message in errors.items():
            for doc_id in pointer_docs[pointer]:
                if doc_id not in failed_docs:
                    failed_docs.add(doc_id)
                    # reference add_documents_handler.py:406-408 exact
                    # wording for failed media downloads/decodes
                    collector.collect_error(self._error_id(doc_id), DocError(
                        f"Could not process the media file found at "
                        f"`{pointer}`. Reason: {message}",
                        code="invalid_argument"),
                        position=self._positions.get(doc_id))
        return images, failed_docs

    def _chunk_audio(self, pointer: str):
        """Fetch + decode + split an audio pointer into overlapping clips
        (reference AudioVideoChunker over ffmpeg chunks; .wav decodes
        without ffmpeg via ops/audio_ops.load_wav)."""
        from marqo_tpu_torch.ops.audio_ops import chunk_waveform, load_wav
        from marqo_tpu_torch.tensor_search.add_docs import fetch_content
        prep = self.index.audio_preprocessing
        split_length = prep.split_length if prep else 10
        split_overlap = prep.split_overlap if prep else 3
        wav = load_wav(fetch_content(
            pointer, self.params.media_download_headers))
        chunks = chunk_waveform(wav, split_length, split_overlap)
        pieces = [piece for (_s, _e, piece) in chunks]
        chunk_strs = [f"[{s:.1f}, {e:.1f}]" for (s, e, _p) in chunks]
        return pieces, chunk_strs

    def _chunk_video(self, pointer: str, frames_per_clip: int = 8):
        """Video → overlapping clips of sampled frames. Decodes with
        OpenCV's bundled codecs (no ffmpeg binary needed; the ffmpeg
        streaming processor remains available for exotic containers).
        Chunking mirrors the reference's fixed-length overlapping clips
        (streaming_media_processor.py:86-136)."""
        import cv2
        import os as _os
        import tempfile
        from marqo_tpu_torch.tensor_search.add_docs import fetch_content
        local = pointer
        cleanup = None
        if not _os.path.isfile(pointer):
            data = fetch_content(pointer,
                                 self.params.media_download_headers)
            fd, local = tempfile.mkstemp(suffix=_os.path.splitext(
                pointer.split("?")[0])[1] or ".mp4")
            with _os.fdopen(fd, "wb") as f:
                f.write(data)
            cleanup = local
        try:
            cap = cv2.VideoCapture(local)
            if not cap.isOpened():
                raise InvalidArgumentError(
                    f"Could not decode video `{pointer}`")
            fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            duration = total / fps if fps else 0
            prep = self.index.video_preprocessing
            split_length = prep.split_length if prep else 20
            split_overlap = prep.split_overlap if prep else 3
            step = max(1, split_length - split_overlap)
            frame_stacks, chunk_strs = [], []
            start = 0.0
            while start < max(duration, 1e-6):
                end = min(start + split_length, duration)
                first = int(start * fps)
                last = max(first + 1, int(end * fps))
                picks = np.linspace(first, last - 1,
                                    min(frames_per_clip, last - first),
                                    dtype=int)
                frames = []
                for frame_no in picks:
                    cap.set(cv2.CAP_PROP_POS_FRAMES, int(frame_no))
                    ok, frame = cap.read()
                    if ok:
                        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                if frames:
                    frame_stacks.append(frames)
                    chunk_strs.append(f"[{start:.1f}, {end:.1f}]")
                if start + split_length >= duration:
                    break
                start += step
            cap.release()
            if not frame_stacks:
                raise InvalidArgumentError(
                    f"No frames decoded from `{pointer}`")
            return frame_stacks, chunk_strs
        finally:
            if cleanup:
                _os.unlink(cleanup)

    def _patchify(self, image, pointer: str):
        """Apply the index's patch method; default = whole image, chunk
        string = the pointer (reference ImageChunker,
        tensor_fields_container.py:75)."""
        patch_method = self.index.image_preprocessing.patch_method
        if patch_method is None:
            return [image], [pointer]
        from marqo_tpu_torch.inference.image_patching import chunk_image
        patches, chunk_strs = chunk_image(image, patch_method.value)
        return patches, chunk_strs

    def _maybe_grow_semi_structured_schema(self, plans) -> None:
        if not isinstance(self.index, SemiStructuredMarqoIndex):
            return
        if self.index_management is None:
            return
        known_lexical = {f.name for f in self.index.lexical_fields}
        known_tensor = {tf.name for tf in self.index.tensor_fields}
        new_lexical: Dict[str, Field] = {}
        new_tensor: Dict[str, TensorField] = {}
        for _id, doc, field_plans in plans:
            for field, value in doc.items():
                if field == constants.MARQO_DOC_ID:
                    continue
                is_text = isinstance(value, str) or (
                    isinstance(value, list)
                    and all(isinstance(v, str) for v in value))
                if is_text and field not in known_lexical \
                        and field not in new_lexical:
                    field_type = (FieldType.ArrayText
                                  if isinstance(value, list)
                                  else FieldType.Text)
                    new_lexical[field] = Field(
                        name=field, type=field_type,
                        features=[], lexical_field_name=f"marqo__lexical_{field}")
            for field, plan in field_plans.items():
                if field not in known_tensor and field not in new_tensor:
                    new_tensor[field] = TensorField(
                        name=field,
                        chunk_field_name=f"marqo__chunks_{field}",
                        embeddings_field_name=f"marqo__embeddings_{field}")
                # custom_vector CONTENT is lexically searchable, so the
                # field also registers as a lexical field (reference
                # semi_structured_add_document_handler.py:
                # _add_lexical_field_to_index called for custom-vector
                # content; test_..._add_fields.py:141-168)
                if plan.get("kind") == "custom" \
                        and field not in known_lexical \
                        and field not in new_lexical:
                    new_lexical[field] = Field(
                        name=field, type=FieldType.Text, features=[],
                        lexical_field_name=f"marqo__lexical_{field}")
        if not new_lexical and not new_tensor:
            return
        # per-kind limits with the reference's exact wording + error type
        # (semi_structured_add_document_handler.py:75-107: checked against
        # the EXISTING count before each new field is admitted)
        from marqo_tpu_torch.core.exceptions import TooManyFieldsError
        max_lexical = self.field_count_config.max_lexical_field_count
        max_tensor = self.field_count_config.max_tensor_field_count
        if max_lexical is not None:
            count = len(known_lexical)
            for field in new_lexical:
                if count >= max_lexical:
                    raise TooManyFieldsError(
                        f"Index {self.index.name} has {count} lexical "
                        f"fields. Your request to add {field} as a lexical "
                        f"field is rejected since it exceeds the limit of "
                        f"{max_lexical}. Please set a larger limit in "
                        f"MARQO_MAX_LEXICAL_FIELD_COUNT_UNSTRUCTURED "
                        f"environment variable.")
                count += 1
        if max_tensor is not None:
            count = len(known_tensor)
            for field in new_tensor:
                if count >= max_tensor:
                    raise TooManyFieldsError(
                        f"Index {self.index.name} has {count} tensor "
                        f"fields. Your request to add {field} as a tensor "
                        f"field is rejected since it exceeds the limit of "
                        f"{max_tensor}. Please set a larger limit in "
                        f"MARQO_MAX_TENSOR_FIELD_COUNT_UNSTRUCTURED "
                        f"environment variable.")
                count += 1
        updated = self.index.model_copy(update={
            "lexical_fields": self.index.lexical_fields + list(new_lexical.values()),
            "tensor_fields": self.index.tensor_fields + list(new_tensor.values()),
        })
        self.index = self.index_management.update_index(updated)
        if self.meta_cache is not None:
            self.meta_cache.refresh_index(self.index.name)
