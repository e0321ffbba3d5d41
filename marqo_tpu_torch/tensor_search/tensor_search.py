"""Search + document orchestration.

Parity: reference src/marqo/tensor_search/tensor_search.py —
search() (:1459) dispatching TENSOR/LEXICAL/HYBRID, the query-vectorise
pipeline with content dedup + prefixes + weighted merges (:1738-2058),
_lexical_search (:1650), get_document_by_id (:1262), delete_documents
(:2699), add_documents (:105).
"""

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Union

import numpy as np

from marqo_tpu_torch.api import configs
from marqo_tpu_torch.api import exceptions as api_exceptions
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.core import constants
from marqo_tpu_torch.core.add_documents import AddDocumentsHandler
from marqo_tpu_torch.core.exceptions import InvalidArgumentError
from marqo_tpu_torch.core.models.add_docs_params import AddDocsParams
from marqo_tpu_torch.core.models.hybrid_parameters import (HybridParameters,
                                                     RankingMethod,
                                                     RetrievalMethod,
                                                     ScoreModifierLists)
from marqo_tpu_torch.core.models.marqo_index import MarqoIndex
from marqo_tpu_torch.core.search.search_filter import MarqoFilterStringParser
from marqo_tpu_torch.inference import vectorise as inference
from marqo_tpu_torch.tensor_search.utils import parse_lexical_query

SEARCH_METHOD_TENSOR = "TENSOR"
SEARCH_METHOD_LEXICAL = "LEXICAL"
SEARCH_METHOD_HYBRID = "HYBRID"


# --- validation ---------------------------------------------------------

def _validate_pagination(limit: int, offset: int) -> None:
    max_limit = configs.read_env_vars_and_defaults_ints("MARQO_MAX_SEARCH_LIMIT")
    max_offset = configs.read_env_vars_and_defaults_ints("MARQO_MAX_SEARCH_OFFSET")
    max_docs = configs.read_env_vars_and_defaults_ints("MARQO_MAX_RETRIEVABLE_DOCS")
    # exact reference wording (tensor_search.py:1505-1540)
    if limit <= 0:
        raise api_exceptions.IllegalRequestedDocCount(
            f"result_count must be an integer greater than 0! "
            f"Received {limit}")
    if offset < 0:
        raise api_exceptions.IllegalRequestedDocCount(
            "search result offset cannot be less than 0!")
    if max_docs is not None and limit + offset > max_docs:
        raise api_exceptions.IllegalRequestedDocCount(
            f"The search result limit + offset must be less than or equal "
            f"to the MARQO_MAX_RETRIEVABLE_DOCS limit of [{max_docs}]. "
            f"Marqo received search result limit of `{limit}` "
            f"and offset of `{offset}`.")
    if max_limit is not None and limit > max_limit:
        raise api_exceptions.IllegalRequestedDocCount(
            f"The search result limit must be less than or equal to the "
            f"MARQO_MAX_SEARCH_LIMIT limit of [{max_limit}]. Marqo received "
            f"search result limit of `{limit}`.")
    if max_offset is not None and offset > max_offset:
        raise api_exceptions.IllegalRequestedDocCount(
            f"The search result offset must be less than or equal to the "
            f"MARQO_MAX_SEARCH_OFFSET limit of [{max_offset}]. Marqo "
            f"received search result offset of `{offset}`.")


def _validate_filter_for_index(index: MarqoIndex, tree) -> None:
    """Index-aware filter checks (reference behavior):

    - IN is structured-only (unstructured_vespa_index.py:221);
    - on structured indexes IN works only on string/int-family fields,
      with per-element int validation
      (structured_vespa_index.py:694-728 _convert_to_in_list_str).
    """
    from marqo_tpu_torch.core.exceptions import InvalidDataTypeError
    from marqo_tpu_torch.core.models.marqo_index import FieldType, IndexType
    from marqo_tpu_torch.core.search import search_filter as sf

    STR_FIELD_TYPES = [FieldType.Text, FieldType.ArrayText,
                       FieldType.CustomVector]
    INT_FIELD_TYPES = [FieldType.Int, FieldType.Long, FieldType.ArrayInt,
                       FieldType.ArrayLong]

    def walk(node):
        if isinstance(node, sf.InTerm):
            if index.type != IndexType.Structured:
                raise InvalidArgumentError(
                    "The 'IN' filter keyword is not yet supported for "
                    "unstructured indexes")
            field = index.field_map.get(node.field)
            if node.field == "_id" or field is None:
                return  # _id is string-typed; unknown fields match nothing
            if field.type in STR_FIELD_TYPES:
                return
            if field.type in INT_FIELD_TYPES:
                for value in node.value_list:
                    try:
                        int(value)
                    except ValueError:
                        raise InvalidDataTypeError(
                            f"Attempting to use the IN filter operator on "
                            f"field: '{node.field}' of type: "
                            f"'{field.type.value}', but found list element "
                            f"'{value}', which is not of type 'int'.")
                return
            raise InvalidDataTypeError(
                f"The IN filter operator is only supported for the "
                f"following field types: "
                f"{[t.value for t in STR_FIELD_TYPES + INT_FIELD_TYPES]}. "
                f"However, '{node.field}' is of unsupported type: "
                f"'{field.type.value}'.")
        elif isinstance(node, sf.Operator):
            walk(node.left)
            walk(node.right)
        elif isinstance(node, sf.Not):
            walk(node.modified)

    walk(tree.root if isinstance(tree, sf.SearchFilter) else tree)


# --- query vectorisation -------------------------------------------------

def compute_query_vector(index: MarqoIndex,
                         text: Optional[Union[str, Dict[str, float]]],
                         context: Optional[dict],
                         device: Optional[str],
                         text_query_prefix: Optional[str] = None,
                         model_auth: Optional[dict] = None,
                         media_download_headers: Optional[dict] = None
                         ) -> List[float]:
    """Vectorise a (possibly weighted multi-part) query with content dedup,
    merge with context vectors (reference run_vectorise_pipeline +
    get_query_vectors_from_jobs, tensor_search.py:1913-2058)."""
    weighted: "OrderedDict[str, float]" = OrderedDict()
    if isinstance(text, str):
        if context:
            # reference validation.py:181-189 validate_context
            raise InvalidArgumentError(
                f"Marqo received a query = `{text}` with type "
                f"=`{type(text).__name__}` and a parameter `context`.\n"
                f"This is not supported as the context only works when the "
                f"query is a dictionary. If you aim to search with your "
                f"custom vectors, reformat the query as a dictionary.\n")
        weighted[text] = 1.0
    elif isinstance(text, dict):
        if not text:
            raise InvalidArgumentError("Query dict cannot be empty")
        for q, w in text.items():
            if not isinstance(q, str) or not isinstance(w, (int, float)):
                raise InvalidArgumentError(
                    "Multi-part query must map strings to numeric weights")
            weighted[q] = weighted.get(q, 0.0) + float(w)
    elif text is not None:
        raise InvalidArgumentError(
            f"query must be a string or a dict of weighted strings, got "
            f"{type(text).__name__}")

    dims = index.model.get_dimension()
    acc = np.zeros((dims,), dtype=np.float32)
    n_vectors = 0
    got_any = False

    if weighted:
        from marqo_tpu_torch.inference.types import Modality
        from marqo_tpu_torch.tensor_search.add_docs import (fetch_content,
                                                      infer_modality,
                                                      is_media_pointer)
        from marqo_tpu_torch.ops.image_ops import host_decode
        treat_images = getattr(index, "treat_urls_and_pointers_as_images",
                               False)
        treat_media = getattr(index, "treat_urls_and_pointers_as_media",
                              False)
        prefix = index.model.get_text_query_prefix(text_query_prefix)
        common = dict(
            model_name=index.model.name,
            model_properties=(index.model.properties if index.model.custom
                              else None),
            device=device,
            normalize_embeddings=index.normalize_embeddings,
            model_auth=model_auth)

        def query_modality(q: str) -> Modality:
            if not is_media_pointer(q):
                return Modality.TEXT
            modality = infer_modality(q)
            if modality == Modality.IMAGE and treat_images:
                return Modality.IMAGE
            if modality in (Modality.AUDIO, Modality.VIDEO) and treat_media:
                return modality
            return Modality.TEXT

        by_modality: Dict[Modality, list] = {}
        for q, w in weighted.items():
            by_modality.setdefault(query_modality(q), []).append((q, w))

        text_items = by_modality.pop(Modality.TEXT, [])
        if text_items:
            vectors = inference.vectorise(
                content=[prefix + q for q, _ in text_items],
                enable_cache=True, **common)
            for vec, (_, w) in zip(vectors, text_items):
                acc += np.asarray(vec, dtype=np.float32) * w
                n_vectors += 1
                got_any = True
        for modality, items in by_modality.items():
            try:
                if modality == Modality.IMAGE:
                    contents = [host_decode(fetch_content(
                        q, media_download_headers)) for q, _ in items]
                elif modality == Modality.AUDIO:
                    from marqo_tpu_torch.ops.audio_ops import load_wav
                    contents = [load_wav(fetch_content(
                        q, media_download_headers)) for q, _ in items]
                else:
                    raise InvalidArgumentError(
                        "Video queries require pre-decoded frames; query by "
                        "text, image, or audio instead")
            except InvalidArgumentError:
                raise
            except Exception as e:
                # query-side media failures are the caller's error — 400
                # with the reference wording (tensor_search.py:1909)
                raise InvalidArgumentError(
                    f"Error vectorising content: "
                    f"{[q for q, _ in items]}. Message: {e}") from e
            vectors = inference.vectorise(content=contents,
                                          modality=modality, **common)
            for vec, (_, w) in zip(vectors, items):
                acc += np.asarray(vec, dtype=np.float32) * w
                n_vectors += 1
                got_any = True

    if context:
        tensors = context.get("tensor") if isinstance(context, dict) else None
        if not tensors:
            raise InvalidArgumentError(
                "Context must be a dict with a 'tensor' list of "
                "{'vector': [...], 'weight': w} entries")
        for entry in tensors:
            vec = np.asarray(entry["vector"], dtype=np.float32)
            if vec.shape != (dims,):
                raise InvalidArgumentError(
                    f"The dimension of the vectors returned by the model or "
                    f"given by the context vectors does not match the "
                    f"expected dimension. Expected dimension {dims} but got "
                    f"{vec.shape[0]}")
            acc += vec * float(entry.get("weight", 1.0))
            n_vectors += 1
            got_any = True

    if not got_any:
        # reference api_models.py:84-85
        raise InvalidArgumentError(
            "One of Query(q) or context is required for TENSOR search "
            "but both are missing")

    # reference merges weighted query/context vectors with np.mean, not a
    # sum (tensor_search.py:1967) - identical direction when normalizing,
    # but the magnitude matters for normalize_embeddings=False indexes
    if n_vectors > 1:
        acc = acc / n_vectors
    if index.normalize_embeddings:
        norm = float(np.linalg.norm(acc))
        if norm > 0:
            acc = acc / norm
    return acc.tolist()


# --- search ---------------------------------------------------------------

def search(config: Config, index_name: str,
           text: Optional[Union[str, Dict[str, float]]] = None,
           search_method: str = SEARCH_METHOD_TENSOR,
           limit: int = 10, offset: int = 0,
           ef_search: Optional[int] = None,
           approximate: Optional[bool] = None,
           searchable_attributes: Optional[List[str]] = None,
           filter: Optional[str] = None,
           attributes_to_retrieve: Optional[List[str]] = None,
           device: Optional[str] = None,
           score_modifiers: Optional[dict] = None,
           context: Optional[dict] = None,
           show_highlights: bool = True,
           text_query_prefix: Optional[str] = None,
           hybrid_parameters: Optional[dict] = None,
           model_auth: Optional[dict] = None,
           expose_facets: bool = False,
           reranker: Optional[str] = None,
           reranker_properties: Optional[dict] = None,
           media_download_headers: Optional[dict] = None) -> dict:
    start = time.perf_counter()
    original_query = text  # echoed verbatim in the response (reference
    # tensor_search.py:1639 — None stays null, custom-vector queries echo
    # their object form)
    _validate_pagination(limit, offset)
    method = str(search_method).upper()
    if method not in (SEARCH_METHOD_TENSOR, SEARCH_METHOD_LEXICAL,
                      SEARCH_METHOD_HYBRID):
        raise api_exceptions.InvalidArgError(
            f"Search method `{search_method}` is not valid! Choose one of "
            f"TENSOR, LEXICAL, HYBRID")

    # reference validation.py:74-97: the cap applies to TENSOR search only,
    # and once MARQO_MAX_SEARCHABLE_TENSOR_ATTRIBUTES is set the request
    # must pass explicit searchable_attributes (None is an error too)
    from marqo_tpu_torch.tensor_search.validation import \
        validate_searchable_attributes
    validate_searchable_attributes(searchable_attributes, method)

    # custom-vector query normalisation (reference CustomVectorQuery,
    # test_hybrid_search.py:315-434): the supplied VECTOR joins the
    # context for the tensor leg (mean with any context vectors) while
    # the CONTENT string drives the lexical leg
    custom_vector_content = None
    _cv = None
    if isinstance(text, dict) and set(text.keys()) == {"customVector"} \
            and isinstance(text["customVector"], dict):
        _cv = text["customVector"]
    elif hasattr(text, "customVector"):
        _cv = text.customVector
        if not isinstance(_cv, dict):
            _cv = _cv.model_dump() if hasattr(_cv, "model_dump") else \
                dict(_cv)
    if _cv is not None:
        # reference validation.py:35-40: custom-vector queries are only
        # valid for HYBRID/TENSOR (message names HYBRID only)
        if method not in (SEARCH_METHOD_TENSOR, SEARCH_METHOD_HYBRID):
            raise api_exceptions.InvalidArgError(
                'Custom vector search is currently only supported for '
                'search_method="HYBRID" \nReceived search_method '
                f'`{search_method}`.')
        if not isinstance(_cv, dict) or not _cv.get("vector"):
            raise api_exceptions.InvalidArgError(
                "Custom vector query must provide a non-empty `vector`")
        extra = [{"vector": _cv["vector"], "weight": 1.0}]
        context = ({"tensor": list((context or {}).get("tensor", []))
                    + extra} if context else {"tensor": extra})
        custom_vector_content = _cv.get("content")
        text = None
    else:
        # reference tensor_search.py:1517 validate_query: dict multi-
        # queries only for TENSOR (with kv-type checks); non-str/dict/None
        # q values are a 400
        from marqo_tpu_torch.tensor_search.validation import validate_query
        validate_query(text, search_method)

    if attributes_to_retrieve is not None and \
            not isinstance(attributes_to_retrieve, (list, tuple)):
        # reference test_attributes_to_retrieve_non_list: strings/dicts/
        # numbers are a 400, not silently iterated
        raise api_exceptions.InvalidArgError(
            f"attributes_to_retrieve must be a list of field names, "
            f"received `{attributes_to_retrieve}` of type "
            f"`{type(attributes_to_retrieve).__name__}`")

    index = config.index_meta_cache.get_index(index_name)

    # structured indexes validate the requested field names up front
    # (reference structured_vespa_index.py:355-363 and :598-604)
    from marqo_tpu_torch.core.models.marqo_index import IndexType
    if index.type == IndexType.Structured:
        field_map = index.field_map
        if attributes_to_retrieve is not None:
            for att in attributes_to_retrieve:
                if att not in field_map:
                    raise api_exceptions.InvalidFieldNameError(
                        f'Index {index.name} has no field {att}. '
                        f'Available fields are: '
                        f'{", ".join(field_map.keys())}')
        if searchable_attributes is not None and \
                method == SEARCH_METHOD_TENSOR:
            tensor_field_map = index.tensor_field_map
            for att in searchable_attributes:
                if att not in tensor_field_map:
                    raise api_exceptions.InvalidFieldNameError(
                        f'Index {index.name} has no tensor field {att}. '
                        f'Available tensor fields are: '
                        f'{", ".join(tensor_field_map.keys())}')

    # `filter=""` is a parse error, not "no filter"
    # (reference test_filtering_bad_syntax includes the empty string)
    search_filter = (MarqoFilterStringParser().parse(filter)
                     if filter is not None else None)
    if search_filter is not None:
        _validate_filter_for_index(index, search_filter)
    mods = None
    if score_modifiers:
        mods = ScoreModifierLists(**score_modifiers).to_score_modifiers()

    if method == SEARCH_METHOD_TENSOR:
        result = _tensor_search(config, index, text, context, limit, offset,
                                ef_search, approximate, searchable_attributes,
                                search_filter, mods, attributes_to_retrieve,
                                device, show_highlights, text_query_prefix,
                                model_auth, expose_facets,
                                media_download_headers)
    elif method == SEARCH_METHOD_LEXICAL:
        result = _lexical_search(config, index, text, limit, offset,
                                 searchable_attributes, search_filter, mods,
                                 attributes_to_retrieve, expose_facets,
                                 show_highlights)
    else:
        # reference marqo_query.py:63-76 — hybrid rejects the top-level
        # knobs; the per-leg variants live inside hybridParameters
        if score_modifiers:
            raise api_exceptions.InvalidArgError(
                "'scoreModifiers' cannot be used for hybrid search. "
                "Instead, define the 'scoreModifiersTensor' and/or "
                "'scoreModifiersLexical' keys inside the "
                "'hybridParameters' dict parameter.")
        if searchable_attributes is not None:
            raise api_exceptions.InvalidArgError(
                "'searchableAttributes' cannot be used for hybrid search. "
                "Instead, define the 'searchableAttributesTensor' and/or "
                "'searchableAttributesLexical' keys inside the "
                "'hybridParameters' dict parameter.")
        result = _hybrid_search(config, index, text, context, limit, offset,
                                ef_search, approximate, search_filter,
                                attributes_to_retrieve, device,
                                show_highlights, text_query_prefix,
                                hybrid_parameters, model_auth, expose_facets,
                                media_download_headers,
                                lexical_text=custom_vector_content)

    if reranker is not None:
        # optional cross-encoder rerank (reference tensor_search.py:1619-1637;
        # rerank_query:1443-1456 — None searchable_attributes is a 400 with
        # this exact wording, and any rerank failure wraps as BadRequest)
        if searchable_attributes is None:
            raise api_exceptions.InvalidArgError(
                "searchable_attributes cannot be None when re-ranking. "
                "Specify which fields to search and rerank over.")
        from marqo_tpu_torch.inference.rerank import rerank_search_results
        rerank_search_results(result, text if isinstance(text, str) else "",
                              reranker, device=device,
                              searchable_attributes=searchable_attributes,
                              properties=reranker_properties)

    result["query"] = original_query
    result["limit"] = limit
    result["offset"] = offset
    result["processingTimeMs"] = round((time.perf_counter() - start) * 1000)
    return result


def _hit_to_dict(hit, show_highlights: bool, method: str) -> dict:
    doc = dict(hit.fields)
    doc.pop(constants.MARQO_DOC_MULTIMODAL_PARAMS, None)  # internal field
    doc[constants.MARQO_DOC_ID] = hit.doc_id
    doc["_score"] = float(hit.score)
    if show_highlights:
        doc[constants.MARQO_DOC_HIGHLIGHTS] = (
            [hit.highlight] if hit.highlight else [])
    if method == SEARCH_METHOD_HYBRID:
        if hit.raw_tensor_score is not None:
            doc[constants.MARQO_DOC_HYBRID_TENSOR_SCORE] = hit.raw_tensor_score
        if hit.raw_lexical_score is not None:
            doc[constants.MARQO_DOC_HYBRID_LEXICAL_SCORE] = hit.raw_lexical_score
    return doc


def _default_ef_search(ef_search: Optional[int], limit: int,
                       offset: int) -> int:
    """ef_search default = max(MARQO_DEFAULT_EF_SEARCH, limit+offset)
    (reference tensor_search.py:1571-1578)."""
    if ef_search is not None:
        if ef_search < limit + offset:
            raise api_exceptions.InvalidArgError(
                f"efSearch `{ef_search}` must be ≥ limit+offset "
                f"`{limit + offset}`")
        return ef_search
    # `or 2000`: an env var set to '' reads as None (configs contract) —
    # max(None, int) would TypeError every default-ef search into a 500
    default = configs.read_env_vars_and_defaults_ints(
        "MARQO_DEFAULT_EF_SEARCH") or 2000
    return max(default, limit + offset)


def _tensor_search(config, index, text, context, limit, offset, ef_search,
                   approximate, searchable_attributes, search_filter, mods,
                   attributes_to_retrieve, device, show_highlights,
                   text_query_prefix, model_auth, expose_facets,
                   media_download_headers=None) -> dict:
    from marqo_tpu_torch.api.telemetry import RequestMetricsStore
    metrics = RequestMetricsStore.for_request()
    with metrics.time("search.vector.processing_before_engine"):
        vector = compute_query_vector(index, text, context, device,
                                      text_query_prefix, model_auth,
                                      media_download_headers)
    if approximate is None:
        approximate = configs.read_env_vars_and_defaults_bool(
            "MARQO_DEFAULT_APPROXIMATE_SEARCH")
    metrics.start("search.vector.engine")
    res = config.engine.query_tensor(
        index.schema_name, vector, limit=limit, offset=offset,
        searchable_fields=searchable_attributes,
        search_filter=search_filter, score_modifiers=mods,
        ef_search=_default_ef_search(ef_search, limit, offset),
        approximate=approximate,
        attributes_to_retrieve=attributes_to_retrieve,
        expose_facets=expose_facets)
    metrics.stop("search.vector.engine")
    return {"hits": [_hit_to_dict(h, show_highlights, SEARCH_METHOD_TENSOR)
                     for h in res.hits]}


def _lexical_search(config, index, text, limit, offset,
                    searchable_attributes, search_filter, mods,
                    attributes_to_retrieve, expose_facets,
                    show_highlights: bool = True) -> dict:
    if not isinstance(text, str):
        raise api_exceptions.InvalidArgError(
            "Query q must be a string for LEXICAL search")
    and_phrases, or_terms = parse_lexical_query(text)
    res = config.engine.query_lexical(
        index.schema_name, or_phrases=or_terms, and_phrases=and_phrases,
        limit=limit, offset=offset,
        searchable_fields=searchable_attributes,
        search_filter=search_filter, score_modifiers=mods,
        attributes_to_retrieve=attributes_to_retrieve,
        expose_facets=expose_facets)
    # lexical hits carry an EMPTY _highlights list when highlights are on
    # (reference test_lexical_search_no_highlights_format: the key exists,
    # the list is empty; highlights=False drops the key entirely)
    return {"hits": [_hit_to_dict(h, show_highlights,
                                  SEARCH_METHOD_LEXICAL)
                     for h in res.hits]}


def _hybrid_search(config, index, text, context, limit, offset, ef_search,
                   approximate, search_filter, attributes_to_retrieve, device,
                   show_highlights, text_query_prefix, hybrid_parameters,
                   model_auth, expose_facets,
                   media_download_headers=None, lexical_text=None) -> dict:
    """``lexical_text``: a custom-vector query's CONTENT — the tensor leg
    uses the supplied vector (via context) while the lexical leg matches
    the content string (reference test_hybrid_search.py:315-434)."""
    params = HybridParameters(**(hybrid_parameters or {}))
    from marqo_tpu_torch.core.models.marqo_index import (IndexType,
                                                   SemiStructuredMarqoIndex)
    if (index.type == IndexType.Unstructured
            and not isinstance(index, SemiStructuredMarqoIndex)
            and (params.searchableAttributesTensor is not None
                 or params.searchableAttributesLexical is not None)):
        # reference hybrid_search.py:109-116: legacy unstructured indexes
        # reject per-leg searchable attributes
        from marqo_tpu_torch.core.exceptions import UnsupportedFeatureError
        raise UnsupportedFeatureError(
            "Hybrid search for unstructured indexes currently does not "
            "support `searchableAttributesTensor` or "
            "`searchableAttributesLexical`. Please set these attributes "
            "to None.")
    if text is None and lexical_text is None:
        # a None query is only a context-vector tensor search in disguise
        # (reference hybrid_search.py:132-142); a custom-vector query with
        # content still has a lexical leg and is exempt
        if not (params.retrievalMethod == RetrievalMethod.Tensor
                and params.rankingMethod == RankingMethod.Tensor):
            raise InvalidArgumentError(
                "Query cannot be 'None' for hybrid search unless "
                "retrieval_method and ranking_method are both 'tensor'.")
        if context is None:
            raise InvalidArgumentError(
                "Query cannot be 'None' for hybrid search unless "
                "'context' is provided.")
    needs_tensor = (params.retrievalMethod in (RetrievalMethod.Disjunction,
                                               RetrievalMethod.Tensor)
                    or params.rankingMethod == RankingMethod.Tensor)
    vector: List[float] = []
    if needs_tensor:
        vector = compute_query_vector(index, text, context, device,
                                      text_query_prefix, model_auth,
                                      media_download_headers)
    lexical_query = lexical_text if lexical_text is not None else text
    if isinstance(lexical_query, str):
        and_phrases, or_terms = parse_lexical_query(lexical_query)
    else:
        and_phrases, or_terms = [], []

    mods_tensor = (params.scoreModifiersTensor.to_score_modifiers()
                   if params.scoreModifiersTensor else None)
    mods_lexical = (params.scoreModifiersLexical.to_score_modifiers()
                    if params.scoreModifiersLexical else None)

    res = config.engine.query_hybrid(
        index.schema_name, vector, or_phrases=or_terms,
        and_phrases=and_phrases, limit=limit, offset=offset,
        retrieval_method=params.retrievalMethod.value,
        ranking_method=params.rankingMethod.value,
        alpha=params.alpha if params.alpha is not None else 0.5,
        rrf_k=params.rrfK if params.rrfK is not None else 60,
        searchable_fields_tensor=params.searchableAttributesTensor,
        searchable_fields_lexical=params.searchableAttributesLexical,
        search_filter=search_filter,
        score_modifiers_tensor=mods_tensor,
        score_modifiers_lexical=mods_lexical,
        ef_search=_default_ef_search(ef_search, limit, offset),
        # same operator default the TENSOR path honors — a hybrid tensor
        # leg must not silently keep the HNSW when
        # MARQO_DEFAULT_APPROXIMATE_SEARCH=FALSE forces exact scoring
        approximate=(configs.read_env_vars_and_defaults_bool(
            "MARQO_DEFAULT_APPROXIMATE_SEARCH")
            if approximate is None else approximate),
        attributes_to_retrieve=attributes_to_retrieve,
        expose_facets=expose_facets)
    return {"hits": [_hit_to_dict(h, show_highlights, SEARCH_METHOD_HYBRID)
                     for h in res.hits]}


# --- documents ---------------------------------------------------------------

def add_documents(config: Config, params: AddDocsParams) -> dict:
    index = config.index_meta_cache.get_index(params.index_name,
                                              force_refresh=True)
    handler = AddDocumentsHandler(
        index=index, engine=config.engine, params=params,
        index_management=config.index_management,
        meta_cache=config.index_meta_cache)
    return handler.add_documents()


def get_document_by_id(config: Config, index_name: str, document_id: str,
                       show_vectors: bool = False) -> dict:
    # reference validation.validate_id: non-string / empty ids are a 400,
    # not a 404 (test_get_document.py:80-96)
    from marqo_tpu_torch.tensor_search.utils import validate_doc_id
    validate_doc_id(document_id)
    index = config.index_meta_cache.get_index(index_name)
    doc = config.engine.get(index.schema_name, document_id)
    if doc is None:
        raise api_exceptions.DocumentNotFoundError(
            f"Document with ID {document_id} not found in index {index_name}")
    doc.pop(constants.MARQO_DOC_MULTIMODAL_PARAMS, None)  # internal field
    doc[constants.MARQO_DOC_ID] = document_id
    if show_vectors:
        facets = []
        for field, entries in config.engine.get_tensors(
                index.schema_name, document_id).items():
            for e in entries:
                facets.append({field: e["chunk"], "_embedding": e["embedding"]})
        doc["_tensor_facets"] = facets
    return doc


def get_documents_by_ids(config: Config, index_name: str,
                         document_ids: List[str],
                         show_vectors: bool = False) -> dict:
    # reference tensor_search.py:1319-1328 — collection/emptiness checks
    # are distinct InvalidArgErrors; the max-docs limit names the env var
    from collections.abc import Collection
    if not isinstance(document_ids, Collection) or \
            isinstance(document_ids, (str, bytes)):
        raise api_exceptions.InvalidArgError(
            "Get documents must be passed a collection of IDs!")
    if len(document_ids) <= 0:
        raise api_exceptions.InvalidArgError(
            "Can't get empty collection of IDs!")
    max_docs = configs.read_env_vars_and_defaults_ints(
        "MARQO_MAX_RETRIEVABLE_DOCS")
    if max_docs is not None and len(document_ids) > max_docs:
        raise api_exceptions.IllegalRequestedDocCount(
            f"{len(document_ids)} documents were requested, which is more "
            f"than the allowed limit of [{max_docs}], set by the "
            f"environment variable `MARQO_MAX_RETRIEVABLE_DOCS`")
    results = []
    errors = False
    for doc_id in document_ids:
        try:
            doc = get_document_by_id(config, index_name, doc_id, show_vectors)
            results.append({**doc, "_found": True})
        except api_exceptions.DocumentNotFoundError:
            results.append({constants.MARQO_DOC_ID: doc_id, "_found": False})
        except api_exceptions.InvalidDocumentIdError as e:
            # per-item 400 instead of failing the batch (reference
            # test_get_documents_by_ids_InvalidIdsResponse; _found stays
            # unset on invalid-id items)
            errors = True
            results.append({constants.MARQO_DOC_ID: doc_id, "status": 400,
                            "message": e.message})
    return {"errors": errors, "results": results}


def delete_documents(config: Config, index_name: str,
                     document_ids: List[str]) -> dict:
    """Batch delete (parity: reference tensor_search/delete_docs.py:36,
    validation.py:637). Deleting a non-existent id still reports
    status 200 / 'deleted' — Vespa returns 200 for missing docs, and the
    reference's tests pin deletedDocuments == receivedDocumentIds
    (test_delete_documents.py:234-245)."""
    if not document_ids:
        # validation.py:655 — empty ids is an InvalidDocumentIdError
        raise api_exceptions.InvalidDocumentIdError("doc_ids can't be empty!")
    if not isinstance(document_ids, (list, tuple)):
        raise api_exceptions.InvalidArgError(
            "documentIds param must be an array of strings.")
    max_delete = configs.read_env_vars_and_defaults_ints(
        "MARQO_MAX_DELETE_DOCS_COUNT")
    if max_delete is not None and len(document_ids) > max_delete:
        raise api_exceptions.InvalidArgError(
            f"The number of documentIds to delete `{len(document_ids)}` is "
            f"greater than the limit `{max_delete}` set by the env var "
            f"`MARQO_MAX_DELETE_DOCS_COUNT`. ")
    for doc_id in document_ids:
        if not isinstance(doc_id, str) or not doc_id:
            raise api_exceptions.InvalidDocumentIdError(
                f"Document _id must be a non-empty string! Received: {doc_id}")
    start = time.time()
    index = config.index_meta_cache.get_index(index_name)
    items = []
    for doc_id in document_ids:
        config.engine.delete(index.schema_name, doc_id)
        items.append({"_id": doc_id, "status": 200, "result": "deleted"})
    return {
        "index_name": index_name,
        "status": "succeeded",
        "type": "documentDeletion",
        "details": {
            "receivedDocumentIds": len(document_ids),
            "deletedDocuments": len(items),
        },
        "duration": f"PT{time.time() - start:.3f}S",
        "startedAt": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                   time.gmtime(start)),
        "finishedAt": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "items": items,
    }
