"""The HTTP application: full route table + exception mapping + startup.

Parity: reference src/marqo/tensor_search/api.py — ~30 routes (:228-515),
the ordered core→API exception mapping (:88-141), startup chain
(on_start_script.py:28-45), error envelope, feature-gated batch/upgrade/
debug routes.
"""

import os
from typing import Optional

from marqo_tpu_torch.api import configs
from marqo_tpu_torch.api import exceptions as api_exceptions
from marqo_tpu_torch.api.http_framework import App, Request, bind_body
from marqo_tpu_torch.api.models.index_settings import IndexSettings
from marqo_tpu_torch.api.models.requests import (AddDocsBodyParams,
                                           CustomVectorQuery, EmbedRequest,
                                           IndexSettingsWithName,
                                           RecommendQuery, SearchQuery,
                                           UpdateDocumentsBodyParams)
from marqo_tpu_torch.api.throttling import RequestType, throttle
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.core import exceptions as core_exceptions
from marqo_tpu_torch.core.models.add_docs_params import AddDocsParams
from marqo_tpu_torch.exceptions import InvalidArgumentError
from marqo_tpu_torch.inference import vectorise as inference
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.logging import get_logger
from marqo_tpu_torch.tensor_search import tensor_search
from marqo_tpu_torch.version import __version__

logger = get_logger(__name__)


def _feature_gate(env_var: str, name: str) -> None:
    # 403 with the reference's wording (utils.py:428-430)
    if not configs.read_env_vars_and_defaults_bool(env_var):
        raise api_exceptions.DisabledFeatureError(
            f"This API endpoint is disabled. Please set {env_var} to true "
            f"to enable it.")


def install_exception_mappers(app: App) -> None:
    """Ordered core→API error translation (reference api.py:88-141)."""
    mappers = [
        (core_exceptions.IndexExistsError,
         lambda e: api_exceptions.IndexAlreadyExistsError(e.message)),
        (core_exceptions.IndexNotFoundError,
         lambda e: api_exceptions.IndexNotFoundError(e.message)),
        (core_exceptions.InvalidFieldNameError,
         lambda e: api_exceptions.InvalidFieldNameError(e.message)),
        (core_exceptions.FilterStringParsingError,
         lambda e: api_exceptions.InvalidArgError(e.message)),
        (core_exceptions.ModelNotInCacheError,
         lambda e: api_exceptions.ModelNotInCacheError(e.message)),
        (core_exceptions.VectoriseError,
         lambda e: api_exceptions.VectoriseError(e.message)),
        # reference api.py:110 — generic model errors are 400 bad_request
        (core_exceptions.ModelError,
         lambda e: api_exceptions.BadRequestError(e.message)),
        (core_exceptions.UnsupportedFeatureError,
         lambda e: api_exceptions.BadRequestError(e.message)),
        # reference api.py:108 — zero-magnitude is a 400 bad_request
        (core_exceptions.ZeroMagnitudeVectorError,
         lambda e: api_exceptions.BadRequestError(e.message)),
        (core_exceptions.MarqoDocumentParsingError,
         lambda e: api_exceptions.InvalidArgError(e.message)),
        # reference api.py:105 — Vespa/engine payload parse failures are a
        # 500 backend_data_parsing envelope
        (core_exceptions.VespaDocumentParsingError,
         lambda e: api_exceptions.BackendDataParsingError(e.message)),
        (core_exceptions.InternalError,
         lambda e: api_exceptions.InternalError(e.message)),
        (core_exceptions.TooManyFieldsError,
         lambda e: api_exceptions.BadRequestError(e.message)),
        (core_exceptions.OperationConflictError,
         lambda e: api_exceptions.OperationConflictError(e.message)),
        (core_exceptions.BackendCommunicationError,
         lambda e: api_exceptions.BackendCommunicationError(e.message)),
        # engine timeouts surface as the reference's 504 vector_store_
        # timeout invalid_request envelope with its fixed message
        # (api.py:117-122)
        (core_exceptions.BackendTimeoutError,
         lambda e: api_exceptions.VectorStoreTimeoutError(
             "Vector store request timed out. Try your request again "
             "later.")),
        (core_exceptions.ApplicationRollbackError,
         lambda e: api_exceptions.InternalError(e.message)),
        (core_exceptions.DeviceError,
         lambda e: api_exceptions.InternalError(e.message)),
        # NB: ModelDownloadError / ModelLoadError are ModelError
        # subclasses, so the (ModelError -> BadRequestError 400) entry
        # above already covers them — exactly the reference's behavior
        # (api.py:110 maps core ModelError before anything more specific;
        # model-auth 403s surface as 400s, test_model_auth.py:705-751)
        (InvalidArgumentError,
         lambda e: api_exceptions.InvalidArgError(e.message)),
        (ValueError,
         lambda e: api_exceptions.InvalidArgError(str(e))),
    ]
    for exc_type, mapper in mappers:
        app.map_exception(exc_type, mapper)


def _validate_device(request: Request) -> Optional[str]:
    # reference web/api_validation.py:49 validate_device +
    # api_utils.translate_api_device: "?device=cuda2" -> "cuda:2"
    from marqo_tpu_torch.api.api_utils import translate_api_device
    return translate_api_device(request.query_param("device"))


def build_app(config: Config) -> App:
    app = App(title="marqo-tpu")
    install_exception_mappers(app)

    # --- root / health / info -------------------------------------------

    @app.get("/")
    def root(request: Request):
        return {"message": "Welcome to Marqo (TPU-native)",
                "version": __version__}

    @app.get("/health")
    def check_health(request: Request):
        return config.monitoring.get_health()

    @app.get("/healthz")
    def check_healthz(request: Request):
        return config.monitoring.get_health()

    @app.get("/indexes/{index_name}/health")
    def check_index_health(request: Request):
        return config.monitoring.get_health(
            index_name=request.path_params["index_name"])

    @app.get("/memory")
    def memory(request: Request):
        _feature_gate("MARQO_ENABLE_DEBUG_API", "debug")
        # reference memory_profiler.get_memory_profile: the body is exactly
        # {"memory_used": <process MB>, "stats": [tracemalloc lines]}
        # (core/monitoring/memory_profiler.py:8-20)
        import tracemalloc
        if not tracemalloc.is_tracing():
            tracemalloc.start()
        snapshot = tracemalloc.take_snapshot()
        stats = [str(s) for s in snapshot.statistics("lineno")[:20]]
        mem_used_mb = 0.0
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        mem_used_mb = int(line.split()[1]) / 1024.0
                        break
        except OSError:
            import resource
            mem_used_mb = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0
        return {"memory_used": mem_used_mb, "stats": stats}

    # --- index DDL --------------------------------------------------------

    @app.post("/indexes/{index_name}")
    def create_index(request: Request):
        index_name = request.path_params["index_name"]
        settings = bind_body(request, IndexSettings) if request.body else \
            IndexSettings()
        index = settings.to_marqo_index(index_name)
        config.index_management.create_index(index)
        config.index_meta_cache.refresh_index(index_name)
        return {"acknowledged": True, "index": index_name}

    @app.delete("/indexes/{index_name}")
    def delete_index(request: Request):
        index_name = request.path_params["index_name"]
        config.index_management.delete_index_by_name(index_name)
        config.index_meta_cache.remove_index(index_name)
        return {"acknowledged": True}

    @app.get("/indexes")
    def get_indexes(request: Request):
        return {"results": [
            {"indexName": i.name}
            for i in config.index_management.get_all_indexes()]}

    @app.get("/indexes/{index_name}/settings")
    def get_settings(request: Request):
        index = config.index_management.get_index(
            request.path_params["index_name"])
        return IndexSettings.from_marqo_index(index)

    @app.get("/indexes/{index_name}/settings/history")
    def get_settings_history(request: Request):
        """Settings version history (reference Vespa IndexSettings Java
        component serves history at /index-settings/*)."""
        name = request.path_params["index_name"]
        config.index_management.get_index(name)  # 404 when missing
        return {"history": config.settings_store.get_history(name)}

    @app.post("/validate/index/{index_name}")
    def schema_validation(request: Request):
        # gated behind MARQO_ENABLE_OPS_API, 403 by default (reference
        # api.py:240-243 @utils.enable_ops_api)
        _feature_gate("MARQO_ENABLE_OPS_API", "ops")
        index_name = request.path_params["index_name"]
        if not isinstance(request.body, dict):
            # missing or non-object bodies are a 400, not a 500/false-OK
            raise api_exceptions.InvalidArgError(
                "Request body must be a JSON object of index settings")
        from marqo_tpu_torch.core.index_management.index_management import \
            IndexManagement
        IndexManagement.validate_index_settings(
            index_name, request.body)  # raises on invalid
        return {"validated": True, "index": index_name}

    # --- search / recommend / embed --------------------------------------

    @app.post("/indexes/{index_name}/search")
    @throttle(RequestType.SEARCH)
    def search(request: Request):
        index_name = request.path_params["index_name"]
        query = bind_body(request, SearchQuery)
        device = _validate_device(request)
        if query.boost is not None:
            # parity with the reference's exact status codes: non-TENSOR
            # methods reject any boost at validation (400,
            # validation.py:202-206); the TENSOR path raises its generic
            # not-supported error (500, tensor_search.py:2211)
            if str(query.searchMethod).upper() != "TENSOR":
                raise api_exceptions.InvalidArgError(
                    'Boosting is only supported for search_method="TENSOR".'
                    f" Received search_method={query.searchMethod}")
            raise api_exceptions.MarqoWebError(
                "Boosting is not currently supported")
        text = query.q
        context = (query.context.model_dump() if query.context else None)
        if isinstance(text, CustomVectorQuery):
            # tensor_search.search handles the vector/content split
            # (vector → tensor leg, content → lexical leg)
            text = {"customVector": text.customVector.model_dump()}
        return tensor_search.search(
            config, index_name, text=text,
            search_method=query.searchMethod,
            limit=query.limit, offset=query.offset,
            ef_search=query.efSearch, approximate=query.approximate,
            searchable_attributes=query.searchableAttributes,
            filter=query.filter,
            attributes_to_retrieve=query.attributesToRetrieve,
            device=device,
            score_modifiers=(query.scoreModifiers.model_dump()
                             if query.scoreModifiers else None),
            context=context,
            show_highlights=query.showHighlights,
            text_query_prefix=query.textQueryPrefix,
            hybrid_parameters=(query.hybridParameters.model_dump()
                               if query.hybridParameters else None),
            model_auth=(query.modelAuth.model_dump()
                        if query.modelAuth else None),
            expose_facets=query.exposeFacets,
            reranker=query.reRanker,
            media_download_headers=(query.mediaDownloadHeaders
                                    or query.image_download_headers))

    @app.post("/indexes/{index_name}/recommend")
    @throttle(RequestType.SEARCH)
    def recommend(request: Request):
        index_name = request.path_params["index_name"]
        query = bind_body(request, RecommendQuery)
        return config.recommender.recommend(
            index_name=index_name, documents=query.documents,
            tensor_fields=query.tensorFields,
            interpolation_method=query.interpolationMethod,
            exclude_input_documents=query.excludeInputDocuments,
            limit=query.limit, offset=query.offset,
            ef_search=query.efSearch, approximate=query.approximate,
            searchable_attributes=query.searchableAttributes,
            filter=query.filter,
            attributes_to_retrieve=query.attributesToRetrieve,
            score_modifiers=(query.scoreModifiers.model_dump()
                             if query.scoreModifiers else None),
            show_highlights=query.showHighlights)

    @app.post("/indexes/{index_name}/embed")
    @throttle(RequestType.SEARCH)
    def embed(request: Request):
        index_name = request.path_params["index_name"]
        body = bind_body(request, EmbedRequest)
        device = _validate_device(request)
        return config.embed.embed_content(
            index_name=index_name, content=body.content,
            content_type=body.content_type, device=device,
            model_auth=(body.modelAuth.model_dump()
                        if body.modelAuth else None),
            media_download_headers=(body.mediaDownloadHeaders
                                    or body.image_download_headers))

    # --- documents --------------------------------------------------------

    @app.post("/indexes/{index_name}/documents")
    @throttle(RequestType.INDEX)
    def add_or_replace_documents(request: Request):
        index_name = request.path_params["index_name"]
        body = bind_body(request, AddDocsBodyParams)
        device = _validate_device(request)
        params = AddDocsParams(
            index_name=index_name, docs=body.documents,
            tensor_fields=body.tensorFields,
            use_existing_tensors=body.useExistingTensors,
            device=device, mappings=body.mappings,
            text_chunk_prefix=body.textChunkPrefix,
            model_auth=(body.modelAuth.model_dump()
                        if body.modelAuth else None),
            media_download_headers=(body.mediaDownloadHeaders
                                    or body.imageDownloadHeaders),
            image_download_thread_count=body.imageDownloadThreadCount,
            media_download_thread_count=body.mediaDownloadThreadCount,
            batch_vectorisation_mode=body.batchVectorisationMode)
        return tensor_search.add_documents(config, params)

    @app.patch("/indexes/{index_name}/documents")
    @throttle(RequestType.PARTIAL_UPDATE)
    def update_documents(request: Request):
        index_name = request.path_params["index_name"]
        body = bind_body(request, UpdateDocumentsBodyParams)
        return config.document.partial_update_documents_by_index_name(
            index_name, body.documents)

    @app.get("/indexes/{index_name}/documents/{document_id}")
    def get_document_by_id(request: Request):
        return tensor_search.get_document_by_id(
            config, request.path_params["index_name"],
            request.path_params["document_id"],
            show_vectors=request.query_flag("expose_facets"))

    @app.get("/indexes/{index_name}/documents")
    def get_documents_by_ids(request: Request):
        if not isinstance(request.body, list):
            raise api_exceptions.InvalidArgError(
                "Expected a JSON list of document IDs in the request body")
        return tensor_search.get_documents_by_ids(
            config, request.path_params["index_name"], request.body,
            show_vectors=request.query_flag("expose_facets"))

    @app.post("/indexes/{index_name}/documents/delete-batch")
    def delete_docs(request: Request):
        # NOT throttled: the reference decorates only SEARCH/INDEX/
        # PARTIAL_UPDATE endpoints (api.py:266-344); RequestType.DELETE
        # exists upstream but no throttle uses it
        if not isinstance(request.body, list):
            raise api_exceptions.InvalidArgError(
                "Expected a JSON list of document IDs in the request body")
        return tensor_search.delete_documents(
            config, request.path_params["index_name"], request.body)

    @app.delete("/indexes/{index_name}/documents/delete-all")
    def delete_all_documents(request: Request):
        _feature_gate("MARQO_ENABLE_BATCH_APIS", "batch")
        count = config.document.delete_all_docs_by_index_name(
            request.path_params["index_name"])
        return {"documentCount": count}

    # --- stats / models / devices ----------------------------------------

    @app.get("/indexes/{index_name}/stats")
    def get_index_stats(request: Request):
        return config.monitoring.get_index_stats(
            request.path_params["index_name"])

    @app.get("/models")
    def get_loaded_models(request: Request):
        return inference.get_loaded_models()

    @app.delete("/models")
    def eject_model(request: Request):
        model_name = request.query_param("model_name")
        model_device = request.query_param("model_device")
        if not model_name or not model_device:
            raise api_exceptions.InvalidArgError(
                "Query parameters model_name and model_device are required")
        return inference.eject_model(model_name, model_device)

    @app.get("/device/cpu")
    def get_cpu_info(request: Request):
        return config.monitoring.get_cpu_info()

    @app.get("/device/cuda")
    def get_cuda_info(request: Request):
        return config.monitoring.get_accelerator_info()

    # --- batch / ops APIs (feature-gated) ---------------------------------

    @app.post("/batch/indexes/delete")
    def batch_delete_indexes(request: Request):
        _feature_gate("MARQO_ENABLE_BATCH_APIS", "batch")
        if not isinstance(request.body, list):
            raise api_exceptions.InvalidArgError(
                "Expected a JSON list of index names")
        config.index_management.batch_delete_indexes_by_name(request.body)
        for name in request.body:
            config.index_meta_cache.remove_index(name)
        return {"acknowledged": True}

    @app.post("/batch/indexes/create")
    def batch_create_indexes(request: Request):
        _feature_gate("MARQO_ENABLE_BATCH_APIS", "batch")
        if not isinstance(request.body, list):
            raise api_exceptions.InvalidArgError(
                "Expected a JSON list of index settings with names")
        indexes = []
        for raw in request.body:
            item = IndexSettingsWithName(**raw)
            settings_dict = {k: v for k, v in raw.items() if k != "indexName"}
            indexes.append(
                IndexSettings(**settings_dict).to_marqo_index(item.indexName))
        config.index_management.batch_create_indexes(indexes)
        for index in indexes:
            config.index_meta_cache.refresh_index(index.name)
        return {"acknowledged": True}

    @app.post("/rollback")
    def rollback(request: Request):
        _feature_gate("MARQO_ENABLE_UPGRADE_API", "rollback")
        body = request.body or {}
        index_name = body.get("indexName")
        if not index_name:
            raise api_exceptions.InvalidArgError(
                "rollback requires an indexName")
        index = config.index_management.rollback_index(index_name)
        config.index_meta_cache.refresh_index(index_name)
        return {"acknowledged": True, "index": index.name,
                "version": index.version}

    @app.post("/upgrade")
    def upgrade(request: Request):
        """Run pending settings migrations (reference api.py:493-497 runs
        UpgradeRunner over the Vespa app; ours runs it over the settings
        store, core/upgrades.py)."""
        _feature_gate("MARQO_ENABLE_UPGRADE_API", "upgrade")
        from marqo_tpu_torch.core.upgrades import UpgradeRunner
        result = UpgradeRunner(config.index_management).upgrade()
        if result["migrated"] == 0 and result["from"] == result["to"]:
            message = "No migrations pending"
        else:
            message = (f"Upgraded {result['from']} -> {result['to']} "
                       f"({result['migrated']} indexes migrated)")
        return {"acknowledged": True, "message": message,
                "version": __version__, **result}

    @app.post("/rollback-vespa")
    def rollback_application(request: Request):
        """Restore the pre-upgrade application backup (reference
        api.py:509-515 rollback_vespa; route name kept for drop-in
        client parity)."""
        version = config.index_management.rollback_application()
        config.index_meta_cache.populate()
        return {"version": version}

    @app.post("/ops/heal")
    def heal_replicas(request: Request):
        """Replica anti-entropy for cluster deployments (engine/cluster.py
        heal): re-sync replicas that missed writes. Gated like the other
        ops APIs; no-op message on non-cluster engines (Vespa performs the
        equivalent redistribution internally)."""
        _feature_gate("MARQO_ENABLE_UPGRADE_API", "heal")
        from marqo_tpu_torch.engine.cluster import ClusterEngine
        if not isinstance(config.engine, ClusterEngine):
            return {"acknowledged": True,
                    "message": "Engine is not a cluster; nothing to heal"}
        body = request.body or {}
        if body.get("index"):
            return {"acknowledged": True,
                    "report": {body["index"]:
                               config.engine.heal(str(body["index"]))}}
        return {"acknowledged": True, "report": config.engine.heal_all()}

    return app


def generate_config() -> Config:
    return Config()


def on_start(config: Config) -> None:
    """Startup bootstrap chain (reference on_start_script.py:28-45)."""
    # 0. the device to serve on, before anything starts: a
    #    MARQO_BEST_AVAILABLE_DEVICE already set is kept; otherwise it is
    #    CUDA, and startup fails without a CUDA device (no silent CPU
    #    fallback; set MARQO_BEST_AVAILABLE_DEVICE=cpu to serve on the CPU)
    best = configs.read_env_vars_and_defaults("MARQO_BEST_AVAILABLE_DEVICE")
    if not best:
        best = Device.best_available().value
        os.environ["MARQO_BEST_AVAILABLE_DEVICE"] = best
    logger.info(f"Best available device: {best}")
    # 1. restore persisted engine documents BEFORE bootstrap — bootstrap
    #    re-creates any missing engine indexes from settings, and restore
    #    skips indexes that already exist (role of Vespa's durable store)
    data_dir = configs.read_env_vars_and_defaults("MARQO_ENGINE_DATA_DIR")
    from marqo_tpu_torch.engine.store import StoreEngine
    if data_dir and isinstance(config.engine, StoreEngine):
        # restore snapshots, replay + attach the WAL, start the snapshot
        # daemon (shared with the standalone engine server)
        from marqo_tpu_torch.engine.wal import setup_engine_durability
        setup_engine_durability(config.engine, str(data_dir))
    # 2. bootstrap settings store + any engine indexes without snapshots
    config.index_management.bootstrap()
    # 3. populate + start the index-cache refresh daemon
    config.index_meta_cache.populate()
    config.index_meta_cache.start_refresh_thread()
    # 4. model + patch-model pre-warming (reference CacheModels /
    #    CachePatchModels, on_start_script.py:122-230)
    from marqo_tpu_torch.api.on_start_script import CacheModels, CachePatchModels
    CacheModels().run()
    CachePatchModels().run()
    logger.info("Marqo-TPU startup complete")


def main(host: str = "0.0.0.0", port: int = 8882,
         background: bool = False, preload_models: bool = True,
         workers: int = 1):
    """Serve the API. ``workers > 1`` (or MARQO_API_WORKERS) forks N
    processes sharing the port via SO_REUSEPORT — lifts the single-process
    GIL bound on host-side work (tokenization, chunking, engine HTTP).
    Multi-worker REQUIRES shared state: an external/cluster engine (each
    worker cannot hold its own in-process document store) and a
    cross-process coordination backend for DDL/throttling."""
    from marqo_tpu_torch.api.http_framework import serve
    workers = max(workers, int(
        configs.read_env_vars_and_defaults("MARQO_API_WORKERS") or 1))
    if workers > 1:
        if not (configs.read_env_vars_and_defaults("MARQO_ENGINE_QUERY_URL")
                or configs.read_env_vars_and_defaults("MARQO_ENGINE_CLUSTER")):
            raise api_exceptions.StartupSanitationError(
                "MARQO_API_WORKERS > 1 requires an external engine "
                "(MARQO_ENGINE_QUERY_URL or MARQO_ENGINE_CLUSTER): "
                "in-process stores cannot be shared across workers")
        if (configs.read_env_vars_and_defaults("MARQO_COORDINATION_BACKEND")
                or "in_process") == "in_process":
            logger.warning(
                "MARQO_API_WORKERS > 1 with in-process coordination: DDL "
                "mutual exclusion and throttle caps will NOT span workers. "
                "Set MARQO_COORDINATION_BACKEND=file (one host) or =engine.")
        import multiprocessing

        def _worker(worker_index: int):
            worker_config = generate_config()
            on_start(worker_config)
            worker_app = build_app(worker_config)
            logger.info(f"API worker {worker_index} serving on "
                        f"{host}:{port}")
            serve(worker_app, host=host, port=port, reuse_port=True)

        # daemon=True: workers die with the coordinator — a terminated
        # parent must never leave orphan workers holding the port (they
        # would keep serving stale state)
        processes = [multiprocessing.Process(target=_worker, args=(i,),
                                             daemon=True)
                     for i in range(1, workers)]
        for process in processes:
            process.start()

        import signal as _signal

        def _shutdown(signum, frame):
            for process in processes:
                process.terminate()
            raise SystemExit(0)

        _signal.signal(_signal.SIGTERM, _shutdown)
        try:
            _worker(0)
        finally:
            for process in processes:
                process.terminate()
        return None
    config = generate_config()
    if not preload_models:
        os.environ["MARQO_MODELS_TO_PRELOAD"] = "[]"
    on_start(config)
    app = build_app(config)
    return serve(app, host=host, port=port, background=background)


if __name__ == "__main__":
    main()
