"""Environment-variable configuration registry.

Parity: reference src/marqo/api/configs.py:10-59 (defaults table) and
src/marqo/tensor_search/enums.py:39-86 (EnvVars registry) and
src/marqo/tensor_search/utils.py:148-196 (typed readers).

One mechanism: ``default_env_vars()`` is the single source of truth for
names + defaults; ``read_env_vars_and_defaults*`` give typed access.
"""

import json
import os
from typing import Any, Dict, Optional


def default_env_vars() -> Dict[str, Any]:
    return {
        # --- request limits ---
        # legacy v1 knob, not enforced (matches the reference: listed in
        # api/configs.py:21 with no v2 reader; superseded by the per-kind
        # MARQO_MAX_{TENSOR,LEXICAL}_FIELD_COUNT_UNSTRUCTURED caps)
        "MARQO_MAX_INDEX_FIELDS": None,
        "MARQO_MAX_DOC_BYTES": 100_000,
        "MARQO_MAX_RETRIEVABLE_DOCS": 10_000,
        "MARQO_MAX_SEARCHABLE_TENSOR_ATTRIBUTES": None,
        "MARQO_MAX_DELETE_DOCS_COUNT": 10_000,
        "MARQO_MAX_NUMBER_OF_REPLICAS": 1,
        "MARQO_MAX_ADD_DOCS_COUNT": 128,
        # reference api/configs.py:52-53 — semi-structured dynamic-field caps
        "MARQO_MAX_TENSOR_FIELD_COUNT_UNSTRUCTURED": 100,
        "MARQO_MAX_LEXICAL_FIELD_COUNT_UNSTRUCTURED": 100,
        # --- concurrency / throttling (reference configs.py:28-30,49) ---
        "MARQO_ENABLE_THROTTLING": "TRUE",
        "MARQO_MAX_CONCURRENT_INDEX": 8,
        "MARQO_MAX_CONCURRENT_SEARCH": 8,
        "MARQO_MAX_CONCURRENT_PARTIAL_UPDATE": 100,
        "MARQO_THREAD_EXPIRY_TIME": 1800,
        # --- inference ---
        "MARQO_MODELS_TO_PRELOAD": ["hf/e5-base-v2"],
        "MARQO_PATCH_MODELS_TO_PRELOAD": [],
        "MARQO_MAX_VECTORISE_BATCH_SIZE": 16,
        "MARQO_MAX_CPU_MODEL_MEMORY": 4,
        "MARQO_MAX_TPU_MODEL_MEMORY": 12,  # HBM GiB budget for live params
        "MARQO_MAX_CUDA_MODEL_MEMORY": 4,  # name kept for API parity
        "MARQO_INFERENCE_CACHE_SIZE": 0,
        "MARQO_INFERENCE_CACHE_TYPE": "LRU",
        "MARQO_BEST_AVAILABLE_DEVICE": None,  # set at startup: "tpu" or "cpu"
        # --- search ---
        "MARQO_DEFAULT_EF_SEARCH": 2000,
        "MARQO_DEFAULT_APPROXIMATE_SEARCH": "TRUE",
        "MARQO_MAX_SEARCH_LIMIT": 1000,
        "MARQO_MAX_SEARCH_OFFSET": 10_000,
        "MARQO_EF_CONSTRUCTION_MAX_VALUE": 4096,
        "MARQO_SEARCH_TIMEOUT_MS": 1000,
        # --- media download ---
        "MARQO_IMAGE_DOWNLOAD_THREAD_COUNT_PER_REQUEST": 20,
        "MARQO_MEDIA_DOWNLOAD_THREAD_COUNT_PER_REQUEST": 5,
        "MARQO_MAX_BACKEND_ADD_DOCS_COUNT": 128,
        # --- engine (our C++ store; ports mirror reference Vespa roles) ---
        "MARQO_ENGINE_DATA_DIR": None,  # None => in-process, no persistence
        "MARQO_ENGINE_QUERY_URL": None,  # None => in-process engine
        "MARQO_ENGINE_CLUSTER": None,  # JSON [[shard0 replicas...],...]
        "MARQO_ENGINE_SHARDS": 1,
        "MARQO_ENGINE_REPLICAS": 0,
        # --- detector patch models (inference/image_patching.py) ---
        "MARQO_PATCH_MODELS_RANDOM_INIT": "FALSE",  # synthetic-weight mode
        "MARQO_DINO_WEIGHTS_PATH": None,  # local dino_vits16 state dict
        "MARQO_FRCNN_WIDTH": 1.0,  # resnet-50 width multiplier (tests shrink it)
        # --- cross-replica coordination (role of reference ZK + Redis) ---
        "MARQO_COORDINATION_BACKEND": "in_process",  # in_process|file|engine
        "MARQO_COORDINATION_DIR": None,   # file backend; default derives
        "MARQO_COORDINATION_URL": None,   # engine backend: engine server URL
        "MARQO_API_WORKERS": 1,  # >1 forks SO_REUSEPORT workers (needs
        #     an external engine + non-in_process coordination backend)
        # --- ops / feature gates (reference utils.py feature decorators) ---
        "MARQO_ENABLE_BATCH_APIS": "FALSE",
        "MARQO_ENABLE_DEBUG_API": "FALSE",
        "MARQO_ENABLE_UPGRADE_API": "FALSE",
        "MARQO_LOG_LEVEL": "info",
        # --- TPU runtime ---
        "MARQO_TPU_MESH_SHAPE": None,  # e.g. "4,2" => (dp, tp); None = all-dp
        "MARQO_TPU_COMPILE_BUCKETS": [16, 32, 64, 128, 256, 512],
        "MARQO_TPU_BATCH_BUCKETS": [1, 8, 16, 32, 64, 128, 256],
        "MARQO_TPU_ROW_BUCKETS": [16, 32, 48, 64, 96, 128, 160, 192,
                                  256, 320, 384, 512],
        "MARQO_HNSW_BUILD_THREADS": 0,  # 0 = all cores (parallel graph build)
        "MARQO_ENGINE_WAL": "TRUE",       # write-ahead log when data dir set
        "MARQO_ENGINE_WAL_FSYNC": "FALSE",  # fsync each record (durability
                                            # vs feed latency trade)
        # feed-block watermarks (role of Vespa cluster-controller resource
        # limits: feeds above these utilization fractions are refused with
        # 507, reference services.xml resource-limits + the 507 row of the
        # vespa_client.py:579-607 translate matrix)
        "MARQO_ENGINE_MEMORY_WATERMARK": 0.95,
        "MARQO_ENGINE_DISK_WATERMARK": 0.95,
        # cluster anti-entropy: >0 = failover-triggered repair + a full
        # digest sweep every N seconds; 0 (default) = failover-triggered
        # repair only; <0 = fully disabled (manual /ops/heal still works)
        "MARQO_CLUSTER_HEAL_INTERVAL": 0,
        # default vector cell storage for indexes created WITHOUT an
        # explicit vectorNumericType: float32 | bfloat16 (Vespa tensor
        # cell-type option; bfloat16 halves vector memory). Read by
        # api/models/index_settings.py at create time; an explicit
        # vectorNumericType in the settings document always wins.
        "MARQO_ENGINE_CELL_TYPE": "float32",
        "MARQO_TPU_DEFAULT_DTYPE": "bfloat16",
        "MARQO_TELEMETRY_ENABLED": "TRUE",
        "MARQO_DYNAMIC_BATCHING": "FALSE",  # coalesce concurrent embeds
    }


_DEFAULTS = default_env_vars()


def read_env_vars_and_defaults(var: str) -> Optional[Any]:
    """Read ``var`` from the environment, falling back to the defaults table.
    An env var explicitly set to the empty string reads as None — NOT the
    default — matching reference utils.read_env_vars_and_defaults:148-160
    (e.g. MARQO_MAX_RETRIEVABLE_DOCS='' disables the limit)."""
    if var in os.environ:
        value = os.environ[var]
        if isinstance(value, str) and len(value) == 0:
            return None
        return value
    return _DEFAULTS.get(var)


def read_env_vars_and_defaults_ints(var: str) -> Optional[int]:
    value = read_env_vars_and_defaults(var)
    if value is None:
        return None
    try:
        return int(value)
    except (ValueError, TypeError):
        from marqo_tpu_torch.exceptions import InvalidArgumentError
        raise InvalidArgumentError(
            f"Environment variable `{var}` must be an int, got `{value}`")


def read_env_vars_and_defaults_floats(var: str) -> Optional[float]:
    value = read_env_vars_and_defaults(var)
    if value is None:
        return None
    try:
        return float(value)
    except (ValueError, TypeError):
        from marqo_tpu_torch.exceptions import InvalidArgumentError
        raise InvalidArgumentError(
            f"Environment variable `{var}` must be a float, got `{value}`")


def read_env_vars_and_defaults_bool(var: str) -> bool:
    value = read_env_vars_and_defaults(var)
    if isinstance(value, bool):
        return value
    return str(value).strip().upper() == "TRUE"


def read_env_vars_and_defaults_list(var: str) -> list:
    value = read_env_vars_and_defaults(var)
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    value = str(value).strip()
    if value.startswith("["):
        return json.loads(value)
    return [v.strip() for v in value.split(",") if v.strip()]
