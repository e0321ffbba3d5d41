"""The inference engine's public API: ``vectorise()`` and the live-model cache.

Parity: reference src/marqo/s2_inference/s2_inference.py —
  vectorise() (:48), model cache `_available_models` keyed `name||device`
  (:260-283), thread-locked load with busy rejection (:293-298),
  memory-threshold eviction (:463-500), eject_model (:774),
  get_loaded_models (:161). Where the reference converts the output to
  List[List[float]] (:705-749), vectorise answers the same values as one
  float32 array, and the cache stores float32 rows.

TPU specifics: the "memory threshold" budgets HBM for live param pytrees;
encoding runs through bucketed static shapes (loaders.py) so the steady
state never recompiles.
"""

import datetime
import threading
from typing import Any, Dict, List, Optional, Union

import numpy as np

from marqo_tpu_torch.api import configs, telemetry
from marqo_tpu_torch.core.exceptions import (InvalidArgumentError,
                                       ModelNotInCacheError, VectoriseError)
from marqo_tpu_torch.inference.inference_cache import MarqoInferenceCache
from marqo_tpu_torch.inference.loaders import EmbeddingModel, load_model
from marqo_tpu_torch.inference.model_registry import (
    get_model_properties_from_registry, load_model_properties)
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.logging import get_logger

logger = get_logger(__name__)

# model_cache_key -> {"model": EmbeddingModel, "most_recently_used_time": dt,
#                     "model_size": GiB}
_available_models: Dict[str, dict] = {}
MODEL_PROPERTIES = load_model_properties()
_lock = threading.Lock()

_inference_cache: Optional[MarqoInferenceCache] = None
_inference_cache_lock = threading.Lock()


def _get_inference_cache() -> MarqoInferenceCache:
    global _inference_cache
    if _inference_cache is None:
        with _inference_cache_lock:
            if _inference_cache is None:
                _inference_cache = MarqoInferenceCache()
    return _inference_cache


def _create_model_cache_key(model_name: str, device: str,
                            model_properties: Optional[dict] = None) -> str:
    """Cache key (reference s2_inference.py:260 _create_model_cache_key)."""
    if model_properties is None:
        model_properties = {}
    return (model_name + "||" +
            str(model_properties.get("name", "")) + "||" +
            str(model_properties.get("dimensions", "")) + "||" +
            str(model_properties.get("type", "")) + "||" +
            str(model_properties.get("tokens", "")) + "||" +
            str(device))


def _resolve_properties(model_name: str,
                        model_properties: Optional[dict]) -> dict:
    if model_properties is not None and len(model_properties) > 0:
        props = dict(model_properties)
        props.setdefault("name", model_name)
        return props
    return get_model_properties_from_registry(model_name)


def _model_size_gib(model: EmbeddingModel, properties: dict) -> float:
    if "model_size" in properties:
        return float(properties["model_size"])
    return model.memory_bytes() / (1024 ** 3)


# Pre-load size estimates (reference s2_inference/constants.py:6-25):
# explicit model_size property -> name substring -> type -> default.
# Post-load, the cache entry is refined to the true param-pytree bytes
# (_model_size_gib) — more accurate HBM budgeting than the reference's
# static tables, which it keeps for the entry too.
MODEL_NAME_SIZE_MAPPING = {
    "vit-l-14": 1.5,
    "vit-g": 5,
    "vit-h": 5,
    "vit-bigg-14": 6,
}
MODEL_TYPE_SIZE_MAPPING = {
    "open_clip": 1,
    "clip": 1,
    "sbert": 0.7,
    "random": 0.1,
    "multilingual_clip": 5,
    "clip_onnx": 1,
    "sbert_onnx": 0.7,
    "hf": 1,
}
DEFAULT_MODEL_SIZE = 0.66


def get_model_size(model_name: str, model_properties: dict) -> float:
    """Pre-load size estimate in GiB (reference s2_inference.py:503-518:
    priority size_in_properties -> model_name -> model_type -> default)."""
    if "model_size" in model_properties:
        return model_properties["model_size"]
    name_info = (model_name +
                 model_properties.get("name", "")).lower().replace("/", "-")
    for name, size in MODEL_NAME_SIZE_MAPPING.items():
        if name in name_info:
            return size
    model_type = model_properties.get("type", None)
    return MODEL_TYPE_SIZE_MAPPING.get(model_type, DEFAULT_MODEL_SIZE)


def validate_model_properties(model_name: str,
                              model_properties: Optional[dict]) -> dict:
    """Resolve + validate properties for a model name (reference
    s2_inference.py:340-397 validate_model_properties: explicit properties
    win, else the registry row)."""
    return _resolve_properties(model_name, model_properties)


def _used_memory_gib(device: Device) -> float:
    return sum(entry["model_size"] for entry in _available_models.values()
               if entry["model"].device == device)


def _device_threshold_gib(device: Device) -> float:
    var = ("MARQO_MAX_CPU_MODEL_MEMORY" if device == Device.CPU
           else "MARQO_MAX_TPU_MODEL_MEMORY")
    value = configs.read_env_vars_and_defaults_floats(var)
    # explicit `is None` check: `or` would silently rewrite an explicit 0
    # (force-reject caching) to the fallback, and mask the defaults-table
    # value whenever the var is set to an empty string
    return 4.0 if value is None else float(value)


def _check_memory_threshold_for_model(device: Device, model_size: float,
                                      calling_func: str = None) -> bool:
    """True iff `model_size` GiB fits the device threshold alongside the
    models currently cached on it; raises ModelCacheManagementError when
    the model alone exceeds the threshold (reference s2_inference.py:
    463-500, including the calling_func thread-safety guard)."""
    if calling_func not in ("unit_test", "_validate_model_into_device"):
        raise RuntimeError(
            "The function `_check_memory_threshold_for_model` should only "
            "be called by `unit_test` or `_validate_model_into_device` for "
            "threading safeness.")
    from marqo_tpu_torch.api.exceptions import ModelCacheManagementError
    threshold = _device_threshold_gib(device)
    if model_size > threshold:
        raise ModelCacheManagementError(
            f"You are trying to load a model with size = `{model_size}` "
            f"into device = `{device.value}`, which is larger than the "
            f"device threshold = `{threshold}`. Marqo CANNOT find enough "
            f"space for the model. Please change the threshold by adjusting "
            f"the environment variables `MARQO_MAX_CPU_MODEL_MEMORY` or "
            f"`MARQO_MAX_TPU_MODEL_MEMORY`.")
    return (_used_memory_gib(device) + model_size) < threshold


def _validate_model_into_device(model_name: str, model_properties: dict,
                                device: Device,
                                calling_func: str = None) -> bool:
    """LRU-evict models on `device` until the estimated model size fits;
    raises ModelCacheManagementError when even an empty device can't hold
    it (reference s2_inference.py:421-461, with its calling_func guard)."""
    if calling_func not in ("unit_test", "_update_available_models"):
        raise RuntimeError(
            "This function should only be called by "
            "`update_available_models` or `unit_test` for thread safeness.")
    from marqo_tpu_torch.api.exceptions import ModelCacheManagementError
    model_size = get_model_size(model_name, model_properties)
    if _check_memory_threshold_for_model(
            device, model_size, calling_func="_validate_model_into_device"):
        return True
    candidates = [(k, v) for k, v in _available_models.items()
                  if v["model"].device == device]
    for key, _ in sorted(candidates,
                         key=lambda kv: kv[1]["most_recently_used_time"]):
        logger.info(
            f"Eject model = `{key.split('||')[0]}` from device = "
            f"`{device.value}` to save space for model = `{model_name}`.")
        del _available_models[key]
        _drop_scheduler(key)
        if _check_memory_threshold_for_model(
                device, model_size,
                calling_func="_validate_model_into_device"):
            return True
    raise ModelCacheManagementError(
        f"Marqo CANNOT find enough space to load model = `{model_name}` in "
        f"device = `{device.value}`. Marqo tried to eject all the models on "
        f"this device = `{device.value}` but still can't find enough space. "
        f"Please use a smaller model or increase the memory threshold.")


def _evict_lru_until_fits(device: Device, incoming_gib: float) -> None:
    """LRU-evict models on `device` until `incoming_gib` fits the threshold.
    Post-load refinement path: called with the true param-pytree size after
    a load, since real bytes can exceed the pre-load estimate."""
    threshold = _device_threshold_gib(device)
    if incoming_gib > threshold:
        from marqo_tpu_torch.api.exceptions import ModelCacheManagementError
        raise ModelCacheManagementError(
            f"You are trying to load a model with size = `{incoming_gib:.2f}` "
            f"into device = `{device.value}`, which is larger than the "
            f"device threshold = `{threshold}`. Marqo CANNOT find enough "
            f"space for the model. Please change the threshold by adjusting "
            f"the environment variables `MARQO_MAX_CPU_MODEL_MEMORY` or "
            f"`MARQO_MAX_TPU_MODEL_MEMORY`.")
    while _used_memory_gib(device) + incoming_gib > threshold:
        candidates = [(k, v) for k, v in _available_models.items()
                      if v["model"].device == device]
        if not candidates:
            break
        key, _ = min(candidates, key=lambda kv: kv[1]["most_recently_used_time"])
        logger.info(f"Evicting model `{key}` from {device.value} cache to free memory")
        del _available_models[key]
        _drop_scheduler(key)


def _update_available_models(model_cache_key: str, model_name: str,
                             properties: dict, device: Device,
                             model_auth=None) -> EmbeddingModel:
    """Thread-locked model load with busy rejection + LRU eviction
    (reference _update_available_models, s2_inference.py:286-337)."""
    # atomic read: a concurrent eviction between a separate membership
    # check and item access would KeyError a call that should simply
    # have reloaded the model
    entry = _available_models.get(model_cache_key)
    if entry is not None:
        entry["most_recently_used_time"] = datetime.datetime.now()
        return entry["model"]

    acquired = _lock.acquire(blocking=False)
    if not acquired:
        from marqo_tpu_torch.api.exceptions import ModelCacheManagementError
        # reference s2_inference.py:293-298: a racing loader is rejected
        # with ModelCacheManagementError (409), never queued
        raise ModelCacheManagementError(
            "Request rejected, as this request attempted to update the "
            "model cache, while another request was updating the model "
            "cache at the same time. Please wait for 10 seconds and send "
            "the request again ")
    try:
        if model_cache_key in _available_models:  # lost the race, already loaded
            entry = _available_models[model_cache_key]
            entry["most_recently_used_time"] = datetime.datetime.now()
            return entry["model"]
        _validate_model_into_device(model_name, properties, device,
                                    calling_func="_update_available_models")
        logger.info(f"Loading model `{model_name}` on {device.value}")
        model = load_model(model_name, properties, device, model_auth)
        size = _model_size_gib(model, properties)
        _evict_lru_until_fits(device, size)
        _available_models[model_cache_key] = {
            "model": model,
            "most_recently_used_time": datetime.datetime.now(),
            "model_size": size,
        }
        return model
    finally:
        _lock.release()


def _get_max_vectorise_batch_size() -> int:
    """Reads + validates MARQO_MAX_VECTORISE_BATCH_SIZE (reference
    s2_inference.py:239-258: non-int or <1 is a ConfigurationError, read
    at call time)."""
    from marqo_tpu_torch.api import configs
    from marqo_tpu_torch.api.exceptions import EnvVarError
    value = configs.read_env_vars_and_defaults(
        "MARQO_MAX_VECTORISE_BATCH_SIZE")
    validation_error_msg = (
        "Could not properly read env var `MARQO_MAX_VECTORISE_BATCH_SIZE`. "
        "`MARQO_MAX_VECTORISE_BATCH_SIZE` must be an int greater than or "
        "equal to 1.")
    try:
        batch_size = int(value)
    except (ValueError, TypeError) as e:
        raise EnvVarError(
            f"`{validation_error_msg} Current value: `{value}`. "
            f"Reason: {e}") from e
    if batch_size < 1:
        raise EnvVarError(
            f"`{validation_error_msg} Current value: `{value}`.")
    return batch_size


def vectorise(model_name: str,
              content: Union[str, List[Any]],
              model_properties: Optional[dict] = None,
              device: Optional[str] = None,
              normalize_embeddings: bool = True,
              model_auth=None,
              enable_cache: bool = False,
              modality: Modality = Modality.TEXT,
              **kwargs) -> np.ndarray:
    """Embed content → one C-contiguous ``(n, dim)`` float32 array, a row
    per item (reference s2_inference.py:48 answers the same values as
    List[List[float]]).

    ``content`` may be a single string or a list of strings / preprocessed
    media tensors. ``enable_cache`` consults the embedding-result cache
    (search-query path passes True, as in the reference).
    """
    if content is None or (isinstance(content, list) and len(content) == 0):
        raise VectoriseError("Received empty content for vectorise")
    contents = [content] if isinstance(content, str) else list(content)

    dev = Device.normalize(device)
    properties = _resolve_properties(model_name, model_properties)
    cache_key = _create_model_cache_key(model_name, dev.value, properties)
    model = _update_available_models(cache_key, model_name, properties, dev,
                                     model_auth)

    cache = _get_inference_cache()
    use_cache = enable_cache and cache.enabled and normalize_embeddings
    hits: Dict[int, np.ndarray] = {}
    misses: List[int] = []
    if use_cache:
        for i, item in enumerate(contents):
            hit = cache.get(cache_key, item)
            if hit is not None:
                hits[i] = hit
            else:
                misses.append(i)
        metrics = telemetry.RequestMetricsStore.for_request()
        metrics.increment_counter("inference_cache.hits", len(hits))
        metrics.increment_counter("inference_cache.misses", len(misses))
    else:
        misses = list(range(len(contents)))

    encoded = None
    if misses:
        # MARQO_MAX_VECTORISE_BATCH_SIZE chunks encode calls (reference
        # s2_inference.py:134-146) and its value is validated either way.
        # TPU divergence: the chunk guard only applies when the env var is
        # EXPLICITLY set — the default 16-item chunking is a CPU/GPU
        # memory knob, and inference/batching.py already buckets device
        # batches; results are identical, only chunking differs.
        import os as _os
        max_batch = _get_max_vectorise_batch_size()
        if "MARQO_MAX_VECTORISE_BATCH_SIZE" not in _os.environ:
            max_batch = len(misses)
        try:
            miss_contents = [contents[i] for i in misses]
            parts = []
            from marqo_tpu_torch.inference.batching import generate_batches
            for chunk in generate_batches(miss_contents, max_batch):
                parts.append(_encode(model, cache_key, chunk,
                                     normalize_embeddings, modality))
            encoded = (parts[0] if len(parts) == 1
                       else np.concatenate([np.asarray(p) for p in parts],
                                           axis=0))
        except VectoriseError:
            raise
        except Exception as e:
            raise VectoriseError(
                f"Error vectorising content with model `{model_name}`: {e}",
                cause=e) from e
    return _finish(contents, hits, misses, encoded, cache_key, use_cache)


def _finish(contents, hits, misses, encoded, cache_key, use_cache):
    """The rows of ``contents`` as one ``(n, dim)`` float32 array:
    ``encoded`` (the misses' rows, in order) with the cache's hits placed
    by index. The cache keeps a copy of each miss's row, so that an entry
    holds no whole batch alive."""
    with telemetry.span("inference.to_lists"):
        rows = float_rows(encoded) if misses else None
        if use_cache and rows is not None:
            cache = _get_inference_cache()
            for j, i in enumerate(misses):
                cache.set(cache_key, contents[i], rows[j].copy())
        if not hits:
            return rows
        out = np.empty((len(contents), len(next(iter(hits.values())))),
                       dtype=np.float32)
        for i, hit in hits.items():
            out[i] = hit
        if misses:
            out[misses] = rows
        return out


def _encode(model: EmbeddingModel, cache_key: str, contents: List[Any],
            normalize: bool, modality: Modality):
    """Dispatch to the model, optionally through the dynamic micro-batching
    scheduler (MARQO_DYNAMIC_BATCHING=TRUE): concurrent small text requests
    coalesce into one bucketed device batch — the TPU-serving replacement
    for the reference's thread-per-request torch loops (SURVEY.md D2)."""
    use_scheduler = (
        modality == Modality.TEXT and normalize is True and
        configs.read_env_vars_and_defaults_bool("MARQO_DYNAMIC_BATCHING") and
        all(isinstance(c, str) for c in contents))
    if not use_scheduler:
        return model.encode(contents, normalize=normalize, modality=modality)
    from marqo_tpu_torch.inference.batch_scheduler import (SchedulerShutdown,
                                                     get_scheduler)
    encode_fn = lambda batch: model.encode(batch, normalize=True,
                                           modality=Modality.TEXT)
    for _ in range(2):
        scheduler = get_scheduler(cache_key, encode_fn,
                                  max_batch=256, max_wait_ms=2.0)
        try:
            return scheduler.encode(contents)
        except SchedulerShutdown:
            # model ejected concurrently; this call still holds a live
            # model reference — re-resolve once, then encode directly
            continue
    return model.encode(contents, normalize=normalize, modality=modality)


def float_rows(arr) -> np.ndarray:
    """Encoder output as a C-contiguous ``(n, dim)`` float32 array: a 1-D
    vector is one row."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    return arr[None, :] if arr.ndim == 1 else arr


def get_model_dimensions(model_name: str,
                         model_properties: Optional[dict] = None) -> int:
    props = _resolve_properties(model_name, model_properties)
    dims = props.get("dimensions")
    if not dims:
        raise InvalidArgumentError(
            f"Model `{model_name}` has no `dimensions` in its properties")
    return int(dims)


def get_loaded_models() -> dict:
    """Loaded-model listing (reference s2_inference.py:161 + api /models)."""
    models = []
    for key, entry in _available_models.items():
        model_name = key.split("||")[0]
        models.append({"model_name": model_name,
                       "model_device": entry["model"].device.value})
    return {"models": models}


def eject_model(model_name: str, device: str) -> dict:
    """Remove a model from the cache (reference s2_inference.py:774)."""
    dev = Device.normalize(device)
    # under the loader lock: a load in progress iterates
    # _available_models (eviction/memory accounting) — an unlocked del
    # here is a 'dict changed size during iteration' 500 on that thread
    with _lock:
        to_remove = [key for key, entry in _available_models.items()
                     if key.split("||")[0] == model_name
                     and entry["model"].device == dev]
        if not to_remove:
            raise ModelNotInCacheError(
                f"The model_name `{model_name}` device `{device}` is not cached or found")
        for key in to_remove:
            del _available_models[key]
            _drop_scheduler(key)
    return {"result": "success",
            "message": f"successfully eject model_name `{model_name}` "
                       f"from device `{dev.value}`"}


def _drop_scheduler(cache_key: str) -> None:
    """Release the dynamic-batching scheduler tied to an ejected/evicted
    model — its encode_fn closure would otherwise keep the model alive."""
    from marqo_tpu_torch.inference.batch_scheduler import clear_scheduler
    clear_scheduler(cache_key)


def clear_loaded_models() -> None:
    from marqo_tpu_torch.inference.batch_scheduler import clear_schedulers
    with _lock:
        _available_models.clear()
        clear_schedulers()


def clear_inference_cache() -> None:
    global _inference_cache
    _inference_cache = None
