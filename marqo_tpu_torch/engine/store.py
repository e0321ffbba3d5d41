"""In-process vector-store engine: document store + tensor ANN + BM25 +
filters + hybrid fusion.

Role parity: the Vespa content node + HybridSearcher container plugin
(SURVEY.md §2.2) — per-schema document store, per-tensor-field vector index,
bm25 posting lists, filter evaluation, rank expressions (score modifiers),
parallel hybrid legs fused with weighted RRF
(vespa/.../HybridSearcher.java:92-285: alpha·1/(k+rank) tensor leg,
(1-alpha)·1/(k+rank) lexical leg, k=60, alpha=0.5 defaults).

This is the Python reference engine (numpy brute-force scoring — exact, the
``approximate=False`` path); the native C++ engine (engine/cpp) implements
the same interface with HNSW for ``approximate=True`` at scale, and shards
documents by id-hash across content shards (reference services.xml
distribution, SURVEY.md D1).
"""

import contextlib
import threading
import zlib
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from marqo_tpu_torch.api import telemetry
from marqo_tpu_torch.core.exceptions import (IndexExistsError, IndexNotFoundError,
                                       InvalidArgumentError)
from marqo_tpu_torch.core.models.score_modifier import (ScoreModifier,
                                                  ScoreModifierType)
from marqo_tpu_torch.core.search.search_filter import SearchFilter
from marqo_tpu_torch.engine.bm25 import (Bm25FieldIndex,
                                   global_idf as bm25_global_idf,
                                   make_field_index, tokenize)
from marqo_tpu_torch.engine.descriptor import IndexDescriptor
from marqo_tpu_torch.engine.filter_eval import evaluate_node
from marqo_tpu_torch.engine.torch_scorer import bring_up_field
from marqo_tpu_torch.logging import get_logger

logger = get_logger(__name__)


# --- scoring ---------------------------------------------------------------

def closeness(metric: str, query: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Vespa-compatible closeness = 1/(1+distance) per metric
    (rank feature closeness(field), reference embedding_similarity profile)."""
    if matrix.size == 0:
        return np.zeros((0,), dtype=np.float32)
    if matrix.dtype != np.float32:
        # bfloat16-cell stores: exact scoring upcasts once per scan (the
        # exact path only runs on small fields or approximate=False)
        matrix = matrix.astype(np.float32)
    if metric == "prenormalized-angular":
        dist = 1.0 - matrix @ query
    elif metric == "angular":
        q = query / max(np.linalg.norm(query), 1e-12)
        norms = np.maximum(np.linalg.norm(matrix, axis=1), 1e-12)
        cos = np.clip((matrix @ q) / norms, -1.0, 1.0)
        dist = np.arccos(cos)
    elif metric == "dotproduct":
        # Vespa dotproduct: distance = -dot; closeness uses the raw dot
        dot = matrix @ query
        return dot.astype(np.float32)
    elif metric == "euclidean":
        dist = np.linalg.norm(matrix - query[None, :], axis=1)
    elif metric == "hamming":
        dist = np.sum(np.sign(matrix) != np.sign(query[None, :]), axis=1)
    elif metric == "geodegrees":
        # lat/lng pairs in degrees; great-circle distance in km
        lat1, lng1 = np.radians(matrix[:, 0]), np.radians(matrix[:, 1])
        lat2, lng2 = np.radians(query[0]), np.radians(query[1])
        dlat, dlng = lat2 - lat1, lng2 - lng1
        a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlng / 2) ** 2
        dist = 6371.0 * 2 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
    else:
        raise InvalidArgumentError(f"Unknown distance metric: {metric}")
    return (1.0 / (1.0 + dist)).astype(np.float32)


def _closeness_from_distance(metric: str, dists: np.ndarray) -> np.ndarray:
    """Convert native-engine distances to closeness scores. The native
    euclidean metric returns squared L2 (monotone-equivalent for ranking);
    dotproduct returns -dot."""
    dists = np.asarray(dists, dtype=np.float32)
    if metric == "dotproduct":
        return -dists
    if metric == "euclidean":
        return (1.0 / (1.0 + np.sqrt(np.maximum(dists, 0)))).astype(np.float32)
    if metric == "angular":
        # The native METRIC_ANGULAR kernel returns 1-cos (using its
        # per-row norm cache over the store's cells); convert to the
        # true-angle closeness the exact path reports (1/(1+arccos)).
        cos = np.clip(1.0 - dists, -1.0, 1.0)
        return (1.0 / (1.0 + np.arccos(cos))).astype(np.float32)
    return (1.0 / (1.0 + dists)).astype(np.float32)


# --- per-shard storage -------------------------------------------------------

def np_cell_dtype(cell_dtype: str):
    """numpy dtype for a vector cell type. bfloat16 comes from ml_dtypes
    (installed with numpy's scientific stack); it registers a real numpy
    dtype, so views/matmul/savez all work, with matmul upcasting to fp32."""
    if cell_dtype == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(np.float32)


class _FieldTensors:
    """Append-only chunk store for one tensor field (per shard).

    SINGLE-COPY vector storage: one contiguous (capacity, dim) ndarray in
    the index's cell dtype (float32 default; bfloat16 halves memory —
    Vespa's bfloat16 tensor-cell option / marqo vectorNumericType). The
    native HNSW is graph-only and reads rows straight out of this array
    (engine/native.py ABI v2), so there is no second fp32 copy anywhere
    in the process. Rows are append-only with a validity mask so row ids
    stay stable for the HNSW graph; deletes are tombstones in both
    structures (Vespa's HNSW behaves the same way).
    """

    def __init__(self, dimensions: int,
                 metric: str = "prenormalized-angular",
                 hnsw_m: int = 16, hnsw_ef_construction: int = 512,
                 cell_dtype: str = "float32"):
        self.dimensions = dimensions
        self.metric = metric
        self.cell_dtype = cell_dtype
        self._np_dtype = np_cell_dtype(cell_dtype)
        self._store = np.empty((0, dimensions), dtype=self._np_dtype)
        self._n = 0
        self._doc_ids: List[str] = []
        self._chunks: List[str] = []
        self._valid: List[bool] = []
        self._live_docs: Set[str] = set()
        self._rows_by_doc: Dict[str, List[int]] = defaultdict(list)
        self._hnsw = None
        self._hnsw_params = (hnsw_m, hnsw_ef_construction)
        self._version = 0
        self._device_scorer = None

    def _ensure_capacity(self, extra: int) -> None:
        need = self._n + extra
        if need <= self._store.shape[0]:
            return
        cap = max(64, self._store.shape[0])
        while cap < need:
            cap *= 2
        grown = np.empty((cap, self.dimensions), dtype=self._np_dtype)
        grown[:self._n] = self._store[:self._n]
        # callers hold the shard lock, so no native call is mid-flight on
        # the old buffer; the next call passes the new base pointer
        self._store = grown

    def _build_threads(self) -> int:
        from marqo_tpu_torch.api import configs
        return int(configs.read_env_vars_and_defaults(
            "MARQO_HNSW_BUILD_THREADS") or 0)

    def _ensure_hnsw(self):
        if self._hnsw is None:
            try:
                from marqo_tpu_torch.engine.native import (METRIC_IDS, NativeHnsw,
                                                     native_available)
                if self.metric not in METRIC_IDS:
                    # hamming/geodegrees have no native distance kernel:
                    # stay on the exact numpy path (correct, slower)
                    # rather than silently scoring with the wrong metric
                    return None
                if native_available():
                    m, efc = self._hnsw_params
                    hnsw = NativeHnsw(self.dimensions, m=m,
                                      ef_construction=efc,
                                      metric=self.metric,
                                      cell_dtype=self.cell_dtype)
                    if self._n:
                        # bulk parallel build over the store's rows (callers
                        # hold the field lock; MARQO_HNSW_BUILD_THREADS=0 →
                        # all cores)
                        first = hnsw.link(self._store, self._n,
                                          self._build_threads())
                        assert first == 0
                        for row, ok in enumerate(self._valid):
                            if not ok:
                                hnsw.remove(row)
                    self._hnsw = hnsw
            except Exception:
                self._hnsw = None
        return self._hnsw

    def add(self, doc_id: str, chunks: List[str], embeddings) -> None:
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim == 1 and emb.size:
            # promote a single 1-D vector to (1, dim); an EMPTY list is a
            # valid zero-chunk payload, not a (1, 0) matrix
            emb = emb[None, :]
        if emb.shape[0] != len(chunks):
            raise InvalidArgumentError(
                f"chunks ({len(chunks)}) and embeddings ({emb.shape[0]}) "
                f"count mismatch")
        if emb.size and emb.shape[1] != self.dimensions:
            raise InvalidArgumentError(
                f"Expected embeddings of dimension {self.dimensions}, got "
                f"{emb.shape[1]}")
        self.remove(doc_id)
        self._live_docs.add(doc_id)
        n_new = emb.shape[0]
        if n_new:
            self._ensure_capacity(n_new)
            self._store[self._n:self._n + n_new] = emb  # cell-dtype cast
        for chunk in chunks:
            row = self._n
            self._n += 1
            self._rows_by_doc[doc_id].append(row)
            self._doc_ids.append(doc_id)
            self._chunks.append(chunk)
            self._valid.append(True)
        if self._hnsw is not None and n_new:
            self._hnsw.link(self._store, self._n, n_threads=1)
        self._version += 1
        # the write that takes the field to MIN_ROWS_FOR_DEVICE rows starts
        # the exact scan's device bring-up, in the background
        bring_up_field(self, wait=False)

    def remove(self, doc_id: str) -> None:
        if doc_id not in self._live_docs:
            return
        self._live_docs.discard(doc_id)
        rows = self._rows_by_doc.pop(doc_id, [])
        for row in rows:
            self._valid[row] = False
            if self._hnsw is not None:
                self._hnsw.remove(row)
        self._version += 1

    def matrix(self) -> Tuple[np.ndarray, List[str], List[str], np.ndarray]:
        """(vectors view — cell dtype, no copy; per-row doc ids, per-row
        chunks, validity mask)."""
        return (self._store[:self._n], self._doc_ids, self._chunks,
                np.asarray(self._valid, dtype=bool))

    def search_approximate(self, query: np.ndarray, k: int, ef: int,
                           allowed_docs: Optional[Set[str]]):
        """HNSW row search; returns (row_indices, distances) or None when
        the native engine is unavailable."""
        hnsw = self._ensure_hnsw()
        if hnsw is None or len(self._doc_ids) == 0:
            return None
        mask = None
        if allowed_docs is not None:
            mask = np.zeros(len(self._doc_ids), dtype=np.uint8)
            for doc_id in allowed_docs:
                for row in self._rows_by_doc.get(doc_id, ()):
                    mask[row] = 1
        k = min(k, len(self._doc_ids))
        return hnsw.search(self._store,
                           np.asarray(query, dtype=np.float32),
                           k=k, ef=max(ef, k), filter_mask=mask)

    def search_exact_device(self, query: np.ndarray, k: int):
        """Accelerator-backed exact top-k (engine/torch_scorer.py); None when
        the corpus is small or no CUDA device is attached."""
        from marqo_tpu_torch.engine.torch_scorer import TorchExactScorer
        if self._device_scorer is None:
            self._device_scorer = TorchExactScorer(self.metric)
        matrix, _doc_ids, _chunks, valid = self.matrix()
        return self._device_scorer.top_k(matrix, self._version, query, k, valid)

    def doc_tensors(self, doc_id: str) -> List[Tuple[str, np.ndarray]]:
        return [(self._chunks[i],
                 np.asarray(self._store[i], dtype=np.float32))
                for i in self._rows_by_doc.get(doc_id, [])]

    @property
    def vector_count(self) -> int:
        return sum(len(rows) for rows in self._rows_by_doc.values())


class _Shard:
    def __init__(self, descriptor: IndexDescriptor):
        self.descriptor = descriptor
        self.docs: Dict[str, dict] = {}
        self.tensors: Dict[str, _FieldTensors] = {}
        self.lexical: Dict[str, Bm25FieldIndex] = {}
        self.lock = threading.RLock()

    def _tensor_store(self, field: str) -> _FieldTensors:
        if field not in self.tensors:
            tf = self.descriptor.tensor_field_map.get(field)
            if tf is None and self.descriptor.tensor_fields:
                tf = self.descriptor.tensor_fields[0]
            self.tensors[field] = _FieldTensors(
                self.descriptor.model_dimensions,
                metric=(tf.distance_metric if tf else "prenormalized-angular"),
                hnsw_m=(tf.hnsw_m if tf else 16),
                hnsw_ef_construction=(tf.hnsw_ef_construction if tf else 512),
                cell_dtype=getattr(self.descriptor, "cell_dtype", "float32"))
        return self.tensors[field]

    def _lexical_index(self, field: str) -> Bm25FieldIndex:
        if field not in self.lexical:
            self.lexical[field] = make_field_index()
        return self.lexical[field]

    def _is_lexical_field(self, field: str, value: Any) -> bool:
        if self.descriptor.dynamic_fields:
            return isinstance(value, str) or (
                isinstance(value, list) and all(isinstance(v, str) for v in value))
        f = self.descriptor.field_map.get(field)
        return f is not None and f.lexical

    def feed(self, doc_id: str, fields: dict, tensors: dict) -> None:
        with self.lock:
            if doc_id in self.docs:
                # upsert: clear the old doc from every index. New docs
                # (the ingest hot path) skip the per-index removal scans.
                self.delete(doc_id)
            self.docs[doc_id] = dict(fields)
            with telemetry.summed("engine.feed.lexical"):
                for field, value in fields.items():
                    if self._is_lexical_field(field, value):
                        text = " ".join(value) if isinstance(value, list) \
                            else value
                        self._lexical_index(field).add(doc_id, text)
            for field, payload in (tensors or {}).items():
                self._tensor_store(field).add(
                    doc_id, payload["chunks"], payload["embeddings"])

    def update(self, doc_id: str, updates: dict) -> bool:
        """Merge ``updates`` into the stored fields atomically, leaving
        tensors untouched (the Vespa partial-update contract: metadata
        assign ops never disturb the document's tensor attributes).
        Returns False when the document does not exist."""
        with self.lock:
            current = self.docs.get(doc_id)
            if current is None:
                return False
            merged = dict(current)
            merged.update(updates)
            # replace wholesale, never mutate in place: _get_ref readers
            # hold references to the old dict
            self.docs[doc_id] = merged
            for field, value in updates.items():
                if field in self.lexical:
                    self.lexical[field].remove(doc_id)
                if self._is_lexical_field(field, value):
                    text = " ".join(value) if isinstance(value, list) else value
                    self._lexical_index(field).add(doc_id, text)
            return True

    def delete(self, doc_id: str) -> bool:
        with self.lock:
            existed = doc_id in self.docs
            self.docs.pop(doc_id, None)
            for idx in self.lexical.values():
                idx.remove(doc_id)
            for ts in self.tensors.values():
                ts.remove(doc_id)
            return existed

    def allowed_docs(self, search_filter: Optional[SearchFilter]) -> Optional[Set[str]]:
        if search_filter is None or search_filter.root is None:
            return None
        return {doc_id for doc_id, doc in self.docs.items()
                if evaluate_node(search_filter.root,
                                 self._filterable_view(doc), doc_id)}

    def _filterable_view(self, doc: dict) -> dict:
        """Unstructured/semi-structured indexes only keep strings up to
        filter_string_max_length in the filterable store (reference
        unstructured schema: short-string map is filterable, long strings
        are lexical-only — filter_string_max_length threshold)."""
        if not self.descriptor.dynamic_fields:
            return doc
        cap = self.descriptor.filter_string_max_length
        view = {}
        for key, value in doc.items():
            if isinstance(value, str) and len(value) > cap:
                continue
            if isinstance(value, list):
                value = [v for v in value
                         if not (isinstance(v, str) and len(v) > cap)]
            view[key] = value
        return view


# --- results ----------------------------------------------------------------

class Hit:
    __slots__ = ("doc_id", "score", "fields", "highlight", "raw_tensor_score",
                 "raw_lexical_score")

    def __init__(self, doc_id: str, score: float, fields: dict,
                 highlight: Optional[dict] = None,
                 raw_tensor_score: Optional[float] = None,
                 raw_lexical_score: Optional[float] = None):
        self.doc_id = doc_id
        self.score = score
        self.fields = fields
        self.highlight = highlight
        self.raw_tensor_score = raw_tensor_score
        self.raw_lexical_score = raw_lexical_score

    def __repr__(self):
        return f"Hit({self.doc_id!r}, {self.score:.4f})"


class QueryResult:
    def __init__(self, hits: List[Hit], total: int):
        self.hits = hits
        self.total = total


# --- the engine --------------------------------------------------------------

class StoreEngine:
    """One engine instance hosting many indexes, each split into shards by
    id-hash (reference Vespa content-cluster distribution, SURVEY.md D1)."""

    def __init__(self, n_shards: int = 1):
        self.n_shards = max(1, n_shards)
        self._indexes: Dict[str, List[_Shard]] = {}
        self._descriptors: Dict[str, IndexDescriptor] = {}
        self._lock = threading.RLock()
        # incremental snapshots: per-index mutation counter + the counter
        # value captured by the last snapshot write (snapshot() skips
        # indexes whose state is unchanged — the 60s daemon stops rewriting
        # every index's full doc+tensor state on idle systems)
        self._mutations: Dict[str, int] = defaultdict(int)
        self._snapshotted: Dict[str, int] = {}
        # optional write-ahead log (engine/wal.py): Vespa-transactionlog
        # role — acknowledged mutations survive a crash between snapshots
        self._wal = None
        # >0 on a thread replaying the WAL or restoring a snapshot:
        # BOOT-time recovery must never be refused by the feed-block
        # watermark (Vespa likewise replays its transaction log above the
        # feed resource limits). Thread-local: concurrent client feeds on
        # other threads keep their watermark check, and parallel recovery
        # calls can't corrupt a shared counter. Peer-dump sync
        # (load_index_dump) deliberately does NOT bypass — an out-of-space
        # node must refuse repair traffic too, else anti-entropy fills its
        # disk to ENOSPC with exactly the writes the watermark refused.
        self._recovery = threading.local()

    def _mutated(self, name: str) -> None:
        with self._lock:
            self._mutations[name] += 1

    @contextlib.contextmanager
    def _recovering(self):
        """Mark THIS thread as inside boot-time recovery: its feeds skip
        the feed-block watermark. Re-entrant; other threads unaffected."""
        depth = getattr(self._recovery, "depth", 0)
        self._recovery.depth = depth + 1
        try:
            yield
        finally:
            self._recovery.depth = depth

    def _in_recovery(self) -> bool:
        return getattr(self._recovery, "depth", 0) > 0

    # -- write-ahead log --

    def attach_wal(self, wal) -> None:
        """Start logging mutations (call AFTER restore + replay)."""
        self._wal = wal

    def _log(self, record: dict) -> None:
        if self._wal is not None:
            self._wal.append(record)

    def replay_wal(self, wal) -> int:
        """Apply logged mutations over restored snapshot state (idempotent:
        feed is an upsert, deletes/DDL tolerate already-applied records)."""
        with self._recovering():
            applied = self._replay_wal_records(wal)
        return applied

    def _replay_wal_records(self, wal) -> int:
        applied = 0
        for rec in wal.replay():
            try:
                op = rec["op"]
                if op == "feed":
                    self.feed(rec["index"], rec["doc_id"], rec["fields"],
                              rec["tensors"])
                elif op == "update":
                    self.update(rec["index"], rec["doc_id"], rec["updates"])
                elif op == "delete":
                    self.delete(rec["index"], rec["doc_id"])
                elif op == "delete_all":
                    if self.has_index(rec["index"]):
                        self.delete_all(rec["index"])
                elif op == "create_index":
                    if not self.has_index(rec["descriptor"]["name"]):
                        self.create_index(
                            IndexDescriptor.from_json(rec["descriptor"]))
                elif op == "update_index":
                    if self.has_index(rec["descriptor"]["name"]):
                        self.update_index(
                            IndexDescriptor.from_json(rec["descriptor"]))
                elif op == "delete_index":
                    if self.has_index(rec["index"]):
                        self.delete_index(rec["index"])
                applied += 1
            except Exception as e:
                # one bad record must not block the rest of the log
                from marqo_tpu_torch.logging import get_logger
                get_logger(__name__).warning(f"WAL replay skipped a "
                                             f"record: {e}")
        return applied

    # -- DDL --

    def create_index(self, descriptor: IndexDescriptor) -> None:
        with self._lock:
            if descriptor.name in self._indexes:
                raise IndexExistsError(f"Index {descriptor.name} already exists")
            self._indexes[descriptor.name] = [
                _Shard(descriptor) for _ in range(self.n_shards)]
            self._descriptors[descriptor.name] = descriptor
            self._mutations[descriptor.name] += 1
            # log under the same lock that ordered the application: DDL on
            # the same name must hit the WAL in apply order, else replay
            # can resurrect a deleted index (create applied before delete
            # but logged after it)
            self._log({"op": "create_index",
                       "descriptor": descriptor.to_json()})

    def update_index(self, descriptor: IndexDescriptor) -> None:
        """Semi-structured schema growth: swap the descriptor in place."""
        with self._lock:
            shards = self._shards(descriptor.name)
            self._descriptors[descriptor.name] = descriptor
            for shard in shards:
                shard.descriptor = descriptor
            self._mutations[descriptor.name] += 1
            self._log({"op": "update_index",
                       "descriptor": descriptor.to_json()})

    def delete_index(self, name: str) -> None:
        with self._lock:
            if name not in self._indexes:
                raise IndexNotFoundError(f"Index {name} not found")
            del self._indexes[name]
            del self._descriptors[name]
            self._mutations.pop(name, None)
            self._snapshotted.pop(name, None)
            self._log({"op": "delete_index", "index": name})

    def has_index(self, name: str) -> bool:
        return name in self._indexes

    def list_indexes(self) -> List[str]:
        return list(self._indexes)

    def _shards(self, name: str) -> List[_Shard]:
        try:
            return self._indexes[name]
        except KeyError:
            raise IndexNotFoundError(f"Index {name} not found")

    def _shard_for(self, name: str, doc_id: str) -> _Shard:
        # Stable across process restarts (builtin hash() is salted per
        # process, which would misroute restored/re-fed docs).
        shards = self._shards(name)
        return shards[zlib.crc32(doc_id.encode("utf-8")) % len(shards)]

    # -- documents --

    def feed(self, index_name: str, doc_id: str, fields: dict,
             tensors: Optional[dict] = None) -> None:
        if not self._in_recovery():
            # feed-block: refuse writes above the resource watermarks
            # (Vespa cluster-controller resource limits → HTTP 507 → the
            # per-doc 400 of the translate matrix). Cached probe: ~2 dict
            # lookups per doc on the hot path.
            from marqo_tpu_torch.core.exceptions import EngineOutOfSpaceError
            from marqo_tpu_torch.engine.resources import watcher
            reason = watcher().feed_block_reason()
            if reason is not None:
                raise EngineOutOfSpaceError(f"Feed blocked: {reason}")
        shard = self._shard_for(index_name, doc_id)
        # log under the shard lock (RLock): WAL order must match apply
        # order per document, else a crash replay can resurrect a deleted
        # doc or revert an upsert (apply-then-log outside the lock races)
        with telemetry.locked(shard.lock, "engine.lock_wait"):
            shard.feed(doc_id, fields, tensors or {})
            if self._wal is not None:
                self._log({"op": "feed", "index": index_name,
                           "doc_id": doc_id, "fields": fields,
                           "tensors": tensors or {}})
        self._mutated(index_name)

    def update(self, index_name: str, doc_id: str, updates: dict) -> bool:
        """Atomic partial update: merge ``updates`` into the stored fields
        under the shard lock (reference: Vespa partial updates are atomic
        per document — document.py:107-170 builds assign updates; a
        get/merge/feed read-modify-write would lose concurrent writes).
        Tensors are preserved. Returns False when the doc doesn't exist."""
        if not self._in_recovery():
            # same write gate as feed(): Vespa feed-block applies to
            # put AND update operations (only removes are exempt)
            from marqo_tpu_torch.core.exceptions import EngineOutOfSpaceError
            from marqo_tpu_torch.engine.resources import watcher
            reason = watcher().feed_block_reason()
            if reason is not None:
                raise EngineOutOfSpaceError(f"Feed blocked: {reason}")
        shard = self._shard_for(index_name, doc_id)
        with shard.lock:  # see feed(): log order == apply order per doc
            found = shard.update(doc_id, updates)
            if found and self._wal is not None:
                self._log({"op": "update", "index": index_name,
                           "doc_id": doc_id, "updates": updates})
        if found:
            self._mutated(index_name)
        return found

    def get(self, index_name: str, doc_id: str) -> Optional[dict]:
        shard = self._shard_for(index_name, doc_id)
        with shard.lock:
            doc = shard.docs.get(doc_id)
            return dict(doc) if doc is not None else None

    def _get_ref(self, index_name: str, doc_id: str) -> Optional[dict]:
        """Read-only reference WITHOUT the defensive copy — for the
        score-modifier hot path, which reads a couple of numeric fields
        per scored doc (feed replaces the doc dict wholesale under the
        shard lock, so a reference read stays internally consistent).
        Callers must not mutate the result."""
        shard = self._shard_for(index_name, doc_id)
        with shard.lock:
            return shard.docs.get(doc_id)

    def get_tensors(self, index_name: str, doc_id: str) -> Dict[str, list]:
        shard = self._shard_for(index_name, doc_id)
        with shard.lock:
            result = {}
            for field, ts in shard.tensors.items():
                pairs = ts.doc_tensors(doc_id)
                if pairs:
                    result[field] = [
                        {"chunk": c, "embedding": v.tolist()} for c, v in pairs]
            return result

    def delete(self, index_name: str, doc_id: str) -> bool:
        shard = self._shard_for(index_name, doc_id)
        with shard.lock:  # see feed(): log order == apply order per doc
            existed = shard.delete(doc_id)
            if existed:
                self._log({"op": "delete", "index": index_name,
                           "doc_id": doc_id})
        if existed:
            self._mutated(index_name)
        return existed

    def delete_all(self, index_name: str) -> int:
        count = 0
        for shard in self._shards(index_name):
            with shard.lock:
                count += len(shard.docs)
                doc_ids = list(shard.docs)
            for doc_id in doc_ids:
                shard.delete(doc_id)
        if count:
            self._mutated(index_name)
            # coarse ordering: a feed racing delete_all may replay in
            # either order — the same nondeterminism the caller already
            # has (per-doc ops above ARE strictly ordered via shard locks)
            self._log({"op": "delete_all", "index": index_name})
        return count

    def index_digest(self, index_name: str) -> dict:
        """Order-independent content digest for replica divergence checks:
        identical doc sets yield identical digests regardless of feed
        order. Cheap (one crc pass per doc), computed on demand by the
        cluster heal operation.

        ``seq`` is the durable per-index mutation sequence (advanced by
        every applied mutation, persisted in snapshots, re-advanced by WAL
        replay, adopted from the source on sync) — the heal election key.
        With write-all semantics the replica that applied MORE mutations is
        the one that was up for the writes its peer missed, including
        DELETES — doc-count election would resurrect a missed delete
        (the replica that missed it holds more docs and would win)."""
        import json as _json
        checksum = 0
        count = 0
        for doc_id, fields in self.visit_all(index_name):
            payload = doc_id + "\x00" + _json.dumps(fields, sort_keys=True)
            checksum = (checksum + zlib.crc32(payload.encode("utf-8"))) \
                % (2 ** 63)
            count += 1
        return {"doc_count": count, "checksum": checksum,
                "seq": self._mutations.get(index_name, 0)}

    def dump_index(self, index_name: str) -> dict:
        """Full JSON-serializable state of one index (descriptor + docs +
        tensors) — replica anti-entropy (engine/cluster.py heal: a replica
        that missed writes while down re-syncs from a healthy peer; Vespa
        content nodes redistribute replicas internally the same way)."""
        if index_name not in self._descriptors:
            raise IndexNotFoundError(f"Index {index_name} not found")
        docs = []
        for doc_id, fields in self.visit_all(index_name):
            docs.append({"id": doc_id, "fields": fields,
                         "tensors": self.get_tensors(index_name, doc_id)})
        return {"descriptor": self._descriptors[index_name].to_json(),
                "docs": docs,
                "version": self._mutations.get(index_name, 0)}

    def load_index_dump(self, dump: dict) -> int:
        """Replace this engine's copy of the index with a peer's dump."""
        descriptor = IndexDescriptor.from_json(dump["descriptor"])
        # A feed-blocked node refuses the WHOLE sync up front — BEFORE
        # deleting its current copy — so repair traffic can never fill an
        # out-of-space node to ENOSPC with writes its watermark already
        # refused (the healing peer gets the 507, the shard stays flagged,
        # and the sync retries once space frees). Checked once here, then
        # applied under the recovery bypass: a half-applied dump (partial
        # replica serving reads with the old copy gone) would be worse
        # than a bounded overshoot of the watermark.
        from marqo_tpu_torch.core.exceptions import EngineOutOfSpaceError
        from marqo_tpu_torch.engine.resources import watcher
        reason = watcher().feed_block_reason()
        if reason is not None:
            raise EngineOutOfSpaceError(f"Sync refused: {reason}")
        if self.has_index(descriptor.name):
            self.delete_index(descriptor.name)
        self.create_index(descriptor)
        with self._recovering():
            for doc in dump["docs"]:
                tensors = {
                    field: {"chunks": [e["chunk"] for e in entries],
                            "embeddings": [e["embedding"] for e in entries]}
                    for field, entries in (doc.get("tensors") or {}).items()}
                self.feed(descriptor.name, doc["id"], doc["fields"],
                          tensors)
        # adopt the source's mutation sequence so a healed replica ties the
        # election with its source instead of looking permanently behind
        with self._lock:
            self._mutations[descriptor.name] = max(
                int(dump.get("version", 0)),
                self._mutations.get(descriptor.name, 0))
        return len(dump["docs"])

    def visit_all(self, index_name: str) -> Iterable[Tuple[str, dict]]:
        for shard in self._shards(index_name):
            with shard.lock:
                items = list(shard.docs.items())
            for doc_id, doc in items:
                yield doc_id, dict(doc)

    # -- persistence (role of Vespa's document store durability) --

    def snapshot(self, directory: str) -> int:
        """Write all indexes' documents + tensor stores (including the
        native HNSW graph blobs) to ``directory``. Lexical indexes are
        derived state and rebuild on restore. Returns #documents written.

        Consistency: docs and tensors for each shard are captured under a
        single lock hold, and the JSON/npz pair carries a shared snapshot id
        so restore() can detect a torn pair (e.g. crash between the two
        os.replace calls) and degrade to doc-only restore instead of raising.
        """
        import json as _json
        import os
        import uuid
        os.makedirs(directory, exist_ok=True)
        total = 0
        for name in self.list_indexes():
            # incremental: skip indexes unchanged since their last write
            version = self._mutations.get(name, 0)
            path = os.path.join(directory, f"{name}.engine.json")
            if self._snapshotted.get(name) == version and \
                    os.path.exists(path):
                continue
            snapshot_id = uuid.uuid4().hex
            docs = []
            tensor_meta = {}
            binary: Dict[str, np.ndarray] = {}
            try:
                shards = self._shards(name)
                descriptor_json = self._descriptors[name].to_json()
            except (IndexNotFoundError, KeyError):
                # index deleted concurrently mid-pass: skip it — it must
                # not abort the snapshots of every index sorted after it
                continue
            for shard_idx, shard in enumerate(shards):
                # one lock hold per shard: docs + tensors are mutually
                # consistent (feed() updates both under this same lock)
                with shard.lock:
                    for doc_id, doc in shard.docs.items():
                        docs.append({"id": doc_id, "fields": dict(doc)})
                        total += 1
                    for field, ts in shard.tensors.items():
                        key = f"{shard_idx}::{field}"
                        matrix, doc_ids, chunks, valid = ts.matrix()
                        tensor_meta[key] = {
                            "doc_ids": list(doc_ids),
                            "chunks": list(chunks),
                            "valid": [bool(v) for v in valid],
                            "metric": ts.metric,
                            "hnsw_params": list(ts._hnsw_params),
                            # bfloat16 rows round-trip the npz as raw V2
                            # bytes; restore views them back by this name
                            "cell_dtype": ts.cell_dtype,
                        }
                        binary[key + "::vectors"] = np.ascontiguousarray(
                            matrix)
                        if ts._hnsw is not None:
                            # graph-only blob (ABI v2) — the vectors above
                            # are the single copy
                            binary[key + "::hnsw"] = np.frombuffer(
                                ts._hnsw.save(), dtype=np.uint8)
            payload = {
                "snapshot_id": snapshot_id,
                "n_shards": len(shards),
                "descriptor": descriptor_json,
                "docs": docs,
                "tensor_meta": tensor_meta,
                # durable mutation sequence: restore resumes the counter so
                # heal elections stay comparable across restarts
                "seq": version,
            }
            binary["__snapshot_id__"] = np.frombuffer(
                snapshot_id.encode("ascii"), dtype=np.uint8)
            # npz first, JSON second: restore keys off the JSON, so a crash
            # between the two replaces leaves old-JSON + new-npz, which the
            # id check downgrades to doc-only restore of the OLD snapshot.
            bin_path = os.path.join(directory, f"{name}.tensors.npz")
            np.savez(bin_path + ".tmp.npz", **binary)
            os.replace(bin_path + ".tmp.npz", bin_path)
            with open(path + ".tmp", "w") as f:
                _json.dump(payload, f)
            os.replace(path + ".tmp", path)
            self._snapshotted[name] = version
        # drop snapshots of deleted indexes
        import glob
        live = set(self.list_indexes())
        for path in glob.glob(os.path.join(directory, "*.engine.json")):
            base = os.path.basename(path)[:-len(".engine.json")]
            if base not in live:
                os.remove(path)
                npz = os.path.join(directory, f"{base}.tensors.npz")
                if os.path.exists(npz):
                    os.remove(npz)
        return total

    def restore(self, directory: str) -> int:
        """Load snapshots from ``directory`` (indexes not already present).
        Tensor stores (and HNSW graphs, when the native engine is available)
        restore directly from the binary sidecar — no graph rebuild; only
        the lexical indexes re-derive from documents.

        Robustness: each index restores independently (one corrupt snapshot
        never blocks the rest); a torn JSON/npz pair (snapshot-id mismatch)
        or a shard-count change degrades gracefully instead of raising.
        """
        import glob
        import json as _json
        import os
        total = 0
        with self._recovering():
            for path in sorted(glob.glob(os.path.join(directory,
                                                      "*.engine.json"))):
                try:
                    total += self._restore_one(path, _json, os)
                except Exception:
                    logger.exception(f"Failed to restore snapshot {path}; "
                                     "skipping this index")
        return total

    def _restore_one(self, path: str, _json, os) -> int:
        count = 0
        with open(path) as f:
            payload = _json.load(f)
        descriptor = IndexDescriptor.from_json(payload["descriptor"])
        if self.has_index(descriptor.name):
            return 0
        self.create_index(descriptor)
        # documents + lexical rebuild
        for doc in payload["docs"]:
            self.feed(descriptor.name, doc["id"], doc["fields"], {})
            count += 1
        # resume the durable mutation sequence (heal election key — see
        # index_digest); the restore feeds above only counted docs, not
        # the full mutation history this snapshot represents
        with self._lock:
            self._mutations[descriptor.name] = max(
                int(payload.get("seq", 0)),
                self._mutations.get(descriptor.name, 0))
        # tensor stores from the binary sidecar
        bin_path = path[:-len(".engine.json")] + ".tensors.npz"
        if not os.path.exists(bin_path):
            return count
        shards = self._shards(descriptor.name)
        snap_shards = payload.get("n_shards", len(shards))
        with np.load(bin_path) as data:
            if "__snapshot_id__" in data.files and "snapshot_id" in payload:
                npz_id = data["__snapshot_id__"].tobytes().decode("ascii")
                if npz_id != payload["snapshot_id"]:
                    logger.warning(
                        f"Snapshot pair for index {descriptor.name} is torn "
                        f"(json id {payload['snapshot_id']} != npz id "
                        f"{npz_id}); restoring documents only — tensors for "
                        "this index are lost and need re-embedding")
                    return count
            redistribute = snap_shards != len(shards)
            if redistribute:
                logger.warning(
                    f"Index {descriptor.name}: snapshot has {snap_shards} "
                    f"shards but engine now runs {len(shards)}; re-routing "
                    "tensor rows per document (HNSW graphs rebuild lazily)")
            for key, meta in payload.get("tensor_meta", {}).items():
                shard_idx_s, field = key.split("::", 1)
                cell_dtype = meta.get("cell_dtype", "float32")
                matrix = data[key + "::vectors"]
                if matrix.dtype != np_cell_dtype(cell_dtype):
                    # npz stores bfloat16 as raw V2 bytes — view back
                    matrix = matrix.view(np_cell_dtype(cell_dtype))
                if redistribute:
                    self._reroute_tensor_rows(descriptor.name, field, meta,
                                              matrix)
                    continue
                shard = shards[int(shard_idx_s)]
                ts = _FieldTensors(
                    descriptor.model_dimensions, metric=meta["metric"],
                    hnsw_m=meta["hnsw_params"][0],
                    hnsw_ef_construction=meta["hnsw_params"][1],
                    cell_dtype=cell_dtype)
                ts._doc_ids = list(meta["doc_ids"])
                ts._chunks = list(meta["chunks"])
                ts._store = np.ascontiguousarray(matrix, dtype=ts._np_dtype)
                ts._n = matrix.shape[0]
                ts._valid = list(meta["valid"])
                ts._live_docs = {d for d, v in zip(ts._doc_ids, ts._valid)
                                 if v}
                for row, doc_id in enumerate(ts._doc_ids):
                    if ts._valid[row]:
                        ts._rows_by_doc[doc_id].append(row)
                hnsw_key = key + "::hnsw"
                if hnsw_key in data.files:
                    try:
                        from marqo_tpu_torch.engine.native import NativeHnsw
                        ts._hnsw = NativeHnsw.load(
                            data[hnsw_key].tobytes(),
                            metric=meta["metric"])
                    except Exception:
                        ts._hnsw = None  # lazily rebuilt on first query
                with shard.lock:
                    shard.tensors[field] = ts
        return count

    def _reroute_tensor_rows(self, index_name: str, field: str, meta: dict,
                             matrix: np.ndarray) -> None:
        """Re-feed one snapshotted tensor store through current doc routing
        (used when the engine shard count changed between snapshot and
        restore, so the recorded shard index no longer matches where
        get/delete will look for the doc)."""
        rows_by_doc: Dict[str, List[int]] = defaultdict(list)
        for row, (doc_id, valid) in enumerate(zip(meta["doc_ids"],
                                                  meta["valid"])):
            if valid:
                rows_by_doc[doc_id].append(row)
        for doc_id, rows in rows_by_doc.items():
            shard = self._shard_for(index_name, doc_id)
            with shard.lock:
                ts = shard._tensor_store(field)
                ts.metric = meta["metric"]
                ts._hnsw_params = tuple(meta["hnsw_params"])
                ts.add(doc_id, [meta["chunks"][r] for r in rows],
                       matrix[rows])

    def engine_health(self) -> dict:
        """Backend health for /health aggregation (reference
        monitoring.py:89-154 aggregates per-service Vespa state). The
        in-process engine is reachable by construction; feed-block state
        is surfaced so health can degrade to yellow under resource
        pressure."""
        from marqo_tpu_torch.engine.resources import watcher
        w = watcher()
        blocked = w.feed_block_reason()
        status = "yellow" if blocked else "green"
        return {"status": status,
                "nodes": [{"url": "in-process", "status": status,
                           "memoryIsAvailable": w.memory_is_available(),
                           "storageIsAvailable": w.storage_is_available(),
                           **({"feed_blocked": blocked} if blocked else {})}]}

    def doc_count(self, index_name: str) -> int:
        return sum(len(s.docs) for s in self._shards(index_name))

    def vector_count(self, index_name: str) -> int:
        return sum(ts.vector_count for s in self._shards(index_name)
                   for ts in s.tensors.values())

    # -- queries --

    def query_tensor(self, index_name: str, vector, limit: int,
                     offset: int = 0,
                     searchable_fields: Optional[List[str]] = None,
                     search_filter: Optional[SearchFilter] = None,
                     score_modifiers: Optional[List[ScoreModifier]] = None,
                     ef_search: Optional[int] = None,
                     approximate: bool = True,
                     attributes_to_retrieve: Optional[List[str]] = None,
                     expose_facets: bool = False) -> QueryResult:
        query = np.asarray(vector, dtype=np.float32)
        scored = self._tensor_leg(index_name, query, searchable_fields,
                                  search_filter, ef_search, limit + offset,
                                  approximate=approximate)
        return self._finalize(index_name, scored, limit, offset,
                              score_modifiers, attributes_to_retrieve,
                              expose_facets, leg="tensor")

    def query_lexical(self, index_name: str, or_phrases: List[str],
                      and_phrases: List[str], limit: int, offset: int = 0,
                      searchable_fields: Optional[List[str]] = None,
                      search_filter: Optional[SearchFilter] = None,
                      score_modifiers: Optional[List[ScoreModifier]] = None,
                      attributes_to_retrieve: Optional[List[str]] = None,
                      expose_facets: bool = False,
                      global_stats: Optional[dict] = None) -> QueryResult:
        scored = self._lexical_leg(index_name, or_phrases, and_phrases,
                                   searchable_fields, search_filter,
                                   global_stats=global_stats)
        return self._finalize(index_name, scored, limit, offset,
                              score_modifiers, attributes_to_retrieve,
                              expose_facets, leg="lexical")

    def lexical_stats(self, index_name: str, terms: List[str],
                      searchable_fields: Optional[List[str]] = None) -> dict:
        """Per-field corpus statistics for the given (pre-tokenized) terms,
        aggregated across this engine's internal shards: {field:
        {"num_docs", "total_length", "df": {term: df}}}. The cluster
        coordinator sums these across engine nodes so BM25 scores with
        GLOBAL document frequencies (single-node-identical ranking;
        semantics target: Vespa's cluster-wide idf in the reference's
        content cluster)."""
        merged: Dict[str, dict] = {}
        for shard in self._shards(index_name):
            with shard.lock:
                fields = (searchable_fields if searchable_fields is not None
                          else list(shard.lexical))
                for field in fields:
                    idx = shard.lexical.get(field)
                    if idx is None:
                        continue
                    stats = idx.stats(terms)
                    slot = merged.setdefault(
                        field, {"num_docs": 0, "total_length": 0,
                                "df": {t: 0 for t in terms}})
                    slot["num_docs"] += stats["num_docs"]
                    slot["total_length"] += stats["total_length"]
                    for t, df in stats["df"].items():
                        slot["df"][t] = slot["df"].get(t, 0) + int(df)
        return merged

    def query_hybrid(self, index_name: str, vector, or_phrases: List[str],
                     and_phrases: List[str], limit: int, offset: int = 0,
                     retrieval_method: str = "disjunction",
                     ranking_method: str = "rrf",
                     alpha: float = 0.5, rrf_k: int = 60,
                     searchable_fields_tensor: Optional[List[str]] = None,
                     searchable_fields_lexical: Optional[List[str]] = None,
                     search_filter: Optional[SearchFilter] = None,
                     score_modifiers_tensor: Optional[List[ScoreModifier]] = None,
                     score_modifiers_lexical: Optional[List[ScoreModifier]] = None,
                     ef_search: Optional[int] = None,
                     approximate: bool = True,
                     attributes_to_retrieve: Optional[List[str]] = None,
                     expose_facets: bool = False,
                     global_stats: Optional[dict] = None) -> QueryResult:
        """Hybrid retrieval + fusion (HybridSearcher.java semantics)."""
        max_leg = limit + offset

        tensor_scores: Dict[str, Tuple[float, Optional[dict]]] = {}
        lexical_scores: Dict[str, float] = {}

        if retrieval_method in ("disjunction", "tensor"):
            query = np.asarray(vector, dtype=np.float32)
            tensor_scores = self._tensor_leg(
                index_name, query, searchable_fields_tensor, search_filter,
                ef_search, max_leg, approximate=approximate)
            if score_modifiers_tensor:
                tensor_scores = {
                    d: (self._modify_score(index_name, d, s, score_modifiers_tensor), h)
                    for d, (s, h) in tensor_scores.items()}
        if retrieval_method in ("disjunction", "lexical"):
            lexical_raw = self._lexical_leg(
                index_name, or_phrases, and_phrases,
                searchable_fields_lexical, search_filter,
                global_stats=global_stats)
            lexical_scores = {d: s for d, (s, _) in lexical_raw.items()}
            if score_modifiers_lexical:
                lexical_scores = {
                    d: self._modify_score(index_name, d, s, score_modifiers_lexical)
                    for d, s in lexical_scores.items()}

        if retrieval_method == "tensor" and ranking_method == "lexical":
            # retrieve by tensor TOP-K, rank those docs by lexical score.
            # The truncation is the whole point of the mode: the exact
            # path scores every row, and without it the result degrades
            # to a pure global lexical ranking (validated combinations
            # attach score_modifiers_lexical to the RANKING leg here —
            # hybrid_parameters _validate_combinations)
            top_tensor = sorted(tensor_scores.items(),
                                key=lambda kv: -kv[1][0])[:max_leg]
            lexical_raw = self._lexical_leg(
                index_name, or_phrases, and_phrases,
                searchable_fields_lexical, search_filter,
                global_stats=global_stats)
            scored = {}
            for d, (_s, h) in top_tensor:
                lex = lexical_raw.get(d, (0.0, None))[0]
                if score_modifiers_lexical:
                    lex = self._modify_score(index_name, d, lex,
                                             score_modifiers_lexical)
                scored[d] = (lex, h)
            return self._finalize(index_name, scored, limit, offset, None,
                                  attributes_to_retrieve, expose_facets,
                                  leg="hybrid")
        if retrieval_method == "lexical" and ranking_method == "tensor":
            # retrieve by lexical TOP-K, rank those docs by tensor score
            # (with the ranking leg's score modifiers applied)
            top_lexical = sorted(lexical_scores.items(),
                                 key=lambda kv: -kv[1])[:max_leg]
            query = np.asarray(vector, dtype=np.float32)
            tensor_raw = self._tensor_leg(
                index_name, query, searchable_fields_tensor, search_filter,
                ef_search, None, approximate=approximate)
            scored = {}
            for d, _s in top_lexical:
                ts, h = tensor_raw.get(d, (0.0, None))
                if score_modifiers_tensor:
                    ts = self._modify_score(index_name, d, ts,
                                            score_modifiers_tensor)
                scored[d] = (ts, h)
            return self._finalize(index_name, scored, limit, offset, None,
                                  attributes_to_retrieve, expose_facets,
                                  leg="hybrid")
        if retrieval_method == ranking_method == "tensor":
            return self._finalize(index_name, tensor_scores, limit, offset,
                                  None, attributes_to_retrieve, expose_facets,
                                  leg="tensor")
        if retrieval_method == ranking_method == "lexical":
            scored = {d: (s, None) for d, s in lexical_scores.items()}
            return self._finalize(index_name, scored, limit, offset, None,
                                  attributes_to_retrieve, expose_facets,
                                  leg="lexical")

        # disjunction + RRF (reference rrf(), HybridSearcher.java:154-285).
        # Fusion pool is max(limit+offset, ef default): truncating the leg
        # rankings to exactly limit+offset would make page N of the fused
        # list disagree with the same slice of a larger query (a doc in
        # one leg's top-k but just outside the other's loses its second
        # contribution) — reference pagination tests pin page/full
        # equality (test_pagination_hybrid)
        from marqo_tpu_torch.api import configs
        pool = max(max_leg, configs.read_env_vars_and_defaults_ints(
            "MARQO_DEFAULT_EF_SEARCH") or 2000)
        tensor_ranked = sorted(tensor_scores.items(),
                               key=lambda kv: -kv[1][0])[:pool]
        lexical_ranked = sorted(lexical_scores.items(),
                                key=lambda kv: -kv[1])[:pool]
        fused: Dict[str, float] = defaultdict(float)
        raw_tensor: Dict[str, float] = {}
        raw_lexical: Dict[str, float] = {}
        highlights: Dict[str, Optional[dict]] = {}
        for rank, (doc_id, (score, highlight)) in enumerate(tensor_ranked):
            if alpha > 0:
                # a zero-weighted leg contributes NOTHING: alpha=0 must
                # return exactly the lexical result set (reference
                # test_hybrid_search_disjunction_rrf_zero_alpha)
                fused[doc_id] += alpha * (1.0 / (rank + 1 + rrf_k))
            raw_tensor[doc_id] = score
            highlights[doc_id] = highlight
        for rank, (doc_id, score) in enumerate(lexical_ranked):
            if alpha < 1:
                fused[doc_id] += (1.0 - alpha) * (1.0 / (rank + 1 + rrf_k))
            raw_lexical[doc_id] = score

        scored = {d: (s, highlights.get(d)) for d, s in fused.items()}
        result = self._finalize(index_name, scored, limit, offset, None,
                                attributes_to_retrieve, expose_facets,
                                leg="hybrid")
        for hit in result.hits:
            hit.raw_tensor_score = raw_tensor.get(hit.doc_id)
            hit.raw_lexical_score = raw_lexical.get(hit.doc_id)
        return result

    # -- legs --

    # below this corpus size, exact numpy scoring beats graph traversal
    APPROX_MIN_ROWS = 1024

    def _tensor_leg(self, index_name: str, query: np.ndarray,
                    searchable_fields: Optional[List[str]],
                    search_filter: Optional[SearchFilter],
                    ef_search: Optional[int],
                    max_hits: Optional[int],
                    approximate: bool = True) -> Dict[str, Tuple[float, dict]]:
        """Per-doc max chunk closeness over searched tensor fields
        (reference: per-field nearestNeighbor legs OR'd,
        structured_vespa_index.py:672-688; max aggregation). Approximate
        mode routes through the native HNSW once the field is large enough;
        exact mode is a full matrix scan."""
        shards = self._shards(index_name)
        best: Dict[str, float] = {}
        best_chunk: Dict[str, dict] = {}
        for shard in shards:
            with shard.lock:
                allowed = shard.allowed_docs(search_filter)
                # [] means "search zero fields" — only None means all
                # (reference test_pagination_empty_searchable_attributes)
                fields = (searchable_fields if searchable_fields is not None
                          else list(shard.tensors))
                for field in fields:
                    ts = shard.tensors.get(field)
                    if ts is None:
                        continue
                    metric = ts.metric
                    if approximate and max_hits is not None and \
                            ts.vector_count >= self.APPROX_MIN_ROWS:
                        result = ts.search_approximate(
                            query,
                            k=min(ts.vector_count, max(max_hits * 4, 64)),
                            ef=(ef_search or 2000),
                            allowed_docs=allowed)
                        if result is not None:
                            rows, dists = result
                            _, doc_ids, chunks, _valid = ts.matrix()
                            scores = _closeness_from_distance(metric, dists)
                            for row, s in zip(rows, scores):
                                doc_id = doc_ids[row]
                                s = float(s)
                                if s > best.get(doc_id, float("-inf")):
                                    best[doc_id] = s
                                    best_chunk[doc_id] = {field: chunks[row]}
                            continue
                    matrix, doc_ids, chunks, valid = ts.matrix()
                    if matrix.shape[0] == 0:
                        continue
                    if max_hits is not None and allowed is None:
                        device_hits = ts.search_exact_device(
                            query, k=max(max_hits * 4, 64))
                        if device_hits is not None:
                            rows, dev_scores = device_hits
                            for row, s in zip(rows, dev_scores):
                                doc_id = doc_ids[row]
                                s = float(s)
                                if s > best.get(doc_id, float("-inf")):
                                    best[doc_id] = s
                                    best_chunk[doc_id] = {field: chunks[row]}
                            continue
                    scores = closeness(metric, query, matrix)
                    for i, doc_id in enumerate(doc_ids):
                        if not valid[i]:
                            continue
                        if allowed is not None and doc_id not in allowed:
                            continue
                        s = float(scores[i])
                        if s > best.get(doc_id, float("-inf")):
                            best[doc_id] = s
                            best_chunk[doc_id] = {field: chunks[i]}
        return {d: (s, best_chunk.get(d)) for d, s in best.items()}

    def _lexical_leg(self, index_name: str, or_phrases: List[str],
                     and_phrases: List[str],
                     searchable_fields: Optional[List[str]],
                     search_filter: Optional[SearchFilter],
                     global_stats: Optional[dict] = None
                     ) -> Dict[str, Tuple[float, None]]:
        """weakAnd optional terms + required phrases; per-doc score = sum of
        per-field bm25 (reference bm25-sum rank profile).

        IDF scope: `global_stats` ({field: {num_docs, total_length, df}})
        makes every shard score with the SAME corpus statistics. The cluster
        coordinator supplies cluster-wide stats; absent that, a multi-shard
        engine aggregates across its own shards, so ranking always equals a
        single-shard index."""
        # wildcard match-all: a lone `*` optional term matches every live
        # document, filters still apply; a quoted "*" stays literal
        # (reference _get_lexical_search_term → YQL `true`,
        # structured_vespa_index.py:811; bm25 of no terms = 0.0)
        if or_phrases == ["*"] and not and_phrases:
            out: Dict[str, Tuple[float, None]] = {}
            for shard in self._shards(index_name):
                with shard.lock:
                    allowed = shard.allowed_docs(search_filter)
                    for doc_id in shard.docs:
                        if allowed is None or doc_id in allowed:
                            out[doc_id] = (0.0, None)
            return out

        terms = [t for phrase in or_phrases for t in tokenize(phrase)]
        if global_stats is None and len(self._shards(index_name)) > 1:
            all_terms = terms + [t for p in and_phrases for t in tokenize(p)]
            global_stats = self.lexical_stats(index_name, all_terms,
                                              searchable_fields)
        doc_scores: Dict[str, float] = defaultdict(float)
        for shard in self._shards(index_name):
            with shard.lock:
                allowed = shard.allowed_docs(search_filter)
                fields = (searchable_fields if searchable_fields is not None
                          else list(shard.lexical))
                # required phrases: doc must contain every phrase in at
                # least one searched field
                required: Optional[Set[str]] = None
                for phrase in and_phrases:
                    phrase_docs: Set[str] = set()
                    for field in fields:
                        idx = shard.lexical.get(field)
                        if idx:
                            phrase_docs |= idx.docs_with_phrase(phrase)
                    required = (phrase_docs if required is None
                                else required & phrase_docs)
                for field in fields:
                    idx = shard.lexical.get(field)
                    if idx is None:
                        continue
                    shard_allowed = allowed
                    if required is not None:
                        shard_allowed = (required if shard_allowed is None
                                         else shard_allowed & required)
                    field_scores = idx.score_terms(
                        terms, shard_allowed,
                        global_stats=(global_stats.get(field)
                                      if global_stats else None))
                    for doc_id, s in field_scores.items():
                        doc_scores[doc_id] += s
                # phrase-only query: every doc matching all phrases scores
                if not terms and and_phrases and required:
                    for doc_id in required:
                        if allowed is None or doc_id in allowed:
                            doc_scores.setdefault(doc_id, 0.0)
                            for phrase in and_phrases:
                                for field in fields:
                                    idx = shard.lexical.get(field)
                                    if idx and doc_id in idx.docs_with_phrase(phrase):
                                        stats = (global_stats.get(field)
                                                 if global_stats else None)
                                        if stats is not None:
                                            doc_scores[doc_id] += sum(
                                                bm25_global_idf(
                                                    stats["num_docs"],
                                                    int(stats["df"].get(t, 0)))
                                                for t in tokenize(phrase))
                                        else:
                                            doc_scores[doc_id] += sum(
                                                idx.idf(t)
                                                for t in tokenize(phrase))
                                        break
        return {d: (s, None) for d, s in doc_scores.items()}

    # -- score modifiers + finalization --

    def _modify_score(self, index_name: str, doc_id: str, score: float,
                      modifiers: List[ScoreModifier]) -> float:
        """new_score = score · Π(mult_field·weight) + Σ(add_field·weight)
        (reference modify() rank expression,
        structured_vespa_schema.py:255-263)."""
        # reference read (no copy): called once per scored doc on the
        # query hot path
        doc = self._get_ref(index_name, doc_id) or {}
        mult = 1.0
        add = 0.0
        for mod in modifiers:
            value = doc.get(mod.field)
            if "." in mod.field and value is None:
                base, _, key = mod.field.partition(".")
                parent = doc.get(base)
                if isinstance(parent, dict):
                    value = parent.get(key)
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            if mod.type == ScoreModifierType.Multiply:
                mult *= value * mod.weight
            else:
                add += value * mod.weight
        return score * mult + add

    def _finalize(self, index_name: str,
                  scored: Dict[str, Tuple[float, Optional[dict]]],
                  limit: int, offset: int,
                  score_modifiers: Optional[List[ScoreModifier]],
                  attributes_to_retrieve: Optional[List[str]],
                  expose_facets: bool, leg: str) -> QueryResult:
        if score_modifiers:
            scored = {
                d: (self._modify_score(index_name, d, s, score_modifiers), h)
                for d, (s, h) in scored.items()}
        ranked = sorted(scored.items(), key=lambda kv: (-kv[1][0], kv[0]))
        total = len(ranked)
        page = ranked[offset:offset + limit]
        hits = []
        for doc_id, (score, highlight) in page:
            doc = self.get(index_name, doc_id) or {}
            if attributes_to_retrieve is not None:
                doc = {k: v for k, v in doc.items()
                       if k in attributes_to_retrieve}
            hit = Hit(doc_id, score, doc, highlight)
            if expose_facets:
                facets = []
                for field, entries in self.get_tensors(index_name, doc_id).items():
                    for e in entries:
                        facets.append({field: e["chunk"],
                                       "_embedding": e["embedding"]})
                hit.fields["_tensor_facets"] = facets
            hits.append(hit)
        return QueryResult(hits, total)
