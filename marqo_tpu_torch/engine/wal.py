"""Write-ahead log for the in-process engine.

Role parity: Vespa's transaction log — the reference's store never loses
acknowledged writes because every mutation is logged before it is applied
(Vespa proton transactionlog). Our engine checkpoints full state every 60s
(store.snapshot), which alone would lose up to 60s of acknowledged feeds
on a crash; the WAL closes that window:

  - every mutation (feed / delete / delete_all / create_index /
    delete_index) appends one framed record BEFORE the caller gets its ack
  - on startup: restore the latest snapshot, then replay the log in order
    (replay is idempotent — feed is an upsert, deletes are idempotent —
    so records already captured by the snapshot are harmless)
  - when a snapshot succeeds the log rotates: current log → .old, snapshot
    runs, .old is dropped; a crash mid-rotation replays .old then current,
    which converges to the same final state

Records are length-prefixed pickles (numpy embeddings stay binary — JSON
would dominate the ingest hot path on 1-core hosts). A truncated tail
(crash mid-append) ends replay cleanly at the last complete record.
"""

import os
import pickle
import struct
import threading
from typing import Iterator, Optional

from marqo_tpu_torch.logging import get_logger

logger = get_logger(__name__)

_MAGIC = b"MQWL"
_HEADER = struct.Struct("<4sI")  # magic + payload length


class WriteAheadLog:
    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.old_path = path + ".old"
        self._fsync = fsync
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # Truncate a torn tail (crash mid-append) BEFORE reopening in
        # append mode: replay stops at the last complete frame, so any
        # record appended after garbage bytes would be unreachable — i.e.
        # every write acked after the restart would be silently lost on
        # the next crash. Frame-level scan (magic + full payload present);
        # torn writes can't produce a complete frame with a bad payload.
        valid = self._valid_prefix_length(self.path)
        if valid is not None:
            logger.warning(
                f"WAL {path}: truncating torn tail at byte {valid} "
                "(crash mid-append)")
            with open(self.path, "r+b") as f:
                f.truncate(valid)
        self._fh = open(self.path, "ab")

    @staticmethod
    def _valid_prefix_length(path: str) -> Optional[int]:
        """Byte length of the longest valid frame prefix, or None when the
        file is absent or already ends on a frame boundary."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return None
        good = 0
        with open(path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if not header:
                    return None if good == size else good
                if len(header) < _HEADER.size:
                    return good
                magic, length = _HEADER.unpack(header)
                if magic != _MAGIC:
                    return good
                if good + _HEADER.size + length > size:
                    return good  # payload torn
                f.seek(length, os.SEEK_CUR)
                good += _HEADER.size + length

    def append(self, record: dict) -> None:
        payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._fh.write(_HEADER.pack(_MAGIC, len(payload)))
            self._fh.write(payload)
            self._fh.flush()
            if self._fsync:
                os.fsync(self._fh.fileno())

    @staticmethod
    def _replay_file(path: str) -> Iterator[dict]:
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                magic, length = _HEADER.unpack(header)
                if magic != _MAGIC:
                    logger.warning(f"WAL {path}: bad frame magic — "
                                   "stopping replay at last good record")
                    break
                payload = f.read(length)
                if len(payload) < length:
                    break  # torn tail from a crash mid-append
                try:
                    yield pickle.loads(payload)
                except Exception as e:
                    logger.warning(f"WAL {path}: undecodable record ({e}) — "
                                   "stopping replay")
                    break

    def replay(self) -> Iterator[dict]:
        """All records in order: the pre-rotation log (if a crash happened
        between rotation and cleanup), then the current log."""
        yield from self._replay_file(self.old_path)
        yield from self._replay_file(self.path)

    def rotate_begin(self) -> None:
        """Move the current log aside before a snapshot. Mutations keep
        flowing into a fresh log; the snapshot will capture everything in
        the .old file (those ops were applied before rotation)."""
        with self._lock:
            self._fh.close()
            try:
                # a leftover .old from an interrupted rotation is already
                # reflected in engine state (ops were applied) — fold it
                # in by concatenation so no acknowledged write is dropped
                if os.path.exists(self.old_path):
                    import shutil
                    with open(self.old_path, "ab") as dst, \
                            open(self.path, "rb") as src:
                        shutil.copyfileobj(src, dst)  # constant memory
                    os.remove(self.path)
                else:
                    os.replace(self.path, self.old_path)
            finally:
                # ALWAYS leave an open handle: a failure above (disk full
                # mid-copy) must not turn every subsequent append into
                # 'I/O operation on closed file' until the next rotation.
                # A partially-copied prefix living in both files replays
                # twice — harmless, replay is idempotent by design.
                self._fh = open(self.path, "ab")

    def rotate_commit(self) -> None:
        """Snapshot succeeded: drop the pre-rotation log."""
        with self._lock:
            try:
                os.remove(self.old_path)
            except FileNotFoundError:
                pass

    def size_bytes(self) -> int:
        with self._lock:
            try:
                return os.path.getsize(self.path) + (
                    os.path.getsize(self.old_path)
                    if os.path.exists(self.old_path) else 0)
            except OSError:
                return 0

    def close(self) -> None:
        with self._lock:
            self._fh.close()


# engine_dir → (engine, wal): the snapshot daemon reads the CURRENT
# registration each tick, so re-running setup (config rebuilds, tests)
# swaps the engine the daemon persists instead of leaving a stale daemon
# rotating the live WAL against a dead engine
_ACTIVE: dict = {}
_ACTIVE_LOCK = threading.Lock()


def setup_engine_durability(engine, data_dir: str,
                            snapshot_interval_s: int = 60) -> Optional[
                                WriteAheadLog]:
    """Shared durability bootstrap for any process hosting a StoreEngine
    (the API's in-process mode AND the standalone engine server): restore
    the latest snapshots, replay the WAL, attach it, and start the
    rotate→snapshot→commit daemon. Returns the WAL (None when disabled)."""
    import threading

    from marqo_tpu_torch.api import configs

    engine_dir = os.path.join(str(data_dir), "engine_data")
    try:
        restored = engine.restore(engine_dir)
        if restored:
            logger.info(f"Restored {restored} documents from {engine_dir}")
    except Exception as e:
        logger.warning(f"Engine restore failed: {e}")

    wal = None
    wal_path = os.path.join(engine_dir, "wal.log")
    wal_enabled = str(configs.read_env_vars_and_defaults(
        "MARQO_ENGINE_WAL")).upper() != "FALSE"
    # Construct + replay + swap UNDER the registry lock: a previously
    # registered daemon for this dir must not rotate the OLD WriteAheadLog
    # (same file paths, separate handle) while the new one is being built —
    # os.replace would move wal.log out from under the new handle and
    # rotate_commit would then delete records appended through it. The
    # daemon holds the same lock for its whole tick.
    with _ACTIVE_LOCK:
        if wal_enabled:
            for attempt in (1, 2):  # one retry: a transient open/replay
                try:                # error must not quarantine acked writes
                    wal = WriteAheadLog(
                        wal_path,
                        fsync=str(configs.read_env_vars_and_defaults(
                            "MARQO_ENGINE_WAL_FSYNC")).upper() == "TRUE")
                    replayed = engine.replay_wal(wal)
                    if replayed:
                        logger.info(f"Replayed {replayed} WAL records")
                    engine.attach_wal(wal)
                    break
                except Exception as e:
                    if wal is not None:
                        try:
                            wal.close()
                        except Exception:
                            pass
                    wal = None
                    logger.warning(
                        f"WAL open/replay failed (attempt {attempt}): {e}")
        if wal is None:
            # quarantine any leftover log: snapshots will keep advancing
            # with no rotation, and replaying these records over a FUTURE
            # snapshot (next WAL-enabled run) would resurrect deleted/
            # overwritten docs
            for leftover in (wal_path, wal_path + ".old"):
                if os.path.exists(leftover):
                    try:
                        os.replace(leftover, leftover + ".stale")
                        logger.warning(f"Quarantined stale WAL {leftover} "
                                       f"(WAL disabled this run)")
                    except OSError as e:
                        # e.g. read-only FS: degrade to snapshots-only
                        # rather than crashing startup
                        logger.error(f"Could not quarantine {leftover}: "
                                     f"{e}")
            if wal_enabled:
                logger.warning("WAL unavailable; snapshots only")
        start_daemon = engine_dir not in _ACTIVE
        _ACTIVE[engine_dir] = (engine, wal)

    # the exact scan's device comes up here, before the server binds its
    # port, never inside a search; a failure fails the start
    from marqo_tpu_torch.engine.torch_scorer import bring_up_engine
    bring_up_engine(engine)

    def snapshot_loop():
        import time as _time
        while True:
            _time.sleep(snapshot_interval_s)
            # the whole tick runs under the registry lock so a concurrent
            # setup_engine_durability re-run (config rebuilds, tests) can
            # never interleave with a rotation on the outgoing WAL object
            with _ACTIVE_LOCK:
                current = _ACTIVE.get(engine_dir)
                if current is None:
                    return
                cur_engine, cur_wal = current
                try:
                    # rotate first: the snapshot covers every op in the
                    # rotated-out log, so committing drops only records the
                    # snapshot persists (a crash in between replays .old +
                    # current — idempotent)
                    if cur_wal is not None:
                        cur_wal.rotate_begin()
                    cur_engine.snapshot(engine_dir)
                    if cur_wal is not None:
                        cur_wal.rotate_commit()
                except Exception as e:
                    logger.warning(f"Engine snapshot failed: {e}")

    if start_daemon:
        threading.Thread(target=snapshot_loop, daemon=True,
                         name=f"engine-snapshot::{engine_dir}").start()
    return wal
