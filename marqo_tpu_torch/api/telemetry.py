"""Request-scoped telemetry: named timers and counters per request, and,
for a request that asks for it, spans on the wall clock.

Parity: reference src/marqo/tensor_search/telemetry.py —
RequestMetricsStore with time()/start()/stop()/increment_counter (:48-117),
per-request registration keyed by request object (:119-152), and the
middleware that injects a ``telemetry`` block into the response JSON when
the request has ``?telemetry=true`` (:154-218). Thread-local here instead
of a Request-keyed dict: our framework dispatches one request per thread.

A request with ``?telemetry=true`` is traced, and then:

- every span its timers time (``time()``, ``start()``/``stop()``) goes to
  the process's span log (``spans()``): its request's id, its name, the
  span open below it on the same thread, the thread, and its start and end
  in ``time.time_ns()``'s nanoseconds, the clock torch.profiler stamps its
  events on, so that spans line up with a trace without being in it;
- the stage sites that time traced requests alone run (``span()``,
  ``summed()``, ``locked()``): the add path's stages and the engine's
  per-document timers;
- while any traced request is in flight a ``gc.callbacks`` hook times each
  collection on a traced request's thread as ``gc.pause`` (logged with its
  generation) and counts the full ones as ``gc.collections.gen2``;
- a counter kept per part (the tokens each (layer, expert) of a mixture of
  experts took) goes to the process's count log (``record_counts``,
  ``counts()``) with its request's id and its time on ``time.time_ns()``.

Outside a traced request each stage site costs one check of ``tracing``.
"""

import gc
import itertools
import threading
import time
from collections import deque, namedtuple
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

from marqo_tpu_torch.logging import get_logger

logger = get_logger(__name__)

# One entry of the span log. ``parent`` is None for a thread's outermost
# span; ``generation`` is set on ``gc.pause`` alone.
Span = namedtuple("Span", "request name parent thread start_ns end_ns "
                          "generation", defaults=(None,))

# True while at least one traced request is in flight
tracing = False

_NO_SPAN = nullcontext()


class SpanLog:
    """A bounded in-memory log of spans: a ring of ``size`` entries that
    drops its oldest when full and counts what it dropped."""

    def __init__(self, size: int = 65_536):
        self._ring = deque(maxlen=size)
        # reentrant: an allocation inside ``append`` can start a collection,
        # whose hook appends its ``gc.pause`` on the same thread
        self._lock = threading.RLock()
        self._appended = 0

    def append(self, span: Span) -> None:
        with self._lock:
            self._appended += 1
            self._ring.append(span)

    def entries(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._appended - len(self._ring)


_log = SpanLog()


def spans() -> List[Span]:
    """The spans of traced requests, oldest first (the newest 65,536)."""
    return _log.entries()


def dropped_spans() -> int:
    """How many spans the log has dropped, oldest first, to stay bounded."""
    return _log.dropped


# One entry of the count log: a traced request's counter kept per part
# (an array), stamped on time.time_ns()
Counts = namedtuple("Counts", "request name time_ns values")

_counts = SpanLog(4096)


def record_counts(metrics: "RequestMetrics", name: str, values) -> None:
    """Logs the per-part counter ``name`` (an array) of the traced request
    ``metrics``."""
    _counts.append(Counts(metrics.request_id, name, time.time_ns(), values))


def counts(name: str) -> list:
    """The logged entries of the per-part counter ``name``, oldest first
    (the newest 4,096 of every counter)."""
    return [entry for entry in _counts.entries() if entry.name == name]


class RequestMetrics:
    def __init__(self, request_id: int = 0, traced: bool = False):
        self.request_id = request_id
        self.traced = traced
        self.times: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        # per thread, the open spans: (name, perf_counter, time_ns)
        self._open: Dict[int, list] = {}

    @contextmanager
    def time(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def start(self, name: str) -> None:
        stack = self._open.setdefault(threading.get_ident(), [])
        started = time.perf_counter()
        stack.append((name, started, time.time_ns() if self.traced else 0))

    def stop(self, name: str) -> Optional[float]:
        stack = self._open.get(threading.get_ident(), [])
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                break
        else:
            # reference telemetry.py: "timer {k} stopped incorrectly. ..."
            logger.warning(
                f"timer {name} stopped incorrectly. Time not recorded.")
            return None
        _name, started, wall = stack.pop(i)
        return self._record(name, started, wall,
                            stack[i - 1][0] if i else None)

    def _record(self, name: str, started: float, wall: int,
                parent: Optional[str], generation: Optional[int] = None):
        """Adds the span from ``started`` (perf_counter) to now to the
        ``name`` timer; logs it where the request is traced, its end
        ``wall`` (time_ns at its start) plus its length."""
        elapsed = time.perf_counter() - started
        elapsed_ms = elapsed * 1000
        self.times[name] = self.times.get(name, 0.0) + elapsed_ms
        if self.traced:
            _log.append(Span(self.request_id, name, parent,
                             threading.get_ident(), wall,
                             wall + int(elapsed * 1e9), generation))
        return elapsed_ms

    def add_time(self, name: str, value_ms: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + value_ms

    def increment_counter(self, name: str, value: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def json(self) -> dict:
        # Both keys always present (reference RequestMetrics.json()).
        return {"counter": dict(self.counters),
                "timesMs": dict(self.times)}


class RequestMetricsStore:
    """Thread-scoped registry of the in-flight request's metrics."""

    _local = threading.local()
    _ids = itertools.count(1)
    _lock = threading.Lock()
    _traced_in_flight = 0

    @classmethod
    def for_request(cls) -> RequestMetrics:
        metrics = getattr(cls._local, "metrics", None)
        if metrics is None:
            metrics = RequestMetrics(next(cls._ids))
            cls._local.metrics = metrics
        return metrics

    @classmethod
    def set_in_request(cls, traced: bool = False) -> RequestMetrics:
        """A new request on this thread, with an id of its own; ``traced``
        where it asked for telemetry."""
        cls.clear()
        cls._local.metrics = RequestMetrics(next(cls._ids), traced)
        if traced:
            cls._trace_begins()
        return cls._local.metrics

    @classmethod
    def clear(cls) -> None:
        metrics = getattr(cls._local, "metrics", None)
        cls._local.metrics = None
        if metrics is not None and metrics.traced:
            cls._trace_ends()

    @classmethod
    def _trace_begins(cls) -> None:
        global tracing
        with cls._lock:
            cls._traced_in_flight += 1
            if cls._traced_in_flight == 1:
                gc.callbacks.append(_on_collection)
                tracing = True

    @classmethod
    def _trace_ends(cls) -> None:
        global tracing
        with cls._lock:
            cls._traced_in_flight -= 1
            if cls._traced_in_flight == 0:
                tracing = False
                gc.callbacks.remove(_on_collection)


def traced() -> Optional[RequestMetrics]:
    """The calling thread's request metrics where that request is traced,
    else None."""
    if not tracing:
        return None
    metrics = getattr(RequestMetricsStore._local, "metrics", None)
    return metrics if metrics is not None and metrics.traced else None


def span(name: str):
    """A span ``name`` on the calling thread's traced request (timed and
    logged); a no-op outside one."""
    metrics = traced() if tracing else None
    return metrics.time(name) if metrics is not None else _NO_SPAN


class _Summed:
    """Adds the time of a block to a request's timer, unlogged."""

    def __init__(self, metrics: RequestMetrics, name: str):
        self.metrics, self.name = metrics, name

    def __enter__(self):
        self.started = time.perf_counter()

    def __exit__(self, *exc):
        self.metrics.add_time(self.name,
                              (time.perf_counter() - self.started) * 1000)
        return False


class _TimedLock:
    """Holds ``lock`` for a block; the wait to acquire it is added to a
    request's timer, unlogged."""

    def __init__(self, metrics: RequestMetrics, name: str, lock):
        self.metrics, self.name, self.lock = metrics, name, lock

    def __enter__(self):
        started = time.perf_counter()
        self.lock.acquire()
        self.metrics.add_time(self.name,
                              (time.perf_counter() - started) * 1000)

    def __exit__(self, *exc):
        self.lock.release()
        return False


def summed(name: str):
    """Times a block into the calling thread's traced request's ``name``
    timer without logging it: for per-document stages, too many to log. A
    no-op outside a traced request."""
    metrics = traced() if tracing else None
    return _Summed(metrics, name) if metrics is not None else _NO_SPAN


def locked(lock, name: str):
    """``lock`` to hold for a block; on a traced request the wait to
    acquire it is summed into the ``name`` timer, unlogged."""
    metrics = traced() if tracing else None
    return _TimedLock(metrics, name, lock) if metrics is not None else lock


_gc_started = threading.local()


def _on_collection(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection on a traced request's thread,
    from start to stop, as a ``gc.pause`` span under that thread's open
    span."""
    metrics = traced()
    if metrics is None:
        return
    if phase == "start":
        _gc_started.at = (time.perf_counter(), time.time_ns())
        return
    started = getattr(_gc_started, "at", None)
    if started is None:
        return
    _gc_started.at = None
    stack = metrics._open.get(threading.get_ident())
    metrics._record("gc.pause", started[0], started[1],
                    stack[-1][0] if stack else None, info["generation"])
    if info["generation"] == 2:
        metrics.increment_counter("gc.collections.gen2")
