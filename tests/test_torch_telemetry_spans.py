"""The port's request telemetry as a span recorder
(marqo_tpu_torch/api/telemetry.py), on the CPU:

(a) a request without ``?telemetry=true`` logs nothing, runs no
    per-document timer and installs no collector hook, and keeps the
    always-on timers; a traced one logs each span with its request's id
    and its parent, and its stages' timers come back in ``timesMs``;
(b) spans share torch.profiler's clock: a span around an aten op brackets
    the op's kineto interval;
(c) ``graphs.captured`` and ``inference.graph_capture`` count one capture
    and nothing on replay, which is an ``inference.dispatch``;
(d) collections on a traced request's thread are ``gc.pause`` spans;
(e) the span log is a ring that drops its oldest entries and counts them.
"""

import gc
import json
import threading

import pytest
import torch

from marqo_tpu_torch.api import telemetry
from marqo_tpu_torch.api.telemetry import (RequestMetricsStore, Span,
                                           SpanLog)
from marqo_tpu_torch.engine.store import StoreEngine
from marqo_tpu_torch.inference import graphs
from marqo_tpu_torch.inference import vectorise as inference
from tests.test_torch_encoder_graphs import StandIn, _forward, _x

STAGES = {"add_documents.plan", "inference.tokenize", "inference.pack",
          "inference.device_wait", "inference.to_lists"}
PER_DOCUMENT = {"engine.lock_wait", "engine.feed.lexical"}
ALWAYS_ON = {"wholeRequest", "add_documents.vectorise",
             "add_documents.engine._bulk"}


@pytest.fixture(scope="module")
def app():
    from marqo_tpu_torch.api.app import build_app, on_start
    from marqo_tpu_torch.config import Config
    with pytest.MonkeyPatch.context() as env:
        env.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
        env.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
        inference.clear_loaded_models()
        config = Config()
        on_start(config)
        app = build_app(config)
        assert call(app, "POST", "/indexes/spans", {"model": "test"})
        yield app
        config.index_meta_cache.stop_refresh_thread()
        inference.clear_loaded_models()


def call(app, method, path, body=None):
    response = app.dispatch(method, path,
                            json.dumps(body).encode() if body else b"", {})
    assert response.status == 200, (response.status, response.body)
    return response.body


def add(app, first, n, traced):
    docs = [{"_id": f"doc{first + i}", "title": f"title number {i}",
             "body": f"A first sentence of document {i}. A second one. "
                     f"And a third sentence, longer than both."}
            for i in range(n)]
    return call(app, "POST", "/indexes/spans/documents" +
                ("?telemetry=true" if traced else ""),
                {"documents": docs, "tensorFields": ["title", "body"]})


def new_spans(before):
    return telemetry.spans()[len(before):]


def watch_feed(monkeypatch):
    """Records, at each document's feed, the request's metrics, whether
    the collector hook is in and whether tracing is on."""
    seen = []
    feed = StoreEngine.feed

    def watched(self, *args, **kwargs):
        seen.append((RequestMetricsStore.for_request(),
                     telemetry._on_collection in gc.callbacks,
                     telemetry.tracing))
        return feed(self, *args, **kwargs)

    monkeypatch.setattr(StoreEngine, "feed", watched)
    return seen


# --- (a) untraced and traced requests ----------------------------------------

def test_an_untraced_add_logs_nothing_and_runs_no_stage_timer(app,
                                                              monkeypatch):
    add(app, 0, 4, traced=False)  # the model loads
    seen = watch_feed(monkeypatch)
    before = telemetry.spans()
    body = add(app, 100, 6, traced=False)
    assert body["errors"] is False and "telemetry" not in body
    assert telemetry.spans() == before
    assert len(seen) == 6
    metrics = seen[0][0]
    assert not metrics.traced
    assert not any(hooked or tracing for _, hooked, tracing in seen)
    assert ALWAYS_ON - {"wholeRequest"} <= set(metrics.times)
    assert not (STAGES | PER_DOCUMENT) & set(metrics.times)
    assert telemetry._on_collection not in gc.callbacks


def test_a_traced_add_logs_each_span_with_its_request_and_parent(
        app, monkeypatch):
    add(app, 0, 4, traced=False)
    seen = watch_feed(monkeypatch)
    before = telemetry.spans()
    body = add(app, 200, 6, traced=True)
    assert body["errors"] is False
    times = body["telemetry"]["timesMs"]
    assert ALWAYS_ON | STAGES | PER_DOCUMENT <= set(times)
    assert all(hooked and tracing for _, hooked, tracing in seen)
    # the hook and the flag go with the last traced request
    assert telemetry._on_collection not in gc.callbacks
    assert telemetry.tracing is False

    logged = new_spans(before)
    assert len({s.request for s in logged}) == 1
    names = {s.name for s in logged}
    assert ALWAYS_ON | STAGES <= names
    assert not PER_DOCUMENT & names  # summed, not logged
    parents = {s.name: s.parent for s in logged if s.name != "gc.pause"}
    assert parents["wholeRequest"] is None
    assert parents["add_documents.plan"] == "wholeRequest"
    assert parents["add_documents.vectorise"] == "wholeRequest"
    assert parents["inference.tokenize"] == "add_documents.vectorise"
    assert parents["inference.device_wait"] == "add_documents.vectorise"
    # each span lies inside a span of its parent's name on its thread, and
    # its timer is the sum of its logged spans
    for s in logged:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert any(p.name == s.parent and p.thread == s.thread and
                       p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
                       for p in logged), s
    for name in ALWAYS_ON | STAGES:
        logged_ms = sum(s.end_ns - s.start_ns for s in logged
                        if s.name == name) / 1e6
        assert logged_ms == pytest.approx(times[name], rel=1e-3, abs=1e-3)


def test_requests_take_ids_of_their_own():
    first = RequestMetricsStore.set_in_request()
    second = RequestMetricsStore.set_in_request(traced=True)
    try:
        assert second.request_id > first.request_id
        assert telemetry.tracing and telemetry.traced() is second
    finally:
        RequestMetricsStore.clear()
    assert not telemetry.tracing and telemetry.traced() is None


# --- (b) the profiler's clock ------------------------------------------------

def test_a_span_brackets_the_profilers_interval_of_its_op():
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    metrics = RequestMetricsStore.set_in_request(traced=True)
    before = telemetry.spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with metrics.time("matmul"):
                    torch.mm(a, b)
    finally:
        RequestMetricsStore.clear()
    spans = [s for s in new_spans(before) if s.name == "matmul"]
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    assert len(spans) == len(ops) == 3
    for span, (start, end) in zip(spans, ops):
        assert span.start_ns <= start <= end <= span.end_ns, (span, start,
                                                              end)


# --- (c) graph captures ------------------------------------------------------

@pytest.mark.parametrize("traced", [False, True])
def test_a_capture_counts_once_and_a_replay_is_a_dispatch(traced):
    cache = graphs.EncoderGraphs("cpu", capture=StandIn())
    metrics = RequestMetricsStore.set_in_request(traced=traced)
    try:
        cache.run("text", torch.bfloat16, _forward, _x(0))
        captured = dict(metrics.counters), dict(metrics.times)
        cache.run("text", torch.bfloat16, _forward, _x(1))
    finally:
        RequestMetricsStore.clear()
    if not traced:
        assert metrics.counters == {} and metrics.times == {}
        return
    counters, times = captured
    assert counters == {"graphs.captured": 1}
    assert set(times) == {"inference.graph_capture"}
    assert metrics.counters == {"graphs.captured": 1}
    assert set(metrics.times) == {"inference.graph_capture",
                                  "inference.dispatch"}


# --- (d) the collector -------------------------------------------------------

def test_collections_on_a_traced_thread_are_gc_pauses():
    metrics = RequestMetricsStore.set_in_request(traced=True)
    before = telemetry.spans()
    try:
        assert telemetry._on_collection in gc.callbacks
        with metrics.time("outer"):
            gc.collect()
        # a collection on a thread of no traced request is not the
        # request's
        other = threading.Thread(target=gc.collect)
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
    finally:
        RequestMetricsStore.clear()
    assert telemetry._on_collection not in gc.callbacks
    pauses = [s for s in new_spans(before) if s.name == "gc.pause"]
    full = [s for s in pauses if s.generation == 2]
    assert len(full) == 1 and full[0].parent == "outer"
    assert {s.thread for s in pauses} == {threading.get_ident()}
    assert metrics.counters == {"gc.collections.gen2": 1}
    assert metrics.times["gc.pause"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in pauses) / 1e6, abs=1e-3)


# --- (e) the ring ------------------------------------------------------------

def test_the_ring_drops_its_oldest_entries_and_counts_them():
    log = SpanLog(size=4)
    entries = [Span(1, f"s{i}", None, 0, i, i + 1) for i in range(6)]
    for entry in entries:
        log.append(entry)
    assert log.entries() == entries[2:]
    assert log.dropped == 2
    assert telemetry.dropped_spans() >= 0
