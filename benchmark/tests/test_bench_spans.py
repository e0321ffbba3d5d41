"""The program's stage spans in the benchmark: the join of spans with a
trace's device intervals (harness/spans.py) on synthetic intervals, and a
tiny traced run on the CPU reporting each stage metric."""

import json

import pytest

from harness import spans
from harness.trace import Trace
from tiny import run_cell

STAGE_SHARES = ["plan_share.ingest", "tokenize_share.ingest",
                "device_wait_share.ingest", "to_lists_share.ingest",
                "lexical_share.ingest", "lock_wait_share.ingest",
                "gc_share.ingest"]


class S:
    """A span as the program logs it."""

    def __init__(self, name, start, end, thread=1, parent=None):
        self.name, self.start_ns, self.end_ns = name, start, end
        self.thread, self.parent = thread, parent


def trace(device, host=(("host", 0, 100),)):
    return Trace([("k", a, b) for a, b in device], list(host), 1.0)


def test_idle_intervals_complement_the_busy_union():
    t = trace([(10, 20), (15, 30), (50, 60)])
    assert spans.busy_intervals(t) == [[10, 30], [50, 60]]
    assert spans.idle_intervals(t) == [(0, 10), (30, 50), (60, 100)]


def test_idle_share_of_a_stage():
    t = trace([(10, 20), (50, 60)])
    waits = [S("inference.device_wait", 0, 20),     # 10 idle of 20
             S("inference.device_wait", 40, 60),    # 10 idle of 20
             S("inference.device_wait", 200, 300),  # after the trace
             S("inference.tokenize", 20, 50)]
    assert spans.idle_share(t, waits, "inference.device_wait") == 50.0
    assert spans.idle_share(t, waits, "inference.pack") is None
    assert spans.idle_share(trace([]), waits, "inference.device_wait") \
        is None
    assert spans.idle_share(None, waits, "inference.device_wait") is None


def test_a_gap_goes_to_the_innermost_span_of_each_moment():
    # device busy 0-10 and 90-100: one gap, 10-90
    t = trace([(0, 10), (90, 100)])
    logged = [S("wholeRequest", 5, 80),
              S("add_documents.vectorise", 20, 70, parent="wholeRequest"),
              S("inference.tokenize", 20, 30,
                parent="add_documents.vectorise"),
              S("gc.pause", 40, 50, parent="add_documents.vectorise"),
              S("inference.device_wait", 60, 70,
                parent="add_documents.vectorise"),
              S("other.thread", 60, 65, thread=2)]
    ((seconds, cover),) = spans.idle_gaps(t, logged)
    assert seconds == pytest.approx(80e-9)
    ns = {label: round(s * 1e9) for label, s in cover.items()}
    assert ns == {"wholeRequest": 20, "inference.tokenize": 10,
                  "add_documents.vectorise": 20, "gc.pause": 10,
                  "inference.device_wait + other.thread": 5,
                  "inference.device_wait": 5, spans.NO_SPAN: 10}
    assert sum(ns.values()) == 80
    by_stage = spans.idle_by_stage(t, logged)
    assert round(sum(by_stage.values()) * 1e9) == 80


def test_the_longest_gaps_come_first():
    t = trace([(0, 10), (20, 30), (60, 70), (71, 80)])
    gaps = spans.idle_gaps(t, [], count=2)
    assert [round(g[0] * 1e9) for g in gaps] == [30, 10]
    assert gaps[0][1] == {spans.NO_SPAN: pytest.approx(30e-9)}


class Window:
    def __init__(self, timers):
        self._timers = timers

    def timers(self, name):
        return [t[name] for t in self._timers if name in t]


def test_a_program_without_stage_spans_reads_none():
    parent = Window([{"wholeRequest": 80.0, "add_documents.vectorise": 50.0}])
    assert spans.share(parent, "inference.tokenize") is None
    assert spans.timer_sum(parent, "inference.graph_capture") is None
    change = Window([{"wholeRequest": 80.0, "add_documents.plan": 4.0,
                      "inference.tokenize": 8.0}])
    assert spans.share(change, "inference.tokenize") == 10.0
    assert spans.share(change, "gc.pause") == 0.0
    assert spans.timer_sum(change, "inference.graph_capture") == 0


def test_a_traced_run_reports_each_stage_metric(capsys):
    rc, line, err = run_cell("e5_base.bulk_ingest", 2147483720, capsys,
                             trace=1)
    assert rc == 0, err[-2000:]
    metrics = json.loads(line)["metrics"]
    for name in STAGE_SHARES:
        assert 0 <= metrics[name]["value"] <= 100, name
        assert metrics[name]["unit"] == "%"
    assert metrics["graph_capture_ms.ingest"]["value"] >= 0
    # on the CPU the trace holds no device operation
    assert "device_wait_idle.ingest" not in metrics
    shares = {name: metrics[name]["value"] for name in STAGE_SHARES}
    assert shares["tokenize_share.ingest"] + \
        shares["device_wait_share.ingest"] + \
        shares["to_lists_share.ingest"] <= \
        metrics["vectorise_share.ingest"]["value"]
    assert shares["lexical_share.ingest"] + shares["lock_wait_share.ingest"] \
        <= metrics["engine_feed_share.ingest"]["value"]
