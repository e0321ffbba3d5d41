"""The program's stage spans, and their join with the traced window.

A traced run's adds carry the program's stage timers in their telemetry
(``timesMs``); the program keeps every span of a traced request in a log
(``marqo_tpu_torch.api.telemetry.spans()``), stamped on ``time.time_ns()``,
the clock torch.profiler stamps its events on. So a span and the trace's
device intervals can be laid side by side: how much of a stage the card
sat idle, and which stage the host was in during each idle gap.

A program without the stage spans (no add carries ``add_documents.plan``,
or no span log) reads None throughout, never 0.
"""

import bisect
from collections import defaultdict

# a stage span every traced add of a program with stage spans carries
MARK = "add_documents.plan"
# where no span is open on any thread
NO_SPAN = "no span"


def timer_sum(window, *names):
    """Σ of the named server timers over the window's adds, in ms; None
    where the program records no stage spans."""
    if not window.timers(MARK):
        return None
    return sum(sum(window.timers(name)) for name in names)


def share(window, *names):
    """Σ of the named timers over Σ ``wholeRequest``, over the window's
    adds, in per cent; None where the program records no stage spans."""
    whole = sum(window.timers("wholeRequest"))
    part = timer_sum(window, *names)
    if not whole or part is None:
        return None
    return 100.0 * part / whole


def program_spans():
    """The program's span log, or None where it keeps none."""
    try:
        from marqo_tpu_torch.api import telemetry
    except ImportError:
        return None
    read = getattr(telemetry, "spans", None)
    return read() if read is not None else None


def bounds(trace):
    """(first, last) ns of the trace's events."""
    ops = trace.device_ops + trace.host_ops
    return min(op[1] for op in ops), max(op[2] for op in ops)


def busy_intervals(trace):
    """The union of the trace's device operations: sorted, disjoint
    [start_ns, end_ns] pairs."""
    out = []
    for _name, start, end in trace.device_ops:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def idle_intervals(trace):
    """The complement of ``busy_intervals`` between the trace's first and
    last event: every stretch in which the card ran nothing."""
    first, last = bounds(trace)
    out, reach = [], first
    for start, end in busy_intervals(trace):
        if start > reach:
            out.append((reach, start))
        reach = max(reach, end)
    if last > reach:
        out.append((reach, last))
    return out


def _overlap_ns(intervals, starts, lo, hi):
    """ns of [lo, hi] under the sorted, disjoint ``intervals`` (``starts``
    their starts)."""
    total = 0
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    while i < len(intervals) and intervals[i][0] < hi:
        total += max(0, min(hi, intervals[i][1]) - max(lo, intervals[i][0]))
        i += 1
    return total


def idle_share(trace, spans, name):
    """Of the time inside spans ``name`` between the trace's first and last
    event, the share in which the card ran nothing, in per cent; None where
    the trace has no device operation or the window no such span."""
    if trace is None or not trace.device_ops:
        return None
    first, last = bounds(trace)
    busy = busy_intervals(trace)
    starts = [b[0] for b in busy]
    inside = idle = 0
    for span in spans:
        if span.name != name:
            continue
        lo, hi = max(span.start_ns, first), min(span.end_ns, last)
        if hi <= lo:
            continue
        inside += hi - lo
        idle += hi - lo - _overlap_ns(busy, starts, lo, hi)
    if not inside:
        return None
    return 100.0 * idle / inside


def innermost_cover(spans, intervals):
    """For each (lo, hi) of the sorted, disjoint ``intervals``, {label: ns}
    of its time by the innermost span open then: on each thread the open
    span that started last (spans of one thread nest), the labels of
    several threads joined by " + ", ``NO_SPAN`` where none is open."""
    covers = [defaultdict(int) for _ in intervals]
    if not intervals:
        return covers
    lo_all, hi_all = intervals[0][0], intervals[-1][1]
    spans = [s for s in spans if s.end_ns > lo_all and s.start_ns < hi_all]
    points = sorted({p for s in spans for p in (s.start_ns, s.end_ns)} |
                    {p for iv in intervals for p in iv})
    starting = defaultdict(list)
    for s in spans:
        starting[s.start_ns].append(s)
    open_spans = []
    k = 0
    for left, right in zip(points, points[1:]):
        open_spans = [s for s in open_spans if s.end_ns > left]
        open_spans.extend(s for s in starting.get(left, ())
                          if s.end_ns > left)
        while k < len(intervals) and intervals[k][1] <= left:
            k += 1
        if k == len(intervals):
            break
        if right <= intervals[k][0]:
            continue
        inner = {}
        for s in open_spans:
            held = inner.get(s.thread)
            if held is None or (s.start_ns, -s.end_ns) > \
                    (held.start_ns, -held.end_ns):
                inner[s.thread] = s
        label = " + ".join(sorted(s.name for s in inner.values())) or NO_SPAN
        covers[k][label] += right - left
    return covers


def idle_gaps(trace, spans, count: int = 10):
    """The ``count`` longest idle gaps between device operations, each
    [seconds, {innermost span: seconds}], longest first."""
    gaps, reach = [], None
    for _name, start, end in trace.device_ops:
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:count]
    ordered = sorted(longest)
    covers = dict(zip(ordered, innermost_cover(spans, ordered)))
    return [[(hi - lo) / 1e9,
             {label: ns / 1e9 for label, ns in
              sorted(covers[(lo, hi)].items(), key=lambda kv: -kv[1])}]
            for lo, hi in longest]


def idle_by_stage(trace, spans):
    """All of the window's idle time, {innermost span: seconds}."""
    total = defaultdict(int)
    for cover in innermost_cover(spans, idle_intervals(trace)):
        for label, ns in cover.items():
            total[label] += ns
    return {label: ns / 1e9 for label, ns in
            sorted(total.items(), key=lambda kv: -kv[1])}
