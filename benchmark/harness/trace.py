"""The traced run's device side: torch.profiler over the measured window,
reduced to device intervals by name, the busy time (the union of every
device operation), and the longest idle gaps, each named by the host
operation that overlapped it most.
"""

import time
from collections import defaultdict


class Trace:
    """What a reader of a per-layer metric gets from the profiler."""

    def __init__(self, device_ops, host_ops, window_s: float):
        self.device_ops = device_ops   # [(name, start_ns, end_ns)], sorted
        self.host_ops = host_ops       # [(name, start_ns, end_ns)]
        self.window_s = window_s
        self.busy_s = _union_s(device_ops)

    def seconds_by_name(self) -> dict:
        out = defaultdict(float)
        for name, start, end in self.device_ops:
            out[name] += (end - start) / 1e9
        return dict(out)

    def idle_gaps(self, count: int = 10) -> list:
        """The ``count`` longest gaps between device operations, as
        [label, seconds], the label the host operation that covers most of
        the gap ("host: no profiled operation" where none does)."""
        gaps, reach = [], None
        for _name, start, end in self.device_ops:
            if reach is not None and start > reach:
                gaps.append((start - reach, reach, start))
            reach = end if reach is None else max(reach, end)
        gaps.sort(reverse=True)
        out = []
        for length, lo, hi in gaps[:count]:
            cover = defaultdict(int)
            for name, start, end in self.host_ops:
                overlap = min(end, hi) - max(start, lo)
                if overlap > 0:
                    cover[name] += overlap
            label = max(cover, key=cover.get) if cover else \
                "no profiled operation"
            out.append([f"host: {label}", length / 1e9])
        return out


def _union_s(ops) -> float:
    total, reach_start, reach_end = 0, None, None
    for _name, start, end in ops:
        if reach_end is None or start > reach_end:
            if reach_end is not None:
                total += reach_end - reach_start
            reach_start, reach_end = start, end
        else:
            reach_end = max(reach_end, end)
    if reach_end is not None:
        total += reach_end - reach_start
    return total / 1e9


class Profiler:
    """torch.profiler on the CPU and the card, started and stopped around
    the window; host operations on every thread where the build offers it."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        kwargs = {}
        try:
            from torch._C._profiler import _ExperimentalConfig
            kwargs["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA], **kwargs)
        self.started = self.stopped = None

    def start(self) -> None:
        self.prof.__enter__()
        self.started = time.perf_counter()

    def stop(self) -> Trace:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.stopped = time.perf_counter()
        self.prof.__exit__(None, None, None)
        cuda = self.torch.autograd.DeviceType.CUDA
        device_ops, host_ops = [], []
        for event in self.prof.profiler.kineto_results.events():
            start = event.start_ns()
            span = (event.name(), start, start + event.duration_ns())
            if event.device_type() == cuda:
                device_ops.append(span)
            elif not getattr(event, "is_python_function", lambda: False)():
                host_ops.append(span)
        device_ops.sort(key=lambda op: op[1])
        return Trace(device_ops, host_ops, self.stopped - self.started)
