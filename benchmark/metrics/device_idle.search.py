"""Share of the traced window in which no operation ran on the card, in
per cent (torch.profiler's device intervals, their union as busy)."""


def read(window):
    trace = window.trace
    if trace is None or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
