"""Of the time the server's adds spent in ``inference.device_wait`` (the
host blocked until the card has run the add's work and copied it back)
within the traced window, the share in which the card ran nothing, in per
cent: near 0 the wait is the card's own work; higher, the host waits on
something else (the program's spans joined with the trace's device
intervals, harness/spans.py)."""

from harness import spans


def read(window):
    logged = spans.program_spans()
    if logged is None:
        return None
    return spans.idle_share(window.trace, logged, "inference.device_wait")
