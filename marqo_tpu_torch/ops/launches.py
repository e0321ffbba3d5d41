"""The kernels' launch counts, kept true under CUDA graphs.

Each kernel wrapper (ops/flash_attention.py, ops/fused_attention.py,
ops/quant_matmul.py) calls ``count`` where it launches its kernel. A launch
made while a CUDA graph captures (inference/graphs.py) puts nothing on the
card: inside ``recording()`` ``count`` keeps it in the capture's list, and
every replay of the graph adds that list (``add``). So the modules'
``LAUNCHES`` and ``LOOP_LAUNCHES`` count launches that ran on the card,
eager or replayed, and never a capture.
"""

import contextlib
import threading
from typing import NamedTuple, Optional

# serving threads launch concurrently, so additions take the lock
_lock = threading.Lock()
_recording = threading.local()


class Launch(NamedTuple):
    """One launch: the module's counts and the mode it adds one to, its
    per-loop counts and loop (attention only), the counter's name
    ("masked_attention_padding", "fused_attention_nomask", "w8a8_matmul",
    ...) and the shape launched ((B, N, S, D) for attention, (M, K, N) for
    B3)."""
    counts: dict
    mode: str
    loop_counts: Optional[dict]
    loop: Optional[str]
    name: str
    shape: tuple


def count(launch: Launch) -> None:
    """Add ``launch``, or keep it in this thread's recording."""
    log = getattr(_recording, "log", None)
    if log is None:
        add((launch,))
    else:
        log.append(launch)


def add(launches) -> None:
    """Add each of ``launches`` to its counts."""
    with _lock:
        for launch in launches:
            launch.counts[launch.mode] += 1
            if launch.loop_counts is not None:
                launch.loop_counts[launch.loop] += 1


@contextlib.contextmanager
def recording():
    """Launches counted in this thread inside the block are kept in the
    list it yields, not added."""
    _recording.log = log = []
    try:
        yield log
    finally:
        _recording.log = None
