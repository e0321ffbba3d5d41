"""The add path's share spent waiting for the engine's shard locks: Σ of
the server's per-document ``engine.lock_wait`` timer over Σ
``wholeRequest``, over the adds completed in the window, in per cent."""

from harness import spans


def read(window):
    return spans.share(window, "engine.lock_wait")
