"""The add path's share spent in the garbage collector: Σ of the server's
``gc.pause`` spans (every collection on the add's threads, start to stop)
over Σ ``wholeRequest``, over the adds completed in the window, in per
cent."""

from harness import spans


def read(window):
    return spans.share(window, "gc.pause")
