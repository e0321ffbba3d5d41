"""The add path's share spent taking embeddings from the host array to the
per-field arrays the engine feed takes (normalising, Python lists, the
scatter): Σ of the server's ``inference.to_lists`` span over Σ
``wholeRequest``, over the adds completed in the window, in per cent."""

from harness import spans


def read(window):
    return spans.share(window, "inference.to_lists")
