"""The add path's share spent handing work to the card and waiting for its
embeddings: Σ of the server's ``inference.dispatch`` (the model's lock,
the copy in, the graph's replay) and ``inference.device_wait`` (the host
blocked on the copy back) spans over Σ ``wholeRequest``, over the adds
completed in the window, in per cent."""

from harness import spans


def read(window):
    return spans.share(window, "inference.dispatch", "inference.device_wait")
