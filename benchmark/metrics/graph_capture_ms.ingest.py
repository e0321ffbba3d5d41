"""Time the adds completed in the window spent capturing encoder graphs
(a key's first use: a warm run and the capture): Σ of the server's
``inference.graph_capture`` span, in ms; 0 where no add captured."""

from harness import spans


def read(window):
    return spans.timer_sum(window, "inference.graph_capture")
