"""The decoder embedder's share of the card's bf16 peak: the activated
operations (attention projections, causal attention, the dense layer, the
router, the six routed and two shared experts) that the window's
acknowledged documents need at published widths, counted from the
reference's own chunks and token counts, over the window's seconds times
989 TFLOP/s."""

from harness.work import model_share


def read(window):
    return model_share(window)
