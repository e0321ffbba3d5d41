"""The encoder's share of the card's bf16 peak: the model operations that
the window's acknowledged documents need, counted at published widths from
the reference's own chunks and token counts, over the window's seconds
times 989 TFLOP/s."""

from harness.work import model_share


def read(window):
    return model_share(window)
