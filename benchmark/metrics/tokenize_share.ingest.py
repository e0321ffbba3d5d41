"""The add path's share spent turning chunks into the encoder's rows:
Σ of the server's ``inference.tokenize`` (WordPiece and bucket padding)
and ``inference.pack`` (sequence packing, or the padded rows) spans over
Σ ``wholeRequest``, over the adds completed in the window, in per cent."""

from harness import spans


def read(window):
    return spans.share(window, "inference.tokenize", "inference.pack")
