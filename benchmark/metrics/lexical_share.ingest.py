"""The add path's share spent indexing the documents' lexical fields for
BM25: Σ of the server's per-document ``engine.feed.lexical`` timer over Σ
``wholeRequest``, over the adds completed in the window, in per cent."""

from harness import spans


def read(window):
    return spans.share(window, "engine.feed.lexical")
