"""The add path's share spent validating the documents and splitting their
fields into chunks: Σ of the server's ``add_documents.plan`` span over Σ
``wholeRequest``, over the adds completed in the window, in per cent."""

from harness import spans


def read(window):
    return spans.share(window, "add_documents.plan")
