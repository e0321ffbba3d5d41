"""The add path's share spent in vectorise: the sum of the server's
``add_documents.vectorise`` timer over the sum of ``wholeRequest``, over
the adds completed in the window, in per cent."""


def read(window):
    whole = sum(window.timers("wholeRequest"))
    if not whole:
        return None
    return 100.0 * sum(window.timers("add_documents.vectorise")) / whole
