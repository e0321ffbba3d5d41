"""Seconds from the process's start to the window's: loading, the
checkpoint, the index and its base corpus, warming every shape the cell
uses, and in a checkout's first run the kernel build."""


def read(window):
    return window.setup_s
