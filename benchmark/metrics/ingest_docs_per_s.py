"""Documents acknowledged without error by the adds that completed inside
the window, over the window's seconds (client side)."""


def read(window):
    return len(window.acknowledged()) / window.seconds
