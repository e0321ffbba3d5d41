"""Median over the window's searches of the client's time from send to
answer less the server's ``wholeRequest`` timer: the HTTP layer's and the
socket's share of a search."""

from harness.window import median


def read(window):
    return median([(done - sent) * 1e3 - t["wholeRequest"]
                   for k, due, sent, done, status, ids, scores, t
                   in window.in_window()
                   if status == 200 and "wholeRequest" in t])
