"""Percent of the whole traced window in which no operation ran on the
device (``idle_share.serve``, ``idle_share.train``): 100 * (1 - busy /
window), busy the union of the device's intervals, the window the span's
wall time (the result's busy_s and window_s)."""


def read(t):
    return 100.0 * (1.0 - t.busy_us / t.window_us)
