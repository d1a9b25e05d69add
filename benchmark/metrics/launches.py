"""Device kernels per served batch (``launches.serve``) or training step
(``launches.train``), copies and fills not counted, from the profiler's
count over the traced calls."""


def read(t):
    n = len(t.kernels())
    return n / t.calls if n else None
