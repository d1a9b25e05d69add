"""Device ms of host-to-device copies per served batch (the frames' way
in): the profiler's ``Memcpy HtoD`` events over the traced calls."""


def read(t):
    us = t.copy_us("HtoD")
    return us / t.calls / 1e3 if us > 0 else None
