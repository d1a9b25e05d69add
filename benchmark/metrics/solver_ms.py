"""Device ms of the solver per served batch (``solver_ms.serve``) or per
training step's forward (``solver_ms.train``): the program's
``hat.solver`` span (its 15 rounds and the casts before them), the
stream time between the span's entry and its exit, idle inside
included."""

from benchmark.harness import spans


def read(t):
    return spans.ms_per_call(t, ("hat.solver",), "device")
