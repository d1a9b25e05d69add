"""Device ms of the backward pass per training step: the program's
``hat.train.backward`` span, the stream time between its entry and its
exit, idle inside included."""

from benchmark.harness import spans


def read(t):
    return spans.ms_per_call(t, ("hat.train.backward",), "device")
