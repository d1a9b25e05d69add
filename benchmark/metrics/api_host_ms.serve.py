"""Host ms of the serving API's own work per served batch, during which
the card has nothing of the call queued: the program's
``hat.predict.stage`` (arguments, padding) and ``hat.predict.finish``
(unpadding, denormalization) spans on the host clock."""

from benchmark.harness import spans


def read(t):
    return spans.ms_per_call(t, ("hat.predict.stage", "hat.predict.finish"),
                             "host")
