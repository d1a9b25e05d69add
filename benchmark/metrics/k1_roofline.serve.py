"""K1's share of its roofline, in percent: the least time of the banded
moment work of the traced calls (the bytes its inputs and outputs need,
``counts.k1_bytes``, over 3.35 TB/s) over the device time of the kernels
that do it (``banded_moments``)."""

from benchmark.harness import counts


def read(t):
    us, n = t.time_us("banded_moments")
    if not n:
        return None
    least = counts.k1_bytes({**t.model, **t.route}, t.traffic["batch"],
                            t.reference) * t.calls / counts.PEAK_BYTES
    return 100.0 * least / (us / 1e6)
