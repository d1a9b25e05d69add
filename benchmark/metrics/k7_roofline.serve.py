"""K7's share of its roofline, in percent: the least time of the G2SP
per-line contraction of the traced calls (``counts.k7_bytes`` over 3.35
TB/s: the kept samples' four float32 rows in, the lines' LM sums out) over
the device time of the kernels that do it (``projline_linemom_kernel``)."""

from benchmark.harness import counts


def read(t):
    us, n = t.time_us("projline_linemom_kernel")
    if not n:
        return None
    least = counts.k7_bytes({**t.model, **t.route}, t.traffic["batch"],
                            t.reference) * t.calls / counts.PEAK_BYTES
    return 100.0 * least / (us / 1e6)
