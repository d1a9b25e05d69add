"""K4's share of its roofline, in percent: the least time of the G2SP
projective-line sampling of the traced calls (``counts.k4_bytes`` over
3.35 TB/s) over the device time of the kernels that do it
(``projline_sample_kernel``)."""

from benchmark.harness import counts


def read(t):
    us, n = t.time_us("projline_sample_kernel")
    if not n:
        return None
    least = counts.k4_bytes({**t.model, **t.route}, t.traffic["batch"],
                            t.reference) * t.calls / counts.PEAK_BYTES
    return 100.0 * least / (us / 1e6)
