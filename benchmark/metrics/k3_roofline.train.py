"""K3's share of its roofline, in percent: the least time of the map
gradient work of the traced steps (``counts.k3_bytes`` over 3.35 TB/s)
over the device time of the kernels that do it
(``banded_sample_backward``)."""

from benchmark.harness import counts


def read(t):
    us, n = t.time_us("banded_sample_backward")
    if not n:
        return None
    least = counts.k3_bytes(t.model, t.traffic["batch"]) * t.calls \
        / counts.PEAK_BYTES
    return 100.0 * least / (us / 1e6)
