"""The program's own spans (``highlyaccurate_tpu_torch.utils.profiling``):
they record only while a profiler runs, so after a traced window their
table holds that window's calls alone.  A port without spans, or a span
that never ran, reads None."""


def table() -> dict:
    """The port's span table, {name: row with ``count``, ``host_s``,
    ``device_s``, ``timed``}; empty where the port has none."""
    try:
        from highlyaccurate_tpu_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "span_table", None)
    return read() if read is not None else {}


def ms_per_call(t, names, clock: str):
    """Milliseconds per traced call (``t.calls``) of the spans ``names``
    together, on the ``"device"`` clock (the stream time each span
    covered) or the ``"host"`` clock; None where none of them ran or, on
    the device clock, none was timed."""
    rows = [r for n, r in table().items() if n in names]
    if clock == "device":
        rows = [r for r in rows if r.timed]
        total = sum(r.device_s for r in rows)
    else:
        total = sum(r.host_s for r in rows)
    return total / t.calls * 1e3 if rows else None
