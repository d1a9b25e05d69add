"""The traced window: ``torch.profiler`` over the calls inside one
``benchmark.window`` span, reduced to what the per-layer readers and the
result line need.  Busy time is the union of the device's intervals
(kernels, copies, fills) inside the span, so nothing counts twice; the
window is the span's own wall time."""

from __future__ import annotations

import contextlib
import dataclasses

WINDOW = "benchmark.window"
CONV_OPS = ("aten::convolution", "aten::convolution_backward")


@dataclasses.dataclass
class Trace:
    """What a traced window held.  Times in microseconds."""
    calls: int                       # batches or steps inside the window
    window_us: float
    busy_us: float
    device: list                     # (name, dur_us) of every device op
    conv_us: float                   # device time of convolution kernels
    gaps: list                       # (host op name, idle us) per gap
    call_s: float = None             # seconds a call, untraced
    model: dict = None               # the configuration's model settings
    route: dict = None
    traffic: dict = None
    reference: object = None         # the configuration's reference module

    def kernels(self):
        """(name, dur_us) of the kernels: device ops other than copies and
        fills."""
        return [(n, d) for n, d in self.device
                if not n.startswith(("Memcpy", "Memset"))]

    def time_us(self, part: str):
        """(device us, count) of the kernels whose name holds ``part``."""
        hits = [d for n, d in self.kernels() if part in n]
        return sum(hits), len(hits)

    def copy_us(self, kind: str = "HtoD"):
        return sum(d for n, d in self.device
                   if n.startswith(f"Memcpy {kind}"))

    def breakdown(self, top: int = 10) -> dict:
        ops, gaps = {}, {}
        for n, d in self.device:
            ops[n[:64]] = ops.get(n[:64], 0.0) + d / 1e6
        for n, d in self.gaps:
            gaps[n[:64]] = gaps.get(n[:64], 0.0) + d / 1e6

        def best(m):
            return [list(kv) for kv in
                    sorted(m.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(gaps)}


@contextlib.contextmanager
def profiled():
    """Profile CPU and CUDA activity; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _is_conv(e) -> bool:
    while e is not None:
        if e.name in CONV_OPS:
            return True
        e = e.cpu_parent
    return False


def reduce(prof, calls: int) -> Trace:
    """The ``Trace`` of the profiler's ``benchmark.window`` span."""
    from torch.autograd import DeviceType
    events = prof.events()
    span = next(e for e in events if e.name == WINDOW)
    w0, w1 = span.time_range.start, span.time_range.end
    dev, cpu = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name == WINDOW:
                continue         # the span's own mark on the device line
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                dev.append((s, t, e.name))
        elif (e.name != WINDOW and w0 <= e.time_range.start <= w1
              and not getattr(e, "is_async", False)):
            cpu.append(e)
    dev.sort()
    busy, end, idle = 0.0, w0, []
    for s, t, _ in dev:
        if s > end:
            idle.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if w1 > end:
        idle.append((end, w1))
    conv = sum(k.duration for e in cpu if e.kernels and _is_conv(e)
               for k in e.kernels)
    return Trace(calls=calls, window_us=w1 - w0, busy_us=busy,
                 device=[(n, t - s) for s, t, n in dev], conv_us=conv,
                 gaps=_host_during(idle, cpu, span.thread))


def _host_during(idle, cpu, main) -> list:
    """(name, us) of each idle gap, named by the innermost host op of the
    window's thread ``main`` that covered the gap's middle, else of any
    other thread (the autograd engine's, which runs the backward), else
    ``_no_host_op_``."""
    threads = sorted({e.thread for e in cpu}, key=lambda t: t != main)
    names = [None] * len(idle)
    for th in threads:
        todo = [i for i, n in enumerate(names) if n is None]
        if not todo:
            break
        found = _innermost([(idle[i][0] + idle[i][1]) / 2 for i in todo],
                           [e for e in cpu if e.thread == th])
        for i, n in zip(todo, found):
            names[i] = n
    return [(n or "_no_host_op_", t - s) for n, (s, t) in zip(names, idle)]


def _innermost(points, ops) -> list:
    """For each of the ascending ``points``, the name of the innermost op
    of one thread (its ops nest) covering it, or None: one sweep over the
    ops in start order with a stack of the open ones."""
    ops = sorted(ops, key=lambda e: e.time_range.start)
    out, stack, i = [], [], 0
    for p in points:
        while i < len(ops) and ops[i].time_range.start <= p:
            while stack and stack[-1].time_range.end < ops[i].time_range.start:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1].time_range.end < p:
            stack.pop()
        out.append(stack[-1].name if stack else None)
    return out
