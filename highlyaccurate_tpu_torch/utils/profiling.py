"""Tracing utilities (port of ``highlyaccurate_tpu/utils/profiling.py``).

  * ``trace(logdir)`` — a ``torch.profiler`` context (host and, on a GPU,
    CUDA activity) that writes a Chrome trace into ``logdir`` on exit
    (Perfetto / chrome://tracing load it);
  * ``span(name)`` — the program's own spans at its layer boundaries
    (``hat.predict``, ``hat.features``, ``hat.solver.round.l<k>``,
    ``hat.solver.project``, ``hat.train.backward``, ...).  They record
    only while a torch profiler runs or after ``enable_spans(True)``;
    otherwise each costs one flag check.  ``span_table()`` reads what
    they recorded, ``reset_spans()`` clears it.

A span's name is dotted under the span that encloses it where it has one
place in the program (``hat.predict.h2d`` inside ``hat.predict``); the
features and the solver keep their own names, since serving and training
both reach them.

The JAX module's ``enable_nan_debugging`` (``jax_debug_nans``) has the
reference's own counterpart, ``torch.autograd.set_detect_anomaly``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import torch
from torch._C._autograd import _profiler_enabled

# pending CUDA event pairs beyond this many fold those already complete,
# so a long profiled run holds a bounded number of events
FOLD_AT = 4096

_NULL = contextlib.nullcontext()
_enabled = False
_lock = threading.Lock()
_rows: dict = {}        # name -> SpanStats
_pending: list = []     # (SpanStats, start event, end event), record order
_fold_next = FOLD_AT


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed work; on exit write
    ``<logdir>/trace_<pid>.json`` (a Chrome trace).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))


@dataclasses.dataclass
class SpanStats:
    """What the spans of one name recorded: how many closed, their host
    seconds (entry to exit on the host clock), and their device seconds
    (stream time from the event recorded at entry to the one at exit,
    idle inside included) over the ``timed`` of them that ran with CUDA
    initialized."""
    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    timed: int = 0


def enable_spans(on: bool = True) -> None:
    """Record spans without a profiler (``on``), or only under one."""
    global _enabled
    _enabled = bool(on)


def span(name: str, args=None):
    """A context that records the span ``name``, or a shared null context
    when no profiler runs and spans are not enabled, and while
    ``torch.compile`` or ``torch.export`` traces (an exported program
    holds no profiler op).  ``args`` (its ``str``) labels the span in the
    profiler's trace."""
    if not (_enabled or _profiler_enabled()) or torch.compiler.is_compiling():
        return _NULL
    return _Span(name, args)


class _Span:
    __slots__ = ("name", "args", "rf", "t0", "start")

    def __init__(self, name: str, args):
        self.name, self.args = name, args

    def __enter__(self):
        self.rf = torch.profiler.record_function(
            self.name, None if self.args is None else str(self.args))
        self.rf.__enter__()
        self.start = _record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        end = None if self.start is None else _record()
        self.rf.__exit__(*exc)
        with _lock:
            row = _rows.get(self.name)
            if row is None:
                row = _rows[self.name] = SpanStats()
            row.count += 1
            row.host_s += (t1 - self.t0) / 1e9
            if end is not None:
                _pending.append((row, self.start, end))
                if len(_pending) >= _fold_next:
                    _fold(wait=False)
        return False


def _record():
    """A timing event recorded on the current CUDA stream, or None where
    CUDA is not in use."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _fold(wait: bool) -> None:
    """Add the device time of pending event pairs to their rows: all of
    them (``wait``, synchronizing on each end event), or those complete in
    record order up to the first that is not.  Called under ``_lock``."""
    global _fold_next
    done = 0
    for row, start, end in _pending:
        if wait:
            end.synchronize()
        elif not end.query():
            break
        row.device_s += start.elapsed_time(end) / 1e3
        row.timed += 1
        done += 1
    del _pending[:done]
    _fold_next = len(_pending) + FOLD_AT


def span_table() -> dict:
    """{name: SpanStats} of every span recorded since the last
    ``reset_spans()``, with the device time of all of them (this waits
    for the device to reach each span's end)."""
    with _lock:
        _fold(wait=True)
        return {k: dataclasses.replace(v) for k, v in _rows.items()}


def reset_spans() -> None:
    """Forget every recorded span, pending device times included."""
    global _fold_next
    with _lock:
        _rows.clear()
        _pending.clear()
        _fold_next = FOLD_AT
