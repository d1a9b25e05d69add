"""Tracing and timing utilities (port of
``highlyaccurate_tpu/utils/profiling.py``).

  * ``trace(logdir)`` — a ``torch.profiler`` context (host and, on a GPU,
    CUDA activity) that writes a Chrome trace into ``logdir`` on exit
    (Perfetto / chrome://tracing load it);
  * ``PhaseTimer`` — named host-clock timers; on a GPU each phase ends with
    ``torch.cuda.synchronize()``, so a phase's time holds its device work;
  * ``device_memory_stats()`` — ``torch.cuda.memory_stats`` of each device.

The JAX module's ``enable_nan_debugging`` (``jax_debug_nans``) has the
reference's own counterpart, ``torch.autograd.set_detect_anomaly``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


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


class PhaseTimer:
    """Accumulating named timers on the host clock.

    with timer.phase("project"): ...
    print(timer.summary())

    With ``sync`` (the default when a GPU is present) each phase ends with
    ``torch.cuda.synchronize()``, so it measures the phase's device work
    and not only its launches.
    """

    def __init__(self, sync: bool | None = None):
        self.sync = torch.cuda.is_available() if sync is None else sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: total {t:.4f}s over {n} calls "
                         f"({t / max(n, 1) * 1e3:.2f} ms/call)")
        return "\n".join(lines)


def device_memory_stats() -> dict:
    """Per-device memory statistics (bytes and counts,
    ``torch.cuda.memory_stats``); empty without a GPU."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
