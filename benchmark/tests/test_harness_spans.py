"""The readers of the program's spans (``solver_ms.*``,
``features_ms.serve``, ``api_host_ms.serve``, ``backward_ms.train``) on a
hand-filled span table, their silence where the port has no spans or the
span never ran, and the table of a traced run on the CPU."""

import time

import pytest
import torch

from benchmark.harness import runner, spec, trace
from benchmark.tests._tiny import tiny_cell
from highlyaccurate_tpu_torch.utils import profiling
from highlyaccurate_tpu_torch.utils.profiling import SpanStats

READERS = ("solver_ms.serve", "solver_ms.train", "features_ms.serve",
           "api_host_ms.serve", "backward_ms.train")


def _trace(calls):
    return trace.Trace(calls=calls, window_us=1e6, busy_us=5e5, device=[],
                       conv_us=0.0, gaps=[])


def _table(rows, monkeypatch):
    monkeypatch.setattr(profiling, "span_table", lambda: dict(rows))


def test_readers_on_a_hand_filled_table(monkeypatch):
    _table({"hat.solver": SpanStats(4, 2.0, 0.6, 4),
            "hat.solver.round.l0": SpanStats(20, 1.0, 0.2, 20),
            "hat.features": SpanStats(4, 0.1, 0.5, 4),
            "hat.predict.stage": SpanStats(8, 0.012, 0.0, 8),
            "hat.predict.finish": SpanStats(4, 0.004, 0.0, 4),
            "hat.train.backward": SpanStats(4, 0.3, 1.2, 4)}, monkeypatch)
    t = _trace(4)
    got = {name: spec.metric_reader(name)(t) for name in READERS}
    assert got == pytest.approx({
        "solver_ms.serve": 150.0, "solver_ms.train": 150.0,
        "features_ms.serve": 125.0, "api_host_ms.serve": 4.0,
        "backward_ms.train": 300.0})


@pytest.mark.parametrize("name", READERS)
def test_readers_are_silent_without_their_spans(name, monkeypatch):
    read = spec.metric_reader(name)
    _table({}, monkeypatch)
    assert read(_trace(2)) is None
    _table({"hat.other": SpanStats(2, 1.0, 1.0, 2)}, monkeypatch)
    assert read(_trace(2)) is None
    monkeypatch.delattr(profiling, "span_table")
    assert read(_trace(2)) is None


@pytest.mark.parametrize("name", ("solver_ms.serve", "features_ms.serve",
                                  "backward_ms.train"))
def test_device_readers_are_silent_on_untimed_spans(name, monkeypatch):
    """Spans of a process without CUDA carry no device time."""
    _table({n: SpanStats(2, 1.0, 0.0, 0) for n in
            ("hat.solver", "hat.features", "hat.train.backward")},
           monkeypatch)
    assert spec.metric_reader(name)(_trace(2)) is None


def test_a_traced_run_fills_the_table_with_its_window_alone():
    """The spans record only under the profiler: a traced serve run on
    the CPU reads the serving API's host time per call from the traced
    calls alone, and no device time."""
    profiling.reset_spans()
    cell = tiny_cell("s2gp-serve-b128")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = runner.execute(cell, 2 ** 31 + 5, 1.0, True, "cpu",
                           time.perf_counter())
    finally:
        torch.set_num_threads(n)
    table = profiling.span_table()
    calls = cell.traffic["trace_calls"]
    assert table["hat.predict"].count == calls
    assert table["hat.solver"].count == calls
    assert r["metrics"]["api_host_ms.serve"]["value"] > 0
    assert not {"solver_ms.serve", "features_ms.serve"} & set(r["metrics"])
    profiling.reset_spans()
