"""The port's spans (``utils/profiling.py``) on the CPU: nothing is
recorded without a profiler or ``enable_spans``; under ``torch.profiler``
a served batch holds ``hat.predict`` with the features, the solver and
its rounds inside, a training step its three ``hat.train.*`` spans; an
export traced under a profiler holds no profiler op; the span table folds
its pending device times as it goes."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.inference import ExportedLocalizer, Localizer
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP, _scaled_default_k
from highlyaccurate_tpu_torch.train.state import create_train_state
from highlyaccurate_tpu_torch.train.step import make_train_step
from highlyaccurate_tpu_torch.utils import profiling
from highlyaccurate_tpu_torch.utils.profiling import (enable_spans,
                                                      reset_spans, span,
                                                      span_table)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# three levels, two iterations: 6 rounds a call; G2SP at a 64-row ground
# input, so every level takes the projective-line sampler
GEOM = {"S2GP": dict(grd_h=32, grd_w=128, sat_size=64),
        "G2SP": dict(grd_h=64, grd_w=256, sat_size=128, direction="G2SP")}
N_ITERS, LEVELS = 2, 3
# openings per call of one chunk: the stage opens for the call's
# arguments and again for the chunk's padding
SERVE_SPANS = {"hat.predict.stage": 2, "hat.predict.h2d": 1,
               "hat.features": 1, "hat.solver": 1,
               "hat.predict.readback": 1, "hat.predict.finish": 1}


@pytest.fixture(autouse=True)
def clean_spans():
    reset_spans()
    enable_spans(False)
    yield
    enable_spans(False)
    reset_spans()


def _localizer(family, **over):
    cfg = Config(**{**GEOM[family], "N_iters": N_ITERS, "level": 3, **over})
    kw = (dict(camera_k=_scaled_default_k(cfg)) if family == "G2SP"
          else {})
    return Localizer(cfg, random_init=True, batch_size=2, seed=1,
                     device="cpu", **kw)


def _images(family, n, seed=0):
    g = GEOM[family]
    rng = np.random.RandomState(seed)
    return ((rng.rand(n, g["sat_size"], g["sat_size"], 3) * 255)
            .astype(np.uint8),
            (rng.rand(n, g["grd_h"], g["grd_w"], 3) * 255).astype(np.uint8))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof.events(), out


def _named(events, name):
    return [e for e in events if e.name == name]


def _parents(e):
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


def test_no_profiler_records_nothing():
    loc = _localizer("S2GP")
    loc.predict(*_images("S2GP", 2))
    assert span_table() == {}


def test_off_is_one_shared_null_context():
    a, b = span("hat.a"), span("hat.b", 7)
    assert a is b
    with a:
        pass
    assert span_table() == {}


@pytest.mark.parametrize("family", ["S2GP", "G2SP"])
def test_predict_spans_under_profiler(family):
    """Two calls of one batch each: ``hat.predict`` twice, each holding
    the serving spans and ``N_iters`` x L rounds inside its
    ``hat.solver``; the table counts the same."""
    loc = _localizer(family)
    sat, grd = _images(family, 2)
    loc.predict(sat, grd)                      # warm, outside the window
    events, _ = _profiled(lambda: [loc.predict(sat, grd) for _ in range(2)])
    calls = _named(events, "hat.predict")
    assert len(calls) == 2
    for name, per_call in SERVE_SPANS.items():
        hits = _named(events, name)
        assert len(hits) == 2 * per_call, name
        assert all("hat.predict" in _parents(e) for e in hits), name
    rounds = [e for e in events if e.name.startswith("hat.solver.round.l")]
    assert len(rounds) == 2 * N_ITERS * LEVELS
    assert {e.name for e in rounds} == {f"hat.solver.round.l{k}"
                                        for k in range(LEVELS)}
    assert all(_parents(e)[0] == "hat.solver" for e in rounds)
    table = span_table()
    assert table["hat.predict"].count == 2
    assert sum(v.count for k, v in table.items()
               if k.startswith("hat.solver.round.l")) == len(rounds)
    assert all(table[k].count == 2 * n for k, n in SERVE_SPANS.items())
    assert all(v.host_s > 0 and v.timed == 0 for v in table.values())


def test_train_step_spans_under_profiler():
    cfg = Config(**GEOM["S2GP"], N_iters=1, level=3)
    model = LMS2GP(cfg, device="cpu")
    model.train()
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    rng = np.random.RandomState(0)
    sat = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32))
    grd = torch.from_numpy(rng.rand(2, 32, 128, 3).astype(np.float32))
    gt = torch.from_numpy(rng.uniform(-1, 1, (2, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    events, _ = _profiled(lambda: step(state, sat, grd, gt, gen))
    for name in ("hat.train.forward", "hat.train.backward",
                 "hat.train.optimizer"):
        assert len(_named(events, name)) == 1, name
    (solver,) = _named(events, "hat.solver")
    assert "hat.train.forward" in _parents(solver)
    assert {k: v.count for k, v in span_table().items()
            if k.startswith("hat.train.")} == {
        "hat.train.forward": 1, "hat.train.backward": 1,
        "hat.train.optimizer": 1}


def test_export_under_profiler_holds_no_profiler_op(tmp_path):
    """An export traced while a profiler runs gives the program an
    un-profiled export gives: no profiler op in its graph, the same
    answers; its spans stay shut while it traces.  Its server still opens
    the serving API's spans."""
    loc = _localizer("S2GP", level=-1)
    plain, traced = str(tmp_path / "plain.zip"), str(tmp_path / "traced.zip")
    loc.export(plain)
    _profiled(lambda: loc.export(traced))
    assert span_table() == {}
    srv = {p: ExportedLocalizer(p, seed=2, device="cpu")
           for p in (plain, traced)}
    for s in srv.values():
        for gm in s._programs.values():
            targets = [str(n.target) for n in gm.graph.nodes]
            assert not any("profiler" in t for t in targets), targets
    sat, grd = _images("S2GP", 3, seed=4)
    want = srv[plain].predict(sat, grd)
    events, got = _profiled(lambda: srv[traced].predict(sat, grd))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    names = {e.name for e in events}
    assert {"hat.predict", "hat.predict.h2d",
            "hat.predict.readback"} <= names
    assert not names & {"hat.features", "hat.solver"}


def test_enable_spans_records_host_times_and_reset_clears():
    enable_spans(True)
    with span("hat.outer"):
        with span("hat.outer.inner"):
            sum(range(1000))
    with span("hat.outer"):
        pass
    table = span_table()
    assert table["hat.outer"].count == 2
    assert table["hat.outer.inner"].count == 1
    assert table["hat.outer"].host_s >= table["hat.outer.inner"].host_s > 0
    reset_spans()
    assert span_table() == {}
    enable_spans(False)
    with span("hat.outer"):
        pass
    assert span_table() == {}


class _Event:
    """A stand-in for a CUDA timing event: complete once ``done``."""
    clock = 0

    def __init__(self):
        self.done = False
        _Event.clock += 1
        self.t = _Event.clock

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return float(end.t - self.t)          # ms


def test_pending_device_times_fold_as_they_complete(monkeypatch):
    """Beyond ``FOLD_AT`` pending pairs the complete ones fold, in record
    order up to the first incomplete one; ``span_table`` folds the rest."""
    made = []

    def record():
        made.append(_Event())
        return made[-1]

    monkeypatch.setattr(profiling, "FOLD_AT", 4)
    monkeypatch.setattr(profiling, "_record", record)
    reset_spans()
    enable_spans(True)
    for _ in range(3):
        with span("hat.x"):
            pass
    for ev in made:
        ev.done = True
    with span("hat.x"):                        # the 4th pair: a fold
        pass
    assert len(profiling._pending) == 1        # the 4th is incomplete
    assert len(profiling._pending) < profiling._fold_next
    row = span_table()["hat.x"]
    assert (row.count, row.timed) == (4, 4)
    assert row.device_s == pytest.approx(4 * 1e-3)
    assert profiling._pending == []
