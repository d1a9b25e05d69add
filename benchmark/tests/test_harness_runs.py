"""Whole runs of every cell on the CPU at a tiny size: ``correct`` holds on
the program as it is and falls when the timed path is broken underneath
(an answer altered where it is produced; half of a served batch left
unsolved; a training step that leaves its state unchanged; half of each
training batch left out, the mean over the rest),
nothing loads JAX or the JAX package, and the command refuses to run
without a card or without the port."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.tests._tiny import tiny_cell, workloads


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload, traced=False, seed=2 ** 31 + 11):
    return runner.execute(tiny_cell(workload), seed, 1.0, traced, "cpu",
                          time.perf_counter())


@pytest.mark.parametrize("workload", workloads())
def test_a_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    cell = spec.resolve(workload)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("workload", workloads("train"))
def test_a_traced_train_run_is_correct(workload):
    r = run(workload, traced=True)
    assert r["correct"], r["checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert "breakdown" in r


@pytest.mark.parametrize("workload", workloads("serve"))
def test_an_altered_answer_is_not_correct(workload, monkeypatch):
    from highlyaccurate_tpu_torch import inference
    predict = inference.Localizer.predict

    def altered(self, *a, **kw):
        out = predict(self, *a, **kw)
        out["lateral_m"] = out["lateral_m"] + 0.5
        return out
    monkeypatch.setattr(inference.Localizer, "predict", altered)
    assert not run(workload)["correct"]


@pytest.mark.parametrize("workload", workloads("serve"))
def test_half_a_served_batch_left_unsolved_is_not_correct(workload,
                                                          monkeypatch):
    from highlyaccurate_tpu_torch import inference
    predict = inference.Localizer.predict

    def half(self, sat, grd, *a, **kw):
        out = predict(self, sat, grd, *a, **kw)
        n = len(sat) // 2
        for k in ("lateral_m", "longitudinal_m", "heading_deg"):
            out[k] = out[k].copy()
            out[k][n:] = 0.0
        return out
    monkeypatch.setattr(inference.Localizer, "predict", half)
    assert not run(workload)["correct"]


@pytest.mark.parametrize("workload", workloads("train"))
def test_a_step_that_keeps_its_state_is_not_correct(workload, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)
    assert not run(workload)["correct"]


@pytest.mark.parametrize("workload", workloads("train"))
def test_half_the_batch_left_out_is_not_correct(workload, monkeypatch):
    from highlyaccurate_tpu_torch.train import step as step_mod
    make = step_mod.make_train_step

    def half(model, cfg, *a, **kw):
        fn = make(model, cfg, *a, **kw)

        def step(state, sat, grd, gt, gen):
            n = sat.shape[0] // 2
            return fn(state, sat[:n], grd[:n], gt[:n], gen)
        return step
    monkeypatch.setattr(step_mod, "make_train_step", half)
    assert not run(workload)["correct"]


def test_forbidden_modules_compare_whole_top_level_names():
    ok = ["highlyaccurate_tpu_torch", "highlyaccurate_tpu_torch.ops",
          "jaxtyping", "torch"]
    assert runner.forbidden_modules(ok) == []
    assert runner.forbidden_modules(ok + ["highlyaccurate_tpu.models",
                                          "jax", "jaxlib.xla"]) == [
        "highlyaccurate_tpu", "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from benchmark.tests._tiny import tiny_cell;"
            "from benchmark.harness import runner;"
            "runner.execute(tiny_cell('s2gp-serve-b128'), 3, 0.5, False, "
            "'cpu', time.perf_counter());"
            "print(runner.forbidden_modules(list(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "s2gp-serve-b128", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_the_command_refuses_without_the_port(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "s2gp-serve-b128", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    json.loads((tmp_path / "BENCHMARK.json").read_text())
