"""The port's benchmark entry point, ``python -m
highlyaccurate_tpu_torch.bench``, on the CPU.

Orchestrator cases (the counterparts of tests/test_bench_orchestrator.py,
each a run of the parent with ``--device cpu`` and short deadlines): a
healthy run prints contract lines; a hung headline gives a FAILED line by
the watchdog's deadline and exit 1, never a cached value; a hung extra
reads "error: timeout ..."; an unknown metric exits 2; without a card and
without ``--device cpu`` the run exits 1 and no child runs.

Workload parity with the JAX bench (``bench.py``): its CPU config and
batches (G2SP's intrinsics scaled to the CPU's ground input, as
``bench.build`` scales them), the same ``RandomState(0)`` images and the JAX model's
``init``
weights (``PRNGKey(0)`` / ``(1)``, as ``bench.py`` draws them) carried
across with ``state_dict_from_jax``; one call of each workload's builder
against the same call in JAX.  Tolerances: the pose 1e-5 absolute per
component (normalized; the gather path's six-round trajectory reads
<= 6.3e-6 in tests/test_torch_gather_path.py), the train step's loss 1e-5
relative (its gradients are held to JAX in test_torch_gather_train.py and
test_torch_train_step.py).
"""

import dataclasses
import functools
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.geometry import ford as jford
from highlyaccurate_tpu.models.ford import LMS2GPFord as JLMS2GPFord
from highlyaccurate_tpu.models.lm_g2sp import LMG2SP as JLMG2SP
from highlyaccurate_tpu.models.lm_s2gp import LMS2GP as JLMS2GP
from highlyaccurate_tpu.train import step as jstep
from highlyaccurate_tpu.train.state import create_train_state
from highlyaccurate_tpu_torch import bench, ops
from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTRACT = {"metric", "value", "unit", "vs_baseline", "extra"}


@functools.lru_cache(maxsize=None)
def _jax_bench():
    """The repository's JAX ``bench.py``, imported as a module (its
    import runs nothing)."""
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args=("--device", "cpu"), timeout=240, **env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **env_extra)
    proc = subprocess.run(
        [sys.executable, "-m", "highlyaccurate_tpu_torch.bench", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    for d in lines:
        assert set(d) == CONTRACT, d
        assert isinstance(d["value"], (int, float))
        assert d["unit"] == "frames/sec"
    return proc, lines


def test_healthy_cpu_run_prints_flagship_then_final():
    proc, lines = _run(_BENCH_ONLY="")
    assert proc.returncode == 0, proc.stderr
    assert len(lines) >= 2  # the moment the flagship lands, and the final
    last = lines[-1]
    assert last["value"] > 0 and "FAILED" not in last["metric"]
    assert "not a device number" in last["metric"]
    assert last["extra"] == {"device": {"name": "cpu", "power_limit": None}}
    assert last["vs_baseline"] == round(last["value"] / 2.86, 2)


def test_hung_flagship_emits_failed_line_by_the_watchdog():
    proc, lines = _run(_BENCH_FAKE_HANG="flagship", _BENCH_FLUSH_S="1",
                       _BENCH_FLAGSHIP_TIMEOUT_S="4", _BENCH_ONLY="")
    assert proc.returncode == 1
    assert "watchdog deadline" in lines[0]["metric"]
    assert "timeout after 4s" in lines[-1]["metric"]
    for d in lines:
        assert d["value"] == 0.0 and "FAILED" in d["metric"]
        assert "CACHED" not in d["metric"]


def test_hung_extra_reads_error_timeout():
    proc, lines = _run(_BENCH_FAKE_HANG="flagship,train_fps",
                       _BENCH_FLAGSHIP_TIMEOUT_S="2",
                       _BENCH_METRIC_TIMEOUT_S="2", _BENCH_ONLY="train_fps")
    assert proc.returncode == 1
    last = lines[-1]
    assert last["value"] == 0.0 and "FAILED" in last["metric"]
    assert last["extra"]["train_fps"].startswith("error: timeout")


@pytest.mark.parametrize("args,env", [
    (("--metric", "nope", "--device", "cpu"), {}),
    (("--device", "cpu"), {"_BENCH_ONLY": "nope"}),
], ids=["child", "only"])
def test_unknown_metric_exits_2(args, env):
    proc, lines = _run(args, **env)
    assert proc.returncode == 2 and not lines


def test_no_card_runs_nothing():
    """No card visible (``CUDA_VISIBLE_DEVICES=""`` hides one where there
    is one) and no ``--device cpu``: a FAILED line, every extra not run,
    exit 1."""
    proc, lines = _run((), CUDA_VISIBLE_DEVICES="",
                       _BENCH_ONLY="train_fps,batch1_latency_ms")
    assert proc.returncode == 1
    assert len(lines) == 1
    (d,) = lines
    assert d["value"] == 0.0 and "FAILED" in d["metric"]
    assert "batch 32" in d["metric"]
    assert set(d["extra"]) == {"train_fps", "batch1_latency_ms"}
    assert all(v.startswith("error: not run") for v in d["extra"].values())


@pytest.mark.parametrize("visible,want", [
    (None, "0"), ("", "0"), ("3", "3"), ("GPU-5f1c,1", "GPU-5f1c"),
    (" 2 ,5", "2")], ids=["unset", "empty", "index", "uuid", "spaces"])
def test_device_info_names_the_visible_card(monkeypatch, visible, want):
    """``extra.device`` queries the card the children see as device 0."""
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert bench.smi_index() == want


def test_expect_launches_checks_every_kernel():
    """The launch rule the bench's children and chip_smoke.py share: the
    kernels named launched exactly that often, every other one never."""
    counters = ops.launch_counters()
    assert set(counters) == {"k1", "k2", "k3", "k4", "k5", "k6", "k7"}
    try:
        ops.reset_launches()
        assert ops.launch_counts() == dict.fromkeys(counters, 0)
        assert ops.expect_launches("none", {}) == dict.fromkeys(counters, 0)
        counters["k1"].launches = 15
        assert ops.expect_launches("k1", {"k1": 15})["k1"] == 15
        for wrong in ({}, {"k1": 14}, {"k1": 15, "k2": 15}):
            with pytest.raises(RuntimeError, match="launched the kernels"):
                ops.expect_launches("k1", wrong)
    finally:
        ops.reset_launches()


@pytest.mark.parametrize("gpu", [True, False], ids=["cuda", "cpu"])
def test_configs_are_bench_pys(gpu):
    """The headline's batch and config on each device, and the extras'
    names, are ``bench.py``'s."""
    jb = _jax_bench()
    jbatch, jcfg = jb._flagship_cfg(gpu)
    batch, cfg = bench.flagship_cfg("cuda" if gpu else "cpu")
    assert batch == jbatch
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert set(jb._make_extra_metrics(gpu)) == set(bench.EXTRAS)


# bench.py's CPU workloads of the parity cases
PARITY = {"s2gp_eval": "fp32_eval_fps",
          "s2gp_tracking": "tracking_warm2_b1_latency_ms",
          "g2sp_eval": "g2sp_eval_fps", "ford_eval": "ford_eval_fps",
          "s2gp_train": "train_fps"}
JAX_MODELS = {"S2GP": JLMS2GP, "G2SP": JLMG2SP, "Ford": JLMS2GPFord}


def _jax_init(spec):
    return _jax_init_of(spec.family, spec.cfg, spec.batch)


@functools.lru_cache(maxsize=None)
def _jax_init_of(family, port_cfg, B):
    """``bench.py``'s inputs and ``init`` of a JAX model (one per family,
    config and batch: the S2GP eval and train cases share theirs):
    (model, images, extra inputs, params)."""
    cfg = JConfig(**dataclasses.asdict(port_cfg))
    model = JAX_MODELS[family](cfg=cfg)
    rng = np.random.RandomState(0)
    sat = rng.rand(B, cfg.sat_size, cfg.sat_size, 3).astype(np.float32)
    grd = rng.rand(B, cfg.grd_h, cfg.grd_w, 3).astype(np.float32)
    if family == "G2SP":
        # bench.py's K (the default K) scaled to the 128 x 32 input, as
        # bench.build scales it: unscaled its principal point leaves the
        # image and both frameworks return pose 0
        extra = (np.broadcast_to(_scaled_default_k(port_cfg),
                                 (B, 3, 3)).copy(),)
    elif family == "Ford":
        R = np.asarray(jford.qvec2rotmat(list(bench.FORD_QVEC)), np.float32)
        extra = (jnp.asarray(cfg.sat_size * 0.22),
                 np.broadcast_to(R, (B, 3, 3)).copy(),
                 np.broadcast_to(np.asarray(bench.FORD_T_FL, np.float32),
                                 (B, 3)).copy())
    else:
        extra = ()
    extra = tuple(jnp.asarray(e) for e in extra)
    v = jax.jit(lambda s, g, *e: model.init(
        {"params": jax.random.PRNGKey(0), "lm": jax.random.PRNGKey(1)},
        s, g, *e, jnp.zeros((B, 3)), mode="train"))(sat, grd, *extra)
    return model, (sat, grd), extra, v["params"]


@pytest.mark.parametrize("case", list(PARITY))
def test_workload_matches_jax_bench(case):
    spec = bench.specs("cpu")[PARITY[case]]
    model, (sat, grd), extra, params = _jax_init(spec)
    w = bench.build(spec, "cpu", state_dict=state_dict_from_jax(params))
    # the same inputs (Ford's patch side is a number, not an input tensor)
    arrays = (sat, grd) + tuple(e for e in extra if np.ndim(e))
    assert len(w.inputs) == len(arrays)
    for got, want in zip(w.inputs, arrays):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    if spec.train:
        state = create_train_state(model.cfg, params)
        ts = jstep.make_train_step(model, model.cfg, mesh=None)
        _, metrics = ts(state, jnp.asarray(sat), jnp.asarray(grd),
                        jnp.zeros((spec.batch, 3)), jax.random.PRNGKey(0))
        want = float(metrics["loss"])
        got = float(w.call(0, w.start))
        print(case, "loss", got, want, abs(got - want) / abs(want))
        assert np.isfinite(want) and want > 0
        assert abs(got - want) <= 1e-5 * abs(want)
        return

    order = bench.POSE_ORDER[spec.family]

    @jax.jit
    def call(p, init, key):
        out = model.apply({"params": p}, sat, grd, *extra, mode="test",
                          init_pose=init, rngs={"lm": key})
        return jnp.stack([out[j] for j in order], -1)

    init, prev = jnp.zeros((spec.batch, 3)), w.start
    for i in range(2 if spec.warm else 1):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        want = np.asarray(call(params, init if spec.warm else None, key))
        with torch.no_grad():
            prev = w.call(i, prev)
        got = prev.numpy()
        print(case, i, np.abs(got - want).max())
        assert np.all(np.abs(want[:, :2]) < 2.5), "the pose left the range"
        assert np.abs(want).max() > 1e-3, "the pose never moved"
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        init = jnp.asarray(want)
