"""The port's data parallelism on the CPU: ``train/distributed.py``, the
mesh helpers of ``train/step.py`` and ``Localizer(mesh=)``.

* Two gloo processes (``tests/_torch_dist_worker.py``) take one S2GP
  training step of the tiny model (JAX tests/test_train_sharding.py:15) on
  a global batch of 4 through ``make_train_step(mesh=)``, each on its 2
  rows: the two states after Adam are bit-identical, and the loss and the
  averaged gradients match one process's step on the whole batch within
  1e-6 relative and ``GRAD_LIMIT`` relL2 (the same sums in another order:
  a mean of two means of two).
* The KITTI driver with a world of 2: rank 0 alone writes the checkpoint
  and the results.
* ``make_mesh_for_batch``'s warning, ``eval_batch_pad`` and
  ``local_batch_slice`` give JAX's values.
* ``Localizer(mesh=)`` over two CPU replicas answers bit for bit as a
  ``Localizer`` of each slice's batch size (a whole-batch comparison would
  part on random weights through per-size convolution algorithms).

Every subprocess has a timeout.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.train import distributed as jdist
from highlyaccurate_tpu.train import step as jstep
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.inference import Localizer
from highlyaccurate_tpu_torch.train import distributed
from highlyaccurate_tpu_torch.train import step as step_lib
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORKER = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
GRAD_LIMIT = 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(mode, out, world=2, timeout=240):
    """Start ``world`` worker processes of ``mode`` and wait for all."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        WORKER)), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(r), str(world), port, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(
        log[-3000:] for log in logs)
    return logs


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("step")
    _run_world("step", out)
    return {name: dict(np.load(out / f"{name}.npz"))
            for name in ("step_0", "step_1", "single")}


def test_ranks_keep_the_same_state(step_results):
    r0, r1 = step_results["step_0"], step_results["step_1"]
    assert sorted(r0) == sorted(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_step_matches_one_process(step_results):
    dist_, single = step_results["step_0"], step_results["single"]
    want = float(single["loss"])
    assert abs(float(dist_["loss"]) - want) <= 1e-6 * abs(want)
    grads = sorted(k for k in single if k.startswith("g:"))
    assert grads and sorted(k for k in dist_ if k.startswith("g:")) == grads
    got = np.concatenate([dist_[k].ravel() for k in grads])
    ref = np.concatenate([single[k].ravel() for k in grads])
    err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print("gradient relL2, 2 processes vs 1:", err)
    assert np.abs(ref).max() > 0 and err <= GRAD_LIMIT


def test_cli_rank0_alone_writes(tmp_path):
    logs = _run_world("cli", tmp_path, timeout=300)
    assert "Finished Training" in logs[0], logs[0][-3000:]
    assert "Finished Training" not in logs[1], logs[1][-3000:]

    def written(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    files0 = written(tmp_path / "rank0")
    assert any(f.endswith("model_0.pth") for f in files0), files0
    assert any(f.endswith("Test1_results.txt") for f in files0), files0
    assert written(tmp_path / "rank1") == []


@pytest.mark.parametrize("batch_size,n", [(6, 4), (8, 4), (5, 3), (7, 8)])
def test_mesh_helpers_match_jax(capsys, batch_size, n):
    """One process: ``make_mesh_for_batch`` over n devices prints JAX's
    warning and keeps JAX's device count; ``eval_batch_pad`` and
    ``local_batch_slice`` give JAX's numbers."""
    jmesh = jstep.make_mesh_for_batch(batch_size, jax.devices()[:n])
    want = capsys.readouterr().out
    mesh = step_lib.make_mesh_for_batch(batch_size, ["cpu"] * n)
    assert capsys.readouterr().out == want
    assert ("WARNING" in want) == (batch_size % n != 0)
    assert mesh.size == jmesh.devices.size
    full = jstep.make_mesh(jax.devices()[:n])
    assert step_lib.eval_batch_pad(batch_size, step_lib.make_mesh(
        ["cpu"] * n)) == jstep.eval_batch_pad(batch_size, full)
    assert step_lib.eval_batch_pad(batch_size, None) == batch_size
    assert distributed.local_batch_slice(batch_size) == \
        jdist.local_batch_slice(batch_size)


def test_localizer_mesh_replicas():
    """Two CPU replicas: a padded batch of 4 split in two halves, each
    answered bit for bit as a batch-2 ``Localizer`` answers it; a ragged
    call of 3 images pads to 4.  The poses stay inside the re-init range,
    so the two draw orders cannot part them."""
    cfg = Config(grd_h=32, grd_w=128, sat_size=64, N_iters=2, level=-1)
    mesh = step_lib.make_mesh(["cpu", "cpu"])
    loc = Localizer(cfg, random_init=True, batch_size=3, seed=3, mesh=mesh)
    assert loc.device == torch.device("cpu")
    rng = np.random.RandomState(8)
    sat = (rng.rand(7, 64, 64, 3) * 255).astype(np.uint8)
    grd = rng.rand(7, 32, 128, 3).astype(np.float32)
    got = loc.predict(sat, grd)
    ref = Localizer(cfg, random_init=True, batch_size=2, seed=3,
                    device="cpu")
    want = ref.predict(sat, grd)
    for k, v in want.items():
        assert got[k].shape == (7,)
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert (np.abs(want["lateral_m"]) < 2.5 * cfg.shift_range_lat).all()
    with pytest.raises(ValueError, match="mesh=None"):
        loc.export("unused.zip")
