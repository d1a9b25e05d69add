"""The solver-option flags of both CLIs (``--Optimizer``,
``--beta1`` / ``--beta2``, ``--using_weight``, ``--dropout``,
``--level_first``, ``--loss_method``) on one tiny training run each: the
flag reaches the model's config, the run trains one epoch of synthetic
data and evaluates, and its result files hold finite predictions.  The
models' parity with the JAX package under these options is in
tests/test_torch_solver_options.py and tests/test_torch_solver_train.py.
"""

import os

import numpy as np
import pytest
import scipy.io

from highlyaccurate_tpu_torch.cli import train_ford as ford_cli
from highlyaccurate_tpu_torch.cli import train_kitti as kitti_cli
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

KITTI = ["--grd_h", "32", "--grd_w", "128", "--sat_size", "64"]
# the Ford data's rig leaves a small patch: a 64x256 ground input
FORD = ["--grd_h", "64", "--grd_w", "256", "--sat_size", "128"]
RUN = ["--test", "0", "--epochs", "1", "--synthetic", "2", "--batch_size",
       "2", "--N_iters", "1", "--device", "cpu"]
FLAGS = {
    "Optimizer=SGD": ["--Optimizer", "SGD"],
    "Optimizer=ADAM,beta1,beta2": ["--Optimizer", "ADAM", "--beta1", "0.8",
                                   "--beta2", "0.99"],
    "Optimizer=NN": ["--Optimizer", "NN"],
    "using_weight": ["--using_weight", "1"],
    "dropout": ["--dropout", "1"],
    "level_first": ["--level_first", "1"],
    "loss_method": ["--loss_method", "1"],
}
FORD_FLAGS = dict(FLAGS, **{"Optimizer=GN": ["--Optimizer", "GN"]})
del FORD_FLAGS["Optimizer=ADAM,beta1,beta2"]   # Ford has no ADAM rule
FORD_FLAGS["loss_method"] = ["--loss_method", "2"]


def _expected(argv):
    """The config fields the flags set."""
    pairs = dict(zip(argv[::2], argv[1::2]))
    return {k[2:]: (v if k == "--Optimizer" else float(v))
            for k, v in pairs.items()}


def _built_config(monkeypatch, cli):
    """Record the config each ``build_model`` call receives."""
    seen = []
    build = cli.build_model

    def spy(cfg, device):
        seen.append(cfg)
        return build(cfg, device)

    monkeypatch.setattr(cli, "build_model", spy)
    return seen


def _check(seen, flags):
    assert seen
    for cfg in seen:
        for k, v in _expected(flags).items():
            assert getattr(cfg, k) == v, (k, getattr(cfg, k), v)


@pytest.mark.parametrize("name", list(FLAGS))
def test_kitti_cli_flag_trains(tmp_path, monkeypatch, name):
    seen = _built_config(monkeypatch, kitti_cli)
    kitti_cli.main(RUN + FLAGS[name] + ["--save_root", str(tmp_path)]
                   + KITTI)
    _check(seen, FLAGS[name])
    save_path = seen[0].save_path(str(tmp_path))
    for split in ("Test1", "Test2"):
        mat = scipy.io.loadmat(os.path.join(save_path,
                                            f"{split}_results.mat"))
        assert np.isfinite(mat["pred_shifts"]).all(), split


@pytest.mark.parametrize("name", list(FORD_FLAGS))
def test_ford_cli_flag_trains(tmp_path, monkeypatch, name):
    seen = _built_config(monkeypatch, ford_cli)
    ford_cli.main(RUN + FORD_FLAGS[name] + ["--save_root", str(tmp_path)]
                  + FORD)
    _check(seen, FORD_FLAGS[name])
    save_path = seen[0].ford_paths(str(tmp_path))[1]
    mat = scipy.io.loadmat(os.path.join(save_path, "0_result.mat"))
    assert np.isfinite(mat["pred_shifts"]).all()
