"""The projection and depth flags of both CLIs: ``--proj polar|nn`` and
``--use_gt_depth 1`` (KITTI), ``--proj polar``, ``--estimate_depth 1`` and
``--use_gt_depth 1`` (Ford).

* KITTI ``evaluate`` against the JAX CLI's on one init (float32 features,
  one iteration; every one of these options takes the gather sampler in
  both): S2GP ``--proj polar``, G2SP ``--proj nn`` (the re-laid-out ground
  branch and the in-plane warp) and S2GP ``--use_gt_depth 1`` (the CLI
  passes no depth, so the flat rays), within 5e-4 m / deg
  (tests/test_torch_cli_kitti.py's ``EVAL_ATOL``; measured 3.0e-6,
  2.5e-6 and 2.0e-6).  The Ford flags' ``evaluate`` parity is in
  tests/test_torch_cli_ford.py.
* One tiny training run of each flag through ``main`` (the train step and
  its checkpoint, then the evaluation): the flag reaches the model's
  config, the save path carries the JAX suffix (KITTI ``_polar``, ``_nn``,
  ``_depth``; Ford ``_polar``, ``_Depth1``, none for ``use_gt_depth``;
  JAX ``config.py:192-195, 228-233``) and the result files hold finite
  predictions.
"""

import os

import numpy as np
import pytest
import scipy.io

from highlyaccurate_tpu.cli import train_kitti as jcli
from highlyaccurate_tpu.config import config_from_args as jconfig_from_args
from highlyaccurate_tpu.train import step as jstep
from highlyaccurate_tpu_torch.cli import train_ford as ford_cli
from highlyaccurate_tpu_torch.cli import train_kitti as kitti_cli
from highlyaccurate_tpu_torch.config import config_from_args
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from test_torch_cli_kitti import (EVAL, G2SP, S2GP, _assert_in_range,
                                  _jax_params, _preds)
from test_torch_cli_solver_flags import FORD, KITTI, RUN, _built_config
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

EVAL_ATOL = 5e-4
EVAL_FLAGS = {
    "proj=polar": S2GP + ["--proj", "polar"],
    "proj=nn": G2SP + ["--proj", "nn"],
    "use_gt_depth": S2GP + ["--use_gt_depth", "1"],
}
KITTI_FLAGS = {
    "proj=polar": (["--proj", "polar"], "_polar"),
    "proj=nn": (["--proj", "nn"], "_nn"),
    "use_gt_depth": (["--use_gt_depth", "1"], "_depth"),
}
FORD_FLAGS = {
    "proj=polar": (["--proj", "polar"], "_polar"),
    "estimate_depth": (["--estimate_depth", "1"], "_Depth1"),
    "use_gt_depth": (["--use_gt_depth", "1"], ""),
}


def _check(seen, flags):
    """Every config ``build_model`` received holds the flags' values."""
    assert seen
    for cfg in seen:
        for k, v in zip(flags[::2], flags[1::2]):
            have = getattr(cfg, k[2:])
            assert have == type(have)(v), (k, have, v)


@pytest.mark.parametrize("name", list(EVAL_FLAGS))
def test_kitti_flag_evaluates_like_jax(tmp_path, name):
    argv = EVAL + EVAL_FLAGS[name]
    params = _jax_params(argv, 21)
    jargs = jcli.parse_args(argv)
    jcfg = jconfig_from_args(jargs)
    jmodel = jcli.build_model(jcfg)
    jdir = str(tmp_path / "jax")
    jcli.evaluate(jmodel, jcfg, params, jargs, "test1", jdir, 0, 1e9,
                  eval_step=jstep.make_eval_step(jmodel, jcfg))
    args = kitti_cli.parse_args(argv + ["--device", "cpu"])
    cfg = config_from_args(args)
    assert cfg.save_path("r") == jcfg.save_path("r")
    model = kitti_cli.build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(params))
    tdir = str(tmp_path / "torch")
    kitti_cli.evaluate(model, cfg, args, "test1", tdir, 0, 1e9)
    got, want = _preds(tdir, "Test1"), _preds(jdir, "Test1")
    _assert_in_range(want)
    assert np.abs(want).max() > 1e-2
    print(name, "eval max |port - JAX|:", np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=EVAL_ATOL)


@pytest.mark.parametrize("name", list(KITTI_FLAGS))
def test_kitti_flag_trains(tmp_path, monkeypatch, name):
    flags, suffix = KITTI_FLAGS[name]
    geom = G2SP if name == "proj=nn" else KITTI
    seen = _built_config(monkeypatch, kitti_cli)
    kitti_cli.main(RUN + flags + ["--save_root", str(tmp_path)] + geom)
    _check(seen, flags)
    save_path = seen[0].save_path(str(tmp_path))
    assert save_path.endswith(suffix)
    assert os.path.exists(os.path.join(save_path, "model_0.pth"))
    for split in ("Test1", "Test2"):
        mat = scipy.io.loadmat(os.path.join(save_path,
                                            f"{split}_results.mat"))
        assert np.isfinite(mat["pred_shifts"]).all(), split


@pytest.mark.parametrize("name", list(FORD_FLAGS))
def test_ford_flag_trains(tmp_path, monkeypatch, name):
    flags, suffix = FORD_FLAGS[name]
    seen = _built_config(monkeypatch, ford_cli)
    ford_cli.main(RUN + flags + ["--save_root", str(tmp_path)] + FORD)
    _check(seen, flags)
    save_path = seen[0].ford_paths(str(tmp_path))[1]
    assert save_path.endswith(suffix) if suffix else save_path.endswith(
        "_End1")
    mat = scipy.io.loadmat(os.path.join(save_path, "0_result.mat"))
    assert np.isfinite(mat["pred_shifts"]).all()
