"""Port parity for the KITTI CLI: ``highlyaccurate_tpu_torch.cli.
train_kitti`` (CPU, the kernels' plain versions) against the JAX CLI
``highlyaccurate_tpu.cli.train_kitti`` (``--use_banded_warp 2``: its Pallas
kernels in interpret mode, not its gather fallback) on the same weights
and the same synthetic data.

Tiny geometry both packages take: sat 64 and grd 32x128 for S2GP; sat 128
and a 64x256 ground for G2SP, so that every level's ground map takes the
projective-line sampler.  ``dropout=0`` and the synthetic poses lie inside
the ranges, so neither solver re-draws a pose (the random streams of the
two frameworks cannot match); the tests check that no prediction left the
re-init range.

* evaluation (S2GP and G2SP, fp32 features, bf16 map): ``evaluate`` of both
  CLIs on one JAX init converted by ``state_dict_from_jax``; the ``.mat``
  predictions within ``EVAL_ATOL`` (m and deg);
* training: one JAX init written as JAX ``model_0`` (orbax) and as the
  port's ``model_0.pth``; both CLIs run ``--resume 1 --epochs 2
  --synthetic 4 --batch_size 2`` (two Adam steps of epoch 1, then test1
  and test2); every tensor's weight update within ``UPDATE_REL_L2`` and
  its norm within ``UPDATE_NORM_RTOL``, the Test1 predictions within
  ``TRAIN_EVAL_ATOL``;
* ``--test 1`` on the port's own run reads ``model_1`` with bf16 features;
  ``--test 1 --import_pth`` at its faithful defaults (the gather sampler,
  the full G2SP grid, float32) agrees with the JAX CLI's within
  ``EVAL_ATOL`` (S2GP and G2SP); ``--test 1 --pose_hypotheses 2`` runs
  the multi-start sweep and writes its result files;
* ``--visualize`` writes the trajectory and feature-PCA files, and
  ``project_at_pose`` equals the JAX model's maps within
  ``PROJECT_ATOL``, also at headings whose rows fail the banded validity
  guard; ``--profile_dir`` writes a trace.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from highlyaccurate_tpu.cli import train_kitti as jcli
from highlyaccurate_tpu.config import config_from_args as jconfig_from_args
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu.train import step as jstep
from highlyaccurate_tpu.train.checkpoint import load_params as jload_params
from highlyaccurate_tpu.train.checkpoint import save_params as jsave_params
from highlyaccurate_tpu_torch.cli import train_kitti as cli
from highlyaccurate_tpu_torch.config import config_from_args
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

S2GP = ["--grd_h", "32", "--grd_w", "128", "--sat_size", "64"]
G2SP = ["--direction", "G2SP", "--grd_h", "64", "--grd_w", "256",
        "--sat_size", "128"]
EVAL = ["--test", "1", "--synthetic", "2", "--batch_size", "2",
        "--N_iters", "1", "--compute_dtype", "float32"]

# Tolerances, in m and deg of the .mat predictions (normalized pose x 20 m
# / 10 deg).  Three fp32 rounds on a bf16 map: the two frameworks' uv
# differ in the last bits, which moves a sample's bilinear weights (or its
# floor cell) slightly; measured 8.7e-5 (S2GP) and 2.3e-6 (G2SP).
EVAL_ATOL = 5e-4
# Two Adam steps on the bf16 map: Adam's update is about lr * sign(g), so
# the elements whose gradient lies within the frameworks' noise of zero
# (the bf16-map gradients agree to ~1.7e-3 relL2,
# tests/test_torch_train_step_bf16.py) may step the other way, by up to
# 2 lr per step.  Per tensor, measured: update relL2 up to 0.125
# (SatFeatureNet.conv5.bias), the update's norm within 0.5% of JAX's (a
# flipped sign keeps the size of a step; a wrong lr or step count would
# not).  The predictions of random weights after those steps then differ
# by up to 0.18 m / deg (measured).
UPDATE_REL_L2 = 0.25
UPDATE_NORM_RTOL = 2e-2
TRAIN_EVAL_ATOL = 0.5
# project_at_pose: the gather sampler at every pixel in both packages, on
# float32 maps (measured 3.6e-7 against values up to 3e-2).
PROJECT_ATOL = 1e-5


def _jax_params(cfg_args, seed):
    """A JAX params pytree as the JAX model creates it: two initialised
    VGGUnet branches and the damping (zero for S2GP, [1, 3] at
    ``cfg.damping`` for G2SP)."""
    cfg = jconfig_from_args(jcli.parse_args(cfg_args))
    rng = np.random.RandomState(seed)
    sat = rng.rand(1, cfg.sat_size, cfg.sat_size, 3).astype(np.float32)
    grd = rng.rand(1, cfg.grd_h, cfg.grd_w, 3).astype(np.float32)
    net = JVGGUnet(level=cfg.level)
    damping = (np.full((1, 3), cfg.damping, np.float32)
               if cfg.direction == "G2SP" else np.zeros((1, 3), np.float32))
    return {"SatFeatureNet": net.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(sat))["params"],
            "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 100),
                                      jnp.asarray(grd))["params"],
            "damping": damping}


def _preds(save_path, split):
    m = scipy.io.loadmat(os.path.join(save_path,
                                      f"{split}_results.mat"))
    return np.concatenate([m["pred_shifts"], m["pred_headings"]], axis=1)


def _assert_in_range(preds):
    # |normalized shift| < 2.5: no re-init draw (20 m ranges)
    assert np.all(np.abs(preds[:, :2]) < 2.5 * 20), preds


def _eval_pair(tmp_path, argv, seed):
    """Both CLIs' ``evaluate`` of test1 on one JAX init -> (port, JAX)
    predictions [N, 3] (lat m, lon m, heading deg)."""
    params = _jax_params(argv, seed)
    jargs = jcli.parse_args(argv + ["--use_banded_warp", "2"])
    jcfg = jconfig_from_args(jargs)
    jmodel = jcli.build_model(jcfg)
    jdir = str(tmp_path / "jax")
    jcli.evaluate(jmodel, jcfg, params, jargs, "test1", jdir, 0, 1e9,
                  eval_step=jstep.make_eval_step(jmodel, jcfg))

    args = cli.parse_args(argv + ["--device", "cpu"])
    cfg = config_from_args(args)
    model = cli.build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(params))
    tdir = str(tmp_path / "torch")
    cli.evaluate(model, cfg, args, "test1", tdir, 0, 1e9)
    for d in (jdir, tdir):
        assert os.path.exists(os.path.join(d, "Test1_results.txt"))
    return _preds(tdir, "Test1"), _preds(jdir, "Test1")


@pytest.mark.parametrize("family", ["S2GP", "G2SP"])
def test_evaluate_matches_jax(tmp_path, family):
    got, want = _eval_pair(tmp_path, EVAL + (S2GP if family == "S2GP"
                                             else G2SP), seed=3)
    _assert_in_range(want)
    print(family, "eval max |port - JAX|:", np.abs(got - want).max(0))
    np.testing.assert_allclose(got, want, rtol=0, atol=EVAL_ATOL)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_train_resume_matches_jax(tmp_path, monkeypatch):
    """Epoch 1 of ``--resume 1`` from one JAX init in both CLIs: the
    weight updates of two Adam steps and the Test1 predictions after
    them; then ``--test 1`` on the port's run evaluates ``model_1`` with
    bf16 features."""
    argv = (["--test", "0", "--resume", "1", "--epochs", "2", "--synthetic",
             "4", "--batch_size", "2", "--N_iters", "1"] + S2GP)
    params = _jax_params(argv, seed=5)
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jargv = argv + ["--use_banded_warp", "2", "--save_root", str(jroot)]
    targv = argv + ["--device", "cpu", "--save_root", str(troot)]
    jdir = jconfig_from_args(jcli.parse_args(jargv)).save_path(str(jroot))
    tdir = config_from_args(cli.parse_args(targv)).save_path(str(troot))
    assert os.path.relpath(jdir, jroot) == os.path.relpath(tdir, troot)

    jsave_params(jdir, "model_0", params)
    os.makedirs(tdir)
    torch.save(state_dict_from_jax(params), os.path.join(tdir,
                                                         "model_0.pth"))
    # the JAX CLI's init runs the whole model once only to get a params
    # template; the params themselves are that template
    monkeypatch.setattr(jcli, "init_model",
                        lambda cfg, model: {"params": params})
    monkeypatch.setattr(jstep, "make_mesh_for_batch",
                        lambda bs: jstep.make_mesh(jax.devices()[:1]))
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    jcli.main(jargv)
    cli.main(targv)

    before = state_dict_from_jax(params)
    jafter = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jload_params(jdir, "model_1", params)))
    tafter = torch.load(os.path.join(tdir, "model_1.pth"))
    assert tafter.keys() == before.keys()
    rel, norm = {}, {}
    for k in before:
        if k == "damping":
            continue
        d, w = ((a[k] - before[k]).numpy() for a in (tafter, jafter))
        rel[k] = _rel_l2(d, w)
        nd, nw = np.linalg.norm(d), np.linalg.norm(w)
        norm[k] = abs(nd / nw - 1.0) if nw > 0 else nd
    assert torch.equal(tafter["damping"], before["damping"])
    print("update relL2, worst:", max(rel.items(), key=lambda kv: kv[1]),
          "norm ratio, worst:", max(norm.items(), key=lambda kv: kv[1]))
    for k in rel:
        assert rel[k] <= UPDATE_REL_L2, (k, rel[k])
        assert norm[k] <= UPDATE_NORM_RTOL, (k, norm[k])

    got, want = _preds(tdir, "Test1"), _preds(jdir, "Test1")
    _assert_in_range(want)
    print("train eval max |port - JAX|:", np.abs(got - want).max(0))
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_EVAL_ATOL)
    for d in (jdir, tdir):
        with open(os.path.join(d, "Test2_results.txt")) as f:
            assert f.read().count("EPOCH: 1") == 1

    # --test 1 at the defaults: model_1 with bf16 features
    targs = cli.parse_args(["--test", "1", "--synthetic", "4",
                            "--batch_size", "2", "--N_iters", "1",
                            "--device", "cpu", "--save_root", str(troot)]
                           + S2GP)
    assert config_from_args(targs).compute_dtype == "bfloat16"
    cli.main(["--test", "1", "--synthetic", "4", "--batch_size", "2",
              "--N_iters", "1", "--device", "cpu", "--save_root",
              str(troot)] + S2GP)
    with open(os.path.join(tdir, "Test1_results.txt")) as f:
        assert f.read().count("EPOCH: 0") == 1
    assert np.isfinite(_preds(tdir, "Test1")).all()


def test_refused_options_name_themselves(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint 'model_1'"):
        cli.main(["--test", "1", "--device", "cpu",
                  "--save_root", str(tmp_path)] + S2GP)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--test", "1", "--save_root", str(tmp_path)] + S2GP)


@pytest.mark.parametrize("family", ["S2GP", "G2SP"])
def test_import_pth_faithful_matches_jax(tmp_path, monkeypatch, capsys,
                                         family):
    """``--test 1 --import_pth`` at its faithful defaults, which resolve to
    the gather sampler, the full G2SP grid and float32 features in both
    CLIs: the Test1 and Test2 predictions of one reference ``.pth``."""
    geom = S2GP if family == "S2GP" else G2SP
    params = _jax_params(geom, seed=9)
    pth = tmp_path / "ref.pth"
    torch.save(state_dict_from_jax(params), pth)
    argv = ["--test", "1", "--import_pth", str(pth), "--synthetic", "2",
            "--batch_size", "2", "--N_iters", "1"] + geom
    cfg = config_from_args(cli.parse_args(argv))
    assert (cfg.use_banded_warp, cfg.g2sp_restrict_grid,
            cfg.compute_dtype) == (0, 0, "float32")
    # the JAX CLI's init only gives the params template import_pth fills
    monkeypatch.setattr(jcli, "init_model",
                        lambda cfg, model: {"params": params})
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jcli.main(argv + ["--save_root", str(jroot)])
    cli.main(argv + ["--device", "cpu", "--save_root", str(troot)])
    assert "defaults to the reference-faithful gather sampler" in \
        capsys.readouterr().out
    for split in ("Test1", "Test2"):
        got = _preds(cfg.save_path(str(troot)), split)
        want = _preds(cfg.save_path(str(jroot)), split)
        _assert_in_range(want)
        print(family, split, "max |port - JAX|:", np.abs(got - want).max(0))
        np.testing.assert_allclose(got, want, rtol=0, atol=EVAL_ATOL)


def test_pose_hypotheses_evaluates(tmp_path):
    """``--test 1 --pose_hypotheses 2`` on the banded path (its plain
    versions here) evaluates with two starts per image and writes the
    result files of both splits."""
    pth = tmp_path / "ref.pth"
    torch.save(state_dict_from_jax(_jax_params(S2GP, seed=7)), pth)
    argv = ["--test", "1", "--import_pth", str(pth), "--use_banded_warp",
            "1", "--pose_hypotheses", "2", "--synthetic", "2",
            "--batch_size", "2", "--N_iters", "1", "--device", "cpu",
            "--save_root", str(tmp_path)] + S2GP
    cfg = config_from_args(cli.parse_args(argv))
    assert cfg.pose_hypotheses == 2
    cli.main(argv)
    for split in ("Test1", "Test2"):
        assert os.path.exists(os.path.join(cfg.save_path(str(tmp_path)),
                                           f"{split}_results.txt"))
        assert np.isfinite(_preds(cfg.save_path(str(tmp_path)), split)).all()


def test_import_pth_evaluates_on_banded_kernels(tmp_path):
    """``--import_pth`` with ``--use_banded_warp 1`` loads a reference
    ``.pth`` through ``params.load_pth`` and evaluates it."""
    params = _jax_params(S2GP, seed=8)
    pth = tmp_path / "ref.pth"
    torch.save(state_dict_from_jax(params), pth)
    argv = ["--test", "1", "--import_pth", str(pth), "--use_banded_warp",
            "1", "--synthetic", "2", "--batch_size", "2", "--N_iters", "1",
            "--device", "cpu", "--save_root", str(tmp_path)] + S2GP
    cfg = config_from_args(cli.parse_args(argv))
    assert cfg.compute_dtype == "float32" and cfg.use_banded_warp == 1
    cli.main(argv)
    assert np.isfinite(_preds(cfg.save_path(str(tmp_path)), "Test1")).all()


def test_visualize_and_profile_write_files(tmp_path, monkeypatch):
    """``--visualize 1`` (train loop and evaluation) and ``--profile_dir``
    over a 3-step epoch."""
    monkeypatch.chdir(tmp_path)  # plots land in ./visualize_rot<r>
    prof = tmp_path / "prof"
    cli.main(["--test", "0", "--epochs", "1", "--synthetic", "3",
              "--batch_size", "1", "--N_iters", "1", "--visualize", "1",
              "--profile_dir", str(prof), "--device", "cpu",
              "--save_root", str(tmp_path)] + S2GP)
    viz = tmp_path / "visualize_rot10.0"
    assert glob.glob(str(viz / "traj_0_0.png"))
    assert glob.glob(str(viz / "traj_test1_0.png"))
    # 3 levels x (sat, grd, proj at pred, proj at gt)
    assert len(glob.glob(str(viz / "feat_e0_l0_L*_0000_*.png"))) == 12
    traces = glob.glob(str(prof / "trace_*.json"))
    assert traces
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


# (rotation_range, normalized heading of the predicted pose): the tiny
# geometry's own range, and a heading of 54 deg, where the rows run steeper
# than the banded validity guard takes (|slope| >= 0.95 from about 44 deg)
PROJECT_CASES = {"default": (10.0, None), "steep_heading": (60.0, 0.9)}


@pytest.mark.parametrize("case", list(PROJECT_CASES))
def test_project_at_pose_matches_jax(case):
    """The ``--visualize`` maps: per level (sat_feat, grd_feat,
    proj_at_pred, proj_at_gt) of both models on one init."""
    from highlyaccurate_tpu.models.lm_s2gp import LMS2GP as JLMS2GP
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP

    rotation, heading = PROJECT_CASES[case]
    argv = ["--N_iters", "1", "--compute_dtype", "float32",
            "--rotation_range", str(rotation)] + S2GP
    params = _jax_params(argv, seed=11)
    jcfg = jconfig_from_args(jcli.parse_args(argv))
    cfg = config_from_args(cli.parse_args(argv))
    rng = np.random.RandomState(12)
    sat = rng.rand(1, 64, 64, 3).astype(np.float32)
    grd = rng.rand(1, 32, 128, 3).astype(np.float32)
    pred = rng.uniform(-0.5, 0.5, (1, 3)).astype(np.float32)
    gt = rng.uniform(-0.5, 0.5, (1, 3)).astype(np.float32)
    if heading is not None:
        pred[:, 2] = heading
    want = JLMS2GP(cfg=jcfg).apply(
        {"params": params}, *(jnp.asarray(a) for a in (sat, grd, pred, gt)),
        method="project_at_pose")
    model = LMS2GP(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    got = model.project_at_pose(*(torch.from_numpy(a)
                                  for a in (sat, grd, pred, gt)))
    assert len(got) == len(want) == 3
    for g_lvl, w_lvl in zip(got, want):
        for g, w in zip(g_lvl, w_lvl):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=PROJECT_ATOL)
        assert np.abs(np.asarray(w_lvl[2])).max() > 0  # the map is hit
