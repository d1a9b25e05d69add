"""Port parity for the Ford CLI: ``highlyaccurate_tpu_torch.cli.train_ford``
(CPU, the kernels' plain versions) against the JAX CLI
``highlyaccurate_tpu.cli.train_ford`` on the same weights and the same
synthetic data.

``SyntheticFord`` carries the Ford data's own front-left rig, whose ground
rows run along sat u: the JAX package's banded path samples nothing under
it (ROADMAP C), and on the CPU its CLI's default resolves to the gather
path anyway.  So the CLIs are held to each other on the gather sampler
(``--use_banded_warp 0``), on a 128x128 patch (28.16 m) and a 64x256
ground input (at smaller sizes the rig's rows leave the patch), level 3,
one iteration.  The synthetic poses lie inside the ranges and
``dropout=0``, so no solver re-draws a pose (the tests check that no
prediction left the re-init range).

* evaluation: ``evaluate`` of both CLIs on one JAX init converted by
  ``state_dict_from_jax``, the ``<log>_result.mat`` predictions within
  ``EVAL_ATOL`` (m and deg); the port's default banded path (bf16 map, the
  layout it picks for the rig) against the JAX gather path within
  ``BANDED_ATOL``;
* training: one JAX init written as JAX ``model_0`` (orbax) and as the
  port's ``model_0.pth``; both CLIs run ``--resume 1 --epochs 2
  --synthetic 4 --batch_size 2`` (two Adam steps of epoch 1, then the
  test log); every tensor's weight update within ``UPDATE_REL_L2`` and its
  norm within ``UPDATE_NORM_RTOL``, the predictions within
  ``TRAIN_EVAL_ATOL``; then ``--test 1`` reads ``Model_best`` with bf16
  features;
* ``--transformer 1`` restores ``Model_best`` of the base experiment and
  leaves both feature networks bit-equal while the damping trains;
* ``write_ford`` writes the same files, line for line, as JAX's on the
  same results;
* ``--test 1 --pose_hypotheses 2`` runs the multi-start sweep and writes
  its result files;
* the refusals name their option; ``--visualize`` and ``--profile_dir``
  write their files.
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

from highlyaccurate_tpu.cli import train_ford as jcli
from highlyaccurate_tpu.config import config_from_args as jconfig_from_args
from highlyaccurate_tpu.eval import metrics as jmetrics
from highlyaccurate_tpu.models.ford import LMS2GPFord as JLMS2GPFord
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu.train import step as jstep
from highlyaccurate_tpu.train.checkpoint import load_params as jload_params
from highlyaccurate_tpu.train.checkpoint import save_params as jsave_params
from highlyaccurate_tpu_torch.cli import train_ford as cli
from highlyaccurate_tpu_torch.config import config_from_args
from highlyaccurate_tpu_torch.eval import metrics
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEOM = ["--grd_h", "64", "--grd_w", "256", "--sat_size", "128"]
EVAL = ["--test", "1", "--synthetic", "2", "--batch_size", "2",
        "--N_iters", "1", "--compute_dtype", "float32"] + GEOM
GATHER = ["--use_banded_warp", "0"]
# a test that only checks which files a run writes takes a smaller
# geometry (where the rig's rows leave the patch and the pose stays put)
SMALL = ["--grd_h", "32", "--grd_w", "128", "--sat_size", "64"]

# Tolerances, in m and deg of the .mat predictions (normalized pose x 20 m
# / 10 deg).  Both CLIs on the gather sampler at float32: the same
# samples, three rounds (measured 7.7e-7).
EVAL_ATOL = 5e-4
# The port's default banded path (bf16 map) against JAX's gather path at
# float32: the bf16 quantisation of the map over three rounds (measured
# 0.014 m / 0.068 deg; KITTI S2GP's bf16 map moves 6 rounds by 4.4e-3 of
# the range, ROADMAP C).
BANDED_ATOL = 0.1
# Two Adam steps: Adam steps about lr * sign(g), so elements whose
# gradient lies within the frameworks' noise of zero may step the other
# way (tests/test_torch_cli_kitti.py); the norm of each update stays
# within 2% of JAX's.  Measured: update relL2 up to 0.067
# (SatFeatureNet.conv_dec2.1.weight), norms within 0.22%, predictions
# after the steps within 1.2e-2 m / deg.
UPDATE_REL_L2 = 0.25
UPDATE_NORM_RTOL = 2e-2
TRAIN_EVAL_ATOL = 0.5


def _jax_params(seed):
    """A JAX LMS2GPFord params pytree: two initialised VGGUnet branches and
    the zero (1, 3) damping."""
    rng = np.random.RandomState(seed)
    sat = rng.rand(1, 128, 128, 3).astype(np.float32)
    grd = rng.rand(1, 64, 256, 3).astype(np.float32)
    net = JVGGUnet(level=3)
    return {"SatFeatureNet": net.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(sat))["params"],
            "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 100),
                                      jnp.asarray(grd))["params"],
            "damping": np.zeros((1, 3), np.float32)}


def _preds(save_path, ind=0):
    m = scipy.io.loadmat(os.path.join(save_path, f"{ind}_result.mat"))
    return np.concatenate([m["pred_shifts"], m["pred_headings"]], axis=1)


def _assert_in_range(preds):
    # |normalized shift| < 2.5: no re-init draw (20 m ranges)
    assert np.all(np.abs(preds[:, :2]) < 2.5 * 20), preds


def _port_eval(tmp_path, argv, params, tag):
    args = cli.parse_args(argv + ["--device", "cpu"])
    cfg = config_from_args(args)
    model = cli.build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(params))
    tdir = str(tmp_path / tag)
    rank = cli.evaluate(model, cfg, args, tdir, 0, 1e9)
    assert 0.0 <= rank <= 100.0
    assert not os.path.exists(os.path.join(tdir, "Model_best.pth"))
    return _preds(tdir)


def test_evaluate_matches_jax(tmp_path):
    """``evaluate`` of both CLIs on the gather sampler, one init; and the
    port's default banded path against that."""
    params = _jax_params(3)
    jargs = jcli.parse_args(EVAL + GATHER)
    jcfg = jconfig_from_args(jargs)
    jmodel = JLMS2GPFord(cfg=jcfg)
    jdir = str(tmp_path / "jax")
    jcli.evaluate(jmodel, jcfg, params, jargs, jdir, 0, 1e9,
                  eval_step=jstep.make_eval_step(jmodel, jcfg,
                                                 ford_side_m=128 * 0.22))
    want = _preds(jdir)
    _assert_in_range(want)
    assert np.abs(want).max() > 1e-2

    got = _port_eval(tmp_path, EVAL + GATHER, params, "gather")
    print("gather eval max |port - JAX|:", np.abs(got - want).max(0))
    np.testing.assert_allclose(got, want, rtol=0, atol=EVAL_ATOL)
    banded = _port_eval(tmp_path, EVAL, params, "banded")
    print("banded eval max |port - JAX gather|:",
          np.abs(banded - want).max(0))
    np.testing.assert_allclose(banded, want, rtol=0, atol=BANDED_ATOL)
    with open(os.path.join(tmp_path, "jax", "0_results.txt")) as f:
        jlines = f.read().splitlines()
    with open(os.path.join(tmp_path, "gather", "0_results.txt")) as f:
        tlines = f.read().splitlines()
    assert len(tlines) == len(jlines)
    assert [ln.split(":")[0] for ln in tlines] == \
        [ln.split(":")[0] for ln in jlines]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_train_resume_matches_jax(tmp_path, monkeypatch):
    """Epoch 1 of ``--resume 1`` from one JAX init in both CLIs on the
    gather sampler: the weight updates of two Adam steps and the test-log
    predictions after them; then ``--test 1`` on the port's run reads
    ``Model_best`` with bf16 features."""
    argv = (["--test", "0", "--resume", "1", "--epochs", "2", "--synthetic",
             "4", "--batch_size", "2", "--N_iters", "1"] + GEOM + GATHER)
    params = _jax_params(5)
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jargv = argv + ["--save_root", str(jroot)]
    targv = argv + ["--device", "cpu", "--save_root", str(troot)]
    jdir = jconfig_from_args(jcli.parse_args(jargv)).save_path_ford(
        str(jroot))
    tdir = config_from_args(cli.parse_args(targv)).save_path_ford(str(troot))
    assert os.path.relpath(jdir, jroot) == os.path.relpath(tdir, troot)

    jsave_params(jdir, "model_0", params)
    os.makedirs(tdir)
    torch.save(state_dict_from_jax(params), os.path.join(tdir,
                                                         "model_0.pth"))
    # the JAX CLI's init runs the whole model once only to get a params
    # template; the params themselves are that template
    monkeypatch.setattr(JLMS2GPFord, "init",
                        lambda self, *a, **kw: {"params": params})
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

    got, want = _preds(tdir), _preds(jdir)
    _assert_in_range(want)
    print("train eval max |port - JAX|:", np.abs(got - want).max(0))
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_EVAL_ATOL)
    for d in (jdir, tdir):
        with open(os.path.join(d, "0_results.txt")) as f:
            assert f.read().count("EPOCH: 1") == 1
    # the rank of epoch 1 beat 0 only if some sample was within 5 m and
    # 1 deg; Model_best exists in both runs or in neither
    assert os.path.exists(os.path.join(tdir, "Model_best.pth")) == \
        os.path.isdir(os.path.join(jdir, "Model_best"))

    # --test 1 at the defaults: Model_best with bf16 features
    torch.save(tafter, os.path.join(tdir, "Model_best.pth"))
    targs = ["--test", "1", "--synthetic", "2", "--batch_size", "2",
             "--N_iters", "1", "--device", "cpu", "--save_root",
             str(troot)] + GEOM
    assert config_from_args(cli.parse_args(targs)).compute_dtype == \
        "bfloat16"
    cli.main(targs)
    with open(os.path.join(tdir, "0_results.txt")) as f:
        assert f.read().count("EPOCH: 0") == 1
    assert np.isfinite(_preds(tdir)).all()


def test_transformer_keeps_backbones(tmp_path):
    """``--transformer 1``: ``Model_best`` of the base experiment seeds the
    model, the feature networks' gradients are zeroed, so both stay
    bit-equal over an epoch while the damping (``--train_damping 1``)
    trains; the run writes into the ``_transformer`` experiment."""
    argv = ["--test", "0", "--epochs", "1", "--synthetic", "2",
            "--batch_size", "1", "--N_iters", "1", "--train_damping", "1",
            "--device", "cpu", "--save_root", str(tmp_path)] + GEOM
    cfg = config_from_args(cli.parse_args(argv + ["--transformer", "1"]))
    restore, save = cfg.ford_paths(str(tmp_path))
    base = config_from_args(cli.parse_args(argv)).save_path_ford(
        str(tmp_path))
    assert restore == base and save == base + "_transformer"
    best = state_dict_from_jax(_jax_params(7))
    os.makedirs(restore)
    torch.save(best, os.path.join(restore, "Model_best.pth"))
    cli.main(argv + ["--transformer", "1"])
    after = torch.load(os.path.join(save, "model_0.pth"))
    for k, v in best.items():
        if k.startswith(("SatFeatureNet.", "GrdFeatureNet.")):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["damping"], best["damping"])


def test_write_ford_matches_jax(tmp_path):
    """The per-log result files of one set of results, line for line, and
    the rank."""
    rng = np.random.RandomState(0)
    args = (rng.uniform(-8, 8, (12, 2)), rng.uniform(-3, 3, (12, 1)),
            rng.uniform(-8, 8, (12, 2)), rng.uniform(-3, 3, (12, 1)))
    args[0][:4] = args[2][:4] + 0.1            # some within 5 m and 1 deg
    args[1][:4] = args[3][:4] + 0.2
    ranks = []
    for tag, mod in (("torch", metrics), ("jax", jmetrics)):
        res = mod.EvalResults(*args, time_per_image=0.25)
        for epoch in (0, 1):
            ranks.append(mod.write_ford(res, str(tmp_path / tag), 2, epoch))
    assert ranks[:2] == ranks[2:] and ranks[0] > 0
    for name in ("2_results.txt",):
        with open(tmp_path / "torch" / name) as f, \
                open(tmp_path / "jax" / name) as g:
            assert f.read().splitlines() == g.read().splitlines()
    t = scipy.io.loadmat(str(tmp_path / "torch" / "2_result.mat"))
    j = scipy.io.loadmat(str(tmp_path / "jax" / "2_result.mat"))
    for k in ("gt_shifts", "gt_headings", "pred_shifts", "pred_headings"):
        np.testing.assert_array_equal(t[k], j[k])


REFUSED = {"estimate_depth": ["--estimate_depth", "1"],
           "use_gt_depth": ["--use_gt_depth", "1"],
           "proj": ["--proj", "polar"]}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_options_name_themselves(tmp_path, name):
    with pytest.raises(NotImplementedError, match=name):
        cli.main(["--test", "1", "--device", "cpu", "--save_root",
                  str(tmp_path)] + GEOM + REFUSED[name])


def test_pose_hypotheses_evaluates(tmp_path):
    """``--test 1 --pose_hypotheses 2`` on the banded path (its plain
    versions here) evaluates with two starts per image and writes the
    result files."""
    pth = tmp_path / "ref.pth"
    torch.save(state_dict_from_jax(_jax_params(seed=7)), pth)
    argv = ["--test", "1", "--import_pth", str(pth), "--use_banded_warp",
            "1", "--pose_hypotheses", "2", "--synthetic", "2",
            "--batch_size", "2", "--N_iters", "1", "--device", "cpu",
            "--save_root", str(tmp_path)] + GEOM
    cfg = config_from_args(cli.parse_args(argv))
    assert cfg.pose_hypotheses == 2
    cli.main(argv)
    save_path = cfg.ford_paths(str(tmp_path))[1]
    assert os.path.exists(os.path.join(save_path, "0_results.txt"))
    assert np.isfinite(_preds(save_path)).all()


def test_entry_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint 'Model_best'"):
        cli.main(["--test", "1", "--device", "cpu",
                  "--save_root", str(tmp_path)] + GEOM)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--test", "1", "--save_root", str(tmp_path)] + GEOM)


def test_visualize_and_profile_write_files(tmp_path, monkeypatch):
    """``--visualize 1`` (train loop and evaluation, through the Ford
    ``project_at_pose``) and ``--profile_dir`` over a 3-step epoch."""
    monkeypatch.chdir(tmp_path)  # plots land in ./visualize_ford_rot<r>
    prof = tmp_path / "prof"
    cli.main(["--test", "0", "--epochs", "1", "--synthetic", "3",
              "--batch_size", "1", "--N_iters", "1", "--visualize", "1",
              "--profile_dir", str(prof), "--device", "cpu",
              "--save_root", str(tmp_path)] + SMALL)
    viz = tmp_path / "visualize_ford_rot10.0"
    assert glob.glob(str(viz / "traj_0_0.png"))
    assert glob.glob(str(viz / "traj_test_log0_e0.png"))
    # 3 levels x (sat, grd, proj at pred, proj at gt)
    assert len(glob.glob(str(viz / "feat_e0_l0_L*_0000_*.png"))) == 12
    traces = glob.glob(str(prof / "trace_*.json"))
    assert traces
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
