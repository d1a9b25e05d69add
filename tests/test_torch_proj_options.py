"""Port parity for the projection options of KITTI S2GP and G2SP on the
CPU: ``proj`` polar and nn and ``use_gt_depth`` (with and without a
``gt_depth=`` input), against the JAX package on the same weights
(``state_dict_from_jax``) and inputs.

Every option leaves the banded path in JAX, so both frameworks run the
gather sampler.  Pieces: the polar rays (``grd_img2cam_polar``, host
numpy, bit for bit), the in-plane warp of G2SP ``proj="nn"``
(``inplane_uv_jac``), VGGUnet's G2S re-layout (``g2s_rearrange``) at
float32 and bf16, each option's trajectory and training forward, and the
``gt_depth=`` lift at a depth size that is not a multiple of the level
sizes, with -1 holes, through the single start, ``with_info`` and the
multi-start sweep (``gt_depth`` tiled with the hypotheses).

Sizes as tests/test_torch_solver_options.py: 64x64 satellite, 32x128
ground (so G2SP nn has 2 * grd_h == sat == grd_w / 2 at every level),
level 3, N_iters 2, float32 features.  Limits:

* polar rays exact; the in-plane warp's uv and d(uv)/d(pose) within 1e-4
  and 1e-5 pixels (float32 sums of coordinates up to 32 px; measured
  3.8e-6 and 0);
* G2S features and confidences rtol 1e-4 / atol 1e-5 at float32 (as
  tests/test_torch_vggunet.py), relL2 <= 1e-2 at bf16 (as
  tests/test_torch_bf16.py);
* trajectories: round 1 atol 1e-5, all rounds 1e-4 (normalized pose; as
  tests/test_torch_solver_options.py); ``with_info``'s covariance relative
  Frobenius <= 1e-3 (tests/test_torch_serving_api.py's limit);
* training forwards: loss within 1e-5 relative, each parameter's gradient
  relL2 <= 3e-2 (tests/test_torch_solver_train.py's limit).

The measured deltas are in ROADMAP.md section C.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.geometry import kitti as jgeom
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu_torch.geometry import kitti as geom
from highlyaccurate_tpu_torch.models import lm_s2gp
from highlyaccurate_tpu_torch.models.vggunet import VGGUnet
from highlyaccurate_tpu_torch.params import _branch, state_dict_from_jax
from test_torch_multi_start import _feed_starts
from test_torch_solver_options import (B, _images, extras, jax_model,
                                       jax_params, port_model)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRAD_REL = 3e-2
COV_REL = 1e-3

CASES = {
    "S2GP-polar": ("S2GP", dict(proj="polar")),
    "S2GP-nn": ("S2GP", dict(proj="nn")),
    "S2GP-use_gt_depth": ("S2GP", dict(use_gt_depth=1)),
    "G2SP-nn": ("G2SP", dict(proj="nn")),
    "G2SP-polar": ("G2SP", dict(proj="polar")),
}
TRAIN = ("S2GP-polar", "S2GP-gt_depth", "G2SP-nn", "G2SP-polar")
STARTS = np.array([[[0.0, 0.0, 0.0], [0.5, -0.4, 0.3]],
                   [[0.0, 0.0, 0.0], [-0.3, 0.45, -0.5]]], np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _gt_depth(seed, n=B, hw=(37, 150)):
    """A depth map of a size no level divides, 1-30 m, with about 10% of
    pixels -1 (unknown)."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(1.0, 30.0, (n,) + hw).astype(np.float32)
    d[rng.rand(n, *hw) < 0.1] = -1.0
    return d


def _jax_apply(family, params, sat, grd, gt_depth=None, **kw):
    """The JAX model's outputs of ``kw["mode"]``, jitted."""
    cfg_kw = {k: v for k, v in kw.items() if k not in ("mode", "with_info",
                                                        "gt")}
    model = jax_model(family, **cfg_kw)
    mode = kw.get("mode", "trajectory")
    call = dict(mode=mode, rngs={"lm": jax.random.PRNGKey(3)})
    if kw.get("with_info"):
        call["with_info"] = True

    def fwd(p, s, g, *ex):
        if gt_depth is not None:
            call["gt_depth"] = jnp.asarray(gt_depth)
        return model.apply({"params": p}, s, g, *ex, **call)

    ex = [jnp.asarray(e) for e in extras(family)]
    return jax.jit(fwd)(params, jnp.asarray(sat), jnp.asarray(grd), *ex)


def _port_apply(model, family, sat, grd, gt_depth=None, mode="trajectory",
                **call):
    args = [torch.from_numpy(sat), torch.from_numpy(grd)]
    args += [torch.from_numpy(e) for e in extras(family)]
    if family != "G2SP":
        call["generator"] = torch.Generator().manual_seed(0)
    if gt_depth is not None:
        call["gt_depth"] = torch.from_numpy(gt_depth)
    with torch.no_grad():
        return model(*args, mode=mode, **call)


def _stack(out):
    return np.stack([np.asarray(o) for o in out], -1)


def test_polar_rays_match_jax():
    for h, w in ((4, 16), (8, 32), (37, 150)):
        want = jgeom.grd_img2cam_polar(h, w)
        got = geom.grd_img2cam_polar(h, w)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
    rays = lm_s2gp.precompute_rays(lm_s2gp.Config(proj="nn", grd_h=32,
                                                  grd_w=128))
    assert all(r[2] is None for r in rays)


def test_inplane_uv_jac_matches_jax():
    pose = np.random.RandomState(1).uniform(-1, 1, (3, 3)).astype(
        np.float32)
    for A in (8, 32):
        want = jgeom.inplane_uv_jac(jnp.asarray(pose), A, 10.0, 20.0, 20.0)
        got = geom.inplane_uv_jac(torch.from_numpy(pose), A, 10.0, 20.0,
                                  20.0)
        for g, w, tol in zip(got, want, (1e-4, 1e-5, 0)):
            assert tuple(g.shape) == tuple(w.shape)
            print(A, "max |port - JAX|", np.abs(g.numpy() - w).max())
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vggunet_g2s_matches_jax(dtype):
    x = np.random.RandomState(2).rand(2, 32, 128, 3).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jnet = JVGGUnet(level=3, g2s_rearrange=True, dtype=jdt)
    params = jnet.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    want_f, want_c = jnet.apply({"params": params}, jnp.asarray(x))
    net = VGGUnet(3, getattr(torch, dtype), g2s_rearrange=True)
    net.load_state_dict(_branch(params, ""))
    with torch.no_grad():
        got_f, got_c = net(torch.from_numpy(x))
    # slot 0: the re-laid-out feature map, the confidence before it
    assert tuple(got_f[0].shape) == (2, 8, 8, 256)
    assert tuple(got_c[0].shape) == (2, 4, 16, 1)
    for g, w in zip(got_f + got_c, list(want_f) + list(want_c)):
        assert tuple(g.shape) == tuple(w.shape)
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "bfloat16":
            assert _rel_l2(g, w) <= 1e-2, _rel_l2(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def _check_trajectory(name, got, want):
    assert got.shape == want.shape == (B, 2, 3, 3)
    assert np.abs(want[..., :2]).max() < 2.5, "parity input left the range"
    assert np.abs(want).max() > 1e-3, "the pose never moved"
    d = np.abs(got - want)
    print(name, "round 1, all rounds max |port - JAX|:", d[:, 0, 0].max(),
          d.max())
    np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case):
    family, kw = CASES[case]
    params = jax_params(family, 40)
    sat, grd = _images(41)
    model = port_model(family, params, **kw)
    assert not any(n.startswith("rows01") for n, _ in model.named_buffers())
    want = _stack(_jax_apply(family, params, sat, grd, **kw))
    got = _stack(_port_apply(model, family, sat, grd))
    _check_trajectory(case, got, want)


@pytest.mark.parametrize("call", ["trajectory", "with_info",
                                  "pose_hypotheses"])
def test_gt_depth_lift_matches_jax(call, monkeypatch):
    """``use_gt_depth`` with a [B, 37, 150] ``gt_depth`` (no level size
    divides it; -1 holes): every round gathers on the lifted rays; the
    covariance of ``with_info`` and the multi-start sweep (2 starts,
    ``gt_depth`` tiled with them) read the same lift."""
    kw = dict(use_gt_depth=1)
    params = jax_params("S2GP", 42)
    sat, grd = _images(43)
    gt_depth = _gt_depth(44)
    model = port_model("S2GP", params, **kw)
    if call == "trajectory":
        want = _stack(_jax_apply("S2GP", params, sat, grd, gt_depth, **kw))
        got = _stack(_port_apply(model, "S2GP", sat, grd, gt_depth))
        flat = _stack(_port_apply(model, "S2GP", sat, grd))
        assert np.abs(flat - got).max() > 1e-3, "the lift changed nothing"
        _check_trajectory("gt_depth", got, want)
        return
    if call == "pose_hypotheses":
        kw["pose_hypotheses"] = 2
        _feed_starts(monkeypatch, STARTS)
        model = port_model("S2GP", params, **kw)
    want = _jax_apply("S2GP", params, sat, grd, gt_depth, mode="test",
                      with_info=True, **kw)
    got = _port_apply(model, "S2GP", sat, grd, gt_depth, mode="test",
                      with_info=True)
    d = np.abs(_stack(got[:3]) - _stack(want[:3])).max()
    cov = _rel_l2(got[3].numpy(), np.asarray(want[3]))
    print(call, "pose max |port - JAX|", d, "cov relative Frobenius", cov)
    assert np.abs(_stack(want[:3])).max() > 1e-3
    assert d <= 1e-4 and cov <= COV_REL


def _train_case(case):
    """(family, config kw, gt_depth or None) of a training-forward case."""
    if case == "S2GP-gt_depth":
        return "S2GP", dict(use_gt_depth=1), _gt_depth(45)
    family, kw = CASES[case]
    return family, kw, None


@pytest.mark.parametrize("case", TRAIN)
def test_train_forward_matches_jax(case):
    family, kw, gt_depth = _train_case(case)
    kw = dict(kw, N_iters=1, train_damping=1)
    params = jax_params(family, 46)
    sat, grd = _images(47)
    gt = np.random.RandomState(48).uniform(-0.5, 0.5, (B, 3)).astype(
        np.float32)
    jmodel = jax_model(family, **kw)
    ex = [jnp.asarray(e) for e in extras(family)]
    call = {} if gt_depth is None else dict(gt_depth=jnp.asarray(gt_depth))

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(sat), jnp.asarray(grd),
                           *ex, jnp.asarray(gt), mode="train",
                           rngs={"lm": jax.random.PRNGKey(3)}, **call)
        return out.loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    model = port_model(family, params, **kw)
    args = [torch.from_numpy(sat), torch.from_numpy(grd)]
    args += [torch.from_numpy(e) for e in extras(family)]
    fwd = dict(gt_pose=torch.from_numpy(gt))
    if family == "S2GP":
        fwd["generator"] = torch.Generator().manual_seed(0)
    if gt_depth is not None:
        fwd["gt_depth"] = torch.from_numpy(gt_depth)
    out = model(*args, mode="train", **fwd)
    out.loss.backward()
    loss = float(out.loss.detach())
    print(case, "loss", loss, "JAX", float(jloss))
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    rel = {}
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        rel[name] = _rel_l2(got, want)
    worst = max(rel, key=rel.get)
    print(case, "worst gradient relL2", worst, rel[worst])
    assert rel[worst] <= GRAD_REL, (worst, rel[worst])
    assert np.abs(jgrads["GrdFeatureNet.conv0.weight"].numpy()).max() > 0
