"""Port parity for the Ford model: ``LMS2GPFord`` trajectories and the Ford
``Localizer`` against the JAX package (``use_banded_warp=2``: the Pallas
kernels in interpret mode) on the same weights, images and extrinsics; the
JAX params importer and ``init_params`` on the Ford model; and the options
and inputs the port refuses.

``TINY`` is a 64x64 satellite patch (14.08 m at the Ford data's 0.22 m per
pixel), a 32x128 ground input and level 3.  The rig is near identity, as in
the JAX package's own Ford tests: its ground rows run along sat v, the JAX
kernel layout.  The Ford data's own rig, whose rows run along sat u and
which the JAX package's banded path cannot sample, is held to the JAX
gather path on both branches (``test_real_rig_*``).

Tolerances, and why (as tests/test_torch_lm_s2gp.py for KITTI S2GP):
* fp32 map: round 1 atol 1e-5 on the pose (measured 2.8e-7); all rounds
  atol 1e-4 (measured 5.4e-6), since an ulp of uv flips the floor cell of a
  few samples and the LM rounds amplify it.  The same on the implicit
  branch (K2's samples and ``lm_update_implicit``, what JAX evaluates with
  ``use_fused_moments=0`` and the port trains through): measured 3.0e-7
  and 8.3e-6.
* default bf16 map: whole trajectories start from each framework's own
  convolutions, which flip the bf16 rounding of some map values: atol 1e-3
  (measured 2.7e-5; KITTI S2GP's inputs read 4.4e-3 under a 1e-2 limit).
* ``Localizer`` (fp32 map, one iteration): atol 1e-3 m / deg.
* The re-init draws differ between frameworks, so every parity input keeps
  the poses inside +-2.5 and the tests assert that they do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.geometry import ford as jford
from highlyaccurate_tpu.models.ford import LMS2GPFord as JLMS2GPFord
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.ford import (LMS2GPFord, kernel_layout,
                                                  sample_layouts)
from highlyaccurate_tpu_torch.params import init_params, state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=2, level=3)
B = 2
SIDE_M = 64 * 0.22
R_FL = jford.qvec2rotmat([0.997, 0.01, 0.05, 0.02]).astype(np.float32)
T_FL = np.array([1.0, 0.5, -1.4], np.float32)


def _images(seed, n=B):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 64, 64, 3).astype(np.float32),
            rng.rand(n, 32, 128, 3).astype(np.float32))


def _rig(n=B):
    return (np.broadcast_to(R_FL, (n, 3, 3)).copy(),
            np.broadcast_to(T_FL, (n, 3)).copy())


def _params(seed):
    """A JAX LMS2GPFord params pytree: two initialised VGGUnet branches and
    the zero (1, 3) damping."""
    sat, grd = _images(seed, n=1)
    net = JVGGUnet(level=3)
    return {"SatFeatureNet": net.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(sat))["params"],
            "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 100),
                                      jnp.asarray(grd))["params"],
            "damping": np.zeros((1, 3), np.float32)}


def _port_model(params, **kw):
    model = LMS2GPFord(Config(**TINY, **kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _jax_traj(params, sat, grd, R, T, **kw):
    jmodel = JLMS2GPFord(cfg=JConfig(use_banded_warp=2, **TINY, **kw))
    want = jmodel.apply({"params": params}, jnp.asarray(sat),
                        jnp.asarray(grd), SIDE_M, jnp.asarray(R),
                        jnp.asarray(T), mode="trajectory",
                        rngs={"lm": jax.random.PRNGKey(3)})
    want = np.stack([np.asarray(w) for w in want], -1)   # [B, I, L, 3]
    assert want.shape == (B, TINY["N_iters"], 3, 3)
    # Ford: (lat, lon) = (pose u, pose v); keep both inside the range
    assert np.all(np.abs(want[..., :2]) < 2.5), "parity input left the range"
    assert np.abs(want).max() > 1e-3, "the pose never moved"
    return want


@pytest.mark.parametrize("bf16_map", [0, 1], ids=["fp32_map", "bf16_map"])
def test_trajectory_matches_jax(bf16_map):
    params = _params(0)
    sat, grd = _images(0)
    R, T = _rig()
    want = _jax_traj(params, sat, grd, R, T, banded_bf16_map=bf16_map)
    port = _port_model(params, banded_bf16_map=bf16_map)
    got = port(*(torch.from_numpy(a) for a in (sat, grd)), SIDE_M,
               *(torch.from_numpy(a) for a in (R, T)), mode="trajectory",
               generator=torch.Generator().manual_seed(3))
    got = np.stack([g.numpy() for g in got], -1)
    if bf16_map:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    else:
        np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_implicit_branch_matches_jax():
    """The banded implicit branch (K2's samples, ``lm_update_implicit``),
    which the port's training forward runs, against JAX's evaluation with
    ``use_fused_moments=0`` on the fp32 map."""
    params = _params(1)
    sat, grd = _images(1)
    R, T = _rig()
    want = _jax_traj(params, sat, grd, R, T, banded_bf16_map=0,
                     use_fused_moments=0)
    port = _port_model(params, banded_bf16_map=0)
    R, T = torch.from_numpy(R), torch.from_numpy(T)
    geo = (R, T, SIDE_M, kernel_layout(R))
    assert geo[3]               # this rig's rows run along sat v: JAX's layout
    with torch.no_grad():
        sf, _, gf, _ = port.extract_features(torch.from_numpy(sat),
                                             torch.from_numpy(grd))
        traj = port._run_rounds(torch.zeros(B, 3), sf, gf,
                                torch.Generator().manual_seed(3), True,
                                geo).numpy()
    np.testing.assert_allclose(traj[:, 0, 0], want[:, 0, 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(traj, want, atol=1e-4, rtol=0)


# the Ford data's front-left rig (quaternion w, x, y, z; translation)
REAL_R_FL = jford.qvec2rotmat(
    [0.496157034, -0.486630591, 0.507791308, -0.509084328]).astype(np.float32)
REAL_T_FL = np.array([1.470563, 0.405664, 1.243369], np.float32)
REAL_TINY = dict(TINY, grd_h=64, grd_w=256, sat_size=128)
REAL_SIDE_M = 128 * 0.22


def _real_rig_case():
    """Inputs, params, the port model and the JAX gather path's trajectory
    (fp32 map) under the Ford data's own rig, on a 128x128 patch of 28.16 m
    and a 64x256 ground input (at TINY's sizes its rows leave the patch and
    the pose never moves)."""
    rng = np.random.RandomState(0)
    sat = rng.rand(B, 128, 128, 3).astype(np.float32)
    grd = rng.rand(B, 64, 256, 3).astype(np.float32)
    R = np.broadcast_to(REAL_R_FL, (B, 3, 3)).copy()
    T = np.broadcast_to(REAL_T_FL, (B, 3)).copy()
    net = JVGGUnet(level=3)
    params = {"SatFeatureNet": net.init(jax.random.PRNGKey(0),
                                        jnp.asarray(sat[:1]))["params"],
              "GrdFeatureNet": net.init(jax.random.PRNGKey(100),
                                        jnp.asarray(grd[:1]))["params"],
              "damping": np.zeros((1, 3), np.float32)}
    jmodel = JLMS2GPFord(cfg=JConfig(use_banded_warp=0, banded_bf16_map=0,
                                     **REAL_TINY))
    want = np.stack([np.asarray(w) for w in jmodel.apply(
        {"params": params}, jnp.asarray(sat), jnp.asarray(grd), REAL_SIDE_M,
        jnp.asarray(R), jnp.asarray(T), mode="trajectory",
        rngs={"lm": jax.random.PRNGKey(2)})], -1)
    assert np.abs(want).max() > 1e-2 and np.all(np.abs(want[..., :2]) < 2.5)
    port = LMS2GPFord(Config(banded_bf16_map=0, **REAL_TINY), device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    tR, tT = torch.from_numpy(R), torch.from_numpy(T)
    assert not kernel_layout(tR)
    return port, torch.from_numpy(sat), torch.from_numpy(grd), tR, tT, want


def test_real_rig_matches_jax_gather_path():
    """The Ford data's own rig (camera forward -> body north): its ground
    rows run along sat u.  In the JAX package's kernel layout (sat axes
    swapped) every row is steeper than the validity guard allows, so its
    banded path samples nothing and the pose never moves; the port picks
    the unswapped layout and follows the JAX gather path, the reference's
    own sampler (``_real_rig_case``): round 1 atol 1e-5, all rounds atol
    1e-4 (measured 8.2e-7 and 1.6e-5; the two samplers differ at the map's
    edge and in the rows the guard drops)."""
    from highlyaccurate_tpu_torch.ops import banded_warp as tbw
    port, sat, grd, tR, tT, want = _real_rig_case()
    # the JAX layout drops every row of every level at the zero pose
    for slot in port._slots:
        A = 128 >> (3 - slot)
        uv01 = port._line_uv(torch.zeros(B, 3), slot, A,
                             (tR, tT, REAL_SIDE_M, True))[0].flip(-1)
        W = getattr(port, f"mask_{slot}").shape[1]
        coefs = tbw.pack_row_coefs(uv01[:, :, 0], uv01[:, :, 1], A,
                                   tbw.default_rb(A), W)
        assert torch.all(coefs[..., 0] == 1e9)
    got = np.stack([g.numpy() for g in port(
        sat, grd, REAL_SIDE_M, tR, tT, mode="trajectory",
        generator=torch.Generator().manual_seed(0))], -1)
    np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_real_rig_implicit_branch_matches_jax_gather_path():
    """The implicit branch the port trains through (K2's samples in the
    unswapped layout, du, dv = the kernel's dx, dy, ``lm_update_implicit``)
    under the Ford data's own rig, against the JAX gather path
    (``_real_rig_case``), with the tolerances of the moments branch:
    round 1 atol 1e-5, all rounds 1e-4 (measured 8.2e-7 and 1.6e-5)."""
    port, sat, grd, tR, tT, want = _real_rig_case()
    with torch.no_grad():
        sf, _, gf, _ = port.extract_features(sat, grd)
        traj = port._run_rounds(torch.zeros(B, 3), sf, gf,
                                torch.Generator().manual_seed(0), True,
                                (tR, tT, REAL_SIDE_M, False)).numpy()
    np.testing.assert_allclose(traj[:, 0, 0], want[:, 0, 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(traj, want, atol=1e-4, rtol=0)


def test_kernel_layout_follows_the_rows():
    """``sample_layouts``, a closed form of R_FL, against the rows'
    measured direction in the satellite map (``ford_uv_jac`` at the zero
    pose, summed over the kept rows of every level) for random rigs; a
    batch of mixed layouts raises."""
    rng = np.random.RandomState(4)
    q = rng.normal(size=(64, 4))
    R = np.stack([jford.qvec2rotmat(v / np.linalg.norm(v))
                  for v in q]).astype(np.float32)
    T = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    port = LMS2GPFord(Config(**TINY), device="cpu")
    tR, tT = torch.from_numpy(R), torch.from_numpy(T)
    got = sample_layouts(tR)
    np.testing.assert_array_equal(got, sample_layouts(R))
    assert 0 < got.sum() < len(got)
    for slot in port._slots:
        uv01 = port._line_uv(torch.zeros(64, 3), slot, 64 >> (3 - slot),
                             (tR, tT, SIDE_M, True))[0]
        live = (getattr(port, f"mask_{slot}") > 0).any(-1)
        du, dv = (uv01[:, :, 1] - uv01[:, :, 0]).abs()[:, live].sum(1).T
        np.testing.assert_array_equal(got, (dv >= du).numpy())
    assert kernel_layout(R[got]) and not kernel_layout(R[~got])
    with pytest.raises(ValueError, match="separate batches"):
        kernel_layout(R)


def test_localizer_serves_mixed_layouts_apart():
    """A Ford ``predict`` whose per-image rigs take both kernel layouts
    gives each image what a call with its layout's images alone gives
    (the model refuses such a batch whole)."""
    from highlyaccurate_tpu_torch.inference import Localizer
    rng = np.random.RandomState(5)
    sat = rng.rand(5, 64, 64, 3).astype(np.float32)
    grd = rng.rand(5, 32, 128, 3).astype(np.float32)
    real = np.array([0, 1, 0, 1, 1], bool)
    Rs = np.where(real[:, None, None], REAL_R_FL, R_FL)
    Ts = np.where(real[:, None], REAL_T_FL, T_FL)
    loc = Localizer(Config(**dict(TINY, N_iters=1)), random_init=True,
                    batch_size=2, device="cpu", ford_extrinsics=(R_FL, T_FL),
                    ford_side_m=SIDE_M)
    with pytest.raises(ValueError, match="separate batches"):
        loc.model(*(torch.from_numpy(a[:2]) for a in (sat, grd)), SIDE_M,
                  *(torch.from_numpy(a[:2]) for a in (Rs, Ts)),
                  generator=torch.Generator())
    got = loc.predict(sat, grd, R_FL=Rs, T_FL=Ts)
    for sel in (real, ~real):
        part = loc.predict(sat[sel], grd[sel], R_FL=Rs[sel], T_FL=Ts[sel])
        for key, v in part.items():
            assert got[key].shape == (5,)
            np.testing.assert_array_equal(got[key][sel], v, err_msg=key)


def test_localizer_matches_jax():
    """Ford ``Localizer.predict`` on the CPU against the JAX Localizer on
    the same params: the constructor rig, per-call [N, 3, 3] / [N, 3]
    extrinsics, a ragged tail, uint8 input and a warm start (Ford's u is
    lateral)."""
    from highlyaccurate_tpu.inference import Localizer as JLocalizer
    from highlyaccurate_tpu_torch.inference import Localizer

    kw = dict(TINY, N_iters=1, banded_bf16_map=0)
    params = _params(6)
    rng = np.random.RandomState(7)
    sat = (rng.rand(3, 64, 64, 3) * 255).astype(np.uint8)
    grd = rng.rand(3, 32, 128, 3).astype(np.float32)
    Rs = np.stack([jford.qvec2rotmat(q / np.linalg.norm(q)) for q in
                   [0.997, 0.01, 0.05, 0.02] + rng.uniform(
                       -0.02, 0.02, (3, 4))]).astype(np.float32)
    Ts = T_FL + rng.uniform(-0.2, 0.2, (3, 3)).astype(np.float32)
    init = {"lateral_m": rng.uniform(-2, 2, 3).astype(np.float32),
            "longitudinal_m": rng.uniform(-2, 2, 3).astype(np.float32),
            "heading_deg": rng.uniform(-1, 1, 3).astype(np.float32)}
    rig = dict(ford_extrinsics=(R_FL, T_FL), ford_side_m=SIDE_M)
    jloc = JLocalizer(JConfig(use_banded_warp=2, **kw), params=params,
                      batch_size=2, **rig)
    tloc = Localizer(Config(**kw), params=params, batch_size=2,
                     device="cpu", **rig)
    for call in (dict(), dict(R_FL=Rs, T_FL=Ts), dict(init_pose=init)):
        want = jloc.predict(sat, grd, **call)
        got = tloc.predict(sat, grd, **call)
        assert np.all(np.abs(want["lateral_m"]) < 2.5 * 20)
        for key in ("lateral_m", "longitudinal_m", "heading_deg"):
            assert got[key].shape == (3,) and got[key].dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], atol=1e-3,
                                       rtol=0, err_msg=f"{key} {list(call)}")
    assert not np.allclose(tloc.predict(sat, grd)["lateral_m"],
                           tloc.predict(sat, grd, R_FL=Rs,
                                        T_FL=Ts)["lateral_m"])


def test_jax_ford_params_load_and_init():
    """The JAX Ford model's own params pytree loads through
    ``state_dict_from_jax``; ``init_params`` zeroes the (1, 3) damping."""
    jmodel = JLMS2GPFord(cfg=JConfig(**TINY))
    sat, grd = _images(2, n=1)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(2)}, jnp.asarray(sat),
        jnp.asarray(grd),
        method=lambda m, s, g: (m.SatFeatureNet(s), m.GrdFeatureNet(g),
                                m.damping))
    model = LMS2GPFord(Config(**TINY), device="cpu")
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    variables["params"]))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    assert model.damping.shape == (1, 3)
    init_params(model, torch.Generator().manual_seed(0))
    assert torch.equal(model.damping, torch.zeros(1, 3))
    assert model.lm_cfg.active_dims == (0, 1, 2) and model.lm_cfg.reinit
    # the whole-DoF solve whatever the ranges freeze, as in JAX
    frozen = LMS2GPFord(Config(**TINY, rotation_range=0.0), device="cpu")
    assert frozen.lm_cfg.active_dims == (0, 1, 2)
    assert frozen.damping.shape == (1, 3)


REFUSED = {
    "Optimizer=ADAM": dict(Optimizer="ADAM"),
    "estimate_depth": dict(estimate_depth=1),
    "use_gt_depth": dict(use_gt_depth=1), "proj": dict(proj="polar"),
}


@pytest.mark.parametrize("opt", list(REFUSED.values()), ids=list(REFUSED))
def test_unsupported_ford_options_raise(opt):
    """What the port does not carry for Ford yet raises
    ``NotImplementedError`` naming it; ADAM, which Ford has no update rule
    for, ``ValueError``, as the JAX model does (its forward raises)."""
    from highlyaccurate_tpu_torch.inference import Localizer
    name = next(iter(opt))
    adam = opt.get("Optimizer") == "ADAM"
    with pytest.raises(ValueError if adam else NotImplementedError,
                       match="ADAM" if adam else name):
        Localizer(Config(**TINY, **opt), random_init=True, device="cpu",
                  ford_extrinsics=(R_FL, T_FL), ford_side_m=SIDE_M)
    if adam:
        sat, grd = _images(0)
        R, T = _rig()
        with pytest.raises(ValueError, match="ADAM"):
            JLMS2GPFord(cfg=JConfig(**TINY, **opt)).init(
                {"params": jax.random.PRNGKey(0),
                 "lm": jax.random.PRNGKey(1)}, jnp.asarray(sat),
                jnp.asarray(grd), SIDE_M, jnp.asarray(R), jnp.asarray(T),
                mode="trajectory")


# Options the port carries since the gather path came (they were refused
# before): each held to the JAX package on one init through the model's
# evaluation forward.  Banded cases on TINY's rig (JAX
# ``use_banded_warp=2``, fp32 map): round 1 atol 1e-5, all rounds 1e-4
# (measured 8.4e-7 / 3.2e-6 and 9.2e-7 / 4.7e-6 at KITTI S2GP's sizes).
# The gather sampler under the Ford data's own rig (``REAL_TINY``) against
# the JAX gather path, the same limits (measured 3.9e-7 / 4.1e-7).  bf16
# features against JAX at bf16: relL2 over the batch's poses, round 1 <=
# 2e-2 and final <= 0.15, the limits of tests/test_torch_bf16.py.
LIFTED = {
    "use_fused_moments": (dict(use_fused_moments=0, banded_bf16_map=0),
                          dict(use_banded_warp=2)),
    "use_implicit_lm": (dict(use_implicit_lm=0, banded_bf16_map=0),
                        dict(use_banded_warp=2)),
    "use_banded_warp": (dict(use_banded_warp=0), {}),
    "compute_dtype": (dict(compute_dtype="bfloat16"),
                      dict(use_banded_warp=2)),
}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", list(LIFTED))
def test_lifted_option_matches_jax(name):
    kw, jax_kw = LIFTED[name]
    real = name == "use_banded_warp"
    geom = REAL_TINY if real else TINY
    side = REAL_SIDE_M if real else SIDE_M
    rng = np.random.RandomState(9)
    A, H, W = geom["sat_size"], geom["grd_h"], geom["grd_w"]
    sat = rng.rand(B, A, A, 3).astype(np.float32)
    grd = rng.rand(B, H, W, 3).astype(np.float32)
    R, T = ((np.broadcast_to(REAL_R_FL, (B, 3, 3)).copy(),
             np.broadcast_to(REAL_T_FL, (B, 3)).copy()) if real else _rig())
    net = JVGGUnet(level=3)
    params = {"SatFeatureNet": net.init(jax.random.PRNGKey(9),
                                        jnp.asarray(sat[:1]))["params"],
              "GrdFeatureNet": net.init(jax.random.PRNGKey(109),
                                        jnp.asarray(grd[:1]))["params"],
              "damping": np.zeros((1, 3), np.float32)}
    jmodel = JLMS2GPFord(cfg=JConfig(**geom, **kw, **jax_kw))
    want = np.stack([np.asarray(w) for w in jmodel.apply(
        {"params": params}, jnp.asarray(sat), jnp.asarray(grd), side,
        jnp.asarray(R), jnp.asarray(T), mode="trajectory",
        rngs={"lm": jax.random.PRNGKey(3)})], -1)
    assert np.all(np.abs(want[..., :2]) < 2.5), "parity input left the range"
    assert np.abs(want).max() > 1e-2, "the pose never moved"
    port = LMS2GPFord(Config(**geom, **kw), device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    got = np.stack([g.numpy() for g in port(
        torch.from_numpy(sat), torch.from_numpy(grd), side,
        torch.from_numpy(R), torch.from_numpy(T), mode="trajectory",
        generator=torch.Generator().manual_seed(3))], -1)
    if name == "compute_dtype":
        assert _rel_l2(got[:, 0, 0], want[:, 0, 0]) <= 2e-2
        assert _rel_l2(got[:, -1, -1], want[:, -1, -1]) <= 0.15
        return
    np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_ford_entry_errors():
    from highlyaccurate_tpu_torch.inference import Localizer
    rig = (R_FL, T_FL)
    with pytest.raises(ValueError, match="both"):
        Localizer(Config(**TINY), random_init=True, device="cpu",
                  ford_extrinsics=rig)
    with pytest.raises(ValueError, match="both"):
        Localizer(Config(**TINY), random_init=True, device="cpu",
                  ford_side_m=SIDE_M)
    with pytest.raises(ValueError, match="S2GP-only"):
        Localizer(Config(**dict(TINY, direction="G2SP")), random_init=True,
                  device="cpu", ford_extrinsics=rig, ford_side_m=SIDE_M)
    loc = Localizer(Config(**TINY), random_init=True, device="cpu",
                    ford_extrinsics=rig, ford_side_m=SIDE_M)
    sat, grd = _images(0, n=2)
    R, T = _rig()
    with pytest.raises(ValueError, match="R_FL must have shape"):
        loc.predict(sat, grd, R_FL=R[:1], T_FL=T)
    with pytest.raises(ValueError, match="G2SP input"):
        loc.predict(sat, grd, camera_k=np.eye(3))
    kitti = Localizer(Config(**TINY), random_init=True, device="cpu")
    with pytest.raises(ValueError, match="Ford-chain"):
        kitti.predict(sat, grd, R_FL=R, T_FL=T)
    # loss method 1 trains through the gather sampler with its triplet
    # term (tests/test_torch_solver_train.py holds KITTI's to JAX); a
    # weighted solve has no covariance, as in JAX
    out = Localizer(Config(**TINY, loss_method=1), random_init=True,
                    device="cpu", ford_extrinsics=rig,
                    ford_side_m=SIDE_M).model(
        *(torch.from_numpy(a) for a in (sat, grd)), SIDE_M,
        *(torch.from_numpy(a) for a in (R, T)), mode="train",
        gt_pose=torch.full((2, 3), 0.5), generator=torch.Generator())
    assert out.L1 is not None and torch.isfinite(out.loss)
    with pytest.raises(ValueError, match="using_weight"):
        Localizer(Config(**TINY, using_weight=1), random_init=True,
                  device="cpu", ford_extrinsics=rig,
                  ford_side_m=SIDE_M).predict(sat, grd, return_cov=True)
