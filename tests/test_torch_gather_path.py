"""Port parity for the gather sampler path (``use_banded_warp=0``) of all
three families, and the banded options the gather path's updates serve,
against the JAX package on one init per family (CPU, seeded numpy inputs).

Sizes: KITTI S2GP on a 64x64 satellite and a 32x128 ground input; Ford on
128x128 (28.16 m) and 64x256 under the Ford data's own front-left rig (the
rig ``SyntheticFord`` carries; at Ford's smaller sizes its rows leave the
patch); G2SP on 128x128 and 64x256 (every level on the gather sampler),
and at a 32x128 ground input with JAX's ``use_banded_warp=2``, where the
coarse level's 4-row ground map takes the gather sampler and the other two
the projective-line kernels (``G2SP32``).  Level 3, ``N_iters=2``: six
rounds.  ``dropout=0`` and in-range poses, so no solver re-draws (the
tests assert it).

Tolerances, and why:
* the round-1 pose (normalized) atol 1e-5: the same gather, one solve
  (measured <= 1.8e-6);
* the 6-round trajectory atol 1e-4 (measured <= 6.3e-6, G2SP32, whose
  projective-line levels sample a bf16 copy of each framework's own ground
  map; 1.4e-6 elsewhere);

One training step through the gather path is in
tests/test_torch_gather_train.py.
"""

import functools

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
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.ford import LMS2GPFord
from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP, projline_slots
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP, _scaled_default_k
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 2
FAMILIES = {
    "S2GP": dict(grd_h=32, grd_w=128, sat_size=64),
    "Ford": dict(grd_h=64, grd_w=256, sat_size=128),
    "G2SP": dict(direction="G2SP", grd_h=64, grd_w=256, sat_size=128),
    "G2SP32": dict(direction="G2SP", grd_h=32, grd_w=128, sat_size=128),
}
REAL_R_FL = jford.qvec2rotmat(
    [0.496157034, -0.486630591, 0.507791308, -0.509084328]).astype(np.float32)
REAL_T_FL = np.array([1.470563, 0.405664, 1.243369], np.float32)


@functools.lru_cache(maxsize=None)
def _case(family):
    """Seeded images, gt poses and extra inputs (Ford rig / G2SP K), and
    one JAX init of the family's two branches and damping."""
    geom = FAMILIES[family]
    rng = np.random.RandomState(len(family))
    A, H, W = geom["sat_size"], geom["grd_h"], geom["grd_w"]
    sat = rng.rand(B, A, A, 3).astype(np.float32)
    grd = rng.rand(B, H, W, 3).astype(np.float32)
    gt = rng.uniform(-0.8, 0.8, (B, 3)).astype(np.float32)
    net = JVGGUnet(level=3)
    g2sp = family.startswith("G2SP")
    params = {"SatFeatureNet": net.init(jax.random.PRNGKey(1),
                                        jnp.asarray(sat[:1]))["params"],
              "GrdFeatureNet": net.init(jax.random.PRNGKey(2),
                                        jnp.asarray(grd[:1]))["params"],
              "damping": np.full((1, 3), 0.1 if g2sp else 0.0, np.float32)}
    if family == "Ford":
        extra = (A * 0.22, np.broadcast_to(REAL_R_FL, (B, 3, 3)).copy(),
                 np.broadcast_to(REAL_T_FL, (B, 3)).copy())
    elif g2sp:
        extra = (np.broadcast_to(_scaled_default_k(Config(**geom)),
                                 (B, 3, 3)).copy(),)
    else:
        extra = ()
    return sat, grd, gt, extra, params


def _cfg_kw(family, **kw):
    base = dict(FAMILIES[family], N_iters=2, level=3)
    if family != "G2SP32":
        base["use_banded_warp"] = 0
    return dict(base, **kw)


def _jax(family, **kw):
    cfg = JConfig(**dict(_cfg_kw(family, **kw), use_banded_warp=2)
                  if family == "G2SP32" else _cfg_kw(family, **kw))
    return {"S2GP": JLMS2GP, "Ford": JLMS2GPFord}.get(family, JLMG2SP)(
        cfg=cfg)


def _port(family, params, **kw):
    cls = {"S2GP": LMS2GP, "Ford": LMS2GPFord}.get(family, LMG2SP)
    model = cls(Config(**_cfg_kw(family, **kw)), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _torch_args(family, sat, grd, extra):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (sat, grd)]
    if family == "Ford":
        t += [extra[0]] + [torch.from_numpy(a) for a in extra[1:]]
    else:
        t += [torch.from_numpy(a) for a in extra]
    return t


def _fwd_kw(family):
    return ({} if family.startswith("G2SP")
            else dict(generator=torch.Generator().manual_seed(0)))


def test_g2sp32_mixes_the_samplers():
    assert projline_slots(Config(**_cfg_kw("G2SP32"))) == {
        0: False, 1: True, 2: True}
    assert not any(projline_slots(Config(**_cfg_kw("G2SP"))).values())


CASES = [(f, i) for f in FAMILIES for i in (1, 0)]


@pytest.mark.parametrize("family,implicit", CASES,
                         ids=[f"{f}-implicit{i}" for f, i in CASES])
def test_trajectory_matches_jax(family, implicit):
    """Round 1 and all six rounds of the evaluation trajectory, with
    ``use_implicit_lm`` 1 (``lm_update_implicit_pixel_norm`` /
    ``lm_update_implicit_pixel``) and 0 (``grid_sample`` with the Jacobian,
    ``lm_update``)."""
    sat, grd, _, extra, params = _case(family)
    kw = dict(use_implicit_lm=implicit)
    want = np.stack([np.asarray(w) for w in _jax(family, **kw).apply(
        {"params": params}, *(jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in (sat, grd, *extra)),
        mode="trajectory", rngs={"lm": jax.random.PRNGKey(3)})], -1)
    assert np.all(np.abs(want[..., :2]) < 2.5), "parity input left the range"
    assert np.abs(want).max() > 1e-2, "the pose never moved"
    with torch.no_grad():
        got = np.stack([g.numpy() for g in _port(family, params, **kw)(
            *_torch_args(family, sat, grd, extra), mode="trajectory",
            **_fwd_kw(family))], -1)
    print(family, implicit, "round 1:", np.abs(got - want)[:, 0, 0].max(),
          "all rounds:", np.abs(got - want).max())
    np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


BANDED = [("S2GP", dict(use_fused_moments=0)),
          ("S2GP", dict(use_implicit_lm=0))]


@pytest.mark.parametrize("family,kw", BANDED,
                         ids=[f"{f}-{next(iter(k))}" for f, k in BANDED])
def test_banded_options_match_jax(family, kw):
    """The banded path's other updates at evaluation (fp32 map, JAX
    ``use_banded_warp=2``): ``use_fused_moments=0`` (K2's samples and
    ``lm_update_implicit``) and ``use_implicit_lm=0`` (K2's samples, the
    row-affine Jacobian materialized, ``lm_update``).  Round 1 atol 1e-5;
    all rounds atol 2e-3: the banded path is not continuous in the pose
    (a row's band start and the edge quirk), and on these inputs JAX
    against itself with the satellite image perturbed by 1e-5 moves the
    sixth round by 9.2e-4, as much as the port differs from it (9.2e-4;
    1.4e-6 at round 1)."""
    sat, grd, _, extra, params = _case(family)
    kw = dict(kw, use_banded_warp=2, banded_bf16_map=0)
    want = np.stack([np.asarray(w) for w in _jax(family, **kw).apply(
        {"params": params}, jnp.asarray(sat), jnp.asarray(grd),
        mode="trajectory", rngs={"lm": jax.random.PRNGKey(3)})], -1)
    assert np.all(np.abs(want[..., :2]) < 2.5)
    with torch.no_grad():
        got = np.stack([g.numpy() for g in _port(family, params, **kw)(
            *_torch_args(family, sat, grd, extra), mode="trajectory",
            **_fwd_kw(family))], -1)
    print(family, kw, "round 1:", np.abs(got - want)[:, 0, 0].max(),
          "all rounds:", np.abs(got - want).max())
    np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_ford_project_at_pose_matches_jax():
    """The Ford ``--visualize`` maps through the gather sampler at every
    ground pixel, against JAX's ``project_at_pose`` (float32 maps; atol
    1e-5, measured in the KITTI twin at 3.6e-7)."""
    sat, grd, _, (side, R, T), params = _case("Ford")
    rng = np.random.RandomState(4)
    pred, gt = (rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
                for _ in range(2))
    want = JLMS2GPFord(cfg=JConfig(**_cfg_kw("Ford"))).apply(
        {"params": params}, jnp.asarray(sat), jnp.asarray(grd), side,
        jnp.asarray(R), jnp.asarray(T), jnp.asarray(pred), jnp.asarray(gt),
        method="project_at_pose")
    got = _port("Ford", params).project_at_pose(
        *_torch_args("Ford", sat, grd, (side, R, T)),
        torch.from_numpy(pred), torch.from_numpy(gt))
    assert len(got) == len(want) == 3
    for g_lvl, w_lvl in zip(got, want):
        for g, w in zip(g_lvl, w_lvl):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        assert np.abs(np.asarray(w_lvl[2])).max() > 0  # the map is hit
