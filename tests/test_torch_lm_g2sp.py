"""Port parity for the G2SP model: ``lm_update_implicit_pixel``, one solver
round, the ``LMG2SP`` trajectory, the G2SP ``Localizer`` and the ``corr``
head against the JAX package (``use_banded_warp=2``: the projective-line
kernel in interpret mode) on the same weights and images; the projections
served like JAX; and what the port refuses.

``TINY`` (128x128 satellite, 64x256 ground, level 3) keeps every level's
ground map on the projective-line sampler (8 / 16 / 32 rows; at a 32-row
ground input the coarse level would be 4 rows and JAX would take the gather
sampler instead), and drops 8 columns at the fine level (j0 = 0 / 0 / 8).

Tolerances, and why:
* ``lm_update_implicit_pixel`` and its VJP: 1e-5 relative (the same sums in
  another order, a 3x3 solve).
* One round per level on the JAX model's own features: atol 1e-5 on the
  pose; the bf16 cast sees identical inputs (measured up to 2.0e-7).
* Whole trajectories start from each framework's own convolutions, which
  differ by ~1e-6 relative; that flips the bf16 rounding of a few ground
  map values, and XLA's CPU code rounds the projective divide otherwise
  (an FMA): atol 1e-4 on the pose (measured 3.2e-6 over 6 rounds).
* ``Localizer``: atol 1e-3 m / deg, the same 1e-4 in normalized pose times
  the 20 m / 10 deg ranges, with margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.models.lm_g2sp import LMG2SP as JLMG2SP
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu.solver import updates as ju
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP, projline_slots
from highlyaccurate_tpu_torch.ops.projline import projline_supported
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from highlyaccurate_tpu_torch.solver import updates as tu
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

S, GH, GW = 128, 64, 256
TINY = dict(direction="G2SP", grd_h=GH, grd_w=GW, sat_size=S, N_iters=2,
            level=3)
B = 2
# the default K, rescaled to the 64x256 input as the KITTI loader does
K = np.array([[582.9802 * GW / 1024, 0.0, 496.2420 * GW / 1024],
              [0.0, 482.7076 * GH / 256, 125.0034 * GH / 256],
              [0.0, 0.0, 1.0]], np.float32)


def _images(seed, n=B):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, S, S, 3).astype(np.float32),
            rng.rand(n, GH, GW, 3).astype(np.float32))


def _camera_k(n=B):
    return np.broadcast_to(K, (n, 3, 3)).copy()


def _params(seed, damping=0.1):
    """A JAX LMG2SP params pytree: two initialised VGGUnet branches and
    the (1, 3) damping at its initial value."""
    sat, grd = _images(seed, n=1)
    net = JVGGUnet(level=3)
    return {"SatFeatureNet": net.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(sat))["params"],
            "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 100),
                                      jnp.asarray(grd))["params"],
            "damping": np.full((1, 3), damping, np.float32)}


def _port_model(params, **kw):
    model = LMG2SP(Config(**TINY, **kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


def test_tiny_levels_take_the_projline_sampler():
    model = LMG2SP(Config(**TINY), device="cpu")
    assert model._col_start == {0: 0, 1: 0, 2: 8}
    for slot, C in zip((0, 1, 2), (256, 128, 64)):
        f = 2 ** (3 - slot)
        assert projline_supported(GH // f, GW // f, C)


def _pixel_inputs(seed, H=6, W=5, C=4):
    rng = np.random.RandomState(seed)
    out, dx, dy, tgt = (rng.randn(B, H, W, C).astype(np.float32)
                        for _ in range(4))
    duv = rng.randn(B, H, W, 2, 3).astype(np.float32)
    pose = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    damping = rng.uniform(0.05, 0.2, (1, 3)).astype(np.float32)
    return pose, out, dx, dy, tgt, duv, damping


@pytest.mark.parametrize("train_damping", [0, 1])
def test_lm_update_implicit_pixel_and_vjp(train_damping):
    """The G2SP per-pixel update (raw damping, no re-init) and its VJP with
    respect to every input, against ``jax.vjp``."""
    args = _pixel_inputs(train_damping)
    jcfg = ju.LMConfig(active_dims=(0, 1, 2), train_damping=bool(
        train_damping), damping=0.1, normalize=False, reinit=False,
        raw_damping=True)
    tcfg = tu.LMConfig(active_dims=(0, 1, 2), train_damping=bool(
        train_damping), damping=0.1, reinit=False, raw_damping=True)

    def jfn(*a):
        return ju.lm_update_implicit_pixel(*a[:6], a[6], jcfg)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    ct = np.random.RandomState(9).randn(B, 3).astype(np.float32)
    want_g = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    got = tu.lm_update_implicit_pixel(*ts[:6], ts[6], tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    got.backward(torch.from_numpy(ct))
    for i, (t, w) in enumerate(zip(ts, want_g)):
        g = np.zeros_like(args[i]) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(w)).max()
                                   + 1e-7, err_msg=str(i))


def test_round_on_same_features():
    """One eval round per level on the JAX model's own features: the bf16
    map, K4's plain version, the line order and the per-pixel solve agree
    with the JAX round to 1e-5."""
    params = _params(4)
    jmodel = JLMG2SP(cfg=JConfig(use_banded_warp=2, **TINY))
    sat, grd = _images(4)
    net = JVGGUnet(level=3)
    sf, _ = net.apply({"params": params["SatFeatureNet"]}, jnp.asarray(sat))
    gf, _ = net.apply({"params": params["GrdFeatureNet"]}, jnp.asarray(grd))
    k = _camera_k()
    port = _port_model(params)
    pose = np.random.RandomState(5).uniform(-0.3, 0.3, (B, 3)).astype(
        np.float32)

    def jround(m, pose, lvl):
        level_round = m._make_level_round(sf, gf, [None] * 3,
                                          jnp.asarray(k), "test", False)
        return level_round(pose, lvl)[0]

    for lvl, slot in enumerate((0, 1, 2)):
        want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(pose),
                                       lvl, method=jround))
        j0 = port._col_start[slot]
        got = port._solver_round(
            torch.from_numpy(pose), slot,
            torch.from_numpy(np.array(gf[lvl])).to(torch.bfloat16),
            torch.from_numpy(np.array(sf[lvl]))[:, :, j0:].transpose(1, 2),
            torch.from_numpy(k)).numpy()
        assert np.abs(got - pose).max() > 1e-4   # the round moved the pose
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_trajectory(jcfg, params, sat, grd, k):
    """The JAX model's trajectory outputs, jitted (its interpret-mode
    kernels and gather rounds run several times faster compiled)."""
    model = JLMG2SP(cfg=jcfg)

    def fwd(p, s, g, kk):
        return model.apply({"params": p}, s, g, kk, mode="trajectory")

    return jax.jit(fwd)(params, jnp.asarray(sat), jnp.asarray(grd),
                        jnp.asarray(k))


def _trajectories(seed):
    params = _params(seed)
    sat, grd = _images(seed)
    k = _camera_k()
    want = _jax_trajectory(JConfig(use_banded_warp=2, **TINY), params, sat,
                           grd, k)
    port = _port_model(params)
    got = port(torch.from_numpy(sat), torch.from_numpy(grd),
               torch.from_numpy(k), mode="trajectory")
    want = np.stack([np.asarray(w) for w in want], -1)  # [B, I, L, 3]
    got = np.stack([g.numpy() for g in got], -1)
    assert got.shape == want.shape == (B, TINY["N_iters"], 3, 3)
    return got, want, port, (sat, grd, k)


def test_trajectory_matches_jax():
    got, want, port, (sat, grd, k) = _trajectories(0)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the training forward samples the same bf16 map through the autograd
    # function and contracts K4's samples in torch (lm_update_implicit_pixel
    # on g2sp_uv_jac), where evaluation contracts them line by line (K7's
    # plain version): the same poses up to the order of the sums
    gt = torch.zeros(B, 3)
    with torch.no_grad():
        test = port(torch.from_numpy(sat), torch.from_numpy(grd),
                    torch.from_numpy(k), mode="test")
    out = port(torch.from_numpy(sat), torch.from_numpy(grd),
               torch.from_numpy(k), mode="train", gt_pose=gt)
    assert out.loss.requires_grad
    # loss_func method 0 against a zero gt: the last-level L1 errors
    np.testing.assert_allclose(
        out.shift_lat_last[-1].detach().numpy(),
        np.abs(test[0].numpy()).mean(), rtol=1e-5, atol=0)


def test_localizer_matches_jax():
    """G2SP ``Localizer.predict`` on the CPU against the JAX Localizer on
    the same params: a constructor K, a per-call [N, 3, 3] K, a ragged
    tail, uint8 input and a warm start."""
    from highlyaccurate_tpu.inference import Localizer as JLocalizer
    from highlyaccurate_tpu_torch.inference import Localizer

    kw = dict(TINY, N_iters=1)
    params = _params(6)
    rng = np.random.RandomState(7)
    sat = (rng.rand(3, S, S, 3) * 255).astype(np.uint8)
    grd = rng.rand(3, GH, GW, 3).astype(np.float32)
    ks = _camera_k(3) * rng.uniform(0.95, 1.05, (3, 1, 1)).astype(np.float32)
    ks[:, 2] = [0.0, 0.0, 1.0]
    init = {"lateral_m": rng.uniform(-2, 2, 3).astype(np.float32),
            "longitudinal_m": rng.uniform(-2, 2, 3).astype(np.float32),
            "heading_deg": rng.uniform(-1, 1, 3).astype(np.float32)}
    jloc = JLocalizer(JConfig(use_banded_warp=2, **kw), params=params,
                      batch_size=2, camera_k=K)
    tloc = Localizer(Config(**kw), params=params, batch_size=2, device="cpu",
                     camera_k=K)
    for call in (dict(), dict(camera_k=ks), dict(init_pose=init)):
        want = jloc.predict(sat, grd, **call)
        got = tloc.predict(sat, grd, **call)
        for key in ("lateral_m", "longitudinal_m", "heading_deg"):
            assert got[key].shape == (3,) and got[key].dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], atol=1e-3,
                                       rtol=0, err_msg=f"{key} {list(call)}")
    assert not np.allclose(tloc.predict(sat, grd)["lateral_m"],
                           tloc.predict(sat, grd, camera_k=ks)["lateral_m"])


# Options the port carries since the gather path came (they were refused
# before): ``banded_bf16_map=0`` leaves the banded path in JAX
# (lm_g2sp.py:230-234), as ``use_banded_warp=0`` does, so every level
# takes the gather sampler; with bf16 features (``compute_dtype``) it
# samples the bf16 ground maps.  Each trajectory against JAX's on one init:
# round 1 atol 1e-5 and all rounds 1e-4 (measured 8.4e-8 and 2.2e-7 at
# use_banded_warp=0); bf16 features relL2 over the batch's poses, round 1
# <= 2e-2 and final <= 0.15 (tests/test_torch_bf16.py's limits).  The
# solver options G2SP has no rule of its own for leave the fast paths in
# JAX (lm_g2sp.py:230-234, 263-264) for the gather ``lm_update`` on the
# whole grid: ``using_weight`` (weighted by the projected ground
# confidence) and ``Optimizer`` SGD or NN (plain LM), at the JAX default
# use_banded_warp=2 (measured round 1 / all rounds 1.6e-7 / 2.7e-7,
# 3.8e-7 / 3.8e-7 and the same for NN).
LIFTED = {
    "banded_bf16_map": (dict(banded_bf16_map=0), dict(use_banded_warp=2)),
    "use_banded_warp": (dict(use_banded_warp=0), {}),
    "compute_dtype": (dict(banded_bf16_map=0, compute_dtype="bfloat16"),
                      dict(use_banded_warp=2)),
    "using_weight": (dict(using_weight=1), dict(use_banded_warp=2)),
    "Optimizer": (dict(Optimizer="SGD"), dict(use_banded_warp=2)),
    "Optimizer_NN": (dict(Optimizer="NN"), dict(use_banded_warp=2)),
}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", list(LIFTED))
def test_lifted_option_matches_jax(name):
    from highlyaccurate_tpu_torch.models.lm_g2sp import projline_slots
    kw, jax_kw = LIFTED[name]
    assert not any(projline_slots(Config(**TINY, **kw)).values())
    params = _params(12)
    sat, grd = _images(13)
    k = _camera_k()
    want = np.stack([np.asarray(w) for w in _jax_trajectory(
        JConfig(**TINY, **kw, **jax_kw), params, sat, grd, k)], -1)
    assert np.abs(want).max() > 1e-2, "the pose never moved"
    port = _port_model(params, **kw)
    with torch.no_grad():
        got = np.stack([g.numpy() for g in port(
            torch.from_numpy(sat), torch.from_numpy(grd),
            torch.from_numpy(k), mode="trajectory")], -1)
    if name == "compute_dtype":
        assert _rel_l2(got[:, 0, 0], want[:, 0, 0]) <= 2e-2
        assert _rel_l2(got[:, -1, -1], want[:, -1, -1]) <= 0.15
        return
    print(name, "round 1, all rounds:", np.abs(got - want)[:, 0, 0].max(),
          np.abs(got - want).max())
    np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# The projections other than geo (refused before), ``Localizer.predict``
# against the JAX Localizer on one init, one iteration: ``proj="nn"`` (the
# re-laid-out ground branch and the in-plane warp over the whole satellite
# grid) and ``proj="polar"`` (``g2sp_uv_jac`` without the column
# restriction); both on the gather sampler, atol 1e-3 m / deg as
# test_localizer_matches_jax (measured 2.4e-7 and 4.1e-6).
PROJ = ("nn", "polar")


@pytest.mark.parametrize("proj", PROJ)
def test_proj_options_serve_like_jax(proj):
    from highlyaccurate_tpu.inference import Localizer as JLocalizer
    from highlyaccurate_tpu_torch.inference import Localizer

    kw = dict(TINY, N_iters=1, proj=proj)
    assert not any(projline_slots(Config(**kw)).values())
    params = _params(14)
    sat, grd = _images(15, n=3)
    want = JLocalizer(JConfig(use_banded_warp=2, **kw), params=params,
                      batch_size=2, camera_k=K).predict(sat, grd)
    loc = Localizer(Config(**kw), params=params, batch_size=2, device="cpu",
                    camera_k=K)
    assert loc.model.GrdFeatureNet.g2s_rearrange == (proj == "nn")
    got = loc.predict(sat, grd)
    keys = ("lateral_m", "longitudinal_m", "heading_deg")
    g = np.stack([got[k] for k in keys], -1)
    w = np.stack([want[k] for k in keys], -1)
    assert np.abs(w).max() > 1e-2, "the pose never moved"
    print(proj, "max |port - JAX|:", np.abs(g - w).max())
    np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def test_g2sp_corr_head_parity():
    """The dense correlation head at every level of the level-3 model
    (search window +-2 m), against JAX on the same weights: the test-mode
    estimates equal, the train loss within 1e-5 relative.  Both
    feature networks get a gradient."""
    kw = dict(shift_range_lat=2.0, shift_range_lon=2.0)
    params = _params(5)
    jmodel = JLMG2SP(cfg=JConfig(**TINY, **kw))
    sat, grd = _images(5)
    gt = np.random.RandomState(5).uniform(-0.5, 0.5, (B, 3)).astype(
        np.float32)
    k = jnp.asarray(_camera_k())
    want_loss, want_uv = jax.jit(lambda p: (
        jmodel.apply({"params": p}, sat, grd, k, gt, mode="train",
                     method="corr"),
        jmodel.apply({"params": p}, sat, grd, k, mode="test",
                     method="corr")))(params)
    model = _port_model(params, **kw)
    ts = [torch.from_numpy(a) for a in (sat, grd, _camera_k())]
    loss = model.corr(*ts, torch.from_numpy(gt), mode="train")
    loss.backward()
    for net in (model.SatFeatureNet, model.GrdFeatureNet):
        assert any(p.grad is not None and p.grad.abs().max() > 0
                   for p in net.parameters())
    print("corr loss port / JAX:", float(loss), float(want_loss))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    with torch.no_grad():
        got_uv = model.corr(*ts, mode="test")
    for g, w in zip(got_uv, want_uv):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_g2sp_refusals_and_errors():
    from highlyaccurate_tpu_torch.inference import Localizer
    # a 32-row ground input: the coarse level's map is 4 rows, which the
    # JAX package samples with the gather sampler, and so does the port
    # (tests/test_torch_gather_path.py holds it to JAX)
    mixed = LMG2SP(Config(**dict(TINY, grd_h=32, grd_w=128)), device="cpu")
    assert mixed._projline == {0: False, 1: True, 2: True}
    loc = Localizer(Config(**TINY), random_init=True, device="cpu")
    sat, grd = _images(0, n=1)
    with pytest.raises(ValueError, match="camera intrinsics"):
        loc.predict(sat, grd)
    with pytest.raises(ValueError, match="camera_k must have shape"):
        loc.predict(sat, grd, camera_k=_camera_k(2))
    with pytest.warns(UserWarning, match="UNCALIBRATED"):
        out = loc.predict(sat, grd, camera_k=K, return_cov=True)
    assert out["cov"].shape == (sat.shape[0], 3, 3)
    loc1 = Localizer(Config(**TINY, loss_method=1), random_init=True,
                     device="cpu")
    loc1.predict(sat, grd, camera_k=K)    # serving ignores the loss
    with pytest.raises(ValueError, match="loss_method 0 only"):
        loc1.model(torch.from_numpy(sat), torch.from_numpy(grd),
                   torch.from_numpy(_camera_k(1)), mode="train",
                   gt_pose=torch.zeros(1, 3))


def test_s2gp_unchanged():
    """S2GP still takes no camera_k, zero-initialises its damping and
    re-inits; G2SP initialises its (1, 3) damping at cfg.damping."""
    from highlyaccurate_tpu_torch.inference import Localizer
    s2gp = dict(TINY, direction="S2GP", grd_h=32, grd_w=128)
    with pytest.raises(ValueError, match="G2SP input"):
        Localizer(Config(**s2gp), random_init=True, device="cpu",
                  camera_k=K)
    loc = Localizer(Config(**s2gp), random_init=True, device="cpu")
    sat, grd = _images(0, n=1)
    with pytest.raises(ValueError, match="G2SP input"):
        loc.predict(sat[:, :S, :S], grd[:, :32, :128], camera_k=K)
    assert torch.equal(loc.model.damping, torch.zeros(1, 3))
    assert tu.LMConfig().reinit and not tu.LMConfig().raw_damping
    g2sp = Localizer(Config(**TINY, damping=0.3), random_init=True,
                     device="cpu")
    assert torch.equal(g2sp.model.damping, torch.full((1, 3), 0.3))
