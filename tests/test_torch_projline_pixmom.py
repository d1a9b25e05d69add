"""Port parity for K6, the fused per-pixel moments of G2SP evaluation
(``highlyaccurate_tpu_torch.ops.projline.projline_pixmom``), its update
``lm_update_pixel_moments``, and ``LMG2SP`` with ``g2sp_pixel_moments=1``.

* The plain K6 against JAX ``make_projline_pixmom(interpret=True)`` in the
  three layouts of the JAX package's own test (full map, channels-first
  column blocks, channels-last column blocks; AY = 16), on the same packed
  coefficients and a bf16-exact map.  XLA's CPU code rounds the projective
  divide as an FMA (tests/test_torch_projline_sampler.py), which moves x
  and y by ulps and the samples by up to ~1e-4 of their O(1) values; the
  moments sum C such products.  Limit per lane: 1e-4 x max|JAX lane| + 1e-6
  (measured up to 2.1e-5).
* The same on the hand-made lines of ``chip_smoke.edge_projlines`` (a pole
  inside the line, dd = 0, dnx = 0, dny = 0, samples converging on one
  cell, lines along x = AX-2 and y = AY-2, a guard line, |dd| = 1e-7),
  each package's ``pack_projline_coefs`` on its side, at the same limit.
* ``lm_update_pixel_moments`` against JAX's on the same 16-lane moments:
  rtol 1e-5 (the same sums in another order, a 3x3 solve); on the port's
  own 5 lanes it equals ``lm_update_implicit_pixel`` to 1e-5.
* ``LMG2SP`` trajectories (128x128 satellite, 64x256 ground, level 3, 2
  iterations): against JAX with ``use_banded_warp=2`` atol 1e-4 on the pose,
  the limit of the K4 path (tests/test_torch_lm_g2sp.py; measured 8.1e-6);
  against the port's own K4 path on the same weights (K4, then K7's plain
  version): atol 1e-5, the same samples with the sums over pixels taken
  line by line and the per-pixel Jacobian formed from each line's affine
  points (measured 4.0e-7 over 6 rounds).
* The CUDA kernel against the plain version, on the card only:
  |err| <= 1e-5 x max|plain lane| + 1e-6, also on the hand-made lines
  written straight into lanes 0-5, and a second launch bit for bit; it
  raises on a channel count that is no multiple of 8.

The JAX package is imported inside the tests that use it, so the card test
runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_projline_pixmom.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (EDGE_AX, EDGE_AY, edge_projline_coefs,
                        edge_projlines)
from highlyaccurate_tpu_torch.ops import projline as tpl
from highlyaccurate_tpu_torch.solver import updates as tu
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _jax():
    import jax
    import jax.numpy as jnp

    from highlyaccurate_tpu.ops.pallas import banded_warp as jbw
    return jax, jnp, jbw


def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _projlines(B, AY, AX, V, W, seed):
    """Random projective lines (h0, dh) [B, V, 3] with gentle slopes and
    den > 0 (the lines of the JAX package's test_projline_pixmom_parity)."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(2, AX - 14, (B, V))
    y0 = rng.uniform(2, AY - 4, (B, V))
    sl = rng.uniform(-0.4, 0.4, (B, V))
    step = rng.uniform(1.0, 3.0, (B, V))
    d0 = rng.uniform(0.8, 1.6, (B, V))
    dd = rng.uniform(-0.02, 0.02, (B, V))
    h0 = np.stack([x0 * d0, y0 * d0, d0], -1).astype(np.float32)
    h1x = (x0 + step * (W - 1)) * (d0 + dd * (W - 1))
    h1y = (y0 + sl * step * (W - 1)) * (d0 + dd * (W - 1))
    h1 = np.stack([h1x, h1y, d0 + dd * (W - 1)], -1).astype(np.float32)
    return h0, ((h1 - h0) / (W - 1)).astype(np.float32)


@pytest.mark.parametrize("C,AX", [(8, 48), (8, 256), (128, 256)],
                         ids=["fullmap", "cfirst-blk", "cl-blk"])
def test_reference_matches_jax_pixmom(C, AX):
    jax, jnp, jbw = _jax()
    B, AY, V, W = 2, 16, 6, 12
    rng = np.random.RandomState(81)
    img = _bf16_exact(rng.rand(B, AY, AX, C).astype(np.float32))
    tgt = rng.rand(B, V, W, C).astype(np.float32)
    h0, dh = _projlines(B, AY, AX, V, W, seed=82)
    coefs = tpl.pack_projline_coefs(torch.from_numpy(h0),
                                    torch.from_numpy(dh), AY, AX, AY, W)
    pix = jbw.make_projline_pixmom(AY=AY, AX=AX, C=C, V=V, W=W,
                                   interpret=True)
    want = np.asarray(pix(jnp.asarray(img), jnp.asarray(tgt),
                          jnp.asarray(coefs.numpy())))     # [B, V, W, 16]
    got = tpl.projline_pixmom(torch.from_numpy(img), torch.from_numpy(tgt),
                              coefs, W).numpy()
    assert got.shape == (B, V, W, 5) and got.dtype == np.float32
    assert set(tpl.PIXMOM_IDX.items()) == set(jbw.PIXMOM_IDX.items())
    assert not want[..., 5:].any()
    kept = tpl._projline_cells(coefs, W, AY, AX)[4].numpy() > 0
    assert kept.mean() > 0.5
    assert not got[~kept].any()          # dropped samples: every lane zero
    for name, lane in tpl.PIXMOM_IDX.items():
        scale = np.abs(want[..., lane]).max()
        assert scale > 0
        np.testing.assert_allclose(got[..., lane], want[..., lane], rtol=0,
                                   atol=1e-4 * scale + 1e-6, err_msg=name)


@pytest.mark.parametrize("C,W", [(8, 130), (128, 24)])
def test_reference_matches_jax_pixmom_edge_lines(C, W):
    jax, jnp, jbw = _jax()
    AY, AX = EDGE_AY, EDGE_AX
    h0, dh = edge_projlines()
    B, V = h0.shape[:2]
    rng = np.random.RandomState(83)
    img = _bf16_exact(rng.rand(B, AY, AX, C).astype(np.float32))
    tgt = rng.rand(B, V, W, C).astype(np.float32)
    coefs = tpl.pack_projline_coefs(torch.from_numpy(h0),
                                    torch.from_numpy(dh), AY, AX, AY, W)
    jcoefs = jbw.pack_projline_coefs(jnp.asarray(h0), jnp.asarray(dh), AY,
                                     AX, AY, W)
    pix = jbw.make_projline_pixmom(AY=AY, AX=AX, C=C, V=V, W=W,
                                   interpret=True)
    want = np.asarray(pix(jnp.asarray(img), jnp.asarray(tgt), jcoefs))
    got = tpl.projline_pixmom(torch.from_numpy(img), torch.from_numpy(tgt),
                              coefs, W).numpy()
    kept = tpl._projline_cells(coefs, W, AY, AX)[4].numpy() > 0
    assert kept.mean() > 0.5
    assert not got[~kept].any()
    for name, lane in tpl.PIXMOM_IDX.items():
        scale = np.abs(want[..., lane]).max()
        assert scale > 0
        np.testing.assert_allclose(got[..., lane], want[..., lane], rtol=0,
                                   atol=1e-4 * scale + 1e-6, err_msg=name)


def test_reference_is_k4_then_moments():
    """The plain K6 equals the plain K4 followed by the five channel sums
    of ``lm_update_implicit_pixel``, on a strided (transposed) target."""
    B, AY, AX, C, V, W = 2, 16, 64, 6, 5, 10
    rng = np.random.RandomState(3)
    img = torch.from_numpy(rng.rand(B, AY, AX, C).astype(np.float32))
    sat = torch.from_numpy(rng.rand(B, W, V, C).astype(np.float32))
    tgt = sat.transpose(1, 2)                              # [B, V, W, C]
    h0, dh = _projlines(B, AY, AX, V, W, seed=4)
    coefs = tpl.pack_projline_coefs(torch.from_numpy(h0),
                                    torch.from_numpy(dh), AY, AX, AY, W)
    got = tpl.projline_pixmom(img, tgt, coefs, W)
    out, dx, dy = tpl.projline_sample_forward(img.to(torch.bfloat16), coefs,
                                              W, with_dxy=False)
    r = out - tgt
    want = torch.stack([(dx * dx).sum(-1), (dx * dy).sum(-1),
                        (dy * dy).sum(-1), (dx * r).sum(-1),
                        (dy * r).sum(-1)], -1)
    assert torch.equal(got, want)


def test_pixmom_has_no_gradient():
    B, AY, AX, C, V, W = 1, 16, 64, 4, 3, 8
    h0, dh = _projlines(B, AY, AX, V, W, seed=5)
    coefs = tpl.pack_projline_coefs(torch.from_numpy(h0),
                                    torch.from_numpy(dh), AY, AX, AY, W)
    img = torch.rand(B, AY, AX, C, requires_grad=True)
    tgt = torch.rand(B, V, W, C)
    with pytest.raises(RuntimeError, match="evaluation-only"):
        tpl.projline_pixmom(img, tgt, coefs, W)
    with torch.no_grad():
        assert tpl.projline_pixmom(img, tgt, coefs, W).shape == (B, V, W, 5)
    with pytest.raises(ValueError, match="tgt must be"):
        tpl.projline_pixmom(img.detach(), tgt[:, :, :-1], coefs, W)


@pytest.mark.parametrize("train_damping", [0, 1])
def test_lm_update_pixel_moments_matches_jax(train_damping):
    jax, jnp, _ = _jax()
    from highlyaccurate_tpu.solver import updates as ju
    B, H, W = 2, 6, 5
    rng = np.random.RandomState(10 + train_damping)
    pm = np.zeros((B, H, W, 16), np.float32)
    pm[..., :5] = rng.randn(B, H, W, 5)
    duv = rng.randn(B, H, W, 2, 3).astype(np.float32)
    pose = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    damping = rng.uniform(0.05, 0.2, (1, 3)).astype(np.float32)
    jcfg = ju.LMConfig(active_dims=(0, 1, 2), train_damping=bool(
        train_damping), damping=0.1, normalize=False, reinit=False,
        raw_damping=True)
    tcfg = tu.LMConfig(active_dims=(0, 1, 2), train_damping=bool(
        train_damping), damping=0.1, reinit=False, raw_damping=True)
    want = np.asarray(ju.lm_update_pixel_moments(
        jnp.asarray(pose), jnp.asarray(pm), jnp.asarray(duv),
        jnp.asarray(damping), jcfg))
    args = [torch.from_numpy(a) for a in (pose, pm, duv, damping)]
    got = tu.lm_update_pixel_moments(*args[:3], args[3], tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the port's 5 lanes give the same update
    five = tu.lm_update_pixel_moments(args[0], args[1][..., :5], args[2],
                                      args[3], tcfg).numpy()
    np.testing.assert_array_equal(five, got)


def test_lm_update_pixel_moments_matches_implicit_pixel():
    B, H, W, C = 2, 6, 5, 4
    rng = np.random.RandomState(12)
    out, dx, dy, tgt = (torch.from_numpy(rng.randn(B, H, W, C).astype(
        np.float32)) for _ in range(4))
    duv = torch.from_numpy(rng.randn(B, H, W, 2, 3).astype(np.float32))
    pose = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32))
    damping = torch.full((1, 3), 0.1)
    cfg = tu.LMConfig(reinit=False, raw_damping=True)
    want = tu.lm_update_implicit_pixel(pose, out, dx, dy, tgt, duv, damping,
                                       cfg)
    pm = torch.stack(tpl.pixel_moments(out, dx, dy, tgt), -1)
    got = tu.lm_update_pixel_moments(pose, pm, duv, damping, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


S, GH, GW = 128, 64, 256
TINY = dict(direction="G2SP", grd_h=GH, grd_w=GW, sat_size=S, N_iters=2,
            level=3)
B = 2
K = np.array([[582.9802 * GW / 1024, 0.0, 496.2420 * GW / 1024],
              [0.0, 482.7076 * GH / 256, 125.0034 * GH / 256],
              [0.0, 0.0, 1.0]], np.float32)


def _traj(model, *args):
    return np.stack([t.numpy() for t in model(*args, mode="trajectory")], -1)


def test_g2sp_pixmom_trajectory_matches_jax_and_k4_path():
    jax, jnp, _ = _jax()
    from highlyaccurate_tpu.config import Config as JConfig
    from highlyaccurate_tpu.models.lm_g2sp import LMG2SP as JLMG2SP
    from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    from highlyaccurate_tpu_torch.params import state_dict_from_jax

    rng = np.random.RandomState(8)
    sat = rng.rand(B, S, S, 3).astype(np.float32)
    grd = rng.rand(B, GH, GW, 3).astype(np.float32)
    k = np.broadcast_to(K, (B, 3, 3)).copy()
    net = JVGGUnet(level=3)
    params = {"SatFeatureNet": net.init(jax.random.PRNGKey(8),
                                        jnp.asarray(sat[:1]))["params"],
              "GrdFeatureNet": net.init(jax.random.PRNGKey(108),
                                        jnp.asarray(grd[:1]))["params"],
              "damping": np.full((1, 3), 0.1, np.float32)}
    jmodel = JLMG2SP(cfg=JConfig(use_banded_warp=2, g2sp_pixel_moments=1,
                                 **TINY))
    want = np.stack([np.asarray(w) for w in jmodel.apply(
        {"params": params}, jnp.asarray(sat), jnp.asarray(grd),
        jnp.asarray(k), mode="trajectory")], -1)
    args = [torch.from_numpy(a) for a in (sat, grd, k)]
    trajs = []
    for flag in (1, 0):
        port = LMG2SP(Config(g2sp_pixel_moments=flag, **TINY), device="cpu")
        port.load_state_dict(state_dict_from_jax(params))
        calls = tpl.projline_pixmom.launches, tpl.projline_sample_forward.launches
        trajs.append(_traj(port, *args))
        # the CPU runs the plain versions: no kernel launches
        assert (tpl.projline_pixmom.launches,
                tpl.projline_sample_forward.launches) == calls
    got, k4_path = trajs
    assert got.shape == want.shape == (B, TINY["N_iters"], 3, 3)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, k4_path, atol=1e-5, rtol=0)


def test_g2sp_pixmom_localizer_and_training_keep_k4():
    """The Localizer serves with the flag set; the training forward ignores
    it and runs the differentiable K4 path, as in JAX."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models import lm_g2sp

    kw = dict(TINY, N_iters=1)
    loc = Localizer(Config(g2sp_pixel_moments=1, **kw), random_init=True,
                    device="cpu", batch_size=2, camera_k=K)
    rng = np.random.RandomState(9)
    sat = rng.rand(2, S, S, 3).astype(np.float32)
    grd = rng.rand(2, GH, GW, 3).astype(np.float32)
    calls = []
    real = lm_g2sp.projline_pixmom

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    lm_g2sp.projline_pixmom = spy
    try:
        out = loc.predict(sat, grd)
        assert len(calls) == 3 and np.isfinite(out["lateral_m"]).all()
        loss = loc.model(*(torch.from_numpy(a) for a in (sat, grd)),
                         torch.from_numpy(np.broadcast_to(K, (2, 3, 3)).copy()),
                         mode="train", gt_pose=torch.zeros(2, 3)).loss
    finally:
        lm_g2sp.projline_pixmom = real
    assert len(calls) == 3 and loss.requires_grad
    loss.backward()
    assert loc.model.GrdFeatureNet.conv0.weight.grad.abs().max() > 0


@pytest.mark.cuda
def test_cuda_kernel_matches_reference():
    """K6 against its plain version on the card, on a strided target view,
    at a channel count whose 8-channel chunks do not fill the lane groups
    (C = 40), and on the hand-made lines; a second launch gives the same
    bits.  A channel count that is no multiple of 8 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    edge = edge_projline_coefs(torch, "cuda")
    for C, AX, W, lines in ((40, 64, 21, None), (256, 128, 21, None),
                            (64, EDGE_AX, 130, edge)):
        B, AY, V = 2, 32, 7
        if lines is None:
            h0, dh = _projlines(B, AY, AX, V, W, seed=C)
            coefs = tpl.pack_projline_coefs(torch.from_numpy(h0).cuda(),
                                            torch.from_numpy(dh).cuda(), AY,
                                            AX, AY, W)
        else:
            AY, coefs = EDGE_AY, lines
            V = coefs.shape[1]
        rng = np.random.RandomState(C)
        img = torch.from_numpy(rng.rand(B, AY, AX, C).astype(
            np.float32)).cuda().to(torch.bfloat16)
        sat = torch.from_numpy(rng.rand(B, W, V + 3, C).astype(
            np.float32)).cuda()
        tgt = sat[:, :, 3:].transpose(1, 2)                # strided view
        before = tpl.projline_pixmom.launches
        got = tpl.projline_pixmom(img, tgt, coefs, W)
        torch.cuda.synchronize()
        assert tpl.projline_pixmom.launches == before + 1
        want = tpl.projline_pixmom_reference(img, tgt, coefs, W)
        scale = want.abs().flatten(0, 2).amax(0)
        assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
        assert torch.equal(got, tpl.projline_pixmom(img, tgt, coefs, W))
    with pytest.raises(ValueError, match="multiple of 8"):
        tpl.projline_pixmom(img[..., :36], tgt[..., :36], coefs, W)
