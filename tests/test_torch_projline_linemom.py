"""Port parity for K7, K4's samples contracted line by line into the sums
of the G2SP LM normal equations (``highlyaccurate_tpu_torch.ops.projline
.projline_linemom``), its update ``lm_update_line_moments``, and which
G2SP rounds take it.

* The plain K7 against the route it replaces in evaluation: K4's plain
  samples, ``g2sp_uv_jac``'s per-pixel d(uv)/d(pose) and the sums of
  ``lm_update_implicit_pixel``, for H, g and the pose after one round, at
  C in {64, 128, 256}, on real G2SP lines of a 16 x 16 satellite grid
  with every column kept (j0 = 0: half the columns lie behind the camera,
  so their lines are masked by ``pack_projline_coefs``).  The sums are
  taken in another order and the Jacobian comes from each line's affine
  points (x0 + u*dx) rather than the grid's own: 1e-5 of the largest entry
  of H and g, atol 1e-6 on the pose (measured up to 8.9e-7 of the largest
  entry and 6.0e-8).
* The same contraction on the hand-made lines of
  ``chip_smoke.edge_projlines`` (a pole inside the line with samples
  behind the camera, dd = 0, a guard line, ...) with random dP lanes,
  against a float64 loop over the samples: 1e-5 of the largest entry.
* ``lm_update_line_moments`` against the per-pixel solve on the same
  moments: 1e-5 relative.
* ``LMG2SP`` trajectories (128x128 satellite, 64x256 ground, level 3, 2
  iterations): evaluation (K4, then K7) against the K4 + PyTorch route of
  the same model on the same features (the training rounds, run without
  autograd), atol 1e-5 (measured 2.5e-7); the JAX package's G2SP evaluation
  is held to the port's in tests/test_torch_lm_g2sp.py.
* Which rounds take K7, by counting the wrappers' calls (the CPU runs the
  plain versions, which count no launches): evaluation K4 and K7 once a
  round; training neither K7 nor the non-differentiable K4 forward;
  ``g2sp_pixel_moments=1`` K6 and no K7; S2GP no K7.  ``torch.export``
  keeps the custom op.
* The CUDA kernel against the plain version, on the card only (the
  ``cuda`` marker): |err| <= 1e-5 x max|plain lane| + 1e-6 at the three
  flagship level shapes at batch 2, on K4's own samples and on random
  ones, a second launch bit for bit, and the wrapper's refusals.

    python -m pytest --noconftest -m cuda tests/test_torch_projline_linemom.py
"""

import contextlib

import numpy as np
import pytest
import torch

from chip_smoke import EDGE_AX, EDGE_AY, edge_projline_coefs, edge_projlines
from highlyaccurate_tpu_torch.geometry import kitti as geom
from highlyaccurate_tpu_torch.ops import projline as tpl
from highlyaccurate_tpu_torch.solver import updates as tu
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

S, GH, GW = 128, 64, 256
TINY = dict(direction="G2SP", grd_h=GH, grd_w=GW, sat_size=S, N_iters=2,
            level=3)
B = 2
K = np.array([[582.9802 * GW / 1024, 0.0, 496.2420 * GW / 1024],
              [0.0, 482.7076 * GH / 256, 125.0034 * GH / 256],
              [0.0, 0.0, 1.0]], np.float32)
RANGES = (10.0, 20.0, 20.0)   # rotation, lateral and longitudinal ranges
CFG = tu.LMConfig(reinit=False, raw_damping=True, normalize=False)


def _lines(A, AY, AX, pose, k):
    """(ground points of every satellite column [V, A, 4], x0, dx [V, 4],
    coefs [B, V, 16], jac [B, V, 24]) of the A x A grid's lines at pose,
    as ``LMG2SP._solver_round`` builds them (j0 = 0)."""
    pts = torch.from_numpy(np.ascontiguousarray(
        geom.warp_sat2real(A).transpose(1, 0, 2)))
    x0, dx = pts[:, 0], pts[:, 1] - pts[:, 0]
    P = geom.g2sp_P(pose, k, AY, AX, GH, GW, *RANGES)

    def project(X):
        return (P[:, None, :, :] * X[None, :, None, :]).sum(-1)

    h0, dh = project(x0), project(dx)
    dP = geom.g2sp_dP(pose, k, AY, AX, GH, GW, *RANGES)
    return (pts, x0, dx, tpl.pack_projline_coefs(h0, dh, AY, AX, AY, A),
            geom.g2sp_line_jac(h0, dh, dP, x0, dx))


def _hg(lm):
    s = lm.sum(1)
    h = torch.stack([s[:, i] for i in (0, 1, 2, 1, 3, 4, 2, 4, 5)],
                    -1).reshape(-1, 3, 3)
    return h, s[:, 6:]


@pytest.mark.parametrize("C", [64, 128, 256])
def test_reference_matches_uv_jac_and_implicit_pixel(C):
    A, AY, AX = 16, 8, 32
    rng = np.random.RandomState(C)
    pose = torch.tensor([[0.3, -0.4, 0.9], [-0.6, 0.2, -1.0]])
    k = torch.from_numpy(K).expand(B, 3, 3)
    pts, _, _, coefs, jac = _lines(A, AY, AX, pose, k)
    grd = torch.from_numpy(rng.randn(B, AY, AX, C).astype(np.float32))
    sat = torch.from_numpy(rng.randn(B, A, A, C).astype(np.float32))
    tgt = sat.transpose(1, 2)                     # every column, line order
    out, dx, dy = tpl.projline_sample_forward(grd.to(torch.bfloat16), coefs,
                                              A, with_dxy=False)
    # lines the guard masks, and samples behind the camera
    assert (coefs[..., 0] == 1e9).any() and (coefs[..., 0] != 1e9).any()
    _, duv, front = geom.g2sp_uv_jac(pose, pts, k, AY, AX, GH, GW, *RANGES)
    assert not front.all()
    assert tpl._projline_cells(coefs, A, AY, AX)[4].sum() > 20

    Du, Dv = duv[..., 0, :], duv[..., 1, :]
    sxx, sxy, syy, rx, ry = tpl.pixel_moments(out, dx, dy, tgt)
    want_h = tu._pixel_hessian(Du, Dv, sxx, sxy, syy)
    want_g = (Du * rx[..., None]).sum((1, 2)) + (Dv * ry[..., None]).sum(
        (1, 2))
    lm = tpl.projline_linemom(out, dx, dy, tgt, coefs, jac, AY, AX)
    assert lm.shape == (B, A, 9) and lm.dtype == torch.float32
    got_h, got_g = _hg(lm)
    for got, want in ((got_h, want_h), (got_g, want_g)):
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * scale)
    damping = torch.full((1, 3), 0.1)
    want = tu.lm_update_implicit_pixel(pose, out, dx, dy, tgt, duv, damping,
                                       CFG)
    got = tu.lm_update_line_moments(pose, lm, damping, CFG)
    assert (got - pose).abs().max() > 1e-4          # the round moved
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_reference_on_edge_lines_matches_a_float64_loop():
    """Hand-made lines (a pole inside a line, behind the camera before it,
    dd = 0, a guard line, ...) with random dP lanes, against the per-sample
    sums in float64."""
    AY, AX, C, W = EDGE_AY, EDGE_AX, 8, 40
    coefs = edge_projline_coefs(torch, "cpu")
    h0, dh = edge_projlines()
    Bn, V = h0.shape[:2]
    rng = np.random.RandomState(5)
    jac = np.concatenate([np.stack([h0, dh], 2)[:, :, None],
                          rng.randn(Bn, V, 3, 2, 3).astype(np.float32)],
                         2).reshape(Bn, V, 24)
    grd = torch.from_numpy(rng.rand(Bn, AY, AX, C).astype(np.float32))
    tgt = torch.from_numpy(rng.rand(Bn, V, W, C).astype(np.float32))
    out, dx, dy = tpl.projline_sample_forward(grd, coefs, W, with_dxy=False)
    keep = tpl._projline_cells(coefs, W, AY, AX)[4].numpy() > 0
    got = tpl.projline_linemom(out, dx, dy, tgt, coefs,
                               torch.from_numpy(jac), AY, AX).numpy()

    o, x, y, t = (a.numpy().astype(np.float64) for a in (out, dx, dy, tgt))
    c = jac.astype(np.float64).reshape(Bn, V, 4, 2, 3)
    want = np.zeros((Bn, V, 9))
    behind = 0
    for b in range(Bn):
        for v in range(V):
            for u in range(W):
                h = c[b, v, :, 0] + u * c[b, v, :, 1]        # [4, 3]
                if h[0, 2] <= 1e-6:
                    behind += 1
                    continue
                if not keep[b, v, u]:
                    continue
                z = h[0, 2]
                du = h[1:, 0] / z - h[0, 0] / z * h[1:, 2] / z
                dv = h[1:, 1] / z - h[0, 1] / z * h[1:, 2] / z
                r = o[b, v, u] - t[b, v, u]
                sxx, sxy, syy = (x[b, v, u] ** 2).sum(), (
                    x[b, v, u] * y[b, v, u]).sum(), (y[b, v, u] ** 2).sum()
                H = (np.outer(du, du) * sxx + (np.outer(du, dv)
                     + np.outer(dv, du)) * sxy + np.outer(dv, dv) * syy)
                g = du * (x[b, v, u] * r).sum() + dv * (y[b, v, u] * r).sum()
                want[b, v] += np.concatenate([H[np.triu_indices(3)], g])
    assert behind > 0 and keep.mean() > 0.3
    assert not got[:, coefs[0, :, 0].numpy() == 1e9].any()  # the guard line
    scale = np.abs(want).max((0, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale.max())


@pytest.mark.parametrize("train_damping", [0, 1])
def test_lm_update_line_moments_matches_pixel_solve(train_damping):
    Bn, V, W = 2, 6, 5
    rng = np.random.RandomState(20 + train_damping)
    Du, Dv = (torch.from_numpy(rng.randn(Bn, V, W, 3).astype(np.float32))
              for _ in range(2))
    m = torch.from_numpy(rng.randn(5, Bn, V, W).astype(np.float32))
    moments = (m[0].abs() + 1, m[1] * 0.1, m[2].abs() + 1, m[3], m[4])
    pose = torch.from_numpy(rng.uniform(-0.5, 0.5, (Bn, 3)).astype(
        np.float32))
    damping = torch.from_numpy(rng.uniform(0.05, 0.2, (1, 3)).astype(
        np.float32))
    cfg = CFG._replace(train_damping=bool(train_damping))
    want = tu._pixel_solve(pose, Du, Dv, moments, damping, cfg)
    got = tu.lm_update_line_moments(
        pose, tpl.line_normal_sums(Du, Dv, moments), damping, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_linemom_refusals():
    Bn, V, W, C, AY, AX = 1, 3, 8, 8, 16, 64
    rng = np.random.RandomState(6)
    h0 = np.tile(np.array([[[4.0, 3.0, 1.0]]], np.float32), (Bn, V, 1))
    dh = np.tile(np.array([[[1.0, 0.1, 0.0]]], np.float32), (Bn, V, 1))
    coefs = tpl.pack_projline_coefs(torch.from_numpy(h0),
                                    torch.from_numpy(dh), AY, AX, AY, W)
    out, dx, dy, tgt = (torch.from_numpy(rng.rand(Bn, V, W, C).astype(
        np.float32)) for _ in range(4))
    jac = torch.from_numpy(rng.rand(Bn, V, 24).astype(np.float32))
    with pytest.raises(RuntimeError, match="evaluation-only"):
        tpl.projline_linemom(out.requires_grad_(), dx, dy, tgt, coefs, jac,
                             AY, AX)
    out = out.detach()
    with pytest.raises(ValueError, match="tgt must be"):
        tpl.projline_linemom(out, dx, dy, tgt[:, :, :-1], coefs, jac, AY, AX)
    with pytest.raises(ValueError, match="jac must be"):
        tpl.projline_linemom(out, dx, dy, tgt, coefs, jac[..., :18], AY, AX)
    assert tpl.projline_linemom(out, dx, dy, tgt, coefs, jac, AY,
                                AX).shape == (Bn, V, 9)


def test_dP_matches_uv_jac():
    """``g2sp_dP`` is the derivative ``g2sp_uv_jac`` projects: duv from
    K7's per-line coefficients at every grid point equals its own."""
    A, AY, AX = 16, 8, 32
    pose = torch.tensor([[0.1, 0.5, -0.3], [0.7, -0.2, 0.4]])
    k = torch.from_numpy(K).expand(B, 3, 3)
    pts, _, _, _, jac = _lines(A, AY, AX, pose, k)
    _, duv, front = geom.g2sp_uv_jac(pose, pts, k, AY, AX, GH, GW, *RANGES)
    Du, Dv = tpl.projline_line_duv(jac, A)
    scale = float(duv.abs().max())
    for got, want in ((Du, duv[..., 0, :]), (Dv, duv[..., 1, :])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * scale)
    # the pose-free derivative of the shifts, K' applied to dT
    d = geom.g2sp_dP(pose, k, AY, AX, GH, GW, *RANGES)
    assert d.shape == (B, 3, 3, 4) and not d[:, :2, :, :3].any()


# -- routing --------------------------------------------------------------

@contextlib.contextmanager
def _counting(module, names):
    """Count the calls of ``names`` looked up in ``module`` (the CPU runs
    the plain versions, which count no launches)."""
    calls = dict.fromkeys(names, 0)
    real = {n: getattr(module, n) for n in names}

    def spy(n):
        def call(*a, **kw):
            calls[n] += 1
            return real[n](*a, **kw)
        return call

    for n in names:
        setattr(module, n, spy(n))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


ROUTES = ("projline_sample_forward", "projline_sample", "projline_linemom",
          "projline_pixmom")


def _model(**kw):
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    torch.manual_seed(0)
    return LMG2SP(Config(**dict(TINY, N_iters=1), **kw), device="cpu")


def _images(seed, n=B):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.rand(n, S, S, 3).astype(np.float32)),
            torch.from_numpy(rng.rand(n, GH, GW, 3).astype(np.float32)),
            torch.from_numpy(np.broadcast_to(K, (n, 3, 3)).copy()))


@pytest.mark.parametrize("flag,want", [
    (0, dict(projline_sample_forward=3, projline_sample=0,
             projline_linemom=3, projline_pixmom=0)),
    (1, dict(projline_sample_forward=0, projline_sample=0,
             projline_linemom=0, projline_pixmom=3))],
    ids=["k4_k7", "k6"])
def test_evaluation_routes(flag, want):
    """G2SP evaluation runs K4 and K7 once a round (3 rounds at N_iters 1),
    or with ``g2sp_pixel_moments=1`` K6 alone; the Localizer too."""
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models import lm_g2sp
    model = _model(g2sp_pixel_moments=flag)
    sat, grd, k = _images(1)
    with _counting(lm_g2sp, ROUTES) as calls:
        with torch.no_grad():
            model(sat, grd, k, mode="test")
    assert calls == want
    loc = Localizer(model.cfg, random_init=True, device="cpu", batch_size=2,
                    camera_k=K)
    with _counting(lm_g2sp, ROUTES) as calls:
        out = loc.predict(sat.numpy(), grd.numpy())
    assert calls == want and np.isfinite(out["lateral_m"]).all()


def test_training_takes_no_k7():
    """A G2SP training step contracts K4's samples in torch, through the
    differentiable sampler: no K7, no plain K4 forward; its gradients
    reach both feature networks."""
    from highlyaccurate_tpu_torch.models import lm_g2sp
    model = _model()
    sat, grd, k = _images(2)
    with _counting(lm_g2sp, ROUTES) as calls:
        loss = model(sat, grd, k, mode="train",
                     gt_pose=torch.zeros(B, 3)).loss
    assert calls == dict(projline_sample_forward=0, projline_sample=3,
                         projline_linemom=0, projline_pixmom=0)
    loss.backward()
    for net in (model.SatFeatureNet, model.GrdFeatureNet):
        assert net.conv0.weight.grad.abs().max() > 0


def test_s2gp_takes_no_k7():
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
    torch.manual_seed(0)
    model = LMS2GP(Config(grd_h=32, grd_w=128, sat_size=64, N_iters=1,
                          level=3), device="cpu")
    rng = np.random.RandomState(3)
    sat = torch.from_numpy(rng.rand(B, 64, 64, 3).astype(np.float32))
    grd = torch.from_numpy(rng.rand(B, 32, 128, 3).astype(np.float32))
    with _counting(tpl, ("projline_linemom_reference",)) as calls:
        with torch.no_grad():
            model(sat, grd, mode="test",
                  generator=torch.Generator().manual_seed(0))
    assert calls == dict(projline_linemom_reference=0)


def test_evaluation_matches_k4_torch_route():
    """Evaluation (K4, then K7's plain version) against the K4 + PyTorch
    route on the same features: the model's training rounds, run without
    autograd, sample the same bf16 maps and contract in torch."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    torch.manual_seed(4)
    model = LMG2SP(Config(**TINY), device="cpu")
    sat, grd, k = _images(4)
    with torch.no_grad():
        sf, _, gf, _ = model.extract_features(sat, grd)
        pose0 = torch.zeros(B, 3)
        got = model._run_rounds(pose0, sf, gf, k, train=False)
        want = model._run_rounds(pose0, sf, gf, k, train=True)
    assert got.shape == (B, TINY["N_iters"], 3, 3)
    assert want.abs().max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_export_keeps_the_custom_op():
    """``torch.export`` traces K7's custom op through its fake (the CPU
    wrapper runs the plain version, so the op is exported directly)."""
    Bn, V, W, C = 2, 5, 8, 16

    class Contract(torch.nn.Module):
        def forward(self, out, dx, dy, tgt, coefs, jac):
            return tpl._projline_linemom_op(out, dx, dy, tgt, coefs, jac, 16,
                                            64)

    args = tuple(torch.rand(Bn, V, W, C) for _ in range(4)) + (
        torch.rand(Bn, V, 16), torch.rand(Bn, V, 24))
    ep = torch.export.export(Contract(), args)
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert any("projline_linemom" in o for o in ops), ops
    (node,) = [n for n in ep.graph.nodes if n.op == "output"]
    assert tuple(node.args[0][0].meta["val"].shape) == (Bn, V, 9)


# -- the card -------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_kernel_matches_reference():
    """K7 against its plain version on the card at the three flagship
    G2SP level shapes (batch 2), on K4's own samples of a random map and on
    random samples, against a transposed target view; a second launch
    gives the same bits.  C not a multiple of 8 and a misaligned target
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k
    from chip_smoke import g2sp_lines
    cfg = Config(direction="G2SP")
    gen = torch.Generator(device="cuda").manual_seed(7)
    k = torch.from_numpy(_scaled_default_k(cfg)).cuda().expand(B, 3, 3)
    for slot, C in zip((0, 1, 2), (256, 128, 64)):
        pose = torch.rand(B, 3, generator=gen, device="cuda") * 2 - 1
        A, AY, AX, j0, h0, dh, coefs = g2sp_lines(torch, cfg, slot, pose, k)
        jac = torch.randn(B, coefs.shape[1], 24, generator=gen,
                          device="cuda")
        jac[..., :6] = torch.stack([h0, dh], 2).flatten(2)
        grd = torch.randn(B, AY, AX, C, generator=gen, device="cuda")
        sat = torch.randn(B, A, A, C, generator=gen, device="cuda")
        tgt = sat[:, :, j0:].transpose(1, 2)
        samples = tpl.projline_sample_forward(grd.to(torch.bfloat16), coefs,
                                              A, with_dxy=False)
        rand = tuple(torch.randn_like(s) for s in samples)
        for outs in (samples, rand):
            before = tpl.projline_linemom.launches
            got = tpl.projline_linemom(*outs, tgt, coefs, jac, AY, AX)
            torch.cuda.synchronize()
            assert tpl.projline_linemom.launches == before + 1
            want = tpl.projline_linemom_reference(*outs, tgt, coefs, jac, AY,
                                                  AX)
            scale = want.abs().flatten(0, 1).amax(0)
            assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all(), slot
            assert torch.equal(got, tpl.projline_linemom(*outs, tgt, coefs,
                                                         jac, AY, AX))
    with pytest.raises(ValueError, match="multiple of 8"):
        tpl.projline_linemom(*(s[..., :60] for s in samples), tgt[..., :60],
                             coefs, jac, AY, AX)
    buf = torch.empty(samples[0].numel() + 1, device="cuda")
    shifted = buf[1:].view_as(samples[0])          # contiguous, misaligned
    with pytest.raises(ValueError, match="16-byte-aligned"):
        tpl.projline_linemom(shifted, *samples[1:], tgt, coefs, jac, AY, AX)
    bad = torch.randn(B, A, A - j0, C + 4, device="cuda")
    with pytest.raises(ValueError, match="tgt must be"):
        tpl.projline_linemom(*samples, bad[..., 1:C + 1].transpose(1, 2),
                             coefs, jac, AY, AX)
