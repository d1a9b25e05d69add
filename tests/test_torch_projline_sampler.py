"""Port parity: K4 and K5, the projective-line sampler of G2SP
(``highlyaccurate_tpu_torch.ops.projline``).

Lines come from the G2SP geometry itself (``g2sp_P`` on the first two
satellite rows of the kept columns, the default K, random poses) at the
flagship's three ground-map shapes, where the JAX package runs its
column-blocked kernel (AX % 128 == 0), and at AX = 64, where it runs the
full-map kernel.  Map values are bf16-exact, so the cast inside both
samplers is the identity.

* ``pack_projline_coefs`` against JAX on lines with rows the validity guard
  rejects (behind the camera, outside the map, |slope| >= 0.95, a
  degenerate line): lanes 0-5 (the only lanes the kernels read) and the
  guard bit for bit; the schedule lanes to 1e-5 relative, except slope and
  yref, whose cross products cancel (JAX's CPU code contracts them into
  FMAs): 1e-3 relative (measured up to 7e-4 over three seeds).
* The plain K4 against the interpret-mode JAX sampler: atol 1e-3 on values
  of O(1).  XLA's CPU code computes den = d0 + dd*u as one FMA, the port
  as a rounded product and sum (as its CUDA kernel does), so x and y differ
  by a few ulps: up to 1.6e-4 in dy at AX = 512 (ulp(512) = 6e-5).  A
  sample dropped by the TPU kernel's block skip (xlo/xhi) or per-block
  y-window would read O(0.5): this also shows that the blocked schedule
  drops no sample the mask keeps, at every flagship shape and at poses up
  to 1.5x the ranges.
* The plain VJP (plain K5 and the coefficient gradients, through
  ``pack_projline_coefs`` to h0 and dh) against ``jax.grad`` through the
  differentiable sampler: 1e-4 of each gradient's max (measured up to
  9e-6), since the samples' ulps above and K5's summation order move the
  sums.
* The autograd function against autograd through the plain forward
  (1e-5), the map gradient bit-equal whether the map came in as bf16 or
  fp32 (K5 never reads the map), and the tensors the forward saves.
* The same on hand-made lines (``chip_smoke.edge_projlines``: a pole
  inside the line, dd = 0, dnx = 0, dny = 0, samples converging on one
  cell, tile-border starts, lines along x = AX-2 and y = AY-2, a guard
  line, |dd| = 1e-7), each package's ``pack_projline_coefs`` on both
  sides: the plain K4 at atol 1e-3, the plain VJP at 1e-4 of each
  gradient's max.
* The CUDA kernels against the plain versions, on the card only, also on
  the hand-made lines written straight into lanes 0-5; K5 launched twice,
  bit for bit.

The JAX package is imported inside the tests that use it, so the card test
runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_projline_sampler.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (EDGE_AX, EDGE_AY, edge_projline_coefs,
                        edge_projlines)
from highlyaccurate_tpu_torch.geometry import kitti as tg
from highlyaccurate_tpu_torch.ops import projline as tpl

RANGES = (10.0, 20.0, 20.0)
# (A, AY, AX, j0, C): the flagship G2SP levels (256x1024 ground input,
# 512x512 satellite) with few channels, and one full-map shape
FLAGSHIP = [(64, 32, 128, 8, 8), (128, 64, 256, 16, 4),
            (256, 128, 512, 40, 2)]
FULLMAP = (32, 16, 64, 0, 8)


def _jax():
    import jax
    import jax.numpy as jnp

    from highlyaccurate_tpu.ops.pallas import banded_warp as jbw
    return jax, jnp, jbw


def _lines(seed, B, A, AY, AX, j0, margin=1.0):
    """h0, dh [B, A-j0, 3] of the G2SP lines at random poses within
    ``margin`` x the ranges (default K of the 256x1024 input)."""
    rng = np.random.RandomState(seed)
    pose = torch.from_numpy(rng.uniform(-margin, margin, (B, 3)).astype(
        np.float32))
    k = torch.from_numpy(np.broadcast_to(tg.DEFAULT_CAMERA_K, (B, 3, 3))
                         .astype(np.float32))
    xyz1 = torch.from_numpy(tg.warp_sat2real(A)[:, j0:])
    P = tg.g2sp_P(pose, k, AY, AX, 256, 1024, *RANGES)

    def project(X):
        return (P[:, None, :, :] * X[None, :, None, :]).sum(-1)

    return (project(xyz1[0]).numpy(),
            project(xyz1[1] - xyz1[0]).numpy())


def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _map(seed, B, AY, AX, C):
    rng = np.random.RandomState(seed)
    return _bf16_exact(rng.uniform(0.5, 1.0, (B, AY, AX, C)).astype(
        np.float32))


def test_pack_projline_coefs_matches_jax():
    jax, jnp, jbw = _jax()
    A, AY, AX, j0, _ = FLAGSHIP[0]
    h0, dh = _lines(0, 2, A, AY, AX, j0)
    # rows the guard rejects: behind the camera, entirely right of the
    # map, a steep image line (|slope| >= 0.95), a degenerate line (h1 a
    # multiple of h0, so l = 0)
    h0[:, 0], dh[:, 0] = [10.0, 5.0, -3.0], [0.1, 0.0, -0.5]
    h0[:, 1], dh[:, 1] = [4000.0, 10.0, 10.0], [5.0, 0.1, 0.1]
    h0[:, 2], dh[:, 2] = [500.0, 100.0, 10.0], [5.0, 8.0, 0.05]
    h0[:, 3], dh[:, 3] = [500.0, 100.0, 10.0], [50.0, 10.0, 1.0]
    W = A
    want = np.asarray(jbw.pack_projline_coefs(jnp.asarray(h0),
                                              jnp.asarray(dh), AY, AX, AY,
                                              W))
    got = tpl.pack_projline_coefs(torch.from_numpy(h0), torch.from_numpy(dh),
                                  AY, AX, AY, W).numpy()
    assert got.shape == want.shape == (2, A - j0, 16)
    np.testing.assert_array_equal(got[..., :6], want[..., :6])
    assert np.all(got[:, :4, 0] == 1e9) and np.all(got[:, :4, 4] == 1.0)
    assert np.any(got[:, 4:, 0] != 1e9)     # and real lines stay valid
    for lane in range(6, 16):
        rtol = 1e-3 if lane in (6, 10) else 1e-5
        np.testing.assert_allclose(got[..., lane], want[..., lane],
                                   rtol=rtol, atol=1e-5, err_msg=lane)


@pytest.mark.parametrize("shape", FLAGSHIP + [FULLMAP],
                         ids=["slot0", "slot1", "slot2", "fullmap"])
@pytest.mark.parametrize("seed,margin", [(0, 1.0), (1, 1.5)])
def test_reference_matches_jax_sampler(shape, seed, margin):
    jax, jnp, jbw = _jax()
    A, AY, AX, j0, C = shape
    B, V, W = 2, A - j0, A
    h0, dh = _lines(seed, B, A, AY, AX, j0, margin)
    coefs = tpl.pack_projline_coefs(torch.from_numpy(h0),
                                    torch.from_numpy(dh), AY, AX, AY, W)
    grd = _map(seed + 10, B, AY, AX, C)
    sampler = jbw.make_projline_sampler(AY=AY, AX=AX, C=C, V=V, W=W,
                                        interpret=True)
    want = sampler(jnp.asarray(grd), jnp.asarray(coefs.numpy()))
    got = tpl.projline_sample_forward(torch.from_numpy(grd).to(
        torch.bfloat16), coefs, W, with_dxy=False)
    kept = tpl._projline_cells(coefs, W, AY, AX)[4]
    assert kept.sum() > 0.1 * B * V * W
    for name, g, w in zip(("out", "dx", "dy"), got, want):
        assert g.shape == (B, V, W, C) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=0, err_msg=name)
        assert np.all(g.numpy()[kept.numpy() == 0] == 0)


def _cotangents(seed, B, V, W, C):
    return np.random.RandomState(seed).randn(3, B, V, W, C).astype(
        np.float32)


def _port_grads(grd, h0, dh, cts, AY, AX, W):
    """(out, dx, dy) and the gradients of sum(cts * outputs) with respect
    to (grd, h0, dh) through the port's autograd function."""
    ts = [torch.from_numpy(a).requires_grad_() for a in (grd, h0, dh)]
    coefs = tpl.pack_projline_coefs(ts[1], ts[2], AY, AX, AY, W)
    outs = tpl.projline_sample(ts[0], coefs, W=W)
    sum(o.mul(torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()
    return [o.detach().numpy() for o in outs], [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shape", [FLAGSHIP[0], FULLMAP],
                         ids=["blocked", "fullmap"])
def test_vjp_matches_jax(shape):
    jax, jnp, jbw = _jax()
    A, AY, AX, j0, C = shape
    B, V, W = 2, A - j0, A
    h0, dh = _lines(2, B, A, AY, AX, j0)
    grd = _map(3, B, AY, AX, C)
    cts = _cotangents(4, B, V, W, C)
    sampler = jbw.make_projline_sampler(AY=AY, AX=AX, C=C, V=V, W=W,
                                        interpret=True, differentiable=True)

    def loss(g, a, b):
        coefs = jbw.pack_projline_coefs(a, b, AY, AX, AY, W)
        return sum(jnp.sum(o * c) for o, c in zip(sampler(g, coefs), cts))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(grd), jnp.asarray(h0), jnp.asarray(dh))
    _, got = _port_grads(grd, h0, dh, cts, AY, AX, W)
    for name, g, w in zip(("map", "h0", "dh"), got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def _edge_coefs(jnp, jbw, W):
    """The hand-made lines, packed by the port and by the JAX package:
    (h0, dh, port coefs, JAX coefs)."""
    h0, dh = edge_projlines()
    AY, AX = EDGE_AY, EDGE_AX
    coefs = tpl.pack_projline_coefs(torch.from_numpy(h0), torch.from_numpy(dh),
                                    AY, AX, AY, W)
    jcoefs = np.asarray(jbw.pack_projline_coefs(jnp.asarray(h0),
                                                jnp.asarray(dh), AY, AX, AY,
                                                W))
    np.testing.assert_array_equal(coefs[..., :6].numpy(), jcoefs[..., :6])
    return h0, dh, coefs, jcoefs


@pytest.mark.parametrize("W", [24, 130])
def test_reference_matches_jax_sampler_edge_lines(W):
    jax, jnp, jbw = _jax()
    AY, AX, C = EDGE_AY, EDGE_AX, 8
    h0, dh, coefs, jcoefs = _edge_coefs(jnp, jbw, W)
    B, V = h0.shape[:2]
    grd = _map(20 + W, B, AY, AX, C)
    sampler = jbw.make_projline_sampler(AY=AY, AX=AX, C=C, V=V, W=W,
                                        interpret=True)
    want = sampler(jnp.asarray(grd), jnp.asarray(jcoefs))
    got = tpl.projline_sample_forward(torch.from_numpy(grd).to(
        torch.bfloat16), coefs, W, with_dxy=False)
    kept = tpl._projline_cells(coefs, W, AY, AX)[4]
    assert kept.sum() > 0.5 * B * V * W
    for name, g, w in zip(("out", "dx", "dy"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("W", [24, 130])
def test_vjp_matches_jax_edge_lines(W):
    jax, jnp, jbw = _jax()
    AY, AX, C = EDGE_AY, EDGE_AX, 8
    h0, dh, _, _ = _edge_coefs(jnp, jbw, W)
    B, V = h0.shape[:2]
    grd = _map(30 + W, B, AY, AX, C)
    cts = _cotangents(31 + W, B, V, W, C)
    sampler = jbw.make_projline_sampler(AY=AY, AX=AX, C=C, V=V, W=W,
                                        interpret=True, differentiable=True)

    def loss(g, a, b):
        coefs = jbw.pack_projline_coefs(a, b, AY, AX, AY, W)
        return sum(jnp.sum(o * c) for o, c in zip(sampler(g, coefs), cts))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(grd), jnp.asarray(h0), jnp.asarray(dh))
    _, got = _port_grads(grd, h0, dh, cts, AY, AX, W)
    for name, g, w in zip(("map", "h0", "dh"), got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_vjp_matches_autograd_through_plain_forward():
    """The hand-written VJP (K5's plain version and the coefficient
    gradients) against autograd through ``projline_sample_reference`` on
    the same bf16-exact map."""
    A, AY, AX, j0, C = FLAGSHIP[0]
    B, V, W = 2, A - j0, A
    h0, dh = _lines(5, B, A, AY, AX, j0)
    grd = _map(6, B, AY, AX, C)
    cts = _cotangents(7, B, V, W, C)
    _, got = _port_grads(grd, h0, dh, cts, AY, AX, W)
    ts = [torch.from_numpy(a).requires_grad_() for a in (grd, h0, dh)]
    coefs = tpl.pack_projline_coefs(ts[1], ts[2], AY, AX, AY, W)
    outs = tpl.projline_sample_reference(ts[0], coefs, W, with_dxy=False)
    sum(o.mul(torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()
    for name, g, t in zip(("map", "h0", "dh"), got, ts):
        scale = t.grad.abs().max().item()
        np.testing.assert_allclose(g, t.grad.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_map_gradient_same_for_bf16_and_fp32_map():
    """The bf16 cast sits inside the autograd function and K5 never reads
    the map: a bf16 map and the same values in fp32 give the same outputs,
    and the fp32 map's gradient is K5's fp32 sum, of which the bf16 map
    gets the bf16 rounding."""
    A, AY, AX, j0, C = FLAGSHIP[0]
    B, V, W = 2, A - j0, A
    h0, dh = _lines(8, B, A, AY, AX, j0)
    coefs = tpl.pack_projline_coefs(torch.from_numpy(h0),
                                    torch.from_numpy(dh), AY, AX, AY, W)
    cts = [torch.from_numpy(c) for c in _cotangents(9, B, V, W, C)]
    grd = torch.from_numpy(_map(10, B, AY, AX, C))
    results = []
    for m in (grd.clone(), grd.to(torch.bfloat16)):
        m.requires_grad_()
        outs = tpl.projline_sample(m, coefs, W=W)
        sum((o * c).sum() for o, c in zip(outs, cts)).backward()
        results.append(([o.detach() for o in outs], m.grad))
    (o32, g32), (o16, g16) = results
    for a, b in zip(o32, o16):
        assert torch.equal(a, b)
    assert g32.dtype == torch.float32 and g16.dtype == torch.bfloat16
    assert torch.equal(g32, tpl.projline_sample_backward_reference(
        coefs, *cts, AY, AX))
    assert torch.equal(g16, g32.to(torch.bfloat16))


def test_saved_tensors():
    """The forward keeps dx, dy and dxy beside the coefs only when the
    coefficients need a gradient, and never ``out``."""
    A, AY, AX, j0, C = FULLMAP
    h0, dh = _lines(11, 1, A, AY, AX, j0)
    coefs = tpl.pack_projline_coefs(torch.from_numpy(h0),
                                    torch.from_numpy(dh), AY, AX, AY, A)
    grd = torch.from_numpy(_map(12, 1, AY, AX, C)).requires_grad_()
    outs = tpl.projline_sample(grd, coefs, W=A)
    assert len(outs[0].grad_fn.saved_tensors) == 1             # coefs
    outs = tpl.projline_sample(grd, coefs.requires_grad_(), W=A)
    assert len(outs[0].grad_fn.saved_tensors) == 4             # and dx, dy, dxy


def test_projline_supported():
    assert tpl.projline_supported(32, 128, 256)
    assert tpl.projline_supported(128, 512, 64)       # 8 MiB of bf16
    assert not tpl.projline_supported(4, 16, 256)      # 4-row map
    assert tpl.projline_supported(256, 1024, 16)       # slot 3: 8 MiB
    assert not tpl.projline_supported(256, 1024, 32)   # 16 MiB


@pytest.mark.cuda
def test_cuda_kernels_match_reference():
    """K4 (with and without dxy, strided bf16 and fp32 maps) and K5
    against their plain versions on the card, on G2SP lines and on the
    hand-made lines.  K5 sums each map cell in another order than the plain
    version, |err| <= 1e-5 x max|plain| + 1e-6, and in a fixed one: a
    second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    A, AY, AX, j0, C = FLAGSHIP[1]
    B, V, W = 2, A - j0, A
    h0, dh = (torch.from_numpy(a).cuda() for a in _lines(13, B, A, AY, AX,
                                                          j0, 1.5))
    coefs = tpl.pack_projline_coefs(h0, dh, AY, AX, AY, W)
    base = torch.from_numpy(_map(14, B, AY, AX, 2 * C)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        grd = base.to(dtype)[..., :C]    # a strided view
        for with_dxy in (False, True):
            before = tpl.projline_sample_forward.launches
            got = tpl.projline_sample_forward(grd, coefs, W,
                                              with_dxy=with_dxy)
            torch.cuda.synchronize()
            assert tpl.projline_sample_forward.launches == before + 1
            want = tpl.projline_sample_reference(grd, coefs, W, with_dxy)
            assert len(got) == len(want) == (4 if with_dxy else 3)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                           rtol=1e-5, atol=1e-6)
    cts = [torch.from_numpy(c).cuda() for c in _cotangents(15, B, V, W, C)]
    before = tpl.projline_sample_backward.launches
    got = tpl.projline_sample_backward(coefs, *cts, AY, AX)
    torch.cuda.synchronize()
    assert tpl.projline_sample_backward.launches == before + 1
    want = tpl.projline_sample_backward_reference(coefs, *cts, AY, AX)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale + 1e-6
    assert torch.equal(got, tpl.projline_sample_backward(coefs, *cts, AY, AX))

    # the hand-made lines, straight into lanes 0-5, at two widths of C
    coefs = edge_projline_coefs(torch, "cuda")
    AY, AX = EDGE_AY, EDGE_AX
    B, V = coefs.shape[:2]
    for C, W in ((64, 24), (192, 130)):
        grd = torch.from_numpy(_map(16 + W, B, AY, AX, C)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            got = tpl.projline_sample_forward(grd.to(dtype), coefs, W,
                                              with_dxy=True)
            want = tpl.projline_sample_reference(grd.to(dtype), coefs, W, True)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                           rtol=1e-5, atol=1e-6)
        cts = [torch.from_numpy(c).cuda()
               for c in _cotangents(17 + W, B, V, W, C)]
        got = tpl.projline_sample_backward(coefs, *cts, AY, AX)
        want = tpl.projline_sample_backward_reference(coefs, *cts, AY, AX)
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale + 1e-6
        assert torch.equal(got, tpl.projline_sample_backward(coefs, *cts,
                                                             AY, AX))
