"""Port parity: K2 and K3, the differentiable banded line sampler
(``banded_sample`` in highlyaccurate_tpu_torch.ops.banded_warp).

* The plain K2 against the JAX sampler run in interpret mode
  (``make_banded_sampler(interpret=True)``) for out, dx and dy, with the
  fp32 and the bf16 map, on lines that leave the map, rows the validity
  guard zeroes (|slope| >= 0.95) and samples on x = A-1 (the edge quirk).
  Tolerance atol 1e-5: the Pallas kernel forms the same bilinear sums as
  banded matmuls in another order (values are O(1)).
* The plain VJP (sat, uv0, uv1) against ``jax.grad`` through the same
  sampler: rtol 1e-4 / atol 1e-4, the JAX package's own custom-VJP
  tolerance (tests/test_banded_warp.py), since K3's transpose sums each map
  cell over up to W samples in another order.
* The coefficient gradients of the autograd function against autograd
  through the plain forward (1e-5), the map gradient identical with a bf16
  and an fp32 map (K3 never reads the map), and a strided map view.
* The plain K2 and the plain VJP against the JAX sampler on crowded
  lines (``_crowded_inputs``): every sample of a row on one cell, nearly
  flat and reversed lines, tile-border starts and lines along the last
  kept column and row.  K2 at atol 1e-5, the VJP at the JAX package's
  rtol 1e-4 / atol 1e-4 (up to W samples meet on one map cell).
* The CUDA kernels against the plain versions, on the card only, on both
  sets of lines, and K3 launched twice on the same inputs: equal bits.

The JAX package is imported inside the tests that use it, so the card test
runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_banded_sampler.py
"""

import numpy as np
import pytest
import torch

from highlyaccurate_tpu_torch.ops import banded_warp as tbw

B, A, C, V, W = 2, 32, 8, 6, 24
RB = tbw.default_rb(A)


def _jax():
    import jax
    import jax.numpy as jnp

    from highlyaccurate_tpu.ops.pallas import banded_warp as jbw
    return jax, jnp, jbw


def _inputs(seed):
    """A map and row endpoints (kernel x, y at u = 0, 1) covering the cases
    of the contract: ordinary lines, a line entering the map late, one
    starting below it, a row with |slope| >= 0.95, a row whose u = 0 sample
    sits on x = A-1, and one that reaches x = A-1 exactly at u = 16."""
    rng = np.random.RandomState(seed)
    sat = rng.rand(B, A, A, C).astype(np.float32)
    ax = rng.uniform(0, A - 1, (B, V))
    ay = rng.uniform(0, A - 1, (B, V))
    bx = rng.uniform(0.5, 1.5, (B, V)) * rng.choice([-1, 1], (B, V))
    by = bx * rng.uniform(-0.6, 0.6, (B, V))
    ax[:, 1] = rng.uniform(-20, -5, B)
    ay[:, 2] = A + 3.0
    by[:, 3] = bx[:, 3] * 0.97
    ax[:, 4], bx[:, 4], ay[:, 4], by[:, 4] = A - 1.0, 0.5, 5.0, 0.25
    ax[:, 5], bx[:, 5], ay[:, 5], by[:, 5] = A - 9.0, 0.5, 3.0, 0.25
    uv0 = np.stack([ax, ay], -1).astype(np.float32)
    uv1 = np.stack([ax + bx, ay + by], -1).astype(np.float32)
    cts = rng.randn(3, B, V, W, C).astype(np.float32)  # cotangents
    return sat, uv0, uv1, cts


VC = 8  # rows of the crowded lines


def _crowded_lines():
    """Row endpoints (kernel x, y at u = 0, 1) that crowd samples onto few
    map cells and sit where the CUDA kernels split their work: bx = by = 0
    (all W samples on one cell), |bx| = 0.05 and ~1.2e-7, negative bx and
    by, a start on integer coordinates (an 8-cell tile border), a point on
    x = A-2 and a line along y = A-2 (the edge quirk keeps both), and a row
    the guard zeroes (|slope| = 0.98).  The second image is the first
    shifted by 1/8 cell in x."""
    rows = np.array([(A / 2 + 0.3, 0.0, A / 3 + 0.6, 0.0),
                     (1.5, 0.05, 9.25, 0.02),
                     (0.5, 1.2e-7, 17.5, 0.0),
                     (A - 2.5, -0.7, A - 3.2, -0.3),
                     (8.0, 0.5, 16.0, 0.25),
                     (A - 2.0, 0.0, 5.5, 0.0),
                     (0.5, 0.45, A - 2.0, 0.0),
                     (3.0, 0.5, 2.0, 0.49)])
    rows = np.stack([rows, rows + [0.125, 0.0, 0.0, 0.0]])   # [B, VC, 4]
    uv0 = rows[..., [0, 2]].astype(np.float32)
    uv1 = (rows[..., [0, 2]] + rows[..., [1, 3]]).astype(np.float32)
    return uv0, uv1


def _crowded_inputs(seed):
    rng = np.random.RandomState(seed)
    sat = rng.rand(B, A, A, C).astype(np.float32)
    cts = rng.randn(3, B, VC, W, C).astype(np.float32)
    return (sat, *_crowded_lines(), cts)


def _port_grads(sat, uv0, uv1, cts, bf16_map):
    """(out, dx, dy) and the gradients of sum(cts * outputs) with respect to
    (sat, uv0, uv1), through the port's autograd function."""
    ts = [torch.from_numpy(a).requires_grad_() for a in (sat, uv0, uv1)]
    outs = tbw.banded_sample(*ts, W=W, RB=RB, bf16_map=bf16_map)
    sum(o.mul(torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()
    return ([o.detach().numpy() for o in outs],
            [t.grad.numpy() for t in ts])


@pytest.mark.parametrize("bf16_map", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_reference_matches_jax_sampler(bf16_map, seed):
    jax, jnp, jbw = _jax()
    sat, uv0, uv1, cts = _inputs(seed)
    sampler = jbw.make_banded_sampler(A=A, C=C, V=V, W=W, RB=RB,
                                      interpret=True, bf16_map=bf16_map)
    want = sampler(jnp.asarray(sat), jnp.asarray(uv0), jnp.asarray(uv1))
    got = tbw.banded_sample(torch.from_numpy(sat), torch.from_numpy(uv0),
                            torch.from_numpy(uv1), W=W, RB=RB,
                            bf16_map=bf16_map)
    for name, g, w in zip(("out", "dx", "dy"), got, want):
        assert g.shape == (B, V, W, C) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)
    # the guarded row and the row starting on x = A-1 are all zero; the
    # row reaching x = A-1 at u = 16 keeps the samples before it
    for g in got:
        assert np.all(g[:, 3:5].numpy() == 0)
        assert np.all(g[:, 5, 16:].numpy() == 0)
    assert np.all(got[0][:, 5, :16].numpy() != 0)


@pytest.mark.parametrize("bf16_map", [False, True])
def test_vjp_matches_jax_grad(bf16_map):
    jax, jnp, jbw = _jax()
    sat, uv0, uv1, cts = _inputs(3)
    sampler = jbw.make_banded_sampler(A=A, C=C, V=V, W=W, RB=RB,
                                      interpret=True, bf16_map=bf16_map)

    def loss(s, a, b):
        return sum(jnp.sum(o * c) for o, c in zip(sampler(s, a, b), cts))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(sat), jnp.asarray(uv0), jnp.asarray(uv1))
    _, got = _port_grads(sat, uv0, uv1, cts, bf16_map)
    for name, g, w in zip(("sat", "uv0", "uv1"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # the guarded row gets a zero uv gradient, as through jnp.where
    assert np.all(got[1][:, 3] == 0) and np.all(got[2][:, 3] == 0)


@pytest.mark.parametrize("bf16_map", [False, True])
def test_reference_matches_jax_sampler_crowded_lines(bf16_map):
    jax, jnp, jbw = _jax()
    sat, uv0, uv1, _ = _crowded_inputs(1)
    sampler = jbw.make_banded_sampler(A=A, C=C, V=VC, W=W, RB=RB,
                                      interpret=True, bf16_map=bf16_map)
    want = sampler(jnp.asarray(sat), jnp.asarray(uv0), jnp.asarray(uv1))
    got = tbw.banded_sample(torch.from_numpy(sat), torch.from_numpy(uv0),
                            torch.from_numpy(uv1), W=W, RB=RB,
                            bf16_map=bf16_map)
    for name, g, w in zip(("out", "dx", "dy"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)
    # the one-cell row keeps all W samples, the guarded row none
    assert np.all(got[0][:, 0].numpy() != 0)
    assert all(np.all(g[:, 7].numpy() == 0) for g in got)


@pytest.mark.parametrize("bf16_map", [False, True])
def test_vjp_matches_jax_grad_crowded_lines(bf16_map):
    jax, jnp, jbw = _jax()
    sat, uv0, uv1, cts = _crowded_inputs(2)
    sampler = jbw.make_banded_sampler(A=A, C=C, V=VC, W=W, RB=RB,
                                      interpret=True, bf16_map=bf16_map)

    def loss(s, a, b):
        return sum(jnp.sum(o * c) for o, c in zip(sampler(s, a, b), cts))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(sat), jnp.asarray(uv0), jnp.asarray(uv1))
    _, got = _port_grads(sat, uv0, uv1, cts, bf16_map)
    for name, g, w in zip(("sat", "uv0", "uv1"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_vjp_matches_autograd_through_plain_forward():
    """The hand-written VJP (K3's plain version and the coefficient
    gradients) against autograd through ``banded_sample_reference``."""
    sat, uv0, uv1, cts = _inputs(5)
    _, got = _port_grads(sat, uv0, uv1, cts, bf16_map=False)
    ts = [torch.from_numpy(a).requires_grad_() for a in (sat, uv0, uv1)]
    coefs = tbw.pack_row_coefs(ts[1], ts[2], A, RB, W)
    outs = tbw.banded_sample_reference(ts[0], coefs, W, with_dxy=False)
    sum(o.mul(torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()
    for name, g, t in zip(("sat", "uv0", "uv1"), got, ts):
        np.testing.assert_allclose(g, t.grad.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_map_gradient_same_for_bf16_and_fp32_map():
    """The bf16 cast sits inside the autograd function and K3 never reads
    the map, so the map gradient is the fp32-map one, bit for bit."""
    sat, uv0, uv1, cts = _inputs(9)
    _, g16 = _port_grads(sat, uv0, uv1, cts, bf16_map=True)
    _, g32 = _port_grads(sat, uv0, uv1, cts, bf16_map=False)
    np.testing.assert_array_equal(g16[0], g32[0])


def test_strided_map_view_and_saved_outputs():
    """A transposed channels-last view of the map (as the model passes it)
    gives the outputs and the map gradient of a contiguous copy, with that
    view's layout; the forward keeps dxy only when the uv need a
    gradient."""
    sat, uv0, uv1, cts = _inputs(2)
    base = torch.from_numpy(sat).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    view = base.permute(0, 2, 3, 1).transpose(1, 2)       # kernel axes
    assert not view.is_contiguous()
    uv = [torch.from_numpy(a) for a in (uv0, uv1)]
    outs = tbw.banded_sample(view, *uv, W=W, RB=RB, bf16_map=True)
    assert len(outs[0].grad_fn.saved_tensors) == 3        # coefs, dx, dy
    sum(o.mul(torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()
    copy = view.detach().contiguous().requires_grad_()
    ref = tbw.banded_sample(copy, *uv, W=W, RB=RB, bf16_map=True)
    sum(o.mul(torch.from_numpy(c)).sum() for o, c in zip(ref, cts)).backward()
    for o, r in zip(outs, ref):
        np.testing.assert_array_equal(o.detach().numpy(), r.detach().numpy())
    assert base.grad.shape == base.shape
    np.testing.assert_array_equal(base.grad.permute(0, 3, 2, 1).numpy(),
                                  copy.grad.numpy())
    uv[0].requires_grad_()
    outs = tbw.banded_sample(view, *uv, W=W, RB=RB, bf16_map=True)
    assert len(outs[0].grad_fn.saved_tensors) == 4        # and dxy


@pytest.mark.cuda
def test_cuda_kernels_match_reference():
    """K2 (all four outputs) and K3 against their plain versions on the
    card, strided bf16 and fp32 maps, on the lines of ``_inputs`` and on the
    crowded lines (with one row made a true line along x = A-2, which the
    guard would zero).  K3 sums each map cell in another order than the
    plain index_add_: atol 1e-5 on O(1) sums of at most ~W terms; two K3
    launches on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sat, uv0, uv1, cts = (torch.from_numpy(a).cuda() for a in _inputs(11))
    crowded = [torch.from_numpy(a).cuda() for a in _crowded_inputs(12)]
    cases = [(tbw.pack_row_coefs(uv0, uv1, A, RB, W), cts)]
    coefs = tbw.pack_row_coefs(*crowded[1:3], A, RB, W)
    coefs[:, 5, :4] = torch.tensor([A - 2.0, 0.0, 1.0, 0.4])
    cases.append((coefs, crowded[3]))
    for coefs, cts in cases:
        for dtype in (torch.float32, torch.bfloat16):
            sat_k = sat.to(dtype).transpose(1, 2)
            before = tbw.banded_sample.launches
            got = tbw.banded_sample_forward(sat_k, coefs, W, with_dxy=True)
            torch.cuda.synchronize()
            assert tbw.banded_sample.launches == before + 1
            want = tbw.banded_sample_reference(sat_k, coefs, W, with_dxy=True)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                           rtol=1e-5, atol=1e-6)
        before = tbw.banded_sample_backward.launches
        got = tbw.banded_sample_backward(coefs, *cts, A)
        torch.cuda.synchronize()
        assert tbw.banded_sample_backward.launches == before + 1
        want = tbw.banded_sample_backward_reference(coefs, *cts, A)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=1e-5)
        again = tbw.banded_sample_backward(coefs, *cts, A)
        assert torch.equal(got, again)
