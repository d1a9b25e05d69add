"""Port parity: ``lm_update_from_moments`` (highlyaccurate_tpu_torch.solver)
against the JAX function on the same M / P0 / dP / damping, for the four
LMConfig variants of tests/test_implicit_lm.py.  Tolerance rtol 2e-4 /
atol 2e-5 (the JAX package's own solver-parity tolerance).

The out-of-range re-init draws different numbers in the two frameworks, so
the inputs keep every pose inside +-2.5 and the test asserts that they do;
a separate test checks the re-init itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.solver import updates as ju
from highlyaccurate_tpu_torch.solver import updates as tu

B, V, W = 3, 5, 16


def _moments(seed):
    """A moment tensor with the structure K1 emits: non-negative squared
    moments, signed cross moments, u-weighted rows, zero lanes 9-15."""
    rng = np.random.RandomState(seed)
    M = np.zeros((B, V, 3, 16), np.float32)
    u = np.arange(W, dtype=np.float32)
    per_px = rng.randn(B, V, W, 9).astype(np.float32)
    per_px[..., :5] = np.abs(per_px[..., :5]) + 0.5       # ss, gg, sxx, sxy, syy
    per_px[..., 3] = 0.3 * rng.randn(B, V, W)             # sxy is signed
    for k, w in enumerate((np.ones_like(u), u, u * u)):
        M[:, :, k, :9] = np.einsum("bvwk,w->bvk", per_px, w)
    P0 = rng.randn(B, V, 2, 3).astype(np.float32)
    dP = (rng.randn(B, V, 2, 3) * 0.1).astype(np.float32)
    pose = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    damping = rng.randn(1, 3).astype(np.float32)
    return M, P0, dP, pose, damping


CASES = [dict(), dict(active_dims=(0, 1)), dict(use_hessian=True),
         dict(train_damping=True)]


@pytest.mark.parametrize("overrides", CASES)
def test_update_from_moments_matches(overrides):
    M, P0, dP, pose, damping = _moments(17)
    want = np.asarray(ju.lm_update_from_moments(
        jnp.asarray(pose), jnp.asarray(M), jnp.asarray(P0), jnp.asarray(dP),
        jnp.asarray(damping), ju.LMConfig(normalize=True, **overrides),
        jax.random.PRNGKey(20)))
    assert np.all(np.abs(want[:, :2]) < 2.5), "parity input left the range"
    got = tu.lm_update_from_moments(
        torch.from_numpy(pose), torch.from_numpy(M), torch.from_numpy(P0),
        torch.from_numpy(dP), torch.from_numpy(damping),
        tu.LMConfig(**overrides),
        torch.Generator().manual_seed(20)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("train_damping", [False, True])
def test_compute_damping_matches(train_damping):
    d = np.random.RandomState(1).randn(1, 3).astype(np.float32)
    for dims in ((0, 1, 2), (0, 1), (2,)):
        cfg_kw = dict(train_damping=train_damping, active_dims=dims)
        want = ju.compute_damping(jnp.asarray(d), ju.LMConfig(**cfg_kw),
                                  len(dims))
        got = tu.compute_damping(torch.from_numpy(d), tu.LMConfig(**cfg_kw),
                                 len(dims))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_reinit_fires_outside_range_only():
    """Shifts outside +-2.5 are redrawn in [-1, 1); heading and in-range
    shifts are kept.  Identity-sized system so delta is known."""
    pose = torch.tensor([[3.0, 0.1, 0.2], [0.0, -2.6, 4.0]])
    hess = torch.zeros(2, 3, 3)
    g = torch.zeros(2, 3)
    gen = torch.Generator().manual_seed(0)
    new = tu._solve_and_reinit(pose, hess, g, torch.zeros(1, 3),
                               tu.LMConfig(), gen)
    assert -1.0 <= new[0, 0] < 1.0 and new[0, 1] == pytest.approx(0.1)
    assert new[1, 0] == 0.0 and -1.0 <= new[1, 1] < 1.0
    assert new[0, 2] == pytest.approx(0.2) and new[1, 2] == pytest.approx(4.0)


def test_partial_solve_keeps_out_of_range_shifts():
    """A solve over fewer than three DoF never re-inits, in both packages:
    out-of-range shifts stay where the solve put them."""
    pose = np.array([[3.0, 0.1, 0.2], [0.0, -2.6, 4.0]], np.float32)
    hess = np.zeros((2, 2, 2), np.float32)
    g = np.zeros((2, 2), np.float32)
    damping = np.zeros((1, 3), np.float32)
    want = np.asarray(ju._solve_and_reinit(
        jnp.asarray(pose), jnp.asarray(hess), jnp.asarray(g),
        jnp.asarray(damping), ju.LMConfig(active_dims=(0, 1)),
        jax.random.PRNGKey(0)))
    got = tu._solve_and_reinit(
        torch.from_numpy(pose), torch.from_numpy(hess), torch.from_numpy(g),
        torch.from_numpy(damping), tu.LMConfig(active_dims=(0, 1)),
        torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(got, pose)
    np.testing.assert_array_equal(want, pose)


# --- the gather path's updates ---------------------------------------------
# lm_update on a materialized Jacobian (S2GP / Ford settings: normalized
# features and the re-init; G2SP settings: raw features, raw damping, no
# re-init) and lm_update_implicit_pixel_norm (S2GP / Ford per-pixel) on the
# same seeded samples; the same tolerance as above (measured <= 3e-7).

H, WP, C = 4, 6, 5


def _pixel_inputs(seed):
    """Sampled values and screen derivatives, a target, a ray mask with
    holes and a per-pixel duv, as the gather sampler feeds the updates."""
    rng = np.random.RandomState(seed)
    out, dx, dy, grd = (rng.randn(B, H, WP, C).astype(np.float32)
                        for _ in range(4))
    mask = (rng.rand(1, H, WP) > 0.25).astype(np.float32)
    duv = (rng.randn(B, H, WP, 2, 3) * 0.3).astype(np.float32)
    pose = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    damping = rng.randn(1, 3).astype(np.float32)
    return out, dx, dy, grd, mask, duv, pose, damping


def _materialized(out, dx, dy, grd, mask, duv):
    """(sat, grd, jac) as the gather ``_project`` feeds ``lm_update``: the
    Jacobian dx * duv_u + dy * duv_v, every piece masked."""
    m = mask[..., None]
    jac = (dx[..., None] * duv[..., None, 0, :]
           + dy[..., None] * duv[..., None, 1, :]) * m[..., None]
    return out * m, grd * m, jac


SETTINGS = {"S2GP": dict(normalize=True),
            "G2SP": dict(normalize=False, reinit=False, raw_damping=True)}
UPDATE_CASES = ([("S2GP", c) for c in CASES]
                + [("G2SP", dict()), ("G2SP", dict(train_damping=True))])


@pytest.mark.parametrize("family,overrides", UPDATE_CASES,
                         ids=[f"{f}-{'-'.join(o) or 'default'}"
                              for f, o in UPDATE_CASES])
def test_lm_update_matches(family, overrides):
    out, dx, dy, grd, mask, duv, pose, damping = _pixel_inputs(23)
    sat, tgt, jac = _materialized(out, dx, dy, grd, mask, duv)
    kw = dict(SETTINGS[family], **overrides)
    want = np.asarray(ju.lm_update(
        jnp.asarray(pose), jnp.asarray(sat), None, jnp.asarray(tgt),
        jnp.asarray(mask[..., None].repeat(B, 0)), jnp.asarray(jac),
        jnp.asarray(damping), ju.LMConfig(**kw),
        jax.random.PRNGKey(4) if family == "S2GP" else None))
    # the step itself stays inside the re-init range (a redraw would hide)
    kept = np.asarray(ju.lm_update(
        jnp.asarray(pose), jnp.asarray(sat), None, jnp.asarray(tgt),
        jnp.asarray(mask[..., None].repeat(B, 0)), jnp.asarray(jac),
        jnp.asarray(damping),
        ju.LMConfig(**dict(kw, reinit=False))))
    assert np.all(np.abs(kept[:, :2]) < 2.5), "parity input left the range"
    assert np.abs(want - pose).max() > 1e-3, "the pose never moved"
    got = tu.lm_update(
        *(torch.from_numpy(a) for a in (pose, sat, tgt, jac, damping)),
        tu.LMConfig(**kw), torch.Generator().manual_seed(4)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("overrides", CASES)
def test_implicit_pixel_norm_matches(overrides):
    out, dx, dy, grd, mask, duv, pose, damping = _pixel_inputs(29)
    want = np.asarray(ju.lm_update_implicit_pixel_norm(
        *(jnp.asarray(a) for a in (pose, out, dx, dy, grd, mask, duv,
                                   damping)),
        ju.LMConfig(normalize=True, **overrides), jax.random.PRNGKey(5)))
    kept = np.asarray(ju.lm_update_implicit_pixel_norm(
        *(jnp.asarray(a) for a in (pose, out, dx, dy, grd, mask, duv,
                                   damping)),
        ju.LMConfig(normalize=True, reinit=False, **overrides)))
    assert np.all(np.abs(kept[:, :2]) < 2.5), "parity input left the range"
    assert np.abs(want - pose).max() > 1e-3, "the pose never moved"
    got = tu.lm_update_implicit_pixel_norm(
        *(torch.from_numpy(a) for a in (pose, out, dx, dy, grd, mask, duv,
                                        damping)),
        tu.LMConfig(**overrides), torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_implicit_pixel_norm_is_lm_update_on_the_jacobian():
    """The per-pixel implicit update equals ``lm_update`` on the Jacobian
    it never materializes (masked samples, masked target): the identity
    the JAX package's gather path rests on."""
    out, dx, dy, grd, mask, duv, pose, damping = _pixel_inputs(31)
    t = [torch.from_numpy(a) for a in (pose, out, dx, dy, grd, mask, duv,
                                       damping)]
    cfg = tu.LMConfig(use_hessian=True)
    implicit = tu.lm_update_implicit_pixel_norm(
        *t, cfg, torch.Generator().manual_seed(6))
    sat, tgt, jac = (torch.from_numpy(a) for a in _materialized(
        out, dx, dy, grd, mask, duv))
    full = tu.lm_update(t[0], sat, tgt, jac, t[-1], cfg,
                        torch.Generator().manual_seed(6))
    assert (implicit - t[0]).abs().max() > 1e-3
    np.testing.assert_allclose(implicit.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)
