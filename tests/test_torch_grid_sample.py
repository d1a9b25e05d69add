"""Port parity for the gather sampler: ``highlyaccurate_tpu_torch.ops.
grid_sample`` (``grid_sample`` with and without the pose Jacobian,
``grid_sample_derivs``) against ``highlyaccurate_tpu.ops.grid_sample`` on
the same seeded inputs, and their gradients against ``jax.vjp``.

The points cover the interior, the exact right and bottom edges (weight 0
there, a JAX contract kept from the reference), integer coordinates,
points outside the image and the ~1e9 coordinates of G2SP's projective
uv behind the camera (the float is clipped before the integer cast, so no
index leaves the image).  Tolerances: values and derivatives within 1e-6
absolute (float32, values of order 1; measured 0 to 1e-7), gradients
within 1e-5 of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.ops import grid_sample as jgs
from highlyaccurate_tpu_torch.ops import grid_sample as tgs

IH, IW, C = 7, 9, 5
ATOL = 1e-6
GRAD_TOL = 1e-5


def _points(rng, kind, shape=(2, 4, 6)):
    """uv [*shape, 2] of one kind of point."""
    u = rng.uniform(0.2, IW - 1.2, shape)
    v = rng.uniform(0.2, IH - 1.2, shape)
    if kind == "edges":
        # exact right / bottom / left / top edges, and corners
        u[..., 0], v[..., 1] = IW - 1, IH - 1
        u[..., 2], v[..., 2] = IW - 1, IH - 1
        u[..., 3], v[..., 4] = 0.0, 0.0
        u[..., 5], v[..., 5] = 0.0, IH - 1
    elif kind == "integer":
        u = rng.randint(0, IW, shape).astype(np.float64)
        v = rng.randint(0, IH, shape).astype(np.float64)
    elif kind == "outside":
        u = rng.uniform(-3, IW + 2, shape)
        v = rng.uniform(-3, IH + 2, shape)
    elif kind == "huge":
        u[..., :3] = rng.choice([-1e9, 1e9, 3.7e8], (shape[0], shape[1], 3))
        v[..., 3:] = rng.choice([-1e9, 1e9, -2.5e8], (shape[0], shape[1], 3))
    return np.stack([u, v], -1).astype(np.float32)


KINDS = ["interior", "edges", "integer", "outside", "huge"]


def _inputs(kind, seed=0):
    rng = np.random.RandomState(seed)
    image = rng.randn(2, IH, IW, C).astype(np.float32)
    uv = _points(rng, kind)
    duv = rng.randn(*uv.shape, 3).astype(np.float32)
    return image, uv, duv


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(kind):
    image, uv, duv = _inputs(kind)
    ji, ju, jd = (jnp.asarray(a) for a in (image, uv, duv))
    ti, tu, td = (torch.from_numpy(a) for a in (image, uv, duv))
    want_out, want_jac = jgs.grid_sample(ji, ju, jd)
    got_out, got_jac = tgs.grid_sample(ti, tu, td)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_jac.numpy(), np.asarray(want_jac),
                               atol=ATOL, rtol=0)
    out_only, none = tgs.grid_sample(ti, tu)
    assert none is None
    assert torch.equal(out_only, got_out)
    for g, w in zip(tgs.grid_sample_derivs(ti, tu),
                    jgs.grid_sample_derivs(ji, ju)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
    if kind == "edges":
        # a sample exactly on the right or bottom edge has weight 0
        assert np.all(got_out.numpy()[:, :, :3] == 0)
    if kind in ("outside", "huge"):
        assert np.isfinite(got_out.numpy()).all()


def test_bf16_image_promotes_like_jax():
    """A bf16 image meets float32 weights: float32 results, as JAX's
    promotion gives them (the gather path under bf16 features)."""
    image, uv, _ = _inputs("interior", seed=1)
    ti = torch.from_numpy(image).to(torch.bfloat16)
    ji = jnp.asarray(image).astype(jnp.bfloat16)
    got = tgs.grid_sample_derivs(ti, torch.from_numpy(uv))
    want = jgs.grid_sample_derivs(ji, jnp.asarray(uv))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=ATOL, rtol=0)


def _max_err(got, want):
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kind", ["interior", "edges", "outside"])
def test_vjp_matches_jax(kind):
    """Gradients of (out, du, dv) and of the chained Jacobian under random
    cotangents, with respect to the image and to uv (and duv)."""
    image, uv, duv = _inputs(kind, seed=2)
    rng = np.random.RandomState(3)
    cts = [rng.randn(2, 4, 6, C).astype(np.float32) for _ in range(3)]
    ct_jac = rng.randn(2, 4, 6, C, 3).astype(np.float32)

    def jfn(i, u, d):
        o, du, dv = jgs.grid_sample_derivs(i, u)
        _, jac = jgs.grid_sample(i, u, d)
        return o, du, dv, jac

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (image, uv, duv)))
    want = vjp((*(jnp.asarray(c) for c in cts), jnp.asarray(ct_jac)))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (image, uv, duv)]
    o, du, dv = tgs.grid_sample_derivs(leaves[0], leaves[1])
    _, jac = tgs.grid_sample(*leaves)
    loss = sum((t * torch.from_numpy(c)).sum()
               for t, c in zip((o, du, dv, jac), cts + [ct_jac]))
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(("image", "uv", "duv"), got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        assert _max_err(g.numpy(), w) <= GRAD_TOL, (name, _max_err(
            g.numpy(), w))
