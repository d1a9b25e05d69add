"""Port parity for the Ford geometry (``highlyaccurate_tpu_torch.geometry.
ford``) against ``highlyaccurate_tpu/geometry/ford.py`` on the same inputs.

* Rays, mask and the camera K are host numpy in both, computed the same
  way: equal bit for bit.
* ``ford_uv_jac`` (uv and d(uv)/d(pose)) with a scalar side length and a
  per-sample [B] one, rays [H, W, 3] and [B, H, W, 3]: rtol 1e-5 with atol
  1e-5 of the largest |value| (the small products in another order of
  summation; measured up to 8.4e-8 of the max).  The per-sample side length
  must scale each sample's uv on its own, which a [B] division broadcast
  against the uv-component axis would get wrong.
* The quaternion helpers: to 1e-12 (the same float64 numpy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.geometry import ford as jford
from highlyaccurate_tpu_torch.geometry import ford as tford

RANGES = (10.0, 20.0, 20.0)   # rotation, lat, lon
B = 3


@pytest.mark.parametrize("hw", [(8, 32), (32, 128), (256, 1024)])
def test_rays_and_mask_match(hw):
    want = jford.grd_img2cam_ford(*hw, 256, 1024)
    got = tford.grd_img2cam_ford(*hw, 256, 1024)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert 0 < got[1].mean() < 1          # both sides of the horizon
    np.testing.assert_array_equal(tford.ford_camera_k(), jford.ford_camera_k())
    np.testing.assert_array_equal(tford.ford_camera_k(64, 256),
                                  jford.ford_camera_k(64, 256))


def _inputs(seed, H=4, W=16, per_sample_rays=False):
    rng = np.random.RandomState(seed)
    pose = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    R = np.stack([jford.qvec2rotmat(q / np.linalg.norm(q))
                  for q in rng.randn(B, 4)]).astype(np.float32)
    T = rng.uniform(-2, 2, (B, 3)).astype(np.float32)
    xyz = jford.grd_img2cam_ford(H, W, 32, 128)[0][H // 2:]
    if per_sample_rays:
        xyz = xyz[None] + rng.uniform(-0.1, 0.1, (B,) + xyz.shape).astype(
            np.float32)
    return pose, R, T, xyz


@pytest.mark.parametrize("side", ["scalar", "per_sample"])
@pytest.mark.parametrize("per_sample_rays", [False, True],
                         ids=["rays_hw", "rays_bhw"])
def test_uv_jac_matches_jax(side, per_sample_rays):
    pose, R, T, xyz = _inputs(1, per_sample_rays=per_sample_rays)
    A = 64
    side_m = (np.float32(512 * 0.22) if side == "scalar" else
              np.array([100.0, 112.64, 130.0], np.float32))
    want = jford.ford_uv_jac(jnp.asarray(pose), jnp.asarray(R),
                             jnp.asarray(T), jnp.asarray(xyz),
                             jnp.asarray(side_m) if side != "scalar"
                             else float(side_m), A, *RANGES)
    t_side = torch.from_numpy(side_m) if side != "scalar" else float(side_m)
    got = tford.ford_uv_jac(torch.from_numpy(pose), torch.from_numpy(R),
                            torch.from_numpy(T), torch.from_numpy(xyz),
                            t_side, A, *RANGES)
    H, W = xyz.shape[-3:-1]
    for name, g, w in zip(("uv", "duv"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == ((B, H, W, 2) if name == "uv"
                                      else (B, H, W, 2, 3))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    uv_only, none = tford.ford_uv_jac(
        torch.from_numpy(pose), torch.from_numpy(R), torch.from_numpy(T),
        torch.from_numpy(xyz), t_side, A, *RANGES, require_jac=False)
    assert none is None and torch.equal(uv_only, got[0])


def test_per_sample_side_scales_each_sample():
    """A [B] side length equals B scalar calls, one per sample."""
    pose, R, T, xyz = _inputs(2)
    sides = np.array([90.0, 112.64, 140.0], np.float32)
    ts = [torch.from_numpy(a) for a in (pose, R, T, xyz)]
    uv, duv = tford.ford_uv_jac(*ts, torch.from_numpy(sides), 64, *RANGES)
    for i, s in enumerate(sides):
        u1, d1 = tford.ford_uv_jac(ts[0][i:i + 1], ts[1][i:i + 1],
                                   ts[2][i:i + 1], ts[3], float(s), 64,
                                   *RANGES)
        np.testing.assert_allclose(uv[i:i + 1].numpy(), u1.numpy(),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(duv[i:i + 1].numpy(), d1.numpy(),
                                   rtol=1e-6, atol=1e-5)


def test_jacobian_matches_autograd():
    """The closed-form d(uv)/d(pose) against torch.autograd."""
    pose, R, T, xyz = _inputs(3)
    args = [torch.from_numpy(a).double() for a in (R, T, xyz)]
    p = torch.from_numpy(pose).double()
    _, duv = tford.ford_uv_jac(p, *args, 112.64, 64, *RANGES)

    def uv_of(q):
        return tford.ford_uv_jac(q, *args, 112.64, 64, *RANGES,
                                 require_jac=False)[0]

    jac = torch.autograd.functional.jacobian(uv_of, p)   # [B,H,W,2,B,3]
    auto = torch.stack([jac[b, ..., b, :] for b in range(B)])
    np.testing.assert_allclose(duv.numpy(), auto.numpy(), rtol=1e-9,
                               atol=1e-9)


def test_quaternion_helpers_match():
    rng = np.random.RandomState(4)
    for q in list(rng.randn(4, 4)) + [np.array([0.496157034, -0.486630591,
                                                0.507791308, -0.509084328])]:
        q = q / np.linalg.norm(q)
        np.testing.assert_allclose(tford.qvec2rotmat(q),
                                   jford.qvec2rotmat(q), atol=1e-12)
        np.testing.assert_allclose(tford.qvec2angle(*q),
                                   jford.qvec2angle(*q), atol=1e-12)
    R = tford.qvec2rotmat([0.496157034, -0.486630591, 0.507791308,
                           -0.509084328])
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
