"""Port parity: KITTI S2GP geometry (highlyaccurate_tpu_torch.geometry.kitti)
against the JAX package on the same numpy inputs.

Tolerance: 1e-4 px, plus two float32 ulps relative (UV_TOL).  Rows near the
horizon project far outside a 512 px map (|uv| ~ 1800 px), where one ulp is
already 1.2e-4 px and the two frameworks' 3-term dot products may round
differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.geometry import kitti as jgeom
from highlyaccurate_tpu.models.lm_s2gp import _scaled_default_k as j_k
from highlyaccurate_tpu.models.lm_s2gp import precompute_rays as j_rays
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.geometry import kitti as tgeom
from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k as t_k
from highlyaccurate_tpu_torch.models.lm_s2gp import precompute_rays as t_rays

UV_TOL = dict(atol=1e-4, rtol=2.5e-7)
RANGES = dict(rotation_range=10.0, shift_range_lat=20.0, shift_range_lon=20.0)


@pytest.mark.parametrize("hw", [(4, 16), (32, 128), (128, 512)])
def test_grd_img2cam_matches(hw):
    h, w = hw
    want = jgeom.grd_img2cam(h, w, 256, 1024)
    got = tgeom.grd_img2cam(h, w, 256, 1024)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_rays_and_scaled_k_match():
    cfg_kw = dict(grd_h=32, grd_w=128, sat_size=64)
    from highlyaccurate_tpu.config import Config as JConfig
    np.testing.assert_array_equal(t_k(Config(**cfg_kw)), j_k(JConfig(**cfg_kw)))
    for got, want in zip(t_rays(Config(**cfg_kw)), j_rays(JConfig(**cfg_kw))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _pose_and_points(seed, batched):
    rng = np.random.RandomState(seed)
    pose = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    xyz, _, _ = tgeom.grd_img2cam(16, 64, 256, 1024)
    xyz = xyz[8:]  # ground half, as the solver uses
    if batched:
        xyz = np.stack([xyz * s for s in (1.0, 0.9, 1.1)]).astype(np.float32)
    return pose, xyz


@pytest.mark.parametrize("A", [64, 512])
@pytest.mark.parametrize("batched", [False, True])
def test_s2gp_uv_and_jac_match(A, batched):
    pose, xyz = _pose_and_points(1, batched)
    want_uv, want_j = jgeom.s2gp_uv_jac(jnp.asarray(pose), jnp.asarray(xyz), A,
                                        **RANGES)
    got_uv, got_j = tgeom.s2gp_uv_jac(torch.from_numpy(pose),
                                      torch.from_numpy(xyz), A, **RANGES)
    np.testing.assert_allclose(got_uv.numpy(), np.asarray(want_uv), **UV_TOL)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), **UV_TOL)
    plain = tgeom.s2gp_uv(torch.from_numpy(pose), torch.from_numpy(xyz), A,
                          **RANGES)
    want_plain = jgeom.s2gp_uv(jnp.asarray(pose), jnp.asarray(xyz), A, **RANGES)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want_plain), **UV_TOL)


def test_s2gp_jacobian_matches_autograd():
    """The closed-form Jacobian equals torch autograd of s2gp_uv."""
    pose, xyz = _pose_and_points(2, False)
    xyz_t = torch.from_numpy(xyz[:2, :3]).double()
    pose_t = torch.from_numpy(pose).double()
    _, jac = tgeom.s2gp_uv_jac(pose_t, xyz_t, 64, **RANGES)
    for b in range(pose.shape[0]):
        def f(p, b=b):
            return tgeom.s2gp_uv(p[None], xyz_t, 64, **RANGES)[0]
        auto = torch.autograd.functional.jacobian(f, pose_t[b])  # [H,W,2,3]
        np.testing.assert_allclose(jac[b].numpy(), auto.numpy(), atol=1e-9)
