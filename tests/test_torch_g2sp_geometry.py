"""Port parity for the G2SP geometry (``highlyaccurate_tpu_torch.geometry.
kitti``) against the JAX package.

* ``warp_sat2real`` and ``g2sp_inview_col_start`` (host numpy): exactly
  equal, at the flagship's three satellite levels (j0 = 8 / 16 / 40 at
  A = 64 / 128 / 256) and at the test sizes.
* ``g2sp_P``: within 1e-6 of its max (measured: equal).
* ``g2sp_uv_jac`` at poses within the ranges: the in-front mask equal; uv
  within 1e-6 and every d(uv)/d(pose) component within 2e-6 of that
  component's max over the points that project into the ground map
  (measured up to 3.6e-7 for uv and 1.1e-6 for duv, at the finest level).
  The port sums the four terms of each projection as rounded products and
  sums, XLA's CPU code with FMAs; at points just in front of the camera
  the projective divide amplifies that without bound, so those are left
  out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.geometry import kitti as jg
from highlyaccurate_tpu_torch.geometry import kitti as tg

RANGES = (10.0, 20.0, 20.0)
# (A, Hg, Wg, j0): the flagship G2SP levels (512 satellite, 256x1024
# ground) and the sizes of the G2SP tests (128 satellite, 64x256 ground)
LEVELS = [(64, 32, 128, 8), (128, 64, 256, 16), (256, 128, 512, 40),
          (16, 8, 32, 0), (32, 16, 64, 0)]


@pytest.mark.parametrize("A,Hg,Wg,j0", LEVELS)
def test_warp_sat2real_and_col_start_equal(A, Hg, Wg, j0):
    np.testing.assert_array_equal(tg.warp_sat2real(A), jg.warp_sat2real(A))
    got = tg.g2sp_inview_col_start(A, Hg, Wg, *RANGES)
    assert got == jg.g2sp_inview_col_start(A, Hg, Wg, *RANGES) == j0
    # other ranges and margins take the same path
    assert (tg.g2sp_inview_col_start(A, Hg, Wg, 5.0, 10.0, 30.0, margin=1.0)
            == jg.g2sp_inview_col_start(A, Hg, Wg, 5.0, 10.0, 30.0,
                                        margin=1.0))


def _inputs(seed, B=8):
    """Poses within the ranges, the default K of the 256x1024 input."""
    rng = np.random.RandomState(seed)
    pose = rng.uniform(-1.0, 1.0, (B, 3)).astype(np.float32)
    k = np.broadcast_to(jg.DEFAULT_CAMERA_K, (B, 3, 3)).astype(np.float32)
    return pose, k


@pytest.mark.parametrize("A,Hg,Wg,j0", LEVELS[:3])
def test_g2sp_P_and_uv_jac_match(A, Hg, Wg, j0):
    pose, k = _inputs(A)
    args = (Hg, Wg, 256, 1024, *RANGES)
    want = np.asarray(jg.g2sp_P(jnp.asarray(pose), jnp.asarray(k), *args))
    got = tg.g2sp_P(torch.from_numpy(pose), torch.from_numpy(k), *args)
    assert got.shape == (8, 3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())

    xyz1 = jg.warp_sat2real(A)[:, j0:]
    uv_w, duv_w, m_w = (np.asarray(t) for t in jg.g2sp_uv_jac(
        jnp.asarray(pose), jnp.asarray(xyz1), jnp.asarray(k), *args))
    uv_g, duv_g, m_g = (t.numpy() for t in tg.g2sp_uv_jac(
        torch.from_numpy(pose), torch.from_numpy(xyz1), torch.from_numpy(k),
        *args))
    assert duv_g.shape == duv_w.shape == (8, A, A - j0, 2, 3)
    np.testing.assert_array_equal(m_g, m_w)
    assert np.all(duv_g[~m_g] == 0)
    inview = (m_w & (uv_w[..., 0] > -1) & (uv_w[..., 0] < Wg + 1)
              & (uv_w[..., 1] > -1) & (uv_w[..., 1] < Hg + 1))
    assert inview.sum() > 0.05 * inview.size
    for name, g, w in (("uv", uv_g[inview], uv_w[inview]),
                       *((f"duv[{i}, {j}]", duv_g[..., i, j][inview],
                          duv_w[..., i, j][inview])
                         for i in range(2) for j in range(3))):
        tol = 1e-6 if name == "uv" else 2e-6
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=name)
