"""Port parity: K1, the fused-moment banded sampler
(highlyaccurate_tpu_torch.ops.banded_warp).

* ``pack_row_coefs`` against the JAX function, atol 1e-5;
* the plain PyTorch version against the JAX Pallas kernel run in interpret
  mode (``make_banded_moments(interpret=True)``), with the fp32 and the bf16
  map, at rtol 1e-4 / atol 1e-4 (the tolerance of the JAX package's own
  fused-moment test): lines that leave the map, rows the validity guard
  zeroes (|slope| >= 0.95) and samples exactly on x = A-1 (the edge quirk);
* the plain version against the same JAX kernel on crowded lines
  (``_crowded_lines``: every sample of a row on one cell, nearly flat and
  reversed lines, tile-border starts, lines along the last kept column and
  row), under a ray mask with one row masked whole, at the same tolerance;
* the CUDA kernel against the plain version, on the card only, on both
  sets of lines, and launched twice on the same inputs: equal bits.

The JAX package is imported inside the tests that use it, so the card test
runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_banded_moments.py
"""

import numpy as np
import pytest
import torch

from highlyaccurate_tpu_torch.ops import banded_warp as tbw

B, A, C, V, W = 2, 32, 8, 6, 24
RB = tbw.default_rb(A)


def _jax():
    import jax.numpy as jnp

    from highlyaccurate_tpu.ops.pallas import banded_warp as jbw
    return jnp, jbw


def _lines(seed):
    """Row endpoints (kernel x, y at u = 0, 1) covering the cases of the
    contract: ordinary in-map lines, lines leaving the map, a row with
    |slope| >= 0.95, and a row whose samples land exactly on x = A-1."""
    rng = np.random.RandomState(seed)
    ax = rng.uniform(0, A - 1, (B, V))
    ay = rng.uniform(0, A - 1, (B, V))
    bx = rng.uniform(0.5, 1.5, (B, V)) * rng.choice([-1, 1], (B, V))
    by = bx * rng.uniform(-0.6, 0.6, (B, V))
    ax[:, 1] = rng.uniform(-20, -5, B)            # enters the map late
    ay[:, 2] = A + 3.0                            # starts below the map
    by[:, 3] = bx[:, 3] * 0.97                    # guard: |slope| >= 0.95
    ax[:, 4], bx[:, 4] = A - 1.0, 0.5             # u = 0 on x = A-1, the
    ay[:, 4], by[:, 4] = 5.0, 0.25                #   rest off the map
    ax[:, 5], bx[:, 5] = A - 9.0, 0.5             # reaches x = A-1 exactly
    ay[:, 5], by[:, 5] = 3.0, 0.25                #   at u = 16
    uv0 = np.stack([ax, ay], -1).astype(np.float32)
    uv1 = np.stack([ax + bx, ay + by], -1).astype(np.float32)
    return uv0, uv1


VC = 8  # rows of the crowded lines


def _crowded_lines():
    """Row endpoints that crowd samples onto few map cells and sit where the
    CUDA kernels split their work: bx = by = 0 (all W samples on one cell),
    |bx| = 0.05 and ~1.2e-7, negative bx and by, a start on integer
    coordinates, a point on x = A-2 and a line along y = A-2 (kept by the
    edge quirk), and a row the guard zeroes (|slope| = 0.98).  The second
    image is the first shifted by 1/8 cell in x."""
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
    grd = rng.rand(B, VC, W, C).astype(np.float32)
    mask = (rng.rand(VC, W) > 0.2).astype(np.float32)
    mask[4] = 0.0
    return sat, grd, mask, *_crowded_lines()


def _inputs(seed):
    rng = np.random.RandomState(seed)
    sat = rng.rand(B, A, A, C).astype(np.float32)
    grd = rng.rand(B, V, W, C).astype(np.float32)
    mask = (rng.rand(V, W) > 0.2).astype(np.float32)
    return sat, grd, mask, *_lines(seed + 1)


def test_pack_row_coefs_matches():
    jnp, jbw = _jax()
    _, _, _, uv0, uv1 = _inputs(0)
    want = np.asarray(jbw.pack_row_coefs(jnp.asarray(uv0), jnp.asarray(uv1),
                                         A, RB, W))
    got = tbw.pack_row_coefs(torch.from_numpy(uv0), torch.from_numpy(uv1),
                             A, RB, W).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the guard fired on the steep row, and only there among rows 3-5
    assert (got[:, 3, 0] == 1e9).all()
    assert (got[:, 4:, 0] != 1e9).all()
    assert tbw.default_rb(A) == jbw.default_rb(A)
    assert tbw.MOM_IDX == jbw.MOM_IDX


@pytest.mark.parametrize("bf16_map", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_reference_matches_jax_kernel(bf16_map, seed):
    jnp, jbw = _jax()
    sat, grd, mask, uv0, uv1 = _inputs(seed)
    msampler = jbw.make_banded_moments(A=A, C=C, V=V, W=W, RB=RB,
                                       interpret=True, bf16_map=bf16_map)
    want = np.asarray(msampler(jnp.asarray(sat), jnp.asarray(grd),
                               jnp.asarray(mask), jnp.asarray(uv0),
                               jnp.asarray(uv1)))
    got = tbw.banded_moments(torch.from_numpy(sat), torch.from_numpy(grd),
                             torch.from_numpy(mask), torch.from_numpy(uv0),
                             torch.from_numpy(uv1), RB=RB,
                             bf16_map=bf16_map).numpy()
    assert got.shape == (B, V, 3, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # guarded rows and the x = A-1 row carry only the target moment gg
    gg = tbw.MOM_IDX["gg"]
    for row in (3, 4):
        assert np.all(np.delete(got[:, row], gg, axis=-1) == 0)
    assert np.all(got[:, :, :, 9:] == 0)
    # the partial row 5 keeps its samples before x reaches A-1
    assert np.all(got[:, 5, 0, tbw.MOM_IDX["ss"]] > 0)


@pytest.mark.parametrize("bf16_map", [False, True])
def test_reference_matches_jax_kernel_crowded_lines(bf16_map):
    jnp, jbw = _jax()
    sat, grd, mask, uv0, uv1 = _crowded_inputs(4)
    msampler = jbw.make_banded_moments(A=A, C=C, V=VC, W=W, RB=RB,
                                       interpret=True, bf16_map=bf16_map)
    want = np.asarray(msampler(*(jnp.asarray(a)
                                 for a in (sat, grd, mask, uv0, uv1))))
    got = tbw.banded_moments(*(torch.from_numpy(a)
                               for a in (sat, grd, mask, uv0, uv1)),
                             RB=RB, bf16_map=bf16_map).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the masked row and the guarded row: nothing, or the target moment only
    assert np.all(got[:, 4] == 0)
    assert np.all(np.delete(got[:, 7], tbw.MOM_IDX["gg"], axis=-1) == 0)
    assert np.all(got[:, 0, 0, tbw.MOM_IDX["ss"]] > 0)


def test_strided_map_view_matches_transposed_copy():
    """A transposed view of the map gives the same moments as a copy."""
    sat, grd, mask, uv0, uv1 = _inputs(3)
    base = torch.from_numpy(sat)
    args = (torch.from_numpy(grd), torch.from_numpy(mask),
            torch.from_numpy(uv0), torch.from_numpy(uv1))
    view = tbw.banded_moments(base.transpose(1, 2), *args, RB=RB,
                              bf16_map=True)
    copy = tbw.banded_moments(base.transpose(1, 2).contiguous(), *args,
                              RB=RB, bf16_map=True)
    np.testing.assert_array_equal(view.numpy(), copy.numpy())


@pytest.mark.cuda
def test_cuda_kernel_matches_reference():
    """The kernel against the plain version on the lines of ``_inputs`` and
    on the crowded lines (with one row made a true line along x = A-2,
    which the guard would zero), bf16 and fp32 maps; two launches on the
    same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for inputs in (_inputs(11), _crowded_inputs(12)):
        sat, grd, mask, uv0, uv1 = (torch.from_numpy(a).cuda()
                                    for a in inputs)
        sat_k = sat.transpose(1, 2)
        coefs = tbw.pack_row_coefs(uv0, uv1, A, RB, W)
        if coefs.shape[1] == VC:
            coefs[:, 5, :4] = torch.tensor([A - 2.0, 0.0, 1.0, 0.4])
        for bf16_map in (False, True):
            sat_m = sat_k.to(torch.bfloat16) if bf16_map else sat_k
            before = tbw.banded_moments.launches
            got = tbw.moments_from_coefs(sat_m, grd, mask, coefs,
                                         bf16_map=bf16_map)
            torch.cuda.synchronize()
            assert tbw.banded_moments.launches == before + 1
            want = tbw.moments_from_coefs_reference(sat_m, grd, mask, coefs)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-4, atol=1e-4)
            again = tbw.moments_from_coefs(sat_m, grd, mask, coefs,
                                           bf16_map=bf16_map)
            assert torch.equal(got, again)
