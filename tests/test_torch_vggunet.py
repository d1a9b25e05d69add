"""Port parity: VGGUnet (highlyaccurate_tpu_torch.models.vggunet) against
the flax VGGUnet on converted parameters, fp32.  Features and confidences
within rtol 1e-4 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu_torch.models.vggunet import (VGGUnet, l2_norm_wholemap,
                                                     max_pool_2x2)
from highlyaccurate_tpu_torch.params import _branch


def _pair(level, seed, hw):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, hw[0], hw[1], 3).astype(np.float32)
    jmod = JVGGUnet(level=level)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    tmod = VGGUnet(level)
    missing, unexpected = tmod.load_state_dict(_branch(params, ""),
                                               strict=False)
    assert not unexpected
    # a level-3 flax model still creates every decoder stage and head
    assert not missing, missing
    return jmod, params, tmod, x


@pytest.mark.parametrize("level", [3, 4])
def test_features_and_confs_match(level):
    jmod, params, tmod, x = _pair(level, seed=level, hw=(32, 64))
    want_f, want_c = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got_f, got_c = tmod(torch.from_numpy(x))
    assert len(got_f) == len(want_f) == level
    for g, w in zip(got_f + got_c, list(want_f) + list(want_c)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_single_level_slice():
    jmod, params, tmod, x = _pair(-2, seed=5, hw=(16, 32))
    want_f, _ = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got_f, _ = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got_f[0].numpy(), np.asarray(want_f[0]),
                               rtol=1e-4, atol=1e-5)


def test_l2_norm_floor_and_pool():
    from highlyaccurate_tpu.models import vggunet as jv
    x = np.random.RandomState(0).randn(2, 4, 6, 3).astype(np.float32)
    x[1] = 0.0  # an all-zero map hits the 1e-24 floor, not 0/0
    got = l2_norm_wholemap(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jv.l2_norm_wholemap(x)),
                               rtol=1e-6, atol=0)
    assert np.isfinite(got).all()
    pooled = max_pool_2x2(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(pooled.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jv.max_pool_2x2(x)))
