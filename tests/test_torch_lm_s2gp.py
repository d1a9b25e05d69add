"""Port parity for the whole S2GP model: the port's LMS2GP against the JAX
package (``use_banded_warp=2``: the Pallas kernel in interpret mode) on the
same weights and images.  The serving API and the package rules are in
tests/test_torch_inference.py.

Tolerances, and why:
* fp32 map (``banded_bf16_map=0``): round 1 atol 1e-5 on the pose; all
  rounds atol 1e-4, because a last-bit difference in uv flips the floor
  cell of a few samples and the LM rounds amplify it.
* default bf16 map: one round on identical features agrees to 1e-5.  Whole
  trajectories start from each framework's own convolutions, which differ
  by ~2e-6 relative; that flips the bf16 rounding of some map values (a
  2^-9 relative step each), so they are held to atol 1e-2 on the pose
  (measured up to 4.4e-3 over 6 rounds).
* The re-init draws differ between frameworks, so every parity input keeps
  the poses inside +-2.5 and the tests assert that they do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.models.lm_s2gp import LMS2GP as JLMS2GP
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=2, level=3)
B = 2


def _images(seed, n=B):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 64, 64, 3).astype(np.float32),
            rng.rand(n, 32, 128, 3).astype(np.float32))


def _jax_model(seed, **kw):
    sat, grd = _images(seed)
    model = JLMS2GP(cfg=JConfig(use_banded_warp=2, **TINY, **kw))
    params = model.init({"params": jax.random.PRNGKey(seed),
                         "lm": jax.random.PRNGKey(1)}, jnp.asarray(sat),
                        jnp.asarray(grd),
                        method=JLMS2GP.extract_features)["params"]
    return model, params


def _port_model(params, **kw):
    model = LMS2GP(Config(**TINY, **kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _trajectories(seed, **kw):
    jmodel, params = _jax_model(seed, **kw)
    sat, grd = _images(seed)
    want = jmodel.apply({"params": params}, jnp.asarray(sat),
                        jnp.asarray(grd), mode="trajectory",
                        rngs={"lm": jax.random.PRNGKey(3)})
    got = _port_model(params, **kw)(
        torch.from_numpy(sat), torch.from_numpy(grd), mode="trajectory",
        generator=torch.Generator().manual_seed(3))
    want = np.stack([np.asarray(w) for w in want], -1)  # [B, I, L, 3]
    got = np.stack([g.numpy() for g in got], -1)
    assert got.shape == want.shape == (B, TINY["N_iters"], 3, 3)
    # (lat, lon) = (pose v, pose u): keep both inside the re-init range
    assert np.all(np.abs(want[..., :2]) < 2.5), "parity input left the range"
    return got, want


def test_trajectory_matches_fp32_map():
    got, want = _trajectories(0, banded_bf16_map=0)
    np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_trajectory_matches_bf16_map():
    got, want = _trajectories(1)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


def test_round_on_same_features_matches_bf16_map():
    """One fused-eval round per level on the JAX model's own features: the
    bf16 map, K1's plain version, the axis swap and the solve agree with
    the JAX round to 1e-5."""
    jmodel, params = _jax_model(4)
    sat, grd = _images(4)
    sf, _, gf, _ = jmodel.apply({"params": params}, jnp.asarray(sat),
                                jnp.asarray(grd),
                                method=JLMS2GP.extract_features)
    port = _port_model(params)
    pose = np.random.RandomState(5).uniform(-0.3, 0.3, (B, 3)).astype(
        np.float32)

    def jround(m, pose, s, g, lvl):
        return m._solver_round(pose, lvl, lvl, s, None, g, None,
                               jax.random.PRNGKey(0), None, 0, banded=True,
                               fused_eval=True)[0]

    for lvl in range(3):
        want = np.asarray(jmodel.apply(
            {"params": params}, jnp.asarray(pose), sf[lvl], gf[lvl], lvl,
            method=jround))
        g = torch.from_numpy(np.array(gf[lvl]))
        got = port._solver_round(
            torch.from_numpy(pose), lvl,
            torch.from_numpy(np.array(sf[lvl])).to(torch.bfloat16),
            g[:, g.shape[1] // 2:].contiguous(),
            torch.Generator().manual_seed(0)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
