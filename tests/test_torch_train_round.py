"""Port parity: one training round of the S2GP solver per level, on the JAX
model's own features.  The port's ``_solver_round(train=True)`` (banded
implicit branch: ``s2gp_uv_jac``, ``banded_project`` with K2 / K3's plain
versions, ``lm_update_implicit``) against the JAX round with
``banded=True, fused_eval=False`` (the Pallas sampler in interpret mode),
fp32 map: the new pose and its VJP with respect to the satellite features,
the ground features and the incoming pose.

Tolerance: pose atol 1e-5 (as the fused-eval round); gradients atol 1e-4 of
each gradient's max.  The map gradient sums up to W samples per cell in
another order than the Pallas transpose, and the pose gradient passes
through second derivatives of the geometry and the 3x3 solve.
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

TINY = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=2, level=3,
            banded_bf16_map=0)
B = 2


def test_train_round_vjp_matches_on_same_features():
    rng = np.random.RandomState(4)
    sat = rng.rand(B, 64, 64, 3).astype(np.float32)
    grd = rng.rand(B, 32, 128, 3).astype(np.float32)
    jmodel = JLMS2GP(cfg=JConfig(use_banded_warp=2, **TINY))
    params = jmodel.init({"params": jax.random.PRNGKey(4),
                          "lm": jax.random.PRNGKey(1)}, jnp.asarray(sat),
                         jnp.asarray(grd),
                         method=JLMS2GP.extract_features)["params"]
    sf, _, gf, _ = jmodel.apply({"params": params}, jnp.asarray(sat),
                                jnp.asarray(grd),
                                method=JLMS2GP.extract_features)
    port = LMS2GP(Config(**TINY), device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    pose = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    ct = rng.randn(B, 3).astype(np.float32)

    def jround(m, pose, s, g, lvl):
        return m._solver_round(pose, lvl, lvl, s, None, g, None,
                               jax.random.PRNGKey(0), None, 0, banded=True,
                               fused_eval=False)[0]

    for lvl in range(3):
        def f(pose, s, g, lvl=lvl):
            return jmodel.apply({"params": params}, pose, s, g, lvl,
                                method=jround)

        want, vjp = jax.vjp(f, jnp.asarray(pose), sf[lvl], gf[lvl])
        want_g = vjp(jnp.asarray(ct))
        assert np.all(np.abs(np.asarray(want)[:, :2]) < 2.5)

        tp, ts, tg = (torch.from_numpy(np.array(a)).requires_grad_()
                      for a in (pose, sf[lvl], gf[lvl]))
        H = tg.shape[1]
        got = port._solver_round(tp, lvl, ts, tg[:, H // 2:].contiguous(),
                                 torch.Generator().manual_seed(0),
                                 train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0, err_msg=f"level {lvl}")
        got.backward(torch.from_numpy(ct))
        for name, t, w in zip(("pose", "sat", "grd"), (tp, ts, tg), want_g):
            w = np.asarray(w)
            np.testing.assert_allclose(
                t.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                err_msg=f"level {lvl}: d/d{name}")
