"""Port parity for one whole G2SP training step at a tiny size: the port's
``make_train_step`` (CPU, plain K4 / K5) against ``jax.value_and_grad`` of
the JAX G2SP model (``use_banded_warp=2``: the differentiable
projective-line sampler in interpret mode) followed by the JAX package's
optax Adam, on the same weights, images, intrinsics and ground-truth poses.
``train_damping=1`` so that ``damping`` (used raw by G2SP) gets a gradient.

The projective-line path samples a bf16 ground map only, so the two
frameworks' features, which differ by ~1e-6 relative (their convolutions
sum in other orders), flip the bf16 rounding of a few map values, and
XLA's CPU code rounds the projective divide as an FMA; 6 LM rounds carry
both into the poses.  Tolerances, set about 5-10x above the readings of
this test:
* loss: rtol 1e-4 (measured 9.5e-7);
* per-level metrics: atol 1e-4 of the loss for the two in loss units,
  atol 1e-4 for the normalized pose errors (measured 4.0e-6 of the loss
  and 2.9e-6);
* every parameter gradient: relL2 <= 1e-2 (measured up to 3.1e-3, at the
  satellite branch's convolutions, whose gradient comes through the
  residual's target);
* the Adam step: every element within 2 lr, and every element whose
  gradient is at least 5% of its tensor's RMS gradient within 1e-3 lr.
  Adam's first update is about lr * sign(g) (see
  tests/_torch_train_parity.py), so an element whose gradient is within
  the frameworks' noise of zero may step the other way: here one element
  of ``SatFeatureNet.conv7.weight`` at 2.3% of its tensor's RMS gradient
  does.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_train_parity import LOSS_UNIT_METRICS, update_agreement
from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.models.lm_g2sp import LMG2SP as JLMG2SP
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu.train import state as js
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from highlyaccurate_tpu_torch.train.state import create_train_state
from highlyaccurate_tpu_torch.train.step import METRICS, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

S, GH, GW = 128, 64, 256
TINY = dict(direction="G2SP", grd_h=GH, grd_w=GW, sat_size=S, N_iters=2,
            level=3, train_damping=1)
B = 2


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _step_parity(seed=0):
    rng = np.random.RandomState(seed)
    sat = rng.rand(B, S, S, 3).astype(np.float32)
    grd = rng.rand(B, GH, GW, 3).astype(np.float32)
    gt = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    k = np.array([[582.9802 * GW / 1024, 0.0, 496.2420 * GW / 1024],
                  [0.0, 482.7076 * GH / 256, 125.0034 * GH / 256],
                  [0.0, 0.0, 1.0]], np.float32)
    k = np.broadcast_to(k, (B, 3, 3)) * rng.uniform(
        0.95, 1.05, (B, 1, 1)).astype(np.float32)
    k[:, 2] = [0.0, 0.0, 1.0]
    net = JVGGUnet(level=3)
    params = {"SatFeatureNet": net.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(sat[:1]))["params"],
              "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 1),
                                        jnp.asarray(grd[:1]))["params"],
              "damping": np.full((1, 3), 0.1, np.float32)}
    jcfg = JConfig(use_banded_warp=2, **TINY)
    jmodel = JLMG2SP(cfg=jcfg)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(sat), jnp.asarray(grd),
                           jnp.asarray(k), jnp.asarray(gt), mode="train")
        return out.loss, out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    jafter = js.create_train_state(jcfg, params).apply_gradients(jgrads)

    cfg = Config(**TINY)
    model = LMG2SP(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(cfg, model)
    state, metrics = make_train_step(model, cfg)(
        state, torch.from_numpy(sat), torch.from_numpy(grd),
        torch.from_numpy(k), torch.from_numpy(gt), None)
    assert state.step == 1

    want_g = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    want_p = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jafter.params))
    grad_rel, updates = {}, {}
    for name, p in model.named_parameters():
        w = want_g[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        grad_rel[name] = _rel_l2(g, w)
        d = np.abs((p.detach() - before[name]).numpy()
                   - (want_p[name] - before[name]).numpy())
        updates[name] = (d, w)
    return dict(loss=float(metrics["loss"]), jloss=float(jloss), lr=cfg.lr,
                metrics={k_: (metrics[k_].numpy(),
                              np.asarray(getattr(jout, k_)))
                         for k_ in METRICS},
                grad_rel_l2=grad_rel, updates=updates)


def test_g2sp_train_step_matches_jax():
    r = _step_parity()
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-4)
    for k, (g, w) in r["metrics"].items():
        atol = 1e-4 * abs(r["jloss"]) if k in LOSS_UNIT_METRICS else 1e-4
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)
    for k, rel in r["grad_rel_l2"].items():
        assert rel <= 1e-2, (k, rel)
    # the raw damping and both branches' convolutions get gradients
    assert r["grad_rel_l2"]["damping"] <= 1e-2
    assert np.abs(r["updates"]["damping"][1]).max() > 0
    for k, (strong, worst) in update_agreement(
            SimpleNamespace(updates=r["updates"]), strong_frac=5e-2).items():
        assert strong <= 1e-3 * r["lr"], (k, strong)
        assert worst <= 2 * r["lr"] * (1 + 1e-3), (k, worst)
