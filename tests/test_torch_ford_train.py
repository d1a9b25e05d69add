"""Port parity for one whole Ford training step at a tiny size, fp32 map:
the port's ``make_train_step(model, cfg, ford_side_m=...)`` (CPU, plain K2
/ K3) against ``jax.value_and_grad`` of the JAX Ford model
(``use_banded_warp=2``: the Pallas sampler in interpret mode) followed by
the JAX package's optax Adam, on the same weights, images, per-sample
extrinsics and ground-truth poses, as tests/test_torch_train_step.py does
for KITTI S2GP.  ``train_damping=1`` so that ``damping`` gets a gradient.
The Ford data's own rig, whose rows the JAX package's banded layout cannot
sample, is held to the JAX gather path (``use_banded_warp=0``) at a
128x128 patch and a 64x256 ground input, where its rows reach the patch.

This Ford step's parameter gradients are sensitive to the last bits of the
features: in JAX alone, the satellite images times (1 + 1e-6 noise) move
them by 7.0e-3 relL2 (the same perturbation moves KITTI S2GP's by 2.2e-2
at its test's inputs).  The solver alone, on identical features, agrees
with JAX to 2.2e-4 relL2 in every feature gradient.  Tolerances, each
above the reading of this test:
* loss: rtol 1e-5 (measured 4.6e-7; real rig 4.2e-6, the two samplers
  differ at the map's edge and in the rows the validity guard drops);
* per-level metrics: atol 1e-4 of the loss for the two in loss units
  (measured 3.3e-6 of the loss; real rig 1.1e-5), atol 5e-5 for the
  normalized pose errors (measured 5.1e-6; real rig 1.6e-5);
* every parameter gradient: relL2 <= 3e-2 (measured up to 7.0e-3, at the
  satellite branch's deep convolutions, the perturbation above reads the
  same; real rig 8.7e-3);
* the Adam step: Adam's first update is about lr * sign(g) (see
  tests/_torch_train_parity.py), so every element agrees within 2 lr, and
  every element whose gradient is at least half its tensor's RMS gradient
  within 1e-3 lr (measured 2.3e-6 lr; below that, up to 10% of a tensor's
  elements step the other way).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_train_parity import LOSS_UNIT_METRICS, update_agreement
from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.geometry import ford as jford
from highlyaccurate_tpu.models.ford import LMS2GPFord as JLMS2GPFord
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu.train import state as js
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.ford import LMS2GPFord, kernel_layout
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from highlyaccurate_tpu_torch.train.state import create_train_state
from highlyaccurate_tpu_torch.train.step import METRICS, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=2, level=3,
            train_damping=1)
B = 2
# the Ford data's front-left rig (quaternion w, x, y, z; translation)
REAL_QVEC = np.array([0.496157034, -0.486630591, 0.507791308, -0.509084328])
REAL_T_FL = np.array([1.470563, 0.405664, 1.243369], np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _step_parity(seed=0, real_rig=False, **kw):
    """One step of each side.  ``real_rig``: the Ford data's own rig (each
    sample's quaternion and translation jittered) on a 128x128 patch and a
    64x256 ground input, against the JAX gather path
    (``use_banded_warp=0``), since the JAX package's banded layout samples
    nothing under this rig (see tests/test_torch_ford.py)."""
    tiny = (dict(TINY, grd_h=64, grd_w=256, sat_size=128) if real_rig
            else TINY)
    A, H, W = tiny["sat_size"], tiny["grd_h"], tiny["grd_w"]
    side_m = A * 0.22
    rng = np.random.RandomState(seed)
    sat = rng.rand(B, A, A, 3).astype(np.float32)
    grd = rng.rand(B, H, W, 3).astype(np.float32)
    gt = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    qvec, T_FL = ((REAL_QVEC, REAL_T_FL) if real_rig else
                  ([0.997, 0.01, 0.05, 0.02],
                   np.array([1.0, 0.5, -1.4], np.float32)))
    R = np.stack([jford.qvec2rotmat(q / np.linalg.norm(q)) for q in
                  qvec + rng.uniform(-0.02, 0.02, (B, 4))]).astype(
                      np.float32)
    T = T_FL + rng.uniform(-0.2, 0.2, (B, 3)).astype(np.float32)
    # the real rig takes the unswapped kernel layout, the other JAX's
    assert kernel_layout(R) != real_rig
    net = JVGGUnet(level=3)
    params = {"SatFeatureNet": net.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(sat[:1]))["params"],
              "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 1),
                                        jnp.asarray(grd[:1]))["params"],
              "damping": np.zeros((1, 3), np.float32)}
    jcfg = JConfig(use_banded_warp=0 if real_rig else 2, **tiny, **kw)
    jmodel = JLMS2GPFord(cfg=jcfg)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(sat), jnp.asarray(grd),
                           side_m, jnp.asarray(R), jnp.asarray(T),
                           jnp.asarray(gt), mode="train",
                           rngs={"lm": jax.random.PRNGKey(3)})
        return out.loss, out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    jafter = js.create_train_state(jcfg, params).apply_gradients(jgrads)
    # the trajectory never left the re-init range, so neither side re-drew
    traj = jmodel.apply({"params": params}, jnp.asarray(sat),
                        jnp.asarray(grd), side_m, jnp.asarray(R),
                        jnp.asarray(T), mode="trajectory",
                        rngs={"lm": jax.random.PRNGKey(3)})
    assert all(np.abs(np.asarray(t)).max() < 2.5 for t in traj[:2])
    assert max(np.abs(np.asarray(t)).max() for t in traj) > 1e-2, \
        "the pose never moved"

    cfg = Config(**tiny, **kw)
    model = LMS2GPFord(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(cfg, model)
    state, metrics = make_train_step(model, cfg, ford_side_m=side_m)(
        state, *(torch.from_numpy(a) for a in (sat, grd, R, T, gt)),
        torch.Generator().manual_seed(3))
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
    return SimpleNamespace(
        loss=float(metrics["loss"]), jloss=float(jloss), lr=cfg.lr,
        metrics={k: (metrics[k].numpy(), np.asarray(getattr(jout, k)))
                 for k in METRICS},
        grad_rel_l2=grad_rel, updates=updates)


def _check(r):
    np.testing.assert_allclose(r.loss, r.jloss, rtol=1e-5)
    for k, (g, w) in r.metrics.items():
        atol = 1e-4 * abs(r.jloss) if k in LOSS_UNIT_METRICS else 5e-5
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)
    for k, rel in r.grad_rel_l2.items():
        assert rel <= 3e-2, (k, rel)
    assert r.grad_rel_l2["damping"] <= 3e-2
    assert np.abs(r.updates["damping"][1]).max() > 0
    for k, (strong, worst) in update_agreement(r, strong_frac=0.5).items():
        assert strong <= 1e-3 * r.lr, (k, strong)
        assert worst <= 2 * r.lr * (1 + 1e-3), (k, worst)


def test_ford_train_step_matches_jax():
    _check(_step_parity(banded_bf16_map=0))


def test_ford_train_step_real_rig_matches_jax_gather_path():
    """The Ford data's own rig: the port's unswapped kernel layout (K2 / K3
    and ``lm_update_implicit`` with du, dv = the kernel's dx, dy) against
    the JAX gather path's ``lm_update_implicit_pixel_norm``."""
    _check(_step_parity(real_rig=True, banded_bf16_map=0))
