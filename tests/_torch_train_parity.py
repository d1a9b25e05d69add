"""Shared harness of the whole-step parity tests (test_torch_train_step*.py):
one training step of the port and of the JAX package at a tiny size on the
same weights, images and ground-truth poses."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.models.lm_s2gp import LMS2GP as JLMS2GP
from highlyaccurate_tpu.train import state as js
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from highlyaccurate_tpu_torch.train.state import create_train_state
from highlyaccurate_tpu_torch.train.step import METRICS, make_train_step

TINY = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=2, level=3,
            train_damping=1)
B = 2
# metrics in the loss's units (the rest are normalized pose errors)
LOSS_UNIT_METRICS = ("loss_decrease", "loss_last")


def update_agreement(r):
    """{parameter: (largest update difference over the elements whose JAX
    gradient is at least 1% of the tensor's RMS gradient, over all)}.

    Adam's first update is lr * g / (|g| + eps), about lr * sign(g), so an
    element whose gradient is within the frameworks' noise of zero may step
    the other way; away from zero, a relative gradient error r moves the
    update by lr * r * eps / |g| only."""
    out = {}
    for name, (d, w) in r.updates.items():
        strong = np.abs(w) >= 1e-2 * np.sqrt(np.mean(w * w))
        out[name] = (float(d[strong].max(initial=0.0)), float(d.max()))
    return out


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def step_parity(seed=0, **kw):
    """Run one step in both frameworks.  Returns the losses, the metrics
    (port, JAX), each parameter's gradient relL2, and for each parameter
    the elementwise difference of the two Adam updates beside the JAX
    gradient, (|update - JAX update|, JAX gradient)."""
    rng = np.random.RandomState(seed)
    sat = rng.rand(B, 64, 64, 3).astype(np.float32)
    grd = rng.rand(B, 32, 128, 3).astype(np.float32)
    gt = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    jcfg = JConfig(use_banded_warp=2, **TINY, **kw)
    jmodel = JLMS2GP(cfg=jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(seed),
                          "lm": jax.random.PRNGKey(1)}, jnp.asarray(sat),
                         jnp.asarray(grd),
                         method=JLMS2GP.extract_features)["params"]

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(sat), jnp.asarray(grd),
                           jnp.asarray(gt), mode="train",
                           rngs={"lm": jax.random.PRNGKey(3)})
        return out.loss, out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    jafter = js.create_train_state(jcfg, params).apply_gradients(jgrads)

    cfg = Config(**TINY, **kw)
    model = LMS2GP(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model)
    state, metrics = make_train_step(model, cfg)(
        state, torch.from_numpy(sat), torch.from_numpy(grd),
        torch.from_numpy(gt), torch.Generator().manual_seed(3))
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
