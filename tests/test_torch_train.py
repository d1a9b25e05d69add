"""Port parity for the training pieces without the model:
``lm_update_implicit`` (highlyaccurate_tpu_torch.solver.updates),
``loss_func`` method 0 (highlyaccurate_tpu_torch.losses) and the optimizer
of ``train/state.py`` against the JAX package on the same inputs.

Tolerances, and why:
* ``lm_update_implicit`` values rtol 2e-4 / atol 2e-5, the JAX package's
  own solver-parity tolerance; its VJP atol 1e-5 of each gradient's max
  (measured up to 4e-7: the sums over u, v and channels are reassociated,
  and the 3x3 solve's backward compounds that).
* ``loss_func``: 1e-5 (a mean of absolute errors; float32).
* Adam against optax on the same gradients: rtol 1e-6 / atol 1e-7, the
  rounding of one float32 update (the two order their operations
  differently).
The re-init draws differ between the frameworks, so the update inputs keep
every pose inside +-2.5 and the tests assert that they do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.losses import losses as jl
from highlyaccurate_tpu.solver import updates as ju
from highlyaccurate_tpu.train import state as js
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.losses import losses as tl
from highlyaccurate_tpu_torch.solver import updates as tu
from highlyaccurate_tpu_torch.train import state as ts

B, V, W, C = 3, 5, 16, 8


def _implicit_inputs(seed):
    """K2-like samples and derivatives, target rows, a ray mask, per-row
    affine duv coefficients, a pose and a damping parameter."""
    rng = np.random.RandomState(seed)
    out, dx, dy, grd = (rng.randn(B, V, W, C).astype(np.float32)
                        for _ in range(4))
    mask = (rng.rand(V, W) > 0.2).astype(np.float32)
    P0 = rng.randn(B, V, 2, 3).astype(np.float32)
    dP = (rng.randn(B, V, 2, 3) * 0.1).astype(np.float32)
    pose = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    damping = rng.randn(1, 3).astype(np.float32)
    return out, dx, dy, grd, mask, P0, dP, pose, damping


CASES = [dict(), dict(active_dims=(0, 1)), dict(use_hessian=True),
         dict(train_damping=True)]


@pytest.mark.parametrize("overrides", CASES,
                         ids=["default", "rotation_range=0", "use_hessian",
                              "train_damping"])
def test_lm_update_implicit_matches(overrides):
    """Values and the VJP with respect to every input (active_dims (0, 1)
    is what rotation_range=0 selects)."""
    out, dx, dy, grd, mask, P0, dP, pose, damping = _implicit_inputs(21)
    jcfg = ju.LMConfig(normalize=True, **overrides)
    key = jax.random.PRNGKey(2)

    def jfn(pose, out, dx, dy, grd, P0, dP, damping):
        return ju.lm_update_implicit(pose, out, dx, dy, grd,
                                     jnp.asarray(mask)[None], P0, dP,
                                     damping, jcfg, key)

    args = [pose, out, dx, dy, grd, P0, dP, damping]
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = np.asarray(want)
    assert np.all(np.abs(want[:, :2]) < 2.5), "parity input left the range"
    ct = np.random.RandomState(22).randn(B, 3).astype(np.float32)
    want_g = vjp(jnp.asarray(ct))

    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    got = tu.lm_update_implicit(*ta[:5], torch.from_numpy(mask), *ta[5:],
                                tu.LMConfig(**overrides),
                                torch.Generator().manual_seed(2))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4,
                               atol=2e-5)
    got.backward(torch.from_numpy(ct))
    names = ("pose", "out", "dx", "dy", "grd", "P0", "dP", "damping")
    for name, t, w in zip(names, ta, want_g):
        w = np.asarray(w)
        g = np.zeros_like(w) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


def test_loss_func_method0_matches():
    rng = np.random.RandomState(3)
    traj = [rng.uniform(-1, 1, (B, 5, 3)).astype(np.float32)
            for _ in range(3)]
    gt = [rng.uniform(-1, 1, B).astype(np.float32) for _ in range(3)]
    coes = (100.0, 90.0, 0.0)
    want = jl.loss_func(0, *(jnp.asarray(a) for a in traj + gt), *coes)
    got = tl.loss_func(0, *(torch.from_numpy(a) for a in traj + gt), *coes)
    assert type(got).__name__ == "LossDiagnostics"
    assert got._fields == want._fields
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # methods 1-3 are held to JAX in tests/test_torch_solver_updates.py;
    # another method raises as JAX's does
    with pytest.raises(ValueError, match="unknown loss_method 4"):
        tl.loss_func(4, *(torch.from_numpy(a) for a in traj + gt),
                     ref_feat_list=[])


def _adam_pair(keep):
    """The same three parameters in both frameworks; the port's third gets
    no gradient (grad None), JAX's a zero gradient."""
    rng = np.random.RandomState(4)
    shapes = {"a": (4, 3), "b": (7,), "frozen": (2, 2)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) * (0 if k == "frozen"
                                                      else 1)
              for k, s in shapes.items()} for _ in range(3)]
    jcfg = JConfig(lr=1e-3, keep_optimizer_state=keep)
    tcfg = Config(lr=1e-3, keep_optimizer_state=keep)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    return init, grads, jcfg, tcfg, tparams


@pytest.mark.parametrize("keep", [0, 1])
def test_adam_and_epoch_reset_match_optax(keep):
    """Two steps, the epoch-2 reset, one more step: the parameters after
    each step, the lr and the optimizer state."""
    init, grads, jcfg, tcfg, tparams = _adam_pair(keep)
    jstate = js.create_train_state(jcfg, {k: jnp.asarray(v)
                                          for k, v in init.items()})
    model = torch.nn.Module()
    for k, p in tparams.items():
        model.register_parameter(k, p)
    tstate = ts.create_train_state(tcfg, model)
    assert tstate.optimizer.defaults["betas"] == (0.9, 0.999)
    assert tstate.optimizer.defaults["eps"] == 1e-8
    for i, g in enumerate(grads):
        if i == 2:
            jstate = js.reset_for_epoch(jstate, jcfg, 2)
            tstate = ts.reset_for_epoch(tstate, tcfg, 2)
            assert tstate.epoch == 2
            lr = tstate.optimizer.param_groups[0]["lr"]
            assert lr == pytest.approx(1e-3 * 0.98, rel=1e-12)
            assert lr == pytest.approx(float(
                jstate.opt_state.hyperparams["learning_rate"]), rel=1e-6)
            assert bool(tstate.optimizer.state) == bool(keep)
        jstate = jstate.apply_gradients({k: jnp.asarray(v)
                                         for k, v in g.items()})
        tstate.optimizer.zero_grad(set_to_none=True)
        for k, p in tparams.items():
            if k != "frozen":
                p.grad = torch.from_numpy(g[k])
        tstate.optimizer.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jstate.params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(tparams["frozen"].detach().numpy(),
                                  init["frozen"])
    assert ts.epoch_lr(1e-4, 0) == js.epoch_lr(1e-4, 0) == 1e-4
