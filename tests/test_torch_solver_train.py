"""Port parity for training with the solver options on the CPU: the loss
and every parameter's gradient of one training forward against the JAX
package's ``value_and_grad`` on the same weights and data, for
``Optimizer="NN"`` (the ``NNrefine`` head's gradients included), loss
methods 1, 2 and 3 (the rounds gather the whole ground map, the gt pose is
projected too), dropout (the keep-set fed to both, as in
tests/test_torch_solver_options.py) and Ford's GN; then ``NNrefine`` in
the train state (Adam steps it) and in the checkpoints (``NNrefine.*``).

Sizes and params as tests/test_torch_solver_options.py (64x64 satellite,
32x128 ground, level 3, fp32 map, ``train_damping=1``), one iteration
(3 rounds; two for method 3, whose terms compare iterations).

Limits: the loss within 1e-5 relative; each parameter's gradient within
``GRAD_REL`` relL2 (as tests/test_torch_ford_train.py: torch's fp32 conv
backward reassociates; measured beside it).  Loss method 3's
gradient is NaN in both frameworks, in the same tensors: its point
distance takes sqrt(0) at every masked pixel (a JAX contract, ROADMAP C);
the convolutions' backward spreads the NaN over nearly the same elements
(99.1% of SatFeatureNet.conv0.weight alike).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from highlyaccurate_tpu_torch.train.checkpoint import (load_params,
                                                       load_train_state,
                                                       save_params,
                                                       save_train_state,
                                                       wait_for_async_saves)
from highlyaccurate_tpu_torch.train.state import create_train_state
from highlyaccurate_tpu_torch.train.step import make_train_step
from test_torch_solver_options import (SIDE_M, TINY, _images, dropout_draws,
                                       extras, fixed_permutations,
                                       jax_model, jax_params, port_model)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 2
CASES = {"S2GP-NN": ("S2GP", dict(Optimizer="NN")),
         "S2GP-loss1": ("S2GP", dict(loss_method=1)),
         "S2GP-loss2": ("S2GP", dict(loss_method=2)),
         # method 3 compares consecutive iterations: two of them
         "S2GP-loss3": ("S2GP", dict(loss_method=3, N_iters=2)),
         "S2GP-dropout": ("S2GP", dict(dropout=1)),
         "Ford-GN": ("Ford", dict(Optimizer="GN"))}
# relL2 of each parameter's gradient, as tests/test_torch_ford_train.py
# (the deepest convs' fp32 backward drifts most; measured, worst tensor:
# NN 2.3e-4, loss 1 1.3e-2, loss 2 6.9e-3, dropout 4.1e-3, Ford GN
# 1.1e-3, each at SatFeatureNet.conv0.weight)
GRAD_REL = 3e-2


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _batch(seed):
    sat, grd = _images(seed)
    gt = np.random.RandomState(seed + 1).uniform(-0.5, 0.5, (B, 3)).astype(
        np.float32)
    return sat, grd, gt


def _jax_grads(family, params, sat, grd, gt, **kw):
    model = jax_model(family, train_damping=1, **kw)
    side = (SIDE_M,) if family == "Ford" else ()
    ex = [jnp.asarray(e) for e in extras(family)]

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(sat), jnp.asarray(grd),
                          *side, *ex, jnp.asarray(gt), mode="train",
                          rngs={"lm": jax.random.PRNGKey(3)})
        return out.loss, out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                    has_aux=True))(params)
    return float(loss), out, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads))


def _port_forward(model, family, sat, grd, gt, generator):
    args = [torch.from_numpy(sat), torch.from_numpy(grd)]
    if family == "Ford":
        args.append(SIDE_M)
    args += [torch.from_numpy(e) for e in extras(family)]
    return model(*args, mode="train", gt_pose=torch.from_numpy(gt),
                 generator=generator)


@pytest.mark.parametrize("case", list(CASES))
def test_train_forward_matches_jax(case, monkeypatch):
    family, kw = CASES[case]
    kw = dict(dict(N_iters=1), **kw)
    params = jax_params(family, 30, nn=kw.get("Optimizer") == "NN")
    sat, grd, gt = _batch(31)
    perms = fixed_permutations(monkeypatch) if kw.get("dropout") else None
    jloss, jout, jgrads = _jax_grads(family, params, sat, grd, gt, **kw)
    model = port_model(family, params, train_damping=1, **kw)
    generator = (dropout_draws(kw, perms) if perms is not None
                 else torch.Generator().manual_seed(0))
    out = _port_forward(model, family, sat, grd, gt, generator)
    out.loss.backward()
    print(case, "loss", float(out.loss), "JAX", jloss)
    assert abs(float(out.loss) - jloss) <= 1e-5 * abs(jloss)
    for name in ("L1", "L2", "L3", "L4"):
        w, g = getattr(jout, name), getattr(out, name)
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5 * np.abs(
                                           np.asarray(w)).max(), err_msg=name)
    rel = {}
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        if kw.get("loss_method") == 3:
            # NaN reaches the same tensors (conv backwards spread it over
            # slightly different elements)
            assert np.isnan(got).any() == np.isnan(want).any(), name
            continue
        rel[name] = _rel_l2(got, want)
    if kw.get("loss_method") == 3:
        assert np.isnan(model.GrdFeatureNet.conv0.weight.grad).any()
        return
    worst = max(rel, key=rel.get)
    print(case, "worst gradient relL2", worst, rel[worst])
    assert rel[worst] <= GRAD_REL, (worst, rel[worst])
    if kw.get("Optimizer") == "NN":
        nn_grads = [k for k in rel if k.startswith("NNrefine.linear0")
                    or k.startswith("NNrefine.mapping")]
        assert nn_grads and all(
            np.abs(jgrads[k].numpy()).max() > 0 for k in nn_grads)


def test_nnrefine_trains_and_checkpoints(tmp_path):
    """``create_train_state`` puts ``NNrefine`` in Adam, one
    ``make_train_step`` moves its used weights (the slot-3 conv, unused
    at level 3, stays), and ``save_params`` / ``save_train_state`` keep it
    under ``NNrefine.*`` and restore it bit for bit."""
    params = jax_params("S2GP", 32, nn=True)
    cfg_kw = dict(TINY, Optimizer="NN")
    model = port_model("S2GP", params, Optimizer="NN")
    cfg = Config(**cfg_kw)
    state = create_train_state(cfg, model)
    names = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert all(id(p) in names for p in model.NNrefine.parameters())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sat, grd, gt = _batch(33)
    state, metrics = make_train_step(model, cfg)(
        state, torch.from_numpy(sat), torch.from_numpy(grd),
        torch.from_numpy(gt), torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    after = model.state_dict()
    moved = {k for k in after if k.startswith("NNrefine")
             and not torch.equal(after[k], before[k])}
    assert "NNrefine.linear0.1.weight" in moved
    assert "NNrefine.mapping.3.weight" in moved
    assert "NNrefine.linear3.1.weight" not in moved
    save_params(str(tmp_path), "m", model, async_save=False)
    save_train_state(str(tmp_path), "s", state, model, async_save=False)
    wait_for_async_saves()
    fresh = port_model("S2GP", params, Optimizer="NN")
    load_params(str(tmp_path), "m", fresh)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    fresh = port_model("S2GP", params, Optimizer="NN")
    restored = load_train_state(str(tmp_path), "s",
                                create_train_state(cfg, fresh), fresh)
    assert restored.step == 1
    assert torch.equal(fresh.NNrefine.mapping[1].weight,
                       model.NNrefine.mapping[1].weight)
    assert restored.epoch == state.epoch
