"""Port parity for one training step through the gather sampler path
(``use_banded_warp=0``) of every family: the loss and every parameter's
gradient against the JAX package on one init (CPU; the inputs, sizes and
inits of tests/test_torch_gather_path.py).

Tolerances: the loss relative 1e-5 (measured <= 1.2e-6) and every
gradient relL2 <= ``GRAD_REL_L2`` (torch's and XLA's float32 convolution
backward differ by up to ~1e-2 at the deepest convs, as in
tests/test_whole_model_parity.py; measured <= 1.3e-3, Ford).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu_torch.params import state_dict_from_jax
from test_torch_gather_path import (FAMILIES, _case, _fwd_kw, _jax, _port,
                                    _torch_args)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRAD_REL_L2 = 2e-2


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_jax(family):
    """One training forward and backward through the gather path (loss
    method 0): the loss and every parameter's gradient."""
    sat, grd, gt, extra, params = _case(family)
    jmodel = _jax(family)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in (sat, grd, *extra)]

    def loss_fn(p):
        return jmodel.apply({"params": p}, *jargs, jnp.asarray(gt),
                            mode="train",
                            rngs={"lm": jax.random.PRNGKey(3)}).loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    model = _port(family, params)
    out = model(*_torch_args(family, sat, grd, extra), mode="train",
                gt_pose=torch.from_numpy(gt), **_fwd_kw(family))
    out.loss.backward()
    loss = float(out.loss.detach())
    loss_err = abs(loss - float(jloss)) / abs(float(jloss))
    rel = {}
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if not np.abs(w).max() > 0:
            assert p.grad is None or not p.grad.abs().max() > 0, name
            continue
        rel[name] = _rel_l2(p.grad.numpy(), w)
    worst = max(rel, key=rel.get)
    print(family, "loss rel err", loss_err, "grad relL2 worst", worst,
          rel[worst])
    assert loss_err <= 1e-5
    assert len(rel) > 10 and rel[worst] <= GRAD_REL_L2
