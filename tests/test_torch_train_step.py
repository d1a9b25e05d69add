"""Port parity for one whole training step at a tiny size, fp32 map: the
port's ``make_train_step`` (CPU, plain K2 / K3) against
``jax.value_and_grad`` of the JAX model (``use_banded_warp=2``: the Pallas
sampler in interpret mode) followed by the JAX package's optax Adam, on the
same weights, images and ground-truth poses.  ``train_damping=1`` so that
``damping`` gets a gradient.  The bf16-map step is in
tests/test_torch_train_step_bf16.py.

Tolerances (fp32 map), and why:
* loss: rtol 1e-5.  Both frameworks run the same 6 LM rounds; a last-bit
  difference in uv can flip the floor cell of a few samples, and 6 rounds
  amplify it only slightly (measured: equal to the last bit).
* per-level metrics: atol 1e-5 of the loss for the two in loss units
  (``loss_decrease`` is a difference of two ~140 values; measured 1e-6 of
  the loss), atol 1e-5 for the normalized pose errors (measured 1.8e-6).
* every parameter gradient: relL2 <= 1e-4 (measured up to 2.6e-5 at the
  decoder convolutions).  Torch's and XLA's fp32 convolution backwards sum
  in other orders.
* the parameters after the Adam step: Adam's first update is lr * g /
  (|g| + eps), about lr * sign(g), so an element whose gradient is within
  the frameworks' noise of zero may step the other way.  Every element
  agrees within 2 lr, and every element whose gradient is at least 1% of
  its tensor's RMS gradient within 1e-3 lr (measured 3.7e-5 lr: the
  parameters' float32 rounding).
"""

import numpy as np

from _torch_train_parity import (LOSS_UNIT_METRICS, step_parity,
                                 update_agreement)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_train_step_matches_fp32_map():
    r = step_parity(banded_bf16_map=0)
    np.testing.assert_allclose(r.loss, r.jloss, rtol=1e-5)
    for k, (g, w) in r.metrics.items():
        atol = 1e-5 * abs(r.jloss) if k in LOSS_UNIT_METRICS else 1e-5
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)
    for k, rel in r.grad_rel_l2.items():
        assert rel <= 1e-4, (k, rel)
    assert r.grad_rel_l2["damping"] <= 1e-4
    for k, (strong, worst) in update_agreement(r).items():
        assert strong <= 1e-3 * r.lr, (k, strong)
        assert worst <= 2 * r.lr * (1 + 1e-3), (k, worst)
