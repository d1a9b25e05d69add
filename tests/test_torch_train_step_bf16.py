"""Port parity for one whole training step at a tiny size with the default
bf16 map (``banded_bf16_map=1``): as tests/test_torch_train_step.py, which
has the fp32 map and the tight tolerances.

Here the two frameworks' features differ by ~1e-6 relative (their
convolutions sum in other orders), which flips the bf16 rounding of a few
map values, and 6 LM rounds carry that into the poses.  Tolerances, set
about 5x above the readings of this test:
* loss: rtol 1e-4 (measured 1.5e-5);
* per-level metrics: atol 1e-4 of the loss for the two in loss units
  (measured 3e-5), atol 1e-4 for the normalized pose errors (2.2e-5);
* every parameter gradient: relL2 <= 1e-2 (measured up to 1.7e-3, at the
  ground branch's deep convolutions);
* the Adam step: every element within 2 lr, and every element whose
  gradient is at least 1% of its tensor's RMS gradient within 1e-3 lr, as
  with the fp32 map (measured 3.7e-5 lr; below that 1%, elements near zero
  step the other way).
"""

import numpy as np

from _torch_train_parity import (LOSS_UNIT_METRICS, step_parity,
                                 update_agreement)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_train_step_matches_bf16_map():
    r = step_parity(banded_bf16_map=1)
    np.testing.assert_allclose(r.loss, r.jloss, rtol=1e-4)
    for k, (g, w) in r.metrics.items():
        atol = 1e-4 * abs(r.jloss) if k in LOSS_UNIT_METRICS else 1e-4
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)
    for k, rel in r.grad_rel_l2.items():
        assert rel <= 1e-2, (k, rel)
    for k, (strong, worst) in update_agreement(r).items():
        assert strong <= 1e-3 * r.lr, (k, strong)
        assert worst <= 2 * r.lr * (1 + 1e-3), (k, worst)
