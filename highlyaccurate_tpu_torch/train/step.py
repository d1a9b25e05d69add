"""The train step (port of ``highlyaccurate_tpu/train/step.py:101-156``,
single device; data-parallel training is not ported yet).

    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    state, metrics = step(state, sat, grd, gt_pose, generator)

One step differentiates ``loss_func`` over the whole unrolled solver and
applies Adam.  Parameters that receive no gradient (the confidence heads,
and ``damping`` unless ``train_damping``) keep ``grad`` None, so Adam skips
them; optax updates them with a zero gradient, which also leaves them as
they are.
"""

from __future__ import annotations

import dataclasses

import torch

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
from highlyaccurate_tpu_torch.train.state import TrainState

METRICS = ("loss_decrease", "shift_lat_decrease", "shift_lon_decrease",
           "thetas_decrease", "loss_last", "shift_lat_last", "shift_lon_last",
           "theta_last")


def make_train_step(model: LMS2GP, cfg: Config):
    """``step(state, sat, grd, gt_pose, generator) -> (state, metrics)``.

    sat [B, A, A, 3], grd [B, H, W, 3] float32 images and gt_pose [B, 3]
    (normalized (shift_u, shift_v, heading)) on the model's device;
    generator: the re-init ``torch.Generator`` on that device.  The model's
    parameters are updated in place.  metrics: the JAX step's names, as
    detached tensors on the device ("loss" scalar, the rest [L]).
    """
    del cfg  # the model carries its config; kept for the JAX signature

    def step(state: TrainState, sat, grd, gt_pose, generator):
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        out = model(sat, grd, mode="train", gt_pose=gt_pose,
                    generator=generator)
        out.loss.backward()
        opt.step()
        metrics = {"loss": out.loss.detach()}
        metrics.update((k, getattr(out, k).detach()) for k in METRICS)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step
