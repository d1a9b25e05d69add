"""The train step (port of ``highlyaccurate_tpu/train/step.py:101-156``,
single device; data-parallel training is not ported yet).

    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    state, metrics = step(state, sat, grd, gt_pose, generator)          # S2GP
    state, metrics = step(state, sat, grd, camera_k, gt_pose, generator)  # G2SP
    step = make_train_step(model, cfg, ford_side_m=512 * 0.22)          # Ford
    state, metrics = step(state, sat, grd, R_FL, T_FL, gt_pose, generator)

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
from highlyaccurate_tpu_torch.train.state import TrainState

METRICS = ("loss_decrease", "shift_lat_decrease", "shift_lon_decrease",
           "thetas_decrease", "loss_last", "shift_lat_last", "shift_lon_last",
           "theta_last")


def make_train_step(model: torch.nn.Module, cfg: Config,
                    ford_side_m=None):
    """S2GP (an ``LMS2GP``): ``step(state, sat, grd, gt_pose, generator)``;
    G2SP (an ``LMG2SP``): ``step(state, sat, grd, camera_k, gt_pose,
    generator)``; Ford (an ``LMS2GPFord``, with ``ford_side_m`` the
    satellite patch's side in meters): ``step(state, sat, grd, R_FL, T_FL,
    gt_pose, generator)``; each returns (state, metrics).

    sat [B, A, A, 3], grd [B, H, W, 3] float32 images, camera_k [B, 3, 3]
    (G2SP), R_FL [B, 3, 3] and T_FL [B, 3] (Ford) and gt_pose [B, 3]
    (normalized pose, in the model's own order) on the model's device (a
    Ford rig may stay on the host, which spares the forward a read from
    the device for its kernel layout; see ``models/ford.py``);
    generator: the re-init ``torch.Generator`` on that device (G2SP never
    re-inits and ignores it; it keeps the JAX step's rng argument).  The
    model's parameters are updated in place.  metrics: the JAX step's
    names, as detached tensors on the device ("loss" scalar, the rest [L]).
    """
    g2sp = cfg.direction == "G2SP"
    ford = ford_side_m is not None

    def step(state: TrainState, sat, grd, *rest):
        if ford:
            R_FL, T_FL, gt_pose, generator = rest
            args = (ford_side_m, R_FL, T_FL)
            fwd = dict(generator=generator)
        elif g2sp:
            camera_k, gt_pose, _ = rest
            args, fwd = (camera_k,), {}
        else:
            gt_pose, generator = rest
            args, fwd = (), dict(generator=generator)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        out = model(sat, grd, *args, mode="train", gt_pose=gt_pose, **fwd)
        out.loss.backward()
        opt.step()
        metrics = {"loss": out.loss.detach()}
        metrics.update((k, getattr(out, k).detach()) for k in METRICS)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step
