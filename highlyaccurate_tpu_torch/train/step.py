"""The train and eval steps and the host-to-device prefetch (port of
``highlyaccurate_tpu/train/step.py:80-215``), on one device.

The JAX module also builds the data-parallel mesh (``make_mesh``,
``make_mesh_for_batch``, ``shard_batch``, ``replicate``,
``eval_batch_pad``); the port runs on one device and has no counterpart of
them yet (queue A6, ``torch.distributed``).

    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    state, metrics = step(state, sat, grd, gt_pose, generator)          # S2GP
    state, metrics = step(state, sat, grd, gt_pose, generator,
                          gt_depth=depth)          # S2GP with use_gt_depth
    state, metrics = step(state, sat, grd, camera_k, gt_pose, generator)  # G2SP
    step = make_train_step(model, cfg, ford_side_m=512 * 0.22)          # Ford
    state, metrics = step(state, sat, grd, R_FL, T_FL, gt_pose, generator)
    step = make_eval_step(model, cfg, warm_start=True, with_info=True)
    lat, lon, theta, cov = step(sat, grd, init_pose, generator)        # S2GP

One step differentiates ``loss_func`` over the whole unrolled solver and
applies Adam.  Parameters that receive no gradient (the confidence heads,
and ``damping`` unless ``train_damping``) keep ``grad`` None, so Adam skips
them; optax updates them with a zero gradient, which also leaves them as
they are.  ``freeze_backbones`` (the Ford ``--transformer`` restore) sets
the two feature networks' gradients to zeros before Adam's step, as the
JAX step zeroes them: Adam keeps their state, whose moments are zero after
the restore, so it steps them by zero and the weights stay bit-equal.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.models.lm_s2gp import (eval_draws_per_batch,
                                                     eval_draws_per_image)
from highlyaccurate_tpu_torch.solver.updates import (PresetDraws,
                                                     uniform_draws)
from highlyaccurate_tpu_torch.train.state import TrainState

METRICS = ("loss_decrease", "shift_lat_decrease", "shift_lon_decrease",
           "thetas_decrease", "loss_last", "shift_lat_last", "shift_lon_last",
           "theta_last")


def make_train_step(model: torch.nn.Module, cfg: Config,
                    ford_side_m=None, freeze_backbones: bool = False):
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
    re-inits and ignores it; it keeps the JAX step's rng argument);
    gt_depth (S2GP with ``use_gt_depth`` only): the [B, H, W] depth the
    forward lifts its rays with (the JAX step takes none).  The
    model's parameters are updated in place.  metrics: the JAX step's
    names, as detached tensors on the device ("loss" scalar, the rest [L]).
    ``freeze_backbones`` zeroes the feature networks' gradients before
    each optimizer step (JAX ``train/step.py:139-143``).
    """
    g2sp = cfg.direction == "G2SP"
    ford = ford_side_m is not None
    frozen = ([p for net in (model.SatFeatureNet, model.GrdFeatureNet)
               for p in net.parameters()] if freeze_backbones else [])

    def step(state: TrainState, sat, grd, *rest, gt_depth=None):
        if ford:
            R_FL, T_FL, gt_pose, generator = rest
            args = (ford_side_m, R_FL, T_FL)
            fwd = dict(generator=generator)
        elif g2sp:
            camera_k, gt_pose, _ = rest
            args, fwd = (camera_k,), {}
        else:
            gt_pose, generator = rest
            args, fwd = (), dict(generator=generator, gt_depth=gt_depth)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        out = model(sat, grd, *args, mode="train", gt_pose=gt_pose, **fwd)
        out.loss.backward()
        for p in frozen:
            p.grad = torch.zeros_like(p)
        opt.step()
        metrics = {"loss": out.loss.detach()}
        metrics.update((k, getattr(out, k).detach()) for k in METRICS)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step


def device_prefetch(batches, place, depth: int = 2):
    """Double-buffered host-to-device pipeline: ``place`` maps a host batch
    to device tensors without waiting (``to_device``), and ``depth`` placed
    batches stay in flight, so batch N+1's copy overlaps batch N's
    compute."""
    q = collections.deque()
    for b in batches:
        q.append(place(b))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array (numpy or tensor) on ``device``: for a GPU through a
    pinned host buffer and a ``non_blocking`` copy, which returns at once
    (the caching host allocator keeps the buffer until the copy is done);
    for the CPU the array itself."""
    t = torch.as_tensor(x)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class EvalProgram(torch.nn.Module):
    """The evaluation forward of a model as a module of tensors alone, the
    unit ``Localizer.export`` exports with ``torch.export``:

        program(sat, grd, *extras[, init_pose], draws)
            -> (shift_lat, shift_lon, theta[, cov])

    extras: none for KITTI S2GP, camera_k [B, 3, 3] for G2SP, R_FL
    [B, 3, 3] and T_FL [B, 3] for Ford (with ``ford_side_m``); init_pose
    [B, 3] with ``warm_start``; cov [B, 3, 3] with ``with_info``.  draws
    [``n_draws(B)``] uniform in [-1, 1) are the forward's random numbers
    (``PresetDraws``: the multi-start initial poses, then the dropout and
    the re-init of every round), an input because an exported program
    cannot take a generator; a count that does not match what the forward
    takes raises.  ``ford_layout`` fixes Ford's banded kernel layout (an
    exported program cannot read the rig on the host); None reads it from
    each batch's rig.
    """

    def __init__(self, model: torch.nn.Module, cfg: Config,
                 ford_side_m=None, warm_start: bool = False,
                 with_info: bool = False, ford_layout=None):
        super().__init__()
        self.model = model
        self.g2sp = cfg.direction == "G2SP"
        self.ford_side_m = ford_side_m
        self.warm_start = warm_start
        self.with_info = with_info
        self.ford_layout = ford_layout
        self.draws_per_image = eval_draws_per_image(cfg, model.lm_cfg)
        self.draws_per_batch = eval_draws_per_batch(cfg)

    def n_draws(self, B: int) -> int:
        """The random numbers a forward of B images takes."""
        return self.draws_per_image * B + self.draws_per_batch

    def forward(self, sat, grd, *rest):
        *extras, draws = rest
        init = extras.pop() if self.warm_start else None
        generator = PresetDraws(draws)
        kw = dict(mode="test", init_pose=init, generator=generator,
                  with_info=self.with_info)
        if self.ford_side_m is not None:
            R_FL, T_FL = extras
            out = self.model(sat, grd, self.ford_side_m, R_FL, T_FL,
                             layout=self.ford_layout, **kw)
        elif self.g2sp:
            (camera_k,) = extras
            out = self.model(sat, grd, camera_k, **kw)
        else:
            if extras:  # the star-unpack must not silently eat stray args
                raise TypeError(f"the S2GP eval step takes no extra inputs; "
                                f"got {len(extras)}")
            out = self.model(sat, grd, **kw)
        if generator.used != draws.shape[0]:
            raise ValueError(f"the forward took {generator.used} draws of "
                             f"the {draws.shape[0]} given")
        return out


def make_eval_step(model: torch.nn.Module, cfg: Config, ford_side_m=None,
                   warm_start: bool = False, with_info: bool = False):
    """Inference (port of JAX ``make_eval_step`` without the mesh): the
    final (shift_lat, shift_lon, theta), each [B], and with ``with_info``
    their pose covariance [B, 3, 3] (normalized, pose order).

    S2GP (an ``LMS2GP``): ``step(sat, grd[, init_pose], generator)``; G2SP
    (an ``LMG2SP``): ``step(sat, grd, camera_k[, init_pose], generator)``;
    Ford (an ``LMS2GPFord``, with ``ford_side_m``): ``step(sat, grd, R_FL,
    T_FL[, init_pose], generator)``; ``init_pose`` [B, 3] with
    ``warm_start``.  The step draws the forward's random numbers from
    ``generator`` (a ``torch.Generator`` on the model's device; G2SP draws
    only for ``pose_hypotheses > 1`` and otherwise takes None) ahead of the
    forward, in one call, and runs ``EvalProgram`` on them, so a program
    exported from ``EvalProgram`` and fed numbers from a generator seeded
    alike gives the same outputs.  The model holds its weights; the step
    runs under ``torch.no_grad()``."""
    program = EvalProgram(model, cfg, ford_side_m, warm_start, with_info)

    @torch.no_grad()
    def step(sat, grd, *rest):
        *args, generator = rest
        n = program.n_draws(sat.shape[0])
        if n and generator is None:
            raise ValueError("this evaluation draws random numbers "
                             "(multi-start, dropout or re-init): pass a "
                             "generator")
        draws = (uniform_draws(generator, (n,), sat.device) if n
                 else sat.new_zeros(0))
        return program(sat, grd, *args, draws)

    return step
