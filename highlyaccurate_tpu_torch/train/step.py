"""The train and eval steps, the data-parallel mesh and the host-to-device
prefetch (port of ``highlyaccurate_tpu/train/step.py:29-215``).

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

Data parallelism (JAX: one jitted program over a 1-D ``data`` mesh; here
one process per card under ``torch.distributed``, ``train/distributed.py``):
a ``Mesh`` is this process's devices over the processes of the group.
Shard ``p * len(devices) + i`` of a global batch runs on ``devices[i]`` of
the p-th process of the mesh.  The steps of ``make_train_step(mesh=)`` and
``make_eval_step(mesh=)`` take this process's rows of the global batch
(``shard_batch``): the train step (one device per process) averages the
gradients and metrics over the processes before Adam, so every process
keeps the same state bit for bit; the eval step runs each local device's
slice on its replica and returns the outputs of the whole batch, gathered
from every process in order.  Both hand each shard its slice of the
numbers the whole batch's forward would draw (``ShardDraws``), from a
generator seeded alike on every process.  Without a mesh nothing changes.

    initialize()                                 # torchrun's environment
    mesh = make_mesh_for_batch(cfg.batch_size)
    step = make_train_step(model, cfg, mesh)
    b = shard_batch(mesh, {"sat": sat, "grd": grd, "gt_pose": gt})
    state, metrics = step(state, b["sat"], b["grd"], b["gt_pose"], generator)
"""

from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.models.lm_s2gp import (eval_draws_per_batch,
                                                     eval_draws_per_image)
from highlyaccurate_tpu_torch.solver.updates import (PresetDraws,
                                                     ShardDraws,
                                                     uniform_draws)
from highlyaccurate_tpu_torch.train import distributed
from highlyaccurate_tpu_torch.train.state import TrainState
from highlyaccurate_tpu_torch.utils.profiling import span

METRICS = ("loss_decrease", "shift_lat_decrease", "shift_lon_decrease",
           "thetas_decrease", "loss_last", "shift_lat_last", "shift_lon_last",
           "theta_last")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: ``devices``, this process's devices in shard order
    (one model replica each), over the processes ``ranks`` of the
    ``torch.distributed`` group ``group`` (None: the default group; no
    ranks: this process alone, no collective)."""
    devices: tuple
    ranks: tuple = ()
    group: object = None

    @property
    def processes(self) -> int:
        return max(len(self.ranks), 1)

    @property
    def index(self) -> int:
        """This process's place among the mesh's processes (-1: not in
        it)."""
        if not self.ranks:
            return 0
        r = dist.get_rank()
        return self.ranks.index(r) if r in self.ranks else -1

    @property
    def size(self) -> int:
        """Shards of a global batch: processes times local devices."""
        return self.processes * len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh.  In a process group: every process of it,
    each on ``devices`` (default its own device, ``distributed.
    local_device``: the CPU under gloo, else the card of its local rank).
    Without one: this process alone, on ``devices`` (default every visible
    card)."""
    if dist.is_initialized():
        if devices is None:
            devices = [distributed.local_device(
                "cpu" if dist.get_backend() == "gloo" else None)]
        return Mesh(tuple(torch.device(d) for d in devices),
                    tuple(range(dist.get_world_size())))
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("make_mesh: no devices (no card is visible; pass "
                         "devices=['cpu'])")
    return Mesh(tuple(torch.device(d) for d in devices))


def make_mesh_for_batch(batch_size: int, devices=None) -> Mesh:
    """Data mesh over the largest shard count that divides the batch.

    Training batches must divide evenly across the mesh (gradients are a
    mean over real samples; padding would bias them), so a batch size not
    divisible by the device count idles devices; warn loudly instead of
    silently shrinking.  Eval pads ragged batches to the full mesh
    instead (``eval_batch_pad``).  In a process group the shards are the
    processes (one device each), and a smaller mesh gets a group of its
    own, which every process must make: call this on every process."""
    mesh = make_mesh(devices)
    if mesh.ranks and len(mesh.devices) != 1:
        raise ValueError("a training mesh in a process group takes one "
                         "device per process")
    total = mesh.size
    n = total
    while n > 1 and batch_size % n != 0:
        n -= 1
    if n == total:
        return mesh
    good = sorted({m * total for m in range(1, 3)}
                  | {batch_size - batch_size % total + total})
    print(f"WARNING: batch_size={batch_size} is not divisible by the "
          f"{total} available devices — training will use only "
          f"{n} chip(s) and idle {total - n}. "
          f"Use a batch size that is a multiple of {total} "
          f"(e.g. {good}) to engage the whole mesh.")
    if not mesh.ranks:
        return Mesh(mesh.devices[:n])
    ranks = tuple(range(n))
    return Mesh(mesh.devices, ranks, dist.new_group(list(ranks)))


def eval_batch_pad(batch_size: int, mesh: Optional[Mesh]) -> int:
    """Smallest multiple of the mesh size >= batch_size (eval batches are
    padded up to this so inference shards across every device; the pad
    rows are duplicates and are trimmed from the outputs)."""
    if mesh is None:
        return batch_size
    n = mesh.size
    return -(-batch_size // n) * n


def process_rows(mesh: Mesh, n: int) -> slice:
    """This process's rows of a global batch of ``n`` (a multiple of the
    mesh's processes)."""
    per = n // mesh.processes
    return slice(mesh.index * per, (mesh.index + 1) * per)


def pad_rows(x, n: int):
    """Host array ``x`` with copies of its last row appended up to ``n``
    rows (an eval batch padded to ``eval_batch_pad``)."""
    pad = n - x.shape[0]
    return x if pad <= 0 else np.concatenate([x, np.repeat(x[-1:], pad, 0)])


def shard_batch(mesh: Mesh, batch):
    """This process's rows of a host batch (a dict, list or tuple of arrays
    with the batch axis first, or one array), on the mesh's first local
    device (``to_device``: the copies do not wait)."""
    def place(x):
        return to_device(x[process_rows(mesh, x.shape[0])], mesh.devices[0])

    if isinstance(batch, dict):
        return {k: place(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(place(v) for v in batch)
    return place(batch)


def replicate(mesh: Mesh, model: torch.nn.Module) -> list:
    """The model on each of this process's devices, after every process of
    the mesh took the first one's weights and buffers (a broadcast; none
    without a group).  A device the model is on serves from the model
    itself; another gets a copy, made now: replicate again after the
    weights change."""
    if mesh.ranks:
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=mesh.ranks[0], group=mesh.group)
    return [model if model.device == d else copy.deepcopy(model).to(d)
            for d in mesh.devices]


def _average(mesh: Mesh, tensors) -> list:
    """Each tensor's mean over the mesh's processes (one all-reduce of the
    tensors flattened together; every process gets the same bits)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.processes
    return [f.view_as(t) for t, f in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


def _gather(mesh: Mesh, t):
    """Every process's ``t`` (equal shapes), concatenated in the mesh's
    order along the first axis."""
    if not mesh.ranks:
        return t
    parts = [torch.empty_like(t) for _ in mesh.ranks]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def make_train_step(model: torch.nn.Module, cfg: Config,
                    mesh: Optional[Mesh] = None, ford_side_m=None,
                    ford_extrinsics=None, freeze_backbones: bool = False):
    """S2GP (an ``LMS2GP``): ``step(state, sat, grd, gt_pose, generator)``;
    G2SP (an ``LMG2SP``): ``step(state, sat, grd, camera_k, gt_pose,
    generator)``; Ford (an ``LMS2GPFord``, with ``ford_side_m`` the
    satellite patch's side in meters): ``step(state, sat, grd, R_FL, T_FL,
    gt_pose, generator)``, or ``step(state, sat, grd, gt_pose, generator)``
    where ``ford_extrinsics`` = (R_FL [3, 3], T_FL [3]) gives every
    image's rig (kept on the host, as ``Localizer``'s); each returns
    (state, metrics).

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

    With a ``mesh`` (one device per process, the model's): the batch
    arguments are this process's rows of the global batch (``shard_batch``)
    and ``generator`` is seeded alike on every process; the step draws as
    the whole batch would (``ShardDraws``), and averages the gradients and
    the metrics over the mesh's processes (one all-reduce each) before
    Adam, so the state stays the same on every process.
    """
    g2sp = cfg.direction == "G2SP"
    ford = ford_side_m is not None
    if ford_extrinsics is not None:
        if not ford:
            raise ValueError("ford_extrinsics= is the Ford rig; it needs "
                             "ford_side_m=")
        rig_R, rig_T = (torch.as_tensor(np.asarray(x, np.float32)).reshape(
            shape) for x, shape in zip(ford_extrinsics, ((3, 3), (3,))))
    if mesh is not None and (len(mesh.devices) != 1
                             or mesh.devices[0] != model.device):
        raise ValueError(f"a training mesh holds the model's device alone "
                         f"({model.device}), one process per device; got "
                         f"{list(mesh.devices)}")
    frozen = ([p for net in (model.SatFeatureNet, model.GrdFeatureNet)
               for p in net.parameters()] if freeze_backbones else [])

    def step(state: TrainState, sat, grd, *rest, gt_depth=None):
        if ford:
            if len(rest) == 2 and ford_extrinsics is not None:
                n = sat.shape[0]
                rest = (rig_R.expand(n, 3, 3), rig_T.expand(n, 3)) + rest
            R_FL, T_FL, gt_pose, generator = rest
            args = (ford_side_m, R_FL, T_FL)
            fwd = dict(generator=generator)
        elif g2sp:
            camera_k, gt_pose, _ = rest
            args, fwd = (camera_k,), {}
        else:
            gt_pose, generator = rest
            args, fwd = (), dict(generator=generator, gt_depth=gt_depth)
        if mesh is not None and fwd.get("generator") is not None:
            fwd["generator"] = ShardDraws(fwd["generator"], mesh.size,
                                          mesh.index)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        with span("hat.train.forward"):
            out = model(sat, grd, *args, mode="train", gt_pose=gt_pose,
                        **fwd)
        with span("hat.train.backward"):
            out.loss.backward()
        with span("hat.train.optimizer"):
            for p in frozen:
                p.grad = torch.zeros_like(p)
            metrics = {"loss": out.loss.detach()}
            metrics.update((k, getattr(out, k).detach()) for k in METRICS)
            if mesh is not None and mesh.ranks:
                params = [p for p in model.parameters()
                          if p.grad is not None]
                grads = _average(mesh, [p.grad for p in params])
                for p, g in zip(params, grads):
                    p.grad = g
                metrics = dict(zip(metrics, _average(mesh, list(
                    metrics.values()))))
            opt.step()
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
    each batch's rig.  ``shard`` = (shards, index): the program serves
    shard ``index`` of a batch split in ``shards`` equal ones; draws are
    then the whole batch's (``n_draws`` of its size), of which it takes
    its own (``ShardDraws``).
    """

    def __init__(self, model: torch.nn.Module, cfg: Config,
                 ford_side_m=None, warm_start: bool = False,
                 with_info: bool = False, ford_layout=None, shard=None):
        super().__init__()
        self.model = model
        self.shard = shard
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
        kw = dict(mode="test", init_pose=init, with_info=self.with_info,
                  generator=(generator if self.shard is None
                             else ShardDraws(generator, *self.shard)))
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


def make_eval_step(model: torch.nn.Module, cfg: Config,
                   mesh: Optional[Mesh] = None, ford_side_m=None,
                   warm_start: bool = False, with_info: bool = False):
    """Inference (port of JAX ``make_eval_step``): the final (shift_lat,
    shift_lon, theta), each [B], and with ``with_info`` their pose
    covariance [B, 3, 3] (normalized, pose order).

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
    runs under ``torch.no_grad()``.

    With a ``mesh``: the arguments are this process's rows of the global
    (padded) batch, a multiple of the local devices (``shard_batch``); each
    local device runs its slice on its replica (``replicate``, made with
    the step), drawing its part of the whole batch's numbers, and the step
    returns the outputs of the whole global batch, in order, on the mesh's
    first device (every process gets them all).  A Ford rig stays where it
    is given (the host, for the kernel layout)."""
    if mesh is None:
        program = EvalProgram(model, cfg, ford_side_m, warm_start, with_info)
        programs, devices = [program], None
    else:
        if mesh.index < 0:
            raise ValueError("this process is not in the evaluation mesh")
        nd = len(mesh.devices)
        programs = [EvalProgram(m, cfg, ford_side_m, warm_start, with_info,
                                shard=(mesh.size, mesh.index * nd + i))
                    for i, m in enumerate(replicate(mesh, model))]
        devices = mesh.devices
    n_rigs = 2 if ford_side_m is not None else 0

    @torch.no_grad()
    def step(sat, grd, *rest):
        *args, generator = rest
        if devices is None:
            B, dev = sat.shape[0], sat.device
        else:
            if sat.shape[0] % len(devices):
                raise ValueError(f"a batch of {sat.shape[0]} does not split "
                                 f"over {len(devices)} local devices")
            b = sat.shape[0] // len(devices)
            B, dev = b * mesh.size, devices[0]
        n = programs[0].n_draws(B)
        if n and generator is None:
            raise ValueError("this evaluation draws random numbers "
                             "(multi-start, dropout or re-init): pass a "
                             "generator")
        draws = (uniform_draws(generator, (n,), dev) if n
                 else sat.new_zeros(0, device=dev))
        if devices is None:
            return programs[0](sat, grd, *args, draws)
        outs = []
        for i, (program, d) in enumerate(zip(programs, devices)):
            rows = slice(i * b, (i + 1) * b)
            part = [x[rows] if 2 <= j < 2 + n_rigs
                    else x[rows].to(d, non_blocking=True)
                    for j, x in enumerate((sat, grd, *args))]
            outs.append(program(*part, draws.to(d)))
        return tuple(_gather(mesh, torch.cat([o[k].to(dev) for o in outs]))
                     for k in range(len(outs[0])))

    return step
