"""LM_S2GP evaluation and training (port of
``highlyaccurate_tpu/models/lm_s2gp.py:54-143, 146-186, 233-473,
559-577, 666-855``), and the base it shares with the Ford model
(``models/ford.py``).

Two VGGUnet branches give the satellite and ground feature pyramids; then
N_iters x levels solver rounds refine the pose, iteration-major, or with
``level_first`` every iteration of the coarsest level first
(``round_order``).  Under the geo projection only the bottom half of the
ground rows enters the solver (the sky crop; ``row_start``); every other
``proj`` (polar, nn: the polar rays of ``grd_img2cam_polar``) keeps every
row.  Each round takes one of the JAX package's branches
(``S2GPBase._solver_round``):

* banded (``use_banded_warp``, the default): ``s2gp_uv_jac`` at ground
  columns u = 0, 1 of each kept row (the row's satellite line is affine in
  u, so two points fix it), then ``banded_project``:
  - LM evaluation with ``use_fused_moments`` (the default) and no
    dropout: K1 (``ops/banded_warp.py:banded_moments``) -> per-row
    moments -> ``lm_update_from_moments``;
  - LM training, or evaluation with ``use_fused_moments=0`` or
    ``dropout > 0``: the differentiable sampler K2 / K3
    (``banded_sample``) -> out, dx, dy -> ``lm_update_implicit`` (the
    dropout as a mask);
  - ``use_implicit_lm=0``, or ``Optimizer`` SGD, ADAM or NN: K2's samples
    with the row-affine Jacobian materialized (none for NN) -> the
    update rule (``lm_update``, ``sgd_update``, ``adam_update``, or the
    ``NNrefine`` head's step);
* gather (``use_banded_warp=0``, the faithful default of ``--test 1
  --import_pth``; ``using_weight``, whose update reads the target
  confidence; ``proj`` other than geo; ``use_gt_depth``, whose
  ``gt_depth=`` input lifts the rays per sample with the reference's
  nearest rule, ``gt_depth_lift``, and without one keeps the flat rays):
  ``s2gp_uv_jac`` at every pixel of the kept rows, the
  gather sampler (``ops/grid_sample.py``) on the features in their own
  dtype, then ``lm_update_implicit_pixel_norm`` or, with
  ``use_implicit_lm=0``, ``using_weight`` or another ``Optimizer``, the
  update rule on the materialized Jacobian.

Evaluation (mode ``"test"``) can also run the multi-start sweep
(``pose_hypotheses > 1``, ``S2GPBase.hypotheses``: every hypothesis rides
the batch axis through the same rounds, so K1 launches at batch B x P, and
the one with the smallest normalized finest-level residual wins) and, with
``with_info``, return the pose covariance of the solution
(``S2GPBase._pose_info``: one gather projection at the finest level and
``lm_information`` / ``pose_covariance``; no hand kernel).

Training scores the trajectory with ``loss_func``.  Loss methods 1-3 read
every round's projection of the whole ground map, so their rounds gather
every row and crop the sky before the update (no hand kernel), and each
level is projected at the gt pose too.  The satellite map goes to the
banded kernels as a transposed view (kernel y = sat u, kernel x = sat v).
K1 reads a map cast once per forward to the map dtype, since it does not
change across rounds; K2 casts inside its autograd function, so the map
gradient stays float32.  With ``compute_dtype="bfloat16"`` the features
are bf16 (``VGGUnet``), the banded map is bf16 as ``banded_bf16_map``
makes it, and the target rows are read in float32, as in JAX.

The random numbers of a forward (``Draws``) are, in order: the multi-start
initial poses, then per round the dropout's (``dropout_keep``) and the
re-init's.  ``check_supported`` refuses a direction other than S2GP with
``NotImplementedError`` and an unknown ``Optimizer`` with ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.geometry import kitti as geom
from highlyaccurate_tpu_torch.losses.losses import clamped_index, loss_func
from highlyaccurate_tpu_torch.ops.correlation import grouped_corr, window_sum
from highlyaccurate_tpu_torch.models.vggunet import LEVEL_SLOTS, VGGUnet
from highlyaccurate_tpu_torch.ops.banded_warp import (banded_moments,
                                                      banded_sample,
                                                      default_rb)
from highlyaccurate_tpu_torch.ops.grid_sample import (grid_sample,
                                                      grid_sample_derivs)
from highlyaccurate_tpu_torch.models.nnrefine import NNrefine
from highlyaccurate_tpu_torch.solver.updates import (
    LMConfig, adam_update, lm_information, lm_update, lm_update_from_moments,
    lm_update_implicit, lm_update_implicit_pixel_norm, pose_covariance,
    sgd_update, uniform_draws)
from highlyaccurate_tpu_torch.utils import geo as geo_utils
from highlyaccurate_tpu_torch.utils.device import resolve_device
from highlyaccurate_tpu_torch.utils.profiling import span


def check_supported(cfg: Config):
    """Raise ``NotImplementedError`` for a direction other than S2GP (the
    G2SP model is ``models/lm_g2sp.py``); an ``Optimizer`` KITTI S2GP has
    no update rule for raises ``ValueError``, as the JAX model does."""
    if cfg.direction != "S2GP":
        raise NotImplementedError(
            f"direction={cfg.direction!r} is not the S2GP model's "
            "(build models/lm_g2sp.py's LMG2SP)")
    if cfg.Optimizer not in ("LM", "SGD", "ADAM", "NN"):
        raise ValueError(f"unknown Optimizer {cfg.Optimizer}")


def feature_dtype(cfg: Config) -> torch.dtype:
    """The VGGUnet compute dtype of ``cfg.compute_dtype`` (flax semantics:
    float32 parameters, convs and activations in this dtype)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


def bf16_map(cfg: Config) -> bool:
    """Whether the banded kernels sample a bf16 map: ``banded_bf16_map``,
    implied by bf16 features (JAX ``lm_s2gp.py:89``)."""
    return bool(cfg.banded_bf16_map) or cfg.compute_dtype == "bfloat16"


def banded_project(cfg: Config, sat_feat, uv01, duv01, mask_vw,
                   moments_grd=None, swap: bool = True):
    """Banded line sampling of one per-row-affine projection.

    The kernels want lines with |dy/dx| < 1 (the validity guard of
    ``pack_row_coefs`` drops the rest).  In KITTI S2GP sat-u is the
    near-constant-depth axis, so ground rows trace near-vertical lines in
    the satellite map, and with ``swap`` (the JAX package's only layout) the
    map axes and the uv components are swapped here (kernel x = sat v,
    kernel y = sat u).  ``swap=False`` samples the map as it is (kernel x =
    sat u), for a rig whose ground rows run along sat u (the Ford camera;
    see models/ford.py).  Outputs are the same in either layout.

    Args:
      sat_feat: [B, A, A, C] satellite features (the map dtype for K1;
        float32 for K2, which casts inside its autograd function).
      uv01: [B, V, 2, 2] satellite uv of each row's u = 0, 1 pixels.
      duv01: [B, V, 2, 2, 3] d(uv)/d(pose) at u = 0, 1.
      mask_vw: [V, W] ray mask.
      moments_grd: [B, V, W, C] target rows, or None.
    Returns, with ``moments_grd`` (K1, evaluation): (M [B, V, 3, 16], P0s,
    dPs [B, V, 2, 3]) in kernel axis order.  Without it (K2, training; the
    implicit branch): (out, dx, dy [B, V, W, C], P0, dP [B, V, 2, 3]), with
    dx, dy the sat-u and sat-v derivatives and P0, dP in sat (u, v) order,
    differentiable with respect to sat_feat and uv01.
    """
    A = sat_feat.shape[1]
    RB = default_rb(A)

    def kernel_axes(t, dim):  # sat (u, v) order <-> kernel (x, y) order
        return t.flip(dim) if swap else t

    uvk = kernel_axes(uv01, -1)
    sat_k = sat_feat.transpose(1, 2) if swap else sat_feat  # (y, x) view
    if moments_grd is None:
        out, dkx, dky = banded_sample(sat_k, uvk[:, :, 0], uvk[:, :, 1],
                                      W=mask_vw.shape[1], RB=RB,
                                      bf16_map=bf16_map(cfg))
        du, dv = (dky, dkx) if swap else (dkx, dky)
        P0 = duv01[:, :, 0]                           # [B, V, 2, 3]
        return out, du, dv, P0, duv01[:, :, 1] - P0
    M = banded_moments(sat_k, moments_grd, mask_vw, uvk[:, :, 0],
                       uvk[:, :, 1], RB=RB, bf16_map=bf16_map(cfg))
    P0s = kernel_axes(duv01[:, :, 0], -2)             # [B, V, 2, 3]
    dPs = kernel_axes(duv01[:, :, 1] - duv01[:, :, 0], -2)
    return M, P0s, dPs


def _level_hw(cfg: Config, level_idx: int):
    """Feature map H, W of pyramid slot ``level_idx`` (0 coarse ... 3 fine)."""
    f = 2 ** (3 - level_idx)
    return cfg.grd_h // f, cfg.grd_w // f


def _scaled_default_k(cfg: Config):
    """Reference fixed K (for 1024x256 inputs), rescaled to cfg.grd_{h,w}."""
    k = geom.DEFAULT_CAMERA_K.copy()
    k[0, :] *= cfg.grd_w / 1024.0
    k[1, :] *= cfg.grd_h / 256.0
    return k


def polar_grid(sat_size: int, slot: int, max_radius_m: float = 40.0):
    """Polar satellite -> panorama sampling grid of pyramid slot ``slot``
    (port of JAX ``lm_s2gp.py:189-204``; reference
    models_kitti.py:1518-1541): [A / 2, 8 A, 2] satellite pixel coords,
    numpy float32, A the slot's satellite side."""
    A = sat_size // (2 ** (3 - slot))
    # meters-per-pixel ladder (reference models_kitti.py:637-640), adjusted
    # for non-default sat sizes
    mpp = geo_utils.get_meter_per_pixel() * (
        geo_utils.get_process_satmap_sidelength() / sat_size) * (
        2 ** (3 - slot))
    grd_H, grd_W = A // 2, A * 2
    v, u = np.meshgrid(np.arange(grd_H, dtype=np.float32),
                       np.arange(4 * grd_W, dtype=np.float32), indexing="ij")
    theta = u / grd_W * np.pi * 2
    radius = (1 - v / grd_H) * max_radius_m / mpp
    us = A / 2 + radius * np.cos(np.pi / 4 - theta)
    vs = A / 2 - radius * np.sin(np.pi / 4 - theta)
    return np.stack([us, vs], axis=-1).astype(np.float32)


def precompute_rays(cfg: Config):
    """Host-side per-level ground-plane rays (reference
    models_kitti.py:622-635): [(xyz [H, W, 3], mask [H, W], xyz_w)] * 4,
    the geo projection's, or for any other ``proj`` the polar
    parameterization's with xyz_w None (JAX ``lm_s2gp.py:162-168``)."""
    rays = []
    for lvl in range(4):
        h, w = _level_hw(cfg, lvl)
        if cfg.proj == "geo":
            rays.append(geom.grd_img2cam(h, w, cfg.grd_h, cfg.grd_w,
                                         camera_k=_scaled_default_k(cfg)))
        else:
            rays.append(geom.grd_img2cam_polar(h, w) + (None,))
    return rays


def row_start(cfg: Config, H: int) -> int:
    """The first of H ground rows the solver reads: the sky crop keeps the
    bottom half under the geo projection, and every other ``proj`` keeps
    every row (JAX ``half = H // 2 if cfg.proj == "geo" else 0``)."""
    return H // 2 if cfg.proj == "geo" else 0


def gt_depth_lift(xyz_w, gt_depth, h: int, w: int):
    """The reference's gt-depth lift of one level (JAX ``lm_s2gp.py:
    233-257``): gt_depth [B, H, W] subsampled to h x w by
    ``F.interpolate(mode="nearest")``'s rule, source index floor(i * in /
    out) in float32 (not the half-pixel centre), times the unit-depth rays
    xyz_w [h, w, 3].  Returns xyz [B, h, w, 3] and the mask [B, h, w],
    1.0 where the depth is not -1."""
    H, W = gt_depth.shape[1:3]
    dev = gt_depth.device

    def index(n, size):
        i = np.floor(np.arange(n, dtype=np.float32) * np.float32(size / n))
        return torch.from_numpy(i.astype(np.int64)).to(dev)

    depth = gt_depth.index_select(1, index(h, H)).index_select(
        2, index(w, W))[..., None]
    return xyz_w[None] * depth, (depth[..., 0] != -1).to(torch.float32)


def level_slots(cfg: Config):
    """Map config.level to pyramid slot indices (coarse->fine)."""
    return LEVEL_SLOTS[cfg.level]


def draw_starts(generator, B: int, P: int, device) -> torch.Tensor:
    """The [B, P, 3] uniform [-1, 1) numbers of the multi-start initial
    poses, drawn from the forward's generator before the rounds (JAX draws
    them from ``fold_in(make_rng("lm"), 0x5EED)``, which torch cannot
    reproduce; a test feeds both the same starts through this one
    function)."""
    return uniform_draws(generator, (B, P, 3), device, batch_dim=0)


def multi_starts(generator, B: int, P: int, init_pose, rotation_range,
                 device) -> torch.Tensor:
    """The [B * P, 3] initial poses of the multi-start sweep, sample-major
    (JAX ``multi_hypothesis_test``): hypothesis 0 at zero or at
    ``init_pose`` [B, 3], the others from ``draw_starts``; the heading 0
    where ``rotation_range`` is 0."""
    starts = draw_starts(generator, B, P, device).clone()
    starts[:, 0] = 0.0 if init_pose is None else init_pose.to(torch.float32)
    if rotation_range == 0:
        starts[..., 2] = 0.0
    return starts.reshape(B * P, 3)


def normalized_cost(a, b) -> torch.Tensor:
    """The multi-start score of each sample [N]: the squared distance
    between a and b [N, ...] (already masked to the same support), each
    flattened and divided by its norm floored at 1e-6, in float32."""
    a = a.reshape(a.shape[0], -1).to(torch.float32)
    b = b.reshape(b.shape[0], -1).to(torch.float32)
    na = torch.sqrt(torch.clamp_min((a * a).sum(-1), 1e-12))
    nb = torch.sqrt(torch.clamp_min((b * b).sum(-1), 1e-12))
    return ((a / na[:, None] - b / nb[:, None]) ** 2).sum(-1)


def eval_draws_per_image(cfg: Config, lm_cfg: LMConfig) -> int:
    """How many uniform numbers one image's evaluation forward draws: its
    multi-start initial poses, then two per round of the re-init, each for
    every hypothesis.  Only the LM update of a solve over all three DoF
    with ``reinit``, and Ford's GN update, re-init (and draw); SGD, ADAM
    and NN draw nothing.  ``PresetDraws`` holds that many per image, and
    ``eval_draws_per_batch`` more per batch."""
    P = cfg.pose_hypotheses
    rounds = cfg.N_iters * len(LEVEL_SLOTS[cfg.level])
    reinit = ((cfg.Optimizer == "LM" and lm_cfg.reinit
               and len(lm_cfg.active_dims) == 3) or cfg.Optimizer == "GN")
    return (3 * P if P > 1 else 0) + (2 * P * rounds if reinit else 0)


def eval_draws_per_batch(cfg: Config) -> int:
    """How many uniform numbers an S2GP or Ford evaluation forward draws
    for its dropout, whatever its batch: with ``dropout > 0`` and the LM
    update, one per pixel of a level's kept rows per round
    (``dropout_keep``: one keep-set per round for the batch); else 0.
    Drawn in each round before its re-init numbers.  G2SP drops no
    pixel."""
    if not (cfg.dropout > 0 and cfg.Optimizer == "LM"
            and cfg.direction == "S2GP"):
        return 0
    kept = [(h - row_start(cfg, h)) * w for h, w in
            (_level_hw(cfg, slot) for slot in LEVEL_SLOTS[cfg.level])]
    return cfg.N_iters * sum(kept)


# the span of a solver round at each level index (0 coarse ... L-1 fine)
ROUND_SPANS = tuple(f"hat.solver.round.l{k}" for k in
                    range(max(map(len, LEVEL_SLOTS.values()))))


def round_order(cfg: Config):
    """The (iteration, level index) of each round in the order they run:
    iteration-major, or with ``level_first`` every iteration of a level
    before the next level (JAX ``_run_rounds``).  A round's index t in
    this order is the one ADAM's bias correction reads (JAX
    ``lm_s2gp.py:687-688``)."""
    n_levels = len(LEVEL_SLOTS[cfg.level])
    if cfg.level_first:
        return [(it, lvl) for lvl in range(n_levels)
                for it in range(cfg.N_iters)]
    return [(it, lvl) for it in range(cfg.N_iters)
            for lvl in range(n_levels)]


class S2GPBase(nn.Module):
    """What the KITTI S2GP and Ford models share: two VGGUnet branches, the
    solver rounds over the kept ground rows (``row_start``) on the banded
    kernels or the gather sampler, the forward's mode handling and
    ``project_at_pose``.  A subclass gives the per-slot rays, ``_uv_jac``
    (the satellite uv of ground points and their d(uv)/d(pose)),
    ``_swap``, the kernel layout (``banded_project``'s ``swap``), and
    ``_lifts``, the per-sample rays of a forward that lifts them (KITTI's
    ``gt_depth=``, Ford's estimated depth)."""

    # whether ``using_weight`` takes the rounds off the banded path (KITTI
    # S2GP: the weighted update projects on the gather sampler, JAX
    # lm_s2gp.py:354-358; Ford keeps K2, ford.py:216-224)
    _weight_gathers = True

    def _init_common(self, cfg: Config, lm_cfg: LMConfig, damping_shape,
                     rays, device, gather: bool = False, lift: bool = False,
                     grd_kw=None):
        """The networks (the ground one built with ``grd_kw``; and
        ``NNrefine`` for ``Optimizer="NN"``), the damping, the solver
        settings and, per slot of ``cfg.level``, from ``rays`` (the
        per-slot (xyz [H, W, 3], mask [H, W], xyz_w)) the buffers of the
        kept rows (``row_start``): ``mask_{slot}``, and ``rows01_{slot}``
        (their u = 0, 1 points [V, 2, 3]) for the banded path or
        ``xyz_{slot}`` (every point [V, W, 3]) for the gather path, the
        finest slot's ``xyz`` in any case (the multi-start score and the
        covariance gather there); with ``loss_method > 0`` every row's
        ``rays_{slot}`` and ``raymask_{slot}`` (the rounds of such a
        training forward gather the whole map); with ``lift`` the
        unit-depth rays ``rayw_{slot}`` [H, W, 3] that ``_lifts`` scales.
        ``gather``: the option takes every round off the banded path."""
        self.cfg = cfg
        dev = resolve_device(device)
        self.SatFeatureNet = VGGUnet(cfg.level, feature_dtype(cfg))
        self.GrdFeatureNet = VGGUnet(cfg.level, feature_dtype(cfg),
                                     **(grd_kw or {}))
        self.damping = nn.Parameter(torch.zeros(damping_shape))
        if cfg.Optimizer == "NN":
            self.NNrefine = NNrefine(feature_dtype(cfg))
        self._slots = level_slots(cfg)
        self._rays = rays
        self.lm_cfg = lm_cfg
        self._gather = gather or not cfg.use_banded_warp or (
            bool(cfg.using_weight) and self._weight_gathers)
        for slot in self._slots:
            xyz, mask, xyz_w = rays[slot]
            half = row_start(cfg, xyz.shape[0])
            buffers = {"mask": mask[half:]}
            if not self._gather:
                buffers["rows01"] = xyz[half:, :2]
            if self._gather or slot == self._slots[-1]:
                buffers["xyz"] = xyz[half:]
            if cfg.loss_method > 0:
                buffers.update(rays=xyz, raymask=mask)
            if lift:
                buffers["rayw"] = xyz_w
            for name, a in buffers.items():
                self.register_buffer(f"{name}_{slot}", torch.from_numpy(
                    np.ascontiguousarray(a)), persistent=False)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.damping.device

    def extract_features(self, sat_map, grd_img):
        """(sat_feats, sat_confs, grd_feats, grd_confs[, grd_depths]): the
        depths where the ground branch estimates them."""
        with span("hat.features"):
            return (*self.SatFeatureNet(sat_map),
                    *self.GrdFeatureNet(grd_img))

    def _features(self, sat_map, grd_img, gt_depth=None):
        """The forward's inputs to the rounds: (sat_feats, grd_feats,
        grd_confs, the per-level lifted rays of ``_lifts`` or None)."""
        sat_feats, _, grd_feats, grd_confs, *depths = self.extract_features(
            sat_map, grd_img)
        return (sat_feats, grd_feats, grd_confs,
                self._lifts(depths[0] if depths else gt_depth))

    def _lifts(self, src):
        """Per level, the per-sample rays of every row (xyz [B, H, W, 3],
        mask [B, H, W]) lifted from ``src`` (the forward's ``gt_depth`` or
        the ground branch's depths), or None for the precomputed rays."""
        return None

    def _kept_points(self, slot: int, lift):
        """(points, mask [1|B, V, W]) of the slot's kept rows: the
        precomputed rays [V, W, 3], or the kept rows of a lift."""
        if lift is None:
            return (getattr(self, f"xyz_{slot}"),
                    getattr(self, f"mask_{slot}")[None])
        xyz, mask = lift
        r = row_start(self.cfg, mask.shape[1])
        return xyz[:, r:], mask[:, r:]

    def _all_points(self, slot: int, lift):
        """(points, mask [1|B, H, W]) of every row of the slot (loss
        methods 1-3): the precomputed rays, or the lift."""
        if lift is None:
            return (getattr(self, f"rays_{slot}"),
                    getattr(self, f"raymask_{slot}")[None])
        return lift

    def _uv_jac(self, pose, points, A: int, geo: tuple, jac: bool = True):
        """Satellite uv [B, ..., 2] of ground points [..., 3] at ``pose``
        and, with ``jac``, their d(uv)/d(pose) [B, ..., 2, 3] (else
        None)."""
        raise NotImplementedError

    def _swap(self, geo: tuple) -> bool:
        """The kernel layout of the batch (``banded_project``'s ``swap``)."""
        raise NotImplementedError

    def _tile_geo(self, geo: tuple, P: int) -> tuple:
        """``geo`` for the batch with each sample repeated P times."""
        return geo

    def _line_uv(self, pose, slot: int, A: int, geo: tuple):
        """(uv01 [B, V, 2, 2], duv01 [B, V, 2, 2, 3], swap) of the kept
        rows, projected under the span ``hat.solver.project`` labelled with
        the kernel layout (``swap=0`` or ``swap=1``)."""
        swap = self._swap(geo)
        with span("hat.solver.project", f"swap={int(swap)}"):
            uv01, duv01 = self._uv_jac(pose, getattr(self, f"rows01_{slot}"),
                                       A, geo)
        return uv01, duv01, swap

    def _fused_eval(self, train: bool) -> bool:
        """Whether an evaluation round runs K1 (JAX: the banded implicit
        branch with ``fused_eval``, for the unweighted LM update without
        dropout)."""
        cfg = self.cfg
        return (not train and not self._gather and cfg.Optimizer == "LM"
                and not cfg.using_weight and cfg.dropout == 0
                and bool(cfg.use_implicit_lm)
                and bool(cfg.use_fused_moments))

    # whether the gather path's implicit update is open (Ford's estimated
    # depth closes it, JAX ford.py:198-200)
    _gather_implicit = True

    def _solver_round(self, pose, slot: int, sat_feat, grd_rows, generator,
                      train: bool = False, geo: tuple = (), conf_rows=None,
                      t: int = 0, adam=None, aux=None, lift=None):
        """One (iteration, level) round, the branch the JAX package takes
        for this config (module docstring); returns the new pose.

        sat_feat [B, A, A, C] (the map dtype for K1, else the features'
        own dtype); grd_rows [B, V, W, C] the kept target rows in float32;
        ``geo`` the model's per-call geometry inputs for ``_uv_jac``;
        conf_rows [B, V, W, 1] their confidence, the LM / GN weight with
        ``using_weight``; t the round's index (``round_order``) and adam
        the [m, v] list of ``Optimizer="ADAM"``, updated in place; ``aux``
        a list: the round gathers every ground row (loss methods 1-3) and
        appends its masked projection [B, H, W, C] and uv / A
        [B, H, W, 2]; ``lift`` the level's per-sample rays (``_lifts``),
        which the gather path reads in place of the precomputed ones."""
        cfg = self.cfg
        A = sat_feat.shape[1]
        lm = cfg.Optimizer == "LM"
        implicit = (lm and bool(cfg.use_implicit_lm)
                    and not cfg.using_weight and aux is None)
        with_jac = cfg.Optimizer != "NN"
        if not self._gather and aux is None:
            mask = getattr(self, f"mask_{slot}")
            uv01, duv01, swap = self._line_uv(pose, slot, A, geo)
            if self._fused_eval(train):
                M, P0s, dPs = banded_project(cfg, sat_feat, uv01, duv01,
                                             mask, grd_rows, swap=swap)
                return lm_update_from_moments(pose, M, P0s, dPs,
                                              self.damping, self.lm_cfg,
                                              generator)
            out, du, dv, P0, dP = banded_project(cfg, sat_feat, uv01, duv01,
                                                 mask, swap=swap)
            if implicit:
                return lm_update_implicit(pose, out, du, dv, grd_rows, mask,
                                          P0, dP, self.damping, self.lm_cfg,
                                          generator)
            jac = None
            if with_jac:
                # the row-affine Jacobian materialized: duv = P0 + u * dP
                u = torch.arange(mask.shape[1], dtype=torch.float32,
                                 device=mask.device)
                duv = (P0[:, :, None]
                       + u[None, None, :, None, None] * dP[:, :, None])
                jac = (du[..., None] * duv[:, :, :, None, 0, :]
                       + dv[..., None] * duv[:, :, :, None, 1, :])
            m = mask[None]
        elif implicit and self._gather_implicit:
            points, m = self._kept_points(slot, lift)
            uv, duv = self._uv_jac(pose, points, A, geo)
            out, dx, dy = grid_sample_derivs(sat_feat, uv)
            return lm_update_implicit_pixel_norm(
                pose, out, dx, dy, grd_rows, m, duv, self.damping,
                self.lm_cfg, generator)
        else:
            points, m = (self._kept_points(slot, lift) if aux is None
                         else self._all_points(slot, lift))
            uv, duv = self._uv_jac(pose, points, A, geo, jac=with_jac)
            out, jac = grid_sample(sat_feat, uv, duv)
            if aux is not None:
                # the whole map for the loss, then the sky crop
                aux.append((out * m[..., None], uv * m[..., None] / A))
                V = grd_rows.shape[1]
                out, m = out[:, -V:], m[:, -V:]
                jac = None if jac is None else jac[:, -V:]
        m = m[..., None]
        sat = out * m
        grd = grd_rows * m
        conf = None if conf_rows is None else conf_rows * m
        jac = None if jac is None else jac * m[..., None]
        if lm:
            return lm_update(pose, sat, grd, jac, self.damping, self.lm_cfg,
                             generator, grd_conf=conf)
        if cfg.Optimizer == "NN":
            return pose + self.NNrefine(sat, grd)
        return self._other_update(pose, sat, grd, conf, jac, generator, t,
                                  adam)

    def _other_update(self, pose, sat, grd, conf, jac, generator, t: int,
                      adam):
        """The family's update rules besides LM and NN on the masked,
        sky-cropped samples, target rows, confidence and Jacobian."""
        raise NotImplementedError

    def _run_rounds(self, pose0, sat_feats, grd_feats, generator,
                    train: bool, geo: tuple = (), grd_confs=None,
                    aux=None, lifts=None):
        """The (iteration x level) rounds in ``round_order`` ->
        [B, N_iters, L, 3].  grd_confs: the ground confidence pyramid
        (read with ``using_weight``); ``aux``: a dict of one list per level
        index, which each round of the level fills (``_solver_round``);
        ``lifts``: the per-level per-sample rays (``_lifts``) or None."""
        with span("hat.solver"):
            cfg = self.cfg
            # constant across rounds: K1's map cast (the banded sampler
            # casts inside its autograd function, the gather sampler reads
            # the features in their own dtype), the kept target rows and
            # their confidence, which the updates read in float32 (JAX's K1
            # wrapper casts them too)
            map_dtype = (torch.bfloat16 if bf16_map(cfg)
                         and self._fused_eval(train) else torch.float32)
            sats, grds, confs = [], [], []
            for lvl in range(len(self._slots)):
                sats.append(sat_feats[lvl] if self._gather
                            else sat_feats[lvl].to(map_dtype))
                half = row_start(cfg, grd_feats[lvl].shape[1])
                grds.append(grd_feats[lvl][:, half:].to(torch.float32)
                            .contiguous())
                confs.append(grd_confs[lvl][:, half:].to(torch.float32)
                             if cfg.using_weight else None)
            B, n = pose0.shape[0], len(self.lm_cfg.active_dims)
            adam = [torch.zeros(B, n, device=pose0.device)] * 2
            pose, traj = pose0, []
            for t, (it, lvl) in enumerate(round_order(cfg)):
                with span(ROUND_SPANS[lvl]):
                    pose = self._solver_round(
                        pose, self._slots[lvl], sats[lvl], grds[lvl],
                        generator, train, geo, confs[lvl], t, adam,
                        None if aux is None else aux[lvl],
                        None if lifts is None else lifts[lvl])
                traj.append(pose)
            traj = torch.stack(traj, dim=1)
            L = len(self._slots)
            if cfg.level_first:
                return traj.reshape(B, L, cfg.N_iters, 3).transpose(1, 2)
            return traj.reshape(B, cfg.N_iters, L, 3)

    def hypotheses(self, sat_feats, grd_feats, init_pose, generator,
                   geo: tuple = (), grd_confs=None, lifts=None):
        """The multi-start sweep (JAX ``multi_hypothesis_test`` up to its
        argmin) on the feature pyramids of B samples: ``pose_hypotheses``
        = P initial poses per sample (``multi_starts``) ride the batch axis
        through the rounds of evaluation (K1 at batch B x P on the default
        path), then each final pose is scored by the normalized residual
        of the finest level's kept rows under the ray mask
        (``normalized_cost``).  ``grd_confs``: the ground confidence
        pyramid, which ``using_weight`` reads; ``lifts``: the per-sample
        rays (``_lifts``), repeated P times with the features (JAX tiles
        ``gt_depth``).  Returns the final poses [B, P, 3] and the costs
        [B, P]."""
        cfg = self.cfg
        B, P = sat_feats[0].shape[0], cfg.pose_hypotheses
        pose0 = multi_starts(generator, B, P, init_pose, cfg.rotation_range,
                             self.device)

        def tile(fs):
            return None if fs is None else [f.repeat_interleave(P, 0)
                                            for f in fs]

        sat_t, grd_t, conf_t = tile(sat_feats), tile(grd_feats), \
            tile(grd_confs)
        lifts_t = None if lifts is None else [tuple(tile(l)) for l in lifts]
        geo_t = self._tile_geo(geo, P)
        final = self._run_rounds(pose0, sat_t, grd_t, generator, False,
                                 geo_t, conf_t, lifts=lifts_t)[:, -1, -1]
        # the finest slot's kept pixels gathered at the final poses (JAX
        # _project with with_jac=False, row_start = half), both sides
        # masked
        points, mask = self._kept_points(
            self._slots[-1], None if lifts_t is None else lifts_t[-1])
        uv = self._uv_jac(final, points, sat_t[-1].shape[1], geo_t,
                          jac=False)[0]
        H = grd_t[-1].shape[1]
        mask = mask[..., None]
        cost = normalized_cost(grid_sample(sat_t[-1], uv)[0] * mask,
                               grd_t[-1][:, row_start(cfg, H):] * mask)
        return final.reshape(B, P, 3), cost.reshape(B, P)

    def _pose_info(self, sat_feats, grd_feats, pose, geo: tuple = (),
                   lifts=None):
        """[B, 3, 3] pose covariance (normalized pose order) at ``pose``
        from the solver's Gauss-Newton information (JAX ``_pose_info``):
        the gather sampler's values and derivatives at the finest slot's
        kept pixels, ``lm_information`` with the normalized residual, and
        ``pose_covariance`` over ``active_pose_dims``.  Refuses
        ``using_weight`` with ``ValueError``, as JAX does: that solver
        minimized a weighted residual, whose information this is not."""
        cfg = self.cfg
        if cfg.using_weight:
            raise ValueError("with_info does not support using_weight=1")
        points, mask = self._kept_points(
            self._slots[-1], None if lifts is None else lifts[-1])
        uv, duv = self._uv_jac(pose, points, sat_feats[-1].shape[1], geo)
        out, dx, dy = grid_sample_derivs(sat_feats[-1], uv)
        H = grd_feats[-1].shape[1]
        hess, rss, n_res = lm_information(
            out, dx, dy, grd_feats[-1][:, row_start(cfg, H):], mask, duv,
            cfg.active_pose_dims, normalize=True)
        return pose_covariance(hess, rss, n_res, cfg.active_pose_dims)

    @torch.no_grad()
    def _test(self, sat_map, grd_img, init_pose, generator, with_info: bool,
              geo: tuple = (), gt_depth=None):
        """Mode 'test': the final pose [B, 3] (pose order) of the single
        start or, with ``pose_hypotheses > 1``, of the winning hypothesis;
        with ``with_info`` also its covariance [B, 3, 3], else None."""
        sat_feats, grd_feats, grd_confs, lifts = self._features(
            sat_map, grd_img, gt_depth)
        B = sat_map.shape[0]
        if self.cfg.pose_hypotheses > 1:
            final, cost = self.hypotheses(sat_feats, grd_feats, init_pose,
                                          generator, geo, grd_confs, lifts)
            pose = final[torch.arange(B, device=final.device),
                         cost.argmin(1)]
        else:
            pose0 = (torch.zeros(B, 3, dtype=torch.float32,
                                 device=self.device)
                     if init_pose is None else init_pose.to(torch.float32))
            pose = self._run_rounds(pose0, sat_feats, grd_feats, generator,
                                    False, geo, grd_confs,
                                    lifts=lifts)[:, -1, -1]
        cov = (self._pose_info(sat_feats, grd_feats, pose, geo, lifts)
               if with_info else None)
        return pose, cov

    @torch.no_grad()
    def _project_at_pose(self, sat_map, grd_img, poses, geo: tuple = (),
                         gt_depth=None):
        """Per level (sat_feat, grd_feat, projection at each of ``poses``):
        the satellite features gathered at every ground pixel (all rows)
        by ``grid_sample``, zero where the ray misses the ground (JAX
        ``_project`` with ``with_jac=False``), on the lifted rays of a
        forward that lifts them."""
        sat_feats, grd_feats, _, lifts = self._features(sat_map, grd_img,
                                                        gt_depth)
        outs = []
        for lvl, slot in enumerate(self._slots):
            xyz, mask = (lifts[lvl] if lifts is not None else (
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in self._rays[slot][:2]))
            A = sat_feats[lvl].shape[1]
            proj = [grid_sample(sat_feats[lvl], self._uv_jac(
                pose.to(torch.float32), xyz, A, geo, jac=False)[0])[0]
                * mask[..., None] for pose in poses]
            outs.append((sat_feats[lvl], grd_feats[lvl], *proj))
        return outs

    def _trajectory(self, sat_map, grd_img, mode, init_pose, gt_pose,
                    generator, geo=(), gt_depth=None):
        """Modes 'trajectory' and 'train': checks ``mode``, extracts the
        features and runs the single-start rounds (with autograd only in
        training) -> (the poses [B, N_iters, L, 3], the feature lists of
        loss methods 1-3 or None).  A training forward with
        ``loss_method > 0`` collects every round's projection of the whole
        map and projects each level at ``gt_pose`` (JAX ``lm_s2gp.py:
        798, 832-846``)."""
        if mode not in ("trajectory", "train"):
            raise NotImplementedError(f"mode={mode!r}")
        train = mode == "train"
        if train and gt_pose is None:
            raise ValueError("mode='train' needs gt_pose")
        collect = train and self.cfg.loss_method > 0
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            B = sat_map.shape[0]
            sat_feats, grd_feats, grd_confs, lifts = self._features(
                sat_map, grd_img, gt_depth)
            pose0 = (torch.zeros(B, 3, dtype=torch.float32,
                                 device=self.device)
                     if init_pose is None else init_pose.to(torch.float32))
            aux = {lvl: [] for lvl in range(len(self._slots))} \
                if collect else None
            traj = self._run_rounds(pose0, sat_feats, grd_feats, generator,
                                    train, geo, grd_confs, aux, lifts)
            if not collect:
                return traj, None
            gt = [self._project_gt(sat_feats[lvl], slot, gt_pose, geo,
                                   None if lifts is None else lifts[lvl])
                  for lvl, slot in enumerate(self._slots)]
            lists = dict(ref_feat_list=grd_feats,
                         pred_feat_list=[torch.stack([a[0] for a in aux[l]],
                                                     1) for l in aux],
                         gt_feat_list=[g[0] for g in gt],
                         pred_uv_list=[torch.stack([a[1] for a in aux[l]],
                                                   1) for l in aux],
                         gt_uv_list=[g[1] for g in gt])
            return traj, lists

    def _project_gt(self, sat_feat, slot: int, gt_pose, geo: tuple,
                    lift=None):
        """The satellite features gathered at every ground pixel of the
        slot at ``gt_pose`` [B, 3] (model pose order), zero where the ray
        misses the ground, and the points' uv / A [B, H, W, 2] (zero
        there too)."""
        A = sat_feat.shape[1]
        points, m = self._all_points(slot, lift)
        uv = self._uv_jac(gt_pose.to(torch.float32), points, A, geo,
                          jac=False)[0]
        m = m[..., None]
        return grid_sample(sat_feat, uv)[0] * m, uv * m / A

    def _outputs(self, mode, shift_lats, shift_lons, thetas, gt_lat, gt_lon,
                 gt_theta, lists=None):
        """The outputs of ``mode`` from the [B, N_iters, L] trajectories
        (and, in training, the gt components, each [B], and the feature
        lists of loss methods 1-3)."""
        cfg = self.cfg
        if mode == "trajectory":
            return shift_lats, shift_lons, thetas
        coe_heading = 0.0 if cfg.rotation_range == 0 else cfg.coe_heading
        return loss_func(cfg.loss_method, shift_lats, shift_lons, thetas,
                         gt_lat, gt_lon, gt_theta, cfg.coe_shift_lat,
                         cfg.coe_shift_lon, coe_heading, **(lists or {}),
                         coe_L1=cfg.coe_L1, coe_L2=cfg.coe_L2,
                         coe_L3=cfg.coe_L3, coe_L4=cfg.coe_L4)


class LMS2GP(S2GPBase):
    """Flagship KITTI model, direction S2GP.

    ``state_dict`` keys follow the reference: ``SatFeatureNet.*``,
    ``GrdFeatureNet.*``, ``damping``.
    """

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        check_supported(cfg)
        geo = cfg.proj == "geo"
        # the orien_corr head's polar grids, per slot (JAX lm_s2gp.py:227)
        for slot in level_slots(cfg):
            self.register_buffer(f"polar_{slot}", torch.from_numpy(
                polar_grid(cfg.sat_size, slot)), persistent=False)
        # a projection other than geo and use_gt_depth leave the banded
        # path (JAX lm_s2gp.py:366-367)
        self._init_common(
            cfg, LMConfig(active_dims=cfg.active_pose_dims,
                          train_damping=bool(cfg.train_damping),
                          damping=cfg.damping,
                          use_hessian=bool(cfg.use_hessian),
                          using_weight=bool(cfg.using_weight),
                          dropout=cfg.dropout),
            (1, 3) if cfg.rotation_range > 0 else (), precompute_rays(cfg),
            device, gather=not geo or bool(cfg.use_gt_depth),
            lift=geo and bool(cfg.use_gt_depth))

    def _lifts(self, gt_depth):
        """With ``use_gt_depth`` and a ``gt_depth`` [B, H, W] (-1 where
        unknown), each level's rays lifted by it (``gt_depth_lift``); else
        None, the flat rays (JAX ``_level_rays``)."""
        cfg = self.cfg
        if gt_depth is None or not cfg.use_gt_depth:
            return None
        if cfg.proj != "geo":
            raise ValueError(f"gt_depth= lifts the geo rays; proj="
                             f"{cfg.proj!r} has no unit-depth rays")
        return [gt_depth_lift(getattr(self, f"rayw_{slot}"),
                              gt_depth.to(torch.float32),
                              *_level_hw(cfg, slot))
                for slot in self._slots]

    def _other_update(self, pose, sat, grd, conf, jac, generator, t: int,
                      adam):
        """KITTI's SGD and ADAM steps (JAX ``lm_s2gp.py:457-466``)."""
        cfg = self.cfg
        if cfg.Optimizer == "SGD":
            return sgd_update(pose, sat, grd, jac, self.lm_cfg)
        pose, adam[0], adam[1] = adam_update(pose, sat, grd, jac, *adam, t,
                                             self.lm_cfg, cfg.beta1,
                                             cfg.beta2)
        return pose

    def _uv_jac(self, pose, points, A: int, geo: tuple, jac: bool = True):
        cfg = self.cfg
        ranges = (cfg.rotation_range, cfg.shift_range_lat,
                  cfg.shift_range_lon)
        if jac:
            return geom.s2gp_uv_jac(pose, points, A, *ranges)
        return geom.s2gp_uv(pose, points, A, *ranges), None

    def _swap(self, geo: tuple) -> bool:
        return True

    def forward(self, sat_map, grd_img, mode: str = "test",
                init_pose: Optional[torch.Tensor] = None, *,
                gt_pose: Optional[torch.Tensor] = None,
                generator, with_info: bool = False,
                gt_depth: Optional[torch.Tensor] = None):
        """Feature extraction + unrolled solver.

        sat_map [B, A, A, 3], grd_img [B, H, W, 3] float32 on the model's
        device; init_pose [B, 3] normalized warm start (default zero; with
        ``pose_hypotheses > 1`` hypothesis 0); generator: the
        ``torch.Generator`` (on the model's device) or ``PresetDraws`` of
        the multi-start initial poses, drawn first, then per round of the
        dropout's keep-set and of the out-of-range re-init (LM only);
        gt_depth [B, H, W] the per-pixel depth (-1 unknown), which
        ``use_gt_depth`` lifts the geo rays with (``gt_depth_lift``; any
        H x W; ignored without ``use_gt_depth``).

        mode 'test' -> (shift_lat, shift_lon, theta) each [B], and with
        ``with_info`` their pose covariance [B, 3, 3] (normalized units,
        pose order, zero on frozen DoFs) appended;
        mode 'trajectory' -> the same three, each [B, N_iters, levels]
        (always the single start);
        mode 'train' -> ``LossDiagnostics`` of ``loss_func`` against
        ``gt_pose`` [B, 3] (normalized (shift_u, shift_v, heading)),
        differentiable with respect to the parameters.  Only the two
        evaluation modes run without autograd.
        """
        if mode == "test":
            pose, cov = self._test(sat_map, grd_img, init_pose, generator,
                                   with_info, gt_depth=gt_depth)
            # KITTI: u is longitudinal, v lateral
            out = (pose[:, 1], pose[:, 0], pose[:, 2])
            return out + (cov,) if with_info else out
        traj, lists = self._trajectory(sat_map, grd_img, mode, init_pose,
                                       gt_pose, generator, gt_depth=gt_depth)
        # KITTI: u is longitudinal, v lateral
        gt = (None,) * 3 if gt_pose is None else (
            gt_pose[:, 1].float(), gt_pose[:, 0].float(),
            gt_pose[:, 2].float())
        return self._outputs(mode, traj[..., 1], traj[..., 0], traj[..., 2],
                             *gt, lists)

    def project_at_pose(self, sat_map, grd_img, pred_pose, gt_pose,
                        gt_depth=None):
        """Per-level feature maps for ``--visualize`` PCA dumps (port of JAX
        ``lm_s2gp.py:559``; the reference's in-forward visualization
        inputs, models_kitti.py:1285-1293).

        sat_map [B, A, A, 3], grd_img [B, H, W, 3]; pred_pose, gt_pose
        [B, 3] normalized.  Returns per level (sat_feat [B, A', A', C],
        grd_feat [B, H', W', C], proj_at_pred, proj_at_gt [B, H', W', C]):
        the satellite features projected into every ground pixel at each
        pose by the gather sampler, as in JAX, float32, zero where the ray
        misses the ground; with ``use_gt_depth``, on the rays ``gt_depth``
        lifts (as ``forward``'s).
        """
        return self._project_at_pose(sat_map, grd_img, (pred_pose, gt_pose),
                                     gt_depth=gt_depth)

    def polar_transform(self, sat_feat, slot: int):
        """Polar warp of satellite features (port of JAX
        ``lm_s2gp.py:480-487``; reference models_kitti.py:1494-1516) on
        the gather sampler: sat_feat [B, A, A, C] -> [B, A/2, 8A, C],
        float32 (a bf16 map meets float32 weights)."""
        grid = getattr(self, f"polar_{slot}")
        return grid_sample(sat_feat, grid.expand(sat_feat.shape[0],
                                                 *grid.shape))[0]

    def orien_corr(self, sat_map, grd_img, gt_pose=None, mode: str = "train"):
        """Orientation-only dense correlation head (port of JAX
        ``lm_s2gp.py:489-557``; reference models_kitti.py:1543-1624).

        Each level's ground features, normalized per sample, correlate
        circularly against the polar-warped satellite features over the
        heading candidates within +-rotation_range (``grouped_corr``).
        mode 'test' -> the finest level's argmin heading [B] in degrees,
        (idx - n) * degree_per_pixel; mode 'train' -> the heading triplet
        loss (a scalar) against ``gt_pose`` [B, 3] normalized, summed over
        the levels, differentiable into both feature networks.  The
        features keep their dtype (``compute_dtype``); the polar map is
        float32, so the correlation runs in float32.
        """
        cfg = self.cfg
        sat_feats, _, grd_feats, *_ = self.extract_features(sat_map, grd_img)
        B = sat_map.shape[0]
        corr_list = []
        orien = None
        for lvl, slot in enumerate(self._slots):
            grd_feat = grd_feats[lvl]                     # [B, H, W, C]
            H, W = grd_feat.shape[1:3]
            flat = grd_feat.reshape(B, -1)
            norm = torch.sqrt(torch.clamp_min((flat * flat).sum(-1), 1e-24))
            grd_feat = grd_feat / norm[:, None, None, None]

            polar = self.polar_transform(sat_feats[lvl], slot)  # [B,H,4W',C]
            degree_per_pixel = 90.0 / W
            n = int(np.ceil(cfg.rotation_range / degree_per_pixel))
            sat_W = polar.shape[2]
            # circular padding: n columns before, and after up to W + n
            if sat_W - W < n:
                polar1 = torch.cat([polar[:, :, -n:], polar,
                                    polar[:, :, :(n - sat_W + W)]], dim=2)
            else:
                polar1 = torch.cat([polar[:, :, -n:],
                                    polar[:, :, :(W + n)]], dim=2)
            corr = grouped_corr(polar1, grd_feat)[:, 0]   # [B, L-W+1]
            denom = window_sum((polar1 ** 2).sum(-1), H, W)[:, 0]
            denom = torch.clamp_min(torch.sqrt(denom), 1e-6)
            corr = 2 - 2 * corr / denom
            orien = (torch.argmin(corr, dim=-1) - n) * degree_per_pixel
            corr_list.append((corr, degree_per_pixel))

        if mode != "train":
            return orien
        # heading triplet loss (reference models_kitti.py:1607-1624)
        gt_deg = gt_pose[:, 2].float() * cfg.rotation_range
        rows = torch.arange(B, device=gt_deg.device)
        loss = 0.0
        for corr, dpp in corr_list:
            Wc = corr.shape[1]
            gt_idx = clamped_index((Wc - 1) / 2 + torch.round(gt_deg / dpp), Wc)
            pos_neg = corr[rows, gt_idx][:, None] - corr
            loss = loss + (torch.log1p(torch.exp(pos_neg * 10.0)).sum()
                           / (B * (Wc - 1)))
        return loss
