"""LM_S2GP evaluation and training (port of
``highlyaccurate_tpu/models/lm_s2gp.py:54-143, 146-186, 233-304,
306-470, 559-577, 666-855``), and the base it shares with the Ford model
(``models/ford.py``).

Two VGGUnet branches give the satellite and ground feature pyramids; then
N_iters x levels solver rounds refine the pose, iteration-major.  Only the
bottom half of the ground rows enters the solver (the sky crop).  Each
round takes one of the JAX package's branches (``S2GPBase._solver_round``):

* banded (``use_banded_warp``, the default): ``s2gp_uv_jac`` at ground
  columns u = 0, 1 of each kept row (the row's satellite line is affine in
  u, so two points fix it), then ``banded_project``:
  - evaluation with ``use_fused_moments`` (the default): K1
    (``ops/banded_warp.py:banded_moments``) -> per-row moments ->
    ``lm_update_from_moments``;
  - training, or evaluation with ``use_fused_moments=0``: the
    differentiable sampler K2 / K3 (``banded_sample``) -> out, dx, dy ->
    ``lm_update_implicit``;
  - ``use_implicit_lm=0``: K2's samples with the row-affine Jacobian
    materialized -> ``lm_update``;
* gather (``use_banded_warp=0``, the faithful default of ``--test 1
  --import_pth``): ``s2gp_uv_jac`` at every pixel of the kept rows, the
  gather sampler (``ops/grid_sample.py``) on the features in their own
  dtype, then ``lm_update_implicit_pixel_norm`` or, with
  ``use_implicit_lm=0``, ``lm_update`` on the materialized Jacobian.

Evaluation (mode ``"test"``) can also run the multi-start sweep
(``pose_hypotheses > 1``, ``S2GPBase.hypotheses``: every hypothesis rides
the batch axis through the same rounds, so K1 launches at batch B x P, and
the one with the smallest normalized finest-level residual wins) and, with
``with_info``, return the pose covariance of the solution
(``S2GPBase._pose_info``: one gather projection at the finest level and
``lm_information`` / ``pose_covariance``; no hand kernel).

Training scores the trajectory with ``loss_func`` method 0.  The
satellite map goes to the banded kernels as a transposed view (kernel y =
sat u, kernel x = sat v).  K1 reads a map cast once per forward to the map
dtype, since it does not change across rounds; K2 casts inside its
autograd function, so the map gradient stays float32.  With
``compute_dtype="bfloat16"`` the features are bf16 (``VGGUnet``), the
banded map is bf16 as ``banded_bf16_map`` makes it, and the target rows are
read in float32, as in JAX.

``check_supported`` refuses every option this port does not carry yet with
``NotImplementedError``; ``loss_method`` other than 0 is refused when a
training forward is called.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.geometry import kitti as geom
from highlyaccurate_tpu_torch.losses.losses import loss_func
from highlyaccurate_tpu_torch.models.vggunet import LEVEL_SLOTS, VGGUnet
from highlyaccurate_tpu_torch.ops.banded_warp import (banded_moments,
                                                      banded_sample,
                                                      default_rb)
from highlyaccurate_tpu_torch.ops.grid_sample import (grid_sample,
                                                      grid_sample_derivs)
from highlyaccurate_tpu_torch.solver.updates import (
    LMConfig, lm_information, lm_update, lm_update_from_moments,
    lm_update_implicit, lm_update_implicit_pixel_norm, pose_covariance,
    uniform_draws)
from highlyaccurate_tpu_torch.utils.device import resolve_device


def check_supported(cfg: Config):
    """Raise ``NotImplementedError`` naming the first option of ``cfg`` that
    this port does not carry yet."""
    refused = [
        (cfg.direction != "S2GP", f"direction={cfg.direction!r}"),
        (cfg.proj != "geo", f"proj={cfg.proj!r}"),
        (cfg.Optimizer != "LM", f"Optimizer={cfg.Optimizer!r}"),
        (bool(cfg.using_weight), "using_weight"),
        (bool(cfg.use_gt_depth), "use_gt_depth"),
        (cfg.dropout > 0, "dropout > 0"),
        (bool(cfg.level_first), "level_first"),
    ]
    for bad, name in refused:
        if bad:
            raise NotImplementedError(
                f"{name} is not supported by highlyaccurate_tpu_torch yet "
                "(it carries KITTI S2GP geo LM evaluation and training)")


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


def precompute_rays(cfg: Config):
    """Host-side per-level ground-plane rays (reference
    models_kitti.py:622-635): [(xyz [H, W, 3], mask [H, W], xyz_w)] * 4."""
    rays = []
    for lvl in range(4):
        h, w = _level_hw(cfg, lvl)
        rays.append(geom.grd_img2cam(h, w, cfg.grd_h, cfg.grd_w,
                                     camera_k=_scaled_default_k(cfg)))
    return rays


def level_slots(cfg: Config):
    """Map config.level to pyramid slot indices (coarse->fine)."""
    return LEVEL_SLOTS[cfg.level]


def draw_starts(generator, B: int, P: int, device) -> torch.Tensor:
    """The [B, P, 3] uniform [-1, 1) numbers of the multi-start initial
    poses, drawn from the forward's generator before the rounds (JAX draws
    them from ``fold_in(make_rng("lm"), 0x5EED)``, which torch cannot
    reproduce; a test feeds both the same starts through this one
    function)."""
    return uniform_draws(generator, (B, P, 3), device)


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
    multi-start initial poses, then two per round of the re-init (only a
    solve over all three DoF with ``reinit`` draws), each for every
    hypothesis.  ``PresetDraws`` holds that many per image."""
    P = cfg.pose_hypotheses
    rounds = cfg.N_iters * len(LEVEL_SLOTS[cfg.level])
    reinit = lm_cfg.reinit and len(lm_cfg.active_dims) == 3
    return (3 * P if P > 1 else 0) + (2 * P * rounds if reinit else 0)


class S2GPBase(nn.Module):
    """What the KITTI S2GP and Ford models share: two VGGUnet branches, the
    solver rounds over the bottom half of the ground rows on the banded
    kernels or the gather sampler, the forward's mode handling and
    ``project_at_pose``.  A subclass gives the per-slot rays, ``_uv_jac``
    (the satellite uv of ground points and their d(uv)/d(pose)) and
    ``_swap``, the kernel layout (``banded_project``'s ``swap``)."""

    def _init_common(self, cfg: Config, lm_cfg: LMConfig, damping_shape,
                     rays, device):
        """The networks, the damping, the solver settings and, per slot of
        ``cfg.level``, from ``rays`` (the per-slot (xyz [H, W, 3], mask
        [H, W], ...)) the buffers of the kept rows: ``mask_{slot}``, and
        ``rows01_{slot}`` (their u = 0, 1 points [V, 2, 3]) for the banded
        path or ``xyz_{slot}`` (every point [V, W, 3]) for the gather
        path, and the finest slot's ``xyz`` in any case (the multi-start
        score and the covariance gather there)."""
        self.cfg = cfg
        dev = resolve_device(device)
        self.SatFeatureNet = VGGUnet(cfg.level, feature_dtype(cfg))
        self.GrdFeatureNet = VGGUnet(cfg.level, feature_dtype(cfg))
        self.damping = nn.Parameter(torch.zeros(damping_shape))
        self._slots = level_slots(cfg)
        self._rays = rays
        self.lm_cfg = lm_cfg
        for slot in self._slots:
            xyz, mask = rays[slot][:2]
            half = xyz.shape[0] // 2
            buffers = {"mask": mask[half:]}
            if cfg.use_banded_warp:
                buffers["rows01"] = xyz[half:, :2]
            if not cfg.use_banded_warp or slot == self._slots[-1]:
                buffers["xyz"] = xyz[half:]
            for name, a in buffers.items():
                self.register_buffer(f"{name}_{slot}", torch.from_numpy(
                    np.ascontiguousarray(a)), persistent=False)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.damping.device

    def extract_features(self, sat_map, grd_img):
        sat_feats, sat_confs = self.SatFeatureNet(sat_map)
        grd_feats, grd_confs = self.GrdFeatureNet(grd_img)
        return sat_feats, sat_confs, grd_feats, grd_confs

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
        rows."""
        uv01, duv01 = self._uv_jac(pose, getattr(self, f"rows01_{slot}"), A,
                                   geo)
        return uv01, duv01, self._swap(geo)

    def _fused_eval(self, train: bool) -> bool:
        """Whether an evaluation round runs K1 (JAX: the banded implicit
        branch with ``fused_eval``)."""
        cfg = self.cfg
        return (not train and bool(cfg.use_banded_warp)
                and bool(cfg.use_implicit_lm) and bool(cfg.use_fused_moments))

    def _solver_round(self, pose, slot: int, sat_feat, grd_rows, generator,
                      train: bool = False, geo: tuple = ()):
        """One (iteration, level) round, the branch the JAX package takes
        for this config (module docstring).  sat_feat [B, A, A, C] (the map
        dtype for K1, else the features' own dtype); grd_rows [B, V, W, C]
        the kept target rows in float32; ``geo`` holds the model's per-call
        geometry inputs for ``_uv_jac``."""
        cfg = self.cfg
        mask = getattr(self, f"mask_{slot}")
        A = sat_feat.shape[1]
        if not cfg.use_banded_warp:
            uv, duv = self._uv_jac(pose, getattr(self, f"xyz_{slot}"), A,
                                   geo)
            if cfg.use_implicit_lm:
                out, dx, dy = grid_sample_derivs(sat_feat, uv)
                return lm_update_implicit_pixel_norm(
                    pose, out, dx, dy, grd_rows, mask[None], duv,
                    self.damping, self.lm_cfg, generator)
            out, jac = grid_sample(sat_feat, uv, duv)
            return self._lm_update(pose, out, jac, grd_rows, mask, generator)
        uv01, duv01, swap = self._line_uv(pose, slot, A, geo)
        if self._fused_eval(train):
            M, P0s, dPs = banded_project(cfg, sat_feat, uv01, duv01, mask,
                                         grd_rows, swap=swap)
            return lm_update_from_moments(pose, M, P0s, dPs, self.damping,
                                          self.lm_cfg, generator)
        out, du, dv, P0, dP = banded_project(cfg, sat_feat, uv01, duv01,
                                             mask, swap=swap)
        if cfg.use_implicit_lm:
            return lm_update_implicit(pose, out, du, dv, grd_rows, mask, P0,
                                      dP, self.damping, self.lm_cfg,
                                      generator)
        # the row-affine Jacobian materialized: duv(v, u) = P0 + u * dP
        u = torch.arange(mask.shape[1], dtype=torch.float32,
                         device=mask.device)
        duv = P0[:, :, None] + u[None, None, :, None, None] * dP[:, :, None]
        jac = (du[..., None] * duv[:, :, :, None, 0, :]
               + dv[..., None] * duv[:, :, :, None, 1, :])
        return self._lm_update(pose, out, jac, grd_rows, mask, generator)

    def _lm_update(self, pose, out, jac, grd_rows, mask, generator):
        """``lm_update`` on samples, target rows and Jacobian under the ray
        mask [V, W] (JAX: the projection masks all three)."""
        m = mask[None, :, :, None]
        return lm_update(pose, out * m, grd_rows * m, jac * m[..., None],
                         self.damping, self.lm_cfg, generator)

    def _run_rounds(self, pose0, sat_feats, grd_feats, generator,
                    train: bool, geo: tuple = ()):
        """Iteration-first (iteration x level) loop -> [B, N_iters, L, 3]."""
        cfg = self.cfg
        # constant across rounds: K1's map cast (the banded sampler casts
        # inside its autograd function, the gather sampler reads the
        # features in their own dtype) and the kept target rows, which the
        # updates read in float32 (JAX's K1 wrapper casts them too)
        map_dtype = (torch.bfloat16 if bf16_map(cfg)
                     and self._fused_eval(train) else torch.float32)
        sats, grds = [], []
        for lvl in range(len(self._slots)):
            sats.append(sat_feats[lvl] if not cfg.use_banded_warp
                        else sat_feats[lvl].to(map_dtype))
            H = grd_feats[lvl].shape[1]
            grds.append(grd_feats[lvl][:, H // 2:].to(torch.float32)
                        .contiguous())
        pose, traj = pose0, []
        for _ in range(cfg.N_iters):
            for lvl, slot in enumerate(self._slots):
                pose = self._solver_round(pose, slot, sats[lvl], grds[lvl],
                                          generator, train, geo)
                traj.append(pose)
        return torch.stack(traj, dim=1).reshape(pose0.shape[0], cfg.N_iters,
                                                len(self._slots), 3)

    def hypotheses(self, sat_feats, grd_feats, init_pose, generator,
                   geo: tuple = ()):
        """The multi-start sweep (JAX ``multi_hypothesis_test`` up to its
        argmin) on the feature pyramids of B samples: ``pose_hypotheses``
        = P initial poses per sample (``multi_starts``) ride the batch axis
        through the rounds of evaluation (K1 at batch B x P on the default
        path), then each final pose is scored by the normalized residual
        of the finest level's kept rows under the ray mask
        (``normalized_cost``).  Returns the final poses [B, P, 3] and the
        costs [B, P]."""
        cfg = self.cfg
        B, P = sat_feats[0].shape[0], cfg.pose_hypotheses
        pose0 = multi_starts(generator, B, P, init_pose, cfg.rotation_range,
                             self.device)
        sat_t = [f.repeat_interleave(P, 0) for f in sat_feats]
        grd_t = [f.repeat_interleave(P, 0) for f in grd_feats]
        geo_t = self._tile_geo(geo, P)
        final = self._run_rounds(pose0, sat_t, grd_t, generator, False,
                                 geo_t)[:, -1, -1]
        # the finest slot's kept pixels gathered at the final poses (JAX
        # _project with with_jac=False, row_start = H/2), both sides masked
        slot = self._slots[-1]
        uv = self._uv_jac(final, getattr(self, f"xyz_{slot}"),
                          sat_t[-1].shape[1], geo_t, jac=False)[0]
        mask = getattr(self, f"mask_{slot}")[:, :, None]
        H = grd_t[-1].shape[1]
        cost = normalized_cost(grid_sample(sat_t[-1], uv)[0] * mask,
                               grd_t[-1][:, H // 2:] * mask)
        return final.reshape(B, P, 3), cost.reshape(B, P)

    def _pose_info(self, sat_feats, grd_feats, pose, geo: tuple = ()):
        """[B, 3, 3] pose covariance (normalized pose order) at ``pose``
        from the solver's Gauss-Newton information (JAX ``_pose_info``):
        the gather sampler's values and derivatives at the finest slot's
        kept pixels, ``lm_information`` with the normalized residual, and
        ``pose_covariance`` over ``active_pose_dims``."""
        cfg = self.cfg
        slot = self._slots[-1]
        uv, duv = self._uv_jac(pose, getattr(self, f"xyz_{slot}"),
                               sat_feats[-1].shape[1], geo)
        out, dx, dy = grid_sample_derivs(sat_feats[-1], uv)
        H = grd_feats[-1].shape[1]
        hess, rss, n_res = lm_information(
            out, dx, dy, grd_feats[-1][:, H // 2:],
            getattr(self, f"mask_{slot}")[None], duv, cfg.active_pose_dims,
            normalize=True)
        return pose_covariance(hess, rss, n_res, cfg.active_pose_dims)

    @torch.no_grad()
    def _test(self, sat_map, grd_img, init_pose, generator, with_info: bool,
              geo: tuple = ()):
        """Mode 'test': the final pose [B, 3] (pose order) of the single
        start or, with ``pose_hypotheses > 1``, of the winning hypothesis;
        with ``with_info`` also its covariance [B, 3, 3], else None."""
        sat_feats, _, grd_feats, _ = self.extract_features(sat_map, grd_img)
        B = sat_map.shape[0]
        if self.cfg.pose_hypotheses > 1:
            final, cost = self.hypotheses(sat_feats, grd_feats, init_pose,
                                          generator, geo)
            pose = final[torch.arange(B, device=final.device),
                         cost.argmin(1)]
        else:
            pose0 = (torch.zeros(B, 3, dtype=torch.float32,
                                 device=self.device)
                     if init_pose is None else init_pose.to(torch.float32))
            pose = self._run_rounds(pose0, sat_feats, grd_feats, generator,
                                    False, geo)[:, -1, -1]
        cov = (self._pose_info(sat_feats, grd_feats, pose, geo)
               if with_info else None)
        return pose, cov

    @torch.no_grad()
    def _project_at_pose(self, sat_map, grd_img, poses, geo: tuple = ()):
        """Per level (sat_feat, grd_feat, projection at each of ``poses``):
        the satellite features gathered at every ground pixel (all rows)
        by ``grid_sample``, zero where the ray misses the ground (JAX
        ``_project`` with ``with_jac=False``)."""
        sat_feats, _, grd_feats, _ = self.extract_features(sat_map, grd_img)
        outs = []
        for lvl, slot in enumerate(self._slots):
            xyz, mask = (torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device) for a in self._rays[slot][:2])
            A = sat_feats[lvl].shape[1]
            proj = [grid_sample(sat_feats[lvl], self._uv_jac(
                pose.to(torch.float32), xyz, A, geo, jac=False)[0])[0]
                * mask[None, :, :, None] for pose in poses]
            outs.append((sat_feats[lvl], grd_feats[lvl], *proj))
        return outs

    def _trajectory(self, sat_map, grd_img, mode, init_pose, gt_pose,
                    generator, geo=()):
        """Modes 'trajectory' and 'train': checks ``mode``, extracts the
        features and runs the single-start rounds (with autograd only in
        training) -> the poses [B, N_iters, L, 3]."""
        if mode not in ("trajectory", "train"):
            raise NotImplementedError(f"mode={mode!r}")
        train = mode == "train"
        if train and self.cfg.loss_method != 0:
            raise NotImplementedError(
                f"loss_method={self.cfg.loss_method} is not supported by "
                "highlyaccurate_tpu_torch yet (training carries method 0)")
        if train and gt_pose is None:
            raise ValueError("mode='train' needs gt_pose")
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            B = sat_map.shape[0]
            sat_feats, _, grd_feats, _ = self.extract_features(sat_map,
                                                               grd_img)
            pose0 = (torch.zeros(B, 3, dtype=torch.float32,
                                 device=self.device)
                     if init_pose is None else init_pose.to(torch.float32))
            return self._run_rounds(pose0, sat_feats, grd_feats, generator,
                                    train, geo)

    def _outputs(self, mode, shift_lats, shift_lons, thetas, gt_lat, gt_lon,
                 gt_theta):
        """The outputs of ``mode`` from the [B, N_iters, L] trajectories
        (and, in training, the gt components, each [B])."""
        cfg = self.cfg
        if mode == "trajectory":
            return shift_lats, shift_lons, thetas
        coe_heading = 0.0 if cfg.rotation_range == 0 else cfg.coe_heading
        return loss_func(cfg.loss_method, shift_lats, shift_lons, thetas,
                         gt_lat, gt_lon, gt_theta, cfg.coe_shift_lat,
                         cfg.coe_shift_lon, coe_heading)


class LMS2GP(S2GPBase):
    """Flagship KITTI model, direction S2GP.

    ``state_dict`` keys follow the reference: ``SatFeatureNet.*``,
    ``GrdFeatureNet.*``, ``damping``.
    """

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        check_supported(cfg)
        self._init_common(
            cfg, LMConfig(active_dims=cfg.active_pose_dims,
                          train_damping=bool(cfg.train_damping),
                          damping=cfg.damping,
                          use_hessian=bool(cfg.use_hessian)),
            (1, 3) if cfg.rotation_range > 0 else (), precompute_rays(cfg),
            device)

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
                generator, with_info: bool = False):
        """Feature extraction + unrolled solver.

        sat_map [B, A, A, 3], grd_img [B, H, W, 3] float32 on the model's
        device; init_pose [B, 3] normalized warm start (default zero; with
        ``pose_hypotheses > 1`` hypothesis 0); generator: the
        ``torch.Generator`` (on the model's device) or ``PresetDraws`` of
        the multi-start initial poses, drawn first, and of the
        out-of-range re-init draw, which every round makes.

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
                                   with_info)
            # KITTI: u is longitudinal, v lateral
            out = (pose[:, 1], pose[:, 0], pose[:, 2])
            return out + (cov,) if with_info else out
        traj = self._trajectory(sat_map, grd_img, mode, init_pose, gt_pose,
                                generator)
        # KITTI: u is longitudinal, v lateral
        gt = (None,) * 3 if gt_pose is None else (
            gt_pose[:, 1].float(), gt_pose[:, 0].float(),
            gt_pose[:, 2].float())
        return self._outputs(mode, traj[..., 1], traj[..., 0], traj[..., 2],
                             *gt)

    def project_at_pose(self, sat_map, grd_img, pred_pose, gt_pose):
        """Per-level feature maps for ``--visualize`` PCA dumps (port of JAX
        ``lm_s2gp.py:559``; the reference's in-forward visualization
        inputs, models_kitti.py:1285-1293).

        sat_map [B, A, A, 3], grd_img [B, H, W, 3]; pred_pose, gt_pose
        [B, 3] normalized.  Returns per level (sat_feat [B, A', A', C],
        grd_feat [B, H', W', C], proj_at_pred, proj_at_gt [B, H', W', C]):
        the satellite features projected into every ground pixel at each
        pose by the gather sampler, as in JAX, float32, zero where the ray
        misses the ground.
        """
        return self._project_at_pose(sat_map, grd_img, (pred_pose, gt_pose))
