"""LM_S2GP evaluation and training (port of
``highlyaccurate_tpu/models/lm_s2gp.py:54-143, 146-186, 306-394, 666-855``),
and the base it shares with the Ford model (``models/ford.py``).

Two VGGUnet branches give the satellite and ground feature pyramids; then
N_iters x levels solver rounds refine the pose, iteration-major.  Each round
runs ``s2gp_uv_jac`` at ground columns u = 0, 1 of each kept row (the row's
satellite line is affine in u, so two points fix it), then one of two
branches of the JAX package:

* evaluation (fused-eval): ``banded_project`` with target rows runs K1
  (``ops/banded_warp.py:banded_moments``) -> per-row moments ->
  ``lm_update_from_moments``;
* training (banded implicit): ``banded_project`` without them runs the
  differentiable sampler K2 / K3 (``banded_sample``) -> out, dx, dy ->
  ``lm_update_implicit``; ``loss_func`` method 0 scores the trajectory.

Only the bottom half of the ground rows is sampled (the sky crop).  The
satellite map goes to the kernels as a transposed view (kernel y = sat u,
kernel x = sat v).  Evaluation casts it to the map dtype once per forward,
since it does not change across rounds; training casts it inside the
autograd function, so its gradient stays float32.

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
from highlyaccurate_tpu_torch.solver.updates import (LMConfig,
                                                     lm_update_from_moments,
                                                     lm_update_implicit)
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
        (cfg.pose_hypotheses > 1, "pose_hypotheses > 1"),
        (not cfg.use_fused_moments, "use_fused_moments=0"),
        (not cfg.use_banded_warp, "use_banded_warp=0"),
        (not cfg.use_implicit_lm, "use_implicit_lm=0"),
        (cfg.compute_dtype != "float32",
         f"compute_dtype={cfg.compute_dtype!r}"),
    ]
    for bad, name in refused:
        if bad:
            raise NotImplementedError(
                f"{name} is not supported by highlyaccurate_tpu_torch yet "
                "(this slice carries KITTI S2GP geo LM evaluation and "
                "training)")


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
    bf16_map = bool(cfg.banded_bf16_map)
    if moments_grd is None:
        out, dkx, dky = banded_sample(sat_k, uvk[:, :, 0], uvk[:, :, 1],
                                      W=mask_vw.shape[1], RB=RB,
                                      bf16_map=bf16_map)
        du, dv = (dky, dkx) if swap else (dkx, dky)
        P0 = duv01[:, :, 0]                           # [B, V, 2, 3]
        return out, du, dv, P0, duv01[:, :, 1] - P0
    M = banded_moments(sat_k, moments_grd, mask_vw, uvk[:, :, 0],
                       uvk[:, :, 1], RB=RB, bf16_map=bf16_map)
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


class BandedS2GPBase(nn.Module):
    """What the KITTI S2GP and Ford models share: two VGGUnet branches, the
    per-row-affine solver rounds on K1 (evaluation) or K2 / K3 (training)
    over the bottom half of the ground rows, and the forward's mode
    handling.  A subclass gives the per-slot rays and ``_line_uv``, the
    satellite uv of each kept row's u = 0, 1 pixels, their d(uv)/d(pose)
    and the kernel layout (``banded_project``'s ``swap``)."""

    def _init_common(self, cfg: Config, lm_cfg: LMConfig, damping_shape,
                     rays, device):
        """The networks, the damping, the solver settings and, per slot of
        ``cfg.level``, the buffers ``rows01_{slot}`` (the u = 0, 1 points
        [V, 2, 3] of the kept rows) and ``mask_{slot}`` from ``rays``, the
        per-slot (xyz [H, W, 3], mask [H, W], ...)."""
        self.cfg = cfg
        dev = resolve_device(device)
        self.SatFeatureNet = VGGUnet(cfg.level)
        self.GrdFeatureNet = VGGUnet(cfg.level)
        self.damping = nn.Parameter(torch.zeros(damping_shape))
        self._slots = level_slots(cfg)
        self.lm_cfg = lm_cfg
        for slot in self._slots:
            xyz, mask = rays[slot][:2]
            half = xyz.shape[0] // 2
            self.register_buffer(f"rows01_{slot}", torch.from_numpy(
                np.ascontiguousarray(xyz[half:, :2])), persistent=False)
            self.register_buffer(f"mask_{slot}", torch.from_numpy(
                np.ascontiguousarray(mask[half:])), persistent=False)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.damping.device

    def extract_features(self, sat_map, grd_img):
        sat_feats, sat_confs = self.SatFeatureNet(sat_map)
        grd_feats, grd_confs = self.GrdFeatureNet(grd_img)
        return sat_feats, sat_confs, grd_feats, grd_confs

    def _line_uv(self, pose, slot: int, A: int, geo: tuple):
        """(uv01 [B, V, 2, 2], duv01 [B, V, 2, 2, 3], swap) of the kept
        rows."""
        raise NotImplementedError

    def _solver_round(self, pose, slot: int, sat_feat, grd_rows, generator,
                      train: bool = False, geo: tuple = ()):
        """One (iteration, level) round: the fused-eval branch, or with
        ``train`` the differentiable banded implicit branch.  ``geo`` holds
        the model's per-call geometry inputs for ``_line_uv``."""
        cfg = self.cfg
        mask = getattr(self, f"mask_{slot}")
        uv01, duv01, swap = self._line_uv(pose, slot, sat_feat.shape[1], geo)
        if train:
            out, dx, dy, P0, dP = banded_project(cfg, sat_feat, uv01, duv01,
                                                 mask, swap=swap)
            return lm_update_implicit(pose, out, dx, dy, grd_rows, mask, P0,
                                      dP, self.damping, self.lm_cfg,
                                      generator)
        M, P0s, dPs = banded_project(cfg, sat_feat, uv01, duv01, mask,
                                     grd_rows, swap=swap)
        return lm_update_from_moments(pose, M, P0s, dPs, self.damping,
                                      self.lm_cfg, generator)

    def _run_rounds(self, pose0, sat_feats, grd_feats, generator,
                    train: bool, geo: tuple = ()):
        """Iteration-first (iteration x level) loop -> [B, N_iters, L, 3]."""
        cfg = self.cfg
        map_dtype = (torch.bfloat16 if cfg.banded_bf16_map and not train
                     else torch.float32)
        sats, grds = [], []
        for lvl in range(len(self._slots)):
            # constant across rounds: the map cast and the kept target rows
            sats.append(sat_feats[lvl].to(map_dtype))
            H = grd_feats[lvl].shape[1]
            grds.append(grd_feats[lvl][:, H // 2:].contiguous())
        pose, traj = pose0, []
        for _ in range(cfg.N_iters):
            for lvl, slot in enumerate(self._slots):
                pose = self._solver_round(pose, slot, sats[lvl], grds[lvl],
                                          generator, train, geo)
                traj.append(pose)
        return torch.stack(traj, dim=1).reshape(pose0.shape[0], cfg.N_iters,
                                                len(self._slots), 3)

    def _trajectory(self, sat_map, grd_img, mode, init_pose, gt_pose,
                    generator, geo=()):
        """Checks ``mode``, extracts the features and runs the rounds (with
        autograd only in training) -> the poses [B, N_iters, L, 3]."""
        if mode not in ("test", "trajectory", "train"):
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
        if mode == "test":
            return (shift_lats[:, -1, -1], shift_lons[:, -1, -1],
                    thetas[:, -1, -1])
        coe_heading = 0.0 if cfg.rotation_range == 0 else cfg.coe_heading
        return loss_func(cfg.loss_method, shift_lats, shift_lons, thetas,
                         gt_lat, gt_lon, gt_theta, cfg.coe_shift_lat,
                         cfg.coe_shift_lon, coe_heading)


class LMS2GP(BandedS2GPBase):
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

    def _line_uv(self, pose, slot: int, A: int, geo: tuple):
        cfg = self.cfg
        uv01, duv01 = geom.s2gp_uv_jac(
            pose, getattr(self, f"rows01_{slot}"), A, cfg.rotation_range,
            cfg.shift_range_lat, cfg.shift_range_lon)
        return uv01, duv01, True

    def forward(self, sat_map, grd_img, mode: str = "test",
                init_pose: Optional[torch.Tensor] = None, *,
                gt_pose: Optional[torch.Tensor] = None,
                generator: torch.Generator):
        """Feature extraction + unrolled solver.

        sat_map [B, A, A, 3], grd_img [B, H, W, 3] float32 on the model's
        device; init_pose [B, 3] normalized warm start (default zero);
        generator: the ``torch.Generator`` (on the model's device) of the
        out-of-range re-init draw, which every round makes.

        mode 'test' -> (shift_lat, shift_lon, theta) each [B];
        mode 'trajectory' -> the same three, each [B, N_iters, levels];
        mode 'train' -> ``LossDiagnostics`` of ``loss_func`` against
        ``gt_pose`` [B, 3] (normalized (shift_u, shift_v, heading)),
        differentiable with respect to the parameters.  Only the two
        evaluation modes run without autograd.
        """
        traj = self._trajectory(sat_map, grd_img, mode, init_pose, gt_pose,
                                generator)
        # KITTI: u is longitudinal, v lateral
        gt = (None,) * 3 if gt_pose is None else (
            gt_pose[:, 1].float(), gt_pose[:, 0].float(),
            gt_pose[:, 2].float())
        return self._outputs(mode, traj[..., 1], traj[..., 0], traj[..., 2],
                             *gt)
