"""LM_S2GP evaluation and training (port of
``highlyaccurate_tpu/models/lm_s2gp.py:54-143, 146-186, 306-394, 666-855``).

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
                   moments_grd=None):
    """Banded line sampling of one per-row-affine projection.

    Sat-u is the near-constant-depth axis, so ground rows trace near-vertical
    lines in the satellite map; the kernels want |dy/dx| < 1, so the map axes
    and the uv components are swapped here (kernel x = sat v, kernel y =
    sat u).

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
    dx, dy the sat-u and sat-v derivatives (the kernel's y and x) and P0, dP
    in sat (u, v) order, differentiable with respect to sat_feat and uv01.
    """
    A = sat_feat.shape[1]
    RB = default_rb(A)
    uv01s = uv01.flip(-1)
    sat_t = sat_feat.transpose(1, 2)  # view: kernel axes (y, x)
    bf16_map = bool(cfg.banded_bf16_map)
    if moments_grd is None:
        out, dv, du = banded_sample(sat_t, uv01s[:, :, 0], uv01s[:, :, 1],
                                    W=mask_vw.shape[1], RB=RB,
                                    bf16_map=bf16_map)
        P0 = duv01[:, :, 0]                           # [B, V, 2, 3]
        return out, du, dv, P0, duv01[:, :, 1] - P0
    M = banded_moments(sat_t, moments_grd, mask_vw, uv01s[:, :, 0],
                       uv01s[:, :, 1], RB=RB, bf16_map=bf16_map)
    P0s = duv01[:, :, 0].flip(-2)                     # [B, V, 2, 3]
    dPs = (duv01[:, :, 1] - duv01[:, :, 0]).flip(-2)
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


class LMS2GP(nn.Module):
    """Flagship KITTI model, direction S2GP.

    ``state_dict`` keys follow the reference: ``SatFeatureNet.*``,
    ``GrdFeatureNet.*``, ``damping``.
    """

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        self.SatFeatureNet = VGGUnet(cfg.level)
        self.GrdFeatureNet = VGGUnet(cfg.level)
        shape = (1, 3) if cfg.rotation_range > 0 else ()
        self.damping = nn.Parameter(torch.zeros(shape))
        self._slots = level_slots(cfg)
        self.lm_cfg = LMConfig(
            active_dims=cfg.active_pose_dims,
            train_damping=bool(cfg.train_damping), damping=cfg.damping,
            use_hessian=bool(cfg.use_hessian))
        # per-slot rays of the kept (bottom-half) rows: the u = 0, 1 points
        # [V, 2, 3] and the ray mask [V, W]
        rays = precompute_rays(cfg)
        for slot in self._slots:
            xyz, mask, _ = rays[slot]
            half = xyz.shape[0] // 2
            self.register_buffer(f"xyz01_{slot}", torch.from_numpy(
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

    def _solver_round(self, pose, slot: int, sat_feat, grd_rows, generator,
                      train: bool = False):
        """One (iteration, level) round: the fused-eval branch, or with
        ``train`` the differentiable banded implicit branch."""
        cfg = self.cfg
        A = sat_feat.shape[1]
        mask = getattr(self, f"mask_{slot}")
        uv01, duv01 = geom.s2gp_uv_jac(
            pose, getattr(self, f"xyz01_{slot}"), A, cfg.rotation_range,
            cfg.shift_range_lat, cfg.shift_range_lon)
        if train:
            out, dx, dy, P0, dP = banded_project(cfg, sat_feat, uv01, duv01,
                                                 mask)
            return lm_update_implicit(pose, out, dx, dy, grd_rows, mask, P0,
                                      dP, self.damping, self.lm_cfg,
                                      generator)
        M, P0s, dPs = banded_project(cfg, sat_feat, uv01, duv01, mask,
                                     grd_rows)
        return lm_update_from_moments(pose, M, P0s, dPs, self.damping,
                                      self.lm_cfg, generator)

    def _run_rounds(self, pose0, sat_feats, grd_feats, generator,
                    train: bool):
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
                                          generator, train)
                traj.append(pose)
        return torch.stack(traj, dim=1).reshape(pose0.shape[0], cfg.N_iters,
                                                len(self._slots), 3)

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
            return self._forward(sat_map, grd_img, mode, init_pose, gt_pose,
                                 generator)

    def _forward(self, sat_map, grd_img, mode, init_pose, gt_pose, generator):
        cfg = self.cfg
        B = sat_map.shape[0]
        sat_feats, _, grd_feats, _ = self.extract_features(sat_map, grd_img)
        pose0 = (torch.zeros(B, 3, dtype=torch.float32, device=self.device)
                 if init_pose is None else init_pose.to(torch.float32))
        traj = self._run_rounds(pose0, sat_feats, grd_feats, generator,
                                train=mode == "train")
        shift_lats, shift_lons, thetas = traj[..., 1], traj[..., 0], traj[..., 2]
        if mode == "trajectory":
            return shift_lats, shift_lons, thetas
        if mode == "test":
            return (shift_lats[:, -1, -1], shift_lons[:, -1, -1],
                    thetas[:, -1, -1])
        gt = gt_pose.to(torch.float32)
        coe_heading = 0.0 if cfg.rotation_range == 0 else cfg.coe_heading
        return loss_func(cfg.loss_method, shift_lats, shift_lons, thetas,
                         gt[:, 1], gt[:, 0], gt[:, 2], cfg.coe_shift_lat,
                         cfg.coe_shift_lon, coe_heading)
