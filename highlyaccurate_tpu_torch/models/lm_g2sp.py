"""LM_G2SP evaluation and training (port of
``highlyaccurate_tpu/models/lm_g2sp.py:44-88, 112-162, 206-262, 402-482``).

Two VGGUnet branches give the satellite and ground feature pyramids; then
N_iters x levels solver rounds refine the pose, iteration-major.  G2SP
projects the *ground* features into the satellite grid: each satellite
column j >= j0 (``g2sp_inview_col_start``; the columns west of it never see
the camera) is one line, and its samples u are the satellite rows.  Each
round runs ``g2sp_P`` on the line's first two ground points, packs the
projective-line coefficients (``pack_projline_coefs``), samples the ground
map with K4 (out, dx, dy [B, V, W, C] in line order: V satellite columns,
W = A satellite rows), takes the per-pixel d(uv)/d(pose) from
``g2sp_uv_jac`` and solves ``lm_update_implicit_pixel`` against the
satellite features of those columns (residual grd_proj - sat, no feature
normalization, no re-init, damping used raw).  Evaluation samples a bf16
copy of each ground map made once per forward; with ``g2sp_pixel_moments``
it runs K6 instead of K4, which contracts the samples with the target into
five moments per pixel, and solves ``lm_update_pixel_moments`` (JAX
``lm_g2sp.py:235-255``).  Training keeps K4 whatever that flag says: it
goes through the differentiable sampler (K4 with dxy forward, K5
backward), whose bf16 cast sits inside the autograd function, and
``loss_func`` method 0 scores the trajectory.

The samples stay in line order; the satellite target is passed as a
transposed view of the same columns, made once per level per forward
(outside the rounds), so nothing is copied to sat-grid order: K6 takes the
view's strides.

``check_supported`` refuses every option this port does not carry for G2SP
with ``NotImplementedError``; ``loss_method`` other than 0 raises
``ValueError`` in training, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.geometry import kitti as geom
from highlyaccurate_tpu_torch.losses.losses import loss_func
from highlyaccurate_tpu_torch.models.lm_s2gp import _level_hw
from highlyaccurate_tpu_torch.models.vggunet import LEVEL_SLOTS, VGGUnet
from highlyaccurate_tpu_torch.ops.projline import (pack_projline_coefs,
                                                   projline_pixmom,
                                                   projline_sample,
                                                   projline_sample_forward,
                                                   projline_supported)
from highlyaccurate_tpu_torch.solver.updates import (LMConfig,
                                                     lm_update_implicit_pixel,
                                                     lm_update_pixel_moments)
from highlyaccurate_tpu_torch.utils.device import resolve_device

SLOT_CHANNELS = (256, 128, 64, 16)  # VGGUnet feature channels per slot


def check_supported(cfg: Config):
    """Raise ``NotImplementedError`` naming the first option of a G2SP
    ``cfg`` that this port does not carry yet."""
    refused = [
        (cfg.direction != "G2SP", f"direction={cfg.direction!r}"),
        (cfg.proj != "geo", f"proj={cfg.proj!r}"),
        (cfg.Optimizer != "LM", f"Optimizer={cfg.Optimizer!r}"),
        (bool(cfg.using_weight), "using_weight"),
        (not cfg.banded_bf16_map, "banded_bf16_map=0"),
        (not cfg.use_banded_warp, "use_banded_warp=0"),
        (cfg.pose_hypotheses > 1, "pose_hypotheses > 1"),
        (cfg.compute_dtype != "float32",
         f"compute_dtype={cfg.compute_dtype!r}"),
    ]
    for bad, name in refused:
        if bad:
            raise NotImplementedError(
                f"{name} is not supported by highlyaccurate_tpu_torch for "
                "G2SP yet (it carries KITTI G2SP geo LM evaluation and "
                "training on the projective-line sampler)")
    for slot in LEVEL_SLOTS[cfg.level]:
        Hg, Wg = _level_hw(cfg, slot)
        if not projline_supported(Hg, Wg, SLOT_CHANNELS[slot]):
            raise NotImplementedError(
                f"direction='G2SP' at level={cfg.level}: the "
                f"{Hg}x{Wg}x{SLOT_CHANNELS[slot]} "
                f"ground map of slot {slot} needs the gather sampler "
                "(ops/grid_sample.py), which highlyaccurate_tpu_torch does "
                "not carry yet")


class LMG2SP(nn.Module):
    """KITTI model, direction G2SP.

    ``state_dict`` keys follow the reference: ``SatFeatureNet.*``,
    ``GrdFeatureNet.*``, ``damping`` [1, 3].
    """

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        self.SatFeatureNet = VGGUnet(cfg.level)
        self.GrdFeatureNet = VGGUnet(cfg.level)
        # raw damping, initialised at cfg.damping (reference
        # models_kitti.py:41); used only with train_damping
        self.damping = nn.Parameter(torch.full((1, 3), float(cfg.damping)))
        self._slots = LEVEL_SLOTS[cfg.level]
        self.lm_cfg = LMConfig(
            active_dims=(0, 1, 2), train_damping=bool(cfg.train_damping),
            damping=cfg.damping, use_hessian=False, reinit=False,
            raw_damping=True)
        # per slot: the first satellite column j0 and the ground points of
        # the kept columns in line order [V, A, 4]; rows 0 and 1 fix each
        # line (its points are affine in the row index)
        self._col_start = {}
        for slot in self._slots:
            A = cfg.sat_size >> (3 - slot)
            Hg, Wg = _level_hw(cfg, slot)
            j0 = (geom.g2sp_inview_col_start(
                A, Hg, Wg, cfg.rotation_range, cfg.shift_range_lat,
                cfg.shift_range_lon) if cfg.g2sp_restrict_grid else 0)
            xyz1 = geom.warp_sat2real(A)[:, j0:]          # [A(i), V(j), 4]
            self._col_start[slot] = j0
            self.register_buffer(f"lines_{slot}", torch.from_numpy(
                np.ascontiguousarray(xyz1.transpose(1, 0, 2))),
                persistent=False)
            self.register_buffer(f"x0_{slot}", torch.from_numpy(
                np.ascontiguousarray(xyz1[0])), persistent=False)
            self.register_buffer(f"dx_{slot}", torch.from_numpy(
                np.ascontiguousarray(xyz1[1] - xyz1[0])), persistent=False)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.damping.device

    def extract_features(self, sat_map, grd_img):
        sat_feats, sat_confs = self.SatFeatureNet(sat_map)
        grd_feats, grd_confs = self.GrdFeatureNet(grd_img)
        return sat_feats, sat_confs, grd_feats, grd_confs

    def corr(self, *args, **kwargs):
        raise NotImplementedError(
            "the corr head (dense correlation, soft_margin_triplet) needs "
            "the gather projection, which highlyaccurate_tpu_torch does not "
            "carry yet")

    def _solver_round(self, pose, slot: int, grd_map, target, camera_k,
                      train: bool = False):
        """One (iteration, level) round on the projective-line sampler.

        grd_map [B, Hg, Wg, C] ground features (bf16 in evaluation, float32
        in training); target [B, V, A, C] the satellite features of the
        kept columns in line order (a view); camera_k [B, 3, 3] raw K.
        """
        cfg = self.cfg
        Hg, Wg = grd_map.shape[1:3]
        A = target.shape[2]
        ranges = (cfg.rotation_range, cfg.shift_range_lat,
                  cfg.shift_range_lon)
        P = geom.g2sp_P(pose, camera_k, Hg, Wg, cfg.grd_h, cfg.grd_w,
                        *ranges)                          # [B, 3, 4]

        def project(X):  # [V, 4] -> [B, V, 3]
            return (P[:, None, :, :] * X[None, :, None, :]).sum(-1)

        coefs = pack_projline_coefs(project(getattr(self, f"x0_{slot}")),
                                    project(getattr(self, f"dx_{slot}")),
                                    Hg, Wg, Hg, A)
        _, duv, _ = geom.g2sp_uv_jac(pose, getattr(self, f"lines_{slot}"),
                                     camera_k, Hg, Wg, cfg.grd_h, cfg.grd_w,
                                     *ranges)             # [B, V, A, 2, 3]
        if not train and cfg.g2sp_pixel_moments:
            pm = projline_pixmom(grd_map, target, coefs, A)  # [B, V, A, 5]
            return lm_update_pixel_moments(pose, pm, duv, self.damping,
                                           self.lm_cfg)
        if train:
            out, dx, dy = projline_sample(grd_map, coefs, W=A)
        else:
            out, dx, dy = projline_sample_forward(grd_map, coefs, A,
                                                  with_dxy=False)
        return lm_update_implicit_pixel(pose, out, dx, dy, target, duv,
                                        self.damping, self.lm_cfg)

    def _run_rounds(self, pose0, sat_feats, grd_feats, camera_k,
                    train: bool):
        """Iteration-first (iteration x level) loop -> [B, N_iters, L, 3]."""
        cfg = self.cfg
        maps, targets = [], []
        for lvl, slot in enumerate(self._slots):
            # constant across rounds: the eval map cast and the targets
            maps.append(grd_feats[lvl] if train
                        else grd_feats[lvl].to(torch.bfloat16))
            j0 = self._col_start[slot]
            targets.append(sat_feats[lvl][:, :, j0:].transpose(1, 2))
        pose, traj = pose0, []
        for _ in range(cfg.N_iters):
            for lvl, slot in enumerate(self._slots):
                pose = self._solver_round(pose, slot, maps[lvl],
                                          targets[lvl], camera_k, train)
                traj.append(pose)
        return torch.stack(traj, dim=1).reshape(pose0.shape[0], cfg.N_iters,
                                                len(self._slots), 3)

    def forward(self, sat_map, grd_img, camera_k, mode: str = "test",
                init_pose: Optional[torch.Tensor] = None, *,
                gt_pose: Optional[torch.Tensor] = None):
        """Feature extraction + unrolled solver.

        sat_map [B, A, A, 3], grd_img [B, H, W, 3] float32 and camera_k
        [B, 3, 3] (the intrinsics of the grd_h x grd_w input) on the
        model's device; init_pose [B, 3] normalized warm start (default
        zero).  G2SP has no re-init, so no generator.

        mode 'test' -> (shift_lat, shift_lon, theta) each [B];
        mode 'trajectory' -> the same three, each [B, N_iters, levels];
        mode 'train' -> ``LossDiagnostics`` of ``loss_func`` against
        ``gt_pose`` [B, 3], differentiable with respect to the parameters.
        Only the two evaluation modes run without autograd.
        """
        if mode not in ("test", "trajectory", "train"):
            raise NotImplementedError(f"mode={mode!r}")
        train = mode == "train"
        if train and self.cfg.loss_method != 0:
            raise ValueError(
                "G2SP supports loss_method 0 only (the reference passes None "
                "feature dicts for G2SP, models_kitti.py:488-492)")
        if train and gt_pose is None:
            raise ValueError("mode='train' needs gt_pose")
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            return self._forward(sat_map, grd_img, camera_k, mode, init_pose,
                                 gt_pose)

    def _forward(self, sat_map, grd_img, camera_k, mode, init_pose, gt_pose):
        cfg = self.cfg
        B = sat_map.shape[0]
        sat_feats, _, grd_feats, _ = self.extract_features(sat_map, grd_img)
        pose0 = (torch.zeros(B, 3, dtype=torch.float32, device=self.device)
                 if init_pose is None else init_pose.to(torch.float32))
        traj = self._run_rounds(pose0, sat_feats, grd_feats,
                                camera_k.to(torch.float32),
                                train=mode == "train")
        shift_lats, shift_lons, thetas = traj[..., 1], traj[..., 0], traj[..., 2]
        if mode == "trajectory":
            return shift_lats, shift_lons, thetas
        if mode == "test":
            return (shift_lats[:, -1, -1], shift_lons[:, -1, -1],
                    thetas[:, -1, -1])
        gt = gt_pose.to(torch.float32)
        return loss_func(cfg.loss_method, shift_lats, shift_lons, thetas,
                         gt[:, 1], gt[:, 0], gt[:, 2], cfg.coe_shift_lat,
                         cfg.coe_shift_lon, cfg.coe_heading)
