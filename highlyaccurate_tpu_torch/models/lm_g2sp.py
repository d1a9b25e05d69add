"""LM_G2SP evaluation and training (port of
``highlyaccurate_tpu/models/lm_g2sp.py:44-162, 206-293, 366-482``).

Two VGGUnet branches give the satellite and ground feature pyramids; then
N_iters x levels solver rounds refine the pose, iteration-major.  G2SP
projects the *ground* features into the satellite grid: each satellite
column j >= j0 (``g2sp_inview_col_start``; the columns west of it never see
the camera) is one line, and its samples u are the satellite rows.  Each
slot takes one of two samplers, chosen per slot as JAX chooses per level
(``level_round``, :244-293):

* the projective-line kernels, where the banded path is on
  (``use_banded_warp`` and ``banded_bf16_map``) and ``projline_supported``
  takes the slot's ground map: each round runs ``g2sp_P`` on the line's
  first two ground points, packs the projective-line coefficients
  (``pack_projline_coefs``), samples the ground map with K4 (out, dx, dy
  [B, V, W, C] in line order: V satellite columns, W = A satellite rows),
  takes the per-pixel d(uv)/d(pose) from ``g2sp_uv_jac`` and solves
  ``lm_update_implicit_pixel`` against the satellite features of those
  columns (residual grd_proj - sat, no feature normalization, no re-init,
  damping used raw).  Evaluation samples a bf16 copy of each ground map
  made once per forward (a no-op under bf16 features,
  ``compute_dtype="bfloat16"``); with ``g2sp_pixel_moments`` it runs K6
  instead of K4, which contracts the samples with the target into five
  moments per pixel, and solves ``lm_update_pixel_moments``.  Training
  keeps K4 whatever that flag says: it goes through the differentiable
  sampler (K4 with dxy forward, K5 backward), whose bf16 cast sits inside
  the autograd function;
* the gather sampler (``ops/grid_sample.py``) everywhere else, on the
  ground map in its own dtype: ``g2sp_uv_jac`` at the same points, then
  ``grid_sample_derivs`` and ``lm_update_implicit_pixel``, or with
  ``use_implicit_lm=0`` the whole satellite grid (no column restriction,
  as in JAX ``_project_grd_to_map``) through ``grid_sample`` with the
  Jacobian and ``lm_update`` without normalization.  A 32-row ground
  input, whose coarse map has 4 rows, mixes the two within one forward.

G2SP has one update rule, LM: ``using_weight`` and every other
``Optimizer`` leave both fast paths (``fast_paths``, JAX
``lm_g2sp.py:230-234, 263-264``) for that last branch, the gather
``lm_update`` on the whole grid, weighted with ``using_weight`` by the
ground confidence projected with the features.  Dropout and
``level_first`` change nothing in G2SP, as in JAX.

The projection options leave the projective-line kernels, as in JAX
(``lm_g2sp.py:230``): ``proj="polar"`` keeps ``g2sp_uv_jac`` on the gather
path without the column restriction (j0 = 0); ``proj="nn"`` builds the
ground branch with VGGUnet's G2S re-layout (``g2s_rearrange``: each ground
map [H, W] becomes [2H, W/2], the satellite grid's size when 2 * grd_h ==
sat == grd_w / 2) and samples it with the in-plane SE(2) warp
``inplane_uv_jac`` over the whole satellite grid, in the rounds, the
multi-start score and the covariance.

Evaluation (mode ``"test"``) can also run the multi-start sweep
(``pose_hypotheses > 1``, ``LMG2SP.hypotheses``: the hypotheses ride the
batch axis through the same per-slot samplers, then the normalized
finest-level residual over the shared valid support picks one) and, with
``with_info``, return the covariance of the solution (``_pose_info``: the
gather sampler over the whole finest satellite grid, unnormalized
residual, all-ones mask; no hand kernel).  Both score through
``_project_grd_to_map``, the gather projection of JAX ``:90``.

Training scores the trajectory with ``loss_func`` method 0.  The samples
stay in line order; the satellite target is passed as a transposed view of
the same columns, made once per level per forward (outside the rounds), so
nothing is copied to sat-grid order: K6 takes the view's strides.

``check_supported`` refuses a direction other than G2SP with
``NotImplementedError``; ``loss_method`` other than 0 raises ``ValueError``
in training, as in the JAX package, and ``corr`` (the correlation head)
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.geometry import kitti as geom
from highlyaccurate_tpu_torch.losses.losses import loss_func
from highlyaccurate_tpu_torch.models.lm_s2gp import (_level_hw,
                                                    feature_dtype,
                                                    multi_starts,
                                                    normalized_cost)
from highlyaccurate_tpu_torch.models.vggunet import LEVEL_SLOTS, VGGUnet
from highlyaccurate_tpu_torch.ops.grid_sample import (grid_sample,
                                                      grid_sample_derivs)
from highlyaccurate_tpu_torch.ops.projline import (pack_projline_coefs,
                                                   projline_pixmom,
                                                   projline_sample,
                                                   projline_sample_forward,
                                                   projline_supported)
from highlyaccurate_tpu_torch.solver.updates import (LMConfig,
                                                     lm_information,
                                                     lm_update,
                                                     lm_update_implicit_pixel,
                                                     lm_update_pixel_moments,
                                                     pose_covariance)
from highlyaccurate_tpu_torch.utils.device import resolve_device

SLOT_CHANNELS = (256, 128, 64, 16)  # VGGUnet feature channels per slot


def check_supported(cfg: Config):
    """Raise ``NotImplementedError`` for a direction other than G2SP (the
    S2GP model is ``models/lm_s2gp.py``)."""
    if cfg.direction != "G2SP":
        raise NotImplementedError(
            f"direction={cfg.direction!r} is not the G2SP model's "
            "(build models/lm_s2gp.py's LMS2GP)")


def fast_paths(cfg: Config) -> bool:
    """Whether the rounds may take the fast paths (the projective-line
    kernels, the gather path's implicit update): only the unweighted LM
    update (JAX ``lm_g2sp.py:230-234, 263-264``).  G2SP has no other update
    rule: ``using_weight`` and any other ``Optimizer`` run the gather
    ``lm_update`` on the whole satellite grid."""
    return cfg.Optimizer == "LM" and not cfg.using_weight


def projline_slots(cfg: Config) -> dict:
    """Per slot of ``cfg.level``, whether its rounds run the
    projective-line kernels (else the gather sampler): the banded path is
    on, the fast paths are open (``fast_paths``) and ``projline_supported``
    takes the slot's ground map (JAX ``lm_g2sp.py:230-249``)."""
    banded = (cfg.proj == "geo" and bool(cfg.use_banded_warp)
              and bool(cfg.banded_bf16_map) and fast_paths(cfg))
    return {slot: banded and projline_supported(
        *_level_hw(cfg, slot), SLOT_CHANNELS[slot])
        for slot in LEVEL_SLOTS[cfg.level]}


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
        self.SatFeatureNet = VGGUnet(cfg.level, feature_dtype(cfg))
        # proj="nn" samples the re-laid-out ground maps (JAX lm_g2sp.py:56)
        self._nn = cfg.proj == "nn"
        self.GrdFeatureNet = VGGUnet(cfg.level, feature_dtype(cfg),
                                     g2s_rearrange=self._nn)
        # raw damping, initialised at cfg.damping (reference
        # models_kitti.py:41); used only with train_damping
        self.damping = nn.Parameter(torch.full((1, 3), float(cfg.damping)))
        self._slots = LEVEL_SLOTS[cfg.level]
        self.lm_cfg = LMConfig(
            active_dims=(0, 1, 2), train_damping=bool(cfg.train_damping),
            damping=cfg.damping, use_hessian=False, reinit=False,
            raw_damping=True, normalize=False,
            using_weight=bool(cfg.using_weight))
        self._projline = projline_slots(cfg)
        self._implicit = bool(cfg.use_implicit_lm) and fast_paths(cfg)
        # per slot: the first satellite column j0 (the restriction is the
        # geo projection's, JAX lm_g2sp.py:80) and the ground points of the
        # kept columns in line order [V, A, 4]; rows 0 and 1 fix each
        # line (its points are affine in the row index); with
        # use_implicit_lm=0 a gather slot's whole grid [A, A, 4], which the
        # finest slot keeps in any case (multi-start score, covariance);
        # proj="nn" projects no ground points (inplane_uv_jac)
        self._col_start = {}
        for slot in self._slots:
            A = cfg.sat_size >> (3 - slot)
            Hg, Wg = _level_hw(cfg, slot)
            j0 = (geom.g2sp_inview_col_start(
                A, Hg, Wg, cfg.rotation_range, cfg.shift_range_lat,
                cfg.shift_range_lon)
                if cfg.g2sp_restrict_grid and cfg.proj == "geo" else 0)
            xyz1 = geom.warp_sat2real(A)[:, j0:]          # [A(i), V(j), 4]
            self._col_start[slot] = j0
            self.register_buffer(f"lines_{slot}", torch.from_numpy(
                np.ascontiguousarray(xyz1.transpose(1, 0, 2))),
                persistent=False)
            self.register_buffer(f"x0_{slot}", torch.from_numpy(
                np.ascontiguousarray(xyz1[0])), persistent=False)
            self.register_buffer(f"dx_{slot}", torch.from_numpy(
                np.ascontiguousarray(xyz1[1] - xyz1[0])), persistent=False)
            if (not (self._projline[slot] or self._implicit)
                    or slot == self._slots[-1]):
                self.register_buffer(f"grid_{slot}", torch.from_numpy(
                    geom.warp_sat2real(A)), persistent=False)
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
            "the corr head (dense correlation, soft_margin_triplet) is not "
            "supported by highlyaccurate_tpu_torch yet")

    def _solver_round(self, pose, slot: int, grd_map, target, camera_k,
                      train: bool = False, conf=None):
        """One (iteration, level) round on the slot's sampler.

        grd_map [B, Hg, Wg, C] ground features (bf16 in a projective-line
        evaluation, else in their own dtype); target the satellite
        features in float32: of the kept columns in line order [B, V, A, C]
        (a view), or on a gather slot without the fast paths
        (``use_implicit_lm=0``, ``using_weight``, another ``Optimizer``) the
        whole grid [B, A, A, C]; camera_k [B, 3, 3] raw K; conf
        [B, Hg, Wg, 1] the ground confidence, projected with the features
        as the weight of ``using_weight`` (JAX ``lm_g2sp.py:286-292``).
        """
        cfg = self.cfg
        Hg, Wg = grd_map.shape[1:3]
        A = target.shape[2]
        ranges = self._ranges()
        if not self._projline[slot]:
            if not self._implicit:
                uv, duv, _ = self._grid_uv_jac(pose, slot, camera_k, Hg, Wg)
                g_proj, jac = grid_sample(grd_map, uv, duv)
                c_proj = (grid_sample(conf, uv)[0] if cfg.using_weight
                          else None)
                return lm_update(pose, g_proj, target, jac, self.damping,
                                 self.lm_cfg, None, grd_conf=c_proj)
            if self._nn:   # the whole satellite grid, in its own order
                uv, duv, _ = geom.inplane_uv_jac(pose, A, *ranges)
            else:
                uv, duv, _ = geom.g2sp_uv_jac(
                    pose, getattr(self, f"lines_{slot}"), camera_k, Hg, Wg,
                    cfg.grd_h, cfg.grd_w, *ranges)        # [B, V, A, ...]
            out, dx, dy = grid_sample_derivs(grd_map, uv)
            return lm_update_implicit_pixel(pose, out, dx, dy, target, duv,
                                            self.damping, self.lm_cfg)
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

    def _ranges(self):
        cfg = self.cfg
        return (cfg.rotation_range, cfg.shift_range_lat, cfg.shift_range_lon)

    def _grid_uv_jac(self, pose, slot: int, camera_k, Hg: int, Wg: int):
        """(uv, duv, mask) of every satellite pixel of the slot's grid
        (JAX ``_project_grd_to_map``): ``g2sp_uv_jac`` on its ground
        points, or with ``proj="nn"`` the in-plane warp."""
        cfg = self.cfg
        if self._nn:
            return geom.inplane_uv_jac(pose, cfg.sat_size >> (3 - slot),
                                       *self._ranges())
        return geom.g2sp_uv_jac(pose, getattr(self, f"grid_{slot}"),
                                camera_k, Hg, Wg, cfg.grd_h, cfg.grd_w,
                                *self._ranges())

    def _project_grd_to_map(self, grd_feat, pose, camera_k):
        """The ground features [B, A, A, C] of the finest slot gathered at
        every satellite pixel of its grid at ``pose`` (no column
        restriction), and the in-front mask [B, A, A] (port of JAX
        ``_project_grd_to_map`` with ``with_jac=False``)."""
        Hg, Wg = grd_feat.shape[1:3]
        uv, _, mask = self._grid_uv_jac(pose, self._slots[-1], camera_k, Hg,
                                        Wg)
        return grid_sample(grd_feat, uv)[0], mask

    def hypotheses(self, sat_feats, grd_feats, camera_k, init_pose,
                   generator, grd_confs=None):
        """The multi-start sweep (JAX ``_multi_hypothesis_from_feats`` up
        to its argmin) on the feature pyramids of B samples:
        ``pose_hypotheses`` = P initial poses per sample
        (``multi_starts``) ride the batch axis through the evaluation
        rounds, each slot on its own sampler (K4, K6 or the gather path,
        as a single start), then each final pose is scored by the
        normalized residual of the finest level, the projected ground
        features against the satellite features under the in-front mask
        (``normalized_cost``).  camera_k [B, 3, 3]; grd_confs the ground
        confidence pyramid (read with ``using_weight``).  Returns the
        final poses [B, P, 3] and the costs [B, P]."""
        cfg = self.cfg
        B, P = camera_k.shape[0], cfg.pose_hypotheses
        pose0 = multi_starts(generator, B, P, init_pose, cfg.rotation_range,
                             self.device)
        sat_t = [f.repeat_interleave(P, 0) for f in sat_feats]
        grd_t = [f.repeat_interleave(P, 0) for f in grd_feats]
        conf_t = (None if grd_confs is None
                  else [c.repeat_interleave(P, 0) for c in grd_confs])
        k_t = camera_k.repeat_interleave(P, 0)
        final = self._run_rounds(pose0, sat_t, grd_t, k_t, train=False,
                                 grd_confs=conf_t)[:, -1, -1]
        g_proj, m = self._project_grd_to_map(grd_t[-1], final, k_t)
        cost = normalized_cost(g_proj, sat_t[-1] * m[..., None])
        return final.reshape(B, P, 3), cost.reshape(B, P)

    def _pose_info(self, sat_feats, grd_feats, pose, camera_k):
        """[B, 3, 3] pose covariance (normalized pose order) at ``pose``
        from the G2SP objective's Gauss-Newton information (JAX
        ``_pose_info``): the gather sampler's values and derivatives over
        the whole finest satellite grid, the unnormalized residual
        grd_proj - sat with an all-ones mask, all three DoF.  Refuses
        ``using_weight`` with ``ValueError``, as JAX does."""
        cfg = self.cfg
        if cfg.using_weight:
            raise ValueError("with_info does not support using_weight=1")
        A = sat_feats[-1].shape[1]
        Hg, Wg = grd_feats[-1].shape[1:3]
        uv, duv, _ = self._grid_uv_jac(pose, self._slots[-1], camera_k, Hg,
                                       Wg)
        out, dx, dy = grid_sample_derivs(grd_feats[-1], uv)
        ones = torch.ones(1, A, A, dtype=torch.float32, device=self.device)
        hess, rss, n_res = lm_information(out, dx, dy, sat_feats[-1], ones,
                                          duv, (0, 1, 2), normalize=False)
        return pose_covariance(hess, rss, n_res, (0, 1, 2))

    def _run_rounds(self, pose0, sat_feats, grd_feats, camera_k,
                    train: bool, grd_confs=None):
        """Iteration-first (iteration x level) loop -> [B, N_iters, L, 3]
        (G2SP has no ``level_first``, as in JAX); grd_confs: the ground
        confidence pyramid, read with ``using_weight``."""
        cfg = self.cfg
        maps, targets = [], []
        for lvl, slot in enumerate(self._slots):
            # constant across rounds: the projective-line eval map cast and
            # the targets, read in float32 (a no-op unless the features are
            # bf16)
            projline = self._projline[slot]
            maps.append(grd_feats[lvl].to(torch.bfloat16)
                        if projline and not train else grd_feats[lvl])
            sat = sat_feats[lvl].to(torch.float32)
            j0 = self._col_start[slot]
            targets.append(sat[:, :, j0:].transpose(1, 2)
                           if projline or (self._implicit and not self._nn)
                           else sat)
        pose, traj = pose0, []
        for _ in range(cfg.N_iters):
            for lvl, slot in enumerate(self._slots):
                pose = self._solver_round(
                    pose, slot, maps[lvl], targets[lvl], camera_k, train,
                    grd_confs[lvl] if cfg.using_weight else None)
                traj.append(pose)
        return torch.stack(traj, dim=1).reshape(pose0.shape[0], cfg.N_iters,
                                                len(self._slots), 3)

    def forward(self, sat_map, grd_img, camera_k, mode: str = "test",
                init_pose: Optional[torch.Tensor] = None, *,
                gt_pose: Optional[torch.Tensor] = None, generator=None,
                with_info: bool = False):
        """Feature extraction + unrolled solver.

        sat_map [B, A, A, 3], grd_img [B, H, W, 3] float32 and camera_k
        [B, 3, 3] (the intrinsics of the grd_h x grd_w input) on the
        model's device; init_pose [B, 3] normalized warm start (default
        zero; hypothesis 0 of a multi-start sweep).  G2SP has no re-init:
        the ``generator`` (``torch.Generator`` or ``PresetDraws``) serves
        only the multi-start initial poses of ``pose_hypotheses > 1``.

        mode 'test' -> (shift_lat, shift_lon, theta) each [B], and with
        ``with_info`` their pose covariance [B, 3, 3] (normalized, pose
        order) appended;
        mode 'trajectory' -> the same three, each [B, N_iters, levels];
        mode 'train' -> ``LossDiagnostics`` of ``loss_func`` against
        ``gt_pose`` [B, 3], differentiable with respect to the parameters.
        Only the two evaluation modes run without autograd.
        """
        if mode == "test":
            pose, cov = self._test(sat_map, grd_img, camera_k, init_pose,
                                   generator, with_info)
            out = (pose[:, 1], pose[:, 0], pose[:, 2])
            return out + (cov,) if with_info else out
        if mode not in ("trajectory", "train"):
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

    @torch.no_grad()
    def _test(self, sat_map, grd_img, camera_k, init_pose, generator,
              with_info: bool):
        """Mode 'test': the final pose [B, 3] (pose order) of the single
        start or, with ``pose_hypotheses > 1``, of the winning hypothesis;
        with ``with_info`` also its covariance [B, 3, 3], else None."""
        B = sat_map.shape[0]
        camera_k = camera_k.to(torch.float32)
        sat_feats, _, grd_feats, grd_confs = self.extract_features(sat_map,
                                                                   grd_img)
        if self.cfg.pose_hypotheses > 1:
            final, cost = self.hypotheses(sat_feats, grd_feats, camera_k,
                                          init_pose, generator, grd_confs)
            pose = final[torch.arange(B, device=final.device),
                         cost.argmin(1)]
        else:
            pose0 = (torch.zeros(B, 3, dtype=torch.float32,
                                 device=self.device)
                     if init_pose is None else init_pose.to(torch.float32))
            pose = self._run_rounds(pose0, sat_feats, grd_feats, camera_k,
                                    train=False,
                                    grd_confs=grd_confs)[:, -1, -1]
        cov = (self._pose_info(sat_feats, grd_feats, pose, camera_k)
               if with_info else None)
        return pose, cov

    def _forward(self, sat_map, grd_img, camera_k, mode, init_pose, gt_pose):
        cfg = self.cfg
        B = sat_map.shape[0]
        sat_feats, _, grd_feats, grd_confs = self.extract_features(sat_map,
                                                                   grd_img)
        pose0 = (torch.zeros(B, 3, dtype=torch.float32, device=self.device)
                 if init_pose is None else init_pose.to(torch.float32))
        traj = self._run_rounds(pose0, sat_feats, grd_feats,
                                camera_k.to(torch.float32),
                                train=mode == "train", grd_confs=grd_confs)
        shift_lats, shift_lons, thetas = traj[..., 1], traj[..., 0], traj[..., 2]
        if mode == "trajectory":
            return shift_lats, shift_lons, thetas
        gt = gt_pose.to(torch.float32)
        return loss_func(cfg.loss_method, shift_lats, shift_lons, thetas,
                         gt[:, 1], gt[:, 0], gt[:, 2], cfg.coe_shift_lat,
                         cfg.coe_shift_lon, cfg.coe_heading)
