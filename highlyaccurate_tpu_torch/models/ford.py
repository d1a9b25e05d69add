"""LM_S2GP_Ford evaluation and training (port of the banded LM paths of
``highlyaccurate_tpu/models/ford.py:40-99, 132-197, 453-529``).

The Ford model is KITTI's S2GP with the Ford camera chain
(``geometry/ford.py``): each round runs ``ford_uv_jac`` with the per-sample
camera extrinsics R_FL [B, 3, 3], T_FL [B, 3] and the satellite patch's
side length in meters at ground columns u = 0, 1 of each kept row, then the
shared ``banded_project``: K1 and ``lm_update_from_moments`` in
evaluation, K2 / K3 and ``lm_update_implicit`` in training.  Only the bottom
half of the ground rows is sampled.  Ford keeps the reference's
differences from KITTI:
* the solver updates all three DoF whatever ``active_pose_dims`` says, with
  normalized features, and re-inits the shifts that leave the range (not
  gated on a DoF freeze, models_ford.py:453-458);
* the damping is a (1, 3) parameter, initialised at zero;
* u is lateral and v longitudinal (models_ford.py:823-824): the loss reads
  ``gt_pose[:, 0]`` as lateral, and ``coe_heading`` is 0 when
  ``rotation_range == 0``.

One repair against the JAX package: its ``banded_project`` always swaps
the satellite axes, which suits KITTI, whose ground rows run along sat v.
Under the Ford rig (camera forward -> body north, at a heading near zero)
the ground rows run along sat u, the swapped lines are steep (|slope| ~ 30)
and the validity guard drops every row, so K1 / K2 sample nothing and the
pose never moves (its gather path, the reference's, does move it).  This
port picks the kernel layout per forward from the rows' direction at the
zero pose, a closed form of R_FL read on the host (``kernel_layout``): the
JAX layout wherever the rows run along sat v, where it agrees with the JAX
package, and the unswapped one where they run along sat u.  A batch whose
rigs disagree raises; ``Localizer.predict`` serves such rigs in separate
batches.

``state_dict`` keys follow the reference: ``SatFeatureNet.*``,
``GrdFeatureNet.*``, ``damping``.  ``check_supported`` refuses every option
the port does not carry for Ford with ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.geometry import ford as fgeom
from highlyaccurate_tpu_torch.models.lm_s2gp import BandedS2GPBase, _level_hw
from highlyaccurate_tpu_torch.solver.updates import LMConfig


def check_supported(cfg: Config):
    """Raise ``NotImplementedError`` naming the first option of a Ford
    ``cfg`` that this port does not carry yet."""
    refused = [
        (cfg.Optimizer != "LM", f"Optimizer={cfg.Optimizer!r}"),
        (bool(cfg.estimate_depth), "estimate_depth"),
        (bool(cfg.use_gt_depth), "use_gt_depth"),
        (cfg.pose_hypotheses > 1, "pose_hypotheses > 1"),
        (bool(cfg.using_weight), "using_weight"),
        (cfg.dropout > 0, "dropout > 0"),
        (bool(cfg.level_first), "level_first"),
        (cfg.proj != "geo", f"proj={cfg.proj!r}"),
        (not cfg.use_fused_moments, "use_fused_moments=0"),
        (not cfg.use_implicit_lm, "use_implicit_lm=0"),
        (not cfg.use_banded_warp, "use_banded_warp=0"),
        (cfg.compute_dtype != "float32",
         f"compute_dtype={cfg.compute_dtype!r}"),
    ]
    for bad, name in refused:
        if bad:
            raise NotImplementedError(
                f"{name} is not supported by highlyaccurate_tpu_torch for "
                "Ford yet (it carries LM_S2GP_Ford geo LM evaluation and "
                "training on the banded sampler)")


def ford_rays(cfg: Config):
    """Host-side per-level Ford ground-plane rays (reference
    models_ford.py:110-155): [(xyz [H, W, 3], mask [H, W], xyz_w)] * 4."""
    return [fgeom.grd_img2cam_ford(*_level_hw(cfg, lvl), cfg.grd_h,
                                   cfg.grd_w) for lvl in range(4)]


def sample_layouts(R_FL) -> np.ndarray:
    """Each sample's ``banded_project`` ``swap`` for the camera -> body
    rotations R_FL [B, 3, 3] (a host array or tensor; a tensor on the
    device costs one read to the host): bool [B].

    A kept ground row meets the ground plane at one camera depth, so it
    runs along the camera x axis, body direction R_FL[:, :, 0].  At heading
    0 sat u is body east (R_FL[:, 1, 0]) and sat v body south
    (-R_FL[:, 0, 0]), so True (the JAX layout, kernel x = sat v) where
    |R_FL[:, 0, 0]| >= |R_FL[:, 1, 0]|: the rows run at least as much along
    sat v as along sat u."""
    col = (R_FL[:, :2, 0].detach().cpu().numpy() if torch.is_tensor(R_FL)
           else np.asarray(R_FL)[:, :2, 0])
    return np.abs(col[:, 0]) >= np.abs(col[:, 1])


def kernel_layout(R_FL) -> bool:
    """The one ``swap`` of a batch (``sample_layouts``); raises
    ``ValueError`` when its samples' rigs disagree, since one kernel launch
    takes one layout."""
    swap = sample_layouts(R_FL)
    if swap.any() != swap.all():
        raise ValueError(
            "the batch mixes Ford rigs whose ground rows run along different "
            "satellite axes (sample_layouts: "
            f"{swap.astype(int).tolist()}); pass them in separate batches")
    return bool(swap[0])


class LMS2GPFord(BandedS2GPBase):
    """Ford-AV model, LM_S2GP_Ford."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        check_supported(cfg)
        self._init_common(
            cfg, LMConfig(active_dims=(0, 1, 2),
                          train_damping=bool(cfg.train_damping),
                          damping=cfg.damping,
                          use_hessian=bool(cfg.use_hessian), reinit=True),
            (1, 3), ford_rays(cfg), device)

    def _line_uv(self, pose, slot: int, A: int, geo: tuple):
        cfg = self.cfg
        R_FL, T_FL, side_m, swap = geo
        uv01, duv01 = fgeom.ford_uv_jac(
            pose, R_FL, T_FL, getattr(self, f"rows01_{slot}"), side_m, A,
            cfg.rotation_range, cfg.shift_range_lat, cfg.shift_range_lon)
        return uv01, duv01, swap

    def forward(self, sat_map, grd_img, satmap_sidelength_meters, R_FL, T_FL,
                mode: str = "test", init_pose: Optional[torch.Tensor] = None,
                *, gt_pose: Optional[torch.Tensor] = None,
                generator: torch.Generator):
        """Feature extraction + unrolled solver.

        sat_map [B, A, A, 3], grd_img [B, H, W, 3] float32 on the model's
        device; R_FL [B, 3, 3] and T_FL [B, 3] (camera -> body) on the host
        or on that device (on the host they spare ``kernel_layout`` a read
        from the device; a batch of disagreeing layouts raises
        ``ValueError``); satmap_sidelength_meters the satellite patch's side
        (a scalar or a
        per-sample [B] tensor); init_pose [B, 3] normalized warm start
        (default zero); generator: the ``torch.Generator`` (on the model's
        device) of the re-init draw, which every round makes.

        mode 'test' -> (shift_lat, shift_lon, theta) each [B];
        mode 'trajectory' -> the same three, each [B, N_iters, levels];
        mode 'train' -> ``LossDiagnostics`` of ``loss_func`` against
        ``gt_pose`` [B, 3] (normalized (shift_u = lateral, shift_v =
        longitudinal, heading)), differentiable with respect to the
        parameters.
        """
        swap = kernel_layout(R_FL)
        R_FL, T_FL = (t.to(self.device, torch.float32) for t in (R_FL, T_FL))
        geo = (R_FL, T_FL, satmap_sidelength_meters, swap)
        traj = self._trajectory(sat_map, grd_img, mode, init_pose, gt_pose,
                                generator, geo)
        # Ford: u is lateral, v longitudinal
        gt = (None,) * 3 if gt_pose is None else tuple(
            gt_pose[:, i].float() for i in range(3))
        return self._outputs(mode, traj[..., 0], traj[..., 1], traj[..., 2],
                             *gt)
