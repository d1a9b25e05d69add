"""LM_S2GP_Ford evaluation and training (port of
``highlyaccurate_tpu/models/ford.py:40-130, 132-300, 393-420, 453-529``).

The Ford model is KITTI's S2GP with the Ford camera chain
(``geometry/ford.py``): each round runs ``ford_uv_jac`` with the per-sample
camera extrinsics R_FL [B, 3, 3], T_FL [B, 3] and the satellite patch's
side length in meters, then the round of the shared base
(``models/lm_s2gp.py`` ``S2GPBase``): on the banded path, at ground columns
u = 0, 1 of each kept row, K1 and ``lm_update_from_moments`` in LM
evaluation, K2 / K3 and ``lm_update_implicit`` in LM training (or in
evaluation with ``use_fused_moments=0`` or ``dropout > 0``), K2's samples
with the materialized Jacobian and the update rule with
``use_implicit_lm=0``, ``using_weight`` (which stays on K2 for Ford, JAX
``ford.py:216-224``) or another ``Optimizer``: ``lm_update``,
``gn_update`` (GN), ``sgd_update_l1`` (SGD) or the ``NNrefine`` head
(NN); on the gather path (``use_banded_warp=0``) at every pixel of the
kept rows, ``grid_sample_derivs`` and ``lm_update_implicit_pixel_norm``
(JAX ``ford.py:198-215``), or ``grid_sample`` with the Jacobian and the
update rule.  Under the geo projection only the bottom half of the ground
rows enters the update; any other ``proj`` keeps every row (the rays do
not change) and takes the gather path, as in JAX (``ford.py:155, 169``);
loss methods 1-3 gather every row in training.  ``estimate_depth`` gives
the ground branch its depth heads (``VGGUnet(estimate_depth=True)``):
every round lifts the unit-depth rays to the estimated height
(``depth_lift``) and gathers on them with the materialized Jacobian and
the update rule (JAX ``ford.py:110-112, 155-156, 200``), in training
through the heads' gradients too; ``with_info`` raises ``ValueError``
with it, as in JAX.  ``use_gt_depth`` reads nothing here, as in JAX.
No update rule reads the projected satellite confidence, so the port
does not project it (JAX transforms it, 1/(1 + c), and drops it).
``compute_dtype="bfloat16"`` gives bf16
features with the rules of KITTI S2GP (``feature_dtype``: float32
parameters cast at each conv, a bf16 banded map, float32 target rows).
Ford keeps the reference's differences from KITTI:
* the solver updates all three DoF whatever ``active_pose_dims`` says, with
  normalized features, and re-inits the shifts that leave the range (not
  gated on a DoF freeze, models_ford.py:453-458);
* the damping is a (1, 3) parameter, initialised at zero;
* u is lateral and v longitudinal (models_ford.py:823-824): the loss reads
  ``gt_pose[:, 0]`` as lateral, and ``coe_heading`` is 0 when
  ``rotation_range == 0``.

Evaluation carries the base's multi-start sweep (``pose_hypotheses > 1``,
the rig tiled with the features) and ``with_info`` covariance (JAX
``ford.py:318-390, 423-451``).

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
rigs disagree raises on the banded path; ``Localizer.predict`` serves such
rigs in separate batches.  A caller that must not read the rig on the
host (an exported program) fixes the layout with ``forward``'s ``layout``.

``state_dict`` keys follow the reference: ``SatFeatureNet.*``,
``GrdFeatureNet.*`` (with ``estimate_depth`` its ``depth0..3.{1,3}.weight``),
``damping`` (and ``NNrefine.*``).  ``check_supported`` refuses ADAM with
``ValueError``, as the JAX model does.
"""

from __future__ import annotations

from typing import Optional

import torch

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.geometry import ford as fgeom
from highlyaccurate_tpu_torch.geometry.ford import sample_layouts
from highlyaccurate_tpu_torch.models.lm_s2gp import S2GPBase, _level_hw
from highlyaccurate_tpu_torch.solver.updates import (LMConfig, gn_update,
                                                     sgd_update_l1)


def check_supported(cfg: Config):
    """An ``Optimizer`` Ford has no update rule for (ADAM) raises
    ``ValueError``, as the JAX model does (``ford.py:251-252``).  Every
    other option of the JAX Ford model runs (``use_gt_depth`` reads
    nothing there, as in JAX)."""
    if cfg.Optimizer not in ("LM", "GN", "SGD", "NN"):
        raise ValueError(cfg.Optimizer)


def ford_rays(cfg: Config):
    """Host-side per-level Ford ground-plane rays (reference
    models_ford.py:110-155): [(xyz [H, W, 3], mask [H, W], xyz_w)] * 4."""
    return [fgeom.grd_img2cam_ford(*_level_hw(cfg, lvl), cfg.grd_h,
                                   cfg.grd_w) for lvl in range(4)]


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


class LMS2GPFord(S2GPBase):
    """Ford-AV model, LM_S2GP_Ford."""

    _weight_gathers = False

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        check_supported(cfg)
        depth = bool(cfg.estimate_depth)
        # the lifted rays take the gather path's materialized update (JAX
        # ford.py:155-156, 198-200)
        self._gather_implicit = not depth
        self._init_common(
            cfg, LMConfig(active_dims=(0, 1, 2),
                          train_damping=bool(cfg.train_damping),
                          damping=cfg.damping,
                          use_hessian=bool(cfg.use_hessian), reinit=True,
                          using_weight=bool(cfg.using_weight),
                          dropout=cfg.dropout),
            (1, 3), ford_rays(cfg), device,
            gather=cfg.proj != "geo" or depth, lift=depth,
            grd_kw=dict(estimate_depth=depth))

    def _lifts(self, depths):
        """With ``estimate_depth``, each level's rays lifted to the height
        the ground branch estimates (``depth_lift``, JAX ``ford.py:
        110-112``); else None."""
        if depths is None:
            return None
        return [fgeom.depth_lift(getattr(self, f"rayw_{slot}"), d)
                for slot, d in zip(self._slots, depths)]

    def _pose_info(self, *args, **kwargs):
        """The base's covariance; ``estimate_depth`` raises ``ValueError``,
        as in JAX (its per-pixel duv leaves out the lift)."""
        if self.cfg.estimate_depth:
            raise ValueError("with_info does not support estimate_depth")
        return super()._pose_info(*args, **kwargs)

    def _other_update(self, pose, sat, grd, conf, jac, generator, t: int,
                      adam):
        """Ford's GN and L1-SGD steps (JAX ``ford.py:245-248``)."""
        if self.cfg.Optimizer == "GN":
            return gn_update(pose, sat, grd, conf, jac, self.lm_cfg,
                             generator)
        return sgd_update_l1(pose, sat, grd, jac, self.lm_cfg)

    def _uv_jac(self, pose, points, A: int, geo: tuple, jac: bool = True):
        cfg = self.cfg
        R_FL, T_FL, side_m, _ = geo
        return fgeom.ford_uv_jac(pose, R_FL, T_FL, points, side_m, A,
                                 cfg.rotation_range, cfg.shift_range_lat,
                                 cfg.shift_range_lon, require_jac=jac)

    def _swap(self, geo: tuple) -> bool:
        return geo[3]

    def _tile_geo(self, geo: tuple, P: int) -> tuple:
        R_FL, T_FL, side_m, swap = geo
        if torch.is_tensor(side_m) and side_m.ndim:
            side_m = side_m.repeat_interleave(P, 0)
        return (R_FL.repeat_interleave(P, 0), T_FL.repeat_interleave(P, 0),
                side_m, swap)

    def _geo(self, R_FL, T_FL, satmap_sidelength_meters,
             banded: bool = True, layout: Optional[bool] = None):
        """The per-call geometry of ``_uv_jac``: the rig on the model's
        device, the patch side, and the kernel layout of a ``banded``
        round (``layout`` where the caller fixes it, else read from R_FL
        on the host; the gather sampler takes any mix of rigs)."""
        swap = (layout if layout is not None
                else kernel_layout(R_FL) if banded and not self._gather
                else None)
        R_FL, T_FL = (t.to(self.device, torch.float32) for t in (R_FL, T_FL))
        return (R_FL, T_FL, satmap_sidelength_meters, swap)

    def forward(self, sat_map, grd_img, satmap_sidelength_meters, R_FL, T_FL,
                mode: str = "test", init_pose: Optional[torch.Tensor] = None,
                *, gt_pose: Optional[torch.Tensor] = None,
                generator, with_info: bool = False,
                layout: Optional[bool] = None):
        """Feature extraction + unrolled solver.

        sat_map [B, A, A, 3], grd_img [B, H, W, 3] float32 on the model's
        device; R_FL [B, 3, 3] and T_FL [B, 3] (camera -> body) on the host
        or on that device (on the host they spare ``kernel_layout`` a read
        from the device; on the banded path a batch of disagreeing layouts
        raises ``ValueError``); satmap_sidelength_meters the satellite patch's side
        (a scalar or a
        per-sample [B] tensor); init_pose [B, 3] normalized warm start
        (default zero; hypothesis 0 of a multi-start sweep); generator: the
        ``torch.Generator`` (on the model's device) or ``PresetDraws`` of
        the multi-start initial poses, then per round of the LM dropout's
        keep-set and of the re-init (LM and GN only, as in JAX
        ``ford.py:150``); ``layout`` fixes the banded kernel layout
        (``kernel_layout``'s ``swap``) instead of reading it from R_FL.

        mode 'test' -> (shift_lat, shift_lon, theta) each [B], and with
        ``with_info`` their pose covariance [B, 3, 3] (normalized, pose
        order u = lateral, v = longitudinal) appended;
        mode 'trajectory' -> the same three, each [B, N_iters, levels];
        mode 'train' -> ``LossDiagnostics`` of ``loss_func`` against
        ``gt_pose`` [B, 3] (normalized (shift_u = lateral, shift_v =
        longitudinal, heading)), differentiable with respect to the
        parameters.
        """
        # loss methods 1-3 gather in every training round
        banded = not (mode == "train" and self.cfg.loss_method > 0)
        geo = self._geo(R_FL, T_FL, satmap_sidelength_meters, banded,
                        layout)
        if mode == "test":
            # Ford: u is lateral, v longitudinal
            pose, cov = self._test(sat_map, grd_img, init_pose, generator,
                                   with_info, geo)
            out = (pose[:, 0], pose[:, 1], pose[:, 2])
            return out + (cov,) if with_info else out
        traj, lists = self._trajectory(sat_map, grd_img, mode, init_pose,
                                       gt_pose, generator, geo)
        # Ford: u is lateral, v longitudinal
        gt = (None,) * 3 if gt_pose is None else tuple(
            gt_pose[:, i].float() for i in range(3))
        return self._outputs(mode, traj[..., 0], traj[..., 1], traj[..., 2],
                             *gt, lists)

    def project_at_pose(self, sat_map, grd_img, satmap_sidelength_meters,
                        R_FL, T_FL, pred_pose, gt_pose):
        """Per-level feature maps for ``--visualize`` PCA dumps (port of JAX
        ``ford.py:393``): per level (sat_feat, grd_feat, proj_at_pred,
        proj_at_gt), the projections through the gather sampler at every
        ground pixel of the Ford chain, float32, zero where the ray misses
        the ground.  Inputs as ``forward``'s; poses [B, 3] normalized."""
        geo = self._geo(R_FL, T_FL, satmap_sidelength_meters, banded=False)
        return self._project_at_pose(sat_map, grd_img, (pred_pose, gt_pose),
                                     geo)
