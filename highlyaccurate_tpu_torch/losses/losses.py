"""Training loss of the unrolled pose solver (port of
``highlyaccurate_tpu/losses/losses.py:21-164``).

Method 0, the weighted L1 pose error over every (iteration, level) of the
trajectory, is the production loss.  Methods 1-3, the reference's failed
feature-triplet trials (models_ford.py:1040 marks them so), read the
projected feature maps of every round, which the models collect on the
gather sampler.

Trajectories are [B, N_iters, L] tensors in normalized units.
``soft_margin_triplet`` (JAX ``losses.py:167-180``) is the G2SP ``corr``
head's loss.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LossDiagnostics(NamedTuple):
    loss: torch.Tensor                # scalar
    loss_decrease: torch.Tensor       # [L]
    shift_lat_decrease: torch.Tensor  # [L]
    shift_lon_decrease: torch.Tensor  # [L]
    thetas_decrease: torch.Tensor     # [L]
    loss_last: torch.Tensor           # [L]
    shift_lat_last: torch.Tensor      # [L]
    shift_lon_last: torch.Tensor      # [L]
    theta_last: torch.Tensor          # [L]
    L1: Optional[torch.Tensor] = None
    L2: Optional[torch.Tensor] = None
    L3: Optional[torch.Tensor] = None
    L4: Optional[torch.Tensor] = None


def normalize_feature(x):
    """Whole-map L2 normalization over the trailing three axes of a
    channel-last map [..., H, W, C], the norm floored at 1e-12 (reference
    models_ford.py:1206-1209)."""
    flat = x.reshape(x.shape[:-3] + (-1,))
    norm = torch.sqrt(torch.clamp_min((flat * flat).sum(-1), 1e-24))
    return x / norm[..., None, None, None]


def _softplus(x):
    """log(1 + exp(x)) written out, as JAX writes it (``F.softplus``
    switches to x above 20, where this overflows to inf)."""
    return torch.log1p(torch.exp(x))


def _feature_triplets(ref, pred, gt):
    """(pos [B], neg [B, I]) of one level: 2 - 2 <ref, gt> and
    2 - 2 <ref, pred_i> over the whole map, gt and pred normalized (ref
    as it is, as in the reference); ``pred`` None gives neg None."""
    pos = 2 - 2 * (ref * normalize_feature(gt)).sum((-3, -2, -1))
    neg = (None if pred is None else
           2 - 2 * (ref[:, None] * normalize_feature(pred)).sum((-3, -2, -1)))
    return pos, neg


def loss_func(loss_method: int, shift_lats, shift_lons, thetas,
              gt_shift_lat, gt_shift_lon, gt_theta,
              coe_shift_lat: float = 100.0, coe_shift_lon: float = 100.0,
              coe_theta: float = 100.0, ref_feat_list=None,
              pred_feat_list=None, gt_feat_list=None, pred_uv_list=None,
              gt_uv_list=None, coe_L1: float = 100.0, coe_L2: float = 100.0,
              coe_L3: float = 100.0, coe_L4: float = 100.0
              ) -> LossDiagnostics:
    """The reference loss (models_ford.py:1041-1202).

    shift_lats / shift_lons / thetas [B, N_iters, L]; gt_* [B].  Method 0:
    the mean over (iteration, level) of the batch-mean absolute errors,
    weighted by the coefficients; the diagnostics are per level.  Methods
    1-3 read, per level, ref_feat_list (the target features [B, H, W, C]),
    pred_feat_list (the projection of every iteration [B, I, H, W, C]),
    gt_feat_list (the projection at the gt pose [B, H, W, C]) and, for
    method 3, pred_uv_list [B, I, H, W, 2] and gt_uv_list [B, H, W, 2] (the
    projected points over the map side):
    * 1: method 0 plus a soft-margin triplet of the gt projection against
      each round's, over the rounds whose pose errors all exceed (0.001,
      0.001, 0.01) (the reference's mask names undefined variables; this is
      the JAX package's reading of it);
    * 2: method 0 plus the gt projection's distance to the target;
    * 3: four terms per (iteration, level) only: the triplet where the
      points moved more than 0.002, the points' mean distance, its
      increase, and the triplet's change against the distance's;
      ``loss_decrease`` and ``loss_last`` read the distance term.
    """
    lat_d0 = (shift_lats - gt_shift_lat[:, None, None]).abs()  # [B, I, L]
    lon_d0 = (shift_lons - gt_shift_lon[:, None, None]).abs()
    th_d0 = (thetas - gt_theta[:, None, None]).abs()
    lat_d, lon_d, th_d = lat_d0.mean(0), lon_d0.mean(0), th_d0.mean(0)
    losses = coe_shift_lat * lat_d + coe_shift_lon * lon_d + coe_theta * th_d
    base = dict(loss_decrease=losses[0] - losses[-1],
                shift_lat_decrease=lat_d[0] - lat_d[-1],
                shift_lon_decrease=lon_d[0] - lon_d[-1],
                thetas_decrease=th_d[0] - th_d[-1], loss_last=losses[-1],
                shift_lat_last=lat_d[-1], shift_lon_last=lon_d[-1],
                theta_last=th_d[-1])
    loss0 = losses.mean()
    if loss_method == 0:
        return LossDiagnostics(loss=loss0, **base)
    n_levels = len(ref_feat_list)
    if loss_method in (1, 2):
        masks = (lat_d0 > 0.001) & (lon_d0 > 0.001) & (th_d0 > 0.01)
        terms = []
        for lvl in range(n_levels):
            pos, neg = _feature_triplets(
                ref_feat_list[lvl],
                pred_feat_list[lvl] if loss_method == 1 else None,
                gt_feat_list[lvl])
            if loss_method == 2:
                terms.append(pos)                             # [B]
                continue
            m = masks[..., lvl].to(pos.dtype)
            terms.append(_softplus(10 * m * (pos[:, None] - neg)) * m)
        tl = torch.stack(terms, -1)
        if loss_method == 1:
            L1 = coe_L1 * tl.sum() / torch.clamp_min(masks.sum(), 1)
        else:
            L1 = coe_L1 * tl.sum() / gt_shift_lat.shape[0]
        return LossDiagnostics(loss=loss0 + L1, L1=L1, **base)
    if loss_method == 3:
        parts = [[], [], [], []]
        for lvl in range(n_levels):
            pos, neg = _feature_triplets(ref_feat_list[lvl],
                                         pred_feat_list[lvl],
                                         gt_feat_list[lvl])
            uv_diff = torch.sqrt(((pred_uv_list[lvl]
                                   - gt_uv_list[lvl][:, None]) ** 2).sum(-1)
                                 ).mean((2, 3))                # [B, I]
            mask_neg = (uv_diff > 0.002).to(uv_diff.dtype)
            uv_upd = uv_diff[:, 1:] - uv_diff[:, :-1]
            sign = torch.where(uv_upd <= 0.0, 1.0, -1.0)
            terms = (
                coe_L1 * _softplus(10 * mask_neg * (pos[:, None] - neg))
                * mask_neg,
                coe_L2 * uv_diff,
                coe_L3 * _softplus(100 * uv_upd),
                coe_L4 * _softplus(10 * sign * (neg[:, 1:] - neg[:, :-1])))
            for acc, t in zip(parts, terms):
                acc.append(t.mean(0))
        L1, L2, L3, L4 = (torch.stack(p, -1) for p in parts)
        base.update(loss_decrease=L2[0] - L2[-1], loss_last=L2[-1])
        return LossDiagnostics(loss=L1.sum() + L2.sum() + L3.sum()
                               + L4.sum(), L1=L1, L2=L2, L3=L3, L4=L4,
                               **base)
    raise ValueError(f"unknown loss_method {loss_method}")


def clamped_index(i, n: int) -> torch.Tensor:
    """Integer indices as a JAX gather takes them: a negative index counts
    from the end, and an index out of range clamps to the nearest end."""
    i = i.to(torch.int64)
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def soft_margin_triplet(corr, gt_u_px, gt_v_px) -> torch.Tensor:
    """Soft-margin triplet loss over a dense correlation map (port of JAX
    ``losses.py:167-180``; reference models_kitti.py:579-595): the gt cell
    is the positive and every other cell a negative, loss = sum of
    log(1 + exp(10 (pos - neg))) / (B (H W - 1)).

    corr [B, H, W]; gt_u_px, gt_v_px [B] cell coordinates (float, cast to
    integers by truncation as JAX's ``astype(int32)`` does)."""
    B, H, W = corr.shape
    v = clamped_index(gt_v_px, H)
    u = clamped_index(gt_u_px, W)
    pos = corr[torch.arange(B, device=corr.device), v, u]
    pos_neg = pos[:, None, None] - corr
    return torch.log1p(torch.exp(pos_neg * 10.0)).sum() / (B * (H * W - 1))
