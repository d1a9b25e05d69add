"""Training loss of the unrolled pose solver (port of
``highlyaccurate_tpu/losses/losses.py:21-35, 48-99``).

Method 0, the weighted L1 pose error over every (iteration, level) of the
trajectory, is the production loss.  Methods 1-3, the reference's failed
feature-triplet trials, need the full projected feature maps of the gather
sampler and raise ``NotImplementedError`` here.

Trajectories are [B, N_iters, L] tensors in normalized units.
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


def loss_func(loss_method: int, shift_lats, shift_lons, thetas,
              gt_shift_lat, gt_shift_lon, gt_theta,
              coe_shift_lat: float = 100.0, coe_shift_lon: float = 100.0,
              coe_theta: float = 100.0) -> LossDiagnostics:
    """Method 0 of the reference loss (models_ford.py:1041-1095).

    shift_lats / shift_lons / thetas [B, N_iters, L]; gt_* [B].  The loss is
    the mean over (iteration, level) of the batch-mean absolute errors,
    weighted by the coefficients; the diagnostics are per level.
    """
    if loss_method != 0:
        raise NotImplementedError(
            f"loss_method={loss_method} is not supported by "
            "highlyaccurate_tpu_torch yet (it needs the gather projection)")
    lat_d = (shift_lats - gt_shift_lat[:, None, None]).abs().mean(0)  # [I, L]
    lon_d = (shift_lons - gt_shift_lon[:, None, None]).abs().mean(0)
    th_d = (thetas - gt_theta[:, None, None]).abs().mean(0)
    losses = coe_shift_lat * lat_d + coe_shift_lon * lon_d + coe_theta * th_d
    return LossDiagnostics(
        loss=losses.mean(), loss_decrease=losses[0] - losses[-1],
        shift_lat_decrease=lat_d[0] - lat_d[-1],
        shift_lon_decrease=lon_d[0] - lon_d[-1],
        thetas_decrease=th_d[0] - th_d[-1], loss_last=losses[-1],
        shift_lat_last=lat_d[-1], shift_lon_last=lon_d[-1],
        theta_last=th_d[-1])
