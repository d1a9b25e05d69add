"""Serving API (port of ``highlyaccurate_tpu/inference.py:67-279, 587-671``).

    loc = Localizer(Config(), pth_path="model_1.pth")        # on the GPU
    out = loc.predict(sat_imgs, grd_imgs)   # numpy [N,A,A,3], [N,H,W,3]
    out["lateral_m"], out["longitudinal_m"], out["heading_deg"]     # [N]

One object owns the model on its device, pads ragged batches to a fixed
batch size, and converts the normalized pose to meters and degrees.  Tracking
mode feeds the previous estimate back as a warm start:

    out = loc.predict(sat_t, grd_t, init_pose=out_prev)

This slice serves KITTI S2GP only.  G2SP, Ford extrinsics, orbax
checkpoints and ``return_cov`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP, check_supported
from highlyaccurate_tpu_torch.params import (init_params, load_pth,
                                             state_dict_from_jax)
from highlyaccurate_tpu_torch.utils.device import resolve_device


class Localizer:
    """Batched pose estimation over the flagship S2GP model.

    Weights come from exactly one of ``params`` (the JAX package's params
    pytree), ``pth_path`` (a reference checkpoint) or ``random_init=True``
    (untrained weights drawn from ``seed``; tests and smoke runs only).
    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to run the plain PyTorch path on the host.
    """

    def __init__(self, cfg: Config, params=None, pth_path: Optional[str] = None,
                 batch_size: int = 8, seed: int = 0, random_init: bool = False,
                 device=None, save_path: Optional[str] = None,
                 ford_extrinsics=None, ford_side_m: Optional[float] = None):
        if save_path is not None:
            raise NotImplementedError("save_path= (orbax checkpoints) is not "
                                      "supported; pass pth_path= or params=")
        if ford_extrinsics is not None or ford_side_m is not None:
            raise NotImplementedError("Ford extrinsics are not supported yet")
        check_supported(cfg)
        sources = sum([params is not None, pth_path is not None,
                       bool(random_init)])
        if sources != 1:
            raise ValueError("pass exactly one weight source: params=, "
                             "pth_path= or random_init=True")
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.model = LMS2GP(cfg, device=self.device)
        if random_init:
            init_params(self.model, torch.Generator().manual_seed(seed))
        else:
            sd = (state_dict_from_jax(params) if params is not None
                  else load_pth(pth_path))
            self.model.load_state_dict(sd)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def predict(self, sat_imgs, grd_imgs, init_pose=None,
                return_cov: bool = False) -> dict:
        """sat_imgs [N, A, A, 3], grd_imgs [N, H, W, 3] (float in [0, 1] or
        uint8).  Returns numpy {"lateral_m", "longitudinal_m",
        "heading_deg"}, each [N], denormalized as the reference eval does
        (reference train_kitti.py:77-80).

        ``init_pose`` warm-starts the solver: the dict a previous
        ``predict`` returned or an [N, 3] array of (lateral_m,
        longitudinal_m, heading_deg).
        """
        if return_cov:
            raise NotImplementedError("return_cov is not supported yet")
        cfg = self.cfg
        ranges = (cfg.shift_range_lat, cfg.shift_range_lon,
                  cfg.rotation_range)
        sat_imgs = np.asarray(sat_imgs)
        n = sat_imgs.shape[0]
        extras = {}
        if init_pose is not None:
            extras["_init_pose"] = _init_to_normalized(init_pose, n, ranges)

        def to_dev(x):
            t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            # uint8 images cross to the device as bytes and convert there
            # (IEEE float32 x / 255, the same numbers as on the host)
            return t.to(torch.float32) / 255.0 if t.dtype == torch.uint8 \
                else t.to(torch.float32)

        def run(sb, gb, eb):
            init = to_dev(eb["_init_pose"]) if "_init_pose" in eb else None
            lat, lon, th = self.model(to_dev(sb), to_dev(gb), mode="test",
                                      init_pose=init,
                                      generator=self._generator)
            return lat.cpu().numpy(), lon.cpu().numpy(), th.cpu().numpy()

        return _batched_predict(run, sat_imgs, grd_imgs, self.batch_size,
                                ranges, extras)


def _init_to_normalized(init_pose, n, ranges) -> np.ndarray:
    """[N, 3] normalized pose-order (u = lon, v = lat, heading) warm start
    from the dict a previous predict returned or an [N, 3] array of
    (lateral_m, longitudinal_m, heading_deg).  A zero range freezes that
    DoF at 0."""
    if isinstance(init_pose, dict):
        init_pose = np.stack([np.asarray(init_pose["lateral_m"]),
                              np.asarray(init_pose["longitudinal_m"]),
                              np.asarray(init_pose["heading_deg"])], -1)
    p = np.asarray(init_pose, np.float32)
    if p.shape != (n, 3):
        raise ValueError(f"init_pose must have shape ({n}, 3) to match the "
                         f"{n} images, got {p.shape}")
    lat = p[:, 0] / ranges[0] if ranges[0] else np.zeros_like(p[:, 0])
    lon = p[:, 1] / ranges[1] if ranges[1] else np.zeros_like(p[:, 1])
    deg = p[:, 2] / ranges[2] if ranges[2] else np.zeros_like(p[:, 2])
    return np.stack([lon, lat, deg], -1).astype(np.float32)


def _batched_predict(run, sat_imgs, grd_imgs, batch_size, ranges,
                     extras) -> dict:
    """Padding of the ragged tail to ``batch_size`` (with copies of the last
    image) and denormalization to meters/degrees.  ``run(sat, grd,
    extras_batch)`` executes one padded batch of host arrays (uint8 or
    float) and converts them to float32 itself."""
    sat = np.asarray(sat_imgs)
    grd = np.asarray(grd_imgs)
    n = sat.shape[0]
    if n == 0:
        empty = np.zeros((0,), np.float32)
        return {"lateral_m": empty, "longitudinal_m": empty,
                "heading_deg": empty}

    def pad_to(x, bs):
        pad = bs - x.shape[0]
        return x if not pad else np.concatenate(
            [x, np.repeat(x[-1:], pad, 0)])

    lats, lons, ths = [], [], []
    for i in range(0, n, batch_size):
        chunk = min(batch_size, n - i)
        sb = pad_to(sat[i:i + chunk], batch_size)
        gb = pad_to(grd[i:i + chunk], batch_size)
        eb = {k: pad_to(v[i:i + chunk], batch_size) for k, v in extras.items()}
        lat, lon, th = run(sb, gb, eb)
        lats.append(lat[:chunk])
        lons.append(lon[:chunk])
        ths.append(th[:chunk])

    return {
        "lateral_m": np.concatenate(lats) * ranges[0],
        "longitudinal_m": np.concatenate(lons) * ranges[1],
        "heading_deg": np.concatenate(ths) * ranges[2],
    }
