"""Serving API (port of ``highlyaccurate_tpu/inference.py:67-279, 540-671``).

    loc = Localizer(Config(), pth_path="model_1.pth")        # on the GPU
    out = loc.predict(sat_imgs, grd_imgs)   # numpy [N,A,A,3], [N,H,W,3]
    out["lateral_m"], out["longitudinal_m"], out["heading_deg"]     # [N]

    loc = Localizer(Config(direction="G2SP"), pth_path=..., camera_k=K)
    out = loc.predict(sat_imgs, grd_imgs)              # or camera_k=[N,3,3]

    loc = Localizer(Config(), pth_path=..., ford_extrinsics=(R_FL, T_FL),
                    ford_side_m=512 * 0.22)                 # Ford
    out = loc.predict(sat_imgs, grd_imgs)       # or R_FL=[N,3,3], T_FL=[N,3]

One object owns the model on its device, pads ragged batches to a fixed
batch size, and converts the normalized pose to meters and degrees.  Tracking
mode feeds the previous estimate back as a warm start:

    out = loc.predict(sat_t, grd_t, init_pose=out_prev)

This port serves KITTI S2GP and G2SP and Ford LM_S2GP_Ford.  G2SP takes the
camera intrinsics of the grd_h x grd_w input, per call or as a constructor
default; Ford takes the camera -> body extrinsics and the satellite patch's
side length in meters at construction, and per-image extrinsics per call.
Orbax checkpoints and ``return_cov`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.models import ford, lm_g2sp, lm_s2gp
from highlyaccurate_tpu_torch.params import (init_params, load_pth,
                                             state_dict_from_jax)
from highlyaccurate_tpu_torch.utils.device import resolve_device


class Localizer:
    """Batched pose estimation over the KITTI S2GP or G2SP model
    (``cfg.direction``), or the Ford model when ``ford_extrinsics`` and
    ``ford_side_m`` are given.

    Weights come from exactly one of ``params`` (the JAX package's params
    pytree), ``pth_path`` (a reference checkpoint) or ``random_init=True``
    (untrained weights drawn from ``seed``; tests and smoke runs only).
    ``camera_k`` [3, 3] (G2SP only) is the default intrinsics of the
    grd_h x grd_w input for ``predict`` calls that pass none.  Ford needs
    both ``ford_extrinsics`` = (R_FL [3, 3], T_FL [3]), the default
    camera -> body extrinsics, and ``ford_side_m``, the satellite patch's
    side length in meters (the Ford data's 0.22 m per pixel times its
    side); the Ford chain is S2GP only.
    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to run the plain PyTorch path on the host.
    """

    def __init__(self, cfg: Config, params=None, pth_path: Optional[str] = None,
                 batch_size: int = 8, seed: int = 0, random_init: bool = False,
                 device=None, save_path: Optional[str] = None,
                 ford_extrinsics=None, ford_side_m: Optional[float] = None,
                 camera_k=None):
        if save_path is not None:
            raise NotImplementedError("save_path= (orbax checkpoints) is not "
                                      "supported; pass pth_path= or params=")
        self._ford = ford_side_m is not None or ford_extrinsics is not None
        self._g2sp = cfg.direction == "G2SP"
        if self._ford and (ford_side_m is None or ford_extrinsics is None):
            raise ValueError("Ford serving needs both ford_extrinsics="
                             "(R_FL [3,3], T_FL [3]) and ford_side_m= "
                             "(satellite patch side length in meters)")
        if self._ford and self._g2sp:
            raise ValueError("the Ford chain is S2GP-only "
                             "(direction='G2SP' with ford_* contradicts it)")
        if camera_k is not None and not self._g2sp:
            raise ValueError("camera_k is a G2SP input (KITTI S2GP "
                             "precomputes rays from the fixed default K); "
                             "build with Config(direction='G2SP')")
        module = (ford if self._ford else lm_g2sp if self._g2sp
                  else lm_s2gp)
        module.check_supported(cfg)
        family = (ford.LMS2GPFord if self._ford else lm_g2sp.LMG2SP
                  if self._g2sp else lm_s2gp.LMS2GP)
        sources = sum([params is not None, pth_path is not None,
                       bool(random_init)])
        if sources != 1:
            raise ValueError("pass exactly one weight source: params=, "
                             "pth_path= or random_init=True")
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._camera_k = (None if camera_k is None else
                          np.asarray(camera_k, np.float32).reshape(3, 3))
        self._ford_side_m = ford_side_m
        self._ford_R = self._ford_T = None
        if self._ford:
            R_FL, T_FL = ford_extrinsics
            self._ford_R = np.asarray(R_FL, np.float32).reshape(3, 3)
            self._ford_T = np.asarray(T_FL, np.float32).reshape(3)
        self.model = family(cfg, device=self.device)
        if random_init:
            init_params(self.model, torch.Generator().manual_seed(seed))
        else:
            sd = (state_dict_from_jax(params) if params is not None
                  else load_pth(pth_path))
            self.model.load_state_dict(sd)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def predict(self, sat_imgs, grd_imgs, R_FL=None, T_FL=None,
                camera_k=None, init_pose=None,
                return_cov: bool = False) -> dict:
        """sat_imgs [N, A, A, 3], grd_imgs [N, H, W, 3] (float in [0, 1] or
        uint8).  Returns numpy {"lateral_m", "longitudinal_m",
        "heading_deg"}, each [N], denormalized as the reference eval does
        (reference train_kitti.py:77-80).

        Ford only: ``R_FL`` [N, 3, 3] / ``T_FL`` [N, 3] override the
        constructor's extrinsics per image (mixed camera rigs; images whose
        rigs take different kernel layouts, ``ford.sample_layouts``, go in
        separate batches).
        G2SP only: ``camera_k`` [N, 3, 3] (or [3, 3], one rig), the
        intrinsics of the grd_h x grd_w input; required unless the
        constructor got ``camera_k=``.

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
        extras = _per_image_extras(n, self._ford, self._g2sp, self._ford_R,
                                   self._ford_T, self._camera_k, R_FL, T_FL,
                                   camera_k)
        if init_pose is not None:
            extras["_init_pose"] = _init_to_normalized(init_pose, n,
                                                       self._ford, ranges)

        def to_dev(x):
            t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            # uint8 images cross to the device as bytes and convert there
            # (IEEE float32 x / 255, the same numbers as on the host)
            return t.to(torch.float32) / 255.0 if t.dtype == torch.uint8 \
                else t.to(torch.float32)

        def run(sb, gb, eb):
            init = to_dev(eb["_init_pose"]) if "_init_pose" in eb else None
            if self._ford:
                # the rig goes on the host: the model reads its layout there
                lat, lon, th = self.model(
                    to_dev(sb), to_dev(gb), self._ford_side_m,
                    *(torch.from_numpy(np.ascontiguousarray(eb[k]))
                      for k in ("R_FL", "T_FL")), mode="test",
                    init_pose=init, generator=self._generator)
            elif self._g2sp:
                lat, lon, th = self.model(to_dev(sb), to_dev(gb),
                                          to_dev(eb["camera_k"]),
                                          mode="test", init_pose=init)
            else:
                lat, lon, th = self.model(to_dev(sb), to_dev(gb),
                                          mode="test", init_pose=init,
                                          generator=self._generator)
            return lat.cpu().numpy(), lon.cpu().numpy(), th.cpu().numpy()

        if self._ford:
            swap = ford.sample_layouts(extras["R_FL"])
            if swap.any() != swap.all():
                # one launch takes one kernel layout: serve each apart
                grd_imgs, out = np.asarray(grd_imgs), {}
                for sel in (swap, ~swap):
                    part = _batched_predict(
                        run, sat_imgs[sel], grd_imgs[sel], self.batch_size,
                        ranges, {k: v[sel] for k, v in extras.items()})
                    for k, v in part.items():
                        out.setdefault(k, np.empty(n, np.float32))[sel] = v
                return out
        return _batched_predict(run, sat_imgs, grd_imgs, self.batch_size,
                                ranges, extras)


def _per_image_extras(n, ford, g2sp, ford_R, ford_T, default_k, R_FL,
                      T_FL, camera_k) -> dict:
    """The per-image model inputs of one call, [N, ...] arrays, from the
    call's overrides and the constructor's defaults: a Ford call's R_FL
    [N, 3, 3] and T_FL [N, 3]; a G2SP call's camera_k [N, 3, 3] (from
    [N, 3, 3] or [3, 3]); a KITTI S2GP call takes none."""
    if (R_FL is not None or T_FL is not None) and not ford:
        raise ValueError("R_FL/T_FL are Ford-chain extrinsics; this "
                         "localizer does not serve the Ford model")
    if camera_k is not None and not g2sp:
        raise ValueError("camera_k is a G2SP input; this localizer serves "
                         "an S2GP model (the fixed-K quirk: KITTI S2GP "
                         "precomputes rays from the default K)")

    def check(name, x, shape):
        x = np.asarray(x, np.float32)
        if x.shape != shape:
            raise ValueError(f"{name} must have shape {shape} to match the "
                             f"{shape[0]} images, got {x.shape}")
        return x

    if ford:
        return {
            "R_FL": (check("R_FL", R_FL, (n, 3, 3)) if R_FL is not None
                     else np.broadcast_to(ford_R, (n, 3, 3))),
            "T_FL": (check("T_FL", T_FL, (n, 3)) if T_FL is not None
                     else np.broadcast_to(ford_T, (n, 3))),
        }
    if not g2sp:
        return {}
    k = camera_k if camera_k is not None else default_k
    if k is None:
        raise ValueError("G2SP serving needs camera intrinsics: pass "
                         "camera_k= ([N,3,3] or [3,3]) to predict(), or a "
                         "default at construction")
    k = np.asarray(k, np.float32)
    if k.shape == (3, 3):
        k = np.broadcast_to(k, (n, 3, 3))
    return {"camera_k": check("camera_k", k, (n, 3, 3))}


def _init_to_normalized(init_pose, n, ford, ranges) -> np.ndarray:
    """[N, 3] normalized pose-order warm start from the dict a previous
    predict returned or an [N, 3] array of (lateral_m, longitudinal_m,
    heading_deg).  Pose order is the model's: KITTI (u = lon, v = lat,
    heading), Ford (u = lat, v = lon, heading).  A zero range freezes that
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
    order = [lat, lon, deg] if ford else [lon, lat, deg]
    return np.stack(order, -1).astype(np.float32)


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
