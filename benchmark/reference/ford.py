"""Plain Ford LM_S2GP_Ford of HighlyAccurate (CVPR 2022, ``models_ford.py``
and ``train_ford.py`` of github.com/YujiaoShi/HighlyAccurate), on the Ford
Multi-AV Seasonal data: KITTI's satellite-to-ground solver (``s2gp``)
under the Ford camera chain, per pixel and in float32, on the features of
``vgg.features``.

Each of the N_iters x 3 rounds (iteration-major, levels coarse to fine)
lifts the bottom half of the ground feature rows (the sky crop) onto the
ground plane 1.65 m below the front-left camera (its intrinsics, ``rays``),
carries those points through the camera -> body -> world -> satellite
chain (body X north, Y east, Z down; Xb = R_FL Xc + T_FL; the shift
(longitudinal north, lateral west) and the heading about Z; satellite u
east, v south at ``METERS_PER_PIXEL``; ``uv_jac``), samples the satellite
features there with their screen derivatives, and takes the damped
Gauss-Newton step of ``s2gp.lm_step``: all three pose terms, normalized
features, damping 0.1 (the (1, 3) damping parameter starts at zero and
is not trained), and the re-init of a shift that leaves (-2.5, 2.5).
The pose is (lateral, longitudinal, heading) in this order, normalized by
``shift_range_lat``, ``shift_range_lon`` and ``rotation_range``.

Every frame carries the Ford data's front-left rig (``RIG_QVEC``,
``RIG_T``).  Two sampling rules, as the deployment states them (``rule``):
  * ``gather``: the reference's own sampler (``s2gp.sample_gather``);
  * ``line``: the banded deployment's (``use_banded_warp=1``), whose
    validity guard (``s2gp.line_rows_valid``) reads each row's line in
    the kernel's axes.  Departure from the JAX package, which always takes
    kernel x = satellite v: the layout follows the rig (``swapped``).
    Under the Ford rig a kept row runs along satellite u, so kernel x is
    u, and the guard drops a row steeper than 0.95 in v per u or spanning
    more than RB - 3 rows of v; in the JAX layout that guard would drop
    every row and the pose would never move.

What the harness asks of a family is listed in ``s2gp``'s docstring.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from benchmark.reference import s2gp, vgg
from benchmark.reference.s2gp import (  # noqa: F401 (the family's answers)
    initial_damping, loss, reinit_draws, touched_cells)

# the Ford data's front-left camera -> body calibration (rotation as a
# quaternion w, x, y, z; translation in meters), as the reference's
# dataLoader/Ford_dataset.py reads it for every frame
RIG_QVEC = (0.496157034, -0.486630591, 0.507791308, -0.509084328)
RIG_T = (1.470563, 0.405664, 1.243369)
# the Ford satellite patches: 0.22 m a pixel (512 pixels, 112.64 m)
METERS_PER_PIXEL = 0.22
# the front-left camera's intrinsics of its 1656 x 860 frame (reference
# models_ford.py)
K_FL = np.array([[945.391406, 0.0, 855.502825],
                 [0.0, 945.668274, 566.372868],
                 [0.0, 0.0, 1.0]])
FRAME_W, FRAME_H = 1656, 860


def rotation(qvec) -> np.ndarray:
    """The rotation matrix [3, 3] of a unit quaternion (w, x, y, z)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def rig():
    """(R_FL [3, 3], T_FL [3]) float32 of the Ford data's front-left
    camera."""
    return (rotation(RIG_QVEC).astype(np.float32),
            np.asarray(RIG_T, np.float32))


def side_m(cfg: dict) -> float:
    """The satellite patch's side in meters."""
    return cfg["sat_size"] * METERS_PER_PIXEL


def swapped(R) -> bool:
    """The banded kernels' layout under the rotation R [3, 3]: True where
    kernel x is satellite v (the JAX package's layout), False where it is
    satellite u.  A kept ground row lies at one camera depth, so it runs
    along the camera's x axis, body direction R[:, 0]; at heading 0 that
    is (R[1, 0], -R[0, 0]) in satellite (u, v), and the row takes v where
    it runs at least as much along v as along u."""
    R = np.asarray(R, np.float64)
    return bool(abs(R[0, 0]) >= abs(R[1, 0]))


def rays(h: int, w: int, grd_h: int, grd_w: int):
    """Ground-plane point [h, w, 3] (camera frame) of each pixel of an
    h x w feature map of a grd_h x grd_w input, 1.65 m below the camera,
    and the mask [h, w] of rays that meet it in front (z > 0), float32
    numpy."""
    k = K_FL.copy()
    k[0] = k[0] / FRAME_W * grd_w * (w / grd_w)
    k[1] = k[1] / FRAME_H * grd_h * (h / grd_h)
    v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                       np.arange(w, dtype=np.float64), indexing="ij")
    xyz_w = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(k).T
    y = xyz_w[..., 1:2]
    xyz = xyz_w * (s2gp.CAMERA_HEIGHT / np.where(np.abs(y) > s2gp.EPS, y,
                                                 s2gp.EPS))
    return xyz.astype(np.float32), (xyz[..., 2] > 0).astype(np.float32)


def uv_jac(pose, R, T, xyz, A: int, side: float, ranges):
    """Satellite pixel (u east, v south) [B, V, W, 2] of camera-frame
    ground points xyz [V, W, 3] under pose [B, 3] (normalized lateral,
    longitudinal, heading) and the rig R [B, 3, 3], T [B, 3], and its
    derivative [B, V, W, 2, 3] by the pose."""
    rot, lat, lon = ranges
    r = rot / 180.0 * math.pi
    th = pose[:, 2] * r
    c, s = torch.cos(th), torch.sin(th)
    s_lat, s_lon = pose[:, 0] * lat, pose[:, 1] * lon
    mpp = torch.tensor(side, dtype=torch.float32, device=pose.device) / A

    def b(t):
        return t[:, None, None]

    body = torch.einsum("bij,vwj->bvwi", R, xyz) + T[:, None, None]
    # the shift moves the body by longitudinal north and lateral west;
    # world = Rz(heading) body, Rz = [[c, s, 0], [-s, c, 0], [0, 0, 1]]
    n, e = body[..., 0] + b(s_lon), body[..., 1] - b(s_lat)
    wn = b(c) * n + b(s) * e
    we = -b(s) * n + b(c) * e
    uv = torch.stack([we, -wn], -1) / mpp + A // 2
    d_lat = torch.stack([-c * lat, s * lat], -1)        # d(u, v)/d pose_0
    d_lon = torch.stack([-s * lon, -c * lon], -1)       # ... / d pose_1
    d_th = torch.stack([-wn, -we], -1) * r              # ... / d heading
    shape = uv.shape
    duv = torch.stack([b(d_lat / mpp).expand(shape),
                       b(d_lon / mpp).expand(shape), d_th / mpp], -1)
    return uv, duv


def row_lines(pose, R, T, xyz, A: int, side: float, ranges):
    """``uv_jac`` of every ground point of each row from the row's first
    two: a row of the ground plane is a straight line of the satellite
    map, affine in the column k (the chain is affine), as the banded
    deployment parametrizes each row."""
    uv01, duv01 = uv_jac(pose, R, T, xyz[:, :2], A, side, ranges)
    k = torch.arange(xyz.shape[1], dtype=torch.float32, device=xyz.device)
    uv = uv01[:, :, :1] + k[:, None] * (uv01[:, :, 1:] - uv01[:, :, :1])
    d0 = duv01[:, :, :1]
    duv = d0 + k[:, None, None] * (duv01[:, :, 1:] - d0)
    return uv, duv


def line_cells(uv, A: int, swap: bool):
    """``s2gp.line_cells`` in the layout ``swap``: kernel x = v (True), or
    kernel x = u, which is the swapped layout on the transposed map, read
    at (v, u); the cells' (row, column) are then the transposed map's."""
    return s2gp.line_cells(uv if swap else uv.flip(-1), A)


def sample_line(img, uv, bf16_map: bool, swap: bool):
    """Bilinear value and d/du, d/dv [B, V, W, C] of img [B, A, A, C] at uv
    as the banded deployment samples in the layout ``swap``
    (``line_cells``): the same cells and weights in either layout; only
    the guard differs."""
    if swap:
        return s2gp.sample_line(img, uv, bf16_map)
    s, dv, du = s2gp.sample_line(img.transpose(1, 2), uv.flip(-1), bf16_map)
    return s, du, dv


def trajectory(params, sat, grd, cfg: dict, draws, mode: str,
               rule: str = "line", rows=None):
    """The poses of every round [B, N_iters, 3, 3] (iteration, level,
    (lateral, longitudinal, heading)) from zero, for sat [B, A, A, 3] and
    grd [B, H, W, 3] float32 images in [0, 1].

    cfg: the deployment's sizes and ranges (``sat_size``, ``grd_h``,
    ``grd_w``, ``N_iters``, ``shift_range_lat``, ``shift_range_lon``,
    ``rotation_range``, ``damping``, ``banded_bf16_map``); draws(t) gives
    round t's uniform numbers [2, B]; mode: ``vgg.features``' precision;
    rule: ``line`` or ``gather``; rows: the images whose poses are solved
    (default all; the features are computed for every image given).
    Every frame carries the Ford data's rig (``rig``).  Differentiable in
    params under autograd.
    """
    slots = (0, 1, 2)
    sat_f = vgg.features(params, "SatFeatureNet.", sat, slots, mode)
    grd_f = vgg.features(params, "GrdFeatureNet.", grd, slots, mode)
    if rows is not None:
        sat_f, grd_f = [f[rows] for f in sat_f], [f[rows] for f in grd_f]
    ranges = (cfg["rotation_range"], cfg["shift_range_lat"],
              cfg["shift_range_lon"])
    dev = sat.device
    B = sat_f[0].shape[0]
    R_np, T_np = rig()
    swap = swapped(R_np)
    R = torch.from_numpy(R_np).to(dev).expand(B, 3, 3)
    T = torch.from_numpy(T_np).to(dev).expand(B, 3)
    side = side_m(cfg)
    levels = []
    for lvl in range(len(slots)):
        h, w = grd_f[lvl].shape[1:3]
        xyz, mask = rays(h, w, cfg["grd_h"], cfg["grd_w"])
        half = h // 2
        levels.append((torch.from_numpy(xyz[half:]).to(dev),
                       torch.from_numpy(mask[half:]).to(dev),
                       sat_f[lvl].float(), grd_f[lvl][:, half:].float()))
    pose = torch.zeros(B, 3, dtype=torch.float32, device=dev)
    traj, t = [], 0
    for _ in range(cfg["N_iters"]):
        for xyz, mask, sat_l, grd_l in levels:
            A = sat_l.shape[1]
            if rule == "line":
                uv, duv = row_lines(pose, R, T, xyz, A, side, ranges)
                s, du, dv = sample_line(sat_l, uv,
                                        bool(cfg["banded_bf16_map"]), swap)
            else:
                uv, duv = uv_jac(pose, R, T, xyz, A, side, ranges)
                s, du, dv = s2gp.sample_gather(sat_l, uv)
            pose = s2gp.lm_step(pose, s, du, dv, grd_l, mask, duv, draws(t),
                                cfg["damping"])
            traj.append(pose)
            t += 1
    return torch.stack(traj, 1).reshape(B, cfg["N_iters"], len(slots), 3)


# --- what the harness asks of the family -----------------------------------

MODEL_CLASS = "highlyaccurate_tpu_torch.models.ford.LMS2GPFord"
# the trajectory's pose terms as keys of ``Localizer.predict``'s output, and
# the ranges that normalize each
POSE_KEYS = ("lateral_m", "longitudinal_m", "heading_deg")
POSE_RANGES = ("shift_range_lat", "shift_range_lon", "rotation_range")


def localizer_inputs(cfg: dict) -> dict:
    """``Localizer`` keyword arguments beside the configuration: the rig
    of every frame and the patch's side in meters."""
    return {"ford_extrinsics": rig(), "ford_side_m": side_m(cfg)}


def step_inputs(cfg: dict, batch: int) -> tuple:
    """Host arrays the train step takes after the frames: none, since
    ``step_options`` gives the rig of every image."""
    return ()


def step_options(cfg: dict) -> dict:
    """``make_train_step`` keyword arguments: every image's rig and the
    patch's side."""
    return {"ford_extrinsics": rig(), "ford_side_m": side_m(cfg)}


def map_cells(cfg: dict) -> tuple:
    """Per level, the satellite map cells the kept rows' samples touch at
    the zero pose under the Ford data's rig, in its layout: what one
    image's banded sampling must read of its map."""
    return _map_cells(tuple(sorted(cfg.items())))


@functools.lru_cache(maxsize=None)
def _map_cells(items: tuple) -> tuple:
    cfg = dict(items)
    ranges = (cfg["rotation_range"], cfg["shift_range_lat"],
              cfg["shift_range_lon"])
    R_np, T_np = rig()
    R, T = torch.from_numpy(R_np)[None], torch.from_numpy(T_np)[None]
    out = []
    for A, C, h, w in vgg.levels(cfg):
        xyz, mask = rays(h, w, cfg["grd_h"], cfg["grd_w"])
        uv, _ = uv_jac(torch.zeros(1, 3), R, T, torch.from_numpy(
            xyz[h // 2:]), A, side_m(cfg), ranges)
        r0, c0, _, _, m = line_cells(uv, A, swapped(R_np))
        out.append(touched_cells(r0, c0, m * torch.from_numpy(
            mask[h // 2:]), A))
    return tuple(out)
