"""Plain KITTI LM_S2GP of HighlyAccurate (CVPR 2022, ``models_kitti.py``
of github.com/YujiaoShi/HighlyAccurate): the satellite-to-ground
projection, the bilinear sampler and the unrolled Levenberg-Marquardt
solver, per pixel and in float32, on the features of ``vgg.features``.

Each of the N_iters x 3 rounds (iteration-major, levels coarse to fine)
projects the bottom half of the ground feature rows (the sky crop) onto
the ground plane, moves those points by the pose into the satellite map,
samples the satellite features there with their screen derivatives, and
takes one damped Gauss-Newton step on the whole-map-normalized residual
r = s / |s| - g / |g| over every pixel under the ray mask and every
channel (damping 0.1 on each of the three pose terms).  A shift that
leaves (-2.5, 2.5) in normalized units is redrawn from the round's two
uniform numbers per image.

Two sampling rules, as the deployment states them (``rule``):
  * ``gather``: the reference's own sampler: the 2x2 block clamped into the
    map, weights from the clamped corners, zero outside [0, A-1];
  * ``line``: the banded deployment's (``use_banded_warp=1``): a row
    whose satellite line is steeper than 0.95 or spans more rows of the
    map than its window (RB - 3) is dropped, a sample on the last map row
    or column is dropped, and with ``bf16_map`` the map is read rounded to
    bfloat16 (its gradient stays float32).

A configuration names its family's module (``"reference"`` in
``configs/<config>.json``); the harness asks it, and nothing else, what
differs by family: ``trajectory`` and ``loss``, the program's model class
(``MODEL_CLASS``), the order of the pose terms and their ranges
(``POSE_KEYS``, ``POSE_RANGES``), the re-init numbers (``reinit_draws``),
the starting damping (``initial_damping``), what the program takes beside
the frames (``localizer_inputs``, ``step_inputs``, ``step_options``) and
the map footprint the roofline counts read (``map_cells``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from benchmark.reference import vgg

CAMERA_HEIGHT = 1.65
EPS = 1e-7
REINIT = 2.5
DEFAULT_K = np.array([[582.9802, 0.0, 496.2420],
                      [0.0, 482.7076, 125.0034],
                      [0.0, 0.0, 1.0]], np.float32).astype(np.float64)


def meter_per_pixel(A: int) -> float:
    """Web-mercator zoom 18 at latitude 49.015, fetched at scale 2, for an
    A-pixel side of the 512-pixel patch."""
    mpp = 156543.03392 * math.cos(49.015 * math.pi / 180.0) / 2 ** 18 / 2
    return mpp * 512 / A


def rays(h: int, w: int, grd_h: int, grd_w: int):
    """Ground-plane point [h, w, 3] of each pixel of an h x w feature map of
    a grd_h x grd_w image and the mask [h, w] of rays that point forward
    (camera +x south, +y down, +z forward), float32 numpy."""
    k = DEFAULT_K.copy()
    k[0] *= grd_w / 1024.0 * w / grd_w
    k[1] *= grd_h / 256.0 * h / grd_h
    v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                       np.arange(w, dtype=np.float64), indexing="ij")
    xyz_w = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(k).T
    y = xyz_w[..., 1:2]
    xyz = xyz_w * (CAMERA_HEIGHT / np.where(np.abs(y) > EPS, y, EPS))
    return xyz.astype(np.float32), (xyz[..., 2] > 0).astype(np.float32)


def uv_jac(pose, xyz, A: int, ranges):
    """Satellite pixel (u east, v south) [B, V, W, 2] of ground points xyz
    [V, W, 3] under pose [B, 3] (normalized shift_u, shift_v, heading) and
    its derivative [B, V, W, 2, 3] by the pose."""
    rot, lat, lon = ranges
    r = rot / 180.0 * math.pi
    th = pose[:, 2] * r
    c, s = torch.cos(th), torch.sin(th)
    su, sv = pose[:, 0] * lon, pose[:, 1] * lat
    mpp = meter_per_pixel(A)
    X, Y, Z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    def b(t):
        return t[:, None, None]

    # world = R (p - [sv, h, -su]) with R = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    dx, dz = X - b(sv), Z + b(su)
    wx = b(c) * dx - b(s) * dz
    wz = b(s) * dx + b(c) * dz
    uv = torch.stack([wz, wx], -1) / mpp + A / 2
    d_su = torch.stack([c * lon, -s * lon], -1)          # d(wz, wx)/d pose_u
    d_sv = torch.stack([-s * lat, -c * lat], -1)         # ... / d pose_v
    d_th = torch.stack([b(c) * dx - b(s) * dz,
                        -b(s) * dx - b(c) * dz], -1) * r
    shape = uv.shape
    duv = torch.stack([b(d_su).expand(shape), b(d_sv).expand(shape), d_th],
                      -1) / mpp
    return uv, duv


def row_lines(pose, xyz, A: int, ranges):
    """``uv_jac`` of every ground point of each row from the row's first
    two: a row of the flat ground plane maps to a straight line of the
    satellite map, affine in the column k, so uv(k) = uv(0) + k (uv(1) -
    uv(0)) and likewise its derivative, as the banded deployment
    parametrizes each row."""
    uv01, duv01 = uv_jac(pose, xyz[:, :2], A, ranges)
    k = torch.arange(xyz.shape[1], dtype=torch.float32, device=xyz.device)
    uv = uv01[:, :, :1] + k[:, None] * (uv01[:, :, 1:] - uv01[:, :, :1])
    d0 = duv01[:, :, :1]
    duv = d0 + k[:, None, None] * (duv01[:, :, 1:] - d0)
    return uv, duv


def _corners(img, r0, c0):
    """The 2x2 blocks of img [B, A, A, C] at rows r0 and columns c0 (int64
    [B, V, W]), float32: (top-left, top-right, bottom-left, bottom-right)."""
    B, A = img.shape[0], img.shape[1]
    flat = img.reshape(B, A * A, -1)
    idx = (r0 * A + c0).reshape(B, -1)
    out = []
    for off in (0, 1, A, A + 1):
        g = torch.gather(flat, 1, (idx + off)[..., None].expand(
            -1, -1, flat.shape[-1]))
        out.append(g.reshape(*r0.shape, -1).float())
    return out


def sample_gather(img, uv):
    """Bilinear value and d/du, d/dv [B, V, W, C] of img [B, A, A, C] at uv
    (pixels), as the reference's sampler computes them."""
    A = img.shape[1]
    u, v = uv[..., 0], uv[..., 1]
    fu, fv = torch.floor(u), torch.floor(v)
    cu0, cv0 = fu.clamp(0, A - 1), fv.clamp(0, A - 1)
    cu1, cv1 = (fu + 1).clamp(0, A - 1), (fv + 1).clamp(0, A - 1)
    c0 = fu.clamp(0, A - 2).long().clamp(0, A - 2)
    r0 = fv.clamp(0, A - 2).long().clamp(0, A - 2)
    a, b, c, d = _corners(img, r0, c0)
    m = ((u >= 0) & (u <= A - 1) & (v >= 0) & (v <= A - 1)).float()
    wu1, wu0 = (u - cu0) * m, (cu1 - u) * m
    wv1, wv0 = v - cv0, cv1 - v
    e = lambda t: t[..., None]                          # noqa: E731
    s = e(wv0) * (e(wu0) * a + e(wu1) * b) + e(wv1) * (e(wu0) * c
                                                         + e(wu1) * d)
    du = (e(wv0 * m) * (b - a) + e(wv1 * m) * (d - c)) * e(cu1 - cu0)
    dv = (e(wu0) * (c - a) + e(wu1) * (d - b)) * e(cv1 - cv0)
    return s, du, dv


def window_rows(A: int) -> int:
    """The row window of the banded deployment's sampler for an A x A map."""
    return min(A, ((int(A * 0.47) + 13) // 8) * 8)


def line_rows_valid(uv, A: int):
    """[B, V, 1] bool: the rows the banded sampler serves, from each row's
    line through its samples at u = 0 and u = 1: in map (row, column) =
    (v, u) terms, the line's run across rows per column step stays under
    0.95 and, over its in-map part, it spans at most RB - 3 columns of u."""
    W = uv.shape[2]
    u0, v0 = uv[:, :, 0, 0], uv[:, :, 0, 1]
    bu, bv = uv[:, :, 1, 0] - u0, uv[:, :, 1, 1] - v0

    def safe(t):
        return torch.where(t.abs() > 1e-12, t,
                           torch.where(t >= 0, 1e-12, -1e-12))

    def span(a, b):
        lo, hi = (0.0 - a) / safe(b), (A - 1.0 - a) / safe(b)
        return torch.minimum(lo, hi), torch.maximum(lo, hi)

    (l1, h1), (l2, h2) = span(v0, bv), span(u0, bu)
    lo = torch.clamp_min(torch.maximum(l1, l2), 0.0)
    hi = torch.maximum(torch.clamp_max(torch.minimum(h1, h2), W - 1.0), lo)
    ya, yb = u0 + bu * lo, u0 + bu * hi
    ymin = torch.clamp(torch.minimum(ya, yb), 0.0, A - 1.0)
    ymax = torch.clamp(torch.maximum(ya, yb), 0.0, A - 1.0)
    ok = ((bu / safe(bv)).abs() < 0.95) & (ymax - ymin <= window_rows(A) - 3)
    return ok[..., None]


def line_cells(uv, A: int):
    """The bilinear cells the banded deployment samples at uv [B, V, W, 2]:
    top-left (row, column) int64 [B, V, W] (zero where dropped), the
    fractions along u and v, and the mask [B, V, W]: the rows
    ``line_rows_valid`` drops and the samples on the map's last row or
    column are out."""
    u, v = uv[..., 0], uv[..., 1]
    fu, fv = torch.floor(u), torch.floor(v)
    m = ((u >= 0) & (u <= A - 1) & (v >= 0) & (v <= A - 1) & (fu < A - 1)
         & (fv < A - 1) & line_rows_valid(uv, A)).float()
    keep = m > 0
    c0 = torch.where(keep, fu, torch.zeros_like(fu)).long()
    r0 = torch.where(keep, fv, torch.zeros_like(fv)).long()
    return r0, c0, u - fu, v - fv, m


def sample_line(img, uv, bf16_map: bool):
    """Bilinear value and d/du, d/dv [B, V, W, C] of img [B, A, A, C] at uv
    as the banded deployment samples (``line_cells``); with ``bf16_map``
    the map's values are rounded to bfloat16 and its gradient stays
    float32."""
    A = img.shape[1]
    if bf16_map:
        img = img + (img.to(torch.bfloat16).float() - img).detach()
    r0, c0, xu, xv, m = line_cells(uv, A)
    a, b, c, d = _corners(img, r0, c0)
    xu, xv, mm = xu[..., None], xv[..., None], m[..., None]
    s = mm * ((1 - xv) * ((1 - xu) * a + xu * b) + xv * ((1 - xu) * c
                                                          + xu * d))
    du = mm * ((1 - xv) * (b - a) + xv * (d - c))
    dv = mm * ((1 - xu) * (c - a) + xu * (d - b))
    return s, du, dv


def lm_step(pose, s, du, dv, grd, mask, duv, draws, damping: float = 0.1):
    """One damped Gauss-Newton step of the normalized residual over the
    pixels under mask [V, W] (samples s, du, dv and target grd [B, V, W, C],
    float32; duv [B, V, W, 2, 3]), then the re-init of shifts out of range
    from draws [2, B]."""
    m = mask[None, :, :, None]
    g = grd.float() * m
    s, du, dv = s * m, du * m, dv * m
    B = pose.shape[0]
    ns = torch.sqrt(torch.clamp_min((s * s).sum((1, 2, 3)), 1e-12))
    ng = torch.sqrt(torch.clamp_min((g * g).sum((1, 2, 3)), 1e-12))
    bcast = lambda t: t[:, None, None, None]             # noqa: E731
    r = s / bcast(ns) - g / bcast(ng)                    # [B, V, W, C]
    # J[p, c, :] = (du[p, c] duv_u[p, :] + dv[p, c] duv_v[p, :]) / ns
    Du, Dv = duv[..., 0, :], duv[..., 1, :]              # [B, V, W, 3]
    suu, suv, svv = (du * du).sum(-1), (du * dv).sum(-1), (dv * dv).sum(-1)
    ru, rv = (du * r).sum(-1), (dv * r).sum(-1)          # [B, V, W]

    def outer(X, Y, w):
        return (X[..., :, None] * Y[..., None, :] * w[..., None, None]).sum(
            (1, 2))

    H = (outer(Du, Du, suu) + outer(Du, Dv, suv) + outer(Dv, Du, suv)
         + outer(Dv, Dv, svv)) / (ns * ns)[:, None, None]
    grad = ((Du * ru[..., None]).sum((1, 2))
            + (Dv * rv[..., None]).sum((1, 2))) / ns[:, None]
    eye = torch.eye(3, dtype=torch.float32, device=pose.device)
    delta = torch.linalg.solve(H + damping * eye, grad[..., None])[..., 0]
    new = pose - delta
    lim = REINIT
    keep_u = (new[:, 0] > -lim) & (new[:, 0] < lim)
    keep_v = (new[:, 1] > -lim) & (new[:, 1] < lim)
    return torch.stack([torch.where(keep_u, new[:, 0], draws[0]),
                        torch.where(keep_v, new[:, 1], draws[1]),
                        new[:, 2]], -1)


def trajectory(params, sat, grd, cfg: dict, draws, mode: str,
               rule: str = "line", rows=None):
    """The poses of every round [B, N_iters, 3, 3] (iteration, level,
    (shift_u, shift_v, heading)) from zero, for sat [B, A, A, 3] and grd
    [B, H, W, 3] float32 images in [0, 1].

    cfg: the deployment's sizes and ranges (``sat_size``, ``grd_h``,
    ``grd_w``, ``N_iters``, ``shift_range_lat``, ``shift_range_lon``,
    ``rotation_range``, ``damping``, ``banded_bf16_map``); draws(t) gives
    round t's uniform numbers [2, B]; mode: ``vgg.features``' precision;
    rule: ``line`` or ``gather``; rows: the images whose poses are solved
    (default all; the features are computed for every image given).
    Differentiable in params under autograd.
    """
    slots = (0, 1, 2)
    sat_f = vgg.features(params, "SatFeatureNet.", sat, slots, mode)
    grd_f = vgg.features(params, "GrdFeatureNet.", grd, slots, mode)
    if rows is not None:
        sat_f, grd_f = [f[rows] for f in sat_f], [f[rows] for f in grd_f]
    ranges = (cfg["rotation_range"], cfg["shift_range_lat"],
              cfg["shift_range_lon"])
    dev = sat.device
    levels = []
    for lvl, slot in enumerate(slots):
        h, w = grd_f[lvl].shape[1:3]
        xyz, mask = rays(h, w, cfg["grd_h"], cfg["grd_w"])
        half = h // 2
        levels.append((torch.from_numpy(xyz[half:]).to(dev),
                       torch.from_numpy(mask[half:]).to(dev),
                       sat_f[lvl].float(), grd_f[lvl][:, half:].float()))
    B = sat_f[0].shape[0]
    pose = torch.zeros(B, 3, dtype=torch.float32, device=dev)
    traj, t = [], 0
    for _ in range(cfg["N_iters"]):
        for xyz, mask, sat_l, grd_l in levels:
            if rule == "line":
                uv, duv = row_lines(pose, xyz, sat_l.shape[1], ranges)
                s, du, dv = sample_line(sat_l, uv,
                                        bool(cfg["banded_bf16_map"]))
            else:
                uv, duv = uv_jac(pose, xyz, sat_l.shape[1], ranges)
                s, du, dv = sample_gather(sat_l, uv)
            pose = lm_step(pose, s, du, dv, grd_l, mask, duv, draws(t),
                           cfg["damping"])
            traj.append(pose)
            t += 1
    return torch.stack(traj, 1).reshape(B, cfg["N_iters"], len(slots), 3)


def loss(traj, gt_pose, coe: float = 100.0):
    """Loss method 0 of each sample [B]: the mean over (iteration, level)
    of coe times the absolute error of each pose term."""
    return coe * (traj - gt_pose[:, None, None, :]).abs().sum(-1).mean((1, 2))


# --- what the harness asks of the family -----------------------------------

MODEL_CLASS = "highlyaccurate_tpu_torch.models.lm_s2gp.LMS2GP"
# the trajectory's pose terms as keys of ``Localizer.predict``'s output, and
# the ranges that normalize each
POSE_KEYS = ("longitudinal_m", "lateral_m", "heading_deg")
POSE_RANGES = ("shift_range_lon", "shift_range_lat", "rotation_range")


def reinit_draws(cfg: dict) -> tuple:
    """(rounds, uniform numbers an image a round) that the program's
    generator draws per call for the re-init: two a round, one per
    shift."""
    return cfg["N_iters"] * 3, 2


def initial_damping(cfg: dict) -> float:
    """The solver's damping weight as the model initialises it."""
    return 0.0


def localizer_inputs(cfg: dict) -> dict:
    """``Localizer`` keyword arguments beside the configuration."""
    return {}


def step_inputs(cfg: dict, batch: int) -> tuple:
    """Host arrays the train step takes after the frames, before the
    ground-truth pose."""
    return ()


def step_options(cfg: dict) -> dict:
    """``make_train_step`` keyword arguments beside the model and
    configuration."""
    return {}


def touched_cells(r0, c0, m, side: int) -> int:
    """How many map cells the 2x2 blocks at (r0, c0) of the samples m
    keeps touch, on a map ``side`` cells wide."""
    keep = m.reshape(-1) > 0
    base = (r0 * side + c0).reshape(-1)[keep]
    return int(torch.cat([base, base + 1, base + side,
                          base + side + 1]).unique().numel())


def map_cells(cfg: dict) -> tuple:
    """Per level, the satellite map cells the kept rows' samples touch at
    the zero pose: what one image's banded sampling must read of its map
    (the footprint moves with the pose; its size stays)."""
    return _map_cells(tuple(sorted(cfg.items())))


@functools.lru_cache(maxsize=None)
def _map_cells(items: tuple) -> tuple:
    cfg = dict(items)
    ranges = (cfg["rotation_range"], cfg["shift_range_lat"],
              cfg["shift_range_lon"])
    out = []
    for A, C, h, w in vgg.levels(cfg):
        xyz, mask = rays(h, w, cfg["grd_h"], cfg["grd_w"])
        uv, _ = uv_jac(torch.zeros(1, 3), torch.from_numpy(
            xyz[h // 2:]), A, ranges)
        r0, c0, _, _, m = line_cells(uv, A)
        out.append(touched_cells(r0, c0, m * torch.from_numpy(
            mask[h // 2:]), A))
    return tuple(out)
