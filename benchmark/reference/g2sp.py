"""Plain KITTI LM_G2SP of HighlyAccurate (CVPR 2022, ``models_kitti.py``
of github.com/YujiaoShi/HighlyAccurate): the ground-to-satellite
projection and the unrolled Levenberg-Marquardt solver, per pixel and in
float32, on the features of ``vgg.features``.

Each of the N_iters x 3 rounds (iteration-major, levels coarse to fine)
puts the ground plane under every satellite pixel of the columns that can
see the camera (``first_column``), projects those points into the ground
feature map through the camera (K [R(-heading) | T]), samples the ground
features there with their screen derivatives, and takes one damped
Gauss-Newton step on the residual r = sample - satellite feature (no
normalization, damping 0.1 on each pose term, no re-init).

The banded deployment's sampler (``use_banded_warp=1``): each satellite
column is a line in the ground map; a column whose image line is steeper
than 0.95, spans more rows than the map minus 3, or has no in-map part is
dropped, and a sample behind the camera, outside the map or on its last
row or column reads zero; the map is read in bfloat16 (its gradient stays
float32).

Training scores the trajectory as S2GP does (``loss``).  What the harness
asks of a family is listed in ``s2gp``'s docstring.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from benchmark.reference import vgg
from benchmark.reference.s2gp import (  # noqa: F401 (the family's answers)
    CAMERA_HEIGHT, POSE_KEYS, POSE_RANGES, loss, meter_per_pixel,
    step_options, touched_cells)

DEFAULT_K = np.array([[582.9802, 0.0, 496.2420],
                      [0.0, 482.7076, 125.0034],
                      [0.0, 0.0, 1.0]], np.float32)


def ground_points(A: int) -> np.ndarray:
    """[A (row i, south), A (column j, east), 4] homogeneous ground points
    (X south, Y = 0, Z east) under the satellite pixels, float32."""
    i = np.arange(A, dtype=np.float64) - A // 2
    ii, jj = np.meshgrid(i, i, indexing="ij")
    mpp = meter_per_pixel(A)
    return np.stack([mpp * ii, np.zeros_like(ii), mpp * jj,
                     np.ones_like(ii)], -1).astype(np.float32)


def first_column(A: int, h: int, w: int, ranges, margin: float = 1.5,
                 align: int = 8, slack: float = 1.1) -> int:
    """The westmost satellite column that can project into an h x w ground
    map for any pose within ``margin`` x the ranges (a 5^3 grid of poses,
    focal lengths over ``slack``, 1 px of image and 2 px of bilinear slop),
    aligned down to ``align``; the columns west of it never see the
    camera."""
    rot, lat, lon = ranges
    k = DEFAULT_K.astype(np.float64).copy()
    k[0, 0] /= slack
    k[1, 1] /= slack
    k[0] *= w / 1024.0
    k[1] *= h / 256.0
    X = ground_points(A).astype(np.float64)
    vals = np.array([-margin, -margin / 2, 0.0, margin / 2, margin])
    jmin = A
    for su, sv, th in itertools.product(vals, repeat=3):
        a = -th * rot / 180.0 * np.pi
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
        T = np.array([[sv * lat], [CAMERA_HEIGHT], [-su * lon]])
        p = X @ (k @ np.concatenate([R, T], 1)).T
        front = p[..., 2] > 1e-6
        den = np.maximum(p[..., 2], 1e-6)
        u, v = p[..., 0] / den, p[..., 1] / den
        inb = front & (u > -1) & (u < w + 1) & (v > -1) & (v < h + 1)
        js = np.where(inb.any(0))[0]
        if len(js):
            jmin = min(jmin, int(js.min()))
    return (max(jmin - 2, 0) // align) * align


def projection(pose, k, ranges):
    """P = k [R(-heading) | T] [B, 3, 4] of pose [B, 3] (normalized) with
    k [B, 3, 3] the intrinsics of the feature map, and dP/dpose
    [B, 3, 3, 4]."""
    rot, lat, lon = ranges
    r = rot / 180.0 * math.pi
    a = -pose[:, 2] * r
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([c, z, -s, z, o, z, s, z, c], -1).view(-1, 3, 3)
    T = torch.stack([pose[:, 1] * lat, CAMERA_HEIGHT * o,
                     -pose[:, 0] * lon], -1)
    dR = torch.stack([s, z, c, z, z, z, -c, z, s], -1).view(-1, 3, 3) * r
    zc = torch.zeros_like(T)
    dM = torch.stack([
        torch.cat([torch.zeros_like(R), torch.stack(
            [z, z, -lon * o], -1)[..., None]], -1),
        torch.cat([torch.zeros_like(R), torch.stack(
            [lat * o, z, z], -1)[..., None]], -1),
        torch.cat([dR, zc[..., None]], -1)], 1)          # [B, 3, 3, 4]
    P = (k[:, :, :, None] * torch.cat([R, T[..., None]], -1)[:, None]).sum(2)
    dP = (k[:, None, :, :, None] * dM[:, :, None]).sum(3)
    return P, dP


def lines_valid(P, X0, X1, h: int, w: int, W: int):
    """[B, V, 1] bool: the satellite columns the banded sampler serves,
    from the images h0 = P X0 and h1 = P X1 of each column's first two
    points (X0, X1 [V, 4])."""
    eps = 1e-6
    h0 = (P[:, None] * X0[None, :, None, :]).sum(-1)      # [B, V, 3]
    dh = (P[:, None] * (X1 - X0)[None, :, None, :]).sum(-1)
    nx0, ny0, d0 = h0.unbind(-1)
    dnx, dny, dd = dh.unbind(-1)
    h1x, h1y, h1z = nx0 + dnx, ny0 + dny, d0 + dd
    la, lb = ny0 * h1z - d0 * h1y, d0 * h1x - nx0 * h1z
    sgn = lambda t: torch.where(t >= 0, eps, -eps)        # noqa: E731
    slope = -la / torch.where(lb.abs() > eps, lb, sgn(lb))
    ca = torch.stack([d0 - eps, nx0, (w - 1.0) * d0 - nx0, ny0,
                      (h - 1.0) * d0 - ny0], -1)
    cb = torch.stack([dd, dnx, (w - 1.0) * dd - dnx, dny,
                      (h - 1.0) * dd - dny], -1)
    pos, neg = cb > eps, cb < -eps
    ratio = -ca / torch.where(cb.abs() > eps, cb, torch.ones_like(cb))
    lo = torch.clamp_min(torch.where(pos, ratio, 0.0).amax(-1), 0.0)
    hi = torch.clamp_max(torch.where(neg, ratio, W - 1.0).amin(-1), W - 1.0)
    flat = ((~pos) & (~neg) & (ca < 0)).any(-1)

    def y_at(u):
        den = d0 + dd * u
        return (ny0 + dny * u) / torch.where(den > eps, den,
                                             torch.ones_like(den))

    ya, yb = y_at(lo), y_at(hi)
    ymin = torch.clamp(torch.minimum(ya, yb), 0.0, h - 1.0)
    ymax = torch.clamp(torch.maximum(ya, yb), 0.0, h - 1.0)
    ok = ((hi >= lo) & ~flat & (slope.abs() < 0.95)
          & (ymax - ymin <= h - 3) & (lb.abs() > eps))
    return ok[..., None]


def sample(img, x, y, m):
    """Bilinear value and d/dx, d/dy [B, V, W, C] of img [B, h, w, C] at
    x, y, zero where m is 0."""
    B, h, w, C = img.shape
    keep = m > 0
    x0 = torch.where(keep, torch.floor(x), torch.zeros_like(x))
    y0 = torch.where(keep, torch.floor(y), torch.zeros_like(y))
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    flat = img.reshape(B, h * w, C)
    idx = (y0.long() * w + x0.long()).reshape(B, -1)

    def at(off):
        g = torch.gather(flat, 1, (idx + off)[..., None].expand(-1, -1, C))
        return g.reshape(*x.shape, C).float()

    a, b, c, d = at(0), at(1), at(w), at(w + 1)
    mm = m[..., None]
    s = mm * ((1 - fy) * ((1 - fx) * a + fx * b) + fy * ((1 - fx) * c
                                                         + fx * d))
    dx = mm * ((1 - fy) * (b - a) + fy * (d - c))
    dy = mm * ((1 - fx) * (c - a) + fx * (d - b))
    return s, dx, dy


def image_points(P, X, valid, h: int, w: int):
    """The images x, y [B, V, W] of the ground points X [V, W, 4] under P
    [B, 3, 4], their depth z (floored at 1e-6), whether each is in front
    of the camera, and the mask of the samples the banded sampler reads:
    its column ``valid`` [B, V, 1], in front, in the h x w map and clear of
    its last row and column."""
    p = (P[:, None, None] * X[None, :, :, None, :]).sum(-1)   # [B, V, W, 3]
    front = p[..., 2] > 1e-6
    z = torch.clamp_min(p[..., 2], 1e-6)
    x, y = p[..., 0] / z, p[..., 1] / z
    m = (front & valid & (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
         & (torch.floor(x) < w - 1) & (torch.floor(y) < h - 1)).float()
    return x, y, z, front, m


def lm_step(pose, P, dP, X, grd_map, target, valid, damping: float = 0.1):
    """One damped Gauss-Newton step: the ground map [B, h, w, C] sampled at
    the images of the ground points X [V, W, 4] under P, against the
    satellite features ``target`` [B, V, W, C]."""
    h, w = grd_map.shape[1:3]
    x, y, z, front, m = image_points(P, X, valid, h, w)
    s, sx, sy = sample(grd_map, x, y, m)
    # d(x, y)/dpose by the quotient rule, zero behind the camera
    dp = (dP[:, :, None, None] * X[None, None, :, :, None, :]).sum(-1)
    dxy = (dp[..., :2] - torch.stack([x, y], -1)[:, None]
           * dp[..., 2:]) / z[:, None, ..., None]        # [B, 3, V, W, 2]
    dxy = torch.where(front[:, None, ..., None], dxy, torch.zeros_like(dxy))
    Dx, Dy = dxy[..., 0].permute(0, 2, 3, 1), dxy[..., 1].permute(0, 2, 3, 1)
    r = s - target.float()
    sxx, sxy, syy = (sx * sx).sum(-1), (sx * sy).sum(-1), (sy * sy).sum(-1)
    rx, ry = (sx * r).sum(-1), (sy * r).sum(-1)

    def outer(A_, B_, wt):
        return (A_[..., :, None] * B_[..., None, :] * wt[..., None, None]
                ).sum((1, 2))

    H = (outer(Dx, Dx, sxx) + outer(Dx, Dy, sxy) + outer(Dy, Dx, sxy)
         + outer(Dy, Dy, syy))
    g = (Dx * rx[..., None]).sum((1, 2)) + (Dy * ry[..., None]).sum((1, 2))
    eye = torch.eye(3, dtype=torch.float32, device=pose.device)
    return pose - torch.linalg.solve(H + damping * eye, g[..., None])[..., 0]


def level_geometry(cfg: dict, A: int, h: int, w: int, device):
    """(X [V, A, 4] ground points of the served columns in line order,
    k [3, 3] the intrinsics of the h x w map, j0 the first column)."""
    ranges = (cfg["rotation_range"], cfg["shift_range_lat"],
              cfg["shift_range_lon"])
    j0 = first_column(A, h, w, ranges) if cfg["g2sp_restrict_grid"] else 0
    X = torch.from_numpy(np.ascontiguousarray(
        ground_points(A)[:, j0:].transpose(1, 0, 2))).to(device)
    k = DEFAULT_K * np.array([[cfg["grd_w"] / 1024.0 * w / cfg["grd_w"]],
                              [cfg["grd_h"] / 256.0 * h / cfg["grd_h"]],
                              [1.0]], np.float32)
    return X, torch.from_numpy(k.astype(np.float32)).to(device), j0


def trajectory(params, sat, grd, cfg: dict, draws=None,
               mode: str = "float32", rule: str = "line", rows=None):
    """The poses of every round [B, N_iters, 3, 3] from zero for sat
    [B, A, A, 3] and grd [B, H, W, 3] float32 images in [0, 1] (``rule``
    ``line``: the banded deployment's column restriction and sampler; no
    other rule is served here), of the images ``rows`` (default all)."""
    slots = (0, 1, 2)
    sat_f = vgg.features(params, "SatFeatureNet.", sat, slots, mode)
    grd_f = vgg.features(params, "GrdFeatureNet.", grd, slots, mode)
    if rows is not None:
        sat_f, grd_f = [f[rows] for f in sat_f], [f[rows] for f in grd_f]
    ranges = (cfg["rotation_range"], cfg["shift_range_lat"],
              cfg["shift_range_lon"])
    dev = sat.device
    levels = []
    for lvl in range(len(slots)):
        A = sat_f[lvl].shape[1]
        h, w = grd_f[lvl].shape[1:3]
        X, k, j0 = level_geometry(cfg, A, h, w, dev)
        gmap = grd_f[lvl].float()
        if rule == "line":      # read in bf16, differentiated in float32
            gmap = gmap + (gmap.to(torch.bfloat16).float() - gmap).detach()
        levels.append((X, k[None].expand(gmap.shape[0], 3, 3), gmap,
                       sat_f[lvl].float()[:, :, j0:].transpose(1, 2)))
    B = sat_f[0].shape[0]
    pose = torch.zeros(B, 3, dtype=torch.float32, device=dev)
    traj = []
    for _ in range(cfg["N_iters"]):
        for X, k, gmap, target in levels:
            P, dP = projection(pose, k, ranges)
            h, w = gmap.shape[1:3]
            valid = lines_valid(P, X[:, 0], X[:, 1], h, w, X.shape[1])
            pose = lm_step(pose, P, dP, X, gmap, target, valid,
                           cfg["damping"])
            traj.append(pose)
    return torch.stack(traj, 1).reshape(B, cfg["N_iters"], len(slots), 3)


# --- what the harness asks of the family -----------------------------------
# (``POSE_KEYS``, ``POSE_RANGES``, ``loss`` and ``step_options`` are
# S2GP's, imported above: the same pose order, loss and step keywords)

MODEL_CLASS = "highlyaccurate_tpu_torch.models.lm_g2sp.LMG2SP"


def reinit_draws(cfg: dict) -> tuple:
    """(rounds, uniform numbers an image a round) that the program's
    generator draws per call: G2SP never re-inits."""
    return cfg["N_iters"] * 3, 0


def initial_damping(cfg: dict) -> float:
    """The solver's damping weight as the model initialises it: the
    configuration's."""
    return cfg["damping"]


def camera_k(cfg: dict) -> np.ndarray:
    """The default KITTI intrinsics (of the 1024 x 256 input) scaled to
    the configured input."""
    k = DEFAULT_K.copy()
    k[0] *= cfg["grd_w"] / 1024.0
    k[1] *= cfg["grd_h"] / 256.0
    return k


def localizer_inputs(cfg: dict) -> dict:
    """``Localizer`` keyword arguments beside the configuration: the
    camera of every call."""
    return {"camera_k": camera_k(cfg)}


def step_inputs(cfg: dict, batch: int) -> tuple:
    """Host arrays the train step takes after the frames: every image's
    camera [B, 3, 3]."""
    return (np.repeat(camera_k(cfg)[None], batch, 0),)


def _zero_pose(cfg: dict, A: int, h: int, w: int):
    """The samples of one level at the zero pose: the ground map cells'
    top-left corners r0, c0 and the banded sampler's mask [1, V, A], and V,
    the satellite columns served."""
    ranges = (cfg["rotation_range"], cfg["shift_range_lat"],
              cfg["shift_range_lon"])
    X, k, _ = level_geometry(cfg, A, h, w, "cpu")
    P, _ = projection(torch.zeros(1, 3), k[None], ranges)
    valid = lines_valid(P, X[:, 0], X[:, 1], h, w, X.shape[1])
    x, y, _, _, m = image_points(P, X, valid, h, w)
    keep = m > 0
    r0 = torch.where(keep, torch.floor(y), torch.zeros_like(y)).long()
    c0 = torch.where(keep, torch.floor(x), torch.zeros_like(x)).long()
    return r0, c0, m, X.shape[0]


def map_cells(cfg: dict) -> tuple:
    """Per level, (the ground map cells the served satellite columns'
    samples touch at the zero pose, the columns served), under the
    route's ``g2sp_restrict_grid``."""
    return _footprint(tuple(sorted(cfg.items())))[0]


def kept_samples(cfg: dict) -> tuple:
    """Per level, the samples the banded sampler keeps at the zero pose
    (in the map, in front of the camera, on a served line)."""
    return _footprint(tuple(sorted(cfg.items())))[1]


@functools.lru_cache(maxsize=None)
def _footprint(items: tuple) -> tuple:
    cfg = dict(items)
    cells, kept = [], []
    for A, C, h, w in vgg.levels(cfg):
        r0, c0, m, V = _zero_pose(cfg, A, h, w)
        cells.append((touched_cells(r0, c0, m, w), V))
        kept.append(int((m > 0).sum()))
    return tuple(cells), tuple(kept)
