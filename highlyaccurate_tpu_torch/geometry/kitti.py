"""KITTI geometry (port of ``highlyaccurate_tpu/geometry/kitti.py:31-193``
for S2GP and ``:195-397`` for G2SP).

Ground-plane rays (S2GP: the geo projection's and the polar
parameterization of ``proj`` polar and nn), the ground points under
satellite pixels and the G2SP in-view column bound are precomputed on the
host in numpy exactly as the JAX package does; the pose -> pixel
projections and their closed-form Jacobians (G2SP ``proj="nn"``: the
in-plane SE(2) warp) are torch functions of the pose on the pose's device.

Layouts follow the JAX package: pose [B, 3] = (shift_u, shift_v, heading)
in normalized units, uv [B, H, W, 2], d(uv)/d(pose) [B, H, W, 2, 3].
Frames: camera +x south, +y down, +z forward; satellite pixels u east,
v south, origin at the patch's top-left.  Small products (3x3 by 3x4, a
3x4 matrix against 4-vectors) are written as broadcast sums, so no matrix
product (and no TF32 mode) is involved on the GPU.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from highlyaccurate_tpu_torch.utils import geo

# The reference uses one fixed K for ray precomputation regardless of the
# per-drive calibration (models_kitti.py:657-660) — preserved exactly.
DEFAULT_CAMERA_K = np.array(
    [[582.9802, 0.0, 496.2420],
     [0.0, 482.7076, 125.0034],
     [0.0, 0.0, 1.0]], dtype=np.float32)


def grd_img2cam(grd_H: int, grd_W: int, ori_grdH: int, ori_grdW: int,
                camera_k: np.ndarray | None = None):
    """Per-pixel ground-plane ray intersections in the camera frame.

    Returns host numpy arrays: xyz_grd [H, W, 3] (ground-plane point of each
    ground pixel), mask [H, W] (1.0 where the ray points forward) and
    xyz_w [H, W, 3] (unit-depth ray).
    """
    if camera_k is None:
        camera_k = DEFAULT_CAMERA_K
    k = camera_k.astype(np.float64).copy()
    k[0, :] *= grd_W / ori_grdW
    k[1, :] *= grd_H / ori_grdH
    k_inv = np.linalg.inv(k)

    v, u = np.meshgrid(np.arange(grd_H, dtype=np.float64),
                       np.arange(grd_W, dtype=np.float64), indexing="ij")
    uv1 = np.stack([u, v, np.ones_like(u)], axis=-1)  # [H, W, 3]
    xyz_w = uv1 @ k_inv.T  # [H, W, 3]

    denom = np.where(np.abs(xyz_w[..., 1:2]) > geo.EPS, xyz_w[..., 1:2], geo.EPS)
    w = geo.CAMERA_HEIGHT / denom
    xyz_grd = xyz_w * w
    mask = (xyz_grd[..., 2] > 0).astype(np.float32)
    return xyz_grd.astype(np.float32), mask, xyz_w.astype(np.float32)


def grd_img2cam_polar(grd_H: int, grd_W: int, max_radius: float = 30.0):
    """Polar ground-plane parameterization (reference
    models_kitti.py:684-698) of every non-geo ``proj``: host numpy xyz_grd
    [H, W, 3] (row v at radius (1 - v/H) * max_radius, column u at angle
    u/W * pi/4, on the plane y = camera height) and an all-ones mask
    [H, W].  No unit-depth rays go with them (the ``gt_depth`` lift is
    geo's)."""
    v, u = np.meshgrid(np.arange(grd_H, dtype=np.float64),
                       np.arange(grd_W, dtype=np.float64), indexing="ij")
    theta = u / grd_W * np.pi / 4
    radius = (1 - v / grd_H) * max_radius
    z = radius * np.cos(np.pi / 4 - theta)
    x = -radius * np.sin(np.pi / 4 - theta)
    y = geo.CAMERA_HEIGHT * np.ones_like(z)
    xyz_grd = np.stack([x, y, z], axis=-1).astype(np.float32)
    return xyz_grd, np.ones((grd_H, grd_W), dtype=np.float32)


def pose_to_cam2world(pose, rotation_range: float, shift_range_lat: float,
                      shift_range_lon: float):
    """Camera->world rotation R [B, 3, 3] and translation T [B, 3] of a
    normalized pose: R = Ry(heading), T = -R @ [shift_v, h_cam, -shift_u]
    (reference models_kitti.py:718-737)."""
    heading = pose[:, 2] * (rotation_range / 180.0 * np.pi)
    shift_u = pose[:, 0] * shift_range_lon
    shift_v = pose[:, 1] * shift_range_lat

    cos, sin = torch.cos(heading), torch.sin(heading)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    R = torch.stack([cos, zeros, -sin,
                     zeros, ones, zeros,
                     sin, zeros, cos], dim=-1).reshape(-1, 3, 3)
    height = geo.CAMERA_HEIGHT * ones
    T0 = torch.stack([shift_v, height, -shift_u], dim=-1)  # [B, 3]
    T = -torch.einsum("bij,bj->bi", R, T0)
    return R, T


def _meter_per_pixel(satmap_sidelength: int) -> float:
    return geo.get_meter_per_pixel() * (
        geo.get_process_satmap_sidelength() / satmap_sidelength)


def _rotate(R, xyz_grd):
    """R [B, 3, 3] applied to [H, W, 3] or [B, H, W, 3] points."""
    if xyz_grd.dim() == 3:
        return torch.einsum("bij,hwj->bhwi", R, xyz_grd)
    return torch.einsum("bij,bhwj->bhwi", R, xyz_grd)


def s2gp_uv(pose, xyz_grd, satmap_sidelength: int, rotation_range: float,
            shift_range_lat: float, shift_range_lon: float):
    """Satellite pixel coords [B, H, W, 2] of each ground point under pose
    (reference models_kitti.py:700-766, without the Jacobian)."""
    R, T = pose_to_cam2world(pose, rotation_range, shift_range_lat,
                             shift_range_lon)
    xyz = _rotate(R, xyz_grd) + T[:, None, None, :]
    zx = torch.stack([xyz[..., 2], xyz[..., 0]], dim=-1)
    return zx / _meter_per_pixel(satmap_sidelength) + satmap_sidelength / 2


def s2gp_uv_jac(pose, xyz_grd, satmap_sidelength: int, rotation_range: float,
                shift_range_lat: float, shift_range_lon: float):
    """``s2gp_uv`` plus the closed-form Jacobian d(uv)/d(pose).

    Returns sat_uv [B, H, W, 2] and duv_dpose [B, H, W, 2, 3].
    """
    heading = pose[:, 2] * (rotation_range / 180.0 * np.pi)
    cos, sin = torch.cos(heading), torch.sin(heading)
    zeros = torch.zeros_like(cos)
    R, T = pose_to_cam2world(pose, rotation_range, shift_range_lat,
                             shift_range_lon)
    xyz = _rotate(R, xyz_grd) + T[:, None, None, :]
    zx = torch.stack([xyz[..., 2], xyz[..., 0]], dim=-1)

    meter_per_pixel = _meter_per_pixel(satmap_sidelength)
    sat_uv = zx / meter_per_pixel + satmap_sidelength / 2

    # d(xyz)/d(shift): T = -R @ T0, dT0/du = [0, 0, -shift_range_lon],
    # dT0/dv = [shift_range_lat, 0, 0]
    rot_scale = rotation_range / 180.0 * np.pi
    f32 = dict(dtype=pose.dtype, device=pose.device)
    dT0_du = torch.tensor([0.0, 0.0, -1.0], **f32) * shift_range_lon
    dT0_dv = torch.tensor([1.0, 0.0, 0.0], **f32) * shift_range_lat
    dxyz_du = -torch.einsum("bij,j->bi", R, dT0_du)  # [B, 3]
    dxyz_dv = -torch.einsum("bij,j->bi", R, dT0_dv)  # [B, 3]

    dR_dtheta = rot_scale * torch.stack(
        [-sin, zeros, -cos,
         zeros, zeros, zeros,
         cos, zeros, -sin], dim=-1).reshape(-1, 3, 3)
    shift_u = pose[:, 0] * shift_range_lon
    shift_v = pose[:, 1] * shift_range_lat
    height = geo.CAMERA_HEIGHT * torch.ones_like(shift_u)
    T0 = torch.stack([shift_v, height, -shift_u], dim=-1)
    dT_dtheta = -torch.einsum("bij,bj->bi", dR_dtheta, T0)  # [B, 3]
    dxyz_dtheta = _rotate(dR_dtheta, xyz_grd) + dT_dtheta[:, None, None, :]

    # uv = [xyz.z, xyz.x] / mpp + A/2 -> duv = [dxyz.z, dxyz.x] / mpp
    def to_uv(dxyz):
        return torch.stack([dxyz[..., 2], dxyz[..., 0]], dim=-1) / meter_per_pixel

    duv_du = to_uv(dxyz_du)[:, None, None, :].expand_as(sat_uv)
    duv_dv = to_uv(dxyz_dv)[:, None, None, :].expand_as(sat_uv)
    duv_dtheta = to_uv(dxyz_dtheta)

    duv_dpose = torch.stack([duv_du, duv_dv, duv_dtheta], dim=-1)  # [B,H,W,2,3]
    return sat_uv, duv_dpose


def warp_sat2real(satmap_sidelength: int) -> np.ndarray:
    """Ground-plane point under each satellite pixel (G2SP; reference
    models_kitti.py:54-84): XYZ1 [A(i, south), A(j, east), 4] float32
    homogeneous world points on the Y = 0 plane.  Host numpy."""
    i = np.arange(satmap_sidelength, dtype=np.float64)
    ii, jj = np.meshgrid(i, i, indexing="ij")
    u0 = v0 = satmap_sidelength // 2
    uc, vc = jj - u0, ii - v0
    mpp = _meter_per_pixel(satmap_sidelength)
    X = mpp * vc   # south
    Z = mpp * uc   # east
    Y = np.zeros_like(X)
    return np.stack([X, Y, Z, np.ones_like(X)], axis=-1).astype(np.float32)


def g2sp_inview_col_start(A: int, grd_H: int, grd_W: int,
                          rotation_range: float, shift_range_lat: float,
                          shift_range_lon: float, margin: float = 1.5,
                          align: int = 8, fov_slack: float = 1.1) -> int:
    """Westmost satellite column j0 that can ever project into the ground
    image of size grd_H x grd_W (the level's feature map) for a pose within
    ``margin`` x the ranges: columns west of it give zero rows of the LM
    Jacobian and are dropped.  The bound is the union over a 5^3 pose grid
    with the default K's focal lengths divided by ``fov_slack``, a 1-px
    image slop, a 2-px bilinear slop, aligned down to ``align``.  Host
    numpy, the same arithmetic as the JAX package, so the same j0."""
    k = DEFAULT_CAMERA_K.astype(np.float64).copy()
    k[0, 0] /= fov_slack
    k[1, 1] /= fov_slack
    k[0, :] *= grd_W / 1024.0
    k[1, :] *= grd_H / 256.0
    XYZ1 = warp_sat2real(A).astype(np.float64)
    rot_scale = rotation_range / 180.0 * np.pi
    vals = np.array([-margin, -margin / 2, 0.0, margin / 2, margin])
    jmin = A
    for su, sv, th in itertools.product(vals, repeat=3):
        heading = -th * rot_scale  # G2SP rotates by -heading (g2sp_P)
        cos, sin = np.cos(heading), np.sin(heading)
        R = np.array([[cos, 0.0, -sin], [0.0, 1.0, 0.0], [sin, 0.0, cos]])
        T = np.array([[sv * shift_range_lat], [geo.CAMERA_HEIGHT],
                      [-su * shift_range_lon]])
        P = k @ np.concatenate([R, T], axis=1)
        uv1 = XYZ1 @ P.T
        front = uv1[..., 2] > 1e-6
        den = np.maximum(uv1[..., 2], 1e-6)
        u, v = uv1[..., 0] / den, uv1[..., 1] / den
        inb = front & (u > -1) & (u < grd_W + 1) & (v > -1) & (v < grd_H + 1)
        js = np.where(inb.any(axis=0))[0]
        if len(js):
            jmin = min(jmin, int(js.min()))
    j0 = max(jmin - 2, 0)
    return (j0 // align) * align


def _scaled_k(camera_k, grd_H: int, grd_W: int, ori_grdH: int,
              ori_grdW: int):
    """camera_k [B, 3, 3] (for the ori_grdH x ori_grdW input) rescaled to
    the grd_H x grd_W feature map, float32.  The rows are scaled by Python
    numbers, so nothing is copied from the host."""
    k = camera_k.to(torch.float32)
    return torch.cat([k[:, :1] * (grd_W / ori_grdW),
                      k[:, 1:2] * (grd_H / ori_grdH), k[:, 2:]], dim=1)


def _rot_neg_heading(pose, rotation_range: float):
    """cos and sin of -heading, [B] each."""
    heading = pose[:, 2] * (rotation_range / 180.0 * np.pi)
    return torch.cos(-heading), torch.sin(-heading)


def _k_times(k, M):
    """k [B, 3, 3] times M [B, 3, 4] as a broadcast sum -> [B, 3, 4]."""
    return (k[:, :, :, None] * M[:, None, :, :]).sum(2)


def g2sp_P(pose, camera_k, grd_H: int, grd_W: int, ori_grdH: int,
           ori_grdW: int, rotation_range: float, shift_range_lat: float,
           shift_range_lon: float):
    """The G2SP perspective projection P = K' [R(-heading) | T] (reference
    models_kitti.py:101-121) of a normalized pose [B, 3], with camera_k
    [B, 3, 3] rescaled to the grd_H x grd_W map.  Returns [B, 3, 4]."""
    cos, sin = _rot_neg_heading(pose, rotation_range)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    R = torch.stack([cos, zeros, -sin,
                     zeros, ones, zeros,
                     sin, zeros, cos], dim=-1).reshape(-1, 3, 3)
    T = torch.stack([pose[:, 1] * shift_range_lat,
                     geo.CAMERA_HEIGHT * ones,
                     -(pose[:, 0] * shift_range_lon)], dim=-1)[..., None]
    k = _scaled_k(camera_k, grd_H, grd_W, ori_grdH, ori_grdW)
    return _k_times(k, torch.cat([R, T], dim=-1))


def g2sp_dP(pose, camera_k, grd_H: int, grd_W: int, ori_grdH: int,
            ori_grdW: int, rotation_range: float, shift_range_lat: float,
            shift_range_lon: float):
    """d(``g2sp_P``)/d(pose) [B, 3 (pose dim), 3, 4]: K' dM_k with dM_u =
    [0 | dT/du], dM_v = [0 | dT/dv] and dM_theta = [dR(-heading)/dtheta |
    0], the matrices ``g2sp_uv_jac``'s quotient rule projects.  Built on
    the pose's device from the pose alone (no copy from the host)."""
    cos, sin = _rot_neg_heading(pose, rotation_range)
    zeros = torch.zeros_like(cos)
    dM = torch.zeros(pose.shape[0], 3, 3, 4, dtype=torch.float32,
                     device=pose.device)
    dM[:, 0, 2, 3] = -shift_range_lon     # dT/du = (0, 0, -lon)
    dM[:, 1, 0, 3] = shift_range_lat      # dT/dv = (lat, 0, 0)
    # d(-heading)/d(theta_norm) = -rot_scale, folded into dR
    dM[:, 2, :, :3] = (rotation_range / 180.0 * np.pi) * torch.stack(
        [sin, zeros, cos,
         zeros, zeros, zeros,
         -cos, zeros, sin], dim=-1).reshape(-1, 3, 3)
    k = _scaled_k(camera_k, grd_H, grd_W, ori_grdH, ori_grdW)
    return (k[:, None, :, :, None] * dM[:, :, None, :, :]).sum(3)


def g2sp_line_jac(h0, dh, dP, x0, dx):
    """The per-line Jacobian coefficients [B, V, 24] of K7
    (``ops/projline.py`` ``projline_linemom``) for the lines of ground
    points x0 + u*dx (x0, dx [V, 4]): for P, the lines' images h0, dh
    [B, V, 3], then for each dP_k of ``g2sp_dP`` [B, 3, 3, 4] the images
    dP_k x0 and dP_k dx, three floats each."""
    def project_d(X):  # [V, 4] -> [B, V, 3 (pose dim), 3]
        return (dP[:, None] * X[None, :, None, None, :]).sum(-1)

    return torch.stack([torch.cat([h0[:, :, None], project_d(x0)], 2),
                        torch.cat([dh[:, :, None], project_d(dx)], 2)],
                       3).flatten(2)


def _apply_P(P, XYZ1):
    """P [B, 3, 4] applied to points XYZ1 [H, W, 4] -> [B, H, W, 3]."""
    return (P[:, None, None, :, :] * XYZ1[None, :, :, None, :]).sum(-1)


def g2sp_uv_jac(pose, XYZ1, camera_k, grd_H: int, grd_W: int,
                ori_grdH: int, ori_grdW: int, rotation_range: float,
                shift_range_lat: float, shift_range_lon: float):
    """Perspective projection of satellite ground points into the ground
    map with its quotient-rule Jacobian (reference models_kitti.py:86-150;
    the rotation uses -heading).

    pose [B, 3]; XYZ1 [H, W, 4] points (any grid of them); camera_k
    [B, 3, 3] raw K.  Returns uv [B, H, W, 2] ground-map pixel coords,
    duv_dpose [B, H, W, 2, 3] (zero where the point is not in front of the
    camera) and that mask [B, H, W] (uv1_z > 1e-6).
    """
    P = g2sp_P(pose, camera_k, grd_H, grd_W, ori_grdH, ori_grdW,
               rotation_range, shift_range_lat, shift_range_lon)
    dP = g2sp_dP(pose, camera_k, grd_H, grd_W, ori_grdH, ori_grdW,
                 rotation_range, shift_range_lat, shift_range_lon)

    uv1 = _apply_P(P, XYZ1)                                # [B, H, W, 3]
    uv1_last = torch.clamp_min(uv1[..., 2:], 1e-6)
    uv = uv1[..., :2] / uv1_last
    mask = uv1[..., 2] > 1e-6

    def quotient(dPk):
        duv1 = _apply_P(dPk, XYZ1)
        q = duv1[..., :2] / uv1_last - uv * duv1[..., 2:] / uv1_last
        return torch.where(mask[..., None], q, torch.zeros_like(q))

    duv = torch.stack([quotient(dP[:, i]) for i in range(3)],
                      dim=-1)                             # [B, H, W, 2, 3]
    return uv, duv, mask


def _inplane_consts(A: int, device: torch.device):
    """``inplane_uv_jac``'s constants, made on ``device`` at every call
    (``arange`` and ``eye`` there, no copy from the host): the pixel grid
    (u, v) centred on the patch [A, A, 2] and the unit vectors of its u
    and v shifts in uv, (-1, 0) and (0, 1).  Nothing is kept between calls:
    a tensor made while ``torch.export`` traces is a FakeTensor, and a
    cached one would turn a later eager call's outputs fake."""
    i = torch.arange(A, dtype=torch.float32, device=device) - A / 2
    vg, ug = torch.meshgrid(i, i, indexing="ij")
    e_v = torch.eye(2, dtype=torch.float32, device=device)[1]
    return torch.stack([ug, vg], dim=-1), e_v - 1.0, e_v  # (-1, +0), (0, 1)


def inplane_uv_jac(pose, satmap_sidelength: int, rotation_range: float,
                   shift_range_lat: float, shift_range_lon: float):
    """The in-plane SE(2) warp of G2SP ``proj="nn"`` (reference
    models_kitti.py:289-331): each satellite pixel (u, v) rotated by the
    heading about the patch centre and shifted by the pose in pixels.

    pose [B, 3] normalized.  Returns uv [B, A, A, 2] (the pixel of the
    re-laid-out ground map to sample), duv_dpose [B, A, A, 2, 3] and an
    all-ones mask [B, A, A].  The 2x2 rotations are broadcast sums.
    """
    A = satmap_sidelength
    mpp = _meter_per_pixel(A)
    B = pose.shape[0]
    f32 = dict(dtype=torch.float32, device=pose.device)
    T = torch.stack([-(pose[:, 0] * shift_range_lon / mpp),
                     pose[:, 1] * shift_range_lat / mpp], dim=-1)  # [B, 2]
    rot_scale = rotation_range / 180.0 * np.pi
    heading = pose[:, 2] * rot_scale
    cos, sin = torch.cos(heading), torch.sin(heading)
    R = torch.stack([cos, -sin, sin, cos], dim=-1).reshape(B, 2, 2)

    uv2, e_u, e_v = _inplane_consts(A, pose.device)

    def rotate(M):  # M [B, 2, 2] applied to every uv2 -> [B, A, A, 2]
        return (M[:, None, None, :, :] * uv2[None, :, :, None, :]).sum(-1)

    uv = rotate(R) + T[:, None, None, :] + A / 2
    mask = torch.ones(uv.shape[:-1], **f32)
    duv_du = (e_u * (shift_range_lon / mpp)).expand(uv.shape)
    duv_dv = (e_v * (shift_range_lat / mpp)).expand(uv.shape)
    dR_dtheta = rot_scale * torch.stack([-sin, -cos, cos, -sin],
                                        dim=-1).reshape(B, 2, 2)
    duv = torch.stack([duv_du, duv_dv, rotate(dR_dtheta)], dim=-1)
    return uv, duv, mask
