"""KITTI S2GP geometry (port of ``highlyaccurate_tpu/geometry/kitti.py:31-193``).

Ground-plane rays are precomputed on the host in float64 numpy exactly as the
JAX package does; the pose -> satellite-pixel projection and its closed-form
Jacobian are torch functions of the pose on the pose's device.

Layouts follow the JAX package: pose [B, 3] = (shift_u, shift_v, heading)
in normalized units, uv [B, H, W, 2], d(uv)/d(pose) [B, H, W, 2, 3].
Frames: camera +x south, +y down, +z forward; satellite pixels u east,
v south, origin at the patch's top-left.
"""

from __future__ import annotations

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
