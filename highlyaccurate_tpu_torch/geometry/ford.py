"""Ford-AV geometry (port of ``highlyaccurate_tpu/geometry/ford.py:20-56,
73-171``): the camera -> body -> world -> satellite chain of LM_S2GP_Ford.

Frames (Ford): body X north, Y east, Z down; the camera extrinsics
(R_FL, T_FL) map camera to body, Xb = R_FL @ Xc + T_FL.  The normalized
pose scales are swapped against KITTI, as in the reference: shift_u uses
``shift_range_lat``, shift_v ``shift_range_lon``.  Rays are host numpy,
computed exactly as the JAX package does; the projection and its
closed-form Jacobian are torch functions of the pose on the pose's device.
The estimated-height lift (``depth_lift``) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from highlyaccurate_tpu_torch.utils import geo

# Front-left camera intrinsics of the original 1656x860 frame (reference
# models_ford.py:116-130), rescaled to the network input by ford_camera_k.
K_FL_RAW = np.array([[945.391406, 0.0, 855.502825],
                     [0.0, 945.668274, 566.372868],
                     [0.0, 0.0, 1.0]], dtype=np.float64)
H_FL, W_FL = 860, 1656
NET_H, NET_W = 256, 1024


def ford_camera_k(net_h: int = NET_H, net_w: int = NET_W) -> np.ndarray:
    k = K_FL_RAW.copy()
    k[0, :] = k[0, :] / W_FL * net_w
    k[1, :] = k[1, :] / H_FL * net_h
    return k


def grd_img2cam_ford(grd_H: int, grd_W: int, ori_grdH: int, ori_grdW: int):
    """Ground-plane ray intersections under the Ford camera (reference
    models_ford.py:110-155): host numpy xyz_grd [H, W, 3], mask [H, W] (1.0
    where the ray meets the ground in front) and xyz_w [H, W, 3]
    (unit-depth rays)."""
    k = ford_camera_k(ori_grdH, ori_grdW)
    k[0, :] *= grd_W / ori_grdW
    k[1, :] *= grd_H / ori_grdH
    k_inv = np.linalg.inv(k)

    v, u = np.meshgrid(np.arange(grd_H, dtype=np.float64),
                       np.arange(grd_W, dtype=np.float64), indexing="ij")
    uv1 = np.stack([u, v, np.ones_like(u)], axis=-1)
    xyz_w = uv1 @ k_inv.T
    denom = np.where(np.abs(xyz_w[..., 1:2]) > geo.EPS, xyz_w[..., 1:2],
                     geo.EPS)
    xyz_grd = xyz_w * (geo.CAMERA_HEIGHT / denom)
    mask = (xyz_grd[..., 2] > 0).astype(np.float32)
    return xyz_grd.astype(np.float32), mask, xyz_w.astype(np.float32)


def _to_sat(X):
    """Rs X with Rs = [[0, 1, 0], [-1, 0, 0], [0, 0, 1]], world (N, E, D)
    -> satellite pixel axes (u east, v south); the first two components."""
    return torch.stack([X[..., 1], -X[..., 0]], dim=-1)


def ford_uv_jac(pose, R_FL, T_FL, Xc, satmap_sidelength_meters,
                satmap_sidelength_pixels: int, rotation_range: float,
                shift_range_lat: float, shift_range_lon: float,
                require_jac: bool = True):
    """Pose -> satellite pixel coordinates and their closed-form Jacobian
    (reference models_ford.py:173-264):
    Xb = R_FL Xc + T_FL; Tw = [shift_v_m, -shift_u_m, 0];
    Xw = Rz(yaw) (Xb + Tw); uv = (Rs Xw)[:2] / mpp + A // 2.

    pose [B, 3] normalized (shift_u, shift_v, theta); R_FL [B, 3, 3]; T_FL
    [B, 3]; Xc [H, W, 3] or [B, H, W, 3]; satmap_sidelength_meters a scalar
    or a per-sample [B] vector.  Returns uv [B, H, W, 2] and duv_dpose
    [B, H, W, 2, 3] (None unless ``require_jac``).
    """
    B = pose.shape[0]
    f32 = dict(dtype=pose.dtype, device=pose.device)
    shift_u_m = pose[:, 0] * shift_range_lat   # the reference's swapped scales
    shift_v_m = pose[:, 1] * shift_range_lon
    yaw = pose[:, 2] * (rotation_range / 180.0 * np.pi)

    eq = "bij,hwj->bhwi" if Xc.dim() == 3 else "bij,bhwj->bhwi"
    Xb = torch.einsum(eq, R_FL, Xc) + T_FL[:, None, None, :]
    Tw = torch.stack([shift_v_m, -shift_u_m, torch.zeros_like(shift_u_m)],
                     dim=-1)
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    Rw = torch.stack([cos, sin, zeros,
                      -sin, cos, zeros,
                      zeros, zeros, ones], dim=-1).reshape(B, 3, 3)
    Xbt = Xb + Tw[:, None, None, :]
    Xs = _to_sat(torch.einsum("bij,bhwj->bhwi", Rw, Xbt))

    # mpp is a scalar or a per-sample [B] vector; a vector broadcasts over
    # the trailing (H, W, 2) axes
    mpp = torch.as_tensor(satmap_sidelength_meters, **f32) \
        / satmap_sidelength_pixels
    mpp_hw = mpp.reshape(-1, 1, 1, 1) if mpp.dim() else mpp
    uv = Xs / mpp_hw + satmap_sidelength_pixels // 2
    if not require_jac:
        return uv, None

    rot_scale = rotation_range / 180.0 * np.pi
    dRw = rot_scale * torch.stack([-sin, cos, zeros,
                                   -cos, -sin, zeros,
                                   zeros, zeros, zeros],
                                  dim=-1).reshape(B, 3, 3)
    dTw_du = shift_range_lat * torch.tensor([0.0, -1.0, 0.0], **f32)
    dTw_dv = shift_range_lon * torch.tensor([1.0, 0.0, 0.0], **f32)
    dXs_dtheta = _to_sat(torch.einsum("bij,bhwj->bhwi", dRw, Xbt))
    dXs_du = _to_sat(torch.einsum("bij,j->bi", Rw, dTw_du))   # [B, 2]
    dXs_dv = _to_sat(torch.einsum("bij,j->bi", Rw, dTw_dv))

    mpp_b = mpp.reshape(-1, 1) if mpp.dim() else mpp
    duv_dtheta = dXs_dtheta / mpp_hw
    duv_du = (dXs_du / mpp_b)[:, None, None, :].expand_as(uv)
    duv_dv = (dXs_dv / mpp_b)[:, None, None, :].expand_as(uv)
    return uv, torch.stack([duv_du, duv_dv, duv_dtheta], dim=-1)


def qvec2rotmat(qvec) -> np.ndarray:
    """Quaternion [w, x, y, z] -> rotation matrix (reference
    dataLoader/Ford_dataset.py:62-72)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
         2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x * x - 2 * y * y]])


def qvec2angle(q0, q1, q2, q3):
    """Quaternion -> (roll, pitch, yaw) in degrees (reference
    dataLoader/Ford_dataset.py:74-78)."""
    roll = np.arctan2(2.0 * (q3 * q2 + q0 * q1),
                      1.0 - 2.0 * (q1 * q1 + q2 * q2)) / np.pi * 180
    pitch = np.arcsin(2.0 * (q2 * q0 - q3 * q1)) / np.pi * 180
    yaw = np.arctan2(2.0 * (q3 * q0 + q1 * q2),
                     -1.0 + 2.0 * (q0 * q0 + q1 * q1)) / np.pi * 180
    return roll, pitch, yaw
