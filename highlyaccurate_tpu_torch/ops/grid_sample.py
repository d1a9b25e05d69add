"""Differentiable bilinear sampling with screen derivatives (port of
``highlyaccurate_tpu/ops/grid_sample.py``), the gather sampler of every
non-banded path: S2GP and Ford with ``use_banded_warp=0``, G2SP levels the
projective-line kernels do not take, and ``project_at_pose``.

The JAX contract, kept exactly:
  * ``uv`` is in pixel units (u = x in [0, IW], v = y in [0, IH]), not
    normalized;
  * the four corners are read as one 2x2 block at
    ``clip(floor(uv), 0, I - 2)`` (the float clipped before the integer
    cast, so no index leaves the image whatever uv is);
  * the bilinear weights come from the *clamped* corner coordinates, so a
    sample exactly on the right or bottom edge gets weight 0;
  * the in-bounds mask comes from the raw coordinates and multiplies value
    and derivatives;
  * the screen derivatives carry the ``dup_x`` / ``dup_y`` factors (0 where
    both corners of an axis clamp to one texel).

This is not ``torch.nn.functional.grid_sample``, which takes normalized
coordinates, weights the corners from the raw coordinates and gives no
derivatives.  Layout is channel-last ``[B, H, W, C]``.  The gather is plain
indexing, so autograd gives the backward (on CUDA an index accumulation
with atomics, not bit-repeatable).  Corner values keep the image dtype and
meet float32 weights, so a bf16 image gives float32 results, as JAX
promotes them.
"""

from __future__ import annotations

import torch


def _gather_corners(image, ix, iy):
    """The 2x2 block of each point: image [B, IH, IW, C]; ix, iy [B, H, W]
    float pixel coords.  Returns the corner values (nw, ne, sw, se), each
    [B, H, W, C], and the clamped corner coordinates of the weights."""
    B, IH, IW, C = image.shape
    ix_nw = torch.floor(ix)
    iy_nw = torch.floor(iy)
    ix_se = ix_nw + 1
    iy_se = iy_nw + 1
    cx_nw = ix_nw.clamp(0, IW - 1)
    cy_nw = iy_nw.clamp(0, IH - 1)
    cx_se = ix_se.clamp(0, IW - 1)
    cy_se = iy_se.clamp(0, IH - 1)

    # block starts: clamp the float, cast, and clamp again (a NaN coordinate
    # casts to an arbitrary integer, which must not index out of bounds)
    y0 = iy_nw.clamp(0, IH - 2).long().clamp(0, IH - 2)
    x0 = ix_nw.clamp(0, IW - 2).long().clamp(0, IW - 2)
    start = (y0 * IW + x0).reshape(B, -1)                 # [B, P]
    idx = torch.cat([start, start + 1, start + IW, start + IW + 1], dim=1)
    flat = image.reshape(B, IH * IW, C)
    vals = flat[torch.arange(B, device=image.device)[:, None], idx]
    shape = ix.shape + (C,)
    nw, ne, sw, se = (v.reshape(shape) for v in vals.chunk(4, dim=1))
    return (nw, ne, sw, se), (cx_nw, cy_nw, cx_se, cy_se)


def _sample_parts(image, uv):
    """The bilinear sample and the pieces of its uv-derivatives."""
    IH, IW = image.shape[1:3]
    ix = uv[..., 0]
    iy = uv[..., 1]
    corners, (cx_nw, cy_nw, cx_se, cy_se) = _gather_corners(image, ix, iy)
    nw_val, ne_val, sw_val, se_val = corners

    maskf = ((ix >= 0) & (ix <= IW - 1) & (iy >= 0)
             & (iy <= IH - 1)).to(uv.dtype)
    nw = (cx_se - ix) * (cy_se - iy) * maskf
    ne = (ix - cx_nw) * (cy_se - iy) * maskf
    sw = (cx_se - ix) * (iy - cy_nw) * maskf
    se = (ix - cx_nw) * (iy - cy_nw) * maskf

    out = (nw_val * nw[..., None] + ne_val * ne[..., None]
           + sw_val * sw[..., None] + se_val * se[..., None])
    coords = (ix, iy, cx_nw, cy_nw, cx_se, cy_se, maskf)
    return out, corners, coords


def _screen_derivs(corners, coords):
    """d(out)/du and d(out)/dv from the corner values, with the dup
    factors."""
    nw_val, ne_val, sw_val, se_val = corners
    ix, iy, cx_nw, cy_nw, cx_se, cy_se, maskf = coords
    dup_x = cx_se - cx_nw
    dup_y = cy_se - cy_nw
    dout_du = (nw_val * (-(cy_se - iy) * maskf)[..., None]
               + ne_val * ((cy_se - iy) * maskf)[..., None]
               + sw_val * (-(iy - cy_nw) * maskf)[..., None]
               + se_val * ((iy - cy_nw) * maskf)[..., None]) * dup_x[..., None]
    dout_dv = (nw_val * (-(cx_se - ix) * maskf)[..., None]
               + ne_val * (-(ix - cx_nw) * maskf)[..., None]
               + sw_val * ((cx_se - ix) * maskf)[..., None]
               + se_val * ((ix - cx_nw) * maskf)[..., None]) * dup_y[..., None]
    return dout_du, dout_dv


def grid_sample(image, uv, duv_dpose=None):
    """Bilinear sample ``image`` [B, IH, IW, C] at ``uv`` [B, H, W, 2]
    (pixels); with ``duv_dpose`` [B, H, W, 2, P] also the pose Jacobian of
    the sample.  Returns (out [B, H, W, C], jac [B, H, W, C, P] or None)."""
    out, corners, coords = _sample_parts(image, uv)
    if duv_dpose is None:
        return out, None
    dout_du, dout_dv = _screen_derivs(corners, coords)
    duv = duv_dpose.to(dout_du.dtype)
    jac = (dout_du[..., None] * duv[..., None, 0, :]
           + dout_dv[..., None] * duv[..., None, 1, :])
    return out, jac


def grid_sample_derivs(image, uv):
    """Bilinear sample and its screen-space derivatives, without a pose
    chain: (out, dout_du, dout_dv), each [B, H, W, C], the numerics of the
    pieces ``grid_sample`` chains.  They feed the per-pixel implicit LM
    updates, which never materialize the [B, H, W, C, 3] Jacobian."""
    out, corners, coords = _sample_parts(image, uv)
    dout_du, dout_dv = _screen_derivs(corners, coords)
    return out, dout_du, dout_dv
