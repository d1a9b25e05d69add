"""LM pose updates (port of ``highlyaccurate_tpu/solver/updates.py:29-43,
79-92, 156-248, 251-393, 441-516``): the S2GP and Ford update from K1's
fused moments (evaluation) and from K2's line samples (training), and the
G2SP per-pixel update from K4's samples (both) or K6's fused moments
(evaluation).

pose is [B, 3] = (shift_u, shift_v, heading), normalized.  The 3x3 damped
solve runs in float32 whatever the feature dtype.  The contractions are
written as broadcast products and sums rather than ``einsum`` so that no
matrix product (and hence no TF32 mode) is involved on the GPU.  The
out-of-range re-init draws from an explicit ``torch.Generator``; it gives
other numbers than the JAX package's keys for the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from highlyaccurate_tpu_torch.ops.banded_warp import MOM_IDX, moment_sums
from highlyaccurate_tpu_torch.ops.projline import PIXMOM_IDX, pixel_moments


# shifts leaving (-REINIT_RANGE, REINIT_RANGE) are redrawn in [-1, 1)
REINIT_RANGE = 2.5


class LMConfig(NamedTuple):
    """Static solver knobs (subset of Config).  G2SP sets ``reinit=False``
    (no out-of-range re-init) and ``raw_damping=True`` (a trained damping
    is used as it is, reference models_kitti.py:356-359)."""
    active_dims: tuple = (0, 1, 2)
    train_damping: bool = False
    damping: float = 0.1
    use_hessian: bool = False
    reinit: bool = True
    raw_damping: bool = False


def compute_damping(damping_param, cfg: LMConfig, n_active: int,
                    device=None):
    """Per-DoF damping vector [n_active] (float32).

    Trained damping uses the reference's log-parameterization
    10^(-6 + 11*sigmoid(d)) (models_kitti.py:962-963), or with
    ``raw_damping`` the parameter itself; otherwise a constant.
    """
    if cfg.train_damping:
        d = damping_param.reshape(-1).to(torch.float32)
        if d.shape[0] == 1:
            d = d.expand(3)
        if not cfg.raw_damping:
            d = torch.pow(10.0, -6.0 + torch.sigmoid(d) * 11.0)
        return d[list(cfg.active_dims)][:n_active]
    return torch.full((n_active,), cfg.damping, dtype=torch.float32,
                      device=device)


def _solve_and_reinit(pose, hess, g, damping_param, cfg: LMConfig,
                      generator: torch.Generator):
    """Damped solve on the active-DoF system, then the out-of-range uniform
    re-init of the shifts (reference models_kitti.py:1005-1033).

    hess [B, n, n] and g [B, n] are already active-dim sliced.  The re-init
    numbers are drawn every round (as the JAX package splits its key every
    round), from ``generator`` on the pose's device.  Only a solve over all
    three DoF with ``cfg.reinit`` re-inits (and draws), as in the JAX
    package; without it ``generator`` may be None.
    """
    B = pose.shape[0]
    act = list(cfg.active_dims)
    n = len(act)
    damping = compute_damping(damping_param, cfg, n, device=pose.device)
    if cfg.use_hessian:
        diag = torch.diagonal(hess, dim1=-2, dim2=-1)
    else:
        diag = torch.ones(B, n, dtype=torch.float32, device=pose.device)
    lhs = hess + torch.diag_embed(damping[None, :] * diag)
    # solve_ex: LU with partial pivoting like jnp.linalg.solve, and no
    # host-side error check (which would synchronise with the device)
    sol, _ = torch.linalg.solve_ex(lhs, g[..., None])
    delta = -sol[..., 0]

    new = pose.to(torch.float32).clone()
    new[:, act] += delta
    if cfg.reinit and n == 3:
        rand = torch.rand(2, B, generator=generator, dtype=torch.float32,
                          device=pose.device) * 2.0 - 1.0
        lim = REINIT_RANGE
        su, sv = new[:, 0], new[:, 1]
        new = torch.stack([
            torch.where((su > -lim) & (su < lim), su, rand[0]),
            torch.where((sv > -lim) & (sv < lim), sv, rand[1]),
            new[:, 2]], dim=-1)
    return new


def _pair(Pa, Da, Pb, Db, m0, m1, m2):
    """Sum_v Sum_u duv_a[p] * duv_b[q] * S(v, u) with duv = P + u*D, from the
    u-moment sums m0, m1, m2 [B, V] of S."""
    def outer(X, Y, w):  # sum_v X[b,v,p] Y[b,v,q] w[b,v] -> [B, 3, 3]
        return (X[:, :, :, None] * Y[:, :, None, :]
                * w[:, :, None, None]).sum(1)
    return (outer(Pa, Pb, m0) + (outer(Pa, Db, m1) + outer(Da, Pb, m1))
            + outer(Da, Db, m2))


def lm_update_from_moments(pose, M, P0, dP, damping_param, cfg: LMConfig,
                           generator: torch.Generator):
    """LM update from K1's per-row moments.

    M [B, V, 3, 16] (or the first 9 lanes, [B, V, 3, 9]) moment rows (sum,
    u-sum, u^2-sum) in ``MOM_IDX`` lane order, in kernel axes; P0, dP
    [B, V, 2, 3] per-row affine duv coefficients in the same (x, y) order
    as the kernel.  Returns the new
    pose [B, 3], re-initialized from ``generator`` where a shift left the
    range.  The S2GP eval update: normalized features, no pixel weights, no
    dropout.
    """
    f32 = torch.float32
    M = M.to(f32)

    def mom(name, k):
        return M[:, :, k, MOM_IDX[name]]  # [B, V]

    # whole-map feature norms, floored: sqrt(max(., 1e-12))
    ns = torch.sqrt(torch.clamp_min(mom("ss", 0).sum(1), 1e-12))  # [B]
    ng = torch.sqrt(torch.clamp_min(mom("gg", 0).sum(1), 1e-12))

    def pair(Pa, Da, Pb, Db, name):
        return _pair(Pa, Da, Pb, Db, mom(name, 0), mom(name, 1), mom(name, 2))

    Px, Py = P0[:, :, 0].to(f32), P0[:, :, 1].to(f32)  # [B, V, 3]
    Dx_, Dy_ = dP[:, :, 0].to(f32), dP[:, :, 1].to(f32)

    hess = (pair(Px, Dx_, Px, Dx_, "sxx")
            + pair(Px, Dx_, Py, Dy_, "sxy")
            + pair(Py, Dy_, Px, Dx_, "sxy")
            + pair(Py, Dy_, Py, Dy_, "syy")) / (ns * ns)[:, None, None]

    inv_ss = 1.0 / (ns * ns)[:, None]
    inv_sg = 1.0 / (ns * ng)[:, None]
    qx0 = mom("dxs", 0) * inv_ss - mom("dxg", 0) * inv_sg  # [B, V]
    qx1 = mom("dxs", 1) * inv_ss - mom("dxg", 1) * inv_sg
    qy0 = mom("dys", 0) * inv_ss - mom("dyg", 0) * inv_sg
    qy1 = mom("dys", 1) * inv_ss - mom("dyg", 1) * inv_sg

    def vdot(X, q):  # sum_v X[b,v,p] q[b,v] -> [B, 3]
        return (X * q[:, :, None]).sum(1)

    g_full = (vdot(Px, qx0) + vdot(Dx_, qx1)
              + vdot(Py, qy0) + vdot(Dy_, qy1))

    act = list(cfg.active_dims)
    hess = hess[:, act][:, :, act]  # [B, n, n]
    g = g_full[:, act]
    return _solve_and_reinit(pose, hess, g, damping_param, cfg, generator)


def lm_update_implicit(pose, out, dx, dy, grd, mask, P0, dP, damping_param,
                       cfg: LMConfig, generator: torch.Generator):
    """LM update from implicit (never materialized) Jacobians, the training
    path's update: differentiable with respect to every tensor argument.

    out, dx, dy [B, V, W, C] line samples and screen derivatives (K2's
    outputs, masked in bounds); grd [B, V, W, C] target rows; mask [V, W]
    ray mask; P0, dP [B, V, 2, 3] per-row affine duv coefficients in the
    (dx, dy) order of the samples.  The nine per-pixel channel moments
    under the ray mask, summed over u with weights 1, u, u^2, are exactly
    what K1 fuses, so the rest is ``lm_update_from_moments``.  The
    contraction is plain torch, as the JAX package left it to XLA.
    """
    f32 = torch.float32
    M = moment_sums(out.to(f32), dx.to(f32), dy.to(f32), grd, mask)
    return lm_update_from_moments(pose, M, P0, dP, damping_param, cfg,
                                  generator)


def _pixel_hessian(Du, Dv, sxx, sxy, syy):
    """Sum over pixels of duv^T S duv with S = [[sxx, sxy], [sxy, syy]]
    per pixel: Du, Dv [B, H, W, 3] (d(x)/d(pose), d(y)/d(pose)), the
    moments [B, H, W] -> [B, 3, 3]."""
    def outer(X, Y, w):
        return (X[..., :, None] * Y[..., None, :]
                * w[..., None, None]).sum((1, 2))
    return (outer(Du, Du, sxx) + outer(Du, Dv, sxy) + outer(Dv, Du, sxy)
            + outer(Dv, Dv, syy))


def lm_update_implicit_pixel(pose, out, dx, dy, target, duv, damping_param,
                             cfg: LMConfig):
    """The G2SP LM update from per-pixel moments, the [B, H, W, C, 3]
    Jacobian never materialized: residual r = out - target, no feature
    normalization, J[p, c, :] = dx[p, c]*duv_x[p, :] + dy[p, c]*duv_y[p, :]:

        H = sum_p duv_p^T S_p duv_p,   S_p = [[sxx, sxy], [sxy, syy]]_p
        g = sum_p duv_p^T [sum_c dx*r; sum_c dy*r]_p

    out, dx, dy [B, H, W, C] sampled values and screen derivatives (K4's
    outputs, zero out of view); target [B, H, W, C] (any strides); duv
    [B, H, W, 2, 3].  Differentiable with respect to every tensor argument.
    It never re-inits, whatever ``cfg.reinit`` says, as in the JAX package.
    """
    f32 = torch.float32
    moments = pixel_moments(out.to(f32), dx.to(f32), dy.to(f32), target)
    return _pixel_solve(pose, duv[..., 0, :].to(f32), duv[..., 1, :].to(f32),
                        moments, damping_param, cfg)


def _pixel_solve(pose, Du, Dv, moments, damping_param, cfg: LMConfig):
    """H and g of the per-pixel update from the five moments [B, H, W] and
    the duv rows Du, Dv [B, H, W, 3]; the damped solve, never a re-init."""
    sxx, sxy, syy, rx, ry = moments
    hess = _pixel_hessian(Du, Dv, sxx, sxy, syy)
    g = ((Du * rx[..., None]).sum((1, 2))
         + (Dv * ry[..., None]).sum((1, 2)))
    act = list(cfg.active_dims)
    return _solve_and_reinit(pose, hess[:, act][:, :, act], g[:, act],
                             damping_param, cfg._replace(reinit=False), None)


def lm_update_pixel_moments(pose, pm, duv, damping_param, cfg: LMConfig):
    """The G2SP LM update from K6's fused moments (port of
    ``highlyaccurate_tpu/solver/updates.py:482-516``): the same H and g as
    ``lm_update_implicit_pixel``, up to the order of the channel sums, with
    the five per-pixel moments already contracted by the kernel.

    pm [B, H, W, L] moment lanes in ``PIXMOM_IDX`` order (L = 5 from the
    port's K6, or the JAX kernel's 16); duv [B, H, W, 2, 3] in the kernel's
    (x, y) derivative order.  Evaluation only; no re-init.
    """
    f32 = torch.float32
    pm = pm.to(f32)
    moments = tuple(pm[..., PIXMOM_IDX[k]]
                    for k in ("sxx", "sxy", "syy", "rx", "ry"))
    return _pixel_solve(pose, duv[..., 0, :].to(f32), duv[..., 1, :].to(f32),
                        moments, damping_param, cfg)
