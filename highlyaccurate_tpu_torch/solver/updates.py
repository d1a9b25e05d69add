"""Pose updates (port of ``highlyaccurate_tpu/solver/updates.py:29-43,
45-154, 156-248, 251-516, 519-620``): the S2GP and Ford LM update from K1's
fused moments (evaluation) and from K2's line samples (training), the
G2SP per-pixel update from K4's samples (both), K6's fused moments
(evaluation) or K7's per-line sums (evaluation), and the gather sampler's
updates: ``lm_update`` on a materialized Jacobian (``use_implicit_lm=0``,
``using_weight``, every family) and the S2GP / Ford per-pixel
``lm_update_implicit_pixel_norm``; and the other update rules on a
materialized Jacobian: ``sgd_update`` and ``adam_update`` (KITTI),
``gn_update`` and ``sgd_update_l1`` (Ford).

Pixel dropout (``dropout > 0``, the reference's random half of the
pixels, models_kitti.py:968-974) keeps ``dropout_keep``'s pixels: one
random half of the H x W grid per round for the whole batch, as JAX
permutes H * W with the round's key.

pose is [B, 3] = (shift_u, shift_v, heading), normalized.  The 3x3 damped
solve runs in float32 whatever the feature dtype.  The contractions are
written as broadcast products and sums rather than ``einsum`` so that no
matrix product (and hence no TF32 mode) is involved on the GPU.  The
out-of-range re-init draws from an explicit ``torch.Generator``, or from
numbers drawn ahead (``PresetDraws``, the input of an exported program); it
gives other numbers than the JAX package's keys for the same seed.

``lm_information`` and ``pose_covariance`` (port of ``:623-698``) give the
pose covariance at the solution from the same per-pixel moments as the
gather path's update.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from highlyaccurate_tpu_torch.ops.banded_warp import (MOM_IDX,
                                                      channel_moments,
                                                      moment_sums)
from highlyaccurate_tpu_torch.ops.projline import (LINEMOM_IDX, PIXMOM_IDX,
                                                   pixel_moments)


# shifts leaving (-REINIT_RANGE, REINIT_RANGE) are redrawn in [-1, 1)
REINIT_RANGE = 2.5


class LMConfig(NamedTuple):
    """Static solver knobs (subset of Config).  G2SP sets ``reinit=False``
    (no out-of-range re-init), ``raw_damping=True`` (a trained damping
    is used as it is, reference models_kitti.py:356-359) and
    ``normalize=False`` (``lm_update`` without the feature norms).
    ``using_weight``: ``lm_update`` and ``gn_update`` weight each residual
    by the target confidence; ``dropout > 0``: the LM updates keep a random
    half of the pixels (``dropout_keep``)."""
    active_dims: tuple = (0, 1, 2)
    train_damping: bool = False
    damping: float = 0.1
    use_hessian: bool = False
    reinit: bool = True
    raw_damping: bool = False
    normalize: bool = True
    using_weight: bool = False
    dropout: int = 0


class PresetDraws:
    """Uniform numbers in [-1, 1) drawn ahead of a forward, handed out in
    the order the forward asks for them: it stands where a
    ``torch.Generator`` goes, so that the caller fixes the numbers (an
    exported program takes them as an input tensor, since it cannot take a
    generator).  ``numbers`` is flat; ``used`` counts what was taken."""

    def __init__(self, numbers: torch.Tensor):
        self.numbers = numbers
        self.used = 0

    def take(self, shape) -> torch.Tensor:
        n = math.prod(shape)
        if self.used + n > self.numbers.shape[0]:
            raise ValueError(f"PresetDraws: {self.numbers.shape[0]} numbers "
                             f"cannot give {self.used} + {n}")
        out = self.numbers[self.used:self.used + n].reshape(shape)
        self.used += n
        return out


class ShardDraws:
    """The draws of one shard of a data-parallel forward: of the numbers
    the forward of the whole batch takes from ``source`` (a generator or
    ``PresetDraws``, alike on every shard), a draw per image keeps this
    shard's slice of its batch axis (shard ``index`` of ``shards`` equal
    ones) and a draw per batch (a dropout keep-set) keeps all.  So every
    shard advances its source as the whole batch would, and the shards
    together draw what one forward of the whole batch draws."""

    def __init__(self, source, shards: int, index: int):
        self.source = source
        self.shards = shards
        self.index = index

    def take(self, shape, batch_dim, device) -> torch.Tensor:
        if batch_dim is None:
            return uniform_draws(self.source, shape, device)
        full = list(shape)
        n = full[batch_dim]
        full[batch_dim] = n * self.shards
        return uniform_draws(self.source, tuple(full), device).narrow(
            batch_dim, self.index * n, n)


Draws = Union[torch.Generator, PresetDraws, ShardDraws]


def uniform_draws(generator: Draws, shape, device,
                  batch_dim: Optional[int] = None) -> torch.Tensor:
    """float32 numbers of ``shape``, uniform in [-1, 1): the next ones of a
    ``PresetDraws``, or new ones from a ``torch.Generator`` on
    ``device``; ``batch_dim``, the batch axis of a draw per image, tells a
    ``ShardDraws`` which slice is its shard's."""
    if isinstance(generator, ShardDraws):
        return generator.take(shape, batch_dim, device)
    if isinstance(generator, PresetDraws):
        return generator.take(shape)
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device) * 2.0 - 1.0


def dropout_keep(generator: Draws, H: int, W: int, device) -> torch.Tensor:
    """The pixels one dropout round keeps, as flat indices into H x W: of
    H * W numbers drawn from ``generator`` (``uniform_draws``), the indices
    of the (H * W) // 2 smallest, in order.  A uniform random half, as JAX's
    ``permutation(key, H * W)[:H * W // 2]`` gives; numbers whose argsort is
    a given permutation keep exactly its first half."""
    hw = H * W
    return torch.argsort(uniform_draws(generator, (hw,), device))[: hw // 2]


def dropout_mask(generator: Draws, H: int, W: int, device) -> torch.Tensor:
    """``dropout_keep``'s pixels as a float32 [H, W] mask (1 kept)."""
    mask = torch.zeros(H * W, dtype=torch.float32, device=device)
    mask[dropout_keep(generator, H, W, device)] = 1.0
    return mask.reshape(H, W)


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
                      generator: Draws):
    """Damped solve on the active-DoF system, then the out-of-range uniform
    re-init of the shifts (reference models_kitti.py:1005-1033).

    hess [B, n, n] and g [B, n] are already active-dim sliced.  The re-init
    numbers are drawn every round (as the JAX package splits its key every
    round), from ``generator`` (``uniform_draws``).  Only a solve over all
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
        new = _reinit(new, uniform_draws(generator, (2, B), pose.device,
                                         batch_dim=1))
    return new


def _reinit(pose, rand):
    """The shifts of ``pose`` [B, 3] that left (-REINIT_RANGE,
    REINIT_RANGE) replaced by ``rand`` [2, B] (u, v)."""
    lim = REINIT_RANGE
    su, sv = pose[:, 0], pose[:, 1]
    return torch.stack([
        torch.where((su > -lim) & (su < lim), su, rand[0]),
        torch.where((sv > -lim) & (sv < lim), sv, rand[1]),
        pose[:, 2]], dim=-1)


def _safe_norm(x, floor: float):
    """L2 norm over the last axis, floored, with a NaN-free backward at 0:
    sqrt(max(sum_sq, floor^2)), whose clamp gates the sqrt's gradient."""
    return torch.sqrt(torch.clamp_min((x * x).sum(-1), floor * floor))


def _flatten(sat_feat, grd_feat, jac, cfg: LMConfig, grd_conf, keep):
    """The residual system of ``lm_update`` and ``gn_update`` (JAX
    ``_flatten_residual_system``): J [B, D, n] on the active DoFs, sat and
    grd [B, D] and the weight [B, D] (``grd_conf`` [B, H, W, 1] repeated
    over the channels, or None), in float32, over every (pixel, channel),
    or over the pixels ``keep`` (flat indices into H x W) holds."""
    f32 = torch.float32
    B, H, W, C = sat_feat.shape
    act = list(cfg.active_dims)
    J = jac[..., act].reshape(B, H * W, C, len(act))
    sat = sat_feat.reshape(B, H * W, C)
    grd = grd_feat.reshape(B, H * W, C)
    conf = None if grd_conf is None else grd_conf.reshape(B, H * W)
    if keep is not None:
        J, sat, grd = J[:, keep], sat[:, keep], grd[:, keep]
        conf = None if conf is None else conf[:, keep]
    weight = (None if conf is None
              else conf.to(f32).repeat_interleave(C, dim=-1))
    return (J.reshape(B, -1, len(act)).to(f32), sat.reshape(B, -1).to(f32),
            grd.reshape(B, -1).to(f32), weight)


def _normal_equations(J, r, w):
    """H = J^T W J [B, n, n] and g = J^T W r [B, n] (W = diag(w), or the
    identity where w is None), written as sums of products, one per pair
    of DoF, so no matrix product (and no TF32 mode) is involved."""
    cols = J.unbind(-1)
    wcols = cols if w is None else [a * w for a in cols]
    hess = torch.stack([torch.stack([(a * b).sum(1) for b in cols], -1)
                        for a in wcols], -2)
    g = torch.stack([(a * r).sum(1) for a in wcols], -1)
    return hess, g


def lm_update(pose, sat_feat, grd_feat, jac, damping_param, cfg: LMConfig,
              generator: Draws, grd_conf=None):
    """One damped Gauss-Newton (LM) update on a materialized Jacobian (port
    of JAX ``lm_update``, reference models_kitti.py:939-1041 for S2GP and
    Ford, ``normalize=True``, and :333-379 for G2SP, ``normalize=False``).

    sat_feat [B, H, W, C] the projected "moving" features, grd_feat
    [B, H, W, C] the target, jac [B, H, W, C, 3] d(sat_feat)/d(pose);
    grd_conf [B, H, W, 1] the target confidence, the residuals' weight with
    ``cfg.using_weight`` (else unused).  The residual is r = sat - grd over
    every (pixel, channel), or with ``cfg.dropout > 0`` and a
    ``generator`` over the pixels ``dropout_keep`` draws (first, before the
    re-init's numbers).  With ``normalize``, both sides are divided by
    their whole-map norms floored at 1e-6 (``_safe_norm``: an all-masked
    projection gives a zero vector, whose norm's backward would be 0/0).
    """
    H, W = sat_feat.shape[1:3]
    keep = (dropout_keep(generator, H, W, pose.device)
            if cfg.dropout > 0 and generator is not None else None)
    J, sat, grd, weight = _flatten(sat_feat, grd_feat, jac, cfg, grd_conf,
                                   keep)
    if cfg.normalize:
        sat_norm = _safe_norm(sat, 1e-6)
        sat = sat / sat_norm[:, None]
        J = J / sat_norm[:, None, None]
        grd = grd / _safe_norm(grd, 1e-6)[:, None]
    hess, g = _normal_equations(J, sat - grd,
                                weight if cfg.using_weight else None)
    return _solve_and_reinit(pose, hess, g, damping_param, cfg, generator)


def _feature_grad(r, jac, act):
    """sum over (h, w, c) of r * jac [B, n] on the active DoFs (JAX's
    ``einsum("bhwc,bhwcn->bn")``), as products and sums."""
    return (r.to(torch.float32)[..., None]
            * jac[..., act].to(torch.float32)).sum((1, 2, 3))


def _add_active(pose, act, delta):
    new = pose.clone()
    new[:, act] = new[:, act] + delta
    return new


def sgd_update(pose, sat_feat, grd_feat, jac, cfg: LMConfig,
               lr: float = 0.01):
    """Plain gradient step on the unnormalized L2 residual (port of JAX
    ``sgd_update``, reference models_kitti.py:1056-1084): grad = sum over
    (h, w, c) of 2 r d(sat)/d(pose), r = sat - grd; pose -= lr * grad on
    the active DoFs.  No draws."""
    act = list(cfg.active_dims)
    grad = _feature_grad(2 * (sat_feat.float() - grd_feat.float()), jac,
                         act)
    return _add_active(pose, act, -lr * grad)


def adam_update(pose, sat_feat, grd_feat, jac, m, v, t: int, cfg: LMConfig,
                beta1: float = 0.9, beta2: float = 0.999, lr: float = 0.01):
    """Adam-style step on ``sgd_update``'s gradient (port of JAX
    ``adam_update``, reference models_kitti.py:1086-1124): m, v [B, n] the
    moment accumulators of the forward, t the round index (0 first), which
    sets the bias corrections.  Returns (pose, m, v)."""
    act = list(cfg.active_dims)
    grad = _feature_grad(2 * (sat_feat.float() - grd_feat.float()), jac,
                         act)
    m = beta1 * m + (1 - beta1) * grad
    v = beta2 * v + (1 - beta2) * grad * grad
    m_hat = m / (1 - beta1 ** (t + 1))
    v_hat = v / (1 - beta2 ** (t + 1))
    delta = m_hat / (torch.sqrt(v_hat) + 1e-8)
    return _add_active(pose, act, -lr * delta), m, v


def gn_update(pose, sat_feat, grd_feat, grd_conf, jac, cfg: LMConfig,
              generator: Draws):
    """Undamped Gauss-Newton step, the Ford ``Optimizer=GN`` (port of JAX
    ``gn_update``, reference models_ford.py:534-598): the satellite side
    and J divided by the satellite features' whole-map norm (the target is
    not normalized), weighted by ``grd_conf`` with ``cfg.using_weight``,
    H delta = -J^T W r solved with a 1e-8 Tikhonov floor (finite where H is
    singular; the reference would raise), then, with a ``generator`` and
    all three DoF active, the out-of-range re-init of the shifts
    (whatever ``cfg.reinit`` says).  No dropout."""
    B = pose.shape[0]
    act = list(cfg.active_dims)
    n = len(act)
    J, sat, grd, weight = _flatten(sat_feat, grd_feat, jac, cfg, grd_conf,
                                   None)
    sat_norm = _safe_norm(sat, 1e-6)
    sat = sat / sat_norm[:, None]
    J = J / sat_norm[:, None, None]
    hess, g = _normal_equations(J, sat - grd,
                                weight if cfg.using_weight else None)
    eye = torch.eye(n, dtype=torch.float32, device=pose.device)
    sol, _ = torch.linalg.solve_ex(hess + 1e-8 * eye, g[..., None])
    new = _add_active(pose.to(torch.float32), act, -sol[..., 0])
    if generator is not None and n == 3:
        new = _reinit(new, uniform_draws(generator, (2, B), pose.device,
                                         batch_dim=1))
    return new


def sgd_update_l1(pose, sat_feat, grd_feat, jac, cfg: LMConfig,
                  lr: float = 0.001):
    """L1-subgradient step, the Ford ``Optimizer=SGD`` (port of JAX
    ``sgd_update_l1``, reference models_ford.py:609-634): grad = sum of
    sign(r) / (C * H * W) * d(sat)/d(pose).  No draws."""
    act = list(cfg.active_dims)
    H, W, C = sat_feat.shape[1:]
    r = sat_feat.float() - grd_feat.float()
    grad = _feature_grad(torch.sign(r) / (C * H * W), jac, act)
    return _add_active(pose, act, -lr * grad)


def _pair(Pa, Da, Pb, Db, m0, m1, m2):
    """Sum_v Sum_u duv_a[p] * duv_b[q] * S(v, u) with duv = P + u*D, from the
    u-moment sums m0, m1, m2 [B, V] of S."""
    def outer(X, Y, w):  # sum_v X[b,v,p] Y[b,v,q] w[b,v] -> [B, 3, 3]
        return (X[:, :, :, None] * Y[:, :, None, :]
                * w[:, :, None, None]).sum(1)
    return (outer(Pa, Pb, m0) + (outer(Pa, Db, m1) + outer(Da, Pb, m1))
            + outer(Da, Db, m2))


def lm_update_from_moments(pose, M, P0, dP, damping_param, cfg: LMConfig,
                           generator: Draws):
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
                       cfg: LMConfig, generator: Draws):
    """LM update from implicit (never materialized) Jacobians, the training
    path's update: differentiable with respect to every tensor argument.

    out, dx, dy [B, V, W, C] line samples and screen derivatives (K2's
    outputs, masked in bounds); grd [B, V, W, C] target rows; mask [V, W]
    ray mask; P0, dP [B, V, 2, 3] per-row affine duv coefficients in the
    (dx, dy) order of the samples.  The nine per-pixel channel moments
    under the ray mask, summed over u with weights 1, u, u^2, are exactly
    what K1 fuses, so the rest is ``lm_update_from_moments``.  The
    contraction is plain torch, as the JAX package left it to XLA.  With
    ``cfg.dropout > 0`` the mask also drops the pixels ``dropout_keep``
    leaves out (the same pixels ``lm_update`` would keep from the same
    numbers).
    """
    f32 = torch.float32
    mask = _dropped(mask, generator, cfg)
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


def _dropped(mask, generator, cfg: LMConfig):
    """``mask`` [..., H, W] times ``dropout_mask`` with ``cfg.dropout > 0``
    (JAX ``_implicit_moments``: dropped pixels leave the moments and the
    norms), else ``mask`` itself."""
    if cfg.dropout > 0 and generator is not None:
        H, W = mask.shape[-2:]
        return mask * dropout_mask(generator, H, W, mask.device)
    return mask


def _implicit_moments(out, dx, dy, grd, mask):
    """The moment preamble of the per-pixel implicit update and of
    ``lm_information`` (JAX ``_implicit_moments``; the caller folds the
    dropout into ``mask``): the nine per-pixel channel moments [B, H, W, 9] in
    ``MOM_IDX`` order under the mask [1|B, H, W], and the whole-map feature
    norms ns, ng [B] floored at 1e-6."""
    f32 = torch.float32
    m = mask.to(f32)[..., None]
    mom = channel_moments(out.to(f32), dx.to(f32), dy.to(f32), grd) * m
    ns = torch.sqrt(torch.clamp_min(mom[..., MOM_IDX["ss"]].sum((1, 2)),
                                    1e-12))
    ng = torch.sqrt(torch.clamp_min(mom[..., MOM_IDX["gg"]].sum((1, 2)),
                                    1e-12))
    return mom, ns, ng


def lm_update_implicit_pixel_norm(pose, out, dx, dy, grd, mask, duv,
                                  damping_param, cfg: LMConfig,
                                  generator: Draws):
    """The S2GP / Ford LM update from per-pixel implicit Jacobians, the
    gather path's (port of JAX ``lm_update_implicit_pixel_norm`` with its
    ``_implicit_moments``): ``lm_update`` on the Jacobian
    J = dx * duv_u + dy * duv_v, which is never materialized.  The nine
    per-pixel channel moments under the ray mask give H and g, with the
    whole-map feature norms floored at 1e-6 and r = s/ns - g/ng.

    out, dx, dy [B, H, W, C] sampled values and screen derivatives (masked
    in bounds by the sampler); grd [B, H, W, C] the target, unmasked;
    mask [1|B, H, W] the ray mask; duv [B, H, W, 2, 3].  Differentiable with
    respect to every tensor argument.  Dropout as in ``lm_update_implicit``.
    """
    f32 = torch.float32
    mom, ns, ng = _implicit_moments(out, dx, dy, grd,
                                    _dropped(mask, generator, cfg))

    def pix(name):
        return mom[..., MOM_IDX[name]]                    # [B, H, W]

    Du = duv[..., 0, :].to(f32)                           # [B, H, W, 3]
    Dv = duv[..., 1, :].to(f32)
    hess = _pixel_hessian(Du, Dv, pix("sxx"), pix("sxy"), pix("syy")) \
        / (ns * ns)[:, None, None]
    ss = (ns[:, None, None] ** 2)
    sg = (ns * ng)[:, None, None]
    qx = pix("dxs") / ss - pix("dxg") / sg
    qy = pix("dys") / ss - pix("dyg") / sg
    g = ((Du * qx[..., None]).sum((1, 2))
         + (Dv * qy[..., None]).sum((1, 2)))
    act = list(cfg.active_dims)
    return _solve_and_reinit(pose, hess[:, act][:, :, act], g[:, act],
                             damping_param, cfg, generator)


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


def lm_update_line_moments(pose, lm, damping_param, cfg: LMConfig):
    """The G2SP LM update from K7's per-line sums: the H and g of
    ``lm_update_implicit_pixel``, up to the order of the sums, already
    contracted over each line's samples by the kernel.

    lm [B, V, 9] per-line sums in ``LINEMOM_IDX`` order (H's six unique
    entries, then g), summed here over the lines.  Evaluation only; the
    damping used raw as ``cfg`` says; no re-init.
    """
    s = lm.to(torch.float32).sum(1)                        # [B, 9]
    hess = torch.stack([s[:, LINEMOM_IDX[k]] for k in (
        "h00", "h01", "h02", "h01", "h11", "h12", "h02", "h12", "h22")],
        -1).reshape(-1, 3, 3)
    g = s[:, LINEMOM_IDX["g0"]:]
    act = list(cfg.active_dims)
    return _solve_and_reinit(pose, hess[:, act][:, :, act], g[:, act],
                             damping_param, cfg._replace(reinit=False), None)


def lm_information(out, dx, dy, target, mask, duv, active_dims,
                   normalize: bool):
    """Gauss-Newton information of the LM objective at a pose (port of JAX
    ``lm_information``): the solver's own J^T J, from the moments of the
    gather path's update (``_implicit_moments``; the [B, H, W, C, 3]
    Jacobian is never materialized).

    out, dx, dy [B, H, W, C] sampled values and screen derivatives; target
    [B, H, W, C] the other branch's features (unmasked); mask [1|B, H, W]
    (all ones for the G2SP objective, whose residual keeps the pixels the
    sampler zeroes); duv [B, H, W, 2, 3].  ``normalize``: the S2GP / Ford
    residual r = s/ns - g/ng with the floored whole-map norms; else the
    G2SP residual r = out - target.

    Returns (hess [B, 3, 3] with zero rows and columns on inactive DoFs,
    rss [B] the residual sum of squares, n_res [B] the residual count).
    rss is summed from the residual itself: the ss + gg - 2 sg identity
    cancels catastrophically in float32 exactly where the fit is good.
    """
    f32 = torch.float32
    B, H, W, C = out.shape
    mom, ns, ng = _implicit_moments(out, dx, dy, target, mask)
    hess = _pixel_hessian(duv[..., 0, :].to(f32), duv[..., 1, :].to(f32),
                          *(mom[..., MOM_IDX[k]] for k in ("sxx", "sxy",
                                                          "syy")))
    m = mask.to(f32).expand(mask.shape[0], H, W)[..., None]
    out, tgt = out.to(f32), target.to(f32)
    if normalize:
        hess = hess / (ns * ns)[:, None, None]
        r = (out / ns[:, None, None, None]
             - tgt / ng[:, None, None, None]) * m
    else:
        r = (out - tgt) * m
    rss = (r * r).sum((1, 2, 3))
    n_res = (m[..., 0].sum((1, 2)) * C).expand(B)
    sel = torch.zeros(3, dtype=f32, device=hess.device)
    sel[list(active_dims)] = 1.0
    return hess * sel[None, :, None] * sel[None, None, :], rss, n_res


def pose_covariance(hess, rss, n_res, active_dims):
    """[B, 3, 3] pose covariance from ``lm_information``'s outputs (port of
    JAX ``pose_covariance``): sigma^2 H^-1 on the active block, sigma^2 =
    rss / (n_res - n), a float32 inverse with the relative Tikhonov floor
    1e-9 tr(H) / n + 1e-20 (a flat residual gives a large but finite
    covariance), and zero rows and columns on the inactive DoFs."""
    f32 = torch.float32
    act = list(active_dims)
    n = len(act)
    h = hess[:, act][:, :, act].to(f32)                   # [B, n, n]
    tr = torch.diagonal(h, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(n, dtype=f32, device=h.device)
    h = h + (1e-9 * tr / n + 1e-20)[:, None, None] * eye
    sigma2 = rss / torch.clamp_min(n_res - n, 1.0)
    # inv_ex: no host-side error check (which would wait for the device)
    cov_act = torch.linalg.inv_ex(h)[0] * sigma2[:, None, None]
    cov = torch.zeros(hess.shape[0], 3, 3, dtype=f32, device=h.device)
    idx = torch.tensor(act, device=h.device)
    cov[:, idx[:, None], idx[None, :]] = cov_act
    return cov
