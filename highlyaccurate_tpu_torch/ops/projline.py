"""Projective-line sampler of the G2SP direction: K4, its forward, K5, the
map gradient, and K6, K4 fused with the per-pixel LM moments (port of
``highlyaccurate_tpu/ops/pallas/banded_warp.py:276, 1353-1412, 1744-1818,
1821-1870, 1963-2003, 2006-2114, 2117-2138, 2190-2263``).

Along one satellite column the ground-plane points form a 3D line, and the
perspective image of a line is a line: the homogeneous ground-map
coordinates h(u) = h0 + u*dh are affine in the satellite row u, so the
samples lie at x(u) = (nx0 + dnx*u) / (d0 + dd*u), y(u) likewise.  K4
samples the ground map [B, AY, AX, C] bilinearly at those points and emits
out, dx, dy (and dxy, the cross derivative the coefficient gradients need)
as [B, V, W, C]; K5 takes their gradients back onto the map, each tile of
the map gathered from the samples that touch it, in a fixed order (no
atomics: the card's map gradients are bit-repeatable).
``projline_sample`` ties K4 and K5 into one autograd function with the
coefficient gradients of the JAX custom VJP.  K6 (``projline_pixmom``,
evaluation only) samples as K4 does and contracts each sample's out, dx, dy
over the channels with the target row into the five moments of
``lm_update_pixel_moments`` (``PIXMOM_IDX``), so the [B, V, W, C] samples
never reach device memory.

Each wrapper launches its CUDA kernel (``csrc/projline_sampler.cu``) on CUDA
tensors, or raises; on CPU tensors it runs the plain PyTorch version beside
it, which the tests hold to the JAX kernel.
``projline_sample_forward.launches`` (K4),
``projline_sample_backward.launches`` (K5) and ``projline_pixmom.launches``
(K6) count kernel launches.  K4's forward and K6 launch through
``torch.library`` custom ops (``highlyaccurate_tpu_torch::projline_sample``,
``::projline_pixmom``), as K1 and K2 do (``ops/banded_warp.py``), so that
an exported program launches them.
"""

from __future__ import annotations

import torch

from highlyaccurate_tpu_torch.ops.banded_warp import (_I, _L, _P, _check,
                                                      _entry, _run,
                                                      bilinear_samples,
                                                      bilinear_transpose)

NCOEF = 16  # nx0 dnx ny0 dny d0 dd slope oy nck xref yref xlo xhi 0 0 0
# K6's moment lanes, r = out - target (banded_warp.py:276); the TPU kernel
# pads them to 16 lanes for its layout, this port emits these five
PIXMOM_IDX = dict(sxx=0, sxy=1, syy=2, rx=3, ry=4)
_SHEAR_CHUNK = 8                   # the TPU kernel's row-chunk size
_FULLMAP_VMEM_BUDGET = 9 * 2 ** 20  # the TPU kernel's bf16 map residency


def projline_supported(AY: int, AX: int, C: int) -> bool:
    """Whether the JAX package's projective-line sampler serves this ground
    map shape (8-row chunks, bf16 map resident in VMEM).  Elsewhere the
    level takes the gather sampler, in JAX and here (``models/lm_g2sp.py``
    ``projline_slots``)."""
    return AY % _SHEAR_CHUNK == 0 and AY * AX * C * 2 <= _FULLMAP_VMEM_BUDGET


def pack_projline_coefs(h0, dh, AY: int, AX: int, RB: int, W: int):
    """Per-line coefficients [B, V, 16] float32 from the homogeneous image
    coordinates h0, dh [B, V, 3] of each line's samples, h(u) = h0 + u*dh.

    Lanes 0-5 are (nx0, dnx, ny0, dny, d0, dd); a line without a non-empty
    in-map interval, with |slope| >= 0.95, with a y-span above RB - 3 or a
    near-vertical image line gets nx0 = 1e9, dnx = dd = 0, d0 = 1, so every
    sample is masked.  Lanes 6-12 (slope, oy, nck, xref, yref, xlo, xhi) are
    the TPU kernel's schedule data, copied lane for lane; the CUDA kernels
    read lanes 0-5 only.  The gradient reaches h0 and dh through lanes 0-5
    of the valid lines; the guard and the schedule lanes carry none.
    """
    eps = 1e-6
    f32 = torch.float32
    h0, dh = h0.to(f32), dh.to(f32)
    nx0, ny0, d0 = h0.detach().unbind(-1)
    dnx, dny, dd = dh.detach().unbind(-1)

    # the image line through all projections: l = h0 x h1 (homogeneous)
    h1x, h1y, h1z = nx0 + dnx, ny0 + dny, d0 + dd
    la = ny0 * h1z - d0 * h1y
    lb = d0 * h1x - nx0 * h1z
    lc = nx0 * h1y - ny0 * h1x

    def signed_eps(t):
        return torch.where(t >= 0, eps, -eps).to(f32)

    safe_lb = torch.where(lb.abs() > eps, lb, signed_eps(lb))
    slope = -la / safe_lb
    xref = torch.full_like(slope, (AX - 1) / 2.0)
    yref = (-lc - la * xref) / safe_lb

    # valid-u interval: with den > 0 every constraint is affine in u
    #   den - eps >= 0; x >= 0; x <= AX-1; y >= 0; y <= AY-1
    cons_a = torch.stack([d0 - eps, nx0, (AX - 1.0) * d0 - nx0,
                          ny0, (AY - 1.0) * d0 - ny0], -1)
    cons_b = torch.stack([dd, dnx, (AX - 1.0) * dd - dnx,
                          dny, (AY - 1.0) * dd - dny], -1)
    bpos = cons_b > eps
    bneg = cons_b < -eps
    ratio = -cons_a / torch.where(cons_b.abs() > eps, cons_b,
                                  torch.ones_like(cons_b))
    lo = torch.clamp_min(torch.where(bpos, ratio, 0.0).amax(-1), 0.0)
    hi = torch.clamp_max(torch.where(bneg, ratio, W - 1.0).amin(-1), W - 1.0)
    flat_bad = ((~bpos) & (~bneg) & (cons_a < 0)).any(-1)
    nonempty = (hi >= lo) & ~flat_bad

    def at(num0, dnum, den0, dden, u):
        den = den0 + dden * u
        return (num0 + dnum * u) / torch.where(den > eps, den,
                                               torch.ones_like(den))

    ya, yb = at(ny0, dny, d0, dd, lo), at(ny0, dny, d0, dd, hi)
    ymin = torch.clamp(torch.minimum(ya, yb), 0.0, AY - 1.0)
    ymax = torch.clamp(torch.maximum(ya, yb), 0.0, AY - 1.0)
    oy = torch.clamp(torch.floor(ymin) - 1.0, 0.0, float(max(AY - RB, 0)))
    nck = torch.clamp(torch.ceil((ymax - oy + 4.0) / _SHEAR_CHUNK), 1.0,
                      float(RB // _SHEAR_CHUNK))

    valid = (nonempty & (slope.abs() < 0.95)
             & ((ymax - ymin) <= (RB - 3)) & (lb.abs() > eps))

    def guard(t, bad):
        return torch.where(valid, t, torch.full_like(t, bad))

    # invalid lines: x far out of bounds with a safe denominator
    nx0_v, dnx_v = guard(h0[..., 0], 1e9), guard(dh[..., 0], 0.0)
    d0_v, dd_v = guard(h0[..., 2], 1.0), guard(dh[..., 2], 0.0)

    # x-extent of the valid segment (x(u) is monotone on [lo, hi])
    g0, g1, g2, g3 = (t.detach() for t in (nx0_v, dnx_v, d0_v, dd_v))
    xa, xb = at(g0, g1, g2, g3, lo), at(g0, g1, g2, g3, hi)
    xlo = guard(torch.clamp(torch.minimum(xa, xb), 0.0, AX - 1.0),
                float(AX + 10))
    xhi = guard(torch.clamp(torch.maximum(xa, xb), 0.0, AX - 1.0), -10.0)

    z = torch.zeros_like(slope)
    return torch.stack([nx0_v, dnx_v, h0[..., 1], dh[..., 1], d0_v, dd_v,
                        slope, oy, nck, xref, yref, xlo, xhi, z, z, z], -1)


def _projline_coords(coefs, W: int):
    """x, y [B, V, W] of every sample and the in-front flag, with the
    kernels' roundings: den = d0 + dd*u, deni = 1/den (1 behind the
    camera), x = (nx0 + dnx*u)*deni."""
    u = torch.arange(W, dtype=torch.float32, device=coefs.device)
    nx0, dnx, ny0, dny, d0, dd = (coefs[..., i:i + 1] for i in range(6))
    den = d0 + dd * u
    infront = den > 1e-6
    deni = 1.0 / torch.where(infront, den, torch.ones_like(den))
    return (nx0 + dnx * u) * deni, (ny0 + dny * u) * deni, infront, deni


def _projline_cells(coefs, W: int, AY: int, AX: int):
    """The bilinear cell of every sample of every line: x0, y0 (int64
    [B, V, W], zero where masked), fx, fy and the mask m (float32: 1 where
    the sample is in front of the camera, in the AY x AX map and clear of
    the edge quirk, floor(x) < AX-1 and floor(y) < AY-1)."""
    x, y, infront, _ = _projline_coords(coefs, W)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    keep = (infront & (x >= 0) & (x <= AX - 1) & (y >= 0) & (y <= AY - 1)
            & (x0f < AX - 1) & (y0f < AY - 1))
    zero = torch.zeros_like(x0f)
    return (torch.where(keep, x0f, zero).long(),
            torch.where(keep, y0f, zero).long(),
            x - x0f, y - y0f, keep.to(torch.float32))


def projline_sample_reference(grd_k, coefs, W: int, with_dxy: bool):
    """Plain PyTorch K4: grd_k [B, AY, AX, C] ground map (already in the map
    dtype), coefs [B, V, 16] -> (out, dx, dy[, dxy]) [B, V, W, C] float32,
    zero at masked samples."""
    AY, AX = grd_k.shape[1:3]
    return bilinear_samples(grd_k, *_projline_cells(coefs, W, AY, AX),
                            with_dxy)


def projline_sample_backward_reference(coefs, g_o, g_dx, g_dy, AY: int,
                                       AX: int):
    """Plain PyTorch K5: the exact transpose of K4's (out, dx, dy) under the
    cotangents g_o, g_dx, g_dy [B, V, W, C] -> [B, AY, AX, C] float32."""
    cells = _projline_cells(coefs, g_o.shape[2], AY, AX)
    return bilinear_transpose(*cells, g_o, g_dx, g_dy, AY, AX)


def _check_coefs(kernel: str, coefs, B: int, V: int, W: int, C: int):
    _check(C % 2 == 0, kernel, f"channel count must be even, got {C}")
    _check(coefs.dtype == torch.float32 and coefs.is_contiguous()
           and tuple(coefs.shape) == (B, V, NCOEF), kernel,
           f"coefs must be contiguous float32 [{B}, {V}, {NCOEF}]")
    _check(B * V * ((W * C // 2 + 255) // 256) < 2 ** 31, kernel,
           "too many samples for one launch")


def projline_sample_forward(grd_k, coefs, W: int, *, with_dxy: bool):
    """K4: the CUDA kernel for CUDA tensors (or raises),
    ``projline_sample_reference`` for CPU tensors.

    grd_k [B, AY, AX, C] ground map, bf16 or fp32 (a strided view with unit
    channel stride is fine); coefs [B, V, 16]; W samples per line.  Returns
    (out, dx, dy[, dxy]) [B, V, W, C] float32.
    """
    if grd_k.device.type == "cpu":
        return projline_sample_reference(grd_k, coefs, W, with_dxy)
    _check(grd_k.device.type == "cuda", "projline_sample",
           f"unsupported device {grd_k.device}")
    return tuple(_projline_sample_op(grd_k, coefs, W, with_dxy))


@torch.library.custom_op(
    "highlyaccurate_tpu_torch::projline_sample", mutates_args=(),
    schema="(Tensor grd_k, Tensor coefs, int W, bool with_dxy) -> Tensor[]")
def _projline_sample_op(grd_k, coefs, W, with_dxy):
    """Validate and launch K4 on the current stream."""
    k = "projline_sample"
    dev = grd_k.device
    B, AY, AX, C = grd_k.shape
    V = coefs.shape[1]
    _check_coefs(k, coefs, B, V, W, C)
    _check(coefs.device == dev, k, f"coefs on {coefs.device}, map on {dev}")
    _check(grd_k.dtype in (torch.bfloat16, torch.float32), k,
           f"map must be bfloat16 or float32, got {grd_k.dtype}")
    _check(grd_k.stride(3) == 1 and all(s % 2 == 0 for s in grd_k.stride()[:3])
           and grd_k.data_ptr() % (2 * grd_k.element_size()) == 0, k,
           "map needs unit channel stride and channel-pair alignment")
    outs = tuple(torch.empty(B, V, W, C, dtype=torch.float32, device=dev)
                 for _ in range(4 if with_dxy else 3))
    fn = _entry("projline_sampler", "projline_sample_launch",
                (_P,) * 6 + (_I,) * 6 + (_L,) * 3 + (_I, _P))
    _run(k, fn, dev, coefs.data_ptr(), grd_k.data_ptr(),
         *(o.data_ptr() for o in outs[:3]),
         outs[3].data_ptr() if with_dxy else None, B, V, W, AY, AX, C,
         grd_k.stride(0), grd_k.stride(1), grd_k.stride(2),
         int(grd_k.dtype == torch.bfloat16))
    projline_sample_forward.launches += 1
    return list(outs)


@_projline_sample_op.register_fake
def _(grd_k, coefs, W, with_dxy):
    B, _, _, C = grd_k.shape
    return [grd_k.new_empty(B, coefs.shape[1], W, C, dtype=torch.float32)
            for _ in range(4 if with_dxy else 3)]


projline_sample_forward.launches = 0


def projline_sample_backward(coefs, g_o, g_dx, g_dy, AY: int, AX: int):
    """K5: the map gradient [B, AY, AX, C] float32 of K4's (out, dx, dy)
    under the cotangents g_o, g_dx, g_dy [B, V, W, C] float32.  The CUDA
    kernel for CUDA tensors (or raises; it writes every element, each map
    cell's sum in a fixed order, so two launches give the same bits),
    ``projline_sample_backward_reference`` for CPU tensors."""
    if g_o.device.type == "cpu":
        return projline_sample_backward_reference(coefs, g_o, g_dx, g_dy,
                                                  AY, AX)
    k = "projline_sample_backward"
    dev = g_o.device
    _check(dev.type == "cuda", k, f"unsupported device {dev}")
    B, V, W, C = g_o.shape
    _check_coefs(k, coefs, B, V, W, C)
    _check(coefs.device == dev, k, f"coefs on {coefs.device}, g_o on {dev}")
    for name, t in (("g_o", g_o), ("g_dx", g_dx), ("g_dy", g_dy)):
        _check(t.device == dev and t.dtype == torch.float32
               and t.is_contiguous() and t.shape == g_o.shape
               and t.data_ptr() % 8 == 0, k,
               f"{name} must be contiguous 8-byte aligned float32 "
               f"{tuple(g_o.shape)} on {dev}")
    _check(B < 65536, k, f"batch {B} exceeds the launch grid")
    grad = torch.empty(B, AY, AX, C, dtype=torch.float32, device=dev)
    fn = _entry("projline_sampler", "projline_sample_backward_launch",
                (_P,) * 5 + (_I,) * 6 + (_P,))
    _run(k, fn, dev, coefs.data_ptr(), g_o.data_ptr(), g_dx.data_ptr(),
         g_dy.data_ptr(), grad.data_ptr(), B, V, W, AY, AX, C)
    projline_sample_backward.launches += 1
    return grad


projline_sample_backward.launches = 0


def projline_coef_grads(coefs, g_o, g_dx, g_dy, dx, dy, dxy):
    """The gradient [B, V, 16] of K4's (out, dx, dy) with respect to the
    coefficients (``sample_bwd``, banded_warp.py:2070-2091): the bilinear
    surface's second derivatives vanish almost everywhere but the cross
    term dxy, and x = (nx0 + dnx*u)/den, y = (ny0 + dny*u)/den with
    den = d0 + dd*u give lanes 0-5 by the quotient rule; lanes 6-15 get
    zero."""
    x, y, infront, deni = _projline_coords(coefs, g_o.shape[2])
    deni = deni * infront.to(torch.float32)
    x, y = x * infront, y * infront
    u = torch.arange(g_o.shape[2], dtype=torch.float32, device=coefs.device)
    g_x = (g_o * dx + g_dy * dxy).sum(-1)                 # [B, V, W]
    g_y = (g_o * dy + g_dx * dxy).sum(-1)
    gd = g_x * deni
    ge = g_y * deni
    gden = -(x * g_x + y * g_y) * deni
    zeros = torch.zeros_like(gd[..., 0])
    return torch.stack([gd.sum(-1), (gd * u).sum(-1), ge.sum(-1),
                        (ge * u).sum(-1), gden.sum(-1), (gden * u).sum(-1)]
                       + [zeros] * (NCOEF - 6), dim=-1)


class ProjlineSample(torch.autograd.Function):
    """K4 forward, K5 backward and the coefficient gradients of the JAX
    custom VJP (port of ``sample`` / ``sample_fwd`` / ``sample_bwd``,
    banded_warp.py:2053-2092).

    ``apply(grd_map, coefs, W)``: grd_map [B, AY, AX, C] float32, coefs
    [B, V, 16] -> (out, dx, dy).  The map is cast to bf16 here, inside the
    function, so its gradient reaches ``grd_map`` in float32: K5 never
    reads the map.  The forward computes dxy, and saves dx, dy and dxy
    beside the coefs, only when the coefficients need a gradient (not in
    round 1, whose pose is constant).
    """

    @staticmethod
    def forward(ctx, grd_map, coefs, W):
        with_dxy = ctx.needs_input_grad[1]
        outs = projline_sample_forward(grd_map.to(torch.bfloat16), coefs, W,
                                       with_dxy=with_dxy)
        ctx.map_hw = tuple(grd_map.shape[1:3])
        ctx.save_for_backward(coefs, *(outs[1:] if with_dxy else ()))
        return outs[:3]

    @staticmethod
    def backward(ctx, g_o, g_dx, g_dy):
        # autograd hands in zeros for an output that got no gradient
        coefs, *saved = ctx.saved_tensors
        g_o, g_dx, g_dy = (g.contiguous() for g in (g_o, g_dx, g_dy))
        grad_map = grad_coefs = None
        if ctx.needs_input_grad[0]:
            grad_map = projline_sample_backward(coefs, g_o, g_dx, g_dy,
                                                *ctx.map_hw)
        if ctx.needs_input_grad[1]:
            grad_coefs = projline_coef_grads(coefs, g_o, g_dx, g_dy, *saved)
        return grad_map, grad_coefs, None


def projline_sample(grd_map, coefs, *, W: int):
    """The differentiable projective-line sampler (port of
    ``make_projline_sampler(differentiable=True)``'s ``sample_pub``,
    banded_warp.py:2108-2112).

    grd_map [B, AY, AX, C] ground map (any float dtype; sampled from a bf16
    copy made inside the autograd function), coefs [B, V, 16] from
    ``pack_projline_coefs``, W samples per line.  Returns (out, dx, dy),
    each [B, V, W, C] float32, differentiable with respect to grd_map and
    coefs (lanes 0-5).
    """
    return ProjlineSample.apply(grd_map.to(torch.float32),
                                coefs.to(torch.float32), W)


def pixel_moments(out, dx, dy, tgt):
    """The five per-pixel channel moments of the G2SP residual r = out - tgt
    (``_pixmom_from_accs``, banded_warp.py:2117-2138): out, dx, dy, tgt
    [..., C] -> (sxx, sxy, syy, rx, ry), each [...] float32, the
    ``PIXMOM_IDX`` order.  A masked sample has zero dx and dy, so all five
    are zero."""
    r = out - tgt.to(torch.float32)
    return ((dx * dx).sum(-1), (dx * dy).sum(-1), (dy * dy).sum(-1),
            (dx * r).sum(-1), (dy * r).sum(-1))


def projline_pixmom_reference(grd_k, tgt, coefs, W: int):
    """Plain PyTorch K6: K4's samples of grd_k [B, AY, AX, C] (already in
    the map dtype) along the lines of coefs [B, V, 16], contracted with the
    target rows tgt [B, V, W, C] (any strides) -> [B, V, W, 5] float32."""
    out, dx, dy = projline_sample_reference(grd_k, coefs, W, with_dxy=False)
    return torch.stack(pixel_moments(out, dx, dy, tgt), dim=-1)


def projline_pixmom(grd_map, tgt, coefs, W: int):
    """K6, the fused per-pixel moments of G2SP evaluation (port of
    ``make_projline_pixmom``, banded_warp.py:2237-2263): the CUDA kernel for
    CUDA tensors (or raises), ``projline_pixmom_reference`` for CPU tensors.

    grd_map [B, AY, AX, C] ground map, sampled from a bf16 copy (a no-op
    for a bf16 map; unit channel stride); tgt [B, V, W, C] float32 target
    rows in line order, any strides with unit channel stride (the model
    passes a transposed view of the satellite features); coefs [B, V, 16]
    from ``pack_projline_coefs``.  The CUDA kernel loads 8 channels at a
    time, so on the card C must be a multiple of 8 and the rows of the map
    and the target 16-byte aligned; it raises otherwise.  Returns
    [B, V, W, 5] float32 in ``PIXMOM_IDX`` lane order: the TPU kernel's
    16-lane padding is a layout of its own, so only the five used lanes
    are written.  Evaluation only, as in JAX: it has no gradient and raises
    if autograd would need one.
    """
    k = "projline_pixmom"
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (grd_map, tgt, coefs)):
        raise RuntimeError(f"{k} (K6) is evaluation-only and has no "
                           "gradient; training samples with projline_sample")
    grd_k = grd_map.to(torch.bfloat16)
    B, AY, AX, C = grd_k.shape
    V = coefs.shape[1]
    _check_coefs(k, coefs, B, V, W, C)
    _check(tuple(tgt.shape) == (B, V, W, C), k,
           f"tgt must be [{B}, {V}, {W}, {C}], got {tuple(tgt.shape)}")
    if grd_k.device.type == "cpu":
        return projline_pixmom_reference(grd_k, tgt, coefs, W)
    _check(grd_k.device.type == "cuda", k,
           f"unsupported device {grd_k.device}")
    return _projline_pixmom_op(grd_k, tgt, coefs, W)


@torch.library.custom_op(
    "highlyaccurate_tpu_torch::projline_pixmom", mutates_args=(),
    schema="(Tensor grd_k, Tensor tgt, Tensor coefs, int W) -> Tensor")
def _projline_pixmom_op(grd_k, tgt, coefs, W):
    """Validate and launch K6 on the current stream."""
    k = "projline_pixmom"
    dev = grd_k.device
    B, AY, AX, C = grd_k.shape
    V = coefs.shape[1]
    _check(coefs.device == dev and tgt.device == dev, k,
           f"coefs on {coefs.device}, tgt on {tgt.device}, map on {dev}")
    # the kernel loads 8 channels at a time, 16 bytes of map, 32 of target
    _check(C % 8 == 0, k, f"channel count must be a multiple of 8, got {C}")
    _check(grd_k.stride(3) == 1 and all(s % 8 == 0 for s in grd_k.stride()[:3])
           and grd_k.data_ptr() % 16 == 0, k,
           "map needs unit channel stride and 16-byte-aligned rows")
    _check(tgt.dtype == torch.float32 and tgt.stride(3) == 1
           and all(s % 4 == 0 for s in tgt.stride()[:3])
           and tgt.data_ptr() % 16 == 0, k,
           "tgt must be float32 with unit channel stride and 16-byte-aligned "
           "rows")
    pm = torch.empty(B, V, W, len(PIXMOM_IDX), dtype=torch.float32,
                     device=dev)
    fn = _entry("projline_sampler", "projline_pixmom_launch",
                (_P,) * 4 + (_I,) * 6 + (_L,) * 6 + (_P,))
    _run(k, fn, dev, coefs.data_ptr(), grd_k.data_ptr(), tgt.data_ptr(),
         pm.data_ptr(), B, V, W, AY, AX, C, *grd_k.stride()[:3],
         *tgt.stride()[:3])
    projline_pixmom.launches += 1
    return pm


@_projline_pixmom_op.register_fake
def _(grd_k, tgt, coefs, W):
    return grd_k.new_empty(grd_k.shape[0], coefs.shape[1], W,
                           len(PIXMOM_IDX), dtype=torch.float32)


projline_pixmom.launches = 0
