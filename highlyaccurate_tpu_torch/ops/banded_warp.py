"""Banded line samplers: K1, the fused-moment sampler of evaluation, and
K2 / K3, the differentiable sampler of training and its map gradient (port
of ``highlyaccurate_tpu/ops/pallas/banded_warp.py:54-132, 272-273,
704-796, 1046-1116, 1147-1193, 1204-1335``).

The S2GP geo projection maps every ground row to a straight line in the
satellite map, affine in the ground column u.  K1 samples the map
bilinearly along each row's line, takes the screen derivatives, and
contracts them with the target row into the 9 channel moments the LM update
needs (``MOM_IDX``), each summed over u with weights 1, u, u^2: out
[B, V, 3, 16].  The [B, V, W, C] samples never reach device memory.  K2
emits those samples, out, dx, dy (and dxy, the cross derivative the
coefficient gradients need) as [B, V, W, C]; K3 gathers their gradients
back onto the map, each map tile from the samples that touch it.
``banded_sample`` ties K2 and K3 into one autograd function with the
coefficient gradients of the JAX custom VJP.

Each kernel's wrapper launches its CUDA kernel (``csrc/banded_moments.cu``,
``csrc/banded_sampler.cu``) on CUDA tensors, or raises; on CPU tensors it
runs the plain PyTorch version beside it, which the tests hold to the JAX
kernel.  ``banded_moments.launches``, ``banded_sample.launches`` (K2) and
``banded_sample_backward.launches`` (K3) count kernel launches.  The
forward launches, K1 and K2, are ``torch.library`` custom ops
(``highlyaccurate_tpu_torch::banded_moments``, ``::banded_sample``) whose
body is the ctypes launch and whose fake function gives the output shapes,
so that ``torch.export`` traces a program that launches the kernels (it
cannot trace through ctypes); they register when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from highlyaccurate_tpu_torch.ops import _build

_SHEAR_CHUNK = 8  # the TPU kernel's row-chunk size (sets n_chunks, lane 6)
_NCOEF = 8

# fused-moment vector layout (lane indices into the 16-lane output)
MOM_IDX = dict(ss=0, gg=1, sxx=2, sxy=3, syy=4, dxs=5, dys=6, dxg=7, dyg=8)
_MOM_LANES = 16


def default_rb(A: int) -> int:
    """Window height of the TPU kernel for an AxA map.  Here it only sets
    the validity guard of ``pack_row_coefs`` (rows whose in-bounds y-span
    exceeds RB - 3 are zeroed), which changes outputs and is kept."""
    return min(A, ((int(A * 0.47) + 13) // 8) * 8)


def pack_row_coefs(uv0, uv1, A: int, RB: int, W: int):
    """Per-row line coefficients [B, V, 8] float32:
    (ax, bx, ay, by, slope, oy, n_chunks, 0) from the uv of u = 0 and 1.

    Rows with |slope| >= 0.95, or an in-bounds y-span above RB - 3, get
    ax = 1e9 so every sample of the row is masked (the TPU kernel's 4-row
    shear could not serve them).  Lanes 4-6 are TPU schedule data; the CUDA
    kernel reads lanes 0-3 only.
    """
    Ac, Bc = uv0, uv1 - uv0
    ax, ay = Ac[..., 0], Ac[..., 1]
    bx, by = Bc[..., 0], Bc[..., 1]
    eps = 1e-12

    def safe(d):
        return torch.where(d.abs() > eps, d,
                           torch.where(d >= 0, eps, -eps).to(d.dtype))

    slope = by / safe(bx)

    # exact in-mask u-interval: x(u), y(u) in [0, A-1] and u in [0, W-1]
    def interval(a, b):
        lo = (0.0 - a) / safe(b)
        hi = ((A - 1.0) - a) / safe(b)
        return torch.minimum(lo, hi), torch.maximum(lo, hi)

    ux_lo, ux_hi = interval(ax, bx)
    uy_lo, uy_hi = interval(ay, by)
    u_lo = torch.clamp_min(torch.maximum(ux_lo, uy_lo), 0.0)
    u_hi = torch.clamp_max(torch.minimum(ux_hi, uy_hi), float(W - 1))
    u_hi = torch.maximum(u_hi, u_lo)  # empty interval -> all masked

    y_a = ay + by * u_lo
    y_b = ay + by * u_hi
    ymin = torch.clamp(torch.minimum(y_a, y_b), 0.0, A - 1.0)
    ymax = torch.clamp(torch.maximum(y_a, y_b), 0.0, A - 1.0)
    oy = torch.clamp(torch.floor(ymin) - 1.0, 0.0, float(max(A - RB, 0)))

    valid = (slope.abs() < 0.95) & ((ymax - ymin) <= (RB - 3))
    ax = torch.where(valid, ax, torch.full_like(ax, 1e9))

    n_chunks = torch.clamp(torch.ceil((ymax - oy + 4.0) / _SHEAR_CHUNK),
                           1.0, float(RB // _SHEAR_CHUNK))
    zeros = torch.zeros_like(ax)
    return torch.stack([ax, bx, ay, by, slope, oy, n_chunks, zeros],
                       dim=-1).to(torch.float32)


def _map_dtype(bf16_map: bool):
    return torch.bfloat16 if bf16_map else torch.float32


def _line_cells(coefs, W: int, A: int):
    """The bilinear cell of every sample on every row's line, as all three
    kernels sample: x = ax + bx*u, y = ay + by*u for u in [0, W).

    Returns x0, y0 (int64 [B, V, W], zero where masked), fx, fy and the
    mask m (float32 [B, V, W]: 1 where the sample is in the AxA map and
    clear of the edge quirk, floor(x) < A-1 and floor(y) < A-1).
    """
    f32 = torch.float32
    u = torch.arange(W, dtype=f32, device=coefs.device)
    ax, bx, ay, by = (coefs[..., i:i + 1] for i in range(4))
    x = ax + bx * u                                       # [B, V, W]
    y = ay + by * u
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    m = ((x >= 0) & (x <= A - 1) & (y >= 0) & (y <= A - 1)
         & (x0f < A - 1) & (y0f < A - 1)).to(f32)
    keep = m > 0
    x0 = torch.where(keep, x0f, torch.zeros_like(x0f)).long()
    y0 = torch.where(keep, y0f, torch.zeros_like(y0f)).long()
    return x0, y0, x - x0f, y - y0f, m


def banded_sample_reference(sat_k, coefs, W: int, with_dxy: bool):
    """Plain PyTorch K2 on packed coefficients.

    sat_k [B, A, A, C] in kernel axes (y, x), already in the map dtype;
    coefs [B, V, 8].  Returns (out, dx, dy) or, ``with_dxy``, (out, dx, dy,
    dxy), each [B, V, W, C] float32 and zero at masked samples:
    out = sum wx*gy*map, dx = sum dwx*gy*map, dy = sum wx*dgy*map,
    dxy = sum dwx*dgy*map, where wx and dwx carry the mask.
    """
    return bilinear_samples(sat_k, *_line_cells(coefs, W, sat_k.shape[1]),
                            with_dxy)


def bilinear_samples(map_k, x0, y0, fx, fy, m, with_dxy: bool):
    """The bilinear samples of map_k [B, AY, AX, C] at the cells (x0, y0,
    fx, fy, m [B, V, W]) of ``_line_cells`` or its projective sibling:
    (out, dx, dy[, dxy]), each [B, V, W, C] float32, zero where m is 0."""
    B = map_k.shape[0]
    f32 = torch.float32
    bi = torch.arange(B, device=map_k.device)[:, None, None]

    def corner(dy, dx):
        return map_k[bi, y0 + dy, x0 + dx].to(f32)        # [B, V, W, C]

    a, b, c, d = corner(0, 0), corner(0, 1), corner(1, 0), corner(1, 1)
    wxa = ((1.0 - fx) * m)[..., None]
    wxb = (fx * m)[..., None]
    gya = (1.0 - fy)[..., None]
    gyb = fy[..., None]
    mm = m[..., None]
    s = gya * (wxa * a + wxb * b) + gyb * (wxa * c + wxb * d)
    dx = mm * (gya * (b - a) + gyb * (d - c))
    dy = wxa * (c - a) + wxb * (d - b)
    if with_dxy:
        return s, dx, dy, mm * (a - b - c + d)
    return s, dx, dy


def banded_sample_backward_reference(coefs, g_o, g_dx, g_dy, A: int):
    """Plain PyTorch K3: the exact transpose of K2's (out, dx, dy).

    coefs [B, V, 8]; g_o, g_dx, g_dy [B, V, W, C] float32.  Each corner of
    each kept sample receives g_o*wx*gy + g_dx*dwx*gy + g_dy*wx*dgy.
    Returns the map gradient [B, A, A, C] float32 in kernel axes.
    """
    return bilinear_transpose(*_line_cells(coefs, g_o.shape[2], A), g_o,
                              g_dx, g_dy, A, A)


def bilinear_transpose(x0, y0, fx, fy, m, g_o, g_dx, g_dy, AY: int,
                       AX: int):
    """The transpose of ``bilinear_samples``'s (out, dx, dy) at the same
    cells: the map gradient [B, AY, AX, C] float32 of the cotangents
    g_o, g_dx, g_dy [B, V, W, C]."""
    B, V, W, C = g_o.shape
    wxa = ((1.0 - fx) * m)[..., None]
    wxb = (fx * m)[..., None]
    gya = (1.0 - fy)[..., None]
    gyb = fy[..., None]
    mm = m[..., None]
    gx = g_dx * mm
    grad = torch.zeros(B * AY * AX, C, dtype=torch.float32,
                       device=g_o.device)
    base = ((torch.arange(B, device=g_o.device)[:, None, None] * AY + y0)
            * AX + x0)                                    # [B, V, W]
    for t, off in ((g_o * wxa * gya - gx * gya - g_dy * wxa, 0),
                   (g_o * wxb * gya + gx * gya - g_dy * wxb, 1),
                   (g_o * wxa * gyb - gx * gyb + g_dy * wxa, AX),
                   (g_o * wxb * gyb + gx * gyb + g_dy * wxb, AX + 1)):
        grad.index_add_(0, (base + off).reshape(-1), t.reshape(-1, C))
    return grad.view(B, AY, AX, C)


def channel_moments(s, dx, dy, grd):
    """The nine per-pixel channel dots of float32 samples (s, dx, dy)
    [..., C] and the target ``grd`` [..., C] (cast to float32), in
    ``MOM_IDX`` order: [..., 9]."""
    g = grd.to(torch.float32)
    return torch.stack([
        (s * s).sum(-1), (g * g).sum(-1),
        (dx * dx).sum(-1), (dx * dy).sum(-1), (dy * dy).sum(-1),
        (dx * s).sum(-1), (dy * s).sum(-1),
        (dx * g).sum(-1), (dy * g).sum(-1)], dim=-1)


def moment_sums(s, dx, dy, grd, mask):
    """The LM moments of line samples, the contraction K1 fuses: the nine
    per-pixel channel dots of (s, dx, dy) and the target rows ``grd``
    (``channel_moments``) under the ray mask [V, W], each summed over u
    with weights 1, u, u^2.  Returns [B, V, 3, 9] float32."""
    f32 = torch.float32
    cols = channel_moments(s, dx, dy, grd)                # [B, V, W, 9]
    cols = cols * mask.to(f32)[None, :, :, None]
    u = torch.arange(mask.shape[1], dtype=f32, device=cols.device)
    wts = torch.stack([torch.ones_like(u), u, u * u])     # [3, W]
    return (cols[:, :, None] * wts[None, None, :, :, None]).sum(3)


def moments_from_coefs_reference(sat_k, grd, mask, coefs):
    """Plain PyTorch K1 on packed coefficients.

    sat_k [B, A, A, C] in kernel axes (y, x), already in the map dtype;
    grd [B, V, W, C]; mask [V, W]; coefs [B, V, 8].  Returns [B, V, 3, 16].
    """
    B = sat_k.shape[0]
    V, W = mask.shape
    s, dx, dy = banded_sample_reference(sat_k, coefs, W, with_dxy=False)
    out = torch.zeros(B, V, 3, _MOM_LANES, dtype=torch.float32,
                      device=grd.device)
    out[..., :len(MOM_IDX)] = moment_sums(s, dx, dy, grd, mask)
    return out


def banded_moments_reference(sat_k, grd, mask, uv0, uv1, *, RB: int,
                             bf16_map: bool):
    """Plain PyTorch version of ``banded_moments`` (same contract)."""
    A = sat_k.shape[1]
    W = mask.shape[1]
    coefs = pack_row_coefs(uv0, uv1, A, RB, W)
    return moments_from_coefs_reference(sat_k.to(_map_dtype(bf16_map)), grd,
                                        mask, coefs)


def _check(cond: bool, kernel: str, msg: str):
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def _check_inputs(kernel: str, coefs, B: int, V: int, W: int, C: int,
                  sat_k=None):
    """What every kernel of this module takes: float32 contiguous coefs
    [B, V, 8]; an even channel count; a grid within the CUDA limits; and,
    when given, a square bf16 or fp32 map on the coefs' device with unit
    channel stride and channel-pair alignment (a strided view is fine)."""
    _check(C % 2 == 0, kernel, f"channel count must be even, got {C}")
    _check(coefs.dtype == torch.float32 and coefs.is_contiguous()
           and tuple(coefs.shape) == (B, V, _NCOEF), kernel,
           f"coefs must be contiguous float32 [{B}, {V}, {_NCOEF}]")
    _check(B * V * ((W * C // 2 + 255) // 256) < 2 ** 31, kernel,
           "too many samples for one launch")
    if sat_k is None:
        return
    _check(sat_k.shape[1] == sat_k.shape[2], kernel,
           f"map must be square, got {tuple(sat_k.shape)}")
    _check(sat_k.device == coefs.device, kernel,
           f"coefs on {coefs.device}, map on {sat_k.device}")
    _check(sat_k.dtype in (torch.bfloat16, torch.float32), kernel,
           f"map must be bfloat16 or float32, got {sat_k.dtype}")
    _check(sat_k.stride(3) == 1 and all(s % 2 == 0 for s in sat_k.stride()[:3])
           and sat_k.data_ptr() % (2 * sat_k.element_size()) == 0, kernel,
           "map needs unit channel stride and channel-pair alignment")


@functools.lru_cache(maxsize=None)
def _entry(lib: str, name: str, argtypes: tuple):
    """A kernel's C entry point, built, loaded and typed once per process."""
    fn = getattr(_build.load(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _run(kernel: str, fn, dev, *args):
    """Call a launcher on the current stream of ``dev``; raise on a CUDA
    error from the launch."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _launch(sat_k, grd, mask, coefs, bf16_map: bool):
    """Validate and launch K1 on the current stream."""
    B, A, _, C = sat_k.shape
    V, W = mask.shape
    dev = sat_k.device
    k = "banded_moments"
    _check_inputs(k, coefs, B, V, W, C, sat_k)
    for name, t in (("grd", grd), ("mask", mask)):
        _check(t.device == dev, k, f"{name} on {t.device}, map on {dev}")
    _check(sat_k.dtype == _map_dtype(bf16_map), k,
           f"map dtype {sat_k.dtype} does not match bf16_map={bf16_map}")
    _check(grd.dtype == torch.float32 and tuple(grd.shape) == (B, V, W, C), k,
           f"grd must be float32 [{B}, {V}, {W}, {C}], got {grd.dtype} "
           f"{tuple(grd.shape)}")
    _check(grd[0].is_contiguous() and grd.stride(0) % 2 == 0
           and grd.data_ptr() % 8 == 0, k,
           "grd rows of one image must be contiguous")
    _check(mask.dtype == torch.float32 and mask.is_contiguous(), k,
           "mask must be contiguous float32 [V, W]")

    out = torch.empty(B, V, 3, _MOM_LANES, dtype=torch.float32, device=dev)
    fn = _entry("banded_moments", "banded_moments_launch",
                (_P,) * 5 + (_I,) * 5 + (_L,) * 4 + (_I, _P))
    _run(k, fn, dev, coefs.data_ptr(), sat_k.data_ptr(), grd.data_ptr(),
         mask.data_ptr(), out.data_ptr(), B, V, W, A, C, sat_k.stride(0),
         sat_k.stride(1), sat_k.stride(2), grd.stride(0), int(bf16_map))
    banded_moments.launches += 1
    return out


@torch.library.custom_op(
    "highlyaccurate_tpu_torch::banded_moments", mutates_args=(),
    schema="(Tensor sat_k, Tensor grd, Tensor mask, Tensor coefs, "
           "bool bf16_map) -> Tensor")
def _banded_moments_op(sat_k, grd, mask, coefs, bf16_map):
    return _launch(sat_k, grd, mask, coefs, bf16_map)


@_banded_moments_op.register_fake
def _(sat_k, grd, mask, coefs, bf16_map):
    return sat_k.new_empty(sat_k.shape[0], mask.shape[0], 3, _MOM_LANES,
                           dtype=torch.float32)


def moments_from_coefs(sat_k, grd, mask, coefs, *, bf16_map: bool):
    """K1 on packed row coefficients (``pack_row_coefs``): the CUDA kernel
    for CUDA tensors (or raises), the plain version for CPU tensors.
    ``sat_k`` must already be in the map dtype."""
    if sat_k.device.type == "cpu":
        return moments_from_coefs_reference(sat_k, grd, mask, coefs)
    _check(sat_k.device.type == "cuda", "banded_moments",
           f"unsupported device {sat_k.device}")
    return _banded_moments_op(sat_k, grd, mask, coefs, bf16_map)


def banded_moments(sat_k, grd, mask, uv0, uv1, *, RB: int, bf16_map: bool):
    """K1: fused LM moments of the bilinear line samples.

    sat_k [B, A, A, C] in kernel axes (kernel y = axis 1, x = axis 2; a
    strided view is fine as long as channels are unit-stride), cast to bf16
    when ``bf16_map`` (a no-op if it already is); grd [B, V, W, C] float32
    target rows; mask [V, W] float32 ray mask; uv0/uv1 [B, V, 2] kernel-axis
    (x, y) of each row's samples at u = 0 and 1.  Returns [B, V, 3, 16]
    float32 (rows: sum, u-sum, u^2-sum; lanes: ``MOM_IDX``, rest zero).

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    CUDA kernel, or raise.  Its work is bytes (the live target rows and
    the map corners the kept samples touch): the blocks of a row
    split its samples and form a thread-block cluster, lanes in groups of
    8-32 per sample keep 20 loads in flight each, masked samples are
    skipped, and the partial sums meet in a fixed order through distributed
    shared memory, so one launch per call gives the same bits every time.
    """
    coefs = pack_row_coefs(uv0, uv1, sat_k.shape[1], RB, mask.shape[1])
    return moments_from_coefs(sat_k.to(_map_dtype(bf16_map)), grd, mask,
                              coefs, bf16_map=bf16_map)


banded_moments.launches = 0


def banded_sample_forward(sat_k, coefs, W: int, *, with_dxy: bool):
    """K2 on packed row coefficients: the CUDA kernel for CUDA tensors (or
    raises), ``banded_sample_reference`` for CPU tensors.

    sat_k [B, A, A, C] in kernel axes, bf16 or fp32 (the map dtype; a
    strided view with unit channel stride is fine); coefs [B, V, 8].
    Returns (out, dx, dy[, dxy]) [B, V, W, C] float32.  Counts launches in
    ``banded_sample.launches``.
    """
    if sat_k.device.type == "cpu":
        return banded_sample_reference(sat_k, coefs, W, with_dxy)
    _check(sat_k.device.type == "cuda", "banded_sample",
           f"unsupported device {sat_k.device}")
    return tuple(_banded_sample_op(sat_k, coefs, W, with_dxy))


@torch.library.custom_op(
    "highlyaccurate_tpu_torch::banded_sample", mutates_args=(),
    schema="(Tensor sat_k, Tensor coefs, int W, bool with_dxy) -> Tensor[]")
def _banded_sample_op(sat_k, coefs, W, with_dxy):
    """Validate and launch K2 on the current stream."""
    k = "banded_sample"
    B, A, _, C = sat_k.shape
    V = coefs.shape[1]
    _check_inputs(k, coefs, B, V, W, C, sat_k)
    outs = tuple(torch.empty(B, V, W, C, dtype=torch.float32,
                             device=sat_k.device)
                 for _ in range(4 if with_dxy else 3))
    fn = _entry("banded_sampler", "banded_sample_launch",
                (_P,) * 6 + (_I,) * 5 + (_L,) * 3 + (_I, _P))
    _run(k, fn, sat_k.device, coefs.data_ptr(), sat_k.data_ptr(),
         *(o.data_ptr() for o in outs[:3]),
         outs[3].data_ptr() if with_dxy else None, B, V, W, A, C,
         sat_k.stride(0), sat_k.stride(1), sat_k.stride(2),
         int(sat_k.dtype == torch.bfloat16))
    banded_sample.launches += 1
    return list(outs)


@_banded_sample_op.register_fake
def _(sat_k, coefs, W, with_dxy):
    B, _, _, C = sat_k.shape
    return [sat_k.new_empty(B, coefs.shape[1], W, C, dtype=torch.float32)
            for _ in range(4 if with_dxy else 3)]


def banded_sample_backward(coefs, g_o, g_dx, g_dy, A: int):
    """K3: the map gradient [B, A, A, C] float32 (kernel axes) of K2's
    (out, dx, dy) under the cotangents g_o, g_dx, g_dy [B, V, W, C] float32.
    The CUDA kernel for CUDA tensors (or raises), the plain
    ``banded_sample_backward_reference`` for CPU tensors.

    Its work is bytes: the kept samples' cotangents read and the whole
    gradient written.  One block owns a tile of 8 x 4 map cells x 64
    channels of one image, gathers the samples with a corner in it (K2's
    own cell rounding decides), sums each (cell, channel) in one thread in
    (v, u) order, and writes the tile once, zeros included: no atomics, no
    zero fill, and two launches on the same inputs give the same bits.
    """
    if g_o.device.type == "cpu":
        return banded_sample_backward_reference(coefs, g_o, g_dx, g_dy, A)
    k = "banded_sample_backward"
    dev = g_o.device
    _check(dev.type == "cuda", k, f"unsupported device {dev}")
    B, V, W, C = g_o.shape
    _check_inputs(k, coefs, B, V, W, C)
    _check(coefs.device == dev, k, f"coefs on {coefs.device}, g_o on {dev}")
    for name, t in (("g_o", g_o), ("g_dx", g_dx), ("g_dy", g_dy)):
        _check(t.device == dev and t.dtype == torch.float32
               and t.is_contiguous() and t.shape == g_o.shape
               and t.data_ptr() % 8 == 0, k,
               f"{name} must be contiguous 8-byte aligned float32 "
               f"{tuple(g_o.shape)} on {dev}")
    _check(B < 65536, k, f"batch {B} exceeds the launch grid")
    grad = torch.empty(B, A, A, C, dtype=torch.float32, device=dev)
    fn = _entry("banded_sampler", "banded_sample_backward_launch",
                (_P,) * 5 + (_I,) * 5 + (_P,))
    _run(k, fn, dev, coefs.data_ptr(), g_o.data_ptr(), g_dx.data_ptr(),
         g_dy.data_ptr(), grad.data_ptr(), B, V, W, A, C)
    banded_sample_backward.launches += 1
    return grad


banded_sample_backward.launches = 0


class BandedSample(torch.autograd.Function):
    """K2 forward, K3 backward and the coefficient gradients of the JAX
    custom VJP (port of ``sample`` / ``sample_fwd`` / ``sample_bwd``,
    ``banded_warp.py:1240-1268``).

    ``apply(sat, coefs, W, bf16_map)``: sat [B, A, A, C] float32 in kernel
    axes (a strided view is fine), coefs [B, V, 8] -> (out, dx, dy).  The
    map is cast to bf16 here, inside the function, so the map gradient
    reaches ``sat`` in float32: K3 never reads the map.  The forward
    computes dxy, and saves it with coefs, dx and dy, only when the
    coefficients need a gradient.
    """

    @staticmethod
    def forward(ctx, sat, coefs, W, bf16_map):
        with_dxy = ctx.needs_input_grad[1]
        outs = banded_sample_forward(sat.to(_map_dtype(bf16_map)), coefs, W,
                                     with_dxy=with_dxy)
        ctx.A = sat.shape[1]
        ctx.save_for_backward(coefs, *outs[1:])
        return outs[:3]

    @staticmethod
    def backward(ctx, g_o, g_dx, g_dy):
        # autograd hands in zeros for an output that got no gradient
        coefs, dx, dy, *dxy = ctx.saved_tensors
        g_o, g_dx, g_dy = (g.contiguous() for g in (g_o, g_dx, g_dy))
        grad_sat = grad_coefs = None
        if ctx.needs_input_grad[0]:
            grad_sat = banded_sample_backward(coefs, g_o, g_dx, g_dy, ctx.A)
        if ctx.needs_input_grad[1]:
            # bilinear second derivatives: d2/dx2 = d2/dy2 = 0 almost
            # everywhere, the cross term dxy survives
            (dxy,) = dxy
            sx = (g_o * dx + g_dy * dxy).sum(-1)          # [B, V, W]
            sy = (g_o * dy + g_dx * dxy).sum(-1)
            u = torch.arange(dx.shape[2], dtype=torch.float32,
                             device=dx.device)
            zeros = torch.zeros_like(sx[..., 0])
            grad_coefs = torch.stack(
                [sx.sum(-1), (sx * u).sum(-1), sy.sum(-1), (sy * u).sum(-1),
                 zeros, zeros, zeros, zeros], dim=-1)
        return grad_sat, grad_coefs, None, None


def banded_sample(sat, uv0, uv1, *, W: int, RB: int, bf16_map: bool):
    """The differentiable banded line sampler (port of ``sample_uv``,
    ``banded_warp.py:1275-1279``).

    sat [B, A, A, C] in kernel axes (kernel y = axis 1, x = axis 2; a
    strided view is fine), sampled in float32 or, with ``bf16_map``, from a
    bf16 copy made inside the autograd function; uv0/uv1 [B, V, 2]
    kernel-axis (x, y) of each row's samples at u = 0 and 1; W samples per
    row.  Returns (out, dx, dy), each [B, V, W, C] float32, differentiable
    with respect to sat, uv0 and uv1 (through ``pack_row_coefs``, whose
    validity guard gives the rows it zeroes a zero gradient).
    """
    coefs = pack_row_coefs(uv0, uv1, sat.shape[1], RB, W)
    return BandedSample.apply(sat.to(torch.float32), coefs, W, bf16_map)


banded_sample.launches = 0
