"""Fused-moment banded line sampler, K1 (port of
``highlyaccurate_tpu/ops/pallas/banded_warp.py:54-60, 272-273, 704-796,
1282-1335``).

The S2GP geo projection maps every ground row to a straight line in the
satellite map, affine in the ground column u.  K1 samples the map
bilinearly along each row's line, takes the screen derivatives, and
contracts them with the target row into the 9 channel moments the LM update
needs (``MOM_IDX``), each summed over u with weights 1, u, u^2: out
[B, V, 3, 16].  The [B, V, W, C] samples never reach device memory.

``banded_moments`` is the wrapper: on CUDA tensors it launches the CUDA
kernel (``csrc/banded_moments.cu``) or raises; on CPU tensors it runs the
plain PyTorch version ``banded_moments_reference``, which the tests hold to
the JAX kernel.  ``banded_moments.launches`` counts kernel launches.
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


def moments_from_coefs_reference(sat_k, grd, mask, coefs):
    """Plain PyTorch K1 on packed coefficients.

    sat_k [B, A, A, C] in kernel axes (y, x), already in the map dtype;
    grd [B, V, W, C]; mask [V, W]; coefs [B, V, 8].  Returns [B, V, 3, 16].
    """
    B, A = sat_k.shape[:2]
    V, W = mask.shape
    f32 = torch.float32
    u = torch.arange(W, dtype=f32, device=grd.device)
    ax, bx, ay, by = (coefs[..., i:i + 1] for i in range(4))
    x = ax + bx * u                                       # [B, V, W]
    y = ay + by * u
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    m = ((x >= 0) & (x <= A - 1) & (y >= 0) & (y <= A - 1)
         & (x0f < A - 1) & (y0f < A - 1)).to(f32)
    keep = m > 0
    x0 = torch.where(keep, x0f, torch.zeros_like(x0f)).long()
    y0 = torch.where(keep, y0f, torch.zeros_like(y0f)).long()
    bi = torch.arange(B, device=grd.device)[:, None, None]

    def corner(dy, dx):
        return sat_k[bi, y0 + dy, x0 + dx].to(f32)        # [B, V, W, C]

    a, b, c, d = corner(0, 0), corner(0, 1), corner(1, 0), corner(1, 1)
    wxa = ((1.0 - fx) * m)[..., None]
    wxb = (fx * m)[..., None]
    gya = (1.0 - fy)[..., None]
    gyb = fy[..., None]
    mm = m[..., None]
    s = gya * (wxa * a + wxb * b) + gyb * (wxa * c + wxb * d)
    dx = mm * (gya * (b - a) + gyb * (d - c))
    dy = wxa * (c - a) + wxb * (d - b)
    g = grd.to(f32)

    cols = torch.stack([
        (s * s).sum(-1), (g * g).sum(-1),
        (dx * dx).sum(-1), (dx * dy).sum(-1), (dy * dy).sum(-1),
        (dx * s).sum(-1), (dy * s).sum(-1),
        (dx * g).sum(-1), (dy * g).sum(-1)], dim=-1)      # [B, V, W, 9]
    cols = cols * mask.to(f32)[None, :, :, None]
    wts = torch.stack([torch.ones_like(u), u, u * u])     # [3, W]
    mom = (cols[:, :, None] * wts[None, None, :, :, None]).sum(3)  # [B,V,3,9]
    out = torch.zeros(B, V, 3, _MOM_LANES, dtype=f32, device=grd.device)
    out[..., :len(MOM_IDX)] = mom
    return out


def banded_moments_reference(sat_k, grd, mask, uv0, uv1, *, RB: int,
                             bf16_map: bool):
    """Plain PyTorch version of ``banded_moments`` (same contract)."""
    A = sat_k.shape[1]
    W = mask.shape[1]
    coefs = pack_row_coefs(uv0, uv1, A, RB, W)
    return moments_from_coefs_reference(sat_k.to(_map_dtype(bf16_map)), grd,
                                        mask, coefs)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"banded_moments: {msg}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built and typed once per process."""
    fn = _build.load("banded_moments").banded_moments_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(sat_k, grd, mask, coefs, bf16_map: bool):
    """Validate and launch the CUDA kernel on the current stream."""
    B, A, A2, C = sat_k.shape
    V, W = mask.shape
    dev = sat_k.device
    _check(A == A2, f"map must be square, got {tuple(sat_k.shape)}")
    _check(C % 2 == 0, f"channel count must be even, got {C}")
    for name, t in (("grd", grd), ("mask", mask), ("coefs", coefs)):
        _check(t.device == dev, f"{name} on {t.device}, map on {dev}")
    _check(sat_k.dtype == _map_dtype(bf16_map),
           f"map dtype {sat_k.dtype} does not match bf16_map={bf16_map}")
    _check(sat_k.stride(3) == 1 and all(s % 2 == 0 for s in sat_k.stride()[:3])
           and sat_k.data_ptr() % (2 * sat_k.element_size()) == 0,
           "map needs unit channel stride and channel-pair alignment")
    _check(grd.dtype == torch.float32 and tuple(grd.shape) == (B, V, W, C),
           f"grd must be float32 [{B}, {V}, {W}, {C}], got {grd.dtype} "
           f"{tuple(grd.shape)}")
    _check(grd[0].is_contiguous() and grd.stride(0) % 2 == 0
           and grd.data_ptr() % 8 == 0,
           "grd rows of one image must be contiguous")
    _check(mask.dtype == torch.float32 and mask.is_contiguous(),
           "mask must be contiguous float32 [V, W]")
    _check(coefs.dtype == torch.float32 and coefs.is_contiguous()
           and tuple(coefs.shape) == (B, V, _NCOEF),
           f"coefs must be contiguous float32 [{B}, {V}, {_NCOEF}]")

    out = torch.empty(B, V, 3, _MOM_LANES, dtype=torch.float32, device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(coefs.data_ptr(), sat_k.data_ptr(), grd.data_ptr(),
                 mask.data_ptr(), out.data_ptr(), B, V, W, A, C,
                 sat_k.stride(0), sat_k.stride(1), sat_k.stride(2),
                 grd.stride(0), int(bf16_map), stream)
    if err != 0:
        raise RuntimeError(f"banded_moments kernel launch failed: CUDA error "
                           f"{err}")
    banded_moments.launches += 1
    return out


def moments_from_coefs(sat_k, grd, mask, coefs, *, bf16_map: bool):
    """K1 on packed row coefficients (``pack_row_coefs``): the CUDA kernel
    for CUDA tensors (or raises), the plain version for CPU tensors.
    ``sat_k`` must already be in the map dtype."""
    if sat_k.device.type == "cpu":
        return moments_from_coefs_reference(sat_k, grd, mask, coefs)
    if sat_k.device.type != "cuda":
        raise ValueError(f"banded_moments: unsupported device {sat_k.device}")
    return _launch(sat_k, grd, mask, coefs, bf16_map)


def banded_moments(sat_k, grd, mask, uv0, uv1, *, RB: int, bf16_map: bool):
    """K1: fused LM moments of the bilinear line samples.

    sat_k [B, A, A, C] in kernel axes (kernel y = axis 1, x = axis 2; a
    strided view is fine as long as channels are unit-stride), cast to bf16
    when ``bf16_map`` (a no-op if it already is); grd [B, V, W, C] float32
    target rows; mask [V, W] float32 ray mask; uv0/uv1 [B, V, 2] kernel-axis
    (x, y) of each row's samples at u = 0 and 1.  Returns [B, V, 3, 16]
    float32 (rows: sum, u-sum, u^2-sum; lanes: ``MOM_IDX``, rest zero).

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    CUDA kernel, or raise.
    """
    coefs = pack_row_coefs(uv0, uv1, sat_k.shape[1], RB, mask.shape[1])
    return moments_from_coefs(sat_k.to(_map_dtype(bf16_map)), grd, mask,
                              coefs, bf16_map=bf16_map)


banded_moments.launches = 0
