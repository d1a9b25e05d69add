"""Native host-side warp kernels, C++ through ctypes (port of
``highlyaccurate_tpu/native/``, a copy: no framework).

``warp.cpp`` is built by ``g++`` on first use into ``build/native/`` at the
repository root (a directory git ignores), named by a hash of the source,
the flags and the host CPU, so an edited source or another machine builds
anew.  Exposes:

  * ``affine_warp(img, matrix, out_hw)`` — one bilinear affine pass
    (PIL Image.transform AFFINE BILINEAR sampling convention, zero fill);
  * ``compose_affine(*mats)`` — compose output->source 6-dof maps;
  * ``fused_synthesize_matrix(...)`` — the KITTI GT-synthesis chain
    (rotate -> camera-offset affine -> gt-shift affine -> rotate -> crop,
    reference dataLoader/KITTI_dataset.py:128-152) collapsed to ONE matrix
    for the fast single-pass training path.

This is host data preparation (``data/kitti.py`` uses it for the train
split when ``available()``), not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "warp.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (``-march=native`` depends
    on them), or nothing where /proc/cpuinfo is not readable."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()
                            + _host_cpu()).hexdigest()
    return BUILD_DIR / f"_warp_{digest[:16]}.so"


def _build() -> Path:
    """Compile ``warp.cpp`` unless its library exists; the library is
    written under a temporary name and renamed into place, so concurrent
    builds never load a half-written file."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            d = ctypes.c_double
            i = ctypes.c_int
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.affine_warp_u8.argtypes = [u8p, i, i, i, u8p, i, i,
                                           d, d, d, d, d, d]
            lib.affine_warp_f32.argtypes = [f32p, i, i, i, f32p, i, i,
                                            d, d, d, d, d, d]
            lib.affine_warp_u8_to_f32.argtypes = [u8p, i, i, i, f32p, i, i,
                                                  d, d, d, d, d, d]
            for fn in (lib.affine_warp_u8, lib.affine_warp_f32,
                       lib.affine_warp_u8_to_f32):
                fn.restype = None
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def affine_warp(img: np.ndarray, matrix, out_hw: Tuple[int, int],
                normalize: bool = False) -> np.ndarray:
    """Warp ``img`` [H, W, C] by the output->source affine ``matrix``
    (a, b, tx, d, e, ty).  uint8 in -> uint8 out (or float32 /255 when
    ``normalize``); float32 in -> float32 out."""
    lib = _load()
    a, b, tx, d, e, ty = (float(v) for v in matrix)
    oh, ow = out_hw
    img = np.ascontiguousarray(img)
    sh, sw, c = img.shape
    if img.dtype == np.uint8 and normalize:
        out = np.empty((oh, ow, c), np.float32)
        lib.affine_warp_u8_to_f32(img, sh, sw, c, out, oh, ow, a, b, tx, d, e, ty)
    elif img.dtype == np.uint8:
        out = np.empty((oh, ow, c), np.uint8)
        lib.affine_warp_u8(img, sh, sw, c, out, oh, ow, a, b, tx, d, e, ty)
    elif img.dtype == np.float32:
        out = np.empty((oh, ow, c), np.float32)
        lib.affine_warp_f32(img, sh, sw, c, out, oh, ow, a, b, tx, d, e, ty)
    else:
        raise TypeError(f"unsupported dtype {img.dtype}")
    return out


def _mat3(m6):
    a, b, tx, d, e, ty = m6
    return np.array([[a, b, tx], [d, e, ty], [0, 0, 1.0]])


def compose_affine(*m6s):
    """Compose output->source maps applied in pipeline order.

    If pass 1 maps its output coords to its source (the original image) via
    M1, and pass 2 maps ITS output to pass-1's output via M2, the fused
    output->original map is M1 @ M2.
    """
    m = np.eye(3)
    for m6 in m6s:
        m = m @ _mat3(m6)
    return (m[0, 0], m[0, 1], m[0, 2], m[1, 0], m[1, 1], m[1, 2])


def rotate_matrix(angle_deg: float, w: int, h: int):
    """output->source map of PIL ``Image.rotate(angle)`` (CCW, expand=False,
    about the image center, pixel-center convention)."""
    ang = np.deg2rad(angle_deg)
    cos, sin = np.cos(ang), np.sin(ang)
    cx, cy = w / 2.0, h / 2.0
    # source = R(+angle) applied inversely: PIL rotates the IMAGE ccw, so the
    # output pixel looks up the source rotated cw about the center.
    a, b = cos, -sin
    d, e = sin, cos
    tx = cx - a * cx - b * cy
    ty = cy - d * cx - e * cy
    return (a, b, tx, d, e, ty)


def translate_matrix(tx: float, ty: float):
    """output->source map of PIL AFFINE (1, 0, tx, 0, 1, ty)."""
    return (1.0, 0.0, tx, 0.0, 1.0, ty)


def crop_matrix(src_w: int, src_h: int, out_size: int):
    """output->source map of a center crop to ``out_size``."""
    left = (src_w - out_size) // 2
    top = (src_h - out_size) // 2
    return (1.0, 0.0, float(left), 0.0, 1.0, float(top))


def ford_synthesize_matrix(b_delta_u: float, b_delta_v: float,
                           yaw_deg: float, gt_shift_u: float,
                           gt_shift_v: float, theta: float,
                           shift_range_lat: float, shift_range_lon: float,
                           rotation_range: float, src_w: int, src_h: int,
                           out_size: int, meter_per_pixel: float):
    """Collapse the Ford GT-synthesis chain into one matrix.

    Chain (reference dataLoader/Ford_dataset.py:185-208):
      affine(gps2utm alignment) -> rotate(yaw) -> affine(gt shift, with the
      reference's swapped lat/lon scaling) -> rotate(theta*rotation_range)
      -> center crop.
    """
    m1 = translate_matrix(b_delta_u, b_delta_v)
    m2 = rotate_matrix(yaw_deg, src_w, src_h)
    m3 = translate_matrix(gt_shift_u * shift_range_lat / meter_per_pixel,
                          gt_shift_v * shift_range_lon / meter_per_pixel)
    m4 = rotate_matrix(theta * rotation_range, src_w, src_h)
    m5 = crop_matrix(src_w, src_h, out_size)
    return compose_affine(m1, m2, m3, m4, m5)


def fused_synthesize_matrix(heading_rad: float, gt_shift_x: float,
                            gt_shift_y: float, theta: float,
                            shift_range_lat: float, shift_range_lon: float,
                            rotation_range: float, src_w: int, src_h: int,
                            out_size: int, meter_per_pixel: float,
                            cam_shift=(1.08, 0.26)):
    """Collapse the KITTI GT-synthesis chain into one matrix.

    Chain (reference dataLoader/KITTI_dataset.py:128-152):
      rotate(-heading) -> affine(camera-GPS offset) -> affine(gt shift) ->
      rotate(theta*rotation_range) -> center crop.
    """
    m1 = rotate_matrix(-np.rad2deg(heading_rad), src_w, src_h)
    m2 = translate_matrix(cam_shift[0] / meter_per_pixel,
                          cam_shift[1] / meter_per_pixel)
    m3 = translate_matrix(gt_shift_x * shift_range_lon / meter_per_pixel,
                          -gt_shift_y * shift_range_lat / meter_per_pixel)
    m4 = rotate_matrix(theta * rotation_range, src_w, src_h)
    m5 = crop_matrix(src_w, src_h, out_size)
    return compose_affine(m1, m2, m3, m4, m5)
