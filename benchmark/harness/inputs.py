"""Inputs made from ``--seed``: the weights, drawn on the device in one call,
and the pool of uint8 frame batches, drawn on the device and held on the
host as a caller holds camera frames and map tiles.  The benchmark hands
the same tensors to the program and to the reference."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import vgg

TRUNCATE = 2.0      # LeCun-normal weights clamped at two standard deviations


def streams(seed: int, n: int = 4) -> list:
    """n independent 63-bit seeds from ``seed`` (weights, frames, poses,
    the program's generator)."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s) >> 1 for s in state]


def weight_shapes() -> dict:
    """{name: shape} of the model's weights, as the authors name them: two
    VGG16-UNet branches and the solver's damping."""
    shapes = {**vgg.branch_shapes("SatFeatureNet."),
              **vgg.branch_shapes("GrdFeatureNet.")}
    shapes["damping"] = (1, 3)
    return shapes


def draw_weights(seed: int, damping: float, device) -> dict:
    """Float32 weights on ``device``: every conv kernel LeCun-normal
    (variance 1 / fan_in) clamped at +-2 standard deviations, from one
    normal draw of them all; zero biases; the damping ``damping``, as the
    model initialises it (the reference's ``initial_damping``)."""
    shapes = weight_shapes()
    kernels = [k for k, s in shapes.items() if len(s) == 4]
    sizes = [math.prod(shapes[k]) for k in kernels]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for k, part in zip(kernels, flat.split(sizes)):
        shape = shapes[k]
        std = math.sqrt(1.0 / math.prod(shape[1:]))
        out[k] = (part.clamp(-TRUNCATE, TRUNCATE) * std).view(shape)
    for k, s in shapes.items():
        if k not in out:
            fill = damping if k == "damping" else 0
            out[k] = torch.full(s, float(fill), device=device)
    return out


def _texture(g, n: int, h: int, w: int, octaves, device):
    """[n, h, w, 3] uint8 images: a sum of uniform noise at coarse scales,
    bilinearly upsampled, so that images have structure at every scale."""
    img = torch.zeros(n, 3, h, w, device=device)
    for factor, weight in octaves:
        small = torch.rand(n, 3, max(h // factor, 1), max(w // factor, 1),
                           generator=g, device=device)
        img += weight * F.interpolate(small, size=(h, w), mode="bilinear",
                                      align_corners=False)
    img /= sum(wt for _, wt in octaves)
    return (img * 255).round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous()


def frame_pool(seed: int, batches: int, batch: int, sat_size: int,
               grd_h: int, grd_w: int, octaves, device):
    """``batches`` distinct batches of ``batch`` (satellite [A, A, 3],
    ground [H, W, 3]) uint8 pairs, drawn on ``device`` and returned as host
    numpy arrays [batches, batch, ...]."""
    g = torch.Generator(device=device).manual_seed(seed)
    sat = np.empty((batches, batch, sat_size, sat_size, 3), np.uint8)
    grd = np.empty((batches, batch, grd_h, grd_w, 3), np.uint8)
    for i in range(batches):
        sat[i] = _texture(g, batch, sat_size, sat_size, octaves,
                          device).cpu().numpy()
        grd[i] = _texture(g, batch, grd_h, grd_w, octaves,
                          device).cpu().numpy()
    return sat, grd


def pose_pool(seed: int, batches: int, batch: int) -> np.ndarray:
    """[batches, batch, 3] ground-truth poses, normalized, uniform in
    [-1, 1): the whole prior range of each shift and of the heading."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (batches, batch, 3)).astype(np.float32)


def to_float(u8) -> torch.Tensor:
    """uint8 frames (a tensor) as float32 in [0, 1], as the port converts
    them."""
    return u8.to(torch.float32) / 255.0
