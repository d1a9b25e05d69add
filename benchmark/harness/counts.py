"""The yardstick: the card's published peaks, the model's FLOPs and the
bytes each hand kernel's work needs, counted from the shapes of the
configuration, whatever implements the work."""

from __future__ import annotations

import functools

import torch

from benchmark.reference import g2sp, s2gp, vgg

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12                     # HBM3, bytes/s

SLOTS = (0, 1, 2)                         # level 3: coarse /8 to /2


def precision(route: dict) -> str:
    """The precision the route's convolutions run in: bf16, or float32 on
    the CUDA cores (TF32 off), or TF32."""
    if route["compute_dtype"] == "bfloat16":
        return "bfloat16"
    return "tf32" if route["cudnn_allow_tf32"] else "float32"


def model_flops(model: dict, batch: int, train: bool) -> float:
    """FLOPs of one call: the 3x3 convolutions of both VGG16-UNet branches
    (2 per multiply-add), the confidence heads of the kept levels with
    them; a training step counts 3x the forward."""
    total = 0.0
    for h, w in ((model["sat_size"], model["sat_size"]),
                 (model["grd_h"], model["grd_w"])):
        for cin, cout, f in vgg.conv_layers(SLOTS):
            total += 2.0 * cin * cout * 9 * (h // f) * (w // f)
    return total * batch * (3 if train else 1)


def levels(model: dict):
    """(A, C, h, w) of each kept level: satellite side, channels, ground
    feature rows and columns."""
    out = []
    for s in SLOTS:
        f = 2 ** (3 - s)
        out.append((model["sat_size"] // f, vgg.CHANNELS[s],
                    model["grd_h"] // f, model["grd_w"] // f))
    return out


def _cells(r0, c0, m, side: int) -> int:
    """How many map cells the 2x2 blocks at (r0, c0) of the samples m
    keeps touch."""
    keep = m.reshape(-1) > 0
    base = (r0 * side + c0).reshape(-1)[keep]
    return int(torch.cat([base, base + 1, base + side,
                          base + side + 1]).unique().numel())


@functools.lru_cache(maxsize=None)
def s2gp_map_cells(model_items: tuple) -> tuple:
    """Per level, the satellite map cells the kept rows' samples touch at
    the zero pose: what one image's banded sampling must read of its map
    (the footprint moves with the pose; its size stays)."""
    model = dict(model_items)
    ranges = (model["rotation_range"], model["shift_range_lat"],
              model["shift_range_lon"])
    out = []
    for A, C, h, w in levels(model):
        xyz, mask = s2gp.rays(h, w, model["grd_h"], model["grd_w"])
        uv, _ = s2gp.uv_jac(torch.zeros(1, 3), torch.from_numpy(
            xyz[h // 2:]), A, ranges)
        r0, c0, _, _, m = s2gp.line_cells(uv, A)
        out.append(_cells(r0, c0, m * torch.from_numpy(mask[h // 2:]), A))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def g2sp_map_cells(model_items: tuple, restrict: int) -> tuple:
    """Per level, (the ground map cells the served satellite columns'
    samples touch at the zero pose, the columns served)."""
    model = dict(model_items, g2sp_restrict_grid=restrict)
    ranges = (model["rotation_range"], model["shift_range_lat"],
              model["shift_range_lon"])
    out = []
    for A, C, h, w in levels(model):
        X, k, _ = g2sp.level_geometry(model, A, h, w, "cpu")
        P, _ = g2sp.projection(torch.zeros(1, 3), k[None], ranges)
        valid = g2sp.lines_valid(P, X[:, 0], X[:, 1], h, w, X.shape[1])
        x, y, _, _, m = g2sp.image_points(P, X, valid, h, w)
        keep = m > 0
        r0 = torch.where(keep, torch.floor(y), torch.zeros_like(y)).long()
        c0 = torch.where(keep, torch.floor(x), torch.zeros_like(x)).long()
        out.append((_cells(r0, c0, m, w), X.shape[0]))
    return tuple(out)


def k1_bytes(model: dict, batch: int, map_bytes: int = 2) -> float:
    """Bytes one S2GP evaluation call's banded-moment work needs (K1, once
    per round): each round reads the map cells its samples touch
    (``s2gp_map_cells``, bf16), the kept target rows (float32, bottom half
    of the ground rows), the ray mask and 8 line coefficients a row, and
    writes 3 x 16 float32 moments a row."""
    total = 0.0
    cells = s2gp_map_cells(tuple(sorted(model.items())))
    for (A, C, h, w), n in zip(levels(model), cells):
        V = h // 2
        total += batch * (n * C * map_bytes + V * w * C * 4
                          + V * 8 * 4 + V * 3 * 16 * 4) + V * w * 4
    return total * model["N_iters"]


def k3_bytes(model: dict, batch: int) -> float:
    """Bytes one S2GP training step's map-gradient work needs (K3, once per
    round): it reads the cotangents of the samples, their x and y
    derivatives (three float32 [V, W, C] a sample) and the line
    coefficients, and writes the float32 map gradient [A, A, C]."""
    total = 0.0
    for A, C, h, w in levels(model):
        V = h // 2
        total += batch * (3 * V * w * C * 4 + V * 8 * 4 + A * A * C * 4)
    return total * model["N_iters"]


def k4_bytes(model: dict, batch: int, restrict: int) -> float:
    """Bytes one G2SP evaluation call's projective-line sampling needs (K4,
    once per round): it reads the ground map cells its samples touch
    (``g2sp_map_cells``, bf16) and 16 line coefficients a satellite column,
    and writes the samples and their two derivatives (three float32
    [V, A, C]) of the V satellite columns it serves."""
    total = 0.0
    cells = g2sp_map_cells(tuple(sorted(model.items())), restrict)
    for (A, C, h, w), (n, V) in zip(levels(model), cells):
        total += batch * (n * C * 2 + V * 16 * 4 + 3 * V * A * C * 4)
    return total * model["N_iters"]
