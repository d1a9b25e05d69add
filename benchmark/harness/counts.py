"""The yardstick: the card's published peaks, the model's FLOPs and the
bytes each hand kernel's work needs, counted from the shapes of the
configuration, whatever implements the work.  The map footprints come
from the cell's reference module (``map_cells``, ``kept_samples``), which
holds its family's geometry; ``cfg`` is the configuration's model settings
with its route's."""

from __future__ import annotations

from benchmark.reference import vgg
from benchmark.reference.vgg import levels

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


def k1_bytes(cfg: dict, batch: int, ref, map_bytes: int = 2) -> float:
    """Bytes one evaluation call's banded-moment work needs (K1, once
    per round): each round reads the map cells its samples touch
    (``ref.map_cells``, bf16), the kept target rows (float32, bottom half
    of the ground rows), the ray mask and 8 line coefficients a row, and
    writes 3 x 16 float32 moments a row."""
    total = 0.0
    for (A, C, h, w), n in zip(levels(cfg), ref.map_cells(cfg)):
        V = h // 2
        total += batch * (n * C * map_bytes + V * w * C * 4
                          + V * 8 * 4 + V * 3 * 16 * 4) + V * w * 4
    return total * cfg["N_iters"]


def k3_bytes(model: dict, batch: int) -> float:
    """Bytes one training step's banded map-gradient work needs (K3, once
    per round): it reads the cotangents of the samples, their x and y
    derivatives (three float32 [V, W, C] a sample) and the line
    coefficients, and writes the float32 map gradient [A, A, C]."""
    total = 0.0
    for A, C, h, w in levels(model):
        V = h // 2
        total += batch * (3 * V * w * C * 4 + V * 8 * 4 + A * A * C * 4)
    return total * model["N_iters"]


def k4_bytes(cfg: dict, batch: int, ref) -> float:
    """Bytes one evaluation call's projective-line sampling needs (K4,
    once per round): it reads the ground map cells its samples touch
    (``ref.map_cells``, bf16) and 16 line coefficients a satellite column,
    and writes the samples and their two derivatives (three float32
    [V, A, C]) of the V satellite columns it serves."""
    total = 0.0
    for (A, C, h, w), (n, V) in zip(levels(cfg), ref.map_cells(cfg)):
        total += batch * (n * C * 2 + V * 16 * 4 + 3 * V * A * C * 4)
    return total * cfg["N_iters"]


def k7_bytes(cfg: dict, batch: int, ref) -> float:
    """Bytes one evaluation call's per-line contraction of K4's samples
    needs (K7, once per round): it reads, of each sample the banded
    sampler keeps at the zero pose (``ref.kept_samples``), four float32
    rows of C (the sample, its two derivatives and the satellite target),
    and writes the 9 float32 LM sums (H 6, g 3) of each of the V lines."""
    total = 0.0
    for (A, C, h, w), (n, V), kept in zip(levels(cfg), ref.map_cells(cfg),
                                          ref.kept_samples(cfg)):
        total += batch * (kept * 4 * C * 4 + V * 9 * 4)
    return total * cfg["N_iters"]
