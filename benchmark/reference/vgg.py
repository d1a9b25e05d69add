"""Plain VGG16-UNet feature pyramid of HighlyAccurate (CVPR 2022,
``VGG.py`` of github.com/YujiaoShi/HighlyAccurate), functional, on a dict
of weights named as the authors' ``state_dict``.

The first three VGG16 blocks encode; nearest-upsample, skip-concat and
bias-free double-conv stages (128 and 64 channels) decode; each kept level
is L2-normalized over its whole map.  Only the pyramid slots 0-2 (level 3,
coarse /8 to /2) are computed, which is what the pose solver reads; the
confidence heads feed no output of the benchmark's cells and are skipped.

Precision (``mode``):
  * ``float32``: every op in float32;
  * ``bfloat16``: float32 weights cast to bf16 at each conv, activations in
    bf16, the whole-map norm taken in float32 and divided in bf16;
  * ``fp8``: the control of a bf16 deployment: as bf16, with each conv's
    input and weight rounded to float8 e4m3 under a per-tensor scale.
float32 convolutions follow torch's TF32 flags, which the caller sets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ENCODER = ("conv0", "conv2", "conv5", "conv7", "conv10", "conv12", "conv14")
ENCODER_SHAPES = ((64, 3), (64, 64), (128, 64), (128, 128), (256, 128),
                  (256, 256), (256, 256))
DECODER = {"conv_dec1": (384, 128, 128), "conv_dec2": (192, 64, 64),
           "conv_dec3": (128, 32, 16)}
CONF = {"conf0": 256, "conf1": 128, "conf2": 64, "conf3": 16}
CHANNELS = (256, 128, 64, 16)          # feature channels of slots 0..3


def branch_shapes(prefix: str) -> dict:
    """{name: shape} of one branch's weights, as the authors name them."""
    shapes = {}
    for name, (cout, cin) in zip(ENCODER, ENCODER_SHAPES):
        shapes[f"{prefix}{name}.weight"] = (cout, cin, 3, 3)
        shapes[f"{prefix}{name}.bias"] = (cout,)
    for name, (cin, mid, cout) in DECODER.items():
        shapes[f"{prefix}{name}.1.weight"] = (mid, cin, 3, 3)
        shapes[f"{prefix}{name}.3.weight"] = (cout, mid, 3, 3)
    for name, cin in CONF.items():
        shapes[f"{prefix}{name}.1.weight"] = (1, cin, 3, 3)
    return shapes


def _fp8(t):
    """t rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    scale = 448.0 / torch.clamp_min(t.detach().abs().amax().float(), 1e-12)
    return ((t.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(t.dtype)


def _dtype(mode: str):
    return torch.float32 if mode == "float32" else torch.bfloat16


def _conv(x, p, name, mode, bias=True):
    w = p[f"{name}.weight"].to(x.dtype)
    b = p[f"{name}.bias"].to(x.dtype) if bias else None
    if mode == "fp8":
        x, w = _fp8(x), _fp8(w)
    return F.conv2d(x, w, b, padding=1)


def _block(x, p, name, mode):
    x = _conv(F.relu(x), p, f"{name}.1", mode, bias=False)
    return _conv(F.relu(x), p, f"{name}.3", mode, bias=False)


def _l2norm(x):
    flat = x.reshape(x.shape[0], -1).float()
    norm = torch.sqrt(torch.clamp_min((flat * flat).sum(-1), 1e-24))
    return x / norm.reshape(-1, 1, 1, 1).to(x.dtype)


def features(p: dict, prefix: str, img, slots=(0, 1, 2),
             mode: str = "float32"):
    """img [B, H, W, 3] float32 in [0, 1] -> the L2-normalized feature maps
    of ``slots``, coarse to fine, each [B, h, w, C] (NHWC) in the compute
    dtype."""
    q = {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
    x = img.to(_dtype(mode)).permute(0, 3, 1, 2)
    relu, pool = F.relu, lambda t: F.max_pool2d(t, 2, 2)
    x2 = _conv(relu(_conv(x, q, "conv0", mode)), q, "conv2", mode)
    x3 = pool(x2)
    x7 = _conv(relu(_conv(relu(x3), q, "conv5", mode)), q, "conv7", mode)
    x8 = pool(x7)
    x14 = _conv(relu(_conv(relu(_conv(relu(x8), q, "conv10", mode)), q,
                           "conv12", mode)), q, "conv14", mode)
    maps = [pool(x14)]
    skips = [x8, x3, x2]
    for i, name in enumerate(("conv_dec1", "conv_dec2", "conv_dec3")):
        if max(slots) <= i:
            break
        up = F.interpolate(maps[-1], size=skips[i].shape[-2:],
                           mode="nearest")
        maps.append(_block(torch.cat([up, skips[i]], 1), q, name, mode))
    return [_l2norm(maps[s]).permute(0, 2, 3, 1) for s in slots]


def levels(model: dict, slots=(0, 1, 2)):
    """(A, C, h, w) of each kept level: satellite side, channels, ground
    feature rows and columns, of the sizes in ``model`` (``sat_size``,
    ``grd_h``, ``grd_w``)."""
    out = []
    for s in slots:
        f = 2 ** (3 - s)
        out.append((model["sat_size"] // f, CHANNELS[s],
                    model["grd_h"] // f, model["grd_w"] // f))
    return out


def conv_layers(slots=(0, 1, 2)):
    """(cin, cout, f) of every 3x3 conv one branch's forward runs for
    ``slots``, the confidence heads of those slots included (the program
    computes them): each runs at the input image's size divided by f.  The
    model's FLOPs are counted from these."""
    layers = [(cin, cout, s) for (cout, cin), s in zip(
        ENCODER_SHAPES, (1, 1, 2, 2, 4, 4, 4))]
    for i, (cin, mid, cout) in enumerate(DECODER.values()):
        if max(slots) <= i:
            break
        s = (4, 2, 1)[i]
        layers += [(cin, mid, s), (mid, cout, s)]
    layers += [(CHANNELS[s], 1, (8, 4, 2, 1)[s]) for s in slots]
    return layers
