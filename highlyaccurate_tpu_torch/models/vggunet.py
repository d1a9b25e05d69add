"""VGG16-UNet feature pyramid extractor (port of
``highlyaccurate_tpu/models/vggunet.py:32-218``).

Topology and quirks as in the JAX package: the first three VGG16 conv blocks
as encoder, three nearest-upsample + skip-concat + bias-free double-conv
decoder stages (128, 64, 16 channels), per-level double-sigmoid confidence
heads c = sigmoid(-sigmoid(conv(relu(x)))), whole-map L2 normalisation of
each feature level, and ``level`` slicing of the pyramid.

Parameter names follow the reference's torch ``state_dict``
(``conv0.weight``, ``conv_dec1.1.weight``, ``conf0.1.weight``) so a released
``.pth`` loads as it is.  The public layout is the JAX package's NHWC: the
module takes [B, H, W, 3] and returns [B, h, w, C] features and [B, h, w, 1]
confidences.  Inside, the convolutions run on channels-last NCHW views of
the same memory, so no copy is made at either end.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# pyramid slots selected by Config.level (coarse /8 ... fine /1)
LEVEL_SLOTS = {-1: [0], -2: [1], -3: [2],
               2: [1, 2], 3: [0, 1, 2], 4: [0, 1, 2, 3]}


def l2_norm_wholemap(x):
    """Normalize each sample's whole map to unit L2 norm, floored at 1e-24
    on the squared norm (reference VGG.py:511-514)."""
    B = x.shape[0]
    sq = torch.sum((x * x).reshape(B, -1), dim=-1)
    norm = torch.sqrt(torch.clamp_min(sq, 1e-24))
    return x / norm.reshape(B, 1, 1, 1)


def max_pool_2x2(x):
    """2x2 stride-2 max pool (NCHW view; even H and W)."""
    return F.max_pool2d(x, 2, 2)


def _upsample_nearest(x, target_hw):
    """Integer-factor nearest upsample (every reference site is 2x)."""
    H, W = x.shape[-2:]
    th, tw = target_hw
    if th % H or tw % W:
        raise ValueError(f"non-integer upsample {H}x{W} -> {th}x{tw}")
    return F.interpolate(x, size=(th, tw), mode="nearest")


def _conv(cin, cout, bias):
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


def _conv_block(cin, mid, out):
    """relu -> conv -> relu -> conv (decoder stage, bias-free convs);
    Sequential indices 1 and 3 hold the convs, as in the reference."""
    return nn.Sequential(nn.ReLU(), _conv(cin, mid, False), nn.ReLU(),
                         _conv(mid, out, False))


def _conf_head(cin):
    """relu -> conv(->1) -> sigmoid (index 1 holds the conv)."""
    return nn.Sequential(nn.ReLU(), _conv(cin, 1, False), nn.Sigmoid())


class VGGUnet(nn.Module):
    """Two-branch-shareable VGG16-UNet pyramid extractor.

    ``forward`` returns (features, confidences) lists ordered coarse->fine,
    sliced per ``level``.  Decoder stages finer than the finest selected
    slot are not run (their outputs would be discarded).
    """

    def __init__(self, level: int):
        super().__init__()
        if level not in LEVEL_SLOTS:
            raise ValueError(f"unsupported level {level}")
        self.level = level
        self.slots = LEVEL_SLOTS[level]
        self.conv0 = _conv(3, 64, True)
        self.conv2 = _conv(64, 64, True)
        self.conv5 = _conv(64, 128, True)
        self.conv7 = _conv(128, 128, True)
        self.conv10 = _conv(128, 256, True)
        self.conv12 = _conv(256, 256, True)
        self.conv14 = _conv(256, 256, True)
        self.conv_dec1 = _conv_block(256 + 128, 128, 128)
        self.conv_dec2 = _conv_block(128 + 64, 64, 64)
        self.conv_dec3 = _conv_block(64 + 64, 32, 16)
        self.conf0 = _conf_head(256)
        self.conf1 = _conf_head(128)
        self.conf2 = _conf_head(64)
        self.conf3 = _conf_head(16)

    def forward(self, x) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        # NHWC in -> channels-last NCHW view (no copy for contiguous input)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        relu = F.relu
        x2 = self.conv2(relu(self.conv0(x)))
        x3 = max_pool_2x2(x2)                       # H/2
        x7 = self.conv7(relu(self.conv5(relu(x3))))
        x8 = max_pool_2x2(x7)                       # H/4
        x14 = self.conv14(relu(self.conv12(relu(self.conv10(relu(x8))))))
        x15 = max_pool_2x2(x14)                     # H/8

        deepest = max(self.slots)
        maps = [x15]
        if deepest >= 1:
            x16 = _upsample_nearest(x15, x8.shape[-2:])
            maps.append(self.conv_dec1(torch.cat([x16, x8], dim=1)))
        if deepest >= 2:
            x19 = _upsample_nearest(maps[1], x3.shape[-2:])
            maps.append(self.conv_dec2(torch.cat([x19, x3], dim=1)))
        if deepest >= 3:
            x22 = _upsample_nearest(maps[2], x2.shape[-2:])
            maps.append(self.conv_dec3(torch.cat([x22, x2], dim=1)))

        heads = (self.conf0, self.conf1, self.conf2, self.conf3)
        to_nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        feats = [to_nhwc(l2_norm_wholemap(maps[s])) for s in self.slots]
        confs = [to_nhwc(torch.sigmoid(-heads[s](maps[s])))
                 for s in self.slots]
        return feats, confs
