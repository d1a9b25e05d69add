"""VGG16-UNet feature pyramid extractor (port of
``highlyaccurate_tpu/models/vggunet.py:32-218``).

Topology and quirks as in the JAX package: the first three VGG16 conv blocks
as encoder, three nearest-upsample + skip-concat + bias-free double-conv
decoder stages (128, 64, 16 channels), per-level double-sigmoid confidence
heads c = sigmoid(-sigmoid(conv(relu(x)))), whole-map L2 normalisation of
each feature level, and ``level`` slicing of the pyramid.  Two variants:

* ``g2s_rearrange`` (G2SP ``proj="nn"``; reference VGG.py:276-345): the
  encoder maps x2, x3, x8 and x15 are re-laid out by the NCHW reshape
  [B, C, H, W] -> [B, C, 2H, W/2] before the decoder and the coarsest
  feature; the coarsest confidence head still reads the map before it;
* ``estimate_depth`` (Ford): per-level height heads relu -> conv -> relu ->
  conv(->1) -> tanh (the final conv zero at init), mapped to meters by
  ``process_depth``; ``forward`` then also returns the depths.

Parameter names follow the reference's torch ``state_dict``
(``conv0.weight``, ``conv_dec1.1.weight``, ``conf0.1.weight``,
``depth0.3.weight``) so a released ``.pth`` loads as it is.  The public
layout is the JAX package's NHWC: the
module takes [B, H, W, 3] and returns [B, h, w, C] features and [B, h, w, 1]
confidences.  Inside, the convolutions run on channels-last NCHW views of
the same memory, so no copy is made at either end.

``dtype`` is the compute dtype, with flax's semantics as the JAX package
uses them (``compute_dtype``): the parameters stay float32 and each conv
casts them, with its input, to ``dtype``, so a bf16 branch runs its convs,
activations, pools, upsampling and confidence heads in bf16; the feature
normalisation takes its norm in float32 and divides in the feature dtype.
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
    flat = x.reshape(B, -1).to(torch.float32)
    norm = torch.sqrt(torch.clamp_min(torch.sum(flat * flat, dim=-1), 1e-24))
    return x / norm.reshape(B, 1, 1, 1).to(x.dtype)


def process_depth(d):
    """A tanh height map [B, 1, H, W] -> meters: (d + 1) / 2, times 10 in
    the top half of the rows and 1.6 in the bottom half (reference
    VGG.py:348-352), in d's dtype."""
    H = d.shape[2]
    d = (d + 1) / 2
    return torch.cat([d[:, :, : H // 2] * 10.0, d[:, :, H // 2:] * 1.6],
                     dim=2)


def g2s(x):
    """The G2S re-layout [B, C, H, W] -> [B, C, 2H, W/2] as the NCHW
    reshape of the logical tensor (a view of channels-last memory would
    scramble it), returned channels-last."""
    B, C, H, W = x.shape
    return x.contiguous().reshape(B, C, 2 * H, W // 2).contiguous(
        memory_format=torch.channels_last)


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


class _Conv(nn.Conv2d):
    """3x3 conv, padding 1, computed in its input's dtype: the float32
    parameters are cast to it at each call (flax ``Conv(dtype=...)``)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _conv(cin, cout, bias):
    return _Conv(cin, cout, 3, padding=1, bias=bias)


def _conv_block(cin, mid, out):
    """relu -> conv -> relu -> conv (decoder stage, bias-free convs);
    Sequential indices 1 and 3 hold the convs, as in the reference."""
    return nn.Sequential(nn.ReLU(), _conv(cin, mid, False), nn.ReLU(),
                         _conv(mid, out, False))


def _conf_head(cin):
    """relu -> conv(->1) -> sigmoid (index 1 holds the conv)."""
    return nn.Sequential(nn.ReLU(), _conv(cin, 1, False), nn.Sigmoid())


def _depth_head(cin, mid):
    """relu -> conv -> relu -> conv(->1) -> tanh (indices 1 and 3 hold the
    convs, VGG.py:85-118); ``params.init_params`` zeroes the last conv, as
    the JAX head's ``kernel_init=zeros`` does."""
    return nn.Sequential(nn.ReLU(), _conv(cin, mid, False), nn.ReLU(),
                         _conv(mid, 1, False), nn.Tanh())


class VGGUnet(nn.Module):
    """Two-branch-shareable VGG16-UNet pyramid extractor.

    ``forward`` returns (features, confidences[, depths]) lists ordered
    coarse->fine, sliced per ``level``; depths [B, h, w, 1] in meters with
    ``estimate_depth``.  Decoder stages finer than the finest selected slot
    are not run (their outputs would be discarded).
    """

    def __init__(self, level: int, dtype: torch.dtype = torch.float32,
                 g2s_rearrange: bool = False, estimate_depth: bool = False):
        super().__init__()
        if level not in LEVEL_SLOTS:
            raise ValueError(f"unsupported level {level}")
        self.level = level
        self.dtype = dtype
        self.slots = LEVEL_SLOTS[level]
        self.g2s_rearrange = g2s_rearrange
        self.estimate_depth = estimate_depth
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
        if estimate_depth:
            self.depth0 = _depth_head(256, 64)
            self.depth1 = _depth_head(128, 32)
            self.depth2 = _depth_head(64, 16)
            self.depth3 = _depth_head(16, 16)

    def forward(self, x) -> Tuple[List[torch.Tensor], ...]:
        # NHWC in -> channels-last NCHW view (no copy for contiguous input)
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        relu = F.relu
        x2 = self.conv2(relu(self.conv0(x)))
        x3 = max_pool_2x2(x2)                       # H/2
        x7 = self.conv7(relu(self.conv5(relu(x3))))
        x8 = max_pool_2x2(x7)                       # H/4
        x14 = self.conv14(relu(self.conv12(relu(self.conv10(relu(x8))))))
        x15 = max_pool_2x2(x14)                     # H/8
        # the heads of slot 0 read x15 as it is, whatever the re-layout
        heads_in = [x15]
        if self.g2s_rearrange:
            x2, x3, x8, x15 = g2s(x2), g2s(x3), g2s(x8), g2s(x15)

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
        heads_in += maps[1:]

        heads = (self.conf0, self.conf1, self.conf2, self.conf3)
        to_nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        feats = [to_nhwc(l2_norm_wholemap(maps[s])) for s in self.slots]
        confs = [to_nhwc(torch.sigmoid(-heads[s](heads_in[s])))
                 for s in self.slots]
        if not self.estimate_depth:
            return feats, confs
        dheads = (self.depth0, self.depth1, self.depth2, self.depth3)
        depths = [to_nhwc(process_depth(dheads[s](heads_in[s])))
                  for s in self.slots]
        return feats, confs, depths
