"""Learned pose-update head, ``Optimizer="NN"`` (port of
``highlyaccurate_tpu/models/nnrefine.py``; reference RNNs.py:93-126).

The residual of the projected and target features, ReLU, a 3x3 conv to 64
channels chosen by the feature width (``linear0`` .. ``linear3`` for 256,
128, 64, 16 channels), the spatial mean, ReLU, Dense 16, ReLU, Dense 3 and
tanh: a pose step in [-1, 1]^3.  The ``state_dict`` keys are the
reference's (``linear{i}.1.*``, ``mapping.1.*``, ``mapping.3.*``); all
four convs exist whatever the level, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

WIDTHS = (256, 128, 64, 16)


class NNrefine(nn.Module):
    """The head; ``dtype`` is the compute dtype of the convs and dense
    layers (float32 parameters cast at each call, flax ``dtype=``)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, c in enumerate(WIDTHS):
            setattr(self, f"linear{i}", nn.Sequential(
                nn.ReLU(), nn.Conv2d(c, 64, 3, padding=1)))
        self.mapping = nn.Sequential(nn.ReLU(), nn.Linear(64, 16), nn.ReLU(),
                                     nn.Linear(16, 3), nn.Tanh())

    def forward(self, pred_feat, ref_feat):
        """pred_feat, ref_feat [B, H, W, C] (C in ``WIDTHS``) -> the pose
        step [B, 3] float32."""
        dt = self.dtype
        r = (pred_feat - ref_feat).to(dt).permute(0, 3, 1, 2)
        conv = getattr(self, f"linear{WIDTHS.index(r.shape[1])}")[1]
        x = F.conv2d(F.relu(r), conv.weight.to(dt), conv.bias.to(dt),
                     padding=1)
        x = F.relu(x.mean((2, 3)))                           # [B, 64]
        d0, d1 = self.mapping[1], self.mapping[3]
        x = F.relu(F.linear(x, d0.weight.to(dt), d0.bias.to(dt)))
        x = F.linear(x, d1.weight.to(dt), d1.bias.to(dt))
        return torch.tanh(x).to(torch.float32)
