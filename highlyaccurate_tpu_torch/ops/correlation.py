"""The dense correlation of the two correlation heads (S2GP
``orien_corr``, G2SP ``corr``): each sample's kernel slid over its own
search map, and the windowed sum that normalizes it.

The JAX package computes both with XLA ops outside any Pallas kernel: the
correlation is one ``lax.conv_general_dilated`` with
``feature_group_count=B`` over a [1, B*C] layout, the sum a
``lax.reduce_window``.  Here they are PyTorch convolutions (``conv1d``
per sample, ``conv2d`` with a kernel of ones); no hand kernel.  Layout
is channel-last ``[B, H, W, C]`` as in the models.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_corr(x, k) -> torch.Tensor:
    """x [B, H, W, C] search maps, k [B, h, w, C] kernels -> [B, H-h+1,
    W-w+1], sample b's kernel correlated (no flip, VALID) with its own map.
    The operands meet in their promoted dtype (a bf16 map and a float32
    kernel correlate in float32; ``lax.conv_general_dilated`` itself
    refuses mixed dtypes).

    Per sample, one ``conv1d`` with the (column, channel) pairs of a row
    flattened and a stride of C correlates every map row with every
    kernel row; the correlation is the sum over the diagonal (map row
    i + u against kernel row u).  So the contraction is a matrix product,
    forward and backward; a 2-D convolution with a large kernel took
    minutes on a CPU (the backward of G2SP's finest level, batch 2)."""
    B, H, W, C = x.shape
    h, w = k.shape[1:3]
    dt = torch.promote_types(x.dtype, k.dtype)
    Hp, Wp = H - h + 1, W - w + 1
    out = []
    for b in range(B):
        rows = F.conv1d(x[b].to(dt).reshape(H, 1, W * C),
                        k[b].to(dt).reshape(h, 1, w * C), stride=C)
        # rows [H, h, Wp]: corr[i, j] = sum over u of rows[i + u, u, j]
        diag = rows.as_strided((Hp, h, Wp), (h * Wp, h * Wp + Wp, 1))
        out.append(diag.sum(1))
    return torch.stack(out)


def window_sum(s, h: int, w: int) -> torch.Tensor:
    """s [B, H, W] -> [B, H-h+1, W-w+1], the sum over each h x w window
    (VALID, stride 1), in s's dtype."""
    ones = s.new_ones(1, 1, h, w)
    return F.conv2d(s[:, None], ones)[:, 0]
