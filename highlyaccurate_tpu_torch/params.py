"""Weights for the port (port of ``highlyaccurate_tpu/train/checkpoint.py:
175-203`` and ``highlyaccurate_tpu/models/vggunet.py:237-285``).

* ``state_dict_from_jax``: the JAX package's LMS2GP or LMG2SP params
  pytree (numpy or array leaves) -> this port's ``state_dict`` (the
  reference's key layout; both models have the same keys).
* ``load_pth``: a reference ``.pth`` -> the keys the port's models hold.
* ``init_params``: fresh weights drawn like the JAX model's own
  initialisation (flax ``Conv`` defaults: LeCun-normal truncated at two
  standard deviations, zero bias; damping 0 for S2GP, ``cfg.damping`` for
  G2SP), from a ``torch.Generator``.  The distribution matches; the
  numbers do not.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

_ENC = ("conv0", "conv2", "conv5", "conv7", "conv10", "conv12", "conv14")
_DEC = {"dec1": "conv_dec1", "dec2": "conv_dec2", "dec3": "conv_dec3"}
_CONF = ("conf0", "conf1", "conf2", "conf3")
_BRANCHES = ("SatFeatureNet", "GrdFeatureNet")


def _hwio_to_oihw(k) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))))


def _branch(p: dict, prefix: str) -> dict:
    sd = {}
    for name in _ENC:
        k = np.asarray(p[name]["kernel"], np.float32)
        if name == "conv0":
            # the JAX package may zero-pad conv0's input channels
            # (pad_input_channels); the padded inputs are zero, so the extra
            # kernel rows never contribute
            k = k[:, :, :3]
        sd[f"{prefix}{name}.weight"] = _hwio_to_oihw(k)
        sd[f"{prefix}{name}.bias"] = torch.from_numpy(
            np.asarray(p[name]["bias"], np.float32).copy())
    for jname, tname in _DEC.items():
        if jname not in p:
            continue
        sd[f"{prefix}{tname}.1.weight"] = _hwio_to_oihw(
            p[jname]["conv_a"]["kernel"])
        sd[f"{prefix}{tname}.3.weight"] = _hwio_to_oihw(
            p[jname]["conv_b"]["kernel"])
    for name in _CONF:
        if name in p:
            sd[f"{prefix}{name}.1.weight"] = _hwio_to_oihw(
                p[name]["conv"]["kernel"])
    return sd


def state_dict_from_jax(params: dict) -> dict:
    """JAX LMS2GP / LMG2SP params pytree -> port ``state_dict`` (HWIO -> OIHW;
    ``dec1/conv_a`` -> ``conv_dec1.1``; ``conf0/conv`` -> ``conf0.1``)."""
    sd = {}
    for br in _BRANCHES:
        sd.update(_branch(params[br], f"{br}."))
    sd["damping"] = torch.from_numpy(
        np.asarray(params["damping"], np.float32).copy())
    return sd


def load_pth(path: str) -> dict:
    """A reference ``.pth`` state_dict, restricted to the keys of the two
    feature branches and the damping (other heads belong to options this
    port refuses)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v for k, v in sd.items()
            if k.split(".", 1)[0] in _BRANCHES or k == "damping"}


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator):
    """Re-draw every conv kernel as flax's default initialiser does
    (variance 1/fan_in, truncated normal at +-2 std), zero the biases, and
    set the damping as the JAX model initialises it (0 for S2GP,
    ``cfg.damping`` for G2SP, lm_g2sp.py:58-60).  Draws on the CPU, then
    copies to the model's device."""
    stddev = 1.0 / 0.87962566103423978  # std of N(0,1) truncated to [-2, 2]
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) * stddev
            w = torch.empty(mod.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
    g2sp = model.cfg.direction == "G2SP"
    for name, p in model.named_parameters():
        if name == "damping":
            p.fill_(model.cfg.damping if g2sp else 0.0)
