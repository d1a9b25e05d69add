"""Checkpoints as torch ``state_dict`` files (port of
``highlyaccurate_tpu/train/checkpoint.py``).

The reference writes a per-epoch ``model_<epoch%100>.pth`` and a best-model
``Model_best.pth``, plain torch pickles of the state_dict, into the
experiment directory.  Here:

  * ``save_params`` / ``load_params`` write and read ``<save_path>/<name>.pth``
    holding ``model.state_dict()``: the reference key layout
    (``SatFeatureNet.conv0.weight``, ``conv_dec1.1.weight``, ``conf0.1.weight``,
    ``damping``), which ``params.state_dict_from_jax`` produces and the JAX
    package's ``import_pth`` reads;
  * ``save_train_state`` / ``load_train_state`` write ``<name>_full.pth``
    with the weights, the Adam ``state_dict()``, ``step`` and ``epoch``
    (the fix path for the reference's per-epoch Adam reset,
    ``keep_optimizer_state=1``);
  * ``async_save=True`` copies the tensors to the host on the caller's
    thread and writes the file on one background thread, one save at a
    time; loads and ``wait_for_async_saves`` wait for it, and a clean exit
    flushes it;
  * ``import_vgg16_encoder`` / ``apply_vgg16_init`` read a local torchvision
    VGG16 state_dict into both branches' encoder convs (the reference's
    from-scratch init, VGG.py:20-28).

A released reference ``.pth`` loads with ``params.load_pth``.
"""

from __future__ import annotations

import atexit
import concurrent.futures as cf
import os
import threading
from typing import Optional

import torch
from torch import nn

from highlyaccurate_tpu_torch.train.state import TrainState

_BRANCHES = ("SatFeatureNet", "GrdFeatureNet")


class _AsyncWriter:
    """One background thread that writes checkpoint files in order."""

    def __init__(self):
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._pending: list = []
        self._lock = threading.Lock()

    def submit(self, payload, path: str):
        with self._lock:
            if self._pool is None:
                self._pool = cf.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt")
                atexit.register(self.wait)  # flush on a clean exit
            self._pending.append(self._pool.submit(_write, payload, path))

    def wait(self):
        """Wait for every pending write; re-raise the first failure."""
        with self._lock:
            pending, self._pending = self._pending, []
        errors = [e for e in (fut.exception() for fut in pending) if e]
        if errors:
            raise errors[0]


_WRITER = _AsyncWriter()


def _write(payload, path: str):
    """Write ``payload`` to ``path`` through a temporary name, so a reader
    never sees a half-written file."""
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _host_copy(obj):
    """``obj`` with every tensor copied to the host (nested dicts, lists
    and tuples), so later updates on the device cannot reach the copy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _save(payload, path: str, async_save: bool) -> str:
    payload = _host_copy(payload)
    if async_save:
        _WRITER.submit(payload, path)
        return path
    # a synchronous overwrite must not race an earlier async write
    _WRITER.wait()
    _write(payload, path)
    return path


def wait_for_async_saves() -> None:
    """Barrier on all pending async checkpoint writes (no-op if none).

    Call before reading a just-saved checkpoint and before process exit."""
    _WRITER.wait()


def _path(save_path: str, name: str) -> str:
    return os.path.abspath(os.path.join(save_path, name + ".pth"))


def save_params(save_path: str, name: str, model: nn.Module,
                async_save: bool = False) -> str:
    """Write ``model.state_dict()`` to ``<save_path>/<name>.pth``.

    ``async_save=True`` returns once the tensors are copied to the host;
    the file is written on the background thread (overlapping the
    evaluation that follows an epoch snapshot).  Returns the path."""
    os.makedirs(save_path, exist_ok=True)
    return _save(model.state_dict(), _path(save_path, name), async_save)


def load_params(save_path: str, name: str, model: nn.Module) -> nn.Module:
    """Load ``<save_path>/<name>.pth`` into ``model`` (every key, in place)
    and return it."""
    wait_for_async_saves()  # a just-issued async save must be readable
    path = _path(save_path, name)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no checkpoint '{name}' under {save_path} — train first "
            f"(--test 0), point --save_root/--resume at an existing "
            f"experiment directory, or evaluate a released reference "
            f"checkpoint with --import_pth <model.pth>")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd)
    return model


def epoch_ckpt_name(epoch: int) -> str:
    """model_<epoch%100> (reference train_kitti.py:409-414)."""
    return f"model_{epoch % 100}"


def save_train_state(save_path: str, name: str, state: TrainState,
                     model: nn.Module, async_save: bool = False) -> str:
    """Full-state checkpoint ``<save_path>/<name>_full.pth``: the weights,
    the Adam ``state_dict()``, ``step`` and ``epoch``.  The reference
    never checkpoints optimizer state; this is the
    ``keep_optimizer_state=1`` path.  ``async_save`` as in
    :func:`save_params`."""
    os.makedirs(save_path, exist_ok=True)
    payload = {"params": model.state_dict(),
               "opt_state": state.optimizer.state_dict(),
               "step": int(state.step), "epoch": int(state.epoch)}
    return _save(payload, _path(save_path, name + "_full"), async_save)


def load_train_state(save_path: str, name: str, state: TrainState,
                     model: nn.Module) -> TrainState:
    """Restore a full-state checkpoint: the weights into ``model``, the
    Adam moments into ``state.optimizer`` (on the parameters' device).
    Returns the state with the saved step and epoch.  Raises
    ``FileNotFoundError`` if there is none."""
    wait_for_async_saves()
    path = _path(save_path, name + "_full")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no full-state checkpoint '{name}_full' "
                                f"under {save_path}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    return TrainState(step=int(payload["step"]), epoch=int(payload["epoch"]),
                      optimizer=state.optimizer)


# torchvision VGG16 `features` indices of the 7 encoder convs the reference
# slices out (reference VGG.py:20-28)
_VGG16_FEATURE_CONVS = {
    "conv0": 0, "conv2": 2, "conv5": 5, "conv7": 7,
    "conv10": 10, "conv12": 12, "conv14": 14,
}


def import_vgg16_encoder(src) -> dict:
    """torchvision-VGG16 ImageNet weights -> one branch's encoder convs.

    ``src`` is a torchvision VGG16 state_dict (keys
    ``features.<i>.weight`` / ``.bias``), or the path of a local ``.pth``
    holding one (such as torchvision's ``vgg16-397923af.pth``).  Returns
    {conv name: (weight [O, I, 3, 3], bias [O])} float32 on the host; torch
    and torchvision share the OIHW layout, so nothing is transposed."""
    if isinstance(src, (str, os.PathLike)):
        src = torch.load(src, map_location="cpu", weights_only=True)
    return {name: (torch.as_tensor(src[f"features.{i}.weight"]).float(),
                   torch.as_tensor(src[f"features.{i}.bias"]).float())
            for name, i in _VGG16_FEATURE_CONVS.items()}


@torch.no_grad()
def apply_vgg16_init(model: nn.Module, src) -> nn.Module:
    """Overwrite both feature branches' encoder convs with ImageNet weights
    (both SatFeatureNet and GrdFeatureNet start from the same VGG16, as in
    the reference, VGG.py:20-28).  Decoder and confidence heads keep their
    own init.  Returns ``model``."""
    enc = import_vgg16_encoder(src)
    for branch in _BRANCHES:
        net = getattr(model, branch)
        for name, (w, b) in enc.items():
            conv = getattr(net, name)
            if conv.weight.shape != w.shape:
                raise ValueError(f"{branch}.{name}: {tuple(conv.weight.shape)} "
                                 f"vs VGG16 {tuple(w.shape)}")
            conv.weight.copy_(w)
            conv.bias.copy_(b)
    return model
