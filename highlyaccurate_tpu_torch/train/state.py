"""Train state and optimizer (port of ``highlyaccurate_tpu/train/state.py:
21-62``).

The reference rebuilds Adam every epoch with lr = base_lr * (1 - epoch/100)
(reference train_kitti.py:328-333), so the moments reset each epoch;
``reset_for_epoch`` does the same unless ``keep_optimizer_state``, which
only sets the new lr.  ``torch.optim.Adam(lr, betas=(0.9, 0.999),
eps=1e-8)`` applies optax ``adam``'s update rule.

The parameters live in the model (an ``nn.Module`` owns its weights); the
state holds the optimizer over them and the step and epoch counters.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from highlyaccurate_tpu_torch.config import Config


@dataclasses.dataclass
class TrainState:
    step: int
    epoch: int
    optimizer: torch.optim.Adam


def epoch_lr(base_lr: float, epoch: int) -> float:
    """Polynomial decay, power 1 (reference train_kitti.py:329)."""
    return base_lr * (1.0 - float(epoch) / 100.0)


def _adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(cfg: Config, model: nn.Module) -> TrainState:
    """Step and epoch 0, Adam at ``cfg.lr`` over every model parameter."""
    return TrainState(step=0, epoch=0,
                      optimizer=_adam(model.parameters(), cfg.lr))


def reset_for_epoch(state: TrainState, cfg: Config, epoch: int) -> TrainState:
    """The reference's per-epoch Adam reset at the poly-decayed lr."""
    lr = epoch_lr(cfg.lr, epoch)
    opt = state.optimizer
    if cfg.keep_optimizer_state:
        for group in opt.param_groups:
            group["lr"] = lr
    else:
        opt = _adam([p for g in opt.param_groups for p in g["params"]], lr)
    return dataclasses.replace(state, optimizer=opt, epoch=epoch)
