"""Learning-rate schedules and optimizer construction.
Port of ``meg_decoding_tpu/train/schedules.py``.

Reference: ``train.py:160-175`` — Adam over encoder+loss params; schedulers:
``cosine`` (``CosineAnnealingLR(T_max=epochs, eta_min=0.1·lr)``),
``multistep`` (milestones at fractions of total epochs, gamma), or none.
Torch schedulers step per epoch; as in the JAX package the same curves are
stepped per update from the epoch index ``count // updates_per_epoch``.

A schedule maps the optimizer's update count (a 0-dim int tensor on the
device, the number of updates applied so far) to a 0-dim f32 learning rate
on the same device, so reading it never syncs with the host.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from meg_decoding_tpu_torch.train.optim import Adam

__all__ = ["make_schedule", "make_optimizer"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


def make_schedule(cfg, updates_per_epoch: int) -> Schedule:
    lr = float(cfg.lr)
    epochs = int(cfg.epochs)
    upe = max(int(updates_per_epoch), 1)
    kind = cfg.get("lr_scheduler", "none")
    if kind == "cosine":
        # torch CosineAnnealingLR: lr(e) = eta_min + (lr-eta_min)(1+cos(πe/T))/2
        eta_min = lr * 0.1

        def sched(count):
            epoch = (count // upe).to(torch.float32)
            return eta_min + (lr - eta_min) * 0.5 * (
                1 + torch.cos(math.pi * epoch / epochs))

        return sched
    if kind == "multistep":
        milestones = [int(float(m) * epochs) for m in cfg.lr_multistep_mlstns]
        gamma = float(cfg.lr_step_gamma)

        def sched(count):
            epoch = count // upe
            n_passed = sum((epoch >= m).to(torch.float32) for m in milestones)
            return lr * gamma ** n_passed

        return sched
    if kind != "none":
        raise ValueError(f"unknown lr_scheduler {kind!r} (cosine, multistep, none)")
    return lambda count: torch.full((), lr, dtype=torch.float32,
                                    device=count.device)


def make_optimizer(cfg, updates_per_epoch: int) -> Adam:
    return Adam(make_schedule(cfg, updates_per_epoch))
