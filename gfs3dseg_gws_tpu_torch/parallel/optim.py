"""Optimizers (counterpart of the JAX package's parallel/optim.py).

Reference GFS training: Adam with the encoder at 0.1x base_lr and the heads
and prototypes at base_lr, StepLR(step_size, gamma) per epoch
(train.py:426-439). Reference pretrain: Adam(lr, weight_decay) +
StepLR(50, 0.5) (pretrain/runs/pre_train.py:133-137). torch Adam's
weight_decay adds wd * param to the gradient (L2, not AdamW's decoupled
decay), which is what the JAX package's `add_decayed_weights` before `adam`
computes.
"""
from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch


def step_lr(step_size_epochs: int, gamma: float,
            steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR as a factor of the optimizer step count (JAX: step_lr):
    gamma ** ((count // steps_per_epoch) // step_size_epochs). When every
    epoch runs in full this is a per-epoch StepLR; when epochs are cut
    short it follows the step count, as the JAX package does."""

    def factor(count: int) -> float:
        return gamma ** ((count // steps_per_epoch) // step_size_epochs)

    return factor


def make_pretrain_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                            steps_per_epoch: int, weight_decay: float = 1e-4,
                            step_size: int = 50, gamma: float = 0.5
                            ) -> Tuple[torch.optim.Adam,
                                       torch.optim.lr_scheduler.LambdaLR]:
    """Adam with L2 weight decay and a StepLR schedule stepped once per
    optimizer step (JAX: make_pretrain_optimizer). Step t uses
    lr * factor(t), as optax's schedule does."""
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, step_lr(step_size, gamma, steps_per_epoch))
    return opt, sched


def make_gfs_optimizer(model: torch.nn.Module, base_lr: float,
                       steps_per_epoch: int, step_size: int = 50,
                       gamma: float = 0.5, encoder_lr_scale: float = 0.1,
                       weight_decay: float = 0.0
                       ) -> Tuple[torch.optim.Adam,
                                  torch.optim.lr_scheduler.LambdaLR]:
    """Adam in two parameter groups, `encoder.*` at encoder_lr_scale x
    base_lr and everything else at base_lr, with optional L2 weight decay
    and StepLR on the step count for both (JAX: make_gfs_optimizer, an
    optax.multi_transform over the same two groups)."""
    encoder, rest = [], []
    for name, p in model.named_parameters():
        (encoder if name.startswith("encoder.") else rest).append(p)
    opt = torch.optim.Adam(
        [{"params": encoder, "lr": base_lr * encoder_lr_scale},
         {"params": rest, "lr": base_lr}], weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, step_lr(step_size, gamma, steps_per_epoch))
    return opt, sched
