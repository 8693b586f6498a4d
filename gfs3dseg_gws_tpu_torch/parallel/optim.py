"""Optimizers (counterpart of the JAX package's parallel/optim.py).

Reference GFS training: Adam with the encoder at 0.1x base_lr and the heads
and prototypes at base_lr, StepLR(step_size, gamma) per epoch
(train.py:426-439). Reference pretrain: Adam(lr, weight_decay) +
StepLR(50, 0.5) (pretrain/runs/pre_train.py:133-137). Reference few-shot
baselines: Adam with the encoder at 1e-4 and the rest at lr, StepLR per
iteration (pretrain/models/proto_learner.py:24-32). torch Adam's
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
    lr * factor(t), as optax's schedule does.

    On CUDA parameters Adam is `capturable` and its LR a device tensor
    (`hold_lr_in_tensors`), as in `make_gfs_optimizer`, so that
    parallel/steps.py::pretrain_step can replay the update as part of a
    CUDA graph; on the CPU the LR stays a float."""
    params = list(params)
    device = params[0].device
    cuda = device.type == "cuda"
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay,
                           capturable=cuda)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, step_lr(step_size, gamma, steps_per_epoch))
    if cuda:
        hold_lr_in_tensors(opt, device)
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
    optax.multi_transform over the same two groups).

    On CUDA parameters Adam is `capturable` (its step count and bias
    corrections stay on the device, in float32) and each group's LR is a
    device tensor that the scheduler writes (`hold_lr_in_tensors`), so
    that parallel/steps.py::gfs_train_step can replay the update as part
    of a CUDA graph; on the CPU the LR stays a float."""
    encoder, rest = [], []
    for name, p in model.named_parameters():
        (encoder if name.startswith("encoder.") else rest).append(p)
    device = (encoder + rest)[0].device
    cuda = device.type == "cuda"
    opt = torch.optim.Adam(
        [{"params": encoder, "lr": base_lr * encoder_lr_scale},
         {"params": rest, "lr": base_lr}], weight_decay=weight_decay,
        capturable=cuda)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, step_lr(step_size, gamma, steps_per_epoch))
    if cuda:
        hold_lr_in_tensors(opt, device)
    return opt, sched


def hold_lr_in_tensors(opt: torch.optim.Optimizer,
                       device: torch.device) -> None:
    """Give each parameter group its LR as a one-element tensor on `device`
    (after the scheduler took its float base LRs): the scheduler then
    writes each new value into that tensor (`fill_`), so that a CUDA graph
    that captured `opt.step()` reads the schedule's LR at every replay.
    The tensor has the precision of the arithmetic that reads it: float32
    on CUDA, Adam's `capturable` update; float64 elsewhere, where Adam
    reads it as a Python float, so that the update is the float LR's bit
    for bit."""
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    for group in opt.param_groups:
        group["lr"] = torch.tensor(float(group["lr"]), dtype=dtype,
                                   device=device)


def make_fewshot_optimizer(model: torch.nn.Module, lr: float,
                           step_size: int, gamma: float,
                           encoder_lr: float = 1e-4
                           ) -> Tuple[torch.optim.Adam,
                                      torch.optim.lr_scheduler.LambdaLR]:
    """The ProtoNet / MPTI optimizer (JAX pipelines/baselines.py::
    _make_optimizer, an optax.multi_transform): Adam at `encoder_lr` for
    the DGCNN `encoder.*` and at `lr` for everything else (base learner,
    attention or mapper), no weight decay, both on a StepLR of the
    iteration count (one optimizer step an iteration)."""
    encoder, rest = [], []
    for name, p in model.named_parameters():
        (encoder if name.startswith("encoder.") else rest).append(p)
    opt = torch.optim.Adam([{"params": encoder, "lr": encoder_lr},
                            {"params": rest, "lr": lr}])
    sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                              step_lr(step_size, gamma, 1))
    return opt, sched
