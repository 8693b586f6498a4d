"""Seeded random weights and the geometric-word basis, drawn on the device
from one generator in a few large calls, in float32 (the type they are
served in), then cut into the leaves of a state dict by key.

Evaluation (`eval_state`): every conv LeCun-normal (std 1/sqrt(fan_in)),
conv biases 0.1 N(0, 1), BatchNorm scale 1 + 0.1 N, shift 0.1 N, running
mean 0.1 N and running variance 0.5 + U(0, 1), so that folding them is
exercised; any other leaf (the prototypes) N(0, 1).
Training (`train_state`): convs as above, conv biases 0, BatchNorms at
scale 1, shift 0, running mean 0, variance 1; prototypes N(0, 1).
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _kind(key: str, state: Dict[str, torch.Tensor]) -> str:
    stem, _, leaf = key.rpartition(".")
    bn = stem + ".running_var" in state
    if leaf == "num_batches_tracked":
        return "count"
    if leaf in ("running_mean", "running_var"):
        return leaf
    if bn:
        return "bn_" + leaf
    if leaf == "weight" and state[key].dim() >= 2:
        return "conv"
    if leaf == "bias":
        return "conv_bias"
    return "other"


def _draw(template: Dict[str, torch.Tensor], seed: int,
          device: torch.device, train: bool) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [t.numel() for t in template.values()]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (key, t), size in zip(template.items(), sizes):
        n = normal[at:at + size].reshape(t.shape)
        u = uniform[at:at + size].reshape(t.shape)
        at += size
        kind = _kind(key, template)
        if kind == "count":
            v = torch.zeros_like(t, device=device)
        elif kind == "conv":
            v = n / math.sqrt(t.reshape(t.shape[0], -1).shape[1])
        elif train and kind in ("conv_bias", "bn_bias", "running_mean"):
            v = torch.zeros_like(n)
        elif train and kind in ("bn_weight", "running_var"):
            v = torch.ones_like(n)
        elif kind == "conv_bias":
            v = 0.1 * n
        elif kind == "bn_weight":
            v = 1.0 + 0.1 * n
        elif kind in ("bn_bias", "running_mean"):
            v = 0.1 * n
        elif kind == "running_var":
            v = 0.5 + u
        else:
            v = n
        out[key] = v.to(t.dtype).contiguous()
    return out


def eval_state(template, seed: int, device) -> Dict[str, torch.Tensor]:
    return _draw(template, seed, torch.device(device), train=False)


def train_state(template, seed: int, device) -> Dict[str, torch.Tensor]:
    return _draw(template, seed, torch.device(device), train=True)


def basis(seed: int, words: int, dims: int, device) -> torch.Tensor:
    """The (words, dims) geometric-word basis, from its own stream."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randn((words, dims), generator=gen, device=device)
