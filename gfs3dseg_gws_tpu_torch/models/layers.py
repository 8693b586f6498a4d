"""Shared eval-mode building blocks (counterpart of the JAX package's
models/layers.py).

Tensors are channel-last, (..., C), as in the JAX package. A reference 1x1
conv is a per-point linear map, so `Conv1x1` is a matmul over the trailing
axis; its weight keeps the reference torch shape ((out, in, 1, 1) for the
EdgeConv Conv2d layers, (out, in, 1) for the Conv1d ones) so that reference
`.pth` files load with `load_state_dict(strict=True)`.

Only evaluation is ported: BatchNorm normalises with its running statistics
(eps 1e-5, torch semantics) and refuses to run in training mode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

LEAKY_SLOPE = 0.2  # the reference uses LeakyReLU(0.2) everywhere


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise along `dim` with torch F.normalize's eps clamp."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


class Conv1x1(nn.Module):
    """Reference Conv1d/Conv2d with kernel size 1, applied channel-last."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, conv2d: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__()
        shape = (out_features, in_features) + ((1, 1) if conv2d else (1,))
        self.weight = nn.Parameter(torch.zeros(shape, device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        else:
            self.register_parameter("bias", None)

    @property
    def kernel(self) -> torch.Tensor:
        """The (in, out) matrix of the JAX package's Dense kernel."""
        return self.weight.reshape(self.weight.shape[0], -1).t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        if self.bias is not None:
            y = y + self.bias
        return y


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the trailing channel axis, with the
    parameter and buffer names of torch's BatchNorm1d/2d."""

    def __init__(self, features: int, eps: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long, device=device))

    def affine(self):
        """(scale, shift) of the eval-mode normalisation, for folding into
        adjacent matmuls (the JAX package's ManualBN.affine)."""
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "the port has eval-mode BatchNorm only (training is the next "
                "slice, ROADMAP queue 1 §6); call .eval()")
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * (inv * self.weight) + self.bias


class LeakyReLU(nn.Module):
    """Parameter-free slot in the reference Sequentials (keeps indices)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)


def conv_bn_stack(in_features: int, widths, conv2d: bool = False,
                  device: Optional[torch.device] = None) -> nn.Sequential:
    """[Conv1x1, BatchNorm, LeakyReLU] per width: the reference conv block,
    so width j sits at Sequential indices 3j (conv) and 3j+1 (bn)."""
    layers = []
    for i, w in enumerate(widths):
        fin = in_features if i == 0 else widths[i - 1]
        layers += [Conv1x1(fin, w, conv2d=conv2d, device=device),
                   BatchNorm(w, device=device), LeakyReLU()]
    return nn.Sequential(*layers)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every weight and BatchNorm statistic from `generator` (a CPU
    generator, so the same seed gives the same weights on every device).

    Conv weights are LeCun-normal; BatchNorm scales, shifts and running
    statistics are randomised so that folding them is exercised; any other
    parameter (the prototypes) is standard normal.
    """
    def normal(shape):
        return torch.randn(shape, generator=generator)

    done = set()
    for mod in module.modules():
        if isinstance(mod, Conv1x1):
            fan_in = mod.weight.shape[1]
            mod.weight.copy_(normal(mod.weight.shape) / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.copy_(0.1 * normal(mod.bias.shape))
        elif isinstance(mod, BatchNorm):
            c = mod.weight.shape[0]
            mod.weight.copy_(1.0 + 0.1 * normal(c))
            mod.bias.copy_(0.1 * normal(c))
            mod.running_mean.copy_(0.1 * normal(c))
            mod.running_var.copy_(
                0.5 + torch.rand(c, generator=generator))
        else:
            continue
        done.update(id(p) for p in mod.parameters(recurse=False))
    for p in module.parameters():
        if id(p) not in done:
            p.copy_(normal(p.shape))
    return module
