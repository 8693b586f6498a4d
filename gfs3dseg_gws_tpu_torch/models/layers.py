"""Shared building blocks (counterpart of the JAX package's
models/layers.py).

Tensors are channel-last, (..., C), as in the JAX package. A reference 1x1
conv is a per-point linear map, so `Conv1x1` is a matmul over the trailing
axis; its weight keeps the reference torch shape ((out, in, 1, 1) for the
EdgeConv Conv2d layers, (out, in, 1) for the Conv1d ones) so that reference
`.pth` files load with `load_state_dict(strict=True)`.

BatchNorm has torch semantics (eps 1e-5, momentum 0.1): in training it
normalises with the biased batch variance and moves the running variance
towards the UNBIASED one (x n/(n-1)), as the JAX package's BatchNorm and
ManualBN do; in eval mode it uses the running statistics.

Data parallelism (parallel/mesh.py): `use_mesh(model, mesh)` sets the mesh
on every module that reduces over the batch (each has a `mesh` attribute,
None by default). Then a train-mode BatchNorm normalises with the
statistics of the global batch, `cross_entropy` returns this rank's share
of the global mean and `dropout` takes this rank's rows of the global
batch's mask.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gfs3dseg_gws_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                                  local_rows, reduce_sum)

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
    """BatchNorm over the trailing channel axis, with the parameter and
    buffer names of torch's BatchNorm1d/2d. In training the statistics
    reduce over every other axis (for an edge tensor (B, N, K, C) that is
    B*N*K elements per channel). With a mesh the statistics are the
    global batch's: one all-reduce of the packed (sum x, sum x^2) through
    `AllReduceSum`, whose backward gives SyncBatchNorm's (the all-reduce of
    the two sums of the incoming gradient)."""

    momentum = 0.1     # weight of the batch in the running averages
    mesh: Optional[Mesh] = None

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

    @torch.no_grad()
    def record_batch_stats(self, mean: torch.Tensor, var: torch.Tensor,
                           n: int) -> None:
        """Fold batch statistics (biased `var` over `n` elements per
        channel) into the running averages: the train-mode side effect of
        forward, for callers that normalise outside the module (the fused
        training EdgeConv). JAX: ManualBN.record_batch_stats."""
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean.detach())
        self.running_var.mul_(1 - m).add_(
            (m * n / max(n - 1, 1)) * var.detach())
        self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return (x - self.running_mean) * (inv * self.weight) + self.bias
        axes = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        if self.mesh is None:
            mean = torch.mean(x, axes)
            ex2 = torch.mean(x * x, axes)
        else:
            # every rank holds as many rows, so the global count is static
            n *= self.mesh.size
            sums = reduce_sum(torch.stack([torch.sum(x, axes),
                                           torch.sum(x * x, axes)]),
                              self.mesh) / n
            mean, ex2 = sums[0], sums[1]
        # E[x^2] - E[x]^2, clamped: the JAX package's formula
        var = torch.clamp_min(ex2 - mean * mean, 0.0)
        self.record_batch_stats(mean, var, n)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class LeakyReLU(nn.Module):
    """Parameter-free slot in the reference Sequentials (keeps indices)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Inverted dropout whose mask comes from `generator` (a generator on
    x's device). Its stream is not flax's: tests compare at rate 0. With a
    mesh, x holds this rank's rows of the global batch: the mask is drawn
    for the global batch and this rank keeps its rows, so every rank's
    generator moves in step and the masks are the single process's."""
    if rate <= 0.0:
        return x
    shape = x.shape
    if mesh is not None:
        shape = (x.shape[0] * mesh.size,) + tuple(x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    if mesh is not None:
        keep = keep[local_rows(shape[0], mesh)]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(nn.Module):
    """Parameter-free slot in the reference Sequentials; active in training
    only. The caller passes the generator (see `dropout`)."""

    mesh: Optional[Mesh] = None

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, generator, self.mesh)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: Optional[int] = None,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean CE over points; logits (..., C), labels (...,) int. Matches
    torch nn.CrossEntropyLoss(ignore_index=...) (JAX: layers.cross_entropy).
    With a mesh, this rank's share: its sum of NLL over the GLOBAL count,
    so that the shares of the ranks add up to the global mean."""
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    if ignore_index is None and mesh is None:
        return -torch.gather(logp, -1, labels[..., None]).mean()
    if ignore_index is None:
        nll = -torch.gather(logp, -1, labels[..., None])
        return torch.sum(nll) / (nll.numel() * mesh.size)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    v = valid.to(nll.dtype)
    return torch.sum(nll * v) / torch.clamp_min(
        all_reduce_sum(torch.sum(v), mesh), 1.0)


def use_mesh(module: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Set `mesh` on every submodule that reduces over the batch (those with
    a `mesh` attribute: BatchNorm, Dropout, the EdgeConv blocks, the
    self-attention, GWCAPL), in the manner of
    nn.SyncBatchNorm.convert_sync_batchnorm, and on `module` itself, where
    the train steps (parallel/steps.py) read it; None restores one
    process. A `data x points` mesh is refused: training takes its data
    mesh (`Mesh.data_mesh`); the points axis splits evaluation only
    (parallel/mesh.py::points_split)."""
    if mesh is not None and mesh.sp > 1:
        raise ValueError("use_mesh: a data x points mesh splits evaluation "
                         "only; train on mesh.data_mesh()")
    for mod in module.modules():
        if hasattr(mod, "mesh"):
            mod.mesh = mesh
    module.mesh = mesh
    return module


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
def train_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisers, drawn from `generator` (a CPU
    generator): LeCun-normal conv kernels (flax lecun_normal: a normal
    truncated at 2 sigma, rescaled to variance 1/fan_in), zero biases,
    BatchNorm scale 1 and shift 0, running mean 0 and variance 1."""
    for mod in module.modules():
        if isinstance(mod, Conv1x1):
            fan_in = mod.weight.shape[1]
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            w = torch.empty(mod.weight.shape)
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()
    return module


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
