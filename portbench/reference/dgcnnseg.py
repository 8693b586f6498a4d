"""The plain reference of DGCNNSeg, the backbone pre-training segmentor:
its training forward pass, its mean cross-entropy, the gradients through
torch.autograd and Adam's update with L2 weight decay, in plain PyTorch on
a dictionary of tensors keyed as the reference's state dict.

It follows attMPTI's pre-training segmentor (Zhao et al., CVPR 2021,
arXiv 2006.12052; reference pretrain/runs/pre_train.py:22-48 for the
model, 86-198 for the loop, pretrain/pretrain_segmentor.sh for the
recipe): the DGCNN encoder (arXiv 1801.07829) as `reference.gwcapl`
writes it (each EdgeConv builds the (B, N, k, 2C) edge tensor from a
top-k of pairwise distances and runs its 1x1 convs on it; textbook
BatchNorm), the global max of the point feature over the points,
broadcast to every point after the EdgeConv features, and the segmenter
Conv(256, no bias), BN, LeakyReLU(0.2), Conv(128), BN, LeakyReLU(0.2),
Dropout(0.3), Conv(classes); mean cross-entropy over the points; Adam
with L2 weight decay (torch.optim.Adam's `weight_decay`: wd * p added to
the gradient before the moments, not AdamW's decoupled decay). It
imports nothing of the programs it judges; the encoder pieces are
`reference.gwcapl`'s.

Departures from pre_train.py:
- The dropout mask is drawn as `torch.rand((B, N, 128), generator=g) >=
  rate` from a generator on the batch's device at the program's seed and
  offset (seeded once with the run's seed, as the program's, and moved on
  by each step's one draw), and the kept values are scaled by
  1 / (1 - rate). That is plain torch, and the program's own draw;
  nn.Dropout draws its mask from its own stream, which no other code can
  reproduce.
- The kNN distances are worked out in float64 (`reference.gwcapl.knn`),
  and the program's kNN rows are taken where they differ from the
  reference's only by a near-tie (`reference.gwcapl.Graphs`).
- Tensors are channel-last, (B, N, C): a 1x1 conv is a matmul over the
  trailing axis, as in every reference of this benchmark.
- The LR is the recipe's base LR: the checked steps lie within StepLR's
  first 50 epochs, where its factor is 1.
Float32 throughout; `reference.gwcapl.precision("tf32")` lowers every
product to TF32 for the control.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference.gwcapl import (Adam, Graphs, batchnorm, conv, edgeconv,
                              leaky)

Params = Dict[str, torch.Tensor]
# a run's state before a step: parameters, Adam's first and second moments
# by name, and its step count
Start = Tuple[Params, Params, Params, int]


def dropout_keep(generator: torch.Generator, shape: Sequence[int],
                 rate: float, device: torch.device) -> torch.Tensor:
    """The keep mask of one dropout call: uniforms from `generator` at its
    seed and offset, kept where at or above `rate`."""
    return torch.rand(tuple(shape), generator=generator, device=device) \
        >= rate


def logits(p: Params, cfg: dict, x: torch.Tensor, train: bool,
           keep: Optional[torch.Tensor] = None,
           graphs: Optional[Graphs] = None) -> torch.Tensor:
    """(B, N, classes) logits of the points x (B, N, C_in); in training the
    batch's BatchNorm statistics and, with `keep`, the dropout mask of
    the segmenter's 128-wide layer."""
    edges, h = [], x
    for i, w in enumerate(cfg["edgeconv_widths"]):
        h = edgeconv(p, i, h, w, cfg["dgcnn_k"], train, graphs)
        edges.append(h)
    f = torch.cat(edges, dim=-1)
    for j in range(len(cfg["dgcnn_mlp_widths"])):
        f = leaky(batchnorm(p, f"encoder.conv.layer.{3 * j + 1}",
                            conv(p, f"encoder.conv.layer.{3 * j}", f), train))
    g = f.amax(dim=1, keepdim=True).expand(-1, x.shape[1], -1)
    h = torch.cat(edges + [g], dim=-1)
    h = leaky(batchnorm(p, "segmenter.1", conv(p, "segmenter.0", h), train))
    h = leaky(batchnorm(p, "segmenter.4", conv(p, "segmenter.3", h), train))
    if keep is not None:
        rate = cfg["dropout"]
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    return conv(p, "segmenter.7", h)


def loss(p: Params, cfg: dict, x: torch.Tensor, y: torch.Tensor,
         keep: Optional[torch.Tensor], graphs: Optional[Graphs] = None
         ) -> torch.Tensor:
    """Mean cross-entropy over every point of the batch, in training."""
    out = logits(p, cfg, x, True, keep, graphs)
    return F.cross_entropy(out.reshape(-1, out.shape[-1]),
                           y.reshape(-1).long())


def train_steps(state: Params, trainable: List[str], cfg: dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                seed: int, graphs: Optional[Graphs] = None,
                starts: Optional[Sequence[Start]] = None
                ) -> Tuple[List[float], Dict[str, torch.Tensor],
                           List[Dict[str, torch.Tensor]]]:
    """len(batches) pre-training steps from `state` under Adam at the
    recipe's LR with L2 weight decay, each with its dropout mask drawn
    from one generator seeded with `seed`, the kNN graphs through
    `graphs`. With `starts`, step i begins from starts[i], another run's
    state before its step i (its parameters, Adam's moments and step
    count), instead of from where step i - 1 left the reference: each
    step is then compared alone. Returns (each step's loss, the first
    step's gradients as the optimizer takes them, wd * p added, the
    parameters after each step)."""
    p = {n: t.detach().clone() for n, t in state.items()}
    params = {n: p[n] for n in trainable}
    opt = Adam(params, {n: cfg["lr"] for n in trainable})
    wd, rate = cfg["weight_decay"], cfg["dropout"]
    width = p["segmenter.3.weight"].shape[0]
    device = batches[0][0].device
    gen = torch.Generator(device=device).manual_seed(seed)
    losses, first, afters = [], None, []
    for i, (x, y) in enumerate(batches):
        if starts is not None:
            start(opt, starts[i])
        keep = dropout_keep(gen, (x.shape[0], x.shape[1], width), rate,
                            device) if rate > 0 else None
        for t in params.values():
            t.requires_grad_(True)
        value = loss(p, cfg, x, y, keep, graphs)
        grads = torch.autograd.grad(value, list(params.values()))
        for t in params.values():
            t.requires_grad_(False)
        grads = {n: g + wd * params[n] for n, g in zip(params, grads)}
        losses.append(float(value.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(grads)
        afters.append({n: t.detach().clone() for n, t in params.items()})
        del value, grads
    return losses, first, afters


@torch.no_grad()
def start(opt: Adam, at: Start) -> None:
    """Put a state (parameters, first and second moments by name, step
    count) into `opt` and its parameters, in place."""
    params, m, v, t = at
    for n, tensor in opt.params.items():
        tensor.copy_(params[n])
        opt.m[n].copy_(m[n])
        opt.v[n].copy_(v[n])
    opt.t = t
