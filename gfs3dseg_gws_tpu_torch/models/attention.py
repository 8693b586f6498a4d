"""Single-head self-attention over points (counterpart of the JAX package's
models/attention.py; reference model/attention.py:10-48).

Bias-free Q, K, V 1x1 convs and temperature sqrt(out_channels). In eval
mode the weights stay on chip in the fused kernel K2
(ops/attention_kernel.py); in training dropout (rate `attn_dropout`) acts
on the normalised weights inside K5a/K5b (ops/attention_train.py), with a
per-step seed drawn from the caller's generator. With a mesh
(parallel/mesh.py) every rank draws the same seed and passes its first
global row as the mask's batch offset, so the ranks draw the single
process's mask. Under the `data x points` mesh (`points_mesh`, eval only)
x holds this rank's points of each block: k and v are all-gathered over
the points group, q stays local, and K2 takes the local queries against
every key.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gfs3dseg_gws_tpu_torch.models.layers import Conv1x1
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import fused_attention
from gfs3dseg_gws_tpu_torch.ops.attention_train import attention_train
from gfs3dseg_gws_tpu_torch.parallel.mesh import Mesh, all_gather_points


def draw_seed(generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """A one-element int32 dropout seed in [0, 2^31 - 1) on `device`, from
    `generator` (on that device; None: the device's default generator).
    It stays on the device, so drawing it never waits for the host."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)


class SelfAttention(nn.Module):
    mesh: Optional[Mesh] = None
    points_mesh: Optional[Mesh] = None

    def __init__(self, in_features: int, out_channels: int = 64,
                 attn_dropout: float = 0.1,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.out_channels = out_channels
        self.attn_dropout = attn_dropout
        self.q_map = Conv1x1(in_features, out_channels, device=device)
        self.k_map = Conv1x1(in_features, out_channels, device=device)
        self.v_map = Conv1x1(in_features, out_channels, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, N, C_in) -> (B, N, out_channels). `generator` draws the
        dropout seed in training."""
        temperature = float(self.out_channels) ** 0.5
        q, k, v = self.q_map(x), self.k_map(x), self.v_map(x)
        if not self.training:
            if self.points_mesh is not None:
                k = all_gather_points(k, self.points_mesh)
                v = all_gather_points(v, self.points_mesh)
            return fused_attention(q, k, v, temperature)
        offset = 0 if self.mesh is None else self.mesh.rank * x.shape[0]
        return attention_train(q, k, v, draw_seed(generator, x.device),
                               temperature, self.attn_dropout, offset)
