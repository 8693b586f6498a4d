"""Single-head self-attention over points, eval mode (counterpart of the JAX
package's models/attention.py; reference model/attention.py:10-48).

Bias-free Q, K, V 1x1 convs and temperature sqrt(out_channels); the weights
stay on chip in the fused kernel K2 (ops/attention_kernel.py). Dropout acts
on the attention weights only in training, which this slice does not port.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gfs3dseg_gws_tpu_torch.models.layers import Conv1x1
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import fused_attention


class SelfAttention(nn.Module):
    def __init__(self, in_features: int, out_channels: int = 64,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.out_channels = out_channels
        self.q_map = Conv1x1(in_features, out_channels, device=device)
        self.k_map = Conv1x1(in_features, out_channels, device=device)
        self.v_map = Conv1x1(in_features, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N, C_in) -> (B, N, out_channels)."""
        if self.training:
            raise NotImplementedError(
                "attention dropout (training) is not ported yet; call .eval()")
        temperature = float(self.out_channels) ** 0.5
        return fused_attention(self.q_map(x), self.k_map(x), self.v_map(x),
                               temperature)
