"""DGCNN backbone (counterpart of the JAX package's models/dgcnn.py;
reference model/dgcnn.py:83-152).

The first 1x1 conv of an EdgeConv block acts on concat([x_j - x_i, x_i]);
that linear map splits into two per-POINT matmuls plus a gather-add,
    (x_j - x_i) @ Wd + x_i @ Wc == (x_j @ Wd) + x_i @ (Wc - Wd),
so the (B, N, K, 2C) edge tensor of the reference is never built. For a
block of two widths (the model's), both BatchNorms are folded into the
neighbour table a, the centre table b, W2' and bias2 exactly as the JAX
package folds them (its dgcnn.py:99-105), and the rest of the block - kNN,
gather, layer 2, max - is the fused kernel K1 (ops/fused_edgeconv.py).

In training (module.training) such a block computes the unscaled tables
a = x @ Wd and b = x @ (Wc - Wd), builds the kNN graph with its neighbour
statistics (K3, ops/knn.py::knn_with_stats) and runs the fused training
block (K4, ops/fused_edgeconv_train.py), whose batch statistics feed both
BatchNorms' running averages (JAX dgcnn.py:107-125).

A block of any other depth (the DGCNN semantic-segmentation backbone's
third block is one layer deep) builds its graph with K6
(ops/knn.py::knn_indices) and gathers the neighbour table with
ops/edgeconv.py::gather_neighbors, whose backward is K7; its layers are
torch ops on the (B, N, K, W) edge tensor, in eval and in training.

With a mesh (parallel/mesh.py, set by models/layers.py::use_mesh) a
training block's BatchNorm statistics are the global batch's: the fused
Function and the BatchNorm modules all-reduce them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from gfs3dseg_gws_tpu_torch.models.layers import (Conv1x1, BatchNorm,
                                                  conv_bn_stack, leaky_relu)
from gfs3dseg_gws_tpu_torch.ops.edgeconv import gather_neighbors
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import fused_edgeconv_infer
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv_train import (
    fused_edgeconv_train)
from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices, knn_with_stats
from gfs3dseg_gws_tpu_torch.parallel.mesh import Mesh


class EdgeConvBlock(nn.Module):
    """One dynamic EdgeConv: kNN graph -> edge MLP -> max over neighbours.

    `layer` is the reference Sequential; its first conv has weight
    (widths[0], 2 * C_in, 1, 1) over the [x_j - x_i, x_i] channel concat.
    """

    mesh: Optional[Mesh] = None

    def __init__(self, in_features: int, widths: Sequence[int], k: int = 20,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.widths = tuple(widths)
        self.k = k
        self.layer = conv_bn_stack(2 * in_features, widths, conv2d=True,
                                   device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N, C) -> (B, N, widths[-1])."""
        c = x.shape[-1]
        kernel = self.layer[0].kernel                       # (2C, w0)
        wd, wc = kernel[:c], kernel[c:]
        bn1 = self.layer[1]
        if len(self.widths) == 2 and self.training:
            conv2, bn2 = self.layer[3], self.layer[4]
            a_tab = x @ wd
            b_tab = x @ (wc - wd)
            idx, cnt, scb = knn_with_stats(x.detach().contiguous(),
                                           b_tab.detach(), self.k)
            out, mu1, var1, mu2, var2 = fused_edgeconv_train(
                a_tab, b_tab, bn1.weight, bn1.bias, conv2.kernel,
                bn2.weight, bn2.bias, idx, cnt, scb, mesh=self.mesh)
            n_stats = idx.numel()          # statistics over (B, N, K)
            if self.mesh is not None:
                n_stats *= self.mesh.size  # ... of the global batch
            bn1.record_batch_stats(mu1, var1, n_stats)
            bn2.record_batch_stats(mu2, var2, n_stats)
            return out
        if len(self.widths) == 2:
            s1, t1 = bn1.affine()
            a_table = (x @ wd) * s1
            b_table = (x @ (wc - wd)) * s1 + t1
            conv2, bn2 = self.layer[3], self.layer[4]
            s2, t2 = bn2.affine()
            w2f = conv2.kernel * s2[None, :]
            return fused_edgeconv_infer(x.contiguous(), a_table, b_table,
                                        w2f.contiguous(), t2, self.k)
        # blocks of other depths (JAX dgcnn.py:126-134): the kNN indices
        # (K6), the gather whose backward is K7, then the layers as torch
        # ops, in training with batch statistics over (B, N, K)
        idx = knn_indices(x.detach().contiguous(), self.k)  # (B, N, K)
        h = gather_neighbors(x @ wd, idx) + (x @ (wc - wd))[:, :, None, :]
        h = leaky_relu(bn1(h))
        for j in range(1, len(self.widths)):
            h = leaky_relu(self.layer[3 * j + 1](self.layer[3 * j](h)))
        return torch.amax(h, dim=2)


class _ConvStack(nn.Module):
    """Holds the reference's `conv.layer` Sequential (a point MLP)."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 device: Optional[torch.device] = None):
        super().__init__()
        self.layer = conv_bn_stack(in_features, widths, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class DGCNN(nn.Module):
    """Stacked EdgeConv blocks + point MLP (reference model/dgcnn.py:83-127).

    Returns (edgeconv_outputs, final_feat): the per-block outputs (each
    (B, N, 64) by default) and the (B, N, mlp_widths[-1]) point feature.
    """

    def __init__(self, in_features: int = 9,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64),) * 3,
                 mlp_widths: Sequence[int] = (512, 256), k: int = 20,
                 device: Optional[torch.device] = None):
        super().__init__()
        blocks = []
        fin = in_features
        for widths in edgeconv_widths:
            blocks.append(EdgeConvBlock(fin, widths, k=k, device=device))
            fin = widths[-1]
        self.edge_convs = nn.ModuleList(blocks)
        self.conv = _ConvStack(sum(w[-1] for w in edgeconv_widths),
                               mlp_widths, device=device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        outputs = []
        h = x
        for block in self.edge_convs:
            h = block(h)
            outputs.append(h)
        return outputs, self.conv(torch.cat(outputs, dim=-1))


class BaseLearner(nn.Module):
    """1x1 convs WITH bias + BN; ReLU between layers but not after the last
    (reference model/dgcnn.py:130-152)."""

    def __init__(self, in_features: int, widths: Sequence[int] = (128, 64),
                 device: Optional[torch.device] = None):
        super().__init__()
        convs = []
        for i, w in enumerate(widths):
            fin = in_features if i == 0 else widths[i - 1]
            convs.append(nn.Sequential(
                Conv1x1(fin, w, bias=True, device=device),
                BatchNorm(w, device=device)))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i != len(self.convs) - 1:
                x = torch.relu(x)
        return x
