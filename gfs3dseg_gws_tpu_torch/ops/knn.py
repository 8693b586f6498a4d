"""k-nearest-neighbour graph, plain path (counterpart of the JAX package's
ops/knn.py `pairwise_sq_dists` and `_knn_xla`).

Score = -squared-L2 distance, top-k of the score with the point itself
included (reference model/dgcnn.py:17-23). On the eval path the kNN graph is
built inside the fused EdgeConv kernel (ops/fused_edgeconv.py); this plain
version serves the kernel's plain counterpart and EdgeConv blocks that are
not two layers deep.
"""
from __future__ import annotations

import torch


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between rows of x (..., M, C) and y (..., N, C),
    in the JAX package's formula and order: |x|^2 - 2 x.y + |y|^2."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)                # (..., M, 1)
    yy = torch.sum(y * y, dim=-1, keepdim=True)                # (..., N, 1)
    xy = torch.einsum("...mc,...nc->...mn", x, y)              # (..., M, N)
    return xx - 2.0 * xy + yy.transpose(-1, -2)


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, N, C) -> neighbour indices (B, N, k) int64, nearest first."""
    score = -pairwise_sq_dists(x, x)
    return torch.topk(score, k, dim=-1).indices
