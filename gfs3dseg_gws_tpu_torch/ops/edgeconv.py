"""Neighbour gather for EdgeConv (forward of the JAX package's
ops/edgeconv.py::gather_neighbors)."""
from __future__ import annotations

import torch


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) point features, idx (B, N, K) indices into the N axis ->
    (B, N, K, C) neighbour features (one row gather over the flattened
    (B*N, C) table)."""
    b, n, c = x.shape
    k = idx.shape[-1]
    offset = (torch.arange(b, device=idx.device) * n)[:, None, None]
    flat = (idx.long() + offset).reshape(-1)
    return x.reshape(b * n, c)[flat].reshape(b, n, k, c)
