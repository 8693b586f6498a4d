"""Energy-threshold multi-hot coding of geometric-word histograms
(counterpart of the JAX package's ops/coding.py; reference train.py:132-152).
"""
from __future__ import annotations

import torch


def energy_multihot(coding: torch.Tensor, energy: float) -> torch.Tensor:
    """Convert probability/frequency vector(s) (..., K) to an
    energy-truncated multi-hot in {0., 1.}.

    In descending-value order (stable: ties keep their original order), an
    element is kept iff the EXCLUSIVE prefix sum before it is <=
    energy * total, so the element that pushes the running sum over the
    threshold is still kept, matching the reference's post-increment break.
    """
    total = torch.sum(coding, dim=-1, keepdim=True)
    order = torch.argsort(-coding, dim=-1, stable=True)
    sorted_vals = torch.gather(coding, -1, order)
    inclusive = torch.cumsum(sorted_vals, dim=-1)
    exclusive = inclusive - sorted_vals
    keep_sorted = (exclusive <= energy * total).to(coding.dtype)
    return torch.zeros_like(coding).scatter(-1, order, keep_sorted)
