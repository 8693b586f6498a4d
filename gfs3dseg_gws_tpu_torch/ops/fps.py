"""Farthest point sampling (counterpart of the JAX package's ops/fps.py;
reference pretrain/models/mpti.py:153, torch_cluster's
`fps(..., random_start=False)`).

The JAX package runs it as a `lax.fori_loop`, not a Pallas kernel; here it
is a loop of torch ops whose selected indices stay on the device (no host
read in the loop), so it queues without a sync on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e30


def farthest_point_sampling(x: torch.Tensor, n_samples: int,
                            valid_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """n_samples indices of x (N, C) by iterative farthest-point selection.

    The walk starts at the first valid row; each step takes the valid row
    farthest from everything selected so far, the first such row on a tie
    (torch.argmax's documented rule, lax.argmax's too). Invalid rows are
    never selected unless no row is valid (then index 0, as in JAX); when
    fewer rows are valid than n_samples, indices repeat. Returns
    (n_samples,) int64 on x's device.
    """
    n = x.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=x.device)
    valid_mask = valid_mask.to(torch.bool)
    selected = torch.zeros(n_samples, dtype=torch.long, device=x.device)
    selected[0] = torch.argmax(valid_mask.to(torch.uint8))
    min_d = torch.full((n,), _BIG, dtype=torch.float32, device=x.device)
    floor = torch.full((n,), -_BIG, dtype=torch.float32, device=x.device)
    for i in range(1, n_samples):
        last = torch.index_select(x, 0, selected[i - 1:i])   # (1, C)
        d = torch.sum((x - last) ** 2, dim=-1)
        min_d = torch.minimum(min_d, d)
        selected[i] = torch.argmax(torch.where(valid_mask, min_d, floor))
    return selected
