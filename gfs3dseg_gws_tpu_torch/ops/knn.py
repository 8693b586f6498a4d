"""k-nearest-neighbour graph (counterpart of the JAX package's ops/knn.py).

Score = -squared-L2 distance, top-k of the score with the point itself
included (reference model/dgcnn.py:17-23). On the eval path of a block two
layers deep the kNN graph is built inside the fused EdgeConv kernel
(ops/fused_edgeconv.py).

`knn_indices` (K6) gives the indices alone, for EdgeConv blocks that are not
two layers deep (models/dgcnn.py) and for the split eval EdgeConv. It
replaces the JAX package's TPU kernel ops/knn.py::knn_indices (`_knn_pallas`,
body `_knn_kernel`) with K1's kNN stage launched alone
(`knn_kernel<CP, false>` in csrc/fused_edgeconv.cu). `knn_indices_plain` is
its twin; the plain twins of K1 and K3 call the twin, never the kernel.

`knn_with_stats` (K3) is the training path's kNN: it also returns the
in-degrees and the transposed b-scatter that let the fused training
EdgeConv (ops/fused_edgeconv_train.py) compute its first BatchNorm's batch
statistics before any gather. It replaces the JAX package's TPU kernel
ops/knn.py::knn_with_stats (`_knn_stats_kernel`) with the CUDA kernel
`knn_kernel<CP, true>` in csrc/fused_edgeconv.cu.
"""
from __future__ import annotations

from typing import Tuple

import torch

from gfs3dseg_gws_tpu_torch.ops import _ext


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between rows of x (..., M, C) and y (..., N, C),
    in the JAX package's formula and order: |x|^2 - 2 x.y + |y|^2."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)                # (..., M, 1)
    yy = torch.sum(y * y, dim=-1, keepdim=True)                # (..., N, 1)
    xy = torch.einsum("...mc,...nc->...mn", x, y)              # (..., M, N)
    return xx - 2.0 * xy + yy.transpose(-1, -2)


def knn_indices_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain twin of K6: x (B, N, C) -> neighbour indices (B, N, k) int32,
    nearest first (JAX: _knn_xla)."""
    score = -pairwise_sq_dists(x, x)
    return torch.topk(score, k, dim=-1).indices.to(torch.int32)


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Neighbour indices (B, N, k) int32 of x (B, N, C), nearest first, self
    included.

    A CPU tensor goes to `knn_indices_plain`; a CUDA tensor to K6 (C <= 64,
    1 <= k <= min(N, 32); anything else raises). Ties at equal distance go
    to the lower index, as in K1. x should be detached: the graph carries
    no gradient.
    """
    if x.device.type == "cpu":
        return knn_indices_plain(x, k)
    name = "knn_indices"
    _ext.check_tensors(name, x=x)
    b, n, c = x.shape
    if c > 64 or not 1 <= k <= min(n, 32):
        raise ValueError(f"{name}: the kernel takes C <= 64 and "
                         f"1 <= k <= min(N, 32); got C={c}, k={k}, N={n}")
    idx = torch.empty((b, n, k), device=x.device, dtype=torch.int32)
    lib = _ext.library()
    with torch.cuda.device(x.device):
        code = lib.gfs_knn_indices(x.data_ptr(), idx.data_ptr(), b, n, c, k,
                                   _ext.current_stream(x.device))
    _ext.check(code, name)
    knn_indices.launches += 1
    return idx


knn_indices.launches = 0


def neighbor_stats_plain(idx: torch.Tensor, btab: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-degrees and transposed b-scatter of a kNN graph (JAX:
    neighbor_stats_xla):

        cnt[b, 0, j] = |{(i, r) : idx[b, i, r] == j}|
        scb[b, j, :] = sum over those (i, r) of btab[b, i, :]
    """
    bsz, n, k = idx.shape
    c = btab.shape[-1]
    flat = idx.reshape(bsz, n * k).long()
    cnt = torch.zeros((bsz, n), dtype=btab.dtype, device=btab.device)
    cnt.scatter_add_(1, flat, torch.ones_like(flat, dtype=btab.dtype))
    src = btab[:, :, None, :].expand(bsz, n, k, c).reshape(bsz, n * k, c)
    scb = torch.zeros_like(btab).scatter_add_(
        1, flat[..., None].expand(bsz, n * k, c), src)
    return cnt[:, None, :], scb


def knn_with_stats_plain(x: torch.Tensor, btab: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K3: `knn_indices_plain` + `neighbor_stats_plain`."""
    idx = knn_indices_plain(x, k)
    return (idx,) + neighbor_stats_plain(idx, btab)


def knn_with_stats(x: torch.Tensor, btab: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN indices + (in-degree counts, transposed b-scatter).

    Args:
      x:    (B, N, C) features the graph is built on (C <= 64 on CUDA).
      btab: (B, N, Cb) centre-term table to scatter (Cb <= 64 on CUDA).
      k:    neighbours per point, self included (k <= 32 on CUDA).
    Returns:
      (idx (B, N, k) int32, cnt (B, 1, N) f32, scb (B, N, Cb) f32).
    Both inputs should be detached: the statistics are inputs-only, their
    gradient is carried in closed form by the fused training EdgeConv.

    A CPU tensor goes to `knn_with_stats_plain`; a CUDA tensor to K3, which
    raises on what it does not take. K3 adds with float atomics, so the
    last bits of `scb` vary from run to run; `cnt` is exact.
    """
    if x.device.type == "cpu":
        return knn_with_stats_plain(x, btab, k)
    name = "knn_with_stats"
    _ext.check_tensors(name, x=x, btab=btab)
    b, n, c = x.shape
    cb = btab.shape[-1]
    if btab.shape[:2] != (b, n):
        raise ValueError(f"{name}: x {tuple(x.shape)} and btab "
                         f"{tuple(btab.shape)} do not agree")
    if c > 64 or cb > 64 or not 1 <= k <= min(n, 32):
        raise ValueError(f"{name}: the kernel takes C, Cb <= 64 and "
                         f"1 <= k <= min(N, 32); got C={c}, Cb={cb}, k={k}, "
                         f"N={n}")
    idx = torch.empty((b, n, k), device=x.device, dtype=torch.int32)
    cnt = torch.zeros((b, 1, n), device=x.device, dtype=torch.float32)
    scb = torch.zeros((b, n, cb), device=x.device, dtype=torch.float32)
    lib = _ext.library()
    with torch.cuda.device(x.device):
        code = lib.gfs_knn_with_stats(
            x.data_ptr(), btab.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
            scb.data_ptr(), b, n, c, cb, k, _ext.current_stream(x.device))
    _ext.check(code, name)
    knn_with_stats.launches += 1
    return idx, cnt, scb


knn_with_stats.launches = 0
