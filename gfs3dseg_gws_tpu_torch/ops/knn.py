"""k-nearest-neighbour graph (counterpart of the JAX package's ops/knn.py).

Score = -squared-L2 distance, top-k of the score with the point itself
included (reference model/dgcnn.py:17-23). On the eval path of a block two
layers deep the kNN graph is built inside the fused EdgeConv kernel
(ops/fused_edgeconv.py).

`knn_indices` (K6) gives the indices alone, for EdgeConv blocks that are not
two layers deep (models/dgcnn.py) and for the split eval EdgeConv; like K1
it takes a range of query rows against every row as keys (`q_offset`,
`nq`: a rank's own points of a block under the `data x points` mesh). It
replaces the JAX package's TPU kernel ops/knn.py::knn_indices (`_knn_pallas`,
body `_knn_kernel`) with K1's kNN stage launched alone
(`knn_split_kernel<CP, KMAX, S, false>` in csrc/fused_edgeconv.cu: each
query's keys split over S threads whose lists are merged exactly).
`knn_indices_plain` is its twin; the plain twins of K1 and K3 call the twin,
never the kernel.

`knn_with_stats` (K3) is the training path's kNN: it also returns the
in-degrees and the transposed b-scatter that let the fused training
EdgeConv (ops/fused_edgeconv_train.py) compute its first BatchNorm's batch
statistics before any gather. It replaces the JAX package's TPU kernel
ops/knn.py::knn_with_stats (`_knn_stats_kernel`) with the CUDA kernel
`knn_split_kernel<CP, KMAX, S, true>` in csrc/fused_edgeconv.cu.

Both take any C, any N and any 1 <= k <= N on the card, by variant: the
split selection for C <= 64 and k <= 32; one thread per query
(`knn_kernel`) past it, the channels streamed in chunks for C > 64, the
register insertion chain for k <= 64; K8's selection for k > 64: up to
k = 256 its streaming selection (`knn_stream_kernel`: each query's sorted
list and queue of taken keys in shared memory, at any N), past it the
fold-merge tournament (a query's key row in shared memory; past N ~ 27,000
in chunks whose k best are merged through a scratch the wrapper
allocates).

`knn_indices_fold` (K8) replaces the JAX package's TPU kernel
ops/knn.py::_knn_pallas_fold (body `_knn_fold_kernel`), the fold-merge
tournament, with csrc/knn_fold.cu: `knn_stream_kernel` for k <= 256,
`knn_fold_kernel` (the tournament) past it. Its plain twin
`knn_indices_fold_plain` runs the JAX tournament in torch. As in JAX, no
model path calls it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gfs3dseg_gws_tpu_torch.ops import _ext
from gfs3dseg_gws_tpu_torch.utils.observability import span


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between rows of x (..., M, C) and y (..., N, C),
    in the JAX package's formula and order: |x|^2 - 2 x.y + |y|^2."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)                # (..., M, 1)
    yy = torch.sum(y * y, dim=-1, keepdim=True)                # (..., N, 1)
    xy = torch.einsum("...mc,...nc->...mn", x, y)              # (..., M, N)
    return xx - 2.0 * xy + yy.transpose(-1, -2)


def knn_indices_plain(x: torch.Tensor, k: int, q_offset: int = 0,
                      nq: Optional[int] = None) -> torch.Tensor:
    """Plain twin of K6: x (B, N, C) -> neighbour indices (B, nq, k) int32
    of the query rows [q_offset, q_offset + nq) (default: every row) among
    all N rows, nearest first, ties to the lower index (JAX: _knn_xla,
    whose lax.top_k breaks ties so; torch.topk's tie order is neither,
    hence a stable sort). A query's row depends on its own row of x and the
    keys alone, so a local call gives the rows of the full call."""
    nq = query_rows("knn_indices_plain", x.shape[1], q_offset, nq)
    score = -pairwise_sq_dists(x[:, q_offset:q_offset + nq], x)
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


def query_rows(name: str, n: int, q_offset: int, nq: Optional[int]) -> int:
    """nq (None: the rows from q_offset to N), after checking that the
    query rows [q_offset, q_offset + nq) lie in [0, N)."""
    nq = n - q_offset if nq is None else nq
    if nq < 1 or q_offset < 0 or q_offset + nq > n:
        raise ValueError(f"{name}: query rows [{q_offset}, {q_offset + nq}) "
                         f"do not lie in [0, {n})")
    return nq


def knn_indices(x: torch.Tensor, k: int, q_offset: int = 0,
                nq: Optional[int] = None) -> torch.Tensor:
    """Neighbour indices (B, nq, k) int32 of the query rows [q_offset,
    q_offset + nq) of x (B, N, C) (default: every row) among all N rows,
    as indices in [0, N), nearest first, self included. A sequence-
    parallel rank passes its own rows of a block against the block's
    all-gathered x (models/dgcnn.py).

    A CPU tensor goes to `knn_indices_plain`; a CUDA tensor to K6 (any C,
    1 <= k <= N; k > N raises, as in JAX). Ties at equal distance go to the
    lower index, on the card as in the twin and in JAX. x should be
    detached: the graph carries no gradient.
    """
    if x.device.type == "cpu":
        return knn_indices_plain(x, k, q_offset, nq)
    with span("op.k6"):
        name = "knn_indices"
        _ext.check_tensors(name, x=x)
        b, n, c = x.shape
        _check_k(name, k, n)
        nq = query_rows(name, n, q_offset, nq)
        idx = torch.empty((b, nq, k), device=x.device, dtype=torch.int32)
        scratch = _ext.knn_scratch(name, x, k, nq=nq)
        lib = _ext.library()
        with torch.cuda.device(x.device):
            code = lib.gfs_knn_indices(x.data_ptr(), idx.data_ptr(),
                                       _ext.ptr(scratch), b, n, nq, q_offset,
                                       c, k, _ext.current_stream(x.device))
        _ext.check(code, name)
        return idx


def _check_k(name: str, k: int, n: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"{name}: k must lie in [1, N]; got k={k}, N={n}")


_NO_KEY = torch.iinfo(torch.int64).max


def knn_indices_fold_plain(x: torch.Tensor, k: int, folds: int = 4
                           ) -> torch.Tensor:
    """Plain twin of K8: the fold-merge tournament in torch. Keys are
    (distance bits << 32) | index (the squared distances of
    `pairwise_sq_dists`, clamped at 0), padded to folds x ceil(N / folds)
    with int64 max; every column is sorted across the folds, then k rounds
    each pop the minimum of fold 0 and shift its column up by one fold.
    x (B, N, C) -> (B, N, k) int32, nearest first."""
    if folds not in (2, 4, 8):
        raise ValueError(f"folds must be 2, 4 or 8, got {folds}")
    bsz, n, _ = x.shape
    _check_k("knn_indices_fold_plain", k, n)
    d2 = torch.clamp_min(pairwise_sq_dists(x, x), 0.0).float()
    bits = d2.contiguous().view(torch.int32).long() & 0x7FFFFFFF
    keys = (bits << 32) | torch.arange(n, device=x.device)
    w = -(-n // folds)
    keys = torch.cat([keys, keys.new_full((bsz, n, folds * w - n), _NO_KEY)],
                     -1)
    cols = keys.reshape(bsz, n, folds, w).sort(dim=2).values
    out = []
    for _ in range(k):
        best, col = cols[:, :, 0, :].min(dim=-1)               # (B, N)
        out.append(best & 0xFFFFFFFF)
        at = col[:, :, None, None].expand(bsz, n, folds, 1)
        column = cols.gather(3, at)                            # (B, N, F, 1)
        shifted = torch.cat([column[:, :, 1:],
                             torch.full_like(column[:, :, :1], _NO_KEY)], 2)
        cols = cols.scatter(3, at, shifted)
    return torch.stack(out, -1).to(torch.int32)


def knn_indices_fold(x: torch.Tensor, k: int, folds: int = 4) -> torch.Tensor:
    """K8: `knn_indices` by an exact selection of its own (JAX:
    _knn_pallas_fold), (B, N, C) -> (B, N, k) int32, nearest first.

    A CPU tensor goes to `knn_indices_fold_plain`; a CUDA tensor to the
    kernel at any N (ragged N needs no gate), any C and 1 <= k <= N: the
    streaming selection for k <= 256, the fold-merge tournament past it
    (a key row past ~27,000 streamed in chunks). `folds` (2, 4 or 8) is
    validated as in JAX: up to k = 256 it is kept for parity with JAX alone
    and unused, past it it sets the tournament's layout; the indices never
    depend on it. Its distances are K6's own, so on the card its indices
    equal `knn_indices`' bit for bit.
    """
    if x.device.type == "cpu":
        return knn_indices_fold_plain(x, k, folds)
    with span("op.k8"):
        name = "knn_indices_fold"
        _ext.check_tensors(name, x=x)
        b, n, c = x.shape
        _check_k(name, k, n)
        if folds not in (2, 4, 8):
            raise ValueError(f"{name}: folds must be 2, 4 or 8, got {folds}")
        idx = torch.empty((b, n, k), device=x.device, dtype=torch.int32)
        scratch = _ext.knn_scratch(name, x, k, folds)
        lib = _ext.library()
        with torch.cuda.device(x.device):
            code = lib.gfs_knn_fold(x.data_ptr(), idx.data_ptr(),
                                    _ext.ptr(scratch), b, n, c, k, folds,
                                    _ext.current_stream(x.device))
        _ext.check(code, name)
        return idx


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
      x:    (B, N, C) features the graph is built on.
      btab: (B, N, Cb) centre-term table to scatter.
      k:    neighbours per point, self included (1 <= k <= N).
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
    with span("op.k3"):
        name = "knn_with_stats"
        _ext.check_tensors(name, x=x, btab=btab)
        b, n, c = x.shape
        cb = btab.shape[-1]
        if btab.shape[:2] != (b, n):
            raise ValueError(f"{name}: x {tuple(x.shape)} and btab "
                             f"{tuple(btab.shape)} do not agree")
        _check_k(name, k, n)
        idx = torch.empty((b, n, k), device=x.device, dtype=torch.int32)
        cnt = torch.zeros((b, 1, n), device=x.device, dtype=torch.float32)
        scb = torch.zeros((b, n, cb), device=x.device, dtype=torch.float32)
        scratch = _ext.knn_scratch(name, x, k)
        lib = _ext.library()
        with torch.cuda.device(x.device):
            code = lib.gfs_knn_with_stats(
                x.data_ptr(), btab.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                scb.data_ptr(), _ext.ptr(scratch), b, n, c, cb, k,
                _ext.current_stream(x.device))
        _ext.check(code, name)
        return idx, cnt, scb

