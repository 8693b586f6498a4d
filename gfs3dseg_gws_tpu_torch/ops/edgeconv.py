"""Neighbour gather for EdgeConv, with K7 as its backward (counterpart of
the JAX package's ops/edgeconv.py::gather_neighbors).

The forward is one row gather over the flattened (B*N, C) table (XLA's
`take` in JAX, torch indexing here). Its backward is the scatter-add

    dx[b, j] = sum over (i, r) with idx[b, i, r] == j of g[b, i, r]

which replaces the JAX package's TPU kernel `_scatter_bwd_pallas` (body
`_scatter_bwd_kernel`) with K7, `edgeconv_scatter_kernel` in
csrc/edgeconv.cu (several edge rows in flight a warp, each added into dx
by float atomics, four channels an atomic where C % 4 == 0).
`scatter_bwd_plain` is its twin (`index_add_`, the
counterpart of `_scatter_bwd_xla`'s exact fp32 segment sum). The TPU
kernel's bf16 one-hot matmul is not carried over.

`gather_neighbors_plain` is the gather under autograd alone; the plain
twins of K1, K3 and K4 call it, never the Function.
"""
from __future__ import annotations

import torch

from gfs3dseg_gws_tpu_torch.ops import _ext
from gfs3dseg_gws_tpu_torch.utils.observability import span


def _flat_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """idx (B, N, K) -> row indices into the flattened (B*N, C) table."""
    offset = (torch.arange(idx.shape[0], device=idx.device) * n)[:, None, None]
    return (idx.long() + offset).reshape(-1)


def gather_neighbors_plain(x: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    """x (B, N, C) point features, idx (B, M, K) indices into the N axis ->
    (B, M, K, C) neighbour features (M = N, or a rank's own queries);
    autograd differentiates the indexing."""
    b, n, c = x.shape
    return x.reshape(b * n, c)[_flat_rows(idx, n)].reshape(*idx.shape, c)


def scatter_bwd_plain(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain twin of K7: g (B, N, K, C) summed onto the rows idx (B, N, K)
    names -> (B, N, C)."""
    b, n, k, c = g.shape
    out = torch.zeros((b * n, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, _flat_rows(idx, n), g.reshape(-1, c))
    return out.reshape(b, n, c)


def scatter_bwd(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K7 on a CUDA tensor, its plain twin on a CPU tensor.

    idx (B, N, K) contiguous int32, g (B, N, K, C) contiguous fp32 (any C;
    C % 4 == 0 adds 16-byte vectors, other C single floats). The kernel
    adds with float atomics, so the last bits of the result vary from run
    to run."""
    if g.device.type == "cpu":
        return scatter_bwd_plain(idx, g)
    with span("op.k7"):
        name = "gather_neighbors backward (K7)"
        _ext.check_tensors(name, g=g)
        b, n, k, c = g.shape
        if (idx.shape != (b, n, k) or idx.dtype != torch.int32
                or not idx.is_contiguous() or idx.device != g.device):
            raise ValueError(f"{name}: idx {tuple(idx.shape)} {idx.dtype} "
                             f"must be contiguous int32 (B, N, K) on g's "
                             f"device; g {tuple(g.shape)}")
        out = torch.zeros((b, n, c), device=g.device, dtype=torch.float32)
        lib = _ext.library()
        with torch.cuda.device(g.device):
            code = lib.gfs_edgeconv_scatter(idx.data_ptr(), g.data_ptr(),
                                            out.data_ptr(), b, n, k, c,
                                            _ext.current_stream(g.device))
        _ext.check(code, name)
        return out


class _GatherNeighbors(torch.autograd.Function):
    """JAX: the custom VJP `_gather_fwd` / `_gather_bwd`."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx.to(torch.int32).contiguous())
        return gather_neighbors_plain(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_bwd(idx, g.contiguous()), None


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather per-point neighbour features.

    Args:
      x:   (B, N, C) point features.
      idx: (B, M, K) indices into the N axis (int32 or int64); M = N, or
           in evaluation a rank's own queries under the `data x points`
           mesh.
    Returns:
      (B, M, K, C) neighbour features. The gradient with respect to x (M
      = N) is the scatter-add of K7 on the card, `scatter_bwd_plain` on
      the CPU. On the card the call is the span `op.gather`.
    """
    if x.device.type == "cpu":
        return _GatherNeighbors.apply(x, idx)
    with span("op.gather"):
        return _GatherNeighbors.apply(x, idx)
