"""K1: the fused eval-mode EdgeConv block (kNN + gather + two folded
conv/BN/LeakyReLU layers + max over the neighbours).

`fused_edgeconv_infer` replaces the JAX package's TPU kernel
ops/fused_edgeconv.py::fused_edgeconv_infer with the hand-written CUDA kernel
in csrc/fused_edgeconv.cu. `fused_edgeconv_plain` is the same function in
plain PyTorch (counterpart of `_fused_edgeconv_xla`); the wrapper takes it
for a tensor on the CPU, and the tests and chip_smoke.py hold the kernel
against it.

K9: `gather_conv` is K1's second stage on its own (`edge_mlp_kernel`, the
gather + edge layer + max from given indices), replacing the JAX package's
TPU kernel ops/fused_edgeconv.py::fused_edgeconv_infer_split (body
`_gather_conv_kernel`). `fused_edgeconv_infer_split` is K6 then K9: the same
two device functions as K1 launched apart, so on the card it equals
`fused_edgeconv_infer` bit for bit. As in JAX, no model path calls it.

On the card every entry takes any C, W0, W1 and 1 <= k <= N (the variants
are chosen by shape in csrc/fused_edgeconv.cu; k > N raises, as in JAX).
K1 also takes local queries (`q_offset`, the rows of b_table): the
neighbours of those rows among every row of x, for a rank of the
`data x points` mesh; K9 keeps one N for queries and keys.
"""
from __future__ import annotations

import torch

from gfs3dseg_gws_tpu_torch.ops import _ext
from gfs3dseg_gws_tpu_torch.ops.edgeconv import gather_neighbors_plain
from gfs3dseg_gws_tpu_torch.ops.knn import (_check_k, knn_indices,
                                            knn_indices_plain, query_rows)
from gfs3dseg_gws_tpu_torch.utils.observability import span


def fused_edgeconv_plain(x: torch.Tensor, a_table: torch.Tensor,
                         b_table: torch.Tensor, w2: torch.Tensor,
                         bias2: torch.Tensor, k: int,
                         neg_slope: float = 0.2,
                         q_offset: int = 0) -> torch.Tensor:
    """Plain composition: exact top-k of the b_table's rows (rows q_offset
    .. of x) among all of x, gather, layer 2, max over k."""
    idx = knn_indices_plain(x, k, q_offset, b_table.shape[1])
    return gather_conv_plain(idx, a_table, b_table, w2, bias2, neg_slope)


def gather_conv_plain(idx: torch.Tensor, a_table: torch.Tensor,
                      b_table: torch.Tensor, w2: torch.Tensor,
                      bias2: torch.Tensor,
                      neg_slope: float = 0.2) -> torch.Tensor:
    """Plain twin of K9: gather a[idx], add b, leaky, layer 2, leaky, max
    over the neighbours. idx and b_table may hold fewer rows than a_table
    (a rank's own queries)."""
    nbr = gather_neighbors_plain(a_table, idx)              # (B, N, K, W0)
    e = nbr + b_table[:, :, None, :]
    e = torch.where(e >= 0, e, neg_slope * e)
    l2 = torch.einsum("bnkc,cd->bnkd", e, w2) + bias2
    l2 = torch.where(l2 >= 0, l2, neg_slope * l2)
    return torch.amax(l2, dim=2)


def fused_edgeconv_infer(x: torch.Tensor, a_table: torch.Tensor,
                         b_table: torch.Tensor, w2: torch.Tensor,
                         bias2: torch.Tensor, k: int,
                         neg_slope: float = 0.2,
                         q_offset: int = 0) -> torch.Tensor:
    """Fused eval-mode EdgeConv block.

    Args:
      x:        (B, N, C) features the kNN graph is built on.
      a_table:  (B, N, W0) = scale1 * (x @ Wd)                 (neighbour term)
      b_table:  (B, nq, W0) = scale1 * (x_q @ (Wc - Wd)) + shift1 (centre
                term of the query rows x_q = x[:, q_offset:q_offset + nq]),
                where scale1/shift1 are the eval-mode BatchNorm affine.
      w2:       (W0, W1) layer-2 kernel pre-scaled by BatchNorm2's scale.
      bias2:    (W1,) BatchNorm2 shift.
      k:        neighbours per point, self included (1 <= k <= N).
      q_offset: the first query row (0 with nq = N: every point; a rank of
                the `data x points` mesh passes its own rows against the
                block's all-gathered x).
    Returns:
      (B, nq, W1) max-pooled EdgeConv output of the query rows, float32;
      the rows of the call over every point, bit for bit.

    A CPU tensor goes to `fused_edgeconv_plain`; a CUDA tensor to the
    kernel, which raises on shapes or dtypes it does not take.
    """
    if x.device.type == "cpu":
        return fused_edgeconv_plain(x, a_table, b_table, w2, bias2, k,
                                    neg_slope, q_offset)
    with span("op.k1"):
        name = "fused_edgeconv_infer"
        _ext.check_tensors(name, x=x, a_table=a_table, b_table=b_table, w2=w2,
                           bias2=bias2)
        b, n, c = x.shape
        nq = b_table.shape[1]
        w0, w1 = w2.shape
        _check_tables(name, (b, n), a_table, b_table, w2, bias2, nq)
        _check_k(name, k, n)
        query_rows(name, n, q_offset, nq)
        out = torch.empty((b, nq, w1), device=x.device, dtype=torch.float32)
        idx = torch.empty((b, nq, k), device=x.device, dtype=torch.int32)
        scratch = _ext.knn_scratch(name, x, k, nq=nq)
        lib = _ext.library()
        with torch.cuda.device(x.device):
            code = lib.gfs_fused_edgeconv_infer(
                x.data_ptr(), a_table.data_ptr(), b_table.data_ptr(),
                w2.data_ptr(), bias2.data_ptr(), idx.data_ptr(),
                _ext.ptr(scratch), out.data_ptr(), b, n, nq, q_offset, c, w0,
                w1, k, neg_slope, _ext.current_stream(x.device))
        _ext.check(code, name)
        return out


def _check_tables(name, bn, a_table, b_table, w2, bias2, nq=None):
    """a_table (B, N, W0), b_table (B, nq, W0) (nq None: N), bias2 (W1,)."""
    w0, w1 = w2.shape
    rows = bn[1] if nq is None else nq
    if (a_table.shape != (*bn, w0) or b_table.shape != (bn[0], rows, w0)
            or bias2.shape != (w1,)):
        raise ValueError(
            f"{name}: shapes (B, N) {tuple(bn)}, a_table "
            f"{tuple(a_table.shape)}, b_table {tuple(b_table.shape)}, w2 "
            f"{tuple(w2.shape)}, bias2 {tuple(bias2.shape)} do not agree")


def gather_conv(idx: torch.Tensor, a_table: torch.Tensor,
                b_table: torch.Tensor, w2: torch.Tensor, bias2: torch.Tensor,
                neg_slope: float = 0.2) -> torch.Tensor:
    """K9: the eval EdgeConv's edge layer and max from given indices.

    Args:
      idx: (B, N, k) int32 neighbour indices (contiguous on CUDA).
      a_table, b_table, w2, bias2: as for `fused_edgeconv_infer`.
    Returns:
      (B, N, W1) float32.

    A CPU tensor goes to `gather_conv_plain`; a CUDA tensor to the kernel
    (any W0, W1; 1 <= k <= N).
    """
    if a_table.device.type == "cpu":
        return gather_conv_plain(idx, a_table, b_table, w2, bias2, neg_slope)
    with span("op.k9"):
        name = "gather_conv"
        _ext.check_tensors(name, a_table=a_table, b_table=b_table, w2=w2,
                           bias2=bias2)
        b, n, k = idx.shape
        w0, w1 = w2.shape
        _check_tables(name, (b, n), a_table, b_table, w2, bias2)
        if (idx.dtype != torch.int32 or not idx.is_contiguous()
                or idx.device != a_table.device):
            raise ValueError(f"{name}: idx must be contiguous int32 on the "
                             f"tables' device, got {idx.dtype} on "
                             f"{idx.device}")
        _check_k(name, k, n)
        out = torch.empty((b, n, w1), device=idx.device, dtype=torch.float32)
        lib = _ext.library()
        with torch.cuda.device(idx.device):
            code = lib.gfs_gather_conv(
                idx.data_ptr(), a_table.data_ptr(), b_table.data_ptr(),
                w2.data_ptr(), bias2.data_ptr(), out.data_ptr(), b, n, w0, w1,
                k, neg_slope, _ext.current_stream(idx.device))
        _ext.check(code, name)
        return out


def fused_edgeconv_infer_split(x: torch.Tensor, a_table: torch.Tensor,
                               b_table: torch.Tensor, w2: torch.Tensor,
                               bias2: torch.Tensor, k: int,
                               neg_slope: float = 0.2) -> torch.Tensor:
    """`fused_edgeconv_infer` as two calls: K6 (`knn_indices`) then K9
    (`gather_conv`). Same arguments and result."""
    return gather_conv(knn_indices(x, k), a_table, b_table, w2, bias2,
                       neg_slope)
