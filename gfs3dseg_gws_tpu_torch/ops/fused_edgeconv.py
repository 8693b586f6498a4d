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
"""
from __future__ import annotations

import torch

from gfs3dseg_gws_tpu_torch.ops import _ext
from gfs3dseg_gws_tpu_torch.ops.edgeconv import gather_neighbors_plain
from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices, knn_indices_plain


def fused_edgeconv_plain(x: torch.Tensor, a_table: torch.Tensor,
                         b_table: torch.Tensor, w2: torch.Tensor,
                         bias2: torch.Tensor, k: int,
                         neg_slope: float = 0.2) -> torch.Tensor:
    """Plain composition: exact top-k, gather, layer 2, max over k."""
    return gather_conv_plain(knn_indices_plain(x, k), a_table, b_table, w2,
                             bias2, neg_slope)


def gather_conv_plain(idx: torch.Tensor, a_table: torch.Tensor,
                      b_table: torch.Tensor, w2: torch.Tensor,
                      bias2: torch.Tensor,
                      neg_slope: float = 0.2) -> torch.Tensor:
    """Plain twin of K9: gather a[idx], add b, leaky, layer 2, leaky, max
    over the neighbours."""
    nbr = gather_neighbors_plain(a_table, idx)              # (B, N, K, W0)
    e = nbr + b_table[:, :, None, :]
    e = torch.where(e >= 0, e, neg_slope * e)
    l2 = torch.einsum("bnkc,cd->bnkd", e, w2) + bias2
    l2 = torch.where(l2 >= 0, l2, neg_slope * l2)
    return torch.amax(l2, dim=2)


def fused_edgeconv_infer(x: torch.Tensor, a_table: torch.Tensor,
                         b_table: torch.Tensor, w2: torch.Tensor,
                         bias2: torch.Tensor, k: int,
                         neg_slope: float = 0.2) -> torch.Tensor:
    """Fused eval-mode EdgeConv block.

    Args:
      x:        (B, N, C) features the kNN graph is built on (C <= 64).
      a_table:  (B, N, W0) = scale1 * (x @ Wd)                 (neighbour term)
      b_table:  (B, N, W0) = scale1 * (x @ (Wc - Wd)) + shift1 (centre term)
                where scale1/shift1 are the eval-mode BatchNorm affine.
      w2:       (W0, W1) layer-2 kernel pre-scaled by BatchNorm2's scale.
      bias2:    (W1,) BatchNorm2 shift.
      k:        neighbours per point, self included (k <= 32 on CUDA).
    Returns:
      (B, N, W1) max-pooled EdgeConv output, float32.

    A CPU tensor goes to `fused_edgeconv_plain`; a CUDA tensor to the
    kernel, which raises on shapes or dtypes it does not take.
    """
    if x.device.type == "cpu":
        return fused_edgeconv_plain(x, a_table, b_table, w2, bias2, k,
                                    neg_slope)
    name = "fused_edgeconv_infer"
    _ext.check_tensors(name, x=x, a_table=a_table, b_table=b_table, w2=w2,
                       bias2=bias2)
    b, n, c = x.shape
    w0, w1 = w2.shape
    _check_tables(name, (b, n), a_table, b_table, w2, bias2)
    if c > 64 or w0 > 64 or w1 > 64 or not 1 <= k <= min(n, 32):
        raise ValueError(f"{name}: the kernel takes C, W0, W1 <= 64 and "
                         f"1 <= k <= min(N, 32); got C={c}, W0={w0}, "
                         f"W1={w1}, k={k}, N={n}")
    out = torch.empty((b, n, w1), device=x.device, dtype=torch.float32)
    idx = torch.empty((b, n, k), device=x.device, dtype=torch.int32)
    lib = _ext.library()
    with torch.cuda.device(x.device):
        code = lib.gfs_fused_edgeconv_infer(
            x.data_ptr(), a_table.data_ptr(), b_table.data_ptr(),
            w2.data_ptr(), bias2.data_ptr(), idx.data_ptr(), out.data_ptr(),
            b, n, c, w0, w1, k, neg_slope, _ext.current_stream(x.device))
    _ext.check(code, name)
    fused_edgeconv_infer.launches += 1
    return out


fused_edgeconv_infer.launches = 0


def _check_tables(name, bn, a_table, b_table, w2, bias2):
    w0, w1 = w2.shape
    if (a_table.shape != (*bn, w0) or b_table.shape != (*bn, w0)
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
    (W0, W1 <= 64, 1 <= k <= min(N, 32); anything else raises).
    """
    if a_table.device.type == "cpu":
        return gather_conv_plain(idx, a_table, b_table, w2, bias2, neg_slope)
    name = "gather_conv"
    _ext.check_tensors(name, a_table=a_table, b_table=b_table, w2=w2,
                       bias2=bias2)
    b, n, k = idx.shape
    w0, w1 = w2.shape
    _check_tables(name, (b, n), a_table, b_table, w2, bias2)
    if (idx.dtype != torch.int32 or not idx.is_contiguous()
            or idx.device != a_table.device):
        raise ValueError(f"{name}: idx must be contiguous int32 on the "
                         f"tables' device, got {idx.dtype} on {idx.device}")
    if w0 > 64 or w1 > 64 or not 1 <= k <= min(n, 32):
        raise ValueError(f"{name}: the kernel takes W0, W1 <= 64 and "
                         f"1 <= k <= min(N, 32); got W0={w0}, W1={w1}, "
                         f"k={k}, N={n}")
    out = torch.empty((b, n, w1), device=idx.device, dtype=torch.float32)
    lib = _ext.library()
    with torch.cuda.device(idx.device):
        code = lib.gfs_gather_conv(
            idx.data_ptr(), a_table.data_ptr(), b_table.data_ptr(),
            w2.data_ptr(), bias2.data_ptr(), out.data_ptr(), b, n, w0, w1, k,
            neg_slope, _ext.current_stream(idx.device))
    _ext.check(code, name)
    gather_conv.launches += 1
    return out


gather_conv.launches = 0


def fused_edgeconv_infer_split(x: torch.Tensor, a_table: torch.Tensor,
                               b_table: torch.Tensor, w2: torch.Tensor,
                               bias2: torch.Tensor, k: int,
                               neg_slope: float = 0.2) -> torch.Tensor:
    """`fused_edgeconv_infer` as two calls: K6 (`knn_indices`) then K9
    (`gather_conv`). Same arguments and result."""
    return gather_conv(knn_indices(x, k), a_table, b_table, w2, bias2,
                       neg_slope)
