"""K1: the fused eval-mode EdgeConv block (kNN + gather + two folded
conv/BN/LeakyReLU layers + max over the neighbours).

`fused_edgeconv_infer` replaces the JAX package's TPU kernel
ops/fused_edgeconv.py::fused_edgeconv_infer with the hand-written CUDA kernel
in csrc/fused_edgeconv.cu. `fused_edgeconv_plain` is the same function in
plain PyTorch (counterpart of `_fused_edgeconv_xla`); the wrapper takes it
for a tensor on the CPU, and the tests and chip_smoke.py hold the kernel
against it.
"""
from __future__ import annotations

import torch

from gfs3dseg_gws_tpu_torch.ops import _ext
from gfs3dseg_gws_tpu_torch.ops.edgeconv import gather_neighbors
from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices


def fused_edgeconv_plain(x: torch.Tensor, a_table: torch.Tensor,
                         b_table: torch.Tensor, w2: torch.Tensor,
                         bias2: torch.Tensor, k: int,
                         neg_slope: float = 0.2) -> torch.Tensor:
    """Plain composition: exact top-k, gather, layer 2, max over k."""
    idx = knn_indices(x, k)
    nbr = gather_neighbors(a_table, idx)                    # (B, N, K, W0)
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
    if (a_table.shape != (b, n, w0) or b_table.shape != (b, n, w0)
            or bias2.shape != (w1,)):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, a_table "
            f"{tuple(a_table.shape)}, b_table {tuple(b_table.shape)}, w2 "
            f"{tuple(w2.shape)}, bias2 {tuple(bias2.shape)} do not agree")
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
