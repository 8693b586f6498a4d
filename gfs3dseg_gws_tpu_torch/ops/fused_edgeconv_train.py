"""K4: the fused train-mode EdgeConv block, forward (K4a) and backward (K4b).

Per block, with train-mode BatchNorm (statistics over all B*N*K edges):

    e0  = a[idx] + b[:, :, None]           # (B, N, K, C) edge tensor
    h1  = leaky(bn1_batch(e0))
    z1  = h1 @ W2
    out = max_k leaky(bn2_batch(z1))

`fused_edgeconv_train` replaces the JAX package's TPU op
ops/fused_edgeconv_train.py::fused_edgeconv_train (its Pallas bodies
`_gsf_kernel` and `_bwd_kernel`) with an autograd Function around two CUDA
kernels in csrc/fused_edgeconv_train.cu, with the same closed-form algebra:

* the bn1 statistics come from the kNN kernel's in-degrees `cnt` and
  transposed b-scatter `scb` before any gather (sum_edges a_j = sum_j
  cnt_j a_j, sum_edges a_j b_i = sum_j a_j scb_j);
* K4a (`_gsf`) gathers a[idx] once, forms h1 and z1 = h1 @ W2 per edge and
  reduces sum(h1), the Gram matrix h1^T h1 (the bn2 statistics follow as
  E[z1] = E[h1] W2, E[z1^2] = diag(W2^T E[h1 h1^T] W2)), the running
  max/min of z1 over k with their slots, and sum_k a[idx]; for C, W1 <= 64
  it takes z1 and the Gram matrix on the tensor cores in 3xTF32, past
  that it reduces sum z1 and sum z1^2 per column instead of the C x C
  Gram, in fp32;
* bn2 + leaky is monotone per channel, so the block output is the max or
  the min of z1 by the sign of the bn2 scale, selected here in torch;
* K4b (`_bwd`) re-gathers a[idx] (no (B, N, K, C) residual is stored),
  recomputes e0/h1/z1 (z1 in 3xTF32 for C, W1 <= 64) and reduces dW2,
  the two bn1 sums and sum_k g1 * dy1 per point, and scatters
  [g1 * dy1 | yhat1] onto the neighbour rows; da and db are assembled
  here in closed form.

On the card the stages take any C, W1 and 1 <= k <= N: past C, W1 <= 64
the kernels tile W1 (and, in K4b, C) over a grid axis, and the partial
sums of the tiles are added here. Each device stage has a plain twin
(`_gsf_plain`, `_bwd_plain`) that the stage wrapper takes for a CPU
tensor, so on the CPU the Function runs all of its glue on the twins.
`fused_edgeconv_train_plain` is the unfused composition under autograd
(JAX: fused_edgeconv_train_xla), the reference both are tested against.

With a mesh (parallel/mesh.py) each rank holds its rows of the global batch
and the Function normalises with the global statistics: four all-reduces
between the kernel launches, none inside a kernel. Forward: the bn1 sums
before s1/t1 (they feed K4a) and K4a's `stats` before the bn2 moments;
backward: the two sums behind c1/c2 before K4b (pk feeds it) and K4b's
bn1 sums before gd1/gd2. The gradients of the BN scales and shifts stay
this rank's local parts, as every other parameter's: the caller's
gradient all-reduce (`allreduce_grads`) sums them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from gfs3dseg_gws_tpu_torch.ops import _ext
from gfs3dseg_gws_tpu_torch.ops.edgeconv import gather_neighbors_plain
from gfs3dseg_gws_tpu_torch.ops.knn import neighbor_stats_plain
from gfs3dseg_gws_tpu_torch.parallel.mesh import all_reduce_sum
from gfs3dseg_gws_tpu_torch.utils.observability import span

EPS = 1e-5  # torch BatchNorm eps


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _affines(gamma, beta, mu, var):
    inv = torch.rsqrt(var + EPS)
    s = gamma * inv
    return s, beta - mu * s, inv


# --------------------------------------------------------------------------- #
# the unfused reference (autograd)
# --------------------------------------------------------------------------- #

def fused_edgeconv_train_plain(a, b, gamma1, beta1, w2, gamma2, beta2, idx,
                               neg_slope: float = 0.2):
    """Unfused train-mode composition with the same semantics; it builds
    the (B, N, K, C) edge tensor. Returns (out, mu1, var1, mu2, var2)."""
    h2, *stats = train_plain_edges(a, b, gamma1, beta1, w2, gamma2, beta2,
                                   idx, neg_slope)
    return (torch.amax(h2, dim=2), *stats)


def train_plain_edges(a, b, gamma1, beta1, w2, gamma2, beta2, idx,
                      neg_slope: float = 0.2):
    """`fused_edgeconv_train_plain` before its max over the neighbours:
    (leaky(bn2(z1)) (B, N, K, W1), mu1, var1, mu2, var2)."""

    def bn(x, gamma, beta):
        axes = tuple(range(x.dim() - 1))
        mu = torch.mean(x, axes)
        var = torch.clamp_min(torch.mean(x * x, axes) - mu * mu, 0.0)
        return (x - mu) * (torch.rsqrt(var + EPS) * gamma) + beta, mu, var

    e0 = gather_neighbors_plain(a, idx) + b[:, :, None, :]
    y1, mu1, var1 = bn(e0, gamma1, beta1)
    z1 = torch.einsum("bnkc,cd->bnkd", _leaky(y1, neg_slope), w2)
    y2, mu2, var2 = bn(z1, gamma2, beta2)
    return (_leaky(y2, neg_slope), mu1.detach(), var1.detach(),
            mu2.detach(), var2.detach())


# --------------------------------------------------------------------------- #
# K4a: the one gather pass of the forward
# --------------------------------------------------------------------------- #

def _wide(c: int, w1: int) -> bool:
    """Whether K4a/K4b take their tiled variants (csrc: is_wide)."""
    return c > 64 or w1 > 64


def _bn2_moments(stats, w2, e):
    """E[z1] and E[z1^2] over the e edges from K4a's `stats`: [sum h1 (C) |
    Gram h1^T h1 (C x C)] for C, W1 <= 64, where E[z1] = E[h1] W2 and
    E[z1^2] = diag(W2^T E[h1 h1^T] W2); past that [sum z1 | sum z1^2]
    (W1 each)."""
    c, w1 = w2.shape
    if _wide(c, w1):
        return stats[:w1] / e, stats[w1:] / e
    return ((stats[:c] / e) @ w2,
            torch.einsum("cd,ce,ed->d", w2, stats[c:].reshape(c, c) / e, w2))


def _z1(h1, w2):
    """z1 = h1 @ W2 on every edge (B, N, K, W1) in fp32: the twins' product
    (K4a's and K4b's kernels take it on the tensor cores in 3xTF32 for C,
    W1 <= 64, tests/test_torch_port_split_tf32.py rehearses that here)."""
    return torch.einsum("bnkc,cd->bnkd", h1, w2)


def _gram(h1):
    """The Gram matrix h1^T h1 over every edge (C, C) in fp32: the twin's
    product (K4a's kernel takes it on the tensor cores in 3xTF32 for C,
    W1 <= 64, tests/test_torch_port_split_tf32.py rehearses that here)."""
    return torch.einsum("bnkc,bnkd->cd", h1, h1)


def _gsf_plain(a, b, idx, s1, t1, w2, neg_slope):
    """Plain twin of K4a. Returns (snbr (B,N,C), zmax, zmin (B,N,W1),
    kmax, kmin (B,N,W1) int32, stats): the sums over the B N K edges the
    bn2 statistics come from, in K4a's layout for these widths
    (`_bn2_moments`)."""
    nbr = gather_neighbors_plain(a, idx)                      # (B,N,K,C)
    h1 = _leaky((nbr + b[:, :, None, :]) * s1 + t1, neg_slope)
    z1 = _z1(h1, w2)
    zmax, kmax = torch.max(z1, dim=2)
    zmin, kmin = torch.min(z1, dim=2)
    if _wide(*w2.shape):
        stats = torch.cat([z1.sum((0, 1, 2)), (z1 * z1).sum((0, 1, 2))])
    else:
        stats = torch.cat([h1.sum((0, 1, 2)), _gram(h1).reshape(-1)])
    return (nbr.sum(2), zmax, zmin, kmax.to(torch.int32),
            kmin.to(torch.int32), stats)


def _gsf(a, b, idx, s1, t1, w2, neg_slope):
    """K4a on a CUDA tensor, its plain twin on a CPU tensor.

    The Gram matrix and sum(h1) (past C, W1 <= 64: sum z1 and sum z1^2) are
    reduced per block into a buffer of partials that is then summed here:
    a fixed order, so the forward statistics are the same from run to
    run."""
    if a.device.type == "cpu":
        return _gsf_plain(a, b, idx, s1, t1, w2, neg_slope)
    with span("op.k4a"):
        name = "fused_edgeconv_train forward (K4a)"
        _ext.check_tensors(name, a=a, b=b, s1=s1, t1=t1, w2=w2)
        bsz, n, c = a.shape
        w1 = w2.shape[1]
        k = idx.shape[-1]
        _check_shapes(name, a, b, idx, w2)
        tiles = (n + 63) // 64
        wide = _wide(c, w1)
        snbr = torch.zeros_like(a) if wide else torch.empty_like(a)
        zmax = torch.empty((bsz, n, w1), device=a.device)
        zmin = torch.empty_like(zmax)
        kmax = torch.empty((bsz, n, w1), device=a.device, dtype=torch.int32)
        kmin = torch.empty_like(kmax)
        part = torch.empty((bsz * tiles, 2 * w1 if wide else c + c * c),
                           device=a.device)
        lib = _ext.library()
        with torch.cuda.device(a.device):
            code = lib.gfs_edgeconv_train_fwd(
                a.data_ptr(), b.data_ptr(), idx.data_ptr(), s1.data_ptr(),
                t1.data_ptr(), w2.data_ptr(), snbr.data_ptr(), zmax.data_ptr(),
                zmin.data_ptr(), kmax.data_ptr(), kmin.data_ptr(),
                part.data_ptr(), bsz, n, c, w1, k, neg_slope,
                _ext.current_stream(a.device))
        _ext.check(code, name)
        return snbr, zmax, zmin, kmax, kmin, part.sum(0)


# --------------------------------------------------------------------------- #
# K4b: the gather-free backward (re-gathers a[idx] from L2)
# --------------------------------------------------------------------------- #

def _bwd_plain(a, b, idx, p1, w2, gsel, ksel, pk, neg_slope):
    """Plain twin of K4b. p1 = [s1, t1, mu1, inv1, g1s] (5, C), pk = [g2s,
    c1, c2, mu2, inv2] (5, W1). Returns (scat (B,N,2C), psum (B,N,C),
    dw2 (C,W1), sums (2,C)). LeakyReLU's derivative takes its branch from
    the exact sign of the bn1 pre-activation, as the kernel does."""
    s1, t1, mu1, inv1, g1s = p1
    g2s, c1, c2, mu2, inv2 = pk
    k = idx.shape[-1]
    e0 = gather_neighbors_plain(a, idx) + b[:, :, None, :]
    pre1 = e0 * s1 + t1
    h1 = _leaky(pre1, neg_slope)
    z1 = _z1(h1, w2)
    slot = torch.arange(k, device=a.device)[None, None, :, None]
    dy2 = torch.where(ksel[:, :, None, :] == slot, gsel[:, :, None, :], 0.0)
    dz1 = g2s * (dy2 - c1 - (z1 - mu2) * inv2 * c2)
    dh1 = torch.einsum("bnkd,cd->bnkc", dz1, w2)
    # LeakyReLU's branch by the exact sign of e0 s1 + t1, as K4b's fmaf
    # rounds it: the two roundings of pre1 can give a pre-activation within
    # an ulp of 0 the other sign
    pos = e0.double() * s1.double() + t1.double() >= 0
    dy1 = torch.where(pos, dh1, neg_slope * dh1)
    y1hat = (e0 - mu1) * inv1
    gdy1 = g1s * dy1
    bsz, n, _, c = e0.shape
    flat = idx.reshape(bsz, n * k, 1).long().expand(bsz, n * k, 2 * c)
    scat = torch.zeros((bsz, n, 2 * c), dtype=a.dtype, device=a.device)
    scat.scatter_add_(1, flat, torch.cat([gdy1, y1hat], -1).reshape(
        bsz, n * k, 2 * c))
    sums = torch.stack([dy1.sum((0, 1, 2)), (dy1 * y1hat).sum((0, 1, 2))])
    return (scat, gdy1.sum(2), torch.einsum("bnkc,bnkd->cd", h1, dz1),
            sums)


def _bwd(a, b, idx, p1, w2, gsel, ksel, pk, neg_slope):
    """K4b on a CUDA tensor, its plain twin on a CPU tensor. dW2 and the
    bn1 sums are reduced per block and summed here (fixed order); `scat`
    is added with float atomics, so its last bits vary from run to run."""
    if a.device.type == "cpu":
        return _bwd_plain(a, b, idx, p1, w2, gsel, ksel, pk, neg_slope)
    with span("op.k4b"):
        name = "fused_edgeconv_train backward (K4b)"
        _ext.check_tensors(name, a=a, b=b, p1=p1, w2=w2, gsel=gsel, pk=pk)
        bsz, n, c = a.shape
        w1 = w2.shape[1]
        k = idx.shape[-1]
        _check_shapes(name, a, b, idx, w2)
        if (ksel.dtype != torch.int32 or not ksel.is_contiguous()
                or ksel.shape != (bsz, n, w1) or gsel.shape != (bsz, n, w1)):
            raise ValueError(f"{name}: gsel/ksel must be (B, N, W1), ksel "
                             "contiguous int32")
        tiles = (n + 63) // 64
        # past C, W1 <= 64 each of the OT column tiles leaves its own psum and
        # bn1 sums, added below
        n_ot = -(-w1 // 64) if _wide(c, w1) else 1
        scat = torch.zeros((bsz, n, 2 * c), device=a.device)
        psum = torch.empty((n_ot, bsz, n, c), device=a.device)
        part = torch.empty((bsz * tiles, c * w1 + n_ot * 2 * c),
                           device=a.device)
        lib = _ext.library()
        with torch.cuda.device(a.device):
            code = lib.gfs_edgeconv_train_bwd(
                a.data_ptr(), b.data_ptr(), idx.data_ptr(), p1.data_ptr(),
                w2.data_ptr(), gsel.data_ptr(), ksel.data_ptr(), pk.data_ptr(),
                scat.data_ptr(), psum.data_ptr(), part.data_ptr(), bsz, n, c,
                w1, k, neg_slope, _ext.current_stream(a.device))
        _ext.check(code, name)
        tot = part.sum(0)
        sums = tot[c * w1:].reshape(n_ot, 2, c)
        return (scat, psum[0] if n_ot == 1 else psum.sum(0),
                tot[:c * w1].reshape(c, w1),
                sums[0] if n_ot == 1 else sums.sum(0))


def _check_shapes(name, a, b, idx, w2):
    bsz, n, c = a.shape
    w1 = w2.shape[1]
    k = idx.shape[-1]
    if (b.shape != a.shape or w2.shape[0] != c or idx.shape[:2] != (bsz, n)
            or idx.dtype != torch.int32 or not idx.is_contiguous()
            or idx.device != a.device):
        raise ValueError(
            f"{name}: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, w2 "
            f"{tuple(w2.shape)}, idx {tuple(idx.shape)} {idx.dtype} do not "
            "agree (idx: contiguous int32 on the tables' device)")
    if not 1 <= k <= n:
        raise ValueError(f"{name}: k must lie in [1, N]; got k={k}, N={n}")
    if k > 65535:
        raise ValueError(f"{name}: the kernels keep a neighbour's slot in 16 "
                         f"bits (k <= 65535); got k={k}")


# --------------------------------------------------------------------------- #
# the autograd Function
# --------------------------------------------------------------------------- #

class _FusedEdgeConvTrain(torch.autograd.Function):
    """JAX: `_fused_train` with `_vjp_fwd` / `_vjp_bwd`."""

    @staticmethod
    def forward(ctx, a, b, gamma1, beta1, w2, gamma2, beta2, idx, cnt, scb,
                neg_slope, mesh):
        w2 = w2.contiguous()
        bsz, n, _ = a.shape
        k = idx.shape[-1]
        e = bsz * n * k * (1 if mesh is None else mesh.size)   # global edges
        cnt0 = cnt[:, 0]
        # e0 batch statistics before any gather
        sum_e0 = torch.einsum("bn,bnc->c", cnt0, a) + k * b.sum((0, 1))
        sum_e02 = (torch.einsum("bn,bnc->c", cnt0, a * a)
                   + 2.0 * torch.einsum("bnc,bnc->c", scb, a)
                   + k * (b * b).sum((0, 1)))
        if mesh is not None:
            sum_e0, sum_e02 = all_reduce_sum(torch.stack([sum_e0, sum_e02]),
                                             mesh)
        mu1 = sum_e0 / e
        var1 = torch.clamp_min(sum_e02 / e - mu1 * mu1, 0.0)
        s1, t1, _ = _affines(gamma1, beta1, mu1, var1)

        snbr, zmax, zmin, kmax, kmin, stats = _gsf(
            a, b, idx, s1.contiguous(), t1.contiguous(), w2, neg_slope)
        stats = all_reduce_sum(stats, mesh)
        mu2, ez2 = _bn2_moments(stats, w2, e)
        var2 = torch.clamp_min(ez2 - mu2 * mu2, 0.0)
        s2a, t2, _ = _affines(gamma2, beta2, mu2, var2)

        pos = s2a > 0
        z1sel = torch.where(pos, zmax, zmin)
        ksel = torch.where(pos, kmax, kmin)
        out = _leaky(z1sel * s2a + t2, neg_slope)
        ctx.save_for_backward(a, b, idx, w2, gamma1, beta1, gamma2, mu1,
                              var1, mu2, var2, z1sel, ksel, out, snbr, cnt)
        ctx.neg_slope, ctx.mesh = neg_slope, mesh
        ctx.mark_non_differentiable(mu1, var1, mu2, var2)
        return out, mu1, var1, mu2, var2

    @staticmethod
    def backward(ctx, gout, *_stat_cotangents):
        (a, b, idx, w2, g1, beta1, g2, mu1, var1, mu2, var2, z1sel, ksel,
         out, snbr, cnt) = ctx.saved_tensors
        slope, mesh = ctx.neg_slope, ctx.mesh
        bsz, n, c = a.shape
        k = idx.shape[-1]
        e = bsz * n * k * (1 if mesh is None else mesh.size)   # global edges

        s1, t1, inv1 = _affines(g1, beta1, mu1, var1)
        inv2 = torch.rsqrt(var2 + EPS)
        g2s = g2 * inv2
        g1s = g1 * inv1
        gsel = torch.where(out >= 0, gout, slope * gout).contiguous()
        # this rank's sums: the gradients of beta2 and gamma2
        dbeta2 = gsel.sum((0, 1))
        dgamma2 = (gsel * (z1sel - mu2) * inv2).sum((0, 1))
        if mesh is None:
            c1, c2 = dbeta2 / e, dgamma2 / e
            dbeta2, dgamma2 = c1 * e, c2 * e    # as one process always had
        else:
            c1, c2 = all_reduce_sum(torch.stack([dbeta2, dgamma2]), mesh) / e

        p1 = torch.stack([s1, t1, mu1, inv1, g1s]).contiguous()
        pk = torch.stack([g2s, c1, c2, mu2, inv2]).contiguous()
        scat, psum, dw2, sums = _bwd(a, b, idx, p1, w2, gsel,
                                     ksel.contiguous(), pk, slope)
        # sums (this rank's): the gradients of beta1 and gamma1
        tot = all_reduce_sum(sums, mesh)
        gd1 = g1s * tot[0] / e
        gd2 = g1s * tot[1] / e
        da = scat[..., :c] - gd1 * cnt[:, 0, :, None] - gd2 * scat[..., c:]
        db = psum - k * gd1 - gd2 * ((snbr + k * b - k * mu1) * inv1)
        return (da, db, sums[1], sums[0], dw2, dgamma2, dbeta2, None, None,
                None, None, None)


def fused_edgeconv_train(a, b, gamma1, beta1, w2, gamma2, beta2, idx,
                         cnt=None, scb=None, neg_slope: float = 0.2,
                         mesh=None) -> Tuple[torch.Tensor, ...]:
    """Fused train-mode EdgeConv block.

    Args:
      a:      (B, N, C) neighbour-term table  x @ Wd.
      b:      (B, N, C) centre-term table     x @ (Wc - Wd).
      gamma1/beta1: (C,) bn1 scale/shift; w2: (C, W1); gamma2/beta2: (W1,).
      idx:    (B, N, K) int32 kNN indices.
      cnt/scb: the neighbour statistics of `ops.knn.knn_with_stats`
        (in-degrees (B, 1, N), transposed b-scatter (B, N, C)); computed
        from idx and b when omitted. They carry no gradient.
    Returns:
      (out (B, N, W1), mu1, var1, mu2, var2); the batch statistics are for
      the running averages and carry no gradient.

    On the CUDA device the stages run K4a and K4b (any C and W1,
    1 <= k <= N); on the CPU their plain twins. Ties in the max over k send the gradient
    to the first slot. With a `mesh` (parallel/mesh.py) the tables hold this
    rank's rows and the statistics are the global batch's.
    """
    if cnt is None or scb is None:
        cnt, scb = neighbor_stats_plain(idx, b.detach())
    return _FusedEdgeConvTrain.apply(a, b, gamma1, beta1, w2, gamma2, beta2,
                                     idx, cnt.detach(), scb.detach(),
                                     neg_slope, mesh)
