"""K5: single-head attention with dropout on the weights, for training:
forward (K5a) and backward (K5b).

    P   = softmax((q / t) k^T)        normalised before dropout
    out = (keep * P / (1 - rate)) v

`attention_train` replaces the JAX package's TPU op
ops/attention_train.py::attention_train (its Pallas bodies `_fwd_kernel`
and `_bwd_kernel`) with an autograd Function around two CUDA kernels in
csrc/attention_train.cu. The forward saves the row max and denominator of
the softmax, (B, N) each, and its output; the backward recomputes P from
them, regenerates the dropout mask and takes Delta = rowsum(dy * out).

The mask is a counter-based hash of (seed, batch, query, key) that the
kernels compute in uint32 and `dropout_keep_mask` computes in int64 torch
arithmetic: both draw the same bits, whatever the tiling, so the kernels
are held to their plain twins exactly at any rate. `batch_offset` is
added to the batch index before hashing: a data-parallel rank holding rows
[o, o + B) of the global batch passes o and draws the single process's
mask for those rows (offset 0 is the mask of one process). It is not the TPU
kernel's stream (its in-core random bits cannot be reproduced), nor
flax's; the tests compare with JAX at rate 0 and check the mask's
statistics at rate > 0.

The kernels take any head width D (csrc/attention_train.cu: K5a and K5b
cover D <= 128 in one block on the tensor cores, in 3xTF32, and split the
channels over blocks on the fp32 pipe past that; K5a scales the scores by
1 / t on the products, as K5b recomputes them, so the saved m is the max
of the same products); a D that is not a multiple of 4 is zero-padded by
the stage wrappers (`pad_head`, exact: the padded columns add 0 to every
score and are sliced off the outputs; the temperature is the caller's).

Each device stage has a plain twin (`_fwd_plain`, `_bwd_plain`) that the
stage wrapper takes for a CPU tensor, so on the CPU the Function runs on the
twins. `attention_train_plain` is the whole composition under autograd, the
reference both are tested against.
"""
from __future__ import annotations

import math

import torch

from gfs3dseg_gws_tpu_torch.ops import _ext
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import pad_head
from gfs3dseg_gws_tpu_torch.utils.observability import span

MASK32 = 0xFFFFFFFF
_MIX1, _MIX2, _GOLDEN = 0x7FEB352D, 0x846CA68B, 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), with no int64 overflow:
    c is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The kernels' `mix32` (the lowbias32 finaliser) on int64 holding
    uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """thr = ceil(rate 2^24): an element is kept iff its hash's top 24 bits
    are >= thr, i.e. u = bits / 2^24 >= rate."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return math.ceil(rate * (1 << 24))


def dropout_keep_mask(seed, batch: int, n: int, rate: float,
                      device=None, batch_offset: int = 0) -> torch.Tensor:
    """The (batch, n, n) bool keep mask of `seed` (an int or a one-element
    integer tensor): h = mix(mix(mix(seed + b G) + i G) + j G), keep iff
    (h >> 8) >= keep_threshold(rate), as the kernels draw it, for the batch
    indices b = batch_offset .. batch_offset + batch - 1."""
    thr = keep_threshold(rate)
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        s = seed.reshape(-1)[:1].to(device=device, dtype=torch.int64)
    else:
        s = torch.tensor([int(seed)], dtype=torch.int64, device=device)
    s = s & MASK32
    b = torch.arange(batch_offset, batch_offset + batch, dtype=torch.int64,
                     device=s.device)
    cols = _mul32(torch.arange(n, dtype=torch.int64, device=s.device),
                  _GOLDEN)
    bkey = _mix32((s + _mul32(b, _GOLDEN)) & MASK32)              # (B,)
    rkey = _mix32((bkey[:, None] + cols[None, :]) & MASK32)       # (B, N)
    h = _mix32((rkey[:, :, None] + cols[None, None, :]) & MASK32)  # (B,N,N)
    return (h >> 8) >= thr


def attention_train_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          seed, temperature: float, rate: float,
                          batch_offset: int = 0) -> torch.Tensor:
    """The plain twin of the whole op, under autograd (JAX: the XLA
    composition of models/attention.py with the kernels' mask)."""
    attn = torch.einsum("bmc,bnc->bmn", q * (1.0 / temperature), k)
    attn = torch.softmax(attn, dim=-1)
    if rate > 0.0:
        keep = dropout_keep_mask(seed, q.shape[0], q.shape[1], rate,
                                 q.device, batch_offset)
        attn = torch.where(keep, attn * (1.0 / (1.0 - rate)),
                           torch.zeros_like(attn))
    return torch.einsum("bmn,bnc->bmc", attn, v)


# --------------------------------------------------------------------------- #
# K5a: the forward
# --------------------------------------------------------------------------- #

def _fwd_plain(q, k, v, seed, temperature: float, rate: float,
               batch_offset: int = 0):
    """Plain twin of K5a. Returns (out (B,N,D), m (B,N), den (B,N))."""
    s = torch.einsum("bmc,bnc->bmn", q * (1.0 / temperature), k)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.sum(p, dim=-1, keepdim=True)
    a = p * (1.0 / den)
    if rate > 0.0:
        keep = dropout_keep_mask(seed, q.shape[0], q.shape[1], rate,
                                 q.device, batch_offset)
        a = torch.where(keep, a * (1.0 / (1.0 - rate)), torch.zeros_like(a))
    return torch.einsum("bmn,bnc->bmc", a, v), m[..., 0], den[..., 0]


def _fwd(q, k, v, seed, temperature: float, rate: float,
         batch_offset: int = 0):
    """K5a on a CUDA tensor, its plain twin on a CPU tensor."""
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, seed, temperature, rate, batch_offset)
    with span("op.k5a"):
        name = "attention_train forward (K5a)"
        thr = _check(name, q, k, v, seed, rate, batch_offset)
        d_true = q.shape[-1]
        q, k, v = pad_head(q, k, v)
        b, n, d = q.shape
        out = torch.empty_like(q)
        m = torch.empty((b, n), device=q.device)
        den = torch.empty_like(m)
        lib = _ext.library()
        with torch.cuda.device(q.device):
            code = lib.gfs_attention_train_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seed.data_ptr(),
                out.data_ptr(), m.data_ptr(), den.data_ptr(), b, n, d,
                1.0 / temperature, thr, 1.0 / (1.0 - rate), batch_offset,
                _ext.current_stream(q.device))
        _ext.check(code, name)
        if d != d_true:
            out = out[..., :d_true].contiguous()
        return out, m, den


# --------------------------------------------------------------------------- #
# K5b: the backward
# --------------------------------------------------------------------------- #

def _bwd_plain(q, k, v, seed, m, den, delta, dy, temperature: float,
               rate: float, batch_offset: int = 0):
    """Plain twin of K5b: P from the saved m and den, the mask regenerated
    from the seed. Returns (dq, dk, dv)."""
    inv_t = 1.0 / temperature
    s = torch.einsum("bmc,bnc->bmn", q * inv_t, k)
    p = torch.exp(s - m[..., None]) * (1.0 / den[..., None])
    da = torch.einsum("bmc,bnc->bmn", dy, v)
    if rate > 0.0:
        keep = dropout_keep_mask(seed, q.shape[0], q.shape[1], rate,
                                 q.device, batch_offset)
        scale = 1.0 / (1.0 - rate)
        a = torch.where(keep, p * scale, torch.zeros_like(p))
        dp = torch.where(keep, da * scale, torch.zeros_like(da))
    else:
        a, dp = p, da
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bmn,bmc->bnc", a, dy)
    dq = torch.einsum("bmn,bnc->bmc", ds, k) * inv_t
    dk = torch.einsum("bmn,bmc->bnc", ds, q) * inv_t
    return dq, dk, dv


def _bwd(q, k, v, seed, m, den, delta, dy, temperature: float, rate: float,
         batch_offset: int = 0):
    """K5b on a CUDA tensor, its plain twin on a CPU tensor. dk and dv are
    summed in registers in a fixed order; dq is added across blocks with
    float atomics, so its last bits vary from run to run."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, seed, m, den, delta, dy, temperature,
                          rate, batch_offset)
    with span("op.k5b"):
        name = "attention_train backward (K5b)"
        thr = _check(name, q, k, v, seed, rate, batch_offset, dy=dy)
        d_true = q.shape[-1]
        q, k, v, dy = pad_head(q, k, v, dy)
        b, n, d = q.shape
        _ext.check_tensors(name, m=m, den=den, delta=delta)
        if m.shape != (b, n) or den.shape != (b, n) or delta.shape != (b, n):
            raise ValueError(f"{name}: m, den and delta must be (B, N) = "
                             f"{(b, n)}")
        dq = torch.zeros_like(q)
        dk = torch.empty_like(q)
        dv = torch.empty_like(q)
        lib = _ext.library()
        with torch.cuda.device(q.device):
            code = lib.gfs_attention_train_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seed.data_ptr(),
                m.data_ptr(), den.data_ptr(), delta.data_ptr(), dy.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, d,
                1.0 / temperature, thr, 1.0 / (1.0 - rate), batch_offset,
                _ext.current_stream(q.device))
        _ext.check(code, name)
        if d != d_true:
            dq, dk, dv = (t[..., :d_true].contiguous() for t in (dq, dk, dv))
        return dq, dk, dv


def _check(name, q, k, v, seed, rate, batch_offset, **more) -> int:
    """Raise unless the kernels take these inputs; returns the threshold."""
    _ext.check_tensors(name, q=q, k=k, v=v, **more)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape or any(
            t.shape != q.shape for t in more.values()):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must all be (B, N, D)")
    # (a D that is not a multiple of 4 gets padded, aligned copies)
    if q.shape[-1] % 4 == 0 and any(
            t.data_ptr() % 16 for t in (q, k, v, *more.values())):
        raise ValueError(f"{name}: q, k, v and dy must be 16-byte aligned")
    if (seed.dtype != torch.int32 or seed.numel() != 1
            or seed.device != q.device):
        raise ValueError(f"{name}: seed must be one int32 on {q.device}")
    if not 0 <= batch_offset < 2 ** 31:
        raise ValueError(f"{name}: batch_offset {batch_offset} must lie in "
                         "[0, 2^31)")
    return keep_threshold(rate)


# --------------------------------------------------------------------------- #
# the autograd Function
# --------------------------------------------------------------------------- #

class _AttentionTrain(torch.autograd.Function):
    """JAX: `_attn_train` with `_attn_vjp_fwd` / `_attn_vjp_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, seed, temperature, rate, batch_offset):
        out, m, den = _fwd(q, k, v, seed, temperature, rate, batch_offset)
        ctx.save_for_backward(q, k, v, seed, out, m, den)
        ctx.temperature, ctx.rate = temperature, rate
        ctx.batch_offset = batch_offset
        return out

    @staticmethod
    def backward(ctx, dy):
        q, k, v, seed, out, m, den = ctx.saved_tensors
        dy = dy.contiguous()
        delta = torch.sum(dy * out, dim=-1)         # = rowsum(dP * P)
        dq, dk, dv = _bwd(q, k, v, seed, m, den, delta, dy, ctx.temperature,
                          ctx.rate, ctx.batch_offset)
        return dq, dk, dv, None, None, None, None


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seed, temperature: float, rate: float = 0.1,
                    batch_offset: int = 0) -> torch.Tensor:
    """Dropout-softmax attention, (B, N, D) -> (B, N, D), differentiable in
    q, k and v.

    seed: the per-step dropout seed, an int or a one-element integer tensor
    (a device tensor keeps the step free of host synchronisation). On the
    CUDA device the stages run K5a and K5b (any D, contiguous fp32); on
    the CPU their plain twins. `batch_offset`: the global index of q's
    first row (a data-parallel rank's first row; the mask hashes
    batch + batch_offset).
    """
    keep_threshold(rate)
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([int(seed)], dtype=torch.int32)
    seed = seed.reshape(1).to(device=q.device, dtype=torch.int32)
    return _AttentionTrain.apply(q, k, v, seed, temperature, rate,
                                 int(batch_offset))
