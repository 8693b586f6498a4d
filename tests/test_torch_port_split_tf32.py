"""The 3xTF32 numerics of K2 and K5b, rehearsed on the CPU.

K2 (csrc/attention.cu) and K5b (csrc/attention_train.cu) run their
products on the tensor cores as three TF32 products (csrc/mma_tf32.cuh):
x = hi + lo, hi = x rounded to TF32 (10 mantissa bits, ties away from zero,
as cvt.rna.tf32.f32), lo = x - hi, and a b ~= a_lo b_hi + a_hi b_lo + a_hi
b_hi summed in fp32. The kernels hand lo to the tensor core as it is, which
reads its top 19 bits (lo truncated); the split as usually written rounds
lo too. Both are emulated here in torch, on the attention forward and
backward at (2, 512, D), and must lie within the card checks' tolerances
of the fp32 twins (chip_smoke.py: K2 atol 1e-5 + rtol 1e-4 per element,
K5b 1e-4 of the largest entry); single-pass TF32 must not, which is why
the split is there.
"""
import numpy as np
import pytest
import torch

from gfs3dseg_gws_tpu_torch.ops import attention_train as atr
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import (attention_plain,
                                                         pad_head)


def _rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32: 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """x cut to TF32 (what a tensor core reads of an fp32 register)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(split):
    """a @ b emulated: "3x" with lo rounded, "3x_lo_read" with lo as the
    tensor core reads it (the kernels), "1x" single TF32."""
    def mm(a, b):
        if split == "1x":
            return _rna(a) @ _rna(b)
        ah, bh = _rna(a), _rna(b)
        al, bl = a - ah, b - bh
        lo = _rna if split == "3x" else _trunc
        al, bl = lo(al), lo(bl)
        return (al @ bh + ah @ bl) + ah @ bh
    return mm


def _inputs(d, seed):
    r = np.random.default_rng(seed)
    q, k, v, dy = (torch.from_numpy(r.standard_normal((2, 512, d)).astype(
        np.float32)) for _ in range(4))
    return q, k, v, dy


def _forward(mm, q, k, v, temperature):
    """K2: S and P V through mm, the softmax in fp32."""
    s = mm(q * (1.0 / temperature), k.transpose(1, 2))
    return mm(torch.softmax(s, dim=-1), v)


def _backward(mm, q, k, v, seed, m, den, delta, dy, temperature, rate):
    """K5b's five products through mm, the rest as `_bwd_plain`."""
    inv_t = 1.0 / temperature
    s = mm(k, q.transpose(1, 2)).transpose(1, 2) * inv_t
    p = torch.exp(s - m[..., None]) * (1.0 / den[..., None])
    da = mm(dy, v.transpose(1, 2))
    if rate > 0.0:
        keep = atr.dropout_keep_mask(seed, q.shape[0], q.shape[1], rate)
        scale = 1.0 / (1.0 - rate)
        a = torch.where(keep, p * scale, torch.zeros_like(p))
        dp = torch.where(keep, da * scale, torch.zeros_like(da))
    else:
        a, dp = p, da
    ds = p * (dp - delta[..., None])
    dv = mm(a.transpose(1, 2), dy)
    dk = mm(ds.transpose(1, 2), q) * inv_t
    dq = mm(ds, k) * inv_t
    return dq, dk, dv


def _k2_within(got, ref):
    return bool(((got - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all())


def _k5b_err(got, ref):
    return max(((g - r).abs().max() / r.abs().max()).item()
               for g, r in zip(got, ref))


D_CASES = [30, 64, 128]


@pytest.mark.parametrize("split", ["3x", "3x_lo_read"])
@pytest.mark.parametrize("d", D_CASES)
def test_split_tf32_forward_within_k2_tolerance(d, split):
    q, k, v, _ = _inputs(d, d)
    temp = d ** 0.5
    ref = attention_plain(q, k, v, temp)
    qp, kp, vp = pad_head(q, k, v)
    got = _forward(_mm(split), qp, kp, vp, temp)[..., :d]
    assert _k2_within(got, ref), (got - ref).abs().max().item()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("split", ["3x", "3x_lo_read"])
@pytest.mark.parametrize("d", D_CASES)
def test_split_tf32_backward_within_k5b_tolerance(d, split, rate):
    q, k, v, dy = _inputs(d, d + 1)
    seed, temp = 1234, d ** 0.5
    qp, kp, vp, yp = pad_head(q, k, v, dy)
    out, m, den = atr._fwd_plain(qp, kp, vp, seed, temp, rate)
    delta = (yp * out).sum(-1)
    ref = atr._bwd_plain(qp, kp, vp, seed, m, den, delta, yp, temp, rate)
    got = _backward(_mm(split), qp, kp, vp, seed, m, den, delta, yp, temp,
                    rate)
    assert _k5b_err(got, ref) <= 1e-4


@pytest.mark.parametrize("d", D_CASES)
def test_single_tf32_misses_both_tolerances(d):
    """One TF32 product per pair keeps 10 mantissa bits: ~1e-3 off, outside
    both checks, at rates 0 and 0.1."""
    q, k, v, dy = _inputs(d, d + 2)
    temp = d ** 0.5
    qp, kp, vp, yp = pad_head(q, k, v, dy)
    got = _forward(_mm("1x"), qp, kp, vp, temp)[..., :d]
    assert not _k2_within(got, attention_plain(q, k, v, temp))
    for rate in (0.0, 0.1):
        out, m, den = atr._fwd_plain(qp, kp, vp, 7, temp, rate)
        delta = (yp * out).sum(-1)
        ref = atr._bwd_plain(qp, kp, vp, 7, m, den, delta, yp, temp, rate)
        got_b = _backward(_mm("1x"), qp, kp, vp, 7, m, den, delta, yp, temp,
                          rate)
        assert _k5b_err(got_b, ref) > 1e-4
