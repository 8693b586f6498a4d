"""The 3xTF32 numerics of K2, K5a and K5b, rehearsed on the CPU.

K2 (csrc/attention.cu), K5a and K5b (csrc/attention_train.cu) run their
products on the tensor cores as three TF32 products (csrc/mma_tf32.cuh):
x = hi + lo, hi = x rounded to TF32 (10 mantissa bits, ties away from zero,
as cvt.rna.tf32.f32), lo = x - hi, and a b ~= a_lo b_hi + a_hi b_lo + a_hi
b_hi summed in fp32. The kernels hand lo to the tensor core as it is, which
reads its top 19 bits (lo truncated); the split as usually written rounds
lo too. Both are emulated here in torch, on the attention forward and
backward at (2, 512, D), and must lie within the card checks' tolerances
of the fp32 twins (chip_smoke.py: K2 atol 1e-5 + rtol 1e-4 per element,
K5a 1e-5 and K5b 1e-4 of the largest entry); single-pass TF32 must not,
which is why the split is there.

A tensor core also truncates as it accumulates. K5a's forward is modelled
with that too, at the model's N = 2048: one accumulator chain over every
key drifts past K5a's tolerance, so the kernel sums each key tile of P V
in a fresh accumulator and adds it to its output in fp32.

K1's edge stage (also K9, `edge_mma_kernel` in csrc/fused_edgeconv.cu) is
modelled as the kernel sums it: per neighbour slot a fresh accumulator
over the 64 channels in 8 k-steps (channels grouped as the kernel's
fragments group them), then bias, LeakyReLU and the max over the slots in
fp32; held to the twin `gather_conv_plain` within chip_smoke.py's EC_TOL.

K4b's recomputed z1 (`bwd_kernel` in csrc/fused_edgeconv_train.cu) is
modelled the same way, in its own channel order: the whole backward stage
`_bwd_plain` with z1 as the card sums it stays within chip_smoke.py's
GRAD_TOL of the fp32 twin, and within its K4B_Z1_TOL where c2 is drawn
large enough for z1's rounding to show; single TF32 misses the latter.
"""
import numpy as np
import pytest
import torch

from chip_smoke import EC_TOL, GRAD_TOL, K4B_Z1_TOL, rel_err
from gfs3dseg_gws_tpu_torch.ops import attention_train as atr
from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import (attention_plain,
                                                         pad_head)
from gfs3dseg_gws_tpu_torch.ops.edgeconv import gather_neighbors_plain
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import gather_conv_plain
from torch_port_util import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")


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


def _inputs(d, seed, b=2, n=512):
    r = np.random.default_rng(seed)
    q, k, v, dy = (torch.from_numpy(r.standard_normal((b, n, d)).astype(
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


def _rel_err(got, ref):
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
    assert _rel_err(got, ref) <= 1e-4


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
        assert _rel_err(got_b, ref) > 1e-4


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 rounded toward zero, as a tensor core's
    accumulator keeps a sum."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _mm_tc(steps=None):
    """a @ b as the kernels issue it: m16n8k8 steps of 8 along k, three
    TF32 products a step (lo as the tensor core reads it), each product's
    sum of 8 added to the accumulator and truncated to fp32. With `steps`,
    every `steps` steps start a new accumulator that is added to the result
    in fp32 (K5a's P V, one accumulator per key tile), else one accumulator
    runs over all of k (its S)."""
    def mm(a, b):
        ah, bh = _rna(a), _rna(b)
        al, bl = _trunc(a - ah), _trunc(b - bh)
        out = torch.zeros(a.shape[:-1] + b.shape[-1:])
        acc = out
        for i, k0 in enumerate(range(0, a.shape[-1], 8)):
            if steps and i % steps == 0:
                acc = torch.zeros_like(out)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                acc = _rz(acc.double() + x[..., k0:k0 + 8].double()
                          @ y[..., k0:k0 + 8, :].double())
            if not steps:
                out = acc
            elif i % steps == steps - 1 or k0 + 8 >= a.shape[-1]:
                out = out + acc
        return out
    return mm


def _train_forward(mm, q, k, v, seed, temperature, rate, mm_pv=None):
    """K5a: S through mm with 1 / t on the products, the row max m and the
    sum den of every weight (before the mask), the dropped weights set to 0
    before P V through mm_pv (default mm), then out = (P V) (1 / (1 -
    rate)) / den."""
    s = mm(q, k.transpose(1, 2)) * (1.0 / temperature)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.sum(p, dim=-1, keepdim=True)
    if rate > 0.0:
        keep = atr.dropout_keep_mask(seed, q.shape[0], q.shape[1], rate)
        p = torch.where(keep, p, torch.zeros_like(p))
    out = (mm_pv or mm)(p, v) * ((1.0 / (1.0 - rate)) / den)
    return out, m[..., 0], den[..., 0]


K5A_D = [32, 64, 128]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("split", ["3x", "3x_lo_read"])
@pytest.mark.parametrize("d", K5A_D)
def test_split_tf32_train_forward_within_k5a_tolerance(d, split, rate):
    """out, m and den within K5_FWD_TOL = 1e-5 of _fwd_plain's largest
    entry, each."""
    q, k, v, _ = _inputs(d, d + 3)
    seed, temp = 4321, d ** 0.5
    ref = atr._fwd_plain(q, k, v, seed, temp, rate)
    got = _train_forward(_mm(split), q, k, v, seed, temp, rate)
    assert _rel_err(got, ref) <= 1e-5, _rel_err(got, ref)


@pytest.mark.parametrize("d", K5A_D)
def test_single_tf32_misses_k5a_tolerance(d):
    """One TF32 product per pair misses K5_FWD_TOL at rates 0 and 0.1."""
    q, k, v, _ = _inputs(d, d + 4)
    temp = d ** 0.5
    for rate in (0.0, 0.1):
        ref = atr._fwd_plain(q, k, v, 7, temp, rate)
        got = _train_forward(_mm("1x"), q, k, v, 7, temp, rate)
        assert _rel_err(got, ref) > 1e-5


K5A_KEY_TILE = {32: 64, 64: 64, 128: 16}   # KT of attn_train_fwd_mma_kernel


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", K5A_D)
def test_tensor_core_accumulation_within_k5a_tolerance(d, rate):
    """K5a as the card accumulates, at (1, 2048, D): S in one chain over D,
    P V in a fresh accumulator per key tile; out, m, den within 1e-5."""
    q, k, v, _ = _inputs(d, d + 5, b=1, n=2048)
    seed, temp = 99, d ** 0.5
    ref = atr._fwd_plain(q, k, v, seed, temp, rate)
    got = _train_forward(_mm_tc(), q, k, v, seed, temp, rate,
                         mm_pv=_mm_tc(K5A_KEY_TILE[d] // 8))
    assert _rel_err(got, ref) <= 1e-5, _rel_err(got, ref)


@pytest.mark.parametrize("d", [64, 128])
def test_one_accumulator_over_the_keys_misses_k5a_tolerance(d):
    """P V in one accumulator chain over all 2048 keys misses 1e-5 (on an
    H100 it gave 2.2e-5 at D = 64): why K5a adds per key tile."""
    q, k, v, _ = _inputs(d, d + 5, b=1, n=2048)
    ref = atr._fwd_plain(q, k, v, 99, d ** 0.5, 0.1)
    got = _train_forward(_mm_tc(), q, k, v, 99, d ** 0.5, 0.1)
    assert _rel_err(got, ref) > 1e-5


# the channel each k-step position of edge_mma_kernel takes: k-step 2 p + h
# sums channels 16 p + 4 t + 2 h + {0, 1} (t = 0 .. 3)
EDGE_ORDER = [16 * p + 4 * t + 2 * h + e for p in range(4) for h in range(2)
              for t in range(4) for e in range(2)]


def _edge_inputs(b=2, n=200, w=64, k=20, seed=11):
    """K9's inputs as chip_smoke.py draws them (W2 scaled by W0^-1/2, the
    bias by 0.1), on random neighbour indices; N = 200 is not a multiple of
    the kernel's 64 queries a block."""
    r = np.random.default_rng(seed)
    idx = torch.from_numpy(r.integers(0, n, (b, n, k)).astype(np.int32))
    a, bt = (torch.from_numpy(r.standard_normal((b, n, w)).astype(np.float32))
             for _ in range(2))
    w2 = torch.from_numpy((r.standard_normal((w, w)) * w ** -0.5).astype(
        np.float32))
    bias = torch.from_numpy((r.standard_normal(w) * 0.1).astype(np.float32))
    return idx, a, bt, w2, bias


def _edge_stage(mm, idx, a, bt, w2, bias, slope=0.2):
    """The edge stage with its product through mm over the kernel's channel
    order: each (query, slot) row is its own accumulator; the max over the
    slots, then bias and LeakyReLU (monotone: the same floats as the max of
    leaky(z + bias))."""
    e = gather_neighbors_plain(a, idx) + bt[:, :, None, :]
    e = torch.where(e >= 0, e, slope * e)
    z = mm(e[..., EDGE_ORDER], w2[EDGE_ORDER]).amax(2) + bias
    return torch.where(z >= 0, z, slope * z)


def _within_ec_tol(got, ref):
    return bool(((got - ref).abs() <= EC_TOL[0] + EC_TOL[1] * ref.abs()
                 ).all())


def test_edge_stage_tensor_core_sums_within_ec_tolerance():
    """K9 at (2, 200, 64 -> 64), k = 20, as the card sums it (3xTF32, one
    accumulator per slot over 8 k-steps, truncating): within EC_TOL."""
    args = _edge_inputs()
    got = _edge_stage(_mm_tc(), *args)
    assert _within_ec_tol(got, gather_conv_plain(*args))


def test_single_tf32_misses_ec_tolerance():
    """One TF32 product per pair misses EC_TOL on the same inputs: why the
    edge stage splits its operands."""
    args = _edge_inputs()
    assert not _within_ec_tol(_edge_stage(_mm("1x"), *args),
                              gather_conv_plain(*args))


# the channel each k-step position of K4b's z1 takes (bwd_kernel): k-step kk
# sums channels 8 kk + 2 t (position t) and 8 kk + 2 t + 1 (t + 4)
K4B_ORDER = [8 * kk + 2 * t + e for kk in range(8) for e in range(2)
             for t in range(4)]


def _k4b_args(c2_scale=1.0):
    """K4b's inputs at (2, 200, 64 -> 64), k = 20, as chip_smoke.py's
    check_fused_train draws them (c2 0.01 N(0, 1), times `c2_scale`), the
    statistics from the Function's forward; N = 200 is no multiple of 64."""
    r = np.random.default_rng(12)
    bsz, n, c, k = 2, 200, 64, 20

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((r.standard_normal(shape) * scale
                                 + shift).astype(np.float32))

    a, bt = randn(bsz, n, c), randn(bsz, n, c)
    g1, be1 = randn(c, scale=0.2, shift=1.0), randn(c, scale=0.2)
    w2 = randn(c, c, scale=c ** -0.5)
    g2 = randn(c, scale=0.2, shift=1.0) * torch.tensor(
        [-1.0 if i % 8 == 0 else 1.0 for i in range(c)])
    idx = torch.from_numpy(r.integers(0, n, (bsz, n, k)).astype(np.int32))
    _, mu1, var1, mu2, var2 = fet.fused_edgeconv_train(
        a, bt, g1, be1, w2, g2, randn(c, scale=0.2), idx)
    s1, t1, inv1 = fet._affines(g1, be1, mu1, var1)
    inv2 = torch.rsqrt(var2 + fet.EPS)
    gsel = randn(bsz, n, c)
    p1 = torch.stack([s1, t1, mu1, inv1, g1 * inv1])
    pk = torch.stack([g2 * inv2, gsel.mean((0, 1)),
                      randn(c, scale=0.01) * c2_scale, mu2, inv2])
    kmax = fet._gsf_plain(a, bt, idx, s1, t1, w2, 0.2)[3]
    return (a, bt, idx, p1, w2, gsel, kmax, pk, 0.2)


def _k4b_z1_err(monkeypatch, mm, args):
    """The largest of K4b's outputs' errors (scat, psum, dW2, the bn1 sums;
    max |diff| / max |twin|) with z1 through `mm` in the kernel's channel
    order, against the fp32 twin."""
    ref = fet._bwd_plain(*args)
    with monkeypatch.context() as m:
        m.setattr(fet, "_z1", lambda h1, w: mm(h1[..., K4B_ORDER],
                                               w[K4B_ORDER]))
        got = fet._bwd_plain(*args)
    return max(rel_err(g, w) for g, w in zip(got, ref))


def test_k4b_tensor_core_z1_within_grad_tolerance(monkeypatch):
    """K4b with z1 as the card sums it (3xTF32, one accumulator an edge row
    over 8 k-steps, truncating, in the kernel's channel order), against
    the fp32 twin: every output within GRAD_TOL of the twin's largest
    entry, the measure chip_smoke.py holds the card's K4b to."""
    err = _k4b_z1_err(monkeypatch, _mm_tc(), _k4b_args())
    print(f"K4b with tensor-core z1: {err:.3g} of the twin's largest entry "
          f"(GRAD_TOL {GRAD_TOL}, margin {GRAD_TOL / err:.3g}x)")
    assert 0.0 < err <= GRAD_TOL


def test_k4b_tensor_core_z1_within_z1_tolerance(monkeypatch):
    """The same with c2 100 times larger, as chip_smoke.py's second K4b
    check draws it, so that z1's rounding shows in dz1: within
    K4B_Z1_TOL."""
    err = _k4b_z1_err(monkeypatch, _mm_tc(), _k4b_args(100.0))
    print(f"K4b at c2 ~ N(0, 1), tensor-core z1: {err:.3g} (K4B_Z1_TOL "
          f"{K4B_Z1_TOL}, margin {K4B_Z1_TOL / err:.3g}x)")
    assert 0.0 < err <= K4B_Z1_TOL


def test_k4b_single_tf32_z1_misses_z1_tolerance(monkeypatch):
    """z1 in one TF32 product misses K4B_Z1_TOL on the same inputs (and
    passes GRAD_TOL at c2 0.01 N(0, 1)): why the kernel splits its
    operands, and why chip_smoke.py checks K4b at the larger c2 too."""
    err = _k4b_z1_err(monkeypatch, _mm("1x"), _k4b_args(100.0))
    print(f"K4b at c2 ~ N(0, 1), single-TF32 z1: {err:.3g} (K4B_Z1_TOL "
          f"{K4B_Z1_TOL})")
    assert err > K4B_Z1_TOL
    assert _k4b_z1_err(monkeypatch, _mm("1x"), _k4b_args()) <= GRAD_TOL
