"""The PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Builds the hand-written kernels from gfs3dseg_gws_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, then drives the port's three
paths at the full width of the S3DIS model on synthetic S3DIS-layout data:
GFS evaluation (`train_cli --only_evaluate`, random seeded weights),
backbone pre-training (`pretrain_cli --phase pretrain`, two short epochs
with validation) and GFS base-stage training (`train_cli`, two short
epochs from the pre-trained encoder, validation after each, its checkpoint
evaluated again), and checks the card against the CPU on each. Every phase
prints one line of numbers; any failure raises and the script exits
non-zero. The line before the last lists every kernel with its launches on
the main paths, error against its plain version, time, plain time, bound
and library yardstick; the last line is {"ok": true, "device": {...}}.
Needs one CUDA device; imports no JAX.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
B, N, K = 16, 2048, 20            # eval batch, points per block, neighbours
NUM_GW, N_TRAIN, N_TEST = 150, 64, 512
EC_TOL = (1e-4, 1e-4)             # K1: |diff| <= atol + rtol * |ref| per row
EC_ROWS = 0.999                   # ... on at least this share of rows
TIE_RTOL = 1e-5                   # other rows: 20th/21st plain d2 this close
ATTN_TOL = dict(atol=1e-5, rtol=1e-4)
CPU_AGREE = 0.999                 # card vs CPU: argmax agreement
LOGIT_TOL = 1e-3                  # logits (cosine x 10 x beta) per point
MISS_RATIO, MISS_SLACK = 2.0, 1e-3  # card may miss fp64 this much more than
                                    # the CPU's fp32 does (see phase 5)
CMP_BLOCKS = 8                    # blocks compared between card and CPU
STATS_TOL = 1e-4                  # K3 scb: max |diff| / max |twin|
FWD_TOL, GRAD_TOL = 1e-4, 1e-3    # K4 forward / gradients, same measure
PRE_BLOCKS, PRE_EPOCHS = 480, 2   # pre-training data and epochs
LEARN_STEPS, LEARN_DROP = 30, 0.10  # one batch: loss must fall >= 10%
TRAIN_CMP_BLOCKS = 4              # card vs CPU train step: blocks
STEP_RTOL = 1e-4                  # ... loss and running statistics
GRAD_COS = 0.999                  # ... per-parameter gradient cosine
NOISE_GRAD = 1e-5                 # ... unless both gradients are below this
                                  # share of the largest gradient norm
GRAPH_TIE = 1e-4                  # ... card graph rows the CPU's own graph
                                  # differs on: near-ties (near_tie_rows)
ATTN_RATE = 0.1                   # K5: the model's attention dropout
K5_FWD_TOL, K5_BWD_TOL = 1e-5, 1e-4  # K5a / K5b: max |diff| / max |twin|
GFS_BLOCKS, GFS_EPOCHS = 320, 2   # GFS training data and epochs
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
PROFILE_STEPS = 10                # train steps under torch.profiler
# kernel groups of the step's profile: the first group whose pattern is in a
# kernel's name takes it
KERNEL_GROUPS = (
    ("K5a attn_train_fwd", ("attn_train_fwd",)),
    ("K5b attn_train_bwd", ("attn_train_bwd",)),
    ("K3 knn_kernel", ("knn_kernel",)),
    ("K4a gsf_kernel", ("gsf_kernel",)),
    ("K4b bwd_kernel", ("bwd_kernel",)),
    ("GEMMs (cuBLAS/CUTLASS)", ("gemm", "sm90_xmma", "cutlass", "Kernel2")),
    ("Adam", ("multi_tensor", "adam", "Adam")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized", "unrolled",
                     "index", "scatter", "gather", "fill", "copy", "Copy")),
)


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the least time for `flops` fp32 operations (an
    FMA is two) at the card's fp32 peak outside the tensor cores and for
    `nbytes` (each input read once, each output written once) at its
    memory rate; the larger of the two."""
    t_ops, t_mem = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def size_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase(name, **numbers):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_edgeconv(dev, c: int, gen: torch.Generator):
    """K1 against fused_edgeconv_plain at (B, N, c -> 64), k=20."""
    from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (
        fused_edgeconv_infer, fused_edgeconv_plain)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    args = (randn(B, N, c), randn(B, N, 64), randn(B, N, 64),
            randn(64, 64, scale=0.125), randn(64, scale=0.1))
    got = fused_edgeconv_infer(*args, K)
    ref = fused_edgeconv_plain(*args, K)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    row_ok = (diff <= EC_TOL[0] + EC_TOL[1] * ref.abs()).all(-1)   # (B, N)
    share = row_ok.float().mean().item()
    if share < EC_ROWS:
        raise AssertionError(f"K1 C={c}: only {share:.6f} of rows within "
                             f"tolerance")
    bad = (~row_ok).nonzero().tolist()
    near_tie_rows(args[0], bad, f"K1 C={c}")
    ms = cuda_ms(lambda: fused_edgeconv_infer(*args, K))
    plain_ms = cuda_ms(lambda: fused_edgeconv_plain(*args, K))
    max_err = diff.max().item()
    # FMAs: the kNN distances (B N^2 c) and the edge layer (B N K 64 x 64)
    bound_ms, bound_by = bound(2.0 * (B * N * N * c + B * N * K * 64 * 64),
                               size_of(*args, got))
    phase(f"K1 fused_edgeconv ({B},{N},{c}->64) k={K}", max_abs_err=max_err,
          rows_within_tol=share, near_tie_rows=len(bad), kernel_ms=ms,
          plain_ms=plain_ms, bound_ms=bound_ms)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_attention(dev, gen: torch.Generator):
    """K2 against attention_plain at (B, N, 64)."""
    from gfs3dseg_gws_tpu_torch.ops.attention_kernel import (attention_plain,
                                                             fused_attention)

    q, k, v = (torch.randn((B, N, 64), generator=gen).to(dev)
               for _ in range(3))
    temp = 64 ** 0.5
    got = fused_attention(q, k, v, temp)
    ref = attention_plain(q, k, v, temp)
    torch.testing.assert_close(got, ref, **ATTN_TOL)
    ms = cuda_ms(lambda: fused_attention(q, k, v, temp))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, temp))
    # yardstick only: the port never calls it (its default scale is 1/8)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v))
    max_err = (got - ref).abs().max().item()
    bound_ms, bound_by = bound(2.0 * 2 * B * N * N * 64, size_of(q, k, v, got))
    phase(f"K2 fused_attention ({B},{N},64)", max_abs_err=max_err,
          kernel_ms=ms, plain_ms=plain_ms, sdpa_fp32_ms=library_ms,
          bound_ms=bound_ms)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def near_tie_rows(x, bad, label, rtol=TIE_RTOL, by_norm=False):
    """Each (b, i) in `bad` must be a near-tie at the k-th neighbour: the
    k-th and (k+1)-th plain squared distances within `rtol` of the k-th, or
    with `by_norm` of the larger of it and |x_i|^2 (the rounding scale of
    |x_i|^2 + |x_j|^2 - 2 x_i.x_j where points lie far from the origin)."""
    from gfs3dseg_gws_tpu_torch.ops.knn import pairwise_sq_dists

    for b, i in bad:
        d2 = pairwise_sq_dists(x[b, i:i + 1], x[b])[0]
        d20, d21 = torch.topk(d2, K + 1, largest=False).values[-2:].tolist()
        scale = max(abs(d20), (x[b, i] ** 2).sum().item() if by_norm
                    else 1e-30)
        if abs(d21 - d20) > rtol * scale:
            raise AssertionError(f"{label}: row ({b},{i}) differs without a "
                                 f"near-tie (d20={d20}, d21={d21})")


def check_knn_stats(dev, c: int, gen: torch.Generator):
    """K3 against knn_with_stats_plain at (B, N, c), k=20, btab (B, N, 64):
    idx equal to the twin's, order included, on >= EC_ROWS of the rows;
    each row whose neighbour set differs must be a near-tie at the k-th
    distance. cnt/scb against the plain statistics of the kernel's own idx
    (cnt exact, scb within STATS_TOL)."""
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_with_stats,
                                                knn_with_stats_plain,
                                                neighbor_stats_plain)

    x = torch.randn((B, N, c), generator=gen).to(dev)
    btab = torch.randn((B, N, 64), generator=gen).to(dev)
    idx, cnt, scb = knn_with_stats(x, btab, K)
    ref_idx = knn_with_stats_plain(x, btab, K)[0]
    torch.cuda.synchronize()
    row_ok = (idx.sort(-1).values == ref_idx.sort(-1).values).all(-1)
    share = row_ok.float().mean().item()
    if share < EC_ROWS:
        raise AssertionError(f"K3 C={c}: only {share:.6f} of neighbour sets "
                             f"agree")
    order = (idx == ref_idx).all(-1).float().mean().item()
    if order < EC_ROWS:
        raise AssertionError(f"K3 C={c}: idx equals the twin's on only "
                             f"{order:.6f} of rows")
    bad = (~row_ok).nonzero().tolist()
    near_tie_rows(x, bad, f"K3 C={c}")
    ref_cnt, ref_scb = neighbor_stats_plain(idx, btab)
    if not torch.equal(cnt, ref_cnt):
        raise AssertionError(f"K3 C={c}: cnt differs from the plain count")
    err = rel_err(scb, ref_scb)
    if err > STATS_TOL:
        raise AssertionError(f"K3 C={c}: scb off by {err} (> {STATS_TOL})")
    max_err = (scb - ref_scb).abs().max().item()
    ms = cuda_ms(lambda: knn_with_stats(x, btab, K))
    plain_ms = cuda_ms(lambda: knn_with_stats_plain(x, btab, K))
    # FMAs: the kNN distances (B N^2 c); the scatter's B N K 64 adds
    bound_ms, bound_by = bound(2.0 * B * N * N * c + B * N * K * 64,
                               size_of(x, btab, idx, cnt, scb))
    phase(f"K3 knn_with_stats ({B},{N},{c}) k={K}", sets_agree=share,
          order_agree=order,
          near_tie_rows=len(bad), scb_rel_err=err, max_abs_err=max_err,
          kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_fused_train(dev, gen: torch.Generator):
    """K4a/K4b at (B, N, 64 -> 64), k=20, on an idx from the plain kNN.

    The autograd Function (the kernels) against the unfused composition:
    forward and its four batch statistics. Then each stage against its
    plain twin on the same inputs: K4a at the forward's bn1 affine (values;
    max/min slots on >= EC_ROWS of the (point, channel) pairs: a slot may
    differ where two neighbours' z1 agree to rounding), K4b on K4a's slots.
    K4a's max_abs_err takes sum(h1) and the Gram matrix per edge, as the
    bn2 statistics use them. Then the seven gradients of one random
    cotangent: max |diff| / max |ref|
    <= GRAD_TOL when every slot agreed; where some differed, the gradient
    goes to another edge there, and the relative L2 error is held instead.
    One bn2 scale in eight is negative, so the min branch runs."""
    from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet
    from gfs3dseg_gws_tpu_torch.ops.knn import knn_with_stats_plain

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    x, a, b = randn(B, N, 64), randn(B, N, 64), randn(B, N, 64)
    g1, be1 = randn(64, scale=0.2, shift=1.0), randn(64, scale=0.2)
    w2 = randn(64, 64, scale=0.125)
    g2 = randn(64, scale=0.2, shift=1.0) * torch.tensor(
        [-1.0 if i % 8 == 0 else 1.0 for i in range(64)], device=dev)
    be2 = randn(64, scale=0.2)
    idx, cnt, scb = knn_with_stats_plain(x, b, K)
    cot = randn(B, N, 64)
    params = [a, b, g1, be1, w2, g2, be2]
    names = ("a", "b", "gamma1", "beta1", "w2", "gamma2", "beta2")

    def run(fn, **kw):
        ins = [p.clone().requires_grad_() for p in params]
        outs = fn(*ins, idx, **kw)
        grads = torch.autograd.grad((outs[0] * cot).sum(), ins)
        return [o.detach() for o in outs], grads

    f_outs, f_grads = run(fet.fused_edgeconv_train, cnt=cnt, scb=scb)
    p_outs, p_grads = run(fet.fused_edgeconv_train_plain)
    torch.cuda.synchronize()
    out_err = max(rel_err(f, p) for f, p in zip(f_outs, p_outs))
    if out_err > FWD_TOL:
        raise AssertionError(f"K4 forward off the plain version by {out_err}")

    # K4a against its twin at the forward's bn1 affine
    _, mu1, var1, mu2, var2 = f_outs
    inv1 = torch.rsqrt(var1 + 1e-5)
    s1, t1 = g1 * inv1, be1 - mu1 * g1 * inv1
    gsf_args = (a, b, idx, s1, t1, w2, 0.2)
    got, ref = fet._gsf(*gsf_args), fet._gsf_plain(*gsf_args)
    torch.cuda.synchronize()
    values = [0, 1, 2, 5, 6]                 # snbr, zmax, zmin, sumh1, gram
    k4a_err = max(rel_err(got[i], ref[i]) for i in values)
    # the sums over all B*N*K edges as the glue uses them: per edge
    per_edge = {5: 1.0 / idx.numel(), 6: 1.0 / idx.numel()}
    k4a_abs = max((got[i] - ref[i]).abs().max().item() * per_edge.get(i, 1.0)
                  for i in values)
    slots_ok = ((got[3] == ref[3]) & (got[4] == ref[4])).float().mean().item()
    flips = round((1.0 - slots_ok) * got[3].numel())
    if k4a_err > FWD_TOL or slots_ok < EC_ROWS:
        raise AssertionError(f"K4a off its twin: values {k4a_err}, slots "
                             f"{slots_ok}")

    # K4b against its twin on K4a's slots
    inv2 = torch.rsqrt(var2 + 1e-5)
    gsel = randn(B, N, 64)
    p1 = torch.stack([s1, t1, mu1, inv1, g1 * inv1])
    pk = torch.stack([g2 * inv2, gsel.mean((0, 1)), randn(64, scale=0.01),
                      mu2, inv2])
    bwd_args = (a, b, idx, p1, w2, gsel, got[3], pk, 0.2)
    got_b, ref_b = fet._bwd(*bwd_args), fet._bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    k4b_err = max(rel_err(g, r) for g, r in zip(got_b, ref_b))
    k4b_abs = max((g - r).abs().max().item() for g, r in zip(got_b, ref_b))
    if k4b_err > GRAD_TOL:
        raise AssertionError(f"K4b off its twin by {k4b_err}")

    # the gradients through the whole Function
    def l2(f, p):
        return ((f - p).norm() / p.norm().clamp_min(1e-30)).item()

    measure = rel_err if flips == 0 else l2
    grad_errs = {n: measure(f, p) for n, f, p in zip(names, f_grads, p_grads)}
    worst = max(grad_errs, key=grad_errs.get)
    if grad_errs[worst] > GRAD_TOL:
        raise AssertionError(f"K4 gradient of {worst} off the plain version "
                             f"by {grad_errs[worst]}")

    def fwd(fn, **kw):
        with torch.no_grad():
            fn(*params, idx, **kw)

    times = dict(
        k4a_ms=cuda_ms(lambda: fet._gsf(*gsf_args)),
        k4a_plain_ms=cuda_ms(lambda: fet._gsf_plain(*gsf_args)),
        k4b_ms=cuda_ms(lambda: fet._bwd(*bwd_args)),
        k4b_plain_ms=cuda_ms(lambda: fet._bwd_plain(*bwd_args)),
        fwd_ms=cuda_ms(lambda: fwd(fet.fused_edgeconv_train, cnt=cnt,
                                   scb=scb)),
        fwd_plain_ms=cuda_ms(lambda: fwd(fet.fused_edgeconv_train_plain)),
        fwd_bwd_ms=cuda_ms(lambda: run(fet.fused_edgeconv_train, cnt=cnt,
                                       scb=scb)),
        fwd_bwd_plain_ms=cuda_ms(lambda: run(fet.fused_edgeconv_train_plain)))
    # FMAs per edge (B N K of them), 64 x 64 each: K4a z1 and the Gram
    # matrix, K4b dz1 -> dh1, dW2 and the recomputed z1
    edges = B * N * K
    k4a_bound = bound(2.0 * 2 * edges * 64 * 64,
                      size_of(*gsf_args[:6], *got))
    k4b_bound = bound(2.0 * 3 * edges * 64 * 64,
                      size_of(*bwd_args[:8], *got_b))
    phase(f"K4 fused_edgeconv_train ({B},{N},64->64) k={K}",
          forward_rel_err=out_err, k4a_rel_err=k4a_err, slots_agree=slots_ok,
          slot_flips=flips, k4b_rel_err=k4b_err,
          grad_measure="max_abs_ratio" if flips == 0 else "rel_l2",
          worst_grad=worst, worst_grad_err=grad_errs[worst],
          k4a_bound_ms=k4a_bound[0], k4b_bound_ms=k4b_bound[0], **times)
    return (dict(max_abs_err=k4a_abs, ms=times["k4a_ms"],
                 plain_ms=times["k4a_plain_ms"], bound_ms=k4a_bound[0],
                 bound_by=k4a_bound[1], library_ms=None),
            dict(max_abs_err=k4b_abs, ms=times["k4b_ms"],
                 plain_ms=times["k4b_plain_ms"], bound_ms=k4b_bound[0],
                 bound_by=k4b_bound[1], library_ms=None))


def check_attention_train(dev, gen: torch.Generator):
    """K5a/K5b against their plain twins at (B, N, 64), rates ATTN_RATE and
    0. The twins draw the kernels' dropout mask bit for bit, so out, m, den
    (K5a) and dq, dk, dv (K5b, on the twin's m, den and Delta) are held to
    K5_FWD_TOL / K5_BWD_TOL of the twin's largest entry; the keep share must
    lie within 5 sigma of 1 - rate. Times at ATTN_RATE, the main path's;
    beside them, as a yardstick only, fp32 scaled_dot_product_attention
    forward and backward at dropout 0 (the port never calls it)."""
    from gfs3dseg_gws_tpu_torch.ops import attention_train as atr

    q, k, v, dy = (torch.randn((B, N, 64), generator=gen).to(dev)
                   for _ in range(4))
    seed = torch.tensor([SEED + 77], dtype=torch.int32, device=dev)
    temp = 64 ** 0.5
    errs = {}
    for rate in (0.0, ATTN_RATE):
        got = atr._fwd(q, k, v, seed, temp, rate)
        ref = atr._fwd_plain(q, k, v, seed, temp, rate)
        delta = (dy * ref[0]).sum(-1)
        bwd_args = (q, k, v, seed, ref[1], ref[2], delta, dy, temp, rate)
        got_b, ref_b = atr._bwd(*bwd_args), atr._bwd_plain(*bwd_args)
        torch.cuda.synchronize()
        errs[rate] = dict(
            fwd=max(rel_err(g, r) for g, r in zip(got, ref)),
            bwd=max(rel_err(g, r) for g, r in zip(got_b, ref_b)),
            fwd_abs=(got[0] - ref[0]).abs().max().item(),
            bwd_abs=max((g - r).abs().max().item()
                        for g, r in zip(got_b, ref_b)))
        if errs[rate]["fwd"] > K5_FWD_TOL or errs[rate]["bwd"] > K5_BWD_TOL:
            raise AssertionError(f"K5 at rate {rate} off its twin: "
                                 f"{errs[rate]}")
        del got, ref, got_b, ref_b
    keep = atr.dropout_keep_mask(seed, B, N, ATTN_RATE)
    share = keep.double().mean().item()
    sigma = math.sqrt(ATTN_RATE * (1.0 - ATTN_RATE) / keep.numel())
    del keep
    if abs(share - (1.0 - ATTN_RATE)) > 5 * sigma:
        raise AssertionError(f"K5 keeps {share} of the weights at rate "
                             f"{ATTN_RATE} (sigma {sigma})")

    out, m, den = atr._fwd(q, k, v, seed, temp, ATTN_RATE)
    delta = (dy * out).sum(-1)
    bwd_args = (q, k, v, seed, m, den, delta, dy, temp, ATTN_RATE)
    dq, dk, dv = atr._bwd(*bwd_args)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    lib_out = sdpa(*leaves)
    times = dict(
        k5a_ms=cuda_ms(lambda: atr._fwd(q, k, v, seed, temp, ATTN_RATE)),
        k5a_plain_ms=cuda_ms(lambda: atr._fwd_plain(q, k, v, seed, temp,
                                                    ATTN_RATE)),
        k5b_ms=cuda_ms(lambda: atr._bwd(*bwd_args)),
        k5b_plain_ms=cuda_ms(lambda: atr._bwd_plain(*bwd_args)),
        sdpa_fwd_ms=cuda_ms(lambda: sdpa(q, k, v)),
        sdpa_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dy, retain_graph=True)))
    # FMAs: K5a S and A.V (2 B N^2 D); K5b S, dA, dv, dk, dq (5 B N^2 D)
    k5a_bound = bound(2.0 * 2 * B * N * N * 64,
                      size_of(q, k, v, seed, out, m, den))
    k5b_bound = bound(2.0 * 5 * B * N * N * 64,
                      size_of(q, k, v, seed, m, den, delta, dy, dq, dk, dv))
    phase(f"K5 attention_train ({B},{N},64) rate={ATTN_RATE}",
          k5a_rel_err=errs[ATTN_RATE]["fwd"],
          k5b_rel_err=errs[ATTN_RATE]["bwd"],
          k5a_rel_err_rate0=errs[0.0]["fwd"],
          k5b_rel_err_rate0=errs[0.0]["bwd"], keep_share=share,
          keep_sigma=sigma, k5a_bound_ms=k5a_bound[0],
          k5b_bound_ms=k5b_bound[0], **times)
    return (dict(max_abs_err=errs[ATTN_RATE]["fwd_abs"], ms=times["k5a_ms"],
                 plain_ms=times["k5a_plain_ms"], bound_ms=k5a_bound[0],
                 bound_by=k5a_bound[1], library_ms=times["sdpa_fwd_ms"]),
            dict(max_abs_err=errs[ATTN_RATE]["bwd_abs"], ms=times["k5b_ms"],
                 plain_ms=times["k5b_plain_ms"], bound_ms=k5b_bound[0],
                 bound_by=k5b_bound[1], library_ms=times["sdpa_bwd_ms"]))


def make_inputs(root: str):
    """Synthetic S3DIS-layout data, a random (150, 192) basis and a
    full-width GWCAPL with seeded random weights saved as a reference .pth."""
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL

    train_dir, test_dir = make_synthetic_blocks(
        root, n_train_blocks=N_TRAIN, n_test_blocks=N_TEST,
        points_per_block=4096, seed=SEED)
    gen = torch.Generator().manual_seed(SEED)
    basis = torch.randn((NUM_GW, 192), generator=gen).numpy()
    basis_path = os.path.join(root, "basis.pkl")
    with open(basis_path, "wb") as f:
        pickle.dump(basis, f)
    model = GWCAPL(num_gw=NUM_GW, generator=gen)
    pth = os.path.join(root, "ckpt", "model.pth")
    os.makedirs(os.path.dirname(pth))
    torch.save({"epoch": 0, "state_dict": model.state_dict(),
                "optimizer": {}, "max_iou": 0.0}, pth)
    return train_dir, test_dir, basis_path, pth, model


def pretrain_data(root: str) -> str:
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks

    return make_synthetic_blocks(os.path.join(root, "pretrain_data"),
                                 n_train_blocks=PRE_BLOCKS, n_test_blocks=1,
                                 points_per_block=4096, seed=SEED + 1)[0]


def pretrain_dataset(root: str, mode: str):
    """The pre-training split of `pretrain_data` as pretrain() builds it."""
    from gfs3dseg_gws_tpu_torch.data import (PretrainBlockDataset,
                                             make_registry)

    data_dir = os.path.join(root, "pretrain_data", "blocks_bs1.0_s1.0")
    reg = make_registry("s3dis", 0, data_dir)
    classes = reg.train_classes
    return PretrainBlockDataset(data_dir, classes,
                                {c: reg.class2scans[c] for c in classes},
                                mode=mode, num_point=N, split_ratio=0.1)


def reset_launches():
    """Set every kernel's launch count to 0; returns a reader of them."""
    from gfs3dseg_gws_tpu_torch.ops import attention_train as atr
    from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet
    from gfs3dseg_gws_tpu_torch.ops.attention_kernel import fused_attention
    from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import fused_edgeconv_infer
    from gfs3dseg_gws_tpu_torch.ops.knn import knn_with_stats

    fns = {"k1": fused_edgeconv_infer, "k2": fused_attention,
           "k3": knn_with_stats, "k4a": fet._gsf, "k4b": fet._bwd,
           "k5a": atr._fwd, "k5b": atr._bwd}
    for fn in fns.values():
        fn.launches = 0
    return lambda: {name: fn.launches for name, fn in fns.items()}


def check_pretrain(dev, root: str):
    """The pre-training path on the card through its CLI, at the reference
    config (S3DIS cvfold 0, N=2048, k=20, batch 16, lr 1e-3, wd 1e-4,
    StepLR(50, 0.5), --pc_augm) for PRE_EPOCHS short epochs with a
    validation sweep after each; then the written checkpoint.tar in the
    port's eval DGCNN and the train step's device time."""
    from gfs3dseg_gws_tpu_torch.cli import pretrain_cli
    from gfs3dseg_gws_tpu_torch.models.dgcnn import DGCNN
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_pretrain_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import pretrain_step

    t0 = time.perf_counter()
    data_dir = pretrain_data(root)
    save = os.path.join(root, "pretrain")
    argv = ["--phase", "pretrain", "--dataset", "s3dis", "--cvfold", "0",
            "--data_path", data_dir, "--save_path", save,
            "--batch_size", str(B), "--pc_npts", str(N), "--pc_augm",
            "--pretrain_lr", "0.001", "--pretrain_weight_decay", "1e-4",
            "--n_iters", str(PRE_EPOCHS), "--eval_interval", "1",
            "--seed", str(SEED), "--device", dev.type]
    read = reset_launches()
    t1 = time.perf_counter()
    res = pretrain_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read()
    hist = res["history"]
    steps = sum(h["steps"] for h in hist)
    n_valid = sum(1 for h in hist if "miou" in h)
    phase("pretrain", data_seconds=t1 - t0, wall_seconds=wall, steps=steps,
          losses=[round(h["loss"], 6) for h in hist],
          steps_per_s=[h["steps"] / h["seconds"] for h in hist],
          miou=[h.get("miou") for h in hist], best_miou=res["best_iou"],
          **{f"{k}_launches": v for k, v in launches.items()})
    if not all(math.isfinite(h["loss"]) for h in hist) or n_valid == 0:
        raise AssertionError(f"pre-training went wrong: {hist}")
    if any(launches[k] != 3 * steps for k in ("k3", "k4a", "k4b")):
        raise AssertionError(f"launches {launches} != 3 x {steps} steps")
    log_dir = os.path.join(save, "log_pretrain_s3dis_S0_LongTail")
    valid_batches = n_valid * math.ceil(len(pretrain_dataset(root, "test"))
                                        / B)
    if launches["k1"] != 3 * valid_batches:
        raise AssertionError(f"K1 launches {launches['k1']} != 3 x "
                             f"{valid_batches} validation forwards")
    for name in ("checkpoint.tar", "checkpoint.npz"):
        if not os.path.exists(os.path.join(log_dir, name)):
            raise AssertionError(f"pre-training wrote no {name}")
    enc = DGCNN(device=dev)
    enc.load_state_dict(torch.load(os.path.join(log_dir, "checkpoint.tar"),
                                   map_location=dev)["params"], strict=True)
    enc.eval()
    points = torch.randn((2, N, 9), device=dev)
    with torch.inference_mode():
        feat = enc(points)[1]
    if feat.shape != (2, N, 256) or not torch.isfinite(feat).all():
        raise AssertionError("checkpoint.tar does not run in the eval DGCNN")

    # the train step alone on device tensors
    model = DGCNNSeg(8, generator=torch.Generator().manual_seed(SEED)).to(dev)
    opt, sched = make_pretrain_optimizer(model.parameters(), 1e-3, 100)
    drop = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.randn((B, N, 9), generator=drop, device=dev)
    lbl = torch.randint(0, 8, (B, N), generator=drop, device=dev)
    step_ms = cuda_ms(lambda: pretrain_step(model, opt, pts, lbl, drop, sched))
    phase("device step pretrain_step", batch=B, ms=step_ms,
          steps_per_s=1000.0 / step_ms, valid_batches=valid_batches)
    return launches


def check_learning(dev, root: str):
    """LEARN_STEPS steps on one fixed batch: the loss must fall."""
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_pretrain_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import pretrain_step
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import train_batches

    ds = pretrain_dataset(root, "train")
    points, labels, _ = next(train_batches(ds, B, seed=SEED, epoch=0))
    pts = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
    lbl = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    model = DGCNNSeg(len(ds.classes) + 1,
                     generator=torch.Generator().manual_seed(SEED)).to(dev)
    opt, _ = make_pretrain_optimizer(model.parameters(), 1e-3, 100)
    drop = torch.Generator(device=dev).manual_seed(SEED)
    losses = [pretrain_step(model, opt, pts, lbl, drop).item()
              for _ in range(LEARN_STEPS)]
    phase("learning check (one batch)", steps=LEARN_STEPS,
          first_loss=losses[0], last_loss=losses[-1],
          drop=1.0 - losses[-1] / losses[0])
    if not losses[-1] <= (1.0 - LEARN_DROP) * losses[0]:
        raise AssertionError(f"loss fell from {losses[0]} to {losses[-1]} "
                             f"only")


def compare_train_step(label: str, cpu_model, card_model, dev, run):
    """One train step (no dropout) of the same weights and batch on the
    card and on the CPU (the card model takes the CPU model's weights),
    `run(model, device)` giving its loss: the loss within STEP_RTOL, each
    gradient's cosine with the CPU's >= GRAD_COS, the updated running
    statistics within STEP_RTOL.

    On these blocks at random weights the kNN graphs have near-ties that
    rounding resolves either way, and one flipped neighbour can move a
    block's global max feature and with it the loss of all its points: the
    CPU's own fp32 and fp64 steps differ by ~5e-4 in the loss and by 0.98
    in a gradient's cosine. So the CPU takes the card's graphs: each
    EdgeConv's K3 indices are recorded on the card and replayed on the
    CPU, after checking that every row where they differ from the CPU's own
    graph (at most 1 - EC_ROWS of them) is a near-tie at the k-th
    distance. cnt/scb on the CPU are the plain twin's of that graph. A
    gradient that is zero in exact arithmetic (a bias whose shift a
    train-mode BatchNorm downstream removes) is rounding noise on both
    devices: a pair under NOISE_GRAD of the largest gradient norm is
    counted and left out."""
    from gfs3dseg_gws_tpu_torch.models import dgcnn
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices, knn_with_stats,
                                                neighbor_stats_plain)

    graphs, differing = [], []

    def record(x, btab, k):
        out = knn_with_stats(x, btab, k)
        graphs.append(out[0].cpu())
        return out

    def replay(x, btab, k):
        idx = graphs.pop(0)
        row_ok = (idx.sort(-1).values
                  == knn_indices(x, k).sort(-1).values).all(-1)
        bad = (~row_ok).nonzero().tolist()
        if len(bad) > (1.0 - EC_ROWS) * row_ok.numel():
            raise AssertionError(f"card graph {len(differing)}: {len(bad)} "
                                 f"rows differ from the CPU's")
        near_tie_rows(x, bad, f"card graph {len(differing)}", GRAPH_TIE,
                      by_norm=True)
        differing.append(len(bad))
        return (idx,) + neighbor_stats_plain(idx, btab)

    card_model.load_state_dict(cpu_model.state_dict())
    runs = {}
    for name, model, device, knn in (("card", card_model, dev, record),
                                     ("cpu", cpu_model, "cpu", replay)):
        dgcnn.knn_with_stats = knn
        try:
            model.train()
            loss = run(model, device)
            loss.backward()
        finally:
            dgcnn.knn_with_stats = knn_with_stats
        runs[name] = dict(
            loss=loss.item(),
            grads={n: p.grad.cpu().double().flatten()
                   for n, p in model.named_parameters()},
            stats={n: b.cpu().double() for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))})
    ref, got = runs["cpu"], runs["card"]
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    stat_err = max(((v - ref["stats"][n]).abs()
                    / ref["stats"][n].abs().clamp_min(1.0)).max().item()
                   for n, v in got["stats"].items())
    floor = NOISE_GRAD * max(g.norm().item() for g in ref["grads"].values())
    cos, noise = {}, 0
    for n, g in ref["grads"].items():
        gg = got["grads"][n]
        if g.norm() < floor and gg.norm() < floor:
            noise += 1
            continue
        cos[n] = (g @ gg / (g.norm() * gg.norm()).clamp_min(1e-300)).item()
    worst = min(cos, key=cos.get)
    phase(f"card_vs_cpu {label} ({TRAIN_CMP_BLOCKS} blocks)",
          cpu_loss=ref["loss"], card_loss=got["loss"], loss_rel_err=loss_err,
          running_stat_err=stat_err, worst_grad=worst,
          worst_grad_cosine=cos[worst], noise_grads=noise,
          graph_rows_differing=differing)
    if loss_err > STEP_RTOL or stat_err > STEP_RTOL:
        raise AssertionError("card and CPU train steps disagree")
    if cos[worst] < GRAD_COS:
        raise AssertionError(f"gradient of {worst} off the CPU's")


def first_batch(dataset, blocks: int, epoch: int):
    """The first training batch of `dataset` as CPU tensors (f32, int64)."""
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import train_batches

    points, labels, _ = next(train_batches(dataset, blocks, seed=SEED,
                                           epoch=epoch))
    return (torch.from_numpy(np.asarray(points, np.float32)),
            torch.from_numpy(np.asarray(labels, np.int64)))


def check_train_step_vs_cpu(dev, root: str):
    """compare_train_step on the full-width DGCNNSeg (dropout 0)."""
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy

    gen = torch.Generator().manual_seed(SEED + 5)
    pts, lbl = first_batch(pretrain_dataset(root, "train"), TRAIN_CMP_BLOCKS,
                           1)
    compare_train_step(
        "pretrain step", DGCNNSeg(8, dropout=0.0, generator=gen),
        DGCNNSeg(8, dropout=0.0, device=dev), dev,
        lambda model, device: cross_entropy(model(pts.to(device)),
                                            lbl.to(device)))


# --------------------------------------------------------------------------- #
# GFS base-stage training
# --------------------------------------------------------------------------- #

def gfs_setup(train_dir: str, test_dir: str):
    """The port's GFS setup on the CPU (datasets and class orders)."""
    from gfs3dseg_gws_tpu_torch.pipelines import gfs as port_gfs
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     TrainConfig)

    return port_gfs.build_setup(
        ModelConfig(), DataConfig(data_path=train_dir,
                                  testing_data_path=test_dir, pc_npts=N,
                                  k_shot=5, pc_augm=True),
        TrainConfig(batch_size=B, device="cpu"),
        np.zeros((NUM_GW, 192), np.float32), torch.device("cpu"))


def gfs_model(dev, seed: int, attn_dropout: float = ATTN_RATE):
    """A full-width GWCAPL with the JAX initialisers drawn from `seed`."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL

    model = GWCAPL(num_gw=NUM_GW, attn_dropout=attn_dropout)
    return model.train_init(torch.Generator().manual_seed(seed)).to(dev)


def check_gfs_train(dev, root: str, test_dir: str, basis_path: str):
    """The GFS training path on the card through its CLI (no
    --only_evaluate), at the reference config (S3DIS cvfold 0, N=2048,
    k=20, batch 16, Adam 0.01 with the encoder at 0.1x, StepLR(50, 0.5),
    attention dropout 0.1, --pc_augm) from the pre-training phase's
    checkpoint.tar, GFS_EPOCHS epochs with validation on support seed 0
    after each; launches checked per step and per forward. Then the newest
    checkpoint through `train_cli --only_evaluate` (the 5 support seeds)."""
    import glob

    from gfs3dseg_gws_tpu_torch.cli import train_cli
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks

    t0 = time.perf_counter()
    train_dir = make_synthetic_blocks(
        os.path.join(root, "gfs_train_data"), n_train_blocks=GFS_BLOCKS,
        n_test_blocks=1, points_per_block=4096, seed=SEED + 2)[0]
    save = os.path.join(root, "gfs_train")
    common = ["--dataset", "s3dis", "--cvfold", "0", "--data_path",
              train_dir, "--testing_data_path", test_dir, "--basis_path",
              basis_path, "--pc_npts", str(N), "--k_shot", "5",
              "--batch_size", str(B), "--seed", str(SEED), "--device",
              dev.type]
    argv = common + [
        "--phase", "train", "--save_path", save, "--epochs",
        str(GFS_EPOCHS), "--base_lr", "0.01", "--pc_augm",
        "--use_pretrain_weight", "--pretrain_checkpoint_path",
        os.path.join(root, "pretrain", "log_pretrain_s3dis_S0_LongTail",
                     "checkpoint.tar")]
    read = reset_launches()
    t1 = time.perf_counter()
    res = train_cli.main(argv, eval_interval=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read()
    hist, steps = res["history"], res["step"]
    setup = gfs_setup(train_dir, test_dir)
    n_valid = sum(1 for h in hist if "mean_iou" in h)
    # eval forwards: one coding sweep (epoch 0), and per validation one
    # forward of the support shots plus the static_test sweep
    forwards = (math.ceil(len(setup.train_data_noaug) / B)
                + n_valid * (1 + math.ceil(len(setup.val_dataset) / B)))
    phase("gfs_train", data_seconds=t1 - t0, wall_seconds=wall, steps=steps,
          losses=[h["loss"] for h in hist],
          accuracies=[h["accuracy"] for h in hist],
          steps_per_s=[h["steps"] / h["seconds"] for h in hist],
          mean_iou=[h.get("mean_iou") for h in hist],
          hm_iou=[h.get("hm_iou") for h in hist], eval_forwards=forwards,
          **{f"{k}_launches": v for k, v in launches.items()})
    if (len(hist) != GFS_EPOCHS or n_valid != GFS_EPOCHS
            or not all(math.isfinite(h["loss"]) and math.isfinite(
                h["mean_iou"]) for h in hist)):
        raise AssertionError(f"GFS training went wrong: {hist}")
    if (launches["k5a"] != steps or launches["k5b"] != steps
            or any(launches[k] != 3 * steps for k in ("k3", "k4a", "k4b"))):
        raise AssertionError(f"launches {launches} do not match {steps} "
                             "steps (K5a/K5b 1, K3/K4a/K4b 3 per step)")
    if launches["k2"] != forwards or launches["k1"] != 3 * forwards:
        raise AssertionError(f"launches {launches} do not match {forwards} "
                             "eval forwards (K2 1, K1 3 per forward)")

    ckpts = glob.glob(os.path.join(save, "train_*.npz"))
    if not ckpts:
        raise AssertionError("GFS training wrote no checkpoint")
    ckpt = max(ckpts, key=os.path.getmtime)
    t1 = time.perf_counter()
    ev = train_cli.main(common + [
        "--phase", "test", "--only_evaluate", "--model_checkpoint_path",
        ckpt, "--save_path", os.path.join(root, "gfs_eval"),
        "--eval_weight", "1.2", "--energy", "0.9"])
    mious = [ev[k] for k in ("mean_iou", "base_iou", "novel_iou", "hm_iou")]
    phase("gfs_train checkpoint through evaluate_gfs",
          checkpoint=os.path.basename(ckpt), mean_iou=mious[0],
          base_iou=mious[1], novel_iou=mious[2], hm_iou=mious[3],
          wall_seconds=time.perf_counter() - t1)
    if not all(math.isfinite(m) for m in mious):
        raise AssertionError(f"non-finite mIoU {mious} from {ckpt}")
    return launches, setup


def check_gfs_learning(dev, setup, gp: torch.Tensor):
    """LEARN_STEPS GFS steps on one fixed batch (the fake classes and the
    dropout drawn anew each step): the mean loss of the last 5 steps must
    lie LEARN_DROP below the first step's."""
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_train_step

    pts, lbl = (t.to(dev) for t in first_batch(setup.train_data, B, 0))
    model = gfs_model(dev, SEED)
    opt, _ = make_gfs_optimizer(model, 0.01, 100)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    losses = [gfs_train_step(model, opt, pts, lbl, gp, gen)[0].item()
              for _ in range(LEARN_STEPS)]
    last = statistics.mean(losses[-5:])
    phase("gfs learning check (one batch)", steps=LEARN_STEPS,
          first_loss=losses[0], last5_mean_loss=last,
          drop=1.0 - last / losses[0])
    if not last <= (1.0 - LEARN_DROP) * losses[0]:
        raise AssertionError(f"GFS loss fell from {losses[0]} to {last} "
                             "only")


def profile_groups(fn, steps: int):
    """ms per step of each KERNEL_GROUPS group (and the rest) from
    torch.profiler's device times over `steps` calls of `fn`; None where
    the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    launches = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        launches += evt.count
        key = next((name for name, pats in KERNEL_GROUPS
                    if any(p in evt.key for p in pats)), "other")
        groups[key] += us / 1e3 / steps
    if sum(groups.values()) == 0.0:
        return None, 0
    return groups, launches / steps


def check_gfs_step(dev, setup, gp: torch.Tensor):
    """gfs_train_step alone on device tensors: the CUDA-event median, the
    host-clock wall of PROFILE_STEPS steps, and the kernel time by group
    from torch.profiler (device idle share = 1 - kernels / wall)."""
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_train_step

    pts, lbl = (t.to(dev) for t in first_batch(setup.train_data, B, 1))
    model = gfs_model(dev, SEED + 1)
    opt, sched = make_gfs_optimizer(model, 0.01, 100)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        return gfs_train_step(model, opt, pts, lbl, gp, gen, sched)

    step_ms = cuda_ms(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / PROFILE_STEPS
    groups, launches = profile_groups(step, PROFILE_STEPS)
    phase("device step gfs_train_step", batch=B, ms=step_ms,
          steps_per_s=1000.0 / step_ms, wall_ms=wall_ms)
    if groups is None:
        phase("profile gfs_train_step", note="torch.profiler saw no device "
              "time; CUDA-event times above stand")
        return
    kernels = sum(groups.values())
    phase("profile gfs_train_step", steps=PROFILE_STEPS,
          kernel_ms_per_step=kernels, wall_ms_per_step=wall_ms,
          idle_share=1.0 - kernels / wall_ms, launches_per_step=launches,
          groups_ms=json.dumps({k: round(v, 4) for k, v in groups.items()}))


def check_gfs_step_vs_cpu(dev, setup, gp: torch.Tensor):
    """compare_train_step on the full-width GWCAPL (attention dropout 0, a
    fixed fake_row)."""
    pts, lbl = first_batch(setup.train_data, TRAIN_CMP_BLOCKS, 1)
    fake = torch.zeros(13)
    fake[[2, 4, 5]] = 1.0
    gp_cpu = gp.cpu()
    compare_train_step(
        "gfs step", gfs_model("cpu", SEED + 6, attn_dropout=0.0),
        gfs_model(dev, SEED + 7, attn_dropout=0.0), dev,
        lambda model, device: model(pts.to(device), lbl.to(device),
                                    gp_cpu.to(device),
                                    fake_row=fake.to(device))[1])


def main() -> int:
    # ---- phase 0: the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0],
          devices=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from gfs3dseg_gws_tpu_torch.cli import train_cli
    from gfs3dseg_gws_tpu_torch.ops import _ext
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_eval_multi_step
    from gfs3dseg_gws_tpu_torch.pipelines import gfs as port_gfs
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     TrainConfig)

    # ---- phase 1: build the kernels
    t0 = time.perf_counter()
    so = _ext.build()
    _ext.library()
    phase("build", seconds=time.perf_counter() - t0,
          library=os.path.relpath(so))

    # ---- phases 2-3: each kernel against its plain version
    gen = torch.Generator().manual_seed(SEED)
    check_edgeconv(dev, 9, gen)
    stats = {"k1": check_edgeconv(dev, 64, gen),
             "k2": check_attention(dev, gen)}
    check_knn_stats(dev, 9, gen)
    stats["k3"] = check_knn_stats(dev, 64, gen)
    stats["k4a"], stats["k4b"] = check_fused_train(dev, gen)
    stats["k5a"], stats["k5b"] = check_attention_train(dev, gen)

    with tempfile.TemporaryDirectory(prefix="gfs_chip_smoke_") as root:
        # ---- phase 4: the main path, train_cli --only_evaluate on the card
        t0 = time.perf_counter()
        train_dir, test_dir, basis_path, pth, cpu_model = make_inputs(root)
        phase("data", seconds=time.perf_counter() - t0, train_blocks=N_TRAIN,
              test_blocks=N_TEST)
        argv = ["--phase", "test", "--only_evaluate", "--dataset", "s3dis",
                "--cvfold", "0", "--data_path", train_dir,
                "--testing_data_path", test_dir, "--basis_path", basis_path,
                "--model_checkpoint_path", pth,
                "--save_path", os.path.join(root, "eval"),
                "--pc_npts", str(N), "--k_shot", "5", "--eval_weight", "1.2",
                "--energy", "0.9", "--batch_size", str(B),
                "--device", "cuda"]
        read = reset_launches()
        t0 = time.perf_counter()
        res = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eval_launches = read()
        k1_launches, k2_launches = eval_launches["k1"], eval_launches["k2"]

        model_cfg = ModelConfig()
        data_cfg = DataConfig(data_path=train_dir, testing_data_path=test_dir,
                              pc_npts=N, k_shot=5)
        train_cfg = TrainConfig(batch_size=B, eval_weight=1.2, device="cpu")
        setup = port_gfs.build_setup(model_cfg, data_cfg, train_cfg,
                                     np.zeros((NUM_GW, 192), np.float32),
                                     torch.device("cpu"))
        forwards = (math.ceil(len(setup.train_data_noaug) / B)
                    + len(setup.supp_datasets)
                    + math.ceil(len(setup.val_dataset) / B))
        mious = [res[k] for k in ("mean_iou", "base_iou", "novel_iou",
                                  "hm_iou")]
        phase("evaluate_gfs", mean_iou=mious[0], base_iou=mious[1],
              novel_iou=mious[2], hm_iou=mious[3], blocks=res["n_blocks"],
              sweep_seconds=res["sweep_seconds"],
              sweep_blocks_per_s=res["n_blocks"] / res["sweep_seconds"],
              wall_seconds=wall, forwards=forwards, k1_launches=k1_launches,
              k2_launches=k2_launches)
        if not all(math.isfinite(m) for m in mious):
            raise AssertionError(f"non-finite mIoU {mious}")
        if k2_launches != forwards or k1_launches != 3 * forwards:
            raise AssertionError(
                f"launch counts K1={k1_launches} K2={k2_launches} do not "
                f"match {forwards} forwards (3 and 1 per forward)")

        # ---- phase 4b: the same sweep again, its memmap cache now built
        gpu_model = type(cpu_model)(num_gw=NUM_GW, device=dev)
        gpu_model.load_state_dict(cpu_model.state_dict())
        basis_np = port_gfs.load_basis(basis_path)
        heads = (res["gened_protos"], res["base_coding"],
                 res["novel_codings"])
        t0 = time.perf_counter()
        port_gfs.validate_multi(gpu_model, torch.from_numpy(basis_np).to(dev),
                                setup.val_dataset,
                                *heads, setup.all_learning_order,
                                setup.test_class_names,
                                len(setup.all_class_names), B)
        warm = time.perf_counter() - t0
        phase("sweep (warm cache)", blocks=len(setup.val_dataset),
              seconds=warm, blocks_per_s=len(setup.val_dataset) / warm)

        # ---- phase 4c: the eval step alone on device tensors (no host)
        batch = next(port_gfs.eval_batches(setup.val_dataset, B))
        dev_args = [torch.from_numpy(np.array(a)).to(dev) for a in
                    (batch[0], batch[1], basis_np) + heads]
        step_ms = cuda_ms(lambda: gfs_eval_multi_step(
            gpu_model, *dev_args[:3], *dev_args[3:], B,
            len(setup.all_class_names)))
        phase("device step gfs_eval_multi_step", batch=B, ms=step_ms,
              blocks_per_s=1000.0 * B / step_ms)

        # ---- phase 5: the card against the CPU. With random weights, kNN
        # on these blocks has near-ties that fp32 rounding alone resolves
        # either way: the CPU's own fp32 and fp64 logits differ past
        # LOGIT_TOL on 0.05-0.6% of points, depending on the blocks, and
        # which points those are is a matter of rounding. So the card's
        # logits are held to the CPU's fp64 ones and may miss them on at
        # most MISS_RATIO times as many points as the CPU's fp32 logits do,
        # plus MISS_SLACK; a wrong weight, fold or kernel misses on most.
        points, _, _ = next(port_gfs.eval_batches(setup.val_dataset,
                                                  CMP_BLOCKS))
        inputs = [torch.from_numpy(np.array(a)) for a in (points, basis_np)
                  + heads]
        with torch.inference_mode():
            cpu32 = cpu_model.evaluate_multi(*inputs)[0].double()
            card = gpu_model.evaluate_multi(
                *(a.to(dev) for a in inputs))[0].cpu().double()
            cpu64 = cpu_model.double().evaluate_multi(
                *(a.double() for a in inputs))[0]

        def within(a, b):
            return ((a - b).abs() <= LOGIT_TOL).all(-1).double().mean().item()

        agree = (card.argmax(-1) == cpu32.argmax(-1)).double().mean().item()
        card_miss = 1.0 - within(card, cpu64)
        cpu_miss = 1.0 - within(cpu32, cpu64)
        phase(f"card_vs_cpu evaluate_multi ({CMP_BLOCKS} blocks)",
              argmax_agree=agree,
              card_vs_cpu32_within_tol=within(card, cpu32),
              card_misses_cpu64=card_miss, cpu32_misses_cpu64=cpu_miss,
              max_abs_diff=(card - cpu32).abs().max().item())
        if agree < CPU_AGREE or card_miss > MISS_RATIO * cpu_miss + MISS_SLACK:
            raise AssertionError("card and CPU disagree")

        # ---- phases 6-8: pre-training, the learning check, card vs CPU
        check_pretrain(dev, root)
        check_learning(dev, root)
        check_train_step_vs_cpu(dev, root)

        # ---- phases 9-12: GFS training from the pre-trained encoder, the
        # learning check, the train step alone, card vs CPU
        train_launches, gfs = check_gfs_train(dev, root, test_dir,
                                              basis_path)
        gp = torch.from_numpy(port_gfs.load_basis(basis_path)).to(dev)
        check_gfs_learning(dev, gfs, gp)
        check_gfs_step(dev, gfs, gp)
        check_gfs_step_vs_cpu(dev, gfs, gp)

    # K1/K2 launches from the evaluation path, K3-K5 from GFS training
    launches = dict(train_launches, k1=k1_launches, k2=k2_launches)
    kernels = [
        ("k1", "fused_edgeconv_infer", "fused_edgeconv.cu",
         "fused_edgeconv.py:94"),
        ("k2", "fused_attention", "attention.cu", "attention_kernel.py:34"),
        ("k3", "knn_with_stats", "fused_edgeconv.cu", "knn.py:380"),
        ("k4a", "fused_edgeconv_train_fwd", "fused_edgeconv_train.cu",
         "fused_edgeconv_train.py:408"),
        ("k4b", "fused_edgeconv_train_bwd", "fused_edgeconv_train.cu",
         "fused_edgeconv_train.py:239"),
        ("k5a", "attention_train_fwd", "attention_train.cu",
         "attention_train.py:124"),
        ("k5b", "attention_train_bwd", "attention_train.cu",
         "attention_train.py:70"),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"gfs3dseg_gws_tpu_torch/csrc/{src}",
         "replaces": f"gfs3dseg_gws_tpu/ops/{tpu}",
         "launches": launches[key], **stats[key]}
        for key, name, src, tpu in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
