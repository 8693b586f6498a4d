"""The PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Builds the hand-written kernels from gfs3dseg_gws_tpu_torch/csrc, holds each
against its plain PyTorch version on the card (at the model's widths; then
every kernel past them - C = W = 128 with k = 40, k = 80, attention at
D = 30, 128 and 192, the kNN at k = 80 on a key row of 30,000 points - and
K8, the kNN by its own selection, bit for bit against K6; K6, K3 and K1's
kNN stage on blocks of copied points, whose exact ties go to the lower
index, against the twin on every row), then
drives the port's paths at the full width of the S3DIS model on synthetic
S3DIS-layout data: GFS evaluation (`train_cli --only_evaluate`, random
seeded weights), backbone pre-training (`pretrain_cli --phase pretrain`,
two short epochs with validation), geometric-word extraction (`basis_cli`
on the pre-training checkpoint) and GFS base-stage training (`train_cli`,
two short epochs from the pre-trained encoder and that basis, validation
after each, its checkpoint evaluated again), the six few-shot baseline
phases of `pretrain_cli` from that pre-trained encoder (ProtoNet and MPTI
training and evaluation, MPTI's GFS evaluation, FineTune); then the same
chain
pre-train -> basis -> GFS train -> evaluate at the DGCNN semantic-
segmentation widths, whose third EdgeConv block is one layer deep, and at
the DGCNN classification encoder's (four one-layer blocks 64, 64, 128, 256,
k = 40). It checks the card against the CPU on each. It also preprocesses
raw data: S3DIS rooms (one of a million points) and ScanNet scans through
`preprocess_cli` (collection, then `room2blocks` on the card, held to the
host's byte for byte) into blocks that `train_cli --only_evaluate`
evaluates; and takes what the main path wrote through the checkpoint
converter (`cli/convert_checkpoint.py`, round trips bit for bit, the GFS
`.pth` evaluated to the npz's mIoU) and the GFS step through the port's
`trace`. Every phase prints
one line of numbers; any failure raises and the script exits non-zero. The
line before the last lists every kernel with its launches on the main
paths, error against its plain version, time, plain time, bound and
library yardstick (and, where it has one, the same at its wide shape); the
last line is {"ok": true, "device": {...}}. Needs one CUDA device; imports
no JAX.
"""
from __future__ import annotations

import glob
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
K4B_Z1_TOL = 1e-4                 # K4b at c2 ~ N(0, 1), same measure
PRE_BLOCKS, PRE_EPOCHS = 160, 2   # pre-training data and epochs
LEARN_STEPS, LEARN_DROP = 30, 0.10  # one batch: loss must fall >= 10%
TRAIN_CMP_BLOCKS = 4              # card vs CPU train step: blocks (2 at
                                  # the classification widths)
STEP_RTOL = 1e-4                  # ... loss and running statistics
GRAD_COS = 0.999                  # ... per-parameter gradient cosine
NOISE_GRAD = 1e-5                 # ... unless both gradients are below this
                                  # share of the largest gradient norm
GRAPH_TIE = 1e-4                  # ... card graph rows the CPU's own graph
                                  # differs on: near-ties (near_tie_rows)
MAX_TIE = 1e-4                    # ... and global-max points it differs on:
                                  # |max - value there| / |max| at most this
ATTN_RATE = 0.1                   # K5: the model's attention dropout
K5_OFFSET = 8                     # K5 also at this batch_offset (a data-
                                  # parallel rank's first global row)
K5_FWD_TOL, K5_BWD_TOL = 1e-5, 1e-4  # K5a / K5b: max |diff| / max |twin|
GFS_BLOCKS, GFS_EPOCHS = 256, 2   # GFS training data and epochs
DEFAULT_WIDTHS = "[[64,64],[64,64],[64,64]]"
# the DGCNN semantic-segmentation backbone (Wang et al., TOG 2019,
# DGCNN_semseg conv1-2 / conv3-4 / conv5): a third block one layer deep
SEMSEG_WIDTHS = "[[64,64],[64,64],[64]]"
# the DGCNN classification encoder (same paper, DGCNN_cls: EdgeConv 64, 64,
# 128, 256, one layer each) with its 2,048-point k = 40
CLASS_WIDTHS, CLASS_K = "[[64],[64],[128],[256]]", 40
# the wide kernel checks: every kernel past the fast path's C, W <= 64 and
# k <= 32 at the classification widths (C = W = 128, k = 40), at k > 64,
# and the attention at D = 30 (zero-padded to 32), D = 128 (K2 and K5b's
# widest single block) and D = 192 (past it: channels split over blocks)
WIDE_C, WIDE_K, BIG_K, BIG_B = 128, CLASS_K, 80, 4
WIDE_D = (30, 128, 192)
LONG_N = 30000                    # kNN at k = BIG_K past one shared key row
WIDE_REPS = 5                     # timing repetitions past the fast path
K4_DRAWS = (1, 2, 3)              # K4 at C = W = WIDE_C: seeds of more draws
K8_FOLDS = (2, 4, 8)              # K8: folds held to K6 (2 and 4 timed)
K7_TOL = 1e-5                     # K7, gather gradient: max |diff| / max |ref|
LLOYD_BLOCKS, LLOYD_ITERS = 32, 20  # lloyd card vs CPU: blocks, iterations
LLOYD_AGREE = 0.999               # ... per iteration: labels equal on this
                                  # share of points; centres: max |diff| /
CENTRE_TOL = 1e-4                 # max |CPU| when all labels agree, else (a
CENTRE_FLIP_TOL = 1e-2            # flipped point moves its two centres) this
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, TF32 on them
# (dense), HBM3
PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_PER_S = 67e12, 495e12, 3.35e12
PROFILE_STEPS = 5                 # train steps under torch.profiler
# the few-shot baselines: prototrain / mptitrain episodes (one validation
# at the last), bank episodes a class pair, mptigfs's base and query
# blocks, finetune's inner steps and episodes, repetitions of a device
# episode's time; label_propagate card vs CPU fp64: max |diff| / max |z|
FS_ITERS, FS_MPTI_ITERS, FS_BANK, FS_BLOCKS = 4, 2, 1, 16
FT_ITERS, FT_EPISODES, FS_REPS = 3, 2, 5
LP_TOL = 1e-3
RELOAD_TOL = 1e-3                 # eval phase vs its train phase's mIoU
PROTO_EPISODES = 4                # ProtoNet card vs CPU: test episodes
# raw data: an average S3DIS room (273 M points over 272 rooms, about 6 x 5
# m), the other rooms small; ScanNet scans of a typical vertex count, their
# over-segmentation a grid of cells; the raw ScanNet category of class c
# (class 0: a label no row of the tsv names)
RAW_ROOM_POINTS, RAW_ROOM_M, SMALL_ROOM_POINTS = 1_000_000, (6.0, 5.0), 12_000
SCAN_POINTS, SCAN_M, SCAN_CELL = 100_000, (6.0, 4.0), 0.5
SCANNET_RAW = (
    "mystery object", "wall", "floor", "chair", "table", "desk", "bed",
    "bookshelf", "couch", "sink", "bathtub", "toilet", "curtain", "counter",
    "door", "window", "shower curtain", "refrigerator", "picture", "cabinet",
    "trash can")
TRACE_STEPS = 3                   # gfs_train_steps under trace
# kernel groups of the step's profile: the first group whose pattern is in a
# kernel's name takes it
KERNEL_GROUPS = (
    ("K5a attn_train_fwd", ("attn_train_fwd",)),
    ("K5b attn_train_bwd", ("attn_train_bwd",)),
    ("K8 knn_stream_kernel / knn_fold_kernel (the kNN for k > 64)",
     ("knn_stream_kernel", "knn_fold_kernel")),
    ("K6 knn_split_kernel / knn_kernel <CP, KMAX, (S,) false>",
     ("2, false>", "4, false>")),
    ("K7 edgeconv_scatter", ("edgeconv_scatter",)),
    ("K3 knn_split_kernel / knn_kernel <CP, KMAX, true>",
     ("knn_split_kernel", "knn_kernel")),
    ("K4a gsf_kernel", ("gsf_kernel",)),
    ("K4b bwd_kernel", ("bwd_kernel",)),
    ("GEMMs (cuBLAS/CUTLASS)", ("gemm", "sm90_xmma", "cutlass", "Kernel2")),
    ("solve (cuSOLVER LU)", ("getrf", "getrs", "trsm", "laswp", "potrf")),
    ("sort", ("Sort", "sort")),
    ("Adam", ("multi_tensor", "adam", "Adam")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized", "unrolled",
                     "index", "scatter", "gather", "fill", "copy", "Copy")),
)


def bound(flops: float, nbytes: float, tf32x3: bool = False,
          tc_flops: float = 0.0):
    """(bound_ms, bound_by): the least time for `flops` fp32 operations (an
    FMA is two) at the card's fp32 peak outside the tensor cores, or with
    `tf32x3` as three TF32 products each on the tensor cores (3xTF32, K2,
    K5a and K5b: fp32-accurate, 3 x flops at the TF32 peak), plus
    `tc_flops` more in 3xTF32 (K1: its edge stage beside its fp32 kNN),
    and for `nbytes` (each input read once, each output written once) at
    its memory rate; the larger of the two."""
    t_ops = (3.0 * flops / PEAK_TF32_FLOPS if tf32x3
             else flops / PEAK_FP32_FLOPS) + 3.0 * tc_flops / PEAK_TF32_FLOPS
    t_mem = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def size_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase(name, **numbers):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


PHASE_SECONDS = {}                # host-clock seconds of each step of main


def timed(name: str, fn, *args):
    """fn(*args), its host-clock seconds kept in PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    return out


def sync(dev: torch.device) -> None:
    """Wait for `dev` (a CUDA device; nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


def check_edgeconv(dev, c: int, gen: torch.Generator, w0: int = 64,
                   w1: int = 64, k: int = K, b: int = B, reps: int = 20):
    """K1 against fused_edgeconv_plain at (b, N, c -> w0 -> w1), k."""
    from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (
        fused_edgeconv_infer, fused_edgeconv_plain)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    args = (randn(b, N, c), randn(b, N, w0), randn(b, N, w0),
            randn(w0, w1, scale=w0 ** -0.5), randn(w1, scale=0.1))
    got = fused_edgeconv_infer(*args, k)
    ref = fused_edgeconv_plain(*args, k)
    # local queries (a data x points rank): the second half of the points
    # against all of them, the rows of the full call bit for bit
    h = N // 2
    local = (args[0], args[1], args[2][:, h:].contiguous()) + args[3:]
    got_local = fused_edgeconv_infer(*local, k, q_offset=h)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    row_ok = (diff <= EC_TOL[0] + EC_TOL[1] * ref.abs()).all(-1)   # (B, N)
    share = row_ok.float().mean().item()
    label = f"K1 fused_edgeconv ({b},{N},{c}->{w0}->{w1}) k={k}"
    if share < EC_ROWS:
        raise AssertionError(f"{label}: only {share:.6f} of rows within "
                             f"tolerance")
    if not torch.equal(got_local, got[:, h:]):
        raise AssertionError(f"{label}: local queries differ from the full "
                             "call's rows")
    bad = (~row_ok).nonzero().tolist()
    near_tie_rows(args[0], bad, label, k=k)
    ms = cuda_ms(lambda: fused_edgeconv_infer(*args, k), reps)
    local_ms = cuda_ms(lambda: fused_edgeconv_infer(*local, k, q_offset=h),
                       reps)
    plain_ms = cuda_ms(lambda: fused_edgeconv_plain(*args, k), reps)
    max_err = diff.max().item()
    # FMAs: the kNN distances (b N^2 c, fp32) and the edge layer (b N k w0
    # x w1: 3xTF32 on the tensor cores up to W0, W1 = 64, fp32 past them)
    knn_flops, edge_flops = 2.0 * b * N * N * c, 2.0 * b * N * k * w0 * w1
    nbytes = size_of(*args, got)
    fp32_ms = bound(knn_flops + edge_flops, nbytes)[0]
    bound_ms, bound_by = (bound(knn_flops, nbytes, tc_flops=edge_flops)
                          if max(w0, w1) <= 64
                          else bound(knn_flops + edge_flops, nbytes))
    phase(label, max_abs_err=max_err,
          rows_within_tol=share, near_tie_rows=len(bad), kernel_ms=ms,
          plain_ms=plain_ms, bound_ms=bound_ms, bound_fp32_ms=fp32_ms,
          local_queries="rows of the full call, bit for bit",
          local_ms=local_ms)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                bound_fp32_ms=fp32_ms, local_ms=local_ms)


def check_attention(dev, gen: torch.Generator, d: int = 64, reps: int = 20):
    """K2 against attention_plain at (B, N, d)."""
    from gfs3dseg_gws_tpu_torch.ops.attention_kernel import (attention_plain,
                                                             fused_attention)

    q, k, v = (torch.randn((B, N, d), generator=gen).to(dev)
               for _ in range(3))
    temp = d ** 0.5
    got = fused_attention(q, k, v, temp)
    ref = attention_plain(q, k, v, temp)
    torch.testing.assert_close(got, ref, **ATTN_TOL)
    # local queries (a data x points rank): the second half of q against
    # every key, the rows of the full call bit for bit
    q_half = q[:, N // 2:].contiguous()
    if not torch.equal(fused_attention(q_half, k, v, temp), got[:, N // 2:]):
        raise AssertionError(f"K2 fused_attention ({B},{N},{d}): local "
                             "queries differ from the full call's rows")
    ms = cuda_ms(lambda: fused_attention(q, k, v, temp), reps)
    local_ms = cuda_ms(lambda: fused_attention(q_half, k, v, temp), reps)
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, temp), reps)
    # yardstick only: the port never calls it (its default scale is
    # 1/sqrt(d), the same)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v), reps)
    max_err = (got - ref).abs().max().item()
    # FMAs: S and P.V (2 B N^2 D); on the tensor cores in 3xTF32 up to
    # D = 128, on the fp32 pipe past it
    flops, nbytes = 2.0 * 2 * B * N * N * d, size_of(q, k, v, got)
    bound_ms, bound_by = bound(flops, nbytes, tf32x3=d <= 128)
    fp32_ms = bound(flops, nbytes)[0]
    phase(f"K2 fused_attention ({B},{N},{d})", max_abs_err=max_err,
          kernel_ms=ms, plain_ms=plain_ms, sdpa_fp32_ms=library_ms,
          bound_ms=bound_ms, bound_fp32_ms=fp32_ms,
          local_queries="rows of the full call, bit for bit",
          local_ms=local_ms)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                bound_fp32_ms=fp32_ms, local_ms=local_ms)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def k4a_offset_affine(r: np.random.Generator, c: int):
    """The bn1 affine (s1, t1) of K4a's offset check: s1 ~ 1e-5 (1 + 0.2
    N(0, 1)), t1 ~ U[0.5, 1.5], so that h1 = leaky(e0 s1 + t1) is one
    value a channel to a spread far below a TF32 step: every edge row
    rounds the same way, and a Gram matrix in single TF32 misses FWD_TOL
    (tests/test_torch_port_split_tf32.py)."""
    s1 = (1e-5 * (1.0 + 0.2 * r.standard_normal(c))).astype(np.float32)
    return s1, r.uniform(0.5, 1.5, c).astype(np.float32)


def near_tie_rows(x, bad, label, rtol=TIE_RTOL, by_norm=False, k=K):
    """Each (b, i) in `bad` must be a near-tie at the k-th neighbour: the
    k-th and (k+1)-th plain squared distances within `rtol` of the k-th, or
    with `by_norm` of the larger of it and |x_i|^2 (the rounding scale of
    |x_i|^2 + |x_j|^2 - 2 x_i.x_j where points lie far from the origin)."""
    from gfs3dseg_gws_tpu_torch.ops.knn import pairwise_sq_dists

    for b, i in bad:
        d2 = pairwise_sq_dists(x[b, i:i + 1], x[b])[0]
        d20, d21 = torch.topk(d2, k + 1, largest=False).values[-2:].tolist()
        scale = max(abs(d20), (x[b, i] ** 2).sum().item() if by_norm
                    else 1e-30)
        if abs(d21 - d20) > rtol * scale:
            raise AssertionError(f"{label}: row ({b},{i}) differs without a "
                                 f"near-tie (d20={d20}, d21={d21})")


def graph_agreement(x, idx, ref_idx, label, k=K):
    """A kernel's kNN graph against its twin's: neighbour sets equal on
    >= EC_ROWS of the rows, every row whose set differs a near-tie at the
    k-th distance, and the order equal on >= EC_ROWS of the rows (for k up
    to the fast path's 32; past it, where a longer list meets more
    near-ties, every row whose order alone differs must hold the same
    distances slot by slot, within TIE_RTOL of its k-th). Returns (share
    of equal sets, share of equal orders, the rows whose set differs)."""
    row_ok = (idx.sort(-1).values == ref_idx.sort(-1).values).all(-1)
    share = row_ok.float().mean().item()
    if share < EC_ROWS:
        raise AssertionError(f"{label}: only {share:.6f} of neighbour sets "
                             f"agree")
    same = (idx == ref_idx).all(-1)
    order = same.float().mean().item()
    if k <= 32 and order < EC_ROWS:
        raise AssertionError(f"{label}: idx equals the twin's on only "
                             f"{order:.6f} of rows")
    if k > 32:
        from gfs3dseg_gws_tpu_torch.ops.knn import pairwise_sq_dists

        for b, i in (row_ok & ~same).nonzero().tolist():
            d2 = pairwise_sq_dists(x[b, i:i + 1], x[b])[0]
            got, want = d2[idx[b, i].long()], d2[ref_idx[b, i].long()]
            if (got - want).abs().max() > TIE_RTOL * want.max():
                raise AssertionError(f"{label}: row ({b},{i}) is ordered "
                                     "otherwise than the twin's without a "
                                     "near-tie")
    bad = (~row_ok).nonzero().tolist()
    near_tie_rows(x, bad, label, k=k)
    return share, order, bad


def check_knn_indices(dev, c: int, gen: torch.Generator, k: int = K,
                      b: int = B, reps: int = 20):
    """K6 against knn_indices_plain at (b, N, c), k, by the rule of K3
    (graph_agreement). Its max_abs_err is the largest difference between
    the plain squared distances of the kernel's neighbours and the twin's,
    slot by slot (0 where the graphs agree)."""
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices,
                                                knn_indices_plain)

    x = torch.randn((b, N, c), generator=gen).to(dev)
    idx = knn_indices(x, k)
    ref = knn_indices_plain(x, k)
    h = N // 2           # local queries: the second half against every key
    idx_local = knn_indices(x, k, h, N - h)
    torch.cuda.synchronize()
    label = f"K6 knn_indices ({b},{N},{c}) k={k}"
    if not torch.equal(idx_local, idx[:, h:]):
        raise AssertionError(f"{label}: local queries differ from the full "
                             "call's rows")
    share, order, bad = graph_agreement(x, idx, ref, label, k)
    max_err = slot_dist_err(x, idx, ref)
    ms = cuda_ms(lambda: knn_indices(x, k), reps)
    local_ms = cuda_ms(lambda: knn_indices(x, k, h, N - h), reps)
    plain_ms = cuda_ms(lambda: knn_indices_plain(x, k), reps)
    # FMAs: the kNN distances (b N^2 c)
    bound_ms, bound_by = bound(2.0 * b * N * N * c, size_of(x, idx))
    phase(label, sets_agree=share,
          order_agree=order, near_tie_rows=len(bad), max_abs_err=max_err,
          kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
          local_queries="rows of the full call, bit for bit",
          local_ms=local_ms)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                local_ms=local_ms)


def slot_dist_err(x, idx, ref) -> float:
    """The largest difference between the plain squared distances of two
    kNN graphs' neighbours, slot by slot (0 where they agree)."""
    from gfs3dseg_gws_tpu_torch.ops.knn import pairwise_sq_dists

    d2 = pairwise_sq_dists(x, x)
    return (d2.gather(-1, idx.long()) - d2.gather(-1, ref.long())
            ).abs().max().item()


def copied_block(n=2048, c=9, copies=548, seed=0):
    """(1, n, c) standard-normal points, `copies` rows replaced by copies of
    earlier rows: many queries meet keys at exactly equal distances."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((1, n, c)).astype(np.float32)
    for i in np.sort(r.choice(np.arange(1, n), copies, replace=False)):
        x[0, i] = x[0, r.integers(0, i)]
    return x


def check_knn_ties(dev, gen: torch.Generator, cb: int = 64):
    """The fast path's kNN stage (knn_split_kernel: K6, K3 and K1's first
    stage) on B blocks of copied points (copied_block, seeds 0 .. B-1) at
    C = 9 and 64: K3's and K8's idx equal K6's bit for bit (K8: the same
    distances, another selection), and K1's out equals K9 on K6's idx bit
    for bit (so K1's own graph is K6's). At C = 9 K6's idx equals the
    twin's on every row, order included; at C = 64, where the twin's
    cuBLAS distances round otherwise than the kernel's fmaf chains and
    near-ties between distinct points occur, by graph_agreement. Then K6 at
    C = 12 (its own CP) and a ragged N: K8's idx bit for bit, the twin's
    by graph_agreement."""
    from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (
        fused_edgeconv_infer, gather_conv)
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices,
                                                knn_indices_fold,
                                                knn_indices_plain,
                                                knn_with_stats)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    tables = (randn(B, N, 64), randn(B, N, 64), randn(64, 64, scale=0.125),
              randn(64, scale=0.1))
    btab = randn(B, N, cb)
    agree = {}
    for c in (9, 64):
        x = torch.from_numpy(np.concatenate(
            [copied_block(c=c, seed=i) for i in range(B)])).to(dev)
        label = f"kNN on copied points ({B},{N},{c}) k={K}"
        twin = knn_indices_plain(x, K)
        idx6 = knn_indices(x, K)
        idx3 = knn_with_stats(x, btab, K)[0]
        idx8 = knn_indices_fold(x, K, 4)
        k1 = fused_edgeconv_infer(x, *tables, K)
        k9 = gather_conv(idx6, *tables)
        torch.cuda.synchronize()
        for name, idx in (("K3", idx3), ("K8", idx8)):
            if not torch.equal(idx, idx6):
                rows = int((idx != idx6).any(-1).sum())
                raise AssertionError(f"{label}: {name} differs from K6 on "
                                     f"{rows} rows")
        if not torch.equal(k1, k9):
            raise AssertionError(f"{label}: K1 differs from K9 on K6's "
                                 "graph")
        if c == 9 and not torch.equal(idx6, twin):
            rows = int((idx6 != twin).any(-1).sum())
            raise AssertionError(f"{label}: K6 differs from the twin on "
                                 f"{rows} rows")
        agree[c] = graph_agreement(x, idx6, twin, label)[:2]
        del x, twin, idx6, idx3, idx8, k1, k9
    ragged = randn(B, N - 37, 12)
    label12 = f"K6 knn_indices ({B},{N - 37},12) k={K}"
    idx = knn_indices(ragged, K)
    if not torch.equal(idx, knn_indices_fold(ragged, K, 4)):
        raise AssertionError(f"{label12}: differs from K8")
    share, order, bad = graph_agreement(ragged, idx, knn_indices_plain(
        ragged, K), label12)
    phase(f"kNN on copied points ({B},{N},9 and 64) k={K}",
          k3_k8_equal_k6="bit for bit", k1_equals_k9_on_k6="bit for bit",
          c9_k6_equals_twin="every row, order included",
          c64_k6_twin_sets_and_order_agree=agree[64],
          c12_ragged_sets_agree=share,
          c12_ragged_order_agree=order, c12_ragged_near_tie_rows=len(bad),
          c12_ragged_equals_k8="bit for bit")


def check_scatter(dev, gen: torch.Generator, c: int = 64, reps: int = 20):
    """K7 against scatter_bwd_plain at g (B, N, K, c) on the graph K6
    builds on (B, N, c) features, within K7_TOL of the largest entry (float
    atomics); then the gather Function's gradient against autograd through
    gather_neighbors_plain on the card, likewise. Library: one index_add_
    of the flattened g into the flattened (B*N, c) table, which the port
    never calls. Prints the kernel's share of its bytes bound."""
    from gfs3dseg_gws_tpu_torch.ops.edgeconv import (_flat_rows,
                                                     gather_neighbors,
                                                     gather_neighbors_plain,
                                                     scatter_bwd,
                                                     scatter_bwd_plain)
    from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices

    x = torch.randn((B, N, c), generator=gen).to(dev)
    idx = knn_indices(x, K)
    g = torch.randn((B, N, K, c), generator=gen).to(dev)
    got = scatter_bwd(idx, g)
    ref = scatter_bwd_plain(idx, g)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    grads = []
    for fn in (gather_neighbors, gather_neighbors_plain):
        leaf = x.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(leaf, idx), leaf, g)[0])
    fn_err = rel_err(*grads)
    if err > K7_TOL or fn_err > K7_TOL:
        raise AssertionError(f"K7 off its twin by {err}, the gather "
                             f"Function's gradient by {fn_err}")
    max_err = (got - ref).abs().max().item()
    flat, gflat = _flat_rows(idx, N), g.reshape(-1, c)
    table = torch.zeros((B * N, c), device=dev)
    ms = cuda_ms(lambda: scatter_bwd(idx, g), reps)
    plain_ms = cuda_ms(lambda: scatter_bwd_plain(idx, g), reps)
    library_ms = cuda_ms(lambda: table.index_add_(0, flat, gflat), reps)
    # B N K c adds; g and idx read, dx written
    bound_ms, bound_by = bound(float(g.numel()), size_of(idx, g, got))
    phase(f"K7 gather_neighbors backward ({B},{N},{K},{c})", rel_err=err,
          function_grad_rel_err=fn_err, max_abs_err=max_err, kernel_ms=ms,
          plain_ms=plain_ms, index_add_ms=library_ms, bound_ms=bound_ms,
          share_of_bound=bound_ms / ms)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_gather_conv(dev, gen: torch.Generator, cs=(9, 64), w0: int = 64,
                      w1: int = 64, k: int = K, b: int = B, reps: int = 20):
    """K9 against gather_conv_plain at (b, N, w0 -> w1), k, on K6's
    indices (the same graph for both: within EC_TOL everywhere); then the
    split EdgeConv (K6 then K9) against K1 at each C of `cs`, bit for
    bit."""
    from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (
        fused_edgeconv_infer, fused_edgeconv_infer_split, gather_conv,
        gather_conv_plain)
    from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    tables = (randn(b, N, w0), randn(b, N, w0),
              randn(w0, w1, scale=w0 ** -0.5), randn(w1, scale=0.1))
    for c in cs:
        x = randn(b, N, c)
        split = fused_edgeconv_infer_split(x, *tables, k)
        fused = fused_edgeconv_infer(x, *tables, k)
        torch.cuda.synchronize()
        if not torch.equal(split, fused):
            raise AssertionError(f"K6 -> K9 differs from K1 at C={c} by "
                                 f"{(split - fused).abs().max().item()}")
    idx = knn_indices(x, k)
    got = gather_conv(idx, *tables)
    ref = gather_conv_plain(idx, *tables)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=EC_TOL[0], rtol=EC_TOL[1])
    max_err = (got - ref).abs().max().item()
    ms = cuda_ms(lambda: gather_conv(idx, *tables), reps)
    plain_ms = cuda_ms(lambda: gather_conv_plain(idx, *tables), reps)
    # FMAs: the edge layer (b N k w0 x w1), 3xTF32 on the tensor cores up
    # to W0, W1 = 64, fp32 past them
    flops, nbytes = 2.0 * b * N * k * w0 * w1, size_of(idx, *tables, got)
    bound_ms, bound_by = bound(flops, nbytes, tf32x3=max(w0, w1) <= 64)
    fp32_ms = bound(flops, nbytes)[0]
    phase(f"K9 gather_conv ({b},{N},{w0}->{w1}) k={k}", max_abs_err=max_err,
          split_equals_k1=f"bit for bit at C={cs}", kernel_ms=ms,
          plain_ms=plain_ms, bound_ms=bound_ms, bound_fp32_ms=fp32_ms)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                bound_fp32_ms=fp32_ms)


def check_knn_stats(dev, c: int, gen: torch.Generator, k: int = K,
                    b: int = B, cb: int = 64, reps: int = 20):
    """K3 against knn_with_stats_plain at (b, N, c), k, btab (b, N, cb):
    idx equal to the twin's, order included, on >= EC_ROWS of the rows;
    each row whose neighbour set differs must be a near-tie at the k-th
    distance. cnt/scb against the plain statistics of the kernel's own idx
    (cnt exact, scb within STATS_TOL)."""
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_with_stats,
                                                knn_with_stats_plain,
                                                neighbor_stats_plain)

    x = torch.randn((b, N, c), generator=gen).to(dev)
    btab = torch.randn((b, N, cb), generator=gen).to(dev)
    idx, cnt, scb = knn_with_stats(x, btab, k)
    ref_idx = knn_with_stats_plain(x, btab, k)[0]
    torch.cuda.synchronize()
    label = f"K3 knn_with_stats ({b},{N},{c}) k={k} cb={cb}"
    share, order, bad = graph_agreement(x, idx, ref_idx, label, k)
    ref_cnt, ref_scb = neighbor_stats_plain(idx, btab)
    if not torch.equal(cnt, ref_cnt):
        raise AssertionError(f"{label}: cnt differs from the plain count")
    err = rel_err(scb, ref_scb)
    if err > STATS_TOL:
        raise AssertionError(f"{label}: scb off by {err} (> {STATS_TOL})")
    max_err = (scb - ref_scb).abs().max().item()
    ms = cuda_ms(lambda: knn_with_stats(x, btab, k), reps)
    plain_ms = cuda_ms(lambda: knn_with_stats_plain(x, btab, k), reps)
    # FMAs: the kNN distances (b N^2 c); the scatter's b N k cb adds
    bound_ms, bound_by = bound(2.0 * b * N * N * c + b * N * k * cb,
                               size_of(x, btab, idx, cnt, scb))
    phase(label, sets_agree=share,
          order_agree=order,
          near_tie_rows=len(bad), scb_rel_err=err, max_abs_err=max_err,
          kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_fused_train(dev, gen: torch.Generator, b: int = B, c: int = 64,
                      w1: int = 64, k: int = K, reps: int = 20,
                      composite_times: bool = True, timing: bool = True,
                      draw: str = "in place"):
    """K4a/K4b at (b, N, c -> w1), k, on an idx from the plain kNN, inputs
    drawn from `gen`.

    The autograd Function (the kernels) against the unfused composition:
    forward and its four batch statistics. Then each stage against its
    plain twin on the same inputs: K4a at the forward's bn1 affine (values;
    max/min slots on >= EC_ROWS of the (point, channel) pairs: a slot may
    differ where two neighbours' z1 agree to rounding), and again on the
    offset input of `k4a_offset_affine` against the twin in fp64 (values,
    within FWD_TOL, which a Gram matrix in single TF32 misses: its
    rounding averages out at the draw above), K4b on K4a's slots
    (the twin's LeakyReLU branch by the exact sign of the pre-activation,
    as the kernel's fmaf gives it; the edges where two roundings would flip
    it are counted), and again with c2 100 times larger, where the
    recomputed z1 weighs in dz1 as much as the cotangent, within K4B_Z1_TOL
    (a z1 in single TF32 misses it: tests/test_torch_port_split_tf32.py).
    K4a's max_abs_err takes its bn2 sums (sum(h1) and the Gram matrix;
    past C, W1 = 64 sum z1 and sum z1^2) per edge, as the bn2 statistics
    use them. Then the seven gradients of one random cotangent through the
    whole Function, max |diff| / max |ref| <= GRAD_TOL, against the
    composition's when both runs select the same neighbour at every (point,
    channel) - the Function's slot (K4a's max or min slot by the sign of
    the bn2 scale, at its own statistics) and the composition's argmax over
    k (at its own statistics, which round otherwise). Where some differ,
    each such neighbour must be a near-tie (its value below the max there
    by at most FWD_TOL of the composition's largest output), and the
    reference is the composition taking the Function's neighbours instead
    of its argmax, as the card-vs-CPU checks replay the card's kNN graphs:
    one (point, channel) sent to another edge moves the gradient of `a` by
    4-7e-4 in relative L2 at (16, 2048, 128 -> 128), k = 40. One bn2 scale
    in eight is negative, so the min branch runs. With `timing`, K4a and
    K4b are timed (else None is returned), and with `composite_times` the
    whole Function and the composition too."""
    from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet
    from gfs3dseg_gws_tpu_torch.ops.edgeconv import gather_neighbors_plain
    from gfs3dseg_gws_tpu_torch.ops.knn import knn_with_stats_plain

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)

    x, a, bt = randn(b, N, c), randn(b, N, c), randn(b, N, c)
    g1, be1 = randn(c, scale=0.2, shift=1.0), randn(c, scale=0.2)
    w2 = randn(c, w1, scale=c ** -0.5)
    g2 = randn(w1, scale=0.2, shift=1.0) * torch.tensor(
        [-1.0 if i % 8 == 0 else 1.0 for i in range(w1)], device=dev)
    be2 = randn(w1, scale=0.2)
    idx, cnt, scb = knn_with_stats_plain(x, bt, k)
    cot = randn(b, N, w1)
    params = [a, bt, g1, be1, w2, g2, be2]
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

    # K4a against its twin at the forward's bn1 affine, as the Function
    # forms it
    _, mu1, var1, mu2, var2 = f_outs
    s1, t1, inv1 = fet._affines(g1, be1, mu1, var1)
    gsf_args = (a, bt, idx, s1, t1, w2, 0.2)
    got, ref = fet._gsf(*gsf_args), fet._gsf_plain(*gsf_args)
    torch.cuda.synchronize()
    values = [0, 1, 2, 5]              # snbr, zmax, zmin, the bn2 sums
    k4a_err = max(rel_err(got[i], ref[i]) for i in values)
    # the sums over all b*N*k edges as the glue uses them: per edge
    per_edge = {5: 1.0 / idx.numel()}
    k4a_abs = max((got[i] - ref[i]).abs().max().item() * per_edge.get(i, 1.0)
                  for i in values)
    slots_ok = ((got[3] == ref[3]) & (got[4] == ref[4])).float().mean().item()
    flips = round((1.0 - slots_ok) * got[3].numel())
    if k4a_err > FWD_TOL or slots_ok < EC_ROWS:
        raise AssertionError(f"K4a off its twin: values {k4a_err}, slots "
                             f"{slots_ok}")
    # K4a on the offset input (h1 one value a channel, k4a_offset_affine),
    # where every edge row rounds the same way: a Gram matrix in single
    # TF32 misses FWD_TOL there (5.8e-4 at (2, 200, 64 -> 64) on the CPU)
    # while at the draw above its rounding averages out. Held against the
    # twin in fp64 (values only: z1 differs between slots by ~1e-5 of
    # itself there, near-ties for any rounding)
    off_args = (a, bt, idx, *(torch.from_numpy(v).to(dev) for v in
                              k4a_offset_affine(np.random.default_rng(SEED),
                                                c)), w2, 0.2)
    got_o = fet._gsf(*off_args)
    ref_o = fet._gsf_plain(*(x.double() if x.is_floating_point() else x
                             for x in off_args[:6]), 0.2)
    torch.cuda.synchronize()
    k4a_offset_err = max(rel_err(got_o[i], ref_o[i]) for i in values)
    del got_o, ref_o
    if k4a_offset_err > FWD_TOL:
        raise AssertionError(f"K4a on the offset input off its fp64 twin "
                             f"by {k4a_offset_err} (> {FWD_TOL})")

    # K4b against its twin on K4a's slots
    inv2 = torch.rsqrt(var2 + fet.EPS)
    gsel = randn(b, N, w1)
    p1 = torch.stack([s1, t1, mu1, inv1, g1 * inv1])
    pk = torch.stack([g2 * inv2, gsel.mean((0, 1)), randn(w1, scale=0.01),
                      mu2, inv2])
    bwd_args = (a, bt, idx, p1, w2, gsel, got[3], pk, 0.2)
    got_b, ref_b = fet._bwd(*bwd_args), fet._bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    # edges whose bn1 pre-activation lies so near 0 that two roundings give
    # it the other sign than one: the twin takes the exact sign's branch
    e0 = gather_neighbors_plain(a, idx) + bt[:, :, None, :]
    branch_ties = int(((e0 * s1 + t1 >= 0) != (
        e0.double() * s1.double() + t1.double() >= 0)).sum())
    del e0
    k4b_err = max(rel_err(g, r) for g, r in zip(got_b, ref_b))
    k4b_abs = max((g - r).abs().max().item() for g, r in zip(got_b, ref_b))
    if k4b_err > GRAD_TOL:
        raise AssertionError(f"K4b off its twin by {k4b_err}")
    # the same at c2 ~ N(0, 1), where (z1 - mu2) inv2 c2 weighs in dz1 as
    # much as the dy2 term (no new draw: c2 above is 0.01 N(0, 1)): K4b's
    # z1 must be fp32-accurate, as 3xTF32 is and single TF32 is not
    pk_z1 = pk.clone()
    pk_z1[2] *= 100.0
    z1_args = (*bwd_args[:7], pk_z1, 0.2)
    got_z, ref_z = fet._bwd(*z1_args), fet._bwd_plain(*z1_args)
    torch.cuda.synchronize()
    k4b_z1_err = max(rel_err(g, r) for g, r in zip(got_z, ref_z))
    del got_z, ref_z
    if k4b_z1_err > K4B_Z1_TOL:
        raise AssertionError(f"K4b at c2 ~ N(0, 1) off its twin by "
                             f"{k4b_z1_err} (> {K4B_Z1_TOL})")

    # the neighbour each whole run sends a (point, channel)'s gradient to:
    # the Function's slot (K4a's, by the sign of its bn2 scale) and the
    # composition's argmax over k, each at its own statistics
    ksel = torch.where(g2 * inv2 > 0, got[3], got[4]).long()
    with torch.no_grad():
        h2 = fet.train_plain_edges(*params, idx)[0]
        top = h2.amax(2)
        flipped = h2.argmax(2) != ksel
        gap = (top - h2.gather(2, ksel[:, :, None])[:, :, 0])[flipped]
    run_flips = int(flipped.sum())
    del h2
    label = f"K4 fused_edgeconv_train ({b},{N},{c}->{w1}) k={k}"
    if (gap > FWD_TOL * top.abs().max()).any():
        raise AssertionError(f"{label}: the Function selects a neighbour "
                             "that is not a near-tie of the composition's "
                             "max")

    # the gradients through the whole Function: against the composition,
    # or where the runs select different neighbours (near-ties, each moving
    # a whole (point, channel)'s gradient to another edge), against the
    # composition sending each to the Function's neighbour
    def on_slots(*ins):
        h2, *stats = fet.train_plain_edges(*ins)
        return (h2.gather(2, ksel[:, :, None])[:, :, 0], *stats)

    ref_grads = p_grads if run_flips == 0 else run(on_slots)[1]
    grad_errs = {n: rel_err(f, r) for n, f, r in zip(names, f_grads,
                                                      ref_grads)}
    worst = max(grad_errs, key=grad_errs.get)
    grads = dict(
        draw=draw, slot_flips=flips, k4b_branch_ties=branch_ties,
        run_slot_flips=run_flips,
        grad_measure=("max_abs_ratio" if run_flips == 0 else
                      "max_abs_ratio on the Function's neighbours"),
        worst_grad=worst, worst_grad_err=grad_errs[worst],
        free_run_worst_rel_l2=max(
            ((f - p).norm() / p.norm().clamp_min(1e-30)).item()
            for f, p in zip(f_grads, p_grads)))
    if grad_errs[worst] > GRAD_TOL:
        raise AssertionError(f"{label}: gradient of {worst} off the plain "
                             f"version by {grad_errs[worst]} ({grads})")
    if not timing:
        phase(label, forward_rel_err=out_err, k4a_rel_err=k4a_err,
              slots_agree=slots_ok, k4a_offset_rel_err=k4a_offset_err,
              k4b_rel_err=k4b_err, k4b_z1_rel_err=k4b_z1_err, **grads)
        return None

    def fwd(fn, **kw):
        with torch.no_grad():
            fn(*params, idx, **kw)

    times = dict(
        k4a_ms=cuda_ms(lambda: fet._gsf(*gsf_args), reps),
        k4a_plain_ms=cuda_ms(lambda: fet._gsf_plain(*gsf_args), reps),
        k4b_ms=cuda_ms(lambda: fet._bwd(*bwd_args), reps),
        k4b_plain_ms=cuda_ms(lambda: fet._bwd_plain(*bwd_args), reps))
    if composite_times:
        times.update(
            fwd_ms=cuda_ms(lambda: fwd(fet.fused_edgeconv_train, cnt=cnt,
                                       scb=scb)),
            fwd_plain_ms=cuda_ms(lambda: fwd(
                fet.fused_edgeconv_train_plain)),
            fwd_bwd_ms=cuda_ms(lambda: run(fet.fused_edgeconv_train,
                                           cnt=cnt, scb=scb)),
            fwd_bwd_plain_ms=cuda_ms(lambda: run(
                fet.fused_edgeconv_train_plain)))
    # FMAs per edge (b N k of them): K4a z1 (c x w1) and the Gram matrix,
    # which is symmetric, so c (c + 1) / 2 of its entries (past the fast
    # path: z1 and its square, 2 w1 more); K4b c x w1 each for dz1 -> dh1,
    # dW2 and the recomputed z1. Up to C, W1 = 64 K4a's bound takes both its
    # products in 3xTF32 on the tensor cores, as it runs them, and K4b's its
    # three (fp32-accurate, as its z1 already runs), past them in fp32; the
    # all-fp32 bound beside each
    edges = b * N * k
    fast = max(c, w1) <= 64
    gram = c * (c + 1) // 2 if fast else w1
    k4a_flops = 2.0 * edges * (c * w1 + gram)
    k4a_bytes = size_of(*gsf_args[:6], *got)
    k4a_bound = bound(k4a_flops, k4a_bytes, tf32x3=fast)
    k4a_fp32_ms = bound(k4a_flops, k4a_bytes)[0]
    k4b_flops = 3 * 2.0 * edges * c * w1
    k4b_bytes = size_of(*bwd_args[:8], *got_b)
    k4b_bound = bound(k4b_flops, k4b_bytes, tf32x3=fast)
    k4b_fp32_ms = bound(k4b_flops, k4b_bytes)[0]
    phase(label, forward_rel_err=out_err, k4a_rel_err=k4a_err,
          slots_agree=slots_ok, k4a_offset_rel_err=k4a_offset_err,
          k4b_rel_err=k4b_err, k4b_z1_rel_err=k4b_z1_err, **grads,
          k4a_bound_ms=k4a_bound[0], k4a_bound_fp32_ms=k4a_fp32_ms,
          k4b_bound_ms=k4b_bound[0], k4b_bound_fp32_ms=k4b_fp32_ms, **times)
    return (dict(max_abs_err=k4a_abs, ms=times["k4a_ms"],
                 plain_ms=times["k4a_plain_ms"], bound_ms=k4a_bound[0],
                 bound_by=k4a_bound[1], library_ms=None,
                 bound_fp32_ms=k4a_fp32_ms),
            dict(max_abs_err=k4b_abs, ms=times["k4b_ms"],
                 plain_ms=times["k4b_plain_ms"], bound_ms=k4b_bound[0],
                 bound_by=k4b_bound[1], library_ms=None,
                 bound_fp32_ms=k4b_fp32_ms))


def check_attention_train(dev, gen: torch.Generator, d: int = 64,
                          reps: int = 20):
    """K5a/K5b against their plain twins at (B, N, d), rates ATTN_RATE and
    0. The twins draw the kernels' dropout mask bit for bit, so out, m, den
    (K5a) and dq, dk, dv (K5b, on the twin's m, den and Delta) are held to
    K5_FWD_TOL / K5_BWD_TOL of the twin's largest entry, and so are dq, dk,
    dv of the card's chain (K5b on K5a's m, den and out) against the twins'
    chain; the same at ATTN_RATE with batch_offset K5_OFFSET (the mask of
    a data-parallel rank's rows); the keep share must lie within 5 sigma
    of 1 - rate. Times at
    ATTN_RATE, the main path's; beside them, as a yardstick only, fp32
    scaled_dot_product_attention forward and backward at dropout 0 (the
    port never calls it)."""
    from gfs3dseg_gws_tpu_torch.ops import attention_train as atr

    q, k, v, dy = (torch.randn((B, N, d), generator=gen).to(dev)
                   for _ in range(4))
    seed = torch.tensor([SEED + 77], dtype=torch.int32, device=dev)
    temp = d ** 0.5
    errs = {}
    for rate, off in ((0.0, 0), (ATTN_RATE, 0), (ATTN_RATE, K5_OFFSET)):
        got = atr._fwd(q, k, v, seed, temp, rate, off)
        ref = atr._fwd_plain(q, k, v, seed, temp, rate, off)
        delta = (dy * ref[0]).sum(-1)
        bwd_args = (q, k, v, seed, ref[1], ref[2], delta, dy, temp, rate,
                    off)
        got_b, ref_b = atr._bwd(*bwd_args), atr._bwd_plain(*bwd_args)
        chain = atr._bwd(q, k, v, seed, got[1], got[2],
                         (dy * got[0]).sum(-1), dy, temp, rate, off)
        torch.cuda.synchronize()
        key = rate if off == 0 else "offset"
        errs[key] = dict(
            fwd=max(rel_err(g, r) for g, r in zip(got, ref)),
            bwd=max(rel_err(g, r) for g, r in zip(got_b, ref_b)),
            chain=max(rel_err(g, r) for g, r in zip(chain, ref_b)),
            fwd_abs=(got[0] - ref[0]).abs().max().item(),
            bwd_abs=max((g - r).abs().max().item()
                        for g, r in zip(got_b, ref_b)))
        if (errs[key]["fwd"] > K5_FWD_TOL or errs[key]["bwd"] > K5_BWD_TOL
                or errs[key]["chain"] > K5_BWD_TOL):
            raise AssertionError(f"K5 at rate {rate}, batch_offset {off} "
                                 f"off its twin: {errs[key]}")
        del got, ref, got_b, ref_b, chain
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
        k5a_ms=cuda_ms(lambda: atr._fwd(q, k, v, seed, temp, ATTN_RATE),
                       reps),
        k5a_plain_ms=cuda_ms(lambda: atr._fwd_plain(q, k, v, seed, temp,
                                                    ATTN_RATE), reps),
        k5b_ms=cuda_ms(lambda: atr._bwd(*bwd_args), reps),
        k5b_plain_ms=cuda_ms(lambda: atr._bwd_plain(*bwd_args), reps),
        sdpa_fwd_ms=cuda_ms(lambda: sdpa(q, k, v), reps),
        sdpa_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dy, retain_graph=True), reps))
    # FMAs: K5a S and A.V (2 B N^2 D); K5b S, dA, dv, dk, dq (5 B N^2 D);
    # both 3xTF32 on the tensor cores up to D = 128, fp32 past it
    k5a_args = (2.0 * 2 * B * N * N * d,
                size_of(q, k, v, seed, out, m, den))
    k5a_bound = bound(*k5a_args, tf32x3=d <= 128)
    k5a_fp32 = bound(*k5a_args)[0]
    k5b_args = (2.0 * 5 * B * N * N * d,
                size_of(q, k, v, seed, m, den, delta, dy, dq, dk, dv))
    k5b_bound = bound(*k5b_args, tf32x3=d <= 128)
    k5b_fp32 = bound(*k5b_args)[0]
    phase(f"K5 attention_train ({B},{N},{d}) rate={ATTN_RATE}",
          k5a_rel_err=errs[ATTN_RATE]["fwd"],
          k5b_rel_err=errs[ATTN_RATE]["bwd"],
          k5_chain_rel_err=errs[ATTN_RATE]["chain"],
          k5a_rel_err_rate0=errs[0.0]["fwd"],
          k5b_rel_err_rate0=errs[0.0]["bwd"],
          k5_chain_rel_err_rate0=errs[0.0]["chain"],
          k5a_rel_err_offset=errs["offset"]["fwd"],
          k5b_rel_err_offset=errs["offset"]["bwd"],
          k5_chain_rel_err_offset=errs["offset"]["chain"],
          batch_offset=K5_OFFSET, keep_share=share,
          keep_sigma=sigma, k5a_bound_ms=k5a_bound[0],
          k5a_bound_fp32_ms=k5a_fp32, k5b_bound_ms=k5b_bound[0],
          k5b_bound_fp32_ms=k5b_fp32, **times)
    return (dict(max_abs_err=errs[ATTN_RATE]["fwd_abs"], ms=times["k5a_ms"],
                 plain_ms=times["k5a_plain_ms"], bound_ms=k5a_bound[0],
                 bound_by=k5a_bound[1], library_ms=times["sdpa_fwd_ms"],
                 bound_fp32_ms=k5a_fp32),
            dict(max_abs_err=errs[ATTN_RATE]["bwd_abs"], ms=times["k5b_ms"],
                 plain_ms=times["k5b_plain_ms"], bound_ms=k5b_bound[0],
                 bound_by=k5b_bound[1], library_ms=times["sdpa_bwd_ms"],
                 bound_fp32_ms=k5b_fp32))


def check_knn_fold(dev, c: int, gen: torch.Generator):
    """K8 (knn_indices_fold) at (B, N, c): at k = K and k = CLASS_K with
    each of K8_FOLDS, and at a ragged N, its indices equal K6's bit for
    bit (K6 there runs its own selection on the same distance code, ties
    to the lower index); at k = kcap (the streaming selection's cap, read
    from the library, which K6 shares past k = 64) and kcap + 1 (the
    fold-merge tournament, folds 2 and 8 against K6's 4) on BIG_B blocks,
    likewise.
    Every graph against the twin (the JAX tournament in torch, on the card)
    by the rule of K6 (graph_agreement). Times: folds 2 and 4 at k = K
    beside K6 in this call, k = BIG_K on (BIG_B, N, c) with its own bound;
    the twin at folds 4. Bound as K6's: the B N^2 c distance FMAs."""
    from gfs3dseg_gws_tpu_torch.ops._ext import knn_stream_cap
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices,
                                                knn_indices_fold,
                                                knn_indices_fold_plain)

    x = torch.randn((B, N, c), generator=gen).to(dev)
    ragged = x[:, :N - 37].contiguous()
    few = x[:BIG_B].contiguous()
    kcap = knn_stream_cap()
    max_err, agree = 0.0, {}
    for k, folds, pts in ([(k, f, x) for k in (K, CLASS_K)
                           for f in K8_FOLDS] + [(K, 4, ragged)] +
                          [(kcap, 4, few), (kcap + 1, 2, few),
                           (kcap + 1, 8, few)]):
        idx = knn_indices_fold(pts, k, folds)
        k6 = knn_indices(pts, k)
        torch.cuda.synchronize()
        label = (f"K8 ({pts.shape[0]},{pts.shape[1]},{c}) k={k} "
                 f"folds={folds}")
        if not torch.equal(idx, k6):
            rows = int((idx != k6).any(-1).sum())
            raise AssertionError(f"{label}: differs from K6 on {rows} rows")
        twin = knn_indices_fold_plain(pts, k, folds)
        share, order, _ = graph_agreement(pts, idx, twin, label, k)
        agree[f"k{k}_f{folds}_b{pts.shape[0]}_n{pts.shape[1]}"] = (share,
                                                                   order)
        max_err = max(max_err, slot_dist_err(pts, idx, twin))
        del idx, k6, twin
    times = {f"k8_folds{f}_ms": cuda_ms(lambda f=f: knn_indices_fold(x, K, f))
             for f in (2, 4)}
    times["k6_ms"] = cuda_ms(lambda: knn_indices(x, K))
    times["k8_k80_ms"] = cuda_ms(lambda: knn_indices_fold(few, BIG_K, 4))
    times["k6_k80_ms"] = cuda_ms(lambda: knn_indices(few, BIG_K))
    plain_ms = cuda_ms(lambda: knn_indices_fold_plain(x, K, 4), WIDE_REPS)
    bound_ms, bound_by = bound(2.0 * B * N * N * c,
                               size_of(x) + B * N * K * 4)
    k80_bound = bound(2.0 * BIG_B * N * N * c,
                      size_of(few) + BIG_B * N * BIG_K * 4)[0]
    phase(f"K8 knn_indices_fold ({B},{N},{c}) k={K}",
          equals_k6=("bit for bit, folds 2/4/8 at k=20 and 40, ragged N, "
                     f"k={kcap} and {kcap + 1}"), kcap=kcap,
          twin_sets_and_order_agree=json.dumps(agree), max_abs_err=max_err,
          plain_ms=plain_ms, bound_ms=bound_ms,
          share_of_bound=bound_ms / times["k8_folds4_ms"],
          k80_bound_ms=k80_bound, **times)
    return dict(max_abs_err=max_err, ms=times["k8_folds4_ms"],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, folds2_ms=times["k8_folds2_ms"],
                k6_same_call_ms=times["k6_ms"], k80_ms=times["k8_k80_ms"])


def check_wide_kernels(dev, gen: torch.Generator):
    """Every kernel past the fast path, held to its twin as at the model's
    widths: K1, K3, K6, K9 and K4 at C = W = WIDE_C, k = WIDE_K (K4 also on
    the inputs of each seed of K4_DRAWS); K7 at C =
    256 (the classification encoder's widest gather); K1, K3, K6 and K4 at
    k = BIG_K (K8's streaming selection for the kNN stage), batch BIG_B,
    with ragged 64-column tiles; K2 and K5 (rates ATTN_RATE and 0) at each
    D of WIDE_D. Returns each kernel's numbers at the first of these
    shapes."""
    wc, wk = WIDE_C, WIDE_K
    wide = {
        "k1": check_edgeconv(dev, wc, gen, wc, wc, wk, reps=WIDE_REPS),
        "k3": check_knn_stats(dev, wc, gen, wk, cb=wc, reps=WIDE_REPS),
        "k6": check_knn_indices(dev, wc, gen, wk, reps=WIDE_REPS),
        "k7": check_scatter(dev, gen, 256, reps=WIDE_REPS),
        "k9": check_gather_conv(dev, gen, (9, wc), wc, wc, wk,
                                reps=WIDE_REPS)}
    wide["k4a"], wide["k4b"] = check_fused_train(
        dev, gen, c=wc, w1=wc, k=wk, reps=WIDE_REPS, composite_times=False)
    # the gradient check's margin moves with its inputs: more draws, each
    # from a generator of its own, whatever ran before
    for seed in K4_DRAWS:
        check_fused_train(dev, torch.Generator().manual_seed(seed), c=wc,
                          w1=wc, k=wk, timing=False, draw=f"seed {seed}")
    check_edgeconv(dev, 9, gen, 72, 130, BIG_K, b=BIG_B, reps=WIDE_REPS)
    check_knn_stats(dev, 64, gen, BIG_K, b=BIG_B, reps=WIDE_REPS)
    check_knn_indices(dev, 64, gen, BIG_K, b=BIG_B, reps=WIDE_REPS)
    check_gather_conv(dev, gen, (9,), 72, 130, BIG_K, b=BIG_B,
                      reps=WIDE_REPS)
    check_fused_train(dev, gen, b=BIG_B, c=72, w1=130, k=BIG_K,
                      reps=WIDE_REPS, composite_times=False)
    for d in WIDE_D:
        k2 = check_attention(dev, gen, d, reps=WIDE_REPS)
        k5 = check_attention_train(dev, gen, d, reps=WIDE_REPS)
        if d == 128:
            wide["k2"], (wide["k5a"], wide["k5b"]) = k2, k5
    check_long_rows(dev, gen)
    shapes = {"k1": f"({B},{N},{wc}->{wc}->{wc}) k={wk}",
              "k3": f"({B},{N},{wc}) cb={wc} k={wk}",
              "k6": f"({B},{N},{wc}) k={wk}",
              "k7": f"({B},{N},{K},256)",
              "k9": f"({B},{N},{wc}->{wc}) k={wk}",
              "k4a": f"({B},{N},{wc}->{wc}) k={wk}",
              "k4b": f"({B},{N},{wc}->{wc}) k={wk}",
              "k2": f"({B},{N},128)",
              "k5a": f"({B},{N},128) rate={ATTN_RATE}",
              "k5b": f"({B},{N},128) rate={ATTN_RATE}"}
    return {key: dict(shape=shapes[key], **{
        name: val for name, val in st.items()
        if name in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_fp32_ms", "library_ms")})
        for key, st in wide.items()}


def knn_plain_by_rows(x, k, rows=2048):
    """knn_indices_plain's rule (the squared distances of pairwise_sq_dists,
    nearest first, ties to the lower index) over chunks of query rows, so
    that the (N, N) scores never exist whole."""
    from gfs3dseg_gws_tpu_torch.ops.knn import pairwise_sq_dists

    out = []
    for i0 in range(0, x.shape[1], rows):
        score = -pairwise_sq_dists(x[:, i0:i0 + rows], x)
        order = torch.sort(score, dim=-1, descending=True, stable=True)
        out.append(order.indices[..., :k].to(torch.int32))
    return torch.cat(out, 1)


def check_long_rows(dev, gen: torch.Generator, c: int = 9, cb: int = 64):
    """K6, K3 and K8 (folds 4) at (1, LONG_N, c), k = BIG_K: a key row
    longer than shared memory holds, which K8's streaming selection (K6's
    and K3's too, at k > 64) never keeps whole. Each graph held to the
    plain rule over chunks of rows (graph_agreement), K8 to K6 bit for bit,
    K3's cnt and scb to the plain statistics of its own idx. Then K8 one
    past the streaming selection's cap (k = kcap + 1), where the fold-merge
    tournament merges chunks of the row through the wrapper's scratch: held
    to the plain rule over chunks of rows by the same rule, and exactly to
    two other selections on the same distances: K6 (four folds) against K8
    at two, and its first kcap columns against the streaming selection at
    k = kcap; on every row ordered otherwise than the plain rule, the two
    graphs' squared distances (float64) slot by slot within TIE_RTOL of
    the row's largest. Reported there: the rows ordered otherwise and that
    largest gap."""
    from gfs3dseg_gws_tpu_torch.ops._ext import knn_stream_cap
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices,
                                                knn_indices_fold,
                                                knn_with_stats,
                                                neighbor_stats_plain)

    x = torch.randn((1, LONG_N, c), generator=gen).to(dev)
    btab = torch.randn((1, LONG_N, cb), generator=gen).to(dev)
    k = BIG_K
    ref = knn_plain_by_rows(x, k)
    idx6 = knn_indices(x, k)
    idx3, cnt, scb = knn_with_stats(x, btab, k)
    idx8 = knn_indices_fold(x, k, 4)
    torch.cuda.synchronize()
    label = f"kNN (1,{LONG_N},{c}) k={k}"
    if not (torch.equal(idx6, idx3) and torch.equal(idx6, idx8)):
        raise AssertionError(f"{label}: K6, K3 and K8 differ")
    share, order, bad = graph_agreement(x, idx6, ref, label, k)
    ref_cnt, ref_scb = neighbor_stats_plain(idx3, btab)
    if not torch.equal(cnt, ref_cnt):
        raise AssertionError(f"{label}: K3's cnt differs from the plain count")
    err = rel_err(scb, ref_scb)
    if err > STATS_TOL:
        raise AssertionError(f"{label}: K3's scb off by {err}")
    kcap = knn_stream_cap()
    kf = kcap + 1
    fold8, fold6 = knn_indices_fold(x, kf, 2), knn_indices(x, kf)
    stream = knn_indices_fold(x, kcap, 2)
    ref_f = knn_plain_by_rows(x, kf)
    torch.cuda.synchronize()
    label_f = f"kNN (1,{LONG_N},{c}) k={kf}"
    if not torch.equal(fold8, fold6):
        raise AssertionError(f"{label_f}: K8 (folds 2) and K6 (folds 4) "
                             "differ")
    if not torch.equal(fold8[..., :kcap], stream):
        raise AssertionError(f"{label_f}: the tournament differs from the "
                             "streaming selection")
    share_f, order_f, bad_f = graph_agreement(x, fold8, ref_f, label_f, kf)
    differ = (fold8 != ref_f).any(-1)
    xd, gap_f = x.double(), 0.0
    for b, i in differ.nonzero().tolist():
        d2 = ((xd[b] - xd[b, i]) ** 2).sum(-1)
        got, want = d2[fold8[b, i].long()], d2[ref_f[b, i].long()]
        gap_f = max(gap_f, ((got - want).abs().max() / want.max()).item())
    if gap_f > TIE_RTOL:
        raise AssertionError(f"{label_f}: a row ordered otherwise than the "
                             f"plain rule is no near-tie ({gap_f})")
    phase(label, sets_agree=share, order_agree=order, near_tie_rows=len(bad),
          scb_rel_err=err, max_abs_err=slot_dist_err(x, idx6, ref),
          k6_ms=cuda_ms(lambda: knn_indices(x, k), WIDE_REPS),
          k3_ms=cuda_ms(lambda: knn_with_stats(x, btab, k), WIDE_REPS),
          k8_ms=cuda_ms(lambda: knn_indices_fold(x, k, 4), WIDE_REPS),
          plain_ms=cuda_ms(lambda: knn_plain_by_rows(x, k), WIDE_REPS),
          bound_ms=bound(2.0 * LONG_N * LONG_N * c,
                         size_of(x) + LONG_N * k * 4)[0],
          **{f"k{kf}_tournament": "K6 and the streaming selection, bit "
                                  "for bit",
             f"k{kf}_sets_agree": share_f, f"k{kf}_order_agree": order_f,
             f"k{kf}_near_tie_rows": len(bad_f),
             f"k{kf}_rows_ordered_otherwise": int(differ.sum()),
             f"k{kf}_fp64_slot_gap": gap_f})


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
    """Synthetic blocks for pre-training and basis extraction (made once,
    shared by both chains)."""
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks

    out = os.path.join(root, "pretrain_data")
    if not os.path.isdir(out):
        make_synthetic_blocks(out, n_train_blocks=PRE_BLOCKS,
                              n_test_blocks=1, points_per_block=4096,
                              seed=SEED + 1)
    return os.path.join(out, "blocks_bs1.0_s1.0")


def pretrain_dataset(root: str, mode: str, split_ratio: float = 0.1):
    """The pre-training split of `pretrain_data` as pretrain() builds it
    (split_ratio 0: as extract_basis builds it)."""
    from gfs3dseg_gws_tpu_torch.data import (PretrainBlockDataset,
                                             make_registry)

    data_dir = os.path.join(root, "pretrain_data", "blocks_bs1.0_s1.0")
    reg = make_registry("s3dis", 0, data_dir)
    classes = reg.train_classes
    return PretrainBlockDataset(data_dir, classes,
                                {c: reg.class2scans[c] for c in classes},
                                mode=mode, num_point=N,
                                split_ratio=split_ratio)


KERNELS = ("k1", "k2", "k3", "k4a", "k4b", "k5a", "k5b", "k6", "k7", "k8",
           "k9")


def reset_launches():
    """A reader of every kernel's launches from now on: the calls of its
    op span (`op.k1` ...) since this call."""
    from gfs3dseg_gws_tpu_torch.utils.observability import calls, snapshot

    def launches():
        snap = snapshot()
        return {k: calls("op." + k, snap) for k in KERNELS}

    before = launches()
    return lambda: {k: n - before[k] for k, n in launches().items()}


def reset_replays():
    """A reader of the train steps replayed as a CUDA graph from now on
    (parallel/steps.py's counters `graph_replays`, of `gfs_train_step`
    and `pretrain_step`)."""
    from gfs3dseg_gws_tpu_torch.utils.observability import snapshot

    def replays():
        return sum(n for book in snapshot().values()
                   for path, n in book["counters"].items()
                   if path.endswith(("train_step/graph_replays",
                                     "pretrain_step/graph_replays")))

    before = replays()
    return lambda: replays() - before


def expected_launches(widths: str, steps: int = 0, forwards: int = 0,
                      attention: bool = False):
    """Every kernel's launches for `steps` training steps and `forwards`
    eval forwards of a model with EdgeConv `widths`: per block two layers
    deep, K1 per forward and K3/K4a/K4b per step; per block of another
    depth, K6 per forward and per step and K7 per step; with `attention`,
    K2 per forward and K5a/K5b per step. K8 and K9 are on no model
    path."""
    import ast

    depths = [len(w) for w in ast.literal_eval(widths)]
    two = sum(d == 2 for d in depths)
    other = len(depths) - two
    att = int(attention)
    return {"k1": two * forwards, "k2": att * forwards, "k3": two * steps,
            "k4a": two * steps, "k4b": two * steps, "k5a": att * steps,
            "k5b": att * steps, "k6": other * (steps + forwards),
            "k7": other * steps, "k8": 0, "k9": 0}


def check_launches(label: str, launches, expected) -> None:
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches} != expected "
                             f"{expected}")


def check_pretrain(dev, root: str, widths: str = DEFAULT_WIDTHS,
                   name: str = "pretrain", k: int = K, reps: int = 20):
    """The pre-training path on the card through its CLI, at the reference
    config (S3DIS cvfold 0, N=2048, batch 16, lr 1e-3, wd 1e-4,
    StepLR(50, 0.5), --pc_augm), EdgeConv `widths` and k, for PRE_EPOCHS short
    epochs with a validation sweep after each: launches per step and per
    forward, finite losses that fall; then the written checkpoint.tar in
    the port's eval DGCNN and the train step's device time (median of
    `reps`; from the fourth call at its key the step replays its CUDA
    graph). Returns the checkpoint.tar's path."""
    import ast

    from gfs3dseg_gws_tpu_torch.cli import pretrain_cli
    from gfs3dseg_gws_tpu_torch.models.dgcnn import DGCNN
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_pretrain_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import pretrain_step

    t0 = time.perf_counter()
    data_dir = pretrain_data(root)
    save = os.path.join(root, name)
    argv = ["--phase", "pretrain", "--dataset", "s3dis", "--cvfold", "0",
            "--data_path", data_dir, "--save_path", save,
            "--batch_size", str(B), "--pc_npts", str(N), "--pc_augm",
            "--pretrain_lr", "0.001", "--pretrain_weight_decay", "1e-4",
            "--n_iters", str(PRE_EPOCHS), "--eval_interval", "1",
            "--edgeconv_widths", widths, "--dgcnn_k", str(k),
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
    valid_batches = n_valid * math.ceil(len(pretrain_dataset(root, "test"))
                                        / B)
    phase(name, widths=widths, data_seconds=t1 - t0, wall_seconds=wall,
          steps=steps, losses=[round(h["loss"], 6) for h in hist],
          steps_per_s=[h["steps"] / h["seconds"] for h in hist],
          miou=[h.get("miou") for h in hist], best_miou=res["best_iou"],
          valid_batches=valid_batches,
          **{f"{k}_launches": v for k, v in launches.items()})
    if not all(math.isfinite(h["loss"]) for h in hist) or n_valid == 0:
        raise AssertionError(f"pre-training went wrong: {hist}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"pre-training loss did not fall: {hist}")
    check_launches(name, launches,
                   expected_launches(widths, steps, valid_batches))
    log_dir = os.path.join(save, "log_pretrain_s3dis_S0_LongTail")
    for fname in ("checkpoint.tar", "checkpoint.npz"):
        if not os.path.exists(os.path.join(log_dir, fname)):
            raise AssertionError(f"pre-training wrote no {fname}")
    ckpt = os.path.join(log_dir, "checkpoint.tar")
    ec_widths = ast.literal_eval(widths)
    enc = DGCNN(edgeconv_widths=ec_widths, k=k, device=dev)
    enc.load_state_dict(torch.load(ckpt, map_location=dev)["params"],
                        strict=True)
    enc.eval()
    points = torch.randn((2, N, 9), device=dev)
    with torch.inference_mode():
        feat = enc(points)[1]
    if feat.shape != (2, N, 256) or not torch.isfinite(feat).all():
        raise AssertionError("checkpoint.tar does not run in the eval DGCNN")

    # the train step alone on device tensors
    model = DGCNNSeg(8, edgeconv_widths=ec_widths, k=k,
                     generator=torch.Generator().manual_seed(SEED)).to(dev)
    opt, sched = make_pretrain_optimizer(model.parameters(), 1e-3, 100)
    drop = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.randn((B, N, 9), generator=drop, device=dev)
    lbl = torch.randint(0, 8, (B, N), generator=drop, device=dev)
    step_ms = cuda_ms(lambda: pretrain_step(model, opt, pts, lbl, drop, sched),
                      reps)
    phase(f"device step pretrain_step ({name})", batch=B, ms=step_ms,
          steps_per_s=1000.0 / step_ms)
    groups, per_step = profile_groups(
        lambda: pretrain_step(model, opt, pts, lbl, drop, sched),
        PROFILE_STEPS)
    if groups is not None:
        phase(f"profile pretrain_step ({name})", steps=PROFILE_STEPS,
              kernel_ms_per_step=sum(groups.values()),
              launches_per_step=per_step,
              groups_ms=json.dumps({k: round(v, 4)
                                    for k, v in groups.items()}))
    return ckpt


def run_basis(dev, root: str, ckpt: str, widths: str, name: str,
              k: int = K) -> str:
    """`basis_cli` on the pre-training blocks and `ckpt` (NUM_GW words) on
    the card: launches per eval forward (batch 8, as the CLI runs it), the
    basis (NUM_GW, every EdgeConv output width together: 192 by default)
    finite, its kept SVD rank above 0. Returns the basis path."""
    import ast

    from gfs3dseg_gws_tpu_torch.cli import basis_cli

    save = os.path.join(root, name)
    read = reset_launches()
    t0 = time.perf_counter()
    basis = basis_cli.main([
        "--dataset", "s3dis", "--cvfold", "0", "--data_path",
        pretrain_data(root), "--pretrain_checkpoint_path", ckpt,
        "--num_cnt", str(NUM_GW), "--save_path", save, "--pc_npts", str(N),
        "--edgeconv_widths", widths, "--dgcnn_k", str(k),
        "--device", dev.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    forwards = math.ceil(len(pretrain_dataset(root, "train", 0.0)) / 8)
    rank = int(np.linalg.matrix_rank(basis.astype(np.float64)))
    path = os.path.join(save, f"GlobalKmeans_EdgeConv123_cnt={NUM_GW}_"
                              "energy=095_SVDReconstruct.pkl")
    phase(name, widths=widths, wall_seconds=wall, basis_shape=basis.shape,
          kept_svd_rank=rank, forwards=forwards,
          **{f"{k}_launches": v for k, v in launches.items()})
    words = sum(w[-1] for w in ast.literal_eval(widths))
    if (basis.shape != (NUM_GW, words) or not np.isfinite(basis).all()
            or rank == 0 or not os.path.exists(path)):
        raise AssertionError(f"{name}: basis {basis.shape} at {path}")
    check_launches(name, launches, expected_launches(widths, 0, forwards))
    return path


def check_lloyd(dev, root: str, ckpt: str, widths: str):
    """lloyd on the card against the CPU from the same k-means++ centres
    (NUM_GW of them) on the same features: the EdgeConv 1-3 features of the
    encoder in `ckpt` over LLOYD_BLOCKS pre-training blocks.

    LLOYD_ITERS iterations, each from the same centres on both devices
    (the CPU's centres carried on): labels equal on >= LLOYD_AGREE of the
    points, centres within CENTRE_TOL of the largest where every label
    agreed and within CENTRE_FLIP_TOL where some differed (a flipped point
    moves its two centres). Lloyd is chaotic at near-ties: two free runs,
    one per device, drift apart from the first flipped point on, so only
    iterations from shared centres are compared. Prints the seconds of
    those iterations on each device."""
    import ast

    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.ops.kmeans import (_assign,
                                                   kmeans_plus_plus_init,
                                                   lloyd)
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
        load_pretrained_encoder)

    model = DGCNNSeg(8, edgeconv_widths=ast.literal_eval(widths), device=dev)
    model.encoder.load_state_dict(load_pretrained_encoder(ckpt), strict=True)
    model.eval()
    pts, _ = first_batch(pretrain_dataset(root, "train", 0.0), LLOYD_BLOCKS,
                         0)
    with torch.inference_mode():
        feats = torch.cat([model(pts[i:i + B].to(dev), return_feat=True)[1]
                           for i in range(0, LLOYD_BLOCKS, B)])
    x = feats.reshape(-1, feats.shape[-1]).cpu()
    xd = x.to(dev)
    c0 = torch.from_numpy(kmeans_plus_plus_init(
        np.random.default_rng(SEED), x.numpy(), NUM_GW))

    centres, worst_agree, err_agreed, err_flipped = c0, 1.0, 0.0, 0.0
    card_s = cpu_s = 0.0
    for _ in range(LLOYD_ITERS):
        # the assignment the iteration's update uses, then the update
        agree = (_assign(xd, centres.to(dev)).cpu()
                 == _assign(x, centres)).double().mean().item()
        t0 = time.perf_counter()
        card_c, _ = lloyd(xd, centres, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu_c, _ = lloyd(x, centres, 1)
        card_s, cpu_s = card_s + t1 - t0, cpu_s + time.perf_counter() - t1
        err = rel_err(card_c.cpu(), cpu_c)
        worst_agree = min(worst_agree, agree)
        if agree == 1.0:
            err_agreed = max(err_agreed, err)
        else:
            err_flipped = max(err_flipped, err)
        centres = cpu_c
    phase(f"card_vs_cpu lloyd ({x.shape[0]} points, {NUM_GW} centres, "
          f"{LLOYD_ITERS} iterations)", step_labels_agree_min=worst_agree,
          step_centre_rel_err_all_agree=err_agreed,
          step_centre_rel_err_some_flipped=err_flipped, card_seconds=card_s,
          cpu_seconds=cpu_s)
    if (worst_agree < LLOYD_AGREE or err_agreed > CENTRE_TOL
            or err_flipped > CENTRE_FLIP_TOL):
        raise AssertionError("lloyd on the card and the CPU disagree")


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


def check_replayed_graph(x, idx, k: int, label: str) -> int:
    """The card's kNN graph `idx` of the CPU features `x`, before the CPU
    replays it: the rows where it differs from the CPU's own graph (as
    sets) are at most 1 - EC_ROWS of them, each a near-tie at the k-th
    distance (GRAPH_TIE). Returns how many rows differ."""
    from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices_plain

    row_ok = (idx.sort(-1).values
              == knn_indices_plain(x, k).sort(-1).values).all(-1)
    bad = (~row_ok).nonzero().tolist()
    if len(bad) > (1.0 - EC_ROWS) * row_ok.numel():
        raise AssertionError(f"{label}: {len(bad)} rows differ from the "
                             "CPU's")
    near_tie_rows(x, bad, label, GRAPH_TIE, by_norm=True, k=k)
    return len(bad)


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
    EdgeConv's K3 (or, in a block that is not two layers deep, K6) indices
    are recorded on the card and replayed on the CPU, after checking that
    every row where they differ from the CPU's own graph (at most
    1 - EC_ROWS of them) is a near-tie at the k-th distance. cnt/scb on
    the CPU are the plain twin's of that graph. A gradient that is zero in
    exact arithmetic (a bias whose shift a train-mode BatchNorm downstream
    removes) is rounding noise on both devices: a pair under NOISE_GRAD of
    the largest gradient norm is counted and left out.

    A block's global max feature (models/dgcnnseg.py::global_max, the max
    over its points per channel) is replayed likewise: the card's argmax
    point of each (block, channel) is recorded, and the CPU takes the value
    at that point (so the gradient goes to the same point), after checking
    that wherever its own argmax differs, its max and its value at the
    card's point lie within MAX_TIE of the max: a near-tie that rounding
    resolves either way."""
    from gfs3dseg_gws_tpu_torch.models import dgcnn, dgcnnseg
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices, knn_with_stats,
                                                neighbor_stats_plain)

    graphs, differing = [], []

    def record(x, btab, k):
        out = knn_with_stats(x, btab, k)
        graphs.append(out[0].cpu())
        return out

    def record_idx(x, k, **local):
        idx = knn_indices(x, k, **local)
        graphs.append(idx.cpu())
        return idx

    def replay_idx(x, k, **local):
        idx = graphs.pop(0)
        differing.append(check_replayed_graph(
            x, idx, k, f"card graph {len(differing)}"))
        return idx

    def replay(x, btab, k):
        idx = replay_idx(x, k)
        return (idx,) + neighbor_stats_plain(idx, btab)

    maxima, max_differing = [], []

    def record_max(feat):
        maxima.append(feat.argmax(1).cpu())
        return saved_max(feat)

    def replay_max(feat):
        at = maxima.pop(0)                                     # (B, C)
        top = feat.detach().amax(1)
        bad = feat.detach().argmax(1) != at
        gap = (top - feat.detach().gather(1, at[:, None])[:, 0]).abs()
        if (gap[bad] > MAX_TIE * top[bad].abs().clamp_min(1e-30)).any():
            raise AssertionError(f"global max {len(max_differing)}: the "
                                 "card's point is not a near-tie of the "
                                 "CPU's max")
        max_differing.append(int(bad.sum()))
        return feat.gather(1, at[:, None])

    card_model.load_state_dict(cpu_model.state_dict())
    runs = {}
    saved = dgcnn.knn_with_stats, dgcnn.knn_indices
    saved_max = dgcnnseg.global_max
    for name, model, device, knn, knn_idx, gmax in (
            ("card", card_model, dev, record, record_idx, record_max),
            ("cpu", cpu_model, "cpu", replay, replay_idx, replay_max)):
        dgcnn.knn_with_stats, dgcnn.knn_indices = knn, knn_idx
        dgcnnseg.global_max = gmax
        try:
            model.train()
            loss = run(model, device)
            loss.backward()
        finally:
            dgcnn.knn_with_stats, dgcnn.knn_indices = saved
            dgcnnseg.global_max = saved_max
        runs[name] = dict(
            loss=loss.item(),
            grads={n: p.grad.cpu().double().flatten()
                   for n, p in model.named_parameters()},
            stats={n: b.cpu().double() for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))})
    if graphs or maxima:
        raise AssertionError(f"{len(graphs)} card graphs, {len(maxima)} "
                             "global maxima not replayed")
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
    phase(f"card_vs_cpu {label}",
          cpu_loss=ref["loss"], card_loss=got["loss"], loss_rel_err=loss_err,
          running_stat_err=stat_err, worst_grad=worst,
          worst_grad_cosine=cos[worst], noise_grads=noise,
          graph_rows_differing=differing,
          global_max_points_differing=max_differing)
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


def check_train_step_vs_cpu(dev, root: str, widths: str = DEFAULT_WIDTHS,
                            k: int = K, blocks: int = TRAIN_CMP_BLOCKS):
    """compare_train_step on the full-width DGCNNSeg (dropout 0) at
    EdgeConv `widths` and k, on `blocks` blocks."""
    import ast

    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy

    ec_widths = ast.literal_eval(widths)
    gen = torch.Generator().manual_seed(SEED + 5)
    pts, lbl = first_batch(pretrain_dataset(root, "train"), blocks, 1)
    compare_train_step(
        f"pretrain step {widths} ({blocks} blocks)",
        DGCNNSeg(8, edgeconv_widths=ec_widths, k=k, dropout=0.0,
                 generator=gen),
        DGCNNSeg(8, edgeconv_widths=ec_widths, k=k, dropout=0.0, device=dev),
        dev,
        lambda model, device: cross_entropy(model(pts.to(device)),
                                            lbl.to(device)))


# --------------------------------------------------------------------------- #
# data parallelism (parallel/mesh.py)
# --------------------------------------------------------------------------- #

DP_RANKS, DP_STEPS = 2, 3         # dp phase: gloo ranks on the one card
DP_RTOL, DP_COS = 1e-5, 0.99999   # ... loss and running statistics; the
                                  # gradient cosine (noise pairs: NOISE_GRAD)
DP_NORM = 5e-3                    # ... and | |g| / |ref| - 1 |: the relative
                                  # change DP_COS admits, sqrt(2(1 - DP_COS))
DP_TRAJ_RTOL = 1e-3               # ... one process's own DP_STEPS steps vs
                                  # the ranks' losses: Adam's first steps
                                  # are +-lr for each weight, so a weight
                                  # whose gradient sign the card's rounding
                                  # and near-tie flips decide moves by 2 lr
DP_MIOU_TOL = 1e-6                # ... evaluate_gfs over the ranks, per seed
DXP_RANKS, DXP_SP = 4, 2          # dxp phase: a 2 x 2 data x points mesh of
                                  # gloo ranks on the one card
DXP_MIOU_TOL = 1e-4               # ... evaluate_gfs over it vs one process
                                  # at its data rows' batch, per seed: the
                                  # card's GEMMs on N/2 rows and the split
                                  # softmax sums round otherwise
DXP_LONG_N, DXP_LONG_B = 16384, 2  # ... a batch of long blocks over 1 x 2
DXP_AGREE = 0.999                 # ... its argmax vs one process's
DXP_REPS = 5                      # ... timed steps (median)


class Recorder:
    """Stands in for a kernel's stage wrapper (e.g. ops/
    fused_edgeconv_train.py::_gsf) while a check records its outputs:
    calls `fn`, hands the result to `sink`, returns it."""

    def __init__(self, fn, sink):
        self.fn, self.sink = fn, sink

    def __call__(self, *args):
        out = self.fn(*args)
        self.sink(args, out)
        return out


def dp_rank(mesh, *args):
    """One rank of the dp phase's `dryrun_multichip`: `gfs_ranks` (its
    arguments), recording the kNN graphs of the training EdgeConvs (K3)
    and K4a's max and min neighbour slots, of this rank's rows. Adds them
    to its result as "graphs" / "slots", a list of the blocks' per step."""
    from gfs3dseg_gws_tpu_torch.models import dgcnn
    from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet
    from gfs3dseg_gws_tpu_torch.parallel.dryrun import gfs_ranks

    graphs, slots = [], []
    knn, gsf = dgcnn.knn_with_stats, fet._gsf

    def knn_rec(*a):
        res = knn(*a)
        graphs.append(res[0].cpu())
        return res

    def gsf_rec(a, res):
        k = a[2].shape[-1]                      # the slots lie in [0, k)
        slots.append(torch.stack(res[3:5]).to(
            torch.uint8 if k <= 256 else torch.int32).cpu())

    dgcnn.knn_with_stats, fet._gsf = knn_rec, Recorder(gsf, gsf_rec)
    try:
        out = gfs_ranks(mesh, *args)
    finally:
        dgcnn.knn_with_stats, fet._gsf = knn, gsf
    steps = len(out["loss"])
    if len(graphs) % steps or len(slots) != len(graphs):
        raise AssertionError(f"dp rank {mesh.rank}: {len(graphs)} graphs "
                             f"and {len(slots)} K4a calls in {steps} steps")
    n = len(graphs) // steps
    return dict(out, graphs=[graphs[i * n:(i + 1) * n] for i in range(steps)],
                slots=[slots[i * n:(i + 1) * n] for i in range(steps)])


def dp_evaluate_rank(mesh, model_cfg, data_cfg, train_cfg):
    """One rank of `evaluate_gfs` over the mesh (`train_cli
    --only_evaluate` data-parallel); returns its result."""
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import evaluate_gfs

    return evaluate_gfs(model_cfg, data_cfg, train_cfg, mesh=mesh)


def one_process_steps(out, dev, **model_kwargs):
    """The GFS train steps of a dryrun_multichip run (`out`) taken by one
    process on the global batch from the ranks' starting state, with the
    generator seeded as theirs. Returns (losses, step walls on the host
    clock). The states are not held to the ranks': a bias before a
    BatchNorm has a gradient of rounding noise, which Adam turns into a
    step of +-lr either way."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_train_step
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import step_seed

    one = GWCAPL(device=dev, **model_kwargs)
    one.load_state_dict(out["init"])
    opt, sched = make_gfs_optimizer(one, 0.01, 10, 50, 0.5)
    points, labels, gp = (a.to(dev) for a in out["inputs"])
    gen = torch.Generator(device=dev)
    losses, seconds = [], []
    for step in range(len(out["loss"])):
        gen.manual_seed(step_seed(SEED, step))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        losses.append(gfs_train_step(one, opt, points, labels, gp, gen,
                                     sched)[0].item())
        seconds.append(time.perf_counter() - t1)
    return losses, seconds


def replay_dp_step(model, out, step: int, dev):
    """One process's GFS train pass of step `step` of a dryrun_multichip
    run (ranks running `dp_rank`) on the same card: the ranks' state
    before the step, the global
    batch, the generator seeded as theirs (so the same fake classes and
    attention masks), forward and backward. Each EdgeConv replays the
    ranks' kNN graph (K3's), rows in rank order, after counting the rows
    where its own K3 graph differs as a set; K4a's max/min neighbour slots
    are compared with the ranks' (slot flips). Returns (loss, grads,
    running statistics after, graph rows differing, slot flips)."""
    from gfs3dseg_gws_tpu_torch.models import dgcnn
    from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet
    from gfs3dseg_gws_tpu_torch.ops.knn import neighbor_stats_plain
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import step_seed

    graphs = [torch.cat(layer) for layer in zip(
        *(r["graphs"][step] for r in out["ranks"]))]
    slots = [torch.cat(layer, dim=1) for layer in zip(
        *(r["slots"][step] for r in out["ranks"]))]
    rows, flips = [], []
    knn, gsf = dgcnn.knn_with_stats, fet._gsf

    def replay(x, btab, k):
        own = knn(x, btab, k)[0]
        idx = graphs[len(rows)].to(dev)
        rows.append(int((own.sort(-1).values != idx.sort(-1).values)
                        .any(-1).sum()))
        return (idx,) + neighbor_stats_plain(idx, btab)

    def gsf_rec(args, res):
        flips.append(int((torch.stack(res[3:5]).cpu().long()
                          != slots[len(flips)].long()).sum()))

    model.load_state_dict(out["states"][step])
    model.train()
    model.zero_grad(set_to_none=True)
    points, labels, gp = (a.to(dev) for a in out["inputs"])
    gen = torch.Generator(device=dev).manual_seed(step_seed(SEED, step))
    dgcnn.knn_with_stats, fet._gsf = replay, Recorder(gsf, gsf_rec)
    try:
        _, loss = model(points, labels, gp, gen)
        loss.backward()
    finally:
        dgcnn.knn_with_stats, fet._gsf = knn, gsf
    grads = {n: p.grad.detach().cpu().double().flatten()
             for n, p in model.named_parameters()}
    stats = {n: b.detach().cpu().double() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return loss.item(), grads, stats, rows, flips


def check_dp(dev, root: str, eval_inputs, eval_res, gw_path: str,
             pre_ckpt: str):
    """Data parallelism on the one card (correctness and collective
    overhead, not scaling: two ranks share one H100).

    1. `dryrun_multichip(DP_RANKS, cuda:0, "gloo")`: DP_STEPS GFS train
       steps of the full-width GWCAPL (attention dropout ATTN_RATE) on a
       global batch of B blocks of N points, then the coding step, the
       ranks recording their K3 graphs and K4a slots (`dp_rank`). Each
       step is replayed by one process on the card from the ranks' state
       (`replay_dp_step`): the loss and the running statistics after it
       within DP_RTOL, each gradient's cosine with the ranks' summed one
       >= DP_COS and its norm within DP_NORM of theirs; graph rows and K4a
       slots that differ are counted. One process then takes the same
       DP_STEPS steps from the same start (`one_process_steps`: the summed
       gradients and the Adam updates end to end; Adam is blind to a
       gradient's uniform scale, which the norm check holds), its losses
       within DP_TRAJ_RTOL of the ranks'. The ranks' launches of K3-K5 are
       checked per step; the collectives a step, their bytes and the step
       walls (2 ranks; one process on the same batch) are printed.
    2. `evaluate_gfs` over the ranks on phase 4's inputs (the coding sweep
       and the static_test sweep split, registration replicated) against
       one process at the ranks' batch (B / DP_RANKS: the same blocks in
       each call), every seed's mIoUs within DP_MIOU_TOL and the base
       codings equal; the difference from phase 4's one process at batch
       B is printed beside it (the card's GEMMs round by batch size).
    3. `torchrun --nproc_per_node 1 -m ...cli.train_cli` on NCCL: one
       epoch through the normal entry point, which builds its mesh on the
       card (its log names the mesh)."""
    import ast

    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.parallel import dryrun
    from gfs3dseg_gws_tpu_torch.pipelines import gfs as port_gfs
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     TrainConfig, replace)

    card = f"cuda:{dev.index or 0}"
    kw = dict(num_gw=NUM_GW, attn_dropout=ATTN_RATE)
    t0 = time.perf_counter()
    out = dryrun.dryrun_multichip(DP_RANKS, card, "gloo", steps=DP_STEPS,
                                  batch=B, npts=N, seed=SEED,
                                  rank_fn=dp_rank, **kw)
    dp_seconds = time.perf_counter() - t0
    blocks = len(ast.literal_eval(DEFAULT_WIDTHS))
    per_rank = {"k3": blocks * DP_STEPS, "k4a": blocks * DP_STEPS,
                "k4b": blocks * DP_STEPS, "k5a": DP_STEPS, "k5b": DP_STEPS}
    rank_launches = [r["launches"] for r in out["ranks"]]
    for r, launched in enumerate(rank_launches):
        check_launches(f"dp rank {r}", launched, per_rank)

    model = GWCAPL(device=dev, **kw)
    losses, worst, norms, noise, rows, flips, stat_errs = \
        [], [], [], [], [], [], []
    for step in range(DP_STEPS):
        loss, grads, stats, r, f = replay_dp_step(model, out, step, dev)
        after = (out["states"][step + 1] if step + 1 < DP_STEPS
                 else out["final_state"])
        stat_errs.append(max(
            ((v - after[n].double()).abs()
             / after[n].double().abs().clamp_min(1.0)).max().item()
            for n, v in stats.items()))
        ref = {n: g.double().flatten() for n, g in out["grads"][step].items()}
        floor = NOISE_GRAD * max(g.norm().item() for g in ref.values())
        cos, ratio, quiet = {}, {}, 0
        for n, g in grads.items():
            if g.norm() < floor and ref[n].norm() < floor:
                quiet += 1
                continue
            cos[n] = (g @ ref[n] / (g.norm() * ref[n].norm())
                      .clamp_min(1e-300)).item()
            ratio[n] = (g.norm() / ref[n].norm().clamp_min(1e-300)).item()
        w = min(cos, key=cos.get)
        off = max(ratio, key=lambda n: abs(ratio[n] - 1.0))
        losses.append((out["loss"][step], loss,
                       abs(out["loss"][step] - loss) / abs(loss)))
        worst.append((w, cos[w]))
        norms.append((off, ratio[off]))
        noise.append(quiet)
        rows.append(r)
        flips.append(f)

    # one process's steps on the same global batch, from the same start
    one_loss, one_seconds = one_process_steps(out, dev, **kw)
    traj_errs = [abs(a - b) / abs(b) for a, b in zip(out["loss"], one_loss)]
    phase(f"dp train steps ({DP_RANKS} gloo ranks on one card vs one "
          "process; correctness and collective overhead, not scaling)",
          batch=B, steps=DP_STEPS,
          dp_loss=[x[0] for x in losses], replay_loss=[x[1] for x in losses],
          loss_rel_err=[x[2] for x in losses],
          one_process_loss=one_loss, one_process_loss_rel_err=traj_errs,
          running_stat_err=stat_errs,
          worst_grad=[x[0] for x in worst],
          worst_grad_cosine=[x[1] for x in worst],
          worst_norm_grad=[x[0] for x in norms],
          worst_grad_norm_ratio=[x[1] for x in norms], noise_grads=noise,
          graph_rows_differing=rows, k4a_slots_differing=flips,
          collectives_per_step=out["collectives"],
          collective_bytes_per_step=out["collective_bytes"],
          dp_step_seconds=out["seconds"], one_step_seconds=one_seconds,
          dp_accuracy=out["accuracy"], rank_launches=rank_launches,
          dryrun_wall_seconds=dp_seconds)
    if max(x[2] for x in losses) > DP_RTOL or max(stat_errs) > DP_RTOL \
            or max(traj_errs) > DP_TRAJ_RTOL:
        raise AssertionError("data-parallel and one-process steps disagree")
    if min(x[1] for x in worst) < DP_COS or \
            max(abs(x[1] - 1.0) for x in norms) > DP_NORM:
        raise AssertionError(f"data-parallel gradients off one process's: "
                             f"{worst} {norms}")

    # evaluate_gfs over the ranks against one process at their batch
    train_dir, test_dir, basis_path, pth = eval_inputs
    cfgs = (ModelConfig(),
            DataConfig(data_path=train_dir, testing_data_path=test_dir,
                       pc_npts=N, k_shot=5),
            TrainConfig(batch_size=B, eval_weight=1.2, energy=0.9,
                        basis_path=basis_path, model_checkpoint_path=pth,
                        save_path=os.path.join(root, "dp_eval"),
                        only_evaluate=True, device="cuda"))
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(dp_evaluate_rank, DP_RANKS, card, "gloo", cfgs)
    eval_seconds = time.perf_counter() - t0
    one = port_gfs.evaluate_gfs(*cfgs[:2], replace(
        cfgs[2], batch_size=B // DP_RANKS,
        save_path=os.path.join(root, "dp_eval_one")))
    diffs = [float(np.abs(r["per_seed"] - one["per_seed"]).max())
             for r in ranks]
    phase(f"dp evaluate_gfs ({DP_RANKS} gloo ranks vs one process at "
          f"batch {B // DP_RANKS})",
          blocks=ranks[0]["n_blocks"], coding_sweep=ranks[0]["coding_sweep"],
          per_seed_miou=[round(float(v), 6) for v in
                         ranks[0]["per_seed"][:, 0]],
          max_abs_diff=diffs,
          base_coding_equal=[np.array_equal(r["base_coding"],
                                            one["base_coding"])
                             for r in ranks],
          one_at_batch_b_max_abs_diff=float(np.abs(
              one["per_seed"] - eval_res["per_seed"]).max()),
          sweep_seconds=ranks[0]["sweep_seconds"],
          wall_seconds=eval_seconds)
    if max(diffs) > DP_MIOU_TOL or not all(
            np.array_equal(r["base_coding"], one["base_coding"])
            for r in ranks):
        raise AssertionError("data-parallel evaluation differs from one "
                             "process")
    dp_one = one

    # the normal entry point under torchrun, NCCL, one rank
    save = os.path.join(root, "dp_torchrun")
    data = os.path.join(root, "gfs_train_data", "blocks_bs1.0_s1.0")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "1", "--standalone", "-m", "gfs3dseg_gws_tpu_torch.cli.train_cli",
         "--dataset", "s3dis", "--cvfold", "0", "--data_path", data,
         "--testing_data_path", test_dir, "--basis_path", gw_path,
         "--pc_npts", str(N), "--k_shot", "5", "--batch_size", str(B),
         "--seed", str(SEED), "--epochs", "1", "--pc_augm",
         "--use_pretrain_weight", "--pretrain_checkpoint_path", pre_ckpt,
         "--save_path", save, "--mesh", "data", "--device", "cuda"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    log = ""
    if os.path.exists(os.path.join(save, "log_train.txt")):
        log = open(os.path.join(save, "log_train.txt")).read()
    mesh_line = next((line for line in log.splitlines()
                      if "data mesh" in line), "")
    phase("dp torchrun train_cli (NCCL, 1 rank)", rc=res.returncode,
          wall_seconds=wall, mesh=mesh_line.strip("- "),
          epoch_line=next((line for line in log.splitlines()
                           if line.startswith("Train result")), ""))
    if res.returncode != 0 or "over nccl" not in mesh_line or \
            "Train result at epoch [0/1]" not in log:
        raise AssertionError(f"torchrun train_cli failed ({res.returncode}):"
                             f"\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return dp_one


def dxp_evaluate_rank(mesh, model_cfg, data_cfg, train_cfg):
    """One rank of `evaluate_gfs` over the data x points mesh; returns its
    result, its kernel launches and its points all-gathers (calls, bytes)
    and all collectives."""
    from gfs3dseg_gws_tpu_torch.parallel import mesh as pmesh
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import evaluate_gfs

    read = reset_launches()
    gathers, total = pmesh.gathers(), pmesh.collectives()
    out = evaluate_gfs(model_cfg, data_cfg, train_cfg, mesh=mesh)
    sync(mesh.device)
    now, now_total = pmesh.gathers(), pmesh.collectives()
    return dict(out, launches=read(),
                gathers=(now[0] - gathers[0], now[1] - gathers[1]),
                collectives=(now_total[0] - total[0],
                             now_total[1] - total[1]))


def dxp_long_rank(mesh, state, points, labels, gp, heads):
    """One rank of the dxp phase's long blocks: its rows and points of the
    batch through gfs_eval_multi_step under the points split (one warm-up,
    then the median host-clock ms of DXP_REPS calls, each waited for), and
    the argmax of the same pass (GWCAPL.evaluate_multi)."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.parallel import mesh as pmesh
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_eval_multi_step

    dev = mesh.device
    model = GWCAPL(num_gw=NUM_GW, device=dev)
    model.load_state_dict(state)
    pmesh.replicate(model, mesh)
    x, y = (pmesh.shard_points(pmesh.shard_batch(t, mesh), mesh).to(dev)
            for t in (points, labels))
    gp, heads = gp.to(dev), [h.to(dev) for h in heads]
    with pmesh.points_split(model, mesh):
        return _timed_long_pass(model, x, y, gp, heads,
                                gfs_eval_multi_step)


def _timed_long_pass(model, x, y, gp, heads, step):
    """(argmax (S, B, N) on the host, median ms of `step` on the batch,
    K1/K2 launches of one step)."""
    read = reset_launches()
    step(model, x, y, gp, *heads, x.shape[0], 13)
    launched = read()
    seconds = []
    for _ in range(DXP_REPS):
        sync(x.device)
        t0 = time.perf_counter()
        step(model, x, y, gp, *heads, x.shape[0], 13)
        sync(x.device)
        seconds.append(time.perf_counter() - t0)
    with torch.inference_mode():
        logits = model.evaluate_multi(x, gp, *heads)[0]
    return (torch.argmax(logits, -1).cpu(), 1e3 * statistics.median(seconds),
            {k: launched[k] for k in ("k1", "k2")})


def check_dxp(dev, root: str, eval_inputs, dp_one, model, basis, heads):
    """The data x points mesh (`--mesh dxp`, parallel/mesh.py::
    make_mesh_dxp) on the one card (correctness and collective overhead,
    not scaling):

    1. `evaluate_gfs` over a 2 x 2 mesh of DXP_RANKS gloo ranks on
       phase 4's inputs (S3DIS defaults, N = 2048, batch 16: each rank 8
       blocks x 1,024 points) against one process at batch 8 (the dp
       phase's run, `dp_one`): every seed's mIoUs within DXP_MIOU_TOL, the
       base codings equal; each rank's K1/K2 launches as one process's
       forwards; the points all-gathers a batch, their bytes.
    2. One batch of DXP_LONG_B synthetic blocks of DXP_LONG_N points
       through gfs_eval_multi_step over a 1 x 2 mesh against one process on
       the card: argmax agreement >= DXP_AGREE; each rank's ms and one
       process's.
    3. `torchrun --nproc_per_node 1 train_cli --only_evaluate --mesh dxp
       --mesh_sp 1` on NCCL: rc 0, and the mesh in its log."""
    from gfs3dseg_gws_tpu_torch.parallel import dryrun
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_eval_multi_step
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     TrainConfig)

    card = f"cuda:{dev.index or 0}"
    train_dir, test_dir, basis_path, pth = eval_inputs
    cfgs = (ModelConfig(),
            DataConfig(data_path=train_dir, testing_data_path=test_dir,
                       pc_npts=N, k_shot=5),
            TrainConfig(batch_size=B, eval_weight=1.2, energy=0.9,
                        basis_path=basis_path, model_checkpoint_path=pth,
                        save_path=os.path.join(root, "dxp_eval"),
                        only_evaluate=True, device="cuda"))
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(dxp_evaluate_rank, DXP_RANKS, card, "gloo",
                             cfgs, sp=DXP_SP)
    wall = time.perf_counter() - t0
    setup = gfs_setup(train_dir, test_dir)
    forwards = eval_forwards(setup, ranks[0]["coding_sweep"])
    split = forwards - len(setup.supp_datasets)     # the split sweeps' batches
    want = expected_launches(DEFAULT_WIDTHS, 0, forwards, True)
    for r, out in enumerate(ranks):
        check_launches(f"dxp rank {r}", out["launches"], want)
    diffs = [float(np.abs(r["per_seed"] - dp_one["per_seed"]).max())
             for r in ranks]
    codings = [np.array_equal(r["base_coding"], dp_one["base_coding"])
               for r in ranks]
    log = open(os.path.join(root, "dxp_eval", "log_test.txt")).read()
    mesh_line = next((line for line in log.splitlines()
                      if "data x points mesh" in line), "")
    phase(f"dxp evaluate_gfs ({DXP_RANKS // DXP_SP} x {DXP_SP} gloo ranks "
          f"on one card vs one process at batch {B // (DXP_RANKS // DXP_SP)};"
          " correctness and collective overhead, not scaling)",
          mesh=mesh_line.strip("- "), blocks=ranks[0]["n_blocks"],
          coding_sweep=ranks[0]["coding_sweep"],
          per_seed_miou=[round(float(v), 6)
                         for v in ranks[0]["per_seed"][:, 0]],
          max_abs_diff=diffs, tol=DXP_MIOU_TOL, base_coding_equal=codings,
          split_batches=split,
          gathers_per_batch=ranks[0]["gathers"][0] / split,
          gather_bytes_per_batch=ranks[0]["gathers"][1] / split,
          collectives_per_batch=ranks[0]["collectives"][0] / split,
          collective_bytes_per_batch=ranks[0]["collectives"][1] / split,
          rank_launches=[r["launches"]["k1"] for r in ranks],
          sweep_seconds=[r["sweep_seconds"] for r in ranks],
          one_process_sweep_seconds=dp_one["sweep_seconds"],
          wall_seconds=wall)
    if "{'data': 2, 'points': 2}" not in mesh_line or \
            max(diffs) > DXP_MIOU_TOL or not all(codings):
        raise AssertionError("data x points evaluation differs from one "
                             "process")

    # a batch of long blocks over 1 x 2 against one process on the card
    r = np.random.default_rng(SEED + 18)
    xyz = r.random((DXP_LONG_B, DXP_LONG_N, 3)).astype(np.float32)
    points = torch.from_numpy(np.concatenate(
        [xyz, r.random((DXP_LONG_B, DXP_LONG_N, 3)).astype(np.float32),
         xyz / xyz.max(axis=1, keepdims=True)], -1))
    labels = torch.from_numpy(r.integers(0, 13, (DXP_LONG_B, DXP_LONG_N)))
    gp = torch.from_numpy(np.asarray(basis, np.float32))
    heads = [torch.from_numpy(np.asarray(h)) for h in heads]
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    long_ranks = dryrun.run_ranks(dxp_long_rank, DXP_SP, card, "gloo",
                                  (state, points, labels, gp, heads),
                                  sp=DXP_SP)
    long_wall = time.perf_counter() - t0
    pred = torch.cat([lr[0] for lr in long_ranks], dim=2)
    one_pred, one_ms, one_launches = _timed_long_pass(
        model, points.to(dev), labels.to(dev), gp.to(dev),
        [h.to(dev) for h in heads], gfs_eval_multi_step)
    agree = (pred == one_pred).double().mean().item()
    phase(f"dxp gfs_eval_multi_step ({DXP_LONG_B}, {DXP_LONG_N}) over 1 x "
          f"{DXP_SP} gloo ranks vs one process",
          argmax_agree=agree, rank_ms=[lr[1] for lr in long_ranks],
          one_process_ms=one_ms,
          rank_launches=[lr[2] for lr in long_ranks],
          one_process_launches=one_launches, wall_seconds=long_wall)
    if pred.shape != one_pred.shape or agree < DXP_AGREE:
        raise AssertionError(f"long blocks over the data x points mesh "
                             f"agree with one process on {agree}")

    # the normal entry point under torchrun, NCCL, one rank
    save = os.path.join(root, "dxp_torchrun")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "1", "--standalone", "-m", "gfs3dseg_gws_tpu_torch.cli.train_cli",
         "--phase", "test", "--only_evaluate", "--dataset", "s3dis",
         "--cvfold", "0", "--data_path", train_dir,
         "--testing_data_path", test_dir, "--basis_path", basis_path,
         "--model_checkpoint_path", pth, "--save_path", save,
         "--pc_npts", str(N), "--k_shot", "5", "--eval_weight", "1.2",
         "--energy", "0.9", "--batch_size", str(B), "--mesh", "dxp",
         "--mesh_sp", "1", "--device", "cuda"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    log = ""
    if os.path.exists(os.path.join(save, "log_test.txt")):
        log = open(os.path.join(save, "log_test.txt")).read()
    mesh_line = next((line for line in log.splitlines()
                      if "data x points mesh" in line), "")
    phase("dxp torchrun train_cli --only_evaluate --mesh dxp --mesh_sp 1 "
          "(NCCL, 1 rank)", rc=res.returncode, wall_seconds=wall,
          mesh=mesh_line.strip("- "),
          eval_line=next((line for line in log.splitlines()
                          if line.startswith("Eval result")), ""))
    if res.returncode != 0 or "{'data': 1, 'points': 1}" not in mesh_line \
            or "over nccl" not in mesh_line or "Eval result" not in log:
        raise AssertionError(f"torchrun train_cli --mesh dxp failed "
                             f"({res.returncode}):\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")



# --------------------------------------------------------------------------- #
# GFS base-stage training
# --------------------------------------------------------------------------- #

def gfs_setup(train_dir: str, test_dir: str, dataset: str = "s3dis"):
    """The port's GFS setup on the CPU (datasets and class orders)."""
    from gfs3dseg_gws_tpu_torch.pipelines import gfs as port_gfs
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     TrainConfig)

    return port_gfs.build_setup(
        ModelConfig(), DataConfig(dataset=dataset, data_path=train_dir,
                                  testing_data_path=test_dir, pc_npts=N,
                                  k_shot=5, pc_augm=True),
        TrainConfig(batch_size=B, device="cpu"),
        np.zeros((NUM_GW, 192), np.float32), torch.device("cpu"))


def eval_forwards(setup, coding_sweep: bool) -> int:
    """Eval forwards of one `train_cli --only_evaluate` run: the coding
    sweep (if evaluate_gfs ran it: it found no saved coding), one forward
    per support seed, the static_test sweep."""
    return (coding_sweep * math.ceil(len(setup.train_data_noaug) / B)
            + len(setup.supp_datasets)
            + math.ceil(len(setup.val_dataset) / B))


def gfs_model(dev, seed: int, attn_dropout: float = ATTN_RATE):
    """A full-width GWCAPL with the JAX initialisers drawn from `seed`."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL

    model = GWCAPL(num_gw=NUM_GW, attn_dropout=attn_dropout)
    return model.train_init(torch.Generator().manual_seed(seed)).to(dev)


def check_gfs_train(dev, root: str, test_dir: str, basis_path: str,
                    pretrain_ckpt: str, widths: str = DEFAULT_WIDTHS,
                    name: str = "gfs_train", k: int = K):
    """The GFS training path on the card through its CLI (no
    --only_evaluate), at the reference config (S3DIS cvfold 0, N=2048,
    batch 16, Adam 0.01 with the encoder at 0.1x, StepLR(50, 0.5),
    attention dropout 0.1, --pc_augm), EdgeConv `widths` and k, from
    `pretrain_ckpt` and the basis at `basis_path`, GFS_EPOCHS epochs with
    validation on support seed 0 after each; launches checked per step
    (a replayed step adds its graph's launches to the op spans) and per
    forward. Then the newest checkpoint through `train_cli
    --only_evaluate` (the 5 support seeds), its launches checked too.
    Returns the training run's launches, the setup, and the checkpoint
    with its evaluation ({"checkpoint", "evaluated", "eval_launches",
    "argv": the arguments the evaluation shares with training})."""
    import glob

    from gfs3dseg_gws_tpu_torch.cli import train_cli
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks

    t0 = time.perf_counter()
    data = os.path.join(root, "gfs_train_data")
    if not os.path.isdir(data):
        make_synthetic_blocks(data, n_train_blocks=GFS_BLOCKS,
                              n_test_blocks=1, points_per_block=4096,
                              seed=SEED + 2)
    train_dir = os.path.join(data, "blocks_bs1.0_s1.0")
    save = os.path.join(root, name)
    common = ["--dataset", "s3dis", "--cvfold", "0", "--data_path",
              train_dir, "--testing_data_path", test_dir, "--basis_path",
              basis_path, "--pc_npts", str(N), "--k_shot", "5",
              "--batch_size", str(B), "--edgeconv_widths", widths,
              "--dgcnn_k", str(k), "--seed", str(SEED), "--device", dev.type]
    argv = common + [
        "--phase", "train", "--save_path", save, "--epochs",
        str(GFS_EPOCHS), "--base_lr", "0.01", "--pc_augm",
        "--use_pretrain_weight", "--pretrain_checkpoint_path", pretrain_ckpt]
    read, replayed = reset_launches(), reset_replays()
    t1 = time.perf_counter()
    res = train_cli.main(argv, eval_interval=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches, replays = read(), replayed()
    hist, steps = res["history"], res["step"]
    setup = gfs_setup(train_dir, test_dir)
    n_valid = sum(1 for h in hist if "mean_iou" in h)
    # eval forwards: one coding sweep (epoch 0), and per validation one
    # forward of the support shots plus the static_test sweep
    forwards = (math.ceil(len(setup.train_data_noaug) / B)
                + n_valid * (1 + math.ceil(len(setup.val_dataset) / B)))
    phase(name, widths=widths, data_seconds=t1 - t0, wall_seconds=wall,
          steps=steps, losses=[h["loss"] for h in hist],
          accuracies=[h["accuracy"] for h in hist],
          steps_per_s=[h["steps"] / h["seconds"] for h in hist],
          mean_iou=[h.get("mean_iou") for h in hist],
          hm_iou=[h.get("hm_iou") for h in hist], eval_forwards=forwards,
          replayed_steps=replays,
          **{f"{k}_launches": v for k, v in launches.items()})
    if (len(hist) != GFS_EPOCHS or n_valid != GFS_EPOCHS
            or not all(math.isfinite(h["loss"]) and math.isfinite(
                h["mean_iou"]) for h in hist)):
        raise AssertionError(f"GFS training went wrong: {hist}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"GFS training loss did not fall: {hist}")
    check_launches(name, launches,
                   expected_launches(widths, steps, forwards, True))

    ckpts = glob.glob(os.path.join(save, "train_*.npz"))
    if not ckpts:
        raise AssertionError("GFS training wrote no checkpoint")
    ckpt = max(ckpts, key=os.path.getmtime)
    read = reset_launches()
    t1 = time.perf_counter()
    ev = train_cli.main(common + [
        "--phase", "test", "--only_evaluate", "--model_checkpoint_path",
        ckpt, "--save_path", os.path.join(root, name + "_eval"),
        "--eval_weight", "1.2", "--energy", "0.9"])
    torch.cuda.synchronize()
    ev_launches = read()
    mious = [ev[k] for k in ("mean_iou", "base_iou", "novel_iou", "hm_iou")]
    phase(f"{name} checkpoint through evaluate_gfs",
          checkpoint=os.path.basename(ckpt), mean_iou=mious[0],
          base_iou=mious[1], novel_iou=mious[2], hm_iou=mious[3],
          wall_seconds=time.perf_counter() - t1,
          coding_sweep=ev["coding_sweep"],
          **{f"{k}_launches": v for k, v in ev_launches.items()})
    if not all(math.isfinite(m) for m in mious):
        raise AssertionError(f"non-finite mIoU {mious} from {ckpt}")
    check_launches(f"{name} evaluate", ev_launches, expected_launches(
        widths, 0, eval_forwards(setup, ev["coding_sweep"]), True))
    return launches, setup, {"checkpoint": ckpt, "evaluated": ev,
                             "eval_launches": ev_launches, "argv": common}


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
    torch.profiler's device times over `steps` calls of `fn`, and the
    launches a step; None where the profiler sees no device time. The
    device ranges of user annotations (the port's spans, the optimizer's
    `Optimizer.step#...`) enclose kernels and are not counted."""
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
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False):
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


def gfs_step_fn(dev, setup, gp: torch.Tensor):
    """One gfs_train_step of a full-width GWCAPL (seed SEED + 1) with its
    optimizer and schedule on a fixed batch of device tensors, as a
    function of no arguments (each call takes a step)."""
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_train_step

    pts, lbl = (t.to(dev) for t in first_batch(setup.train_data, B, 1))
    model = gfs_model(dev, SEED + 1)
    opt, sched = make_gfs_optimizer(model, 0.01, 100)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        return gfs_train_step(model, opt, pts, lbl, gp, gen, sched)

    return step


def check_gfs_step(dev, setup, gp: torch.Tensor):
    """gfs_train_step alone on device tensors: the CUDA-event median and
    the host-clock wall of PROFILE_STEPS steps, replayed as a CUDA graph;
    then the kernel time by group and the launches of the eager step, the
    one that runs under torch.profiler (parallel/steps.py), which launches
    the kernels that a replay does."""
    step = gfs_step_fn(dev, setup, gp)
    step_ms = cuda_ms(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / PROFILE_STEPS
    groups, launches = profile_groups(step, PROFILE_STEPS)
    phase("device step gfs_train_step (replayed)", batch=B, ms=step_ms,
          steps_per_s=1000.0 / step_ms, wall_ms=wall_ms)
    if groups is None:
        phase("profile gfs_train_step (eager)", note="torch.profiler saw "
              "no device time; CUDA-event times above stand")
        return
    phase("profile gfs_train_step (eager)", steps=PROFILE_STEPS,
          kernel_ms_per_step=sum(groups.values()),
          launches_per_step=launches,
          groups_ms=json.dumps({k: round(v, 4) for k, v in groups.items()}))


def check_gfs_step_vs_cpu(dev, setup, gp: torch.Tensor):
    """compare_train_step on the full-width GWCAPL (attention dropout 0, a
    fixed fake_row)."""
    pts, lbl = first_batch(setup.train_data, TRAIN_CMP_BLOCKS, 1)
    fake = torch.zeros(13)
    fake[[2, 4, 5]] = 1.0
    gp_cpu = gp.cpu()
    compare_train_step(
        f"gfs_step ({TRAIN_CMP_BLOCKS} blocks)",
        gfs_model("cpu", SEED + 6, attn_dropout=0.0),
        gfs_model(dev, SEED + 7, attn_dropout=0.0), dev,
        lambda model, device: model(pts.to(device), lbl.to(device),
                                    gp_cpu.to(device),
                                    fake_row=fake.to(device))[1])


# --------------------------------------------------------------------------- #
# the few-shot baselines (pretrain_cli's six baseline phases)
# --------------------------------------------------------------------------- #

def baseline_argv(dev, phase_name: str, data_dir: str, save: str, *extra):
    """pretrain_cli arguments of a baseline phase at the default widths,
    N = 2048, 2-way 1-shot, one query a way, FS_BANK bank episodes a class
    pair."""
    return ["--phase", phase_name, "--dataset", "s3dis", "--cvfold", "0",
            "--data_path", data_dir, "--save_path", save, "--pc_npts",
            str(N), "--n_way", "2", "--k_shot", "1", "--n_queries", "1",
            "--n_episode_test", str(FS_BANK), "--seed", str(SEED),
            "--device", dev.type, *extra]


def run_baseline(dev, name: str, argv, expected, **limits):
    """One pretrain_cli baseline phase on the card: its launches against
    `expected`, its mIoU and loss finite; prints a phase line. Returns
    (result, wall seconds)."""
    from gfs3dseg_gws_tpu_torch.cli import pretrain_cli

    read = reset_launches()
    t0 = time.perf_counter()
    res = pretrain_cli.main(argv, **limits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    if "history" in res:            # a train phase: its last validation
        miou, loss = res["best_iou"], res["history"][-1]["loss"]
        extra = {"train_losses": [round(v, 6) for v in res["train_losses"]],
                 "train_episodes": res["episodes"],
                 "train_ms_per_episode":
                     1e3 * res["train_seconds"] / res["episodes"]}
        losses = res["train_losses"] + [loss]
    elif "losses" in res:           # finetune
        miou, losses = res["mean_iou"], res["losses"]
        extra = {"episodes": res["episodes"],
                 "last_losses": [round(v, 6) for v in losses[-3:]]}
    elif "hm_iou" in res:           # mptigfs
        miou, losses = res["mean_iou"], []
        extra = {k: res[k] for k in ("base_iou", "novel_iou", "hm_iou",
                                     "base_blocks", "query_blocks")}
    else:                           # protoeval, mptieval
        miou, losses = res["mean_iou"], [res["loss"]]
        extra = {"loss": res["loss"], "episodes": res["episodes"]}
    phase(name, wall_seconds=wall, miou=miou, **extra,
          **{f"{k}_launches": v for k, v in launches.items()})
    if not (math.isfinite(miou) and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{name}: mIoU {miou}, losses {losses}")
    check_launches(name, launches, expected)
    return res, wall


def check_reloaded(name: str, evaluated, trained) -> None:
    """The eval phase read the train phase's checkpoint: its test bank
    holds the validation bank's episodes (both drawn from one seed), so
    its mIoU is the one validation's, within RELOAD_TOL."""
    if abs(evaluated["mean_iou"] - trained["best_iou"]) > RELOAD_TOL:
        raise AssertionError(f"{name}: mIoU {evaluated['mean_iou']} from "
                             f"the checkpoint, {trained['best_iou']} in "
                             "training")


def check_proto_vs_cpu(dev, learner, episodes):
    """ProtoNet test episodes on the card against the CPU (the same
    weights), held as evaluate_multi's is, over all their query points
    together (PROTO_EPISODES episodes, as many points as evaluate_multi's
    CMP_BLOCKS blocks; one episode's 4,096 points hold too few kNN
    near-ties for the rule): the card's logits against the CPU's fp64 ones
    may miss LOGIT_TOL (relative to the logit's size: the euclidean logits
    are negative squared distances) on at most MISS_RATIO times as many
    points as the CPU's fp32 ones, plus MISS_SLACK, and argmax agreement
    >= CPU_AGREE."""
    import copy

    card_model = learner.model.eval()
    cpu_model = copy.deepcopy(card_model).cpu()
    cpu64_model = copy.deepcopy(cpu_model).double()
    card, cpu32, cpu64 = [], [], []
    with torch.inference_mode():
        for episode in episodes:
            args = [torch.from_numpy(np.asarray(a, dt)) for a, dt in zip(
                episode[:4], (np.float32, np.int64, np.float32, np.int64))]
            card.append(card_model(*(a.to(dev) for a in args))[0].cpu())
            cpu32.append(cpu_model(*args)[0])
            cpu64.append(cpu64_model(*(a.double() if a.is_floating_point()
                                       else a for a in args))[0])
    card, cpu32, cpu64 = (torch.cat(x).double() for x in (card, cpu32,
                                                           cpu64))

    def within(a, b):
        return ((a - b).abs() <= LOGIT_TOL * (1.0 + b.abs())).all(
            -1).double().mean().item()

    agree = (card.argmax(-1) == cpu32.argmax(-1)).double().mean().item()
    card_miss, cpu_miss = 1.0 - within(card, cpu64), 1.0 - within(cpu32,
                                                                  cpu64)
    # per point: where kNN near-ties flip, a few points move far and the
    # rest not at all
    rel = ((card - cpu64).abs() / (1.0 + cpu64.abs())).amax(-1)
    phase(f"card_vs_cpu protonet test episodes ({len(episodes)})",
          points=card.shape[0] * card.shape[1], argmax_agree=agree,
          card_misses_cpu64=card_miss, cpu32_misses_cpu64=cpu_miss,
          max_abs_diff=(card - cpu32).abs().max().item(),
          rel_diff_quantiles=[float(q) for q in torch.quantile(
              rel.flatten(), torch.tensor([0.5, 0.99, 0.999],
                                          dtype=torch.float64))],
          max_abs_logit=cpu64.abs().max().item())
    if agree < CPU_AGREE or card_miss > MISS_RATIO * cpu_miss + MISS_SLACK:
        raise AssertionError("ProtoNet: card and CPU disagree")


def check_proto_episodes_vs_cpu(dev, learner, episodes):
    """ProtoNet test episodes on the card against the CPU in fp32 (the
    same weights), one episode at a time, with the card's kNN graphs
    replayed on the CPU as compare_train_step replays them: each EdgeConv
    block's graph is taken on the card by K6 (knn_indices, the kNN stage
    K1 runs; K6 -> K9 equals K1 bit for bit), checked where it differs
    from the CPU's own graph (near-ties only, check_replayed_graph), and
    the CPU block then runs K1's plain edge stage on it
    (gather_conv_plain). With the graphs fixed, what is left is rounding:
    on every query point of every episode the card's logits lie within
    LOGIT_TOL of the CPU's (relative to 1 + |logit|, the euclidean logits
    being negative squared distances), and the argmax agrees wherever the
    CPU's top two logits lie further apart than that. The margin is one
    point's: it does not grow with the points an episode or a pool
    holds."""
    import copy

    from gfs3dseg_gws_tpu_torch.models import dgcnn
    from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import gather_conv_plain
    from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices

    card_model = learner.model.eval()
    cpu_model = copy.deepcopy(card_model).cpu()
    saved = dgcnn.fused_edgeconv_infer
    graphs, rows = [], []

    def record(x, a_table, b_table, w2, bias2, k, neg_slope=0.2):
        graphs.append(knn_indices(x, k).cpu())
        return saved(x, a_table, b_table, w2, bias2, k, neg_slope)

    def replay(x, a_table, b_table, w2, bias2, k, neg_slope=0.2):
        idx = graphs.pop(0)
        rows.append(check_replayed_graph(x, idx, k,
                                         f"ProtoNet graph {len(rows)}"))
        return gather_conv_plain(idx, a_table, b_table, w2, bias2, neg_slope)

    worst, flips, tight = [], 0, 0
    try:
        for i, episode in enumerate(episodes):
            args = [torch.from_numpy(np.asarray(a, dt)) for a, dt in zip(
                episode[:4], (np.float32, np.int64, np.float32, np.int64))]
            with torch.inference_mode():
                dgcnn.fused_edgeconv_infer = record
                card = card_model(*(a.to(dev) for a in args))[0].cpu()
                dgcnn.fused_edgeconv_infer = replay
                cpu = cpu_model(*args)[0]
            if graphs:
                raise AssertionError(f"{len(graphs)} card graphs not "
                                     "replayed")
            card, cpu = card.double(), cpu.double()
            rel = ((card - cpu).abs() / (1.0 + cpu.abs())).amax(-1)
            top2 = cpu.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 2.0 * LOGIT_TOL * (
                1.0 + top2[..., 0].abs())
            off = (card.argmax(-1) != cpu.argmax(-1)) & clear
            worst.append(rel.max().item())
            flips += int(off.sum())
            tight += int((~clear).sum())
            if worst[-1] > LOGIT_TOL or off.any():
                raise AssertionError(
                    f"ProtoNet episode {i}: card vs CPU max rel diff "
                    f"{worst[-1]}, {int(off.sum())} argmax flips")
    finally:
        dgcnn.fused_edgeconv_infer = saved
    phase(f"card_vs_cpu protonet episode by episode ({len(episodes)}, "
          "card graphs replayed)", points_per_episode=card.shape[0]
          * card.shape[1], max_rel_diff=worst, tol=LOGIT_TOL,
          argmax_flips=flips, near_tie_points=tight,
          graph_rows_differing=rows)


def check_label_propagate(dev, learner, episode):
    """MPTI's graph of one eval episode on the card ((2 + 1) x 100
    prototypes + 2 x 2048 query points = 4,396 nodes of 192 features):
    label_propagate of the card's affinity on the card against the CPU
    in fp64 (max |diff| / max |z| <= LP_TOL, argmax agreement on the
    query rows >= CPU_AGREE), and the card's times of the affinity and
    the solve."""
    from gfs3dseg_gws_tpu_torch.ops.linalg import (
        label_propagate, local_constrained_affinity)

    model = learner.model.eval()
    sx, sy, qx, _ = learner._episode_args(episode)
    with torch.inference_mode():
        s_feat, q_feat = model.support_query_features(sx, qx)
        node_feat, y0, num_p = model.graph_nodes(s_feat, sy, q_feat)

        def affinity():
            return local_constrained_affinity(node_feat, model.k_connect,
                                              model.sigma)

        a = affinity()
        z = label_propagate(a, y0).cpu().double()
        z64 = label_propagate(a.cpu().double(), y0.cpu().double())
        err = ((z - z64).abs().max() / z64.abs().max()).item()
        agree = (z[num_p:].argmax(-1) == z64[num_p:].argmax(-1)).double(
            ).mean().item()
        affinity_ms = cuda_ms(affinity, FS_REPS)
        solve_ms = cuda_ms(lambda: label_propagate(a, y0), FS_REPS)
    phase("card_vs_cpu label_propagate", nodes=node_feat.shape[0],
          feat=node_feat.shape[1], rel_err=err, argmax_agree=agree,
          affinity_ms=affinity_ms, solve_ms=solve_ms)
    if node_feat.shape[0] != 3 * 100 + 2 * N:
        raise AssertionError(f"MPTI graph of {node_feat.shape[0]} nodes")
    if err > LP_TOL or agree < CPU_AGREE:
        raise AssertionError("label_propagate: card and CPU disagree")


def episode_ms(dev, name: str, learner, episode):
    """One train and one test episode of a trained learner on device
    tensors: CUDA-event medians (FS_REPS repetitions), and the train
    episode's kernel time by group from torch.profiler against its wall
    (device idle share = 1 - kernels / wall)."""
    from gfs3dseg_gws_tpu_torch.parallel.steps import (fewshot_test_step,
                                                       fewshot_train_step)

    args = learner._episode_args(episode)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def train():
        return fewshot_train_step(learner.model, learner.opt, *args, gen,
                                  learner.sched)

    train_ms = cuda_ms(train, FS_REPS)
    test_ms = cuda_ms(lambda: fewshot_test_step(learner.model, *args),
                      FS_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FS_REPS):
        train()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / FS_REPS
    groups, launches = profile_groups(train, FS_REPS)
    numbers = {}
    if groups is not None:
        kernels = sum(groups.values())
        numbers = dict(kernel_ms=kernels, idle_share=1.0 - kernels / wall_ms,
                       launches=launches, groups_ms=json.dumps(
                           {k: round(v, 4) for k, v in groups.items()
                            if v > 0}))
    phase(f"device episode {name}", train_ms=train_ms, test_ms=test_ms,
          train_wall_ms=wall_ms, **numbers)


def check_baselines(dev, root: str, pre_ckpt: str, test_dir: str):
    """The six baseline phases of pretrain_cli on the card at the default
    widths from the default-width pre-training checkpoint, with their
    launches: prototrain (FS_ITERS episodes, one validation) -> protoeval
    from its checkpoint; mptitrain (FS_MPTI_ITERS) -> mptieval; mptigfs
    (FS_BLOCKS base and query blocks); finetune (FT_EPISODES episodes of
    FT_ITERS inner steps). A train episode runs the encoder twice (support,
    query), an eval episode too; FineTune's frozen encoder runs no K4b.
    Then a ProtoNet test episode and MPTI's label propagation card vs
    CPU, and the device time of an episode."""
    from gfs3dseg_gws_tpu_torch.data.episodes import StaticEpisodeBank
    from gfs3dseg_gws_tpu_torch.pipelines.baselines import (
        FewShotConfig, make_finetune_loop)
    from gfs3dseg_gws_tpu_torch.utils.config import ModelConfig

    data_dir = pretrain_data(root)
    save = os.path.join(root, "baselines") + "/"
    bank = math.comb(6, 2) * FS_BANK   # S3DIS fold 0: six novel classes
    att = ("--use_attention",)
    pretrained = ("--pretrain_checkpoint_path", pre_ckpt)
    seconds = {}

    res, seconds["prototrain"] = run_baseline(
        dev, "prototrain", baseline_argv(
            dev, "prototrain", data_dir, save, "--n_iters", str(FS_ITERS),
            "--eval_interval", str(FS_ITERS), *att, *pretrained),
        expected_launches(DEFAULT_WIDTHS, 2 * FS_ITERS, 2 * bank, True))
    proto = res["learner"]
    proto_dir = save + "log_proto_s3dis_S0_N2_K1_TL0_Att1"
    evaluated, seconds["protoeval"] = run_baseline(
        dev, "protoeval", baseline_argv(
            dev, "protoeval", data_dir, save, "--model_checkpoint_path",
            proto_dir, *att),
        expected_launches(DEFAULT_WIDTHS, 0, 2 * bank, True))
    train_res, seconds["mptitrain"] = run_baseline(
        dev, "mptitrain", baseline_argv(
            dev, "mptitrain", data_dir, save, "--n_iters",
            str(FS_MPTI_ITERS), "--eval_interval", str(FS_MPTI_ITERS), *att,
            *pretrained),
        expected_launches(DEFAULT_WIDTHS, 2 * FS_MPTI_ITERS, 2 * bank, True))
    mpti = train_res["learner"]
    check_reloaded("protoeval", evaluated, res)
    mpti_dir = os.path.join(save, "log_mpti_S0_N2_K1_Att1_")
    evaluated, seconds["mptieval"] = run_baseline(
        dev, "mptieval", baseline_argv(
            dev, "mptieval", data_dir, save, "--model_checkpoint_path",
            mpti_dir, *att),
        expected_launches(DEFAULT_WIDTHS, 0, 2 * bank, True))
    check_reloaded("mptieval", evaluated, train_res)
    # forwards: the base blocks, one a novel class's support shot, the
    # query blocks
    _, seconds["mptigfs"] = run_baseline(
        dev, "mptigfs", baseline_argv(
            dev, "mptigfs", data_dir, save + "mptigfs",
            "--model_checkpoint_path", mpti_dir, "--testing_data_path",
            test_dir, *att),
        expected_launches(DEFAULT_WIDTHS, 0, 2 * FS_BLOCKS + 6, True),
        max_base_blocks=FS_BLOCKS, max_query_blocks=FS_BLOCKS)
    ft = expected_launches(DEFAULT_WIDTHS, FT_ITERS * FT_EPISODES,
                           FT_EPISODES)
    ft["k4b"] = 0
    _, seconds["finetune"] = run_baseline(
        dev, "finetune", baseline_argv(
            dev, "finetune", data_dir, save, "--n_iters", str(FT_ITERS),
            *pretrained),
        ft, max_episodes=FT_EPISODES)

    test_bank = StaticEpisodeBank(data_dir, "s3dis", num_episode_per_comb=
                                  FS_BANK, n_way=2, k_shot=1, num_point=N,
                                  mode="test")
    episode = test_bank[0]
    proto_episodes = [test_bank[i] for i in range(PROTO_EPISODES)]
    check_proto_vs_cpu(dev, proto, proto_episodes)
    check_proto_episodes_vs_cpu(dev, proto, proto_episodes)
    check_label_propagate(dev, mpti, episode)
    episode_ms(dev, "protonet", proto, episode)
    episode_ms(dev, "mpti", mpti, episode)
    model, new_opt, inner, _ = make_finetune_loop(
        ModelConfig(), FewShotConfig(device=dev.type), 3, device=dev)
    sx = torch.from_numpy(episode[0].reshape(-1, N, 9)).to(dev)
    sy = torch.from_numpy((episode[1] * np.array([1, 2])[:, None, None])
                          .reshape(-1, N).astype(np.int64)).to(dev)
    opt = new_opt()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phase("device step finetune inner", ms=cuda_ms(
        lambda: inner(opt, sx, sy, gen), FS_REPS))
    phase("baselines", **{f"{k}_seconds": v for k, v in seconds.items()})


# --------------------------------------------------------------------------- #
# preprocessing: raw rooms and scans -> blocks -> evaluation
# --------------------------------------------------------------------------- #

def write_s3dis_raw(raw: str) -> None:
    """A raw S3DIS tree (Stanford3dDataset_v1.2_Aligned_Version layout,
    tests/test_collect.py:28): Areas 1-6, Area_1/office_1 at the size of an
    average S3DIS room (RAW_ROOM_POINTS over RAW_ROOM_M), one room of
    SMALL_ROOM_POINTS over 2 x 2 m in each other Area and two in Area_6
    (the test split). Each room is one instance file of every class, its
    points uniform over the room, plus `stairs`, a class the registry
    lacks (clutter); each room sits at its own offset, as S3DIS rooms do
    in their Area's frame."""
    from gfs3dseg_gws_tpu_torch.data.registry import S3DIS_CLASSNAMES

    rng = np.random.default_rng(SEED + 3)
    names = S3DIS_CLASSNAMES + ["stairs"]
    rooms = [("Area_1", "office_1", RAW_ROOM_POINTS, RAW_ROOM_M)]
    rooms += [(f"Area_{a}", "office_1", SMALL_ROOM_POINTS, (2.0, 2.0))
              for a in range(2, 6)]
    rooms += [("Area_6", f"office_{r}", SMALL_ROOM_POINTS, (2.0, 2.0))
              for r in (1, 2)]
    for a, (area, room, n, (sx, sy)) in enumerate(rooms):
        anno = os.path.join(raw, area, room, "Annotations")
        os.makedirs(anno)
        per = n // len(names)
        for name in names:
            xyz = rng.uniform((0.0, 0.0, 0.0), (sx, sy, 3.0), (per, 3))
            xyz += (7.5 * a, -3.25 * a, 0.5)
            rgb = rng.integers(0, 256, (per, 3))
            rows = np.concatenate([xyz, rgb], axis=1).tolist()
            with open(os.path.join(anno, f"{name}_1.txt"), "w") as f:
                f.write("".join("%.3f %.3f %.3f %d %d %d\n" % tuple(r)
                                for r in rows))


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary little-endian PLY of the vertices, as ScanNet's
    *_vh_clean_2.ply holds them (x y z float, red green blue uchar)."""
    rows = np.empty(len(xyz), np.dtype([
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
        ("green", "u1"), ("blue", "u1")]))
    for name, col in zip(("x", "y", "z", "red", "green", "blue"),
                         np.concatenate([xyz, rgb], axis=1).T):
        rows[name] = col
    with open(path, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(xyz)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\n"
                 "property uchar blue\nend_header\n").encode())
        f.write(rows.tobytes())


def write_scannet_raw(scans: str, val_names) -> None:
    """Raw ScanNet scans (tests/test_collect.py:41-84 layout: ply,
    segs.json, aggregation.json): the first two named after scenes of the
    vendored v2 validation list (the test split), the others train scenes;
    SCAN_POINTS vertices over SCAN_M each. The over-segmentation is a grid
    of SCAN_CELL cells, one segment a cell and one segGroup (instance) a
    segment, the class of a cell varying with its place and the scan; a
    cell's group names the raw category of SCANNET_RAW (class 0: a label
    the tsv lacks, so class 0). Every 11th segment is in no group (its
    vertices are left out) and every 13th group also names the next
    segment (emitted twice)."""
    rng = np.random.default_rng(SEED + 5)
    nx, ny = (int(round(m / SCAN_CELL)) for m in SCAN_M)
    names = list(val_names[:2]) + [f"scene09{90 + s}_00" for s in range(3)]
    for s, scene in enumerate(names):
        sdir = os.path.join(scans, scene)
        os.makedirs(sdir)
        xyz = rng.uniform((0.0, 0.0, 0.0), (*SCAN_M, 3.0),
                          (SCAN_POINTS, 3)).astype(np.float32)
        write_ply(os.path.join(sdir, f"{scene}_vh_clean_2.ply"), xyz,
                  rng.integers(0, 256, (SCAN_POINTS, 3)))
        cell = (np.minimum(xyz[:, 0] // SCAN_CELL, nx - 1)
                + nx * np.minimum(xyz[:, 1] // SCAN_CELL, ny - 1))
        with open(os.path.join(
                sdir, f"{scene}_vh_clean_2.0.010000.segs.json"), "w") as f:
            json.dump({"segIndices": cell.astype(int).tolist()}, f)
        groups = []
        for g in range(nx * ny):
            if g % 11 == 5:
                continue
            cls = (g % nx + 5 * (g // nx) + 7 * s) % len(SCANNET_RAW)
            groups.append({"label": SCANNET_RAW[cls], "segments":
                           [g, g + 1] if g % 13 == 0 else [g]})
        with open(os.path.join(sdir, f"{scene}.aggregation.json"), "w") as f:
            json.dump({"segGroups": groups}, f)


def block_tree(root: str):
    """{path under root: bytes} of every block file of a dataset root."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "blocks_*", "data",
                                              "*.npy"))):
        with open(path, "rb") as f:
            out[os.path.relpath(path, root)] = f.read()
    return out


def cut_blocks(dev, out: str, dataset: str):
    """`preprocess_cli room2blocks` for both splits on the card into `out`,
    and with `--device cpu` on a copy of its scenes: the card's block
    files must be the host's, name for name and byte for byte. Returns
    (the card's block count, the seconds of the card's and the host's
    runs)."""
    import shutil

    from gfs3dseg_gws_tpu_torch.cli import preprocess_cli

    host = out + "_host"
    shutil.copytree(os.path.join(out, "scenes"), os.path.join(host, "scenes"))
    seconds = {}
    for d, device in ((out, dev.type), (host, "cpu")):
        t0 = time.perf_counter()
        for split in (["--train"], []):
            preprocess_cli.main(["room2blocks", "--data_path",
                                 os.path.join(d, "scenes"), "--dataset",
                                 dataset, "--device", device] + split)
        seconds[device] = time.perf_counter() - t0
    card, ref = block_tree(out), block_tree(host)
    if sorted(card) != sorted(ref) or card != ref:
        raise AssertionError(f"{dataset}: room2blocks on the card wrote "
                             f"{len(card)} block files, the host {len(ref)}, "
                             "or their bytes differ")
    return len(card), seconds[dev.type], seconds["cpu"]


def evaluate_blocks(dev, root: str, name: str, dataset: str, train_dir: str,
                    test_dir: str, basis_path: str, pth: str, *extra):
    """`train_cli --only_evaluate` on the card on the blocks in
    train_dir / test_dir: K1/K2 launches against eval_forwards, finite
    per-seed mIoUs. Returns its result."""
    from gfs3dseg_gws_tpu_torch.cli import train_cli

    argv = ["--phase", "test", "--only_evaluate", "--dataset", dataset,
            "--cvfold", "0", "--data_path", train_dir,
            "--testing_data_path", test_dir, "--basis_path", basis_path,
            "--model_checkpoint_path", pth, "--save_path",
            os.path.join(root, name), "--pc_npts", str(N), "--k_shot", "5",
            "--eval_weight", "1.2", "--energy", "0.9", "--batch_size",
            str(B), "--device", dev.type, *extra]
    read = reset_launches()
    t0 = time.perf_counter()
    res = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    setup = gfs_setup(train_dir, test_dir, dataset)
    forwards = eval_forwards(setup, res["coding_sweep"])
    phase(name, per_seed_miou=[round(float(v), 6) for v in
                               res["per_seed"][:, 0]],
          mean_iou=res["mean_iou"], base_iou=res["base_iou"],
          novel_iou=res["novel_iou"], hm_iou=res["hm_iou"],
          blocks=res["n_blocks"], wall_seconds=wall, forwards=forwards,
          **{f"{k}_launches": v for k, v in launches.items()})
    if not np.isfinite(res["per_seed"]).all():
        raise AssertionError(f"{name}: non-finite per-seed mIoU "
                             f"{res['per_seed']}")
    check_launches(name, launches,
                   expected_launches(DEFAULT_WIDTHS, 0, forwards, True))
    return res


def check_raw_s3dis(dev, root: str, basis_path: str, pth: str):
    """Raw S3DIS rooms -> `preprocess_cli collect_s3dis` (both splits) ->
    `room2blocks --device cuda`, held to `--device cpu` byte for byte, the
    large room's room2blocks timed on the card and on the host (median
    of 3, the arrays equal) -> `train_cli --only_evaluate` on the card's
    blocks with make_inputs' seeded weights and basis."""
    from gfs3dseg_gws_tpu_torch.cli import preprocess_cli
    from gfs3dseg_gws_tpu_torch.data import preprocess as pp

    t0 = time.perf_counter()
    raw, out = os.path.join(root, "raw_s3dis"), os.path.join(root, "s3dis")
    write_s3dis_raw(raw)
    t1 = time.perf_counter()
    for split in (["--train"], []):
        preprocess_cli.main(["collect_s3dis", "--data_path", raw,
                             "--out_root", out] + split)
    t2 = time.perf_counter()
    n_blocks, card_s, host_s = cut_blocks(dev, out, "s3dis")

    room = np.load(os.path.join(out, "scenes", "train_data",
                                "Area_1_office_1.npy"))
    times = {}
    for device in (dev, torch.device("cpu")):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            blocks = pp.room2blocks(room, device=device)
            runs.append(time.perf_counter() - t)
        times[device.type] = (statistics.median(runs), blocks)
    card, host = times[dev.type][1], times["cpu"][1]
    if len(card) != len(host) or any(
            a.dtype != b.dtype or a.shape != b.shape
            or a.tobytes() != b.tobytes() for a, b in zip(card, host)):
        raise AssertionError("room2blocks: the card's blocks of the large "
                             "room are not the host's")
    phase("raw S3DIS -> blocks", large_room_points=room.shape[0],
          large_room_blocks=len(card), large_room_card_seconds=times[
              dev.type][0], large_room_host_seconds=times["cpu"][0],
          write_raw_seconds=t1 - t0, collect_seconds=t2 - t1,
          room2blocks_cli_card_seconds=card_s,
          room2blocks_cli_host_seconds=host_s, block_files=n_blocks,
          card_equals_host="byte for byte")
    evaluate_blocks(dev, root, "evaluate_gfs on raw S3DIS blocks", "s3dis",
                    os.path.join(out, "blocks_bs1_s1"),
                    os.path.join(out, "blocks_bs1_s1_test"), basis_path, pth)


def check_raw_scannet(dev, root: str, basis_path: str):
    """Raw ScanNet scans -> `preprocess_cli collect_scannet` (the vendored
    meta: the two scans named after v2 validation scenes go to the test
    split) -> `room2blocks --dataset scannet --device cuda`, held to the
    host's -> a full-width GWCAPL with seeded random weights at the
    ScanNet class count (21, 15 base) through `train_cli --only_evaluate
    --dataset scannet`: finite per-seed mIoUs, class 0 out of every
    aggregate (per_class holds classes 1-20; mIoU is their mean)."""
    from gfs3dseg_gws_tpu_torch.cli import preprocess_cli
    from gfs3dseg_gws_tpu_torch.data import preprocess as pp
    from gfs3dseg_gws_tpu_torch.data.registry import SCANNET_CLASSNAMES
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL

    tsv = pp.load_scannet_label_map(pp.scannet_meta_paths()[0],
                                    SCANNET_CLASSNAMES)
    if [tsv.get(r, 0) for r in SCANNET_RAW] != list(range(21)):
        raise AssertionError("SCANNET_RAW does not map to classes 0-20")
    t0 = time.perf_counter()
    scans, out = os.path.join(root, "scans"), os.path.join(root, "scannet")
    write_scannet_raw(scans, pp.load_scannet_val_scenes())
    t1 = time.perf_counter()
    preprocess_cli.main(["collect_scannet", "--data_path", scans,
                         "--out_root", out])
    split = {sub: len(os.listdir(os.path.join(out, "scenes", sub)))
             for sub in ("train_data", "test_data")}
    t2 = time.perf_counter()
    n_blocks, card_s, host_s = cut_blocks(dev, out, "scannet")
    phase("raw ScanNet -> blocks", scans=len(os.listdir(scans)),
          scenes=split, vertices_per_scan=SCAN_POINTS,
          write_raw_seconds=t1 - t0, collect_seconds=t2 - t1,
          room2blocks_cli_card_seconds=card_s,
          room2blocks_cli_host_seconds=host_s, block_files=n_blocks,
          card_equals_host="byte for byte")
    if split != {"train_data": 3, "test_data": 2}:
        raise AssertionError(f"ScanNet split {split}")
    model = GWCAPL(classes=21, base_num=15, num_gw=NUM_GW,
                   generator=torch.Generator().manual_seed(SEED + 4))
    pth = os.path.join(root, "ckpt_scannet", "model.pth")
    os.makedirs(os.path.dirname(pth))
    torch.save({"epoch": 0, "state_dict": model.state_dict(),
                "optimizer": {}, "max_iou": 0.0}, pth)
    res = evaluate_blocks(dev, root, "evaluate_gfs on raw ScanNet blocks",
                          "scannet", os.path.join(out, "blocks_bs1_s1"),
                          os.path.join(out, "blocks_bs1_s1_test"),
                          basis_path, pth, "--total_classes", "21")
    per_class = np.asarray(res["per_class"])
    if per_class.shape != (20,) or abs(res["mean_iou"]
                                       - per_class.mean()) > 1e-9:
        raise AssertionError(f"ScanNet: class 0 in the aggregates "
                             f"({per_class.shape}, {res['mean_iou']})")


# --------------------------------------------------------------------------- #
# the checkpoint converter and trace
# --------------------------------------------------------------------------- #

def npz_round_trip(src: str, modes, tmp: str, carried=(),
                   keep=lambda key: True):
    """`src` through convert_checkpoint's two `modes` (npz -> reference
    file -> npz): every array `keep` selects and the metadata the
    reference file carries (`carried`) must come back bit for bit.
    Returns the number of arrays."""
    from gfs3dseg_gws_tpu_torch.cli import convert_checkpoint
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import load_checkpoint

    mid, back = tmp + (".pth" if modes[0] in ("npz-to-gfs", "npz-to-coding")
                       else ""), tmp + ".npz"
    convert_checkpoint.main([modes[0], src, mid])
    convert_checkpoint.main([modes[1], mid, back])
    if modes[0] == "npz-to-coding":
        with np.load(src) as a, np.load(back) as b:
            ref, got, meta = {"coding": a["coding"]}, {
                "coding": b["coding"]}, ({}, {})
    else:
        (ref, m_ref), (got, m_got) = load_checkpoint(src), load_checkpoint(
            back)
        ref = {k: v for k, v in ref.items() if keep(k)}
        meta = ({k: v for k, v in m_ref.items() if k in carried},
                {k: v for k, v in m_got.items() if k in carried})
    if (sorted(got) != sorted(ref) or meta[0] != meta[1] or any(
            got[k].dtype != v.dtype or np.ascontiguousarray(got[k]).tobytes()
            != np.ascontiguousarray(v).tobytes() for k, v in ref.items())):
        raise AssertionError(f"{modes}: {src} does not come back bit for "
                             "bit")
    return len(ref)


def check_converter(dev, root: str, gfs_run, pre_ckpts, proto_dir: str,
                    coding_npz: str):
    """cli/convert_checkpoint.py on what the main path wrote: the GFS npz
    of phases 10-13 through npz-to-gfs and gfs-to-npz, its .pth evaluated
    by `train_cli --only_evaluate` (the per-seed mIoUs must be the npz's
    exactly); the pre-training checkpoints at the default and semseg
    widths (npz-to-pretrain, pretrain-to-npz: the tar holds the encoder
    alone), the ProtoNet checkpoint of the baselines phase (npz-to-fewshot,
    fewshot-to-npz) and phase 4's base coding (npz-to-coding,
    coding-to-npz)."""
    from gfs3dseg_gws_tpu_torch.cli import convert_checkpoint, train_cli

    t0 = time.perf_counter()
    tmp = os.path.join(root, "converted")
    os.makedirs(tmp)
    arrays = {"gfs": npz_round_trip(gfs_run["checkpoint"],
                                    ("npz-to-gfs", "gfs-to-npz"),
                                    os.path.join(tmp, "gfs"),
                                    ("epoch", "max_iou"))}
    for name, tar in pre_ckpts.items():
        arrays[name] = npz_round_trip(
            os.path.join(os.path.dirname(tar), "checkpoint.npz"),
            ("npz-to-pretrain", "pretrain-to-npz"),
            os.path.join(tmp, name), keep=lambda key: "/encoder/" in key)
    arrays["protonet"] = npz_round_trip(
        os.path.join(proto_dir, "checkpoint.npz"),
        ("npz-to-fewshot", "fewshot-to-npz"), os.path.join(tmp, "proto"),
        ("iteration", "IoU", "loss"))
    arrays["coding"] = npz_round_trip(coding_npz, ("npz-to-coding",
                                                   "coding-to-npz"),
                                      os.path.join(tmp, "coding"))
    t1 = time.perf_counter()

    # the .pth beside the npz, so that evaluate_gfs finds the same coding
    npz = gfs_run["checkpoint"]
    pth = os.path.join(os.path.dirname(npz), "converted.pth")
    convert_checkpoint.main(["npz-to-gfs", npz, pth])
    read = reset_launches()
    ev = train_cli.main(gfs_run["argv"] + [
        "--phase", "test", "--only_evaluate", "--model_checkpoint_path",
        pth, "--save_path", os.path.join(root, "gfs_from_pth"),
        "--eval_weight", "1.2", "--energy", "0.9"])
    torch.cuda.synchronize()
    launches = read()
    ref = gfs_run["evaluated"]
    diff = float(np.abs(ev["per_seed"] - ref["per_seed"]).max())
    phase("converter", round_trips=arrays, round_trip_seconds=t1 - t0,
          pth_per_seed_miou=[round(float(v), 6) for v in
                             ev["per_seed"][:, 0]],
          npz_per_seed_miou=[round(float(v), 6) for v in
                             ref["per_seed"][:, 0]],
          pth_vs_npz_max_diff=diff, coding_sweep=ev["coding_sweep"],
          **{f"{k}_launches": v for k, v in launches.items()})
    if not np.array_equal(ev["per_seed"], ref["per_seed"]):
        raise AssertionError("the converted .pth does not reproduce the "
                             "npz's per-seed mIoU")
    if launches != gfs_run["eval_launches"]:
        raise AssertionError(f"the .pth evaluation launched {launches}, "
                             f"the npz's {gfs_run['eval_launches']}")


def check_trace(dev, root: str, step):
    """TRACE_STEPS calls of `step` (default-width gfs_train_steps) inside
    the port's `trace`: its Chrome-trace JSON must hold device time under
    the kernel symbols of K3, K4a, K4b, K5a and K5b (ms a step, beside
    profile_groups' figure for as many further steps)."""
    from gfs3dseg_gws_tpu_torch.utils.observability import trace

    step()
    torch.cuda.synchronize()
    log_dir = os.path.join(root, "trace")
    t0 = time.perf_counter()
    with trace(log_dir):
        for _ in range(TRACE_STEPS):
            step()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    files = glob.glob(os.path.join(log_dir, "*.json"))
    if len(files) != 1:
        raise AssertionError(f"trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    traced = {name: 0.0 for name, _ in KERNEL_GROUPS}
    n_kernels = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        n_kernels += 1
        key = next((name for name, pats in KERNEL_GROUPS
                    if any(p in e["name"] for p in pats)), None)
        if key is not None:
            traced[key] += e["dur"] / 1e3 / TRACE_STEPS
    profiled, _ = profile_groups(step, TRACE_STEPS)
    want = [name for name, _ in KERNEL_GROUPS
            if name.split()[0] in ("K3", "K4a", "K4b", "K5a", "K5b")]
    phase("trace gfs_train_step", steps=TRACE_STEPS,
          file=os.path.basename(files[0]),
          megabytes=os.path.getsize(files[0]) / 2 ** 20,
          kernel_events_per_step=n_kernels / TRACE_STEPS,
          seconds=t1 - t0, columns="[trace ms, profile_groups ms] a step",
          **{name.split()[0]: [round(traced[name], 4),
                               round(profiled[name], 4) if profiled
                               else None] for name in want})
    missing = [name for name in want if not traced[name] > 0.0]
    if missing:
        raise AssertionError(f"the trace holds no device time under "
                             f"{missing}")


def main() -> int:
    # ---- phase 0: the card
    t_start = time.perf_counter()
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
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    check_edgeconv(dev, 9, gen)
    stats = {"k1": check_edgeconv(dev, 64, gen),
             "k2": check_attention(dev, gen)}
    check_knn_stats(dev, 9, gen)
    stats["k3"] = check_knn_stats(dev, 64, gen)
    stats["k4a"], stats["k4b"] = check_fused_train(dev, gen)
    stats["k5a"], stats["k5b"] = check_attention_train(dev, gen)
    check_knn_indices(dev, 9, gen)
    stats["k6"] = check_knn_indices(dev, 64, gen)
    stats["k7"] = check_scatter(dev, gen)
    stats["k9"] = check_gather_conv(dev, gen)
    PHASE_SECONDS["kernels"] = time.perf_counter() - t0
    check_knn_fold(dev, 9, gen)
    stats["k8"] = timed("k8", check_knn_fold, dev, 64, gen)
    wide = timed("wide_kernels", check_wide_kernels, dev, gen)
    timed("knn_ties", check_knn_ties, dev, gen)

    with tempfile.TemporaryDirectory(prefix="gfs_chip_smoke_") as root:
        # ---- phase 4: the main path, train_cli --only_evaluate on the card
        t_eval = t0 = time.perf_counter()
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

        model_cfg = ModelConfig()
        data_cfg = DataConfig(data_path=train_dir, testing_data_path=test_dir,
                              pc_npts=N, k_shot=5)
        train_cfg = TrainConfig(batch_size=B, eval_weight=1.2, device="cpu")
        setup = port_gfs.build_setup(model_cfg, data_cfg, train_cfg,
                                     np.zeros((NUM_GW, 192), np.float32),
                                     torch.device("cpu"))
        forwards = eval_forwards(setup, res["coding_sweep"])
        mious = [res[k] for k in ("mean_iou", "base_iou", "novel_iou",
                                  "hm_iou")]
        phase("evaluate_gfs", mean_iou=mious[0], base_iou=mious[1],
              novel_iou=mious[2], hm_iou=mious[3], blocks=res["n_blocks"],
              sweep_seconds=res["sweep_seconds"],
              sweep_blocks_per_s=res["n_blocks"] / res["sweep_seconds"],
              wall_seconds=wall, forwards=forwards,
              **{f"{k}_launches": v for k, v in eval_launches.items()})
        if not all(math.isfinite(m) for m in mious):
            raise AssertionError(f"non-finite mIoU {mious}")
        check_launches("evaluate_gfs", eval_launches,
                       expected_launches(DEFAULT_WIDTHS, 0, forwards, True))

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
        PHASE_SECONDS["evaluation"] = time.perf_counter() - t_eval

        # ---- phase 5b: raw data -> blocks -> evaluation: raw S3DIS rooms
        # (one of a million points) and ScanNet scans through
        # preprocess_cli, room2blocks on the card held to the host's, the
        # blocks through train_cli --only_evaluate
        timed("raw_s3dis", check_raw_s3dis, dev, root, basis_path, pth)
        timed("raw_scannet", check_raw_scannet, dev, root, basis_path)

        # ---- phases 6-9: pre-training, geometric words from its
        # checkpoint, the learning check, card vs CPU
        pre_ckpt = timed("pretrain", check_pretrain, dev, root)
        gw_path = timed("basis", run_basis, dev, root, pre_ckpt,
                        DEFAULT_WIDTHS, "basis")
        timed("learning_check", check_learning, dev, root)
        timed("card_vs_cpu_pretrain_step", check_train_step_vs_cpu, dev,
              root)

        # ---- phases 10-13: GFS training from the pre-trained encoder and
        # its basis, the learning check, the train step alone, card vs CPU
        train_launches, gfs, gfs_run = timed(
            "gfs_train_and_evaluate", check_gfs_train, dev, root, test_dir,
            gw_path, pre_ckpt)
        gp = torch.from_numpy(port_gfs.load_basis(gw_path)).to(dev)
        timed("gfs_learning_check", check_gfs_learning, dev, gfs, gp)
        timed("gfs_step", check_gfs_step, dev, gfs, gp)
        timed("card_vs_cpu_gfs_step", check_gfs_step_vs_cpu, dev, gfs, gp)

        # ---- phase 13a: data parallelism (parallel/mesh.py): 2 gloo ranks
        # on the card against one process (train steps, evaluate_gfs), and
        # train_cli under torchrun on NCCL
        dp_one = timed("dp", check_dp, dev, root,
                       (train_dir, test_dir, basis_path, pth), res, gw_path,
                       pre_ckpt)

        # ---- phase 13c: the data x points mesh (--mesh dxp): evaluate_gfs
        # over 2 x 2 gloo ranks on the card against one process, a batch
        # of 16,384-point blocks over 1 x 2, train_cli under torchrun
        timed("dxp", check_dxp, dev, root,
              (train_dir, test_dir, basis_path, pth), dp_one, gpu_model,
              basis_np, heads)

        # ---- phase 13b: the few-shot baselines (prototrain, protoeval,
        # mptitrain, mptieval, mptigfs, finetune) from the pre-trained
        # encoder, card vs CPU for a ProtoNet episode and MPTI's solve
        timed("baselines", check_baselines, dev, root, pre_ckpt, test_dir)

        # ---- phases 14-18: the DGCNN semantic-segmentation widths, pre-
        # training -> basis -> GFS training -> evaluation, card vs CPU for
        # its pre-training step and for Lloyd's iterations
        t0 = time.perf_counter()
        seg_ckpt = timed("semseg_pretrain", check_pretrain, dev, root,
                         SEMSEG_WIDTHS, "semseg_pretrain")
        timed("semseg_card_vs_cpu_pretrain_step", check_train_step_vs_cpu,
              dev, root, SEMSEG_WIDTHS)
        seg_gw = timed("semseg_basis", run_basis, dev, root, seg_ckpt,
                       SEMSEG_WIDTHS, "semseg_basis")
        timed("card_vs_cpu_lloyd", check_lloyd, dev, root, seg_ckpt,
              SEMSEG_WIDTHS)
        seg_launches, _, _ = timed("semseg_gfs_train_and_evaluate",
                                   check_gfs_train, dev, root, test_dir,
                                   seg_gw, seg_ckpt, SEMSEG_WIDTHS,
                                   "semseg_gfs_train")
        phase("semseg chain", widths=SEMSEG_WIDTHS,
              seconds=time.perf_counter() - t0)

        # ---- phases 19-22: the DGCNN classification encoder (four
        # one-layer EdgeConv blocks 64, 64, 128, 256, k = 40): pre-training
        # -> basis (512-wide words) -> GFS training -> evaluation, card vs
        # CPU for its pre-training step
        t0 = time.perf_counter()
        cls_ckpt = timed("class_pretrain", check_pretrain, dev, root,
                         CLASS_WIDTHS, "class_pretrain", CLASS_K, WIDE_REPS)
        timed("class_card_vs_cpu_pretrain_step", check_train_step_vs_cpu,
              dev, root, CLASS_WIDTHS, CLASS_K, 2)
        cls_gw = timed("class_basis", run_basis, dev, root, cls_ckpt,
                       CLASS_WIDTHS, "class_basis", CLASS_K)
        cls_launches, _, _ = timed("class_gfs_train_and_evaluate",
                                   check_gfs_train, dev, root, test_dir,
                                   cls_gw, cls_ckpt, CLASS_WIDTHS,
                                   "class_gfs_train", CLASS_K)
        phase("classification chain", widths=CLASS_WIDTHS, k=CLASS_K,
              seconds=time.perf_counter() - t0)

        # ---- phases 23-24: the checkpoint converter on what the main path
        # wrote, trace around the default-width GFS step
        timed("converter", check_converter, dev, root, gfs_run,
              {"default": pre_ckpt, "semseg": seg_ckpt},
              os.path.join(root, "baselines",
                           "log_proto_s3dis_S0_N2_K1_TL0_Att1"),
              os.path.join(root, "eval",
                           "base_class_gp_coding_energy=0.9.npz"))
        step = gfs_step_fn(dev, gfs, gp)
        timed("trace", check_trace, dev, root, step)

    # launches of one main-path run each: K1/K2 in the evaluation
    # (train_cli --only_evaluate), K3-K5 in GFS training at the default
    # widths, K6/K7 in GFS training at the semseg widths; K8 and K9 are on
    # no path. The classification chain's launches are checked above.
    runs = {"eval": ("train_cli --only_evaluate", eval_launches),
            "train": ("train_cli (default widths)", train_launches),
            "semseg": (f"train_cli --edgeconv_widths {SEMSEG_WIDTHS}",
                       seg_launches),
            "none": ("none (not on a model path, as in JAX)", seg_launches)}
    phase("class chain launches", **{f"{k}_launches": v
                                     for k, v in cls_launches.items()})
    kernels = [
        ("k1", "fused_edgeconv_infer", "fused_edgeconv.cu",
         "knn_split_kernel<CP, KMAX, false> + edge_mma_kernel",
         "fused_edgeconv.py:94", "eval"),
        ("k2", "fused_attention", "attention.cu",
         "attention_mma_kernel<DP, KT>", "attention_kernel.py:34", "eval"),
        ("k3", "knn_with_stats", "fused_edgeconv.cu",
         "knn_split_kernel<CP, KMAX, true>", "knn.py:380", "train"),
        ("k4a", "fused_edgeconv_train_fwd", "fused_edgeconv_train.cu",
         "gsf_kernel", "fused_edgeconv_train.py:408", "train"),
        ("k4b", "fused_edgeconv_train_bwd", "fused_edgeconv_train.cu",
         "bwd_kernel", "fused_edgeconv_train.py:408", "train"),
        ("k5a", "attention_train_fwd", "attention_train.cu",
         "attn_train_fwd_mma_kernel<DP, KT>", "attention_train.py:124",
         "train"),
        ("k5b", "attention_train_bwd", "attention_train.cu",
         "attn_train_bwd_mma_kernel<DP, QT>", "attention_train.py:124",
         "train"),
        ("k6", "knn_indices", "fused_edgeconv.cu",
         "knn_split_kernel<CP, KMAX, false>", "knn.py:401", "semseg"),
        ("k7", "gather_neighbors_bwd", "edgeconv.cu",
         "edgeconv_scatter_kernel<V> (V = float4 where C % 4 == 0)",
         "edgeconv.py:98", "semseg"),
        ("k8", "knn_indices_fold", "knn_fold.cu",
         f"knn_stream_kernel<CP, kStats> (k <= {_ext.knn_stream_cap()}), "
         "knn_fold_kernel<CP, F, kStats> past it", "knn.py:193", "none"),
        ("k9", "gather_conv", "fused_edgeconv.cu", "edge_mma_kernel",
         "fused_edgeconv.py:222", "none"),
    ]
    phase("phase seconds", **PHASE_SECONDS)
    phase("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"gfs3dseg_gws_tpu_torch/csrc/{src}", "kernel": cu,
         "replaces": f"gfs3dseg_gws_tpu/ops/{tpu}",
         "launches": runs[run][1][key], "launches_run": runs[run][0],
         **stats[key], **({"wide": wide[key]} if key in wide else {})}
        for key, name, src, cu, tpu, run in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
