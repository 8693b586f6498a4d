"""The PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Builds the hand-written kernels from gfs3dseg_gws_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, then drives the port's two
paths at the full width of the S3DIS model on synthetic S3DIS-layout data:
GFS evaluation (`train_cli --only_evaluate`, random seeded weights) and
backbone pre-training (`pretrain_cli --phase pretrain`, two short epochs
with validation), and checks the card against the CPU on both. Every phase
prints one line of numbers; any failure raises and the script exits
non-zero. The last line is {"ok": true, "device": {...}}. Needs one CUDA
device; imports no JAX.
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
    phase(f"K1 fused_edgeconv ({B},{N},{c}->64) k={K}", max_abs_err=max_err,
          rows_within_tol=share, near_tie_rows=len(bad), kernel_ms=ms,
          plain_ms=plain_ms)
    return max_err, ms, plain_ms


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
    max_err = (got - ref).abs().max().item()
    phase(f"K2 fused_attention ({B},{N},64)", max_abs_err=max_err,
          kernel_ms=ms, plain_ms=plain_ms)
    return max_err, ms, plain_ms


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
    phase(f"K3 knn_with_stats ({B},{N},{c}) k={K}", sets_agree=share,
          order_agree=order,
          near_tie_rows=len(bad), scb_rel_err=err, max_abs_err=max_err,
          kernel_ms=ms, plain_ms=plain_ms)
    return max_err, ms, plain_ms


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
    phase(f"K4 fused_edgeconv_train ({B},{N},64->64) k={K}",
          forward_rel_err=out_err, k4a_rel_err=k4a_err, slots_agree=slots_ok,
          slot_flips=flips, k4b_rel_err=k4b_err,
          grad_measure="max_abs_ratio" if flips == 0 else "rel_l2",
          worst_grad=worst, worst_grad_err=grad_errs[worst], **times)
    return (k4a_abs, times["k4a_ms"], times["k4a_plain_ms"],
            k4b_abs, times["k4b_ms"], times["k4b_plain_ms"])


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
    from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet
    from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import fused_edgeconv_infer
    from gfs3dseg_gws_tpu_torch.ops.knn import knn_with_stats

    for fn in (knn_with_stats, fet._gsf, fet._bwd, fused_edgeconv_infer):
        fn.launches = 0
    return lambda: {"k3": knn_with_stats.launches, "k4a": fet._gsf.launches,
                    "k4b": fet._bwd.launches,
                    "k1": fused_edgeconv_infer.launches}


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


def check_train_step_vs_cpu(dev, root: str):
    """One train step (dropout 0) of the full-width DGCNNSeg from the same
    weights and batch on the card and on the CPU: the loss within
    STEP_RTOL, each gradient's cosine with the CPU's >= GRAD_COS, the
    updated running statistics within STEP_RTOL.

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
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices, knn_with_stats,
                                                neighbor_stats_plain)
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import train_batches

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

    gen = torch.Generator().manual_seed(SEED + 5)
    cpu = DGCNNSeg(8, dropout=0.0, generator=gen)
    card = DGCNNSeg(8, dropout=0.0, device=dev)
    card.load_state_dict(cpu.state_dict())
    points, labels, _ = next(train_batches(pretrain_dataset(root, "train"),
                                           TRAIN_CMP_BLOCKS, seed=SEED,
                                           epoch=1))
    pts = torch.from_numpy(np.asarray(points, np.float32))
    lbl = torch.from_numpy(np.asarray(labels, np.int64))
    runs = {}
    for name, model, device, knn in (("card", card, dev, record),
                                     ("cpu", cpu, "cpu", replay)):
        dgcnn.knn_with_stats = knn
        try:
            model.train()
            loss = cross_entropy(model(pts.to(device)), lbl.to(device))
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
    phase(f"card_vs_cpu pretrain step ({TRAIN_CMP_BLOCKS} blocks)",
          cpu_loss=ref["loss"], card_loss=got["loss"], loss_rel_err=loss_err,
          running_stat_err=stat_err, worst_grad=worst,
          worst_grad_cosine=cos[worst], noise_grads=noise,
          graph_rows_differing=differing)
    if loss_err > STEP_RTOL or stat_err > STEP_RTOL:
        raise AssertionError("card and CPU train steps disagree")
    if cos[worst] < GRAD_COS:
        raise AssertionError(f"gradient of {worst} off the CPU's")


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
    from gfs3dseg_gws_tpu_torch.ops.attention_kernel import fused_attention
    from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import fused_edgeconv_infer
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
    k1_err, k1_ms, k1_plain_ms = check_edgeconv(dev, 64, gen)
    k2_err, k2_ms, k2_plain_ms = check_attention(dev, gen)
    check_knn_stats(dev, 9, gen)
    k3_err, k3_ms, k3_plain_ms = check_knn_stats(dev, 64, gen)
    k4 = check_fused_train(dev, gen)

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
        fused_edgeconv_infer.launches = 0
        fused_attention.launches = 0
        t0 = time.perf_counter()
        res = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1_launches = fused_edgeconv_infer.launches
        k2_launches = fused_attention.launches

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
        launches = check_pretrain(dev, root)
        check_learning(dev, root)
        check_train_step_vs_cpu(dev, root)

    print(json.dumps({"kernels": [
        {"name": "fused_edgeconv_infer", "route": "cuda",
         "source": "gfs3dseg_gws_tpu_torch/csrc/fused_edgeconv.cu",
         "replaces": "gfs3dseg_gws_tpu/ops/fused_edgeconv.py:94",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "fused_attention", "route": "cuda",
         "source": "gfs3dseg_gws_tpu_torch/csrc/attention.cu",
         "replaces": "gfs3dseg_gws_tpu/ops/attention_kernel.py:34",
         "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms},
        {"name": "knn_with_stats", "route": "cuda",
         "source": "gfs3dseg_gws_tpu_torch/csrc/fused_edgeconv.cu",
         "replaces": "gfs3dseg_gws_tpu/ops/knn.py:380",
         "launches": launches["k3"], "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain_ms},
        {"name": "fused_edgeconv_train_fwd", "route": "cuda",
         "source": "gfs3dseg_gws_tpu_torch/csrc/fused_edgeconv_train.cu",
         "replaces": "gfs3dseg_gws_tpu/ops/fused_edgeconv_train.py:408",
         "launches": launches["k4a"], "max_abs_err": k4[0], "ms": k4[1],
         "plain_ms": k4[2]},
        {"name": "fused_edgeconv_train_bwd", "route": "cuda",
         "source": "gfs3dseg_gws_tpu_torch/csrc/fused_edgeconv_train.cu",
         "replaces": "gfs3dseg_gws_tpu/ops/fused_edgeconv_train.py:239",
         "launches": launches["k4b"], "max_abs_err": k4[3], "ms": k4[4],
         "plain_ms": k4[5]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
