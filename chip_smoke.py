"""The PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Builds the hand-written kernels from gfs3dseg_gws_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, then drives the port's main
path - GFS evaluation (`train_cli --only_evaluate`) of the full-width S3DIS
GW/CAPL model with random seeded weights on a synthetic S3DIS-layout
dataset - and checks the card against the CPU. Every phase prints one line
of numbers; any failure raises and the script exits non-zero. The last line
is {"ok": true, "device": {...}}. Needs one CUDA device; imports no JAX.
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
    from gfs3dseg_gws_tpu_torch.ops.knn import pairwise_sq_dists

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
    for b, i in bad:      # each must be a near-tie at the k-th neighbour
        d2 = pairwise_sq_dists(args[0][b, i:i + 1], args[0][b])[0]
        d20, d21 = torch.topk(d2, K + 1, largest=False).values[-2:].tolist()
        if abs(d21 - d20) > TIE_RTOL * max(abs(d20), 1e-30):
            raise AssertionError(f"K1 C={c}: row ({b},{i}) differs by "
                                 f"{diff[b, i].max().item()} without a "
                                 f"near-tie (d20={d20}, d21={d21})")
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
