"""Time the port's kernels at the model's shapes, for an A/B of two
checkouts on one card.

    cd <checkout> && PYTHONPATH=. python3 <this file> --out run.pt
    python3 <this file> --compare a.pt b.pt [c.pt ...]
    cd <checkout> && PYTHONPATH=. python3 <this file> --ptxas [SOURCE ...]

The first form builds the checkout's kernels, runs K1, K2, K3, K4a, K4b,
K5a, K5b, K6, K7, K8 and K9 at (16, 2048, .), k = 20 (C = 64; K1, K3 and K6
also C = 9; K2, K5a and K5b also at D = 128, the `_d128` entries, and K5a
at D = 30 and 192; K1, K3, K6 and K9 past the fast path, at C = 128,
k = 40, and K6 at k = 80 on (4, 2048, 64), the `_wide` entries, and K4a
and K4b at C = W1 = 128, k = 40, `k4a_wide` and `k4b_wide`; K9 also at
W0 = 30 -> W1 = 40, whose rows take 4-byte copies, `k9_w30`; K7 at
C = 256, `k7_wide`; K8 also at C = 9, `k8_c9`, and at k = 80 on
(4, 2048, 64), `k8_k80`, beside K3 there, `k3_k80`; K6, K3 and K8 at
k = 80 on one row of 30,000 points, C = 9, `k6_long`, `k3_long`,
`k8_long`; where the checkout's K1, K6 and K2 take local queries, also
at nq = 1,024 queries from row 1,024 of the 2,048, `k1_c64_local`,
`k6_c64_local`, `k2_local`) on inputs drawn
from a fixed seed, prints one JSON line of CUDA-event times (ms) beside the
card's name and power limit, and saves the outputs. K5b takes m and den
from K5a's plain twin on the card, so that its inputs do not depend on the
checkout's K5a. `ms` is the median over single calls, each waited for, as
chip_smoke.py times them (the host's time to launch counts where the card
idles); `ms_queued` is the mean of 30 calls queued back to back (the
card's time alone). The second form prints, for each named output of each
kernel (K1's out, K3's idx, cnt and scb, ...), whether the runs agree bit
for bit, their largest difference and the first run's largest magnitude
beside it, and for index outputs (K3, K6 and K8's idx) on how many rows
they differ. An entry that only some runs have (a local one, against a
checkout without local queries) is compared across those runs. Where two
runs' outputs differ in width only (K4b's scat (B, N, 2C) against a
variant that leaves its yhat1 half to a closed form, (B, N, C)), the first
columns they share are compared, and the entry says so. Run the checkouts in turns (A,
B, B, A) in one call: two calls may land on two cards. `--only k6_c64
k3_c9 ...` times those entries alone. The third form compiles the
checkout's attention sources, csrc/fused_edgeconv.cu,
csrc/fused_edgeconv_train.cu, csrc/edgeconv.cu and csrc/knn_fold.cu with
`-Xptxas -v` and prints, for each
kernel, its registers, spills, static shared memory and the
`HMMA.1688.F32.TF32` instructions that `cuobjdump -sass` finds in it, as
one JSON line.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile

import torch

B, N, K = 16, 2048, 20
# the local-query entries, which a checkout without `q_offset` lacks
LOCAL = ("k1_c64_local", "k6_c64_local", "k2_local")


def cuda_ms(fn, reps: int = 30) -> float:
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


def cuda_ms_queued(fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(out: str, only=None) -> None:
    from gfs3dseg_gws_tpu_torch.ops import attention_train as atr
    from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet
    from gfs3dseg_gws_tpu_torch.ops.attention_kernel import fused_attention
    from gfs3dseg_gws_tpu_torch.ops.edgeconv import scatter_bwd
    from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (
        fused_edgeconv_infer, gather_conv)
    from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices, knn_indices_fold,
                                                knn_with_stats)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    x9, x64 = randn(B, N, 9), randn(B, N, 64)
    a, b = randn(B, N, 64), randn(B, N, 64)
    w2, bias2 = randn(64, 64, scale=0.125), randn(64, scale=0.1)
    s1, t1 = randn(64, scale=0.2) + 1.0, randn(64, scale=0.2)
    q, k, v, dy = (randn(B, N, 64) for _ in range(4))
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    idx = knn_indices(x64, K)
    g = randn(B, N, K, 64)
    zmax_args = fet._gsf(a, b, idx, s1, t1, w2, 0.2)
    p1 = torch.stack([s1, t1, randn(64, scale=0.1), randn(64).abs() + 0.5,
                      s1])
    pk = torch.stack([randn(64).abs() + 0.5, randn(64, scale=0.01),
                      randn(64, scale=0.01), randn(64, scale=0.1),
                      randn(64).abs() + 0.5])
    gsel = randn(B, N, 64)
    attn_out, m, den = atr._fwd_plain(q, k, v, seed, 8.0, 0.1)
    delta = (dy * attn_out).sum(-1)
    q2, k2, v2, dy2 = (randn(B, N, 128) for _ in range(4))
    t2 = 128 ** 0.5
    out2, m2, den2 = atr._fwd_plain(q2, k2, v2, seed, t2, 0.1)
    delta2 = (dy2 * out2).sum(-1)
    q3, k3, v3 = (randn(B, N, 30) for _ in range(3))
    t3 = 30 ** 0.5
    q4, k4, v4 = (randn(B, N, 192) for _ in range(3))
    t4 = 192 ** 0.5
    x128, a128, b128 = (randn(B, N, 128) for _ in range(3))
    w128, bias128 = randn(128, 128, scale=128 ** -0.5), randn(128, scale=0.1)
    x4 = randn(4, N, 64)
    idx128 = knn_indices(x128, 40)
    g256 = randn(B, N, K, 256)
    b4 = randn(4, N, 64)
    x_long, b_long = randn(1, 30000, 9), randn(1, 30000, 64)
    a30, b30 = randn(B, N, 30), randn(B, N, 30)
    w30, bias40 = randn(30, 40, scale=30 ** -0.5), randn(40, scale=0.1)
    s1w, t1w = randn(128, scale=0.2) + 1.0, randn(128, scale=0.2)
    p1w = torch.stack([s1w, t1w, randn(128, scale=0.1),
                       randn(128).abs() + 0.5, s1w])
    pkw = torch.stack([randn(128).abs() + 0.5, randn(128, scale=0.01),
                       randn(128, scale=0.01), randn(128, scale=0.1),
                       randn(128).abs() + 0.5])
    gselw = randn(B, N, 128)
    kselw = fet._gsf(a128, b128, idx128, s1w, t1w, w128, 0.2)[3]

    calls = {
        "k1_c9": lambda: fused_edgeconv_infer(x9, a, b, w2, bias2, K),
        "k1_c64": lambda: fused_edgeconv_infer(x64, a, b, w2, bias2, K),
        "k2": lambda: fused_attention(q, k, v, 8.0),
        "k3_c9": lambda: knn_with_stats(x9, b, K),
        "k3_c64": lambda: knn_with_stats(x64, b, K),
        "k4a": lambda: fet._gsf(a, b, idx, s1, t1, w2, 0.2),
        "k4b": lambda: fet._bwd(a, b, idx, p1, w2, gsel, zmax_args[3], pk,
                                0.2),
        "k5a": lambda: atr._fwd(q, k, v, seed, 8.0, 0.1),
        "k5b": lambda: atr._bwd(q, k, v, seed, m, den, delta, dy, 8.0, 0.1),
        "k2_d128": lambda: fused_attention(q2, k2, v2, t2),
        "k5a_d128": lambda: atr._fwd(q2, k2, v2, seed, t2, 0.1),
        "k5a_d30": lambda: atr._fwd(q3, k3, v3, seed, t3, 0.1),
        "k5a_d192": lambda: atr._fwd(q4, k4, v4, seed, t4, 0.1),
        "k5b_d128": lambda: atr._bwd(q2, k2, v2, seed, m2, den2, delta2, dy2,
                                     t2, 0.1),
        "k6_c9": lambda: knn_indices(x9, K),
        "k6_c64": lambda: knn_indices(x64, K),
        "k7": lambda: scatter_bwd(idx, g),
        "k7_wide": lambda: scatter_bwd(idx, g256),
        "k8": lambda: knn_indices_fold(x64, K, 4),
        "k8_c9": lambda: knn_indices_fold(x9, K, 4),
        "k8_k80": lambda: knn_indices_fold(x4, 80, 4),
        "k3_k80": lambda: knn_with_stats(x4, b4, 80),
        "k6_long": lambda: knn_indices(x_long, 80),
        "k3_long": lambda: knn_with_stats(x_long, b_long, 80),
        "k8_long": lambda: knn_indices_fold(x_long, 80, 4),
        "k9": lambda: gather_conv(idx, a, b, w2, bias2),
        "k9_w30": lambda: gather_conv(idx, a30, b30, w30, bias40),
        "k1_wide": lambda: fused_edgeconv_infer(x128, a128, b128, w128,
                                                bias128, 40),
        "k3_wide": lambda: knn_with_stats(x128, b128, 40),
        "k6_wide": lambda: knn_indices(x128, 40),
        "k6_k80_wide": lambda: knn_indices(x4, 80),
        "k9_wide": lambda: gather_conv(idx128, a128, b128, w128, bias128),
        "k4a_wide": lambda: fet._gsf(a128, b128, idx128, s1w, t1w, w128,
                                     0.2),
        "k4b_wide": lambda: fet._bwd(a128, b128, idx128, p1w, w128, gselw,
                                     kselw, pkw, 0.2),
    }
    if "q_offset" in inspect.signature(knn_indices).parameters:
        # local queries (the `data x points` mesh): the second half of the
        # points against all of them; a checkout without them skips these
        h = N // 2
        calls.update({
            "k1_c64_local": lambda: fused_edgeconv_infer(
                x64, a, b[:, h:].contiguous(), w2, bias2, K, q_offset=h),
            "k6_c64_local": lambda: knn_indices(x64, K, q_offset=h, nq=h),
            "k2_local": lambda: fused_attention(q[:, h:].contiguous(), k, v,
                                                8.0)})
    names = {"k3": ("idx", "cnt", "scb"), "k4a": ("snbr", "zmax", "zmin",
                                                  "kmax", "kmin"),
             "k4b": ("scat", "psum", "dw2", "sums")}
    if only:     # (the local entries are left out where the checkout
        # lacks local queries; any other unknown name raises)
        unknown = sorted(set(only) - set(calls) - set(LOCAL))
        if unknown:
            raise KeyError(f"no such entries: {unknown}")
        calls = {name: calls[name] for name in only if name in calls}
    outputs = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    times = {name: cuda_ms(fn) for name, fn in calls.items()}
    queued = {name: cuda_ms_queued(fn) for name, fn in calls.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "ms": times, "ms_queued": queued}),
          flush=True)

    def named(name, o):
        """{output name: tensor on the host}; K4a keeps its per-point outputs
        (the form of its bn2 partials differs between versions)"""
        o = o if isinstance(o, tuple) else (o,)
        keys = names.get(name.split("_")[0])
        if keys is None:
            keys = (("idx",) if o[0].dtype == torch.int32 else
                    ("out",) if len(o) == 1 else
                    tuple(f"out{i}" for i in range(len(o))))
        return {key: t.cpu() for key, t in zip(keys, o)}

    torch.save({name: named(name, o) for name, o in outputs.items()}, out)


def compare(paths) -> None:
    runs = [torch.load(p) for p in paths]
    report = {}
    for name in dict.fromkeys(n for run in runs for n in run):
        # each entry against the first run that has it: the local entries,
        # which a checkout without local queries lacks, are compared across
        # the runs that have them; any other entry must be in every run
        have = [(run, path) for run, path in zip(runs, paths) if name in run]
        if len(have) < len(runs) and name not in LOCAL:
            raise KeyError(f"{name} is missing from a run")
        first = have[0][0][name]
        entry = {}
        for run, path in have[1:]:
            other = run[name]
            res = {}
            for key, x in first.items():
                y = other[key]
                res[key] = {}
                if x.shape[:-1] == y.shape[:-1] and x.shape != y.shape:
                    # K4b's scat: (B, N, 2C) [g1s dy1 | yhat1] against a
                    # variant's (B, N, C) g1s dy1 alone
                    cols = min(x.shape[-1], y.shape[-1])
                    res[key]["compared"] = (
                        f"first {cols} columns of {x.shape[-1]} and "
                        f"{y.shape[-1]}")
                    x, y = x[..., :cols], y[..., :cols]
                res[key]["bit_for_bit"] = torch.equal(x, y)
                if x.is_floating_point():
                    res[key]["max_abs_diff"] = (
                        x.double() - y.double()).abs().max().item()
                    res[key]["max_abs"] = x.abs().max().item()
                elif x.dim() == 3:
                    res[key]["rows_differing"] = (x != y).reshape(
                        -1, x.shape[-1]).any(-1).sum().item()
            entry[path] = res
        report[name] = entry
    print(json.dumps(report), flush=True)


def ptxas(sources=()) -> None:
    from gfs3dseg_gws_tpu_torch.ops import _ext

    nvcc = _ext._nvcc()
    tools = os.path.dirname(nvcc)
    filt = shutil.which("cu++filt", path=tools) or shutil.which("c++filt")
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    report = {"nvcc": version.strip().splitlines()[-1]}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources or ("attention.cu", "attention_train.cu",
                               "fused_edgeconv.cu",
                               "fused_edgeconv_train.cu", "edgeconv.cu",
                               "knn_fold.cu"):
            obj = os.path.join(tmp, src + ".o")
            res = subprocess.run(
                [nvcc, *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                 str(_ext._CSRC), "-c", str(_ext._CSRC / src), "-o", obj],
                capture_output=True, text=True, check=True, timeout=600)
            sass = subprocess.run(
                [os.path.join(tools, "cuobjdump"), "-sass", obj],
                capture_output=True, text=True, check=True,
                timeout=120).stdout
            kernels, fn = {}, None
            for line in (res.stdout + res.stderr).splitlines():
                if found := re.search(r"Function properties for (\S+)", line):
                    fn = kernels.setdefault(found[1], {})
                elif fn is not None and (found := re.search(
                        r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)):
                    fn["spill_stores"], fn["spill_loads"] = map(
                        int, found.groups())
                elif fn is not None and (found := re.search(
                        r"Used (\d+) registers", line)):
                    fn["registers"] = int(found[1])
                    if found := re.search(r"(\d+) bytes smem", line):
                        fn["static_smem_bytes"] = int(found[1])
            for part in sass.split("Function : ")[1:]:
                name = part.split()[0]
                kernels.setdefault(name, {})["hmma_tf32"] = part.count(
                    "HMMA.1688.F32.TF32")
            if filt:
                names = subprocess.run([filt], input="\n".join(kernels),
                                       capture_output=True, text=True,
                                       timeout=60).stdout.split("\n")
                kernels = dict(zip(names, kernels.values()))
            report[src] = {name: kernels[name] for name in kernels
                           if kernels[name].get("registers") is not None}
    print(json.dumps(report), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out")
    p.add_argument("--compare", nargs="+")
    p.add_argument("--ptxas", nargs="*", metavar="SOURCE",
                   help="-Xptxas -v of these csrc sources (default: the "
                   "attention sources, fused_edgeconv.cu, "
                   "fused_edgeconv_train.cu, edgeconv.cu and knn_fold.cu)")
    p.add_argument("--only", nargs="+", help="time these entries alone")
    args = p.parse_args()
    if args.ptxas is not None:
        ptxas(args.ptxas)
    elif args.compare:
        compare(args.compare)
    else:
        run(args.out, args.only)


if __name__ == "__main__":
    main()
