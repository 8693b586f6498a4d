"""Small sizes at which a whole run of a cell fits the CPU: the model at
widths 8, k 5, a 24-word basis; blocks of 2,048 points (the least that
keeps every class of a block above the prepared-data registry's 100
points), few of them: 13 test blocks, so that every class has one (the
GFS metric's IoU raises on a class with no union, as the reference's
does) and the last batch is padded."""
from __future__ import annotations

import shutil
import tempfile

import torch

import run

MODEL = {"dgcnn_k": 5, "edgeconv_widths": [[8, 8], [8, 8], [8, 8]],
         "dgcnn_mlp_widths": [16, 16], "base_widths": [8, 8],
         "output_dim": 8, "main_dim": 8, "num_gw": 24}
EVAL = {"test_blocks": 13, "train_blocks": 13, "batch": 4, "k_shot": 1,
        "support_seeds": [10, 20], "sample_sweeps": 1,
        "trace_skip_sweeps": 0, "trace_sweeps": 1}
TRAIN = {"train_blocks": 13, "batch": 4, "warm_steps": 3,
         "trace_skip_steps": 0, "trace_steps": 2}
SEED = 2 ** 31 + 977          # a seed past 32 signed bits


def overrides(workload: str) -> dict:
    out = dict(MODEL)
    if "semseg" in workload:
        out["edgeconv_widths"] = [[8, 8], [8, 8], [8]]
    out.update(EVAL if "eval" in workload else TRAIN)
    return out


def run_tiny(workload: str, fault=None, trace=False, seed=SEED,
             after=None) -> dict:
    """One run of the cell on the CPU at the small sizes, the device check
    skipped; its result line's object."""
    torch.set_num_threads(4)
    workdir = tempfile.mkdtemp(prefix="portbench_test_")
    try:
        return run.run(workload, seed, 0.0, trace, torch.device("cpu"),
                       workdir, fault=fault, overrides=overrides(workload),
                       after=after)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
