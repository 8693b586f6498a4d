"""The pre-training cell `dgcnnseg_s3dis.pretrain`: its driver at the
small sizes on the CPU (tests/tiny.py) reads correct, each planted fault
reads not correct, the pass's count against a hand count, the readers of
its per-layer metrics on a hand-made trace; on a card, the cell at its
full size within its limits and the TF32 control outside them (marked
`cuda`; run on the card as `python -m pytest -p no:cacheprovider -m cuda
portbench/tests/test_portbench_pretrain.py`)."""
import json
import os
import shutil
import tempfile

import pytest
import torch

import control
import run
from tiny import SEED, run_tiny
from tracer import HERE, Summary, load_module, load_spans

CELL = "dgcnnseg_s3dis.pretrain"
FAULTS = ["unchanged_state", "half_batch", "no_dropout"]


def limits():
    with open(os.path.join(HERE, "limits", f"{CELL}.json")) as f:
        return json.load(f)


def test_the_cell_reads_correct_at_the_small_sizes():
    res = run_tiny(CELL)
    assert res["correct"], res["compared"]
    assert res["compared"]["loader_rows_unmatched"]["value"] == 0.0
    assert res["notes"]["graph_rows"] == 5 * 3 * 4 * 2048


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_comes_out_not_correct(fault):
    res = run_tiny(CELL, fault=fault)
    assert res["correct"] is False
    failed = [n for n, c in res["compared"].items()
              if c["value"] > limits()[n]]
    assert failed, res["compared"]


def test_no_weight_decay_moves_the_first_gradient():
    """Adam without its L2 decay: wd * p is about 1e-4 of a weight, so the
    first gradient moves by more than rounding, though within grad_gap's
    limit, and the changes move where a gradient is zero but for rounding,
    which change_gap leaves out (drivers/pretrain.py::change_gaps): the
    check reads the fault correct (PERF.md). The card tests of the
    replayed step catch a step without the decay
    (tests/test_torch_port_cuda.py)."""
    sound = run_tiny(CELL)["compared"]
    fault = run_tiny(CELL, fault="no_weight_decay")["compared"]
    assert fault["grad_gap"]["value"] > 4 * sound["grad_gap"]["value"]


def counts():
    return load_module(os.path.join(HERE, "counts", "pretrain_block.py"),
                       "counts_pretrain_block")


def config():
    with open(os.path.join(HERE, "configs", "dgcnnseg_s3dis.json")) as f:
        return dict(json.load(f), num_classes=8)


def test_pretrain_block_is_forward_plus_twice_its_differentiable_part():
    n, k = 2048, 20
    mac = (n * n * (9 + 64 + 64)            # three kNN Gram matrices
           + 2 * n * 64 * (9 + 64 + 64)     # neighbour and centre tables
           + 3 * n * k * 64 * 64            # three second edge convs
           + n * 192 * 512 + n * 512 * 256  # point MLP
           + n * 448 * 256 + n * 256 * 128 + n * 128 * 8)   # segmenter
    knn = 2.0 * n * n * (9 + 64 + 64)
    got = counts().flops(config(), n)
    assert counts().forward_flops(config(), n) == 2.0 * mac
    assert got == pytest.approx(2.0 * mac + 2 * (2.0 * mac - knn),
                                rel=1e-12)
    assert round(got / 1e9, 2) == 9.03


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def read(metric, s):
    return load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                       "m_" + metric.replace(".", "_")).read(s)


def test_readers_on_a_hand_made_trace():
    """A stretch of 100 us, two steps: a head span with a GEMM and an
    elementwise kernel in the first step, a kernel outside it."""
    evs = [ev("user_annotation", "portbench.stretch", 0, 100),
           ev("user_annotation", "portbench.pretrain.step", 0, 50),
           ev("user_annotation", "portbench.pretrain.step", 50, 50),
           ev("user_annotation", "portbench.seg_head", 10, 10),
           ev("cuda_runtime", "cudaLaunchKernel", 11, 1, 1),
           ev("kernel", "sm90_xmma_gemm_f32f32", 20, 8, 1, tid=7),
           ev("cuda_runtime", "cudaLaunchKernel", 15, 1, 2),
           ev("kernel", "vectorized_elementwise_kernel", 30, 4, 2, tid=7),
           ev("cuda_runtime", "cudaLaunchKernel", 60, 1, 3),
           ev("kernel", "bwd_kernel", 62, 20, 3, tid=7)]
    s = Summary(evs, load_spans(), {})
    s.blocks, s.cfg = 32, config()
    assert read("pretrain.head_ms", s) == pytest.approx(1e3 * 12e-6 / 2)
    assert read("pretrain.step_ms", s) == pytest.approx(1e3 * 32e-6 / 2)
    assert read("pretrain.idle", s) == pytest.approx(100 * (1 - 0.32))
    peak = load_module(os.path.join(HERE, "tracer.py"), "t").load_peaks()
    assert read("pretrain.mfu", s) == pytest.approx(
        100 * counts().flops(s.cfg, 2048) * 32 / 100e-6
        / peak["tf32_flops_per_s"])
    assert read("pretrain.k4b_roofline", s) is None   # no call recorded
    s = Summary(evs[:3] + evs[8:], load_spans(), {})
    assert read("pretrain.head_ms", s) is None         # no head traced


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run on the card only")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_the_cell_at_full_size_on_the_card(card):
    """The cell at its configuration's and traffic's sizes, traced: correct
    over its five checked steps (the fifth a replay), the per-layer
    metrics read, and the TF32 control outside the limits."""
    held = {}
    workdir = tempfile.mkdtemp(prefix="portbench_test_")
    try:
        res = run.run(CELL, SEED, 0.0, True, card, workdir,
                      after=lambda d: held.update(
                          ctl=control.control_numbers(d)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    assert res["correct"], res["compared"]
    assert res["device"]["busy_s"] > 0
    for name in ("pretrain.step_ms", "pretrain.mfu", "pretrain.head_ms",
                 "pretrain.k4b_roofline", "pretrain.idle",
                 "pretrain.dispatch_ms", "pretrain.replay_share"):
        assert name in res["metrics"], name
    ok, compared = run.judge(held["ctl"], limits())
    assert not ok, compared
