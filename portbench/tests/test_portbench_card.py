"""On a card: every cell at the small sizes through the kernels, within
its limits, and the control (the reference with the card's own TF32 in
the program's place) outside them. Marked `cuda`; skips without a card.
Run on the card as `python -m pytest -p no:cacheprovider -m cuda
portbench/tests/test_portbench_card.py`."""
import json
import os
import shutil
import tempfile

import pytest
import torch

import control
import run
from tiny import SEED, overrides
from tracer import HERE

CELLS = [w["name"] for w in json.load(open(os.path.join(
    os.path.dirname(HERE), "BENCHMARK.json")))["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run on the card only")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        limits = json.load(f)
    held = {}
    workdir = tempfile.mkdtemp(prefix="portbench_test_")
    try:
        res = run.run(cell, SEED, 0.0, True, card, workdir,
                      overrides=overrides(cell),
                      after=lambda d: held.update(
                          ctl=control.control_numbers(d)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    assert res["correct"], res["compared"]
    assert res["device"]["busy_s"] > 0
    ok, compared = run.judge(held["ctl"], limits)
    assert not ok, compared
