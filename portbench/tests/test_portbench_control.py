"""The control: the plain reference put in the program's place with its
products in TF32 (emulated on the CPU, the card's own TF32 on a card),
judged as the program is. It has to come out not correct under each
cell's limits, while the program at the same size comes out within
them. Small sizes (tests/tiny.py); the control's readings at each cell's
own size come from control.py on the card."""
import json
import os

import pytest

import control
import run
from tiny import run_tiny
from tracer import HERE

CELLS = [w["name"] for w in json.load(open(os.path.join(
    os.path.dirname(HERE), "BENCHMARK.json")))["workloads"]]


def limits(cell):
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    held = {}
    res = run_tiny(cell, after=lambda d: held.update(
        ctl=control.control_numbers(d)))
    ctl = held["ctl"]
    ok, compared = run.judge(ctl, limits(cell))
    assert not ok, compared
    program = {n: c["value"] for n, c in res["compared"].items()}
    worse = [n for n in ctl if ctl[n] > max(3 * program[n], 1e-12)]
    assert worse, (ctl, program)
