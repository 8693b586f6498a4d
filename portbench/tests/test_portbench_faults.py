"""A run with its timed path broken underneath comes out not correct, for
each fault that the cell can have: in an evaluation cell half of each
batch left out (the counts taken over the rest) and an answer altered
where it is produced; in a training cell a step that returns its state
unchanged and half of each batch left out (the mean taken over the
rest). The cells run on one card, so no exchange between cards can be
left out. The device check is skipped; small sizes (tests/tiny.py)."""
import json
import os

import pytest

from tiny import run_tiny
from tracer import HERE

FAULTS = [("gwcapl_s3dis.eval_sweep", "half_batch"),
          ("gwcapl_s3dis.eval_sweep", "altered_answer"),
          ("gwcapl_s3dis_semseg.eval_sweep", "altered_answer"),
          ("gwcapl_s3dis.gfs_train", "unchanged_state"),
          ("gwcapl_s3dis.gfs_train", "half_batch"),
          ("gwcapl_s3dis_semseg.gfs_train", "half_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_comes_out_not_correct(cell, fault):
    res = run_tiny(cell, fault=fault)
    assert res["correct"] is False
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        limits = json.load(f)
    failed = [n for n, c in res["compared"].items()
              if c["value"] > limits[n]]
    assert failed, res["compared"]
