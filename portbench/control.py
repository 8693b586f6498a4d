"""The readings that the limits in limits/<cell>.json are set from, for
one cell, in one process (benchmark runs never run this):

  program   a sound run of the program at the cell's size and load (a
            short window), on each of `--seeds`;
  control   on the same runs, for the first `--control-seeds` of them, the
            plain reference put in the program's place with every product
            in TF32 (the precision next below the configuration's float32
            with TF32 off), compared with the reference in float32 as the
            program is;
  fault:*   the program with a fault planted in its timed path, on each of
            `--fault-seeds`: eval cells half_batch and altered_answer,
            training cells unchanged_state and half_batch.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 3 --fault-seeds 101,102,103 --seconds 2 \
        --out readings/control_<cell>.jsonl

Each reading is one JSON line {"workload", "seed", "kind", "numbers"}.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import run                                                  # noqa: E402
from reference import gwcapl                                # noqa: E402
from tracer import load_module                              # noqa: E402

FAULTS = {"eval": ("half_batch", "altered_answer"),
          "train": ("unchanged_state", "half_batch")}


def control_numbers(driver) -> dict:
    """The control's numbers: the reference in TF32 judged as the program
    is, against the traffic driver's float32 reference."""
    mod = SimpleNamespace(**type(driver).setup.__globals__)
    if driver.kind == "eval":
        cfg, tr = driver.cfg, driver.traffic
        with gwcapl.precision("tf32"):
            labels, logits, _ = mod.reference_eval(
                driver.state, driver.gp, cfg, tr, driver.train_dir,
                driver.test_dir, driver.device)
        n_cls, bsz = cfg["total_classes"], tr["batch"]
        cms = []
        for b in sorted(logits):
            y = torch.from_numpy(labels[b * bsz:(b + 1) * bsz]).to(
                logits[b].device)
            cell = y[None] * n_cls + logits[b].argmax(-1)
            cms.append(torch.stack([
                torch.bincount(c.reshape(-1), minlength=n_cls * n_cls)
                .reshape(n_cls, n_cls) for c in cell]).double().cpu())
        stand_in = SimpleNamespace(logits=logits, cms=torch.stack(cms),
                                   n_batches=len(cms))
        return mod.compare_eval(stand_in, cfg, tr, driver.reference)
    own = gwcapl.Graphs()
    losses, grads, after = driver.reference_steps("tf32", own)
    graphs = gwcapl.Graphs(own.used)
    reference = driver.reference_steps("fp32", graphs)
    moment = {n: (1.0 - mod.ADAM_BETA1) * g for n, g in grads.items()}
    return mod.compare_train(losses, moment, after, driver.initial,
                             reference, graphs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    kind = load_module(os.path.join(
        HERE, "drivers", run.load_cell(args.workload)[3]["driver"] + ".py"),
        "kind_probe").Driver.kind

    def emit(out, seed, what, numbers, extra=None):
        line = {"workload": args.workload, "seed": seed, "kind": what,
                "numbers": numbers, **(extra or {})}
        out.write(json.dumps(line) + "\n")
        out.flush()
        print(json.dumps(line), flush=True)

    with open(args.out, "a") as out:
        jobs = [(s, None) for s in seeds] + [
            (s, f) for f in FAULTS[kind] for s in fault_seeds]
        for i, (seed, fault) in enumerate(jobs):
            workdir = tempfile.mkdtemp(prefix="portbench_control_")
            held = {}
            t0 = time.perf_counter()
            try:
                res = run.run(args.workload, seed, args.seconds, False,
                              device, workdir, fault=fault, start=t0,
                              after=lambda d: held.setdefault("d", d))
                numbers = {n: c["value"] for n, c in res["compared"].items()}
                emit(out, seed, "program" if fault is None
                     else f"fault:{fault}", numbers,
                     {"metrics": {n: m["value"]
                                  for n, m in res["metrics"].items()},
                      "notes": held["d"].notes,
                      "seconds": time.perf_counter() - t0})
                if fault is None and i < args.control_seeds:
                    emit(out, seed, "control", control_numbers(held["d"]))
            finally:
                held.clear()
                shutil.rmtree(workdir, ignore_errors=True)
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
