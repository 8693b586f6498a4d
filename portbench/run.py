"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Each run is a new process. It sets up the cell (its configuration
`configs/<name>.json` and traffic mix `traffic/<name>.json`, found through
BENCHMARK.json; the traffic mix names its driver, `drivers/<name>.py`),
warms up, runs the window for `--seconds`, checks what the window
produced against the plain reference (`reference/`), and prints one JSON
line last on standard output. With `--trace 0` the line holds the cell's
end-to-end metrics; with `--trace 1` its per-layer metrics, each read by
`metrics/<name>.py` from a profiled stretch of the window (tracer.py),
and the device's busy and window seconds. Every number compared is
printed beside its limit (`limits/<cell>.json`) as the last lines on
standard error and under "compared", the line's last key.

It needs CUDA and as many cards as the cell asks for, and fails (exit 3,
no result) without them; it fails (exit 4, no result) when a module of
JAX, flax or the JAX package is loaded at its end. Caches of the
program's builds stay inside the checkout (build/).
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse                                             # noqa: E402
import json                                                 # noqa: E402
import os                                                   # noqa: E402
import shutil                                               # noqa: E402
import sys                                                  # noqa: E402
import tempfile                                             # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "portbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path[:0] = [HERE, ROOT]

FORBIDDEN = ("jax", "jaxlib", "flax", "gfs3dseg_gws_tpu")


def forbidden_modules(names) -> list:
    """Top-level names of loaded modules that are, whole, one of
    FORBIDDEN (the port's package passes: its name is another word)."""
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT):
    """(benchmark, cell, configuration, traffic mix) of a workload name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     f"{cell['traffic']}.json"))
    return bench, cell, cfg, traffic


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number without a limit fails."""
    compared = {n: {"value": v, "limit": limits.get(n)}
                for n, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in compared.values())
    return ok and bool(compared), compared


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        workdir: str, fault=None, overrides=None, start=None,
        after=None) -> dict:
    """One run of a cell on `device`; returns the result line's object.
    `overrides` replace configuration and traffic keys (small sizes for
    the tests on the CPU); `fault` plants a fault in the timed path (the
    benchmark's tests and control, never a benchmark run); `after(driver)`
    is called once the check is done (the control reads the reference
    there)."""
    import torch

    from tracer import Tracer, load_module

    start = PROCESS_START if start is None else start
    bench, cell, cfg, traffic = load_cell(workload)
    for key, value in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = value
    drivers = os.path.join(HERE, "drivers", f"{traffic['driver']}.py")
    driver = load_module(drivers, f"driver_{traffic['driver']}").Driver(
        cfg, traffic, seed, device, workdir, fault)
    cuda = device.type == "cuda"
    if cuda:                    # a new process: its peak is the run's
        torch.cuda.set_device(device)
    driver.phases["imports"] = time.perf_counter() - start
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - start
    tracer = Tracer(workdir).install() if trace else None
    try:
        out = driver.window(seconds, tracer)
    finally:
        if tracer is not None:
            tracer.uninstall()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release()
    numbers = driver.check()
    if after is not None:
        after(driver)
    limits_path = os.path.join(HERE, "limits", f"{workload}.json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    correct, compared = judge(numbers, limits)

    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    if not trace:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, workload) and m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    else:
        s = tracer.summary
        for m in bench["per_layer"]:
            if not applies(m, workload):
                continue
            reader = load_module(
                os.path.join(HERE, "metrics", f"{m['name']}.py"),
                "metric_" + m["name"].replace(".", "_"))
            value = reader.read(s)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        device_info.update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = s.breakdown()
    result["device"] = device_info
    result["compared"] = compared
    result["setup_phases"] = driver.phases
    result["notes"] = driver.notes
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _, cell, _, _ = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); CUDA available: {torch.cuda.is_available()}, "
              f"devices: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    workdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 4
    print(f"setup phases (s): {json.dumps(result.pop('setup_phases', {}))}",
          file=sys.stderr)
    print(f"notes: {json.dumps(result.pop('notes', {}))}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
