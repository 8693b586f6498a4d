"""The harness finds a cell's configuration, traffic mix, driver and
metrics by name; it refuses JAX; adding a cell is adding files and an
entry."""
import importlib
import json
import os
import shutil
import subprocess
import sys

import pytest

import run
from tracer import HERE, load_module, load_spans

ROOT = os.path.dirname(HERE)


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_finds_its_files(cell):
    b, found, cfg, traffic = run.load_cell(cell)
    assert found["name"] == cell
    assert cfg["name"] == found["config"]
    driver = os.path.join(HERE, "drivers", f"{traffic['driver']}.py")
    assert hasattr(load_module(driver, "d_" + traffic["driver"]), "Driver")
    for m in b["per_layer"]:
        if run.applies(m, cell):
            path = os.path.join(HERE, "metrics", f"{m['name']}.py")
            assert callable(load_module(path, "m").read)
    assert os.path.exists(os.path.join(HERE, "limits", f"{cell}.json"))


def test_every_span_names_an_entry_of_the_port():
    for spec in load_spans():
        if "module" in spec:
            mod = importlib.import_module(spec["module"])
            assert callable(getattr(mod, spec["attr"]))
        else:
            assert spec["autograd"].endswith("Backward")


def test_configs_are_the_files_benchmark_json_names():
    for c in bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_the_check_for_jax_compares_whole_top_level_names():
    assert run.forbidden_modules(["gfs3dseg_gws_tpu.x"]) == \
        ["gfs3dseg_gws_tpu"]
    assert run.forbidden_modules(["gfs3dseg_gws_tpu_torch.x",
                                  "gfs3dseg_gws_tpu_torch", "jaxtyping",
                                  "flaxen.x", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]


def test_a_run_with_a_jax_module_loaded_fails(monkeypatch, capsys):
    """main() prints no result and exits non-zero when a module of the JAX
    package is in sys.modules at its end (a fake one here; the run itself
    is stubbed, since it needs a card)."""
    import types

    import torch

    monkeypatch.setitem(sys.modules, "gfs3dseg_gws_tpu.x",
                        types.ModuleType("gfs3dseg_gws_tpu.x"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run", lambda *a, **k: {"compared": {}})
    code = run.main(["--workload", "gwcapl_s3dis.eval_sweep", "--seed", "1",
                     "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert "gfs3dseg_gws_tpu" in out.err
    monkeypatch.delitem(sys.modules, "gfs3dseg_gws_tpu.x")
    code = run.main(["--workload", "gwcapl_s3dis.eval_sweep", "--seed", "1",
                     "--seconds", "1"])
    assert code == 0 and capsys.readouterr().out.strip() == '{"compared": {}}'


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "gwcapl_s3dis.gfs_train", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_alone_fails_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, a run cannot import the program and fails."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path[:0] = ['portbench']; import run; "
            "run.run('gwcapl_s3dis.eval_sweep', 1, 1.0, False, "
            "torch.device('cpu'), '.')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=tmp_path, timeout=120,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "gfs3dseg_gws_tpu_torch" in proc.stderr


def test_adding_a_cell_is_adding_files_and_an_entry(tmp_path):
    """A copy of the benchmark with a new traffic mix (a data file for the
    existing driver) and a new entry in BENCHMARK.json: the harness finds
    the new cell without any file edited but BENCHMARK.json."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(HERE, "traffic", "eval_sweep.json")) as f:
        mix = json.load(f)
    mix.update(test_blocks=64, why="a smaller static test set")
    with open(tmp_path / "portbench" / "traffic" / "eval_small.json",
              "w") as f:
        json.dump(mix, f)
    b = bench()
    b["workloads"].append({"name": "gwcapl_s3dis.eval_small",
                           "config": "gwcapl_s3dis", "traffic": "eval_small",
                           "chips": 1, "why": "a test"})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    copy = load_module(str(tmp_path / "portbench" / "run.py"), "run_copy")
    _, cell, cfg, traffic = copy.load_cell("gwcapl_s3dis.eval_small",
                                           root=str(tmp_path))
    assert traffic["test_blocks"] == 64 and traffic["driver"] == "eval_sweep"
    assert cfg["name"] == "gwcapl_s3dis"
