"""The port must import and start on a host without JAX (the GPU host has
none), and without any module of the JAX package: every module of
gfs3dseg_gws_tpu_torch imports (the training slices' kernels, models,
optimizers, pipelines and CLIs among them, geometric-word extraction,
the few-shot baselines, preprocessing and the checkpoint converter),
`chip_smoke` imports, and the five CLIs answer --help, in a subprocess where importing jax, flax or gfs3dseg_gws_tpu
(even its numpy-only modules) fails, and h5py too (the GPU host has
none)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["gfs3dseg_gws_tpu"] = None
sys.modules["h5py"] = None
import gfs3dseg_gws_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print("imported", len(names))
for name in ("ops.knn", "ops.fused_edgeconv_train", "ops.attention_train",
             "models.dgcnnseg", "parallel.optim", "pipelines.pretrain",
             "cli.pretrain_cli", "utils.observability", "data.datasets",
             "data.native_loader", "data.synthetic", "ops.edgeconv",
             "ops.kmeans", "ops.linalg", "pipelines.basis", "cli.basis_cli",
             "ops.fused_edgeconv", "ops.attention_kernel", "ops._ext",
             "data.episodes", "ops.metrics", "ops.fps", "models.protonet",
             "models.mpti", "pipelines.baselines", "parallel.steps",
             "cli.preprocess_cli", "cli.convert_checkpoint",
             "data.preprocess", "utils.visual"):
    assert "gfs3dseg_gws_tpu_torch." + name in names, name
import chip_smoke
from gfs3dseg_gws_tpu_torch.cli import (basis_cli, convert_checkpoint,
                                        preprocess_cli, pretrain_cli,
                                        train_cli)
for cli in (train_cli, pretrain_cli, basis_cli, preprocess_cli,
            convert_checkpoint):
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m, v in sys.modules.items() if v is not None)
assert not any(m == "gfs3dseg_gws_tpu" or m.startswith("gfs3dseg_gws_tpu.")
               for m, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_port_imports_and_starts_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "--only_evaluate" in res.stdout and "--device" in res.stdout
    assert "--pretrain_weight_decay" in res.stdout
    assert "--num_cnt" in res.stdout
    assert "room2blocks" in res.stdout and "npz-to-fewshot" in res.stdout
    assert res.stdout.rstrip().endswith("ok")
    n = int(res.stdout.split("imported ")[1].split()[0])
    assert n >= 20
