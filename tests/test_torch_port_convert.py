"""PyTorch port, the checkpoint converter and the utilities: each of the
eight modes of `python -m gfs3dseg_gws_tpu_torch.cli.convert_checkpoint`
against the JAX package's `scripts/convert_checkpoint.py` on the same
input at the default widths (the same keys, dtypes, bits, metadata and
final line), the port's round trips to the identity at encoder depths the
JAX script's torch-tar writer cannot take (the DGCNN semantic-segmentation
widths, whose third block is one layer deep, and the classification
encoder's four one-layer blocks), and `trace`, `MetricsWriter`,
`colorize` and `labeled_pointcloud` against JAX's utils."""
import ast
import glob
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from gfs3dseg_gws_tpu.utils import observability as jax_obs
from gfs3dseg_gws_tpu.utils import visual as jax_visual
from gfs3dseg_gws_tpu_torch.cli import convert_checkpoint as port_convert
from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
from gfs3dseg_gws_tpu_torch.models.protonet import ProtoNet
from gfs3dseg_gws_tpu_torch.utils import checkpoint as ck
from gfs3dseg_gws_tpu_torch.utils import observability as port_obs
from gfs3dseg_gws_tpu_torch.utils import visual as port_visual
from torch_port_util import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "convert_checkpoint.py")
SEMSEG = ((64, 64), (64, 64), (64,))
CLASS = ((64,), (64,), (128,), (256,))
GFS_META = {"epoch": 3, "max_iou": 0.25}
FEWSHOT_META = {"iteration": 7, "IoU": 0.3125, "loss": 1.25}


def randomized(model, seed):
    """`model` with every float parameter and buffer drawn from `seed`
    (running variances positive), so that no two arrays are alike."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen))
                if name.endswith("running_var"):
                    t.abs_().add_(0.5)
    return model


def models(widths=((64, 64),) * 3):
    kw = dict(edgeconv_widths=widths)
    return {"gfs": randomized(GWCAPL(**kw), 1),
            "pretrain": randomized(DGCNNSeg(13, **kw), 2),
            "fewshot": randomized(ProtoNet(use_attention=True, **kw), 3),
            "fewshot_linear": randomized(ProtoNet(use_attention=False, **kw),
                                         4)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The input file of each mode, at the default widths, written by the
    port."""
    root = str(tmp_path_factory.mktemp("convert_in"))
    m = models()
    coding = (np.random.default_rng(5).random((7, 150)) > 0.5).astype(
        np.float32)
    out = {}
    out["gfs-to-npz"] = os.path.join(root, "model.pth")
    ck.save_torch_gfs_checkpoint(m["gfs"].state_dict(), out["gfs-to-npz"],
                                 **GFS_META)
    out["npz-to-gfs"] = os.path.join(root, "gfs.npz")
    ck.save_gfs_npz(m["gfs"], out["npz-to-gfs"], GFS_META)
    out["pretrain-to-npz"] = os.path.join(root, "log_pretrain")
    ck.save_torch_pretrain_checkpoint(m["pretrain"].state_dict(),
                                      out["pretrain-to-npz"])
    out["npz-to-pretrain"] = os.path.join(root, "pretrain.npz")
    ck.save_pretrain_npz(m["pretrain"], out["npz-to-pretrain"],
                         {"epoch": 1, "miou": 0.5})
    out["coding-to-npz"] = os.path.join(root, "coding.pth")
    ck.save_torch_coding(coding, out["coding-to-npz"])
    out["npz-to-coding"] = os.path.join(root, "coding.npz")
    np.savez(out["npz-to-coding"], coding=coding)
    for name in ("fewshot", "fewshot_linear"):
        ck.save_torch_fewshot_checkpoint(
            m[name].state_dict(), os.path.join(root, f"log_{name}"),
            FEWSHOT_META["iteration"], FEWSHOT_META["IoU"],
            FEWSHOT_META["loss"])
        out[f"fewshot-to-npz/{name}"] = os.path.join(root, f"log_{name}")
        out[f"npz-to-fewshot/{name}"] = os.path.join(root, f"{name}.npz")
        ck.save_fewshot_npz(m[name], out[f"npz-to-fewshot/{name}"],
                            FEWSHOT_META)
    return out


def load_npz(path):
    flat, meta = ck.load_checkpoint(path)
    return {k: np.ascontiguousarray(v) for k, v in flat.items()}, meta


def assert_npz_equal(a, b):
    (fa, ma), (fb, mb) = load_npz(a), load_npz(b)
    assert ma == mb
    assert sorted(fa) == sorted(fb)
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        assert fa[key].shape == fb[key].shape, key
        assert fa[key].tobytes() == fb[key].tobytes(), key


def assert_same(a, b, where=""):
    """Two loaded torch objects: the same keys, value types and values,
    tensors bit for bit with their dtypes."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(sorted(a)) == list(sorted(b)), where
        for key in a:
            assert_same(a[key], b[key], f"{where}/{key}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def torch_file(path):
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.tar")
    return ck.torch_load(path)


def run_jax(mode, src, dst, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [SCRIPT, mode, src, dst])
    runpy.run_path(SCRIPT, run_name="__main__")
    return capsys.readouterr().out.strip().splitlines()[-1]


@pytest.mark.parametrize("case", [
    "gfs-to-npz", "npz-to-gfs", "pretrain-to-npz", "npz-to-pretrain",
    "coding-to-npz", "npz-to-coding", "fewshot-to-npz/fewshot",
    "fewshot-to-npz/fewshot_linear", "npz-to-fewshot/fewshot",
    "npz-to-fewshot/fewshot_linear"])
def test_mode_equals_jax_script(case, inputs, tmp_path, monkeypatch, capsys):
    mode = case.split("/")[0]
    src = inputs[case]
    ext = {"gfs": ".pth", "coding": ".pth", "pretrain": "",
           "fewshot": ""}[mode.split("-")[-1]] if mode.startswith(
        "npz-to") else ".npz"
    want, got = str(tmp_path / f"jax{ext}"), str(tmp_path / f"port{ext}")
    line = run_jax(mode, src, want, monkeypatch, capsys)
    port_convert.main([mode, src, got])
    assert capsys.readouterr().out.strip() == line.replace(want, got)
    if ext == ".npz":
        assert_npz_equal(got, want)
    else:
        assert_same(torch_file(got), torch_file(want))


def test_modes_match_jax_script():
    """The converter takes the JAX script's mode choices, in its order."""
    tree = ast.parse(open(SCRIPT).read())
    choices = next(
        ast.literal_eval(kw.value) for node in ast.walk(tree)
        if isinstance(node, ast.Call) and node.args
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "mode" for kw in node.keywords
        if kw.arg == "choices")
    assert port_convert.MODES == choices
    action = next(a for a in port_convert.build_parser()._actions
                  if a.dest == "mode")
    assert list(action.choices) == choices


@pytest.mark.parametrize("widths", [SEMSEG, CLASS], ids=["semseg", "class"])
@pytest.mark.parametrize("kind", ["gfs", "pretrain", "fewshot",
                                  "fewshot_linear"])
def test_round_trips_are_the_identity(kind, widths, tmp_path):
    """npz -> torch file -> npz gives every array and the carried metadata
    back bit for bit, and torch file -> npz -> torch file every tensor
    (the pre-training tar holds the encoder alone, so its npz round trip
    is held on the encoder's arrays)."""
    model = models(widths)[kind]
    mode = {"gfs": ("npz-to-gfs", "gfs-to-npz", ".pth"),
            "pretrain": ("npz-to-pretrain", "pretrain-to-npz", ""),
            "fewshot": ("npz-to-fewshot", "fewshot-to-npz", ""),
            "fewshot_linear": ("npz-to-fewshot", "fewshot-to-npz", "")}[kind]
    meta = {"gfs": GFS_META, "pretrain": {}}.get(kind, FEWSHOT_META)
    save = {"gfs": ck.save_gfs_npz, "pretrain": ck.save_pretrain_npz}.get(
        kind, ck.save_fewshot_npz)
    first = str(tmp_path / "a.npz")
    save(model, first, meta)
    torch_path, second = str(tmp_path / f"b{mode[2]}"), str(tmp_path /
                                                            "c.npz")
    port_convert.main([mode[0], first, torch_path])
    port_convert.main([mode[1], torch_path, second])
    (fa, ma), (fb, mb) = load_npz(first), load_npz(second)
    if kind == "pretrain":
        fa = {k: v for k, v in fa.items() if "/encoder/" in k}
    assert mb == ma and sorted(fb) == sorted(fa)
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        assert fa[key].tobytes() == fb[key].tobytes(), key
    # and the other way
    third = str(tmp_path / f"d{mode[2]}")
    port_convert.main([mode[0], second, third])
    assert_same(torch_file(third), torch_file(torch_path))
    # the torch file loads into the port's model at these widths
    sd = torch_file(torch_path)
    sd = {"gfs": lambda: sd["state_dict"],
          "pretrain": lambda: {f"encoder.{k}": v
                               for k, v in sd["params"].items()}}.get(
        kind, lambda: sd["model_state_dict"])()
    fresh = type(model)(**({"num_classes": 13} if kind == "pretrain" else
                           {"use_attention": kind == "fewshot"}
                           if kind.startswith("fewshot") else {}),
                        edgeconv_widths=widths)
    missing = fresh.load_state_dict(sd, strict=kind != "pretrain")
    if kind == "pretrain":
        assert all(k.startswith("segmenter.") for k in missing.missing_keys)
        assert not missing.unexpected_keys


def test_coding_round_trip(tmp_path):
    coding = (np.random.default_rng(1).random((15, 150)) > 0.3).astype(
        np.float32)
    np.savez(str(tmp_path / "a.npz"), coding=coding)
    port_convert.main(["npz-to-coding", str(tmp_path / "a.npz"),
                       str(tmp_path / "b.pth")])
    port_convert.main(["coding-to-npz", str(tmp_path / "b.pth"),
                       str(tmp_path / "c.npz")])
    with np.load(str(tmp_path / "c.npz")) as z:
        assert z["coding"].dtype == np.float32
        assert z["coding"].tobytes() == coding.tobytes()


# --------------------------------------------------------------------------- #
# utils: trace, MetricsWriter, visual
# --------------------------------------------------------------------------- #

def test_trace_writes_chrome_json(tmp_path):
    log_dir = str(tmp_path / "trace")
    with port_obs.trace(log_dir) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8)).sum()
    assert prof is not None
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    with port_obs.trace(None) as prof:
        pass
    assert prof is None


def test_metrics_writer_jsonl_equals_jax(tmp_path):
    rows = []
    for mod, sub in ((jax_obs, "jax"), (port_obs, "port")):
        w = mod.MetricsWriter(str(tmp_path / sub), use_tensorboard=False)
        w.scalar("Train/loss", 1.5, 0)
        w.scalar("Valid/meanIoU", np.float32(0.25), 3)
        w.close()
        with open(os.path.join(str(tmp_path / sub), "metrics.jsonl")) as f:
            rows.append([{k: v for k, v in json.loads(line).items()
                          if k != "time"} for line in f])
    assert rows[0] == rows[1] and len(rows[0]) == 2


def test_visual_equals_jax(tmp_path):
    labels = np.random.default_rng(0).integers(0, 40, (6, 7))
    np.testing.assert_array_equal(port_visual.colorize(labels),
                                  jax_visual.colorize(labels))
    np.testing.assert_array_equal(port_visual.PALETTE, jax_visual.PALETTE)
    xyz = np.random.default_rng(1).standard_normal((50, 3))
    lbl = np.arange(50) % 21
    got = port_visual.labeled_pointcloud(xyz, lbl)
    assert got.shape == (50, 6) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jax_visual.labeled_pointcloud(xyz,
                                                                     lbl))
    port_visual.save_png(labels, str(tmp_path / "a.png"))
    jax_visual.save_png(labels, str(tmp_path / "b.png"))
    with open(str(tmp_path / "a.png"), "rb") as a, \
            open(str(tmp_path / "b.png"), "rb") as b:
        assert a.read() == b.read()
