"""PyTorch port, preprocessing: `room2blocks` (the block selection in torch),
`split_rooms_to_blocks`, `collect_s3dis` and `collect_scannet` of the port
against the JAX package's, file for file and byte for byte, and the
port's `preprocess_cli` end to end in a subprocess against the JAX CLI's
outputs. The raw trees are `tests/test_collect.py`'s, plus the cases it
lacks: points on block edges, overlapping blocks (stride < block_size), a
block under min_npts, a bad S3DIS room, a segment shared by two ScanNet
groups, vertices in no group, an unknown raw label and a corrupt scan."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gfs3dseg_gws_tpu.cli import preprocess_cli as jax_cli
from gfs3dseg_gws_tpu.data import preprocess as jax_pp
from gfs3dseg_gws_tpu.data.registry import (S3DIS_CLASSNAMES,
                                            SCANNET_CLASSNAMES)
from gfs3dseg_gws_tpu_torch.cli import preprocess_cli as port_cli
from gfs3dseg_gws_tpu_torch.data import preprocess as port_pp
from test_collect import _write_ply, _write_s3dis_raw
from torch_port_util import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tree(root):
    """{relative path: file bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def write_rooms(scenes, dtype):
    """Rooms under scenes/{train,test}_data: one on a 0.25 m grid from the
    origin (many points exactly on block edges), one offset from the
    origin, one with a sparse strip whose blocks hold few points."""
    rng = np.random.default_rng(5)

    def room(n, extent, offset=0.0):
        xyz = np.round(rng.uniform(0, 1, (n, 3)) * extent * 4) / 4 + offset
        rgb = rng.integers(0, 256, (n, 3))
        lbl = rng.integers(0, 13, (n, 1))
        return np.concatenate([xyz, rgb, lbl], axis=1).astype(dtype)

    sparse = room(500, np.array([2.0, 2.5, 3.0]))
    strip = room(12, np.array([1.0, 2.5, 3.0]))
    strip[:, 0] += 3.0
    rooms = {"train_data": {"Area_1_grid": room(700, np.array([3.0, 2.5,
                                                               3.0])),
                            "Area_2_offset": room(600, np.array([2.6, 3.1,
                                                                 2.9]),
                                                  10.3)},
             "test_data": {"Area_6_sparse": np.concatenate([sparse, strip])}}
    for sub, named in rooms.items():
        os.makedirs(os.path.join(scenes, sub))
        for name, data in named.items():
            np.save(os.path.join(scenes, sub, f"{name}.npy"), data)


@pytest.mark.parametrize("block_size,stride,min_npts,dtype", [
    (1.0, 1.0, 10, np.float64),
    (1.0, 0.5, 10, np.float64),
    (1.5, 0.7, 40, np.float64),
    (1.0, 0.5, 10, np.float32),
], ids=["bs1_s1", "bs1_s0.5", "bs1.5_s0.7_min40", "float32"])
def test_split_rooms_to_blocks_equals_jax(tmp_path, monkeypatch, block_size,
                                          stride, min_npts, dtype):
    """The same block files, names and bytes as the JAX package's; some
    blocks fall under min_npts and go in both, and in the chunked mask
    (MASK_ENTRIES cut to two blocks a chunk) as in one."""
    scenes = str(tmp_path / "scenes")
    write_rooms(scenes, dtype)
    jax_counts = [jax_pp.split_rooms_to_blocks(
        scenes, str(tmp_path / "jax"), train, block_size, stride, min_npts)
        for train in (True, False)]
    port_counts = [port_pp.split_rooms_to_blocks(
        scenes, str(tmp_path / "port"), train, block_size, stride, min_npts,
        device="cpu") for train in (True, False)]
    assert port_counts == jax_counts and min(jax_counts) > 0
    ref = tree(str(tmp_path / "jax"))
    assert tree(str(tmp_path / "port")) == ref

    # every block of every room, chunk by chunk; some fall under min_npts
    n_all = 0
    for sub in ("train_data", "test_data"):
        for f in sorted(os.listdir(os.path.join(scenes, sub))):
            data = np.load(os.path.join(scenes, sub, f))
            want = jax_pp.room2blocks(data, block_size, stride, 0)
            monkeypatch.setattr(port_pp, "MASK_ENTRIES", 2 * data.shape[0])
            got = port_pp.room2blocks(data, block_size, stride, 0,
                                      device="cpu")
            assert len(got) == len(want)
            n_all += len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
    assert n_all > sum(jax_counts)
    # the grid room puts points on shared edges: some rows are in two
    # blocks
    grid = np.load(os.path.join(scenes, "train_data", "Area_1_grid.npy"))
    assert sum(len(b) for b in port_pp.room2blocks(
        grid, block_size, stride, 0, device="cpu")) > len(grid)


def test_room2blocks_leaves_its_input(tmp_path):
    data = np.random.default_rng(0).uniform(3, 5, (200, 7))
    before = data.copy()
    blocks = port_pp.room2blocks(data, 1.0, 1.0, 1, device="cpu")
    np.testing.assert_array_equal(data, before)
    assert min(b[:, :3].min() for b in blocks) == 0.0
    with pytest.raises(ValueError):
        port_pp.room2blocks(data, 1.0, 1.5, 1, device="cpu")


def test_collect_s3dis_equals_jax(tmp_path, capsys):
    """Both splits file for file; a room whose txt does not parse is
    reported and skipped by both; a missing Area raises in both."""
    raw = str(tmp_path / "raw")
    _write_s3dis_raw(raw)
    bad = os.path.join(raw, "Area_2", "hallway_1", "Annotations")
    os.makedirs(bad)
    with open(os.path.join(bad, "wall_1.txt"), "w") as f:
        f.write("1 2 3\n4 5\n")
    for pkg, out in ((jax_pp, "jax"), (port_pp, "port")):
        for train in (True, False):
            written = pkg.collect_s3dis(raw, str(tmp_path / out),
                                        S3DIS_CLASSNAMES, train=train)
            assert len(written) == (5 if train else 1)
        assert "hallway_1/Annotations ERROR" in capsys.readouterr().out
    assert tree(str(tmp_path / "port")) == tree(str(tmp_path / "jax"))
    for pkg in (jax_pp, port_pp):
        with pytest.raises(ValueError, match="does not exist"):
            pkg.collect_s3dis(str(tmp_path / "none"), str(tmp_path / "x"),
                              S3DIS_CLASSNAMES)


def write_scans(root, val_scene, corrupt=False):
    """Three scans: a validation scene (from the vendored val list) and two
    train scenes. Groups share a segment, one segment is in no group, and
    one group's raw label is in no tsv row; `corrupt` makes a group name a
    segment that does not exist."""
    rng = np.random.default_rng(3)
    for s, scene in enumerate((val_scene, "scene9998_00", "scene9999_00")):
        sdir = os.path.join(root, scene)
        os.makedirs(sdir)
        n = 80
        _write_ply(os.path.join(sdir, f"{scene}_vh_clean_2.ply"),
                   rng.uniform(0, 3, (n, 3)).astype(np.float32),
                   rng.integers(0, 256, (n, 3)))
        with open(os.path.join(
                sdir, f"{scene}_vh_clean_2.0.010000.segs.json"), "w") as f:
            json.dump({"segIndices": [int(v) for v in
                                      rng.integers(0, 5, n)]}, f)
        groups = [{"label": "wall", "segments": [0, 1]},
                  {"label": "office chair", "segments": [1]},
                  {"label": "no such label", "segments": [2]},
                  {"label": "kitchen counter", "segments": [3]}]
        if corrupt and s == 2:
            groups.append({"label": "door", "segments": [77]})
        with open(os.path.join(sdir, f"{scene}.aggregation.json"), "w") as f:
            json.dump({"segGroups": groups}, f)


def test_collect_scannet_equals_jax(tmp_path):
    """The default (vendored) meta on both sides: the same scenes in the
    same splits, the same rows; class 0 for the unknown label; segment 4
    (in no group) left out; segment 1 twice."""
    val = port_pp.load_scannet_val_scenes()
    assert val == jax_pp.load_scannet_val_scenes() and len(val) == 312
    for a, b in zip(port_pp.scannet_meta_paths(), jax_pp.scannet_meta_paths()):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    scans = str(tmp_path / "scans")
    write_scans(scans, val[0])
    for pkg, out in ((jax_pp, "jax"), (port_pp, "port")):
        written = pkg.collect_scannet(scans, str(tmp_path / out),
                                      SCANNET_CLASSNAMES)
        assert len(written) == 3
    got = tree(str(tmp_path / "port"))
    assert got == tree(str(tmp_path / "jax"))
    assert sorted(got) == [os.path.join("scenes", "test_data",
                                        f"{val[0]}.npy"),
                           os.path.join("scenes", "train_data",
                                        "scene9998_00.npy"),
                           os.path.join("scenes", "train_data",
                                        "scene9999_00.npy")]
    scene = np.load(str(tmp_path / "port" / "scenes" / "test_data"
                        / f"{val[0]}.npy"))
    with open(os.path.join(scans, val[0],
                           f"{val[0]}_vh_clean_2.0.010000.segs.json")) as f:
        segs = np.asarray(json.load(f)["segIndices"])
    counts = np.bincount(segs, minlength=5)
    assert len(scene) == counts[0] + 2 * counts[1] + counts[2] + counts[3]
    labels = scene[:, 6]
    assert (labels == 0).sum() == counts[2]
    assert (labels == SCANNET_CLASSNAMES.index("counter")).sum() == counts[3]


def test_corrupt_scan_stops_both(tmp_path):
    scans = str(tmp_path / "scans")
    write_scans(scans, port_pp.load_scannet_val_scenes()[0], corrupt=True)
    for pkg in (jax_pp, port_pp):
        with pytest.raises(ValueError, match="scene9999_00") as err:
            pkg.collect_scannet(scans, str(tmp_path / pkg.__name__),
                                SCANNET_CLASSNAMES)
        assert isinstance(err.value.__cause__, KeyError)


def test_preprocess_cli_end_to_end_equals_jax(tmp_path):
    """`python -m gfs3dseg_gws_tpu_torch.cli.preprocess_cli` (both
    collect subcommands and room2blocks --device cpu for both splits)
    writes the JAX CLI's tree byte for byte."""
    raw = str(tmp_path / "raw")
    _write_s3dis_raw(raw)
    scans = str(tmp_path / "scans")
    write_scans(scans, port_pp.load_scannet_val_scenes()[0])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO

    def commands(out):
        scenes = os.path.join(out, "s3dis", "scenes")
        return [["collect_s3dis", "--data_path", raw, "--out_root",
                 os.path.join(out, "s3dis"), "--train"],
                ["collect_s3dis", "--data_path", raw, "--out_root",
                 os.path.join(out, "s3dis")],
                ["collect_scannet", "--data_path", scans, "--out_root",
                 os.path.join(out, "scannet")],
                ["room2blocks", "--data_path", scenes, "--train",
                 "--min_npts", "10", "--stride", "0.5"],
                ["room2blocks", "--data_path", scenes, "--min_npts", "10"]]

    for argv in commands(str(tmp_path / "jax")):
        jax_cli.main(argv)
    for argv in commands(str(tmp_path / "port")):
        if argv[0] == "room2blocks":
            argv = argv + ["--device", "cpu"]
        res = subprocess.run(
            [sys.executable, "-m", "gfs3dseg_gws_tpu_torch.cli.preprocess_cli"]
            + argv, cwd=REPO, env=env, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
    got = tree(str(tmp_path / "port"))
    assert got == tree(str(tmp_path / "jax"))
    assert any(p.startswith(os.path.join("s3dis", "blocks_bs1_s0.5",
                                         "data")) for p in got)
    assert any(p.startswith(os.path.join("s3dis", "blocks_bs1_s1_test",
                                         "data")) for p in got)


def test_room2blocks_cuda_without_gpu_raises_before_writing(tmp_path,
                                                            monkeypatch):
    scenes = str(tmp_path / "scenes")
    write_rooms(scenes, np.float64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["room2blocks", "--data_path", scenes, "--train",
                       "--device", "cuda"])
    assert sorted(os.listdir(tmp_path)) == ["scenes"]
