"""Raw-dataset preprocessing: scene collection and room -> block splitting
(counterpart of the JAX package's data/preprocess.py; reference
pretrain/preprocess/{collect_s3dis_data,collect_scannet_data,
room2blocks}.py, with their hard-coded ROOT_DIR paths made arguments).

Output layouts are the reference's:
    scenes/{train,test}_data/*.npy                (N x 7 XYZRGBL per room)
    blocks_bs{bs}_s{s}[_test]/data/*.npy          (room blocks)

`room2blocks` selects every block's points in torch on a given device, in
chunks of blocks: the one array computation here that grows with the
room (a room of a million points and ~40 blocks is a 40 M-entry mask).
Its blocks equal the JAX package's bit for bit: the same blocks in the
same (i, j) order, the same rows in the same order, the same dtype. The
collection functions parse files and stay host numpy, as in JAX.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

# entries of one chunk's (blocks, points) membership mask
MASK_ENTRIES = 1 << 26


# --------------------------------------------------------------------------- #
# room -> blocks (reference room2blocks.py:14-55)
# --------------------------------------------------------------------------- #

def room2blocks(data: np.ndarray, block_size: float = 1.0,
                stride: float = 1.0, min_npts: int = 1000,
                device: Union[str, torch.device] = "cuda"
                ) -> List[np.ndarray]:
    """Sliding-window XY blocks over one room (rows XYZ...), xyz shifted to
    the room's minimum; blocks with fewer than `min_npts` points are
    dropped. `data` is left as it is (the reference shifts it in place).

    A block's window is closed on both sides, so a point on a shared edge
    (or, with stride < block_size, in an overlap) lies in several blocks.
    Membership is decided by the JAX package's comparisons in the room's
    dtype on `device`; the block counts come from the maximum on the host,
    as there. Returns numpy arrays of the room's dtype.
    """
    if stride > block_size:
        raise ValueError(f"stride {stride} > block_size {block_size}")
    device = torch.device(device)
    room = torch.from_numpy(np.ascontiguousarray(data)).to(device,
                                                              copy=True)
    room[:, :3] -= room[:, :3].amin(dim=0)
    xyz_max = room[:, :3].amax(dim=0).cpu().numpy()
    num_block_x = int(np.ceil((xyz_max[0] - block_size) / stride)) + 1
    num_block_y = int(np.ceil((xyz_max[1] - block_size) / stride)) + 1
    n_blocks = max(num_block_x, 0) * max(num_block_y, 0)

    # window edges of block b = i * num_block_y + j: begin i * stride (and
    # j * stride), end begin + block_size, in float64 as the JAX package
    # computes them, then cast to the room's dtype as its comparison does
    i, j = np.divmod(np.arange(n_blocks), max(num_block_y, 1))
    xbeg, ybeg = i * stride, j * stride
    edges = torch.from_numpy(np.stack([xbeg, xbeg + block_size, ybeg,
                                       ybeg + block_size], axis=1)).to(
        device=device, dtype=room.dtype)
    x, y = room[None, :, 0], room[None, :, 1]
    per_chunk = max(MASK_ENTRIES // max(room.shape[0], 1), 1)
    blocks = []
    for lo in range(0, n_blocks, per_chunk):
        e = edges[lo:lo + per_chunk, :, None]
        cond = ((x >= e[:, 0]) & (x <= e[:, 1])
                & (y >= e[:, 2]) & (y <= e[:, 3]))            # (chunk, N)
        counts = cond.sum(dim=1)
        keep = (counts >= min_npts).nonzero()[:, 0]
        if keep.numel() == 0:
            continue
        rows = cond[keep].nonzero()[:, 1]      # block-major, rows in order
        sizes = counts[keep].cpu().tolist()
        blocks += list(np.split(room[rows].cpu().numpy(),
                                np.cumsum(sizes)[:-1]))
    return blocks


def split_rooms_to_blocks(scenes_dir: str, out_root: str, train: bool,
                          block_size: float = 1.0, stride: float = 1.0,
                          min_npts: int = 1000,
                          device: Union[str, torch.device] = "cuda") -> int:
    """Split every room npy under scenes/{train,test}_data into block files
    `<out_root>/blocks_bs{bs}_s{s}[_test]/data/<room>_block_<i>.npy`;
    returns the number of blocks written."""
    sub = "train_data" if train else "test_data"
    suffix = "" if train else "_test"
    save_dir = os.path.join(
        out_root, f"blocks_bs{block_size:g}_s{stride:g}{suffix}", "data")
    os.makedirs(save_dir, exist_ok=True)

    count = 0
    for path in sorted(glob.glob(os.path.join(scenes_dir, sub, "*.npy"))):
        room_name = os.path.basename(path)[:-4]
        data = np.load(path)
        for i, block in enumerate(room2blocks(data, block_size, stride,
                                              min_npts, device)):
            np.save(os.path.join(save_dir, f"{room_name}_block_{i}.npy"),
                    block)
            count += 1
    return count


# --------------------------------------------------------------------------- #
# S3DIS collection (reference collect_s3dis_data.py:16-56)
# --------------------------------------------------------------------------- #

def collect_s3dis_scene(anno_path: str, classnames: Sequence[str]
                        ) -> np.ndarray:
    """Aggregate one room's instance txts into an N x 7 XYZRGBL array.
    Unknown classes (e.g. 'stairs') map to clutter."""
    class2label = {c: i for i, c in enumerate(classnames)}
    parts = []
    for f in sorted(glob.glob(os.path.join(anno_path, "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        if cls not in class2label:
            cls = "clutter"
        points = np.loadtxt(f)
        labels = np.full((points.shape[0], 1), class2label[cls], np.float64)
        parts.append(np.concatenate([points, labels], axis=1))
    return np.concatenate(parts, axis=0)


def collect_s3dis(data_path: str, out_root: str, classnames: Sequence[str],
                  train: bool = True) -> List[str]:
    """Collect all rooms of the train (Areas 1-5) or test (Area 6) split. A
    missing Area raises; a room that fails to parse is reported and
    skipped, as the reference does."""
    areas = [f"Area_{i}" for i in (range(1, 6) if train else [6])]
    save_dir = os.path.join(out_root, "scenes",
                            "train_data" if train else "test_data")
    os.makedirs(save_dir, exist_ok=True)
    written = []
    for area in areas:
        area_dir = os.path.join(data_path, area)
        if not os.path.isdir(area_dir):
            raise ValueError(f"{area_dir} does not exist")
        for scene in sorted(os.listdir(area_dir)):
            scene_path = os.path.join(area_dir, scene)
            if not os.path.isdir(scene_path):
                continue
            anno = os.path.join(scene_path, "Annotations")
            out = os.path.join(save_dir, f"{area}_{scene}.npy")
            try:
                np.save(out, collect_s3dis_scene(anno, classnames))
                written.append(out)
            except Exception as e:  # the reference continues past bad rooms
                print(f"{anno} ERROR: {e}")
    return written


# --------------------------------------------------------------------------- #
# ScanNet collection (reference collect_scannet_data.py:16-177)
# --------------------------------------------------------------------------- #

META_DIR = os.path.join(os.path.dirname(__file__), "meta")


def scannet_meta_paths():
    """The vendored canonical ScanNet meta files (data/meta/): the
    raw-label -> nyu40 tsv and the v2 validation-scene list (312 scenes),
    the reference's pretrain/datasets/ScanNet/meta files. Returns
    (tsv_path, val_txt_path)."""
    return (os.path.join(META_DIR, "scannetv2-labels.combined.tsv"),
            os.path.join(META_DIR, "scannetv2_val.txt"))


def load_scannet_val_scenes(path: str | None = None):
    """Scene names of the canonical ScanNet v2 validation split."""
    if path is None:
        path = scannet_meta_paths()[1]
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def load_scannet_label_map(tsv_path: str, classnames: Sequence[str]
                           ) -> Dict[str, int]:
    """raw category -> class index via the nyu40class column of
    scannetv2-labels.combined.tsv; names not in `classnames` -> 0."""
    name2idx = {c: i for i, c in enumerate(classnames)}
    mapping: Dict[str, int] = {}
    with open(tsv_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        raw_i = header.index("raw_category")
        nyu_i = header.index("nyu40class")
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) <= max(raw_i, nyu_i):
                continue
            mapping[cols[raw_i]] = name2idx.get(cols[nyu_i], 0)
    return mapping


_PLY_TYPES = {"float": "f4", "double": "f8", "uchar": "u1", "uint8": "u1",
              "int": "i4", "uint16": "u2", "ushort": "u2"}


def read_ply_xyzrgb(ply_path: str) -> np.ndarray:
    """Minimal binary-little-endian PLY vertex reader -> (N, 6) float64
    x y z red green blue."""
    with open(ply_path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a ply file")
        n_verts = 0
        props: List[tuple] = []
        fmt = None
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element"):
                parts = line.split()
                in_vertex = parts[1] == b"vertex"
                if in_vertex:
                    n_verts = int(parts[2])
            elif line.startswith(b"property") and in_vertex:
                parts = line.split()
                props.append((parts[1].decode(), parts[2].decode()))
            elif line == b"end_header":
                break
        if fmt != b"binary_little_endian":
            raise NotImplementedError("only binary_little_endian ply")
        dtype = np.dtype([(name, "<" + _PLY_TYPES[t]) for t, name in props])
        arr = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype)
    return np.stack([arr[c].astype(np.float64)
                     for c in ("x", "y", "z", "red", "green", "blue")],
                    axis=1)


def collect_scannet_scene(scene_dir: str, scene_name: str,
                          label_map: Dict[str, int]) -> np.ndarray:
    """ply + over-segmentation json + aggregation json -> N x 7 XYZRGBL.

    The reference's instance-major order (collect_scannet_data.py:48-111):
    each segGroup's points in group order, then the group's segment order,
    then vertex order within a segment. Vertices whose segment is in no
    segGroup are left out, a segment shared by two groups is emitted
    twice, and a raw label the tsv does not map is class 0. A group naming
    an unknown segment id raises KeyError, as in the reference.
    """
    ply = os.path.join(scene_dir, f"{scene_name}_vh_clean_2.ply")
    segs_json = os.path.join(scene_dir,
                             f"{scene_name}_vh_clean_2.0.010000.segs.json")
    agg_json = os.path.join(scene_dir, f"{scene_name}.aggregation.json")

    points = read_ply_xyzrgb(ply)
    with open(segs_json) as f:
        seg_of_vertex = json.load(f)["segIndices"]
    segid_to_pointid: Dict[int, List[int]] = {}
    for i, s in enumerate(seg_of_vertex):
        segid_to_pointid.setdefault(s, []).append(i)
    with open(agg_json) as f:
        agg = json.load(f)

    rows = []
    for group in agg["segGroups"]:
        pointids: List[int] = []
        for segid in group["segments"]:
            pointids += segid_to_pointid[segid]
        inst = points[np.asarray(pointids)]
        cls = label_map.get(group["label"], 0)
        rows.append(np.concatenate(
            [inst, np.full((inst.shape[0], 1), float(cls))], axis=1))
    return np.concatenate(rows, axis=0)


def collect_scannet(scans_dir: str, out_root: str, classnames: Sequence[str],
                    tsv_path: str | None = None,
                    val_scenes: Sequence[str] | None = None) -> List[str]:
    """Collect every scan: scenes in the validation list go to test_data,
    the rest to train_data (reference collect_scannet_data.py:142-176).
    `tsv_path` and `val_scenes` default to the vendored meta files. A
    corrupt scan stops the collection with ValueError, as the reference's
    does: skipping it would leave an incomplete dataset."""
    if tsv_path is None:
        tsv_path = scannet_meta_paths()[0]
    if val_scenes is None:
        val_scenes = load_scannet_val_scenes()
    label_map = load_scannet_label_map(tsv_path, classnames)
    val_set = set(val_scenes)
    written = []
    for scene_name in sorted(os.listdir(scans_dir)):
        scene_dir = os.path.join(scans_dir, scene_name)
        if not os.path.isdir(scene_dir):
            continue
        sub = "test_data" if scene_name in val_set else "train_data"
        save_dir = os.path.join(out_root, "scenes", sub)
        os.makedirs(save_dir, exist_ok=True)
        out = os.path.join(save_dir, f"{scene_name}.npy")
        try:
            np.save(out, collect_scannet_scene(scene_dir, scene_name,
                                               label_map))
            written.append(out)
        except Exception as e:
            raise ValueError(f"ERROR {scene_dir}!!") from e
    return written

