"""Synthetic S3DIS-layout blocks drawn from a run's seed: the general
generator that every traffic mix's block counts and sizes feed.

The layout is the reference's prepared-data tree:

    <root>/meta/s3dis_classnames.txt
    <root>/blocks_bs1.0_s1.0/data/Area_train_room_<i>_block_0.npy
    <root>/blocks_bs1.0_s1.0_test/data/Area_test_room_<i>_block_0.npy

Each block is (P, 7) float32 rows of xyz, rgb (integers 0-255) and the
class label. A block holds 3 to 6 classes as blobs with a fixed colour and
height band a class, exactly P points (every class at least `MIN_SHARE` of
them, so that the prepared-data registry lists the block under each of its
classes), and block i holds classes i, i + 1 and i + 2 (mod 13), so every
class appears in many blocks.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

S3DIS_CLASSNAMES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
]
MIN_SHARE = 0.06        # each present class: at least this share of a block


def _signature(cls: int, n_classes: int) -> Tuple[np.ndarray, float]:
    """A class's fixed colour and height (the same for every seed)."""
    rng = np.random.default_rng(1000 + cls)
    return rng.uniform(30, 225, size=3), 0.3 + 2.2 * cls / (n_classes - 1)


def _block(rng: np.random.Generator, index: int, points: int,
           n_classes: int, signatures) -> np.ndarray:
    forced = {index % n_classes, (index + 1) % n_classes,
              (index + 2) % n_classes}
    present = sorted(forced | set(rng.choice(n_classes, 3,
                                             replace=False).tolist()))
    m = len(present)
    floor = int(np.ceil(MIN_SHARE * points))
    counts = rng.multinomial(points - floor * m, np.full(m, 1.0 / m)) + floor
    label = np.repeat(np.asarray(present, np.float32), counts)
    centre = np.repeat(rng.uniform(0, 4, size=(m, 2)), counts, axis=0)
    colour = np.repeat(np.stack([signatures[c][0] for c in present]),
                       counts, axis=0)
    height = np.repeat(np.asarray([signatures[c][1] for c in present]),
                       counts)
    noise = rng.standard_normal((points, 6))
    xyz = np.stack([centre[:, 0] + 0.35 * noise[:, 0],
                    centre[:, 1] + 0.35 * noise[:, 1],
                    height + 0.15 * noise[:, 2]], axis=1)
    xyz[:, :2] -= xyz[:, :2].min(axis=0)
    rgb = np.rint(np.clip(colour + 20.0 * noise[:, 3:], 0, 255))
    return np.concatenate([xyz, rgb, label[:, None]], axis=1).astype(
        np.float32)


def make_blocks(root: str, seed: int, train_blocks: int,
                train_block_points: int, test_blocks: int = 0,
                test_block_points: int = 0, n_classes: int = 13
                ) -> Tuple[str, str]:
    """Write the tree under `root`; returns (train_dir, test_dir). The
    same seed writes the same bytes."""
    rng = np.random.default_rng(seed)
    signatures = [_signature(c, n_classes) for c in range(n_classes)]
    os.makedirs(os.path.join(root, "meta"), exist_ok=True)
    with open(os.path.join(root, "meta", "s3dis_classnames.txt"), "w") as f:
        f.write("\n".join(S3DIS_CLASSNAMES[:n_classes]) + "\n")
    dirs = []
    for sub, tag, count, points in (
            ("blocks_bs1.0_s1.0", "train", train_blocks, train_block_points),
            ("blocks_bs1.0_s1.0_test", "test", test_blocks,
             test_block_points)):
        path = os.path.join(root, sub)
        os.makedirs(os.path.join(path, "data"), exist_ok=True)
        for i in range(count):
            np.save(os.path.join(path, "data",
                                 f"Area_{tag}_room_{i}_block_0.npy"),
                    _block(rng, i, points, n_classes, signatures))
        dirs.append(path)
    return dirs[0], dirs[1]
