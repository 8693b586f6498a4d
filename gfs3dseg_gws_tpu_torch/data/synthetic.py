"""Synthetic scene/block generation for tests and benchmarks.

The port's own copy of the JAX package's data/synthetic.py; it imports
nothing of that package, so the two can be held against each other.

Produces on-disk trees with the exact reference layout:
    <root>/blocks_bs1.0_s1.0/data/*.npy      (N x 7 xyzrgbL blocks)
    <root>/blocks_bs1.0_s1.0_test/data/*.npy
    <root>/meta/{dataset}_classnames.txt
so every registry/dataset/pipeline/CLI code path can run hermetically.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from gfs3dseg_gws_tpu_torch.data.registry import (
    S3DIS_CLASSNAMES,
    SCANNET_CLASSNAMES,
)


def _class_signature(cls: int, n_classes: int):
    """Stable per-class attributes so synthetic datasets carry a LEARNABLE
    cross-block signal: a fixed colour (deterministic per class) and a
    class-dependent height band."""
    rng = np.random.default_rng(1000 + cls)
    color = rng.uniform(30, 225, size=3)
    z_center = 0.3 + 2.2 * (cls / max(n_classes - 1, 1))
    return color, z_center


def make_synthetic_room(rng: np.random.Generator, n_points: int = 8000,
                        n_classes: int = 13,
                        present: Optional[Sequence[int]] = None) -> np.ndarray:
    """One synthetic room: clustered class blobs, N x 7 (xyz rgb label).

    Classes have stable colour/height signatures (plus noise), so models can
    genuinely generalise from train blocks to test blocks — learning-signal
    tests would be vacuous on pure noise."""
    if present is None:
        n_present = rng.integers(3, min(8, n_classes) + 1)
        present = rng.choice(n_classes, n_present, replace=False)
    present = np.asarray(present)
    pts_per = np.maximum(rng.multinomial(
        n_points, np.ones(len(present)) / len(present)), 150)
    rows = []
    for cls, cnt in zip(present, pts_per):
        color, z_center = _class_signature(int(cls), n_classes)
        center_xy = rng.uniform(0, 4, size=2)
        xyz = np.stack([
            center_xy[0] + 0.35 * rng.standard_normal(cnt),
            center_xy[1] + 0.35 * rng.standard_normal(cnt),
            z_center + 0.15 * rng.standard_normal(cnt),
        ], axis=1)
        # integer-valued like the real collectors' output (S3DIS txt /
        # ScanNet ply store rgb as 0-255 ints) — also what makes the
        # packed-H2D uint8 round-trip exact
        rgb = np.rint(np.clip(color + 20.0 * rng.standard_normal((cnt, 3)),
                              0, 255))
        lbl = np.full((cnt, 1), cls, dtype=np.float64)
        rows.append(np.concatenate([xyz, rgb, lbl], axis=1))
    room = np.concatenate(rows, axis=0)
    room[:, :2] -= room[:, :2].min(axis=0)
    return room


def make_synthetic_blocks(
    root: str,
    dataset: str = "s3dis",
    n_train_blocks: int = 24,
    n_test_blocks: int = 8,
    points_per_block: int = 3000,
    n_classes: int = 13,
    seed: int = 0,
    classnames: Optional[List[str]] = None,
) -> tuple[str, str]:
    """Write a reference-layout synthetic dataset; returns
    (train_blocks_dir, test_blocks_dir)."""
    rng = np.random.default_rng(seed)
    if classnames is None:
        if dataset == "s3dis":
            classnames = S3DIS_CLASSNAMES[:n_classes]
        elif dataset == "scannet":
            # real table names so the registry's fold lists resolve
            classnames = SCANNET_CLASSNAMES[:n_classes]
        else:
            classnames = [f"class{i}" for i in range(n_classes)]

    meta = os.path.join(root, "meta")
    os.makedirs(meta, exist_ok=True)
    with open(os.path.join(meta, f"{dataset}_classnames.txt"), "w") as f:
        f.write("\n".join(classnames) + "\n")

    train_dir = os.path.join(root, "blocks_bs1.0_s1.0")
    test_dir = os.path.join(root, "blocks_bs1.0_s1.0_test")
    for d, n_blocks, tag in ((train_dir, n_train_blocks, "train"),
                             (test_dir, n_test_blocks, "test")):
        data_dir = os.path.join(d, "data")
        os.makedirs(data_dir, exist_ok=True)
        for i in range(n_blocks):
            # guarantee every class appears in several blocks
            forced = [i % n_classes, (i + 1) % n_classes, (i + 2) % n_classes]
            extra = rng.choice(n_classes, 3, replace=False).tolist()
            present = sorted(set(forced + extra))
            block = make_synthetic_room(rng, points_per_block, n_classes,
                                        present)
            np.save(os.path.join(
                data_dir, f"Area_{tag}_room_{i}_block_0.npy"), block)
    return train_dir, test_dir


# --------------------------------------------------------------------------- #
# geometry-signature variant: class identity carried by LOCAL structure
# --------------------------------------------------------------------------- #

def _geometry_patch(rng: np.random.Generator, cls: int, cnt: int,
                    center: np.ndarray) -> np.ndarray:
    """`cnt` points whose LOCAL geometry (at the kNN k=20 scale) carries the
    within-group class identity: one of four local-manifold families
    (kind = cls // 4), with class-specific orientation/frequency. Paired
    with the group-colour scheme in `make_synthetic_geometry_room` (colour
    = cls % 4), colour narrows a point to a ~3-4 class group and only the
    local structure — what the geometric-word coding captures (reference
    model/capl.py:344-353, get_basis.py:162-205) — separates classes inside
    the group."""
    prng = np.random.default_rng(2000 + cls)   # stable per-class parameters
    kind = (cls // 4) % 4
    # class-specific orthonormal frame
    q, _ = np.linalg.qr(prng.standard_normal((3, 3)))
    u, v, w = q[:, 0], q[:, 1], q[:, 2]
    s = 0.45                                    # patch half-extent (metres)
    a = rng.uniform(-s, s, cnt)
    b = rng.uniform(-s, s, cnt)
    if kind == 0:                               # flat planar patch
        pts = a[:, None] * u + b[:, None] * v \
            + 0.012 * rng.standard_normal((cnt, 1)) * w
    elif kind == 1:                             # bundle of parallel lines
        n_lines = 3 + (cls % 3)
        offs = prng.uniform(-s, s, n_lines)
        pick = rng.integers(0, n_lines, cnt)
        pts = a[:, None] * u + offs[pick, None] * v \
            + 0.015 * rng.standard_normal((cnt, 3))
    elif kind == 2:                             # volumetric scatter
        pts = (a[:, None] * u + b[:, None] * v
               + rng.uniform(-s, s, cnt)[:, None] * w)
    else:                                       # corrugated sheet
        freq = 6.0 + 3.0 * (cls // 4)
        height = 0.10 * np.sin(freq * a) * np.cos(freq * b)
        pts = a[:, None] * u + b[:, None] * v \
            + (height + 0.012 * rng.standard_normal(cnt))[:, None] * w
    return center[None, :] + pts


_GROUP_COLORS = np.array([[205, 85, 70], [70, 190, 90],
                          [80, 110, 215], [210, 200, 75]], np.float64)


def make_synthetic_geometry_room(rng: np.random.Generator,
                                 n_points: int = 8000, n_classes: int = 13,
                                 present: Optional[Sequence[int]] = None
                                 ) -> np.ndarray:
    """One room where colour narrows a point to a CLASS GROUP and only
    local geometry separates classes within it: colour group = cls % 4
    (classes 0/4/8/12 share a colour, 1/5/9 share another, ...) while the
    local-manifold family = cls // 4 — so the semantic features can learn
    the group from colour, and resolving the class inside the group
    requires exactly the local-structure signal the geometric-word coding
    captures. Patch centres are uniform (position classless)."""
    if present is None:
        n_present = rng.integers(3, min(8, n_classes) + 1)
        present = rng.choice(n_classes, n_present, replace=False)
    present = np.asarray(present)
    pts_per = np.maximum(rng.multinomial(
        n_points, np.ones(len(present)) / len(present)), 150)
    rows = []
    for cls, cnt in zip(present, pts_per):
        center = np.array([rng.uniform(0.6, 3.4), rng.uniform(0.6, 3.4),
                           rng.uniform(0.8, 2.2)])
        # ~12% structural contaminant drawn from OTHER classes' signatures
        # (real objects mix local structures): the geometric-word k-means —
        # which only ever sees BASE-class features (get_basis.py:162-183) —
        # therefore allocates words for EVERY signature, while each class's
        # energy-thresholded coding keeps only its dominant own-signature
        # words. That exclusivity is what makes the evaluation reweighting
        # differential (a base class is NOT boosted at a novel-geometry
        # point), matching how the mechanism works on real scans.
        n_cont = int(0.12 * cnt)
        n_own = int(cnt) - n_cont
        parts = [_geometry_patch(rng, int(cls), n_own, center)]
        if n_cont:
            others = rng.integers(0, n_classes, n_cont)
            for oc in np.unique(others):
                parts.append(_geometry_patch(
                    rng, int(oc), int(np.sum(others == oc)), center))
        xyz = np.concatenate(parts, axis=0)
        color = _GROUP_COLORS[int(cls) % 4]
        rgb = np.rint(np.clip(color + 25.0 * rng.standard_normal(
            (len(xyz), 3)), 0, 255))             # colour = group only
        lbl = np.full((len(xyz), 1), cls, dtype=np.float64)
        rows.append(np.concatenate([xyz, rgb, lbl], axis=1))
    room = np.concatenate(rows, axis=0)
    room[:, :2] -= room[:, :2].min(axis=0)
    return room


def make_synthetic_geometry_blocks(
    root: str,
    dataset: str = "s3dis",
    n_train_blocks: int = 24,
    n_test_blocks: int = 8,
    points_per_block: int = 3000,
    n_classes: int = 13,
    seed: int = 0,
    classnames: Optional[List[str]] = None,
) -> tuple[str, str]:
    """`make_synthetic_blocks` with geometry-signature rooms — the dataset
    the GW-mechanism tests use: class identity is carried by local geometry
    so geometric-word codings DISCRIMINATE and the coding/eval_weight path
    measurably moves novel-class mIoU (round-4 verdict missing #3)."""
    rng = np.random.default_rng(seed)
    if classnames is None:
        if dataset == "s3dis":
            classnames = S3DIS_CLASSNAMES[:n_classes]
        elif dataset == "scannet":
            classnames = SCANNET_CLASSNAMES[:n_classes]
        else:
            classnames = [f"class{i}" for i in range(n_classes)]

    meta = os.path.join(root, "meta")
    os.makedirs(meta, exist_ok=True)
    with open(os.path.join(meta, f"{dataset}_classnames.txt"), "w") as f:
        f.write("\n".join(classnames) + "\n")

    train_dir = os.path.join(root, "blocks_bs1.0_s1.0")
    test_dir = os.path.join(root, "blocks_bs1.0_s1.0_test")
    for d, n_blocks, tag in ((train_dir, n_train_blocks, "train"),
                             (test_dir, n_test_blocks, "test")):
        data_dir = os.path.join(d, "data")
        os.makedirs(data_dir, exist_ok=True)
        for i in range(n_blocks):
            # 3-4 classes per block (vs 4-6 in the blob rooms): denser
            # per-class patches so the kNN neighbourhoods resolve the local
            # manifold even at CI point counts
            forced = [i % n_classes, (i + 1) % n_classes]
            extra = rng.choice(n_classes, 2, replace=False).tolist()
            present = sorted(set(forced + extra))
            block = make_synthetic_geometry_room(rng, points_per_block,
                                                 n_classes, present)
            np.save(os.path.join(
                data_dir, f"Area_{tag}_room_{i}_block_0.npy"), block)
    return train_dir, test_dir
