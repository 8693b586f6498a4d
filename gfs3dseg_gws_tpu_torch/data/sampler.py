"""Block -> fixed-shape sample conversion and augmentation.

The port's own copy of the JAX package's data/sampler.py; it imports
nothing of that package, so the two can be held against each other.

Behavioural parity with reference dataloaders/loader.py:19-151:
  * fixed 2048-point sampling — class-coverage-aware for support shots,
    uniform otherwise;
  * 9-d `xyzrgbXYZ` attributes (shifted xyz, rgb/255, per-block normalised
    XYZ computed AFTER augmentation);
  * z-rotation / uniform scale / axis mirror / Gaussian jitter augmentation
    (rotation matrices composed directly — no transforms3d dependency).
"""
from __future__ import annotations

import math
import os
import random as _pyrandom
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np


class LegacyRNG:
    """Bit-exact replay of the reference's legacy global RNG streams.

    The reference drives all sampling through the GLOBAL numpy legacy RNG
    (`np.random.seed(s)` + `np.random.choice/randn`, MT19937) and the GLOBAL
    python stdlib RNG (`random.seed(s)` + `random.uniform/random`) —
    reference dataloaders/loader.py:381-385 (ValSupp seeding), 39-129
    (sample_pointcloud draws), 132-151 (augmentation draws).  This adapter
    reproduces those streams EXACTLY with instance-local state:
    `np.random.RandomState(s)` is the same MT19937 generator the global
    functions use after `np.random.seed(s)`, and `random.Random(s)` is the
    stdlib generator after `random.seed(s)`.  Methods are named after the
    numpy Generator API the samplers call; each maps onto the function the
    reference calls at that point in the sequence:

        choice          -> np.random.choice   (numpy MT19937)
        standard_normal -> np.random.randn    (numpy MT19937)
        uniform         -> random.uniform     (stdlib Mersenne)
        random          -> random.random      (stdlib Mersenne)

    so for the same seed the draw sequence — and therefore every
    materialised fixture — is byte-identical to the reference's.
    """

    def __init__(self, seed: int):
        self.np_rs = np.random.RandomState(seed)
        self.py = _pyrandom.Random(seed)

    def choice(self, a, size=None, replace=True):
        return self.np_rs.choice(a, size, replace)

    def standard_normal(self, shape):
        return self.np_rs.randn(*shape)

    def uniform(self, lo, hi):
        return self.py.uniform(lo, hi)

    def random(self):
        return self.py.random()


SamplerRNG = Union[np.random.Generator, LegacyRNG]


def _rot_z(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _mirror(axis: int) -> np.ndarray:
    m = np.eye(3)
    m[axis, axis] = -1.0
    return m


def augment_pointcloud(xyz: np.ndarray, config: Dict,
                       rng: SamplerRNG) -> np.ndarray:
    """Random rigid augmentation of xyz + jitter (loader.py:132-151).

    Application order matches the reference composition: scale, then
    z-rotation, then optional x/y mirrors; jitter afterwards on all columns.
    """
    m = np.eye(3)
    if config.get("scale", 0) > 1:
        s = rng.uniform(1.0 / config["scale"], config["scale"])
        m = s * np.eye(3) @ m
    if config.get("rot", 0) == 1:
        m = _rot_z(rng.uniform(0.0, 2.0 * math.pi)) @ m
    if config.get("mirror_prob", 0) > 0:
        if rng.random() < config["mirror_prob"] / 2:
            m = _mirror(0) @ m
        if rng.random() < config["mirror_prob"] / 2:
            m = _mirror(1) @ m
    out = xyz.copy()
    out[:, :3] = xyz[:, :3] @ m.T
    if config.get("jitter", 0):
        sigma, clip = 0.01, 0.05
        out = out + np.clip(sigma * rng.standard_normal(out.shape),
                            -clip, clip).astype(np.float32)
    return out


def sample_pointcloud(
    data_path: str,
    num_point: int,
    pc_attribs: str,
    pc_augm: bool,
    pc_augm_config: Optional[Dict],
    scan_name: str,
    sampled_classes: Sequence,
    sampled_class: int = 0,
    support: bool = False,
    random_sample: bool = False,
    use_all_classes: bool = False,
    rng: Optional[SamplerRNG] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load one block .npy and sample `num_point` points (loader.py:39-129).

    Returns (ptcloud (P, len(attribs)), groundtruth (P,), segment_label (P,)).
    Label semantics:
      * support=True  -> binary mask of `sampled_class`;
      * use_all_classes=False -> 1 + index into `sampled_classes` (0 = other);
      * use_all_classes=True  -> index into `sampled_classes` (no bg slot).
    """
    if rng is None:
        raise TypeError(
            "sample_pointcloud requires an explicit rng (np.random.Generator "
            "or LegacyRNG) — an unseeded default would silently break "
            "reproducibility")
    sampled_classes = list(sampled_classes)

    data = np.load(os.path.join(data_path, "data", f"{scan_name}.npy"))
    n = data.shape[0]

    if random_sample:
        inds = rng.choice(np.arange(n), num_point, replace=(n < num_point))
    else:
        # ensure the target class is represented proportionally
        valid = np.nonzero(data[:, 6] == sampled_class)[0]
        if n < num_point:
            n_valid = len(valid)
        else:
            n_valid = int(len(valid) / float(n) * num_point)
        valid_inds = rng.choice(valid, n_valid, replace=False)
        other_inds = rng.choice(np.arange(n), num_point - n_valid,
                                replace=(n < num_point))
        inds = np.concatenate([valid_inds, other_inds])

    data = data[inds]
    xyz = data[:, 0:3].copy()
    rgb = data[:, 3:6]

    xyz -= np.amin(xyz, axis=0)
    if pc_augm:
        xyz = augment_pointcloud(xyz, pc_augm_config or {}, rng)
    if "XYZ" in pc_attribs:
        shifted = xyz - np.amin(xyz, axis=0)
        span = np.amax(shifted, axis=0)
        norm_xyz = shifted / span

    parts = []
    if "xyz" in pc_attribs:
        parts.append(xyz)
    if "rgb" in pc_attribs:
        parts.append(rgb / 255.0)
    if "XYZ" in pc_attribs:
        parts.append(norm_xyz)
    ptcloud = np.concatenate(parts, axis=1)

    labels = data[:, 6].astype(np.int64)
    if support:
        groundtruth = (labels == sampled_class).astype(np.int64)
    else:
        groundtruth = np.zeros_like(labels)
        offset = 0 if use_all_classes else 1
        for i, cls in enumerate(sampled_classes):
            groundtruth[labels == cls] = i + offset

    if data.shape[1] == 8:
        segment_label = data[:, 7]
    else:
        segment_label = np.zeros(data.shape[0], dtype=data.dtype)

    return (ptcloud.astype(np.float32), groundtruth,
            segment_label.astype(np.float32))


def sample_k_pointclouds(
    data_path: str, num_point: int, pc_attribs: str, pc_augm: bool,
    pc_augm_config: Optional[Dict], scan_names: Sequence[str],
    sampled_class: int, sampled_classes: Sequence, is_support: bool = False,
    rng: Optional[SamplerRNG] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample K point clouds for one class (loader.py:19-36)."""
    clouds, labels, segs = [], [], []
    for scan in scan_names:
        pc, lb, sg = sample_pointcloud(
            data_path, num_point, pc_attribs, pc_augm, pc_augm_config, scan,
            sampled_classes, sampled_class, support=is_support, rng=rng)
        clouds.append(pc)
        labels.append(lb)
        segs.append(sg)
    return (np.stack(clouds), np.stack(labels), np.stack(segs))
