"""Label visualisation helpers (reference util/util.py:159-163 colorize).

Maps per-point class labels to RGB colours for dumping coloured point clouds
or palette PNGs. Pure numpy; PIL only needed for save_png.
"""
from __future__ import annotations

import numpy as np

# 21-entry palette (covers S3DIS 13 and ScanNet 21), RGB uint8
PALETTE = np.array([
    [174, 199, 232], [152, 223, 138], [31, 119, 180], [255, 187, 120],
    [188, 189, 34], [140, 86, 75], [255, 152, 150], [214, 39, 40],
    [197, 176, 213], [148, 103, 189], [196, 156, 148], [23, 190, 207],
    [247, 182, 210], [219, 219, 141], [255, 127, 14], [158, 218, 229],
    [44, 160, 44], [112, 128, 144], [227, 119, 194], [82, 84, 163],
    [100, 85, 144],
], dtype=np.uint8)


def colorize(labels: np.ndarray, palette: np.ndarray = PALETTE) -> np.ndarray:
    """Map integer labels (...,) to RGB uint8 (..., 3)."""
    labels = np.asarray(labels, dtype=np.int64) % len(palette)
    return palette[labels]


def save_png(labels_2d: np.ndarray, path: str,
             palette: np.ndarray = PALETTE):
    """Save a 2-D label map as a palette PNG (needs PIL)."""
    from PIL import Image

    Image.fromarray(colorize(labels_2d, palette)).save(path)


def labeled_pointcloud(xyz: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """(N, 3) xyz + (N,) labels -> (N, 6) xyzrgb float array for viewers."""
    rgb = colorize(labels).astype(np.float64)
    return np.concatenate([np.asarray(xyz, np.float64), rgb], axis=1)
