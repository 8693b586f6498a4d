"""Dataset metadata / split registries for S3DIS and ScanNet.

The port's own copy of the JAX package's data/registry.py; it imports
nothing of that package, so the two can be held against each other.

Parity with reference dataloaders/s3dis.py + scannet.py: class-name tables,
cvfold novel/base splits, and the cached class2scans mapping (a block
qualifies for a class when it has > max(5% of points, 100) labelled points).
The class2scans.pkl cache format is identical, so datasets prepared for the
reference load directly.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

S3DIS_CLASSNAMES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
]
SCANNET_CLASSNAMES = [
    "unannotated", "wall", "floor", "chair", "table", "desk", "bed",
    "bookshelf", "sofa", "sink", "bathtub", "toilet", "curtain", "counter",
    "door", "window", "shower curtain", "refridgerator", "picture", "cabinet",
    "otherfurniture",
]

# cvfold -> novel-class NAMES (reference s3dis.py:27-28, scannet.py:23-25)
S3DIS_FOLDS = {
    0: ["table", "window", "column", "beam", "board", "sofa"],
    1: ["wall", "ceiling", "floor", "clutter", "bookcase", "door", "chair"],
}
SCANNET_FOLDS = {
    0: ["sink", "toilet", "bathtub", "shower curtain", "picture", "counter"],
    1: ["refridgerator", "desk", "curtain", "sofa", "bookshelf", "bed",
        "table", "otherfurniture", "window", "cabinet", "door", "chair",
        "unannotated", "floor", "wall"],
}

MIN_RATIO = 0.05
MIN_PTS = 100


class DatasetRegistry:
    """Registry of one prepared block directory (`<data_path>/data/*.npy`).

    Attributes mirror the reference dataset objects: `classes` (count),
    `class2type`, `type2class`, `train_classes`, `test_classes`,
    `class2scans`.
    """

    def __init__(self, dataset: str, cvfold: int, data_path: str,
                 classnames: Optional[Sequence[str]] = None):
        self.dataset = dataset
        self.cvfold = cvfold
        self.data_path = data_path

        if classnames is None:
            classnames = self._load_classnames()
        self.classnames = list(classnames)
        self.classes = len(self.classnames)
        self.class2type = dict(enumerate(self.classnames))
        self.type2class = {v: k for k, v in self.class2type.items()}

        folds = S3DIS_FOLDS if dataset == "s3dis" else SCANNET_FOLDS
        if cvfold not in folds:
            raise NotImplementedError(
                f"Unknown cvfold ({cvfold}). [Options: 0,1]")
        self.test_classes = [self.type2class[n] for n in folds[cvfold]]
        self.train_classes = [c for c in range(self.classes)
                              if c not in self.test_classes]
        self.class2scans = self._get_class2scans()

    def _load_classnames(self) -> List[str]:
        """Read `<dirname(data_path)>/meta/<dataset>_classnames.txt` like the
        reference; fall back to the built-in table when the meta dir is
        absent."""
        meta = os.path.join(os.path.dirname(self.data_path), "meta",
                            f"{self.dataset}_classnames.txt")
        if os.path.exists(meta):
            with open(meta) as f:
                return [line.strip() for line in f if line.strip()]
        if self.dataset == "s3dis":
            return list(S3DIS_CLASSNAMES)
        if self.dataset == "scannet":
            return list(SCANNET_CLASSNAMES)
        raise NotImplementedError(f"Unknown dataset {self.dataset}!")

    def _get_class2scans(self) -> Dict[int, List[str]]:
        cache = os.path.join(self.data_path, "class2scans.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)

        class2scans: Dict[int, List[str]] = {k: [] for k in range(self.classes)}
        for file in sorted(glob.glob(os.path.join(self.data_path, "data",
                                                  "*.npy"))):
            scan_name = os.path.basename(file)[:-4]
            data = np.load(file)
            labels = data[:, 6].astype(np.int64)
            threshold = max(int(data.shape[0] * MIN_RATIO), MIN_PTS)
            for class_id in np.unique(labels):
                if np.count_nonzero(labels == class_id) > threshold:
                    class2scans[int(class_id)].append(scan_name)

        with open(cache, "wb") as f:
            pickle.dump(class2scans, f, pickle.HIGHEST_PROTOCOL)
        return class2scans


def make_registry(dataset: str, cvfold: int, data_path: str) -> DatasetRegistry:
    if dataset not in ("s3dis", "scannet"):
        raise NotImplementedError(f"Unknown dataset {dataset}!")
    return DatasetRegistry(dataset, cvfold, data_path)
