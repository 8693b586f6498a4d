"""The reference's data preparation, worked out again from the raw blocks
in plain numpy (reference dataloaders/loader.py and s3dis.py, train.py):
which blocks list which class, the static test set, the support shots,
each class's geometric-word coding and the registered prototypes.

The reference draws its samples from numpy's legacy global RandomState
and Python's `random`, seeded once (`np.random.seed(s)`); a RandomState of
the same seed replays that stream. Nothing here imports the programs it
judges.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference.gwcapl import features, l2norm

# S3DIS fold -> novel class names (reference dataloaders/s3dis.py:27-28)
S3DIS_FOLDS = {
    0: ["table", "window", "column", "beam", "board", "sofa"],
    1: ["wall", "ceiling", "floor", "clutter", "bookcase", "door", "chair"],
}


class Split:
    """The class split of a fold: base (train) and novel (test) classes by
    class id, and the learning order: base classes, then novel."""

    def __init__(self, classnames: Sequence[str], cvfold: int):
        ids = {n: i for i, n in enumerate(classnames)}
        self.novel = sorted(ids[n] for n in S3DIS_FOLDS[cvfold])
        self.base = [c for c in range(len(classnames)) if c not in self.novel]
        self.order = self.base + self.novel


def read_classnames(blocks_dir: str) -> List[str]:
    meta = os.path.join(os.path.dirname(blocks_dir), "meta",
                        "s3dis_classnames.txt")
    with open(meta) as f:
        return [line.strip() for line in f if line.strip()]


def class2scans(blocks_dir: str, n_classes: int) -> Dict[int, List[str]]:
    """Blocks listed under each class: those with more than max(5% of
    the block, 100) points of it (reference s3dis.py), in file order."""
    out: Dict[int, List[str]] = {c: [] for c in range(n_classes)}
    for path in sorted(glob.glob(os.path.join(blocks_dir, "data", "*.npy"))):
        labels = np.load(path)[:, 6].astype(np.int64)
        thr = max(int(labels.shape[0] * 0.05), 100)
        for c in np.unique(labels):
            if np.count_nonzero(labels == c) > thr:
                out[int(c)].append(os.path.basename(path)[:-4])
    return out


def attributes(rows: np.ndarray) -> np.ndarray:
    """xyz shifted to the block's minimum, rgb / 255, and xyz normalised to
    [0, 1] (pc_attribs 'xyzrgbXYZ'): (P, 9) float32."""
    xyz = rows[:, 0:3] - np.amin(rows[:, 0:3], axis=0)
    shifted = xyz - np.amin(xyz, axis=0)
    norm = shifted / np.amax(shifted, axis=0)
    return np.concatenate([xyz, rows[:, 3:6] / 255.0, norm],
                          axis=1).astype(np.float32)


def static_test(test_dir: str, npts: int, order: Sequence[int],
                seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The static test set: every block, in the directory's listing order,
    sampled to `npts` points by the legacy stream of `seed`; labels in the
    learning order. Returns (points (M, npts, 9), labels (M, npts))."""
    rs = np.random.RandomState(seed)
    where = {c: i for i, c in enumerate(order)}
    lut = np.array([where[c] for c in range(len(order))], np.int64)
    points, labels = [], []
    for fname in os.listdir(os.path.join(test_dir, "data")):
        rows = np.load(os.path.join(test_dir, "data", fname))
        n = rows.shape[0]
        rows = rows[rs.choice(np.arange(n), npts, replace=n < npts)]
        points.append(attributes(rows))
        labels.append(lut[rows[:, 6].astype(np.int64)])
    return np.stack(points), np.stack(labels)


def support_shots(train_dir: str, c2s: Dict[int, List[str]],
                  novel: Sequence[int], k_shot: int, npts: int, seed: int
                  ) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """The k-shot support set of one seed (reference loader.py:373-421):
    per novel class in id order, k blocks drawn from those listing it (a
    block drawn for one class is not drawn again), each sampled so that
    the class keeps its share of the points. Returns (class id, points
    (npts, 9), binary mask (npts,)) per shot."""
    rs = np.random.RandomState(seed)
    black: List[str] = []
    shots = []
    for c in sorted(novel):
        names = [s for s in c2s[c] if s not in black]
        chosen = rs.choice(names, k_shot, replace=False)
        black.extend(chosen)
        for scan in chosen:
            rows = np.load(os.path.join(train_dir, "data", f"{scan}.npy"))
            n = rows.shape[0]
            valid = np.nonzero(rows[:, 6] == c)[0]
            n_valid = len(valid) if n < npts else int(len(valid) / n * npts)
            inds = np.concatenate([
                rs.choice(valid, n_valid, replace=False),
                rs.choice(np.arange(n), npts - n_valid, replace=n < npts)])
            rows = rows[inds]
            shots.append((c, attributes(rows),
                          (rows[:, 6] == c).astype(np.float32)))
    return shots


def energy_multihot(h: np.ndarray, energy: float) -> np.ndarray:
    """Reference train.py:132-152: the words in descending frequency
    (stable), kept until the running sum has passed energy x total (the
    word that passes it is kept)."""
    out = np.zeros_like(h, dtype=np.float32)
    total, run = float(h.sum()), 0.0
    for w in np.argsort(-h, kind="stable"):
        out[w] = 1.0
        run += float(h[w])
        if run > energy * total:
            break
    return out


@torch.no_grad()
def base_coding(p, cfg: dict, train_dir: str, c2s: Dict[int, List[str]],
                split: Split, gp: torch.Tensor, batch: int) -> np.ndarray:
    """Each base class's word coding (reference train.py:156-218) over
    every block that lists a base class, each block whole (its points are
    the sweep's, in any order): the mean one-hot word of the class's
    points, cut to its energy multi-hot. (n_base, K)."""
    names = sorted({s for c in split.base for s in c2s[c]})
    where = {c: i + 1 for i, c in enumerate(split.base)}
    lut = np.array([where.get(c, 0) for c in range(len(split.order))])
    k = gp.shape[0]
    sums = torch.zeros((len(split.base) + 1, k), dtype=torch.float64,
                       device=gp.device)
    for s in range(0, len(names), batch):
        rows = [np.load(os.path.join(train_dir, "data", f"{n}.npy"))
                for n in names[s:s + batch]]
        x = torch.from_numpy(np.stack([attributes(r) for r in rows])).to(
            gp.device)
        y = torch.from_numpy(np.stack([lut[r[:, 6].astype(np.int64)]
                                       for r in rows])).to(gp.device)
        _, onehot = features(p, cfg, x, gp)
        cls = torch.nn.functional.one_hot(y, len(split.base) + 1).double()
        sums += torch.einsum("bnc,bnk->ck", cls, onehot.double())
    sums = sums[1:].cpu().numpy()
    counts = sums.sum(axis=1, keepdims=True)
    means = sums / np.maximum(counts, 1.0)
    return np.stack([energy_multihot(m, cfg["energy"]) for m in means])


@torch.no_grad()
def register(p, cfg: dict, shots, split: Split, gp: torch.Tensor
             ) -> Tuple[np.ndarray, np.ndarray]:
    """One seed's registered prototypes (reference train.py:240-305):
    base rows the learned main_proto, a novel class's row the mean over
    its shots of each shot's mean foreground feature, every row
    L2-normalised; and each novel class's coding, the energy multi-hot of
    its shots' summed foreground word histogram. Returns (protos (cls, C),
    novel codings (n_novel, K)) with rows in the learning order."""
    x = torch.from_numpy(np.stack([s[1] for s in shots])).to(gp.device)
    m = torch.from_numpy(np.stack([s[2] for s in shots])).to(gp.device)
    feat, onehot = features(p, cfg, x, gp)
    means = (torch.einsum("snc,sn->sc", feat.double(), m.double())
             / torch.clamp_min(m.double().sum(1, keepdim=True), 1e-12))
    hists = torch.einsum("snk,sn->sk", onehot.double(), m.double())
    means, hists = means.cpu().numpy(), hists.cpu().numpy()
    classes = np.array([s[0] for s in shots])
    protos = p["main_proto"].detach().double().cpu().numpy().copy()
    codings = []
    for c in split.novel:
        row = split.order.index(c)
        protos[row] = means[classes == c].mean(axis=0)
        h = hists[classes == c].sum(axis=0)
        codings.append(energy_multihot(h / h.sum(), cfg["energy"]))
    protos = l2norm(torch.from_numpy(protos)).float().numpy()
    return protos, np.stack(codings)


def unmatched_rows(train_dir: str, batches, cfg: dict) -> int:
    """Rows of the fed batches (points (B, N, 9), labels (B, N)) that are
    not a sample of a distinct training block: a row is a sample of a
    block when its points' (rgb, label) pairs are a sub-multiset of the
    block's (the loader samples without replacement and does not move
    rgb; labels are the base classes' learning order + 1, 0 for the
    rest), and its normalised xyz spans [0, 1] on every axis."""
    split = Split(read_classnames(train_dir), cfg["cvfold"])
    c2s = class2scans(train_dir, len(split.order))
    names = sorted({s for c in split.base for s in c2s[c]})
    where = {c: i + 1 for i, c in enumerate(split.base)}
    lut = np.array([where.get(c, 0) for c in range(len(split.order))])

    def keys(rgb, label):
        rgb = np.rint(rgb).astype(np.int64)
        return ((rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]) * 16 \
            + label

    block_keys = []
    for n in names:
        rows = np.load(os.path.join(train_dir, "data", f"{n}.npy"))
        block_keys.append(keys(rows[:, 3:6], lut[rows[:, 6].astype(
            np.int64)]))
    owner = np.repeat(np.arange(len(names)), [len(k) for k in block_keys])
    flat = np.concatenate(block_keys)
    order = np.argsort(flat, kind="stable")
    flat, owner = flat[order], owner[order]
    used, unmatched = set(), 0
    for x, y in batches:
        for row in range(x.shape[0]):
            k = keys(x[row, :, 3:6] * 255.0, y[row])
            norm = x[row, :, 6:9]
            spans = (np.abs(norm.min(0)).max() <= 1e-6
                     and np.abs(norm.max(0) - 1.0).max() <= 1e-6)
            lo, hi = np.searchsorted(flat, k[0]), np.searchsorted(
                flat, k[0], side="right")
            uk, uc = np.unique(k, return_counts=True)
            match = None
            for cand in np.unique(owner[lo:hi]):
                bu, bc = np.unique(block_keys[cand], return_counts=True)
                pos = np.minimum(np.searchsorted(bu, uk), len(bu) - 1)
                if np.all(bu[pos] == uk) and np.all(bc[pos] >= uc):
                    match = int(cand)
                    break
            if match is None or match in used or not spans:
                unmatched += 1
            else:
                used.add(match)
    return unmatched
