"""Episodic few-shot datasets for the baselines (counterpart of the JAX
package's data/episodes.py; reference pretrain/dataloaders/loader.py:144-362).

`EpisodeDataset` draws N-way K-shot episodes on the fly from the
class2scans registry (scans used by one way are blacklisted for the next);
`StaticEpisodeBank` materialises a fixed bank of test episodes, one file an
episode, with the reference's five datasets (support_ptclouds,
support_masks, query_ptclouds, query_labels, sampled_classes).

A bank is written in the reference's `.h5` format when h5py is installed
and as `.npz` files of the same five arrays, names and dtypes otherwise
(`default_format`); an existing bank is read in the format of its files,
and reading `.h5` needs h5py. The same seed gives the same arrays in
either format and in the JAX package's bank.
"""
from __future__ import annotations

import glob
import importlib.util
import os
from itertools import combinations
from typing import Dict, List, Optional, Sequence

import numpy as np

from gfs3dseg_gws_tpu_torch.data.registry import (DatasetRegistry,
                                                  make_registry)
from gfs3dseg_gws_tpu_torch.data.sampler import (LegacyRNG,
                                                 sample_k_pointclouds)

# the reference schema: dataset name -> dtype, in file order
EPISODE_KEYS = (("support_ptclouds", "float32"), ("support_masks", "int32"),
                ("query_ptclouds", "float32"), ("query_labels", "int64"),
                ("sampled_classes", "int32"))
FORMATS = ("h5", "npz")


def default_format() -> str:
    """`h5` where h5py is installed, else `npz`."""
    return "h5" if importlib.util.find_spec("h5py") is not None else "npz"


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading or writing an .h5 episode needs h5py, "
                          "which is not installed; a bank written where it "
                          "is not installed is .npz and needs none") from e
    return h5py


class EpisodeDataset:
    """On-the-fly N-way K-shot episodes."""

    def __init__(self, data_path: str, dataset_name: str, cvfold: int = 0,
                 num_episode: int = 50_000, n_way: int = 3, k_shot: int = 5,
                 n_queries: int = 1, mode: str = "train",
                 num_point: int = 2048, pc_attribs: str = "xyzrgbXYZ",
                 pc_augm: bool = False, pc_augm_config: Optional[Dict] = None,
                 registry: Optional[DatasetRegistry] = None):
        self.data_path = data_path
        self.n_way = n_way
        self.k_shot = k_shot
        self.n_queries = n_queries
        self.num_episode = num_episode
        self.num_point = num_point
        self.pc_attribs = pc_attribs
        self.pc_augm = pc_augm
        self.pc_augm_config = pc_augm_config

        ds = registry or make_registry(dataset_name, cvfold, data_path)
        self.classes = np.array(ds.train_classes if mode == "train"
                                else ds.test_classes)
        self.class2scans = ds.class2scans

    def __len__(self):
        return self.num_episode

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None,
                    n_way_classes: Optional[Sequence[int]] = None):
        """(support (w, s, N, C), support masks (w, s, N), query
        (w*q, N, C), query labels (w*q, N), sampled classes (w,))."""
        rng = rng or np.random.default_rng()
        if n_way_classes is not None:
            sampled = np.array(n_way_classes)
        else:
            sampled = rng.choice(self.classes, self.n_way, replace=False)
        return self.generate_one_episode(sampled, rng) + (
            sampled.astype(np.int32),)

    def generate_one_episode(self, sampled_classes: np.ndarray, rng):
        s_pc, s_mask, q_pc, q_lbl = [], [], [], []
        black_list: List[str] = []
        for cls in sampled_classes:
            names = [x for x in self.class2scans[int(cls)]
                     if x not in black_list]
            selected = rng.choice(names, self.k_shot + self.n_queries,
                                  replace=False)
            black_list.extend(selected)
            q_names = selected[: self.n_queries]
            s_names = selected[self.n_queries:]

            qp, ql, _ = sample_k_pointclouds(
                self.data_path, self.num_point, self.pc_attribs, self.pc_augm,
                self.pc_augm_config, q_names, int(cls), sampled_classes,
                is_support=False, rng=rng)
            sp, sm, _ = sample_k_pointclouds(
                self.data_path, self.num_point, self.pc_attribs, self.pc_augm,
                self.pc_augm_config, s_names, int(cls), sampled_classes,
                is_support=True, rng=rng)
            q_pc.append(qp)
            q_lbl.append(ql)
            s_pc.append(sp)
            s_mask.append(sm)

        return (np.stack(s_pc).astype(np.float32),
                np.stack(s_mask).astype(np.int32),
                np.concatenate(q_pc).astype(np.float32),
                np.concatenate(q_lbl).astype(np.int64))


def _stem(path: str) -> int:
    return int(os.path.splitext(os.path.basename(path))[0])


class StaticEpisodeBank:
    """A fixed bank of test episodes, one file an episode, in
    `<data_path>/S_{cvfold}_N_{n_way}_K_{k_shot}{tag}_episodes_{n}_pts_{N}`
    (tag `_test` unless mode is `valid`), files named by episode index.
    A bank this call writes takes `default_format()`; an existing bank
    keeps the format of its files (`self.format`)."""

    def __init__(self, data_path: str, dataset_name: str, cvfold: int = 0,
                 num_episode_per_comb: int = 100, n_way: int = 3,
                 k_shot: int = 5, n_queries: int = 1, num_point: int = 2048,
                 pc_attribs: str = "xyzrgbXYZ", mode: str = "valid",
                 seed: int = 321,
                 registry: Optional[DatasetRegistry] = None):
        source = EpisodeDataset(data_path, dataset_name, cvfold=cvfold,
                                n_way=n_way, k_shot=k_shot,
                                n_queries=n_queries, mode="test",
                                num_point=num_point, pc_attribs=pc_attribs,
                                registry=registry)
        self.classes = source.classes
        tag = "" if mode == "valid" else "_test"
        self.bank_path = os.path.join(
            data_path, f"S_{cvfold}_N_{n_way}_K_{k_shot}{tag}_episodes_"
            f"{num_episode_per_comb}_pts_{num_point}")

        if os.path.exists(self.bank_path):
            found = {f: glob.glob(os.path.join(self.bank_path, f"*.{f}"))
                     for f in FORMATS}
            present = [f for f in FORMATS if found[f]]
            if len(present) > 1:
                raise ValueError(f"episode bank {self.bank_path} mixes .h5 "
                                 "and .npz files")
            self.format = present[0] if present else default_format()
            self.file_names = sorted(found[self.format], key=_stem)
        else:
            self.format = default_format()
            os.makedirs(self.bank_path)
            # LegacyRNG replays the reference's global-stream draws
            # (pretrain/dataloaders/loader.py:293-322); the class
            # combinations iterate in the registry's fold-table order, the
            # reference's `combinations(self.classes, n_way)`
            rng = LegacyRNG(seed)
            self.file_names = []
            episode_ind = 0
            for comb in combinations([int(c) for c in self.classes], n_way):
                for _ in range(num_episode_per_comb):
                    data = source.generate_one_episode(np.array(comb), rng)
                    out = os.path.join(self.bank_path,
                                       f"{episode_ind}.{self.format}")
                    write_episode(out, data + (np.array(comb, np.int32),))
                    self.file_names.append(out)
                    episode_ind += 1

    def __len__(self):
        return len(self.file_names)

    def __getitem__(self, index: int):
        return read_episode(self.file_names[index])


def write_episode(path: str, data) -> None:
    """One episode's five arrays to `path`: `.h5` (the reference schema,
    needs h5py) or `.npz` (the same names and dtypes)."""
    arrays = {name: np.asarray(a, dtype)
              for (name, dtype), a in zip(EPISODE_KEYS, data)}
    if path.endswith(".npz"):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        return
    with _h5py().File(path, "w") as f:
        for name, dtype in EPISODE_KEYS:
            f.create_dataset(name, data=arrays[name], dtype=dtype)


def read_episode(path: str):
    """(support_ptclouds, support_masks, query_ptclouds, query_labels,
    sampled_classes) of one episode file, `.h5` or `.npz`."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return tuple(z[name] for name, _ in EPISODE_KEYS)
    with _h5py().File(path, "r") as f:
        return tuple(f[name][:] for name, _ in EPISODE_KEYS)
