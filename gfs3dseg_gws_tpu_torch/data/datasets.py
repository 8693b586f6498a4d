"""Dataset views over prepared block directories.

The port's own copy of the JAX package's data/datasets.py; it imports
nothing of that package, so the two can be held against each other.

Parity targets:
  * PretrainBlockDataset  — reference dataloaders/loader.py:159-264
    (MyPretrainDataset / MyPretrainDataset_CheckBasis).
  * ValSuppDataset        — loader.py:269-421: one-time materialisation of the
    static support set `ValSupp_S{fold}_K{shot}_Seed{seed}/{pcd,mask,
    segment_label}/*.pkl`, then reads from it forever.
  * TestingDataset        — loader.py:426-556: one-time materialisation of
    `static_test_{npts}/{pcd,label,segment_label}/*.pkl`; labels re-mapped
    from class-name order to learning order at read time.

All return channel-LAST (N, C) arrays (the TPU layout); the reference's
(C, N) transpose happens only in its torch collate.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gfs3dseg_gws_tpu_torch.data.registry import DatasetRegistry, make_registry
from gfs3dseg_gws_tpu_torch.data.sampler import (LegacyRNG, sample_k_pointclouds,
                                           sample_pointcloud)


class PretrainBlockDataset:
    """All blocks of the given classes; uniform 2048-pt sampling per block."""

    def __init__(self, data_path: str, classes: Sequence, class2scans: Dict,
                 mode: str = "train", num_point: int = 2048,
                 pc_attribs: str = "xyzrgbXYZ", pc_augm: bool = False,
                 pc_augm_config: Optional[Dict] = None,
                 use_all_classes: bool = False, split_ratio: float = 0.0):
        """split_ratio=0 reproduces the top-level MyPretrainDataset (train
        mode uses ALL blocks, loader.py:190-191); split_ratio=0.1 reproduces
        the pretrain-tree 90/10 variant (pretrain/dataloaders/loader.py:
        398-399)."""
        self.data_path = data_path
        self.classes = list(classes)
        self.num_point = num_point
        self.pc_attribs = pc_attribs
        self.pc_augm = pc_augm
        self.pc_augm_config = pc_augm_config
        self.use_all_classes = use_all_classes

        train_block_names: List[str] = []
        all_block_names: List[str] = []
        for _, v in sorted(class2scans.items()):
            all_block_names.extend(v)
            n_blocks = len(v)
            n_test = int(n_blocks * split_ratio) if split_ratio else int(
                n_blocks * 0.1)
            train_block_names.extend(v[: n_blocks - n_test])

        if mode == "train":
            if split_ratio:
                self.block_names = sorted(set(train_block_names))
            else:
                self.block_names = sorted(set(all_block_names))
        elif mode == "test":
            self.block_names = sorted(
                set(all_block_names) - set(train_block_names))
        else:
            raise NotImplementedError("Mode is unknown!")

    def __len__(self):
        return len(self.block_names)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        pc, label, seg = sample_pointcloud(
            self.data_path, self.num_point, self.pc_attribs, self.pc_augm,
            self.pc_augm_config, self.block_names[index], self.classes,
            random_sample=True, use_all_classes=self.use_all_classes, rng=rng)
        return pc, label.astype(np.int64), seg


class ValSuppDataset:
    """Static K-shot support set for the novel classes (binary masks)."""

    def __init__(self, data_path: str, dataset_name: str, cvfold: int = 0,
                 k_shot: int = 5, mode: str = "test", num_point: int = 2048,
                 pc_attribs: str = "xyzrgbXYZ", seed: int = 1,
                 learning_order: Optional[Sequence[int]] = None,
                 registry: Optional[DatasetRegistry] = None):
        self.data_path = data_path
        self.k_shot = k_shot
        self.num_point = num_point
        self.pc_attribs = pc_attribs
        self.seed = seed
        self.cvfold = cvfold
        self.learning_order = list(learning_order) if learning_order else None

        ds = registry or make_registry(dataset_name, cvfold, data_path)
        classes = ds.train_classes if mode == "train" else ds.test_classes
        self.classes = np.sort(np.array(classes))
        self.class2scans = ds.class2scans

        self.save_path = os.path.join(
            self.data_path, f"ValSupp_S{cvfold}_K{k_shot}_Seed{seed}")
        self.data_list = self._initialize()

    def _initialize(self) -> List[str]:
        if not os.path.exists(self.save_path):
            self._generate_episode()
        names = sorted(os.listdir(os.path.join(self.save_path, "pcd")))
        # a crash mid-_generate_episode leaves a partial tree that would
        # otherwise be reused forever, silently registering prototypes for
        # only some novel classes
        expected = len(self.classes) * self.k_shot
        if len(names) != expected:
            raise RuntimeError(
                f"support set {self.save_path} holds {len(names)} shots but "
                f"{expected} ({len(self.classes)} classes x K={self.k_shot}) "
                "were expected — delete the partial dir to re-materialise")
        return names

    def _generate_episode(self):
        """Materialise k_shot support blocks per novel class
        (loader.py:373-421).

        BYTE-IDENTICAL to the reference: LegacyRNG(seed) replays the exact
        `np.random.seed(seed)`/`random.seed(seed)` MT19937 streams the
        reference's generate_one_episode consumes (loader.py:381-385), so
        for the same seed and the same class2scans.pkl both frameworks
        materialise identical pkl fixtures (pinned by
        tests/test_fixture_rng_oracle.py). Scans already used by one class
        are blacklisted for the next."""
        rng = LegacyRNG(self.seed)
        black_list: List[str] = []
        for sampled_class in self.classes:
            names = [s for s in self.class2scans[int(sampled_class)]
                     if s not in black_list]
            selected = rng.choice(names, self.k_shot, replace=False)
            black_list.extend(selected)
            pcs, masks, segs = sample_k_pointclouds(
                self.data_path, self.num_point, self.pc_attribs, False, None,
                selected, int(sampled_class), self.classes, is_support=True,
                rng=rng)
            for sub in ("pcd", "mask", "segment_label"):
                os.makedirs(os.path.join(self.save_path, sub), exist_ok=True)
            for k in range(self.k_shot):
                stem = f"class{int(sampled_class)}_{k}.pkl"
                for sub, arr in (("pcd", pcs[k]), ("mask", masks[k]),
                                 ("segment_label", segs[k])):
                    with open(os.path.join(self.save_path, sub, stem),
                              "wb") as f:
                        pickle.dump(arr, f)

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, index: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Returns (pcd (N, 9), mask (N,), class learning-order index)."""
        name = self.data_list[index]
        with open(os.path.join(self.save_path, "pcd", name), "rb") as f:
            pcd = pickle.load(f)
        with open(os.path.join(self.save_path, "mask", name), "rb") as f:
            mask = pickle.load(f)
        cls = int(name.split("_")[0][5:])
        if self.learning_order is not None:
            cls = self.learning_order.index(cls)
        return (pcd.astype(np.float32), mask.astype(np.float32), cls)


class TestingDataset:
    """Static full-class query sweep (`static_test_{npts}`)."""

    def __init__(self, data_path: str, class_names: Sequence[int],
                 learning_order: Sequence[int], class2scans: Dict,
                 mode: str = "test", num_point: int = 2048,
                 pc_attribs: str = "xyzrgbXYZ", seed: int = 321):
        if mode != "test":
            raise NotImplementedError("this dataset is only for testing!")
        self.data_path = data_path
        self.classes = list(class_names)
        self.learning_order = list(learning_order)
        self.num_point = num_point
        self.pc_attribs = pc_attribs
        self.seed = seed

        all_block_names: List[str] = []
        for _, v in sorted(class2scans.items()):
            all_block_names.extend(v)
        self.block_names = sorted(set(all_block_names))

        self.save_path = os.path.join(self.data_path,
                                      f"static_test_{num_point}")
        self.data_list = self._initialize()
        # reference loader.py:471 — a partial static_test dir (crashed
        # materialisation) or one built from a different block set must not
        # be silently evaluated as if complete
        assert len(self.data_list) == len(self.block_names), (
            f"static_test dir {self.save_path} holds {len(self.data_list)} "
            f"blocks but the registry lists {len(self.block_names)}; delete "
            "the stale dir to re-materialise")

    def _initialize(self) -> List[str]:
        if not os.path.exists(self.save_path):
            self._create_static()
        names = os.listdir(os.path.join(self.save_path, "pcd"))
        return sorted(names, key=lambda s: int(s.split(".")[0]))

    def _create_static(self):
        """Materialise every block in the test dir once (loader.py:491-521);
        labels stored in class-NAME order.

        BYTE-IDENTICAL to the reference: the reference consumes the global
        legacy RNG, which train.py:825-828 seeds with args.seed (default
        321) right before main() and nothing touches in between, so
        LegacyRNG(seed) replays the same stream.  The block enumeration
        deliberately uses the UNsorted os.listdir order — that is the
        reference's enumeration (loader.py:500-501), and the draw sequence
        (hence every sampled block) depends on it.  Which physical block
        lands in which {i}.pkl therefore matches the reference exactly on
        the same filesystem state (and is filesystem-order dependent in
        both frameworks — a reference quirk, kept for parity; labels are
        stored alongside each block so downstream results do not depend on
        the enumeration)."""
        rng = LegacyRNG(self.seed)
        src = os.path.join(self.data_path, "data")
        block_list = os.listdir(src)
        for sub in ("pcd", "label", "segment_label"):
            os.makedirs(os.path.join(self.save_path, sub), exist_ok=True)
        for i, fname in enumerate(block_list):
            block_name = fname[:-4]
            pcd, label, seg = sample_pointcloud(
                self.data_path, self.num_point, self.pc_attribs, False, None,
                block_name, self.classes, random_sample=True,
                use_all_classes=True, rng=rng)
            for sub, arr in (("pcd", pcd), ("label", label),
                             ("segment_label", seg)):
                with open(os.path.join(self.save_path, sub, f"{i}.pkl"),
                          "wb") as f:
                    pickle.dump(arr, f)

    def __len__(self):
        return len(self.data_list)

    def packed_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The whole static_test set as contiguous memmaps + a label LUT.

        The reference sweep (train.py:666-731) pays a pickle parse plus a
        per-unique-class python remap loop per block; at TPU eval rates
        (>1.5k blocks/s/chip) that host path dominates the sweep. This
        packs all blocks ONCE into `packed_pcd.npy` (M, N, C) float32 and
        `packed_label.npy` (M, N) int32 (class-NAME order, exactly the
        pickle contents), after which a batch is a pure memmap slice.

        Returns (pcd_memmap, label_memmap, lut) where lut maps class-name
        ids to learning-order ids (apply `lut[label]`); the cache itself is
        independent of the learning order. Stale caches (block count
        mismatch) are rebuilt.
        """
        pcd_path = os.path.join(self.save_path, "packed_pcd.npy")
        lbl_path = os.path.join(self.save_path, "packed_label.npy")
        m = len(self.data_list)
        c = len(self.pc_attribs)
        pcd, lbl = self._load_cache(
            ((pcd_path, np.float32, (m, self.num_point, c)),
             (lbl_path, np.int32, (m, self.num_point))), self._build_packed)
        return pcd, lbl, self._label_lut()

    def packed_q_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]:
        """Quantised transfer cache: xyz f16 + rgb u8 (+ labels, lut).

        9 bytes/point instead of 36 — the H2D payload for the packed eval
        path (parallel.steps.unpack_points reconstructs xyzrgbXYZ on
        device). rgb recovers the original uint8 exactly (fixtures store
        orig/255); xyz is f16-quantised and XYZ recomputed on device — the
        documented throughput-mode deviation.
        """
        xyz_path = os.path.join(self.save_path, "packed_xyz16.npy")
        rgb_path = os.path.join(self.save_path, "packed_rgb8.npy")
        lbl_path = os.path.join(self.save_path, "packed_label.npy")
        m = len(self.data_list)
        if "xyz" not in self.pc_attribs or "rgb" not in self.pc_attribs:
            raise ValueError("packed transfer needs xyz+rgb attributes")
        xyz, rgb, lbl = self._load_cache(
            ((xyz_path, np.float16, (m, self.num_point, 3)),
             (rgb_path, np.uint8, (m, self.num_point, 3)),
             (lbl_path, np.int32, (m, self.num_point))),
            self._build_packed_q)
        return xyz, rgb, lbl, self._label_lut()

    def _label_lut(self) -> np.ndarray:
        """class-NAME id -> learning-order id (shared by both eval caches so
        the exact and quantised paths can never remap labels differently)."""
        lut = np.zeros(max(self.learning_order) + 1, np.int32)
        for pos, cls in enumerate(self.learning_order):
            lut[cls] = pos
        return lut

    def _load_cache(self, specs, builder):
        """Validated memmap cache loader: EVERY file must exist with the
        exact expected shape+dtype or the whole set is rebuilt (a
        count-only check silently served mismatched label files)."""
        ok = all(os.path.exists(path) for path, _, _ in specs)
        if ok:
            arrays = []
            for path, dtype, shape in specs:
                arr = np.load(path, mmap_mode="r")
                if arr.shape != shape or arr.dtype != dtype:
                    ok = False
                    break
                arrays.append(arr)
        if not ok:
            # may raise OSError on a read-only dataset mount — callers
            # (pipelines.gfs.eval_batches) fall back to the pickle path
            builder(specs)
            arrays = [np.load(path, mmap_mode="r") for path, _, _ in specs]
        return tuple(arrays)

    def _tmp_suffix(self) -> str:
        # unique per process: two concurrent eval jobs over one static_test
        # dir must not interleave writes into the same tmp memmap
        return f".tmp.{os.getpid()}"

    def _build_packed(self, specs) -> None:
        (pcd_path, _, pcd_shape), (lbl_path, _, lbl_shape) = specs
        tmp = self._tmp_suffix()
        pcd = np.lib.format.open_memmap(
            pcd_path + tmp, mode="w+", dtype=np.float32, shape=pcd_shape)
        lbl = np.lib.format.open_memmap(
            lbl_path + tmp, mode="w+", dtype=np.int32, shape=lbl_shape)
        for i, name in enumerate(self.data_list):
            with open(os.path.join(self.save_path, "pcd", name), "rb") as f:
                pcd[i] = pickle.load(f).astype(np.float32)
            with open(os.path.join(self.save_path, "label", name),
                      "rb") as f:
                lbl[i] = pickle.load(f).astype(np.int32)
        pcd.flush()
        lbl.flush()
        del pcd, lbl
        os.replace(pcd_path + tmp, pcd_path)
        os.replace(lbl_path + tmp, lbl_path)

    def _build_packed_q(self, specs) -> None:
        (xyz_path, _, xyz_shape), (rgb_path, _, rgb_shape), \
            (lbl_path, _, lbl_shape) = specs
        tmp = self._tmp_suffix()
        xyz = np.lib.format.open_memmap(
            xyz_path + tmp, mode="w+", dtype=np.float16, shape=xyz_shape)
        rgb = np.lib.format.open_memmap(
            rgb_path + tmp, mode="w+", dtype=np.uint8, shape=rgb_shape)
        lbl = np.lib.format.open_memmap(
            lbl_path + tmp, mode="w+", dtype=np.int32, shape=lbl_shape)
        # the on-disk pickle layout is the sampler's presence-ordered
        # [xyz, rgb, XYZ] parts list (sampler.py:162-167), NOT the attrib
        # string order: xyz is always first and rgb always follows it
        # (packed_q_arrays already requires both)
        xyz_cols, rgb_cols = 0, 3
        try:
            for i, name in enumerate(self.data_list):
                with open(os.path.join(self.save_path, "pcd", name),
                          "rb") as f:
                    block = pickle.load(f).astype(np.float32)
                coords = block[:, xyz_cols:xyz_cols + 3]
                x16 = coords.astype(np.float16)
                if np.isinf(x16).any() and np.isfinite(coords).all():
                    # same guard as parallel.steps.pack_batch: huge absolute
                    # coordinates (UTM offsets, mm units) overflow f16 and
                    # would make every packed-sweep metric silently garbage
                    raise ValueError(
                        f"block {name}: coordinates overflow float16 — the "
                        "quantised eval cache cannot represent this dataset; "
                        "use h2d='exact' (or GFS3D_EXACT_H2D=1)")
                xyz[i] = x16
                # clip (not modulo-wrap) rgb outside [0,1], as pack_batch does
                rgb[i] = np.clip(np.rint(block[:, rgb_cols:rgb_cols + 3]
                                         * 255.0), 0, 255).astype(np.uint8)
                with open(os.path.join(self.save_path, "label", name),
                          "rb") as f:
                    lbl[i] = pickle.load(f).astype(np.int32)
        except Exception:
            del xyz, rgb, lbl
            for path, _, _ in specs:
                try:
                    os.remove(path + tmp)
                except OSError:
                    pass
            raise
        for arr in (xyz, rgb, lbl):
            arr.flush()
        del xyz, rgb, lbl
        for path, _, _ in specs:
            os.replace(path + tmp, path)

    def __getitem__(self, index: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (pcd (N, 9), label in LEARNING order (N,), segment (N,))."""
        name = self.data_list[index]
        with open(os.path.join(self.save_path, "pcd", name), "rb") as f:
            pcd = pickle.load(f)
        with open(os.path.join(self.save_path, "label", name), "rb") as f:
            label = pickle.load(f)
        # class-name order -> learning order (loader.py:543-550)
        final = np.zeros_like(label)
        for cls in np.unique(label):
            final[label == cls] = self.learning_order.index(cls)
        with open(os.path.join(self.save_path, "segment_label", name),
                  "rb") as f:
            seg = pickle.load(f)
        return (pcd.astype(np.float32), final.astype(np.int64),
                seg.astype(np.float32))
