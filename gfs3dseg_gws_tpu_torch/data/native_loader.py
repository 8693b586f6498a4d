"""ctypes binding for the native C++ block-loader (native/blockloader.cc).

The port's own copy of the JAX package's data/native_loader.py; it imports
nothing of that package, so the two can be held against each other.

The C++ pool replaces the reference's torch DataLoader worker forks
(SURVEY.md §2.3): worker threads parse .npy blocks, sample fixed 2048-point
sets with attribute/label computation and augmentation, and hand back
ready-padded (B, N, 9) float32 batches.

Falls back transparently (is_available() == False) when the shared library
has not been built; `build()` compiles it with the in-image toolchain.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from gfs3dseg_gws_tpu_torch.utils.observability import span

# the loader's source sits at the root of the checkout, beside both packages
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libblockloader.so")

_lib = None

LABEL_LEARNING_ORDER = 0   # sampled_classes.index(label) + 1, bg = 0
LABEL_ALL_CLASSES = 1      # sampled_classes.index(label), no bg slot
LABEL_BINARY = 2           # mask of target_class


def build(force: bool = False) -> bool:
    """Compile native/libblockloader.so with make; returns success.

    Always invokes make (a no-op when the .so is newer than the source) so
    a checkout with a stale library picks up newly added symbols instead of
    silently keeping the old binary."""
    try:
        cmd = ["make", "-C", _NATIVE_DIR]
        if force:
            cmd = ["make", "-C", _NATIVE_DIR, "-B"]
        subprocess.run(cmd, check=True, capture_output=True)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return os.path.exists(_LIB_PATH) and not force


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.bl_pool_create.restype = ctypes.c_void_p
    lib.bl_pool_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int]
    lib.bl_pool_num_batches.restype = ctypes.c_int64
    lib.bl_pool_num_batches.argtypes = [ctypes.c_void_p]
    lib.bl_pool_get.restype = ctypes.c_int64
    lib.bl_pool_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float)]
    lib.bl_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.bl_pool_error.restype = ctypes.c_char_p
    lib.bl_pool_error.argtypes = [ctypes.c_void_p]
    lib.bl_sample_one.restype = ctypes.c_int
    lib.bl_sample_one.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float)]
    try:
        lib.bl_pack.restype = ctypes.c_int
        lib.bl_pack.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib._has_pack = True
    except AttributeError:   # stale .so predating bl_pack
        lib._has_pack = False
    _lib = lib
    return lib


def is_available() -> bool:
    return _load() is not None


def pack_available() -> bool:
    lib = _load()
    return lib is not None and getattr(lib, "_has_pack", False)


def pack(points: np.ndarray, labels: Optional[np.ndarray],
         out: np.ndarray, n_threads: int = 0) -> int:
    """One-pass C encoder for the packed H2D wire buffer.

    points: C-contiguous (count, 9) float32; labels: C-contiguous (count,)
    int64 or None; out: (count, 10) uint8, written in place. Returns the
    bl_pack status: 0 ok, 1 finite-coordinate f16 overflow, 2 label outside
    u8 — `parallel.steps.pack_batch` maps 1/2 onto the same ValueErrors the
    numpy path raises. Byte-identical to the numpy path
    (tests/test_native_loader.py::TestNativePack)."""
    lib = _load()
    assert lib is not None and lib._has_pack, "native pack not built"
    lbl_ptr = labels.ctypes.data_as(ctypes.c_void_p) if labels is not None \
        else None
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    return lib.bl_pack(
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), lbl_ptr,
        points.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)


def sample_one(path: str, classes: Sequence[int], num_point: int,
               label_mode: int = LABEL_LEARNING_ORDER, coverage: bool = False,
               target_class: int = 0, augment: bool = False,
               aug_config: Optional[dict] = None, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single-block sampling through the native code (mirrors
    data/sampler.py::sample_pointcloud semantics)."""
    lib = _load()
    assert lib is not None, "native loader not built"
    aug = aug_config or {}
    classes_arr = np.asarray(list(classes), dtype=np.int64)
    pts = np.empty((num_point, 9), np.float32)
    lbl = np.empty((num_point,), np.int64)
    seg = np.empty((num_point,), np.float32)
    rc = lib.bl_sample_one(
        path.encode(), classes_arr.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)), len(classes_arr),
        num_point, label_mode, int(coverage), target_class, int(augment),
        float(aug.get("scale", 0)), int(aug.get("rot", 0)),
        float(aug.get("mirror_prob", 0)), int(aug.get("jitter", 0)),
        seed, pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lbl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    assert rc == 0, f"bl_sample_one failed for {path}"
    return pts, lbl, seg


class NativeBatchPool:
    """Threaded native batch producer over a list of block files."""

    def __init__(self, data_path: str, block_names: Sequence[str],
                 classes: Sequence[int], num_point: int, batch_size: int,
                 label_mode: int = LABEL_LEARNING_ORDER,
                 augment: bool = False, aug_config: Optional[dict] = None,
                 seed: int = 0, shuffle: bool = False, n_threads: int = 4):
        lib = _load()
        assert lib is not None, "native loader not built"
        self._lib = lib
        self.batch_size = batch_size
        self.num_point = num_point
        paths = [os.path.join(data_path, "data", f"{n}.npy")
                 for n in block_names]
        blob = b"\0".join(p.encode() for p in paths) + b"\0"
        classes_arr = np.asarray(list(classes), dtype=np.int64)
        aug = aug_config or {}
        self._pool = lib.bl_pool_create(
            blob, len(paths),
            classes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(classes_arr), num_point, batch_size, label_mode, 0, 0,
            int(augment), float(aug.get("scale", 0)), int(aug.get("rot", 0)),
            float(aug.get("mirror_prob", 0)), int(aug.get("jitter", 0)),
            seed, int(shuffle), n_threads)
        self.n_batches = lib.bl_pool_num_batches(self._pool)

    def __len__(self):
        return self.n_batches

    def __iter__(self) -> Iterator:
        # single-pass: batches are destructively consumed in C++ (the pool
        # frees each after hand-off), so a second iteration would block
        # forever on batch 0's condition variable — fail loudly instead
        # (pipelines rebuild the pool per epoch; see gfs.py::train_batches)
        if getattr(self, "_consumed", False):
            raise RuntimeError(
                "NativeBatchPool is single-pass; construct a new pool per "
                "epoch")
        self._consumed = True
        b, n = self.batch_size, self.num_point
        for i in range(self.n_batches):
            pts = np.empty((b, n, 9), np.float32)
            lbl = np.empty((b, n), np.int64)
            seg = np.empty((b, n), np.float32)
            with span("pool.get"):          # the wait on the pool's queue
                valid = self._lib.bl_pool_get(
                    self._pool, i,
                    pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    lbl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    seg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if valid == -2:
                # fail loudly like the Python path (np.load raises) rather
                # than serving zero-filled stand-in rows as training data
                bad = self._lib.bl_pool_error(self._pool).decode()
                raise RuntimeError(
                    f"native loader: unreadable or corrupt block file {bad}")
            yield pts, lbl, seg, int(valid)

    def close(self):
        if self._pool:
            self._lib.bl_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
