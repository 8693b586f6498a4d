"""Build and load the hand-written CUDA kernels (csrc/*.cu).

`nvcc` compiles every source in `gfs3dseg_gws_tpu_torch/csrc/` for sm_90a,
one process per source, all started together, and links the objects into
one shared library with a plain C interface, which is loaded with ctypes.
The build runs on first use (the first CUDA tensor that reaches a kernel
wrapper), never at import, and lands in `build/torch_kernels/` at the root
of the checkout, named by a hash of the sources and flags so that an edited
source never meets a stale library.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points in csrc/*.cu
_SIGNATURES = {
    # x, a_table, b_table, w2, bias2, idx (scratch), kNN scratch, out,
    # batch, n, nq, q_offset, c, w0, w1, k, neg_slope, stream
    "gfs_fused_edgeconv_infer": (_P,) * 8 + (_I,) * 8 + (_F, _P),
    # q, k, v, out, batch, nq, nk, d, inv_temperature, stream
    "gfs_fused_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # x, btab, idx, cnt, scb, scratch, batch, n, c, cb, k, stream
    "gfs_knn_with_stats": (_P,) * 6 + (_I,) * 5 + (_P,),
    # x, idx, scratch, batch, n, nq, q_offset, c, k, stream
    "gfs_knn_indices": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, idx, scratch, batch, n, c, k, folds, stream
    "gfs_knn_fold": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # batch, n, nq, c, k, folds (0: the K1/K3/K6 route), bytes out
    "gfs_knn_scratch_bytes": (_I, _I, _I, _I, _I, _I,
                              ctypes.POINTER(ctypes.c_longlong)),
    # no arguments: the streaming kNN selection's longest k
    "gfs_knn_stream_cap": (),
    # idx, g, dx, batch, n, k, c, stream
    "gfs_edgeconv_scatter": (_P, _P, _P, _I, _I, _I, _I, _P),
    # idx, a_table, b_table, w2, bias2, out, batch, n, w0, w1, k,
    # neg_slope, stream
    "gfs_gather_conv": (_P,) * 6 + (_I,) * 5 + (_F, _P),
    # a, b, idx, s1, t1, w2, snbr, zmax, zmin, kmax, kmin, part, batch, n,
    # c, w1, k, neg_slope, stream
    "gfs_edgeconv_train_fwd": (_P,) * 12 + (_I,) * 5 + (_F, _P),
    # a, b, idx, p1, w2, gsel, ksel, pk, scat, psum, part, batch, n, c, w1,
    # k, neg_slope, stream
    "gfs_edgeconv_train_bwd": (_P,) * 11 + (_I,) * 5 + (_F, _P),
    # q, k, v, seed, out, m, den, batch, n, d, inv_temperature, thr,
    # keep_scale, stream
    "gfs_attention_train_fwd": (_P,) * 7 + (_I, _I, _I, _F, _I, _F, _I, _P),
    # q, k, v, seed, m, den, delta, dy, dq, dk, dv, batch, n, d,
    # inv_temperature, thr, keep_scale, stream
    "gfs_attention_train_bwd": (_P,) * 11 + (_I, _I, _I, _F, _I, _F, _I,
                                             _P),
}


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgfs3dseg_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a private directory, then rename: a concurrent build never
    # sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src),
                   "-o", obj]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compiler before reporting any failure
        outputs = [proc.communicate()[0] for _, proc in procs]
        for (cmd, proc), output in zip(procs, outputs):
            _check_nvcc(cmd, output, proc.returncode)
        lib = os.path.join(tmp, so.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _check_nvcc(cmd, res.stdout + res.stderr, res.returncode)
        os.replace(lib, so)
    return so


def _check_nvcc(cmd, output: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{output}")


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.gfs_error_string.argtypes = [ctypes.c_int]
    lib.gfs_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().gfs_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({code})")


def check_tensors(name: str, **tensors) -> None:
    """Raise unless every tensor is contiguous fp32 on one CUDA device."""
    devices = set()
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs span devices {sorted(map(str, devices))}")


def current_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def knn_scratch(name: str, x: torch.Tensor, k: int, folds: int = 0,
                nq: Optional[int] = None):
    """The scratch the kNN selection needs for nq queries (default: every
    row) against x (B, N, C) and k on x's device (folds 0: K1, K3 and K6;
    2, 4 or 8: K8), or None: only K8's fold-merge tournament on a key row
    too long for shared memory (k > 256, N past ~27,000) takes one,
    (B, nq, 2, k) 64-bit keys."""
    b, n, c = x.shape
    nbytes = ctypes.c_longlong(0)
    with torch.cuda.device(x.device):
        check(library().gfs_knn_scratch_bytes(b, n, n if nq is None else nq,
                                               c, k, folds,
                                               ctypes.byref(nbytes)), name)
    if nbytes.value == 0:
        return None
    return torch.empty(nbytes.value, device=x.device, dtype=torch.uint8)


def knn_stream_cap() -> int:
    """The longest k that K8's streaming selection runs (kCap in
    csrc/knn_fold.cu; K1, K3 and K6 take it past k = 64): past it, the
    fold-merge tournament."""
    return library().gfs_knn_stream_cap()


def ptr(t) -> int:
    """t's device address, or 0 (a null pointer) for None."""
    return 0 if t is None else t.data_ptr()
