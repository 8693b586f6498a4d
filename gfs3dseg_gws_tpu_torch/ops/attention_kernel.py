"""K2: fused single-head attention for inference.

`fused_attention` replaces the JAX package's TPU kernel
ops/attention_kernel.py::fused_attention with the hand-written CUDA kernel in
csrc/attention.cu (online softmax; the (B, N, N) weights never reach device
memory). `attention_plain` is the same function in plain PyTorch
(counterpart of `_attention_xla`); the wrapper takes it for a tensor on the
CPU, and the tests and chip_smoke.py hold the kernel against it.
"""
from __future__ import annotations

import torch

from gfs3dseg_gws_tpu_torch.ops import _ext


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    attn = torch.einsum("bmc,bnc->bmn", q / temperature, k)
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bmn,bnc->bmc", attn, v)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """softmax(q kᵀ / temperature) v for q, k, v (B, N, D); on CUDA D <= 64
    and a multiple of 4.

    Returns (B, N, D) float32. A CPU tensor goes to `attention_plain`; a CUDA
    tensor to the kernel, which raises on shapes or dtypes it does not take.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, temperature)
    name = "fused_attention"
    _ext.check_tensors(name, q=q, k=k, v=v)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must all be (B, N, D)")
    b, n, d = q.shape
    if d > 64 or d % 4:
        raise ValueError(f"{name}: the kernel takes D <= 64 and a multiple "
                         f"of 4, got {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _ext.library()
    with torch.cuda.device(q.device):
        code = lib.gfs_fused_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, d,
            1.0 / temperature, _ext.current_stream(q.device))
    _ext.check(code, name)
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
