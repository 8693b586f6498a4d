"""Data parallelism over `torch.distributed` (counterpart of the JAX
package's parallel/mesh.py, its 1-D `data` mesh).

One process a rank. Each holds B/R contiguous rows of the global batch
(`shard_batch`, as `P("data")` cuts them) and a replica of the weights
(`replicate`). The single-process semantics on the global batch are kept
by a few explicit reductions where JAX's GSPMD inserts them: the
gradient all-reduce (`allreduce_grads`), the train-mode BatchNorm
statistics (models/layers.py, ops/fused_edgeconv_train.py), the fake
prototypes' class sums and the loss denominators (models/capl.py,
models/layers.py::cross_entropy), and the confusion counts of an
evaluation sweep (pipelines/). Everything else is per block.

`mesh=None` everywhere means one process, the path taken without a mesh.

NCCL is the backend on the GPU, gloo on the CPU. Two ranks can share one
card only through gloo, and only when the caller names it
(`make_mesh(backend="gloo", device="cuda:0")`): NCCL refuses a duplicate
GPU. On gloo with CUDA tensors only `all_reduce` and `broadcast` are used,
the two collectives gloo implements for them.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Iterable, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A data-parallel group: this process's rank among `size`, and the
    device its tensors live on."""
    group: object            # torch.distributed.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str

    def __deepcopy__(self, memo):
        return self          # a module copied on a rank stays on its group

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __str__(self) -> str:
        return (f"data mesh of {self.size} rank(s) over {self.backend}, "
                f"rank {self.rank} on {self.device}")


def is_main(mesh: Optional[Mesh]) -> bool:
    """Whether this process logs, writes metrics and saves: rank 0, or the
    only process."""
    return mesh is None or mesh.is_main


def _env_int(name: str, value: Optional[int]) -> int:
    if value is not None:
        return value
    if name not in os.environ:
        raise RuntimeError(f"make_mesh: {name} is not set (launch with "
                           "torchrun, or pass rank and world_size)")
    return int(os.environ[name])


def make_mesh(backend: Optional[str] = None, device=None, *,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """Join (or take) the default process group and return its Mesh.

    Rank and world size come from `RANK` / `WORLD_SIZE` (what torchrun
    sets) unless given; the rendezvous is `init_method`, else torchrun's
    store (`env://`). `device` defaults to CUDA where there is a GPU, else
    the CPU; `backend=None` means `nccl` for a CUDA device and `gloo` for
    the CPU. Under NCCL each rank takes `cuda:LOCAL_RANK`, and more ranks
    on a host than it has cards raise. gloo on CUDA tensors is taken only
    when named."""
    rank = _env_int("RANK", rank)
    size = _env_int("WORLD_SIZE", world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend {backend!r} (nccl or gloo)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: device {device} requested but CUDA "
                           "is not available")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("make_mesh: NCCL needs a CUDA device; the CPU "
                             "takes gloo")
        cards = torch.cuda.device_count()
        if local_size > cards or local_rank >= cards:
            raise RuntimeError(
                f"make_mesh: NCCL takes one card a rank, and this host runs "
                f"{local_size} ranks on {cards} card(s); NCCL refuses two "
                "ranks on one card (name backend='gloo' to share it)")
        if device.index is not None and device.index != local_rank:
            raise ValueError(f"make_mesh: under NCCL rank {rank} takes "
                             f"cuda:{local_rank}, not {device}")
        device = torch.device("cuda", local_rank)
    elif device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=size)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh: the process group runs "
                           f"{dist.get_backend()}, not {backend}")
    if (dist.get_rank(), dist.get_world_size()) != (rank, size):
        raise RuntimeError("make_mesh: the process group's rank or size is "
                           "not this process's")
    return Mesh(dist.group.WORLD, rank, size, device, backend)


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> None:
    """SUM all-reduce of `t` in place over the mesh, counted."""
    dist.all_reduce(t, group=mesh.group)
    _all_reduce.calls += 1
    _all_reduce.bytes += t.numel() * t.element_size()


_all_reduce.calls = _all_reduce.bytes = 0


def collectives():
    """(calls, bytes) of every all-reduce this process has issued so far
    (read before and after a step for its share)."""
    return _all_reduce.calls, _all_reduce.bytes


def close_mesh(mesh: Optional[Mesh]) -> None:
    """Leave the process group (a no-op without a mesh)."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def main_first(mesh: Optional[Mesh]):
    """Rank 0 runs the block before the other ranks do: for set-up that
    writes files every rank then reads (a dataset's class registry, its
    materialised support sets), so that no rank reads one half written.
    The ranks meet in one all-reduce, which rank 0 enters after the block
    and the others before it."""
    wait = mesh is not None and mesh.size > 1
    if wait and not mesh.is_main:
        _all_reduce(torch.zeros(1, device=mesh.device), mesh)
    yield
    if wait and mesh.is_main:
        _all_reduce(torch.zeros(1, device=mesh.device), mesh)


def local_rows(total: int, mesh: Optional[Mesh]) -> slice:
    """This rank's contiguous rows of a global batch of `total` rows, which
    must divide by the mesh size (JAX pipelines/gfs.py:227)."""
    if mesh is None:
        return slice(0, total)
    if total % mesh.size:
        raise ValueError(f"global batch {total} does not divide over "
                         f"{mesh.size} ranks")
    b = total // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(x, mesh: Optional[Mesh]):
    """This rank's rows of `x` (a tensor or an array with the batch first),
    as `P("data")` cuts them."""
    return x[local_rows(x.shape[0], mesh)]


def local_valid(valid: int, total: int, mesh: Optional[Mesh]) -> int:
    """How many of this rank's rows lie before `valid` (the real rows of a
    padded global batch of `total`)."""
    rows = local_rows(total, mesh)
    return min(max(valid - rows.start, 0), rows.stop - rows.start)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Optional[Mesh]
              ) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (after a warm start or
    a resume, so that every replica starts from the same weights)."""
    if mesh is not None and mesh.size > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=mesh.group)
    return module


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of `t` over the ranks, as a new tensor; no gradient."""
    if mesh is None:
        return t
    out = t.detach().clone()
    _all_reduce(out, mesh)
    return out


class AllReduceSum(torch.autograd.Function):
    """y = sum over the ranks of x, on every rank. Each rank's loss share
    depends on y, so the gradient of x is the sum over the ranks of the
    gradient of y: the backward all-reduces it too."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.clone()
        _all_reduce(out, mesh)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _all_reduce(grad, ctx.mesh)
        return grad, None


def reduce_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """`AllReduceSum` where there is a mesh, `t` itself where there is
    none."""
    return t if mesh is None else AllReduceSum.apply(t, mesh)


@torch.no_grad()
def allreduce_grads(params: Iterable[torch.nn.Parameter],
                    mesh: Optional[Mesh]) -> None:
    """Sum every gradient over the ranks in one flattened all-reduce. A
    parameter without a gradient keeps none (the graph is the same on
    every rank, so it has none on any)."""
    if mesh is None or mesh.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat, mesh)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
