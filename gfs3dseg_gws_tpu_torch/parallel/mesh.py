"""Data and sequence parallelism over `torch.distributed` (counterpart of
the JAX package's parallel/mesh.py: its 1-D `data` mesh, `make_mesh`, and
its 2-D `data x points` mesh, `make_mesh_dxp`).

One process a rank. On the `data` mesh each holds B/R contiguous rows of
the global batch (`shard_batch`, as `P("data")` cuts them) and a replica
of the weights (`replicate`). The single-process semantics on the global
batch are kept by a few explicit reductions where JAX's GSPMD inserts
them: the gradient all-reduce (`allreduce_grads`), the train-mode
BatchNorm statistics (models/layers.py, ops/fused_edgeconv_train.py), the
fake prototypes' class sums and the loss denominators (models/capl.py,
models/layers.py::cross_entropy), and the confusion counts of an
evaluation sweep (pipelines/). Everything else is per block.

The `data x points` mesh (`make_mesh_dxp(S)`, the evaluation sweeps
only) lays the R ranks out as JAX's `reshape(R // S, S)`: rank r sits at
data index r // S and points index r % S. Each holds B/D rows of a batch
(D = R / S) and N/S points of each (`shard_points`, as `P("data",
"points")` cuts them): sequence parallelism over the points of a block.
What needs a block's every point is written out where XLA inserts it in
JAX: the kNN and attention keys are all-gathered over the points group
(`all_gather_points`), the prototype refinement's softmax over points and
the coding's per-block background sums are reduced over it
(`all_reduce_points`), and the sweeps' sums go over the world as on the
`data` mesh. `points_split(model, mesh)` turns the split on for a sweep.
S = 1 is the `data` mesh itself. `rank` and `size` are always the world's
(the group the sums run over); `data_index` / `data_size` and
`points_index` / `sp` are the mesh's coordinates.

`mesh=None` everywhere means one process, the path taken without a mesh.

NCCL is the backend on the GPU, gloo on the CPU. Two ranks can share one
card only through gloo, and only when the caller names it
(`make_mesh(backend="gloo", device="cuda:0")`): NCCL refuses a duplicate
GPU. On gloo with CUDA tensors only `all_reduce` and `broadcast` are used,
the two collectives gloo implements for them (the points all-gather
included).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass
from typing import Iterable, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A group of ranks: this process's rank among `size` (the world, whose
    group carries the sums) and the device its tensors live on; on a
    `data x points` mesh also `sp` ranks along `points` and this rank's
    points group (None at sp = 1). `kind` names the mesh the run asked for
    ("data" or "dxp"), for its log."""
    group: object            # torch.distributed.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str
    sp: int = 1
    points_group: object = None
    kind: str = "data"

    def __deepcopy__(self, memo):
        return self          # a module copied on a rank stays on its group

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_index(self) -> int:
        return self.rank // self.sp

    @property
    def data_size(self) -> int:
        return self.size // self.sp

    @property
    def points_index(self) -> int:
        return self.rank % self.sp

    def data_mesh(self) -> "Mesh":
        """The 1-D `data` mesh over the same ranks (training takes it under
        `--mesh dxp`, as JAX's train_gfs ignores the mesh shape)."""
        return dataclasses.replace(self, sp=1, points_group=None,
                                   kind="data")

    def __str__(self) -> str:
        where = (f"{self.size} rank(s) over {self.backend}, rank {self.rank} "
                 f"on {self.device}")
        if self.kind == "dxp":
            return (f"data x points mesh {{'data': {self.data_size}, "
                    f"'points': {self.sp}}} of {where}")
        return f"data mesh of {where}"


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


def make_mesh_dxp(sp: int = 2, backend: Optional[str] = None, device=None,
                  *, init_method: Optional[str] = None,
                  rank: Optional[int] = None,
                  world_size: Optional[int] = None) -> Mesh:
    """The 2-D `data x points` mesh over every rank (JAX: make_mesh_dxp):
    `sp` ranks along `points`, rank r at data index r // sp and points
    index r % sp. Joins the world as `make_mesh` does (same arguments),
    after checking that its size divides by `sp` (ValueError, before any
    rendezvous), then creates every points group, on every rank in the
    same order. sp = 1 is the `data` mesh (no points group)."""
    size = _env_int("WORLD_SIZE", world_size)
    if sp < 1 or size % sp:
        raise ValueError(f"make_mesh_dxp: world size {size} not divisible "
                         f"by mesh_sp={sp}")
    mesh = make_mesh(backend, device, init_method=init_method, rank=rank,
                     world_size=size)
    group = None
    if sp > 1:
        for d in range(size // sp):
            g = dist.new_group(list(range(d * sp, (d + 1) * sp)))
            if d == mesh.rank // sp:
                group = g
    return dataclasses.replace(mesh, sp=sp, points_group=group, kind="dxp")


def _all_reduce(t: torch.Tensor, mesh: Mesh, group=None) -> None:
    """SUM all-reduce of `t` in place over the mesh (or `group`), counted."""
    dist.all_reduce(t, group=mesh.group if group is None else group)
    _all_reduce.calls += 1
    _all_reduce.bytes += t.numel() * t.element_size()


_all_reduce.calls = _all_reduce.bytes = 0


def collectives():
    """(calls, bytes) of every collective this process has issued so far,
    all-reduces and points all-gathers (read before and after a step for
    its share)."""
    return (_all_reduce.calls + all_gather_points.calls,
            _all_reduce.bytes + all_gather_points.bytes)


def gathers():
    """(calls, bytes gathered) of the points all-gathers alone."""
    return all_gather_points.calls, all_gather_points.bytes


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
    must divide by the mesh's data size (JAX pipelines/gfs.py:227)."""
    if mesh is None:
        return slice(0, total)
    if total % mesh.data_size:
        raise ValueError(f"global batch {total} does not divide over "
                         f"{mesh.data_size} ranks along data")
    b = total // mesh.data_size
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def shard_batch(x, mesh: Optional[Mesh]):
    """This rank's rows of `x` (a tensor or an array with the batch first),
    as `P("data")` cuts them."""
    return x[local_rows(x.shape[0], mesh)]


def shard_points(x, mesh: Optional[Mesh]):
    """This rank's contiguous points (dim 1) of `x` (B, N, ...), as the
    `points` axis of `P("data", "points")` cuts them; N must divide by the
    points axis. Every point without a mesh or at sp = 1."""
    if mesh is None or mesh.sp == 1:
        return x
    n = x.shape[1]
    if n % mesh.sp:
        raise ValueError(f"{n} points a block do not divide over "
                         f"mesh_sp={mesh.sp} ranks along points")
    m = n // mesh.sp
    return x[:, mesh.points_index * m:(mesh.points_index + 1) * m]


@torch.no_grad()
def all_gather_points(t: torch.Tensor, mesh: Optional[Mesh]
                      ) -> torch.Tensor:
    """A block's every point from its ranks along `points`: t (B, N/S,
    ...) -> (B, N, ...), the points in rank order (`torch.cat` of the
    ranks' t over dim 1, exactly). Every backend gathers into one (S, B,
    N/S, ...) buffer, then moves the points axis into place: NCCL by
    `all_gather_into_tensor`; gloo on the CPU by `all_gather` into the
    buffer's S slices; gloo on CUDA tensors, which it takes only in
    `all_reduce` and `broadcast`, by one SUM all-reduce of the zeroed
    buffer into which each rank writes its slice (exact: x + 0 = x).
    Counted in `collectives()` and `gathers()`; t itself without a mesh or
    at sp = 1. No gradient (the evaluation sweeps)."""
    if mesh is None or mesh.sp == 1:
        return t
    t = t.contiguous()
    s = mesh.sp
    if mesh.backend == "nccl":
        out = t.new_empty((s,) + t.shape)
        dist.all_gather_into_tensor(out, t, group=mesh.points_group)
    elif t.device.type == "cpu":
        out = t.new_empty((s,) + t.shape)
        dist.all_gather(list(out.unbind(0)), t, group=mesh.points_group)
    else:
        out = t.new_zeros((s,) + t.shape)
        out[mesh.points_index] = t
        dist.all_reduce(out, group=mesh.points_group)
    out = out.transpose(0, 1).reshape(
        (t.shape[0], s * t.shape[1]) + t.shape[2:])
    all_gather_points.calls += 1
    all_gather_points.bytes += out.numel() * out.element_size()
    return out


all_gather_points.calls = all_gather_points.bytes = 0


def all_reduce_points(t: torch.Tensor, mesh: Optional[Mesh]
                      ) -> torch.Tensor:
    """The sum of `t` over this rank's points group, as a new tensor (a
    block's sums over its points); t itself without a mesh or at sp = 1.
    No gradient."""
    if mesh is None or mesh.sp == 1:
        return t
    out = t.detach().clone()
    _all_reduce(out, mesh, mesh.points_group)
    return out


@contextlib.contextmanager
def points_split(model: torch.nn.Module, mesh: Optional[Mesh]):
    """The model's forward takes this rank's points of each block (the
    evaluation sweeps on a `data x points` mesh): sets `points_mesh` on
    every submodule that has one (the EdgeConv blocks, the self-attention,
    GWCAPL) and on `model`, where parallel/steps.py::coding_step reads it,
    and clears it after. A no-op without a mesh or at sp = 1. Only eval
    passes honour it; training takes the data mesh."""
    if mesh is None or mesh.sp == 1:
        yield model
        return
    mods = [m for m in model.modules() if hasattr(m, "points_mesh")]
    for m in mods:
        m.points_mesh = mesh
    model.points_mesh = mesh
    try:
        yield model
    finally:
        for m in mods:
            m.points_mesh = None
        model.points_mesh = None


def local_valid(valid: int, total: int, mesh: Optional[Mesh]) -> int:
    """How many of this rank's rows lie before `valid` (the real rows of a
    padded global batch of `total`; rows are cut along `data`)."""
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
