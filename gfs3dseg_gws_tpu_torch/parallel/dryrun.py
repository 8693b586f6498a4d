"""Data parallelism over several processes, in one call (counterpart of
the JAX package's `__graft_entry__.py::dryrun_multichip`).

`run_ranks(fn, n, ...)` spawns n ranks (the `spawn` start method: a
parent such as chip_smoke.py has CUDA initialised, so `fork` is wrong)
that meet through a file under a fresh directory, calls `fn(mesh, *args)`
on each and returns every rank's result. A rank that raises fails the
call; `sp` > 1 gives the ranks a `data x points` mesh. `dryrun_multichip`
runs GFS train steps and the coding step of the base-class codings over
such a mesh (`gfs_ranks` on each rank) and returns their numbers, so that
a caller can hold them to one process on the global batch; for an even
number of ranks from 4 it also runs JAX's step 2, an evaluation pass on a
2-way `data x points` mesh (`dxp_evaluate`).
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def _rank(rank: int, fn: Callable, n_ranks: int, device: str,
          backend: Optional[str], workdir: str, threads: Optional[int],
          args: Sequence, sp: int) -> None:
    from gfs3dseg_gws_tpu_torch.parallel.mesh import (close_mesh, make_mesh,
                                                      make_mesh_dxp)

    if threads is not None:
        torch.set_num_threads(threads)
    join = dict(init_method="file://" + os.path.join(workdir, "rdv"),
                rank=rank, world_size=n_ranks)
    mesh = (make_mesh(backend, device, **join) if sp == 1
            else make_mesh_dxp(sp, backend, device, **join))
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        close_mesh(mesh)


def run_ranks(fn: Callable, n_ranks: int, device: str = "cpu",
              backend: Optional[str] = None, args: Sequence = (),
              threads: Optional[int] = None, sp: int = 1) -> List:
    """fn(mesh, *args) on `n_ranks` spawned processes, each on `device`
    (parallel/mesh.py::make_mesh: `backend` None is NCCL on CUDA, gloo on
    the CPU; two ranks on one card need backend="gloo"), on the data mesh,
    or with `sp` > 1 on the `data x points` mesh of `sp` ranks along points
    (make_mesh_dxp). `fn` and `args` must pickle (a module-level function,
    CPU tensors); each child sets `threads` intra-op threads where given.
    Returns the ranks' results in rank order; a rank that fails raises
    here."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from gfs3dseg_gws_tpu_torch.ops import _ext

        _ext.build()        # once, before the ranks could race on it
    with tempfile.TemporaryDirectory(prefix="gfs_ranks_") as workdir:
        mp.start_processes(_rank, args=(fn, n_ranks, device, backend,
                                        workdir, threads, tuple(args), sp),
                           nprocs=n_ranks, join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]


def gfs_ranks(mesh, model_kwargs: Dict, state: Dict, points, labels, gp,
              steps: int, seed: int) -> Dict:
    """One rank of `dryrun_multichip`: `steps` GFS train steps of the
    GWCAPL `model_kwargs` from `state` on this rank's rows of the global
    batch, then the coding step over them, its sums all-reduced.

    Returns per step the loss and accuracy (the global batch's), the wall
    seconds (host clock, waited for), the collectives issued and their
    bytes; the launches of the training kernels over the steps (K3, K4a,
    K4b, K5a, K5b: their op spans' calls); rank 0 also returns each step's state before it, the
    summed gradients and the state after the last step."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.models.layers import use_mesh
    from gfs3dseg_gws_tpu_torch.parallel import mesh as pmesh
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import (coding_step,
                                                       gfs_train_step)
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import step_seed
    from gfs3dseg_gws_tpu_torch.utils import observability

    dev = mesh.device
    model = GWCAPL(device=dev, **model_kwargs)
    model.load_state_dict(state)
    pmesh.replicate(use_mesh(model, mesh), mesh)
    opt, sched = make_gfs_optimizer(model, 0.01, 10, 50, 0.5)
    x = pmesh.shard_batch(points, mesh).to(dev)
    y = pmesh.shard_batch(labels, mesh).to(dev)
    gp = gp.to(dev)
    gen = torch.Generator(device=dev)
    out = {"loss": [], "accuracy": [], "seconds": [], "collectives": [],
           "collective_bytes": [], "states": [], "grads": []}
    kernels = ("k3", "k4a", "k4b", "k5a", "k5b")
    launched = {k: observability.calls("op." + k) for k in kernels}
    for step in range(steps):
        if mesh.is_main:
            out["states"].append({k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()})
        gen.manual_seed(step_seed(seed, step))
        calls, nbytes = pmesh.collectives()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, acc = gfs_train_step(model, opt, x, y, gp, gen, sched)
        loss, acc = loss.item(), acc.item()
        out["seconds"].append(time.perf_counter() - t0)
        now = pmesh.collectives()
        out["collectives"].append(now[0] - calls)
        out["collective_bytes"].append(now[1] - nbytes)
        out["loss"].append(loss)
        out["accuracy"].append(acc)
        if mesh.is_main:
            out["grads"].append({n: p.grad.detach().cpu().clone()
                                 for n, p in model.named_parameters()})
    out["launches"] = {k: observability.calls("op." + k) - launched[k]
                       for k in kernels}
    if mesh.is_main:
        out["final_state"] = {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()}
    n_base = model.base_num
    sums = coding_step(model, x, y, gp, n_base)
    out["coding"] = [pmesh.all_reduce_sum(s.double(), mesh).cpu()
                     for s in sums]
    return out


# ranks along points in `dryrun_multichip`'s dxp pass (JAX step 2:
# `make_mesh_dxp(2)`)
DXP_SP = 2


def dxp_eval_ranks(mesh, model_kwargs: Dict, state: Dict, points, gp,
                   gened, base_coding, novel_coding) -> torch.Tensor:
    """One rank of `dxp_evaluate`: the GWCAPL eval pass (`evaluate`, one
    prototype set) on this rank's rows and points of the global batch,
    under the points split. Returns its argmax (B / D, N / S) on the
    host."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.parallel import mesh as pmesh

    dev = mesh.device
    model = GWCAPL(device=dev, **model_kwargs)
    model.load_state_dict(state)
    pmesh.replicate(model, mesh)
    x = pmesh.shard_points(pmesh.shard_batch(points, mesh), mesh).to(dev)
    with torch.inference_mode(), pmesh.points_split(model, mesh):
        logits, _, _ = model.evaluate(x, gp.to(dev), gened.to(dev),
                                      base_coding.to(dev),
                                      novel_coding.to(dev))
    return torch.argmax(logits, dim=-1).cpu()


def dxp_evaluate(n_ranks: int, device: str, backend: Optional[str],
                 model_kwargs: Dict, state: Dict, points, gp, seed: int = 0,
                 threads: Optional[int] = None) -> torch.Tensor:
    """JAX `__graft_entry__.py::dryrun_multichip` step 2: an evaluation pass
    of the GWCAPL (`state`) on a `data x points` mesh of `n_ranks` ranks,
    `DXP_SP` along points (`make_mesh_dxp(2)`); the registered prototypes
    standard normal from numpy with `seed`, the codings all ones, as
    there. Returns the predictions put back together in rank order,
    (B, N)."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL

    shape = GWCAPL(**model_kwargs)
    r = np.random.default_rng(seed)
    gened = torch.from_numpy(r.standard_normal(
        (shape.classes, shape.main_proto.shape[1])).astype(np.float32))
    base = torch.ones((shape.base_num, shape.num_gw))
    novel = torch.ones((shape.classes - shape.base_num, shape.num_gw))
    preds = run_ranks(dxp_eval_ranks, n_ranks, device, backend,
                      (model_kwargs, state, points, gp, gened, base, novel),
                      threads, DXP_SP)
    rows = [torch.cat(preds[d * DXP_SP:(d + 1) * DXP_SP], dim=1)
            for d in range(n_ranks // DXP_SP)]
    return torch.cat(rows, dim=0)


def dryrun_multichip(n_ranks: int, device: str = "cpu",
                     backend: Optional[str] = None, *, steps: int = 1,
                     batch: Optional[int] = None, npts: int = 64,
                     seed: int = 0, threads: Optional[int] = None,
                     rank_fn: Callable = gfs_ranks, **model_kwargs) -> Dict:
    """GFS train steps and the coding step on a data mesh of `n_ranks`
    spawned ranks (JAX: `__graft_entry__.py::dryrun_multichip`).

    The GWCAPL (`model_kwargs`: its constructor's widths, k, num_gw,
    attn_dropout; the defaults are the model's) starts from the JAX
    initialisers drawn with `seed`; the global batch (`batch`, default
    2 n_ranks, of `npts` points; labels in 0..base_num) and the basis come
    from numpy with `seed`. Each rank runs `rank_fn`: `gfs_ranks`, or a
    module-level function that calls it and adds to its result (as a check
    that records kernel outputs does). Returns rank 0's result plus
    "inputs" (points, labels, gp), "init" (the starting state) and "ranks"
    (every rank's result, rank order); for an even `n_ranks` >= 4 also
    "dxp_pred", the (B, N) predictions of `dxp_evaluate` on a 2-way
    `data x points` mesh from the starting state (the batch must divide
    by n_ranks / 2 and npts by 2)."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL

    model = GWCAPL(**model_kwargs)
    model.train_init(torch.Generator().manual_seed(seed))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    feat = sum(w[-1] for w in model_kwargs.get("edgeconv_widths",
                                               ((64, 64),) * 3))
    r = np.random.default_rng(seed)
    batch = batch or 2 * n_ranks
    inputs = tuple(torch.from_numpy(a) for a in (
        r.standard_normal((batch, npts, 9)).astype(np.float32),
        r.integers(0, model.base_num + 1, (batch, npts)).astype(np.int64),
        r.standard_normal((model.num_gw, feat)).astype(np.float32)))
    ranks = run_ranks(rank_fn, n_ranks, device, backend,
                      (model_kwargs, state) + inputs + (steps, seed),
                      threads)
    for key in ("loss", "coding"):
        for other in ranks[1:]:      # every rank reports the global numbers
            if not all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                       for a, b in zip(ranks[0][key], other[key])):
                raise AssertionError(f"ranks disagree on {key}")
    out = dict(ranks[0], inputs=inputs, init=state, ranks=ranks)
    if n_ranks % DXP_SP == 0 and n_ranks >= 2 * DXP_SP:
        pred = dxp_evaluate(n_ranks, device, backend, model_kwargs, state,
                            inputs[0], inputs[2], seed + 2, threads)
        if pred.shape != (batch, npts):
            raise AssertionError(f"dxp evaluation gave {tuple(pred.shape)}, "
                                 f"not {(batch, npts)}")
        out["dxp_pred"] = pred
    return out
