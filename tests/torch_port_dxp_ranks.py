"""Rank functions of tests/test_torch_port_dxp.py, run by
`gfs3dseg_gws_tpu_torch.parallel.dryrun.run_ranks` on spawned gloo ranks of a
`data x points` mesh. This module imports no JAX, so that a spawned rank
starts light.
"""
import sys

import numpy as np
import torch

from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
from gfs3dseg_gws_tpu_torch.parallel import mesh as pmesh
from gfs3dseg_gws_tpu_torch.parallel.steps import coding_step

_ABSENT = object()


def _local(t, mesh):
    """This rank's rows and points of a (B, N, ...) tensor."""
    return pmesh.shard_points(pmesh.shard_batch(t, mesh), mesh)


def gather(mesh, seed):
    """all_gather_points and all_reduce_points on tensors every rank draws
    alike: (D, 3, N, 5), data row d's block on the ranks of data index d.
    Returns this rank's slice, the gathered block, the block it should be,
    the gathers' count and bytes, and the points-group sum of
    points_index + 1."""
    r = np.random.default_rng(seed)
    full = torch.from_numpy(r.standard_normal(
        (mesh.data_size, 3, 8 * mesh.sp, 5)).astype(np.float32))
    mine = pmesh.shard_points(full[mesh.data_index], mesh)
    calls, nbytes = pmesh.gathers()
    total = pmesh.collectives()[0]
    got = pmesh.all_gather_points(mine, mesh)
    after = pmesh.gathers()
    total = pmesh.collectives()[0] - total
    summed = pmesh.all_reduce_points(
        torch.full((2,), float(mesh.points_index + 1)), mesh)
    return {"mine": mine, "got": got, "want": full[mesh.data_index],
            "calls": after[0] - calls, "bytes": after[1] - nbytes,
            "collectives": total, "summed": summed}


def evaluate_multi(mesh, kwargs, state, x, gp, gened, base, novel, y,
                   valid):
    """GWCAPL.evaluate_multi on this rank's rows and points, under the
    points split. Returns its logits (S, B / D, N / S, cls)."""
    model = GWCAPL(**kwargs)
    model.load_state_dict(state)
    pmesh.replicate(model, mesh)
    with torch.inference_mode(), pmesh.points_split(model, mesh):
        logits, _, _ = model.evaluate_multi(
            _local(x, mesh), gp, gened, base, novel, _local(y, mesh),
            pmesh.local_valid(valid, x.shape[0], mesh))
    assert model.points_mesh is None          # the split is undone
    return logits


def coding(mesh, kwargs, state, x, y, gp, n_base):
    """coding_step on this rank's rows and points under the points split,
    its four sums then summed over every rank (in float64)."""
    model = GWCAPL(**kwargs)
    model.load_state_dict(state)
    with pmesh.points_split(model, mesh):
        sums = coding_step(model, _local(x, mesh), _local(y, mesh), gp,
                           n_base)
    return [pmesh.all_reduce_sum(s.double(), mesh) for s in sums]


def pipelines(mesh, model_cfg, data_cfg, eval_cfg, train_cfg,
              max_steps_per_epoch):
    """evaluate_gfs over the mesh, then train_gfs (which takes its data
    mesh). torch.utils.tensorboard is made unimportable meanwhile, as in
    tests/torch_port_dp_ranks.py::pipelines (its import loads TensorFlow
    here, ~17 s a process)."""
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import evaluate_gfs, train_gfs

    tb = sys.modules.get("torch.utils.tensorboard", _ABSENT)
    sys.modules["torch.utils.tensorboard"] = None
    try:
        ev = evaluate_gfs(model_cfg, data_cfg, eval_cfg, mesh=mesh)
        tr = train_gfs(model_cfg, data_cfg, train_cfg,
                       max_steps_per_epoch=max_steps_per_epoch, mesh=mesh)
    finally:
        if tb is _ABSENT:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = tb
    tr.pop("model")
    return {"eval": ev, "train": tr}


def run_all(mesh, tasks):
    """[fn(mesh, *args) for each (name of a function here, args)]: several
    cases in one spawn of the ranks."""
    return [globals()[name](mesh, *args) for name, args in tasks]
