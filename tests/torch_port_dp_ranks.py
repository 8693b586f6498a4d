"""Rank functions of tests/test_torch_port_dp.py, run by
`gfs3dseg_gws_tpu_torch.parallel.dryrun.run_ranks` on spawned gloo ranks
(and in the test process with mesh=None, for one process on the global
batch). This module imports no JAX, so that a spawned rank starts light.
"""
import builtins
import os
import sys

import torch

from gfs3dseg_gws_tpu_torch.models import attention as att_mod
from gfs3dseg_gws_tpu_torch.models import layers
from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
from gfs3dseg_gws_tpu_torch.ops.attention_train import dropout_keep_mask
from gfs3dseg_gws_tpu_torch.parallel.mesh import (all_reduce_sum,
                                                  allreduce_grads,
                                                  replicate, shard_batch)
from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_train_step

_ABSENT = object()


def _recording_masks(masks):
    """Patch the attention's and the segmenter's dropout so that each
    records its keep mask of this rank's rows; returns the undo."""
    attn, drop = att_mod.attention_train, layers.dropout

    def attention_train(q, k, v, seed, temperature, rate, batch_offset=0):
        masks.append(dropout_keep_mask(seed, q.shape[0], q.shape[1], rate,
                                       batch_offset=batch_offset))
        return attn(q, k, v, seed, temperature, rate, batch_offset)

    def dropout(x, rate, generator, mesh=None):
        out = drop(x, rate, generator, mesh)
        masks.append(out != 0)
        return out

    att_mod.attention_train, layers.dropout = attention_train, dropout

    def undo():
        att_mod.attention_train, layers.dropout = attn, drop
    return undo


def _result(model, loss, mesh, masks, pred=None):
    return {"loss": all_reduce_sum(loss.detach(), mesh).item(),
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "stats": {n: b.detach().clone()
                      for n, b in model.named_buffers()},
            "masks": masks, "pred": pred}


def capl_pass(mesh, kwargs, state, x, y, gp, fake_row=None, seed=0):
    """The GWCAPL train pass on this rank's rows of (x, y): forward,
    backward of its loss share, the gradient all-reduce. `fake_row` None:
    drawn from a generator seeded `seed`, as the attention's dropout seed."""
    model = GWCAPL(**kwargs)
    model.load_state_dict(state)
    replicate(layers.use_mesh(model, mesh), mesh).train()
    masks, protos = [], []
    fake_proto = model.generate_fake_proto

    def generate_fake_proto(*args):
        out = fake_proto(*args)
        protos.append(out[0].detach().clone())
        return out

    model.generate_fake_proto = generate_fake_proto
    undo = _recording_masks(masks)
    try:
        pred, loss = model(shard_batch(x, mesh), shard_batch(y, mesh), gp,
                           torch.Generator().manual_seed(seed), fake_row)
        loss.backward()
    finally:
        undo()
    allreduce_grads(model.parameters(), mesh)
    return dict(_result(model, loss, mesh, masks, pred), proto=protos[0])


def seg_pass(mesh, kwargs, state, x, y, seed=0):
    """The DGCNNSeg pre-training loss (pretrain_step's) on this rank's rows:
    forward with the dropout mask from a generator seeded `seed`, backward
    of the loss share, the gradient all-reduce."""
    model = DGCNNSeg(**kwargs)
    model.load_state_dict(state)
    replicate(layers.use_mesh(model, mesh), mesh).train()
    masks = []
    undo = _recording_masks(masks)
    try:
        logits = model(shard_batch(x, mesh),
                       torch.Generator().manual_seed(seed))
        loss = layers.cross_entropy(logits, shard_batch(y, mesh), mesh=mesh)
        loss.backward()
    finally:
        undo()
    allreduce_grads(model.parameters(), mesh)
    return _result(model, loss, mesh, masks)


def capl_step(mesh, kwargs, state, x, y, gp, fake_row):
    """One gfs_train_step (GWCAPL pass, gradient all-reduce, Adam, StepLR)
    on this rank's rows. Returns its loss and the state after it."""
    model = GWCAPL(**kwargs)
    model.load_state_dict(state)
    replicate(layers.use_mesh(model, mesh), mesh)
    opt, sched = make_gfs_optimizer(model, 1e-3, 10)
    loss, _ = gfs_train_step(model, opt, shard_batch(x, mesh),
                             shard_batch(y, mesh), gp,
                             torch.Generator().manual_seed(0), sched,
                             fake_row)
    return {"loss": loss.item(),
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()}}


def pipelines(mesh, model_cfg, data_cfg, eval_cfg, train_cfg, pre_cfg,
              max_steps_per_epoch):
    """evaluate_gfs, train_gfs, then pretrain, over the mesh. Returns their
    results (the models left out) and, on a rank other than 0, every file
    it opened for writing under any run's save_path or log_dir (there must
    be none).
    torch.utils.tensorboard is made unimportable meanwhile (where it loads
    TensorFlow, its import takes ~17 s a process), so metrics.jsonl has no
    TensorBoard mirror in these runs."""
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import evaluate_gfs, train_gfs

    tb = sys.modules.get("torch.utils.tensorboard", _ABSENT)
    sys.modules["torch.utils.tensorboard"] = None

    from gfs3dseg_gws_tpu_torch.pipelines.pretrain import pretrain

    roots = (os.path.abspath(eval_cfg.save_path),
             os.path.abspath(train_cfg.save_path),
             os.path.abspath(pre_cfg.log_dir))
    writes, real_open = [], builtins.open

    def open_(file, mode="r", *a, **kw):
        if (isinstance(file, (str, os.PathLike)) and set(mode) & set("wax+")
                and os.path.abspath(file).startswith(roots)):
            writes.append(os.fspath(file))
        return real_open(file, mode, *a, **kw)

    if mesh is not None and not mesh.is_main:
        builtins.open = open_
    try:
        ev = evaluate_gfs(model_cfg, data_cfg, eval_cfg, mesh=mesh)
        tr = train_gfs(model_cfg, data_cfg, train_cfg,
                       max_steps_per_epoch=max_steps_per_epoch, mesh=mesh)
        pre = pretrain(model_cfg, data_cfg, pre_cfg,
                       max_steps_per_epoch=max_steps_per_epoch, mesh=mesh)
    finally:
        builtins.open = real_open
        if tb is _ABSENT:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = tb
    tr.pop("model")
    pre.pop("model")
    return {"eval": ev, "train": tr, "pretrain": pre, "writes": writes}


def run_all(mesh, tasks):
    """[fn(mesh, *args) for each (name of a function here, args)]: several
    cases in one spawn of the ranks."""
    return [globals()[name](mesh, *args) for name, args in tasks]


def train_steps_book(mesh, kwargs, state, x, y, gp, steps):
    """`steps` gfs_train_steps at one key (the same rows, generator and
    shapes) on this rank's rows; returns the span calls and counters they
    added to the plain book."""
    from gfs3dseg_gws_tpu_torch.utils.observability import snapshot

    model = GWCAPL(**kwargs)
    model.load_state_dict(state)
    replicate(layers.use_mesh(model, mesh), mesh)
    opt, sched = make_gfs_optimizer(model, 1e-3, 10)
    gen = torch.Generator()
    before = snapshot()["plain"]
    for step in range(steps):
        gen.manual_seed(step)
        gfs_train_step(model, opt, shard_batch(x, mesh), shard_batch(y, mesh),
                       gp, gen, sched)
    after = snapshot()["plain"]
    return {"calls": {p: e["calls"] - before["spans"].get(
                          p, {"calls": 0})["calls"]
                      for p, e in after["spans"].items()},
            "counters": {p: n - before["counters"].get(p, 0)
                         for p, n in after["counters"].items()}}
