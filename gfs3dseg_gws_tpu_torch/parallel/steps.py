"""Single-device train and eval steps (counterpart of the JAX package's
parallel/steps.py: the GFS train step, steps.py:223-264, the pretrain step,
steps.py:655-692, and the eval factories, steps.py:534-577, 727-742 and
745-808; and of the few-shot baselines' episode steps,
pipelines/baselines.py:160-190).

Plain functions; each returns device tensors and never synchronises, so a
loop can queue steps back to back and read the results later. The JAX
package's multi-step `lax.scan` dispatch and packed host-to-device batches
are TPU workarounds and have no counterpart here.

The train steps `gfs_train_step` and `pretrain_step` on one card replay a
CUDA graph of the step through parallel/graph.py::run_step, one graph per
optimizer and key (the model, the device, the shapes and dtypes of the
tensor inputs, the generator). Its first WARM_CALLS calls at a key run
eagerly, the next captures the forward, the backward and Adam's update,
and every later call copies its inputs into the graph's and replays it;
the LR schedule steps on the host after each step, eager or replayed,
into the LR tensors the graph reads (parallel/optim.py). A replay draws
from the generator what an eager call would draw from its seed and
offset, and moves the offset on as that call would. CPU tensors, a model
with a mesh and a running torch profiler keep the eager step; eager calls
and replays update the same parameters and optimizer state, so they can
alternate.

Data parallelism (parallel/mesh.py): the train steps run over the model's
mesh, the one models/layers.py::use_mesh set on it and on every module
that reduces over the batch, so that the model and the step cannot
disagree on it. Each rank backwards its
share of the global loss, the gradients are summed over the ranks and
every rank takes the same optimizer step; the loss and accuracy returned
are the global batch's. The eval steps run per block on this rank's rows
and return sums and confusion counts that the caller all-reduces; under
the `data x points` mesh (the model's `points_mesh`, parallel/mesh.py::
points_split) on this rank's points of those rows, and `coding_step`
reduces each block's background count and sum over the points group
first.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch

from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy
from gfs3dseg_gws_tpu_torch.ops.metrics import confusion_matrix
from gfs3dseg_gws_tpu_torch.parallel.graph import run_step
from gfs3dseg_gws_tpu_torch.parallel.mesh import (Mesh, all_reduce_points,
                                                  all_reduce_sum,
                                                  allreduce_grads)
from gfs3dseg_gws_tpu_torch.utils.observability import span


def _update(model, opt, loss: torch.Tensor, mesh: Optional[Mesh]) -> None:
    """Backward (this rank's share of the loss under a mesh; span
    `backward`), the gradient all-reduce and the optimizer step (span
    `optimizer`)."""
    opt.zero_grad(set_to_none=True)
    with span("backward"):
        loss.backward()
    allreduce_grads(model.parameters(), mesh)
    with span("optimizer"):
        opt.step()


def _global(mesh: Optional[Mesh], *values: torch.Tensor):
    """Per-rank shares summed over the ranks, in one all-reduce."""
    if mesh is None:
        return values
    return tuple(all_reduce_sum(torch.stack([v.detach() for v in values]),
                                mesh))


def gfs_train_step(model, opt: torch.optim.Optimizer, points: torch.Tensor,
                   labels: torch.Tensor, gp: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   sched=None, fake_row: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GFS base-stage step (reference train.py:616-631): train-mode
    GWCAPL forward (fake-novel prototypes, 0.5 CE2 + 0.5 CE1), backward,
    optimizer step, then the per-step LR schedule. `generator` (on the
    device) draws the fake classes and the attention's dropout seed; a
    replay draws what an eager call would from the generator's seed and
    offset. Returns (loss, accuracy = mean(pred == labels)) as device
    tensors; with a mesh (the model's), this rank's rows in, the global
    batch's loss and accuracy out. On one card the step is replayed as a
    CUDA graph from the call after WARM_CALLS eager ones at its key (module
    docstring). Spans: `train_step` around it, `forward` around the model
    call of an eager step; counters `graph_captures` and `graph_replays`
    in `train_step`."""
    with span("train_step"):
        out = run_step(opt, model, partial(_gfs_step, model, generator),
                       (opt, points, labels, gp, fake_row), train=True,
                       generator=generator)
        if sched is not None:
            sched.step()
        return out


def _gfs_step(model, generator, opt, points, labels, gp, fake_row):
    """The step, eager or captured (spans `forward`, `backward`,
    `optimizer` of an eager step); with the model's mesh, if it has one."""
    mesh = getattr(model, "mesh", None)
    model.train()
    with span("forward"):
        pred, loss = model(points, labels, gp, generator, fake_row)
    _update(model, opt, loss, mesh)
    accuracy = torch.mean((pred == labels).to(torch.float32))
    if mesh is not None:
        accuracy = accuracy / mesh.size      # every rank holds as many rows
    return _global(mesh, loss.detach(), accuracy)


def pretrain_step(model, opt: torch.optim.Optimizer, points: torch.Tensor,
                  labels: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  sched=None) -> torch.Tensor:
    """One supervised segmentation step (reference pre_train.py:144-159):
    train-mode forward, mean cross-entropy, backward, optimizer step, then
    the per-step LR schedule. `generator` draws the dropout masks; a
    replay draws what an eager call would from the generator's seed and
    offset. Returns the loss as a device tensor (the caller reads it when
    it likes); with a mesh (the model's), the global batch's. On one card
    the step is replayed as a CUDA graph from the call after WARM_CALLS
    eager ones at its key (module docstring). Spans: `pretrain_step`
    around it, `forward` around the model call and the loss of an eager
    step; counters `graph_captures` and `graph_replays` in
    `pretrain_step`."""
    with span("pretrain_step"):
        out = run_step(opt, model, partial(_pretrain_step, model, generator),
                       (opt, points, labels), train=True,
                       generator=generator)[0]
        if sched is not None:
            sched.step()
        return out


def _pretrain_step(model, generator, opt, points, labels):
    """The step, eager or captured (spans `forward`, `backward`,
    `optimizer` of an eager step); with the model's mesh, if it has one.
    Returns (loss,)."""
    mesh = getattr(model, "mesh", None)
    model.train()
    with span("forward"):
        loss = cross_entropy(model(points, generator), labels, mesh=mesh)
    _update(model, opt, loss, mesh)
    return _global(mesh, loss.detach())


def fewshot_train_step(model, opt: torch.optim.Optimizer, support_x,
                       support_y, query_x, query_y,
                       generator: Optional[torch.Generator] = None,
                       sched=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One episodic update of a ProtoNet / MPTI (reference
    proto_learner.py:34-49): train-mode forward (support and query in two
    encoder calls), backward, optimizer step, then the per-iteration LR
    schedule. `generator` draws the attention's dropout seed. Returns
    (loss, accuracy of the query argmax) as device tensors."""
    model.train()
    logits, loss = model(support_x, support_y, query_x, query_y, generator)
    _update(model, opt, loss, None)
    if sched is not None:
        sched.step()
    pred = torch.argmax(logits.detach(), dim=-1)
    return loss.detach(), torch.mean((pred == query_y).to(torch.float32))


@torch.inference_mode()
def fewshot_test_step(model, support_x, support_y, query_x, query_y
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """One eval episode (reference proto_learner.py:51-65): eval-mode
    forward, argmax, the (n_way+1)^2 confusion counts. Returns (pred, cm,
    loss, accuracy) as device tensors."""
    model.eval()
    logits, loss = model(support_x, support_y, query_x, query_y)
    pred = torch.argmax(logits, dim=-1)
    cm = confusion_matrix(pred, query_y, support_x.shape[0] + 1)
    return pred, cm, loss, torch.mean((pred == query_y).to(torch.float32))


@torch.inference_mode()
def eval_logits_step(model, points: torch.Tensor, labels: torch.Tensor,
                     valid: int, num_classes: int) -> torch.Tensor:
    """Segmentor eval of one batch: logits -> argmax -> confusion counts
    (C, C), leaving out rows at or past `valid` (the padding of a final
    short batch). The model runs in eval mode."""
    model.eval()
    pred = torch.argmax(model(points), dim=-1)
    rows = torch.arange(points.shape[0], device=points.device) < valid
    return confusion_matrix(pred, labels, num_classes,
                            rows[:, None].expand(labels.shape))


@torch.inference_mode()
def gfs_eval_multi_step(model, points: torch.Tensor, labels: torch.Tensor,
                        gp: torch.Tensor, gened_protos: torch.Tensor,
                        base_coding: torch.Tensor,
                        novel_codings: torch.Tensor, valid: int,
                        num_classes: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-seed GFS eval of one batch: S prototype sets share one feature
    sweep (GWCAPL.evaluate_multi). Rows at or past `valid` (padding of a
    final short batch) stay out of the confusion counts and gp_acc.

    Returns (cm (S, C, C), gp_acc (S,), gp_novel_acc (S,)). Spans:
    `eval_step` around it, `counts` around the argmax and the counts; on
    one card the model call replays a CUDA graph of the forward and the
    heads (counters `eval_step/graph_captures` and
    `eval_step/graph_replays`), and the counts stay eager.
    """
    with span("eval_step"):
        model.eval()
        logits, gp_acc, gp_nacc = model.evaluate_multi(
            points, gp, gened_protos, base_coding, novel_codings, labels,
            valid)
        with span("counts"):
            pred = torch.argmax(logits, dim=-1)              # (S, B, N)
            rows = torch.arange(points.shape[0],
                                device=points.device) < valid
            mask = rows[:, None].expand(labels.shape)
            cm = torch.stack([confusion_matrix(p, labels, num_classes, mask)
                              for p in pred])
        return cm, gp_acc, gp_nacc


@torch.inference_mode()
def coding_step(model, points: torch.Tensor, labels: torch.Tensor,
                gp: torch.Tensor, num_base: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """One accumulation step of base-class geometric-word coding collection
    (reference train.py:156-218, over a batch of blocks).

    For each base class c (label c+1): the sum of per-point one-hot word
    vectors and the point count. For background (label 0): the sum of
    per-BLOCK mean word vectors and the number of blocks with background
    (the reference averages block means).

    Returns (cls_sums (num_base, K), cls_counts (num_base,),
             bg_mean_sum (K,), bg_block_count ()).

    Under the points split (the model's `points_mesh`) points and labels
    are this rank's points of each block: a block's background count and
    sum are summed over its points group before the division and before
    `has_bg`, and only points index 0 returns the per-block terms, so that
    the caller's sum over every rank counts each block once.
    """
    model.eval()
    pm = getattr(model, "points_mesh", None)
    _, _, gw = model.get_features(points, gp)                # (B, N, K)
    onehot = torch.nn.functional.one_hot(labels.long(), num_base + 1).to(
        gw.dtype)
    sums = torch.einsum("bnc,bnk->ck", onehot, gw)
    counts = torch.sum(onehot, dim=(0, 1))
    bg_mask = onehot[..., 0]                                 # (B, N)
    bg_cnt = torch.sum(bg_mask, dim=1)                       # (B,)
    bg_sum = torch.einsum("bn,bnk->bk", bg_mask, gw)
    if pm is not None:
        both = all_reduce_points(torch.cat([bg_cnt[:, None], bg_sum], 1), pm)
        bg_cnt, bg_sum = both[:, 0], both[:, 1:]
    has_bg = (bg_cnt > 0).to(gw.dtype)
    bg_means = bg_sum / torch.clamp_min(bg_cnt, 1.0)[:, None]
    bg_mean_sum = torch.einsum("b,bk->k", has_bg, bg_means)
    bg_blocks = torch.sum(has_bg)
    if pm is not None and pm.points_index != 0:
        bg_mean_sum = torch.zeros_like(bg_mean_sum)
        bg_blocks = torch.zeros_like(bg_blocks)
    return sums[1:], counts[1:], bg_mean_sum, bg_blocks


@torch.inference_mode()
def fg_feat_step(model, points: torch.Tensor, mask: torch.Tensor,
                 gp: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Support-shot foreground features for prototype registration
    (reference train.py:266-277 via capl.py:71-88), all shots in one batch.

    Returns (fg_sums (S, C), fg_counts (S,), gw_hists (S, K)).
    """
    model.eval()
    return model.get_fg_feat(points, mask, gp)
