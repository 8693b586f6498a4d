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
CUDA graph of the step: the host would take longer to issue its ~1,000
launches than the card to run them. Each keeps a `_StepGraph` a key (per
model and optimizer: the device, the shapes and dtypes of points and
labels, the generator; `gfs_train_step` also gp and whether fake_row is
given). Its first WARM_CALLS calls at a key run eagerly, the next
captures the forward, the backward and Adam's update, and every later
call copies its inputs into the graph's and replays it; the LR schedule
steps on the host after it, into the LR tensors the graph reads
(parallel/optim.py). A replay draws from the generator what an eager call
would draw from its seed and offset, and moves the offset on as that call
would. CPU tensors, a model with a mesh and a running torch profiler keep
the eager step; eager calls and replays update the same parameters and
optimizer state, so they can alternate. A replay adds to the kernels' op
spans (`op.k3` ...) the calls its capture made, so that their calls stay
the launches of the run.

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

import weakref
from typing import Optional, Tuple

import torch

from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy
from gfs3dseg_gws_tpu_torch.ops.metrics import confusion_matrix
from gfs3dseg_gws_tpu_torch.parallel.mesh import (Mesh, all_reduce_points,
                                                  all_reduce_sum,
                                                  allreduce_grads)
from gfs3dseg_gws_tpu_torch.utils.observability import (add_calls, count,
                                                       profiler_running,
                                                       snapshot, span)

# eager calls at a key before the one that captures the train step: the
# warm-up PyTorch asks for before a capture, by which time what is built
# lazily (Adam's moments, cuBLAS workspaces, the kernel library) exists
WARM_CALLS = 3
_graphs = weakref.WeakKeyDictionary()    # optimizer -> {key: _StepGraph}


def _update(model, opt, loss: torch.Tensor, sched,
            mesh: Optional[Mesh]) -> None:
    """Backward (this rank's share of the loss under a mesh; span
    `backward`), the gradient all-reduce, the optimizer step and the
    per-step LR schedule (span `optimizer`)."""
    opt.zero_grad(set_to_none=True)
    with span("backward"):
        loss.backward()
    allreduce_grads(model.parameters(), mesh)
    with span("optimizer"):
        opt.step()
        if sched is not None:
            sched.step()


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
        key = _graph_key(model, points, labels, id(gp), id(generator),
                         fake_row is None)
        if key is None:
            return _gfs_step(model, opt, points, labels, gp, generator,
                             sched, fake_row, getattr(model, "mesh", None))
        graph = _graph_at(opt, key, lambda: _StepGraph(
            lambda o, x, y, row: _gfs_step(model, o, x, y, gp, generator,
                                           None, row, None),
            model, generator, points.device))
        out = graph(opt, points, labels, fake_row)
        if sched is not None:
            sched.step()
        return out


def _gfs_step(model, opt, points, labels, gp, generator, sched, fake_row,
              mesh):
    """The eager step (spans `forward`, `backward`, `optimizer`)."""
    model.train()
    with span("forward"):
        pred, loss = model(points, labels, gp, generator, fake_row)
    _update(model, opt, loss, sched, mesh)
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
        key = _graph_key(model, points, labels, id(generator))
        if key is None:
            return _pretrain_step(model, opt, points, labels, generator,
                                  sched, getattr(model, "mesh", None))
        graph = _graph_at(opt, key, lambda: _StepGraph(
            lambda o, x, y: (_pretrain_step(model, o, x, y, generator, None,
                                            None),),
            model, generator, points.device))
        out = graph(opt, points, labels)[0]
        if sched is not None:
            sched.step()
        return out


def _pretrain_step(model, opt, points, labels, generator, sched, mesh):
    """The eager step (spans `forward`, `backward`, `optimizer`)."""
    model.train()
    with span("forward"):
        loss = cross_entropy(model(points, generator), labels, mesh=mesh)
    _update(model, opt, loss, sched, mesh)
    return _global(mesh, loss.detach())[0]


def _graph_key(model, points, labels, *parts):
    """The key of a train step's graph, `parts` after the model, the device
    and the inputs' shapes and dtypes, or None where the step stays eager:
    CPU tensors; a model with a mesh (its collectives are not captured);
    a running profiler (a replay has no per-operation host events to
    attribute its kernels by)."""
    if points.device.type != "cuda" or profiler_running() or \
            getattr(model, "mesh", None) is not None:
        return None
    return (id(model), points.device, points.shape, points.dtype,
            labels.shape, labels.dtype) + parts


def _graph_at(opt, key, make) -> "_StepGraph":
    """The step graph of `opt` at `key`, made by `make()` at its first
    call."""
    graphs = _graphs.setdefault(opt, {})
    if key not in graphs:
        graphs[key] = make()
    return graphs[key]


class _StepGraph:
    """A train step at one key: WARM_CALLS eager calls on a side stream,
    then one that captures the step without its schedule (forward,
    backward, Adam) on that stream and replays it, then a replay a call.
    `step(opt, *inputs)` is the eager step; it returns a tuple of device
    tensors. The graph reads the model's parameters and buffers, Adam's
    state and LR tensors, what `step` holds (gp) and the generator's state
    where they lay at capture (the object holds the model, the generator
    and `step`, so that none is freed and no other object takes its key;
    not the optimizer, the weak key of its cache), and its own copies of
    the inputs (None stays None), which each replay refills; a replay
    returns copies of the step's outputs, which the next replay
    overwrites. `launches` holds the op spans' calls of the capture, which
    every later replay adds again (the capture's own replay runs the
    kernels that its op spans counted). Counters `graph_captures` and
    `graph_replays` under the caller's span."""

    def __init__(self, step, model, generator, device):
        self.step, self.model, self.generator = step, model, generator
        self.stream = torch.cuda.Stream(device)
        self.calls = 0
        self.graph = None
        self.inputs = self.outputs = None
        self.launches = {}

    def __call__(self, opt, *inputs):
        if self.graph is not None:
            count("graph_replays")
            add_calls(self.launches)
            if not self.model.training:
                self.model.train()         # the mode an eager step leaves
            for static, given in zip(self.inputs, inputs):
                if static is not None:
                    static.copy_(given)
            return self._replay()
        current = torch.cuda.current_stream(inputs[0].device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            if self.calls < WARM_CALLS:
                self.calls += 1
                out = self.step(opt, *inputs)
            else:
                count("graph_captures")
                out = None
                self._capture(opt, inputs)
        current.wait_stream(self.stream)
        return self._replay() if out is None else out

    def _capture(self, opt, inputs):
        device = inputs[0].device
        self.inputs = [None if t is None else t.to(device, copy=True)
                       for t in inputs]
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _op_calls()
        with torch.cuda.graph(graph, stream=self.stream):
            self.outputs = self.step(opt, *self.inputs)
        after = _op_calls()
        self.launches = {path: n - before.get(path, 0)
                         for path, n in after.items()
                         if n != before.get(path, 0)}
        self.graph = graph

    def _replay(self):
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)


def _op_calls():
    """{path: calls} of the op spans (`.../op.k3` ...) in the plain book,
    where a capture counts (it never runs under a profiler)."""
    return {path: entry["calls"]
            for path, entry in snapshot()["plain"]["spans"].items()
            if path.rsplit("/", 1)[-1].startswith("op.")}


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
    _update(model, opt, loss, sched, None)
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
    `eval_step` around it, `counts` around the argmax and the counts.
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
