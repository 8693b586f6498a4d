"""CUDA graphs of the port's steps on one card: the train steps
(parallel/steps.py::gfs_train_step, pretrain_step) and the evaluation
forward (models/capl.py::GWCAPL.evaluate_multi). The host would take
longer to issue a step's hundreds of launches than the card to run them.

Every step goes through `run_step`, which decides whether the step runs
eagerly (`stays_eager`), builds its key (`_graph_key`) and replays the
owner's `StepGraph` at that key. A `StepGraph` holds one step at one key.
Its first WARM_CALLS calls run the eager step on a side stream, the next
captures it there and replays it, and every later call copies its tensor
inputs into the graph's own and replays it. The step stays eager on CPU
tensors; on a model with a mesh or a `data x points` mesh (its
collectives are not captured); under a running torch profiler (a replay
has no per-operation host events to attribute its kernels by); and, for
an evaluation step, in train mode or with autograd on. A replay adds to
the kernels' op spans (`op.k1` ...) the calls its capture made, so that
their calls stay the launches of the run.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from gfs3dseg_gws_tpu_torch.utils.observability import (add_calls, count,
                                                       profiler_running,
                                                       snapshot)

# eager calls at a key before the one that captures the step: the warm-up
# PyTorch asks for before a capture, by which time what is built lazily
# (Adam's moments, cuBLAS workspaces, the kernel library) exists
WARM_CALLS = 3


def run_step(owner, model, step, inputs: Sequence, *, train: bool,
             generator: Optional[torch.Generator] = None, parts=()):
    """`step(*inputs)`: eagerly where `stays_eager` holds, else through the
    graph of `owner` (the optimizer of a train step, the model of an
    evaluation) at the key of `model`, `inputs`, `generator` and `parts`,
    made at its first call. `step` returns a tuple of device tensors; it
    reads no tensor but its inputs, the model's, the owner's and the
    generator's, and nothing that the key does not fix: a graph keeps the
    `step` of the call that made it. The graphs live on the owner and go
    with it."""
    if stays_eager(model, inputs, train):
        return step(*inputs)
    key = _graph_key(model, inputs, generator, parts)
    graphs = owner.__dict__.setdefault("_step_graphs", {})
    if key not in graphs:                     # key[1]: the device
        graphs[key] = StepGraph(step, model, key[1], train, generator)
    return graphs[key](*inputs)


def stays_eager(model, inputs: Sequence, train: bool) -> bool:
    """Whether a step of `model` on `inputs` runs eagerly (module
    docstring)."""
    return (any(torch.is_tensor(t) and t.device.type != "cuda"
                for t in inputs)
            or profiler_running()
            or getattr(model, "mesh", None) is not None
            or getattr(model, "points_mesh", None) is not None
            or not train and (model.training or torch.is_grad_enabled()))


def _graph_key(model, inputs: Sequence, generator, parts) -> tuple:
    """The key of a step's graph: the model, the device of the first tensor
    input, each tensor input's shape and dtype (None for a None input; an
    input of another kind, the optimizer, is the owner), the generator
    where one is given (the graph registers its state), whether inference
    mode is on (the graph's inputs are made in it), then `parts`. It holds
    no tensor's id: a caller that makes its inputs anew each time (and
    CPython reuses ids) finds its graph, whose replay copies them in."""
    key = (id(model), next(t for t in inputs if torch.is_tensor(t)).device)
    for t in inputs:
        if t is None:
            key += (None,)
        elif torch.is_tensor(t):
            key += (t.shape, t.dtype)
    return key + (None if generator is None else id(generator),
                  torch.is_inference_mode_enabled(), *parts)


class StepGraph:
    """A step at one key: WARM_CALLS eager calls on a side stream, then one
    that captures the step on that stream and replays it, then a replay a
    call. `step(*inputs)` is the eager step; it returns a tuple of device
    tensors. Tensor inputs are copied into the graph's own at capture and
    refilled by every replay; any other input (the optimizer, None) is
    handed to `step` at capture and ignored after. The graph reads the
    model's parameters and buffers, an optimizer's state and LR tensors,
    what `step` holds and the generator's state where they lay at capture
    (the object holds the model, the generator and `step`, so that none is
    freed and no other object takes its key), and returns copies of the
    step's outputs, which no later replay overwrites. A replay puts the
    model in the mode an eager step leaves: training (`train`) or
    evaluation. `launches` holds the op spans' calls of the capture, which
    every later replay adds again (the capture's own replay runs the
    kernels that its op spans counted). Counters `graph_captures` and
    `graph_replays` under the caller's span."""

    def __init__(self, step, model, device: torch.device, train: bool,
                 generator: Optional[torch.Generator] = None):
        self.step, self.model, self.generator = step, model, generator
        self.device, self.train = device, train
        self.stream = torch.cuda.Stream(device)
        self.calls = 0
        self.graph = None
        self.inputs = self.outputs = None
        self.launches = {}

    def __call__(self, *inputs):
        if self.graph is not None:
            count("graph_replays")
            add_calls(self.launches)
            if self.model.training != self.train:
                self.model.train(self.train)
            for static, given in zip(self.inputs, inputs):
                if static is not None:
                    static.copy_(given)
            return self._replay()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            if self.calls < WARM_CALLS:
                self.calls += 1
                out = self.step(*inputs)
            else:
                count("graph_captures")
                out = None
                self._capture(inputs)
        current.wait_stream(self.stream)
        return self._replay() if out is None else out

    def _capture(self, inputs):
        self.inputs = [t.to(self.device, copy=True) if torch.is_tensor(t)
                       else None for t in inputs]
        args = [given if static is None else static
                for static, given in zip(self.inputs, inputs)]
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _op_calls()
        with torch.cuda.graph(graph, stream=self.stream):
            self.outputs = self.step(*args)
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
