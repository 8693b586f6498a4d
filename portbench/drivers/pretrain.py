"""Traffic driver `pretrain`: backbone pre-training of the DGCNNSeg
segmentor, `pipelines/pretrain.py::pretrain`'s inner loop without its
validation sweeps or checkpoints.

Set-up is `pretrain()`'s: blocks written from the seed, the class lists,
the augmented training split (90/10 by class), the model with its own
initialisers drawn from a CPU generator seeded with the run's seed, Adam
with L2 weight decay and its StepLR, one device generator seeded once
with the run's seed for the dropout masks, never reseeded. It then
drives that one training object through its first steps, through the
window's own call and feed: `pipelines/gfs.py::train_batches` (the
native C++ pool, shuffled, augmented, epoch after epoch) into
`parallel/steps.py::pretrain_step`; losses are read LOSS_LAG steps late
and all of them at an epoch's end, as `pretrain()` reads them. The
window goes on with the same object and feed.

The checked steps are the set-up's first five: on one card the three
eager warm-up calls at the step's key, the call that captures the step
as a CUDA graph (and replays it) and one replay. The reference takes
each of them from the program's state before it. What the comparison
reads, kept during set-up: the weights before step 1, the program's
state before each checked step (parameters, Adam's moments and step
count), Adam's first moment after step 1 (the first gradient as the
optimizer got it, weight decay included), each checked step's update
(the parameters after it less those before it), the five steps' losses,
batches and kNN graphs. The graphs are
the EdgeConvs' own (K3, or K6 in a block of another depth), copied as
they are built: a second forward pass would not do, as the program's
forward is not bit for bit the same from call to call, and a near-tie
then falls the other way. A replay builds them without calling back to
the host, so the capture copies them into tensors of the graph's, which
every replay rewrites and which are copied out after the checked
replays. Those three copies (2.6 MB each at batch 16 x 2,048 points, k
20) stay in the graph for the rest of the run (PERF.md gives their
cost).

The driver opens the span `seg_head` around the program's segmenter head
(`models/dgcnnseg.py::seg_head`, called through its module's global
name) while a trace runs, where the program has one.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

import blocks
from phases import Phases
from reference import data as refdata
from reference import dgcnnseg as refseg
from reference import gwcapl
from tracer import HERE, load_module

_gfs = load_module(os.path.join(HERE, "drivers", "gfs_train.py"),
                   "driver_gfs_train_for_pretrain")
ADAM_BETA1 = _gfs.ADAM_BETA1
_norm = _gfs._norm


class Driver:
    kind = "train"

    def __init__(self, cfg, traffic, seed, device, workdir, fault=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir, self.fault = device, workdir, fault
        self.phases, self.notes = {}, {}

    def setup(self):
        from gfs3dseg_gws_tpu_torch.cli.common import disable_tf32
        from gfs3dseg_gws_tpu_torch.data import (PretrainBlockDataset,
                                                 make_registry)
        from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
        from gfs3dseg_gws_tpu_torch.models.layers import Dropout
        from gfs3dseg_gws_tpu_torch.parallel.optim import (
            make_pretrain_optimizer)
        from gfs3dseg_gws_tpu_torch.parallel.steps import pretrain_step
        from gfs3dseg_gws_tpu_torch.pipelines import gfs
        from gfs3dseg_gws_tpu_torch.utils.config import DataConfig
        cfg, tr, dev = self.cfg, self.traffic, self.device
        disable_tf32()
        clock = Phases(self.phases)
        self.train_dir, _ = blocks.make_blocks(
            os.path.join(self.workdir, "data"), self.seed, tr["train_blocks"],
            tr["train_block_points"], 0, 0, cfg["total_classes"])
        clock("data")
        reg = make_registry(cfg["dataset"], cfg["cvfold"], self.train_dir)
        classes = reg.train_classes
        augment = DataConfig(
            pc_augm_scale=cfg["pc_augm_scale"], pc_augm_rot=cfg["pc_augm_rot"],
            pc_augm_mirror_prob=cfg["pc_augm_mirror_prob"],
            pc_augm_jitter=cfg["pc_augm_jitter"]).augment_config
        data = PretrainBlockDataset(
            self.train_dir, classes, {c: reg.class2scans[c] for c in classes},
            mode="train", num_point=cfg["pc_npts"],
            pc_attribs=cfg["pc_attribs"], pc_augm=cfg["pc_augm"],
            pc_augm_config=augment, split_ratio=cfg["split_ratio"])
        clock("class_lists")
        self.num_classes = len(classes) + 1
        model = DGCNNSeg(
            self.num_classes, in_features=len(cfg["pc_attribs"]),
            edgeconv_widths=tuple(tuple(w) for w in cfg["edgeconv_widths"]),
            mlp_widths=tuple(cfg["dgcnn_mlp_widths"]), k=cfg["dgcnn_k"],
            dropout=cfg["dropout"],
            generator=torch.Generator().manual_seed(self.seed)).to(dev)
        self.initial = {n: t.detach().clone()
                        for n, t in model.state_dict().items()}
        if self.fault == "no_dropout":        # fault: the step at rate 0
            for mod in model.modules():
                if isinstance(mod, Dropout):
                    mod.rate = 0.0
        wd = 0.0 if self.fault == "no_weight_decay" else cfg["weight_decay"]
        opt, sched = make_pretrain_optimizer(
            model.parameters(), cfg["lr"],
            max(len(data) // tr["batch"], 1), wd, cfg["step_size"],
            cfg["gamma"])
        if self.fault == "unchanged_state":   # fault: the step moves nothing
            opt.step = lambda *a, **k: None
        self.gfs, self.step_fn = gfs, pretrain_step
        self.model, self.opt, self.sched = model, opt, sched
        self.gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.feed = self._feed(data)
        self.epoch, self.pending = 0, []
        self.batches, self.losses, self.graphs = [], [], []
        names = {id(p): n for n, p in model.named_parameters()}
        self.trainable = [n for n, _ in model.named_parameters()]
        clock("model_and_optimizer")
        live, self.starts, self.updates = [], [], []
        for i in range(max(tr["warm_steps"], tr["checked_steps"])):
            batch = next(self.feed)
            if i < tr["checked_steps"]:
                self.batches.append((self.epoch,
                                     np.array(batch[0], np.float32),
                                     np.array(batch[1], np.int64)))
                self.starts.append(self._state(names))
                made = []
                with self._record_graphs(made):
                    self._step(batch)
                live = made or live           # a replay calls back nothing
                self.graphs += [g.clone() for g in live]
                self.losses.append(self.pending[-1])
                self.updates.append({
                    n: p.detach() - self.starts[-1][0][n]
                    for n, p in model.named_parameters()})
            else:
                self._step(batch)
            if i == 0:
                self.first_moment = {
                    names[id(p)]: st["exp_avg"].clone()
                    for p, st in opt.state.items() if "exp_avg" in st}
            self._drain()
        self._drain(0)
        clock("first_steps")

    def _state(self, names):
        """The program's state before a step, as the reference takes it
        (reference/dgcnnseg.py::Start): parameters, Adam's moments (zero
        before its first step) and step count."""
        params = {n: p.detach().clone()
                  for n, p in self.model.named_parameters()}
        m = {n: torch.zeros_like(t) for n, t in params.items()}
        v = {n: torch.zeros_like(t) for n, t in params.items()}
        t = 0
        for p, st in self.opt.state.items():
            if "exp_avg" in st:
                m[names[id(p)]] = st["exp_avg"].clone()
                v[names[id(p)]] = st["exp_avg_sq"].clone()
                t = int(st["step"])
        return params, m, v, t

    @staticmethod
    @contextlib.contextmanager
    def _record_graphs(into):
        """Put copies of the kNN graphs the program's EdgeConvs build (K3
        and K6, looked up in models/dgcnn.py at call time) into `into`, in
        the order built."""
        from gfs3dseg_gws_tpu_torch.models import dgcnn

        stats, indices = dgcnn.knn_with_stats, dgcnn.knn_indices

        def with_stats(*args, **kwargs):
            out = stats(*args, **kwargs)
            into.append(out[0].clone())
            return out

        def plain(*args, **kwargs):
            idx = indices(*args, **kwargs)
            into.append(idx.clone())
            return idx

        dgcnn.knn_with_stats, dgcnn.knn_indices = with_stats, plain
        try:
            yield
        finally:
            dgcnn.knn_with_stats, dgcnn.knn_indices = stats, indices

    def _feed(self, data):
        """Epoch after epoch of the native pool's batches; at each epoch's
        end every loss is read, as `pretrain()` reads them there."""
        while True:
            yield from self.gfs.train_batches(data, self.traffic["batch"],
                                              seed=self.seed,
                                              epoch=self.epoch)
            self._drain(0)
            self.epoch += 1

    def _step(self, batch):
        points = np.asarray(batch[0], np.float32)
        labels = np.asarray(batch[1], np.int64)
        if self.fault == "half_batch":        # fault: half the batch left out
            points, labels = points[:len(points) // 2], \
                labels[:len(labels) // 2]
        self.pending.append(self.step_fn(
            self.model, self.opt, torch.from_numpy(points).to(self.device),
            torch.from_numpy(labels).to(self.device), self.gen, self.sched))

    def _drain(self, keep=None):
        """Read the losses as `pretrain()` does: those LOSS_LAG steps old
        (all of them at an epoch's end)."""
        keep = self.gfs.LOSS_LAG if keep is None else keep
        while len(self.pending) > keep:
            float(self.pending.pop(0))

    def _trace_head(self, tracer):
        """While `tracer` is installed, the span `seg_head` around the
        program's segmenter head, as Tracer.install wraps the entries of
        spans/ (its uninstall restores it); nothing where the program has
        no such function."""
        from gfs3dseg_gws_tpu_torch.models import dgcnnseg

        fn = getattr(dgcnnseg, "seg_head", None)
        if fn is not None:
            tracer._saved.append((dgcnnseg, "seg_head", fn))
            dgcnnseg.seg_head = tracer._wrap(fn, "seg_head")

    def window(self, seconds, tracer=None):
        tr = self.traffic
        if tracer is not None:
            self._trace_head(tracer)
        stepper = (lambda: tracer.span("pretrain.step")) if tracer else \
            contextlib.nullcontext
        steps, traced = 0, tracer is None
        t0 = time.perf_counter()
        while True:
            tracing = not traced and steps == tr["trace_skip_steps"]
            ctx = tracer.stretch(self.device) if tracing \
                else contextlib.nullcontext()
            with ctx:
                for _ in range(tr["trace_steps"] if tracing else 1):
                    batch = next(self.feed)
                    with stepper():
                        self._step(batch)
                    self._drain()
                    steps += 1
            traced = traced or tracing
            if time.perf_counter() - t0 >= seconds and traced:
                break
        self._drain(0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        end = time.perf_counter()
        if tracer is not None:
            s = tracer.summarize()
            s.blocks = tr["trace_steps"] * tr["batch"]
            s.cfg = dict(self.cfg, num_classes=self.num_classes)
        return {"attempted": steps, "failed": 0, "metrics": {
            "train_blocks_per_s": steps * tr["batch"] / (end - t0)}}

    def release(self):
        """Free the program's state; keep what set-up kept for the check."""
        self.losses = [float(v) for v in self.losses]
        del self.model, self.opt, self.sched, self.feed
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """The numbers compared with the plain reference's checked steps,
        each step taken by the reference from the program's state before
        it (`reference_steps`): loss_gap, grad_gap, grad_err_median,
        graph_untied and loader_rows_unmatched as the GFS driver defines
        them (drivers/gfs_train.py::Driver.check), the last over each
        epoch's checked batches (a block is sampled once an epoch), and
        change_gap over every checked step's update (`compare_train`).
        The notes name the step and leaf of the worst change gap."""
        graphs = gwcapl.Graphs(self.graphs)
        self.reference = self.reference_steps("fp32", graphs)
        numbers = compare_train(self.losses, self.first_moment, self.updates,
                                self.initial, self.reference, graphs)
        gaps = change_gaps(self.updates, self.reference)
        worst = max(gaps, key=gaps.get)
        self.notes = {"graph_rows_differing": graphs.differing,
                      "graph_rows": graphs.rows,
                      "change_gap_worst": f"step {worst[0] + 1} {worst[1]}"}
        epochs = sorted({e for e, _, _ in self.batches})
        numbers["loader_rows_unmatched"] = float(sum(
            refdata.unmatched_rows(
                self.train_dir, [(x, y) for e, x, y in self.batches
                                 if e == epoch], self.cfg)
            for epoch in epochs))
        return numbers

    def reference_steps(self, mode: str, graphs: gwcapl.Graphs):
        """The reference's checked steps on the same batches and generator
        seed, each from the program's state before it, its products in
        `mode` ('fp32', or the control's 'tf32'), its kNN graphs through
        `graphs`: (losses, the first step's gradients, each step's update
        of each parameter)."""
        dev = self.device
        batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
                   for _, x, y in self.batches]
        with gwcapl.precision(mode):
            losses, first, afters = refseg.train_steps(
                self.initial, self.trainable, self.cfg, batches, self.seed,
                graphs, self.starts)
        return losses, first, [{n: after[n] - start[0][n] for n in after}
                               for after, start in zip(afters, self.starts)]


def change_gaps(updates, ref):
    """{(step, leaf): gap} of every checked step's update: the gap between
    the norms of the program's update (`updates[step]`) and the
    reference's, from the program's state before that step, against the
    larger of the reference's norm of that leaf's update and of the
    step's median leaf's. Taken over the leaves whose first reference
    gradient is at least a thousandth of the median leaf's norm, and in
    each over the elements whose first reference gradient is at least a
    thousandth of the leaf's root mean square: a gradient that is zero
    but for rounding (the bias of the point MLP's last BatchNorm, reached
    only through the global max, where every block's maximum lies on the
    same side of the LeakyReLU: the segmenter's BatchNorm takes the
    blocks' mean of what the max passes back) takes Adam's steps of about
    +-lr / sqrt(v) of either sign and size. Norms, as the GFS driver
    takes them: such steps move the difference of two updates but hardly
    their norms."""
    _, ref_grads, ref_updates = ref
    g_ref = {n: _norm(g) for n, g in ref_grads.items()}
    med = float(np.median(list(g_ref.values())))
    kept = {n: g.abs() >= 1e-3 * g_ref[n] / g.numel() ** 0.5
            for n, g in ref_grads.items() if g_ref[n] >= 1e-3 * med}
    gaps = {}
    for step, (update, ref_update) in enumerate(zip(updates, ref_updates)):
        u_ref = {n: _norm(ref_update[n][k]) for n, k in kept.items()}
        umed = float(np.median(list(u_ref.values())))
        for n, k in kept.items():
            gaps[step, n] = abs(_norm(update[n][k]) - u_ref[n]) / max(
                u_ref[n], umed)
    return gaps


def compare_train(losses, first_moment, updates, initial, ref, graphs):
    """drivers/gfs_train.py::compare_train's numbers, but for change_gap:
    the worst of `change_gaps` over every checked step's update
    (`updates`, the program's, one dict a step). Each step starts from
    the program's state, so an update is that step's alone: two free runs
    part at Adam's first steps, which move each weight by about +-lr
    whatever the size of its gradient, so that a rounding-sized
    gradient's sign decides the step, and the feature kNNs of blocks 2
    and 3 amplify the difference within a few steps (PERF.md). `initial`
    is unused (control.py passes it)."""
    ref_losses, ref_grads, _ = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_ref = {n: _norm(g) for n, g in ref_grads.items()}
    g_prog = {n: _norm(first_moment[n]) / (1.0 - ADAM_BETA1)
              if n in first_moment else 0.0 for n in ref_grads}
    med = float(np.median(list(g_ref.values())))
    grad_gap = max(abs(g_prog[n] - g_ref[n]) / max(g_ref[n], med)
                   for n in g_ref)
    err = sorted(_norm(first_moment[n] / (1.0 - ADAM_BETA1) - ref_grads[n])
                 / max(g_ref[n], med) if n in first_moment else 1.0
                 for n in g_ref)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": max(change_gaps(updates, ref).values()),
            "grad_err_median": err[len(err) // 2],
            "graph_untied": graphs.untied / max(graphs.rows, 1)}
