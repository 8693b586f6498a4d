"""Traffic driver `gfs_train`: base-stage GFS training, `train_gfs`'s inner
loop without its validation, coding sweeps or checkpoints.

Set-up is `train_gfs`'s: blocks written from the seed, the class lists,
the augmented training dataset, the model with seeded weights, Adam in
two groups with its StepLR, a device generator. It then drives that one
training object through its first steps, through the window's own call
and feed: `pipelines/gfs.py::train_batches` (the native C++ pool,
shuffled, augmented, epoch after epoch) into
`parallel/steps.py::gfs_train_step`, the generator seeded per step as
`train_gfs` seeds it; losses are read LOSS_LAG steps late and in full
every `print_freq` steps, as `train_gfs` reads them. The window goes on
with the same object and feed.

What the comparison reads, kept during set-up: the weights before step
1, Adam's first moment after step 1 (the first gradient as the optimizer
got it), the parameters after step 3 (before step 4 moves them), the
three steps' losses and batches.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

import blocks
import weights
from phases import Phases
from reference import data as refdata
from reference import gwcapl

ADAM_BETA1 = 0.9


def step_seed(seed: int, step: int) -> int:
    """The device generator's seed for step `step`, as `train_gfs` draws
    it: a function of (seed, step) alone."""
    return (seed << 32) + step


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
        from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
        from gfs3dseg_gws_tpu_torch.models.layers import use_mesh
        from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
        from gfs3dseg_gws_tpu_torch.pipelines import gfs
        from gfs3dseg_gws_tpu_torch.utils.config import DataConfig, TrainConfig
        cfg, tr, dev = self.cfg, self.traffic, self.device
        disable_tf32()
        clock = Phases(self.phases)
        self.train_dir, _ = blocks.make_blocks(
            os.path.join(self.workdir, "data"), self.seed, tr["train_blocks"],
            tr["train_block_points"], 0, 0, cfg["total_classes"])
        clock("data")
        reg = make_registry(cfg["dataset"], cfg["cvfold"], self.train_dir)
        base = sorted(reg.train_classes)
        augment = DataConfig(
            pc_augm_scale=cfg["pc_augm_scale"], pc_augm_rot=cfg["pc_augm_rot"],
            pc_augm_mirror_prob=cfg["pc_augm_mirror_prob"],
            pc_augm_jitter=cfg["pc_augm_jitter"]).augment_config
        data = PretrainBlockDataset(
            self.train_dir, base, {c: reg.class2scans[c] for c in base},
            mode="train", num_point=cfg["pc_npts"],
            pc_attribs=cfg["pc_attribs"], pc_augm=cfg["pc_augm"],
            pc_augm_config=augment)
        clock("class_lists")
        model = GWCAPL(
            classes=cfg["total_classes"], base_num=len(base),
            num_gw=cfg["num_gw"], main_dim=cfg["main_dim"],
            energy=cfg["energy"], eval_weight=cfg["eval_weight"],
            cosine_scale=cfg["cosine_scale"],
            edgeconv_widths=tuple(tuple(w) for w in cfg["edgeconv_widths"]),
            mlp_widths=tuple(cfg["dgcnn_mlp_widths"]),
            base_widths=tuple(cfg["base_widths"]),
            output_dim=cfg["output_dim"], k=cfg["dgcnn_k"],
            in_features=len(cfg["pc_attribs"]),
            attn_dropout=cfg["attn_dropout"], device=dev)
        self.initial = weights.train_state(model.state_dict(), self.seed, dev)
        model.load_state_dict(self.initial, strict=True)
        model = use_mesh(model, None)
        self.gp = weights.basis(self.seed, cfg["num_gw"], sum(
            w[-1] for w in cfg["edgeconv_widths"]), dev)
        opt, sched = make_gfs_optimizer(
            model, cfg["base_lr"], max(len(data) // tr["batch"], 1),
            cfg["step_size"], cfg["gamma"], cfg["encoder_lr_scale"],
            cfg["weight_decay"])
        if self.fault == "unchanged_state":   # fault: the step moves nothing
            opt.step = lambda *a, **k: None
        self.gfs, self.model, self.opt, self.sched = gfs, model, opt, sched
        self.base_num = len(base)
        self.gen = torch.Generator(device=dev)
        self.print_freq = TrainConfig().print_freq
        self.feed = self._feed(data)
        self.step, self.epoch_steps, self.pending = 0, 0, []
        self.batches, self.losses = [], []
        names = {id(p): n for n, p in model.named_parameters()}
        self.trainable = [n for n, _ in model.named_parameters()]
        clock("model_and_optimizer")
        self.graphs = []
        for i in range(tr["warm_steps"]):
            batch = next(self.feed)
            if i < tr["checked_steps"]:
                self.batches.append((np.array(batch[0], np.float32),
                                     np.array(batch[1], np.int64)))
                with self._record_graphs():
                    self._step(batch)
                self.losses.append(self.pending[-1][0])
            else:
                self._step(batch)
            if i == 0:
                self.first_moment = {
                    names[id(p)]: st["exp_avg"].clone()
                    for p, st in opt.state.items() if "exp_avg" in st}
            if i == tr["checked_steps"] - 1:
                self.after = {n: p.detach().clone()
                              for n, p in model.named_parameters()}
            self._drain()
        self._drain(0)
        clock("first_steps")

    @contextlib.contextmanager
    def _record_graphs(self):
        """Keep the kNN graphs the program's EdgeConvs build (K3 and K6,
        looked up in models/dgcnn.py at call time), in the order built."""
        from gfs3dseg_gws_tpu_torch.models import dgcnn

        stats, indices = dgcnn.knn_with_stats, dgcnn.knn_indices

        def with_stats(*args, **kwargs):
            out = stats(*args, **kwargs)
            self.graphs.append(out[0].clone())
            return out

        def plain(*args, **kwargs):
            idx = indices(*args, **kwargs)
            self.graphs.append(idx.clone())
            return idx

        dgcnn.knn_with_stats, dgcnn.knn_indices = with_stats, plain
        try:
            yield
        finally:
            dgcnn.knn_with_stats, dgcnn.knn_indices = stats, indices

    def _feed(self, data):
        """Epoch after epoch of the native pool's batches; at each epoch's
        end every loss is read, as `train_gfs` reads them there."""
        epoch = 0
        while True:
            self.epoch_steps = 0
            yield from self.gfs.train_batches(data, self.traffic["batch"],
                                              seed=self.seed, epoch=epoch)
            self._drain(0)
            epoch += 1

    def _step(self, batch):
        points = np.asarray(batch[0], np.float32)
        labels = np.asarray(batch[1], np.int64)
        if self.fault == "half_batch":        # fault: half the batch left out
            points, labels = points[:len(points) // 2], \
                labels[:len(labels) // 2]
        self.gen.manual_seed(step_seed(self.seed, self.step))
        self.pending.append(self.gfs.gfs_train_step(
            self.model, self.opt, torch.from_numpy(points).to(self.device),
            torch.from_numpy(labels).to(self.device), self.gp, self.gen,
            self.sched))
        self.step += 1
        self.epoch_steps += 1

    def _drain(self, keep=None):
        """Read the losses as `train_gfs` does: all of them every
        `print_freq` steps, else those LOSS_LAG steps old."""
        if keep is None:
            keep = 0 if self.epoch_steps % self.print_freq == 0 else \
                self.gfs.LOSS_LAG
        while len(self.pending) > keep:
            loss, acc = self.pending.pop(0)
            float(loss)
            float(acc)

    def window(self, seconds, tracer=None):
        tr = self.traffic
        loader = (lambda: tracer.span("train.loader")) if tracer else \
            contextlib.nullcontext
        stepper = (lambda: tracer.span("train.step")) if tracer else \
            contextlib.nullcontext
        steps, traced = 0, tracer is None
        t0 = time.perf_counter()
        while True:
            tracing = not traced and steps == tr["trace_skip_steps"]
            ctx = tracer.stretch(self.device) if tracing \
                else contextlib.nullcontext()
            with ctx:
                for _ in range(tr["trace_steps"] if tracing else 1):
                    with loader():
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
            s.blocks, s.cfg = tr["trace_steps"] * tr["batch"], self.cfg
        return {"attempted": steps, "failed": 0, "metrics": {
            "train_blocks_per_s": steps * tr["batch"] / (end - t0)}}

    def release(self):
        """Free the program's state; keep what set-up kept for the check."""
        self.losses = [float(v) for v in self.losses]
        del self.model, self.opt, self.sched, self.feed
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """The numbers compared with the plain reference's first steps:
        loss_gap, the largest relative gap of a step's loss; grad_gap, by
        the worst leaf, the gap between the norms of the first gradient
        (the program's from Adam's first moment after one step) against
        the larger of the reference's norm of that leaf and of the median
        leaf; change_gap, the same of the parameters' change after the
        checked steps, over the leaves whose reference gradient is at
        least a thousandth of the median leaf's; grad_err_median, the
        median leaf's norm of the first gradient's difference from the
        reference's, on the same scale (it sees a lower precision's
        rounding in every product, where the norms' gaps average it out);
        graph_untied, the share of the program's kNN graph rows that
        differ from the reference's by more than a near-tie
        (reference.gwcapl.Graphs: the reference takes the program's rows
        at near-ties, so that a neighbour flipped by rounding does not
        move the other numbers); loader_rows_unmatched,
        the rows of the checked batches that are not a sample of a
        distinct training block (exact)."""
        graphs = gwcapl.Graphs(self.graphs)
        self.reference = self.reference_steps("fp32", graphs)
        numbers = compare_train(self.losses, self.first_moment, self.after,
                                self.initial, self.reference, graphs)
        self.notes = {"graph_rows_differing": graphs.differing,
                      "graph_rows": graphs.rows}
        numbers["loader_rows_unmatched"] = float(refdata.unmatched_rows(
            self.train_dir, self.batches, self.cfg))
        return numbers


    def reference_steps(self, mode: str, graphs: gwcapl.Graphs):
        """The reference's checked steps from the same weights, batches and
        per-step seeds, its products in `mode` ('fp32', or the control's
        'tf32'), its kNN graphs through `graphs`."""
        dev = self.device
        batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
                   for x, y in self.batches]
        with gwcapl.precision(mode):
            return gwcapl.train_steps(
                self.initial, self.trainable, self.cfg, batches, self.gp,
                self.base_num,
                [step_seed(self.seed, i) for i in range(len(batches))],
                graphs)


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def compare_train(losses, first_moment, after, initial, ref, graphs):
    ref_losses, ref_grads, ref_after = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_ref = {n: _norm(g) for n, g in ref_grads.items()}
    g_prog = {n: _norm(first_moment[n]) / (1.0 - ADAM_BETA1)
              if n in first_moment else 0.0 for n in ref_grads}
    med = float(np.median(list(g_ref.values())))
    grad_gap = max(abs(g_prog[n] - g_ref[n]) / max(g_ref[n], med)
                   for n in g_ref)
    moved = [n for n in g_ref if g_ref[n] >= 1e-3 * med]
    d_ref = {n: _norm(ref_after[n] - initial[n]) for n in moved}
    d_prog = {n: _norm(after[n] - initial[n]) for n in moved}
    dmed = float(np.median(list(d_ref.values())))
    change_gap = max(abs(d_prog[n] - d_ref[n]) / max(d_ref[n], dmed)
                     for n in moved)
    err = sorted(_norm(first_moment[n] / (1.0 - ADAM_BETA1) - ref_grads[n])
                 / max(g_ref[n], med) if n in first_moment else 1.0
                 for n in g_ref)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_err_median": err[len(err) // 2],
            "graph_untied": graphs.untied / max(graphs.rows, 1)}
