"""Traffic driver `eval_sweep`: the paper's `--only_evaluate`, repeated.

Set-up is `evaluate_gfs`'s: blocks written from the seed, the data's
caches (class lists, static test set, support shots), the model with
seeded weights, the base-coding sweep over the training blocks
(`collect_base_codings`), novel prototypes registered for every support
seed (`register_novel_protos`) and one warm sweep. The window then calls
`pipelines/gfs.py::validate_multi` over the static test set again and
again, one client in a closed loop; each sweep ends when its confusion
counts reach the host.

What the window produced and the comparison reads: every sweep's
confusion counts (each batch's, as `gfs_eval_multi_step` returns them)
and, for each batch position, the logits of one sweep drawn from the
seed among the first `sample_sweeps`.
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


def p95(values):
    """The nearest-rank 95th percentile: the smallest value with at least
    95% of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(int(np.ceil(0.95 * len(ordered))) - 1, 0)]


class Driver:
    kind = "eval"

    def __init__(self, cfg, traffic, seed, device, workdir, fault=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir, self.fault = device, workdir, fault
        self.phases, self.notes = {}, {}

    # ------------------------------------------------------------------ #
    def setup(self):
        from gfs3dseg_gws_tpu_torch.cli.common import disable_tf32
        from gfs3dseg_gws_tpu_torch.pipelines import gfs
        from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig,
                                                         ModelConfig,
                                                         TrainConfig)
        cfg, tr = self.cfg, self.traffic
        disable_tf32()
        clock = Phases(self.phases)
        self.train_dir, self.test_dir = blocks.make_blocks(
            os.path.join(self.workdir, "data"), self.seed, tr["train_blocks"],
            tr["train_block_points"], tr["test_blocks"],
            tr["test_block_points"], cfg["total_classes"])
        clock("data")
        widths = tuple(tuple(w) for w in cfg["edgeconv_widths"])
        model_cfg = ModelConfig(
            pc_attribs=cfg["pc_attribs"], pc_npts=cfg["pc_npts"],
            dgcnn_k=cfg["dgcnn_k"], edgeconv_widths=widths,
            dgcnn_mlp_widths=tuple(cfg["dgcnn_mlp_widths"]),
            base_widths=tuple(cfg["base_widths"]),
            output_dim=cfg["output_dim"], attn_dropout=cfg["attn_dropout"],
            main_dim=cfg["main_dim"], cosine_scale=cfg["cosine_scale"])
        data_cfg = DataConfig(
            dataset=cfg["dataset"], cvfold=cfg["cvfold"],
            data_path=self.train_dir, testing_data_path=self.test_dir,
            total_classes=cfg["total_classes"], k_shot=tr["k_shot"],
            pc_npts=cfg["pc_npts"], pc_attribs=cfg["pc_attribs"],
            support_seeds=tuple(tr["support_seeds"]))
        train_cfg = TrainConfig(
            batch_size=tr["batch"], energy=cfg["energy"],
            eval_weight=cfg["eval_weight"], num_cnt=cfg["num_gw"],
            only_evaluate=True, device=str(self.device))
        self.gp = weights.basis(self.seed, cfg["num_gw"],
                                sum(w[-1] for w in widths), self.device)
        setup = gfs.build_setup(model_cfg, data_cfg, train_cfg,
                                self.gp.cpu().numpy(), self.device)
        model = setup.model
        self.state = weights.eval_state(model.state_dict(), self.seed,
                                        self.device)
        model.load_state_dict(self.state, strict=True)
        clock("caches_and_weights")
        n_base = len(setup.train_class_names)
        base_coding, _ = gfs.collect_base_codings(
            model, setup.gp, setup.train_data_noaug, n_base, cfg["energy"],
            tr["batch"])
        clock("coding_sweep")
        main_proto = model.main_proto.detach().cpu().numpy()
        geneds, novels = [], []
        for supp in setup.supp_datasets:
            g, c = gfs.register_novel_protos(
                model, setup.gp, supp, main_proto, n_base,
                setup.test_learning_order_idx, cfg["energy"])
            geneds.append(g)
            novels.append(c)
        self.n_blocks = len(setup.val_dataset)
        self.n_batches = -(-self.n_blocks // tr["batch"])
        self.codings = np.stack([np.concatenate([base_coding, c])
                                 for c in novels])
        self.sweep_args = (model, setup.gp, setup.val_dataset,
                           np.stack(geneds), base_coding, np.stack(novels),
                           setup.all_learning_order, setup.test_class_names,
                           len(setup.all_class_names), tr["batch"])
        self.gfs, self.model, self.setup_obj = gfs, model, setup
        rng = np.random.default_rng(self.seed)
        self.plan = rng.integers(0, tr["sample_sweeps"], self.n_batches)
        clock("registration")
        self._sweep()                                     # the warm sweep
        clock("warm_sweep")

    def _sweep(self):
        return self.gfs.validate_multi(*self.sweep_args)

    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def _capture(self, tracer):
        """Keep what the timed path produces: each batch's confusion
        counts, and the logits of the planned sweep of each batch
        position. With a tracer, a span around each batch's load."""
        gfs, model = self.gfs, self.model
        step, evaluate, batches = (gfs.gfs_eval_multi_step,
                                   model.evaluate_multi, gfs.eval_batches)
        self.cms, self.logits, calls = [], {}, [0]
        half = self.fault == "half_batch"

        def capture_step(m, points, labels, *rest):
            if half:        # fault: half of the batch left out
                b = points.shape[0] // 2
                points, labels = points[:b], labels[:b]
                rest = rest[:4] + (min(rest[4], b),) + rest[5:]
            out = step(m, points, labels, *rest)
            self.cms.append(out[0])
            return out

        def capture_logits(*args, **kwargs):
            out = evaluate(*args, **kwargs)
            sweep, b = divmod(calls[0], self.n_batches)
            calls[0] += 1
            if self.fault == "altered_answer":   # fault: an altered answer
                out = (out[0].clone(),) + tuple(out[1:])
                out[0][:, 0] = out[0][:, 0].roll(1, dims=-1)
            if sweep == self.plan[b]:
                self.logits[b] = out[0]
            return out

        def traced_batches(*args, **kwargs):
            it = batches(*args, **kwargs)
            while True:
                with tracer.span("eval.loader"):
                    item = next(it, None)
                if item is None:
                    return
                yield item

        gfs.gfs_eval_multi_step = capture_step
        model.evaluate_multi = capture_logits
        if tracer is not None:
            gfs.eval_batches = traced_batches
        try:
            yield
        finally:
            gfs.gfs_eval_multi_step, gfs.eval_batches = step, batches
            del model.evaluate_multi

    def window(self, seconds, tracer=None):
        tr = self.traffic
        times, sweeps, traced = [], 0, tracer is None
        with self._capture(tracer):
            t0 = time.perf_counter()
            while True:
                tracing = not traced and sweeps == tr["trace_skip_sweeps"]
                ctx = tracer.stretch(self.device) if tracing \
                    else contextlib.nullcontext()
                with ctx:
                    for _ in range(tr["trace_sweeps"] if tracing else 1):
                        ts = time.perf_counter()
                        self._sweep()
                        end = time.perf_counter()
                        times.append(end - ts)
                        sweeps += 1
                traced = traced or tracing
                if end - t0 >= seconds and traced and \
                        sweeps >= tr["sample_sweeps"]:
                    break
        if tracer is not None:
            s = tracer.summarize()
            s.blocks, s.cfg = tr["trace_sweeps"] * self.n_blocks, self.cfg
        return {"attempted": sweeps, "failed": 0, "metrics": {
            "eval_blocks_per_s": sweeps * self.n_blocks / (end - t0),
            "eval_sweep_ms_p95": 1e3 * p95(times)}}

    def release(self):
        """Free the program's state; keep what the window produced."""
        self.cms = torch.stack(self.cms).double().cpu()
        del self.sweep_args, self.model, self.setup_obj
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def check(self):
        """The numbers compared with the plain reference (reference/):
        logit_miss, the share of (seed, point) logit rows of the sampled
        sweeps off the reference's by more than 1e-3 (1 + |reference|);
        label_count_gap, over every sweep and seed, the points whose
        label count differs from the reference's (exact). `notes` gets
        how many entries of the classes' word codings differ from the
        reference's (a diagnostic, not compared)."""
        cfg, tr = self.cfg, self.traffic
        with gwcapl.precision("fp32"):
            self.reference = reference_eval(
                self.state, self.gp, cfg, tr, self.train_dir, self.test_dir,
                self.device)
        self.notes = {"coding_entries_differing": int(
            (self.codings != self.reference[2]).sum())}
        return compare_eval(self, cfg, tr, self.reference)


def reference_eval(state, gp, cfg, tr, train_dir, test_dir, device,
                   batches=None):
    """The reference's logits of every test block (or of the block
    batches listed) for every support seed, from the raw blocks, the
    weights and the basis alone. Returns (labels (M, N), logits by batch
    position {b: (S, B, N, cls)}, the classes' codings (S, cls, K))."""
    p = {k: v.detach().clone() for k, v in state.items()}
    names = refdata.read_classnames(train_dir)
    split = refdata.Split(names, cfg["cvfold"])
    c2s = refdata.class2scans(train_dir, len(names))
    points, labels = refdata.static_test(test_dir, cfg["pc_npts"],
                                         split.order, tr["static_seed"])
    base = refdata.base_coding(p, cfg, train_dir, c2s, split, gp,
                               tr["batch"])
    protos, codings = [], []
    for s in tr["support_seeds"]:
        shots = refdata.support_shots(train_dir, c2s, split.novel,
                                      tr["k_shot"], cfg["pc_npts"], s)
        g, c = refdata.register(p, cfg, shots, split, gp)
        protos.append(g)
        codings.append(np.concatenate([base, c]))
    protos = torch.from_numpy(np.stack(protos)).to(device)
    codings = torch.from_numpy(np.stack(codings)).to(device)
    n_batches = -(-points.shape[0] // tr["batch"])
    out = {}
    for b in range(n_batches) if batches is None else batches:
        x = torch.from_numpy(points[b * tr["batch"]:(b + 1) * tr["batch"]])
        out[b] = gwcapl.eval_logits(p, cfg, x.to(device), gp, protos,
                                    codings, len(split.base))
    return labels, out, codings.cpu().numpy()


def compare_eval(drv, cfg, tr, ref):
    labels, ref_logits, _ = ref
    n_cls, bsz = cfg["total_classes"], tr["batch"]
    misses, total = 0, 0
    counts_ref = torch.zeros((n_cls,), dtype=torch.float64)
    for b, r in ref_logits.items():
        y = labels[b * bsz:(b + 1) * bsz]
        counts_ref += torch.from_numpy(np.bincount(
            y.reshape(-1), minlength=n_cls)).double()
        got = drv.logits.get(b)
        if got is not None:             # a final batch's padding rows
            got = got[:, :r.shape[1]]
        rows = r.shape[0] * r.shape[1] * r.shape[2]
        total += rows
        if got is None or got.shape != r.shape:
            misses += rows
            continue
        off = (got.to(r.device) - r).abs() > 1e-3 * (1.0 + r.abs())
        misses += int(off.any(-1).sum())
    if drv.cms.shape[0] % drv.n_batches == 0:
        sweeps = drv.cms.reshape(-1, drv.n_batches,
                                 *drv.cms.shape[1:]).sum(1)
        label_gap = float((sweeps.sum(-1) - counts_ref).abs().sum(-1).max())
    else:                               # a sweep cut short
        label_gap = float(labels.size)
    return {"logit_miss": misses / max(total, 1),
            "label_count_gap": label_gap}
