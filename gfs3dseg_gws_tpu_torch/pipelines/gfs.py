"""Generalized few-shot training and evaluation (counterpart of the JAX
package's pipelines/gfs.py; reference train.py:309-588, 666-731).

`train_gfs` (`train.py`) trains the GW/CAPL model on the base classes:
every epoch (re)codes the base classes when due, runs the training batches
through `gfs_train_step`, validates on support seed 0 every
`eval_interval` epochs and keeps the best checkpoints (`_maybe_save`).

`evaluate_gfs` (`train.py --only_evaluate`) does four things:
  1. collect base-class geometric-word codings over the train split
     (`collect_base_codings`), unless a saved coding is found;
  2. register novel prototypes from each support seed
     (`register_novel_protos`);
  3. run one static_test sweep that scores every seed's prototype set
     (`validate_multi`, `GWCAPL.evaluate_multi`);
  4. reduce to base, novel, mean and harmonic-mean mIoU (`gfs_miou`).

The host data layer (datasets, registry, native C++ loader) is the port's
own copy of the JAX package's numpy-only one (`gfs3dseg_gws_tpu_torch.data`).

Both entry points take a `mesh` (parallel/mesh.py) for data parallelism,
as the JAX pipelines take theirs: every rank reads the same global
batches and keeps its rows, the sweeps' sums and confusion counts are
all-reduced, and only rank 0 logs, writes metrics and saves. The global
batch (and the sweeps' batch) must divide by the number of ranks along
`data`. On a `data x points` mesh (`--mesh dxp --mesh_sp S`) the two
sweeps of the evaluation (`collect_base_codings`, `validate_multi`) also
cut every block's points S ways (`shard_points`, `points_split`); the
registration of the support shots stays replicated at full N, as in JAX,
and `train_gfs` runs on the data mesh of all the ranks, as JAX's ignores
the mesh shape.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gfs3dseg_gws_tpu_torch.data import (
    PretrainBlockDataset,
    TestingDataset,
    ValSuppDataset,
    batch_iterator,
    make_registry,
    native_loader,
)
from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
from gfs3dseg_gws_tpu_torch.models.layers import l2norm, use_mesh
from gfs3dseg_gws_tpu_torch.ops.coding import energy_multihot
from gfs3dseg_gws_tpu_torch.ops.metrics import gfs_miou
from gfs3dseg_gws_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                                  is_main, local_rows,
                                                  local_valid, main_first,
                                                  points_split, replicate,
                                                  shard_batch, shard_points)
from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
from gfs3dseg_gws_tpu_torch.parallel.steps import (coding_step, fg_feat_step,
                                                   gfs_eval_multi_step,
                                                   gfs_train_step)
from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
    load_basis,
    load_checkpoint,
    load_pretrained_encoder,
    load_torch_coding,
    load_torch_gfs_state_dict,
    load_train_state,
    save_gfs_npz,
    save_train_state,
    state_dict_from_jax,
)
from gfs3dseg_gws_tpu_torch.utils.logging import (AverageMeter, IOStream,
                                                  Silent, init_logger)
from gfs3dseg_gws_tpu_torch.utils.observability import (MetricsWriter,
                                                        count, span, trace)

_log = logging.getLogger(__name__)

# training losses stay on the device this many steps before the host reads
# them, so reading one never waits for the step just queued (JAX: drain(16))
LOSS_LAG = 16
# steps of the first epoch under `trace_dir`'s profiler, from step LOSS_LAG
TRACE_STEPS = 24


def resolve_device(name: str) -> torch.device:
    """torch.device(name); a CUDA device without CUDA raises rather than
    quietly running on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available (use --device cpu for the plain path)")
    return device


def _env_flag(name: str) -> bool:
    """Same reading as the JAX package's utils/env.py::env_flag."""
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "no", "off")


def _to(device: torch.device, array, dtype=None) -> torch.Tensor:
    """A host array copied to `device`, as `dtype` if one is given: one
    host copy (`np.array`), then a pageable `.to` (span `h2d`, its bytes
    counted as `h2d_bytes`). Every pipeline's copies of its batches and
    arrays to the device come through here."""
    with span("h2d"):
        host = np.array(array, dtype)
        out = torch.from_numpy(host).to(device)
    count("h2d_bytes", host.nbytes)
    return out


def run_logs(log_dir: str, phase: str, logger: Optional[IOStream],
             mesh: Optional[Mesh]):
    """(logger, metrics writer) of a run: the log file and metrics.jsonl
    under `log_dir` on rank 0 (or the only process), `Silent` on the other
    ranks, which write nothing there."""
    if not is_main(mesh):
        return Silent(), Silent()
    logger = logger or init_logger(log_dir, phase=phase)
    if mesh is not None:
        logger.cprint(f"---- {mesh} ----")
    return logger, MetricsWriter(log_dir)


# --------------------------------------------------------------------------- #
# setup
# --------------------------------------------------------------------------- #

@dataclass
class GFSSetup:
    model: GWCAPL
    gp: torch.Tensor
    train_class_names: List[int]
    test_class_names: List[int]
    all_learning_order: List[int]
    all_class_names: List[int]
    test_learning_order_idx: List[int]
    val_dataset: TestingDataset
    supp_datasets: List[ValSuppDataset]
    train_data: PretrainBlockDataset
    train_data_noaug: PretrainBlockDataset


def build_setup(model_cfg, data_cfg, train_cfg, basis: np.ndarray,
                device: torch.device) -> GFSSetup:
    """Datasets + class orderings exactly as reference train.py:328-415,
    and an eval-mode GWCAPL on `device` (weights still to be loaded)."""
    reg_test = make_registry(data_cfg.dataset, data_cfg.cvfold,
                             data_cfg.testing_data_path)
    train_class_names = sorted(reg_test.train_classes)
    test_class_names = sorted(reg_test.test_classes)
    all_learning_order = train_class_names + test_class_names
    all_class_names = sorted(all_learning_order)
    test_learning_order_idx = [all_learning_order.index(c)
                               for c in test_class_names]

    test_c2s = {c: reg_test.class2scans[c] for c in all_class_names}
    val_dataset = TestingDataset(
        data_cfg.testing_data_path, all_class_names, all_learning_order,
        test_c2s, mode="test", num_point=data_cfg.pc_npts,
        pc_attribs=data_cfg.pc_attribs)

    reg_train = make_registry(data_cfg.dataset, data_cfg.cvfold,
                              data_cfg.data_path)
    supp_datasets = [
        ValSuppDataset(data_cfg.data_path, data_cfg.dataset,
                       cvfold=data_cfg.cvfold, k_shot=data_cfg.k_shot,
                       mode="test", num_point=data_cfg.pc_npts,
                       pc_attribs=data_cfg.pc_attribs, seed=seed,
                       learning_order=all_learning_order, registry=reg_train)
        for seed in data_cfg.support_seeds
    ]
    train_c2s = {c: reg_train.class2scans[c] for c in train_class_names}
    train_data = PretrainBlockDataset(
        data_cfg.data_path, train_class_names, train_c2s, mode="train",
        num_point=data_cfg.pc_npts, pc_attribs=data_cfg.pc_attribs,
        pc_augm=data_cfg.pc_augm, pc_augm_config=data_cfg.augment_config)
    train_data_noaug = PretrainBlockDataset(
        data_cfg.data_path, train_class_names, train_c2s, mode="train",
        num_point=data_cfg.pc_npts, pc_attribs=data_cfg.pc_attribs,
        pc_augm=False)

    model = GWCAPL(
        classes=len(all_class_names), base_num=len(train_class_names),
        num_gw=basis.shape[0], main_dim=model_cfg.main_dim,
        energy=train_cfg.energy, eval_weight=train_cfg.eval_weight,
        cosine_scale=model_cfg.cosine_scale,
        edgeconv_widths=model_cfg.edgeconv_widths,
        mlp_widths=model_cfg.dgcnn_mlp_widths,
        base_widths=model_cfg.base_widths, output_dim=model_cfg.output_dim,
        k=model_cfg.dgcnn_k, in_features=model_cfg.pc_in_dim,
        attn_dropout=model_cfg.attn_dropout, device=device)
    return GFSSetup(model, _to(device, basis), train_class_names,
                    test_class_names, all_learning_order, all_class_names,
                    test_learning_order_idx, val_dataset, supp_datasets,
                    train_data, train_data_noaug)


def init_model(setup: GFSSetup, seed: int) -> GWCAPL:
    """setup.model with the JAX package's initialisers drawn from a CPU
    generator seeded `seed` (JAX: init_variables); the same seed gives the
    same weights on every device."""
    return setup.model.train_init(torch.Generator().manual_seed(seed))


def load_model_weights(model: GWCAPL, path: str) -> None:
    """A reference-layout `.pth`/`.tar`, or a JAX-package or port `.npz`
    through the converter, into `model` (strict: every key must match)."""
    if path.endswith((".pth", ".tar")):
        sd = load_torch_gfs_state_dict(path)
    else:
        flat, _ = load_checkpoint(path)
        sd = state_dict_from_jax(flat)
    model.load_state_dict(sd, strict=True)


# --------------------------------------------------------------------------- #
# coding collection / prototype registration
# --------------------------------------------------------------------------- #

def _coding_batches(dataset, batch_size: int, seed: int):
    """Ordered full-coverage batches (points, labels, segment, valid) for the
    coding sweep: the native C++ pool when it is available (the JAX
    package's choice, so both draw the same blocks), padded final batch
    either way."""
    if not _env_flag("GFS3D_NO_NATIVE") and native_loader.is_available():
        pool = native_loader.NativeBatchPool(
            dataset.data_path, dataset.block_names, dataset.classes,
            dataset.num_point, batch_size,
            label_mode=(native_loader.LABEL_ALL_CLASSES
                        if dataset.use_all_classes
                        else native_loader.LABEL_LEARNING_ORDER),
            augment=False, seed=seed, shuffle=False)
        try:
            yield from pool
        finally:
            pool.close()
        return
    yield from batch_iterator(dataset, batch_size, shuffle=False,
                              pad_final=True, seed=seed)


def train_batches(dataset, batch_size: int, seed: int, epoch: int):
    """Shuffled training batches (points, labels, segment) over a block
    dataset, the final short batch dropped, as the JAX package's
    pipelines/gfs.py::train_batches draws them: the native C++ pool
    (threaded parsing, sampling and augmentation) when it is available,
    else the Python iterator; so the same seed and epoch give the same
    batches. GFS3D_NO_NATIVE=1 turns the native pool off."""
    if not _env_flag("GFS3D_NO_NATIVE") and native_loader.is_available():
        pool = native_loader.NativeBatchPool(
            dataset.data_path, dataset.block_names, dataset.classes,
            dataset.num_point, batch_size,
            label_mode=(native_loader.LABEL_ALL_CLASSES
                        if dataset.use_all_classes
                        else native_loader.LABEL_LEARNING_ORDER),
            augment=dataset.pc_augm, aug_config=dataset.pc_augm_config,
            seed=seed * 10_007 + epoch, shuffle=True)
        try:
            for pts, lbl, seg, valid in pool:
                if valid < batch_size:
                    continue
                yield pts, lbl, seg
        finally:
            pool.close()
        return
    for batch in batch_iterator(dataset, batch_size, shuffle=True,
                                drop_last=True, seed=seed, epoch=epoch):
        yield batch[0], batch[1], batch[2]


def collect_base_codings(model, gp: torch.Tensor, dataset, n_base: int,
                         energy: float, batch_size: int = 16,
                         seed: int = 0, mesh: Optional[Mesh] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference train.py:156-218: one sweep over the no-augmentation train
    set. Returns (base_class_coding (n_base, K) multi-hot,
    bg_class_coding (K,)). With a mesh each rank codes its rows of every
    batch that lie before the batch's `valid` (on a `data x points` mesh
    its points of them: the ranks of a points group share their rows and
    skip a batch together), and the sums are all-reduced."""
    device = gp.device
    k = gp.shape[0]
    sums = torch.zeros((n_base, k), dtype=torch.float64, device=device)
    counts = torch.zeros((n_base,), dtype=torch.float64, device=device)
    bg_sum = torch.zeros((k,), dtype=torch.float64, device=device)
    bg_blocks = torch.zeros((), dtype=torch.float64, device=device)
    rows = local_rows(batch_size, mesh)
    with points_split(model, mesh):
        for batch in _coding_batches(dataset, batch_size, seed):
            valid = local_valid(int(batch[-1]), batch_size, mesh)
            if valid == 0:   # this rank's rows are all padding (no step of
                continue     # this sweep reaches a rank of another row)
            points = shard_points(batch[0][rows][:valid], mesh)
            labels = shard_points(batch[1][rows][:valid], mesh)
            s, c, b, nb = coding_step(model, _to(device, points),
                                      _to(device, labels), gp, n_base)
            sums += s.double()
            counts += c.double()
            bg_sum += b.double()
            bg_blocks += nb.double()
    if mesh is not None:
        flat = all_reduce_sum(torch.cat([sums.reshape(-1), counts, bg_sum,
                                         bg_blocks[None]]), mesh)
        sums, counts, bg_sum, bg_blocks = torch.split(
            flat, [sums.numel(), n_base, k, 1])
        sums, bg_blocks = sums.reshape(n_base, k), bg_blocks[0]
    means = (sums / torch.clamp_min(counts[:, None], 1.0)).cpu().numpy()
    coding = energy_multihot(torch.from_numpy(means).float(), energy)
    # the reference means a random 2000-subset of the per-block bg features
    # (train.py:214-215); the bg coding is dead in the reference model (its
    # only consumer is commented out, capl.py:206), so the deterministic
    # full mean is kept, as in the JAX package
    bg_coding = (bg_sum / torch.clamp_min(bg_blocks, 1.0)).cpu().numpy()
    return coding.numpy().astype(np.float32), bg_coding.astype(np.float32)


def register_novel_protos(model, gp: torch.Tensor, supp_dataset,
                          main_proto: np.ndarray, base_num: int,
                          novel_class_list: Sequence[int], energy: float
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference train.py:240-305 (get_new_proto_Geo2SemProto).

    Novel prototype = mean over shots of per-shot foreground means (eqn.1);
    base rows copy main_proto; rows L2-normalised. Novel coding = summed
    word histograms -> probability -> energy multi-hot. All shots of the
    seed run as one batch.
    """
    device = gp.device
    k = gp.shape[0]
    shots = [supp_dataset[i] for i in range(len(supp_dataset))]
    pcds = np.stack([s[0] for s in shots])                 # (S, N, 9)
    masks = np.stack([s[1] for s in shots])                # (S, N)
    classes = [int(s[2]) for s in shots]
    fg_sums, fg_cnts, gw_hists = (
        t.cpu().numpy() for t in fg_feat_step(model, _to(device, pcds),
                                              _to(device, masks), gp))

    feat_acc: Dict[int, List[np.ndarray]] = {c: [] for c in novel_class_list}
    hist_acc: Dict[int, np.ndarray] = {c: np.zeros(k) for c in novel_class_list}
    for i, cls in enumerate(classes):
        feat_acc[cls].append(fg_sums[i] / max(float(fg_cnts[i]), 1e-12))
        hist_acc[cls] += gw_hists[i]

    gened = np.zeros_like(main_proto)
    gened[:base_num] = main_proto[:base_num]
    for c in novel_class_list:
        gened[c] = np.mean(np.stack(feat_acc[c]), axis=0)
    gened = l2norm(torch.from_numpy(gened)).numpy()

    novel_codings = []
    for c in sorted(novel_class_list):
        h = hist_acc[c] / hist_acc[c].sum()
        novel_codings.append(
            energy_multihot(torch.from_numpy(h).float(), energy).numpy())
    return gened.astype(np.float32), np.stack(novel_codings).astype(np.float32)


# --------------------------------------------------------------------------- #
# the static_test sweep
# --------------------------------------------------------------------------- #

def eval_batches(val_dataset, batch_size: int):
    """(points (B,N,C) f32, labels (B,N) learning order, valid) batches of
    the static_test sweep, the final batch padded by repeating its first
    block.

    Reads the packed memmap cache (TestingDataset.packed_arrays: one slice
    plus a label lookup per batch); where the cache cannot be built (e.g. a
    read-only dataset mount) it falls back to the per-block pickle iterator,
    which yields the same arrays.
    """
    try:
        arrays = val_dataset.packed_arrays()
    except (OSError, ValueError) as e:
        _log.warning("packed eval cache unavailable (%s); falling back to "
                     "the per-block pickle iterator", e)
        arrays = None
    if arrays is None:
        for batch in batch_iterator(val_dataset, batch_size, shuffle=False,
                                    pad_final=True):
            yield batch[0], batch[1], int(batch[-1])
        return
    pcd, lbl_mm, lut = arrays
    for s in range(0, lbl_mm.shape[0], batch_size):
        points = np.asarray(pcd[s:s + batch_size])
        labels = lut[np.asarray(lbl_mm[s:s + batch_size])]
        valid = labels.shape[0]
        if valid < batch_size:
            pad = batch_size - valid
            points = np.concatenate([points, np.repeat(points[:1], pad, 0)])
            labels = np.concatenate([labels, np.repeat(labels[:1], pad, 0)])
        yield points, labels, valid


def validate_multi(model, gp: torch.Tensor, val_dataset,
                   gened_protos: np.ndarray, base_coding: np.ndarray,
                   novel_codings: np.ndarray, all_learning_order,
                   novel_class_names, num_classes: int, batch_size: int = 16,
                   scannet: bool = False, logger: Optional[IOStream] = None,
                   mesh: Optional[Mesh] = None):
    """One static_test sweep evaluating S prototype sets at once.
    Returns a list of S (mean, base, novel, hm, iou_list) tuples.

    The confusion counts and gp accuracies stay on the device until the
    sweep ends, so no batch waits on a host round trip. With a mesh each
    rank scores its rows of every batch (rows past `valid` count nowhere;
    on a `data x points` mesh its points of them) and the counts are
    all-reduced at the end; so are the numerators and point counts of
    each batch's gp accuracies, which are divided after the reduction, so
    that the log reads what one process logs.
    """
    with span("sweep"):
        device = gp.device
        n_seeds = gened_protos.shape[0]
        protos = _to(device, gened_protos)
        base = _to(device, base_coding)
        novel = _to(device, novel_codings)
        cm = torch.zeros((n_seeds, num_classes, num_classes),
                         dtype=torch.float64, device=device)
        accs = []
        batches = eval_batches(val_dataset, batch_size)
        with points_split(model, mesh):
            while True:
                with span("sweep.load"):
                    batch = next(batches, None)
                if batch is None:
                    break
                points, labels, valid = batch
                valid = local_valid(valid, batch_size, mesh)
                labels = shard_points(shard_batch(np.asarray(labels), mesh),
                                      mesh)
                points = shard_points(shard_batch(points, mesh), mesh)
                c, gp_acc, gp_nacc = gfs_eval_multi_step(
                    model, _to(device, points), _to(device, labels), gp,
                    protos, base, novel, valid, num_classes)
                cm += c.double()
                acc = torch.stack([gp_acc.mean(), gp_nacc.mean()])
                if mesh is not None:  # numerators, counts: all, novel
                    real = labels[:valid]
                    n = acc.new_tensor([real.size,
                                        np.sum(real >= model.base_num)])
                    acc = torch.cat([acc * n, n])
                accs.append(acc)
        with span("sweep.tail"):   # counts to the host, mIoU
            cm = all_reduce_sum(cm, mesh).cpu().numpy()
            accs = torch.stack(accs)
            if mesh is not None:
                accs = all_reduce_sum(accs, mesh)
                accs = accs[:, :2] / torch.clamp_min(accs[:, 2:], 1.0)
            if logger:
                gp_acc_m, gp_nacc_m = AverageMeter(), AverageMeter()
                for a, na in accs.cpu().tolist():
                    gp_acc_m.update(a)
                    gp_nacc_m.update(na)
                logger.cprint(f"---------- gp acc: {gp_acc_m.avg:.4f}, "
                              f"gp_novel_acc: {gp_nacc_m.avg:.4f} ----------")
            return [gfs_miou(cm[s], all_learning_order, novel_class_names,
                             scannet=scannet) for s in range(n_seeds)]


def _eval_batch_size(train_cfg) -> int:
    """Evaluation sweep batch: results are batch-invariant (per-block
    forward + padded confusion masking); 0 = the training batch size."""
    return train_cfg.eval_batch_size or train_cfg.batch_size


def load_base_coding(save_path: str, energy: float,
                     extra_dirs: Sequence[str] = (),
                     logger: Optional[IOStream] = None,
                     prefixes: Sequence[str] = ("",)
                     ) -> Optional[np.ndarray]:
    """Locate a saved base-class coding artifact (the JAX package's
    `.npz`, or the reference's `base_class_gp_coding_energy={e}.pth`,
    train.py:466-467).

    The search is directory-major: `extra_dirs` (e.g. the checkpoint's
    directory) come before `save_path`; within a directory `.npz` wins over
    `.pth`; `prefixes` are tried in order (("hm_", "") for best-hm
    checkpoints, reference train.py:582-584). None if nothing is found.
    """
    dirs = []
    for d in list(extra_dirs) + [save_path]:
        if d and d not in dirs:
            dirs.append(d)
    for d in dirs:
        for pref in prefixes:
            for ext in (".npz", ".pth"):
                path = os.path.join(
                    d, f"{pref}base_class_gp_coding_energy={energy}{ext}")
                if not os.path.exists(path):
                    continue
                if ext == ".npz":
                    with np.load(path) as z:
                        coding = z["coding"]
                else:
                    coding = load_torch_coding(path)
                if logger:
                    logger.cprint(
                        f"---- loading base_class_coding from {path} ----")
                return np.asarray(coding, np.float32)
    return None


# --------------------------------------------------------------------------- #
# entry point: --only_evaluate
# --------------------------------------------------------------------------- #

def evaluate_gfs(model_cfg, data_cfg, train_cfg,
                 logger: Optional[IOStream] = None,
                 mesh: Optional[Mesh] = None) -> Dict:
    """--only_evaluate: the 4 metrics averaged over the support seeds
    (reference train.py:459-499), on `train_cfg.device` (with a `mesh`,
    its device: the sweeps split over the ranks, on a `data x points` mesh
    each block's points too, the registration of the support shots
    replicated, as in JAX).

    Returns the averaged metrics (`mean_iou`, `base_iou`, `novel_iou`,
    `hm_iou`, `per_class`) and what produced them: `per_seed` (S x 4),
    `base_coding`, `gened_protos`, `novel_codings`, plus `n_blocks` and
    `sweep_seconds` of the static_test sweep and `coding_sweep`: whether
    the base coding was computed by a sweep over the training blocks (no
    saved coding was found). With `train_cfg.trace_dir` the static_test
    sweep runs under a profiler whose trace is written there.
    """
    device = resolve_device(train_cfg.device) if mesh is None else \
        mesh.device
    basis = load_basis(train_cfg.basis_path)
    with main_first(mesh):       # it may write the data's caches
        setup = build_setup(model_cfg, data_cfg, train_cfg, basis, device)
    if is_main(mesh):
        logger = logger or init_logger(train_cfg.save_path, phase="test")
        if mesh is not None:
            logger.cprint(f"---- {mesh} ----")
    else:
        logger = Silent()
    load_model_weights(setup.model, train_cfg.model_checkpoint_path)
    replicate(setup.model, mesh)

    n_base = len(setup.train_class_names)
    ckpt_name = os.path.basename(train_cfg.model_checkpoint_path)
    prefixes = ("hm_", "") if ckpt_name.startswith("train_hm_") else ("",)
    base_coding = load_base_coding(
        train_cfg.save_path, train_cfg.energy,
        extra_dirs=[os.path.dirname(train_cfg.model_checkpoint_path)],
        logger=logger, prefixes=prefixes)
    coding_sweep = base_coding is None
    if coding_sweep:
        logger.cprint(f"---- recompute base_class_coding, "
                      f"energy={train_cfg.energy} ----")
        base_coding, _ = collect_base_codings(
            setup.model, setup.gp, setup.train_data_noaug, n_base,
            train_cfg.energy, train_cfg.batch_size, mesh=mesh)
        if is_main(mesh):
            os.makedirs(train_cfg.save_path, exist_ok=True)
            np.savez(os.path.join(
                train_cfg.save_path,
                f"base_class_gp_coding_energy={train_cfg.energy}.npz"),
                coding=base_coding)

    scannet = len(setup.all_learning_order) > 13
    main_proto = setup.model.main_proto.detach().cpu().numpy()
    # register every support seed, then score all prototype sets in one
    # sweep: the features do not depend on the seed
    geneds, novel_codings = [], []
    for supp in setup.supp_datasets:
        gened, novel_coding = register_novel_protos(
            setup.model, setup.gp, supp, main_proto, n_base,
            setup.test_learning_order_idx, train_cfg.energy)
        geneds.append(gened)
        novel_codings.append(novel_coding)
    geneds, novel_codings = np.stack(geneds), np.stack(novel_codings)

    t0 = time.perf_counter()
    with trace(train_cfg.trace_dir):
        metrics = validate_multi(
            setup.model, setup.gp, setup.val_dataset, geneds, base_coding,
            novel_codings, setup.all_learning_order, setup.test_class_names,
            len(setup.all_class_names), _eval_batch_size(train_cfg), scannet,
            logger, mesh)
    sweep_seconds = time.perf_counter() - t0
    per_seed = np.asarray([m[:4] for m in metrics], np.float64)
    sums = per_seed.mean(axis=0)
    logger.cprint(
        f"Eval result: Final mIoU: {sums[0]}, BASE: {sums[1]}, "
        f"NOVEL: {sums[2]}, hm_mIoU: {sums[3]}")
    per_class = np.mean(np.stack([m[4] for m in metrics]), axis=0)
    for i, v in enumerate(per_class):
        logger.cprint(f"class {i}, iou over multiple runs: {v}")
    return {"mean_iou": sums[0], "base_iou": sums[1], "novel_iou": sums[2],
            "hm_iou": sums[3], "per_class": per_class, "per_seed": per_seed,
            "base_coding": base_coding, "gened_protos": geneds,
            "novel_codings": novel_codings,
            "n_blocks": len(setup.val_dataset),
            "sweep_seconds": sweep_seconds, "coding_sweep": coding_sweep}


# --------------------------------------------------------------------------- #
# entry point: base-stage training
# --------------------------------------------------------------------------- #


def step_seed(seed: int, step: int) -> int:
    """The device generator's seed for optimizer step `step`: a function of
    (seed, step) alone (JAX: fold_in(rng, step)), so that a resumed run
    draws what an uninterrupted one would."""
    return (seed << 32) + step


def train_gfs(model_cfg, data_cfg, train_cfg,
              logger: Optional[IOStream] = None,
              max_steps_per_epoch: Optional[int] = None,
              mesh: Optional[Mesh] = None) -> Dict:
    """Base-stage training (reference train.py:503-588; JAX
    pipelines/gfs.py::train_gfs) on `train_cfg.device`, or data-parallel
    over `mesh` on its device (a `data x points` mesh trains, and
    validates, on the data mesh of all its ranks, as JAX's does).

    The model starts from the JAX initialisers (seed `train_cfg.seed`),
    then, in order: the pre-trained encoder (`use_pretrain_weight`), a warm
    start from `model_checkpoint_path` at `start_epoch == 0` (weights only,
    a fresh optimizer), or a resume at `start_epoch > 0` (weights, optimizer
    moments, schedule and step count from the port's own train state beside
    the checkpoint). `max_steps_per_epoch` cuts epochs short. With
    `train_cfg.trace_dir`, steps LOSS_LAG ... LOSS_LAG + TRACE_STEPS - 1 of
    the first epoch run under a profiler whose trace is written there
    (utils/observability.py::trace).

    Returns {"best", "history", "model", "step", "base_coding"}; `history`
    has one entry per epoch with its mean loss and accuracy, steps and
    seconds, plus the validation mIoUs where it validated.
    """
    if mesh is not None:
        mesh = mesh.data_mesh()
    device = resolve_device(train_cfg.device) if mesh is None else \
        mesh.device
    local_rows(train_cfg.batch_size, mesh)          # B must divide over R
    local_rows(_eval_batch_size(train_cfg), mesh)
    basis = load_basis(train_cfg.basis_path)
    with main_first(mesh):       # it may write the data's caches
        setup = build_setup(model_cfg, data_cfg, train_cfg, basis, device)
    logger, writer = run_logs(train_cfg.save_path, "train", logger, mesh)
    model = use_mesh(init_model(setup, train_cfg.seed), mesh)

    if train_cfg.use_pretrain_weight and train_cfg.pretrain_checkpoint_path:
        logger.cprint("----- loading pretrain weight of feature extractor ----")
        model.encoder.load_state_dict(
            load_pretrained_encoder(train_cfg.pretrain_checkpoint_path),
            strict=True)
    if train_cfg.start_epoch == 0 and train_cfg.model_checkpoint_path \
            and not train_cfg.only_evaluate:
        logger.cprint("----- warm-starting full model from checkpoint -----")
        load_model_weights(model, train_cfg.model_checkpoint_path)

    n_base = len(setup.train_class_names)
    steps_per_epoch = max(len(setup.train_data) // train_cfg.batch_size, 1)
    opt, sched = make_gfs_optimizer(
        model, train_cfg.base_lr, steps_per_epoch, train_cfg.step_size,
        train_cfg.gamma, train_cfg.encoder_lr_scale, train_cfg.weight_decay)
    step = 0
    if train_cfg.start_epoch > 0 and train_cfg.model_checkpoint_path:
        logger.cprint("----- resuming from checkpoint -----")
        load_model_weights(model, train_cfg.model_checkpoint_path)
        step = load_train_state(train_cfg.model_checkpoint_path, opt, sched)
    replicate(model, mesh)
    gen = torch.Generator(device=device)

    scannet = len(setup.all_learning_order) > 13
    best = {"max_iou": 0.0, "max_iou_100": 0.0, "max_hm": 0.0}
    history = []
    base_coding = None
    for epoch in range(train_cfg.start_epoch, train_cfg.epochs):
        # always on a run's first epoch, so that a resume off the coding
        # interval still has a coding (JAX train_gfs does the same)
        if epoch == train_cfg.start_epoch or \
                epoch % train_cfg.coding_interval == 0:
            base_coding, _ = collect_base_codings(
                model, setup.gp, setup.train_data_noaug, n_base,
                train_cfg.energy, train_cfg.batch_size, mesh=mesh)

        loss_m, acc_m = AverageMeter(), AverageMeter()
        pending: List = []

        def drain(keep: int):
            while len(pending) > keep:
                loss, acc = pending.pop(0)
                loss_m.update(float(loss))
                acc_m.update(float(acc))

        t0 = time.time()
        steps = 0
        with contextlib.ExitStack() as traced:
            for i, batch in enumerate(train_batches(
                    setup.train_data, train_cfg.batch_size,
                    seed=train_cfg.seed, epoch=epoch)):
                if max_steps_per_epoch and i >= max_steps_per_epoch:
                    break
                if epoch == train_cfg.start_epoch and i == LOSS_LAG:
                    traced.enter_context(trace(train_cfg.trace_dir))
                elif i == LOSS_LAG + TRACE_STEPS:
                    traced.close()
                # every rank draws the same global batch and keeps its rows
                gen.manual_seed(step_seed(train_cfg.seed, step))
                pending.append(gfs_train_step(
                    model, opt,
                    _to(device, shard_batch(batch[0], mesh), np.float32),
                    _to(device, shard_batch(batch[1], mesh), np.int64),
                    setup.gp, gen, sched))
                step += 1
                steps += 1
                if steps % train_cfg.print_freq == 0:
                    drain(0)
                    logger.cprint(
                        f"Epoch: [{epoch + 1}/{train_cfg.epochs}][{steps}/"
                        f"{steps_per_epoch}] Loss {loss_m.val:.4f} "
                        f"({loss_m.avg:.4f}) Accuracy {acc_m.val:.4f} "
                        f"({acc_m.avg:.4f}).")
                else:
                    drain(LOSS_LAG)
        drain(0)
        seconds = time.time() - t0
        logger.cprint(f"Train result at epoch [{epoch}/{train_cfg.epochs}]: "
                      f"acc {acc_m.avg:.4f}. ({seconds:.1f}s)")
        writer.scalar("Train/loss", loss_m.avg, epoch)
        writer.scalar("Train/accuracy", acc_m.avg, epoch)
        entry = {"epoch": epoch, "loss": loss_m.avg, "accuracy": acc_m.avg,
                 "steps": steps, "seconds": seconds}
        history.append(entry)

        # ---- validation on support seed 0 (reference train.py:518-544)
        if train_cfg.evaluate and (epoch + 1) % train_cfg.eval_interval == 0:
            main_proto = model.main_proto.detach().cpu().numpy()
            gened, novel_coding = register_novel_protos(
                model, setup.gp, setup.supp_datasets[0], main_proto, n_base,
                setup.test_learning_order_idx, train_cfg.energy)
            mean_iou, base_iou, novel_iou, hm, _ = validate_multi(
                model, setup.gp, setup.val_dataset, gened[None], base_coding,
                novel_coding[None], setup.all_learning_order,
                setup.test_class_names, len(setup.all_class_names),
                _eval_batch_size(train_cfg), scannet, logger, mesh)[0]
            logger.cprint(f"Epoch: {epoch}, Final mIoU: {mean_iou}, BASE: "
                          f"{base_iou}, NOVEL: {novel_iou}, hm: {hm}")
            entry.update(mean_iou=mean_iou, base_iou=base_iou,
                         novel_iou=novel_iou, hm_iou=hm)
            writer.scalar("Val/mIoU_val", mean_iou, epoch)
            writer.scalar("Val/base_mIoU", base_iou, epoch)
            writer.scalar("Val/novel_mIoU", novel_iou, epoch)
            writer.scalar("Val/hm_mIoU", hm, epoch)
            _maybe_save(model, opt, sched, step, base_coding, train_cfg,
                        logger, best, epoch, mean_iou, base_iou, novel_iou,
                        hm, write=is_main(mesh))

    writer.close()
    return {"best": best, "history": history, "model": model, "step": step,
            "base_coding": base_coding}


def _maybe_save(model, opt, sched, step, base_coding, train_cfg, logger,
                best, epoch, mean_iou, base_iou, novel_iou, hm,
                write: bool = True) -> None:
    """Keep the best checkpoints by validation mIoU (before and after epoch
    100) and by harmonic mean, each with its coding file, under the JAX
    package's names (reference train.py:546-588). Every rank updates
    `best`; only a rank with `write` saves."""
    meta = {"epoch": epoch, "max_iou": float(mean_iou)}

    def save(name, coding_prefix=""):
        if not write:
            return
        path = os.path.join(train_cfg.save_path, name)
        logger.cprint("Saving best checkpoint to: " + path)
        save_gfs_npz(model, path, meta)
        save_train_state(path, opt, sched, step)
        np.savez(os.path.join(
            train_cfg.save_path,
            f"{coding_prefix}base_class_gp_coding_energy="
            f"{train_cfg.energy}.npz"), coding=base_coding)

    if mean_iou > best["max_iou"] and epoch < 100:
        best["max_iou"] = mean_iou
        save(f"train_epoch_{epoch}_{mean_iou}_Base_{base_iou}"
             f"_Novel_{novel_iou}.npz")
    if mean_iou > best["max_iou_100"] and epoch >= 100:
        best["max_iou_100"] = mean_iou
        save(f"train_epoch_{epoch}_{mean_iou}_Base_{base_iou}"
             f"_Novel_{novel_iou}_hm_{hm}.npz")
    if hm > best["max_hm"]:
        best["max_hm"] = hm
        # the hm checkpoint gets its own coding file (reference train.py:584)
        save(f"train_hm_epoch_{epoch}_{mean_iou}_Base_{base_iou}"
             f"_Novel_{novel_iou}_hm_{hm}.npz", coding_prefix="hm_")
