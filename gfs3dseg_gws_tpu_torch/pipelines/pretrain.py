"""Backbone pre-training (counterpart of the JAX package's
pipelines/pretrain.py; reference pretrain/runs/pre_train.py:86-198).

Fully supervised segmentation on the base classes + background with the
`DGCNNSeg` segmentor; every `eval_interval` epochs a validation sweep, and
the best encoder by validation mIoU (classes 1..C-1) is written both as
`checkpoint.tar` (reference layout: `get_basis.py` and
`train.py --use_pretrain_weight` read it) and as the JAX package's
`checkpoint.npz`.

Training batches come from the port's host data layer through
`pipelines/gfs.py::train_batches`, so the same seed and epoch give the
JAX package's batches. The model is initialised from a CPU generator
seeded with `seed` and the dropout masks come from a generator on the
device seeded likewise; the dropout stream is not flax's.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from gfs3dseg_gws_tpu_torch.data import (PretrainBlockDataset, batch_iterator,
                                         make_registry)
from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
from gfs3dseg_gws_tpu_torch.ops.metrics import overall_accuracy_and_miou
from gfs3dseg_gws_tpu_torch.parallel.optim import make_pretrain_optimizer
from gfs3dseg_gws_tpu_torch.parallel.steps import (eval_logits_step,
                                                   pretrain_step)
from gfs3dseg_gws_tpu_torch.pipelines.gfs import (LOSS_LAG, resolve_device,
                                                  train_batches)
from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
    save_pretrain_npz, save_torch_pretrain_checkpoint)
from gfs3dseg_gws_tpu_torch.utils.logging import (AverageMeter, IOStream,
                                                  init_logger)
from gfs3dseg_gws_tpu_torch.utils.observability import MetricsWriter


def _to(device, array, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(array, dtype)).to(device)


def validate(model, dataset, batch_size: int, num_classes: int,
             device) -> np.ndarray:
    """Confusion counts (C, C) of one sweep over `dataset`, counted on the
    device and read once at the end."""
    cm = torch.zeros((num_classes, num_classes), dtype=torch.float64,
                     device=device)
    for batch in batch_iterator(dataset, batch_size, pad_final=True):
        cm += eval_logits_step(model, _to(device, batch[0], np.float32),
                               _to(device, batch[1], np.int64),
                               int(batch[-1]), num_classes)
    return cm.cpu().numpy()


def pretrain(model_cfg, data_cfg, pretrain_cfg,
             logger: Optional[IOStream] = None,
             max_steps_per_epoch: Optional[int] = None,
             init_state_dict: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Dict:
    """Train for `pretrain_cfg.n_iters` epochs on `pretrain_cfg.device`.

    `max_steps_per_epoch` cuts epochs short; `init_state_dict` (a full
    DGCNNSeg state dict) replaces the seeded initialisation (JAX:
    `init_checkpoint_path`). Returns {"best_iou", "history", "model"}:
    `history` has one entry per epoch with its mean loss, step count and
    seconds, plus "oa" and "miou" where it was validated.
    """
    device = resolve_device(pretrain_cfg.device)
    logger = logger or init_logger(pretrain_cfg.log_dir, phase="pretrain")
    writer = MetricsWriter(pretrain_cfg.log_dir)

    reg = make_registry(data_cfg.dataset, data_cfg.cvfold, data_cfg.data_path)
    classes = reg.train_classes
    num_classes = len(classes) + 1  # + background
    c2s = {c: reg.class2scans[c] for c in classes}
    train_ds = PretrainBlockDataset(
        data_cfg.data_path, classes, c2s, mode="train",
        num_point=data_cfg.pc_npts, pc_attribs=data_cfg.pc_attribs,
        pc_augm=data_cfg.pc_augm, pc_augm_config=data_cfg.augment_config,
        split_ratio=0.1)
    valid_ds = PretrainBlockDataset(
        data_cfg.data_path, classes, c2s, mode="test",
        num_point=data_cfg.pc_npts, pc_attribs=data_cfg.pc_attribs,
        split_ratio=0.1)
    logger.cprint(
        f"=== Pre-train Dataset (classes: {classes}) | "
        f"Train: {len(train_ds)} blocks | Valid: {len(valid_ds)} blocks ===")

    model = DGCNNSeg(num_classes, in_features=model_cfg.pc_in_dim,
                     edgeconv_widths=model_cfg.edgeconv_widths,
                     mlp_widths=model_cfg.dgcnn_mlp_widths,
                     k=model_cfg.dgcnn_k, dropout=pretrain_cfg.dropout,
                     generator=torch.Generator().manual_seed(
                         pretrain_cfg.seed))
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict, strict=True)
    model.to(device)
    steps_per_epoch = max(len(train_ds) // pretrain_cfg.batch_size, 1)
    opt, sched = make_pretrain_optimizer(
        model.parameters(), pretrain_cfg.lr, steps_per_epoch,
        pretrain_cfg.weight_decay, pretrain_cfg.step_size, pretrain_cfg.gamma)
    drop_gen = torch.Generator(device=device).manual_seed(pretrain_cfg.seed)

    # start below zero so the first evaluation always checkpoints
    best_iou = -1.0
    history = []
    for epoch in range(pretrain_cfg.n_iters):
        loss_m = AverageMeter()
        pending = []
        t0 = time.time()
        steps = 0
        for i, batch in enumerate(train_batches(
                train_ds, pretrain_cfg.batch_size, seed=pretrain_cfg.seed,
                epoch=epoch)):
            if max_steps_per_epoch and i >= max_steps_per_epoch:
                break
            pending.append(pretrain_step(
                model, opt, _to(device, batch[0], np.float32),
                _to(device, batch[1], np.int64), drop_gen, sched))
            steps += 1
            while len(pending) > LOSS_LAG:
                loss_m.update(float(pending.pop(0)))
        for loss in pending:
            loss_m.update(float(loss))
        seconds = time.time() - t0
        logger.cprint(f"=====[Train] Epoch: {epoch} | Loss: {loss_m.avg:.4f} "
                      f"| {seconds:.1f}s =====")
        writer.scalar("Train/loss", loss_m.avg, epoch)
        entry = {"epoch": epoch, "loss": loss_m.avg, "steps": steps,
                 "seconds": seconds}
        history.append(entry)

        if (epoch + 1) % pretrain_cfg.eval_interval == 0 and len(valid_ds):
            cm = validate(model, valid_ds, pretrain_cfg.batch_size,
                          num_classes, device)
            oa, miou, _ = overall_accuracy_and_miou(cm)
            logger.cprint(f"===== EPOCH [{epoch}]: Accuracy: {oa:.6f} | "
                          f"mIoU: {miou:.6f} =====")
            entry.update(oa=oa, miou=miou)
            writer.scalar("Valid/overall_accuracy", oa, epoch)
            writer.scalar("Valid/meanIoU", miou, epoch)
            if miou > best_iou:
                best_iou = miou
                logger.cprint("*******************Model Saved**************")
                save_pretrain_npz(
                    model, os.path.join(pretrain_cfg.log_dir,
                                        "checkpoint.npz"),
                    {"epoch": epoch, "miou": miou})
                save_torch_pretrain_checkpoint(model.state_dict(),
                                               pretrain_cfg.log_dir)

    writer.close()
    return {"best_iou": best_iou, "history": history, "model": model}
