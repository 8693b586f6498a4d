"""Single-device train and eval steps (counterpart of the JAX package's
parallel/steps.py: the GFS train step, steps.py:223-264, the pretrain step,
steps.py:655-692, and the eval factories, steps.py:534-577, 727-742 and
745-808).

Plain functions; each returns device tensors and never synchronises, so a
loop can queue steps back to back and read the results later. The JAX
package's multi-step `lax.scan` dispatch and packed host-to-device batches
are TPU workarounds and have no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy
from gfs3dseg_gws_tpu_torch.ops.metrics import confusion_matrix


def gfs_train_step(model, opt: torch.optim.Optimizer, points: torch.Tensor,
                   labels: torch.Tensor, gp: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   sched=None, fake_row: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GFS base-stage step (reference train.py:616-631): train-mode
    GWCAPL forward (fake-novel prototypes, 0.5 CE2 + 0.5 CE1), backward,
    optimizer step, then the per-step LR schedule. `generator` (on the
    device) draws the fake classes and the attention's dropout seed.
    Returns (loss, accuracy = mean(pred == labels)) as device tensors."""
    model.train()
    pred, loss = model(points, labels, gp, generator, fake_row)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    if sched is not None:
        sched.step()
    accuracy = torch.mean((pred == labels).to(torch.float32))
    return loss.detach(), accuracy


def pretrain_step(model, opt: torch.optim.Optimizer, points: torch.Tensor,
                  labels: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  sched=None) -> torch.Tensor:
    """One supervised segmentation step (reference pre_train.py:144-159):
    train-mode forward, mean cross-entropy, backward, optimizer step, then
    the per-step LR schedule. `generator` draws the dropout masks. Returns
    the loss as a device tensor (the caller reads it when it likes)."""
    model.train()
    loss = cross_entropy(model(points, generator), labels)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    if sched is not None:
        sched.step()
    return loss.detach()


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

    Returns (cm (S, C, C), gp_acc (S,), gp_novel_acc (S,)).
    """
    model.eval()
    logits, gp_acc, gp_nacc = model.evaluate_multi(
        points, gp, gened_protos, base_coding, novel_codings, labels, valid)
    pred = torch.argmax(logits, dim=-1)                      # (S, B, N)
    rows = torch.arange(points.shape[0], device=points.device) < valid
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
    """
    model.eval()
    _, _, gw = model.get_features(points, gp)                # (B, N, K)
    onehot = torch.nn.functional.one_hot(labels.long(), num_base + 1).to(
        gw.dtype)
    sums = torch.einsum("bnc,bnk->ck", onehot, gw)
    counts = torch.sum(onehot, dim=(0, 1))
    bg_mask = onehot[..., 0]                                 # (B, N)
    bg_cnt = torch.sum(bg_mask, dim=1)                       # (B,)
    bg_sum = torch.einsum("bn,bnk->bk", bg_mask, gw)
    has_bg = (bg_cnt > 0).to(gw.dtype)
    bg_means = bg_sum / torch.clamp_min(bg_cnt, 1.0)[:, None]
    bg_mean_sum = torch.einsum("b,bk->k", has_bg, bg_means)
    return sums[1:], counts[1:], bg_mean_sum, torch.sum(has_bg)


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
