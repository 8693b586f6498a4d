"""The fully supervised segmentors (counterpart of the JAX package's
models/dgcnnseg.py).

`DGCNNSeg` is the pre-training segmentor (reference
pretrain/runs/pre_train.py:22-48): the DGCNN encoder, then its head
(`seg_head`): a global max feature broadcast to every point, and the
segmenter MLP 448 -> 256 -> 128 -> classes with Dropout(0.3).
`DGCNNSegAtt` is its attention variant
(reference model/dgcnn.py:155-202): EdgeConv 1's feature, the
self-attention (K2 in eval, K5 in training) and the base learner over the
point feature, then the same segmenter.

The state-dict keys are the reference's, `encoder.*`, `base_learner.*`,
`att_learner.*` and `segmenter.{0,1,3,4,7}`, which the JAX package's
converters read (utils/checkpoint.py::convert_torch_dgcnn_encoder,
convert_torch_base_learner, convert_torch_attention,
convert_torch_segmenter).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gfs3dseg_gws_tpu_torch.models.attention import SelfAttention
from gfs3dseg_gws_tpu_torch.models.dgcnn import DGCNN, BaseLearner
from gfs3dseg_gws_tpu_torch.models.layers import (BatchNorm, Conv1x1,
                                                  Dropout, LeakyReLU,
                                                  train_init_)
from gfs3dseg_gws_tpu_torch.utils.observability import span


def global_max(point_feat: torch.Tensor) -> torch.Tensor:
    """The global feature: the max of (B, N, C) over the N points,
    (B, 1, C). A function of its own so that a check can swap it, as it
    swaps the kNN (chip_smoke.py::compare_train_step)."""
    return torch.amax(point_feat, dim=1, keepdim=True)


def seg_head(edge_feats: Sequence[torch.Tensor], point_feat: torch.Tensor,
             segmenter: "Segmenter",
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DGCNNSeg's head: the global max of the point feature (B, N, C),
    broadcast to every point after the EdgeConv features, through the
    segmenter; logits (B, N, classes). A module-level function that
    `DGCNNSeg.forward` calls through its global name, so that a trace can
    place it; span `seg_head`."""
    with span("seg_head"):
        global_feat = global_max(point_feat)
        feats = list(edge_feats) + [
            global_feat.expand(-1, point_feat.shape[1], -1)]
        return segmenter(torch.cat(feats, dim=-1), generator)


class Segmenter(nn.Sequential):
    """Conv(256, no bias)+BN+Leaky -> Conv(128)+BN+Leaky -> Dropout ->
    Conv(classes): the reference Sequential, indices 0..7."""

    def __init__(self, in_features: int, num_classes: int,
                 dropout: float = 0.3,
                 device: Optional[torch.device] = None):
        super().__init__(
            Conv1x1(in_features, 256, device=device),
            BatchNorm(256, device=device), LeakyReLU(),
            Conv1x1(256, 128, bias=True, device=device),
            BatchNorm(128, device=device), LeakyReLU(),
            Dropout(dropout),
            Conv1x1(128, num_classes, bias=True, device=device))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self:
            x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
        return x


class DGCNNSeg(nn.Module):
    """Pre-training segmentor: encoder + global-max broadcast + segmenter.

    With a `generator` (CPU), the weights are drawn with the JAX package's
    initialisers (`train_init_`); otherwise they are zeros, to be loaded.
    """

    def __init__(self, num_classes: int, in_features: int = 9,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64),) * 3,
                 mlp_widths: Sequence[int] = (512, 256), k: int = 20,
                 dropout: float = 0.3,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = DGCNN(in_features, edgeconv_widths, mlp_widths, k=k,
                             device=device)
        feat = sum(w[-1] for w in edgeconv_widths) + mlp_widths[-1]
        self.segmenter = Segmenter(feat, num_classes, dropout, device=device)
        if generator is not None:
            train_init_(self, generator)

    def forward(self, pc: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                return_feat: bool = False):
        """pc (B, N, C_in) -> logits (B, N, classes); with `return_feat`
        also the concat of every EdgeConv block's output (the geometric-word
        feature space, which GWCAPL matches against the basis: 192 channels
        at the default widths, 512 at the DGCNN classification widths).
        `generator` draws the dropout mask in training.

        The JAX package takes EdgeConv 1-3 only (`edge_feats[:3]`, the
        reference's three blocks); past three blocks its basis would not
        match its own GWCAPL's feature, so the port takes them all."""
        edge_feats, point_feat = self.encoder(pc)
        logits = seg_head(edge_feats, point_feat, self.segmenter, generator)
        if return_feat:
            return logits, torch.cat(edge_feats, dim=-1)
        return logits


class DGCNNSegAtt(nn.Module):
    """Attention segmentor: encoder, then [EdgeConv 1 | self-attention |
    base learner] per point, then the segmenter.

    With a `generator` (CPU), the weights are drawn with the JAX package's
    initialisers (`train_init_`); otherwise they are zeros, to be loaded.
    """

    def __init__(self, num_classes: int, in_features: int = 9,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64),) * 3,
                 mlp_widths: Sequence[int] = (512, 256),
                 base_widths: Sequence[int] = (128, 64),
                 output_dim: int = 64, k: int = 20, dropout: float = 0.3,
                 attn_dropout: float = 0.1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = DGCNN(in_features, edgeconv_widths, mlp_widths, k=k,
                             device=device)
        self.base_learner = BaseLearner(mlp_widths[-1], base_widths,
                                        device=device)
        self.att_learner = SelfAttention(mlp_widths[-1], output_dim,
                                         attn_dropout, device=device)
        feat = edgeconv_widths[0][-1] + output_dim + base_widths[-1]
        self.segmenter = Segmenter(feat, num_classes, dropout, device=device)
        if generator is not None:
            train_init_(self, generator)

    def forward(self, pc: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                return_feat: bool = False):
        """pc (B, N, C_in) -> logits (B, N, classes); with `return_feat`
        also EdgeConv 1's feature. `generator` draws the attention's
        dropout seed and the segmenter's dropout mask in training."""
        edge_feats, point_feat = self.encoder(pc)
        feats = torch.cat([edge_feats[0],
                           self.att_learner(point_feat, generator),
                           self.base_learner(point_feat)], dim=-1)
        logits = self.segmenter(feats, generator)
        if return_feat:
            return logits, edge_feats[0]
        return logits
