"""GW/CAPL head (counterpart of the JAX package's models/capl.py; reference
model/capl.py:21-433).

  * DGCNN features + self-attention + base learner -> 192-d semantic feature.
  * Cosine match of the EdgeConv features (every block) against the
    geometric-word basis, sharpened softmax(10 cos) + hard one-hot word
    assignment.
  * Fusion conv -> 128-d point feature; per-class prototypes (main_proto)
    + background prototype; cosine classifier (x10).
  * Training (`forward`): fake-novel prototypes (CAPL eqn.8) and
    transductive prototype refinement (eqn.6); loss = 0.5 CE1 + 0.5 CE2.
  * Evaluation: transductively refined base + registered novel prototypes,
    logits re-weighted by geometric-word multi-hot agreement (x eval_weight).

With a mesh (parallel/mesh.py, set by models/layers.py::use_mesh) the
training pass keeps the single-process semantics on the global batch: the
fake half is the global batch's second half, its class counts and sums are
all-reduced, and each cross-entropy is this rank's share over the global
count. Evaluation is per block and needs no data mesh. Under the `data x
points` mesh (`points_mesh`, set by parallel/mesh.py::points_split for the
sweeps) a rank holds N/S points of each block: the encoder all-gathers
what needs every point (models/dgcnn.py, models/attention.py), the heads
are per point, and the prototype refinement's softmax over points spans
the ranks (`post_refine_proto`). `get_fg_feat` (the support shots) stays
replicated at full N.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from gfs3dseg_gws_tpu_torch.models.attention import SelfAttention
from gfs3dseg_gws_tpu_torch.models.dgcnn import DGCNN, BaseLearner
from gfs3dseg_gws_tpu_torch.models.layers import (BatchNorm, Conv1x1,
                                                  LeakyReLU, cross_entropy,
                                                  l2norm, random_init_,
                                                  train_init_)
from gfs3dseg_gws_tpu_torch.parallel.graph import run_step
from gfs3dseg_gws_tpu_torch.parallel.mesh import (Mesh, all_gather_points,
                                                  all_reduce_points,
                                                  all_reduce_sum, reduce_sum)
from gfs3dseg_gws_tpu_torch.utils.observability import span

IGNORE_INDEX = 255  # labels the training loss leaves out (reference capl.py)


def _one_hot(y: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """jax.nn.one_hot: a label outside [0, n) gives a zero row."""
    return (y.long()[..., None] == torch.arange(n, device=y.device)).to(dtype)


class GWCAPL(nn.Module):
    """Geometric-words CAPL model, built in eval mode.

    Its state dict has the reference's keys, so a reference `.pth` loads
    with `load_state_dict(strict=True)`. With a `generator`, every weight
    and BatchNorm statistic is drawn from it (`random_init_`); a model to be
    trained takes the JAX package's initialisers instead (`train_init`).
    """

    mesh: Optional[Mesh] = None
    points_mesh: Optional[Mesh] = None

    def __init__(self, classes: int = 13, base_num: int = 7,
                 num_gw: int = 150, main_dim: int = 128, energy: float = 0.9,
                 eval_weight: float = 1.0, cosine_scale: float = 10.0,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64),) * 3,
                 mlp_widths: Sequence[int] = (512, 256),
                 base_widths: Sequence[int] = (128, 64),
                 output_dim: int = 64, k: int = 20, in_features: int = 9,
                 attn_dropout: float = 0.1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.classes = classes
        self.base_num = base_num
        self.num_gw = num_gw
        self.energy = energy
        self.eval_weight = eval_weight
        self.cosine_scale = cosine_scale
        self.encoder = DGCNN(in_features, edgeconv_widths, mlp_widths, k=k,
                             device=device)
        self.base_learner = BaseLearner(mlp_widths[-1], base_widths,
                                        device=device)
        self.att_learner = SelfAttention(mlp_widths[-1], output_dim,
                                         attn_dropout, device=device)
        semantic = edgeconv_widths[0][-1] + output_dim + base_widths[-1]
        # input order [cosine_feat, semantic_feat] (reference capl.py:63-65)
        self.fusion = nn.Sequential(
            Conv1x1(num_gw + semantic, main_dim, bias=True, device=device),
            BatchNorm(main_dim, device=device), LeakyReLU())
        self.main_proto = nn.Parameter(torch.zeros(classes, main_dim,
                                                   device=device))
        self.bg_proto = nn.Parameter(torch.zeros(1, main_dim, device=device))
        if generator is not None:
            random_init_(self, generator)
        self.eval()

    @torch.no_grad()
    def train_init(self, generator: torch.Generator) -> "GWCAPL":
        """The JAX package's initialisers, drawn from `generator` (a CPU
        generator): `train_init_` for the convs and BatchNorms, and
        main_proto and bg_proto standard normal (JAX capl.py:68-72)."""
        train_init_(self, generator)
        for proto in (self.main_proto, self.bg_proto):
            proto.copy_(torch.randn(proto.shape, generator=generator))
        return self

    # ------------------------------------------------------------------ #
    # feature extraction
    # ------------------------------------------------------------------ #

    def get_features(self, x: torch.Tensor, gp: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Reference capl.py:324-362.

        x: (B, N, C_in) point clouds; gp: (num_gw, sum of the EdgeConv
        output widths, 192 by default) geometric-word basis (a constant: no
        gradient reaches it). In training the BatchNorms
        use batch statistics and `generator` draws the attention's dropout
        seed. Returns point_feat (B, N, main_dim), semantic_feat
        (B, N, 192), one_hot_gw (B, N, num_gw).
        """
        edge_feats, feat_level2 = self.encoder(x)
        feat_level3 = self.base_learner(feat_level2)
        att_feat = self.att_learner(feat_level2, generator)
        semantic_feat = torch.cat([edge_feats[0], att_feat, feat_level3],
                                  dim=-1)
        edge_l2 = l2norm(torch.cat(edge_feats, dim=-1))
        gp_l2 = l2norm(gp.detach())
        cos = torch.einsum("bnd,kd->bnk", edge_l2, gp_l2)
        cosine_feat = torch.softmax(self.cosine_scale * cos, dim=-1)
        assignment = torch.argmax(cosine_feat, dim=-1)
        one_hot_gw = nn.functional.one_hot(assignment, self.num_gw).to(
            cos.dtype)
        point_feat = self.fusion(torch.cat([cosine_feat, semantic_feat],
                                           dim=-1))
        return point_feat, semantic_feat, one_hot_gw

    def get_fg_feat(self, x: torch.Tensor, mask: torch.Tensor,
                    gp: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Masked foreground features of support shots (capl.py:71-88), as
        per-shot sums and counts so callers average like the reference.

        x: (S, N, C_in), mask: (S, N) binary. Returns (fg_feat_sums
        (S, main_dim), fg_counts (S,), fg_gw_hists (S, num_gw)).
        """
        point_feat, _, gw = self.get_features(x, gp)
        m = mask.to(point_feat.dtype)
        fg_sums = torch.einsum("snc,sn->sc", point_feat, m)
        fg_cnts = torch.sum(m, dim=-1)
        gw_hists = torch.einsum("snk,sn->sk", gw, m)
        return fg_sums, fg_cnts, gw_hists

    # ------------------------------------------------------------------ #
    # prototype classifier
    # ------------------------------------------------------------------ #

    def get_pred(self, x: torch.Tensor, proto: torch.Tensor,
                 use_bg_proto: bool = False) -> torch.Tensor:
        """Cosine-similarity logits x cosine_scale (reference capl.py:290-322).

        x: (B, N, C); proto: (cls, C), or (..., B, cls, C) with any leading
        dims (e.g. seeds). Returns (B, N, cls[+1]) or (..., B, N, cls[+1]).
        """
        if use_bg_proto:
            bg = self.bg_proto.expand(*proto.shape[:-2], 1, proto.shape[-1])
            proto = torch.cat([bg, proto], dim=-2)
        xn = l2norm(x)
        pn = l2norm(proto)
        if proto.dim() == 2:
            pred = torch.einsum("bnc,kc->bnk", xn, pn)
        else:
            pred = torch.einsum("bnc,...bkc->...bnk", xn, pn)
        return pred * self.cosine_scale

    def post_refine_proto(self, proto: torch.Tensor, point_feat: torch.Tensor,
                          use_bg_proto: bool = False) -> torch.Tensor:
        """Transductive prototype refinement, eqn.6 (capl.py:245-287).

        The per-class softmax runs over POINTS (dim 1), not classes; each
        refined prototype is blended with the learned one by their clamped
        cosine agreement. proto: (cls, C); point_feat: (B, N, C) ->
        (B, cls, C). Under the points split point_feat holds this rank's
        points: the softmax takes the global max of each (block, class)
        from the ranks' maxima, and [sum exp, sum exp * feat] summed over
        the points group in one all-reduce, before the division.
        """
        pred = self.get_pred(point_feat, proto, use_bg_proto)  # (B, N, cls*)
        pm = self.points_mesh
        if pm is None:
            pred = torch.softmax(pred, dim=1)                  # over points
            pred_proto = torch.einsum("bnk,bnc->bkc", pred, point_feat)
        else:
            top = all_gather_points(pred.amax(dim=1, keepdim=True), pm)
            e = torch.exp(pred - top.amax(dim=1, keepdim=True))
            sums = all_reduce_points(torch.cat(
                [torch.sum(e, dim=1)[..., None],
                 torch.einsum("bnk,bnc->bkc", e, point_feat)], dim=-1), pm)
            pred_proto = sums[..., 1:] / sums[..., :1]
        if use_bg_proto:
            pred_proto = pred_proto[:, 1:, :]
        w = torch.sum(l2norm(pred_proto) * l2norm(proto)[None], dim=-1,
                      keepdim=True)
        w = w * (w > 0).to(w.dtype)                            # clamp at 0
        return w * pred_proto + (1.0 - w) * proto[None]

    # ------------------------------------------------------------------ #
    # fake-novel episode construction (training only)
    # ------------------------------------------------------------------ #

    def generate_fake_proto(self, feats: torch.Tensor, y: torch.Tensor,
                            main_proto: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            fake_row: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """CAPL eqn.8 (reference capl.py:364-411; JAX capl.py:192-247).

        Half of the classes present in `y` (background 0 excluded) become
        "fake novel": their prototype rows are replaced by the mean of the
        L2-normalised features of their points; the other rows keep the
        normalised learned prototype.

        feats: (B2, N, C) features of the second half of the batch; y:
        (B2, N) labels in {0..base_num}; main_proto: (cls, C). `fake_row`
        (cls,) {0,1} pins the draw (so that tests can hold both frameworks
        to one draw); otherwise `n_present // 2` present classes are drawn
        uniformly with `generator` (on feats' device), without a host
        round trip: the distribution of JAX's noise-argsort, not its bits.
        With a mesh, feats and y are this rank's rows of the global second
        half (possibly none): the counts and class sums are all-reduced.
        Returns (new_proto (cls, C), fake_row (cls,) in {0., 1.}).
        """
        n_cls = main_proto.shape[0]
        onehot = _one_hot(y, n_cls + 1, feats.dtype)          # (B2, N, cls+1)
        counts = all_reduce_sum(torch.sum(onehot, dim=(0, 1)), self.mesh)
        present = counts[1:] > 0
        if fake_row is None:
            novel_num = torch.sum(present) // 2
            noise = torch.rand(n_cls, generator=generator,
                               device=feats.device)
            score = torch.where(present, noise, torch.full_like(noise, -1.0))
            rank = torch.argsort(torch.argsort(-score))         # descending
            fake_row = present & (rank < novel_num)
        fake_row = fake_row.to(device=feats.device, dtype=feats.dtype)
        class_sums = reduce_sum(torch.einsum("bnk,bnc->kc", onehot,
                                             l2norm(feats)), self.mesh)
        class_means = class_sums[1:] / (counts[1:, None] + 1e-12)
        new_proto = ((1.0 - fake_row[:, None]) * l2norm(main_proto)
                     + fake_row[:, None] * class_means)
        return new_proto, fake_row

    # ------------------------------------------------------------------ #
    # the training pass
    # ------------------------------------------------------------------ #

    def forward(self, x: torch.Tensor, y: torch.Tensor, gp: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                fake_row: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Base-stage training pass (reference capl.py:194-242; JAX
        `__call__`), in the module's mode (train: batch statistics).

        x: (B, N, C_in); y: (B, N) labels in {0..base_num}, 255 ignored.
        The second half of the batch builds the fake-novel prototypes;
        `generator` draws them and the attention's dropout seed, `fake_row`
        pins the former. Returns (pred (B, N), loss = 0.5 CE2 + 0.5 CE1).
        With a mesh, x and y are this rank's rows and the loss is its share
        of the global loss (the shares of the ranks add up to it).
        """
        point_feat, _, _ = self.get_features(x, gp, generator)
        fake_num = x.shape[0] // 2
        if self.mesh is not None:
            # the global second half: this rank's rows at or past B/2
            first = self.mesh.rank * x.shape[0]
            fake_num = min(max(x.shape[0] * self.mesh.size // 2 - first, 0),
                           x.shape[0])
        ori_proto, _ = self.generate_fake_proto(
            point_feat[fake_num:], y[fake_num:], self.main_proto, generator,
            fake_row)
        x_pre_1 = self.get_pred(point_feat, ori_proto, use_bg_proto=True)
        loss_ce_1 = cross_entropy(x_pre_1, y, ignore_index=IGNORE_INDEX,
                                  mesh=self.mesh)

        refine = self.post_refine_proto(self.main_proto, point_feat,
                                        use_bg_proto=True)    # (B, cls, C)
        base = self.base_num
        post = torch.cat([
            refine[:, :base] + ori_proto[None, :base],
            ori_proto[None, base:].expand(refine.shape[0],
                                          refine.shape[1] - base,
                                          refine.shape[2]),
        ], dim=1)
        x_pre_2 = self.get_pred(point_feat, post, use_bg_proto=True)
        loss_ce_2 = cross_entropy(x_pre_2, y, ignore_index=IGNORE_INDEX,
                                  mesh=self.mesh)
        return (torch.argmax(x_pre_2, dim=-1),
                0.5 * loss_ce_2 + 0.5 * loss_ce_1)

    # ------------------------------------------------------------------ #
    # geometric-word re-weighting
    # ------------------------------------------------------------------ #

    def gp_weight(self, gp_coding: torch.Tensor, gw_onehot: torch.Tensor,
                  th: float, y: Optional[torch.Tensor] = None,
                  base_num: Optional[int] = None,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Reference capl.py:92-142 (test branch).

        gp_coding: (..., cls, num_gw) multi-hot class codings (leading dims,
        e.g. seeds, allowed); gw_onehot: (B, N, num_gw) hard word assignment;
        mask: optional (B, N) validity mask (padded rows of a final short
        batch stay out of the gp_acc means).
        Returns (weight (..., B, N, cls), gp_acc (...), gp_novel_acc (...)).
        """
        # {0,1} products summed in fp32: exact, so `== 1.0` is exact
        score = torch.einsum("...kw,bnw->...bnk", gp_coding, gw_onehot)
        weight = torch.where(score == 1.0,
                             torch.full_like(score, th),
                             torch.ones_like(score))
        if y is None:
            zero = score.new_zeros(score.shape[:-3])
            return weight, zero, zero
        n_cls = gp_coding.shape[-2]
        gt_onehot = nn.functional.one_hot(y.long(), n_cls).to(score.dtype)
        per_point = torch.sum(gt_onehot * score, dim=-1)        # (..., B, N)
        w = (torch.ones_like(y, dtype=score.dtype) if mask is None
             else mask.to(score.dtype))
        acc = (torch.sum(per_point * w, dim=(-2, -1))
               / torch.clamp_min(torch.sum(w), 1.0))
        if base_num is None:
            base_num = self.base_num
        novel_mask = (y > base_num - 1).to(score.dtype) * w
        novel_cnt = torch.sum(novel_mask)
        novel_acc = torch.where(
            novel_cnt > 0,
            torch.sum(per_point * novel_mask, dim=(-2, -1))
            / torch.clamp_min(novel_cnt, 1.0),
            torch.zeros_like(acc))
        return weight, acc, novel_acc

    # ------------------------------------------------------------------ #
    # evaluation passes
    # ------------------------------------------------------------------ #

    def _merge(self, refine: torch.Tensor, gened: torch.Tensor
               ) -> torch.Tensor:
        """Base rows: refined + registered; novel rows: registered.
        refine (B, cls, C), gened (..., cls, C) -> (..., B, cls, C)."""
        base = self.base_num
        gened = gened.unsqueeze(-3)                          # (..., 1, cls, C)
        lead = gened.shape[:-3] + refine.shape[:1]
        return torch.cat([
            refine[..., :base, :] + gened[..., :base, :],
            gened[..., base:, :].expand(*lead, refine.shape[1] - base,
                                        refine.shape[2]),
        ], dim=-2)

    @staticmethod
    def _row_mask(x: torch.Tensor, valid: Optional[int]
                  ) -> Optional[torch.Tensor]:
        if valid is None:
            return None
        rows = torch.arange(x.shape[0], device=x.device) < valid
        return rows[:, None].expand(x.shape[:2])

    def evaluate(self, x: torch.Tensor, gp: torch.Tensor,
                 gened_proto: torch.Tensor, base_coding: torch.Tensor,
                 novel_coding: torch.Tensor, y: Optional[torch.Tensor] = None,
                 valid: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """GFS evaluation pass (reference capl.py:170-192).

        gened_proto: (cls, main_dim) registered prototypes;
        base_coding/novel_coding: (n_base, num_gw)/(n_novel, num_gw).
        Returns (logits (B, N, cls), gp_acc, gp_novel_acc).
        """
        point_feat, _, gw_onehot = self.get_features(x, gp)
        refine = self.post_refine_proto(self.main_proto, point_feat)
        x_pre = self.get_pred(point_feat, self._merge(refine, gened_proto))
        gp_coding = torch.cat([base_coding, novel_coding], dim=0)
        weight, gp_acc, gp_novel_acc = self.gp_weight(
            gp_coding, gw_onehot, th=self.eval_weight, y=y,
            mask=self._row_mask(x, valid))
        return x_pre * weight, gp_acc, gp_novel_acc

    def evaluate_multi(self, x: torch.Tensor, gp: torch.Tensor,
                       gened_protos: torch.Tensor, base_coding: torch.Tensor,
                       novel_codings: torch.Tensor,
                       y: Optional[torch.Tensor] = None,
                       valid: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Evaluate S registered prototype sets in ONE feature sweep: the
        encoder does not depend on the seed, so features are computed once
        and the heads run over an explicit leading seed dimension.

        gened_protos: (S, cls, main_dim); novel_codings: (S, n_novel, num_gw).
        Returns (logits (S, B, N, cls), gp_acc (S,), gp_novel_acc (S,)),
        tensors of this call's own.

        On one card, in eval mode with autograd off, the pass replays a
        CUDA graph from the call after WARM_CALLS eager ones at its key
        (parallel/graph.py::run_step; `valid` is part of the key, so a
        sweep's short last batch takes a graph of its own): each call
        copies every tensor argument into the graph's inputs, replays it
        and returns copies of its outputs. The graph reads the parameters
        and BatchNorm buffers where they lie, so a replay after a train
        step reads the new weights. CPU tensors, a mesh, a running
        profiler, train mode and autograd keep the eager pass. Spans of an
        eager pass: `features` (the encoder), `heads` (the rest); counters
        `graph_captures` and `graph_replays` under the caller's span.
        """
        return run_step(self, self, partial(self._evaluate_multi,
                                            valid=valid),
                        (x, gp, gened_protos, base_coding, novel_codings, y),
                        train=False, parts=(valid,))

    def _evaluate_multi(self, x, gp, gened_protos, base_coding,
                        novel_codings, y, valid):
        """The pass of `evaluate_multi`, eager or captured."""
        with span("features"):
            point_feat, _, gw_onehot = self.get_features(x, gp)
        with span("heads"):
            refine = self.post_refine_proto(self.main_proto, point_feat)
            x_pre = self.get_pred(point_feat,
                                  self._merge(refine, gened_protos))
            s = gened_protos.shape[0]
            gp_coding = torch.cat([base_coding.expand(s, *base_coding.shape),
                                   novel_codings], dim=1)     # (S, cls, K)
            weight, gp_acc, gp_novel_acc = self.gp_weight(
                gp_coding, gw_onehot, th=self.eval_weight, y=y,
                mask=self._row_mask(x, valid))
            return x_pre * weight, gp_acc, gp_novel_acc
