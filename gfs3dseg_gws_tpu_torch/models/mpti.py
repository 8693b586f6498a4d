"""The MPTI baseline, multi-prototype transductive inference (counterpart
of the JAX package's models/mpti.py; reference
pretrain/models/mpti.py:48-297).

Per class, `n_subprototypes` prototypes: farthest-point seeds over the
class's masked point features, each the mean of the masked points nearest
to it. A k-NN gaussian affinity graph over the prototypes and the query
points, then closed-form label propagation; the loss is the cross-entropy
of the propagated scores, whose gradient flows through the solve.

Shapes are fixed as in JAX: every class yields exactly `n_subprototypes`
prototypes (duplicate seeds where a class has fewer masked points; the
reference shrinks the set instead), and a support with no background keeps
its background rows but neutralises them (labels zero, features shifted by
1e6, so their affinity to every real node vanishes).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy
from gfs3dseg_gws_tpu_torch.models.protonet import FewShotEncoder
from gfs3dseg_gws_tpu_torch.ops.fps import farthest_point_sampling
from gfs3dseg_gws_tpu_torch.ops.knn import pairwise_sq_dists
from gfs3dseg_gws_tpu_torch.ops.linalg import (label_propagate,
                                               local_constrained_affinity)


def multi_prototypes(feat: torch.Tensor, valid: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """k sub-prototypes (k, D) of the valid rows of feat (M, D)
    (reference mpti.py:139-172): sorted farthest-point seeds over the
    valid rows (the reference's `fps(...).unique()` sorts), then each seed
    the mean of the valid rows nearest to it (the first seed on a tie); a
    seed no row joins keeps its own feature."""
    valid = valid.to(feat.dtype)
    seeds_idx = torch.sort(farthest_point_sampling(feat, k, valid > 0)).values
    seeds = feat[seeds_idx]                                  # (k, D)
    assign = torch.argmin(pairwise_sq_dists(feat, seeds), dim=-1)
    onehot = torch.nn.functional.one_hot(assign, k).to(feat.dtype) \
        * valid[:, None]
    sums = onehot.t() @ feat                                 # (k, D)
    counts = torch.sum(onehot, dim=0)                        # (k,)
    means = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, means, seeds)


class MPTI(FewShotEncoder):
    def __init__(self, n_way: int = 2, k_shot: int = 5,
                 n_subprototypes: int = 100, k_connect: int = 200,
                 sigma: float = 1.0, dist_method: str = "gaussian", **kw):
        super().__init__(**kw)
        self.n_way, self.k_shot = n_way, k_shot
        self.n_subprototypes = n_subprototypes
        self.k_connect = k_connect
        self.sigma = sigma
        # the JAX package takes gaussian for any other name
        self.dist_method = (dist_method if dist_method in
                            ("gaussian", "cosine") else "gaussian")

    def graph_nodes(self, s_feat: torch.Tensor, support_y: torch.Tensor,
                    q_feat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """The propagation graph's nodes from support features (w, s, N, D),
        masks (w, s, N) and query features (q, N, D): (node features
        (P + q N, D), initial labels (P + q N, w + 1), P), the P =
        (w + 1) n_subprototypes prototypes first, the background's
        leading."""
        n_way, k_shot, n_pts, dim = s_feat.shape
        n_classes = self.n_way + 1
        kp = self.n_subprototypes
        s_feat = s_feat.reshape(n_way, k_shot * n_pts, dim)
        q_feat = q_feat.reshape(-1, dim)                     # (q N, D)
        fg_mask = support_y.reshape(n_way, k_shot * n_pts).to(s_feat.dtype)

        def onehot_rows(col: int, value) -> torch.Tensor:
            lab = torch.zeros((kp, n_classes), dtype=s_feat.dtype,
                              device=s_feat.device)
            lab[:, col] = value
            return lab

        bg_mask = 1.0 - fg_mask.reshape(-1)
        bg_valid = (torch.sum(bg_mask) > 0).to(s_feat.dtype)
        bg_protos = multi_prototypes(s_feat.reshape(-1, dim), bg_mask, kp)
        protos = [bg_protos + (1.0 - bg_valid) * 1e6]
        labels = [onehot_rows(0, bg_valid)]
        for i in range(n_way):
            protos.append(multi_prototypes(s_feat[i], fg_mask[i], kp))
            labels.append(onehot_rows(i + 1, 1.0))
        num_p = kp * n_classes
        node_feat = torch.cat(protos + [q_feat], dim=0)
        y0 = torch.cat(labels + [q_feat.new_zeros((q_feat.shape[0],
                                                   n_classes))], dim=0)
        return node_feat, y0, num_p

    def forward(self, support_x: torch.Tensor, support_y: torch.Tensor,
                query_x: torch.Tensor, query_y: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shapes as ProtoNet's. Returns (query scores (q, N, w + 1),
        loss)."""
        s_feat, q_feat = self.support_query_features(support_x, query_x,
                                                     generator)
        node_feat, y0, num_p = self.graph_nodes(s_feat, support_y, q_feat)
        z = label_propagate(local_constrained_affinity(
            node_feat, self.k_connect, self.sigma, self.dist_method), y0)
        query_pred = z[num_p:].reshape(*query_y.shape, y0.shape[1])
        return query_pred, cross_entropy(query_pred, query_y)
