"""The ProtoNet few-shot baseline (counterpart of the JAX package's
models/protonet.py; reference pretrain/models/protonet.py:38-163).

`FewShotEncoder` is the feature extractor the baselines share: the DGCNN
encoder, the base learner and the self-attention (or a bias-free linear
mapper) over its point feature; a point's feature is [EdgeConv 1 | mapped
| base], 192 channels at the default widths. Its submodules carry the
reference's attribute names (`encoder`, `base_learner`, `att_learner` /
`linear_mapper`) at the top level of the model, so a reference
`model_state_dict` loads with `strict=True` (the JAX package nests them
under `feat`; `utils/checkpoint.py::fewshot_state_dict_from_jax` maps
them). In training the encoder runs K3/K4 (and K5 with attention), in eval
K1 (and K2).

`ProtoNet` scores each query point against masked-average prototypes, one
a way plus a background prototype averaged over every way and shot, by
10 x cosine or by negative squared distance, and takes the cross-entropy
on the query labels.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from gfs3dseg_gws_tpu_torch.models.attention import SelfAttention
from gfs3dseg_gws_tpu_torch.models.dgcnn import DGCNN, BaseLearner
from gfs3dseg_gws_tpu_torch.models.layers import (Conv1x1, cross_entropy,
                                                  l2norm, train_init_)


class FewShotEncoder(nn.Module):
    """DGCNN + base learner + self-attention or linear mapper.

    With a `generator` (CPU), the weights are drawn with the JAX package's
    initialisers (`train_init_`); otherwise they are zeros, to be loaded.
    """

    def __init__(self, in_features: int = 9,
                 edgeconv_widths: Sequence[Sequence[int]] = ((64, 64),) * 3,
                 mlp_widths: Sequence[int] = (512, 256),
                 base_widths: Sequence[int] = (128, 64),
                 output_dim: int = 64, k: int = 20,
                 use_attention: bool = True, attn_dropout: float = 0.1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_attention = use_attention
        self.encoder = DGCNN(in_features, edgeconv_widths, mlp_widths, k=k,
                             device=device)
        self.base_learner = BaseLearner(mlp_widths[-1], base_widths,
                                        device=device)
        if use_attention:
            self.att_learner = SelfAttention(mlp_widths[-1], output_dim,
                                             attn_dropout, device=device)
        else:
            self.linear_mapper = Conv1x1(mlp_widths[-1], output_dim,
                                         device=device)
        if generator is not None:
            train_init_(self, generator)

    def get_features(self, x: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """x (B, N, C_in) -> (B, N, edge 1 + output_dim + base) features;
        `generator` draws the attention's dropout seed in training."""
        edge_feats, point_feat = self.encoder(x)
        if self.use_attention:
            mapped = self.att_learner(point_feat, generator)
        else:
            mapped = self.linear_mapper(point_feat)
        return torch.cat([edge_feats[0], mapped,
                          self.base_learner(point_feat)], dim=-1)

    def support_query_features(self, support_x: torch.Tensor,
                               query_x: torch.Tensor,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Support (w, s, N, C) and query (q, N, C) features in two encoder
        calls, support first, as the JAX package runs them: in training
        each call takes its own BatchNorm batch statistics and moves the
        running statistics once. Returns ((w, s, N, D), (q, N, D))."""
        n_way, k_shot, n_pts, cin = support_x.shape
        s_feat = self.get_features(
            support_x.reshape(n_way * k_shot, n_pts, cin), generator)
        q_feat = self.get_features(query_x, generator)
        return s_feat.reshape(n_way, k_shot, n_pts, -1), q_feat


class ProtoNet(FewShotEncoder):
    def __init__(self, n_way: int = 2, k_shot: int = 5,
                 dist_method: str = "cosine", **kw):
        if dist_method not in ("cosine", "euclidean"):
            raise NotImplementedError(dist_method)
        super().__init__(**kw)
        self.n_way, self.k_shot = n_way, k_shot
        self.dist_method = dist_method

    def forward(self, support_x: torch.Tensor, support_y: torch.Tensor,
                query_x: torch.Tensor, query_y: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """support_x (w, s, N, C), support_y (w, s, N) in {0, 1}, query_x
        (q, N, C), query_y (q, N) in {0..w} -> (query logits
        (q, N, w + 1), loss)."""
        n_way, k_shot = support_x.shape[:2]
        s_feat, q_feat = self.support_query_features(support_x, query_x,
                                                     generator)
        fg = support_y[..., None].to(s_feat.dtype)           # (w, s, N, 1)
        bg = 1.0 - fg
        fg_feat = torch.sum(s_feat * fg, dim=2) / (torch.sum(fg, dim=2)
                                                   + 1e-5)
        bg_feat = torch.sum(s_feat * bg, dim=2) / (torch.sum(bg, dim=2)
                                                   + 1e-5)
        fg_protos = torch.sum(fg_feat, dim=1) / k_shot       # (w, D)
        bg_proto = torch.sum(bg_feat, dim=(0, 1)) / (n_way * k_shot)
        protos = torch.cat([bg_proto[None], fg_protos], dim=0)

        if self.dist_method == "cosine":
            sim = 10.0 * torch.einsum("qnd,pd->qnp", l2norm(q_feat, -1),
                                      l2norm(protos, -1))
        else:
            diff = q_feat[:, :, None, :] - protos[None, None, :, :]
            sim = -torch.sum(diff * diff, dim=-1)
        return sim, cross_entropy(sim, query_y)
