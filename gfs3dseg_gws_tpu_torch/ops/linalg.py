"""Small linear algebra (counterpart of the JAX package's ops/linalg.py):
the energy-truncated SVD of geometric-word extraction (host numpy), and
MPTI's k-NN affinity graph and label propagation (torch, on the caller's
device).

MPTI's k-NN (k_connect = 200 over ~4,400 nodes of 192 dims) is
`lax.top_k` on `pairwise_sq_dists` in JAX, not a Pallas site, so it is
torch here too: a stable sort, so that exact ties (duplicate seeds, the
background sentinel rows of `multi_prototypes`) go to the lower index as
they do in `lax.top_k`.
"""
from __future__ import annotations

import numpy as np
import torch

from gfs3dseg_gws_tpu_torch.ops.knn import pairwise_sq_dists


def svd_energy_reconstruct(protos: np.ndarray, energy: float = 0.95
                           ) -> np.ndarray:
    """Energy-truncated SVD reconstruction of the geometric-word basis
    (reference get_basis.py:50-71).

    SVD of protos^T (D, K); keep the smallest rank r with sum(s[:r]) >
    energy * sum(s); return (u[:, :r] diag(s[:r]) vh[:r])^T, float32. All K
    rows stay: the truncation lowers the rank, not the row count.
    """
    a = np.asarray(protos, dtype=np.float64).T               # (D, K)
    u, s, vh = np.linalg.svd(a, full_matrices=False)
    cum = np.cumsum(s)
    r = int(np.searchsorted(cum > energy * cum[-1], True)) + 1
    recon = u[:, :r] @ np.diag(s[:r]) @ vh[:r, :]            # (D, K)
    return recon.T.astype(np.float32)                        # (K, D)


def local_constrained_affinity(node_feat: torch.Tensor, k: int,
                               sigma: float = 1.0,
                               method: str = "gaussian") -> torch.Tensor:
    """The k-NN-sparsified affinity of MPTI's graph (reference
    pretrain/models/mpti.py:230-270): each node's k nearest other nodes,
    weighted exp(-d^2 / (2 sigma^2)) (`gaussian`) or by cosine similarity
    (`cosine`), symmetrised as A + A^T with a zero diagonal. node_feat
    (M, D) -> (M, M). The gradient reaches node_feat through the kept
    distances (or cosines), not through the choice of neighbours."""
    m = node_feat.shape[0]
    eye = torch.eye(m, dtype=node_feat.dtype, device=node_feat.device)
    # the node itself is never its own neighbour (faiss: search k + 1,
    # drop the first)
    d2 = pairwise_sq_dists(node_feat, node_feat) + eye * 1e30
    idx = torch.sort(-d2.detach(), dim=1, descending=True,
                     stable=True).indices[:, :k]                 # (M, k)
    if method == "gaussian":
        # from d^2 itself: JAX squares sqrt(d^2), whose gradient is NaN
        # where two nodes coincide (duplicate seeds, the sentinel rows);
        # the values agree within rounding, the gradients wherever JAX's
        # are finite
        sim = torch.exp(-0.5 * torch.clamp_min(torch.gather(d2, 1, idx), 0.0)
                        / sigma ** 2)
    elif method == "cosine":
        unit = node_feat / (torch.linalg.vector_norm(
            node_feat, dim=-1, keepdim=True) + 1e-12)
        sim = torch.gather(unit @ unit.t(), 1, idx)
    else:
        raise NotImplementedError(method)
    a = torch.zeros((m, m), dtype=sim.dtype,
                    device=node_feat.device).scatter(1, idx, sim)
    return (a + a.t()) * (1.0 - eye)


def label_propagate(affinity: torch.Tensor, labels: torch.Tensor,
                    alpha: float = 0.99) -> torch.Tensor:
    """Closed-form label propagation (Zhou et al. 2003; reference
    pretrain/models/mpti.py:273-292): Z = (I - alpha S + eps)^-1 Y with
    S = D^-1/2 A D^-1/2, found by solving the system, never by inverting.
    eps (float64's machine epsilon, as the reference) is added to every
    entry. affinity (M, M) symmetric with a zero diagonal, labels (M, C)
    -> (M, C)."""
    eps = float(np.finfo(np.float64).eps)
    d_inv_sqrt = torch.rsqrt(torch.sum(affinity, dim=1) + eps)
    s = affinity * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
    m = affinity.shape[0]
    a = torch.eye(m, dtype=s.dtype, device=s.device) - alpha * s + eps
    return torch.linalg.solve(a, labels)
