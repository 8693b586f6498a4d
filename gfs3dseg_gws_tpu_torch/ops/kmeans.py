"""Batched k-means for geometric-word extraction (counterpart of the JAX
package's ops/kmeans.py; replaces the sklearn KMeans of reference
get_basis.py:210-213).

k-means++ seeding runs on the host in numpy and float64, as in JAX, so the
same seed gives the same centres bit for bit. Lloyd's iterations run on
the tensor's device: the assignment is one (N, D) x (D, K) product, the
sums one `index_add_`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def kmeans_plus_plus_init(rng: np.random.Generator, x: np.ndarray, k: int,
                          subsample: int = 100_000) -> np.ndarray:
    """k-means++ seeding on a subsample of at most `subsample` rows, with
    sklearn's 2 + log(k) local trials per centre. Distances are
    |c|^2 + |x|^2 - 2 c.x, accumulated in float64."""
    n = x.shape[0]
    if n > subsample:
        idx = rng.choice(n, subsample, replace=False)
        x = x[idx]
        n = subsample
    n_trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    centers[0] = x[rng.integers(n)]
    x64 = x.astype(np.float64)
    xx = np.einsum("nd,nd->n", x64, x64)
    c0 = centers[0].astype(np.float64)
    closest = np.maximum(xx - 2.0 * (x64 @ c0) + c0 @ c0, 0.0)
    for i in range(1, k):
        pot = closest.sum()
        cand = rng.choice(n, n_trials, p=closest / pot)
        xc = x64[cand]                                       # (T, D)
        d_cand = np.maximum(
            xx[None, :] - 2.0 * (xc @ x64.T)
            + np.einsum("td,td->t", xc, xc)[:, None], 0.0)   # (T, n)
        new_closest = np.minimum(closest[None, :], d_cand)
        best = new_closest.sum(-1).argmin()
        centers[i] = x[cand[best]]
        closest = new_closest[best]
    return centers


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """argmin_k |x - c_k|^2 = argmax_k (2 x.c_k - |c_k|^2), the first on a
    tie."""
    cc = torch.sum(centers * centers, dim=-1)
    return torch.argmax(2.0 * (x @ centers.T) - cc[None, :], dim=-1)


def lloyd(x: torch.Tensor, centers0: torch.Tensor, n_iters: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`n_iters` Lloyd iterations on x (N, D) from centers0 (K, D), on x's
    device in fp32. An empty cluster keeps its centre. Returns (centers
    (K, D), labels (N,) int64 of those centers)."""
    x = x.float()
    centers = centers0.to(x.device, torch.float32)
    k = centers.shape[0]
    for _ in range(n_iters):
        labels = _assign(x, centers)
        sums = torch.zeros_like(centers).index_add_(0, labels, x)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        new = sums / counts.clamp_min(1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    return centers, _assign(x, centers)


def kmeans(x, k: int, n_iters: int = 50, seed: int = 0, device="cpu"
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster the rows of x into k groups: k-means++ seeding, then Lloyd
    on `device`.

    Returns (centers (k, D) float32, labels (N,) int32) as numpy arrays.
    """
    x = np.asarray(x, dtype=np.float32)
    rng = np.random.default_rng(seed)
    centers0 = kmeans_plus_plus_init(rng, x, k)
    centers, labels = lloyd(torch.from_numpy(x).to(device),
                            torch.from_numpy(centers0), n_iters)
    return (centers.cpu().numpy(),
            labels.cpu().numpy().astype(np.int32))


def cluster_means(x: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    """Per-cluster means of the members in float64 (reference
    get_basis.py:27-44). Asserts that no cluster is empty, like the
    reference."""
    x = np.asarray(x, dtype=np.float64)
    sums = np.zeros((k, x.shape[1]), dtype=np.float64)
    np.add.at(sums, labels, x)
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    assert (counts > 0).all(), "empty k-means cluster"
    return (sums / counts[:, None]).astype(np.float32)
