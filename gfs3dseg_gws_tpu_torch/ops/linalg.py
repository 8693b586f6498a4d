"""Small linear algebra of geometric-word extraction (counterpart of the
JAX package's ops/linalg.py::svd_energy_reconstruct; host numpy)."""
from __future__ import annotations

import numpy as np


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
