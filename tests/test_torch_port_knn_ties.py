"""PyTorch port against the JAX package on the CPU: the kNN twin's tie order.

A block sampled with replacement holds copies of points, so many queries
meet keys at exactly equal distances. JAX's `_knn_xla` (`lax.top_k`) gives
such ties to the lower index; `knn_indices_plain`, and every twin that
calls it (K3's, K1's, K4's), must do the same, in order and in set.

Inputs are drawn with numpy; the JAX functions run their XLA path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import copied_block
from gfs3dseg_gws_tpu.ops.fused_edgeconv import _fused_edgeconv_xla
from gfs3dseg_gws_tpu.ops.knn import _knn_xla
from gfs3dseg_gws_tpu.ops.knn import knn_with_stats as jax_knn_with_stats
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import fused_edgeconv_plain
from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices, knn_indices_plain,
                                            knn_with_stats)
from torch_port_util import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

K = 20


@pytest.fixture(scope="module")
def block():
    return copied_block()


def test_knn_twin_equals_xla_on_copied_points(block):
    """Order and set equal to _knn_xla on every row (the old torch.topk
    twin differed in order on most rows of this block)."""
    ref = np.asarray(_knn_xla(jnp.asarray(block), K))
    got = knn_indices_plain(torch.from_numpy(block), K).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(ref, -1))
    # the entry point on a CPU tensor is the twin
    np.testing.assert_array_equal(
        knn_indices(torch.from_numpy(block), K).numpy(), ref)


def test_three_copies_come_lowest_index_first():
    r = np.random.default_rng(5)
    x = r.standard_normal((1, 500, 9)).astype(np.float32)
    x[0, 300] = x[0, 400] = x[0, 10]
    got = knn_indices_plain(torch.from_numpy(x), 5).numpy()
    ref = np.asarray(_knn_xla(jnp.asarray(x), 5))
    for row in (10, 300, 400):
        assert got[0, row, :3].tolist() == [10, 300, 400], got[0, row]
    np.testing.assert_array_equal(got, ref)


def test_knn_with_stats_twin_equals_xla_on_copied_points(block):
    """K3's twin against JAX's XLA path: idx and cnt exactly, scb within
    1e-5 of its largest entry (sums in another order)."""
    r = np.random.default_rng(1)
    btab = r.standard_normal((1, block.shape[1], 16)).astype(np.float32)
    ref = [np.asarray(t) for t in jax_knn_with_stats(
        jnp.asarray(block), jnp.asarray(btab), k=K, use_pallas=False)]
    got = [t.numpy() for t in knn_with_stats(torch.from_numpy(block),
                                             torch.from_numpy(btab), K)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert np.abs(got[2] - ref[2]).max() <= 1e-5 * np.abs(ref[2]).max()


def test_fused_edgeconv_twin_equals_xla_on_copied_points(block):
    """K1's twin (kNN, gather, layer 2, max) against JAX's XLA
    composition on the same block: within 1e-5 (one neighbour picked
    otherwise would move a row's max by far more)."""
    r = np.random.default_rng(2)
    n = block.shape[1]
    a, b = (r.standard_normal((1, n, 16)).astype(np.float32)
            for _ in range(2))
    w2 = (r.standard_normal((16, 16)) * 0.3).astype(np.float32)
    bias2 = (r.standard_normal(16) * 0.1).astype(np.float32)
    ref = np.asarray(_fused_edgeconv_xla(*(jnp.asarray(t) for t in (
        block, a, b, w2, bias2)), K, 0.2))
    got = fused_edgeconv_plain(*(torch.from_numpy(t) for t in (
        block, a, b, w2, bias2)), K).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
