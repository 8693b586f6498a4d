"""PyTorch port, ops: each kernel's plain version and the plain ops against
the JAX package on the same numpy inputs (CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gfs3dseg_gws_tpu.ops import attention_kernel as jax_attn
from gfs3dseg_gws_tpu.ops import fused_edgeconv as jax_fec
from gfs3dseg_gws_tpu.ops.coding import energy_multihot as jax_multihot
from gfs3dseg_gws_tpu.ops.knn import _knn_xla
from gfs3dseg_gws_tpu.ops.metrics import confusion_matrix as jax_confusion
from gfs3dseg_gws_tpu.ops.metrics import gfs_miou as jax_gfs_miou
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import (attention_plain,
                                                         fused_attention)
from gfs3dseg_gws_tpu_torch.ops.coding import energy_multihot
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (fused_edgeconv_infer,
                                                       fused_edgeconv_plain)
from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices
from gfs3dseg_gws_tpu_torch.ops.metrics import confusion_matrix, gfs_miou
from gfs3dseg_gws_tpu_torch.utils.observability import calls
from torch_port_util import one_thread, set_fp32, t

pytestmark = pytest.mark.usefixtures("one_thread")

B, N, W, K = 2, 128, 8, 5


@pytest.fixture(autouse=True)
def _fp32():
    set_fp32()


def _edgeconv_inputs(c, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, N, c)).astype(np.float32),
            r.standard_normal((B, N, W)).astype(np.float32),
            r.standard_normal((B, N, W)).astype(np.float32),
            (r.standard_normal((W, W)) * 0.3).astype(np.float32),
            (r.standard_normal((W,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("c", [9, 8])
def test_fused_edgeconv_plain_matches_xla(c):
    args = _edgeconv_inputs(c, seed=c)
    ref = np.asarray(jax_fec._fused_edgeconv_xla(*map(jnp.asarray, args),
                                                 k=K, neg_slope=0.2))
    got = fused_edgeconv_plain(*map(t, args), k=K).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_fused_edgeconv_plain_close_to_pallas_interpret():
    """The TPU kernel rounds its gathers and matmuls to bf16: the bounds of
    tests/test_fused_edgeconv.py:42-55."""
    args = _edgeconv_inputs(9, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fec.fused_edgeconv_infer(
            *map(jnp.asarray, args), k=K, tile_q=64))
    got = fused_edgeconv_plain(*map(t, args), k=K).numpy()
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def _qkv(seed, n=N, d=16):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, n, d)).astype(np.float32) for _ in range(3)]


def test_attention_plain_matches_xla():
    q, k, v = _qkv(3)
    ref = np.asarray(jax_attn._attention_xla(*map(jnp.asarray, (q, k, v)),
                                             4.0))
    got = attention_plain(t(q), t(k), t(v), 4.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_attention_plain_matches_pallas_interpret():
    q, k, v = _qkv(4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attn.fused_attention(
            *map(jnp.asarray, (q, k, v)), 4.0, tile_q=64))
    got = attention_plain(t(q), t(k), t(v), 4.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c,k", [(9, 5), (64, 20)])
def test_knn_indices_match_xla(c, k):
    x = np.random.default_rng(c).standard_normal((B, N, c)).astype(np.float32)
    ref = np.asarray(_knn_xla(jnp.asarray(x), k))
    np.testing.assert_array_equal(knn_indices(t(x), k).numpy(), ref)


@pytest.mark.parametrize("energy", [0.5, 0.9, 1.0])
def test_energy_multihot_matches_jax(energy):
    r = np.random.default_rng(5)
    # multiples of 1/8 sum exactly in any order, and repeat (ties)
    coding = (r.integers(0, 6, (4, 3, 20)) / 8.0).astype(np.float32)
    coding[0, 0] = 0.25                               # all tied
    ref = np.asarray(jax_multihot(jnp.asarray(coding), energy))
    np.testing.assert_array_equal(energy_multihot(t(coding), energy).numpy(),
                                  ref)


def test_confusion_and_gfs_miou_match_jax():
    r = np.random.default_rng(6)
    c = 13
    gt = r.integers(0, c, (3, 50))
    pred = np.where(r.random((3, 50)) < 0.6, gt, r.integers(0, c, (3, 50)))
    gt[0, :c] = np.arange(c)              # every class present
    mask = np.ones((3, 50), np.float32)
    mask[2] = 0                           # a padded row
    ref = np.asarray(jax_confusion(jnp.asarray(pred), jnp.asarray(gt), c,
                                   jnp.asarray(mask)))
    got = confusion_matrix(t(pred), t(gt), c, t(mask)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        confusion_matrix(t(pred), t(gt), c).numpy(),
        np.asarray(jax_confusion(jnp.asarray(pred), jnp.asarray(gt), c)))
    order = [0, 1, 2, 4, 6, 8, 9, 3, 5, 7, 10, 11, 12]
    novel = [3, 5, 7, 10, 11, 12]
    for a, b in zip(gfs_miou(got, order, novel),
                    jax_gfs_miou(ref, order, novel)):
        np.testing.assert_array_equal(a, b)


def test_cpu_tensors_take_the_plain_path_without_launches():
    ec = _edgeconv_inputs(9, seed=7)
    q, k, v = _qkv(8)
    before = (calls("op.k1"), calls("op.k2"))
    np.testing.assert_array_equal(
        fused_edgeconv_infer(*map(t, ec), k=K).numpy(),
        fused_edgeconv_plain(*map(t, ec), k=K).numpy())
    np.testing.assert_array_equal(
        fused_attention(t(q), t(k), t(v), 4.0).numpy(),
        attention_plain(t(q), t(k), t(v), 4.0).numpy())
    assert (calls("op.k1"), calls("op.k2")) == before


def test_non_cpu_non_cuda_tensors_raise():
    """Dispatch is by device alone: a tensor that is neither on the CPU nor
    on CUDA reaches the kernel checks and is refused, not sent to the plain
    version."""
    q = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        fused_attention(q, q, q, 2.0)
    x = torch.empty((1, 8, 3), device="meta")
    a = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        fused_edgeconv_infer(x, a, a, torch.empty((4, 4), device="meta"),
                             torch.empty((4,), device="meta"), k=2)
