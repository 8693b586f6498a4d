"""PyTorch port on the CPU: a torch model of the kNN selection that
`knn_split_kernel` (K1's first stage, K3 and K6 at C <= 64, k <= 32; in
gfs3dseg_gws_tpu_torch/csrc/fused_edgeconv.cu) runs, held bit for bit to the
twin `knn_indices_plain` on the same distances.

The kernel splits each query's keys over S threads (S = 2, or 4 for K3 at
C > 16). Key tile by key tile
(64 keys), thread s takes its share in index order, interleaved (keys
S i + s of the tile) or contiguous (keys 64 / S * s + i), and keeps its own
sorted list of k (distance, index):
- a key goes through only if it is nearer than the list's own k-th entry,
  and no farther than the largest of the S lists' ceil(k / S)-th entries as
  they stood at the tile's start (S lists then hold >= k keys at least as
  near, so a farther key is not among the k nearest);
- it is inserted after every listed key at its distance.
At the end the S lists are merged by (distance, index). The model runs the
S lists of every query at once, one step per key of a share.

Inputs: the copied-points block of tests/test_torch_port_knn_ties.py
(chip_smoke.copied_block: exact ties), a random block and a ragged N (not a
multiple of 64).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gfs3dseg_gws_tpu.ops.knn import _knn_xla
from chip_smoke import copied_block
from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices_plain, pairwise_sq_dists
from torch_port_util import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

TILE = 64


def split_select(d: torch.Tensor, k: int, splits: int,
                 layout: str = "interleaved") -> torch.Tensor:
    """The kernel's selection on distances d (Q, N): (Q, k) int32 indices,
    nearest first, ties to the lower index."""
    q, n = d.shape
    share = TILE // splits
    m = -(-k // splits) - 1                     # the slot the bound reads
    lists_d = torch.full((q, splits, k), float("inf"), dtype=d.dtype)
    lists_i = torch.zeros((q, splits, k), dtype=torch.int64)
    slots = torch.arange(k)
    s = torch.arange(splits)
    for base in range(0, n, TILE):
        nk = min(TILE, n - base)
        bound = (lists_d[:, :, m].amax(1, keepdim=True) if base
                 else torch.full((q, 1), float("inf"), dtype=d.dtype))
        for i in range(share):
            r = splits * i + s if layout == "interleaved" else share * s + i
            valid = r < nk                                       # (S,)
            j = base + torch.where(valid, r, 0)
            dj = d[:, j]                                         # (Q, S)
            take = valid & (dj < lists_d[:, :, k - 1]) & (dj <= bound)
            pos = (lists_d <= dj[..., None]).sum(-1, keepdim=True)
            for lst, new in ((lists_d, dj), (lists_i, j.expand(q, splits))):
                shifted = torch.cat([lst[..., :1], lst[..., :-1]], -1)
                ins = torch.where(slots < pos, lst,
                                  torch.where(slots == pos, new[..., None],
                                              shifted))
                lst.copy_(torch.where(take[..., None], ins, lst))
    # merge by (distance, index): sort by index, then stably by distance
    flat_d, flat_i = lists_d.reshape(q, -1), lists_i.reshape(q, -1)
    by_i = torch.argsort(flat_i, dim=-1, stable=True)
    flat_d, flat_i = flat_d.gather(-1, by_i), flat_i.gather(-1, by_i)
    by_d = torch.argsort(flat_d, dim=-1, stable=True)
    return flat_i.gather(-1, by_d)[:, :k].to(torch.int32)


def _random_block(n, c=9, seed=3):
    r = np.random.default_rng(seed)
    return r.standard_normal((2, n, c)).astype(np.float32)


BLOCKS = {"copied": copied_block, "random": lambda: _random_block(512),
          "ragged": lambda: _random_block(300)}


@pytest.fixture(scope="module")
def dists():
    """Each block's points and pairwise_sq_dists, (B, N, N)."""
    out = {}
    for name, make in BLOCKS.items():
        x = torch.from_numpy(make())
        out[name] = (x, pairwise_sq_dists(x, x))
    return out


@pytest.mark.parametrize("layout", ["interleaved", "contiguous"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_selection_equals_plain(dists, splits, k, block, layout):
    """S partial lists merged by (distance, index) give knn_indices_plain's
    indices, order included, on every row."""
    x, d = dists[block]
    b, n, _ = d.shape
    got = split_select(d.reshape(b * n, n), k, splits, layout)
    np.testing.assert_array_equal(got.reshape(b, n, k).numpy(),
                                  knn_indices_plain(x, k).numpy())


@pytest.mark.parametrize("splits", [2, 4])
def test_split_selection_equals_xla_on_copied_points(dists, splits):
    """The model at the kernel's S against JAX's _knn_xla on the block of
    copied points: order and set on every row."""
    x, d = dists["copied"]
    b, n, _ = d.shape
    got = split_select(d.reshape(b * n, n), 20, splits).reshape(
        b, n, 20).numpy()
    ref = np.asarray(_knn_xla(jnp.asarray(x.numpy()), 20))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(ref, -1))
