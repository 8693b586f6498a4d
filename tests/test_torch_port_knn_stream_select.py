"""PyTorch port on the CPU: a torch model of the selection that K8's
`knn_stream_kernel` (gfs3dseg_gws_tpu_torch/csrc/knn_fold.cu; K8 for
k <= 256, and K1, K3 and K6 for 64 < k <= 256) runs, held bit for bit to
the twin `knn_indices_plain` on the same distances.

The kernel streams a query's keys 64 at a time, in index order. Keys are
(distance, index) packed into one integer: distinct, ordered as the twin
orders them (nearest first, ties to the lower index). Each query keeps:
- a sorted list of kl = max(32, k rounded up to a power of two) keys,
  all-ones (no key) at first;
- a queue of up to QUEUE = 64 taken keys.
A key of a tile is taken if it is below the list's k-th entry. Taken keys
are appended to the queue in index order. If a tile's taken keys would
overflow the queue, the queue is merged first and the tile's keys filtered
again against the new k-th entry; while the list holds fewer than k keys
(its k-th entry is no-key), a queue that holds k keys after a tile is
merged at once. A merge pads the queue with no-keys,
sorts it by a 64-wide bitonic network, lets list entry kl - 1 - t take the
smaller of itself and the queue's t-th (a bitonic sequence), and sorts the
list by a bitonic merge. At the end every non-empty queue is merged; the
list's first k indices are the query's neighbours. The model runs every
query at once, one tile a step, with the kernel's networks stage by stage.

The kernel packs the bits of a distance clamped at 0, whose order is the
float order; the model packs every float (the twin's distances may fall
just below 0 on the diagonal) through a map that keeps the float order.

Inputs: a block of copied points (chip_smoke.copied_block: exact ties), a
random block and a ragged N (not a multiple of 64), at k = 1, 20, 65, 80
and 256 (the kernel's cap).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gfs3dseg_gws_tpu.ops.knn import _knn_xla
from chip_smoke import copied_block
from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices_plain, pairwise_sq_dists
from torch_port_util import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

KERNEL = (Path(__file__).resolve().parents[1] / "gfs3dseg_gws_tpu_torch" /
          "csrc" / "knn_fold.cu")


def kernel_constant(name: str) -> int:
    """`constexpr int name = value;` in the kernel's source, so that the
    model keeps the kernel's tile, queue and cap."""
    found = re.findall(rf"constexpr int {name} = (\d+);", KERNEL.read_text())
    assert len(found) == 1, (name, found)
    return int(found[0])


TILE, QUEUE, KCAP = (kernel_constant(name)
                     for name in ("kTile", "kQueue", "kCap"))
NO_KEY = torch.iinfo(torch.int64).max


def pack(d: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """(distance, index) -> one int64 key ordered as (d, j), d any float32
    (-0.0 as +0.0), j < 2^31."""
    u = (d + 0.0).contiguous().view(torch.int32).long() & 0xFFFFFFFF
    order = torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u + 2 ** 31)
    return (order << 31) | j


def bitonic_sort(q: torch.Tensor) -> torch.Tensor:
    """q (R, 64) sorted ascending by the kernel's network: stage by stage,
    pair p (lane p) compares i = p / stride * 2 stride + p % stride with
    i + stride, ascending where i & size == 0."""
    q = q.clone()
    p = torch.arange(q.shape[1] // 2)
    size = 2
    while size <= q.shape[1]:
        stride = size // 2
        while stride > 0:
            i = p // stride * 2 * stride + p % stride
            a, b = q[:, i], q[:, i + stride]
            swap = (a > b) == ((i & size) == 0)
            q[:, i] = torch.where(swap, b, a)
            q[:, i + stride] = torch.where(swap, a, b)
            stride //= 2
        size *= 2
    return q


def merge(lists, queue, fill, k):
    """The kernel's merge of every row's queue (fill keys) into its list:
    (new lists, their k-th keys)."""
    kl = lists.shape[1]
    q = torch.where(torch.arange(QUEUE) < fill[:, None], queue, NO_KEY)
    q = bitonic_sort(q)
    lists = lists.clone()
    t = torch.arange(min(kl, QUEUE))
    lists[:, kl - 1 - t] = torch.minimum(lists[:, kl - 1 - t], q[:, t])
    p = torch.arange(kl // 2)
    stride = kl // 2
    while stride > 0:
        i = p // stride * 2 * stride + p % stride
        a, b = lists[:, i], lists[:, i + stride]
        lists[:, i], lists[:, i + stride] = (torch.minimum(a, b),
                                             torch.maximum(a, b))
        stride //= 2
    return lists, lists[:, k - 1]


def stream_select(d: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's selection on distances d (R, N): (R, k) int32 indices,
    nearest first, ties to the lower index."""
    rows, n = d.shape
    kl = max(32, 1 << (k - 1).bit_length())
    lists = torch.full((rows, kl), NO_KEY)
    queue = torch.full((rows, QUEUE), NO_KEY)
    fill = torch.zeros(rows, dtype=torch.int64)
    thr = torch.full((rows,), NO_KEY)

    def merge_where(mask):
        nonlocal lists, thr, fill
        new, kth = merge(lists, queue, fill, k)
        lists = torch.where(mask[:, None], new, lists)
        thr = torch.where(mask, kth, thr)
        fill = torch.where(mask, 0, fill)

    for base in range(0, n, TILE):
        j = base + torch.arange(TILE)
        valid = j < n
        keys = pack(d[:, j.clamp(max=n - 1)], j)              # (R, 64)
        take = valid & (keys < thr[:, None])
        over = fill + take.sum(1) > QUEUE
        if over.any():
            merge_where(over)
            take = valid & (keys < thr[:, None])
        pos = fill[:, None] + take.cumsum(1) - 1
        r, c = take.nonzero(as_tuple=True)
        queue[r, pos[r, c]] = keys[r, c]
        fill = fill + take.sum(1)
        merge_where((thr == NO_KEY) & (fill >= k))
    merge_where(fill > 0)
    return (lists[:, :k] & (2 ** 31 - 1)).to(torch.int32)


def _random_block(n, c=9, seed=3):
    r = np.random.default_rng(seed)
    return r.standard_normal((2, n, c)).astype(np.float32)


BLOCKS = {"copied": lambda: copied_block(n=300, copies=80),
          "random": lambda: _random_block(256),
          "ragged": lambda: _random_block(300)}


@pytest.fixture(scope="module")
def dists():
    """Each block's points and pairwise_sq_dists, (B, N, N)."""
    out = {}
    for name, make in BLOCKS.items():
        x = torch.from_numpy(make())
        out[name] = (x, pairwise_sq_dists(x, x))
    return out


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("k", [1, 20, 65, 80, KCAP])
def test_stream_selection_equals_plain(dists, k, block):
    """The list and queue, merged as the kernel merges them, give
    knn_indices_plain's indices, order included, on every row."""
    x, d = dists[block]
    b, n, _ = d.shape
    got = stream_select(d.reshape(b * n, n), k)
    np.testing.assert_array_equal(got.reshape(b, n, k).numpy(),
                                  knn_indices_plain(x, k).numpy())


@pytest.mark.parametrize("k", [20, 80])
def test_stream_selection_equals_xla_on_copied_points(dists, k):
    """The model against JAX's _knn_xla on the block of copied points:
    order and set on every row."""
    x, d = dists["copied"]
    b, n, _ = d.shape
    got = stream_select(d.reshape(b * n, n), k).reshape(b, n, k).numpy()
    ref = np.asarray(_knn_xla(jnp.asarray(x.numpy()), k))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(ref, -1))
