"""Batching iterator feeding fixed-shape device batches.

The port's own copy of the JAX package's data/pipeline.py; it imports
nothing of that package, so the two can be held against each other.

Replaces the reference's torch DataLoader worker pool with a thread-pool
prefetcher: blocks are sampled host-side (numpy) while the device computes,
then stacked into (B, N, C) arrays.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator

import numpy as np


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: int = 0,
    num_workers: int = 8,
    epoch: int = 0,
    pad_final: bool = False,
) -> Iterator:
    """Iterate `dataset` in batches of stacked numpy arrays.

    Each __getitem__(i, rng) (or __getitem__(i)) must return a tuple of
    arrays/scalars; the iterator stacks each field. With pad_final=True the
    last short batch is padded by repeating its first element and a
    `valid` count is appended to the tuple (keeps shapes static for jit).
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    if drop_last:
        order = order[: (n // batch_size) * batch_size]

    # probe the SIGNATURE, not a call: catching TypeError around the whole
    # __getitem__ would misread a genuine in-item TypeError (corrupt pickle,
    # malformed augment config) as "no rng support" and silently degrade
    # every later fetch to the unseeded path
    import inspect

    try:
        supports_rng = "rng" in inspect.signature(
            dataset.__getitem__).parameters
    except (TypeError, ValueError):
        supports_rng = False

    def fetch(i, idx):
        if supports_rng:
            rng = np.random.default_rng((seed, epoch, int(i)))
            return dataset.__getitem__(int(idx), rng=rng)
        return dataset[int(idx)]

    def stack(samples, valid):
        fields = list(zip(*samples))
        arrays = [np.stack([np.asarray(f) for f in field]) for field in fields]
        if pad_final:
            arrays.append(np.asarray(valid, dtype=np.int32))
        return tuple(arrays)

    with cf.ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        batches = [order[i: i + batch_size]
                   for i in range(0, len(order), batch_size)]
        # prefetch pipeline: schedule next batch while current is consumed
        pending = []
        for bi, idxs in enumerate(batches):
            pending.append([pool.submit(fetch, bi * batch_size + j, idx)
                            for j, idx in enumerate(idxs)])
            if len(pending) > 2:  # keep up to 2 batches in flight
                futs = pending.pop(0)
                samples = [f.result() for f in futs]
                yield _finalize(samples, batch_size, pad_final, stack)
        for futs in pending:
            samples = [f.result() for f in futs]
            yield _finalize(samples, batch_size, pad_final, stack)


def _finalize(samples, batch_size, pad_final, stack):
    valid = len(samples)
    if pad_final and valid < batch_size:
        samples = samples + [samples[0]] * (batch_size - valid)
    return stack(samples, valid)
