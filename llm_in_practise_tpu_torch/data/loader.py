"""Array batching with a seeded shuffle and per-process shards.

Port of ``llm_in_practise_tpu/data/loader.py`` (a copy). ``epoch``
seeds the shuffle (``DistributedSampler.set_epoch``), so processes that
share a seed draw the same order without talking; with
``process_count > 1`` each takes a disjoint interleaved shard of every
batch. Arrays stay host numpy; the caller moves a batch to its device.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np


def batch_iterator(
    arrays: tuple[np.ndarray, ...],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[tuple[np.ndarray, ...]]:
    """Per-process batch tuples from aligned arrays; the per-process
    batch is ``batch_size // process_count``."""
    n = len(arrays[0])
    if batch_size % process_count != 0:
        raise ValueError(
            f"batch {batch_size} not divisible by {process_count} processes")
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed + epoch)
        rng.shuffle(order)
    if process_count > 1:
        # a partial last batch would give processes different shapes
        drop_last = True
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(n_batches):
        idx = order[b * batch_size: (b + 1) * batch_size]
        idx = idx[process_index::process_count]
        yield tuple(a[idx] for a in arrays)


def num_batches(n_examples: int, batch_size: int,
                drop_last: bool = True) -> int:
    return (n_examples // batch_size if drop_last
            else -(-n_examples // batch_size))


def train_val_split(arrays: tuple[np.ndarray, ...],
                    val_fraction: float = 0.1, seed: int = 42
                    ) -> tuple[tuple[np.ndarray, ...], tuple[np.ndarray, ...]]:
    """Seeded random split of aligned arrays: ``(train, val)``."""
    n = len(arrays[0])
    order = np.random.default_rng(seed).permutation(n)
    n_val = int(n * val_fraction)
    val_idx, train_idx = order[:n_val], order[n_val:]
    return (tuple(a[train_idx] for a in arrays),
            tuple(a[val_idx] for a in arrays))
