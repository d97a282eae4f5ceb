"""Bucket-range boundaries for the sharded durable map (the port's own
copy of ``make_map_splits`` and ``replan_splits`` from
``repro.launch.mesh``; the device meshes there have no counterpart here,
where every shard lives on one card)."""
from __future__ import annotations

import numpy as np


def make_map_splits(n_buckets: int, n_shards: int, loads=None):
    """Contiguous bucket-range boundaries (``n_shards + 1`` ints) for the
    sharded durable map.

    Without ``loads`` this is the even partition.  With ``loads`` (one
    nonnegative weight per *global* bucket, e.g. accumulated
    ``ShardCommitStats.bucket_flushes``) the boundaries split the
    cumulative load into ``n_shards`` equal quantiles, every range kept
    non-empty.

    >>> make_map_splits(64, 4)
    (0, 16, 32, 48, 64)
    >>> make_map_splits(8, 2, loads=[12.0, 0, 0, 0, 0, 0, 0, 0])
    (0, 1, 8)
    """
    if loads is None:
        from ..core.sharded import even_splits
        return even_splits(n_buckets, n_shards)
    loads = np.asarray(loads, np.float64)
    if loads.shape != (n_buckets,):
        raise ValueError(f"loads must have shape ({n_buckets},)")
    cum = np.cumsum(loads + 1e-12)        # epsilon: empty buckets still
    total = cum[-1]                       # advance the quantile walk
    bounds = [0]
    for s in range(1, n_shards):
        b = int(np.searchsorted(cum, total * s / n_shards, side="left"))
        b = min(max(b, bounds[-1] + 1), n_buckets - (n_shards - s))
        bounds.append(b)
    bounds.append(n_buckets)
    return tuple(bounds)


def replan_splits(splits, loads, *, threshold: float = 1.5):
    """Should the boundaries move, given the per-bucket load since they
    were set?  Returns ``(new_splits, imbalance)``: ``imbalance`` is the
    hottest shard's load over the mean per-shard load (1.0 = balanced),
    ``new_splits`` the load-quantile re-plan, or ``None`` when the
    imbalance is within ``threshold``, there is no load, or the re-plan
    reproduces the current boundaries.

    >>> replan_splits((0, 2, 4), [10.0, 10.0, 10.0, 10.0])
    (None, 1.0)
    >>> replan_splits((0, 2, 4), [40.0, 0.0, 0.0, 0.0])
    ((0, 1, 4), 2.0)
    """
    splits = tuple(int(b) for b in splits)
    n_shards = len(splits) - 1
    n_buckets = splits[-1]
    loads = np.asarray(loads, np.float64)
    if loads.shape != (n_buckets,):
        raise ValueError(f"loads must have shape ({n_buckets},)")
    per = np.asarray([loads[a:b].sum()
                      for a, b in zip(splits, splits[1:])])
    total = float(per.sum())
    if total <= 0:
        return None, 1.0
    imbalance = float(per.max() / (total / n_shards))
    if imbalance <= threshold:
        return None, imbalance
    new = tuple(make_map_splits(n_buckets, n_shards, loads=loads))
    if new == splits:
        return None, imbalance
    return new, imbalance
