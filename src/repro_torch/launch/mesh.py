"""Meshes, bucket-range boundaries for the sharded durable map, and the
roofline constants of the card (the port's own copy of
``repro.launch.mesh``).

The meshes are device-free: a :class:`Mesh` has the reference's
``axis_names`` and a ``shape`` mapping and nothing else, the counterpart
of what the reference's sharding rules read off a JAX mesh
(``mesh.shape[a]``, ``mesh.axis_names``).  No 256-card mesh exists here;
the dry-run reads the production layouts' shard shapes from them.  The
port's sharded durable map does not use :func:`make_map_mesh`: its shards
share one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

# NVIDIA H100 SXM5 80GB at its 700 W limit: datasheet figures (not
# measured here), the roofline's denominators.
PEAK_FLOPS_BF16 = 989e12     # dense bf16 tensor-core flop/s
HBM_BW = 3.35e12             # HBM3 bytes/s
HBM_BYTES = 80e9             # device memory, bytes
NVLINK_BW = 450e9            # NVLink 4 bytes/s, each direction


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device-free mesh: axis names and their sizes."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes, dtype=np.int64))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layouts: 16 x 16 ("data", "model"), or
    2 x 16 x 16 with an outer "pod" axis."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_card_mesh() -> Mesh:
    """One card: the ("data", "model") axes of size 1 (the dry-run's
    ``h100`` layout)."""
    return Mesh(("data", "model"), (1, 1))


def make_test_mesh(n_data: int = 2, n_model: int = 4) -> Mesh:
    """A small ("data", "model") mesh for tests."""
    return Mesh(("data", "model"), (n_data, n_model))


def make_map_mesh(n_shards: int) -> Mesh:
    """The 1-D ("shards",) layout of the reference's sharded durable map."""
    return Mesh(("shards",), (n_shards,))


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
