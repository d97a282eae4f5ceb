"""Deterministic skiplist tower heights (the port's own copy of the
promotion in ``repro.core.skiplist`` and the hash it uses).

The ordered map's index towers are volatile (the paper's Property 2): they
are rebuilt after a crash from the persistent bottom list.  Their heights
come from the key's hash alone, so the rebuilt index is identical to the
one before the crash, whichever package built it.  The hash is 64-bit
splitmix; it runs on the host, in Python integers or numpy ``uint64``
(PyTorch has no unsigned 64-bit shifts).
"""
from __future__ import annotations

import numpy as np

_M64 = 0xFFFFFFFFFFFFFFFF
_SALT = 0xA5A5_5A5A


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def tower_height(key: int, max_level: int) -> int:
    """Deterministic promotion: geometric(1/2) from the key hash."""
    h = _splitmix(int(key) ^ _SALT)
    level = 1
    while (h & 1) and level < max_level:
        level += 1
        h >>= 1
    return level


def tower_heights(keys, max_level: int) -> np.ndarray:
    """Vectorized twin of :func:`tower_height` (int32 levels).

    >>> tower_heights(np.arange(64), 8).tolist() == \\
    ...     [tower_height(k, 8) for k in range(64)]
    True
    """
    x = (np.asarray(keys, np.int64).astype(np.uint64) ^ np.uint64(_SALT))
    with np.errstate(over="ignore"):          # splitmix wraps mod 2**64
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    level = np.ones(x.shape, np.int64)
    alive = np.ones(x.shape, np.bool_)
    for _ in range(max_level - 1):
        alive &= (x & np.uint64(1)).astype(bool) & (level < max_level)
        level += alive
        x = x >> np.uint64(1)
    return level.astype(np.int32)
