"""Lock-free skiplist in traversal form, and its deterministic tower
heights (the port's own copy of ``repro.core.skiplist`` and the hash it
uses).

Paper §3, Property 2: "a skiplist can be a traversal data structure since
... only a linked list at the bottom level holds all the data, while the
rest of the nodes and edges simply serve as a way to access the linked list
faster".  Accordingly:

  * the **core tree** is the bottom-level Harris list (persistent);
  * the **index towers are auxiliary and volatile** -- they live outside the
    persistent pool, are consulted only by ``findEntry`` to pick a shortcut
    entry node, and are *reconstructed* after a crash (the optional
    Property 2 rebuild function, implemented in :meth:`SkipList.
    rebuild_index`).

Tower heights come from the key's hash alone, so the rebuilt index is
identical to the one before the crash, whichever package or engine built
it (:mod:`repro_torch.core.ordered` builds its towers from
:func:`tower_heights`).  The hash is 64-bit splitmix; it runs on the host,
in Python integers or numpy ``uint64`` (PyTorch has no unsigned 64-bit
shifts).  :mod:`repro_torch.core.hash_table` hashes with the same
:func:`_splitmix`, so this module must not import it.

``findEntry`` may return a stale or concurrently-marked shortcut node; the
inherited traversal falls back to the bottom head in that case (see
``HarrisList.traverse``), preserving correctness with zero persistence cost
for the index.
"""
from __future__ import annotations

import bisect
from typing import Dict, List

import numpy as np

from .harris_list import KEY, NXT, HarrisList
from .instr import OpContext, is_marked
from .pmem import PMem
from .traversal import TraverseResult

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


class SkipList(HarrisList):
    def __init__(self, mem: PMem, *, max_level: int = 8):
        super().__init__(mem)
        self.max_level = max_level
        # volatile auxiliary index: level -> sorted list of (key, node_addr)
        self.index: Dict[int, List[tuple]] = {l: [] for l in
                                              range(2, max_level + 1)}

    # ------------------------------------------------------------------ #
    def find_entry(self, ctx: OpContext, op: str, args) -> int:
        """Descend the volatile towers to the closest shortcut with
        key strictly below the target; fall back to the bottom head."""
        k = args[0]
        entry = self.head
        best = None
        for level in range(self.max_level, 1, -1):
            lst = self.index.get(level, ())
            i = bisect.bisect_left(lst, (k, -1)) - 1
            if i >= 0:
                key, addr = lst[i]
                # validity probe (a shared read; a stale/marked shortcut is
                # tolerated — the traversal falls back)
                if not is_marked(ctx.read(addr + NXT)):
                    best = (key, addr)
                    break
        if best is not None:
            entry = best[1]
        return entry

    # traverse/critical/Protocol 1 inherited from HarrisList.

    def post_insert(self, key: int, addr: int) -> None:
        """Volatile index maintenance after a successful insert."""
        h = tower_height(key, self.max_level)
        for level in range(2, h + 1):
            lst = self.index[level]
            i = bisect.bisect_left(lst, (key, -1))
            if i >= len(lst) or lst[i][0] != key:
                lst.insert(i, (key, addr))

    def post_delete(self, key: int) -> None:
        for level in range(2, self.max_level + 1):
            lst = self.index[level]
            i = bisect.bisect_left(lst, (key, -1))
            if i < len(lst) and lst[i][0] == key:
                del lst[i]

    def critical(self, ctx: OpContext, tr: TraverseResult, op: str, args):
        restart, val = super().critical(ctx, tr, op, args)
        if not restart and val:
            if op == "insert":
                # locate the published node (volatile bookkeeping only — a
                # stale entry is tolerated by the findEntry validity probe).
                addr = self._addr_of(args[0])
                if addr is not None:
                    self.post_insert(args[0], addr)
            elif op == "delete":
                self.post_delete(args[0])
        return restart, val

    # ------------------------------------------------------------------ #
    def rebuild_index(self) -> None:
        """Property 2's optional reconstruction function — run on recovery.

        One :meth:`~repro.core.harris_list.HarrisList.sorted_snapshot`
        walk re-promotes every live key deterministically (the old
        per-key ``_addr_of`` rescan was O(n²) and rotted the harness on
        large recoveries); the resulting towers are bit-identical to the
        incrementally maintained pre-crash index."""
        self.index = {l: [] for l in range(2, self.max_level + 1)}
        for key, addr in self.sorted_snapshot():
            self.post_insert(key, addr)

    def _addr_of(self, key: int):
        image = self.mem.volatile
        curr = (int(image[self.head + NXT])) >> 1
        while curr and curr != self.tail:
            w = int(image[curr + NXT])
            if not (w & 1) and int(image[curr + KEY]) == key:
                return curr
            curr = w >> 1
        return None

    def disconnect(self) -> None:
        HarrisList.disconnect(self)
        self.rebuild_index()
