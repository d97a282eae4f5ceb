"""Lock-free hash table in traversal form (David et al. [18] style).
(the port's own copy of ``repro.core.hash_table``)

Fixed array of buckets, each bucket an independent Harris-list segment with
its own head/tail sentinels.  The core tree is rooted at the table object:
root → bucket heads → chains (the paper, §3: "hash tables have a core-tree
structure").  ``findEntry`` hashes the key and returns the bucket head —
the bucket array is immutable after construction, so findEntry performs no
mutable shared reads.

All traversal/critical/Protocol-1 behavior is inherited from
:class:`HarrisList`; only entry selection, enumeration and recovery differ.
The paper's observation that contention is per-bucket (and hence tiny for
large tables) is what makes the NVTraverse version beat link-and-persist on
the hash-table workloads (§5.3) — reproduced in the benchmark cost model.
"""
from __future__ import annotations

from typing import List

from .harris_list import KEY, NXT, VAL, KEY_MAX, KEY_MIN, HarrisList
from .instr import NULLPTR, OpContext, pack
from .pmem import PMem
# the port keeps one splitmix, beside the tower heights that also use it
# (skiplist.py must therefore never import this module)
from .skiplist import _splitmix


class HashTable(HarrisList):
    def __init__(self, mem: PMem, *, n_buckets: int = 16):
        # NOTE: deliberately not calling HarrisList.__init__ — the table has
        # per-bucket sentinels instead of a single head/tail pair.
        self.mem = mem
        self.use_orig_parent = False
        self.n_buckets = n_buckets
        self.heads: List[int] = []
        self.tails: List[int] = []
        for _ in range(n_buckets):
            tail = mem.alloc(self.NODE_WORDS)
            head = mem.alloc(self.NODE_WORDS)
            mem.write(tail + KEY, KEY_MAX)
            mem.write(tail + NXT, NULLPTR)
            mem.write(head + KEY, KEY_MIN)
            mem.write(head + NXT, pack(tail, 0))
            self.heads.append(head)
            self.tails.append(tail)
        mem.persist_all()
        self._head_index = {h: i for i, h in enumerate(self.heads)}

    # the table uses modulo of a mixed hash, like the paper's general
    # implementation (the bit-mask trick of David et al. is noted in §5.3)
    def bucket_of(self, key: int) -> int:
        return _splitmix(int(key)) % self.n_buckets

    def find_entry(self, ctx: OpContext, op: str, args) -> int:
        return self.heads[self.bucket_of(args[0])]

    def _segment_head(self, entry: int) -> int:
        # entry is always a bucket head here (findEntry returns heads only)
        return entry

    # ------------------------------------------------------------------ #
    def disconnect(self) -> None:
        for head in self.heads:
            self.head = head          # reuse the list trimmer per bucket
            HarrisList.disconnect(self)
        del self.head

    def _walk_bucket(self, image, head) -> dict:
        self.head = head
        self.tail = self.tails[self._head_index[head]]
        try:
            return HarrisList._walk(self, image)
        finally:
            del self.head, self.tail

    def contents(self) -> dict:
        out = {}
        for h in self.heads:
            out.update(self._walk_bucket(self.mem.volatile, h))
        return out

    def persistent_contents(self) -> dict:
        out = {}
        for h in self.heads:
            out.update(self._walk_bucket(self.mem.persistent, h))
        return out

    def check_integrity(self, *, require_unmarked: bool = False) -> None:
        for i, h in enumerate(self.heads):
            self.head = h
            self.tail = self.tails[i]
            try:
                HarrisList.check_integrity(
                    self, require_unmarked=require_unmarked)
                # every key in this bucket must hash here
                for k in HarrisList._walk(self, self.mem.volatile):
                    assert self.bucket_of(k) == i, "key in wrong bucket"
            finally:
                del self.head, self.tail
