"""Lock-free external (leaf-oriented) BST in traversal form.
(the port's own copy of ``repro.core.bst``)

Modeled on Ellen et al. [20] (one of the paper's evaluated structures),
adapted to the simulator's word-addressed memory: instead of Ellen's
Info-descriptor flag/mark protocol, each internal node stores BOTH child
pointers in a single 64-bit word together with the deletion mark:

    child_word = (mark_dir << 62) | (left_addr << 31) | right_addr

so that *marking is a single CAS that atomically makes the node immutable*
(every subsequent CAS expects an unmarked word and fails), exactly
Definition 1.  The mark encodes which child is being deleted, so the mark
alone uniquely determines the legal disconnection instruction
(Property 5(2)): the parent's child slot is swung to the marked node's
*survivor*, resolved through any chain of marked descendants
(Property 5(3): disconnection order is irrelevant because resolution is
confluent).  This packing plays the role of Ellen's descriptors and is
recorded in DESIGN.md as a word-model adaptation.

Traversal properties: routing uses only the immutable ``key`` (Property
4(3)); the stopping condition is the immutable leaf flag (4(2)); marks do
not affect routing at all, so traversal stability (4(5)) holds trivially;
the returned nodes are the path suffix [grandparent, parent, leaf] and the
extra ``parents=[great-grandparent]`` serves the Lemma 4.1 ensureReachable
optimization.

Layout per node (one line): ``[key, value, is_leaf, child_word]``.
Sentinels (Ellen's ∞₁/∞₂): S2(key=+∞) → left S1(key=+∞) → left leaf(−∞);
every operable leaf therefore has a parent and grandparent.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .instr import OpContext
from .pmem import PMem
from .traversal import TraversalDS, TraverseResult

KEY, VAL, LEAF, CW = 0, 1, 2, 3

KEY_MIN = -(1 << 40)
KEY_MAX = (1 << 40)        # Ellen's inf1
KEY_MAX2 = (1 << 40) + 1   # Ellen's inf2 (root sentinel)

# child_word packing: 30 bits per child address, 2 mark bits (fits int64)
_ADDR_BITS = 30
_ADDR_MASK = (1 << _ADDR_BITS) - 1
MARK_NONE, MARK_LEFT, MARK_RIGHT = 0, 1, 2


def pack_cw(left: int, right: int, mark: int = MARK_NONE) -> int:
    assert 0 <= left <= _ADDR_MASK and 0 <= right <= _ADDR_MASK
    return (mark << (2 * _ADDR_BITS)) | (left << _ADDR_BITS) | right


def unpack_cw(w: int) -> tuple[int, int, int]:
    return ((w >> _ADDR_BITS) & _ADDR_MASK, w & _ADDR_MASK,
            w >> (2 * _ADDR_BITS))


def cw_is_marked(w: int) -> bool:
    return (w >> (2 * _ADDR_BITS)) != MARK_NONE


class ExternalBST(TraversalDS):
    NODE_WORDS = 4

    def __init__(self, mem: PMem):
        super().__init__(mem)
        leaf_min = self._make_leaf_raw(KEY_MIN, 0)
        leaf_max1 = self._make_leaf_raw(KEY_MAX, 0)
        leaf_max2 = self._make_leaf_raw(KEY_MAX2, 0)
        self.s1 = mem.alloc(self.NODE_WORDS)
        mem.write(self.s1 + KEY, KEY_MAX)
        mem.write(self.s1 + CW, pack_cw(leaf_min, leaf_max1))
        self.s2 = mem.alloc(self.NODE_WORDS)
        mem.write(self.s2 + KEY, KEY_MAX2)
        mem.write(self.s2 + CW, pack_cw(self.s1, leaf_max2))
        mem.persist_all()

    def _make_leaf_raw(self, k: int, v: int) -> int:
        a = self.mem.alloc(self.NODE_WORDS)
        self.mem.write(a + KEY, k)
        self.mem.write(a + VAL, v)
        self.mem.write(a + LEAF, 1)
        return a

    # ------------------------------------------------------------------ #
    def find_entry(self, ctx: OpContext, op: str, args) -> int:
        return self.s2

    def traverse(self, ctx: OpContext, entry: int, op: str, args) -> TraverseResult:
        k = args[0]
        ggp = entry          # great-grandparent (for ensureReachable)
        gp = entry           # grandparent
        p = entry            # parent
        node = entry
        # descend to a leaf; route only by immutable keys (Property 4(3))
        while not ctx.read(node + LEAF, immutable=True):
            ggp, gp, p = gp, p, node
            w = ctx.read(node + CW)
            left, right, _mark = unpack_cw(w)
            node = left if k < ctx.read(node + KEY, immutable=True) else right
        return TraverseResult(nodes=[gp, p, node], parents=[ggp],
                              info=None)

    def ensure_reachable_addrs(self, tr: TraverseResult) -> List[int]:
        return [p + CW for p in tr.parents]

    def read_field_addrs(self, tr: TraverseResult) -> List[int]:
        return [n + CW for n in tr.nodes]

    # ------------------------------------------------------------------ #
    def _resolve(self, ctx: OpContext, addr: int) -> int:
        """Follow survivor chains through marked internal nodes."""
        hops = 0
        while True:
            if ctx.read(addr + LEAF, immutable=True):
                return addr
            w = ctx.read(addr + CW)
            left, right, mark = unpack_cw(w)
            if mark == MARK_NONE:
                return addr
            addr = right if mark == MARK_LEFT else left
            hops += 1
            assert hops < 10_000, "marked chain runaway"

    def _trim(self, ctx: OpContext, parent: int, child: int) -> None:
        """Physically disconnect a marked ``child`` from an unmarked
        ``parent`` (the unique Property 5(2) instruction) — the helping
        step that replaces Ellen's descriptor-based helping and guarantees
        progress when a marked node's physical deletion was interrupted."""
        w = ctx.read(parent + CW)
        l, r, m = unpack_cw(w)
        if m != MARK_NONE or (l != child and r != child):
            return
        surv = self._resolve(ctx, child)
        nw = pack_cw(surv, r) if l == child else pack_cw(l, surv)
        ctx.cas(parent + CW, w, nw)

    def critical(self, ctx: OpContext, tr: TraverseResult, op: str, args):
        gp, p, leaf = tr.nodes
        ggp = tr.parents[0]
        k = args[0]
        if op == "find":
            found = ctx.read(leaf + KEY, immutable=True) == k
            return False, found
        if op == "insert":
            return self._insert_critical(ctx, ggp, gp, p, leaf, args)
        if op == "delete":
            return self._delete_critical(ctx, ggp, gp, p, leaf, args)
        raise ValueError(op)

    def _insert_critical(self, ctx, ggp, gp, p, leaf, args):
        k, v = args
        leaf_key = ctx.read(leaf + KEY, immutable=True)
        if leaf_key == k:
            return False, False  # already present
        pw = ctx.read(p + CW)
        pl, pr, pmark = unpack_cw(pw)
        if pmark != MARK_NONE:
            self._trim(ctx, gp, p)   # help finish the pending delete
            return True, False
        if pl != leaf and pr != leaf:
            return True, False       # leaf displaced: retry
        # build replacement subtree: internal node with the two leaves
        new_leaf = ctx.alloc(self.NODE_WORDS)
        ctx.write_local(new_leaf + KEY, k)
        ctx.write_local(new_leaf + VAL, v)
        ctx.write_local(new_leaf + LEAF, 1)
        internal = ctx.alloc(self.NODE_WORDS)
        ctx.write_local(internal + KEY, max(k, leaf_key))
        ctx.write_local(internal + LEAF, 0)
        if k < leaf_key:
            ctx.write_local(internal + CW, pack_cw(new_leaf, leaf))
        else:
            ctx.write_local(internal + CW, pack_cw(leaf, new_leaf))
        new_pw = pack_cw(internal, pr) if pl == leaf else pack_cw(pl, internal)
        ok = ctx.cas(p + CW, pw, new_pw)
        return (False, True) if ok else (True, False)

    def _delete_critical(self, ctx, ggp, gp, p, leaf, args):
        k = args[0]
        if ctx.read(leaf + KEY, immutable=True) != k:
            return False, False  # no such key
        if k in (KEY_MIN, KEY_MAX, KEY_MAX2):
            return False, False  # sentinels are not deletable
        pw = ctx.read(p + CW)
        pl, pr, pmark = unpack_cw(pw)
        if pmark != MARK_NONE:
            self._trim(ctx, gp, p)
            return True, False
        if pl != leaf and pr != leaf:
            return True, False
        gw = ctx.read(gp + CW)
        gl, gr, gmark = unpack_cw(gw)
        if gmark != MARK_NONE:
            self._trim(ctx, ggp, gp)  # help finish the pending delete above
            return True, False
        if gl != p and gr != p:
            return True, False
        # logical delete: mark the parent (single CAS, atomically immutable)
        mark = MARK_LEFT if pl == leaf else MARK_RIGHT
        if not ctx.cas(p + CW, pw, pack_cw(pl, pr, mark)):
            return True, False
        # physical delete: the unique disconnection at the grandparent
        survivor = self._resolve(ctx, p)
        new_gw = pack_cw(survivor, gr) if gl == p else pack_cw(gl, survivor)
        ctx.cas(gp + CW, gw, new_gw)  # failure is fine: someone else trims
        return False, True

    # ------------------------------------------------------------------ #
    # Supplement 1 / recovery                                             #
    # ------------------------------------------------------------------ #
    def disconnect(self) -> None:
        mem = self.mem
        changed = True
        while changed:
            changed = False
            stack = [self.s2]
            while stack:
                node = stack.pop()
                if int(mem.volatile[node + LEAF]):
                    continue
                w = int(mem.volatile[node + CW])
                left, right, mark = unpack_cw(w)
                if mark != MARK_NONE:
                    continue  # will be trimmed via its parent
                new_l = self._resolve_raw(left)
                new_r = self._resolve_raw(right)
                if (new_l, new_r) != (left, right):
                    mem.cas(node + CW, w, pack_cw(new_l, new_r))
                    mem.flush(node + CW)
                    changed = True
                stack.extend([new_l, new_r])
        mem.fence()

    def _resolve_raw(self, addr: int) -> int:
        mem = self.mem
        while True:
            if int(mem.volatile[addr + LEAF]):
                return addr
            l, r, mark = unpack_cw(int(mem.volatile[addr + CW]))
            if mark == MARK_NONE:
                return addr
            addr = r if mark == MARK_LEFT else l

    # ------------------------------------------------------------------ #
    def _walk(self, image: np.ndarray) -> dict:
        out = {}
        stack = [self.s2]
        seen = set()
        while stack:
            node = stack.pop()
            if node in seen:
                raise AssertionError("cycle in BST")
            seen.add(node)
            if int(image[node + LEAF]):
                k = int(image[node + KEY])
                if k not in (KEY_MIN, KEY_MAX, KEY_MAX2):
                    out[k] = int(image[node + VAL])
                continue
            left, right, mark = unpack_cw(int(image[node + CW]))
            if mark == MARK_LEFT:       # left child logically deleted
                stack.append(right)
            elif mark == MARK_RIGHT:
                stack.append(left)
            else:
                stack.extend([left, right])
        return out

    def contents(self) -> dict:
        return self._walk(self.mem.volatile)

    def persistent_contents(self) -> dict:
        return self._walk(self.mem.persistent)

    def check_integrity(self, *, require_unmarked: bool = False) -> None:
        image = self.mem.volatile

        def rec(node, lo, hi, depth):
            assert depth < 10_000, "BST depth runaway"
            k = int(image[node + KEY])
            if int(image[node + LEAF]):
                assert lo <= k <= hi, "leaf key out of range"
                return
            left, right, mark = unpack_cw(int(image[node + CW]))
            if require_unmarked:
                assert mark == MARK_NONE, "marked node survived recovery"
            # search-tree invariant on live edges: left keys < k ≤ right keys
            if mark != MARK_LEFT:    # left edge live
                rec(left, lo, k - 1, depth + 1)
            if mark != MARK_RIGHT:   # right edge live
                rec(right, k, hi, depth + 1)

        rec(self.s2, KEY_MIN, KEY_MAX2, 0)
