"""Harris's lock-free linked list in traversal form (paper §2.1, §4.4).
(the port's own copy of ``repro.core.harris_list``)

Node layout (one cache line): ``[key, value, next, orig_parent]``
  * ``key``   — immutable (never flushed on read, §4.2);
  * ``value`` — payload word;
  * ``next``  — packed ``(succ_addr << 1) | mark``; a set mark bit means the
    node is *logically deleted* and immutable (Definition 1);
  * ``orig_parent`` — Supplement 2 field: the address of the pointer that
    linked this node into the structure (populated *before* publication).
    Only consulted when ``use_orig_parent=True``; by default the list uses
    the Lemma 4.1 optimization (the traversal returns the current parent of
    the first returned node, and ensureReachable flushes that parent's
    ``next`` field).

The three methods follow the paper's pseudocode:
  * findEntry returns the head sentinel (Algorithm 3 line 9);
  * traverse is Algorithm 4 lines 8–36: returns ``[left, marked…, right]``
    plus ``leftParent`` for the ensureReachable optimization;
  * critical is Algorithm 3 (insert/delete) and Algorithm 4 (find), with
    ``deleteMarkedNodes`` trimming the marked interior nodes first.

Note: the paper's Algorithm 4 line 41 returns ``false`` when
``nodes.size()==2``; taken literally that retries forever when there is
nothing to trim.  We implement the evident intent: nothing to trim ⇒
proceed (return true).
"""
from __future__ import annotations

from typing import List

import numpy as np

from .instr import NULLPTR, OpContext, is_marked, pack, unpack, with_mark
from .pmem import PMem
from .traversal import TraversalDS, TraverseResult

# field offsets
KEY, VAL, NXT, OPAR = 0, 1, 2, 3

KEY_MIN = np.iinfo(np.int64).min + 1   # head sentinel key (-inf)
KEY_MAX = np.iinfo(np.int64).max       # tail sentinel key (+inf)


class HarrisList(TraversalDS):
    NODE_WORDS = 4

    def __init__(self, mem: PMem, *, base: int | None = None,
                 use_orig_parent: bool = False):
        super().__init__(mem)
        self.use_orig_parent = use_orig_parent
        if base is not None:
            mem.init_alloc(max(base, mem.line_words))  # address 0 reserved
        # sentinels (persisted immediately — structure creation is durable)
        self.tail = mem.alloc(self.NODE_WORDS)
        self.head = mem.alloc(self.NODE_WORDS)
        mem.write(self.tail + KEY, KEY_MAX)
        mem.write(self.tail + NXT, NULLPTR)
        mem.write(self.head + KEY, KEY_MIN)
        mem.write(self.head + NXT, pack(self.tail, 0))
        mem.persist_all()

    # ------------------------------------------------------------------ #
    # the three methods                                                   #
    # ------------------------------------------------------------------ #
    def find_entry(self, ctx: OpContext, op: str, args) -> int:
        return self.head  # the root is the only entry point

    def traverse(self, ctx: OpContext, entry: int, op: str, args) -> TraverseResult:
        k = args[0]
        head = self._segment_head(entry)
        while True:
            nodes: List[int] = []
            left_found = False
            left_parent = entry
            pred = entry
            curr = entry
            succ_w = ctx.read(curr + NXT)
            # walk while current node is marked or its key < k
            while is_marked(succ_w) or ctx.read(curr + KEY, immutable=True) < k:
                if not is_marked(succ_w):
                    nodes.clear()
                    left_found = True
                    left_parent = pred
                    nodes.append(curr)          # candidate left node
                else:
                    nodes.append(curr)          # marked interior node
                pred = curr
                curr, _ = unpack(succ_w)
                if curr == NULLPTR:
                    break
                succ_w = ctx.read(curr + NXT)
            right = curr
            nodes.append(right)
            # entry node itself was (or became) marked and no unmarked left
            # was seen — can happen when the entry point is an auxiliary
            # shortcut (skiplist tower / stale hint); fall back to the
            # segment head, which is a sentinel and never marked.
            if not left_found:
                entry = head
                continue
            # restart if right got marked under us (Algorithm 4 line 31)
            if right != NULLPTR and is_marked(ctx.read(right + NXT)):
                continue
            return TraverseResult(nodes=nodes, parents=[left_parent])

    def _segment_head(self, entry: int) -> int:
        """Sentinel head of the core-tree segment containing ``entry``
        (overridden by the hash table, which has one head per bucket)."""
        return self.head

    # -- Protocol 1 addresses -------------------------------------------- #
    def ensure_reachable_addrs(self, tr: TraverseResult) -> List[int]:
        first = tr.nodes[0]
        if self.use_orig_parent:
            # Supplement 2: the field stores the location of the pointer
            # that linked `first` in; flush that location.
            return [int(self.mem.volatile[first + OPAR])]
        # Lemma 4.1 optimization: flush the current parent's next field.
        return [p + NXT for p in tr.parents]

    def read_field_addrs(self, tr: TraverseResult) -> List[int]:
        # traverse read key+next of each returned node; nodes are
        # line-aligned so one flush per node covers both fields.
        return [n + NXT for n in tr.nodes]

    # ------------------------------------------------------------------ #
    # critical methods                                                    #
    # ------------------------------------------------------------------ #
    def _delete_marked_nodes(self, ctx: OpContext, tr: TraverseResult) -> bool:
        """Algorithm 4 lines 40–57: trim marked nodes between left and right."""
        nodes = tr.nodes
        if len(nodes) == 2 or len(nodes) == 1:
            return True  # nothing to trim (see module docstring re paper typo)
        left, right = nodes[0], nodes[-1]
        expected = pack(nodes[1], 0)
        ok = ctx.cas(left + NXT, expected, pack(right, 0))
        if ok:
            if right != NULLPTR and is_marked(ctx.read(right + NXT)):
                return False  # right got marked; retraverse
            return True
        return False

    def critical(self, ctx: OpContext, tr: TraverseResult, op: str, args):
        if op == "find":
            right = tr.nodes[-1]
            found = (right != NULLPTR
                     and ctx.read(right + KEY, immutable=True) == args[0])
            return False, found
        if op == "insert":
            return self._insert_critical(ctx, tr, args)
        if op == "delete":
            return self._delete_critical(ctx, tr, args)
        raise ValueError(op)

    def _insert_critical(self, ctx: OpContext, tr: TraverseResult, args):
        k, v = args
        if not self._delete_marked_nodes(ctx, tr):
            return True, False  # retry
        left, right = tr.nodes[0], tr.nodes[-1]
        if right != NULLPTR and ctx.read(right + KEY, immutable=True) == k:
            return False, False  # key already present
        new = ctx.alloc(self.NODE_WORDS)
        ctx.write_local(new + KEY, k)
        ctx.write_local(new + VAL, v)
        ctx.write_local(new + NXT, pack(right, 0))
        ctx.write_local(new + OPAR, left + NXT)  # Supplement 2
        ok = ctx.cas(left + NXT, pack(right, 0), pack(new, 0))
        if ok:
            return False, True
        return True, False  # retry

    def _delete_critical(self, ctx: OpContext, tr: TraverseResult, args):
        k = args[0]
        if not self._delete_marked_nodes(ctx, tr):
            return True, False
        left, right = tr.nodes[0], tr.nodes[-1]
        if right == NULLPTR or ctx.read(right + KEY, immutable=True) != k:
            return False, False  # no such key
        rnext_w = ctx.read(right + NXT)
        if not is_marked(rnext_w):
            ok = ctx.cas(right + NXT, rnext_w, with_mark(rnext_w))  # logical
            if ok:
                # physical delete; failure is fine (another op will trim)
                ctx.cas(left + NXT, pack(right, 0), rnext_w)
                return False, True
        return True, False  # retry

    # ------------------------------------------------------------------ #
    # Supplement 1: disconnect(root) — also THE recovery procedure (§4)   #
    # ------------------------------------------------------------------ #
    def disconnect(self) -> None:
        """Trim every marked node; persist the repaired pointers.

        Runs quiescently (post-crash recovery) directly against memory;
        each disconnection is the unique CAS of Property 5(2), and the
        repaired locations are flushed + fenced so the recovered state is
        itself durable.
        """
        mem = self.mem
        pred = self.head
        while True:
            pred_w = int(mem.volatile[pred + NXT])
            curr, _ = unpack(pred_w)
            if curr == NULLPTR:
                break
            # find maximal run of marked nodes starting at curr
            run_end = curr
            run_end_w = int(mem.volatile[run_end + NXT])
            trimmed = False
            while is_marked(run_end_w):
                trimmed = True
                run_end, _ = unpack(run_end_w)
                if run_end == NULLPTR:
                    break
                run_end_w = int(mem.volatile[run_end + NXT])
            if trimmed:
                mem.cas(pred + NXT, pred_w, pack(run_end, 0))
                mem.flush(pred + NXT)
                if run_end == NULLPTR:
                    break
                continue  # re-examine pred with its new successor
            pred = curr
        mem.fence()

    # ------------------------------------------------------------------ #
    # verification                                                        #
    # ------------------------------------------------------------------ #
    def _walk(self, image: np.ndarray) -> dict:
        out = {}
        seen = set()
        curr, _ = unpack(int(image[self.head + NXT]))
        while curr != NULLPTR and curr != self.tail:
            if curr in seen:
                raise AssertionError("cycle in list")
            seen.add(curr)
            w = int(image[curr + NXT])
            if not is_marked(w):
                out[int(image[curr + KEY])] = int(image[curr + VAL])
            curr, _ = unpack(w)
        return out

    def contents(self) -> dict:
        return self._walk(self.mem.volatile)

    def sorted_snapshot(self) -> List[tuple]:
        """One bottom-level walk returning ``[(key, addr), …]`` of every
        *unmarked* node in list (= key) order — the batch form of the
        traversal, exposed so callers that need every node (the skiplist
        index rebuild, the batch-parallel ordered engine's differential
        tests) pay one O(n) walk instead of one traversal per key."""
        image = self.mem.volatile
        out: List[tuple] = []
        seen = set()
        curr, _ = unpack(int(image[self.head + NXT]))
        while curr != NULLPTR and curr != self.tail:
            if curr in seen:
                raise AssertionError("cycle in list")
            seen.add(curr)
            w = int(image[curr + NXT])
            if not is_marked(w):
                out.append((int(image[curr + KEY]), curr))
            curr, _ = unpack(w)
        return out

    def persistent_contents(self) -> dict:
        return self._walk(self.mem.persistent)

    def check_integrity(self, *, require_unmarked: bool = False) -> None:
        image = self.mem.volatile
        curr, _ = unpack(int(image[self.head + NXT]))
        prev_key = KEY_MIN
        hops = 0
        while curr != NULLPTR and curr != self.tail:
            w = int(image[curr + NXT])
            k = int(image[curr + KEY])
            if not is_marked(w):
                assert k > prev_key, "keys not strictly sorted"
                prev_key = k
            elif require_unmarked:
                raise AssertionError("marked node survived recovery")
            curr, _ = unpack(w)
            hops += 1
            assert hops < self.mem.capacity, "runaway list walk"
