"""Lock-free FIFO queue in traversal form (Michael & Scott [35] lineage).
(the port's own copy of ``repro.core.queue``)

The paper (§3, Property 2) lists queues among traversal data structures:
the core tree is the chain from the head sentinel; the *tail pointer* is an
auxiliary entry point (volatile, reconstructed after a crash), used only by
``findEntry`` as a shortcut.  This is also the structure against which the
paper situates the only previously *proven* durable algorithm, the
DurableQueue of Friedman et al. [21].

  * enqueue: findEntry returns the volatile tail hint; traverse walks to
    the last node (stopping condition: next == NULL — a mutable field, as
    Property 4(2) allows); critical CASes last.next from NULL to the new
    node.  The queue demonstrates the **Supplement 2** variant: each node
    records its original parent (the pointer that linked it in), and
    ensureReachable flushes the location stored there.
  * dequeue: findEntry returns head; traverse reads the first node;
    critical *marks* it (logical dequeue, Definition 1) and then swings
    head.next (the unique disconnection, Property 5(2)).

Node layout: ``[value, next, orig_parent, _pad]``.
"""
from __future__ import annotations

from typing import List

from .instr import NULLPTR, OpContext, is_marked, pack, unpack, with_mark
from .pmem import PMem
from .traversal import TraversalDS, TraverseResult

VAL, NXT, OPAR = 0, 1, 2


class MSQueue(TraversalDS):
    NODE_WORDS = 4

    def __init__(self, mem: PMem):
        super().__init__(mem)
        self.head = mem.alloc(self.NODE_WORDS)
        mem.write(self.head + NXT, NULLPTR)
        mem.persist_all()
        self.tail_hint = self.head      # volatile auxiliary entry point

    # ------------------------------------------------------------------ #
    def find_entry(self, ctx: OpContext, op: str, args) -> int:
        if op == "enqueue":
            return self.tail_hint       # may be stale; traverse walks on
        return self.head

    def traverse(self, ctx: OpContext, entry: int, op: str, args) -> TraverseResult:
        if op == "enqueue":
            curr = entry
            w = ctx.read(curr + NXT)
            while True:
                nxt, _ = unpack(w)
                if nxt == NULLPTR:
                    break
                curr = nxt
                w = ctx.read(curr + NXT)
            return TraverseResult(nodes=[curr], info=w)
        # dequeue / peek: head and its first successor
        hw = ctx.read(self.head + NXT)
        first, _ = unpack(hw)
        nodes = [self.head] if first == NULLPTR else [self.head, first]
        return TraverseResult(nodes=nodes, info=hw)

    def ensure_reachable_addrs(self, tr: TraverseResult) -> List[int]:
        first = tr.nodes[0]
        if first == self.head:
            return []                   # the root sentinel is always durable
        # Supplement 2: flush the location recorded in the original-parent
        # field (populated before the node was published).
        return [int(self.mem.volatile[first + OPAR])]

    def read_field_addrs(self, tr: TraverseResult) -> List[int]:
        return [n + NXT for n in tr.nodes]

    # ------------------------------------------------------------------ #
    def critical(self, ctx: OpContext, tr: TraverseResult, op: str, args):
        if op == "enqueue":
            last = tr.nodes[0]
            last_w = ctx.read(last + NXT)
            if unpack(last_w)[0] != NULLPTR or is_marked(last_w):
                return True, None       # tail moved (or node dequeued): retry
            new = ctx.alloc(self.NODE_WORDS)
            ctx.write_local(new + VAL, args[0])
            ctx.write_local(new + NXT, NULLPTR)
            ctx.write_local(new + OPAR, last + NXT)
            ok = ctx.cas(last + NXT, last_w, pack(new, 0))
            if ok:
                self.tail_hint = new    # volatile hint update
                return False, True
            return True, None
        if op == "dequeue":
            if len(tr.nodes) == 1:
                return False, None      # empty queue
            head, first = tr.nodes
            val = ctx.read(first + VAL, immutable=True)
            fw = ctx.read(first + NXT)
            if is_marked(fw):
                # help finish the pending dequeue, then retry
                hw = ctx.read(head + NXT)
                if unpack(hw)[0] == first:
                    ctx.cas(head + NXT, hw, pack(unpack(fw)[0], 0))
                return True, None
            if not ctx.cas(first + NXT, fw, with_mark(fw)):
                return True, None       # lost the race: retry
            # unique disconnection: swing head.next past the marked node
            ctx.cas(head + NXT, pack(first, 0), pack(unpack(fw)[0], 0))
            if self.tail_hint == first:
                self.tail_hint = self.head
            return False, val
        raise ValueError(op)

    # ------------------------------------------------------------------ #
    def disconnect(self) -> None:
        mem = self.mem
        while True:
            hw = int(mem.volatile[self.head + NXT])
            first, _ = unpack(hw)
            if first == NULLPTR:
                break
            fw = int(mem.volatile[first + NXT])
            if not is_marked(fw):
                break
            mem.cas(self.head + NXT, hw, pack(unpack(fw)[0], 0))
            mem.flush(self.head + NXT)
        mem.fence()
        # rebuild the volatile tail hint (auxiliary reconstruction)
        curr = self.head
        while True:
            nxt, _ = unpack(int(mem.volatile[curr + NXT]))
            if nxt == NULLPTR:
                break
            curr = nxt
        self.tail_hint = curr

    # ------------------------------------------------------------------ #
    def _walk(self, image) -> list:
        out = []
        curr, _ = unpack(int(image[self.head + NXT]))
        hops = 0
        while curr != NULLPTR:
            w = int(image[curr + NXT])
            if not is_marked(w):
                out.append(int(image[curr + VAL]))
            curr, _ = unpack(w)
            hops += 1
            assert hops < self.mem.capacity, "runaway queue walk"
        return out

    def contents(self) -> list:
        return self._walk(self.mem.volatile)

    def persistent_contents(self) -> list:
        return self._walk(self.mem.persistent)

    def check_integrity(self, *, require_unmarked: bool = False) -> None:
        image = self.mem.volatile
        curr, _ = unpack(int(image[self.head + NXT]))
        seen = set()
        marked_allowed = True           # only a prefix may be marked
        while curr != NULLPTR:
            assert curr not in seen, "cycle in queue"
            seen.add(curr)
            w = int(image[curr + NXT])
            if is_marked(w):
                assert marked_allowed, "marked node after live node"
                if require_unmarked:
                    raise AssertionError("marked node survived recovery")
            else:
                marked_allowed = False
            curr, _ = unpack(w)
