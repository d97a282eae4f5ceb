"""Lock-free Treiber stack in traversal form.
(the port's own copy of ``repro.core.stack``)

The paper (§3, Property 2) lists stacks among traversal data structures:
the core tree is the chain from a fixed head sentinel (top = head.next),
findEntry returns the head, the traversal reads the top node, and the
critical method pushes/pops at the destination with O(1) persistence.

  * push(v): new node (next = top, orig_parent = &head.next recorded
    pre-publication — Supplement 2), CAS head.next top→new;
  * pop(): *mark* the top (Definition 1, the linearization point), then
    the unique disconnection CAS swings head.next past it (Property 5).
    A push can land between mark and swing, burying the marked node
    mid-chain — later pops help-trim marked runs exactly like the list's
    deleteMarkedNodes, and recovery's disconnect() trims them all.

Node layout: ``[value, next, orig_parent, _pad]``.
"""
from __future__ import annotations

from typing import List

from .instr import NULLPTR, OpContext, is_marked, pack, unpack, with_mark
from .pmem import PMem
from .traversal import TraversalDS, TraverseResult

VAL, NXT, OPAR = 0, 1, 2


class TreiberStack(TraversalDS):
    NODE_WORDS = 4

    def __init__(self, mem: PMem):
        super().__init__(mem)
        self.head = mem.alloc(self.NODE_WORDS)
        mem.write(self.head + NXT, NULLPTR)
        mem.persist_all()

    # ------------------------------------------------------------------ #
    def find_entry(self, ctx: OpContext, op: str, args) -> int:
        return self.head

    def traverse(self, ctx: OpContext, entry: int, op: str, args) -> TraverseResult:
        hw = ctx.read(entry + NXT)
        top, _ = unpack(hw)
        nodes = [entry] if top == NULLPTR else [entry, top]
        return TraverseResult(nodes=nodes, info=hw)

    def ensure_reachable_addrs(self, tr: TraverseResult) -> List[int]:
        first = tr.nodes[0]
        if first == self.head:
            return []
        return [int(self.mem.volatile[first + OPAR])]

    def read_field_addrs(self, tr: TraverseResult) -> List[int]:
        return [n + NXT for n in tr.nodes]

    # ------------------------------------------------------------------ #
    def critical(self, ctx: OpContext, tr: TraverseResult, op: str, args):
        head = tr.nodes[0]
        top = tr.nodes[1] if len(tr.nodes) > 1 else NULLPTR
        if op == "push":
            hw = ctx.read(head + NXT)
            new = ctx.alloc(self.NODE_WORDS)
            ctx.write_local(new + VAL, args[0])
            ctx.write_local(new + NXT, hw)
            ctx.write_local(new + OPAR, head + NXT)   # Supplement 2
            ok = ctx.cas(head + NXT, hw, pack(new, 0))
            return (False, True) if ok else (True, None)
        if op == "pop":
            if top == NULLPTR:
                return False, None        # empty
            val = ctx.read(top + VAL, immutable=True)
            tw = ctx.read(top + NXT)
            if is_marked(tw):
                # help finish the pending pop, then retry
                hw = ctx.read(head + NXT)
                if unpack(hw)[0] == top:
                    ctx.cas(head + NXT, hw, pack(unpack(tw)[0], 0))
                return True, None
            if not ctx.cas(top + NXT, tw, with_mark(tw)):
                return True, None         # lost the race
            # the unique disconnection (may fail if a push landed; the
            # marked node is then trimmed by later helps / recovery)
            ctx.cas(head + NXT, pack(top, 0), pack(unpack(tw)[0], 0))
            return False, val
        raise ValueError(op)

    # ------------------------------------------------------------------ #
    def disconnect(self) -> None:
        """Trim every marked node in the chain (Supplement 1)."""
        mem = self.mem
        pred = self.head
        while True:
            pw = int(mem.volatile[pred + NXT])
            curr, _ = unpack(pw)
            if curr == NULLPTR:
                break
            run_end = curr
            rw = int(mem.volatile[run_end + NXT])
            trimmed = False
            while is_marked(rw):
                trimmed = True
                run_end, _ = unpack(rw)
                if run_end == NULLPTR:
                    break
                rw = int(mem.volatile[run_end + NXT])
            if trimmed:
                mem.cas(pred + NXT, pw, pack(run_end, 0))
                mem.flush(pred + NXT)
                if run_end == NULLPTR:
                    break
                continue
            pred = curr
        mem.fence()

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
            assert hops < self.mem.capacity, "runaway stack walk"
        return out                         # top first

    def contents(self) -> list:
        return self._walk(self.mem.volatile)

    def persistent_contents(self) -> list:
        return self._walk(self.mem.persistent)

    def check_integrity(self, *, require_unmarked: bool = False) -> None:
        image = self.mem.volatile
        curr, _ = unpack(int(image[self.head + NXT]))
        seen = set()
        while curr != NULLPTR:
            assert curr not in seen, "cycle in stack"
            seen.add(curr)
            w = int(image[curr + NXT])
            if require_unmarked and is_marked(w):
                raise AssertionError("marked node survived recovery")
            curr, _ = unpack(w)
