"""Algorithm 1 / Algorithm 2: the traversal-data-structure operation layout.
(the port's own copy of ``repro.core.traversal``)

A traversal data structure exposes exactly three shared-memory methods
(Property 3) which are always called in order:

    findEntry(root, input) -> entry
    traverse(entry, input) -> (parents, nodes)     # read-only, Property 4
    critical(nodes, input) -> (restart, value)     # disconnections per Prop 5

:' func:`run_operation` drives the retry loop.  Under the NVTraverse policy it
additionally runs Protocol 1 between traverse and critical (Algorithm 2):

    ensureReachable(nodes.first())   # flush the linking parent pointer
    makePersistent(nodes)            # flush all fields traverse read + fence

``traverse`` returns a :class:`TraverseResult`:

  * ``nodes``   — the suffix of the traversed path handed to critical
                  (e.g. Harris list: left, marked…, right);
  * ``parents`` — the extra node(s) returned for the Lemma 4.1
                  ensureReachable *optimization* (the current parent of the
                  first returned node), when the structure does not maintain
                  an original-parent field; structures that do maintain the
                  Supplement 2 field instead expose ``original_parent_addr``.

Subclasses enumerate, per returned node, the addresses of the fields the
traversal read (``read_field_addrs``) so makePersistent can flush exactly
those (§4.1 Protocol 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

from .instr import OpContext, Phase
from .pmem import PMem
from .policies import Policy


@dataclasses.dataclass
class TraverseResult:
    nodes: List[int]                      # node base addresses, top-most first
    parents: List[int] = dataclasses.field(default_factory=list)
    # structure-specific payload threaded to critical (e.g. packed words read)
    info: Any = None


class TraversalDS:
    """Base class — subclasses implement the three methods + supplements."""

    #: number of words per node (one line-aligned allocation unit)
    NODE_WORDS: int = 0

    def __init__(self, mem: PMem):
        self.mem = mem

    # -- the three methods (Property 3) ---------------------------------- #
    def find_entry(self, ctx: OpContext, op: str, args) -> int:
        raise NotImplementedError

    def traverse(self, ctx: OpContext, entry: int, op: str, args) -> TraverseResult:
        raise NotImplementedError

    def critical(self, ctx: OpContext, tr: TraverseResult, op: str, args):
        raise NotImplementedError

    # -- Protocol 1 support ------------------------------------------------#
    def ensure_reachable_addrs(self, tr: TraverseResult) -> List[int]:
        """Address(es) whose flush guarantees the topmost returned node is
        linked into the persistent structure (Lemma 4.1)."""
        raise NotImplementedError

    def read_field_addrs(self, tr: TraverseResult) -> List[int]:
        """Every field address the traversal read in the returned nodes."""
        raise NotImplementedError

    # -- Supplement 1: disconnect(root) ------------------------------------#
    def disconnect(self) -> None:
        """Trim all marked nodes (the entire recovery procedure, §4)."""
        raise NotImplementedError

    # -- verification helpers ----------------------------------------------#
    def contents(self) -> dict:
        """Abstract state read from the *volatile* view (spec oracle)."""
        raise NotImplementedError

    def persistent_contents(self) -> dict:
        """Abstract state as recovery would read it from NVRAM."""
        raise NotImplementedError

    def check_integrity(self) -> None:
        raise NotImplementedError


def run_operation(ds: TraversalDS, policy: Policy, op: str, args, *,
                  step_hook=None, opid: int = 0,
                  max_restarts: Optional[int] = None) -> Any:
    """Algorithm 2: the NVTraverse operation driver."""
    ctx = OpContext(ds.mem, policy, step_hook=step_hook, opid=opid)
    restarts = 0
    while True:
        ctx.enter(Phase.ENTRY)
        entry = ds.find_entry(ctx, op, args)
        ctx.enter(Phase.TRAVERSE)
        tr = ds.traverse(ctx, entry, op, args)
        # Protocol 1 (Algorithm 2 lines 5-6): ensureReachable + makePersistent
        # — runs between traverse and critical; its flushes belong to the
        # destination, not the journey, so leave the traverse phase first.
        ctx.enter(Phase.CRITICAL)
        policy.pre_critical(ctx, ds.ensure_reachable_addrs(tr),
                            ds.read_field_addrs(tr))
        restart, val = ds.critical(ctx, tr, op, args)
        if not restart:
            ctx.before_return()
            return val
        restarts += 1
        if max_restarts is not None and restarts > max_restarts:
            raise RuntimeError(f"operation {op}{args} exceeded "
                               f"{max_restarts} restarts")


def sequential_apply(ds: TraversalDS, policy: Policy,
                     ops: Sequence[tuple], **kw) -> list:
    """Run a sequence of (op, args) with no interleaving; returns results."""
    return [run_operation(ds, policy, op, args, **kw) for op, args in ops]
