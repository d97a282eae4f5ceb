"""Flush/fence injection policies.
(the port's own copy of ``repro.core.policies``)

Three policies implement the three systems compared in the paper:

  * :class:`VolatilePolicy` — the original, non-durable lock-free algorithm
    (no flushes, no fences).  The upper bound on throughput.
  * :class:`IzraelevitzPolicy` — the general transformation of Izraelevitz
    et al. [26]: a flush + fence accompanies *every* shared-memory access
    ("add a flush and a fence instruction between every two synchronized
    instructions").  Provably correct, prohibitively expensive: O(path)
    fences per operation.
  * :class:`NVTraversePolicy` — the paper's contribution, Protocols 1 and 2:
      - nothing is persisted during findEntry/traverse (the journey);
      - between traverse and critical, ``pre_critical`` runs
        ``ensureReachable`` (flush the parent pointer that links the
        traversal's topmost returned node into the structure — Lemma 4.1)
        and ``makePersistent`` (flush every field the traversal read in the
        returned nodes), then ONE fence;
      - during critical: flush after every shared read (immutable fields
        exempt), flush after every write/CAS, fence before every write/CAS,
        fence before every return.

The policy objects are stateless; all accounting lives in the PMem counters,
so a policy can be swapped per-run to produce the paper's comparison curves.
"""
from __future__ import annotations

from .instr import OpContext, Phase


class Policy:
    name = "abstract"

    # -- Protocol 2 hooks ------------------------------------------------ #
    def after_read(self, ctx: OpContext, addr: int, *, immutable: bool) -> None:
        pass

    def before_mod(self, ctx: OpContext, addr: int) -> None:
        pass

    def after_mod(self, ctx: OpContext, addr: int) -> None:
        pass

    def after_local_write(self, ctx: OpContext, addr: int) -> None:
        pass

    def before_return(self, ctx: OpContext) -> None:
        pass

    # -- Protocol 1 hook (between traverse and critical) ------------------ #
    def pre_critical(self, ctx: OpContext, parent_addrs, node_field_addrs) -> None:
        """``parent_addrs``: address(es) ensureReachable must flush (the
        pointer location linking the topmost returned node — either the
        recorded original-parent location or, under the Lemma 4.1
        optimization, the current parent's pointer field returned by the
        traversal).  ``node_field_addrs``: every field the traversal read in
        the returned nodes, for makePersistent."""
        pass


class VolatilePolicy(Policy):
    name = "volatile"


class IzraelevitzPolicy(Policy):
    """Flush+fence around every shared access (incl. traversal reads)."""

    name = "izraelevitz"

    def after_read(self, ctx, addr, *, immutable):
        ctx.flush(addr)
        ctx.fence()

    def after_mod(self, ctx, addr):
        ctx.flush(addr)
        ctx.fence()

    def after_local_write(self, ctx, addr):
        ctx.flush(addr)
        ctx.fence()

    def before_return(self, ctx):
        ctx.fence()


class NVTraversePolicy(Policy):
    name = "nvtraverse"

    # During traverse, ctx.phase is TRAVERSE and the structure only issues
    # reads; after_read below is a no-op in that phase (the journey is free).

    def after_read(self, ctx, addr, *, immutable):
        if ctx.phase is Phase.CRITICAL and not immutable:
            ctx.flush(addr)

    def before_mod(self, ctx, addr):
        if ctx.phase is Phase.CRITICAL:
            ctx.fence()

    def after_mod(self, ctx, addr):
        if ctx.phase is Phase.CRITICAL:
            ctx.flush(addr)

    def after_local_write(self, ctx, addr):
        # flush each initialized field; the single fence happens via
        # before_mod of the publishing CAS.
        ctx.flush(addr)

    def before_return(self, ctx):
        ctx.fence()

    def pre_critical(self, ctx, parent_addrs, node_field_addrs):
        # ensureReachable: persist the link that makes the subtree reachable.
        for a in parent_addrs:
            ctx.flush(a)
        # makePersistent: persist every field the traversal read in the
        # returned nodes ...
        for a in node_field_addrs:
            ctx.flush(a)
        # ... and a single fence covering all of the above (§4.1).
        ctx.fence()


POLICIES = {p.name: p for p in (VolatilePolicy(), IzraelevitzPolicy(),
                                NVTraversePolicy())}


def get_policy(name: str) -> Policy:
    return POLICIES[name]
