"""Instruction layer: per-operation execution context over :class:`PMem`.
(the port's own copy of ``repro.core.instr``)

Every traversal data structure in this package accesses shared memory only
through an :class:`OpContext` — the enforcement point for

  * the three-phase operation layout of Algorithm 1 (findEntry → traverse →
    critical), tracked as ``ctx.phase``;
  * Property 4(1): *the traverse method does not modify shared memory* —
    writes/CAS during the traverse phase raise;
  * policy hooks (:mod:`repro_torch.core.policies`) that inject flush/fence
    instructions per the NVTraverse Protocols 1–2 or per the Izraelevitz
    baseline transformation;
  * the interleaving scheduler: ``step_hook`` is invoked before every shared
    instruction, letting the linearizability harness preempt the operation
    or inject a crash at any instruction boundary.

Pointer/mark packing (Harris-style): a pointer word is ``(addr << 1) | mark``
with ``addr == 0`` reserved as null, so a marked pointer differs from its
unmarked form only in bit 0 — "we consider a 'marking' of a node to be a
non-pointer value modification, even though some algorithms place the mark
physically on the pointer field" (§3.1).
"""
from __future__ import annotations

import enum
from typing import Callable, Optional

from .pmem import PMem

NULLPTR = 0  # packed null (address 0 is reserved, never allocated)


def pack(addr: int, mark: int = 0) -> int:
    return (addr << 1) | mark


def unpack(word: int) -> tuple[int, int]:
    return word >> 1, word & 1


def is_marked(word: int) -> bool:
    return bool(word & 1)


def with_mark(word: int) -> int:
    return word | 1


class Phase(enum.Enum):
    ENTRY = "entry"
    TRAVERSE = "traverse"
    CRITICAL = "critical"


class CrashInterrupt(Exception):
    """Raised inside an operation thread when the scheduler injects a crash."""


class TraversalWriteError(RuntimeError):
    """Property 4(1) violation: traverse attempted to modify shared memory."""


class OpContext:
    def __init__(self, mem: PMem, policy, *,
                 step_hook: Optional[Callable[[str], None]] = None,
                 opid: int = 0):
        self.mem = mem
        self.policy = policy
        self.step_hook = step_hook or (lambda kind: None)
        self.opid = opid
        self.phase = Phase.ENTRY

    # -- phase management (driven by traversal.run_operation) ----------- #
    def enter(self, phase: Phase) -> None:
        self.phase = phase

    @property
    def in_traverse(self) -> bool:
        return self.phase is Phase.TRAVERSE

    # -- shared instructions -------------------------------------------- #
    def read(self, addr: int, *, immutable: bool = False) -> int:
        self.step_hook("read")
        val = self.mem.read(addr)
        self.policy.after_read(self, addr, immutable=immutable)
        return val

    def write(self, addr: int, value: int) -> None:
        if self.in_traverse:
            raise TraversalWriteError("write during traverse phase")
        self.step_hook("write")
        self.policy.before_mod(self, addr)
        self.mem.write(addr, value)
        self.policy.after_mod(self, addr)

    def cas(self, addr: int, expected: int, new: int) -> bool:
        if self.in_traverse:
            raise TraversalWriteError("CAS during traverse phase")
        self.step_hook("cas")
        self.policy.before_mod(self, addr)
        ok = self.mem.cas(addr, expected, new)
        self.policy.after_mod(self, addr)
        return ok

    # -- node initialization (pre-publication, process-local) ----------- #
    def write_local(self, addr: int, value: int) -> None:
        """Initializing write to a not-yet-published node.

        Protocol 2 note: "when initializing a node, a process executes
        flushes after initializing each field, but only needs to fence once
        before atomically inserting the new node".
        """
        self.step_hook("write_local")
        self.mem.write(addr, value)
        self.policy.after_local_write(self, addr)

    def alloc(self, n_words: int) -> int:
        return self.mem.alloc(n_words)

    # -- raw persistence instructions (issued by policies) --------------- #
    def flush(self, addr: int) -> None:
        self.step_hook("flush")
        self.mem.flush(addr, in_traverse=self.in_traverse)

    def fence(self) -> None:
        self.step_hook("fence")
        self.mem.fence(in_traverse=self.in_traverse)

    # -- return boundary -------------------------------------------------#
    def before_return(self) -> None:
        self.policy.before_return(self)
