"""Controlled-interleaving scheduler for concurrency + crash testing.
(the port's own copy of ``repro.core.scheduler``)

The paper's correctness claim (Theorem 4.2: every NVTraverse data structure
is durably linearizable) quantifies over all interleavings, all crash points
and all implicit-eviction choices.  This module provides the adversary:

  * each operation runs in its own (real) thread, but every shared-memory
    instruction gates on the scheduler, which grants exactly one instruction
    at a time — interleavings are deterministic given a seed;
  * a crash can be injected at any global instruction boundary; in-flight
    operations become *pending* (no response), the volatile view is lost,
    and a chosen subset of unpersisted lines is evicted to NVRAM
    (:meth:`PMem.crash`);
  * the full invoke/respond history is recorded in real-time order for the
    linearizability checker.

This is test infrastructure (the paper's "threads"), not the data path; the
port's batched engines are exercised separately.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from .instr import CrashInterrupt
from .policies import Policy
from .traversal import TraversalDS, run_operation


@dataclasses.dataclass
class OpRecord:
    opid: int
    op: str
    args: tuple
    invoke_step: Optional[int] = None    # global step of first instruction
    respond_step: Optional[int] = None   # global step of completion
    result: Any = None

    @property
    def completed(self) -> bool:
        return self.respond_step is not None

    @property
    def invoked(self) -> bool:
        return self.invoke_step is not None


class _OpThread:
    def __init__(self, ds: TraversalDS, policy: Policy, rec: OpRecord):
        self.rec = rec
        self._go = threading.Event()
        self._ready = threading.Event()
        self._crash = False
        self.alive = True
        self.error: Optional[BaseException] = None

        def hook(kind: str) -> None:
            self._ready.set()
            self._go.wait()
            self._go.clear()
            if self._crash:
                raise CrashInterrupt()

        def body() -> None:
            try:
                self.rec.result = run_operation(
                    ds, policy, rec.op, rec.args,
                    step_hook=hook, opid=rec.opid, max_restarts=10_000)
            except CrashInterrupt:
                pass
            except BaseException as e:  # surfaced by the scheduler
                self.error = e
            finally:
                self.alive = False
                self._ready.set()

        self.thread = threading.Thread(target=body, daemon=True)

    def start(self) -> None:
        self.thread.start()
        self._ready.wait()   # reaches first instruction boundary (or ends)
        self._ready.clear()

    def step(self) -> None:
        """Grant exactly one instruction; returns when the thread reaches
        the next boundary or terminates."""
        self._go.set()
        self._ready.wait()
        self._ready.clear()

    def kill(self) -> None:
        self._crash = True
        if self.alive:
            self._go.set()
            self.thread.join(timeout=10)


class Interleaver:
    """Runs a batch of operations under a seeded random interleaving."""

    def __init__(self, ds: TraversalDS, policy: Policy,
                 ops: Sequence[tuple], *, seed: int = 0):
        self.ds = ds
        self.policy = policy
        self.records = [OpRecord(i, op, tuple(args))
                        for i, (op, args) in enumerate(ops)]
        self._rng = np.random.default_rng(seed)
        self.global_step = 0
        self.crashed = False

    def run(self, *, crash_at: Optional[int] = None,
            evict: Any = "random", p_evict: float = 0.5,
            max_steps: int = 2_000_000) -> List[OpRecord]:
        threads = [_OpThread(self.ds, self.policy, r) for r in self.records]
        for t in threads:
            t.start()
        live = [t for t in threads if t.alive]
        try:
            while live and self.global_step < max_steps:
                if crash_at is not None and self.global_step >= crash_at:
                    self._crash(threads, evict, p_evict)
                    return self.records
                t = live[self._rng.integers(len(live))]
                if t.rec.invoke_step is None:
                    t.rec.invoke_step = self.global_step
                t.step()
                self.global_step += 1
                if not t.alive:
                    if t.error is not None:
                        raise t.error
                    t.rec.respond_step = self.global_step
                    live.remove(t)
            if live:
                raise RuntimeError("interleaver exceeded max_steps")
            return self.records
        finally:
            for t in threads:
                t.kill()

    def _crash(self, threads, evict, p_evict) -> None:
        for t in threads:
            t.kill()
        self.ds.mem.crash(evict=evict, p_evict=p_evict)
        self.crashed = True
