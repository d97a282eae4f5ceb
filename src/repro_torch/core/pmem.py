"""Persistent-memory simulator — the substrate for the NVTraverse reproduction
(the port's own copy of ``repro.core.pmem``).

Models the paper's memory system (Section 2, "Persistent memory"):

  * two levels: a *volatile* view (cache) and a *persistent* image (NVRAM);
  * all reads/writes hit the volatile view;
  * a value reaches the persistent image either *explicitly* (flush of its
    cache line followed by a fence) or *implicitly* (background cache
    eviction, which may happen at any time and in any order);
  * a crash loses the volatile view: every modification that was *pending*
    (written but not persisted) at crash time MAY be lost — implicit eviction
    means any subset of pending lines may have made it to NVRAM.

The simulator is word-addressed with configurable cache-line grouping
(``line_words``); flushes and evictions act on whole lines, matching
``clwb``/eviction granularity on x86 and the paper's per-node flush counting
(a node allocated within one line costs one flush).

Adversary model for ``crash``: each line with pending words is independently
either evicted (its *current volatile* words reach NVRAM) or dropped.  This
covers the old-value/new-value outcomes relevant to CAS-based lock-free
structures, where each location is written at most once per modification.
(Intermediate-value outcomes from multiple unfenced writes to the *same word*
are not modeled; the traversal structures here never rely on that case —
node fields are written once before publication and pointers change by CAS.)

This module is deliberately a small, mutable, numpy-backed machine: it is the
*verification substrate* that the instruction interpreter, the interleaving
scheduler and the durable-linearizability checker drive at single-instruction
granularity.  The batched durable engines built for the card live in
:mod:`repro_torch.core.batched` and :mod:`repro_torch.core.ordered` and are
cross-checked against this machine's accounting in the tests.

**It stays a numpy machine on the host, and so does everything above it**
(the instruction layer, the policies, the six traversal structures, the
interleaving scheduler and the checkers).  It executes one word at a time:
the Izraelevitz list at 4096 keys is about 10^6 such instructions, and a
scalar index of a torch tensor costs several microseconds a word, on the
card a device round trip.  The reference keeps it on the host for the same
reason; a device copy of this machine would be a feature the reference
lacks.  It takes no ``device``: its memory images are numpy arrays, which
is what the port's tests compare bit for bit against the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

NULL = -1  # null "pointer" (node index)


def evicted_mask(n: int, evict, rng: np.random.Generator,
                 p_evict: float = 0.5) -> np.ndarray:
    """The shared implicit-eviction adversary, one policy for every
    crash model in the repo: given ``n`` pending items (dirty cache
    lines for :class:`PMem`, staged-but-unfenced files for
    :class:`repro_torch.persistence.manifest.StagedIO`), return a bool mask —
    True means that item happened to reach durable storage at the
    crash.  Seedable via ``rng`` so adversarial schedules replay
    exactly; unknown modes raise instead of silently behaving like
    ``"random"``.

    >>> import numpy as np
    >>> evicted_mask(3, "none", np.random.default_rng(0)).tolist()
    [False, False, False]
    >>> evicted_mask(3, "all", np.random.default_rng(0)).tolist()
    [True, True, True]
    >>> a = evicted_mask(5, "random", np.random.default_rng(7))
    >>> b = evicted_mask(5, "random", np.random.default_rng(7))
    >>> bool((a == b).all())
    True
    """
    if evict == "none":
        return np.zeros(n, dtype=bool)
    if evict == "all":
        return np.ones(n, dtype=bool)
    if evict == "random":
        return rng.random(n) < p_evict
    raise ValueError(f"unknown evict mode {evict!r}")


@dataclasses.dataclass
class PMemCounters:
    """Instruction accounting used by the paper-figure cost model."""

    reads: int = 0
    writes: int = 0
    cas: int = 0
    flushes: int = 0          # every explicit flush instruction issued
    fences: int = 0
    # flushes/fences attributed to the traversal phase (must stay 0 for
    # NVTraverse structures — asserted in tests).
    traverse_flushes: int = 0
    traverse_fences: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class PMem:
    """Word-addressed two-level memory with explicit persistence.

    Addresses are integers in ``[0, capacity)``.  Values are int64 words.
    """

    def __init__(self, capacity: int, line_words: int = 8,
                 seed: Optional[int] = None):
        if capacity % line_words:
            capacity += line_words - capacity % line_words
        self.capacity = capacity
        self.line_words = line_words
        self.volatile = np.zeros(capacity, dtype=np.int64)
        self.persistent = np.zeros(capacity, dtype=np.int64)
        # dirty: written since last persisted (the "pending" set, per word)
        self.dirty = np.zeros(capacity, dtype=bool)
        # flushed_line: a flush was issued for this line since the last fence
        self.flushed_line = np.zeros(capacity // line_words, dtype=bool)
        self.counters = PMemCounters()
        self._rng = np.random.default_rng(seed)
        self._crashed = False
        # optional repro_torch.robustness.faultinject.CrashPlan: when set,
        # every persistence instruction reports a crash site before
        # executing (attach via CrashPlan.attach, never set directly).
        # Recorders that additionally define ``on_event`` (e.g.
        # repro_torch.analysis.trace.PersistTrace) receive the *full*
        # instruction stream, writes included.
        self.faults = None
        # address 0 is reserved (packed null); allocations start at line 1
        self._alloc_cursor = line_words

    def _event(self, kind: str, target: str = "", **meta) -> None:
        """Report one executed instruction to an attached trace recorder."""
        cb = getattr(self.faults, "on_event", None) if self.faults else None
        if cb is not None:
            cb(kind, target, **meta)

    # ------------------------------------------------------------------ #
    # basic instructions                                                  #
    # ------------------------------------------------------------------ #
    def read(self, addr: int) -> int:
        self.counters.reads += 1
        return int(self.volatile[addr])

    def write(self, addr: int, value: int) -> None:
        self.counters.writes += 1
        self.volatile[addr] = value
        self.dirty[addr] = True
        if self.faults is not None:
            self._event("write", f"line:{self.line_of(addr)}")

    def cas(self, addr: int, expected: int, new: int) -> bool:
        """Atomic compare-and-swap on the volatile view."""
        if self.faults is not None:
            self.faults.on_site("publish", f"addr:{addr}")
            self._event("publish", f"addr:{addr}")
        self.counters.cas += 1
        if int(self.volatile[addr]) == expected:
            self.volatile[addr] = new
            self.dirty[addr] = True
            # the successful swing dirties its line like any write
            if self.faults is not None:
                self._event("write", f"line:{self.line_of(addr)}")
            return True
        return False

    # ------------------------------------------------------------------ #
    # persistence instructions                                            #
    # ------------------------------------------------------------------ #
    def line_of(self, addr: int) -> int:
        return addr // self.line_words

    def flush(self, addr: int, *, in_traverse: bool = False) -> None:
        """Issue a flush (clwb) for the line containing ``addr``.

        The flush only *guarantees* persistence once a subsequent fence
        executes; until then the line may still be dropped by a crash
        (matching clwb + sfence semantics).
        """
        if self.faults is not None:
            self.faults.on_site("flush", f"line:{self.line_of(addr)}")
            self._event("flush", f"line:{self.line_of(addr)}",
                        in_traverse=in_traverse)
        self.counters.flushes += 1
        if in_traverse:
            self.counters.traverse_flushes += 1
        self.flushed_line[self.line_of(addr)] = True

    def fence(self, *, in_traverse: bool = False) -> None:
        """sfence: all lines flushed since the previous fence are persisted."""
        if self.faults is not None:
            self.faults.on_site("fence", "")
            self._event("fence", in_traverse=in_traverse)
        self.counters.fences += 1
        if in_traverse:
            self.counters.traverse_fences += 1
        lines = np.nonzero(self.flushed_line)[0]
        for ln in lines:
            lo, hi = ln * self.line_words, (ln + 1) * self.line_words
            sel = self.dirty[lo:hi]
            self.persistent[lo:hi][sel] = self.volatile[lo:hi][sel]
            self.dirty[lo:hi] = False
        self.flushed_line[:] = False

    def persist_all(self) -> None:
        """Test helper: persist everything (e.g. after prefill setup)."""
        self.persistent[self.dirty] = self.volatile[self.dirty]
        self.dirty[:] = False
        self.flushed_line[:] = False

    # ------------------------------------------------------------------ #
    # crash semantics                                                     #
    # ------------------------------------------------------------------ #
    def dirty_lines(self) -> np.ndarray:
        d = self.dirty.reshape(-1, self.line_words).any(axis=1)
        return np.nonzero(d)[0]

    def crash(self, evict: str | Iterable[int] = "random",
              p_evict: float = 0.5) -> None:
        """Simulate a full-system crash.

        ``evict`` selects the implicit-eviction adversary:
          * ``"none"``   — no pending line reached NVRAM (pure loss);
          * ``"all"``    — every pending line happened to be evicted;
          * ``"random"`` — each pending line independently evicted with
            probability ``p_evict`` (the general adversary);
          * an iterable of line indices — exact adversarial choice, used by
            the exhaustive durable-linearizability checker.

        Afterwards the volatile view is reloaded from the persistent image
        (cache contents are gone).
        """
        lines = self.dirty_lines()
        if isinstance(evict, str):
            chosen = lines[evicted_mask(len(lines), evict, self._rng,
                                        p_evict)]
        else:
            chosen = np.asarray(sorted(set(evict)), dtype=np.int64)
        for ln in chosen:
            lo, hi = ln * self.line_words, (ln + 1) * self.line_words
            sel = self.dirty[lo:hi]
            self.persistent[lo:hi][sel] = self.volatile[lo:hi][sel]
        # cache is lost; reload from NVRAM
        self.volatile = self.persistent.copy()
        self.dirty[:] = False
        self.flushed_line[:] = False
        self._crashed = True

    # ------------------------------------------------------------------ #
    # allocation                                                          #
    # ------------------------------------------------------------------ #
    # A bump allocator whose cursor is *volatile auxiliary state* in the
    # paper's sense (Property 2): after a crash it is reconstructed by the
    # recovery scan (the structures' ``disconnect``), not persisted per
    # allocation.
    # Allocations are line-aligned so one node == one flushable unit.

    def init_alloc(self, base: int) -> None:
        self._alloc_cursor = base

    def alloc(self, n_words: int) -> int:
        lines = -(-n_words // self.line_words)
        addr = self._alloc_cursor
        self._alloc_cursor += lines * self.line_words
        if self._alloc_cursor > self.capacity:
            raise MemoryError("PMem pool exhausted")
        return addr

    @property
    def alloc_cursor(self) -> int:
        return self._alloc_cursor
