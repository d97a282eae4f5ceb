"""Ordering-rule replay over a recorded persistence trace.
(the port's own copy of ``repro.analysis.checker``)

The checker runs a per-target state machine over a
:class:`~repro_torch.analysis.trace.PersistEvent` stream:

``(clean) --write--> dirty --flush--> flushed --fence--> (clean)``

A *write* to a flushed-but-unfenced target invalidates the earlier
flush (the deliberately strict hardware model: a ``clwb`` does not
cover bytes written after it, even though the forgiving ``StagedIO``
simulator would persist the newest bytes at the fence).  Against that
model the rules are:

**Fatal violations** (the discipline is broken):

* ``missing-flush`` — a write the layer relies on durably was never
  carried to a fence: a publish whose payload source is still dirty, or
  a dirty/unfenced target left at end of trace (``end_check``).  Such
  bytes reach NVRAM only by eviction luck.
* ``publish-before-persist`` — a publish whose payload was flushed but
  not yet fenced: the rename/CAS can become visible before its payload
  is durable.
* ``traversal-phase-persistence`` — any flush/fence carrying
  ``in_traverse=True``: the paper's core claim is that the journey
  persists nothing.

**Non-fatal diagnostics** (correct but wasteful):

* ``redundant-flush`` — flushing a target already in the flushed state
  with no intervening write.
* ``fence-with-nothing-pending`` — a fence with no flushed target to
  persist.

An event kind outside :data:`~repro_torch.analysis.trace.EVENT_KINDS` raises
— the shared registry fails loudly here exactly as it does in
``CrashPlan.on_site``.

>>> from repro_torch.analysis.trace import PersistEvent as E
>>> good = [E(0, "write", "a.tmp"), E(1, "flush", "a.tmp"),
...         E(2, "fence", ""), E(3, "publish", "a", src="a.tmp")]
>>> check_events(good).ok
True
>>> no_fence = [good[0], good[1], good[3]]      # fence deleted
>>> [f.rule for f in check_events(no_fence).violations]
['publish-before-persist']
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List

from .trace import EVENT_KINDS, PersistEvent

FATAL_RULES = ("missing-flush", "publish-before-persist",
               "traversal-phase-persistence")
DIAG_RULES = ("redundant-flush", "fence-with-nothing-pending")

_DIRTY, _FLUSHED = "dirty", "flushed"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule hit: ``rule`` at event ``index`` on ``target``."""
    rule: str
    index: int          # event index (-1 for end-of-trace findings)
    target: str
    detail: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TraceReport:
    n_events: int
    violations: List[Finding]       # fatal: discipline broken
    diagnostics: List[Finding]      # non-fatal: correct but wasteful

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"n_events": self.n_events, "ok": self.ok,
                "violations": [f.to_dict() for f in self.violations],
                "diagnostics": [f.to_dict() for f in self.diagnostics]}


def check_events(events: Iterable[PersistEvent], *,
                 end_check: bool = True) -> TraceReport:
    """Replay ``events`` against the ordering rules.

    ``end_check=True`` (the file layers: every surviving write is part
    of the durable contract) reports targets still dirty or unfenced at
    end of trace as ``missing-flush``.  Use ``end_check=False`` for
    PMem structure traces, where volatile auxiliary state (the paper's
    Property 2) may legitimately stay unpersisted.
    """
    state: dict = {}                # target -> _DIRTY | _FLUSHED
    violations: List[Finding] = []
    diagnostics: List[Finding] = []
    n = 0
    for ev in events:
        n += 1
        if ev.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {ev.kind!r} "
                             f"(registry: {EVENT_KINDS})")
        if ev.in_traverse and ev.kind in ("flush", "fence"):
            violations.append(Finding(
                "traversal-phase-persistence", ev.index, ev.target,
                f"{ev.kind} issued during a traversal phase — the "
                f"journey must persist nothing"))
        if ev.kind == "write":
            # a write after a flush re-dirties: the flush no longer
            # covers the newest bytes
            state[ev.target] = _DIRTY
        elif ev.kind == "flush":
            if state.get(ev.target) == _FLUSHED:
                diagnostics.append(Finding(
                    "redundant-flush", ev.index, ev.target,
                    "flushed again with no intervening write"))
            else:
                # flushing a clean/unseen target is a valid marking
                # (e.g. persisting lines read during the critical phase)
                state[ev.target] = _FLUSHED
        elif ev.kind == "fence":
            pending = [t for t, s in state.items() if s == _FLUSHED]
            if not pending:
                diagnostics.append(Finding(
                    "fence-with-nothing-pending", ev.index, "",
                    "fence with no flushed target to persist"))
            for t in pending:
                del state[t]
        elif ev.kind == "publish":
            if ev.src is not None:
                st = state.get(ev.src)
                if st == _DIRTY:
                    violations.append(Finding(
                        "missing-flush", ev.index, ev.src,
                        f"publish of {ev.target!r} from a payload that "
                        f"was written but never flushed"))
                elif st == _FLUSHED:
                    violations.append(Finding(
                        "publish-before-persist", ev.index, ev.src,
                        f"publish of {ev.target!r} from a payload "
                        f"flushed but not yet fenced"))
                state.pop(ev.src, None)
            # the published name now holds durable bytes
            state.pop(ev.target, None)
        elif ev.kind == "trim":
            # unlink / remove_tree: the target (and, for a tree, every
            # name under it) leaves the durable contract
            state.pop(ev.target, None)
            prefix = ev.target.rstrip("/") + "/"
            for t in [t for t in state if t.startswith(prefix)]:
                del state[t]
    if end_check:
        for t, s in sorted(state.items()):
            what = ("written but never flushed" if s == _DIRTY
                    else "flushed but never fenced")
            violations.append(Finding(
                "missing-flush", -1, t,
                f"end of trace: {what} — durable only by eviction luck"))
    return TraceReport(n_events=n, violations=violations,
                       diagnostics=diagnostics)
