"""Persistence-instruction trace recording.
(the port's own copy of ``repro.analysis.trace``)

:class:`PersistTrace` is a :class:`~repro_torch.robustness.faultinject.
CrashPlan` that never fires: attached to a
:class:`~repro_torch.persistence.manifest.StagedIO` or
:class:`~repro_torch.core.pmem.PMem` through the exact surface the crash
sweep uses (``plan.attach(obj)`` → ``obj.faults``), it records the
**full** executed instruction stream — writes included, which crash
sites deliberately omit — as a list of :class:`PersistEvent`.  The
stream is what :func:`repro_torch.analysis.checker.check_events` replays
against the ordering rules.

Event kinds are the shared crash-site registry
:data:`repro_torch.robustness.KINDS` plus ``"write"`` (a staged write is not
a crash site — crashing "before" a volatile write is the same crash as
before the next site — but the checker needs it to know what each
flush/fence/publish covers).  An unknown kind raises, mirroring
``CrashPlan.on_site``.
"""
from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path
from typing import List, Optional

from ..robustness import KINDS
from ..robustness.faultinject import SCENARIOS, CrashPlan

#: every kind a :class:`PersistEvent` may carry: the crash-site
#: registry plus the volatile ``"write"`` instruction.
EVENT_KINDS = ("write",) + KINDS


@dataclasses.dataclass(frozen=True)
class PersistEvent:
    """One executed persistence-relevant instruction.

    ``target`` is a staged-file rel path (StagedIO), a cache line
    (``line:N``) or CAS address (``addr:N``) for PMem, or ``""`` for a
    fence.  ``src`` is set only on file publishes: the staged tmp name
    whose bytes the rename makes visible.  ``in_traverse`` marks
    flush/fence instructions issued during an operation's traversal
    phase (must never happen for NVTraverse structures).
    """
    index: int
    kind: str
    target: str
    src: Optional[str] = None
    in_traverse: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class PersistTrace(CrashPlan):
    """A no-crash :class:`CrashPlan` that records the full stream.

    Inherits the site numbering (``sites`` / ``completed_sites``), so a
    scenario's own ``check()`` still works; additionally every
    instrumented instruction lands in :attr:`events` via the optional
    ``on_event`` hook the IO substrates call when present.
    """

    def __init__(self):
        super().__init__()          # crash_at=None, p_crash=0: never fires
        self.events: List[PersistEvent] = []

    def on_event(self, kind: str, target: str = "", *,
                 src: Optional[str] = None,
                 in_traverse: bool = False) -> None:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r} "
                             f"(registry: {EVENT_KINDS})")
        self.events.append(PersistEvent(len(self.events), kind, target,
                                        src, in_traverse))


def trace_scenario(layer: str, scenario_kw: Optional[dict] = None
                   ) -> PersistTrace:
    """Run one faultinject scenario (``log`` / ``checkpoint`` /
    ``migrate`` / ``rebalance``) in no-crash mode under a
    :class:`PersistTrace` and return the populated trace.  The
    scenario's own recovery invariants are checked too — a trace of a
    broken run would prove nothing."""
    scenario_cls = SCENARIOS[layer]
    trace = PersistTrace()
    with tempfile.TemporaryDirectory() as d:
        sc = scenario_cls(Path(d), trace, **(scenario_kw or {}))
        sc.run()
        sc.check()
    return trace
