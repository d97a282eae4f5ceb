"""PersistLint: static + trace-based persistence-ordering analysis.
(the port's own copy of ``repro.analysis``)

Two cooperating passes over the NVTraverse flush/fence/publish
discipline that the rest of the repo implements and docs/durability.md
argues in prose:

* :mod:`repro_torch.analysis.persistlint` — AST-based **static lint** over
  ``src/repro_torch``: durable layers must not bypass
  :class:`repro_torch.persistence.manifest.StagedIO`, every publish must be
  fence-dominated with no intervening durable write, traversal-phase
  code must contain no persistence instructions, and every crash-site
  kind must come from the shared :data:`repro_torch.robustness.KINDS`
  registry.
* :mod:`repro_torch.analysis.trace` + :mod:`repro_torch.analysis.checker` —
  **dynamic trace checking**: a :class:`~repro_torch.analysis.trace.
  PersistTrace` records the full instruction stream through the same
  attach surface :class:`~repro_torch.robustness.faultinject.CrashPlan` uses,
  and the checker replays it against the ordering rules
  (missing-flush, publish-before-persist, traversal-phase persistence;
  redundant-flush / fence-with-nothing-pending as diagnostics).

The reference's CLI over both passes, ``tools/persist_lint.py``, is not
ported: call :func:`run_static` and :func:`check_events` directly.
"""
from .checker import TraceReport, check_events
from .persistlint import StaticReport, Violation, run_static
from .trace import EVENT_KINDS, PersistEvent, PersistTrace, trace_scenario

__all__ = [
    "EVENT_KINDS", "PersistEvent", "PersistTrace", "trace_scenario",
    "TraceReport", "check_events",
    "StaticReport", "Violation", "run_static",
]
