"""Systematic crash-fault injection for the port's durable layers (port of
``repro.robustness``).

:data:`KINDS` is the crash-site kind registry: every persistence
instruction an instrumented IO object reports to a
:class:`~repro_torch.robustness.faultinject.CrashPlan` carries one of
these kinds, and an unknown kind fails loudly.
"""

#: The shared crash-site kind registry (defined before the faultinject
#: import below, which reads it from this partially initialized package).
KINDS = ("flush", "fence", "publish", "trim")

from .faultinject import (CrashPlan, CrashPoint, CrashSite,  # noqa: E402
                          SCENARIOS, enumerate_sites, sweep)

__all__ = ["KINDS", "CrashPlan", "CrashPoint", "CrashSite", "SCENARIOS",
           "enumerate_sites", "sweep"]
