"""NVTrace: runtime observability for the serving + durable-map stack
(the port of ``repro.obs``; the modules are the reference's own, renamed).

Make the paper's phase asymmetry (traversal persists nothing; every
fence lands at the destination) *measurable on a live process* instead
of only provable by crash sweeps and lint — and, since LoadScope,
measurable *over time under load*:

* :mod:`repro_torch.obs.metrics` — counters / gauges / log-bucket histograms
  in a mergeable, snapshottable registry.
* :mod:`repro_torch.obs.spans` — nested phase spans whose per-span
  flush/fence/publish counts ride the existing ``faults`` hook surface,
  each also a ``torch.profiler`` range ``nvt.<phase>`` while a profiler
  runs; garbage collections as counters and spans.
* :mod:`repro_torch.obs.compile` — first-call stall tracking with
  trigger attribution (the capacity ladder of the dedup map).
* :mod:`repro_torch.obs.windows` — fixed-epoch windowed histograms/counters:
  the rolling p50/p99/throughput series.
* :mod:`repro_torch.obs.timeline` — timestamped event annotations aligned
  with the latency series (excursion attribution) and a bounded
  flight recorder dumped on SLO breach or crash.
* :mod:`repro_torch.obs.loadgen` — deterministic open/closed-loop load
  generator that ties all of the above together against
  ``RequestLog``/``ServeEngine``.
"""
from .compile import CompileEvent, CompileTracker, get_tracker
from .loadgen import LoadHarness, LoadSpec, Schedule, make_schedule
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .spans import (FaultsTee, PersistListener, Span, Tracer,
                    get_tracer, profiled)
from .timeline import EventTimeline, FlightRecorder, attribute_excursions
from .windows import WindowedCounter, WindowedHistogram

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "Span", "Tracer", "PersistListener", "FaultsTee", "get_tracer",
    "profiled",
    "CompileEvent", "CompileTracker", "get_tracker",
    "WindowedHistogram", "WindowedCounter",
    "EventTimeline", "FlightRecorder", "attribute_excursions",
    "LoadSpec", "Schedule", "make_schedule", "LoadHarness",
]
