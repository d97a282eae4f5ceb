"""NVTrace spans: request-scoped phase timing that carries the
persistence-instruction bill of each phase (the port's own copy of
``repro.obs.spans``).

A :class:`Tracer` maintains a stack of nested :class:`Span`s
(``commit -> flush_fence`` and ``snapshot -> flush_fence / publish`` in
the request log) and a bounded ring buffer of finished spans.  Every
span reports wall time *and* how many flush/fence/publish/write/trim
instructions executed while it was the innermost open span — and those
counts come **free**: a :class:`PersistListener` rides the ``faults``
attach surface of ``StagedIO`` (its ``on_event`` hooks), so no
durable-layer code grows a single new instrumentation site.  A traversal-phase span showing
``counts == {}`` next to a commit-phase span paying all the fences is
the paper's asymmetry, live.
"""
from __future__ import annotations

import time
from collections import deque


class Span:
    """One phase span; also its own context manager (a generator-based
    ``@contextmanager`` costs ~2x as much per enter/exit, and spans sit
    on the serving hot path)."""

    __slots__ = ("phase", "depth", "t0_ns", "dur_us", "counts", "meta",
                 "_tracer")

    def __init__(self, tracer, phase, depth, t0_ns, meta):
        self._tracer = tracer
        self.phase = phase
        self.depth = depth
        self.t0_ns = t0_ns
        self.dur_us = None
        self.counts = {}
        self.meta = meta

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        tr._stack.pop()
        self.dur_us = (time.perf_counter_ns() - self.t0_ns) / 1e3
        tr._ring.append(self)        # record dicts are built lazily
        cached = tr._hists.get(self.phase)
        if cached is None or cached[0] != tr.registry.gen:
            cached = (tr.registry.gen, tr.registry.histogram(
                "span_us", lo=0.1, hi=1e8, growth=1.25,
                phase=self.phase))
            tr._hists[self.phase] = cached
        cached[1].record(self.dur_us)
        if self.counts:
            sc = tr.span_counts
            for k, n in self.counts.items():
                sc[k] = sc.get(k, 0) + n
        return False

    def to_record(self, epoch_ns) -> dict:
        return {"span": self.phase, "depth": self.depth,
                "t_us": (self.t0_ns - epoch_ns) / 1e3,
                "dur_us": self.dur_us, "counts": self.counts,
                **({"meta": self.meta} if self.meta else {})}


class Tracer:
    """Nested phase spans + ring-buffer trace sink.

    * ``span(phase)`` is a context manager; spans nest, and an event
      reported while several spans are open is charged to the
      **innermost** one only, so summing ``counts`` over all finished
      spans never double-counts an instruction.
    * finished spans land in a ring buffer (``maxlen=ring``) as plain
      dicts; ``totals`` accumulates per-kind event counts for the
      tracer's whole lifetime (ring overflow never loses totals).
    * per-span wall time is also recorded into the registry histogram
      ``span_us{phase=...}`` so p50/p99 per phase fall out of the
      ordinary metrics path.
    """

    def __init__(self, registry=None, ring: int = 2048):
        if registry is None:
            from .metrics import get_registry
            registry = get_registry()
        self.registry = registry
        self.epoch_ns = time.perf_counter_ns()
        self._ring = deque(maxlen=ring)
        self._stack = []
        self._hists = {}        # phase -> (registry gen, histogram):
                                # skips the registry label lookup per
                                # span exit, invalidated by reset()
        self.totals = {}
        self.span_counts = {}   # per-kind sums over *finished* spans

    # -- spans --------------------------------------------------------
    def span(self, phase: str, **meta):
        """Open a phase span (use as ``with tracer.span("commit") as s``).
        The span closes — and is recorded — when the ``with`` block
        exits."""
        s = Span(self, phase, len(self._stack),
                 time.perf_counter_ns(), meta)
        self._stack.append(s)
        return s

    # -- event accounting (called by PersistListener) -----------------
    def count_event(self, kind: str, n: int = 1) -> None:
        self.totals[kind] = self.totals.get(kind, 0) + n
        if self._stack:
            s = self._stack[-1]
            s.counts[kind] = s.counts.get(kind, 0) + n

    # -- sink ---------------------------------------------------------
    def records(self) -> list:
        return [s.to_record(self.epoch_ns) for s in self._ring]


class PersistListener:
    """Metrics-emitting ``faults`` attachment for ``PMem``/``StagedIO``.

    Implements the ``faults`` surface of ``StagedIO`` (``on_site`` — a
    no-op, it never fires — and ``on_event``).  Every persistence instruction becomes a
    registry counter ``persist_events_total{kind=...}`` and is charged
    to the tracer's innermost open span.
    """

    def __init__(self, tracer=None, registry=None):
        if registry is None and tracer is not None:
            registry = tracer.registry
        if registry is None:
            from .metrics import get_registry
            registry = get_registry()
        self.tracer = tracer
        self.registry = registry
        self._counters = {}   # kind -> (registry gen, counter) hot cache

    def attach(self, *objs) -> "PersistListener":
        for o in objs:
            o.faults = self
        return self

    def on_site(self, kind: str, target: str) -> None:
        return None

    def on_event(self, kind: str, target: str = "", **meta) -> None:
        cached = self._counters.get(kind)
        if cached is None or cached[0] != self.registry.gen:
            cached = (self.registry.gen, self.registry.counter(
                "persist_events_total", kind=kind))
            self._counters[kind] = cached
        cached[1].inc()
        if self.tracer is not None:
            self.tracer.count_event(kind)
