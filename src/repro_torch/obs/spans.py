"""NVTrace spans: request-scoped phase timing that carries the
persistence-instruction bill of each phase (the port's own copy of
``repro.obs.spans``).

A :class:`Tracer` maintains a stack of nested :class:`Span`s
(``route -> plan -> commit -> flush/fence -> publish -> snapshot`` in
the serving loop) and a bounded ring buffer of finished-span records
(JSONL via `Tracer.dump_jsonl`).  Every span reports wall time *and*
how many flush/fence/publish/write/trim instructions executed while it
was the innermost open span — and those counts come **free**: a
:class:`PersistListener` rides the same ``faults`` attach surface that
``CrashPlan``/``PersistTrace`` use (the ``on_event`` hooks on
``PMem``/``StagedIO``), so no durable-layer code grows a single new
instrumentation site.  A traversal-phase span showing
``counts == {}`` next to a commit-phase span paying all the fences is
the paper's asymmetry, live.

:class:`FaultsTee` fans one ``faults`` slot out to several sinks
(e.g. a ``PersistTrace`` *and* a ``PersistListener`` on the same run),
which is how span-level counts are cross-validated against the trace
checker's event totals.

While a ``torch.profiler`` session runs, every span also opens a profiler
range named ``nvt.<phase>`` (a ``user_annotation`` event in the
profiler's Chrome-trace export, on the profiler's own clock), so the
device trace says which program phase the host was in; with no profiler
running a span pays one flag check for it.  :func:`profiled` is the same
range without a span, for sites called hundreds of times a step, and
:meth:`Tracer.watch_gc` turns Python's garbage collections into counters,
histograms and (full collections) ``gc`` spans.
"""
from __future__ import annotations

import gc
import json
import time
import weakref
from collections import deque

from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

RANGE_PREFIX = "nvt."


class Span:
    """One phase span; also its own context manager (a generator-based
    ``@contextmanager`` costs ~2x as much per enter/exit, and spans sit
    on the serving hot path)."""

    __slots__ = ("phase", "depth", "t0_ns", "dur_us", "counts", "meta",
                 "_tracer", "_range")

    def __init__(self, tracer, phase, depth, t0_ns, meta, rng=None):
        self._tracer = tracer
        self.phase = phase
        self.depth = depth
        self.t0_ns = t0_ns
        self.dur_us = None
        self.counts = {}
        self.meta = meta
        self._range = rng       # the open profiler range, if any

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        tr._stack.pop()
        self.dur_us = (time.perf_counter_ns() - self.t0_ns) / 1e3
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        tr._finish(self)
        return False

    def to_record(self, epoch_ns) -> dict:
        return {"span": self.phase, "depth": self.depth,
                "t_us": (self.t0_ns - epoch_ns) / 1e3,
                "dur_us": self.dur_us, "counts": self.counts,
                **({"meta": self.meta} if self.meta else {})}


class _DisabledSpan:
    """Shared no-op context manager for ``enabled=False`` tracers."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_DISABLED = _DisabledSpan()


def _open_range(name: str):
    rng = record_function(RANGE_PREFIX + name)
    rng.__enter__()
    return rng


def profiled(name: str):
    """A profiler range ``nvt.<name>`` around a ``with`` block while a
    ``torch.profiler`` session runs, and nothing otherwise (one flag
    check).  It never enters a tracer's ring or histograms: it is for
    sites called hundreds of times a step, such as the kernel wrappers'
    host work or the serving engine's decode step."""
    if not _profiler._is_profiler_enabled:
        return _DISABLED
    return record_function(RANGE_PREFIX + name)


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
    * while a ``torch.profiler`` session runs, each span is also the
      profiler range ``nvt.<phase>``, on the device trace's clock.
    """

    def __init__(self, registry=None, ring: int = 2048,
                 enabled: bool = True):
        if registry is None:
            from .metrics import get_registry
            registry = get_registry()
        self.registry = registry
        self.enabled = enabled
        self.epoch_ns = time.perf_counter_ns()
        self._ring = deque(maxlen=ring)
        self._stack = []
        self._hists = {}        # phase -> (registry gen, histogram):
                                # skips the registry label lookup per
                                # span exit, invalidated by reset()
        self._gc_metrics = {}   # generation -> (registry gen, counter,
                                # histogram), the same for watch_gc
        self.totals = {}
        self.span_counts = {}   # per-kind sums over *finished* spans
        self.on_span = None     # optional callback(record) on span
                                # close — the FlightRecorder feed
                                # (`repro_torch.obs.timeline`); one attr
                                # check per exit when unset

    # -- spans --------------------------------------------------------
    @property
    def current(self):
        return self._stack[-1] if self._stack else None

    def span(self, phase: str, **meta):
        """Open a phase span (use as ``with tracer.span("commit") as s``;
        ``s`` is None on a disabled tracer).  The span closes — and is
        recorded — when the ``with`` block exits."""
        if not self.enabled:
            return _DISABLED
        s = Span(self, phase, len(self._stack), time.perf_counter_ns(),
                 meta, _open_range(phase) if _profiler._is_profiler_enabled
                 else None)
        self._stack.append(s)
        return s

    def _finish(self, s: Span) -> None:
        """Record a finished span: the ring, the flight recorder's feed,
        its phase's histogram and the per-kind sums."""
        self._ring.append(s)         # record dicts are built lazily
        if self.on_span is not None:  # flight-recorder feed (rare)
            self.on_span(s.to_record(self.epoch_ns))
        cached = self._hists.get(s.phase)
        if cached is None or cached[0] != self.registry.gen:
            cached = (self.registry.gen, self.registry.histogram(
                "span_us", lo=0.1, hi=1e8, growth=1.25, phase=s.phase))
            self._hists[s.phase] = cached
        cached[1].record(s.dur_us)
        if s.counts:
            sc = self.span_counts
            for k, n in s.counts.items():
                sc[k] = sc.get(k, 0) + n

    # -- garbage collections ------------------------------------------
    def watch_gc(self) -> "Tracer":
        """Record Python's garbage collections: every collection adds to
        ``gc_collections_total{generation}`` and
        ``gc_pause_us{generation}`` on the tracer's registry, and a full
        (generation 2) one is also a finished ``gc`` span (meta
        ``generation``) charged where it fell, one level below the spans
        then open.  While a profiler runs each collection is also a
        range: ``nvt.gc`` for a full one, ``nvt.gc0`` and ``nvt.gc1`` for
        the younger generations.  One ``gc.callbacks`` hook serves every
        watching tracer, counting once per registry.  Each call is one
        watch, undone by one :meth:`unwatch_gc`, so owners that share a
        tracer keep it watched until the last lets go; a tracer watched
        several times records each collection once."""
        if self.enabled:
            _GC_WATCHERS[self] = _GC_WATCHERS.get(self, 0) + 1
            if _on_gc not in gc.callbacks:
                gc.callbacks.append(_on_gc)
        return self

    def unwatch_gc(self) -> None:
        n = _GC_WATCHERS.pop(self, 0) - 1
        if n > 0:
            _GC_WATCHERS[self] = n
        elif not _GC_WATCHERS and _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)

    # -- event accounting (called by PersistListener) -----------------
    def count_event(self, kind: str, n: int = 1) -> None:
        self.totals[kind] = self.totals.get(kind, 0) + n
        if self._stack:
            s = self._stack[-1]
            s.counts[kind] = s.counts.get(kind, 0) + n

    # -- sinks --------------------------------------------------------
    def records(self) -> list:
        return [s.to_record(self.epoch_ns) for s in self._ring]

    def dump_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for s in self._ring:
                f.write(json.dumps(s.to_record(self.epoch_ns)) + "\n")


_GC_WATCHERS: "weakref.WeakKeyDictionary[Tracer, int]" = \
    weakref.WeakKeyDictionary()     # tracer -> its watches
_GC_OPEN: list = []     # the running collection's (t0, range)


def _on_gc(phase: str, info: dict) -> None:
    """The one ``gc.callbacks`` hook of :meth:`Tracer.watch_gc`."""
    gen = info["generation"]
    if phase == "start":
        # while a profiler runs, every collection is a range (a young one
        # scanning many fresh objects stalls the host too)
        _GC_OPEN.append((time.perf_counter_ns(), _open_range(
            "gc" if gen == 2 else f"gc{gen}")
            if _profiler._is_profiler_enabled else None))
        return
    if not _GC_OPEN:            # the hook went in mid-collection
        return
    t0, rng = _GC_OPEN.pop()
    dur_us = (time.perf_counter_ns() - t0) / 1e3
    if rng is not None:
        rng.__exit__(None, None, None)
    seen = set()
    for tr in list(_GC_WATCHERS):
        if gen == 2:
            s = Span(tr, "gc", len(tr._stack), t0, {"generation": 2})
            s.dur_us = dur_us
            tr._finish(s)
        reg = tr.registry
        if id(reg) in seen:
            continue
        seen.add(id(reg))
        cached = tr._gc_metrics.get(gen)
        if cached is None or cached[0] != reg.gen:
            cached = tr._gc_metrics[gen] = (
                reg.gen, reg.counter("gc_collections_total", generation=gen),
                reg.histogram("gc_pause_us", lo=1.0, hi=1e8, growth=1.25,
                              generation=gen))
        cached[1].inc()
        cached[2].record(dur_us)


_TRACER = None


def get_tracer() -> Tracer:
    """The process-wide tracer, on the process-wide registry: what the
    train step and the kernel builds record to unless handed another."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER


class PersistListener:
    """Metrics-emitting ``faults`` attachment for ``PMem``/``StagedIO``.

    Implements the crash-plan surface (``on_site`` — a no-op, it never
    fires — and ``on_event``) so it can sit in the ``faults`` slot that
    ``CrashPlan.attach`` uses.  Every persistence instruction becomes a
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
        self.totals = {}
        self._counters = {}   # kind -> (registry gen, counter) hot cache

    def attach(self, *objs) -> "PersistListener":
        for o in objs:
            o.faults = self
        return self

    def on_site(self, kind: str, target: str) -> None:
        return None

    def on_event(self, kind: str, target: str = "", **meta) -> None:
        self.totals[kind] = self.totals.get(kind, 0) + 1
        cached = self._counters.get(kind)
        if cached is None or cached[0] != self.registry.gen:
            cached = (self.registry.gen, self.registry.counter(
                "persist_events_total", kind=kind))
            self._counters[kind] = cached
        cached[1].inc()
        if self.tracer is not None:
            self.tracer.count_event(kind)


class FaultsTee:
    """Fan one ``faults`` slot out to several sinks.

    ``on_site`` forwards to every sink that defines it (a sink that
    raises — a firing ``CrashPlan`` — propagates); ``on_event``
    likewise.  Used to run a ``PersistTrace`` and a
    :class:`PersistListener` over the *same* instruction stream, which
    is how the two observability layers cross-validate.
    """

    def __init__(self, *sinks):
        self.sinks = tuple(sinks)

    def attach(self, *objs) -> "FaultsTee":
        for o in objs:
            o.faults = self
        return self

    def on_site(self, kind: str, target: str) -> None:
        for s in self.sinks:
            fn = getattr(s, "on_site", None)
            if fn is not None:
                fn(kind, target)

    def on_event(self, kind: str, target: str = "", **meta) -> None:
        for s in self.sinks:
            fn = getattr(s, "on_event", None)
            if fn is not None:
                fn(kind, target, **meta)
