"""NVTrace event timeline + flight recorder: *why* latency moved.

Two consumers of the same clock as the windowed latency series
(`repro_torch.obs.windows`):

* :class:`EventTimeline` — timestamped annotations (snapshot/truncate,
  migration rounds, rebalance triggers, compile stalls, crash/recovery
  boundaries).  Because annotations and latency samples share one
  ``t_us`` axis, `timeline.py:attribute_excursions` can hand
  each p99 excursion window the concrete events inside it.
* :class:`FlightRecorder` — a bounded ring of the last-N observability
  entries (finished spans, persistence instructions, annotations),
  dumped to JSON on SLO breach or injected crash.  The dump is the
  post-mortem: what the process was doing in the moments before the
  breach, plus — on the subsequent reload — the per-phase
  restart/recovery timing breakdown (`engine.py:RequestLog`
  ``restart_timing``).

Both take caller-supplied or shared-epoch time so they align with the
deterministic load schedules in `repro_torch.obs.loadgen`.

>>> tl = EventTimeline(epoch_ns=0)
>>> _ = tl.annotate("snapshot", t_us=150.0, horizon=12)
>>> _ = tl.annotate("truncate", t_us=151.0, n_trimmed=3)
>>> [e["kind"] for e in tl.in_range(100.0, 200.0)]
['snapshot', 'truncate']

A window whose p99 towers over the median gets its events attached:

>>> series = [{"epoch": 0, "t_start_us": 0.0, "t_end_us": 100.0,
...            "count": 9, "p99_us": 10.0},
...           {"epoch": 1, "t_start_us": 100.0, "t_end_us": 200.0,
...            "count": 9, "p99_us": 80.0},
...           {"epoch": 2, "t_start_us": 200.0, "t_end_us": 300.0,
...            "count": 9, "p99_us": 10.0}]
>>> exc = attribute_excursions(series, tl, factor=3.0)
>>> [(e["epoch"], [v["kind"] for v in e["events"]]) for e in exc]
[(1, ['snapshot', 'truncate'])]
"""
from __future__ import annotations

import json
import time
from collections import deque
from statistics import median


class EventTimeline:
    """Append-only list of ``{t_us, kind, **meta}`` annotations.

    ``t_us`` is relative to ``epoch_ns`` (defaults to construction
    time); pass a tracer's ``epoch_ns`` so spans, annotations and
    latency windows share one axis.  ``annotate`` without ``t_us``
    stamps *now*; explicit ``t_us`` keeps tests deterministic.
    """

    def __init__(self, epoch_ns: int | None = None, recorder=None):
        self.epoch_ns = (time.perf_counter_ns()
                         if epoch_ns is None else epoch_ns)
        self.events = []
        self.recorder = recorder    # optional FlightRecorder mirror

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self.epoch_ns) / 1e3

    def annotate(self, kind: str, t_us: float | None = None,
                 **meta) -> dict:
        e = {"t_us": self.now_us() if t_us is None else float(t_us),
             "kind": str(kind), **meta}
        self.events.append(e)
        if self.recorder is not None:
            self.recorder.note("annotation", e)
        return e

    def in_range(self, t0_us: float, t1_us: float) -> list:
        """Annotations with ``t0_us <= t_us < t1_us`` (same half-open
        convention as the latency windows)."""
        return [e for e in self.events if t0_us <= e["t_us"] < t1_us]

    def to_list(self) -> list:
        return list(self.events)


def attribute_excursions(series, timeline, factor: float = 2.0,
                         quantile_key: str = "p99_us",
                         min_count: int = 1,
                         slack_us: float = 0.0) -> list:
    """Attach timeline events to latency-excursion windows.

    A window is an *excursion* when its ``quantile_key`` value is at
    least ``factor`` times the median of that value across all windows
    with ``count >= min_count``.  Each excursion row carries the
    annotations whose ``t_us`` falls inside the window (widened by
    ``slack_us`` on the left, so an event logged just before the
    boundary — e.g. a snapshot whose cost lands on the next sample —
    still attributes).

    Returns ``[{epoch, t_start_us, t_end_us, <quantile_key>,
    baseline_us, count, events}]`` sorted by epoch; windows with no
    matching events still appear (``events == []``) so "unexplained
    excursion" is a visible state, not a silent drop.
    """
    rows = [r for r in series if r.get("count", 0) >= min_count
            and r.get(quantile_key) == r.get(quantile_key)]  # drop NaN
    if not rows:
        return []
    baseline = median(r[quantile_key] for r in rows)
    out = []
    for r in rows:
        if baseline > 0 and r[quantile_key] >= factor * baseline:
            out.append({
                "epoch": r["epoch"],
                "t_start_us": r["t_start_us"],
                "t_end_us": r["t_end_us"],
                quantile_key: r[quantile_key],
                "baseline_us": baseline,
                "count": r["count"],
                "events": timeline.in_range(
                    r["t_start_us"] - slack_us, r["t_end_us"]),
            })
    return out


class FlightRecorder:
    """Bounded ring of the last-``capacity`` observability entries.

    Three entry types, all ``{"type", "t_us", ...}``:

    * ``"span"`` — finished spans, fed via ``Tracer.on_span``
      (`spans.py:Tracer`);
    * ``"persist"`` — persistence instructions, fed by sitting in a
      ``faults`` slot (tee alongside the normal listener with
      `spans.py:FaultsTee`);
    * ``"annotation"`` — timeline events, mirrored when the timeline
      is built with ``recorder=``.

    ``dump()`` freezes the ring to a JSON-able dict (optionally written
    to a file) stamped with a reason (``"slo_breach"`` /
    ``"injected_crash"`` / ...) and, when supplied, the per-phase
    restart timing of the post-crash reload.  Dumps are cheap and the
    ring keeps recording afterwards.

    >>> fr = FlightRecorder(capacity=2, clock=lambda: 42.0)
    >>> for i in range(3):
    ...     fr.note("annotation", {"kind": "snapshot", "i": i})
    >>> [e["i"] for e in fr.entries()]      # ring keeps the last 2
    [1, 2]
    >>> d = fr.dump("slo_breach")
    >>> d["reason"], d["n_entries"], d["dropped"]
    ('slo_breach', 2, 1)
    """

    def __init__(self, capacity: int = 512, clock=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring = deque(maxlen=self.capacity)
        self._clock = clock
        self._epoch_ns = time.perf_counter_ns()
        self.seen = 0            # entries ever noted (ring may drop)
        self.dumps = []          # reasons, in order

    def now_us(self) -> float:
        if self._clock is not None:
            return float(self._clock())
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    # -- feeds --------------------------------------------------------
    def note(self, typ: str, entry: dict) -> None:
        e = dict(entry)
        e["type"] = typ
        e.setdefault("t_us", self.now_us())
        self._ring.append(e)
        self.seen += 1

    def on_span(self, record: dict) -> None:
        """``Tracer.on_span`` callback: record is ``Span.to_record``
        output (already carries ``t_us`` on the tracer's epoch)."""
        self.note("span", record)

    # faults-slot surface (sit behind a FaultsTee):
    def on_site(self, kind: str, target: str) -> None:
        return None

    def on_event(self, kind: str, target: str = "", **meta) -> None:
        self.note("persist", {"kind": kind, "target": target, **meta})

    # -- dump ---------------------------------------------------------
    def entries(self) -> list:
        return list(self._ring)

    def dump(self, reason: str, path=None, restart_timing=None,
             extra=None) -> dict:
        doc = {"reason": reason,
               "t_us": self.now_us(),
               "capacity": self.capacity,
               "n_entries": len(self._ring),
               "seen": self.seen,
               "dropped": self.seen - len(self._ring),
               "entries": self.entries()}
        if restart_timing is not None:
            doc["restart_timing"] = dict(restart_timing)
        if extra:
            doc.update(extra)
        self.dumps.append(reason)
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
        return doc
