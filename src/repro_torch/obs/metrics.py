"""NVTrace metrics: a process-local registry of counters, gauges and
fixed log-spaced-bucket histograms (the port's own copy of
``repro.obs.metrics``).

The paper's whole argument is an *accounting* one — traversal persists
nothing, so every microsecond and every fence concentrates at the
destination — and this module is the ledger that argument is read from
at runtime.  Three metric kinds, one registry:

* :class:`Counter` — monotone event totals (records parsed, flushes
  issued, migrations completed).
* :class:`Gauge` — last-written level (per-shard load, imbalance).
* :class:`Histogram` — fixed log-spaced buckets with an explicit
  overflow bucket.  Quantiles are *deterministic and bounded*: for any
  recorded distribution, ``oracle <= quantile(q) <= oracle * growth``
  (the bucket upper edge), so p50/p99/p999 are exact up to the
  configured bucket resolution — and two histograms with the same
  layout merge by elementwise count addition, which is what makes
  snapshots mergeable across shards and subprocesses.

Snapshots are plain JSON (`MetricsRegistry.snapshot` /
`MetricsRegistry.from_snapshot` / `MetricsRegistry.merge_snapshot`)
and export to Prometheus text (`MetricsRegistry.to_prometheus`) or a
JSON file (`MetricsRegistry.dump_json`).

>>> reg = MetricsRegistry()
>>> reg.counter("ops_total", layer="log").inc(3)
>>> reg.counter("ops_total", layer="log").value
3
>>> h = reg.histogram("lat_us", lo=1.0, hi=1000.0, growth=2.0)
>>> for v in [1, 2, 3, 500]:
...     h.record(v)
>>> h.count, h.quantile(0.5), h.quantile(0.99)
(4, 2.0, 512.0)

Round-trip through JSON and merge — the cross-shard path:

>>> import json
>>> snap = json.loads(json.dumps(reg.snapshot()))
>>> twin = MetricsRegistry.from_snapshot(snap)
>>> twin.merge_snapshot(snap)          # two identical shards
>>> twin.counter("ops_total", layer="log").value
6
>>> twin.histogram("lat_us", lo=1.0, hi=1000.0, growth=2.0).count
8
"""
from __future__ import annotations

import json
import math
from bisect import bisect_left
from dataclasses import dataclass, field


class Counter:
    """Monotone counter.  ``inc`` only; negative increments raise."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = value

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters are monotone; inc(n >= 0)")
        self.value += n


class Gauge:
    """Last-written level (may go up or down)."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


def log_bounds(lo: float, hi: float, growth: float) -> tuple:
    """Bucket upper edges ``lo * growth**i`` covering ``[0, hi]``.

    >>> log_bounds(1.0, 8.0, 2.0)
    (1.0, 2.0, 4.0, 8.0)
    """
    if not (lo > 0 and hi >= lo and growth > 1.0):
        raise ValueError("need lo > 0, hi >= lo, growth > 1")
    n = max(1, math.ceil(math.log(hi / lo) / math.log(growth) - 1e-9) + 1)
    return tuple(lo * growth ** i for i in range(n))


class Histogram:
    """Fixed log-spaced-bucket histogram with an overflow bucket.

    ``counts`` has ``len(bounds) + 1`` slots: bucket *i* holds values in
    ``(bounds[i-1], bounds[i]]`` (bucket 0 is ``[0, bounds[0]]``), the
    last slot holds everything past ``bounds[-1]``.  Quantiles return
    the containing bucket's upper edge — or the observed ``max`` for
    the overflow bucket — so they never under-report.
    """

    __slots__ = ("lo", "hi", "growth", "bounds", "counts",
                 "sum", "min", "max")

    def __init__(self, lo: float = 1.0, hi: float = 1e7,
                 growth: float = 1.25):
        self.lo, self.hi, self.growth = float(lo), float(hi), float(growth)
        self.bounds = log_bounds(lo, hi, growth)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def count(self) -> int:
        return sum(self.counts)

    def record(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the ``q``-th observation.

        Bounded by construction: ``oracle <= quantile(q) <=
        oracle * growth`` for in-range data; overflow returns the
        observed max.  Returns ``nan`` when empty.
        """
        total = self.count
        if total == 0:
            return math.nan
        rank = min(max(1, math.ceil(q * total)), total)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max  # pragma: no cover - rank <= total

    def merge(self, other: "Histogram") -> None:
        """Elementwise count addition; layouts must match exactly."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


@dataclass
class _Entry:
    kind: str
    name: str
    labels: dict
    obj: object = field(default=None)


class MetricsRegistry:
    """Name+labels → metric object; one kind per name.

    ``counter``/``gauge``/``histogram`` are get-or-create and memoized,
    so call sites just ask for the metric every time — no wiring phase.
    """

    def __init__(self):
        self._entries = {}   # (name, label_key) -> _Entry
        self._kinds = {}     # name -> kind
        self.gen = 0         # bumped by reset(): hot paths that cache a
                             # metric handle key it on (registry, gen)

    # -- get-or-create ------------------------------------------------
    def _get(self, kind, name, labels, factory):
        seen = self._kinds.get(name)
        if seen is not None and seen != kind:
            raise ValueError(f"metric {name!r} already registered "
                             f"as a {seen}, not a {kind}")
        key = (name, _label_key(labels))
        e = self._entries.get(key)
        if e is None:
            e = _Entry(kind, name, dict(labels), factory())
            self._entries[key] = e
            self._kinds[name] = kind
        return e.obj

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, lo: float = 1.0, hi: float = 1e7,
                  growth: float = 1.25, **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(lo=lo, hi=hi, growth=growth))

    # -- introspection ------------------------------------------------
    def entries(self):
        return list(self._entries.values())

    def reset(self) -> None:
        self._entries.clear()
        self._kinds.clear()
        self.gen += 1

    # -- snapshots ----------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able snapshot of every registered metric."""
        out = {"counters": [], "gauges": [], "histograms": []}
        for e in self._entries.values():
            if e.kind == "counter":
                out["counters"].append(
                    {"name": e.name, "labels": e.labels,
                     "value": e.obj.value})
            elif e.kind == "gauge":
                out["gauges"].append(
                    {"name": e.name, "labels": e.labels,
                     "value": e.obj.value})
            else:
                h = e.obj
                out["histograms"].append(
                    {"name": e.name, "labels": e.labels,
                     "lo": h.lo, "hi": h.hi, "growth": h.growth,
                     "counts": list(h.counts), "sum": h.sum,
                     "min": (None if h.count == 0 else h.min),
                     "max": (None if h.count == 0 else h.max)})
        return out

    @classmethod
    def from_snapshot(cls, snap: dict) -> "MetricsRegistry":
        reg = cls()
        reg.merge_snapshot(snap)
        return reg

    def merge_snapshot(self, snap: dict) -> None:
        """Fold another snapshot in: counters/histograms add, gauges
        take the incoming value.  Associative and commutative for the
        additive kinds — shard order does not matter."""
        for c in snap.get("counters", ()):
            self.counter(c["name"], **c["labels"]).inc(int(c["value"]))
        for g in snap.get("gauges", ()):
            self.gauge(g["name"], **g["labels"]).set(g["value"])
        for hs in snap.get("histograms", ()):
            h = self.histogram(hs["name"], lo=hs["lo"], hi=hs["hi"],
                               growth=hs["growth"], **hs["labels"])
            other = Histogram(lo=hs["lo"], hi=hs["hi"],
                              growth=hs["growth"])
            other.counts = list(hs["counts"])
            other.sum = float(hs["sum"])
            other.min = math.inf if hs["min"] is None else float(hs["min"])
            other.max = -math.inf if hs["max"] is None else float(hs["max"])
            h.merge(other)

    # -- exporters ----------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition (histograms as cumulative
        ``_bucket{le=...}`` series plus ``_sum``/``_count``)."""
        lines = []
        typed = set()
        for e in sorted(self._entries.values(),
                        key=lambda e: (e.name, _label_key(e.labels))):
            if e.name not in typed:
                lines.append(f"# TYPE {e.name} {e.kind}")
                typed.add(e.name)
            if e.kind in ("counter", "gauge"):
                lines.append(f"{e.name}{_promlabels(e.labels)} "
                             f"{e.obj.value}")
            else:
                h = e.obj
                cum = 0
                for b, c in zip(h.bounds, h.counts):
                    cum += c
                    lines.append(
                        f"{e.name}_bucket"
                        f"{_promlabels(e.labels, le=repr(b))} {cum}")
                lines.append(f"{e.name}_bucket"
                             f"{_promlabels(e.labels, le='+Inf')} "
                             f"{h.count}")
                lines.append(f"{e.name}_sum{_promlabels(e.labels)} "
                             f"{h.sum}")
                lines.append(f"{e.name}_count{_promlabels(e.labels)} "
                             f"{h.count}")
        return "\n".join(lines) + "\n"

    def dump_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)


def _promlabels(labels: dict, **extra) -> str:
    items = dict(labels, **extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry (what the serving/core wiring
    writes to unless handed an explicit one)."""
    return REGISTRY
