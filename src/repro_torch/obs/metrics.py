"""NVTrace metrics: a process-local registry of counters, gauges and fixed
log-spaced-bucket histograms (the port's own copy of the parts of
``repro.obs.metrics`` it uses).

The paper's whole argument is an *accounting* one — traversal persists
nothing, so every microsecond and every fence concentrates at the
destination — and this module is the ledger that argument is read from
at runtime.  Three metric kinds, one registry:

* :class:`Counter` — monotone event totals (records parsed, commits,
  migrations completed).
* :class:`Gauge` — a last-written level (per-shard load, imbalance).
* :class:`Histogram` — fixed log-spaced buckets with an explicit
  overflow bucket.  Quantiles are *deterministic and bounded*: for any
  recorded distribution, ``oracle <= quantile(q) <= oracle * growth``
  (the bucket upper edge), so p50/p99 are exact up to the configured
  bucket resolution.

>>> reg = MetricsRegistry()
>>> reg.counter("ops_total", layer="log").inc(3)
>>> reg.counter("ops_total", layer="log").value
3
>>> h = reg.histogram("lat_us", lo=1.0, hi=1000.0, growth=2.0)
>>> for v in [1, 2, 3, 500]:
...     h.record(v)
>>> h.count, h.quantile(0.5), h.quantile(0.99)
(4, 2.0, 512.0)
"""
from __future__ import annotations

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


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry (what the serving/core wiring
    writes to unless handed an explicit one)."""
    return REGISTRY
