"""NVTrace windowed telemetry: rolling p50/p99/throughput series.

A run-lifetime histogram answers "what was p99" — useless for *when*
and *why*.  :class:`WindowedHistogram` slices time into fixed epochs of
``window_us`` microseconds and keeps one :class:`repro_torch.obs.metrics.
Histogram` per epoch (plus a lifetime aggregate), so the latency series
can be laid next to the event timeline (`repro_torch.obs.timeline`) and a p99
excursion attributed to the snapshot/rebalance/recompile inside its
window.

Design points, all load-bearing for the tests:

* **Caller-supplied time.** ``record(v, t_us)`` takes the timestamp
  instead of reading a clock, so window membership is a pure function
  of its inputs: epoch ``e`` covers ``[e*window_us, (e+1)*window_us)``
  — a sample at exactly ``k*window_us`` lands in window ``k``.
* **Mergeable fixed-epoch snapshots.** Epochs are absolute (derived
  from ``t_us``, not from arrival order), so snapshots from shard
  subprocesses merge per-epoch by elementwise count addition —
  associative and commutative like the registry's histograms.
* **Bounded.** At most ``max_windows`` epochs are retained (oldest
  dropped first, ``dropped_epochs`` counts them); the lifetime
  aggregate never drops.

>>> w = WindowedHistogram(window_us=100.0, lo=1.0, hi=1e4, growth=2.0)
>>> for t, v in [(0, 5), (99.9, 7), (100, 20), (250, 30)]:
...     w.record(v, t_us=t)
>>> [s["epoch"] for s in w.series()]
[0, 1, 2]
>>> w.epoch_of(100.0)        # boundary sample opens window 1
1
>>> w.lifetime.count, w.merged().count
(4, 4)

Same-layout snapshots merge per epoch:

>>> import json
>>> snap = json.loads(json.dumps(w.snapshot()))
>>> twin = WindowedHistogram.from_snapshot(snap)
>>> twin.merge_snapshot(snap)
>>> [s["count"] for s in twin.series()]
[4, 2, 2]
"""
from __future__ import annotations

import math

from .metrics import Histogram


def _hist_snap(h: Histogram) -> dict:
    return {"counts": list(h.counts), "sum": h.sum,
            "min": (None if h.count == 0 else h.min),
            "max": (None if h.count == 0 else h.max)}


def _hist_merge_snap(h: Histogram, lo, hi, growth, snap: dict) -> None:
    other = Histogram(lo=lo, hi=hi, growth=growth)
    other.counts = list(snap["counts"])
    other.sum = float(snap["sum"])
    other.min = math.inf if snap["min"] is None else float(snap["min"])
    other.max = -math.inf if snap["max"] is None else float(snap["max"])
    h.merge(other)


class WindowedHistogram:
    """Per-epoch histograms over fixed ``window_us`` windows.

    ``lo``/``hi``/``growth`` are the bucket layout shared by every
    window and the lifetime aggregate (see
    `metrics.py:log_bounds`); quantiles inherit the bounded
    ``oracle <= q <= oracle*growth`` guarantee per window.
    """

    def __init__(self, window_us: float = 250_000.0, lo: float = 1.0,
                 hi: float = 1e7, growth: float = 1.25,
                 max_windows: int = 512):
        if window_us <= 0:
            raise ValueError("window_us must be > 0")
        if max_windows < 1:
            raise ValueError("max_windows must be >= 1")
        self.window_us = float(window_us)
        self.lo, self.hi, self.growth = float(lo), float(hi), float(growth)
        self.max_windows = int(max_windows)
        self.epochs = {}                  # int epoch -> Histogram
        self.lifetime = Histogram(lo=lo, hi=hi, growth=growth)
        self.dropped_epochs = 0

    def epoch_of(self, t_us: float) -> int:
        """Window index of timestamp ``t_us``: epoch ``e`` covers
        ``[e*window_us, (e+1)*window_us)``."""
        return int(math.floor(t_us / self.window_us))

    def record(self, v: float, t_us: float) -> None:
        e = self.epoch_of(t_us)
        h = self.epochs.get(e)
        if h is None:
            h = self.epochs[e] = Histogram(lo=self.lo, hi=self.hi,
                                           growth=self.growth)
            if len(self.epochs) > self.max_windows:
                del self.epochs[min(self.epochs)]
                self.dropped_epochs += 1
        h.record(v)
        self.lifetime.record(v)

    # -- views --------------------------------------------------------
    def window(self, epoch: int) -> Histogram | None:
        return self.epochs.get(epoch)

    def merged(self) -> Histogram:
        """Aggregate over *retained* windows (== ``lifetime`` exactly
        when nothing was dropped — the consistency invariant the tests
        pin)."""
        out = Histogram(lo=self.lo, hi=self.hi, growth=self.growth)
        for h in self.epochs.values():
            out.merge(h)
        return out

    def series(self, quantiles=(0.5, 0.99)) -> list:
        """Rolling series, one row per retained epoch in time order:
        ``{epoch, t_start_us, t_end_us, count, ops_s, p<q>_us...}``.
        ``ops_s`` is samples-per-second within the window — the
        throughput series for latency samples recorded once per op."""
        rows = []
        for e in sorted(self.epochs):
            h = self.epochs[e]
            row = {"epoch": e,
                   "t_start_us": e * self.window_us,
                   "t_end_us": (e + 1) * self.window_us,
                   "count": h.count,
                   "ops_s": h.count / (self.window_us / 1e6)}
            for q in quantiles:
                row[f"p{int(q * 100)}_us"] = h.quantile(q)
            rows.append(row)
        return rows

    # -- snapshots ----------------------------------------------------
    def snapshot(self) -> dict:
        return {"window_us": self.window_us, "lo": self.lo,
                "hi": self.hi, "growth": self.growth,
                "max_windows": self.max_windows,
                "dropped_epochs": self.dropped_epochs,
                "epochs": {str(e): _hist_snap(h)
                           for e, h in self.epochs.items()},
                "lifetime": _hist_snap(self.lifetime)}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "WindowedHistogram":
        w = cls(window_us=snap["window_us"], lo=snap["lo"],
                hi=snap["hi"], growth=snap["growth"],
                max_windows=snap["max_windows"])
        w.merge_snapshot(snap)
        return w

    def merge_snapshot(self, snap: dict) -> None:
        """Fold another snapshot in, per absolute epoch.  Layouts and
        ``window_us`` must match; epochs add elementwise, so merging is
        associative and commutative — shard order does not matter."""
        if (snap["window_us"] != self.window_us
                or snap["lo"] != self.lo or snap["hi"] != self.hi
                or snap["growth"] != self.growth):
            raise ValueError("cannot merge windowed histograms with "
                             "different window/bucket layouts")
        for es, hs in snap["epochs"].items():
            e = int(es)
            h = self.epochs.get(e)
            if h is None:
                h = self.epochs[e] = Histogram(
                    lo=self.lo, hi=self.hi, growth=self.growth)
            _hist_merge_snap(h, self.lo, self.hi, self.growth, hs)
        _hist_merge_snap(self.lifetime, self.lo, self.hi, self.growth,
                         snap["lifetime"])
        self.dropped_epochs += int(snap.get("dropped_epochs", 0))
        while len(self.epochs) > self.max_windows:
            del self.epochs[min(self.epochs)]
            self.dropped_epochs += 1


class WindowedCounter:
    """Per-epoch event counts over the same fixed-window scheme.

    For throughput of events that are *not* latency samples (rids
    committed, records parsed): ``inc(n, t_us)`` then ``series()`` of
    ``{epoch, count, per_s}``.

    >>> c = WindowedCounter(window_us=1000.0)
    >>> c.inc(3, t_us=0); c.inc(2, t_us=999.9); c.inc(5, t_us=1000.0)
    >>> [(s["epoch"], s["count"]) for s in c.series()]
    [(0, 5), (1, 5)]
    >>> c.total
    10
    """

    def __init__(self, window_us: float = 250_000.0,
                 max_windows: int = 512):
        if window_us <= 0:
            raise ValueError("window_us must be > 0")
        self.window_us = float(window_us)
        self.max_windows = int(max_windows)
        self.epochs = {}              # int epoch -> int count
        self.total = 0
        self.dropped_epochs = 0

    def epoch_of(self, t_us: float) -> int:
        return int(math.floor(t_us / self.window_us))

    def inc(self, n: int, t_us: float) -> None:
        if n < 0:
            raise ValueError("windowed counters are monotone")
        e = self.epoch_of(t_us)
        if e not in self.epochs and len(self.epochs) >= self.max_windows:
            del self.epochs[min(self.epochs)]
            self.dropped_epochs += 1
        self.epochs[e] = self.epochs.get(e, 0) + n
        self.total += n

    def series(self) -> list:
        return [{"epoch": e,
                 "t_start_us": e * self.window_us,
                 "t_end_us": (e + 1) * self.window_us,
                 "count": c,
                 "per_s": c / (self.window_us / 1e6)}
                for e, c in sorted(self.epochs.items())]

    def snapshot(self) -> dict:
        return {"window_us": self.window_us,
                "max_windows": self.max_windows,
                "dropped_epochs": self.dropped_epochs,
                "epochs": {str(e): c for e, c in self.epochs.items()},
                "total": self.total}

    def merge_snapshot(self, snap: dict) -> None:
        if snap["window_us"] != self.window_us:
            raise ValueError("cannot merge windowed counters with "
                             "different window_us")
        for es, c in snap["epochs"].items():
            self.epochs[int(es)] = self.epochs.get(int(es), 0) + int(c)
        self.total += int(snap["total"])
        self.dropped_epochs += int(snap.get("dropped_epochs", 0))
        while len(self.epochs) > self.max_windows:
            del self.epochs[min(self.epochs)]
            self.dropped_epochs += 1
