"""NVTrace first-call tracking: who paid for that stall?

The port's own copy of ``repro.obs.compile``.  PyTorch runs eagerly, so
nothing is compiled per shape; what stays is the first call on a fresh
``(site, static-key, arg-shapes)`` signature -- in the port, the
capacity-ladder seam of ``core/migrate.py`` (every growth step of the
dedup map runs ``update_parallel`` on a new pool size), which is where a
later CUDA-graph capture would pay its cost.

:class:`CompileTracker` wraps such seams.  Callers that *know why* a
first call is about to happen declare it with ``tracker.reason(...)``
(``"capacity_ladder"``); any first call on a never-seen signature is
timed to the card's completion and recorded as a :class:`CompileEvent`
attributed to the innermost active reason (``"steady"`` when none).
Steady-state calls on warm signatures pay one set lookup.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass


@dataclass
class CompileEvent:
    """One first-call stall on a fresh signature."""
    site: str          # e.g. "migrate.update_parallel"
    key: str           # static config part of the signature
    trigger: str       # "capacity_ladder" | "steady" | ...
    stall_us: float

    def to_dict(self) -> dict:
        return {"site": self.site, "key": self.key,
                "trigger": self.trigger, "stall_us": self.stall_us}


def _leaves(x):
    """Flatten nested tuples, lists and dicts (NamedTuples included)."""
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    if isinstance(x, dict):
        return [leaf for k in sorted(x, key=str) for leaf in _leaves(x[k])]
    return [x]


def _sync_if_cuda(out) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor (a host clock
    around an asynchronous launch would time only the enqueue)."""
    import torch
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in _leaves(out)):
        torch.cuda.synchronize()


def _shape_sig(args, kwargs):
    leaves = _leaves((args, kwargs))
    return tuple((tuple(x.shape), str(x.dtype)) if hasattr(x, "shape")
                 else x if isinstance(x, (int, float, str, bool, type(None)))
                 else type(x).__name__
                 for x in leaves)


class CompileTracker:
    """First-call stall recorder with trigger attribution."""

    def __init__(self, registry=None):
        if registry is None:
            from .metrics import get_registry
            registry = get_registry()
        self.registry = registry
        self.enabled = True
        self.events = []
        self._seen = set()
        self._reasons = []

    # -- attribution --------------------------------------------------
    @property
    def current_reason(self) -> str:
        return self._reasons[-1] if self._reasons else "steady"

    @contextmanager
    def reason(self, trigger: str):
        """Attribute compiles inside the block to ``trigger``."""
        self._reasons.append(trigger)
        try:
            yield
        finally:
            self._reasons.pop()

    # -- recording ----------------------------------------------------
    def first_seen(self, site: str, key) -> bool:
        """True exactly once per (site, key); marks the pair seen."""
        sig = (site, key)
        if sig in self._seen:
            return False
        self._seen.add(sig)
        return True

    def record(self, site: str, key, stall_us: float,
               trigger: str = None) -> None:
        trigger = trigger if trigger is not None else self.current_reason
        ev = CompileEvent(site, str(key), trigger, float(stall_us))
        self.events.append(ev)
        self.registry.counter("compile_events_total",
                              site=site, trigger=trigger).inc()
        self.registry.counter("compile_stall_us_total",
                              site=site, trigger=trigger).inc(
                                  int(stall_us))

    def instrument(self, site: str, key, fn):
        """Wrap a callable: the first call on each fresh
        ``(site, key, arg-shapes)`` signature is timed to a blocking
        result and recorded; warm calls pass straight through."""
        tracker = self

        def wrapped(*args, **kwargs):
            if not tracker.enabled:
                return fn(*args, **kwargs)
            sig = (site, key, _shape_sig(args, kwargs))
            if sig in tracker._seen:
                return fn(*args, **kwargs)
            tracker._seen.add(sig)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync_if_cuda(out)
            tracker.record(site, key,
                           (time.perf_counter() - t0) * 1e6)
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    # -- aggregation --------------------------------------------------
    def stats(self) -> dict:
        """Per-trigger totals: ``{trigger: {events, stall_us}}``."""
        out = {}
        for ev in self.events:
            d = out.setdefault(ev.trigger, {"events": 0, "stall_us": 0.0})
            d["events"] += 1
            d["stall_us"] += ev.stall_us
        return out

    def reset(self) -> None:
        self.events.clear()
        self._seen.clear()


TRACKER = CompileTracker()


def get_tracker() -> CompileTracker:
    """The process-default tracker (what the core seams record to)."""
    return TRACKER
