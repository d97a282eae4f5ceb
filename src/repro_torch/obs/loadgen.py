"""LoadScope: deterministic open/closed-loop load against the serving
stack, with windowed telemetry, an event timeline and a flight recorder
(the port of ``repro.obs.loadgen``: the schedules are the reference's bit
for bit, the executor drives the port's log and engine on the card).

A serving tier is judged under *sustained* load — p50/p99 over time,
not one lifetime aggregate — and the paper's own evaluation is exactly
that shape (throughput under concurrent load, §6).  This module
generates that load:

* **Deterministic schedules.** :func:`make_schedule` turns a
  :class:`LoadSpec` into plain numpy arrays — op kind (read/update),
  key-popularity rank (zipf or uniform), open-loop arrival offsets —
  seeded and free of wall-clock randomness: same spec ⇒ bit-identical
  schedule (``Schedule.fingerprint``).  Only the *execution* reads a
  clock.
* **Open vs closed loop.** Closed loop issues the next op the moment
  the previous completes (measures service capacity); open loop paces
  ops by the precomputed arrival times and measures latency from
  *scheduled arrival* to completion, so a stall shows up as queueing
  delay instead of silently back-pressuring the generator.
* **The three LoadScope layers** ride along: latency samples land in a
  :class:`repro_torch.obs.windows.WindowedHistogram` (rolling p50/p99 +
  ops/s), the :class:`repro_torch.obs.timeline.EventTimeline` collects
  snapshot/truncate/compile/crash/recovery annotations on the same
  clock, and a :class:`repro_torch.obs.timeline.FlightRecorder` rings the
  last-N spans + persistence instructions, dumping on SLO breach or
  injected crash (with the per-phase restart breakdown after the
  reload).

Two executors: :class:`LoadHarness` drives a ``RequestLog`` directly
(update = durable batch commit, read = ``took_effect`` probe) and
— via ``engine=`` — a full ``ServeEngine`` (update = model traversal +
commit, read = dedup-hit serve).  The harness's clock is the host's, so
each measured op ends with the card synced: no sample closes while the
op's work is still queued on the device.

>>> import numpy as np
>>> s = make_schedule(LoadSpec(n_ops=4, seed=7, mode="open",
...                            rate_ops_s=1000.0))
>>> t = make_schedule(LoadSpec(n_ops=4, seed=7, mode="open",
...                            rate_ops_s=1000.0))
>>> s.fingerprint() == t.fingerprint()      # same seed, same schedule
True
>>> bool(np.all(np.diff(s.arrival_us) > 0))  # arrivals strictly ordered
True
>>> u = make_schedule(LoadSpec(n_ops=4, seed=8, mode="open",
...                            rate_ops_s=1000.0))
>>> s.fingerprint() == u.fingerprint()
False
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np

from .compile import get_tracker
from .metrics import MetricsRegistry
from .spans import FaultsTee, Tracer
from .timeline import EventTimeline, FlightRecorder, attribute_excursions
from .windows import WindowedCounter, WindowedHistogram


@dataclass(frozen=True)
class LoadSpec:
    """One load run, fully determined (schedule-wise) by its fields.

    ``mode``: ``"closed"`` (issue-on-completion) or ``"open"``
    (seeded-exponential arrivals at ``rate_ops_s``).  ``dist``:
    ``"zipf"`` (popularity rank ~ zipf(``skew``), skew > 1) or
    ``"uniform"`` over the retention window.  Reads probe
    ``took_effect`` on committed rids by popularity rank
    (rank 1 = newest); updates commit a fresh ``batch`` of rids and
    evict past the ``retain`` window.  Every ``snapshot_every``-th
    commit publishes a truncating snapshot *inside* the measured op —
    that is the excursion the timeline must attribute.
    """
    n_ops: int = 200
    seed: int = 0
    mode: str = "closed"
    dist: str = "zipf"
    skew: float = 1.2
    update_frac: float = 0.6
    batch: int = 4
    rate_ops_s: float = 400.0
    window_us: float = 20_000.0
    max_windows: int = 4096
    retain: int = 128
    snapshot_every: Optional[int] = 25
    warmup_ops: int = 8
    payload_len: int = 4
    excursion_factor: float = 2.0
    slo_p99_us: Optional[float] = None
    crash_at_op: Optional[int] = None
    crash_evict: str = "torn"
    shards: Optional[int] = None
    rebalance: bool = False
    capacity: int = 1 << 12
    ring: int = 512


@dataclass
class Schedule:
    """Precomputed per-op decisions; arrays all length ``n_ops``."""
    spec: LoadSpec
    is_update: np.ndarray       # bool: commit batch vs took_effect probe
    rank: np.ndarray            # int >= 1: popularity rank for reads
    arrival_us: np.ndarray      # float: open-loop arrival offsets (0s closed)

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        h.update(json.dumps(asdict(self.spec), sort_keys=True).encode())
        for a in (self.is_update, self.rank, self.arrival_us):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]


def make_schedule(spec: LoadSpec) -> Schedule:
    """Deterministic schedule from the spec alone — no wall clock, no
    global RNG.  Zipf ranks are clipped to the retention window (the
    tail of an unclipped zipf aims past any finite committed set)."""
    if spec.mode not in ("closed", "open"):
        raise ValueError(f"unknown mode {spec.mode!r}")
    if spec.dist not in ("zipf", "uniform"):
        raise ValueError(f"unknown dist {spec.dist!r}")
    rng = np.random.default_rng(spec.seed)
    n = int(spec.n_ops)
    is_update = rng.random(n) < spec.update_frac
    if spec.dist == "zipf":
        if not spec.skew > 1.0:
            raise ValueError("zipf needs skew > 1")
        rank = np.minimum(rng.zipf(spec.skew, n), spec.retain)
    else:
        rank = rng.integers(1, max(2, spec.retain + 1), n)
    if spec.mode == "open":
        if not spec.rate_ops_s > 0:
            raise ValueError("open loop needs rate_ops_s > 0")
        gaps = rng.exponential(1e6 / spec.rate_ops_s, n)
        arrival_us = np.cumsum(gaps)
    else:
        arrival_us = np.zeros(n)
    return Schedule(spec=spec, is_update=is_update,
                    rank=rank.astype(np.int64), arrival_us=arrival_us)


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def _wait_until(now_us, target_us: float) -> None:
    """Sleep-then-spin to the open-loop release point: coarse sleep to
    ~200us short of the target, then spin out the remainder (a bare
    ``time.sleep`` overshoots by the scheduler quantum)."""
    while True:
        dt = target_us - now_us()
        if dt <= 0:
            return
        if dt > 500.0:
            time.sleep((dt - 200.0) / 1e6)


class LoadHarness:
    """Run one :class:`LoadSpec` against a ``RequestLog`` (default) or
    a ``ServeEngine`` and return the LoadScope report.

    ``flight_path`` (optional) is where the flight-recorder dump is
    written when an SLO breach or the injected crash fires; the report
    always carries the dump inline too.  With ``engine=`` a factory
    ``lambda registry, timeline: ServeEngine(...)`` supplies the
    engine; updates serve fresh rids (traversal + commit), reads
    re-serve committed rids (dedup hits).  ``device`` places the log's
    dedup map (``None`` = the card); an engine factory brings its own.
    """

    def __init__(self, root, spec: LoadSpec, flight_path=None,
                 engine=None, device=None):
        self.root = root
        self.spec = spec
        self.flight_path = flight_path
        self.engine_factory = engine
        if engine is None:
            from ..core.batched import resolve_device
            device = resolve_device(device)
        self.device = device

    # -- wiring -------------------------------------------------------
    def _tee_recorder(self, io) -> None:
        # ride the recorder alongside the normal persistence listener
        sinks = [s for s in (io.faults, self.recorder) if s is not None]
        FaultsTee(*sinks).attach(io)

    def _open_log(self):
        from ..serving.engine import RequestLog
        sp = self.spec
        log = RequestLog(self.root, capacity=sp.capacity,
                         shards=sp.shards, rebalance=sp.rebalance,
                         registry=self.registry, tracer=self.tracer,
                         timeline=self.timeline, device=self.device)
        self._tee_recorder(log.io)
        return log

    def _open_engine(self):
        eng = self.engine_factory(registry=self.registry,
                                  timeline=self.timeline)
        self.device = eng.device
        self._tee_recorder(eng.log.io)
        return eng

    # -- the run ------------------------------------------------------
    def run(self) -> dict:
        sp = self.spec
        sched = make_schedule(sp)
        self.registry = MetricsRegistry()
        self.tracer = Tracer(registry=self.registry, ring=sp.ring)
        self.timeline = EventTimeline(epoch_ns=self.tracer.epoch_ns)
        self.recorder = FlightRecorder(capacity=sp.ring,
                                       clock=self.timeline.now_us)
        self.timeline.recorder = self.recorder
        self.tracer.on_span = self.recorder.on_span
        engine_mode = self.engine_factory is not None
        eng = self._open_engine() if engine_mode else None
        log = eng.log if engine_mode else self._open_log()
        tracker = get_tracker()
        n_compile_seen = len(tracker.events)

        rng = np.random.default_rng(sp.seed ^ 0x10ad)
        acked: list = []          # rids committed by this run, in order
        next_rid = 0
        crash_report = None
        breach_dumped = False

        def _payload(r):
            return [int(r) & 0xFF] * sp.payload_len

        def _commit(rids):
            nonlocal eng, log
            if engine_mode:
                prompts = {int(r): self._prompt(rng, r) for r in rids}
                eng.serve(prompts, n_new=2)
            else:
                evict = log.expired_rids(sp.retain)
                log.commit({int(r): _payload(r) for r in rids},
                           evict=evict)
            acked.extend(int(r) for r in rids)

        def _read(rank):
            start = max(0, len(acked) - int(rank) - sp.batch + 1)
            probe = acked[start:start + sp.batch] or [0]
            if engine_mode:
                prompts = {int(r): self._prompt(rng, r) for r in probe}
                eng.serve(prompts, n_new=2)    # dedup hits
            else:
                log.took_effect(probe)

        # warmup (unmeasured): first durable write, first dedup-map
        # jit compile, first probe — so the measured series starts on
        # the steady state and compile stalls during the run are *news*
        for _ in range(max(1, sp.warmup_ops)):
            _commit(range(next_rid, next_rid + sp.batch))
            next_rid += sp.batch
            _read(1)

        win = WindowedHistogram(window_us=sp.window_us, lo=1.0, hi=1e8,
                                growth=1.25, max_windows=sp.max_windows)
        thr = WindowedCounter(window_us=sp.window_us,
                              max_windows=sp.max_windows)
        now_us = self.timeline.now_us
        t_run0 = now_us()
        commits = 0
        last_epoch = None
        for i in range(sp.n_ops):
            if sp.mode == "open":
                target = t_run0 + float(sched.arrival_us[i])
                _wait_until(now_us, target)
                t_issue = target      # latency includes queueing delay
            else:
                t_issue = now_us()
            if sched.is_update[i]:
                _commit(range(next_rid, next_rid + sp.batch))
                next_rid += sp.batch
                commits += 1
                if (not engine_mode and sp.snapshot_every
                        and commits % sp.snapshot_every == 0):
                    log.snapshot()    # timeline: snapshot + truncate
            else:
                _read(sched.rank[i])
            _sync(self.device)        # the op is done when the card is
            t_done = now_us()
            win.record(t_done - t_issue, t_us=t_done)
            thr.inc(sp.batch, t_us=t_done)
            # surface fresh compile stalls as timeline annotations
            while n_compile_seen < len(tracker.events):
                ev = tracker.events[n_compile_seen]
                n_compile_seen += 1
                self.timeline.annotate("compile_stall", t_us=t_done,
                                       trigger=ev.trigger, site=ev.site,
                                       stall_us=ev.stall_us)
            # SLO check once per completed window
            e = win.epoch_of(t_done)
            if (sp.slo_p99_us and last_epoch is not None
                    and e != last_epoch and not breach_dumped):
                h = win.window(last_epoch)
                if h is not None and h.count \
                        and h.quantile(0.99) > sp.slo_p99_us:
                    self.timeline.annotate("slo_breach", t_us=t_done,
                                           epoch=last_epoch,
                                           p99_us=h.quantile(0.99))
                    self.recorder.dump("slo_breach",
                                       path=self.flight_path,
                                       extra={"epoch": last_epoch})
                    breach_dumped = True
            last_epoch = e
            if sp.crash_at_op is not None and i == sp.crash_at_op \
                    and not engine_mode:
                log, crash_report = self._crash_and_recover(log, acked)
        wall_s = max(1e-9, (now_us() - t_run0) / 1e6)

        series = win.series()
        excursions = attribute_excursions(
            series, self.timeline, factor=sp.excursion_factor,
            slack_us=sp.window_us * 0.25)
        report = {
            "spec": asdict(sp),
            "target": "engine" if engine_mode else "log",
            "schedule_fingerprint": sched.fingerprint(),
            "wall_s": wall_s,
            "ops": int(sp.n_ops),
            "rids_processed": int(sp.n_ops) * sp.batch,
            "sustained_ops_s": int(sp.n_ops) * sp.batch / wall_s,
            "p50_us": win.lifetime.quantile(0.5),
            "p99_us": win.lifetime.quantile(0.99),
            "mean_us": (win.lifetime.sum / win.lifetime.count
                        if win.lifetime.count else float("nan")),
            "series": series,
            "throughput": thr.series(),
            "timeline": self.timeline.to_list(),
            "excursions": excursions,
            "n_excursions": len(excursions),
            "n_attributed_excursions": sum(
                1 for x in excursions if x["events"]),
            "flight": {"capacity": self.recorder.capacity,
                       "seen": self.recorder.seen,
                       "dumps": list(self.recorder.dumps)},
            "counters": {
                "commits": self.registry.counter(
                    "serving_commits_total").value,
                "snapshots": self.registry.counter(
                    "serving_snapshots_total").value,
                "records_parsed": self.registry.counter(
                    "serving_records_parsed_total").value,
            },
        }
        if crash_report is not None:
            report["crash"] = crash_report
        return report

    @staticmethod
    def _prompt(rng, rid: int, length: int = 6):
        del rng  # prompts are a pure function of the rid: replayable
        return (np.arange(length, dtype=np.int32) + int(rid)) % 97

    def _crash_and_recover(self, log, acked):
        """Injected crash mid-commit: stage a record, flush it, crash
        with the spec's eviction mode (``"torn"`` leaves a partial
        payload on disk), dump the flight ring, reopen, and verify no
        acked op was lost.  Returns (new log, crash report)."""
        sp = self.spec
        # stage-but-never-fence one record so the adversary has a
        # victim; its rids are *not* acked (commit never returned)
        victim = log._claim_slot()
        log.io.write(victim, json.dumps(
            {str(1 << 40): [0] * sp.payload_len}).encode())
        log.io.flush(victim)
        self.timeline.annotate("crash", evict=sp.crash_evict)
        log.io.crash(evict=sp.crash_evict)
        t0 = self.timeline.now_us()
        self.timeline.annotate("recovery_begin")
        log = self._open_log()       # fresh instance, same obs wiring
        t1 = self.timeline.now_us()
        self.timeline.annotate("recovery_end",
                               total_us=log.restart_timing["total_us"])
        probe = acked[-min(len(acked), 4 * sp.batch):]
        no_acked_lost = bool(np.all(log.took_effect(probe))) \
            if probe else True
        dump = self.recorder.dump(
            "injected_crash", path=self.flight_path,
            restart_timing=log.restart_timing,
            extra={"no_acked_lost": no_acked_lost,
                   "recovery_wall_us": t1 - t0})
        return log, {
            "evict": sp.crash_evict,
            "no_acked_lost": no_acked_lost,
            "restart_timing": dict(log.restart_timing),
            "recovery_wall_us": t1 - t0,
            "flight_dump": {k: dump[k] for k in
                            ("reason", "n_entries", "seen", "dropped",
                             "no_acked_lost", "restart_timing")},
        }
