"""Durable request log with exactly-once dedup, and the batched serving
engine on top of it (port of ``repro.serving.engine.RequestLog`` and
``ServeEngine``).

A finished request's result is the **destination**: it is committed to the
durable request log with flush(record) -> fence -> publish, and only then
acknowledged.  The committed-rid set is mirrored into a
:class:`repro_torch.persistence.index.MembershipIndex` on the card, so the
exactly-once check is a batched, persistence-free lookup.  After a crash,
recovery reads the newest snapshot plus the committed record suffix.  The
on-disk records and snapshots are byte-compatible with the JAX package's,
so a log directory written by either reopens in the other.

:class:`ServeEngine` serves batches of prompts greedily through a model's
prefill and decode steps and commits each batch's results to the log.
The dedup set lives on the hash map, on the bucket-range-sharded map
(``shards``, optionally re-split under live traffic with ``rebalance``)
or, with ``ordered_dedup``, on the ordered map.
"""
from __future__ import annotations

import json
import os
import random
import time
import weakref
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.batched import resolve_device
from ..models.model import prefix_tokens
from ..obs.metrics import get_registry
from ..obs.spans import PersistListener, Tracer, profiled
from ..persistence.index import MembershipIndex, OrderedMembershipIndex
from ..persistence.manifest import StagedIO


class RequestLog:
    """Durable request log + a durable-map dedup index on the card.

    The committed-rid set is mirrored into a durable-map
    :class:`~repro_torch.persistence.index.MembershipIndex` (updated by one
    *mixed* plan/commit round per commit: new rids insert, expired rids
    delete, in a single batch), so the exactly-once check is a batched,
    persistence-free lookup — the journey — instead of a Python dict
    probe per request.

    Restart is O(retention window), not O(log length): the caches and
    the dedup map are seeded from the newest published
    :meth:`snapshot` and only the post-snapshot record suffix is
    replayed; :meth:`took_effect`/:meth:`descriptor` then answer a
    recovering client's "did my op land?" from the map, with zero
    record parsing."""

    # upper bound on the filesystem timestamp granule (1-10 ms coarse
    # clock on modern Linux, but a full second on ext3/HFS+/some network
    # mounts; leave headroom): an mtime younger than this never
    # authorizes the refresh() fast path
    _RACY_NS = 2_000_000_000

    # base grace interval granted to a concurrent committer before a torn
    # placeholder seen at restart is trimmed; attempt k waits
    # base * 2**k (capped at _TRIM_BACKOFF_MAX_S, jittered) so retries
    # never run in lockstep with the writer they are yielding to
    _TRIM_BACKOFF_S = 0.01
    _TRIM_BACKOFF_MAX_S = 0.08
    _TRIM_RETRIES = 4

    def __init__(self, root, seed: int = 0, capacity: int = 1 << 15,
                 shards: Optional[int] = None, rebalance: bool = False,
                 ordered_dedup: bool = False, registry=None,
                 tracer: Optional[Tracer] = None, timeline=None,
                 obs: bool = True, device=None):
        """``capacity`` is only the *seed* pool size of the dedup map: under
        live traffic it grows itself (:attr:`dedup_migrations` counts the
        growth events).  ``device`` places the dedup map (``None`` = the
        card).  ``shards`` backs the dedup index with the
        bucket-range-sharded map
        (:class:`~repro_torch.core.sharded.ShardedDurableMap`) over that
        many shards, with the same exactly-once semantics; ``rebalance``
        (sharded only) additionally lets skewed rid streams re-split the
        shard boundaries under live traffic
        (:class:`~repro_torch.core.rebalance.RebalancingShardedMap`;
        :attr:`dedup_rebalances` counts completions).

        ``ordered_dedup`` keeps the committed rids on the ordered map
        (:class:`~repro_torch.persistence.index.OrderedMembershipIndex`)
        instead of the hash map, and :meth:`expired_rids` becomes an
        ordered-by-rid horizon trim: the same rids for the monotone rid
        streams the engine hands out.  It excludes ``shards`` (the ordered
        pool is not sharded).

        ``registry``/``tracer`` plug the log into an explicit NVTrace
        metrics registry and span tracer (default: the process-wide
        registry and a tracer on it); the tracer records one span per
        commit/snapshot phase, charged with the persistence instructions
        it executed (a :class:`PersistListener` on ``io``).  ``timeline``
        (an :class:`~repro_torch.obs.timeline.EventTimeline`) additionally
        gets snapshot/truncate, dedup-migration/rebalance and open
        annotations, so a latency excursion in a windowed series is
        attributable to its cause; ``obs=False`` disables the span tracer
        and the persistence-event listener (the zero-instrumentation
        baseline)."""
        if ordered_dedup and shards is not None:
            raise ValueError("ordered_dedup is not sharded (no shards)")
        self.io = StagedIO(Path(root), seed=seed)
        self.metrics = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else Tracer(
            registry=self.metrics, enabled=obs)
        if obs and self.io.faults is None:
            # persistence-instruction counts per span ride the same
            # `faults` hook surface CrashPlan uses; a crash plan attached
            # later simply replaces the listener for that run
            PersistListener(tracer=self.tracer,
                            registry=self.metrics).attach(self.io)
        self._rng = random.Random(0x5eed ^ seed)
        self._ordered = bool(ordered_dedup)
        if ordered_dedup:
            self._dedup = OrderedMembershipIndex(capacity, device=device)
        else:
            self._dedup = MembershipIndex(capacity, n_buckets=256,
                                          n_shards=shards,
                                          auto_rebalance=rebalance,
                                          device=device)
        self._folded: set = set()  # log filenames already in the index
        self._torn: dict = {}      # torn filename -> (size, mtime_ns) seen
        self._results: Dict[int, list] = {}   # rid -> committed result
        self._n = 0                # next log index: 1 + highest seen
        self._dir_mtime: Optional[int] = None  # log dir mtime at last scan
        self._snap_horizon = 0     # records below this index are covered
                                   # by the loaded snapshot
        self._snap_name: Optional[str] = None  # newest published snapshot
        self._stale: set = set()   # snapshot-covered leftovers (a crash
                                   # mid-truncation): trimmed at restart
        self.records_parsed = 0    # log records read+parsed by this
                                   # instance (restart-replay observability)
        self.timeline = timeline
        t0 = time.perf_counter_ns()
        self._load_snapshot()
        t1 = time.perf_counter_ns()
        self.refresh()
        t2 = time.perf_counter_ns()
        # recovery: a restart is *usually* quiescent, but the torn
        # placeholder may be another live instance's in-flight commit —
        # grant the writer a bounded, jittered exponential backoff to
        # land the payload instead of failing the restart.  Torn files
        # that appear *later* are always left alone (they heal via the
        # refresh() signature check).
        for name in list(self._torn):
            self._trim_torn(name)
        # finish any truncation a crash interrupted: records (and older
        # snapshots) the loaded snapshot supersedes
        for name in sorted(self._stale):
            self._unlink_quiet(name)
        self._stale.clear()
        t3 = time.perf_counter_ns()
        # per-phase restart breakdown, so recovery cost is explainable,
        # not just a total (the flight recorder dumps it on a post-crash
        # reload; chip_smoke.py's serve phase prints it)
        self.restart_timing = {
            "load_snapshot_us": (t1 - t0) / 1e3,
            "replay_us": (t2 - t1) / 1e3,
            "trim_us": (t3 - t2) / 1e3,
            "total_us": (t3 - t0) / 1e3,
            "records_parsed": self.records_parsed,
            "snapshot_loaded": self._snap_name is not None,
        }
        for ph in ("load_snapshot", "replay", "trim"):
            self.metrics.histogram(
                "restart_phase_us", lo=1.0, hi=1e8, growth=1.25,
                phase=ph).record(self.restart_timing[ph + "_us"])
        if timeline is not None:
            timeline.annotate("log_open",
                              total_us=self.restart_timing["total_us"],
                              records_parsed=self.records_parsed)

    @staticmethod
    def _log_index(name: str) -> Optional[int]:
        try:
            return int(name[len("log_"):-len(".json")])
        except ValueError:
            return None

    def _load_snapshot(self) -> None:
        """Restart fast path: seed the caches *and* the durable-map dedup
        index from the newest published snapshot — one JSON read plus one
        batched map round — so the scan that follows replays only the
        post-snapshot record suffix.  Restart cost is O(window), not
        O(log length).  A torn/alien snapshot file falls back to the
        next-newest one (the publish rename makes each snapshot
        all-or-nothing, so this only triggers on outside interference)."""
        try:
            with os.scandir(self.io.root) as it:
                snaps = sorted(e.name for e in it
                               if e.name.startswith("snap_")
                               and e.name.endswith(".json"))
        except FileNotFoundError:
            return
        for name in reversed(snaps):
            try:
                data = json.loads((Path(self.io.root) / name).read_text())
                horizon = int(data["horizon"])
                rec = {int(k): list(v) for k, v in data["results"].items()}
            except (OSError, json.JSONDecodeError, KeyError, TypeError,
                    ValueError):
                continue
            self._results.update(rec)
            self._dedup.update(rec, ())
            self._snap_horizon = horizon
            self._snap_name = name
            self._n = max(self._n, horizon)
            break
        # superseded older snapshots ride the restart trim
        self._stale.update(n for n in snaps if n != self._snap_name)

    def _backoff(self, attempt: int) -> None:
        """Bounded exponential backoff with jitter: attempt *k* sleeps
        ``base * 2**k`` capped at ``_TRIM_BACKOFF_MAX_S``, scaled by a
        uniform [0.5, 1.0) jitter so concurrent restarting instances
        (and the writer being yielded to) never phase-lock."""
        span = min(self._TRIM_BACKOFF_S * (1 << attempt),
                   self._TRIM_BACKOFF_MAX_S)
        time.sleep(span * (0.5 + self._rng.random() / 2))

    def _trim_torn(self, name: str) -> None:
        """Trim one torn record seen at restart, tolerating a concurrent
        creation race.  Each of the ``_TRIM_RETRIES`` attempts grants a
        growing, jittered grace interval (:meth:`_backoff`), re-checks
        whether the writer finished (a mid-commit record *heals* instead
        of being trimmed), then tries the unlink.  Exhausting the budget
        leaves the file in the torn set — it heals or trims later —
        never failing the restart itself.  Retries and heals are
        counted on the registry (``serving_trim_retries_total`` /
        ``serving_trim_heals_total``)."""
        for attempt in range(self._TRIM_RETRIES):
            self._backoff(attempt)
            self._try_fold(name)
            if name not in self._torn:
                self.metrics.counter("serving_trim_heals_total").inc()
                return              # healed: the writer finished
            try:
                self.io.unlink(name)
            except OSError:
                self.metrics.counter("serving_trim_retries_total").inc()
                continue            # grace grows; writer may still land
            del self._torn[name]
            self.metrics.counter("serving_trims_total").inc()
            return

    def _unlink_quiet(self, name: str) -> None:
        """Best-effort trim of one superseded file; a failure just leaves
        the file for the next truncation pass to retry."""
        try:
            self.io.unlink(name)
        except OSError:
            pass
        self._folded.discard(name)

    def refresh(self) -> None:
        """Fold commits made by other RequestLog instances on the same log
        dir into the dedup index.  Incremental twice over: the directory
        scan is skipped entirely while the log dir's mtime is unchanged
        since the last scan (record files are only ever *created*, so new
        commits always bump it) and no torn record is pending a re-check
        — a refresh with nothing new is a single ``stat``, keeping
        ``serve()`` O(new records) instead of O(total historical
        records).  When the scan does run, only log records not yet
        folded (and not known torn) are parsed."""
        now = self._fs_now()     # BEFORE the stat/scan: see guard below
        if now is None:          # log dir itself is gone
            return
        try:
            dir_mtime = os.stat(self.io.root).st_mtime_ns
        except FileNotFoundError:
            return
        if dir_mtime == self._dir_mtime:
            # nothing was created/renamed/removed; known torn records can
            # still *heal* (their content changes without touching the
            # dir mtime), so re-stat just those — O(torn), usually zero
            self._check_torn()
            return
        self._scan()
        # The racy-timestamp guard (à la git's index): directory mtimes
        # come from the filesystem's coarse clock, so a record created in
        # the same clock granule as ``dir_mtime`` — even *after* this
        # scan's directory listing — leaves the mtime unchanged.  Cache
        # the mtime (enabling the fast path above) only if its granule
        # had already closed before this scan started (``now`` is taken
        # before the stat, which precedes the listing); otherwise leave
        # the cache invalid so the next refresh rescans.  ``now`` is read
        # from the *filesystem's* clock (a sentinel-file utime), not the
        # local one — on network mounts the two can disagree by more than
        # the granule.
        self._dir_mtime = (dir_mtime
                           if now - dir_mtime > self._RACY_NS else None)

    def _fs_now(self) -> Optional[int]:
        """The log-dir filesystem's current time: utime a sentinel file
        and read its mtime back.  Updating an *existing* file never
        touches the parent directory's mtime, so the probe is invisible
        to the fast-path check (only its one-time creation bumps it).
        Returns None when the log dir itself has been removed."""
        clock = Path(self.io.root) / ".clock"
        try:
            os.utime(clock)
        except FileNotFoundError:
            try:
                # the sentinel is a clock probe, not durable data: its
                # one-time creation must not register as a crash site
                # persistlint: waive(raw-durable-io) — mtime-clock sentinel
                clock.touch()
            except FileNotFoundError:
                return None
        return os.stat(clock).st_mtime_ns

    def _scan(self) -> None:
        """One pass over the log dir, O(directory entries): already-folded
        names are dropped before the (slot-order) sort and never stat'd
        or re-parsed, so only *new* records cost anything."""
        try:
            with os.scandir(self.io.root) as it:
                fresh = [e.name for e in it
                         if e.name.startswith("log_")
                         and e.name.endswith(".json")
                         and e.name not in self._folded]
        except FileNotFoundError:
            return
        for name in sorted(fresh):       # slot order = linearization order
            self._try_fold(name)

    def _check_torn(self) -> None:
        """Re-stat only the known-torn records; a stable signature costs
        one stat, a changed one re-parses (heals)."""
        for name in sorted(self._torn):
            self._try_fold(name)

    def _try_fold(self, name: str) -> None:
        """Stat/parse one log record and fold it into the caches if it is
        whole.  A torn record is skipped while its on-disk (size, mtime)
        signature is unchanged, but re-parsed once it changes — a record
        caught mid-write by a slow concurrent committer heals instead of
        being poisoned forever.  ``_n`` advances past every seen log
        index — torn records included — so a commit never reuses the
        slot of a record that is already on disk."""
        idx = self._log_index(name)
        if idx is not None and idx < self._snap_horizon:
            # covered by the loaded snapshot: content already folded.
            # The file is an interrupted-truncation leftover — queue it
            # for the restart trim and never re-scan it.
            self._stale.add(name)
            self._folded.add(name)
            self._torn.pop(name, None)
            return
        p = Path(self.io.root) / name
        try:
            st = p.stat()
        except FileNotFoundError:
            return
        sig = (st.st_size, st.st_mtime_ns)
        if self._torn.get(name) == sig:
            return      # unchanged since the failed parse: still torn
        if idx is not None:
            self._n = max(self._n, idx + 1)
        self.records_parsed += 1   # per-instance shim; registry mirror:
        self.metrics.counter("serving_records_parsed_total").inc()
        try:
            rec, evict = self._parse_record(p.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError):
            # torn log record — truncated payloads fail to parse,
            # garbled ones may not even decode as UTF-8; both are the
            # same torn-record state, trimmed by recovery semantics
            self._torn[name] = sig
            return
        self._torn.pop(name, None)
        self._folded.add(name)
        self._apply_record(rec, evict)

    @staticmethod
    def _parse_record(text: str):
        """Decode one log record.  Plain records are a rid -> result dict
        (the pre-eviction format, still written when nothing is evicted);
        records carrying evictions are ``{"results": …, "evict": [rids]}``
        — distinguishable because plain records only have integer keys."""
        data = json.loads(text)
        if "results" in data and set(data) <= {"results", "evict"}:
            return ({int(k): v for k, v in data["results"].items()},
                    [int(r) for r in data.get("evict", [])])
        return {int(k): v for k, v in data.items()}, []

    def _apply_record(self, rec: Dict[int, list], evict: Sequence[int]):
        """Fold one record into the caches and the dedup map: new rids in,
        evicted rids out — one mixed plan/commit round on the durable
        map (record order is the linearization order)."""
        self._results.update(rec)
        for r in evict:
            self._results.pop(r, None)
        self._dedup.update(rec, evict)

    @property
    def dedup_migrations(self) -> int:
        """Online growth migrations the dedup map has run (observability
        for the serving path: growth is supposed to be rare and
        amortized — a hot counter here means the seed capacity or the
        eviction ``retain`` window is mis-sized)."""
        return self._dedup.migrations

    @property
    def dedup_rebalances(self) -> int:
        """Live cross-shard re-splits the dedup map has completed (only
        nonzero when the log was opened with ``rebalance=True``)."""
        return self._dedup.rebalances

    def is_committed(self, rids: Sequence[int]) -> np.ndarray:
        """Batched exactly-once probe over the dedup map (bool[len(rids)]).
        Arbitrary-int rids are fine: the index stores int32-representable
        rids in the durable map and falls back to a Python-set probe for
        the rare out-of-range one (the old dict-based dedup accepted
        arbitrary ints)."""
        return self._dedup.contains([int(r) for r in rids])

    def _claim_slot(self) -> str:
        """Atomically reserve the next free log slot (O_CREAT|O_EXCL), so
        genuinely concurrent instances can never claim the same filename.
        The zero-byte placeholder is a torn record until the fence lands
        the payload; a crash in between leaves it torn, which recovery
        semantics already skip (and ``_n`` derivation steps over)."""
        while True:
            rel = f"log_{self._n:06d}.json"
            self._n += 1
            try:
                # atomic claim needs O_CREAT|O_EXCL, which StagedIO's
                # staged write cannot express; the zero-byte placeholder
                # is torn-by-construction until the staged commit lands
                # persistlint: waive(raw-durable-io) — O_EXCL slot claim
                fd = os.open(Path(self.io.root) / rel,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue     # slot taken by another instance: skip it
            os.close(fd)
            return rel

    def commit(self, results: Dict[int, list],
               evict: Sequence[int] = ()) -> None:
        """Commit a batch of finished requests and, in the *same* record
        and the same mixed plan/commit round on the dedup map, evict
        expired rids (one fence for the whole batch — the batched-map
        fence elision of the plan/commit engine) into an atomically claimed
        slot, so a concurrent RequestLog instance's commit is never
        overwritten.  An evicted rid leaves the exactly-once window: its
        result is dropped from the committed cache and a later request
        with that rid is served afresh."""
        with self.tracer.span("commit", n_results=len(results),
                              n_evict=len(evict)):
            rel = self._claim_slot()
            rec = {int(k): list(v) for k, v in results.items()}
            evict = sorted({int(r) for r in evict})
            if evict:
                payload = json.dumps({"results": rec, "evict": evict})
            else:
                payload = json.dumps(rec)   # legacy-compatible record
            self.io.write(rel, payload.encode())
            with self.tracer.span("flush_fence"):
                self.io.flush(rel)
                self.io.fence()
            self._folded.add(rel)
            m0, r0 = self._dedup.migrations, self._dedup.rebalances
            self._apply_record(rec, evict)
            if self.timeline is not None:
                # annotate live-traffic dedup growth/re-splits only (a
                # restart replay folds records through _apply_record
                # directly and stays silent)
                if self._dedup.migrations > m0:
                    self.timeline.annotate(
                        "dedup_migration",
                        rounds=self._dedup.migrations - m0)
                if self._dedup.rebalances > r0:
                    self.timeline.annotate(
                        "dedup_rebalance",
                        rounds=self._dedup.rebalances - r0)
        self.metrics.counter("serving_commits_total").inc()
        self.metrics.counter("serving_committed_rids_total").inc(len(rec))
        self.metrics.counter("serving_evicted_rids_total").inc(len(evict))

    def expired_rids(self, retain: int) -> List[int]:
        """Rids past the newest ``retain`` committed ones, in commit
        order (restart replays records in slot order, so the retention
        horizon survives recovery).  With ``ordered_dedup`` the window is
        ordered by rid instead, answered by the ordered map
        (:meth:`~repro_torch.persistence.index.OrderedMembershipIndex.
        expired`)."""
        if self._ordered:
            return [int(r) for r in self._dedup.expired(max(retain, 0))]
        done = list(self._results)
        if retain <= 0:
            return done
        return done[:-retain] if len(done) > retain else []

    def committed(self) -> Dict[int, list]:
        """All committed results, incrementally maintained: refresh()
        parses each durable log record exactly once and retains its
        rid -> result payload, so this is O(new records), not a full
        re-parse of the log per call.  Values are copied out so caller
        mutation cannot diverge the cache from the durable records."""
        self.refresh()
        return {k: list(v) for k, v in self._results.items()}

    # ---------------- detectable recovery ------------------------------ #
    def snapshot(self, truncate: bool = True) -> Optional[str]:
        """Publish a durable restart snapshot: the committed-results
        window plus its log horizon, written with the same flush → fence
        → atomic-publish discipline as a log record.  With ``truncate``
        (default) the records it covers — and the previous snapshot —
        are then unlinked, so a restart replays only the post-snapshot
        suffix: O(retention window), independent of log length.  The
        horizon never covers a torn record (it may still heal into a
        commit), and a crash anywhere in here is safe: before the
        publish the old snapshot still rules; after it, leftover covered
        records are re-trimmed by the next restart.  Snapshots are meant
        to be taken by the log's owning serving instance; other
        instances keep folding records as usual and adopt the snapshot
        on their own restart.  Returns the published snapshot filename,
        or None if nothing new is covered."""
        self.refresh()
        horizon = self._n
        for name in self._torn:
            idx = self._log_index(name)
            if idx is not None:
                horizon = min(horizon, idx)
        if horizon <= self._snap_horizon:
            return None
        with self.tracer.span("snapshot", horizon=horizon):
            payload = json.dumps(
                {"format": 1, "horizon": horizon,
                 "results": {str(k): list(v)
                             for k, v in self._results.items()}})
            final = f"snap_{horizon:08d}.json"
            self.io.write("snap.tmp", payload.encode())
            with self.tracer.span("flush_fence"):
                self.io.flush("snap.tmp")
                self.io.fence()
            with self.tracer.span("publish"):
                self.io.publish("snap.tmp", final)
            old_snap, self._snap_name = self._snap_name, final
            self._snap_horizon = horizon
            if self.timeline is not None:
                self.timeline.annotate("snapshot", horizon=horizon,
                                       n_results=len(self._results))
            if truncate:
                n_trimmed = self._truncate(horizon, old_snap)
                if self.timeline is not None:
                    self.timeline.annotate("truncate", horizon=horizon,
                                           n_trimmed=n_trimmed)
        self.metrics.counter("serving_snapshots_total").inc()
        return final

    def _truncate(self, horizon: int, old_snap: Optional[str]) -> int:
        """Unlink everything the just-published snapshot supersedes.
        Crash-safe by construction: every leftover is either below the
        published horizon (restart re-collects and trims it) or an older
        snapshot shadowed by the newer one.  Returns the number of
        files trimmed (timeline observability)."""
        n = 0
        for name in sorted(self._folded):
            idx = self._log_index(name)
            if idx is not None and idx < horizon:
                self._unlink_quiet(name)
                n += 1
        for name in sorted(self._stale):
            self._unlink_quiet(name)
            n += 1
        self._stale.clear()
        if old_snap is not None:
            self._unlink_quiet(old_snap)
            n += 1
        return n

    def took_effect(self, rids: Sequence[int]) -> np.ndarray:
        """Per-op detectable recovery ("Tracking in Order to Recover"):
        did each rid's operation take effect?  Answered from the durable
        dedup map in one batched lookup — no log replay, even
        immediately after a restart (the snapshot seeds the map with the
        whole window).  A rid evicted past the retention window answers
        False: its descriptor left the exactly-once window together with
        its result."""
        return self.is_committed(rids)

    def descriptor(self, rid: int) -> dict:
        """One rid's operation descriptor: whether it took effect and,
        if so, its committed result — what a recovering client reads
        instead of re-submitting blind."""
        took = bool(self.is_committed([rid])[0])
        res = self._results.get(int(rid))
        return {"rid": int(rid), "took_effect": took,
                "result": list(res) if took and res is not None else None}


def _stack_batch(prompts: List[np.ndarray]) -> np.ndarray:
    """Stack one equal-length batch of 1-D prompt token arrays.  The
    length uniformity is checked, not papered over: a shorter row
    right-padded into a longer batch would attend over the pad tokens
    and its generation would change with batch composition -- serve()
    groups requests by prompt length precisely so this never happens."""
    S = int(prompts[0].shape[0])
    if not all(int(p.shape[0]) == S for p in prompts):
        raise ValueError("serve() must batch equal-length prompts")
    return np.stack(prompts).astype(np.int32)


def stub_inputs(cfg, batch: int, device) -> dict:
    """The frontend stubs' inputs a prompt batch needs, zero in f32 as in
    the reference: a VLM's ``vis`` [B, vis_tokens, D], an
    encoder-decoder's ``frames`` [B, enc_seq, D]; none for the other
    families."""
    if cfg.family == "vlm":
        return {"vis": torch.zeros((batch, cfg.vis_tokens, cfg.d_model),
                                   device=device)}
    if cfg.family == "encdec":
        return {"frames": torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                      device=device)}
    return {}


class ServeEngine:
    def __init__(self, model, params, *, max_len: int, log_dir,
                 batch_size: int = 4, retain: Optional[int] = None,
                 log_shards: Optional[int] = None,
                 log_rebalance: bool = False,
                 ordered_dedup: bool = False,
                 snapshot_every: Optional[int] = None,
                 registry=None, timeline=None, obs: bool = True,
                 device=None):
        """``retain`` bounds the exactly-once window: when set, each
        commit also evicts all but the newest ``retain`` committed rids
        from the durable dedup index (one mixed insert/delete round).
        ``snapshot_every`` publishes a truncating
        :meth:`RequestLog.snapshot` after that many commits, keeping a
        restart O(retention window).  ``device`` (``None`` = the card)
        holds the model's parameters and the log's dedup map.
        ``ordered_dedup`` keeps the dedup set on the ordered map, so
        retention eviction is an ordered-by-rid horizon trim (see
        :class:`RequestLog`).  ``log_shards`` backs the log's dedup map
        with the bucket-range-sharded map over that many shards, and
        ``log_rebalance`` lets it re-split its shard boundaries under
        live traffic.  ``registry``/``timeline``/``obs`` select the
        NVTrace metrics registry, the event timeline for
        snapshot/truncate/growth annotations, and toggle span/listener
        instrumentation (see :class:`RequestLog`); with ``obs`` the
        tracer also spans each batch's ``prefill`` and ``decode`` inside
        ``plan`` and watches the garbage collector.  Under a profiler
        each decode step is the range ``nvt.decode_step``.

        Each request's arrival is :meth:`serve`'s entry.  Per request,
        the ``serve_request_us`` histogram gets its latency either way:
        arrival to its batch's commit fenced, or for a dedup hit to the
        route's end.  :attr:`request_times` keeps, per fresh request, its
        ``wait_s`` (arrival to its batch's prefill start) and
        ``latency_s`` (arrival to the commit fenced).
        :attr:`step_times` keeps each batch's prefill and decode-step
        seconds: on the card each step's span on the device's timeline, a
        pair of CUDA events on the current stream read once the batch's
        tokens are copied back (no device sync of its own); on the CPU
        the host clock."""
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"not on {self.device}")
        self.model = model
        self.params = params
        self.max_len = max_len
        self.batch = batch_size
        self.retain = retain
        self.snapshot_every = snapshot_every
        self._commits_since_snap = 0
        self.log = RequestLog(log_dir, shards=log_shards,
                              rebalance=log_rebalance,
                              ordered_dedup=ordered_dedup,
                              registry=registry, timeline=timeline,
                              obs=obs, device=self.device)
        self.metrics = self.log.metrics
        self.tracer = self.log.tracer
        self.timeline = self.log.timeline
        self.step_times: Dict[str, List[float]] = {"prefill_s": [],
                                                   "decode_step_s": []}
        self.request_times: Dict[str, List[float]] = {"wait_s": [],
                                                      "latency_s": []}
        self._pending: list = []     # (key, start event, end event)
        if obs:
            # the collector is watched while this engine lives
            weakref.finalize(self, self.tracer.watch_gc().unwatch_gc)

    def _timed(self, key: str, fn):
        """Run ``fn`` and time it into ``step_times[key]``: on the card
        by CUDA events around it on the current stream, read by
        :meth:`_read_times` once the device is past them; on the CPU by
        the host clock."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            self.step_times[key].append(time.perf_counter() - t0)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        self._pending.append((key, start, end))
        return out

    def _read_times(self) -> None:
        """The timed steps' seconds, in order; called after the host has
        waited for the device past them."""
        for key, start, end in self._pending:
            self.step_times[key].append(start.elapsed_time(end) / 1e3)
        self._pending.clear()

    @torch.no_grad()
    def _greedy_batch(self, prompts: np.ndarray, n_new: int) -> np.ndarray:
        B, S = prompts.shape
        batch = {"tokens": torch.as_tensor(prompts, device=self.device),
                 **stub_inputs(self.model.cfg, B, self.device)}
        with self.tracer.span("prefill", batch=B, prompt_len=S):
            logits, caches = self._timed(
                "prefill_s", lambda: self.model.prefill(
                    self.params, batch, self.max_len))
        out = []
        tok = torch.argmax(logits[:, -1], dim=-1)
        prefix = prefix_tokens(self.model.cfg)
        with self.tracer.span("decode", steps=n_new):
            for i in range(n_new):
                out.append(tok)
                with profiled("decode_step"):
                    logits, caches = self._timed(
                        "decode_step_s", lambda: self.model.decode_step(
                            self.params, tok, caches, S + prefix + i))
                    tok = torch.argmax(logits[:, 0], dim=-1)
            gen = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        self._read_times()
        return gen

    def serve(self, requests: Dict[int, np.ndarray], n_new: int = 8,
              *, crash_after_batches: Optional[int] = None) -> Dict[int, list]:
        """Serve a request dict {rid: prompt tokens[S]} and return the
        committed results for exactly the requested rids.  Ragged prompt
        lengths are handled by grouping requests into equal-length
        batches (shortest first, rid order within a group): a causal
        model's generation for a prompt is then independent of which
        other requests share its batch.  Already-committed rids are
        skipped (exactly-once) and answered from the log."""
        arrival = time.perf_counter_ns()
        with self.tracer.span("route", n_requests=len(requests)):
            self.log.refresh()  # pick up other engine instances' commits
            rids = sorted(requests)
            todo = [rid for rid, done
                    in zip(rids, self.log.is_committed(rids)) if not done]
            groups: Dict[int, List[int]] = {}
            for rid in todo:
                groups.setdefault(int(requests[rid].shape[0]), []).append(rid)
        routed = time.perf_counter_ns()
        self.metrics.counter("serving_requests_total").inc(len(rids))
        self.metrics.counter("serving_dedup_hits_total").inc(
            len(rids) - len(todo))
        lat_hist = self.metrics.histogram("serve_request_us",
                                          lo=1.0, hi=1e8, growth=1.25)
        for _ in range(len(rids) - len(todo)):     # answered by the log
            lat_hist.record((routed - arrival) / 1e3)
        wait_s, latency_s = self.request_times["wait_s"], \
            self.request_times["latency_s"]
        batches = 0
        for length in sorted(groups):
            for i in range(0, len(groups[length]), self.batch):
                batch_rids = groups[length][i:i + self.batch]
                with self.tracer.span("plan", n=len(batch_rids),
                                      prompt_len=length):
                    prompts = _stack_batch(
                        [requests[r] for r in batch_rids])
                    started = time.perf_counter_ns()
                    gen = self._greedy_batch(prompts, n_new)  # traversal
                # never evict a rid this call is serving: its result was
                # just paid for and belongs in this call's return value
                expired = ([r for r in self.log.expired_rids(self.retain)
                            if r not in requests]
                           if self.retain is not None else ())
                self.log.commit({int(r): gen[j].tolist()  # the destination
                                 for j, r in enumerate(batch_rids)},
                                evict=expired)
                self._commits_since_snap += 1
                # each request of the batch waited from its arrival to the
                # batch's start, and is answered once the commit is fenced
                done = time.perf_counter_ns()
                for _ in batch_rids:
                    wait_s.append((started - arrival) / 1e9)
                    latency_s.append((done - arrival) / 1e9)
                    lat_hist.record((done - arrival) / 1e3)
                self.metrics.counter("serving_batches_total").inc()
                if self.snapshot_every is not None and \
                        self._commits_since_snap >= self.snapshot_every:
                    self.log.snapshot()
                    self._commits_since_snap = 0
                batches += 1
                if crash_after_batches is not None and \
                        batches >= crash_after_batches:
                    self.log.io.crash(evict="none")
                    committed = self.log.committed()
                    return {rid: committed[rid] for rid in requests
                            if rid in committed}
        committed = self.log.committed()
        return {rid: committed[rid] for rid in requests if rid in committed}

    def took_effect(self, rids: Sequence[int]) -> np.ndarray:
        """Recovering-client probe: which of ``rids`` durably took
        effect (see :meth:`RequestLog.took_effect`), answered without
        log replay."""
        self.log.refresh()
        return self.log.took_effect(rids)
