"""Systematic crash-fault injection across the port's durable layers (port
of ``repro.robustness.faultinject``).

A :class:`CrashPlan` instruments every persistence instruction a scenario
issues through :class:`repro_torch.persistence.manifest.StagedIO` --
flush, fence, publish (the atomic rename) and trim -- as a numbered
**crash site**, and can

  * **enumerate** the sites of a deterministic scenario (no crash),
  * **crash deterministically** at the N-th site (the site's own
    instruction never executes -- crash-*before* semantics, so sweeping
    every site plus the no-crash run covers every boundary), or
  * **fuzz** sites with a seeded coin (``p_crash``),

combined with the shared seedable eviction adversary
(:func:`repro_torch.core.pmem.evicted_mask`) applied to whatever was
staged at the crash.  :func:`sweep` drives a scenario crash-at-every-site
x eviction mode and runs the scenario's recovery checks after each crash:
no acknowledged op lost, prefix durability, and oracle equivalence (an
independent host-side replay of the durable bytes matches the recovered
object).

Six scenarios (:data:`SCENARIOS`), the reference's: the serving
:class:`~repro_torch.serving.engine.RequestLog` (``log``), two such logs
live on one dir (``log2``), the :class:`~repro_torch.persistence.
checkpoint.CheckpointManager` save/gc chain (``checkpoint``), the
:class:`~repro_torch.core.migrate.MigratingMap` growth window
(``migrate``), the :class:`~repro_torch.core.rebalance.
RebalancingShardedMap` re-split window (``rebalance``, with ``n_shards``
through ``scenario_kw``) and the
:class:`~repro_torch.core.ordered.DurableOrderedMap` batch journal
(``ordered``).  Each takes a ``device`` (through ``scenario_kw``) for the
maps it builds; ``None`` is the card.  Each visits the same
``(kind, target)`` sites as the reference's scenario of the same name.

>>> s = CrashSite(3, "publish", "mig_0001/state.json")
>>> s.index, s.kind
(3, 'publish')
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import KINDS


@dataclasses.dataclass(frozen=True)
class CrashSite:
    """One persistence instruction: the ``index``-th site the scenario
    reached, of ``kind`` (flush/fence/publish/trim), acting on ``target``
    (a staged file's relative path, or "" for a fence)."""
    index: int
    kind: str
    target: str


class CrashPoint(Exception):
    """Raised by a firing :class:`CrashPlan` -- the simulated kill.  By the
    time it propagates every attached IO object has crashed (staging
    lost, eviction adversary applied)."""

    def __init__(self, site: CrashSite):
        super().__init__(f"injected crash at site {site.index} "
                         f"({site.kind} {site.target})")
        self.site = site


class CrashPlan:
    """A shared, seedable crash schedule over every attached IO object.

    ``crash_at`` fires at that site index; ``p_crash`` > 0 instead flips
    a seeded coin at every site.  Leave both unset to enumerate: the
    scenario runs to completion and :attr:`sites` holds every site it
    visited.  ``evict``/``p_evict`` select the eviction adversary each
    attached object's ``crash()`` applies when the plan fires.  The crash
    is whole-process: all attached objects crash together, the site's
    own instruction never executes, and a fired plan goes inert."""

    def __init__(self, crash_at: Optional[int] = None, *,
                 evict: str = "none", p_evict: float = 0.5,
                 p_crash: float = 0.0, seed: int = 0):
        self.crash_at = crash_at
        self.evict = evict
        self.p_evict = p_evict
        self.p_crash = p_crash
        self._rng = np.random.default_rng(seed)
        self.sites: List[CrashSite] = []
        self.fired_at: Optional[CrashSite] = None
        self._attached: list = []

    def attach(self, *objs) -> "CrashPlan":
        """Instrument IO objects: every persistence instruction they
        execute from now on reports a site, and all of them crash
        together when the plan fires."""
        for obj in objs:
            obj.faults = self
            if not any(o is obj for o in self._attached):
                self._attached.append(obj)
        return self

    def on_site(self, kind: str, target: str = "") -> None:
        """Called by instrumented IO before executing one persistence
        instruction; fires the crash when the schedule says so."""
        if self.fired_at is not None:
            return                       # already crashed: inert
        if kind not in KINDS:
            raise ValueError(f"unknown site kind {kind!r}")
        site = CrashSite(len(self.sites), kind, target)
        self.sites.append(site)
        fire = site.index == self.crash_at or (
            self.p_crash > 0 and self._rng.random() < self.p_crash)
        if fire:
            self.fired_at = site
            for obj in self._attached:
                obj.crash(evict=self.evict, p_evict=self.p_evict)
            raise CrashPoint(site)

    def completed_sites(self) -> List[CrashSite]:
        """Sites whose instruction actually executed: everything before
        the fired site -- the ground truth for "was this publish
        acknowledged?"."""
        if self.fired_at is None:
            return list(self.sites)
        return self.sites[:self.fired_at.index]


# --------------------------------------------------------------------- #
# scenario helpers                                                       #
# --------------------------------------------------------------------- #
def _acked_publishes(plan: CrashPlan, match: Callable[[str], bool]) -> int:
    """Count executed publish instructions whose target matches."""
    return sum(1 for s in plan.completed_sites()
               if s.kind == "publish" and match(s.target))


def _replay_rounds(new_items: dict, rounds: Sequence[dict]) -> None:
    """Independent dict-model replay of journaled rounds, with the
    engine's op semantics (batch order; an insert lands iff the key is
    not live, a delete iff it is; a dead node keeps its last value)."""
    for rec in rounds:
        for o, k, v in zip(rec["ops"], rec["ks"], rec["vs"]):
            k, v = int(k), int(v)
            live, old_v = new_items.get(k, (False, 0))
            if int(o) == 0:                       # OP_INSERT
                if not live:
                    new_items[k] = (True, v)
            else:                                 # OP_DELETE
                if live:
                    new_items[k] = (False, old_v)


def _live(items: dict) -> dict:
    """Abstract live content {key: val} of a {key: (live, val)} dict."""
    return {k: v for k, (alive, v) in items.items() if alive}


def _journal_invariants(root: Path, plan: CrashPlan, prefix: str):
    """Shared RoundJournal checks: returns ``(dirname, header bytes,
    snapshot, rounds)`` of the newest published journal after asserting
    no acked round lost and that round files are contiguous from 0.
    Returns None -- after asserting no header publish had executed --
    when no journal was ever published."""
    from ..core.migrate import RoundJournal

    d = RoundJournal.newest_dir(root, prefix)
    acked_rounds = _acked_publishes(
        plan, lambda t: t.startswith(f"{prefix}_") and "/round_" in t)
    acked_headers = _acked_publishes(
        plan, lambda t: t.startswith(f"{prefix}_")
        and t.endswith("state.json"))
    if d is None:
        assert acked_headers == 0, \
            f"published {prefix} header lost after crash"
        assert acked_rounds == 0, \
            f"acked {prefix} rounds lost with their journal"
        return None
    hdr, snap, rounds = RoundJournal.read(root, d)
    k = len(rounds)
    assert k >= acked_rounds, \
        f"acked rounds lost: journal has {k}, {acked_rounds} were acked"
    names = sorted(p.name for p in (Path(root) / d).glob("round_*.npz"))
    assert names == [f"round_{i:06d}.npz" for i in range(k)], \
        f"round files not a contiguous prefix: {names}"
    return d, hdr, snap, rounds


# --------------------------------------------------------------------- #
# the durable-layer scenarios                                            #
# --------------------------------------------------------------------- #
class RequestLogScenario:
    """Serving request log under commit + evict + snapshot/truncate
    traffic.  Acked ground truth is tracked at the API boundary (a
    commit() that returned was acknowledged); the oracle is an
    independent host-side replay of the surviving snapshot + record
    files."""

    layer = "log"
    N_BATCHES = 6
    BATCH = 3
    RETAIN = 6
    SNAP_EVERY = 2          # snapshot()+truncate after every 2 commits

    def __init__(self, root, plan: CrashPlan, device=None,
                 shards: Optional[int] = None):
        """``shards`` runs the identical schedule with the dedup index on
        the bucket-range-sharded durable map (its shards share
        ``device``); the invariants do not depend on the shard count."""
        self.root = Path(root)
        self.plan = plan
        self.device = device
        self.shards = shards
        self.issued: Dict[int, list] = {}   # every commit attempted
        self.issued_evict: set = set()
        self.acked: Dict[int, list] = {}    # commit() returned
        self.acked_evict: set = set()

    def _log(self, **kw):
        from ..serving.engine import RequestLog
        return RequestLog(self.root, capacity=1024, device=self.device,
                          shards=self.shards,
                          **kw)

    def run(self) -> None:
        log = self._log()
        self.plan.attach(log.io)
        rid = 0
        for b in range(self.N_BATCHES):
            results = {rid + i: [b, i, rid + i]
                       for i in range(self.BATCH)}
            rid += self.BATCH
            evict = log.expired_rids(self.RETAIN)
            self.issued.update(results)
            self.issued_evict.update(evict)
            log.commit(results, evict=evict)
            self.acked.update(results)
            self.acked_evict.update(evict)
            if (b + 1) % self.SNAP_EVERY == 0:
                log.snapshot()

    def _disk_oracle(self) -> Dict[int, list]:
        """Independent replay of the durable bytes: newest valid
        snapshot, then every whole record at/past its horizon in slot
        order."""
        snaps = sorted(p.name for p in self.root.glob("snap_*.json"))
        results: Dict[int, list] = {}
        horizon = 0
        for name in reversed(snaps):
            try:
                data = json.loads((self.root / name).read_text())
                results = {int(k): list(v)
                           for k, v in data["results"].items()}
                horizon = int(data["horizon"])
                break
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
        for p in sorted(self.root.glob("log_*.json")):
            try:
                idx = int(p.name[4:-5])
            except ValueError:
                continue
            if idx < horizon:
                continue
            try:
                data = json.loads(p.read_text())
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue    # torn record (truncated or garbled): trimmed
            if "results" in data and set(data) <= {"results", "evict"}:
                rec = {int(k): list(v)
                       for k, v in data["results"].items()}
                ev = [int(r) for r in data.get("evict", [])]
            else:
                rec = {int(k): list(v) for k, v in data.items()}
                ev = []
            results.update(rec)
            for r in ev:
                results.pop(r, None)
        return results

    def check(self) -> None:
        oracle = self._disk_oracle()         # before restart trims
        log = self._log()
        committed = log.committed()
        # oracle equivalence: recovery == independent durable replay
        assert committed == oracle, \
            "recovered state diverges from the durable-bytes oracle"
        # no acknowledged op lost: an acked rid answers with its exact
        # payload unless some *issued* evicting record became durable
        for r, res in self.acked.items():
            if r in committed:
                assert committed[r] == res, f"payload of rid {r} changed"
            else:
                assert r in self.issued_evict, f"acked rid {r} lost"
        # prefix/atomicity: nothing outside the issued stream survives
        for r, res in committed.items():
            assert self.issued.get(r) == res, \
                f"rid {r} recovered with a payload never issued"
        # detectability: took_effect answers match
        rids = sorted(self.issued)
        want = np.asarray([r in committed for r in rids])
        assert np.array_equal(log.took_effect(rids), want)


class ConcurrentLogScenario(RequestLogScenario):
    """Two live RequestLog instances sharing one log dir, committing
    interleaved batches while instance A periodically snapshots and
    truncates; both IOs ride the same whole-process crash plan.  On top
    of the single-log invariants, the check recovers two fresh instances,
    each on its own metrics registry, and asserts that ``records_parsed``
    (attribute and registry counter alike) equals the durable
    post-horizon record files the restart had to replay, and that both
    recoveries agree."""

    layer = "log2"
    N_ROUNDS = 4
    BATCH = 2
    RETAIN = 8
    SNAP_EVERY = 2          # A snapshots after every 2 interleaved rounds

    def run(self) -> None:
        from ..obs.metrics import MetricsRegistry
        from ..serving.engine import RequestLog
        a = self._log(registry=MetricsRegistry())
        b = RequestLog(self.root, seed=1, capacity=1024, shards=self.shards,
                       registry=MetricsRegistry(), device=self.device)
        self.plan.attach(a.io, b.io)
        rid = 0
        for rnd in range(self.N_ROUNDS):
            for log in (a, b):
                results = {rid + i: [rnd, i, rid + i]
                           for i in range(self.BATCH)}
                rid += self.BATCH
                log.refresh()        # adopt the peer's commits first
                evict = log.expired_rids(self.RETAIN)
                self.issued.update(results)
                self.issued_evict.update(evict)
                log.commit(results, evict=evict)
                self.acked.update(results)
                self.acked_evict.update(evict)
            if (rnd + 1) % self.SNAP_EVERY == 0:
                a.snapshot()

    def _replay_expect(self) -> int:
        """How many record files a fresh restart must parse right now:
        every ``log_*.json`` at/past the newest valid snapshot's horizon
        (torn records cost one parse attempt too)."""
        horizon = 0
        for name in sorted((p.name for p in self.root.glob("snap_*.json")),
                           reverse=True):
            try:
                horizon = int(json.loads(
                    (self.root / name).read_text())["horizon"])
                break
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
        return sum(1 for p in self.root.glob("log_*.json")
                   if (i := self._log_idx(p.name)) is not None
                   and i >= horizon)

    @staticmethod
    def _log_idx(name: str) -> Optional[int]:
        try:
            return int(name[len("log_"):-len(".json")])
        except ValueError:
            return None

    def _recover_one(self):
        """One fresh recovered instance on a private registry, plus the
        replay size its restart was facing (read from the durable bytes
        before construction: a restart trims torn/stale files)."""
        from ..obs.metrics import MetricsRegistry
        expect = self._replay_expect()
        reg = MetricsRegistry()
        return self._log(registry=reg), reg, expect

    def check(self) -> None:
        oracle = self._disk_oracle()         # before restart trims
        log1, reg1, expect1 = self._recover_one()
        committed = log1.committed()
        assert committed == oracle, \
            "recovered state diverges from the durable-bytes oracle"
        for r, res in self.acked.items():
            if r in committed:
                assert committed[r] == res, f"payload of rid {r} changed"
            else:
                assert r in self.issued_evict, f"acked rid {r} lost"
        for r, res in committed.items():
            assert self.issued.get(r) == res, \
                f"rid {r} recovered with a payload never issued"
        assert log1.records_parsed == expect1, \
            (f"instance 1 parsed {log1.records_parsed} records, durable "
             f"suffix holds {expect1}")
        assert reg1.counter("serving_records_parsed_total").value \
            == expect1, \
            "registry counter diverges from records_parsed"
        log2, reg2, expect2 = self._recover_one()
        assert log2.records_parsed == expect2, \
            (f"instance 2 parsed {log2.records_parsed} records, durable "
             f"suffix holds {expect2}")
        assert reg2.counter("serving_records_parsed_total").value \
            == expect2, \
            "registry counter diverges from records_parsed"
        assert log2.committed() == committed, \
            "two fresh recoveries disagree on the committed state"
        rids = sorted(self.issued)
        want = np.asarray([r in committed for r in rids])
        assert np.array_equal(log1.took_effect(rids), want)
        assert np.array_equal(log2.took_effect(rids), want), \
            "took_effect answers diverge between concurrent recoveries"


class CheckpointScenario:
    """Checkpoint save/gc chain.  The manifest publish rename is the only
    commit point: after any crash, recovery must land on exactly the last
    acked step, restore its exact tree (delta references included), and
    never resurrect an unpublished commit."""

    layer = "checkpoint"
    STEPS = (1, 2, 3, 4)
    GC_AT = 3               # gc(keep=2) right after saving step 3

    def __init__(self, root, plan: CrashPlan, device=None):
        self.root = Path(root)
        self.plan = plan
        self.device = device
        self.acked: List[int] = []

    @staticmethod
    def _tree(step: int) -> dict:
        # "w" changes every step; "b" settles at step 2, so steps 3+
        # delta-reference step 2's copy (gc must keep it alive), while
        # step 1 really dies at gc time (a trim crash site)
        return {"w": np.arange(6, dtype=np.float64).reshape(2, 3) + step,
                "b": np.full(3, float(min(step, 2)))}

    def _manager(self, **kw):
        from ..persistence.checkpoint import CheckpointManager
        return CheckpointManager(self.root, device=self.device, **kw)

    def run(self) -> None:
        mgr = self._manager(faults=self.plan)
        for s in self.STEPS:
            mgr.save(s, self._tree(s), aux={"step": s})
            self.acked.append(s)
            if s == self.GC_AT:
                mgr.gc(keep=2)

    def check(self) -> None:
        man = self._manager().recover()
        if not self.acked:
            assert man is None, \
                "a never-acked save resurrected after recovery"
            return
        assert man is not None, "all acked checkpoints lost"
        assert man.step == self.acked[-1], \
            f"recovered head {man.step} != last acked {self.acked[-1]}"
        man2, tree = self._manager().restore(self._tree(0))
        assert man2.step == self.acked[-1]
        want = self._tree(man2.step)
        for k in want:
            assert np.array_equal(tree[k].cpu().numpy(), want[k]), \
                f"restored leaf {k} differs"


class MigrateScenario:
    """Map growth window: the journaled rounds are the durable surface
    (steady-state batches outside a migration are volatile by design).
    Acked ground truth is derived from the plan's executed publish
    sites."""

    layer = "migrate"

    def __init__(self, root, plan: CrashPlan, device=None):
        self.root = Path(root)
        self.plan = plan
        self.device = device

    def run(self) -> None:
        from ..core.migrate import MigratingMap
        from ..core import batched as B
        m = MigratingMap(capacity=16, n_buckets=4, root=self.root,
                         buckets_per_round=1, rounds_per_update=1,
                         device=self.device)
        self.plan.attach(m.io)
        m.insert(np.arange(1, 11, dtype=np.int32),
                 np.arange(1, 11, dtype=np.int32) * 3)
        m.delete(np.asarray([2, 5], np.int32))
        # does not fit the 16-slot pool: opens the journaled migration
        m.insert(np.arange(11, 19, dtype=np.int32),
                 np.arange(11, 19, dtype=np.int32) * 3)
        # mixed user traffic while the drain is in flight
        m.update(np.asarray([B.OP_DELETE, B.OP_INSERT, B.OP_INSERT],
                            np.int32),
                 np.asarray([3, 2, 30], np.int32),
                 np.asarray([0, 222, 330], np.int32))
        while m.migrating:
            m.migrate_round()

    def check(self) -> None:
        from ..core.migrate import (MigratingMap, MigrationState,
                                    items_of_host)
        out = _journal_invariants(self.root, self.plan, "mig")
        m2 = MigratingMap.recover(self.root, device=self.device)
        if out is None:
            assert m2.items() == {}, \
                "recovered content from a never-published journal"
            return
        _, hdr_bytes, snap, rounds = out
        hdr = MigrationState.from_bytes(hdr_bytes)
        acked_headers = _acked_publishes(
            self.plan, lambda t: t.endswith("state.json"))
        if acked_headers >= 2:       # start + done both executed
            assert hdr.phase == "done", "acked done-header lost"
        # oracle equivalence: snapshot + round replay through an
        # independent dict model == the recovered map's live content
        new_items: dict = {}
        _replay_rounds(new_items, rounds)
        merged = dict(items_of_host(snap))
        merged.update(new_items)
        want = _live(merged)
        assert _live(m2.items()) == want, \
            "recovered live content diverges from the journal oracle"
        # the recovered map finishes the window without moving content
        if m2.migrating:
            m2.run_migration()
            assert _live(m2.items()) == want, \
                "finishing the recovered migration changed content"


class RebalanceScenario:
    """Sharded map re-split window: the journaled rounds are the durable
    surface.  ``n_shards`` of 1 re-splits onto the same single range (a
    compaction); more shards skew shard 0 down to 2 buckets."""

    layer = "rebalance"

    def __init__(self, root, plan: CrashPlan, n_shards: int = 1,
                 device=None):
        self.root = Path(root)
        self.plan = plan
        self.n_shards = n_shards
        self.device = device

    def run(self) -> None:
        from ..core.rebalance import RebalancingShardedMap
        from ..core import batched as B
        rm = RebalancingShardedMap(self.n_shards, capacity=64,
                                   n_buckets=8, root=self.root,
                                   buckets_per_round=2,
                                   rounds_per_update=1, device=self.device)
        self.plan.attach(rm.io)
        ks = np.arange(1, 21, dtype=np.int32)
        rm.insert(ks, ks * 7)
        rm.delete(np.asarray([4, 9], np.int32))
        nb = rm.n_buckets
        if self.n_shards == 1:
            splits = (0, nb)          # a compaction re-split
        else:
            step = max(1, (nb - 2) // (self.n_shards - 1))
            splits = (0, *[2 + i * step
                           for i in range(self.n_shards - 1)], nb)
        rm.start_rebalance(splits)
        rm.update(np.asarray([B.OP_DELETE, B.OP_INSERT, B.OP_INSERT],
                             np.int32),
                  np.asarray([7, 4, 40], np.int32),
                  np.asarray([0, 444, 400], np.int32))
        while rm.rebalancing:
            rm.rebalance_round()

    def check(self) -> None:
        from ..core.migrate import items_of_host
        from ..core.rebalance import RebalancingShardedMap, RebalanceState
        from ..core.sharded import shard_host
        out = _journal_invariants(self.root, self.plan, "reb")
        if out is None:
            return       # recover() requires a published journal
        _, hdr_bytes, snap, rounds = out
        hdr = RebalanceState.from_bytes(hdr_bytes)
        acked_headers = _acked_publishes(
            self.plan, lambda t: t.endswith("state.json"))
        if acked_headers >= 2:
            assert hdr.phase == "done", "acked done-header lost"
        m2 = RebalancingShardedMap.recover(self.root, self.n_shards,
                                           device=self.device)
        merged: dict = {}
        for s in range(self.n_shards):
            merged.update(items_of_host(shard_host(snap, s)))
        new_items: dict = {}
        _replay_rounds(new_items, rounds)
        merged.update(new_items)
        want = _live(merged)
        assert _live(m2.items()) == want, \
            "recovered live content diverges from the journal oracle"
        if m2.rebalancing:
            m2.run_rebalance()
            assert _live(m2.items()) == want, \
                "finishing the recovered rebalance changed content"


class OrderedScenario:
    """The durable ordered map: mixed batches with duplicate keys
    journaled round by round, a mid-schedule snapshot with round and
    snapshot trims, then recovery checked four ways: oracle equivalence
    (a raw-file replay of the durable bytes), no acked batch lost (acked
    == durable exactly under crash-before semantics), sorted-prefix
    durability (:func:`repro_torch.core.ordered.check_sorted`), and
    tower-rebuild identity against the scalar
    :func:`repro_torch.core.skiplist.tower_height` plus bit-identity of
    the recovered arrays with a fresh engine replay."""

    layer = "ordered"
    N_BATCHES = 6
    CAPACITY = 96
    SNAP_AFTER = 3          # snapshot()+trim after the 4th batch

    def __init__(self, root, plan: CrashPlan, device=None):
        self.root = Path(root)
        self.plan = plan
        self.device = device
        self.issued: List[dict] = []     # every update() attempted
        self.acked: List[dict] = []      # update() returned

    @staticmethod
    def _batch(b: int):
        """Deterministic mixed batch ``b``: clustered keys (duplicate key
        groups and shared predecessors on purpose), every batch a
        different size."""
        rng = np.random.default_rng(4242 + b)
        n = 6 + b * 2
        ops = rng.integers(0, 2, n).astype(np.int32)
        ks = rng.integers(0, 24, n).astype(np.int32)
        vs = (100 * b + np.arange(n)).astype(np.int32)
        return ops, ks, vs

    def _map(self):
        from ..core.ordered import DurableOrderedMap
        return DurableOrderedMap(self.root, capacity=self.CAPACITY,
                                 device=self.device)

    def run(self) -> None:
        m = self._map()
        self.plan.attach(m.io)
        for b in range(self.N_BATCHES):
            ops, ks, vs = self._batch(b)
            rec = {"ops": ops.tolist(), "ks": ks.tolist(),
                   "vs": vs.tolist()}
            self.issued.append(rec)
            m.update(ops, ks, vs)
            self.acked.append(rec)
            if b == self.SNAP_AFTER:
                m.snapshot()

    def _disk_rounds(self) -> Tuple[Optional[dict], List[dict]]:
        """(newest whole snapshot payload or None, whole rounds at/past
        its horizon in index order) -- raw file parsing only."""
        snap = None
        horizon = 0
        for p in sorted(self.root.glob("osnap_*.json"), reverse=True):
            try:
                snap = json.loads(p.read_text())
                horizon = int(snap["horizon"])
                break
            except (json.JSONDecodeError, KeyError, ValueError):
                continue             # torn snapshot: older one wins
        rounds = []
        for p in sorted(self.root.glob("ord_*.json")):
            try:
                idx = int(p.name[4:-5])
            except ValueError:
                continue
            if idx < horizon:
                continue             # covered by snapshot (trim raced)
            try:
                rounds.append((idx, json.loads(p.read_text())))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue             # torn round: never published whole
        return snap, [r for _, r in sorted(rounds)]

    @staticmethod
    def _walk_snapshot(snap: dict) -> dict:
        """Raw chain walk of a snapshot's arrays: {key: (live, val)}."""
        out: dict = {}
        node = int(snap["nxt"][0])
        hops = 0
        while node != -1:
            out[int(snap["key"][node])] = (bool(snap["live"][node]),
                                           int(snap["val"][node]))
            node = int(snap["nxt"][node])
            hops += 1
            assert hops <= len(snap["key"]), "cycle in snapshot chain"
        return out

    def check(self) -> None:
        from ..core.ordered import (KEY_PAD, build_towers, check_sorted,
                                    make_ordered, state_to_numpy,
                                    update_parallel_ordered)
        from ..core.skiplist import tower_height

        snap, rounds = self._disk_rounds()
        # no acked batch lost: rounds publish before the engine applies,
        # so the durable stream is exactly the acked stream
        horizon = int(snap["horizon"]) if snap else 0
        n_durable = horizon + len(rounds)
        assert n_durable == len(self.acked), \
            f"{len(self.acked)} batches acked, {n_durable} durable"
        for rec, want in zip(rounds, self.issued[horizon:]):
            assert rec == want, "durable round payload differs from issued"

        m2 = self._map()
        # oracle equivalence: snapshot walk + dict-model round replay
        items = self._walk_snapshot(snap) if snap else {}
        _replay_rounds(items, rounds)
        assert m2.items() == items, \
            "recovered content diverges from the durable-bytes oracle"
        check_sorted(m2.state)
        # engine bit-identity: a fresh engine replaying the durable
        # stream reproduces the recovered arrays exactly
        st = make_ordered(self.CAPACITY, m2.device)
        for rec in (self.issued[:horizon] + rounds):
            st, _, _ = update_parallel_ordered(
                st, np.asarray(rec["ops"], np.int32),
                np.asarray(rec["ks"], np.int32),
                np.asarray(rec["vs"], np.int32))
        got, want_st = state_to_numpy(m2.state), state_to_numpy(st)
        for f, arr in want_st.items():
            assert np.array_equal(arr, got[f]), \
                f"recovered state field {f} not bit-identical to replay"
        # tower-rebuild identity vs the scalar promotion
        tw = build_towers(m2.state, m2.max_level)
        ks, live = got["key"], got["live"]
        by_level: Dict[int, list] = {lv: [] for lv in
                                     range(2, m2.max_level + 1)}
        for nid in np.nonzero(live)[0]:
            for lv in range(2, tower_height(int(ks[nid]),
                                            m2.max_level) + 1):
                by_level[lv].append((int(ks[nid]), int(nid)))
        row_keys, row_addr = tw.keys.cpu().numpy(), tw.addr.cpu().numpy()
        for lv in range(2, m2.max_level + 1):
            want = sorted(by_level[lv])
            row_k, row_a = row_keys[lv - 2], row_addr[lv - 2]
            assert [(int(row_k[i]), int(row_a[i]))
                    for i in range(len(want))] == want, \
                f"tower level {lv} diverges from scalar"
            assert (row_k[len(want):] == KEY_PAD).all(), \
                f"tower level {lv} padding corrupt"
        # and the rebuild is idempotent (same state -> same towers)
        tw2 = build_towers(m2.state, m2.max_level)
        assert all(bool((a == b).all()) for a, b in zip(tw, tw2)), \
            "tower rebuild not stable"


SCENARIOS = {
    "log": RequestLogScenario,
    "log2": ConcurrentLogScenario,
    "checkpoint": CheckpointScenario,
    "migrate": MigrateScenario,
    "rebalance": RebalanceScenario,
    "ordered": OrderedScenario,
}


# --------------------------------------------------------------------- #
# sweep driver                                                           #
# --------------------------------------------------------------------- #
def _run_once(scenario_cls, plan: CrashPlan,
              scenario_kw: Optional[dict] = None) -> Optional[CrashSite]:
    """One fresh-tmpdir scenario run under ``plan``; returns the fired
    site (None for a clean run) and always runs the recovery checks."""
    with tempfile.TemporaryDirectory() as d:
        sc = scenario_cls(Path(d), plan, **(scenario_kw or {}))
        try:
            sc.run()
            fired = None
        except CrashPoint as cp:
            fired = cp.site
        sc.check()
        return fired


def enumerate_sites(scenario_cls,
                    scenario_kw: Optional[dict] = None
                    ) -> List[CrashSite]:
    """Run the scenario once with no crash, returning every persistence
    site it visits (and checking its invariants crash-free)."""
    plan = CrashPlan()
    fired = _run_once(scenario_cls, plan, scenario_kw)
    assert fired is None
    return plan.sites


def _budget_indices(n: int, budget: Optional[int]) -> List[int]:
    """All sites, or an evenly spaced subset always containing the first
    and last site."""
    if budget is None or budget >= n:
        return list(range(n))
    return sorted({int(i) for i in
                   np.linspace(0, n - 1, max(2, budget)).round()})


def sweep(scenario_cls, *, budget: Optional[int] = None,
          evict_modes: Sequence[str] = ("none", "random"),
          seed: int = 0,
          scenario_kw: Optional[dict] = None) -> dict:
    """Crash-at-every-site sweep of one scenario: enumerate, then for each
    (site x eviction mode) crash there, recover, and run the scenario's
    invariant checks.  ``budget`` bounds the sites tested (evenly spaced,
    first and last always included); ``evict_modes`` may include
    ``"torn"``, the partial-write adversary.  Returns a JSON-able report;
    ``report["failures"]`` is empty iff every recovery held every
    invariant."""
    sites = enumerate_sites(scenario_cls, scenario_kw)
    idxs = _budget_indices(len(sites), budget)
    failures = []
    runs = 0
    for i in idxs:
        for evict in evict_modes:
            plan = CrashPlan(crash_at=i, evict=evict,
                             seed=seed + 1009 * i)
            runs += 1
            try:
                fired = _run_once(scenario_cls, plan, scenario_kw)
                assert fired is not None and fired.index == i, \
                    "scenario is not deterministic: planned site not hit"
            except AssertionError as e:
                failures.append({
                    "site": i, "kind": sites[i].kind,
                    "target": sites[i].target, "evict": evict,
                    "error": str(e) or repr(e)})
    return {
        "layer": getattr(scenario_cls, "layer", scenario_cls.__name__),
        "n_sites": len(sites),
        "tested_sites": idxs,
        "runs": runs,
        "evict_modes": list(evict_modes),
        "sites": [dataclasses.asdict(s) for s in sites],
        "failures": failures,
    }
