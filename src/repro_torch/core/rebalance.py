"""Live cross-shard rebalancing: re-split a sharded durable map under
routed user traffic (port of ``repro.core.rebalance``).

:meth:`repro_torch.core.sharded.ShardedDurableMap.rebalance` moves a
map's bucket-range boundaries but blocks user operations while its drain
rounds run.  This module lifts the online-migration protocol of
:mod:`repro_torch.core.migrate` to the shards:

* **The old map is frozen.**  ``start_rebalance`` copies the current map
  to the host once; from then on every user update commits into the
  *new* map only, routed by the **new** splits.
* **New is authoritative per key.**  A key with any node in the new map,
  live or dead, is answered there; a dead node means "deleted during the
  rebalance" and vetoes the old map's stale live copy.  Lookups compose
  both probes with :func:`repro_torch.core.batched.merge_new_old`.
* **Drain rounds are ordinary routed updates** of a bounded contiguous
  *global* bucket range of the frozen snapshot, in the canonical order of
  :func:`repro_torch.core.migrate.drain_range`, so every migrated key pays
  O(1) flushes and 2 fences in its new owner shard.
* **User batches pull first**: one mixed ``[pull-inserts; user ops]``
  round on the new map, with the same results as running the blocking
  rebalance first and the batches after.
* **Every round is durable.**  With a ``root``, the
  :class:`RebalanceState` header, the frozen snapshot and every round go
  through the shared :class:`repro_torch.core.migrate.RoundJournal`
  (``reb_NNNN/``), flush -> fence -> atomic publish, byte-identical to
  the reference's journal; :meth:`RebalancingShardedMap.recover` replays
  it to a state bit-identical to a round boundary and resumes.

:class:`AutoRebalancePolicy` closes the loop: the per-bucket flush counts
of every round accumulate, and when the hottest shard's share exceeds
the threshold, :func:`repro_torch.launch.mesh.replan_splits` derives
load-quantile boundaries and a rebalance starts by itself.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from . import batched as B
from ..obs.compile import get_tracker
from ..obs.metrics import get_registry
from .migrate import RoundJournal, drain_range
from .sharded import RebalanceReport, ShardedDurableMap, shard_host


class RebalanceState(NamedTuple):
    """The durable rebalance header, small enough to publish atomically;
    with the frozen snapshot and the journaled rounds it determines both
    maps.  ``frontier``/``n_rounds`` are as of the header's publish.

    >>> h = RebalanceState(phase="rebalancing", frontier=8, n_buckets=64,
    ...                    capacity_old=4096, capacity_new=4096,
    ...                    splits_old=(0, 32, 64), splits_new=(0, 8, 64),
    ...                    buckets_per_round=8, n_rounds=1)
    >>> RebalanceState.from_bytes(h.to_bytes()) == h
    True
    """
    phase: str                    # "rebalancing" | "done"
    frontier: int                 # global old-bucket drain frontier
    n_buckets: int
    capacity_old: int
    capacity_new: int
    splits_old: Tuple[int, ...]
    splits_new: Tuple[int, ...]
    buckets_per_round: int
    n_rounds: int                 # journaled rounds (drain + user)

    def to_bytes(self) -> bytes:
        return json.dumps(self._asdict(), sort_keys=True).encode()

    @staticmethod
    def from_bytes(b: bytes) -> "RebalanceState":
        d = json.loads(b.decode())
        d["splits_old"] = tuple(d["splits_old"])
        d["splits_new"] = tuple(d["splits_new"])
        return RebalanceState(**d)


class AutoRebalancePolicy(NamedTuple):
    """When to re-split without an operator call: every ``check_every``-th
    steady-state update, if at least ``min_load`` flushes accumulated
    since the last rebalance, the hottest shard carries more than
    ``threshold`` x the mean load, and the re-plan moves a boundary."""
    threshold: float = 1.5
    min_load: int = 2048
    check_every: int = 4
    buckets_per_round: Optional[int] = None


def _pending_per_shard(shards, splits_old, frontier: int,
                       new_map: ShardedDurableMap) -> np.ndarray:
    """Per-*new*-shard count of live old keys not yet drained (global
    bucket >= ``frontier``): the reserve the fits check holds against
    user traffic so the remaining drains always fit."""
    remaining = np.zeros(new_map.n_shards, np.int64)
    for s, (a0, b0) in enumerate(zip(splits_old, splits_old[1:])):
        a = max(frontier, a0)
        if a >= b0:
            continue
        ks, _ = drain_range(shards[s], a - a0, b0 - a0)
        if ks.size:
            remaining += np.bincount(new_map.owners_of(ks),
                                     minlength=new_map.n_shards)
    return remaining


class RebalancingShardedMap:
    """A :class:`~repro_torch.core.sharded.ShardedDurableMap` that
    re-splits its bucket ranges under live traffic and, given a policy,
    by itself.

    Steady state it is a thin wrapper (same ``update``/``insert``/
    ``delete``/``lookup``/``probe`` contracts).  During a rebalance, user
    batches route by the new splits and commit pull-first into the new
    map, lookups are new-then-old, and every ``update()`` first advances
    ``rounds_per_update`` drain rounds.  On completion the new map is
    adopted as is, so a quiescent live rebalance is state-identical to
    the blocking one.  ``root`` journals the rebalance window and
    :meth:`recover` rebuilds bit-identical state after a crash.
    ``device`` (``None`` = the card) holds both maps."""

    def __init__(self, n_shards: int = 1, *, capacity: int = 1 << 16,
                 n_buckets: int = 1024,
                 splits: Optional[Sequence[int]] = None,
                 root=None, seed: int = 0,
                 buckets_per_round: Optional[int] = None,
                 rounds_per_update: int = 1,
                 policy: Optional[AutoRebalancePolicy] = None,
                 device=None):
        self.map = ShardedDurableMap(n_shards, capacity=capacity,
                                     n_buckets=n_buckets, splits=splits,
                                     device=device)
        self.device = self.map.device
        self.buckets_per_round = buckets_per_round
        self.rounds_per_update = rounds_per_update
        self.policy = policy
        self.io = None
        if root is not None:
            from ..persistence.manifest import StagedIO
            self.io = StagedIO(Path(root), seed=seed)
        self._reb = None            # in-flight rebalance bookkeeping
        self._journal = None        # RoundJournal of the in-flight window
        self._reb_seq = 0           # completed+started rebalances (dir)
        self._updates_since_check = 0
        # per-global-bucket flush load since the last rebalance: what the
        # auto policy (and replan_splits) read
        self.loads = np.zeros(n_buckets, np.int64)
        self.rebalances_completed = 0
        self.rounds_total = 0       # drain rounds across all rebalances
        self.migrated_total = 0
        self.pulls_total = 0
        self.last_report: Optional[RebalanceReport] = None
        self.last_trigger_imbalance: Optional[float] = None

    # ---------------- pass-through geometry --------------------------- #
    def _auth(self) -> ShardedDurableMap:
        """The authoritative map: the new one while a rebalance drains."""
        return self._reb["new"] if self._reb else self.map

    @property
    def n_shards(self) -> int:
        return self.map.n_shards

    @property
    def n_buckets(self) -> int:
        return self.map.n_buckets

    @property
    def splits(self) -> Tuple[int, ...]:
        """The authoritative boundaries: the new splits as soon as a
        rebalance opens (ops route by them from that moment on)."""
        return self._auth().splits

    @property
    def capacity(self) -> int:
        return self._auth().capacity

    @property
    def cap_local(self) -> int:
        return self._auth().cap_local

    @property
    def state(self):
        return self._auth().state

    @property
    def rebalancing(self) -> bool:
        return self._reb is not None

    @property
    def frontier(self) -> Optional[int]:
        return None if self._reb is None else self._reb["frontier"]

    @property
    def cursors(self) -> np.ndarray:
        """Upper bound of per-shard pool usage: the serving map's cursors
        plus, during a rebalance, the un-drained live keys still owed to
        each new shard."""
        if self._reb is None:
            return self.map.cursors
        return self._reb["new"].cursors + self._reb["remaining"]

    @property
    def flushes(self) -> int:
        f = self.map.flushes
        if self._reb is not None:
            f += self._reb["new"].flushes
        return f

    @property
    def fences(self) -> int:
        f = self.map.fences
        if self._reb is not None:
            f += self._reb["new"].fences
        return f

    def owners_of(self, ks) -> np.ndarray:
        return self._auth().owners_of(ks)

    def fresh_demand(self, ks) -> np.ndarray:
        """Per-shard allocation demand of distinct insert keys beyond the
        drain reserve of :attr:`cursors`: mid-rebalance a key allocates
        in the new map unless it has a node there or is live in the old
        map (a key whose only node is dead in the old map allocates)."""
        if self._reb is None:
            return self.map.fresh_demand(ks)
        ks = np.asarray(ks, np.int32)
        new = self._reb["new"]
        ex_new, _, _ = new.probe(ks)
        _, live_old, _ = self.map.probe(ks)
        covered = ex_new | live_old
        return np.bincount(new.owners_of(ks[~covered]),
                           minlength=self.n_shards).astype(np.int64)

    def chain_stats(self) -> Tuple[int, float]:
        return self._auth().chain_stats()

    def items(self) -> dict:
        """Abstract content ``{key: (live, val)}``, new-authoritative."""
        out = self.map.items()
        if self._reb is not None:
            out.update(self._reb["new"].items())
        return out

    # ---------------- op API ------------------------------------------- #
    def update(self, ops, ks, vs):
        """One mixed round in batch order; advances ``rounds_per_update``
        drain rounds first while a rebalance is in flight and, with a
        policy, opens one when the load counters say so.  Returns
        ``(ok, ShardCommitStats)`` as the plain sharded map does."""
        ops = np.asarray(ops, np.int32)
        ks = np.asarray(ks, np.int32)
        vs = np.asarray(vs, np.int32)
        if self._reb is None:
            self._maybe_trigger()
        if self._reb is None:
            ok, stats = self.map.update(ops, ks, vs)
            self._note(stats)
            return ok, stats
        for _ in range(self.rounds_per_update):
            if self._reb is not None:
                self.rebalance_round()
        if self._reb is None:
            return self.update(ops, ks, vs)     # finished mid-call
        return self._commit_rebalancing(ops, ks, vs)

    def insert(self, ks, vs):
        ks = np.asarray(ks, np.int32)
        return self.update(np.full(ks.shape, B.OP_INSERT, np.int32),
                           ks, vs)

    def delete(self, ks):
        ks = np.asarray(ks, np.int32)
        return self.update(np.full(ks.shape, B.OP_DELETE, np.int32),
                           ks, np.zeros_like(ks))

    def probe(self, ks):
        """Merged node-level probe ``(exists, live, vals)``: the new map's
        node (live or dead) shadows the old map's."""
        if self._reb is None:
            return self.map.probe(ks)
        ex_n, live_n, val_n = self._reb["new"].probe(ks)
        ex_o, live_o, val_o = self.map.probe(ks)
        return (ex_n | ex_o, np.where(ex_n, live_n, live_o),
                np.where(ex_n, val_n, val_o).astype(np.int32))

    def lookup(self, ks):
        """New-then-old batched lookup (no persistence work)."""
        if self._reb is None:
            return self.map.lookup(ks)
        ex_n, live_n, val_n = self._reb["new"].probe(ks)
        _, live_o, val_o = self.map.probe(ks)
        return B.merge_new_old(ex_n, live_n, val_n, live_o, val_o)

    # ---------------- the auto policy ---------------------------------- #
    def _note(self, stats) -> None:
        if stats is None:
            return
        self.loads += np.asarray(stats.bucket_flushes, np.int64)
        self._updates_since_check += 1
        # gauges from the numbers the auto policy reads: per-shard
        # accumulated flush load and the hottest-shard ratio
        per = np.add.reduceat(self.loads, np.asarray(self.splits[:-1]))
        total = float(per.sum())
        m = get_registry()
        for s, v in enumerate(per):
            m.gauge("map_shard_load", shard=str(s)).set(float(v))
        if total > 0:
            m.gauge("map_load_imbalance").set(
                float(per.max()) / (total / len(per)))

    def _maybe_trigger(self) -> None:
        p = self.policy
        if p is None or self._updates_since_check < p.check_every:
            return
        self._updates_since_check = 0
        if int(self.loads.sum()) < p.min_load:
            return
        from ..launch import mesh
        new_splits, imbalance = mesh.replan_splits(
            self.map.splits, self.loads, threshold=p.threshold)
        if new_splits is None:
            return
        try:
            self.start_rebalance(new_splits,
                                 buckets_per_round=p.buckets_per_round)
        except ValueError:
            # the flush-load plan can pack more live keys into one new
            # shard than its pool holds: the auto path declines (and
            # re-plans on fresh load) instead of failing a user update
            self.loads[:] = 0
            get_registry().counter("map_rebalance_declined_total").inc()
            return
        self.last_trigger_imbalance = imbalance
        get_registry().gauge("map_trigger_imbalance").set(imbalance)

    def imbalance(self) -> float:
        """Hottest shard's share of the accumulated load, normalized so
        1.0 is perfect balance (what the policy thresholds)."""
        from ..launch import mesh
        return mesh.replan_splits(self.splits, self.loads,
                                  threshold=float("inf"))[1]

    # ---------------- rebalance control -------------------------------- #
    def start_rebalance(self, splits: Sequence[int], *,
                        capacity: Optional[int] = None,
                        buckets_per_round: Optional[int] = None) -> None:
        """Freeze the current map as the drain source, open an empty map
        on the new boundaries, and durably publish the header
        (phase=rebalancing, frontier=0) and the frozen snapshot."""
        if self._reb is not None:
            raise RuntimeError("rebalance already in flight")
        new = ShardedDurableMap(
            self.map.n_shards, capacity=capacity or self.map.capacity,
            n_buckets=self.map.n_buckets, splits=splits,
            device=self.device)
        host = self.map.host()
        shards = [shard_host(host, s) for s in range(self.map.n_shards)]
        remaining = _pending_per_shard(shards, self.map.splits, 0, new)
        if not bool((1 + remaining <= new.cap_local).all()):
            raise ValueError(
                f"splits {tuple(splits)} cannot hold the live content: "
                f"per-shard demand {remaining.tolist()} vs per-shard "
                f"pool {new.cap_local - 1}")
        bpr = (buckets_per_round or self.buckets_per_round
               or max(1, self.map.n_buckets // 8))
        self._reb = {
            "new": new, "frontier": 0, "bpr": bpr, "n_rounds": 0,
            "drain_rounds": 0, "shard_host": shards,
            "remaining": remaining, "migrated": 0, "skipped": 0,
            "foreign": 0, "bf": np.zeros(self.map.n_buckets, np.int64),
            "splits_old": self.map.splits,
            "chain_before": self.map.chain_stats(),
        }
        self._reb_seq += 1
        if self.io is not None:
            self._journal = RoundJournal(self.io, self._reb_dir())
            self._journal.write_snapshot(host)
            self._publish_header("rebalancing")

    def _reb_dir(self) -> str:
        return f"reb_{self._reb_seq:04d}"

    def _header(self, phase: str) -> RebalanceState:
        r = self._reb
        return RebalanceState(
            phase=phase, frontier=r["frontier"],
            n_buckets=self.map.n_buckets,
            capacity_old=self.map.capacity,
            capacity_new=r["new"].capacity,
            splits_old=r["splits_old"], splits_new=r["new"].splits,
            buckets_per_round=r["bpr"], n_rounds=r["n_rounds"])

    def _publish_header(self, phase: str) -> None:
        self._journal.publish_header(self._header(phase).to_bytes())

    def _journal_round(self, ops, ks, vs, frontier_after: int) -> None:
        r = self._reb
        if self._journal is None:
            r["n_rounds"] += 1
            return
        self._journal.append(ops=ops, ks=ks, vs=vs,
                             frontier=np.int32(frontier_after))
        r["n_rounds"] = self._journal.n_rounds

    def rebalance_round(self) -> bool:
        """Drain the next ``buckets_per_round`` global old buckets into
        the new map as one routed insert round, journal it, and advance
        the frontier.  Returns True when the rebalance completed (the
        last round also adopts the new map)."""
        r = self._reb
        if r is None:
            raise RuntimeError("no rebalance in flight")
        nb = self.map.n_buckets
        lo, hi = r["frontier"], min(r["frontier"] + r["bpr"], nb)
        parts = []
        for s in range(self.map.n_shards):   # split order = bucket-asc
            a = max(lo, r["splits_old"][s])
            b = min(hi, r["splits_old"][s + 1])
            if a < b:
                parts.append(drain_range(
                    r["shard_host"][s], a - r["splits_old"][s],
                    b - r["splits_old"][s]))
        ks = (np.concatenate([p[0] for p in parts]) if parts
              else np.zeros(0, np.int32))
        vs = (np.concatenate([p[1] for p in parts]) if parts
              else np.zeros(0, np.int32))
        n_cand = int(ks.size)
        if n_cand:
            r["remaining"] -= np.bincount(
                r["new"].owners_of(ks), minlength=self.map.n_shards)
            # new-authoritative filter: keys user traffic already pulled
            # (or re-inserted, or deleted) must not be re-migrated
            with get_tracker().reason("resplit_width_change"):
                ex, _, _ = r["new"].probe(ks)
            ks, vs = ks[~ex], vs[~ex]
        ops = np.zeros(ks.size, np.int32)          # all OP_INSERT
        if ks.size:
            with get_tracker().reason("resplit_width_change"):
                ok, stats = r["new"].insert(ks, vs)
            if not ok.all():
                raise RuntimeError(
                    f"rebalance drain dropped keys at global bucket "
                    f"{lo} (reserve accounting bug)")
            r["foreign"] += int(stats.foreign_ops.sum())
            r["bf"] += stats.bucket_flushes
        self._journal_round(ops, ks, vs, hi)
        r["frontier"] = hi
        r["drain_rounds"] += 1
        r["migrated"] += int(ks.size)
        r["skipped"] += n_cand - int(ks.size)
        self.rounds_total += 1
        self.migrated_total += int(ks.size)
        get_registry().counter("map_rebalance_rounds_total").inc()
        get_registry().counter("map_rebalanced_keys_total").inc(
            int(ks.size))
        if hi >= nb:
            self._finish()
            return True
        return False

    def run_rebalance(self) -> RebalanceReport:
        """Drive the in-flight rebalance to completion (blocking)."""
        if self._reb is None:
            raise RuntimeError("no rebalance in flight")
        while self._reb is not None:
            self.rebalance_round()
        return self.last_report

    def _finish(self) -> None:
        r = self._reb
        if self._journal is not None:
            self._publish_header("done")
            if self._reb_seq > 1:      # the previous window's journal is
                self.io.remove_tree(   # superseded: bound disk growth
                    f"reb_{self._reb_seq - 1:04d}")
        self.last_report = RebalanceReport(
            rounds=r["drain_rounds"], migrated=r["migrated"],
            foreign_ops=r["foreign"],
            bucket_flushes=r["bf"].astype(np.int32),
            splits_old=r["splits_old"], splits_new=r["new"].splits,
            chain_before=r["chain_before"],
            chain_after=r["new"].chain_stats())
        self.map = r["new"]
        self._reb = None
        self._journal = None
        # the trigger measures post-rebalance traffic only
        self.loads[:] = 0
        self._updates_since_check = 0
        self.rebalances_completed += 1
        get_registry().counter("map_rebalances_total").inc()

    def _commit_rebalancing(self, ops, ks, vs):
        """Commit a user batch into the new map as one mixed routed round
        of ``[pull-inserts; user ops]``."""
        r = self._reb
        new = r["new"]
        uniq = np.unique(ks)
        with get_tracker().reason("resplit_width_change"):
            ex_new, _, _ = new.probe(uniq)
        cand = uniq[~ex_new]
        _, live_old, val_old = self.map.probe(cand)
        pull_ks = cand[live_old]
        pull_vs = val_old[live_old].astype(np.int32)
        # exact per-shard reserve check: every pull and every fresh user
        # insert allocates at worst one node in its owner shard, and the
        # un-drained remainder must still fit behind them
        fresh_cand = cand[~live_old]
        fresh_user = np.unique(ks[ops == B.OP_INSERT])
        fresh_user = fresh_user[np.isin(fresh_user, fresh_cand,
                                        assume_unique=True)]
        alloc_ks = np.concatenate([pull_ks, fresh_user])
        demand = (np.bincount(new.owners_of(alloc_ks),
                              minlength=self.map.n_shards)
                  if alloc_ks.size else np.zeros(self.map.n_shards,
                                                 np.int64))
        if not bool((new.cursors + demand + r["remaining"]
                     <= new.cap_local).all()):
            # this batch and the un-drained remainder cannot fit: finish
            # now (the reserve guarantees the drains fit), then commit
            self.run_rebalance()
            return self.update(ops, ks, vs)
        bops = np.concatenate(
            [np.full(pull_ks.size, B.OP_INSERT, np.int32), ops])
        bks = np.concatenate([pull_ks, ks])
        bvs = np.concatenate([pull_vs, vs])
        if bks.size == 0:
            return np.zeros(0, np.bool_), None
        with get_tracker().reason("resplit_width_change"):
            ok, stats = new.update(bops, bks, bvs)
        if not ok[:pull_ks.size].all():
            raise RuntimeError("rebalance pull dropped keys "
                               "(reserve accounting bug)")
        r["foreign"] += int(stats.foreign_ops.sum())
        r["bf"] += stats.bucket_flushes
        self._journal_round(bops, bks, bvs, r["frontier"])
        self.pulls_total += int(pull_ks.size)
        get_registry().counter("map_pulls_total").inc(int(pull_ks.size))
        self._note(stats)
        return ok[pull_ks.size:], stats

    # ---------------- growth (for the index backend) ------------------- #
    def grow_to(self, *, capacity: Optional[int] = None,
                n_buckets: Optional[int] = None) -> RebalanceReport:
        """Capacity/bucket growth: finish any in-flight rebalance, then
        migrate through :meth:`~ShardedDurableMap.migrate_to` and adopt
        the grown map.  The load counters reset (the bucket space may
        change)."""
        if self._reb is not None:
            self.run_rebalance()
        self.map, report = self.map.migrate_to(capacity=capacity,
                                               n_buckets=n_buckets)
        self.loads = np.zeros(self.map.n_buckets, np.int64)
        self._updates_since_check = 0
        self.last_report = report
        return report

    # ---------------- crash recovery ----------------------------------- #
    def crash(self, evict: str = "none", p_evict: float = 0.5) -> None:
        """Simulate a process kill: the staging area is lost (unfenced
        journal bytes with it, apart from what the ``evict`` adversary
        lands) and the in-memory maps are dropped."""
        if self.io is None:
            raise RuntimeError("crash() needs a durable root")
        self.io.crash(evict=evict, p_evict=p_evict)
        self.map = None
        self._reb = None
        self._journal = None

    @classmethod
    def recover(cls, root, n_shards: Optional[int] = None, *,
                seed: int = 0, rounds_per_update: int = 1,
                policy: Optional[AutoRebalancePolicy] = None,
                device=None) -> "RebalancingShardedMap":
        """Rebuild from the newest rebalance journal: restore the frozen
        old map from the snapshot, replay the published rounds in order
        through the routed engine (deterministic, so bit-identical) and
        resume from the recovered frontier.  A ``done`` header recovers
        the completed re-split map.  ``n_shards`` defaults to the
        journal's."""
        root = Path(root)
        d = RoundJournal.newest_dir(root, "reb")
        if d is None:
            raise FileNotFoundError(
                f"no published rebalance journal under {root}")
        hdr_bytes, snap, rounds = RoundJournal.read(root, d)
        hdr = RebalanceState.from_bytes(hdr_bytes)
        if n_shards is None:
            n_shards = len(hdr.splits_old) - 1
        m = cls(n_shards, capacity=hdr.capacity_old,
                n_buckets=hdr.n_buckets, splits=hdr.splits_old, root=root,
                seed=seed, rounds_per_update=rounds_per_update,
                policy=policy, device=device)
        m._reb_seq = int(d.split("_")[1])
        m.map.load_state(snap)
        new = ShardedDurableMap(
            m.map.n_shards, capacity=hdr.capacity_new,
            n_buckets=hdr.n_buckets, splits=hdr.splits_new,
            device=m.device)
        frontier = drain_rounds = migrated = foreign = 0
        bf = np.zeros(hdr.n_buckets, np.int64)
        for rec in rounds:
            if rec["ks"].size:
                _, stats = new.update(rec["ops"], rec["ks"], rec["vs"])
                foreign += int(stats.foreign_ops.sum())
                bf += stats.bucket_flushes
            f_after = int(rec["frontier"])
            if f_after > frontier:               # a drain round
                drain_rounds += 1
                migrated += int(rec["ks"].size)
                frontier = f_after
        if hdr.phase == "done":
            m.map = new
            m.rebalances_completed = 1
            return m
        shards = [shard_host(snap, s) for s in range(m.map.n_shards)]
        m._reb = {
            "new": new, "frontier": frontier,
            "bpr": hdr.buckets_per_round, "n_rounds": len(rounds),
            "drain_rounds": drain_rounds, "shard_host": shards,
            "remaining": _pending_per_shard(shards, hdr.splits_old,
                                            frontier, new),
            "migrated": migrated, "skipped": 0, "foreign": foreign,
            "bf": bf, "splits_old": hdr.splits_old,
            "chain_before": m.map.chain_stats(),
        }
        m._journal = RoundJournal(m.io, d)
        m._journal.n_rounds = len(rounds)    # resume round numbering
        return m
