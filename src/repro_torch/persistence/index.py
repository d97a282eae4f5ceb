"""Set-membership index on the PyTorch durable map (port of
``repro.persistence.index``).

One mixed ``update_parallel`` round keeps the index current (new members
insert, removed members delete), one batched
:func:`repro_torch.core.batched.lookup` answers membership (the journey:
zero persistence work), and the map grows online before a batch that
would not fit, so the index never drops a member.  The map behind the
index is the single-device engine, or with ``n_shards`` the
bucket-range-sharded :class:`repro_torch.core.sharded.ShardedDurableMap`
(``auto_rebalance`` makes it a
:class:`repro_torch.core.rebalance.RebalancingShardedMap`).
:class:`OrderedMembershipIndex` keeps the same set on the ordered map
(:mod:`repro_torch.core.ordered`) and adds the ordered reads a retention
policy wants.  :func:`live_step_index` is the checkpoint manager's
"which steps must survive a trim?" index.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..core import batched, ordered
from ..obs.metrics import get_registry

N_BUCKETS = 128


def owner_step(rel: str) -> int:
    """Owner step of a manifest-referenced path (``step_XXXXXXXX/…``)."""
    return int(rel.split("/", 1)[0].split("_")[1])


def _pad_pow2(xs: np.ndarray) -> np.ndarray:
    """Pad a batch to the next power of two with duplicates of its *last*
    element.  A duplicate of the batch's last op never commits -- after an
    insert the key is live (a repeat insert fails), after a delete it is
    dead (a repeat delete fails) -- so padding is invisible to the map.
    Duplicating the *first* op would not be safe in a mixed batch: an
    insert replayed after a later delete of the same key would resurrect
    it."""
    n = max(1, 1 << (xs.size - 1).bit_length())
    return np.concatenate([xs, np.full(n - xs.size, xs[-1], xs.dtype)])


class _SingleBackend:
    """The single-device plan/commit engine behind the index."""

    def __init__(self, capacity: int, n_buckets: int, device):
        self.capacity = capacity
        self.n_buckets = n_buckets
        self.device = batched.resolve_device(device)
        self.state = batched.make_state(capacity, n_buckets, self.device)
        self.migrations = 0

    def _tensor(self, xs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(_pad_pow2(xs), device=self.device)

    def fits(self, ks: np.ndarray) -> bool:
        """Exact fit check for a batch of fresh-insert keys: only keys
        without a node (live or dead) allocate.  The probe only runs when
        the batch-size upper bound does not already prove fitness."""
        cursor = int(self.state.cursor)
        if cursor + ks.size <= self.capacity:
            return True
        ex, _, _ = batched.probe(self.state, self._tensor(ks),
                                 self.n_buckets)
        n_fresh = int((~ex.cpu().numpy()[:ks.size]).sum())
        return cursor + n_fresh <= self.capacity

    def grow_for(self, ks: np.ndarray) -> None:
        """Online growth: migrate to a doubled pool and bucket count (a
        rehash) in bounded rounds until the batch fits; dead nodes are
        compacted away by the drain."""
        from ..core.migrate import migrate_state
        from ..obs.compile import get_tracker
        while not self.fits(ks):
            nb_old = self.n_buckets
            self.capacity *= 2
            self.n_buckets *= 2
            with get_tracker().reason("capacity_ladder"):
                self.state, _ = migrate_state(
                    self.state, nb_old, self.capacity, self.n_buckets)
            self.migrations += 1
            get_registry().counter("dedup_migrations_total").inc()

    def update(self, ops: np.ndarray, ks: np.ndarray):
        pk = self._tensor(ks)
        self.state, ok, stats = batched.update_parallel(
            self.state, self._tensor(ops), pk, pk, self.n_buckets)
        return ok.cpu().numpy()[:ks.size], stats

    def lookup(self, ks: np.ndarray) -> np.ndarray:
        found, _ = batched.lookup(self.state, self._tensor(ks),
                                  self.n_buckets)
        return found.cpu().numpy()[:ks.size]


class _ShardedBackend:
    """The bucket-range-sharded map behind the index.  With
    ``auto_rebalance`` it is a
    :class:`~repro_torch.core.rebalance.RebalancingShardedMap`: skewed
    member streams re-split the boundaries under live index traffic, and
    growth finishes any in-flight re-split first."""

    def __init__(self, capacity: int, n_buckets: int, n_shards: int,
                 device, auto_rebalance: bool = False):
        if auto_rebalance:
            from ..core.rebalance import (AutoRebalancePolicy,
                                          RebalancingShardedMap)
            self.map = RebalancingShardedMap(
                n_shards, capacity=capacity, n_buckets=n_buckets,
                policy=AutoRebalancePolicy(), device=device)
        else:
            from ..core.sharded import ShardedDurableMap
            self.map = ShardedDurableMap(
                n_shards, capacity=capacity, n_buckets=n_buckets,
                device=device)
        self._live = auto_rebalance
        self.migrations = 0

    @property
    def rebalances(self) -> int:
        return self.map.rebalances_completed if self._live else 0

    @property
    def state(self):
        return self.map.state

    @property
    def capacity(self) -> int:
        return self.map.cap_local * self.map.n_shards

    @property
    def n_buckets(self) -> int:
        return self.map.n_buckets

    def fits(self, ks: np.ndarray) -> bool:
        """Exact *per-shard* fit check: only keys without a node (live or
        dead) allocate, each in its owner shard, so per-shard demand is
        held against each shard's own free pool.  The probe only runs
        when the batch-size upper bound does not already prove fitness.
        Mid-rebalance the map's ``cursors`` include the un-drained
        reserve and its ``fresh_demand`` counts a key whose only node is
        dead in the frozen old map."""
        cursors = self.map.cursors
        if int(cursors.max()) + ks.size <= self.map.cap_local:
            return True
        demand = self.map.fresh_demand(np.unique(ks))
        return bool((cursors + demand <= self.map.cap_local).all())

    def grow_for(self, ks: np.ndarray) -> None:
        """Online growth across the shards: migrate every chain to a map
        with doubled per-shard pools and bucket count in bounded drain
        rounds until the batch fits each owner shard."""
        while not self.fits(ks):
            cap = 2 * self.map.cap_local * self.map.n_shards
            nb = 2 * self.map.n_buckets
            if self._live:
                self.map.grow_to(capacity=cap, n_buckets=nb)
            else:
                self.map, _ = self.map.migrate_to(capacity=cap,
                                                  n_buckets=nb)
            self.migrations += 1
            get_registry().counter("dedup_migrations_total").inc()

    def update(self, ops: np.ndarray, ks: np.ndarray):
        return self.map.update(ops, ks, ks)

    def lookup(self, ks: np.ndarray) -> np.ndarray:
        found, _ = self.map.lookup(ks)
        return found


class MembershipIndex:
    """Growable set-membership index on the durable map.

    Keys are arbitrary ints.  Keys in ``[0, 2**31-2]`` are stored in the
    int32-keyed map as ``key + 1``; the rare out-of-range key falls back
    to a Python-set side table rather than wrapping.  :meth:`update`
    commits adds and removes in one mixed plan/commit round; a removed
    key's node is resurrected if the key returns.  A batch whose fresh
    inserts would not fit (checked exactly, per owner shard on the
    sharded backend) first grows the map online.

    ``n_shards`` runs the map bucket-range-sharded over that many shards
    on ``device``; ``auto_rebalance`` (sharded only, ignored without
    ``n_shards`` as in the reference) lets skewed member
    streams re-split the shard boundaries under live index traffic
    (:attr:`rebalances` counts completions)."""

    def __init__(self, capacity: int = 4096, n_buckets: int = N_BUCKETS,
                 n_shards: Optional[int] = None,
                 auto_rebalance: bool = False, device=None):
        self.n_buckets = n_buckets
        self.capacity = capacity
        self.n_shards = n_shards
        if n_shards is None:
            self._backend = _SingleBackend(capacity, n_buckets, device)
        else:
            self._backend = _ShardedBackend(capacity, n_buckets, n_shards,
                                            device, auto_rebalance)
        self._members: set = set()               # live in-range members
        self._oob: set = set()     # members outside the int32 key space
        self.last_stats = None

    @property
    def state(self):
        """The backing map state (``HashMapState`` or ``ShardedState``)."""
        return self._backend.state

    @property
    def migrations(self) -> int:
        """Online growth migrations the backend has run so far."""
        return self._backend.migrations

    @property
    def rebalances(self) -> int:
        """Live cross-shard re-splits completed (0 unless the backend was
        opted in with ``auto_rebalance``)."""
        return getattr(self._backend, "rebalances", 0)

    @staticmethod
    def _in_range(k: int) -> bool:
        return 0 <= k < 2**31 - 1

    @property
    def members(self) -> set:
        """The current member set (copy), side-table keys included."""
        return self._members | self._oob

    def update(self, add_keys: Iterable[int] = (),
               remove_keys: Iterable[int] = ()) -> None:
        """Commit adds and removes in one mixed plan/commit round.  Batch
        order is adds-then-removes, so a key named in both leaves."""
        adds = {int(k) for k in add_keys}
        rems = {int(k) for k in remove_keys}
        self._oob.update(k for k in adds if not self._in_range(k))
        self._oob.difference_update(k for k in rems
                                    if not self._in_range(k))
        ins_set = {k for k in adds
                   if self._in_range(k) and k not in self._members}
        del_set = {k for k in rems if self._in_range(k)
                   and (k in self._members or k in ins_set)}
        ins = np.asarray(sorted(ins_set), np.int32)
        dels = np.asarray(sorted(del_set), np.int32)
        if ins.size + dels.size == 0:
            return
        if not self._backend.fits(ins + 1):
            self._backend.grow_for(ins + 1)
            self.capacity = self._backend.capacity
        ks = np.concatenate([ins, dels]) + 1
        ops = np.concatenate([
            np.full(ins.size, batched.OP_INSERT, np.int32),
            np.full(dels.size, batched.OP_DELETE, np.int32)])
        okh, self.last_stats = self._backend.update(ops, ks)
        # every planned insert is a non-member and growth ran first, so a
        # failed insert here means the growth arithmetic is wrong
        if not okh[:ins.size].all():
            raise RuntimeError("membership insert dropped")
        self._members.update(int(k) for k in ins[okh[:ins.size]])
        self._members.difference_update(
            int(k) for k in dels[okh[ins.size:]])

    def add(self, keys: Iterable[int]) -> None:
        self.update(add_keys=keys)

    def remove(self, keys: Iterable[int]) -> None:
        """Logical batched delete; a later re-add resurrects the node."""
        self.update(remove_keys=keys)

    def contains(self, keys: Sequence[int]) -> np.ndarray:
        keys = [int(k) for k in keys]
        out = np.zeros(len(keys), np.bool_)
        in_range = [(i, k) for i, k in enumerate(keys)
                    if self._in_range(k)]
        if in_range:
            pos, ks = zip(*in_range)
            ks = np.asarray(ks, np.int32)
            out[list(pos)] = self._backend.lookup(ks + 1)
        for i, k in enumerate(keys):
            if not self._in_range(k):
                out[i] = k in self._oob
        return out


class OrderedMembershipIndex:
    """Membership index on the batch-parallel ordered map: the same
    ``update``/``contains``/``members`` surface as
    :class:`MembershipIndex`, plus :meth:`expired` (which members fall
    below a retention horizon, from one top-k walk and one
    tower-descended range read) and :meth:`range_members`.  The serving
    :class:`~repro_torch.serving.engine.RequestLog` uses it in its
    ``ordered_dedup`` mode.

    Same int32 key envelope as the hash index: in-range keys are stored
    shifted by +1 (node 0 is the ordered map's head sentinel), others
    fall back to a side set, which the ordered reads do not cover.
    Growth doubles the node pool and rebuilds it from the live member set
    (:attr:`migrations` counts the rebuilds)."""

    rebalances = 0      # single-device pool: never re-splits

    def __init__(self, capacity: int = 4096, max_level: int = 8,
                 device=None):
        self.device = batched.resolve_device(device)
        self.capacity = capacity
        self.max_level = max_level
        self.state = ordered.make_ordered(capacity, self.device)
        self._towers = ordered.build_towers(self.state, max_level)
        self._members: set = set()
        self._oob: set = set()
        self.migrations = 0
        self.last_stats = None

    _in_range = staticmethod(MembershipIndex._in_range)

    @property
    def members(self) -> set:
        return self._members | self._oob

    def _grow_for(self, n_fresh: int) -> None:
        need = int(self.state.cursor) + n_fresh
        while self.capacity < need:
            self.capacity *= 2
        self.state = ordered.make_ordered(self.capacity, self.device)
        live = np.asarray(sorted(self._members), np.int32)
        if live.size:
            self.state, ok, _ = ordered.update_parallel_ordered(
                self.state, np.zeros(live.size, np.int32), live + 1,
                live + 1, max_level=self.max_level)
            if not bool(ok.all()):
                raise RuntimeError("ordered membership rebuild dropped keys")
        self._towers = ordered.build_towers(self.state, self.max_level)
        self.migrations += 1

    def update(self, add_keys: Iterable[int] = (),
               remove_keys: Iterable[int] = ()) -> None:
        """One mixed plan/commit round; a key named in both leaves (adds
        batch first, removes last)."""
        adds = {int(k) for k in add_keys}
        rems = {int(k) for k in remove_keys}
        self._oob.update(k for k in adds if not self._in_range(k))
        self._oob.difference_update(k for k in rems
                                    if not self._in_range(k))
        ins_set = {k for k in adds
                   if self._in_range(k) and k not in self._members}
        del_set = {k for k in rems if self._in_range(k)
                   and (k in self._members or k in ins_set)}
        ins = np.asarray(sorted(ins_set), np.int32)
        dels = np.asarray(sorted(del_set), np.int32)
        if ins.size + dels.size == 0:
            return
        if int(self.state.cursor) + ins.size > self.capacity:
            # the bound is exact here: every planned insert is a
            # non-member, and dead nodes resurrect without allocating
            n_dead = len(self._dead_keys() & ins_set)
            if int(self.state.cursor) + ins.size - n_dead > self.capacity:
                self._grow_for(ins.size - n_dead)
        ks = np.concatenate([ins, dels]) + 1
        ops = np.concatenate([
            np.full(ins.size, batched.OP_INSERT, np.int32),
            np.full(dels.size, batched.OP_DELETE, np.int32)])
        self.state, ok, self.last_stats = \
            ordered.update_parallel_ordered(
                self.state, ops, ks, ks, towers=self._towers,
                max_level=self.max_level)
        ok = ok.cpu().numpy()
        if not ok[:ins.size].all():
            raise RuntimeError("ordered membership insert dropped")
        self._towers = ordered.build_towers(self.state, self.max_level)
        self._members.update(int(k) for k in ins[ok[:ins.size]])
        self._members.difference_update(
            int(k) for k in dels[ok[ins.size:]])

    def _dead_keys(self) -> set:
        return {k - 1 for k, (lv, _) in
                ordered.items_host(self.state).items() if not lv}

    def add(self, keys: Iterable[int]) -> None:
        self.update(add_keys=keys)

    def remove(self, keys: Iterable[int]) -> None:
        self.update(remove_keys=keys)

    def contains(self, keys: Sequence[int]) -> np.ndarray:
        keys = [int(k) for k in keys]
        out = np.zeros(len(keys), np.bool_)
        in_range = [(i, k) for i, k in enumerate(keys)
                    if self._in_range(k)]
        if in_range:
            pos, ks = zip(*in_range)
            found, _ = ordered.lookup_ordered(
                self.state, np.asarray(ks, np.int32) + 1, self._towers)
            out[list(pos)] = found.cpu().numpy()
        for i, k in enumerate(keys):
            if not self._in_range(k):
                out[i] = k in self._oob
        return out

    def range_members(self, lo: int, hi: int, max_items: int) -> list:
        """Ascending live members in ``[lo, hi]`` (an ordered read: a
        pure journey)."""
        total, ks, _ = ordered.range_query(
            self.state, lo + 1, hi + 1, max_items, self._towers)
        m = min(int(total), max_items)
        return [int(k) - 1 for k in ks[:m].tolist()]

    def expired(self, retain: int) -> list:
        """Members below the retention horizon, ascending: all but the
        ``retain`` largest (in-range) members."""
        n_live = len(self._members)
        n_evict = n_live - retain
        if n_evict <= 0:
            return []
        cnt, tk, _ = ordered.top_k(self.state, retain + 1)
        if int(cnt) <= retain:               # fewer live than retain+1
            return []
        # tk is ascending: tk[0] is the (retain+1)-th largest stored key,
        # the largest member to evict (inclusive)
        horizon = int(tk[0])
        return self.range_members(ordered.KEY_MIN, horizon - 1, n_evict)


def live_step_index(manifests, keep_files: Iterable[str],
                    idx: Optional[MembershipIndex] = None,
                    device=None) -> MembershipIndex:
    """Index of every step that must survive a trim pass: steps with a
    surviving manifest plus the owner steps of every delta-referenced
    file.  A given ``idx`` is updated in place (newly live steps enter,
    since-died steps leave, in one mixed round) instead of rebuilt; a new
    one is made on ``device``."""
    steps = set()
    for man in manifests:
        steps.add(man.step)
    for rel in keep_files:
        steps.add(owner_step(rel))
    if idx is None:
        idx = MembershipIndex(device=device)
    idx.update(steps, idx.members - steps)
    return idx
