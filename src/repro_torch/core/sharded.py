"""Sharded durable map: bucket-range partitioning of the plan/commit engine
(port of ``repro.core.sharded``).

The NVTraverse split is shard-local.  The *plan* phase (the journey)
reads a snapshot and does no persistence work, and the *commit* phase
(the destination) only touches one bucket chain, so partitioning the node
pool and the bucket heads by **bucket range** keeps every flush and fence
inside the shard that owns the bucket.

Layout (:class:`ShardedState`): the single-device
:class:`~repro_torch.core.batched.HashMapState` with a leading shard axis.
Shard ``s`` owns global buckets ``[splits[s], splits[s+1])`` and a private
node pool with its own bump cursor; every shard's head row is padded to
the widest range.  The engine commits a shard's ops with
``update_parallel(..., nb_global=n_buckets, base=splits[s])``, so a key
lands in the same global bucket it would occupy unsharded and the
gathered map is a bucket-permutation-equivalent of the single-device map.

All ``S`` shards live on one device, in ``[S, ...]`` tensors.  The
reference routes ops between devices with one ``all_to_all``; here the
exchange is one index permutation that builds each shard's receive buffer
exactly as the reference's collective leaves it: the batch is padded so
each source slice is the same power-of-two length (pads invalid, routed
to shard 0), each source groups its slice by owner shard with a stable
sort, and shard ``d``'s buffer holds source ``src``'s group at block
``src``, zero-filled behind it.  The buffer is in global batch order, so
each shard's plan/commit round composes duplicate-key ops exactly as the
single-device engine would, and its state arrays, per-op ``ok`` and
:class:`ShardCommitStats` equal the reference's bit for bit.  The shards
commit one after another.

Accounting: per-shard stats come back stacked, ``bucket_flushes`` on the
global bucket axis (the locality proof: nonzero only inside each shard's
own range), and ``foreign_ops`` counts ops a shard received for buckets
outside its range (always 0 unless routing is broken).
:meth:`ShardedDurableMap.migrate_to` drains a map into a new geometry in
bounded rounds, each an ordinary routed insert, and
:meth:`ShardedDurableMap.rebalance` re-splits a map in place that way.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import batched
from ..obs.compile import get_tracker
from ..obs.metrics import get_registry

_FIELDS = ("key", "val", "nxt", "live", "head", "cursor", "flushes",
           "fences")


class ShardedState(NamedTuple):
    """:class:`~repro_torch.core.batched.HashMapState` with a leading
    shard axis; row ``s`` is shard ``s``'s node pool and bucket heads."""
    key: torch.Tensor       # int32[S, cap_local]
    val: torch.Tensor       # int32[S, cap_local]
    nxt: torch.Tensor       # int32[S, cap_local]
    live: torch.Tensor      # bool[S, cap_local]
    head: torch.Tensor      # int32[S, nb_max]
    cursor: torch.Tensor    # int32[S]  per-shard bump allocator
    flushes: torch.Tensor   # int32[S]  per-shard persistence accounting
    fences: torch.Tensor    # int32[S]


class ShardCommitStats(NamedTuple):
    """Per-shard :class:`~repro_torch.core.batched.CommitStats`, stacked
    as host int32 arrays: every field but ``bucket_flushes`` is
    ``int32[S]``; ``bucket_flushes`` is ``int32[n_buckets]`` on the global
    bucket axis.  ``foreign_ops[s]`` counts valid ops shard ``s``
    received for a bucket outside its range."""
    ops_committed: np.ndarray
    conflict_groups: np.ndarray
    max_group: np.ndarray
    coalesced_flushes: np.ndarray
    coalesced_fences: np.ndarray
    foreign_ops: np.ndarray
    bucket_flushes: np.ndarray

    @property
    def total_ops_committed(self) -> int:
        return int(np.sum(self.ops_committed))

    @property
    def total_coalesced_flushes(self) -> int:
        return int(np.sum(self.coalesced_flushes))

    @property
    def global_coalesced_fences(self) -> int:
        """Shards commit concurrently, so their fences overlap: the batch
        needs ``2 x (largest same-bucket group on any shard)`` fences."""
        return int(np.max(self.coalesced_fences))


def shard_host(host: dict, s: int) -> dict:
    """Shard ``s``'s row of a host snapshot, in ``drain_range``'s form."""
    return {f: np.asarray(host[f][s]) for f in _FIELDS}


def items_of_state(state) -> dict:
    """``{key: (live, val)}`` over every allocated node of a single-device
    map (a ``HashMapState`` or its host dict): the map's abstract content,
    dead nodes included."""
    st = state if isinstance(state, dict) else batched.state_to_numpy(state)
    c = int(st["cursor"])
    return {int(k): (bool(l), int(v))
            for k, l, v in zip(st["key"][1:c], st["live"][1:c],
                               st["val"][1:c])}


def even_splits(n_buckets: int, n_shards: int) -> Tuple[int, ...]:
    """The default contiguous-range boundaries: ``n_shards`` equal ranges.

    >>> even_splits(64, 4)
    (0, 16, 32, 48, 64)
    """
    if n_buckets % n_shards:
        raise ValueError(
            f"n_buckets={n_buckets} not divisible by n_shards={n_shards}"
            " (pass explicit splits= for uneven ranges)")
    w = n_buckets // n_shards
    return tuple(s * w for s in range(n_shards)) + (n_buckets,)


class RebalanceReport(NamedTuple):
    """What a re-split or migration did, and the proof it kept persistence
    local to the *new* owner ranges."""
    rounds: int
    migrated: int               # live keys drained into the new map
    foreign_ops: int            # sum over rounds and shards (must be 0)
    bucket_flushes: np.ndarray  # int32[n_buckets_new] summed over rounds
    splits_old: Tuple[int, ...]
    splits_new: Tuple[int, ...]
    chain_before: Tuple[int, float]
    chain_after: Tuple[int, float]


def _route(owner: torch.Tensor, S: int, per: int) -> torch.Tensor:
    """Each padded op's slot in the stacked ``[S, S*per]`` receive
    buffers: shard ``owner``'s buffer, block ``src = i // per``, after the
    earlier ops of the same source with the same owner (the reference's
    stable owner sort and tiled all_to_all).  Returns flat int64 slots."""
    n = owner.shape[0]
    src = torch.arange(n, device=owner.device) // per
    group = src * S + owner.long()
    order = torch.argsort(group, stable=True)
    counts = torch.bincount(group, minlength=S * S)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(group)
    rank[order] = torch.arange(n, device=owner.device) - starts[group[order]]
    return owner.long() * (S * per) + src * per + rank


class ShardedDurableMap:
    """Bucket-range-sharded durable map running the plan/commit engine
    per shard, all shards on one device.

    ``capacity`` is the *total* node budget (split evenly; each shard
    reserves its own null node 0).  ``splits`` (optional, ``S+1``
    strictly increasing boundaries from 0 to ``n_buckets``) assigns shard
    ``s`` the global bucket range ``[splits[s], splits[s+1])``; the
    default is the even partition.  ``device`` (``None`` = the card)
    holds every shard."""

    def __init__(self, n_shards: int = 1, *, capacity: int = 1 << 16,
                 n_buckets: int = 1024,
                 splits: Optional[Sequence[int]] = None, device=None):
        self.device = batched.resolve_device(device)
        self.n_shards = int(n_shards)
        if splits is None:
            splits = even_splits(n_buckets, self.n_shards)
        self.splits = tuple(int(b) for b in splits)
        if (len(self.splits) != self.n_shards + 1
                or self.splits[0] != 0 or self.splits[-1] != n_buckets
                or any(a >= b for a, b in zip(self.splits,
                                              self.splits[1:]))):
            raise ValueError(
                f"splits={splits} must be {self.n_shards + 1} strictly "
                f"increasing boundaries from 0 to {n_buckets}")
        self.n_buckets = n_buckets
        self.sizes = tuple(b - a for a, b in zip(self.splits,
                                                 self.splits[1:]))
        self.nb_max = max(self.sizes)       # head width (ranges padded)
        self.capacity = capacity
        self.cap_local = -(-capacity // self.n_shards)
        S, C, NBM, dev = self.n_shards, self.cap_local, self.nb_max, \
            self.device
        i32 = torch.int32
        self.state = ShardedState(
            key=torch.zeros((S, C), dtype=i32, device=dev),
            val=torch.zeros((S, C), dtype=i32, device=dev),
            nxt=torch.full((S, C), batched.NIL, dtype=i32, device=dev),
            live=torch.zeros((S, C), dtype=torch.bool, device=dev),
            head=torch.full((S, NBM), batched.NIL, dtype=i32, device=dev),
            cursor=torch.ones(S, dtype=i32, device=dev),
            flushes=torch.zeros(S, dtype=i32, device=dev),
            fences=torch.zeros(S, dtype=i32, device=dev))
        self._bounds = torch.tensor(self.splits, dtype=i32, device=dev)
        # first-call seam: the first round per argument-shape signature
        # is timed and attributed to the active reason (re-split, growth)
        self._cfg = f"S={S},nb={n_buckets},nb_max={NBM}"
        self._metrics = get_registry()
        # seconds spent in the per-shard engine loop (the shards commit
        # one after another on one device)
        self.loop_s = 0.0

    # ---------------- the routed rounds -------------------------------- #
    def _pad(self, *arrs: np.ndarray):
        """Pad the batch so each source slice is the same power-of-two
        length; pad slots are ``valid=False`` and transparent."""
        n = arrs[0].shape[0]
        per = -(-max(n, 1) // self.n_shards)
        per = 1 << (per - 1).bit_length()
        total = per * self.n_shards
        out = [torch.as_tensor(np.concatenate(
            [a, np.zeros(total - n, a.dtype)]), device=self.device)
            for a in arrs]
        valid = torch.as_tensor(np.arange(total) < n, device=self.device)
        return out, valid, per

    def _owner(self, ks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        b = batched.bucket_of(ks, self.n_buckets)
        owner = torch.searchsorted(self._bounds, b, right=True).to(
            torch.int32) - 1
        return torch.where(valid, owner, 0)

    def _receive(self, ks, cols, valid, per):
        """Route op columns to every shard by ``ks``'s owners: returns the
        flat slots and each column (``valid`` last) as ``[S, S*per]``
        receive buffers, zero-filled behind each block."""
        S = self.n_shards
        flat = _route(self._owner(ks, valid), S, per)
        out = []
        for c in cols + [valid]:
            buf = torch.zeros(S * S * per, dtype=c.dtype, device=c.device)
            buf[flat] = c
            out.append(buf.view(S, S * per))
        return flat, out

    def _shard(self, state: ShardedState, s: int) -> batched.HashMapState:
        return batched.HashMapState(*(f[s] for f in state))

    def _update_round(self, state, ops, ks, vs, valid, per):
        """One routed round: every shard commits its receive buffer."""
        flat, (r_ops, r_ks, r_vs, r_valid) = self._receive(
            ks, [ops, ks, vs], valid, per)
        rows, oks, stats = [], [], []
        t0 = time.perf_counter()
        for s in range(self.n_shards):
            base, size = self.splits[s], self.sizes[s]
            g = batched.bucket_of(r_ks[s], self.n_buckets) - base
            foreign = (r_valid[s] & ((g < 0) | (g >= size))).sum()
            st, ok, cs = batched.update_parallel(
                self._shard(state, s), r_ops[s], r_ks[s], r_vs[s],
                self.nb_max, valid=r_valid[s], nb_global=self.n_buckets,
                base=base)
            rows.append(st)
            oks.append(ok)
            stats.append(torch.stack([
                cs.ops_committed, cs.conflict_groups, cs.max_group,
                cs.coalesced_flushes, cs.coalesced_fences,
                foreign.to(torch.int32)]))
            stats.append(cs.bucket_flushes)
        if state.key.is_cuda:        # the caller syncs next anyway
            torch.cuda.synchronize(state.key.device)
        self.loop_s += time.perf_counter() - t0
        new = ShardedState(*(torch.stack([getattr(r, f) for r in rows])
                             for f in ShardedState._fields))
        ok = torch.cat(oks)[flat]
        return new, ok, torch.cat(stats)

    def _probe_round(self, state, ks, valid, per):
        flat, (r_ks, _) = self._receive(ks, [ks], valid, per)
        outs = []
        for s in range(self.n_shards):
            ex, live, vals = batched.probe(
                self._shard(state, s), r_ks[s], self.nb_max,
                nb_global=self.n_buckets, base=self.splits[s])
            outs.append(torch.stack([ex.to(torch.int32),
                                     live.to(torch.int32), vals]))
        return torch.cat(outs, 1)[:, flat]

    # ---------------- host API ----------------------------------------- #
    def update(self, ops, ks, vs) -> Tuple[np.ndarray, ShardCommitStats]:
        """One mixed plan/commit round over the whole map: route each op
        to its owner shard, commit per shard, return per-op ``ok`` in
        batch order and the stacked per-shard stats."""
        ops = np.asarray(ops, np.int32)
        ks = np.asarray(ks, np.int32)
        vs = np.asarray(vs, np.int32)
        n = ks.shape[0]
        if n == 0:
            return np.zeros(0, np.bool_), None
        (ops_p, ks_p, vs_p), valid, per = self._pad(ops, ks, vs)
        fn = get_tracker().instrument("sharded.update", self._cfg,
                                      self._update_round)
        self.state, ok, packed = fn(self.state, ops_p, ks_p, vs_p, valid,
                                    per)
        S, NBM = self.n_shards, self.nb_max
        packed = packed.cpu().numpy()
        rows = packed.reshape(S, 6 + NBM)
        bf = rows[:, 6:]
        stats = ShardCommitStats(
            *(np.ascontiguousarray(rows[:, i]) for i in range(6)),
            bucket_flushes=np.concatenate(
                [bf[s, :w] for s, w in enumerate(self.sizes)]))
        self._export_stats(stats)
        return ok.cpu().numpy()[:n], stats

    def _export_stats(self, stats: ShardCommitStats) -> None:
        """Mirror one round's commit accounting onto the metrics
        registry: flush/fence totals, the routing invariant and per-shard
        committed-op load."""
        m = self._metrics
        committed = stats.ops_committed
        m.counter("map_commit_ops_total").inc(int(committed.sum()))
        m.counter("map_commit_flushes_total").inc(
            int(stats.coalesced_flushes.sum()))
        m.counter("map_commit_fences_total").inc(
            int(stats.coalesced_fences.max(initial=0)))
        m.counter("map_foreign_ops_total").inc(int(stats.foreign_ops.sum()))
        for s in range(self.n_shards):
            m.counter("map_shard_ops_total", shard=str(s)).inc(
                int(committed[s]))

    def owners_of(self, ks) -> np.ndarray:
        """Owner shard of each key under the current split (host twin of
        the routing, for the exact per-shard fit checks)."""
        b = batched.bucket_of_np(np.asarray(ks, np.int32), self.n_buckets)
        return (np.searchsorted(np.asarray(self.splits), b,
                                side="right") - 1).astype(np.int32)

    def insert(self, ks, vs):
        ks = np.asarray(ks, np.int32)
        return self.update(np.full(ks.shape, batched.OP_INSERT, np.int32),
                           ks, vs)

    def delete(self, ks):
        ks = np.asarray(ks, np.int32)
        return self.update(np.full(ks.shape, batched.OP_DELETE, np.int32),
                           ks, np.zeros_like(ks))

    def lookup(self, ks) -> Tuple[np.ndarray, np.ndarray]:
        """Batched lookup (the journey: no persistence work on any shard):
        ``(found bool[n], vals int32[n])``; a not-found key's val is 0."""
        _, found, vals = self.probe(ks)
        return found, np.where(found, vals, 0).astype(np.int32)

    def probe(self, ks) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Node-level probe across shards: ``(exists, live, vals)``,
        ``exists`` True iff the key holds a node at all, dead included."""
        ks = np.asarray(ks, np.int32)
        n = ks.shape[0]
        if n == 0:
            z = np.zeros(0, np.bool_)
            return z, z, np.zeros(0, np.int32)
        (ks_p,), valid, per = self._pad(ks)
        fn = get_tracker().instrument("sharded.lookup", self._cfg,
                                      self._probe_round)
        back = fn(self.state, ks_p, valid, per).cpu().numpy()
        return (back[0, :n].astype(np.bool_), back[1, :n].astype(np.bool_),
                back[2, :n].astype(np.int32))

    def host(self) -> dict:
        """The state as stacked host numpy arrays (copied)."""
        return {f: getattr(self.state, f).to("cpu", copy=True).numpy()
                for f in ShardedState._fields}

    def items(self) -> dict:
        """Gathered abstract content ``{key: (live, val)}``; keys are
        disjoint across shards, so the union is exact."""
        host = self.host()
        out = {}
        for s in range(self.n_shards):
            out.update(items_of_state(shard_host(host, s)))
        return out

    @property
    def flushes(self) -> int:
        """Per-op flush accounting summed over shards (equals the
        single-device engine's on the same ops)."""
        return int(self.state.flushes.sum())

    @property
    def fences(self) -> int:
        return int(self.state.fences.sum())

    @property
    def cursor_max(self) -> int:
        return int(self.state.cursor.max())

    @property
    def cursors(self) -> np.ndarray:
        """Per-shard bump cursors (``int64[S]``)."""
        return self.state.cursor.cpu().numpy().astype(np.int64)

    def fresh_demand(self, ks) -> np.ndarray:
        """Per-shard allocation demand (``int64[S]``) of a batch of
        distinct insert keys: only keys without a node (live or dead)
        allocate, each in its owner shard."""
        ks = np.asarray(ks, np.int32)
        exists, _, _ = self.probe(ks)
        return np.bincount(self.owners_of(ks[~exists]),
                           minlength=self.n_shards).astype(np.int64)

    def load_state(self, arrays: dict) -> None:
        """Adopt a host snapshot (field name -> stacked ``[S, ...]``
        numpy array) as this map's state; the geometry must match."""
        self.state = ShardedState(**{
            f: torch.tensor(np.asarray(arrays[f]),
                            dtype=batched._DTYPES[f], device=self.device)
            for f in ShardedState._fields})

    def chain_stats(self) -> Tuple[int, float]:
        """Global (max, mean) chain length over every shard's *owned*
        buckets (the padding of an uneven split is excluded)."""
        mx, total = 0, 0.0
        for s, w in enumerate(self.sizes):
            local = self._shard(self.state, s)
            local = local._replace(head=local.head[:w])
            m, mean = batched.chain_stats(local, w)
            mx = max(mx, int(m))
            total += float(mean) * w
        return mx, total / self.n_buckets

    # ---------------- migration ---------------------------------------- #
    def migrate_to(self, *, capacity: Optional[int] = None,
                   n_buckets: Optional[int] = None,
                   splits: Optional[Sequence[int]] = None,
                   buckets_per_round: Optional[int] = None,
                   ) -> Tuple["ShardedDurableMap", RebalanceReport]:
        """Drain this map into a fresh one (new boundaries and/or a larger
        pool and/or another bucket count) in bounded rounds of
        ``buckets_per_round`` old global buckets, each round one ordinary
        routed insert on the new map.  Returns ``(new_map, report)``; the
        old map is left frozen."""
        nb_new = n_buckets or self.n_buckets
        if splits is None:
            if nb_new == self.n_buckets:
                splits = self.splits
            elif nb_new % self.n_buckets == 0:
                # bucket growth keeps the split's shape
                f = nb_new // self.n_buckets
                splits = tuple(b * f for b in self.splits)
            else:
                raise ValueError(
                    f"n_buckets={nb_new} is not a multiple of the "
                    f"current {self.n_buckets}; pass splits= explicitly "
                    f"to re-shape the ranges")
        reason = ("capacity_ladder" if (capacity or n_buckets)
                  else "resplit_width_change")
        new = ShardedDurableMap(
            self.n_shards, capacity=capacity or self.capacity,
            n_buckets=nb_new, splits=splits, device=self.device)
        bpr = buckets_per_round or max(1, self.n_buckets // 8)
        chain_before = self.chain_stats()
        from .migrate import drain_range
        host = self.host()
        shards = [shard_host(host, s) for s in range(self.n_shards)]
        rounds = migrated = foreign = 0
        bf_total = np.zeros(new.n_buckets, np.int64)
        with get_tracker().reason(reason):
            for lo in range(0, self.n_buckets, bpr):
                hi = min(lo + bpr, self.n_buckets)
                parts = []
                for s in range(self.n_shards):   # split order = global
                    a = max(lo, self.splits[s])  # bucket-ascending order
                    b = min(hi, self.splits[s + 1])
                    if a < b:
                        parts.append(drain_range(
                            shards[s], a - self.splits[s],
                            b - self.splits[s]))
                ks = np.concatenate([p[0] for p in parts])
                vs = np.concatenate([p[1] for p in parts])
                rounds += 1
                if not ks.size:
                    continue
                ok, stats = new.insert(ks, vs)
                if not ok.all():
                    raise RuntimeError(
                        f"rebalance drain overflowed the new pool at "
                        f"global bucket {lo} (capacity {new.capacity})")
                migrated += int(ks.size)
                foreign += int(stats.foreign_ops.sum())
                bf_total += stats.bucket_flushes
        m = get_registry()
        m.counter("map_drain_rounds_total").inc(rounds)
        m.counter("map_drained_keys_total").inc(migrated)
        return new, RebalanceReport(
            rounds=rounds, migrated=migrated, foreign_ops=foreign,
            bucket_flushes=bf_total.astype(np.int32),
            splits_old=self.splits, splits_new=new.splits,
            chain_before=chain_before, chain_after=new.chain_stats())

    def rebalance(self, splits: Sequence[int], *,
                  buckets_per_round: Optional[int] = None
                  ) -> RebalanceReport:
        """Re-split the bucket ranges in place (see :meth:`migrate_to`):
        the handle survives, only the split and the node placement
        change."""
        new, report = self.migrate_to(splits=splits,
                                      buckets_per_round=buckets_per_round)
        self.__dict__.update(new.__dict__)
        return report
