"""Online migration engine: grow a durable map into a larger pool and
bucket count in bounded NVTraverse-correct rounds (port of
``repro.core.migrate``).

Each round drains a contiguous range of old buckets -- bucket ascending,
chain head to tail, live nodes only -- and commits it into the new table
as one plan/commit batch, so every migrated key pays the paper's O(1)
flushes + 2 fences at its destination and nothing on the journey.  The
drain order is canonical, so the migrated table is bit-identical to the
reference's.

The protocol (see the reference module for the full argument): the old
table is frozen from ``start_migration`` on; the new table is
authoritative per key, dead nodes included; lookups are new-then-old;
a user batch during migration commits as one mixed round of
``[pull-inserts; user ops]``; and every round, drain or user, is journaled
(``round_NNNNNN.npz``) with flush -> fence -> atomic publish under a
:class:`MigrationState` header, so :meth:`MigratingMap.recover` replays
the journal to a state bit-identical to a round boundary.  The journal
files are byte-identical to the reference's: a journal written by either
package recovers in the other.
"""
from __future__ import annotations

import io as _io
import json
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import batched as B
from ..obs.compile import get_tracker
from ..obs.metrics import get_registry

_NIL = B.NIL


class MigrationState(NamedTuple):
    """The durable migration header, small enough to publish atomically.

    ``old``/``new`` are pool handles, (capacity, n_buckets) pairs that,
    with the journaled rounds, fully determine both tables.  ``phase`` is
    ``"migrating"`` until the last drain round publishes, then ``"done"``;
    ``frontier``/``n_rounds`` are as of the header's publish (recovery
    derives live progress from the published round files).

    >>> h = MigrationState(phase="migrating", frontier=3, old=(128, 8),
    ...                    new=(512, 16), buckets_per_round=2, n_rounds=5)
    >>> MigrationState.from_bytes(h.to_bytes()) == h
    True
    """
    phase: str
    frontier: int          # global old-bucket drain frontier
    old: Tuple[int, int]   # (capacity, n_buckets) of the frozen old pool
    new: Tuple[int, int]   # (capacity, n_buckets) of the growing new pool
    buckets_per_round: int
    n_rounds: int          # journaled rounds (drain + user)

    def to_bytes(self) -> bytes:
        return json.dumps(self._asdict(), sort_keys=True).encode()

    @staticmethod
    def from_bytes(b: bytes) -> "MigrationState":
        d = json.loads(b.decode())
        return MigrationState(phase=d["phase"], frontier=d["frontier"],
                              old=tuple(d["old"]), new=tuple(d["new"]),
                              buckets_per_round=d["buckets_per_round"],
                              n_rounds=d["n_rounds"])


class MigrationReport(NamedTuple):
    rounds: int            # drain rounds run
    migrated: int          # live keys drained into the new table
    skipped: int           # drained keys already owned by the new table
    max_round_batch: int   # largest drain batch (bounded-round proof)


# --------------------------------------------------------------------- #
# durable round machinery                                                #
# --------------------------------------------------------------------- #
class RoundJournal:
    """Durable round journal through a
    :class:`repro_torch.persistence.manifest.StagedIO`: a frozen-source
    snapshot (``old.npz``, flushed once at start), a JSON header
    (``state.json``, published atomically at start and at finish), and
    numbered round records (``round_NNNNNN.npz``), each written flush ->
    fence -> atomic publish -- the rename is the commit point, so a crash
    mid-round rolls the journal back to exactly the previous round.  The
    journal never interprets the arrays it stores; callers replay them
    through their own deterministic engine."""

    def __init__(self, io, dirname: str):
        self.io = io
        self.d = dirname
        self.n_rounds = 0

    def write_snapshot(self, arrays: dict, name: str = "old.npz") -> None:
        """Flush the frozen drain source (the header's publish commits
        the whole start)."""
        buf = _io.BytesIO()
        np.savez(buf, **arrays)
        self.io.write(f"{self.d}/{name}", buf.getvalue())
        self.io.flush(f"{self.d}/{name}")

    def publish_header(self, payload: bytes) -> None:
        """flush(header) -> fence -> atomic publish of ``state.json``."""
        self.io.write(f"{self.d}/state.tmp", payload)
        self.io.flush(f"{self.d}/state.tmp")
        self.io.fence()
        self.io.publish(f"{self.d}/state.tmp", f"{self.d}/state.json")

    def append(self, **arrays) -> None:
        """Durably commit one round: flush(record) -> fence -> publish."""
        buf = _io.BytesIO()
        np.savez(buf, **arrays)
        tmp = f"{self.d}/round.tmp"
        self.io.write(tmp, buf.getvalue())
        self.io.flush(tmp)
        self.io.fence()
        self.io.publish(tmp, f"{self.d}/round_{self.n_rounds:06d}.npz")
        self.n_rounds += 1

    @staticmethod
    def newest_dir(root, prefix: str) -> Optional[str]:
        """Newest journal dir (``<prefix>_NNNN``) with a published header,
        or None."""
        digs = sorted(p.name for p in Path(root).glob(f"{prefix}_*")
                      if (p / "state.json").exists())
        return digs[-1] if digs else None

    @staticmethod
    def read(root, dirname: str, snapshot: str = "old.npz"):
        """Load one journal: ``(header bytes, snapshot dict, rounds)``,
        rounds as dicts in publish order (the replay order)."""
        root = Path(root)
        hdr = (root / dirname / "state.json").read_bytes()
        snap_npz = np.load(
            _io.BytesIO((root / dirname / snapshot).read_bytes()))
        snap = {k: np.asarray(snap_npz[k]) for k in snap_npz.files}
        rounds = []
        for rp in sorted((root / dirname).glob("round_*.npz")):
            rec = np.load(_io.BytesIO(rp.read_bytes()))
            rounds.append({k: np.asarray(rec[k]) for k in rec.files})
        return hdr, snap, rounds


def _pad_pow2(*arrs, n=None, device=None):
    """Pad host arrays to the next power of two (valid-masked), so batch
    widths come from a small set.  Returns (padded tensors, valid)."""
    n = arrs[0].shape[0] if n is None else n
    total = max(1, 1 << (n - 1).bit_length())
    out = [torch.as_tensor(np.concatenate(
        [a, np.zeros(total - n, a.dtype)]), device=device) for a in arrs]
    return out, torch.as_tensor(np.arange(total) < n, device=device)


def _probe_np(state, ks: np.ndarray, n_buckets: int):
    """Host-facing :func:`repro_torch.core.batched.probe` (padded,
    trimmed)."""
    n = ks.shape[0]
    if n == 0:
        z = np.zeros(0, np.bool_)
        return z, z, np.zeros(0, np.int32)
    (pk,), _ = _pad_pow2(ks, device=state.key.device)
    ex, live, vals = B.probe(state, pk, n_buckets)
    return (ex.cpu().numpy()[:n], live.cpu().numpy()[:n],
            vals.cpu().numpy()[:n])


def host_state(state) -> dict:
    """Every field on the host as numpy (the frozen old table is read this
    way once per migration, then sliced per round)."""
    return B.state_to_numpy(state)


def live_chain_nodes(old: dict, lo: int, hi: int) -> np.ndarray:
    """The live node ids of old buckets ``[lo, hi)`` in canonical drain
    order: bucket ascending, chain head to tail (newest first) within a
    bucket.  One vectorized walk over every chain at once (a step per
    link of the longest chain), not a Python loop per node."""
    head, nxt, live = old["head"], old["nxt"], old["live"]
    node = head[lo:hi].astype(np.int64)
    bucket = np.arange(lo, hi)
    found, at_bucket, at_step = [], [], []
    step = 0
    while True:
        more = node != _NIL
        node, bucket = node[more], bucket[more]
        if not node.size:
            break
        hit = live[node]
        found.append(node[hit])
        at_bucket.append(bucket[hit])
        at_step.append(np.full(int(hit.sum()), step))
        node = nxt[node].astype(np.int64)
        step += 1
    if not found:
        return np.zeros(0, np.int64)
    order = np.lexsort((np.concatenate(at_step), np.concatenate(at_bucket)))
    return np.concatenate(found)[order]


def drain_range(old: dict, lo: int, hi: int):
    """Canonical drain order of old buckets ``[lo, hi)`` (see
    :func:`live_chain_nodes`).  Returns ``(keys, vals)`` int32."""
    nodes = live_chain_nodes(old, lo, hi)
    return (old["key"][nodes].astype(np.int32),
            old["val"][nodes].astype(np.int32))


def items_of_host(old: dict) -> dict:
    """``{key: (live, val)}`` over allocated nodes of a host-side map."""
    c = int(old["cursor"])
    return {int(k): (bool(l), int(v)) for k, l, v in
            zip(old["key"][1:c], old["live"][1:c], old["val"][1:c])}


def _run_batch(state, ops, ks, vs, n_buckets: int):
    """One padded plan/commit round; returns (state', ok numpy, stats).

    The capacity-ladder seam: the first call per (pool capacity,
    n_buckets, padded width) signature is timed to the card's completion
    and attributed to the active reason of the first-call tracker."""
    n = ks.shape[0]
    if n == 0:
        return state, np.zeros(0, np.bool_), None
    (po, pk, pv), valid = _pad_pow2(ops, ks, vs, device=state.key.device)
    trk = get_tracker()
    sig = (int(state.key.shape[0]), n_buckets, int(po.shape[0]))
    first = trk.enabled and trk.first_seen("migrate.update_parallel", sig)
    t0 = time.perf_counter()
    state, ok, stats = B.update_parallel(state, po, pk, pv, n_buckets,
                                         valid=valid)
    ok = ok.cpu().numpy()[:n]              # waits for the card
    if first:
        trk.record("migrate.update_parallel",
                   f"cap={sig[0]},nb={n_buckets},n={sig[2]}",
                   (time.perf_counter() - t0) * 1e6)
    return state, ok, stats


def migrate_state(state, n_buckets: int, new_capacity: int,
                  new_n_buckets: Optional[int] = None,
                  buckets_per_round: Optional[int] = None):
    """Journal-free full migration of ``state`` into a fresh
    ``(new_capacity, new_n_buckets)`` table on the same device, in bounded
    rounds of ``buckets_per_round`` old buckets each.  Returns
    ``(new_state, MigrationReport)``; raises if a drained insert does not
    fit (the caller sizes the new pool)."""
    nb_new = new_n_buckets or 2 * n_buckets
    bpr = buckets_per_round or max(1, n_buckets // 16)
    old = host_state(state)
    new = B.make_state(new_capacity, nb_new, device=state.key.device)
    rounds = migrated = max_batch = 0
    for lo in range(0, n_buckets, bpr):
        ks, vs = drain_range(old, lo, min(lo + bpr, n_buckets))
        ops = np.zeros(ks.shape[0], np.int32)       # all OP_INSERT
        new, ok, _ = _run_batch(new, ops, ks, vs, nb_new)
        if not ok.all():
            raise RuntimeError(
                f"migration drain overflowed the new pool "
                f"(capacity {new_capacity}) at bucket {lo}")
        rounds += 1
        migrated += ks.shape[0]
        max_batch = max(max_batch, int(ks.shape[0]))
    return new, MigrationReport(rounds=rounds, migrated=migrated,
                                skipped=0, max_round_batch=max_batch)


# --------------------------------------------------------------------- #
# the online map                                                         #
# --------------------------------------------------------------------- #
class MigratingMap:
    """Durable map with online capacity growth + rehash.

    Steady state it is a thin host wrapper over the plan/commit engine.
    When an update batch would not fit, it opens a migration to a table
    of twice the pool (and twice the buckets), then amortizes the drain
    over later traffic: every :meth:`update` first advances
    ``rounds_per_update`` migration rounds, then commits the user batch
    into the new table, pulls first.  ``root`` (optional) makes the
    migration durable through a
    :class:`repro_torch.persistence.manifest.StagedIO` journal, and
    :meth:`recover` rebuilds a bit-identical map from it after a crash.
    ``device`` places both tables (``None`` = the card)."""

    def __init__(self, capacity: int = 4096, n_buckets: int = 128, *,
                 root=None, buckets_per_round: Optional[int] = None,
                 rounds_per_update: int = 1, seed: int = 0, device=None):
        self.device = B.resolve_device(device)
        self.capacity = capacity
        self.n_buckets = n_buckets
        self.state = B.make_state(capacity, n_buckets, self.device)
        self.buckets_per_round = buckets_per_round
        self.rounds_per_update = rounds_per_update
        self.io = None
        if root is not None:
            from ..persistence.manifest import StagedIO
            self.io = StagedIO(Path(root), seed=seed)
        self._mig = None           # in-flight migration bookkeeping
        self._journal = None       # RoundJournal of the in-flight migration
        self._mig_seq = 0          # completed+started migrations (dir name)
        self.migrations_completed = 0
        self.rounds_total = 0
        self.migrated_total = 0
        self.pulls_total = 0
        self.last_stats = None

    # ---------------- steady-state + migrating op API ----------------- #
    def update(self, ops, ks, vs) -> np.ndarray:
        """One mixed plan/commit round in batch order; grows the map (via
        migration rounds) whenever the batch would not fit.  Returns
        per-op ``ok`` exactly as the engine would on an unbounded pool."""
        ops = np.asarray(ops, np.int32)
        ks = np.asarray(ks, np.int32)
        vs = np.asarray(vs, np.int32)
        if self._mig is None:
            if self._fits(self.state, self.capacity, self.n_buckets,
                          ops, ks):
                self.state, ok, self.last_stats = _run_batch(
                    self.state, ops, ks, vs, self.n_buckets)
                return ok
            self.start_migration(
                new_capacity=self._grown_capacity(ops, ks))
        for _ in range(self.rounds_per_update):
            if self._mig is not None:
                self.migrate_round()
        if self._mig is None:
            return self.update(ops, ks, vs)     # finished mid-call
        return self._commit_migrating(ops, ks, vs)

    def insert(self, ks, vs) -> np.ndarray:
        ks = np.asarray(ks, np.int32)
        return self.update(np.full(ks.shape, B.OP_INSERT, np.int32),
                           ks, vs)

    def delete(self, ks) -> np.ndarray:
        ks = np.asarray(ks, np.int32)
        return self.update(np.full(ks.shape, B.OP_DELETE, np.int32),
                           ks, np.zeros_like(ks))

    def lookup(self, ks) -> Tuple[np.ndarray, np.ndarray]:
        """New-then-old: a key with any node in the new table is answered
        from it (its dead nodes veto the old table's stale copy);
        otherwise the old table answers.  Zero persistence work."""
        ks = np.asarray(ks, np.int32)
        if self._mig is None:
            n = ks.shape[0]
            if n == 0:
                return np.zeros(0, np.bool_), np.zeros(0, np.int32)
            (pk,), _ = _pad_pow2(ks, device=self.device)
            f, v = B.lookup(self.state, pk, self.n_buckets)
            return f.cpu().numpy()[:n], v.cpu().numpy()[:n]
        m = self._mig
        ex_new, live_new, val_new = _probe_np(m["new"], ks, m["nb_new"])
        _, live_old, val_old = _probe_np(self.state, ks, self.n_buckets)
        return B.merge_new_old(ex_new, live_new, val_new,
                               live_old, val_old)

    def items(self) -> dict:
        """Abstract content ``{key: (live, val)}``, new-authoritative."""
        out = items_of_host(host_state(self.state))
        if self._mig is not None:
            out.update(items_of_host(host_state(self._mig["new"])))
        return out

    @property
    def migrating(self) -> bool:
        return self._mig is not None

    @property
    def frontier(self) -> Optional[int]:
        return None if self._mig is None else self._mig["frontier"]

    @property
    def flushes(self) -> int:
        f = int(self.state.flushes)
        if self._mig is not None:
            f += int(self._mig["new"].flushes)
        return f

    @property
    def fences(self) -> int:
        f = int(self.state.fences)
        if self._mig is not None:
            f += int(self._mig["new"].fences)
        return f

    # ---------------- capacity planning -------------------------------- #
    def _fits(self, state, capacity, n_buckets, ops, ks,
              reserve: int = 0) -> bool:
        """Exact fit check: the batch allocates one node per distinct
        absent key with at least one insert op.  The probe only runs when
        the batch-size upper bound does not already prove fitness."""
        if int(state.cursor) + ks.shape[0] + reserve <= capacity:
            return True
        ins = np.unique(ks[ops == B.OP_INSERT])
        if ins.size:
            ex, _, _ = _probe_np(state, ins, n_buckets)
            n_fresh = int((~ex).sum())
        else:
            n_fresh = 0
        return int(state.cursor) + n_fresh + reserve <= capacity

    def _grown_capacity(self, ops, ks) -> int:
        live = int(self.state.live.sum())
        need = 1 + live + ks.shape[0]
        return max(2 * self.capacity, 2 * need)

    # ---------------- migration control -------------------------------- #
    def start_migration(self, new_capacity: Optional[int] = None,
                        new_n_buckets: Optional[int] = None,
                        buckets_per_round: Optional[int] = None) -> None:
        """Freeze the current table as the drain source, open an empty
        larger table, and durably publish the :class:`MigrationState`
        header (phase=migrating, frontier=0) plus the old-pool snapshot."""
        if self._mig is not None:
            raise RuntimeError("migration already in flight")
        cap_new = new_capacity or 2 * self.capacity
        nb_new = new_n_buckets or 2 * self.n_buckets
        bpr = (buckets_per_round or self.buckets_per_round
               or max(1, self.n_buckets // 16))
        old_host = host_state(self.state)
        self._mig = {
            "new": B.make_state(cap_new, nb_new, self.device),
            "cap_new": cap_new, "nb_new": nb_new, "bpr": bpr,
            "frontier": 0, "n_rounds": 0,
            "old_host": old_host,            # frozen: one copy to the host
            "remaining_live": int(old_host["live"].sum()),
            "migrated": 0, "skipped": 0,
        }
        self._mig_seq += 1
        if self.io is not None:
            self._journal = RoundJournal(self.io, self._mig_dir())
            self._journal.write_snapshot(old_host)
            self._publish_header("migrating")

    def _mig_dir(self) -> str:
        return f"mig_{self._mig_seq:04d}"

    def _header(self, phase: str) -> MigrationState:
        m = self._mig
        return MigrationState(
            phase=phase, frontier=m["frontier"],
            old=(self.capacity, self.n_buckets),
            new=(m["cap_new"], m["nb_new"]),
            buckets_per_round=m["bpr"], n_rounds=m["n_rounds"])

    def _publish_header(self, phase: str) -> None:
        self._journal.publish_header(self._header(phase).to_bytes())

    def _journal_round(self, ops, ks, vs, frontier_after: int) -> None:
        """Durably commit one round (flush -> fence -> atomic publish)."""
        m = self._mig
        if self._journal is None:
            m["n_rounds"] += 1
            return
        self._journal.append(ops=ops, ks=ks, vs=vs,
                             frontier=np.int32(frontier_after))
        m["n_rounds"] = self._journal.n_rounds

    def migrate_round(self) -> bool:
        """Drain the next ``buckets_per_round`` old buckets into the new
        table as one plan/commit batch, journal it, and advance the
        frontier.  Returns True when the migration completed."""
        m = self._mig
        if m is None:
            raise RuntimeError("no migration in flight")
        lo = m["frontier"]
        hi = min(lo + m["bpr"], self.n_buckets)
        ks, vs = drain_range(m["old_host"], lo, hi)
        n_live = ks.shape[0]
        if n_live:
            # new-authoritative filter: keys user traffic already pulled
            # (or re-inserted, or deleted) must not be re-migrated
            ex, _, _ = _probe_np(m["new"], ks, m["nb_new"])
            ks, vs = ks[~ex], vs[~ex]
        ops = np.zeros(ks.shape[0], np.int32)
        with get_tracker().reason("capacity_ladder"):
            m["new"], ok, _ = _run_batch(m["new"], ops, ks, vs,
                                         m["nb_new"])
        if not ok.all():
            raise RuntimeError(
                "migration drain dropped keys (new pool undersized: "
                f"capacity {m['cap_new']}, frontier {lo})")
        self._journal_round(ops, ks, vs, hi)
        m["frontier"] = hi
        m["migrated"] += int(ks.shape[0])
        m["skipped"] += int(n_live - ks.shape[0])
        m["remaining_live"] -= n_live
        self.rounds_total += 1
        self.migrated_total += int(ks.shape[0])
        get_registry().counter("map_migration_rounds_total").inc()
        get_registry().counter("map_migrated_keys_total").inc(
            int(ks.shape[0]))
        if hi >= self.n_buckets:
            self._finish_migration()
            return True
        return False

    def run_migration(self) -> MigrationReport:
        """Drive the in-flight migration to completion (blocking)."""
        m = self._mig
        if m is None:
            raise RuntimeError("no migration in flight")
        mx = 0
        r0, g0, s0 = self.rounds_total, self.migrated_total, m["skipped"]
        while self._mig is not None:
            before = self.migrated_total
            self.migrate_round()
            mx = max(mx, self.migrated_total - before)
        return MigrationReport(rounds=self.rounds_total - r0,
                               migrated=self.migrated_total - g0,
                               skipped=m["skipped"] - s0,
                               max_round_batch=mx)

    def _finish_migration(self) -> None:
        m = self._mig
        if self.io is not None:
            self._publish_header("done")
            if self._mig_seq > 1:      # the previous migration's journal
                self.io.remove_tree(   # is superseded
                    f"mig_{self._mig_seq - 1:04d}")
        # carry the frozen old table's accounting into the adopted state,
        # so the public flushes/fences stay monotone across growth
        self.state = m["new"]._replace(
            flushes=m["new"].flushes + self.state.flushes,
            fences=m["new"].fences + self.state.fences)
        self.capacity, self.n_buckets = m["cap_new"], m["nb_new"]
        self._mig = None
        self._journal = None
        self.migrations_completed += 1
        get_registry().counter("map_migrations_total").inc()

    def _commit_migrating(self, ops, ks, vs) -> np.ndarray:
        """Commit a user batch into the new table as one mixed round of
        ``[pull-inserts; user ops]``."""
        m = self._mig
        uniq = np.unique(ks)
        ex_new, _, _ = _probe_np(m["new"], uniq, m["nb_new"])
        cand = uniq[~ex_new]
        _, live_old, val_old = _probe_np(self.state, cand, self.n_buckets)
        pull_ks = cand[live_old]
        pull_vs = val_old[live_old].astype(np.int32)
        # every pull and every fresh user insert allocates at worst one
        # node; the un-drained remainder must still fit behind them
        fresh_cand = cand[~live_old]
        n_fresh = int(pull_ks.size) + int(
            np.isin(np.unique(ks[ops == B.OP_INSERT]), fresh_cand,
                    assume_unique=True).sum())
        fits = (int(m["new"].cursor) + n_fresh + m["remaining_live"]
                <= m["cap_new"])
        if not fits:
            # finish the migration now (the reserve guarantees the drains
            # fit) and let the steady-state path grow again
            self.run_migration()
            return self.update(ops, ks, vs)
        bops = np.concatenate(
            [np.full(pull_ks.size, B.OP_INSERT, np.int32), ops])
        bks = np.concatenate([pull_ks, ks])
        bvs = np.concatenate([pull_vs, vs])
        with get_tracker().reason("capacity_ladder"):
            m["new"], ok, self.last_stats = _run_batch(
                m["new"], bops, bks, bvs, m["nb_new"])
        if not ok[:pull_ks.size].all():
            raise RuntimeError("migration pull dropped keys "
                               "(reserve accounting bug)")
        self._journal_round(bops, bks, bvs, m["frontier"])
        self.pulls_total += int(pull_ks.size)
        get_registry().counter("map_pulls_total").inc(int(pull_ks.size))
        return ok[pull_ks.size:]

    # ---------------- crash recovery ----------------------------------- #
    def crash(self, evict: str = "none", p_evict: float = 0.5) -> None:
        """Simulate a process kill: the staging area is lost (unfenced
        journal bytes with it, apart from what the ``evict`` adversary
        lands) and the in-memory tables are dropped.  Use :meth:`recover`
        on the same root afterwards."""
        if self.io is None:
            raise RuntimeError("crash() needs a durable root")
        self.io.crash(evict=evict, p_evict=p_evict)
        self.state = None
        self._mig = None
        self._journal = None

    @classmethod
    def recover(cls, root, *, rounds_per_update: int = 1, seed: int = 0,
                device=None) -> "MigratingMap":
        """Rebuild from the journal: load the newest migration's header
        and old-pool snapshot, replay the published rounds in order
        through the plan/commit engine (deterministic, so bit-identical),
        and resume from the recovered frontier.  A ``done`` header
        recovers the completed table; no migration dir recovers an empty
        map."""
        root = Path(root)
        d = RoundJournal.newest_dir(root, "mig")
        m = cls(rounds_per_update=rounds_per_update, root=root, seed=seed,
                device=device)
        if d is None:
            return m
        hdr_bytes, old_host, rounds = RoundJournal.read(root, d)
        hdr = MigrationState.from_bytes(hdr_bytes)
        m._mig_seq = int(d.split("_")[1])
        m.capacity, m.n_buckets = hdr.old
        cap_new, nb_new = hdr.new
        new = B.make_state(cap_new, nb_new, m.device)
        frontier = 0
        for rec in rounds:
            new, _, _ = _run_batch(new, rec["ops"], rec["ks"], rec["vs"],
                                   nb_new)
            frontier = max(frontier, int(rec["frontier"]))
        if hdr.phase == "done":
            # the accounting carry of _finish_migration, so a recovered
            # completed table is bit-identical to the live one's
            def carried(x, name):
                return x + torch.tensor(int(old_host[name]),
                                        dtype=torch.int32, device=m.device)
            m.state = new._replace(flushes=carried(new.flushes, "flushes"),
                                   fences=carried(new.fences, "fences"))
            m.capacity, m.n_buckets = cap_new, nb_new
            m.migrations_completed = 1
            return m
        # resume mid-migration: the frozen old table and the reserve of
        # live keys still to drain
        m.state = B.state_from_numpy(old_host, m.device)
        drained = live_chain_nodes(old_host, 0, frontier).size
        m._mig = {
            "new": new, "cap_new": cap_new, "nb_new": nb_new,
            "bpr": hdr.buckets_per_round, "frontier": frontier,
            "n_rounds": len(rounds), "old_host": old_host,
            "remaining_live": int(old_host["live"].sum()) - drained,
            "migrated": 0, "skipped": 0,
        }
        m._journal = RoundJournal(m.io, d)
        m._journal.n_rounds = len(rounds)    # resume the round numbering
        return m
