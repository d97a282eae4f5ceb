"""Online migration, functional core: grow a durable map into a larger
pool and bucket count in bounded NVTraverse-correct rounds.

Port of ``repro.core.migrate`` (its journal-free part).  Each round drains
a contiguous range of old buckets -- bucket ascending, chain head to tail,
live nodes only -- and commits it into the new table as one plan/commit
batch, so every migrated key pays the paper's O(1) flushes + 2 fences at
its destination and nothing on the journey.  The drain order is
canonical, so the migrated table is bit-identical to the reference's.

The journaled ``MigratingMap``/``RoundJournal`` are not ported yet.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import batched as B
from ..obs.compile import get_tracker

_NIL = B.NIL


class MigrationReport(NamedTuple):
    rounds: int            # drain rounds run
    migrated: int          # live keys drained into the new table
    skipped: int           # drained keys already owned by the new table
    max_round_batch: int   # largest drain batch (bounded-round proof)


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


def drain_range(old: dict, lo: int, hi: int):
    """Canonical drain order of old buckets ``[lo, hi)``: bucket
    ascending, chain head to tail (newest first) within a bucket, live
    nodes only.  Returns ``(keys, vals)`` int32."""
    ks, vs = [], []
    head, nxt = old["head"], old["nxt"]
    key, val, live = old["key"], old["val"], old["live"]
    for b in range(lo, hi):
        node = int(head[b])
        while node != _NIL:
            if live[node]:
                ks.append(key[node])
                vs.append(val[node])
            node = int(nxt[node])
    return (np.asarray(ks, np.int32), np.asarray(vs, np.int32))


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
