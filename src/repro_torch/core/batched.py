"""PyTorch durable hash map: node-pool arrays + bucket heads, with the
sequential oracle engines and the batch plan/commit engine.

This is the PyTorch port of the JAX map in ``repro.core.batched`` and is
bit-identical to it: state arrays, per-op ``ok`` flags, flush/fence
accounting and :class:`CommitStats`.  The algorithm and its accounting
law are the same:

* *plan* (the journey): every op's destination -- bucket, existing node,
  resurrect-vs-fresh -- is found by a batched chain walk over the
  pre-batch snapshot, with zero persistence accounting;
* *commit* (the destination): ops are sorted stably by key, duplicate-key
  groups are resolved by a per-key liveness composition
  (``ok = is_insert XOR prev_live``), fresh node ids are a prefix sum in
  batch order, and chains are linked newest-first, so the result equals
  serializing the batch in order.  Each successful op costs O(1) flushes
  (2 for a fresh node, 1 for a resurrect or delete) and 2 fences;
  :class:`CommitStats` reports the coalesced batch cost, 2 fences per
  largest same-bucket group.

Where PyTorch does not behave like JAX, this module reproduces JAX:

* the 32-bit hash runs in int64 with a ``& 0xFFFFFFFF`` after each step
  (PyTorch on the CPU has no unsigned 32-bit shift);
* gathers go through :func:`_take`, which wraps a negative index once and
  then clamps, as a JAX gather does (``live[NIL]`` reads the last slot;
  the oracle :func:`insert` can publish a head past the pool, whose walk
  then reads the last slot);
* scatters go through :func:`_put`, which drops out-of-range indices, as
  ``.at[...].set(mode="drop")`` does;
* sorts are stable, segment min/max are ``scatter_reduce_`` on the same
  initial fill, and integer sums are cast back to int32.

Every entry point works on the device its state lives on.  A state is
made on ``device=None`` = ``"cuda"``, which raises when no card is
present; the CPU is only used when asked for.  The sequential oracles
(:func:`insert`, :func:`delete`, :func:`apply`) are one op at a time by
definition, so they run on the host and hand the state back on its
device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NIL = -1              # chain-link sentinel: no node id is negative, and
                      # slot 0 stays reserved (the bump cursor starts at 1)

OP_INSERT = 0         # per-op codes for apply / update_parallel
OP_DELETE = 1

_M32 = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; it raises when there is none, so a run
    never falls back to the CPU unless the caller asked for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on "
                "the host")
        return torch.device("cuda")
    return torch.device(device)


class HashMapState(NamedTuple):
    key: torch.Tensor       # int32[N] node keys
    val: torch.Tensor       # int32[N] node values
    nxt: torch.Tensor       # int32[N] chain links (NIL = end of chain)
    live: torch.Tensor      # bool[N]  logically present (False = deleted)
    head: torch.Tensor      # int32[B] bucket heads
    cursor: torch.Tensor    # int32    bump allocator (next free node id)
    flushes: torch.Tensor   # int32    persistence accounting
    fences: torch.Tensor


_DTYPES = {"key": torch.int32, "val": torch.int32, "nxt": torch.int32,
           "live": torch.bool, "head": torch.int32, "cursor": torch.int32,
           "flushes": torch.int32, "fences": torch.int32}


def make_state(capacity: int, n_buckets: int, device=None) -> HashMapState:
    """Fresh empty map; links (``nxt``, ``head``) are NIL-filled."""
    dev = resolve_device(device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return HashMapState(
        key=torch.zeros(capacity, dtype=torch.int32, device=dev),
        val=torch.zeros(capacity, dtype=torch.int32, device=dev),
        nxt=torch.full((capacity,), NIL, dtype=torch.int32, device=dev),
        live=torch.zeros(capacity, dtype=torch.bool, device=dev),
        head=torch.full((n_buckets,), NIL, dtype=torch.int32, device=dev),
        cursor=scalar(1), flushes=scalar(0), fences=scalar(0))


def state_from_numpy(arrays: dict, device=None) -> HashMapState:
    """``{field: numpy array}`` -> a state on ``device`` (the way a map
    built elsewhere, e.g. by the JAX package, is carried across)."""
    dev = resolve_device(device)
    return HashMapState(**{
        f: torch.tensor(np.asarray(arrays[f]), dtype=_DTYPES[f], device=dev)
        for f in HashMapState._fields})


def state_to_numpy(state: HashMapState) -> dict:
    """A state's fields as host numpy arrays (int32/bool, scalars 0-d),
    copied: writing to them never touches the state."""
    return {f: getattr(state, f).to("cpu", copy=True).numpy()
            for f in HashMapState._fields}


def _i32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=torch.int32)


# --------------------------------------------------------------------- #
# JAX indexing semantics                                                 #
# --------------------------------------------------------------------- #
def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as a JAX gather: a negative index wraps once, then
    every index is clamped into range (never an out-of-bounds fault)."""
    n = x.shape[0]
    idx = idx.long()
    return x[torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)]


def _put(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``x.at[idx].set(vals, mode="drop")``: a new tensor with in-range
    indices written (a negative index wraps once) and the rest dropped.
    Dropped writes land in a spare slot past the end, so no host sync."""
    n = x.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    buf = torch.cat([x, x.new_zeros(1)])
    buf[idx] = torch.as_tensor(vals, device=x.device).to(x.dtype)
    return buf[:n]


def _shift(x: torch.Tensor, fill) -> torch.Tensor:
    """``concatenate([fill], x[:-1])``."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype,
                                 device=x.device), x[:-1]])


def _seg_reduce(seg, src, n: int, reduce: str, fill) -> torch.Tensor:
    """``full(n, fill).at[seg].min/max(src)``."""
    out = torch.full((n,), fill, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(0, seg, src, reduce, include_self=True)


# --------------------------------------------------------------------- #
# hashing                                                                #
# --------------------------------------------------------------------- #
def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style 32-bit hash, emulated in int64: returns the uint32
    value in ``[0, 2**32)`` as int64.  Negative keys map through two's
    complement; the int64 products wrap, which keeps the low 32 bits."""
    x = x.long() & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def bucket_of(k: torch.Tensor, n_buckets: int) -> torch.Tensor:
    return (_mix(k) % n_buckets).to(torch.int32)


def bucket_of_np(k, n_buckets: int):
    """Numpy twin of :func:`bucket_of` for host-side decisions.

    >>> bucket_of_np([1, 2, 3], 8).tolist() == \\
    ...     bucket_of(torch.tensor([1, 2, 3]), 8).tolist()
    True
    """
    x = np.asarray(k).astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return (x % np.uint32(n_buckets)).astype(np.int32)


# --------------------------------------------------------------------- #
# traversal (the journey -- zero persistence work)                       #
# --------------------------------------------------------------------- #
def _bucket_local(k, n_buckets: int, nb_global, base):
    """Local bucket of ``k``: ``hash mod n_buckets``, or -- when the state
    holds the global range ``[base, base+n_buckets)`` of an
    ``nb_global``-bucket space -- ``hash mod nb_global - base``, clipped."""
    if nb_global is None:
        return bucket_of(k, n_buckets)
    return (bucket_of(k, nb_global) - base).clamp(0, n_buckets - 1).to(
        torch.int32)


def _walk(state: HashMapState, ks: torch.Tensor, b: torch.Tensor):
    """Batched chain walk: every lane follows its chain until it reaches
    its key or NIL.  A frontier loop of gathers; deciding whether any lane
    is still active is one host sync per step (chain length + 1 steps)."""
    node = _take(state.head, b)
    while True:
        act = (node != NIL) & (_take(state.key, node) != ks)
        if not bool(act.any()):
            return node
        node = torch.where(act, _take(state.nxt, node), node)


def _find(state: HashMapState, ks: torch.Tensor, n_buckets: int,
          nb_global=None, base=None):
    """Node id of each key, or NIL."""
    return _walk(state, ks, _bucket_local(ks, n_buckets, nb_global, base))


def lookup(state: HashMapState, ks, n_buckets: int, nb_global=None,
           base=None):
    """Batched lookup: ``(found bool[batch], vals int32[batch])``."""
    ks = _i32(ks, state.key.device)
    node = _find(state, ks, n_buckets, nb_global, base)
    found = (node != NIL) & _take(state.live, node)
    return found, torch.where(found, _take(state.val, node), 0)


def merge_new_old(exists_new, live_new, vals_new, live_old, vals_old):
    """The migration new-then-old lookup rule (host numpy): a key with any
    node in the new table is answered there, dead or alive; only node-less
    keys fall through to the old table.  A not-found key's val is 0.

    >>> f, v = merge_new_old(
    ...     np.array([True, True, False]), np.array([False, True, False]),
    ...     np.array([0, 7, 0]), np.array([True, True, True]),
    ...     np.array([5, 6, 9]))
    >>> f.tolist(), v.tolist()
    ([False, True, True], [0, 7, 9])
    """
    found = np.asarray(np.where(exists_new, live_new, live_old), np.bool_)
    vals = np.where(exists_new, vals_new, vals_old)
    return found, np.where(found, vals, 0).astype(np.int32)


def probe(state: HashMapState, ks, n_buckets: int, nb_global=None,
          base=None):
    """Node-level probe: ``(exists, live, vals)``; ``exists`` is True iff
    the key has a node at all, dead or alive."""
    ks = _i32(ks, state.key.device)
    node = _find(state, ks, n_buckets, nb_global, base)
    exists = node != NIL
    live = exists & _take(state.live, node)
    return exists, live, torch.where(exists, _take(state.val, node), 0)


# --------------------------------------------------------------------- #
# sequential oracles (host, one op at a time in batch order)             #
# --------------------------------------------------------------------- #
class _HostMap:
    """A state's arrays on the host, with JAX's index semantics for the
    scalar reads and writes of the scan oracles."""

    def __init__(self, state: HashMapState):
        self.device = state.key.device
        a = state_to_numpy(state)
        self.key, self.val, self.nxt = a["key"], a["val"], a["nxt"]
        self.live, self.head = a["live"], a["head"]
        self.cursor = int(a["cursor"])
        self.flushes = int(a["flushes"])
        self.fences = int(a["fences"])
        self.cap = self.key.shape[0]

    def _clip(self, i: int) -> int:
        return min(max(i + self.cap if i < 0 else i, 0), self.cap - 1)

    def get(self, arr, i: int):
        return arr[self._clip(i)]

    def set(self, arr, i: int, v) -> None:
        i = i + self.cap if i < 0 else i
        if 0 <= i < self.cap:          # out-of-range writes are dropped
            arr[i] = v

    def find(self, k: int, b: int) -> int:
        node = int(self.head[b])
        while node != NIL and int(self.get(self.key, node)) != k:
            node = int(self.get(self.nxt, node))
        return node

    def alloc(self, k: int, v: int, b: int) -> None:
        nid = self.cursor
        self.set(self.key, nid, k)
        self.set(self.val, nid, v)
        self.set(self.nxt, nid, self.head[b])
        self.set(self.live, nid, True)
        self.head[b] = np.int32(nid)
        self.cursor += 1
        self.flushes += 2
        self.fences += 2

    def resurrect(self, node: int, v: int) -> None:
        self.set(self.val, node, v)
        self.set(self.live, node, True)
        self.flushes += 1
        self.fences += 2

    def kill(self, node: int) -> None:
        self.set(self.live, node, False)
        self.flushes += 1
        self.fences += 2

    def state(self) -> HashMapState:
        return state_from_numpy({
            "key": self.key, "val": self.val, "nxt": self.nxt,
            "live": self.live, "head": self.head,
            "cursor": np.int64(self.cursor).astype(np.int32),
            "flushes": np.int64(self.flushes).astype(np.int32),
            "fences": np.int64(self.fences).astype(np.int32)},
            device=self.device)


def _host_batch(*xs):
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            .astype(np.int32) for x in xs]


def insert(state: HashMapState, ks, vs, n_buckets: int):
    """Sequential batched insert (batch order is the linearization order).
    A live key fails; a dead node is resurrected in place.  On pool
    exhaustion the node writes are dropped while the head still publishes
    the dangling id -- the reference oracle's behaviour, kept as is.
    Returns ``(state', ok bool[batch])``."""
    h = _HostMap(state)
    ks, vs = _host_batch(ks, vs)
    bs = bucket_of_np(ks, n_buckets)
    ok = np.zeros(ks.shape[0], np.bool_)
    for i, (k, v, b) in enumerate(zip(ks.tolist(), vs.tolist(),
                                      bs.tolist())):
        node = h.find(k, b)
        if node != NIL and h.get(h.live, node):
            continue
        if node != NIL:
            h.resurrect(node, v)
        else:
            h.alloc(k, v, b)
        ok[i] = True
    return h.state(), torch.as_tensor(ok, device=h.device)


def delete(state: HashMapState, ks, n_buckets: int):
    """Sequential batched logical delete (mark-before-disconnect)."""
    h = _HostMap(state)
    (ks,) = _host_batch(ks)
    bs = bucket_of_np(ks, n_buckets)
    ok = np.zeros(ks.shape[0], np.bool_)
    for i, (k, b) in enumerate(zip(ks.tolist(), bs.tolist())):
        node = h.find(k, b)
        if node != NIL and h.get(h.live, node):
            h.kill(node)
            ok[i] = True
    return h.state(), torch.as_tensor(ok, device=h.device)


def apply(state: HashMapState, ops, ks, vs, n_buckets: int):
    """Sequential mixed oracle: interleaved inserts and deletes in batch
    order.  Insert succeeds iff the key is dead/absent (a fresh node fails
    cleanly when the pool is full); delete iff it is live.  Returns
    ``(state', ok bool[batch])``."""
    h = _HostMap(state)
    ops, ks, vs = _host_batch(ops, ks, vs)
    bs = bucket_of_np(ks, n_buckets)
    ok = np.zeros(ks.shape[0], np.bool_)
    for i, (op, k, v, b) in enumerate(zip(ops.tolist(), ks.tolist(),
                                          vs.tolist(), bs.tolist())):
        node = h.find(k, b)
        exists_live = node != NIL and bool(h.get(h.live, node))
        if op == OP_INSERT:
            if exists_live:
                continue
            if node != NIL:
                h.resurrect(node, v)
            elif h.cursor < h.cap:
                h.alloc(k, v, b)
            else:
                continue
            ok[i] = True
        elif exists_live:
            h.kill(node)
            ok[i] = True
    return h.state(), torch.as_tensor(ok, device=h.device)


# --------------------------------------------------------------------- #
# plan/commit engine (the hot path)                                      #
# --------------------------------------------------------------------- #
class CommitStats(NamedTuple):
    """The coalesced cost the batch engine pays at the destination (see
    ``repro.core.batched.CommitStats``); all int32."""
    ops_committed: torch.Tensor
    conflict_groups: torch.Tensor
    max_group: torch.Tensor
    coalesced_flushes: torch.Tensor
    coalesced_fences: torch.Tensor
    bucket_flushes: torch.Tensor      # int32[n_buckets]


def _plan(state: HashMapState, ks: torch.Tensor, n_buckets: int,
          nb_global=None, base=None):
    """The journey, batch-wide: each op's node in the pre-batch snapshot.
    Reads no persistence state."""
    bucket = _bucket_local(ks, n_buckets, nb_global, base)
    node = _walk(state, ks, bucket)
    snap_exists = node != NIL
    snap_live = snap_exists & _take(state.live, node)
    return node, snap_exists, snap_live, bucket


def _commit_stats(bucket, ok, flushes_per_op, n_buckets: int) -> CommitStats:
    dev = ok.device
    counts = torch.zeros(n_buckets, dtype=torch.int32, device=dev)
    counts.index_add_(0, bucket.long(), ok.to(torch.int32))
    max_group = counts.max()
    flushes = torch.where(ok, flushes_per_op, 0).to(torch.int32)
    bucket_flushes = torch.zeros(n_buckets, dtype=torch.int32, device=dev)
    bucket_flushes.index_add_(0, bucket.long(), flushes)
    return CommitStats(
        ops_committed=ok.sum().to(torch.int32),
        conflict_groups=(counts > 0).sum().to(torch.int32),
        max_group=max_group,
        coalesced_flushes=flushes.sum().to(torch.int32),
        coalesced_fences=(2 * max_group).to(torch.int32),
        bucket_flushes=bucket_flushes)


def update_parallel(state: HashMapState, ops, ks, vs, n_buckets: int,
                    valid=None, nb_global=None, base=None):
    """One plan/commit round over interleaved inserts and deletes,
    bit-identical to :func:`apply`; returns ``(state', ok bool[batch],
    CommitStats)``.

    ``valid`` (optional ``bool[batch]``) marks padding: an invalid op
    fails, never writes or counts, and is transparent to the liveness
    composition of its key group.  An allocator that would overflow the
    pool fails its whole duplicate-key group.  ``nb_global``/``base``
    commit against the global bucket range ``[base, base+n_buckets)``.
    The only host syncs are the chain walk's steps."""
    dev = state.key.device
    ops, ks, vs = (_i32(x, dev) for x in (ops, ks, vs))
    n = ks.shape[0]
    cap = state.key.shape[0]
    if n == 0:                       # an empty batch is a no-op
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        none = torch.zeros(0, dtype=torch.bool, device=dev)
        return state, none, _commit_stats(empty, none, empty, n_buckets)

    # ---- plan: the journey, zero persistence ------------------------- #
    node, snap_exists, snap_live, bucket = _plan(state, ks, n_buckets,
                                                 nb_global, base)
    is_ins = ops == OP_INSERT

    # ---- merged conflict resolution: per-key liveness composition ---- #
    order = torch.argsort(ks, stable=True)      # ties keep batch order
    sk = ks[order]
    s_ins = is_ins[order]
    s_node = node[order]
    s_exists = snap_exists[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(first, 0) - 1
    pos = torch.arange(n, device=dev)

    if valid is None:
        prev_live = torch.where(first, snap_live[order], _shift(s_ins, False))
        s_ok = s_ins ^ prev_live
    else:
        # an op's predecessor state is the code of the latest valid op
        # before it in its segment (the snapshot seed when there is none)
        s_valid = torch.as_tensor(valid, device=dev).to(torch.bool)[order]
        lastv = torch.cummax(torch.where(s_valid, pos, -1), 0).values
        prev_j = _shift(lastv, -1)
        pj = prev_j.clamp(0, n - 1)
        in_seg = (prev_j >= 0) & (seg[pj] == seg)
        prev_live = torch.where(in_seg, s_ins[pj], snap_live[order])
        s_ok = (s_ins ^ prev_live) & s_valid
    s_okins = s_ok & s_ins

    # the allocator of an absent-key group is its first successful insert
    first_okins = _seg_reduce(seg, torch.where(s_okins, pos, n), n, "amin", n)
    s_alloc = s_okins & (pos == first_okins[seg]) & ~s_exists

    # ---- commit: allocation in batch order (oracle-identical ids) ---- #
    alloc = torch.zeros(n, dtype=torch.bool, device=dev)
    alloc[order] = s_alloc
    rank = torch.cumsum(alloc, 0) - alloc.long()
    alloc = alloc & (state.cursor + rank < cap)
    # a capacity-failed allocator fails its entire duplicate-key group
    s_alloc_ok = alloc[order]
    dead_seg = _seg_reduce(seg, (s_alloc & ~s_alloc_ok).long(), n, "amax", 0)
    s_ok = s_ok & (dead_seg[seg] == 0)
    s_okins = s_ok & s_ins
    s_alloc = s_alloc & s_alloc_ok

    # group node id: the snapshot node, or the allocator's fresh id
    s_fresh_nid = torch.where(s_alloc, state.cursor + rank[order], 0)
    seg_nid = _seg_reduce(seg, s_fresh_nid, n, "amax", 0)
    s_nid = torch.where(s_exists, s_node.long(), seg_nid[seg])

    # the last successful op / insert of each group decide final values
    last_ok = _seg_reduce(seg, torch.where(s_ok, pos, -1), n, "amax", -1)
    s_write_live = s_ok & (pos == last_ok[seg])
    last_okins = _seg_reduce(seg, torch.where(s_okins, pos, -1), n, "amax",
                             -1)
    s_write_val = s_okins & (pos == last_okins[seg])

    # node-field publication (masked ops scatter out of bounds: dropped)
    key = _put(state.key, torch.where(s_alloc, s_nid, cap), sk)
    val = _put(state.val, torch.where(s_write_val, s_nid, cap), vs[order])
    live = _put(state.live, torch.where(s_write_live, s_nid, cap), s_ins)

    # chain linking: fresh nodes sorted by (bucket, batch index); each
    # points at its predecessor in the group, the group's first at the
    # snapshot head, and the group's last becomes the new head
    nid_b = torch.where(alloc, state.cursor + rank, 0)
    bkey = torch.where(alloc, bucket.long(), n_buckets)
    order2 = torch.argsort(bkey, stable=True)
    sb = bkey[order2]
    snid = nid_b[order2]
    sfresh = alloc[order2]
    same_prev = torch.zeros(n, dtype=torch.bool, device=dev)
    same_prev[1:] = sb[1:] == sb[:-1]
    link = torch.where(same_prev, _shift(snid, 0),
                       _take(state.head, sb.clamp(0, n_buckets - 1)).long())
    nxt = _put(state.nxt, torch.where(sfresh, snid, cap), link)
    group_last = torch.ones(n, dtype=torch.bool, device=dev)
    group_last[:-1] = sb[:-1] != sb[1:]
    group_last &= sfresh
    head = _put(state.head, torch.where(group_last, sb, n_buckets), snid)

    # oracle accounting: fresh = 2 flushes, resurrect/delete = 1,
    # +2 fences per successful op
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    ok[order] = s_ok
    flushes_per_op = torch.where(alloc, 2, torch.where(ok, 1, 0))
    state = state._replace(
        key=key, val=val, nxt=nxt, live=live, head=head,
        cursor=(state.cursor + alloc.sum()).to(torch.int32),
        flushes=(state.flushes + flushes_per_op.sum()).to(torch.int32),
        fences=(state.fences + 2 * ok.sum()).to(torch.int32))
    return state, ok, _commit_stats(bucket, ok, flushes_per_op, n_buckets)


def insert_parallel(state: HashMapState, ks, vs, n_buckets: int):
    """Batch insert via plan/commit (a homogeneous OP_INSERT batch)."""
    ks = _i32(ks, state.key.device)
    return update_parallel(state, torch.full_like(ks, OP_INSERT), ks, vs,
                           n_buckets)


def delete_parallel(state: HashMapState, ks, n_buckets: int):
    """Batch logical delete via plan/commit (a homogeneous OP_DELETE
    batch)."""
    ks = _i32(ks, state.key.device)
    return update_parallel(state, torch.full_like(ks, OP_DELETE), ks,
                           torch.zeros_like(ks), n_buckets)


def chain_stats(state: HashMapState, n_buckets: int):
    """Max/mean chain length over every bucket.  The mean is the integer
    total in float32 times the float32 reciprocal of ``n_buckets``, as XLA
    computes the reference's ``mean`` (the float32 sum is exact while the
    total stays below 2**24)."""
    dev = state.key.device
    cap = state.key.shape[0]
    node = _take(state.head, torch.arange(n_buckets, device=dev))
    steps = torch.zeros(n_buckets, dtype=torch.int32, device=dev)
    while True:
        act = (node != NIL) & (steps < cap)
        if not bool(act.any()):
            break
        node = torch.where(act, _take(state.nxt, node), node)
        steps += act.to(torch.int32)
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        float(n_buckets), dtype=torch.float32)
    mean = steps.sum().to(torch.float32) * inv.to(dev)
    return steps.max(), mean
