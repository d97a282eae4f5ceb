"""Batch-parallel durable *ordered* map (port of ``repro.core.ordered``).

The paper's canonical traversal structure in its ordered form: a skiplist
whose persistent core is only the sorted bottom list (Property 2), under
volatile index towers.  It is bit-identical to the reference: state
arrays, per-op ``ok`` flags, flush/fence accounting, every
:class:`OrderedCommitStats` field, reads, towers, and the bytes of the
journal and snapshot files of :class:`DurableOrderedMap`.

* the **bottom list** is a node pool (``key``/``val``/``nxt``/``live``)
  threaded in ascending key order off the head sentinel (node 0, key
  ``KEY_MIN``).  Deletes are logical marks; nodes are never unlinked;
* the **towers** (:class:`TowerIndex`) are per-level sorted arrays of the
  live keys promoted to that level, built on the host by
  :func:`build_towers` from :func:`repro_torch.core.skiplist.tower_heights`,
  so the index rebuilt after a crash equals the one before it;
* *plan* (the journey): each op's predecessor -- the last physical node
  with key below the op's key -- is found by a tower descent
  (``searchsorted`` per level) and a batched frontier walk along the
  bottom list, one host sync per step, with zero persistence accounting;
* *commit* (the destination): duplicate keys compose their liveness in
  batch order exactly as the hash engine does; fresh nodes sharing a
  predecessor splice into its gap in ascending key order; each op costs 2
  flushes (fresh) or 1 (resurrect/delete) and 2 fences.

The ordered reads (:func:`range_query`, :func:`scan`, :func:`top_k`) are
node-by-node walks in the reference.  Here they rank the chain by pointer
jumping instead (``log2(capacity)`` gathers per table, see
:func:`_jump_tables`) and select by rank, which computes the same function
in a bounded number of device steps on any acyclic chain.

The sequential oracle :func:`apply_ordered` runs on the host, one op at a
time in batch order, and hands the state back on its device.  A state is
made on ``device=None`` = the card; the CPU is used only when asked for.

>>> items = {}
>>> oracle_apply(items, [0, 0, 1], [5, 3, 5], [50, 30, 0], capacity=8)
[True, True, True]
>>> sorted((k, lv) for k, (lv, _) in items.items())
[(3, True), (5, False)]
>>> oracle_range(items, 0, 9)
[(3, 30)]
"""
from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..obs.metrics import get_registry
from .batched import (NIL, OP_DELETE, OP_INSERT, _i32, _put, _seg_reduce,
                      _shift, _take, resolve_device)
from .skiplist import tower_heights

KEY_MIN = -(2 ** 31)        # head-sentinel key (node 0): -inf
KEY_PAD = 2 ** 31 - 1       # tower padding: +inf.  Valid keys are in
                            # (KEY_MIN, KEY_PAD) -- the int32 interior.
MAX_LEVEL = 8               # default tower height cap (seed skiplist's)


class OrderedState(NamedTuple):
    """The persistent bottom-level list (node pool + accounting)."""
    key: torch.Tensor       # int32[N] node keys (node 0: KEY_MIN sentinel)
    val: torch.Tensor       # int32[N] node values
    nxt: torch.Tensor       # int32[N] ascending-key chain (NIL = end)
    live: torch.Tensor      # bool[N]  logically present
    cursor: torch.Tensor    # int32    bump allocator (next free node id)
    flushes: torch.Tensor   # int32    persistence accounting (per-op law)
    fences: torch.Tensor


class TowerIndex(NamedTuple):
    """The volatile index: per level 2..max_level a sorted, KEY_PAD-padded
    row of the live keys promoted to that level and their node ids."""
    keys: torch.Tensor      # int32[levels, N]
    addr: torch.Tensor      # int32[levels, N]


class OrderedCommitStats(NamedTuple):
    """Coalesced batch cost at the destination, grouped by predecessor
    node (the gap being spliced); all int32."""
    ops_committed: torch.Tensor
    conflict_groups: torch.Tensor
    max_group: torch.Tensor
    coalesced_flushes: torch.Tensor
    coalesced_fences: torch.Tensor   # 2 x max_group


_DTYPES = {"key": torch.int32, "val": torch.int32, "nxt": torch.int32,
           "live": torch.bool, "cursor": torch.int32,
           "flushes": torch.int32, "fences": torch.int32}


def make_ordered(capacity: int, device=None) -> OrderedState:
    """Fresh empty ordered map.  Node 0 is the permanent head sentinel
    (key -inf, never live)."""
    dev = resolve_device(device)
    key = torch.zeros(capacity, dtype=torch.int32, device=dev)
    key[0] = KEY_MIN

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return OrderedState(
        key=key, val=torch.zeros(capacity, dtype=torch.int32, device=dev),
        nxt=torch.full((capacity,), NIL, dtype=torch.int32, device=dev),
        live=torch.zeros(capacity, dtype=torch.bool, device=dev),
        cursor=scalar(1), flushes=scalar(0), fences=scalar(0))


def state_from_numpy(arrays: dict, device=None) -> OrderedState:
    """``{field: array-like}`` -> a state on ``device``."""
    dev = resolve_device(device)
    return OrderedState(**{
        f: torch.tensor(np.asarray(arrays[f]), dtype=_DTYPES[f], device=dev)
        for f in OrderedState._fields})


def state_to_numpy(state: OrderedState) -> dict:
    """A state's fields as host numpy arrays (copies)."""
    return {f: getattr(state, f).to("cpu", copy=True).numpy()
            for f in OrderedState._fields}


# --------------------------------------------------------------------- #
# the volatile towers (Property 2's reconstruction function, batch form) #
# --------------------------------------------------------------------- #
def build_towers(state: OrderedState, max_level: int = MAX_LEVEL
                 ) -> TowerIndex:
    """Deterministic volatile index over the live keys of ``state``, built
    on the host as the reference builds it (so the towers are identical
    whichever package built them) and placed on the state's device."""
    ks = state.key.cpu().numpy()
    ids = np.nonzero(state.live.cpu().numpy())[0].astype(np.int32)
    order = np.argsort(ks[ids], kind="stable")
    sk, sid = ks[ids][order], ids[order]
    h = tower_heights(sk, max_level) if sk.size else np.zeros(0, np.int32)
    cap = int(state.key.shape[0])
    levels = max(1, max_level - 1)
    keys = np.full((levels, cap), KEY_PAD, np.int32)
    addr = np.zeros((levels, cap), np.int32)
    for lvl in range(2, max_level + 1):
        sel = h >= lvl
        m = int(sel.sum())
        keys[lvl - 2, :m] = sk[sel]
        addr[lvl - 2, :m] = sid[sel]
    dev = state.key.device
    return TowerIndex(keys=torch.from_numpy(keys).to(dev),
                      addr=torch.from_numpy(addr).to(dev))


def _tower_arrays(state: OrderedState, towers: Optional[TowerIndex]):
    if towers is None:
        cap = state.key.shape[0]
        dev = state.key.device
        return (torch.full((1, cap), KEY_PAD, dtype=torch.int32, device=dev),
                torch.zeros((1, cap), dtype=torch.int32, device=dev))
    return towers.keys, towers.addr


def _descend(tk: torch.Tensor, ta: torch.Tensor, ks: torch.Tensor):
    """Tower descent: the closest tower key strictly below each ``k``
    over every level hands over its node; the head sentinel otherwise."""
    entry = torch.zeros_like(ks)
    ekey = torch.full_like(ks, KEY_MIN)
    for lvl in range(tk.shape[0] - 1, -1, -1):
        i = torch.searchsorted(tk[lvl], ks, right=False) - 1
        j = i.clamp(min=0)
        ck = tk[lvl][j]
        better = (i >= 0) & (ck > ekey)
        entry = torch.where(better, ta[lvl][j], entry)
        ekey = torch.where(better, ck, ekey)
    return entry


def _find_pred(state: OrderedState, tk, ta, ks: torch.Tensor):
    """Walk every lane from its tower entry to the last physical node
    (live or dead) with key below its ``k``.  A frontier loop of gathers
    with one host sync per step; the steps are counted on the metrics
    registry (``ordered_plan_steps_total``).  Zero persistence."""
    pred = _descend(tk, ta, ks)
    steps = 0
    while True:
        nx = _take(state.nxt, pred)
        act = (nx != NIL) & (_take(state.key, nx) < ks)
        steps += 1
        if not bool(act.any()):
            break
        pred = torch.where(act, nx, pred)
    reg = get_registry()
    reg.counter("ordered_plan_walks_total").inc()
    reg.counter("ordered_plan_steps_total").inc(steps)
    return pred


def _plan(state: OrderedState, tk, ta, ks: torch.Tensor):
    """Every op's predecessor and existing node in the pre-batch
    snapshot."""
    pred = _find_pred(state, tk, ta, ks)
    nx = _take(state.nxt, pred)
    found = (nx != NIL) & (_take(state.key, nx) == ks)
    node = torch.where(found, nx, NIL)
    snap_live = (node != NIL) & _take(state.live, node)
    return pred, node, snap_live


# --------------------------------------------------------------------- #
# traversal reads (zero persistence)                                     #
# --------------------------------------------------------------------- #
def lookup_ordered(state: OrderedState, ks,
                   towers: Optional[TowerIndex] = None):
    """Batched ordered lookup: ``(found bool[B], vals int32[B])``."""
    ks = _i32(ks, state.key.device)
    tk, ta = _tower_arrays(state, towers)
    _, node, snap_live = _plan(state, tk, ta, ks)
    return snap_live, torch.where(snap_live, _take(state.val, node), 0)


class _JumpTables(NamedTuple):
    """Pointer-jumping tables over the pool plus a sink (index ``cap``,
    standing for NIL, which points at itself): ``jump[k][i]`` is the node
    ``2**k`` links after ``i``, ``lives[k][i]`` the live nodes among the
    ``2**k`` nodes from ``i`` on, ``kmax[k][i]`` their largest key (the
    sink's key is ``2**31``, above every int32 bound)."""
    jump: List[torch.Tensor]
    lives: List[torch.Tensor]
    kmax: Optional[List[torch.Tensor]]
    sink: int


def _link(state: OrderedState, raw: torch.Tensor) -> torch.Tensor:
    """A raw link value as a table index: NIL is the sink, anything else
    is read as a JAX gather reads it (wrapped once, clamped)."""
    cap = state.key.shape[0]
    raw = raw.long()
    idx = torch.where(raw < 0, raw + cap, raw).clamp(0, cap - 1)
    return torch.where(raw == NIL, cap, idx)


def _jump_tables(state: OrderedState, with_keys: bool) -> _JumpTables:
    """``cap.bit_length()`` levels, so one descent over them can move past
    every node of an acyclic chain (``2**K - 1 >= cap``)."""
    cap = state.key.shape[0]
    dev = state.key.device
    sink = torch.tensor([cap], dtype=torch.long, device=dev)
    jump = [torch.cat([_link(state, state.nxt), sink])]
    lives = [torch.cat([state.live.long(), sink.new_zeros(1)])]
    kmax = [torch.cat([state.key.long(), sink.new_full((1,), 2 ** 31)])] \
        if with_keys else None
    for _ in range(1, cap.bit_length()):
        j = jump[-1]
        lives.append(lives[-1] + lives[-1][j])
        if kmax is not None:
            kmax.append(torch.maximum(kmax[-1], kmax[-1][j]))
        jump.append(j[j])
    return _JumpTables(jump, lives, kmax, cap)


def _select(state: OrderedState, tb: _JumpTables, start: torch.Tensor,
            first: torch.Tensor, count: torch.Tensor, width: int):
    """For each lane, the live nodes of ranks ``first .. first+count-1``
    along the chain from ``start`` (rank 0 = the first live node), in
    chain order, as ``(keys [Q, width], vals [Q, width])``; slots past
    ``count`` hold KEY_PAD / 0."""
    r = torch.arange(width, device=start.device)
    valid = r[None, :] < count[:, None]
    rem = first[:, None] + r[None, :]
    cur = start[:, None].expand(-1, width).clone()
    for k in range(len(tb.jump) - 1, -1, -1):
        c = tb.lives[k][cur]
        take = c <= rem
        rem = torch.where(take, rem - c, rem)
        cur = torch.where(take, tb.jump[k][cur], cur)
    node = cur.clamp(max=tb.sink - 1)
    keys = torch.where(valid, state.key[node], KEY_PAD)
    vals = torch.where(valid, state.val[node], 0)
    return keys.to(torch.int32), vals.to(torch.int32)


def range_query(state: OrderedState, lo, hi, max_items: int,
                towers: Optional[TowerIndex] = None):
    """Ordered range read ``[lo, hi]`` (a pure journey): returns
    ``(total, keys int32[max_items], vals int32[max_items])`` -- the first
    ``max_items`` live keys met walking the chain from ``lo``'s
    predecessor until a key above ``hi`` or the chain's end, and the
    *total* live count of that walk (``> max_items`` means a truncated
    prefix).  Unused slots hold :data:`KEY_PAD` / 0.  ``lo`` and ``hi``
    may also be 1-D batches of bounds; then every output gains a leading
    batch axis."""
    dev = state.key.device
    batched = torch.as_tensor(lo).dim() > 0
    lo = _i32(lo, dev).reshape(-1)
    hi = _i32(hi, dev).reshape(-1).long()
    tk, ta = _tower_arrays(state, towers)
    pred = _find_pred(state, tk, ta, lo)
    start = _link(state, _take(state.nxt, pred))
    tb = _jump_tables(state, with_keys=True)
    cur, total = start, torch.zeros_like(start)
    for k in range(len(tb.jump) - 1, -1, -1):
        inside = tb.kmax[k][cur] <= hi       # every node of the hop in range
        total = torch.where(inside, total + tb.lives[k][cur], total)
        cur = torch.where(inside, tb.jump[k][cur], cur)
    keys, vals = _select(state, tb, start, torch.zeros_like(total),
                         total.clamp(max=max_items), max_items)
    total = total.to(torch.int32)
    if batched:
        return total, keys, vals
    return total[0], keys[0], vals[0]


def scan(state: OrderedState, max_items: int,
         towers: Optional[TowerIndex] = None):
    """Full ordered scan (ascending): :func:`range_query` over the whole
    key interior."""
    return range_query(state, KEY_MIN + 1, KEY_PAD - 1, max_items, towers)


def top_k(state: OrderedState, k: int):
    """The last ``k`` live nodes of the chain (the ``k`` largest live keys
    of a sorted chain), in chain order: ``(count, keys int32[k], vals
    int32[k])`` with ``count = min(k, live)``; slots past ``count`` hold
    KEY_PAD / 0."""
    tb = _jump_tables(state, with_keys=False)
    start = _link(state, state.nxt[:1])
    cur, n_live = start, torch.zeros_like(start)
    for j, lv in zip(tb.jump, tb.lives):     # hop 2**K - 1 >= cap links
        n_live = n_live + lv[cur]
        cur = j[cur]
    count = n_live.clamp(max=k)
    keys, vals = _select(state, tb, start, n_live - count, count, k)
    return count[0].to(torch.int32), keys[0], vals[0]


# --------------------------------------------------------------------- #
# sequential scan oracle (the linearization reference)                   #
# --------------------------------------------------------------------- #
class _HostChain:
    """A state's arrays on the host plus its chain order, for the scan
    oracle.  The walk from the head to an op's predecessor stops at the
    first chain node whose key is at least ``k``: that is the first
    position whose prefix maximum reaches ``k``, found by bisection.
    Fresh nodes of this batch sit in sorted per-gap lists (a gap is the
    space before a chain position), which the same walk passes in key
    order -- so the oracle equals the literal head-to-predecessor walk on
    any acyclic chain at a bisection per op."""

    def __init__(self, state: OrderedState):
        a = state_to_numpy(state)
        self.device = state.key.device
        self.key, self.val = a["key"], a["val"]
        self.nxt, self.live = a["nxt"], a["live"]
        self.cursor = int(a["cursor"])
        self.flushes, self.fences = int(a["flushes"]), int(a["fences"])
        self.cap = self.key.shape[0]
        nxt, key = self.nxt.tolist(), self.key.tolist()
        self.order, self.pmax = [], []
        node, top = nxt[0], KEY_MIN
        while node != NIL:
            if len(self.order) >= self.cap:
                raise AssertionError("cycle in bottom list")
            self.order.append(node)
            top = max(top, key[node])
            self.pmax.append(top)
            node = nxt[node]
        self.gaps = {}          # chain position -> ([keys], [node ids])

    def find(self, k: int):
        """``(pred, next)`` of the walk for key ``k``."""
        j = bisect.bisect_left(self.pmax, k)
        pred = self.order[j - 1] if j else 0
        nx = self.order[j] if j < len(self.order) else NIL
        gk, gn = self.gaps.get(j, ((), ()))
        t = bisect.bisect_left(gk, k)
        if t:
            pred = gn[t - 1]
        if t < len(gk):
            nx = gn[t]
        return pred, nx, j, t

    def state(self) -> OrderedState:
        return state_from_numpy({
            "key": self.key, "val": self.val, "nxt": self.nxt,
            "live": self.live,
            "cursor": np.int64(self.cursor).astype(np.int32),
            "flushes": np.int64(self.flushes).astype(np.int32),
            "fences": np.int64(self.fences).astype(np.int32)},
            device=self.device)


def apply_ordered(state: OrderedState, ops, ks, vs):
    """Sequential mixed oracle: the batch serialized in batch order, each
    op one head-to-predecessor walk.  Insert succeeds iff the key is
    dead/absent (dead nodes resurrect in place; absent keys allocate,
    failing cleanly when the pool is full); delete succeeds iff live.
    Accounting: fresh = 2 flushes, resurrect/delete = 1, +2 fences per
    successful op.  Returns ``(state', ok bool[B])``."""
    h = _HostChain(state)
    ops, ks, vs = (np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                              else x).astype(np.int32)
                   for x in (ops, ks, vs))
    ok = np.zeros(ks.shape[0], np.bool_)
    for i, (op, k, v) in enumerate(zip(ops.tolist(), ks.tolist(),
                                       vs.tolist())):
        pred, nx, j, t = h.find(k)
        node = nx if nx != NIL and int(h.key[nx]) == k else NIL
        exists_live = node != NIL and bool(h.live[node])
        if op == OP_INSERT:
            if exists_live:
                continue
            if node != NIL:
                h.val[node], h.live[node] = v, True
                h.flushes += 1
            elif h.cursor < h.cap:
                nid = h.cursor
                h.key[nid], h.val[nid], h.live[nid] = k, v, True
                h.nxt[nid] = h.nxt[pred]
                h.nxt[pred] = nid
                gk, gn = h.gaps.setdefault(j, ([], []))
                gk.insert(t, k)
                gn.insert(t, nid)
                h.cursor += 1
                h.flushes += 2
            else:
                continue
        elif exists_live:
            h.live[node] = False
            h.flushes += 1
        else:
            continue
        h.fences += 2
        ok[i] = True
    return h.state(), torch.as_tensor(ok, device=h.device)


# --------------------------------------------------------------------- #
# plan/commit engine (the hot path)                                      #
# --------------------------------------------------------------------- #
def update_parallel_ordered(state: OrderedState, ops, ks, vs,
                            towers: Optional[TowerIndex] = None,
                            max_level: int = MAX_LEVEL):
    """One plan/commit round of mixed inserts/deletes over the ordered
    map, bit-identical to :func:`apply_ordered` (state arrays, per-op ok
    flags, flush/fence accounting).  Returns ``(state', ok bool[B],
    OrderedCommitStats)``.  ``towers`` is the pre-batch volatile index;
    when absent it is built from ``state``.  The only host syncs are the
    plan walk's steps."""
    if towers is None:
        towers = build_towers(state, max_level)
    dev = state.key.device
    return _update(state, _i32(ops, dev), _i32(ks, dev), _i32(vs, dev),
                   towers.keys, towers.addr)


def _update(state: OrderedState, ops, ks, vs, tk, ta):
    n = ks.shape[0]
    cap = state.key.shape[0]
    dev = state.key.device
    if n == 0:
        z = torch.tensor(0, dtype=torch.int32, device=dev)
        return state, torch.zeros(0, dtype=torch.bool, device=dev), \
            OrderedCommitStats(z, z, z, z, z)

    # ---- plan: the journey, fully parallel, zero persistence --------- #
    pred, node, snap_live = _plan(state, tk, ta, ks)
    is_ins = ops == OP_INSERT

    # ---- merged conflict resolution: per-key liveness composition ---- #
    order = torch.argsort(ks, stable=True)      # ties keep batch order
    sk = ks[order]
    s_ins = is_ins[order]
    s_node = node[order]
    s_exists = (node != NIL)[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(first, 0) - 1
    pos = torch.arange(n, device=dev)

    prev_live = torch.where(first, snap_live[order], _shift(s_ins, False))
    s_ok = s_ins ^ prev_live      # insert iff dead/absent, delete iff live
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

    s_fresh_nid = torch.where(s_alloc, state.cursor + rank[order], 0)
    seg_nid = _seg_reduce(seg, s_fresh_nid, n, "amax", 0)
    s_nid = torch.where(s_exists, s_node.long(), seg_nid[seg])

    last_ok = _seg_reduce(seg, torch.where(s_ok, pos, -1), n, "amax", -1)
    s_write_live = s_ok & (pos == last_ok[seg])
    last_okins = _seg_reduce(seg, torch.where(s_okins, pos, -1), n, "amax",
                             -1)
    s_write_val = s_okins & (pos == last_okins[seg])

    key = _put(state.key, torch.where(s_alloc, s_nid, cap), sk)
    val = _put(state.val, torch.where(s_write_val, s_nid, cap), vs[order])
    live = _put(state.live, torch.where(s_write_live, s_nid, cap), s_ins)

    # ---- chain splicing: fresh nodes sharing a predecessor, sorted by
    # (pred, key), each linked at its in-group successor, the group's last
    # at the predecessor's snapshot successor, the predecessor at the
    # group's first.  Node ids keep batch order (the allocator rank);
    # predecessor slots (< cursor) and fresh slots (>= cursor) are
    # disjoint scatter targets.
    nid_b = torch.where(alloc, state.cursor + rank, 0)
    pkey = torch.where(alloc, pred.long(), cap)   # non-fresh sort last
    by_key = torch.argsort(ks, stable=True)
    order2 = by_key[torch.argsort(pkey[by_key], stable=True)]
    sp = pkey[order2]
    snid = nid_b[order2]
    sfresh = alloc[order2]
    same_next = torch.zeros(n, dtype=torch.bool, device=dev)
    same_next[:-1] = sp[:-1] == sp[1:]
    succ_snap = state.nxt[sp.clamp(0, cap - 1)].long()
    link = torch.where(same_next, torch.cat([snid[1:], snid.new_zeros(1)]),
                       succ_snap)
    nxt = _put(state.nxt, torch.where(sfresh, snid, cap), link)
    group_first = torch.ones(n, dtype=torch.bool, device=dev)
    group_first[1:] = sp[1:] != sp[:-1]
    group_first &= sfresh
    nxt = _put(nxt, torch.where(group_first, sp, cap), snid)

    # ---- accounting (the oracle's per-op law) + coalesced stats ------- #
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    ok[order] = s_ok
    flushes_per_op = torch.where(alloc, 2, torch.where(ok, 1, 0))
    state = state._replace(
        key=key, val=val, nxt=nxt, live=live,
        cursor=(state.cursor + alloc.sum()).to(torch.int32),
        flushes=(state.flushes + flushes_per_op.sum()).to(torch.int32),
        fences=(state.fences + 2 * ok.sum()).to(torch.int32))
    counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    counts.index_add_(0, pred.long(), ok.to(torch.int32))
    max_group = counts.max()
    stats = OrderedCommitStats(
        ops_committed=ok.sum().to(torch.int32),
        conflict_groups=(counts > 0).sum().to(torch.int32),
        max_group=max_group,
        coalesced_flushes=torch.where(ok, flushes_per_op, 0).sum()
        .to(torch.int32),
        coalesced_fences=(2 * max_group).to(torch.int32))
    return state, ok, stats


# --------------------------------------------------------------------- #
# host-side helpers + the pure differential oracle                       #
# --------------------------------------------------------------------- #
def _chain(state: OrderedState):
    """Node ids of the bottom list in chain order (host), raising on a
    cycle."""
    nxt = state.nxt.cpu().tolist()
    out, node = [], nxt[0]
    while node != NIL:
        if len(out) >= len(nxt):
            raise AssertionError("cycle in bottom list")
        out.append(node)
        node = nxt[node]
    return out


def items_host(state: OrderedState) -> dict:
    """Walk the bottom list on the host: ``{key: (live, val)}`` in chain
    order -- every physical node, dead ones included."""
    key = state.key.cpu().tolist()
    val = state.val.cpu().tolist()
    live = state.live.cpu().tolist()
    return {key[n]: (live[n], val[n]) for n in _chain(state)}


def live_items(state: OrderedState) -> dict:
    """Abstract live content {key: val}."""
    return {k: v for k, (lv, v) in items_host(state).items() if lv}


def check_sorted(state: OrderedState) -> None:
    """Integrity: the physical chain is strictly ascending, cycle-free,
    and threads every allocated node (allocation always links).  Raises
    AssertionError otherwise."""
    key = state.key.cpu().tolist()
    chain = _chain(state)
    prev = KEY_MIN
    for node in chain:
        if key[node] <= prev:
            raise AssertionError(
                f"keys not strictly sorted: {key[node]} after {prev}")
        prev = key[node]
    if len(chain) != int(state.cursor) - 1:
        raise AssertionError(f"chain threads {len(chain)} nodes, "
                             f"{int(state.cursor) - 1} allocated")


def oracle_apply(items: dict, ops, ks, vs, capacity: Optional[int] = None
                 ) -> list:
    """The pure-dict differential oracle: apply one mixed batch to
    ``items`` (``{key: (live, val)}``, mutated in place) in batch order
    with the engine's semantics -- insert iff dead/absent, delete iff
    live, a dead key keeps its node (and last value), and with
    ``capacity`` a fresh insert fails once ``1 + len(items)`` reaches the
    pool.  Returns per-op ok.

    >>> it = {}
    >>> oracle_apply(it, [0, 1, 0], [7, 7, 7], [70, 0, 71])
    [True, True, True]
    >>> it[7]
    (True, 71)
    >>> oracle_apply(it, [0], [9], [90], capacity=2)   # pool full
    [False]
    """
    out = []
    for o, k, v in zip(ops, ks, vs):
        o, k, v = int(o), int(k), int(v)
        lv, old = items.get(k, (False, 0))
        if o == OP_INSERT:
            if lv:
                out.append(False)
            elif k in items:
                items[k] = (True, v)
                out.append(True)
            elif capacity is not None and 1 + len(items) >= capacity:
                out.append(False)
            else:
                items[k] = (True, v)
                out.append(True)
        else:
            if lv:
                items[k] = (False, old)
                out.append(True)
            else:
                out.append(False)
    return out


def oracle_range(items: dict, lo: int, hi: int) -> list:
    """Sorted-dict range oracle: ascending live ``(key, val)`` in
    ``[lo, hi]``.

    >>> oracle_range({3: (True, 30), 4: (False, 0), 9: (True, 90)}, 3, 9)
    [(3, 30), (9, 90)]
    """
    return sorted((k, v) for k, (lv, v) in items.items()
                  if lv and lo <= k <= hi)


# --------------------------------------------------------------------- #
# the durable deployment surface (journaled batches through StagedIO)    #
# --------------------------------------------------------------------- #
class DurableOrderedMap:
    """Ordered map whose committed batches are the durable surface.

    Each :meth:`update` journals its batch as one staged round file --
    write -> flush -> fence -> atomic publish (``ord_NNNNNN.json``) --
    before the engine applies it, so an acknowledged batch is always
    recoverable and a crash replays a strict prefix of the acknowledged
    stream.  :meth:`snapshot` publishes the bottom list (towers are never
    persisted) and trims the rounds it covers.  Recovery (``__init__``)
    loads the newest valid snapshot, replays the round suffix through the
    same engine and rebuilds the towers.  The files are byte-identical to
    the reference's, so a directory written by either package recovers
    in the other."""

    def __init__(self, root, capacity: int = 256,
                 max_level: int = MAX_LEVEL, seed: int = 0, device=None):
        from ..persistence.manifest import StagedIO
        self.io = StagedIO(Path(root), seed=seed)
        self.device = resolve_device(device)
        self.capacity = capacity
        self.max_level = max_level
        self.state = make_ordered(capacity, self.device)
        self._n = 0                 # next round index
        self._snap_name: Optional[str] = None
        self._recover()
        self.towers = build_towers(self.state, max_level)

    # -- recovery ------------------------------------------------------ #
    @staticmethod
    def _round_index(name: str) -> Optional[int]:
        try:
            return int(name[len("ord_"):-len(".json")])
        except ValueError:
            return None

    def _recover(self) -> None:
        root = Path(self.io.root)
        snaps = sorted(p.name for p in root.glob("osnap_*.json"))
        horizon = 0
        for name in reversed(snaps):
            try:
                data = json.loads(self.io.read(name).decode())
                self.state = state_from_numpy(
                    {f: data[f] for f in OrderedState._fields},
                    self.device)
                horizon = int(data["horizon"])
                self._snap_name = name
                break
            except (OSError, json.JSONDecodeError, KeyError, ValueError):
                continue            # torn snapshot: fall back to older
        rounds = []
        for p in sorted(root.glob("ord_*.json")):
            idx = self._round_index(p.name)
            if idx is None or idx < horizon:
                continue
            try:
                rounds.append((idx, json.loads(self.io.read(p.name)
                                               .decode())))
            except (OSError, json.JSONDecodeError, ValueError):
                continue            # torn round (never published whole)
        self._n = horizon
        for idx, rec in sorted(rounds):
            self.state, _, _ = update_parallel_ordered(
                self.state, np.asarray(rec["ops"], np.int32),
                np.asarray(rec["ks"], np.int32),
                np.asarray(rec["vs"], np.int32), max_level=self.max_level)
            self._n = idx + 1

    # -- the durable commit path --------------------------------------- #
    def update(self, ops, ks, vs) -> np.ndarray:
        """Journal one mixed batch, then apply it through the plan/commit
        engine.  Returns per-op ok flags (numpy bool[B])."""
        rec = {"ops": [int(o) for o in ops],
               "ks": [int(k) for k in ks],
               "vs": [int(v) for v in vs]}
        rel = f"ord_{self._n:06d}.json"
        self.io.write("ord.tmp", json.dumps(rec).encode())
        self.io.flush("ord.tmp")
        self.io.fence()
        self.io.publish("ord.tmp", rel)
        self._n += 1
        self.state, ok, _ = update_parallel_ordered(
            self.state, np.asarray(ops, np.int32), np.asarray(ks, np.int32),
            np.asarray(vs, np.int32), towers=self.towers,
            max_level=self.max_level)
        self.towers = build_towers(self.state, self.max_level)
        return ok.cpu().numpy()

    def insert(self, ks, vs) -> np.ndarray:
        return self.update(np.full(len(ks), OP_INSERT, np.int32), ks, vs)

    def delete(self, ks) -> np.ndarray:
        return self.update(np.full(len(ks), OP_DELETE, np.int32), ks,
                           np.zeros(len(ks), np.int32))

    def snapshot(self) -> Optional[str]:
        """Publish the engine state (bottom list only: towers stay
        volatile) and trim the covered rounds and the superseded
        snapshot, with the same staged discipline as a round."""
        if self._n == 0:
            return None
        a = state_to_numpy(self.state)
        payload = json.dumps({
            "horizon": self._n,
            "key": a["key"].tolist(),
            "val": a["val"].tolist(),
            "nxt": a["nxt"].tolist(),
            "live": a["live"].astype(int).tolist(),
            "cursor": int(a["cursor"]),
            "flushes": int(a["flushes"]),
            "fences": int(a["fences"]),
        })
        final = f"osnap_{self._n:08d}.json"
        self.io.write("osnap.tmp", payload.encode())
        self.io.flush("osnap.tmp")
        self.io.fence()
        self.io.publish("osnap.tmp", final)
        old, self._snap_name = self._snap_name, final
        for p in sorted(Path(self.io.root).glob("ord_*.json")):
            idx = self._round_index(p.name)
            if idx is not None and idx < self._n:
                self.io.unlink(p.name)
        if old is not None:
            self.io.unlink(old)
        return final

    # -- reads --------------------------------------------------------- #
    def lookup(self, ks):
        found, vals = lookup_ordered(self.state, ks, self.towers)
        return found.cpu().numpy(), vals.cpu().numpy()

    def range(self, lo: int, hi: int, max_items: int):
        total, ks, vs = range_query(self.state, lo, hi, max_items,
                                    self.towers)
        m = min(int(total), max_items)
        return int(total), ks.cpu().numpy()[:m], vs.cpu().numpy()[:m]

    def items(self) -> dict:
        return items_host(self.state)
