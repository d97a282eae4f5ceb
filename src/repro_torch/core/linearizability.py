"""Linearizability and durable-linearizability checking (set semantics).
(the port's own copy of ``repro.core.linearizability``)

Durable linearizability [26] (paper §2): an execution history with crash
events is durably linearizable if, after removing crash events, the history
is linearizable — completed operations may not be lost, in-flight operations
are all-or-nothing, and taken-effect operations have their dependencies
taken effect.

For set ADTs (insert/delete/find keyed by ``k``), operations on distinct
keys commute, so a history is (durably) linearizable iff each per-key
sub-history is — which keeps the Wing & Gong style search tractable.  Per
key we search for a linearization of

    all completed operations  ∪  any subset of crash-pending operations

that (a) respects real-time order, (b) matches every completed operation's
return value under sequential set semantics, and (c) ends in the observed
post-recovery membership.  Pending ops carry no return-value constraint but
must linearize after their invocation.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .scheduler import OpRecord

INF = float("inf")


def _sem(op: str, present: bool) -> Tuple[bool, bool]:
    """Sequential set semantics: returns (ret, present')."""
    if op == "insert":
        return (not present), True
    if op == "delete":
        return present, False
    if op == "find":
        return present, present
    raise ValueError(op)


def _check_key(ops: Sequence[OpRecord], init_present: bool,
               final_present: Optional[bool]) -> bool:
    """Search for a valid linearization of one key's sub-history.

    ``final_present`` is the observed post-recovery membership (None when
    there was no crash — then only return values are checked).
    """
    completed = [o for o in ops if o.completed]
    pending = [o for o in ops if not o.completed and o.invoked]
    n_c, n_p = len(completed), len(pending)

    inv = [o.invoke_step for o in completed] + [o.invoke_step for o in pending]
    rsp = [o.respond_step for o in completed] + [INF] * n_p
    kinds = [o.op for o in completed] + [o.op for o in pending]
    rets = [bool(o.result) for o in completed] + [None] * n_p
    n = n_c + n_p

    @lru_cache(maxsize=None)
    def dfs(used_mask: int, present: bool) -> bool:
        if used_mask == (1 << n) - 1:
            return final_present is None or present == final_present
        # completion check: all completed ops must eventually be used;
        # pending ops may be dropped — allow "stop" if only pending remain.
        only_pending_left = all(
            (used_mask >> i) & 1 for i in range(n_c))
        if only_pending_left and (final_present is None
                                  or present == final_present):
            return True
        for i in range(n):
            if (used_mask >> i) & 1:
                continue
            # real-time: i may linearize now only if no unused op responded
            # strictly before i's invocation.
            ok = True
            for j in range(n):
                if j != i and not (used_mask >> j) & 1 and rsp[j] < inv[i]:
                    ok = False
                    break
            if not ok:
                continue
            ret, nxt = _sem(kinds[i], present)
            if rets[i] is not None and ret != rets[i]:
                continue
            if dfs(used_mask | (1 << i), nxt):
                return True
        return False

    return dfs(0, init_present)


def group_by_key(records: Iterable[OpRecord]) -> Dict[int, List[OpRecord]]:
    out: Dict[int, List[OpRecord]] = {}
    for r in records:
        out.setdefault(r.args[0], []).append(r)
    return out


def check_linearizable(records: Sequence[OpRecord],
                       initial_keys: Iterable[int] = ()) -> bool:
    """Crash-free check: all ops completed; return values must linearize."""
    initial = set(initial_keys)
    for key, ops in group_by_key(records).items():
        if not _check_key(ops, key in initial, None):
            return False
    return True


def check_durably_linearizable(records: Sequence[OpRecord],
                               recovered_keys: Iterable[int],
                               initial_keys: Iterable[int] = (),
                               universe: Optional[Iterable[int]] = None) -> bool:
    """Post-crash check against the recovered abstract state.

    ``recovered_keys``: keys present after crash + recovery.
    ``universe``: all keys that must be explained (defaults to keys touched
    by ops ∪ recovered ∪ initial — a recovered key nobody ever inserted is
    a corruption and fails).
    """
    initial = set(initial_keys)
    recovered = set(recovered_keys)
    by_key = group_by_key(records)
    keys = set(by_key) | recovered | initial
    if universe is not None:
        keys |= set(universe)
    for key in keys:
        ops = by_key.get(key, [])
        if not _check_key(ops, key in initial, key in recovered):
            return False
    return True


def check_queue_durably_linearizable(records: Sequence[OpRecord],
                                     recovered: Sequence[int],
                                     initial: Sequence[int] = ()) -> bool:
    """FIFO-queue variant: search for a linearization of completed ops ∪
    subset(pending) that matches all completed return values and ends with
    the recovered queue contents (``None`` recovered ⇒ return-values only).

    Enqueue values are assumed unique per history (the tests enforce it),
    which keeps the state space tiny.
    """
    recs = [o for o in records if o.invoked]
    n = len(recs)
    inv = [o.invoke_step for o in recs]
    rsp = [o.respond_step if o.completed else INF for o in recs]
    target = None if recovered is None else tuple(recovered)
    memo: dict = {}

    def dfs(used_mask: int, state: tuple) -> bool:
        key = (used_mask, state)
        if key in memo:
            return memo[key]
        done_completed = all(
            (used_mask >> i) & 1 for i in range(n) if recs[i].completed)
        if done_completed and (target is None or state == target):
            memo[key] = True
            return True
        ok = False
        for i in range(n):
            if (used_mask >> i) & 1:
                continue
            if any(j != i and not (used_mask >> j) & 1 and rsp[j] < inv[i]
                   for j in range(n)):
                continue
            o = recs[i]
            if o.op == "enqueue":
                nxt_state = state + (o.args[0],)
                ret = True
            elif o.op == "dequeue":
                if state:
                    ret, nxt_state = state[0], state[1:]
                else:
                    ret, nxt_state = None, state
            else:
                raise ValueError(o.op)
            if o.completed and o.result != ret:
                continue
            if dfs(used_mask | (1 << i), nxt_state):
                ok = True
                break
        memo[key] = ok
        return ok

    return dfs(0, tuple(initial))


def check_stack_durably_linearizable(records: Sequence[OpRecord],
                                     recovered: Sequence[int],
                                     initial: Sequence[int] = ()) -> bool:
    """LIFO variant of the queue checker.  ``recovered``: top-first."""
    recs = [o for o in records if o.invoked]
    n = len(recs)
    inv = [o.invoke_step for o in recs]
    rsp = [o.respond_step if o.completed else INF for o in recs]
    # state: bottom..top tuple; recovered list is top-first
    target = None if recovered is None else tuple(reversed(recovered))
    memo: dict = {}

    def dfs(used_mask: int, state: tuple) -> bool:
        key = (used_mask, state)
        if key in memo:
            return memo[key]
        done_completed = all(
            (used_mask >> i) & 1 for i in range(n) if recs[i].completed)
        if done_completed and (target is None or state == target):
            memo[key] = True
            return True
        ok = False
        for i in range(n):
            if (used_mask >> i) & 1:
                continue
            if any(j != i and not (used_mask >> j) & 1 and rsp[j] < inv[i]
                   for j in range(n)):
                continue
            o = recs[i]
            if o.op == "push":
                ret, nxt_state = True, state + (o.args[0],)
            elif o.op == "pop":
                if state:
                    ret, nxt_state = state[-1], state[:-1]
                else:
                    ret, nxt_state = None, state
            else:
                raise ValueError(o.op)
            if o.completed and o.result != ret:
                continue
            if dfs(used_mask | (1 << i), nxt_state):
                ok = True
                break
        memo[key] = ok
        return ok

    return dfs(0, tuple(reversed(list(initial))))


def explain_failure(records: Sequence[OpRecord],
                    recovered_keys: Iterable[int],
                    initial_keys: Iterable[int] = ()) -> List[str]:
    """Diagnostic: list the keys whose sub-history cannot linearize."""
    initial, recovered = set(initial_keys), set(recovered_keys)
    by_key = group_by_key(records)
    bad = []
    for key in set(by_key) | recovered | initial:
        ops = by_key.get(key, [])
        if not _check_key(ops, key in initial, key in recovered):
            ev = [(o.op, o.invoke_step, o.respond_step, o.result) for o in ops]
            bad.append(f"key={key} recovered={key in recovered} ops={ev}")
    return bad
