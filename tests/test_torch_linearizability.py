"""The port's interleaving scheduler and linearizability checkers
(``repro_torch.core.{scheduler,linearizability}``) against the JAX
package's on the CPU, and the bridges from the instruction level to the
port's batched engines.

The same seeded ``Interleaver`` runs, with and without a crash, give the
same ``OpRecord`` histories, recovered states and verdicts in both
packages for all six structures, and each package's checker gives the
same verdict on the other's history; a volatile-policy history is
rejected by both with the same explanation.  The engine bridges run the
port's ``update_parallel`` / ``update_parallel_ordered`` /
``DurableOrderedMap`` / ``build_towers`` on the CPU and judge them with
both packages' checkers.  ``chip_smoke.py``'s paper phase runs the same
functions on the card, where only the port's checker exists.  Every
comparison is exact."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro_torch.core import batched as B
from repro_torch.core import ordered as O

REF, PORT = cs.core_modules("repro"), cs.PORT_CORE
CPU = torch.device("cpu")
STRUCTURES = ("list", "hash", "bst", "skiplist", "queue", "stack")


def history(recs) -> list:
    return [(r.opid, r.op, r.args, r.invoke_step, r.respond_step, r.result)
            for r in recs]


def trial_pair(name, policy, seed, crash_at, evict) -> dict:
    """One trial in each package; histories, states and verdicts equal,
    and each checker agrees on the other package's history."""
    ref = cs.crash_trial(name, policy, seed, crash_at, evict, core=REF)
    port = cs.crash_trial(name, policy, seed, crash_at, evict, core=PORT)
    assert history(port["records"]) == history(ref["records"])
    assert port["state"] == ref["state"]
    assert port["crashed"] == ref["crashed"]
    assert port["steps"] == ref["steps"]
    assert port["ok"] == ref["ok"]
    for recs, core in ((ref["records"], PORT), (port["records"], REF)):
        assert cs.history_verdict(name, recs, port["state"],
                                  port["initial"], core) == port["ok"]
    return port


MODES = {"run": ("nvtraverse", None), "none": ("nvtraverse", "none"),
         "all": ("nvtraverse", "all"), "random": ("nvtraverse", "random"),
         "izraelevitz": ("izraelevitz", "random")}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", STRUCTURES)
def test_interleavings_and_verdicts_equal(name, mode):
    """Uncrashed runs, then the same interleaving crashed at a quarter, a
    half and three quarters of its steps (``chip_smoke.paper_histories``'
    schedule)."""
    policy, evict = MODES[mode]
    for seed in cs.HIST_SEEDS:
        run = trial_pair(name, policy, seed, None, evict or "none")
        assert run["ok"] and not run["crashed"]
        assert all(r.completed for r in run["records"])
        if evict is None:
            continue
        acked = []
        for q in cs.HIST_CRASH_QUARTERS:
            got = trial_pair(name, policy, seed, run["steps"] * q // 4,
                             evict)
            assert got["crashed"] and got["ok"], (name, mode, seed, q)
            acked.append(sum(r.completed for r in got["records"]))
        assert acked == sorted(acked) and acked[-1] > 0


def test_volatile_history_rejected_with_the_same_explanation():
    """No flush at all: a completed update is lost at the crash (after
    ``tests/test_core_list.py:test_volatile_policy_is_not_durable``)."""
    got = trial_pair("list", "volatile", **cs.VOLATILE_LOSS)
    assert got["crashed"] and not got["ok"]
    why = [sorted(core.linearizability.explain_failure(
        got["records"], got["state"], got["initial"]))
        for core in (REF, PORT)]
    assert why[0] == why[1] != []


def test_paper_phase_histories_on_the_cpu():
    out = cs.paper_histories()
    quarters = len(cs.HIST_SEEDS) * 3 * len(cs.HIST_CRASH_QUARTERS)
    for name in STRUCTURES:
        for policy in ("nvtraverse", "izraelevitz"):
            got = out[f"{name}_{policy}"]
            assert got["crashed"] == quarters
            assert got["histories"] == quarters + len(cs.HIST_SEEDS)
    assert out["volatile_list_rejected"]


def test_checkers_equal_on_hand_made_histories():
    """Verdicts of both packages on small histories, including real-time
    violations, wrong return values and corrupt recovered states."""
    def rec(core, i, op, k, inv, rsp, res):
        return core.scheduler.OpRecord(i, op, (k,), inv, rsp, res)

    cases = [  # (ops, recovered or None, initial)
        ([("insert", 1, 0, 3, True), ("find", 1, 4, 5, True)], None, []),
        ([("insert", 1, 0, 3, True), ("find", 1, 4, 5, False)], None, []),
        ([("insert", 1, 0, 5, True), ("find", 1, 1, 2, False)], None, []),
        ([("delete", 2, 0, 1, True), ("insert", 2, 2, None, None)], {2},
         [2]),
        ([("insert", 3, 0, 1, True)], set(), []),
        ([("insert", 3, 0, None, None)], {3, 4}, []),
    ]
    for ops, recovered, initial in cases:
        verdicts = []
        for core in (REF, PORT):
            recs = [rec(core, i, *o) for i, o in enumerate(ops)]
            lin = core.linearizability
            verdicts.append(
                (lin.check_linearizable(recs, initial)
                 if recovered is None else
                 lin.check_durably_linearizable(recs, recovered, initial),
                 sorted(lin.explain_failure(recs, recovered or set(),
                                            initial)),
                 {k: len(v) for k, v in lin.group_by_key(recs).items()}))
        assert verdicts[0] == verdicts[1], ops


# --------------------------------------------------------------------- #
# bridges to the port's engines                                          #
# --------------------------------------------------------------------- #
def strip_times(d):
    if isinstance(d, dict):
        return {k: strip_times(v) for k, v in d.items()
                if not str(k).endswith("_s") and k != "s"}
    return d


def test_fence_bridge_three_fences_against_the_engines_two():
    """``tests/test_batched_hashmap.py``'s cross-check on the port's
    ``update_parallel``: 40 keys, 3 fences an op at the instruction level
    in both packages, 2 in the engine, the same contents."""
    ks = list(range(1, 41))
    fences, contents = [], []
    for core in (REF, PORT):
        mem = core.pmem.PMem(1 << 16)
        ht = core.hash_table.HashTable(mem, n_buckets=8)
        pol = core.policies.get_policy("nvtraverse")
        mem.counters.reset()
        for k in ks:
            core.traversal.run_operation(ht, pol, "insert", (k, k))
        fences.append(mem.counters.fences / len(ks))
        contents.append(ht.contents())
    st = B.make_state(1024, 8, CPU)
    st, ok, _ = B.update_parallel(st, np.zeros(40, np.int32), ks, ks, 8)
    found, vals = B.lookup(st, ks, 8)
    assert bool(ok.all()) and bool(found.all())
    assert fences == [3.0, 3.0] and int(st.fences) / len(ks) == 2.0
    assert contents[0] == contents[1] == dict(zip(ks, vals.tolist()))


@pytest.mark.parametrize("part", ["fence_bridge", "engine_history",
                                  "crash_prefixes", "towers"])
def test_paper_phase_bridges_equal_under_both_checkers(part):
    """The paper phase's bridges at the rehearsal size on the CPU: the same
    results with the reference's instruction-level structures and checker
    as with the port's."""
    fn = getattr(cs, f"paper_{part}")
    got = [strip_times(fn(cs.SMALL, CPU, 1, core=core))
           for core in (REF, PORT)]
    assert got[0] == got[1]
    if part == "fence_bridge":
        assert got[1]["fences_per_op"] == {"instruction": 3.0,
                                           "engine": 2.0}


def test_engine_batches_judged_by_both_checkers():
    """``tests/test_ordered.py``'s engine history on the port's ordered
    engine: five concurrent batches linearize; one flipped ok flag makes
    both checkers reject the history."""
    rng = np.random.default_rng(31)
    stt = O.make_ordered(256, CPU)
    batches, oks = [], []
    for _ in range(5):
        b = (rng.integers(0, 2, 12).astype(np.int32),
             rng.integers(0, 10, 12).astype(np.int32),
             rng.integers(0, 1000, 12).astype(np.int32))
        stt, ok, _ = O.update_parallel_ordered(stt, *b)
        batches.append(b)
        oks.append(ok.numpy())
    for core in (REF, PORT):
        recs = cs.batch_records(batches, oks, core)
        assert core.linearizability.check_linearizable(recs)
        assert core.linearizability.check_durably_linearizable(
            recs, set(O.live_items(stt)))
    oks[2] = oks[2].copy()
    oks[2][0] = not oks[2][0]
    for core in (REF, PORT):
        assert not core.linearizability.check_linearizable(
            cs.batch_records(batches, oks, core))


def test_engine_crash_prefix_replays_durably_linearizable():
    """``tests/test_ordered.py``'s replay of every durable prefix on the
    port's ordered engine, judged by both packages' checkers."""
    rng = np.random.default_rng(37)
    batches = [(rng.integers(0, 2, 8).astype(np.int32),
                rng.integers(0, 12, 8).astype(np.int32),
                rng.integers(0, 1000, 8).astype(np.int32))
               for _ in range(4)]
    stt, oks = O.make_ordered(256, CPU), []
    for b in batches:
        stt, ok, _ = O.update_parallel_ordered(stt, *b)
        oks.append(ok.numpy())
    for c in range(len(batches) + 1):
        stt = O.make_ordered(256, CPU)
        for b in batches[:c]:
            stt, _, _ = O.update_parallel_ordered(stt, *b)
        recovered = set(O.live_items(stt))
        for core in (REF, PORT):
            assert core.linearizability.check_durably_linearizable(
                cs.batch_records(batches, oks, core,
                                 crashed_batch=c if c < 4 else None),
                recovered), f"prefix {c}"


def test_skiplist_rebuild_matches_the_ports_build_towers():
    """``tests/test_ordered.py``'s bridge on the port: the port's
    ``SkipList`` recovery rebuild and ``build_towers`` promote the same
    keys to the same levels, and the rebuild is a fixed point."""
    indexes = []
    for core in (REF, PORT):
        mem = core.pmem.PMem(4096)
        sl = core.skiplist.SkipList(mem, max_level=8)
        pol = core.policies.get_policy("nvtraverse")
        keys = [3, 17, 29, 41, 53, 65, 77, 89, 101]
        for k in keys:
            assert core.traversal.run_operation(sl, pol, "insert", (k, 2 * k))
        for k in (29, 65):
            assert core.traversal.run_operation(sl, pol, "delete", (k,))
        sl.rebuild_index()
        before = {lvl: list(v) for lvl, v in sl.index.items()}
        sl.rebuild_index()
        assert sl.index == before
        indexes.append(sl.index)
    assert indexes[0] == indexes[1]
    live = np.asarray([k for k in keys if k not in (29, 65)], np.int32)
    stt, ok, _ = O.update_parallel_ordered(
        O.make_ordered(64, CPU), np.zeros(live.size, np.int32), live,
        2 * live)
    assert bool(ok.all())
    tw = O.build_towers(stt)
    for lvl in range(2, 9):
        seed_keys = [k for k, _ in indexes[1][lvl]]
        row = tw.keys[lvl - 2].numpy()
        assert row[:len(seed_keys)].tolist() == seed_keys, lvl
        assert (row[len(seed_keys):] == O.KEY_PAD).all()
