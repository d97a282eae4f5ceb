"""The port's instruction-level layer (``repro_torch.core.{pmem,instr,
policies,traversal}`` and the six traversal structures) against the JAX
package's on the CPU: the same seeded operations through both give equal
return values, abstract contents, instruction counters and memory images
after every operation, under every policy; the same crash sites, crash
images and recovered contents; the same traverse-phase write errors; and
the same per-op counts on the paper's cost-model workloads
(``benchmarks/paper_figures.py:run_workload``).  Every comparison is
exact."""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from benchmarks.paper_figures import run_workload

MODULES = ("pmem", "instr", "policies", "traversal", "harris_list",
           "hash_table", "bst", "skiplist", "queue", "stack")


def package(name: str) -> SimpleNamespace:
    ns = SimpleNamespace(**{m: importlib.import_module(f"{name}.core.{m}")
                            for m in MODULES})
    ns.faultinject = importlib.import_module(
        f"{name}.robustness.faultinject")
    return ns


REF, PORT = package("repro"), package("repro_torch")
STRUCTURES = ("list", "hash", "bst", "skiplist", "queue", "stack")
POLICIES = ("volatile", "izraelevitz", "nvtraverse")


def op_stream(name: str, rng, n: int, key_hi: int = 40) -> list:
    """Seeded ops for one structure: a set mix, or FIFO/LIFO traffic with
    unique values."""
    ops, v = [], 100
    for _ in range(n):
        if name in ("queue", "stack"):
            if rng.random() < 0.6:
                ops.append(("enqueue" if name == "queue" else "push", (v,)))
                v += 1
            else:
                ops.append(("dequeue" if name == "queue" else "pop", ()))
        else:
            op = rng.choice(["insert", "delete", "find"])
            k = int(rng.integers(0, key_hi))
            ops.append((str(op), (k, k * 10) if op == "insert" else (k,)))
    return ops


PREFILL = {"queue": ("enqueue", [(v,) for v in range(1, 6)]),
           "stack": ("push", [(v,) for v in range(1, 6)])}


def prefill(name: str, ns, ds) -> None:
    op, args = PREFILL.get(name, ("insert",
                                  [(k, k * 10) for k in range(0, 24, 3)]))
    pol = ns.policies.get_policy("nvtraverse")
    for a in args:
        ns.traversal.run_operation(ds, pol, op, a)


class Twin:
    """One structure in each package, on equal memories."""

    def __init__(self, name: str, capacity: int = 1 << 14, seed: int = 0):
        self.name = name
        self.sides = []
        for ns in (REF, PORT):
            mem = ns.pmem.PMem(capacity, seed=seed)
            self.sides.append((ns, mem, cs.hist_structure(ns, name, mem)))

    def run(self, policy: str, op: str, args):
        got = [ns.traversal.run_operation(ds, ns.policies.get_policy(policy),
                                          op, args)
               for ns, _, ds in self.sides]
        assert got[0] == got[1], (op, args, got)
        return got[0]

    def assert_same(self, ctx="") -> None:
        (_, m0, d0), (_, m1, d1) = self.sides
        assert d0.contents() == d1.contents(), ctx
        assert d0.persistent_contents() == d1.persistent_contents(), ctx
        assert m0.counters.snapshot() == m1.counters.snapshot(), ctx
        for f in ("volatile", "persistent", "dirty", "flushed_line"):
            np.testing.assert_array_equal(getattr(m0, f), getattr(m1, f),
                                          err_msg=f"{ctx}: {f}")
        assert m0.alloc_cursor == m1.alloc_cursor, ctx


# --------------------------------------------------------------------- #
# each structure under each policy, op by op                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", STRUCTURES)
def test_every_op_equal_in_both_packages(name, policy):
    tw = Twin(name)
    tw.assert_same("after construction")
    prefill(name, REF, tw.sides[0][2])
    prefill(name, PORT, tw.sides[1][2])
    tw.assert_same("after prefill")
    for i, (op, args) in enumerate(op_stream(name,
                                             np.random.default_rng(5), 80)):
        tw.run(policy, op, args)
        tw.assert_same(f"op {i} {op}{args}")
    for _, _, ds in tw.sides:
        ds.check_integrity()
    if name == "skiplist":
        assert tw.sides[0][2].index == tw.sides[1][2].index


# --------------------------------------------------------------------- #
# crash images: a CrashPlan fires mid-operation in both packages         #
# --------------------------------------------------------------------- #
EVICTS = {"none": "none", "all": "all", "random": "random",
          "lines": list(range(0, 1 << 11, 3))}


@pytest.mark.parametrize("evict", EVICTS)
@pytest.mark.parametrize("name", STRUCTURES)
def test_crash_mid_operation_same_images_and_recovery(name, evict):
    """Both packages' PMem, attached to their own CrashPlan, crash before
    the same site with the same eviction; the crash images, the volatile
    view reloaded from them and the contents recovered by ``disconnect``
    are equal, and the recovered structure is durable and unmarked."""
    tw = Twin(name, seed=9)
    ops = op_stream(name, np.random.default_rng(2), 40)
    plans = []
    for ns, mem, ds in tw.sides:
        prefill(name, ns, ds)
        mem.persist_all()
        plan = ns.faultinject.CrashPlan(crash_at=57, evict=EVICTS[evict])
        plans.append(plan.attach(mem))
        pol = ns.policies.get_policy("nvtraverse")
        with pytest.raises(ns.faultinject.CrashPoint):
            for op, args in ops:
                ns.traversal.run_operation(ds, pol, op, args)
    site = lambda s: (s.index, s.kind, s.target)  # noqa: E731
    assert [site(s) for s in plans[0].sites] == \
        [site(s) for s in plans[1].sites]
    assert site(plans[0].fired_at) == site(plans[1].fired_at) == \
        site(plans[1].sites[57])
    tw.assert_same("crash image")
    for _, mem, ds in tw.sides:
        mem.faults = None
        if name == "skiplist":
            ds.index = {}                 # the towers die with the crash
        ds.disconnect()
        ds.check_integrity(require_unmarked=True)
    tw.assert_same("recovered")
    if name == "skiplist":
        assert tw.sides[0][2].index == tw.sides[1][2].index


def test_pmem_crash_sites_and_crash_before_the_sites_instruction():
    """After ``tests/test_faultinject.py``'s PMem cases: the same sites,
    and the fired site's own instruction never executes."""
    for ns in (REF, PORT):
        mem = ns.pmem.PMem(64, line_words=8)
        plan = ns.faultinject.CrashPlan().attach(mem)
        mem.write(8, 1)
        mem.flush(8)
        mem.fence()
        mem.cas(16, 0, 5)
        assert [(s.kind, s.target) for s in plan.sites] == [
            ("flush", "line:1"), ("fence", ""), ("publish", "addr:16")]
        mem2 = ns.pmem.PMem(64, line_words=8)
        ns.faultinject.CrashPlan(crash_at=1).attach(mem2)
        mem2.write(8, 1)
        mem2.flush(8)
        with pytest.raises(ns.faultinject.CrashPoint) as ei:
            mem2.fence()
        assert ei.value.site.index == 1 and ei.value.site.kind == "fence"
        assert mem2.counters.fences == 0
        assert mem2.persistent[8] == 0 and mem2.volatile[8] == 0


@pytest.mark.parametrize("evict", ["none", "all", "random", "lines"])
def test_pmem_crash_adversaries_equal(evict):
    """Direct ``crash(evict=...)`` on dirty, flushed and fenced lines: the
    same persistent image in both packages (the seeded adversary too)."""
    images = []
    for ns in (REF, PORT):
        m = ns.pmem.PMem(256, line_words=8, seed=4)
        rng = np.random.default_rng(1)
        for a in rng.integers(8, 256, 60):
            m.write(int(a), int(a) * 7)
        for a in rng.integers(8, 256, 10):
            m.flush(int(a))
        m.fence()
        for a in rng.integers(8, 256, 20):
            m.write(int(a), -int(a))
        m.crash(evict=EVICTS[evict] if evict != "lines" else [1, 4, 9, 30],
                p_evict=0.5)
        assert not m.dirty.any()
        np.testing.assert_array_equal(m.volatile, m.persistent)
        images.append(m.persistent.copy())
    np.testing.assert_array_equal(*images)


# --------------------------------------------------------------------- #
# Property 4(1): the journey may not write                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("instr", ["write", "cas"])
@pytest.mark.parametrize("name", STRUCTURES)
def test_write_during_traverse_raises(name, instr):
    for ns in (REF, PORT):
        mem = ns.pmem.PMem(1 << 12)
        ds = cs.hist_structure(ns, name, mem)
        before = mem.counters.snapshot()
        image = mem.volatile.copy()

        def bad_traverse(ctx, entry, op, args):
            if instr == "write":
                ctx.write(entry + 1, 7)
            else:
                ctx.cas(entry + 1, 0, 7)

        ds.traverse = bad_traverse
        op = {"queue": "dequeue", "stack": "pop"}.get(name, "find")
        with pytest.raises(ns.instr.TraversalWriteError,
                           match={"write": "write", "cas": "CAS"}[instr]
                           + " during traverse phase"):
            ns.traversal.run_operation(ds, ns.policies.get_policy(
                "nvtraverse"), op, (1,) if op == "find" else ())
        assert mem.counters.writes == before["writes"]
        assert mem.counters.cas == before["cas"]
        np.testing.assert_array_equal(mem.volatile, image)


def test_skiplist_rebuild_index_after_deletes_equal():
    tw = Twin("skiplist")
    rng = np.random.default_rng(3)
    keys = [int(k) for k in rng.permutation(200)[:90]]
    for k in keys:
        tw.run("nvtraverse", "insert", (k, k * 2))
    for k in keys[::4]:
        tw.run("nvtraverse", "delete", (k,))
    incremental = [dict(ds.index) for _, _, ds in tw.sides]
    for _, _, ds in tw.sides:
        ds.rebuild_index()
    assert tw.sides[0][2].index == tw.sides[1][2].index
    assert [ds.index for _, _, ds in tw.sides] == incremental
    live = sorted(set(keys) - set(keys[::4]))
    for lvl in range(2, 7):
        want = [k for k in live
                if PORT.skiplist.tower_height(k, 6) >= lvl]
        assert [k for k, _ in tw.sides[1][2].index[lvl]] == want
    tw.assert_same("after rebuild")


def test_pack_helpers_equal():
    for w in (0, 1, 2, 77, 1 << 40):
        for ns in (REF, PORT):
            assert ns.instr.unpack(ns.instr.pack(w, 1)) == (w, 1)
        assert PORT.instr.with_mark(w) == REF.instr.with_mark(w)
        assert PORT.instr.is_marked(w) == REF.instr.is_marked(w)
    for l, r, m in ((1, 2, 0), (5, (1 << 30) - 1, 1), (9, 0, 2)):
        w = REF.bst.pack_cw(l, r, m)
        assert PORT.bst.pack_cw(l, r, m) == w
        assert PORT.bst.unpack_cw(w) == REF.bst.unpack_cw(w) == (l, r, m)
        assert PORT.bst.cw_is_marked(w) == REF.bst.cw_is_marked(w)


# --------------------------------------------------------------------- #
# the paper's flush/fence economy, op by op                              #
# --------------------------------------------------------------------- #
def workload(ns, structure: str, policy: str, size: int, n_ops: int,
             update_pct: int = 20, seed: int = 0):
    """``run_workload``'s workload, yielding each op's counters: an
    nvtraverse prefill of ``size`` keys, then a ``update_pct`` mix."""
    rng = np.random.default_rng(seed)
    mem = ns.pmem.PMem(1 << 19)
    ds = {"list": lambda: ns.harris_list.HarrisList(mem),
          "hash": lambda: ns.hash_table.HashTable(mem, n_buckets=64),
          "bst": lambda: ns.bst.ExternalBST(mem),
          "skiplist": lambda: ns.skiplist.SkipList(mem)}[structure]()
    nv, pol = (ns.policies.get_policy(p) for p in ("nvtraverse", policy))
    for k in rng.permutation(2 * size)[:size]:
        ns.traversal.run_operation(ds, nv, "insert", (int(k), 1))
    mem.persist_all()
    mem.counters.reset()
    for _ in range(n_ops):
        r = rng.random()
        k = int(rng.integers(0, 2 * size))
        op, args = (("insert", (k, 1)) if r < update_pct / 200 else
                    ("delete", (k,)) if r < update_pct / 100 else
                    ("find", (k,)))
        before = mem.counters.snapshot()
        got = ns.traversal.run_operation(ds, pol, op, args)
        after = mem.counters.snapshot()
        yield op, got, {f: after[f] - before[f] for f in after}


ECONOMY = [("list", 256, 150), ("hash", 512, 100), ("bst", 512, 100),
           ("skiplist", 512, 100)]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("structure,size,n_ops", ECONOMY)
def test_paper_workload_counts_equal_per_op(structure, size, n_ops, policy):
    ref = list(workload(REF, structure, policy, size, n_ops))
    port = list(workload(PORT, structure, policy, size, n_ops))
    assert port == ref
    # the replica is run_workload's own workload
    total = {f: sum(c[f] for _, _, c in port) for f in port[0][2]}
    want = run_workload(structure, policy, size=size, update_pct=20,
                        n_ops=n_ops)
    assert total["fences"] / n_ops == want["fences_per_op"]
    assert total["flushes"] / n_ops == want["flushes_per_op"]
    if policy == "nvtraverse":
        # the journey persists nothing; the destination costs O(1) fences
        assert total["traverse_flushes"] == total["traverse_fences"] == 0
        fences = {(op, got): set() for op, got, _ in port}
        for op, got, c in port:
            fences[(op, got)].add(c["fences"])
        assert all(len(v) == 1 for v in fences.values()), fences
        assert max(c["fences"] for _, _, c in port) <= 4
    elif policy == "izraelevitz":
        # O(path) fences: a flush + fence after every shared access
        assert total["fences"] / n_ops > 3 * 4
    else:
        assert total["flushes"] == total["fences"] == 0


@pytest.mark.parametrize("structure,size", [("list", 64), ("hash", 128),
                                            ("bst", 128), ("skiplist", 128)])
def test_chip_smokes_workload_is_run_workloads(structure, size):
    """``chip_smoke.paper_workload`` (one prefill, copied for each policy)
    gives ``run_workload``'s counts (a fresh prefill for each), with the
    reference's structures and with the port's."""
    got = [{p: {f: v for f, v in r.items() if not f.endswith("_s")}
            for p, r in cs.paper_workload(structure, POLICIES, size, 60,
                                          core=cs.core_modules(pkg)).items()}
           for pkg in ("repro", "repro_torch")]
    assert got[0] == got[1]
    for policy in POLICIES:
        want = run_workload(structure, policy, size=size, update_pct=20,
                            n_ops=60)
        assert got[1][policy]["fences_per_op"] == want["fences_per_op"]
        assert got[1][policy]["flushes_per_op"] == want["flushes_per_op"]


def test_paper_phase_count_sweep_on_the_cpu():
    out = cs.paper_counts(cs.SMALL)
    assert len(out) == 5 * len(POLICIES)
    assert out["list256_nvtraverse"]["fences_per_op"] < 4
    assert out["list256_izraelevitz"]["fences_per_op"] > 0.8 * 256 * 0.9
