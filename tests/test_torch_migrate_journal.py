"""The port's journaled migration (``MigratingMap``/``RoundJournal``)
against the JAX package's on the CPU: the same history writes
byte-identical journals and gives identical ok flags and tables; a journal
written by either package recovers in the other; and a crash at every
migration frontier recovers bit-identically to the round boundary."""
import io

import numpy as np
import pytest

from repro.core import migrate as JM
from repro_torch.core import batched as TB
from repro_torch.core import migrate as TM
from repro_torch.obs.metrics import get_registry


def assert_same(ref, port, ctx=""):
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(port, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: field {f}")


def port_map(**kw):
    return TM.MigratingMap(device="cpu", **kw)


def dir_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def drive(m, seed=2, n_rounds=14):
    """A seeded mixed history that grows the map once and, with the
    defaults below, finishes the migration under live traffic.  Returns
    the per-round ok flags."""
    rng = np.random.default_rng(seed)
    oks = []
    for _ in range(n_rounds):
        n = int(rng.integers(8, 40))
        ops = rng.integers(0, 2, size=n).astype(np.int32)
        ks = rng.integers(0, 120, size=n).astype(np.int32)
        vs = rng.integers(0, 1000, size=n).astype(np.int32)
        oks.append(m.update(ops, ks, vs).tolist())
    return oks


def test_migration_state_header_bytes_match_jax():
    h = dict(phase="migrating", frontier=3, old=(128, 8), new=(512, 16),
             buckets_per_round=2, n_rounds=5)
    assert TM.MigrationState(**h).to_bytes() == \
        JM.MigrationState(**h).to_bytes()
    assert TM.MigrationState.from_bytes(
        JM.MigrationState(**h).to_bytes()) == TM.MigrationState(**h)


def test_journals_byte_identical_and_ok_flags_match(tmp_path):
    kw = dict(capacity=32, n_buckets=8, buckets_per_round=2)
    jm = JM.MigratingMap(root=tmp_path / "jax", **kw)
    tm = port_map(root=tmp_path / "port", **kw)
    assert drive(jm) == drive(tm)
    assert tm.migrations_completed == jm.migrations_completed >= 1
    assert (tm.rounds_total, tm.migrated_total, tm.pulls_total) == \
        (jm.rounds_total, jm.migrated_total, jm.pulls_total)
    assert tm.migrating == jm.migrating
    assert_same(jm.state, tm.state, "adopted table")
    assert tm.items() == jm.items()
    assert (tm.flushes, tm.fences) == (jm.flushes, jm.fences)
    jb, tb = dir_bytes(tmp_path / "jax"), dir_bytes(tmp_path / "port")
    assert sorted(tb) == sorted(jb)
    assert any(n.endswith("old.npz") for n in tb)
    assert sum(n.split("/")[-1].startswith("round_") for n in tb) > 3
    for name in jb:
        assert jb[name] == tb[name], name
    snap = np.load(io.BytesIO(tb[next(n for n in tb
                                      if n.endswith("old.npz"))]))
    assert snap.files == list(TB.HashMapState._fields)
    assert snap["cursor"].shape == () and snap["cursor"].dtype == np.int32


def midway(m):
    """Seed a map, open a migration, drain two rounds and commit user
    traffic between them; returns the map, still migrating."""
    ks = np.arange(1, 41, dtype=np.int32)
    m.insert(ks, ks * 5)
    m.delete(ks[::4])
    m.start_migration()
    m.migrate_round()
    m.delete(np.array([1, 2, 3], np.int32))
    m.insert(np.array([100, 2, 5], np.int32), np.array([7, 8, 9], np.int32))
    m.migrate_round()
    return m


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_journal_recovers_in_the_other_package(tmp_path, writer):
    kw = dict(capacity=128, n_buckets=8, buckets_per_round=1)
    jm = midway(JM.MigratingMap(root=tmp_path / "jax", **kw))
    tm = midway(port_map(root=tmp_path / "port", **kw))
    assert_same(jm._mig["new"], tm._mig["new"], "live new table")
    frontier, n_rounds = tm.frontier, tm._mig["n_rounds"]
    assert (frontier, n_rounds) == (4, 6)   # updates drain a round too
    jm.crash()
    tm.crash()
    root = tmp_path / writer
    jr = JM.MigratingMap.recover(root)
    tr = TM.MigratingMap.recover(root, device="cpu")
    assert tr.migrating and tr.frontier == jr.frontier == frontier
    assert tr._mig["remaining_live"] == jr._mig["remaining_live"]
    assert tr._mig["n_rounds"] == jr._mig["n_rounds"] == n_rounds
    assert_same(jr._mig["new"], tr._mig["new"], "recovered new table")
    assert_same(jr.state, tr.state, "recovered old table")
    f = np.arange(0, 110, dtype=np.int32)
    for a, b in zip(jr.lookup(f), tr.lookup(f)):
        np.testing.assert_array_equal(a, b)
    jr.run_migration()
    tr.run_migration()
    assert_same(jr.state, tr.state, "finished")
    assert tr.items() == jr.items()


def test_a_done_journal_recovers_the_grown_table(tmp_path):
    kw = dict(capacity=32, n_buckets=8, buckets_per_round=4)
    tm = port_map(root=tmp_path, **kw)
    tm.insert(np.arange(1, 25, dtype=np.int32),
              np.arange(1, 25, dtype=np.int32))
    tm.start_migration()
    tm.run_migration()
    tm.crash()
    tr = TM.MigratingMap.recover(tmp_path, device="cpu")
    jr = JM.MigratingMap.recover(tmp_path)
    assert not tr.migrating and tr.migrations_completed == 1
    assert (tr.capacity, tr.n_buckets) == (jr.capacity, jr.n_buckets)
    assert_same(jr.state, tr.state, "done")
    empty = TM.MigratingMap.recover(tmp_path / "none", device="cpu")
    assert empty.items() == {} and not empty.migrating


# --------------------------------------------------------------------- #
# crash replay at every frontier (the reference's cases, in the port)    #
# --------------------------------------------------------------------- #
def seeded(root, lib, **kw):
    m = lib.MigratingMap(capacity=128, n_buckets=8, root=root,
                         buckets_per_round=1, **kw)
    ks = np.arange(1, 41, dtype=np.int32)
    m.insert(ks, ks * 5)
    m.delete(ks[::4])
    m.start_migration()
    return m


@pytest.fixture(scope="module")
def boundaries(tmp_path_factory):
    """(frontier, new table) before every drain round, then the final
    table, from an uncrashed port run -- checked against JAX's."""
    d = tmp_path_factory.mktemp("bounds")
    tm = seeded(d / "port", TM, device="cpu")
    jm = seeded(d / "jax", JM)
    out = []
    while tm.migrating:
        assert_same(jm._mig["new"], tm._mig["new"], f"round {len(out)}")
        out.append((tm.frontier, tm._mig["new"]))
        tm.migrate_round()
        jm.migrate_round()
    assert_same(jm.state, tm.state, "final")
    out.append((8, tm.state))
    return out


@pytest.mark.parametrize("crash_round", list(range(9)))
def test_crash_replay_every_frontier(tmp_path, boundaries, crash_round):
    m = seeded(tmp_path, TM, device="cpu")
    for _ in range(crash_round):
        if m.migrating:
            m.migrate_round()
    m.crash()
    rec = TM.MigratingMap.recover(tmp_path, device="cpu")
    if crash_round < len(boundaries) - 1:
        assert rec.migrating and rec.frontier == boundaries[crash_round][0]
        assert_same(rec._mig["new"], boundaries[crash_round][1],
                    f"recovered new table, round {crash_round}")
        rec.run_migration()
    else:
        assert not rec.migrating
    assert_same(rec.state, boundaries[-1][1], f"final via {crash_round}")


def test_unfenced_round_is_lost_fenced_round_survives(tmp_path):
    m = port_map(capacity=128, n_buckets=8, root=tmp_path,
                 buckets_per_round=1)
    m.insert(np.arange(1, 31, dtype=np.int32),
             np.arange(1, 31, dtype=np.int32))
    m.start_migration()
    m.migrate_round()
    pre = m._mig["new"]
    m.io.write("mig_0001/round.tmp", b"torn")
    m.crash()
    rec = TM.MigratingMap.recover(tmp_path, device="cpu")
    assert rec.frontier == 1
    assert_same(pre, rec._mig["new"], "unfenced round leaked")


def test_growth_is_invisible_to_op_results_and_counted():
    reg = get_registry()
    names = ("map_migration_rounds_total", "map_migrated_keys_total",
             "map_migrations_total", "map_pulls_total")
    before = [reg.counter(n).value for n in names]
    rng = np.random.default_rng(2)
    m = port_map(capacity=32, n_buckets=8)
    big = TB.make_state(1 << 12, 8, "cpu")
    for rnd in range(20):
        n = int(rng.integers(8, 48))
        ops = rng.integers(0, 2, size=n).astype(np.int32)
        ks = rng.integers(0, 300, size=n).astype(np.int32)
        vs = rng.integers(0, 1000, size=n).astype(np.int32)
        ok = m.update(ops, ks, vs)
        big, ok_big, _ = TB.update_parallel(big, ops, ks, vs, 8)
        np.testing.assert_array_equal(ok, ok_big.numpy(),
                                      err_msg=f"round {rnd}")
    assert m.migrations_completed >= 1
    live_big = {k: v for k, (l, v) in
                TM.items_of_host(TM.host_state(big)).items() if l}
    assert {k: v for k, (l, v) in m.items().items() if l} == live_big
    after = [reg.counter(n).value for n in names]
    assert after[0] - before[0] == m.rounds_total > 0
    assert after[1] - before[1] == m.migrated_total
    assert after[2] - before[2] == m.migrations_completed
    assert after[3] - before[3] == m.pulls_total


def test_lookup_during_migration_is_new_then_old():
    m = port_map(capacity=64, n_buckets=8, buckets_per_round=1)
    m.insert(np.arange(1, 21, dtype=np.int32),
             np.arange(1, 21, dtype=np.int32) * 10)
    m.start_migration()
    m.migrate_round()
    m.delete(np.array([5, 6], np.int32))
    f, v = m.lookup(np.arange(0, 23, dtype=np.int32))
    want = {k: k * 10 for k in range(1, 21) if k not in (5, 6)}
    assert f.tolist() == [k in want for k in range(0, 23)]
    assert v.tolist() == [want.get(k, 0) for k in range(0, 23)]


def test_live_chain_nodes_equals_the_literal_walk():
    """The vectorized drain order against a node-by-node walk of every
    chain (bucket ascending, head to tail, live only), on a map whose
    chains interleave dead and live nodes."""
    rng = np.random.default_rng(7)
    st = TB.make_state(256, 16, "cpu")
    for _ in range(5):
        ops = rng.integers(0, 2, size=64)
        ks = rng.integers(0, 150, size=64)
        st, _, _ = TB.update_parallel(st, ops, ks, ks * 3, 16)
    old = TM.host_state(st)
    for lo, hi in [(0, 16), (3, 9), (5, 5), (15, 16)]:
        want = []
        for b in range(lo, hi):
            node = int(old["head"][b])
            while node != -1:
                if old["live"][node]:
                    want.append(node)
                node = int(old["nxt"][node])
        assert TM.live_chain_nodes(old, lo, hi).tolist() == want
        ks, vs = TM.drain_range(old, lo, hi)
        assert ks.dtype == vs.dtype == np.int32
        assert ks.tolist() == [int(old["key"][n]) for n in want]
