"""The port's ordered map (``repro_torch.core.ordered``) against the JAX
package's on the CPU: the same seeded batches through both engines and
both scan oracles give bit-identical state arrays, ok flags, accounting
and commit stats; towers, lookups, ranges, scans and top-k agree array
for array (padding included), also on a chain threaded by hand in no key
order; and DurableOrderedMap directories are byte-identical and recover
in either package."""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ordered as JO
from repro.persistence.index import OrderedMembershipIndex as JaxOrdIndex
from repro_torch.core import ordered as TO
from repro_torch.core.skiplist import tower_height, tower_heights
from repro_torch.persistence.index import OrderedMembershipIndex

OP_INSERT, OP_DELETE = 0, 1


def port(cap):
    return TO.make_ordered(cap, "cpu")


def assert_same(ref, got, ctx=""):
    """Field by field, dtype and shape included."""
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: field {f}")


def to_jax(tstate):
    return JO.OrderedState(**{f: jnp.asarray(v) for f, v in
                              TO.state_to_numpy(tstate).items()})


def random_batch(rng, n, key_hi=40, val_hi=1000):
    return (rng.integers(0, 2, n).astype(np.int32),
            rng.integers(0, key_hi, n).astype(np.int32),
            rng.integers(0, val_hi, n).astype(np.int32))


def run_both(jst, tst, ops, ks, vs, towers=True, ctx=""):
    """One batch through the JAX engine and scan and the port's engine and
    scan; everything must agree.  Returns the new states and ok flags."""
    jtw = JO.build_towers(jst) if towers else None
    ttw = TO.build_towers(tst) if towers else None
    jst2, jok, jstats = JO.update_parallel_ordered(jst, ops, ks, vs,
                                                   towers=jtw)
    tst2, tok, tstats = TO.update_parallel_ordered(tst, ops, ks, vs,
                                                   towers=ttw)
    jsc, jsok = JO.apply_ordered(jst, jnp.asarray(ops), jnp.asarray(ks),
                                 jnp.asarray(vs))
    tsc, tsok = TO.apply_ordered(tst, ops, ks, vs)
    assert_same(jst2, tst2, ctx + " engine")
    assert_same(jsc, tsc, ctx + " scan")
    assert_same(jst2, tsc, ctx + " engine = scan")
    for a in (tok, tsok):
        np.testing.assert_array_equal(np.asarray(jok), a.cpu().numpy())
    assert_same(jstats, tstats, ctx + " stats")
    return jst2, tst2, tok.cpu().numpy()


# --------------------------------------------------------------------- #
# the engine, bit for bit                                                #
# --------------------------------------------------------------------- #
def test_mixed_rounds_bit_identical_to_jax_and_oracles():
    rng = np.random.default_rng(11)
    for trial, cap in enumerate((64, 200)):
        jst, tst, model = JO.make_ordered(cap), port(cap), {}
        for rnd in range(6):
            ops, ks, vs = random_batch(rng, (13, 29, 1)[rnd % 3])
            jst, tst, ok = run_both(jst, tst, ops, ks, vs,
                                    towers=bool(rnd % 2),
                                    ctx=f"{trial}/{rnd}")
            ok_m = TO.oracle_apply(model, ops, ks, vs, capacity=cap)
            assert ok.tolist() == ok_m
            assert TO.items_host(tst) == model == JO.items_host(jst)
            TO.check_sorted(tst)


def test_duplicate_key_groups_compose_like_jax():
    rng = np.random.default_rng(23)
    jst, tst = JO.make_ordered(64), port(64)
    for rnd in range(6):
        ops, ks, vs = random_batch(rng, 24, key_hi=3)
        jst, tst, _ = run_both(jst, tst, ops, ks, vs, ctx=f"round {rnd}")


def test_capacity_failure_kills_whole_group_like_jax():
    cap = 6
    jst, tst = JO.make_ordered(cap), port(cap)
    ks0 = np.asarray([10, 20, 30, 40], np.int32)
    jst, tst, _ = run_both(jst, tst, np.zeros(4, np.int32), ks0, ks0)
    ops = np.asarray([OP_INSERT, OP_INSERT, OP_DELETE, OP_INSERT], np.int32)
    ks = np.asarray([50, 60, 50, 50], np.int32)
    vs = np.asarray([1, 2, 0, 3], np.int32)
    jst, tst, _ = run_both(jst, tst, ops, ks, vs, ctx="group kill")
    assert TO.live_items(tst) == {10: 10, 20: 20, 30: 30, 40: 40, 50: 3}
    TO.check_sorted(tst)


def test_conflict_stats_and_accounting_law_match_jax():
    jst, tst = JO.make_ordered(128), port(128)
    two = np.asarray([0, 100], np.int32)
    jst, tst, _ = run_both(jst, tst, np.zeros(2, np.int32), two, two)
    six = np.asarray([10, 20, 30, 40, 50, 60], np.int32)
    _, _, stats = TO.update_parallel_ordered(tst, np.zeros(6, np.int32),
                                             six, six)
    assert [int(x) for x in stats] == [6, 1, 6, 12, 12]
    jst, tst, _ = run_both(jst, tst, np.zeros(6, np.int32), six, six)
    spread = np.asarray([5, 15, 25, 35], np.int32)
    _, _, stats = TO.update_parallel_ordered(tst, np.zeros(4, np.int32),
                                             spread, spread)
    assert [int(x) for x in stats] == [4, 4, 1, 8, 2]
    # fresh 2 flushes, delete 1, resurrect 1; 2 fences each
    flushes = [int(tst.flushes)]
    for op in (OP_DELETE, OP_INSERT):
        ops = np.full(6, op, np.int32)
        jst, tst, _ = run_both(jst, tst, ops, six, six)
        flushes.append(int(tst.flushes))
    assert np.diff(flushes).tolist() == [6, 6]
    assert int(tst.fences) == 2 * (2 + 6 + 6 + 6)


def test_empty_batch_is_a_noop():
    tst = port(16)
    st2, ok, stats = TO.update_parallel_ordered(
        tst, np.zeros(0, np.int32), np.zeros(0, np.int32),
        np.zeros(0, np.int32))
    assert st2 is tst and ok.numel() == 0
    assert [int(x) for x in stats] == [0] * 5


@pytest.mark.parametrize("seed", range(6))
def test_property_streams_bit_identical(seed):
    rng = np.random.default_rng(1234 + seed)
    cap = (4, 19, 48)[seed % 3]      # few shapes: each costs a JAX compile
    jst, tst, model = JO.make_ordered(cap), port(cap), {}
    for b in range(int(rng.integers(1, 5))):
        n = (7, 23, 59)[int(rng.integers(0, 3))]
        ops = rng.integers(0, 2, n).astype(np.int32)
        ks = rng.integers(0, 26, n).astype(np.int32)
        vs = rng.integers(0, 100, n).astype(np.int32)
        jst, tst, ok = run_both(jst, tst, ops, ks, vs, ctx=f"batch {b}")
        assert ok.tolist() == TO.oracle_apply(model, ops, ks, vs,
                                              capacity=cap)
    lo = int(rng.integers(-2, 27))
    hi = int(rng.integers(lo, 29))
    total, rk, rv = TO.range_query(tst, lo, hi, 64)
    want = TO.oracle_range(model, lo, hi)
    assert int(total) == len(want)
    assert list(zip(rk[:len(want)].tolist(), rv[:len(want)].tolist())) \
        == want


# --------------------------------------------------------------------- #
# towers and reads                                                       #
# --------------------------------------------------------------------- #
def grown_pair(rng, cap=512, rounds=5, key_hi=200):
    jst, tst, model = JO.make_ordered(cap), port(cap), {}
    for _ in range(rounds):
        ops, ks, vs = random_batch(rng, 64, key_hi=key_hi)
        jst, _, _ = JO.update_parallel_ordered(jst, ops, ks, vs)
        tst, _, _ = TO.update_parallel_ordered(tst, ops, ks, vs)
        TO.oracle_apply(model, ops, ks, vs, capacity=cap)
    assert_same(jst, tst, "grown")
    return jst, tst, model


def assert_towers_same(jtw, ttw):
    for a, b in zip(jtw, ttw):
        b = b.cpu().numpy()
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("max_level", [1, 2, 8])
def test_build_towers_identical_to_jax(max_level):
    rng = np.random.default_rng(5)
    jst, tst, _ = grown_pair(rng)
    assert_towers_same(JO.build_towers(jst, max_level),
                       TO.build_towers(tst, max_level))
    assert_towers_same(JO.build_towers(JO.make_ordered(8), max_level),
                       TO.build_towers(port(8), max_level))


def test_tower_heights_match_jax_and_scalar():
    from repro.core.skiplist import tower_heights as jax_heights
    ks = np.concatenate([np.arange(-50, 200),
                         [TO.KEY_MIN, TO.KEY_PAD, 2**31 - 2]])
    np.testing.assert_array_equal(tower_heights(ks, 8), jax_heights(ks, 8))
    assert [tower_height(int(k), 8) for k in ks] == \
        tower_heights(ks, 8).tolist()


def test_lookup_with_and_without_towers_matches_jax():
    rng = np.random.default_rng(6)
    jst, tst, model = grown_pair(rng)
    q = rng.integers(-3, 220, 97).astype(np.int32)
    for use in (True, False):
        jtw = JO.build_towers(jst) if use else None
        ttw = TO.build_towers(tst) if use else None
        jf, jv = JO.lookup_ordered(jst, jnp.asarray(q), jtw)
        tf, tv = TO.lookup_ordered(tst, q, ttw)
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def assert_read_same(jout, tout, ctx):
    for a, b in zip(jout, tout):
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, ctx
        np.testing.assert_array_equal(a, b, err_msg=ctx)


def test_range_query_zipf_and_truncated_match_jax():
    rng = np.random.default_rng(42)
    jst, tst, model = JO.make_ordered(1024), port(1024), {}
    for _ in range(5):
        n = 96
        ks = (rng.zipf(1.3, n) % 500).astype(np.int32)
        ops = rng.integers(0, 2, n).astype(np.int32)
        vs = rng.integers(0, 10_000, n).astype(np.int32)
        jst, _, _ = JO.update_parallel_ordered(jst, ops, ks, vs)
        tst, _, _ = TO.update_parallel_ordered(tst, ops, ks, vs)
        TO.oracle_apply(model, ops, ks, vs, capacity=1024)
    jtw, ttw = JO.build_towers(jst), TO.build_towers(tst)
    bounds = [(0, 499), (10, 20), (100, 300), (450, 600), (7, 7),
              (300, 100), (TO.KEY_MIN + 1, TO.KEY_PAD - 1)]
    for lo, hi in bounds:
        for towers in ((jtw, ttw), (None, None)):
            for m in (600, 5, 1):        # 5 and 1 truncate the wide spans
                ctx = f"[{lo}, {hi}] max_items {m}"
                assert_read_same(
                    JO.range_query(jst, lo, hi, m, towers[0]),
                    TO.range_query(tst, lo, hi, m, towers[1]), ctx)
        want = TO.oracle_range(model, lo, hi)
        total, rk, rv = TO.range_query(tst, lo, hi, 600, ttw)
        assert int(total) == len(want)
        assert list(zip(rk[:len(want)].tolist(),
                        rv[:len(want)].tolist())) == want
    # a batch of bounds answers each query as a call of its own would
    lo = np.asarray([b[0] for b in bounds], np.int32)
    hi = np.asarray([b[1] for b in bounds], np.int32)
    total, rk, rv = TO.range_query(tst, lo, hi, 5, ttw)
    assert total.shape == (len(bounds),) and rk.shape == (len(bounds), 5)
    for i, (a, b) in enumerate(bounds):
        assert_read_same(TO.range_query(tst, a, b, 5, ttw),
                         (total[i], rk[i], rv[i]), f"batch row {i}")


def test_scan_and_top_k_match_jax():
    rng = np.random.default_rng(9)
    jst, tst, model = grown_pair(rng)
    n_live = len(TO.live_items(tst))
    for m in (512, 7):
        assert_read_same(JO.scan(jst, m), TO.scan(tst, m), f"scan {m}")
        assert_read_same(JO.scan(jst, m, JO.build_towers(jst)),
                         TO.scan(tst, m, TO.build_towers(tst)), f"scan {m}")
    for k in (1, 3, 17, n_live, n_live + 10):     # the last: fewer live
        assert_read_same(JO.top_k(jst, k), TO.top_k(tst, k), f"top_k {k}")
    empty = port(16)
    assert_read_same(JO.top_k(JO.make_ordered(16), 4), TO.top_k(empty, 4),
                     "top_k of an empty map")
    assert_read_same(JO.scan(JO.make_ordered(16), 4), TO.scan(empty, 4),
                     "scan of an empty map")


def hand_threaded(seed, cap=40):
    """A chain threaded by hand through a random permutation of nodes,
    keys in no order (repeats included), some nodes dead, some nodes off
    the chain."""
    rng = np.random.default_rng(seed)
    n = cap - 8
    key = np.zeros(cap, np.int32)
    key[0] = TO.KEY_MIN
    key[1:] = rng.integers(-20, 60, cap - 1)
    val = rng.integers(0, 1000, cap).astype(np.int32)
    live = rng.random(cap) < 0.7
    live[0] = False
    nxt = np.full(cap, -1, np.int32)
    chain = rng.permutation(np.arange(1, cap))[:n]
    prev = 0
    for node in chain:
        nxt[prev] = node
        prev = node
    return {"key": key, "val": val, "nxt": nxt, "live": live,
            "cursor": np.int32(cap), "flushes": np.int32(3),
            "fences": np.int32(4)}


def literal_walk(a, start, stop):
    """The reference's node-by-node walk: live (key, val) from ``start``
    until ``stop(key)`` or the chain's end."""
    out, node = [], int(start)
    while node != -1 and not stop(int(a["key"][node])):
        if a["live"][node]:
            out.append((int(a["key"][node]), int(a["val"][node])))
        node = int(a["nxt"][node])
    return out


@pytest.mark.parametrize("seed", range(4))
def test_reads_on_a_hand_threaded_unsorted_chain(seed):
    a = hand_threaded(seed)
    tst = TO.state_from_numpy(a, "cpu")
    jst = to_jax(tst)
    all_live = literal_walk(a, a["nxt"][0], lambda k: False)
    for k in (1, 4, len(all_live), len(all_live) + 3):
        cnt, tk, tv = TO.top_k(tst, k)
        want = all_live[-k:]
        assert int(cnt) == len(want)
        assert list(zip(tk[:len(want)].tolist(),
                        tv[:len(want)].tolist())) == want
        assert_read_same(JO.top_k(jst, k), (cnt, tk, tv), f"top_k {k}")
    for lo, hi in [(-30, 70), (0, 20), (10, 10), (40, -5)]:
        for towers in (False, True):
            jtw = JO.build_towers(jst) if towers else None
            ttw = TO.build_towers(tst) if towers else None
            got = TO.range_query(tst, lo, hi, 6, ttw)
            assert_read_same(JO.range_query(jst, lo, hi, 6, jtw), got,
                             f"range [{lo}, {hi}] towers {towers}")
            if not towers:      # from the head, the literal walk
                node = 0
                while a["nxt"][node] != -1 and \
                        a["key"][a["nxt"][node]] < lo:
                    node = a["nxt"][node]
                want = literal_walk(a, a["nxt"][node], lambda k: k > hi)
                assert int(got[0]) == len(want)
                n = min(len(want), 6)
                assert list(zip(got[1][:n].tolist(),
                                got[2][:n].tolist())) == want[:n]
    q = np.arange(-25, 65, dtype=np.int32)
    jf, jv = JO.lookup_ordered(jst, jnp.asarray(q), JO.build_towers(jst))
    tf, tv = TO.lookup_ordered(tst, q, TO.build_towers(tst))
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("seed", range(3))
def test_oracle_and_engine_on_a_hand_threaded_chain_match_jax(seed):
    """The scan oracle walks from the head on a chain in no key order
    (the port finds each walk's end by bisection, so this is its hard
    case); both packages' scans and engines must agree."""
    a = hand_threaded(seed, cap=48)
    a["cursor"] = np.int32(40)          # room for fresh nodes
    a["nxt"][40:] = -1
    for node in range(40, 48):          # take the free nodes off the chain
        a["nxt"][a["nxt"] == node] = -1
    tst = TO.state_from_numpy(a, "cpu")
    jst = to_jax(tst)
    rng = np.random.default_rng(100 + seed)
    for b in range(3):
        ops, ks, vs = random_batch(rng, 16, key_hi=70)
        jsc, jok = JO.apply_ordered(jst, jnp.asarray(ops), jnp.asarray(ks),
                                    jnp.asarray(vs))
        tsc, tok = TO.apply_ordered(tst, ops, ks, vs)
        assert_same(jsc, tsc, f"scan {b}")
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
        jen, jok2, js = JO.update_parallel_ordered(jst, ops, ks, vs)
        ten, tok2, ts = TO.update_parallel_ordered(tst, ops, ks, vs)
        assert_same(jen, ten, f"engine {b}")
        assert_same(js, ts, f"stats {b}")
        np.testing.assert_array_equal(np.asarray(jok2), tok2.numpy())
        jst, tst = jsc, tsc


def test_host_helpers_match_jax():
    rng = np.random.default_rng(3)
    jst, tst, model = grown_pair(rng, cap=128, rounds=3, key_hi=60)
    assert TO.items_host(tst) == JO.items_host(jst) == model
    assert TO.live_items(tst) == JO.live_items(jst)
    TO.check_sorted(tst)
    bad = TO.state_to_numpy(tst)
    chain = TO._chain(tst)
    bad["key"][chain[1]], bad["key"][chain[2]] = \
        bad["key"][chain[2]], bad["key"][chain[1]]
    with pytest.raises(AssertionError, match="not strictly sorted"):
        TO.check_sorted(TO.state_from_numpy(bad, "cpu"))
    bad["nxt"][chain[-1]] = chain[0]
    with pytest.raises(AssertionError, match="cycle"):
        TO.items_host(TO.state_from_numpy(bad, "cpu"))


# --------------------------------------------------------------------- #
# the durable map                                                        #
# --------------------------------------------------------------------- #
def history(m, seed=3, n_batches=7, snap_at=3):
    rng = np.random.default_rng(seed)
    for b in range(n_batches):
        ops, ks, vs = random_batch(rng, int(rng.integers(1, 20)))
        m.update(ops, ks, vs)
        if b == snap_at:
            m.snapshot()


def dir_bytes(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())
            if p.is_file()}


def test_durable_map_dirs_byte_identical_and_cross_recoverable(tmp_path):
    jm = JO.DurableOrderedMap(tmp_path / "jax", capacity=128)
    tm = TO.DurableOrderedMap(tmp_path / "port", capacity=128,
                              device="cpu")
    history(jm)
    history(tm)
    assert_same(jm.state, tm.state, "live")
    jb, tb = dir_bytes(tmp_path / "jax"), dir_bytes(tmp_path / "port")
    assert sorted(tb) == sorted(jb)
    assert any(n.startswith("osnap_") for n in tb)
    for name in jb:
        assert jb[name] == tb[name], name
    # each package recovers the other's directory, bit for bit
    t_from_j = TO.DurableOrderedMap(tmp_path / "jax", capacity=128,
                                    device="cpu")
    j_from_t = JO.DurableOrderedMap(tmp_path / "port", capacity=128)
    assert_same(jm.state, t_from_j.state, "port recovers jax")
    assert_same(j_from_t.state, tm.state, "jax recovers port")
    assert_towers_same(jm.towers, t_from_j.towers)
    assert t_from_j._n == jm._n == j_from_t._n
    total, rk, rv = t_from_j.range(0, 39, 64)
    jt, jk, jv = jm.range(0, 39, 64)
    assert total == jt and rk.tolist() == jk.tolist() and \
        rv.tolist() == jv.tolist()
    f, v = t_from_j.lookup(np.arange(40))
    jf, jv = jm.lookup(np.arange(40))
    assert f.tolist() == jf.tolist() and v.tolist() == jv.tolist()


def test_torn_round_never_acked_and_prefix_replayed(tmp_path):
    rng = np.random.default_rng(8)
    m = TO.DurableOrderedMap(tmp_path, capacity=64, device="cpu")
    for _ in range(3):
        m.update(*random_batch(rng, 8))
    acked = m.items()
    m.io.write("ord.tmp", b'{"ops": [0], "ks": [5]')
    m.io.crash(evict="all")
    m2 = TO.DurableOrderedMap(tmp_path, capacity=64, device="cpu")
    assert m2.items() == acked and m2._n == 3
    TO.check_sorted(m2.state)
    j2 = JO.DurableOrderedMap(tmp_path, capacity=64)
    assert_same(j2.state, m2.state, "torn round")
    (tmp_path / f"osnap_{99:08d}.json").write_text('{"horizon": 9')
    assert TO.DurableOrderedMap(tmp_path, capacity=64,
                                device="cpu").items() == acked


def test_snapshot_payload_is_the_reference_json(tmp_path):
    m = TO.DurableOrderedMap(tmp_path, capacity=16, device="cpu")
    assert m.snapshot() is None
    m.insert([5, 3], [50, 30])
    name = m.snapshot()
    data = json.loads((tmp_path / name).read_text())
    assert list(data) == ["horizon", "key", "val", "nxt", "live", "cursor",
                          "flushes", "fences"]
    assert data["live"][:3] == [0, 1, 1] and data["cursor"] == 3


# --------------------------------------------------------------------- #
# the ordered membership index                                           #
# --------------------------------------------------------------------- #
def test_ordered_membership_index_matches_jax():
    j, t = JaxOrdIndex(capacity=8), OrderedMembershipIndex(8, device="cpu")
    steps = [(range(0, 40, 2), ()), ((), [0, 2, 4]),
             ([4, 41, 2**33, -7], [6, 2**33]), (range(40, 60), [41, 99])]
    for adds, rems in steps:
        j.update(adds, rems)
        t.update(adds, rems)
        assert t.members == j.members
        assert t.migrations == j.migrations
        assert_same(j.state, t.state, "index state")
        for r in (0, 1, 5, 100):
            assert t.expired(r) == j.expired(r)
        assert t.range_members(10, 20, 50) == j.range_members(10, 20, 50)
        q = list(range(-8, 64)) + [2**33]
        np.testing.assert_array_equal(t.contains(q), j.contains(q))
    assert t.expired(5) == sorted(t.members - {-7})[:-5]
    assert t.migrations >= 1
    t.add([7])
    t.remove([7])
    assert not t.contains([7])[0]
