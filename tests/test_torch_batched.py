"""The PyTorch durable map (repro_torch.core.batched) against the JAX
reference (repro.core.batched), on the CPU.

Inputs are made with numpy from seeds and handed to both packages; every
comparison is exact (tolerance 0): state arrays with their dtypes, per-op
ok flags, every CommitStats field, lookup/probe/chain_stats results.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as JB
from repro_torch.core import batched as TB

CPU = "cpu"
NB = 16   # few buckets: heavy same-bucket conflict groups


def assert_same(ref, port, ctx=""):
    """Field-by-field identity of two NamedTuples (states or stats)."""
    assert ref._fields == port._fields
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(port, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: field {f}")


def assert_arrays(ref, port, ctx=""):
    for i, (a, b) in enumerate(zip(ref, port)):
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.dtype == b.dtype, (ctx, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: output {i}")


def both_states(capacity, n_buckets):
    return JB.make_state(capacity, n_buckets), TB.make_state(
        capacity, n_buckets, CPU)


def update_both(js, ts, ops, ks, vs, nb, ctx="", **kw):
    """One update_parallel round on both sides; asserts identity."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    js, jok, jstats = JB.update_parallel(js, jnp.asarray(ops),
                                         jnp.asarray(ks), jnp.asarray(vs),
                                         nb, **jkw)
    ts, tok, tstats = TB.update_parallel(ts, ops, ks, vs, nb, **kw)
    assert_same(js, ts, ctx)
    assert_arrays([jok], [tok], ctx)
    assert_same(jstats, tstats, ctx + " stats")
    return js, ts


HASH_KEYS = np.concatenate([
    np.array([0, -1, 2**31 - 1, -2**31, 1, -2], np.int32),
    np.random.default_rng(0).integers(-2**31, 2**31, size=100_000,
                                      dtype=np.int64).astype(np.int32)])


@pytest.mark.parametrize("n_buckets", [1024, 3000, 1 << 20, 7])
def test_bucket_of_matches_jax(n_buckets):
    ref = np.asarray(JB.bucket_of(jnp.asarray(HASH_KEYS), n_buckets))
    port = TB.bucket_of(torch.as_tensor(HASH_KEYS), n_buckets)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(ref, port.numpy())
    np.testing.assert_array_equal(ref, TB.bucket_of_np(HASH_KEYS,
                                                       n_buckets))
    mix = np.asarray(JB._mix(jnp.asarray(HASH_KEYS))).astype(np.int64)
    np.testing.assert_array_equal(mix, TB._mix(torch.as_tensor(HASH_KEYS))
                                  .numpy())


@pytest.mark.parametrize("seed", [3, 11, 17])
def test_update_parallel_and_apply_match_jax(seed):
    """Dup-heavy mixed rounds (alternating ops on a tiny key range, key 0
    included): the plan/commit engine and the sequential oracle of the
    port both equal JAX's, round after round."""
    rng = np.random.default_rng(seed)
    jp, tp = both_states(4096, NB)
    jo, to = jp, tp
    for rnd in range(6):
        ks = rng.integers(0, 25, size=64)
        vs = rng.integers(0, 1000, size=64)
        ops = rng.integers(0, 2, size=64)
        jp, tp = update_both(jp, tp, ops, ks, vs, NB, f"round {rnd}")
        jo, jok = JB.apply(jo, jnp.asarray(ops), jnp.asarray(ks),
                           jnp.asarray(vs), NB)
        to, tok = TB.apply(to, ops, ks, vs, NB)
        assert_same(jo, to, f"apply round {rnd}")
        assert_arrays([jok], [tok], f"apply round {rnd}")
    assert_same(jo, tp, "oracle == engine")


def test_insert_delete_oracles_and_wrappers_match_jax():
    """The homogeneous scan oracles and the parallel wrappers, interleaved
    with resurrects (the test_commit_engine pattern)."""
    rng = np.random.default_rng(7)
    jo, to = both_states(4096, NB)
    jp, tp = jo, to
    for rnd in range(8):
        ks = rng.integers(0, 60, size=32)
        if rnd % 2 == 0:
            vs = rng.integers(0, 1000, size=32)
            jo, jok = JB.insert(jo, jnp.asarray(ks), jnp.asarray(vs), NB)
            to, tok = TB.insert(to, ks, vs, NB)
            jp, jpok, jst = JB.insert_parallel(jp, jnp.asarray(ks),
                                               jnp.asarray(vs), NB)
            tp, tpok, tst = TB.insert_parallel(tp, ks, vs, NB)
        else:
            jo, jok = JB.delete(jo, jnp.asarray(ks), NB)
            to, tok = TB.delete(to, ks, NB)
            jp, jpok, jst = JB.delete_parallel(jp, jnp.asarray(ks), NB)
            tp, tpok, tst = TB.delete_parallel(tp, ks, NB)
        assert_same(jo, to, f"oracle round {rnd}")
        assert_same(jp, tp, f"parallel round {rnd}")
        assert_arrays([jok, jpok], [tok, tpok], f"round {rnd}")
        assert_same(jst, tst, f"stats round {rnd}")


def test_insert_overflow_dangles_the_head_like_jax():
    """The oracle insert past a full pool drops its node writes but still
    publishes the id as the bucket head; later walks read the clamped
    last slot.  The port reproduces the corrupt state and every read of
    it."""
    ks = np.arange(1, 9)
    js, jok = JB.insert(JB.make_state(4, 2), jnp.asarray(ks),
                        jnp.asarray(ks * 5), 2)
    ts, tok = TB.insert(TB.make_state(4, 2, CPU), ks, ks * 5, 2)
    assert_same(js, ts, "overflow")
    assert_arrays([jok], [tok], "overflow")
    assert int(ts.head.max()) >= 4            # a head past the pool
    q = np.arange(-1, 12)
    assert_arrays(JB.lookup(js, jnp.asarray(q), 2), TB.lookup(ts, q, 2),
                  "lookup")
    assert_arrays(JB.probe(js, jnp.asarray(q), 2), TB.probe(ts, q, 2),
                  "probe")
    # further oracle ops on the dangling state stay identical
    ops = np.array([1, 0, 1, 0, 1, 0])
    ks2 = np.array([3, 3, 8, 8, 2, 9])
    js2, jok2 = JB.apply(js, jnp.asarray(ops), jnp.asarray(ks2),
                         jnp.asarray(ks2), 2)
    ts2, tok2 = TB.apply(ts, ops, ks2, ks2, 2)
    assert_same(js2, ts2, "apply on dangling")
    assert_arrays([jok2], [tok2], "apply on dangling")
    js3, jok3 = JB.insert(js, jnp.asarray(ks2), jnp.asarray(ks2), 2)
    ts3, tok3 = TB.insert(ts, ks2, ks2, 2)
    assert_same(js3, ts3, "insert on dangling")
    assert_arrays([jok3], [tok3], "insert on dangling")


@pytest.mark.parametrize("trial", range(3))
def test_valid_mask_matches_jax(trial):
    """Padding masks (random, a mid-group pad, all-invalid) compose the
    same way on both sides."""
    rng = np.random.default_rng(9 + trial)
    ops = rng.integers(0, 2, size=64)
    ks = rng.integers(0, 20, size=64)
    vs = rng.integers(0, 1000, size=64)
    js, ts = both_states(512, NB)
    js, ts = update_both(js, ts, np.zeros(8, np.int64), np.arange(1, 9),
                         np.arange(1, 9), NB, "seed")
    js, ts = update_both(js, ts, ops, ks, vs, NB, "random mask",
                         valid=rng.random(64) < 0.6)
    # a pad shaped like an insert between a real delete and insert
    js, ts = update_both(js, ts, np.array([1, 0, 0]), np.full(3, 5),
                         np.array([0, 999, 51]), NB, "mid-group pad",
                         valid=np.array([True, False, True]))
    update_both(js, ts, ops, ks, vs, NB, "all invalid",
                valid=np.zeros(64, np.bool_))
    # the masked path with nothing masked equals the unmasked path
    a = TB.update_parallel(ts, ops, ks, vs, NB)
    b = TB.update_parallel(ts, ops, ks, vs, NB, valid=np.ones(64, np.bool_))
    for x, y in zip((a[1], *a[0], *a[2]), (b[1], *b[0], *b[2])):
        assert torch.equal(x, y)


def test_capacity_exhaustion_kills_group_like_jax():
    I, D = TB.OP_INSERT, TB.OP_DELETE
    ops = np.array([I, D, I] * 4)
    ks = np.array([5] * 3 + [6] * 3 + [7] * 3 + [8] * 3)
    vs = np.arange(12)
    js, ts = both_states(4, 2)
    js2, ts2 = update_both(js, ts, ops, ks, vs, 2, "exhausted")
    assert int(ts2.cursor) == 4
    jo, jok = JB.apply(js, jnp.asarray(ops), jnp.asarray(ks),
                       jnp.asarray(vs), 2)
    to, tok = TB.apply(ts, ops, ks, vs, 2)
    assert_same(jo, to, "apply exhausted")
    assert_arrays([jok], [tok], "apply exhausted")
    # pool exhaustion through the insert wrapper, then a resurrect
    js, ts = both_states(4, 2)
    js, ts = update_both(js, ts, np.zeros(6, np.int64), np.arange(1, 7),
                         np.arange(1, 7), 2, "full")
    js, ts = update_both(js, ts, np.array([D, I, I]), np.array([2, 2, 9]),
                         np.array([0, 42, 1]), 2, "resurrect at full")


@pytest.mark.parametrize("nb_global,base,nb", [(64, 16, 16), (64, 0, 8),
                                                (48, 40, 8)])
def test_bucket_ranges_match_jax(nb_global, base, nb):
    """``(nb_global, base)`` range states: updates, lookups and probes of
    keys inside and outside the owned range."""
    rng = np.random.default_rng(nb_global + base)
    js, ts = both_states(512, nb)
    for rnd in range(3):
        ops = rng.integers(0, 2, size=64)
        ks = rng.integers(0, 200, size=64)
        vs = rng.integers(0, 1000, size=64)
        js, ts = update_both(js, ts, ops, ks, vs, nb, f"range {rnd}",
                             nb_global=nb_global, base=base)
    q = np.arange(-2, 210)
    assert_arrays(JB.lookup(js, jnp.asarray(q), nb, nb_global, base),
                  TB.lookup(ts, q, nb, nb_global, base), "lookup")
    assert_arrays(JB.probe(js, jnp.asarray(q), nb, nb_global, base),
                  TB.probe(ts, q, nb, nb_global, base), "probe")


def test_key_zero_nil_and_reads_match_jax():
    """Key 0 round-trips, no link aliases slot 0, and lookup / probe /
    chain_stats of a map with deleted and resurrected keys agree."""
    js, ts = both_states(64, 2)
    js, ts = update_both(js, ts, np.zeros(4, np.int64),
                         np.array([0, 5, 0, 13]), np.array([10, 50, 11, 130]),
                         2, "key 0")
    js, ts = update_both(js, ts, np.array([1, 0, 1]), np.array([0, 0, 5]),
                         np.array([0, 77, 0]), 2, "delete/resurrect 0")
    assert (ts.nxt[1:int(ts.cursor)] != 0).all() and (ts.head != 0).all()
    rng = np.random.default_rng(13)
    js, ts = both_states(512, NB)
    for _ in range(4):
        js, ts = update_both(js, ts, rng.integers(0, 2, size=40),
                             rng.integers(0, 30, size=40),
                             rng.integers(0, 1000, size=40), NB, "mixed")
    q = np.arange(-3, 40)
    assert_arrays(JB.lookup(js, jnp.asarray(q), NB), TB.lookup(ts, q, NB),
                  "lookup")
    assert_arrays(JB.probe(js, jnp.asarray(q), NB), TB.probe(ts, q, NB),
                  "probe")
    assert_arrays(JB.chain_stats(js, NB), TB.chain_stats(ts, NB),
                  "chain_stats")


def test_empty_batch_is_a_noop_like_jax():
    js, ts = both_states(64, NB)
    e = np.zeros(0, np.int64)
    update_both(js, ts, e, e, e, NB, "empty")


def test_state_numpy_round_trip():
    """A JAX-built map carried into the port and back is unchanged, and
    the port keeps engine-identical behaviour on it."""
    rng = np.random.default_rng(5)
    js = JB.make_state(256, NB)
    js, _, _ = JB.update_parallel(js, jnp.asarray(rng.integers(0, 2, 64)),
                                  jnp.asarray(rng.integers(0, 40, 64)),
                                  jnp.asarray(rng.integers(0, 99, 64)), NB)
    arrays = {f: np.asarray(getattr(js, f)) for f in JB.HashMapState._fields}
    ts = TB.state_from_numpy(arrays, CPU)
    assert_same(js, ts, "carried")
    back = TB.state_to_numpy(ts)
    for f in JB.HashMapState._fields:
        assert back[f].dtype == arrays[f].dtype
        np.testing.assert_array_equal(back[f], arrays[f])
    back["key"][:] = -7                      # a copy: the state is intact
    assert_same(js, ts, "after writing the copy")
    update_both(js, ts, rng.integers(0, 2, 64), rng.integers(0, 40, 64),
                rng.integers(0, 99, 64), NB, "after carry")
