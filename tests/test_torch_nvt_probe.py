"""The port's nvt_probe (plain version, CPU wrapper, tile makers) against
the JAX reference on the CPU, and the Hopper kernel against its plain
version on the card (``gpu``-marked: skipped without a card).

Every comparison is exact.  The JAX side runs as its own tests run it:
the Pallas kernel in interpret mode and the plain ``impl="xla"`` path.
JAX is imported by the tests that compare with it, so the card's test run
(``-m gpu``), on a machine without JAX, can import this file.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import batched as TB
from repro_torch.kernels.nvt_probe import kernel as tkernel
from repro_torch.kernels.nvt_probe import ref as tref
from repro_torch.kernels.nvt_probe.ops import nvt_probe


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: jnp, repro.core.batched, the probe's ref/ops."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import batched
    from repro.kernels.nvt_probe import ref
    from repro.kernels.nvt_probe.ops import nvt_probe as probe
    return types.SimpleNamespace(jnp=jnp, B=batched, ref=ref, probe=probe)


def first_fit_tiles(keys, nb, cap, val_mult=3):
    """The reference tests' own tile layout (test_kernels.py)."""
    kt = np.zeros((nb, cap), np.int32)
    vt = np.zeros((nb, cap), np.int32)
    slots = np.zeros(nb, np.int32)
    for k in keys:
        b = int(tref.mix32_np(k) % np.uint32(nb))
        if slots[b] < cap:
            kt[b, slots[b]] = k
            vt[b, slots[b]] = k * val_mult
            slots[b] += 1
    return kt, vt


@pytest.mark.parametrize("nb,cap,nq", [(64, 16, 128), (256, 32, 256),
                                       (16, 8, 64), (3000, 8, 61)])
def test_probe_matches_jax_pallas_and_xla(jx, nb, cap, nq):
    rng = np.random.default_rng(0)
    keys = rng.choice(np.arange(1, 10_000), size=min(nb * cap // 2, 9000),
                      replace=False).astype(np.int32)
    kt, vt = first_fit_tiles(keys, nb, cap)
    kt[0, -1] = kt[0, 0]                     # a duplicate key in one row
    queries = rng.integers(1, 10_000, size=nq).astype(np.int32)
    queries[:3] = (0, -1, kt[0, 0])           # empty slot, padding, dup
    jk, jv, jq = (jx.jnp.asarray(a) for a in (kt, vt, queries))
    pf, pv = jx.probe(jk, jv, jq, impl="pallas", interpret=True, block_q=64)
    xf, xv = jx.probe(jk, jv, jq, impl="xla")
    np.testing.assert_array_equal(np.asarray(pf), np.asarray(xf))
    np.testing.assert_array_equal(np.asarray(pv), np.asarray(xv))
    tk, tv, tq = (torch.as_tensor(a) for a in (kt, vt, queries))
    launches = nvt_probe.launches
    for f, v in (tref.probe_ref(tk, tv, tq), nvt_probe(tk, tv, tq)):
        assert f.dtype == v.dtype == torch.int32
        np.testing.assert_array_equal(f.numpy(), np.asarray(xf))
        np.testing.assert_array_equal(v.numpy(), np.asarray(xv))
    assert nvt_probe.launches == launches     # the CPU launches nothing


def test_probe_sums_wrap_in_int32_like_jax(jx):
    kt = np.full((4, 8), 7, np.int32)
    vt = np.full((4, 8), 2**30, np.int32)     # 8 hits of 2**30 wrap to 0
    vt[:, 0] = 2**31 - 1
    q = np.array([7, 7, 3, 7], np.int32)
    xf, xv = jx.probe(*(jx.jnp.asarray(a) for a in (kt, vt, q)), impl="xla")
    f, v = nvt_probe(*(torch.as_tensor(a) for a in (kt, vt, q)))
    np.testing.assert_array_equal(f.numpy(), np.asarray(xf))
    np.testing.assert_array_equal(v.numpy(), np.asarray(xv))


def test_mix32_matches_jax(jx):
    x = np.random.default_rng(1).integers(-2**31, 2**31, size=5000,
                                          dtype=np.int64).astype(np.int32)
    want = np.asarray(jx.ref.mix32(jx.jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(tref.mix32(torch.as_tensor(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(tref.mix32_np(x), jx.ref.mix32_np(x))


@pytest.mark.parametrize("val_mult", [3, 5])
def test_tiles_from_keys_matches_jax(jx, val_mult):
    rng = np.random.default_rng(val_mult)
    keys = rng.integers(-2**31, 2**31, size=3000, dtype=np.int64)
    keys = keys.astype(np.int32)
    keys = np.concatenate([keys, keys[:40]])          # duplicate keys
    jk, jv = jx.ref.tiles_from_keys(keys, 64, 16, val_mult)   # rows overflow
    tk, tv = tref.tiles_from_keys(keys, 64, 16, val_mult, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _jax_map_with_deletes_and_resurrects(jx, nb):
    B, jnp = jx.B, jx.jnp
    js = B.make_state(1024, nb)
    ks = jnp.arange(1, 301)
    js, _, _ = B.insert_parallel(js, ks, ks * 7, nb)
    js, _, _ = B.delete_parallel(js, jnp.arange(1, 120), nb)
    js, _, _ = B.insert_parallel(js, jnp.arange(50, 80),
                                 jnp.arange(50, 80) * 11, nb)
    return js


def test_tiles_from_hashmap_matches_the_jax_loop(jx):
    nb, cap = 32, 16
    js = _jax_map_with_deletes_and_resurrects(jx, nb)
    jk, jv = jx.ref.tiles_from_hashmap(js, nb, cap)
    ts = TB.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in jx.B.HashMapState._fields},
        "cpu")
    tk, tv = tref.tiles_from_hashmap(ts, nb, cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the tiles answer like the chain walk (test_kernels' cross-check)
    q = torch.arange(1, 321)
    f, v = nvt_probe(tk, tv, q)
    cf, cv = TB.lookup(ts, q, nb)
    assert torch.equal(f.bool(), cf) and torch.equal(v * f, cv * cf)


def test_tiles_from_hashmap_raises_on_bucket_overflow(jx):
    js = _jax_map_with_deletes_and_resurrects(jx, 4)        # ~50 live a row
    with pytest.raises(AssertionError):
        jx.ref.tiles_from_hashmap(js, 4, 8)
    ts = TB.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in jx.B.HashMapState._fields},
        "cpu")
    with pytest.raises(ValueError, match="bucket overflow"):
        tref.tiles_from_hashmap(ts, 4, 8)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """Input checks run before the library is built or loaded."""
    kt = torch.zeros((8, 4), dtype=torch.int32)
    q = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.nvt_probe_kernel(kt, kt, q)
    with pytest.raises(ValueError, match="one device"):
        nvt_probe(kt.to("meta"), kt, q)


_Z = torch.zeros((8, 4), dtype=torch.int32)


@pytest.mark.parametrize("keys,vals,queries,match", [
    (torch.zeros((8, 0), dtype=torch.int32),
     torch.zeros((8, 0), dtype=torch.int32), _Z[0], "cap=0"),
    (torch.zeros((0, 4), dtype=torch.int32),
     torch.zeros((0, 4), dtype=torch.int32), _Z[0], "NB=0"),
    (_Z.long(), _Z.long(), _Z[0], "int32"),
    (_Z, _Z.float(), _Z[0], "int32"),
    (_Z, _Z, _Z[0].long(), "int32"),
    (_Z, torch.zeros((8, 8), dtype=torch.int32), _Z[0], "shapes differ"),
    (_Z, torch.zeros((4, 4), dtype=torch.int32), _Z[0], "shapes differ"),
    (_Z[0], _Z[0], _Z[0], "rank 2"),
    (_Z, _Z, _Z, "rank 1"),
    (_Z.t(), _Z.t(), _Z[0], "contiguous"),
], ids=["zero_cap", "zero_buckets", "int64_tiles", "float_vals",
        "int64_queries", "wider_vals", "fewer_val_rows", "rank1_tiles",
        "rank2_queries", "strided_tiles"])
def test_kernel_wrapper_rejects_bad_inputs(keys, vals, queries, match):
    """What the kernel does not take is refused by shape and type, before
    the device is looked at (so the host reaches every case)."""
    with pytest.raises(ValueError, match=match):
        tkernel.nvt_probe_kernel(keys, vals, queries)


@pytest.mark.parametrize("nq", [1, 7, 33, 61, 4097])
def test_wrapper_matches_jax_with_no_padding(jx, nq):
    """Any query count, as the JAX wrapper answers it (``impl="xla"``,
    which pads to its block and slices): the port pads nothing."""
    rng = np.random.default_rng(nq)
    kt, vt = first_fit_tiles(rng.choice(np.arange(1, 5000), size=600,
                                        replace=False), 257, 8)
    queries = rng.integers(-2, 5000, size=nq).astype(np.int32)
    queries[: min(nq, 2)] = (0, -1)[: min(nq, 2)]
    xf, xv = jx.probe(*(jx.jnp.asarray(a) for a in (kt, vt, queries)),
                      impl="xla")
    f, v = nvt_probe(*(torch.as_tensor(a) for a in (kt, vt, queries)))
    assert f.shape == v.shape == (nq,)
    np.testing.assert_array_equal(f.numpy(), np.asarray(xf))
    np.testing.assert_array_equal(v.numpy(), np.asarray(xv))


@pytest.mark.parametrize("aligned", [True, False])
def test_launch_geometry_covers_each_slot_once(aligned):
    """For every cap in 1..300, the lanes of a row group and their chunks
    (vector ``c * lanes + t`` of ``vec`` words, guarded to the row) read
    each slot of the row exactly once, a pass fits one lane's 32-bit hit
    mask, and a load's rows tile a warp."""
    for cap in range(1, 301):
        g = tkernel.launch_geometry(cap, aligned)
        assert g.vec == (4 if aligned and cap % 4 == 0 else 1)
        assert g.lanes & (g.lanes - 1) == 0 and g.lanes * g.vec <= 32
        assert g.lanes * g.rows_per_load == 32
        nvec = cap // g.vec
        slots = [v * g.vec + e for c in range(g.chunks)
                 for t in range(g.lanes) for v in [c * g.lanes + t]
                 if v < nvec for e in range(g.vec)]
        assert sorted(slots) == list(range(cap)), cap
        # no pass is idle, and a narrow row takes the fewest lanes
        assert (g.chunks - 1) * g.lanes < nvec
        assert g.lanes * g.vec == 32 or g.lanes // 2 < nvec
    with pytest.raises(ValueError):
        tkernel.launch_geometry(0, aligned)


def warp_model(kt, vt, q, aligned):
    """The kernel's schedule for one batch of ``len(q) <= 32`` queries,
    lane by lane: which lanes read which words of which row in which
    pass, how lane r gathers its row's hit bits from the lanes that read
    it, and the values it then loads.  Sums wrap in uint32, as on the
    card."""
    nb, cap = kt.shape
    g = tkernel.launch_geometry(cap, aligned)
    L, R, n, V = g.lanes, g.rows_per_load, len(q), g.vec
    nvec = cap // V
    qs = np.zeros(32, np.int32)
    qs[:n] = q
    b = (tref.mix32_np(qs) % np.uint32(nb)).astype(np.int64)
    found = np.zeros(32, bool)
    sums = np.zeros(32, np.uint32)
    for c in range(g.chunks):
        hits = np.zeros((32, L), np.int64)          # lane, step: VEC bits
        for lane in range(32):
            grp, sub = divmod(lane, L)
            v = c * L + sub
            for s in range(L):
                r = s * R + grp
                if r < n and v < nvec:
                    m = kt[b[r], v * V:(v + 1) * V] == qs[r]
                    hits[lane, s] = sum(1 << e for e in np.flatnonzero(m))
        for lane in range(32):
            step, grp = divmod(lane, R)
            mine = 0
            for t in range(L):
                mine |= int(hits[grp * L + t, step]) << (t * V)
            assert mine < 2**32
            found[lane] |= mine != 0
            for i in range(32):
                if mine >> i & 1:
                    sums[lane] += np.uint32(vt[b[lane], c * L * V + i]
                                            .astype(np.uint32))
    return found[:n].astype(np.int32), sums[:n].view(np.int32)


@pytest.mark.parametrize("cap", [1, 4, 7, 8, 32, 33, 40, 64, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_warp_schedule_model_matches_probe_ref(cap, aligned):
    """The kernel's index arithmetic, modelled lane by lane on the host,
    answers as the plain version on full and ragged batches, with query
    0 summing empty slots that hold values and a duplicated key whose
    values wrap (a row of cap hits over several passes)."""
    rng = np.random.default_rng(cap)
    nb = 37
    kt, vt = first_fit_tiles(rng.choice(np.arange(1, 100_000),
                                        size=nb * cap // 2, replace=False),
                             nb, cap)
    vt[kt == 0] = rng.integers(-9, 9, size=int((kt == 0).sum()))
    kt[3, :] = 11                            # one key fills a whole row
    vt[3, :] = 2**30 + 7
    for n in (32, 13):
        q = rng.choice(kt[kt != 0], size=n).astype(np.int32)
        q[:4] = (0, -1, 11, 200_000)
        want = tref.probe_ref(*(torch.as_tensor(a) for a in (kt, vt, q)))
        got = warp_model(kt, vt, q, aligned)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_tiles(rng, nb, cap, dev):
    """Tiles half full of distinct keys, with non-zero values in the
    empty slots (query 0 sums them as stored)."""
    keys = rng.choice(1 << 24, size=max(1, nb * cap // 2),
                      replace=False).astype(np.int32) + 1
    kt, vt = tref.tiles_from_keys(keys, nb, cap, device=dev)
    empty = kt == 0
    vt[empty] = torch.as_tensor(rng.integers(
        -2**31, 2**31, size=int(empty.sum()), dtype=np.int64).astype(
            np.int32), device=dev)
    return kt, vt


def card_queries(rng, kt, nq, dev):
    """Half hits, half random keys; 0, -1 and a stored key first."""
    present = kt[kt != 0]
    q = torch.as_tensor(rng.integers(1, 1 << 24, size=nq).astype(np.int32),
                        device=dev)
    if present.numel():
        pick = torch.as_tensor(rng.integers(0, present.numel(), size=nq),
                               device=dev)
        q = torch.where(torch.as_tensor(rng.random(nq) < 0.5, device=dev),
                        present[pick], q)
    head = [0, -1] + ([int(present[0])] if present.numel() else [])
    q[: min(nq, len(head))] = torch.tensor(head[:nq], dtype=torch.int32,
                                           device=dev)
    return q


def probe_once_on_card(kt, vt, q):
    before = nvt_probe.launches
    f, v = nvt_probe(kt, vt, q)
    torch.cuda.synchronize()
    assert nvt_probe.launches == before + 1
    return f, v


@pytest.mark.gpu
@pytest.mark.parametrize("nq", [1, 31, 33, 4097, 1 << 16])
@pytest.mark.parametrize("cap", [1, 7, 8, 32, 33, 40, 64, 256])
def test_kernel_matches_probe_ref_on_card(cuda_device, cap, nq):
    """The Hopper kernel bit for bit against its plain version, one launch
    and no padding, at odd NB, ragged Q, both load paths, with 0 (which
    sums the values stored in empty slots), -1 and stored queries."""
    rng = np.random.default_rng(cap * 7 + nq)
    for nb in (1, 257, 3000):
        kt, vt = card_tiles(rng, nb, cap, cuda_device)
        q = card_queries(rng, kt, nq, cuda_device)
        f, v = probe_once_on_card(kt, vt, q)
        rf, rv = tref.probe_ref(kt, vt, q)
        assert torch.equal(f, rf) and torch.equal(v, rv), (nb, cap, nq)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8, 32, 33, 256])
def test_kernel_sums_duplicate_keys_that_wrap_on_card(cuda_device, cap):
    """Rows full of one key whose values wrap int32 when summed."""
    nb = 257
    kt = torch.full((nb, cap), 7, dtype=torch.int32, device=cuda_device)
    vt = torch.full((nb, cap), 2**30 + 3, dtype=torch.int32,
                    device=cuda_device)
    vt[:, 0] = 2**31 - 1
    q = torch.tensor([7, 7, 3, 0, -1, 7] * 50, dtype=torch.int32,
                     device=cuda_device)
    f, v = probe_once_on_card(kt, vt, q)
    rf, rv = tref.probe_ref(kt, vt, q)
    assert torch.equal(f, rf) and torch.equal(v, rv)
    assert int(v[0]) == int(np.int32(np.uint32(
        (2**31 - 1 + (cap - 1) * (2**30 + 3)) % 2**32)))


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [4, 32, 64])
def test_query_zero_sums_empty_slot_values_on_card(cuda_device, cap):
    """Key 0 marks an empty slot; query 0 finds every empty slot of its
    row and sums the values stored there, whatever they are."""
    rng = np.random.default_rng(cap)
    kt, vt = card_tiles(rng, 3000, cap, cuda_device)
    q = torch.zeros(4097, dtype=torch.int32, device=cuda_device)
    f, v = probe_once_on_card(kt, vt, q)
    rf, rv = tref.probe_ref(kt, vt, q)
    assert torch.equal(f, rf) and torch.equal(v, rv)
    assert int(v[0]) != 0


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [4, 32, 40])
def test_kernel_reads_unaligned_tiles_on_card(cuda_device, cap):
    """Tiles that start 4 bytes past a 16-byte boundary take the
    element loads; the answers stay bit for bit."""
    rng = np.random.default_rng(cap + 1)
    nb = 3000
    kt0, vt0 = card_tiles(rng, nb, cap, cuda_device)
    buf = torch.zeros((2, nb * cap + 1), dtype=torch.int32,
                      device=cuda_device)
    kt = buf[0, 1:].view(nb, cap)
    vt = buf[1, 1:].view(nb, cap)
    kt.copy_(kt0)
    vt.copy_(vt0)
    assert kt.data_ptr() % 16 and kt.is_contiguous()
    assert tkernel.launch_geometry(cap, False).vec == 1
    q = card_queries(rng, kt, 1 << 16, cuda_device)
    f, v = probe_once_on_card(kt, vt, q)
    rf, rv = tref.probe_ref(kt0, vt0, q)
    assert torch.equal(f, rf) and torch.equal(v, rv)
