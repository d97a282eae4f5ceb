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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_probe_ref_on_card(cuda_device):
    """The Hopper kernel bit for bit against its plain version, at odd NB,
    ragged Q (padded by the wrapper), with 0/-1/duplicate queries."""
    rng = np.random.default_rng(2)
    for nb, cap, nq in [(3000, 32, 4097), (1 << 16, 32, 1 << 16),
                        (257, 40, 100), (64, 8, 8)]:
        keys = rng.integers(1, 1 << 24, size=nb * cap // 2).astype(np.int32)
        kt, vt = tref.tiles_from_keys(keys, nb, cap, device=cuda_device)
        q = torch.as_tensor(rng.integers(1, 1 << 24, size=nq).astype(
            np.int32), device=cuda_device)
        q[: min(nq, 3)] = torch.tensor([0, -1, int(kt[0, 0])][:min(nq, 3)],
                                       device=cuda_device)
        before = nvt_probe.launches
        f, v = nvt_probe(kt, vt, q)
        torch.cuda.synchronize()
        assert nvt_probe.launches == before + 1
        rf, rv = tref.probe_ref(kt, vt, q)
        assert torch.equal(f, rf) and torch.equal(v, rv), (nb, cap, nq)
