"""The port's flash attention (plain version and CPU wrapper) against the
JAX reference on the CPU, and the Hopper kernel against its plain version
on the card (``gpu``-marked: skipped without a card).

The JAX side runs as its own tests run it: the Pallas kernel in interpret
mode and the plain ``impl="xla"`` path.  Tolerance 2e-5 in f32 (the
tests/test_kernels.py tolerance: f32 sums in another order), 2e-2 in bf16.
JAX is imported by the tests that compare with it, so the card's test run
(``-m gpu``), on a machine without JAX, can import this file.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import attention_ref


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention as jfa
    from repro.kernels.flash_attention.ref import attention_ref as jref
    return types.SimpleNamespace(jnp=jnp, fa=jfa, ref=jref)


def _qkv(seed, B, Sq, Sk, H, K, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, K, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, K, dh)).astype(np.float32))


# tests/test_kernels.py's sweep, cut small: MHA, GQA 2:1 and 4:1, MQA
# rectangular, with TPU blocks that divide each length
@pytest.mark.parametrize("B,Sq,Sk,H,K,dh,bq,bk", [
    (1, 64, 64, 2, 2, 32, 32, 32),
    (2, 64, 64, 4, 2, 16, 32, 16),
    (1, 32, 32, 8, 2, 8, 16, 32),
    (2, 32, 96, 2, 1, 64, 32, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_port_matches_jax_pallas_and_xla(jx, B, Sq, Sk, H, K, dh, bq, bk,
                                         causal):
    q, k, v = _qkv(0, B, Sq, Sk, H, K, dh)
    jq, jk, jv = (jx.jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jx.fa(jq, jk, jv, causal=causal, impl="pallas",
                              interpret=True, block_q=bq, block_k=bk))
    xla = np.asarray(jx.fa(jq, jk, jv, causal=causal, impl="xla"))
    got = flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                          causal=causal)
    assert got.shape == (B, Sq, H, dh) and got.dtype == torch.float32
    for want in (pallas, xla):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [8, 16, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_sliding_window_matches_jax(jx, window, causal):
    q, k, v = _qkv(1, 2, 64, 64, 4, 2, 16)
    jq, jk, jv = (jx.jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jx.fa(jq, jk, jv, causal=causal, window=window,
                            impl="xla"))
    if causal:
        pallas = np.asarray(jx.fa(jq, jk, jv, causal=True, window=window,
                                  impl="pallas", interpret=True,
                                  block_q=16, block_k=16))
        np.testing.assert_allclose(pallas, want, atol=2e-5, rtol=2e-5)
    got = flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                          causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_rows_with_no_visible_key_give_zero(jx):
    """Non-causal window, more queries than keys: rows past the window
    see nothing and give exactly 0, in the port and in the reference's
    plain version.  The reference's Pallas kernel gives such a row the
    mean of v when it shares a visible KV tile with rows that do see keys
    (rows 23-31 here at 16-row blocks); the port follows the plain
    version and the kernel's own finalize (``l == 0`` -> 0)."""
    q, k, v = _qkv(2, 1, 48, 16, 2, 2, 8)
    want = np.asarray(jx.ref(*(jx.jnp.asarray(a.transpose(0, 2, 1, 3)
                                              .reshape(-1, a.shape[1], 8))
                               for a in (q, k, v)),
                             causal=False, window=8))
    got = attention_ref(*(torch.as_tensor(a).transpose(1, 2)
                          .reshape(-1, a.shape[1], 8) for a in (q, k, v)),
                        causal=False, window=8)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert not got[:, 23:].any() and bool((got[:, :23] != 0).any(-1).all())
    pallas = np.asarray(jx.fa(*(jx.jnp.asarray(a) for a in (q, k, v)),
                              causal=False, window=8, impl="pallas",
                              interpret=True, block_q=16, block_k=16))
    assert (pallas[:, 23:32] != 0).any(-1).all() and not pallas[:, 32:].any()


def test_bf16_plain_version_matches_jax(jx):
    q, k, v = _qkv(3, 2, 64, 64, 4, 2, 32)
    jb = [jx.jnp.asarray(a).astype(jx.jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jx.fa(*jb, causal=True, impl="xla"), np.float32)
    got = flash_attention(*(torch.as_tensor(a).to(torch.bfloat16)
                            for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Input checks run before the library is built or loaded."""
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention_kernel(q, k, k)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.to("meta"), k)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q, torch.zeros((1, 8, 3, 16)),
                        torch.zeros((1, 8, 3, 16)))
    launches = flash_attention.launches
    flash_attention(q, k, k)
    assert flash_attention.launches == launches    # the CPU launches nothing


def _attention_head_dims() -> dict:
    """Every arch with attention layers (all but the pure SSM) and its
    head dim."""
    from repro_torch.configs.registry import ARCHS
    return {c.name: c.head_dim for c in ARCHS.values() if c.family != "ssm"}


def test_bwd_route_for_every_arch_head_dim():
    """bf16 at d = 128 (qwen3-1.7b, gemma3-27b, the dense, MoE and VLM
    archs) and d = 64 (whisper-medium) takes the wgmma pair, zamba2-7b's
    d = 112 the mma.sync pair, f32 the scalar pair; no other d takes
    wgmma, and a d or dtype no kernel takes raises."""
    dims = _attention_head_dims()
    assert dims == {"whisper-medium": 64, "arctic-480b": 128,
                    "qwen2-moe-a2.7b": 128, "gemma3-27b": 128,
                    "qwen3-1.7b": 128, "qwen1.5-32b": 128, "qwen2-7b": 128,
                    "internvl2-26b": 128, "zamba2-7b": 112}
    routes = {a: tkernel.bwd_route(d, torch.bfloat16)
              for a, d in dims.items()}
    assert routes == {a: "mma_sync" if a == "zamba2-7b" else "wgmma"
                      for a in dims}
    assert {tkernel.bwd_route(d, torch.float32) for d in dims.values()} == \
        {"scalar"}
    assert [d for d in range(1, tkernel.MAX_HEAD_DIM + 1)
            if tkernel.bwd_route(d, torch.bfloat16) == "wgmma"] == [64, 128]
    for d, dtype in ((0, torch.bfloat16), (129, torch.float32),
                     (64, torch.float16)):
        with pytest.raises(ValueError):
            tkernel.bwd_route(d, dtype)


def test_bwd_kernels_fit_shared_memory_at_every_served_head_dim():
    """On every route, at every head dim an arch uses, each backward
    kernel's block fits the card's 232,448 bytes: the wgmma pair's rings
    (dq: Q and dO of 128 rows and three stages of K and V; dkdv: K and V
    of 128 keys and two stages of Q and dO) take 165,432 and 133,160
    bytes at d = 128, one block an SM."""
    for d in sorted(set(_attention_head_dims().values())):
        for dtype in (torch.bfloat16, torch.float32):
            dq, dkdv = tkernel.bwd_smem_bytes(d, dtype)
            assert 0 < dq <= tkernel.SMEM_LIMIT, (d, dtype, dq)
            assert 0 < dkdv <= tkernel.SMEM_LIMIT, (d, dtype, dkdv)
    assert tkernel.bwd_smem_bytes(128, torch.bfloat16) == (165_432, 133_160)
    assert tkernel.bwd_smem_bytes(64, torch.bfloat16) == (83_512, 67_624)
    assert tkernel.bwd_smem_bytes(112, torch.bfloat16) == (93_184, 93_184)
    assert tkernel.bwd_smem_bytes(128, torch.float32) == (148_736, 165_888)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card(cuda_device):
    """The Hopper kernel against attention_ref on the card: the sweep in
    f32 (2e-5), ragged lengths and windows, and bf16 (2e-2)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [(1, 128, 128, 2, 2, 64, True, 0), (2, 256, 256, 4, 2, 64,
                                                False, 0),
             (1, 256, 256, 8, 2, 32, True, 0), (2, 64, 192, 2, 1, 128,
                                                True, 0),
             (2, 256, 256, 4, 4, 64, True, 32), (1, 100, 77, 4, 2, 112,
                                                 True, 0),
             (1, 70, 70, 2, 1, 48, False, 16), (1, 48, 16, 2, 2, 8,
                                                False, 8)]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for B, Sq, Sk, H, K, dh, causal, window in cases:
            q = torch.randn((B, Sq, H, dh), generator=g, device=cuda_device)
            k = torch.randn((B, Sk, K, dh), generator=g, device=cuda_device)
            v = torch.randn((B, Sk, K, dh), generator=g, device=cuda_device)
            q, k, v = (t.to(dtype) for t in (q, k, v))
            before = flash_attention.launches
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
            ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=causal, window=window)
            torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [512, 500])
def test_bf16_tensor_core_kernel_at_the_serve_shape(cuda_device, S):
    """The bf16 tensor-core kernel at the zamba2-7b prefill shape (B = 4,
    H = K = 32, d = 112, causal), ragged at S = 500, against the plain
    version in f32 on the same values: 2e-2 abs + rel."""
    g = torch.Generator(device=cuda_device).manual_seed(S)
    q, k, v = (torch.randn((4, S, 32, 112), generator=g, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_f32_and_bf16_both_launch(cuda_device):
    """The dtype alone picks the kernel: f32 runs the scalar kernel, bf16
    the tensor-core kernel; the wrapper counts a launch of each, and each
    agrees with the plain version at its own tolerance."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn((2, 96, 4, 64), generator=g, device=cuda_device)
               for _ in range(3))
    ref = flash_attention_plain(q, k, v, causal=True)
    before = flash_attention.launches
    o32 = flash_attention(q, k, v, causal=True)
    o16 = flash_attention(*(t.to(torch.bfloat16) for t in (q, k, v)),
                          causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert (o32.dtype, o16.dtype) == (torch.float32, torch.bfloat16)
    torch.testing.assert_close(o32, ref, atol=2e-5, rtol=2e-5)
    ref16 = flash_attention_plain(*(t.to(torch.bfloat16).float()
                                    for t in (q, k, v)), causal=True)
    torch.testing.assert_close(o16.float(), ref16, atol=2e-2, rtol=2e-2)
    # the two paths do not share their arithmetic: bf16 rounds P
    assert not torch.equal(o16.float(), o32)


@pytest.mark.gpu
def test_bf16_kernel_takes_any_head_dim(cuda_device):
    """Every bf16 shape the wrapper takes runs the tensor-core kernel:
    head dims that are not a multiple of 8 (element loads, zero-padded to
    16 in shared memory) and odd ones (element stores), with GQA, ragged
    lengths, windows and rectangular non-causal attention: 2e-2 of the
    plain version in f32 on the same values."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    for B, Sq, Sk, H, K, dh, causal, window in [
            (1, 100, 100, 4, 2, 12, True, 0),
            (2, 70, 70, 2, 1, 100, True, 24),
            (1, 33, 90, 2, 2, 1, False, 0),
            (1, 130, 130, 4, 4, 120, False, 40)]:
        q = torch.randn((B, Sq, H, dh), generator=g, device=cuda_device)
        k = torch.randn((B, Sk, K, dh), generator=g, device=cuda_device)
        v = torch.randn((B, Sk, K, dh), generator=g, device=cuda_device)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
        torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("Sq,Sk", [(37, 100), (64, 150), (100, 100)])
def test_non_causal_plain_version_with_ragged_keys_matches_jax(jx, Sq, Sk):
    """The encoder's and the cross-attention's shapes, cut small:
    non-causal, Sq != Sk, Sk not a multiple of 64 (whisper's 1500 is
    not), d = 64 and GQA 6:1 (internvl2's head ratio), the plain version
    the CPU runs against the reference's ``attention_ref``."""
    B, H, K, dh = 2, 6, 1, 64
    q, k, v = _qkv(Sq + Sk, B, Sq, Sk, H, K, dh)

    def kl(a, n):          # model layout -> kernel layout [B*n, S, d]
        return np.moveaxis(a, 2, 1).reshape(B * n, a.shape[1], dh)
    want = np.asarray(jx.ref(*(jx.jnp.asarray(a) for a in (
        kl(q, H), kl(k, K), kl(v, K))), causal=False))
    got = flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                          causal=False)
    got = got.transpose(1, 2).reshape(B * H, Sq, dh)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,H,K,dh,causal", [
    (1500, 1500, 16, 16, 64, False),      # whisper's encoder
    (512, 1500, 16, 16, 64, False),       # its cross-attention
    (500, 1500, 16, 16, 64, False),
    (512, 512, 16, 16, 64, True),         # its decoder
    (768, 768, 48, 8, 128, True),         # internvl2 over its prefix
    (512, 512, 56, 8, 128, True),         # arctic-480b
])
def test_bf16_kernel_at_the_family_shapes(cuda_device, Sq, Sk, H, K, dh,
                                          causal):
    """The bf16 tensor-core kernel at the new families' prefill shapes
    (B = 2): non-causal with a ragged last KV tile (1500), Sq != Sk,
    d = 64, GQA 6:1 and 7:1, within 2e-2 of the plain version in f32 on
    the same values."""
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Sk + H)
    q = torch.randn((2, Sq, H, dh), generator=g, device=cuda_device)
    k, v = (torch.randn((2, Sk, K, dh), generator=g, device=cuda_device)
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


# --------------------------------------------------------------------- #
# the backward: plain version against autograd and jax.grad on the CPU,  #
# the kernels against it on the card                                     #
# --------------------------------------------------------------------- #
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_lse_plain)

# (B, Sq, Sk, H, K, dh, causal, window): causal, GQA 2:1 and 4:1,
# windows, non-causal, Sq != Sk (ragged), and the no-visible-key rows of
# test_rows_with_no_visible_key_give_zero (non-causal, window 8, 48 x 16)
BWD_CASES = [
    (2, 40, 40, 4, 2, 16, True, 0),
    (1, 64, 64, 8, 2, 8, True, 16),
    (2, 37, 53, 6, 1, 8, False, 0),
    (1, 33, 90, 2, 2, 16, False, 24),
    (1, 48, 16, 2, 2, 8, False, 8),
]
BWD_IDS = ["causal_gqa", "window", "noncausal_ragged", "noncausal_window",
           "no_visible_key"]
# f32 on both sides, sums in other orders
BWD_TOL = dict(atol=2e-5, rtol=2e-5)


def _bwd_inputs(case, seed=0):
    B, Sq, Sk, H, K, dh, causal, window = case
    q, k, v = _qkv(seed, B, Sq, Sk, H, K, dh)
    do = np.random.default_rng(seed + 1).standard_normal(
        (B, Sq, H, dh)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_bwd_plain_matches_autograd_through_the_plain_forward(case):
    """flash_attention_bwd_plain, from the forward's o and lse, against
    autograd through flash_attention_plain (which the CPU trains with),
    and the wrapper's CPU path against it; f32 at 2e-5."""
    B, Sq, Sk, H, K, dh, causal, window = case
    q, k, v, do = (torch.as_tensor(a) for a in _bwd_inputs(case))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash_attention(qg, kg, vg, causal=causal, window=window)
    want = torch.autograd.grad(o, (qg, kg, vg), do)
    lse = flash_attention_lse_plain(q, k, causal=causal, window=window)
    assert lse.shape == (B, H, Sq)
    got = flash_attention_bwd_plain(q, k, v, o.detach(), lse, do,
                                    causal=causal, window=window)
    wrapped = flash_attention_bwd(q, k, v, o.detach(), lse, do,
                                  causal=causal, window=window)
    for g, w, x in zip(got, want, wrapped):
        assert g.shape == w.shape and bool(w.abs().max() > 0)
        torch.testing.assert_close(g, w, **BWD_TOL)
        assert torch.equal(g, x)


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_bwd_plain_matches_jax_grad(jx, case):
    """The plain backward against ``jax.vjp`` of the reference's
    ``attention_ref`` (kernel layout, every case) and, where every row
    sees a key, of ``models.layers.attention_blocked`` (the function the
    reference's training differentiates: kv repeated to H, so dk/dv are
    summed over each group here); the lse against ``jax.nn.logsumexp`` of
    the masked scores.  f32 at 2e-5."""
    import jax
    from repro.models.layers import attention_blocked
    B, Sq, Sk, H, K, dh, causal, window = case
    q, k, v, do = _bwd_inputs(case)
    kl = lambda a: np.moveaxis(a, 2, 1).reshape(-1, a.shape[1], dh)  # noqa
    jq, jk, jv, jdo = (jx.jnp.asarray(kl(a)) for a in (q, k, v, do))
    o, vjp = jax.vjp(lambda a, b, c: jx.ref(a, b, c, causal=causal,
                                            window=window), jq, jk, jv)
    want = [np.asarray(g) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, do))
    lse = flash_attention_lse_plain(tq, tk, causal=causal, window=window)
    got = flash_attention_bwd_plain(tq, tk, tv, torch.as_tensor(np.array(
        np.moveaxis(np.asarray(o).reshape(B, H, Sq, dh), 1, 2))), lse, tdo,
        causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            np.moveaxis(g.numpy(), 2, 1).reshape(w.shape), w, **BWD_TOL)
    # lse against the masked scores' logsumexp
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = jx.jnp.einsum("bqd,bkd->bqk", jq, jx.jnp.repeat(jk, H // K, 0)) \
        / dh ** 0.5
    jl = np.asarray(jax.nn.logsumexp(jx.jnp.where(mask, s, -np.inf), -1))
    jl = np.where(mask.any(-1), jl, np.inf).reshape(B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), jl, **BWD_TOL)
    if not mask.any(-1).all():
        assert np.isinf(lse.numpy()).any()
        return
    # attention_blocked: [B, S, H, dh] with kv repeated to H
    rep = lambda a: jx.jnp.repeat(jx.jnp.asarray(a), H // K, axis=2)  # noqa
    _, vjp = jax.vjp(lambda a, b, c: attention_blocked(
        a, b, c, causal=causal, window=window or None, chunk=16),
        jx.jnp.asarray(q), rep(k), rep(v))
    bq, bk, bv = (np.asarray(g) for g in vjp(jx.jnp.asarray(do)))
    sum_group = lambda g: g.reshape(B, Sk, K, H // K, dh).sum(3)  # noqa
    for g, w in zip(got, (bq, sum_group(bk), sum_group(bv))):
        np.testing.assert_allclose(g.numpy(), w, **BWD_TOL)


def test_flash_attention_under_grad_on_the_cpu_has_nonzero_grads():
    """On the CPU a gradient reaches q, k and v through the plain
    version: nonzero, and no kernel launch counted."""
    q, k, v = (torch.as_tensor(a).requires_grad_(True)
               for a in _qkv(4, 1, 24, 24, 4, 2, 16))
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.square().sum().backward()
    for t in (q, k, v):
        assert bool(t.grad.abs().max() > 0)
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (f0, b0)


def _scaled_err(got, want):
    """max|got - want| / max|want|, and max|want| (a zero gradient would
    pass an absolute-plus-relative test)."""
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / scale, scale


# the card's backward cases: the training shape of qwen3-1.7b (cut to
# B = 1, S = 1024 here; chip_smoke.py checks the full one), zamba2's
# d = 112, whisper's cross shape (non-causal, Sq != Sk, ragged), a gemma3
# window (1024 over 1536) and the no-visible-key rows; then the wgmma
# pair's edges: d = 128 and d = 64 with Sq not a multiple of its 128-row
# blocks and GQA 7:1 (qwen2-7b's 28:4), and a window of 1024 over 2048
GPU_BWD_CASES = [
    (1, 1024, 1024, 16, 8, 128, True, 0),
    (1, 300, 300, 4, 4, 112, True, 0),
    (1, 200, 1500, 4, 4, 64, False, 0),
    (1, 1536, 1536, 4, 2, 128, True, 1024),
    (1, 48, 16, 2, 2, 8, False, 8),
    (1, 1000, 1000, 14, 2, 128, True, 0),
    (2, 333, 333, 7, 1, 64, True, 0),
    (1, 2048, 2048, 4, 2, 128, True, 1024),
] + BWD_CASES[:4]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_bwd_kernels_match_the_plain_version_on_card(cuda_device, dtype,
                                                     tol):
    """The backward kernels through autograd against the plain backward
    on the same values (f32, from the same o and lse): each gradient
    within ``tol * max|ref|`` and ``max|ref| > 0``; the forward's lse
    against the plain log-sum-exp (+inf rows where no key is visible);
    two backward calls give the same bits (no atomics)."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    for B, Sq, Sk, H, K, dh, causal, window in GPU_BWD_CASES:
        q = torch.randn((B, Sq, H, dh), generator=g, device=cuda_device)
        k = torch.randn((B, Sk, K, dh), generator=g, device=cuda_device)
        v = torch.randn((B, Sk, K, dh), generator=g, device=cuda_device)
        do = torch.randn((B, Sq, H, dh), generator=g, device=cuda_device)
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
        o, lse = tkernel.flash_attention_kernel(q, k, v, causal=causal,
                                                window=window, with_lse=True)
        assert torch.equal(o, flash_attention(q, k, v, causal=causal,
                                              window=window))
        want_lse = flash_attention_lse_plain(q.float(), k.float(),
                                             causal=causal, window=window)
        assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
        fin = torch.isfinite(want_lse)
        torch.testing.assert_close(lse[fin], want_lse[fin], atol=1e-4,
                                   rtol=1e-5)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        before = flash_attention_bwd.launches
        out = flash_attention(qg, kg, vg, causal=causal, window=window)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, (qg, kg, vg), do)
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches == before + 1
        want = flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            causal=causal, window=window)
        for name, a, w in zip("qkv", got, want):
            err, scale = _scaled_err(a, w)
            assert scale > 0 and err <= tol, (name, err, B, Sq, Sk, dh)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
