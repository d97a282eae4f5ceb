"""The port's SSD scan (sequential oracle, chunked plain version, CPU
wrapper) and its plain backward against the JAX reference on the CPU, and
the Hopper kernels, forward and backward, against their plain versions on
the card (``gpu``-marked: skipped without a card).

The JAX side runs as its own tests run it: the Pallas kernel in interpret
mode, the ``impl="xla"`` oracle and ``models/mamba2.py:ssd_chunked``.
Tolerance 1e-4 in f32 and 5e-2 in bf16 (the tests/test_kernels.py
tolerances: f32 sums in another order; the reference's chunked form
rounds its scores to bf16 where the kernel keeps f32).  JAX is imported
by the tests that compare with it, so the card's test run (``-m gpu``),
on a machine without JAX, can import this file.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel as tkernel
from repro_torch.kernels.ssd_scan.ops import SsdScanFn, ssd_scan, ssd_scan_bwd
from repro_torch.kernels.ssd_scan.ref import (ssd_bwd_states_plain,
                                              ssd_chunked, ssd_ref,
                                              ssd_scan_bwd_plain,
                                              ssd_scan_passes_plain)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ops import ssd_scan as jscan
    from repro.kernels.ssd_scan.ref import ssd_ref as jref
    from repro.models.mamba2 import ssd_chunked as jchunked
    return types.SimpleNamespace(jax=jax, jnp=jnp, scan=jscan, ref=jref,
                                 chunked=jchunked)


def _inputs(seed, B, S, H, P, N):
    """Model-like inputs (tests/test_kernels.py's distributions)."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    return xh, dt, A, Bm, Cm


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


# tests/test_kernels.py's sweep: padded and uneven final chunks included
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 64, 4, 32, 16, 32),
    (1, 96, 2, 64, 32, 32),
    (2, 80, 2, 16, 16, 32),
])
def test_chunked_and_wrapper_match_jax(jx, B, S, H, P, N, chunk):
    xh, dt, A, Bm, Cm = ins = _inputs(0, B, S, H, P, N)
    j = [jx.jnp.asarray(a) for a in ins]
    pallas = np.asarray(jx.scan(*j, chunk=chunk, impl="pallas",
                                interpret=True))
    xla = np.asarray(jx.scan(*j, chunk=chunk, impl="xla"))
    jy, jfinal = (np.asarray(a) for a in jx.chunked(*j, chunk))
    y, final = ssd_scan(*_t(*ins), chunk=chunk)
    y2, final2 = ssd_chunked(*_t(*ins), chunk)
    assert torch.equal(y, y2) and torch.equal(final, final2)
    assert y.shape == (B, S, H, P) and final.shape == (B, H, P, N)
    for want in (pallas, xla, jy):
        np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(final.numpy(), jfinal, atol=1e-4, rtol=1e-4)


def test_init_state_carries_in_like_jax(jx):
    B, S, H, P, N, chunk = 2, 48, 3, 16, 8, 16
    ins = _inputs(1, B, S, H, P, N)
    init = np.random.default_rng(9).standard_normal(
        (B, H, P, N)).astype(np.float32)
    j = [jx.jnp.asarray(a) for a in ins]
    jy, jfinal = jx.chunked(*j, chunk, init_state=jx.jnp.asarray(init))
    y, final = ssd_scan(*_t(*ins), chunk=chunk,
                        init_state=torch.as_tensor(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), atol=1e-4,
                               rtol=1e-4)
    # splitting the sequence and carrying the state gives the whole scan
    ya, sa = ssd_chunked(*_t(*(a[:, :32] for a in ins[:2])), _t(ins[2])[0],
                         *_t(*(a[:, :32] for a in ins[3:])), chunk,
                         init_state=torch.as_tensor(init))
    yb, sb = ssd_chunked(*_t(*(a[:, 32:] for a in ins[:2])), _t(ins[2])[0],
                         *_t(*(a[:, 32:] for a in ins[3:])), chunk,
                         init_state=sa)
    torch.testing.assert_close(torch.cat([ya, yb], 1), y, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(sb, final, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S,chunk", [(64, 16), (40, 16)])
def test_sequential_oracle_matches_jax(jx, S, chunk):
    """ssd_ref on the kernel layout; the pad path pads to whole chunks
    with dt = 0, which leaves the final state as it was."""
    B, H, P, N = 2, 2, 8, 4
    xh, dt, A, Bm, Cm = _inputs(2, B, S, H, P, N)
    pad = (-S) % chunk
    C = (S + pad) // chunk

    def lay(a, tail):      # [B,S,H,...] -> [B*H, C, Q, ...], zero-padded
        a = np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
        return np.moveaxis(a, 2, 1).reshape((B * H, C, chunk) + tail)

    xk, dtk = lay(xh, (P,)), lay(dt, ())
    dAk = dtk * np.tile(A, B)[:, None, None]
    bk = np.repeat(np.pad(Bm, [(0, 0), (0, pad), (0, 0)])[:, None], H,
                   1).reshape(B * H, C, chunk, N)
    ck = np.repeat(np.pad(Cm, [(0, 0), (0, pad), (0, 0)])[:, None], H,
                   1).reshape(B * H, C, chunk, N)
    want = np.asarray(jx.ref(*(jx.jnp.asarray(a)
                               for a in (xk, dtk, dAk, bk, ck))))
    y, state = ssd_ref(*_t(xk, dtk, dAk, bk, ck))
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)
    _, final = ssd_chunked(*_t(xh, dt, A, Bm, Cm), chunk)
    np.testing.assert_allclose(state.numpy(),
                               final.numpy().reshape(B * H, P, N),
                               atol=1e-4, rtol=1e-4)


def test_bf16_plain_version_matches_jax(jx):
    """The reference's bf16 casts (scores and decays rounded to the input
    dtype) are kept: the port's chunked bf16 scan against JAX's at the
    bf16 tolerance."""
    ins = _inputs(3, 2, 64, 2, 16, 8)
    j = [jx.jnp.asarray(a) for a in ins]
    jb = [a.astype(jx.jnp.bfloat16) for a in j[:2]] + [j[2]] + \
        [a.astype(jx.jnp.bfloat16) for a in j[3:]]
    jy, jfinal = jx.chunked(*jb, 16)
    tb = [torch.as_tensor(a).to(torch.bfloat16) for a in ins]
    tb[2] = torch.as_tensor(ins[2])
    y, final = ssd_scan(*tb, chunk=16)
    assert y.dtype == final.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), atol=5e-2,
                               rtol=5e-2)
    np.testing.assert_allclose(final.float().numpy(),
                               np.asarray(jfinal, np.float32), atol=5e-2,
                               rtol=5e-2)
    # an f32 state carried under bf16 activations promotes as in JAX
    init = np.random.default_rng(8).standard_normal(
        (2, 2, 16, 8)).astype(np.float32)
    jy, jfinal = jx.chunked(*jb, 16, init_state=jx.jnp.asarray(init))
    y, final = ssd_scan(*tb, chunk=16, init_state=torch.as_tensor(init))
    assert y.dtype == final.dtype == torch.float32
    assert str(jy.dtype) == str(jfinal.dtype) == "float32"
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=5e-2,
                               rtol=5e-2)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("B,S,H,P,N,chunk,with_init", [
    (1, 64, 2, 16, 8, 16, False),
    (2, 80, 3, 16, 16, 32, True),       # a ragged last chunk
    (1, 72, 2, 64, 128, 32, True),      # mamba2-370m's P and N
])
def test_three_pass_plain_matches_jax_and_the_chunked_form(
        jx, B, S, H, P, N, chunk, with_init):
    """The forward as the bf16 kernels split it (each chunk's own state
    contribution, the scan, each chunk's output) against the reference's
    ``ssd_chunked`` and its Pallas kernel in interpret mode (1e-4, f32);
    its chunk start states are the final states of ``ssd_chunked`` run
    on each prefix of whole chunks (the first the init_state), and its
    final state the whole run's."""
    xh, dt, A, Bm, Cm = ins = _inputs(12 + S, B, S, H, P, N)
    init = np.random.default_rng(S).standard_normal(
        (B, H, P, N)).astype(np.float32) * 0.5 if with_init else None
    j = [jx.jnp.asarray(a) for a in ins]
    jy, jfinal = jx.chunked(*j, chunk, init_state=None if init is None
                            else jx.jnp.asarray(init))
    tinit = None if init is None else torch.as_tensor(init)
    y, final, states = ssd_scan_passes_plain(*_t(*ins), chunk,
                                             init_state=tinit)
    n_chunks = -(-S // chunk)
    assert y.shape == (B, S, H, P) and final.shape == (B, H, P, N)
    assert states.shape == (B, n_chunks, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal),
                               atol=1e-4, rtol=1e-4)
    if init is None:
        pallas = np.asarray(jx.scan(*j, chunk=chunk, impl="pallas",
                                    interpret=True))
        np.testing.assert_allclose(y.numpy(), pallas, atol=1e-4, rtol=1e-4)
    t = _t(*ins)
    for c in range(n_chunks):
        want = torch.zeros((B, H, P, N)) if init is None else tinit
        if c:
            want = ssd_chunked(t[0][:, :c * chunk], t[1][:, :c * chunk],
                               t[2], t[3][:, :c * chunk],
                               t[4][:, :c * chunk], chunk,
                               init_state=tinit)[1]
        torch.testing.assert_close(states[:, c], want.float(), atol=1e-4,
                                   rtol=1e-4)


def test_forward_route_and_shared_memory_at_every_ssm_shape():
    """bf16 at every SSM arch's scan (zamba2-7b: P = N = 64; mamba2-370m:
    P = 64, N = 128; chunk 128) takes the three wgmma passes, whose
    blocks fit the card: the state pass 52,224 / 35,840 bytes (N = 128 /
    64: the backward's delta pass's layout), the chunk pass 166,952 /
    101,416 (B and C, two stages of a head's x and split start state),
    the split state 32,768 / 16,384 bytes a (batch, chunk, head).  P
    above 64 or chunks above 128 take ``ssd_scan_tc`` (the mma.sync
    route), f32 the scalar kernel; each route's block fits at these
    shapes."""
    from repro_torch.configs.registry import ARCHS
    for c in ARCHS.values():
        if c.ssm_state:
            assert tkernel.fwd_route(c.ssm_head_dim, c.ssm_state,
                                     c.ssm_chunk, torch.bfloat16) == "wgmma"
    assert tkernel.fwd_wg_smem_bytes(128) == (52_224, 166_952)
    assert tkernel.fwd_wg_smem_bytes(64) == (35_840, 101_416)
    assert tkernel.fwd_wg_smem_bytes(8) == tkernel.fwd_wg_smem_bytes(64)
    assert (tkernel.fwd_split_state_bytes(128),
            tkernel.fwd_split_state_bytes(64)) == (32_768, 16_384)
    assert tkernel.fwd_wg_smem_bytes(128)[0] == \
        tkernel.delta_wg_smem_bytes(128)
    for P, N, Q, route in ((64, 128, 128, "wgmma"), (7, 20, 40, "wgmma"),
                           (80, 16, 32, "mma_sync"),
                           (64, 64, 256, "mma_sync"),
                           (65, 128, 128, "mma_sync")):
        assert tkernel.fwd_route(P, N, Q, torch.bfloat16) == route
        assert tkernel.fwd_route(P, N, Q, torch.float32) == "scalar"
        assert tkernel.fwd_smem_bytes(Q, P, N, torch.bfloat16) <= \
            tkernel.SMEM_LIMIT
        assert tkernel.fwd_smem_bytes(Q, P, N, torch.bfloat16, "mma_sync") \
            == tkernel.tc_smem_bytes(Q, P, N)
    with pytest.raises(ValueError):
        tkernel.fwd_route(64, 64, 128, torch.float16)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Input checks run before the library is built or loaded."""
    xh, dt, A, Bm, Cm = _t(*_inputs(4, 1, 16, 2, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ssd_scan_kernel(xh, dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="one device"):
        ssd_scan(xh, dt, A, Bm.to("meta"), Cm, chunk=16)
    assert tkernel.smem_bytes(128, 64, 64) <= tkernel.SMEM_LIMIT
    assert tkernel.smem_bytes(128, 128, 128) > tkernel.SMEM_LIMIT
    launches = ssd_scan.launches
    ssd_scan(xh, dt, A, Bm, Cm, chunk=16)
    assert ssd_scan.launches == launches      # the CPU launches nothing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scan(xh, dt, A, Bm, Cm, route, **kw):
    """The forward through the wrapper (route None: the rule's, counted
    as a launch), or through the binding on a named bf16 route."""
    if route is None or xh.dtype == torch.float32:
        before = ssd_scan.launches
        out = ssd_scan(xh, dt, A, Bm, Cm, **kw)
        assert ssd_scan.launches == before + 1
        return out
    return tkernel.ssd_scan_kernel(xh, dt, A, Bm, Cm, route=route, **kw)


# the bf16 forward's two routes: the rule's (the wgmma passes at P <= 64,
# N <= 128, chunk <= 128; ssd_scan_tc elsewhere) and ssd_scan_tc by name
FWD_ROUTES = [None, "mma_sync"]


@pytest.mark.gpu
@pytest.mark.parametrize("route", FWD_ROUTES, ids=["rule", "mma_sync"])
def test_kernel_matches_plain_versions_on_card(cuda_device, route):
    """y and the final state of the Hopper kernels against ssd_chunked on
    the card: f32 at 1e-4, bf16 at 5e-2 on each bf16 route, with ragged
    last chunks and a carried-in state."""
    for (B, S, H, P, N, chunk) in [(1, 64, 2, 16, 8, 16),
                                   (2, 80, 2, 16, 16, 32),
                                   (2, 300, 4, 64, 64, 128),
                                   (1, 96, 3, 32, 16, 32)]:
        ins = [torch.as_tensor(a, device=cuda_device)
               for a in _inputs(5, B, S, H, P, N)]
        init = torch.randn((B, H, P, N), device=cuda_device) * 0.5
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            xh, dt, A, Bm, Cm = ins
            xh, Bm, Cm = (t.to(dtype) for t in (xh, Bm, Cm))
            y, final = _scan(xh, dt, A, Bm, Cm, route, chunk=chunk,
                             init_state=init)
            torch.cuda.synchronize()
            assert y.dtype == dtype and final.dtype == torch.float32
            # the plain version in f32 on the same values: its bf16 form
            # rounds scores and state to bf16 where the kernel keeps f32
            ry, rf = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                                 chunk, init_state=init)
            torch.testing.assert_close(y.float(), ry, atol=tol, rtol=tol)
            torch.testing.assert_close(final, rf, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk,strided,with_init", [
    (2, 4096 // 8, 8, 64, 128, 128, True, False),   # mamba2's P, N; TMA
    (1, 500, 7, 64, 64, 128, True, True),           # zamba2's; ragged S
    (2, 200, 4, 64, 128, 64, True, True),           # cp.async: chunk 64
    (2, 100, 3, 32, 24, 40, False, True),           # chunk 40, N 24
    (1, 64, 2, 16, 8, 16, False, False)])           # chunk 16
def test_wgmma_forward_writes_the_chunk_states_on_card(
        cuda_device, B, S, H, P, N, chunk, strided, with_init):
    """The three wgmma passes (the rule's route at these shapes) against
    the three-pass plain version in f32 on the same values: y within
    5e-2, each chunk's start state (``with_states``) and the final state
    within 1e-3 of their magnitude's scale; y and the final state the
    same bits with and without the chunk states and from call to call;
    strided xBC slices read in place."""
    assert tkernel.fwd_route(P, N, chunk, torch.bfloat16) == "wgmma"
    xh, dt, A, Bm, Cm = (torch.as_tensor(a, device=cuda_device)
                         for a in _inputs(S + N, B, S, H, P, N))
    xh, Bm, Cm = (t.to(torch.bfloat16) for t in (xh, Bm, Cm))
    if strided:
        xbc = torch.cat([xh.reshape(B, S, H * P), Bm, Cm], -1)
        xh = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    init = torch.randn((B, H, P, N), device=cuda_device) * 0.5 \
        if with_init else None
    before = tkernel.ssd_scan_kernel.routes["wgmma"]
    y, final, states = tkernel.ssd_scan_kernel(
        xh, dt, A, Bm, Cm, chunk=chunk, init_state=init, with_states=True)
    y2, final2 = tkernel.ssd_scan_kernel(xh, dt, A, Bm, Cm, chunk=chunk,
                                         init_state=init)
    torch.cuda.synchronize()
    assert tkernel.ssd_scan_kernel.routes["wgmma"] == before + 2
    assert torch.equal(y, y2) and torch.equal(final, final2)
    ry, rf, rs = ssd_scan_passes_plain(xh.float(), dt, A, Bm.float(),
                                       Cm.float(), chunk, init_state=init)
    torch.testing.assert_close(y.float(), ry, atol=5e-2, rtol=5e-2)
    for got, want in ((final, rf), (states, rs)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= \
            1e-3 * max(float(want.abs().max()), 1)


def test_strided_inputs_give_their_contiguous_result():
    """x, B and C as the model slices them out of its fused xBC
    activation (token stride conv_dim, no copy) give the result of their
    contiguous copies; the kernel's binding reads those strides and
    raises on a layout it does not take."""
    B, S, H, P, N = 2, 40, 3, 8, 4
    xh, dt, A, Bm, Cm = _t(*_inputs(6, B, S, H, P, N))
    xbc = torch.cat([xh.reshape(B, S, H * P), Bm, Cm], dim=-1)
    xs = xbc[..., :H * P].reshape(B, S, H, P)
    bs, cs = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not (xs.is_contiguous() or bs.is_contiguous()
                or cs.is_contiguous())
    y, final = ssd_scan(xs, dt, A, bs, cs, chunk=16)
    y2, final2 = ssd_scan(xs.contiguous(), dt, A, bs.contiguous(),
                          cs.contiguous(), chunk=16)
    assert torch.equal(y, y2) and torch.equal(final, final2)
    cd = H * P + 2 * N
    assert tkernel.token_strides(xs, bs, cs) == (S * cd, cd) * 3
    with pytest.raises(ValueError, match="heads must be"):
        tkernel.token_strides(xh.transpose(2, 3).contiguous()
                              .transpose(2, 3), bs, cs)
    with pytest.raises(ValueError, match="Bm strides"):
        tkernel.token_strides(xs, torch.zeros((B, N, S)).transpose(1, 2),
                              cs)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [512, 500])
def test_bf16_tensor_core_kernel_at_the_serve_shape(cuda_device, S):
    """The bf16 tensor-core kernel at the zamba2-7b SSD shape (P = N = 64,
    chunk 128) with B = 2, H = 8 and a carried-in f32 state, ragged at
    S = 500: y and the final state within 5e-2 of the plain chunked
    version in f32 on the same values and of the sequential ssd_ref."""
    B, H, P, N, Q = 2, 8, 64, 64, 128
    xh, dt, A, Bm, Cm = (torch.as_tensor(a, device=cuda_device)
                         for a in _inputs(S, B, S, H, P, N))
    xh, Bm, Cm = (t.to(torch.bfloat16) for t in (xh, Bm, Cm))
    init = torch.as_tensor(np.random.default_rng(S).standard_normal(
        (B, H, P, N)).astype(np.float32) * 0.5, device=cuda_device)
    y, final = ssd_scan(xh, dt, A, Bm, Cm, chunk=Q, init_state=init)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32
    ry, rf = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(), Q,
                         init_state=init)
    torch.testing.assert_close(y.float(), ry, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(final, rf, atol=5e-2, rtol=5e-2)
    pad = (-S) % Q
    C = (S + pad) // Q

    def lay(t):
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.movedim(2, 1).reshape((B * H, C, Q) + t.shape[3:])
    dtk = lay(dt)
    bc = [t[:, :, None].expand(B, S, H, N).float() for t in (Bm, Cm)]
    sy, sf = ssd_ref(lay(xh.float()), dtk,
                     dtk * A.repeat(B)[:, None, None], lay(bc[0]),
                     lay(bc[1]), init_state=init.reshape(B * H, P, N))
    sy = sy.reshape(B, H, C * Q, P).movedim(1, 2)[:, :S]
    torch.testing.assert_close(y.float(), sy, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(final, sf.reshape(B, H, P, N), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.gpu
def test_f32_and_bf16_both_launch_and_read_strides(cuda_device):
    """The dtype alone picks the kernel (scalar f32, tensor-core bf16);
    the wrapper counts a launch of each.  Both read the model's strided
    slices of xBC in place and give what their contiguous copies give."""
    B, S, H, P, N, Q = 2, 200, 4, 32, 16, 64
    ins = [torch.as_tensor(a, device=cuda_device)
           for a in _inputs(7, B, S, H, P, N)]
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        xh, dt, A, Bm, Cm = ins
        xbc = torch.cat([xh.reshape(B, S, H * P), Bm, Cm], -1).to(dtype)
        xs = xbc[..., :H * P].reshape(B, S, H, P)
        bs, cs = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        before = ssd_scan.launches
        y, final = ssd_scan(xs, dt, A, bs, cs, chunk=Q)
        y2, final2 = ssd_scan(xs.contiguous(), dt, A, bs.contiguous(),
                              cs.contiguous(), chunk=Q)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 2
        assert torch.equal(y, y2) and torch.equal(final, final2)
        ry, rf = ssd_chunked(xs.float(), dt, A, bs.float(), cs.float(), Q)
        torch.testing.assert_close(y.float(), ry, atol=tol, rtol=tol)
        torch.testing.assert_close(final, rf, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_bf16_kernel_takes_any_shape(cuda_device):
    """Every bf16 shape the wrapper takes runs the tensor-core kernel: P
    above 64 (split over blocks), P, N or chunk not a multiple of 16 or of
    8 (zero padding, element loads), odd P (element stores), N up to 128
    (the wider register tile), with a carried-in state: y and the final
    state within 5e-2 of the plain chunked version in f32."""
    for B, S, H, P, N, chunk in [(1, 100, 2, 80, 16, 32),
                                 (1, 70, 3, 24, 20, 40),
                                 (2, 130, 2, 16, 96, 64),
                                 (1, 50, 2, 7, 128, 16)]:
        xh, dt, A, Bm, Cm = (torch.as_tensor(a, device=cuda_device)
                             for a in _inputs(8, B, S, H, P, N))
        xh, Bm, Cm = (t.to(torch.bfloat16) for t in (xh, Bm, Cm))
        init = torch.randn((B, H, P, N), device=cuda_device) * 0.5
        y, final = ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk, init_state=init)
        torch.cuda.synchronize()
        ry, rf = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                             chunk, init_state=init)
        torch.testing.assert_close(y.float(), ry, atol=5e-2, rtol=5e-2)
        torch.testing.assert_close(final, rf, atol=5e-2, rtol=5e-2)


def test_plain_scan_at_mamba2_state_size_matches_jax_ssd_ref(jx):
    """mamba2-370m's N = 128 (its P = 64; two heads, a chunk of 32, a
    ragged last chunk): the plain wrapper the CPU runs against the
    reference's sequential ``ssd_ref`` on the kernel layout."""
    B, S, H, P, N, chunk = 1, 72, 2, 64, 128, 32
    xh, dt, A, Bm, Cm = _inputs(11, B, S, H, P, N)
    pad = (-S) % chunk
    C = (S + pad) // chunk

    def lay(a, tail):      # [B,S,H,...] -> [B*H, C, Q, ...], zero-padded
        a = np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
        return np.moveaxis(a, 2, 1).reshape((B * H, C, chunk) + tail)

    dtk = lay(dt, ())
    bc = [np.repeat(np.pad(m, [(0, 0), (0, pad), (0, 0)])[:, None], H,
                    1).reshape(B * H, C, chunk, N) for m in (Bm, Cm)]
    want = np.asarray(jx.ref(*(jx.jnp.asarray(a) for a in (
        lay(xh, (P,)), dtk, dtk * np.tile(A, B)[:, None, None], *bc))))
    want = np.moveaxis(want.reshape(B, H, C * chunk, P), 1, 2)[:, :S]
    y, _ = ssd_scan(*_t(xh, dt, A, Bm, Cm), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)


def test_both_kernels_fit_shared_memory_at_every_served_ssm_shape():
    """For every arch with an SSM (zamba2-7b: P = N = 64; mamba2-370m:
    P = 64, N = 128) at its chunk, each kernel's block fits the card's
    232,448 bytes: the f32 kernel splits mamba2's P into slices of 16
    (216,640 bytes; 265,984 unsplit, 233,088 in slices of 32), zamba2's
    runs unsplit as before; the bf16 kernel takes both whole."""
    from repro_torch.configs.registry import ARCHS
    served = {c.name: (c.ssm_chunk, c.ssm_head_dim, c.ssm_state)
              for c in ARCHS.values() if c.ssm_state}
    assert served == {"zamba2-7b": (128, 64, 64),
                      "mamba2-370m": (128, 64, 128)}
    for Q, P, N in served.values():
        assert tkernel.f32_smem_bytes(Q, P, N) <= tkernel.SMEM_LIMIT
        assert tkernel.tc_smem_bytes(Q, P, N) <= tkernel.SMEM_LIMIT
        assert N <= tkernel.TC_MAX_STATE
    assert tkernel.f32_slice_p(128, 64, 64) == 64
    assert tkernel.f32_smem_bytes(128, 64, 64) == \
        tkernel.smem_bytes(128, 64, 64) == 184_064
    assert tkernel.f32_slice_p(128, 64, 128) == 16
    assert (tkernel.smem_bytes(128, 64, 128), tkernel.smem_bytes(
        128, 32, 128), tkernel.f32_smem_bytes(128, 64, 128)) == \
        (265_984, 233_088, 216_640)
    assert tkernel.tc_smem_bytes(128, 64, 128) == 165_392
    # a chunk whose scores alone overflow a block has no slice
    assert tkernel.f32_slice_p(256, 64, 64) == 0
    assert tkernel.f32_smem_bytes(256, 64, 64) > tkernel.SMEM_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("S", [512, 500])
def test_both_kernels_at_the_mamba2_shape(cuda_device, S):
    """mamba2-370m's scan (B = 2 of its 32 heads: H = 4, P = 64,
    N = 128, chunk 128, a carried-in state, ragged at S = 500): the bf16
    tensor-core kernel (``ssd_scan_tc<16>``) within 5e-2 and the f32
    kernel, its P split over four blocks, within 1e-4 of the plain
    chunked version in f32 on the same values."""
    B, H, P, N, Q = 2, 4, 64, 128, 128
    ins = [torch.as_tensor(a, device=cuda_device)
           for a in _inputs(S + 1, B, S, H, P, N)]
    init = torch.randn((B, H, P, N), device=cuda_device) * 0.5
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
        xh, dt, A, Bm, Cm = ins
        xh, Bm, Cm = (t.to(dtype) for t in (xh, Bm, Cm))
        y, final = ssd_scan(xh, dt, A, Bm, Cm, chunk=Q, init_state=init)
        torch.cuda.synchronize()
        ry, rf = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(), Q,
                             init_state=init)
        torch.testing.assert_close(y.float(), ry, atol=tol, rtol=tol)
        torch.testing.assert_close(final, rf, atol=tol, rtol=tol)


# --------------------------------------------------------------------- #
# the backward                                                           #
# --------------------------------------------------------------------- #
def _cotangents(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.standard_normal((B, H, P, N)).astype(np.float32),
            (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32))


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tiny_ssd_shape():
    from repro_torch.configs.registry import get_arch, tiny
    cfg = tiny(get_arch("mamba2-370m"))
    return (2, 64, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk)


BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


@pytest.mark.parametrize("shape,with_init", [
    ((2, 64, 3, 8, 16, 16), False),
    ((2, 50, 3, 8, 16, 16), False),          # pads to whole chunks
    ((2, 64, 3, 8, 16, 16), True),           # init_state and a d final
    (_tiny_ssd_shape(), False),              # mamba2-370m's tiny() SSD
], ids=["plain", "ragged", "init_state", "mamba2_tiny"])
def test_plain_backward_matches_jax_vjp(jx, shape, with_init):
    """``ssd_scan_bwd_plain`` against ``jax.vjp`` of the reference's
    ``models/mamba2.py:ssd_chunked`` (what the reference's training
    differentiates) in f32: every gradient within 1e-5 of its max."""
    B, S, H, P, N, Q = shape
    ins = _inputs(21, B, S, H, P, N)
    dy, dfinal, init = _cotangents(22, B, S, H, P, N)
    j = [jx.jnp.asarray(a) for a in ins]
    if with_init:
        _, vjp = jx.jax.vjp(lambda *a: jx.chunked(*a[:5], Q,
                                                  init_state=a[5]),
                            *j, jx.jnp.asarray(init))
        want = vjp((jx.jnp.asarray(dy), jx.jnp.asarray(dfinal)))
    else:
        (_, jfinal), vjp = jx.jax.vjp(lambda *a: jx.chunked(*a, Q), *j)
        want = vjp((jx.jnp.asarray(dy), jx.jnp.zeros_like(jfinal)))
    got = ssd_scan_bwd_plain(
        *_t(*ins), torch.as_tensor(dy), chunk=Q,
        init_state=torch.as_tensor(init) if with_init else None,
        dfinal=torch.as_tensor(dfinal) if with_init else None)
    assert (got[5] is None) == (not with_init)
    for name, a, w in zip(BWD_NAMES, got, want):
        assert a.shape == w.shape, name
        assert _scaled_err(a.numpy(), w) <= 1e-5, name


@pytest.mark.parametrize("shape,with_dfinal", [
    ((2, 64, 3, 8, 16, 16), False),
    ((2, 50, 3, 8, 16, 16), False),          # pads to whole chunks
    ((2, 64, 3, 8, 16, 16), True),           # a d final
    (_tiny_ssd_shape(), True),               # mamba2-370m's tiny() SSD
], ids=["plain", "ragged", "dfinal", "mamba2_tiny"])
def test_state_split_matches_plain_backward_and_jax_vjp(jx, shape,
                                                        with_dfinal):
    """The bf16 backward's split of the state pass (every chunk's own
    Delta at once, then the reverse scan; ``ssd_bwd_states_plain``) in
    f64: the gradient of each chunk's end state equals the d init_state
    of ``ssd_scan_bwd_plain`` run on the chunks after it from the state
    the forward carries into them, its d init_state equals
    ``ssd_scan_bwd_plain``'s (1e-10 of its max), and equals ``jax.vjp``
    of the reference's ``ssd_chunked`` with respect to init_state (f32:
    1e-5 of its max)."""
    B, S, H, P, N, Q = shape
    f64 = torch.float64
    ins = _inputs(31, B, S, H, P, N)
    dy, dfinal, init = _cotangents(32, B, S, H, P, N)
    xh, dt, A, Bm, Cm = (t.to(f64) for t in _t(*ins))
    dy_, init_ = (t.to(f64) for t in _t(dy, init))
    dfinal_ = torch.as_tensor(dfinal).to(f64) if with_dfinal else None
    delta, dS, dinit = ssd_bwd_states_plain(dt, A, Cm, dy_, chunk=Q,
                                            dfinal=dfinal_)
    nC = -(-S // Q)
    assert delta.shape == dS.shape == (B, nC, H, P, N)
    want = ssd_scan_bwd_plain(xh, dt, A, Bm, Cm, dy_, chunk=Q,
                              init_state=init_, dfinal=dfinal_)[5]
    assert _scaled_err(dinit, want) <= 1e-10
    for c in range(nC - 1):           # the chunks after c, from its state
        t = (c + 1) * Q
        _, carry = ssd_chunked(xh[:, :t], dt[:, :t], A, Bm[:, :t],
                               Cm[:, :t], Q, init_state=init_)
        tail = ssd_scan_bwd_plain(
            xh[:, t:], dt[:, t:], A, Bm[:, t:], Cm[:, t:], dy_[:, t:],
            chunk=Q, init_state=carry, dfinal=dfinal_)[5]
        assert _scaled_err(dS[:, c], tail) <= 1e-10, c
    last = torch.zeros_like(init_) if dfinal_ is None else dfinal_
    assert torch.equal(dS[:, -1], last)
    j = [jx.jnp.asarray(a) for a in ins]
    _, vjp = jx.jax.vjp(lambda i: jx.chunked(*j, Q, init_state=i),
                        jx.jnp.asarray(init))
    jd = vjp((jx.jnp.asarray(dy), jx.jnp.asarray(dfinal) if with_dfinal
              else jx.jnp.zeros_like(jx.jnp.asarray(init))))[0]
    assert _scaled_err(dinit.numpy(), jd) <= 1e-5


def test_chunked_gradient_stays_finite_where_the_masked_exp_overflows(jx):
    """Where cum falls by more than 88 within a chunk (large dt), the
    reference's ``where(mask, exp(diff), 0)`` overflows above the
    diagonal and ``jax.vjp`` of its ``ssd_chunked`` is NaN there; the
    port masks before the exponential: the same y, and a finite gradient
    equal to ``ssd_scan_bwd_plain``'s within 1e-4 of each max (the f32
    tolerance: dA is a sum that cancels to 1e-2 here)."""
    B, S, H, P, N, Q = 1, 32, 2, 4, 4, 16
    xh, dt, A, Bm, Cm = _inputs(29, B, S, H, P, N)
    dt = dt + 8.0                     # cum falls by over 128 a chunk
    dy = _cotangents(30, B, S, H, P, N)[0]
    j = [jx.jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)]
    (jy, jfinal), vjp = jx.jax.vjp(lambda *a: jx.chunked(*a, Q), *j)
    jg = vjp((jx.jnp.asarray(dy), jx.jnp.zeros_like(jfinal)))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)
    leaves = [t.requires_grad_(True) for t in _t(xh, dt, A, Bm, Cm)]
    y, _ = ssd_chunked(*leaves, Q)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-4, rtol=1e-4)
    got = torch.autograd.grad(y, leaves, torch.as_tensor(dy))
    want = ssd_scan_bwd_plain(*_t(xh, dt, A, Bm, Cm), torch.as_tensor(dy),
                              chunk=Q)
    for name, a, w in zip(BWD_NAMES, got, want):
        assert torch.isfinite(a).all(), name
        assert _scaled_err(a, w) <= 1e-4, name


def test_plain_backward_matches_autograd_through_the_recurrence():
    """``ssd_scan_bwd_plain`` against autograd through the sequential
    ``ssd_ref`` in f64 (a ragged last chunk, an init_state and a d
    final): the chunked algorithm's gradient is the recurrence's."""
    B, S, H, P, N, Q = 2, 40, 2, 8, 4, 16
    f64 = torch.float64
    xh, dt, A, Bm, Cm = (t.to(f64) for t in _t(*_inputs(23, B, S, H, P,
                                                        N)))
    dy, dfinal, init = (t.to(f64) for t in _t(*_cotangents(24, B, S, H,
                                                            P, N)))
    leaves = [t.clone().requires_grad_(True)
              for t in (xh, dt, A, Bm, Cm, init)]
    x_, dt_, A_, B_, C_, i_ = leaves
    pad = (-S) % Q

    def lay(t):                # [B,S,H,...] -> [B*H, C, Q, ...]
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.movedim(2, 1).reshape((B * H, -1, Q) + t.shape[3:])
    bc = [m[:, :, None].expand(B, S, H, N) for m in (B_, C_)]
    dtk = lay(dt_)
    y, final = ssd_ref(lay(x_), dtk, dtk * A_.repeat(B)[:, None, None],
                       lay(bc[0]), lay(bc[1]), init_state=i_.reshape(
                           B * H, P, N))
    y = y.reshape(B, H, -1, P).movedim(1, 2)[:, :S]
    want = torch.autograd.grad((y, final.reshape(B, H, P, N)), leaves,
                               (dy, dfinal))
    got = ssd_scan_bwd_plain(xh, dt, A, Bm, Cm, dy, chunk=Q,
                             init_state=init, dfinal=dfinal)
    assert all(g.dtype == f64 for g in got)
    for name, a, w in zip(BWD_NAMES, got, want):
        assert _scaled_err(a, w) <= 1e-10, name


@pytest.mark.parametrize("with_init", [False, True])
def test_autograd_function_gradchecks_on_the_host(with_init):
    """``SsdScanFn`` with the plain pieces in place of the kernels (its
    CPU path): the wiring around the backward -- the saved inputs, a None
    init_state (no gradient), a cotangent on the final state or none,
    the dtypes handed back -- under ``torch.autograd.gradcheck`` in
    f64."""
    B, S, H, P, N, Q = 1, 10, 2, 3, 4, 4
    f64 = torch.float64
    ins = [t.to(f64).requires_grad_(True)
           for t in _t(*_inputs(25, B, S, H, P, N))]
    if with_init:
        init = torch.as_tensor(_cotangents(26, B, S, H, P, N)[2]).to(
            f64).requires_grad_(True)
        assert torch.autograd.gradcheck(
            lambda *a: SsdScanFn.apply(*a, Q), (*ins, init))
    else:
        assert torch.autograd.gradcheck(
            lambda *a: SsdScanFn.apply(*a, None, Q), ins)
        # the final state unused: its cotangent never arrives
        assert torch.autograd.gradcheck(
            lambda *a: SsdScanFn.apply(*a, None, Q)[0], ins)


def test_backward_fits_shared_memory_at_every_trained_ssm_shape():
    """Each backward pass's block fits the card's 232,448 bytes at every
    SSM arch's chunk, full and ``tiny()``, in both dtypes: the f32 carry
    pass holds mamba2's whole P (133,888 bytes), the f32 chunk pass two
    [Q][Q + 1] tiles (136,736); the bf16 passes hold a chunk of up to 128
    rows, P = 64 and N = 128 whole: the delta pass dy and C (52,224 bytes
    at mamba2's N = 128, 35,840 at zamba2's 64), the chunk pass B, C, G's
    triangle in f32, and stages of x, dy and S_prev and dS in high and
    low parts (231,616 bytes: one stage at N = 128, two at 64).  The
    chunk pass sums dB and dC over 8 heads a block at mamba2-370m's
    training shape and 7 at zamba2-7b's, so its f32 scratch for each of
    them shrinks by that factor from the [B, S, H, N] one a head: 16.8 MB
    instead of 134.2 at mamba2-370m's [2, 4096, 32, 128], 16.8 instead of
    117.4 at zamba2-7b's [1, 4096, 112, 64]."""
    from repro_torch.configs.registry import ARCHS, tiny
    shapes = {(c.ssm_chunk, c.ssm_head_dim, c.ssm_state)
              for c in ARCHS.values() if c.ssm_state}
    shapes |= {(t.ssm_chunk, t.ssm_head_dim, t.ssm_state)
               for t in (tiny(c) for c in ARCHS.values() if c.ssm_state)}
    assert shapes == {(128, 64, 64), (128, 64, 128), (16, 16, 16)}
    for Q, P, N in shapes:
        assert tkernel.carry_slice_p(Q, P, N) == P
        assert P <= tkernel.TC_BWD_MAX_P and N <= tkernel.TC_MAX_STATE
        assert Q <= tkernel.TC_BWD_MAX_Q
        for dtype in (torch.float32, torch.bfloat16):
            assert max(tkernel.bwd_smem_bytes(Q, P, N, dtype)) <= \
                tkernel.SMEM_LIMIT
    assert tkernel.bwd_smem_bytes(128, 64, 128) == (133_888, 136_736)
    assert tkernel.bwd_smem_bytes(128, 64, 128, torch.bfloat16) == \
        (52_224, 231_616)
    assert tkernel.bwd_smem_bytes(128, 64, 64, torch.bfloat16) == \
        (35_840, 231_616)
    for (B, S, H, N), group, mb in (
            ((2, 4096, 32, 128), 8, (134.2, 16.8)),
            ((1, 4096, 112, 64), 7, (117.4, 16.8))):
        assert tkernel.bwd_heads_per_block(B, -(-S // 128), H) == group
        assert (round(B * S * H * N * 4 / 1e6, 1),
                round(B * S * (H // group) * N * 4 / 1e6, 1)) == mb
    # a chunk whose two f32 tiles overflow a block does not fit
    assert tkernel.chunk_smem_bytes(256) > tkernel.SMEM_LIMIT


def test_cpu_gradient_goes_through_the_plain_version():
    """On the CPU ``ssd_scan`` under a gradient is autograd through the
    plain chunked version, which ``ssd_scan_bwd`` reproduces; nothing is
    launched or counted."""
    B, S, H, P, N, Q = 2, 40, 2, 8, 4, 16
    ins = [t.requires_grad_(True) for t in _t(*_inputs(27, B, S, H, P, N))]
    dy = torch.as_tensor(_cotangents(28, B, S, H, P, N)[0])
    before = (ssd_scan.launches, ssd_scan_bwd.launches)
    y, _ = ssd_scan(*ins, chunk=Q)
    want = torch.autograd.grad(y, ins, dy)
    got = ssd_scan_bwd(*(t.detach() for t in ins), dy, chunk=Q)
    assert got[5] is None
    for name, a, w in zip(BWD_NAMES, got, want):
        assert _scaled_err(a, w) <= 1e-5, name
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == before
    with pytest.raises(ValueError, match="one device"):
        ssd_scan_bwd(*(t.detach() for t in ins), dy.to("meta"), chunk=Q)


# the card's backward checks: (B, S, H, P, N, chunk, with init_state);
# the last four are shapes no model has: P and N padded to 16 with element
# loads (N = 20), N = 96 in the wider register tile, odd P (element
# stores), one partial chunk
CARD_BWD_SHAPES = {
    "mamba2_train": (2, 4096, 32, 64, 128, 128, False),
    "zamba2_train": (1, 4096, 112, 64, 64, 128, False),
    "ragged_init": (2, 300, 4, 64, 64, 128, True),
    "p24_n20": (1, 70, 3, 24, 20, 40, True),
    "n96": (2, 130, 2, 16, 96, 64, False),
    "p7_n128": (1, 50, 2, 7, 128, 16, True),
    "one_partial_chunk": (1, 33, 4, 64, 64, 128, True),
}
CARD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("key", sorted(CARD_BWD_SHAPES))
def test_backward_kernel_matches_plain_backward_on_card(cuda_device, key,
                                                         dtype):
    """The backward kernels through ``ssd_scan``'s autograd Function at
    mamba2-370m's and zamba2-7b's training shapes (a microbatch of
    train_4k), a ragged S with an init_state and a cotangent on the final
    state, and odd shapes the bf16 passes pad, on x, B and C sliced out of
    one fused xBC leaf (the model's strides): every gradient within
    ``CARD_BWD_TOL`` of its max against ``ssd_scan_bwd_plain`` in f32 on
    the same values, two calls the same bits (no atomics), one forward
    and one backward counted a call."""
    B, S, H, P, N, Q, with_init = CARD_BWD_SHAPES[key]
    g = torch.Generator(device=cuda_device).manual_seed(S + H)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)
    xbc = torch.cat([rnd(B, S, H * P), rnd(B, S, N) * 0.5,
                     rnd(B, S, N) * 0.5], -1).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    A = -torch.exp(rnd(H) * 0.3)
    dy = rnd(B, S, H, P).to(dtype)
    init, dfinal = rnd(B, H, P, N) * 0.5, rnd(B, H, P, N)
    leaves = [t.clone().requires_grad_(True) for t in
              (xbc, dt, A) + ((init,) if with_init else ())]

    def split(t):
        return (t[..., :H * P].reshape(B, S, H, P), t[..., H * P:H * P + N],
                t[..., H * P + N:])

    def grads():
        xs, bs, cs = split(leaves[0])
        y, final = ssd_scan(xs, leaves[1], leaves[2], bs, cs, chunk=Q,
                            init_state=leaves[3] if with_init else None)
        outs = ((y, final), (dy, dfinal)) if with_init else ((y,), (dy,))
        return torch.autograd.grad(outs[0], leaves, outs[1])
    before = (ssd_scan.launches, ssd_scan_bwd.launches)
    got, again = grads(), grads()
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    xs, bs, cs = split(xbc.float())
    dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd_plain(
        xs, dt, A, bs, cs, dy.float(), chunk=Q,
        init_state=init if with_init else None,
        dfinal=dfinal if with_init else None)
    want = [torch.cat([dx.reshape(B, S, H * P), dB, dC], -1), ddt, dA] + \
        ([dinit] if with_init else [])
    for name, a, w in zip(("dxBC", "ddt", "dA", "dinit"), got, want):
        assert a.dtype == leaves[("dxBC", "ddt", "dA", "dinit").index(
            name)].dtype
        err = float((a.float() - w).abs().max() / w.abs().max())
        assert err <= CARD_BWD_TOL[dtype], (name, err)
