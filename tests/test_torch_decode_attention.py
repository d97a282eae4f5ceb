"""The port's decode attention: the plain version against the model's
``attention_scores`` over the whole cache under the full-length mask (the
decode step's attention before the kernel), the wrapper's paths and
counters, and its meta branch on the CPU; the Hopper kernels against the
plain version on the card (``gpu``-marked: skipped without a card).

The file imports no JAX, so the card's test run (``-m gpu``) can import
it.  On the CPU the plain version attends over the filled slice of the
cache, the full-length attention over every slot with the rest masked:
masked slots add exact zeros, so the two agree up to the order of f32
sums (``TOL``).  On the card the kernels round the scores and weights to
the q dtype as the plain version does, with their sums in another order:
in bf16 each output within 2**-6 of the largest |output| of its (row,
head), about two bf16 steps at the outputs' scale, and never beyond
``2e-2 + 2e-2 |want|`` (:func:`assert_card_close`); 1e-5 in f32.
"""
import copy
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch, tiny
from repro_torch.kernels import work as W
from repro_torch.kernels.decode_attention import kernel as dkernel
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_plain, row_range, work)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import attention_scores
from repro_torch.models.model import Model
from repro_torch.obs.metrics import get_registry

TOL = {torch.float32: dict(atol=1e-6, rtol=1e-6),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
S_MAX = 300
SPLIT = dkernel.SPLIT


def _inputs(seed, B, H, K, d, S, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, K, d)).astype(np.float32)
    v = rng.standard_normal((B, S, K, d)).astype(np.float32)
    return [torch.as_tensor(a).to(dtype).to(device) for a in (q, k, v)]


def full_length(q, k, v, positions, window=0):
    """The decode step's attention before the kernel: every cache slot,
    those past each row's position (and before its window) masked."""
    kpos = torch.arange(k.shape[1])
    pos = positions.reshape(-1, 1).long().cpu()
    m = kpos[None, :] <= pos
    if window > 0:
        m = m & (kpos[None, :] > pos - window)
    return attention_scores(q, k, v, m.to(q.device)[:, None, None, :])


# filled lengths: one slot, a split's edge on each side, the whole cache
FILLED = [1, SPLIT, SPLIT + 1, S_MAX]


@pytest.mark.parametrize("filled", FILLED)
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("d", [32, 64, 112, 128])
@pytest.mark.parametrize("G", [1, 2, 6, 7])
def test_plain_matches_full_length_attention(G, d, window, filled):
    K = 2
    q, k, v = _inputs(G * 1000 + d, 2, G * K, K, d, S_MAX)
    pos = torch.full((2, 1), filled - 1, dtype=torch.int32)
    got = decode_attention_plain(q, k, v, pos, window)
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got, full_length(q, k, v, pos, window),
                               **TOL[torch.float32])


@pytest.mark.parametrize("window", [0, 48])
def test_plain_takes_each_rows_own_position_in_bf16(window):
    """Rows at different positions (a vision prefix moves them), bf16:
    each row as the full-length attention of that row alone."""
    q, k, v = _inputs(7, 3, 14, 2, 112, S_MAX, torch.bfloat16)
    pos = torch.tensor([[0], [SPLIT + 3], [S_MAX - 1]], dtype=torch.int32)
    got = decode_attention_plain(q, k, v, pos, window)
    for b in range(3):
        want = full_length(q[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1],
                           window)
        torch.testing.assert_close(got[b:b + 1].float(), want.float(),
                                   **TOL[torch.bfloat16])


def test_row_range_and_scratch_layout():
    assert row_range(0, 300) == (0, 1)
    assert row_range(299, 300) == (0, 300)
    assert row_range(500, 300) == (0, 300)         # clipped to the cache
    assert row_range(100, 300, window=16) == (85, 101)
    assert row_range(3, 300, window=16) == (0, 4)
    assert dkernel.n_splits(4109) == 33 and dkernel.n_splits(128) == 1
    stats, partial, n = dkernel.scratch_layout(3, 301, 5, 64)
    assert stats % 4 == 0 and partial % 4 == 0
    assert stats >= 3 * 5 * 301 and partial - stats >= 3 * 5 * 3 * 2
    assert n - partial == 3 * 5 * 3 * 64


def _calls(path):
    return get_registry().counter("decode_attention_calls_total",
                                  path=path).value


def test_cpu_decode_step_counts_the_plain_path():
    """A CPU decode step of tiny qwen3-1.7b calls the wrapper once a
    layer on the plain path; it launches nothing and leaves the flash
    kernel's shape count alone (the prefill's are its own)."""
    cfg = tiny(get_arch("qwen3-1.7b"))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 9)))
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks[:, :8]}, 16)
        shapes = dict(flash_attention.shapes)
        plain, kernel = _calls("plain"), _calls("kernel")
        launches = decode_attention.launches
        model.decode_step(params, toks[:, 8], caches, 8)
    assert _calls("plain") - plain == cfg.n_layers
    assert _calls("kernel") == kernel
    assert decode_attention.launches == launches
    assert dict(flash_attention.shapes) == shapes


@pytest.mark.parametrize("window", [0, 24])
def test_meta_branch_adds_the_work_at_the_last_slot(window):
    B, H, K, d, S = 3, 16, 8, 128, 100
    q = torch.empty((B, 1, H, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, S, K, d), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((B, 1), dtype=torch.int32, device="meta")
    with W.recording(W.Tally()) as t:
        out = decode_attention(q, k, k, pos, window)
    assert out.device.type == "meta" and out.shape == q.shape
    w = work(B, H, K, d, window or S)
    assert t.by_kernel["decode_attention"] == {"calls": 1, **w}
    assert w["bytes"] == (2 * B * H * d + 2 * B * (window or S) * K * d) * 2


def test_kernel_binding_takes_cuda_tensors_only():
    q, k, v = _inputs(0, 1, 2, 1, 32, 8)
    with pytest.raises(ValueError, match="CUDA"):
        dkernel.decode_attention_kernel(q, k, v,
                                        torch.zeros(1, dtype=torch.int32))


# --------------------------------------------------------------------- #
# on the card                                                            #
# --------------------------------------------------------------------- #
def assert_card_close(got, want):
    """The kernel's output against the plain version's: 1e-5 in f32; in
    bf16 each element within 2**-6 of the largest |want| of its (row,
    head) and within ``2e-2 + 2e-2 |want|``."""
    got, want, dtype = got.float(), want.float(), got.dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        return
    err = (got - want).abs()
    lim = torch.minimum(2.0 ** -6 * want.abs().amax(-1, keepdim=True),
                        2e-2 + 2e-2 * want.abs())
    assert torch.isfinite(got).all()
    assert bool((err <= lim).all()), \
        f"max abs error {float(err.max())}, {float((err / lim).max())} " \
        f"of the limit"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (G, d, window, positions of the rows): every group size of the served
# archs, every head dim, windows shorter and longer than the filled part,
# a split's edges, a row at the last slot and rows at different positions
CARD_CASES = [(1, 32, 0, [0, 5]), (2, 64, 0, [SPLIT - 1, SPLIT]),
              (2, 128, 0, [S_MAX - 1, 200]), (6, 128, 48, [S_MAX - 1, 20]),
              (7, 128, 0, [SPLIT, 2 * SPLIT + 3]), (7, 112, 16, [150, 151]),
              (8, 64, 200, [S_MAX - 1, S_MAX - 1]), (3, 112, 0, [7, 260])]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("G,d,window,positions", CARD_CASES)
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, G, d,
                                              window, positions):
    K = 2
    q, k, v = _inputs(G + d, len(positions), G * K, K, d, S_MAX, dtype,
                      cuda_device)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda_device)
    got = dkernel.decode_attention_kernel(q, k, v, pos, window)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, pos, window)
    assert got.dtype == dtype and got.shape == q.shape
    assert_card_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernel_reads_and_writes_only_the_filled_splits(cuda_device,
                                                        dtype):
    """Cache slots outside each row's [lo, hi) hold NaN, and so does the
    scratch before the launch: the output is finite and the same bits as
    on the clean cache; two launches give the same bits; the scores and
    partial sums of splits no row position reaches are still NaN."""
    B, G, K, d, S, window = 3, 2, 8, 128, 4109, 0
    H = G * K
    q, k, v = _inputs(3, B, H, K, d, S, dtype, cuda_device)
    positions = [512, 4096, 2 * SPLIT - 1]
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda_device)
    clean = dkernel.decode_attention_kernel(q, k, v, pos, window)
    again = dkernel.decode_attention_kernel(q, k, v, pos, window)
    kp, vp = k.clone(), v.clone()
    for b, p in enumerate(positions):
        kp[b, p + 1:] = float("nan")
        vp[b, p + 1:] = float("nan")
    o_stats, o_partial, n = dkernel.scratch_layout(B, S, H, d)
    scratch = torch.full((n,), float("nan"), device=cuda_device)
    got = dkernel._launch(q, kp, vp, pos, window, scratch)
    torch.cuda.synchronize()
    assert torch.equal(clean, again)
    assert torch.isfinite(got.float()).all() and torch.equal(got, clean)
    ns = dkernel.n_splits(S)
    scores = scratch[:B * H * S].view(B, H, S)
    partial = scratch[o_partial:].view(B, H, ns, d)
    for b, p in enumerate(positions):
        assert torch.isfinite(scores[b, :, :p + 1]).all()
        assert torch.isnan(scores[b, :, p + 1:]).all()
        live = p // SPLIT + 1
        assert torch.isfinite(partial[b, :, :live]).all()
        assert torch.isnan(partial[b, :, live:]).all()


@pytest.mark.gpu
def test_wrapper_counts_kernel_calls_on_card(cuda_device):
    q, k, v = _inputs(4, 2, 16, 8, 128, 4109, torch.bfloat16, cuda_device)
    pos = torch.full((2, 1), 600, dtype=torch.int32, device=cuda_device)
    kernel, plain = _calls("kernel"), _calls("plain")
    launches, shapes = decode_attention.launches, dict(flash_attention.shapes)
    out = decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert (_calls("kernel") - kernel, _calls("plain") - plain) == (1, 0)
    assert decode_attention.launches == launches + 1
    assert decode_attention.shapes[(2, 16, 8, 128, 4109, 0)] >= 1
    assert dict(flash_attention.shapes) == shapes
    assert_card_close(out, decode_attention_plain(q, k, v, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-27b"])
def test_decode_step_on_card_matches_the_cpu(cuda_device, arch):
    """A tiny f32 model's decode step on the card, through the kernel and
    the stacked cache's layer views, against the same step on the CPU
    (gemma3's local layers at window 16, positions past it)."""
    cfg = tiny(get_arch(arch))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 38)))
    outs = []
    for dev in ("cpu", cuda_device):
        p = copy.deepcopy(params).to(dev)
        with torch.no_grad():
            _, c = model.prefill(p, {"tokens": toks[:, :37].to(dev)}, 48)
            logits, _ = model.decode_step(p, toks[:, 37].to(dev), c, 37)
        outs.append(logits.cpu())
    torch.testing.assert_close(outs[1], outs[0], atol=1e-4, rtol=1e-4)
    assert math.isfinite(float(outs[1].abs().max()))
