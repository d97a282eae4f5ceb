"""The port's GPipe schedule (``repro_torch.training.pipeline``) against the
JAX package on the CPU, at the reference test's size (S = 4 stages of
Lps = 2 blocks, D = 16, F = 32):

  * ``gpipe_forward`` on the reference's ``init_pipeline_params``
    (converted by ``pipeline_params_from_numpy``) against the reference's
    sequential ``mlp_block`` stack in JAX, at 1e-5, with fewer and with
    more microbatches than stages (the reference's 4-device ``shard_map``
    run is a slow test of its own);
  * the schedule's tick count, M + S - 1;
  * the pipelined output against the port's sequential stack;
  * ``make_gpipe_fn`` raises without a card unless asked for the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.pipeline import init_pipeline_params as jinit
from repro.training.pipeline import mlp_block as jmlp_block
from repro_torch.models.convert import pipeline_params_from_numpy
from repro_torch.training import pipeline as P

S, LPS, D, F = 4, 2, 16, 32
TOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    """The reference's parameters and its sequential stack as a function
    of the input."""
    params = jinit(jax.random.PRNGKey(0), n_stages=S, layers_per_stage=LPS,
                   d_model=D, d_ff=F)
    flat = jax.tree.map(lambda a: a.reshape((S * LPS,) + a.shape[2:]),
                        params)

    @jax.jit
    def stack(x):
        y, _ = jax.lax.scan(lambda h, lp: (jmlp_block(lp, h), None), x,
                            flat)
        return y
    return jax.tree.map(np.asarray, params), stack


def _x(M, B=2, T=8, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (M, B, T, D)).astype(np.float32)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("M", [2, 6])        # fewer and more than S
def test_gpipe_matches_the_reference_sequential_stack(reference, M):
    params, stack = reference
    x = _x(M)
    want = np.asarray(stack(jnp.asarray(x.reshape(-1, *x.shape[2:])))
                      ).reshape(x.shape)
    got = P.gpipe_forward(pipeline_params_from_numpy(params, "cpu"),
                          torch.from_numpy(x), n_stages=S)
    assert got.shape == x.shape
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("M", [1, 3, 8])
def test_the_schedule_takes_m_plus_s_minus_1_ticks(monkeypatch, M):
    """Every tick applies each stage's Lps blocks once (all stages
    batched): M + S - 1 ticks, the S - 1 that fill the pipe included."""
    calls = []
    block = P.mlp_block

    def counted(p, x):
        calls.append(x.shape[0])
        return block(p, x)
    monkeypatch.setattr(P, "mlp_block", counted)
    params = P.init_pipeline_params(torch.Generator().manual_seed(0),
                                    n_stages=S, layers_per_stage=LPS,
                                    d_model=D, d_ff=F)
    out = P.gpipe_forward(params, torch.from_numpy(_x(M)), n_stages=S)
    assert out.shape[0] == M
    assert P.gpipe_ticks(M, S) == M + S - 1
    assert calls == [S] * (P.gpipe_ticks(M, S) * LPS)


def test_pipelined_equals_the_port_s_sequential_stack():
    gen = torch.Generator().manual_seed(3)
    params = P.init_pipeline_params(gen, n_stages=S, layers_per_stage=LPS,
                                    d_model=D, d_ff=F)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "w1": (S, LPS, D, F), "w2": (S, LPS, D, F), "w3": (S, LPS, F, D)}
    x = torch.from_numpy(_x(5, seed=4))
    fn = P.make_gpipe_fn(S, device="cpu")
    got = fn(params, x)
    want = P.sequential_forward(params, x.reshape(-1, *x.shape[2:])
                                ).reshape(x.shape)
    assert _rel(got.numpy(), want.numpy()) <= TOL
    with pytest.raises(ValueError, match="stages"):
        P.gpipe_forward(params, x, n_stages=S + 1)


def test_make_gpipe_fn_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.make_gpipe_fn(S)
