"""The port's training (``repro_torch.data``, ``repro_torch.training``,
``Model.loss``, ``repro_torch.launch.train``) against the JAX package on
the CPU, all at ``tiny()`` sizes:

  * ``TokenPipeline``'s batches equal the reference's, snapshot and
    restore included;
  * AdamW and Adafactor, one and several steps, on the same converted
    parameters, gradients and state: f32, ``rtol`` 1e-6 (the same f32
    arithmetic; an ulp of the scalar ``pow`` may differ), and AdamW's
    closed form; arctic-480b's bf16 moments and bf16 microbatch
    accumulator (its ``opt_dtype``) to one bf16 ulp, bit for bit where
    the gradient clip does not act;
  * ``Model.loss`` and every parameter's gradient against
    ``jax.value_and_grad(model.loss)`` for one arch per family plus
    gemma3-27b (its window): the loss at 1e-5, each gradient within
    ``GRAD_TOL * max|ref|`` (f32, attention and the scans summed in other
    orders; measured at most 1.2e-5);
  * ``make_train_step`` with two microbatches against the reference's
    scan accumulation;
  * the port's ``run_training`` through a crash between steps, after the
    shards and before the manifest's publish, resumed bit for bit; the
    loss decreasing; stragglers; the CLI with ``--device cpu``.

The card's side (the flash backward kernels, deterministic steps) is
``chip_smoke.py``'s ``train`` phase and the ``gpu`` tests of
``tests/test_torch_flash_attention.py``.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import get_arch as jget_arch
from repro.configs.registry import tiny as jtiny
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models.model import build_model
from repro.training import optimizer as JO
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.configs import registry as TR
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.train import run_training
from repro_torch.models.convert import (grads_from_numpy,
                                        opt_state_from_numpy,
                                        params_from_numpy)
from repro_torch.models.model import Model
from repro_torch.training import optimizer as TO
from repro_torch.training.train_loop import (make_train_step,
                                             shape_batch_for_accum)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny models run fastest on one intra-op thread, and the
    suite's parallel workers share the cores: with 8 threads a worker's
    training steps wait on threads that other workers hold (12 tiny steps
    took 119 s against 9.7 s on one thread beside five busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4
OPT_TOL = dict(atol=1e-7, rtol=1e-6)
B, S = 2, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed, B=B, S=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S + 1))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vis"] = rng.standard_normal(
            (B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _env(arch, seed=0, **overrides):
    jcfg = dataclasses.replace(jtiny(jget_arch(arch)), **overrides)
    cfg = dataclasses.replace(TR.tiny(TR.get_arch(arch)), **overrides)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(_np(jp), cfg, "cpu", trainable=True)
    return jcfg, cfg, jm, jp, Model(cfg), tp


def _assert_grads_close(got: dict, want: dict, tol=GRAD_TOL):
    assert set(got) == set(want)
    for n, g in got.items():
        w = want[n]
        assert g.shape == w.shape, n
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol * max(scale, 1e-30), (n, err, scale)


# --------------------------------------------------------------------- #
# the data pipeline                                                      #
# --------------------------------------------------------------------- #
def test_shapes_are_the_reference_s():
    from repro.configs.base import SHAPES as JSHAPES
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch,microbatches", [
    ("qwen3-1.7b", 1), ("qwen3-1.7b", 2), ("whisper-medium", 2),
    ("internvl2-26b", 1)])
def test_pipeline_batches_equal_the_reference_s(arch, microbatches):
    """Every batch of the port's pipeline equals the reference's, bit for
    bit (tokens, and frames or vision patches), shaped [M, B/M, ...] for
    two microbatches; a restored snapshot continues the same stream, and
    different cursors differ."""
    jcfg, cfg = jtiny(jget_arch(arch)), TR.tiny(TR.get_arch(arch))
    shape = ShapeConfig("t", 16, 4, "train")
    jshape = JShape("t", 16, 4, "train")
    mine = TokenPipeline(cfg, shape, seed=5, microbatches=microbatches)
    ref = JPipeline(jcfg, jshape, seed=5, microbatches=microbatches)
    first = []
    for _ in range(4):
        got, want = mine.next_batch(), ref.next_batch()
        assert set(got) == set(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        first.append(got)
    assert got["tokens"].shape == ((microbatches, 4 // microbatches, 17)
                                   if microbatches > 1 else (4, 17))
    snap = mine.snapshot()
    assert snap == ref.snapshot()
    more = [mine.next_batch() for _ in range(2)]
    again = TokenPipeline(cfg, shape, seed=5, microbatches=microbatches)
    again.restore(snap)
    for want in more:
        np.testing.assert_array_equal(again.next_batch()["tokens"],
                                      want["tokens"])
    assert not np.array_equal(first[0]["tokens"], first[1]["tokens"])


# --------------------------------------------------------------------- #
# the optimizers                                                         #
# --------------------------------------------------------------------- #
def _opt_grads(jp, seed, n):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape))
                         .astype(np.float32), _np(jp)) for _ in range(n)]


OPTIMIZERS = {
    "adamw": (lambda: JO.adamw(JO.AdamWConfig(warmup_steps=3)),
              lambda: TO.adamw(TO.AdamWConfig(warmup_steps=3))),
    "adafactor": (lambda: JO.adafactor(JO.AdafactorConfig(
        warmup_steps=3, weight_decay=0.01)),
        lambda: TO.adafactor(TO.AdafactorConfig(warmup_steps=3,
                                                weight_decay=0.01))),
}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-7b"])
@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_optimizer_steps_match_the_reference(kind, arch):
    """Three steps of the port's optimizer on converted parameters and
    gradients against the reference's (stacked layers, zamba2's unstacked
    shared block and its norms): parameters and state after each step;
    then one more step of each from the reference's state converted
    across (``opt_state_from_numpy``)."""
    jmake, tmake = OPTIMIZERS[kind]
    jcfg, cfg, jm, jp, _, _ = _env(arch)
    jopt, topt = jmake(), tmake()
    params = grads_from_numpy(_np(jp), cfg, "cpu")
    jst, tst = jopt.init(jp), topt.init(params)
    grads = _opt_grads(jp, 1, 4)
    for step in range(3):
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads[step]), jst,
                              jp, jnp.int32(step))
        topt.update(grads_from_numpy(grads[step], cfg, "cpu"), tst,
                    params, step)
        want = grads_from_numpy(_np(jp), cfg, "cpu")
        for n, p in params.items():
            torch.testing.assert_close(p, want[n], **OPT_TOL)
        want_st = opt_state_from_numpy(_np(jst), cfg, "cpu")
        torch.testing.assert_close(tst, want_st, **OPT_TOL)
    # the reference's state and parameters carried across, one more step
    params = grads_from_numpy(_np(jp), cfg, "cpu")
    tst = opt_state_from_numpy(_np(jst), cfg, "cpu")
    jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads[3]), jst, jp,
                          jnp.int32(3))
    topt.update(grads_from_numpy(grads[3], cfg, "cpu"), tst, params, 3)
    want = grads_from_numpy(_np(jp), cfg, "cpu")
    for n, p in params.items():
        torch.testing.assert_close(p, want[n], **OPT_TOL)


def test_global_norm_sums_in_the_reference_s_leaf_order():
    """The leaf groups follow the reference's sorted pytree paths, the
    layers of a stacked leaf in order, and the norm matches the
    reference's ``global_norm``."""
    jcfg, cfg, jm, jp, _, tp = _env("zamba2-7b")
    names = [n for _, n in sorted(
        (tuple(int(p) if p.isdigit() else -1 for p in n.split(".")), n)
        for n in dict(tp.named_parameters()))]
    groups = TO.layer_groups(names)
    want_paths = [".".join(k.key for k in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(groups) == want_paths
    assert groups["blocks.mamba.in_proj"] == [
        f"blocks.mamba.{i}.in_proj" for i in range(cfg.n_layers)]
    g = _opt_grads(jp, 2, 1)[0]
    np.testing.assert_allclose(
        float(TO.global_norm(grads_from_numpy(g, cfg, "cpu"))),
        float(JO.global_norm(g)), rtol=1e-6)


def test_adamw_matches_closed_form():
    """tests/test_train_loop.py's single-parameter AdamW step, on the
    port."""
    cfg = TO.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                         grad_clip=1e9, warmup_steps=1)
    opt = TO.adamw(cfg)
    p = {"w": torch.tensor([2.0])}
    st = opt.init(p)
    opt.update({"w": torch.tensor([0.5])}, st, p, 0)
    mhat = 0.1 * 0.5 / (1 - 0.9)
    vhat = 0.01 * 0.25 / (1 - 0.99)
    assert float(p["w"][0]) == pytest.approx(
        2.0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8), rel=1e-5)
    assert float(st["mu"]["w"][0]) == pytest.approx(0.05, rel=1e-6)


def test_make_optimizer_takes_the_moment_dtype():
    cfg = dataclasses.replace(TR.tiny(TR.get_arch("qwen3-1.7b")),
                              opt_dtype="bfloat16")
    st = TO.make_optimizer(cfg).init({"w": torch.zeros(3)})
    assert st["mu"]["w"].dtype == torch.bfloat16
    assert "vr" in TO.make_optimizer(cfg, "adafactor").init(
        {"w": torch.zeros((2, 3))})["w"]


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor,
               scale: torch.Tensor) -> float:
    """max |got - want| over one bf16 ulp of ``scale`` (elementwise: the
    spacing of bf16 at |scale|'s binade, normal numbers only)."""
    mag = scale.float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - want.float()).abs() / ulp).max())


def _assert_bf16_moments(got, want, prev, g, exact):
    """The port's bf16 AdamW moments against the reference's after one
    step: bit for bit if ``exact``; else within one bf16 ulp of the
    update's largest operand (|new|, b |old| or (1 - b) |g| for mu, the
    same with g^2 for nu).  A clip scale one f32 ulp apart (the global
    norms sum in other orders) can round a moment the other way, and
    where the update cancels, one ulp of its operands is many of the
    small result's."""
    for m, b in (("mu", 0.9), ("nu", 0.95)):
        for n, t in got[m].items():
            w = want[m][n]
            assert t.dtype == w.dtype == torch.bfloat16, (m, n)
            if exact:
                assert torch.equal(t, w), (m, n)
                continue
            term = g[n].float() if m == "mu" else g[n].float() ** 2
            scale = torch.maximum(w.float().abs(), torch.maximum(
                b * prev[m][n].float().abs(), (1 - b) * term.abs()))
            assert _bf16_ulps(t, w, scale) <= 1.0, (m, n)


@pytest.mark.parametrize("grad_clip", [1.0, 1e9])
def test_bf16_optimizer_state_matches_the_reference(grad_clip):
    """arctic-480b keeps its AdamW moments in bf16 (``opt_dtype``): three
    steps of the port's AdamW on its converted ``tiny()`` parameters and
    ``_opt_grads`` against the reference's; the moments after each step
    bit for bit when ``grad_clip=1e9`` leaves the clip scale at 1, within
    one bf16 ulp of their operands under the default clip
    (``_assert_bf16_moments``).  The parameters at ``OPT_TOL`` where the
    moments agree bit for bit; else at 1e-5: a step moves a parameter by
    lr * delta (lr <= 3e-4 here, |delta| = |mhat| / sqrt(vhat) of order
    1), and moments one bf16 ulp apart change delta by about 2^-8 of
    itself, 1e-6 a step."""
    tol = OPT_TOL if grad_clip == 1e9 else dict(atol=1e-5, rtol=0)
    jcfg, cfg, jm, jp, _, _ = _env("arctic-480b")
    assert cfg.opt_dtype == "bfloat16"
    kw = dict(warmup_steps=3, grad_clip=grad_clip,
              moment_dtype=cfg.opt_dtype)
    jopt, topt = JO.adamw(JO.AdamWConfig(**kw)), TO.adamw(
        TO.AdamWConfig(**kw))
    params = grads_from_numpy(_np(jp), cfg, "cpu")
    jst, tst = jopt.init(jp), topt.init(params)
    prev = opt_state_from_numpy(_np(jst), cfg, "cpu")
    grads = _opt_grads(jp, 5, 3)
    for step in range(3):
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads[step]), jst,
                              jp, jnp.int32(step))
        g = grads_from_numpy(grads[step], cfg, "cpu")
        topt.update(g, tst, params, step)
        want_st = opt_state_from_numpy(_np(jst), cfg, "cpu")
        _assert_bf16_moments(tst, want_st, prev, g, grad_clip == 1e9)
        prev = want_st
        want = grads_from_numpy(_np(jp), cfg, "cpu")
        for n, p in params.items():
            torch.testing.assert_close(p, want[n], **tol)


@pytest.mark.parametrize("grad_clip", [1.0, 1e9])
def test_bf16_microbatch_accumulator_matches_the_reference(grad_clip):
    """arctic-480b with ``microbatches=2`` sums its microbatch gradients
    in bf16 (``opt_dtype``): one train step of each package whose loss is
    linear in the parameters, sum(p o g), so that both see ``_opt_grads``
    as their gradients exactly (the model's own gradients differ at f32
    noise, which near zero is hundreds of bf16 ulps).  The accumulator
    handed to the optimizer (the bf16 sum / 2 in f32) bit for bit; after
    one AdamW step the bf16 moments as
    :func:`test_bf16_optimizer_state_matches_the_reference` holds them."""
    jcfg, cfg, _, jp, _, tp = _env("arctic-480b", microbatches=2)
    grads = _opt_grads(jp, 7, 2)
    leaves = [jax.tree.leaves(g) for g in grads]
    jbatch = {f"g{i}": jnp.stack([jnp.asarray(ls[i]) for ls in leaves])
              for i in range(len(leaves[0]))}
    tgrads = [grads_from_numpy(g, cfg, "cpu") for g in grads]
    tbatch = {n: np.stack([t[n].numpy() for t in tgrads]) for n in tgrads[0]}
    jlin = types.SimpleNamespace(loss=lambda p, mb: sum(
        jnp.sum(leaf * mb[f"g{i}"])
        for i, leaf in enumerate(jax.tree.leaves(p))))
    tlin = types.SimpleNamespace(loss=lambda p, mb: sum(
        (leaf * mb[n]).sum() for n, leaf in p.named_parameters()))
    seen, jcap, tcap = _capture()
    jmake_train_step(jlin, jcfg, jcap)(jp, {}, jbatch, jnp.int32(0))
    make_train_step(tlin, cfg, tcap)(tp, {}, tbatch, 0)
    want = grads_from_numpy(_np(seen["jax"]), cfg, "cpu")
    assert set(seen["port"]) == set(want)
    for n, g in seen["port"].items():
        assert g.dtype == torch.float32 and torch.equal(g, want[n]), n
    kw = dict(grad_clip=grad_clip, moment_dtype=cfg.opt_dtype)
    jopt, topt = JO.adamw(JO.AdamWConfig(**kw)), TO.adamw(
        TO.AdamWConfig(**kw))
    jst = jopt.init(jp)
    prev = opt_state_from_numpy(_np(jst), cfg, "cpu")
    _, jst, _ = jmake_train_step(jlin, jcfg, jopt)(jp, jst, jbatch,
                                                   jnp.int32(0))
    tst = topt.init(tp)
    make_train_step(tlin, cfg, topt)(tp, tst, tbatch, 0)
    _assert_bf16_moments(tst, opt_state_from_numpy(_np(jst), cfg, "cpu"),
                         prev, want, grad_clip == 1e9)


# --------------------------------------------------------------------- #
# the loss and its gradients                                             #
# --------------------------------------------------------------------- #
LOSS_ARCHS = ["qwen3-1.7b", "gemma3-27b", "qwen2-moe-a2.7b", "mamba2-370m",
              "zamba2-7b", "whisper-medium", "internvl2-26b"]


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    """``Model.loss`` and ``torch.autograd.grad`` of it against
    ``jax.value_and_grad(model.loss)`` on the same parameters and batch:
    dense (the blocked attention of qwen3-1.7b; gemma3-27b's window, which
    S = 24 exceeds), MoE (its aux loss in the loss), SSM, hybrid, encdec
    (the encoder's gradients) and VLM (the vision prefix dropped from the
    logits).  Remat is on (``"block"``) in both."""
    jcfg, cfg, jm, jp, model, tp = _env(arch)
    assert cfg.remat == "block"
    batch = _batch(cfg, 1)
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = model.loss(tp, batch)
    assert loss.dtype == torch.float32 and loss.grad_fn is not None
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOSS_TOL)
    named = dict(tp.named_parameters())
    got = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    _assert_grads_close(got, grads_from_numpy(_np(jg), cfg, "cpu"))
    if cfg.family == "moe":     # the aux term is in: without it, another
        jax_no_aux = float(jl) - 0.01 * float(
            jax.jit(lambda p: _moe_aux(jm, p, batch))(jp))
        assert abs(jax_no_aux - float(loss.detach())) > 1e-4


def _moe_aux(jm, params, batch):
    """The reference's mean aux loss of a MoE model on ``batch``."""
    tokens = jnp.asarray(batch["tokens"])[:, :-1]
    Bn, Sn = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(Sn), (Bn, Sn))
    x = jm._embed(params, tokens, positions)
    _, _, aux = jm._backbone(params, x, positions=positions, mode="causal")
    return aux


def test_remat_changes_memory_not_values():
    """The same loss and gradients, bit for bit, with the layers
    checkpointed (``remat="block"``: the backward recomputes each layer)
    and without (``"none"``)."""
    _, cfg, _, jp, _, _ = _env("qwen3-1.7b")
    batch = _batch(cfg, 2)
    out = {}
    for remat in ("block", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        tp = params_from_numpy(_np(jp), c, "cpu", trainable=True)
        loss = Model(c).loss(tp, batch)
        out[remat] = (loss, torch.autograd.grad(loss, list(tp.parameters())))
    assert torch.equal(out["block"][0], out["none"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["block"][1],
                                                 out["none"][1]))


def test_parameters_are_frozen_unless_trainable():
    """The serving path's parameters take no gradient; ``trainable=True``
    gives every leaf one."""
    cfg = TR.tiny(TR.get_arch("qwen3-1.7b"))
    model = Model(cfg)
    gen = torch.Generator().manual_seed(0)
    frozen = model.init(gen)
    assert not any(p.requires_grad for p in frozen.parameters())
    logits, _ = model.prefill(frozen, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)}, 8)
    assert logits.grad_fn is None
    assert all(p.requires_grad for p in model.init(
        gen, trainable=True).parameters())


# --------------------------------------------------------------------- #
# the train step                                                         #
# --------------------------------------------------------------------- #
def _capture():
    """An optimizer pair that records the gradients it is given."""
    seen = {}

    def jupdate(g, s, p, step):
        seen["jax"] = g
        return p, s

    def tupdate(g, s, p, step):
        seen["port"] = g
        return p, s
    return seen, JO.Optimizer(lambda p: {}, jupdate), \
        TO.Optimizer(lambda p: {}, tupdate)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_train_step_with_two_microbatches_matches_the_reference(arch):
    """``microbatches=2``: the gradients the step hands its optimizer (the
    sum over the microbatches in ``opt_dtype``, divided by 2) and its loss
    against the reference's ``lax.scan`` accumulation; then one AdamW step
    of each: the parameters at 2e-5 (AdamW's first step moves an element
    by about ``lr * warm`` whatever its gradient's size, so an element
    whose gradient sits at the f32 noise floor may move by up to
    ``2 * lr * warm``, 6e-6, between the two).  The MoE arch's loss
    carries its aux term, and its gradients run through the dispatch's
    and the combine's backward."""
    jcfg, cfg, jm, jp, model, tp = _env(arch, microbatches=2)
    batch = shape_batch_for_accum(_batch(cfg, 3, B=4), 2)
    seen, jcap, tcap = _capture()
    _, _, jmet = jmake_train_step(jm, jcfg, jcap)(
        jp, {}, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0))
    _, _, tmet = make_train_step(model, cfg, tcap)(tp, {}, batch, 0)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               **LOSS_TOL)
    assert all(g.dtype == torch.float32 for g in seen["port"].values())
    _assert_grads_close(seen["port"],
                        grads_from_numpy(_np(seen["jax"]), cfg, "cpu"))
    jopt, topt = JO.make_optimizer(jcfg), TO.make_optimizer(cfg)
    jp2, _, _ = jmake_train_step(jm, jcfg, jopt)(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.int32(0))
    make_train_step(model, cfg, topt)(tp, topt.init(tp), batch, 0)
    want = grads_from_numpy(_np(jp2), cfg, "cpu")
    for n, p in tp.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], atol=2e-5, rtol=0)


def test_shape_batch_for_accum_rejects_a_batch_it_cannot_split():
    out = shape_batch_for_accum({"tokens": np.zeros((4, 3))}, 2)
    assert out["tokens"].shape == (2, 2, 3)
    with pytest.raises(ValueError, match="multiple"):
        shape_batch_for_accum({"tokens": np.zeros((3, 3))}, 2)


# --------------------------------------------------------------------- #
# run_training                                                           #
# --------------------------------------------------------------------- #
KW = dict(arch="tiny:qwen3-1.7b", steps=30, ckpt_every=10, global_batch=4,
          seq_len=32, seed=3, device="cpu")


@pytest.fixture(scope="module")
def uninterrupted_runs(tmp_path_factory):
    """``run(arch)``: the uninterrupted run of KW on ``arch``, once a
    module."""
    runs = {}

    def run(arch):
        if arch not in runs:
            runs[arch] = run_training(
                ckpt_dir=str(tmp_path_factory.mktemp("ref")),
                **dict(KW, arch=arch))
        return runs[arch]
    return run


@pytest.fixture(scope="module")
def uninterrupted(uninterrupted_runs):
    return uninterrupted_runs(KW["arch"])


@pytest.mark.parametrize("arch", ["tiny:qwen3-1.7b", "tiny:qwen2-moe-a2.7b"])
@pytest.mark.parametrize("crash_phase", ["between", "shards", "manifest"])
def test_crash_restart_equivalence(tmp_path, uninterrupted_runs, crash_phase,
                                   arch):
    """tests/test_train_loop.py's recipe on the port: a crash at step 17
    (or inside step 20's commit), a restart from the newest committed
    manifest, and every loss the resumed run computes equal to the
    uninterrupted run's, bit for bit; on the dense arch and on the MoE
    arch (its routing and aux loss repeated by the resumed run)."""
    ref = uninterrupted_runs(arch)
    kw = dict(KW, arch=arch)
    assert ref["final_step"] == 30
    crash_at = 17 if crash_phase == "between" else 20
    first = run_training(ckpt_dir=str(tmp_path), crash_at=crash_at,
                         crash_phase=crash_phase, **kw)
    assert first["crashed_at"] == crash_at
    second = run_training(ckpt_dir=str(tmp_path), **kw)
    assert second["final_step"] == 30
    assert second["log"] == ["resumed from committed step 10"]
    assert min(second["losses"]) == 11
    for s, loss in second["losses"].items():
        assert loss == ref["losses"][s], (s, loss)
    assert second["final_loss"] == ref["final_loss"]
    assert second["io"]["fences"] > 0


SSM_KW = dict(KW, arch="tiny:mamba2-370m")


@pytest.fixture(scope="module")
def uninterrupted_ssm(tmp_path_factory):
    return run_training(ckpt_dir=str(tmp_path_factory.mktemp("ssm")),
                        **SSM_KW)


@pytest.mark.parametrize("crash_phase", ["between", "shards", "manifest"])
def test_crash_restart_equivalence_ssm(tmp_path, uninterrupted_ssm,
                                       crash_phase):
    """The same recipe on tiny:mamba2-370m, whose gradients run through the
    SSD scan's backward (on the card, the ``ssd_scan`` backward kernels):
    the resumed run's losses equal the uninterrupted run's bit for bit."""
    ref = uninterrupted_ssm
    crash_at = 17 if crash_phase == "between" else 20
    first = run_training(ckpt_dir=str(tmp_path), crash_at=crash_at,
                         crash_phase=crash_phase, **SSM_KW)
    assert first["crashed_at"] == crash_at
    second = run_training(ckpt_dir=str(tmp_path), **SSM_KW)
    assert second["log"] == ["resumed from committed step 10"]
    assert second["final_step"] == 30 and min(second["losses"]) == 11
    for s, loss in second["losses"].items():
        assert loss == ref["losses"][s], (s, loss)
    assert np.isfinite(ref["final_loss"])


def test_loss_decreases_and_stragglers_are_counted(tmp_path,
                                                   uninterrupted):
    out = uninterrupted
    first = np.mean([out["losses"][s] for s in range(1, 6)])
    last = np.mean([out["losses"][s] for s in range(26, 31)])
    assert last < first, (first, last)
    assert out["stragglers"] == []
    slow = run_training(ckpt_dir=str(tmp_path), **{
        **KW, "steps": 3, "ckpt_every": 3}, step_deadline=0.0)
    assert [s["step"] for s in slow["stragglers"]] == [1, 2, 3]
    beat = json.loads((tmp_path / "heartbeat.json").read_text())
    assert beat["step"] == 3 and beat["loss"] == slow["final_loss"]


def test_run_training_matches_the_reference_s_first_loss(tmp_path):
    """The port's run_training and the reference's on the same arch, shape and
    seed give the same first loss (different random parameters from the
    two generators would not): the pipeline's first batch through the
    reference's parameters carried across."""
    from repro.launch.train import run_training as jrun
    jout = jrun(arch="tiny:qwen3-1.7b", steps=1, ckpt_every=1,
                ckpt_dir=str(tmp_path / "j"), global_batch=4, seq_len=32,
                seed=3)
    jcfg, cfg, jm, jp, model, tp = _env("qwen3-1.7b", seed=3)
    batch = TokenPipeline(cfg, ShapeConfig("train", 32, 4, "train"),
                          seed=3).next_batch()
    np.testing.assert_allclose(float(model.loss(tp, batch)),
                               jout["final_loss"], **LOSS_TOL)


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--steps", "4",
            "--ckpt-every", "2", "--global-batch", "2", "--seq-len", "16"]
    train.main(args + ["--crash-at", "4", "--crash-phase", "manifest"])
    assert '"crashed_at": 4' in capsys.readouterr().out
    train.main(args)
    out = capsys.readouterr().out
    assert "resumed from committed step 2" in out and "final loss:" in out
    train.main(args)
    assert "already at target step" in capsys.readouterr().out


def test_train_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """Without ``device`` run_training and the CLI run on the card, and
    raise where there is none instead of training on the host."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(arch="tiny:qwen3-1.7b", steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--ckpt-dir", str(tmp_path), "--steps", "1"])
