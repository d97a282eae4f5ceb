"""The port's dense family (qwen2-7b, qwen3-1.7b, qwen1.5-32b, gemma3-27b)
against the JAX package on the CPU: the configs, the parameter tree,
``dense_stack``, prefill and decode logits and greedy tokens on
``tiny(arch)`` with the JAX parameters carried across as numpy arrays
(``models/convert.py``), and ``ServeEngine`` on ``tiny(qwen2-7b)``.

Everything is f32 and held at ``TOL`` (1e-4, rtol and atol): both sides
compute in f32 with sums in other orders (the reference's prefill runs
its blocked online softmax, the port ``flash_attention``'s plain version).
The zero-initialised leaves (QKV bias, q/k norms, layer norms) are
replaced by seeded noise before the weights cross, so each of them acts.
``S`` exceeds tiny gemma3's local window (16), so the window bites in
prefill and in decode.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.configs.registry import tiny as jtiny
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import build_model
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.obs.metrics import get_registry
from repro_torch.serving.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ("qwen2-7b", "qwen3-1.7b", "qwen1.5-32b", "gemma3-27b")
B, S, MAX_LEN = 2, 37, 48
# leaves the reference initialises to zero: given seeded noise so that
# the bias, the q/k norms and the layer norms all act
NOISY = ("bq", "bk", "bv", "q_norm", "k_norm", "ln1", "ln2", "final_norm")


def _noisy(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key in NOISY:
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


def _env(name, seed=0):
    jcfg = jtiny(jget_arch(name))
    cfg = TR.tiny(TR.get_arch(name))
    jm = build_model(jcfg)
    jp = _noisy(jm.init(jax.random.PRNGKey(seed)), seed)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jp=jp, tm=Model(cfg), tp=tp)


@pytest.fixture(scope="module", params=DENSE)
def env(request):
    e = _env(request.param)
    e["toks"] = np.random.default_rng(1).integers(
        0, e["cfg"].vocab, size=(B, S + 1)).astype(np.int32)
    return e


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(kw or TOL))


@pytest.mark.parametrize("name", DENSE)
def test_dense_configs_and_their_tiny_forms_are_the_references(name):
    j, t = jget_arch(name), TR.get_arch(name)
    assert t.family == "dense"
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.n_params()) == (j.head_dim, j.n_params())
    tt, jt = TR.tiny(t), jtiny(j)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert (tt.head_dim, tt.n_params()) == (jt.head_dim, jt.n_params())


def test_port_init_has_the_reference_tree(env):
    """Names, shapes and dtypes of every leaf (the stacked layer axis
    unrolled: ``blocks/attn/wq[3]`` is ``blocks.3.attn.wq``), including
    the bias and q/k-norm leaves of ``attn_params``."""
    own = env["tm"].init(torch.Generator().manual_seed(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(env["jp"]):
        keys = [k.key for k in path]
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                want[".".join(["blocks", str(i)] + keys[1:])] = \
                    (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            want[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in own.named_parameters()}
    assert got == want
    assert dict(env["tp"].named_parameters()).keys() == got.keys()
    cfg = env["cfg"]
    attn = set(dict(own.named_parameters()))
    assert ("blocks.0.attn.bq" in attn) == cfg.qkv_bias
    assert ("blocks.0.attn.q_norm" in attn) == cfg.qk_norm


def test_dense_stack_matches_jax(env):
    cfg, jcfg = env["cfg"], env["jcfg"]
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jy, _ = JT.dense_stack(env["jp"]["blocks"], jnp.asarray(x), jcfg,
                           positions=jnp.asarray(pos), mode="causal")
    ty, _ = TT.dense_stack(env["tp"]["blocks"], torch.as_tensor(x), cfg,
                           positions=torch.as_tensor(pos), mode="causal")
    close(ty, jy)


def test_prefill_and_decode_logits_and_tokens_match_jax(env):
    jm, jp, tm, tp, toks = (env[k] for k in ("jm", "jp", "tm", "tp",
                                             "toks"))
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, MAX_LEN))(
        jp, {"tokens": jnp.asarray(toks[:, :S])})
    jd, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, S]), jc,
                                     jnp.int32(S))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :S])},
                            MAX_LEN)
        td, tc = tm.decode_step(tp, torch.as_tensor(toks[:, S]), tc, S)
    assert tl.shape == (B, 1, env["cfg"].vocab)
    close(tl, jl)
    close(td, jd)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    for t, j in ((tl, jl), (td, jd)):
        np.testing.assert_array_equal(t[:, -1].argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(j[:, -1], -1)))


def test_port_prefill_agrees_with_prefill_plus_decode(env):
    tm, tp, toks = env["tm"], env["tp"], torch.as_tensor(env["toks"])
    with torch.no_grad():
        _, c = tm.prefill(tp, {"tokens": toks[:, :S]}, MAX_LEN)
        dec, _ = tm.decode_step(tp, toks[:, S], c, S)
        full, _ = tm.prefill(tp, {"tokens": toks}, MAX_LEN + 1)
    torch.testing.assert_close(dec[:, 0], full[:, 0], **TOL)


def test_gemma3_window_bites_in_prefill_and_decode():
    """Tiny gemma3's layers are all local (window 16, 5 local a global,
    4 layers): with S = 37 both the prefill and the decode logits move
    when the window is lifted, and both still match JAX with it."""
    e = _env("gemma3-27b")
    assert [TT._layer_window(e["cfg"], i) for i in range(6)] == \
        [16] * 5 + [0]
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, e["cfg"].vocab, size=(B, S + 1)))
    wide = Model(dataclasses.replace(e["cfg"], local_per_global=0))
    with torch.no_grad():
        outs = []
        for m in (e["tm"], wide):
            pl, c = m.prefill(e["tp"], {"tokens": toks[:, :S]}, MAX_LEN)
            dl, _ = m.decode_step(e["tp"], toks[:, S], c, S)
            outs.append((pl, dl))
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) > 1e-2


def test_layer_window_matches_the_reference():
    cfg = dataclasses.replace(TR.get_arch("gemma3-27b"), n_layers=14)
    jcfg = dataclasses.replace(jget_arch("gemma3-27b"), n_layers=14)
    assert [TT._layer_window(cfg, i) for i in range(14)] == \
        [int(JT._layer_window(jcfg, i)) for i in range(14)]
    assert TT._layer_window(TR.get_arch("qwen2-7b"), 5) == 0


def test_bf16_decode_attention_rounds_its_scale_at_dh_128():
    """At dh = 128 the reference divides the scores by sqrt(128) rounded
    to bf16 (11.3125, not 11.3137), in bf16: the port's scores equal
    JAX's under GQA 28:4."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((2, 1, 28, 128)).astype(np.float32) * 3
    k, v = (rng.standard_normal((2, 9, 4, 128)).astype(np.float32)
            for _ in range(2))
    assert float(torch.tensor(128 ** 0.5).to(torch.bfloat16)) == 11.3125
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    got = TL.attention_scores(*tb, None)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(JL.attention_scores(*jb, None),
                                  np.float32), atol=5e-3, rtol=0)


@pytest.fixture(scope="module")
def qwen():
    e = _env("qwen2-7b", seed=1)
    rng = np.random.default_rng(4)
    e["requests"] = {rid: rng.integers(0, e["cfg"].vocab,
                                       size=20 if rid < 4 else 16
                                       ).astype(np.int32)
                     for rid in range(8)}
    return e


def _port(e, d, **kw):
    return ServeEngine(e["tm"], e["tp"], max_len=25, log_dir=d,
                       batch_size=2, device="cpu", **kw)


def test_engines_commit_identical_tokens_and_hold_exactly_once(qwen,
                                                               tmp_path):
    """ServeEngine on tiny(qwen2-7b) commits the JAX engine's greedy
    tokens; a crash after one batch and a second engine on the same log
    keep exactly-once (one record a batch, dedup hits for the first)."""
    want = JaxEngine(qwen["jm"], qwen["jp"], max_len=25,
                     log_dir=tmp_path / "jax", batch_size=2).serve(
        qwen["requests"], n_new=5)
    reg = get_registry()
    first = _port(qwen, tmp_path / "port").serve(
        qwen["requests"], n_new=5, crash_after_batches=1)
    assert sorted(first) == [4, 5]
    hits = reg.counter("serving_dedup_hits_total").value
    again = _port(qwen, tmp_path / "port")
    got = again.serve(qwen["requests"], n_new=5)
    assert got == want and len(got) == 8
    assert reg.counter("serving_dedup_hits_total").value - hits == 2
    assert len(list((tmp_path / "port").glob("log_*.json"))) == 4
    assert len(again.step_times["prefill_s"]) == 3


def test_model_phase_serves_qwen2_exactly_once_on_the_cpu():
    """chip_smoke.py's model phase on tiny(qwen2-7b): two prefills, four
    dedup hits after the crash, one record a batch, no kernel launched
    on the CPU and no SSD."""
    got = chip_smoke.run_model(chip_smoke.SMALL, torch.device("cpu"), 3,
                               "qwen2-7b")
    assert got["arch"] == "qwen2-7b"
    assert (got["prefills"], got["dedup_hits"], got["records"]) == (2, 4, 2)
    assert got["launches"] == {"flash_attention": 0, "ssd_scan": 0,
                               "nvt_probe": 0, "decode_attention": 0}
    assert got["prefill_compute_bound_ms"] > 0
    full = TR.get_arch("qwen2-7b")
    assert chip_smoke.attn_launches_per_prefill(full) == 28
    assert chip_smoke.attn_launches_per_prefill(
        TR.get_arch("zamba2-7b")) == 13
    assert chip_smoke.decode_launches_per_step(full) == 28
    assert chip_smoke.decode_launches_per_step(
        TR.get_arch("zamba2-7b")) == 13
    # 2 flops a non-embedding weight a token of a 4 x 512 prefill: ~29 ms
    bound = chip_smoke.prefill_bound_ms(full, chip_smoke.FULL)
    assert 28.0 < bound < 30.0


def test_checks_phase_holds_the_qwen2_shapes_on_the_cpu():
    sz, cpu = chip_smoke.SMALL, torch.device("cpu")
    errs = chip_smoke.check_flash(sz, cpu)
    assert {"qwen2_bf16_S40", "qwen2_bf16_S37", "bf16_S40",
            "qwen2_engine_bf16"} <= set(errs)
    # the engine point's prefills on the card: 2 prompts of 6 tokens,
    # qwen2-7b's GQA 28:4 heads at d = 128
    assert chip_smoke.engine_flash_shape(chip_smoke.FULL) == (2, 6, 28, 4,
                                                              128)
    cons = chip_smoke.check_consistency(sz, cpu, 1, "qwen2-7b")
    assert cons["arch"] == "qwen2-7b" and cons["max_abs_err"] < cons["tol"]
    assert "shared_attn_calls" not in cons
