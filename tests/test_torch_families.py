"""The port's MoE, SSM, encoder-decoder and VLM families (qwen2-moe-a2.7b,
arctic-480b, mamba2-370m, whisper-medium, internvl2-26b) against the JAX
package on the CPU: the configs, ``moe_ffn`` and its routing and drops,
the moe, ssm, encoder and decoder stacks, cross-attention, the gelu MLP
and the fused projections, prefill and decode logits and greedy tokens on
``tiny(arch)`` with the JAX parameters carried across as numpy arrays
(``models/convert.py``), and ``ServeEngine`` on ``tiny(whisper-medium)``
and ``tiny(internvl2-26b)``.

Everything is f32 and held at ``TOL`` (1e-4, rtol and atol): both sides
compute in f32 with sums in other orders (the reference's prefill
attention runs its blocked online softmax or one softmax, the port
``flash_attention``'s plain version; the port's MoE combine sums each
token's K slots in order where the reference scatter-adds them).  The
zero-initialised leaves (biases, norms, the SSM's ``dt_bias`` and
``A_log``) are replaced by seeded noise before the weights cross, so each
of them acts.  The MoE's routing (``top_e``) and its dropped slots are
compared exactly.
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
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.models.model import build_model
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.mamba2 import SSMCache
from repro_torch.models.model import Model
from repro_torch.obs.metrics import get_registry
from repro_torch.serving.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {"qwen2-moe-a2.7b": "moe", "arctic-480b": "moe",
            "mamba2-370m": "ssm", "whisper-medium": "encdec",
            "internvl2-26b": "vlm"}
MOE = ("qwen2-moe-a2.7b", "arctic-480b")
B, S, N_NEW = 2, 37, 4
# leaves the reference initialises to zero (or one): seeded noise
NOISY = ("bq", "bk", "bv", "bqkv", "q_norm", "k_norm", "ln1", "ln2",
         "ln_x", "ln", "final_norm", "enc_norm", "out_norm", "conv_b",
         "dt_bias", "A_log")


def _noisy(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key in NOISY:
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


def _env(name, seed=0, **overrides):
    jcfg = jtiny(jget_arch(name), **overrides)
    cfg = TR.tiny(TR.get_arch(name), **overrides)
    jm = build_model(jcfg)
    jp = _noisy(jm.init(jax.random.PRNGKey(seed)), seed)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jp=jp, tm=Model(cfg), tp=tp)


@pytest.fixture(scope="module", params=list(FAMILIES))
def env(request):
    return _env(request.param)


@pytest.fixture(scope="module")
def moe_envs():
    return {name: _env(name, seed=3) for name in MOE}


@pytest.fixture(scope="module")
def whisper():
    return _env("whisper-medium", seed=2)


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(kw or TOL))


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _prefix(cfg, seed):
    """The family's frontend inputs, as numpy: {"vis"} or {"frames"}."""
    if cfg.family == "vlm":
        return {"vis": _x(seed, B, cfg.vis_tokens, cfg.d_model)}
    if cfg.family == "encdec":
        return {"frames": _x(seed, B, cfg.enc_seq, cfg.d_model)}
    return {}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_configs_and_their_tiny_forms_are_the_references(name):
    j, t = jget_arch(name), TR.get_arch(name)
    assert t.family == FAMILIES[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.n_params(), t.n_active_params()) == \
        (j.head_dim, j.n_params(), j.n_active_params())
    tt, jt = TR.tiny(t), jtiny(j)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)


@pytest.mark.parametrize("theta", [0.0, 1e4])
def test_rope_without_theta_is_the_identity_like_jax(theta):
    """whisper's ``rope_theta = 0`` means absolute positions: the
    reference returns q and k as they are, and so must the port (a log of
    0 would make them NaN)."""
    x = _x(1, 2, 5, 3, 32)
    pos = np.array([[0, 1, 2, 7, 100], [3, 4, 5, 6, 527]], np.int32)
    got = TL.rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    close(got, JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    assert torch.isfinite(got).all()
    assert torch.equal(got, torch.as_tensor(x)) == (theta == 0.0)


def _jax_routing(p, x, cfg):
    """The reference's top-k experts and kept slots (``moe.py``'s own
    lines, which it does not return)."""
    T = x.shape[0] * x.shape[1]
    xf = x.reshape(T, -1)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, p["router"]), -1)
    _, top_e = jax.lax.top_k(probs, cfg.top_k)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e)
    ranked = flat_e[order]
    start = jnp.searchsorted(ranked, jnp.arange(cfg.n_experts), side="left")
    keep = jnp.arange(T * cfg.top_k) - start[ranked] < \
        JMOE._capacity(T, cfg)
    return np.asarray(top_e), np.asarray(keep)


@pytest.mark.parametrize("capacity", ["tiny", 1.25])
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_routes_drops_and_combines_like_jax(moe_envs, name,
                                                    capacity):
    """y, aux, the top-k experts and the kept slots at tiny's capacity
    (no drops) and at the published capacity factor 1.25 over 4 x 64
    tokens, where 39 of 512 slots are dropped: qwen2-moe with its shared
    experts, arctic with its dense residual."""
    e = moe_envs[name]
    cfg, jcfg = e["cfg"], e["jcfg"]
    if capacity != "tiny":
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity)
    jp = jax.tree.map(lambda a: a[1], e["jp"]["blocks"])["moe"]
    tp = e["tp"]["blocks"][1]["moe"]
    assert ("shared" in tp) == (name == "qwen2-moe-a2.7b")
    assert ("dense_res" in tp) == (name == "arctic-480b")
    # an offset shared by every token skews the routing: at 1.25 the
    # busiest experts overflow their capacity
    x = _x(4, 4, 64, cfg.d_model) + 0.5 * _x(19, cfg.d_model)
    jy, jaux = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = TMOE.moe_ffn(tp, torch.as_tensor(x), cfg)
    close(ty, jy)
    close(taux, jaux)
    want_e, want_keep = _jax_routing(jp, jnp.asarray(x), jcfg)
    T = 4 * 64
    _, _, top_e = TMOE.route(tp, torch.as_tensor(x).reshape(T, -1), cfg)
    keep = TMOE.dispatch(top_e, TMOE._capacity(T, cfg), cfg.n_experts)[3]
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert TMOE._capacity(T, cfg) == JMOE._capacity(T, jcfg)
    assert int((~keep).sum()) == (0 if capacity == "tiny" else 39)


def test_top_k_takes_the_lower_expert_on_a_tie():
    """``lax.top_k`` takes the lower index on equal probabilities; the
    port's router does too (a stable descending sort)."""
    cfg = TR.tiny(TR.get_arch("qwen2-moe-a2.7b"))
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[0, [1, 3, 6]] = 1.0           # experts 1, 3 and 6 tie
    x = np.zeros((3, cfg.d_model), np.float32)
    x[:, 0] = [1.0, 2.0, -1.0]
    _, _, top_e = TMOE.route({"router": torch.as_tensor(router)},
                             torch.as_tensor(x), cfg)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1)
    want = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    np.testing.assert_array_equal(top_e.numpy(), want)
    assert top_e[0].tolist() == [1, 3]


@pytest.mark.parametrize("name", MOE)
def test_moe_stack_matches_jax_with_its_aux_loss(moe_envs, name):
    e = moe_envs[name]
    cfg, jcfg = e["cfg"], e["jcfg"]
    x = _x(5, B, S, cfg.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jy, _, jaux = JT.moe_stack(e["jp"]["blocks"], jnp.asarray(x), jcfg,
                               positions=jnp.asarray(pos), mode="causal")
    ty, _, taux = TT.moe_stack(e["tp"]["blocks"], torch.as_tensor(x), cfg,
                               positions=torch.as_tensor(pos),
                               mode="causal")
    close(ty, jy)
    close(taux, jaux)


def test_ssm_stack_matches_jax_from_zero_and_into_caches():
    e = _env("mamba2-370m", seed=4)
    cfg, jcfg = e["cfg"], e["jcfg"]
    x = _x(6, B, S, cfg.d_model)
    jy, _ = JT.ssm_stack(e["jp"]["blocks"], jnp.asarray(x), jcfg)
    ty, _ = TT.ssm_stack(e["tp"]["blocks"], torch.as_tensor(x), cfg)
    close(ty, jy)
    # prefill into caches that already hold a state (carried in)
    L = cfg.n_layers
    jc = JT.init_ssm_caches(jcfg, L, B, jnp.float32)
    st = _x(7, *jc.state.shape, scale=0.3)
    conv = _x(8, *jc.conv.shape, scale=0.3)
    jc = jc._replace(state=jnp.asarray(st), conv=jnp.asarray(conv))
    tc = SSMCache(torch.as_tensor(st.copy()), torch.as_tensor(conv.copy()))
    jy, jnew = JT.ssm_stack(e["jp"]["blocks"], jnp.asarray(x), jcfg,
                            caches=jc)
    ty, tnew = TT.ssm_stack(e["tp"]["blocks"], torch.as_tensor(x), cfg,
                            caches=tc)
    close(ty, jy)
    close(tnew.state, jnew.state)
    close(tnew.conv, jnew.conv)


def test_encoder_and_decoder_stacks_match_jax(whisper):
    """The bidirectional encoder (no positions) and the decoder with
    cross-attention over the encoder output (Sq = 37, Se = 24): outputs
    and every layer's cross k/v, also from ``precompute_cross_caches``."""
    e = whisper
    cfg, jcfg, jp, tp = e["cfg"], e["jcfg"], e["jp"], e["tp"]
    enc = _x(9, B, cfg.enc_seq, cfg.d_model)
    jenc = JT.encoder_stack(jp["encoder"], jnp.asarray(enc), jcfg)
    tenc = TT.encoder_stack(tp["encoder"], torch.as_tensor(enc), cfg)
    close(tenc, jenc)
    x = _x(10, B, S, cfg.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jy, _, jxa = JT.decoder_stack(jp["blocks"], jnp.asarray(x), jcfg,
                                  positions=jnp.asarray(pos), mode="causal",
                                  enc_out=jenc)
    ty, _, txa = TT.decoder_stack(tp["blocks"], torch.as_tensor(x), cfg,
                                  positions=torch.as_tensor(pos),
                                  mode="causal", enc_out=tenc)
    close(ty, jy)
    L = cfg.n_layers
    assert txa["k"].shape == (L, B, cfg.enc_seq, cfg.n_kv_heads,
                              cfg.head_dim)
    close(txa["k"], jxa["k"])
    close(txa["v"], jxa["v"])
    pre = TT.precompute_cross_caches(tp["blocks"], tenc, cfg)
    jpre = JT.precompute_cross_caches(jp["blocks"], jenc, jcfg)
    close(pre["k"], jpre["k"])
    close(pre["v"], jpre["v"])


def test_cross_attention_prefill_and_decode_match_jax(whisper):
    """Prefill projects the encoder output and attends through
    ``flash_attention`` without a mask (Sq != Se); decode attends one
    query over the cached cross k/v."""
    cfg, jcfg = whisper["cfg"], whisper["jcfg"]
    jp = jax.tree.map(lambda a: a[0], whisper["jp"]["blocks"])["xattn"]
    tp = whisper["tp"]["blocks"][0]["xattn"]
    x, kv = _x(11, B, S, cfg.d_model), _x(12, B, cfg.enc_seq, cfg.d_model)
    jy, jc = JL.cross_attention(jp, jnp.asarray(x), jcfg,
                                kv=jnp.asarray(kv))
    ty, tc = TL.cross_attention(tp, torch.as_tensor(x), cfg,
                                kv=torch.as_tensor(kv))
    close(ty, jy)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    x1 = _x(13, B, 1, cfg.d_model)
    jy, _ = JL.cross_attention(jp, jnp.asarray(x1), jcfg, kv_cache=jc)
    ty, _ = TL.cross_attention(tp, torch.as_tensor(x1), cfg, kv_cache=tc)
    close(ty, jy)


def test_gelu_mlp_and_bidirectional_attention_match_jax(whisper):
    """whisper's MLP (``jax.nn.gelu``'s tanh approximation) and its
    encoder's self-attention without a mask."""
    cfg, jcfg = whisper["cfg"], whisper["jcfg"]
    jl = jax.tree.map(lambda a: a[1], whisper["jp"]["encoder"])
    tl = whisper["tp"]["encoder"][1]
    assert set(tl["mlp"]._parameters) == {"w_up", "w_down"}
    x = _x(14, B, S, cfg.d_model)
    close(TL.mlp(tl["mlp"], torch.as_tensor(x), "gelu"),
          JL.mlp(jl["mlp"], jnp.asarray(x), "gelu"))
    jy, _ = JL.self_attention(jl["attn"], jnp.asarray(x), jcfg,
                              positions=None, mode="bidir")
    ty, tc = TL.self_attention(tl["attn"], torch.as_tensor(x), cfg,
                               positions=None, mode="bidir")
    close(ty, jy)
    assert tc is None


def test_fused_projections_give_the_references_unfused_logits():
    """tests/test_arch_smoke.py's case: tiny(qwen2-7b) (QKV biases) with
    wq/wk/wv packed into ``wqkv``/``bqkv`` and gate|up into
    ``w_gate_up``.  The port's fused model gives the reference's unfused
    and fused logits, and ``Model.init`` draws the fused leaves."""
    jcfg = jtiny(jget_arch("qwen2-7b"))
    fused = dict(fused_qkv=True, fused_gate_up=True)
    jm, jmf = build_model(jcfg), build_model(
        dataclasses.replace(jcfg, **fused))
    jp = _noisy(jm.init(jax.random.PRNGKey(0)), 0)

    def pack_block(b):
        a = dict(b["attn"])
        a["wqkv"] = jnp.concatenate([a.pop("wq"), a.pop("wk"),
                                     a.pop("wv")], axis=1)
        a["bqkv"] = jnp.concatenate([a.pop("bq"), a.pop("bk"),
                                     a.pop("bv")])
        ml = dict(b["mlp"])
        ml["w_gate_up"] = jnp.concatenate([ml.pop("w_gate"),
                                           ml.pop("w_up")], axis=1)
        return {**b, "attn": a, "mlp": ml}
    jpf = dict(jp)
    jpf["blocks"] = jax.vmap(pack_block)(jp["blocks"])
    cfg = dataclasses.replace(TR.tiny(TR.get_arch("qwen2-7b")), **fused)
    tp = params_from_numpy(jax.tree.map(np.asarray, jpf), cfg, "cpu")
    toks = np.random.default_rng(15).integers(0, cfg.vocab, size=(B, S))
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, S)
    want_f, _ = jmf.prefill(jpf, {"tokens": jnp.asarray(toks)}, S)
    with torch.no_grad():
        got, _ = Model(cfg).prefill(tp, {"tokens": torch.as_tensor(toks)},
                                    S)
    close(got, want)
    close(got, want_f)
    own = dict(Model(cfg).init(torch.Generator().manual_seed(0))
               .named_parameters())
    assert own["blocks.0.attn.wqkv"].shape == tp["blocks"][0]["attn"][
        "wqkv"].shape
    assert own["blocks.0.mlp.w_gate_up"].shape == (cfg.d_model,
                                                   2 * cfg.d_ff)
    assert "blocks.0.attn.wq" not in own


def test_prefill_decode_logits_and_greedy_tokens_match_jax(env):
    """Prefill (with the family's frames or vision prefix) and four greedy
    decode steps: every step's logits at TOL, every token identical, and
    the caches after the last step."""
    cfg, jm, jp, tm, tp = (env[k] for k in ("cfg", "jm", "jp", "tm", "tp"))
    toks = np.random.default_rng(16).integers(0, cfg.vocab, size=(B, S))
    extra = _prefix(cfg, 17)
    prefix = cfg.vis_tokens if cfg.family == "vlm" else 0
    max_len = prefix + S + N_NEW
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len))(
        jp, {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in extra.items()}})
    jdec = jax.jit(jm.decode_step)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks),
                                 **{k: torch.as_tensor(v)
                                    for k, v in extra.items()}}, max_len)
        close(tl, jl)
        jtok, ttok = [], []
        for i in range(N_NEW):
            jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
            tt = torch.argmax(tl[:, -1], -1)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            jtok.append(np.asarray(jt))
            ttok.append(tt.numpy())
            jl, jc = jdec(jp, jt, jc, jnp.int32(prefix + S + i))
            tl, tc = tm.decode_step(tp, tt, tc, prefix + S + i)
            close(tl, jl)
    assert np.array_equal(np.stack(jtok), np.stack(ttok))
    if cfg.family == "ssm":
        close(tc.state, jc.state)
    elif cfg.family == "encdec":
        close(tc["self"]["k"], jc["self"]["k"])
        close(tc["cross"]["v"], jc["cross"]["v"])
    else:
        close(tc["k"], jc["k"])


@pytest.mark.parametrize("name", ["whisper-medium", "internvl2-26b"])
def test_engines_commit_identical_tokens_through_a_crash(name, tmp_path):
    """ServeEngine on tiny(whisper-medium) (zero frames) and
    tiny(internvl2-26b) (a zero vision prefix, decode positions after
    it) commits the JAX engine's greedy tokens; a crash after one batch
    and a second engine on the same log keep exactly-once."""
    e = _env(name, seed=5)
    cfg = e["cfg"]
    rng = np.random.default_rng(18)
    requests = {rid: rng.integers(0, cfg.vocab, size=12 if rid < 4 else 9
                                  ).astype(np.int32) for rid in range(6)}
    max_len = 12 + 3 + (cfg.vis_tokens if cfg.family == "vlm" else 0)
    want = JaxEngine(e["jm"], e["jp"], max_len=max_len,
                     log_dir=tmp_path / "jax", batch_size=2).serve(
        requests, n_new=3)
    reg = get_registry()

    def port():
        return ServeEngine(e["tm"], e["tp"], max_len=max_len,
                           log_dir=tmp_path / "port", batch_size=2,
                           device="cpu")
    first = port().serve(requests, n_new=3, crash_after_batches=1)
    assert sorted(first) == [4, 5]
    hits = reg.counter("serving_dedup_hits_total").value
    got = port().serve(requests, n_new=3)
    assert got == want and len(got) == 6
    assert reg.counter("serving_dedup_hits_total").value - hits == 2
    assert len(list((tmp_path / "port").glob("log_*.json"))) == 3


def test_checks_phase_holds_the_family_shapes_on_the_cpu():
    """The checks phase's new kernel shapes (non-causal whisper encoder
    and cross shapes with a ragged Sk, d = 64, GQA 6:1 over the vision
    prefix, the MoE archs' shapes, mamba2's N = 128 scan) and the four
    families' prefill/decode consistency, on the tiny archs."""
    sz, cpu = chip_smoke.SMALL, torch.device("cpu")
    shapes = chip_smoke.family_flash_shapes(sz)
    errs = chip_smoke.check_flash(sz, cpu)
    assert all(any(k.startswith(key + "_bf16") for k in errs)
               for key in shapes)
    full = chip_smoke.family_flash_shapes(chip_smoke.FULL)
    assert full["whisper_encoder"] == (4, 1500, 1500, 16, 16, 64, False, 0)
    assert full["whisper_cross"] == (4, 512, 1500, 16, 16, 64, False, 0)
    assert full["internvl2"] == (4, 768, 768, 48, 8, 128, True, 0)
    assert full["arctic"] == (4, 512, 512, 56, 8, 128, True, 0)
    assert full["qwen1_5"] == (4, 512, 512, 40, 40, 128, True, 0)
    assert full["gemma3_global"] == (4, 512, 512, 32, 16, 128, True, 0)
    assert full["gemma3_local"] == (4, 512, 512, 32, 16, 128, True, 1024)
    ssd = chip_smoke.check_ssd(sz, cpu)
    assert any(k.startswith("mamba2_") for k in ssd)
    for name in chip_smoke.CONSISTENCY_ARCHS:
        cons = chip_smoke.check_consistency(sz, cpu, 1, name)
        assert cons["arch"] == name and cons["max_abs_err"] < cons["tol"]
