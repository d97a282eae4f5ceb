"""The port's zamba2 model (layers, Mamba2 block, hybrid stack, Model) on
``tiny(zamba2-7b)`` against the JAX package on the CPU, with the JAX
parameters carried across as numpy arrays (models/convert.py).

Everything is f32.  Tolerance 1e-4 (rtol and atol): both sides compute in
f32, with sums in other orders (the port's prefill attention is the plain
softmax where the reference scans KV chunks online, and the port's SSD
runs its own chunked plain version).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.registry import get_arch as jget_arch
from repro.configs.registry import tiny as jtiny
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro.models.model import build_model
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, MAX_LEN = 2, 37, 48          # S is not a multiple of the chunk (16)


@pytest.fixture(scope="module")
def env():
    jcfg = jtiny(jget_arch("zamba2-7b"))
    cfg = TR.tiny(TR.get_arch("zamba2-7b"))
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jp=jp, tm=Model(cfg), tp=tp,
                toks=toks)


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(kw or TOL))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_configs_are_the_references():
    for name in TR.ARCHS:
        j, t = jget_arch(name), TR.get_arch(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.head_dim, t.d_inner, t.ssm_heads, t.n_params()) == \
            (j.head_dim, j.d_inner, j.ssm_heads, j.n_params())
        assert dataclasses.asdict(TR.tiny(t)) == dataclasses.asdict(jtiny(j))
    assert sorted(TR.ARCHS) == sorted(JR.ARCHS)


def test_rms_norm_and_rope_match_jax():
    x, w = _x(1, 2, 5, 3, 32), _x(2, 32) * 0.1
    close(TL.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-6),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    pos = np.array([[0, 1, 2, 7, 100], [3, 4, 5, 6, 527]], np.int32)
    for theta in (1e4, 5e5):
        close(TL.rope(torch.as_tensor(x), torch.as_tensor(pos), theta),
              JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # halves, not interleaved pairs: column 0 rotates into column dh/2
    e = torch.zeros((1, 1, 1, 32))
    e[..., 0] = 1.0
    r = TL.rope(e, torch.tensor([[1]]), 1e4)[0, 0, 0]
    want = torch.zeros(32)
    want[0], want[16] = np.cos(1.0), np.sin(1.0)
    torch.testing.assert_close(r, want)


def test_self_attention_causal_and_decode_match_jax(env):
    cfg, jcfg = env["cfg"], env["jcfg"]
    jp = env["jp"]["blocks"]["shared"]["attn"]
    tp = env["tp"]["blocks"]["shared"]["attn"]
    x = _x(3, B, S, cfg.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    K, dh = cfg.n_kv_heads, cfg.head_dim
    jcache = {"k": jnp.zeros((B, MAX_LEN, K, dh)),
              "v": jnp.zeros((B, MAX_LEN, K, dh))}
    tcache = {"k": torch.zeros((B, MAX_LEN, K, dh)),
              "v": torch.zeros((B, MAX_LEN, K, dh))}
    jy, jc = JL.self_attention(jp, jnp.asarray(x), jcfg,
                               positions=jnp.asarray(pos), mode="causal",
                               cache=jcache)
    ty, tc = TL.self_attention(tp, torch.as_tensor(x), cfg,
                               positions=torch.as_tensor(pos),
                               mode="causal", cache=tcache)
    close(ty, jy)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    x1 = _x(4, B, 1, cfg.d_model)
    p1 = np.full((B, 1), S, np.int32)
    jy, jc = JL.self_attention(jp, jnp.asarray(x1), jcfg,
                               positions=jnp.asarray(p1), mode="decode",
                               cache=jc, cache_pos=S)
    ty, tc = TL.self_attention(tp, torch.as_tensor(x1), cfg,
                               positions=torch.as_tensor(p1), mode="decode",
                               cache=tc, cache_pos=S)
    close(ty, jy)
    close(tc["k"], jc["k"])


def test_bf16_decode_attention_rounds_its_scale_like_jax():
    """The reference divides the scores by sqrt(dh) rounded to bf16, in
    bf16 (sqrt(112) becomes 10.5625): the port's scores equal JAX's."""
    q, k, v = _x(10, 2, 1, 4, 112) * 3, _x(11, 2, 9, 2, 112), \
        _x(12, 2, 9, 2, 112)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    want = JL.attention_scores(*jb, None)
    got = TL.attention_scores(*tb, None)
    assert got.dtype == torch.bfloat16
    # an unrounded f32 scale moves these outputs by a bf16 step (1.6e-2)
    close(got.float(), np.asarray(want, np.float32), atol=5e-3, rtol=0)


def test_mamba_block_matches_jax_with_and_without_cache(env):
    cfg, jcfg = env["cfg"], env["jcfg"]
    jlp = jax.tree.map(lambda a: a[2], env["jp"]["blocks"]["mamba"])
    tlp = env["tp"]["blocks"]["mamba"][2]
    x = _x(5, B, S, cfg.d_model)
    jy, _ = JM.mamba_block(jlp, jnp.asarray(x), jcfg)
    ty, tnone = TM.mamba_block(tlp, torch.as_tensor(x), cfg)
    close(ty, jy)
    assert tnone is None
    # prefill into a cache, then one recurrent step
    jc = JM.init_ssm_cache(jcfg, B, jnp.float32)
    tc = TM.init_ssm_cache(cfg, B, torch.float32, "cpu")
    jy, jc = JM.mamba_block(jlp, jnp.asarray(x), jcfg, cache=jc)
    ty, tc = TM.mamba_block(tlp, torch.as_tensor(x), cfg, cache=tc)
    close(ty, jy)
    close(tc.state, jc.state)
    close(tc.conv, jc.conv)
    x1 = _x(6, B, 1, cfg.d_model)
    jy, jc = JM.mamba_block(jlp, jnp.asarray(x1), jcfg, cache=jc)
    ty, tc = TM.mamba_block(tlp, torch.as_tensor(x1), cfg, cache=tc)
    close(ty, jy)
    close(tc.state, jc.state)


def test_causal_conv_tail_and_softplus_match_jax(env):
    jlp = jax.tree.map(lambda a: a[0], env["jp"]["blocks"]["mamba"])
    tlp = env["tp"]["blocks"]["mamba"][0]
    cdim = jlp["conv_w"].shape[1]
    u, tail = _x(7, B, 5, cdim), _x(8, B, 3, cdim)
    jy, jt = JM._causal_conv(jlp, jnp.asarray(u), jnp.asarray(tail))
    ty, tt = TM._causal_conv(tlp, torch.as_tensor(u), torch.as_tensor(tail))
    close(ty, jy)
    np.testing.assert_array_equal(tt.numpy(), u[:, -3:])
    close(tt, jt)
    z = np.array([-30, -1, 0, 1, 19.5, 20.5, 30, 80], np.float32)
    np.testing.assert_array_equal(
        TM.softplus(torch.as_tensor(z)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(z))))


def test_hybrid_stack_matches_jax(env):
    cfg, jcfg = env["cfg"], env["jcfg"]
    x = _x(9, B, S, cfg.d_model)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jy, _ = JT.hybrid_stack(env["jp"]["blocks"], jnp.asarray(x), jcfg,
                            positions=jnp.asarray(pos), mode="causal")
    ty, _ = TT.hybrid_stack(env["tp"]["blocks"], torch.as_tensor(x), cfg,
                            positions=torch.as_tensor(pos), mode="causal")
    close(ty, jy)


def test_prefill_and_decode_logits_match_jax(env):
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
    close(tc["ssm"].state, jc["ssm"].state)
    close(tc["attn"]["k"], jc["attn"]["k"])
    np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl[:, -1], -1)))


def test_port_prefill_decode_consistency(env):
    """prefill(prompt[:S]) + one decode step equals prefill(prompt[:S+1])
    on the last position: the recurrent and chunked SSD and the decode
    and causal attention agree (f32, 1e-4)."""
    tm, tp, toks = env["tm"], env["tp"], torch.as_tensor(env["toks"])
    with torch.no_grad():
        _, c = tm.prefill(tp, {"tokens": toks[:, :S]}, MAX_LEN)
        dec, _ = tm.decode_step(tp, toks[:, S], c, S)
        full, _ = tm.prefill(tp, {"tokens": toks}, MAX_LEN + 1)
    torch.testing.assert_close(dec[:, 0], full[:, 0], **TOL)


def test_port_init_has_the_reference_names_shapes_and_scales(env):
    cfg = env["cfg"]
    own = env["tm"].init(torch.Generator().manual_seed(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(env["jp"]):
        keys = [k.key for k in path]
        if keys[:2] == ["blocks", "mamba"]:
            for i in range(leaf.shape[0]):
                want[".".join(keys[:2] + [str(i)] + keys[2:])] = \
                    (tuple(leaf.shape[1:]), leaf.dtype)
        else:
            want[".".join(keys)] = (tuple(leaf.shape), leaf.dtype)
    got = {n: (tuple(p.shape), p.dtype) for n, p in own.named_parameters()}
    assert set(got) == set(want)
    for n, (shape, dt) in want.items():
        assert got[n][0] == shape, n
        assert str(got[n][1]).replace("torch.", "") == str(dt), n
    assert dict(env["tp"].named_parameters()).keys() == got.keys()
    # dense_init's scales: std of each random leaf near its scale
    D, di, hd = cfg.d_model, cfg.d_inner, cfg.n_heads * cfg.head_dim
    scales = {"embed": 1.0, "lm_head": D ** -0.5,
              "blocks.mamba.0.in_proj": D ** -0.5,
              "blocks.mamba.0.conv_w": 0.5,
              "blocks.mamba.0.out_proj": di ** -0.5,
              "blocks.shared.attn.wq": D ** -0.5,
              "blocks.shared.attn.wo": hd ** -0.5,
              "blocks.shared.mlp.w_down": cfg.d_ff ** -0.5}
    params = dict(own.named_parameters())
    for n, scale in scales.items():
        std = float(params[n].std())
        assert abs(std / scale - 1) < 0.1, (n, std, scale)
    assert not params["blocks.mamba.0.ln"].any()
    assert bool((params["blocks.mamba.0.D"] == 1).all())


FAMILY_ARCH = {"moe": "qwen2-moe-a2.7b", "ssm": "mamba2-370m",
               "encdec": "whisper-medium", "vlm": "internvl2-26b"}


@pytest.mark.parametrize("family", ["moe", "ssm", "encdec", "vlm"])
def test_every_family_builds_and_converts(family):
    """``Model(cfg)``, ``init`` and ``params_from_numpy`` of the
    reference's tiny tree all succeed for each family that once waited
    for its slice, with the reference's leaf names (the stacked layer
    axes unrolled), shapes and dtypes."""
    name = FAMILY_ARCH[family]
    cfg, jcfg = TR.tiny(TR.get_arch(name)), jtiny(jget_arch(name))
    assert cfg.family == family
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        if keys[0] in ("blocks", "encoder"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i)] + keys[1:])] = \
                    (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            want[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    own = Model(cfg).init(torch.Generator().manual_seed(0))
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in own.named_parameters()}
    assert got == want
    conv = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
            for n, p in conv.named_parameters()} == want
