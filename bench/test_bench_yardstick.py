"""The benchmark's frozen yardstick against the program's own formulas at
the shapes the cells run today: a later change to the program's
``work`` or peaks shows here, and never moves the benchmark's ruler."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench import families
from bench.harness import modelflops as MF
from bench.harness import traffic
from bench.harness import yardstick as Y

ROOT = Path(__file__).resolve().parent.parent
CONF = {n: json.loads((ROOT / "bench" / "configs" / f"{n}.json").read_text())
        for n in ("qwen3-1.7b", "mamba2-370m")}
SERVE = json.loads((ROOT / "bench" / "traffic" / "serve-docs.json")
                   .read_text())
# the served cell's groups: (requests of one length, prompt length)
GROUPS = sorted((traffic.call_lengths(SERVE["calls"]).count(L), L)
                for L in set(traffic.call_lengths(SERVE["calls"])))
SERVED = tuple(L for _, L in GROUPS)


def flash_shapes():
    m = CONF["qwen3-1.7b"]["model"]
    H, K, d = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    out = [((2, 4096, 4096, H, K, d), dict(causal=True, with_lse=True)),
           ((2, 4096, 4096, H, K, d), dict(causal=True, backward=True))]
    for n, L in GROUPS:
        n = min(n, SERVE["engine"]["batch_size"])
        out += [((n, L, L, H, K, d), dict(causal=True)),
                ((n, 1, L + 1, H, K, d), dict(causal=False)),
                ((4, L, L, H, K, d), dict(causal=True, window=1024))]
    return out


def ssd_shapes():
    m = CONF["mamba2-370m"]["model"]
    H = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    P, N, c = m["ssm_head_dim"], m["ssm_state"], m["ssm_chunk"]
    out = [((8, 4096, H, P, N, c), dict(with_states=True)),
           ((8, 4096, H, P, N, c), dict(backward=True)),
           ((32, 1, H, P, N, 1), {})]
    out += [((32, L, H, P, N, c), dict(init_state=True)) for L in SERVED]
    out += [((2, 4100, H, P, N, c), dict(init_state=True))]
    return out


@pytest.mark.parametrize("shape,kw", flash_shapes())
def test_flash_work_is_the_programs(shape, kw):
    from repro_torch.kernels.flash_attention.ops import work
    assert Y.flash_work(*shape, **kw) == work(*shape, **kw)


@pytest.mark.parametrize("shape,kw", ssd_shapes())
def test_ssd_work_is_the_programs(shape, kw):
    from repro_torch.kernels.ssd_scan.ops import work
    assert Y.ssd_work(*shape, **kw) == work(*shape, **kw)


def test_peaks_are_the_data_sheets():
    from repro_torch.launch import mesh
    assert Y.PEAK_BF16_FLOPS == mesh.PEAK_FLOPS_BF16 == 989e12
    assert Y.HBM_BYTES_PER_S == mesh.HBM_BW == 3.35e12


@pytest.mark.parametrize("name", sorted(CONF))
def test_matmul_weights_against_the_parameter_count(name):
    """Every parameter but the embedding's rows, the norms, the conv and
    the SSM's per-head scalars is a matmul weight a token passes through
    (the tied head counted once as a matmul)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    conf = CONF[name]
    m = conf["model"]
    cfg = dataclasses.replace(get_arch(conf["arch"]),
                              **conf["arch_overrides"])
    D, L = m["d_model"], m["n_layers"]
    other = 2 * D if m["family"] == "dense" else (
        cfg.ssm_conv * (cfg.d_inner + 2 * cfg.ssm_state) + 3 * cfg.ssm_heads
        + cfg.d_inner + D)
    fam = families.of(m)
    assert fam.matmul_weights(m) == cfg.n_params() - L * other
    assert round(fam.matmul_weights(m) / 1e6) == \
        {"qwen3-1.7b": 1720, "mamba2-370m": 368}[name]


def test_model_flops_count_no_recompute():
    m = CONF["qwen3-1.7b"]["model"]
    fam = families.of(m)
    fwd = 2 * fam.matmul_weights(m) * 4 * 4096 + fam.mixer_flops(
        m, 4, 4096, 4096, causal=True)
    assert MF.train_step_flops(m, 4, 4096) == 3 * fwd
    assert MF.serve_call_flops(m, 32, 512, 1) == \
        2 * fam.matmul_weights(m) * 32 * 512 + fam.mixer_flops(
            m, 32, 512, 512, causal=True)
    step = MF.serve_call_flops(m, 32, 512, 2) - MF.serve_call_flops(
        m, 32, 512, 1)
    assert step == 2 * fam.matmul_weights(m) * 32 + fam.mixer_flops(
        m, 32, 1, 513, causal=False)
