"""The slices as a whole: chip_smoke.py's map flow at small size on the
CPU against the JAX package end to end, its serve, model and checks phases
on the CPU, the port's import hygiene, and the no-card behaviour of its
entry points and of chip_smoke.py."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as JB
from repro.kernels.nvt_probe import ref as jref
from repro.kernels.nvt_probe.ops import nvt_probe as jax_probe

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as SSD  # noqa: E402


def test_map_flow_matches_jax_end_to_end():
    sz = chip_smoke.SMALL
    stream = chip_smoke.make_stream(sz, seed=3)
    out = chip_smoke.run_map(sz, stream, "cpu")
    js = JB.make_state(sz.capacity, sz.n_buckets)
    pre = jnp.asarray(stream["prefill"])
    js, jok, _ = JB.update_parallel(js, jnp.zeros_like(pre), pre, pre,
                                    sz.n_buckets)
    np.testing.assert_array_equal(out["prefill_ok"].numpy(), np.asarray(jok))
    for i, (ops, ks, vs, look) in enumerate(stream["rounds"]):
        js, jok, _ = JB.update_parallel(js, jnp.asarray(ops),
                                        jnp.asarray(ks), jnp.asarray(vs),
                                        sz.n_buckets)
        np.testing.assert_array_equal(out["ok"][i].numpy(), np.asarray(jok))
        for a, b in zip(JB.lookup(js, jnp.asarray(look), sz.n_buckets),
                        out["lookups"][i]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for f in JB.HashMapState._fields:
        np.testing.assert_array_equal(getattr(out["state"], f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    jk, jv = jref.tiles_from_hashmap(js, sz.n_buckets, sz.cap)
    np.testing.assert_array_equal(out["tiles"][0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(out["tiles"][1].numpy(), np.asarray(jv))
    jf, jv2 = jax_probe(jk, jv, jnp.asarray(stream["queries"]), impl="xla")
    np.testing.assert_array_equal(out["probe"][0].numpy(), np.asarray(jf))
    np.testing.assert_array_equal(out["probe"][1].numpy(), np.asarray(jv2))
    # and the script's own checks (dict replay, kernel vs plain, oracle)
    checks = chip_smoke.check_map(sz, stream, out)
    assert checks["max_abs_err"] == 0


def test_ordered_phase_matches_jax_end_to_end():
    """chip_smoke.py's ordered phase at small size on the CPU: the final
    state, ok flags and lookups equal the JAX engine's on the same stream
    (towers rebuilt after every batch in both), the range batch equals
    the JAX range_query bound by bound, and the script's own checks
    pass."""
    from repro.core import ordered as JO
    sz = chip_smoke.SMALL
    stream = chip_smoke.make_stream(sz, seed=3)
    out = chip_smoke.run_ordered(sz, stream, "cpu", 3)
    js = JO.make_ordered(sz.capacity)
    pre = stream["prefill"]
    js, jok, _ = JO.update_parallel_ordered(js, np.zeros_like(pre), pre,
                                            pre, towers=JO.build_towers(js))
    np.testing.assert_array_equal(out["prefill_ok"].numpy(), np.asarray(jok))
    for i, (ops, ks, vs, look) in enumerate(stream["rounds"]):
        js, jok, _ = JO.update_parallel_ordered(js, ops, ks, vs,
                                                towers=JO.build_towers(js))
        np.testing.assert_array_equal(out["ok"][i].numpy(), np.asarray(jok))
        for a, b in zip(JO.lookup_ordered(js, jnp.asarray(look),
                                          JO.build_towers(js)),
                        out["lookups"][i]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for f in JO.OrderedState._fields:
        np.testing.assert_array_equal(getattr(out["state"], f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    lo, hi = out["bounds"]
    jtw = JO.build_towers(js)
    for i in range(0, sz.ranges, 7):
        for a, b in zip(JO.range_query(js, int(lo[i]), int(hi[i]),
                                       sz.max_items, jtw),
                        (x[i] for x in out["ranges"])):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(JO.top_k(js, sz.top_k), out["top_k"]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    got = chip_smoke.check_ordered(sz, stream, out)
    assert got["live_keys"] > 0 and got["check_ops_committed"] > 0
    assert out["steps"]["prefill"] == 1


def test_durable_and_migrate_phases_recover_on_the_cpu():
    cpu = torch.device("cpu")
    dur = chip_smoke.run_durable_ordered(chip_smoke.SMALL, cpu, 3)
    assert dur["crash_site"]["target"] == "ord_000007.json"
    assert dur["snapshot_horizon"] == 5 and dur["journal_bytes"] > 0
    mig = chip_smoke.run_migrate(chip_smoke.SMALL, cpu, 3)
    assert mig["crash_site"]["target"] == "mig_0001/round_000008.npz"
    assert mig["new"] == [2 * chip_smoke.SMALL.mig_capacity,
                          2 * chip_smoke.SMALL.mig_buckets]
    assert mig["recovered"]["n_rounds"] == 8
    assert mig["recovered"]["frontier"] == 4 * chip_smoke.SMALL.mig_bpr
    assert mig["drained_keys"] > 0 and mig["pulls"] > 0


def test_crash_phase_sweeps_every_scenario_on_the_cpu():
    got = chip_smoke.run_crash(torch.device("cpu"))
    assert {k: v["n_sites"] for k, v in got.items()} == chip_smoke.CRASH_SITES
    assert all(v["failures"] == 0 and v["runs"] == 3 * v["n_sites"]
               for v in got.values())


def test_serve_phase_holds_exactly_once_on_the_cpu():
    got = chip_smoke.run_serve(chip_smoke.SMALL, "cpu")
    assert got["dedup_migrations"] >= 1 and got["evicted"] > 0
    sharded = chip_smoke.run_sharded_serve(chip_smoke.SMALL, "cpu")
    assert sharded["shards"] == 4 and sharded["dedup_migrations"] >= 1
    assert sharded["kept"] + sharded["evicted"] == sharded["rids"]


def test_sharded_phase_matches_the_map_phase_on_the_cpu():
    """chip_smoke.py's sharded phase at small size: the 4-shard map holds
    the map phase's results (its own checks raise otherwise), and the
    live rebalance triggers, crashes at its 5th journaled round and
    recovers to the twin."""
    sz, cpu = chip_smoke.SMALL, torch.device("cpu")
    stream = chip_smoke.make_stream(sz, seed=3)
    out = chip_smoke.run_map(sz, stream, cpu)
    got = chip_smoke.run_sharded(sz, stream, out, cpu)
    assert got["splits"] == [i * sz.n_buckets // 4 for i in range(5)]
    assert (got["flushes"], got["fences"]) == (int(out["state"].flushes),
                                               int(out["state"].fences))
    live = chip_smoke.run_live_rebalance(sz, cpu, 3)
    assert live["rebalances"] >= 1 and live["trigger_imbalance"] > 1.3
    assert live["crash"]["site"]["target"] == "reb_0001/round_000004.npz"
    assert live["splits"][1] < sz.n_buckets // 4     # the hot range shrank


def test_checkpoint_phase_restores_step_3_on_the_cpu():
    got = chip_smoke.run_checkpoint(chip_smoke.SMALL,
                                    torch.device("cpu"), 3)
    assert got["recovered_step"] == 3 and got["bit_identical"]
    assert got["fences"]["nvtraverse"] == 4          # one a save
    assert got["fences"]["izraelevitz"] == got["leaves"] + 3 + 4


_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
want = {"repro_torch.kernels._build", "repro_torch.models.model",
        "repro_torch.models.convert", "repro_torch.launch.serve",
        "repro_torch.kernels.flash_attention.kernel",
        "repro_torch.kernels.ssd_scan.kernel", "repro_torch.configs.registry",
        "repro_torch.core.ordered", "repro_torch.core.skiplist",
        "repro_torch.robustness", "repro_torch.robustness.faultinject",
        "repro_torch.core.sharded", "repro_torch.core.rebalance",
        "repro_torch.launch.mesh", "repro_torch.persistence.checkpoint",
        "repro_torch.core.pmem", "repro_torch.core.instr",
        "repro_torch.core.policies", "repro_torch.core.traversal",
        "repro_torch.core.harris_list", "repro_torch.core.hash_table",
        "repro_torch.core.bst", "repro_torch.core.queue",
        "repro_torch.core.stack", "repro_torch.core.scheduler",
        "repro_torch.core.linearizability", "repro_torch.analysis",
        "repro_torch.analysis.trace", "repro_torch.analysis.checker",
        "repro_torch.analysis.persistlint", "repro_torch.obs.windows",
        "repro_torch.obs.timeline", "repro_torch.obs.loadgen",
        "repro_torch.configs.qwen2_7b", "repro_torch.configs.gemma3_27b",
        "repro_torch.models.moe", "repro_torch.models.frontends",
        "repro_torch.configs.qwen2_moe_a2_7b",
        "repro_torch.configs.arctic_480b", "repro_torch.configs.mamba2_370m",
        "repro_torch.configs.whisper_medium",
        "repro_torch.configs.internvl2_26b"}
print(sorted(want - set(names)))
sys.exit(1 if bad or len(names) < 59 or want - set(names) else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(ROOT)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_model_phase_serves_exactly_once_on_the_cpu():
    """chip_smoke.py's model phase on tiny(zamba2-7b): two prefills (one
    per engine), four dedup hits after the crash, one record a batch."""
    got = chip_smoke.run_model(chip_smoke.SMALL, torch.device("cpu"), 3)
    assert (got["prefills"], got["dedup_hits"], got["records"]) == (2, 4, 2)
    assert got["launches"] == {"flash_attention": 0, "ssd_scan": 0,
                               "nvt_probe": 0}      # the CPU launches none
    assert len(got["decode_step_s"]) == 2 * chip_smoke.SMALL.new_tokens


def test_families_phase_serves_every_family_exactly_once_on_the_cpu():
    """chip_smoke.py's families phase on the tiny archs: each served
    through a crash (two prefills, four dedup hits, one record a batch),
    no kernel launched on the CPU, and the launch counts a prefill the
    card must see computed from the configs."""
    got = chip_smoke.run_families(chip_smoke.SMALL, torch.device("cpu"), 3)
    assert [a["arch"] for a in got["archs"]] == list(chip_smoke.FAMILY_ARCHS)
    for a in got["archs"]:
        assert (a["prefills"], a["dedup_hits"], a["records"]) == (2, 4, 2)
        assert a["launches"] == {"flash_attention": 0, "ssd_scan": 0,
                                 "nvt_probe": 0}
    # on the card: full width, arctic-480b cut to one layer; gemma3-27b's
    # 62 launches a prefill are 52 local layers (window 1024) and 10 global
    full = {n: chip_smoke.model_config(chip_smoke.FULL, n)
            for n in chip_smoke.FAMILY_ARCHS}
    assert {n: (chip_smoke.attn_launches_per_prefill(c),
                chip_smoke.ssd_launches_per_prefill(c))
            for n, c in full.items()} == {
        "qwen2-moe-a2.7b": (24, 0), "mamba2-370m": (0, 48),
        "whisper-medium": (72, 0), "internvl2-26b": (48, 0),
        "arctic-480b": (1, 0), "qwen1.5-32b": (64, 0),
        "gemma3-27b": (62, 0)}
    assert chip_smoke.layer_windows(full["gemma3-27b"]) == {1024: 52, 0: 10}
    assert chip_smoke.layer_windows(full["qwen1.5-32b"]) == {0: 64}
    tiny_gemma = next(a for a in got["archs"] if a["arch"] == "gemma3-27b")
    assert tiny_gemma["layers_by_window"] == {16: 4}   # no global layer
    reduced, = chip_smoke.families_reduced(chip_smoke.FULL)
    assert reduced.startswith("arctic-480b: n_layers 35 -> 1")
    assert "14.1 B parameters" in reduced


def test_checks_phase_runs_on_the_cpu():
    sz, cpu = chip_smoke.SMALL, torch.device("cpu")
    assert set(chip_smoke.check_flash(sz, cpu)) >= {"bf16_S40", "bf16_S37"}
    ssd = chip_smoke.check_ssd(sz, cpu)
    assert {"bfloat16_S37_y_vs_ref", "float32_S40_state_vs_chunked",
            "bfloat16_S40_chunked_bf16_vs_ref"} <= set(ssd)
    cons = chip_smoke.check_consistency(sz, cpu, 1)
    assert cons["max_abs_err"] < cons["tol"] and cons["shared_attn_calls"]


@pytest.fixture
def one_torch_thread():
    """The train phase's tiny steps on one intra-op thread: the suite's
    parallel workers share the cores, and with 8 threads each step waits
    on threads other workers hold (tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
def test_train_phase_trains_twice_alike_and_resumes_on_the_cpu():
    """chip_smoke.py's train phase at SMALL on tiny(qwen3-1.7b), then
    tiny(mamba2-370m) and tiny(zamba2-7b): two runs from one seed with the
    same losses, every layer's attention (or A_log and dt_bias) gradients
    nonzero, no kernel launched on the CPU, and the crash/resume recipe in
    f32 and bf16; the full-size phase's configs, shapes and the launches a
    step the card must count."""
    sz = chip_smoke.SMALL
    got = chip_smoke.run_train(sz, torch.device("cpu"), 3)
    assert got["rerun_losses_equal"] and len(got["losses"]) == \
        sz.train_steps and got["microbatches"] == 2
    assert got["attn_grad_leaves_nonzero"] == 4 * 5
    none = {"flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": 0,
            "ssd_scan_bwd": 0}
    assert got["launches"] == none
    assert sorted(got["recipe"]) == ["bfloat16", "float32"]
    assert all(r["resumed_steps"] == 20 for r in got["recipe"].values())
    for arch, layers, micro in (("mamba2-370m", 4, 2), ("zamba2-7b", 7, 4)):
        a = got[arch]
        assert a["rerun_losses_equal"] and a["launches"] == none
        assert (a["n_layers"], a["microbatches"]) == (layers, micro)
        assert a["ssm_grad_leaves_nonzero"] == layers * 2
        assert sorted(a["recipe"]) == ["bfloat16", "float32"]
        assert all(r["resumed_steps"] == 20 for r in a["recipe"].values())
    full = chip_smoke.train_config(chip_smoke.FULL)
    # the MoE arch: its attention leaves are wq, wk, wv and the QKV
    # biases (no head norms); every router and expert tensor nonzero too
    moe = got["qwen2-moe-a2.7b"]
    assert moe["rerun_losses_equal"] and moe["launches"] == none
    assert (moe["n_layers"], moe["microbatches"]) == (4, 4)
    assert (moe["attn_grad_leaves_nonzero"],
            moe["moe_grad_leaves_nonzero"]) == (4 * 6, 4 * 4)
    assert sorted(moe["recipe"]) == ["bfloat16", "float32"]
    assert all(r["resumed_steps"] == 20 for r in moe["recipe"].values())
    arctic = got["arctic-480b"]
    assert all(r["resumed_steps"] == 20 for r in arctic["recipe"].values())
    assert arctic["bf16_optimizer"]["accumulator_bitwise"]
    assert arctic["bf16_optimizer"]["opt_dtype"] == "bfloat16"
    assert (full.n_layers, full.microbatches, full.remat,
            full.compute_dtype) == (28, 2, "block", "bfloat16")
    assert chip_smoke.train_shape(chip_smoke.FULL) == \
        (2, 4096, 4096, 16, 8, 128, True)
    assert any("global batch 256 -> 4" in r
               for r in chip_smoke.train_reduced(chip_smoke.FULL))
    # mamba2-370m at full width and depth, zamba2-7b cut 81 -> 24 layers
    fm, fz = (chip_smoke.train_config(chip_smoke.FULL, a)
              for a in chip_smoke.SSM_TRAIN_ARCHS)
    assert (fm.n_layers, fm.microbatches, fz.n_layers, fz.microbatches) == \
        (48, 2, 24, 4)
    assert chip_smoke.ssd_train_shape(chip_smoke.FULL, "mamba2-370m") == \
        (2, 4096, 32, 64, 128, 128)
    assert chip_smoke.ssd_train_shape(chip_smoke.FULL, "zamba2-7b") == \
        (1, 4096, 112, 64, 64, 128)
    assert chip_smoke.train_shape(chip_smoke.FULL, "zamba2-7b") == \
        (1, 4096, 4096, 32, 32, 112, True)
    assert chip_smoke.train_launches(fm, 1) == {
        "flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": 192,
        "ssd_scan_bwd": 96}
    assert chip_smoke.train_launches(fz, 1) == {
        "flash_attention": 32, "flash_attention_bwd": 16, "ssd_scan": 192,
        "ssd_scan_bwd": 96}
    assert any(r.startswith("n_layers 81 -> 24") for r in
               chip_smoke.train_reduced(chip_smoke.FULL, "zamba2-7b"))
    # qwen2-moe-a2.7b at full width cut 24 -> 4 layers (2.90 B), 4
    # microbatches of [1, 4096]: 2 x 4 x 4 flash forwards and 4 x 4
    # backward pairs a step, MHA 16:16 at d = 128
    fq = chip_smoke.train_config(chip_smoke.FULL, "qwen2-moe-a2.7b")
    assert (fq.n_layers, fq.microbatches) == (4, 4)
    assert round(fq.n_params() / 1e7) == 290
    assert chip_smoke.train_shape(chip_smoke.FULL, "qwen2-moe-a2.7b") == \
        (1, 4096, 4096, 16, 16, 128, True)
    assert chip_smoke.train_launches(fq, 1) == {
        "flash_attention": 32, "flash_attention_bwd": 16}
    assert any(r.startswith("n_layers 24 -> 4") for r in
               chip_smoke.train_reduced(chip_smoke.FULL, "qwen2-moe-a2.7b"))


@pytest.mark.usefixtures("one_torch_thread")
def test_train_checks_run_on_the_cpu():
    """The checks phase's backward checks (every shape, bf16 and f32, the
    no-visible-key rows with +inf lse) and the f32 gradient check on the
    CPU, where both sides are the plain versions."""
    sz, cpu = chip_smoke.SMALL, torch.device("cpu")
    bwd = chip_smoke.check_flash_bwd(sz, cpu)
    assert set(bwd) == {f"{k}_{t}" for k in chip_smoke.flash_bwd_shapes(sz)
                        for t in ("bfloat16", "float32")}
    assert bwd["no_visible_key_float32"]["inf_rows"] > 0
    assert bwd["whisper_cross_bfloat16"]["shape"][1:3] == [37, 24]
    # the route each shape would take on the card (SMALL's head dims, 32
    # and 8, go to the mma.sync pair, as d = 100 does; d = 96 to the wgmma
    # pair) and two calls' same bits
    assert {k: v["route"] for k, v in bwd.items()} == {
        f"{k}_{t}": ("wgmma" if k == "d96_wgmma" else "mma_sync")
        if t == "bfloat16" else "scalar"
        for k in chip_smoke.flash_bwd_shapes(sz)
        for t in ("bfloat16", "float32")}
    assert all(v["bitwise_repeat"] for v in bwd.values())
    cons = chip_smoke.check_train_consistency(sz, cpu, 1)
    assert cons["n_layers"] == 2 and cons["worst_grad_rel_err"] <= \
        cons["tol"]
    # the SSD backward's checks: every shape, both dtypes, the ragged one
    # with an init_state; and the SSM and hybrid gradient checks
    ssd = chip_smoke.check_ssd_bwd(sz, cpu)
    assert set(ssd) == {f"{k}_{t}" for k in chip_smoke.ssd_bwd_shapes(sz)
                        for t in ("bfloat16", "float32")}
    assert all(v["bitwise_repeat"] for v in ssd.values())
    assert "dinit_vs_plain" in ssd["ragged_init_bfloat16"]
    assert ssd["ragged_init_float32"]["shape"][1] % \
        ssd["ragged_init_float32"]["shape"][5]
    for arch, layers in (("mamba2-370m", 2), ("zamba2-7b", 6),
                         ("qwen2-moe-a2.7b", 2)):
        cons = chip_smoke.check_train_consistency(sz, cpu, 1, arch)
        assert cons["n_layers"] == layers and \
            cons["worst_grad_rel_err"] <= cons["tol"]
    # the MoE's capacity factor raised so that nothing drops
    assert cons["capacity_factor"] >= 8 / 2


def test_the_card_checks_both_bf16_backward_routes():
    """At full size the backward check's bf16 shapes take the wgmma pair
    at d = 128 (the training shape, gemma3's window), zamba2's d = 112
    and d = 96 (128-column tiles) and d = 64 (whisper's cross shape), and
    the mma.sync pair at d = 100 (not a multiple of 8) and the
    no-visible-key rows' d = 8."""
    shapes = chip_smoke.flash_bwd_shapes(chip_smoke.FULL)
    assert {k: chip_smoke.fa_kernel.bwd_route(v[5], torch.bfloat16)
            for k, v in shapes.items()} == {
        "qwen3_train": "wgmma", "zamba2_train": "wgmma",
        "qwen2_moe_train": "wgmma", "zamba2_d112": "wgmma",
        "whisper_cross": "wgmma", "gemma3_window": "wgmma",
        "no_visible_key": "mma_sync", "d96_wgmma": "wgmma",
        "d100_mma_sync": "mma_sync"}


@pytest.mark.usefixtures("one_torch_thread")
def test_compressed_reduce_and_gpipe_checks_run_on_the_cpu():
    """The checks phase's two new entries at SMALL: the compressed reduce
    (the replica form at 4 replicas the CPU's bits, the gloo form at world
    size 1 equal to the replica form, the 50-step feedback sum) and GPipe
    against the sequential stack; the full-size shapes they run on the
    card."""
    sz, cpu = chip_smoke.SMALL, torch.device("cpu")
    red = chip_smoke.check_compressed_grads(sz, cpu, 1)
    assert red["replica_bitwise_vs_cpu"] and red["group_backend"] == "gloo"
    assert red["group_world_1_equals_replica"]
    assert red["feedback_rel_err"] <= 1e-3
    pipe = chip_smoke.check_gpipe(sz, cpu, 1)
    assert pipe["ticks"] == 8 + 4 - 1 and pipe["max_rel_err"] <= pipe["tol"]
    full = chip_smoke.FULL
    assert (full.reduce_replicas, full.reduce_elems) == (4, 2 ** 26)
    assert (full.gpipe_stages, full.gpipe_layers, full.gpipe_d,
            full.gpipe_ff, full.gpipe_micro, full.gpipe_batch,
            full.gpipe_seq) == (4, 2, 2048, 8192, 8, 2, 512)


def test_flash_bounds_at_the_new_serve_shapes():
    """The bounds the issue reckons for the new shapes: qwen1.5-32b's MHA
    40:40 prefill (83.9 MB, 0.0250 ms at 3.35 TB/s) and gemma3-27b's
    (50.3 MB, 0.0150 ms; a window of 1024 over 512 tokens sees every
    causal pair), and a window shorter than the sequence counting each
    query's last ``window`` keys."""
    shapes = chip_smoke.family_flash_shapes(chip_smoke.FULL)
    for key, mb in (("qwen1_5", 83.9), ("gemma3_global", 50.3),
                    ("gemma3_local", 50.3)):
        B, Sq, Sk, H, K, d, causal, window = shapes[key]
        nbytes = 2 * (B * Sq * H * d + B * Sk * K * d) * 2
        assert round(nbytes / 1e6, 1) == mb
        # the timing phase's bound reads the kernel's own work formula
        assert FA.work(B, Sq, Sk, H, K, d, causal=causal,
                       window=window)["bytes"] == nbytes
    assert shapes["gemma3_local"][-1] == 1024
    assert FA.visible_pairs(512, 512, True, 1024) == 512 * 513 // 2
    assert FA.visible_pairs(8, 8, True, 3) == 6 + 5 * 3
    assert FA.visible_pairs(4, 6, False) == 24


def test_launches_at_tells_windows_and_cross_shapes_apart():
    """run_model's rows carry the window: a local layer's launches count
    at the windowed shape only, with either prompt length, and a cross
    shape only where Sk differs from Sq."""
    rows = [[4, 500, 500, 32, 16, 128, True, 0, 10],
            [4, 500, 500, 32, 16, 128, True, 1024, 52],
            [4, 512, 512, 32, 16, 128, True, 0, 10],
            [4, 512, 512, 32, 16, 128, True, 1024, 52],
            [4, 512, 1500, 32, 16, 128, False, 0, 7]]
    local = (4, 512, 512, 32, 16, 128, True, 1024)
    assert chip_smoke.launches_at(rows, local) == 104
    assert chip_smoke.launches_at(rows, local[:-1] + (0,)) == 20
    assert chip_smoke.launches_at(rows, (4, 512, 1500, 32, 16, 128, False,
                                         0)) == 7


def test_flash_bounds_at_the_training_shape():
    """The bounds reckoned for the training shape: the forward's 137
    GFLOP (0.139 ms at 989 TFLOP/s), the backward's least work 2.5x that
    (0.347 ms), the two-kernel split's 3.5x (481 GFLOP); compute-bound."""
    shape = chip_smoke.train_shape(chip_smoke.FULL)
    b = chip_smoke.flash_bwd_bounds(shape)
    fwd = 4 * 128 * 2 * 16 * (4096 * 4097 // 2)
    assert round(fwd / 1e9) == 137
    assert b["pair"]["flops"] == 2.5 * fwd
    assert b["dq"]["flops"] + b["dkdv"]["flops"] == 3.5 * fwd
    assert abs(b["pair"]["bound_ms"] - 0.3475) < 1e-4
    assert all(v["bound_by"] == "operations" for v in b.values())


def test_ssd_flop_count_matches_the_chunk_gemms():
    # one full chunk: C B^T and scores x on the lower triangle, C S^T and
    # the state update in full
    B, H, P, N, Q = 1, 1, 4, 2, 8
    tri = Q * (Q + 1) // 2
    flops = lambda S: SSD.work(B, S, H, P, N, Q)["flops"]
    assert flops(Q) == 2 * N * tri + 2 * P * tri + 4 * Q * N * P
    # a ragged last chunk counts only its own tokens
    assert flops(Q + 3) == flops(Q) + flops(3)


def test_ssd_backward_bound_at_the_training_shapes():
    """The SSD backward's least work at mamba2-370m's training shape:
    30.3 GFLOP, 0.0306 ms at the bf16 peak, below the 0.053 ms its 178 MB
    take at 3.35 TB/s (its inputs read once, the forward's f32 chunk
    states among them, and its outputs written once): bound by bytes; at
    zamba2-7b's the same (241 MB, 0.072 ms)."""
    bound = lambda *shape: chip_smoke.bound_of(SSD.work(*shape,
                                                        backward=True))
    b = bound(2, 4096, 32, 64, 128, 128)
    assert round(b["flops"] / 1e8) == 303 and round(b["bytes"] / 1e6) == 178
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 0.0532) < 1e-3
    z = bound(1, 4096, 112, 64, 64, 128)
    assert z["bound_by"] == "bytes"
    # one chunk by hand: C B^T once, then per head two products over P and
    # two over N on the triangle and four [q, P] x [P, N]-sized ones
    q, tri = 8, 36
    assert bound(1, q, 2, 4, 2, q)["flops"] == \
        2 * 2 * tri + 2 * (4 * 4 * tri + 4 * 2 * tri + 8 * q * 4 * 2)


def _keys_in_buckets(nb):
    """The first few positive keys of each bucket of ``nb``."""
    out = {}
    for k in range(1, 200):
        out.setdefault(int(jref.mix32_np(k) % np.uint32(nb)), []).append(k)
    return out


@pytest.mark.parametrize("cap", [8, 12])
def test_probe_bytes_counts_a_hand_made_tile(cap):
    """Rows 0 and 1 touched (row 0 by three queries), four hit slots of
    which two are one key stored twice, five queries.  At cap 8 a row is
    one 32-byte sector; at cap 12 rows 0 and 1 share their middle one."""
    nb = 4
    by = _keys_in_buckets(nb)
    a, b = by[0][:2]
    c = by[1][0]
    kt = torch.zeros((nb, cap), dtype=torch.int32)
    vt = torch.arange(nb * cap, dtype=torch.int32).view(nb, cap)
    kt[0, 0], kt[0, 5], kt[0, 6] = a, b, b
    q = torch.tensor([a, a, b, c, c], dtype=torch.int32)
    for t in (kt, vt, q):
        assert t.data_ptr() % 64 == 0     # the host allocator's alignment
    got = chip_smoke.probe_bytes(kt, vt, q)
    assert got["distinct_rows"] == 2 and got["hit_slots"] == 4
    assert got["bytes"] == 2 * cap * 4 + 5 * 4 + 4 * 4 + 2 * 5 * 4
    assert got["bytes_row_per_query"] == 5 * cap * 4 + 3 * 5 * 4 + 4 * 4
    assert got["row_sectors"] == (2 if cap == 8 else 3)
    assert got["hit_sectors"] == 1        # slots 0, 5, 6 of row 0
    assert got["bytes_sectors"] == 32 * (got["row_sectors"] + 1 + 3)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.configs.registry import get_arch, tiny
    from repro_torch.core import batched as TB
    from repro_torch.core import ordered as TO
    from repro_torch.core.migrate import MigratingMap
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.persistence.index import (MembershipIndex,
                                               OrderedMembershipIndex)
    from repro_torch.robustness.faultinject import SCENARIOS, CrashPlan
    from repro_torch.serving.engine import RequestLog, ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TB.make_state(8, 4), lambda: MembershipIndex(8),
                 lambda: RequestLog(tmp_path),
                 lambda: RequestLog(tmp_path, ordered_dedup=True),
                 lambda: TO.make_ordered(8),
                 lambda: TO.DurableOrderedMap(tmp_path / "ord"),
                 lambda: OrderedMembershipIndex(8),
                 lambda: MigratingMap(8, 4),
                 lambda: MigratingMap.recover(tmp_path / "mig")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for cls in SCENARIOS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(tmp_path / cls.layer, CrashPlan()).run()
    model = Model(tiny(get_arch("zamba2-7b")))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, max_len=8, log_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--log-dir", str(tmp_path)])


def test_serve_cli_recovers_after_a_crash_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve
    args = ["--device", "cpu", "--log-dir", str(tmp_path), "--requests",
            "6", "--prompt-len", "10", "--new-tokens", "3"]
    serve.main(args + ["--crash-after", "1"])
    assert '"committed": 4' in capsys.readouterr().out
    serve.main(args)
    assert '"committed": 6' in capsys.readouterr().out


@pytest.mark.parametrize("module", [
    "repro_torch.core.batched", "repro_torch.core.pmem",
    "repro_torch.obs.metrics", "repro_torch.core.ordered",
    "repro_torch.core.skiplist", "repro_torch.core.migrate",
    "repro_torch.robustness.faultinject", "repro_torch.obs.windows",
    "repro_torch.obs.timeline", "repro_torch.obs.loadgen"])
def test_port_doctests(module):
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(module))
    assert res.attempted > 0 and res.failed == 0


def test_first_call_tracker_times_each_new_signature_once():
    """The port's tracker (no JAX): one event per fresh argument shape,
    attributed to the active reason, and the migrate seam records the
    capacity ladder."""
    from repro_torch.obs.compile import CompileTracker
    from repro_torch.obs.metrics import MetricsRegistry
    trk = CompileTracker(registry=MetricsRegistry())
    fn = trk.instrument("t.sum", "k", lambda x: x.sum())
    fn(torch.ones(4))
    fn(torch.ones(4))
    with trk.reason("capacity_ladder"):
        fn(torch.ones(8))
    assert [e.trigger for e in trk.events] == ["steady", "capacity_ladder"]
    assert trk.stats()["steady"]["events"] == 1


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_alone(tmp_path, alone):
    """No card (or no repo beside the script): non-zero exit, no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__c275b1f3_11_ssd_scan_cu_18d893fe11ssd_scan_tcILi8EEEvPK13__nv_bfloat16PKfS5_S3_S3_S5_PS1_Pfiiiiixxxxxxi' for 'sm_90a'
    16 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__c275b1f3_11_ssd_scan_cu_18d893fe14ssd_chunk_scanIfEEvPKT_PKfS5_S3_S3_S5_PS1_Pfiiiiixxxxxx' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers
"""
_SASS = """\
\t\tFunction : _ZN44_GLOBAL__N__c275b1f3_11_ssd_scan_cu_18d893fe14ssd_chunk_scanIfEEvPKT_PKfS5_S3_S3_S5_PS1_Pfiiiiixxxxxx
        /*0070*/                   FFMA R1, R2, R3, R1 ;
\t\tFunction : _ZN44_GLOBAL__N__c275b1f3_11_ssd_scan_cu_18d893fe11ssd_scan_tcILi8EEEvPK13__nv_bfloat16PKfS5_S3_S3_S5_PS1_Pfiiiiixxxxxxi
        /*0a70*/                   HMMA.16816.F32.BF16 R40, R12, R20, R40 ;
        /*0a80*/                   HMMA.16816.F32.BF16 R44, R12, R22, R44 ;
        /*0a90*/                   LDSM.16.MT88.4 R4, [R2] ;
		Function : _ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_23f0aea715flash_bwd_dq_wgILi128EEEv14CUtensorMap_stS1_S1_S1_PK13__nv_bfloat16S4_PKfPS2_Pfiiiiiiff
        /*1a70*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*1a80*/                   HGMMA.64x128x16.F32.BF16 R88, R140, gdesc[UR8], R88, gsb0 ;
"""


def test_build_report_reads_registers_spills_and_tensor_core_instructions(
        monkeypatch):
    """The build phase's per-function report from a ptxas -v report and
    cuobjdump's SASS (neither tool runs here: the SASS is given)."""
    monkeypatch.setattr(chip_smoke._build, "_nvcc",
                        lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(
                            cmd, 0, stdout=_SASS))
    got = chip_smoke.build_report(Path("ssd_scan.so"), _PTXAS)
    assert got == [
        {"kernel": "flash_bwd_dq_wg<128>", "registers": None,
         "spill_bytes": None, "tensor_core_instr": 2, "hgmma_instr": 2},
        {"kernel": "ssd_chunk_scan<float>", "registers": 60,
         "spill_bytes": 0, "tensor_core_instr": 0, "hgmma_instr": 0},
        {"kernel": "ssd_scan_tc<8>", "registers": 168, "spill_bytes": 16,
         "tensor_core_instr": 2, "hgmma_instr": 0}]


def test_the_build_phase_holds_the_wgmma_backward_to_hgmma_and_no_spill():
    """``check_wgmma_bwd_build`` passes when every function of the wgmma
    backward pair (dq and dkdv at d = 64 and 128) has HGMMA and no spill,
    and fails on a missing one, one without HGMMA, or a spill."""
    names = ["flash_bwd_dq_wg<64>", "flash_bwd_dq_wg<128>",
             "flash_bwd_dkdv_wg<64>", "flash_bwd_dkdv_wg<128>"]
    assert sorted(chip_smoke.WGMMA_BWD_FUNCTIONS) == sorted(names)

    def rows(**bad):
        return [{"kernel": n, "registers": 168, "spill_bytes": 0,
                 "tensor_core_instr": 24, "hgmma_instr": 24,
                 **(bad if n == "flash_bwd_dkdv_wg<128>" else {})}
                for n in names] + [{"kernel": "flash_bwd_dq_tc<112>",
                                    "registers": 238, "spill_bytes": 8,
                                    "tensor_core_instr": 168,
                                    "hgmma_instr": 0}]
    assert set(chip_smoke.check_wgmma_bwd_build(rows())) == set(names)
    with pytest.raises(AssertionError, match="lacks"):
        chip_smoke.check_wgmma_bwd_build(rows()[1:])
    with pytest.raises(AssertionError, match="no HGMMA"):
        chip_smoke.check_wgmma_bwd_build(rows(hgmma_instr=0))
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_wgmma_bwd_build(rows(spill_bytes=4))


def test_the_build_phase_holds_the_ssd_backward_to_hgmma_and_no_spill():
    """``check_ssd_bwd_build`` passes when each wgmma pass of the SSD
    backward (the delta and chunk passes at one and two 64-column boxes
    of N) has HGMMA and no spill, whatever the scalar passes do, and
    fails on a missing one, one without HGMMA, or a spill."""
    names = ["ssd_bwd_delta_wg<1>", "ssd_bwd_delta_wg<2>",
             "ssd_bwd_chunk_wg<1>", "ssd_bwd_chunk_wg<2>"]
    assert sorted(chip_smoke.SSD_BWD_FUNCTIONS) == sorted(names)

    def rows(**bad):
        return [{"kernel": n, "registers": 200, "spill_bytes": 0,
                 "tensor_core_instr": 32, "hgmma_instr": 32,
                 **(bad if n == "ssd_bwd_chunk_wg<2>" else {})}
                for n in names] + [{"kernel": "ssd_chunk_scan<float>",
                                    "registers": 64, "spill_bytes": 60,
                                    "tensor_core_instr": 0,
                                    "hgmma_instr": 0}]
    assert set(chip_smoke.check_ssd_bwd_build(rows())) == set(names)
    with pytest.raises(AssertionError, match="lacks"):
        chip_smoke.check_ssd_bwd_build(rows()[1:])
    with pytest.raises(AssertionError, match="no HGMMA"):
        chip_smoke.check_ssd_bwd_build(rows(hgmma_instr=0))
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_ssd_bwd_build(rows(spill_bytes=116))
