"""The port's spans on the profiler's clock (``repro_torch.obs.spans``) and
the sites that record them: each span a ``torch.profiler`` range
``nvt.<phase>`` nested as the tracer nests them, and nothing without a
profiler; full garbage collections as ``gc`` spans; the train step's
phases, with the same bits whether it traces or not; each served
request's wait and latency; the kernel builds' and loads' counters."""
import dataclasses
import gc
import json
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_arch, tiny
from repro_torch.kernels import _build
from repro_torch.models.model import Model
from repro_torch.obs import spans as S
from repro_torch.obs.metrics import MetricsRegistry, get_registry
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import (make_train_step,
                                             shape_batch_for_accum)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranges(prof, tmp_path) -> list:
    """The export's ``nvt.`` events, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in evs if e.get("ph") == "X"
                   and str(e.get("name", "")).startswith(S.RANGE_PREFIX)),
                  key=lambda e: e["ts"])


def _inside(inner: dict, outer: dict) -> bool:
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_spans_are_profiler_ranges_nested_as_the_tracer_nests_them(
        tmp_path):
    tr = S.Tracer(registry=MetricsRegistry())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("route"):
            torch.ones(4).sum()
        with tr.span("plan"):
            with tr.span("prefill"):
                torch.ones(4).sum()
            with S.profiled("decode_step"):
                torch.ones(4).sum()
    rs = _ranges(prof, tmp_path)
    assert [e["name"] for e in rs] == ["nvt.route", "nvt.plan",
                                       "nvt.prefill", "nvt.decode_step"]
    assert {e["cat"] for e in rs} == {"user_annotation"}
    route, plan, prefill, step = rs
    assert route["ts"] + route["dur"] <= plan["ts"]
    assert _inside(prefill, plan) and _inside(step, plan)
    assert prefill["ts"] + prefill["dur"] <= step["ts"]
    # the profiler-only range entered neither the ring nor a histogram
    assert [(r["span"], r["depth"]) for r in tr.records()] == [
        ("route", 0), ("prefill", 1), ("plan", 0)]
    assert {e.labels["phase"] for e in tr.registry.entries()} == {
        "route", "prefill", "plan"}


def test_nothing_reaches_the_profiler_without_one(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} opened with no profiler")
    monkeypatch.setattr(S, "record_function", refuse)
    tr = S.Tracer(registry=MetricsRegistry())
    with tr.span("commit") as s:
        with S.profiled("decode_step") as r:
            assert r is None
    assert s._range is None
    assert S.profiled("ssd_scan") is S._DISABLED
    assert [r["span"] for r in tr.records()] == ["commit"]


def test_a_full_collection_is_a_gc_span_with_its_range(tmp_path):
    reg = MetricsRegistry()
    tr = S.Tracer(registry=reg)
    twin = S.Tracer(registry=reg)       # a second tracer, one registry
    tr.watch_gc()
    tr.watch_gc()
    twin.watch_gc()
    assert gc.callbacks.count(S._on_gc) == 1
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tr.span("train.step"):
                gc.collect()
            gc.collect(0)       # a young collection: a range, no span
    finally:
        twin.unwatch_gc()
    full = reg.counter("gc_collections_total", generation=2)
    n = full.value
    assert n >= 1           # counted once per registry, not per tracer
    assert reg.histogram("gc_pause_us", lo=1.0, hi=1e8, growth=1.25,
                         generation=2).count == n
    recs = tr.records()
    gcs = [r for r in recs if r["span"] == "gc"]
    assert len(gcs) == n and recs[-1]["span"] == "train.step"
    g, step = gcs[-1], recs[-1]
    assert g["meta"] == {"generation": 2} and g["depth"] == 1
    assert step["t_us"] <= g["t_us"] and \
        g["t_us"] + g["dur_us"] <= step["t_us"] + step["dur_us"]
    rs = {e["name"]: e for e in _ranges(prof, tmp_path)}
    assert _inside(rs["nvt.gc"], rs["nvt.train.step"])
    assert rs["nvt.gc0"]["ts"] >= rs["nvt.train.step"]["ts"] + \
        rs["nvt.train.step"]["dur"]
    tr.unwatch_gc()
    assert tr in S._GC_WATCHERS         # watched twice, let go once
    tr.unwatch_gc()
    assert tr not in S._GC_WATCHERS
    gc.collect()
    assert full.value == n and len([r for r in tr.records()
                                    if r["span"] == "gc"]) == n
    # a disabled tracer watches nothing
    off = S.Tracer(registry=MetricsRegistry(), enabled=False).watch_gc()
    assert off not in S._GC_WATCHERS


def _train(model, cfg, batches, **kw):
    params = model.init(torch.Generator().manual_seed(0), trainable=True)
    opt = make_optimizer(cfg)
    state = opt.init(params)
    step = make_train_step(model, cfg, opt, **kw)
    losses = []
    for i, b in enumerate(batches):
        params, state, met = step(params, state, b, i)
        losses.append(met["loss"])
    return step, torch.stack(losses), {n: p.detach().clone()
                                       for n, p in params.named_parameters()}


def test_train_step_spans_its_phases_and_keeps_its_bits():
    M = 2
    cfg = dataclasses.replace(tiny(get_arch("qwen3-1.7b")), microbatches=M)
    model = Model(cfg)
    batches = [shape_batch_for_accum(
        {"tokens": np.random.default_rng(i).integers(
            0, cfg.vocab, size=(4, 17)).astype(np.int32)}, M)
        for i in range(2)]
    tr = S.Tracer(registry=MetricsRegistry())
    on, losses_on, params_on = _train(model, cfg, batches, tracer=tr)
    off, losses_off, params_off = _train(
        model, cfg, batches, tracer=S.Tracer(enabled=False))
    assert on.tracer is tr and not off.tracer.enabled
    assert off.tracer not in S._GC_WATCHERS
    assert off.tracer.records() == []
    assert torch.equal(losses_on, losses_off)
    assert all(torch.equal(params_on[n], params_off[n]) for n in params_on)
    one = [("train.h2d", 1)] + [("train.forward", 1), ("train.backward", 1),
                                ("train.accumulate", 1)] * M + \
        [("train.optimizer", 1), ("train.step", 0)]
    got = [(r["span"], r["depth"]) for r in tr.records()
           if r["span"] != "gc"]
    assert got == one * len(batches)
    assert [r["meta"]["microbatch"] for r in tr.records()
            if r["span"] == "train.forward"] == list(range(M)) * 2
    # a step watches the collector while it lives: two steps on one
    # tracer keep it watched until the second is gone
    again = make_train_step(model, cfg, make_optimizer(cfg), tracer=tr)
    assert S._GC_WATCHERS[tr] == 2
    del on
    assert S._GC_WATCHERS[tr] == 1
    del again
    assert tr not in S._GC_WATCHERS
    # by default the process-wide tracer
    dflt = make_train_step(model, cfg, make_optimizer(cfg))
    assert dflt.tracer is S.get_tracer() and dflt.tracer in S._GC_WATCHERS


def test_engine_times_each_request_and_spans_its_batches(tmp_path):
    cfg = tiny(get_arch("qwen2-7b"))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    reg = MetricsRegistry()
    eng = ServeEngine(model, params, max_len=12, log_dir=tmp_path,
                      batch_size=2, device="cpu", registry=reg)
    eng.tracer.unwatch_gc()     # the spans below, and no collection's
    rng = np.random.default_rng(2)
    requests = {rid: rng.integers(0, cfg.vocab, size=8 if rid < 5 else 6
                                  ).astype(np.int32) for rid in range(8)}
    n_new = 3
    eng.serve(requests, n_new=n_new)
    # 3 prompts of 6 tokens, then 5 of 8: batches of 2, 1, 2, 2, 1
    wait, lat = eng.request_times["wait_s"], eng.request_times["latency_s"]
    assert len(wait) == len(lat) == 8
    assert all(0 <= w <= x for w, x in zip(wait, lat))
    assert wait == sorted(wait) and lat == sorted(lat)
    assert wait[-1] == max(wait) > wait[0]      # the last batch waits most
    assert len(eng.step_times["prefill_s"]) == 5
    assert len(eng.step_times["decode_step_s"]) == 5 * n_new
    recs = [(r["span"], r["depth"]) for r in eng.tracer.records()]
    batch = [("prefill", 1), ("decode", 1), ("plan", 0), ("flush_fence", 1),
             ("commit", 0)]
    assert recs == [("route", 0)] + batch * 5
    hist = reg.histogram("serve_request_us", lo=1.0, hi=1e8, growth=1.25)
    assert hist.count == 8
    assert hist.max <= lat[-1] * 1e6 * 1.0001
    # served again with two new requests: the hits are answered, not
    # counted as fresh, and every request gives the histogram one sample
    more = dict(requests)
    more.update({8: requests[0].copy(), 9: requests[7].copy()})
    eng.serve(more, n_new=n_new)
    assert len(eng.request_times["wait_s"]) == 10
    assert hist.count == 18
    assert len(eng.step_times["prefill_s"]) == 7
    # an engine watches the collector while it lives, and no longer
    other = ServeEngine(model, params, max_len=12, log_dir=tmp_path / "b",
                        device="cpu", registry=MetricsRegistry())
    tr = other.tracer
    assert tr in S._GC_WATCHERS
    del other
    assert tr not in S._GC_WATCHERS


def test_kernel_builds_and_loads_are_counted(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'w').close()\n"
                    "print(\"ptxas info    : Used 8 registers\")\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    reg = get_registry()
    builds = reg.counter("kernel_builds_total", source="k.cu")
    loads = reg.counter("kernel_loads_total", source="k.cu")
    b0, l0 = builds.value, loads.value
    lib = _build.load(src)
    assert _build.load(src) is lib
    assert (builds.value - b0, loads.value - l0) == (1, 1)
    span = [r for r in S.get_tracer().records()
            if r["span"] == "kernel_build"][-1]
    assert span["meta"] == {"sources": ["k.cu"]} and span["dur_us"] > 0
    monkeypatch.setattr(_build, "_LOADED", {})   # a new process: loaded
    _build.load(src)                             # from the build it left
    assert (builds.value - b0, loads.value - l0) == (1, 2)
