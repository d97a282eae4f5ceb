"""The per-layer metrics read from the program's own spans: the window's
full garbage collections from a synthetic span record, nothing from a
program without the spans, and a number from the tiny training cell run
with ``--trace 1``."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from repro_torch.obs import spans

from .test_bench_cells import tiny_run

ROOT = Path(__file__).resolve().parent.parent


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "metric", ROOT / "bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Record:
    """A tracer's ``records()`` of given spans."""

    def __init__(self, recs):
        self.recs = recs

    def records(self):
        return list(self.recs)


def _span(name, t, dur, **meta):
    return {"span": name, "depth": 0, "t_us": float(t), "dur_us": float(dur),
            "counts": {}, **({"meta": meta} if meta else {})}


def test_gc_ms_reads_the_windows_full_collections(monkeypatch):
    recs = [
        _span("train.step", 0, 100),          # a set-up step
        _span("gc", 40, 30, generation=2),    # ... its collection
        _span("gc", 150, 90, generation=2),   # between it and the window
        _span("train.step", 300, 100),        # the window: 2 steps
        _span("gc", 320, 12, generation=2),
        _span("gc", 330, 5, generation=1),    # not a full collection
        _span("gc", 405, 7, generation=2),    # between the window's steps
        _span("train.step", 420, 100),
        _span("gc", 600, 50, generation=2),   # after the window
    ]
    monkeypatch.setattr(spans, "get_tracer", lambda: _Record(recs))
    read = _reader("gc_ms.train")
    assert read({"kind": "train", "steps": 2}) == pytest.approx(
        (12 + 7) / 2 / 1e3)
    assert read({"kind": "train", "steps": 3}) == pytest.approx(
        (30 + 90 + 12 + 7) / 3 / 1e3)
    assert read({"kind": "train", "steps": 4}) is None   # steps lost
    assert read({"kind": "serve", "steps": 2}) is None
    monkeypatch.setattr(spans, "get_tracer",
                        lambda: _Record([_span("train.step", 0, 9)] * 2))
    assert read({"kind": "train", "steps": 2}) == 0.0


def test_gc_ms_reads_nothing_from_a_program_without_the_spans(monkeypatch):
    read = _reader("gc_ms.train")
    monkeypatch.setattr(spans, "get_tracer", lambda: _Record([]))
    assert read({"kind": "train", "steps": 2}) is None
    monkeypatch.delattr(spans, "get_tracer")
    assert read({"kind": "train", "steps": 2}) is None


def test_tiny_training_cell_reports_gc_ms():
    out = tiny_run("mamba2-370m.train-4k", trace=True)
    assert out["metrics"]["gc_ms.train"]["unit"] == "ms"
    assert out["metrics"]["gc_ms.train"]["value"] >= 0
