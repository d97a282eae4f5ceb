"""Finding a cell's pieces by name.  ``BENCHMARK.json`` names the cell; its
configuration is the file that the ``configs`` entry gives, its traffic
is ``bench/traffic/<traffic>.json``, the traffic's ``kind`` names its
driver ``bench/harness/<kind>.py``, the configuration's ``model.family``
names its reference ``bench/reference/<family>.py``, and every metric is
read by ``bench/metrics/<metric name>.py``.  Adding a configuration, a
mix or a metric is adding files and entries; nothing here changes."""
from __future__ import annotations

import copy
import importlib
import importlib.util
import json
from pathlib import Path


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else copy.deepcopy(v)
    return out


class Spec:
    """One cell: its BENCHMARK.json entry, configuration, traffic and
    metrics.  ``tiny`` applies the ``tiny`` blocks of the configuration and
    the traffic (the CPU tests' form of the cell)."""

    def __init__(self, root: Path, workload: str, tiny: bool = False):
        root = Path(root)
        self.root = root
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.name = workload
        conf_entry = {c["name"]: c for c in self.bench["configs"]}[
            self.cell["config"]]
        self.config = json.loads((root / conf_entry["file"]).read_text())
        self.traffic = json.loads(
            (root / "bench" / "traffic" / f"{self.cell['traffic']}.json")
            .read_text())
        if tiny:
            small = self.config.get("tiny", {})
            self.config = _merge(self.config, small)
            if "limits" in small:    # numbers of their own, not merged
                self.config["limits"] = copy.deepcopy(small["limits"])
            self.traffic = _merge(self.traffic, self.traffic.get("tiny", {}))
        self.kind = self.traffic["kind"]

    def applies(self, metric: dict, reported: set) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric.get("moves") is None or metric["moves"] in reported

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports in this run."""
        e2e = [e for e in self.bench["end_to_end"] if self.applies(e, set())]
        if not trace:
            return e2e
        names = {e["name"] for e in e2e}
        return [e for e in self.bench["per_layer"] if self.applies(e, names)]

    def driver(self):
        return importlib.import_module(f"bench.harness.{self.kind}")

    def reference_module(self):
        return importlib.import_module(
            f"bench.reference.{self.config['model']['family']}")

    def weights(self, seed: int, device) -> dict:
        import torch

        from . import weights
        ref = self.reference_module()
        m = self.config["model"]
        return weights.make(ref.param_layout(m),
                            getattr(ref, "F32_LEAVES", ()),
                            getattr(torch, m["dtype"]), seed, device)

    def limits(self) -> dict:
        return self.config["limits"][self.kind]

    def reader(self, name: str):
        """The ``read(run)`` function of ``bench/metrics/<name>.py``."""
        path = self.root / "bench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
