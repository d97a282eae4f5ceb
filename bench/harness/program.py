"""What the benchmark takes from the program (the ``repro_torch`` port):
its configuration registry, its model, train step, optimizer and serving
engine, and the kernel wrappers' launch counters.  Imported only when a
run starts."""
from __future__ import annotations

import dataclasses
import importlib
from collections import Counter

import torch

from bench import families


def arch_config(conf: dict, microbatches: int = None):
    """The program's ArchConfig: the registry's entry with the
    configuration's ``arch_overrides``, held to its ``model`` block."""
    from repro_torch.configs.registry import get_arch
    over = dict(conf.get("arch_overrides", {}))
    if microbatches is not None:
        over["microbatches"] = microbatches
    cfg = dataclasses.replace(get_arch(conf["arch"]), **over)
    m = conf["model"]
    bad = {k: (getattr(cfg, k), m[k]) for k in families.of(m).ARCH_KEYS
           if getattr(cfg, k) != m[k]}
    if bad:
        raise ValueError(f"the program's {conf['arch']} differs from the "
                         f"configuration: {bad}")
    if cfg.param_dtype != m["dtype"] or cfg.compute_dtype != m["dtype"]:
        raise ValueError("the program's dtypes differ from the configuration")
    return cfg


def params(cfg, weights: dict, nested: dict, trainable: bool):
    """The program's parameter tree over the benchmark's weights (shared
    storage), after checking every name, shape and dtype against the
    program's own layout."""
    from repro_torch.models.model import Model, ParamTree
    want = {n: (tuple(p.shape), p.dtype) for n, p in
            Model(cfg).init_shapes().named_parameters()}
    got = {n: (tuple(t.shape), t.dtype) for n, t in weights.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:8]
        raise ValueError(f"weights layout differs from the program's: {diff}")
    return ParamTree(nested, trainable=trainable)


def kernel_counts(m: dict) -> dict:
    """Copies of the launch counters by shape of the kernel wrappers that
    the family's file names."""
    return {name: Counter(getattr(importlib.import_module(mod), attr).shapes)
            for name, (mod, attr) in families.of(m).COUNTERS.items()}


def counts_delta(before: dict, after: dict) -> dict:
    return {k: {s: n for s, n in (after[k] - before[k]).items()}
            for k in after}


def free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
