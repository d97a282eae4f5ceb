"""Carry the reference's parameters into the port.

The reference keeps parameters as a pytree and stacks per-layer leaves on
a leading ``L`` axis (``repro.models.transformer.stacked_params``).  Given
that tree as numpy arrays (``jax.tree.map(np.asarray, params)``),
:func:`params_from_numpy` builds the port's :class:`ParamTree` with the
layer axis unrolled, so ``blocks/mamba/in_proj[3]`` becomes
``blocks.mamba.3.in_proj`` (and a dense model's ``blocks/attn/wq[3]``
``blocks.3.attn.wq``).  bf16 arrays (numpy's ``bfloat16`` extension
dtype) arrive as torch bf16, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .model import ParamTree

# subtrees whose leaves carry the stacked layer axis, per family
STACKED = {"dense": (("blocks",),), "hybrid": (("blocks", "mamba"),)}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _unstack(tree: dict) -> list:
    """{name: [L, ...]} (nested) -> L trees of {name: [...]}."""
    sizes = set()

    def walk(t):
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
            else:
                sizes.add(len(v))
    walk(tree)
    if len(sizes) != 1:
        raise ValueError(f"stacked leaves disagree on the layer count: "
                         f"{sorted(sizes)}")

    def pick(t, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in t.items()}
    return [pick(tree, i) for i in range(sizes.pop())]


def params_from_numpy(tree: dict, cfg, device) -> ParamTree:
    """The port's parameters from the reference's tree of numpy arrays."""
    if cfg.family not in STACKED:
        raise NotImplementedError(f"family {cfg.family!r}: later slice")

    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else _tensor(v, device)
                for k, v in t.items()}
    out = conv(tree)
    for path in STACKED[cfg.family]:
        parent = out
        for key in path[:-1]:
            parent = parent[key]
        parent[path[-1]] = _unstack(parent[path[-1]])
    return ParamTree(out)
