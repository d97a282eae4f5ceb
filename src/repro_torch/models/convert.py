"""Carry the reference's parameters into the port.

The reference keeps parameters as a pytree and stacks per-layer leaves on
a leading ``L`` axis (``repro.models.transformer.stacked_params``).  Given
that tree as numpy arrays (``jax.tree.map(np.asarray, params)``),
:func:`params_from_numpy` builds the port's :class:`ParamTree` with the
layer axis unrolled, so ``blocks/mamba/in_proj[3]`` becomes
``blocks.mamba.3.in_proj`` (a dense model's ``blocks/attn/wq[3]``
``blocks.3.attn.wq``, an encoder-decoder's ``encoder/mlp/w_up[1]``
``encoder.1.mlp.w_up``).  bf16 arrays (numpy's ``bfloat16`` extension
dtype) arrive as torch bf16, bit for bit.  :func:`grads_from_numpy` and
:func:`opt_state_from_numpy` carry a gradient and an optimizer state across
the same way, keyed by the port's parameter names;
:func:`pipeline_params_from_numpy` the GPipe demo stack's parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from .model import ParamTree

# subtrees whose leaves carry the stacked layer axis, per family
STACKED = {"dense": (("blocks",),), "vlm": (("blocks",),),
           "moe": (("blocks",),), "ssm": (("blocks",),),
           "hybrid": (("blocks", "mamba"),),
           "encdec": (("encoder",), ("blocks",))}


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


def _unstacked(tree: dict, cfg, device) -> dict:
    """The reference's tree of numpy arrays as tensors on ``device``, the
    family's stacked subtrees unrolled into lists of per-layer trees."""
    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else _tensor(v, device)
                for k, v in t.items()}
    out = conv(tree)
    for path in STACKED[cfg.family]:
        parent = out
        for key in path[:-1]:
            parent = parent[key]
        parent[path[-1]] = _unstack(parent[path[-1]])
    return out


def params_from_numpy(tree: dict, cfg, device,
                      trainable: bool = False) -> ParamTree:
    """The port's parameters from the reference's tree of numpy arrays;
    frozen unless ``trainable``."""
    return ParamTree(_unstacked(tree, cfg, device), trainable)


def grads_from_numpy(tree: dict, cfg, device) -> dict:
    """A gradient (or any tree shaped like the parameters) from the
    reference's tree of numpy arrays: the flat ``{name: tensor}`` keyed
    by the port's parameter names."""
    return {n: p.detach() for n, p in
            ParamTree(_unstacked(tree, cfg, device)).named_parameters()}


def opt_state_from_numpy(state: dict, cfg, device) -> dict:
    """The port's optimizer state from the reference's (numpy arrays).

    AdamW's ``{"mu", "nu"}`` trees are unstacked as the parameters are,
    each into a flat ``{name: tensor}``.  Adafactor's slots keep the
    reference's stacked layer axis, ``{reference path: {"vr", "vc"} or
    {"v"}}`` with the path's keys joined by dots: the reference factors
    a stacked leaf as one array (a stacked norm weight [L, D] is a matrix
    whose ``vc`` is shared by the layers), and the port's Adafactor
    updates each stacked group as that array
    (:func:`repro_torch.training.optimizer.layer_groups`)."""
    if set(state) == {"mu", "nu"}:
        return {k: grads_from_numpy(v, cfg, device) for k, v in state.items()}

    def slots(t, prefix=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict) and set(v) in ({"vr", "vc"}, {"v"}):
                out[prefix + k] = {n: _tensor(a, device)
                                   for n, a in v.items()}
            else:
                out.update(slots(v, prefix + k + "."))
        return out
    return slots(state)


def pipeline_params_from_numpy(tree: dict, device) -> dict:
    """The reference's GPipe parameters (``init_pipeline_params``: ``{"w1",
    "w2", "w3"}`` shaped ``[S, Lps, ...]``, as numpy arrays) as the port's
    :mod:`repro_torch.training.pipeline` takes them: the same shapes, on
    ``device``."""
    if set(tree) != {"w1", "w2", "w3"}:
        raise ValueError(f"GPipe parameters are w1, w2, w3, not "
                         f"{sorted(tree)}")
    return {k: _tensor(v, device) for k, v in tree.items()}
