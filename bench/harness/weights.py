"""The weights both sides are handed: made on the device from the seed in a
few large draws, in the dtype they are trained or served in, laid out by
the reference's ``param_layout``.

Every leaf is a view of one of two flat buffers (the parameter dtype, and
float32 for the leaves the layout keeps there), each leaf starting on a
256-element boundary.  Making them again from the same seed on the same
device gives the same bits, which is how the reference gets the weights
after the program's state is gone.
"""
from __future__ import annotations

import math

import torch

ALIGN = 256


def _offsets(leaves) -> tuple:
    offs, n = [], 0
    for _, shape, _ in leaves:
        offs.append(n)
        n += -(-math.prod(shape) // ALIGN) * ALIGN
    return offs, n


def make(layout: list, f32_leaves: tuple, dtype: torch.dtype, seed: int,
         device) -> dict:
    """``{name: tensor}`` of ``layout`` (``(name, shape, init)``) drawn from
    ``seed``.  A leaf whose last name part is in ``f32_leaves`` is
    float32, the rest ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    groups = {True: [], False: []}
    for leaf in layout:
        groups[leaf[0].rsplit(".", 1)[-1] in f32_leaves].append(leaf)
    out = {}
    for is_f32, leaves in groups.items():
        if not leaves:
            continue
        offs, n = _offsets(leaves)
        dt = torch.float32 if is_f32 else dtype
        # one draw for the normal leaves, one for the uniform ones
        flat = torch.randn(n, generator=gen, dtype=dt, device=device)
        unif = torch.rand(n, generator=gen, dtype=torch.float32,
                          device=device) if is_f32 else None
        for (name, shape, init), o in zip(leaves, offs):
            k = math.prod(shape)
            t = flat[o:o + k].view(shape)
            kind = init[0]
            if kind == "normal":
                t.mul_(init[1])
            elif kind == "zeros":
                t.zero_()
            elif kind == "ones":
                t.fill_(1.0)
            elif kind == "a_log":
                t.copy_(torch.log(1.0 + 15.0 * unif[o:o + k]).view(shape))
            elif kind == "dt_bias":
                lo, hi = math.log(1e-3), math.log(1e-1)
                dt_ = torch.exp(lo + (hi - lo) * unif[o:o + k]).view(shape)
                t.copy_(dt_ + torch.log(-torch.expm1(-dt_)))
            else:
                raise ValueError(f"init {init!r} of {name}")
            out[name] = t
        del unif
    return out


def nested(flat: dict) -> dict:
    """``{"blocks.3.attn.wq": t}`` -> the nested dicts and lists the
    program's parameter tree is built from."""
    root: dict = {}
    for name, t in flat.items():
        parts = name.split(".")
        node = root
        for a, b in zip(parts[:-1], parts[1:]):
            key = int(a) if a.isdigit() else a
            default = [] if b.isdigit() else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = default
                node = node[key]
            else:
                node = node.setdefault(key, default)
        last = parts[-1]
        node[last] = t
    return root
