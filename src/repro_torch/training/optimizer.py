"""AdamW and Adafactor in plain PyTorch (port of
``repro.training.optimizer``), with the reference's arithmetic: a linear
warm-up, clipping by the global norm (AdamW), f32 math cast back to the
parameter dtype, AdamW moments in ``cfg.opt_dtype``, Adafactor's factored
second moments for arrays of two or more dimensions.

Parameters, gradients and AdamW's moments are flat state dicts
``{name: tensor}`` keyed by :class:`~repro_torch.models.model.ParamTree`'s
names (``blocks.3.attn.wq``); a ``ParamTree`` may stand for its
parameters.  ``update`` writes the new parameters and state into the
given tensors, under ``torch.no_grad()``, and returns them: the reference
donates both to its jitted step (``launch/train.py``), so neither keeps an
old copy.

The reference stacks a layer-stacked leaf on a leading ``L`` axis where
the port keeps one tensor a layer; :func:`layer_groups` recovers those
stacks from the names.  :func:`global_norm` sums its leaves in the
reference's leaf order (sorted pytree paths, the layers of a stacked leaf
in order), and Adafactor updates each stacked group as the reference's one
array: its row and column statistics and its RMS clip span the stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch
from torch import nn


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]
    # update(grads, state, params, step) -> (params, state), in place


def _named(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) \
        else dict(params)


def layer_groups(names) -> Dict[str, List[str]]:
    """``{reference path: [names]}`` in the reference's leaf order: a
    name's numeric parts are layer indices (the reference's stacked axis),
    its other parts the path; the names of one path are in layer order."""
    groups: Dict[str, list] = {}
    for name in names:
        parts = name.split(".")
        path = ".".join(p for p in parts if not p.isdigit())
        layer = tuple(int(p) for p in parts if p.isdigit())
        groups.setdefault(path, []).append((layer, name))
    return {path: [n for _, n in sorted(groups[path])]
            for path in sorted(groups, key=lambda p: p.split("."))}


def _stacked(group: List[str]) -> bool:
    return any(p.isdigit() for p in group[0].split("."))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, the leaves summed
    in the reference's order."""
    leaves = _named(tree)
    total = None
    for names in layer_groups(leaves).values():
        for n in names:
            s = torch.sum(torch.square(leaves[n].float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


def _f32(x) -> float:
    """An f32 value as a Python float (exact in f32 arithmetic)."""
    return float(np.float32(x))


def _warmup(lr: float, warmup_steps: int, step: int) -> float:
    """The reference's ``lr * min(1, (step + 1) / warmup_steps)`` in f32."""
    warm = np.minimum(np.float32(1.0),
                      np.float32(step + 1) / np.float32(warmup_steps))
    return _f32(np.float32(lr) * warm)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    moment_dtype: str = "float32"


def adamw(cfg: AdamWConfig = AdamWConfig()) -> Optimizer:
    mdt = getattr(torch, cfg.moment_dtype)

    def init(params):
        ps = _named(params)
        return {m: {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
                    for n, p in ps.items()} for m in ("mu", "nu")}

    @torch.no_grad()
    def update(grads, state, params, step: int):
        ps = _named(params)
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        lr = _warmup(cfg.lr, cfg.warmup_steps, step)
        t = np.float32(step + 1)
        c1 = _f32(np.float32(1.0) - np.float32(cfg.b1) ** t)
        c2 = _f32(np.float32(1.0) - np.float32(cfg.b2) ** t)
        for n, p in ps.items():
            mu, nu = state["mu"][n], state["nu"][n]
            g = grads[n].float() * scale
            mu32 = mu.float() * cfg.b1 + g * (1 - cfg.b1)
            nu32 = nu.float() * cfg.b2 + g * (1 - cfg.b2) * g
            del g
            # mhat / (sqrt(vhat) + eps), in place on the temporaries
            delta = (mu32 / c1).div_((nu32 / c2).sqrt_().add_(cfg.eps))
            delta.add_(p.float() * cfg.weight_decay)
            p.copy_(p.float() - delta.mul_(lr))
            mu.copy_(mu32)
            nu.copy_(nu32)
        return params, state

    return Optimizer(init=init, update=update)


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    warmup_steps: int = 100


def adafactor(cfg: AdafactorConfig = AdafactorConfig()) -> Optimizer:
    """Factored second moments: O(r+c) state per matrix instead of O(r·c).
    The state is ``{reference path: {"vr", "vc"} or {"v"}}`` with the
    reference's shapes (a stacked group's leading axis is its layers)."""

    def _shape(ps, names):
        p = ps[names[0]]
        return ((len(names),) if _stacked(names) else ()) + tuple(p.shape)

    def init(params):
        ps = _named(params)
        state = {}
        for path, names in layer_groups(ps).items():
            shape, dev = _shape(ps, names), ps[names[0]].device
            state[path] = (
                {"vr": torch.zeros(shape[:-1], device=dev),
                 "vc": torch.zeros(shape[:-2] + shape[-1:], device=dev)}
                if len(shape) >= 2 else {"v": torch.zeros(shape, device=dev)})
        return state

    @torch.no_grad()
    def update(grads, state, params, step: int):
        ps = _named(params)
        t = np.float32(step + 1)
        rho = _f32(np.float32(1.0) - t ** np.float32(-cfg.decay))
        lr = _warmup(cfg.lr, cfg.warmup_steps, step)
        lr_wd = _f32(np.float32(lr) * np.float32(cfg.weight_decay))
        for path, names in layer_groups(ps).items():
            stacked = _stacked(names)
            p32 = torch.stack([ps[n].float() for n in names]) if stacked \
                else ps[names[0]].float()
            g = torch.stack([grads[n].float() for n in names]) if stacked \
                else grads[names[0]].float()
            s = state[path]
            g2 = g * g + cfg.eps
            if "vr" in s:
                vr = s["vr"] * rho + torch.mean(g2, dim=-1) * (1 - rho)
                vc = s["vc"] * rho + torch.mean(g2, dim=-2) * (1 - rho)
                # u = g / sqrt((vr / mean(vr)) ⊗ vc)
                denom_r = vr / (torch.mean(vr, dim=-1, keepdim=True)
                                + 1e-30)
                u = g / (torch.sqrt(denom_r + 1e-30)[..., None]
                         * torch.sqrt(vc + 1e-30)[..., None, :])
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = s["v"] * rho + g2 * (1 - rho)
                u = g / torch.sqrt(v + 1e-30)
                s["v"].copy_(v)
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
            newp = p32 - lr * u - lr_wd * p32
            for i, n in enumerate(names):
                ps[n].copy_(newp[i] if stacked else newp)
        return params, state

    return Optimizer(init=init, update=update)


def make_optimizer(arch_cfg, kind: str = "adamw") -> Optimizer:
    if kind == "adafactor":
        return adafactor()
    return adamw(AdamWConfig(moment_dtype=arch_cfg.opt_dtype))
