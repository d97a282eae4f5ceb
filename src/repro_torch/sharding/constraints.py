"""Activation-constraint hooks (the port's copy of
``repro.sharding.constraints``).

The reference's models call ``constrain`` at layout-critical points
(post-QKV, block boundaries: ``repro/models/layers.py`` and
``repro/models/transformer.py``), which pin an activation's sharding
under a registered mesh.  The port runs eager PyTorch on one card, where
there is no layout to pin: :func:`constrain` and
:func:`constrain_like_params` return their input itself, and the port's
models make no ``constrain`` calls.  The registry and the guard are kept
so that a layout across cards can be added here (ROADMAP, open cost 7)
without touching the callers.

Divisibility-guarded like :mod:`repro_torch.sharding.specs`: an axis that
does not divide its dim is dropped from the constraint.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..launch.mesh import Mesh

_ACTIVE_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


class use_mesh:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = _ACTIVE_MESH
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(self.prev)


def _guard(dim: int, axes):
    """``axes`` where the active mesh has them all and their size divides
    ``dim`` (and is at most ``dim``), else None."""
    if axes is None:
        return None
    mesh = _ACTIVE_MESH
    size = 1
    axes_t = axes if isinstance(axes, tuple) else (axes,)
    for a in axes_t:
        if a not in mesh.axis_names:
            return None
        size *= mesh.shape[a]
    return axes if dim % size == 0 and dim >= size else None


def constrain(x, *axes):
    """``constrain(x, batch_axes, None, 'model', None)``: ``x`` itself
    (one card has no layout to pin; see the module docstring)."""
    return x


def batch_axes() -> Optional[Tuple[str, ...]]:
    mesh = _ACTIVE_MESH
    if mesh is None:
        return None
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def constrain_like_params(tree, cfg):
    """A params-shaped tree (the gradient accumulator) pinned to the
    parameter rules: ``tree`` itself on one card."""
    return tree
