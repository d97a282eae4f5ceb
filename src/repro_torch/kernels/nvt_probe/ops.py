"""User-facing nvt_probe: the batched read-only probe (the journey).

A CUDA tensor launches the hand-written kernel (``kernel.py``) once, for
any number of queries; a CPU tensor takes the plain version
(``ref.probe_ref``).  There is no fallback from one to the other.  The
TPU version's ``block_q``/``block_nb`` and its padding of the queries
have no counterpart: the Hopper kernel reads one row per query in
batches of 32 and guards the ragged last batch itself.
"""
from __future__ import annotations

import torch

from .kernel import nvt_probe_kernel
from .ref import probe_ref


def nvt_probe(keys_tile: torch.Tensor, vals_tile: torch.Tensor,
              queries: torch.Tensor):
    """Returns ``(found, vals)``, int32 ``[Q]``.  ``nvt_probe.launches``
    counts the kernel launches made through this wrapper."""
    q = queries.to(torch.int32)
    if q.is_cuda:
        found, vals = nvt_probe_kernel(keys_tile, vals_tile, q)
        if q.shape[0]:
            nvt_probe.launches += 1
    elif keys_tile.device.type == vals_tile.device.type == "cpu":
        found, vals = probe_ref(keys_tile, vals_tile, q)
    else:
        raise ValueError("tiles and queries must be on one device")
    return found, vals


nvt_probe.launches = 0
