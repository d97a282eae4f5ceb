"""User-facing nvt_probe: the batched read-only probe (the journey).

A CUDA tensor launches the hand-written kernel (``kernel.py``); a CPU
tensor takes the plain version (``ref.probe_ref``).  There is no fallback
from one to the other.  The TPU version's ``block_q``/``block_nb`` have
no counterpart: the Hopper kernel reads one row per query instead of
streaming bucket tiles, so queries are only padded (with -1) to a whole
number of blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import QUERIES_PER_BLOCK, nvt_probe_kernel
from .ref import probe_ref


def nvt_probe(keys_tile: torch.Tensor, vals_tile: torch.Tensor,
              queries: torch.Tensor):
    """Returns ``(found, vals)``, int32 ``[Q]``.  ``nvt_probe.launches``
    counts the kernel launches made through this wrapper."""
    n = queries.shape[0]
    q = F.pad(queries.to(torch.int32), (0, (-n) % QUERIES_PER_BLOCK),
              value=-1)
    if q.is_cuda:
        found, vals = nvt_probe_kernel(keys_tile, vals_tile, q)
        if q.shape[0]:
            nvt_probe.launches += 1
    elif keys_tile.device.type == vals_tile.device.type == "cpu":
        found, vals = probe_ref(keys_tile, vals_tile, q)
    else:
        raise ValueError("tiles and queries must be on one device")
    return found[:n], vals[:n]


nvt_probe.launches = 0
