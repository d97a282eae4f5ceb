"""Plain PyTorch version of the nvt_probe kernel, and the functions that
make its dense bucket tiles (from a key array or from a chain-format map).

Tiles are ``keys_tile``/``vals_tile`` ``[n_buckets, cap]`` int32: row
``b`` holds the keys hashing to bucket ``b`` (0 marks an empty slot).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.batched import NIL, HashMapState, _mix, resolve_device

mix32 = _mix          # uint32 hash as int64 in [0, 2**32)


def mix32_np(x):
    x = np.asarray(x, np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def probe_ref(keys_tile: torch.Tensor, vals_tile: torch.Tensor,
              queries: torch.Tensor):
    """For each query: ``b = mix32(q) % NB``, ``hit = keys[b] == q``,
    ``found = any(hit)``, ``val = sum(vals[b] where hit)`` wrapping in
    int32.  Key 0 marks an empty slot, so a query of 0 "finds" any bucket
    with an empty slot (value 0), and duplicate keys in a row sum."""
    nb = keys_tile.shape[0]
    b = mix32(queries) % nb
    hit = keys_tile[b] == queries[:, None]
    found = hit.any(dim=1).to(torch.int32)
    vals = torch.where(hit, vals_tile[b], 0).sum(dim=1).to(torch.int32)
    return found, vals


def tiles_from_keys(keys, n_buckets: int, cap: int, val_mult: int = 3,
                    device=None):
    """Dense tiles straight from a key array: first fit per bucket in key
    order, keys past a full row dropped; vals are ``key * val_mult``
    (int32, wrapping)."""
    dev = resolve_device(device)
    keys = np.asarray(keys, np.int32)
    b = (mix32_np(keys) % np.uint32(n_buckets)).astype(np.int64)
    order = np.argsort(b, kind="stable")
    sb = b[order]
    starts = np.searchsorted(sb, sb, side="left")
    slot = np.empty_like(b)
    slot[order] = np.arange(b.size) - starts      # rank within its bucket
    keep = slot < cap
    kt = np.zeros((n_buckets, cap), np.int32)
    vt = np.zeros((n_buckets, cap), np.int32)
    kt[b[keep], slot[keep]] = keys[keep]
    vt[b[keep], slot[keep]] = (keys[keep].astype(np.int64)
                               * val_mult).astype(np.int32)
    return (torch.as_tensor(kt, device=dev), torch.as_tensor(vt, device=dev))


def tiles_from_hashmap(state: HashMapState, n_buckets: int, cap: int):
    """Dense tiles of a chain-format map, on the state's device: row ``b``
    holds bucket ``b``'s live nodes in chain order (head first).

    One frontier walk over all bucket heads at once; a live node's slot is
    the count of live nodes seen before it in its bucket.  Raises
    ``ValueError`` when a bucket holds more than ``cap`` live nodes."""
    dev = state.key.device
    rows = torch.arange(n_buckets, device=dev)
    node = state.head[:n_buckets].long()
    slot = torch.zeros(n_buckets, dtype=torch.long, device=dev)
    # one spare cell past the end takes the writes of lanes with nothing
    # to write, so the walk never leaves the device to compact its lanes
    spare = n_buckets * cap
    kt = torch.zeros(spare + 1, dtype=torch.int32, device=dev)
    vt = torch.zeros(spare + 1, dtype=torch.int32, device=dev)
    while True:
        on = node != NIL
        safe = torch.where(on, node, 0)
        put = on & state.live[safe]
        more, overflow = torch.stack([on.any(), (put & (slot >= cap)).any()
                                      ]).tolist()
        if overflow:
            raise ValueError("bucket overflow in tile conversion")
        if not more:
            break
        cell = torch.where(put, rows * cap + slot, spare)
        kt[cell] = state.key[safe]
        vt[cell] = state.val[safe]
        slot += put.long()
        node = torch.where(on, state.nxt[safe].long(), node)
    return kt[:spare].view(n_buckets, cap), vt[:spare].view(n_buckets, cap)
