"""User-facing decode attention: one new query token a row against one
layer's KV cache, in the model layout.

A CUDA tensor launches the hand-written kernels (``kernel.py``), which
read the cache in place, at GQA size, over each row's filled positions
only, taken from the device tensor ``positions``.  A CPU tensor takes the
plain version, :func:`decode_attention_plain`: the model's
``attention_scores`` over the filled slice of the cache.  A meta tensor
(the dry-run's cells) computes nothing: it gets an empty output and adds
the kernels' :func:`work` to the recording tallies
(:mod:`repro_torch.kernels.work`).  There is no fallback from one to the
other.  On the CUDA path the wrapper's host work is the profiler range
``nvt.decode_attention`` while a profiler runs
(:func:`repro_torch.obs.spans.profiled`), and every call, either path,
counts in ``decode_attention_calls_total{path}`` (``kernel`` or
``plain``) on the process-wide registry.
"""
from __future__ import annotations

from collections import Counter

import torch

from ...obs.metrics import get_registry
from ...obs.spans import profiled
from .. import work as _work
from .kernel import decode_attention_kernel


_COUNTERS = {}   # path -> (registry gen, counter): one label lookup a
                 # path, again after the registry's reset()


def _calls(path: str):
    """``decode_attention_calls_total{path}`` on the process-wide
    registry."""
    reg = get_registry()
    cached = _COUNTERS.get(path)
    if cached is None or cached[0] != reg.gen:
        cached = _COUNTERS[path] = (reg.gen, reg.counter(
            "decode_attention_calls_total", path=path))
    return cached[1]


def row_range(pos: int, S: int, window: int = 0) -> tuple:
    """The cache positions ``[lo, hi)`` a row writing at ``pos`` attends:
    up to its own, within the cache of ``S``, the last ``window`` of them
    where a window is set (the kernel's ``row_range``)."""
    hi = min(max(pos + 1, 0), S)
    return (max(pos - window + 1, 0) if window > 0 else 0), hi


def work(B: int, H: int, K: int, d: int, filled: int, *,
         itemsize: int = 2) -> dict:
    """The least work of one call at q ``[B, 1, H, d]`` and caches of K
    heads, each row attending ``filled`` positions: ``flops``, 2 d a
    (head, position) for each of the two products, and ``bytes``, q
    read and the output written once and each filled K and V row of each
    KV head read once."""
    return {"flops": 2 * 2 * d * B * H * filled,
            "bytes": (2 * B * H * d + 2 * B * filled * K * d) * itemsize}


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """q: ``[B, 1, H, d]``; k_cache/v_cache: one layer's ``[B, S_max, K,
    d]`` (GQA: query head h reads KV head h // (H // K)); positions: the
    B positions being written (``[B]`` or ``[B, 1]``, int32 on the card).
    Row b attends to the cache positions up to ``positions[b]``, the last
    ``window`` of them where a window is set.  Returns ``[B, 1, H, d]`` in
    the q dtype.  ``decode_attention.launches`` counts the kernel
    launches made through this wrapper and ``decode_attention.shapes``
    the same by ``(B, H, K, d, S_max, window)``; a meta tensor launches
    nothing and counts nothing.  A meta ``positions`` holds no value: the
    work is counted at the cache's last slot, where the dry-run's decode
    cells write."""
    if q.device.type == "meta":
        B, _, H, d = q.shape
        S, K = k_cache.shape[1:3]
        lo, hi = row_range(S - 1, S, window)
        w = work(B, H, K, d, hi - lo, itemsize=q.element_size())
        _work.add("decode_attention", w["flops"], w["bytes"])
        return torch.empty_like(q)
    if q.is_cuda:
        with profiled("decode_attention"):
            out = decode_attention_kernel(q, k_cache, v_cache, positions,
                                          window)
            B, _, H, d = q.shape
            decode_attention.launches += 1
            decode_attention.shapes[(B, H, k_cache.shape[2], d,
                                     k_cache.shape[1], int(window))] += 1
            _calls("kernel").inc()
            return out
    if {t.device.type for t in (q, k_cache, v_cache, positions)} != {"cpu"}:
        raise ValueError("all inputs must be on one device (CUDA for the "
                         "kernel, CPU for the plain version)")
    _calls("plain").inc()
    return decode_attention_plain(q, k_cache, v_cache, positions, window)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, positions: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """The plain version, on any device: ``attention_scores`` over the
    cache positions some row attends, each row masked to its own."""
    # the model layer imports this module: import its function late
    from ...models.layers import attention_scores
    S = k_cache.shape[1]
    lo, hi = zip(*(row_range(int(p), S, window)
                   for p in positions.reshape(-1).tolist()))
    a, z = min(lo), max(hi)
    kpos = torch.arange(a, max(a, z), device=q.device)
    mask = (kpos >= torch.tensor(lo, device=q.device)[:, None]) & \
        (kpos < torch.tensor(hi, device=q.device)[:, None])
    return attention_scores(q, k_cache[:, a:z], v_cache[:, a:z],
                            mask[:, None, None, :])


decode_attention.launches = 0
decode_attention.shapes = Counter()
