"""GPipe's pipeline schedule (port of ``repro.training.pipeline``).

The reference splits a stack of dense blocks into S contiguous stage
groups, one a device of a "stage" mesh axis, and streams M microbatches
through them inside ``shard_map``: at each tick stage 0 takes in the next
microbatch, every stage applies its group to the slot it holds, and a
``ppermute`` hands each stage's output to the next stage.  After the S - 1
ticks that fill the pipe, the last stage finishes one microbatch a tick.

Here the schedule runs on one device: the S slots are one tensor
``[S, ...]``, every tick applies all S groups at once (each stage's
weights batched over the leading axis), and ``torch.roll`` over the slots
is the ``ppermute``.  The stages' bubbles compute on zeros, as the
reference's do.  Running the stages on separate cards is not ported.

Parameters are ``{"w1", "w2", "w3"}`` shaped ``[S, Lps, ...]``, as the
reference's ``init_pipeline_params`` makes them
(:func:`repro_torch.models.convert.pipeline_params_from_numpy` carries
those across).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.batched import resolve_device


def mlp_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x + (silu(x w1) * (x w2)) w3: the normalisation-free residual
    block of the demo stack."""
    h = F.silu(x @ p["w1"]) * (x @ p["w2"])
    return x + h @ p["w3"]


def init_pipeline_params(gen: torch.Generator, *, n_stages: int,
                         layers_per_stage: int, d_model: int,
                         d_ff: int) -> dict:
    """``[S, Lps, ...]`` f32 weights drawn from ``gen`` on its device, at
    the reference's scales: ``d_model ** -0.5`` for w1 and w2 and a small
    ``0.1 * d_ff ** -0.5`` for w3, which keeps the stack stable without
    normalisation."""
    lead = (n_stages, layers_per_stage)

    def draw(shape, scale):
        return torch.randn(lead + shape, generator=gen,
                           device=gen.device).mul_(scale)
    s = d_model ** -0.5
    return {"w1": draw((d_model, d_ff), s), "w2": draw((d_model, d_ff), s),
            "w3": draw((d_ff, d_model), 0.1 * d_ff ** -0.5)}


def gpipe_ticks(n_microbatches: int, n_stages: int) -> int:
    """Ticks of the schedule: M, plus the S - 1 that fill the pipe."""
    return n_microbatches + n_stages - 1


def _apply_stages(params: dict, slots: torch.Tensor) -> torch.Tensor:
    """Each stage's group applied to its slot: ``slots`` [S, ...], stage
    s's block l taking ``params[k][s, l]``."""
    extra = (None,) * (slots.dim() - 3)      # broadcast over the batch dims
    for l in range(params["w1"].shape[1]):
        slots = mlp_block({k: v[:, l][(slice(None),) + extra]
                           for k, v in params.items()}, slots)
    return slots


def gpipe_forward(params: dict, x_mb: torch.Tensor, *,
                  n_stages: int) -> torch.Tensor:
    """The M microbatches ``x_mb`` [M, B/M, T, D] through the S-stage
    pipe: :func:`gpipe_ticks` ticks; at tick t stage 0 takes microbatch
    min(t, M - 1), every stage applies its group, the slots rotate s ->
    s + 1, and the last stage's outputs of ticks S - 1 .. S + M - 2 are
    the result, [M, B/M, T, D]."""
    if params["w1"].shape[0] != n_stages:
        raise ValueError(f"parameters of {params['w1'].shape[0]} stages "
                         f"for a pipe of {n_stages}")
    M = x_mb.shape[0]
    slots = x_mb.new_zeros((n_stages,) + tuple(x_mb.shape[1:]))
    outs = []
    for t in range(gpipe_ticks(M, n_stages)):
        slots[0] = x_mb[min(t, M - 1)]
        out = _apply_stages(params, slots)
        if t >= n_stages - 1:
            outs.append(out[-1])
        slots = torch.roll(out, 1, dims=0)   # the ppermute s -> s + 1
    return torch.stack(outs)


def sequential_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The same blocks without a pipe: ``x`` through every stage's group
    in order, one block at a time."""
    S, L = params["w1"].shape[:2]
    for s in range(S):
        for l in range(L):
            x = mlp_block({k: v[s, l] for k, v in params.items()}, x)
    return x


def make_gpipe_fn(n_stages: int, device=None):
    """``fn(params, x_mb)``: :func:`gpipe_forward` over ``n_stages`` on
    ``device`` (default the card; raises without one unless the caller
    asks for the CPU), the inputs moved there, no gradient taken."""
    dev = resolve_device(device)

    def fn(params: dict, x_mb) -> torch.Tensor:
        with torch.no_grad():
            return gpipe_forward(
                {k: torch.as_tensor(v, device=dev) for k, v in params.items()},
                torch.as_tensor(x_mb, device=dev), n_stages=n_stages)

    return fn
