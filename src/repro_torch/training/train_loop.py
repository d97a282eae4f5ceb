"""The train step (port of ``repro.training.train_loop``): one forward and
backward, or a loop over microbatches with the gradients accumulated in
``cfg.opt_dtype``, then the optimizer's in-place update.

The reference's step is a jitted function of (params, opt_state, batch,
step) with a ``lax.scan`` over the microbatches; here it is an eager loop
over the microbatches, ``torch.autograd.grad`` for each.

:func:`make_compressed_psum_grads` is the reference's bf16-compressed
gradient mean with f32 error feedback, over a leading replica axis (the
reference under ``jax.vmap(axis_name=...)``) or over a
``torch.distributed`` process group.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from ..obs.spans import Tracer, get_tracer
from .optimizer import Optimizer


def shape_batch_for_accum(batch: dict, microbatches: int) -> dict:
    """[B, ...] -> [M, B/M, ...] on every batch leaf (numpy or torch)."""
    def r(a):
        B = a.shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} is not a multiple of "
                             f"{microbatches} microbatches")
        return a.reshape((microbatches, B // microbatches)
                         + tuple(a.shape[1:]))
    return {k: r(v) for k, v in batch.items()}


def _on(device, batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(model, cfg, optimizer: Optimizer,
                    tracer: Optional[Tracer] = None):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, {"loss": f32 scalar tensor})``; ``params`` (a trainable
    :class:`~repro_torch.models.model.ParamTree`) and ``opt_state`` are
    updated in place.

    When ``cfg.microbatches`` M > 1 the batch must arrive shaped
    [M, B/M, ...] (:func:`shape_batch_for_accum`, or the pipeline's own
    microbatches): the loss and gradients of each microbatch in turn,
    the gradients summed in ``cfg.opt_dtype``, then ``g / M`` cast to f32
    and the loss ``sum / M``, as the reference's scan does.

    ``tracer`` (default: the process-wide one,
    :func:`~repro_torch.obs.spans.get_tracer`; ``train_step.tracer``)
    records a ``train.step`` span a call, inside it ``train.h2d`` (the
    batch to the device), per microbatch ``train.forward``,
    ``train.backward`` and (M > 1) ``train.accumulate``, then
    ``train.optimizer``; it also watches the garbage collector
    (:meth:`~repro_torch.obs.spans.Tracer.watch_gc`) while the step
    lives.  ``Tracer(enabled=False)`` records nothing.  Tracing changes
    no number the step computes."""
    M = max(1, cfg.microbatches)
    acc_dt = getattr(torch, cfg.opt_dtype)
    if tracer is None:
        tracer = get_tracer()
    span = tracer.span

    def train_step(params, opt_state, batch: dict, step: int):
        with span("train.step"):
            named = dict(params.named_parameters())
            leaves = list(named.values())
            dev = leaves[0].device
            with span("train.h2d"):
                batch = _on(dev, batch)
            if M == 1:
                with span("train.forward", microbatch=0):
                    loss = model.loss(params, batch)
                with span("train.backward", microbatch=0):
                    gs = torch.autograd.grad(loss, leaves)
                grads = dict(zip(named, gs))
                loss = loss.detach()
            else:
                gsum = {n: torch.zeros(p.shape, dtype=acc_dt, device=dev)
                        for n, p in named.items()}
                lsum = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(M):
                    mb = {k: v[i] for k, v in batch.items()}
                    with span("train.forward", microbatch=i):
                        loss = model.loss(params, mb)
                    with span("train.backward", microbatch=i):
                        gs = torch.autograd.grad(loss, leaves)
                    with span("train.accumulate", microbatch=i), \
                            torch.no_grad():
                        for n, g in zip(named, gs):
                            gsum[n].add_(g.to(acc_dt))
                        lsum = lsum + loss.detach()
                    del gs, loss
                with torch.no_grad():
                    # g / M in the accumulator dtype, then f32; in place
                    # where the accumulator is already f32
                    grads = {n: g.div_(M).float() for n, g in gsum.items()}
                loss = lsum / M
            with span("train.optimizer"):
                params, opt_state = optimizer.update(grads, opt_state,
                                                     params, step)
        return params, opt_state, {"loss": loss}

    train_step.tracer = tracer
    weakref.finalize(train_step, tracer.watch_gc().unwatch_gc)
    return train_step


# --------------------------------------------------------------------- #
# gradient compression across replicas                                  #
# --------------------------------------------------------------------- #
def _mean_of_sum(s16: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``pmean(g16).astype(f32)`` from the bf16 sum: XLA
    multiplies by the f32 reciprocal of ``n`` and, its bf16 result cast
    straight to f32, keeps the f32 product unrounded."""
    return s16.float().mul_(float(np.float32(1.0 / n)))


def make_compressed_psum_grads(axis: Optional[int] = None, *, group=None):
    """bf16-compressed mean of the gradients over replicas, with f32
    error feedback (port of the reference's function of that name).

    Returns ``f(grads, err) -> (reduced_f32, new_err)`` over dicts of
    tensors.  For each leaf, in the reference's order: ``g = g.float() +
    e``; ``g16 = g.to(bfloat16)``; the residual ``g - g16.float()`` is the
    new error, kept locally; the mean of ``g16`` over the replicas, in
    f32, is the reduced gradient.

    * ``axis``: every leaf carries the replicas on this axis (``[R, ...]``
      for ``axis=0``), as the reference runs under ``jax.vmap(...,
      axis_name="pod")``; the reduced leaf is broadcast back over it.  The
      mean is XLA's on the CPU: the bf16 replicas summed in order, each
      add rounded to bf16, then times the f32 reciprocal of R, unrounded.
    * ``group``: a ``torch.distributed`` process group; each rank holds
      its own leaves, summed by an all-reduce of the bf16 tensors (NCCL on
      the card, gloo on the CPU), then the same f32 scaling.  With two
      ranks the sum is one rounded add, as the replica form's; with more
      the all-reduce picks its own order of adds.

    Exactly one of ``axis`` and ``group`` must be given: without either
    there is nothing to reduce over, and the function raises rather than
    hand back the local gradient."""
    if (axis is None) == (group is None):
        raise ValueError("give a replica axis or a process group (exactly "
                         "one): there is nothing to reduce over")
    if group is not None:
        import torch.distributed as dist
        n = dist.get_world_size(group)

    def mean16(g16: torch.Tensor) -> torch.Tensor:
        if group is not None:
            s16 = g16.clone()
            dist.all_reduce(s16, op=dist.ReduceOp.SUM, group=group)
            return _mean_of_sum(s16, n)
        rep = g16.movedim(axis, 0)
        s16 = rep[0]
        for r in range(1, rep.shape[0]):
            s16 = s16 + rep[r]
        red = _mean_of_sum(s16, rep.shape[0])
        return red.unsqueeze(axis).expand(g16.shape).contiguous()

    def f(grads: dict, err: dict):
        red, new_err = {}, {}
        for name, g in grads.items():
            g = g.float() + err[name]
            g16 = g.to(torch.bfloat16)
            new_err[name] = g - g16.float()
            red[name] = mean16(g16)
        return red, new_err

    return f
