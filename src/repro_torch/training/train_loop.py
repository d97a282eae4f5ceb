"""The train step (port of ``repro.training.train_loop``): one forward and
backward, or a loop over microbatches with the gradients accumulated in
``cfg.opt_dtype``, then the optimizer's in-place update.

The reference's step is a jitted function of (params, opt_state, batch,
step) with a ``lax.scan`` over the microbatches; here it is an eager loop
over the microbatches, ``torch.autograd.grad`` for each.  The
reference's ``make_compressed_psum_grads`` (a cross-pod ``pmean`` with
bf16 compression) has no counterpart on one card.
"""
from __future__ import annotations

import torch

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


def make_train_step(model, cfg, optimizer: Optimizer):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, {"loss": f32 scalar tensor})``; ``params`` (a trainable
    :class:`~repro_torch.models.model.ParamTree`) and ``opt_state`` are
    updated in place.

    When ``cfg.microbatches`` M > 1 the batch must arrive shaped
    [M, B/M, ...] (:func:`shape_batch_for_accum`, or the pipeline's own
    microbatches): the loss and gradients of each microbatch in turn,
    the gradients summed in ``cfg.opt_dtype``, then ``g / M`` cast to f32
    and the loss ``sum / M``, as the reference's scan does."""
    M = max(1, cfg.microbatches)
    acc_dt = getattr(torch, cfg.opt_dtype)

    def train_step(params, opt_state, batch: dict, step: int):
        named = dict(params.named_parameters())
        leaves = list(named.values())
        dev = leaves[0].device
        batch = _on(dev, batch)
        if M == 1:
            loss = model.loss(params, batch)
            gs = torch.autograd.grad(loss, leaves)
            grads = dict(zip(named, gs))
            loss = loss.detach()
        else:
            gsum = {n: torch.zeros(p.shape, dtype=acc_dt, device=dev)
                    for n, p in named.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(M):
                mb = {k: v[i] for k, v in batch.items()}
                loss = model.loss(params, mb)
                gs = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    for n, g in zip(named, gs):
                        gsum[n].add_(g.to(acc_dt))
                    lsum = lsum + loss.detach()
                del gs, loss
            with torch.no_grad():
                # g / M in the accumulator dtype, then f32; in place where
                # the accumulator is already f32
                grads = {n: g.div_(M).float() for n, g in gsum.items()}
            loss = lsum / M
        params, opt_state = optimizer.update(grads, opt_state, params, step)
        return params, opt_state, {"loss": loss}

    return train_step
