"""The model API of the port (port of ``repro.models.model`` for the
dense and hybrid families)::

    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    logits, caches = model.prefill(params, {"tokens": tokens}, max_len)
    logits, caches = model.decode_step(params, tokens, caches, pos)

Parameters are a :class:`ParamTree`, an ``nn.Module`` whose names are the
reference's tree paths with the stacked layer axis unrolled
(``blocks.mamba.3.in_proj``, ``blocks.3.attn.wq``);
:mod:`repro_torch.models.convert` builds one from the reference's
parameters.  The MoE, SSM, encoder-decoder and VLM families raise
``NotImplementedError`` until their slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from . import transformer as T
from .layers import _zeros, dense_init, rms_norm
from .mamba2 import mamba_params


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def padded_vocab(cfg) -> int:
    """Vocab rounded up to a multiple of 128 (padded logits are masked)."""
    return -(-cfg.vocab // 128) * 128


class ParamTree(nn.Module):
    """A nested parameter tree as an ``nn.Module``: dicts become
    submodules, lists ``nn.ModuleList``s, tensors frozen parameters (the
    serving path takes no gradient).  ``p[name]``, ``name in p`` and
    ``p.get(name)`` read it as the reference's functions read a dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(e) for e in v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default


# the families the port serves, and the layer stack each runs
STACKS = {"dense": T.dense_stack, "hybrid": T.hybrid_stack}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: object

    def __post_init__(self):
        if self.cfg.family not in STACKS:
            raise NotImplementedError(
                f"family {self.cfg.family!r}: later slice")

    def init(self, gen: torch.Generator) -> ParamTree:
        """Random parameters with the reference's shapes, dtypes and
        ``dense_init`` scales, drawn from ``gen`` on its device."""
        cfg = self.cfg
        dt = _dtype(cfg.param_dtype)
        D, V = cfg.d_model, padded_vocab(cfg)
        tree = {"embed": dense_init(gen, (V, D), dt, scale=1.0),
                "final_norm": _zeros(gen, (D,), dt)}
        if not cfg.tie_embeddings:
            tree["lm_head"] = dense_init(gen, (D, V), dt)
        if cfg.family == "dense":
            tree["blocks"] = [T.dense_block_params(gen, cfg, dt)
                              for _ in range(cfg.n_layers)]
        else:
            tree["blocks"] = {
                "mamba": [mamba_params(gen, cfg, dt)
                          for _ in range(cfg.n_layers)],
                "shared": T.dense_block_params(gen, cfg, dt)}
        return ParamTree(tree)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        ct = _dtype(self.cfg.compute_dtype)
        return F.embedding(tokens.long(), params["embed"].to(ct))

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        w = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"]).to(x.dtype)
        logits = x @ w
        Vp = logits.shape[-1]
        if Vp != cfg.vocab:   # mask the padded vocab tail
            logits = torch.where(
                torch.arange(Vp, device=x.device) < cfg.vocab, logits,
                -1e30)
        return logits

    def init_caches(self, batch: int, max_len: int, device) -> dict:
        cfg = self.cfg
        ct = _dtype(cfg.compute_dtype)
        if cfg.family == "dense":
            return T.init_attn_caches(cfg, cfg.n_layers, batch, max_len, ct,
                                      device)
        n_inv = cfg.n_layers // cfg.shared_attn_every
        return {"ssm": T.init_ssm_caches(cfg, cfg.n_layers, batch, ct,
                                         device),
                "attn": T.init_attn_caches(cfg, n_inv, batch, max_len, ct,
                                           device)}

    def prefill(self, params, batch: dict, max_len: int):
        """Forward over the prompt ``batch["tokens"]`` [B, S]; returns
        (last-token logits [B, 1, V], caches)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = params["embed"].device
        positions = torch.arange(S, device=dev).expand(B, S)
        x = self._embed(params, tokens)
        caches = self.init_caches(B, max_len, dev)
        x, caches = STACKS[self.cfg.family](
            params["blocks"], x, self.cfg, positions=positions,
            mode="causal", caches=caches)
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params, tokens: torch.Tensor, caches: dict,
                    pos: int):
        """One decode step.  tokens: [B]; pos: the position being written
        (== current cache length).  The caches are updated in place."""
        B = tokens.shape[0]
        positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                               device=params["embed"].device)
        x = self._embed(params, tokens[:, None])
        x, caches = STACKS[self.cfg.family](
            params["blocks"], x, self.cfg, positions=positions,
            mode="decode", caches=caches, cache_pos=pos)
        return self._logits(params, x), caches
