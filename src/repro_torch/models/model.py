"""The model API of the port over every family (port of
``repro.models.model``)::

    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    loss = model.loss(params, batch)        # train step body
    logits, caches = model.prefill(params, batch, max_len)
    logits, caches = model.decode_step(params, tokens, caches, pos)

Batch conventions (the reference's; ``loss`` takes ``tokens`` [B, S+1]
and predicts each next token, numpy arrays or tensors):

  * lm (dense/moe/ssm/hybrid): ``{"tokens": int[B, S]}``;
  * encdec (whisper): ``{"frames": f[B, enc_seq, D] (conv-stub output),
    "tokens": int[B, S]}``;
  * vlm (internvl2): ``{"vis": f[B, vis_tokens, D] (ViT-stub output),
    "tokens": int[B, S]}``; the vision prefix takes positions
    ``0 .. vis_tokens - 1``, so decode writes at ``vis_tokens + S + i``.

Parameters are a :class:`ParamTree`, an ``nn.Module`` whose names are the
reference's tree paths with the stacked layer axis unrolled
(``blocks.mamba.3.in_proj``, ``blocks.3.attn.wq``, ``encoder.0.mlp.w_up``);
:mod:`repro_torch.models.convert` builds one from the reference's
parameters.  They are frozen unless built with ``trainable=True``: the
serving path takes no gradient, training takes them all.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from . import transformer as T
from .layers import ShapesOnly, _zeros, dense_init, rms_norm
from .mamba2 import mamba_params

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def prefix_tokens(cfg) -> int:
    """Positions a VLM's vision prefix takes before the prompt (0 for the
    other families): decode writes at ``prefix_tokens + S + i``."""
    return cfg.vis_tokens if cfg.family == "vlm" else 0


def padded_vocab(cfg) -> int:
    """Vocab rounded up to a multiple of 128 (padded logits are masked)."""
    return -(-cfg.vocab // 128) * 128


class ParamTree(nn.Module):
    """A nested parameter tree as an ``nn.Module``: dicts become
    submodules, lists ``nn.ModuleList``s, tensors parameters, frozen (the
    serving path takes no gradient) unless ``trainable``.  ``p[name]``,
    ``name in p`` and ``p.get(name)`` read it as the reference's functions
    read a dict; ``dict(p.named_parameters())`` is the flat state dict that
    the optimizer and ``run_training``'s checkpoints key by name."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v, trainable))
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(e, trainable)
                                                    for e in v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=trainable))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: object

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"family {self.cfg.family!r}")

    def init(self, gen: torch.Generator,
             trainable: bool = False) -> ParamTree:
        """Random parameters with the reference's shapes, dtypes and
        ``dense_init`` scales, drawn from ``gen`` on its device; frozen
        unless ``trainable``."""
        cfg = self.cfg
        dt = _dtype(cfg.param_dtype)
        D, V = cfg.d_model, padded_vocab(cfg)
        tree = {"embed": dense_init(gen, (V, D), dt, scale=1.0),
                "final_norm": _zeros(gen, (D,), dt)}
        if not cfg.tie_embeddings:
            tree["lm_head"] = dense_init(gen, (D, V), dt)
        fam, L = cfg.family, cfg.n_layers
        if fam in ("dense", "vlm"):
            tree["blocks"] = [T.dense_block_params(gen, cfg, dt)
                              for _ in range(L)]
        elif fam == "moe":
            tree["blocks"] = [T.moe_block_params(gen, cfg, dt)
                              for _ in range(L)]
        elif fam == "ssm":
            tree["blocks"] = [mamba_params(gen, cfg, dt) for _ in range(L)]
        elif fam == "hybrid":
            tree["blocks"] = {
                "mamba": [mamba_params(gen, cfg, dt) for _ in range(L)],
                "shared": T.dense_block_params(gen, cfg, dt)}
        else:   # encdec
            tree["encoder"] = [T.dense_block_params(gen, cfg, dt)
                               for _ in range(cfg.enc_layers)]
            tree["enc_pos"] = dense_init(gen, (cfg.enc_seq, D), dt,
                                         scale=0.02)
            tree["enc_norm"] = _zeros(gen, (D,), dt)
            tree["blocks"] = [T.encdec_block_params(gen, cfg, dt)
                              for _ in range(L)]
            tree["dec_pos"] = dense_init(gen, (8192, D), dt, scale=0.02)
        return ParamTree(tree, trainable)

    def init_shapes(self, trainable: bool = False) -> ParamTree:
        """The parameters as meta tensors: :meth:`init`'s names, shapes
        and dtypes, no data (the dry-run's cells)."""
        return self.init(ShapesOnly(), trainable)

    def _embed(self, params, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ct = _dtype(cfg.compute_dtype)
        x = F.embedding(tokens.long(), params["embed"].to(ct))
        if cfg.family == "encdec" and cfg.rope_theta <= 0:
            # absolute positional embeddings (whisper's decoder)
            pe = params["dec_pos"].to(ct)
            x = x + pe[positions.long().clamp(0, pe.shape[0] - 1)]
        return x

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

    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ct = _dtype(cfg.compute_dtype)
        x = frames.to(ct) + params["enc_pos"].to(ct)[None]
        x = T.encoder_stack(params["encoder"], x, cfg)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _backbone(self, params, x: torch.Tensor, *, positions, mode: str,
                  caches=None, cache_pos=None, enc_out=None):
        """The family's layer stack; returns (x, caches, the MoE aux loss
        (0 for the other families)), the caches updated in place.  An
        encdec model's caches are ``{"self", "cross"}`` or None; its
        prefill and its loss give the encoder output ``enc_out``, which
        fills the cross caches when they are given."""
        cfg, fam = self.cfg, self.cfg.family
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if fam in ("dense", "vlm"):
            x, _ = T.dense_stack(params["blocks"], x, cfg,
                                 positions=positions, mode=mode,
                                 caches=caches, cache_pos=cache_pos)
        elif fam == "moe":
            x, _, aux = T.moe_stack(params["blocks"], x, cfg,
                                    positions=positions, mode=mode,
                                    caches=caches, cache_pos=cache_pos)
        elif fam == "ssm":
            x, _ = T.ssm_stack(params["blocks"], x, cfg, caches=caches)
        elif fam == "hybrid":
            x, _ = T.hybrid_stack(params["blocks"], x, cfg,
                                  positions=positions, mode=mode,
                                  caches=caches, cache_pos=cache_pos)
        else:   # encdec
            x, _, _ = T.decoder_stack(
                params["blocks"], x, cfg, positions=positions, mode=mode,
                enc_out=enc_out,
                xa_caches=None if caches is None else caches["cross"],
                caches=None if caches is None else caches["self"],
                cache_pos=cache_pos)
        return x, caches, aux

    def loss(self, params, batch: dict) -> torch.Tensor:
        """Mean next-token NLL of ``batch["tokens"]`` [B, S+1] (and the
        family's ``vis`` or ``frames``), in f32: a VLM's vision prefix is
        prepended and dropped from the logits, an encoder-decoder's frames
        run through the encoder, and a MoE adds ``0.01 * aux``.  Batch
        leaves may be numpy arrays; they are moved to the parameters'
        device."""
        cfg = self.cfg
        dev = params["embed"].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        B, S = inp.shape
        positions = torch.arange(S, device=dev).expand(B, S)
        x = self._embed(params, inp, positions)
        n_prefix, enc_out = 0, None
        if cfg.family == "vlm":
            vis = torch.as_tensor(batch["vis"], device=dev)
            x = torch.cat([vis.to(x.dtype), x], dim=1)
            n_prefix = vis.shape[1]
            positions = torch.arange(n_prefix + S, device=dev).expand(
                B, n_prefix + S)
        if cfg.family == "encdec":
            enc_out = self._encode(params, torch.as_tensor(
                batch["frames"], device=dev))
        x, _, aux = self._backbone(params, x, positions=positions,
                                   mode="causal", enc_out=enc_out)
        if n_prefix:
            x = x[:, n_prefix:]
        logits = self._logits(params, x).float()
        lse = torch.logsumexp(logits, dim=-1)
        # The label's logit by a gather where the reference contracts a
        # one-hot over the vocab: the same number (every other term of the
        # one-hot sum is an exact zero), without the [B, S, V] f32 one-hot
        # (5 GB at qwen3-1.7b's B = 2, S = 4096).
        picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        loss = torch.mean(lse - picked)
        if cfg.family == "moe":
            loss = loss + 0.01 * aux
        return loss

    def init_caches(self, batch: int, max_len: int, device) -> dict:
        cfg = self.cfg
        ct = _dtype(cfg.compute_dtype)
        fam, L = cfg.family, cfg.n_layers
        if fam in ("dense", "vlm", "moe"):
            return T.init_attn_caches(cfg, L, batch, max_len, ct, device)
        if fam == "ssm":
            return T.init_ssm_caches(cfg, L, batch, ct, device)
        if fam == "hybrid":
            n_inv = L // cfg.shared_attn_every
            return {"ssm": T.init_ssm_caches(cfg, L, batch, ct, device),
                    "attn": T.init_attn_caches(cfg, n_inv, batch, max_len,
                                               ct, device)}
        # encdec: the cross buffers, sized to the encoder output, are
        # filled by prefill with the projected encoder k/v
        return {"self": T.init_attn_caches(cfg, L, batch, max_len, ct,
                                           device),
                "cross": T.init_attn_caches(cfg, L, batch, cfg.enc_seq, ct,
                                            device)}

    def prefill(self, params, batch: dict, max_len: int):
        """Forward over the prompt ``batch["tokens"]`` [B, S] (and the
        family's ``vis`` or ``frames``); returns (last-token logits
        [B, 1, V], caches)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = params["embed"].device
        positions = torch.arange(S, device=dev).expand(B, S)
        x = self._embed(params, tokens, positions)
        caches = self.init_caches(B, max_len, dev)
        if cfg.family == "vlm":
            x = torch.cat([batch["vis"].to(x.dtype), x], dim=1)
            Sv = x.shape[1]
            positions = torch.arange(Sv, device=dev).expand(B, Sv)
        enc_out = self._encode(params, batch["frames"]) \
            if cfg.family == "encdec" else None
        x, caches, _ = self._backbone(params, x, positions=positions,
                                      mode="causal", caches=caches,
                                      enc_out=enc_out)
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params, tokens: torch.Tensor, caches: dict,
                    pos: int):
        """One decode step.  tokens: [B]; pos: the position being written
        (== current cache length, the vision prefix included).  The
        caches are updated in place."""
        B = tokens.shape[0]
        positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                               device=params["embed"].device)
        x = self._embed(params, tokens[:, None], positions)
        x, caches, _ = self._backbone(params, x, positions=positions,
                                      mode="decode", caches=caches,
                                      cache_pos=pos)
        return self._logits(params, x), caches


def build_model(cfg) -> Model:
    return Model(cfg)
