"""Modality frontend stubs (port of ``repro.models.frontends``).

whisper's audio and internvl2's vision configs specify the transformer
backbone only; their conv and ViT frontends are stubs that give
precomputed frame and patch embeddings of the right shape and dtype,
drawn here from a ``torch.Generator`` on its device.  Nothing in the
backbone or the serving path depends on how they were made.
"""
from __future__ import annotations

import torch


def synth_audio_frames(gen: torch.Generator, batch: int, cfg,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Stub for whisper's conv1d+GELU frontend: [B, enc_seq, d_model]."""
    return torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=gen,
                       device=gen.device).to(dtype)


def synth_vision_patches(gen: torch.Generator, batch: int, cfg,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """Stub for InternViT: [B, vis_tokens, d_model] patch embeddings."""
    return torch.randn((batch, cfg.vis_tokens, cfg.d_model), generator=gen,
                       device=gen.device).to(dtype)
