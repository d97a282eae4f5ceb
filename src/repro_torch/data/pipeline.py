"""Deterministic synthetic data pipeline with a checkpointable cursor (the
port's own copy of ``repro.data.pipeline``, numpy only).

The stream is a pure function of (seed, cursor): after a crash and a
restore the pipeline resumes from the manifest's cursor and reproduces the
same batches, which the bitwise crash-equivalence of ``run_training``
needs.  Batches are numpy arrays; the train step moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    cursor: int = 0


class TokenPipeline:
    """Batches of next-token-prediction data: ``tokens`` int32 [B, S+1],
    plus ``frames`` (encdec) or ``vis`` (vlm) f32, each reshaped to
    [M, B/M, ...] when ``microbatches`` M > 1."""

    def __init__(self, cfg, shape, *, seed: int = 0,
                 microbatches: int = 1):
        self.cfg = cfg
        self.B = shape.global_batch
        self.S = shape.seq_len
        self.M = microbatches
        self.state = PipelineState(seed=seed)

    def _tokens(self, cursor: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, cursor]))
        return rng.integers(0, self.cfg.vocab, size=(self.B, self.S + 1),
                            dtype=np.int64).astype(np.int32)

    def next_batch(self) -> dict:
        batch = {"tokens": self._tokens(self.state.cursor)}
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed ^ 0xABCD,
                                    self.state.cursor]))
        if self.cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (self.B, self.cfg.enc_seq, self.cfg.d_model),
                dtype=np.float32)
        if self.cfg.family == "vlm":
            batch["vis"] = rng.standard_normal(
                (self.B, self.cfg.vis_tokens, self.cfg.d_model),
                dtype=np.float32)
        self.state.cursor += 1
        if self.M > 1:
            batch = {k: v.reshape((self.M, self.B // self.M) + v.shape[1:])
                     for k, v in batch.items()}
        return batch

    # -- checkpoint integration ------------------------------------------ #
    def snapshot(self) -> dict:
        return dataclasses.asdict(self.state)

    def restore(self, snap: Optional[dict]) -> None:
        if snap:
            self.state = PipelineState(**snap)
