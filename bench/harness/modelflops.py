"""The frozen model-flop count: 2 flops a multiply-add of every matmul
weight a token passes through, the head included and the embedding
lookup not, plus each layer's sequence mixer by the kernels' frozen work
formulas, both from the configuration's family file
(``bench/families/<family>.py``).  Counted once as the model needs it:
no recompute."""
from __future__ import annotations

from bench import families


def train_step_flops(m: dict, batch: int, seq: int) -> int:
    """One train step over ``batch`` sequences of ``seq`` predicted
    tokens: forward and backward, 3 times the forward."""
    fam = families.of(m)
    fwd = 2 * fam.matmul_weights(m) * batch * seq \
        + fam.mixer_flops(m, batch, seq, seq, causal=True)
    return 3 * fwd


def serve_call_flops(m: dict, batch: int, prompt: int, new: int) -> int:
    """Serving ``batch`` prompts of ``prompt`` tokens with ``new`` greedy
    tokens each: the prompt's forward, then a decode step for each
    generated token but the last (whose successor is not needed)."""
    fam = families.of(m)
    w = 2 * fam.matmul_weights(m)
    flops = w * batch * prompt + fam.mixer_flops(m, batch, prompt, prompt,
                                                 causal=True)
    for i in range(new - 1):
        flops += w * batch + fam.mixer_flops(m, batch, 1, prompt + i + 1,
                                             causal=False)
    return flops
