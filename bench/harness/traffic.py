"""The one seeded generator every traffic file is read by.

A traffic file (``bench/traffic/<name>.json``) holds parameters only.
``kind: "train"`` is a feed of token rows for next-token training;
``kind: "serve"`` is a closed loop of calls, each a batch of fresh
requests whose prompt lengths follow the mix's distribution, with some
of the previous call's requests sent again.  The same seed gives the
same inputs; different seeds give the same sizes in another order, so a
seed changes which tokens and which request gets which length, never
how much work.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def seeded(seed: int, *salt) -> np.random.Generator:
    """A generator keyed by the run's seed (any whole number) and a salt."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), *salt]))


def train_rows(seed: int, step: int, batch: int, seq: int,
               vocab: int) -> np.ndarray:
    """Step ``step``'s rows: int32 [batch, seq + 1] drawn uniformly from
    the vocabulary, fresh for every step."""
    return seeded(seed, 1, step).integers(0, vocab, size=(batch, seq + 1),
                                        dtype=np.int64).astype(np.int32)


def call_lengths(calls: dict) -> list:
    """The prompt lengths of every call, the same for every seed: the
    ``requests_per_call`` quantiles at (i + 1/2) / n of a log-normal with
    the mix's ``median`` and ``sigma``, each cut down to whole blocks of
    ``block`` tokens, at least one block and at most ``max`` tokens."""
    L, n = calls["lengths"], calls["requests_per_call"]
    if L["max"] % L["block"]:
        raise ValueError("the longest prompt must be whole blocks")
    out = []
    for i in range(n):
        x = math.exp(math.log(L["median"])
                     + L["sigma"] * NormalDist().inv_cdf((i + 0.5) / n))
        out.append(min(L["max"], max(1, int(x // L["block"])) * L["block"]))
    return out


class Call:
    """One call: ``fresh`` and ``resent``, each ``{rid: prompt}``."""

    def __init__(self, fresh: dict, resent: dict):
        self.fresh, self.resent = fresh, resent

    def requests(self) -> dict:
        return {**self.fresh, **self.resent}


class ServeCalls:
    """The closed loop's calls, in order.  Each holds
    ``requests_per_call`` fresh requests, the lengths of
    :func:`call_lengths` handed to its rids in a seeded order, and sends
    again ``resend_per_call`` requests of the call before, drawn by the
    seed: a client retrying what it lost an answer to."""

    def __init__(self, seed: int, calls: dict, vocab: int,
                 first_rid: int = 1):
        self.seed, self.calls, self.vocab = seed, calls, vocab
        self.lengths = call_lengths(calls)
        self.next_rid = first_rid
        self.k = 0
        self.prev: dict = {}

    def next_call(self) -> Call:
        rng = seeded(self.seed, 3, self.k)
        order = rng.permutation(len(self.lengths))
        fresh = {}
        for j in order:
            fresh[self.next_rid] = rng.integers(
                0, self.vocab, size=self.lengths[j],
                dtype=np.int64).astype(np.int32)
            self.next_rid += 1
        old = sorted(self.prev)
        k = min(self.calls["resend_per_call"], len(old))
        resent = {old[i]: self.prev[old[i]]
                  for i in sorted(rng.choice(len(old), size=k,
                                             replace=False))}
        self.prev = fresh
        self.k += 1
        return Call(fresh, resent)
