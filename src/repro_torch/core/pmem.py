"""The implicit-eviction crash adversary shared by the port's crash models
(the port's own copy of ``repro.core.pmem.evicted_mask``)."""
from __future__ import annotations

import numpy as np


def evicted_mask(n: int, evict, rng: np.random.Generator,
                 p_evict: float = 0.5) -> np.ndarray:
    """Given ``n`` pending items (staged-but-unfenced files for
    :class:`repro_torch.persistence.manifest.StagedIO`), return a bool
    mask -- True means that item happened to reach durable storage at the
    crash.  Seedable via ``rng`` so adversarial schedules replay exactly;
    unknown modes raise.

    >>> evicted_mask(3, "none", np.random.default_rng(0)).tolist()
    [False, False, False]
    >>> evicted_mask(3, "all", np.random.default_rng(0)).tolist()
    [True, True, True]
    >>> a = evicted_mask(5, "random", np.random.default_rng(7))
    >>> b = evicted_mask(5, "random", np.random.default_rng(7))
    >>> bool((a == b).all())
    True
    """
    if evict == "none":
        return np.zeros(n, dtype=bool)
    if evict == "all":
        return np.ones(n, dtype=bool)
    if evict == "random":
        return rng.random(n) < p_evict
    raise ValueError(f"unknown evict mode {evict!r}")
