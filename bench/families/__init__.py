"""One file a model family, found by the ``family`` of a configuration's
``model`` block: ``bench/families/<family>.py``.  Each states what the
harness needs of its family beside its plain reference
(``bench/reference/<family>.py``):

* ``ARCH_KEYS``: the program's ArchConfig fields that the ``model`` block
  fixes, held equal before a run;
* ``COUNTERS``: the program's kernel wrappers whose launch counters a
  traced run copies, ``{name: (module, attribute)}``;
* ``published(source_config)``: the ``model`` values the published
  configuration implies, which a CPU test holds the ``model`` block to
  but for the keys the configuration lists in ``reduced`` or
  ``departures``;
* ``matmul_weights(m)`` and ``mixer_flops(m, B, Sq, Sk, causal=...)``:
  the family's part of the frozen model-flop count
  (``bench/harness/modelflops.py``).

A new family is a new file here and a new reference; nothing else
changes."""
from __future__ import annotations

import importlib


def of(m: dict):
    """The family module of a configuration's ``model`` block."""
    return importlib.import_module(f"bench.families.{m['family']}")
