"""PyTorch/CUDA port of the NVTraverse durable-map system.

Beside the JAX package ``repro`` (the reference), with the same module
layout.  It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Entry points take ``device=None``, which means the card and
raises when there is none; pass ``device="cpu"`` to run on the host.
"""
