"""PyTorch/CUDA port of the ML-ECS reproduction.

The package mirrors the layout of ``repro`` (the JAX reference) module for
module.  It imports ``torch`` and never ``jax`` or ``repro``: what it needs
from the reference's numpy-only host code it keeps as its own copy.

The slice ported so far is the serving path: the continuous-batching
engine (``launch.serve_engine``) over the paged KV cache
(``models.paged``) for the dense family, with the decode and prefill
attention as hand-written CUDA kernels (``kernels/csrc``).
"""
