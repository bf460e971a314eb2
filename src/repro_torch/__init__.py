"""PyTorch/CUDA port of the ML-ECS reproduction.

The package mirrors the layout of ``repro`` (the JAX reference) module for
module.  It imports ``torch`` and never ``jax`` or ``repro``: what it needs
from the reference's numpy-only host code it keeps as its own copy.

The slices ported so far: the serving path (the continuous-batching
engine ``launch.serve_engine`` over the paged KV cache ``models.paged``)
for the dense, ssm (mamba2) and hybrid (hymba) families; one federated
round of Algorithm 1 on the loop engine (``core.federated``); and the
int8/int4 wire (``core.channel``).  Every TPU kernel of the reference has
a hand-written CUDA counterpart under ``kernels/csrc``.
"""
