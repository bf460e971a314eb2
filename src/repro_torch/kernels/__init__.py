"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the dispatching wrappers in :mod:`repro_torch.kernels.ops`."""
