"""Checkpointing: pytree save/load + step-indexed CheckpointManager (the
reference's npz format, torch leaves)."""
from repro_torch.checkpointing.checkpoint import (CheckpointManager,
                                                  flatten_pytree,
                                                  latest_step, load_pytree,
                                                  map_pytree, save_pytree)

__all__ = ["CheckpointManager", "flatten_pytree", "latest_step",
           "load_pytree", "map_pytree", "save_pytree"]
