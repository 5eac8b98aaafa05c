"""Checkpoints of the port, in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "latest_checkpoint", "load_checkpoint",
           "save_checkpoint"]
