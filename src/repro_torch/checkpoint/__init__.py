"""repro_torch.checkpoint — async save / restore, in the JAX package's
on-disk format."""
from .checkpoint import (CheckpointManager, restore_checkpoint,
                         save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
