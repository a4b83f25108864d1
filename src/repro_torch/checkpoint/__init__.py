"""Checkpoints of the port (port of ``repro.checkpoint``), in the JAX
package's on-disk format."""
from repro_torch.checkpoint.checkpointer import Checkpointer, restore, save

__all__ = ["Checkpointer", "save", "restore"]
