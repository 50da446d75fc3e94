"""Checkpoint substrate of the port: sharded atomic async save/restore in
the JAX package's on-disk format, elastic reassembly."""

from .manager import (CheckpointManager, latest_step, restore_pytree,
                      save_pytree)

__all__ = ["CheckpointManager", "latest_step", "restore_pytree",
           "save_pytree"]
