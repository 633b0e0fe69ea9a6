"""Checkpoint and resume of the whole train state."""

from .checkpoint import CheckpointWriter, latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointWriter"]
