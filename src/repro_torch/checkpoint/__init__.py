"""Checkpoints and named-array ``.npz`` files in the reference's manifest
format."""

from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         load_arrays, restore_checkpoint,
                                         save_arrays, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_arrays",
           "restore_checkpoint", "save_arrays", "save_checkpoint"]
