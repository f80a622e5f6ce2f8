"""Numpy checkpoints in the reference package's on-disk layout: flat
name->array snapshots and trees of tensors."""
from repro_torch.checkpoint.store import (
    CheckpointManager, gc_incomplete, latest_step, load_arrays,
    restore_checkpoint, restore_extra, save_arrays, save_checkpoint,
)

__all__ = ["CheckpointManager", "gc_incomplete", "latest_step",
           "load_arrays", "restore_checkpoint", "restore_extra",
           "save_arrays", "save_checkpoint"]
