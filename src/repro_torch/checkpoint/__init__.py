"""Numpy checkpoints in the reference package's on-disk layout."""
from repro_torch.checkpoint.store import (
    CheckpointManager, gc_incomplete, latest_step, load_arrays, save_arrays,
)

__all__ = ["CheckpointManager", "gc_incomplete", "latest_step",
           "load_arrays", "save_arrays"]
