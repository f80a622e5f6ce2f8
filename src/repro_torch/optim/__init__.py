"""Optimisers (``optim/`` of the reference): AdamW with float32 moments,
and its blockwise-int8 variant."""
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, clip_by_global_norm, init_opt_state,
    warmup_cosine,
)

__all__ = ["AdamWConfig", "adamw_update", "clip_by_global_norm",
           "init_opt_state", "warmup_cosine"]
