"""Small tree utilities (``utils/`` of the reference)."""
from repro_torch.utils.tree import (
    global_sq_norm, tree_add, tree_bytes, tree_cast, tree_flatten, tree_leaves,
    tree_map, tree_scale, tree_size, tree_unflatten, tree_zeros_like,
)

__all__ = ["global_sq_norm", "tree_add", "tree_bytes", "tree_cast",
           "tree_flatten", "tree_leaves", "tree_map", "tree_scale", "tree_size",
           "tree_unflatten", "tree_zeros_like"]
