from repro_torch.utils.tree import (clip_by_global_norm, global_norm,
                                    param_count, sum_squares, tree_leaves,
                                    tree_map, tree_unflatten)

__all__ = ["clip_by_global_norm", "global_norm", "param_count",
           "sum_squares", "tree_leaves", "tree_map", "tree_unflatten"]
