"""repro_torch.optim — AdamW with quantized-state options, schedules,
clipping; the JAX package's ``repro.optim`` on torch tensors."""
from .adamw import (Q8_BLOCK, adamw_init, adamw_update, dequantize_q8,
                    quantize_q8)
from .clip import clip_by_global_norm, global_norm
from .schedules import cosine_schedule, make_schedule, wsd_schedule
from .tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["Q8_BLOCK", "adamw_init", "adamw_update", "quantize_q8",
           "dequantize_q8", "clip_by_global_norm", "global_norm",
           "cosine_schedule", "wsd_schedule", "make_schedule", "tree_leaves",
           "tree_map", "tree_unflatten"]
