"""Plain torch version of the range-mask kernel."""
from __future__ import annotations

import torch

from repro_torch.core.sorted_ops import INT_SENTINEL


def range_mask_ref(rows: torch.Tensor, cols: torch.Tensor,
                   bounds) -> torch.Tensor:
    """keep[t] = rows[t] ∈ [b[0], b[1]) ∧ cols[t] ∈ [b[2], b[3]) ∧
    rows[t] ≠ SENT, as int32."""
    b = [int(x) for x in bounds]
    valid = rows != int(INT_SENTINEL)
    keep = (valid & (rows >= b[0]) & (rows < b[1])
            & (cols >= b[2]) & (cols < b[3]))
    return keep.to(torch.int32)
