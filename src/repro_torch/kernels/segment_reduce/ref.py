"""Plain torch version of the segmented scan: Hillis-Steele doubling over
sorted key runs (the JAX oracle's ``associative_scan`` does the same
log-depth combine)."""
from __future__ import annotations

import torch

COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def segment_scan_ref(keys: torch.Tensor, vals: torch.Tensor, *,
                     combine: str = "sum") -> torch.Tensor:
    """Inclusive ⊕-scan of ``vals`` (as fp32) within each run of equal,
    sorted ``keys``: out[i] = ⊕ of vals[j] over j <= i with keys[j] ==
    keys[i]."""
    comb = COMBINE[combine]
    acc = vals.to(torch.float32).clone()
    n = keys.shape[0]
    step = 1
    while step < n:
        # keys are sorted, so equal keys `step` apart bound one run
        same = keys[step:] == keys[:-step]
        acc[step:] = torch.where(same, comb(acc[:-step], acc[step:]),
                                 acc[step:])
        step *= 2
    return acc
