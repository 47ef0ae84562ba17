"""Plain torch version of the semiring matmul kernel."""
from __future__ import annotations

import torch

from repro_torch.core.semiring import get_semiring


def semiring_matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
                        semiring="plus_times") -> torch.Tensor:
    """``C[i,j] = ⊕_k a[i,k] ⊗ b[k,j]`` in fp32 (``Semiring.matmul_dense``)."""
    sr = get_semiring(semiring)
    return sr.matmul_dense(a.to(torch.float32), b.to(torch.float32))
