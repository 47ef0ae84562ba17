"""COO keep-masks for compiled rank-range selections.

``range_mask`` is the device half of the selector algebra's range fast
path (:mod:`repro_torch.core.select`): the host compiles a selector to
``[lo, hi)`` rank bounds, the device masks its padded COO triples — the
selection never densifies.  ``impl="auto"`` launches the CUDA kernel
(``csrc/range_mask.cu``) on CUDA tensors and the plain version on CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from .ref import range_mask_ref


def _bounds(bounds):
    """Four ints (row_lo, row_hi, col_lo, col_hi) from a sequence or a
    tensor of any shape."""
    if isinstance(bounds, torch.Tensor):
        bounds = bounds.reshape(-1).tolist()
    b = [int(x) for x in bounds]
    if len(b) != 4:
        raise ValueError(f"bounds must hold 4 entries, got {len(b)}")
    return b


def range_mask_cuda(rows: torch.Tensor, cols: torch.Tensor,
                    bounds) -> torch.Tensor:
    """The kernel: int32 rows/cols [N] on one sm_90 card → int32 keep [N]."""
    cuda_lib.check_cuda(rows, cols)
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("range_mask takes int32 rows and cols")
    if rows.shape != cols.shape or rows.dim() != 1:
        raise ValueError(f"rows {tuple(rows.shape)} / cols "
                         f"{tuple(cols.shape)} must be one 1-D shape")
    # 16-byte (int4) loads need 16-byte-aligned, contiguous operands
    rows, cols = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                  else t.clone() for t in (rows, cols))
    keep = torch.empty_like(rows)
    if rows.shape[0] == 0:        # no grid to launch: nothing to count
        return keep
    rlo, rhi, clo, chi = _bounds(bounds)
    cuda_lib.launch("range_mask", rows.data_ptr(), cols.data_ptr(),
                    keep.data_ptr(), rows.shape[0], rlo, rhi, clo, chi,
                    cuda_lib.stream_ptr(rows))
    return keep


def range_mask(rows: torch.Tensor, cols: torch.Tensor, bounds, *,
               impl: str = "auto") -> torch.Tensor:
    """keep[t] ∈ {0, 1}: triple t inside the (row, col) rank box.

    ``rows``/``cols``: int32[N] sentinel-padded; ``bounds``: the 4 ints
    (row_lo, row_hi, col_lo, col_hi), as a sequence or a tensor.
    """
    if cuda_lib.resolve_impl(impl, rows) == "ref":
        return range_mask_ref(rows, cols, _bounds(bounds))
    return range_mask_cuda(rows, cols, bounds)
