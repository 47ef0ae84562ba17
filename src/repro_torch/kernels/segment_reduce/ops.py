"""Constructor-style aggregation of sorted COO runs: the segmented-scan
CUDA kernel (``csrc/segment_scan.cu``) or its plain version.

``impl="auto"`` launches the kernel on CUDA tensors and runs the plain
version on CPU tensors.  As in the JAX package, the kernel route pads to a
multiple of 256 with the key ``2^31 - 1`` and the value 0 (the pads come
after every real element, so they change no output that is kept), and no
caller in ``core/`` uses it yet: the dedup of ``core/coo.py`` aggregates
with its own torch ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib
from .ref import COMBINE, segment_scan_ref

COMBINE_IDS = {"sum": 0, "min": 1, "max": 2}
PAD = 256
BLOCK = 1024      # elements per block of the kernel's first pass
PAD_KEY = 2 ** 31 - 1


def pad_for_kernel(keys: torch.Tensor, vals: torch.Tensor):
    """Keys (int32) and values (fp32) padded to a multiple of 256."""
    pad = (-keys.shape[0]) % PAD
    keys = F.pad(keys.to(torch.int32), (0, pad), value=PAD_KEY)
    vals = F.pad(vals.to(torch.float32), (0, pad))
    return keys.contiguous(), vals.contiguous()


def segment_scan_cuda(keys: torch.Tensor, vals: torch.Tensor, *,
                      combine: str = "sum") -> torch.Tensor:
    """The kernel: int32 sorted ``keys`` and fp32 ``vals`` [N] on one sm_90
    card → fp32 [N].  Unsorted keys give runs of adjacent equal keys."""
    cuda_lib.check_cuda(keys, vals)
    if combine not in COMBINE_IDS:
        raise ValueError(f"unknown combine {combine!r}; expected "
                         f"{sorted(COMBINE_IDS)}")
    if keys.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError("segment_scan_cuda takes int32 keys and fp32 values")
    if keys.dim() != 1 or keys.shape != vals.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and vals "
                         f"{tuple(vals.shape)} must be one 1-D shape")
    keys, vals = keys.contiguous(), vals.contiguous()
    if keys.data_ptr() % 16 or vals.data_ptr() % 16:   # 16-byte loads
        keys, vals = keys.clone(), vals.clone()
    n = keys.shape[0]
    out = torch.empty_like(vals)
    if n == 0:                    # no grid to launch: nothing to scan
        return out
    nb = -(-n // BLOCK)
    scratch = torch.empty(4 * nb, dtype=torch.int32, device=keys.device)
    cuda_lib.launch("segment_scan", COMBINE_IDS[combine], keys.data_ptr(),
                    vals.data_ptr(), out.data_ptr(), n, scratch.data_ptr(),
                    cuda_lib.stream_ptr(keys))
    return out


def segment_scan(keys: torch.Tensor, vals: torch.Tensor, *,
                 combine: str = "sum", impl: str = "auto") -> torch.Tensor:
    """Inclusive segmented ⊕-scan; run-last positions hold run totals."""
    if combine not in COMBINE:
        raise ValueError(f"unknown combine {combine!r}; expected "
                         f"{sorted(COMBINE)}")
    if cuda_lib.resolve_impl(impl, keys) == "ref":
        return segment_scan_ref(keys, vals, combine=combine)
    n = keys.shape[0]
    kp, vp = pad_for_kernel(keys, vals)
    return segment_scan_cuda(kp, vp, combine=combine)[:n]


def aggregate_runs(keys: torch.Tensor, vals: torch.Tensor, *,
                   combine: str = "sum", impl: str = "auto"):
    """(keys, aggregated value at each run head, head mask)."""
    scanned = segment_scan(keys, vals, combine=combine, impl=impl)
    if keys.shape[0] == 0:
        return keys, scanned, torch.zeros(0, dtype=torch.bool,
                                          device=keys.device)
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    differs = keys[1:] != keys[:-1]
    run_last = torch.cat([differs, one])
    is_head = torch.cat([one, differs])
    # value for each head = scanned value at its run's last position
    head_vals = torch.zeros_like(scanned)
    head_vals[is_head] = scanned[run_last]
    return keys, head_vals, is_head
