"""Constructor-style aggregation of sorted COO runs: the segmented-scan
CUDA kernel (``csrc/segment_scan.cu``) or its plain version.

``impl="auto"`` launches the kernel on CUDA tensors and runs the plain
version on CPU tensors.  As in the JAX package, the kernel route pads to a
multiple of 256 with the key ``2^31 - 1`` and the value 0 (the pads come
after every real element, so they change no output that is kept), and no
caller in ``core/`` uses it yet: the dedup of ``core/coo.py`` aggregates
with its own torch ops.

A call is one launch: a persistent grid that scans tiles of 4096 elements
and finds each tile's carry by a decoupled look-back over 64-bit status
words, each tagged with the call's epoch.  The words are this module's own,
one buffer per (device, stream), zeroed when it is allocated or grown and
when its epochs wrap, and written by no one else: so every word there is 0
or an earlier call's, neither of which carries the current epoch, and no
memset comes before a call.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib
from .ref import COMBINE, KERNEL_TILE, segment_scan_ref

COMBINE_IDS = {"sum": 0, "min": 1, "max": 2}
PAD = 256
TILE = KERNEL_TILE  # elements per tile of the kernel
PAD_KEY = 2 ** 31 - 1
_WARP = 32

EPOCH_MAX = 2 ** 31 - 1

_STATUS_LOCK = threading.Lock()
# (device, stream) -> (status words, the epoch of the last call on them)
_status: dict = {}


def status_words(n: int, device, stream: int) -> tuple[torch.Tensor, int]:
    """The status words of ``stream`` on ``device``, with room for a call
    on ``n`` elements, and that call's epoch (1 .. 2^31 - 1).  A new or
    grown buffer is zeroed and starts again at epoch 1, and so does one
    whose epochs are spent: no word there can carry the epoch returned."""
    words = scratch_words(n)
    with _STATUS_LOCK:
        buf, epoch = _status.get((device, stream), (None, 0))
        if buf is None or buf.numel() < words:
            buf, epoch = torch.zeros(words, dtype=torch.int64,
                                     device=device), 0
        elif epoch == EPOCH_MAX:
            buf.zero_()
            epoch = 0
        epoch += 1
        _status[(device, stream)] = (buf, epoch)
    return buf, epoch


def scratch_words(n: int) -> int:
    """uint64 status words a call on ``n`` elements needs: every tile's,
    then one level of group summaries for each factor of 32 tiles beyond
    the first (as ``segment_scan_scratch_words`` in the source)."""
    if n <= 0:
        return 0
    size = -(-n // TILE)
    words = size
    while size > _WARP:
        size = -(-size // _WARP)
        words += size
    return words


def pad_for_kernel(keys: torch.Tensor, vals: torch.Tensor):
    """Keys (int32) and values (fp32) padded to a multiple of 256."""
    pad = (-keys.shape[0]) % PAD
    keys = F.pad(keys.to(torch.int32), (0, pad), value=PAD_KEY)
    vals = F.pad(vals.to(torch.float32), (0, pad))
    return keys.contiguous(), vals.contiguous()


def segment_scan_cuda(keys: torch.Tensor, vals: torch.Tensor, *,
                      combine: str = "sum") -> torch.Tensor:
    """The kernel: int32 ``keys`` and fp32 ``vals`` [N] on one sm_90 card →
    fp32 [N], the scan over runs of adjacent equal keys."""
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
    stream = cuda_lib.stream_ptr(keys)
    status, epoch = status_words(n, keys.device, stream)
    cuda_lib.launch("segment_scan", COMBINE_IDS[combine], keys.data_ptr(),
                    vals.data_ptr(), out.data_ptr(), n, status.data_ptr(),
                    status.numel(), epoch, stream)
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
    n = keys.shape[0]
    if n == 0:
        return keys, scanned, torch.zeros(0, dtype=torch.bool,
                                          device=keys.device)
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    is_head = torch.cat([one, keys[1:] != keys[:-1]])
    # each head's run ends before the next head: a reverse running minimum
    # of the head positions (n where none), all on the device
    idx = torch.arange(n, device=keys.device)
    nxt = torch.where(is_head, idx, torch.full_like(idx, n))
    nxt = nxt.flip(0).cummin(0).values.flip(0)
    end = torch.cat([nxt[1:], nxt.new_full((1,), n)]) - 1
    # value for each head = scanned value at its run's last position
    head_vals = torch.where(is_head, scanned[end], scanned.new_zeros(()))
    return keys, head_vals, is_head
