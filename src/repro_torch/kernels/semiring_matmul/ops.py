"""Dense semiring matmul: pads to the kernel's tiles, dispatches kernel/ref.

``impl="auto"`` launches the CUDA kernel on CUDA tensors and the plain
version on CPU tensors.  On the card the route follows the semiring
(:func:`route`): (+, ×) runs as three TF32 tensor-core passes
(``csrc/semiring_tf32_sm90.cu``), the other five on the CUDA cores
(``csrc/semiring_matmul.cu``).  Both kernels' block tile is 128×128 with
32-deep k-slabs; operands are padded with the semiring zero to those
multiples, which leaves every ⊕ unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.semiring import Semiring, get_semiring
from repro_torch.kernels import cuda_lib
from .ref import semiring_matmul_ref

BM, BN, BK = 128, 128, 32


def route(sr: Semiring) -> str:
    """The card's route for a semiring: ``"tf32x3"`` (three TF32 wgmma
    passes) for a multiply-accumulate (``mxu=True``: (+, ×)), which the
    TPU kernel sends to its matrix unit, and ``"ring"`` (the CUDA-core
    cp.async ring) for the registry's other five.  There is no switch: the
    semiring decides, and one with no kernel raises ``ValueError``
    (:func:`cuda_lib.kernel_semiring_id`)."""
    return "tf32x3" if cuda_lib.kernel_semiring_id(sr) == 0 else "ring"


def tf32_scratch(m: int, n: int, k: int, device):
    """The TF32 route's scratch: the split operands (A_hi, A_lo [M, K] and
    B_hi^T, B_lo^T [N, K], fp32) and the exact-path flags (int32 [M + N],
    zeroed)."""
    return (torch.empty(2 * (m + n) * k, dtype=torch.float32, device=device),
            torch.zeros(m + n, dtype=torch.int32, device=device))


def _pad_to(x: torch.Tensor, mult_r: int, mult_c: int, fill: float):
    r = (-x.shape[0]) % mult_r
    c = (-x.shape[1]) % mult_c
    if r or c:
        x = F.pad(x, (0, c, 0, r), value=fill)
    return x


def semiring_matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                         sr: Semiring) -> torch.Tensor:
    """The kernel on padded operands: a [M,K], b [K,N] fp32, M and N
    multiples of 128, K a multiple of 32 → [M,N] fp32."""
    cuda_lib.check_cuda(a, b)
    sid = cuda_lib.kernel_semiring_id(sr)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or m % BM or n % BN or k % BK:
        raise ValueError(f"semiring_matmul_cuda: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} are not padded to ({BM}, {BK}) x "
                         f"({BK}, {BN}) multiples")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("semiring_matmul_cuda takes float32 operands")
    a, b = a.contiguous(), b.contiguous()
    if m == 0 or n == 0:          # no grid to launch: nothing to count
        return torch.empty((m, n), dtype=torch.float32, device=a.device)
    if sid == 0:                  # (+, ×): the TF32 route
        if k == 0:                # the empty sum, with no product to run
            return torch.zeros((m, n), dtype=torch.float32, device=a.device)
        c = torch.empty((m, n), dtype=torch.float32, device=a.device)
        scratch, flags = tf32_scratch(m, n, k, a.device)
        cuda_lib.launch("semiring_matmul_tf32", a.data_ptr(), b.data_ptr(),
                        scratch.data_ptr(), flags.data_ptr(), c.data_ptr(),
                        m, n, k, cuda_lib.stream_ptr(a),
                        counts=("semiring_matmul", "semiring_matmul_tf32"))
        return c
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    cuda_lib.launch("semiring_matmul", sid, a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), m, n, k, cuda_lib.stream_ptr(a))
    return c


def semiring_matmul(a: torch.Tensor, b: torch.Tensor, *,
                    semiring="plus_times", impl: str = "auto") -> torch.Tensor:
    """Semiring contraction with shape padding; returns [M, N] fp32.

    impl: ``"cuda"`` (the kernel), ``"ref"`` (plain torch), ``"auto"``
    (the kernel for CUDA tensors, the plain version for CPU tensors).
    """
    sr = get_semiring(semiring)
    m, n = a.shape[0], b.shape[1]
    if cuda_lib.resolve_impl(impl, a) == "ref":
        return semiring_matmul_ref(a, b, semiring=sr)
    ap = _pad_to(a.to(torch.float32), BM, BK, sr.zero)
    bp = _pad_to(b.to(torch.float32), BK, BN, sr.zero)
    return semiring_matmul_cuda(ap, bp, sr)[:m, :n]
