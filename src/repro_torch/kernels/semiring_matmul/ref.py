"""Plain torch version of the semiring matmul kernel."""
from __future__ import annotations

import torch

from repro_torch.core.semiring import get_semiring


def semiring_matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
                        semiring="plus_times") -> torch.Tensor:
    """``C[i,j] = ⊕_k a[i,k] ⊗ b[k,j]`` in fp32 (``Semiring.matmul_dense``)."""
    sr = get_semiring(semiring)
    return sr.matmul_dense(a.to(torch.float32), b.to(torch.float32))


# The TF32 route's error bound (csrc/semiring_tf32_sm90.cu): the dropped
# terms of the split (at most 4·2^-22·|a||b| a product), a 32-deep slab's
# 96 products summed on the tensor cores with each addition taken as
# truncating (48.1·2^-22), and the ceil(K/32) slab sums added in fp32
# round-to-nearest (2^-24 each).
TF32X3_C1 = 52
TF32X3_SLAB = 32


def tf32x3_error_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise bound on |C - A·B| for the three-pass TF32 product of
    a [M, K] and b [K, N]: ``(52·2^-22 + ceil(K/32)·2^-24)·(|A|·|B|)``, in
    fp64."""
    slabs = -(-a.shape[1] // TF32X3_SLAB)
    scale = TF32X3_C1 * 2.0 ** -22 + slabs * 2.0 ** -24
    return scale * (a.double().abs() @ b.double().abs())


def nonfinite_operands(m: int, k: int, n: int, gen: torch.Generator,
                       device) -> tuple:
    """(+, ×) operands that take the TF32 route's exact path: positive
    multiples of 1/4 in [1/4, 2], with +inf and -inf in A, +inf in B, and
    one entry of A and one of B near FLT_MAX, whose products (up to
    3·2^127) overflow to ±inf or stay finite.  No output holds two
    near-FLT_MAX terms, and no inf of A meets a product that overflows (a
    fused multiply-add of such a product onto an inf keeps the inf, so the
    result would depend on the order), so every output is ±inf, NaN (an inf
    against an inf of the other sign), or a sum that is the same in any
    order.  m, k and
    n are at least 81."""
    a = torch.randint(1, 9, (m, k), generator=gen).float() / 4
    b = torch.randint(1, 9, (k, n), generator=gen).float() / 4
    inf = float("inf")
    a[3, 7], a[10, 20] = inf, -inf
    a[30, 40], a[30, 70] = 1.5 * 2.0 ** 127, 0.0
    a[3, 70] = a[10, 70] = 0.25   # the inf rows' term of column 80 stays finite
    b[50, 60] = inf
    b[70, 80] = -3 * 2.0 ** 126
    return a.to(device), b.to(device)


def ring_nonfinite_operands(m: int, k: int, n: int, gen: torch.Generator,
                            device) -> tuple:
    """Operands for the five ring semirings (max/min ⊕) with NaN and
    opposite infinities: positive multiples of 1/4 in [1/4, 2], NaN in row
    3 of A and column 5 of B (a NaN row and column of C under every ring
    semiring), +inf·−inf pairs that meet in one term, (10, 30) and (11, 31)
    (NaN under max_plus and min_plus, −inf under max_times, max_min and
    and_or), and an inf against a 0, (12, 32) and (13, 33) (NaN under
    max_times).  Every other output also has a positive finite term, so
    the kernels' start at the semiring zero changes nothing, and each
    output is a max or min of products or sums that are the same in any
    order.  B's non-finite rows all lie below 64 (the first 128-wide k
    tile).  m >= 14, k >= 64, n >= 34."""
    a = torch.randint(1, 9, (m, k), generator=gen).float() / 4
    b = torch.randint(1, 9, (k, n), generator=gen).float() / 4
    inf, nan = float("inf"), float("nan")
    a[3, 7], b[9, 5] = nan, nan
    a[10, 20], b[20, 30] = inf, -inf
    a[11, 40], b[40, 31] = -inf, inf
    a[12, 50], b[50, 32] = inf, 0.0
    a[13, 60], b[60, 33] = 0.0, -inf
    return a.to(device), b.to(device)
