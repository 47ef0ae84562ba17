"""Flash attention: the CUDA kernels or their plain version, and the
model-layout wrapper.

The kernel route follows the dtype alone: bf16 goes to the Hopper kernel
(``csrc/flash_attention_sm90.cu``: TMA, wgmma, softmax in registers;
counted as ``flash_attention_wgmma``), fp32 to the CUDA-core kernel
(``csrc/flash_attention.cu``; counted as ``flash_attention``).  A launch
that fails raises: neither route gives way to the other or to the plain
version.  The q/k head dim D and the v head dim Dv may differ: both
routes take D = Dv and MLA's (192, 128) (:func:`head_dims`).

Training goes through :class:`FlashAttentionFn`, an autograd Function
whose forward launches the same kernel with its ``lse`` output on (each
row's fp32 log-sum-exp; null, and so unchanged, when serving) and whose
backward launches a backward kernel chosen by dtype as the forward's
(:func:`bwd_kernel_route`): bf16 ``csrc/flash_attention_bwd_sm90.cu``
(TMA, wgmma for all five products, dq summed by fp32 atomics; counted as
``flash_attention_bwd_wgmma``), fp32 ``csrc/flash_attention_bwd.cu`` (the
CUDA cores; counted as ``flash_attention_bwd``): dq, dk and dv, the GQA
group's gradients summed into its kv-head.  :func:`flash_attention` takes that route on the kernel
route whenever autograd records (grad enabled and q, k or v requiring a
gradient); a gradient the kernel cannot take raises, it never gives way
to the plain version.  The plain version (``"ref"``, CPU tensors) is plain
torch, which autograd differentiates.

``repro_torch.models.attention.chunked_attention`` calls
:func:`flash_attention` when ``cfg.attn_impl`` is ``"auto"`` or ``"cuda"``
with [B, S, H, D] tensors.  ``impl="auto"`` launches the kernel on CUDA
tensors and runs the plain version on CPU tensors.  Decode (a query over a
cache, ``k_valid_len`` given) never comes here: ``chunked_attention`` keeps
it on its own plain path, as the JAX package keeps it off the kernel, which
targets the S² train/prefill work.  A chunked prefill comes here with
``q_off`` set to its cache cursor (``models/attention.py``).
"""
from __future__ import annotations

import ctypes
import math
import sys
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_lib
from .ref import flash_attention_ref

# the kernel (and its LAUNCHES key) for each dtype: forward and backward
ROUTES = {torch.bfloat16: "flash_attention_wgmma",
          torch.float32: "flash_attention"}
BWD_ROUTES = {torch.bfloat16: "flash_attention_bwd_wgmma",
              torch.float32: "flash_attention_bwd"}


def kernel_route(dtype: torch.dtype) -> str:
    """The kernel that ``flash_attention_cuda`` launches for ``dtype``."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention_cuda takes bf16 or fp32; got {dtype}")
    return ROUTES[dtype]


def bwd_kernel_route(dtype: torch.dtype) -> str:
    """The kernel that ``flash_attention_bwd_cuda`` launches for ``dtype``."""
    if dtype not in BWD_ROUTES:
        raise TypeError(f"flash_attention_bwd_cuda takes bf16 or fp32; got "
                        f"{dtype}")
    return BWD_ROUTES[dtype]


def _tma_rows_ok(t: torch.Tensor) -> bool:
    """The last axis contiguous, the base and the strides over the first
    three axes in 16-byte units: what a TMA tensor map takes."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s * size % 16 == 0 for s in t.stride()[:3]))


def bwd_group_split(b: int, kv: int, group: int, sk: int, sms: int) -> int:
    """Blocks over which the bf16 backward splits each GQA group's heads.
    It runs one block per (batch row, kv head, 128-key tile), each over its
    group's heads; where that is under two waves of ``sms`` blocks (a
    large group over few kv heads: chatglm3-6b's 16 heads a kv head leave
    128 blocks), the group is split so that the blocks fill about two
    waves, each split's dK/dV summed after in a fixed order.  Every split
    holds at least one head."""
    blocks = -(-sk // 128) * kv * b
    if group <= 1 or blocks >= 2 * sms:
        return 1
    per = -(-group // min(group, -(-2 * sms // blocks)))   # heads a split
    return -(-group // per)


def head_dims(d: int, dv: int) -> Tuple[int, int]:
    """The kernel instance (DQ, DV) that takes q/k head dim ``d`` and v
    head dim ``dv``: each a multiple of 16; D = Dv up to 128 (the bf16
    route pads it to 64 or 128), or MLA's (192, 128).  Any other pair
    raises ``ValueError`` naming it: no instance computes it."""
    if d % 16 == 0 and 16 <= d <= 128 and dv == d:
        return (64, 64) if d <= 64 else (128, 128)
    if (d, dv) == (192, 128):
        return 192, 128
    raise ValueError(f"no flash_attention instance takes head dims (q/k "
                     f"{d}, v {dv}): the instances are D = Dv, a multiple "
                     f"of 16 up to 128, and (192, 128)")


def _check_lse(lse: torch.Tensor, b: int, h: int, sq: int) -> None:
    cuda_lib.check_cuda(lse)
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} is not a "
                         f"contiguous fp32 [B,H,Sq] {(b, h, sq)}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         sm_scale: Optional[float] = None, q_off: int = 0,
                         out: Optional[torch.Tensor] = None,
                         lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel: q [B,H,Sq,D], k [B,KV,Sk,D], v [B,KV,Sk,Dv] (any strides
    over the first three axes, the last contiguous; bf16 or fp32, all one
    dtype; (D, Dv) as :func:`head_dims` takes them) → o [B,H,Sq,Dv],
    written into ``out`` if given (a view of that shape, for example a
    transposed [B,Sq,H,Dv] tensor, with 16-byte aligned rows).  bf16
    launches the wgmma kernel, fp32 the CUDA-core kernel
    (:func:`kernel_route`).  ``lse``, if given (fp32 [B,H,Sq],
    contiguous), gets each row's log-sum-exp of its scaled visible scores,
    +inf for a row that sees no key: the backward's input."""
    cuda_lib.check_cuda(q, k, v)
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes bf16 or fp32 q, k, v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, kv, sk, _ = k.shape
    dv = v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (H a multiple of KV)")
    head_dims(d, dv)
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    if out is None:
        out = q.new_empty((b, h, sq, dv))
    elif out.shape != (b, h, sq, dv) or out.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not match "
                         f"[B,H,Sq,Dv] {(b, h, sq, dv)} {q.dtype}")
    cuda_lib.check_cuda(out)
    if lse is not None:
        _check_lse(lse, b, h, sq)
    # 16-byte chunks (TMA boxes on the bf16 route)
    q, k, v = (t if _tma_rows_ok(t) else t.contiguous() for t in (q, k, v))
    if b == 0 or h == 0 or sq == 0:       # no grid to launch
        return out
    if not _tma_rows_ok(out):
        raise ValueError("out must have a contiguous last axis and 16-byte "
                         "aligned rows")
    if sk == 0:                           # no key: every row is 0
        if lse is not None:
            lse.fill_(math.inf)
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    cuda_lib.launch(kernel_route(q.dtype), q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), strides,
                    b, h, kv, sq, sk, d, dv, int(causal),
                    -1 if window is None else int(window), int(q_off),
                    float(scale), cuda_lib.stream_ptr(q))
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: Optional[int] = None,
                             sm_scale: Optional[float] = None, q_off: int = 0,
                             dq: Optional[torch.Tensor] = None,
                             dk: Optional[torch.Tensor] = None,
                             dv: Optional[torch.Tensor] = None):
    """The backward kernel: q [B,H,Sq,D], k [B,KV,Sk,D], v [B,KV,Sk,Dv], the
    forward's o and its gradient do [B,H,Sq,Dv] (any strides over the first
    three axes, the last contiguous; bf16 or fp32, all one dtype) and the
    forward's ``lse`` (fp32 [B,H,Sq], contiguous) → (dq, dk, dv) in the
    inputs' dtype, written into ``dq``/``dk``/``dv`` if given (views of
    those shapes, the last axis contiguous; on the bf16 route also 4-byte
    aligned rows).  dk and dv are summed over each GQA group.  The masks
    and scale must be the forward's.  bf16 launches
    ``csrc/flash_attention_bwd_sm90.cu`` (counted as
    ``flash_attention_bwd_wgmma``: one call, its launches; its fp32
    scratch, the dQ accumulator and the rows' lse·log2(e) and delta, is
    4·B·H·Sq_pad·(DQ + 2) bytes, Sq_pad = Sq rounded up to 64 and DQ the
    instance's q/k head dim, and with a GQA group split over blocks
    (:func:`bwd_group_split`) 4·nsplit·B·KV·Sk·(DQ + DV) more); fp32
    ``csrc/flash_attention_bwd.cu``
    (counted as ``flash_attention_bwd``: one call, its two passes).  A
    launch that fails raises; neither route gives way to the other."""
    cuda_lib.check_cuda(q, k, v, o, do, lse)
    if q.dtype not in ROUTES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError(f"flash_attention_bwd_cuda takes bf16 or fp32 q, k, "
                        f"v, o, do of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {o.dtype}, {do.dtype}")
    if any(t.dim() != 4 for t in (q, k, v, o, do)) \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, kv, sk, _ = k.shape
    dvh = v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (H a multiple of KV)")
    if o.shape != (b, h, sq, dvh) or do.shape != o.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be [B,H,Sq,Dv] {(b, h, sq, dvh)}")
    _check_lse(lse, b, h, sq)
    head_dims(d, dvh)
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    grads = []
    for name, g, like in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        if g is None:
            g = torch.empty_like(like, memory_format=torch.contiguous_format)
        elif g.shape != like.shape or g.dtype != like.dtype \
                or g.stride(3) != 1:
            raise ValueError(f"{name} {tuple(g.shape)} {g.dtype} does not "
                             f"match {tuple(like.shape)} {like.dtype} with a "
                             f"contiguous last axis")
        cuda_lib.check_cuda(g)
        grads.append(g)
    dq, dk, dv = grads
    if b == 0 or h == 0:
        return dq, dk, dv
    if sq == 0 or sk == 0:                # no visible pair: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    route = bwd_kernel_route(q.dtype)
    if route == "flash_attention_bwd_wgmma":
        # TMA reads q, k, v and dO; the other kernels read and write rows
        # as bf16 pairs
        q, k, v, o, do = (t if _tma_rows_ok(t) else t.contiguous()
                          for t in (q, k, v, o, do))
        for name, g in (("dq", dq), ("dk", dk), ("dv", dv)):
            if g.data_ptr() % 4 or any(s % 2 for s in g.stride()[:3]):
                raise ValueError(f"{name} needs even strides and a 4-byte "
                                 f"aligned base on the bf16 route")
        sq_pad = -(-sq // 64) * 64
        dqi, dvi = head_dims(d, dvh)
        nsplit = bwd_group_split(b, kv, h // kv, sk,
                                 cuda_lib.sm_count(q.device))
        # the dQ accumulator [B·H, Sq_pad, DQ], lse·log2(e) and delta, then
        # with a split group each split's dK·scale | dV [B, KV, Sk, DQ + DV]
        scratch = torch.empty(b * h * sq_pad * (dqi + 2) + (
            nsplit * b * kv * sk * (dqi + dvi) if nsplit > 1 else 0),
            dtype=torch.float32, device=q.device)
        extra = (nsplit,)
    else:
        q, k, v, o, do = (t if t.stride(3) == 1 else t.contiguous()
                          for t in (q, k, v, o, do))
        scratch = torch.empty((b, h, sq), dtype=torch.float32,
                              device=q.device)   # delta
        extra = ()
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, dq, dk,
                                                     dv)
                                         for s in t.stride()[:3]))
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    cuda_lib.launch(route, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), strides, b, h, kv, sq, sk, d, dvh,
                    int(causal), -1 if window is None else int(window),
                    int(q_off), *extra, float(scale), cuda_lib.stream_ptr(q))
    return dq, dk, dv


# ---------------------------------------------------------------------------
# costs the step counters cannot see, and per-rank launches
# ---------------------------------------------------------------------------

_COST = None   # {"flops": .., "bytes": ..} while a count_cost() block runs


class count_cost:
    """Inside the block every kernel launch of this module adds its FLOPs
    and HBM bytes to ``self.cost``, by the formulas of the kernels' bounds:
    forward 2·(D + Dv) FLOPs a visible (query, key) pair, q, k, v and the
    output (and ``lse``) moved once; backward 2·(3·D + 2·Dv) a pair, q, k,
    v and dO read, dq, dk, dv written, o and ``lse`` read.  FLOP counters
    over aten ops (``torch.utils.flop_counter``) do not see an extension's
    launch; the plain route's ops they do see, so it adds nothing here."""

    def __enter__(self):
        global _COST
        self._before = _COST
        self.cost = _COST = {"flops": 0, "bytes": 0, "launches": 0}
        return self

    def __exit__(self, *exc):
        global _COST
        _COST = self._before


def visible_pairs(sq: int, sk: int, causal: bool, window=None,
                  q_off: int = 0) -> int:
    """(query, key) pairs the masks leave visible, per (batch, head)."""
    if not causal and window is None:
        return sq * sk
    total = 0
    for i in range(sq):
        pos = q_off + i
        hi = min(sk, pos + 1) if causal else sk
        lo = max(0, pos - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def _add_cost(q, k, v, *, bwd: bool, causal, window, q_off, lse) -> None:
    if _COST is None:
        return
    b, h, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[3]
    pairs = visible_pairs(sq, sk, causal, window, q_off) * b * h
    el = q.element_size()
    io = q.numel() + k.numel() + v.numel() + b * h * sq * dv
    if bwd:
        _COST["flops"] += 2 * (3 * d + 2 * dv) * pairs
        _COST["bytes"] += 2 * el * (q.numel() + k.numel() + v.numel()
                                    + b * h * sq * dv) \
            + el * b * h * sq * dv + 4 * b * h * sq
    else:
        _COST["flops"] += 2 * (d + dv) * pairs
        _COST["bytes"] += el * io + (4 * b * h * sq if lse else 0)
    _COST["launches"] += 1


def _per_rank(fn):
    """``fn`` run once per simulated rank on that rank's plain tensors
    under ``LocalTensorMode`` (its tensor results joined into
    LocalTensors), as is elsewhere: the extension never sees a tensor
    subclass.  Until ``torch.distributed._local_tensor`` is imported no
    such mode can be active, so one-card code neither imports it nor
    wraps ``fn``."""
    mod = sys.modules.get("torch.distributed._local_tensor")
    return fn if mod is None else mod.maybe_run_for_local_tensor(fn)


def _fwd_launch(q, k, v, causal, window, sm_scale, q_off, with_lse):
    """One forward launch in the model layout → (out, lse or None)."""
    shape = q.shape
    out = q.new_empty(shape[:3] + v.shape[3:])
    lse = (torch.empty((shape[0], shape[2], shape[1]), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash_attention_cuda(qt, kt, vt, causal=causal, window=window,
                         sm_scale=sm_scale, q_off=q_off,
                         out=out.transpose(1, 2), lse=lse)
    _add_cost(qt, kt, vt, bwd=False, causal=causal, window=window,
              q_off=q_off, lse=with_lse)
    return out, lse


def _bwd_launch(q, k, v, out, dout, lse, causal, window, sm_scale, q_off):
    """One backward launch in the model layout → (dq, dk, dv)."""
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    ts = [t.transpose(1, 2) for t in (q, k, v, out, dout)]
    flash_attention_bwd_cuda(*ts, lse, dq=dq.transpose(1, 2),
                             dk=dk.transpose(1, 2), dv=dv.transpose(1, 2),
                             causal=causal, window=window, sm_scale=sm_scale,
                             q_off=q_off)
    _add_cost(*ts[:3], bwd=True, causal=causal, window=window, q_off=q_off,
              lse=True)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The kernel route under autograd, in the model's layout: q [B,Sq,H,D],
    k [B,Sk,KV,D], v [B,Sk,KV,Dv] → [B,Sq,H,Dv].  The forward launches the
    forward kernel with its ``lse`` output and keeps q, k, v, the output
    and ``lse``; the backward launches :func:`flash_attention_bwd_cuda`
    into gradients in the inputs' layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, q_off):
        out, lse = _per_rank(_fwd_launch)(q, k, v, causal, window, sm_scale,
                                          q_off, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, sm_scale, q_off)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _per_rank(_bwd_launch)(q, k, v, out, dout, lse,
                                            *ctx.masks)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, q_positions=None, k_positions=None,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None, impl: str = "auto",
                    q_off: int = 0) -> torch.Tensor:
    """Model-layout entry: q [B,Sq,H,D], k [B,Sk,KV,D], v [B,Sk,KV,Dv] →
    [B,Sq,H,Dv].

    Assumes contiguous positions: queries from ``q_off``, keys from 0 (the
    position arrays are accepted for signature parity with the plain path).
    On the kernel route with autograd recording, :class:`FlashAttentionFn`
    (the backward kernel computes the gradients).
    """
    if cuda_lib.resolve_impl(impl, q) == "ref":
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                   sm_scale=sm_scale,
                                   q_off=q_off).transpose(1, 2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, sm_scale,
                                      q_off)
    return _per_rank(_fwd_launch)(q, k, v, causal, window, sm_scale, q_off,
                                  False)[0]
