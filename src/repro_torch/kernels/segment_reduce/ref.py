"""Plain torch versions of the segmented scan.

``segment_scan_ref`` is the plain version: Hillis-Steele doubling over
sorted key runs (the JAX oracle's ``associative_scan`` does the same
log-depth combine).

``segment_scan_tiled_ref`` repeats the CUDA kernel's order of combination
(``csrc/segment_scan.cu``) step by step: within a thread, across the warp,
across the block, then the look-back over the tiles before.  Tests and
``chip_smoke.py`` hold the kernel to it bit for bit; nothing on a path
calls it.  ``segment_scan_depth`` runs the same order with ⊕ replaced by
max(a, b) + 1, which gives each sum's depth d(i), and
``segment_scan_sum_bound`` turns it into the kernel's error bound."""
from __future__ import annotations

import torch

COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}

# the kernel's block: 256 threads of 16 elements, in warps of 32
KERNEL_THREADS = 256
KERNEL_TILE = 4096
_WARP = 32


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


def _lane_scan(f, v, comb, width: int):
    """Inclusive segmented Hillis-Steele scan along the last axis, as the
    kernel's shuffles run it: lane l takes lane l - off's values for off =
    1, 2, ... < width."""
    off = 1
    while off < width:
        nf, nv = f.clone(), v.clone()
        nv[..., off:] = torch.where(f[..., off:], v[..., off:],
                                    comb(v[..., :-off], v[..., off:]))
        nf[..., off:] = f[..., off:] | f[..., :-off]
        f, v = nf, nv
        off *= 2
    return f, v


def _shift(x, fill):
    """x moved one place along the last axis; ``fill`` at place 0."""
    out = torch.full_like(x, fill)
    out[..., 1:] = x[..., :-1]
    return out


def _tiled(keys, vals, comb, ident, tile: int):
    n = keys.shape[0]
    if n == 0:
        return vals.clone()
    if tile % KERNEL_THREADS or tile < KERNEL_THREADS:
        raise ValueError(f"tile {tile} is not a multiple of "
                         f"{KERNEL_THREADS} threads")
    per = tile // KERNEL_THREADS
    warps = KERNEL_THREADS // _WARP
    nt = -(-n // tile)
    pad = nt * tile - n
    dev = vals.device
    # past n: the last key and the identity, as in the kernel
    k = torch.cat([keys, keys[-1:].expand(pad)])
    v = torch.cat([vals, vals.new_full((pad,), ident)])
    head = torch.ones(nt * tile, dtype=torch.bool, device=dev)
    head[1:] = k[1:] != k[:-1]
    head = head.view(nt, warps, _WARP, per)
    v = v.view(nt, warps, _WARP, per)

    # within a thread: x[e] = head ? v[e] : x[e-1] ⊕ v[e]
    x = v.clone()
    for e in range(1, per):
        x[..., e] = torch.where(head[..., e], v[..., e],
                                comb(x[..., e - 1], v[..., e]))
    # across the warp (thread totals), then the block (warp totals)
    wf, wv = _lane_scan(head.any(-1), x[..., -1], comb, _WARP)
    bf, bv = _lane_scan(wf[..., -1], wv[..., -1], comb, warps)
    # each thread's exclusive prefix within the tile
    ef, ev = _shift(wf, False), _shift(wv, ident)
    pbv = _shift(bv, ident)[..., None].expand_as(ev)
    lane0 = torch.zeros(_WARP, dtype=torch.bool, device=dev)
    lane0[0] = True
    warp0 = torch.zeros((warps, 1), dtype=torch.bool, device=dev)
    warp0[0] = True
    pv = torch.where(lane0, pbv,
                     torch.where(~warp0 & ~ef, comb(pbv, ev), ev))
    pre = ~(lane0 & warp0)
    before_head = head.long().cumsum(-1) == 0     # no head in the thread yet
    y = torch.where(pre[..., None] & before_head,
                    comb(pv[..., None], x), x)

    # look-back: level L holds the summaries of full groups of 32^L tiles;
    # a group's summary is lane 31 of the scan of its 32 entries below
    nl = 1
    while _WARP ** nl < nt:
        nl += 1
    sf, sv = bf[:, -1], bv[:, -1]                 # each tile's summary
    scans = []
    for _ in range(nl):
        m = sf.shape[0]
        g = -(-m // _WARP) * _WARP
        pf = torch.cat([sf, sf.new_zeros(g - m)]).view(-1, _WARP)
        pvv = torch.cat([sv, sv.new_full((g - m,), ident)]).view(-1, _WARP)
        hf, hv = _lane_scan(pf, pvv, comb, _WARP)
        hf, hv = hf.reshape(-1), hv.reshape(-1)
        scans.append((hf, hv))
        full = m // _WARP
        sf, sv = hf[_WARP - 1::_WARP][:full], hv[_WARP - 1::_WARP][:full]
    # the carry of each tile: W_0, then W_L ⊕ carry while no head is found
    idx = torch.arange(nt, device=dev)
    need = (idx > 0) & ~head[:, 0, 0, 0]
    acc_set = torch.zeros(nt, dtype=torch.bool, device=dev)
    acc_f = torch.zeros(nt, dtype=torch.bool, device=dev)
    acc_v = torch.full((nt,), ident, dtype=vals.dtype, device=dev)
    for hf, hv in scans:
        c = idx % _WARP
        take = need & ~acc_f & (c > 0)
        w = (idx - 1).clamp(0, hf.shape[0] - 1)
        wf, wv = hf[w], hv[w]
        acc_v = torch.where(take, torch.where(acc_set, comb(wv, acc_v), wv),
                            acc_v)
        acc_f = torch.where(take, wf, acc_f)
        acc_set = acc_set | take
        idx = idx // _WARP
    # the leading run of each tile takes carry ⊕ its local value
    lead = head.view(nt, -1).long().cumsum(-1) == 0
    y = y.reshape(nt, -1)
    out = torch.where(lead, comb(acc_v[:, None], y), y)
    return out.reshape(-1)[:n]


def segment_scan_tiled_ref(keys: torch.Tensor, vals: torch.Tensor, *,
                           combine: str = "sum",
                           tile: int = KERNEL_TILE) -> torch.Tensor:
    """The inclusive segmented ⊕-scan in the CUDA kernel's exact order of
    combination, for tiles of ``tile`` elements (256 threads of tile / 256
    each; the kernel's is 4096).  Runs are stretches of adjacent equal keys
    (the keys need not be sorted).  Each ⊕ is one fp32 operation, as on the
    card, so the kernel equals it in every bit (min/max: −0 and +0 compare
    equal, NaN where NaN)."""
    return _tiled(keys, vals.to(torch.float32), COMBINE[combine],
                  IDENTITY[combine], tile)


def segment_scan_depth(keys: torch.Tensor, *,
                       tile: int = KERNEL_TILE) -> torch.Tensor:
    """d(i): the most additions any term of the kernel's sum out[i] passes
    (int64), by the kernel's order with ⊕ = max(a, b) + 1 on depths 0."""
    return _tiled(keys, torch.zeros(keys.shape[0], dtype=torch.int64,
                                    device=keys.device),
                  lambda a, b: torch.maximum(a, b) + 1, 0, tile)


def _runs(keys: torch.Tensor):
    """(run id, place in the run: 0 at a head) of each element, for runs
    of adjacent equal keys; int64."""
    n = keys.shape[0]
    idx = torch.arange(n, device=keys.device)
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = keys[1:] != keys[:-1]
    start = torch.where(head, idx, torch.zeros_like(idx)).cummax(0).values
    return head.long().cumsum(0), idx - start


def _gamma(d: torch.Tensor) -> torch.Tensor:
    u = d.double() * 2.0 ** -24
    return u / (1 - u)


def segment_scan_sum_bound(keys: torch.Tensor, vals: torch.Tensor, *,
                           tile: int = KERNEL_TILE,
                           against: str = "plain") -> torch.Tensor:
    """Element-wise bound (fp64) on |kernel sum − other| for the sum: the
    kernel's γ_d(i)·S(i), S(i) = Σ|v| over i's run up to i (in fp64), plus
    the other side's: ``against="plain"``, ``segment_scan_ref``, whose
    doubling gives out[i] a depth of at most bit_length(i's place in its
    sorted run); ``"exact"``, nothing."""
    if against not in ("plain", "exact"):
        raise ValueError(f"against {against!r}: 'plain' or 'exact'")
    run, pos = _runs(keys)
    # S(i) by doubling in fp64: non-negative terms, relative error ~1e-15
    s = vals.double().abs()
    step = 1
    while step < s.shape[0]:
        same = run[step:] == run[:-step]
        s[step:] = torch.where(same, s[:-step] + s[step:], s[step:])
        step *= 2
    g = _gamma(segment_scan_depth(keys, tile=tile))
    if against == "plain":
        bits = torch.where(pos > 0, torch.floor(torch.log2(
            pos.clamp(min=1).double())) + 1, torch.zeros_like(s))
        g = g + _gamma(bits)
    return g * s
