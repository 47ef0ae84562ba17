#!/usr/bin/env python3
"""Time one of the port's kernels against another source of it, on one card.

    # rank_count: another rank_count.cu
    git show <commit>:src/repro_torch/csrc/rank_count.cu > build/rank_count_old.cu
    python3 tools/kernel_ab.py rank_count build/rank_count_old.cu

    # bsr_pairlist and bsr_pairlist_reduce, or bsr_spgemm: another source,
    # with the headers it includes in its directory (here: all of a
    # commit's csrc/)
    mkdir -p build/old && git archive <commit> src/repro_torch/csrc \
        | tar -x -C build/old --strip-components=3
    python3 tools/kernel_ab.py bsr_spgemm build/old/bsr_spgemm.cu
    python3 tools/kernel_ab.py bsr_pairlist build/old/bsr_pairlist.cu

    # range_mask: another range_mask.cu
    git show <commit>:src/repro_torch/csrc/range_mask.cu > build/range_mask_old.cu
    python3 tools/kernel_ab.py range_mask build/range_mask_old.cu

    # segment_scan: another segment_scan.cu, with its headers beside it
    python3 tools/kernel_ab.py segment_scan build/old/segment_scan.cu

    # flash_attention_bwd: another source of the backward with a bf16
    # instance, such as the CUDA-core one before the wgmma route
    git show 03be953:src/repro_torch/csrc/flash_attention_bwd.cu \
        > build/flash_attention_bwd_old.cu
    python3 tools/kernel_ab.py flash_attention_bwd build/flash_attention_bwd_old.cu

The other source is built with ``nvcc`` and the port's flags into
``build/kernel_ab/`` and called through a copy of the port's host work
around its launch.  It must export these C entries:

* ``rank_count_launch(i, j, rank, hit, ni, nj, stream)``, writing every
  entry of ``rank`` and ``hit``;
* the ring entries of the pair kernels, as the port has them since its
  two routes: ``bsr_pairlist_launch(sr, a_tiles, b_tiles, pair_a, pair_b,
  runs, c_tiles, n_c, stream)`` and ``bsr_pairlist_reduce_launch(sr,
  a_tiles, b_tiles, pair_a, pair_b, runs, chunk_off, part, out, n_o,
  items, chunk, axis, stream)`` over runs cut into chunks, for the five
  ring semirings (``cuda_lib.SEMIRING_IDS``; plus_times has its TF32
  entries, which this tool does not time);
* ``bsr_spgemm_launch(sr, a, mask, b, c, m, n, k, stream)``, the ring's,
  for the same five semirings, writing every entry of C;
* ``range_mask_launch(rows, cols, keep, n, rlo, rhi, clo, chi, stream)``;
* ``segment_scan_launch(combine, keys, vals, out, n, scratch, stream)``
  with 4·ceil(n/1024) int32 of scratch: the three-pass source the port had
  before its one-pass kernel;
* ``flash_attention_bwd_launch(dtype, q, k, v, o, dO, lse, delta, dq, dk,
  dv, strides, B, H, KV, Sq, Sk, D, Dv, causal, window, q_off, scale,
  stream)`` with dtype 1 for bf16, fp32 [B, H, Sq] delta scratch and 24
  element strides ((b, h, s) of q, k, v, o, dO, dq, dk, dv): the
  CUDA-core backward the port had before its bf16 wgmma route.

``rank_count`` runs on the ingest path's inputs
(``chip_smoke.rank_count_inputs``: the base's and the delta's keys at
uniform n=15), must equal two ``torch.searchsorted`` on every entry, and is
timed in turns (old, new, library, library, new, old) by chip_smoke's two
clocks: ``cuda_ms`` (device time, L2 evicted before each call) and
``host_ms`` (per call by the host's clock).

``bsr_pairlist`` runs both pair kernels on the main path's inputs at
clustered n=18 (``chip_smoke.pairlist_inputs``: ``A @ B`` and the
``A.sqout(reduce=1)`` pairs, quarter values), under each of the five ring
semirings: both sources must equal the plain version exactly, and are
timed at their launch (no input check with its host read-back inside the
timed call) by ``cuda_ms`` in turns (old, new, new, old).

``bsr_spgemm`` runs on chip_smoke's masked inputs at 4096^3 (the seeded
mask keeping about 1/4 of A's tiles, and the all-present mask of uniform
n=12; quarter values), under each of the five ring semirings: both
sources must equal the plain version exactly and are timed by ``cuda_ms``
in turns (old, new, new, old).

``range_mask`` runs on the main path's selection (clustered n=18, the
row box of ``main_path.row_range``, every column): both sources must
equal the plain version on it, on its entries in a random order and on a
box with no row and one with every row inside.  Each is timed on the
sorted and the unsorted entries, and on the first 4096 (the cost of a
call beyond its bytes), in turns (old, new, new, old) by
``cuda_ms`` (L2 left dirty by the eviction write) and by
``cuda_ms_clean_l2`` (L2 evicted by a read).

``segment_scan`` runs on chip_smoke's four inputs
(``chip_smoke.segment_scan_inputs``: the first 4096 and all 2^21 pair ids
of the clustered n=18 array, 2^21 equal keys, 2^24 keys of the pair ids'
run lengths; quarter values, sum): both sources must equal the plain
version (and the port's its order model) under sum, min and max, and each
is timed in turns (old, new, new, old) by ``cuda_ms`` and by
``cuda_ms_clean_l2``, beside the 12-bytes-an-element bound.

``flash_attention_bwd`` runs at chip_smoke's 11 train shapes
(``chip_smoke.TRAIN_BWD_SHAPES``: bf16, seeded q, k, v and dO, lse and O
from the forward kernel): both sources must be within
``chip_smoke.BWD_REL_TOL`` (relative L2 of dq, dk and dv) of
``flash_attention_bwd_ref``, and are timed in turns (old, new, new, old)
by ``cuda_ms``, beside the bound and SDPA's backward (never called by the
port).

The last lines are the card's name and power limit and one JSON object of
the times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)

# the semirings of the CUDA-core ring, the ones bsr_pairlist and
# bsr_spgemm compare (plus_times goes to the TF32 kernels)
RING = chip_smoke.SEMIRINGS[1:]

_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    "rank_count": {"rank_count_launch": [_P] * 4 + [_I] * 2 + [_P]},
    "bsr_pairlist": {
        "bsr_pairlist_launch": [_I] + [_P] * 6 + [_I, _P],
        "bsr_pairlist_reduce_launch": [_I] + [_P] * 8 + [_I] * 4 + [_P]},
    "bsr_spgemm": {"bsr_spgemm_launch": [_I] + [_P] * 4 + [_I] * 3 + [_P]},
    "range_mask": {"range_mask_launch": [_P] * 3 + [ctypes.c_longlong]
                   + [_I] * 4 + [_P]},
    "segment_scan": {"segment_scan_launch": [_I] + [_P] * 3
                     + [ctypes.c_longlong, _P, _P]},
    "flash_attention_bwd": {"flash_attention_bwd_launch": [_I] + [_P] * 11
                            + [_I] * 10 + [ctypes.c_float, _P]},
}


def build_old(kernel: str, src: str) -> ctypes.CDLL:
    from repro_torch.kernels import cuda_lib
    out = os.path.join(ROOT, "build", "kernel_ab")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"{kernel}_old.so")
    r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        "-o", so, src], capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    for name, argtypes in ENTRIES[kernel].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def turns(calls: dict, order, clock, repeats: int) -> dict:
    """Each call's mean over its turns, and the turns themselves."""
    got = {k: [] for k in calls}
    for name in order:
        got[name].append(clock(calls[name], repeats))
    out = {k: sum(v) / len(v) for k, v in got.items()}
    out["turns"] = got
    return out


def rank_count_ab(old, dev) -> dict:
    import torch

    from repro_torch import main_path
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.sorted_merge import ops as rc_ops
    ing = main_path.build_ingest(chip_smoke.N_INGEST, dev)
    i, j = chip_smoke.rank_count_inputs(ing["raw"], ing["bases"]["sum"])
    del ing

    def old_call(i, j):
        # the port wrapper's host work, then the other source's launch
        cuda_lib.check_cuda(i, j)
        if i.dtype != torch.int32 or j.dtype != torch.int32:
            raise TypeError("rank_count takes int32 i and j")
        i, j = i.contiguous(), j.contiguous()
        rank, hit = torch.empty((2, i.shape[0]), dtype=torch.int32,
                                device=i.device).unbind(0)
        err = old.rank_count_launch(i.data_ptr(), j.data_ptr(),
                                    rank.data_ptr(), hit.data_ptr(),
                                    i.shape[0], j.shape[0],
                                    cuda_lib.stream_ptr(i))
        if err != 0:
            raise RuntimeError(f"the old rank_count failed: CUDA error {err}")
        return rank, hit

    calls = {"old": lambda: old_call(i, j),
             "new": lambda: rc_ops.rank_count_cuda(i, j),
             "library": lambda: (torch.searchsorted(j, i),
                                 torch.searchsorted(j, i, right=True))}
    for name in ("old", "new"):
        for p, q in ((i, j), (j, i)):
            want_lo = torch.searchsorted(q, p).int()
            want_hit = torch.searchsorted(q, p, right=True).int() - want_lo
            rank, hit = (old_call(p, q) if name == "old"
                         else rc_ops.rank_count_cuda(p, q))
            if not (torch.equal(rank, want_lo) and torch.equal(hit, want_hit)):
                raise SystemExit(f"kernel_ab: the {name} rank_count "
                                 "disagrees with torch.searchsorted")
    order = ("old", "new", "library", "library", "new", "old")
    times = {}
    for clock, fn, repeats in (("cuda_ms", chip_smoke.cuda_ms, 50),
                               ("host_ms", chip_smoke.host_ms, 200)):
        t = times[clock] = turns(calls, order, fn, repeats)
        print(f"[time] rank_count {clock}: old {t['old']:.4f}, new "
              f"{t['new']:.4f}, library {t['library']:.4f}; new / old "
              f"{t['new'] / t['old']:.3f}, new / library "
              f"{t['new'] / t['library']:.3f}, old / library "
              f"{t['old'] / t['library']:.3f}", flush=True)
    print(f"[shape] {i.shape[0]} keys in {j.shape[0]} keys, exact both ways")
    return times


def bsr_pairlist_ab(old, dev) -> dict:
    import torch

    from repro_torch import main_path
    from repro_torch.core import REGISTRY
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.bsr_spgemm import ops as bsr_ops
    from repro_torch.kernels.bsr_spgemm import ref as bsr_ref
    clus = main_path.build_clustered(18, dev)
    a, b = clus["A"], clus["B"]
    gen = torch.Generator().manual_seed(0)
    _, mm_tiles, mm_pairs, n_c = chip_smoke.pairlist_inputs(a, b, None, gen)
    _, rd_tiles, rd_pairs, n_o = chip_smoke.pairlist_inputs(
        a, a.transpose(), 1, gen)
    del clus, a, b

    # both sources at their launch, as chip_smoke times them (the inputs
    # are contiguous and valid; no host read-back inside a timed call)
    def old_pairlist(at, bt, pa, pb, pc, sr):
        runs = bsr_ops.run_offsets(pc, n_c)
        c = torch.empty((n_c, 128, 128), dtype=torch.float32, device=dev)
        err = old.bsr_pairlist_launch(
            cuda_lib.SEMIRING_IDS[sr.name], at.data_ptr(), bt.data_ptr(),
            pa.data_ptr(), pb.data_ptr(), runs.data_ptr(), c.data_ptr(), n_c,
            cuda_lib.stream_ptr(at))
        if err != 0:
            raise RuntimeError(f"the old bsr_pairlist failed: CUDA error {err}")
        return c

    def old_reduce(at, bt, pa, pb, po, sr):
        runs = bsr_ops.run_offsets(po, n_o)
        out = torch.empty((n_o, 128), dtype=torch.float32, device=dev)
        chunk_off, items = bsr_ops.reduce_chunks(runs, pa.shape[0])
        part = torch.empty((items, 128), dtype=torch.float32, device=dev)
        err = old.bsr_pairlist_reduce_launch(
            cuda_lib.SEMIRING_IDS[sr.name], at.data_ptr(), bt.data_ptr(),
            pa.data_ptr(), pb.data_ptr(), runs.data_ptr(),
            chunk_off.data_ptr(), part.data_ptr(), out.data_ptr(), n_o,
            items, bsr_ops.REDUCE_CHUNK, 1, cuda_lib.stream_ptr(at))
        if err != 0:
            raise RuntimeError("the old bsr_pairlist_reduce failed: CUDA "
                               f"error {err}")
        return out

    times = {}
    for name in RING:
        sr = REGISTRY[name]
        sid = cuda_lib.kernel_semiring_id(sr)
        at, bt = mm_tiles(sr)
        ar, br = rd_tiles(sr)
        want = bsr_ref.bsr_pairlist_ref(at, bt, *mm_pairs, n_c=n_c,
                                        semiring=sr)
        want_r = bsr_ref.bsr_pairlist_reduce_ref(ar, br, *rd_pairs, n_o=n_o,
                                                 axis=1, semiring=sr)
        calls = {
            "bsr_pairlist": {
                "old": lambda: old_pairlist(at, bt, *mm_pairs, sr),
                "new": lambda: bsr_ops.pairlist_launch(
                    at, bt, *mm_pairs, n_c=n_c, sid=sid)},
            "bsr_pairlist_reduce": {
                "old": lambda: old_reduce(ar, br, *rd_pairs, sr),
                "new": lambda: bsr_ops.pairlist_reduce_launch(
                    ar, br, *rd_pairs, n_o=n_o, axis=1, sid=sid)}}
        for kernel, w in (("bsr_pairlist", want),
                          ("bsr_pairlist_reduce", want_r)):
            for src, fn in calls[kernel].items():
                err = chip_smoke.max_err(fn(), w)
                if err != 0.0:
                    raise SystemExit(f"kernel_ab: the {src} {kernel} under "
                                     f"{name} differs from the plain version "
                                     f"by {err}")
            t = turns(calls[kernel], ("old", "new", "new", "old"),
                      chip_smoke.cuda_ms, 3)
            t["new / old"] = t["new"] / t["old"]
            times.setdefault(name, {})[kernel] = t
            print(f"[time] {kernel} {name}: old {t['old']:.4f} ms, new "
                  f"{t['new']:.4f} ms, new / old {t['new / old']:.3f} "
                  f"(turns {json.dumps(t['turns'])})", flush=True)
        del at, bt, ar, br, want, want_r
    print(f"[shape] bsr_pairlist {int(mm_pairs[0].shape[0])} pairs -> {n_c} "
          f"tiles; bsr_pairlist_reduce {int(rd_pairs[0].shape[0])} pairs -> "
          f"{n_o} blocks; every result exact")
    return times


def bsr_spgemm_ab(old, dev) -> dict:
    import torch

    from repro_torch import main_path
    from repro_torch.core import REGISTRY
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.bsr_spgemm import ops as bsr_ops
    from repro_torch.kernels.bsr_spgemm import ref as bsr_ref
    gen = torch.Generator().manual_seed(0)
    uni = main_path.build_uniform(chip_smoke.N_UNIFORM, dev)
    dn_ops, uni_mask, _ = chip_smoke.dense_inputs(uni["A"], uni["B"], gen)
    mk_ops, mk_mask = chip_smoke.masked_inputs(gen, dev)
    del uni

    def old_call(a, mask, b, sr):
        # the port wrapper's checks and allocation, then the other source
        a, mask, b, m, k, n = bsr_ops._check_masked(a, mask, b)
        c = torch.empty((m, n), dtype=torch.float32, device=a.device)
        err = old.bsr_spgemm_launch(
            cuda_lib.SEMIRING_IDS[sr.name], a.data_ptr(), mask.data_ptr(),
            b.data_ptr(), c.data_ptr(), m, n, k, cuda_lib.stream_ptr(a))
        if err != 0:
            raise RuntimeError(f"the old bsr_spgemm failed: CUDA error {err}")
        return c

    times = {}
    for name in RING:
        sr = REGISTRY[name]
        for label, make, mask in (("1/4 mask", mk_ops, mk_mask),
                                  ("n=12 mask", dn_ops, uni_mask)):
            x, y = make(sr)
            want = bsr_ref.bsr_spgemm_ref(x, mask, y, semiring=sr)
            calls = {"old": lambda: old_call(x, mask, y, sr),
                     "new": lambda: bsr_ops.bsr_spgemm_cuda(x, mask, y, sr=sr)}
            for src, fn in calls.items():
                err = chip_smoke.max_err(fn(), want)
                if err != 0.0:
                    raise SystemExit(f"kernel_ab: the {src} bsr_spgemm under "
                                     f"{name}, {label}, differs from the "
                                     f"plain version by {err}")
            t = turns(calls, ("old", "new", "new", "old"), chip_smoke.cuda_ms,
                      3)
            t["new / old"] = t["new"] / t["old"]
            times.setdefault(name, {})[label] = t
            print(f"[time] bsr_spgemm {name} {label}: old {t['old']:.4f} ms, "
                  f"new {t['new']:.4f} ms, new / old {t['new / old']:.3f} "
                  f"(turns {json.dumps(t['turns'])})", flush=True)
            del x, y, want
    print(f"[shape] bsr_spgemm {128 * mk_mask.shape[0]}^3, "
          f"{int(mk_mask.sum())} and {int(uni_mask.sum())} of "
          f"{mk_mask.numel()} A tiles present; every result exact")
    return times


def range_mask_ab(old, dev) -> dict:
    import torch

    from repro_torch import main_path
    from repro_torch.core.select import compile_selector
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.range_extract import ops as rm_ops
    from repro_torch.kernels.range_extract.ref import range_mask_ref
    a = main_path.build_clustered(18, dev)["A"]
    rc = compile_selector(main_path.row_range(a), a.row_space)
    n_rows, n_cols = len(a.row_space), len(a.col_space)
    bounds = (rc.lo, rc.hi, 0, n_cols)
    perm = torch.randperm(a.capacity,
                          generator=torch.Generator().manual_seed(0)).to(dev)
    # the first 4096 entries: what a call costs beyond its bytes
    inputs = {"sorted": (a.rows, a.cols),
              "unsorted": (a.rows[perm], a.cols[perm]),
              "first 4096": (a.rows[:4096], a.cols[:4096])}
    del perm

    def old_call(rows, cols, b):
        keep = torch.empty_like(rows)
        err = old.range_mask_launch(rows.data_ptr(), cols.data_ptr(),
                                    keep.data_ptr(), rows.shape[0], *b,
                                    cuda_lib.stream_ptr(rows))
        if err != 0:
            raise RuntimeError(f"the old range_mask failed: CUDA error {err}")
        return keep

    boxes = {"main path box": bounds, "no row inside": (n_rows, n_rows + 7, 0,
                                                        n_cols),
             "every row inside": (0, n_rows, 0, n_cols)}
    for label, (rows, cols) in inputs.items():
        for box, b in boxes.items():
            want = range_mask_ref(rows, cols, b)
            for src, got in (("old", old_call(rows, cols, b)),
                             ("new", rm_ops.range_mask_cuda(rows, cols, b))):
                if not torch.equal(got, want):
                    raise SystemExit(f"kernel_ab: the {src} range_mask "
                                     f"differs from the plain version "
                                     f"({label}, {box})")
    times = {}
    for label, (rows, cols) in inputs.items():
        calls = {"old": lambda: old_call(rows, cols, bounds),
                 "new": lambda: rm_ops.range_mask_cuda(rows, cols, bounds)}
        for clock, fn in (("cuda_ms", chip_smoke.cuda_ms),
                          ("cuda_ms_clean_l2", chip_smoke.cuda_ms_clean_l2)):
            t = turns(calls, ("old", "new", "new", "old"), fn, 50)
            t["new / old"] = t["new"] / t["old"]
            times.setdefault(label, {})[clock] = t
            print(f"[time] range_mask {label} {clock}: old {t['old']:.4f} ms, "
                  f"new {t['new']:.4f} ms, new / old {t['new / old']:.3f} "
                  f"(turns {json.dumps(t['turns'])})", flush=True)
    times["bytes"] = {"gated": rm_ops.range_mask_bytes(a.rows, bounds),
                      "all": 12 * a.capacity}
    print(f"[shape] range_mask N={a.capacity}, rows [{rc.lo}, {rc.hi}) of "
          f"{n_rows}, every column; {json.dumps(times['bytes'])} bytes; every "
          "result exact")
    return times


def segment_scan_ab(old, dev) -> dict:
    import torch

    from repro_torch import main_path
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.segment_reduce import ops as ss_ops
    from repro_torch.kernels.segment_reduce.ref import (
        segment_scan_ref, segment_scan_tiled_ref)
    clus = main_path.build_clustered(18, dev)
    gen = torch.Generator().manual_seed(0)
    pair_ids = chip_smoke.segment_inputs(clus["raw"], clus["A"], gen)[0]
    del clus
    inputs = chip_smoke.segment_scan_inputs(pair_ids, gen)

    def old_call(keys, vals, combine=0):
        n = keys.shape[0]
        out = torch.empty_like(vals)
        scratch = torch.empty(4 * -(-n // 1024), dtype=torch.int32,
                              device=keys.device)
        err = old.segment_scan_launch(combine, keys.data_ptr(),
                                      vals.data_ptr(), out.data_ptr(), n,
                                      scratch.data_ptr(),
                                      cuda_lib.stream_ptr(keys))
        if err != 0:
            raise RuntimeError(f"the old segment_scan failed: CUDA error {err}")
        return out

    times = {}
    for label, keys in inputs.items():
        vals = chip_smoke.quarter_values(keys.shape[0], gen, dev)
        for comb, cid in ss_ops.COMBINE_IDS.items():
            want = segment_scan_ref(keys, vals, combine=comb)
            for src, got in (("old", old_call(keys, vals, cid)),
                             ("new", ss_ops.segment_scan_cuda(
                                 keys, vals, combine=comb))):
                if not torch.equal(got, want):
                    raise SystemExit(f"kernel_ab: the {src} segment_scan "
                                     f"differs from the plain version "
                                     f"({label}, {comb})")
            if not torch.equal(ss_ops.segment_scan_cuda(keys, vals,
                                                        combine=comb),
                               segment_scan_tiled_ref(keys, vals,
                                                      combine=comb)):
                raise SystemExit(f"kernel_ab: segment_scan differs from its "
                                 f"order model ({label}, {comb})")
        calls = {"old": lambda k=keys, v=vals: old_call(k, v),
                 "new": lambda k=keys, v=vals: ss_ops.segment_scan_cuda(k, v)}
        bound = 12 * keys.shape[0] / chip_smoke.HBM_BYTES_PER_S * 1e3
        times[label] = {"n": keys.shape[0], "bound_ms": bound}
        for clock, fn in (("cuda_ms", chip_smoke.cuda_ms),
                          ("cuda_ms_clean_l2", chip_smoke.cuda_ms_clean_l2)):
            t = turns(calls, ("old", "new", "new", "old"), fn, 50)
            t["new / old"] = t["new"] / t["old"]
            times[label][clock] = t
            print(f"[time] segment_scan {label} {clock}: old {t['old']:.4f} "
                  f"ms, new {t['new']:.4f} ms, new / old "
                  f"{t['new / old']:.3f}, bound {bound:.4f} ms (turns "
                  f"{json.dumps(t['turns'])})", flush=True)
        del vals
    # the timing's floor: an empty kernel between the same events
    times["empty kernel"] = {
        clock: fn(lambda: torch.cuda._sleep(0), 50)
        for clock, fn in (("cuda_ms", chip_smoke.cuda_ms),
                          ("cuda_ms_clean_l2", chip_smoke.cuda_ms_clean_l2))}
    print(f"[time] an empty kernel: {json.dumps(times['empty kernel'])} ms",
          flush=True)
    print("[shape] segment_scan " + ", ".join(
        f"{k} {v.shape[0]}" for k, v in inputs.items())
        + "; sum of quarter values, every result exact")
    return times


def flash_attention_bwd_ab(old, dev) -> dict:
    import math

    import torch

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import ops as fa_ops

    def old_call(x):
        # the port wrapper's allocation, then the other source (bf16)
        q, k, v, o, do, lse = (x[n] for n in ("q", "k", "v", "o", "do",
                                              "lse"))
        m = x["masks"]
        b, h, sq, d = q.shape
        kv, sk, dvh = k.shape[1], k.shape[2], v.shape[3]
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do,
                                                         *grads)
                                             for s in t.stride()[:3]))
        scale = m["sm_scale"] or 1.0 / math.sqrt(d)
        err = old.flash_attention_bwd_launch(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), strides, b, h, kv, sq, sk, d,
            dvh, int(m["causal"]), m["window"] or -1, 0, scale,
            cuda_lib.stream_ptr(q))
        if err != 0:
            raise RuntimeError(f"the old flash_attention_bwd failed: CUDA "
                               f"error {err}")
        return grads

    def new_call(x):
        return fa_ops.flash_attention_bwd_cuda(
            *(x[n] for n in ("q", "k", "v", "o", "do", "lse")), **x["masks"])

    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(
        chip_smoke.SERVE_SEED)
    times = {}
    for label, b, h, kv, s, d, kw in chip_smoke.TRAIN_BWD_SHAPES:
        x = chip_smoke.bwd_inputs(b, h, kv, s, d, gen, **kw)
        plain, _ = chip_smoke.bwd_plain(x)
        want = plain()
        rels = {}
        for src, fn in (("old", old_call), ("new", new_call)):
            got = fn(x)
            rels[src] = [chip_smoke.rel_err(g, w) for g, w in zip(got, want)]
            if max(rels[src]) > chip_smoke.BWD_REL_TOL:
                raise SystemExit(f"kernel_ab: the {src} flash_attention_bwd "
                                 f"at {label} is {rels[src]} (relative L2 of "
                                 f"dq, dk, dv) from the plain version")
            del got
        del want
        t = turns({"old": lambda: old_call(x), "new": lambda: new_call(x)},
                  ("old", "new", "new", "old"), chip_smoke.cuda_ms, 3)
        bound, by, _, n_ops = chip_smoke.bwd_bound(x)
        lib_ms, backend = chip_smoke.sdpa_bwd_ms(x)
        t.update({"old / new": t["old"] / t["new"], "bound_ms": bound,
                  "bound_by": by, "gflop": n_ops / 1e9,
                  "pct_of_bound": 100 * bound / t["new"],
                  "sdpa_bwd_ms": lib_ms, "sdpa_mask": backend,
                  "rel_l2": rels})
        times[label] = t
        lib = "n/a" if lib_ms is None else \
            f"{lib_ms:.4f} ms ({backend}), new / SDPA {t['new'] / lib_ms:.3f}"
        print(f"[time] flash_attention_bwd at {label}: old {t['old']:.4f} ms, "
              f"new {t['new']:.4f} ms, old / new {t['old / new']:.2f}, bound "
              f"{bound:.4f} ms ({by}), new at {t['pct_of_bound']:.2f}% of "
              f"bound, SDPA backward {lib} (turns {json.dumps(t['turns'])}; "
              f"relative L2 old {rels['old']}, new {rels['new']})",
              flush=True)
        del x
        torch.cuda.empty_cache()
    return times


AB = {"rank_count": rank_count_ab, "bsr_pairlist": bsr_pairlist_ab,
      "bsr_spgemm": bsr_spgemm_ab, "range_mask": range_mask_ab,
      "segment_scan": segment_scan_ab,
      "flash_attention_bwd": flash_attention_bwd_ab}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=sorted(ENTRIES))
    ap.add_argument("source", help="the other source (.cu)")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import cuda_lib
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions
    old = build_old(args.kernel, args.source)
    cuda_lib.load()
    dev = torch.device(chip_smoke.DEVICE)
    times = AB[args.kernel](old, dev)
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
