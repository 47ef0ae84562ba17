#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py                  # the full check, one card
    python3 chip_smoke.py --n-clustered 17 # a smaller clustered size

Phases, each of which fails the run (non-zero exit, no result line):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a);
2. the main path, through the entry points a user calls, with every kernel
   launch counter set to 0 just before and read just after:
   * the clustered workload at n=18 (2^21 triples per array, ~164k x 165k
     keys): ``from_triples``, a row ``Range`` selection, ``A + B``,
     ``A @ B`` (planned ``bsr``), ``A.sqout(reduce=1)`` and
     ``(A.lazy()[sel, :] @ B.lazy()).sum(axis=1).collect()``;
   * the paper's uniform workload at n=12: ``A.matmul(B)`` under
     ``PLUS_TIMES`` and ``MIN_PLUS`` (planned ``dense``);
   every kernel must have launched at least once;
3. the results held against the host ``Assoc`` (numpy/scipy): counts,
   checksums and reduced vectors at n=18, every entry at n=12 and on a
   clustered n=14 run;
4. each kernel against its plain torch version on the card, on inputs of the
   main path's shapes, under all six semirings.  The inputs are multiples
   of 1/4 in [1/4, 2], so every fp32 product and sum is exact in any order:
   the tolerance is 0 for every semiring;
5. CUDA-event times (plus_times) of each kernel, its plain version and one
   PyTorch library yardstick, beside the least time the card could take;
   then ``A @ B``, ``A.sqout(reduce=1)`` and the uniform ``A.matmul(B)``
   once more under ``spgemm.stage_timing()``, for where their time goes.

The last three lines of standard output are the kernels JSON line, the
card's name and power limit as ``nvidia-smi`` gives them, and the result
JSON line.  It exits non-zero, printing no result, when no CUDA device is
available or when the port is not next to it (``src/repro_torch``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

DEVICE = "cuda:0"
N_UNIFORM = 12      # the paper's uniform workload, planned dense
N_FULL = 14         # the clustered size compared entry by entry
SEMIRINGS = ("plus_times", "max_plus", "min_plus", "max_min", "max_times",
             "and_or")


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``repeats`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


# -- kernel inputs at the main path's shapes ------------------------------------

def quarter_values(n: int, gen, device):
    """n values in {1/4, 2/4, ..., 2}: every fp32 sum of their products is
    exact at these sizes, whatever the order."""
    import torch
    return torch.randint(1, 9, (n,), generator=gen).to(device,
                                                         torch.float32) / 4


def pairlist_inputs(a, b, axis, gen):
    """Packed tiles (random quarter values) and pair lists of ``a @ b`` as
    the planner makes them; ``axis`` regroups for the fused reduce."""
    import torch

    from repro_torch.core import spgemm
    from repro_torch.core.semiring import PLUS_TIMES

    a, b, ks = spgemm._contraction_aligned(a, b, PLUS_TIMES)
    ra, ca, _ = spgemm._valid_host(a)
    rb, cb, _ = spgemm._valid_host(b)
    plan = spgemm.plan_matmul(ra, ca, rb, cb, len(a.row_space), len(ks),
                              len(b.col_space))
    dev = a.device
    va = quarter_values(len(ra), gen, dev)
    vb = quarter_values(len(rb), gen, dev)

    def tiles(sr):
        at = spgemm.pack_tiles(va, plan.a_tile_of, plan.a_lr, plan.a_lc,
                               len(plan.a_blocks), 128, 128, sr.zero)
        bt = spgemm.pack_tiles(vb, plan.b_tile_of, plan.b_lr, plan.b_lc,
                               len(plan.b_blocks), 128, 128, sr.zero)
        return at, bt

    def up(x):
        return torch.from_numpy(x.astype("int32")).to(dev)

    if axis is None:
        pairs = (up(plan.pair_a), up(plan.pair_b), up(plan.pair_c))
        n_out = len(plan.c_blocks)
    else:
        pa, pb, po, o_uniq = spgemm.reduce_pairs(plan, axis)
        pairs = (up(pa), up(pb), up(po))
        n_out = len(o_uniq)
    return plan, tiles, pairs, n_out


def dense_inputs(a, b, gen):
    """The dense strategy's operands (densified adjacencies) with random
    quarter values on the stored entries, per semiring zero."""
    import torch

    from repro_torch.core import spgemm
    from repro_torch.core.semiring import PLUS_TIMES

    a, b, _ = spgemm._contraction_aligned(a, b, PLUS_TIMES)
    da, db = spgemm._densify_aligned(a.logical(), b.logical(), PLUS_TIMES)
    qa = quarter_values(da.numel(), gen, da.device).view_as(da)
    qb = quarter_values(db.numel(), gen, db.device).view_as(db)

    def operands(sr):
        z = torch.tensor(sr.zero, device=da.device)
        return torch.where(da != 0, qa, z), torch.where(db != 0, qb, z)
    return operands, (da.shape[0], da.shape[1], db.shape[1])


def max_err(got, want) -> float:
    import torch
    same = (got == want) | (torch.isinf(got) & torch.isinf(want)
                            & (torch.sign(got) == torch.sign(want)))
    if bool(same.all()):
        return 0.0
    d = (got.double() - want.double()).abs()
    return float(torch.where(same, torch.zeros_like(d), d).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-clustered", type=int, default=18,
                    help="clustered size of the main path (17 if 18 does "
                    "not fit the time limit)")
    ap.add_argument("--report", default=None,
                    help="also write every number as JSON to this path")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    try:
        from repro_torch import main_path
        from repro_torch.core import (DISPATCH_STATS, PLAN_STATS, REGISTRY,
                                      reset_all_stats, spgemm)
        from repro_torch.core.select import compile_selector
        from repro_torch.kernels import LAUNCHES, cuda_lib, reset_launch_counts
        from repro_torch.kernels.bsr_spgemm import ops as bsr_ops
        from repro_torch.kernels.bsr_spgemm import ref as bsr_ref
        from repro_torch.kernels.range_extract import ops as rm_ops
        from repro_torch.kernels.range_extract.ref import range_mask_ref
        from repro_torch.kernels.semiring_matmul import ops as sm_ops
        from repro_torch.kernels.semiring_matmul.ref import semiring_matmul_ref
    except ImportError as exc:
        print(f"chip_smoke: the port (src/repro_torch) is not importable "
              f"next to this script: {exc}", file=sys.stderr)
        return 2

    # the plain versions and library yardsticks run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    report = {"device": torch.cuda.get_device_name(0)}
    failures = []
    log(f"device: {report['device']}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")

    # -- phase 1: build --------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)
    cuda_lib.load()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] kernels built and loaded in {report['build_s']:.1f} s")

    # -- phase 2: the main path, counted -----------------------------------
    gen_n, uni_n = args.n_clustered, N_UNIFORM
    reset_all_stats()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    clus = main_path.build_clustered(gen_n, dev)
    res = main_path.drive_clustered(clus["A"], clus["B"])
    uni = main_path.build_uniform(uni_n, dev)
    res_u = main_path.drive_uniform(uni["A"], uni["B"])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    report["main_path_s"] = time.perf_counter() - t0
    report["step_s"] = {**clus["seconds"], **res["seconds"],
                        **{f"uniform_{k}": v
                           for k, v in res_u["seconds"].items()}}
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["launches"] = launches
    report["dispatch_stats"] = dict(DISPATCH_STATS)
    report["plan_stats"] = dict(PLAN_STATS)
    log(f"[main path] clustered n={gen_n}, uniform n={uni_n}: "
        f"{report['main_path_s']:.1f} s, peak {report['peak_mem_gb']:.1f} GB")
    log("[main path] step seconds " + json.dumps(report["step_s"]))
    log(f"[main path] launches {launches}  dispatch {dict(DISPATCH_STATS)}")
    for k, v in launches.items():
        if v < 1:
            failures.append(f"kernel {k} was not launched on the main path")
    if DISPATCH_STATS["range"] < 1:
        failures.append("the row Range selection did not take the range path")
    nnz = {k: int(res[k].nnz) for k in ("select", "add", "matmul")}
    log(f"[main path] nnz {nnz}, sqout vector {tuple(res['sqout_reduce'].shape)}")

    # -- phase 3: host checks --------------------------------------------------
    t0 = time.perf_counter()
    checks = main_path.check_clustered(clus["raw"], res, full=False)
    checks += main_path.check_uniform(uni["raw"], res_u, full=True)
    small = main_path.build_clustered(N_FULL, dev)
    res_s = main_path.drive_clustered(small["A"], small["B"])
    checks += [(f"n={N_FULL} {name}", ok, det) for name, ok, det in
               main_path.check_clustered(small["raw"], res_s, full=True)]
    for name, ok, detail in checks:
        log(f"[host check] {'ok  ' if ok else 'FAIL'} {name}: {detail}")
        if not ok:
            failures.append(f"host check {name}: {detail}")
    report["host_check_s"] = time.perf_counter() - t0
    del small, res_s

    # -- phase 4: each kernel against its plain version ------------------------
    gen = torch.Generator().manual_seed(0)
    a, b = clus["A"], clus["B"]
    rc = compile_selector(res["selector"], a.row_space)
    bounds = (rc.lo, rc.hi, 0, len(a.col_space))
    rm_in = (a.rows, a.cols, bounds)
    mm_plan, mm_tiles, mm_pairs, n_c = pairlist_inputs(a, b, None, gen)
    at_ = a.transpose()
    rd_plan, rd_tiles, rd_pairs, n_o = pairlist_inputs(a, at_, 1, gen)
    dn_ops, (dm, dk, dn) = dense_inputs(uni["A"], uni["B"], gen)
    errs = {}
    got = rm_ops.range_mask_cuda(*rm_in)
    errs["range_mask"] = {"-": max_err(got, range_mask_ref(*rm_in))}
    for name in SEMIRINGS:
        sr = REGISTRY[name]
        x, y = dn_ops(sr)
        e = errs.setdefault("semiring_matmul", {})
        e[name] = max_err(sm_ops.semiring_matmul(x, y, semiring=sr,
                                                 impl="cuda"),
                          semiring_matmul_ref(x, y, semiring=sr))
        at, bt = mm_tiles(sr)
        e = errs.setdefault("bsr_pairlist", {})
        e[name] = max_err(
            bsr_ops.bsr_pairlist_cuda(at, bt, *mm_pairs, n_c=n_c, sr=sr),
            bsr_ref.bsr_pairlist_ref(at, bt, *mm_pairs, n_c=n_c, semiring=sr))
        at, bt = rd_tiles(sr)
        e = errs.setdefault("bsr_pairlist_reduce", {})
        e[name] = max_err(
            bsr_ops.bsr_pairlist_reduce_cuda(at, bt, *rd_pairs, n_o=n_o,
                                             axis=1, sr=sr),
            bsr_ref.bsr_pairlist_reduce_ref(at, bt, *rd_pairs, n_o=n_o,
                                            axis=1, semiring=sr))
        del at, bt
    torch.cuda.synchronize()
    for k, per in errs.items():
        worst = max(per.values())
        log(f"[kernel check] {k}: max |kernel - plain| per semiring "
            f"{json.dumps(per)} (tolerance 0)")
        if worst != 0.0:
            failures.append(f"kernel {k} disagrees with its plain version: "
                            f"{per}")
    report["max_abs_err"] = errs
    log(f"[kernel check] shapes: range_mask N={a.capacity}; semiring_matmul "
        f"{dm}x{dk}x{dn}; bsr_pairlist {len(mm_plan.pair_a)} pairs, "
        f"{len(mm_plan.a_blocks)}+{len(mm_plan.b_blocks)} tiles -> {n_c}; "
        f"bsr_pairlist_reduce {len(rd_plan.pair_a)} pairs, "
        f"{len(rd_plan.a_blocks)}+{len(rd_plan.b_blocks)} tiles -> {n_o}")

    # -- phase 5: times (plus_times) beside the bound --------------------------
    pt = REGISTRY["plus_times"]
    tile_b = 128 * 128 * 4
    x, y = dn_ops(pt)
    mm_at, mm_bt = mm_tiles(pt)
    rd_at, rd_bt = rd_tiles(pt)
    pa, pb, pc = (p.long() for p in mm_pairs)
    qa, qb, qo = (p.long() for p in rd_pairs)

    def bmm_index_add():
        c = torch.zeros((n_c, 128, 128), device=dev)
        return c.index_add_(0, pc, torch.bmm(mm_at[pa], mm_bt[pb]))

    def bmm_sum_index_add():
        o = torch.zeros((n_o, 128), device=dev)
        return o.index_add_(0, qo, torch.bmm(rd_at[qa], rd_bt[qb]).sum(2))

    n_rm = a.capacity
    p_mm, p_rd = len(mm_plan.pair_a), len(rd_plan.pair_a)
    rows = [
        dict(name="range_mask", route="cuda",
             source="src/repro_torch/csrc/range_mask.cu",
             replaces="src/repro/kernels/range_extract/range_extract.py:37",
             kernel=lambda: rm_ops.range_mask_cuda(*rm_in),
             plain=lambda: range_mask_ref(*rm_in), library=None,
             bytes=12 * n_rm, ops=0, repeats=50),
        dict(name="bsr_pairlist", route="cuda",
             source="src/repro_torch/csrc/bsr_pairlist.cu",
             replaces="src/repro/kernels/bsr_spgemm/pairlist.py:69",
             kernel=lambda: bsr_ops.bsr_pairlist_cuda(
                 mm_at, mm_bt, *mm_pairs, n_c=n_c, sr=pt),
             plain=lambda: bsr_ref.bsr_pairlist_ref(
                 mm_at, mm_bt, *mm_pairs, n_c=n_c, semiring=pt),
             library=bmm_index_add,
             bytes=(len(mm_plan.a_blocks) + len(mm_plan.b_blocks) + n_c)
             * tile_b + 12 * p_mm,
             ops=2 * 128 ** 3 * p_mm, repeats=3),
        dict(name="bsr_pairlist_reduce", route="cuda",
             source="src/repro_torch/csrc/bsr_pairlist.cu",
             replaces="src/repro/kernels/bsr_spgemm/pairlist.py:131",
             kernel=lambda: bsr_ops.bsr_pairlist_reduce_cuda(
                 rd_at, rd_bt, *rd_pairs, n_o=n_o, axis=1, sr=pt),
             plain=lambda: bsr_ref.bsr_pairlist_reduce_ref(
                 rd_at, rd_bt, *rd_pairs, n_o=n_o, axis=1, semiring=pt),
             library=bmm_sum_index_add,
             bytes=(len(rd_plan.a_blocks) + len(rd_plan.b_blocks)) * tile_b
             + 12 * p_rd + 512 * n_o,
             ops=2 * 128 ** 3 * p_rd, repeats=3),
        dict(name="semiring_matmul", route="cuda",
             source="src/repro_torch/csrc/semiring_matmul.cu",
             replaces="src/repro/kernels/semiring_matmul/semiring_matmul.py:53",
             kernel=lambda: sm_ops.semiring_matmul(x, y, semiring=pt,
                                                   impl="cuda"),
             plain=lambda: semiring_matmul_ref(x, y, semiring=pt),
             library=lambda: torch.matmul(x, y),
             bytes=4 * (dm * dk + dk * dn + dm * dn),
             ops=2 * dm * dk * dn, repeats=5),
    ]
    kernels = []
    for r in rows:
        ms = cuda_ms(r["kernel"], r["repeats"])
        plain_ms = cuda_ms(r["plain"], max(1, r["repeats"] // 2))
        lib_ms = (cuda_ms(r["library"], max(1, r["repeats"] // 2))
                  if r["library"] else None)
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_FLOP_PER_S * 1e3
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "max_abs_err": max(errs[r["name"]].values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})
        log(f"[time] {r['name']}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
            f" library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms ({kernels[-1]['bound_by']})")
        del r["kernel"], r["plain"], r["library"]
    # per-semiring kernel times (the bound doubles off plus_times: ⊕ and ⊗
    # are two fp32 instructions where (+, ×) is one FMA)
    by_sr = {}
    for name in SEMIRINGS:
        sr = REGISTRY[name]
        xs, ys = dn_ops(sr)
        ats, bts = mm_tiles(sr)
        ars, brs = rd_tiles(sr)
        by_sr[name] = {
            "semiring_matmul": cuda_ms(lambda: sm_ops.semiring_matmul(
                xs, ys, semiring=sr, impl="cuda"), 3),
            "bsr_pairlist": cuda_ms(lambda: bsr_ops.bsr_pairlist_cuda(
                ats, bts, *mm_pairs, n_c=n_c, sr=sr), 2),
            "bsr_pairlist_reduce": cuda_ms(
                lambda: bsr_ops.bsr_pairlist_reduce_cuda(
                    ars, brs, *rd_pairs, n_o=n_o, axis=1, sr=sr), 2)}
        del xs, ys, ats, bts, ars, brs
    log("[time] kernel ms by semiring " + json.dumps(by_sr))
    report["ms_by_semiring"] = by_sr

    # where the time of the products goes: spgemm's own stage spans, each
    # ended by a device sync
    stages = {}
    for name, fn in (("A @ B", lambda: a @ b),
                     ("A.sqout(reduce=1)", lambda: a.sqout(reduce=1)),
                     ("uniform A.matmul(B)", lambda: uni["A"].matmul(uni["B"]))):
        with spgemm.stage_timing() as ms:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        stages[name] = {"total": total, **ms}
        log(f"[stages] {name} ms " + json.dumps(stages[name]))
    report["stages_ms"] = stages

    report["kernels"] = kernels
    smi = nvidia_smi_line()
    report["nvidia_smi"] = smi
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
