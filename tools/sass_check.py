#!/usr/bin/env python3
"""What the compiler made of the semiring kernels, ``range_mask``,
``segment_scan`` and the bf16 flash kernels:
ptxas's register and spill report, and each kernel's instruction mix from
``cuobjdump -sass``.

    python3 tools/sass_check.py [--json chiprun_out/sass.json]

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.  It builds
the port's kernels afresh into a temporary directory with ``-Xptxas -v``
and fails (exit 1) if

* a kernel of ``csrc/semiring_matmul.cu``, ``csrc/bsr_spgemm.cu``,
  ``csrc/semiring_tf32_sm90.cu``, ``csrc/bsr_pairlist.cu``,
  ``csrc/bsr_pairlist_tf32_sm90.cu``, ``csrc/range_mask.cu``,
  ``csrc/segment_scan.cu``, ``csrc/flash_attention_sm90.cu`` or
  ``csrc/flash_attention_bwd_sm90.cu`` spills (spill stores or loads > 0);
* an instance of the flash backward's ``flash_bwd_wgmma`` holds no
  ``HGMMA`` (its five products must run on the tensor cores);
* a ring kernel of a max/min semiring (``semiring_matmul_kernel``,
  ``bsr_spgemm_kernel``, ``bsr_spgemm_reduce_kernel``,
  ``bsr_pairlist_kernel`` and ``bsr_pairlist_reduce_kernel`` under
  MaxPlus, MinPlus, MaxMin, MaxTimes, AndOr) compiles ⊕ to a compare and
  select (``FSETP``/``FSEL``) instead of one ``FMNMX`` a MAC: it must hold
  at least 8·8·4 ``FMNMX`` (one unrolled k4 step's MACs), and ``FSETP`` +
  ``FSEL`` under 1/8 of them;
* the TF32 kernels (``tf32x3_kernel``, ``pair_tf32_kernel``) hold no
  ``HGMMA`` ... ``.TF32`` instruction, or the store instance of
  ``tf32x3_kernel`` (``semiring_matmul`` and, under a block mask,
  ``bsr_spgemm``) holds other than 12 ``HGMMA.64x128x8.F32.TF32`` (one
  32-deep slab: four k8 steps of three passes);
* a max/min ring kernel above, or any instance of
  ``segment_scan_kernel``, holds an ``FMNMX`` without ``.NAN``: ⊕ must
  propagate NaN as ``jnp.maximum`` does (PTX ``max.NaN`` / ``min.NaN``);
* ``range_mask_kernel``, the masked ring store ``bsr_spgemm_kernel`` or
  ``segment_scan_kernel`` uses local memory (a stack frame, ``LDL`` or
  ``STL``);
* ptxas reports that it serialized a kernel's ``wgmma`` instructions.

For each kernel it prints the counts of FMNMX (and of them FMNMX.NAN),
FADD, FMUL, FFMA, FSETP + FSEL, LDS, HGMMA and all instructions, and the
LDS share per ALU instruction of the contraction.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OPS = ("FMNMX", "FADD", "FMUL", "FFMA", "FSETP", "FSEL", "LDS", "HGMMA", "LDL",
       "STL")
# mangled names hold the template arguments' identifiers as substrings
SEMIRING_OF = {"MaxPlus": ("5OpMax", "6OpPlus"), "MinPlus": ("5OpMin", "6OpPlus"),
               "MaxMin": ("5OpMax", "5OpMin"), "MaxTimes": ("5OpMax", "7OpTimes"),
               "AndOr": ("5OpMax", "5OpMin"), "PlusTimes": ("6OpPlus", "7OpTimes")}
RING_KERNELS = ("semiring_matmul_kernel", "bsr_spgemm_kernel",
                "bsr_spgemm_reduce_kernel", "bsr_pairlist_kernel",
                "bsr_pairlist_reduce_kernel")
TF32_KERNELS = ("tf32x3_kernel", "pair_tf32_kernel")
FLASH_KERNELS = ("flash_fwd_wgmma", "flash_bwd_wgmma")
NO_LOCAL_KERNELS = ("range_mask_kernel", "bsr_spgemm_kernel",
                    "segment_scan_kernel")
SCAN_KERNEL = "segment_scan_kernel"
# segment_scan's combine functors (csrc/segment_scan.cu), as mangled
SCAN_OPS = ("3Sum", "3Min", "3Max")
TF32_SLAB_HGMMA = "HGMMA.64x128x8.F32.TF32"
CHECKED_SOURCES = ("semiring_matmul.cu", "bsr_spgemm.cu", "semiring_tf32_sm90.cu",
                   "bsr_pairlist.cu", "bsr_pairlist_tf32_sm90.cu", "range_mask.cu",
                   "segment_scan.cu", "flash_attention_sm90.cu",
                   "flash_attention_bwd_sm90.cu")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "cuobjdump")


def ptxas_report(text: str) -> dict:
    """{source: {mangled function: {"registers", "stack_frame",
    "spill_stores", "spill_loads"}}} from the build's ``-Xptxas -v``
    output."""
    out, src, fn = {}, None, None
    for line in text.splitlines():
        m = re.match(r"\[nvcc (\S+)\]", line)
        if m:
            src = m.group(1)
            out.setdefault(src, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(src, {}).setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[src][fn].update(stack_frame=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out.setdefault(src, {}).setdefault(fn, {})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[src][fn]["registers"] = int(m.group(1))
    return out


def sass_counts(lib: Path) -> dict:
    """{mangled function: {opcode: count, "total": n}}."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {op: 0 for op in OPS} | {"total": 0, "tf32_hgmma": 0,
                                               "slab_hgmma": 0, "fmnmx_nan": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\S*)", line)
        if m and fn:
            op = m.group(1)
            base = op.split(".")[0]
            out[fn]["total"] += 1
            if base in out[fn]:
                out[fn][base] += 1
            if base == "FMNMX" and ".NAN" in op:
                out[fn]["fmnmx_nan"] += 1
            if base == "HGMMA" and "TF32" in op:
                out[fn]["tf32_hgmma"] += 1
            if op.startswith(TF32_SLAB_HGMMA):
                out[fn]["slab_hgmma"] += 1
    return out


def semiring_of(name: str):
    for sr, parts in SEMIRING_OF.items():
        i = name.find("Semiring")
        if i >= 0 and all(p in name[i:] for p in parts):
            # MaxMin and AndOr differ by the zero (Li1E / Li0E)
            if sr in ("MaxMin", "AndOr"):
                return "AndOr" if "Li0E" in name[i:] else "MaxMin"
            return sr
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the report here")
    args = ap.parse_args()

    from repro_torch.kernels import cuda_lib
    failures, report = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        cuda_lib._BUILD = Path(tmp)          # a fresh build, with the report
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            lib = cuda_lib.build(verbose=True)
        ptxas = ptxas_report(buf.getvalue())
        sass = sass_counts(lib)
    serialized = [line for line in buf.getvalue().splitlines()
                  if "wgmma" in line and "serialized" in line]
    failures += [f"ptxas: {line.strip()}" for line in serialized]
    for src in CHECKED_SOURCES:
        for fn, r in ptxas.get(src, {}).items():
            if r.get("spill_stores", 0) or r.get("spill_loads", 0):
                failures.append(f"{src} {fn} spills: {r}")
            if (any(k in fn for k in NO_LOCAL_KERNELS)
                    and r.get("stack_frame", 0)):
                failures.append(f"{src} {fn} has a stack frame: {r}")
    report["ptxas"] = {s: ptxas.get(s, {}) for s in CHECKED_SOURCES}
    rows = {}
    for fn, c in sass.items():
        ring = next((k for k in RING_KERNELS if k in fn), None)
        tf32 = next((k for k in TF32_KERNELS if k in fn), None)
        local = next((k for k in NO_LOCAL_KERNELS if k in fn), None)
        flash = next((k for k in FLASH_KERNELS if k in fn), None)
        if flash:
            inst = re.search(r"ILi(\d+)ELi(\d+)E", fn)
            key = f"{flash}<{inst.group(1)}, {inst.group(2)}>" if inst else flash
            rows[key] = c
            print(f"[sass] {key}: " + ", ".join(f"{k} {v}" for k, v in c.items()
                                               if v), flush=True)
            if flash == "flash_bwd_wgmma" and c["HGMMA"] == 0:
                failures.append(f"{key}: no HGMMA instruction")
            continue
        if not (ring or tf32 or local):
            continue
        if ring or tf32:
            sr = semiring_of(fn) if ring else "PlusTimes"
            key = f"{ring or tf32}<{sr}>" + (
                "" if ring else ("<reduce>" if "Lb1E" in fn else "<store>"))
        elif local == SCAN_KERNEL:
            op = next((o[1:] for o in SCAN_OPS if o in fn), "?")
            key = f"{SCAN_KERNEL}<{op}>"
        else:
            key = local
        alu = c["FMNMX"] + c["FADD"] + c["FMUL"] + c["FFMA"]
        c = dict(c, lds_per_alu=c["LDS"] / alu if alu else None)
        rows[key] = c
        print(f"[sass] {key}: " + ", ".join(f"{k} {v}" for k, v in c.items()
                                           if v), flush=True)
        if ring and sr != "PlusTimes":
            if (c["FMNMX"] < 8 * 8 * 4
                    or (c["FSEL"] + c["FSETP"]) * 8 > c["FMNMX"]):
                failures.append(f"{key}: ⊕ is not one FMNMX a MAC ({c})")
        if ((ring and sr != "PlusTimes") or local == SCAN_KERNEL) \
                and c["fmnmx_nan"] != c["FMNMX"]:
            failures.append(f"{key}: {c['FMNMX'] - c['fmnmx_nan']} FMNMX "
                            f"without .NAN (drops NaN)")
        if tf32 and c["tf32_hgmma"] == 0:
            failures.append(f"{key}: no HGMMA .TF32 instruction")
        if key == "tf32x3_kernel<PlusTimes><store>" and c["slab_hgmma"] != 12:
            failures.append(f"{key}: {c['slab_hgmma']} {TF32_SLAB_HGMMA}, not "
                            "12 (a slab's four k8 steps of three passes)")
        if local and c["LDL"] + c["STL"]:
            failures.append(f"{key}: local memory ({c['LDL']} LDL, "
                            f"{c['STL']} STL)")
    for src, fns in report["ptxas"].items():
        for fn, r in fns.items():
            print(f"[ptxas] {src} {fn}: {r}", flush=True)
    report["sass"] = rows
    report["failures"] = failures
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    for f in failures:
        print(f"sass_check FAILED: {f}", file=sys.stderr)
    if not rows:
        print("sass_check FAILED: no ring or TF32 kernel found", file=sys.stderr)
        return 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
