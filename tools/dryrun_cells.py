#!/usr/bin/env python3
"""Several mesh dry-run cells, one process each, on one card:

    python3 tools/dryrun_cells.py                  # the default cell list
    python3 tools/dryrun_cells.py --cells qwen3-1.7b:train_4k:2x16x16 \\
        --out build/cells.jsonl

Each cell (``arch:shape`` or ``arch:shape:2x16x16``) runs ``python -m
repro_torch.launch.dryrun`` in a process of its own (its fake process
group is that process's default group) with ``--timeout`` seconds; its
JSON record is appended to ``--out``, or, when the process died without
one, an ``error`` record with the tail of its standard error.  One summary
line a cell follows: status, per-rank peak memory, FLOPs, the useful-FLOPs
ratio, collective counts, flash launches, the dominant roofline term, or
the error.  The last lines are the card's name and power limit and a JSON
object of the cells' statuses.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the four other dense configs (both cells), then one cell of each family
# and mesh that the mesh phase leaves out
DEFAULT_CELLS = (
    "chatglm3-6b:train_4k", "chatglm3-6b:decode_32k",
    "starcoder2-7b:train_4k", "starcoder2-7b:decode_32k",
    "minicpm-2b:train_4k", "minicpm-2b:decode_32k",
    "chameleon-34b:train_4k", "chameleon-34b:decode_32k",
    "mixtral-8x22b:train_4k", "deepseek-v3-671b:decode_32k",
    "mamba2-130m:train_4k", "whisper-medium:train_4k",
    "qwen3-1.7b:train_4k:2x16x16", "qwen3-1.7b:prefill_32k",
)


def run(cell: str, out: str, timeout: float) -> dict:
    arch, shape, *mesh = cell.split(":")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if mesh and mesh[0] == "2x16x16":
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=timeout)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        rec = json.loads(lines[-1]) if lines else {
            "arch": arch, "shape": shape, "status": "error",
            "error": f"exit {proc.returncode}: {proc.stderr[-1500:]}"}
        if not lines:
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    except subprocess.TimeoutExpired:
        rec = {"arch": arch, "shape": shape, "status": "error",
               "error": f"no record within {timeout} s"}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    rec["process_s"] = time.perf_counter() - t0
    return rec


def summary(cell: str, rec: dict) -> str:
    if rec.get("status") != "ok":
        return (f"[cell] {cell}: {rec.get('status')} "
                f"{rec.get('reason') or rec.get('error', '')[:600]}")
    mem = rec["memory"]
    return (f"[cell] {cell}: ok, peak {mem['peak_bytes']} B, args "
            f"{mem['argument_bytes']} B, flops {rec['cost']['flops']}, "
            f"useful {rec['useful_flops_ratio']:.4f}, microbatch "
            f"{rec.get('microbatch')}, collectives "
            f"{rec['collectives']['counts']}, flash "
            f"{rec['flash_launches']}, dominant {rec['dominant']} "
            f"{ {k: round(rec['roofline'][k], 4) for k in ('compute_s', 'memory_s', 'collective_s')} }, "
            f"rank step {rec['rank_step_s']:.3f} s, process "
            f"{rec['process_s']:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(DEFAULT_CELLS))
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "cells.jsonl"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    statuses = {}
    for cell in args.cells.split(","):
        rec = run(cell, args.out, args.timeout)
        statuses[cell] = rec.get("status")
        print(summary(cell, rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps(statuses))
    return 0


if __name__ == "__main__":
    sys.exit(main())
