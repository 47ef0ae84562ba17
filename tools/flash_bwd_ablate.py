#!/usr/bin/env python3
"""Time the bf16 flash backward (``csrc/flash_attention_bwd_sm90.cu``)
against variants of its own source, each with one design choice undone,
on one card.

    python3 tools/flash_bwd_ablate.py
    python3 tools/flash_bwd_ablate.py --variants keytile_order,exp2f \\
        --shapes qwen3-1.7b,minicpm-2b

Each variant is the source with the text substitutions of ``VARIANTS``
(the script fails if one no longer applies), built with ``nvcc`` and the
port's flags into ``build/ablate/`` (all at once) and called through its
C entry with the wrapper's arguments (``ops.flash_attention_bwd_cuda``'s
scratch and GQA split).  The variants that undo a choice must stay within
``chip_smoke.BWD_REL_TOL`` of the plain backward; those marked
``timing only`` drop work (their results are wrong) and show what that
work costs.  At each of chip_smoke's train shapes
(``chip_smoke.TRAIN_BWD_SHAPES``, or ``--shapes``) the kernel and the
variants are timed in turns (kernel, variants, variants reversed, kernel)
by ``chip_smoke.cuda_ms``.  The last lines are the card's name and power
limit and one JSON object of the times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)

SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc",
                      "flash_attention_bwd_sm90.cu")

_ATOMICS = (
    "        atomicAdd(a4 + 32 * j, make_float4(dq[4 * j], dq[4 * j + 1], "
    "dq[4 * j + 2], dq[4 * j + 3]));")

# name: (what it undoes, correct?, [(old text, new text), ...])
VARIANTS = {
    "keytile_order": (
        "blocks with the key tile the slowest index of all (no chunks of "
        "one wave of groups)", True,
        [("  const int cg = max(1, p.wave / n_kt);",
          "  const int cg = nbk;")]),
    "exp2f": ("exp2f in place of ex2.approx.ftz", True,
              [("x[e] = ex2(fmaf(", "x[e] = exp2f(fmaf(")]),
    "kv_smem": ("D 64: K and V read from shared memory by each S and dP "
                "product (no register fragments)", True,
                [("  constexpr bool KVREG = DQ == 64;",
                  "  constexpr bool KVREG = false;")]),
    "no_group_split": ("every GQA group whole in one block", True, []),
    "dq_own_keys": (
        "D 128 and 192: each warpgroup's dQ over its own 64 keys and every "
        "64-column chunk (twice the atomics, no shared barrier)", True,
        [("  const int c_lo = NQ == 1 ? 0 : (NQ == 2 ? w : 2 * w);",
          "  const int c_lo = 0;"),
         ("  const int c_hi = NQ == 1 ? 1 : (NQ == 2 ? w + 1 : 2 + w);",
          "  const int c_hi = NQ;"),
         ("  constexpr int KSTEPS = NQ == 1 ? 4 : 8;",
          "  constexpr int KSTEPS = 4;"),
         ("  const int kk_lo = NQ == 1 ? 4 * w : 0;",
          "  const int kk_lo = 4 * w;"),
         ("    if (NQ == 1)\n      asm volatile(",
          "    if (true)\n      asm volatile("),
         ("      if (OVERLAP) {\n        wgmma_wait<1>();",
          "      if (OVERLAP && ch == c_lo) {\n        wgmma_wait<1>();")]),
    "no_dq_atomics": ("timing only: dQ's atomic adds dropped", False,
                      [(_ATOMICS, "        if (dq[4 * j] == 1.2345e38f)\n"
                        + _ATOMICS)]),
    "no_shared_barrier": (
        "timing only: the per-pair barrier of both warpgroups dropped",
        False, [('      asm volatile("bar.sync 1, 256;\\n" ::: "memory");',
                 "      ;")]),
    "empty_main": ("timing only: the main launch does no pair (pre, post "
                   "and the launches alone)", False,
                   [("  const int n_it = n_qt * n_heads;",
                     "  const int n_it = 0 * n_qt * n_heads;")]),
}

def sources(names) -> dict:
    base = open(SOURCE).read()
    out = {}
    for name in names:
        text = base
        for old, new in VARIANTS[name][2]:
            if old not in text:
                raise SystemExit(f"flash_bwd_ablate: variant {name}: {old!r} "
                                 f"is not in {SOURCE}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(texts: dict) -> dict:
    """Each source compiled (all at once) into a library → {name: C
    entry}."""
    from repro_torch.kernels import cuda_lib
    out_dir = os.path.join(ROOT, "build", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I",
             os.path.dirname(SOURCE), "-shared", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        fn = ctypes.CDLL(so).flash_attention_bwd_wgmma_launch
        fn.argtypes = list(cuda_lib._SIGNATURES[
            "flash_attention_bwd_wgmma_launch"])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def call(fn, x, split: bool):
    """The wrapper's host work around one variant's launch."""
    import torch

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v, o, do, lse = (x[n] for n in ("q", "k", "v", "o", "do", "lse"))
    m = x["masks"]
    b, h, sq, d = q.shape
    kv, sk, dvh = k.shape[1], k.shape[2], v.shape[3]
    grads = [torch.empty_like(t) for t in (q, k, v)]
    dqi, dvi = fa_ops.head_dims(d, dvh)
    nsplit = fa_ops.bwd_group_split(b, kv, h // kv, sk,
                                    cuda_lib.sm_count(q.device)) if split else 1
    scratch = torch.empty(b * h * -(-sq // 64) * 64 * (dqi + 2) + (
        nsplit * b * kv * sk * (dqi + dvi) if nsplit > 1 else 0),
        dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, *grads)
                                         for s in t.stride()[:3]))
    scale = m["sm_scale"] or 1.0 / math.sqrt(d)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
             *(g.data_ptr() for g in grads), strides, b, h, kv, sq, sk, d,
             dvh, int(m["causal"]), m["window"] or -1, 0, nsplit, scale,
             cuda_lib.stream_ptr(q))
    if err != 0:
        raise RuntimeError(f"flash_bwd_ablate: CUDA error {err}")
    return grads


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default=None,
                    help="labels of chip_smoke.TRAIN_BWD_SHAPES (default all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ablate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain version
    names = args.variants.split(",")
    texts = sources([n for n in names if VARIANTS[n][2]])
    texts["kernel"] = open(SOURCE).read()
    entries = build(texts)
    # (C entry, split GQA groups as the wrapper does)
    runs = {"kernel": (entries["kernel"], True)}
    for n in names:
        runs[n] = (entries.get(n, entries["kernel"]), n != "no_group_split")
    wanted = args.shapes.split(",") if args.shapes else None
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(
        chip_smoke.SERVE_SEED)
    times = {}
    for label, b, h, kv, s, d, kw in chip_smoke.TRAIN_BWD_SHAPES:
        # every shape's inputs are drawn, so each is chip_smoke's
        x = chip_smoke.bwd_inputs(b, h, kv, s, d, gen, **kw)
        if wanted is not None and label not in wanted:
            continue
        plain, _ = chip_smoke.bwd_plain(x)
        want = plain()
        rels = {}
        for name, (fn, split) in runs.items():
            got = call(fn, x, split)
            rels[name] = max(chip_smoke.rel_err(g, w)
                             for g, w in zip(got, want))
            correct = name == "kernel" or VARIANTS[name][1]
            if correct and rels[name] > chip_smoke.BWD_REL_TOL:
                raise SystemExit(f"flash_bwd_ablate: {name} at {label} is "
                                 f"{rels[name]} (relative L2) from the plain "
                                 f"version")
        del want
        order = ["kernel", *names, *names[::-1], "kernel"]
        got_ms = {n: [] for n in runs}
        for name in order:
            fn, split = runs[name]
            got_ms[name].append(chip_smoke.cuda_ms(
                lambda: call(fn, x, split), 3))
        t = {n: sum(v) / len(v) for n, v in got_ms.items()}
        bound = chip_smoke.bwd_bound(x)[0]
        times[label] = {"ms": t, "turns": got_ms, "bound_ms": bound,
                        "rel_l2": rels}
        print(f"[ablate] {label}: kernel {t['kernel']:.4f} ms "
              f"({100 * bound / t['kernel']:.2f}% of its {bound:.4f} ms "
              "bound); " + ", ".join(
                  f"{n} {t[n]:.4f} ms ({t[n] / t['kernel']:.3f}x)"
                  for n in names), flush=True)
        del x
        torch.cuda.empty_cache()
    for name in names:
        print(f"[variant] {name}: {VARIANTS[name][0]}")
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
