#!/usr/bin/env python3
"""Time the port's rank_count kernel against another source of it, on one card.

    git show <commit>:src/repro_torch/csrc/rank_count.cu > build/rank_count_old.cu
    python3 tools/rank_count_ab.py build/rank_count_old.cu

The other source must export the same C entry, ``rank_count_launch(i, j,
rank, hit, ni, nj, stream)``, and write every entry of ``rank`` and ``hit``.
It is built with ``nvcc`` and the port's flags into ``build/`` and called
through a copy of the port wrapper's host work (checks, contiguous inputs,
one allocation).  Both kernels run on the ingest path's inputs
(``chip_smoke.rank_count_inputs``: the base's and the delta's keys at
uniform n=15) and must equal two ``torch.searchsorted`` on every entry.
Then the old kernel, the new one and the two ``torch.searchsorted`` calls
are timed in turns (old, new, library, library, new, old) by chip_smoke's
two clocks: ``cuda_ms`` (device time, L2 evicted before each call) and
``host_ms`` (per call by the host's clock).  The last lines are the card's
name and power limit and one JSON object of the times.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)


def build_old(src: str) -> ctypes.CDLL:
    from repro_torch.kernels import cuda_lib
    out = os.path.join(ROOT, "build", "rank_count_ab")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "rank_count_old.so")
    r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        "-o", so, src], capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.rank_count_launch.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.rank_count_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    from repro_torch import main_path
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.sorted_merge import ops as rc_ops
    if not torch.cuda.is_available():
        print("rank_count_ab: no CUDA device", file=sys.stderr)
        return 2
    old = build_old(sys.argv[1])
    cuda_lib.load()
    dev = torch.device(chip_smoke.DEVICE)
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
                print(f"rank_count_ab: the {name} kernel disagrees with "
                      f"torch.searchsorted", file=sys.stderr)
                return 1
    order = ("old", "new", "library", "library", "new", "old")
    times = {}
    for clock, fn, repeats in (("cuda_ms", chip_smoke.cuda_ms, 50),
                               ("host_ms", chip_smoke.host_ms, 200)):
        got = {k: [] for k in calls}
        for name in order:
            got[name].append(fn(calls[name], repeats))
        times[clock] = {k: sum(v) / len(v) for k, v in got.items()}
        times[clock]["turns"] = got
        t = times[clock]
        print(f"[time] rank_count {clock}: old {t['old']:.4f}, new "
              f"{t['new']:.4f}, library {t['library']:.4f}; new / old "
              f"{t['new'] / t['old']:.3f}, new / library "
              f"{t['new'] / t['library']:.3f}, old / library "
              f"{t['old'] / t['library']:.3f}", flush=True)
    print(f"[shape] {i.shape[0]} keys in {j.shape[0]} keys, exact both ways")
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
