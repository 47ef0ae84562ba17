"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled on first use with ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together, then one link) into a shared
library with a plain C interface under ``build/`` at the repository root,
and loaded with ``ctypes``.  The library's file name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time: CPU-only installs import
every module and never reach ``nvcc``.

Every kernel wrapper launches through :func:`launch`, which turns a
non-zero ``cudaGetLastError()`` into an exception and adds one to the
kernel's entry in :data:`LAUNCHES` — the count a run reads to show that it
went through the kernels.  The wrappers call it only with a non-empty grid
(they return an empty result without it), so each count is a grid that ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["LAUNCHES", "SEMIRING_IDS", "build", "check_cuda", "launch",
           "load", "reset_launch_counts", "resolve_impl"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("range_mask.cu", "semiring_matmul.cu", "bsr_pairlist.cu")
HEADERS = ("semiring.cuh", "tile_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# template instance of each registered semiring (csrc/semiring.cuh)
SEMIRING_IDS = {"plus_times": 0, "max_plus": 1, "min_plus": 2, "max_min": 3,
                "max_times": 4, "and_or": 5}

# kernel launches since the last reset, by kernel
LAUNCHES: Dict[str, int] = {"range_mask": 0, "semiring_matmul": 0,
                            "bsr_pairlist": 0, "bsr_pairlist_reduce": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "range_mask_launch": (_P, _P, _P, _LL, _I, _I, _I, _I, _P),
    "semiring_matmul_launch": (_I, _P, _P, _P, _I, _I, _I, _P),
    "bsr_pairlist_launch": (_I, _P, _P, _P, _P, _P, _P, _I, _P),
    "bsr_pairlist_reduce_launch": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _P),
}

_LOCK = threading.Lock()          # guards the one-time build and load
_COUNT_LOCK = threading.Lock()    # dict += is a read-modify-write
_LIB = None


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels cannot be built")
    return str(path)


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the shared library's path.  ``verbose`` adds ``-Xptxas -v`` and
    prints the compiler's report of registers and shared memory (the
    report changes no code, so it does not enter the library's hash)."""
    extra = ("-Xptxas", "-v") if verbose else ()
    lib = _BUILD / f"repro_torch_kernels-{_digest()}.so"
    if lib.exists():
        return lib
    obj_dir = _BUILD / f"obj-{lib.stem}-{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:                      # one nvcc per source, at once
        obj = obj_dir / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(_CSRC / name),
               "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(f"[nvcc {name}]\n{out}", flush=True)
        if p.returncode != 0:
            failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = obj_dir / lib.name
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *[str(obj_dir / (n + ".o")) for n in SOURCES]],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, lib)                      # atomic: readers see all or none
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and then cached."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def resolve_impl(impl: str, t: torch.Tensor) -> str:
    """``"auto"`` follows the tensor's device: the kernel for a CUDA tensor,
    the plain torch version for a CPU tensor."""
    if impl == "auto":
        return "cuda" if t.is_cuda else "ref"
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown kernel impl {impl!r}; "
                         f"expected auto/cuda/ref")
    return impl


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device of compute
    capability 9.0 (the kernels are built for sm_90a only)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("the CUDA kernel needs CUDA tensors; got one "
                             f"on {t.device} (use impl='ref' on the CPU)")
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a; {torch.cuda.get_device_name(dev)}"
            f" has compute capability {cap[0]}.{cap[1]}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, *args) -> None:
    """Call ``<kernel>_launch(*args)``; raise on a CUDA error, else count.
    Call it only with a non-empty grid: the C entries return 0 without a
    launch on an empty size, which would count a launch that never ran."""
    lib = load()
    err = getattr(lib, kernel + "_launch")(*args)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1
