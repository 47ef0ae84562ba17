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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

from repro_torch.core.semiring import REGISTRY, Semiring

__all__ = ["LAUNCHES", "SEMIRING_IDS", "build", "check_cuda",
           "kernel_semiring_id", "launch", "load", "plain_route",
           "reset_launch_counts", "resolve_impl"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("range_mask.cu", "semiring_matmul.cu", "bsr_pairlist.cu",
           "bsr_spgemm.cu", "rank_count.cu", "segment_scan.cu",
           "flash_attention.cu", "flash_attention_sm90.cu",
           "flash_attention_bwd.cu", "flash_attention_bwd_sm90.cu",
           "semiring_tf32_sm90.cu", "bsr_pairlist_tf32_sm90.cu")
HEADERS = ("semiring.cuh", "semiring_gemm_sm90.cuh", "tf32_sm90.cuh",
           "pairlist_items.cuh", "flash_sm90.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# template instance of each registered semiring (csrc/semiring.cuh)
SEMIRING_IDS = {"plus_times": 0, "max_plus": 1, "min_plus": 2, "max_min": 3,
                "max_times": 4, "and_or": 5}
_RING = tuple(k for k, v in SEMIRING_IDS.items() if v)


def kernel_semiring_id(sr: Semiring) -> int:
    """The kernels' template index for ``sr``, which every card route asks
    for before a launch.  A semiring with ``mxu=True`` is a plain
    multiply-accumulate, which the JAX kernels send to ``jnp.dot``: 0, the
    (+, ×) kernels (the TF32 route where one exists).  Any other semiring
    has a kernel only if it is the registry's own object of one of the five
    ring semirings (1-5); an unregistered one, or a copy that reuses a
    registered name with other operations, raises ``ValueError`` — no
    kernel computes its ⊕ and ⊗.  CPU tensors run any semiring through the
    plain versions and never ask."""
    if sr.mxu:
        return SEMIRING_IDS["plus_times"]
    if REGISTRY.get(sr.name) is sr and sr.name in _RING:
        return SEMIRING_IDS[sr.name]
    raise ValueError(
        f"no CUDA kernel computes semiring {sr.name!r} (not the registry's "
        f"object; the card's kernels run a semiring with mxu=True and the "
        f"registry's {', '.join(_RING)}): run it on CPU tensors")

# kernel launches since the last reset, by kernel.  A *_tf32 key counts the
# tensor-core route of the kernel named before it, whose own key counts
# both routes; flash_attention and flash_attention_wgmma count one route
# each, and so do the backward's: flash_attention_bwd the fp32 one (one
# call, its dQ and dK/dV passes), flash_attention_bwd_wgmma the bf16 one
# (one call, its three launches)
LAUNCHES: Dict[str, int] = {"range_mask": 0, "semiring_matmul": 0,
                            "semiring_matmul_tf32": 0,
                            "bsr_pairlist": 0, "bsr_pairlist_tf32": 0,
                            "bsr_pairlist_reduce": 0,
                            "bsr_pairlist_reduce_tf32": 0,
                            "bsr_spgemm": 0, "bsr_spgemm_tf32": 0,
                            "bsr_spgemm_reduce": 0,
                            "bsr_spgemm_reduce_tf32": 0,
                            "rank_count": 0, "segment_scan": 0,
                            "flash_attention": 0, "flash_attention_wgmma": 0,
                            "flash_attention_bwd": 0,
                            "flash_attention_bwd_wgmma": 0}

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {
    "range_mask_launch": (_P, _P, _P, _LL, _I, _I, _I, _I, _P),
    "semiring_matmul_launch": (_I, _P, _P, _P, _I, _I, _I, _P),
    "semiring_matmul_tf32_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "bsr_pairlist_launch": (_I, _P, _P, _P, _P, _P, _P, _I, _P),
    "bsr_pairlist_tf32_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    "bsr_pairlist_reduce_launch": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _I, _P),
    "bsr_pairlist_reduce_tf32_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _P),
    "bsr_spgemm_launch": (_I, _P, _P, _P, _P, _I, _I, _I, _P),
    "bsr_spgemm_tf32_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "bsr_spgemm_reduce_launch": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "bsr_spgemm_reduce_tf32_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _P),
    "rank_count_launch": (_P, _P, _P, _P, _I, _I, _P),
    "segment_scan_launch": (_I, _P, _P, _P, _LL, _P, _LL, ctypes.c_uint, _P),
    "flash_attention_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _F, _P),
    "flash_attention_wgmma_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _F, _P),
    "flash_attention_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _F, _P),
    "flash_attention_bwd_wgmma_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                         _I, _I, _I, _I, _F, _P),
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


_ROUTE = threading.local()


@contextlib.contextmanager
def plain_route():
    """In this block (this thread), ``"auto"`` takes every kernel's plain
    version on CUDA tensors too: the same calls on the plain route, to hold
    a kernel route's results against."""
    before = getattr(_ROUTE, "plain", False)
    _ROUTE.plain = True
    try:
        yield
    finally:
        _ROUTE.plain = before


def resolve_impl(impl: str, t: torch.Tensor) -> str:
    """``"auto"`` follows the tensor's device: the kernel for a CUDA tensor,
    the plain torch version for a CPU tensor (and inside
    :func:`plain_route`)."""
    if impl == "auto":
        if getattr(_ROUTE, "plain", False):
            return "ref"
        return "cuda" if t.is_cuda else "ref"
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown kernel impl {impl!r}; "
                         f"expected auto/cuda/ref")
    return impl


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a plain tensor (an ``nn.Parameter``
    too, not a DTensor or a ``LocalTensor``: a kernel reads raw device
    pointers, which a tensor subclass's wrapper does not have) on one CUDA
    device of compute capability 9.0 (the kernels are built for sm_90a
    only)."""
    dev = tensors[0].device
    for t in tensors:
        if type(t) not in (torch.Tensor, torch.nn.Parameter):
            raise TypeError(
                f"the CUDA kernel takes plain tensors, not a "
                f"{type(t).__name__}: run it on each rank's local shard "
                f"(torch.distributed.tensor.experimental.local_map, as "
                f"models/attention.py does for the flash kernel)")
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


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors: the blocks that run at once
    when each takes a whole SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(kernel: str, *args, counts=None) -> None:
    """Call ``<kernel>_launch(*args)``; raise on a CUDA error, else add one
    to each key of ``counts`` (default: ``kernel``).  Call it only with a
    non-empty grid: the C entries return 0 without a launch on an empty
    size, which would count a launch that never ran."""
    lib = load()
    err = getattr(lib, kernel + "_launch")(*args)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
    with _COUNT_LOCK:
        for key in counts or (kernel,):
            LAUNCHES[key] += 1
