"""Shared helpers of the ``test_torch_*`` files: seeded numpy inputs fed to
both the JAX package (``repro``) and its PyTorch port (``repro_torch``)."""
import contextlib
import functools
import gc
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# The port's tests run torch on one intra-op thread, as its spawned ranks
# do.  Their tensors are small, so more threads shorten nothing, and
# OpenMP's idle threads spin between parallel regions: on a busy machine
# they take the cores that the JAX side's compiles (``warm_jax``) need.
torch.set_num_threads(1)

SEMIRINGS = ("plus_times", "max_plus", "min_plus", "max_min", "max_times",
             "and_or")

# exact comparisons everywhere except (+,×) sums of random floats, whose
# order differs between the packages: rtol 1e-5
RTOL_PLUS_TIMES = 1e-5


def keys(rng, n, k, width=4):
    """n zero-padded decimal keys drawn from k distinct values."""
    return np.char.zfill(rng.integers(0, k, n).astype(str), width)


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, semiring="max_plus", floats=True):
    """Port result ``got`` against JAX result ``want``: exact, except
    rtol 1e-5 for (+,×) on random floats."""
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if semiring == "plus_times" and floats:
        np.testing.assert_allclose(g, w, rtol=RTOL_PLUS_TIMES, atol=1e-6)
    else:
        np.testing.assert_array_equal(g, w)


def assert_same_tensor(t, j, semiring="max_plus", floats=True):
    """A port AssocTensor against a JAX AssocTensor, field by field."""
    assert int(t.nnz) == int(j.nnz)
    assert t.capacity == j.capacity
    np.testing.assert_array_equal(np_of(t.rows), np_of(j.rows))
    np.testing.assert_array_equal(np_of(t.cols), np_of(j.cols))
    assert_same(t.vals, j.vals, semiring, floats)
    np.testing.assert_array_equal(t.row_space.keys, j.row_space.keys)
    np.testing.assert_array_equal(t.col_space.keys, j.col_space.keys)


def assert_same_assoc(t, j):
    """A port host Assoc against a JAX host Assoc, triple by triple."""
    for x, y in zip(t.triples(), j.triples()):
        np.testing.assert_array_equal(x, y)


def warm_jax(calls, workers=None):
    """Make ``calls`` (into the JAX package) on ``workers`` threads (by
    default one a core, at most 8) and drop what they return or raise.  XLA
    compiles with the GIL released, so the programs that a module's tests
    are about to call compile side by side, and each test then finds its
    programs compiled."""
    from concurrent.futures import ThreadPoolExecutor

    if workers is None:
        workers = min(8, os.cpu_count() or 1)

    def quiet(call):
        try:
            call()
        except Exception:  # noqa: BLE001 -- the test makes the call again
            pass

    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(quiet, calls))


_FROZE: list = []


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX package's programs compile with XLA's backend optimisations
    off while a port test module runs, and as before after it.  Its
    reference results come from small programs that mostly run once, so
    compiling them is most of their time; switching the optimisations off
    changes no result and shortens that time.  (``jax_optimization_level``
    stays as it is: it is part of JAX's cache keys.)  A module fixture that
    compiles JAX programs takes this one as its first argument, so that it
    runs after it.

    Each module also starts with JAX's caches emptied: a compile takes
    longer the more compiled programs the process holds (the JAX
    package's own tests leave thousands), and one module seldom reuses
    another's programs.

    The first port module also freezes what the process holds then
    (``gc.freeze`` after a collection): the JAX package's tests leave a
    large heap that every later full collection would walk again."""
    import jax
    jax.clear_caches()
    if not _FROZE:
        gc.collect()
        gc.freeze()
        _FROZE.append(True)
    name = "jax_disable_most_optimizations"
    old = jax.config.values[name]
    jax.config.update(name, True)
    yield
    jax.config.update(name, old)


@pytest.fixture(autouse=True)
def _reset_port_stats():
    """Every port test starts from zeroed port counters (the repo's
    conftest does the same for ``repro``)."""
    from repro_torch import core
    core.reset_all_stats()
    yield


# -- the sharded layer ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def cpu_mesh():
    """The one-rank gloo mesh of this pytest process: made once, and a
    process group of its own (``torch.distributed``'s default group stays
    unset for every other test)."""
    from repro_torch.core import make_mesh
    return make_mesh("cpu")


SRC = str(Path(__file__).resolve().parent.parent / "src")

# the first lines of every port rank: no JAX, nothing of the JAX package
_PORT_PRELUDE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.core import make_mesh
RANK, WORLD, STORE, OUT = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
mesh = make_mesh("cpu", rank=RANK, world_size=WORLD, store_path=STORE)
"""


class SpmdRun:
    """``jax_prog`` in one JAX process on ``world`` host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count``) and ``port_prog``
    in ``world`` port ranks on one gloo group, all started at once when
    made, so that a module's other tests run meanwhile.  Each program
    writes an ``.npz``: the JAX one to ``sys.argv[1]``, rank r to ``OUT``.
    :meth:`result` waits and returns ``(jax_arrays, [rank arrays])``;
    with ``jax_prog=None`` only the port ranks run (``jax_arrays`` is
    None).  A process still running at ``timeout`` fails the result."""

    def __init__(self, jax_prog, port_prog: str, tmp, world: int = 4,
                 timeout: float = 240.0):
        tmp = Path(tmp)
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        jax_env = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={world}"),
            JAX_DISABLE_MOST_OPTIMIZATIONS="1")
        self.timeout = timeout
        self.jax_out = tmp / "jax.npz"
        self.outs = [tmp / f"rank{r}.npz" for r in range(world)]
        self.names = (["jax"] if jax_prog else []) + [
            f"rank {r}" for r in range(world)]
        self.procs = [] if jax_prog is None else [subprocess.Popen(
            [sys.executable, "-c", jax_prog, str(self.jax_out)], env=jax_env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
        self.procs += [subprocess.Popen(
            [sys.executable, "-c", _PORT_PRELUDE + port_prog, str(r),
             str(world), str(tmp / "store"), str(self.outs[r])], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        self._result = None

    def result(self):
        if self._result is None:
            errors = []
            try:
                for name, p in zip(self.names, self.procs):
                    _, err = p.communicate(timeout=self.timeout)
                    if p.returncode != 0:
                        errors.append(f"{name} exited {p.returncode}:\n"
                                      f"{err[-3000:]}")
            finally:
                self.close()
            if errors:
                raise RuntimeError("\n".join(errors))
            self._result = (
                None if not self.jax_out.exists()
                else dict(np.load(self.jax_out, allow_pickle=False)),
                [dict(np.load(o, allow_pickle=False)) for o in self.outs])
        return self._result

    def close(self) -> None:
        """Stop whatever still runs."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


# -- the mesh (module step 10) ----------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int):
    """A ``"fake"`` default process group of ``world`` ranks (this process
    is rank 0; every collective is a no-op), destroyed on exit so that no
    later test sees a default group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def local_ranks(world: int):
    """``world`` simulated ranks in this process: ``LocalTensorMode`` over
    a fake group of that size (collectives run on the ranks' real
    values)."""
    from torch.distributed._local_tensor import LocalTensorMode
    with fake_group(world), LocalTensorMode(world) as mode:
        yield mode


# -- the JAX package's SMOKE inits, shared by the port's test modules -------------

_JAX_INITS: dict = {}


def jax_init_f32(jc):
    """The JAX package's ``init(PRNGKey(0), jc)`` parameters at f32, made
    once per pytest process for every config that differs from ``jc`` only
    in fields the init does not read (the compute dtype, remat, the
    attention route and chunks, the MoE capacity and top-k), so that the
    port's model test modules share one compiled init per config."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    key = jc.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                     remat="none", attn_impl="reference", attn_chunk=512,
                     loss_chunk=512)
    if key.moe:
        key = key.replace(moe={k: v for k, v in key.moe.items()
                               if k not in ("capacity_factor", "top_k")})
    name = repr(key)
    if name not in _JAX_INITS:
        _JAX_INITS[name] = jax.jit(lambda k: JM.init(k, jc.replace(
            param_dtype=jnp.float32))[0])(jax.random.PRNGKey(0))
    return _JAX_INITS[name]
