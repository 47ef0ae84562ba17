"""The port's ingest over a sharded ``DistAssoc`` base
(``repro_torch.ingest``, dist layer) against the JAX package's.

* One rank, in this process, against the JAX 1-shard table on the same
  triples: merge-on-read over the full semiring registry (the JAX suite's
  triple mix: base↔delta collisions, duplicates within a batch, new keys
  before and after the old ranges), compaction, the routing table after
  compaction, zero collectives (the JAX ``@contract`` of the dist merge),
  and the ingest workload of the main path at a small size, held against
  the host ``Assoc`` and the device table.
* Four ranks: one JAX process on four host devices and four port ranks on
  one gloo group stream the same batches; every snapshot's shards, the
  ``row_bounds`` that merges and compaction produce, and a selection on a
  snapshot equal the JAX shards.

Values are integers or exact binary fractions: every comparison is exact.
"""
import jax
import numpy as np
import pytest

import repro.core as J
import repro.ingest as JI
import repro_torch.core as T
from repro.analysis.contracts import CONTRACT_ATTR
from repro.ingest import merge as jmerge
from repro_torch import main_path
from repro_torch.core.collectives import collective_count
from repro_torch.ingest import IngestTable

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import (_reset_port_stats,  # noqa: F401
                            SpmdRun, cpu_mesh)

_BASE = (["b", "d", "f", "h"], ["x", "y", "x", "z"], [2.0, 3.0, 4.0, 5.0])
_DELTA = (["b", "b", "a", "zz", "d"], ["x", "x", "w", "z", "y"],
          [10.0, 20.0, 1.5, 7.0, 0.5])


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(scope="module", autouse=True)
def _free_jax_programs():
    """Free the XLA programs this module compiled when it ends: each keeps
    memory maps, and one pytest process runs the whole suite under the
    kernel's limit on them."""
    yield
    jax.clear_caches()


def _tables(agg, jmesh, base=_BASE):
    t = IngestTable(T.DistAssoc.from_triples(*base, cpu_mesh(), aggregate=agg,
                                             device="cpu"), aggregate=agg)
    j = JI.IngestTable(J.DistAssoc.from_triples(*base, jmesh, aggregate=agg),
                       aggregate=agg)
    return t, j


def _stream(table):
    r, c, v = _DELTA
    table.insert(r[:2], c[:2], v[:2])
    table.insert(r[2:], c[2:], v[2:])
    return table.snapshot()


def assert_same_dist(t, j):
    loc, jl = t.local, j.local
    assert int(loc.nnz) == int(np.asarray(jl.nnz)[0])
    np.testing.assert_array_equal(loc.rows.numpy(), np.asarray(jl.rows)[0])
    np.testing.assert_array_equal(loc.cols.numpy(), np.asarray(jl.cols)[0])
    np.testing.assert_array_equal(loc.vals.numpy(), np.asarray(jl.vals)[0])
    np.testing.assert_array_equal(t.row_bounds, j.row_bounds)
    np.testing.assert_array_equal(loc.row_space.keys, jl.row_space.keys)
    np.testing.assert_array_equal(loc.col_space.keys, jl.col_space.keys)


@pytest.mark.parametrize("sr_name", sorted(T.REGISTRY))
def test_merge_on_read_parity_full_semiring_registry(jmesh, sr_name):
    """base ⊕ delta ≡ the JAX dist table ≡ a one-shot constructor over the
    concatenated triples, for every ⊕ monoid of the registry; no
    collective."""
    agg = T.REGISTRY[sr_name].add_kind
    t, j = _tables(agg, jmesh)
    got = _stream(t)
    assert collective_count() == 0
    assert t.layer == "dist" and isinstance(got, T.DistAssoc)
    assert_same_dist(got, _stream(j))
    oracle = T.DistAssoc.from_triples(
        _BASE[0] + _DELTA[0], _BASE[1] + _DELTA[1], _BASE[2] + _DELTA[2],
        cpu_mesh(), aggregate=agg, device="cpu")
    assert got.to_assoc() == oracle.to_assoc()


def test_compaction_preserves_content_and_bumps_version(jmesh):
    t, j = _tables("sum", jmesh)
    for table in (t, j):
        table.insert(*_DELTA)
    before = t.snapshot().to_assoc()
    out, jout = t.compact(), j.compact()
    assert out == jout
    assert out["compacted"] == len(_DELTA[0]) and out["version"] == 1
    assert t.delta_depth == 0 and t.snapshot().to_assoc() == before
    assert t.compact() == {"compacted": 0, "version": 1}
    # post-compaction ingest still lands right (routing table refreshed)
    for table in (t, j):
        table.insert(["zz"], ["z"], [1.0])
    after = t.snapshot()
    assert_same_dist(after, j.snapshot())
    assert after.to_assoc().get("zz", "z") == before.get("zz", "z") + 1.0
    np.testing.assert_array_equal(t._bkeys, j._bkeys)


def test_dist_merge_collectives_match_jax_contract():
    want = getattr(jmerge._dist_merge_prog, CONTRACT_ATTR).collectives
    t = IngestTable(T.DistAssoc.from_triples(*_BASE, cpu_mesh(),
                                             aggregate="max", device="cpu"),
                    aggregate="max")
    t.insert(*_DELTA)
    T.reset_collective_stats()
    t.snapshot()
    t.compact()
    assert collective_count() == want == 0


def test_dist_rejections():
    base = T.DistAssoc.from_triples(*_BASE, cpu_mesh(), aggregate="sum",
                                    device="cpu")
    with pytest.raises(ValueError, match="max.*min.*sum"):
        IngestTable(base, aggregate="concat")
    t = IngestTable(base, aggregate="sum")
    with pytest.raises(TypeError, match="dist ingest requires numeric"):
        t.insert(["a"], ["b"], ["str"])
    strings = T.DistAssoc.from_triples(["a"], ["b"], ["s"], cpu_mesh(),
                                       device="cpu")
    with pytest.raises(TypeError, match="numeric"):
        IngestTable(strings)


def test_dist_ingest_main_path_small():
    """The ingest workload of the main path at uniform n=8 over DistAssoc
    bases: every snapshot, the selection and compaction against the host
    Assoc, and entry by entry against the same workload over AssocTensor
    bases; no collective."""
    ing = main_path.build_ingest(8, "cpu", mesh=cpu_mesh())
    T.reset_collective_stats()
    res = main_path.drive_ingest(ing)
    assert collective_count() == 0
    res_dev = main_path.drive_ingest(main_path.build_ingest(8, "cpu"))
    checks = (main_path.check_ingest(ing["raw"], res)
              + main_path.check_dist_ingest(res, res_dev))
    assert len(checks) == 18
    assert all(ok for _, ok, _ in checks), [c for c in checks if not c[1]]


# ---------------------------------------------------------------------------
# four ranks against the JAX package on four host devices
# ---------------------------------------------------------------------------

_DATA = """
import numpy as np
rng = np.random.default_rng(23)
def keys(n, k):
    return np.char.zfill(rng.integers(0, k, n).astype(str), 3)
BASE = (keys(160, 60), keys(160, 40), rng.integers(1, 10, 160) * 1.0)
# six batches with new row keys before, inside and after the base's range
BATCHES = [(keys(40, 90), keys(40, 50), rng.integers(1, 10, 40) * 1.0)
           for _ in range(6)]
BATCHES[2] = (np.char.add("!", BATCHES[2][0]), BATCHES[2][1], BATCHES[2][2])
AGAIN = (keys(30, 60), keys(30, 40), rng.integers(1, 10, 30) * 1.0)
"""

_OPS = """
for agg in ("sum", "max", "min"):
    table = IngestTable(build(*BASE, agg), aggregate=agg)
    put_d(agg + "_base", table.snapshot())
    for k, b in enumerate(BATCHES):
        table.insert(*b)
        if k == 2:
            put_d(agg + "_half", table.snapshot())
    snap = table.snapshot()
    put_d(agg + "_full", snap)
    keys_ = snap.local.row_space.keys
    put_d(agg + "_select",
          snap[Range(keys_[len(keys_) // 4], keys_[len(keys_) // 2]), :])
    table.compact()
    put_d(agg + "_compact", table.snapshot())
    table.insert(*AGAIN)
    put_d(agg + "_after", table.snapshot())
"""

_JAX_PROG = _DATA + """
import sys
import jax
from repro.core.dist_assoc import DistAssoc
from repro.core.select import Range
from repro.ingest import IngestTable
mesh = jax.make_mesh((4,), ("data",))
out = {}
def build(r, c, v, agg):
    return DistAssoc.from_triples(r, c, v, mesh, aggregate=agg)
def put_d(name, d):
    for f in ("rows", "cols", "vals", "nnz"):
        out[name + "__" + f] = np.asarray(getattr(d.local, f))
    out[name + "__bounds"] = np.asarray(d.row_bounds)
""" + _OPS + """
np.savez(sys.argv[1], **out)
"""

_PORT_PROG = _DATA + """
from repro_torch.core import DistAssoc
from repro_torch.core.select import Range
from repro_torch.ingest import IngestTable
out = {}
def build(r, c, v, agg):
    return DistAssoc.from_triples(r, c, v, mesh, aggregate=agg, device="cpu")
def put_d(name, d):
    for f in ("rows", "cols", "vals", "nnz"):
        out[name + "__" + f] = getattr(d.local, f).numpy()
    out[name + "__bounds"] = np.asarray(d.row_bounds)
""" + _OPS + """
np.savez(OUT, **out)
"""

STEPS = [f"{agg}_{step}" for agg in ("sum", "max", "min")
         for step in ("base", "half", "full", "select", "compact", "after")]


@pytest.fixture(scope="module", autouse=True)
def _four_started(tmp_path_factory):
    """The JAX process and the four ranks, started before the module's
    first test and stopped after its last."""
    run = SpmdRun(_JAX_PROG, _PORT_PROG, tmp_path_factory.mktemp("ingest4"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def four(_four_started):
    return _four_started.result()


@pytest.mark.parametrize("step", STEPS)
def test_four_ranks_ingest_equals_jax(four, step):
    jx, ranks = four
    for r, got in enumerate(ranks):
        for f in ("rows", "cols", "vals", "nnz"):
            np.testing.assert_array_equal(got[f"{step}__{f}"],
                                          jx[f"{step}__{f}"][r], err_msg=f)
        np.testing.assert_array_equal(got[f"{step}__bounds"],
                                      jx[f"{step}__bounds"])


def test_four_ranks_bounds_move_with_new_keys(four):
    """New row keys before the base's range move every bound after the
    first; compaction keeps them (key-interval ownership)."""
    _, ranks = four
    base, full = ranks[0]["sum_base__bounds"], ranks[0]["sum_full__bounds"]
    assert base[0] == full[0] == 0
    assert (full[1:] > base[1:]).all()
    np.testing.assert_array_equal(ranks[0]["sum_compact__bounds"], full)
