"""The port's LSM ingest (``repro_torch.ingest``) against the JAX package's
(``repro.ingest``) and the one-shot oracle: merge-on-read parity on the
host and device layers over the full semiring registry, the overlay
merge against its concat fallback, the memo, compaction (version, plan
and compile-cache invalidation), the rejections, the background
``Compactor``, and the ingest slice of the main path at a small size.

Values here are integers or exact binary fractions, so every comparison
is exact (tolerance 0)."""
import time

import numpy as np
import pytest
import torch

import repro.core as J
import repro.ingest as JI
import repro_torch.core as T
from repro_torch import main_path
from repro_torch.core.coo import SENT
from repro_torch.ingest import Compactor, IngestTable
from repro_torch.ingest import merge as tmerge
from repro_torch.kernels import LAUNCHES

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import (_reset_port_stats,  # noqa: F401
                            assert_same_assoc, assert_same_tensor)

# the JAX suite's triple mix: base↔delta key collisions, duplicates WITHIN
# one delta batch, new row AND col keys sorting before/after the existing
_BASE = (["b", "d", "f", "h"], ["x", "y", "x", "z"], [2.0, 3.0, 4.0, 5.0])
_DELTA = (["b", "b", "a", "zz", "d"], ["x", "x", "w", "z", "y"],
          [10.0, 20.0, 1.5, 7.0, 0.5])


def _build(pkg, layer, rows, cols, vals, aggregate):
    if layer == "host":
        return pkg.Assoc(rows, cols, vals, aggregate=aggregate)
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.AssocTensor.from_triples(rows, cols, vals,
                                        aggregate=aggregate, **kw)


def _as_assoc(arr):
    return arr if isinstance(arr, (T.Assoc, J.Assoc)) else arr.to_assoc()


def _stream(table):
    """The JAX suite's two delta batches (several segments in one merge)."""
    r, c, v = _DELTA
    table.insert(r[:2], c[:2], v[:2])
    table.insert(r[2:], c[2:], v[2:])
    return table.snapshot()


@pytest.mark.parametrize("layer", ["host", "device"])
@pytest.mark.parametrize("sr_name", sorted(T.REGISTRY))
def test_merge_on_read_parity_full_semiring_registry(layer, sr_name):
    """base ⊕ delta ≡ the JAX IngestTable ≡ a one-shot constructor over the
    concatenated triples, for every ⊕ monoid of the registry."""
    agg = T.REGISTRY[sr_name].add_kind
    got = _stream(IngestTable(_build(T, layer, *_BASE, agg), aggregate=agg))
    want = _stream(JI.IngestTable(_build(J, layer, *_BASE, agg),
                                  aggregate=agg))
    if layer == "device":   # same capacity, ranks, values, keyspaces
        assert_same_tensor(got, want, floats=False)
    assert_same_assoc(_as_assoc(got), _as_assoc(want))
    oracle = _build(T, layer, _BASE[0] + _DELTA[0], _BASE[1] + _DELTA[1],
                    _BASE[2] + _DELTA[2], agg)
    assert _as_assoc(got) == _as_assoc(oracle)


def test_host_order_sensitive_aggregate():
    """Host tables take any Assoc aggregator: 'concat' shows the base-first
    ⊕ order survives the overlay merge."""
    base = T.Assoc(["a", "a"], ["x", "x"], ["u", "v"], aggregate="concat")
    t = IngestTable(base, aggregate="concat")
    t.insert(["a", "b"], ["x", "y"], ["w", "q"])
    got = t.snapshot()
    assert got.get("a", "x") == "uvw" and got.get("b", "y") == "q"


def test_device_rejects_order_sensitive_aggregate_and_strings():
    base = T.AssocTensor.from_triples(*_BASE, aggregate="sum", device="cpu")
    with pytest.raises(ValueError, match="max.*min.*sum"):
        IngestTable(base, aggregate="concat")
    t = IngestTable(base, aggregate="sum")
    with pytest.raises(TypeError, match="numeric"):
        t.insert(["a"], ["b"], ["str"])
    strings = T.AssocTensor.from_triples(["a"], ["b"], ["s"], device="cpu")
    with pytest.raises(TypeError, match="numeric"):
        IngestTable(strings)


def test_rejects_dist_base_until_module_step_6():
    """Module step 6a has landed: the port's DistAssoc is a base; a JAX
    DistAssoc and any other object are refused, naming the accepted
    types."""
    import jax
    from _torch_helpers import cpu_mesh
    mesh = jax.make_mesh((1,), ("data",))
    dist = J.DistAssoc.from_triples(*_BASE, mesh, aggregate="sum")
    for bad in (dist, object()):
        with pytest.raises(TypeError, match="Assoc/AssocTensor/DistAssoc"):
            IngestTable(bad)
    port = T.DistAssoc.from_triples(*_BASE, cpu_mesh(), aggregate="sum",
                                    device="cpu")
    assert IngestTable(port, aggregate="sum").layer == "dist"


def test_snapshot_memoized_until_next_mutation():
    base = T.AssocTensor.from_triples(*_BASE, aggregate="sum", device="cpu")
    t = IngestTable(base, aggregate="sum")
    assert t.snapshot() is base          # empty delta: stable identity
    t.insert(["a"], ["w"], [1.0])
    s1 = t.snapshot()
    assert t.snapshot() is s1            # memo hit between mutations
    t.insert(["q"], ["w"], [2.0])
    s2 = t.snapshot()
    assert s2 is not s1                  # a mutation invalidates the memo
    info = t.info()
    assert info["merges"] == 2 and info["reads"] == 4
    assert info["merge_hit_rate"] == pytest.approx(0.5)
    assert t.insert([], [], []) == {"accepted": 0, "delta_depth": 2}
    with pytest.raises(ValueError, match="equal length"):
        t.insert(["a"], ["b", "c"], [1.0])


def test_pad_ranks_uploads_to_the_base_device():
    r, c, v = IngestTable._pad_ranks(np.array([3, 1]), np.array([0, 2]),
                                     np.array([1.5, 2.0]), 8, "cpu")
    assert r.device.type == "cpu" and r.dtype == torch.int32
    assert r.tolist() == [3, 1] + [SENT] * 6
    assert c.tolist() == [0, 2] + [SENT] * 6
    assert v.dtype == torch.float32 and v.tolist() == [1.5, 2.0] + [0.0] * 6


@pytest.mark.parametrize("layer", ["host", "device"])
def test_compaction_preserves_content_and_bumps_version(layer):
    t = IngestTable(_build(T, layer, *_BASE, "sum"), aggregate="sum")
    t.insert(*_DELTA)
    before = _as_assoc(t.snapshot())
    out = t.compact()
    assert out["compacted"] == len(_DELTA[0]) and out["version"] == 1
    assert t.delta_depth == 0 and t.stats["compactions"] == 1
    assert _as_assoc(t.snapshot()) == before
    assert t.compact() == {"compacted": 0, "version": 1}   # idempotent
    t.insert(["zz"], ["z"], [1.0])
    after = _as_assoc(t.snapshot())
    assert after.get("zz", "z") == before.get("zz", "z") + 1.0


def test_compaction_invalidates_plan_and_compile_caches():
    """Plans keyed on the retired base's id, and compiled selectors keyed
    on retired keyspaces, are dropped at compaction; the next query
    re-plans against the new base."""
    from repro_torch.core import select
    t = IngestTable(T.AssocTensor.from_triples(*_BASE, aggregate="sum",
                                               device="cpu"),
                    aggregate="sum")

    def total():
        return float(t.snapshot().lazy().sum(axis=None).collect())

    def row_sel():
        return t.snapshot()[T.Range("a", "c"), :]

    v0 = total()
    assert total() == v0 and T.PLAN_STATS["plan_hits"] >= 1
    row_sel()
    old_digest = t.base.row_space.digest
    assert any(k[0] == old_digest for k in select._COMPILE_CACHE)
    t.insert(["a"], ["w"], [100.0])
    assert total() == v0 + 100.0
    inv0 = T.PLAN_STATS["plan_invalidations"]
    assert t.compact()["plans_invalidated"] >= 1
    assert T.PLAN_STATS["plan_invalidations"] > inv0
    assert not any(k[0] == old_digest for k in select._COMPILE_CACHE)
    assert total() == v0 + 100.0         # re-planned, same answer
    assert int(row_sel().nnz) == 2       # ("a", "w") and ("b", "x")


class _StubRegistry:
    """What the Compactor reads of a registry."""

    def __init__(self, tables):
        self.tables = tables

    def ingest_names(self):
        return sorted(self.tables)

    def ingest_table(self, name):
        return self.tables[name]


def test_background_compactor_idle_and_depth_triggers():
    idle = IngestTable(T.AssocTensor.from_triples(*_BASE, aggregate="sum",
                                                  device="cpu"),
                       compact_threshold=10_000)
    deep = IngestTable(T.Assoc(*_BASE, aggregate="sum"), compact_threshold=2)
    comp = Compactor(_StubRegistry({"idle": idle, "deep": deep}),
                     interval_s=0.02, idle_s=0.05).start()
    try:
        idle.insert(["a"], ["b"], [1.0])
        deep.insert(["a", "c"], ["b", "d"], [1.0, 2.0])
        deadline = time.time() + 10
        while time.time() < deadline:
            if idle.version == 1 and deep.version == 1:
                break
            time.sleep(0.02)
        assert idle.version == 1 and idle.delta_depth == 0
        assert deep.version == 1 and deep.delta_depth == 0
        assert idle.base.to_assoc().get("a", "b") == 1.0
    finally:
        comp.stop()
    assert not idle.maybe_compact()      # nothing buffered


# -- the overlay merge program against its fallback ---------------------------------

def _canon(rng, cap, n, ncols, hi):
    """Canonical padded COO with distinct linear keys below ``hi``."""
    lin = np.sort(rng.choice(hi, n, replace=False))
    r = (lin // ncols).astype(np.int32)
    c = (lin % ncols).astype(np.int32)
    v = rng.integers(1, 9, n).astype(np.float32) / 4
    pad = cap - n
    return (np.concatenate([r, np.full(pad, SENT, np.int32)]),
            np.concatenate([c, np.full(pad, SENT, np.int32)]),
            np.concatenate([v, np.zeros(pad, np.float32)]))


@pytest.mark.parametrize("agg", ["sum", "min", "max"])
def test_merge_read_prog_matches_concat_prog_and_jax(agg):
    """The rank-count overlay merge ≡ the concat + dedup fallback on the
    same padded operands (the fallback is the semantic oracle), and both ≡
    the JAX programs.  The delta is raw: unsorted, with duplicates."""
    import jax.numpy as jnp
    from repro.ingest.merge import _merge_concat_prog, _merge_read_prog

    rng = np.random.default_rng(3)
    ncols = 16
    b = _canon(rng, 64, 40, ncols, 64 * 4)
    dr = rng.integers(0, 20, 32).astype(np.int32)
    dc = rng.integers(0, ncols, 32).astype(np.int32)
    dv = rng.integers(1, 9, 32).astype(np.float32) / 4
    dr[28:], dc[28:], dv[28:] = SENT, SENT, 0.0
    t_in = [torch.from_numpy(x) for x in (*b, dr, dc, dv)]
    j_in = [jnp.asarray(x) for x in (*b, dr, dc, dv)]
    got = tmerge._merge_read_prog(*t_in, ncols, agg)
    fall = tmerge._merge_concat_prog(*t_in, agg)
    j_got = _merge_read_prog(agg)(*j_in, jnp.int32(ncols))
    j_fall = _merge_concat_prog(agg)(*j_in)
    n = int(got[3])
    assert n == int(fall[3]) == int(j_got[3]) == int(j_fall[3])
    for x, y, z, w in zip(got[:3], fall[:3], j_got[:3], j_fall[:3]):
        np.testing.assert_array_equal(x.numpy(), z)       # every slot
        np.testing.assert_array_equal(y.numpy(), w)
        np.testing.assert_array_equal(x.numpy()[:n], y.numpy()[:n])


def test_merge_read_switches_to_concat_past_int32():
    """``merge_read`` takes the rank-count program only while nrows·ncols
    fits int32 (the main path's clustered n=18 does not)."""
    rng = np.random.default_rng(4)
    b = _canon(rng, 16, 10, 8, 64)
    base = T.AssocTensor(*[torch.from_numpy(x) for x in b],
                         torch.tensor(10, dtype=torch.int32),
                         T.KeySpace.integers(8), T.KeySpace.integers(8))
    d = [torch.from_numpy(x) for x in _canon(rng, 8, 5, 8, 64)]
    calls = []
    orig = tmerge.overlay_scatter
    tmerge.overlay_scatter = lambda i, j: calls.append(1) or orig(i, j)
    try:
        small = tmerge.merge_read(base, *d, "sum", nrows=8, ncols=8)
        assert calls == [1]
        big = tmerge.merge_read(base, *d, "sum", nrows=2 ** 16, ncols=2 ** 15)
        assert calls == [1]
    finally:
        tmerge.overlay_scatter = orig
    for x, y in zip(small, big):
        assert torch.equal(x, y)


def test_delta_canon_matches_jax():
    import jax.numpy as jnp
    from repro.ingest.merge import delta_canon as j_delta_canon
    rng = np.random.default_rng(5)
    r = rng.integers(0, 6, 24).astype(np.int32)
    c = rng.integers(0, 6, 24).astype(np.int32)
    v = rng.integers(1, 9, 24).astype(np.float32)
    for agg in ("sum", "min", "max"):
        got = tmerge.delta_canon(*[torch.from_numpy(x) for x in (r, c, v)],
                                 agg)
        want = j_delta_canon(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
                             agg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the ingest slice of the main path, small --------------------------------------

N_INGEST = 8       # 2048 triples per array over ~256 x 256 keys


def test_ingest_slice_matches_jax_and_host():
    """``main_path.drive_ingest`` at a small n: every snapshot equals the
    one-shot host oracle (``check_ingest``), and for ``sum`` the JAX
    IngestTable driven through the same steps, field by field (the other
    aggregates meet the JAX table in the registry-wide parity test)."""
    built = main_path.build_ingest(N_INGEST, "cpu")
    res = main_path.drive_ingest(built)
    rows, cols, rows2, cols2, vals = built["raw"]
    size, batches = res["batch"], res["batches"]
    for agg in ("sum",):
        r = res["per_aggregate"][agg]
        jt = JI.IngestTable(J.AssocTensor.from_triples(rows, cols, vals,
                                                       aggregate=agg),
                            aggregate=agg)
        for k in range(batches):
            part = slice(k * size, (k + 1) * size)
            jt.insert(rows2[part], cols2[part], vals[part])
            if k + 1 == batches // 2:
                assert_same_tensor(r["snap_half"], jt.snapshot(),
                                   floats=False)
        assert_same_tensor(r["snap_full"], jt.snapshot(), floats=False)
        sel = J.Range(r["selector"].lo, r["selector"].hi)
        assert_same_tensor(r["select"], jt.snapshot()[sel, :], floats=False)
        assert jt.compact()["compacted"] == r["compact"]["compacted"]
        jt.insert(rows[:size], cols[:size], vals[:size])
        assert_same_tensor(r["snap_after"], jt.snapshot(), floats=False)
        assert r["stats"]["merges"] == jt.stats["merges"] == 3
    for name, ok, detail in main_path.check_ingest(built["raw"], res):
        assert ok, (name, detail)
    assert all(v == 0 for v in LAUNCHES.values())   # CPU: plain versions


def test_ingest_fallback_slice_matches_host(monkeypatch):
    """The concat fallback of the main path (forced at a small size by
    lowering the int32 limit) against its host check."""
    c = main_path.build_clustered(9, "cpu")
    monkeypatch.setattr(tmerge, "_LINEAR_LIMIT", 0)
    res = main_path.drive_ingest_fallback(c["A"], c["raw"], 1000)
    assert res["stats"]["merges"] == 1
    for name, ok, detail in main_path.check_ingest_fallback(c["raw"], res):
        assert ok, (name, detail)
    ha = T.Assoc(*c["raw"][:2], 1.0)
    want = ha.combine(T.Assoc(c["raw"][2][:1000], c["raw"][3][:1000], 1.0,
                              aggregate="sum"), "sum")
    assert res["snapshot"].to_assoc() == want


def test_device_merge_stage_spans():
    """Under ``spgemm.stage_timing()`` a device snapshot records its host
    keyspace work, the upload and the merge; the spans change nothing."""
    from repro_torch.core import spgemm
    t = IngestTable(T.AssocTensor.from_triples(*_BASE, aggregate="sum",
                                               device="cpu"),
                    aggregate="sum")
    t.insert(*_DELTA)
    with spgemm.stage_timing() as ms:
        got = t.snapshot()
    assert set(ms) == {"delta_keys", "upload", "merge"}
    assert got.to_assoc() == T.Assoc(_BASE[0] + _DELTA[0],
                                     _BASE[1] + _DELTA[1],
                                     _BASE[2] + _DELTA[2], aggregate="sum")
