"""The port's query server (``repro_torch.serve``) on the CPU
(``device="cpu"``): the tests of ``tests/test_serve.py`` and the serve and
ingest tests of ``tests/test_ingest.py`` on the port's tables, then the
two packages side by side — the port ``Engine`` and the JAX ``Engine`` on
the same specs and payloads return equal result bodies (keys and counts
exact; values within ``rtol=1e-5``: float32 sums in another order),
``serve_execute`` carries JAX's ``@contract`` fields, and the serve slice
of the main path at a small size equals the host ``Assoc``."""
import dataclasses
import threading
import time

import numpy as np
import pytest

from repro_torch.core import (CACHE_STATS, PLAN_STATS, Assoc, AssocTensor,
                              Keys, StartsWith, compile_selector,
                              reset_all_stats)
from repro_torch.ingest import Compactor, IngestTable
from repro_torch.serve import (D4MClient, Engine, ServerError, TableRef,
                               TableRegistry, WireError, ingest_from_wire,
                               ingest_to_wire, start_server, to_wire)
from repro_torch.serve.registry import generate_triples, load_triples_file

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats, cpu_mesh  # noqa: F401

RTOL = 1e-5

SPECS = [
    {"name": "edges", "generator": "random", "n": 64, "nnz": 512,
     "seed": 0, "layer": "device"},
    {"name": "feat", "generator": "random", "n": 64, "nnz": 512,
     "seed": 1, "layer": "device"},
    {"name": "hostt", "generator": "random", "n": 32, "nnz": 128,
     "seed": 2, "layer": "host"},
]


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def registry():
    return TableRegistry.from_specs(SPECS, device="cpu")


@pytest.fixture()
def engine(registry):
    with Engine(registry, workers=2, max_batch=4) as eng:
        yield eng


def _pipeline_payload(prefix="r0"):
    A, B = TableRef("edges"), TableRef("feat")
    return to_wire((A[StartsWith(prefix), :] @ B).sum(axis=1))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_load_triples_file(tmp_path):
    p = tmp_path / "t.tsv"
    p.write_text("# comment\nr0\tc0\t1.5\nr1\tc1\t2.5\n\nr0\tc1\t3.0\n")
    rows, cols, vals = load_triples_file(str(p))
    assert list(rows) == ["r0", "r1", "r0"]
    assert vals.dtype.kind == "f" and vals[2] == 3.0
    q = tmp_path / "t.csv"
    q.write_text("a,b,blue\nc,d,red\n")
    _, _, v2 = load_triples_file(str(q))
    assert v2.dtype.kind == "U" and list(v2) == ["blue", "red"]
    bad = tmp_path / "bad.tsv"
    bad.write_text("only_one_field\n")
    with pytest.raises(ValueError, match="bad.tsv:1"):
        load_triples_file(str(bad))


def test_generate_triples_deterministic_and_equal_to_jax():
    from repro.serve.registry import generate_triples as jax_generate
    spec = {"generator": "random", "n": 32, "nnz": 64, "seed": 7}
    a, b = generate_triples(spec), generate_triples(spec)
    assert list(a[0]) == list(b[0]) and np.allclose(a[2], b[2])
    for x, y in zip(a, jax_generate(spec)):
        np.testing.assert_array_equal(x, y)


def test_registry_info_and_lookup(registry):
    assert len(registry) == 3 and "edges" in registry
    info = {i["name"]: i for i in registry.list_info()}
    assert info["edges"]["layer"] == "device"
    assert info["hostt"]["layer"] == "host"
    assert info["edges"]["nnz"] > 0
    with pytest.raises(WireError) as ei:
        registry.get("ghost")
    assert ei.value.code == "unknown_table"
    with pytest.raises(TypeError):
        registry.register("bad", object())


def test_registry_file_spec_roundtrip(tmp_path):
    p = tmp_path / "edges.tsv"
    p.write_text("r0\tc0\t1.0\nr1\tc1\t2.0\n")
    reg = TableRegistry.from_specs([{"name": "e", "path": str(p)}],
                                   device="cpu")
    assert isinstance(reg.get("e"), Assoc)
    assert reg.layer_of("e") == "host"


def test_registry_device_and_dist_tables_on_the_cpu():
    """Device tables go to the registry's device; a dist spec shards over
    the given mesh, ``/tables`` sums its ``nnz``; a registry takes the
    dist tables of one mesh only, and ``"cuda"`` raises without a card."""
    import torch
    specs = [dict(SPECS[0], name="d", layer="dist"), SPECS[1]]
    reg = TableRegistry.from_specs(specs, mesh=cpu_mesh(), device="cpu")
    assert reg.get("feat").rows.device.type == "cpu"
    assert reg.dist_mesh() is cpu_mesh()
    info = {i["name"]: i for i in reg.list_info()}
    want = TableRegistry.from_specs([SPECS[0]], device="cpu").info("edges")
    assert info["d"]["nnz"] == want["nnz"] and info["d"]["shards"] == 1
    assert TableRegistry("cpu").dist_mesh() is None
    from repro_torch.core import make_mesh
    other = make_mesh("cpu")
    with pytest.raises(ValueError, match="one mesh"):
        reg.load(dict(SPECS[1], name="d2", layer="dist"), mesh=other)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TableRegistry()


# ---------------------------------------------------------------------------
# engine: execution, batching, plan-cache behaviour, errors
# ---------------------------------------------------------------------------

def test_engine_executes_and_repeats_hit_plan_cache(engine):
    payload = _pipeline_payload()
    out1 = engine.query(payload)
    assert out1["result"]["kind"] == "vector"
    h0, m0 = PLAN_STATS["plan_hits"], PLAN_STATS["plan_misses"]
    out2 = engine.query(payload)
    assert PLAN_STATS["plan_hits"] == h0 + 1
    assert PLAN_STATS["plan_misses"] == m0
    assert out1["result"]["vals"] == out2["result"]["vals"]
    assert out2["timing"]["exec_s"] >= 0


def test_engine_triples_and_scalar_results(engine):
    A = TableRef("edges")
    out = engine.query(to_wire(A[StartsWith("r0"), :]))
    assert out["result"]["kind"] == "triples"
    assert out["result"]["nnz"] == len(out["result"]["rows"])
    out = engine.query(to_wire(A.sum(axis=None)))
    assert out["result"]["kind"] == "scalar"
    assert out["result"]["val"] > 0


def test_engine_result_truncation(engine):
    A = TableRef("edges")
    out = engine.query(to_wire(A[:, :]), options={"limit": 3})
    assert out["result"]["truncated"] is True
    assert len(out["result"]["rows"]) == 3
    assert out["result"]["nnz"] > 3


def test_engine_malformed_rejected_synchronously(engine):
    with pytest.raises(WireError) as ei:
        engine.submit({"version": 1, "nodes": [{"op": "table",
                                                "name": "ghost"}],
                       "root": 0})
    assert ei.value.code == "unknown_table"


def test_engine_admission_key_groups_by_tables_and_layer(engine):
    k1 = engine._admission_key(_pipeline_payload("r0"))
    k2 = engine._admission_key(_pipeline_payload("r1"))
    assert k1 == k2
    k3 = engine._admission_key(to_wire(TableRef("hostt")[:, :]))
    assert k3 != k1
    assert k3[0] == "query"
    assert k3[2] == ("host",)


def test_engine_batches_compatible_requests(registry):
    with Engine(registry, workers=1, max_batch=8) as eng:
        reqs = [eng.submit(_pipeline_payload()) for _ in range(5)]
        for r in reqs:
            r.wait(timeout=120)
        st = eng.stats()
        assert st["server"]["requests"] == 5
        assert max(r.batch_size for r in reqs) > 1
        assert st["server"]["batch_mean"] > 1.0


def test_engine_stats_shape_and_reset(engine):
    engine.query(_pipeline_payload())
    st = engine.stats()
    assert {"server", "plan", "cache", "union", "dispatch",
            "queue_depth", "workers"} <= set(st)
    assert st["server"]["requests"] >= 1
    assert "p50_s" in st["server"] and "p99_s" in st["server"]
    engine.reset_stats()
    st2 = engine.stats()
    assert st2["server"].get("requests", 0.0) == 0.0
    assert st2["plan"]["plan_hits"] == 0


# ---------------------------------------------------------------------------
# HTTP server + client end-to-end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(registry):
    srv = start_server(registry, workers=2)
    yield srv
    srv.close()


@pytest.fixture()
def client(server):
    return D4MClient(server.url, timeout=120)


def test_http_health_and_tables(client):
    h = client.health()
    assert h["status"] == "ok" and h["tables"] == 3
    assert {t["name"] for t in client.tables()} == {"edges", "feat",
                                                   "hostt"}


def test_http_query_roundtrip(client):
    A, B = TableRef("edges"), TableRef("feat")
    out = client.query((A[StartsWith("r0"), :] @ B).sum(axis=1))
    assert out["result"]["kind"] == "vector"
    assert out["batch"] >= 1


def test_http_stats_exposes_core_counters(client):
    client.reset_stats()
    expr = (TableRef("edges")[StartsWith("r0"), :]
            @ TableRef("feat")).sum(axis=1)
    client.query(expr)
    client.query(expr)
    st = client.stats()
    assert st["plan"]["plan_hits"] >= 1
    assert st["server"]["requests"] == 2.0


def test_http_malformed_is_400_not_500(client):
    with pytest.raises(ServerError) as ei:
        client.query({"version": 1, "nodes": [{"op": "table",
                                               "name": "ghost"}],
                      "root": 0})
    assert ei.value.status == 400 and ei.value.code == "unknown_table"
    with pytest.raises(ServerError) as ei:
        client.query({"version": 77, "nodes": [], "root": 0})
    assert ei.value.status == 400 and ei.value.code == "bad_version"
    with pytest.raises(ServerError) as ei:
        client._request("/query", {"not_expr": 1})
    assert ei.value.status == 400 and ei.value.code == "bad_payload"


def test_http_execution_error_is_422(client):
    with pytest.raises(ServerError) as ei:
        client.query(TableRef("edges") @ TableRef("hostt"))
    assert ei.value.status in (422, 504)
    assert ei.value.code == "execution_error"


def test_http_404(client):
    with pytest.raises(ServerError) as ei:
        client._request("/nope")
    assert ei.value.status == 404


def test_concurrent_hot_mix_plan_hits_exceed_misses(server):
    client = D4MClient(server.url, timeout=120)
    client.reset_stats()
    payload = _pipeline_payload()
    client.query(payload)
    errs = []

    def worker():
        c = D4MClient(server.url, timeout=120)
        try:
            for _ in range(5):
                assert c.query(payload)["result"]["kind"] == "vector"
        except Exception as exc:         # pragma: no cover
            errs.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs
    st = client.stats()
    assert st["server"]["requests"] == 21.0
    assert st["plan"]["plan_hits"] > st["plan"]["plan_misses"]


def test_multithreaded_cache_hammer(registry):
    """Many threads pounding collect() + compile_selector concurrently:
    the locked caches and counters lose nothing."""
    import sys
    from repro_torch.serve.wire import from_wire
    reset_all_stats()
    edges = registry.get("edges")
    keys = edges.row_space.keys
    n_threads, n_iter = 8, 30
    errs = []
    barrier = threading.Barrier(n_threads)
    payload = _pipeline_payload()

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            barrier.wait(timeout=30)
            for i in range(n_iter):
                lo = int(rng.integers(0, len(keys) - 8))
                compile_selector(Keys(list(keys[lo:lo + 4])),
                                 edges.row_space)
                if i % 3 == 0:
                    from_wire(payload, resolve=registry.resolve).collect()
        except Exception as exc:
            errs.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errs, errs
    assert (CACHE_STATS["hits"] + CACHE_STATS["misses"]
            >= n_threads * n_iter)
    assert PLAN_STATS["plan_hits"] > 0


# ---------------------------------------------------------------------------
# ingest through the server (tests/test_ingest.py:185-380)
# ---------------------------------------------------------------------------

_BASE = (["b", "d", "f", "h"], ["x", "y", "x", "z"], [2.0, 3.0, 4.0, 5.0])


def _device_base():
    return AssocTensor.from_triples(*_BASE, aggregate="sum", device="cpu")


def test_compaction_invalidates_plan_cache_through_the_registry():
    from repro_torch.serve.wire import from_wire
    reg = TableRegistry("cpu")
    reg.register("t", IngestTable(_device_base(), aggregate="sum"))
    payload = to_wire(TableRef("t").sum(axis=None))

    def run():
        return float(from_wire(payload, resolve=reg.resolve).collect())

    v0 = run()
    assert run() == v0
    inv0 = PLAN_STATS["plan_invalidations"]
    tab = reg.ingest_table("t")
    tab.insert(["a"], ["w"], [100.0])
    assert run() == pytest.approx(v0 + 100.0)
    tab.compact()
    assert PLAN_STATS["plan_invalidations"] > inv0
    assert run() == pytest.approx(v0 + 100.0)


def test_registry_ingest_spec_and_resolution():
    reg = TableRegistry.from_specs([
        {"name": "mut", "generator": "random", "n": 16, "nnz": 32,
         "seed": 0, "layer": "device", "ingest": True,
         "compact_threshold": 99},
        {"name": "ro", "generator": "random", "n": 16, "nnz": 32,
         "seed": 1, "layer": "device"},
    ], device="cpu")
    assert reg.ingest_names() == ["mut"]
    assert reg.is_ingest("mut") and not reg.is_ingest("ro")
    assert reg.layer_of("mut") == "device"
    tab = reg.ingest_table("mut")
    assert tab.compact_threshold == 99 and tab.name == "mut"
    with pytest.raises(WireError) as ei:
        reg.ingest_table("ro")
    assert ei.value.code == "not_ingestable"
    assert reg.resolve("mut") is tab.base
    info = reg.info("mut")
    assert info["ingest"] is True and info["delta_depth"] == 0


def test_wire_ingest_roundtrip_and_validation():
    p = ingest_to_wire("edges", ["r1", "r2"], ["c1", "c2"], [1.0, 2.0])
    name, r, c, v = ingest_from_wire(p)
    assert name == "edges" and list(r) == ["r1", "r2"]
    assert v.dtype.kind == "f" and v[1] == 2.0

    def code_of(payload):
        with pytest.raises(WireError) as ei:
            ingest_from_wire(payload)
        return ei.value.code

    assert code_of([1, 2]) == "bad_payload"
    assert code_of({"version": 99, "ingest": {}}) == "bad_version"
    assert code_of({"version": 1, "ingest": []}) == "bad_payload"
    base = {"table": "t", "rows": ["a"], "cols": ["b"], "vals": [1.0]}
    assert code_of({"version": 1,
                    "ingest": {**base, "table": ""}}) == "bad_batch"
    assert code_of({"version": 1,
                    "ingest": {**base, "rows": []}}) == "bad_batch"
    assert code_of({"version": 1,
                    "ingest": {**base, "vals": [1.0, 2.0]}}) == "bad_batch"
    assert code_of({"version": 1,
                    "ingest": {**base, "rows": ["a", 3]}}) == "bad_batch"


def test_admission_keys_ingest_vs_query_disjoint():
    reg = TableRegistry("cpu")
    reg.register("mut", IngestTable(_device_base()))
    with Engine(reg, workers=1, compact_interval_s=0) as eng:
        qkey = eng._admission_key(to_wire(TableRef("mut")[:, :]))
        assert qkey[0] == "query"
        i1 = eng.submit_ingest(ingest_to_wire("mut", ["a"], ["b"], [1.0]))
        i2 = eng.submit_ingest(ingest_to_wire("mut", ["c"], ["d"], [2.0]))
        assert i1.batch_key == ("ingest", "mut") == i2.batch_key
        assert i1.batch_key != qkey
        i1.wait(30), i2.wait(30)


@pytest.fixture(scope="module")
def ingest_server():
    reg = TableRegistry("cpu")
    reg.register("mut", IngestTable(_device_base(), aggregate="sum",
                                    compact_threshold=10_000))
    reg.register("ro", Assoc(*_BASE, aggregate="sum"))
    srv = start_server(reg, workers=2)
    yield srv
    srv.close()


def test_http_ingest_endpoint(ingest_server):
    c = D4MClient(ingest_server.url, timeout=120)
    total0 = c.query(to_wire(TableRef("mut").sum(axis=None)))
    r = c.ingest("mut", ["new1", "b"], ["w", "x"], [6.0, 1.0])
    assert r["result"]["kind"] == "ingest"
    assert r["result"]["accepted"] == 2
    total1 = c.query(to_wire(TableRef("mut").sum(axis=None)))
    assert total1["result"]["val"] == pytest.approx(
        total0["result"]["val"] + 7.0)
    st = c.stats()
    assert "mut" in st["ingest"]
    assert st["ingest"]["mut"]["insert_triples"] >= 2
    assert st["server"]["ingests"] >= 1


def test_http_ingest_errors(ingest_server):
    c = D4MClient(ingest_server.url, timeout=120)
    with pytest.raises(ServerError) as ei:
        c.ingest("ro", ["a"], ["b"], [1.0])
    assert ei.value.status == 400 and ei.value.code == "not_ingestable"
    with pytest.raises(ServerError) as ei:
        c.ingest("ghost", ["a"], ["b"], [1.0])
    assert ei.value.status == 400 and ei.value.code == "unknown_table"
    with pytest.raises(ServerError) as ei:
        c.ingest("mut", ["a"], ["b"], [])
    assert ei.value.status == 400 and ei.value.code == "bad_batch"
    with pytest.raises(ServerError) as ei:
        c.ingest("mut", ["a"], ["b"], ["str_val"])
    assert ei.value.code == "execution_error"


def test_http_concurrent_ingest_query_hammer():
    """4 writers streaming disjoint keys into one table, 4 readers summing
    throughout: the final total is exact, partial sums plausible, and the
    background compactor ran."""
    reg = TableRegistry("cpu")
    reg.register("mut", IngestTable(
        AssocTensor.from_triples(["seed"], ["c"], [1.0], aggregate="sum",
                                 device="cpu"),
        aggregate="sum", compact_threshold=64))
    srv = start_server(reg, workers=4)
    try:
        url = srv.url
        n_writers, n_readers, n_batches, bsz = 4, 4, 6, 8
        errs, partials = [], []
        barrier = threading.Barrier(n_writers + n_readers)

        def writer(wid):
            c = D4MClient(url, timeout=120)
            try:
                barrier.wait(timeout=30)
                for b in range(n_batches):
                    rows = [f"w{wid}r{b}k{i}" for i in range(bsz)]
                    cols = [f"c{i % 3}" for i in range(bsz)]
                    out = c.ingest("mut", rows, cols, [1.0] * bsz)
                    assert out["result"]["accepted"] == bsz
            except Exception as exc:
                errs.append(exc)

        def reader():
            c = D4MClient(url, timeout=120)
            payload = to_wire(TableRef("mut").sum(axis=None))
            try:
                barrier.wait(timeout=30)
                for _ in range(8):
                    partials.append(c.query(payload)["result"]["val"])
            except Exception as exc:
                errs.append(exc)

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(n_writers)]
        threads += [threading.Thread(target=reader)
                    for _ in range(n_readers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert not errs, errs
        want = 1.0 + n_writers * n_batches * bsz
        c = D4MClient(url, timeout=120)
        final = c.query(to_wire(TableRef("mut").sum(axis=None)))
        assert final["result"]["val"] == pytest.approx(want)
        assert all(1.0 <= p <= want + 1e-6 for p in partials)
        deadline = time.time() + 10
        while time.time() < deadline:
            info = c.stats()["ingest"]["mut"]
            if info["compactions"] >= 1 and info["delta_depth"] == 0:
                break
            time.sleep(0.1)
        assert info["compactions"] >= 1
        assert c.query(to_wire(TableRef("mut").sum(axis=None)))[
            "result"]["val"] == pytest.approx(want)
    finally:
        srv.close()


def test_background_compactor_idle_trigger():
    reg = TableRegistry("cpu")
    reg.register("mut", IngestTable(_device_base(),
                                    compact_threshold=10_000))
    comp = Compactor(reg, interval_s=0.02, idle_s=0.05).start()
    try:
        reg.ingest_table("mut").insert(["a"], ["b"], [1.0])
        deadline = time.time() + 10
        while time.time() < deadline:
            if reg.ingest_table("mut").version == 1:
                break
            time.sleep(0.02)
        assert reg.ingest_table("mut").version == 1
        assert reg.ingest_table("mut").delta_depth == 0
    finally:
        comp.stop()


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def test_serve_execute_carries_the_jax_contract():
    from repro.analysis.contracts import CONTRACT_ATTR as J_ATTR
    from repro.serve.engine import serve_execute as j_execute
    from repro_torch.analysis import CONTRACT_ATTR, CONTRACT_REGISTRY
    from repro_torch.serve import serve_execute
    got = getattr(serve_execute, CONTRACT_ATTR)
    assert CONTRACT_ATTR == J_ATTR
    assert dataclasses.asdict(got) == dataclasses.asdict(
        getattr(j_execute, J_ATTR))
    assert CONTRACT_REGISTRY["serve.execute"] is got


def _cross_payloads():
    """Queries over the shared specs whose products are not empty (the
    generator's row keys are r.., its column keys c..), on both layers."""
    A, B, H = TableRef("edges"), TableRef("feat"), TableRef("hostt")
    out = [(A[StartsWith("r0"), :] @ B.T).sum(axis=1),
           A[StartsWith("r0"), :], A.sum(axis=None), A.sum(axis=0),
           A + B, A @ B.T, (A @ B.T).sum(axis=0), A.T @ B,
           H[StartsWith("r1"), :] @ H.T, (H @ H.T).sum(axis=1), H + H]
    for sr in ("max_plus", "min_plus", "max_min"):
        out += [A.matmul(B.T, semiring=sr).sum(axis=1, semiring=sr),
                H.matmul(H.T, semiring=sr)]
    return [to_wire(e) for e in out]


def _same_body(t, j):
    assert t.keys() == j.keys()
    for k in t:
        if k == "vals":
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL)
        elif k == "val":
            assert t[k] == pytest.approx(j[k], rel=RTOL)
        else:
            assert t[k] == j[k], k


def test_engine_bodies_equal_jax_engine():
    from repro.serve import Engine as JEngine
    from repro.serve import TableRegistry as JRegistry
    treg = TableRegistry.from_specs(SPECS, device="cpu")
    jreg = JRegistry.from_specs(SPECS)
    with Engine(treg, workers=2) as te, JEngine(jreg, workers=2) as je:
        for payload in _cross_payloads():
            t, j = te.query(payload), je.query(payload)
            _same_body(t["result"], j["result"])
        assert te.stats()["server"]["requests"] == \
            je.stats()["server"]["requests"]
        for name in treg.names():
            t, j = treg.info(name), jreg.info(name)
            assert t == j, name


def test_ingest_bodies_equal_jax_engine():
    """The same ingest batches and reads through both engines."""
    from repro.core import AssocTensor as JAssocTensor
    from repro.ingest import IngestTable as JIngestTable
    from repro.serve import Engine as JEngine
    from repro.serve import TableRegistry as JRegistry
    treg, jreg = TableRegistry("cpu"), JRegistry()
    treg.register("mut", IngestTable(_device_base(), aggregate="sum"))
    jreg.register("mut", JIngestTable(
        JAssocTensor.from_triples(*_BASE, aggregate="sum"),
        aggregate="sum"))
    rng = np.random.default_rng(3)
    with Engine(treg, workers=1, compact_interval_s=0) as te, \
            JEngine(jreg, workers=1, compact_interval_s=0) as je:
        for k in range(4):
            rows = [f"k{int(x)}" for x in rng.integers(0, 12, 16)]
            cols = [f"c{int(x)}" for x in rng.integers(0, 5, 16)]
            vals = [float(x) for x in rng.integers(1, 9, 16)]
            batch = ingest_to_wire("mut", rows, cols, vals)
            t, j = te.ingest(batch), je.ingest(batch)
            _same_body(t["result"], j["result"])
            for q in (TableRef("mut")[:, :], TableRef("mut").sum(axis=1)):
                _same_body(te.query(to_wire(q))["result"],
                           je.query(to_wire(q))["result"])
        assert treg.info("mut") == jreg.info("mut")


# ---------------------------------------------------------------------------
# SPMD mode at one rank, and the serve slice of the main path
# ---------------------------------------------------------------------------

def test_one_rank_spmd_mode_runs_serially_with_no_broadcast():
    """A registry with a dist table: one executor (whatever ``workers``
    says), every request in admission order, compaction as a request, no
    broadcast at one rank; ``follow()`` is for ranks > 0 only."""
    from repro_torch.core import DistAssoc
    from repro_torch.core.collectives import BROADCAST_STATS
    mesh = cpu_mesh()
    d = DistAssoc.from_triples(*_BASE, mesh, aggregate="sum", device="cpu")
    reg = TableRegistry("cpu")
    reg.register("d", IngestTable(d, aggregate="sum",
                                  compact_threshold=10_000))
    eng = Engine(reg, workers=4, compact_interval_s=0.02,
                 compact_idle_s=0.05)
    assert eng.workers == 1 and eng.mesh is mesh
    with pytest.raises(RuntimeError, match="ranks > 0"):
        eng.follow()
    srv = start_server(reg, workers=4)
    try:
        c = D4MClient(srv.url, timeout=120)
        assert srv.engine.workers == 1
        c.ingest("d", ["a", "b"], ["w", "x"], [1.0, 2.0])
        got = c.query(to_wire(TableRef("d")[:, :]))["result"]
        assert got["nnz"] == 5     # (b, x) collides with the base
        deadline = time.time() + 10
        while reg.ingest_table("d").version < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert reg.ingest_table("d").version == 1
        assert c.tables()[0]["nnz"] == 5
        assert c.stats()["server"]["requests"] == 2.0
    finally:
        srv.close()
    assert BROADCAST_STATS["broadcast"] == 0


def test_serve_main_path_small():
    """The serve slice of the main path at clustered n=9, uniform n=8 and
    ingest n=8 on the CPU: every served result identical to the in-process
    collect(), one per mix equal to the host, reads see their writes, the
    hot mix all plan-cache hits, the dist mix's collectives as the JAX
    contracts."""
    from repro_torch import main_path
    clus = main_path.build_clustered(9, "cpu")
    uni = main_path.build_uniform(8, "cpu")
    dist = main_path.build_dist(clus["raw"], cpu_mesh(), "cpu")
    ing = main_path.build_ingest(8, "cpu")
    reg = main_path.build_serve(clus, uni, dist, ing["bases"]["sum"], "cpu")
    drv = main_path.drive_serve(reg, main_path.row_range(clus["A"]),
                                ing["raw"])
    checks = main_path.check_serve(clus["raw"], uni["raw"], ing["raw"], drv)
    assert len(checks) >= 20
    for name, ok, detail in checks:
        assert ok, (name, detail)
    assert drv["broadcasts"] == 0
    assert {t["name"] for t in drv["tables"]} == {
        "edges", "feat", "U", "V", "dA", "dB", "ingest"}
