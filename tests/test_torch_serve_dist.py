"""The query server over sharded tables (SPMD mode of
``repro_torch.serve.engine``) on gloo ranks on the CPU: at one rank in this
process and at four spawned ranks, rank 0 serving HTTP on loopback and
driving the requests through ``D4MClient``, ranks 1-3 following
(``Engine.follow``).

Every result is held against the host ``Assoc`` of the JAX package on
the same triples: a selection, ⊕, the lazy select → product under each
communication strategy (data chosen so that the cost model picks
replicate, all-to-all and 2-D at four ranks), the reductions, a small
triples result, the ``/tables`` ``nnz`` and ``POST /ingest`` followed by a
read of the written table.  Values are small integers, so every sum is
exact: the comparisons are exact.  Also: an execution error is a 422 and
the next query is still answered; one control broadcast per request at
four ranks and none at one; every rank reports the same ``version`` after
the compactor's compaction; every rank exits when rank 0 closes.  Each
spawned rank has a time limit, so a hang fails the test instead of the
suite."""
import json

import numpy as np
import pytest

from repro.core import Assoc as HostAssoc

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import (_reset_port_stats,  # noqa: F401
                            SpmdRun, cpu_mesh)

_SERVE = r'''
import json
import time
import numpy as np
from repro_torch.core import (PLAN_STATS, Assoc, DistAssoc, Keys, KeySpace,
                              Range)
from repro_torch.core.collectives import BROADCAST_STATS
from repro_torch.ingest import IngestTable
from repro_torch.serve import (D4MClient, Engine, ServerError, TableRef,
                               TableRegistry, start_server, to_wire)

STRATEGIES = ("replicate", "all_to_all", "2d")


def serve_data():
    rng = np.random.default_rng(7)

    def mk(n, nr, nc):
        return (rng.integers(0, nr, n).astype(str),
                rng.integers(0, nc, n).astype(str),
                rng.integers(1, 5, n).astype(np.float64))
    # A, B small: replicate; LA against a large B: all_to_all; UA, UB
    # uniform: 2d (at four ranks)
    d = {"a": mk(140, 37, 29), "b": mk(170, 29, 23), "la": mk(32, 16, 29),
         "lb": mk(20000, 1000, 50), "ua": mk(4000, 200, 64),
         "ub": mk(4000, 64, 300), "m": mk(60, 20, 10)}
    d["batch"] = mk(40, 30, 10)
    return d


def build(mesh):
    d = serve_data()
    reg = TableRegistry("cpu")
    for k in ("la", "lb", "ua", "ub"):
        reg.register(k.upper(), DistAssoc.from_triples(
            *d[k], mesh, aggregate="sum", device="cpu"))
    # A and B on their union keyspaces: element-wise operands align
    rs = KeySpace(np.concatenate([d["a"][0], d["b"][0]]))
    cs = KeySpace(np.concatenate([d["a"][1], d["b"][1]]))
    for k in ("a", "b"):
        reg.register(k.upper(), DistAssoc.from_triples(
            *d[k], mesh, aggregate="sum", row_space=rs, col_space=cs,
            device="cpu"))
    reg.register("M", IngestTable(
        DistAssoc.from_triples(*d["m"], mesh, aggregate="sum",
                               device="cpu"),
        aggregate="sum", compact_threshold=10_000))
    reg.register("H", Assoc(*d["a"], aggregate="sum"))
    return reg


def selector(keys):
    keys = np.unique(keys)
    return Range(keys[2], keys[-3])


def drive(url, reg):
    """Every request of the test through one client; the result bodies,
    the strategy each lazy product ran, and the keyspaces of the vector
    results."""
    d = serve_data()
    c = D4MClient(url, timeout=120)
    A, B = TableRef("A"), TableRef("B")
    out = {}

    def q(name, expr):
        before = {k: PLAN_STATS["dist_" + k] for k in STRATEGIES}
        out[name] = c.query(to_wire(expr))["result"]
        ran = [k for k in STRATEGIES if PLAN_STATS["dist_" + k] > before[k]]
        out[name + "__strategy"] = ran[0] if ran else ""

    q("select", A[selector(d["a"][0]), :])
    q("add", A + B)
    q("lazy_replicate", A[selector(d["a"][0]), :] @ B)
    q("lazy_all_to_all", TableRef("LA")[selector(d["la"][0]), :]
      @ TableRef("LB"))
    q("lazy_2d", TableRef("UA")[selector(d["ua"][0]), :] @ TableRef("UB"))
    q("lazy_sum", (A[selector(d["a"][0]), :] @ B).sum(axis=1))
    q("sum0", A.sum(axis=0))
    q("sum1", A.sum(axis=1))
    q("sum_all", A.sum(axis=None))
    q("small", A[Keys(list(np.unique(d["a"][0])[:3])), :])
    out["tables"] = c.tables()
    # an execution error on every rank, then the next query is answered
    try:
        c.query(to_wire(A + TableRef("H")))
        out["error"] = None
    except ServerError as exc:
        out["error"] = [exc.status, exc.code]
    q("after_error", A[selector(d["a"][0]), :])
    # ingest, read your writes, then the compactor's compaction
    r, cc, v = d["batch"]
    out["ingest"] = c.ingest("M", list(r), list(cc), list(v))["result"]
    q("read", TableRef("M")[:, :])
    deadline = time.time() + 60
    while (c.stats()["ingest"]["M"]["version"] < 1
           and time.time() < deadline):
        time.sleep(0.05)
    q("read_after_compact", TableRef("M")[:, :])
    st = c.stats()
    out["version"] = st["ingest"]["M"]["version"]
    out["compactions"] = st["ingest"]["M"]["compactions"]
    out["requests"] = st["server"]["requests"]
    out["errors"] = st["server"]["errors"]
    out["keys"] = {"A_rows": list(reg.get("A").local.row_space.keys),
                   "A_cols": list(reg.get("A").local.col_space.keys)}
    return out


def serve_rank(mesh):
    """This rank's part: rank 0 serves and drives, the others follow.
    Returns what the rank reports."""
    reg = build(mesh)
    mine = {"rank": mesh.rank}
    if mesh.rank == 0:
        srv = start_server(reg, workers=4)
        mine["executors"] = srv.engine.workers
        try:
            mine.update(drive(srv.url, reg))
        finally:
            srv.close()
    else:
        mine["followed"] = Engine(reg).follow()
    mine["broadcasts"] = BROADCAST_STATS["broadcast"]
    mine["final_version"] = reg.ingest_table("M").version
    return mine
'''

_FOUR = _SERVE + r'''
np.savez(OUT, out=np.asarray(json.dumps(serve_rank(mesh))))
'''


@pytest.fixture(scope="module", autouse=True)
def _four_started(tmp_path_factory):
    """The four ranks, started before the module's first test and stopped
    after its last; each has 240 s."""
    run = SpmdRun(None, _FOUR, tmp_path_factory.mktemp("serve4"),
                  timeout=240.0)
    yield run
    run.close()


def _ns():
    ns = {}
    exec(_SERVE, ns)
    return ns


@pytest.fixture(scope="module")
def one_rank():
    """The same program at one rank, in this process."""
    return [_ns()["serve_rank"](cpu_mesh())]


@pytest.fixture(scope="module")
def four(_four_started):
    return [json.loads(str(r["out"])) for r in _four_started.result()[1]]


@pytest.fixture(params=["one_rank", "four"], ids=["1rank", "4ranks"])
def ranks(request):
    return request.getfixturevalue(request.param)


@pytest.fixture(scope="module")
def host():
    d = _ns()["serve_data"]()
    return d, {k: HostAssoc(*d[k], aggregate="sum") for k in d}


def _key_triples(x):
    coo = x.adj.tocoo()
    order = np.lexsort((coo.col, coo.row))
    return (x.row[coo.row[order]].tolist(), x.col[coo.col[order]].tolist(),
            coo.data[order].astype(np.float64).tolist())


def _body_triples(body):
    assert body["kind"] == "triples" and not body["truncated"]
    order = np.lexsort((body["cols"], body["rows"]))
    return ([body["rows"][i] for i in order], [body["cols"][i] for i in order],
            [float(body["vals"][i]) for i in order])


def _sel(keys):
    from repro.core import Range
    keys = np.unique(keys)
    return Range(keys[2], keys[-3])


def _vec_on(keys, host_keys, vec):
    out = np.zeros(len(keys))
    out[np.searchsorted(np.asarray(keys), host_keys)] = np.asarray(vec)
    return out


def test_select_add_and_small_triples_equal_host(ranks, host):
    d, h = host
    r0 = ranks[0]
    a = h["a"]
    sel = _sel(d["a"][0])
    assert _body_triples(r0["select"]) == _key_triples(a[sel, :])
    assert _body_triples(r0["after_error"]) == _key_triples(a[sel, :])
    assert _body_triples(r0["add"]) == _key_triples(a + h["b"])
    from repro.core import Keys
    small = a[Keys(list(np.unique(d["a"][0])[:3])), :]
    assert _body_triples(r0["small"]) == _key_triples(small)
    assert r0["small"]["nnz"] == small.nnz() > 0


@pytest.mark.parametrize("strategy", ["replicate", "all_to_all", "2d"])
def test_lazy_select_product_under_each_strategy_equals_host(ranks, host,
                                                             strategy):
    d, h = host
    r0 = ranks[0]
    a, b = {"replicate": ("a", "b"), "all_to_all": ("la", "lb"),
            "2d": ("ua", "ub")}[strategy]
    want = h[a][_sel(d[a][0]), :] @ h[b]
    assert _body_triples(r0[f"lazy_{strategy}"]) == _key_triples(want)
    # at one rank the cost model always replicates
    ran = r0[f"lazy_{strategy}__strategy"]
    assert ran == (strategy if len(ranks) == 4 else "replicate")


def test_reductions_equal_host(ranks, host):
    d, h = host
    r0 = ranks[0]
    rows, cols = r0["keys"]["A_rows"], r0["keys"]["A_cols"]
    a = h["a"]
    part = a[_sel(d["a"][0]), :] @ h["b"]
    np.testing.assert_array_equal(
        r0["lazy_sum"]["vals"],
        _vec_on(rows, part.row, np.asarray(part.adj.sum(axis=1)).ravel()))
    np.testing.assert_array_equal(
        r0["sum1"]["vals"],
        _vec_on(rows, a.row, np.asarray(a.adj.sum(axis=1)).ravel()))
    np.testing.assert_array_equal(
        r0["sum0"]["vals"],
        _vec_on(cols, a.col, np.asarray(a.adj.sum(axis=0)).ravel()))
    assert r0["sum_all"] == {"kind": "scalar", "val": float(a.adj.sum())}


def test_tables_nnz_equals_host(ranks, host):
    _, h = host
    info = {t["name"]: t for t in ranks[0]["tables"]}
    for name, k in (("A", "a"), ("B", "b"), ("LB", "lb"), ("UA", "ua"),
                    ("M", "m")):
        assert info[name]["nnz"] == h[k].nnz(), name
        assert info[name]["shards"] == len(ranks)
    assert info["H"]["layer"] == "host"


def test_ingest_read_your_writes_equals_host(ranks, host):
    d, _ = host
    r0 = ranks[0]
    assert r0["ingest"]["accepted"] == len(d["batch"][0])
    want = HostAssoc(*(np.concatenate([d["m"][i], d["batch"][i]])
                       for i in range(3)), aggregate="sum")
    assert _body_triples(r0["read"]) == _key_triples(want)
    assert _body_triples(r0["read_after_compact"]) == _key_triples(want)


def test_execution_error_is_422_and_the_next_query_answers(ranks):
    r0 = ranks[0]
    assert r0["error"] == [422, "execution_error"]
    assert r0["errors"] == 1.0
    assert r0["after_error"]["nnz"] > 0


def test_one_executor_one_broadcast_per_request_and_same_version(ranks):
    """One executor on rank 0; at four ranks rank 0 sends each executed
    request (client requests, the /tables listing, the compaction) as
    one message plus the stop message, and each follower receives them
    all; at one rank no broadcast.  Every rank ends at the version the
    compaction gave."""
    r0 = ranks[0]
    assert r0["executors"] == 1
    assert r0["version"] == r0["compactions"] == 1
    executed = r0["requests"] + 1 + r0["compactions"]   # + the /tables
    if len(ranks) == 1:
        assert r0["broadcasts"] == 0
    else:
        assert r0["broadcasts"] == executed + 1
        for r in ranks[1:]:
            assert r["followed"] == executed
            assert r["broadcasts"] == executed + 1
    assert {r["final_version"] for r in ranks} == {1}
    assert [r["rank"] for r in ranks] == list(range(len(ranks)))
