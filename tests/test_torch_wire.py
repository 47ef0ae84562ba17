"""The port's wire format (``repro_torch.serve.wire``) against the JAX
package's (``repro.serve.wire``): the tests of ``tests/test_wire.py`` on
the port's classes, then the two packages on the same expressions — the
port's ``to_wire`` gives JSON equal to JAX's for every node type, selector
and semiring, and a payload of either decodes in the other and encodes
back to the same JSON.  Every comparison is exact (JSON text)."""
import json

import numpy as np
import pytest
from _hypothesis_compat import given, st

import repro.core as J
import repro.serve.wire as JW
import repro_torch.core as T
import repro_torch.serve.wire as TW
from repro_torch.core import (All, Keys, Mask, Match, Positions, Range,
                              REGISTRY, StartsWith, Where)
from repro_torch.serve.wire import (TableRef, WireError, WIRE_VERSION,
                                    from_wire, register_predicate,
                                    sel_from_wire, sel_to_wire, table_names,
                                    to_wire)

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import _reset_port_stats  # noqa: F401


def roundtrip_sel(sel):
    return sel_from_wire(sel_to_wire(sel))


def roundtrip(expr):
    return from_wire(to_wire(expr))


# ---------------------------------------------------------------------------
# Selector round trips — every selector kind in core/select.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sel", [
    All(),
    Keys(["r01", "r07", "r03"]),
    Keys(np.asarray([3.0, 1.0, 2.0])),
    Positions([0, 5, 2]),
    Positions(slice(2, 20, 3)),
    Range("a", "m"),
    Range("a", "m", inclusive=(True, False)),
    Range(None, "k"),
    Range(1.5, 9.0),
    StartsWith("r0"),
    StartsWith(["r0", "r1"]),
    Match(r"r0[0-4]$"),
    Mask([True, False, True, True]),
], ids=lambda s: type(s).__name__ + str(id(s) % 97))
def test_selector_roundtrip(sel):
    back = roundtrip_sel(sel)
    assert type(back) is type(sel)
    assert back.cache_key() == sel.cache_key()


def test_selector_compound_roundtrip():
    sel = (StartsWith("r0") & Match("r.[02468]")) | ~Keys(["r11"])
    back = roundtrip_sel(sel)
    assert back.cache_key() == sel.cache_key()


def test_selector_raw_forms_coerce():
    assert roundtrip_sel("r05").cache_key() == Keys(["r05"]).cache_key()
    assert isinstance(roundtrip_sel(slice(None)), All)
    got = roundtrip_sel([2, 4, 6])
    assert got.cache_key() == Positions([2, 4, 6]).cache_key()


def test_where_crosses_by_registered_name_only():
    fn = lambda v: v > 2.0              # noqa: E731
    with pytest.raises(WireError) as ei:
        sel_to_wire(Where(fn))
    assert ei.value.code == "unserializable_selector"

    register_predicate("torch_gt2", fn)
    back = roundtrip_sel(Where(fn))
    assert isinstance(back, Where)
    assert back.fn is fn

    with pytest.raises(WireError) as ei:
        sel_from_wire({"sel": "where", "name": "no_such_predicate"})
    assert ei.value.code == "unknown_predicate"


# ---------------------------------------------------------------------------
# Expression round trips — every node type × every registered semiring
# ---------------------------------------------------------------------------

def test_expr_roundtrip_every_node_type():
    A, B = TableRef("edges"), TableRef("feat")
    expr = ((A[StartsWith("r0"), :] @ B).sum(axis=1))
    assert roundtrip(expr).key() == expr.key()
    expr2 = (A + B) * A.T
    assert roundtrip(expr2).key() == expr2.key()
    expr3 = A[Range("a", "m"), Keys(["c01"])].sum(axis=None)
    assert roundtrip(expr3).key() == expr3.key()


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_expr_roundtrip_every_semiring(name):
    A, B = TableRef("edges"), TableRef("feat")
    expr = A.matmul(B, semiring=name).sum(axis=0, semiring=name)
    assert roundtrip(expr).key() == expr.key()


def test_shared_subtree_serializes_once():
    A = TableRef("edges")
    sub = A[StartsWith("r0"), :]
    expr = sub @ sub
    payload = to_wire(expr)
    assert len([n for n in payload["nodes"] if n["op"] == "select"]) == 1
    back = roundtrip(expr)
    assert back.key() == expr.key()
    assert back.a is back.b


# -- property test: random expression graphs survive the full JSON trip ----

def _rand_selector(draw, ns):
    kind = draw(st.integers(0, 4))
    if kind == 0:
        return ns.All()
    if kind == 1:
        ks = draw(st.lists(st.integers(0, 63), min_size=1, max_size=6))
        return ns.Keys([f"r{k:02d}" for k in ks])
    if kind == 2:
        lo, hi = sorted(draw(st.lists(st.integers(0, 63), min_size=2,
                                      max_size=2)))
        return ns.Range(f"r{lo:02d}", f"r{hi:02d}")
    if kind == 3:
        return ns.StartsWith(f"r{draw(st.integers(0, 9))}")
    return ns.Positions(draw(st.lists(st.integers(0, 63), min_size=1,
                                      max_size=6)))


def _rand_expr(draw, depth, ns=T, ref=TableRef):
    if depth <= 0 or draw(st.booleans()):
        return ref(draw(st.sampled_from(["edges", "feat", "other"])))
    op = draw(st.integers(0, 5))
    sr = draw(st.sampled_from(sorted(REGISTRY)))
    sub = lambda: _rand_expr(draw, depth - 1, ns, ref)  # noqa: E731
    if op == 0:
        return sub()[_rand_selector(draw, ns), _rand_selector(draw, ns)]
    if op == 1:
        return sub().add(sub(), semiring=sr)
    if op == 2:
        return sub().mul(sub(), semiring=sr)
    if op == 3:
        return sub().matmul(sub(), semiring=sr)
    if op == 4:
        return sub().sum(axis=draw(st.sampled_from([None, 0, 1])),
                         semiring=sr)
    return sub().T


@given(data=st.data())
def test_random_graph_json_roundtrip(data):
    expr = _rand_expr(data.draw, depth=4)
    back = from_wire(json.loads(json.dumps(to_wire(expr))))
    assert back.key() == expr.key()


def test_table_names_admission_key():
    A, B = TableRef("edges"), TableRef("feat")
    assert table_names(to_wire((A @ B) + A)) == ("edges", "feat")


# ---------------------------------------------------------------------------
# Malformed payloads: structured WireError codes, not arbitrary crashes
# ---------------------------------------------------------------------------

def _payload(nodes, root=None):
    return {"version": WIRE_VERSION, "nodes": nodes,
            "root": len(nodes) - 1 if root is None else root}


def _code(payload, resolve=None):
    with pytest.raises(WireError) as ei:
        from_wire(payload, resolve=resolve)
    return ei.value.code


def test_reject_bad_version():
    assert _code({"version": 99, "nodes": [], "root": 0}) == "bad_version"
    assert _code({"nodes": [{"op": "table", "name": "t"}],
                  "root": 0}) == "bad_version"


def test_reject_unknown_semiring():
    p = _payload([{"op": "table", "name": "t"},
                  {"op": "matmul", "a": 0, "b": 0,
                   "semiring": "frobnicate"}])
    assert _code(p) == "unknown_semiring"


def test_reject_unknown_op():
    assert _code(_payload([{"op": "quantum_join"}])) == "unknown_op"


def test_reject_cyclic_refs():
    p = _payload([{"op": "table", "name": "t"},
                  {"op": "transpose", "child": 1}])
    assert _code(p) == "cycle"
    p = _payload([{"op": "transpose", "child": 1},
                  {"op": "table", "name": "t"}], root=0)
    assert _code(p) == "cycle"


def test_reject_structural_garbage():
    assert _code("not a dict") == "bad_payload"
    assert _code({"version": WIRE_VERSION, "nodes": [],
                  "root": 0}) == "bad_payload"
    assert _code(_payload([{"no_op": True}])) == "bad_payload"
    assert _code(_payload([{"op": "table", "name": ""}])) == "bad_payload"
    assert _code(_payload([{"op": "table", "name": "t"}],
                          root=7)) == "bad_payload"
    assert _code(_payload([{"op": "table", "name": "t"},
                           {"op": "select", "child": 0,
                            "row": {"sel": "martian"},
                            "col": {"sel": "all"}}])) == "bad_selector"
    assert _code(_payload([{"op": "table", "name": "t"},
                           {"op": "reduce", "child": 0,
                            "axis": 7}])) == "bad_payload"


def test_reject_unknown_table_via_resolver():
    from repro_torch.serve.registry import TableRegistry
    reg = TableRegistry("cpu")
    p = _payload([{"op": "table", "name": "ghost"}])
    assert _code(p, resolve=reg.resolve) == "unknown_table"


def test_source_without_name_mapping_rejected():
    a = T.Assoc(["r0"], ["c0"], [1.0])
    with pytest.raises(WireError) as ei:
        to_wire(T.lazy(a))
    assert ei.value.code == "unknown_table"
    payload = to_wire(T.lazy(a), names={id(a): "mytab"})
    assert table_names(payload) == ("mytab",)


# ---------------------------------------------------------------------------
# The two packages on the same expressions: equal JSON both ways
# ---------------------------------------------------------------------------

def _selectors(ns):
    """Every selector kind, built in package ``ns``."""
    return [ns.All(), ns.Keys(["r01", "r07", "r03"]),
            ns.Keys(np.asarray([3.0, 1.0, 2.0])), ns.Positions([0, 5, 2]),
            ns.Positions(slice(2, 20, 3)),
            ns.Range("a", "m", inclusive=(True, False)), ns.Range(None, "k"),
            ns.Range(1.5, 9.0), ns.StartsWith(["r0", "r1"]),
            ns.Match(r"r0[0-4]$"), ns.Mask([True, False, True, True]),
            (ns.StartsWith("r0") & ns.Match("r.[02468]"))
            | ~ns.Keys(["r11"])]


def _exprs(ns, ref):
    """Every node type under every registered semiring, in package ``ns``
    over its ``TableRef``."""
    A, B = ref("edges"), ref("feat")
    out = [(A[ns.StartsWith("r0"), :] @ B).sum(axis=1), (A + B) * A.T,
           A[ns.Range("a", "m"), ns.Keys(["c01"])].sum(axis=None),
           A[ns.StartsWith("r0"), :] @ A[ns.StartsWith("r0"), :]]
    for name in sorted(ns.REGISTRY):
        out += [A.matmul(B, semiring=name).sum(axis=0, semiring=name),
                A.add(B.T, semiring=name).mul(A, semiring=name),
                A.sum(axis=1, semiring=name)]
    out += [A[s, :] for s in _selectors(ns)]
    return out


def _text(payload) -> str:
    return json.dumps(payload, sort_keys=True)


def test_port_to_wire_equals_jax_every_node_selector_and_semiring():
    assert sorted(T.REGISTRY) == sorted(J.REGISTRY)
    assert TW.WIRE_VERSION == JW.WIRE_VERSION
    port = _exprs(T, TW.TableRef)
    jax_ = _exprs(J, JW.TableRef)
    assert len(port) == len(jax_)
    for t, j in zip(port, jax_):
        assert _text(TW.to_wire(t)) == _text(JW.to_wire(j))
    for t, j in zip(_selectors(T), _selectors(J)):
        assert _text(TW.sel_to_wire(t)) == _text(JW.sel_to_wire(j))


def test_payloads_cross_between_the_packages():
    """A JAX payload decodes in the port and encodes back to the same
    JSON, and the other way round; the ingest payload too."""
    for j in _exprs(J, JW.TableRef):
        payload = json.loads(json.dumps(JW.to_wire(j)))
        assert _text(TW.to_wire(TW.from_wire(payload))) == _text(payload)
    for t in _exprs(T, TW.TableRef):
        payload = json.loads(json.dumps(TW.to_wire(t)))
        assert _text(JW.to_wire(JW.from_wire(payload))) == _text(payload)
    args = ("edges", ["r1", "r2"], ["c1", "c2"], [1.0, 2.5])
    assert _text(TW.ingest_to_wire(*args)) == _text(JW.ingest_to_wire(*args))
    for a, b in zip(TW.ingest_from_wire(JW.ingest_to_wire(*args)),
                    JW.ingest_from_wire(JW.ingest_to_wire(*args))):
        np.testing.assert_array_equal(a, b)


def test_where_crosses_both_packages_by_name():
    """A ``Where`` crosses by its registered name: the same name resolves
    to each side's own predicate."""
    fn_t, fn_j = (lambda v: v > 1.0), (lambda v: v > 1.0)
    TW.register_predicate("cross_gt1", fn_t)
    JW.register_predicate("cross_gt1", fn_j)
    payload = JW.sel_to_wire(J.Where(fn_j))
    assert payload == TW.sel_to_wire(T.Where(fn_t))
    assert TW.sel_from_wire(payload).fn is fn_t


@given(data=st.data())
def test_random_graph_equal_json_across_packages(data):
    """Random graphs built in the port: JAX decodes them and re-encodes the
    same JSON text."""
    expr = _rand_expr(data.draw, depth=4)
    payload = json.loads(json.dumps(TW.to_wire(expr)))
    assert _text(JW.to_wire(JW.from_wire(payload))) == _text(payload)
