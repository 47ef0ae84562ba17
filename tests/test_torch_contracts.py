"""The port's contracts (``repro_torch.analysis``) against the JAX package's
(``tests/test_contracts.py`` on the port).

Three parts: (1) the registry — the port declares the JAX package's 24
``@contract``s, field for field; (2) the sweep — every program behind every
declared entry point holds its contract when run on the plain versions,
at one rank in this process and at four gloo ranks (one spawned group),
and its collectives by family equal the JAX report of the same probe
label; (3) the checker has teeth — an injected all_reduce, a loop of
all_reduces, a densifying scatter and a host read are each caught with
the right violation kind, and the honest declaration passes.

``test_parser_reads_both_header_dialects`` and
``test_partitioner_custom_calls_are_not_host_transfers`` have no
counterpart: they test the HLO parser, and the port has no HLO (its
checker runs the programs and counts their ops).
"""
import json

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.analysis as J
from repro.analysis import probes as jprobes
from repro.analysis.contracts import RetraceAudit as JRetraceAudit
from repro_torch.analysis import (CONTRACT_REGISTRY, Contract, RetraceAudit,
                                  Violation, analyze_call, verify_all,
                                  verify_entry)
from repro_torch.analysis import contracts as contracts_mod
from repro_torch.analysis import probes as probes_mod
from repro_torch.core import select as select_mod
from repro_torch.core.collectives import all_reduce

from _torch_helpers import _quick_jax_compiles  # noqa: F401
from _torch_helpers import (_reset_port_stats,  # noqa: F401
                            SpmdRun, cpu_mesh)

EXPECTED_ENTRIES = {
    "AssocTensor.__getitem__", "AssocTensor.__setitem__",
    "spgemm.matmul", "spgemm.matmul_reduce",
    "DistAssoc.__getitem__", "DistAssoc.__setitem__",
    "DistAssoc.add", "DistAssoc.mul", "DistAssoc.matmul",
    "DistAssoc.matmul_reduce", "DistAssoc.sqin", "DistAssoc.sqout",
    "DistAssoc.col_reduce", "DistAssoc.row_reduce", "DistAssoc.col_degree",
    "DistAssoc.matmul_dense_vec",
}
FIELDS = ("collectives", "host_transfers", "densify", "dense_budget")
# the 2-D probe: the JAX package's 2 x 4 grid over 8 shards, the port's
# 1 x 4 over four ranks (pc − 1 = 3 ring shifts both); one rank runs none
RING = {"ring-2x4": "ring-1x4"}


def _kinds(violations):
    return sorted({v.kind for v in violations})


def _families(report):
    return {k: float(v) for k, v in report.collective_counts.items() if v}


def _reports(device="cpu", mesh=None):
    """``{entry: {label: report, or the reason it did not run}}`` and the
    sweep's violations."""
    out = {}

    def on_program(entry, label, thunk, result, report, reason):
        out.setdefault(entry, {})[label] = reason if report is None \
            else report

    viols = verify_all(device=device, mesh=mesh, on_program=on_program)
    return out, viols


# ---------------------------------------------------------------------------
# the registry: the JAX package's declarations, field for field
# ---------------------------------------------------------------------------

def test_registry_equals_the_jax_registry():
    contracts_mod._ensure_registry()
    J.contracts._ensure_registry()
    assert set(CONTRACT_REGISTRY) == set(J.CONTRACT_REGISTRY)
    assert len(CONTRACT_REGISTRY) == 24
    for name, c in CONTRACT_REGISTRY.items():
        j = J.CONTRACT_REGISTRY[name]
        assert c.name == j.name == name
        for f in FIELDS:
            assert getattr(c, f) == getattr(j, f), (name, f)


def test_registry_covers_the_public_surface():
    contracts_mod._ensure_registry()
    assert EXPECTED_ENTRIES <= set(CONTRACT_REGISTRY), \
        EXPECTED_ENTRIES - set(CONTRACT_REGISTRY)
    # every registered contract has its probe
    assert set(CONTRACT_REGISTRY) == set(probes_mod.PROBES)


def test_shard_local_entries_declare_zero_collectives():
    contracts_mod._ensure_registry()
    for name in ("DistAssoc.__getitem__", "DistAssoc.__setitem__",
                 "DistAssoc.matmul", "AssocTensor.__getitem__"):
        assert CONTRACT_REGISTRY[name].collectives == 0, name
    # the fused reduce epilogues spend exactly ONE reduction
    for name in ("DistAssoc.matmul_reduce", "DistAssoc.sqin",
                 "DistAssoc.sqout", "DistAssoc.col_reduce"):
        assert CONTRACT_REGISTRY[name].collectives == 1, name


# ---------------------------------------------------------------------------
# the sweep: one rank here, four gloo ranks in one spawned group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    return _reports(mesh=cpu_mesh())


def test_sweep_all_contracts_hold(one_rank):
    reports, results = one_rank
    bad = {k: [str(v) for v in vs] for k, vs in results.items() if vs}
    assert not bad, bad
    # the sweep checked the full registry, not a subset
    assert set(results) == set(CONTRACT_REGISTRY) == set(reports)
    # one rank holds no pc = 4 grid: the 2-D program is reported not run,
    # with its reason, and nothing else is
    not_run = {(e, lb) for e, progs in reports.items()
               for lb, r in progs.items() if isinstance(r, str)}
    assert not_run == {("dist.matmul_2d", "ring")}
    assert "4 ranks" in reports["dist.matmul_2d"]["ring"]


_PORT_PROG = """
import json
from repro_torch.analysis import verify_all
programs = {}
def on_program(entry, label, thunk, result, report, reason):
    programs.setdefault(entry, {})[label] = (
        reason if report is None else
        {k: v for k, v in report.collective_counts.items() if v})
res = verify_all(device="cpu", mesh=mesh, on_program=on_program)
np.savez(OUT, sweep=np.array(json.dumps({
    "violations": {k: [str(v) for v in vs] for k, vs in res.items()},
    "programs": programs})))
"""


@pytest.fixture(scope="module", autouse=True)
def _four_started(tmp_path_factory):
    """The four ranks' sweep, started before the module's first test and
    stopped after its last."""
    run = SpmdRun(None, _PORT_PROG, tmp_path_factory.mktemp("contracts4"),
                  timeout=120.0)
    yield run
    run.close()


@pytest.fixture(scope="module")
def four(_four_started):
    _, ranks = _four_started.result()
    return [json.loads(str(r["sweep"])) for r in ranks]


def test_sweep_holds_on_four_ranks(four):
    """Every rank's reports satisfy every contract, the 2-D program
    included: three ring shifts on the 1 x 4 grid."""
    for r, sweep in enumerate(four):
        bad = {k: v for k, v in sweep["violations"].items() if v}
        assert not bad, (r, bad)
        assert set(sweep["violations"]) == set(CONTRACT_REGISTRY)
        assert sweep["programs"]["dist.matmul_2d"] == {
            "ring-1x4": {"collective-permute": 3.0}}, r


@pytest.fixture(scope="module")
def jax_reports():
    """``{entry: {label: ProgramReport}}`` of the JAX probes, lowered on the
    8-shard AbstractMesh in the form this jax takes."""
    from repro.analysis.hlo_contracts import analyze_program

    J.contracts._ensure_registry()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprobes, "_abstract_mesh",
                   lambda: AbstractMesh((8,), ("data",)))
        for name in sorted(J.CONTRACT_REGISTRY):
            out[name] = {label: analyze_program(hlo)
                         for item in jprobes.PROBES[name]()
                         if not isinstance(item, JRetraceAudit)
                         for label, hlo in [item]}
    return out


@pytest.mark.parametrize("name", sorted(EXPECTED_ENTRIES | {
    "dist.matmul_all_to_all", "dist.matmul_2d", "dist.matmul_bsr",
    "dist.matmul_reduce_all_to_all", "ingest.append", "ingest.merge_read",
    "ingest.dist_merge_read", "serve.execute"}))
def test_collectives_by_family_equal_the_jax_reports(name, one_rank, four,
                                                     jax_reports):
    """For every probe label, the port's collectives by family — at one
    rank and on every one of four — equal the JAX report's; both reports
    are within their own contract's budget."""
    reports, _ = one_rank
    jax = jax_reports[name]
    port = {lb: r for lb, r in reports[name].items()
            if not isinstance(r, str)}
    want = {RING.get(lb, lb): _families(r) for lb, r in jax.items()}
    assert set(port) == set(want) - set(RING.values()), (set(port), set(want))
    for label, rep in port.items():
        assert _families(rep) == want[label], label
        c = CONTRACT_REGISTRY[name]
        assert rep.max_intermediate_elems <= c.budget(rep), label
    for label, jrep in jax.items():
        jc = J.CONTRACT_REGISTRY[name]
        budget = (jc.dense_budget if jc.dense_budget is not None
                  else jrep.dense_budget_default())
        assert jrep.max_intermediate_elems <= budget, label
    for sweep in four:
        assert sweep["programs"][name] == want, name


# ---------------------------------------------------------------------------
# teeth: broken programs are caught with the right violation kind
# ---------------------------------------------------------------------------

def test_injected_all_reduce_is_caught():
    mesh = cpu_mesh()
    x = torch.arange(16, dtype=torch.float32)
    rep = analyze_call(lambda v: all_reduce(v.clone(), mesh), x)
    assert rep.collective_counts["all-reduce"] == 1
    viol = Contract(name="canary", collectives=0).check(rep)
    assert _kinds(viol) == ["collectives"]
    # the honest declaration passes
    assert Contract(name="ok", collectives=1).check(rep) == []


def test_loop_of_all_reduces_counts_each_pass():
    mesh = cpu_mesh()

    def body(v):
        for _ in range(5):
            v = v + all_reduce(v.clone(), mesh)
        return v

    rep = analyze_call(body, torch.ones(16))
    # a loop of N all_reduces is N collectives, not 1
    assert rep.collective_counts["all-reduce"] == 5
    viol = Contract(name="canary", collectives=1).check(rep)
    assert _kinds(viol) == ["collectives"]
    assert Contract(name="ok", collectives=5).check(rep) == []


def test_densifying_scatter_is_caught():
    def densify(rows, cols, vals):
        return torch.zeros(4096, 4096).index_put_((rows, cols), vals)

    idx = torch.arange(64)
    rep = analyze_call(densify, idx, idx, torch.ones(64))
    assert rep.max_intermediate_elems >= 4096 * 4096
    viol = Contract(name="canary", collectives=None).check(rep)
    assert _kinds(viol) == ["densify"]
    # densify=True waives the budget
    assert Contract(name="ok", collectives=None, densify=True).check(rep) == []


def test_host_read_is_caught():
    rep = analyze_call(lambda v: v * v.sum().item(), torch.ones(16))
    assert rep.host_transfers == 1
    viol = Contract(name="canary", collectives=None,
                    host_transfers=0).check(rep)
    assert _kinds(viol) == ["host_transfers"]
    assert Contract(name="ok", collectives=None,
                    host_transfers=1).check(rep) == []


# ---------------------------------------------------------------------------
# checker plumbing: probes, cache audits
# ---------------------------------------------------------------------------

def test_declared_but_unprobed_contract_is_a_violation(monkeypatch):
    monkeypatch.setitem(CONTRACT_REGISTRY, "synthetic.unprobed",
                        Contract(name="synthetic.unprobed", collectives=0))
    viol = verify_entry("synthetic.unprobed", device="cpu", mesh=cpu_mesh())
    assert _kinds(viol) == ["probe"]


def test_retrace_audit_flags_cache_growth(monkeypatch):
    monkeypatch.setitem(
        CONTRACT_REGISTRY, "synthetic.retrace",
        Contract(name="synthetic.retrace", collectives=None,
                 host_transfers=None))
    state = {"size": 0}

    def growing_probe(ctx):
        yield RetraceAudit(
            label="grows",
            first=lambda: state.__setitem__("size", 1),
            again=lambda: state.__setitem__("size", 2),
            size=lambda: state["size"])

    monkeypatch.setitem(probes_mod.PROBES, "synthetic.retrace",
                        growing_probe)
    viol = verify_entry("synthetic.retrace", device="cpu", mesh=cpu_mesh())
    assert _kinds(viol) == ["recompile"]

    def stable_probe(ctx):
        yield RetraceAudit(
            label="stable",
            first=lambda: state.__setitem__("size", 1),
            again=lambda: None,
            size=lambda: state["size"])

    monkeypatch.setitem(probes_mod.PROBES, "synthetic.retrace",
                        stable_probe)
    assert verify_entry("synthetic.retrace", device="cpu",
                        mesh=cpu_mesh()) == []


@pytest.mark.parametrize("name", ["AssocTensor.__getitem__",
                                  "DistAssoc.__getitem__"])
def test_selection_audit_catches_a_wrong_cache_key(name, monkeypatch):
    """The selection probes' audit watches the selector compile cache: a
    key that differs between two equal selections misses on the repeat,
    and the audit reports it."""
    monkeypatch.setattr(select_mod.Range, "cache_key",
                        lambda self: ("range", object()))
    viol = verify_entry(name, device="cpu", mesh=cpu_mesh())
    assert _kinds(viol) == ["recompile"]


def test_serve_audit_sees_the_plan_cache():
    """serve.execute's audit reads the plan cache: the repeat query hits."""
    from repro_torch.core.plan import PLAN_STATS
    assert verify_entry("serve.execute", device="cpu", mesh=cpu_mesh()) == []
    assert PLAN_STATS["plan_hits"] >= 1


def test_violation_str_is_actionable():
    v = Violation(entry="X.y[range]", kind="collectives", message="boom")
    assert "X.y[range]" in str(v) and "collectives" in str(v)


def test_setitem_probe_writes_the_selection():
    """The ``__setitem__`` probes run the entry point's own assignment: the
    selected stored entries take the value, the rest keep theirs."""
    t = probes_mod._device_tensor(probes_mod.context("cpu", cpu_mesh()))
    sel = probes_mod._selector_kinds()[0][1]
    got = probes_mod._assign(t, sel, 0.0)
    keep = t._selection_keep(sel)
    assert bool(keep.any()) and not bool(keep.all())
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(keep.numpy(), 0.0, t.vals.numpy()))


def test_command_line_sweep_and_selftest(capsys):
    """``python -m repro_torch.analysis``'s lines: ``ok`` for a held
    contract, ``skip`` with the reason for the 2-D program on one rank;
    ``--selftest`` catches each injected fault with its own kind."""
    from repro_torch.analysis.__main__ import main

    assert main(["--device", "cpu", "DistAssoc.add", "dist.matmul_2d"]) == 0
    out = capsys.readouterr().out
    assert "ok    DistAssoc.add  (collectives=0" in out
    assert "skip  dist.matmul_2d  (collectives=3" in out
    assert "[ring] not run: " in out and "1 held, 0 violation(s)" in out
    assert main(["--device", "cpu", "--selftest"]) == 0
    out = capsys.readouterr().out
    for kind in ("collectives", "collectives", "densify", "host_transfers"):
        assert f"caught as {kind}" in out
    assert "SELFTEST FAIL" not in out
