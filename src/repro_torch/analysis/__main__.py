"""``python -m repro_torch.analysis`` — check the port's declared performance
contracts (the JAX package's ``tools/d4mcheck``, for the port).

Sweeps every ``@contract``-decorated entry point: runs its programs over
seeded probe inputs, counted, and checks the declared invariants —
collective count, host reads, the largest intermediate (on the card also
the peak memory), cache stability — then runs the d4mlint AST pass over
``src/repro_torch``.  Prints one ``ok``/``FAIL`` line a contract (``skip``
for a contract none of whose programs this mesh can run, with the
reason) and exits 1 on any violation or lint finding.

Usage::

    python -m repro_torch.analysis                  # on the card
    python -m repro_torch.analysis --device cpu     # plain versions, CPU
    python -m repro_torch.analysis --device cpu --ranks 4   # 4 gloo ranks
    python -m repro_torch.analysis DistAssoc.matmul AssocTensor.__getitem__
    python -m repro_torch.analysis --no-lint        # contracts only
    python -m repro_torch.analysis --selftest       # the checker's teeth
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
# a rank that has not finished its sweep by then has hung on a collective
_RANK_TIMEOUT_S = 600


def _claim(c) -> str:
    claim = []
    if c.collectives is not None:
        claim.append(f"collectives={c.collectives}")
    if c.host_transfers is not None:
        claim.append(f"host_transfers={c.host_transfers}")
    claim.append("densify=ok" if c.densify else "densify=never")
    return ", ".join(claim)


def sweep(names, device, mesh=None) -> dict:
    """``{entry: {"violations": [str], "not_run": [[label, reason]],
    "programs": int}}`` of one rank's sweep."""
    from repro_torch.analysis import verify_all

    runs = {}

    def on_program(entry, label, thunk, result, report, reason):
        r = runs.setdefault(entry, {"not_run": [], "programs": 0})
        if reason is None:
            r["programs"] += 1
        else:
            r["not_run"].append([label, reason])

    results = verify_all(names or None, device=device, mesh=mesh,
                         on_program=on_program)
    return {name: {"violations": [str(v) for v in viols],
                   **runs.get(name, {"not_run": [], "programs": 0})}
            for name, viols in results.items()}


def _spawn_ranks(names, world: int) -> list:
    """The sweep on ``world`` gloo ranks of the CPU, one process each;
    every rank's result."""
    with tempfile.TemporaryDirectory(prefix="d4m_analysis_") as tmp:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        src = str(_PACKAGE.parent)
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
             "--no-lint", "--rank", str(r), "--world-size", str(world),
             "--store-path", os.path.join(tmp, "store"), "--json", outs[r],
             *names], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
        errors = []
        try:
            for r, p in enumerate(procs):
                _, err = p.communicate(timeout=_RANK_TIMEOUT_S)
                if not os.path.exists(outs[r]):
                    errors.append(f"rank {r} exited {p.returncode}:\n"
                                  f"{err[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if errors:
            raise RuntimeError("\n".join(errors))
        results = []
        for o in outs:
            with open(o) as f:
                results.append(json.load(f))
        return results


def report(per_rank: list) -> int:
    """Print the d4mcheck lines of every rank's sweep; the number of
    violations."""
    from repro_torch.analysis import CONTRACT_REGISTRY
    from repro_torch.analysis.contracts import _ensure_registry

    _ensure_registry()
    n_viol = held = 0
    world = len(per_rank)
    for name in sorted(per_rank[0]):
        viols = [(f"rank {r}: " if world > 1 else "") + v
                 for r, res in enumerate(per_rank)
                 for v in res[name]["violations"]]
        first = per_rank[0][name]
        not_run = {tuple(x) for res in per_rank for x in res[name]["not_run"]}
        claim = _claim(CONTRACT_REGISTRY[name])
        if viols:
            n_viol += len(viols)
            print(f"FAIL  {name}  ({claim})")
        elif first["programs"] == 0 and not_run:
            print(f"skip  {name}  ({claim})")
        else:
            held += 1
            print(f"ok    {name}  ({claim})")
        for v in viols:
            print(f"      {v}")
        for label, reason in sorted(not_run):
            print(f"      [{label}] not run: {reason}")
    print(f"contracts: {len(per_rank[0])} contract(s) on {world} rank(s), "
          f"{held} held, {n_viol} violation(s)")
    return n_viol


def run_lint() -> int:
    from repro_torch.analysis.lint import lint_paths

    findings = lint_paths([str(_PACKAGE)])
    for f in findings:
        print(f)
    print(f"d4mlint: {len(findings)} finding(s)")
    return len(findings)


def run_selftest(device) -> int:
    """The checker must still CATCH a broken program, each fault with its
    own kind — guards against the counters silently going blind."""
    import torch

    from repro_torch.analysis import Contract, analyze_call
    from repro_torch.analysis.probes import context
    from repro_torch.core.collectives import all_reduce

    ctx = context(device)
    x = torch.arange(64, dtype=torch.float32, device=ctx.device)
    r = torch.arange(64, device=ctx.device)

    def extra_collective(v):
        # a shard-local merge that smuggles in a cross-shard reduction
        return all_reduce(torch.sort(v).values.clone(), ctx.mesh)

    def loop_of_collectives(v):
        for _ in range(5):
            v = all_reduce(v.clone(), ctx.mesh)
        return v

    def densify(rows, cols, vals):
        return torch.zeros(4096, 4096, device=vals.device).index_put_(
            (rows, cols), vals)

    def host_read(v):
        return v * v.sum().item()

    canaries = [
        ("injected all_reduce", analyze_call(extra_collective, x),
         Contract(name="selftest.collective", collectives=0), "collectives"),
        ("loop of 5 all_reduces", analyze_call(loop_of_collectives, x),
         Contract(name="selftest.loop", collectives=1), "collectives"),
        ("densifying scatter", analyze_call(densify, r, r, x),
         Contract(name="selftest.densify"), "densify"),
        ("host read", analyze_call(host_read, x),
         Contract(name="selftest.host_read"), "host_transfers"),
    ]
    bad = 0
    for what, rep, c, kind in canaries:
        kinds = sorted({v.kind for v in c.check(rep)})
        if kinds != [kind]:
            print(f"SELFTEST FAIL: {what} caught as {kinds}, want [{kind!r}] "
                  f"({rep.summary()})")
            bad += 1
        else:
            print(f"selftest ok: {what} caught as {kind} ({rep.summary()})")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("names", nargs="*",
                    help="contract entries to check (default: all)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the d4mlint AST pass")
    ap.add_argument("--selftest", action="store_true",
                    help="verify the checker catches deliberately broken "
                         "programs, then exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the probes run (cuda raises without a card)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="run the sweep on this many gloo ranks of the CPU")
    # one rank of a --ranks run
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world-size", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store-path", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--json", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.selftest:
        return 1 if run_selftest(args.device) else 0
    if args.rank is not None:
        from repro_torch.core.mesh import make_mesh
        mesh = make_mesh(args.device, rank=args.rank,
                         world_size=args.world_size,
                         store_path=args.store_path)
        res = sweep(args.names, args.device, mesh)
        with open(args.json, "w") as f:
            json.dump(res, f)
        return 0
    if args.ranks > 1:
        if args.device != "cpu":
            ap.error("--ranks runs gloo ranks on the CPU: pass --device cpu")
        per_rank = _spawn_ranks(args.names, args.ranks)
    else:
        per_rank = [sweep(args.names, args.device)]
    bad = report(per_rank)
    if not args.no_lint and not args.names:
        bad += run_lint()
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
