"""d4mlint on the port — the host-side AST anti-pattern rules (D4M101…
D4M104) over the port's shard programs (``tests/test_lint.py`` on the
port)."""
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.lint import lint_file, lint_paths

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _lint(src, path="mod.py"):
    return lint_file(path, text=textwrap.dedent(src))


def _rules(findings):
    return sorted({f.rule for f in findings})


def test_numpy_in_prog_body_is_d4m101():
    f = _lint("""
        import numpy as np
        import torch

        def _select_prog(loc, keep):
            return torch.from_numpy(np.asarray(keep.numpy()))
    """)
    assert _rules(f) == ["D4M101"]
    assert len(f) == 2           # the np call and the .numpy()


def test_numpy_at_module_scope_is_fine():
    f = _lint("""
        import numpy as np
        TABLE = np.arange(16)

        def host_helper(x):
            return np.asarray(x.cpu().numpy()).tolist()
    """)
    assert f == []


@pytest.mark.parametrize("call", [
    "x.item()", "x.tolist()", "x.cpu()", 'x.to("cpu")',
    'x.to(device="cpu")', "torch.cuda.synchronize()", "int(x.sum())",
    "float(x[0])", "bool(x.any())"])
def test_host_roundtrip_in_a_program_is_d4m102(call):
    # a program contract of dist_assoc.py / merge.py, not named *_prog
    f = _lint(f"""
        import torch
        from repro_torch.analysis.contracts import contract

        @contract(collectives=0, name="ingest.dist_merge_read")
        def dist_merge(x):
            y = {call}
            return x
    """)
    assert _rules(f) == ["D4M102"]


def test_entry_contracts_are_not_programs():
    # entry points (no dist./ingest. name) do the host planning: no scope
    f = _lint("""
        from repro_torch.analysis.contracts import contract

        @contract(collectives=0)
        def col_reduce(self, x):
            return int(x.sum())
    """)
    assert f == []


def test_nnz_loop_in_prog_is_d4m103():
    f = _lint("""
        def _matmul_prog(x, nnz):
            acc = 0
            for i in range(nnz):
                acc = acc + x[i]
            return acc
    """)
    assert _rules(f) == ["D4M103"]


def test_nested_def_inherits_the_scope():
    f = _lint("""
        def _ewise_prog(x):
            def inner(y):
                import numpy as np
                return np.sqrt(y)
            return inner(x)
    """)
    assert _rules(f) == ["D4M101"]


def test_kernel_ops_missing_cuda_is_d4m104(tmp_path):
    d = tmp_path / "kernels" / "mykern"
    d.mkdir(parents=True)
    p = d / "ops.py"
    p.write_text('IMPLS = {"ref": 1, "auto": 2}\n')  # no "cuda"
    f = lint_file(str(p))
    assert _rules(f) == ["D4M104"]
    assert "cuda" in f[0].message
    p.write_text('IMPLS = {"ref": 1, "cuda": 2, "auto": 3}\n')
    assert lint_file(str(p)) == []
    # resolve_impl dispatches "auto" and "cuda"; "ref" stays required
    p.write_text('def f(impl, t):\n'
                 '    if cuda_lib.resolve_impl(impl, t) == "ref":\n'
                 '        return 1\n')
    assert lint_file(str(p)) == []
    p.write_text('def f(impl, t):\n'
                 '    return cuda_lib.resolve_impl(impl, t)\n')
    assert _rules(lint_file(str(p))) == ["D4M104"]


def test_non_kernel_ops_py_is_exempt(tmp_path):
    p = tmp_path / "ops.py"          # not under a kernels/ tree
    p.write_text("X = 1\n")
    assert lint_file(str(p)) == []


def test_file_level_disable_suppresses():
    f = _lint("""
        # d4mlint: disable=D4M101
        import numpy as np

        def _select_prog(x):
            return np.asarray(x)
    """)
    assert f == []


def test_line_level_ignore_suppresses_only_that_line():
    f = _lint("""
        import numpy as np

        def _select_prog(x):
            a = np.asarray(x)  # d4mlint: ignore[D4M101] host input
            return np.asarray(a)
    """)
    assert len(f) == 1 and f[0].rule == "D4M101"


def test_port_source_tree_is_clean():
    assert lint_paths([str(PORT)]) == []
