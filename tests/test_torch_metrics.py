"""The port's ``MetricsStore`` (``repro_torch.distributed.metrics``): the
tests of ``tests/test_metrics.py`` on the port, then the port's tables
against the JAX package's for the same log sequences, exactly (the
values are sums of small binary fractions)."""
import threading

import numpy as np
import pytest

from repro.distributed.metrics import MetricsStore as JaxMetricsStore
from repro_torch.distributed import MetricsStore

from _torch_helpers import _reset_port_stats  # noqa: F401


def test_log_and_series():
    ms = MetricsStore("last")
    ms.log(0, {"loss": 4.0, "lr": 0.1})
    ms.log(1, {"loss": 3.5, "lr": 0.1})
    steps, losses = ms.series("loss")
    np.testing.assert_array_equal(steps, [0.0, 1.0])
    np.testing.assert_array_equal(losses, [4.0, 3.5])


def test_merge_idempotent_under_retry():
    a = MetricsStore("max")
    a.log(5, {"tokens": 100.0})
    b = MetricsStore("max")
    b.log(5, {"tokens": 100.0})
    merged = a.merge(b)
    _, v = merged.series("tokens")
    np.testing.assert_array_equal(v, [100.0])
    _, v2 = merged.merge(b).series("tokens")
    np.testing.assert_array_equal(v2, [100.0])


def test_cross_host_sum_merge():
    h0, h1 = MetricsStore("sum"), MetricsStore("sum")
    h0.log(1, {"examples": 8.0})
    h1.log(1, {"examples": 8.0})
    _, v = h0.merge(h1).series("examples")
    np.testing.assert_array_equal(v, [16.0])


def test_serialization_roundtrip():
    ms = MetricsStore("last")
    ms.log(2, {"loss": 1.5})
    _, v = MetricsStore.from_dict(ms.to_dict()).series("loss")
    np.testing.assert_array_equal(v, [1.5])


def test_log_is_buffered_one_combine_per_flush():
    ms = MetricsStore("sum")
    for step in range(50):
        ms.log(step, {"loss": 1.0, "tok": 2.0})
    assert ms.combine_calls == 0
    table = ms.table
    assert ms.combine_calls == 0
    assert table.nnz() == 100
    for step in range(50, 100):
        ms.log(step, {"loss": 1.0})
    assert ms.table.nnz() == 150
    assert ms.combine_calls == 1
    ms.flush()
    assert ms.combine_calls == 1


def test_buffered_semantics_match_sequential():
    for agg, expect in [("last", 3.0), ("sum", 6.0), ("max", 3.0),
                        ("min", 1.0)]:
        ms = MetricsStore(agg)
        for v in (1.0, 2.0, 3.0):
            ms.log(0, {"m": v})
        _, v = ms.series("m")
        np.testing.assert_array_equal(v, [expect], err_msg=agg)
        ms.flush()
        ms.log(0, {"m": 2.0})
        _, v = ms.series("m")
        expect2 = {"last": 2.0, "sum": 8.0, "max": 3.0, "min": 1.0}[agg]
        np.testing.assert_array_equal(v, [expect2], err_msg=agg)


def test_concurrent_logging_threads():
    ms = MetricsStore("sum")
    n_threads, n_iter = 8, 100

    def worker():
        for i in range(n_iter):
            ms.log(i, {"count": 1.0})

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    steps, vals = ms.series("count")
    assert len(steps) == n_iter
    np.testing.assert_array_equal(vals, np.full(n_iter, float(n_threads)))


# ---------------------------------------------------------------------------
# the port's tables against the JAX package's
# ---------------------------------------------------------------------------

def _log_sequence(seed):
    """Seeded (step, {name: value}) logs with repeated steps and names,
    and a flush point."""
    rng = np.random.default_rng(seed)
    names = ["loss", "tok", "lr", "requests"]
    logs = []
    for _ in range(60):
        step = int(rng.integers(0, 12))
        pick = rng.choice(names, size=int(rng.integers(1, 4)), replace=False)
        logs.append((step, {str(n): float(rng.integers(0, 64)) / 4
                            for n in pick}))
    return logs


def _same_table(t, j):
    for x, y in zip(t.triples(), j.triples()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("agg", ["last", "sum", "max", "min"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tables_equal_jax_for_the_same_logs(agg, seed):
    """Log, flush half way, log on, merge with a second store, round-trip
    through ``to_dict``: every table equals JAX's entry by entry."""
    logs = _log_sequence(seed)
    stores = []
    for cls in (MetricsStore, JaxMetricsStore):
        a, b = cls(agg), cls(agg)
        for i, (step, vals) in enumerate(logs):
            (a if i % 3 else b).log(step, vals)
            if i == len(logs) // 2:
                a.flush()
        stores.append((a, b, a.merge(b)))
    for t, j in zip(*stores):
        _same_table(t.table, j.table)
        assert t.to_dict() == j.to_dict()
        assert t.combine_calls == j.combine_calls
    for name in ("loss", "tok"):
        for x, y in zip(stores[0][2].series(name), stores[1][2].series(name)):
            np.testing.assert_array_equal(x, y)
