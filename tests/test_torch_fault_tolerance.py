"""Module step 9f on the CPU: the port's fault-tolerance layer
(``repro_torch.distributed.fault_tolerance``) against the JAX package's.

``tests/test_fault_tolerance.py``'s six tests on the port, with the
port's ``CheckpointManager`` and data pipeline under ``run_resilient``
(step 7 dies once; the loop restores the step-5 checkpoint and replays the
same batches), each decision held to the JAX package's on the same
inputs; then one seeded sequence of per-worker step times (occasional
slow steps, one worker slow from step 20 on, another from step 40) fed to
both packages' ``StragglerMitigator``: the same workers flagged at the
same steps, the same strikes; and both ``RestartPolicy``s' backoffs and
budgets.  Everything here is host numpy: exact.
"""
import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import CorpusPipeline as JCorpusPipeline
from repro.distributed import HeartbeatMonitor as JHeartbeatMonitor
from repro.distributed import MetricsStore as JMetricsStore
from repro.distributed import RestartPolicy as JRestartPolicy
from repro.distributed import StragglerMitigator as JStragglerMitigator
from repro.distributed import run_resilient as j_run_resilient
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import CorpusPipeline, synth_corpus
from repro_torch.distributed import (FaultToleranceConfig, HeartbeatMonitor,
                                     MetricsStore, RestartPolicy,
                                     StragglerMitigator, run_resilient)

from _torch_helpers import _reset_port_stats  # noqa: F401


def test_heartbeat_detects_dead_worker():
    for cls in (HeartbeatMonitor, JHeartbeatMonitor):
        t = {"now": 0.0}
        mon = cls(["w0", "w1"], timeout_s=10, clock=lambda: t["now"])
        t["now"] = 5.0
        mon.beat("w0")
        t["now"] = 12.0
        assert mon.dead_workers() == ["w1"] and not mon.healthy()
        mon.beat("w1")
        assert mon.healthy()
        mon.beat("w0", at=-1.0)
        assert mon.dead_workers() == ["w0"]


def test_straggler_detector_flags_persistent_outlier():
    ws = [f"w{i}" for i in range(8)]
    flagged = {}
    for cls in (StragglerMitigator, JStragglerMitigator):
        det = cls(ws, mad_k=4.0, patience=3)
        out = []
        for step in range(5):
            times = {w: 1.0 + 0.01 * i for i, w in enumerate(ws)}
            times["w3"] = 10.0  # persistent straggler
            out.extend(det.record_step(times))
        assert out == ["w3"]   # flagged exactly once, after `patience` steps
        det.reassign("w3", "spare0")
        assert det.reassigned == {"w3": "spare0"}
        flagged[cls] = (out, dict(det.strikes))
    assert flagged[StragglerMitigator] == flagged[JStragglerMitigator]


def test_straggler_transient_not_flagged():
    ws = [f"w{i}" for i in range(8)]
    for cls in (StragglerMitigator, JStragglerMitigator):
        det = cls(ws, mad_k=4.0, patience=3)
        out = []
        for step in range(6):
            times = {w: 1.0 for w in ws}
            if step % 2 == 0:
                times["w1"] = 8.0  # flaps — strikes reset between
            out.extend(det.record_step(times))
        assert out == []


def test_restart_policy_budget():
    for cls in (RestartPolicy, JRestartPolicy):
        p = cls(max_restarts=2, backoff_s=0.5)
        assert p.should_restart() and p.on_restart() == 0.5
        assert p.should_restart() and p.on_restart() == 1.0
        assert not p.should_restart() and p.restarts_used == 2
    assert FaultToleranceConfig().max_restarts == RestartPolicy().max_restarts


def _resilient_run(pkg, tmp_path):
    """``tests/test_fault_tolerance.py``'s recovery scenario on one
    package → (batches seen, steps, restarts, final acc, loss series)."""
    port = pkg == "port"
    docs = synth_corpus(8, seed=0)
    pipeline = (CorpusPipeline if port else JCorpusPipeline)(
        docs, seq_len=8, batch_per_shard=1, seed=3)
    mgr = (CheckpointManager if port else JCheckpointManager)(
        str(tmp_path / pkg), save_interval_steps=5)
    metrics = (MetricsStore if port else JMetricsStore)("last")
    seen = []
    failed = {"done": False}

    def make_state():
        return {"acc": np.zeros(1)}

    def step_fn(state, batch):
        if (not failed["done"]) and len(seen) == 7:
            failed["done"] = True
            raise RuntimeError("boom")
        seen.append(batch["tokens"].copy())
        return {"acc": state["acc"] + batch["tokens"].sum()}, \
            {"ts": float(batch["tokens"].sum())}

    state, steps, restarts = (run_resilient if port else j_run_resilient)(
        n_steps=10, step_fn=step_fn, make_state=make_state,
        ckpt_manager=mgr, pipeline=pipeline,
        policy=(RestartPolicy if port else JRestartPolicy)(
            max_restarts=2, backoff_s=0.0),
        metrics=metrics, sleep=lambda s: None)
    return seen, steps, restarts, float(np.asarray(state["acc"])[0]), \
        metrics.series("ts")


def test_run_resilient_recovers_and_replays(tmp_path):
    """Step 7 dies once; the loop restores step-5 ckpt and replays the SAME
    batches (deterministic cursor) to completion, as the JAX loop does."""
    seen, steps, restarts, acc, series = _resilient_run("port", tmp_path)
    assert steps == 10 and restarts == 1
    ref = CorpusPipeline(synth_corpus(8, seed=0), seq_len=8,
                         batch_per_shard=1, seed=3)
    want = [ref.next_batch()["tokens"] for _ in range(10)]
    # seen = steps 0..6 (pre-crash) + 5..9 (replay)
    assert len(seen) == 12
    for got, w in zip(seen, want[:7] + want[5:]):
        np.testing.assert_array_equal(got, w)
    j_seen, j_steps, j_restarts, j_acc, j_series = _resilient_run(
        "jax", tmp_path)
    assert (steps, restarts, acc) == (j_steps, j_restarts, j_acc)
    assert acc == float(sum(w.sum() for w in want))
    for got, w in zip(seen, j_seen):
        np.testing.assert_array_equal(got, w)
    for a, b in zip(series, j_series):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_run_resilient_exhausts_budget(tmp_path, pkg):
    port = pkg == "port"
    mgr = (CheckpointManager if port else JCheckpointManager)(
        str(tmp_path), save_interval_steps=100)
    calls = []

    def step_fn(state, batch):
        calls.append(1)
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError):
        (run_resilient if port else j_run_resilient)(
            n_steps=3, step_fn=step_fn, make_state=lambda: {},
            ckpt_manager=mgr, pipeline=None,
            policy=(RestartPolicy if port else JRestartPolicy)(
                max_restarts=2, backoff_s=0.0),
            sleep=lambda s: None)
    assert len(calls) == 3       # the first try and two restarts


def test_decisions_match_jax_on_a_seeded_timing_sequence():
    rng = np.random.default_rng(11)
    ws = [f"w{i}" for i in range(16)]
    dets = (StragglerMitigator(ws, mad_k=4.0, patience=3, window=8),
            JStragglerMitigator(ws, mad_k=4.0, patience=3, window=8))
    flagged = ([], [])
    for step in range(60):
        times = {w: float(t) for w, t in zip(
            ws, 1.0 + 0.05 * rng.standard_normal(len(ws)))}
        for w in rng.choice(ws, 2, replace=False):
            times[str(w)] *= 1.0 + 4.0 * rng.random()   # transient slow
        if step >= 20:
            times["w5"] = 3.0 + rng.random()
        if step >= 40:
            times["w9"] = 2.0 + rng.random()
        for det, out in zip(dets, flagged):
            out.extend((step, w) for w in det.record_step(times))
        assert dets[0].strikes == dets[1].strikes, step
    assert flagged[0] == flagged[1]
    assert {w for _, w in flagged[0]} >= {"w5", "w9"}
    assert dets[0].times == dets[1].times
    policies = (RestartPolicy(max_restarts=4, backoff_s=0.25),
                JRestartPolicy(max_restarts=4, backoff_s=0.25))
    decisions = [[], []]
    for _ in range(6):
        for p, out in zip(policies, decisions):
            ok = p.should_restart()
            out.append((ok, p.on_restart() if ok else None))
    assert decisions[0] == decisions[1]
    assert decisions[0][3] == (True, 2.0) and decisions[0][4] == (False, None)
