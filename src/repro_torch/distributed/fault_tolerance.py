"""Fault tolerance: heartbeats, restart policy, straggler mitigation (the
port's own copy of the JAX package's ``repro.distributed.fault_tolerance``,
which is numpy only).

The layer is built against an abstract worker interface and exercised by
a simulation harness in tests (dead workers, slow workers, flapping
workers).  The production binding points are documented inline: on a real
deployment the heartbeat source is the launcher's health checks (the
``torch.distributed`` store or the job scheduler's) and "restart" means
re-scheduling the job; everything above that seam — detection thresholds,
restart-with-checkpoint control flow, deterministic data replay,
straggler quorum logic — is the code here, unchanged.

Control flow implemented by :func:`run_resilient`:

  1. step function raises / a heartbeat lapses →
  2. RestartPolicy decides (restart budget, backoff) →
  3. restore latest checkpoint (CheckpointManager, crash-safe) →
  4. data pipeline cursor restored → bitwise-identical batch replay →
  5. training resumes; metrics merge idempotently (MetricsStore ⊕).

Straggler mitigation: per-step worker timings feed an online median/MAD
estimator; workers slower than ``median + k·MAD`` for ``patience``
consecutive steps are marked and their data shard re-dispatched to a hot
spare (backup-worker semantics à la MapReduce speculative execution).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class FaultToleranceConfig:
    heartbeat_timeout_s: float = 60.0
    max_restarts: int = 5
    backoff_s: float = 1.0
    straggler_mad_k: float = 4.0
    straggler_patience: int = 3
    n_hot_spares: int = 1


class HeartbeatMonitor:
    """Tracks last-seen times; on real clusters fed by the RPC layer."""

    def __init__(self, worker_ids: List[str], timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last_seen: Dict[str, float] = {w: clock() for w in worker_ids}

    def beat(self, worker: str, at: Optional[float] = None):
        self.last_seen[worker] = self.clock() if at is None else at

    def dead_workers(self) -> List[str]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout]

    def healthy(self) -> bool:
        return not self.dead_workers()


class StragglerMitigator:
    """Online median/MAD outlier detector over per-worker step times."""

    def __init__(self, worker_ids: List[str], *, mad_k: float = 4.0,
                 patience: int = 3, window: int = 32):
        self.mad_k = mad_k
        self.patience = patience
        self.window = window
        self.times: Dict[str, List[float]] = {w: [] for w in worker_ids}
        self.strikes: Dict[str, int] = {w: 0 for w in worker_ids}
        self.reassigned: Dict[str, str] = {}

    def record_step(self, step_times: Dict[str, float]) -> List[str]:
        """Feed one step's per-worker wall times; returns NEW stragglers."""
        for w, t in step_times.items():
            buf = self.times[w]
            buf.append(t)
            if len(buf) > self.window:
                buf.pop(0)
        med = float(np.median(list(step_times.values())))
        mad = float(np.median([abs(t - med) for t in step_times.values()]))
        mad = max(mad, 1e-6)
        out = []
        for w, t in step_times.items():
            if t > med + self.mad_k * mad:
                self.strikes[w] += 1
                if self.strikes[w] == self.patience:
                    out.append(w)
            else:
                self.strikes[w] = 0
        return out

    def reassign(self, straggler: str, spare: str):
        """Record a shard re-dispatch (backup-worker execution)."""
        self.reassigned[straggler] = spare


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 1.0
    _used: int = 0

    def should_restart(self) -> bool:
        return self._used < self.max_restarts

    def on_restart(self) -> float:
        """Returns backoff seconds (exponential)."""
        self._used += 1
        return self.backoff_s * (2 ** (self._used - 1))

    @property
    def restarts_used(self) -> int:
        return self._used


def run_resilient(*, n_steps: int, step_fn, make_state, ckpt_manager,
                  pipeline=None, policy: Optional[RestartPolicy] = None,
                  metrics=None, sleep=time.sleep):
    """Drive ``step_fn(state, batch) -> (state, metrics_dict)`` to n_steps,
    surviving step-fn failures via checkpoint restore + deterministic data
    replay.  Returns (state, steps_completed, restarts_used).

    ``make_state()`` builds fresh state: the target a checkpoint is
    restored into, or the state itself if no checkpoint exists at the
    first failure.  This is the exact control flow a real launcher runs
    per-host; only the failure SIGNAL differs (exception here, health
    RPC there).
    """
    policy = policy or RestartPolicy()
    state = make_state()
    step = 0
    while step < n_steps:
        try:
            batch = pipeline.next_batch() if pipeline is not None else None
            state, m = step_fn(state, batch)
            if metrics is not None and m:
                metrics.log(step, m)
            step += 1
            if ckpt_manager is not None and ckpt_manager.should_save(step):
                extra = {"pipeline": pipeline.state_dict()} if pipeline else {}
                ckpt_manager.save_async(step, state, extra=extra)
        except Exception:
            if policy is None or not policy.should_restart():
                raise
            sleep(policy.on_restart())
            try:
                state, step, extra = ckpt_manager.restore_latest(make_state())
                if pipeline is not None and "pipeline" in (extra or {}):
                    pipeline.load_state_dict(extra["pipeline"])
            except FileNotFoundError:
                state, step = make_state(), 0
                if pipeline is not None:
                    pipeline.load_state_dict({"step": 0, "seed":
                                              pipeline.state.seed, "epoch": 0})
    if ckpt_manager is not None:
        ckpt_manager.wait()
    return state, step, policy.restarts_used
