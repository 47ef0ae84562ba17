"""End-to-end training launcher (the JAX package's ``launch/train.py`` on one
card, or on the CPU at smoke scale).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --seq-len 1024 --batch 4 --steps 8 --ckpt-dir /tmp/run1   # the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --device cpu --steps 6 --ckpt-dir /tmp/r --simulate-failure 4

Wires every subsystem: D4M data pipeline → train step (``loss_and_grads``,
``clip_by_global_norm`` and ``adamw_update`` at the schedule's learning
rate, composed as the JAX launcher composes them; on the card the flash
kernel forward and its backward kernel) → async checkpointing →
fault-tolerant step loop → D4M metrics telemetry.  ``--simulate-failure
N`` kills the step function at its N-th call to exercise
restore-and-replay end to end.  The JAX launcher's host mesh and ``jit``
have no counterpart: the port runs eagerly on one device (module step 10
decides a mesh).  ``--device`` picks it: ``cuda`` (the default) without a
card is an error, not a move to the CPU.

The corpus is ``synth_corpus(n_docs=64)``, a flat stream of 1406 tokens:
from ``--seq-len`` 1404 on every window starts at token 0, and from 1406
on the labels come out one token short (the JAX launcher does the same).
"""
from __future__ import annotations

import argparse
import hashlib
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.assoc_tensor import resolve_device
from repro_torch.data import CorpusPipeline, synth_corpus
from repro_torch.distributed import MetricsStore, RestartPolicy, run_resilient
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               make_schedule)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def train_config(args):
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    return cfg.replace(remat="none" if args.smoke else cfg.remat)


def train_schedule(cfg, args):
    """The learning-rate schedule: MiniCPM contributes the WSD schedule —
    honour it by default."""
    kind = ("wsd" if cfg.name.startswith("minicpm")
            and args.schedule == "cosine" else args.schedule)
    return make_schedule(kind, peak_lr=args.lr,
                         warmup=max(args.steps // 20, 2), total=args.steps)


def make_state(cfg, opts: S.TrainOptions, seed: int, device):
    """Fresh ``(params, opt_state, step)``: weights drawn from ``seed`` on
    ``device``, zero AdamW moments, step an int32 scalar."""
    params = M.init(M.make_generator(seed, device), cfg)
    opt_state = adamw_init(params, state_policy=opts.opt_state_policy)
    return (params, opt_state,
            torch.zeros((), dtype=torch.int32, device=resolve_device(device)))


def make_train_step(cfg, opts: S.TrainOptions, schedule):
    """(state, batch of tensors) → (state, {"loss", "grad_norm", "lr"}):
    the loss and its gradients, clipped, then AdamW at ``schedule(step)``;
    parameters and moments are updated in place."""
    def train_step(state, batch):
        params, opt_state, step = state
        lr = schedule(step)
        loss, _, grads = S.loss_and_grads(params, cfg, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, opts.max_grad_norm)
            params, opt_state = adamw_update(
                grads, opt_state, params, lr=lr, b1=opts.b1, b2=opts.b2,
                weight_decay=opts.weight_decay,
                state_policy=opts.opt_state_policy)
        return ((params, opt_state, step + 1),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})
    return train_step


def batch_digest(batch) -> str:
    """A short hash of a numpy batch's tokens and labels."""
    h = hashlib.sha256(batch["tokens"].tobytes())
    h.update(batch["labels"].tobytes())
    return h.hexdigest()[:16]


def main(argv=None, *, report: Optional[dict] = None) -> int:
    """Run the launcher.  ``report`` (a dict), if given, receives ``calls``
    (one record a completed step call, replays included: ``step``,
    ``batch`` digest, ``loss``, ``s``), ``steps``, ``restarts``,
    ``seconds``, ``losses`` (the metrics store's series), the final
    ``state``, and the checkpoint manager's ``saves`` and ``restores``."""
    args = parse_args(argv)
    cfg = train_config(args)
    device = resolve_device(args.device)
    opts = S.TrainOptions(peak_lr=args.lr)
    schedule = train_schedule(cfg, args)

    docs = synth_corpus(n_docs=64, seed=args.seed)
    pipeline = CorpusPipeline(docs, seq_len=args.seq_len,
                              batch_per_shard=args.batch, seed=args.seed)
    print(f"[data] corpus nnz={pipeline.table.nnz()} "
          f"vocab={len(pipeline.tokenizer.table)}")
    if cfg.vocab < len(pipeline.tokenizer.table):
        raise SystemExit("smoke vocab smaller than tokenizer table")

    train_step = make_train_step(cfg, opts, schedule)
    metrics = MetricsStore("last")
    ckpt = (CheckpointManager(args.ckpt_dir, save_interval_steps=args.ckpt_every)
            if args.ckpt_dir else None)

    fail_at = args.simulate_failure
    calls = {"n": 0}
    records = []

    def step_fn(state, batch):
        calls["n"] += 1
        if fail_at >= 0 and calls["n"] == fail_at:
            raise RuntimeError("simulated worker failure")
        t0 = time.perf_counter()
        step = int(state[2]) if report is not None else None
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        state, m = train_step(state, tb)
        out = {k: float(v) for k, v in m.items()}
        if report is not None:
            records.append({"step": step, "batch": batch_digest(batch),
                            "loss": out["loss"],
                            "s": time.perf_counter() - t0})
        return state, out

    t0 = time.time()
    state, steps_done, restarts = run_resilient(
        n_steps=args.steps, step_fn=step_fn,
        make_state=lambda: make_state(cfg, opts, args.seed, device),
        ckpt_manager=ckpt, pipeline=pipeline,
        policy=RestartPolicy(max_restarts=3, backoff_s=0.01),
        metrics=metrics)
    dt = time.time() - t0
    steps_s, losses = metrics.series("loss")
    print(f"[train] {steps_done} steps in {dt:.1f}s "
          f"({dt / max(steps_done,1):.2f} s/step), restarts={restarts}")
    if len(losses) >= 2:
        print(f"[train] loss {losses[0]:.3f} → {losses[-1]:.3f}")
    if report is not None:
        report.update(calls=records, steps=steps_done, restarts=restarts,
                      seconds=dt, losses=list(losses), state=state,
                      saves=ckpt.saves if ckpt else [],
                      restores=ckpt.restores if ckpt else [])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
