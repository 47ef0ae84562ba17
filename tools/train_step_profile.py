#!/usr/bin/env python3
"""Where a training launcher step's time goes on one card: qwen3-1.7b at
full width through ``repro_torch.launch.train``'s step.

    python3 tools/train_step_profile.py                 # 4 x 1024, remat full
    python3 tools/train_step_profile.py --seq-len 2048 --steps 3

The launcher's state (``train.make_state``: seeded bf16 weights, fp32
AdamW moments) takes one warm-up step on the D4M pipeline's batches, then:

1. ``--steps`` steps split by the host's clock, each part ended by a
   device sync: the batch's copy to the card, ``loss_and_grads`` (the
   forward, the layers' recompute and the backward), ``clip_by_global_norm``
   and ``adamw_update``;
2. ``--steps`` whole steps (``train.make_train_step``, as the launcher
   runs them, reading the loss as it does), each timed by the host's
   clock;
3. ``--steps`` whole steps under ``torch.profiler``: the device time of
   the kernels by group (GEMMs, the flash forward and backward kernels,
   the rest), and the device's idle share (one minus the union of kernel
   intervals over the traced wall time, which the profiler's own host
   work lengthens).

The last lines are the card's name and power limit and one JSON object of
the numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)

# kernel-name groups, first match wins
GROUPS = (("flash forward", ("flash_fwd", "flash_attention_fwd")),
          ("flash backward", ("flash_bwd", "flash_attention_bwd")),
          ("GEMM", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "cublas")),
          ("copies", ("memcpy", "memset")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, reductions, norms, softmax-xent, AdamW)"


def busy_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import CorpusPipeline, synth_corpus
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as T
    from repro_torch.optim import adamw_update, clip_by_global_norm

    cuda_lib.build(verbose=False)
    cuda_lib.load()
    dev = torch.device("cuda", 0)
    argv = ["--arch", args.arch, "--seq-len", str(args.seq_len), "--batch",
            str(args.batch), "--steps", str(2 * args.steps + 1)]
    targs = T.parse_args(argv)
    cfg = T.train_config(targs)
    opts = S.TrainOptions(peak_lr=targs.lr)
    schedule = T.train_schedule(cfg, targs)
    step_fn = T.make_train_step(cfg, opts, schedule)
    state = T.make_state(cfg, opts, targs.seed, dev)
    pipe = CorpusPipeline(synth_corpus(n_docs=64, seed=targs.seed),
                          seq_len=targs.seq_len, batch_per_shard=targs.batch,
                          seed=targs.seed)

    def batch():
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipe.next_batch().items()}

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    state, _ = step_fn(state, batch())        # warm-up
    torch.cuda.synchronize()

    # 1. the step in parts, by the host's clock
    parts = []
    for _ in range(args.steps):
        params, opt_state, step = state
        t0 = time.perf_counter()
        b = batch()
        t_batch = sync_s(t0)
        t0 = time.perf_counter()
        _, _, grads = S.loss_and_grads(params, cfg, b)
        t_grads = sync_s(t0)
        t0 = time.perf_counter()
        with torch.no_grad():
            grads, _ = clip_by_global_norm(grads, opts.max_grad_norm)
        t_clip = sync_s(t0)
        t0 = time.perf_counter()
        with torch.no_grad():
            adamw_update(grads, opt_state, params, lr=schedule(step),
                         b1=opts.b1, b2=opts.b2,
                         weight_decay=opts.weight_decay,
                         state_policy=opts.opt_state_policy)
        t_adamw = sync_s(t0)
        del grads
        state = (params, opt_state, step + 1)
        parts.append({"batch_s": t_batch, "loss_and_grads_s": t_grads,
                      "clip_s": t_clip, "adamw_s": t_adamw})
        chip_smoke.log(f"[profile] step parts: " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts[-1].items()))

    # 2. whole steps, by the host's clock
    whole = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch())
        float(m["loss"])
        whole.append(time.perf_counter() - t0)
    chip_smoke.log("[profile] whole steps: " + ", ".join(
        f"{t:.4f}" for t in whole) + " s")

    # 3. whole steps under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step_fn(state, batch())
            float(m["loss"])
        wall_s = sync_s(t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group, by_name = {}, {}
    for e in kernels:
        g, us = group_of(e.name), e.time_range.end - e.time_range.start
        by_group[g] = by_group.get(g, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    total = sum(by_group.values())
    out = {"arch": args.arch, "batch": args.batch, "seq_len": args.seq_len,
           "remat": cfg.remat, "steps": args.steps, "parts": parts,
           "whole_step_s": whole,
           "traced_wall_s": wall_s, "kernels": len(kernels),
           "device_busy_s": busy / 1e6,
           "device_idle_share": 1 - busy / 1e6 / wall_s,
           "kernel_s_by_group": {g: t / 1e6 for g, t in sorted(
               by_group.items(), key=lambda x: -x[1])},
           "top_kernels_s": {n[:90]: t / 1e6 for n, t in sorted(
               by_name.items(), key=lambda x: -x[1])[:12]}}
    chip_smoke.log(f"[profile] {args.steps} steps of {args.arch} at "
                   f"{args.batch} x {args.seq_len}: {wall_s:.3f} s wall, "
                   f"{len(kernels)} kernels, device busy {busy / 1e6:.3f} s "
                   f"(idle share {out['device_idle_share']:.3f})")
    for g, t in out["kernel_s_by_group"].items():
        chip_smoke.log(f"[profile] {g}: {t:.4f} s ({100 * t * 1e6 / total:.1f}%"
                       f" of kernel time)")
    for n, t in out["top_kernels_s"].items():
        chip_smoke.log(f"[profile]   {t:.4f} s  {n}")
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
