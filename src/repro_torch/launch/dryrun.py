"""Mesh dry run: one (arch × shape) cell of the 16×16 (or 2×16×16) mesh,
run for real as rank 0 of a simulated group on one card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-1.7b --shape train_4k [--multi-pod] [--no-fsdp] \\
        [--policy fp32|bf16|q8] [--out results.jsonl] [--extra TAG] \\
        [--overrides parallelism=fsdp_only,residual_budget=2e9,...]

The JAX dry run (``repro/launch/dryrun.py``) compiles a cell for 256 or
512 placeholder devices and reads XLA's memory and cost analyses.  Here
``torch.distributed`` runs a ``"fake"`` process group of 256 (512) ranks
in which every collective is a no-op, rank 0 on ``cuda:0``: the mesh is
a DeviceMesh over it, each parameter, moment, batch and cache tensor is
drawn at its *local* shard shape from ``--seed`` and wrapped with
``DTensor.from_local`` (nothing is materialised whole), and one step of
the cell's kind runs on the card.  Memory is then measured
(``torch.cuda.max_memory_allocated``), not estimated.  The values that a
fake collective returns are whatever its buffer held, so the record is of
shapes, memory and counts; nothing on the step reads a value back to the
host to branch on it.

The record keeps the JAX keys where they mean something: ``status``,
``n_chips``, ``memory`` (``argument_bytes``, ``peak_bytes``), ``cost``
(``flops``, ``bytes accessed``), ``collectives`` (``per_kind``,
``counts``, ``total``), ``roofline``, ``model_flops_total``,
``hlo_flops_total`` (the rank's counted FLOPs × ranks: it counts executed
ops, there is no HLO), ``useful_flops_ratio``, ``params_total``,
``params_active``, ``dominant``.  ``lower_s`` and ``compile_s`` (nothing is
lowered or compiled) and ``tpu_adjusted_bytes`` (a correction for the CPU
backend's bf16 upcasts) have no meaning here and are dropped.  The record
adds ``rank_step_s`` (one rank's warm step with fake collectives: not a
mesh step time), ``flash_launches``, the counter's op count and the ops
with the most FLOPs and bytes (``top_flops``, ``top_bytes``).

Override keys are the JAX dry run's (``parallelism``, ``opt_state_policy``,
``grad_accum_dtype``, ``microbatch``, ``residual_budget``, ``attn_chunk``,
``loss_chunk``, ``prefill_chunk``, ``seq_parallel``, ``remat``,
``capacity_factor``, ``window``, ``moe_sharding``) plus ``seq_len`` and
``global_batch``, which cut the shape (CPU tests).  One cell per process,
as in the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback


def _apply_overrides(cfg, opts, shape, overrides: str):
    from repro_torch.launch import steps as S
    cfg_over, opt_over, shape_over = {}, {}, {}
    for kv in (overrides.split(",") if overrides else []):
        k, v = kv.split("=")
        if k in ("parallelism", "opt_state_policy", "grad_accum_dtype"):
            opt_over[k] = v
        elif k == "microbatch":
            opt_over[k] = int(v)
        elif k == "residual_budget":
            opt_over[k] = float(v)
        elif k in ("attn_chunk", "loss_chunk", "prefill_chunk"):
            cfg_over[k] = int(v)
        elif k == "seq_parallel":
            cfg_over[k] = bool(int(v))
        elif k == "remat":
            cfg_over[k] = v
        elif k == "capacity_factor":
            cfg_over["moe"] = {**cfg.moe, "capacity_factor": float(v)}
        elif k == "window":
            cfg_over[k] = int(v) if int(v) > 0 else None
        elif k == "moe_sharding":
            cfg_over[k] = v
        elif k in ("seq_len", "global_batch"):
            shape_over[k] = int(v)
        else:
            raise KeyError(f"unknown override {k}")
    if cfg_over:
        cfg = cfg.replace(**cfg_over)
    if opt_over:
        opts = S.TrainOptions(**{**opts.__dict__, **opt_over})
    if shape_over:
        shape = dataclasses.replace(shape, **shape_over)
    return cfg, opts, shape


def _local_bytes(tree) -> int:
    from repro_torch.models.pjit_utils import is_dtensor
    from repro_torch.optim import tree_leaves
    n = 0
    for leaf in tree_leaves(tree):
        for t in (leaf.values() if isinstance(leaf, dict) else (leaf,)):
            loc = t.to_local() if is_dtensor(t) else t
            n += loc.numel() * loc.element_size()
    return n


def _fake_group(world: int):
    """A fake default process group of ``world`` ranks (rank 0) unless one
    of that size exists → whether this call made it."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; the cell needs {world}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return True


FLASH_KEYS = ("flash_attention_wgmma", "flash_attention",
              "flash_attention_bwd_wgmma", "flash_attention_bwd")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             fsdp: bool = True, policy: str = "", extra: str = "",
             overrides: str = "", *, device: str = "cuda", seed: int = 0,
             smoke: bool = False) -> dict:
    """One cell → its record (see the module docstring).  ``smoke``: the
    arch's SMOKE config (CPU tests)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke, shapes_for
    from repro_torch.core.assoc_tensor import resolve_device
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_production_mesh

    cfg = (get_smoke if smoke else get_config)(arch)
    shape = {s.name: s for s in shapes_for(arch)}.get(shape_name)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "fsdp": fsdp, "policy": policy or None, "extra": extra or None}
    if shape is None:
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k needs sub-quadratic attention; "
                         "this is a pure full-attention arch (see DESIGN.md)")
        return rec

    dev = resolve_device(device)
    n_chips = 512 if multi_pod else 256
    opts = S.default_train_options(get_config(arch))
    if policy:
        opts = S.TrainOptions(**{**opts.__dict__, "opt_state_policy": policy})
    if not fsdp:
        opts = S.TrainOptions(**{**opts.__dict__, "fsdp": False})
    cfg, opts, shape = _apply_overrides(cfg, opts, shape, overrides)
    if overrides:
        rec["extra"] = ((extra + ";") if extra else "") + overrides

    made = _fake_group(n_chips)
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev.type)
        step, args = S.build_sharded(cfg, shape, mesh, opts, seed=seed,
                                     device=dev)
        arg_bytes = _local_bytes(args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = {k: cuda_lib.LAUNCHES.get(k, 0) for k in FLASH_KEYS}
        with HA.StepCounter() as counter:
            step(*args)
        flash = {k: cuda_lib.LAUNCHES.get(k, 0) - before[k]
                 for k in FLASH_KEYS}
        peak = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        # a second, uncounted step for the rank's time (the first pays
        # DTensor's sharding-propagation caches)
        t0 = time.perf_counter()
        step(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rank_s = time.perf_counter() - t0
    finally:
        if made:
            dist.destroy_process_group()

    st = counter.result()
    terms = HA.roofline_terms(st, st["collectives"], n_chips)
    n_total = S.est_param_count(cfg)
    n_active = HA.active_param_count(cfg, n_total)
    mflops = HA.model_flops(cfg, shape, n_active)
    hlo_flops_total = terms["hlo_flops_per_chip"] * n_chips
    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        "memory": {"argument_bytes": arg_bytes, "peak_bytes": peak},
        "cost": {"flops": st["flops"], "bytes accessed": st["bytes accessed"]},
        "collectives": st["collectives"],
        "roofline": terms,
        "model_flops_total": mflops,
        "hlo_flops_total": hlo_flops_total,
        "hlo_flops_total_counts": "executed ops (aten + flash kernels) of "
                                  "rank 0, times n_chips; no HLO",
        "useful_flops_ratio": (mflops / hlo_flops_total
                               if hlo_flops_total else None),
        "params_total": n_total,
        "params_active": n_active,
        "microbatch": ((opts.microbatch or S.auto_microbatch(
            cfg, shape, mesh, residual_budget=opts.residual_budget,
            parallelism=opts.parallelism))
            if shape.kind == "train" else None),
        "rank_step_s": rank_s,
        "rank_step_s_is": "one rank's warm step with fake (no-op) "
                          "collectives; not a mesh step time",
        "flash_launches": flash,
        "flash_cost": st["flash"],
        "aten_ops": st["ops"],
        "top_flops": st["top_flops"],
        "top_bytes": st["top_bytes"],
        "device": str(dev), "torch": torch.__version__,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
    })
    rec["dominant"] = HA.dominant_term(terms)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--policy", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--extra", default="", help="free-form tag")
    ap.add_argument("--overrides", default="",
                    help="comma-separated cfg/opts knobs (see run_cell)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's SMOKE config")
    args = ap.parse_args(argv)

    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod,
                       fsdp=args.fsdp, policy=args.policy, extra=args.extra,
                       overrides=args.overrides, device=args.device,
                       seed=args.seed, smoke=args.smoke)
    except Exception as exc:  # noqa: BLE001 — record the failure, don't die
        rec = {"arch": args.arch, "shape": args.shape,
               "mesh": "2x16x16" if args.multi_pod else "16x16",
               "status": "error", "error": repr(exc),
               "trace": traceback.format_exc()[-2000:]}
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0 if rec.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
