"""Decode time and torch calls per decode step of the serve path, for the
``repro_torch`` under ``--src``: qwen3-1.7b at ``chip_smoke.py``'s
serve-phase traffic, zamba2-7b and whisper-medium at its families-phase
traffic (the same configs, batch, prompt, tokens and seed).  Each config is
served once to warm up and then REPEATS times; one JSON line per
config gives each run's decode ms a token and the torch calls one decode
step dispatches (``chip_smoke.torch_calls``).

To compare two trees, run this once per tree, each in a process of its own
and in the order A, B, B, A, on one card:

    python tools/serve_ab.py --src <tree>/src --label <name>
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-1.7b", "zamba2-7b", "whisper-medium")
REPEATS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the directory that holds the repro_torch to time")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    # the tree under test is imported first: chip_smoke, imported for its
    # constants, puts this repo's own src first on the path
    import repro_torch
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    if not repro_torch.__file__.startswith(src + os.sep):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model as M

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA card", file=sys.stderr)
        return 2
    cuda_lib.load()
    dev = torch.device(cs.DEVICE)
    for arch in ARCHS:
        cfg = get_config(arch)
        if arch == cs.SERVE_ARCH:
            b, p, g = cs.SERVE_BATCH, cs.SERVE_PROMPT, cs.SERVE_GEN
        else:
            if cfg.family in ("dense", "moe"):
                cfg = cfg.replace(n_layers=cs.FAMILY_LAYERS.get(
                    arch, cs.FAMILY_DENSE_LAYERS))
            b, p = cs.FAMILY_TRAFFIC.get(arch, (cs.SERVE_BATCH,
                                                cs.SERVE_PROMPT))
            g = cs.FAMILY_GEN.get(arch, 8)
        gen = M.make_generator(cs.SERVE_SEED, dev)
        params = M.init(gen, cfg)
        if "shared_lora" in params:
            params["shared_lora"]["b"].normal_(0.0, cs.LORA_B_STD,
                                               generator=gen)
        prompts = torch.randint(0, cfg.vocab, (b, p), generator=gen,
                                device=dev, dtype=torch.int32)
        enc = (serve_lib.frame_embeddings(cfg, b, gen)
               if cfg.family == "encdec" else None)
        serve_lib.serve(params, cfg, prompts, 2, enc)        # warm-up
        ms = []
        for _ in range(REPEATS):
            res = serve_lib.serve(params, cfg, prompts, g, enc)
            ms.append(1e3 * res["decode_s"] / g)
        cache = M.init_cache(cfg, b, 2, device=dev)
        calls = cs.torch_calls(lambda: make_serve_step(cfg)(
            params, cache, prompts[:, :1], 0))
        print(json.dumps({"label": args.label, "arch": arch,
                          "layers": cfg.n_layers, "batch": b, "prompt": p,
                          "tokens": g, "decode_ms_per_token": ms,
                          "torch_calls_per_decode_step": calls,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
        del params, cache, prompts, enc, res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
