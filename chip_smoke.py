#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py                  # the full check, one card
    python3 chip_smoke.py --n-clustered 17 # a smaller clustered size

Phases, each of which fails the run (non-zero exit, no result line):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a);
2. the paths, through the entry points a user calls, each with every
   kernel launch counter set to 0 just before it and read just after:
   * the serve path: qwen3-1.7b at full width (28 layers, d_model 2048,
     1.72e9 seeded random bf16 weights) through
     ``repro_torch.launch.serve``: a prefill of batch 4 x 2048 tokens, the
     cache repack to capacity 2080 and 32 greedy decode steps;
     ``flash_attention`` must launch once per layer (28), every time on
     its bf16 wgmma route (``flash_attention_wgmma``).  Then, outside
     the count: the kernel route's prefill logits against the plain
     route's (``attn_impl="ref"``) on the same weights, the first decode
     step's logits against a prefill of the prompt plus that token, a
     chunked prefill of the prompt in two windows of 1024 (56 wgmma
     launches, the second window at ``q_off`` 1024) against the one-shot
     prefill, layer 0's attention output by both routes, and the kernel
     alone at the path's shape (plus a window case and a ``q_off > 0``
     case);
   * the families phase (module steps 9a-9d), each config through the
     same serve driver with the counters reset before it: zamba2-7b uncut
     (81 mamba layers, d_model 3584, 112 SSM heads, the shared attention
     block invoked 14 times with its LoRA ``b`` drawn from N(0, 0.1^2))
     and mamba2-130m uncut, 32 greedy tokens each; chatglm3-6b,
     starcoder2-7b, minicpm-2b and chameleon-34b at full width and 2
     layers, 8 tokens each, all at batch 4 x 2048; mixtral-8x22b at full
     width and 2 layers (attention with a 4096 window and ring caches, 8
     experts top-2 at capacity factor 1.25), batch 2 x 6144, 32 tokens;
     deepseek-v3-671b at full width and 4 of its 61 layers (MLA, the three
     dense layers and one MoE layer of 256 experts top-8 with the sigmoid
     router and a shared expert; its MTP block built, not run), batch 2 x
     8192 through its own ``prefill_chunk`` of 4096, 32 tokens;
     whisper-medium uncut (24 encoder and 24 decoder layers, d_model 1024,
     1,371,031,552 parameters, over seeded normal frame embeddings [4,
     1500, 1024]), batch 4 x 2048, 32 tokens.  ``flash_attention`` must
     launch once per attention layer or shared-block invocation and
     prefill chunk (14 for zamba2, 0 for mamba2, 2 for the dense ones and
     mixtral, 8 for deepseek-v3); whisper's prefill launches it in its 24
     encoder layers (non-causal over the 1500 frames), 24 decoder layers
     and 24 cross-attentions, and each decode step in its 24
     cross-attentions (72 + 24 x 32); all on the wgmma route, after one
     warm-up prefill; for the MoE configs the
     share of routed (token, expert) entries the prefill dropped is
     printed per layer, and decode must drop none.  Outside the
     count: the kernel route's prefill logits against the plain route's
     (for mixtral with the (token, layer) routes whose experts differ
     between the two), and 128 teacher-forced decode steps against a
     prefill of the prompt plus those tokens (relative L2 2^-4 each;
     mixtral's across its ring's wrap and at a capacity no expert can
     exceed on both sides, since a prefill may drop what decode never
     does; deepseek-v3's decode check prefills in chunks of 128, since a
     no-drop capacity over a 4096-token chunk needs a 30 GB dispatch
     buffer; whisper's prefills take the same frames, and its checks run
     in bf16 unless the plain route's bf16-against-fp32 spread on the
     same weights, printed, exceeds 2^-4).  mamba2 and zamba2 take both
     checks on the same weights in
     fp32 (the flash kernel's fp32 route): at their full depth bf16
     rounding alone moves their logits by 9% and 49% on an H100 (the plain
     route in bf16 against fp32, printed beside, not gated).  Then the
     kernel alone at each config's attention shape (D 112, D 64, GQA 16
     and 9; mixtral's GQA 6 with its window, SDPA given the window as a
     boolean mask; deepseek-v3's two prefill chunks at q/k head dim 192
     and v head dim 128, the second at ``q_off`` 4096 over 8192 keys, SDPA
     given that offset as a boolean mask, the plain version run over 16
     blocks of heads; whisper's four: the encoder's 1500 x 1500 and the
     prefill's 2048 x 1500 cross-attention, non-causal, its decoder's
     causal 2048 x 2048, and a decode step's 1 x 1500 cross-attention,
     SDPA given no mask for the non-causal ones) against its plain
     version, timed beside its bound and SDPA (the ``[serve path] <arch>``
     lines);
   * the train phase (module step 9e; the ``[train]`` lines, the card's
     name and power limit in the first): qwen3-1.7b uncut takes 3 train
     steps (``launch.steps.make_train_step``: loss, gradients, clipping,
     AdamW with the fp32 moments of ``default_train_options``) on one
     seeded batch of 4 x 2048 tokens with remat "full"; each step must
     launch the flash kernel 28 times forward, 28 more in the layers'
     recompute and its bf16 backward kernel (the wgmma route,
     ``flash_attention_bwd_wgmma``) 28 times, the fp32 backward
     (``flash_attention_bwd``) never, and the loss must fall.  Before
     them, outside the count, the route check (step 1's loss, gradient
     norm and the relative L2 of the ``wq``/``wk``/``wv``/``embed``
     gradients on the kernel route against
     ``attn_impl="ref"``, which launches no flash kernel) and the
     microbatch check (``microbatch=2`` against the whole batch), each
     within the limits at ``TRAIN_GRAD_TOL``.  Then one step for every
     other family at full width, with the moment policy its uncut config
     gets: chatglm3-6b, starcoder2-7b, minicpm-2b, chameleon-34b (bf16
     moments) and mixtral-8x22b (bf16, 2 x 6144 past its window) at 2
     layers, mamba2-130m and whisper-medium (frames [4, 1500, 1024])
     uncut, zamba2-7b at 44 of 81 layers, deepseek-v3-671b at its 3 dense
     layers with the MTP block under q8 (2 x 4096); each finite, with the
     flash launches of ``train_launches_wanted``.  Then the backward
     kernel alone at each family's train shape (whisper's 1500-frame
     encoder and cross-attention, MLA's (192, 128)) against
     ``flash_attention_bwd_ref`` (relative L2 within 2^-6), timed beside
     its bound, its plain version and SDPA's backward, and its share of a
     qwen3-1.7b train step (28 launches at the timed ms over the steps'
     median);
   * the train-launch phase (module step 9f; the ``[train launch]``
     lines): ``repro_torch.launch.train``'s ``main`` in process, as
     ``python -m repro_torch.launch.train --arch qwen3-1.7b --seq-len 1024
     --batch 4 --steps 8`` runs it (full width and depth, remat "full",
     fp32 moments, batches from the D4M pipeline), with ``--ckpt-dir`` in
     a temporary directory, ``--ckpt-every 3 --simulate-failure 5`` (the
     step-3 checkpoint restores and step 3 runs again), then with no
     failure and no checkpoint directory, each run counted: 56 forward and
     28 backward wgmma flash launches a completed step, none on an fp32
     route.  It fails unless restarts=1, every step's batch (replays
     included) has the same digest in both runs, every step's loss is
     within 2^-6 relative of the uninterrupted run's, a synchronous
     ``save_checkpoint`` of the final state restored in place into a fresh
     state gives back every leaf bit for bit (bf16 parameters, fp32
     moments, the int32 step), and ``compress_tree`` over one full
     gradient tree holds ``tests/test_compression.py``'s round-trip bound
     and, over three error-feedback rounds, its unbiasedness bound.  It
     prints the step seconds, each save's synchronous host copy and
     writer seconds, the checkpoint bytes, the restore seconds, the peak
     device memory and the host's peak RSS, the free disk and the
     compression's ms and bytes, then the flash kernels alone at the
     launcher's shape (4 x 1024) beside their bounds and SDPA's times.
     The temporary directory goes in a ``finally``;
   * the mesh phase (module step 10; the ``[mesh]`` lines):
     ``python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape
     train_4k`` and ``--shape decode_32k``, each in a process of its own
     as rank 0 of a fake 256-rank group on the 16x16 mesh (full width and
     28 layers, every tensor at its per-rank shard size), their records
     printed beside the card's name and power limit.  It fails unless
     each record is ``ok`` at 256 ranks with a peak under the card's
     memory, and train_4k launched bf16 flash forwards and backwards, made
     all-gathers and all-reduces or reduce-scatters and has a useful-FLOPs
     ratio in (0, 1] (decode stays on the plain path and launches no flash
     kernel).  Then ``chip_smoke.py --mesh-local`` in a process of its
     own: qwen3 SMOKE's train and decode steps in bf16 on a 2x2 mesh of
     simulated ranks (``LocalTensorMode``), the flash kernels launched on
     each rank's local shards, against the same steps unsharded on the
     card: the loss, the gradient norm, every gradient leaf and every
     first moment after the step, and the decode logits, within limits
     (MESH_*_TOL) set from a bf16 control (the unsharded bf16 steps
     against fp32 ones) and printed beside it, and an unsharded
     checkpoint restored sharded
     (every rank's block exact).  The flash rows' launches add the
     phase's; ``--mesh-phase-only`` runs the build and this phase alone;
   * the main path: the clustered workload at n=18 (2^21 triples per
     array, ~164k x 165k keys): ``from_triples``, a row ``Range``
     selection, ``A + B``, ``A @ B`` (planned ``bsr``),
     ``A.sqout(reduce=1)`` and
     ``(A.lazy()[sel, :] @ B.lazy()).sum(axis=1).collect()``; then the
     paper's uniform workload at n=12: ``A.matmul(B)`` under
     ``PLUS_TIMES`` and ``MIN_PLUS``, ``A.sqout(reduce=1)``,
     ``A.matmul_reduce(B, axis=0)`` and the same lazy pipeline (all
     planned ``dense``); every kernel of the path must have launched, the
     uniform ``PLUS_TIMES`` product and fused reduces and the n=18
     ``A @ B``, ``A.sqout(reduce=1)`` and pipeline on the TF32 routes, and
     ``MIN_PLUS`` on the CUDA-core route;
   * the ingest path: the uniform workload at n=15 (262,144 triples per
     array, ~32.8k x 32.8k keys) as an ``IngestTable`` over A that takes
     B in 16 batches, with snapshots (merge-on-read) after batch 8 and
     16, a row ``Range`` selection on the snapshot, ``compact()``, one
     more batch and a snapshot, for ``aggregate="sum"`` and ``"max"``;
     ``rank_count`` must launch twice per merge;
   * the ingest fallback: the clustered n=18 A as a base takes B's first
     65,536 triples; its keyspace is too large to linearize into int32,
     so the merge is concat + dedup and ``rank_count`` must not launch;
   * the dist path, on a one-rank NCCL mesh on the card
     (``make_mesh``): the clustered n=18 triples of the main path as
     ``DistAssoc`` A and B on their union keyspaces, then the row
     ``Range`` selection, ``A + B``, ``A.mul(B)``, ``A[sel, :] = 2.0`` on
     a copy, ``col_reduce`` and ``row_reduce`` under ``PLUS_TIMES`` and
     ``MAX_PLUS``, ``col_degree``, ``matmul_dense_vec`` of a ones vector,
     ``(A.lazy()[sel, :] + B.lazy()[sel, :]).collect()``,
     ``(A.lazy() + B.lazy()).sum(axis=1).collect()``,
     ``gather_replicated()`` and ``to_assoc()``, each beside the same
     operation on the main path's ``AssocTensor``s (the ``[dist path]``
     line); ``range_mask`` must launch in the dist selection and in the
     assignment, and each dist operation must make the collectives its
     JAX ``@contract`` declares (0 shard-local, 1 a reduction); then the
     ingest workload at n=15 over ``DistAssoc`` bases, with no collective;
   * the dist products on the same mesh: the clustered n=18 DistAssocs
     ``A @ B`` (the cost model picks replicate at one rank; 15.6M
     products, so its tiled compute: ``bsr_pairlist``, TF32 route), the
     forced ``coo``, ``all_to_all`` (a one-rank ``all_to_all``) and
     ``2d`` (grid (1, 1), no shift) strategies,
     ``A.matmul_reduce(B, axis=0)`` under replicate and all-to-all,
     ``A.sqout(reduce=1)``, ``A.sqin()`` and ``A.sqin(reduce=1)`` (the
     device planner on the gathered array: ``bsr_pairlist_reduce``), the
     lazy ``(A.lazy()[sel, :] @ B.lazy())`` with and without
     ``.sum(axis=1)``; the uniform n=12 triples as DistAssocs:
     ``A.matmul(B)`` under ``PLUS_TIMES`` and ``MIN_PLUS``
     (``bsr_pairlist`` on both routes), ``A.sqin()``
     (``semiring_matmul``) and ``A.sqin(reduce=1)``
     (``bsr_spgemm_reduce``); each with its wall time beside the
     ``AssocTensor``'s, strategy, collectives and launches (the
     ``[dist product]`` lines);
   * the contracts phase, on the same mesh: ``repro_torch.analysis``'s
     ``verify_all`` runs the programs behind every ``@contract`` (the 24
     of the JAX package) over the probes' seeded inputs (64 triples a
     tensor or shard over 4096 x 4096 keys, the JAX probe geometry) with
     ``impl="auto"``, counted: collectives by family, host reads
     (device-to-host copies included), the largest intermediate beside
     the dense budget and the peak-memory delta beside the budget's
     float32 bytes plus the inputs'; ``range_mask``, ``bsr_pairlist``,
     ``bsr_pairlist_reduce`` and ``rank_count`` must launch, no contract
     may be violated, and each program's output must equal the same call
     on the plain route (the pair kernels' (+, ×) within the TF32 route's
     bound; the ``[contracts]`` lines; ``dist.matmul_2d`` needs four
     ranks and is reported as not run);
   * the serve phase: those arrays (clustered ``edges``/``feat``, uniform
     ``U``/``V``, the dist ``dA``/``dB``) and a fresh ``IngestTable`` over
     the n=15 ``sum`` base, registered as resident tables of the query
     server (``repro_torch.serve``) on 127.0.0.1 with 4 workers (one
     executor in admission order, since the registry holds dist tables)
     and queried by ``D4MClient`` threads over loopback HTTP in six mixes
     (``main_path.SERVE_COUNTS``): hot ``(edges[sel, :] @
     feat).sum(axis=1)`` after one warm-up, cold ones with a fresh
     ``Keys`` window of 16 rows each, ``edges[Keys(16 rows), :] @ feat``
     triples, the uniform ``(U @ V).sum(axis=1)`` under ``PLUS_TIMES``
     and ``MIN_PLUS``, 16 ``POST /ingest`` batches of 16,384 triples each
     followed by a read, and the dist ``(dA[sel, :] @ dB).sum(axis=1)``
     with one ``/tables``; each mix must launch its kernels
     (``main_path.SERVE_MIX_KERNELS``: ``range_mask``, the pair kernels,
     ``bsr_spgemm_reduce`` on both routes, ``rank_count``), and the
     one-rank mesh makes no broadcast (the ``[d4m serve]`` lines: per mix
     p50/p99 latency, throughput, plan hit rate, batch mean, the server's
     ``exec_s`` beside the in-process ``collect()``, launches; peak card
     memory);
3. the results held against the host ``Assoc`` (numpy/scipy): every
   served result identical to the in-process ``collect()`` of the same
   query, one per serve mix against the host, every ingest read and the
   final ingest snapshot against the host, no hot request after the
   warm-up missing the plan cache and the dist mix's collectives against
   the JAX ``@contract``s; counts,
   checksums and reduced vectors at n=18, every entry at n=12, on a
   clustered n=14 run and of every ingest snapshot; every dist result
   entry by entry against the host and against the device result beside
   it; every dist product against the host (counts and checksums at
   n=18, every entry at n=12) and the main path's device result, its
   collectives against the JAX ``@contract`` (no prologue collective at
   one rank) and all three strategies run;
4. each kernel against its plain torch version on the card, on inputs of
   the main path's shapes, under all six semirings where a semiring
   applies.  The matmul inputs are multiples of 1/4 in [1/4, 2], so every
   fp32 product and sum is exact in any order, on the CUDA cores and on
   the TF32 route alike: the tolerance is 0 for every semiring.
   ``bsr_spgemm`` and ``bsr_spgemm_reduce`` are held at 4096^3 both with a
   seeded mask that keeps about 1/4 of A's tiles and with the all-present
   mask of uniform n=12 (``bsr_spgemm`` must take its TF32 route under
   ``plus_times`` and the ring under the other five).  The TF32 route
   ((+, ×) of ``semiring_matmul``, ``bsr_spgemm`` and
   ``bsr_spgemm_reduce``) is also held on normal values against the fp64
   product, within its stated bound (for the masked store K = 128 x the
   block-row's present k tiles) and a relative L2 error of 2^-16, at
   4096^3 and unaligned shapes, and on ±inf and near-FLT_MAX inputs (for
   ``bsr_spgemm`` in present and in absent tiles of A), where it must
   equal the plain version; the pair kernels' TF32 route on normal values
   at the n=18 pairs, within that bound with K = 128 x the run's pairs
   (the reduce: plus its folds).  The five ring semirings (max or min ⊕)
   on NaN and opposite infinities: ``semiring_matmul``, ``bsr_spgemm``,
   ``bsr_spgemm_reduce`` and both pair kernels equal to their plain
   versions, NaN where they have NaN.  ``segment_scan`` (no caller on any
   path, as in the JAX package) is held against its plain version under
   sum, min and max at the size a dedup of the clustered n=18 array scans
   (2^21 sorted pair ids; normal sums within the kernel's and the plain
   version's depth bounds), and in every bit against its order model
   (``segment_scan_tiled_ref``) on 4096 and 2^21 pair ids, 2^21 equal keys
   and 2^24 keys of the same run lengths, with NaN and ±inf among normal
   values; ``range_mask`` on the main path's box, on the same entries in a
   random order, and on a box with no row and one with every row inside;
5. CUDA-event device times (plus_times, L2 evicted before each call) of
   each kernel, its plain version and one PyTorch library yardstick (the
   pair kernels at their launch, ``pairlist_launch``: the wrappers' input
   check reads back from the card, and a host round trip inside a timed
   call would count the host's time), beside the least time the card
   could take for the kernel's route (a kernel time below it fails the
   run; ``rank_count`` is also timed by the host's clock, launch overhead
   included; ``range_mask``, whose bound counts cols only where the row
   is inside the box, also with L2 left clean, ``cuda_ms_clean_l2``;
   ``segment_scan`` so at each of its four inputs, with ``torch.cumsum``
   of the 2^21 values beside it); the
   dense kernels' times under every semiring beside each route's bound
   (FMA pipe, ALU pipe and issue rates of the CUDA cores; three TF32
   products), the pair kernels' times under every semiring beside the
   same bounds, and the two masked kernels at the seeded 1/4 mask;
   then ``A @ B``, ``A.sqout(reduce=1)``, the uniform ``A.matmul(B)``,
   the uniform ``A.sqout(reduce=1)`` and two ingest snapshots (n=15 and
   the n=18 fallback) once more under ``spgemm.stage_timing()``, for
   where their time goes.

The kernels line lists the nine TPU kernels' ports and the port's own
``flash_attention_bwd`` (no TPU counterpart: it replaces XLA's
differentiation of the JAX package's attention reference path; route
``cuda-wgmma``, ``csrc/flash_attention_bwd_sm90.cu``, its launches the
train phase's, train-launch phase's and mesh phase's bf16 ones); the
flash row's launches add those phases' forward launches.

The last three lines of standard output are the kernels JSON line, the
card's name and power limit as ``nvidia-smi`` gives them, and the result
JSON line.  It exits non-zero, printing no result, when no CUDA device is
available or when the port is not next to it (``src/repro_torch``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# CUDA-core issue rates of one H100 SXM (132 SMs at the 1.98 GHz boost
# clock; CUDA C++ Programming Guide, arithmetic instruction throughput
# table, compute capability 9.0): FFMA/FADD/FMUL on the FMA pipe at 128 a
# clock per SM, compare/min/max (FMNMX) on the ALU pipe at 64, and one warp
# instruction a clock from each of 4 sub-partitions (128 a clock per SM)
SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9
FMA_PIPE_PER_CLK = 128
ALU_PIPE_PER_CLK = 64
ISSUE_PER_CLK = 128
# (FMA-pipe, ALU-pipe) instructions per MAC of each semiring's ⊕ and ⊗
SEMIRING_INSTRUCTIONS = {"plus_times": (1, 0), "max_plus": (1, 1),
                         "min_plus": (1, 1), "max_min": (0, 2),
                         "max_times": (1, 1), "and_or": (0, 2)}
SLEEP_CYCLES = 50_000_000  # about 25 ms of head start for cuda_ms
L2_FLUSH_BYTES = 256 << 20  # written before each timed call (L2: 50 MB)

DEVICE = "cuda:0"
N_UNIFORM = 12      # the paper's uniform workload, planned dense
N_FULL = 14         # the clustered size compared entry by entry
N_INGEST = 15       # the largest uniform size whose keys linearize to int32
N_FALLBACK = 65536  # triples of B inserted over the clustered A
MAIN_PATH_KERNELS = ("range_mask", "bsr_pairlist", "bsr_pairlist_reduce",
                     "semiring_matmul", "bsr_spgemm_reduce")
INGEST_PATH_KERNELS = ("rank_count", "range_mask")
CONTRACT_KERNELS = ("range_mask", "bsr_pairlist", "bsr_pairlist_reduce",
                    "rank_count")
SEMIRINGS = ("plus_times", "max_plus", "min_plus", "max_min", "max_times",
             "and_or")
SERVE_WORKERS = 4   # the D4M query server's worker pool
SERVE_ARCH = "qwen3-1.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
SERVE_SEED = 0
# the serve path's logits by the two attention routes, and decode against
# prefill: bf16 rounds P, each attention output and every matmul output
# (2^-9 relative each) at other places on the two routes, and those
# differences pass through 28 residual layers; relative L2 error of the
# logits at most 2^-4
LOGITS_REL_TOL = 2 ** -4
# the families phase: zamba2-7b and mamba2-130m uncut, the four other dense
# configs at full width with their depth cut to 2 layers; each serves batch
# 4 x 2048 and its decode is held against a prefill of the prompt plus
# FAMILY_TEACHER teacher-forced tokens (128 divides both lengths, so the
# SSD scan keeps its chunk of 128)
FAMILY_ARCHS = ("zamba2-7b", "mamba2-130m", "chatglm3-6b", "starcoder2-7b",
                "minicpm-2b", "chameleon-34b", "mixtral-8x22b",
                "deepseek-v3-671b", "whisper-medium")
FAMILY_DENSE_LAYERS = 2
# mixtral-8x22b (module step 9b) at full width and FAMILY_DENSE_LAYERS
# layers, with traffic of its own: a prompt of one and a half windows (4096
# + 2048), so that the prefill's window mask cuts the rows of the last 2048
# queries, its ring cache starts at slot 2048 and every decode step
# overwrites a slot; batch 2 keeps the decode check's no-drop prefill (C = S
# at capacity factor n_experts / top_k) within the card even in fp32
MOE_BATCH, MOE_PROMPT, MOE_GEN = 2, 6144, 32
# deepseek-v3-671b (module step 9c) at full width and 4 of its 61 layers:
# the three dense layers before its first MoE layer and one MoE layer (57
# cut).  Batch 2 x 8192 runs through the config's own prefill_chunk of
# 4096, so the second chunk attends at q_off 4096 over 8192 keys.  Its
# decode check prefills in chunks of 128: at the no-drop capacity (C =
# chunk) a 4096-token chunk's dispatch buffer alone would be [256, 2 x 4096,
# 7168] bf16, 30 GB, and 128 divides both 8192 and 8192 + FAMILY_TEACHER
MLA_ARCH = "deepseek-v3-671b"
MLA_BATCH, MLA_PROMPT, MLA_GEN = 2, 8192, 32
MLA_DECODE_CHUNK = 128
# whisper-medium (module step 9d) uncut: 24 encoder and 24 decoder layers
# over seeded normal frame embeddings [4, 1500, 1024] (the stub frontend's
# output), batch 4 x 2048 (its learned-position table holds max_seq
# 544,768 rows; the published decoder context is 448), 32 tokens.  The
# flash kernel runs non-causally in the encoder and in every
# cross-attention, prefill and decode alike: 72 launches a prefill and 24
# a decode step
ENCDEC_ARCH, ENCDEC_GEN = "whisper-medium", 32
FAMILY_LAYERS = {MLA_ARCH: 4}             # the other dense and MoE ones: 2
FAMILY_TRAFFIC = {"mixtral-8x22b": (MOE_BATCH, MOE_PROMPT),
                  MLA_ARCH: (MLA_BATCH, MLA_PROMPT)}   # the others: 4 x 2048
FAMILY_GEN = {"zamba2-7b": 32, "mamba2-130m": 32,      # the dense ones: 8
              "mixtral-8x22b": MOE_GEN, MLA_ARCH: MLA_GEN,
              ENCDEC_ARCH: ENCDEC_GEN}
# the serve path's prompt in two windows (qwen3-1.7b's chunked prefill,
# held to its one-shot prefill)
SERVE_PREFILL_CHUNK = 1024
FAMILY_TEACHER = 128
LORA_B_STD = 0.1    # zamba2's LoRA b: a @ b then about wq's own scale


def log(*a):
    print(*a, flush=True)


def cuda_core_bound_ms(semiring: str, macs: int) -> float:
    """Least CUDA-core time of ``macs`` semiring MACs: the busier of the
    FMA pipe, the ALU pipe and instruction issue."""
    fma, alu = SEMIRING_INSTRUCTIONS[semiring]
    per_sm = max(fma / FMA_PIPE_PER_CLK, alu / ALU_PIPE_PER_CLK,
                 (fma + alu) / ISSUE_PER_CLK)
    return macs * per_sm / (SM_COUNT * SM_CLOCK_HZ) * 1e3


def tf32x3_bound_ms(macs: int) -> float:
    """Least time of the TF32 route: three tensor-core products."""
    return 3 * 2 * macs / TF32_FLOP_PER_S * 1e3


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def clocks_under_load(fn, calls: int) -> str:
    """The card's SM clock, power draw and temperature read while ``calls``
    queued calls of ``fn`` run (the bounds assume the 1.98 GHz boost)."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(calls):
        fn()
    line = nvidia_smi_line("clocks.sm,power.draw,temperature.gpu")
    torch.cuda.synchronize()
    return line


def cuda_ms(fn, repeats: int, warmup: int = 1) -> float:
    """Mean device milliseconds of one call, CUDA events around each call.
    Before each call a write of a buffer five times the card's 50 MB L2
    evicts what the last call left there, so each call reads its inputs
    from HBM, as a caller that ran other work in between finds them.  A
    sleep kernel ahead of the calls lets the host enqueue them before the
    card reaches them, so a call's host work (argument checks, allocation,
    the launch itself) is not counted where it is shorter than the
    device's: this is the kernels' own time.  The write leaves L2 full of
    dirty lines, which the call's own reads evict: their write-back to HBM
    falls inside the timed window, as after a caller that wrote."""
    flush = _l2_flush_buffer()
    return _event_ms(fn, repeats, warmup, flush.zero_)


def cuda_ms_clean_l2(fn, repeats: int, warmup: int = 1) -> float:
    """As :func:`cuda_ms`, with L2 evicted by a read instead of a write:
    before each call a sum over a second buffer five times L2's size
    leaves only clean lines there, so no write-back of an earlier write
    falls inside the timed window.  Beside ``cuda_ms`` it tells a kernel's
    own limit from the dirty L2 that ``cuda_ms`` leaves it."""
    clean = _l2_flush_buffer(clean=True)
    return _event_ms(fn, repeats, warmup, clean.sum)


def _event_ms(fn, repeats: int, warmup: int, evict) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        evict()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / repeats


_FLUSH = {}


def _l2_flush_buffer(clean: bool = False):
    """The 256 MB eviction buffer: written before each call (``cuda_ms``),
    or zeroed once and then only read (``cuda_ms_clean_l2``)."""
    import torch
    if clean not in _FLUSH:
        make = torch.zeros if clean else torch.empty
        _FLUSH[clean] = make(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                             device=DEVICE)
    return _FLUSH[clean]


def host_ms(fn, repeats: int) -> float:
    """Mean milliseconds per call by the host's clock, each call's device
    work included (events back to back would measure the same where the
    host is the slower side): what a caller waiting on one call sees."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / repeats


# -- kernel inputs at the main path's shapes ------------------------------------

def quarter_values(n: int, gen, device):
    """n values in {1/4, 2/4, ..., 2}: every fp32 sum of their products is
    exact at these sizes, whatever the order."""
    import torch
    return torch.randint(1, 9, (n,), generator=gen).to(device,
                                                         torch.float32) / 4


def pairlist_inputs(a, b, axis, gen):
    """Packed tiles (random quarter values; ``tiles(sr, normal=True)``:
    standard normal values) and pair lists of ``a @ b`` as the planner
    makes them; ``axis`` regroups for the fused reduce."""
    import torch

    from repro_torch.core import spgemm
    from repro_torch.core.semiring import PLUS_TIMES

    a, b, ks = spgemm._contraction_aligned(a, b, PLUS_TIMES)
    ra, ca, _ = spgemm._valid_host(a)
    rb, cb, _ = spgemm._valid_host(b)
    plan = spgemm.plan_matmul(ra, ca, rb, cb, len(a.row_space), len(ks),
                              len(b.col_space))
    dev = a.device
    va = quarter_values(len(ra), gen, dev)
    vb = quarter_values(len(rb), gen, dev)
    ngen = torch.Generator().manual_seed(7)   # leaves `gen`'s draws as they were
    na = torch.randn(len(ra), generator=ngen).to(dev)
    nb = torch.randn(len(rb), generator=ngen).to(dev)

    def tiles(sr, normal=False):
        at = spgemm.pack_tiles(na if normal else va, plan.a_tile_of,
                               plan.a_lr, plan.a_lc, len(plan.a_blocks), 128,
                               128, sr.zero)
        bt = spgemm.pack_tiles(nb if normal else vb, plan.b_tile_of,
                               plan.b_lr, plan.b_lc, len(plan.b_blocks), 128,
                               128, sr.zero)
        return at, bt

    def up(x):
        return torch.from_numpy(x.astype("int32")).to(dev)

    if axis is None:
        pairs = (up(plan.pair_a), up(plan.pair_b), up(plan.pair_c))
        n_out = len(plan.c_blocks)
    else:
        pa, pb, po, o_uniq = spgemm.reduce_pairs(plan, axis)
        pairs = (up(pa), up(pb), up(po))
        n_out = len(o_uniq)
    return plan, tiles, pairs, n_out


def pair_products_f64(at, bt, pa, pb, po, n_out, chunk=1024):
    """Each output's Σ_p A_p·B_p and Σ_p |A_p|·|B_p| over its pairs, in
    fp64 ([n_out, 128, 128] each)."""
    import torch
    c = torch.zeros((n_out, 128, 128), dtype=torch.float64, device=at.device)
    m = torch.zeros_like(c)
    pa, pb, po = (x.long() for x in (pa, pb, po))
    for p0 in range(0, pa.shape[0], chunk):
        x = at[pa[p0:p0 + chunk]].double()
        y = bt[pb[p0:p0 + chunk]].double()
        c.index_add_(0, po[p0:p0 + chunk], torch.bmm(x, y))
        m.index_add_(0, po[p0:p0 + chunk], torch.bmm(x.abs(), y.abs()))
    return c, m


def dense_inputs(a, b, gen):
    """The dense strategy's operands (densified adjacencies) with random
    quarter values on the stored entries, per semiring zero, and A's
    block mask as ``matmul_reduce`` builds it."""
    import torch

    from repro_torch.core import spgemm
    from repro_torch.core.semiring import PLUS_TIMES
    from repro_torch.kernels.bsr_spgemm.ops import make_block_mask

    a, b, _ = spgemm._contraction_aligned(a, b, PLUS_TIMES)
    da, db = spgemm._densify_aligned(a.logical(), b.logical(), PLUS_TIMES)
    mask = make_block_mask(a.rows, a.cols, a.valid_mask(),
                           da.shape[0] // 128, da.shape[1] // 128)
    qa = quarter_values(da.numel(), gen, da.device).view_as(da)
    qb = quarter_values(db.numel(), gen, db.device).view_as(db)

    def operands(sr):
        z = torch.tensor(sr.zero, device=da.device)
        return torch.where(da != 0, qa, z), torch.where(db != 0, qb, z)
    return operands, mask, (da.shape[0], da.shape[1], db.shape[1])


def masked_inputs(gen, device, size=4096):
    """Block-masked operands at ``size``^3: a seeded mask keeping about 1/4
    of A's tiles, and random quarter values on 1/16 of the entries of A
    (absent tiles included, which the kernels must skip) and of B.  At
    that density every fp32 sum of the reduce stays below 2^20, so it is
    exact in any order."""
    import torch
    nb = size // 128
    mask = (torch.rand((nb, nb), generator=gen) < 0.25).to(torch.int32)
    qa = quarter_values(size * size, gen, device).view(size, size)
    qb = quarter_values(size * size, gen, device).view(size, size)
    pa = (torch.rand((size, size), generator=gen) < 1 / 16).to(device)
    pb = (torch.rand((size, size), generator=gen) < 1 / 16).to(device)

    def operands(sr):
        z = torch.tensor(sr.zero, device=device)
        return torch.where(pa, qa, z), torch.where(pb, qb, z)
    return operands, mask.to(device)


def rank_count_inputs(raw, base):
    """The linearized (row, col) keys that the ingest path's full
    snapshot hands ``rank_count``: the base's and the delta's unique keys
    on the union keyspaces, sorted and sentinel-padded to the base's
    capacity and to the delta buffer's (a power of two)."""
    import numpy as np
    import torch

    from repro_torch.core import KeySpace
    from repro_torch.core.coo import SENT
    from repro_torch.ingest.table import _next_pow2
    rows, cols, rows2, cols2, _ = raw
    rs = KeySpace(np.concatenate([rows, rows2]))
    cs = KeySpace(np.concatenate([cols, cols2]))

    def keys(r, c, cap):
        k = np.unique(rs.rank(r)[0].astype(np.int64) * len(cs)
                      + cs.rank(c)[0])
        out = np.full(cap, SENT, np.int32)
        out[:len(k)] = k
        return torch.from_numpy(out).to(base.device)
    return (keys(rows, cols, base.capacity),
            keys(rows2, cols2, _next_pow2(len(rows2))))


def max_err(got, want) -> float:
    import torch
    same = (got == want) | (torch.isinf(got) & torch.isinf(want)
                            & (torch.sign(got) == torch.sign(want)))
    if bool(same.all()):
        return 0.0
    d = (got.double() - want.double()).abs()
    return float(torch.where(same, torch.zeros_like(d), d).max())


def flash_check(got, want, q, k, v, *, p_roundings=1, **masks):
    """A bf16 flash output against its plain version, all [B,H,S,D]:
    (max |err|, largest |err| / elementwise bound, relative L2 error).
    The bound (``bf16_error_bound``): each rounding of P to bf16 moves o_id
    by at most 2^-8·(P·|V|)_id, each rounding of the output by at most
    2^-8·|o_id|, so it follows each row's own scale.  The relative L2 limit
    is 2^-7: those roundings are each at most 2^-8 relative and do not all
    point one way."""
    from repro_torch.kernels.flash_attention.ref import bf16_error_bound
    bound = bf16_error_bound(q, k, v, want, p_roundings=p_roundings, **masks)
    err = (got.float() - want.float()).abs()
    worst = float((err / bound.clamp_min(1e-30)).max())
    return max_err(got.float(), want.float()), worst, rel_err(got, want)


def visible_pairs(sq, sk, causal, window=None, q_off=0) -> int:
    """(query, key) pairs that the masks leave visible, per (batch, head)."""
    total = 0
    for i in range(sq):
        pos = q_off + i
        hi = min(sk, pos + 1) if causal else sk
        lo = max(0, pos - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def rel_err(got, want) -> float:
    d = (got.double() - want.double()).norm()
    return float(d / want.double().norm())


def torch_calls(fn) -> int:
    """The torch functions and tensor methods that one call of ``fn``
    dispatches from Python (each one host-side dispatch, most of them one
    kernel launch)."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


# the probe programs that run a pair kernel: (+, ×) on the TF32 route
PAIR_CONTRACTS = ("spgemm.matmul", "spgemm.matmul_reduce", "dist.matmul_bsr")
# the most pairs any output tile or block of the probes takes
PROBE_PAIRS = 16


def contracts_phase(mesh, report, failures) -> None:
    """Every ``@contract``'s programs on the card (``verify_all`` over the
    probes' seeded inputs, the dist programs on ``mesh``), counted: its
    collectives by family, host reads (device-to-host copies included),
    largest intermediate beside the dense budget and peak memory beside
    the budget's float32 bytes plus the inputs'; each program's output
    held against the same call on the plain route
    (``cuda_lib.plain_route``) — exactly, and the pair kernels' (+, ×)
    within the TF32 route's bound: the inputs are positive, so
    Σ|A|·|B| of an output is the plain output itself, with K = 128 x
    the probe's 16 pairs and the reduce's fp32 fold (2^-23 a term of 128
    folded outputs).  A violation, a disagreement or a kernel of the
    probes that did not launch fails the run."""
    import torch
    from repro_torch.analysis import CONTRACT_REGISTRY, verify_all
    from repro_torch.analysis.report import tensors_in
    from repro_torch.kernels import LAUNCHES, cuda_lib, reset_launch_counts
    from repro_torch.kernels.semiring_matmul.ref import TF32X3_C1

    k = 128 * PROBE_PAIRS
    tf32_scale = (TF32X3_C1 * 2.0 ** -22 + -(-k // 32) * 2.0 ** -24
                  + 128 * 2.0 ** -23)
    rows, ran = {}, set()

    def on_program(entry, label, thunk, got, rep, reason):
        name = f"{entry}[{label}]"
        if reason is None:
            ran.add(entry)
        else:
            rows[name] = {"not_run": reason}
            log(f"[contracts] {name} not run: {reason}")
            return
        with cuda_lib.plain_route():
            want = thunk()
        gots, wants = list(tensors_in(got)), list(tensors_in(want))
        err, ok = 0.0, len(gots) == len(wants)
        for g, w in zip(gots, wants):
            if g.shape != w.shape or g.dtype != w.dtype:
                ok = False
                continue
            e = max_err(g, w) if g.is_floating_point() else float(
                (g != w).sum())
            err = max(err, e)
            if g.is_floating_point() and entry in PAIR_CONTRACTS:
                ok &= bool(((g.double() - w.double()).abs()
                            <= tf32_scale * w.double().abs()).all())
            else:
                ok &= e == 0.0
        budget = CONTRACT_REGISTRY[entry].budget(rep)
        rows[name] = {
            "collectives": {f: v for f, v in rep.collective_counts.items()
                            if v},
            "host_transfers": rep.host_transfers,
            "max_intermediate": rep.max_intermediate_elems,
            "max_intermediate_op": rep.max_intermediate_op,
            "budget": budget, "peak_bytes": rep.peak_bytes,
            "peak_limit_bytes": 4 * budget + rep.input_bytes,
            "max_abs_err": err}
        log(f"[contracts] {name} " + json.dumps(rows[name]))
        if not ok:
            failures.append(f"contract program {name} disagrees with its "
                            f"plain route (max |err| {err})")

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = verify_all(device=mesh.device, mesh=mesh, on_program=on_program)
    torch.cuda.synchronize()
    report["contracts_s"] = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    report["launches"]["contracts"] = launches
    report["contracts"] = rows
    held = sum(1 for n, v in results.items() if n in ran and not v)
    log(f"[contracts] {held} of {len(results)} contracts held on "
        f"{nvidia_smi_line()} in {report['contracts_s']:.1f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for viols in results.values():
        failures += [f"contract {v}" for v in viols]
    for k in CONTRACT_KERNELS:
        if launches[k] < 1:
            failures.append(f"kernel {k} was not launched by the contract "
                            f"probes")


def serve_phase(dev, report, failures) -> dict:
    """The serve path (counted), its route and decode checks, and the
    flash-attention kernel alone at the path's shape.  Returns the
    kernel's row of the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as layers
    from repro_torch.models import model as M

    cfg = get_config(SERVE_ARCH)
    b, p, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    t0 = time.perf_counter()
    gen = M.make_generator(SERVE_SEED, dev)
    params = M.init(gen, cfg)
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev,
                            dtype=torch.int32)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "params": M.param_count(params),
           "weights_gb": torch.cuda.memory_allocated() / 1e9}

    # the counted run: prefill, repack, greedy decode
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = serve_lib.serve(params, cfg, prompts, g)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    out.update(prefill_s=res["prefill_s"], decode_s=res["decode_s"],
               decode_ms_per_token=1e3 * res["decode_s"] / g,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    report["launches"] = {"serve": launches}
    log(f"[serve path] {SERVE_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {out['params']:,} parameters (bf16, seed "
        f"{SERVE_SEED}); batch {b}, prompt {p}, {g} greedy tokens")
    log(f"[serve path] prefill {out['prefill_s']:.3f} s, decode "
        f"{out['decode_ms_per_token']:.2f} ms/token, peak device memory "
        f"{out['peak_mem_gb']:.2f} GB (weights {out['weights_gb']:.2f} GB)")
    step_cache = M.init_cache(cfg, b, 2, device=dev)
    out["torch_calls_per_decode_step"] = torch_calls(
        lambda: make_serve_step(cfg)(params, step_cache, prompts[:, :1], 0))
    del step_cache
    log(f"[serve path] launches {launches}; torch calls per decode step "
        f"{out['torch_calls_per_decode_step']} (host dispatches)")
    if (launches["flash_attention_wgmma"] != cfg.n_layers
            or launches["flash_attention"] != 0):
        failures.append(f"flash_attention launched "
                        f"{launches['flash_attention_wgmma']} times on the "
                        f"wgmma route and {launches['flash_attention']} on "
                        f"the fp32 route in one prefill of {cfg.n_layers} "
                        f"layers (want {cfg.n_layers} and 0)")
    toks = res["tokens"]
    if not (toks.shape == (b, g) and bool((toks >= 0).all())
            and bool((toks < cfg.vocab).all())
            and bool(torch.isfinite(res["logits"]).all())
            and bool(torch.isfinite(res["prefill_logits"]).all())):
        failures.append("serve path: tokens out of range or logits not "
                        "finite")
    log(f"[serve path] generated ids (row 0): {toks[0, :16].tolist()}")

    # the kernel route against the plain route, same weights and prompts
    plain_logits, plain_cache = make_prefill_step(
        cfg.replace(attn_impl="ref"))(params, prompts)
    del plain_cache
    checks = {"prefill logits, kernel vs plain route": rel_err(
        res["prefill_logits"], plain_logits)}
    agree = float((res["prefill_logits"].argmax(-1)
                   == plain_logits.argmax(-1)).float().mean())
    # decode against prefill: the logits at position p
    one = serve_lib.serve(params, cfg, prompts, 1)
    ext_logits, ext_cache = make_prefill_step(cfg)(
        params, torch.cat([prompts, one["tokens"]], dim=1))
    del ext_cache
    checks["decode step vs prefill of prompt + token"] = rel_err(
        one["logits"], ext_logits)
    # chunked (window-wise) prefill: the prompt in windows of
    # SERVE_PREFILL_CHUNK, the second at q_off 1024 under GQA, against the
    # one-shot prefill; flash launches once per layer and window
    reset_launch_counts()
    chunk_logits, chunk_cache = make_prefill_step(
        cfg.replace(prefill_chunk=SERVE_PREFILL_CHUNK))(params, prompts)
    torch.cuda.synchronize()
    n_windows = p // SERVE_PREFILL_CHUNK
    chunk_launches = (LAUNCHES["flash_attention_wgmma"],
                      LAUNCHES["flash_attention"])
    del chunk_cache
    checks[f"chunked prefill ({n_windows} x {SERVE_PREFILL_CHUNK}) vs "
           f"one-shot"] = rel_err(chunk_logits, res["prefill_logits"])
    log(f"[serve check] chunked prefill of {SERVE_ARCH}: flash_attention "
        f"launches {chunk_launches[0]} wgmma / {chunk_launches[1]} fp32, "
        f"want {n_windows * cfg.n_layers} / 0")
    out["chunked_prefill_launches"] = chunk_launches[0]
    if chunk_launches != (n_windows * cfg.n_layers, 0):
        failures.append(f"chunked prefill of {SERVE_ARCH}: flash launches "
                        f"{chunk_launches} (want "
                        f"{(n_windows * cfg.n_layers, 0)})")
    for name, err in checks.items():
        ok = err <= LOGITS_REL_TOL
        log(f"[serve check] {'ok  ' if ok else 'FAIL'} {name}: relative L2 "
            f"error {err:.3e} (tolerance {LOGITS_REL_TOL:.3e})")
        if not ok:
            failures.append(f"serve check {name}: {err}")
    log(f"[serve check] argmax agreement of the two routes' prefill "
        f"logits: {agree:.3f}")
    out["checks"] = checks
    out["argmax_agreement"] = agree
    del res, one, plain_logits, ext_logits, chunk_logits

    # layer 0's attention output by both routes
    lp = params["dense_stack"][0]
    pos = torch.arange(p, dtype=torch.int32, device=dev)
    h = layers.apply_norm(lp["attn_norm"], layers.embed(
        params["embed"], prompts).to(cfg.compute_dtype), kind=cfg.norm)
    q, k, v = attn.gqa_qkv(lp["attn"], cfg, h, pos)
    kw = dict(q_positions=pos, k_positions=pos, causal=True,
              chunk=cfg.attn_chunk)
    o_kernel = attn.chunked_attention(q, k, v, impl="cuda", **kw)
    o_plain = attn.chunked_attention(q, k, v, impl="ref", **kw)
    # the plain route rounds P to bf16 too: two roundings of P
    errs = {"layer 0 attention, kernel vs plain route": flash_check(
        *(x.transpose(1, 2) for x in (o_kernel, o_plain, q, k, v)),
        p_roundings=2, causal=True)}
    del params, o_kernel, o_plain, h

    # the kernel alone on layer 0's q, k, v ([B, H, S, D])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    del q, k, v
    cases = {"path shape": dict(causal=True),
             "window 512": dict(causal=True, window=512),
             "q_off 1536, 512 x 2048": dict(causal=True, q_off=p - 512)}
    for name, c in cases.items():
        qc = qt[:, :, -512:] if "q_off" in c else qt
        want = flash_attention_ref(qc, kt, vt, **c)
        got = fa_ops.flash_attention_cuda(qc, kt, vt, **c)
        errs[f"kernel vs plain, {name}"] = flash_check(got, want, qc, kt, vt,
                                                       **c)
        del got, want
    for name, (err, worst, rel) in errs.items():
        ok = worst <= 1.0 and rel <= 2 ** -7
        log(f"[kernel check] {'ok  ' if ok else 'FAIL'} flash_attention "
            f"{name}: max |err| {err:.3e}, largest |err| / elementwise "
            f"bound {worst:.3f} (limit 1), relative L2 {rel:.3e} (limit "
            f"{2 ** -7:.3e})")
        if not ok:
            failures.append(f"flash_attention {name}: |err|/bound {worst}, "
                            f"relative L2 {rel}")
    torch.cuda.synchronize()

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    ms = cuda_ms(lambda: fa_ops.flash_attention_cuda(qt, kt, vt, causal=True),
                 10)
    plain_ms = cuda_ms(lambda: flash_attention_ref(qt, kt, vt, causal=True),
                       3)
    lib_ms = cuda_ms(library, 10)
    bb, hh, ss, dd = qt.shape
    n_bytes = 2 * (qt.numel() + kt.numel() + vt.numel() + qt.numel())
    n_ops = 4 * dd * visible_pairs(ss, ss, True) * bb * hh
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    log(f"[time] flash_attention (bf16, wgmma route): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
        f"(scaled_dot_product_attention), kernel / library "
        f"{ms / lib_ms:.3f}, bound {bound:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}; "
        f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP), "
        f"{100 * bound / ms:.1f}% of bound")
    out["flash_ms"] = {"kernel": ms, "plain": plain_ms, "library": lib_ms,
                       "bound": bound}
    report["serve"] = out
    return {"name": "flash_attention", "route": "cuda-wgmma",
            "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:76",
            "launches": launches["flash_attention_wgmma"],
            "max_abs_err": errs["kernel vs plain, path shape"][0],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}


def sdpa_backend(q, k, v, mask) -> str:
    """The backend that ``scaled_dot_product_attention``'s dispatcher picks
    for these inputs, an explicit mask and ``enable_gqa``."""
    import torch
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, attn_mask=mask, dropout_p=0.0, is_causal=False, scale=None,
        enable_gqa=True)).name


def heads_sliced(fn, q, k, v, n):
    """``fn(q, k, v)`` over ``n`` blocks of heads (q's and k/v's split
    alike, so a GQA group stays whole), concatenated on the head axis: the
    plain version's fp32 scores at MLA's chunk shape are 34 GB whole."""
    if n == 1:
        return fn(q, k, v)
    import torch
    hq, hk = q.shape[1] // n, k.shape[1] // n
    return torch.cat([fn(q[:, i * hq:(i + 1) * hq], k[:, i * hk:(i + 1) * hk],
                         v[:, i * hk:(i + 1) * hk]) for i in range(n)], dim=1)


def flash_alone(name, b, h, kv, s, d, gen, failures, window=None, *,
                dv=None, sk=None, q_off=0, slices=1, label=None,
                causal=True) -> dict:
    """``flash_attention`` alone at one config's attention shape (bf16,
    causal unless ``causal=False``, with the config's sliding window if it
    has one; seeded normal q [b, h, s, d], k [b, kv, sk, d] and v [b, kv,
    sk, dv], queries from ``q_off``): held against its plain version within
    ``flash_check``'s bounds, and timed beside its bound and SDPA.  SDPA
    has no window or query offset argument (``is_causal`` aligns the
    diagonal top-left), so a window or an offset goes to it as an explicit
    boolean mask; a non-causal shape goes to it with no mask (the backend
    its dispatcher picks is printed for both).  ``slices`` > 1 runs the
    plain version (and the bound) over that many blocks of heads, timed as
    one call of all of them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dv, sk = dv or d, sk or s
    q = torch.randn((b, h, s, d), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    k = torch.randn((b, kv, sk, d), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    v = torch.randn((b, kv, sk, dv), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    masks = dict(causal=causal, window=window, q_off=q_off)

    def plain(qq, kk, vv):
        return flash_attention_ref(qq, kk, vv, **masks)
    want = heads_sliced(plain, q, k, v, slices)
    got = fa_ops.flash_attention_cuda(q, k, v, **masks)
    parts = [flash_check(*(x[:, i * (h // slices):(i + 1) * (h // slices)]
                           for x in (got, want, q)),
                         k[:, i * (kv // slices):(i + 1) * (kv // slices)],
                         v[:, i * (kv // slices):(i + 1) * (kv // slices)],
                         **masks) for i in range(slices)]
    err, worst = max(p[0] for p in parts), max(p[1] for p in parts)
    rel = rel_err(got, want)
    del got, want
    ok = worst <= 1.0 and rel <= 2 ** -7
    shape = (f"q {b} x {h} x {s} x {d}, k {b} x {kv} x {sk} x {d}, v "
             f"{b} x {kv} x {sk} x {dv}, "
             + ("causal" if causal else "non-causal")
             + (f", window {window}" if window else "")
             + (f", q_off {q_off}" if q_off else ""))
    label = label or f"{name}'s shape"
    log(f"[kernel check] {'ok  ' if ok else 'FAIL'} flash_attention at "
        f"{label} ({shape}, GQA {h // kv}): max |err| "
        f"{err:.3e}, largest |err| / elementwise bound {worst:.3f} (limit "
        f"1), relative L2 {rel:.3e} (limit {2 ** -7:.3e})")
    if not ok:
        failures.append(f"flash_attention at {label}: |err|/bound "
                        f"{worst}, relative L2 {rel}")
    torch.cuda.synchronize()
    if not causal and window is None:
        backend = f"no mask, {sdpa_backend(q, k, v, None)}"

        def library():
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    elif window is None and q_off == 0 and sk == s:
        backend = "is_causal"

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    else:
        qpos = q_off + torch.arange(s, device=DEVICE)[:, None]
        kpos = torch.arange(sk, device=DEVICE)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= (qpos - kpos) < window
        backend = f"boolean mask, {sdpa_backend(q, k, v, mask)}"

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
    ms = cuda_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **masks), 10)
    plain_ms = cuda_ms(lambda: heads_sliced(plain, q, k, v, slices), 2)
    try:
        lib_ms = cuda_ms(library, 10)
    except RuntimeError as exc:       # no SDPA backend takes these inputs
        lib_ms, backend = None, f"{backend}: {str(exc).splitlines()[0]}"
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + b * h * s * dv)
    n_ops = (2 * (d + dv) * visible_pairs(s, sk, causal, window=window,
                                          q_off=q_off) * b * h)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    lib = ("n/a" if lib_ms is None
           else f"{lib_ms:.4f} ms (scaled_dot_product_attention, {backend}), "
           f"kernel / library {ms / lib_ms:.3f}")
    log(f"[time] flash_attention at {label}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms"
        + (f" ({slices} blocks of heads)" if slices > 1 else "")
        + f", library {lib}, bound {bound:.4f} ms ({by}; "
        f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP), "
        f"{100 * bound / ms:.1f}% of bound")
    if ms < bound:
        failures.append(f"flash_attention at {label}: {ms} ms below "
                        f"its bound {bound} ms")
    return {"shape": shape, "max_abs_err": err, "err_over_bound": worst,
            "rel_l2": rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": backend, "bound_ms": bound,
            "bound_by": by}


def serve_checks(cfg, params, prompts, p, decode_cfg=None, enc=None):
    """The route check (the kernel route's prefill logits against the
    plain route's) and the decode check (``FAMILY_TEACHER`` teacher-forced
    decode steps after the prompt against one prefill over all those
    tokens), as relative L2 errors; the plain route's logits; and, for a
    MoE config, the (token, layer) routes whose set of experts differs
    between the two routes' prefills (None without MoE).  The decode check
    runs at ``decode_cfg`` on both sides (default ``cfg``): a MoE config
    passes one whose capacity no expert can exceed, since a prefill may
    drop entries that decode, one token at a time, never drops.  An
    encoder-decoder's prefills all take the frame embeddings ``enc``."""
    import torch

    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import moe as moe_lib

    decode_cfg = decode_cfg or cfg
    with moe_lib.routing_log() as plain_routes:
        plain, _ = make_prefill_step(cfg.replace(attn_impl="ref"))(
            params, prompts[:, :p], enc)
    with moe_lib.routing_log() as kernel_routes:
        logits, cache = make_prefill_step(cfg)(params, prompts[:, :p], enc)
    checks = {"prefill logits, kernel vs plain route": rel_err(logits, plain)}
    flips = None
    if cfg.moe:
        flips = [int((torch.sort(a["idx"], -1).values
                      != torch.sort(b["idx"], -1).values).any(-1).sum())
                 for a, b in zip(kernel_routes, plain_routes)]
    del plain_routes, kernel_routes
    if decode_cfg is not cfg:
        del cache
        logits, cache = make_prefill_step(decode_cfg)(params, prompts[:, :p],
                                                      enc)
    cache = serve_lib.repack_cache(cache, p + FAMILY_TEACHER,
                                   window=serve_lib.attention_window(cfg))
    step = make_serve_step(decode_cfg)
    for t in range(p, p + FAMILY_TEACHER):
        logits, cache = step(params, cache, prompts[:, t:t + 1], t)
    del cache
    ext_logits, _ = make_prefill_step(decode_cfg)(params, prompts, enc)
    checks[f"{FAMILY_TEACHER} decode steps vs prefill of "
           f"{p + FAMILY_TEACHER}"] = rel_err(logits, ext_logits)
    return checks, plain, flips


def to_fp32(tree):
    """Every floating leaf of a parameter tree cast to fp32, in place (each
    bf16 leaf is freed as its copy replaces it)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, leaf in list(items):
        if isinstance(leaf, (dict, list)):
            to_fp32(leaf)
        else:
            tree[key] = leaf.float()
    return tree


def flash_launches_wanted(cfg, n_chunks: int, g: int) -> int:
    """The flash launches of one served run: one per attention layer or
    shared-block invocation and prefill chunk; whisper's prefill adds its
    encoder layers and a cross-attention per decoder layer, and its decode
    one cross-attention per decoder layer and step (no ``k_valid_len``)."""
    from repro_torch.models.model import n_invocations
    if cfg.family == "encdec":
        return (cfg.encdec["enc_layers"] + 2 * cfg.n_layers
                + g * cfg.n_layers)
    return n_chunks * (n_invocations(cfg) if cfg.family == "hybrid"
                       else 0 if cfg.family == "ssm" else cfg.n_layers)


def families_phase(dev, report, failures) -> int:
    """Module steps 9a-9d on the card: each config of ``FAMILY_ARCHS``
    served through ``repro_torch.launch.serve`` (counted: ``flash_attention``
    as :func:`flash_launches_wanted` says, all on the wgmma route), its
    route and decode checks, and the kernel alone at its shape (deepseek-v3:
    at both chunks' shapes; whisper-medium: at its four).  For the MoE
    configs also the share of routed (token, expert) entries that the
    served prefill dropped at capacity, per layer, and the routes whose
    experts differ between the check's two attention routes.  Returns the
    flash launches of the counted runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib

    out, flash_launches = {}, 0
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        full_layers = cfg.n_layers
        if cfg.family in ("dense", "moe"):
            cfg = cfg.replace(n_layers=FAMILY_LAYERS.get(
                arch, FAMILY_DENSE_LAYERS))
        b, p = FAMILY_TRAFFIC.get(arch, (SERVE_BATCH, SERVE_PROMPT))
        g = FAMILY_GEN.get(arch, 8)
        n_chunks = p // cfg.prefill_chunk if cfg.prefill_chunk else 1
        t0 = time.perf_counter()
        gen = M.make_generator(SERVE_SEED, dev)
        params = M.init(gen, cfg)
        if "shared_lora" in params:     # b's zero init: a @ b would be 0
            params["shared_lora"]["b"].normal_(0.0, LORA_B_STD, generator=gen)
        prompts = torch.randint(0, cfg.vocab, (b, p + FAMILY_TEACHER),
                                generator=gen, device=dev, dtype=torch.int32)
        encdec = cfg.family == "encdec"
        enc = serve_lib.frame_embeddings(cfg, b, gen) if encdec else None
        torch.cuda.synchronize()
        row = {"layers": cfg.n_layers, "params": M.param_count(params),
               "init_s": time.perf_counter() - t0,
               "weights_gb": torch.cuda.memory_allocated() / 1e9}
        want = flash_launches_wanted(cfg, n_chunks, g)
        cut = (f", {full_layers - cfg.n_layers} of {full_layers} layers cut"
               if cfg.n_layers < full_layers else "")
        chunked = (f", prefill in {n_chunks} chunks of {cfg.prefill_chunk}"
                   if cfg.prefill_chunk else "")
        if encdec:
            chunked = (f", {cfg.encdec['enc_frames']} frames of seeded "
                       f"normal embeddings, {cfg.encdec['enc_layers']} "
                       f"encoder layers")

        # a warm-up prefill outside the count (cuBLAS and the caching
        # allocator meet these shapes here), then the counted run: prefill,
        # repack, greedy decode
        t0 = time.perf_counter()
        make_prefill_step(cfg)(params, prompts[:, :p], enc)
        torch.cuda.synchronize()
        row["cold_prefill_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with moe_lib.routing_log() as routes:
            res = serve_lib.serve(params, cfg, prompts[:, :p], g, enc)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        flash_launches += launches["flash_attention_wgmma"]
        row.update(prefill_s=res["prefill_s"],
                   decode_ms_per_token=1e3 * res["decode_s"] / g,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches={k: n for k, n in launches.items() if n})
        # a zeroed decode cache (whisper's with its cross K/V)
        step_cache = M.init_cache(cfg, b, 2, device=dev)
        row["torch_calls_per_decode_step"] = torch_calls(
            lambda: make_serve_step(cfg)(params, step_cache, prompts[:, :1],
                                         0))
        del step_cache
        log(f"[serve path] {arch}: prefill {row['prefill_s']:.3f} s (cold "
            f"{row['cold_prefill_s']:.3f} s), decode "
            f"{row['decode_ms_per_token']:.2f} ms/token, peak device memory "
            f"{row['peak_mem_gb']:.2f} GB, torch calls per decode step "
            f"{row['torch_calls_per_decode_step']} ({cfg.family}, "
            f"{cfg.n_layers} layers{cut}, d_model {cfg.d_model}, "
            f"{row['params']:,} parameters, weights "
            f"{row['weights_gb']:.2f} GB; batch {b}, prompt {p}{chunked}, "
            f"{g} greedy tokens; flash_attention launches "
            f"{launches['flash_attention_wgmma']} wgmma / "
            f"{launches['flash_attention']} fp32, want {want} / 0)")
        if (launches["flash_attention_wgmma"] != want
                or launches["flash_attention"] != 0):
            failures.append(f"{arch}: flash_attention launched "
                            f"{launches['flash_attention_wgmma']} times on "
                            f"the wgmma route and "
                            f"{launches['flash_attention']} on the fp32 "
                            f"route in one served run (want {want} and 0)")
        if cfg.moe:
            # the prefill's records come first, chunk by chunk and in a
            # chunk one a layer; then decode's
            n_moe = len(params["moe_stack"])
            n_pre = n_moe * n_chunks
            pre = routes[:n_pre]
            m = cfg.moe
            cap = max(1, round(p // n_chunks * m["top_k"] / m["n_experts"]
                               * m["capacity_factor"]))
            row["dropped_share"] = [
                sum(int(r["dropped"]) for r in pre[i::n_moe])
                / sum(r["routed"] for r in pre[i::n_moe])
                for i in range(n_moe)]
            decode_drops = sum(int(r["dropped"]) for r in routes[n_pre:])
            log(f"[serve path] {arch}: routed (token, expert) entries the "
                f"prefill dropped at capacity factor "
                f"{m['capacity_factor']} (C = {cap} per {p // n_chunks}-token "
                f"chunk), per layer: "
                + ", ".join(f"{100 * x:.3f}%" for x in row["dropped_share"])
                + f" (of {sum(r['routed'] for r in pre[::n_moe]):,} each); "
                f"decode dropped {decode_drops}")
            if decode_drops or len(routes) != n_moe * (n_chunks + g):
                failures.append(f"{arch}: {len(routes)} MoE calls, decode "
                                f"dropped {decode_drops} entries (want "
                                f"{n_moe * (n_chunks + g)} and 0)")
        del routes
        toks = res["tokens"]
        if not (toks.shape == (b, g) and bool((toks >= 0).all())
                and bool((toks < cfg.vocab).all())
                and bool(torch.isfinite(res["logits"]).all())
                and bool(torch.isfinite(res["prefill_logits"]).all())):
            failures.append(f"{arch}: tokens out of range or logits not "
                            f"finite")

        # the checks: bf16 for the dense and MoE configs.  The SSM
        # families' bf16 logits move by tens of percent under bf16 rounding
        # alone (their spread, printed beside), so theirs run on the same
        # weights in fp32 (the fp32 flash kernel on the kernel route).
        # mixtral's decode check runs without drops on both sides
        kernel_bf16 = res["prefill_logits"]
        del res
        if cfg.family in ("dense", "moe"):
            no_drop = None
            if cfg.moe:
                m = cfg.moe
                no_drop = cfg.replace(moe={
                    **m, "capacity_factor": m["n_experts"] / m["top_k"]})
                if cfg.prefill_chunk:
                    no_drop = no_drop.replace(prefill_chunk=MLA_DECODE_CHUNK)
            row["checks"], _, flips = serve_checks(cfg, params, prompts, p,
                                                   no_drop)
            if flips is not None:
                row["route_flips"] = flips
                log(f"[serve check] {arch}: (token, layer) routes whose "
                    f"top-{cfg.moe['top_k']} experts differ between the "
                    f"kernel and the plain route's prefill, per MoE call "
                    f"(chunk by chunk, a layer each): {flips} (of "
                    f"{b * p // n_chunks} tokens each)")
        elif encdec:
            # bf16, as for the dense configs, unless the random init's bf16
            # spread alone (the plain route in bf16 against fp32 on the
            # same weights, printed either way) exceeds the tolerance: then
            # fp32, as for the SSM families, and the bf16 checks not gated
            row["checks"], plain_bf16, _ = serve_checks(cfg, params, prompts,
                                                        p, enc=enc)
            cfg32 = cfg.replace(param_dtype=torch.float32,
                                compute_dtype=torch.float32)
            plain32, _ = make_prefill_step(cfg32.replace(attn_impl="ref"))(
                to_fp32(params), prompts[:, :p], enc)
            spread = rel_err(plain_bf16, plain32)
            row["bf16_spread"] = {"plain route, bf16 vs fp32": spread}
            del plain_bf16, plain32
            in_bf16 = spread <= LOGITS_REL_TOL
            if not in_bf16:
                row["bf16_checks"] = row["checks"]
                row["checks"], _, _ = serve_checks(cfg32, params, prompts, p,
                                                   enc=enc)
            log(f"[serve check] {arch}: bf16 spread of the random init, plain "
                f"route bf16 vs fp32 on the same weights, {spread:.3e}; the "
                f"checks run in {'bf16' if in_bf16 else 'fp32'}"
                + ("" if in_bf16 else " (bf16, not gated: " + ", ".join(
                    f"{k} {v:.3e}" for k, v in row["bf16_checks"].items())
                    + ")"))
        else:
            plain_bf16, _ = make_prefill_step(cfg.replace(attn_impl="ref"))(
                params, prompts[:, :p])
            row["checks"], plain32, _ = serve_checks(
                cfg.replace(param_dtype=torch.float32,
                            compute_dtype=torch.float32),
                to_fp32(params), prompts, p)
            row["bf16_spread"] = {
                "prefill logits, kernel vs plain route": rel_err(
                    kernel_bf16, plain_bf16),
                "plain route, bf16 vs fp32": rel_err(plain_bf16, plain32)}
            log(f"[serve check] {arch} in bf16, not gated: "
                + ", ".join(f"{k} {v:.3e}"
                            for k, v in row["bf16_spread"].items()))
            del plain_bf16, plain32
        for name, err in row["checks"].items():
            ok = err <= LOGITS_REL_TOL
            log(f"[serve check] {'ok  ' if ok else 'FAIL'} {arch} {name}: "
                f"relative L2 error {err:.3e} (tolerance "
                f"{LOGITS_REL_TOL:.3e})")
            if not ok:
                failures.append(f"{arch} serve check {name}: {err}")
        del params, kernel_bf16, prompts, enc
        torch.cuda.empty_cache()

        if cfg.mla:
            # MLA's prefill chunks: q/k 192 = qk_nope + qk_rope, v 128
            m = cfg.mla
            c = cfg.prefill_chunk
            row["flash"] = [flash_alone(
                arch, b, cfg.n_heads, cfg.n_heads, c,
                m["qk_nope_dim"] + m["qk_rope_dim"], gen, failures,
                dv=m["v_head_dim"], sk=c * (i + 1), q_off=c * i, slices=16,
                label=f"{arch}'s chunk {i + 1}") for i in range(n_chunks)]
            torch.cuda.empty_cache()
        elif encdec:
            # the encoder's self-attention and the prefill's and a decode
            # step's cross-attention (non-causal over the frames), and the
            # decoder's causal self-attention
            f = cfg.encdec["enc_frames"]
            row["flash"] = [flash_alone(
                arch, b, cfg.n_heads, cfg.n_kv_heads, s, cfg.dh, gen,
                failures, sk=sk, causal=causal, label=f"{arch}'s {what}")
                for what, s, sk, causal in (
                    ("encoder self-attention", f, f, False),
                    ("prefill cross-attention", p, f, False),
                    ("decoder self-attention", p, p, True),
                    ("decode cross-attention", 1, f, False))]
            torch.cuda.empty_cache()
        elif cfg.family != "ssm":
            row["flash"] = flash_alone(arch, b, cfg.n_heads, cfg.n_kv_heads,
                                       p, cfg.dh, gen, failures, cfg.window)
            torch.cuda.empty_cache()
        out[arch] = row
    report["families"] = out
    return flash_launches


# the train phase (module step 9e): qwen3-1.7b uncut takes TRAIN_STEPS steps
# on one fixed batch of TRAIN_BATCH x TRAIN_SEQ seeded tokens (labels the
# tokens shifted by one), remat "full" and default_train_options (fp32
# moments: its estimate is below 2e10); then one step for every other
# family at full width, in the traffic and depth of TRAIN_FAMILIES (None:
# uncut), each with the moment policy default_train_options gives its
# uncut config.  The cuts: a dense or MoE config at 2 layers as when it
# serves (deepseek-v3 at its 3 dense layers, since one MoE layer alone is
# 11.27e9 parameters x (2 + 2 + 3) B = 79 GB under q8; its MTP block
# included), zamba2-7b at TRAIN_ZAMBA_LAYERS of 81 mamba layers (uncut,
# 6.76e9 parameters x 12 B of fp32 moments, weights and gradients are 81
# GB before activations)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen3-1.7b", 4, 2048, 3
TRAIN_ZAMBA_LAYERS = 44
TRAIN_FAMILIES = {"chatglm3-6b": (4, 2048, 2), "starcoder2-7b": (4, 2048, 2),
                  "minicpm-2b": (4, 2048, 2), "chameleon-34b": (4, 2048, 2),
                  "mixtral-8x22b": (MOE_BATCH, MOE_PROMPT, 2),
                  "mamba2-130m": (4, 2048, None),
                  "zamba2-7b": (4, 2048, TRAIN_ZAMBA_LAYERS),
                  "deepseek-v3-671b": (2, 4096, 3),
                  "whisper-medium": (4, 2048, None)}
# qwen3's route check (step 1 on the kernel route against the same step
# with attn_impl="ref" on the card) and microbatch check (microbatch=2
# against the whole batch, fp32 accumulators): bf16 rounds P, each
# attention output and its gradients (2^-8 relative and more) at other
# places on the two sides, in each of 28 layers forward and backward, and
# those differences add along the residual stream: about sqrt(2 x 28) x
# 2^-7 = 0.06 relative in a gradient.  The loss within 2^-7 relative, the
# gradient norm within 2^-5, each gradient (a layer stack's leaves
# concatenated) within a relative L2 of 2^-3; a dropped or misplaced
# gradient term is O(1)
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_GRAD_TOL = 2 ** -7, 2 ** -5, 2 ** -3
# the backward kernel alone against its plain version (fp32 from the same
# bf16 inputs): relative L2 of dq, dk and dv within 2^-6 (one rounding of
# each output, 2^-9, and delta from the bf16-rounded O)
BWD_REL_TOL = 2 ** -6


def train_batch(cfg, b, s, gen):
    """Seeded token ids [b, s + 1] → tokens and labels shifted by one (and
    frame embeddings for an encoder-decoder)."""
    import torch

    from repro_torch.launch import serve as serve_lib
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                         device=gen.device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_inputs"] = serve_lib.frame_embeddings(cfg, b, gen)
    return batch


def train_launches_wanted(cfg):
    """(forward, backward) flash launches of one train step with remat
    "full": each checkpointed attention runs forward twice (the forward,
    then its layer's recompute) and backward once; deepseek-v3's MTP block
    is not checkpointed (once each)."""
    n = flash_launches_wanted(cfg, 1, 0)
    mtp = 1 if cfg.mtp else 0
    return 2 * n + mtp, n + mtp


def grad_rel(got, want, names=("wq", "wk", "wv")) -> dict:
    """Relative L2 of the attention projections' gradients (every layer's
    concatenated, per name) and of the embedding's."""
    import torch

    def cat(tree, name):
        return torch.cat([lp["attn"][name]["w"].float().flatten()
                          for lp in tree["dense_stack"]])
    out = {name: rel_err(cat(got, name), cat(want, name)) for name in names}
    out["embed"] = rel_err(got["embed"]["table"].float(),
                           want["embed"]["table"].float())
    return out


# the flash backward's 11 train shapes (label, batch, heads, kv heads, queries,
# q/k head dim, and the masks, v head dim or key count where they differ)
TRAIN_BWD_SHAPES = [("qwen3-1.7b", 4, 16, 8, 2048, 128, {}),
                    ("zamba2-7b", 4, 32, 32, 2048, 112, {}),
                    ("chatglm3-6b", 4, 32, 2, 2048, 128, {}),
                    ("starcoder2-7b", 4, 36, 4, 2048, 128, {}),
                    ("minicpm-2b", 4, 36, 36, 2048, 64, {}),
                    ("chameleon-34b", 4, 64, 8, 2048, 128, {}),
                    ("mixtral-8x22b", MOE_BATCH, 48, 8, MOE_PROMPT, 128,
                     {"window": 4096}),
                    ("deepseek-v3-671b", 2, 128, 128, 4096, 192,
                     {"dv": 128, "sm_scale": 192 ** -0.5}),
                    ("whisper-medium's encoder", 4, 16, 16, 1500, 64,
                     {"causal": False}),
                    ("whisper-medium's cross-attention", 4, 16, 16, 2048, 64,
                     {"causal": False, "sk": 1500}),
                    ("whisper-medium's decoder", 4, 16, 16, 2048, 64, {})]


def bwd_inputs(b, h, kv, s, d, gen, *, dv=None, sk=None, window=None,
               causal=True, sm_scale=None) -> dict:
    """One train shape's backward inputs on the card: seeded normal bf16
    q, k, v and dO, lse and O from the forward kernel, and the masks."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    dv, sk = dv or d, sk or s
    q, k, v = (torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16)
               for shape in ((b, h, s, d), (b, kv, sk, d), (b, kv, sk, dv)))
    do = torch.randn((b, h, s, dv), generator=gen, device=DEVICE,
                     dtype=torch.bfloat16)
    masks = dict(causal=causal, window=window, sm_scale=sm_scale)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=DEVICE)
    o = fa_ops.flash_attention_cuda(q, k, v, lse=lse, **masks)
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, masks=masks)


def bwd_plain(x) -> tuple:
    """``flash_attention_bwd_ref`` of :func:`bwd_inputs`' inputs over blocks
    of one batch row and hk kv-heads (their GQA groups whole), each at most
    1 GB of fp32 scores → (a callable returning [dq, dk, dv], blocks)."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    q, k, v, do, masks = x["q"], x["k"], x["v"], x["do"], x["masks"]
    b, h, s = q.shape[:3]
    kv, sk = k.shape[1:3]
    g = h // kv
    hk = max([n for n in range(1, kv + 1)
              if kv % n == 0 and n * g * s * sk * 4 <= 1 << 30] or [1])
    blocks = [(i, j) for i in range(b) for j in range(0, kv, hk)]

    def plain():
        grads = [torch.empty_like(t) for t in (q, k, v)]
        for i, j in blocks:
            qs, ks = (slice(i, i + 1), slice(j * g, (j + hk) * g)), \
                (slice(i, i + 1), slice(j, j + hk))
            for out, part in zip(grads, flash_attention_bwd_ref(
                    q[qs], k[ks], v[ks], do[qs], **masks)):
                out[qs if out.shape[1] == h else ks] = part
        return grads
    return plain, len(blocks)


def bwd_bound(x) -> tuple:
    """The least time of the backward on the card → (ms, "bytes" or
    "operations", bytes, FLOPs): each input read and each output written
    once, and the five products' 2·(3·D + 2·Dv) FLOPs a visible pair at the
    bf16 tensor cores' peak."""
    q, k, v, do, o, lse = (x[n] for n in ("q", "k", "v", "do", "o", "lse"))
    b, h, s, d = q.shape
    sk, dv = k.shape[2], v.shape[3]
    pairs = visible_pairs(s, sk, x["masks"]["causal"],
                          window=x["masks"]["window"]) * b * h
    n_ops = 2 * (3 * d + 2 * dv) * pairs
    n_bytes = 2 * 2 * (q.numel() + k.numel() + v.numel() + do.numel()) \
        + 2 * o.numel() + 4 * lse.numel()
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", n_bytes, n_ops)


def sdpa_bwd_ms(x) -> tuple:
    """SDPA's backward on the same inputs, never called by the port: forward
    + backward under autograd, minus the forward under autograd → (ms or
    None, the mask it was given or why no backend took it)."""
    import torch
    import torch.nn.functional as F
    q, k, v, do, masks = x["q"], x["k"], x["v"], x["do"], x["masks"]
    s, sk = q.shape[2], k.shape[2]
    causal, window = masks["causal"], masks["window"]
    kw = dict(enable_gqa=True, scale=masks["sm_scale"])
    if causal and window is None and sk == s:
        kw["is_causal"] = True
        backend = "is_causal"
    elif causal or window is not None:
        qpos = torch.arange(s, device=DEVICE)[:, None]
        kpos = torch.arange(sk, device=DEVICE)[None, :]
        mask = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
        if window is not None:
            mask &= (qpos - kpos) < window
        kw["attn_mask"] = mask
        backend = "boolean mask"
    else:
        backend = "no mask"
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*leaves, **kw)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), leaves, do)
    try:
        return cuda_ms(sdpa_fwd_bwd, 3) - cuda_ms(sdpa_fwd, 3), backend
    except RuntimeError as exc:       # no SDPA backend takes these inputs
        return None, f"{backend}: {str(exc).splitlines()[0]}"


def flash_bwd_alone(label, b, h, kv, s, d, gen, failures, **kw) -> dict:
    """``flash_attention_bwd_cuda`` alone at one train shape (bf16, seeded
    normal q, k, v and dO; lse and O from the forward kernel): held against
    ``flash_attention_bwd_ref`` (over blocks of heads of at most 1 GB of
    fp32 scores) within BWD_REL_TOL, and timed beside its bound, its plain
    version and SDPA's backward (forward + backward under autograd, minus
    the forward under autograd; never called by the port)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    x = bwd_inputs(b, h, kv, s, d, gen, **kw)
    q, k, v, do, o, lse, masks = (x[n] for n in ("q", "k", "v", "do", "o",
                                                 "lse", "masks"))
    got = fa_ops.flash_attention_bwd_cuda(q, k, v, o, do, lse, **masks)
    plain, slices = bwd_plain(x)
    want = plain()
    rels = {name: rel_err(g, w) for name, g, w in zip(("dq", "dk", "dv"),
                                                       got, want)}
    err = max(max_err(g.float(), w.float()) for g, w in zip(got, want))
    del got, want
    ok = all(r <= BWD_REL_TOL for r in rels.values())
    causal, window = masks["causal"], masks["window"]
    sk, dv = k.shape[2], v.shape[3]
    shape = (f"q {b} x {h} x {s} x {d}, k {b} x {kv} x {sk} x {d}, v "
             f"{b} x {kv} x {sk} x {dv}, "
             + ("causal" if causal else "non-causal")
             + (f", window {window}" if window else ""))
    log(f"[kernel check] {'ok  ' if ok else 'FAIL'} flash_attention_bwd at "
        f"{label} ({shape}, GQA {h // kv}): relative L2 "
        + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
        + f" (limit {BWD_REL_TOL:.3e}), max |err| {err:.3e}")
    if not ok:
        failures.append(f"flash_attention_bwd at {label}: relative L2 "
                        f"{rels}")
    ms = cuda_ms(lambda: fa_ops.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                         **masks), 3)
    plain_ms = cuda_ms(plain, 1)
    lib_ms, backend = sdpa_bwd_ms(x)
    bound, by, n_bytes, n_ops = bwd_bound(x)
    lib = ("n/a" if lib_ms is None else
           f"{lib_ms:.4f} ms (SDPA backward, {backend}), kernel / library "
           f"{ms / max(lib_ms, 1e-9):.3f}")
    log(f"[time] flash_attention_bwd at {label}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms ({slices} blocks of heads), library {lib}, bound "
        f"{bound:.4f} ms ({by}; {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} "
        f"GFLOP), {100 * bound / ms:.2f}% of bound")
    if ms < bound:
        failures.append(f"flash_attention_bwd at {label}: {ms} ms below its "
                        f"bound {bound} ms")
    return {"shape": shape, "rel_l2": rels, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "library": backend,
            "bound_ms": bound, "bound_by": by}


def train_phase(dev, report, failures):
    """Module step 9e on the card: qwen3-1.7b's train steps, its route and
    microbatch checks, one step for every other family (each counted:
    forward and backward flash launches as :func:`train_launches_wanted`
    says), then the backward kernel alone at each family's train shape.
    Returns (forward flash launches of the counted steps, the
    ``flash_attention_bwd`` kernels row)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init

    smi = nvidia_smi_line()
    out = {"card": smi}
    fwd_total = bwd_total = 0

    def counted_step(name, cfg, opts, params, state, batch):
        nonlocal fwd_total, bwd_total
        step = steps_lib.make_train_step(cfg, opts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        fwd, bwd = LAUNCHES["flash_attention_wgmma"], \
            LAUNCHES["flash_attention_bwd_wgmma"]
        fwd_total += fwd
        bwd_total += bwd
        want = train_launches_wanted(cfg)
        row = {"loss": loss, "grad_norm": gnorm, "ms": ms,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "flash_launches": [fwd, bwd], "want": list(want),
               "fp32_launches": LAUNCHES["flash_attention"]
               + LAUNCHES["flash_attention_bwd"]}
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            failures.append(f"train {name}: loss {loss}, grad norm {gnorm}")
        if (fwd, bwd) != want or row["fp32_launches"]:
            failures.append(f"train {name}: flash launches {fwd} forward / "
                            f"{bwd} backward (fp32 {row['fp32_launches']}), "
                            f"want {want[0]} / {want[1]}")
        return params, state, row

    # (a) qwen3-1.7b uncut
    cfg = get_config(TRAIN_ARCH)
    opts = steps_lib.default_train_options(cfg)
    gen = M.make_generator(SERVE_SEED, dev)
    params = M.init(gen, cfg)
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, gen)
    n_params = M.param_count(params)
    log(f"[train] ({smi}) {TRAIN_ARCH}: {cfg.n_layers} layers uncut, "
        f"{n_params:,} parameters, batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat "
        f"{cfg.remat}, moments {opts.opt_state_policy}, lr {opts.peak_lr}")
    # the route check and the microbatch check, on the initial weights
    reset_launch_counts()
    loss_k, _, grads_k = steps_lib.loss_and_grads(params, cfg, batch)
    kernel_fb = (LAUNCHES["flash_attention_wgmma"],
                 LAUNCHES["flash_attention_bwd_wgmma"])
    kernel_fp32 = LAUNCHES["flash_attention"] + LAUNCHES["flash_attention_bwd"]
    reset_launch_counts()
    loss_r, _, grads_r = steps_lib.loss_and_grads(
        params, cfg.replace(attn_impl="ref"), batch)
    plain_fb = (LAUNCHES["flash_attention_wgmma"],
                LAUNCHES["flash_attention_bwd_wgmma"])
    from repro_torch.optim import global_norm
    checks = {"loss": abs(float(loss_k) - float(loss_r)) / abs(float(loss_r)),
              "grad_norm": abs(float(global_norm(grads_k))
                               - float(global_norm(grads_r)))
              / float(global_norm(grads_r))}
    checks.update(grad_rel(grads_k, grads_r))
    del grads_r
    loss_m, _, grads_m = steps_lib._accumulated_grads(params, cfg, batch, 2)
    micro = {"loss": abs(float(loss_m) - float(loss_k)) / abs(float(loss_k)),
             "grad_norm": abs(float(global_norm(grads_m))
                              - float(global_norm(grads_k)))
             / float(global_norm(grads_k))}
    micro.update(grad_rel(grads_m, grads_k))
    del grads_m, grads_k
    torch.cuda.empty_cache()
    for label, got, fb in (("kernel vs plain route", checks, kernel_fb),
                           ("microbatch=2 vs whole batch", micro, None)):
        bad = [k for k, x in got.items() if x > {
            "loss": TRAIN_LOSS_TOL, "grad_norm": TRAIN_GNORM_TOL}.get(
                k, TRAIN_GRAD_TOL)]
        log(f"[train] {TRAIN_ARCH} step 1, {label}: "
            + ", ".join(f"{k} {x:.3e}" for k, x in got.items())
            + f" (limits: loss {TRAIN_LOSS_TOL:.3e}, grad norm "
            f"{TRAIN_GNORM_TOL:.3e}, gradients {TRAIN_GRAD_TOL:.3e})"
            + ("" if fb is None else
               f"; flash launches kernel route {fb[0]} / {fb[1]}, plain "
               f"route {plain_fb[0]} / {plain_fb[1]}"))
        if bad:
            failures.append(f"train {TRAIN_ARCH} {label}: {bad} past their "
                            f"limits ({got})")
    if kernel_fb != (2 * cfg.n_layers, cfg.n_layers) or any(plain_fb) \
            or kernel_fp32:
        failures.append(f"train {TRAIN_ARCH}: flash launches kernel route "
                        f"{kernel_fb} (fp32 {kernel_fp32}), plain route "
                        f"{plain_fb}")
    out[TRAIN_ARCH] = {"params": n_params, "route_check": checks,
                       "microbatch_check": micro, "steps": []}
    state = adamw_init(params, state_policy=opts.opt_state_policy)
    for i in range(TRAIN_STEPS):
        params, state, row = counted_step(TRAIN_ARCH, cfg, opts, params,
                                          state, batch)
        out[TRAIN_ARCH]["steps"].append(row)
        fwd, bwd = row["flash_launches"]
        log(f"[train] {TRAIN_ARCH} step {i + 1}: loss {row['loss']:.4f}, "
            f"grad norm {row['grad_norm']:.4f}, {row['ms']:.1f} ms, peak "
            f"{row['peak_gb']:.2f} GB, flash launches {fwd} forward / {bwd} "
            f"backward (want {row['want'][0]} / {row['want'][1]})")
    losses = [r["loss"] for r in out[TRAIN_ARCH]["steps"]]
    if not losses[-1] < losses[0]:
        failures.append(f"train {TRAIN_ARCH}: the loss did not fall over "
                        f"{TRAIN_STEPS} steps on one batch: {losses}")
    del params, state, batch
    torch.cuda.empty_cache()

    # (b) one step for every other family
    for arch, (b, s, layers) in TRAIN_FAMILIES.items():
        full = get_config(arch)
        opts = steps_lib.default_train_options(full)
        cfg = full.replace(n_layers=layers) if layers else full
        gen = M.make_generator(SERVE_SEED, dev)
        params = M.init(gen, cfg)
        batch = train_batch(cfg, b, s, gen)
        state = adamw_init(params, state_policy=opts.opt_state_policy)
        n_params = M.param_count(params)
        _, _, row = counted_step(arch, cfg, opts, params, state, batch)
        row.update(params=n_params, layers=cfg.n_layers,
                   policy=opts.opt_state_policy)
        out[arch] = row
        cut = {"deepseek-v3-671b": "its 3 dense layers and the MTP block; "
               "one MoE layer alone is 79 GB under q8",
               "zamba2-7b": "uncut: 81 GB of weights, gradients and fp32 "
               "moments before activations"}.get(
                   arch, "as it serves: full width, the depth cut to fit "
                   "the card")
        depth = (f"{cfg.n_layers} of {full.n_layers} layers ({cut})"
                 if layers and layers < full.n_layers else
                 f"{cfg.n_layers} layers uncut")
        log(f"[train] {arch}: loss {row['loss']:.4f}, grad norm "
            f"{row['grad_norm']:.4f}, {row['ms']:.1f} ms, peak "
            f"{row['peak_gb']:.2f} GB, moments {opts.opt_state_policy}, "
            f"{depth}, {n_params:,} parameters, batch {b} x {s}; flash "
            f"launches {row['flash_launches'][0]} forward / "
            f"{row['flash_launches'][1]} backward (want {row['want'][0]} / "
            f"{row['want'][1]})")
        del params, state, batch
        torch.cuda.empty_cache()

    # (c) the backward kernel alone at each family's train shape
    gen = torch.Generator(device=DEVICE).manual_seed(SERVE_SEED)
    alone = {label: flash_bwd_alone(label, b, h, kv, s, d, gen, failures,
                                    **kw)
             for label, b, h, kv, s, d, kw in TRAIN_BWD_SHAPES}
    out["bwd_alone"] = alone
    out["flash_launches"] = [fwd_total, bwd_total]
    main = alone["qwen3-1.7b"]
    # the backward's share of qwen3's step: its launches a step at the time
    # measured alone, over the counted steps' median
    step_ms = sorted(r["ms"] for r in out[TRAIN_ARCH]["steps"])[
        TRAIN_STEPS // 2]
    n_bwd = train_launches_wanted(get_config(TRAIN_ARCH))[1]
    out["bwd_share_of_step"] = {"launches": n_bwd, "kernel_ms": main["ms"],
                                "step_ms": step_ms,
                                "share": n_bwd * main["ms"] / step_ms}
    log(f"[time] flash_attention_bwd share of a {TRAIN_ARCH} train step: "
        f"{n_bwd} launches x {main['ms']:.4f} ms = "
        f"{n_bwd * main['ms']:.2f} ms of the steps' median {step_ms:.1f} ms "
        f"({100 * n_bwd * main['ms'] / step_ms:.2f}%)")
    report["train"] = out
    return fwd_total, {
        "name": "flash_attention_bwd", "route": "cuda-wgmma",
        "source": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
        "replaces": "src/repro/models/attention.py:58",
        "launches": bwd_total,
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"]}


# the train-launch phase (module step 9f): the port's launcher
# (repro_torch.launch.train's main, as ``python -m repro_torch.launch.train``
# runs it) in process at qwen3-1.7b's full width and depth, remat "full",
# fp32 moments: LAUNCH_STEPS steps of LAUNCH_BATCH x LAUNCH_SEQ tokens from
# the D4M pipeline (its 64-document corpus holds 1406 tokens: 1024 is the
# largest power of two it serves), a checkpoint every LAUNCH_CKPT_EVERY
# steps and a simulated failure at step call LAUNCH_FAIL_AT (the step-3
# checkpoint restores, step 3 runs again); then the same arguments with no
# failure and no checkpoint directory.  A checkpoint of this state is 17.2
# GB (1.72e9 bf16 parameters, fp32 m and v): the failure run keeps two, and
# they are deleted before the round trip writes a third, so the phase needs
# LAUNCH_DISK_BYTES free (a card machine has had 80 GB: no depth cut)
LAUNCH_ARCH, LAUNCH_BATCH, LAUNCH_SEQ, LAUNCH_STEPS = "qwen3-1.7b", 4, 1024, 8
LAUNCH_CKPT_EVERY, LAUNCH_FAIL_AT = 3, 5
LAUNCH_CALLS = [0, 1, 2, 3, 3, 4, 5, 6, 7]   # step of each completed call
LAUNCH_DISK_BYTES = 2 * 17.3e9
# every step's loss against the uninterrupted run's: the same weights and
# batches, but the flash backward's dQ atomics add in another order in
# each run, and the difference grows over the steps
LAUNCH_LOSS_RTOL = 2 ** -6
# gradient compression over one full gradient tree: LAUNCH_EF_SCALES error-
# feedback rounds of the final state's gradients times each scale
LAUNCH_EF_SCALES = (1.0, -0.5, 2.0)


def tree_bytes(tree) -> int:
    from repro_torch.optim import tree_leaves
    return sum(x.nbytes for leaf in tree_leaves(tree)
               for x in (leaf.values() if isinstance(leaf, dict) else [leaf]))


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def compression_check(cfg, state, batch, failures) -> dict:
    """``compress_tree`` over one full gradient tree (the gradients of
    ``state``'s parameters on ``batch``): the round trip within one
    quantization step of each leaf's largest value, and, over the error-
    feedback rounds of LAUNCH_EF_SCALES, the sum of what was sent within
    the carried residual of the sum of the true gradients (+1e-4), each
    leaf as ``tests/test_compression.py`` asserts; its ms (each round's:
    the first allocates the error state) and bytes."""
    import torch

    from repro_torch.distributed import compress_tree, decompress_tree
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import tree_leaves, tree_map
    _, _, grads = steps_lib.loss_and_grads(state[0], cfg, batch)
    del state
    sums = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for g in tree_leaves(grads)]
    sent = [torch.zeros_like(s) for s in sums]
    err, worst_rt = None, 0.0
    out = {"ms": [], "grad_bytes": tree_bytes(grads),
           "leaves": len(tree_leaves(grads))}
    for i, c in enumerate(LAUNCH_EF_SCALES):
        g = tree_map(lambda x: x * c, grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp, err = compress_tree(g, err)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["compressed_bytes"] = tree_bytes(comp)
        deq = decompress_tree(comp, g)
        for s, d, gl, dl in zip(sums, sent, tree_leaves(g), tree_leaves(deq)):
            s.add_(gl.float())
            d.add_(dl)
            if i == 0:   # from a zero error state: deq against g itself
                bound = float(gl.float().abs().max()) / 127 + 1e-6
                worst_rt = max(worst_rt,
                               float((dl - gl.float()).abs().max()) / bound)
        del g, comp, deq
    worst_ef = max(float((d - s).abs().max())
                   / (float(e.abs().max()) + 1e-4)
                   for s, d, e in zip(sums, sent, tree_leaves(err)))
    out.update(round_trip_over_bound=worst_rt, feedback_over_bound=worst_ef)
    if not (worst_rt <= 1.0 and worst_ef <= 1.0):
        failures.append(f"train launch: compression round trip "
                        f"{worst_rt:.3f} or error feedback {worst_ef:.3f} "
                        f"of its bound (limit 1)")
    return out


def train_launch_phase(dev, report, failures):
    """Module step 9f on the card: the launcher's failure run (counted),
    the round trip of its final state, the uninterrupted run (counted),
    gradient compression on its final state, then the flash kernels alone
    at the launcher's attention shape.  Returns the counted (forward,
    backward) flash launches."""
    import resource
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.optim import tree_leaves

    argv = ["--arch", LAUNCH_ARCH, "--seq-len", str(LAUNCH_SEQ), "--batch",
            str(LAUNCH_BATCH), "--steps", str(LAUNCH_STEPS), "--device",
            DEVICE]
    cfg = train_lib.train_config(train_lib.parse_args(argv))
    want_fb = train_launches_wanted(cfg)
    tmp = tempfile.mkdtemp(prefix="train_launch_")
    out = {"card": nvidia_smi_line(), "argv": argv}
    counted = [0, 0]

    def counted_run(extra):
        rep = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        train_lib.main(argv + extra, report=rep)
        fb = (LAUNCHES["flash_attention_wgmma"],
              LAUNCHES["flash_attention_bwd_wgmma"])
        fp32 = LAUNCHES["flash_attention"] + LAUNCHES["flash_attention_bwd"]
        counted[0] += fb[0]
        counted[1] += fb[1]
        n = len(rep["calls"])
        want = (want_fb[0] * n, want_fb[1] * n)
        if fb != want or fp32:
            failures.append(f"train launch {extra}: flash launches {fb} "
                            f"(fp32 {fp32}), want {want} for {n} steps")
        rep.update(flash_launches=list(fb), want=list(want),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   step_s=sorted(c["s"] for c in rep["calls"])[n // 2])
        return rep

    try:
        free = shutil.disk_usage(tmp).free
        out["disk_free_bytes"] = free
        log(f"[train launch] ({out['card']}) {LAUNCH_ARCH}: {cfg.n_layers} "
            f"layers uncut, remat {cfg.remat}; free disk {free / 1e9:.1f} "
            f"GB at {tmp} (needs {LAUNCH_DISK_BYTES / 1e9:.1f} GB)")
        if free < LAUNCH_DISK_BYTES:
            raise RuntimeError(f"{free / 1e9:.1f} GB free for checkpoints, "
                               f"{LAUNCH_DISK_BYTES / 1e9:.1f} GB needed")
        ckpt_dir = os.path.join(tmp, "run")
        fail = counted_run(["--ckpt-dir", ckpt_dir, "--ckpt-every",
                            str(LAUNCH_CKPT_EVERY), "--simulate-failure",
                            str(LAUNCH_FAIL_AT)])
        ckpt_bytes = [dir_bytes(os.path.join(ckpt_dir, n))
                      for n in sorted(os.listdir(ckpt_dir))]
        shutil.rmtree(ckpt_dir)
        state = fail.pop("state")
        # the round trip: a synchronous save of the final state, restored
        # in place into a fresh state
        rt_dir = os.path.join(tmp, "round_trip")
        t0 = time.perf_counter()
        save_checkpoint(rt_dir, LAUNCH_STEPS, state)
        save_s = time.perf_counter() - t0
        target = train_lib.make_state(cfg, steps_lib.TrainOptions(), 1,
                                      dev)
        t0 = time.perf_counter()
        got, step, _ = restore_checkpoint(rt_dir, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        pairs = list(zip(tree_leaves(got), tree_leaves(state)))
        same = sum(bool(torch.equal(a, b)) for a, b in pairs)
        dtypes = sorted({str(b.dtype).split(".")[1] for _, b in pairs})
        out["round_trip"] = {"leaves": len(pairs), "equal": same,
                             "dtypes": dtypes, "bytes": dir_bytes(rt_dir),
                             "save_s": save_s, "restore_s": restore_s}
        if same != len(pairs) or step != LAUNCH_STEPS:
            failures.append(f"train launch: checkpoint round trip gave "
                            f"{same} of {len(pairs)} leaves equal")
        del state, target, got, pairs
        shutil.rmtree(rt_dir)
        torch.cuda.empty_cache()

        clean = counted_run([])
        out["compression"] = compression_check(
            cfg, clean.pop("state"), train_launch_batch(argv), failures)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the two runs against each other
    by_step = {c["step"]: c for c in clean["calls"]}
    steps = [c["step"] for c in fail["calls"]]
    diffs = [abs(c["loss"] - by_step[c["step"]]["loss"])
             / abs(by_step[c["step"]]["loss"]) for c in fail["calls"]]
    same_batches = all(c["batch"] == by_step[c["step"]]["batch"]
                       for c in fail["calls"])
    if (fail["restarts"], fail["steps"], steps) != (1, LAUNCH_STEPS,
                                                    LAUNCH_CALLS):
        failures.append(f"train launch: restarts {fail['restarts']}, steps "
                        f"{fail['steps']}, calls {steps}")
    if (clean["restarts"], [c["step"] for c in clean["calls"]]) != \
            (0, list(range(LAUNCH_STEPS))):
        failures.append(f"train launch: the uninterrupted run made "
                        f"{clean['restarts']} restarts")
    if not same_batches:
        failures.append("train launch: a step's batch differs between the "
                        "runs")
    if not (max(diffs) <= LAUNCH_LOSS_RTOL and all(
            math.isfinite(c["loss"]) for c in fail["calls"])):
        failures.append(f"train launch: losses {diffs} relative to the "
                        f"uninterrupted run's (limit {LAUNCH_LOSS_RTOL})")
    out.update(fail_run=fail, clean_run=clean, loss_rel=diffs,
               same_batches=same_batches, ckpt_bytes=ckpt_bytes,
               rss_peak_gb=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 1e6)
    rt, comp = out["round_trip"], out["compression"]
    log(f"[train launch] failure run: {fail['steps']} steps, restarts="
        f"{fail['restarts']}, step calls {steps} ({len(steps)} completed, "
        f"failure at call {LAUNCH_FAIL_AT}); uninterrupted run: "
        f"{clean['steps']} steps, restarts={clean['restarts']}")
    log(f"[train launch] seconds a step (median of the calls): failure run "
        f"{fail['step_s']:.3f}, uninterrupted {clean['step_s']:.3f}; "
        f"whole runs {fail['seconds']:.1f} s and {clean['seconds']:.1f} s; "
        "each call: " + ", ".join(f"{c['s']:.3f}" for c in fail["calls"])
        + " and " + ", ".join(f"{c['s']:.3f}" for c in clean["calls"]))
    for s in fail["saves"]:
        log(f"[train launch] save at step {s['step']}: {s['bytes']:,} bytes, "
            f"host copy {s['copy_s']:.3f} s (synchronous), writer "
            f"{s.get('write_s', float('nan')):.2f} s (in the background)")
    log(f"[train launch] checkpoint bytes on disk {ckpt_bytes}; restore "
        f"after the failure "
        + ", ".join(f"{r:.2f}" for r in fail["restores"])
        + f" s (not counting its wait for the writer); round trip of the "
        f"final "
        f"state: {rt['leaves']} leaves ({', '.join(rt['dtypes'])}), "
        f"{rt['equal']} equal bit for bit, {rt['bytes']:,} bytes, save "
        f"{rt['save_s']:.2f} s, restore in place {rt['restore_s']:.2f} s")
    log(f"[train launch] losses: failure run "
        + ", ".join(f"{c['step']}:{c['loss']:.4f}" for c in fail["calls"])
        + "; uninterrupted " + ", ".join(
            f"{c['step']}:{c['loss']:.4f}" for c in clean["calls"])
        + f"; largest relative difference {max(diffs):.3e} (limit "
        f"{LAUNCH_LOSS_RTOL:.3e}); batches identical: {same_batches}")
    log(f"[train launch] peak device memory {fail['peak_gb']:.2f} GB "
        f"(failure run), {clean['peak_gb']:.2f} GB (uninterrupted); host "
        f"peak RSS {out['rss_peak_gb']:.2f} GB (the process's, whole run); "
        f"flash launches {fail['flash_launches'][0]} / "
        f"{fail['flash_launches'][1]} and {clean['flash_launches'][0]} / "
        f"{clean['flash_launches'][1]} forward / backward (want "
        f"{fail['want'][0]} / {fail['want'][1]} and {clean['want'][0]} / "
        f"{clean['want'][1]})")
    log(f"[train launch] compress_tree over {comp['leaves']} gradient "
        f"leaves: " + ", ".join(f"{ms:.2f}" for ms in comp["ms"])
        + f" ms (rounds 1-{len(comp['ms'])}), {comp['grad_bytes']:,} bytes "
        f"of bf16 "
        f"gradients to {comp['compressed_bytes']:,} (q int8 + s fp32); "
        f"round trip {comp['round_trip_over_bound']:.3f} of its bound, "
        f"error feedback over {len(LAUNCH_EF_SCALES)} rounds "
        f"{comp['feedback_over_bound']:.3f} of its bound (limits 1)")

    # the flash kernels alone at the launcher's attention shape
    gen = torch.Generator(device=DEVICE).manual_seed(SERVE_SEED)
    label = f"{LAUNCH_ARCH} at {LAUNCH_BATCH} x {LAUNCH_SEQ}"
    out["flash_alone"] = flash_alone(LAUNCH_ARCH, LAUNCH_BATCH, cfg.n_heads,
                                     cfg.n_kv_heads, LAUNCH_SEQ, cfg.dh,
                                     gen, failures, label=label)
    out["bwd_alone"] = flash_bwd_alone(label, LAUNCH_BATCH, cfg.n_heads,
                                       cfg.n_kv_heads, LAUNCH_SEQ, cfg.dh,
                                       gen, failures)
    report["train_launch"] = out
    return tuple(counted)


def train_launch_batch(argv):
    """The launcher's batch after its last step, on the card."""
    import torch

    from repro_torch.data import CorpusPipeline, synth_corpus
    from repro_torch.launch import train as train_lib
    args = train_lib.parse_args(argv)
    p = CorpusPipeline(synth_corpus(n_docs=64, seed=args.seed),
                       seq_len=args.seq_len, batch_per_shard=args.batch,
                       seed=args.seed)
    p.load_state_dict({"step": args.steps, "seed": args.seed, "epoch": 0})
    return {k: torch.from_numpy(v).to(DEVICE)
            for k, v in p.next_batch().items()}


def serve_summary(drv: dict) -> dict:
    """Per serve mix: requests, client latency p50/p99 and throughput,
    the server's exec_s beside the in-process collect() (and its
    formatting), plan hit rate, batch mean, kernel launches and
    collectives."""
    import numpy as np

    out = {}
    for name, mix in drv["mixes"].items():
        inproc = drv["in_process"].get(name, [])
        out[name] = {
            "requests": mix["requests"], "wall_s": mix["wall_s"],
            "throughput_rps": mix["throughput_rps"],
            "latency_s": mix["latency_s"], "server_exec_s": mix["exec_s"],
            "in_process_collect_s": {
                "p50": float(np.median([r["collect_s"] for r in inproc])),
                "format_p50": float(np.median([r["format_s"]
                                               for r in inproc])),
                "n": len(inproc)} if inproc else None,
            "plan_hit_rate": mix["plan_hit_rate"],
            "plan_hits": mix["plan_hits"], "plan_misses": mix["plan_misses"],
            "batch_mean": mix["batch_mean"], "launches": mix["launches"],
            "collectives": mix["collectives"]}
        # the ingest mix: the POST /ingest requests apart from the reads
        posts = [r for r in mix["records"] if r["body"]["kind"] == "ingest"]
        if posts:
            reads = [r for r in mix["records"]
                     if r["body"]["kind"] != "ingest"]
            out[name]["by_kind"] = {
                kind: {"n": len(rs), **{
                    f: {"p50": float(np.percentile(v, 50)),
                        "p99": float(np.percentile(v, 99))}
                    for f, v in (("latency_s", [r["latency_s"] for r in rs]),
                                 ("server_exec_s",
                                  [r["exec_s"] for r in rs]))}}
                for kind, rs in (("ingest", posts), ("read", reads))}
    return out


def segment_inputs(raw, a, gen):
    """What a dedup of the clustered array scans: its 2^21 raw triples as
    sorted int32 (row, col) pair ids (ranks of the distinct pairs; the
    linear keys do not fit int32 at n=18), with quarter values (every
    partial sum exact in any order) and normal values."""
    import numpy as np
    import torch
    r = a.row_space.rank(raw[0])[0].astype(np.int64)
    c = a.col_space.rank(raw[1])[0].astype(np.int64)
    lin = np.sort(r * len(a.col_space) + c)
    keys = np.unique(lin, return_inverse=True)[1].reshape(-1).astype(np.int32)
    keys = torch.from_numpy(keys).to(a.device)
    return (keys, quarter_values(keys.shape[0], gen, a.device),
            torch.randn(keys.shape[0], generator=gen).to(a.device))


def segment_scan_inputs(pair_ids, gen) -> dict:
    """The keys ``segment_scan`` is checked and timed on: the first 4096
    pair ids (a call's floor), the 2^21 pair ids of the clustered n=18
    array, 2^21 keys all equal (one run over every tile: the look-back's
    longest walk) and 2^24 keys whose run lengths are drawn, seeded, from
    the pair ids' own run lengths."""
    import torch
    lengths = torch.bincount(pair_ids.long())
    lengths = lengths[lengths > 0].cpu()
    n = 2 ** 24
    draw = lengths[torch.randint(0, lengths.shape[0],
                                 (2 * n // int(lengths.float().mean()) + 64,),
                                 generator=gen)]
    while int(draw.sum()) < n:
        draw = torch.cat([draw, lengths[torch.randint(
            0, lengths.shape[0], (4096,), generator=gen)]])
    big = torch.repeat_interleave(torch.arange(draw.shape[0],
                                               dtype=torch.int32), draw)[:n]
    dev = pair_ids.device
    return {"4096": pair_ids[:4096].contiguous(), "2^21 pair ids": pair_ids,
            "2^21 all equal": torch.zeros_like(pair_ids),
            "2^24": big.to(dev)}


# the mesh phase (module step 10): qwen3-1.7b's train_4k and decode_32k
# cells of the 16x16 mesh, each run by ``python -m repro_torch.launch.dryrun``
# in a process of its own as rank 0 of a fake 256-rank group (every
# collective a no-op), full width and depth, each tensor at its per-rank
# shard size; then qwen3 SMOKE's train and decode steps on a 2x2 mesh under
# LocalTensorMode against the same steps unsharded, and a checkpoint of an
# unsharded SMOKE state restored sharded on that mesh (``chip_smoke.py
# --mesh-local``, a process of its own: both need a default group)
MESH_ARCH = "qwen3-1.7b"
MESH_CELLS = ("train_4k", "decode_32k")
MESH_CELL_TIMEOUT = 900
# the 2x2 steps run in bf16, the flash kernels on each rank's local
# shards, against the same steps unsharded in bf16 on the card: the loss's
# relative difference, the gradient norm's, the largest relative L2
# difference of any gradient leaf and of any first-moment leaf after the
# step, and the decode logits' relative L2.  The bf16 control (the
# unsharded bf16 steps against fp32 ones: the rounding that bf16 alone
# brings) is printed beside them; each limit is 2-10x the larger of the
# sharded reading and the control in the runs written in PERF.md (loss
# and grad norm 1e-4, worst gradient leaf 0.016, logits 5e-3 to 7e-3),
# where a lost or doubled partial sum moves a leaf by O(1).  An updated
# parameter within 2 x lr (a first AdamW step moves a parameter by at
# most lr·(1 + wd·|p|)) plus one bf16 ulp of the leaf's largest entry
MESH_LOSS_TOL = 2 ** -10
MESH_GNORM_TOL = 2 ** -10
MESH_GRAD_TOL = 2 ** -4
MESH_LOGITS_TOL = 2 ** -6
MESH_LOCAL_B, MESH_LOCAL_S = 4, 128


def _rel(a, b) -> float:
    """The relative L2 difference of ``a`` from ``b`` (as fp32)."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _leaf_names(tree, prefix: str = "") -> list:
    """The paths of ``tree``'s leaves, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix.lstrip("/")]


def _worst_leaf(got, want) -> tuple:
    """The largest relative L2 difference of a leaf of ``got`` (DTensors
    or plain) from the same leaf of ``want``, and the leaf's path."""
    from repro_torch.models.pjit_utils import whole
    from repro_torch.optim import tree_leaves
    errs = [_rel(whole(a), b) for a, b in zip(tree_leaves(got),
                                               tree_leaves(want))]
    i = max(range(len(errs)), key=lambda j: (math.isnan(errs[j]), errs[j]))
    return errs[i], _leaf_names(want)[i]


def mesh_local_main() -> int:
    """``--mesh-local``: (b) and (c) of the mesh phase in this process →
    one JSON line."""
    import copy
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import LAUNCHES, cuda_lib
    from repro_torch.launch import mesh as MS, sharding as SH, steps as S
    from repro_torch.models import model as M
    from repro_torch.models.logical import param_logical
    from repro_torch.models.pjit_utils import use_mesh, whole
    from repro_torch.optim import adamw_init, tree_leaves, tree_unflatten
    cuda_lib.load()
    dev = torch.device(DEVICE)
    cfg = get_smoke(MESH_ARCH)
    cfg32 = cfg.replace(param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    b, s = MESH_LOCAL_B, MESH_LOCAL_S
    gen = torch.Generator(device=dev).manual_seed(5)
    tok = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                        device=dev, dtype=torch.int32)
    batch = {"tokens": tok[:, :s].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    opts = S.TrainOptions(microbatch=1)
    params = M.init(M.make_generator(0, dev), cfg)
    params32 = tree_unflatten(params, [t.float()
                                       for t in tree_leaves(params)])

    def gnorm(grads):
        return math.sqrt(sum(float(g.float().square().sum())
                             for g in tree_leaves(grads)))

    def decode_logits(c, p):
        cache = M.init_cache(c, b, s + 1, device=dev)
        _, pc = S.make_prefill_step(c)(p, batch["tokens"])
        for key in ("k", "v"):
            cache["dense_stack"][key][:, :, :s] = pc["dense_stack"][key]
        cache["dense_stack"]["len"][:] = s
        lg, _ = S.make_serve_step(c)(p, copy.deepcopy(cache), tok[:, s:],
                                     torch.tensor(s))
        return lg, cache

    # the unsharded steps on the card, in bf16 and (the control) in fp32
    loss_c, _, g_c = S.loss_and_grads(params32, cfg32, batch)
    lg_c, _ = decode_logits(cfg32, params32)
    loss_0, _, g_0 = S.loss_and_grads(params, cfg, batch)
    p0, s0, m0 = S.make_train_step(cfg, opts)(
        copy.deepcopy(params), adamw_init(params), batch)
    lg0, cache = decode_logits(cfg, params)
    out = {"torch": torch.__version__}
    worst_g0, leaf_g0 = _worst_leaf(g_0, g_c)
    out["control"] = {
        "loss": abs(float(loss_0) - float(loss_c)) / abs(float(loss_c)),
        "grad_norm": abs(gnorm(g_0) - gnorm(g_c)) / gnorm(g_c),
        "grad_leaf": worst_g0, "grad_leaf_name": leaf_g0,
        "logits_rel_l2": _rel(lg0, lg_c)}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with LocalTensorMode(4):
            mesh = MS.make_host_mesh(2, 2, device="cuda")
            cuda_lib.reset_launch_counts()
            step, (dp, ds, db) = S.build_sharded(
                cfg, ShapeSpec("t", "train", s, b), mesh, opts,
                params=params, batch=batch)
            with use_mesh(mesh, opts.parallelism):
                loss_1, _, g_1 = S.loss_and_grads(dp, cfg, db)
            p1, s1, m1 = step(dp, ds, db)
            dstep, dargs = S.build_sharded(
                cfg, ShapeSpec("d", "decode", s + 1, b), mesh, opts,
                params=params, batch={"tokens": tok[:, s:].contiguous()},
                cache=cache)
            lg1, _ = dstep(*dargs)
            torch.cuda.synchronize()
            out["launches"] = dict(LAUNCHES)
            worst_g, leaf_g = _worst_leaf(g_1, g_0)
            worst_m, leaf_m = _worst_leaf(s1["m"], s0["m"])
            loss = float(whole(m1["loss"]))
            out["train"] = {
                "loss": loss, "loss_0": float(m0["loss"]),
                "loss_grads": float(whole(loss_1)),
                "loss_grads_0": float(loss_0),
                "grad_norm": float(whole(m1["grad_norm"])),
                "grad_norm_0": float(m0["grad_norm"]),
                "grad_leaf": worst_g, "grad_leaf_name": leaf_g,
                "moment_leaf": worst_m, "moment_leaf_name": leaf_m,
                "n_leaves": len(tree_leaves(g_0)),
                "param_excess": max(
                    float((whole(a).float() - b0.float()).abs().max())
                    - 2 * opts.peak_lr
                    - float(b0.float().abs().max()) * 2 ** -8
                    for a, b0 in zip(tree_leaves(p1), tree_leaves(p0)))}
            out["decode"] = {"rel_l2": _rel(whole(lg1), lg0)}
            # (c) an unsharded state saved, restored sharded: each rank's
            # block against the slice of the original
            specs = SH.param_specs(params, param_logical(cfg), cfg, mesh)
            with tempfile.TemporaryDirectory() as d:
                save_checkpoint(d, 1, params)
                st, _, _ = restore_checkpoint(d, params,
                                              shardings=(specs, mesh))
                worst, blocks = 0.0, 0
                layout = mesh.mesh
                for t, orig, sp in zip(tree_leaves(st), tree_leaves(params),
                                       SH.spec_leaves(specs)):
                    for r, loc in t.to_local()._local_tensors.items():
                        coord = tuple(int(c) for c in
                                      (layout == r).nonzero()[0])
                        want = orig[SH.block_slices(orig.shape, sp, mesh,
                                                    coord)]
                        worst = max(worst, float(
                            (loc.float() - want.float()).abs().max()))
                        blocks += 1
            out["restore"] = {"max_abs": worst, "blocks": blocks}
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def mesh_phase(dev, report, failures) -> tuple:
    """The mesh phase (see MESH_ARCH): the two dry-run cells and the
    LocalTensorMode checks, each process of its own → the (forward,
    backward) bf16 flash launches they counted."""
    import torch

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    total = torch.cuda.get_device_properties(0).total_memory
    fwd = bwd = 0
    report["mesh"] = {}
    for cell in MESH_CELLS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             MESH_ARCH, "--shape", cell], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=MESH_CELL_TIMEOUT)
        wall = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            failures.append(f"mesh dry run {cell}: exit {proc.returncode}: "
                            f"{(lines or [proc.stderr[-1500:]])[-1][:1500]}")
            continue
        rec = json.loads(lines[-1])
        rec["process_s"] = wall
        report["mesh"][cell] = rec
        log(f"[mesh] {MESH_ARCH} {cell} 16x16 rank 0 of 256 on "
            f"{nvidia_smi_line()}: " + json.dumps(rec))
        fl = rec.get("flash_launches", {})
        peak = rec.get("memory", {}).get("peak_bytes")
        if rec.get("status") != "ok" or rec.get("n_chips") != 256:
            failures.append(f"mesh dry run {cell}: status "
                            f"{rec.get('status')}, n_chips "
                            f"{rec.get('n_chips')}")
            continue
        if peak is None or not 0 < peak < total:
            failures.append(f"mesh dry run {cell}: peak {peak} B against "
                            f"the card's {total} B")
        if cell == "train_4k":
            counts = rec["collectives"]["counts"]
            ratio = rec.get("useful_flops_ratio")
            if fl.get("flash_attention_wgmma", 0) < 1 \
                    or fl.get("flash_attention_bwd_wgmma", 0) < 1:
                failures.append(f"mesh train_4k launched no bf16 flash "
                                f"forward or backward: {fl}")
            if counts["all-gather"] < 1 or (counts["all-reduce"] < 1
                                            and counts["reduce-scatter"] < 1):
                failures.append(f"mesh train_4k collectives {counts}")
            if ratio is None or not 0 < ratio <= 1:
                failures.append(f"mesh train_4k useful_flops_ratio {ratio}")
        else:
            log(f"[mesh] {cell}: self-attention decode stays on the plain "
                f"path (a query over a cache), so it launches no flash "
                f"kernel: {fl}")
        fwd += fl.get("flash_attention_wgmma", 0)
        bwd += fl.get("flash_attention_bwd_wgmma", 0)
    # (b) and (c): a process of its own with a fake 4-rank group
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--mesh-local"], cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=MESH_CELL_TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        failures.append(f"mesh --mesh-local: exit {proc.returncode}: "
                        f"{proc.stderr[-2000:]}")
        return fwd, bwd
    res = json.loads(lines[-1])
    report["mesh"]["local"] = res
    launches = res.get("launches", {})
    fwd += launches.get("flash_attention_wgmma", 0)
    bwd += launches.get("flash_attention_bwd_wgmma", 0)
    tr, de, rs, ctl = res["train"], res["decode"], res["restore"], \
        res["control"]
    loss_d = abs(tr["loss"] - tr["loss_0"]) / abs(tr["loss_0"])
    gnorm_d = abs(tr["grad_norm"] - tr["grad_norm_0"]) / \
        abs(tr["grad_norm_0"])
    log(f"[mesh] qwen3 SMOKE bf16 on a 2x2 mesh under LocalTensorMode "
        f"against the unsharded steps on the card (bf16 control: the "
        f"unsharded bf16 steps against fp32 ones): loss {tr['loss']} vs "
        f"{tr['loss_0']} (relative {loss_d}, control {ctl['loss']}), grad "
        f"norm {tr['grad_norm']} vs {tr['grad_norm_0']} (relative {gnorm_d}"
        f", control {ctl['grad_norm']}), worst gradient leaf of "
        f"{tr['n_leaves']} relative L2 {tr['grad_leaf']} "
        f"({tr['grad_leaf_name']}; control {ctl['grad_leaf']}, "
        f"{ctl['grad_leaf_name']}), worst first-moment leaf "
        f"{tr['moment_leaf']} ({tr['moment_leaf_name']}), updated params past 2 lr + 1 ulp by "
        f"{tr['param_excess']}, decode logits relative L2 {de['rel_l2']} "
        f"(control {ctl['logits_rel_l2']}); flash launches on local "
        f"shards {launches}; an unsharded checkpoint restored sharded: "
        f"{rs['blocks']} rank blocks, max |diff| {rs['max_abs']}")
    # each check fails on NaN or inf (no comparison with them holds)
    checks = (("loss", loss_d, MESH_LOSS_TOL),
              ("loss of the gradient pass", abs(
                  tr["loss_grads"] - tr["loss_grads_0"])
               / abs(tr["loss_grads_0"]), MESH_LOSS_TOL),
              ("grad norm", gnorm_d, MESH_GNORM_TOL),
              ("worst gradient leaf", tr["grad_leaf"], MESH_GRAD_TOL),
              ("worst first-moment leaf", tr["moment_leaf"], MESH_GRAD_TOL),
              ("updated params past their bound", tr["param_excess"], 0.0),
              ("decode logits relative L2", de["rel_l2"], MESH_LOGITS_TOL))
    for name, x, tol in checks:
        if not (x <= tol):
            failures.append(f"mesh 2x2 {name}: {x} against {tol}")
    if not (rs["max_abs"] == 0.0 and rs["blocks"] >= 1):
        failures.append(f"mesh sharded restore: {rs}")
    if launches.get("flash_attention_wgmma", 0) < 1 \
            or launches.get("flash_attention_bwd_wgmma", 0) < 1:
        failures.append(f"mesh 2x2 steps launched no bf16 flash kernel on "
                        f"local shards: {launches}")
    return fwd, bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-clustered", type=int, default=18,
                    help="clustered size of the main path (17 if 18 does "
                    "not fit the time limit)")
    ap.add_argument("--report", default=None,
                    help="also write every number as JSON to this path")
    ap.add_argument("--mesh-local", action="store_true",
                    help="(internal) the mesh phase's LocalTensorMode "
                    "checks, in a process of their own")
    ap.add_argument("--mesh-phase-only", action="store_true",
                    help="build the kernels, run the mesh phase, and stop "
                    "(no kernels line, no result line)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    try:
        from repro_torch import main_path
        import numpy as np

        from repro_torch.core import (DISPATCH_STATS, PLAN_STATS, REGISTRY,
                                      clear_union_cache, make_mesh,
                                      reset_all_stats, spgemm)
        from repro_torch.core.collectives import collective_count
        from repro_torch.ingest import IngestTable
        from repro_torch.core.select import compile_selector
        from repro_torch.kernels import LAUNCHES, cuda_lib, reset_launch_counts
        from repro_torch.kernels.bsr_spgemm import ops as bsr_ops
        from repro_torch.kernels.bsr_spgemm import ref as bsr_ref
        from repro_torch.kernels.bsr_spgemm.ref import (
            bsr_spgemm_tf32x3_error_bound, masked_nonfinite_operands,
            masked_ring_nonfinite_operands)
        from repro_torch.kernels.range_extract import ops as rm_ops
        from repro_torch.kernels.segment_reduce import ops as ss_ops
        from repro_torch.kernels.segment_reduce.ref import (
            segment_scan_ref, segment_scan_sum_bound, segment_scan_tiled_ref)
        from repro_torch.kernels.range_extract.ref import range_mask_ref
        from repro_torch.kernels.semiring_matmul import ops as sm_ops
        from repro_torch.kernels.semiring_matmul.ref import (
            TF32X3_C1, nonfinite_operands, ring_nonfinite_operands,
            semiring_matmul_ref, tf32x3_error_bound)
        from repro_torch.kernels.sorted_merge import ops as rc_ops
        from repro_torch.kernels.sorted_merge.ref import rank_count_ref
    except ImportError as exc:
        print(f"chip_smoke: the port (src/repro_torch) is not importable "
              f"next to this script: {exc}", file=sys.stderr)
        return 2

    if args.mesh_local:
        return mesh_local_main()

    # the plain versions and library yardsticks run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    report = {"device": torch.cuda.get_device_name(0)}
    failures = []
    log(f"device: {report['device']}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")

    # -- phase 1: build --------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)
    cuda_lib.load()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] kernels built and loaded in {report['build_s']:.1f} s")
    if args.mesh_phase_only:
        t0 = time.perf_counter()
        fwd, bwd = mesh_phase(dev, report, failures)
        log(f"[mesh] mesh phase {time.perf_counter() - t0:.1f} s, bf16 "
            f"flash launches {fwd} forward, {bwd} backward")
        if args.report:
            os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                        exist_ok=True)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1, default=str)
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0

    # -- phase 2: the serve path, counted (its checks and kernel 9 follow) ---
    flash_row = serve_phase(dev, report, failures)
    torch.cuda.empty_cache()

    # -- the families phase: the SSM, hybrid and other dense configs --------
    t0 = time.perf_counter()
    flash_row["launches"] += families_phase(dev, report, failures)
    report["families_phase_s"] = time.perf_counter() - t0
    log(f"[serve path] families phase {report['families_phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # -- the train phase (module step 9e): train steps, counted ------------
    t0 = time.perf_counter()
    train_fwd, bwd_row = train_phase(dev, report, failures)
    flash_row["launches"] += train_fwd
    report["train_phase_s"] = time.perf_counter() - t0
    log(f"[train] train phase {report['train_phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # -- the train-launch phase (module step 9f): the launcher, counted ----
    t0 = time.perf_counter()
    fwd, bwd = train_launch_phase(dev, report, failures)
    flash_row["launches"] += fwd
    bwd_row["launches"] += bwd
    report["train_launch_phase_s"] = time.perf_counter() - t0
    log(f"[train launch] train-launch phase "
        f"{report['train_launch_phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # -- the mesh phase (module step 10): dry-run cells, 2x2 LocalTensor --
    t0 = time.perf_counter()
    fwd, bwd = mesh_phase(dev, report, failures)
    flash_row["launches"] += fwd
    bwd_row["launches"] += bwd
    report["mesh_phase_s"] = time.perf_counter() - t0
    log(f"[mesh] mesh phase {report['mesh_phase_s']:.1f} s, bf16 flash "
        f"launches {fwd} forward, {bwd} backward")

    # the main path, counted
    gen_n, uni_n = args.n_clustered, N_UNIFORM
    reset_all_stats()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    clus = main_path.build_clustered(gen_n, dev)
    res = main_path.drive_clustered(clus["A"], clus["B"])
    uni = main_path.build_uniform(uni_n, dev)
    res_u = main_path.drive_uniform(uni["A"], uni["B"])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    report["main_path_s"] = time.perf_counter() - t0
    report["step_s"] = {**clus["seconds"], **res["seconds"],
                        **{f"uniform_{k}": v
                           for k, v in res_u["seconds"].items()}}
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["launches"]["main"] = launches
    report["dispatch_stats"] = dict(DISPATCH_STATS)
    report["plan_stats"] = dict(PLAN_STATS)
    log(f"[main path] clustered n={gen_n}, uniform n={uni_n}: "
        f"{report['main_path_s']:.1f} s, peak {report['peak_mem_gb']:.1f} GB")
    log("[main path] step seconds " + json.dumps(report["step_s"]))
    log(f"[main path] launches {launches}  dispatch {dict(DISPATCH_STATS)}")
    for k in MAIN_PATH_KERNELS:
        if launches[k] < 1:
            failures.append(f"kernel {k} was not launched on the main path")
    # the uniform PLUS_TIMES product and fused reduces on the TF32 route,
    # MIN_PLUS on the CUDA-core ring; the n=18 A @ B, sqout(reduce=1) and
    # pipeline (PLUS_TIMES) on the pair kernels' TF32 route
    routes = {"semiring_matmul tf32x3": launches["semiring_matmul_tf32"],
              "semiring_matmul ring": launches["semiring_matmul"]
              - launches["semiring_matmul_tf32"],
              "bsr_spgemm_reduce tf32x3": launches["bsr_spgemm_reduce_tf32"],
              "bsr_pairlist tf32x3": launches["bsr_pairlist_tf32"],
              "bsr_pairlist_reduce tf32x3":
                  launches["bsr_pairlist_reduce_tf32"]}
    log(f"[main path] launches by route {routes}")
    for name, n in routes.items():
        if n < 1:
            failures.append(f"{name} was not launched on the main path")
    if DISPATCH_STATS["range"] < 1:
        failures.append("the row Range selection did not take the range path")
    nnz = {k: int(res[k].nnz) for k in ("select", "add", "matmul")}
    log(f"[main path] nnz {nnz}, sqout vector {tuple(res['sqout_reduce'].shape)}")

    # the ingest path at n=15: merge-on-read through rank_count
    reset_launch_counts()
    t0 = time.perf_counter()
    ing = main_path.build_ingest(N_INGEST, dev)
    res_i = main_path.drive_ingest(ing)
    torch.cuda.synchronize()
    ing_launches = dict(LAUNCHES)
    report["ingest_path_s"] = time.perf_counter() - t0
    report["launches"]["ingest"] = ing_launches
    merges = sum(r["stats"]["merges"]
                 for r in res_i["per_aggregate"].values())
    report["ingest_step_s"] = {agg: r["seconds"] for agg, r in
                               res_i["per_aggregate"].items()}
    space = ing["bases"]["sum"]
    log(f"[ingest path] uniform n={N_INGEST}: base {int(space.nnz)} of "
        f"{space.capacity} triples over {len(space.row_space)} x "
        f"{len(space.col_space)} keys, {res_i['batches']} batches of "
        f"{res_i['batch']}: {report['ingest_path_s']:.1f} s")
    log("[ingest path] step seconds " + json.dumps(report["ingest_step_s"]))
    log(f"[ingest path] launches {ing_launches}, merges {merges}")
    if not (merges >= 1 and ing_launches["rank_count"] == 2 * merges):
        failures.append(f"rank_count launched {ing_launches['rank_count']} "
                        f"times for {merges} merges (want 2 per merge)")
    for k in INGEST_PATH_KERNELS:
        if ing_launches[k] < 1:
            failures.append(f"kernel {k} was not launched on the ingest path")

    # the ingest fallback at clustered n=18: concat + dedup, no rank_count
    reset_launch_counts()
    t0 = time.perf_counter()
    res_f = main_path.drive_ingest_fallback(clus["A"], clus["raw"],
                                            N_FALLBACK)
    torch.cuda.synchronize()
    fb_launches = dict(LAUNCHES)
    report["fallback_s"] = time.perf_counter() - t0
    report["launches"]["fallback"] = fb_launches
    log(f"[ingest fallback] clustered n={gen_n} + {N_FALLBACK} triples: "
        f"{report['fallback_s']:.2f} s, launches {fb_launches}")
    if fb_launches["rank_count"] != 0:
        failures.append("rank_count launched on the concat fallback")

    # the dist path: a one-rank NCCL mesh on the card, the clustered n=18
    # triples of the main path and the ingest workload at n=15
    t0 = time.perf_counter()
    mesh = make_mesh(dev)
    report["make_mesh_s"] = time.perf_counter() - t0
    reset_all_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    dist = main_path.build_dist(clus["raw"], mesh, dev)
    res_d = main_path.drive_dist(dist["A"], dist["B"], clus["A"], clus["B"],
                                 res["selector"])
    ing_d = main_path.build_ingest(N_INGEST, dev, mesh=mesh)
    n_coll = collective_count()
    res_di = main_path.drive_ingest(ing_d)
    ingest_coll = collective_count() - n_coll
    torch.cuda.synchronize()
    dist_launches = dict(LAUNCHES)
    report["dist_path_s"] = time.perf_counter() - t0
    report["launches"]["dist"] = dist_launches
    report["dist_ms"] = {name: {"dist": d * 1e3, "assoc_tensor":
                                None if t is None else t * 1e3}
                         for name, (d, t) in res_d["seconds"].items()}
    report["dist_ms"]["from_triples"] = {
        "dist": dist["seconds"]["dist from_triples"] * 1e3,
        "assoc_tensor": clus["seconds"]["from_triples"] * 1e3}
    report["dist_collectives"] = res_d["collectives"]
    report["dist_range_mask"] = res_d["range_mask"]
    report["dist_ingest_step_s"] = {agg: r["seconds"] for agg, r in
                                    res_di["per_aggregate"].items()}
    log(f"[dist path] one-rank {mesh.backend} mesh on {mesh.device} "
        f"(made in {report['make_mesh_s']:.3f} s), clustered n={gen_n} and "
        f"ingest n={N_INGEST}: {report['dist_path_s']:.1f} s on "
        f"{nvidia_smi_line()}")
    log("[dist path] ms, DistAssoc beside AssocTensor "
        + json.dumps(report["dist_ms"]))
    log(f"[dist path] collectives {res_d['collectives']}, ingest "
        f"{ingest_coll}; range_mask launches {res_d['range_mask']}")
    log("[dist path] ingest step seconds "
        + json.dumps(report["dist_ingest_step_s"]))
    for name in ("select", "setitem"):
        if res_d["range_mask"][name] < 1:
            failures.append(f"range_mask was not launched in the dist {name}")
    if ingest_coll != 0:
        failures.append(f"the dist ingest made {ingest_coll} collectives")

    # the dist products on the same one-rank mesh: the clustered DistAssocs
    # above and the uniform n=12 triples as DistAssocs
    dist_u = main_path.build_dist(uni["raw"], mesh, dev)
    reset_all_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res_p = main_path.drive_dist_product(dist, dist_u, res["selector"])
    torch.cuda.synchronize()
    report["dist_product_s"] = time.perf_counter() - t0
    report["launches"]["dist_product"] = dict(LAUNCHES)
    device_s = {"A @ B": res["seconds"]["matmul"],
                "sqout_reduce": res["seconds"]["sqout_reduce"],
                "pipeline": res["seconds"]["pipeline"],
                "uniform plus_times": res_u["seconds"]["plus_times"],
                "uniform min_plus": res_u["seconds"]["min_plus"]}
    for name in ("coo", "all_to_all", "2d"):
        device_s[name] = res["seconds"]["matmul"]
    report["dist_product_ms"] = {
        name: {"dist": sec * 1e3,
               "assoc_tensor": (device_s[name] * 1e3 if name in device_s
                                else None),
               "strategy": res_p["strategy"][name],
               "collectives": res_p["collectives"][name],
               "prologue": res_p["prologue"][name],
               "launches": res_p["launches"][name]}
        for name, sec in res_p["seconds"].items()}
    report["dist_product_plan"] = res_p["plan"]
    report["dist_product_stages_ms"] = res_p["stages_ms"]
    log(f"[dist product] one-rank {mesh.backend} mesh, clustered n={gen_n} "
        f"and uniform n={uni_n}: {report['dist_product_s']:.1f} s on "
        f"{nvidia_smi_line()}")
    log("[dist product] ms (DistAssoc, AssocTensor), strategy, collectives, "
        "launches " + json.dumps(report["dist_product_ms"]))
    log("[dist product] A @ B plan " + json.dumps(res_p["plan"])
        + " stages ms " + json.dumps(res_p["stages_ms"]))
    # each product's kernel: the tiled replicate compute (PLUS_TIMES on the
    # TF32 route, MIN_PLUS on the ring), and sqin's device planner (bsr on
    # the clustered array, dense on the uniform one)
    want_kernels = {"A @ B": ("bsr_pairlist", "bsr_pairlist_tf32"),
                    "uniform plus_times": ("bsr_pairlist",
                                           "bsr_pairlist_tf32"),
                    "uniform min_plus": ("bsr_pairlist",),
                    "sqin_reduce": ("bsr_pairlist_reduce",),
                    "uniform sqin": ("semiring_matmul",),
                    "uniform sqin_reduce": ("bsr_spgemm_reduce",)}
    for name, kernels_of in want_kernels.items():
        for k in kernels_of:
            if res_p["launches"][name].get(k, 0) < 1:
                failures.append(f"{k} was not launched in the dist product "
                                f"{name} (launches "
                                f"{res_p['launches'][name]})")
    if res_p["launches"]["uniform min_plus"].get("bsr_pairlist_tf32", 0):
        failures.append("the dist MIN_PLUS product took the TF32 route")

    # the contracts phase: every @contract's programs on the card, the dist
    # ones on the same one-rank mesh
    contracts_phase(mesh, report, failures)

    # the serve phase: the arrays above as resident tables of the query
    # server on 127.0.0.1 (one executor in admission order: the registry
    # holds dist tables), queried by client threads over loopback HTTP
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    serve_reg = main_path.build_serve(clus, uni, dist, ing["bases"]["sum"],
                                      dev)
    res_sv = main_path.drive_serve(serve_reg, res["selector"], ing["raw"],
                                   workers=SERVE_WORKERS)
    torch.cuda.synchronize()
    del serve_reg
    report["d4m_serve_phase_s"] = time.perf_counter() - t0
    report["launches"]["d4m_serve"] = dict(LAUNCHES)
    report["d4m_serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["d4m_serve"] = serve_summary(res_sv)
    smi = nvidia_smi_line()
    log(f"[d4m serve] {len(res_sv['mixes'])} mixes over loopback HTTP "
        f"({res_sv['workers']} executor, counts "
        f"{json.dumps(main_path.SERVE_COUNTS)}): "
        f"{report['d4m_serve_phase_s']:.1f} s, peak "
        f"{report['d4m_serve_peak_mem_gb']:.2f} GB, broadcasts "
        f"{res_sv['broadcasts']}, /tables {res_sv['tables_s'] * 1e3:.1f} ms "
        f"on {smi}")
    for name, mix in report["d4m_serve"].items():
        log(f"[d4m serve] {name} " + json.dumps(mix))
    for name, kernels_of in main_path.SERVE_MIX_KERNELS.items():
        got = res_sv["mixes"][name]["launches"]
        for k in kernels_of:
            if got.get(k, 0) < 1:
                failures.append(f"{k} was not launched in the serve mix "
                                f"{name} (launches {got})")
    if res_sv["broadcasts"] != 0:
        failures.append(f"the one-rank serve phase made "
                        f"{res_sv['broadcasts']} broadcasts")

    # -- phase 3: host checks --------------------------------------------------
    t0 = time.perf_counter()
    checks = main_path.check_serve(clus["raw"], uni["raw"], ing["raw"],
                                   res_sv)
    del res_sv
    checks += main_path.check_clustered(clus["raw"], res, full=False)
    checks += main_path.check_uniform(uni["raw"], res_u, full=True)
    checks += main_path.check_ingest(ing["raw"], res_i)
    checks += main_path.check_ingest_fallback(clus["raw"], res_f)
    checks += main_path.check_dist(clus["raw"], res_d)
    checks += [(f"dist {name}", ok, det) for name, ok, det in
               main_path.check_ingest(ing_d["raw"], res_di)]
    checks += main_path.check_dist_ingest(res_di, res_i)
    checks += main_path.check_dist_product(clus["raw"], uni["raw"], res_p,
                                           res, res_u,
                                           clus["A"].row_space.keys)
    small = main_path.build_clustered(N_FULL, dev)
    res_s = main_path.drive_clustered(small["A"], small["B"])
    checks += [(f"n={N_FULL} {name}", ok, det) for name, ok, det in
               main_path.check_clustered(small["raw"], res_s, full=True)]
    for name, ok, detail in checks:
        log(f"[host check] {'ok  ' if ok else 'FAIL'} {name}: {detail}")
        if not ok:
            failures.append(f"host check {name}: {detail}")
    report["host_check_s"] = time.perf_counter() - t0
    del small, res_s, dist, res_d, ing_d, res_di, dist_u, res_p
    mesh.close()

    # -- phase 4: each kernel against its plain version ------------------------
    gen = torch.Generator().manual_seed(0)
    a, b = clus["A"], clus["B"]
    rc = compile_selector(res["selector"], a.row_space)
    bounds = (rc.lo, rc.hi, 0, len(a.col_space))
    rm_in = (a.rows, a.cols, bounds)
    mm_plan, mm_tiles, mm_pairs, n_c = pairlist_inputs(a, b, None, gen)
    at_ = a.transpose()
    rd_plan, rd_tiles, rd_pairs, n_o = pairlist_inputs(a, at_, 1, gen)
    dn_ops, uni_mask, (dm, dk, dn) = dense_inputs(uni["A"], uni["B"], gen)
    mk_ops, mk_mask = masked_inputs(gen, dev)
    rk_i, rk_j = rank_count_inputs(ing["raw"], ing["bases"]["sum"])
    errs = {"rank_count": {}}
    for label, (p, q) in (("base keys in delta keys", (rk_i, rk_j)),
                          ("delta keys in base keys", (rk_j, rk_i))):
        got = rc_ops.rank_count_cuda(p, q)
        want = rank_count_ref(p, q)
        errs["rank_count"][label] = max(max_err(got[0], want[0]),
                                        max_err(got[1], want[1]))
    # the main path's box, its entries in a random order (unsorted: the
    # box's entries no longer one run), a box with no row inside and one
    # with every row inside
    n_rows, n_cols = len(a.row_space), len(a.col_space)
    perm = torch.randperm(a.capacity, generator=gen).to(dev)
    rm_cases = {"main path box": rm_in,
                "main path box, unsorted": (a.rows[perm], a.cols[perm],
                                            bounds),
                "no row inside": (a.rows, a.cols, (n_rows, n_rows + 7, 0,
                                                   n_cols)),
                "every row inside": (a.rows, a.cols, (0, n_rows, 0, n_cols))}
    errs["range_mask"] = {
        label: max_err(rm_ops.range_mask_cuda(*x), range_mask_ref(*x))
        for label, x in rm_cases.items()}
    del perm, rm_cases
    sk_keys, sk_quarter, sk_normal = segment_inputs(clus["raw"], a, gen)
    errs["segment_scan"] = {
        comb: max_err(ss_ops.segment_scan_cuda(sk_keys, sk_quarter,
                                               combine=comb),
                      segment_scan_ref(sk_keys, sk_quarter, combine=comb))
        for comb in ("sum", "min", "max")}
    # normal values: the sums differ by summation order only, each side by
    # at most γ_d(i) · Σ|v| over the run so far, d(i) its depth (the
    # kernel's from its order model, the plain doubling's from the run
    # position): segment_scan_sum_bound
    got = ss_ops.segment_scan_cuda(sk_keys, sk_normal)
    want = segment_scan_ref(sk_keys, sk_normal)
    sum_err = max_err(got, want)
    sum_tol = segment_scan_sum_bound(sk_keys, sk_normal)
    sum_ok = bool(((got.double() - want.double()).abs() <= sum_tol).all())
    log(f"[kernel check] {'ok  ' if sum_ok else 'FAIL'} segment_scan sum of "
        f"normal values: max |err| {sum_err:.3e} (tolerance (γ_d(i) of the "
        f"kernel + of the plain version) · the scan of |v|, at most "
        f"{float(sum_tol.max()):.3e})")
    if not sum_ok:
        failures.append(f"segment_scan sum of normal values: {sum_err}")
    report["segment_scan_normal_sum_err"] = sum_err
    del got, want, sum_tol
    # every bit against the kernel's order model, on each input the timing
    # below uses: normal values, NaN and ±inf among them, sum, min and max
    scan_in = segment_scan_inputs(sk_keys, gen)
    scan_model = {}
    for label, keys in scan_in.items():
        normal = torch.randn(keys.shape[0], generator=gen).to(dev)
        special = normal.clone()
        at = torch.randint(0, keys.shape[0], (8,), generator=gen).to(dev)
        special[at] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), float("nan")] * 2,
                                   device=dev)
        for comb in ("sum", "min", "max"):
            for vlabel, v in (("normal", normal), ("NaN/inf", special)):
                got = ss_ops.segment_scan_cuda(keys, v, combine=comb)
                want = segment_scan_tiled_ref(keys, v, combine=comb)
                nan_g, nan_w = torch.isnan(got), torch.isnan(want)
                bad = int((nan_g != nan_w).sum()) + int(
                    (got[~nan_w] != want[~nan_w]).sum())
                scan_model[f"{label} {comb} {vlabel}"] = bad
        del normal, special, got, want
    ok = not any(scan_model.values())
    log(f"[kernel check] {'ok  ' if ok else 'FAIL'} segment_scan against its "
        f"order model (segment_scan_tiled_ref), elements that differ in any "
        f"bit (tolerance 0) " + json.dumps(scan_model))
    if not ok:
        failures.append(f"segment_scan differs from its order model: "
                        f"{scan_model}")
    report["segment_scan_model_mismatches"] = scan_model
    torch.cuda.empty_cache()      # the 2^24 model's blocks leave the cache
    spgemm_routes = {}
    for name in SEMIRINGS:
        sr = REGISTRY[name]
        x, y = dn_ops(sr)
        e = errs.setdefault("semiring_matmul", {})
        e[name] = max_err(sm_ops.semiring_matmul(x, y, semiring=sr,
                                                 impl="cuda"),
                          semiring_matmul_ref(x, y, semiring=sr))
        at, bt = mm_tiles(sr)
        e = errs.setdefault("bsr_pairlist", {})
        e[name] = max_err(
            bsr_ops.bsr_pairlist_cuda(at, bt, *mm_pairs, n_c=n_c, sr=sr),
            bsr_ref.bsr_pairlist_ref(at, bt, *mm_pairs, n_c=n_c, semiring=sr))
        at, bt = rd_tiles(sr)
        e = errs.setdefault("bsr_pairlist_reduce", {})
        e[name] = max_err(
            bsr_ops.bsr_pairlist_reduce_cuda(at, bt, *rd_pairs, n_o=n_o,
                                             axis=1, sr=sr),
            bsr_ref.bsr_pairlist_reduce_ref(at, bt, *rd_pairs, n_o=n_o,
                                            axis=1, semiring=sr))
        del at, bt
        for label, make, mask in (("1/4 mask", mk_ops, mk_mask),
                                  ("n=12 mask", dn_ops, uni_mask)):
            x, y = make(sr)
            e = errs.setdefault("bsr_spgemm", {})
            before = (LAUNCHES["bsr_spgemm"], LAUNCHES["bsr_spgemm_tf32"])
            got = bsr_ops.bsr_spgemm_cuda(x, mask, y, sr=sr)
            spgemm_routes.setdefault(name, [0, 0])
            spgemm_routes[name][0] += LAUNCHES["bsr_spgemm"] - before[0]
            spgemm_routes[name][1] += LAUNCHES["bsr_spgemm_tf32"] - before[1]
            e[f"{name} {label}"] = max_err(
                got, bsr_ref.bsr_spgemm_ref(x, mask, y, semiring=sr))
            del got
            e = errs.setdefault("bsr_spgemm_reduce", {})
            for axis in (0, 1):
                e[f"{name} {label} axis={axis}"] = max_err(
                    bsr_ops.bsr_spgemm_reduce(x, mask, y, axis=axis,
                                              semiring=sr, impl="cuda"),
                    bsr_ref.bsr_spgemm_reduce_ref(x, mask, y, axis=axis,
                                                  semiring=sr))
        del x, y
    torch.cuda.synchronize()
    # bsr_spgemm took its TF32 route under plus_times and the ring under
    # the other five: (launches, of them on the TF32 route) per semiring
    log(f"[kernel check] bsr_spgemm launches by semiring (all, TF32 route) "
        f"{json.dumps(spgemm_routes)}")
    for name, (n_all, n_tf32) in spgemm_routes.items():
        want = n_all if name == "plus_times" else 0
        if n_all != 2 or n_tf32 != want:
            failures.append(f"bsr_spgemm under {name}: {n_all} launches, "
                            f"{n_tf32} on the TF32 route (want 2 and {want})")
    report["bsr_spgemm_routes"] = spgemm_routes
    for k, per in errs.items():
        worst = max(per.values())
        log(f"[kernel check] {k}: max |kernel - plain| per semiring "
            f"{json.dumps(per)} (tolerance 0)")
        if worst != 0.0:
            failures.append(f"kernel {k} disagrees with its plain version: "
                            f"{per}")
    report["max_abs_err"] = errs

    # the TF32 route on normal values against the fp64 product, within its
    # stated bound (semiring_matmul.ref.tf32x3_error_bound; the fused
    # reduce's fp32 fold adds 2^-23 per term of |C|'s row or column sums)
    # and a relative L2 error below 2^-16 (a product without the lo passes
    # stands near 2^-12); at the path's 4096^3 (both masks for the reduce)
    # and at unaligned shapes.  Then ±inf and near-FLT_MAX inputs, equal to
    # the plain version: inf where it has inf, NaN only where it has NaN.
    tf32_checks = {}
    pt = REGISTRY["plus_times"]

    def normal_check(label, got, want, bound):
        ratio = float(((got.double() - want).abs()
                       / bound.clamp_min(1e-300)).max())
        rel = rel_err(got, want)
        tf32_checks[label] = {"max_err_over_bound": ratio, "rel_l2": rel}
        ok = ratio <= 1.0 and rel <= 2 ** -16
        log(f"[kernel check] {'ok  ' if ok else 'FAIL'} {label}, normal "
            f"values: largest |err| / bound {ratio:.3e} (limit 1), relative "
            f"L2 {rel:.3e} (limit {2 ** -16:.3e})")
        if not ok:
            failures.append(f"{label} on normal values: |err|/bound {ratio}, "
                            f"relative L2 {rel}")

    for mm, kk, nn in ((dm, dk, dn), (1000, 4099, 3001), (129, 33, 257)):
        xa = torch.randn((mm, kk), generator=gen).to(dev)
        xb = torch.randn((kk, nn), generator=gen).to(dev)
        normal_check(f"semiring_matmul {mm}x{kk}x{nn}",
                     sm_ops.semiring_matmul(xa, xb, impl="cuda"),
                     xa.double() @ xb.double(), tf32x3_error_bound(xa, xb))
    xa = torch.randn((dm, dk), generator=gen).to(dev)
    xb = torch.randn((dk, dn), generator=gen).to(dev)
    for label, mask in (("1/4 mask", mk_mask), ("n=12 mask", uni_mask)):
        full = (mask.repeat_interleave(128, 0).repeat_interleave(128, 1)
                != 0)
        xam = torch.where(full, xa, 0.0)
        c = xam.double() @ xb.double()
        # the store: K = 128 x (the block-row's present k tiles)
        normal_check(f"bsr_spgemm {label}",
                     bsr_ops.bsr_spgemm_cuda(xa, mask, xb, sr=pt), c,
                     bsr_spgemm_tf32x3_error_bound(xa, mask, xb))
        cb = tf32x3_error_bound(xam, xb)
        for axis in (0, 1):
            normal_check(
                f"bsr_spgemm_reduce {label} axis={axis}",
                bsr_ops.bsr_spgemm_reduce(xa, mask, xb, axis=axis,
                                          impl="cuda"),
                c.sum(axis), cb.sum(axis)
                + c.shape[axis] * 2.0 ** -23 * c.abs().sum(axis))
        del c, cb, xam, full
    del xa, xb
    # the pair kernels' TF32 route at the n=18 shapes: each C tile within
    # the bound above with K = 128 x (its run's pairs) and |A|·|B| summed
    # over the run; the fused reduce adds its fp32 folds (2^-23 a term of
    # the 128 folded outputs, 2^-24 a chunk partial), each term at most
    # the row's Σ_j (|A|·|B|)
    for label, tiles, pairs, n_out in (
            ("bsr_pairlist", mm_tiles, mm_pairs, n_c),
            ("bsr_pairlist_reduce", rd_tiles, rd_pairs, n_o)):
        at, bt = tiles(pt, normal=True)
        c, m = pair_products_f64(at, bt, *pairs, n_out)
        runs = bsr_ops.run_offsets(pairs[2], n_out)
        lens = (runs[1:] - runs[:-1]).double()
        scale = (TF32X3_C1 * 2.0 ** -22 + 4 * lens * 2.0 ** -24)[:, None, None]
        if label == "bsr_pairlist":
            normal_check(f"{label} n={gen_n}", bsr_ops.bsr_pairlist_cuda(
                at, bt, *pairs, n_c=n_out, sr=pt), c, scale * m)
        else:
            chunks = torch.clamp(torch.ceil(lens / bsr_ops.REDUCE_CHUNK), min=1)
            tol = ((scale * m).sum(2) + (128 * 2.0 ** -23 + (chunks[:, None] - 1)
                                         * 2.0 ** -24) * m.sum(2))
            normal_check(f"{label} n={gen_n} axis=1",
                         bsr_ops.bsr_pairlist_reduce_cuda(
                             at, bt, *pairs, n_o=n_out, axis=1, sr=pt),
                         c.sum(2), tol)
        del at, bt, c, m
    ia, ib = nonfinite_operands(1024, dk, 1024, gen, dev)
    ones = torch.ones((8, dk // 128), dtype=torch.int32, device=dev)
    inf_cases = {"semiring_matmul": (
        sm_ops.semiring_matmul(ia, ib, impl="cuda"),
        semiring_matmul_ref(ia, ib))}
    for axis in (0, 1):
        inf_cases[f"bsr_spgemm_reduce axis={axis}"] = (
            bsr_ops.bsr_spgemm_reduce(ia, ones, ib, axis=axis, impl="cuda"),
            bsr_ref.bsr_spgemm_reduce_ref(ia, ones, ib, axis=axis))
    # bsr_spgemm: more such entries in present and in absent tiles of A
    ma, mmask, mb = masked_nonfinite_operands(1024, dk, 1024, gen, dev)
    inf_cases["bsr_spgemm, masked"] = (
        bsr_ops.bsr_spgemm_cuda(ma, mmask, mb, sr=pt),
        bsr_ref.bsr_spgemm_ref(ma, mmask, mb))
    del ma, mmask, mb
    for label, (got, want) in inf_cases.items():
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        n_inf, n_nan = int(torch.isinf(want).sum()), int(torch.isnan(want).sum())
        tf32_checks[f"{label} nonfinite"] = {"mismatches": int((~same).sum()),
                                             "inf": n_inf, "nan": n_nan}
        ok = bool(same.all()) and n_inf + n_nan > 0
        log(f"[kernel check] {'ok  ' if ok else 'FAIL'} {label}, ±inf and "
            f"near-FLT_MAX inputs ({tuple(ia.shape)} x {tuple(ib.shape)}): "
            f"{int((~same).sum())} entries differ from the plain version "
            f"(which has {n_inf} inf, {n_nan} NaN)")
        if not ok:
            failures.append(f"{label} on non-finite inputs: "
                            f"{tf32_checks[f'{label} nonfinite']}")
    del ia, ib, inf_cases
    report["tf32_checks"] = tf32_checks
    # NaN and opposite infinities under the five ring semirings (max or
    # min ⊕, PTX max.NaN / min.NaN): every ring kernel equal to its plain
    # version, NaN where it has NaN; for the masked kernels B's non-finite
    # rows lie in a k tile present in every block-row
    ring_nan = {}
    ra, rb = ring_nonfinite_operands(512, 1024, 512, gen, dev)
    ma, mmask, mb = masked_ring_nonfinite_operands(512, 1024, 512, gen, dev)
    rat = ra.view(4, 128, 8, 128).permute(0, 2, 1, 3).reshape(-1, 128, 128)
    rbt = rb.view(8, 128, 4, 128).permute(0, 2, 1, 3).reshape(-1, 128, 128)
    rat, rbt = rat.contiguous(), rbt.contiguous()
    ii, jj, kk = torch.meshgrid(torch.arange(4), torch.arange(4),
                                torch.arange(8), indexing="ij")
    rpa, rpb, rpc = (x.reshape(-1).int().to(dev) for x in
                     (ii * 8 + kk, kk * 4 + jj, ii * 4 + jj))
    rpo = ii.reshape(-1).int().to(dev)
    for name in SEMIRINGS[1:]:
        sr = REGISTRY[name]
        cases = {
            "semiring_matmul": (
                sm_ops.semiring_matmul(ra, rb, semiring=sr, impl="cuda"),
                semiring_matmul_ref(ra, rb, semiring=sr)),
            "bsr_spgemm": (
                bsr_ops.bsr_spgemm_cuda(ma, mmask, mb, sr=sr),
                bsr_ref.bsr_spgemm_ref(ma, mmask, mb, semiring=sr)),
            "bsr_pairlist": (
                bsr_ops.bsr_pairlist_cuda(rat, rbt, rpa, rpb, rpc, n_c=16,
                                          sr=sr),
                bsr_ref.bsr_pairlist_ref(rat, rbt, rpa, rpb, rpc, n_c=16,
                                         semiring=sr))}
        for axis in (0, 1):
            cases[f"bsr_spgemm_reduce axis={axis}"] = (
                bsr_ops.bsr_spgemm_reduce(ma, mmask, mb, axis=axis,
                                          semiring=sr, impl="cuda"),
                bsr_ref.bsr_spgemm_reduce_ref(ma, mmask, mb, axis=axis,
                                              semiring=sr))
            cases[f"bsr_pairlist_reduce axis={axis}"] = (
                bsr_ops.bsr_pairlist_reduce_cuda(rat, rbt, rpa, rpb, rpo,
                                                 n_o=4, axis=axis, sr=sr),
                bsr_ref.bsr_pairlist_reduce_ref(rat, rbt, rpa, rpb, rpo,
                                                n_o=4, axis=axis,
                                                semiring=sr))
        for label, (got, want) in cases.items():
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
            ring_nan[f"{label} {name}"] = {
                "mismatches": int((~same).sum()),
                "nan": int(torch.isnan(want).sum()),
                "inf": int(torch.isinf(want).sum())}
        del cases
    bad = {k: v for k, v in ring_nan.items()
           if v["mismatches"] or not v["nan"]}
    log(f"[kernel check] {'ok  ' if not bad else 'FAIL'} the ring kernels on "
        f"NaN and opposite infinities (tolerance 0, NaN where the plain "
        f"version has NaN) " + json.dumps(ring_nan))
    if bad:
        failures.append(f"ring kernels on NaN and infinities: {bad}")
    report["ring_nan_checks"] = ring_nan
    del ra, rb, ma, mmask, mb, rat, rbt
    # the pair lists' runs: pairs per output tile (A @ B) and per output
    # block (the fused reduce), and the reduce's work items (chunks)
    runs_stats = {}
    for label, pairs, n_out in (("bsr_pairlist", mm_pairs, n_c),
                                ("bsr_pairlist_reduce", rd_pairs, n_o)):
        lens = torch.bincount(pairs[2].long(), minlength=n_out).double()
        q = torch.quantile(lens, torch.tensor([0.5, 0.9, 0.99],
                                              dtype=torch.float64,
                                              device=lens.device)).tolist()
        runs_stats[label] = {
            "outputs": n_out, "pairs": int(lens.sum()),
            "mean": float(lens.mean()), "median": q[0], "p90": q[1],
            "p99": q[2], "max": int(lens.max()),
            "reduce_items": int(torch.clamp(torch.ceil(
                lens / bsr_ops.REDUCE_CHUNK), min=1).sum())}
    report["pair_runs"] = runs_stats
    log("[kernel check] pairs per run " + json.dumps(runs_stats))
    log(f"[kernel check] shapes: range_mask N={a.capacity}; semiring_matmul "
        f"{dm}x{dk}x{dn}; bsr_pairlist {len(mm_plan.pair_a)} pairs, "
        f"{len(mm_plan.a_blocks)}+{len(mm_plan.b_blocks)} tiles -> {n_c}; "
        f"bsr_pairlist_reduce {len(rd_plan.pair_a)} pairs, "
        f"{len(rd_plan.a_blocks)}+{len(rd_plan.b_blocks)} tiles -> {n_o}; "
        f"bsr_spgemm(_reduce) {dm}x{dk}x{dn}, {int(uni_mask.sum())} and "
        f"{int(mk_mask.sum())} of {mk_mask.numel()} A tiles present; "
        f"rank_count {rk_i.shape[0]} x {rk_j.shape[0]}; segment_scan "
        f"N={sk_keys.shape[0]} ({int(sk_keys[-1]) + 1} runs)")

    # -- phase 5: times (plus_times) beside the bound --------------------------
    tile_b = 128 * 128 * 4
    x, y = dn_ops(pt)
    mm_at, mm_bt = mm_tiles(pt)
    rd_at, rd_bt = rd_tiles(pt)
    pa, pb, pc = (p.long() for p in mm_pairs)
    qa, qb, qo = (p.long() for p in rd_pairs)

    def bmm_index_add():
        c = torch.zeros((n_c, 128, 128), device=dev)
        return c.index_add_(0, pc, torch.bmm(mm_at[pa], mm_bt[pb]))

    def bmm_sum_index_add():
        o = torch.zeros((n_o, 128), device=dev)
        return o.index_add_(0, qo, torch.bmm(rd_at[qa], rd_bt[qb]).sum(2))

    # range_mask's bound: rows read, keep written, cols read only where
    # the row is inside the box (12 bytes an entry where every cols line
    # is read)
    n_rm = a.capacity
    rm_bytes = rm_ops.range_mask_bytes(a.rows, bounds)
    log(f"[bytes] range_mask N={n_rm}: {rm_bytes} bytes with cols read "
        f"where the row is inside ({(rm_bytes - 8 * n_rm) // 4} rows inside), "
        f"{12 * n_rm} with every cols line read "
        f"({12 * n_rm / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    report["range_mask_bytes"] = {"gated": rm_bytes, "all": 12 * n_rm}
    p_mm, p_rd = len(mm_plan.pair_a), len(rd_plan.pair_a)
    # the block-masked kernels: A with its absent tiles zeroed, for the
    # library yardstick (at n=12 every tile is present)
    n_present = int(uni_mask.sum())
    x_masked = torch.where(uni_mask.repeat_interleave(128, 0)
                           .repeat_interleave(128, 1) != 0, x, 0.0)
    launches = {k: sum(p[k] for p in report["launches"].values())
                for k in LAUNCHES}
    rows = [
        dict(name="range_mask", route="cuda",
             source="src/repro_torch/csrc/range_mask.cu",
             replaces="src/repro/kernels/range_extract/range_extract.py:37",
             kernel=lambda: rm_ops.range_mask_cuda(*rm_in),
             plain=lambda: range_mask_ref(*rm_in), library=None,
             bytes=rm_bytes, ops=0, repeats=50, clean_l2=True,
             extra={"bound_all_cols_ms": 12 * n_rm / HBM_BYTES_PER_S * 1e3}),
        dict(name="bsr_pairlist", route="cuda-wgmma-tf32x3",
             source="src/repro_torch/csrc/bsr_pairlist_tf32_sm90.cu",
             replaces="src/repro/kernels/bsr_spgemm/pairlist.py:69",
             kernel=lambda: bsr_ops.pairlist_launch(
                 mm_at, mm_bt, *mm_pairs, n_c=n_c, sid=0),
             plain=lambda: bsr_ref.bsr_pairlist_ref(
                 mm_at, mm_bt, *mm_pairs, n_c=n_c, semiring=pt),
             library=bmm_index_add,
             bytes=(len(mm_plan.a_blocks) + len(mm_plan.b_blocks) + n_c)
             * tile_b + 12 * p_mm,
             ops=2 * 128 ** 3 * p_mm, tf32x3=True, repeats=3),
        dict(name="bsr_pairlist_reduce", route="cuda-wgmma-tf32x3",
             source="src/repro_torch/csrc/bsr_pairlist_tf32_sm90.cu",
             replaces="src/repro/kernels/bsr_spgemm/pairlist.py:131",
             kernel=lambda: bsr_ops.pairlist_reduce_launch(
                 rd_at, rd_bt, *rd_pairs, n_o=n_o, axis=1, sid=0),
             plain=lambda: bsr_ref.bsr_pairlist_reduce_ref(
                 rd_at, rd_bt, *rd_pairs, n_o=n_o, axis=1, semiring=pt),
             library=bmm_sum_index_add,
             bytes=(len(rd_plan.a_blocks) + len(rd_plan.b_blocks)) * tile_b
             + 12 * p_rd + 512 * n_o,
             ops=2 * 128 ** 3 * p_rd, tf32x3=True, repeats=3),
        dict(name="semiring_matmul", route="cuda-wgmma-tf32x3",
             source="src/repro_torch/csrc/semiring_tf32_sm90.cu",
             replaces="src/repro/kernels/semiring_matmul/semiring_matmul.py:53",
             kernel=lambda: sm_ops.semiring_matmul(x, y, semiring=pt,
                                                   impl="cuda"),
             plain=lambda: semiring_matmul_ref(x, y, semiring=pt),
             library=lambda: torch.matmul(x, y),
             bytes=4 * (dm * dk + dk * dn + dm * dn),
             ops=2 * dm * dk * dn, tf32x3=True, repeats=5),
        dict(name="bsr_spgemm_reduce", route="cuda-wgmma-tf32x3",
             source="src/repro_torch/csrc/semiring_tf32_sm90.cu",
             replaces="src/repro/kernels/bsr_spgemm/bsr_spgemm.py:153",
             kernel=lambda: bsr_ops.bsr_spgemm_reduce(
                 x, uni_mask, y, axis=1, semiring=pt, impl="cuda"),
             plain=lambda: bsr_ref.bsr_spgemm_reduce_ref(
                 x, uni_mask, y, axis=1, semiring=pt),
             library=lambda: torch.matmul(x_masked, y).sum(1),
             bytes=4 * (n_present * 128 * 128 + dk * dn + uni_mask.numel()
                        + dm),
             ops=2 * 128 ** 3 * n_present * (dn // 128), tf32x3=True,
             repeats=5),
        dict(name="bsr_spgemm", route="cuda-wgmma-tf32x3",
             source="src/repro_torch/csrc/semiring_tf32_sm90.cu",
             replaces="src/repro/kernels/bsr_spgemm/bsr_spgemm.py:74",
             kernel=lambda: bsr_ops.bsr_spgemm_cuda(x, uni_mask, y, sr=pt),
             plain=lambda: bsr_ref.bsr_spgemm_ref(x, uni_mask, y,
                                                  semiring=pt),
             library=lambda: torch.matmul(x_masked, y),
             bytes=4 * (n_present * 128 * 128 + dk * dn + uni_mask.numel()
                        + dm * dn),
             ops=2 * 128 ** 3 * n_present * (dn // 128), tf32x3=True,
             repeats=5),
        dict(name="rank_count", route="cuda",
             source="src/repro_torch/csrc/rank_count.cu",
             replaces="src/repro/kernels/sorted_merge/sorted_merge.py:48",
             kernel=lambda: rc_ops.rank_count_cuda(rk_i, rk_j),
             plain=lambda: rank_count_ref(rk_i, rk_j),
             library=lambda: (torch.searchsorted(rk_j, rk_i),
                              torch.searchsorted(rk_j, rk_i, right=True)),
             bytes=4 * (rk_i.shape[0] + rk_j.shape[0]) + 8 * rk_i.shape[0],
             ops=0, repeats=50),
        dict(name="segment_scan", route="cuda",
             source="src/repro_torch/csrc/segment_scan.cu",
             replaces="src/repro/kernels/segment_reduce/segment_reduce.py:65",
             kernel=lambda: ss_ops.segment_scan_cuda(sk_keys, sk_quarter),
             plain=lambda: segment_scan_ref(sk_keys, sk_quarter),
             library=None, bytes=12 * sk_keys.shape[0], ops=0, repeats=50,
             clean_l2=True),
    ]
    kernels = []
    for r in rows:
        ms = cuda_ms(r["kernel"], r["repeats"])
        plain_ms = cuda_ms(r["plain"], max(1, r["repeats"] // 2))
        lib_ms = (cuda_ms(r["library"], max(1, r["repeats"] // 2))
                  if r["library"] else None)
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_fp32 = r["ops"] / FP32_FLOP_PER_S * 1e3
        # the TF32 route's bound is its three tensor-core products
        t_ops = (tf32x3_bound_ms(r["ops"] // 2) if r.get("tf32x3")
                 else t_fp32)
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "max_abs_err": max(errs[r["name"]].values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})
        if r.get("tf32x3"):
            kernels[-1]["bound_fp32_ms"] = max(t_bytes, t_fp32)
        kernels[-1].update(r.get("extra", {}))
        if r.get("clean_l2"):
            kernels[-1]["ms_clean_l2"] = cuda_ms_clean_l2(r["kernel"],
                                                          r["repeats"])
            log(f"[time] {r['name']} with L2 clean before each call (read, "
                f"not written): {kernels[-1]['ms_clean_l2']:.4f} ms")
        ratio = ("" if lib_ms is None
                 else f", kernel / library {ms / lib_ms:.3f}")
        fp32 = (f", fp32 CUDA-core bound {max(t_bytes, t_fp32):.4f} ms"
                if r.get("tf32x3") else "")
        log(f"[time] {r['name']} ({r['route']}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
            f"{ratio}, bound {max(t_bytes, t_ops):.4f} ms "
            f"({kernels[-1]['bound_by']}){fp32}")
        del r["kernel"], r["plain"], r["library"]
    kernels.append(flash_row)
    kernels.append(bwd_row)
    # segment_scan at each of its inputs (quarter values, sum): device ms
    # with L2 evicted by a write (the table's reading) and by a read, each
    # beside its 12-bytes-an-element bound; torch.cumsum of the 2^21 values
    # (CUB's one-pass scan without keys: not the same function) as a
    # reference for a one-pass scan on this card
    scan_times = {}
    for label, keys in scan_in.items():
        q = quarter_values(keys.shape[0], gen, dev)
        fn = (lambda k=keys, v=q: ss_ops.segment_scan_cuda(k, v))
        scan_times[label] = {
            "n": keys.shape[0],
            "ms": cuda_ms(fn, 50), "ms_clean_l2": cuda_ms_clean_l2(fn, 50),
            "bound_ms": 12 * keys.shape[0] / HBM_BYTES_PER_S * 1e3}
        if label == "2^21 pair ids":
            scan_times[label]["torch_cumsum_ms"] = cuda_ms(
                lambda v=q: torch.cumsum(v, 0), 50)
        del q
    log("[time] segment_scan by input (sum, quarter values) "
        + json.dumps(scan_times))
    report["segment_scan_times"] = scan_times
    for label, t in scan_times.items():
        for key in ("ms", "ms_clean_l2"):
            if t[key] < t["bound_ms"]:
                failures.append(f"segment_scan {label}: {key} {t[key]} is "
                                f"below its bound {t['bound_ms']} ms")
    del scan_in
    torch.cuda.empty_cache()
    # device memory one call of each TF32 product takes beyond its inputs
    # (the output and the split operands' scratch, 2(M + N)K fp32)
    call_mb = {}
    for k, fn in (("semiring_matmul", lambda: sm_ops.semiring_matmul(
            x, y, semiring=pt, impl="cuda")),
                  ("bsr_spgemm", lambda: bsr_ops.bsr_spgemm_cuda(
                      x, uni_mask, y, sr=pt))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        call_mb[k] = (torch.cuda.max_memory_allocated() - base) / 1e6
    log(f"[memory] peak MB one call allocates beyond its inputs "
        f"{json.dumps(call_mb)}")
    report["call_peak_mb"] = call_mb
    # a time under the least the card could take is a fault of the timing
    for k in kernels:
        for key in ("ms", "ms_clean_l2"):
            if key in k and k[key] < k["bound_ms"]:
                failures.append(f"{k['name']}: {key} {k[key]} is below its "
                                f"bound {k['bound_ms']} ms")
    # rank_count is a microsecond kernel: its host work per call (checks,
    # one allocation, a memset and the launch) against the library's
    rc_host = {"kernel": host_ms(lambda: rc_ops.rank_count_cuda(rk_i, rk_j),
                                 200),
               "library": host_ms(lambda: (torch.searchsorted(rk_j, rk_i),
                                           torch.searchsorted(rk_j, rk_i,
                                                              right=True)),
                                  200)}
    log(f"[time] rank_count per call by the host's clock: kernel "
        f"{rc_host['kernel']:.4f} ms, library {rc_host['library']:.4f} ms, "
        f"kernel / library {rc_host['kernel'] / rc_host['library']:.3f}")
    report["rank_count_host_ms"] = rc_host
    # per-semiring kernel times beside each route's bound
    by_sr = {}
    dense_macs = dm * dk * dn
    mask_macs = 128 ** 3 * n_present * (dn // 128)
    for name in SEMIRINGS:
        sr = REGISTRY[name]
        sid = cuda_lib.kernel_semiring_id(sr)
        xs, ys = dn_ops(sr)
        ats, bts = mm_tiles(sr)
        ars, brs = rd_tiles(sr)
        by_sr[name] = {
            "route": sm_ops.route(sr),
            "semiring_matmul": cuda_ms(lambda: sm_ops.semiring_matmul(
                xs, ys, semiring=sr, impl="cuda"), 3),
            "bsr_spgemm_reduce": cuda_ms(
                lambda: bsr_ops.bsr_spgemm_reduce(xs, uni_mask, ys, axis=1,
                                                  semiring=sr, impl="cuda"),
                3),
            "bsr_spgemm": cuda_ms(lambda: bsr_ops.bsr_spgemm_cuda(
                xs, uni_mask, ys, sr=sr), 3),
            "bsr_pairlist": cuda_ms(lambda: bsr_ops.pairlist_launch(
                ats, bts, *mm_pairs, n_c=n_c, sid=sid), 2),
            "bsr_pairlist_reduce": cuda_ms(
                lambda: bsr_ops.pairlist_reduce_launch(
                    ars, brs, *rd_pairs, n_o=n_o, axis=1, sid=sid), 2),
            "cuda_core_bound_ms": cuda_core_bound_ms(name, dense_macs)}
        if sm_ops.route(sr) == "tf32x3":
            by_sr[name]["tf32x3_bound_ms"] = tf32x3_bound_ms(dense_macs)
        route_bound = by_sr[name].get("tf32x3_bound_ms",
                                      by_sr[name]["cuda_core_bound_ms"])
        for k in ("semiring_matmul", "bsr_spgemm_reduce", "bsr_spgemm"):
            macs = dense_macs if k == "semiring_matmul" else mask_macs
            bound = route_bound * macs / dense_macs
            if by_sr[name][k] < bound:
                failures.append(f"{k} under {name}: {by_sr[name][k]} ms is "
                                f"below its bound {bound} ms")
        # the pair kernels: the route's bound at their pairs' MACs
        for k, pairs in (("bsr_pairlist", p_mm), ("bsr_pairlist_reduce", p_rd)):
            bound = route_bound * 128 ** 3 * pairs / dense_macs
            by_sr[name][f"{k}_bound_ms"] = bound
            if by_sr[name][k] < bound:
                failures.append(f"{k} under {name}: {by_sr[name][k]} ms is "
                                f"below its bound {bound} ms")
        if name in ("max_plus", "plus_times"):
            by_sr[name]["clocks_under_load"] = clocks_under_load(
                lambda: sm_ops.semiring_matmul(xs, ys, semiring=sr,
                                               impl="cuda"), 60)
        del xs, ys, ats, bts, ars, brs
    log("[time] kernel ms by semiring, with the CUDA-core bound (FMA pipe "
        f"{FMA_PIPE_PER_CLK}, ALU pipe {ALU_PIPE_PER_CLK}, issue "
        f"{ISSUE_PER_CLK} a clock per SM, {SM_COUNT} SMs at "
        f"{SM_CLOCK_HZ / 1e9} GHz) and the TF32 route's "
        + json.dumps(by_sr))
    report["ms_by_semiring"] = by_sr
    # the masked kernels where the mask skips work: the seeded 1/4 mask
    xq, yq = mk_ops(pt)
    xq_masked = torch.where(mk_mask.repeat_interleave(128, 0)
                            .repeat_interleave(128, 1) != 0, xq, 0.0)
    q_present = int(mk_mask.sum())
    q_flops = 2 * 128 ** 3 * q_present * (yq.shape[1] // 128)
    quarter = {"present_tiles": q_present, "tiles": mk_mask.numel(),
               "bound_ms": tf32x3_bound_ms(q_flops // 2),
               "bound_fp32_ms": q_flops / FP32_FLOP_PER_S * 1e3}
    for k, kernel, plain, library in (
            ("bsr_spgemm_reduce",
             lambda: bsr_ops.bsr_spgemm_reduce(xq, mk_mask, yq, axis=1,
                                               semiring=pt, impl="cuda"),
             lambda: bsr_ref.bsr_spgemm_reduce_ref(xq, mk_mask, yq, axis=1,
                                                   semiring=pt),
             lambda: torch.matmul(xq_masked, yq).sum(1)),
            ("bsr_spgemm",
             lambda: bsr_ops.bsr_spgemm_cuda(xq, mk_mask, yq, sr=pt),
             lambda: bsr_ref.bsr_spgemm_ref(xq, mk_mask, yq, semiring=pt),
             lambda: torch.matmul(xq_masked, yq))):
        quarter[k] = {"ms": cuda_ms(kernel, 5), "plain_ms": cuda_ms(plain, 2),
                      "library_ms": cuda_ms(library, 2)}
        if quarter[k]["ms"] < quarter["bound_ms"]:
            failures.append(f"{k} at the 1/4 mask: {quarter[k]['ms']} ms is "
                            f"below its bound {quarter['bound_ms']} ms")
    log("[time] the masked kernels at the seeded 1/4 mask "
        + json.dumps(quarter))
    report["masked_kernels_quarter_mask"] = quarter
    del xq, yq, xq_masked

    # where the time of the products goes: spgemm's own stage spans, each
    # ended by a device sync
    stages = {}
    for name, fn in (("A @ B", lambda: a @ b),
                     ("A.sqout(reduce=1)", lambda: a.sqout(reduce=1)),
                     ("uniform A.matmul(B)", lambda: uni["A"].matmul(uni["B"])),
                     ("uniform A.sqout(reduce=1)",
                      lambda: uni["A"].sqout(reduce=1))):
        with spgemm.stage_timing() as ms:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        stages[name] = {"total": total, **ms}
        log(f"[stages] {name} ms " + json.dumps(stages[name]))
    # and of an ingest snapshot: one delta of all of B over the n=15 base
    # (kernel path), and the n=18 fallback; union memo cleared (cold), as
    # each new delta of a stream brings new keys
    ing_raw = ing["raw"]
    for name, base, (r2, c2, v2) in (
            (f"ingest snapshot n={N_INGEST}", ing["bases"]["sum"],
             (ing_raw[2], ing_raw[3], ing_raw[4])),
            (f"ingest fallback snapshot n={gen_n}", clus["A"],
             (clus["raw"][2][:N_FALLBACK], clus["raw"][3][:N_FALLBACK],
              np.ones(N_FALLBACK)))):
        table = IngestTable(base, aggregate="sum")
        table.insert(r2, c2, v2)
        clear_union_cache()
        with spgemm.stage_timing() as ms:
            t0 = time.perf_counter()
            table.snapshot()
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        stages[name] = {"total": total, **ms}
        log(f"[stages] {name} ms " + json.dumps(stages[name]))
    report["stages_ms"] = stages

    report["kernels"] = kernels
    smi = nvidia_smi_line()
    report["nvidia_smi"] = smi
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
