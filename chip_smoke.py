#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py                  # the phases below
    python3 chip_smoke.py --profile DIR    # also: torch.profiler
                                           # breakdowns of decode passes
                                           # and of train steps, in DIR

Phases, each printed on lines of its own:

1. card — ``nvidia-smi`` name and power limit; build the kernel library
   from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) and time it;
2. kernels — each hand-written kernel against its plain PyTorch version
   on the card: K1 ``rmsnorm`` in bf16 and f32 at the serving paths' 8 x
   2560, 8 x 2048, 8 x 4096, 8 x 5120, 128 x 128 and 8 x 512 (qwen1.5-4b's
   and zamba2-2.7b's norms, mamba2-1.3b's ln1 and gated norm, zamba2-2.7b's
   gated norm, olmoe-1b-7b's q/k norms, deepseek-v2-lite-16b's latent
   norm), the training paths' 8192 x 2560, 8192 x 4096, 8192 x 5120, 8192
   x 2048, 131072 x 128 and 8192 x 512 and a ragged shape (the narrow
   rows' instance timed beside ``block_row`` by the C entry point), and
   a bf16 width sweep of 8192 rows by 128 to 4096 columns (narrow
   instance, ``block_row``, ``F.rms_norm``: ``rmsnorm_sweep``); K2 ``fused_ff``
   in bf16 and f32 at the serving path's 8 x 2560 . 2560 x 6912, the
   decode threshold's neighbours (M 1, 3, 9, 16, 32), ragged shapes, the
   training path's 8192 rows, zamba2-2.7b's shared MLP (8 and 8192 rows .
   2560 x 10240), deepseek-v2-lite-16b's dense layer and shared
   experts (8 and 8192 rows . 2048 x 10944 and 2048 x 2816) and the
   pipeline step's tensor-parallel shard (2048 and 8192 rows . 2560 x
   3456), and serving with a mesh's decode shards (8 rows . 2560 x 1728
   and 2560 x 3456: phase 5d on (model 4) and (data 2, model 2)); K6
   ``flash_attention`` in f32 and bf16 at the training paths' shapes
   (stablelm-3b's and zamba2-2.7b's, olmoe-1b-7b's head dim 128, and
   deepseek-v2-lite-16b's MLA: q and k 192, v 128; the pipeline step's
   16 tensor-parallel heads of one sequence), a ragged GQA shape
   with a window, non-causal shapes and query offsets, and in bf16 at
   whisper-large-v3's (20 heads of 64 on ``wgmma_bq128_bk128_d64``:
   training's (4, 20, 2048, 64) non-causal and causal, serving's encoder
   (8, 20, 1536, 64) and the published 448-token context over 1500
   frames, the last also in f32 on ``simt_64x64``), each timed beside
   SDPA with its own causal flag; K3 ``matmul_leakyrelu`` and K4
   ``bmm`` in f32 and bf16 at ``tests/test_kernels.py``'s shapes, a ragged
   shape and the optimizer path's shapes; K5 ``softmax`` in f32 and bf16
   at ``tests/test_kernels.py``'s shape (512 x 4096, br 8), at 8192
   columns (the largest ``CONFIGS`` entry), at a ragged shape and at the
   PPO fleet path's shape (40960 x 4096: qwen1.5-4b's 20 heads x 2048
   query positions); K7 ``ssd`` in f32 and bf16 in the registry's flat
   layout at ``tests/test_kernels.py``'s shape (chunk 32 and 64) and in
   the model layout at the SSM training path's shape (mamba2-1.3b: (4,
   2048, 64, 64) x (4, 2048, 1, 128)), the hybrid's (zamba2-2.7b: (4,
   2048, 80, 64) x (4, 2048, 2, 64), N 64 through the N 128 instance,
   zero-padded), a ragged two-group shape, chunk
   128, P 128 with N 64, a strong decay, widths only its SIMT instance
   takes, a batch of one (timed with the segments the kernel picks and
   with one) and chunk counts that those segments do not divide; K6 in bf16 at each ``CONFIGS`` entry (bq, bk, d) on a
   causal shape and a GQA shape with a window and a query offset, and K3
   and K4 at each of their ``CONFIGS`` entries, in f32 and bf16.  Every
   K1, K2, K5 and K7 case, every bf16 path shape of K3, K4 and K6, every
   f32 path shape of K3 and K4 and every ``CONFIGS`` case of K3 and K4
   must launch the tiling its ``select_tiling`` names, read from the
   wrappers' per-tiling counts (``launches_by_tiling``), and each record
   names its tiling; at the path shapes the other instances (K1 each br
   that divides the rows, K2 each ``CONFIGS`` entry at 8192 rows, K5 each
   br, K7 chunk 128 beside the model's 64, K3 and K4 in f32 each SIMT
   tile of their ``CONFIGS``) are checked, asserted and timed beside the
   default, and at decode K2's default
   wgmma instance is launched through the library's C entry point and
   timed beside the gemv route; the
   gradients of the four model kernels' ``autograd.Function``s against
   autograd through the plain versions at the training shapes (K7's under
   the strong decay; K6's also at MLA's head dims); each kernel's time, as CUDA events around one call
   (host time included) and as device time (``device_ms``: its kernels'
   own time from torch.profiler), its plain version's and a library
   yardstick's beside its bound;
3. device against host — full-width qwen1.5-4b, mamba2-1.3b,
   olmoe-1b-7b and deepseek-v2-lite-16b cut to 2 layers, f32: paged
   decode logits agree within 1e-5 of the logit scale
   (deepseek-v2-lite-16b's against the host's f64 evaluation, within the
   host's own f32 error plus that); full-width stablelm-3b, mamba2-1.3b,
   olmoe-1b-7b and deepseek-v2-lite-16b cut to 2 layers and zamba2-2.7b
   cut to 12 (two groups: the shared block's gradient sums two
   applications), f32: one train step's loss and grad-norm agree (the
   grad-norm within a bound set by the host's own f32 error against an
   f64 evaluation); whisper-large-v3 cut to 2 encoder and 2 decoder
   layers: forward logits, then 8 decode passes over cross caches each
   device writes from its own encoding of 1536 frames, in f32 on the
   kernels, on weights at each layer's own fan-in (the init's stacked
   fan-in makes this cut chaotic), within 1e-5 of the logit scale of
   the host's (or, where the host's own f32 error exceeds that, no
   further from the host's f64 evaluation than the host plus 1e-5 of
   the scale); and its train step as above.  Phase 6's command lines
   (its searches, their ``--deploy`` runs, (f)'s ``launch.evaluate``
   and (g)'s refusal) run beside this phase, which times nothing: they
   are host-bound, and side by side they take about what the slowest
   takes;
4. serving main paths — qwen1.5-4b, mamba2-1.3b, zamba2-2.7b,
   olmoe-1b-7b and deepseek-v2-lite-16b at full width and about a
   quarter of their depth (``SERVE_LAYERS``: 10, 12, 12, 4 and 7 layers), bf16, seeded
   random weights, each 16 loadgen requests from 2 tenants through the
   paged ``ServeEngine`` (8 lanes); every request completes with in-vocab
   tokens, and the kernels' launch counts equal engine passes x
   ``serve_sites``: rmsnorm 2L + 1 and fused_ff L (qwen1.5-4b: 21, 10),
   rmsnorm 2L + 1 (mamba2-1.3b: 25), rmsnorm 2L + 2G + 1 and fused_ff G
   over G shared-block applications (zamba2-2.7b: 29, 2), rmsnorm 4L +
   1 with the q/k norms (olmoe-1b-7b: 17), rmsnorm 3L + 1 with the latent
   norm and fused_ff at the dense layer and each moe layer's shared
   experts (deepseek-v2-lite-16b: 22, 7); then zamba2-2.7b with its pool
   cut to 48 blocks, the trace's first 8 requests at once: at least one
   spill of pages and recurrent slot rows and one resume by upload, every
   request complete; then deepseek-v2-lite-16b's fork run: a donor
   prefills a 100-token prompt, 7 identical prompts map its MLA pages
   (latent and rope key) and fork the partial block copy-on-write (at
   least 7 prefix hits and 7 forks), and all 8 streams are equal; then
   whisper-large-v3 at full width and depth (32 + 32 layers), bf16, 8
   rows: encode 1536 seeded frames (K6 exactly 32 times), write every
   decoder layer's cross caches from the encoder's output, greedy-decode
   a 4-token prompt and 124 new tokens through ``decode_step`` (no launch
   a pass), and one ``generate()`` call over zero cross caches;
5. training main paths — stablelm-3b, mamba2-1.3b, then zamba2-2.7b, at
   full width, bf16, remat, seq 2048, global batch 4, 3 steps of
   ``Trainer`` each; every loss and grad-norm is finite, step 0's loss
   agrees with the same loss evaluated with every kernel replaced by its
   plain version, and the launch counts equal steps x ``train_sites``,
   forward and recompute: (4L + 1) (rmsnorm), 2L (fused_ff) and 2L
   (flash_attention) for stablelm-3b; (4L + 1) (rmsnorm) and 2L (ssd)
   for mamba2-1.3b; (4L + 4G + 1) (rmsnorm: 253), 2L (ssd: 108), 2G
   (flash_attention, fused_ff: 18) for zamba2-2.7b, whose remat
   recomputes each group of 6 Mamba-2 layers and the shared block as
   one unit; then olmoe-1b-7b and deepseek-v2-lite-16b at full width cut
   to the layers that fit one card beside AdamW's state
   (``TRAIN_LAYERS``: 8 and 6, the latter its dense layer and 5 moe
   layers), with (8L + 1) (rmsnorm: 65) and 2L (flash_attention: 16),
   and (6L + 1) (rmsnorm: 37), 2L (fused_ff, flash_attention: 12), each
   with its peak memory; then whisper-large-v3 at full width and depth
   (1.54 B parameters) on the pipeline's stub frames, K6 alone at 2 (E +
   2D) = 192 a step (each encoder layer's self-attention and each
   decoder layer's self- and cross-attention, in the forward and in
   remat's recompute); beside stablelm-3b's measured step, its roofline
   terms (``launch.jcost`` on fake tensors on the host at 1 and 2
   layers, extrapolated to the depth, over ``launch.roofline``'s H100
   peaks) and model_flops / (step_s x 989e12); then the remat policies:
   stablelm-3b at full width cut to 4 layers (``DOTS_LAYERS``), bf16,
   one step each from the same seeded parameters and batch without
   remat, under ``remat_policy="nothing"`` and under ``"dots"``:
   ``"dots"``'s loss equal to ``"nothing"``'s and its grad-norm within
   1e-6 relative, peak memory ordered ``"nothing"`` < ``"dots"`` < no
   remat, and the K1/K2/K6 launches of ``remat_sites``: 9 / 4 / 4
   without remat, 17 / 8 / 8 under ``"nothing"``, 17 / 4 / 4 under
   ``"dots"`` (its products' outputs saved, K2 and K6 among them: not
   launched again in the recompute);
5b. the pipeline train step — stablelm-3b at full width on 4 ranks
   spawned on the one card (``launch.mesh.run_ranks``: gloo, every
   collective staged through the host; NCCL refuses two ranks on one
   device), global batch 4 x seq 2048 in 4 microbatches: (a) parity in
   f32 at 2 layers with deterministic algorithms, 2 steps each of
   (pipe=2, model=2) under gpipe and 1f1b and of (pod=2, pipe=2) with
   the compressed pod reduction (overlapped and monolithic) and in f32,
   against the mesh-less step on the card from the same seeded parameters
   and batches: loss within 1e-4 and grad-norm within 1e-3 relative
   (compressed runs: step 0, and the last loss within 2e-2 of the f32
   run's), 1f1b equal to gpipe and overlapped equal to monolithic
   exactly, the error-feedback residual non-zero; (b) 3 ``Trainer``
   steps in bf16 at 4 layers on (pipe=2, model=2): seconds a step, each
   rank's peak memory, the transport, and each rank's launches of K1, K2
   and K6 held to ``pipe_sites`` (the schedule's rows x the stage's
   layers, forward and recompute, + the final norm: 41 / 20 / 20 a step),
   K2 at the d_ff / 2 column shard and K6 at n_heads / 2 heads on the
   tilings ``select_tiling`` names;
5c. the GSPMD train step (``make_train_step(mesh=...)``) on 4 ranks
   spawned on the one card as in 5b: (a) f32 parity, deterministic,
   stablelm-3b at full width and 4 layers on the draw at each layer's
   own fan-in, 2 steps on (data=2, model=2) and on (model=4) with
   ``seq_parallel``, against the mesh-less step on the card (loss 1e-4,
   grad-norm 1e-3 relative); (b) olmoe-1b-7b at full width and 2 layers
   on (model=4), f32: ``apply_moe_ep`` on each rank against the
   one-process ``apply_moe_ep_plain`` (1e-5 of the scale) with each
   rank's packed slots equal to the plain version's, and
   ``apply_moe_ep_replicated`` at a sequence 4 does not divide against
   the dense layer; 2 steps against mesh-less steps whose MoE layers
   compute the plain version (5b's bounds); (c) 3 bf16 ``Trainer`` steps
   of stablelm-3b at 4 layers on (data=2, model=2) and of olmoe-1b-7b at
   2 layers on (model=4): seconds a step, each rank's peak memory, and
   each rank's K1/K2/K6 launches held to ``gspmd_sites`` (17 / 8 / 8
   and 17 / 0 / 4 a step), on the tilings ``select_tiling`` names, with
   the operand shapes the calls took held to the shard shapes
   (``gspmd_shapes``: K2 4096 x 2560 . 2560 x 3456, K6 (2, 16, 2048, 80)
   and (4, 4, 2048, 128)), and every rank's head computing the logits of
   its vocabulary block alone (50304 / model columns: the embedding,
   head and loss are vocabulary-parallel);
5d. serving with a mesh (``generate(mesh=)``, ``ServeEngine(mesh=)``) on
   4 ranks spawned on the one card as in 5b, each holding its blocks of
   the parameters and caches: (a) f32 parity at full width cut to 2
   layers (zamba2-2.7b: 6) on the draw at each layer's own fan-in, on
   (data=2, model=2) and (model=4): ``generate(mesh=)`` of qwen1.5-4b,
   gemma3-1b (on (model 4) also cut to 1 layer over 516 new tokens, past
   its 512-position window), olmoe-1b-7b, deepseek-v2-lite-16b and
   mamba2-1.3b over 8 rows, and a paged ``ServeEngine(mesh=)`` run of
   qwen1.5-4b and of zamba2-2.7b over 4 requests into a pool of 4 blocks
   (a spill and a resume): each pass's logits within 1e-5 of the logit
   scale of the mesh-less run on the card (deepseek by
   ``_hold_to_host``'s f64 route where needed), the streams and counters
   equal to the mesh-less ones and on every rank; (b) bf16, qwen1.5-4b
   at full width and 2 layers (``SERVE_MESH_TIMING_LAYERS``: deeper did
   not fit the time limit) on (model=4) through the paged engine, phase 4's 16 requests
   submitted at once: ms a pass of the slowest rank, tokens/s, each
   rank's peak memory and KV-pool bytes beside phase 4's mesh-less
   figures; each rank's pool a quarter of the mesh-less pool, the
   streams equal on every rank, K1/K2 launches = passes x
   ``serve_sites`` (9 / 4 a pass), K2 on ``gemv_m8`` and every K1/K2
   call at the shard shapes (8 x 2560; 8 x 2560 . 2560 x 1728);
6. optimizer main paths (their command lines run beside phase 3, their
   output held here) — (a) ``python -m repro_torch.launch.optimize
   matmul_leakyrelu bmm --strategy greedy`` into a fresh schedule cache
   must print the reference's cycles (8294 -> 8289, 8275 -> 8271), then
   ``--deploy`` must read the artifacts back; each deployed kernel is
   launched through the registry, ``get_kernel(name).kernel_fn(a, b,
   **artifact.config)``, on the card at the path's shapes in bf16 and f32
   and held against ``ref_fn``, and each launches once per call;
   (b) the PPO fleet: ``python -m repro_torch.launch.optimize --arch
   qwen1.5-4b --timesteps 2048`` (the default strategy, ppo, with its
   agent on the card; the budget cut from the default 8192 so that the
   18 cells fit) into a fresh cache: every cell starts at the reference's
   ``-O3`` cycles and ends at or below them, and ``--deploy`` reads the 18
   back; one cell, softmax at the first bucket, runs at the default
   budget, timed; then each of the six deployed kernels is launched
   through the registry at the first bucket's config, in bf16 and f32, at
   the path's shapes, held against ``ref_fn``, twice each; (c) the SSM
   fleet: ``--arch mamba2-1.3b --strategy greedy`` into a fresh cache
   must print the reference's 16 cells and memo line (the cache kept
   for (h)), ``--deploy`` must read them back, and the deployed ``ssd``
   is launched through the
   registry at the first bucket's config in bf16 and f32, once a call;
   (d) the deployed config chooses the tiling: K3's and K4's deployed
   configs (the pair's), K1's, K2's, K5's and K6's (the fleet's first
   bucket's) and K7's (the SSM fleet's), each beside another entry of its
   ``CONFIGS`` that names another instance (K7: the other chunk of 64
   and 128), launched through the registry at the path's shapes, in bf16
   for all seven and in f32 for K2, K3, K4 and K6, must launch the
   instance each names and agree with ``ref_fn``; (e) the guided
   searches: ``launch.optimize matmul_leakyrelu bmm --strategy beam``,
   then ``--strategy lookahead`` (oracle-ranked), each into a fresh cache,
   must print the reference's cycles (8294 -> 8286 and 8275 -> 8268;
   8294 -> 8288 and 8275 -> 8270) and shared-memo lines, ``--deploy``
   must read them back, and K3 and K4 at the beam artifacts' configs are
   launched through the registry in bf16 and f32, each in the instance
   ``select_tiling`` names, against ``ref_fn``; (f) the cost model on the
   card: ``launch.evaluate --budget 512 --train-cost-model`` runs the
   default roster of seven strategies with the PPO warm phase's agent and
   the model on the card, with beam-cost within a quarter of greedy's
   measurements on each kernel and a held-out Spearman of at least 0.5
   (the Spearman against the reference test's 0.8, and beam-cost's
   cycles against greedy's, printed, not held: ROADMAP §C);
   two fits on the card from the saved dataset must be bit-equal and the
   saved model must predict what the live fit predicts; (g) tuned
   schedules served: ``launch.serve --arch qwen1.5-4b --full --qps 4
   --requests 8 --schedule-cache DIR --strict-schedules`` over the cache
   (b) wrote prints the 18-line plan with no fallback, completes every
   request with in-vocab tokens, and launches K1 and K2 passes x 81 and
   x 40 times; over an empty cache it exits non-zero before serving, and
   without ``--strict-schedules`` serves with 18 ``-O3 baseline`` lines,
   the warning and 18 ``schedule_fallbacks``; (h) tuned SSM serving:
   ``launch.serve --arch mamba2-1.3b --full --qps 4 --requests 8
   --schedule-cache DIR --strict-schedules`` over the cache (c) wrote
   prints the 16-line plan with no fallback, completes every request and
   launches K1 passes x 97 times;
7. the ``{"kernels": [...]}`` line (K1-K7, with their launches by path
   — serve, serve_ssm, serve_hybrid, serve_hybrid_spill, serve_moe,
   serve_mla, serve_mla_fork, serve_encdec, train, train_ssm,
   train_hybrid, train_moe, train_mla, train_encdec, train_dots, train_pipe,
   train_gspmd and serve_mesh (each summed over the ranks) and the
   optimizer paths —
   and by path and tiling),
   then the last line: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line.  No phase catches its
own failure, and nothing falls back to the CPU or to a plain version.
Needs the repository's ``src/`` beside this file; imports nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import atexit
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Serving path shapes at qwen1.5-4b full width with 8 lanes.
LANES, D_MODEL, D_FF = 8, 2560, 6912
# Training path shapes at stablelm-3b full width: global batch 4 x seq 2048.
BATCH, SEQ, HEADS, HEAD_DIM = 4, 2048, 32, 80
ROWS = BATCH * SEQ
# Optimizer path shapes: K3 as a 3B-class MLP up-projection (8192 rows of
# width 2560 into 6912), K4 as qwen1.5-4b's 20 heads of 128 over 2048
# positions.
MLR_SHAPE = (ROWS, D_MODEL, D_FF)               # M, K, N
BMM_SHAPE = (20, 2048, 128, 2048)               # B, M, K, N
# what launch.optimize prints for the pair: the reference's cycles
OPTIMIZE_LINES = {"matmul_leakyrelu": "8294 -> 8289 cycles",
                  "bmm": "8275 -> 8271 cycles"}
# The PPO fleet path: qwen1.5-4b's kernel fleet, 6 kernels x 3 buckets,
# each cell starting at the reference's -O3 cycles (the same in every
# bucket), searched at a budget cut from the default 8192 timesteps.
FLEET_ARCH, FLEET_TIMESTEPS, FLEET_CELLS = "qwen1.5-4b", 2048, 18
FLEET_O3 = {"matmul_leakyrelu": 35519, "fused_ff": 9631, "rmsnorm": 29371,
            "flash_attention": 6488, "softmax": 66060, "bmm": 8275}
FLEET_BUCKET = "256x4096xf32"          # the fleet's first bucket
# K5 at the fleet path's shape: qwen1.5-4b's 20 heads x 2048 query
# positions, 4096 columns (the deployed config's)
SOFTMAX_ROWS = 20 * 2048
# The SSM training path, mamba2-1.3b at full width: global batch 4 x seq
# 2048, 64 SSD heads of P 64, one group, state N 128, d_inner 4096 (the
# gated norm's width); K7 in the model layout.
SSM_ARCH, D_INNER = "mamba2-1.3b", 4096
SSM_SHAPE = (BATCH, SEQ, 64, 1, 64, 128)       # B, S, H, G, P, N
# Its serving path: 8 lanes of d_model 2048 (ln1) and d_inner 4096 (the
# gated norm).
SSM_D_MODEL = 2048
# The hybrid paths, zamba2-2.7b at full width: 54 Mamba-2 layers of
# d_model 2560 (d_inner 5120: 80 SSD heads of P 64 in 2 groups, state N
# 64) and one shared attention + MLP block (32 heads of 80, d_ff 10240)
# after every 6 (9 applications); trained at global batch 4 x seq 2048.
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_D_INNER, HYBRID_D_FF = 5120, 10240
HYBRID_SSM_SHAPE = (BATCH, SEQ, 80, 2, 64, 64)  # B, S, H, G, P, N
# The SSM fleet: greedy over mamba2-1.3b's 4 kernels x 4 buckets, the
# reference's cycles (the same in the first three buckets)
SSM_FLEET_CYCLES = {"matmul_leakyrelu": ("35519 -> 35504", "10458 -> 10455"),
                    "fused_ff": ("9631 -> 9121", "9631 -> 9121"),
                    "rmsnorm": ("29371 -> 29349", "29371 -> 29349"),
                    "ssd": ("3945 -> 3943", "3945 -> 3943")}
SSM_BUCKETS = ("b256_s4096_f32_full", "b32_s32768_f32_full",
               "b128_s32768_f32_half", "b1_s524288_f32_low")
# The guided searches on the pair, oracle-ranked (--strategy beam,
# lookahead): the reference's cycles and shared-memo lines
GUIDED_LINES = {"beam": {"matmul_leakyrelu": "8294 -> 8286 cycles",
                         "bmm": "8275 -> 8268 cycles"},
                "lookahead": {"matmul_leakyrelu": "8294 -> 8288 cycles",
                              "bmm": "8275 -> 8270 cycles"}}
GUIDED_MEMO = {"beam": "[optimize] shared memo: 14126 entries, 2/14128 hits "
                       "(0.0%), 0 cross-kernel",
               "lookahead": "[optimize] shared memo: 16393 entries, "
                            "5268/21661 hits (24.3%), 0 cross-kernel"}
# launch.evaluate's per-cell measurement budget (its default, the
# reference acceptance test's)
EVAL_BUDGET = 512
# The held-out Spearman below which the cost model does not rank: far
# below every run of either package (0.685-0.872 over seeds 0-11, with
# each package's own PRNG or one numpy noise stream for both,
# tools/costmodel_seeds.py), far above a model that does not rank (about
# 0).  The reference test's 0.8 sits inside that spread, a coin at one
# seed for the reference itself (ROADMAP §C).
SPEARMAN_FLOOR = 0.5
# requests served over the PPO fleet's tuned schedules
TUNED_REQUESTS = 8
# The moe paths: olmoe-1b-7b (16 layers, d_model 2048, 16 heads of
# 128 with q/k norms, 64 experts top-8 of d_ff 1024) and
# deepseek-v2-lite-16b (27 layers, the first a dense layer of d_ff 10944,
# MLA with a 512-wide latent, q and k heads of 192 = 128 + 64 rope and v
# heads of 128, 64 experts top-6 of d_ff 1408 and 2 shared experts: 2816
# wide).  Served at full width and depth; trained at full width with the
# layers that fit one card beside AdamW's state (PERF.md §4).
MOE_ARCH, MLA_ARCH = "olmoe-1b-7b", "deepseek-v2-lite-16b"
MOE_D_MODEL, MOE_HEADS, MOE_HEAD_DIM = 2048, 16, 128
MLA_D_FF, MLA_SHARED_D_FF, MLA_LATENT = 10944, 2816, 512
MLA_QK_DIM, MLA_V_DIM = 192, 128
TRAIN_LAYERS = {MOE_ARCH: 8, MLA_ARCH: 6}
# the fork run: one donor prefills a prompt of this many tokens (6 blocks
# of 16 and a partial seventh), then this many identical prompts map its
# pages and fork the partial block on their first write
FORK_PROMPT, FORK_SHARERS, FORK_NEW_TOKENS = 100, 7, 32
# The encoder-decoder, whisper-large-v3 (32 encoder and 32 decoder layers,
# d_model 1280, 20 heads of 64, vocab 51866): trained at full width and
# depth on the pipeline's stub frames (frames = tokens = 2048), served by
# encoding ENC_LEN_DECODE frames for 8 rows, writing every decoder
# layer's cross caches from the encoder's output and decoding greedily.
# K6 runs on every attention of the forward at D 64: the encoder's
# (non-causal), the decoder's self-attention (causal) and its
# cross-attention (non-causal, Sq tokens against Sk frames).
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_HEADS, ENCDEC_HEAD_DIM = 20, 64
ENCDEC_TILINGS = {"bfloat16": "wgmma_bq128_bk128_d64",
                  "float32": "simt_64x64"}
# whisper's published decoder context (448 tokens) over the 1500 encoder
# frames of 30 s of audio: Sq != Sk, and Sk a ragged multiple of the tile
ENCDEC_CONTEXT, ENCDEC_AUDIO_FRAMES = 448, 1500
# phase 4: a prompt of this many tokens, then this many greedy ones
ENCDEC_PROMPT, ENCDEC_NEW_TOKENS = 4, 124
SSM_FLEET_TAIL = ("[optimize] campaign: 16 succeeded (0 degraded), 0 failed",
                  "[optimize] shared memo: 7399 entries, 30017/37416 hits "
                  "(80.2%), 0 cross-kernel")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


_PHASE = {"name": None, "t0": 0.0}


def phase(name: str) -> None:
    """Start phase ``name``, printing the seconds the previous one took."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"  phase {_PHASE['name']} took {now - _PHASE['t0']:.1f} s",
              flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
        print(f"== {name} (at {time.strftime('%H:%M:%S')})", flush=True)


def event_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of one call of ``fn`` (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` (ms): the summed duration of the
    kernels it launched, from torch.profiler's kernel events over
    ``iters`` calls.  Beside ``event_ms``, which times one call on an idle
    card and so includes the host's time to launch it, this splits a
    call's time between host and device."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    # now and then a profile on the card comes back without its kernel
    # events, where a profile of the same calls taken again records them:
    # take it again, up to twice more
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return sum(e.time_range.end - e.time_range.start
                       for e in kernels) / iters / 1e3
        print(f"  torch.profiler recorded no kernel on the card (attempt "
              f"{attempt + 1} of 3)", flush=True)
    fail("torch.profiler recorded no kernel on the card")


def timed(fn, iters: int = 30):
    """(``event_ms``, ``device_ms``) of ``fn``."""
    return event_ms(fn, iters), device_ms(fn, max(5, iters // 2))


def bound(nbytes: float, ops: float, dtype: str):
    # the H100 SXM peaks, kept in one place with their sources
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

KERNELS = {   # name -> (source, the TPU kernel it replaces, headline path)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:26", "train"),
    "fused_ff": ("src/repro_torch/kernels/csrc/fused_ff.cu",
                 "src/repro/kernels/fused_ff.py:40", "train"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:66", "train"),
    "matmul_leakyrelu": ("src/repro_torch/kernels/csrc/gemm.cu",
                         "src/repro/kernels/matmul_leakyrelu.py:43",
                         "optimize"),
    "bmm": ("src/repro_torch/kernels/csrc/gemm.cu",
            "src/repro/kernels/bmm.py:35", "optimize"),
    "softmax": ("src/repro_torch/kernels/csrc/softmax.cu",
                "src/repro/kernels/softmax.py:23", "fleet"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
            "src/repro/kernels/ssd.py:65", "train_ssm"),
}


def check_close(name, got, want, atol, rtol):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    print(f"  {name}: max|d| {err:.3e} (atol {atol:g}, rtol {rtol:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def launched(mod, fn):
    """``fn()`` and the tilings it launched, by ``mod``'s per-tiling count
    (a Counter of the kernel instances' names)."""
    import collections

    import torch
    before = collections.Counter(mod.launches_by_tiling)
    out = fn()
    torch.cuda.synchronize()
    return out, sorted(mod.launches_by_tiling - before)


def expect_tiling(name, ran, want=None):
    """The one tiling ``ran`` holds: ``want``, where given, else a wgmma
    tiling (a path shape in bf16 must go through the tensor cores); fails
    on anything else."""
    ok = len(ran) == 1 and (ran[0] == want if want is not None
                            else ran[0].startswith("wgmma_"))
    print(f"  {name}: launched {ran}{'' if want is None else f' (want {want})'}"
          f" {'ok' if ok else 'WRONG TILING'}", flush=True)
    if not ok:
        fail(f"{name} launched {ran}, not {want or 'a wgmma tiling'}")
    return ran[0]


def record(name, path, shape, err, times, plain_ms, nbytes, ops, dtype,
           library_times, **extra):
    """A phase-2 record: ``times`` and ``library_times`` are (call ms,
    device ms) pairs (``timed``) of the kernel and of the one PyTorch call
    that computes the same function (None where there is none; a
    composite of several calls goes in ``extra`` as
    ``library_composite_ms`` / ``library_composite_device_ms``; a kernel's
    backward gives its own ``source`` and ``replaces`` there, with
    ``backward=True``)."""
    t_bound, by = bound(nbytes, ops, dtype)
    src, replaces, _ = KERNELS[name]
    ms, dev_ms = times
    library_ms, library_dev_ms = library_times or (None, None)
    rec = dict(dict(name=name, route="cuda", source=src, replaces=replaces,
                    max_abs_err=err, ms=ms, device_ms=dev_ms,
                    plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                    library_ms=library_ms, library_device_ms=library_dev_ms,
                    shape=shape, path=path), **extra)
    lib = ("" if library_ms is None else
           f"  library {library_ms:.4f} ms (device {library_dev_ms:.4f})")
    comp = ("" if "library_composite_ms" not in extra else
            f"  cuBLAS composite {extra['library_composite_ms']:.4f} ms "
            f"(device {extra['library_composite_device_ms']:.4f})")
    if extra.get("backward"):
        name = f"{name} backward"
    print(f"  time {name} {shape} ({path}): kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  bound {t_bound:.4g} ms "
          f"({by}){lib}{comp}", flush=True)
    return rec


def alternatives(mod, cases, check, iters=30):
    """Other instances of a kernel at one shape, ``cases`` a list of
    (tiling, call, timed call): each call is checked by ``check(out,
    tiling)`` and asserted to launch its tiling, and its timed call (the
    same call, or one that rotates its inputs) is timed; {tiling: {"ms",
    "device_ms"}}."""
    out = {}
    for tiling, call, timed_call in cases:
        got, ran = launched(mod, call)
        expect_tiling(f"{mod.__name__.rsplit('.', 1)[1]} {tiling}", ran,
                      tiling)
        check(got, tiling)
        del got
        ms, dev = timed(timed_call, iters)
        print(f"    {tiling}: {ms:.4f} ms (device {dev:.4f})", flush=True)
        out[tiling] = {"ms": ms, "device_ms": dev}
    return out


# K1's bf16 outputs may differ by one bf16 rounding (2^-7 relative) where
# f32 sums in another order land on either side of a rounding boundary;
# f32 by rsqrtf's 2 ulp
RMS_TOL = {"bfloat16": (1e-5, 2 ** -7), "float32": (1e-5, 1e-5)}


def rmsnorm_checks(gen, records):
    """K1 at the serving paths' 8 x 2560 (qwen1.5-4b; zamba2-2.7b's ln1),
    8 x 2048 and 8 x 4096 (mamba2-1.3b's ln1 and gated norm; also the moe
    models' ln1 and ln2), 8 x 5120 (zamba2-2.7b's gated norm), 128 x 128
    (olmoe-1b-7b's q/k norms: 8 lanes x 16 heads) and 8 x 512
    (deepseek-v2-lite-16b's MLA latent norm), the training paths' 8192 x
    2560, 8192 x 4096, 8192 x 5120, 8192 x 2048 (the moe models' ln1 and
    ln2), 131072 x 128 (olmoe's q/k norms) and 8192 x 512 (the latent
    norm) and a ragged 13 x 1001, in bf16 and f32, each
    launching the instance ``select_tiling`` names; in bf16 at the path
    shapes, timed beside ``F.rms_norm``, with the instance of every br of
    ``CONFIGS`` that divides the rows (through ``br=``, as a deployed
    config calls) timed beside the default (the model's: a narrow
    instance for rows of at most ``NARROW_ROW_BYTES``, then also
    ``block_row`` by the C entry point, else ``block_row``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms_mod

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for rows, cols, path in ((LANES, D_MODEL, "serve"), (13, 1001, None),
                                 (LANES, SSM_D_MODEL, "serve_ssm"),
                                 (LANES, D_INNER, "serve_ssm"),
                                 (LANES, HYBRID_D_INNER, "serve_hybrid"),
                                 (LANES * MOE_HEADS, MOE_HEAD_DIM,
                                  "serve_moe"),
                                 (LANES, MLA_LATENT, "serve_mla"),
                                 (ROWS, D_MODEL, "train"),
                                 (ROWS, D_INNER, "train_ssm"),
                                 (ROWS, HYBRID_D_INNER, "train_hybrid"),
                                 (ROWS, MOE_D_MODEL, "train_moe"),
                                 (ROWS * MOE_HEADS, MOE_HEAD_DIM,
                                  "train_moe"),
                                 (ROWS, MLA_LATENT, "train_mla"),
                                 # the GSPMD step's batch block on (data
                                 # 2, model 2); olmoe's q/k norms at 4 of
                                 # its 16 heads on (model 4)
                                 (ROWS // 2, D_MODEL, "train_gspmd"),
                                 (ROWS * MOE_HEADS // 4, MOE_HEAD_DIM,
                                  "train_gspmd")):
            x = (torch.randn(rows, cols, device="cuda", generator=gen)
                 * 0.5).to(dt)
            g = (torch.randn(cols, device="cuda", generator=gen) * 0.5
                 + 1.0).to(dt)
            shape = f"{rows}x{cols} {dname}"
            plain = ops.rmsnorm(x, g, impl="ref")
            got, ran = launched(rms_mod, lambda: rms_mod.rmsnorm(x, g))
            tiling = expect_tiling(f"rmsnorm {shape}", ran,
                                   rms_mod.select_tiling(dt, x.shape))
            err = check_close(f"rmsnorm {shape} {ran}", got, plain,
                              *RMS_TOL[dname])
            del got
            if path is None or dname != "bfloat16":
                continue
            # each br's instance, through br= as a deployed config calls
            cases = []
            for br in rms_mod.BLOCK_BR:
                if rows % br == 0:
                    call = lambda br=br: rms_mod.rmsnorm(x, g, br=br)
                    cases.append((rms_mod.select_tiling(dt, x.shape, br=br),
                                  call, call))
            alts = alternatives(rms_mod, cases, lambda out, t: check_close(
                f"rmsnorm {shape} {t}", out, plain, *RMS_TOL[dname]))
            if tiling != rms_mod.BLOCK_ROW:
                # the wide rows' instance, which these rows took before
                # the narrow ones, by the library's C entry point
                alts[rms_mod.BLOCK_ROW] = rmsnorm_at_timed(
                    rms_mod.BLOCK_ROW, x, g, plain, RMS_TOL[dname], shape)
            el = x.element_size()
            records.append(record(
                "rmsnorm", path, shape, err,
                timed(lambda: rms_mod.rmsnorm(x, g)),
                event_ms(lambda: ops.rmsnorm(x, g, impl="ref")),
                (2 * rows * cols + cols) * el, 4 * rows * cols, dname,
                timed(lambda: F.rms_norm(x, (cols,), g, eps=1e-6)),
                tiling=tiling, alternatives=alts))
            del x, g, plain


def rmsnorm_at(tiling, x, g):
    """K1's ``tiling`` on ``x`` (rows, cols) and ``g`` by the library's C
    entry point, whatever instance ``select_tiling`` would name: so the
    narrow instances and ``block_row`` are timed at the same rows.  It
    bypasses the wrapper and its launch counts."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rms_mod

    y = torch.empty_like(x)
    err = _build.library().repro_rmsnorm(
        x.data_ptr(), g.data_ptr(), y.data_ptr(), *x.shape, 1e-6,
        _build.tiling_ids("repro_rmsnorm_tilings", rms_mod.TILINGS)[tiling],
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    _build.check(err, f"rmsnorm ({tiling})")
    return y


def rmsnorm_at_timed(tiling, x, g, plain, tol, shape):
    """``rmsnorm_at`` checked against ``plain`` and timed: {"ms",
    "device_ms", "max_abs_err"}."""
    import torch
    got = rmsnorm_at(tiling, x, g)
    torch.cuda.synchronize()
    err = check_close(f"rmsnorm {shape} {tiling} (C entry)", got, plain,
                      *tol)
    del got
    ms, dev = timed(lambda: rmsnorm_at(tiling, x, g))
    print(f"    {tiling}: {ms:.4f} ms (device {dev:.4f})", flush=True)
    return {"ms": ms, "device_ms": dev, "max_abs_err": err}


SWEEP_ROWS = 8192
SWEEP_COLS = (128, 256, 512, 1024, 2048, 4096)


def rmsnorm_sweep(gen, records):
    """K1 in bf16 at 8192 rows of each width of ``SWEEP_COLS``: the
    smallest narrow instance that holds the row (``narrow_tiling``, none
    past the widest) against ``block_row``, both by the C entry point,
    and ``F.rms_norm``, one line each; the record's kernel time is the
    narrow instance's where there is one.  This sweep sets
    ``rmsnorm.NARROW_ROW_BYTES``: a width at or below it whose narrow
    instance is not the faster is reported as ABOVE THE CROSSING."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms_mod

    tol = RMS_TOL["bfloat16"]
    dt = torch.bfloat16
    for cols in SWEEP_COLS:
        x = (torch.randn(SWEEP_ROWS, cols, device="cuda", generator=gen)
             * 0.5).to(dt)
        g = (torch.randn(cols, device="cuda", generator=gen) * 0.5
             + 1.0).to(dt)
        shape = f"{SWEEP_ROWS}x{cols} bfloat16"
        plain = ops.rmsnorm(x, g, impl="ref")
        narrow = rms_mod.narrow_tiling(dt, cols)
        alts = {rms_mod.BLOCK_ROW: rmsnorm_at_timed(
            rms_mod.BLOCK_ROW, x, g, plain, tol, shape)}
        if narrow is not None:
            alts[narrow] = rmsnorm_at_timed(narrow, x, g, plain, tol, shape)
        kernel = narrow or rms_mod.BLOCK_ROW
        lib = timed(lambda: F.rms_norm(x, (cols,), g, eps=1e-6))
        selected = rms_mod.select_tiling(dt, x.shape)
        rec = record(
            "rmsnorm", "sweep", shape, alts[kernel]["max_abs_err"],
            (alts[kernel]["ms"], alts[kernel]["device_ms"]),
            event_ms(lambda: ops.rmsnorm(x, g, impl="ref")),
            (2 * SWEEP_ROWS * cols + cols) * x.element_size(),
            4 * SWEEP_ROWS * cols, "bfloat16", lib, tiling=kernel,
            selected=selected, alternatives=alts)
        records.append(rec)
        faster = (narrow is not None and alts[narrow]["device_ms"]
                  < alts[rms_mod.BLOCK_ROW]["device_ms"])
        within = cols * x.element_size() <= rms_mod.NARROW_ROW_BYTES
        print(f"  sweep rmsnorm {shape}: {narrow or 'no narrow instance'}"
              + (f" device {alts[narrow]['device_ms']:.4f} ms" if narrow
                 else "")
              + f", block_row {alts[rms_mod.BLOCK_ROW]['device_ms']:.4f} ms, "
              f"F.rms_norm {lib[1]:.4f} ms, bound {rec['bound_ms']:.4f} ms; "
              f"selected {selected}"
              + ("; ABOVE THE CROSSING" if within and not faster else ""),
              flush=True)
        del x, g, plain


def wgmma_at(tiling, x, w_gate, w_up):
    """K2's ``tiling`` (a wgmma instance) on bf16 ``x`` of any rows, by the
    library's C entry point: the wrapper sends M <= 8 to the gemv route,
    so this is how the decode threshold's other side is measured.  It
    bypasses the wrapper and its launch counts."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ff as ff_mod

    (m, k), n = x.shape, w_gate.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _build.library().repro_fused_ff(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), out.data_ptr(),
        None, m, k, n, 1,
        _build.tiling_ids("repro_fused_ff_tilings", ff_mod.TILINGS)[tiling],
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    _build.check(err, f"fused_ff ({tiling})")
    return out


def fused_ff_checks(gen, records):
    """K2 at the serving path's 8 x 2560 . 2560 x 6912, the decode
    threshold's neighbours (M 1, 3, 9, 16, 32), ragged shapes (M not a
    multiple of 128, N not a multiple of 8; K and N ragged at decode),
    the training path's 8192 rows, serving with a mesh's column shards
    (8 x 2560 . 2560 x 1728 and x 3456), zamba2-2.7b's shared MLP (8 and
    8192 rows . 2560 x 10240), and deepseek-v2-lite-16b's dense layer (8 and
    8192 rows . 2048 x 10944, N not a multiple of 128) and shared experts
    (. 2048 x 2816), in bf16 and f32, each launching the
    instance ``select_tiling`` names; in bf16 at the path shapes timed
    beside the cuBLAS composite, the serving shape also on the default
    wgmma instance (``wgmma_at``), the training shape at every ``CONFIGS``
    entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_ff as ff_mod
    from repro_torch.kernels import ops

    # bf16: one bf16 rounding of the output (2^-7 relative); f32: dot
    # products of up to 2560 terms summed in another order.
    tol = {"bfloat16": (1e-4, 2 ** -7), "float32": (1e-5, 1e-4)}
    default = "wgmma_bm{}_bn{}_bk{}".format(*ff_mod.DEFAULT_BLOCK)
    cases = [  # M, K, N, path (None: checked, not timed)
        (LANES, D_MODEL, D_FF, "serve"), (1, D_MODEL, D_FF, None),
        (3, D_MODEL, D_FF, None), (LANES + 1, D_MODEL, D_FF, "threshold"),
        (16, D_MODEL, D_FF, "threshold"), (32, D_MODEL, D_FF, "threshold"),
        (3, 1001, 777, None), (300, D_MODEL, 777, None),
        (300, D_MODEL, 776, None), (ROWS, D_MODEL, D_FF, "train"),
        (LANES, D_MODEL, HYBRID_D_FF, "serve_hybrid"),
        (ROWS, D_MODEL, HYBRID_D_FF, "train_hybrid"),
        (LANES, MOE_D_MODEL, MLA_D_FF, "serve_mla"),
        (LANES, MOE_D_MODEL, MLA_SHARED_D_FF, "serve_mla"),
        (ROWS, MOE_D_MODEL, MLA_D_FF, "train_mla"),
        (ROWS, MOE_D_MODEL, MLA_SHARED_D_FF, "train_mla"),
        # the pipeline step's tensor-parallel column shard (d_ff / 2) at a
        # microbatch of one sequence, and at the global batch's rows
        (SEQ, D_MODEL, D_FF // 2, "train_pipe"),
        (ROWS, D_MODEL, D_FF // 2, "train_pipe"),
        # the GSPMD step's column shard on (data 2, model 2): the batch
        # block of 2 sequences
        (ROWS // 2, D_MODEL, D_FF // 2, "train_gspmd"),
        # serving with a mesh: the decode pass's column shard on (model 4)
        # (phase 5d's timed run) and on (data 2, model 2)
        (LANES, D_MODEL, D_FF // 4, "serve_mesh"),
        (LANES, D_MODEL, D_FF // 2, "serve_mesh")]
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        for m, k, n, path in cases:
            x = (torch.randn(m, k, device="cuda", generator=gen)
                 * 0.5).to(dt)
            # Below the training shape, four weight pairs in rotation (283
            # MB in bf16): each call finds its weights out of the 50 MB
            # L2, as a decode pass does.
            ws = [tuple((torch.randn(k, n, device="cuda", generator=gen)
                         * k ** -0.5).to(dt) for _ in range(2))
                  for _ in range(4 if path in ("serve", "serve_hybrid",
                                               "serve_mla", "threshold",
                                               "serve_mesh")
                                 else 1)]
            shape = f"{m}x{k}x{n} {dname}"
            plain = ops.fused_ff(x, *ws[0], impl="ref")
            got, ran = launched(ff_mod, lambda: ff_mod.fused_ff(x, *ws[0]))
            tiling = expect_tiling(f"fused_ff {shape}", ran,
                                   ff_mod.select_tiling(dt, (m, k, n)))
            err = check_close(f"fused_ff {shape} {ran}", got, plain,
                              *tol[dname])
            del got
            if path is None or dname != "bfloat16":
                del x, ws, plain
                continue
            turn = [0]

            def rotate(fn):
                def call():
                    turn[0] = (turn[0] + 1) % len(ws)
                    return fn(*ws[turn[0]])
                return call

            def check(out, t):
                check_close(f"fused_ff {shape} {t}", out, plain,
                            *tol[dname])

            iters = 10 if path.startswith("train") else 30
            if path == "serve":
                # the wgmma route below its threshold: what the threshold
                # weighs the gemv route against
                check(wgmma_at(default, x, *ws[0]), default)
                ms, dev = timed(rotate(
                    lambda a, b: wgmma_at(default, x, a, b)))
                print(f"    {default}: {ms:.4f} ms (device {dev:.4f})",
                      flush=True)
                alts = {default: {"ms": ms, "device_ms": dev}}
            elif path == "train":
                seen, cases_cfg = {tiling}, []
                for cfg in ff_mod.CONFIGS:
                    t = ff_mod.select_tiling(dt, (m, k, n), **cfg)
                    if t not in seen:
                        seen.add(t)
                        call = (lambda cfg=cfg: ff_mod.fused_ff(x, *ws[0],
                                                                **cfg))
                        cases_cfg.append((t, call, call))
                alts = alternatives(ff_mod, cases_cfg, check, iters)
            else:
                alts = {}
            # phase 5d's timed shard: one launch a layer, a pass and a rank
            per_pass = ({"launches_per_pass": SERVE_MESH_TIMING_LAYERS}
                        if path == "serve_mesh"
                        and n == D_FF // SERVE_MESH_TIMING["model"] else {})
            el = x.element_size()
            comp = timed(rotate(lambda a, b: F.silu(x @ a) * (x @ b)), iters)
            records.append(record(
                "fused_ff", path, shape, err,
                timed(rotate(lambda a, b: ff_mod.fused_ff(x, a, b)), iters),
                event_ms(rotate(lambda a, b: ops.fused_ff(x, a, b,
                                                          impl="ref")),
                         iters),
                (m * k + 2 * k * n + m * n) * el, 4 * m * k * n + 4 * m * n,
                dname,
                # no single PyTorch call computes silu(x@Wg)*(x@Wu)
                None, library_composite_ms=comp[0],
                library_composite_device_ms=comp[1], tiling=tiling,
                alternatives=alts, **per_pass))
            del x, ws, plain
    torch.cuda.empty_cache()


def sdpa_backends(q, k, v, causal=True):
    """The SDPA backends that take (q, k, v) with ``causal``, in
    PyTorch's own order of preference (the one a plain call runs is the
    first)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok = []
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH"):
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            ok.append(name)
        except RuntimeError:
            pass
    return ok


def _k_tile_dropped(q, k, v, causal, lo, hi):
    """Plain attention of (q, k, v) (as many KV heads as query heads, no
    window or offset) in f32 with keys ``lo:hi`` left out, cast to q's
    type: a planted fault, one K tile skipped, that a case's bound must
    fail.  ``lo`` > 0, so that every row keeps a key."""
    import torch
    Sq, Sk = q.shape[2], k.shape[2]
    s = (q.float() * q.shape[-1] ** -0.5) @ k.float().transpose(-1, -2)
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    keep[:, lo:hi] = False
    if causal:
        keep &= torch.ones_like(keep).tril()
    s = s.masked_fill(~keep, float("-inf"))
    return (torch.softmax(s, -1) @ v.float()).to(q.dtype)


def flash_attention_checks(gen, records):
    """K6 at the training paths' shapes, stablelm-3b's (4, 32, 2048, 80),
    olmoe-1b-7b's (4, 16, 2048, 128) and deepseek-v2-lite-16b's MLA heads
    (4, 16, 2048, q and k 192, v 128), causal, a ragged GQA shape with a
    window, a non-causal shape and a query offset, in f32 and bf16, each
    launching the instance ``select_tiling`` names (bf16 path shapes on
    wgmma); whisper-large-v3's, in bf16 on ``ENCDEC_TILINGS``: training's
    (4, 20, 2048, 64) non-causal (the encoder; cross-attention at frames
    = tokens) and causal (the decoder), serving's encoder over
    ``ENC_LEN_DECODE`` frames (8, 20, 1536, 64) non-causal, and the
    published 448-token context against 1500 frames, also in f32; the
    path shapes timed beside SDPA with the same causal flag (the backend
    PyTorch picks; those that take MLA's Dv != D printed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.whisper_large_v3 import ENC_LEN_DECODE
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.nn.attention import NO_WINDOW

    # tests/test_kernels.py's tolerances for this kernel: atol 2e-4 in f32
    # (:91), 3e-2 in bf16 (:104, one bf16 rounding of outputs near 1).  In
    # bf16 a case is held to 2^-6 of its largest plain output where that
    # is less (2 to 4 roundings of it): a non-causal output over Sk keys
    # is of size sqrt(e / Sk), under 3e-2 at whisper's Sk, so 3e-2 would
    # pass a skipped K tile there.  Whisper's cases also show that their
    # bound fails such a fault (``_k_tile_dropped``).
    def atol_for(dname, want):
        if dname == "float32":
            return 2e-4
        return min(3e-2, 2 ** -6 * want.abs().max().item())
    both, bf16 = ("float32", "bfloat16"), ("bfloat16",)
    wh, wd = ENCDEC_HEADS, ENCDEC_HEAD_DIM
    cases = [  # B, H, KH, Sq, Sk, D, Dv, causal, window, q_offset, path,
        #        the types checked in, the types timed in
        (BATCH, HEADS, HEADS, SEQ, SEQ, HEAD_DIM, HEAD_DIM, True, NO_WINDOW,
         0, "train", both, bf16),
        (BATCH, MOE_HEADS, MOE_HEADS, SEQ, SEQ, MOE_HEAD_DIM, MOE_HEAD_DIM,
         True, NO_WINDOW, 0, "train_moe", both, bf16),
        # the pipeline step's tensor-parallel heads: n_heads / 2 of a
        # microbatch of one sequence
        (1, HEADS // 2, HEADS // 2, SEQ, SEQ, HEAD_DIM, HEAD_DIM, True,
         NO_WINDOW, 0, "train_pipe", both, bf16),
        # the GSPMD step's heads: stablelm-3b's 16 of 32 for a batch block
        # of 2 on (data 2, model 2), olmoe-1b-7b's 4 of 16 on (model 4)
        (BATCH // 2, HEADS // 2, HEADS // 2, SEQ, SEQ, HEAD_DIM, HEAD_DIM,
         True, NO_WINDOW, 0, "train_gspmd", both, bf16),
        (BATCH, MOE_HEADS // 4, MOE_HEADS // 4, SEQ, SEQ, MOE_HEAD_DIM,
         MOE_HEAD_DIM, True, NO_WINDOW, 0, "train_gspmd", both, bf16),
        (BATCH, MOE_HEADS, MOE_HEADS, SEQ, SEQ, MLA_QK_DIM, MLA_V_DIM, True,
         NO_WINDOW, 0, "train_mla", both, bf16),
        (BATCH, wh, wh, SEQ, SEQ, wd, wd, False, NO_WINDOW, 0,
         "train_encdec", bf16, bf16),
        (BATCH, wh, wh, SEQ, SEQ, wd, wd, True, NO_WINDOW, 0,
         "train_encdec", bf16, bf16),
        (LANES, wh, wh, ENC_LEN_DECODE, ENC_LEN_DECODE, wd, wd, False,
         NO_WINDOW, 0, "serve_encdec", bf16, bf16),
        (BATCH, wh, wh, ENCDEC_CONTEXT, ENCDEC_AUDIO_FRAMES, wd, wd, False,
         NO_WINDOW, 0, "encdec_cross", both, both),
        (2, 8, 2, 1000, 1000, HEAD_DIM, HEAD_DIM, True, 256, 0, None, both,
         ()),
        (2, 8, 8, 1000, 1000, HEAD_DIM, HEAD_DIM, False, NO_WINDOW, 0, None,
         both, ()),
        (1, 4, 2, 100, 300, 64, 64, True, NO_WINDOW, 200, None, both, ()),
        (2, 4, 4, 300, 300, MLA_QK_DIM, MLA_V_DIM, False, NO_WINDOW, 0,
         None, both, ()),
        (1, 4, 2, 100, 300, MLA_QK_DIM, MLA_V_DIM, True, NO_WINDOW, 200,
         None, both, ()),
    ]
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        for (B, H, KH, Sq, Sk, D, Dv, causal, window, q_offset, path,
             checked, timed_in) in cases:
            if dname not in checked:
                continue
            q = torch.randn(B, H, Sq, D, device="cuda", generator=gen).to(dt)
            k = torch.randn(B, KH, Sk, D, device="cuda", generator=gen).to(dt)
            v = torch.randn(B, KH, Sk, Dv, device="cuda",
                            generator=gen).to(dt)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            win = "" if window == NO_WINDOW else f" window {window}"
            dims = f"{D}" if Dv == D else f"{D}/{Dv}"
            shape = (f"({B},{H},{Sq},{dims}) kv ({KH},{Sk}) "
                     f"{'causal' if causal else 'full'}{win}"
                     f"{f' q_offset {q_offset}' if q_offset else ''} "
                     f"{dname}")
            got, ran = launched(
                fa_mod, lambda: fa_mod.flash_attention(q, k, v, **kw))
            want = fa_mod.select_tiling(dt, q.shape, dv=Dv)
            if path is not None and "encdec" in path \
                    and want != ENCDEC_TILINGS[dname]:
                fail(f"flash_attention {shape} would run {want}, not "
                     f"{ENCDEC_TILINGS[dname]}")
            tiling = expect_tiling(f"flash_attention {shape}", ran, want)
            if path is not None and dname == "bfloat16" \
                    and not tiling.startswith("wgmma_"):
                fail(f"flash_attention {shape} ran {tiling}, not wgmma")
            plain = ops.flash_attention(q, k, v, impl="ref", **kw)
            atol = atol_for(dname, plain)
            err = check_close(f"flash_attention {shape} {ran}", got, plain,
                              atol, 0.0)
            del got
            planted = {}
            if path is not None and "encdec" in path:
                # the instance's K tile: wgmma's bk 128, SIMT's 64
                bk = 128 if dname == "bfloat16" else 64
                last = (Sk - 1) // bk * bk
                for name, lo in (("middle", Sk // bk // 2 * bk),
                                 ("last", last)):
                    planted[name] = (_k_tile_dropped(
                        q, k, v, causal, lo, min(lo + bk, Sk)).float()
                        - plain.float()).abs().max().item()
                print(f"  a K tile of {bk} dropped moves {shape} by "
                      f"{planted} (bound {atol:.3e})", flush=True)
                if not min(planted.values()) > atol:
                    fail(f"flash_attention {shape}: its bound {atol:.3e} "
                         f"passes a dropped K tile")
            del plain
            if dname not in timed_in:
                continue
            el = q.element_size()
            # the (query, key) pairs this run's mask keeps: each a D-wide
            # and a Dv-wide product
            pairs = (sum(min(q_offset + i + 1, Sk) for i in range(Sq))
                     if causal else Sq * Sk)
            backends = sdpa_backends(q, k, v, causal)
            print(f"  SDPA backends that take {shape}: {backends}",
                  flush=True)
            extra = ({"note": "also zamba2-2.7b's training shape "
                              "(train_hybrid: its shared block's 32 heads "
                              "of 80)"} if path == "train" else {})
            records.append(record(
                "flash_attention", path, shape, err,
                timed(lambda: fa_mod.flash_attention(q, k, v, **kw), 20),
                event_ms(lambda: ops.flash_attention(q, k, v, impl="ref",
                                                     **kw), 10),
                (B * H * Sq * (D + Dv) + B * KH * Sk * (D + Dv)) * el,
                2 * B * H * (D + Dv) * pairs, dname,
                timed(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), 20), tiling=tiling,
                sdpa_backends=backends, atol=atol,
                **({"dropped_k_tile_err": planted} if planted else {}),
                **extra))
            del q, k, v
    torch.cuda.empty_cache()
    # bf16 at each CONFIGS entry (bq, bk, d): a causal shape, and grouped
    # KV heads with a window and a query offset; each must launch its own
    # wgmma instance
    for cfg in fa_mod.CONFIGS:
        for B, H, KH, Sq, Sk, causal, window, q_offset in (
                (2, 8, 8, 1024, 1024, True, NO_WINDOW, 0),
                (2, 8, 2, 512, 1024, True, 300, 512)):
            q = torch.randn(B, H, Sq, cfg["d"], device="cuda",
                            generator=gen).to(torch.bfloat16)
            k, v = (torch.randn(B, KH, Sk, cfg["d"], device="cuda",
                                generator=gen).to(torch.bfloat16)
                    for _ in range(2))
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            got, ran = launched(fa_mod, lambda: fa_mod.flash_attention(
                q, k, v, **kw, **cfg))
            shape = (f"({B},{H},{Sq},{cfg['d']}) kv ({KH},{Sk}) causal"
                     f"{'' if window == NO_WINDOW else f' window {window}'}"
                     f"{f' q_offset {q_offset}' if q_offset else ''} at {cfg}")
            expect_tiling(f"flash_attention {shape}", ran,
                          fa_mod.select_tiling(torch.bfloat16, q.shape,
                                               **cfg))
            plain = ops.flash_attention(q, k, v, impl="ref", **kw)
            check_close(f"flash_attention {shape} bfloat16", got, plain,
                        atol_for("bfloat16", plain), 0.0)


def flash_attention_backward_checks(gen, records):
    """K6's backward kernel (``flash_attention_grad``, through the
    Function's gradient) against autograd through the plain version, at
    ``gradient_checks``' tolerances (atol 2^-8 of the largest plain
    gradient, rtol 2^-7), at every shape this script's paths give it:
    stablelm-3b's (4, 32, 2048, 80) causal (``train``) and its shards
    (``train_pipe``, ``train_gspmd``), olmoe-1b-7b's (4, 16, 2048, 128)
    causal (``train_moe``) and its GSPMD shard, deepseek-v2-lite-16b's
    MLA heads (4, 16, 2048, q and k 192, v 128) causal (``train_mla``),
    whisper-large-v3's (4, 20, 2048, 64) non-causal and causal
    (``train_encdec``); at the benchmark's 4k cells' calls, stablelm-3b's
    (2, 32, 4096, 80) and MLA's (2, 16, 4096, 192 / 128); and as shape
    checks, on no path, grouped KV heads with a window and a query offset
    and whisper's 448 tokens over 1500 frames (non-causal, Sq != Sk).
    Each must launch the instance ``select_backward_tiling`` names.  The
    path shapes are timed beside their bound (the five products at the
    bf16 peak), the plain backward and SDPA's backward (the backend
    PyTorch picks)."""
    import collections

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.nn.attention import NO_WINDOW

    wh, wd = ENCDEC_HEADS, ENCDEC_HEAD_DIM
    cases = [  # B, H, KH, Sq, Sk, D, Dv, causal, window, q_offset, path
        (BATCH, HEADS, HEADS, SEQ, SEQ, HEAD_DIM, HEAD_DIM, True, NO_WINDOW,
         0, "train"),
        (1, HEADS // 2, HEADS // 2, SEQ, SEQ, HEAD_DIM, HEAD_DIM, True,
         NO_WINDOW, 0, "train_pipe"),
        (BATCH // 2, HEADS // 2, HEADS // 2, SEQ, SEQ, HEAD_DIM, HEAD_DIM,
         True, NO_WINDOW, 0, "train_gspmd"),
        (BATCH, MOE_HEADS, MOE_HEADS, SEQ, SEQ, MOE_HEAD_DIM, MOE_HEAD_DIM,
         True, NO_WINDOW, 0, "train_moe"),
        (BATCH, MOE_HEADS // 4, MOE_HEADS // 4, SEQ, SEQ, MOE_HEAD_DIM,
         MOE_HEAD_DIM, True, NO_WINDOW, 0, "train_gspmd"),
        (BATCH, MOE_HEADS, MOE_HEADS, SEQ, SEQ, MLA_QK_DIM, MLA_V_DIM, True,
         NO_WINDOW, 0, "train_mla"),
        (BATCH, wh, wh, SEQ, SEQ, wd, wd, False, NO_WINDOW, 0,
         "train_encdec"),
        (BATCH, wh, wh, SEQ, SEQ, wd, wd, True, NO_WINDOW, 0,
         "train_encdec"),
        (2, HEADS, HEADS, 4096, 4096, HEAD_DIM, HEAD_DIM, True, NO_WINDOW,
         0, "train_4k"),
        (2, MOE_HEADS, MOE_HEADS, 4096, 4096, MLA_QK_DIM, MLA_V_DIM, True,
         NO_WINDOW, 0, "train_mla_4k"),
        (2, 8, 2, 1000, 1000, HEAD_DIM, HEAD_DIM, True, 256, 24, None),
        (BATCH, wh, wh, ENCDEC_CONTEXT, ENCDEC_AUDIO_FRAMES, wd, wd, False,
         NO_WINDOW, 0, None),
    ]
    for (B, H, KH, Sq, Sk, D, Dv, causal, window, q_offset,
         path) in cases:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda",
                               generator=gen).to(torch.bfloat16)
        q, k, v = rnd(B, H, Sq, D), rnd(B, KH, Sk, D), rnd(B, KH, Sk, Dv)
        dy = rnd(B, H, Sq, Dv)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        win = "" if window == NO_WINDOW else f" window {window}"
        dims = f"{D}" if Dv == D else f"{D}/{Dv}"
        shape = (f"({B},{H},{Sq},{dims}) kv ({KH},{Sk}) "
                 f"{'causal' if causal else 'full'}{win}"
                 f"{f' q_offset {q_offset}' if q_offset else ''} bfloat16")
        mine = [t.clone().requires_grad_() for t in (q, k, v)]
        before = collections.Counter(fa_mod.backward_launches_by_tiling)
        got = torch.autograd.grad(ops.flash_attention(*mine, **kw), mine, dy)
        torch.cuda.synchronize()
        tiling = expect_tiling(
            f"flash_attention backward {shape}",
            sorted(fa_mod.backward_launches_by_tiling - before),
            fa_mod.select_backward_tiling(torch.bfloat16, q.shape, dv=Dv))
        plain = [t.clone().requires_grad_() for t in (q, k, v)]

        def plain_grad():
            return torch.autograd.grad(
                ops.flash_attention(*plain, impl="ref", **kw), plain, dy)
        want = plain_grad()
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                fail(f"flash_attention backward {shape}: {name} is not "
                     f"finite")
            errs.append(check_close(
                f"grad flash_attention {name} {shape}", a, b,
                2 ** -8 * b.float().abs().max().item(), 2 ** -7))
        del mine, got, want
        if path is None:
            continue
        lse = torch.empty((B, H, -(-Sq // fa_mod.ROW_PAD) * fa_mod.ROW_PAD),
                          device="cuda", dtype=torch.float32)
        out = fa_mod.flash_attention(q, k, v, **kw, lse=lse)
        pairs = (sum(min(q_offset + i + 1, Sk) for i in range(Sq))
                 if causal else Sq * Sk)
        el = q.element_size()
        sdpa = [t.clone().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*sdpa, is_causal=causal)
        records.append(record(
            "flash_attention", path, shape, max(errs),
            timed(lambda: fa_mod.flash_attention_grad(
                q, k, v, out, lse, dy, scale=None, **kw), 10),
            event_ms(plain_grad, iters=1, warmup=0),
            (B * H * Sq * 2 * (D + Dv) + 2 * B * KH * Sk * (D + Dv)) * el
            + 4 * lse.numel(),
            2 * B * H * (3 * D + 2 * Dv) * pairs, "bfloat16",
            timed(lambda: torch.autograd.grad(sdpa_out, sdpa, dy,
                                              retain_graph=True), 10),
            tiling=tiling, backward=True,
            source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            replaces="no TPU kernel (the JAX package differentiates "
                     "attention with XLA): the plain f32 backward"))
        del q, k, v, dy, plain, out, lse, sdpa, sdpa_out
        torch.cuda.empty_cache()


def _f64_tolerance(plain, exact, floor):
    """atol at a path's shape: twice the plain version's own error against
    an f64 evaluation of the same function (kernel and plain version round
    the same f32 sums, added in other orders), and at least the test's."""
    return max(floor, 2 * (plain.double() - exact).abs().max().item())


# tests/test_kernels.py's tolerances for K3 and K4: atol (_ATOL :18), rtol
GEMM_TOL = {"float32": (2e-5, 2e-2), "bfloat16": (2e-2, 2e-2)}


def _gemm_inputs(gen, dt, a_shape, b_shape, b_scale=None):
    """a ~ N(0, 0.5^2); b ~ N(0, b_scale^2), by default K^-1/2 (a
    projection's weights: a @ b is O(1))."""
    import torch
    if b_scale is None:
        b_scale = a_shape[-1] ** -0.5
    a = (torch.randn(*a_shape, device="cuda", generator=gen) * 0.5).to(dt)
    b = (torch.randn(*b_shape, device="cuda", generator=gen)
         * b_scale).to(dt)
    return a, b


def _f32_gemm_alternatives(mod, shape, default, call):
    """(tiling, call, timed call) of each f32 SIMT instance that another
    ``CONFIGS`` entry of ``mod`` names at ``shape``, once each."""
    import torch
    cases = {}
    for cfg in mod.CONFIGS:
        tiling = mod.select_tiling(torch.float32, shape, **cfg)
        if tiling != default and tiling not in cases:
            cases[tiling] = (tiling, lambda cfg=cfg: call(cfg),
                             lambda cfg=cfg: call(cfg))
    return list(cases.values())


def gemm_checks(gen, records):
    """K3 and K4, called as the registry calls them (the wrappers, with the
    reference's block-size keywords): ``tests/test_kernels.py``'s cases, a
    ragged shape, and the optimizer path's shapes with times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bmm as bmm_mod
    from repro_torch.kernels import matmul_leakyrelu as mlr_mod
    from repro_torch.kernels import ops

    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        atol, rtol = GEMM_TOL[dname]
        for m, k, n, bm, bn, bk in ((128, 128, 128, 128, 128, 128),
                                    (256, 256, 128, 128, 128, 128),
                                    (128, 128, 256, 64, 128, 64),
                                    (131, 77, 45, 1, 1, 1)):
            # the test's inputs: both operands N(0, 0.5^2)
            a, b = _gemm_inputs(gen, dt, (m, k), (k, n), 0.5)
            got, ran = launched(mlr_mod, lambda: mlr_mod.matmul_leakyrelu(
                a, b, bm=bm, bn=bn, bk=bk))
            check_close(f"matmul_leakyrelu {m}x{k}x{n} {dname} {ran}", got,
                        ops.matmul_leakyrelu(a, b, impl="ref"), atol, rtol)
        for B, m, k, n, blk in ((3, 128, 128, 128, 64), (2, 33, 17, 65, 1)):
            a, b = _gemm_inputs(gen, dt, (B, m, k), (B, k, n), 0.5)
            got, ran = launched(bmm_mod, lambda: bmm_mod.bmm(
                a, b, bm=blk, bn=blk, bk=blk))
            check_close(f"bmm ({B},{m},{k})x({B},{k},{n}) {dname} {ran}", got,
                        ops.bmm(a, b, impl="ref"), atol, rtol)
        # each CONFIGS entry (bm, bn, bk), at the test's inputs, launching
        # the instance its config names: in bf16 its own wgmma instance,
        # in f32 the SIMT instance of its (bm, bn)
        for mod, fn, plain, dims in (
                (mlr_mod, mlr_mod.matmul_leakyrelu, ops.matmul_leakyrelu,
                 ((512, 512), (512, 512))),
                (bmm_mod, bmm_mod.bmm, ops.bmm,
                 ((3, 512, 512), (3, 512, 512)))):
            name = fn.__name__
            for cfg in mod.CONFIGS:
                a, b = _gemm_inputs(gen, dt, *dims, 0.5)
                got, ran = launched(mod, lambda: fn(a, b, **cfg))
                expect_tiling(f"{name} {dims} {cfg} {dname}", ran,
                              mod.select_tiling(
                                  dt, (*dims[0], dims[1][-1]), **cfg))
                check_close(f"{name} {dims} {cfg} {dname} {ran}", got,
                            plain(a, b, impl="ref"), atol, rtol)

        m, k, n = MLR_SHAPE
        a, b = _gemm_inputs(gen, dt, (m, k), (k, n))
        plain = ops.matmul_leakyrelu(a, b, impl="ref")
        tol = _f64_tolerance(plain, ops.matmul_leakyrelu(
            a.double(), b.double(), impl="ref"), atol)
        shape = f"{m}x{k}x{n} {dname}"
        got, ran = launched(mlr_mod, lambda: mlr_mod.matmul_leakyrelu(a, b))
        err = check_close(f"matmul_leakyrelu {shape} {ran}", got, plain, tol,
                          0.0)
        tiling = expect_tiling(
            f"matmul_leakyrelu {shape}", ran,
            None if dname == "bfloat16"
            else mlr_mod.select_tiling(dt, MLR_SHAPE))
        del got
        # f32: the SIMT instance of each other (bm, bn) of CONFIGS (C1)
        alts = {} if dname == "bfloat16" else alternatives(
            mlr_mod, _f32_gemm_alternatives(
                mlr_mod, MLR_SHAPE, tiling,
                lambda cfg: mlr_mod.matmul_leakyrelu(a, b, **cfg)),
            lambda out, t: check_close(f"matmul_leakyrelu {shape} {t}", out,
                                       plain, tol, 0.0), 5)
        el = a.element_size()
        comp = timed(lambda: F.leaky_relu(torch.matmul(a, b), 0.01), 10)
        records.append(record(
            "matmul_leakyrelu", "optimize", shape, err,
            timed(lambda: mlr_mod.matmul_leakyrelu(a, b), 10),
            event_ms(lambda: ops.matmul_leakyrelu(a, b, impl="ref"), 10),
            (m * k + k * n + m * n) * el, 2 * m * k * n, dname,
            # no single PyTorch call computes LeakyReLU(a @ b)
            None, library_composite_ms=comp[0],
            library_composite_device_ms=comp[1], tiling=tiling,
            alternatives=alts))
        del a, b, plain

        B, m, k, n = BMM_SHAPE
        a, b = _gemm_inputs(gen, dt, (B, m, k), (B, k, n))
        plain = ops.bmm(a, b, impl="ref")
        tol = _f64_tolerance(plain, ops.bmm(a.double(), b.double(),
                                            impl="ref"), atol)
        shape = f"({B},{m},{k})x({B},{k},{n}) {dname}"
        got, ran = launched(bmm_mod, lambda: bmm_mod.bmm(a, b))
        err = check_close(f"bmm {shape} {ran}", got, plain, tol, 0.0)
        tiling = expect_tiling(
            f"bmm {shape}", ran,
            None if dname == "bfloat16"
            else bmm_mod.select_tiling(dt, BMM_SHAPE))
        del got
        alts = {} if dname == "bfloat16" else alternatives(
            bmm_mod, _f32_gemm_alternatives(
                bmm_mod, BMM_SHAPE, tiling,
                lambda cfg: bmm_mod.bmm(a, b, **cfg)),
            lambda out, t: check_close(f"bmm {shape} {t}", out, plain, tol,
                                       0.0), 10)
        el = a.element_size()
        records.append(record(
            "bmm", "optimize", shape, err,
            timed(lambda: bmm_mod.bmm(a, b), 20),
            event_ms(lambda: ops.bmm(a, b, impl="ref"), 20),
            B * (m * k + k * n + m * n) * el, 2 * B * m * k * n, dname,
            timed(lambda: torch.bmm(a, b), 20), tiling=tiling,
            alternatives=alts))
        del a, b, plain


# K5: tests/test_kernels.py's atol 2e-6 in f32; in bf16 one bf16 rounding
# of the output (2^-7 relative: f32 results on either side of a rounding
# boundary)
SOFTMAX_TOL = {"float32": (2e-6, 0.0), "bfloat16": (0.0, 2 ** -7)}


def softmax_checks(gen, records):
    """K5 at ``tests/test_kernels.py``'s 512 x 4096 (br 8), 8192 columns
    (br 4), a ragged shape and the fleet path's 40960 x 4096 (br 8), in f32
    and bf16, each launching the instance ``select_tiling`` names for its
    br; at the fleet shape timed beside ``torch.softmax``, with every
    other br instance (1, the calls that name none, and the other
    ``CONFIGS`` values) timed beside it."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import softmax as sm_mod

    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        for rows, cols, br, path in ((512, 4096, 8, None),
                                     (64, 8192, 4, None),
                                     (1000, 1001, None, None),
                                     (SOFTMAX_ROWS, 4096, 8, "fleet")):
            # the test's inputs: N(0, 4)
            x = (torch.randn(rows, cols, device="cuda", generator=gen)
                 * 2.0).to(dt)
            shape = f"{rows}x{cols} {dname}"
            plain = ops.softmax(x, impl="ref")
            got, ran = launched(sm_mod, lambda: sm_mod.softmax(x, br=br))
            tiling = expect_tiling(f"softmax {shape} br {br}", ran,
                                   sm_mod.select_tiling(dt, x.shape, br=br))
            err = check_close(f"softmax {shape} br {br} {ran}", got, plain,
                              *SOFTMAX_TOL[dname])
            del got
            if path is None:
                del x, plain
                continue
            calls = {f"block_br{b}": (lambda b=b: sm_mod.softmax(
                x, br=None if b == 1 else b)) for b in sm_mod.BLOCK_BR}
            alts = alternatives(
                sm_mod, [(t, call, call) for t, call in calls.items()
                         if t != tiling],
                lambda out, t: check_close(f"softmax {shape} {t}", out,
                                           plain, *SOFTMAX_TOL[dname]))
            # bytes: x read once, y written once; operations: max,
            # subtract, exp, add and divide per element, in f32
            records.append(record(
                "softmax", path, shape, err,
                timed(lambda: sm_mod.softmax(x, br=br)),
                event_ms(lambda: ops.softmax(x, impl="ref"), 10),
                2 * rows * cols * x.element_size(), 5 * rows * cols,
                "float32", timed(lambda: torch.softmax(x, -1)),
                tiling=tiling, alternatives=alts))
            del x, plain


def ssd_tol(dname, scale):
    """K7 against its plain version: f32 sums in another order (the
    chunk-parallel scan carries the state across segments, and the SIMT
    kernel runs chunks of 64), 1e-5 of the largest output; bf16 one bf16
    rounding of the output (2^-7 relative), plus 2^-12 of the largest
    output where f32 sums of opposite signs cancel."""
    return ((1e-5 * scale, 0.0) if dname == "float32"
            else (2 ** -12 * scale, 2 ** -7))


def ssd_inputs(gen, shape, dt, strong=False):
    """x, b, c ~ N(0, 1) in ``dt``; a in f32, -U(0, 0.5) a step (about
    mamba2's -softplus(dt) at initialisation), or -3 - U(0, 1) for a
    strong decay (a chunk's decay passes 88: an unmasked
    e^{seg_t - seg_s} would overflow)."""
    import torch
    B, S, H, G, P, N = shape
    x = torch.randn(B, S, H, P, device="cuda", generator=gen).to(dt)
    u = torch.rand(B, S, H, device="cuda", generator=gen)
    a = -3.0 - u if strong else -0.5 * u
    b, c = (torch.randn(B, S, G, N, device="cuda", generator=gen).to(dt)
            for _ in range(2))
    return x, a, b, c


def ssd_checks(gen, records):
    """K7 in the model layout, and in the registry's flat layout at
    ``tests/test_kernels.py``'s shape, against its plain version, each
    case launching the instance ``select_tiling`` names for its chunk; at
    the training shapes (mamba2-1.3b's, and zamba2-2.7b's N 64 through
    the N 128 instance, zero-padded) timed in f32 and bf16, with bf16's
    other chunk (128 beside the model's 64) checked, asserted and timed
    beside it."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as ssd_mod

    cases = [  # (B, S, H, G, P, N), chunk, strong decay, flat, path
        ((2, 128, 1, 1, 32, 16), 32, False, True, None),
        ((2, 128, 1, 1, 32, 16), 64, False, True, None),
        (SSM_SHAPE, 64, False, False, "train_ssm"),
        (HYBRID_SSM_SHAPE, 64, False, False, "train_hybrid"),
        ((2, 1000, 8, 2, 64, 64), 64, False, False, None),
        (SSM_SHAPE, 128, False, False, None),
        ((2, 1024, 16, 1, 128, 64), 64, False, False, None),
        (SSM_SHAPE, 64, True, False, None),
        ((2, 1000, 8, 2, 60, 48), 64, False, False, None),
        ((1, SEQ, 64, 1, 64, 128), 64, False, False, None),
        # chunk counts that the wave's segments do not divide (6 chunks
        # asked for 4 segments run 3 of 2)
        ((1, 384, 64, 1, 64, 128), 64, False, False, None),
        ((4, 384, 8, 1, 64, 128), 64, False, False, None),
        ((1, 6 * 128 + 5, 64, 1, 64, 128), 128, False, False, None),
    ]
    segments_batch1 = {}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        for shp, chunk, strong, flat, path in cases:
            x, a, b, c = ssd_inputs(gen, shp, dt, strong)
            fn, plain = ssd_mod.ssd_chunk, ops.ssd_chunk
            if flat:
                x, a, b, c = x[:, :, 0], a[:, :, 0], b[:, :, 0], c[:, :, 0]
                fn, plain = ssd_mod.ssd, ops.ssd
            got, ran = launched(ssd_mod, lambda: fn(x, a, b, c, chunk=chunk))
            want = plain(x, a, b, c, chunk=chunk, impl="ref")
            if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
                fail(f"ssd {shp} gave a non-finite output")
            scale = want.float().abs().max().item()
            shape = (f"{'flat ' if flat else ''}{tuple(x.shape)} x "
                     f"{tuple(b.shape)} chunk {chunk}"
                     f"{' strong decay' if strong else ''} {dname}")
            tiling = expect_tiling(f"ssd {shape}", ran, ssd_mod.select_tiling(
                dt, shp, chunk=chunk))
            err = check_close(f"ssd {shape}", got, want,
                              *ssd_tol(dname, scale))
            del got
            if shp == (1, SEQ, 64, 1, 64, 128) and dname == "bfloat16":
                segments_batch1 = ssd_segments_times(ssd_mod, x, a, b, c)
            if path is None:
                continue
            alts = {}
            if dname == "bfloat16":    # the other chunk's instance
                alts = alternatives(
                    ssd_mod,
                    [(ssd_mod.select_tiling(dt, shp, chunk=128),
                      lambda: fn(x, a, b, c, chunk=128),
                      lambda: fn(x, a, b, c, chunk=128))],
                    lambda out, t: check_close(
                        f"ssd {shape} {t}", out,
                        plain(x, a, b, c, chunk=128, impl="ref"),
                        *ssd_tol(dname, scale)), 20)
            B, S, H, G, P, N = shp
            el = x.element_size()
            # bytes: x, a, b, c read once, y written once; operations:
            # the least the function needs, the recurrence's one FMA per
            # state entry and position for the update and one for the
            # read-out (the chunked form adds L(L+1)(N+P) a chunk of L)
            ops_n = 4 * N * P * B * S * H
            records.append(record(
                "ssd", path, shape, err,
                timed(lambda: fn(x, a, b, c, chunk=chunk), 20),
                event_ms(lambda: ops.ssd_chunk(x, a, b, c, chunk=chunk,
                                               impl="ref"), 10),
                (2 * B * S * H * P + 2 * B * S * G * N) * el + B * S * H * 4,
                ops_n, dname,
                # no single PyTorch call computes the SSD scan
                None, tiling=tiling, alternatives=alts))
            del x, a, b, c, want
    next(r for r in records if r["name"] == "ssd"
         and r["shape"].endswith("bfloat16"))["segments_batch1"] = \
        segments_batch1
    torch.cuda.empty_cache()


def ssd_segments_times(ssd_mod, x, a, b, c):
    """K7 at a batch of one (64 heads fill a quarter of the card's
    resident blocks): the call with the segments the kernel chooses,
    timed beside the same call held to one segment (the heads alone, no
    states pass), in turns."""
    B, S, H, P = x.shape
    tiling = ssd_mod.select_tiling(x.dtype, (B, S, H, *b.shape[2:3], P,
                                             b.shape[3]))
    chosen = ssd_mod.segments(x, b, tiling)
    out = {"segments": chosen}
    for label in ("chosen", "one", "one_again", "chosen_again"):
        cap = 1 if label.startswith("one") else 0
        out[label] = timed(lambda: ssd_mod.ssd_chunk(x, a, b, c,
                                                     max_segments=cap), 20)
    print(f"  ssd at a batch of one {tuple(x.shape)}: {chosen} segments "
          f"{out['chosen']} and {out['chosen_again']} ms, one segment "
          f"{out['one']} and {out['one_again']} ms ((call, device), in "
          f"turns)", flush=True)
    return out


def gradient_checks(gen):
    """Each kernel's ``autograd.Function`` against autograd through its
    plain version, at the training paths' shapes in bf16 (K7's a in f32,
    strongly decaying to show no NaN in the gradient); K6's, a kernel of
    its own, in :func:`flash_attention_backward_checks`.  Both backward
    passes compute the plain version's gradient in f32 and round it to
    bf16 once, so they may differ by one bf16 rounding (2^-7 relative)
    where f32 sums in another order land on either side of a rounding
    boundary."""
    import torch
    from repro_torch.kernels import ops

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale
                + shift).to(torch.bfloat16)

    cases = {
        "rmsnorm": (lambda impl, x, g: ops.rmsnorm(x, g, impl=impl),
                    [rnd(ROWS, D_MODEL), rnd(D_MODEL, scale=0.1, shift=1.0)]),
        "fused_ff": (lambda impl, x, a, b: ops.fused_ff(x, a, b, impl=impl),
                     [rnd(ROWS, D_MODEL, scale=0.5),
                      rnd(D_MODEL, D_FF, scale=D_MODEL ** -0.5),
                      rnd(D_MODEL, D_FF, scale=D_MODEL ** -0.5)]),
        "ssd": (lambda impl, x, a, b, c: ops.ssd_chunk(x, a, b, c,
                                                       impl=impl),
                list(ssd_inputs(gen, SSM_SHAPE, torch.bfloat16,
                                strong=True))),
    }
    for name, (fn, inputs) in cases.items():
        mine = [t.clone().requires_grad_() for t in inputs]
        plain = [t.clone().requires_grad_() for t in inputs]
        out = fn(None, *mine)
        dy = torch.randn(out.shape, device="cuda",
                         generator=gen).to(out.dtype)
        got = torch.autograd.grad(out, mine, dy)
        want = torch.autograd.grad(fn("ref", *plain), plain, dy)
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.isfinite(a).all():
                fail(f"grad {name} input {i} is not finite")
            scale = b.float().abs().max().item()
            check_close(f"grad {name} input {i} {tuple(b.shape)} {b.dtype}",
                        a, b, 2 ** -8 * scale, 2 ** -7)
        del mine, plain, got, want


def kernel_phase():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    rmsnorm_checks(gen, records)
    # its own draw, so the kernels after it see the inputs they always did
    rmsnorm_sweep(torch.Generator(device="cuda").manual_seed(1), records)
    fused_ff_checks(gen, records)
    flash_attention_checks(gen, records)
    flash_attention_backward_checks(gen, records)
    gemm_checks(gen, records)
    softmax_checks(gen, records)
    ssd_checks(gen, records)
    gradient_checks(gen)
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# phase 3: the same decode on the card and on the host
# ---------------------------------------------------------------------------

def device_host_phase(arch, f64_witness=False):
    """Four paged decode passes of ``arch`` (qwen1.5-4b, mamba2-1.3b,
    olmoe-1b-7b, deepseek-v2-lite-16b: its dense layer and one moe layer)
    at full width cut to 2 layers, f32, on the card and on the host from
    the same parameters, tokens and block table; recurrent slot rows are
    passed gathered to the 8 lanes, as the engine passes them.  The
    logits agree within 1e-5 of the logit scale.

    With ``f64_witness`` (deepseek-v2-lite-16b: with the reference's
    initialisation a stacked layer's weights have unit variance at 2
    layers, so MLA's attention logits and the logits reach the hundreds,
    and the host's own f32 logits lie more than 1e-5 of that scale from
    f64) the card is held instead to the host's f64 evaluation: at each
    pass, max|card - f64| within max|host - f64| plus 1e-5 of the scale,
    which a card within 1e-5 of the host meets too (ROADMAP §C)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import init_paged_caches, paged_decode_step
    from repro_torch.serve.decode import paged_cache_kinds

    cfg = get_config(arch).replace(n_layers=2, dtype="float32")
    cfg64 = cfg.replace(dtype="float64")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    dparams = _tree_to(params, "cuda")
    B, bs, steps = LANES, 16, 4
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.permutation(B * 2).reshape(B, 2).astype(np.int64))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (steps, B, 1)))

    def lanes(caches):
        return [{k: a[:B] for k, a in c.items()} if kind == "slot" else c
                for c, kind in zip(caches, paged_cache_kinds(cfg))]

    host = lanes(init_paged_caches(cfg, B * 2, bs, B))
    dev = lanes(init_paged_caches(cfg, B * 2, bs, B, "cuda"))
    if f64_witness:
        params64 = _tree_to(params, "cpu", torch.float64)
        host64 = lanes(init_paged_caches(cfg64, B * 2, bs, B))
    wmask = torch.ones(B, dtype=torch.bool)
    worst = -float("inf")
    for t in range(steps):
        pos = torch.full((B,), t)
        h_logits, host = paged_decode_step(params, host, table, toks[t], pos,
                                           wmask, cfg, 2 * bs)
        d_logits, dev = paged_decode_step(dparams, dev, table, toks[t], pos,
                                          wmask, cfg, 2 * bs)
        d_logits = d_logits.cpu()
        scale = h_logits.abs().max().item()
        line = (f"  pass {t}: max|d| {(d_logits - h_logits).abs().max():.3e}"
                f" of max|logit| {scale:.1f}")
        if f64_witness:
            exact, host64 = paged_decode_step(params64, host64, table,
                                              toks[t], pos, wmask, cfg64,
                                              2 * bs)
            h_err = (h_logits.double() - exact).abs().max().item()
            d_err = (d_logits.double() - exact).abs().max().item()
            line += (f"; against f64: card {d_err:.3e}, host {h_err:.3e} "
                     f"(bound {h_err + 1e-5 * scale:.3e})")
            worst = max(worst, (d_err - h_err) / scale)
        else:
            worst = max(worst, (d_logits - h_logits).abs().max().item()
                        / scale)
        print(line, flush=True)
    # f32 dot products over 2048-6912 terms, summed in other orders on the
    # two devices (no TF32): a relative bound on the logit scale
    what = ("(max|card - f64| - max|host - f64|)" if f64_witness
            else "max|d|")
    print(f"  {arch}: worst {what} / max|logit| {worst:.3e} (bound 1e-5)",
          flush=True)
    if not worst <= 1e-5:
        fail(f"device and host decode logits of {arch} disagree")


def device_host_train_step(arch, **cut):
    """One train step of ``arch`` (stablelm-3b, mamba2-1.3b, olmoe-1b-7b,
    deepseek-v2-lite-16b: its dense layer and one moe layer; zamba2-2.7b
    cut to 12 layers: two groups, so that the shared block's gradient
    sums two applications; whisper-large-v3 cut to 2 encoder and 2
    decoder layers, over the pipeline's stub frames, on weights at each
    layer's own fan-in as ``device_host_encdec`` holds it) at full width
    cut in depth by ``cut`` (default: 2 layers), f32, from the same
    parameters and batch: on the card through ``make_train_step``, on the
    host through ``compute_grads``, whose loss and gradients are what
    that step's metrics read (the host's optimizer update, which no
    metric reads, is not run).

    The loss agrees within 1e-4 relative.  The grad-norm cannot: with the
    reference's initialisation (a tied N(0, 1) embedding at width 2560,
    logits in the hundreds) this function's f32 gradients are
    ill-conditioned, and every f32 evaluation of it, on either device,
    lies about 0.5% from an f64 evaluation (stablelm-3b).  So, as the CPU
    parity tests bound f32 logits and gradients, the grad-norm is held to
    1e-4 relative plus twice the host's own f32 error against the host's
    f64 evaluation."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_data
    from repro_torch.models import for_config
    from repro_torch.optim import adamw
    from repro_torch.train import TrainState, compute_grads, make_train_step
    from repro_torch.utils.tree import global_norm

    cfg = get_config(arch).replace(**(cut or {"n_layers": 2}),
                                   dtype="float32")
    batch = make_data(cfg, 128, 2, seed=0).batch_at(0)
    params = for_config(cfg).init_model(cfg, torch.Generator().manual_seed(0))
    if cfg.family == "encdec":     # chaotic as drawn: device_host_encdec
        params = per_layer_fan_in(params)
    host_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = compute_grads(params, host_batch, cfg)
    metrics = {"cpu": {"loss": float(loss),
                       "grad_norm": float(global_norm(grads)), "step": 1.0}}
    del grads
    opt = adamw(3e-4, weight_decay=0.1, max_grad_norm=1.0)
    p = _tree_to(params, "cuda")
    state = TrainState(p, opt.init(p),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    _, m = make_train_step(cfg, opt)(state, {
        k: v.to("cuda") for k, v in host_batch.items()})
    metrics["cuda"] = {k: float(v) for k, v in m.items()}
    del state, p
    cfg64 = cfg.replace(dtype="float64")
    _, g64 = compute_grads(_tree_to(params, "cpu", torch.float64),
                           host_batch, cfg64)
    exact = float(global_norm(g64))
    host, dev = metrics["cpu"], metrics["cuda"]
    host_err = abs(host["grad_norm"] - exact) / exact
    rel = {k: abs(dev[k] - host[k]) / abs(host[k])
           for k in ("loss", "grad_norm")}
    bounds = {"loss": 1e-4, "grad_norm": 1e-4 + 2 * host_err}
    print(f"  {arch} train step host {host}\n  train step card {dev}\n"
          f"  host f64 grad_norm {exact:.6f}: host f32 off by {host_err:.3e}, "
          f"card f32 by {abs(dev['grad_norm'] - exact) / exact:.3e}\n"
          f"  card against host: relative |d| {rel}, bounds {bounds}",
          flush=True)
    if not all(rel[k] <= bounds[k] for k in rel):
        fail(f"device and host train steps of {arch} disagree")


def _hold_to_host(what, host, card, exact):
    """Card logits against the host's within 1e-5 of the logit scale; or,
    where the host's own f32 logits lie farther than that from ``exact``
    (its f64 evaluation), against ``exact``: max|card - f64| within
    max|host - f64| plus 1e-5 of the scale (deepseek-v2-lite-16b's route,
    ROADMAP §C).  Returns the held quantity over the scale."""
    scale = host.abs().max().item()
    d = (card - host).abs().max().item()
    h_err = (host.double() - exact).abs().max().item()
    c_err = (card.double() - exact).abs().max().item()
    f64_route = h_err > 1e-5 * scale
    held = (c_err - h_err if f64_route else d) / scale
    print(f"  {what}: max|card - host| {d:.3e} of max|logit| {scale:.1f}; "
          f"against f64: card {c_err:.3e}, host {h_err:.3e}; held "
          f"{'(card - host against f64)' if f64_route else '|card - host|'}"
          f" / scale {held:.3e} (bound 1e-5)", flush=True)
    if not held <= 1e-5:
        fail(f"{what}: the card disagrees with the host")
    return held


def per_layer_fan_in(params):
    """``params`` (a tree of dicts of numpy arrays or tensors) with every
    stacked layer matrix (L, d_in, d_out) rescaled from the init's std
    1/sqrt(L) to 1/sqrt(d_in).  ``ParamSpec.make`` reads a stacked leaf's
    first axis, the layer count, as its fan-in (the reference's init does
    the same); a stacked expert tensor (L, E, d_in, d_out) likewise to
    1/sqrt(d_in).  ``tests/test_torch_encdec.py`` and
    ``tools/encdec_parity_witness.py`` use it too."""
    import math
    return {k: per_layer_fan_in(v) if isinstance(v, dict)
            else v * math.sqrt(v.shape[0] / v.shape[1]) if v.ndim == 3
            else v * math.sqrt(v.shape[0] / v.shape[2]) if v.ndim == 4
            else v for k, v in params.items()}


def fill_cross(cfg, layers, enc_out, caches, apply_dense):
    """``caches`` (``init_caches``'s, zero cross caches) with each decoder
    layer's ``ck`` / ``cv`` written from ``enc_out``: its cross-attention's
    biased k and v projections, as the forward computes them (the
    caller's side of the reference's contract; neither package has a
    function for it).  ``layers`` are the decoder layers' parameters and
    ``apply_dense`` the package's dense product, so that the tests fill
    either package's caches through this one function."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.n_kv_heads, cfg.head_dim)
    return [dict(cache, **{
        key: apply_dense(layer["cross"][w], enc_out).reshape(shape)
        for key, w in (("ck", "wk"), ("cv", "wv"))})
        for layer, cache in zip(layers, caches)]


def _encdec_outputs(params, cfg, device, inputs):
    """[forward logits, then each decode pass's] of the encoder-decoder on
    ``device``, on the host: the forward over ``inputs``' frames and
    tokens, then decode passes over cross caches written from
    ``device``'s own encoding of ``inputs``' 1536 frames."""
    import torch
    from repro_torch.models import encdec, lm
    from repro_torch.nn.core import apply_dense
    from repro_torch.serve import decode_step, init_caches

    frames, tokens, enc_frames, steps = (torch.from_numpy(a).to(device)
                                         for a in inputs)
    params = _tree_to(params, device, torch.float64
                      if cfg.dtype == "float64" else None)
    with torch.no_grad():
        out = [encdec.forward(params, frames, tokens, cfg).cpu()]
        enc_out = encdec.encode(params, enc_frames, cfg)
        caches = fill_cross(
            cfg, lm._unstack(params["dec_layers"], cfg.dec_layers), enc_out,
            init_caches(cfg, steps.shape[1], len(steps), device), apply_dense)
        for t in range(len(steps)):
            logits, caches = decode_step(params, caches, steps[t], t, cfg)
            out.append(logits.cpu())
    return out


def device_host_encdec(arch):
    """``arch`` (whisper-large-v3) at full width cut to 2 encoder and 2
    decoder layers, on the card and on the host from the same parameters
    and inputs: the forward logits of 2 rows of 128 seeded frames and
    tokens, then 8 decode passes of 2 rows over cross caches that each
    device writes from its own encoding of ``ENC_LEN_DECODE`` seeded
    frames (the caller's side of the reference's contract).

    Each is held by ``_hold_to_host`` (1e-5 of the logit scale, or
    deepseek's f64 route), in f32 on the kernels, on weights drawn at
    each layer's own fan-in (``per_layer_fan_in``).  With the init's
    own weights (variance 1/2 at 2 stacked layers) this cut is chaotic:
    two host f32 evaluations that differ only in their products'
    summation order lie 0.2 of the logit scale apart, and a one-ulp move
    of the f32 rope table (f32 in both packages, and computed by each
    device's own ``pow``) moves even the f64 logits by as much
    (``tools/encdec_parity_witness.py --full-width-cut``, ROADMAP §C), so
    no bound on the card against the host holds on them."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_large_v3 import ENC_LEN_DECODE
    from repro_torch.models import encdec

    cfg = get_config(arch).replace(n_layers=4, enc_layers=2, dec_layers=2,
                                   dtype="float32")
    cfg64 = cfg.replace(dtype="float64")
    init = encdec.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    inputs = (rng.standard_normal((2, 128, cfg.d_model)).astype(np.float32),
              rng.integers(0, cfg.vocab, (2, 128)),
              rng.standard_normal((2, ENC_LEN_DECODE, cfg.d_model)).astype(
                  np.float32),
              rng.integers(0, cfg.vocab, (8, 2, 1)))
    names = ["forward logits"] + [f"decode pass {t}" for t in range(8)]
    params = per_layer_fan_in(init)
    worst = max(_hold_to_host(f"{arch} {what}", host, card, exact)
                for what, host, card, exact in zip(
                    names, _encdec_outputs(params, cfg, "cpu", inputs),
                    _encdec_outputs(params, cfg, "cuda", inputs),
                    _encdec_outputs(params, cfg64, "cpu", inputs)))
    print(f"  {arch}: worst held / max|logit| {worst:.3e} (bound 1e-5)",
          flush=True)


def _tree_to(tree, device, dtype=None):
    return {k: _tree_to(v, device, dtype) if isinstance(v, dict)
            else v.to(device, dtype) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 4: the serving main paths — the paged engine, and whisper's encoder
# and decode steps
# ---------------------------------------------------------------------------

def _kernel_modules():
    import importlib
    return {name: importlib.import_module(f"repro_torch.kernels.{name}")
            for name in KERNELS}


def _reset_launches():
    for mod in _kernel_modules().values():
        mod.launches = 0
        if hasattr(mod, "launches_by_tiling"):
            mod.launches_by_tiling.clear()
    from repro_torch.kernels import flash_attention as fa_mod
    fa_mod.backward_launches = fa_mod.plain_backward_calls = 0
    fa_mod.backward_launches_by_tiling.clear()


class _Launches(dict):
    """{kernel: launches} of a phase's run, and in ``tilings`` {kernel:
    {tiling: launches}} for the kernels that count their instances."""


def _read_launches():
    mods = _kernel_modules()
    out = _Launches((name, mod.launches) for name, mod in mods.items())
    out.tilings = {name: dict(mod.launches_by_tiling)
                   for name, mod in mods.items()
                   if hasattr(mod, "launches_by_tiling")}
    return out


def _expected_launches(**counts):
    return {name: counts.get(name, 0) for name in KERNELS}


# the serving trace: a seeded Poisson trace of 16 requests at 4 a second
# from 2 tenants, prompts of 64-128 tokens, 32-64 generated
SERVE_TRAFFIC = dict(qps=4.0, n_requests=16, n_tenants=2,
                     prompt_len=(64, 128), output_len=(32, 64), seed=0)
# The spill run: the trace's first 8 requests submitted at once into a
# pool cut to 48 blocks of 16 positions (from 8 lanes x 256 = 128
# blocks).  Which requests stall and spill then depends on the pool
# alone, not on the clock: 2 spills and 2 resumes (the same run on the
# host at reduced widths: the pool's accounting does not depend on the
# widths).
PREEMPT_REQUESTS, PREEMPT_KV_BLOCKS = 8, 48


def serve_sites(cfg):
    """Kernel launches a decode pass of ``cfg`` makes, by kernel: K1 at
    each norm (an attention layer's ln1 and ln2, its q and k norms where
    the config has them and MLA's latent norm; a Mamba-2 layer's ln1 and
    gated norm; the hybrid's shared block's two at each of its
    applications) and at the final norm, K2 at each SwiGLU (a dense
    layer's MLP, an moe layer's shared experts)."""
    shared = (cfg.n_layers // cfg.shared_attn_every
              if cfg.family == "hybrid" else 0)
    if cfg.family in ("dense", "moe"):
        per_layer = 2 + 2 * cfg.qk_norm + cfg.mla
        n_moe = cfg.n_layers - cfg.first_dense_layers \
            if cfg.family == "moe" else 0
        return {"rmsnorm": per_layer * cfg.n_layers + 1,
                "fused_ff": cfg.n_layers - n_moe
                + (n_moe if cfg.n_shared_experts else 0)}
    return {"rmsnorm": 2 * cfg.n_layers + 2 * shared + 1,
            "fused_ff": shared}


# Phase 4 serves at full width and these depths, about a quarter of the
# published ones (zamba2-2.7b's in whole groups of 6), to keep the script
# inside its time limit: a pass's host time scales with the layers (half
# the published depths until the whole script took 1239.1 s on one
# H100's host with phase 5d).
SERVE_LAYERS = {"qwen1.5-4b": 10, SSM_ARCH: 12, HYBRID_ARCH: 12,
                MOE_ARCH: 4, MLA_ARCH: 7}


def _serve_engine(arch, **kw):
    """(cfg, engine): the paged ``ServeEngine`` over ``arch`` at full
    width and the depth of ``SERVE_LAYERS``, bf16, seeded random weights,
    8 lanes of 256 positions, warmed up."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine, Tenant
    from repro_torch.utils.tree import param_count

    cfg = get_config(arch).replace(n_layers=SERVE_LAYERS[arch])
    t0 = time.perf_counter()
    engine = ServeEngine.from_config(
        cfg, max_batch=LANES, max_seq=256, block_size=16, paged=True,
        tenants=[Tenant("t0"), Tenant("t1")], rng_seed=0, device="cuda",
        **kw)
    torch.cuda.synchronize()
    n_params = param_count(engine.params)
    print(f"  {cfg.name}: {n_params / 1e9:.3f} B parameters in bf16, made "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    engine.generate([1, 2, 3], 2, tenant="t0")      # warm-up: cuBLAS etc.
    engine.finished.clear()
    return cfg, engine


def _check_served(cfg, engine, n_requests, passes, launches):
    """Every request finished whole with in-vocab tokens, and the kernels
    launched ``serve_sites`` times a pass."""
    reqs = engine.finished
    bad = [r.id for r in reqs if r.truncated or len(r.output)
           != r.max_new_tokens or not all(0 <= t < cfg.vocab
                                          for t in r.output)]
    if len(reqs) != n_requests or bad:
        fail(f"{cfg.name}: {len(reqs)} of {n_requests} requests finished; "
             f"incomplete or out of vocab: {bad}")
    want = _expected_launches(**{name: passes * n for name, n
                                 in serve_sites(cfg).items()})
    print(f"  passes {passes}; launches {launches}; expected {want} "
          f"({serve_sites(cfg)} a pass); by tiling {launches.tilings}",
          flush=True)
    if launches != want or passes == 0:
        fail(f"the {cfg.name} serving path did not go through the kernels "
             f"once per site")


def serve_phase(arch, profile_dir):
    """``arch`` served through the paged engine on the serving trace."""
    import torch
    from repro_torch.serve import TrafficConfig, run_load

    cfg, engine = _serve_engine(arch)
    traffic = TrafficConfig(vocab=cfg.vocab, **SERVE_TRAFFIC)
    passes0 = engine.counters["passes"]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    report = run_load(engine, traffic)
    torch.cuda.synchronize()
    launches = _read_launches()
    passes = engine.counters["passes"] - passes0
    print(f"  requests completed {report['completed']}/"
          f"{report['n_requests']}, tokens {report['tokens']}", flush=True)
    if report["completed"] != traffic.n_requests:
        fail(f"{arch}: requests incomplete")
    _check_served(cfg, engine, traffic.n_requests, passes, launches)
    stats = {
        "tokens_per_s": report["tokens_per_s"],
        "latency_p50_s": report["latency_p50_s"],
        "latency_p99_s": report["latency_p99_s"],
        "ttft_p50_s": report["ttft_p50_s"],
        "ttft_p99_s": report["ttft_p99_s"],
        "wall_s": report["wall_s"], "passes": passes,
        "ms_per_pass": report["wall_s"] * 1e3 / passes,
        "lane_utilization": report["stats"]["engine"]["lane_utilization"],
        "peak_kv_bytes": engine.peak_kv_bytes(),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"  serving main path ({arch}) " + json.dumps(stats), flush=True)
    _SERVE_STATS[arch] = stats
    if profile_dir:
        profile_passes(engine, cfg, profile_dir)
    del engine
    torch.cuda.empty_cache()
    return launches


def fork_phase(arch):
    """Copy-on-write over ``arch``'s pages (deepseek-v2-lite-16b: the MLA
    latent and rope-key pages): one donor prefills a prompt of
    ``FORK_PROMPT`` tokens (a partial last block), then ``FORK_SHARERS``
    identical prompts are admitted onto its registered pages, prefill
    nothing, and fork the partial block on their first write.  Clock-free:
    each count is the pool's alone.  Every stream equals the donor's, so
    a forked page holds what the donor's own pages hold, and the launch
    counts equal passes x ``serve_sites``."""
    import numpy as np
    import torch

    cfg, engine = _serve_engine(arch)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, FORK_PROMPT).tolist()
    passes0 = engine.counters["passes"]
    _reset_launches()
    t0 = time.perf_counter()
    donor = engine.submit(prompt, FORK_NEW_TOKENS, tenant="t0")

    def donor_pos():
        slot = next((s for s in engine._active if s.request is donor), None)
        return -1 if slot is None else slot.pos

    # the partial block is registered once the pass at the prompt's last
    # position has completed it
    while donor_pos() < len(prompt):
        engine.step()
    for i in range(FORK_SHARERS):
        engine.submit(prompt, FORK_NEW_TOKENS, tenant=f"t{i % 2}")
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    passes = engine.counters["passes"] - passes0
    _check_served(cfg, engine, 1 + FORK_SHARERS, passes, launches)
    c = engine.counters
    stats = {k: c[k] for k in ("prefix_hits", "cow_forks", "admissions")}
    stats.update(passes=passes, wall_s=wall,
                 streams_equal=all(r.output == donor.output
                                   for r in engine.finished))
    print(f"  fork run ({arch}) " + json.dumps(stats), flush=True)
    if c["prefix_hits"] < FORK_SHARERS or c["cow_forks"] < FORK_SHARERS \
            or not stats["streams_equal"]:
        fail(f"{arch}: shared pages did not fork copy-on-write into the "
             f"donor's stream: {stats}")
    del engine
    torch.cuda.empty_cache()
    return launches


def preempt_phase(arch):
    """``arch`` with its pool cut (``PREEMPT_KV_BLOCKS``): the serving
    trace's first ``PREEMPT_REQUESTS`` requests, submitted at once, must
    spill at least one request's pages and recurrent slot rows to the
    host and resume it by upload, and every request must complete."""
    import torch
    from repro_torch.serve import TrafficConfig, poisson_trace

    cfg, engine = _serve_engine(arch, kv_blocks=PREEMPT_KV_BLOCKS)
    trace = poisson_trace(TrafficConfig(**dict(
        SERVE_TRAFFIC, n_requests=PREEMPT_REQUESTS, vocab=cfg.vocab)),
        ["t0", "t1"])
    for a in trace:
        engine.submit(a.prompt, a.max_new_tokens, tenant=a.tenant)
    passes0 = engine.counters["passes"]
    _reset_launches()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    passes = engine.counters["passes"] - passes0
    _check_served(cfg, engine, PREEMPT_REQUESTS, passes, launches)
    c = engine.counters
    stats = {k: c[k] for k in ("preemptions", "preempt_spills",
                               "resume_uploads", "stalls")}
    stats.update(passes=passes, wall_s=wall, kv_blocks=PREEMPT_KV_BLOCKS,
                 ms_per_pass=wall * 1e3 / passes,
                 resume_tokens=sum(len(r.resume_tokens)
                                   for r in engine.finished))
    print(f"  spill run ({arch}) " + json.dumps(stats), flush=True)
    if c["preempt_spills"] < 1 or c["resume_uploads"] < 1 \
            or stats["resume_tokens"]:
        fail(f"{arch} with {PREEMPT_KV_BLOCKS} blocks: no spill and resume, "
             f"or a resume that recomputed: {stats}")
    del engine
    torch.cuda.empty_cache()
    return launches


def encdec_serve_phase(arch, profile_dir):
    """``arch`` (whisper-large-v3) at full width and depth, bf16, seeded
    random weights, 8 rows: encode ``ENC_LEN_DECODE`` seeded frames (K6
    once an encoder layer), write every decoder layer's cross caches
    ``ck`` / ``cv`` from the encoder's output (the caller's side of the
    reference's contract), then greedy-decode a prompt of
    ``ENCDEC_PROMPT`` tokens and ``ENCDEC_NEW_TOKENS`` new ones through
    ``decode_step`` (``generate()``'s loop, the prompt teacher-forced):
    a decode pass launches no kernel (layernorm, the GELU MLP and decode
    attention are plain in both packages).  Then one ``generate()`` call
    over zero cross caches, the reference's own contract.  The counts
    are exact: K6 once an encoder layer, nothing else.  With
    ``profile_dir``, 8 more decode passes under torch.profiler
    (``profile_decode_ARCH.txt``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_large_v3 import ENC_LEN_DECODE
    from repro_torch.models import encdec, lm
    from repro_torch.nn.core import apply_dense
    from repro_torch.serve import decode_step, generate, init_caches
    from repro_torch.utils.tree import param_count

    cfg = get_config(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = encdec.init_model(cfg, gen)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.enc_layers} + {cfg.dec_layers} layers, "
          f"{param_count(params) / 1e9:.3f} B parameters in {cfg.dtype}, "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    frames = torch.randn((LANES, ENC_LEN_DECODE, cfg.d_model), device="cuda",
                         generator=gen)
    prompt = torch.randint(0, cfg.vocab, (LANES, ENCDEC_PROMPT),
                           device="cuda", generator=gen)
    total = ENCDEC_PROMPT + ENCDEC_NEW_TOKENS
    with torch.inference_mode():
        encdec.encode(params, frames, cfg)      # warm-up: cuBLAS etc.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        enc_out = encdec.encode(params, frames, cfg)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        encode_launches = _read_launches()
        caches = fill_cross(
            cfg, lm._unstack(params["dec_layers"], cfg.dec_layers), enc_out,
            init_caches(cfg, LANES, total + PROFILED_PASSES, "cuda"),
            apply_dense)
        cross_bytes = sum(c[k].numel() * c[k].element_size()
                          for c in caches for k in ("ck", "cv"))
        del enc_out
        tokens = torch.zeros((LANES, total), dtype=torch.long, device="cuda")
        tokens[:, :ENCDEC_PROMPT] = prompt
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(total - 1):
            logits, caches = decode_step(params, caches,
                                         tokens[:, pos:pos + 1], pos, cfg)
            finite &= torch.isfinite(logits).all()
            if pos + 1 >= ENCDEC_PROMPT:
                tokens[:, pos + 1] = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        finite = bool(finite)
        if profile_dir:
            _profile_encdec_passes(params, caches, tokens[:, -1:], total - 1,
                                   cfg, profile_dir)
        del caches
        generated = generate(params, cfg, prompt, ENCDEC_NEW_TOKENS)
        torch.cuda.synchronize()
    launches = _read_launches()
    passes = total - 1
    want = _expected_launches(flash_attention=cfg.enc_layers)
    print(f"  encode launches {encode_launches}; encode, {passes} decode "
          f"passes and a generate() call: {launches}; expected {want}; by "
          f"tiling {launches.tilings}", flush=True)
    if encode_launches != want or launches != want:
        fail(f"the {arch} serving path did not launch K6 once an encoder "
             f"layer and nothing a decode pass")
    for name, toks in (("decode over the encoder's caches", tokens),
                       ("generate() over zero caches", generated)):
        if toks.shape != (LANES, total) or not finite or not bool(
                ((toks >= 0) & (toks < cfg.vocab)).all()):
            fail(f"{arch} {name}: tokens of shape {tuple(toks.shape)} or "
                 f"out of vocab, or logits not finite")
    stats = {
        "rows": LANES, "frames": ENC_LEN_DECODE, "encode_ms": encode_s * 1e3,
        "passes": passes, "ms_per_pass": decode_s * 1e3 / passes,
        "tokens_per_s": LANES * ENCDEC_NEW_TOKENS / decode_s,
        "cross_cache_bytes": cross_bytes,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "sample": tokens[0, :16].tolist(),
    }
    print(f"  serving main path ({arch}) " + json.dumps(stats), flush=True)
    del params
    torch.cuda.empty_cache()
    return launches


PROFILED_PASSES = 8


def _profile_encdec_passes(params, caches, token, pos, cfg, out_dir):
    """torch.profiler over ``PROFILED_PASSES`` decode passes from ``pos``
    on: device busy share and time by kernel, written to
    ``out_dir``/profile_decode_ARCH.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import decode_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILED_PASSES):
            logits, caches = decode_step(params, caches, token, pos + i, cfg)
            token = logits.argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lines, busy_us = _kernel_breakdown(prof)
    _write_profile(out_dir, f"profile_decode_{cfg.name}.txt", lines, prof)
    print(f"  profile: {PROFILED_PASSES} passes in {wall * 1e3:.1f} ms wall "
          f"(profiler on), device busy {busy_us / 1e3:.1f} ms = "
          f"{busy_us / 1e6 / wall:.1%} of wall; kernel time by name:",
          flush=True)
    print("\n".join("    " + line for line in lines[:20]), flush=True)


def _kernel_breakdown(prof):
    """(lines of device time by kernel name, device-busy microseconds) —
    from the kernels' own events (an op's row in key_averages() repeats
    the time of the kernels it launched)."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + stop - start)
    lines = [f"{t / 1e3:10.3f} ms {n:6d} x {t / n:9.2f} us  {name[:90]}"
             for name, (n, t) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][1])]
    return lines, busy_us


def _write_profile(out_dir, name, lines, prof):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(prof.key_averages().table(row_limit=60))


def profile_passes(engine, cfg, out_dir: str, n_passes: int = 8):
    """torch.profiler over steady decode passes: device busy share and
    time by kernel, written to ``out_dir``/profile_decode_ARCH.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng_prompt = list(range(1, 97))
    for i in range(LANES):
        engine.submit([(t + i) % cfg.vocab for t in rng_prompt], 64,
                      tenant="t0")
    while any(s.in_prefill for s in engine._active) or not engine._active:
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        before = engine.counters["passes"]
        while engine.counters["passes"] - before < n_passes:
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    done = engine.counters["passes"] - before
    lines, busy_us = _kernel_breakdown(prof)
    _write_profile(out_dir, f"profile_decode_{cfg.name}.txt", lines, prof)
    print(f"  profile: {done} passes in {wall * 1e3:.1f} ms wall (profiler "
          f"on), device busy {busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.1%}"
          f" of wall; kernel time by name:", flush=True)
    print("\n".join("    " + line for line in lines[:20]), flush=True)
    engine.run()


# ---------------------------------------------------------------------------
# phase 5: the training main paths — Trainer at full width
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3


def train_sites(cfg):
    """Kernel launches a train step of ``cfg`` makes, by kernel: every
    site of a decode pass (``serve_sites``) but the final norm twice, in
    the forward and in the recompute of remat (per layer, or per group of
    Mamba-2 layers and the shared block that follows it), and the final
    norm once; K6 at each attention, K7 at each Mamba-2 layer, likewise
    twice.  The encoder-decoder's norms are layernorms and its MLP GELU,
    plain in both packages: it launches K6 alone, at each encoder layer's
    self-attention and each decoder layer's self- and cross-attention, in
    the forward and again in remat's recompute of the layer."""
    if cfg.family == "encdec":
        return {"rmsnorm": 0, "fused_ff": 0, "ssd": 0,
                "flash_attention": 2 * (cfg.enc_layers + 2 * cfg.dec_layers)}
    sites = serve_sites(cfg)
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "hybrid": sites["fused_ff"]}[cfg.family]
    return {"rmsnorm": 2 * (sites["rmsnorm"] - 1) + 1,
            "fused_ff": 2 * sites["fused_ff"],
            "flash_attention": 2 * attn,
            "ssd": (2 * cfg.n_layers if cfg.family in ("ssm", "hybrid")
                    else 0)}


def train_roofline(cfg, step_s: float) -> None:
    """The roofline terms of one train step of ``cfg`` at the phase's
    global batch, mesh-less, beside its measured ``step_s``: flops and
    ``bytes_fused`` from ``launch.jcost.cost_of`` on fake tensors on the
    host (nothing runs on the card) at 1 and 2 layers, extrapolated
    linearly to ``cfg.n_layers``, over the H100 peaks of
    ``launch.roofline``; and ``model_flops / (step_s x peak)``, the model
    flops utilisation of the measured step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.jcost import cost_of
    from repro_torch.launch.specs import cell

    t0 = time.perf_counter()
    at = {}
    for n in (1, 2):
        with FakeTensorMode():
            fn, args = cell(cfg.replace(n_layers=n), "train", SEQ, BATCH)
            at[n] = cost_of(fn, *args)
    est = {k: at[1][k] + (cfg.n_layers - 1) * (at[2][k] - at[1][k])
           for k in ("flops", "bytes_fused")}
    peak = rl.PEAK_FLOPS[cfg.dtype]
    model_flops = 6.0 * cfg.n_active_params() * SEQ * BATCH
    line = {"n_layers": cfg.n_layers, "tokens": SEQ * BATCH,
            "flops": est["flops"], "bytes_fused": est["bytes_fused"],
            "compute_s": est["flops"] / peak,
            "memory_s": est["bytes_fused"] / rl.HBM_BW,
            "step_s": step_s, "model_flops": model_flops,
            "model_flops_per_step_s_peak": model_flops / (step_s * peak),
            "counted_s": time.perf_counter() - t0}
    print(f"  roofline of the step ({cfg.name}, launch.jcost at 1 and 2 "
          f"layers to {cfg.n_layers}, peak {peak:.3g} FLOP/s, "
          f"{rl.HBM_BW:.3g} B/s) " + json.dumps(line), flush=True)
    if not (line["flops"] > 0 and line["bytes_fused"] > 0
            and 0 < line["model_flops_per_step_s_peak"] < 1):
        fail("the step's roofline terms are out of range")


def train_phase(arch, profile_dir, roofline=False):
    """``TRAIN_STEPS`` steps of ``arch`` at full width, with the layers of
    ``TRAIN_LAYERS`` where the full depth does not fit one card; with
    ``roofline``, its roofline terms beside the measured step
    (:func:`train_roofline`)."""
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import TrainConfig, Trainer, loss_fn
    from repro_torch.utils.tree import param_count

    cfg = get_config(arch)
    if arch in TRAIN_LAYERS:
        cfg = cfg.replace(n_layers=TRAIN_LAYERS[arch])
    tcfg = TrainConfig(steps=TRAIN_STEPS, seq_len=SEQ, global_batch=BATCH)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, device="cuda")
    torch.cuda.synchronize()
    n_params = param_count(trainer.state.params)
    print(f"  {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters in {cfg.dtype}, remat {cfg.remat}, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # step 0's loss evaluated once more with every kernel replaced by its
    # plain version, from the same parameters and batch
    batch0 = {k: torch.from_numpy(v).to("cuda")
              for k, v in trainer.data.batch_at(0).items()}
    with torch.no_grad(), ops.forced("ref"):
        plain_loss = float(loss_fn(trainer.state.params, batch0, cfg)[0])
    del batch0
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    log = trainer.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    tokens = BATCH * SEQ
    for row in log:
        print(f"  step {row['step']}: loss {row['loss']:.4f} grad_norm "
              f"{row['grad_norm']:.4f} {row['seconds']:.3f} s "
              f"({tokens / row['seconds']:.0f} tokens/s)", flush=True)
    if len(log) != TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            for r in log):
        fail("a training loss or grad-norm is not finite")
    # bf16 activations through 32 to 54 layers: the kernels and the plain
    # versions round the same values to bf16 at the same places, but
    # their f32 sums run in other orders, so bf16 roundings may flip.
    rel = abs(log[0]["loss"] - plain_loss) / abs(plain_loss)
    print(f"  step 0 loss {log[0]['loss']:.4f}; with the plain versions "
          f"{plain_loss:.4f}; relative |d| {rel:.3e} (bound 1e-2)",
          flush=True)
    if not rel <= 1e-2:
        fail("step 0's loss disagrees with the plain versions' loss")
    want = _expected_launches(**{
        name: TRAIN_STEPS * n for name, n in train_sites(cfg).items()})
    print(f"  launches {launches}; expected {want} ({train_sites(cfg)} a "
          f"step: forward and recompute); by tiling {launches.tilings}",
          flush=True)
    if launches != want:
        fail("the training path did not go through the kernels once per "
             "site and pass")
    # K6's gradient: the backward kernel once per attention a step (the
    # forward runs twice, in the pass and in remat's recompute)
    from repro_torch.kernels import flash_attention as fa_mod
    bwd = (fa_mod.backward_launches, fa_mod.plain_backward_calls)
    print(f"  K6 backward kernel launches {bwd[0]} "
          f"({dict(fa_mod.backward_launches_by_tiling)}), plain backward "
          f"calls {bwd[1]}; expected {want['flash_attention'] // 2} and 0",
          flush=True)
    if bwd != (want["flash_attention"] // 2, 0):
        fail("the training path's attention gradient did not run the "
             "backward kernel once per site")
    steady = [r["seconds"] for r in log[1:]]
    stats = {
        "n_layers": cfg.n_layers, "steps": len(log), "wall_s": wall,
        "step_s": [r["seconds"] for r in log],
        "steady_step_s": statistics.median(steady),
        "tokens_per_s": tokens / statistics.median(steady),
        "loss": [r["loss"] for r in log],
        "grad_norm": [r["grad_norm"] for r in log],
        "max_memory_allocated_gb": peak_gb,
    }
    print(f"  training main path ({arch}) " + json.dumps(stats), flush=True)
    if roofline:
        train_roofline(cfg, stats["steady_step_s"])
    if profile_dir:
        profile_train_step(trainer, profile_dir)
    del trainer
    torch.cuda.empty_cache()
    return launches


# the remat policies' run: stablelm-3b at full width cut to this depth,
# one step under each policy (None: no remat)
DOTS_LAYERS = 4
REMAT_POLICIES = (None, "nothing", "dots")
# further runs of "dots", for the spread of one policy's grad-norm
REMAT_REPEATS = 2


def remat_sites(cfg, policy):
    """Kernel launches a train step of ``cfg`` makes under remat
    ``policy``: ``train_sites``'s (``"nothing"``: forward and recompute);
    under ``"dots"`` K2, K6 and K7 once, their outputs saved
    (``models/lm.py::_remat``); without remat every kernel once."""
    sites = train_sites(cfg)
    if policy == "nothing":
        return sites
    return {name: (n if name == "rmsnorm" and policy == "dots"
                   else (n - 1) // 2 + 1 if name == "rmsnorm" else n // 2)
            for name, n in sites.items()}


def remat_phase():
    """One bf16 train step of stablelm-3b at full width and
    ``DOTS_LAYERS`` layers, seq ``SEQ`` x batch ``BATCH``, under each of
    ``REMAT_POLICIES`` from the same seeded parameters and batch: each
    run's loss, grad-norm, seconds, peak memory and K1/K2/K6 launches
    (held to ``remat_sites``); ``"dots"``'s loss equal to ``"nothing"``'s
    and its grad-norm within 1e-6 relative; peak memory ordered
    ``"nothing"`` < ``"dots"`` < no remat.  ``"dots"`` runs
    ``REMAT_REPEATS`` times more: K6's backward kernel adds dq in no fixed
    order, so one policy's grad-norm may differ from run to run, and that
    spread must stay under a tenth of the 1e-6 for the comparison of two
    policies to mean anything.
    Returns ``"dots"``'s launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.utils.tree import tree_map

    base = get_config(PIPE_ARCH).replace(n_layers=DOTS_LAYERS)
    params = lm.init_model(base, torch.Generator("cuda").manual_seed(0))
    batch = _pipe_batch(base, 0)
    opt = _pipe_opt()
    runs, launches = {}, None
    for run, policy in enumerate(REMAT_POLICIES
                                 + ("dots",) * REMAT_REPEATS):
        cfg = base.replace(remat=policy is not None,
                           remat_policy=policy or "nothing")
        state = TrainState(tree_map(torch.clone, params),
                           opt.init(params),
                           torch.zeros((), dtype=torch.int32, device="cuda"))
        step = make_train_step(cfg, opt)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        again = run - len(REMAT_POLICIES) + 2
        runs[str(policy) if again < 2 else f"dots {again}"] = {
            "loss": loss, "grad_norm": gnorm, "step_s": seconds,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: launches[k] for k in
                         ("rmsnorm", "fused_ff", "flash_attention")}}
        want = _expected_launches(**remat_sites(cfg, policy))
        if launches != want:
            fail(f"remat {policy}: launches {dict(launches)}, expected "
                 f"{want}")
        del state, step, m
    del params, batch
    torch.cuda.empty_cache()
    dots, nothing, off = runs["dots"], runs["nothing"], runs["None"]
    rel = abs(dots["grad_norm"] - nothing["grad_norm"]) / nothing["grad_norm"]
    repeats = [runs[f"dots {i}"] for i in range(2, REMAT_REPEATS + 2)]
    again = max(abs(r["grad_norm"] - dots["grad_norm"])
                for r in repeats) / dots["grad_norm"]
    print(f"  remat policies ({base.name}, {DOTS_LAYERS} layers, {base.dtype}, "
          f"{BATCH} x {SEQ}) " + json.dumps(dict(
              runs, grad_norm_rel=rel, grad_norm_repeat_rel=again)),
          flush=True)
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in runs.values()):
        fail("a remat policy's loss or grad-norm is not finite")
    if dots["loss"] != nothing["loss"] or not rel <= 1e-6:
        fail("remat_policy 'dots' computes another step than 'nothing' "
             "(loss equal, grad-norm within 1e-6 relative)")
    if any(r["loss"] != dots["loss"] for r in repeats) or not again <= 1e-7:
        fail(f"one remat policy's grad-norm spreads by {again:.3g} relative "
             f"from run to run, over a tenth of the policies' 1e-6 bound")
    peaks = [r["max_memory_allocated_gb"] for r in (nothing, dots, off)]
    if not peaks[0] < peaks[1] < peaks[2]:
        fail(f"peak memory not ordered 'nothing' < 'dots' < no remat: "
             f"{peaks} GB")
    return launches


def profile_train_step(trainer, out_dir: str):
    """torch.profiler over one more train step: device busy share and time
    by kernel, written to ``out_dir``/profile_train_step_ARCH.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step = trainer.tcfg.steps
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in trainer.data.batch_at(step).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, metrics = trainer.train_step(trainer.state, batch)
        float(metrics["loss"])
        wall = time.perf_counter() - t0
    lines, busy_us = _kernel_breakdown(prof)
    _write_profile(out_dir, f"profile_train_step_{trainer.cfg.name}.txt",
                   lines, prof)
    print(f"  profile: one train step in {wall * 1e3:.1f} ms wall (profiler "
          f"on), device busy {busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.1%}"
          f" of wall; kernel time by name:", flush=True)
    print("\n".join("    " + line for line in lines[:25]), flush=True)


# ---------------------------------------------------------------------------
# phase 5b: the pipeline train step — ranks on the one card
# ---------------------------------------------------------------------------

# stablelm-3b at full width cut to PIPE_LAYERS (each pipe stage a
# contiguous block), global batch BATCH x SEQ in PIPE_MICRO microbatches,
# on PIPE_WORLD ranks that share the card over gloo (NCCL refuses two
# ranks on one device), every collective staged through the host.  The
# depths (8 and 4 layers until phase 5c came) are halved to keep the
# script inside its time limit; a stage still holds whole layers.
PIPE_ARCH, PIPE_WORLD, PIPE_LAYERS, PIPE_MICRO = "stablelm-3b", 4, 4, 4
# (a) parity, f32, PIPE_PARITY_LAYERS, PIPE_PARITY_STEPS steps from the
# same seeded parameters and batches as the mesh-less step on the card:
# {mesh: (make_host_mesh keywords, {run: make_sharded_train_step
# keywords})}
PIPE_PARITY_LAYERS, PIPE_PARITY_STEPS = 2, 2
PIPE_PARITY = {
    "pipe2_model2": (dict(pipe=2, model=2),
                     {"gpipe": dict(schedule="gpipe"),
                      "1f1b": dict(schedule="1f1b")}),
    "pod2_pipe2": (dict(pipe=2, pods=2),
                   {"compressed": {},
                    "monolithic": dict(overlap_pod_reduce=False),
                    "f32": dict(compress_pod=False)})}
# (b) timing: bf16, PIPE_LAYERS, 3 Trainer steps on (pipe=2, model=2)
PIPE_TIMING_MESH = dict(pipe=2, model=2)
# the ranks are killed, and the script fails, after this many seconds
PIPE_DEADLINE_S = 900


def pipe_sites(cfg, n_stages, n_micro, schedule):
    """Kernel launches a rank makes in one pipeline train step of ``cfg``:
    every row of the schedule's forward stream runs the stage's
    ``n_layers / n_stages`` layers (``train_sites`` of a model that deep,
    forward and remat's recompute), idle rows included (the SPMD form),
    and the head's final norm runs once."""
    from repro_torch.dist.pipeline import get_schedule
    rows = len(get_schedule(schedule).forward_rows(n_micro, n_stages))
    per = train_sites(cfg.replace(n_layers=cfg.n_layers // n_stages))
    return {name: rows * (n - 1) + 1 if name == "rmsnorm" else rows * n
            for name, n in per.items()}


def _pipe_params(cfg, device):
    """The seeded global parameters of the parity runs, drawn on
    ``device`` (every rank draws the same ones, keeps its blocks and
    frees the draw), every stacked layer matrix at its own fan-in
    (``per_layer_fan_in``): as drawn, at 4 layers the init's stacked
    fan-in gives the layer weights variance 1/4 and the step's f32
    rounding moves its grad-norm by 8.3e-4 between two microbatch splits
    of the mesh-less step alone (ROADMAP §C)."""
    import torch
    from repro_torch.models import lm
    return per_layer_fan_in(lm.init_model(
        cfg, torch.Generator(device).manual_seed(0)))


def _pipe_batch(cfg, i):
    import torch
    from repro_torch.data.pipeline import make_data
    return {k: torch.from_numpy(v).to("cuda")
            for k, v in make_data(cfg, SEQ, BATCH).batch_at(i).items()}


def _pipe_opt():
    from repro_torch import optim
    return optim.adamw(optim.constant_schedule(1e-3), weight_decay=0.1,
                       max_grad_norm=1.0)


def pipe_rank(rank, out_dir):
    """One rank of phase 5b: (a) the parity runs in f32, deterministic,
    then (b) the timed bf16 ``Trainer``; writes rank<r>.json."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.step import (TrainState, init_ef_state,
                                        make_sharded_train_step,
                                        sharded_state_specs, wants_ef)
    from repro_torch.train.loop import pipeline_microbatch_clamp
    from repro_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "parity": {}}
    cfg = get_config(PIPE_ARCH).replace(n_layers=PIPE_PARITY_LAYERS,
                                        dtype="float32",
                                        pipeline_microbatches=PIPE_MICRO)
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    for name, (mesh_kw, runs) in PIPE_PARITY.items():
        mesh = make_host_mesh(device="cuda", **mesh_kw)
        out["mesh_" + name] = repr(mesh)
        n_micro, _ = pipeline_microbatch_clamp(PIPE_MICRO, BATCH, mesh)
        for label, kw in runs.items():
            ef = kw.get("compress_pod", True) and wants_ef(cfg, mesh)
            specs = sharded_state_specs(cfg, mesh, ef)
            params = shd.shard_tree(_pipe_params(cfg, "cuda"), specs.params,
                                    mesh)
            torch.cuda.empty_cache()
            opt = _pipe_opt()
            state = TrainState(params, opt.init(params),
                               torch.zeros((), dtype=torch.int32,
                                           device="cuda"),
                               init_ef_state(params, mesh, lm.model_spec(cfg))
                               if ef else None)
            step = make_sharded_train_step(cfg, opt, mesh,
                                           num_microbatches=n_micro, **kw)
            metrics = []
            for i in range(PIPE_PARITY_STEPS):
                state, m = step(state, _pipe_batch(cfg, i))
                metrics.append({k: float(v) for k, v in m.items()})
            out["parity"][f"{name}/{label}"] = {
                "metrics": metrics, "n_micro": n_micro,
                "ef_l1": (None if state.ef is None else sum(
                    float(e.abs().sum()) for e in tree_leaves(state.ef))),
                "param_sum": sum(float(p.double().sum())
                                 for p in tree_leaves(state.params))}
            del state, params, step
            torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    out["parity_s"] = time.perf_counter() - t0

    cfg = get_config(PIPE_ARCH).replace(n_layers=PIPE_LAYERS,
                                        pipeline_microbatches=PIPE_MICRO)
    mesh = make_host_mesh(device="cuda", **PIPE_TIMING_MESH)
    trainer = Trainer(cfg, TrainConfig(steps=TRAIN_STEPS, seq_len=SEQ,
                                       global_batch=BATCH), mesh=mesh)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    log = trainer.run()
    torch.cuda.synchronize()
    out["timing"] = {
        "mesh": repr(mesh), "wall_s": time.perf_counter() - t0,
        "step_s": [r["seconds"] for r in log],
        "loss": [r["loss"] for r in log],
        "grad_norm": [r["grad_norm"] for r in log],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": dict(_read_launches()),
        "tilings": _read_launches().tilings,
        "local_params": sum(p.numel() for p in
                            tree_leaves(trainer.state.params))}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _rel(a, b):
    return abs(a - b) / abs(b)


def pipeline_phase():
    """Phase 5b: the pipeline train step of stablelm-3b at full width on
    ``PIPE_WORLD`` ranks spawned on the one card (gloo, host-staged).

    (a) Parity, f32, ``PIPE_PARITY_LAYERS`` layers, deterministic
    algorithms (``torch.use_deterministic_algorithms``, cuBLAS workspace
    ``:4096:8``), ``PIPE_PARITY_STEPS`` steps from the seeded parameters
    and batches of the mesh-less ``make_train_step`` run here first:
    (pipe=2, model=2) under gpipe and 1f1b, (pod=2, pipe=2) compressed
    (overlapped and monolithic) and in f32.  Held (the reference test's
    bounds): each step's loss within 1e-4 relative and grad-norm within
    1e-3 relative of the mesh-less step's, for every run whose gradients
    are not compressed (a compressed run: step 0, before any compressed
    update, and its last loss within 2e-2 of the f32 run's); 1f1b equal
    to gpipe and the overlapped reduction equal to the monolithic one,
    exactly; the error-feedback residual non-zero.

    (b) Timing, bf16 (the published type), ``PIPE_LAYERS`` layers,
    ``TRAIN_STEPS`` ``Trainer`` steps on (pipe=2, model=2): seconds a
    step, each rank's peak memory, the transport, and each rank's
    launches of K1, K2 and K6, held to ``pipe_sites`` a step with K2's
    and K6's tilings those ``select_tiling`` names at the shard shapes
    (a d_ff / 2 column shard; n_heads / 2 heads).  Returns the launches
    summed over the ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import fused_ff as ff_mod
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.train import TrainState, make_train_step

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    cfg = get_config(PIPE_ARCH).replace(n_layers=PIPE_PARITY_LAYERS,
                                        dtype="float32")
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    params = _pipe_params(cfg, "cuda")
    opt = _pipe_opt()
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    plain = []
    step = make_train_step(cfg, opt)
    for i in range(PIPE_PARITY_STEPS):
        state, m = step(state, _pipe_batch(cfg, i))
        plain.append({k: float(v) for k, v in m.items()})
    # a witness of the function's own f32 sensitivity, printed, not held:
    # the mesh-less step with the pipeline's microbatch split
    params = _pipe_params(cfg, "cuda")
    opt = _pipe_opt()
    _, m = make_train_step(cfg, opt, num_microbatches=PIPE_MICRO)(
        TrainState(params, opt.init(params),
                   torch.zeros((), dtype=torch.int32, device="cuda")),
        _pipe_batch(cfg, 0))
    split = {k: float(v) for k, v in m.items()}
    torch.use_deterministic_algorithms(False)
    del state, params, step, opt, m
    torch.cuda.empty_cache()
    print(f"  mesh-less step on the card, f32, {cfg.n_layers} layers: "
          f"{plain} in {time.perf_counter() - t0:.1f} s; with "
          f"{PIPE_MICRO} microbatches, step 0: loss {split['loss']!r} "
          f"grad_norm {split['grad_norm']!r} (relative to one batch: "
          f"{_rel(split['loss'], plain[0]['loss']):.3e}, "
          f"{_rel(split['grad_norm'], plain[0]['grad_norm']):.3e})",
          flush=True)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_pipe_",
                               dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        run_ranks(pipe_rank, PIPE_WORLD, out_dir,
                  init_method=f"file://{out_dir}/pg", device="cuda",
                  timeout_s=PIPE_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        outs = []
        for r in range(PIPE_WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    finally:
        shutil.rmtree(out_dir)
    print(f"  {PIPE_WORLD} ranks ran in {ranks_s:.1f} s (parity "
          f"{max(o['parity_s'] for o in outs):.1f} s)", flush=True)
    for name in PIPE_PARITY:
        print(f"  {name}: {outs[0]['mesh_' + name]}", flush=True)

    # (a) every rank sees the same replicated metrics; every line is
    # printed before the first failure is raised
    problems = []
    par = outs[0]["parity"]
    for o in outs[1:]:
        for key, run in o["parity"].items():
            if run["metrics"] != par[key]["metrics"]:
                problems.append(f"pipeline parity {key}: ranks disagree on "
                                f"the metrics")
    for key, run in par.items():
        rels = [{k: _rel(m[k], p[k]) for k in ("loss", "grad_norm")}
                for m, p in zip(run["metrics"], plain)]
        print(f"  {key} ({run['n_micro']} microbatches): {run['metrics']}; "
              f"relative to the mesh-less step {rels}; residual L1 "
              f"{run['ef_l1']}", flush=True)
        compressed = key.startswith("pod2_pipe2/") \
            and not key.endswith("/f32")
        held = rels[:1] if compressed else rels
        if not all(r["loss"] <= 1e-4 and r["grad_norm"] <= 1e-3
                   for r in held):
            problems.append(f"pipeline parity {key}: loss or grad-norm off "
                            f"the mesh-less step's (bounds 1e-4, 1e-3 "
                            f"relative)")
    pairs = (("pipe2_model2/1f1b", "pipe2_model2/gpipe"),
             ("pod2_pipe2/monolithic", "pod2_pipe2/compressed"))
    for a, b in pairs:
        same = (par[a]["metrics"] == par[b]["metrics"]
                and all(o["parity"][a]["param_sum"]
                        == o["parity"][b]["param_sum"] for o in outs))
        print(f"  {a} equal to {b}: {same}", flush=True)
        if not same:
            problems.append(f"pipeline parity: {a} differs from {b}")
    ef_l1 = sum(o["parity"]["pod2_pipe2/compressed"]["ef_l1"] for o in outs)
    lc = par["pod2_pipe2/compressed"]["metrics"][-1]["loss"]
    lf = par["pod2_pipe2/f32"]["metrics"][-1]["loss"]
    print(f"  residual L1 over the ranks {ef_l1:.6g}; compressed against "
          f"f32 loss {_rel(lc, lf):.3e} (bound 2e-2)", flush=True)
    if not (ef_l1 > 0 and _rel(lc, lf) < 2e-2):
        problems.append("pipeline parity: the compressed reduction left no "
                        "residual or strayed from the f32 one")

    # (b) timing and launches
    tcfg = get_config(PIPE_ARCH).replace(n_layers=PIPE_LAYERS)
    per_step = pipe_sites(tcfg, PIPE_TIMING_MESH["pipe"], PIPE_MICRO,
                          tcfg.pipeline_schedule)
    want = _expected_launches(**{k: TRAIN_STEPS * n
                                 for k, n in per_step.items()})
    mb = BATCH // PIPE_MICRO
    tiling = {
        "fused_ff": ff_mod.select_tiling(torch.bfloat16, (
            mb * SEQ, tcfg.d_model, tcfg.d_ff // PIPE_TIMING_MESH["model"])),
        "flash_attention": fa_mod.select_tiling(torch.bfloat16, (
            mb, tcfg.n_heads // PIPE_TIMING_MESH["model"], SEQ,
            tcfg.head_dim), dv=tcfg.head_dim)}
    total = _Launches((name, 0) for name in KERNELS)
    total.tilings = {}
    for o in outs:
        t = o["timing"]
        print(f"  rank {o['rank']}: {t['mesh']}: steps {t['step_s']} s, "
              f"peak {t['max_memory_allocated_gb']:.2f} GB, "
              f"{t['local_params'] / 1e6:.1f} M parameters; launches "
              f"{t['launches']} by tiling {t['tilings']}", flush=True)
        if t["launches"] != want:
            problems.append(f"rank {o['rank']}: pipeline launches "
                            f"{t['launches']}, expected {want} ({per_step} "
                            f"a step)")
        for name, inst in tiling.items():
            if set(t["tilings"][name]) != {inst}:
                problems.append(f"rank {o['rank']}: {name} ran "
                                f"{t['tilings'][name]}, not {inst}")
        for name, n in t["launches"].items():
            total[name] += n
        for name, by in t["tilings"].items():
            for inst, n in by.items():
                total.tilings.setdefault(name, {})
                total.tilings[name][inst] = total.tilings[name].get(inst,
                                                                    0) + n
    timing = outs[0]["timing"]
    if not all(math.isfinite(x) for o in outs
               for x in o["timing"]["loss"] + o["timing"]["grad_norm"]):
        problems.append("a pipeline training loss or grad-norm is not "
                        "finite")
    steady = max(statistics.median(o["timing"]["step_s"][1:]) for o in outs)
    stats = {"arch": PIPE_ARCH, "n_layers": PIPE_LAYERS,
             "mesh": PIPE_TIMING_MESH, "ranks": PIPE_WORLD,
             "microbatches": PIPE_MICRO, "transport": timing["mesh"],
             "step_s": [max(o["timing"]["step_s"][i] for o in outs)
                        for i in range(TRAIN_STEPS)],
             "steady_step_s": steady, "tokens_per_s": BATCH * SEQ / steady,
             "loss": timing["loss"], "grad_norm": timing["grad_norm"],
             "peak_gb_by_rank": [o["timing"]["max_memory_allocated_gb"]
                                 for o in outs],
             "launches_per_rank_step": per_step, "tilings": tiling}
    print(f"  pipeline training main path ({PIPE_ARCH}) "
          + json.dumps(stats), flush=True)
    if problems:
        fail("; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# phase 5c: the GSPMD train step
# ---------------------------------------------------------------------------

GSPMD_WORLD = 4
# (a) dense parity, f32, GSPMD_PARITY_LAYERS layers of PIPE_ARCH, the
# steps and batches of 5b(a): {label: (make_host_mesh keywords, config
# overrides)}
GSPMD_PARITY_LAYERS = 4
GSPMD_PARITY = {"data2_model2": (dict(model=2), {}),
                "model4_sp": (dict(model=4), dict(seq_parallel=True))}
# (b) the moe layer and step, f32, MOE_ARCH at this many layers on this
# mesh; apply_moe_ep_replicated at a sequence the model axis does not
# divide
GSPMD_MOE_LAYERS, GSPMD_MOE_MESH = 2, dict(model=4)
GSPMD_RAGGED_SEQ = SEQ - 2
# (c) timing, bf16, TRAIN_STEPS Trainer steps: {arch: (layers, mesh)}
# (8 and 4 layers until the whole script took 1239.1 s with phase 5d)
GSPMD_TIMING = {PIPE_ARCH: (4, dict(model=2)), MOE_ARCH: (2, dict(model=4))}
# the ranks are killed, and the script fails, after this many seconds
GSPMD_DEADLINE_S = 900


def gspmd_sites(cfg, n_micro=1):
    """Kernel launches a rank makes in one GSPMD train step of ``cfg``:
    every rank runs every layer on its batch block (its ``model`` shard
    of the heads and columns), so each microbatch makes
    ``train_sites``'s launches."""
    return {name: n_micro * n for name, n in train_sites(cfg).items()}


def gspmd_shapes(cfg, mesh_kw):
    """The operand shapes a rank's K1, K2 and K6 calls take in a GSPMD
    step of ``cfg`` on a mesh of ``mesh_kw`` (no ``seq_parallel``): the
    batch block's rows, the ``model`` shard of the MLP's columns and of
    the heads."""
    from repro_torch.launch.mesh import host_mesh_shape
    shape, names = host_mesh_shape(GSPMD_WORLD, **mesh_kw)
    sizes = dict(zip(names, shape))
    m = sizes["model"]
    b = BATCH // (sizes.get("pod", 1) * sizes["data"])
    h = cfg.n_heads // m
    norms = {(b * SEQ, cfg.d_model)}
    if cfg.qk_norm:
        norms.add((b * SEQ * h, cfg.head_dim))
    out = {"rmsnorm": norms,
           "flash_attention": {(b, h, SEQ, cfg.head_dim)}}
    if cfg.family == "dense":
        out["fused_ff"] = {(b * SEQ, cfg.d_model, cfg.d_ff // m)}
    return out


def _watch_shapes():
    """Record the operand shapes of every ``ops.rmsnorm``,
    ``ops.fused_ff`` and ``ops.flash_attention`` call from now on: {name:
    set of shapes} (x's for K1, (rows, d, columns) for K2, q's for
    K6)."""
    from repro_torch.kernels import ops
    seen = {"rmsnorm": set(), "fused_ff": set(), "flash_attention": set()}

    def watch(name, fn, shape_of):
        def call(*a, **k):
            seen[name].add(shape_of(*a))
            return fn(*a, **k)
        setattr(ops, name, call)

    watch("rmsnorm", ops.rmsnorm, lambda x, *_: tuple(x.shape))
    watch("fused_ff", ops.fused_ff,
          lambda x, wg, *_: tuple(x.shape) + (wg.shape[1],))
    watch("flash_attention", ops.flash_attention,
          lambda q, *_: tuple(q.shape))
    return seen


def _moe_layer(cfg, device):
    """Layer 0's MoE parameters of the seeded f32 draw of ``cfg``
    (``_pipe_params``), and a seeded batch of its inputs."""
    import torch
    params = _pipe_params(cfg, device)
    p = {k: {n: w[0] for n, w in v.items()} if isinstance(v, dict)
         else v[0] for k, v in params["layers"]["moe"].items()}
    gen = torch.Generator(device).manual_seed(1)
    x = torch.randn(BATCH, SEQ, cfg.d_model, device=device, generator=gen)
    return p, x


def gspmd_rank(rank, out_dir):
    """One rank of phase 5c: (a) dense parity and (b) the moe layer and
    step, in f32 with deterministic algorithms, then (c) the timed bf16
    ``Trainer``s; writes rank<r>.json."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.nn import moe
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.step import (TrainState, make_train_step,
                                        sharded_state_specs)
    from repro_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "parity": {}}
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()

    def steps(cfg, mesh):
        specs = sharded_state_specs(cfg, mesh)
        params = shd.shard_tree(_pipe_params(cfg, "cuda"), specs.params,
                                mesh)
        torch.cuda.empty_cache()
        opt = _pipe_opt()
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device="cuda"))
        step = make_train_step(cfg, opt, mesh=mesh)
        metrics = []
        for i in range(PIPE_PARITY_STEPS):
            state, m = step(state, _pipe_batch(cfg, i))
            metrics.append({k: float(v) for k, v in m.items()})
        del state, params, step
        torch.cuda.empty_cache()
        return metrics

    for label, (mesh_kw, over) in GSPMD_PARITY.items():
        cfg = get_config(PIPE_ARCH).replace(n_layers=GSPMD_PARITY_LAYERS,
                                            dtype="float32", **over)
        mesh = make_host_mesh(device="cuda", **mesh_kw)
        out["mesh_" + label] = repr(mesh)
        out["parity"][label] = steps(cfg, mesh)

    # (b) the moe layer: its expert-parallel output and the slots of this
    # rank's block against the one-process version, the replicated
    # variant at a ragged sequence against the dense layer
    cfg = get_config(MOE_ARCH).replace(n_layers=GSPMD_MOE_LAYERS,
                                       dtype="float32")
    mcfg = lm.moe_config(cfg)
    mesh = make_host_mesh(device="cuda", **GSPMD_MOE_MESH)
    out["mesh_moe"] = repr(mesh)
    ax = mesh.axis("model")
    p, x = _moe_layer(cfg, "cuda")
    mine = {"router": p["router"],
            "experts": {k: shd.shard_leaf(v, shd.P("model"), mesh)
                        .contiguous() for k, v in p["experts"].items()}}
    with torch.no_grad():
        got = moe.apply_moe_ep(mine, x, mcfg, mesh)
        want, slots = moe.apply_moe_ep_plain(p, x, mcfg, 1, ax.size)
        size = SEQ // ax.size
        block = x[:, ax.index * size:(ax.index + 1) * size]
        my_slots = moe.dispatch(mine, block, mcfg)[1]
        xr = x[:, :GSPMD_RAGGED_SEQ].contiguous()
        rep = moe.apply_moe_ep_replicated(mine, xr, mcfg, mesh)
        dense = (moe.apply_moe_dense(p, xr, mcfg) if rank == 0 else rep)
    scale = float(want.abs().max())
    out["moe_layer"] = {
        "ep_err": float((got - want).abs().max()), "scale": scale,
        "slots_equal": bool(torch.equal(my_slots, slots[ax.index])),
        "dropped": int((slots[ax.index] == mcfg.n_experts
                        * moe.capacity(mcfg, BATCH * size)).sum()),
        "replicated_err": float((rep - dense).abs().max()),
        "replicated_scale": float(dense.abs().max())}
    del p, x, mine, got, want, rep, dense, xr
    torch.cuda.empty_cache()
    out["parity"]["moe"] = steps(cfg, mesh)
    torch.use_deterministic_algorithms(False)
    out["parity_s"] = time.perf_counter() - t0

    # (c) timing, bf16: launches, tilings, operand shapes and the head's
    # columns per rank
    seen = _watch_shapes()
    head = lm.head_forward

    def watched_head(*a, **k):
        logits = head(*a, **k)
        seen["head_columns"].add(logits.shape[-1])
        return logits

    seen["head_columns"] = set()
    lm.head_forward = watched_head
    out["timing"] = {}
    for arch, (layers, mesh_kw) in GSPMD_TIMING.items():
        cfg = get_config(arch).replace(n_layers=layers)
        mesh = make_host_mesh(device="cuda", **mesh_kw)
        trainer = Trainer(cfg, TrainConfig(steps=TRAIN_STEPS, seq_len=SEQ,
                                           global_batch=BATCH), mesh=mesh)
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        for v in seen.values():
            v.clear()
        t0 = time.perf_counter()
        log = trainer.run()
        torch.cuda.synchronize()
        out["timing"][arch] = {
            "mesh": repr(mesh), "wall_s": time.perf_counter() - t0,
            "step_s": [r["seconds"] for r in log],
            "loss": [r["loss"] for r in log],
            "grad_norm": [r["grad_norm"] for r in log],
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": dict(_read_launches()),
            "tilings": _read_launches().tilings,
            "shapes": {k: sorted(v) for k, v in seen.items()
                       if k != "head_columns"},
            "head_columns": sorted(seen["head_columns"]),
            "local_params": sum(p.numel() for p in
                                tree_leaves(trainer.state.params))}
        del trainer
        torch.cuda.empty_cache()
    lm.head_forward = head
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _plain_ep_step(cfg, ep):
    """``PIPE_PARITY_STEPS`` mesh-less steps of ``cfg`` on the card whose
    MoE layers compute the expert-parallel function of a (1, ``ep``) mesh
    in one process (``apply_moe_ep_plain``)."""
    import torch
    from repro_torch import nn
    from repro_torch.nn import moe
    from repro_torch.train import TrainState, make_train_step

    def plain(p, x, mcfg, mesh=None, axis="model", seq_sharded=False):
        return moe.apply_moe_ep_plain(p, x, mcfg, 1, ep)[0]

    params = _pipe_params(cfg, "cuda")
    opt = _pipe_opt()
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    step = make_train_step(cfg, opt)
    before, nn.apply_moe = nn.apply_moe, plain
    try:
        metrics = []
        for i in range(PIPE_PARITY_STEPS):
            state, m = step(state, _pipe_batch(cfg, i))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        nn.apply_moe = before
    return metrics


def gspmd_phase():
    """Phase 5c: the GSPMD train step (``make_train_step(mesh=...)``) on
    ``GSPMD_WORLD`` ranks spawned on the one card (gloo, host-staged).

    (a) Dense parity, f32, ``GSPMD_PARITY_LAYERS`` layers of stablelm-3b
    at full width on the draw at each layer's own fan-in, deterministic
    algorithms, ``PIPE_PARITY_STEPS`` steps on (data=2, model=2) and on
    (model=4) with ``seq_parallel``, against the mesh-less step on the
    card: each step's loss within 1e-4 and grad-norm within 1e-3 relative
    (5b's bounds, the reference test's).

    (b) The moe family, f32, olmoe-1b-7b at ``GSPMD_MOE_LAYERS`` layers on
    (model=4): ``apply_moe_ep`` on each rank against the one-process
    ``apply_moe_ep_plain`` on the card (within 1e-5 of its scale), the
    slots each rank packs equal to the plain version's for its block;
    ``apply_moe_ep_replicated`` at a sequence of ``GSPMD_RAGGED_SEQ`` (4
    does not divide it) against the dense layer (within 1e-5 of its
    scale); and the GSPMD steps against mesh-less steps whose MoE layers
    compute the plain version (the bounds of (a)).

    (c) Timing, bf16 (the published type), ``TRAIN_STEPS`` ``Trainer``
    steps of each of ``GSPMD_TIMING``: seconds a step, each rank's peak
    memory, and each rank's launches of K1, K2 and K6, held to
    ``gspmd_sites`` a step, on the tilings ``select_tiling`` names at the
    shard shapes, and the operand shapes the calls took held to
    ``gspmd_shapes`` (the batch block, d_ff / model columns, n_heads /
    model heads: no rank computes a full-width replica of them).
    Returns the launches summed over the ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import fused_ff as ff_mod
    from repro_torch.launch.mesh import host_mesh_shape, run_ranks
    from repro_torch.train import TrainState, make_train_step

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    cfg = get_config(PIPE_ARCH).replace(n_layers=GSPMD_PARITY_LAYERS,
                                        dtype="float32")
    params = _pipe_params(cfg, "cuda")
    opt = _pipe_opt()
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    step = make_train_step(cfg, opt)
    plain = []
    for i in range(PIPE_PARITY_STEPS):
        state, m = step(state, _pipe_batch(cfg, i))
        plain.append({k: float(v) for k, v in m.items()})
    del state, params, step, opt, m
    torch.cuda.empty_cache()
    moe_cfg = get_config(MOE_ARCH).replace(n_layers=GSPMD_MOE_LAYERS,
                                           dtype="float32")
    plain_moe = _plain_ep_step(moe_cfg, GSPMD_MOE_MESH["model"])
    torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    print(f"  mesh-less steps on the card, f32: {PIPE_ARCH} "
          f"{cfg.n_layers} layers {plain}; {MOE_ARCH} "
          f"{moe_cfg.n_layers} layers with the one-process EP of (1, "
          f"{GSPMD_MOE_MESH['model']}) {plain_moe}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_gspmd_",
                               dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        run_ranks(gspmd_rank, GSPMD_WORLD, out_dir,
                  init_method=f"file://{out_dir}/pg", device="cuda",
                  timeout_s=GSPMD_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        outs = []
        for r in range(GSPMD_WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    finally:
        shutil.rmtree(out_dir)
    print(f"  {GSPMD_WORLD} ranks ran in {ranks_s:.1f} s (parity "
          f"{max(o['parity_s'] for o in outs):.1f} s)", flush=True)

    # (a), (b): every rank sees the same metrics; every line is printed
    # before the first failure is raised
    problems = []
    par = outs[0]["parity"]
    for o in outs[1:]:
        for key, run in o["parity"].items():
            if run != par[key]:
                problems.append(f"GSPMD parity {key}: ranks disagree on "
                                f"the metrics")
    for key, run in par.items():
        mesh = outs[0]["mesh_" + ("moe" if key == "moe" else key)]
        base = plain_moe if key == "moe" else plain
        rels = [{k: _rel(m[k], p[k]) for k in ("loss", "grad_norm")}
                for m, p in zip(run, base)]
        print(f"  {key} {mesh}: {run}; relative to the mesh-less step "
              f"{rels}", flush=True)
        if not all(r["loss"] <= 1e-4 and r["grad_norm"] <= 1e-3
                   for r in rels):
            problems.append(f"GSPMD parity {key}: loss or grad-norm off "
                            f"the mesh-less step's (bounds 1e-4, 1e-3 "
                            f"relative)")
    for o in outs:
        ml = o["moe_layer"]
        print(f"  rank {o['rank']} moe layer: {ml}", flush=True)
        if not (ml["slots_equal"]
                and ml["ep_err"] <= 1e-5 * ml["scale"]
                and ml["replicated_err"] <= 1e-5 * ml["replicated_scale"]):
            problems.append(f"rank {o['rank']}: the expert-parallel layer "
                            f"disagrees with its one-process version or "
                            f"the dense layer")

    # (c) timing, launches, tilings and shapes
    total = _Launches((name, 0) for name in KERNELS)
    total.tilings = {}
    stats = {}
    for arch, (layers, mesh_kw) in GSPMD_TIMING.items():
        tcfg = get_config(arch).replace(n_layers=layers)
        per_step = gspmd_sites(tcfg)
        want = _expected_launches(**{k: TRAIN_STEPS * n
                                     for k, n in per_step.items()})
        shapes = gspmd_shapes(tcfg, mesh_kw)
        shape, names = host_mesh_shape(GSPMD_WORLD, **mesh_kw)
        b = BATCH // (GSPMD_WORLD // dict(zip(names, shape))["model"])
        m = mesh_kw["model"]
        tiling = {"flash_attention": fa_mod.select_tiling(
            torch.bfloat16, (b, tcfg.n_heads // m, SEQ, tcfg.head_dim),
            dv=tcfg.head_dim)}
        if tcfg.family == "dense":
            tiling["fused_ff"] = ff_mod.select_tiling(
                torch.bfloat16, (b * SEQ, tcfg.d_model, tcfg.d_ff // m))
        for o in outs:
            t = o["timing"][arch]
            print(f"  rank {o['rank']} {arch} ({layers} layers): "
                  f"{t['mesh']}: steps {t['step_s']} s, peak "
                  f"{t['max_memory_allocated_gb']:.2f} GB, "
                  f"{t['local_params'] / 1e6:.1f} M parameters, head "
                  f"columns {t['head_columns']}; launches "
                  f"{t['launches']} by tiling {t['tilings']}; operand "
                  f"shapes {t['shapes']}", flush=True)
            if t["launches"] != want:
                problems.append(f"rank {o['rank']} {arch}: GSPMD launches "
                                f"{t['launches']}, expected {want} "
                                f"({per_step} a step)")
            for name, inst in tiling.items():
                if set(t["tilings"][name]) != {inst}:
                    problems.append(f"rank {o['rank']} {arch}: {name} ran "
                                    f"{t['tilings'][name]}, not {inst}")
            for name, want_shapes in shapes.items():
                got = {tuple(s) for s in t["shapes"][name]}
                if got != want_shapes:
                    problems.append(f"rank {o['rank']} {arch}: {name} took "
                                    f"{sorted(got)}, not the shard shapes "
                                    f"{sorted(want_shapes)}")
            if t["head_columns"] != [tcfg.vocab // m]:
                problems.append(f"rank {o['rank']} {arch}: the head "
                                f"computed {t['head_columns']} columns, not "
                                f"its vocabulary block of {tcfg.vocab // m}")
            for name, n in t["launches"].items():
                total[name] += n
            for name, by in t["tilings"].items():
                for inst, n in by.items():
                    total.tilings.setdefault(name, {})
                    total.tilings[name][inst] = \
                        total.tilings[name].get(inst, 0) + n
            if not all(math.isfinite(x) for x in t["loss"] + t["grad_norm"]):
                problems.append(f"{arch}: a GSPMD training loss or "
                                f"grad-norm is not finite")
        timing = outs[0]["timing"][arch]
        steady = max(statistics.median(o["timing"][arch]["step_s"][1:])
                     for o in outs)
        stats[arch] = {
            "n_layers": layers, "mesh": mesh_kw, "ranks": GSPMD_WORLD,
            "transport": timing["mesh"],
            "step_s": [max(o["timing"][arch]["step_s"][i] for o in outs)
                       for i in range(TRAIN_STEPS)],
            "steady_step_s": steady, "tokens_per_s": BATCH * SEQ / steady,
            "loss": timing["loss"], "grad_norm": timing["grad_norm"],
            "peak_gb_by_rank": [o["timing"][arch]["max_memory_allocated_gb"]
                                for o in outs],
            "launches_per_rank_step": per_step, "tilings": tiling}
    print("  GSPMD training main path " + json.dumps(stats), flush=True)
    if problems:
        fail("; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# phase 5d: serving with a mesh — ranks on the one card
# ---------------------------------------------------------------------------

SERVE_MESH_WORLD = 4
# (a) parity, f32, full width at 2 layers (zamba2-2.7b: its one group of
# 6) on the draw at each layer's own fan-in, on each mesh: generate(mesh=)
# of each of SERVE_MESH_GENERATE over LANES rows of (prompt, new) tokens
# (on (data 2, model 2) 2 passes: each gathers every layer over ``data``,
# 3.2-3.7 s a pass for the moe models, measured on one H100), and
# gemma3-1b cut to 1 layer (local) on (model 4) over
# SERVE_MESH_WINDOW_NEW new ones, past its 512-position window (its ring
# buffer 128 positions a rank; at 2 layers 101 ms a pass); a
# paged engine of each of SERVE_MESH_ENGINE over SERVE_MESH_TRAFFIC's 4
# requests, submitted at once into a pool of 4 blocks of 4 positions (11
# passes, a spill and a resume: the same run on the host at reduced
# widths, the pool's accounting not depending on the widths)
SERVE_MESH_MESHES = {"data2_model2": (dict(model=2), 1, 2),
                     "model4": (dict(model=4), 4, 8)}
SERVE_MESH_GENERATE = ("qwen1.5-4b", "gemma3-1b", MOE_ARCH, MLA_ARCH,
                       SSM_ARCH)
SERVE_MESH_WINDOW_NEW = 516
SERVE_MESH_ENGINE = ("qwen1.5-4b", HYBRID_ARCH)
SERVE_MESH_TRAFFIC = dict(qps=4.0, n_requests=4, n_tenants=2,
                          prompt_len=(2, 3), output_len=(3, 6), seed=0)
SERVE_MESH_POOL = dict(max_seq=8, block_size=4, kv_blocks=4)
# (b) timing, bf16: qwen1.5-4b at SERVE_MESH_TIMING_LAYERS on this mesh,
# phase 4's 16 requests submitted at once.  At phase 4's 20 layers a pass
# took 373.3 ms (42 host-staged collectives of 8-12 ms each, measured on
# one H100) and the phase 357 s, at 8 layers 113.8 ms and the whole
# script 1149.1 s, at 4 68.9-91.4 ms and the script 1109.2-1239.1 s, so
# the timed depth is cut to 2
SERVE_MESH_TIMING = dict(model=4)
SERVE_MESH_TIMING_LAYERS = 2
# the ranks are killed, and the script fails, after this many seconds
SERVE_MESH_DEADLINE_S = 600
# phase 4's serving figures by arch, printed beside 5d's
_SERVE_STATS = {}


def _mesh_parity_cfg(arch, n_layers=2):
    from repro_torch.configs import get_config
    return get_config(arch).replace(
        n_layers=6 if arch == HYBRID_ARCH else n_layers, dtype="float32")


class _on_pass:
    """Within it, every call of ``mod.name`` (a decode step the serving
    code looks up there) also calls ``fn(args, kwargs, result)``."""

    def __init__(self, mod, name, fn):
        self.mod, self.name, self.fn = mod, name, fn

    def __enter__(self):
        self.orig = orig = getattr(self.mod, self.name)

        def call(*a, **k):
            result = orig(*a, **k)
            self.fn(a, k, result)
            return result
        setattr(self.mod, self.name, call)

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def _held(card, host, exact):
    """(held quantity over the scale, f64 route) of ``_hold_to_host``
    for one pass: the card's logits against the host's (here the
    mesh-less run on the card) within 1e-5 of the scale, or where the
    host's own f32 error exceeds that, against ``exact``."""
    scale = host.abs().max().item()
    d = (card - host).abs().max().item()
    if exact is None:
        return d / scale, False
    h_err = (host.double() - exact).abs().max().item()
    c_err = (card.double() - exact).abs().max().item()
    route = h_err > 1e-5 * scale
    return (c_err - h_err if route else d) / scale, route


def _mesh_generate(arch, mesh, rank, n_prompt, new, n_layers=2):
    """``generate(mesh=)`` of ``arch`` (``_mesh_parity_cfg``) on ``mesh``;
    rank 0 steps the mesh-less decode on the card in lockstep, on the
    same tokens, and holds each pass's logits (gathered over the batch)
    to its (deepseek-v2-lite-16b: with its f64 evaluation beside), and
    each argmax after the prompt to its, so the mesh-less greedy stream
    is the mesh's."""
    import numpy as np
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.serve import generate
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.decode import decode_step, init_caches

    cfg = _mesh_parity_cfg(arch, n_layers)
    params = _pipe_params(cfg, "cuda")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LANES, n_prompt)))
    total = n_prompt + new
    bspec = shd.P(shd.batch_spec(mesh, LANES)[0], None)
    st = {"worst": 0.0, "f64": False, "agree": True, "passes": 0}
    if rank == 0:
        st["caches"] = init_caches(cfg, LANES, total, "cuda")
        if arch == MLA_ARCH:
            cfg64 = cfg.replace(dtype="float64")
            p64 = _tree_to(params, "cuda", torch.float64)
            st["c64"] = init_caches(cfg64, LANES, total, "cuda")

    def check(args, kw, result):
        logits = shd.gather_leaf(result[0], bspec, mesh)
        tok = shd.gather_leaf(args[2], bspec, mesh)
        pos = args[3]
        st["passes"] += 1
        if rank != 0:
            return
        host, st["caches"] = decode_step(params, st["caches"], tok, pos, cfg)
        exact = None
        if arch == MLA_ARCH:             # f64: the plain versions
            with ops.forced("ref"):
                exact, st["c64"] = decode_step(p64, st["c64"], tok, pos,
                                               cfg64)
        held, route = _held(logits, host, exact)
        st["worst"] = max(st["worst"], held)
        st["f64"] |= route
        if pos + 1 >= n_prompt:
            st["agree"] &= bool(torch.equal(logits.argmax(-1),
                                            host.argmax(-1)))

    t0 = time.perf_counter()
    with torch.no_grad(), _on_pass(engine_mod, "decode_step", check):
        tokens = generate(params, cfg, prompt, new, mesh=mesh)
    out = {k: st[k] for k in ("worst", "f64", "agree", "passes")}
    out.update(seconds=time.perf_counter() - t0,
               tokens=tokens[:, n_prompt:].tolist())
    del params, st
    torch.cuda.empty_cache()
    return out


def _mesh_engine(arch, mesh, rank):
    """A paged ``ServeEngine(mesh=)`` run of ``arch``
    (``_mesh_parity_cfg``) over ``SERVE_MESH_TRAFFIC`` into
    ``SERVE_MESH_POOL``; rank 0 first runs the mesh-less engine on the
    card, keeping each pass's logits, and holds the mesh run's passes to
    them, its streams and counters to the mesh-less run's."""
    import torch
    from repro_torch.serve import (ServeEngine, Tenant, TrafficConfig,
                                   poisson_trace)
    from repro_torch.serve import engine as engine_mod

    cfg = _mesh_parity_cfg(arch)
    params = _pipe_params(cfg, "cuda")
    trace = poisson_trace(TrafficConfig(vocab=cfg.vocab,
                                        **SERVE_MESH_TRAFFIC), ["t0", "t1"])
    names = ("passes", "preempt_spills", "resume_uploads", "stalls")

    def run(on_mesh, fn):
        engine = ServeEngine(cfg, params=params, max_batch=LANES,
                             paged=True, tenants=[Tenant("t0"),
                                                  Tenant("t1")],
                             mesh=mesh if on_mesh else None, device="cuda",
                             **SERVE_MESH_POOL)
        reqs = [engine.submit(a.prompt, a.max_new_tokens, tenant=a.tenant)
                for a in trace]
        with torch.no_grad(), _on_pass(engine_mod, "paged_decode_step", fn):
            engine.run()
        return ([list(map(int, r.output)) for r in reqs],
                {k: engine.counters[k] for k in names},
                engine.kv_bytes_allocated())

    plain = []
    if rank == 0:
        ml_streams, ml_counters, _ = run(
            False, lambda a, k, r: plain.append(r[0]))
    st = {"worst": 0.0, "i": 0}

    def check(args, kw, result):
        if rank == 0 and st["i"] < len(plain):
            st["worst"] = max(st["worst"],
                              _held(result[0], plain[st["i"]], None)[0])
        st["i"] += 1

    t0 = time.perf_counter()
    streams, counters, pool = run(True, check)
    out = {"worst": st["worst"], "passes": st["i"], "streams": streams,
           "counters": counters, "pool_bytes": pool,
           "seconds": time.perf_counter() - t0}
    if rank == 0:
        out.update(meshless_streams=ml_streams, meshless_counters=ml_counters,
                   meshless_passes=len(plain))
    del params, plain
    torch.cuda.empty_cache()
    return out


def _mesh_timing():
    """(b): the bf16 paged engine of qwen1.5-4b at
    ``SERVE_MESH_TIMING_LAYERS`` on ``SERVE_MESH_TIMING``, phase 4's
    requests submitted at once: its
    wall time, passes, peak memory, pool bytes, streams, launches,
    tilings and the operand shapes of every K1/K2/K6 call."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import (ServeEngine, Tenant, TrafficConfig,
                                   poisson_trace)

    cfg = get_config("qwen1.5-4b").replace(
        n_layers=SERVE_MESH_TIMING_LAYERS)
    mesh = make_host_mesh(device="cuda", **SERVE_MESH_TIMING)
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, max_batch=LANES, max_seq=256, block_size=16,
                         paged=True, tenants=[Tenant("t0"), Tenant("t1")],
                         rng_seed=0, mesh=mesh)
    torch.cuda.empty_cache()
    make_s = time.perf_counter() - t0
    engine.generate([1, 2, 3], 2, tenant="t0")      # warm-up
    engine.finished.clear()
    seen = _watch_shapes()
    trace = poisson_trace(TrafficConfig(vocab=cfg.vocab, **SERVE_TRAFFIC),
                          ["t0", "t1"])
    reqs = [engine.submit(a.prompt, a.max_new_tokens, tenant=a.tenant)
            for a in trace]
    passes0 = engine.counters["passes"]
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    for v in seen.values():
        v.clear()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    passes = engine.counters["passes"] - passes0
    tokens = sum(len(r.output) for r in reqs)
    return {"mesh": repr(mesh), "make_s": make_s, "wall_s": wall,
            "passes": passes, "ms_per_pass": wall * 1e3 / passes,
            "tokens": tokens, "tokens_per_s": tokens / wall,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "pool_bytes": engine.kv_bytes_allocated(),
            "peak_kv_bytes": engine.peak_kv_bytes(),
            "streams": [list(map(int, r.output)) for r in reqs],
            "launches": dict(launches), "tilings": launches.tilings,
            "shapes": {k: sorted(v) for k, v in seen.items()}}


def serve_mesh_rank(rank, out_dir):
    """One rank of phase 5d: (a) parity in f32, then (b) the timed bf16
    engine; writes rank<r>.json."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "generate": {}, "engine": {}}
    t0 = time.perf_counter()
    for label, (mesh_kw, n_prompt, n_new) in SERVE_MESH_MESHES.items():
        mesh = make_host_mesh(device="cuda", **mesh_kw)
        out["mesh_" + label] = repr(mesh)
        runs = [(arch, n_new, 2) for arch in SERVE_MESH_GENERATE]
        if label == "model4":
            runs.append(("gemma3-1b", SERVE_MESH_WINDOW_NEW, 1))
        for arch, new, layers in runs:
            key = f"{label} {arch} {layers}L {n_prompt}+{new}"
            out["generate"][key] = _mesh_generate(arch, mesh, rank,
                                                  n_prompt, new, layers)
            if rank == 0:
                print(f"    rank 0: generate {key} in "
                      f"{out['generate'][key]['seconds']:.1f} s", flush=True)
        for arch in SERVE_MESH_ENGINE:
            key = f"{label} {arch}"
            out["engine"][key] = _mesh_engine(arch, mesh, rank)
            if rank == 0:
                print(f"    rank 0: engine {key} in "
                      f"{out['engine'][key]['seconds']:.1f} s", flush=True)
    out["parity_s"] = time.perf_counter() - t0
    out["timing"] = _mesh_timing()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def serve_mesh_phase():
    """Phase 5d: serving with a mesh (``generate(mesh=)``,
    ``ServeEngine(mesh=)``) on ``SERVE_MESH_WORLD`` ranks spawned on the
    one card (gloo, host-staged), each rank holding its blocks of the
    parameters and of the caches.

    (a) Parity, f32, full width cut to 2 layers (zamba2-2.7b: 6), on the
    draw at each layer's own fan-in, on (data=2, model=2) and (model=4):
    ``generate(mesh=)`` of qwen1.5-4b, gemma3-1b (on (model 4) also at 1
    layer past its 512-position window), olmoe-1b-7b, deepseek-v2-lite-16b
    and mamba2-1.3b over 8 rows, and a paged ``ServeEngine(mesh=)`` run
    of qwen1.5-4b and zamba2-2.7b with a spill: each pass's logits within
    1e-5 of the logit scale of the mesh-less run on the card
    (deepseek-v2-lite-16b by ``_hold_to_host``'s f64 route where the
    mesh-less run's own f32 error exceeds that), the streams equal to
    the mesh-less ones and on every rank, the engine's counters equal.

    (b) Timing, bf16: qwen1.5-4b at full width and
    ``SERVE_MESH_TIMING_LAYERS`` on (model=4) through the paged engine,
    phase 4's 16 requests
    submitted at once: ms a pass of the slowest rank, tokens/s, each
    rank's peak memory and KV-pool bytes beside phase 4's mesh-less
    figures; held: each rank's pool a quarter of the mesh-less pool at the
    same geometry, the streams equal on every rank, each rank's K1/K2
    launches = passes x ``serve_sites``, K2 on ``gemv_m8``, and every
    K1/K2 call at the shard shapes (the 8 lanes' residual stream; 8 x
    2560 . 2560 x 1728).  No speed-up is claimed: the collectives are
    host-staged.  Returns the timing run's launches summed over the
    ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_ff as ff_mod
    from repro_torch.kernels import rmsnorm as rn_mod
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.serve.decode import init_paged_caches
    from repro_torch.serve.pool import KVBlockPool
    from repro_torch.utils.tree import tree_leaves

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_",
                               dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        run_ranks(serve_mesh_rank, SERVE_MESH_WORLD, out_dir,
                  init_method=f"file://{out_dir}/pg", device="cuda",
                  timeout_s=SERVE_MESH_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        outs = []
        for r in range(SERVE_MESH_WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    finally:
        shutil.rmtree(out_dir)
    print(f"  {SERVE_MESH_WORLD} ranks ran in {ranks_s:.1f} s (parity "
          f"{max(o['parity_s'] for o in outs):.1f} s); "
          f"{outs[0]['mesh_data2_model2']}; {outs[0]['mesh_model4']}",
          flush=True)

    # (a); every line is printed before the first failure is raised
    problems = []
    for key, g in outs[0]["generate"].items():
        print(f"  generate {key}: {g['passes']} passes in "
              f"{g['seconds']:.1f} s, worst held / scale {g['worst']:.3e}"
              f"{' (f64 route)' if g['f64'] else ''} (bound 1e-5), "
              f"argmax equal to the mesh-less run's: {g['agree']}",
              flush=True)
        if not (g["worst"] <= 1e-5 and g["agree"]):
            problems.append(f"generate {key}: off the mesh-less run")
        if any(o["generate"][key]["tokens"] != g["tokens"] for o in outs):
            problems.append(f"generate {key}: ranks disagree on the tokens")
    for key, e in outs[0]["engine"].items():
        print(f"  engine {key}: {e['passes']} passes in {e['seconds']:.1f} "
              f"s, worst |mesh - mesh-less| / scale {e['worst']:.3e} "
              f"(bound 1e-5), counters {e['counters']} (mesh-less "
              f"{e['meshless_counters']}), pool {e['pool_bytes']} B a rank",
              flush=True)
        if not (e["worst"] <= 1e-5 and e["streams"] == e["meshless_streams"]
                and e["counters"] == e["meshless_counters"]
                and e["passes"] == e["meshless_passes"]):
            problems.append(f"engine {key}: off the mesh-less engine")
        if any(o["engine"][key]["streams"] != e["streams"] for o in outs):
            problems.append(f"engine {key}: ranks disagree on the streams")
        if HYBRID_ARCH in key and not (e["counters"]["preempt_spills"] >= 1
                                       and e["counters"]["resume_uploads"]
                                       >= 1):
            problems.append(f"engine {key}: no spill and resume")

    # (b) timing, pool, launches, tilings and shapes
    cfg = get_config("qwen1.5-4b").replace(
        n_layers=SERVE_MESH_TIMING_LAYERS)
    m = SERVE_MESH_TIMING["model"]
    pool = KVBlockPool(LANES, 256, block_size=16)
    meshless_pool = sum(
        a.numel() * a.element_size() for a in tree_leaves(
            init_paged_caches(cfg, pool.num_blocks, 16, LANES, "meta")))
    per_pass = serve_sites(cfg)
    tiling = {"rmsnorm": rn_mod.select_tiling(torch.bfloat16,
                                              (LANES, cfg.d_model)),
              "fused_ff": ff_mod.select_tiling(
                  torch.bfloat16, (LANES, cfg.d_model, cfg.d_ff // m))}
    if tiling["fused_ff"] != "gemv_m8":
        problems.append(f"K2 at the shard selects {tiling['fused_ff']}, "
                        f"not gemv_m8")
    shapes = {"rmsnorm": {(LANES, cfg.d_model)},
              "fused_ff": {(LANES, cfg.d_model, cfg.d_ff // m)},
              "flash_attention": set()}
    total = _Launches((name, 0) for name in KERNELS)
    total.tilings = {}
    first = outs[0]["timing"]
    for o in outs:
        t = o["timing"]
        want = _expected_launches(**{k: t["passes"] * n
                                     for k, n in per_pass.items()})
        print(f"  rank {o['rank']} {t['mesh']}: {t['passes']} passes in "
              f"{t['wall_s']:.2f} s ({t['ms_per_pass']:.1f} ms a pass), "
              f"peak {t['max_memory_allocated_gb']:.2f} GB, pool "
              f"{t['pool_bytes']} B (mesh-less {meshless_pool} B); "
              f"launches {t['launches']} by tiling {t['tilings']}; "
              f"operand shapes {t['shapes']}", flush=True)
        if t["launches"] != want:
            problems.append(f"rank {o['rank']}: launches {t['launches']}, "
                            f"expected {want} ({per_pass} a pass)")
        for name, inst in tiling.items():
            if set(t["tilings"][name]) != {inst}:
                problems.append(f"rank {o['rank']}: {name} ran "
                                f"{t['tilings'][name]}, not {inst}")
        for name, want_shapes in shapes.items():
            got = {tuple(s) for s in t["shapes"][name]}
            if got != want_shapes:
                problems.append(f"rank {o['rank']}: {name} took "
                                f"{sorted(got)}, not the shard shapes "
                                f"{sorted(want_shapes)}")
        if t["pool_bytes"] * m != meshless_pool:
            problems.append(f"rank {o['rank']}: pool {t['pool_bytes']} B, "
                            f"not 1/{m} of {meshless_pool} B")
        if t["streams"] != first["streams"] or \
                t["passes"] != first["passes"]:
            problems.append(f"rank {o['rank']}: streams differ from rank "
                            f"0's")
        if not all(0 <= x < cfg.vocab for s in t["streams"] for x in s) \
                or len(t["streams"]) != SERVE_TRAFFIC["n_requests"]:
            problems.append(f"rank {o['rank']}: incomplete or out-of-vocab "
                            f"streams")
        for name, n in t["launches"].items():
            total[name] += n
        for name, by in t["tilings"].items():
            for inst, n in by.items():
                total.tilings.setdefault(name, {})
                total.tilings[name][inst] = \
                    total.tilings[name].get(inst, 0) + n
    slowest = max(outs, key=lambda o: o["timing"]["wall_s"])["timing"]
    stats = {"n_layers": cfg.n_layers, "mesh": SERVE_MESH_TIMING,
             "ranks": SERVE_MESH_WORLD, "transport": first["mesh"],
             "passes": slowest["passes"], "wall_s": slowest["wall_s"],
             "ms_per_pass": slowest["ms_per_pass"],
             "tokens_per_s": slowest["tokens"] / slowest["wall_s"],
             "peak_gb_by_rank": [o["timing"]["max_memory_allocated_gb"]
                                 for o in outs],
             "pool_bytes_by_rank": [o["timing"]["pool_bytes"] for o in outs],
             "meshless_pool_bytes": meshless_pool,
             "launches_per_rank_pass": per_pass, "tilings": tiling,
             "meshless_phase4": _SERVE_STATS.get("qwen1.5-4b")}
    print("  serving with a mesh " + json.dumps(stats), flush=True)
    if problems:
        fail("; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# phase 6: the optimizer main path — launch.optimize, deploy, the registry
# ---------------------------------------------------------------------------

def _start_cli(module, *args):
    """Start ``python -m MODULE ARGS``, as a user runs it, its output to
    files (a pipe nobody reads could fill and stall it); the process is
    killed if the script ends first, and its wall time is taken as it
    ends.  For :func:`_finish_cli`."""
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", module, *args]
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True, env=env)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    started = {"proc": proc, "cmd": cmd, "t0": t0, "out": out, "err": err}

    def ended():
        proc.wait()
        started["wall"] = time.perf_counter() - t0
    started["ended"] = threading.Thread(target=ended, daemon=True)
    started["ended"].start()
    return started


def _finish_cli(started, timeout=600):
    """Wait for a :func:`_start_cli` process: (the process, with its
    ``stdout`` and ``stderr`` read, its output lines, its wall time (s)
    from its start), the output printed."""
    proc = started["proc"]
    proc.wait(timeout=max(1.0, started["t0"] + timeout
                          - time.perf_counter()))
    started["ended"].join()
    for name in ("out", "err"):
        started[name].seek(0)
    proc.stdout, proc.stderr = started["out"].read(), started["err"].read()
    wall = started["wall"]
    print(f"  $ python {' '.join(started['cmd'][1:])}  ({wall:.1f} s, exit "
          f"{proc.returncode})\n"
          + "\n".join("    " + line for line in proc.stdout.splitlines()),
          flush=True)
    return proc, proc.stdout.splitlines(), wall


_RAN = {}   # (MODULE, *ARGS) -> a run started by _start_side_by_side


def _start_side_by_side(chains):
    """Start ``chains``, each a list of (MODULE, *ARGS), side by side:
    every chain's first run now, each later one (a ``--deploy`` reads what
    its search wrote) once :func:`_step_side_by_side` sees the run before
    it end.  Each run is kept for :func:`_run_cli`, which reads it
    instead of running it again."""
    side = []
    for run, *rest in chains:
        _RAN[run] = _start_cli(*run)
        side.append((_RAN[run], rest))
    return side


def _step_side_by_side(side):
    """Start the next run of each chain in ``side`` whose run has ended;
    returns at once."""
    for item in list(side):
        started, rest = item
        if started["proc"].poll() is None:
            continue
        side.remove(item)
        if rest:
            _RAN[rest[0]] = _start_cli(*rest[0])
            side.append((_RAN[rest[0]], rest[1:]))


def _end_side_by_side(side, timeout=900):
    """Wait for every run of ``side`` (:func:`_step_side_by_side`)."""
    deadline = time.perf_counter() + timeout
    while side:
        _step_side_by_side(side)
        if side and time.perf_counter() > deadline:
            fail(f"still running after {timeout} s: "
                 f"{[s['cmd'][2:] for s, _ in side]}")
        time.sleep(0.1)


def _run_cli(module, *args, timeout=600):
    """``python -m MODULE ARGS``, as a user runs it: (the process, its
    output lines, its wall time (s)), the output printed.  A run that
    :func:`_start_side_by_side` started is read, not run again."""
    started = _RAN.pop((module, *args), None)
    return _finish_cli(started or _start_cli(module, *args), timeout=timeout)


def _cli(module, *args, timeout=600, started=None):
    """``_run_cli`` (or ``_finish_cli`` of ``started``), failing unless
    the process exits 0: (its output lines, its wall time)."""
    proc, lines, wall = (_run_cli(module, *args, timeout=timeout)
                         if started is None else
                         _finish_cli(started, timeout=timeout))
    if proc.returncode != 0:
        fail(f"{module} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return lines, wall


def _optimize_cli(*args, timeout=600):
    """``python -m repro_torch.launch.optimize ARGS``: (its output lines,
    its wall time)."""
    return _cli("repro_torch.launch.optimize", *args, timeout=timeout)


def optimize_phase(cache_dir):
    """(a) The optimizer pipeline on the §5.7 pair, greedy, on the host
    (its measurement is the simulated TSASS machine, as in the reference),
    into the fresh cache ``cache_dir``, then the deployed kernels on the
    card through the registry."""
    from repro_torch.sched import OptimizationSession

    pair = [*OPTIMIZE_LINES, "--strategy", "greedy", "--cache-dir",
            cache_dir]
    searched, _ = _optimize_cli(*pair)
    deployed, _ = _optimize_cli(*pair, "--deploy")
    for name, cycles in OPTIMIZE_LINES.items():
        if not any(line.startswith(f"[optimize] {name}: {cycles} ")
                   for line in searched):
            fail(f"launch.optimize did not print {name}: {cycles}")
        if not any(line.startswith(f"[optimize] {name}: cached config ")
                   and f" {cycles} " in line for line in deployed):
            fail(f"launch.optimize --deploy did not read back {name}: "
                 f"{cycles}")
    session = OptimizationSession(strategy="greedy", cache_dir=cache_dir)
    configs = {name: session.deploy(name).config for name in OPTIMIZE_LINES}
    return _deployed_pair(configs, seed=1), configs


def _deployed_pair(configs, seed):
    """K3 and K4 launched through the registry, ``get_kernel(name).
    kernel_fn(a, b, **configs[name])``, on the card at the optimizer
    path's shapes in bf16 and f32: each call launches the instance
    ``select_tiling`` names, once, and agrees with ``ref_fn``; returns the
    launches."""
    import importlib

    import torch
    from repro_torch.kernels import get_kernel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    m, k, n = MLR_SHAPE
    B, bm, bk, bn = BMM_SHAPE
    shapes = {"matmul_leakyrelu": ((m, k), (k, n)),
              "bmm": ((B, bm, bk), (B, bk, bn))}
    path_shapes = {"matmul_leakyrelu": MLR_SHAPE, "bmm": BMM_SHAPE}
    inputs = {(name, dname, dt): _gemm_inputs(gen, dt, *shapes[name])
              for dname, dt in (("bfloat16", torch.bfloat16),
                                ("float32", torch.float32))
              for name in OPTIMIZE_LINES}
    torch.cuda.synchronize()
    _reset_launches()
    outs, tilings = {}, {}
    for (name, dname, dt), (a, b) in inputs.items():
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        outs[name, dname], ran = launched(
            mod, lambda: get_kernel(name).kernel_fn(a, b, **configs[name]))
        tilings[name, dname] = expect_tiling(
            f"deployed {name} {configs[name]} {dname}", ran,
            mod.select_tiling(dt, path_shapes[name], **configs[name]))
    launches = _read_launches()
    want = _expected_launches(matmul_leakyrelu=2, bmm=2)
    print(f"  deployed configs {configs}; launches {launches}; expected "
          f"{want}", flush=True)
    if launches != want:
        fail("the optimizer path did not launch each deployed kernel once "
             "per call")
    for (name, dname, _), (a, b) in inputs.items():
        got = outs[name, dname]
        ref_fn = get_kernel(name).ref_fn
        plain = ref_fn(a, b)
        if got.shape != plain.shape or not torch.isfinite(got).all():
            fail(f"deployed {name} {dname}: misshapen or non-finite output")
        tol = _f64_tolerance(plain, ref_fn(a.double(), b.double()),
                             GEMM_TOL[dname][0])
        check_close(f"deployed {name} {configs[name]} "
                    f"{tilings[name, dname]} {dname}", got, plain, tol, 0.0)
    del inputs, outs
    torch.cuda.empty_cache()
    return launches


_CELL = re.compile(r"\[optimize\] (\w+)@(\w+): (\d+) -> (\d+) cycles "
                   r"\(([0-9.]+)x, ppo, ([0-9.]+)s\)")
_SPLIT = re.compile(r"\[optimize\]   search ([0-9.]+)s agent on (\S+), "
                    r"([0-9.]+)s environments on the host \((\d+) updates\)")
_DEPLOYED = re.compile(r"\[optimize\] (\w+)@(\w+): cached config (\{.*\}) "
                       r"(\d+) -> (\d+) cycles")


def _fleet_cells(lines):
    """{(kernel, bucket): cell} from launch.optimize's PPO output: each
    result line and the split line after it."""
    cells = {}
    for line, nxt in zip(lines, lines[1:] + [""]):
        m, split = _CELL.match(line), _SPLIT.match(nxt)
        if m is None:
            continue
        if split is None:
            fail(f"no agent/environment split after {line!r}")
        cells[m.group(1), m.group(2)] = {
            "baseline": int(m.group(3)), "optimized": int(m.group(4)),
            "seconds": float(m.group(6)),
            "agent_s": float(split.group(1)), "agent_device": split.group(2),
            "env_s": float(split.group(3)), "updates": int(split.group(4))}
    return cells


def fleet_phase(cache_dir, one_dir):
    """(b) The paper's PPO agent, on the card, over qwen1.5-4b's kernel
    fleet through ``launch.optimize --arch`` into ``cache_dir`` (a fresh
    cache, kept for 6(g)), and one cell at the default budget into
    ``one_dir``; then the six deployed kernels on the card through the
    registry."""
    import torch
    from repro_torch.kernels import get_kernel
    from repro_torch.sched import OptimizationSession, Scenario

    print(f"  budget: --timesteps {FLEET_TIMESTEPS} a cell, cut from the "
          f"default 8192 so that the {FLEET_CELLS} cells fit the run; one "
          f"cell at the default below", flush=True)
    fleet = ["--arch", FLEET_ARCH, "--cache-dir", cache_dir]
    searched, wall = _optimize_cli(*fleet, "--timesteps",
                                   str(FLEET_TIMESTEPS))
    cells = _fleet_cells(searched)
    if len(cells) != FLEET_CELLS:
        fail(f"the fleet printed {len(cells)} PPO cells, not "
             f"{FLEET_CELLS}")
    for (name, bucket), c in cells.items():
        if c["baseline"] != FLEET_O3[name] \
                or not c["optimized"] <= c["baseline"] \
                or not c["agent_device"].startswith("cuda"):
            fail(f"fleet cell {name}@{bucket}: {c} (want a start at "
                 f"{FLEET_O3[name]}, an end at or below it, the agent "
                 f"on the card)")
    deployed, _ = _optimize_cli(*fleet, "--deploy")
    back = {(m.group(1), m.group(2)): (int(m.group(4)), int(m.group(5)))
            for m in map(_DEPLOYED.match, deployed) if m}
    if back != {key: (c["baseline"], c["optimized"])
                for key, c in cells.items()}:
        fail(f"--deploy read back {back}")
    one, one_wall = _optimize_cli("softmax", "--scenarios", FLEET_BUCKET,
                                  "--cache-dir", one_dir)
    one_cell = next(iter(_fleet_cells(one).values()))
    session = OptimizationSession(cache_dir=cache_dir)
    configs = {name: session.deploy(
        name, scenario=Scenario.parse(FLEET_BUCKET)).config
        for name in FLEET_O3}
    summary = {
        "cells": {f"{n}@{b}": c for (n, b), c in cells.items()},
        "fleet_wall_s": wall, "timesteps": FLEET_TIMESTEPS,
        "agent_s": sum(c["agent_s"] for c in cells.values()),
        "env_s": sum(c["env_s"] for c in cells.values()),
        "one_cell_default_budget": dict(one_cell, wall_s=one_wall,
                                        cell=f"softmax@{FLEET_BUCKET}",
                                        timesteps=8192)}
    print("  PPO fleet " + json.dumps(summary), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale \
            + shift

    m, k, n = MLR_SHAPE
    B, bm, bk, bn = BMM_SHAPE
    d = configs["flash_attention"]["d"]
    shapes = {   # the path's shapes at the deployed configs (f32 masters)
        "rmsnorm": lambda: (rnd(ROWS, configs["rmsnorm"]["cols"], scale=0.5),
                            rnd(configs["rmsnorm"]["cols"], scale=0.5,
                                shift=1.0)),
        "fused_ff": lambda: (rnd(ROWS, D_MODEL, scale=0.5),
                             rnd(D_MODEL, D_FF, scale=D_MODEL ** -0.5),
                             rnd(D_MODEL, D_FF, scale=D_MODEL ** -0.5)),
        "flash_attention": lambda: tuple(rnd(BATCH, 20, SEQ, d)
                                         for _ in range(3)),
        "softmax": lambda: (rnd(SOFTMAX_ROWS, configs["softmax"]["cols"],
                                scale=2.0),),
        "matmul_leakyrelu": lambda: (rnd(m, k, scale=0.5),
                                     rnd(k, n, scale=k ** -0.5)),
        "bmm": lambda: (rnd(B, bm, bk, scale=0.5),
                        rnd(B, bk, bn, scale=bk ** -0.5)),
    }
    inputs = {}
    for name, make in shapes.items():
        master = make()
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            inputs[name, dname] = tuple(t.to(dt) for t in master)
    torch.cuda.synchronize()
    _reset_launches()
    outs = {key: get_kernel(key[0]).kernel_fn(*xs, **configs[key[0]])
            for key, xs in inputs.items()}
    torch.cuda.synchronize()
    launches = _read_launches()
    want = _expected_launches(**{name: 2 for name in FLEET_O3})
    print(f"  deployed configs {configs}; launches {launches}; expected "
          f"{want}", flush=True)
    if launches != want:
        fail("the fleet path did not launch each deployed kernel once per "
             "call")
    # each kernel's phase-2 tolerance; at the path's shapes the GEMMs and
    # fused_ff also get twice the plain version's own f32 error against
    # an f64 evaluation (sums of 2560 terms)
    tols = {"rmsnorm": {"bfloat16": (1e-5, 2 ** -7),
                        "float32": (1e-5, 1e-5)},
            "flash_attention": {"float32": (2e-4, 0.0),
                                "bfloat16": (3e-2, 0.0)},
            "softmax": SOFTMAX_TOL,
            "fused_ff": {"bfloat16": (1e-4, 2 ** -7),
                         "float32": (1e-5, 0.0)},
            "matmul_leakyrelu": {k: (v[0], 0.0) for k, v in GEMM_TOL.items()},
            "bmm": {k: (v[0], 0.0) for k, v in GEMM_TOL.items()}}
    for (name, dname), got in outs.items():
        xs = inputs[name, dname]
        ref_fn = get_kernel(name).ref_fn
        plain = ref_fn(*xs)
        if got.shape != plain.shape or not torch.isfinite(got).all():
            fail(f"deployed {name} {dname}: misshapen or non-finite output")
        atol, rtol = tols[name][dname]
        if name in ("fused_ff", "matmul_leakyrelu", "bmm"):
            atol = _f64_tolerance(plain, ref_fn(*(t.double() for t in xs)),
                                  atol)
        check_close(f"deployed {name} {configs[name]} "
                    f"{tuple(xs[0].shape)} {dname}", got, plain, atol, rtol)
        del plain
    del inputs, outs
    torch.cuda.empty_cache()
    return launches, configs


_GREEDY_CELL = re.compile(r"\[optimize\] (\w+)@(\w+): (\d+ -> \d+) cycles "
                          r"\([0-9.]+x, greedy, ")


def ssm_fleet_phase(cache_dir):
    """(c) The SSM fleet, greedy: ``python -m repro_torch.launch.optimize
    --arch mamba2-1.3b --strategy greedy`` into ``cache_dir`` (a fresh
    cache, kept for 6(h)) prints the
    reference's 16 cells (4 kernels x 4 buckets) and its campaign and memo
    lines, and ``--deploy`` reads the 16 back; then the deployed ``ssd``
    is launched through the registry, ``get_kernel("ssd").kernel_fn(x, a,
    b, c, **artifact.config)``, at the first bucket's config on the flat
    path's shape (mamba2-1.3b's 64 heads x batch 4 as 256 rows of 2048
    positions), in bf16 and f32, held against ``ref_fn``, once a call."""
    import torch
    from repro_torch.kernels import get_kernel
    from repro_torch.sched import OptimizationSession, Scenario

    fleet = ["--arch", SSM_ARCH, "--strategy", "greedy", "--cache-dir",
             cache_dir]
    searched, wall = _optimize_cli(*fleet)
    deployed, deploy_wall = _optimize_cli(*fleet, "--deploy")
    cells = {(m.group(1), m.group(2)): m.group(3)
             for m in map(_GREEDY_CELL.match, searched) if m}
    want = {(name, bucket): cycles[bucket == SSM_BUCKETS[-1]]
            for name, cycles in SSM_FLEET_CYCLES.items()
            for bucket in SSM_BUCKETS}
    if cells != want:
        fail(f"the SSM fleet printed {cells}, not the reference's {want}")
    for tail in SSM_FLEET_TAIL:
        if not any(line.startswith(tail) for line in searched):
            fail(f"the SSM fleet did not print {tail!r}")
    back = {(m.group(1), m.group(2)): f"{m.group(4)} -> {m.group(5)}"
            for m in map(_DEPLOYED.match, deployed) if m}
    if back != want:
        fail(f"--deploy read back {back}")
    config = OptimizationSession(strategy="greedy", cache_dir=cache_dir) \
        .deploy("ssd", scenario=Scenario.parse(FLEET_BUCKET)).config
    print(f"  SSM fleet: {len(cells)} cells as the reference's, "
          f"search {wall:.1f} s, deploy {deploy_wall:.1f} s; ssd deployed "
          f"at {config}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, _, P, N = SSM_SHAPE
    master = ssd_inputs(gen, (B * H, S, 1, 1, P, N), torch.float32)
    master = tuple(t[:, :, 0] for t in master)
    inputs = {dname: (master[0].to(dt), master[1], master[2].to(dt),
                      master[3].to(dt))
              for dname, dt in (("bfloat16", torch.bfloat16),
                                ("float32", torch.float32))}
    kdef = get_kernel("ssd")
    torch.cuda.synchronize()
    _reset_launches()
    outs = {dname: kdef.kernel_fn(*xs, **config)
            for dname, xs in inputs.items()}
    torch.cuda.synchronize()
    launches = _read_launches()
    want_launches = _expected_launches(ssd=2)
    print(f"  launches {launches}; expected {want_launches}", flush=True)
    if launches != want_launches:
        fail("the SSM fleet path did not launch the deployed ssd once per "
             "call")
    for dname, got in outs.items():
        xs = inputs[dname]
        plain = kdef.ref_fn(*xs)
        if got.shape != plain.shape or not torch.isfinite(got).all():
            fail(f"deployed ssd {dname}: misshapen or non-finite output")
        check_close(f"deployed ssd {config} {tuple(xs[0].shape)} x "
                    f"{tuple(xs[2].shape)} {dname}", got, plain,
                    *ssd_tol(dname, plain.float().abs().max().item()))
    del inputs, outs
    torch.cuda.empty_cache()
    return launches, config


def tiling_gate(deployed):
    """The deployed config chooses the tiling (ROADMAP C1), for every
    kernel: each kernel's deployed config (``deployed``: the pair's for K3
    and K4, the fleets' first bucket's for the others) and another entry
    of its ``CONFIGS`` (the space the optimizer deploys from) that names
    another instance are launched through the registry at the path's
    shapes, in bf16 for all seven kernels (K7: the deployed chunk against
    the other of 64 and 128) and in f32 for K2, K3, K4 and K6 (the
    per-config SIMT instances); each must launch the instance its config
    names, and both outputs must agree with ``ref_fn`` at the kernel's
    phase-2 bound."""
    import importlib

    import torch
    from repro_torch.kernels import get_kernel

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, H, _, _, _ = SSM_SHAPE

    def path_shape(name, cfg):   # what the kernel's select_tiling takes
        return {"flash_attention": (BATCH, 20, SEQ, cfg.get("d")),
                "matmul_leakyrelu": MLR_SHAPE, "bmm": BMM_SHAPE,
                "fused_ff": MLR_SHAPE,
                "rmsnorm": (ROWS, cfg.get("cols")),
                "softmax": (SOFTMAX_ROWS, cfg.get("cols")),
                "ssd": (B * H, S, 1, 1, cfg.get("p"), cfg.get("n"))}[name]

    def inputs(name, cfg, dt):
        def rnd(*shape, scale=1.0, shift=0.0):
            return (torch.randn(*shape, device="cuda", generator=gen)
                    * scale + shift).to(dt)
        shape = path_shape(name, cfg)
        if name == "flash_attention":
            return tuple(rnd(*shape) for _ in range(3))
        if name == "rmsnorm":
            return rnd(*shape, scale=0.5), rnd(shape[1], scale=0.5, shift=1.0)
        if name == "softmax":
            return (rnd(*shape, scale=2.0),)
        if name == "ssd":
            return tuple(t[:, :, 0] for t in ssd_inputs(gen, shape, dt))
        if name in ("matmul_leakyrelu", "fused_ff"):
            m, k, n = shape
            a, b = _gemm_inputs(gen, dt, (m, k), (k, n))
            return (a, b) if name == "matmul_leakyrelu" else (
                a, b, rnd(k, n, scale=k ** -0.5))
        B_, m, k, n = shape
        return _gemm_inputs(gen, dt, (B_, m, k), (B_, k, n))

    def tolerance(name, plain, xs, kdef, dname):   # the phase-2 bounds
        if name == "flash_attention":
            return (3e-2 if dname == "bfloat16" else 2e-4), 0.0
        if name == "rmsnorm":
            return 1e-5, 2 ** -7
        if name == "softmax":
            return SOFTMAX_TOL[dname]
        if name == "ssd":
            return ssd_tol(dname, plain.float().abs().max().item())
        floor = (1e-4 if dname == "bfloat16" else 1e-5) \
            if name == "fused_ff" else GEMM_TOL[dname][0]
        f64 = _f64_tolerance(plain, kdef.ref_fn(*(t.double() for t in xs)),
                             floor)
        return f64, 2 ** -7 if (name, dname) == ("fused_ff", "bfloat16") \
            else 0.0

    def second_config(name, configs, first, tiling):
        if name == "ssd":   # the same widths at the other chunk
            same = [c for c in configs if c["chunk"] != first["chunk"]
                    and (c["p"], c["n"]) == (first["p"], first["n"])]
            if same:
                return same[0]
        return next(c for c in configs if tiling(c) != tiling(first))

    gate = {}
    for dname, dt, names in (
            ("bfloat16", bf16, ("matmul_leakyrelu", "bmm", "flash_attention",
                                "rmsnorm", "fused_ff", "softmax", "ssd")),
            ("float32", f32, ("matmul_leakyrelu", "bmm", "flash_attention",
                              "fused_ff"))):
        for name in names:
            kdef = get_kernel(name)
            mod = importlib.import_module(f"repro_torch.kernels.{name}")

            def tiling(cfg):
                return mod.select_tiling(dt, path_shape(name, cfg), **cfg)

            first = deployed[name]
            second = second_config(name, kdef.configs, first, tiling)
            for cfg in (first, second):
                xs = inputs(name, cfg, dt)
                got, ran = launched(mod, lambda: kdef.kernel_fn(*xs, **cfg))
                expect_tiling(f"{name} at {cfg} {dname}", ran, tiling(cfg))
                plain = kdef.ref_fn(*xs)
                if got.shape != plain.shape or not torch.isfinite(got).all():
                    fail(f"{name} at {cfg}: misshapen or non-finite output")
                check_close(f"{name} at {cfg} {tuple(xs[0].shape)} {dname}",
                            got, plain,
                            *tolerance(name, plain, xs, kdef, dname))
                del xs, got, plain
            gate[f"{name} {dname}"] = {tiling(first): first,
                                       tiling(second): second}
            torch.cuda.empty_cache()
    print("  the deployed config chooses the tiling: " + json.dumps(gate),
          flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6 (e)-(g): guided searches, the cost model, tuned schedules served
# ---------------------------------------------------------------------------

def guided_phase(cache_dirs):
    """(e) The oracle-ranked guided searches on the pair: ``launch.optimize
    matmul_leakyrelu bmm --strategy beam``, then ``lookahead``, each into
    its fresh cache ``cache_dirs[strategy]``, print the reference's cycles
    and memo line, and ``--deploy`` reads the artifacts back; then K3 and
    K4 at the beam artifacts' configs through the registry
    (``_deployed_pair``)."""
    from repro_torch.sched import OptimizationSession

    walls, configs = {}, None
    for strategy, cycles in GUIDED_LINES.items():
        cache_dir = cache_dirs[strategy]
        pair = [*cycles, "--strategy", strategy, "--cache-dir",
                cache_dir]
        searched, walls[strategy] = _optimize_cli(*pair)
        deployed, _ = _optimize_cli(*pair, "--deploy")
        for name, want in cycles.items():
            if not any(line.startswith(f"[optimize] {name}: {want} ")
                       and f", {strategy}-oracle, " in line
                       for line in searched):
                fail(f"--strategy {strategy} did not print {name}: "
                     f"{want}")
            if not any(line.startswith(f"[optimize] {name}: cached "
                                       f"config ") and f" {want} " in line
                       for line in deployed):
                fail(f"--strategy {strategy} --deploy did not read back "
                     f"{name}: {want}")
        if not any(line.startswith(GUIDED_MEMO[strategy])
                   for line in searched):
            fail(f"--strategy {strategy} did not print "
                 f"{GUIDED_MEMO[strategy]!r}")
        if strategy == "beam":
            session = OptimizationSession(strategy="greedy",
                                          cache_dir=cache_dir)
            configs = {name: session.deploy(name).config
                       for name in cycles}
    print("  guided searches as the reference's: " + json.dumps(
        {"wall_s": walls, "beam_configs": configs}), flush=True)
    return _deployed_pair(configs, seed=5)


def start_searches(caches):
    """Start phase 6's command lines beside phase 3, which measures no
    time (``_start_side_by_side``): (a)'s, (b)'s, (c)'s and (e)'s
    host-bound searches, each with its ``--deploy`` after it, (b)'s one
    cell at the default budget, and (g)'s refusal over an empty cache,
    into ``caches``.  Each sub-phase of phase 6 then reads its runs'
    output and holds it as if it had run them."""
    opt, serve = "repro_torch.launch.optimize", "repro_torch.launch.serve"
    pair = (*OPTIMIZE_LINES, "--strategy", "greedy", "--cache-dir",
            caches["cache"])
    fleet = ("--arch", FLEET_ARCH, "--cache-dir", caches["fleet"])
    ssm = ("--arch", SSM_ARCH, "--strategy", "greedy", "--cache-dir",
           caches["ssm"])
    chains = [[(opt, *pair), (opt, *pair, "--deploy")],
              [(opt, *fleet, "--timesteps", str(FLEET_TIMESTEPS)),
               (opt, *fleet, "--deploy")],
              [(opt, "softmax", "--scenarios", FLEET_BUCKET, "--cache-dir",
                caches["cell"])],
              [(opt, *ssm), (opt, *ssm, "--deploy")],
              [(serve, "--arch", FLEET_ARCH, "--full", "--qps", "4",
                "--requests", str(TUNED_REQUESTS), "--schedule-cache",
                caches["empty"], "--strict-schedules")]]
    for strategy, cycles in GUIDED_LINES.items():
        guided = (*cycles, "--strategy", strategy, "--cache-dir",
                  caches[strategy])
        chains.append([(opt, *guided), (opt, *guided, "--deploy")])
    return _start_side_by_side(chains)


def start_costmodel():
    """Start (f)'s ``launch.evaluate --budget 512 --memo-dir D
    --train-cost-model --out J`` (host-bound, 94 s alone on one H100's
    host): it runs beside phase 3, which measures no time, and is
    awaited before phase 4 (:func:`costmodel_phase` reads it)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    memo_dir = tempfile.mkdtemp(prefix="chip_smoke_costmodel_",
                                dir=os.path.join(ROOT, "build"))
    out = os.path.join(memo_dir, "evaluator.json")
    started = _start_cli("repro_torch.launch.evaluate", "--budget",
                         str(EVAL_BUDGET), "--memo-dir", memo_dir,
                         "--train-cost-model", "--out", out)
    started.update(memo_dir=memo_dir, json=out)   # the waiter writes here
    return started


def await_costmodel(started, timeout=900):
    """Wait for :func:`start_costmodel`'s process to end (its wall time
    kept for :func:`costmodel_phase`)."""
    started["proc"].wait(timeout=timeout)
    started["ended"].join()
    print(f"  launch.evaluate (beside phase 3) ended after "
          f"{started['wall']:.1f} s", flush=True)


def costmodel_phase(started):
    """(f) The cost model on the card: ``launch.evaluate --budget 512
    --memo-dir D --train-cost-model --out J`` (started by
    :func:`start_costmodel`) runs the default roster with the PPO warm
    phase's agent and the model on the card.  Held: the
    reference acceptance test's budget clause (on each kernel beam-cost
    spends more than nothing and at most a quarter of greedy's
    measurements), and a held-out Spearman of at least ``SPEARMAN_FLOOR``
    (the model ranks at all).  Printed, not held: the Spearman against
    the reference test's 0.8, and beam-cost's best against greedy's — at
    one seed both are coins in the reference itself (ROADMAP §C).  Then
    two fits on the card from the saved dataset, same seed, must give
    equal parameters, and the saved ``cost_model.npz`` loaded back must
    hold those parameters and predict what the live fit predicts."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.costmodel import (DEFAULT_STRATEGIES, CostDataset,
                                       CostModel)
    from repro_torch.launch.evaluate import DATASET_FILENAME, MODEL_FILENAME

    memo_dir, out = started["memo_dir"], started["json"]
    try:
        _, wall = _cli("repro_torch.launch.evaluate", timeout=900,
                       started=started)
        with open(out) as f:
            result = json.load(f)
        dataset = CostDataset.load(os.path.join(memo_dir, DATASET_FILENAME))
        saved = CostModel.load(os.path.join(memo_dir, MODEL_FILENAME),
                               device="cuda")
    finally:
        shutil.rmtree(memo_dir)
    rows = {(r["strategy"], r["kernel"]): r for r in result["rows"]}
    rc = result["rank_correlation"]
    print(f"  held-out Spearman {rc} over {result['dataset_rows']} corpus "
          f"rows (held >= {SPEARMAN_FLOOR}; the reference test's 0.8 "
          f"printed, not held: ROADMAP §C); launch.evaluate {wall:.1f} s",
          flush=True)
    for r in result["rows"]:
        print(f"  {r['strategy']} {r['kernel']}: {r['best_cycles']:.0f} "
              f"cycles, {r['measurements']} measurements, {r['seconds']} s",
              flush=True)
    if {st for st, _ in rows} != set(DEFAULT_STRATEGIES) \
            or len(rows) != len(DEFAULT_STRATEGIES) * 2:
        fail(f"launch.evaluate ran {sorted(rows)}, not the default roster")
    if rc is None or rc < SPEARMAN_FLOOR:
        fail(f"held-out Spearman {rc} below {SPEARMAN_FLOOR}: the cost "
             f"model does not rank")
    for kernel in OPTIMIZE_LINES:
        greedy, beam = rows["greedy", kernel], rows["beam-cost", kernel]
        print(f"  beam-cost {kernel}: {beam['best_cycles']:.0f} cycles in "
              f"{beam['measurements']} measurements; greedy "
              f"{greedy['best_cycles']:.0f} in {greedy['measurements']} "
              f"(best not held: ROADMAP §C)", flush=True)
        if not 0 < beam["measurements"] <= greedy["measurements"] / 4:
            fail(f"beam-cost on {kernel} spent {beam['measurements']} "
                 f"measurements, not within a quarter of greedy's "
                 f"{greedy['measurements']}")
    fits = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, _ = CostModel.fit(dataset, seed=0, device="cuda")
        torch.cuda.synchronize()
        fits.append((model, time.perf_counter() - t0))
    (live, fit_s), (again, fit2_s) = fits
    for k, v in live.params.items():
        if v.device.type != "cuda" or not torch.equal(v, again.params[k]) \
                or not torch.equal(v, saved.params[k]):
            fail(f"cost model parameter {k}: two fits on the card, or the "
                 f"fit and the saved model, differ")
    pred = live.predict_log(dataset.X)
    if pred.shape != (len(dataset),) or not np.isfinite(pred).all() \
            or not np.array_equal(pred, saved.predict_log(dataset.X)):
        fail("the saved cost model does not predict what the live fit "
             "predicts")
    summary = {"spearman": rc, "corpus_rows": result["dataset_rows"],
               "evaluate_wall_s": wall, "fit_s": [fit_s, fit2_s],
               "rows": result["rows"]}
    print("  cost model on the card: two fits bit-equal, the saved model "
          "predicts as the live one; " + json.dumps(summary), flush=True)
    return summary


_PLAN_LINE = re.compile(r"\[serve\]   (\w+)@(\w+)(?: \[\S+\])?: (.*)$")
_TUNED = re.compile(r"[0-9.]+x \(\d+ cycles\)$")


def _serve_in_process(arch, cache, *extra):
    """``launch.serve --arch ARCH --full --qps 4 --requests 8
    --schedule-cache CACHE EXTRA`` through the launcher's ``main`` in this
    process, so that its engine and the kernels' counts can be read:
    every request must finish whole with in-vocab tokens, and the kernels
    launch ``serve_sites`` times a pass.  Returns (the launches, the
    plan lines' states, stats)."""
    import contextlib
    import io

    import torch
    from repro_torch.launch import serve as launch_serve

    engines = []

    class Recorded(launch_serve.ServeEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    real, launch_serve.ServeEngine = launch_serve.ServeEngine, Recorded
    buf = io.StringIO()
    argv = ["--arch", arch, "--full", "--qps", "4", "--requests",
            str(TUNED_REQUESTS), "--schedule-cache", cache, *extra]
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            launch_serve.main(argv)
        torch.cuda.synchronize()
    finally:
        launch_serve.ServeEngine = real
        print(f"  launch.serve {' '.join(argv)}  "
              f"({time.perf_counter() - t0:.1f} s)\n"
              + "\n".join("    " + line
                          for line in buf.getvalue().splitlines()),
              flush=True)
    launches = _read_launches()
    engine, = engines
    passes = engine.counters["passes"]
    _check_served(engine.cfg, engine, TUNED_REQUESTS, passes, launches)
    lines = buf.getvalue().splitlines()
    plan = [m.group(3) for m in map(_PLAN_LINE.match, lines) if m]
    warned = [line for line in lines if line.startswith("[serve] WARNING: ")]
    stats = {"passes": passes, "plan_lines": len(plan),
             "schedule_fallbacks": engine.counters["schedule_fallbacks"],
             "warnings": warned}
    del engines, engine
    torch.cuda.empty_cache()
    return launches, plan, stats


def _tuned(plan, stats, cells):
    """Whether ``plan`` is ``cells`` tuned lines, with no fallback."""
    return (len(plan) == cells and all(map(_TUNED.search, plan))
            and not stats["warnings"] and stats["schedule_fallbacks"] == 0)


def tuned_serve_phase(cache_dir, empty):
    """(g) Tuned schedules served: ``launch.serve --arch qwen1.5-4b --full
    --qps 4 --requests 8 --schedule-cache DIR --strict-schedules`` over the
    cache the PPO fleet (b) wrote prints an 18-line plan and no fallback
    warning, completes every request with in-vocab tokens, and launches K1
    and K2 passes x 81 and x 40 times; against an empty cache the same
    command exits non-zero before serving, and without
    ``--strict-schedules`` it serves with 18 ``not optimized (-O3
    baseline)`` lines, the warning and 18 ``schedule_fallbacks``.  The
    two serving runs call the launcher's ``main`` in this process
    (``_serve_in_process``); ``empty`` is an empty cache."""
    proc, lines, wall = _run_cli(
        "repro_torch.launch.serve", "--arch", FLEET_ARCH, "--full",
        "--qps", "4", "--requests", str(TUNED_REQUESTS),
        "--schedule-cache", empty, "--strict-schedules", timeout=600)
    if proc.returncode == 0 or "FileNotFoundError" not in proc.stderr \
            or any(line.startswith("[serve] tokens/s") for line in lines):
        fail(f"--strict-schedules over an empty cache did not refuse "
             f"before serving (exit {proc.returncode}):\n"
             f"{proc.stderr[-2000:]}")
    print(f"  an empty cache under --strict-schedules: exit "
          f"{proc.returncode}, {proc.stderr.strip().splitlines()[-1]}",
          flush=True)
    tuned, plan, stats = _serve_in_process(FLEET_ARCH, cache_dir,
                                           "--strict-schedules")
    if not _tuned(plan, stats, FLEET_CELLS):
        fail(f"the PPO fleet's cache did not give an {FLEET_CELLS}-line "
             f"tuned plan without fallbacks: {plan} {stats}")
    untuned, plan, ustats = _serve_in_process(FLEET_ARCH, empty)
    if plan != ["not optimized (-O3 baseline)"] * FLEET_CELLS \
            or ustats["schedule_fallbacks"] != FLEET_CELLS \
            or len(ustats["warnings"]) != 1 \
            or f" {FLEET_CELLS} kernel(s) " not in ustats["warnings"][0]:
        fail(f"an empty cache without --strict-schedules: {plan} "
             f"{ustats}")
    print("  tuned schedules served: " + json.dumps(
        {"tuned": stats, "untuned": ustats, "strict_refusal_s": wall}),
        flush=True)
    return tuned, untuned


def tuned_ssm_serve_phase(cache_dir):
    """(h) Tuned SSM serving: ``launch.serve --arch mamba2-1.3b --full
    --qps 4 --requests 8 --schedule-cache DIR --strict-schedules`` over
    the cache the SSM fleet (c) wrote prints the 16-line plan (4 kernels
    x 4 buckets) and no fallback, completes every request with in-vocab
    tokens, and launches K1 passes x 97 times."""
    launches, plan, stats = _serve_in_process(SSM_ARCH, cache_dir,
                                              "--strict-schedules")
    cells = len(SSM_FLEET_CYCLES) * len(SSM_BUCKETS)
    if not _tuned(plan, stats, cells):
        fail(f"the SSM fleet's cache did not give a {cells}-line tuned plan "
             f"without fallbacks: {plan} {stats}")
    print("  tuned SSM schedules served: " + json.dumps(stats), flush=True)
    return launches


# ---------------------------------------------------------------------------

def main_paths(profile):
    """Phases 4 to 5d, the models' main paths on the card: {path: the
    kernels' launches on it}."""
    phase("4 serving main paths")
    launches = {"serve": serve_phase("qwen1.5-4b", profile),
                "serve_ssm": serve_phase(SSM_ARCH, profile),
                "serve_hybrid": serve_phase(HYBRID_ARCH, profile),
                "serve_hybrid_spill": preempt_phase(HYBRID_ARCH),
                "serve_moe": serve_phase(MOE_ARCH, profile),
                "serve_mla": serve_phase(MLA_ARCH, profile),
                "serve_mla_fork": fork_phase(MLA_ARCH),
                "serve_encdec": encdec_serve_phase(ENCDEC_ARCH, profile)}

    phase("5 training main paths")
    launches["train"] = train_phase("stablelm-3b", profile, roofline=True)
    launches["train_ssm"] = train_phase(SSM_ARCH, profile)
    launches["train_hybrid"] = train_phase(HYBRID_ARCH, profile)
    launches["train_moe"] = train_phase(MOE_ARCH, profile)
    launches["train_mla"] = train_phase(MLA_ARCH, profile)
    launches["train_encdec"] = train_phase(ENCDEC_ARCH, profile)
    launches["train_dots"] = remat_phase()

    phase("5b pipeline train step")
    launches["train_pipe"] = pipeline_phase()

    phase("5c GSPMD train step")
    launches["train_gspmd"] = gspmd_phase()

    phase("5d serving with a mesh")
    launches["serve_mesh"] = serve_mesh_phase()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile decode passes and a train step "
                         "of each served and trained model with "
                         "torch.profiler and write the tables to DIR")
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"  kernel library: built in {_build.build_seconds} s "
          f"(None: found built), loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    phase("2 kernels")
    records = kernel_phase()

    phase("3 device against host")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    caches = {name: tempfile.mkdtemp(prefix=f"chip_smoke_{name}_",
                                     dir=os.path.join(ROOT, "build"))
              for name in ("cache", "fleet", "cell", "ssm", *GUIDED_LINES,
                           "empty")}
    try:
        costmodel = start_costmodel()
        side = start_searches(caches)
        for check in (lambda: device_host_phase("qwen1.5-4b"),
                      lambda: device_host_phase(SSM_ARCH),
                      lambda: device_host_phase(MOE_ARCH),
                      lambda: device_host_phase(MLA_ARCH, f64_witness=True),
                      lambda: device_host_train_step("stablelm-3b"),
                      lambda: device_host_train_step(SSM_ARCH),
                      lambda: device_host_train_step(HYBRID_ARCH,
                                                     n_layers=12),
                      lambda: device_host_train_step(MOE_ARCH),
                      lambda: device_host_train_step(MLA_ARCH),
                      lambda: device_host_encdec(ENCDEC_ARCH),
                      lambda: device_host_train_step(
                          ENCDEC_ARCH, n_layers=4, enc_layers=2,
                          dec_layers=2)):
            t0 = time.perf_counter()
            check()
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
            _step_side_by_side(side)
        _end_side_by_side(side)
        await_costmodel(costmodel)
        launches = main_paths(args.profile)

        phase("6 optimizer main paths")
        launches["optimize"], pair_configs = optimize_phase(caches["cache"])
        launches["fleet"], fleet_configs = fleet_phase(caches["fleet"],
                                                       caches["cell"])
        launches["fleet_ssm"], ssd_config = ssm_fleet_phase(caches["ssm"])
        tiling_gate(dict(fleet_configs, **pair_configs, ssd=ssd_config))
        launches["guided"] = guided_phase(caches)
        costmodel_phase(costmodel)
        launches["serve_tuned"], launches["serve_untuned"] = \
            tuned_serve_phase(caches["fleet"], caches["empty"])
        launches["serve_ssm_tuned"] = tuned_ssm_serve_phase(caches["ssm"])
    finally:
        for cache in caches.values():
            shutil.rmtree(cache)

    phase("7 kernels")
    kernels = []
    for name, (_, _, headline) in KERNELS.items():
        mine = [r for r in records if r["name"] == name]
        # the headline numbers are those at the kernel's own path's shape,
        # in bf16
        entry = {k: v for k, v in next(
            r for r in mine if r["path"] == headline
            and r["shape"].endswith("bfloat16")
            and not r.get("backward")).items()
                 if k not in ("shape", "path")}
        by_path = {p: launches[p][name] for p in launches}
        if not sum(by_path.values()):
            fail(f"{name} was launched no time on the main paths")
        tilings = {p: launches[p].tilings[name] for p in launches
                   if launches[p].tilings.get(name)}
        entry.update(launches=sum(by_path.values()),
                     launches_by_path=by_path,
                     launches_by_tiling=tilings,
                     shapes=[{k: v for k, v in r.items()
                              if k not in ("name", "route", "source",
                                           "replaces")} for r in mine])
        kernels.append(entry)
    phase(None)
    print(f"  every phase passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
