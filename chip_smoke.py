#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

``python3 chip_smoke.py --kernel-times SRC`` instead times the BrSGD
kernels of the repro_torch package under SRC (device time by
torch.profiler, and CUDA events) at the two timing shapes, and B7's
backward at its three timing shapes, and checks nothing: run it on this
tree's src and on a parent commit's, unpacked beside it, in turns, to
compare kernels on one card.

Phases (any failure exits non-zero; nothing is caught and carried on),
in this order: 1, 2's start, B6 / B7 of 3, 3b, 7 but its profile, 7e's
and 7g's serve (their libraries build in seconds), 2's end, 3, 4, 5, 6,
7's profile, 7b, 7c, 7d, 7h, 7i, 7e's and 7g's train steps, 7f, 8, 9 (the BrSGD
libraries
take minutes to build, which the first phases use; no torch.profiler
session runs before every library is loaded):
  1. device: name, count, versions, nvidia-smi name and power limit;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc
     per source, all started together) and print the -Xptxas -v
     register / shared-memory / spill summary (the column pass's
     instances at m = 20 on a line of their own); from the SASS, the
     HMMA count of B6 and B7, the HGMMA (wgmma) count of B6's backward,
     which must hold some, the HMMA count of B7's backward, and B3's load
     batching at m = 20;
  3. every kernel (B1-B5, and the median alone) against its plain
     PyTorch version on the card, at the LeNet main-path shape [20,
     61706], a ragged [7, 1003], [64, 4096], the robustness twin's
     [20, 20] and the rate twin's [10, 20], and at [20, 61706] with one
     worker's row NaN (whole, or every 5th column); at every m in 1..64
     (each on its tuned or bucket instance) the column pass (B1 at every
     needs subset, B4, the median alone) at d = 1003 and d = 61 with a
     NaN worker row and with NaN columns, and at [m, 1003] with one
     worker NaN in every third column B1-B5, the fused launches and every
     rule through aggregate_local, fixed and elastic, against the CPU
     (one line of checks per instance and the worst errors; m = 65 must
     raise);
     B5 at trim fractions 0.1, 0.25, 0.49 and 0.5 (a second launch the
     same bits), at every m also with NaN and ±inf in trimmed and kept
     slots at d = 1003 and 61, on G and on a view whose rows start 4
     bytes past 16;
     the fused brsgd launch (B1's brsgd call + B2, one cooperative
     kernel) at the same inputs with G resident in shared memory, and at
     [20, 2000003], where it is not, with and without a NaN worker:
     scores, thresholds, masks and weights exact, the aggregate bit-equal
     to masked_mean_det(G, w), a second launch the same bits; the fused
     select launch (B1's gram pass + the rule + B3, one cooperative
     kernel) for krum, multi_krum and geomedian at the same inputs, with
     a duplicated worker, and at [20, 2000003]: gram within 1e-5, krum
     scores within 1e-5 and weights exact (against the plain rule on the
     launch's own scores and against the plain composition), geomedian's
     weights within 1e-5, the aggregate bit-equal to masked_mean_det(G,
     w); B3 bit-equal with 0/1, float and unit weights; two workers with
     non-finite columns (NaN, +inf, -inf) that the rules leave out, at
     [20, 61706] (resident), [20, 2000003] (not) and on the bucket
     instances at m = 12 and 33: B1-B5 and the fused launches against
     their plain versions, the aggregate NaN in the left-out worker's
     non-finite columns (every combine sums every row, weight 0
     included, as the reference's w @ g);
     B6 (flash attention) at the qwen3-0.6b prefill [B=4, H=16, Hkv=8,
     S=512, D=128] and the serve loop's batch-1 [1, 16, 8, 512 | 256,
     128], a ragged S = 200, window 64, D = 64 and 80, in
     bfloat16, S = 5 (below one mma tile), S one past a query and a key
     tile, groups 1, 2 and 8, every D in both types, and the model's
     strided views against contiguous copies; B6's MLA instances: (q/k
     96, v 64) at minicpm3-4b's prefill [4, 40, 40, 512] in both types,
     at [1, 40, 40, 4096], a ragged S = 211 in groups of 2 and a window;
     (192, 128) at deepseek-v2's prefill [4, 128, 128, 512] in both
     types, [1, 128, 128, 300], ragged S in groups of 2 and windows;
     the (96, 96) instance at phi-3-vision-4.2b's prefill with its 576
     patches [4, 32, 32, 1088] in both types, a ragged S = 211 in
     groups of 2, a window and batch 1 at S = 600;
     B7's one-chunk call at
     rwkv6-7b's [4, 64, 64, 64] with w in (e^-1, 1) and down to e^-3 (the
     clamps bite), a ragged Q = 40 and K = 32, also against the
     sequential oracle, and B7's layer call (wkv6_seq, one launch) at
     S in {1, 63, 64, 65, 512}, K in {32, 64}, and at the serve loop's
     batch 1 with 64 heads, K = 64, S in {300, 512}, both decay ranges,
     from a nonzero state;
  3b. B6's and B7's backward kernels against autograd of their plain
     versions: B6 (dq, dk, dv) at the launcher's train shape [2, 16, 8,
     128, 128], one train_4k sequence [1, 16, 8, 4096, 128], the prefill
     shape, a ragged S = 200 with window 64, D = 64 and 80, S = 5, S one
     past a tile, groups 1, 2 and 8, the model's strided views against
     contiguous copies (bit-equal), the (96, 64) instance at
     minicpm3-4b's [4, 40, 40, 512], [1, 40, 40, 4096], S = 211 and a
     window, and the (192, 128) instance at deepseek-v2's [2, 128, 128,
     128], [1, 16, 16, 4096], S = 211, a window, S = 5 and 65, and the
     (96, 96) instance at phi-3-vision-4.2b's gradient shape [2, 32, 32,
     704], S = 5, 65 and 129 and a window; B7 (dr,
     dk, dv, dw, du, dS_in) at
     [2, 128, 64, 64] and [1, 4096, 64, 64], S in {1, 63, 64, 65}, K = 32,
     w in (e^-1, 1) and down to e^-3, from a nonzero state, with a given
     dS_final and without; each backward launched twice (the same bits),
     and the training forward (log-sum-exp / chunk states written) bit-
     equal to the serve forward;
  4. the paper loop: one make_sim_step step on the card and one on the
     CPU from the same params and batch (brsgd under scale at 0.25, and
     trimmed_mean under scale at 0.1, which it trims away), then 5 card
     steps of each with the launch counters checked (brsgd: 5 fused
     launches and nothing else); the step timed with the fused launch
     and with the two-pass composition it replaced, in turns; one
     aggregate_local of every select rule (brsgd, mean, krum, multi_krum,
     geomedian) and of the median: device kernels per call
     (torch.profiler, must be 1) and host ms, the eager composition (the
     median's: B4 and its two sums) and the one launch in turns; the
     trimmed mean's device kernels per call (B5's one launch); the
     paper step of each select rule, both ways in turns;
  5. the main path: paper.train_lenet at LeNet width, m = 20, 60 steps
     (brsgd under scale and gaussian, the mean baseline, median, krum,
     trimmed_mean under gaussian, multi_krum and geomedian under scale),
     with every kernel's launch counter read around it and each run
     held to its rule's kernels, once a step;
  6. the elastic path: for every aggregator at [20, 61706], 4 arrival
     buckets, quorum 15, the bulk masked aggregate_local on the card
     against the same call on the CPU, and stream_aggregate against the
     bulk call; the CLAIM subset of paper.robustness (1 seed) with its
     launch counters; one elastic step timed;
  7. the serve path: repro_torch.launch.serve.main on the card at full
     width, qwen3-0.6b (28 layers) and rwkv6-7b (32 layers), batch 4,
     prompt 512, 16 greedy tokens, 3 timed passes each, with the launch
     counters read around each (B6 = 28 and B7 = 32 per prefill, none
     in decode); card against the host CPU at full width cut to 2 layers
     (prompt 80, a ragged chunk: prefill logits, 8 teacher-forced decode
     steps over a float32 and over the bfloat16 cache, greedy tokens);
     prefill == sequential decode on the card for both reduced configs;
  7b. the continuous-batching serve loop at full width: (a)
     serve.main --serve-loop for qwen3-0.6b (8 requests, --max-batch
     8, prompts 256-512, 16 new tokens) from a port checkpoint in a
     temporary directory under build/ (removed at the end), and for
     rwkv6-7b from --seed (4 requests, --max-batch 4, 8 new tokens):
     every request completes, one decode graph, and B6 / B7 held
     against their plain versions on the inputs the loop's prefills
     gave them (the first call at each distinct shape); (b) at full
     width cut to 4 layers, from a checkpoint of that depth, a swap to
     negated params published after decode step 4 of a 4-request loop
     with a float32 cache: swap_count 1, two decode graphs, tokens equal
     to an eager batch-1 decode that switches params there, not to the
     never-swapped one; (c) every request of (a) equal to the same loop
     serving it alone (exact), and against its isolated batch-1
     serve.generate decode; then the same stream, params and slots
     through a loop over a float32 cache against serve.generate over
     one; tokens may differ first only at a near tie of the reference
     (top-two logits within 1e-4 of max|logit| with the float32 cache,
     1e-2 with the bfloat16 one), counted and printed;
     (d) B6 = 28 per qwen3 admission, B7 = 32 per rwkv6 admission, none
     in the decode step (counted on its eager warm-up); (e) at the same
     cut depth, a torn and a
     corrupt publish under live decode quarantined, the served step
     kept, a slot stalled for 12 ticks requeued by a 4-tick timeout,
     every request complete and held to its isolated serve.generate
     decode (float32 cache, 1e-4); (f) the loop's decode tok/s and its
     decode step's device time (its graph replayed, by CUDA events and
     torch.profiler) against its median host-clock step;
  7c. the training loss and its gradient at full width: one worker's
     loss_fn and torch.autograd.grad over every parameter on batches from
     LMWorkerPipeline, qwen3-0.6b and rwkv6-7b at batch 2 x 128 and at
     [1, 4096] with remat, with B6's and B7's plain versions made to
     raise on the card: per gradient one forward launch a layer (two with
     remat) and one backward launch a layer, the loss bit-equal to the
     no_grad forward's, every gradient finite; host ms (median of 3),
     peak memory and device ms by kernel group (torch.profiler); then the
     card against the host CPU at full width cut to 2 layers (batch 1 x
     80): the loss within 1e-5, each leaf's gradient within 1e-4 of its
     largest |g|;
  7d. the BrSGD train step (training/step.py) at qwen3-0.6b's full
     width through its entry point, launch.train.main (m = 20 workers
     of 2 x 128 tokens, brsgd under sign_flip at 0.25, adamw, a
     checkpoint and telemetry rows into a temporary directory under
     build/, removed after), B6's and B7's plain versions refusing the
     card: a warm-up and 3 timed steps, each exactly 1 brsgd launch, 560
     B6 launches and 560 B6-bwd calls and nothing else, no gradient input
     copied; host ms (median of 3), its split by CUDA events (gradients,
     attack, aggregate, norm and update) and the peak memory, below the
     card's; on the last step's G the launch's scores (exact) and l1
     (1e-5) against plain statistics summed over column blocks of 2^22,
     its selection and 𝔗 against the plain rule on its own statistics,
     its aggregate bit-equal to masked_mean_det on sampled blocks; then
     two guarded steps under the supervisor (quorum 20, a nan_burst on
     worker 7): the first held with params the input's bits and worker 7
     evicted, the second ok on 19 workers (a quorum shrink); then card =
     CPU for qwen3-0.6b cut to 2 layers and rwkv6-7b reduced at 4
     workers (per-worker gradient rows 1e-4 of each leaf's largest |g|,
     scores and masks of one G on both exact, the loss 1e-5, params 1e-4
     of the largest |Δp| at lr 1; the card's step with the plain versions
     refusing the card, 1 brsgd launch and one B6 or B7 forward and
     backward launch a layer a worker);
  7e. the zoo configs at full width: serve.main for qwen3-1.7b (28
     layers), minicpm3-4b (62 layers of MLA on B6's (96, 64) instance)
     and nemotron-4-15b (32 layers, 62.5 GB of weights, last: the cache
     emptied first), batch 4, prompt 512, 16 tokens, 2 passes, B6 once a
     layer a prefill and never in decode; then the MoE segment through
     the launcher's single-shot function at full width cut to 4 layers:
     dbrx-132b (57.08 GB of weights) and deepseek-v2-236b (its dense
     layer and 3 moe layers, B6's (192, 128) instance, 53.21 GB), each
     alone on the card; each card against the host CPU at full width cut
     to 2 layers over a float32 and a bfloat16 cache (nemotron at batch 1
     x 32, the float32 cache alone; dbrx at one layer and deepseek-v2 at
     2, at 1 x 32 over a float32 cache, at the configs' capacity factor);
     minicpm3-4b through the serve loop (4 requests on 4 slots: one
     decode graph, 62 B6 launches an admission, B6 held on the loop's own
     prefill inputs, tokens equal to the batch-1 decode but for a near
     tie), and deepseek-v2 at 4 layers with lossless dispatch
     (capacity_factor = E / k) the same way; qwen3-1.7b's train step at
     full width through launch.train.main (m = 4, 2 x 128 tokens, brsgd
     under sign_flip at 0.25, adamw: a warm-up and 3 timed steps, each 1
     brsgd launch, 112 B6 and 112 B6-bwd launches and nothing else, host
     ms, split, peak memory); one worker's gradient at [2, 128] of dbrx
     at one layer and deepseek-v2 at 2 (full width; one B6 and one B6-bwd
     launch a layer, host ms, device ms by group, peak memory); card =
     CPU steps of minicpm3-4b and deepseek-v2 (the reduced models with
     their MLA head widths), nemotron-4-15b and dbrx-132b reduced;
  7g. mamba2 and the hybrid segment, and the prefix frontends, at full
     width and full depth: zamba2-2.7b (54 mamba2 layers in 9 units, the
     shared block on B6's (80, 80) instance once a unit) through
     serve.main, phi-3-vision-4.2b (B6's (96, 96) instance) and
     musicgen-large through serve.generate with their seeded prefix (576
     / 64 embeddings), batch 4, prompt 512, 16 tokens, 2 passes, B6 once
     an attention application a prefill and never in decode; card = CPU
     over a float32 cache with 4 decode steps (zamba2 cut to one unit at
     [1, 300]: a 256-token chunk and a ragged tail; the frontends at 2
     layers, [1, 32] with the prefix); zamba2's prefill == its
     sequential decode on the card (reduced); zamba2 through the serve
     loop (4 requests on 4 slots, one decode graph, tokens equal to the
     batch-1 decode but for a near tie); then, after the BrSGD libraries
     are built, one worker's gradient at full width, every leaf finite
     (zamba2 at [2, 128], where the reference's mamba2 gradient is NaN,
     and at [1, 4096] with remat; the frontends at [2, 128] with their
     prefix; one B6 and one B6-bwd launch an attention application, two
     B6 with remat), host ms, device ms by group, the SSD's device time
     a layer, peak memory; zamba2's train step through launch.train.main
     (m = 4 workers of 2 x 128, brsgd under sign_flip at 0.25, sgd: a
     warm-up and 3 timed steps, each 1 brsgd launch and 36 B6 and 36
     B6-bwd launches, the launch held on column blocks); card = CPU
     steps of the three at reduced() (the frontends with their 8 prefix
     embeddings);
  7h. the blocked scope on one card (training/step.py, agg_scope
     "blocked": every bucket aggregated inside one layer-major backward,
     core/blocked.py): qwen3-0.6b at full width through
     launch.train.main (m = 20 workers of 2 x 128, brsgd under sign_flip
     at 0.25, adamw, --agg-scope blocked --remat block): a warm-up and 3
     timed steps, each 29 brsgd launches (28 layer buckets and the top),
     1,120 B6 (remat) and 560 B6-bwd launches and nothing else, every
     aggregate finite, at most two buckets' rows live at once (the top
     one and one layer's: the lockstep of the layer-major backward), the
     plain versions of B6 / B7 and of the aggregation refusing the card;
     host ms (median), the timed steps'
     peak memory (below phase 7d's global-scope peak), n_selected and
     n_selected_min; on the warm-up, the last layer's bucket held against
     the plain brsgd on its rows (scores, 𝔗, masks exact, l1 within
     1e-5, the aggregate bit-equal) and the top bucket's [20, 155.6M]
     launch on column blocks as in 7d; rwkv6-7b at full width (m = 4,
     sgd): a warm-up and 1 timed step, 33 brsgd, 256 B7 and 128 B7-bwd
     launches a step, every aggregate finite, host ms and peak memory;
     card = CPU at m = 4 (qwen3-0.6b cut to 2 layers under brsgd, reduced
     under median and krum; rwkv6-7b reduced under brsgd): every bucket's
     selection, n_selected and n_selected_min exact, the loss within
     1e-5, params within 1e-4 of the largest |Δp|, one aggregation
     launch a bucket;
     a guarded blocked step under the supervisor (qwen3-0.6b cut to 2
     layers, m = 8, a nan_burst on worker 7): held with params the
     input's bits and worker 7 evicted, then ok on 7 workers, one masked
     combine a bucket; each sub-phase's seconds;
  7i. the torch.distributed layouts (launch/mesh.py, engine's
     aggregate_sharded, threat.inject, build_train_step(mesh=)) through
     their entry point, launch.train.main --mesh (its rank function
     wrapped to time and count): 4 ranks spawned in one gloo group on
     the one card (NCCL refuses two ranks on one device; gloo takes the
     CUDA tensors), one rank a worker, qwen3-0.6b at full width, 2 x 128
     tokens a worker, brsgd under sign_flip at 0.25, sgd: the flat mesh
     of 4 under gather and under a2a, the 2 x 2 data x model mesh under
     a2a, a warm-up and 2 timed steps each; on every step of every rank:
     on cuda:0 and every collective's tensor a CUDA one; the
     aggregation's all_gather / all_to_all counts equal
     engine.expected_collectives; the statistics kernel once a leaf and
     B6 / B6-bwd once a layer, nothing else, the plain versions refusing
     the card; on the warm-up the post-attack G gathered once into rank
     0 and the step's scores and selection equal to aggregate_local's on
     it, the aggregate within 1e-6 of max|agg| (the check's launch,
     gathers and time taken out of the step's); the launches summed
     over every step and rank; host ms a step (median of 2), its split
     (gradient, inject, collectives, statistics kernels, combine,
     update), bytes each rank sends, each rank's peak and the card's
     used GB; then card = CPU at the reduced config (launch.train.main
     --reduced: 4 card ranks against 4 CPU ranks from the same params,
     params within 1e-5 of max|Δp|);
  7f. the demo twins on the card: paper.train_100m --full for 3 steps
     (the ~100M qwen3 config, m = 8 workers of 4 x 512 tokens; 1 brsgd,
     96 B6 and 96 B6-bwd launches a step; the loss falls),
     paper.serve_demo --train-and-serve (8 requests across a hot swap,
     the last checkpoint served), paper.byzantine_lenet at 20 steps,
     each held to its launches;
  8. timing with CUDA events (bare kernel launch, wrapper call, plain
     version, one library call) and each bare kernel's device time
     (torch.profiler) at [20, 61706] and [20, 8388608] (the fused select
     launch, and at [20, 8388608] the column pass, first held against
     their plain versions on those inputs), the
     fused brsgd launch against the two-pass composition in turns (it
     must not be slower) and on a sweep of grids; the fused select launch
     of each gram rule; B6 at
     its serve shape and at S = 4096 beside SDPA, with its FP32-pipe and
     3xTF32 tensor-core bounds, and its (96, 64) instance at minicpm3-4b's
     prefill and at S = 4096, its (192, 128) instance at deepseek-v2's
     prefill and at S = 4096 (SDPA on the same unequal widths) and its
     (96, 96) instance at phi-3-vision's prefill [4, 32, 32, 1088] and
     at S = 4096; B7 per
     layer launch at [4, 512, 64, 64]
     and its one-chunk call; B6's backward at [2, 16, 8, 128, 128] and
     [1, 16, 8, 4096, 128] beside the backward of SDPA (its kernels'
     registers, spills, shared memory and CTAs an SM first), and its
     (96, 64) instance at [4, 40, 40, 512] and [1, 40, 40, 4096], its
     (192, 128) instance at [2, 128, 128, 128] and [1, 128, 128, 4096],
     its (96, 96) instance at [2, 32, 32, 704] and [1, 32, 32, 4096],
     B7's (its
     four kernels, each timed too, its CTAs an SM and shared memory
     first) at [2, 128, 64, 64], [2, 128, 64, 32] and [1, 4096, 64, 64],
     with the bytes its design moves beside the bound, each with the
     plain versions' autograd backward; every BrSGD kernel's device time at m = 10, 12,
     16, 32, 33, 63 and 64 (12, 33 and 63 on bucket instances) at d =
     61706 and 8388608;
  9. the {"gradient": [...]}, {"train": {...}}, {"blocked": {...}},
     {"sharded": {...}},
     {"zoo": ..., "demos": ...},
     {"hybrid_frontends": {...}},
     {"phase_seconds": {...}} and {"kernels": [...]} lines (a
     {"phase": ..., "seconds": ...} line also ends each phase), the
     nvidia-smi line, and last the {"ok": true, "device": {...}} line.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
TF32_SPLIT = 3                # 3xTF32: three TF32 products per float32 one
MAIN_SHAPE = (20, 61706)      # LeNet: m = 20 workers, d = 61,706 params
HBM_SHAPE = (20, 8_388_608)   # G = 671 MB, well past the 50 MB L2
# the main path's shape, a ragged one, the largest instance, and the
# shapes paper.robustness ([M, REG_D]) and paper.rate (m = 10) launch at
CHECK_SHAPES = (MAIN_SHAPE, (7, 1003), (64, 4096), (20, 20), (10, 20))
HOST_REPS = 50               # host-clock samples per step timing
REL_TOL = 1e-5                # float outputs, relative to the largest |ref|
SOURCE = "src/repro_torch/kernels/csrc/brsgd_stats.cu"
REPLACES = {
    "fused_stats": "src/repro/kernels/brsgd_stats.py:199",
    "select_mean": "src/repro/kernels/brsgd_stats.py:258",
    "masked_mean": "src/repro/kernels/brsgd_stats.py:289",
    "brsgd_stats": "src/repro/kernels/brsgd_stats.py:150",
    # cwise_median_pallas, which keeps the median of B4's pallas_call
    "cwise_median": "src/repro/kernels/brsgd_stats.py:302",
    "trimmed_mean": "src/repro/kernels/brsgd_stats.py:327",
    # B1's brsgd call (brsgd_partials_pallas, pallas_call at :199) and B2
    "brsgd_aggregate": "src/repro/kernels/brsgd_stats.py:258",
    # B1's gram call (fused_stats_pallas, :199) and B3 (:289)
    "select_aggregate": "src/repro/kernels/brsgd_stats.py:199",
}
ALSO_REPLACES = {"brsgd_aggregate": ["src/repro/kernels/brsgd_stats.py:199"],
                 "select_aggregate": ["src/repro/kernels/brsgd_stats.py:289"]}
# the gram rules of the fused select launch
GRAM_RULES = ("krum", "multi_krum", "geomedian")
# B1's needs that take the column pass (every subset without gram), and
# gram + d2med (geomedian's call), which takes the gram kernel
COLUMN_SUBSETS = (("scores",), ("l1",), ("d2med",), ("scores", "l1"),
                  ("scores", "d2med"), ("l1", "d2med"),
                  ("scores", "l1", "d2med"), ("d2med", "gram"))
# the fused brsgd launch: a shape whose G does not stay in shared memory
NONRESIDENT_SHAPE = (20, 2_000_003)
# non-finite workers left out by the rules: resident, not resident, and
# two bucket instances (16 and 64 rows)
NONFINITE_SHAPES = ((20, 61706), NONRESIDENT_SHAPE, (12, 61706), (33, 61706))
# (beta, threshold / d): the paper's auto rule at two betas, C1 emptied
# (the C2 fallback), and a given 𝔗 that keeps about half of N(0, 1) rows
# (their l1 to the median is ~0.8 d)
FUSED_CASES = ((0.5, 0.0), (0.25, 0.0), (0.5, 1e-9), (0.5, 0.4))
# the kernels each main-path run launches, once a step
MAIN_PATH_KERNELS = {"mean": {"masked_mean"}, "brsgd": {"brsgd_aggregate"},
                     "median": {"cwise_median"},
                     "krum": {"select_aggregate"},
                     "trimmed_mean": {"trimmed_mean"},
                     "multi_krum": {"select_aggregate"},
                     "geomedian": {"select_aggregate"}}
SEQ_KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:79"),
    "wkv6_seq": ("src/repro_torch/kernels/csrc/wkv6.cu",
                 "src/repro/kernels/wkv6.py:69"),
}
# B6 cases (B, H, Hkv, S, D, window, dtype name): the qwen3-0.6b prefill
# (batch 4 single shot; batch 1 at the serve loop's 512 and 256 buckets),
# a ragged S, a window, D = 64 and 80, bfloat16; D = 96 (phi-3-vision-
# 4.2b) at its prefill of 576 patches and 512 tokens in both types, a
# ragged S in GQA groups, a window, batch 1
FLASH_CASES = ((4, 16, 8, 512, 128, 0, "float32"),
               (1, 16, 8, 512, 128, 0, "float32"),
               (1, 16, 8, 256, 128, 0, "float32"),
               (1, 16, 8, 200, 128, 0, "float32"),
               (1, 16, 8, 512, 128, 64, "float32"),
               (2, 8, 4, 300, 64, 0, "float32"),
               (1, 8, 8, 256, 80, 0, "float32"),
               (4, 16, 8, 512, 128, 0, "bfloat16"),
               (2, 4, 4, 5, 64, 0, "float32"),
               (1, 2, 2, 5, 128, 0, "bfloat16"),
               (1, 16, 2, 129, 128, 0, "float32"),
               (1, 8, 1, 191, 128, 100, "float32"),
               (1, 4, 2, 65, 80, 0, "bfloat16"),
               (2, 8, 4, 300, 64, 48, "bfloat16"),
               (4, 32, 32, 1088, 96, 0, "float32"),
               (4, 32, 32, 1088, 96, 0, "bfloat16"),
               (2, 8, 4, 211, 96, 0, "float32"),
               (2, 8, 4, 1000, 96, 48, "float32"),
               (1, 32, 32, 600, 96, 0, "float32"))
FLASH_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (1e-2, 1e-2)}  # rtol, atol
# B6's MLA instances (B, H, Hkv, S, D, Dv, window, dtype name): (96, 64)
# at minicpm3-4b's prefill [4, 40, 40, 512] in both types, one train_4k
# sequence, a ragged S in GQA groups, a window; (192, 128) at
# deepseek-v2's prefill [4, 128, 128, 512] in both types (the float32
# instance on its own 32-row key tile), the serve loop's batch 1, a
# ragged S past a key tile of either width, a window; held to the B6
# rows' FLASH_TOL
MLA_FLASH_CASES = ((4, 40, 40, 512, 96, 64, 0, "float32"),
                   (4, 40, 40, 512, 96, 64, 0, "bfloat16"),
                   (1, 40, 40, 4096, 96, 64, 0, "float32"),
                   (2, 8, 4, 211, 96, 64, 0, "float32"),
                   (2, 8, 4, 1000, 96, 64, 48, "float32"),
                   (1, 40, 40, 200, 96, 64, 64, "bfloat16"),
                   (4, 128, 128, 512, 192, 128, 0, "float32"),
                   (4, 128, 128, 512, 192, 128, 0, "bfloat16"),
                   (1, 128, 128, 300, 192, 128, 0, "float32"),
                   (2, 8, 4, 211, 192, 128, 0, "float32"),
                   (2, 8, 4, 1000, 192, 128, 48, "float32"),
                   (1, 16, 16, 97, 192, 128, 0, "bfloat16"),
                   (1, 16, 16, 200, 192, 128, 64, "bfloat16"))
# B7 cases (B, H, Q, K, log-decay range): rwkv6-7b's chunk with w in
# (e^-1, 1), w down to e^-3, a ragged last chunk, K = 32
WKV_CASES = ((4, 64, 64, 64, 1.0), (4, 64, 64, 64, 3.0),
             (4, 64, 40, 64, 1.0), (4, 32, 64, 32, 1.0))
# wkv6_seq (the layer call): prompt lengths, K, log-decay ranges
WKV_SEQ_S = (1, 63, 64, 65, 512)
WKV_SEQ_K = (32, 64)
# (B, H, S, K): the serve loop's rwkv6-7b prefill, batch 1 at all 64
# heads, a ragged prompt length and a whole number of chunks
WKV_SEQ_SERVE = ((1, 64, 300, 64), (1, 64, 512, 64))
WKV_TOL = (2e-5, 1e-5)        # y, S_out: relative to the largest |plain|
# B6's backward (B, H, Hkv, S, D, window): the launcher's train shape, one
# train_4k sequence, the prefill shape, a ragged S with a window, D = 64
# and 80, S = 5, S one past two streamed tiles of 16 rows (33), one past a
# CTA's 64 rows (65) and two (129), groups 1, 2 and 8; D = 96 at
# phi-3-vision-4.2b's gradient shape (2 x 128 tokens after 576 patches),
# S = 5, 65, 129 and a window
FLASH_BWD_CASES = ((2, 16, 8, 128, 128, 0), (1, 16, 8, 4096, 128, 0),
                   (4, 16, 8, 512, 128, 0), (1, 16, 8, 200, 128, 64),
                   (2, 8, 4, 300, 64, 0), (1, 8, 8, 256, 80, 0),
                   (2, 4, 4, 5, 64, 0), (1, 4, 2, 33, 64, 0),
                   (1, 16, 2, 65, 128, 0), (1, 8, 1, 129, 128, 100),
                   (1, 16, 16, 97, 80, 0),
                   (2, 32, 32, 704, 96, 0), (2, 4, 4, 5, 96, 0),
                   (1, 16, 2, 65, 96, 0), (1, 8, 1, 129, 96, 0),
                   (1, 8, 4, 300, 96, 64))
# dq, dk, dv: relative to the largest |plain| of each (3xTF32 against the
# plain float32 autograd).  The error grows with the keys a row sums over:
# on an H100 80GB HBM3 the first (mma.sync) kernel's largest of the three
# read 3.9e-6 at S = 128, at most 8.0e-6 for the other cases below S =
# 512, 1.3e-5 at S = 512 and 8.2e-5 at S = 4096; the wgmma kernel, whose
# two warpgroups each sum half the tiles, 4.6e-5 at S = 4096; the same
# bits in every run (seeded inputs, a deterministic kernel).  So each case
# is held to 2e-5 + 2e-8 per key, never above FLASH_BWD_TOL.
FLASH_BWD_TOL = 1e-4
# B6-bwd's MLA instances (B, H, Hkv, S, D, Dv, window), at the per-S
# limit of the B6-bwd rows: (96, 64) at minicpm3-4b's prefill shape, one
# train_4k sequence, a ragged S in GQA groups, a window; (192, 128) at
# deepseek-v2's gradient shape [2, 128, 128, 128], one train_4k sequence
# of 16 heads, a ragged S in GQA groups, a window, S = 5 and one past a
# CTA's 64 rows
MLA_FLASH_BWD_CASES = ((4, 40, 40, 512, 96, 64, 0),
                       (1, 40, 40, 4096, 96, 64, 0),
                       (2, 8, 4, 211, 96, 64, 0),
                       (2, 8, 4, 1000, 96, 64, 48),
                       (2, 128, 128, 128, 192, 128, 0),
                       (1, 16, 16, 4096, 192, 128, 0),
                       (2, 8, 4, 211, 192, 128, 0),
                       (2, 8, 4, 1000, 192, 128, 48),
                       (2, 4, 4, 5, 192, 128, 0),
                       (1, 16, 2, 65, 192, 128, 0))


def _flash_bwd_tol(S: int) -> float:
    return min(FLASH_BWD_TOL, 2e-5 + 2e-8 * S)


# B7's backward (B, S, H, K, log-decay range): rwkv6-7b's train shape and
# one train_4k sequence, S around one chunk, K = 32; w in (e^-1, 1) and
# down to e^-3 (the clamps bite); from a nonzero state, with a given
# dS_final (and without one where S <= 130)
WKV_BWD_CASES = ((2, 128, 64, 64, 1.0), (2, 128, 64, 64, 3.0),
                 (1, 4096, 64, 64, 1.0), (2, 1, 8, 64, 1.0),
                 (2, 63, 8, 64, 1.0), (2, 64, 8, 64, 3.0),
                 (2, 65, 8, 64, 1.0), (2, 130, 8, 32, 1.0),
                 (2, 130, 8, 32, 3.0))
WKV_BWD_TOL = 2e-5            # each gradient, relative to its largest |plain|
# B6's and B6-bwd's timing rows (label, (B, H, Hkv, S, D, Dv)): the
# qwen3-0.6b serve / train shape and one train_4k sequence, MLA's (96, 64)
# instance at minicpm3-4b's prefill and at one train_4k sequence, and the
# (192, 128) instance at deepseek-v2's prefill (forward), its gradient
# shape (backward) and one train_4k sequence of its 128 heads; the
# (96, 96) instance at phi-3-vision's prefill (forward), its gradient
# shape (backward) and one train_4k sequence
FLASH_TIMING = (("serve", (4, 16, 8, 512, 128, 128)),
                ("long", (1, 16, 8, 4096, 128, 128)),
                ("mla", (4, 40, 40, 512, 96, 64)),
                ("mla_long", (1, 40, 40, 4096, 96, 64)),
                ("ds", (4, 128, 128, 512, 192, 128)),
                ("ds_long", (1, 128, 128, 4096, 192, 128)),
                ("phi", (4, 32, 32, 1088, 96, 96)),
                ("phi_long", (1, 32, 32, 4096, 96, 96)))
FLASH_BWD_TIMING = (("train", (2, 16, 8, 128, 128, 128)),
                    ("long", (1, 16, 8, 4096, 128, 128)),
                    ("mla", (4, 40, 40, 512, 96, 64)),
                    ("mla_long", (1, 40, 40, 4096, 96, 64)),
                    ("ds", (2, 128, 128, 128, 192, 128)),
                    ("ds_long", (1, 128, 128, 4096, 192, 128)),
                    ("phi", (2, 32, 32, 704, 96, 96)),
                    ("phi_long", (1, 32, 32, 4096, 96, 96)))
# the label prefix of each added instance's timing rows (MLA's, and
# phi-3-vision's (96, 96))
INSTANCE_LABELS = {"96x64": "mla", "192x128": "ds", "96x96": "phi"}
# B7's backward kernels by a part of their names; a tree from before the
# chunk-parallel design (a parent's, for --kernel-times) has one kernel
WKV_BWD_PARTS = (("wkv6_bwd_carry",), ("wkv6_bwd_scan",),
                 ("wkv6_bwd_chunk",), ("wkv6_bwd_du",))
WKV_BWD_PARTS_BEFORE = (("wkv6_seq_bwd_kernel",),)
# its timing rows (label, (B, S, H, K)), chunk 64: the launcher's train
# shape at K 64 and 32, one train_4k sequence
WKV_BWD_TIMING = (("train", (2, 128, 64, 64)), ("train_k32", (2, 128, 64, 32)),
                  ("long", (1, 4096, 64, 64)))
BWD_KERNELS = {
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/layers.py:109 (_sdpa: no Pallas kernel, the JAX "
        "package lets XLA differentiate the plain jnp attention)"),
    "wkv6_seq_bwd": (
        "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
        "src/repro/models/rwkv6.py:100 (_wkv_chunked: no Pallas kernel, the "
        "JAX package lets XLA differentiate the plain jnp scan)"),
}
# the full-width gradient (arch, batch, seq, remat): the JAX launcher's
# defaults (batch 2 x seq 128) and one train_4k sequence with remat
GRAD_CASES = (("qwen3-0.6b", 2, 128, False), ("qwen3-0.6b", 1, 4096, True),
              ("rwkv6-7b", 2, 128, False), ("rwkv6-7b", 1, 4096, True))
GRAD_REPS = 3                 # timed gradients per case (median), the
                              # first also checked
GRAD_KERNELS = {"dense": ("flash_attention", "flash_attention_bwd"),
                "moe": ("flash_attention", "flash_attention_bwd"),
                "hybrid": ("flash_attention", "flash_attention_bwd"),
                "rwkv": ("wkv6_seq", "wkv6_seq_bwd")}
# card = CPU at full width cut to 2 layers, batch 1 x 80 (two rwkv chunks,
# the second ragged): the loss relative, each leaf's gradient relative to
# its largest |g|
GRAD_CPU_LAYERS, GRAD_CPU_SEQ = 2, 80
GRAD_CPU_TOL = (1e-5, 1e-4)
# the train step at full width (phase 7d): qwen3-0.6b, m = 20 (the paper's
# m) workers of the JAX launcher's 2 x 128 tokens, brsgd under sign_flip
# at 0.25 (workers 0-4 byzantine), adamw; TRAIN_STEPS timed steps after a
# warm-up
TRAIN_ARCH, TRAIN_M, TRAIN_B, TRAIN_S = "qwen3-0.6b", 20, 2, 128
TRAIN_STEPS = 3
TRAIN_ATTACK = {"attack": "sign_flip", "alpha": 0.25}
# the launch held on the step's G: plain statistics over blocks of this
# many columns ([20, 4194304] floats, 336 MB, a few such temporaries for
# the sorting network), the aggregate on sampled blocks of
# TRAIN_SAMPLE_COLUMNS (the first, the last, and random ones)
TRAIN_CHECK_BLOCK = 1 << 22
TRAIN_SAMPLE_BLOCKS, TRAIN_SAMPLE_COLUMNS = 4, 1 << 16
TRAIN_FAULT_WORKER = 7        # an honest worker's NaN burst (supervisor)
# card = CPU: qwen3-0.6b at full width cut to 2 layers (D = 187 M); rwkv6-7b
# in its reduced form (2 layers, d 256): cut to 2 layers at full width its
# D is 0.98 B, and the CPU's plain sorting network over [m, D] would take
# tens of GB of host memory
TRAIN_CPU_CASES = (("qwen3-0.6b", 2), ("rwkv6-7b", None))
TRAIN_CPU_M = 4
TRAIN_CPU_PARAM_TOL = 1e-4    # params, relative to the largest |Δp| (lr 1)
SERVE_ARCHS = ("qwen3-0.6b", "rwkv6-7b")
# the zoo configs at full width (phase 7e): single-shot serve, nemotron
# last so that its 62.5 GB of weights meet no other arch's; card = CPU at
# 2 layers (batch, prompt): nemotron's 256,000 x 6144 head on a short
# prompt (its CPU forward at [2, 80] is ~6x the work)
ZOO_SERVE_ARCHS = ("qwen3-1.7b", "minicpm3-4b", "nemotron-4-15b")
ZOO_SERVE_ARGS = ("--batch", "4", "--prompt-len", "512", "--gen", "16",
                  "--repeat", "2")
ZOO_CPU_SHAPES = {"qwen3-1.7b": (2, 80), "minicpm3-4b": (2, 80),
                  "nemotron-4-15b": (1, 32)}
# the caches each is held over: nemotron's CPU decode reads its 15.7 GB of
# 2-layer weights a step, so it takes the float32 cache (SERVE_TOL) alone
ZOO_CPU_CACHES = {"qwen3-1.7b": ("float32", "bfloat16"),
                  "minicpm3-4b": ("float32", "bfloat16"),
                  "nemotron-4-15b": ("float32",)}
ZOO_CPU_STEPS = 4
# minicpm3-4b through the serve loop at full width: 4 requests on 4 slots
ZOO_LOOP_ARCH = "minicpm3-4b"
ZOO_LOOP_ARGS = ("--requests", "4", "--max-batch", "4", "--prompt-len",
                 "512", "--gen", "8")
# qwen3-1.7b's train step at full width through launch.train.main: m = 4
# (G 27.5 GB beside params, m, v, the aggregate and one worker's gradient)
ZOO_TRAIN_ARCH, ZOO_TRAIN_M = "qwen3-1.7b", 4
# card = CPU steps: minicpm3-4b's reduced model with its full MLA head
# widths (q/k 64 + 32, v 64: the reduced widths, 48 and 32, have no B6
# instance; cut to 2 layers at full width, D = 0.5 B, the CPU's plain
# aggregation of G [4, D] took 74 s of the script); nemotron-4-15b
# reduced: cut to 2 layers at full width its D is 3.9 B, and G [4, D]
# alone (63 GB) with params and sgd's state does not fit the card
# dbrx-132b reduced (head 64); deepseek-v2-236b reduced with its own MLA
# head widths (q/k 128 + 64, v 128: its reduced widths, 48 and 32, have
# no instance)
ZOO_TRAIN_CPU_CASES = (("minicpm3-4b", "mla_heads"), ("nemotron-4-15b", None),
                       ("dbrx-132b", None), ("deepseek-v2-236b", "mla_heads"))
# the MoE configs at full width cut in depth (phase 7e): dbrx-132b's 40
# layers and deepseek-v2-236b's 60 hold 526 GB and 943 GB of float32
# weights; 4 layers (deepseek-v2: its dense layer and 3 moe layers) hold
# 57.08 and 53.21 GB.  Each is served alone, the cache emptied first.
MOE_ARCHS = ("dbrx-132b", "deepseek-v2-236b")
MOE_SERVE_LAYERS = 4
# card = CPU at the config's capacity factor (1.25) on the same batch, at
# full width cut to one moe layer (deepseek-v2: with its dense layer), 17.97
# and 21.43 GB on each device: (batch, prompt), a float32 cache
MOE_CPU_LAYERS = {"dbrx-132b": 1, "deepseek-v2-236b": 2}
MOE_CPU_SHAPE = (1, 32)
# deepseek-v2 through the serve loop at 4 layers: 4 requests on 4 slots.
# The loop decodes every slot, empty ones included, and prefills each
# admission at batch 1 (in both packages), and a moe layer's capacity is
# that of the tokens of its call: the loop's tokens can equal the batch-1
# decode only where dispatch is lossless, so the loop runs at
# capacity_factor = E / k (tests/test_moe_ssm.py's lossless setting)
MOE_LOOP_ARCH = "deepseek-v2-236b"
MOE_LOOP_ARGS = ("--requests", "4", "--max-batch", "4", "--prompt-len",
                 "512", "--gen", "8")
# one worker's gradient at full width at [2, 128]: dbrx-132b cut to 1
# layer (~36 GB with its gradient), deepseek-v2 to 2 (~43 GB)
MOE_GRAD_LAYERS = {"dbrx-132b": 1, "deepseek-v2-236b": 2}
MOE_GRAD_SHAPE = (2, 128)
# mamba2 / the hybrid segment and the prefix frontends at full width and
# full depth (phase 7g): 9.69, 15.28 and 12.92 GB of float32 weights
HYBRID_ARCH = "zamba2-2.7b"
PREFIX_ARCHS = ("phi-3-vision-4.2b", "musicgen-large")
# card = CPU over a float32 cache, 4 decode steps: (layers, batch,
# prompt); zamba2 cut to one unit (6 mamba2 layers and the shared block)
# at 300 tokens, a 256-token chunk and a ragged tail
HF_CPU_CASES = {"zamba2-2.7b": (6, 1, 300), "phi-3-vision-4.2b": (2, 1, 32),
                "musicgen-large": (2, 1, 32)}
HF_LOOP_ARGS = ("--requests", "4", "--max-batch", "4", "--prompt-len",
                "512", "--gen", "8")
# one worker's gradient (arch, batch, seq, remat): [2, 128] each (the
# frontends with their prefix, 704 / 192 positions), zamba2 also one
# train_4k sequence with remat (16 chunks of 256)
HF_GRAD_CASES = (("zamba2-2.7b", 2, 128, False), ("zamba2-2.7b", 1, 4096, True),
                 ("phi-3-vision-4.2b", 2, 128, False),
                 ("musicgen-large", 2, 128, False))
# zamba2's train step: m = 4 (params 9.69 + G 38.76 + the aggregate and
# one worker's gradient, 9.69 GB each), sgd (adamw's m and v, 19.4 GB
# more, do not fit beside them)
HF_TRAIN_M, HF_TRAIN_OPTIMIZER = 4, "sgd"
# the demo twins (phase 7f): train_100m --full for DEMO_100M_STEPS steps
DEMO_100M_STEPS = 3
DEMO_LENET_STEPS = 20         # byzantine_lenet's table (its default is 60)
SERVE_ARGS = ("--batch", "4", "--prompt-len", "512", "--gen", "16",
              "--repeat", "3")
SERVE_TOL = 1e-4              # logits, relative to the largest |logit|
# the serve loop at full width (serve.main --serve-loop): qwen3-0.6b from a
# port checkpoint, with the hot swap and the faults; rwkv6-7b from --seed
# (each request is checked against the loop serving it alone and its
# batch-1 decode twice).  Each stream holds more requests than slots, so
# a second wave is admitted into used slots under the captured decode
# graph (qwen3's K/V, rwkv6's wkv state and carries written over a used
# slot).  The streams were 16 x 32 and 8 x 16 tokens before the gradient
# phase joined the script; to keep its time they are cut in tokens, not
# in requests.
SERVE_LOOP_ARGS = {
    "qwen3-0.6b": ("--requests", "12", "--max-batch", "8", "--prompt-len",
                   "512", "--gen", "8"),
    "rwkv6-7b": ("--requests", "6", "--max-batch", "4", "--prompt-len",
                 "512", "--gen", "6"),
}
SWAP_ARCH = "qwen3-0.6b"
SWAP_REQUESTS, SWAP_GEN, SWAP_AT = 4, 8, 4    # negated params after step 4
# the swap and the faults publish and restore checkpoints: at 28 layers
# (2.38 GB) their I/O was most of the sub-phase's 42 s
SWAP_LAYERS = 4
# (e): a slot stalled for FAULT_STALL ticks, requeued after FAULT_TIMEOUT
FAULT_REQUESTS, FAULT_GEN, FAULT_STALL, FAULT_TIMEOUT = 6, 8, 12, 4
# a greedy token may differ from its reference only where the reference's
# top-two logits lie within NEAR_TIE of its max|logit| (float32 cache;
# over the bfloat16 cache the margin is BF16_CACHE_TOL)
NEAR_TIE = 1e-4
BF16_CACHE_TOL = 1e-2         # decode logits over a bfloat16 cache, the same
TRIM_FRACS = (0.1, 0.25, 0.49, 0.5)   # 0.5 takes trim_k's 2k >= m guard
LIBRARY_CALLS = {
    "fused_stats": None, "brsgd_aggregate": None, "select_aggregate": None,
    "select_mean": "w @ G / w.sum()",
    "masked_mean": "w @ G / w.sum()",
    "brsgd_stats": "torch.quantile(G, 0.5, dim=0)",
    "cwise_median": "torch.quantile(G, 0.5, dim=0)",
    "trimmed_mean": "sort + mean, 2 calls",
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no card to run on")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's package is missing under {SRC}: run this script "
             f"from a checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvidia-smi=[{smi_line}]", flush=True)
    return smi_line


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

# the libraries of B6, B7 and their backward kernels: they build in
# seconds, the two BrSGD libraries in minutes, so the sequence phases run
# while those still compile
SEQ_LIBS = ("flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd")


def phase_build_start():
    """Starts one nvcc per source, all at once; returns the pending
    builds (``_build.Builds``)."""
    from repro_torch.kernels import _build
    return _build.Builds()


def phase_build_wait(builds, names):
    """Waits for the libraries ``names`` and loads them."""
    from repro_torch.kernels import _build
    for name in builds.wait(names):
        _build.load(name)


def phase_build(builds, t_start):
    """Waits for every library, then the SASS checks and the ptxas
    report."""
    from repro_torch.kernels import _build
    paths = builds.wait()
    for name in paths:
        _build.load(name)
    secs = time.perf_counter() - t_start
    phase_sass(paths)
    libs = ", ".join(str(p.relative_to(ROOT)) for p in paths.values())
    print(f"build: {libs} done {secs:.1f} s after the start (one nvcc per "
          f"source, in parallel)", flush=True)
    if not _build.BUILD_LOGS:
        print("build: ptxas report not measured (libraries reused from an "
              "earlier build)", flush=True)
        return
    spills = 0
    column = {}
    for lib, log in _build.BUILD_LOGS.items():
        for fn, r in _ptxas_entries(log).items():
            spills += r["spill_bytes"]
            print(f"  ptxas {lib} {fn}: {r['registers']} registers, "
                  f"{r['smem']} B smem, {r['stack']}", flush=True)
            v = re.search(r"column_stats_kernelILi20ELi(\d+)E", fn)
            if v and lib == "brsgd_stats":
                column[int(v.group(1))] = {
                    "registers": r["registers"],
                    "spill_bytes": r["spill_bytes"]}
    print(f"build: spill bytes over all kernels = {spills}", flush=True)
    # the column pass's instances at m = 20 by variant (B1's needs bits;
    # 19 = B4; 16 = the median alone): registers and spill bytes
    emit({"check": "column_pass_ptxas", "m": 20, "instances": column,
          "spill_bytes": sum(c["spill_bytes"] for c in column.values())})


def _ptxas_entries(log: str) -> dict:
    """{kernel: registers, static shared memory, spill bytes and the
    stack line} from nvcc's -Xptxas -v report of one library."""
    out, fn, stack_line, spill = {}, None, "", 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            stack_line = line.strip()
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            out[fn] = {"registers": int(m.group(1)),
                       "smem": int(m.group(2) or 0), "spill_bytes": spill,
                       "stack": stack_line}
    return out


def phase_sass(paths):
    """B6 and B7 (forward and backward) run their products on the tensor
    cores: count the HMMA instructions in each library's SASS (cuobjdump
    beside nvcc), and B6's backward's warpgroup HGMMA, which it must hold.
    Also B3's load batching at m = 20, read from its SASS."""
    from repro_torch.kernels import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        fail(f"no cuobjdump beside nvcc ({tool}): the tensor-core check "
             f"of B6 and B7 cannot run")
    out, hgmma = {}, 0
    for name in ("flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd"):
        sass = subprocess.run([str(tool), "-sass", str(paths[name])],
                              capture_output=True, text=True, timeout=300)
        lines = sass.stdout.splitlines()
        n = sum("HMMA" in line for line in lines)
        if sass.returncode != 0 or n == 0:
            fail(f"{name}: no HMMA instruction in its SASS "
                 f"(cuobjdump rc {sass.returncode})")
        out[name] = n
        if name == "flash_attention_bwd":
            hgmma = sum("HGMMA" in line for line in lines)
            if hgmma == 0:
                fail("flash_attention_bwd: no HGMMA (wgmma) instruction in "
                     "its SASS")
    emit({"check": "tensor_core_sass", "hmma_instructions": out,
          "flash_attention_bwd_hgmma_instructions": hgmma})
    # B3 at m = 20: how many global loads of a column go out before the
    # first add that consumes one (the longest run of LDG without an
    # FADD/FMUL between them in its SASS)
    # (the column loop: after the barrier that ends thread 0's weight setup)
    sass = subprocess.run([str(tool), "-sass", str(paths["brsgd_stats"])],
                          capture_output=True, text=True, timeout=300).stdout
    body = next((f for f in sass.split("Function : ")
                 if "masked_mean_kernelILi20E" in f.split("\n", 1)[0]), "")
    body = body.split("BAR.SYNC", 1)[-1]
    run = longest = loads = 0
    for line in body.splitlines():
        if "LDG" in line:
            loads += 1
            run += 1
            longest = max(longest, run)
        elif "FADD" in line or "FMUL" in line:
            run = 0
    if loads == 0:
        fail("masked_mean_kernel<20>: no global load found in its SASS")
    emit({"check": "masked_mean_sass", "m": 20, "loop_ldg_instructions": loads,
          "longest_load_run": longest})


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _same_nan(a, b):
    return bool(a.shape == b.shape and a.isnan().equal(b.isnan()))


def _err(a, b):
    """Largest absolute difference where both are finite-or-inf (equal
    values, equal infinities among them, differ by 0); NaN positions are
    compared by _same_nan."""
    keep = ~(a.isnan() | b.isnan())
    diff = (a.double() - b.double()).abs().masked_fill(a == b, 0.0)[keep]
    return float(diff.max()) if diff.numel() else 0.0


def _rel_ok(a, b, tol=REL_TOL):
    """NaN where the plain version has it, elsewhere within tol of the
    largest finite |plain| value."""
    fin = b[b.isfinite()].double().abs()
    scale = float(fin.max()) if fin.numel() else 0.0
    return _same_nan(a, b) and _err(a, b) <= tol * max(scale, 1e-30)


def _exact(a, b):
    """Equal bit for bit, NaN matching NaN."""
    keep = ~a.isnan()
    return _same_nan(a, b) and bool(a[keep].equal(b[keep]))


def _check_column_pass(torch, kern, ref, G, label, subsets, worst):
    """B1 at each needs subset, B4 and the median alone on G against
    their plain versions: scores, medians and B4's mean exact, l1, d2med
    and gram within REL_TOL; one JSON line each."""
    for needs in subsets:
        got = kern.fused_stats(G, needs)
        want = ref.fused_stats_ref(G, needs)
        torch.cuda.synchronize()
        for n in needs:
            ok = (_exact(got[n], want[n]) if n == "scores"
                  else _rel_ok(got[n], want[n]))
            worst["fused_stats"] = max(worst["fused_stats"],
                                       _err(got[n], want[n]))
            if not ok:
                fail(f"fused_stats {needs} {label}: {n} differs "
                     f"(max abs err {_err(got[n], want[n])})")
    emit({"check": "fused_stats", "input": label, "subsets": len(subsets),
          "scores": "exact", "l1_d2med_gram_rel_tol": REL_TOL})
    got = kern.brsgd_stats(G)
    want = ref.brsgd_stats_ref(G)
    torch.cuda.synchronize()
    names = ("median", "mean", "scores", "l1")
    for n, a, b in zip(names, got, want):
        ok = _rel_ok(a, b) if n == "l1" else _exact(a, b)
        worst["brsgd_stats"] = max(worst["brsgd_stats"], _err(a, b))
        if not ok:
            fail(f"brsgd_stats {label}: {n} err {_err(a, b)}")
    med = kern.cwise_median(G)
    want_med = ref.cwise_median_ref(G)
    torch.cuda.synchronize()
    worst["cwise_median"] = max(worst["cwise_median"], _err(med, want_med))
    if not _exact(med, want_med):
        fail(f"cwise_median {label}: err {_err(med, want_med)}, NaN equal "
             f"{_same_nan(med, want_med)}")
    emit({"check": "brsgd_stats", "input": label,
          "median_mean_scores": "exact", "l1_rel_tol": REL_TOL,
          "cwise_median": "exact", "nan_columns": int(want_med.isnan().sum())})


def _check_kernels(torch, kern, ref, G, label, rng, subsets, worst):
    """B1 (every needs subset), B2, B3, B4, the median alone and B5 on G
    against their plain versions; emits one JSON line per kernel."""
    m, d = G.shape
    _check_column_pass(torch, kern, ref, G, label, subsets, worst)
    # B2: selection + masked mean, from the plain pass-1 statistics
    st = ref.fused_stats_ref(G, ("scores", "l1"))
    kth, T = ref.brsgd_thresholds(st["scores"], st["l1"], 0.5, 0.0)
    agg, w = kern.select_mean(G, st["scores"], st["l1"], kth, T)
    sel, _, _, _ = ref.brsgd_select_mask(st["scores"], st["l1"], 0.5, 0.0)
    want = ref.masked_mean_det(G, sel.float())
    torch.cuda.synchronize()
    if not _exact(w, sel.float()):
        fail(f"select_mean {label}: selection weights differ")
    if not _rel_ok(agg, want):
        fail(f"select_mean {label}: aggregate err {_err(agg, want)}")
    worst["select_mean"] = max(worst["select_mean"], _err(agg, want))
    emit({"check": "select_mean", "input": label, "w": "exact",
          "n_selected": int(w.sum()), "agg_bit_exact": _exact(agg, want),
          "agg_max_abs_err": _err(agg, want), "rel_tol": REL_TOL})
    # B3: masked mean with a random 0/1 mask, float weights, unit weights
    # (the mean, which also writes w and w > 0) and the empty mask, each
    # bit-equal to masked_mean_det
    weights = {"0/1": torch.as_tensor(rng.random(m) < 0.6, device="cuda"),
               "float": torch.as_tensor(rng.random(m).astype("float32"),
                                        device="cuda"),
               "empty": torch.zeros(m, dtype=torch.bool, device="cuda")}
    errs = {}
    for kind, w in weights.items():
        got, want = kern.masked_mean(G, w), ref.masked_mean_det(G, w)
        torch.cuda.synchronize()
        errs[kind] = _err(got, want)
        if not _exact(got, want):
            fail(f"masked_mean {label} ({kind} weights): err {errs[kind]}")
    r = kern.select_aggregate(G, "mean")
    want = ref.masked_mean_det(G, torch.ones(m, device="cuda"))
    torch.cuda.synchronize()
    if not (_exact(r.agg, want) and bool((r.w == 1).all())
            and bool(r.selected.all())):
        fail(f"masked_mean {label} (unit weights): err {_err(r.agg, want)}")
    worst["masked_mean"] = max(worst["masked_mean"], *errs.values())
    emit({"check": "masked_mean", "input": label,
          "weights": list(weights) + ["unit"],
          "bit_equal_to_masked_mean_det": True})
    _check_trimmed(torch, kern, ref, G, label, worst)


def _check_trimmed(torch, kern, ref, G, label, worst):
    """B5 on G at every trim fraction: bit-equal to its plain version
    (NaN where it has NaN), and a second launch gives the same bits."""
    m = G.shape[0]
    for tf in TRIM_FRACS:
        got = kern.trimmed_mean(G, tf)
        again = kern.trimmed_mean(G, tf)
        want = ref.trimmed_mean_ref(G, tf)
        torch.cuda.synchronize()
        worst["trimmed_mean"] = max(worst["trimmed_mean"], _err(got, want))
        if not _exact(got, want):
            fail(f"trimmed_mean {label} trim_frac={tf}: err "
                 f"{_err(got, want)}, NaN equal {_same_nan(got, want)}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"trimmed_mean {label} trim_frac={tf}: a second launch "
                 f"gave other bits")
    emit({"check": "trimmed_mean", "input": label, "trim_fracs": TRIM_FRACS,
          "k": [ref.trim_k(tf, m) for tf in TRIM_FRACS], "exact": True,
          "repeat_same_bits": True, "nan_columns": int(want.isnan().sum()),
          "inf_columns": int(want.isinf().sum())})


def _trimmed_nonfinite(np, m, d, seed):
    """[m, d] normals with non-finite entries in trimmed and kept slots:
    worker 0 +inf and the last worker -inf in every 5th column (both
    trimmed once k > 0, else NaN), worker m // 2 +inf in every 7th
    (trimmed once k > 0, else kept), worker (m - 1) // 3 NaN in every
    third, column 3 all +inf (kept) and column 4 all -inf."""
    g = np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)
    g[0, ::5] = np.inf
    g[m - 1, ::5] = -np.inf
    g[m // 2, 1::7] = np.inf
    g[(m - 1) // 3, 2::3] = np.nan
    g[:, 3] = np.inf
    g[:, 4] = -np.inf
    return g


def _check_fused(torch, kern, ref, G, label, worst):
    """The fused brsgd launch against its plain version on G, for each of
    FUSED_CASES: scores exact and l1 within REL_TOL of the plain pass;
    kth, 𝔗, the masks and w exact against the plain threshold and mask
    steps applied to the kernel's own scores and l1; the aggregate
    bit-equal to masked_mean_det(G, w); a second launch the same bits."""
    m, d = G.shape
    plan = kern.launch_plan(G)
    want = ref.fused_stats_ref(G, ("scores", "l1"))
    n_sel = []
    for beta, per_col in FUSED_CASES:
        thr = per_col * d
        r = kern.brsgd_aggregate(G, beta, thr)
        again = kern.brsgd_aggregate(G, beta, thr)
        kth, T = ref.brsgd_thresholds(r.scores, r.l1, beta, thr)
        sel, c1, c2 = ref.brsgd_masks(r.scores, r.l1, kth, T)
        agg_want = ref.masked_mean_det(G, r.w)
        torch.cuda.synchronize()
        bad = [n for n, ok in (
            ("scores", _exact(r.scores, want["scores"])),
            ("l1", _rel_ok(r.l1, want["l1"])),
            ("kth", _exact(r.kth, kth)), ("threshold", _exact(r.threshold, T)),
            ("selected", _exact(r.selected, sel)), ("c1", _exact(r.c1, c1)),
            ("c2", _exact(r.c2, c2)), ("w", _exact(r.w, sel.float())),
            ("aggregate", _exact(r.agg, agg_want)),
            ("repeat", all(_exact(a, b) for a, b in zip(again, r))))
            if not ok]
        worst["brsgd_aggregate"] = max(worst["brsgd_aggregate"],
                                       _err(r.l1, want["l1"]),
                                       _err(r.agg, agg_want))
        if bad:
            fail(f"brsgd_aggregate {label} beta={beta} threshold={thr}: "
                 f"{bad} differ (l1 err {_err(r.l1, want['l1'])}, "
                 f"aggregate err {_err(r.agg, agg_want)})")
        n_sel.append(int(r.selected.sum()))
    emit({"check": "brsgd_aggregate", "input": label, "grid": plan.grid,
          "resident": plan.resident, "smem_bytes": plan.smem,
          "cases": [list(c) for c in FUSED_CASES], "n_selected": n_sel,
          "scores_kth_threshold_masks_w": "exact", "l1_rel_tol": REL_TOL,
          "aggregate": "bit-equal to masked_mean_det(G, w)",
          "repeat": "bit-equal"})
    return plan


def _select_cases(m):
    """(rule, host arguments) of the fused select launch at m workers:
    the engine's own for a fixed round at alpha = 0.25."""
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import engine
    cfg = ByzantineConfig(alpha=0.25)
    return [(rule, engine.rule_args(engine.get_spec(rule), cfg, m))
            for rule in GRAM_RULES]


ON_WORKER = 1e-2    # Weiszfeld's iterate within 1% of max‖g_i‖ of a worker
ON_WORKER_W = 1e-2  # the weight there: within 1% of the plain version's


def _geomedian_check(G, w, want_w, S, agg=None, want_agg=None) -> dict:
    """geomedian's weights (and aggregate) against the plain version.
    w_i = 1/‖g_i − z‖ with ‖g_i − z‖² = S_ii − 2(Sw)_i/W + wᵀSw/W², a
    difference of gram terms up to max S_ii: where the iterate z sits on
    worker i, w_i is set by rounding.  Rows the plain iterate stays
    ON_WORKER · √max S_ii or farther from hold w within REL_TOL of the
    largest such weight; rows nearer must be copies of one worker, the
    card's argmax, with w within ON_WORKER_W of the plain's; the
    aggregate within REL_TOL of the plain one, plus, where the iterate
    sits on worker i, ON_WORKER_W of max|g_i − agg|.  Returns the
    verdict and the numbers it was reached on."""
    if bool(want_w.isnan().any()):
        ok = _rel_ok(w, want_w) and (agg is None or _rel_ok(agg, want_agg))
        return {"ok": ok, "on_worker_rows": 0, "w_err": _err(w, want_w)}
    root = float(S.diagonal().max()) ** 0.5
    on = want_w * root * ON_WORKER > 1.0
    off = want_w[~on]
    w_err = _err(w[~on], off) if off.numel() else 0.0
    w_atol = REL_TOL * float(off.abs().max()) if off.numel() else 0.0
    res = {"ok": w_err <= w_atol, "on_worker_rows": int(on.sum()),
           "w_err": w_err, "w_atol": w_atol}
    slack = 0.0
    if bool(on.any()):
        i = int(w.argmax())
        ratio = float((w[on].double() / want_w[on].double() - 1.0).abs()
                      .max())
        res["on_worker_w_rel_err"] = ratio
        res["ok"] &= bool((G[on] == G[i]).all()) and ratio <= ON_WORKER_W
        if agg is not None:
            slack = ON_WORKER_W * float((G[i] - want_agg).abs().max())
    if agg is not None:
        fin = want_agg[want_agg.isfinite()].double().abs()
        scale = float(fin.max()) if fin.numel() else 0.0
        res["agg_err"] = _err(agg, want_agg)
        res["agg_atol"] = REL_TOL * scale + slack
        res["ok"] &= (_same_nan(agg, want_agg)
                      and res["agg_err"] <= res["agg_atol"])
    return res


def _check_select(torch, kern, ref, G, label, worst):
    """The fused select launch against its plain version on G for each
    gram rule: gram (and d2med) within REL_TOL; krum / multi_krum scores
    within REL_TOL and weights exact, against the plain rule on the
    launch's own scores and against the plain composition; geomedian's
    weights against both by _geomedian_check; the aggregate bit-equal to
    masked_mean_det(G, w); a second launch the same bits.  Returns the
    plans."""
    m, d = G.shape
    plans = {}
    for rule, args in _select_cases(m):
        plans[rule] = plan = kern.launch_plan(G, rule)
        r = kern.select_aggregate(G, rule, **args)
        again = kern.select_aggregate(G, rule, **args)
        want = ref.select_aggregate_plain(G, rule, **args)
        agg_want = ref.masked_mean_det(G, r.w)
        torch.cuda.synchronize()
        checks = [("gram", _rel_ok(r.gram, want.gram)),
                  ("selected", _exact(r.selected, r.w > 0)),
                  ("aggregate", _exact(r.agg, agg_want)),
                  ("repeat", all(_exact(a, b) for a, b in zip(again, r)
                                 if b is not None))]
        geo = None
        if rule == "geomedian":
            geo = _geomedian_check(G, r.w, want.w, want.gram, r.agg,
                                   want.agg)
            own = ref.geomedian_weights(r.gram, r.d2med, args["iters"],
                                        args["eps"])
            checks += [("d2med", _rel_ok(r.d2med, want.d2med)),
                       ("w", geo["ok"]),
                       ("w_from_own_gram",
                        _geomedian_check(G, r.w, own, r.gram)["ok"])]
        else:
            own = (ref.krum_weights(r.scores) if rule == "krum"
                   else ref.multi_krum_weights(r.scores, args["k"]))
            checks += [("scores", _rel_ok(r.scores, want.scores)),
                       ("w_from_own_scores", _exact(r.w, own)),
                       ("w", _exact(r.w, want.w))]
        bad = [n for n, ok in checks if not ok]
        worst["select_aggregate"] = max(worst["select_aggregate"],
                                        _err(r.agg, agg_want),
                                        geo["w_err"] if geo else
                                        _err(r.w, want.w))
        if bad:
            fail(f"select_aggregate {rule} {label}: {bad} differ (w err "
                 f"{_err(r.w, want.w)}, gram err {_err(r.gram, want.gram)}, "
                 f"geomedian {geo})")
        emit({"check": "select_aggregate", "rule": rule, "input": label,
              "args": args, "grid": plan.grid, "resident": plan.resident,
              "smem_bytes": plan.smem, "n_selected": int(r.selected.sum()),
              "gram_rel_tol": REL_TOL,
              "w": (f"within {REL_TOL} of the largest weight off a worker"
                    if geo else "exact"),
              **({"geomedian": geo} if geo else {}),
              "aggregate": "bit-equal to masked_mean_det(G, w)",
              "repeat": "bit-equal"})
    return plans


EVERY_M_D = 1003             # the every-m sweep's ragged width


def _check_rules(torch, G, worst) -> int:
    """Every registered rule through engine.aggregate_local on the card
    against the same call on the CPU, fixed and elastic (the masked pass
    over all but every third worker), and stream_aggregate (3 arrival
    buckets, quorum 3m/4) against the bulk masked pass on the card: the
    selection equal, the aggregate exact (geomedian, and the elastic
    pass's l1 sums and gram products: within REL_TOL).  Returns the
    checks made."""
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import engine
    m = G.shape[0]
    G_cpu = G.cpu()
    valid = (torch.arange(m) % 3 != 1).float()
    arrival = torch.zeros(3, m)
    arrival[torch.arange(m) % 3, torch.arange(m)] = 1.0
    q = max(1, (3 * m) // 4)
    n = 0
    for agg in engine.registered():
        cfg = ByzantineConfig(aggregator=agg, alpha=0.25)
        for v in (None, valid):
            got, st = engine.aggregate_local(
                G, cfg, True, valid=None if v is None else v.cuda())
            want, wst = engine.aggregate_local(G_cpu, cfg, True, valid=v)
            got = got.cpu()
            exact_rule = agg != "geomedian" and (v is None or agg in (
                "median", "trimmed_mean", "mean"))
            ok = _exact(got, want) if exact_rule else _rel_ok(got, want)
            if st is not None:
                ok &= torch.equal(st.selected.cpu(), wst.selected)
            worst["aggregate_local"] = max(worst.get("aggregate_local", 0.0),
                                           _err(got, want))
            if not ok:
                fail(f"aggregate_local {agg} [{m},{G.shape[1]}] "
                     f"{'fixed' if v is None else 'elastic'}: card and CPU "
                     f"differ (max abs err {_err(got, want)})")
            n += 1
        scfg = ByzantineConfig(aggregator=agg, alpha=0.25, quorum=q)
        got, st = engine.stream_aggregate(G, scfg, arrival.cuda(), None, True)
        want, bst = engine.aggregate_local(
            G, scfg, True, valid=engine.arrival_active(arrival.cuda(), q))
        if not (_exact(got, want) and torch.equal(st.selected, bst.selected)):
            fail(f"stream_aggregate {agg} [{m},{G.shape[1]}]: differs from "
                 f"the bulk masked pass (max abs err {_err(got, want)})")
        n += 1
    return n


def _check_every_m(torch, kern, ref, subsets, worst):
    """Every worker count 1 <= m <= MAX_M, each on its tuned or bucket
    instance: the column pass (B1 at every needs subset, B4, the median
    alone) at d = 1003 and d = 61 (rows off 16 bytes; one ragged tile)
    with a NaN worker row, then with NaN entries scattered over the
    columns and one column all NaN; B5 at every trim fraction on NaN and
    ±inf in trimmed and kept slots at both widths, on G and on a view
    whose rows start 4 bytes past 16; at [m, 1003] with one worker's row NaN
    in every third column, B1-B5 (_check_kernels), the fused brsgd launch
    (_check_fused), the fused select launch of each gram rule
    (_check_select) and every rule through aggregate_local, fixed and
    elastic (_check_rules).  The per-check lines are not printed: one line
    gives the checks per instance and the worst errors.  m = MAX_M + 1
    must raise, naming the limit."""
    import contextlib
    import io
    import numpy as np
    per = {}
    for m in range(1, kern.MAX_M + 1):
        inst = (f"tuned {m}" if m in kern.TUNED_M
                else f"bucket {kern.instance_rows(m)}")
        n = 0
        with contextlib.redirect_stdout(io.StringIO()):
            for d in (EVERY_M_D, 61):
                g = np.random.default_rng(m * d).normal(size=(m, d)).astype(
                    np.float32)
                g[m // 3] = np.nan
                _check_column_pass(torch, kern, ref, torch.as_tensor(
                    g, device="cuda"), f"[{m},{d}] worker {m // 3} NaN",
                    subsets, worst)
                g[m // 3] = 1.0
                g[np.arange(0, d, 7) % m, np.arange(0, d, 7)] = np.nan
                g[:, 3] = np.nan
                _check_column_pass(torch, kern, ref, torch.as_tensor(
                    g, device="cuda"), f"[{m},{d}] NaN columns", subsets,
                    worst)
                # B5 on ±inf and NaN in trimmed and kept slots, on G and
                # on a view whose rows start 4 bytes past 16
                g = _trimmed_nonfinite(np, m, d, 900 + m)
                base = torch.empty(m * d + 1, device="cuda")
                base[1:] = torch.as_tensor(g.reshape(-1), device="cuda")
                for G, where in ((torch.as_tensor(g, device="cuda"), ""),
                                 (base[1:].view(m, d), " off 16 bytes")):
                    _check_trimmed(torch, kern, ref, G,
                                   f"[{m},{d}] non-finite{where}", worst)
                n += 4
            rng = np.random.default_rng(500 + m)
            g = rng.normal(size=(m, EVERY_M_D)).astype(np.float32)
            g[: m // 4] *= -4.0
            g[(m - 1) // 2, ::3] = np.nan
            G = torch.as_tensor(g, device="cuda")
            label = f"[{m},{EVERY_M_D}] worker {(m - 1) // 2} NaN"
            _check_kernels(torch, kern, ref, G, label, rng, subsets, worst)
            _check_fused(torch, kern, ref, G, label, worst)
            _check_select(torch, kern, ref, G, label, worst)
            n += 3 + _check_rules(torch, G, worst)
        row = per.setdefault(inst, {"m": [], "checks": 0})
        row["m"].append(m)
        row["checks"] += n
    try:
        kern.cwise_median(torch.zeros(kern.MAX_M + 1, 8, device="cuda"))
    except ValueError as e:
        refused = str(e)
    else:
        fail(f"m = {kern.MAX_M + 1} did not raise")
    if str(kern.MAX_M) not in refused:
        fail(f"m = {kern.MAX_M + 1} raised without naming the limit: "
             f"{refused}")
    emit({"check": "every_worker_count", "m": [1, kern.MAX_M],
          "d": [EVERY_M_D, 61], "instances": per,
          "worst_abs_err": dict(worst), "m_above_limit": refused,
          "gates": "PERF.md section 2 (exact; l1, d2med, gram, krum scores, "
                   "geomedian weights within 1e-5 of the largest)"})


def _check_nonfinite(torch, kern, ref, subsets, worst):
    """Workers with non-finite columns that the rules leave out: worker 1
    NaN in every 9th column, worker 3 +inf, -inf and NaN in others (both
    score NaN; krum keeps worker 1, the first).  Every combine sums every
    row, weight 0 included, as the reference's w @ g does, so worker 3's
    non-finite columns are NaN: B1-B5, the fused brsgd launch and the
    fused select launches against their plain versions (aggregates
    bit-equal to masked_mean_det, NaN included), resident at [20, 61706],
    not resident at [20, 2000003], and on the bucket instances at m = 12
    and 33."""
    import numpy as np
    for m, d in NONFINITE_SHAPES:
        rng = np.random.default_rng(300 + m)
        g = rng.normal(size=(m, d)).astype(np.float32)
        g[m - m // 4:] *= -4.0
        g[1, ::9] = np.nan
        g[3, 2::9] = np.inf
        g[3, 5::9] = -np.inf
        g[3, 7::11] = np.nan
        G = torch.as_tensor(g, device="cuda")
        label = f"[{m},{d}] workers 1 and 3 non-finite"
        _check_kernels(torch, kern, ref, G, label, rng, subsets, worst)
        plan = _check_fused(torch, kern, ref, G, label, worst)
        plans = _check_select(torch, kern, ref, G, label, worst)
        left_out = {}
        r = kern.brsgd_aggregate(G, 0.5, 0.0)
        left_out["brsgd"] = (not bool(r.selected[3])
                             and bool(r.agg[2::9].isnan().all()))
        for rule, args in _select_cases(m):
            if rule != "geomedian":
                r = kern.select_aggregate(G, rule, **args)
                left_out[rule] = (not bool(r.selected[3])
                                  and bool(r.agg[5::9].isnan().all()))
        w = torch.ones(m, device="cuda")
        w[3] = 0.0
        left_out["masked_mean"] = bool(kern.masked_mean(G, w)[2::9]
                                       .isnan().all())
        torch.cuda.synchronize()
        if not all(left_out.values()):
            fail(f"{label}: a left-out non-finite worker did not give NaN "
                 f"in its columns: {left_out}")
        if d > 1_000_000 and (plan.resident or any(
                p.resident for p in plans.values())):
            fail(f"{label}: expected G not resident")
        emit({"check": "nonfinite_left_out", "input": label,
              "resident": plan.resident, "nan_in_its_columns": left_out,
              "aggregates": "bit-equal to masked_mean_det(G, w), NaN "
                            "included"})


def phase_kernels(torch, kern, ref):
    import itertools
    import numpy as np
    worst = {k: 0.0 for k in REPLACES}
    subsets = [c for r in range(1, 5)
               for c in itertools.combinations(ref.STAT_NAMES, r)]
    for si, (m, d) in enumerate(CHECK_SHAPES):
        rng = np.random.default_rng(100 + si)
        G = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32),
                            device="cuda")
        _check_kernels(torch, kern, ref, G, f"[{m},{d}]", rng, subsets,
                       worst)
        if not _check_fused(torch, kern, ref, G, f"[{m},{d}]",
                            worst).resident:
            fail(f"brsgd_aggregate [{m},{d}]: G does not stay resident")
        G[: max(1, m // 4)] *= -4.0                    # outlying workers
        plans = _check_select(torch, kern, ref, G, f"[{m},{d}] outliers",
                              worst)
        if not all(p.resident for p in plans.values()):
            fail(f"select_aggregate [{m},{d}]: G does not stay resident")
        G[m - 1] = G[m // 2]                           # tied scores
        _check_select(torch, kern, ref, G, f"[{m},{d}] duplicate worker",
                      worst)
    # one worker's gradient holds NaN: the sort and the scores must
    # propagate it as the plain versions do
    for where, cols in (("row", slice(None)), ("every 5th column",
                                               slice(None, None, 5))):
        rng = np.random.default_rng(200)
        g = rng.normal(size=MAIN_SHAPE).astype(np.float32)
        g[4, cols] = np.nan
        G = torch.as_tensor(g, device="cuda")
        label = f"[20,61706] worker 4 NaN ({where})"
        _check_kernels(torch, kern, ref, G, label, rng, subsets, worst)
        _check_fused(torch, kern, ref, G, label, worst)
        _check_select(torch, kern, ref, G, label, worst)
    _check_every_m(torch, kern, ref, subsets, worst)
    _check_nonfinite(torch, kern, ref, subsets, worst)
    # the fused launch where G does not fit in shared memory: pass 2
    # reads it again
    m, d = NONRESIDENT_SHAPE
    rng = np.random.default_rng(250)
    g = rng.normal(size=(m, d)).astype(np.float32)
    for label in (f"[{m},{d}]", f"[{m},{d}] worker 4 NaN (every 5th "
                                f"column)"):
        if "NaN" in label:
            g[4, ::5] = np.nan
        G = torch.as_tensor(g, device="cuda")
        if _check_fused(torch, kern, ref, G, label, worst).resident:
            fail(f"brsgd_aggregate {label}: expected G not resident")
        if any(p.resident for p in _check_select(torch, kern, ref, G, label,
                                                 worst).values()):
            fail(f"select_aggregate {label}: expected G not resident")
    return worst


def _bshd(torch, B, S, H, D, seed, dtype):
    """A [B,H,S,D] view of [B,S,H,D] data: the layout the model passes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, S, H, D, generator=g, device="cuda")
    return x.to(getattr(torch, dtype)).transpose(1, 2)


def _wkv_inputs(torch, B, H, Q, K, decay, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn(B, H, Q, K, generator=g, device="cuda")
               for _ in range(3))
    w = torch.exp(-decay * torch.rand(B, H, Q, K, generator=g,
                                      device="cuda"))
    u = torch.randn(H, K, generator=g, device="cuda")
    S0 = torch.randn(B, H, K, K, generator=g, device="cuda")
    return r, k, v, w, u, S0


def _flash_inputs(torch, B, H, Hkv, S, D, Dv, dtype, with_do=False):
    """q [B,H,S,D], k [B,Hkv,S,D], v [B,Hkv,S,Dv] (and dO [B,H,S,Dv]) as
    the model's strided views."""
    shapes = ((H, D), (Hkv, D), (Hkv, Dv)) + (((H, Dv),) if with_do else ())
    return tuple(_bshd(torch, B, S, h, d, i, dtype)
                 for i, (h, d) in enumerate(shapes))


def _check_flash(torch, ref, q, k, v, win, label, worst, row=None):
    """B6 on (q, k, v) against its plain version at FLASH_TOL, and on
    contiguous copies (bit-equal: the model passes strided views)."""
    from repro_torch.kernels import flash_attention as fa_kern
    dt = str(q.dtype).replace("torch.", "")
    got = fa_kern.flash_attention(q, k, v, win)
    want = ref.flash_attention_ref(q, k, v, win)
    again = fa_kern.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), win)
    torch.cuda.synchronize()
    if not torch.equal(again, got):
        fail(f"flash_attention {label}: the model's strided views and "
             f"contiguous copies differ")
    rtol, atol = FLASH_TOL[dt]
    a, b = got.double(), want.double()
    err = float((a - b).abs().max())
    excess = float(((a - b).abs() - rtol * b.abs()).max())
    worst["flash_attention"] = max(worst["flash_attention"], err)
    if not (excess <= atol and bool(got.isfinite().all())):
        fail(f"flash_attention {label}: max abs err {err} beyond rtol "
             f"{rtol} / atol {atol}")
    emit({"check": "flash_attention", "input": label, **(row or {}),
          "max_abs_err": err, "rtol": rtol, "atol": atol,
          "strided_equals_contiguous": True})


def _check_wkv_seq(torch, ref, ins, chunk, label, worst, row=None):
    """wkv6_seq (B7's layer call) on ins = (r, k, v, w, u, S0) against
    its plain version at WKV_TOL."""
    from repro_torch.kernels import wkv6 as wkv_kern
    y, S_out = wkv_kern.wkv6_seq(*ins, chunk)
    yp, Sp = ref.wkv6_seq_plain(*ins, chunk)
    torch.cuda.synchronize()
    ey, es = _err(y, yp), _err(S_out, Sp)
    worst["wkv6_seq"] = max(worst["wkv6_seq"], ey, es)
    if not (_rel_ok(y, yp, WKV_TOL[0]) and _rel_ok(S_out, Sp, WKV_TOL[1])):
        fail(f"wkv6_seq {label}: y err {ey}, S err {es} (max|y| "
             f"{float(yp.abs().max())}, max|S| {float(Sp.abs().max())})")
    emit({"check": "wkv6_seq", "input": label, **(row or {}),
          "chunk": chunk, "y_max_abs_err": ey, "S_max_abs_err": es,
          "y_rel_tol": WKV_TOL[0], "S_rel_tol": WKV_TOL[1]})


def phase_seq_kernels(torch, ref):
    """B6 and B7 against their plain versions (and B7 against the
    sequential oracle where the clamps do not bite)."""
    from repro_torch.kernels import wkv6 as wkv_kern
    worst = {"flash_attention": 0.0, "wkv6_seq": 0.0}
    for B, H, Hkv, S, D, win, dt in FLASH_CASES:
        q, k, v = (_bshd(torch, B, S, h, D, i, dt)
                   for i, h in enumerate((H, Hkv, Hkv)))
        _check_flash(torch, ref, q, k, v, win,
                     f"[{B},{H},{Hkv},{S},{D}] window={win} {dt}", worst)
    for B, H, Hkv, S, D, Dv, win, dt in MLA_FLASH_CASES:
        q, k, v = _flash_inputs(torch, B, H, Hkv, S, D, Dv, dt)
        _check_flash(torch, ref, q, k, v, win,
                     f"[{B},{H},{Hkv},{S},{D}->{Dv}] window={win} {dt}",
                     worst, {"instance": [D, Dv]})
        del q, k, v
    for B, H, Q, K, decay in WKV_CASES:
        ins = _wkv_inputs(torch, B, H, Q, K, decay)
        y, S_out = wkv_kern.wkv6_chunk(*ins)
        yp, Sp = ref.wkv6_chunk_plain(*ins)
        torch.cuda.synchronize()
        label = f"[{B},{H},{Q},{K}] w in (e^-{decay:g}, 1)"
        ey, es = _err(y, yp), _err(S_out, Sp)
        worst["wkv6_seq"] = max(worst["wkv6_seq"], ey, es)
        if not (_rel_ok(y, yp, WKV_TOL[0]) and _rel_ok(S_out, Sp, WKV_TOL[1])):
            fail(f"wkv6_chunk {label}: y err {ey}, S err {es} (max|y| "
                 f"{float(yp.abs().max())}, max|S| {float(Sp.abs().max())})")
        row = {"check": "wkv6_chunk", "input": label, "y_max_abs_err": ey,
               "S_max_abs_err": es, "y_rel_tol": WKV_TOL[0],
               "S_rel_tol": WKV_TOL[1]}
        if decay <= 1.0:
            ys, Ss = ref.wkv6_chunk_ref(*ins)
            row["oracle_y_err"] = _err(y, ys)
            row["oracle_S_err"] = _err(S_out, Ss)
            if not (_rel_ok(y, ys, WKV_TOL[0]) and _rel_ok(S_out, Ss, 1e-4)):
                fail(f"wkv6_chunk {label}: differs from the sequential "
                     f"oracle (y {row['oracle_y_err']}, S "
                     f"{row['oracle_S_err']})")
        emit(row)
    # the layer call: one launch over every chunk, from a nonzero state
    cases = [((4, 64) if (S, K) == (512, 64) else (2, 8)) + (S, K)
             for S in WKV_SEQ_S for K in WKV_SEQ_K] + list(WKV_SEQ_SERVE)
    for B, H, S, K in cases:
        for decay in (1.0, 3.0):
            r, k, v, w, u, S0 = _wkv_inputs(torch, B, H, S, K, decay,
                                            seed=S + K)
            r, k, v, w = (x.transpose(1, 2).contiguous()
                          for x in (r, k, v, w))
            _check_wkv_seq(torch, ref, (r, k, v, w, u, S0), 64,
                           f"[{B},{S},{H},{K}] w in (e^-{decay:g}, 1)",
                           worst)
    return worst


def _grad_errs(got, want, names) -> dict:
    """{name: max|got - want| / max|want|} over pairs of gradients."""
    return {n: float((a.double() - b.double()).abs().max()
                     / max(float(b.double().abs().max()), 1e-30))
            for n, a, b in zip(names, got, want)}


def _same_bits(torch, a, b) -> bool:
    """a and b (tensors, or sequences of them) are equal bit for bit."""
    if torch.is_tensor(a):
        a, b = (a,), (b,)
    return all(x.shape == y.shape and bool(torch.equal(x, y))
               for x, y in zip(a, b))


def phase_bwd_kernels(torch, ref):
    """B6's and B7's backward kernels against autograd of their plain
    versions on the card, each launched twice on the same inputs (the
    same bits), and the training forward (log-sum-exp / chunk states
    written) against the serve forward (the same bits)."""
    from repro_torch.kernels import flash_attention as fa_kern
    from repro_torch.kernels import wkv6 as wkv_kern
    worst = {name: 0.0 for name in BWD_KERNELS}
    cases = ([c[:5] + (c[4],) + c[5:] for c in FLASH_BWD_CASES]
             + list(MLA_FLASH_BWD_CASES))
    for B, H, Hkv, S, D, Dv, win in cases:
        label = (f"[{B},{H},{Hkv},{S},{D}] window={win}" if D == Dv else
                 f"[{B},{H},{Hkv},{S},{D}->{Dv}] window={win}")
        q, k, v, dO = _flash_inputs(torch, B, H, Hkv, S, D, Dv, "float32",
                                    with_do=True)
        o_serve = fa_kern.flash_attention(q, k, v, win)
        o, lse = fa_kern.flash_attention_lse(q, k, v, win)
        got = fa_kern.flash_attention_bwd(q, k, v, o, lse, dO, win)
        again = fa_kern.flash_attention_bwd(q, k, v, o, lse, dO, win)
        cont = [t.contiguous() for t in (q, k, v, o, dO)]
        contig = fa_kern.flash_attention_bwd(*cont[:4], lse, cont[4], win)
        want = ref.flash_attention_grads_ref(q, k, v, dO, win)
        torch.cuda.synchronize()
        errs = _grad_errs(got, want, ("dq", "dk", "dv"))
        row = {"check": "flash_attention_bwd", "input": label, **errs,
               "rel_tol": _flash_bwd_tol(S),
               "forward_bits_unchanged": _same_bits(torch, o, o_serve),
               "second_launch_same_bits": _same_bits(torch, got, again),
               "strided_equals_contiguous": _same_bits(torch, got, contig)}
        worst["flash_attention_bwd"] = max(
            worst["flash_attention_bwd"],
            *(float((a - b).abs().max()) for a, b in zip(got, want)))
        if not (max(errs.values()) <= row["rel_tol"]
                and row["forward_bits_unchanged"]
                and row["second_launch_same_bits"]
                and row["strided_equals_contiguous"]):
            fail(f"flash_attention_bwd {label}: {row}")
        emit(row)
        del q, k, v, dO, o, lse, got, again, cont, contig, want
    names = ("dr", "dk", "dv", "dw", "du", "dS_in")
    for B, S, H, K, decay in WKV_BWD_CASES:
        r, k, v, w, u, S0 = _wkv_inputs(torch, B, H, S, K, decay, seed=S + K)
        r, k, v, w = (x.transpose(1, 2).contiguous() for x in (r, k, v, w))
        g = torch.Generator(device="cuda").manual_seed(S)
        dy = torch.randn(B, S, H, K, generator=g, device="cuda")
        dSf = torch.randn(B, H, K, K, generator=g, device="cuda")
        y_serve, s_serve = wkv_kern.wkv6_seq(r, k, v, w, u, S0, 64)
        states = wkv_kern.chunk_states(r, 64)
        y, s_out = wkv_kern.wkv6_seq(r, k, v, w, u, S0, 64, states)
        same = _same_bits(torch, (y, s_out), (y_serve, s_serve))
        for dsf in (dSf, None) if S <= 130 else (dSf,):
            label = (f"[{B},{S},{H},{K}] w in (e^-{decay:g}, 1) dS_final="
                     f"{'given' if dsf is not None else 'none'}")
            got = wkv_kern.wkv6_seq_bwd(r, k, v, w, u, states, dy, dsf, 64)
            again = wkv_kern.wkv6_seq_bwd(r, k, v, w, u, states, dy, dsf, 64)
            want = ref.wkv6_seq_grads_plain(r, k, v, w, u, S0, 64, dy, dsf)
            torch.cuda.synchronize()
            errs = _grad_errs(got, want, names)
            row = {"check": "wkv6_seq_bwd", "input": label, **errs,
                   "rel_tol": WKV_BWD_TOL, "forward_bits_unchanged": same,
                   "second_launch_same_bits": _same_bits(torch, got,
                                                         again)}
            worst["wkv6_seq_bwd"] = max(
                worst["wkv6_seq_bwd"],
                *(float((a - b).abs().max()) for a, b in zip(got, want)))
            if not (max(errs.values()) <= WKV_BWD_TOL and same
                    and row["second_launch_same_bits"]):
                fail(f"wkv6_seq_bwd {label}: {row}")
            emit(row)
    return worst


# ---------------------------------------------------------------------------
# 4. the paper loop, card against CPU, and the launch counters
# ---------------------------------------------------------------------------

def phase_loop(torch, kern, ref):
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.configs.lenet_fmnist import LeNetConfig
    from repro_torch.core import engine, threat
    from repro_torch.core.simulate import make_sim_step, worker_grad_matrix
    from repro_torch.data.pipeline import ImageWorkerPipeline
    from repro_torch.models import lenet
    from repro_torch.models.params import init_params

    bcfg = ByzantineConfig(aggregator="brsgd", attack="scale", alpha=0.25)
    pipe = ImageWorkerPipeline(20, n_per_worker=128, seed=0, byz=bcfg)
    p_cpu = init_params(lenet.lenet_defs(LeNetConfig()),
                        torch.Generator().manual_seed(0))
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    batch = pipe.batch(0, 8)
    states = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        G = worker_grad_matrix(lenet.lenet_loss, params, b)
        G = threat.apply_dense(G, torch.Generator(device=dev), bcfg)
        states[dev] = engine.aggregate_local(G, bcfg, return_state=True)[1]
    if not torch.equal(states["cpu"].selected,
                       states["cuda"].selected.cpu()):
        fail(f"card and CPU select different workers: "
             f"{states['cuda'].selected.tolist()} vs "
             f"{states['cpu'].selected.tolist()}")
    step_cpu = make_sim_step(lenet.lenet_loss, bcfg, 0.05, device="cpu")
    step_gpu = make_sim_step(lenet.lenet_loss, bcfg, 0.05)
    new_cpu, met_cpu = step_cpu(p_cpu, batch, torch.Generator())
    new_gpu, met_gpu = step_gpu(p_gpu, batch,
                                torch.Generator(device="cuda"))
    if float(met_cpu["n_selected"]) != float(met_gpu["n_selected"]):
        fail("card and CPU steps report different n_selected")
    perr = max(_err(new_gpu[k].cpu(), new_cpu[k]) for k in new_cpu)
    pscale = max(float(v.abs().max()) for v in new_cpu.values())
    if perr > 1e-5 * pscale:
        fail(f"card and CPU step params differ by {perr}")
    emit({"check": "step_card_vs_cpu", "n_selected":
          float(met_gpu["n_selected"]), "selection": "equal",
          "params_max_abs_err": perr, "atol": 1e-5 * pscale})

    kern.reset_launches()
    params, gen = p_gpu, torch.Generator(device="cuda").manual_seed(1)
    for s in range(5):
        params, met = step_gpu(params, pipe.batch(s, 8), gen)
        if bool(met["selected"][:5].any()):
            fail(f"step {s}: a byzantine worker (0-4) was selected: "
                 f"{met['selected'].tolist()}")
    counts = dict(kern.LAUNCHES)
    if {k: n for k, n in counts.items() if n} != {"brsgd_aggregate": 5}:
        fail(f"5 brsgd steps launched {counts}, expected 5 brsgd_aggregate "
             f"and nothing else")
    tm_counts = _trimmed_mean_steps(torch, kern, p_cpu, p_gpu, batch, pipe,
                                    make_sim_step, lenet)
    test = pipe.batch(99, 8)
    loss = float(lenet.lenet_loss(params, {
        "images": torch.as_tensor(test["images"][5], device="cuda"),
        "labels": torch.as_tensor(test["labels"][5], device="cuda")}))
    if not math.isfinite(loss):
        fail(f"loss after 5 card steps is {loss}")
    emit({"check": "five_card_steps", "launches": counts,
          "trimmed_mean_launches": tm_counts, "loss": loss,
          "byzantine_selected": False})

    # where a step's time goes: gradients vs attack + aggregation
    b = {k: torch.as_tensor(v, device="cuda")
         for k, v in pipe.batch(7, 8).items()}
    G = worker_grad_matrix(lenet.lenet_loss, params, b)
    parts = {
        "step": lambda: step_gpu(params, pipe.batch(7, 8), gen),
        "worker_grad_matrix": lambda: worker_grad_matrix(
            lenet.lenet_loss, params, b),
        "apply_dense+aggregate_local": lambda: engine.aggregate_local(
            threat.apply_dense(G, gen, bcfg), bcfg, return_state=True),
    }
    res = {f"{k}_ms": _host_ms(torch, fn) for k, fn in parts.items()}
    # the step with the two-pass composition the engine ran before the
    # fused launch, in turns with the fused one: two-pass, fused, fused,
    # two-pass
    step = parts["step"]
    turns = []
    for two_pass in (True, False, False, True):
        with _eager_engine(engine, kern, ref, two_pass):
            turns.append(_host_ms(torch, step))
    res["step_turns_ms"] = {"order": ["two-pass", "fused", "fused",
                                      "two-pass"], "runs": turns}
    emit({"timing": "paper_step_brsgd_scale", "m": 20, "batch": 8,
          "reps": HOST_REPS, **res})
    # the paper step of the other select rules, the eager composition the
    # engine ran before the one launch and the launch, in turns
    for rule in ("mean",) + GRAM_RULES:
        rcfg = ByzantineConfig(aggregator=rule, attack="scale", alpha=0.25)
        rstep = make_sim_step(lenet.lenet_loss, rcfg, 0.05)
        turns = []
        for eager in (True, False, False, True):
            with _eager_engine(engine, kern, ref, eager):
                turns.append(_host_ms(torch, lambda: rstep(
                    params, pipe.batch(7, 8), gen)))
        emit({"timing": f"paper_step_{rule}_scale", "m": 20, "batch": 8,
              "reps": HOST_REPS, "step_turns_ms": {
                  "order": ["eager", "one launch", "one launch", "eager"],
                  "runs": turns}})


def _trimmed_mean_steps(torch, kern, p_cpu, p_gpu, batch, pipe,
                        make_sim_step, lenet):
    """trimmed_mean under scale at alpha = 0.1 (2 byzantine rows, k = 2
    trimmed per side, so the attack is trimmed away and the parameters
    keep their size): one card step against one CPU step, each leaf
    within 1e-5 of its own largest value, then 5 card steps that must
    launch B5 exactly 5 times and nothing else.  The attack is
    deterministic, so both devices see the same rows."""
    from repro_torch.configs.base import ByzantineConfig
    bcfg = ByzantineConfig(aggregator="trimmed_mean", attack="scale",
                           alpha=0.1)
    step_cpu = make_sim_step(lenet.lenet_loss, bcfg, 0.05, device="cpu")
    step_gpu = make_sim_step(lenet.lenet_loss, bcfg, 0.05)
    new_cpu, _ = step_cpu(p_cpu, batch, torch.Generator())
    new_gpu, _ = step_gpu(p_gpu, batch, torch.Generator(device="cuda"))
    leaves = {}
    for k in new_cpu:
        scale = float(new_cpu[k].abs().max())
        leaves[k] = {"max_abs_err": _err(new_gpu[k].cpu(), new_cpu[k]),
                     "atol": 1e-5 * scale}
        if not (scale < 10.0 and _rel_ok(new_gpu[k].cpu(), new_cpu[k])):
            fail(f"trimmed_mean: card and CPU step differ on {k}: "
                 f"{leaves[k]}, largest |param| {scale}")
    emit({"check": "step_card_vs_cpu", "aggregator": "trimmed_mean",
          "attack": "scale", "alpha": 0.1, "leaves": leaves})
    kern.reset_launches()
    params, gen = p_gpu, torch.Generator(device="cuda").manual_seed(1)
    for s in range(5):
        params, _ = step_gpu(params, pipe.batch(s, 8), gen)
    counts = dict(kern.LAUNCHES)
    want = {k: 5 if k == "trimmed_mean" else 0 for k in counts}
    if counts != want:
        fail(f"5 trimmed_mean steps launched {counts}, expected {want}")
    return counts


def _two_pass_brsgd(kern, ref, engine, G, cfg, return_state):
    """The brsgd path of engine.aggregate_local before the fused launch:
    B1's (scores, l1) call with its two partial sums, ref.brsgd_thresholds,
    B2, and the masks of the state."""
    scores, l1 = kern.brsgd_partials(G)
    kth, T = ref.brsgd_thresholds(scores, l1, cfg.beta, cfg.threshold)
    agg, w = kern.select_mean(G, scores, l1, kth, T)
    if not return_state:
        return agg
    _, c1, c2 = ref.brsgd_masks(scores, l1, kth, T)
    return agg, engine.BrSGDState(w > 0, c1, c2, scores, l1, T)


def _eager_select(engine, G, cfg, return_state):
    """A fixed round of a select rule other than brsgd as the engine ran
    it before that round became one launch: B1's call and its partial
    sums (leaf_stats), the rule as torch ops and the weights' guard
    (resolve_select; for the mean, host-made unit weights copied to the
    card), then B3 (_combine_rows)."""
    spec = engine.get_spec(cfg.aggregator)
    m = G.shape[0]
    stats = engine.leaf_stats(G, spec.stats, m)
    w, st, _denom = engine.resolve_select(spec, stats, cfg, m, G.device)
    agg = engine._combine_rows(G, w)
    return (agg, st) if return_state else agg


@contextlib.contextmanager
def _eager_engine(engine, kern, ref, on: bool):
    """While ``on``, engine.aggregate_local takes, for a fixed round of a
    select rule or the median, the composition it ran before that round
    became one launch: brsgd's two-pass composition (_two_pass_brsgd), the
    other select rules' eager path (_eager_select), the median's B4 launch
    and its two partial sums (the median output kept).  Every other call
    is unchanged.  The yardstick the one launch is timed against in the
    same call."""
    fused = engine.aggregate_local

    def aggregate_local(G, cfg, return_state=False, spec=None, valid=None):
        if cfg.aggregator == "median" and spec is None and valid is None:
            out = kern.brsgd_stats(G)[0]
            return (out, None) if return_state else out
        if (spec is not None or valid is not None
                or engine.get_spec(cfg.aggregator).column is not None):
            return fused(G, cfg, return_state, spec, valid)
        if cfg.aggregator == "brsgd":
            return _two_pass_brsgd(kern, ref, engine, G, cfg, return_state)
        return _eager_select(engine, G, cfg, return_state)

    if on:
        engine.aggregate_local = aggregate_local
    try:
        yield
    finally:
        engine.aggregate_local = fused


def _device_kernels(torch, fn, reps: int = 10, tries: int = 5) -> dict:
    """Device kernels per fn() call, counted by torch.profiler over reps
    calls after one warm-up: {"per_call": n, "by_name": {name: count},
    "traces": t}.  fn issues the same kernels every call, so a trace in
    which a kernel shows a count that is not a multiple of reps (or no
    kernel at all) lost records: it is taken again, up to ``tries``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for t in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if names and all(n % reps == 0 for n in names.values()):
            break
    return {"per_call": sum(names.values()) / reps,
            "by_name": {k[:60]: n / reps for k, n in names.items()},
            "traces": t}


def phase_aggregation(torch, kern, ref):
    """One engine.aggregate_local(return_state=True) of each select rule
    and of the median at the paper's shape, five scaled workers: device
    kernels per call (torch.profiler; a host-to-device copy counts too)
    and host ms ending in a synchronize (median, p80 of HOST_REPS), the
    eager composition (brsgd: the two-pass one; the median: B4 and its
    two sums) and the one launch in turns.  The one launch must be one
    device kernel."""
    import numpy as np
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import engine
    rng = np.random.default_rng(11)
    G = torch.as_tensor(rng.normal(size=MAIN_SHAPE).astype(np.float32),
                        device="cuda")
    G[:5] *= 1e10
    out = {}
    for rule in ("brsgd", "mean") + GRAM_RULES + ("median",):
        cfg = ByzantineConfig(aggregator=rule, alpha=0.25)
        call = lambda: engine.aggregate_local(  # noqa: E731
            G, cfg, return_state=True)
        old = "two_pass" if rule == "brsgd" else "eager"
        kernels, host = {}, []
        for name, on in ((old, True), ("fused", False)):
            with _eager_engine(engine, kern, ref, on):
                kernels[name] = _device_kernels(torch, call)
        for on in (True, False, False, True):
            with _eager_engine(engine, kern, ref, on):
                host.append(_host_ms(torch, call))
        res = {"shape": list(MAIN_SHAPE), "device_kernels_per_call": kernels,
               "host_ms": {"order": [old, "fused", "fused", old],
                           "runs": host}}
        emit({"timing": f"{rule}_aggregate_local", **res})
        if kernels["fused"]["per_call"] != 1:
            fail(f"a {rule} aggregate_local issued {kernels['fused']} "
                 f"device kernels, expected one launch")
        out[rule] = res
    # the trimmed mean's aggregate_local: B5's launch and nothing else
    # (it never had another composition)
    cfg = ByzantineConfig(aggregator="trimmed_mean", alpha=0.1)
    kernels = _device_kernels(torch, lambda: engine.aggregate_local(
        G, cfg, return_state=True))
    emit({"timing": "trimmed_mean_aggregate_local", "shape": list(MAIN_SHAPE),
          "device_kernels_per_call": kernels})
    if kernels["per_call"] != 1:
        fail(f"a trimmed_mean aggregate_local issued {kernels} device "
             f"kernels, expected B5's one launch")
    out["trimmed_mean"] = {"device_kernels_per_call": {"fused": kernels}}
    return out


# ---------------------------------------------------------------------------
# 5. the main path: Table-1 runs on the card
# ---------------------------------------------------------------------------

def phase_main_path(torch, kern):
    from repro_torch.paper.common import train_lenet
    runs = [("mean", "none", 0.0), ("brsgd", "scale", 0.25),
            ("brsgd", "gaussian", 0.25), ("median", "gaussian", 0.25),
            ("krum", "scale", 0.25), ("trimmed_mean", "gaussian", 0.1),
            ("multi_krum", "scale", 0.25), ("geomedian", "scale", 0.25)]
    kern.reset_launches()
    acc, secs, per_run = {}, {}, {}
    for agg, attack, alpha in runs:
        before = dict(kern.LAUNCHES)
        t0 = time.perf_counter()
        acc[(agg, attack)], _ = train_lenet(agg, attack, alpha, steps=60)
        torch.cuda.synchronize()
        secs[f"{agg}/{attack}"] = time.perf_counter() - t0
        per_run[f"{agg}/{attack}"] = {k: n - before[k]
                                      for k, n in kern.LAUNCHES.items()
                                      if n - before[k]}
    launches = dict(kern.LAUNCHES)
    base = acc[("mean", "none")]
    emit({"check": "main_path", "steps_per_run": 60, "run_seconds": secs,
          "accuracy": {f"{a}/{t}": v for (a, t), v in acc.items()},
          "launches": launches, "launches_per_run": per_run})
    gated = (("brsgd", "scale"), ("brsgd", "gaussian"),
             ("trimmed_mean", "gaussian"), ("multi_krum", "scale"),
             ("geomedian", "scale"))
    for key in gated:
        if not acc[key] > base - 0.2:
            fail(f"{key}: accuracy {acc[key]} not within 0.2 of the "
                 f"no-attack mean baseline {base}")
    # each run launches exactly its rule's kernels, once a step; B2's
    # standalone launch is off the path since the fused kernel took its
    # place (phases 3 and 8 still hold it against its plain version)
    for agg, attack, _ in runs:
        want = {k: 60 for k in MAIN_PATH_KERNELS[agg]}
        if per_run[f"{agg}/{attack}"] != want:
            fail(f"{agg}/{attack} launched {per_run[f'{agg}/{attack}']}, "
                 f"expected {want}")
    for name in set().union(*MAIN_PATH_KERNELS.values()):
        if launches[name] == 0:
            fail(f"kernel {name} was never launched on the main path")
    return launches


# ---------------------------------------------------------------------------
# 6. the elastic path
# ---------------------------------------------------------------------------

def phase_elastic(torch, kern):
    import numpy as np
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import engine, threat
    from repro_torch.data.pipeline import ArrivalSchedule
    from repro_torch.paper import robustness as rob
    from repro_torch.paper.common import regression_problem
    m, d = MAIN_SHAPE
    q = int(0.75 * m)
    rng = np.random.default_rng(300)
    G = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32),
                        device="cuda")
    G[:5] *= 1e10                                      # scale-attacked rows
    arrival = torch.zeros(4, m, device="cuda")
    arrival[torch.as_tensor(rng.permutation(m) % 4), torch.arange(m)] = 1.0
    active = engine.arrival_active(arrival, q)
    G_cpu, active_cpu = G.cpu(), active.cpu()
    card_vs_cpu = {}
    for agg in engine.registered():
        cfg = ByzantineConfig(aggregator=agg, alpha=0.25, quorum=q, max_m=m)
        got, st = engine.stream_aggregate(G, cfg, arrival, None, True)
        want, bst = engine.aggregate_local(G, cfg, True, valid=active)
        cpu, cst = engine.aggregate_local(G_cpu, cfg, True, valid=active_cpu)
        torch.cuda.synchronize()
        # the masked statistics run as torch ops on either device: the
        # selection, medians and row-order sums agree exactly, the rest
        # (l1 sums, gram products, geomedian's iterations) within REL_TOL
        want_c = want.cpu()
        exact_rule = agg in ("median", "trimmed_mean")
        if not (torch.equal(bst.selected.cpu(), cst.selected)
                and (_exact(want_c, cpu) if exact_rule
                     else _rel_ok(want_c, cpu))):
            fail(f"aggregate_local {agg} (masked): card and CPU differ "
                 f"(max abs err {_err(want_c, cpu)}, selected "
                 f"{bst.selected.tolist()} vs {cst.selected.tolist()})")
        card_vs_cpu[agg] = {"bit_exact": _exact(want_c, cpu),
                            "max_abs_err": _err(want_c, cpu)}
        if not (_exact(got, want) and torch.equal(st.selected, bst.selected)):
            fail(f"stream_aggregate {agg}: differs from the bulk masked "
                 f"pass (max abs err {_err(got, want)})")
        if int(st.selected.sum()) > q or bool((st.selected
                                               & (active == 0)).any()):
            fail(f"stream_aggregate {agg}: selected a dropped worker or "
                 f"more than the quorum")
    emit({"check": "masked_card_vs_cpu", "shape": [m, d], "quorum": q,
          "selection": "equal", "rel_tol": REL_TOL, "rules": card_vs_cpu})
    emit({"check": "stream_equals_bulk", "shape": [m, d], "buckets": 4,
          "quorum": q, "aggregators": list(engine.registered()),
          "bit_exact": True})

    # the CLAIM subset of the robustness twin, at 1 seed
    kern.reset_launches()
    t0 = time.perf_counter()
    clean = rob.run("mean", "none", 0.0)
    errs = {(qq, "brsgd", a): rob.run("brsgd", a, quorum=qq)
            for qq in rob.CLAIM_QUORUMS for a in rob.ATTACKS}
    for a in ("scale", "negation"):
        errs[(rob.M, "mean", a)] = rob.run("mean", a)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    ok, lines = rob.claim(errs, clean)
    for line in lines:
        print(line, flush=True)
    emit({"check": "robustness_claim_subset", "seeds": 1,
          "clean": clean, "seconds": secs, "launches": launches,
          "errors": {f"{k[0]}/{k[1]}/{k[2]}": v if math.isfinite(v)
                     else str(v) for k, v in errs.items()}})
    if not ok:
        fail("the robustness CLAIM subset failed")

    # one elastic step at q = 15 (LeNet-width G, brsgd under scale)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bcfg = ByzantineConfig(aggregator="brsgd", attack="scale", alpha=0.25,
                           quorum=q, max_m=m)
    fixed = ByzantineConfig(aggregator="brsgd", attack="scale", alpha=0.25)
    Gc = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32),
                         device="cuda")
    w = torch.zeros(rob.D, device="cuda")
    sched_act = torch.as_tensor(ArrivalSchedule(m, q, byz=bcfg).active(0),
                                device="cuda")
    _, X, y = regression_problem(m, rob.N, 0, "cuda")
    Gr = torch.einsum("mnd,mn->md", X, torch.matmul(X, w) - y) / rob.N
    parts = {
        "lenet_width_elastic": lambda: engine.aggregate_local(
            threat.apply_dense(Gc, gen, bcfg, active=active), bcfg,
            return_state=True, valid=active),
        "lenet_width_fixed": lambda: engine.aggregate_local(
            threat.apply_dense(Gc, gen, fixed), fixed, return_state=True),
        "robustness_elastic": lambda: engine.aggregate_local(
            threat.apply_dense(Gr, gen, bcfg, active=sched_act), bcfg,
            valid=sched_act),
    }
    emit({"timing": "elastic_step_brsgd_scale", "quorum": q, "m": m,
          "reps": HOST_REPS,
          **{f"{k}_ms": _host_ms(torch, fn) for k, fn in parts.items()}})
    return launches


# ---------------------------------------------------------------------------
# 7. the serve path
# ---------------------------------------------------------------------------

def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _attn_apps(cfg) -> int:
    """Attention applications of one forward: one a layer, one a unit
    for hybrid (the shared block)."""
    if cfg.hybrid_attn_every:
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def _expected_prefill(cfg, S):
    if cfg.rwkv is not None:
        return {"wkv6_seq": cfg.n_layers}        # one launch a layer
    return {"flash_attention": _attn_apps(cfg)}


def _device_ms(torch, fn):
    """Device time of the kernels fn() launches, by group, from
    torch.profiler (kernels run one at a time on the one stream, so
    their sum is the device's busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {"flash_attention": 0.0, "flash_attention_bwd": 0.0,
              "wkv6_seq": 0.0, "wkv6_seq_bwd": 0.0, "gemm": 0.0,
              "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        g = ("flash_attention" if "flash_kernel" in name else
             "flash_attention_bwd" if "flash_bwd_" in name else
             "wkv6_seq" if "wkv6_seq_kernel" in name else
             "wkv6_seq_bwd" if "wkv6_bwd_" in name else
             "gemm" if ("gemm" in name or "cutlass" in name
                        or "xmma" in name) else "other")
        groups[g] += us / 1e3
    return groups


def _serve_profile(torch, cfg, res):
    """One prefill and 4 decode steps of the serve path under the
    profiler: device ms by kernel group, and the busy share against the
    unprofiled median host-clock times of serve.main."""
    from repro_torch.launch import serve
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = PM.init_params(TF.param_defs(cfg), gen, device="cuda")
    B, S, steps = res["batch"], res["prompt_len"], 4
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    cache = TF.init_cache(cfg, B, S + steps, torch.bfloat16, "cuda")
    serve.generate(cfg, params, prompt, steps, S + steps)       # warm-up
    state = {}

    def prefill():
        state["logits"], state["cache"] = TF.prefill_cache(cfg, params,
                                                           prompt, cache)

    def decode():
        tok = state["logits"][:, -1].argmax(-1)[:, None]
        for i in range(steps):
            lg, state["cache"] = TF.decode_step(cfg, params, state["cache"],
                                                tok, S + i)
            tok = lg.reshape(B, -1).argmax(-1)[:, None]

    out = {"check": "serve_profile", "arch": cfg.name}
    for phase, fn, wall in (("prefill", prefill, res["prefill_s"]),
                            ("decode_step", decode,
                             res["decode_s"] / res["gen"])):
        groups = _device_ms(torch, fn)
        busy = sum(groups.values()) / (steps if phase == "decode_step" else 1)
        out[phase] = {"device_ms_by_group": groups,
                      "per": ("4 steps" if phase == "decode_step"
                              else "prefill"),
                      "device_busy_ms": busy, "host_clock_ms": wall * 1e3,
                      "busy_share": busy / (wall * 1e3) if busy else
                      "not measured (the profiler saw no device time)"}
    emit(out)
    del params, cache, state


def _serve_full_width(torch, arch, args, cfg=None):
    """serve.main at full width with the launch counters read around it:
    B6 (B7) once a layer in each prefill, nothing in decode, finite
    logits.  With ``cfg`` (the arch at full width cut in depth), the
    launcher's single-shot function on it.  Returns (result, launches
    over every pass, launches of one prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    if cfg is None:
        cfg = get_config(arch)
        res = serve.main(["--arch", arch, *args])
    else:
        res = serve.single_shot(serve.parse_args(["--arch", arch, *args]),
                                cfg, torch.device("cuda"))
    secs = time.perf_counter() - t0
    counts = ops.launches()
    passes, S = res["repeat"], res["prompt_len"]
    want = _expected_prefill(cfg, S)
    pre = {k: n for k, n in res["launches"]["prefill"].items() if n}
    dec = {k: n for k, n in res["launches"]["decode"].items() if n}
    if pre != want or dec:
        fail(f"serve {arch}: prefill launched {pre} (expected {want}), "
             f"decode launched {dec} (expected none)")
    total = {k: n for k, n in counts.items() if n}
    if total != {k: n * passes for k, n in want.items()}:
        fail(f"serve {arch}: {passes} passes launched {total}")
    if not res["logits_finite"]:
        fail(f"serve {arch}: non-finite logits")
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit({"check": "serve", "arch": arch, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "batch": res["batch"],
          "prompt_len": S, "gen": res["gen"], "passes": passes,
          "prefill_launches": pre, "decode_launches": dec or "none",
          "launches_all_passes": total,
          "prefill_tok_s_median": res["prefill_tok_s"],
          "decode_tok_s_median": res["decode_tok_s"],
          "prefill_s_median": res["prefill_s"],
          "decode_s_median": res["decode_s"], "seconds": secs,
          "peak_mem_gb": res["peak_mem_gb"], "logits_finite": True})
    return res, total, pre


def _serve_card_vs_cpu(torch, arch, B, S, steps,
                       dtypes=("float32", "bfloat16"), n_layers=2):
    """The card against the host CPU at full width cut to ``n_layers``
    layers (with the config's seeded prefix before the prompt where it
    has one): the
    prefill's logits and ``steps`` teacher-forced decode steps over the
    float32 cache (held to SERVE_TOL) and over the serve path's bfloat16
    cache (held to BF16_CACHE_TOL: decode rounds the cache entries and
    the attention weights to bfloat16 on both devices, from float32
    values that differ in their last bits, so a rounding can land one
    bfloat16 step, 2^-8, apart), and the greedy tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as PL
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p_gpu = PM.init_params(TF.param_defs(cfg), gen, device="cuda")
    p_cpu = _tree_to(p_gpu, "cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda").cpu()
    P = cfg.n_prefix_tokens
    pfx = (torch.from_numpy(PL.prefix_embeddings(cfg, 0, (B,))) if P
           else None)
    for dt in dtypes:
        dtype = getattr(torch, dt)
        tol = SERVE_TOL if dt == "float32" else BF16_CACHE_TOL
        caches = {d: TF.init_cache(cfg, B, P + S + steps, dtype, d)
                  for d in ("cpu", "cuda")}
        lc, caches["cpu"] = TF.prefill_cache(cfg, p_cpu, tokens,
                                             caches["cpu"], pfx)
        lg, caches["cuda"] = TF.prefill_cache(
            cfg, p_gpu, tokens.cuda(), caches["cuda"],
            None if pfx is None else pfx.cuda())
        errs = [_err(lg.cpu(), lc) / float(lc.abs().max())]
        greedy_equal = bool(torch.equal(lg[:, -1].argmax(-1).cpu(),
                                        lc[:, -1].argmax(-1)))
        tok = lc[:, -1].argmax(-1)[:, None]
        for i in range(steps):
            lc, caches["cpu"] = TF.decode_step(cfg, p_cpu, caches["cpu"],
                                               tok, P + S + i)
            lg, caches["cuda"] = TF.decode_step(cfg, p_gpu, caches["cuda"],
                                                tok.cuda(), P + S + i)
            errs.append(_err(lg.cpu(), lc) / float(lc.abs().max()))
            nxt = lc.reshape(B, -1).argmax(-1)
            greedy_equal &= bool(torch.equal(
                lg.reshape(B, -1).argmax(-1).cpu(), nxt))
            tok = nxt[:, None]
        emit({"check": "serve_card_vs_cpu", "arch": arch,
              "n_layers": n_layers, "prefix_tokens": P,
              "d_model": cfg.d_model, "batch": B, "prompt_len": S,
              "decode_steps": steps, "cache_dtype": dt,
              "prefill_rel_err": errs[0],
              "decode_rel_err_max": max(errs[1:]),
              "prefill_rel_tol": SERVE_TOL, "decode_rel_tol": tol,
              "greedy_equal": greedy_equal,
              "seconds": time.perf_counter() - t0})
        if errs[0] > SERVE_TOL or max(errs[1:]) > tol or not greedy_equal:
            fail(f"serve {arch} ({dt} cache): card and CPU differ at "
                 f"full width (relative errors {errs}, greedy equal "
                 f"{greedy_equal})")
    del p_gpu, p_cpu, caches
    torch.cuda.empty_cache()


def phase_serve_profile(torch, results):
    """Each serve arch's profile (``_serve_profile``) beside phase 7's
    host times: after every library is loaded, since kernels of a library
    loaded after the process's first torch.profiler session were missing
    from later traces (on an H100: a brsgd aggregate_local counted 0
    device kernels in five traces)."""
    from repro_torch.configs import get_config
    for arch, res in results.items():
        _serve_profile(torch, get_config(arch), res)


def phase_serve(torch):
    """(a)/(b) serve.main at full width with the launch counters; (c) the
    card against the host CPU at full width cut to 2 layers; (d) prefill
    == sequential decode on the card for the reduced configs.  No
    profiler: it runs while the BrSGD libraries build (the profile is
    ``phase_serve_profile``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF

    results, launches, per_prefill = {}, {}, {}
    for arch in SERVE_ARCHS:
        res, total, pre = _serve_full_width(torch, arch, SERVE_ARGS)
        launches.update(total)
        per_prefill.update(pre)
        results[arch] = res

    # (c) card against the host CPU, full width, 2 layers, prompt 80
    for arch in SERVE_ARCHS:
        _serve_card_vs_cpu(torch, arch, 2, 80, 8)

    # (d) prefill == sequential decode on the card, reduced configs
    for arch in SERVE_ARCHS:
        cfg = get_config(arch).reduced()
        gen = torch.Generator(device="cuda").manual_seed(5)
        params = PM.init_params(TF.param_defs(cfg), gen, device="cuda")
        Bd, Sd, T = 2, 8, 12
        tokens = torch.randint(0, cfg.vocab, (Bd, Sd), generator=gen,
                               device="cuda")
        lf, cf = TF.prefill_cache(cfg, params, tokens,
                                  TF.init_cache(cfg, Bd, T, torch.float32,
                                                "cuda"))
        cache = TF.init_cache(cfg, Bd, T, torch.float32, "cuda")
        ls = []
        for s_ in range(Sd):
            lg, cache = TF.decode_step(cfg, params, cache,
                                       tokens[:, s_:s_ + 1], s_)
            ls.append(lg[:, 0])
        ls = torch.stack(ls, dim=1)
        err = _err(lf, ls) / float(ls.abs().max())
        leaf = max(_err(cf[g][k], cache[g][k]) / float(cache[g][k].abs().max())
                   for g in cf for k in cf[g])
        emit({"check": "prefill_equals_sequential_decode", "arch": cfg.name,
              "logits_rel_err": err, "cache_rel_err": leaf,
              "rel_tol": SERVE_TOL})
        if err > SERVE_TOL or leaf > SERVE_TOL:
            fail(f"{cfg.name}: prefill differs from sequential decode on the "
                 f"card (logits {err}, cache {leaf})")
    return results, launches, per_prefill


# ---------------------------------------------------------------------------
# 7b. the continuous-batching serve loop
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@contextlib.contextmanager
def _first_inputs(torch, ops, names):
    """While the block runs, each ``ops.<name>`` of ``names`` keeps a
    clone of the arguments of its first call at every distinct signature
    (shapes, dtypes and the int arguments): yields {name: {signature:
    args}}, so a kernel can later be held against its plain version on
    the inputs a path really gave it."""
    seen = {n: {} for n in names}
    orig = {n: getattr(ops, n) for n in names}

    def wrap(n):
        def call(*args):
            key = tuple((tuple(a.shape), str(a.dtype))
                        if torch.is_tensor(a) else a for a in args)
            if key not in seen[n]:
                seen[n][key] = tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args)
            return orig[n](*args)
        return call
    for n in names:
        setattr(ops, n, wrap(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(ops, n, orig[n])


def _check_loop_inputs(torch, ref, arch, seen, worst) -> int:
    """B6 / B7 on the inputs the serve loop's prefills gave them (the
    first call at each distinct shape) against their plain versions."""
    n = 0
    for args in seen["flash_attention"].values():
        q, k, v, win = args
        B, H, S, D = q.shape
        _check_flash(torch, ref, q, k, v, win,
                     f"[{B},{H},{k.shape[1]},{S},{D}] window={win} "
                     f"{str(q.dtype).replace('torch.', '')}", worst,
                     {"from": f"serve loop {arch} prefill"})
        n += 1
    for args in seen["wkv6_seq"].values():
        r = args[0]
        B, S, H, K = r.shape
        _check_wkv_seq(torch, ref, args[:6], args[6], f"[{B},{S},{H},{K}]",
                       worst, {"from": f"serve loop {arch} prefill"})
        n += 1
    return n


def _margin(torch, logits) -> float:
    """(top1 - top2) / max|logit| of one row of logits."""
    top = torch.topk(logits.float().reshape(-1), 2).values
    return float((top[0] - top[1]) / logits.float().abs().max())


def _near_tie_compare(got, want, margin_at, tol=NEAR_TIE) -> dict:
    """Tokens of one request against its reference: equal, or first
    different where the reference's top-two logits lie within ``tol`` of
    its max|logit| (a near tie); anything else fails."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        fail(f"serve loop: {got.shape[0]} tokens against {want.shape[0]}")
    diff = np.flatnonzero(got != want)
    if not diff.size:
        return {"equal": True}
    j = int(diff[0])
    m = margin_at(j)
    if m > tol:
        fail(f"serve loop: token {j} is {got[j]}, the reference's {want[j]}, "
             f"and the reference's top-two margin {m:.3e} of max|logit| is "
             f"no near tie (<= {tol})")
    return {"equal": False, "near_tie_at": j, "margin": m}


def _ties(rows) -> dict:
    """The near-tie count of a list of _near_tie_compare rows."""
    return {"requests": len(rows),
            "near_ties": sum(not r["equal"] for r in rows),
            "near_tie_detail": [r for r in rows if not r["equal"]]}


def _against_solo_loop(ServeLoop, cfg, params, stream, done, max_batch,
                       max_len):
    """Every request of a loop against the same loop shape serving it
    alone (one request at a time, slot 0, the other slots dead): the same
    prefill and the same decode graph shapes on one card, so tokens are
    exact unless the loop leaks across slots."""
    import numpy as np
    solo = ServeLoop(cfg, max_batch, max_len, params=params)
    for rid, (prompt, _) in enumerate(stream):
        srid = solo.submit(prompt, len(done[rid]))
        want = solo.run()[srid]
        if not np.array_equal(done[rid], want):
            fail(f"serve loop {cfg.name}: request {rid} emitted "
                 f"{done[rid].tolist()}, served alone {want.tolist()}")
    if solo.decode_graphs() != 1:
        fail(f"serve loop: the solo loop captured {solo.decode_graphs()} "
             f"graphs")
    return len(stream)


def _generate_margin(torch, serve, cfg, params, prompt, j, max_len):
    """The margin of the logits that decide token j of serve.generate."""
    _, lg, *_ = serve.generate(cfg, params, prompt, j, max_len)
    return _margin(torch, lg[0, -1])


def _against_generate(torch, serve, cfg, params, stream, done, max_len,
                      tol):
    """Every request's tokens against its isolated batch-1 serve.generate
    decode on the same params (exact-length prefill), under the near-tie
    rule at ``tol``."""
    rows = []
    for rid, (prompt, _) in enumerate(stream):
        p = torch.as_tensor(prompt, device="cuda")[None]
        want, *_ = serve.generate(cfg, params, p, len(done[rid]), max_len)
        rows.append(_near_tie_compare(
            done[rid], want[0].cpu().numpy(),
            lambda j: _generate_margin(torch, serve, cfg, params, p, j,
                                       max_len), tol))
    return rows


def _switching_reference(torch, TF, cfg, p_old, p_new, prompt, gen,
                         swap_step, max_len):
    """Greedy batch-1 eager decode on the card switching params after
    ``swap_step`` decode steps (None = never), sharing the cache across
    the switch; returns (tokens, margin of each token's logits)."""
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    cache = TF.init_cache(cfg, 1, max_len, dtype, "cuda")
    p = torch.as_tensor(prompt, device="cuda")[None]
    logits, cache = TF.prefill_cache(cfg, p_old, p, cache)
    lg = logits[0, -1]
    toks, margins, pos = [], [], p.shape[1]
    for i in range(gen):
        tok = torch.argmax(lg)
        toks.append(int(tok))
        margins.append(_margin(torch, lg))
        if i == gen - 1:
            break
        params = p_old if swap_step is None or i < swap_step else p_new
        lg, cache = TF.decode_step(cfg, params, cache, tok.reshape(1, 1),
                                   pos + i)
        lg = lg[0, 0]
    return toks, margins


def _loop_decode_device(torch, loop, reps: int = 20) -> dict:
    """Device time of one decode step of a finished loop: its graph
    replayed back to back, by CUDA events and by torch.profiler (the
    kernels of one replay, by group)."""
    params = loop.params()
    _, graph, _ = loop._graphs[id(params)]
    ev_ms = _time_ms(torch, graph.replay, reps)
    groups = _device_ms(torch, lambda: [graph.replay() for _ in range(5)])
    busy = sum(groups.values()) / 5
    return {"event_ms": ev_ms,
            "profiler_ms": busy if busy else None,
            "profiler_ms_by_group": {k: v / 5 for k, v in groups.items()}}


def _check_loop_launches(arch, cfg, res) -> dict:
    """The loop ran on the card with a decode graph, its prefills
    launched B6 / B7 as the table says and its decode steps none;
    returns the measured launches per admission."""
    loop = res["loop"]
    want = {k: n * res["prefills"]
            for k, n in _expected_prefill(cfg, 0).items()}
    if loop.device.type != "cuda" or res["decode_graphs"] < 1:
        fail(f"serve loop {arch}: ran on {loop.device} with "
             f"{res['decode_graphs']} decode graphs")
    if loop.prefill_launches != want or res["launches"] != want:
        fail(f"serve loop {arch}: prefills launched {loop.prefill_launches} "
             f"(all launches {res['launches']}), expected {want}")
    if loop.decode_launches:
        fail(f"serve loop {arch}: the decode step launched "
             f"{loop.decode_launches} (expected none)")
    return {k: n // res["prefills"] for k, n in loop.prefill_launches.items()}


def phase_serve_loop(torch, ref, worst):
    """(a) serve.main --serve-loop at full width, qwen3-0.6b from a port
    checkpoint, rwkv6-7b from --seed, with B6 / B7 held against their
    plain versions on the inputs its prefills gave them; (b) a hot swap
    to negated params at decode step SWAP_AT; (c) every request against
    the loop serving it alone and against its isolated serve.generate
    decode, over the bfloat16 cache and again over a float32 cache;
    (d) B6 / B7 launches per admission, none in decode; (e) a torn and a
    corrupt publish quarantined, a stalled slot requeued; (f) the loop's
    decode tok/s and its decode step's device time against the host's."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.faults import get_spec
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    from repro_torch.serving import HotSwapper, ServeLoop

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="serve_loop_", dir=ROOT / "build"))
    out, launches, per_admission = {}, {}, {}
    try:
        for arch, args in SERVE_LOOP_ARGS.items():
            cfg = get_config(arch)
            args = ["--arch", arch, "--serve-loop", *args]
            d = None
            if arch == SWAP_ARCH:
                d = str(tmp / arch)
                gen = torch.Generator(device="cuda").manual_seed(0)
                params = PM.init_params(TF.param_defs(cfg), gen,
                                        device="cuda")
                t0 = time.perf_counter()
                ckpt.save(d, params, step=1)
                save_s = time.perf_counter() - t0
                del params
                args += ["--ckpt-dir", d, "--metrics-out",
                         str(tmp / "metrics.txt")]
            # (a) + (d)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            with _first_inputs(torch, ops, ("flash_attention",
                                            "wkv6_seq")) as seen:
                t0 = time.perf_counter()
                res = serve.main(args)
                secs = time.perf_counter() - t0
            counts = {k: n for k, n in ops.launches().items() if n}
            loop = res["loop"]
            per = _check_loop_launches(arch, cfg, res)
            if counts != res["launches"]:
                fail(f"serve loop {arch}: counters read {counts}")
            if res["decode_graphs"] != 1:
                fail(f"serve loop {arch}: {res['decode_graphs']} decode "
                     f"graphs without a swap (expected 1)")
            if res["prefills"] <= res["max_batch"]:
                fail(f"serve loop {arch}: {res['prefills']} prefills on "
                     f"{res['max_batch']} slots: no slot was used again")
            stream, done = res["stream"], res["done"]
            if sorted(done) != list(range(len(stream))) or any(
                    len(done[r]) != g for r, (_, g) in enumerate(stream)):
                fail(f"serve loop {arch}: not every request completed")
            if any(int(t) < 0 or int(t) >= cfg.vocab
                   for v in done.values() for t in v):
                fail(f"serve loop {arch}: a token outside the vocabulary")
            launches.update(counts)
            per_admission.update(per)
            lat = loop.metrics.step_lat_s
            replay = lat[1:]          # the first step is the graph's warm-up
            row = {"check": "serve_loop", "arch": arch,
                   "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "requests": res["requests"], "max_batch": res["max_batch"],
                   "max_len": res["max_len"], "tokens": res["tokens"],
                   "seconds": secs, "loop_s": res["seconds"],
                   "tok_s": res["tok_s"], "steps": res["steps"],
                   "decode_tokens": res["decode_tokens"],
                   "decode_s": res["decode_s"],
                   "decode_tok_s": res["decode_tok_s"],
                   "step_ms_first": lat[0] * 1e3,
                   "step_ms_median": float(np.median(replay)) * 1e3,
                   "step_ms_p90": float(np.percentile(replay, 90)) * 1e3,
                   "decode_graphs": res["decode_graphs"],
                   "prefill_shapes": res["prefill_shapes"],
                   "prefills": res["prefills"],
                   "launches_per_admission": per, "decode_launches": "none",
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            # the prefill kernels on the loop's own inputs
            row["prefill_inputs_checked"] = _check_loop_inputs(
                torch, ref, arch, seen, worst)
            if not row["prefill_inputs_checked"]:
                fail(f"serve loop {arch}: no prefill kernel input seen")
            del seen
            # (c) every request against the same loop serving it alone
            # (exact), and against its isolated serve.generate decode.
            # Over the bfloat16 cache at BF16_CACHE_TOL: the batched
            # graph's GEMMs and the batch-1 eager ones round the last
            # bits differently, and the bfloat16 cache (qwen3's K/V and
            # attention weights, with the bucket's pad keys in the
            # unmasked row max; rwkv6's wkv state, rounded every step)
            # turns those bits into ~1e-3 of max|logit|.  The same stream
            # over a float32 cache, where nothing rounds them up, is held
            # at NEAR_TIE.
            sub_s = {"serve_main": secs}
            t0 = time.perf_counter()
            row["equal_to_solo_loop"] = _against_solo_loop(
                ServeLoop, cfg, loop.params(), stream, done,
                res["max_batch"], res["max_len"])
            sub_s["solo_loops"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            row["against_generate"] = {
                "cache_dtype": cfg.dtype, "near_tie_tol": BF16_CACHE_TOL,
                **_ties(_against_generate(
                    torch, serve, cfg, loop.params(), stream, done,
                    res["max_len"], BF16_CACHE_TOL))}
            sub_s["against_generate"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            row["float32_cache"] = _float32_cache_loop(
                torch, serve, ServeLoop, dataclasses.replace(
                    cfg, dtype="float32"), loop.params(), stream,
                res["max_batch"], res["max_len"])
            sub_s["float32_cache"] = time.perf_counter() - t0
            row["sub_seconds"] = sub_s
            # (f) the decode step's device time: its graph replayed
            dev = _loop_decode_device(torch, loop)
            row["decode_step_device_ms"] = dev
            row["full_batch_tok_s"] = (res["max_batch"]
                                       / row["step_ms_median"] * 1e3)
            # the least time of one step: every parameter and the whole
            # cache read once; 2 FLOPs a parameter a slot (float32)
            p_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(loop.params()))
            c_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(loop.cache.bufs))
            bound, by = _bound(p_bytes + c_bytes,
                               2 * p_bytes / 4 * res["max_batch"])
            row.update(decode_bound_ms=bound, decode_bound_by=by,
                       param_bytes=p_bytes, cache_bytes=c_bytes)
            for k in ("event_ms", "profiler_ms"):
                row[f"busy_share_{k}"] = (
                    dev[k] / row["step_ms_median"] if dev[k] else
                    "not measured (the profiler saw no device time)")
            if d is not None:
                row["ckpt_save_s"] = save_s
                row["initial_restore_s"] = loop.swapper.last_stall_s
            emit(row)
            out[arch] = row
            del res, loop, done
            if d is not None:
                t0 = time.perf_counter()
                out["swap"] = _swap_and_faults(torch, ckpt, get_spec, TF,
                                               serve, HotSwapper, ServeLoop,
                                               cfg, d, stream)
                emit({"check": "serve_loop_swap_and_faults_seconds",
                      "seconds": time.perf_counter() - t0})
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches, per_admission


def _float32_cache_loop(torch, serve, ServeLoop, cfg, params, stream,
                        max_batch, max_len) -> dict:
    """The same stream, params and slot count through a loop over a
    float32 cache (``cfg.dtype`` float32), every request held to its
    float32-cache serve.generate decode at NEAR_TIE."""
    loop = ServeLoop(cfg, max_batch, max_len, params=params)
    for prompt, g in stream:
        loop.submit(prompt, g)
    done = loop.run()
    if loop.decode_graphs() != 1 or loop.decode_launches:
        fail(f"serve loop {cfg.name} float32 cache: "
             f"{loop.decode_graphs()} decode graphs, decode launched "
             f"{loop.decode_launches}")
    if sorted(done) != list(range(len(stream))) or any(
            len(done[r]) != g for r, (_, g) in enumerate(stream)):
        fail(f"serve loop {cfg.name} float32 cache: not every request "
             f"completed")
    del loop
    return {"cache_dtype": "float32", "near_tie_tol": NEAR_TIE,
            **_ties(_against_generate(torch, serve, cfg, params, stream,
                                      done, max_len, NEAR_TIE))}


def _swap_and_faults(torch, ckpt, get_spec, TF, serve, HotSwapper, ServeLoop,
                     cfg, d, stream):
    """(b) a mid-stream swap to negated params, (e) the faults, at full
    width cut to SWAP_LAYERS layers, from a checkpoint of that depth
    beside (a)'s.  Both loops keep a float32 cache, so their tokens are
    held to batch-1 eager references under the near-tie rule at NEAR_TIE
    (the bfloat16 cache's rounding would mask it)."""
    import dataclasses
    import numpy as np
    from repro_torch.models import params as PM
    cfg = dataclasses.replace(cfg, dtype="float32", n_layers=SWAP_LAYERS)
    d = f"{d}_{SWAP_LAYERS}_layers"
    ckpt.save(d, PM.init_params(TF.param_defs(cfg), torch.Generator(
        device="cuda").manual_seed(0), device="cuda"), step=1)
    max_len = max(len(p) for p, _ in stream) + max(SWAP_GEN, FAULT_GEN)
    # (b): SWAP_REQUESTS requests, all admitted at the first tick, the
    # negated params published after decode step SWAP_AT
    swapper = HotSwapper(d, like=serve.meta_params(cfg), device="cuda")
    loop = ServeLoop(cfg, 8, max_len, swapper=swapper)
    reqs = [(p, SWAP_GEN) for p, _ in stream[:SWAP_REQUESTS]]
    rids = [loop.submit(p, g) for p, g in reqs]
    publish = {}

    def on_step(lp, s):
        if s == SWAP_AT:
            neg = _tree_map(lambda t: -(t.cpu()), lp.params())
            t0 = time.perf_counter()
            ckpt.save(d, neg, step=2)
            publish["save_s"] = time.perf_counter() - t0

    done = loop.run(on_step=on_step)
    p_new = swapper.params()
    p_old = swapper._slots[1 - swapper._active]
    if (swapper.swap_count, swapper.loaded_step, loop.decode_graphs()) != (
            1, 2, 2):
        fail(f"serve loop swap: swap_count {swapper.swap_count}, step "
             f"{swapper.loaded_step}, {loop.decode_graphs()} decode graphs "
             f"(expected 1, 2, 2)")
    rows, differs = [], 0
    for rid, (prompt, g) in zip(rids, reqs):
        want, margins = _switching_reference(torch, TF, cfg, p_old, p_new,
                                              prompt, g, SWAP_AT, max_len)
        rows.append(_near_tie_compare(done[rid], want,
                                      lambda j: margins[j]))
        never, _ = _switching_reference(torch, TF, cfg, p_old, p_new, prompt,
                                        g, None, max_len)
        differs += not np.array_equal(done[rid], never)
    if not differs:
        fail("serve loop swap: every stream equals the never-swapped one")
    swap = {"check": "serve_loop_swap", "arch": cfg.name,
            "cache_dtype": "float32", "gen": SWAP_GEN, "swap_at": SWAP_AT,
            "swap_count": swapper.swap_count,
            "loaded_step": swapper.loaded_step,
            "decode_graphs": loop.decode_graphs(),
            "swap_stall_s": swapper.swap_stall_s,
            "publish_save_s": publish["save_s"],
            "near_tie_tol": NEAR_TIE, **_ties(rows),
            "differ_from_never_swapped": differs}
    emit(swap)
    del loop, swapper, p_new, p_old
    torch.cuda.empty_cache()

    # (e): a torn and a corrupt publish under live decode, and a stalled
    # slot with a request timeout, on a loop serving step 2
    ckpt.prune(d, 1)
    swapper = HotSwapper(d, like=serve.meta_params(cfg), device="cuda")
    loop = ServeLoop(cfg, 4, max_len, swapper=swapper,
                     request_timeout=FAULT_TIMEOUT)
    reqs = [(p, FAULT_GEN) for p, _ in stream[:FAULT_REQUESTS]]
    rids = [loop.submit(p, g) for p, g in reqs]
    fired = {}

    def on_fault(lp, s):
        if s in (2, 4):
            step = 3 if s == 2 else 4
            fault = "torn_ckpt" if s == 2 else "corrupt_ckpt"
            ckpt.save(d, _tree_map(lambda t: t.cpu(), lp.params()),
                      step=step)
            fired[fault] = get_spec(fault).inject(d, step,
                                                  np.random.default_rng(s))
        if s == 3:
            ctx = type("Ctx", (), {"loop": lp, "stall_ticks": FAULT_STALL})()
            fired["slot_stall"] = get_spec("slot_stall").inject(
                ctx, np.random.default_rng(0))

    done = loop.run(on_step=on_fault)
    if sorted(swapper.quarantined) != [3, 4] or swapper.loaded_step != 2:
        fail(f"serve loop faults: quarantined {swapper.quarantined}, "
             f"serving step {swapper.loaded_step} (expected [3, 4], 2)")
    if loop.metrics.requeues < 1 or sorted(done) != sorted(rids) or any(
            len(done[r]) != FAULT_GEN for r in rids):
        fail(f"serve loop faults: {loop.metrics.requeues} requeues, "
             f"{len(done)} of {len(rids)} requests complete")
    if loop.decode_graphs() != 1:
        fail(f"serve loop faults: {loop.decode_graphs()} decode graphs")
    cmp = _against_generate(torch, serve, cfg, swapper.params(),
                            reqs, done, max_len, NEAR_TIE)
    faults = {"check": "serve_loop_faults", "arch": cfg.name,
              "cache_dtype": "float32", "gen": FAULT_GEN,
              "stall_ticks": FAULT_STALL, "request_timeout": FAULT_TIMEOUT,
              "fired": fired,
              "quarantined": {str(k): v[:120]
                              for k, v in swapper.quarantined.items()},
              "requeues": loop.metrics.requeues,
              "completed": loop.metrics.completed,
              "decode_graphs": loop.decode_graphs(),
              "near_tie_tol": NEAR_TIE, **_ties(cmp)}
    emit(faults)
    del loop, swapper
    return {"swap": swap, "faults": faults}


# ---------------------------------------------------------------------------
# 7c. the training loss and its gradient at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _plain_versions_refuse_the_card(torch, extra=()):
    """B6's and B7's plain versions (and ``extra`` ones of ``ref``) raise
    for a CUDA tensor while the block runs: the gradient on the card must
    go through the kernels."""
    from repro_torch.kernels import ref
    names = ("flash_attention_ref", "wkv6_seq_plain",
             "wkv6_chunk_plain") + tuple(extra)
    saved = {n: getattr(ref, n) for n in names}

    def guard(name, fn):
        def call(*args, **kw):
            if any(torch.is_tensor(a) and a.is_cuda for a in args):
                raise RuntimeError(f"{name}: the plain version was called "
                                   f"on the card")
            return fn(*args, **kw)
        return call
    for n, fn in saved.items():
        setattr(ref, n, guard(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ref, n, fn)


def _flat_leaves(tree) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update({f"{k}/{n}" if n else k: t
                        for n, t in _flat_leaves(tree[k]).items()})
        return out
    return {"": tree}


def _gradient(torch, TF, cfg, params, leaves, batch, remat):
    """One worker's loss_fn and torch.autograd.grad over every leaf."""
    loss, _ = TF.loss_fn(cfg, params, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def _grad_on_card(torch, ops, TF, PL, cfg, params, leaves, kind, B, S,
                  remat):
    """The full-width gradient at [B, S] (after the pipeline's prefix
    where the config has one): launch counts, the loss against
    the no_grad forward's (bit for bit), finite gradients, host ms
    (median of GRAD_REPS), peak memory and device ms by group."""
    batch = {k: torch.from_numpy(v[0]).to("cuda") for k, v in
             PL.LMWorkerPipeline(cfg, 2, B, S, seed=0).batch(0).items()}
    fwd, bwd = GRAD_KERNELS[kind]
    with torch.no_grad():
        ops.reset_launches()
        ng_loss, _ = TF.loss_fn(cfg, params, batch)
        torch.cuda.synchronize()
        ng_launches = ops.launches()
    # the first gradient is read (launches, copies, peak memory, finite)
    # and timed with the others; the cache is emptied before each: at
    # rwkv6-7b's width the blocks a gradient frees are split by the next
    # one's per-layer gradients, and its stacked ones then find no room
    # (an OOM with 22 GB cached); the host time includes the allocations
    ts = []
    for i in range(GRAD_REPS):
        torch.cuda.empty_cache()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
        t0 = time.perf_counter()
        loss, grads = _gradient(torch, TF, cfg, params, leaves, batch, remat)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            loss0, got, copies = loss, ops.launches(), ops.copies()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            finite = bool(torch.isfinite(loss)) and all(
                bool(torch.isfinite(g).all()) for g in grads)
        del grads
    L = _attn_apps(cfg)
    want = {fwd: 2 * L if remat else L, bwd: L}
    res = {"check": "gradient", "arch": cfg.name, "batch": B, "seq": S,
           "prefix_tokens": cfg.n_prefix_tokens,
           "remat": remat, "loss": float(loss0), "no_grad_loss":
           float(ng_loss), "loss_equals_no_grad_bits":
           _same_bits(torch, loss0, ng_loss), "finite": finite,
           "launches": {k: got[k] for k in want},
           "no_grad_launches": {k: ng_launches[k] for k in want},
           "gradient_input_copies": copies, "peak_device_gb": peak_gb}
    others = {k: n for k, n in got.items() if n and k not in want}
    if (not finite or not res["loss_equals_no_grad_bits"]
            or any(copies.values())
            or {k: got[k] for k in want} != want or others
            or ng_launches[fwd] != L or ng_launches[bwd] != 0):
        fail(f"gradient {cfg.name} [{B}, {S}] remat={remat}: {res} "
             f"(expected launches {want}, no others: {others}, and no "
             f"gradient input copied)")
    res["host_ms"] = sorted(ts)[len(ts) // 2]
    res["host_ms_runs"] = ts

    def once():
        _, g = _gradient(torch, TF, cfg, params, leaves, batch, remat)
        del g
    torch.cuda.empty_cache()
    res["device_ms_by_group"] = _device_ms(torch, once)
    res["device_busy_ms"] = sum(res["device_ms_by_group"].values())
    emit(res)
    return res


def _grad_card_vs_cpu(torch, TF, PL, PM, cfg):
    """The gradient of full-width cfg cut to GRAD_CPU_LAYERS layers on the
    card against the same on the host CPU (the plain versions)."""
    import dataclasses
    cfg2 = dataclasses.replace(cfg, n_layers=GRAD_CPU_LAYERS)
    p_gpu = PM.init_params(TF.param_defs(cfg2), torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    p_cpu = _tree_to(p_gpu, "cpu")
    toks = PL.LMWorkerPipeline(cfg2, 1, 1, GRAD_CPU_SEQ,
                               seed=3).batch(0)["tokens"][0]
    out = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        leaves = _flat_leaves(p)
        for t in leaves.values():
            t.requires_grad_(True)
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        loss, grads = _gradient(torch, TF, cfg2, p, list(leaves.values()),
                                batch, False)
        out[dev] = (float(loss), dict(zip(leaves, (g.cpu() for g in grads))))
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    # float32 on the host: a 1e-4 relative tolerance needs no float64
    errs = {k: float((gg[k] - gc[k]).abs().max()
                     / max(float(gc[k].abs().max()), 1e-30)) for k in gc}
    res = {"check": "gradient_card_vs_cpu", "arch": cfg.name,
           "n_layers": GRAD_CPU_LAYERS, "seq": GRAD_CPU_SEQ,
           "loss_rel_err": abs(lg - lc) / abs(lc),
           "worst_leaf": max(errs, key=errs.get),
           "worst_leaf_rel_err": max(errs.values()),
           "tol": {"loss": GRAD_CPU_TOL[0], "leaf": GRAD_CPU_TOL[1]}}
    if not (res["loss_rel_err"] <= GRAD_CPU_TOL[0]
            and res["worst_leaf_rel_err"] <= GRAD_CPU_TOL[1]):
        fail(f"gradient card vs CPU {cfg.name}: {res} (leaves {errs})")
    emit(res)


def phase_grad(torch):
    """One worker's loss_fn and its gradient over every parameter at
    full width, on batches from LMWorkerPipeline, with the plain versions
    of B6 and B7 refusing the card; then card = CPU at 2 layers."""
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as PL
    from repro_torch.kernels import ops
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    results, launches = [], {name: 0 for name in BWD_KERNELS}
    torch.cuda.empty_cache()
    for arch in dict.fromkeys(a for a, *_ in GRAD_CASES):
        cfg = get_config(arch)
        kind = TF.segments(cfg)[0].kind
        params = PM.init_params(
            TF.param_defs(cfg), torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        leaves = list(_flat_leaves(params).values())
        for t in leaves:
            t.requires_grad_(True)
        with _plain_versions_refuse_the_card(torch):
            for a, B, S, remat in GRAD_CASES:
                if a == arch:
                    t0 = time.perf_counter()
                    res = _grad_on_card(torch, ops, TF, PL, cfg, params,
                                        leaves, kind, B, S, remat)
                    res["seconds"] = time.perf_counter() - t0
                    results.append(res)
                    bwd = GRAD_KERNELS[kind][1]
                    launches[bwd] += res["launches"][bwd]
        del params, leaves
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _grad_card_vs_cpu(torch, TF, PL, PM, cfg)
        emit({"check": "gradient_card_vs_cpu_seconds", "arch": arch,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    return results, launches


# ---------------------------------------------------------------------------
# 7d. the BrSGD train step at full width
# ---------------------------------------------------------------------------

def _sample_starts(torch, d: int) -> list:
    """The first columns of the sampled aggregate blocks: the first, the
    last and TRAIN_SAMPLE_BLOCKS - 2 drawn from a fixed seed."""
    n = TRAIN_SAMPLE_COLUMNS
    drawn = torch.randint(0, d - n, (TRAIN_SAMPLE_BLOCKS - 2,),
                          generator=torch.Generator().manual_seed(0))
    return sorted({0, d - n, *(int(x) for x in drawn)})


@contextlib.contextmanager
def _step_probe(torch, threat, engine):
    """Wraps the step's attack and aggregation: CUDA events at their
    edges (the step's split into gradients / attack / aggregate / the
    rest), the G and the state the aggregation saw, and copies of the
    aggregate's sampled blocks (the update then scales the aggregate in
    place)."""
    seen = {"events": []}
    saved = threat.apply_dense_, engine.aggregate_local

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        seen["events"].append(ev)

    def attack(G, *args, **kw):
        mark()
        out = saved[0](G, *args, **kw)
        mark()
        return out

    def aggregate(G, *args, **kw):
        out = saved[1](G, *args, **kw)
        mark()
        agg = out[0] if isinstance(out, tuple) else out
        seen["G"], seen["result"] = G, out
        seen["agg_blocks"] = {
            a: agg[a:a + TRAIN_SAMPLE_COLUMNS].clone()
            for a in _sample_starts(torch, agg.numel())
        } if agg.numel() > TRAIN_SAMPLE_COLUMNS else {0: agg.clone()}
        return out
    threat.apply_dense_, engine.aggregate_local = attack, aggregate
    try:
        yield seen
    finally:
        threat.apply_dense_, engine.aggregate_local = saved


def _train_step_timed(torch, ops, step, args, seen):
    """One step: launches and copies, host ms ending in a synchronize,
    and its split by CUDA events (gradients, attack, aggregate, the norm
    and update with the metrics' reads).  The probe's copies of the step
    before are dropped first: its aggregate (one D-sized buffer) would
    otherwise stay alive through this step's gradients."""
    for k in ("G", "result", "agg_blocks"):
        seen.pop(k, None)
    seen["events"].clear()
    ops.reset_launches()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out = step(*args)
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    e = [start] + seen["events"][-3:] + [end]
    split = {k: e[i].elapsed_time(e[i + 1]) for i, k in enumerate(
        ("gradients", "attack", "aggregate", "norm_and_update"))}
    return out, host, split, ops.launches(), ops.copies()


def _check_step_launches(label, got, copies, want):
    others = {k: n for k, n in got.items() if n and k not in want}
    if {k: got[k] for k in want} != want or others or any(copies.values()):
        fail(f"train step {label}: launches {got}, copies {copies}; "
             f"expected {want} and nothing else, no gradient input copied")


def _selection_margins(torch, scores, l1, beta, T) -> dict:
    """How far a brsgd selection lies from a tie: the gap below the kth
    score and the smallest |l1 - 2T| relative to 2T."""
    from repro_torch.kernels import ref
    sc = torch.sort(scores.double().cpu()).values
    k_idx, _ = ref.brsgd_rank_indices(scores.numel(), beta)
    below = sc[sc < sc[k_idx]]
    two_t = 2.0 * float(T)
    return {"kth_score": float(sc[k_idx]),
            "kth_gap": float(sc[k_idx] - below.max()) if below.numel()
            else None,
            "l1_margin": float((l1.double().cpu() - two_t).abs().min()
                               / two_t)}


def _hold_launch_on_blocks(torch, G, st, agg_blocks, beta, threshold) -> dict:
    """The full-width launch against plain statistics summed over
    TRAIN_CHECK_BLOCK-column blocks (the statistics add over disjoint
    column ranges): scores exact (the blocks' whole counts summed in
    float64), l1 within REL_TOL; selected and 𝔗 from the launch's own
    scores and l1 through the plain rule, exact; the aggregate bit-equal
    to masked_mean_det of the launch's weights on sampled blocks."""
    from repro_torch.kernels import ref
    m, d = G.shape
    sc = torch.zeros(m, dtype=torch.float64, device=G.device)
    l1 = torch.zeros(m, dtype=torch.float64, device=G.device)
    for a in range(0, d, TRAIN_CHECK_BLOCK):
        part = ref.fused_stats_ref(G[:, a:a + TRAIN_CHECK_BLOCK],
                                   ("scores", "l1"))
        sc += part["scores"].double()
        l1 += part["l1"].double()
    sc32 = sc.float()
    res = {"blocks": -(-d // TRAIN_CHECK_BLOCK),
           "scores_equal": bool(torch.equal(st.scores, sc32)),
           "l1_rel_err": float((st.l1.double() - l1).abs().max()
                               / l1.abs().max())}
    sel, _, _, T = ref.brsgd_select_mask(st.scores, st.l1, beta, threshold)
    res["selected_equal"] = bool(torch.equal(sel, st.selected))
    res["threshold_equal"] = bool(torch.equal(T.float(), st.threshold))
    plain_sel, _, _, plain_T = ref.brsgd_select_mask(sc32, l1.float(), beta,
                                                     threshold)
    res["plain_stats_selection_equal"] = bool(torch.equal(plain_sel, sel))
    res["margins"] = _selection_margins(torch, st.scores, st.l1, beta,
                                        st.threshold)
    w = st.selected.float()
    n = TRAIN_SAMPLE_COLUMNS
    res["sampled_blocks"] = sorted(agg_blocks)
    res["aggregate_equal"] = all(
        torch.equal(blk, ref.masked_mean_det(G[:, a:a + n], w))
        for a, blk in agg_blocks.items())
    res["n_selected"] = int(w.sum())
    if not (res["scores_equal"] and res["l1_rel_err"] <= REL_TOL
            and res["selected_equal"] and res["threshold_equal"]
            and res["aggregate_equal"]):
        fail(f"train step: the brsgd launch at [{m}, {d}] disagrees with "
             f"its plain statistics over column blocks: {res}")
    return res


def _train_full_width(torch, ops, cfg, m, want, ckpt_dir=None,
                      optimizer="adamw"):
    """``launch.train.main`` at full width for TRAIN_STEPS + 1 steps (the
    first a warm-up), its checkpoint and telemetry into ``ckpt_dir`` (none
    without one).  The
    bundle main builds is wrapped so that each step is timed and held to
    ``want`` launches (counted from 0 before it); host ms (median of
    TRAIN_STEPS), the split of the median step, peak memory.  Returns
    (params, opt_state, result, last probe, each step's launches)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import engine, threat
    from repro_torch.launch import train
    from repro_torch.serving import telemetry
    from repro_torch.training import step as step_mod
    res = {"check": "train_step", "entry": "launch.train.main",
           "arch": cfg.name, "workers": m, "batch_per_worker": TRAIN_B,
           "seq": TRAIN_S}
    steps, got_each, last = [], [], {}
    build = step_mod.build_train_step

    def build_timed(*args, **kw):
        bundle = build(*args, **kw)
        last["bundle"] = bundle

        def step_fn(*a):
            s = len(steps)
            out, host, split, got, copies = _train_step_timed(
                torch, ops, bundle.step_fn, a, seen)
            _check_step_launches(f"step {s}", got, copies, want)
            met = out[2]
            if not all(math.isfinite(met[k]) for k in ("loss", "gnorm")):
                fail(f"train step {s}: metrics {met}")
            got_each.append(got)
            steps.append({"step": s, "host_ms": host, "split_ms": split,
                          "loss": met["loss"], "gnorm": met["gnorm"],
                          "n_selected": met["n_selected"]})
            last["state"] = out[:2]
            return out
        return bundle._replace(step_fn=step_fn)
    argv = ["--arch", cfg.name, "--workers", str(m),
            "--steps", str(TRAIN_STEPS + 1),
            "--batch-per-worker", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--attack", TRAIN_ATTACK["attack"],
            "--alpha", str(TRAIN_ATTACK["alpha"]), "--optimizer", optimizer]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", str(ckpt_dir)]
    torch.cuda.reset_peak_memory_stats()
    step_mod.build_train_step = build_timed
    try:
        with _step_probe(torch, threat, engine) as seen:
            history = train.main(argv)
            probe = {k: seen.pop(k) for k in ("G", "result", "agg_blocks")}
    finally:
        step_mod.build_train_step = build
    bundle = last["bundle"]
    res.update(argv=argv, scope=bundle.scope, layout=bundle.layout,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               card_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    n = TRAIN_STEPS + 1
    want_ckpt = None
    if ckpt_dir is not None:
        rows = telemetry.read_rows(str(ckpt_dir))
        res["ckpt"] = {"steps": ckpt.steps(str(ckpt_dir)),
                       "history_rows": len(json.loads(
                           (ckpt_dir / "history.json").read_text())),
                       "telemetry_rows": len(rows)}
        want_ckpt = {"steps": [n], "history_rows": n, "telemetry_rows": n}
    if (len(steps) != n or [h["step"] for h in history] != list(range(n))
            or any(h["loss"] != r["loss"] for h, r in zip(history, steps))
            or res.get("ckpt") != want_ckpt):
        fail(f"train.main: {len(steps)} steps, history {history}, "
             f"{res['ckpt']} (expected {n} of each, checkpoint step {n})")
    timed = sorted(steps[1:], key=lambda r: r["host_ms"])
    res.update(host_ms=timed[len(timed) // 2]["host_ms"],
               host_ms_runs=[r["host_ms"] for r in steps[1:]],
               split_ms=timed[len(timed) // 2]["split_ms"],
               warmup_host_ms=steps[0]["host_ms"], steps=steps,
               launches_per_step=want)
    if res["peak_device_gb"] >= res["card_gb"]:
        fail(f"train step: peak {res['peak_device_gb']} GB")
    params, opt_state = last.pop("state")
    return params, opt_state, res, probe, got_each


def _supervised_steps(torch, ops, tcfg, params, opt_state, pipe, m):
    """Guarded steps under the supervisor at full width: quorum m, a
    nan_burst on worker TRAIN_FAULT_WORKER (honest: the byzantine workers
    are the first ones) for two steps: the first holds (params the input's
    bits) and evicts it, the second runs on the rest and is ok."""
    import dataclasses
    from repro_torch.configs import RecoveryConfig
    from repro_torch.faults import (ChaosPlan, FaultEvent, Supervisor,
                                    Trigger)
    from repro_torch.models import params as PM
    from repro_torch.training import build_train_step, step_generator
    bcfg = dataclasses.replace(tcfg.byzantine, max_m=m, quorum=m)
    tcfg = dataclasses.replace(tcfg, byzantine=bcfg,
                               recovery=RecoveryConfig(guard=True))
    bundle = build_train_step(tcfg, m, "cuda")
    sup = Supervisor(bundle.step_fn, bcfg, tcfg.recovery, m, like=params)
    plan = ChaosPlan([FaultEvent("nan_burst", Trigger(at=0, duration=2),
                                 workers=(TRAIN_FAULT_WORKER,))], m, 2)
    rows = []
    torch.cuda.reset_peak_memory_stats()
    for s in range(2):
        before = [p.to("cpu", copy=True) for p in PM.tree_leaves(params)]
        ops.reset_launches()
        t0 = time.perf_counter()
        params, opt_state, met = sup.run_step(
            params, opt_state, pipe.batch(10 + s), 10 + s,
            step_generator(0, 10 + s, "cuda"),
            faults=plan.grad_faults(s))
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        same = all(torch.equal(a, b.cpu()) for a, b in
                   zip(before, PM.tree_leaves(params)))
        rows.append({"step": 10 + s, "host_ms": host, "held":
                     met.get("held"), "step_ok": met["step_ok"],
                     "n_active": met["n_active"], "loss": met["loss"],
                     "gnorm": met["gnorm"], "params_unchanged": same,
                     "launches": {k: v for k, v in ops.launches().items()
                                  if v}})
        del before
    L = tcfg.model.n_layers
    n = m * L
    res = {"check": "train_supervised", "rows": rows,
           "summary": {k: v for k, v in sup.summary().items()
                       if k != "events"}, "events": sup.events,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    a, b = rows
    # the held step: every worker's gradient, the masked round's combine;
    # then the evicted worker's loss alone (no gradient: one forward)
    want_a = {"flash_attention": n, "flash_attention_bwd": n,
              "masked_mean": 1}
    want_b = {"flash_attention": n, "flash_attention_bwd": n - L,
              "masked_mean": 1}
    if not (a["held"] == "nonfinite" and a["params_unchanged"]
            and a["launches"] == want_a
            and sup.evicted[TRAIN_FAULT_WORKER] and sup.evictions == 1
            and b["step_ok"] == 1.0 and not b["params_unchanged"]
            and b["n_active"] == m - 1 and sup.quorum_shrinks == 1
            and b["launches"] == want_b):
        fail(f"train step under the supervisor: {res} (launches should be "
             f"{want_a}, then {want_b})")
    del bundle
    return params, opt_state, res


def _mla_heads_config(cfg):
    """The reduced config of an MLA arch with the arch's own attention
    head widths (4 heads, latent ranks 64 / 32): its B6 instance in a
    small model."""
    import dataclasses
    return dataclasses.replace(cfg.reduced(), attention=dataclasses.replace(
        cfg.attention, n_heads=4, n_kv_heads=4, q_lora_rank=64,
        kv_lora_rank=32))


def _train_card_vs_cpu(torch, arch, n_layers):
    """The step of ``arch`` at full width cut to ``n_layers`` layers (None:
    its reduced config; "mla_heads": ``_mla_heads_config``) at
    TRAIN_CPU_M workers, sgd at lr 1, on the card
    and on the host CPU from
    the same params and batch: per-worker gradient rows (G before the
    attack is the rows of the CPU gradients; each leaf's slice within
    GRAD_CPU_TOL of its largest |g|), the aggregation of the CPU's G on
    the card (scores and masks exact), the loss within GRAD_CPU_TOL and
    the params within TRAIN_CPU_PARAM_TOL of the largest |Δp|.  The
    card's step runs with the plain versions of B6 and B7 refusing the
    card and is held to its launches: one brsgd launch and one forward
    and one backward launch a layer a worker."""
    import dataclasses
    from repro_torch.configs import ByzantineConfig, TrainConfig, get_config
    from repro_torch.core import engine, threat
    from repro_torch.data import pipeline as PL
    from repro_torch.kernels import ops
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    from repro_torch.training import build_train_step
    cfg = get_config(arch)
    cfg = (cfg.reduced() if n_layers is None
           else _mla_heads_config(cfg) if n_layers == "mla_heads"
           else dataclasses.replace(cfg, n_layers=n_layers))
    bcfg = ByzantineConfig(**TRAIN_ATTACK)
    tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer="sgd", lr=1.0,
                       agg_scope="global", agg_layout="gather")
    m = TRAIN_CPU_M
    p_gpu = PM.init_params(TF.param_defs(cfg), torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    p_cpu = _tree_to(p_gpu, "cpu")
    p0 = [p.clone() for p in PM.tree_leaves(p_cpu)]
    batch = PL.LMWorkerPipeline(cfg, m, 1, GRAD_CPU_SEQ, seed=4,
                                byz=bcfg).batch(0)
    shapes = [tuple(p.shape) for p in p0]
    fwd, bwd = GRAD_KERNELS[TF.segments(cfg)[0].kind]
    n = m * _attn_apps(cfg)
    want_launches = {"brsgd_aggregate": 1, fwd: n, bwd: n}
    out = {}
    with _step_probe(torch, threat, engine) as seen, \
            _plain_versions_refuse_the_card(torch):
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            bundle = build_train_step(tcfg, m, dev)
            ops.reset_launches()
            _, _, met = bundle.step_fn(p, (), batch, 0, None)
            if dev == "cuda":
                torch.cuda.synchronize()
                copies = {k: v for k, v in ops.copies().items() if v}
                _check_step_launches(f"card vs CPU {cfg.name}",
                                     ops.launches(), {}, want_launches)
            G = seen.pop("G")
            st = seen.pop("result")[1]
            out[dev] = {"met": met, "G": G.cpu(), "state": st,
                        "params": [t.cpu() for t in PM.tree_leaves(p)]}
            del bundle, G
    c, g = out["cpu"], out["cuda"]
    # per-worker gradients: the attack's rows (sign_flip) flip both alike
    errs, a = {}, 0
    for li, s in enumerate(shapes):
        n = math.prod(s)
        for i in range(m):
            want = c["G"][i, a:a + n]
            errs[(li, i)] = float((g["G"][i, a:a + n] - want).abs().max()
                                  / max(float(want.abs().max()), 1e-30))
        a += n
    # the aggregation of one G on both devices
    _, st_card = engine.aggregate_local(c["G"].cuda(), bcfg,
                                        return_state=True)
    st_cpu = c["state"]
    dp = max(float((q - p).abs().max()) for q, p in zip(c["params"], p0))
    perr = max(float((q - p).abs().max())
               for q, p in zip(g["params"], c["params"]))
    res = {"check": "train_card_vs_cpu", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "D": sum(math.prod(s) for s in shapes), "workers": m,
           "seq": GRAD_CPU_SEQ,
           "loss_rel_err": abs(g["met"]["loss"] - c["met"]["loss"])
           / abs(c["met"]["loss"]),
           "worst_row_leaf_rel_err": max(errs.values()),
           "same_G_scores_equal": bool(torch.equal(st_card.scores.cpu(),
                                                   st_cpu.scores)),
           "same_G_selected_equal": bool(torch.equal(
               st_card.selected.cpu(), st_cpu.selected)),
           "same_G_c1_c2_equal": bool(
               torch.equal(st_card.c1.cpu(), st_cpu.c1)
               and torch.equal(st_card.c2.cpu(), st_cpu.c2)),
           "step_selected_equal": bool(torch.equal(
               g["state"].selected.cpu(), st_cpu.selected)),
           "card_launches": want_launches, "card_copies": copies,
           "n_selected": [c["met"]["n_selected"], g["met"]["n_selected"]],
           "margins": _selection_margins(torch, st_cpu.scores, st_cpu.l1,
                                         bcfg.beta, st_cpu.threshold),
           "params_err_over_max_dp": perr / dp,
           "tol": {"loss": GRAD_CPU_TOL[0], "row_leaf": GRAD_CPU_TOL[1],
                   "params": TRAIN_CPU_PARAM_TOL}}
    if not (res["loss_rel_err"] <= GRAD_CPU_TOL[0]
            and res["worst_row_leaf_rel_err"] <= GRAD_CPU_TOL[1]
            and res["same_G_scores_equal"] and res["same_G_selected_equal"]
            and res["same_G_c1_c2_equal"] and res["step_selected_equal"]
            and res["params_err_over_max_dp"] <= TRAIN_CPU_PARAM_TOL):
        fail(f"train step card vs CPU {cfg.name}: {res}")
    emit(res)


def phase_train(torch):
    """The BrSGD train step at qwen3-0.6b's full width through its entry
    point, launch.train.main, with m = TRAIN_M workers, brsgd under
    sign_flip at 0.25, adamw, the plain versions of B6 and B7 refusing
    the card; the brsgd launch held on that step's G against plain
    statistics over column blocks; guarded steps under the supervisor;
    card = CPU at 2 layers for both archs.  Returns the results and the
    launches counted in the full-width steps."""
    import shutil
    import tempfile
    from repro_torch.configs import ByzantineConfig, TrainConfig, get_config
    from repro_torch.data import pipeline as PL
    from repro_torch.kernels import ops
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    bcfg = ByzantineConfig(**TRAIN_ATTACK)
    tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer="adamw")
    m = TRAIN_M
    n = m * cfg.n_layers
    want = {"brsgd_aggregate": 1, "flash_attention": n,
            "flash_attention_bwd": n}
    results = []
    tmp = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    try:
        with _plain_versions_refuse_the_card(torch):
            t0 = time.perf_counter()
            params, opt_state, res, probe, got_each = _train_full_width(
                torch, ops, cfg, m, want, tmp / "ckpt")
            res["D"] = PM.count_params(TF.param_defs(cfg))
            res["seconds"] = time.perf_counter() - t0
            shutil.rmtree(tmp / "ckpt")
            st = probe["result"][1]
            t0 = time.perf_counter()
            res["launch_held_on_blocks"] = _hold_launch_on_blocks(
                torch, probe["G"], st, probe["agg_blocks"], bcfg.beta,
                bcfg.threshold)
            res["launch_check_seconds"] = time.perf_counter() - t0
            emit(res)
            results.append(res)
            del probe, st
            torch.cuda.empty_cache()
            pipe = PL.LMWorkerPipeline(cfg, m, TRAIN_B, TRAIN_S,
                                       seed=tcfg.seed, byz=bcfg)
            t0 = time.perf_counter()
            params, opt_state, sres = _supervised_steps(
                torch, ops, tcfg, params, opt_state, pipe, m)
            sres["seconds"] = time.perf_counter() - t0
            emit(sres)
            results.append(sres)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params, opt_state
    torch.cuda.empty_cache()
    for arch, n_layers in TRAIN_CPU_CASES:
        t0 = time.perf_counter()
        _train_card_vs_cpu(torch, arch, n_layers)
        emit({"check": "train_card_vs_cpu_seconds", "arch": arch,
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    launches = {}
    for got in got_each + [r["launches"] for r in sres["rows"]]:
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    return results, launches


# ---------------------------------------------------------------------------
# 7h. the blocked scope on one card: every bucket aggregated in the backward
# ---------------------------------------------------------------------------

# qwen3-0.6b at phase 7d's configuration (m = 20 of 2 x 128, brsgd under
# sign_flip at 0.25, adamw) and rwkv6-7b at full width (m = 4, sgd), both
# with --agg-scope blocked --remat block through launch.train.main
BLOCKED_ARGS = ("--agg-scope", "blocked", "--remat", "block")
BLOCKED_RWKV_ARCH, BLOCKED_RWKV_M, BLOCKED_RWKV_STEPS = "rwkv6-7b", 4, 1
# card = CPU at m = 4 from the same params and tokens, sgd at lr 1, with
# remat: qwen3-0.6b at full width cut to 2 layers under brsgd, and reduced
# (2 layers, d 256) under median and krum: at full width the CPU's plain
# statistics over the 155.6M-column top bucket took 13-19 s a rule, and
# the script went past 800 s on a slower host; rwkv6-7b reduced under
# brsgd (at full width its 2 layers hold 0.98 B params, too many for the
# CPU's plain statistics, as in phase 7d)
BLOCKED_CPU_CASES = (("qwen3-0.6b", 2, "brsgd"), ("qwen3-0.6b", None, "median"),
                     ("qwen3-0.6b", None, "krum"), ("rwkv6-7b", None, "brsgd"))
# the guarded blocked step under the supervisor: qwen3-0.6b at full width
# cut to 2 layers, m = 8 (worker TRAIN_FAULT_WORKER's NaN burst)
BLOCKED_SUP_LAYERS, BLOCKED_SUP_M = 2, 8
# the card's plain aggregation versions, made to raise during a blocked step
AGG_PLAIN = ("brsgd_aggregate_plain", "select_aggregate_plain",
             "fused_stats_ref", "masked_mean_det", "cwise_median_ref",
             "trimmed_mean_ref", "brsgd_stats_ref")


@contextlib.contextmanager
def _blocked_probe(torch, holds=None):
    """Wraps every bucket's aggregation in the blocked step: the
    aggregate's finiteness (a device flag, read by the caller), each
    call's bucket and n_selected, and, while ``holds`` is set, the
    plain versions of the aggregation made to raise on the card.
    ``holds`` maps a bucket (name, layer) to a check run on its rows and
    result right after the launch (the plain versions allowed there)."""
    from repro_torch.core import blocked
    from repro_torch.kernels import ref
    seen = {"finite": None, "calls": [], "held": {}, "guard": True,
            "rounds": {}}
    saved_plain = {n: getattr(ref, n) for n in AGG_PLAIN}
    agg_rows, finish = blocked.aggregate_rows, blocked._Bucket.finish

    def guard(name, fn):
        def call(*args, **kw):
            if seen["guard"] and any(torch.is_tensor(a) and a.is_cuda
                                     for a in args):
                raise RuntimeError(f"{name}: the plain version was called "
                                   f"on the card")
            return fn(*args, **kw)
        return call

    def finish_probe(self):
        seen["bucket"] = (self.name, self.layer)
        seen["rounds"][id(self.rnd)] = self.rnd
        return finish(self)

    def aggregate(rows, bcfg, valid=None):
        agg, st = agg_rows(rows, bcfg, valid)
        ok = torch.isfinite(agg).all()
        seen["finite"] = ok if seen["finite"] is None else seen["finite"] & ok
        seen["calls"].append(seen["bucket"])
        check = (holds or {}).get(seen["bucket"])
        if check is not None and seen["bucket"] not in seen["held"]:
            seen["guard"] = False
            try:
                seen["held"][seen["bucket"]] = check(rows, agg, st, bcfg)
            finally:
                seen["guard"] = True
        return agg, st
    for n, fn in saved_plain.items():
        setattr(ref, n, guard(n, fn))
    blocked.aggregate_rows, blocked._Bucket.finish = aggregate, finish_probe
    try:
        yield seen
    finally:
        blocked.aggregate_rows, blocked._Bucket.finish = agg_rows, finish
        for n, fn in saved_plain.items():
            setattr(ref, n, fn)


def _hold_layer_bucket(torch, rows, agg, st, bcfg) -> dict:
    """One layer bucket's brsgd launch against the plain version on the
    same rows, whole: scores, 𝔗, the masks and the weights exact, l1
    within REL_TOL (summed in another order), the aggregate bit-equal."""
    from repro_torch.kernels import ref
    plain = ref.brsgd_aggregate_plain(rows, bcfg.beta, bcfg.threshold)
    res = {"shape": list(rows.shape),
           "scores_equal": bool(torch.equal(st.scores, plain.scores)),
           "l1_rel_err": float((st.l1 - plain.l1).abs().max()
                               / plain.l1.abs().max()),
           "threshold_equal": bool(torch.equal(st.threshold.float(),
                                               plain.threshold.float())),
           "masks_equal": bool(torch.equal(st.selected, plain.selected)
                               and torch.equal(st.c1, plain.c1)
                               and torch.equal(st.c2, plain.c2)),
           "aggregate_equal": bool(torch.equal(agg, plain.agg)),
           "n_selected": int(st.selected.sum())}
    if not (res["scores_equal"] and res["l1_rel_err"] <= REL_TOL
            and res["threshold_equal"] and res["masks_equal"]
            and res["aggregate_equal"]):
        fail(f"blocked step: the layer bucket's brsgd launch disagrees with "
             f"its plain version: {res}")
    return res


def _hold_top_bucket(torch, rows, agg, st, bcfg) -> dict:
    """The top bucket's launch held on column blocks, as phase 7d holds
    the global launch (``_hold_launch_on_blocks``)."""
    blocks = {a: agg[a:a + TRAIN_SAMPLE_COLUMNS]
              for a in _sample_starts(torch, agg.numel())}
    return _hold_launch_on_blocks(torch, rows, st, blocks, bcfg.beta,
                                  bcfg.threshold)


def _blocked_full_width(torch, ops, arch, m, optimizer, steps, want,
                        holds=None):
    """``launch.train.main`` with --agg-scope blocked --remat block at
    full width for ``steps`` + 1 steps (the first a warm-up, where the
    ``holds`` run), each held to ``want`` launches and to finite
    aggregates with no plain version on the card; host ms (median of the
    timed steps), the peak memory of the timed steps, n_selected and
    n_selected_min."""
    from repro_torch.launch import train
    from repro_torch.training import step as step_mod
    res = {"check": "blocked_train_step", "entry": "launch.train.main",
           "arch": arch, "workers": m, "batch_per_worker": TRAIN_B,
           "seq": TRAIN_S, "optimizer": optimizer}
    rows, last = [], {}
    build = step_mod.build_train_step

    def build_timed(*args, **kw):
        bundle = build(*args, **kw)
        last["bundle"] = bundle

        def step_fn(*a):
            s = len(rows)
            seen["finite"] = None
            seen["calls"].clear()
            seen["rounds"].clear()
            ops.reset_launches()
            torch.cuda.synchronize()
            if s:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = bundle.step_fn(*a)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            _check_step_launches(f"blocked {arch} step {s}", ops.launches(),
                                 ops.copies(), want)
            met = out[2]
            finite = bool(seen["finite"])
            if not (finite and all(math.isfinite(met[k])
                                   for k in ("loss", "gnorm"))):
                fail(f"blocked {arch} step {s}: aggregates finite {finite}, "
                     f"metrics {met}")
            (rnd,) = seen["rounds"].values()
            live = sorted(f"{n}/{l}" for n, l in rnd.peak_live)
            if len(live) != 2 or "top/0" not in live:
                fail(f"blocked {arch} step {s}: the backward held the rows "
                     f"of {live} at once (lockstep: the top bucket and one "
                     f"layer)")
            rows.append({"step": s, "host_ms": host, "loss": met["loss"],
                         "gnorm": met["gnorm"],
                         "n_selected": met["n_selected"],
                         "n_selected_min": met["n_selected_min"],
                         "buckets": len(seen["calls"]), "peak_live": live,
                         "peak_device_gb": torch.cuda.max_memory_allocated()
                         / 1e9})
            return out
        return bundle._replace(step_fn=step_fn)
    argv = ["--arch", arch, "--workers", str(m), "--steps", str(steps + 1),
            "--batch-per-worker", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--attack", TRAIN_ATTACK["attack"],
            "--alpha", str(TRAIN_ATTACK["alpha"]), "--optimizer", optimizer,
            *BLOCKED_ARGS]
    torch.cuda.empty_cache()
    step_mod.build_train_step = build_timed
    try:
        with _plain_versions_refuse_the_card(torch), \
                _blocked_probe(torch, holds) as seen:
            history = train.main(argv)
    finally:
        step_mod.build_train_step = build
    bundle = last.pop("bundle")
    timed = sorted(rows[1:], key=lambda r: r["host_ms"])
    res.update(argv=argv, scope=bundle.scope, layout=bundle.layout,
               host_ms=timed[len(timed) // 2]["host_ms"],
               host_ms_runs=[r["host_ms"] for r in rows[1:]],
               warmup_host_ms=rows[0]["host_ms"],
               peak_device_gb=max(r["peak_device_gb"] for r in rows[1:]),
               card_gb=torch.cuda.get_device_properties(0).total_memory / 1e9,
               steps=rows, launches_per_step=want, held=dict(
                   (f"{n}/{l}", v) for (n, l), v in seen["held"].items()))
    if (bundle.scope != "blocked" or len(rows) != steps + 1
            or [h["step"] for h in history] != list(range(steps + 1))
            or any(r["n_selected_min"] > r["n_selected"] for r in rows)
            or (holds and set(seen["held"]) != set(holds))):
        fail(f"blocked {arch}: {res}")
    del bundle
    torch.cuda.empty_cache()
    return res


def _blocked_card_vs_cpu(torch, arch, n_layers, rule) -> dict:
    """The blocked step of ``arch`` at full width cut to ``n_layers``
    (None: reduced) at TRAIN_CPU_M workers under ``rule``, sgd at lr 1,
    remat, on the card and on the host CPU from the same params and
    batch: every bucket's selection and n_selected exact, the loss within
    GRAD_CPU_TOL, the params within TRAIN_CPU_PARAM_TOL of the largest
    |Δp|; the card's step held to one aggregation launch a bucket."""
    import dataclasses
    from repro_torch.configs import ByzantineConfig, TrainConfig, get_config
    from repro_torch.data import pipeline as PL
    from repro_torch.kernels import ops
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    from repro_torch.training import build_train_step
    cfg = get_config(arch)
    cfg = (cfg.reduced() if n_layers is None
           else dataclasses.replace(cfg, n_layers=n_layers))
    bcfg = ByzantineConfig(aggregator=rule, **TRAIN_ATTACK)
    tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer="sgd", lr=1.0,
                       agg_scope="blocked", remat="block")
    m = TRAIN_CPU_M
    p_gpu = PM.init_params(TF.param_defs(cfg), torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    p_cpu = _tree_to(p_gpu, "cpu")
    p0 = [p.clone() for p in PM.tree_leaves(p_cpu)]
    batch = PL.LMWorkerPipeline(cfg, m, 1, GRAD_CPU_SEQ, seed=4,
                                byz=bcfg).batch(0)
    fwd, bwd = GRAD_KERNELS[TF.segments(cfg)[0].kind]
    n_b = sum(s.n for s in TF.segments(cfg)) + 1
    agg_kernel = {"brsgd": "brsgd_aggregate", "median": "cwise_median",
                  "krum": "select_aggregate"}[rule]
    n = m * _attn_apps(cfg)
    want = {agg_kernel: n_b, fwd: 2 * n, bwd: n}
    out = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        sel = []
        with _plain_versions_refuse_the_card(torch), \
                _blocked_probe(torch) as seen:
            from repro_torch.core import blocked
            agg_rows = blocked.aggregate_rows

            def record(rows, bcfg, valid=None):
                agg, st = agg_rows(rows, bcfg, valid)
                sel.append(st.selected.cpu())
                return agg, st
            blocked.aggregate_rows = record
            try:
                bundle = build_train_step(tcfg, m, dev)
                ops.reset_launches()
                _, _, met = bundle.step_fn(p, (), batch, 0, None)
            finally:
                blocked.aggregate_rows = agg_rows
            if dev == "cuda":
                torch.cuda.synchronize()
                _check_step_launches(f"blocked card vs CPU {cfg.name} {rule}",
                                     ops.launches(), ops.copies(), want)
        out[dev] = {"met": met, "sel": sel, "calls": list(seen["calls"]),
                    "params": [t.cpu() for t in PM.tree_leaves(p)]}
        del bundle
    c, g = out["cpu"], out["cuda"]
    dp = max(float((q - p).abs().max()) for q, p in zip(c["params"], p0))
    perr = max(float((q - p).abs().max())
               for q, p in zip(g["params"], c["params"]))
    res = {"check": "blocked_card_vs_cpu", "arch": cfg.name, "rule": rule,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "workers": m,
           "seq": GRAD_CPU_SEQ, "buckets": len(c["calls"]),
           "calls_equal": c["calls"] == g["calls"],
           "selections_equal": len(c["sel"]) == len(g["sel"]) == n_b and all(
               torch.equal(a, b) for a, b in zip(c["sel"], g["sel"])),
           "n_selected": [c["met"]["n_selected"], g["met"]["n_selected"]],
           "n_selected_min": [c["met"]["n_selected_min"],
                              g["met"]["n_selected_min"]],
           "loss_rel_err": abs(g["met"]["loss"] - c["met"]["loss"])
           / abs(c["met"]["loss"]),
           "params_err_over_max_dp": perr / dp, "card_launches": want,
           "tol": {"loss": GRAD_CPU_TOL[0], "params": TRAIN_CPU_PARAM_TOL}}
    if not (res["calls_equal"] and res["selections_equal"]
            and res["n_selected"][0] == res["n_selected"][1]
            and res["n_selected_min"][0] == res["n_selected_min"][1]
            and res["loss_rel_err"] <= GRAD_CPU_TOL[0]
            and res["params_err_over_max_dp"] <= TRAIN_CPU_PARAM_TOL):
        fail(f"blocked step card vs CPU {cfg.name} {rule}: {res}")
    return res


def _blocked_supervised(torch, ops) -> dict:
    """The guarded blocked step under the supervisor, qwen3-0.6b at full
    width cut to BLOCKED_SUP_LAYERS layers, m = BLOCKED_SUP_M (quorum m),
    a nan_burst on worker TRAIN_FAULT_WORKER: the first step held (params
    the input's bits) and the worker evicted, the second ok on the rest
    (a quorum shrink).  Launches: every worker's forward and backward
    launch a layer on the held step, the evicted worker's forward alone
    on the next, and one masked combine (B3) a bucket."""
    import dataclasses
    from repro_torch.configs import (ByzantineConfig, RecoveryConfig,
                                     TrainConfig, get_config)
    from repro_torch.data import pipeline as PL
    from repro_torch.faults import (ChaosPlan, FaultEvent, Supervisor,
                                    Trigger)
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    from repro_torch.training import build_train_step, step_generator
    m, L = BLOCKED_SUP_M, BLOCKED_SUP_LAYERS
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=L)
    bcfg = ByzantineConfig(max_m=m, quorum=m, **TRAIN_ATTACK)
    tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer="sgd",
                       agg_scope="blocked",
                       recovery=RecoveryConfig(guard=True))
    params = PM.init_params(TF.param_defs(cfg), torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    bundle = build_train_step(tcfg, m, "cuda")
    sup = Supervisor(bundle.step_fn, bcfg, tcfg.recovery, m, like=params)
    plan = ChaosPlan([FaultEvent("nan_burst", Trigger(at=0, duration=2),
                                 workers=(TRAIN_FAULT_WORKER,))], m, 2)
    pipe = PL.LMWorkerPipeline(cfg, m, TRAIN_B, TRAIN_S, seed=tcfg.seed,
                               byz=bcfg)
    rows, opt_state = [], bundle.opt_init(params)
    with _plain_versions_refuse_the_card(torch), \
            _blocked_probe(torch) as seen:
        for s in range(2):
            before = [p.clone() for p in PM.tree_leaves(params)]
            seen["calls"].clear()
            ops.reset_launches()
            t0 = time.perf_counter()
            params, opt_state, met = sup.run_step(
                params, opt_state, pipe.batch(s), s,
                step_generator(0, s, "cuda"), faults=plan.grad_faults(s))
            torch.cuda.synchronize()
            rows.append({"step": s, "host_ms": (time.perf_counter() - t0)
                         * 1e3, "held": met.get("held"),
                         "step_ok": met["step_ok"],
                         "n_active": met["n_active"],
                         "n_selected": met["n_selected"],
                         "n_selected_min": met["n_selected_min"],
                         "buckets": len(seen["calls"]),
                         "params_unchanged": all(torch.equal(a, b) for a, b
                                                 in zip(before,
                                                        PM.tree_leaves(
                                                            params))),
                         "launches": {k: v for k, v in
                                      ops.launches().items() if v}})
            del before
    a, b = rows
    want_a = {"flash_attention": m * L, "flash_attention_bwd": m * L,
              "masked_mean": L + 1}
    want_b = {"flash_attention": m * L, "flash_attention_bwd": (m - 1) * L,
              "masked_mean": L + 1}
    res = {"check": "blocked_supervised", "arch": cfg.name, "n_layers": L,
           "workers": m, "rows": rows,
           "summary": {k: v for k, v in sup.summary().items()
                       if k != "events"}}
    if not (a["held"] == "nonfinite" and a["params_unchanged"]
            and a["launches"] == want_a
            and sup.evicted[TRAIN_FAULT_WORKER] and sup.evictions == 1
            and b["step_ok"] == 1.0 and not b["params_unchanged"]
            and b["n_active"] == m - 1 and sup.quorum_shrinks == 1
            and b["launches"] == want_b
            and b["n_selected_min"] <= b["n_selected"]):
        fail(f"blocked step under the supervisor: {res} (launches should be "
             f"{want_a}, then {want_b})")
    del bundle, params, opt_state, sup
    return res


def phase_blocked(torch, global_peak_gb):
    """Phase 7h: the blocked scope on one card.  qwen3-0.6b at full width
    with m = TRAIN_M through launch.train.main (--agg-scope blocked
    --remat block): 29 brsgd launches a step (28 layer buckets and the
    top), B6 twice a layer a worker (remat) and B6-bwd once, no plain
    version on the card, its peak below phase 7d's global-scope peak
    ``global_peak_gb``; a layer bucket's launch held against the plain
    version on its rows and the top bucket's on column blocks (warm-up
    step).  rwkv6-7b at full width with m = BLOCKED_RWKV_M, sgd: 33 brsgd
    launches a step, B7 twice a layer a worker and B7-bwd once, every
    aggregate finite.  Then card = CPU and the supervisor.  Returns the
    results and the launches of the full-width steps and the supervised
    ones."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    sub = {}
    cfg = get_config(TRAIN_ARCH)
    L, m = cfg.n_layers, TRAIN_M
    want = {"brsgd_aggregate": L + 1, "flash_attention": 2 * m * L,
            "flash_attention_bwd": m * L}
    t0 = time.perf_counter()
    qwen = _blocked_full_width(
        torch, ops, TRAIN_ARCH, m, "adamw", TRAIN_STEPS, want,
        holds={("seg_0", L - 1): lambda *a: _hold_layer_bucket(torch, *a),
               ("top", 0): lambda *a: _hold_top_bucket(torch, *a)})
    qwen["global_scope_peak_device_gb"] = global_peak_gb
    sub["qwen3_full_width"] = time.perf_counter() - t0
    if qwen["peak_device_gb"] >= global_peak_gb:
        fail(f"blocked qwen3 peak {qwen['peak_device_gb']} GB is not below "
             f"the global scope's {global_peak_gb} GB")
    emit(qwen)
    rcfg = get_config(BLOCKED_RWKV_ARCH)
    Lr, mr = rcfg.n_layers, BLOCKED_RWKV_M
    want_r = {"brsgd_aggregate": Lr + 1, "wkv6_seq": 2 * mr * Lr,
              "wkv6_seq_bwd": mr * Lr}
    t0 = time.perf_counter()
    rwkv = _blocked_full_width(torch, ops, BLOCKED_RWKV_ARCH, mr, "sgd",
                               BLOCKED_RWKV_STEPS, want_r)
    sub["rwkv6_full_width"] = time.perf_counter() - t0
    emit(rwkv)
    cpu = []
    t0 = time.perf_counter()
    for arch, n_layers, rule in BLOCKED_CPU_CASES:
        r = _blocked_card_vs_cpu(torch, arch, n_layers, rule)
        emit(r)
        cpu.append(r)
        torch.cuda.empty_cache()
    sub["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sup = _blocked_supervised(torch, ops)
    sub["supervised"] = time.perf_counter() - t0
    emit(sup)
    torch.cuda.empty_cache()
    emit({"phase": "blocked", "sub_seconds": sub})
    launches = {}
    for per_step, n in ((want, TRAIN_STEPS + 1),
                        (want_r, BLOCKED_RWKV_STEPS + 1)):
        for k, v in per_step.items():
            launches[k] = launches.get(k, 0) + v * n
    for r in sup["rows"]:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"qwen3": qwen, "rwkv6": rwkv, "card_vs_cpu": cpu,
            "supervised": sup, "sub_seconds": sub}, launches


# ---------------------------------------------------------------------------
# 7i. the torch.distributed layouts: one rank a worker, 4 ranks on one card
# ---------------------------------------------------------------------------

# qwen3-0.6b at full width, 2 x 128 tokens a worker, brsgd under sign_flip
# at 0.25 (prefix membership: worker 0 of 4 byzantine; none of 2 on the
# 2 x 2 mesh, where floor(0.25 * 2) = 0), sgd; each case is one call of
# launch.train.main --mesh, 4 ranks in one gloo group on the one card
# (NCCL refuses two ranks on one device): (mesh, --mesh, layout)
SHARDED_ARCH, SHARDED_WORLD = "qwen3-0.6b", 4
SHARDED_CASES = (("flat", "4", "gather"),
                 ("flat", "4", "a2a"),
                 ("dm", "2x2", "a2a"))
SHARDED_STEPS, SHARDED_BATCH, SHARDED_SEQ = 2, 2, 128
SHARDED_ALPHA = 0.25
# the aggregate against aggregate_local on the same G, relative to its
# largest |agg| (the reductions sum in other orders)
SHARDED_AGG_TOL = 1e-6
# card = CPU: the reduced config, 4 ranks each side, sgd at lr 1, params
# relative to the largest |Δp| (launch.train gives each CPU rank
# cpu_count / 4 threads)
SHARDED_CPU_STEPS, SHARDED_CPU_TOL = 2, 1e-5
SHARDED_PLAIN = AGG_PLAIN


def _sharded_argv(spec, layout, steps, reduced=False, device="cuda"):
    argv = ["--arch", SHARDED_ARCH, "--mesh", spec, "--agg-layout", layout,
            "--steps", str(steps), "--batch-per-worker", str(SHARDED_BATCH),
            "--seq", str(SHARDED_SEQ), "--attack", "sign_flip",
            "--alpha", str(SHARDED_ALPHA), "--optimizer", "sgd",
            "--device", device]
    return argv + (["--reduced", "--lr", "1.0"] if reduced else [])


def _sharded_check(torch, engine, collectives, mesh, bcfg, local, agg, st,
                   specs):
    """The warm-up step's aggregate against aggregate_local on the card:
    every rank's post-attack leaves gathered once into G [m, D] on rank
    0, and the aggregate's model shards with them (these gathers stand
    outside the step's counts), then the one brsgd launch on G.  Scores
    and selection exact, the aggregate within SHARDED_AGG_TOL of
    max|agg|.  Rank 0 returns the figures."""
    from repro_torch.launch.mesh import n_workers, worker_axes
    waxes = worker_axes(mesh)
    maxes = tuple(a for a in mesh.axis_names if a not in waxes)
    m, nm = n_workers(mesh), mesh.size(maxes)
    lead = mesh.rank == 0

    def dim_of(ps):
        return next((i for i, e in enumerate(ps or ()) if e is not None),
                    None)
    D = sum(g.numel() * (1 if dim_of(ps) is None else nm)
            for g, ps in zip(local, specs))
    G = (torch.empty((m, D), dtype=torch.float32, device=local[0].device)
         if lead else None)
    got, off = [], 0
    for g, a, ps in zip(local, agg, specs):
        dim = dim_of(ps)
        parts = collectives.all_gather(g, mesh, mesh.axis_names)
        if dim is not None:
            a = torch.cat(list(collectives.all_gather(a, mesh, maxes)), dim)
        if lead:
            for w in range(m):
                rows = parts[w * nm:(w + 1) * nm]
                full = rows[0] if dim is None else torch.cat(list(rows), dim)
                G[w, off:off + full.numel()] = full.reshape(-1)
            off += a.numel()
            got.append(a.reshape(-1))
        del parts
    if not lead:
        return None
    ref_agg, ref_st = engine.aggregate_local(G, bcfg, return_state=True)
    del G
    got = torch.cat(got)
    scale = float(ref_agg.abs().max())
    err = float((got - ref_agg).abs().max())
    res = {"D": D, "agg_err_over_max": err / scale,
           "scores_equal": bool(torch.equal(st.scores, ref_st.scores)),
           "selected_equal": bool(torch.equal(st.selected,
                                              ref_st.selected)),
           "selected": st.selected.int().tolist(),
           "scores": st.scores.tolist()}
    del ref_agg, got
    torch.cuda.empty_cache()
    return res


def _sharded_train_rank(opts, rank, args):
    """One rank of ``launch.train.main --mesh`` (phase 7i puts this in
    place of the launcher's rank function, which it then calls): the
    rank's parts are wrapped in synchronised host timers (threat.inject,
    robust_aggregate, the collectives inside it and after it, the
    statistics pass), each step is timed and its launches and
    collectives counted from 0, the aggregation's all_gather /
    all_to_all counted alone, B6 / B6-bwd and the statistics' plain
    versions refuse the card.  ``opts``: "check" runs
    :func:`_sharded_check` on the warm-up's aggregate, its launches,
    gathers and time taken out of the step's; "cpu_init" draws the
    params on the CPU (so that card and CPU ranks start alike) and rank
    0 keeps the last params.  Rank 0 returns every rank's rows."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import collectives, engine
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TR
    from repro_torch.models import params as PM
    from repro_torch.training import step as ST
    cuda = opts["device"] == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    split, clock, rows, info = {}, {}, [], {"check": None, "init": None}

    def timer(mod, name, key):
        fn = getattr(mod, name)

        def call(*a, **kw):
            sync()
            t0 = time.perf_counter()
            if key == "inject":
                clock["inject"] = t0
            out = fn(*a, **kw)
            sync()
            k = key
            if key == "collectives" and not clock.get("inside"):
                k = "update_collectives"
            if clock.get("on", True):
                split[k] = split.get(k, 0.0) + (time.perf_counter() - t0) \
                    * 1e3
            return out
        setattr(mod, name, call)
    timer(ST.threat, "inject", "inject")
    for name in ("all_gather", "all_to_all", "all_reduce"):
        timer(collectives, name, "collectives")
    timer(ops, "fused_stats", "stats_kernels")
    aggregate = ST.robust_aggregate

    def robust_aggregate(local, bcfg, mesh, axes, **kw):
        sync()
        t0 = time.perf_counter()
        before = collectives.counts()
        clock["inside"] = True
        agg, st = aggregate(local, bcfg, mesh, axes, **kw)
        clock["inside"] = False
        after = collectives.counts()
        sync()
        t1 = clock["aggregate_end"] = time.perf_counter()
        split["aggregate"] = split.get("aggregate", 0.0) + (t1 - t0) * 1e3
        clock["collectives"] = {k: after[k] - before[k]
                                for k in ("all_gather", "all_to_all")}
        info.update(device=str(local[0].device), backend=mesh.backend,
                    n_leaves=len(local), workers=mesh.size(axes))
        if opts["check"] and not rows:
            l0, clock["on"] = ops.launches(), False
            info["check"] = _sharded_check(
                torch, engine, collectives, mesh, bcfg, local, agg, st,
                kw["leaf_specs"])
            clock["on"] = True
            clock["check_launches"] = {
                k: v - l0.get(k, 0) for k, v in ops.launches().items()
                if v - l0.get(k, 0)}
            t2 = clock["aggregate_end"] = time.perf_counter()
            clock["check_ms"] = (t2 - t1) * 1e3
        return agg, st
    ST.robust_aggregate = robust_aggregate
    if opts["cpu_init"]:
        init = PM.init_params

        def init_on_cpu(defs, generator, device="cpu", **kw):
            gen = torch.Generator().manual_seed(generator.initial_seed())
            params = init(defs, gen, **kw)
            if rank == 0:
                info["init"] = [p.numpy().copy()
                                for p in PM.tree_leaves(params)]
            return _to_device(params, device)
        PM.init_params = init_on_cpu
    build = ST.build_train_step

    def build_timed(*a, **kw):
        bundle = build(*a, **kw)

        def step_fn(*sa):
            split.clear()
            collectives.reset()
            ops.reset_launches()
            clock.update(check_ms=0.0, check_launches={})
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sync()
            t0 = time.perf_counter()
            out = bundle.step_fn(*sa)
            sync()
            t1 = time.perf_counter()
            c, got = collectives.counts(), ops.launches()
            met = out[2]
            row = {"host_ms": (t1 - t0) * 1e3 - clock["check_ms"],
                   "launches": {k: v - clock["check_launches"].get(k, 0)
                                for k, v in got.items()
                                if v - clock["check_launches"].get(k, 0)},
                   "check_launches": clock["check_launches"],
                   "collectives": clock["collectives"],
                   "device_types": c["device_types"],
                   "bytes_sent": sum(c["bytes_sent"].values()),
                   "n_selected": met["n_selected"],
                   "loss": met["loss"], "gnorm": met["gnorm"]}
            if cuda:
                free, total = torch.cuda.mem_get_info()
                row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                row["card_used_gb"] = (total - free) / 1e9
                sp = {k: split.get(k, 0.0) for k in (
                    "inject", "aggregate", "collectives", "stats_kernels",
                    "update_collectives")}
                sp["gradient"] = (clock["inject"] - t0) * 1e3
                # the aggregate's model shards and the losses gathered,
                # gnorm and the update
                sp["update"] = (t1 - clock["aggregate_end"]) * 1e3
                sp["combine"] = sp["aggregate"] - sp["stats_kernels"] \
                    - sp["collectives"]
                row["split_ms"] = sp
            rows.append(row)
            if opts["cpu_init"] and rank == 0:
                info["params"] = [p.detach().cpu().numpy().copy()
                                  for p in PM.tree_leaves(out[0])]
            return out
        return bundle._replace(step_fn=step_fn)
    ST.build_train_step = build_timed
    with _plain_versions_refuse_the_card(torch, SHARDED_PLAIN if cuda
                                         else ()):
        TR._mesh_rank(rank, args)
    mine = {"rank": rank, "steps": rows, **info}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every if rank == 0 else None


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(tree[k], dev) for k in sorted(tree)}
    return tree.to(dev)


def _sharded_main(TR, opts, argv):
    """``launch.train.main(argv)`` with :func:`_sharded_train_rank` in
    place of its rank function: every rank's rows, in rank order."""
    import functools
    inner = TR._mesh_rank
    TR._mesh_rank = functools.partial(_sharded_train_rank, opts)
    try:
        return TR.main(argv)
    finally:
        TR._mesh_rank = inner


def phase_sharded(torch):
    """Phase 7i: the global scope with one rank a worker, driven through
    its entry point, ``launch.train.main --mesh``: 4 ranks in one gloo
    group on the one card, qwen3-0.6b at full width, 2 x 128 tokens a
    worker, brsgd under sign_flip at 0.25 (prefix), sgd, on the flat
    mesh of 4 under gather and under a2a and on the 2 x 2 data x model
    mesh under a2a: a warm-up and SHARDED_STEPS timed steps each.  Gates,
    on every step of every rank: on cuda:0 over gloo and every
    collective's tensor a CUDA one; the aggregation's all_gather /
    all_to_all counts equal engine.expected_collectives; the statistics
    kernel once a leaf (and B6 / B6-bwd once a layer, nothing else; the
    check's own launch taken out); the warm-up's scores and selection
    equal aggregate_local's on the same post-attack G, the aggregate
    within SHARDED_AGG_TOL; then card = CPU at the reduced config
    (launch.train.main --reduced on the card against --device cpu,
    params within SHARDED_CPU_TOL of max|Δp|).  Returns (the results,
    every launch of the full-width runs: each step of each rank)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.launch import train as TR
    torch.cuda.empty_cache()
    sub = {}
    spec = engine.get_spec("brsgd")
    L = get_config(SHARDED_ARCH).n_layers
    results, launches = [], {}
    for name, mesh_spec, layout in SHARDED_CASES:
        t0 = time.perf_counter()
        per_rank = _sharded_main(
            TR, {"check": True, "device": "cuda", "cpu_init": False},
            _sharded_argv(mesh_spec, layout, 1 + SHARDED_STEPS))
        sub[f"{name}_{layout}"] = time.perf_counter() - t0
        n_leaves = per_rank[0]["n_leaves"]
        want_c = engine.expected_collectives(spec, layout, n_leaves)
        want_l = {"fused_stats": n_leaves, "flash_attention": L,
                  "flash_attention_bwd": L}
        for rk in per_rank:
            if rk["device"] != "cuda:0" or rk["backend"] != "gloo":
                fail(f"7i {name}/{layout}: rank {rk['rank']} on "
                     f"{rk['device']} over {rk['backend']}")
            if len(rk["steps"]) != 1 + SHARDED_STEPS:
                fail(f"7i {name}/{layout}: rank {rk['rank']} ran "
                     f"{len(rk['steps'])} steps")
            for s, row in enumerate(rk["steps"]):
                if row["device_types"] != ["cuda"]:
                    fail(f"7i {name}/{layout}: a collective took a tensor "
                         f"on {row['device_types']}")
                got_c = row["collectives"]
                if got_c != {k: want_c[k] for k in got_c}:
                    fail(f"7i {name}/{layout} step {s} rank {rk['rank']}: "
                         f"collectives {got_c}, expected {want_c}")
                if row["launches"] != want_l:
                    fail(f"7i {name}/{layout} step {s} rank {rk['rank']}: "
                         f"launches {row['launches']} (the check's "
                         f"{row['check_launches']} taken out), expected "
                         f"{want_l}")
                if not all(math.isfinite(row[k]) for k in ("loss",
                                                           "gnorm")):
                    fail(f"7i {name}/{layout} step {s}: {row}")
                for k, v in row["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        chk = per_rank[0]["check"]
        if not (chk["scores_equal"] and chk["selected_equal"]
                and chk["agg_err_over_max"] <= SHARDED_AGG_TOL):
            fail(f"7i {name}/{layout}: the sharded aggregate against "
                 f"aggregate_local: {chk}")
        timed = [rk["steps"][1:] for rk in per_rank]
        host = [float(np.median([r["host_ms"] for r in t])) for t in timed]
        split = {k: float(np.median([r["split_ms"][k] for t in timed
                                     for r in t]))
                 for k in timed[0][0]["split_ms"]}
        res = {"mesh": name, "argv_mesh": mesh_spec, "layout": layout,
               "entry": "launch.train.main",
               "workers": per_rank[0]["workers"], "D": chk["D"],
               "n_leaves": n_leaves, "backend": per_rank[0]["backend"],
               "host_ms": max(host), "host_ms_by_rank": host,
               "host_ms_runs": [[r["host_ms"] for r in t] for t in timed],
               "warmup_host_ms": [rk["steps"][0]["host_ms"]
                                  for rk in per_rank],
               "split_ms": split,
               "bytes_sent_per_rank": [rk["steps"][1]["bytes_sent"]
                                       for rk in per_rank],
               "peak_gb_by_rank": [max(r["peak_gb"] for r in rk["steps"])
                                   for rk in per_rank],
               "card_used_gb": max(r["card_used_gb"] for rk in per_rank
                                   for r in rk["steps"]),
               "collectives_per_step": per_rank[0]["steps"][1]["collectives"],
               "launches_per_step": per_rank[0]["steps"][1]["launches"],
               "launches_all_steps_all_ranks": {
                   k: sum(r["launches"].get(k, 0) for rk in per_rank
                          for r in rk["steps"]) for k in want_l},
               "check_launches": per_rank[0]["steps"][0]["check_launches"],
               "n_selected": [r["n_selected"] for r in per_rank[0]["steps"]],
               "loss": [r["loss"] for r in per_rank[0]["steps"]],
               "check": {k: chk[k] for k in ("agg_err_over_max",
                                              "scores_equal",
                                              "selected_equal",
                                              "selected")}}
        emit({"check": "sharded_step", **res})
        results.append(res)
    # card = CPU at the reduced config
    t0 = time.perf_counter()
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = _sharded_main(
            TR, {"check": False, "device": device, "cpu_init": True},
            _sharded_argv("4", "a2a", SHARDED_CPU_STEPS, reduced=True,
                          device=device))[0]
    card, host = out["cuda"], out["cpu"]
    cfg = get_config(SHARDED_ARCH).reduced()
    dp = max(float(np.abs(h - p).max()) for h, p in zip(host["params"],
                                                        host["init"]))
    err = max(float(np.abs(c - h).max()) for c, h in zip(card["params"],
                                                         host["params"]))
    sel_equal = [a["n_selected"] for a in card["steps"]] == \
        [a["n_selected"] for a in host["steps"]]
    cpu_res = {"arch": cfg.name, "layout": "a2a", "entry":
               "launch.train.main --reduced", "steps": SHARDED_CPU_STEPS,
               "params_err_over_max_dp": err / dp,
               "n_selected_equal": sel_equal}
    emit({"check": "sharded_card_vs_cpu", **cpu_res})
    if not (dp > 0 and err <= SHARDED_CPU_TOL * dp and sel_equal
            and card["init"] is not None
            and all(np.array_equal(a, b) for a, b in zip(card["init"],
                                                         host["init"]))):
        fail(f"7i card = CPU: {cpu_res}")
    sub["card_vs_cpu"] = time.perf_counter() - t0
    return {"cases": results, "card_vs_cpu": cpu_res,
            "sub_seconds": sub}, launches


# ---------------------------------------------------------------------------
# 7e. the zoo configs at full width: dense, MLA, and the MoE segment
# ---------------------------------------------------------------------------

def _moe_cfg(arch, n_layers, lossless=False):
    """``arch`` at full width cut to ``n_layers`` layers; ``lossless``:
    with capacity_factor = E / k."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    if lossless:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _zoo_serve_loop(torch, ref, worst, arch, args, cfg=None):
    """``arch`` through serve.main --serve-loop at full width from --seed
    (with ``cfg``, the arch cut in depth, the launcher's serve-loop
    function on it): every request completes, one decode graph, B6 once
    a layer per admission (held against its plain version on the loop's
    own prefill inputs) and none in the decode step, every request's
    tokens equal to its isolated batch-1 serve.generate decode but for a
    near tie (BF16_CACHE_TOL over the bfloat16 cache)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    argv = ["--arch", arch, "--serve-loop", *args]
    with _first_inputs(torch, ops, ("flash_attention",)) as seen:
        t0 = time.perf_counter()
        if cfg is None:
            cfg = get_config(arch)
            res = serve.main(argv)
        else:
            res = serve.run_serve_loop(serve.parse_args(argv), cfg,
                                       torch.device("cuda"))
        secs = time.perf_counter() - t0
    seen["wkv6_seq"] = {}
    loop, stream, done = res["loop"], res["stream"], res["done"]
    per = _check_loop_launches(arch, cfg, res)
    if res["decode_graphs"] != 1:
        fail(f"serve loop {arch}: {res['decode_graphs']} decode "
             f"graphs (expected 1)")
    if sorted(done) != list(range(len(stream))) or any(
            len(done[r]) != g for r, (_, g) in enumerate(stream)):
        fail(f"serve loop {arch}: not every request completed")
    lat = loop.metrics.step_lat_s
    row = {"check": "serve_loop", "arch": arch,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "requests": res["requests"], "max_batch": res["max_batch"],
           "max_len": res["max_len"], "tokens": res["tokens"],
           "seconds": secs, "tok_s": res["tok_s"], "steps": res["steps"],
           "decode_tok_s": res["decode_tok_s"],
           "step_ms_median": float(sorted(lat[1:])[len(lat[1:]) // 2])
           * 1e3 if len(lat) > 1 else None,
           "decode_graphs": res["decode_graphs"],
           "prefill_shapes": res["prefill_shapes"],
           "launches_per_admission": per, "decode_launches": "none",
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.is_moe:
        row["capacity_factor"] = cfg.moe.capacity_factor
    row["prefill_inputs_checked"] = _check_loop_inputs(
        torch, ref, arch, seen, worst)
    if not row["prefill_inputs_checked"]:
        fail(f"serve loop {arch}: no prefill kernel input seen")
    t0 = time.perf_counter()
    row["against_generate"] = {
        "cache_dtype": cfg.dtype, "near_tie_tol": BF16_CACHE_TOL,
        **_ties(_against_generate(torch, serve, cfg, loop.params(), stream,
                                  done, res["max_len"], BF16_CACHE_TOL))}
    row["against_generate_seconds"] = time.perf_counter() - t0
    emit(row)
    del res, loop, done, seen
    torch.cuda.empty_cache()
    return row, per


def phase_zoo_serve(torch, ref, worst):
    """(a) serve.main at full width for qwen3-1.7b, minicpm3-4b (MLA, B6's
    (96, 64) instance) and nemotron-4-15b (62.5 GB of weights: the cache
    is emptied first and nothing else stays on the card), then the
    launcher's single-shot function for dbrx-132b and deepseek-v2-236b
    (B6's (192, 128) instance) at full width cut to MOE_SERVE_LAYERS,
    each alone on the card, with B6 held to one launch a layer a
    prefill; (b) each card = CPU at full width cut to 2 layers (the moe
    archs to one moe layer at the config's capacity factor, at
    MOE_CPU_SHAPE over a float32 cache); (c) minicpm3-4b through the
    serve loop, and deepseek-v2 at MOE_SERVE_LAYERS with lossless
    dispatch.  B6 only: it runs while the BrSGD libraries build.  Returns
    the results and the launches counted."""
    import gc
    out = {"serve": {}, "launches": {}, "per_prefill": {}}
    sub_s = {}
    serves = [(arch, None) for arch in ZOO_SERVE_ARCHS] + [
        (arch, _moe_cfg(arch, MOE_SERVE_LAYERS)) for arch in MOE_ARCHS]
    for arch, cfg in serves:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res, total, pre = _serve_full_width(torch, arch, ZOO_SERVE_ARGS,
                                            cfg)
        sub_s[f"serve {arch}"] = time.perf_counter() - t0
        out["serve"][arch] = {k: res[k] for k in (
            "prefill_tok_s", "decode_tok_s", "prefill_s", "decode_s",
            "n_layers", "batch", "prompt_len", "gen", "repeat",
            "peak_mem_gb")}
        for k, n in total.items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        out["per_prefill"][arch] = pre
        del res
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ZOO_SERVE_ARCHS:
        t0 = time.perf_counter()
        B, S = ZOO_CPU_SHAPES[arch]
        _serve_card_vs_cpu(torch, arch, B, S, ZOO_CPU_STEPS,
                           ZOO_CPU_CACHES[arch])
        sub_s[f"serve card vs CPU {arch}"] = time.perf_counter() - t0
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        _serve_card_vs_cpu(torch, arch, *MOE_CPU_SHAPE, ZOO_CPU_STEPS,
                           ("float32",), MOE_CPU_LAYERS[arch])
        sub_s[f"serve card vs CPU {arch}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve_loop"], out["loop_per_admission"] = _zoo_serve_loop(
        torch, ref, worst, ZOO_LOOP_ARCH, ZOO_LOOP_ARGS)
    sub_s[f"serve loop {ZOO_LOOP_ARCH}"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["moe_serve_loop"], per = _zoo_serve_loop(
        torch, ref, worst, MOE_LOOP_ARCH, MOE_LOOP_ARGS,
        _moe_cfg(MOE_LOOP_ARCH, MOE_SERVE_LAYERS, lossless=True))
    out["loop_per_admission_moe"] = per
    sub_s[f"serve loop {MOE_LOOP_ARCH}"] = time.perf_counter() - t0
    emit({"check": "zoo_serve_seconds", **sub_s})
    return out


def phase_zoo_train(torch, zoo):
    """(d) qwen3-1.7b's train step at full width through
    launch.train.main, m = ZOO_TRAIN_M, brsgd under sign_flip at 0.25,
    adamw, the plain versions refusing the card, each step 1 brsgd launch
    and one B6 and one B6-bwd launch a layer a worker; (e) one worker's
    gradient of dbrx-132b and deepseek-v2-236b at full width cut to
    MOE_GRAD_LAYERS, at MOE_GRAD_SHAPE (one B6 and one B6-bwd launch a
    layer: the (192, 128) instances for deepseek-v2); (f) card = CPU
    steps of minicpm3-4b, nemotron-4-15b, dbrx-132b and deepseek-v2.
    Adds its results and launches to ``zoo`` (phase_zoo_serve's)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as PL
    from repro_torch.kernels import ops
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    out, sub_s = zoo, {}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ZOO_TRAIN_ARCH)
    m = ZOO_TRAIN_M
    n = m * cfg.n_layers
    want = {"brsgd_aggregate": 1, "flash_attention": n,
            "flash_attention_bwd": n}
    # no checkpoint: phase 7d writes and counts one (6.9 GB here)
    with _plain_versions_refuse_the_card(torch):
        t0 = time.perf_counter()
        params, opt_state, res, probe, got_each = _train_full_width(
            torch, ops, cfg, m, want)
        res["D"] = PM.count_params(TF.param_defs(cfg))
        res["seconds"] = time.perf_counter() - t0
        sub_s[f"train {ZOO_TRAIN_ARCH}"] = res["seconds"]
        emit(res)
        out["train"] = res
        del params, opt_state, probe
    for got in got_each:
        for k, v in got.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    out["moe_gradient"] = {}
    for arch in MOE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = _moe_cfg(arch, MOE_GRAD_LAYERS[arch])
        t0 = time.perf_counter()
        params = PM.init_params(
            TF.param_defs(cfg), torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        leaves = list(_flat_leaves(params).values())
        for t in leaves:
            t.requires_grad_(True)
        with _plain_versions_refuse_the_card(torch):
            res = _grad_on_card(torch, ops, TF, PL, cfg, params, leaves,
                                "moe", *MOE_GRAD_SHAPE, False)
        res["D"] = PM.count_params(TF.param_defs(cfg))
        res["seconds"] = time.perf_counter() - t0
        sub_s[f"gradient {arch}"] = res["seconds"]
        out["moe_gradient"][arch] = {k: res[k] for k in (
            "n_layers", "D", "batch", "seq", "host_ms", "host_ms_runs",
            "peak_device_gb", "device_busy_ms", "device_ms_by_group",
            "launches") if k in res}
        out["moe_gradient"][arch]["n_layers"] = cfg.n_layers
        for k, v in res["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    for arch, n_layers in ZOO_TRAIN_CPU_CASES:
        t0 = time.perf_counter()
        _train_card_vs_cpu(torch, arch, n_layers)
        sub_s[f"train card vs CPU {arch}"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    emit({"check": "zoo_train_seconds", **sub_s})
    return out


# ---------------------------------------------------------------------------
# 7g. mamba2 and the hybrid segment; the prefix frontends
# ---------------------------------------------------------------------------

def _serve_prefix_full_width(torch, arch, B, S, gen, repeat):
    """serve.generate at full width with the config's seeded prefix
    (``pipeline.prefix_embeddings``) before a [B, S] prompt, ``repeat``
    passes: B6 once a layer in each prefill (over P + S positions),
    nothing in decode, finite logits.  Returns (result, launches over
    every pass, launches of one prefill)."""
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as PL
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    cfg = get_config(arch)
    P = cfg.n_prefix_tokens
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = PM.init_params(TF.param_defs(cfg), g, device="cuda")
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda")
    prefix = torch.from_numpy(PL.prefix_embeddings(cfg, 0, (B,))).to("cuda")
    ops.reset_launches()
    runs = [serve.generate(cfg, params, prompt, gen, P + S + gen,
                           prefix_embed=prefix) for _ in range(repeat)]
    secs = time.perf_counter() - t0
    total = {k: n for k, n in ops.launches().items() if n}
    want = _expected_prefill(cfg, P + S)
    for r in runs:
        pre = {k: n for k, n in r[4]["prefill"].items() if n}
        dec = {k: n for k, n in r[4]["decode"].items() if n}
        if pre != want or dec:
            fail(f"serve {arch}: prefill launched {pre} (expected {want}), "
                 f"decode launched {dec} (expected none)")
    if total != {k: n * repeat for k, n in want.items()}:
        fail(f"serve {arch}: {repeat} passes launched {total}")
    logits = runs[-1][1]
    if not bool(torch.isfinite(logits).all()):
        fail(f"serve {arch}: non-finite logits")
    t_pre = statistics.median(r[2] for r in runs)
    t_dec = statistics.median(r[3] for r in runs)
    res = {"prefill_tok_s": B * S / t_pre,
           "prefill_positions_s": B * (P + S) / t_pre,
           "decode_tok_s": B * gen / t_dec, "prefill_s": t_pre,
           "decode_s": t_dec, "n_layers": cfg.n_layers, "batch": B,
           "prompt_len": S, "prefix_tokens": P, "gen": gen,
           "repeat": repeat,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit({"check": "serve", "arch": arch, "entry": "serve.generate",
          "d_model": cfg.d_model, **res, "prefill_launches": pre,
          "decode_launches": "none", "launches_all_passes": total,
          "seconds": secs, "logits_finite": True})
    del params, runs, logits
    return res, total, pre


def _prefill_equals_decode_reduced(torch, arch):
    """The reduced config's fused prefill against its sequential decode
    on the card (logits and every cache leaf, SERVE_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    cfg = get_config(arch).reduced()
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = PM.init_params(TF.param_defs(cfg), gen, device="cuda")
    B, S, T = 2, 40, 44                  # past a 32-token chunk
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    lf, cf = TF.prefill_cache(cfg, params, tokens,
                              TF.init_cache(cfg, B, T, torch.float32, "cuda"))
    cache = TF.init_cache(cfg, B, T, torch.float32, "cuda")
    ls = []
    for i in range(S):
        lg, cache = TF.decode_step(cfg, params, cache, tokens[:, i:i + 1], i)
        ls.append(lg[:, 0])
    ls = torch.stack(ls, dim=1)
    err = _err(lf, ls) / float(ls.abs().max())
    a, b = _flat_leaves(cf), _flat_leaves(cache)
    leaf = max(_err(a[k], b[k]) / max(float(b[k].abs().max()), 1e-30)
               for k in a)
    emit({"check": "prefill_equals_sequential_decode", "arch": cfg.name,
          "seq": S, "logits_rel_err": err, "cache_rel_err": leaf,
          "rel_tol": SERVE_TOL})
    if err > SERVE_TOL or leaf > SERVE_TOL:
        fail(f"{cfg.name}: prefill differs from sequential decode on the "
             f"card (logits {err}, cache {leaf})")


def phase_hybrid_serve(torch, ref, worst):
    """(a) zamba2-2.7b through serve.main at full width (B6's (80, 80)
    instance once a unit: 9 a prefill), phi-3-vision-4.2b (B6's (96, 96)
    instance) and musicgen-large through serve.generate with their
    seeded prefix, each alone on the card; (b) card = CPU over a float32
    cache (HF_CPU_CASES); (c) zamba2's reduced prefill == its sequential
    decode; (d) zamba2 through the serve loop.  B6 only: it runs while
    the BrSGD libraries build.  Returns the results and launches."""
    import gc
    out = {"serve": {}, "launches": {}, "per_prefill": {}}
    sub_s = {}
    args = dict(zip(ZOO_SERVE_ARGS[::2], ZOO_SERVE_ARGS[1::2]))
    for arch in (HYBRID_ARCH,) + PREFIX_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if arch == HYBRID_ARCH:
            res, total, pre = _serve_full_width(torch, arch, ZOO_SERVE_ARGS)
        else:
            res, total, pre = _serve_prefix_full_width(
                torch, arch, int(args["--batch"]), int(args["--prompt-len"]),
                int(args["--gen"]), int(args["--repeat"]))
        sub_s[f"serve {arch}"] = time.perf_counter() - t0
        out["serve"][arch] = {k: res[k] for k in (
            "prefill_tok_s", "decode_tok_s", "prefill_s", "decode_s",
            "n_layers", "batch", "prompt_len", "gen", "repeat",
            "peak_mem_gb") if k in res}
        out["serve"][arch]["prefix_tokens"] = res.get("prefix_tokens", 0)
        for k, n in total.items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        out["per_prefill"][arch] = pre
        del res
    gc.collect()
    torch.cuda.empty_cache()
    for arch, (n_layers, B, S) in HF_CPU_CASES.items():
        t0 = time.perf_counter()
        _serve_card_vs_cpu(torch, arch, B, S, ZOO_CPU_STEPS, ("float32",),
                           n_layers)
        sub_s[f"serve card vs CPU {arch}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _prefill_equals_decode_reduced(torch, HYBRID_ARCH)
    sub_s["prefill == decode zamba2 reduced"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["serve_loop"], out["loop_per_admission"] = _zoo_serve_loop(
        torch, ref, worst, HYBRID_ARCH, HF_LOOP_ARGS)
    sub_s[f"serve loop {HYBRID_ARCH}"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    emit({"check": "hybrid_frontends_serve_seconds", **sub_s})
    return out


def _ssd_device_ms(torch, cfg, B, S) -> dict:
    """Device ms of one mamba2 layer's SSD (``mamba2._ssd_chunked``: its
    batched products, the decays, the chunk recurrence) at the layer's
    shapes for [B, S], forward alone and forward + backward, on seeded
    inputs (dt a softplus of a normal, A = -1)."""
    import torch.nn.functional as F
    from repro_torch.models import mamba2 as M2
    di, H = M2.dims(cfg.d_model, cfg.ssm)
    N, Pd = cfg.ssm.state_dim, di // H
    g = torch.Generator(device="cuda").manual_seed(0)
    xh = torch.randn(B, S, H, Pd, generator=g, device="cuda")
    dt = F.softplus(torch.randn(B, S, H, generator=g, device="cuda"))
    Bc, Cc = (torch.randn(B, S, N, generator=g, device="cuda")
              for _ in range(2))
    A = -torch.ones(H, device="cuda")
    ins = [t.requires_grad_(True) for t in (xh, dt, Bc, Cc)]

    def fwd():
        with torch.no_grad():
            M2._ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm.chunk)

    def fwd_bwd():
        y, st = M2._ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm.chunk)
        torch.autograd.grad(y.sum() + st.sum(), ins)
    fwd()
    fwd_bwd()
    return {"forward": sum(_device_ms(torch, fwd).values()),
            "forward_backward": sum(_device_ms(torch, fwd_bwd).values())}


def phase_hybrid_train(torch, hf):
    """(e) one worker's gradient at full width of zamba2-2.7b ([2, 128],
    and [1, 4096] with remat), phi-3-vision-4.2b and musicgen-large
    ([2, 128] after their prefix), the plain versions refusing the card,
    every leaf finite, one B6 and one B6-bwd launch an attention
    application (two B6 with remat), and zamba2's SSD device time a
    layer; (f) zamba2's train step through launch.train.main at m =
    HF_TRAIN_M, brsgd under sign_flip at 0.25, sgd, the launch held on
    column blocks; (g) card = CPU steps of the three at reduced().  Adds
    its results and launches to ``hf`` (phase_hybrid_serve's)."""
    import gc
    from repro_torch.configs import ByzantineConfig, get_config
    from repro_torch.data import pipeline as PL
    from repro_torch.kernels import ops
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    out, sub_s = hf, {}
    out["gradient"] = []
    for arch in dict.fromkeys(a for a, *_ in HF_GRAD_CASES):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        params = PM.init_params(
            TF.param_defs(cfg), torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        leaves = list(_flat_leaves(params).values())
        for t in leaves:
            t.requires_grad_(True)
        with _plain_versions_refuse_the_card(torch):
            for a, B, S, remat in HF_GRAD_CASES:
                if a != arch:
                    continue
                t0 = time.perf_counter()
                res = _grad_on_card(torch, ops, TF, PL, cfg, params, leaves,
                                    TF.segments(cfg)[0].kind, B, S, remat)
                if cfg.ssm is not None:
                    ssd = _ssd_device_ms(torch, cfg, B, S)
                    res["ssd_device_ms_per_layer"] = ssd
                    res["ssd_device_ms_all_layers"] = {
                        "forward": ssd["forward"] * cfg.n_layers,
                        "forward_backward": ssd["forward_backward"]
                        * cfg.n_layers,
                        "note": "one layer's SSD timed alone, times "
                                "n_layers; inside the gemm / other groups "
                                "of device_ms_by_group"}
                    emit({"check": "gradient_ssd", "arch": arch,
                          "batch": B, "seq": S, "per_layer": ssd,
                          **res["ssd_device_ms_all_layers"]})
                res["seconds"] = time.perf_counter() - t0
                sub_s[f"gradient {arch} [{B},{S}]"
                      f"{' remat' if remat else ''}"] = res["seconds"]
                out["gradient"].append({k: res[k] for k in (
                    "arch", "batch", "seq", "remat", "prefix_tokens",
                    "host_ms", "host_ms_runs", "peak_device_gb",
                    "device_busy_ms", "device_ms_by_group", "launches",
                    "finite", "ssd_device_ms_per_layer") if k in res})
                for k, v in res["launches"].items():
                    out["launches"][k] = out["launches"].get(k, 0) + v
        del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(HYBRID_ARCH)
    bcfg = ByzantineConfig(**TRAIN_ATTACK)
    m = HF_TRAIN_M
    n = m * _attn_apps(cfg)
    want = {"brsgd_aggregate": 1, "flash_attention": n,
            "flash_attention_bwd": n}
    with _plain_versions_refuse_the_card(torch):
        t0 = time.perf_counter()
        params, opt_state, res, probe, got_each = _train_full_width(
            torch, ops, cfg, m, want, optimizer=HF_TRAIN_OPTIMIZER)
        res["D"] = PM.count_params(TF.param_defs(cfg))
        res["optimizer"] = HF_TRAIN_OPTIMIZER
        res["seconds"] = time.perf_counter() - t0
        del params, opt_state
        t0 = time.perf_counter()
        res["launch_held_on_blocks"] = _hold_launch_on_blocks(
            torch, probe["G"], probe["result"][1], probe["agg_blocks"],
            bcfg.beta, bcfg.threshold)
        res["launch_check_seconds"] = time.perf_counter() - t0
        sub_s[f"train {HYBRID_ARCH}"] = res["seconds"]
        emit(res)
        out["train"] = res
        del probe
    for got in got_each:
        for k, v in got.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    for arch in (HYBRID_ARCH,) + PREFIX_ARCHS:
        t0 = time.perf_counter()
        _train_card_vs_cpu(torch, arch, None)
        sub_s[f"train card vs CPU {arch}"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    emit({"check": "hybrid_frontends_train_seconds", **sub_s})
    return out


# ---------------------------------------------------------------------------
# 7f. the demo twins
# ---------------------------------------------------------------------------

def phase_demos(torch):
    """The three demo twins of src/repro_torch/paper on the card:
    train_100m --full (the ~100M qwen3 config, D = 100,684,032, m = 8
    workers of 4 x 512 tokens, gaussian at 0.25, brsgd) for
    DEMO_100M_STEPS steps, each 1 brsgd launch and one B6 and one B6-bwd
    launch a layer a worker, the loss falling; serve_demo
    --train-and-serve (its own assertions: 8 requests, a hot swap, the
    last checkpoint served, one decode graph a parameter slot; its
    launches: 5 brsgd, one B6 and B6-bwd a layer a worker a step, one B6
    a layer an admission); and byzantine_lenet at DEMO_LENET_STEPS steps
    (one brsgd, median or mean launch a step; the brsgd column
    finite)."""
    import shutil
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.paper import byzantine_lenet, serve_demo, train_100m
    out, sub_s = {}, {}
    tmp = Path(tempfile.mkdtemp(prefix="demo_", dir=ROOT / "build"))
    try:
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = train_100m.main(["--full", "--steps", str(DEMO_100M_STEPS),
                                "--ckpt-dir", str(tmp / "train_100m")])
        sub_s["train_100m"] = time.perf_counter() - t0
        cfg = train_100m.full_config()
        n = DEMO_100M_STEPS * 8 * cfg.n_layers
        want = {"brsgd_aggregate": DEMO_100M_STEPS, "flash_attention": n,
                "flash_attention_bwd": n}
        got = {k: v for k, v in ops.launches().items() if v}
        if got != want or len(hist) != DEMO_100M_STEPS:
            fail(f"train_100m --full: launches {got} (expected {want}), "
                 f"{len(hist)} steps")
        out["train_100m"] = {
            "steps": len(hist), "losses": [h["loss"] for h in hist],
            "launches": got, "seconds": sub_s["train_100m"],
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit({"check": "train_100m_full", **out["train_100m"]})
        torch.cuda.empty_cache()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = serve_demo.main(["--train-and-serve"])
        sub_s["serve_demo"] = time.perf_counter() - t0
        got = {k: v for k, v in ops.launches().items() if v}
        # the reduced model (2 layers): 5 steps of 8 workers, then 8
        # prefills at batch 1; the decode steps launch nothing
        want = {"brsgd_aggregate": 5, "flash_attention": 5 * 8 * 2 + 8 * 2,
                "flash_attention_bwd": 5 * 8 * 2}
        if got != want:
            fail(f"serve_demo --train-and-serve: launches {got} (expected "
                 f"{want})")
        out["serve_demo"] = {"requests": len(res["done"]),
                             "swap_count": res["swap_count"],
                             "loaded_step": res["loaded_step"],
                             "decode_graphs": res["decode_graphs"],
                             "launches": got}
        emit({"check": "serve_demo_train_and_serve", **out["serve_demo"]})
        del res
        ops.reset_launches()
        t0 = time.perf_counter()
        table = byzantine_lenet.main(["--steps", str(DEMO_LENET_STEPS)])
        sub_s["byzantine_lenet"] = time.perf_counter() - t0
        got = {k: v for k, v in ops.launches().items() if v}
        # one launch a step: brsgd and the median under the four attacks,
        # the mean under them and in the baseline
        n = DEMO_LENET_STEPS
        want = {"brsgd_aggregate": 4 * n, "cwise_median": 4 * n,
                "masked_mean": 5 * n}
        if got != want:
            fail(f"byzantine_lenet: launches {got} (expected {want})")
        if not all(math.isfinite(r["brsgd"]) for r in table["rows"].values()):
            fail(f"byzantine_lenet: a brsgd accuracy is not finite: {table}")
        out["byzantine_lenet"] = {**table, "launches": got}
        emit({"check": "byzantine_lenet", **out["byzantine_lenet"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"check": "demos_seconds", **sub_s})
    return out


# ---------------------------------------------------------------------------
# 8. timing
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _column_instance(*variants) -> str:
    """A pattern of the column pass's instances of these variants: the
    template arguments <M, VARIANT, BUCKET> in the profiler's demangled
    name, or in the mangled one."""
    v = "|".join(str(x) for x in variants)
    return rf"column_stats_kernel(<\d+, ({v}), |ILi\d+ELi({v})E)"


# the device kernel each timed row launches, by a pattern its name
# matches (the parent tree's combine_rows_kernel served both B2 and B3,
# its fused_stats_kernel B1's every call and B4, the median included, and
# its trimmed_mean_kernel B5); the column pass's rows name their variants,
# so that none counts another's launches
KERNEL_NAMES = {
    "fused_stats": (_column_instance(*range(1, 8)), "fused_stats_kernel"),
    "fused_stats[gram]": ("fused_stats_kernel",),
    "select_mean": ("select_mean_kernel", "combine_rows_kernel"),
    "masked_mean": ("masked_mean_kernel", "combine_rows_kernel"),
    "brsgd_stats": (_column_instance(19), "fused_stats_kernel"),
    "cwise_median": (_column_instance(16), "fused_stats_kernel"),
    "trimmed_mean": (_column_instance(32), "trimmed_mean_kernel"),
    "brsgd_aggregate": ("brsgd_aggregate_kernel", "select_aggregate_kernel"),
    **{f"select_aggregate[{r}]": ("select_aggregate_kernel",)
       for r in GRAM_RULES},
}


def _kernel_device_ms(torch, fn, reps: int, kernels, warmup: int = 3,
                      records: dict = None):
    """Device time of the kernels one call of fn launches, by
    torch.profiler over reps calls.  ``kernels`` has one entry per kernel
    a call launches (one for the aggregation kernels, three for B6's
    backward), each a tuple of name patterns (regular expressions) of
    which the kernel's name matches one; each is taken at its mean over
    the records the trace kept (a trace can lose records), and the means
    are summed.  A trace that lost every record of one of them is taken
    again; after three such traces the result is None, as a sum that
    leaves a kernel out would read low.  ``records``, when given,
    receives the number of records
    of each kernel in the trace read.  Unlike CUDA events around
    back-to-back launches it leaves out the idle gaps when the host
    launches slower than the kernel runs (the L2 shape's few-microsecond
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count]
        us, counts = 0.0, {}
        for parts in kernels:
            hit = [e for e in evs if any(re.search(k, e.key) for k in parts)]
            n = counts[parts[0]] = sum(e.count for e in hit)
            for e in hit:
                t = getattr(e, "self_device_time_total", None)
                us += (e.self_cuda_time_total if t is None else t) / n
        if records is not None:
            records.update(counts)
        if all(counts.values()):
            return us / 1e3
    return None


def _host_ms(torch, fn, reps: int = None) -> dict:
    """Host-clock milliseconds of fn() ending in a synchronize: median
    and 80th percentile (10 samples beyond it at 50 reps)."""
    reps = reps or HOST_REPS
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return {"median": ts[reps // 2], "p80": ts[int(0.8 * reps)]}


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(torch, kern, ref, shape, reps, plain_reps, worst):
    import numpy as np
    m, d = shape
    rng = np.random.default_rng(7)
    G = torch.as_tensor(rng.standard_normal((m, d), dtype=np.float32),
                        device="cuda")
    # the fused select launch and the column pass against their plain
    # versions on the timing input (B1's non-gram subsets and gram +
    # d2med, B4, the median alone)
    _check_select(torch, kern, ref, G, f"[{m},{d}] timing input", worst)
    if shape == HBM_SHAPE:
        _check_column_pass(torch, kern, ref, G, f"[{m},{d}] timing input",
                           COLUMN_SUBSETS, worst)
    st = kern.fused_stats(G, ("scores", "l1"))
    kth, T = ref.brsgd_thresholds(st["scores"], st["l1"], 0.5, 0.0)
    _, w_sel = kern.select_mean(G, st["scores"], st["l1"], kth, T)
    mask = torch.ones(m, device="cuda")
    n_sel = int(w_sel.sum())
    k = ref.trim_k(TRIM_FRACS[0], m)
    mp = ref.padded_workers(m)
    n_cmpx = sum(len(s) for s in ref.bitonic_stages(mp))
    sort_ops = 2 * n_cmpx * d
    gb = m * d * 4
    lib_combine = lambda w: (w @ G) / w.sum()                  # noqa: E731
    rows = {
        "fused_stats": dict(
            fn=lambda: kern.fused_stats(G, ("scores", "l1")),
            plain=lambda: ref.fused_stats_ref(G, ("scores", "l1")),
            library=None, nbytes=gb + 2 * m * 4,
            ops=(m + 1 + 2 * m) * d + sort_ops + 3 * m * d),
        "fused_stats[gram]": dict(
            fn=lambda: kern.fused_stats(G, ("gram",)),
            plain=lambda: ref.fused_stats_ref(G, ("gram",)),
            library=lambda: G @ G.T, nbytes=gb + m * m * 4,
            ops=2 * m * m * d),
        # every row read, weight 0 included (the reference's w @ g), and
        # summed; out and w written
        "select_mean": dict(
            fn=lambda: kern.select_mean(G, st["scores"], st["l1"], kth, T),
            plain=lambda: ops_select_plain(ref, G, st, kth, T),
            library=lambda: lib_combine(w_sel),
            nbytes=gb + d * 4 + m * 4, ops=2 * m * d + d),
        "masked_mean": dict(
            fn=lambda: kern.masked_mean(G, mask),
            plain=lambda: ref.masked_mean_det(G, mask),
            library=lambda: lib_combine(mask),
            nbytes=gb + d * 4, ops=2 * m * d + d),
        "brsgd_stats": dict(
            fn=lambda: kern.brsgd_stats(G),
            plain=lambda: ref.brsgd_stats_ref(G),
            library=lambda: torch.quantile(G, 0.5, dim=0),
            nbytes=gb + 2 * d * 4 + 2 * m * 4,
            ops=(m + 1 + 2 * m) * d + sort_ops + 3 * m * d),
        # G read once, the median written
        "cwise_median": dict(
            fn=lambda: kern.cwise_median(G),
            plain=lambda: ref.cwise_median_ref(G),
            library=lambda: torch.quantile(G, 0.5, dim=0),
            nbytes=gb + d * 4, ops=sort_ops),
        "trimmed_mean": dict(
            fn=lambda: kern.trimmed_mean(G, TRIM_FRACS[0]),
            plain=lambda: ref.trimmed_mean_ref(G, TRIM_FRACS[0]),
            library=lambda: torch.sort(G, dim=0).values[k:m - k].mean(0),
            nbytes=gb + d * 4, ops=sort_ops + (m - 2 * k) * d),
        # G read once, out written; pass 1's operations and the combine
        # of the selected rows (the thresholds are O(m^2), none of d)
        "brsgd_aggregate": dict(
            fn=lambda: kern.brsgd_aggregate(G, 0.5, 0.0),
            plain=lambda: ref.brsgd_aggregate_plain(G, 0.5, 0.0),
            library=None, nbytes=gb + d * 4 + 9 * m * 4,
            ops=(m + 1 + 2 * m) * d + sort_ops + 3 * m * d
            + 2 * n_sel * d + d),
    }
    # the fused select launch of each gram rule: G read once, pass 2's
    # rows of nonzero weight read again unless G stays resident, out
    # written; the gram products (m(m+1)/2 pairs, 2 operations a column),
    # geomedian's median and d² to it, and the combine
    for rule, args in _select_cases(m):
        plan = kern.launch_plan(G, rule)
        r = kern.select_aggregate(G, rule, **args)
        n_w = int((r.w != 0).sum())
        ops = m * (m + 1) * d + 2 * n_w * d + d
        if rule == "geomedian":
            ops += sort_ops + 3 * m * d
        rows[f"select_aggregate[{rule}]"] = dict(
            fn=lambda rule=rule, args=args: kern.select_aggregate(
                G, rule, **args),
            plain=lambda rule=rule, args=args: ref.select_aggregate_plain(
                G, rule, **args),
            library=None, nbytes=gb + (0 if plan.resident else n_w * d * 4)
            + d * 4 + (2 * m + m * m) * 4, ops=ops,
            extra={"grid": plan.grid, "resident": plan.resident,
                   "smem_bytes": plan.smem, "nonzero_weights": n_w,
                   "args": args})
    for name, variant in (("fused_stats", 3), ("brsgd_stats", kern.B4_VARIANT),
                          ("cwise_median", kern.COLUMN_OUT),
                          ("trimmed_mean", kern.TRIM_OUT)):
        plan = kern.column_launch_plan(G, variant)
        rows[name]["extra"] = {"grid": plan.grid, "stages": plan.stages,
                               "smem_bytes": plan.smem}
    raw = _raw_launchers(torch, G, torch.stack([st["scores"], st["l1"]]),
                         torch.stack([kth, 2.0 * T]).float(), mask, k)
    out = {}
    for name, r in rows.items():
        bound_ms, bound_by = _bound(r["nbytes"], r["ops"])
        res = {"kernel_ms": _time_ms(torch, raw[name], reps),
               "device_ms": _kernel_device_ms(torch, raw[name], reps,
                                              (KERNEL_NAMES[name],)),
               "wrapper_ms": _time_ms(torch, r["fn"], reps),
               "plain_ms": _time_ms(torch, r["plain"], plain_reps, 1),
               "library_ms": (None if r["library"] is None else
                              _time_ms(torch, r["library"], reps)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               **r.get("extra", {})}
        out[name] = res
        emit({"timing": name, "shape": [m, d], **res})
    out["brsgd_aggregate"].update(_fused_turns(torch, kern, ref, G, reps,
                                               raw, out))
    return out


def _fused_turns(torch, kern, ref, G, reps, raw, rows):
    """The fused launch against the two-pass composition on the same G in
    one call, in turns (two-pass, fused, fused, two-pass), both through
    their wrappers; the bare kernels of both; and the bare fused launch
    on other grids (every grid the card holds at once, G resident where
    it fits)."""
    from repro_torch.configs.base import ByzantineConfig
    m, d = G.shape
    cfg = ByzantineConfig(aggregator="brsgd")
    two_pass = lambda: _two_pass_brsgd(kern, ref, None, G, cfg,  # noqa: E731
                                       False)
    fused = lambda: kern.brsgd_aggregate(G, 0.5, 0.0)            # noqa: E731
    turns = [_time_ms(torch, f, reps) for f in (two_pass, fused, fused,
                                                 two_pass)]
    plan = kern.launch_plan(G)
    sweep = []
    for grid in sorted({132, 264, 396, 528, plan.grid, plan.grid // 2}):
        for resident in (True, False):
            fn = raw["brsgd_aggregate@"](grid, resident)
            if fn is not None:
                sweep.append({"grid": grid, "resident": resident,
                              "ms": _time_ms(torch, fn, reps)})
    res = {"two_pass_ms": min(turns[0], turns[3]),
           "fused_wrapper_turns_ms": min(turns[1], turns[2]),
           "turns_ms": {"order": ["two-pass", "fused", "fused", "two-pass"],
                        "runs": turns},
           "two_pass_kernels_ms": rows["fused_stats"]["kernel_ms"]
           + rows["select_mean"]["kernel_ms"],
           "grid": plan.grid, "resident": plan.resident,
           "smem_bytes": plan.smem, "grid_sweep": sweep}
    emit({"timing": "brsgd_aggregate_vs_two_pass", "shape": [m, d], **res})
    if min(turns[1], turns[2]) > min(turns[0], turns[3]):
        fail(f"brsgd_aggregate [{m},{d}]: the fused launch "
             f"({min(turns[1], turns[2])} ms) is slower than the two-pass "
             f"composition ({min(turns[0], turns[3])} ms) in this call")
    return res


def _visible_pairs(S, T, window):
    """(query, key) pairs B6's mask lets through: keys j <= i (and
    i - j < window)."""
    return sum(min(i + 1, T) - (max(0, i - window + 1) if window else 0)
               for i in range(S))


def _tc_bound(nbytes: float, ops: float):
    """The 3xTF32 tensor-core bound: three TF32 products per float32
    one at 495 TFLOP/s, or the bytes, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = TF32_SPLIT * ops / TF32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_seq_timing(torch, ref):
    """B6 and B7 by CUDA events at their serve shapes (wrapper calls: the
    wrapper's host work overlaps the device queue), their plain versions
    and, for B6, one library call in the same call; bounds from this
    run's shapes.  B6 is held to its 3xTF32 tensor-core bound and also
    shows the FP32-pipe bound; B7 is timed per layer launch (both column
    splits) and as its one-chunk call."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_kern
    from repro_torch.kernels import wkv6 as wkv_kern
    out = {}
    for label, (B, H, Hkv, S, D, Dv) in FLASH_TIMING:
        q, k, v = _flash_inputs(torch, B, H, Hkv, S, D, Dv, "float32")
        kx, vx = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        qc = q.contiguous()
        # q and o, k and v, each read or written once
        nbytes = 4 * (B * H * S * (D + Dv) + B * Hkv * S * (D + Dv))
        ops = 2 * (D + Dv) * B * H * _visible_pairs(S, S, 0)
        bound_ms, bound_by = _tc_bound(nbytes, ops)
        fp32_ms, _ = _bound(nbytes, ops)
        reps = 10 if "long" in label else 50
        kern = lambda: fa_kern.flash_attention(q, k, v)        # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(            # noqa: E731
            qc, kx, vx, is_causal=True)
        # kernel, library, library, kernel: the card's clocks drift
        ms = [_time_ms(torch, kern, reps)]
        lib_ms = [_time_ms(torch, lib, reps), _time_ms(torch, lib, reps)]
        ms.append(_time_ms(torch, kern, reps))
        res = {"shape": [B, H, Hkv, S, D] + ([Dv] if Dv != D else []),
               "ms": min(ms), "ms_runs": ms,
               "plain_ms": _time_ms(torch, lambda: ref.flash_attention_ref(
                   q, k, v), max(2, reps // 5), 1),
               "library_ms": min(lib_ms), "library_ms_runs": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "fp32_bound_ms": fp32_ms,
               "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
        out[f"flash_attention/{label}"] = res
        emit({"timing": "flash_attention", "label": label, **res,
              "bound": "3xTF32 tensor cores (3 x FLOPs / 495 TFLOP/s)",
              "library_call": "F.scaled_dot_product_attention(is_causal=True)"
                              ", float32, kv heads repeated"})
        del q, k, v, kx, vx, qc
    # B7: one layer of rwkv6-7b's prefill, [B, S, H, K] = [4, 512, 64, 64]
    B, S, H, K, Q = 4, 512, 64, 64, 64
    r, k, v, w, u, S0 = _wkv_inputs(torch, B, H, S, K, 1.0)
    r, k, v, w = (x.transpose(1, 2).contiguous() for x in (r, k, v, w))
    nbytes = 4 * (5 * B * S * H * K + H * K + 2 * B * H * K * K)
    tri = Q * (Q - 1) // 2
    ops = (S // Q) * B * H * (2 * tri * 2 * K + 2 * 2 * Q * K * K)
    bound_ms, bound_by = _bound(nbytes, ops)
    res = {"shape": [B, S, H, K], "chunk": Q,
           "ms": _time_ms(torch, lambda: wkv_kern.wkv6_seq(
               r, k, v, w, u, S0, Q), 50),
           "plain_ms": _time_ms(torch, lambda: ref.wkv6_seq_plain(
               r, k, v, w, u, S0, Q), 10, 1),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "tc_bound_ms": _tc_bound(nbytes, ops)[0],
           "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
    # the one-chunk call at [4, 64, 64, 64] (the Pallas kernel's shape)
    ins = _wkv_inputs(torch, B, H, Q, K, 1.0)
    cbytes = 4 * (5 * B * H * Q * K + H * K + 2 * B * H * K * K)
    cops = B * H * (2 * tri * 2 * K + 2 * 2 * Q * K * K)
    res.update(chunk_ms=_time_ms(torch, lambda: wkv_kern.wkv6_chunk(*ins),
                                 200),
               chunk_plain_ms=_time_ms(torch, lambda: ref.wkv6_chunk_plain(
                   *ins), 50),
               chunk_bound_ms=_bound(cbytes, cops)[0])
    out["wkv6_seq/serve"] = res
    emit({"timing": "wkv6_seq", **res, "library_call": "none",
          "per": "one layer launch (8 chunks of 64)"})
    return out


def _backward_ms(torch, fn, inputs, grad_out, reps):
    """CUDA-event ms of the backward alone of out = fn(*inputs): the
    graph is built once and differentiated reps times."""
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    grads = grad_out if isinstance(grad_out, tuple) else (grad_out,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    return _time_ms(torch, lambda: torch.autograd.grad(
        [o for o, _ in pairs], leaves, [g for _, g in pairs],
        retain_graph=True, allow_unused=True), reps, 1)


def _sdpa_backend(torch, fn) -> str:
    """The backend PyTorch's scaled_dot_product_attention took, read from
    the name of the attention kernel fn() launches; "not measured" when
    three traces show none (the math backend launches no such kernel,
    but a trace that lost its records shows none either)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernel = next((e.key for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and any(
                           k in e.key.lower() for k in
                           ("fmha", "flash", "cudnn", "attention"))), None)
        if kernel:
            break
    else:
        return "not measured (no attention kernel in three traces)"
    low = kernel.lower()
    backend = ("cudnn" if "cudnn" in low else
               "flash" if "flash" in low else
               "efficient (memory-efficient / cutlass fmha)"
               if ("fmha" in low or "efficient" in low) else "unknown")
    return f"{backend}: {kernel[:100]}"


def phase_bwd_timing(torch, ref):
    """B6's and B7's backward kernels by CUDA events (wrapper calls) and
    device time (torch.profiler, every kernel of a call) at the gradient
    phase's shapes; the plain versions' backward (autograd, the forward
    graph built once) and, for B6, the backward of one
    scaled_dot_product_attention call.  Bounds from this run's shapes:
    the larger of the bytes over 3.35 TB/s and 3 x FLOPs / 495 TFLOP/s
    (3xTF32), with the FP32-pipe bound beside it."""
    import ctypes

    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa_kern
    from repro_torch.kernels import wkv6 as wkv_kern
    out = {}
    # B6-bwd's resources: each kernel's registers, spills and shared memory
    # (the build's ptxas report) and the CTAs an SM holds (the occupancy
    # calculator, with the launch's dynamic shared memory)
    occ = (ctypes.c_int * 4)()
    log = _build.BUILD_LOGS.get("flash_attention_bwd")
    for D, Dv in ((128, 128), (96, 64), (192, 128), (96, 96)):
        rc = _build.load("flash_attention_bwd").flash_bwd_ctas_per_sm(
            D, Dv, occ)
        if rc != 0:
            fail(f"flash_bwd_ctas_per_sm({D}, {Dv}): CUDA error {rc}")
        emit({"check": "flash_attention_bwd_resources", "D": D, "Dv": Dv,
              "threads_per_cta": 384, "ctas_per_sm": {"dkdv": occ[0],
                                                      "dq": occ[1]},
              "dynamic_smem_bytes": {"dkdv": occ[2], "dq": occ[3]},
              "ptxas": ({fn: {k: r[k] for k in ("registers", "smem",
                                                "spill_bytes")}
                         for fn, r in _ptxas_entries(log).items()
                         if f"ILi{D}ELi{Dv}E" in fn}
                        if log else "not measured (library reused)")})
    # B6's forward instance at (96, 96): registers, spills, shared memory
    flog = _build.BUILD_LOGS.get("flash_attention")
    emit({"check": "flash_attention_resources", "D": 96, "Dv": 96,
          "ptxas": ({fn: {k: r[k] for k in ("registers", "smem",
                                            "spill_bytes")}
                     for fn, r in _ptxas_entries(flog).items()
                     if "flash_kernelILi96ELi96E" in fn}
                    if flog else "not measured (library reused)")})
    for label, (B, H, Hkv, S, D, Dv) in FLASH_BWD_TIMING:
        q, k, v, dO = _flash_inputs(torch, B, H, Hkv, S, D, Dv, "float32",
                                    with_do=True)
        o, lse = fa_kern.flash_attention_lse(q, k, v)
        reps = 10 if "long" in label else 50
        kern = lambda: fa_kern.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, dO)
        # q, dq, k, dk (D wide); o, dO, v, dv (Dv wide); the log-sum-exp
        nbytes = 4 * (2 * B * H * S * (D + Dv) + 2 * B * Hkv * S * (D + Dv)
                      + B * H * S)
        # s = q·kᵀ, dq, dk over D; dp = dO·vᵀ, dv over Dv
        ops = 2 * (3 * D + 2 * Dv) * B * H * _visible_pairs(S, S, 0)
        bound_ms, bound_by = _tc_bound(nbytes, ops)
        kx, vx = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        sdpa = lambda a, b, c: F.scaled_dot_product_attention(  # noqa: E731
            a, b, c, is_causal=True)
        sdpa_ins = [t.contiguous() for t in (q, kx, vx)]
        ms = [_time_ms(torch, kern, reps)]
        lib = [_backward_ms(torch, sdpa, sdpa_ins, dO.contiguous(), reps)]
        lib.append(_backward_ms(torch, sdpa, sdpa_ins, dO.contiguous(),
                                reps))
        ms.append(_time_ms(torch, kern, reps))
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in sdpa_ins]
        o_lib = sdpa(*leaves)
        records = {}
        res = {"shape": [B, H, Hkv, S, D] + ([Dv] if Dv != D else []),
               "ms": min(ms), "ms_runs": ms,
               "device_ms": _kernel_device_ms(
                   torch, kern, reps, (("flash_bwd_dot",),
                                       ("flash_bwd_dkdv",),
                                       ("flash_bwd_dq",)), 1, records),
               "device_records": records, "reps": reps,
               "plain_ms": _backward_ms(
                   torch, ref.flash_attention_ref, (q, k, v), dO,
                   max(2, reps // 5)),
               "library_ms": min(lib), "library_ms_runs": lib,
               "library_backend": _sdpa_backend(
                   torch, lambda: torch.autograd.grad(
                       o_lib, leaves, dO.contiguous(), retain_graph=True)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "fp32_bound_ms": _bound(nbytes, ops)[0],
               "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
        out[f"flash_attention_bwd/{label}"] = res
        emit({"timing": "flash_attention_bwd", **res,
              "library_call": "backward of F.scaled_dot_product_attention("
                              "is_causal=True), float32, kv heads repeated"})
        del q, k, v, dO, o, lse, kx, vx, sdpa_ins, leaves, o_lib
    emit({"check": "wkv6_seq_bwd_resources",
          **{f"K={K}": wkv_kern.bwd_resources(K) for K in (32, 64)},
          "ptxas": ({fn: {k: r[k] for k in ("registers", "smem",
                                            "spill_bytes")}
                     for fn, r in _ptxas_entries(
                         _build.BUILD_LOGS["wkv6_bwd"]).items()}
                    if "wkv6_bwd" in _build.BUILD_LOGS
                    else "not measured (library reused)")})
    for label, (B, S, H, K) in WKV_BWD_TIMING:
        Q = 64
        ins, kern = _wkv_bwd_call(torch, wkv_kern, B, S, H, K, Q)
        reps = 10 if label == "long" else 50
        C = -(-S // Q)
        nbytes = 4 * (9 * B * S * H * K + B * H * C * K * K
                      + B * H * K * K + H * K + B * H * K)
        ops = 0
        for c0 in range(0, S, Q):
            Qc = min(Q, S - c0)
            tri = Qc * (Qc - 1) // 2
            ops += B * H * (5 * 2 * tri * K + 4 * 2 * Qc * K * K)
        bound_ms, bound_by = _tc_bound(nbytes, ops)
        design = _wkv_bwd_design_bytes(B, S, H, K, Q)
        records = {}
        res = {"shape": [B, S, H, K], "chunk": Q,
               "ms": _time_ms(torch, kern, reps),
               "device_ms": _kernel_device_ms(torch, kern, reps,
                                              WKV_BWD_PARTS, 1, records),
               "device_ms_by_kernel": {
                   parts[0]: _kernel_device_ms(torch, kern, reps, (parts,), 1)
                   for parts in WKV_BWD_PARTS},
               "device_records": records, "reps": reps,
               "plain_ms": _backward_ms(
                   torch, lambda *x: ref.wkv6_seq_plain(*x, Q), ins[:6],
                   (ins[6], None), max(2, reps // 5)),
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by, "fp32_bound_ms": _bound(nbytes, ops)[0],
               "design_mbytes": design / 1e6,
               "design_bytes_ms": design / HBM_BYTES_PER_S * 1e3,
               "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
        out[f"wkv6_seq_bwd/{label}"] = res
        emit({"timing": "wkv6_seq_bwd", **res, "library_call": "none",
              "per": "one layer call (four kernels)"})
        del ins, kern
        torch.cuda.empty_cache()
    return out


def _wkv_bwd_call(torch, wkv_kern, B, S, H, K, Q):
    """Inputs of one layer's B7 backward at [B, S, H, K] (w in (e^-1, 1),
    chunk states from the training forward) and the wrapper call on them:
    (r, k, v, w, u, S0, dy), fn."""
    r, k, v, w, u, S0 = _wkv_inputs(torch, B, H, S, K, 1.0)
    r, k, v, w = (x.transpose(1, 2).contiguous() for x in (r, k, v, w))
    g = torch.Generator(device="cuda").manual_seed(S + K)
    dy = torch.randn(B, S, H, K, generator=g, device="cuda")
    states = wkv_kern.chunk_states(r, Q)
    wkv_kern.wkv6_seq(r, k, v, w, u, S0, Q, states)
    return (r, k, v, w, u, S0, dy), lambda: wkv_kern.wkv6_seq_bwd(
        r, k, v, w, u, states, dy, None, Q)


def _wkv_bwd_design_bytes(B, S, H, K, Q) -> int:
    """Bytes B7's backward kernels move at [B, S, H, K]: the carry terms
    (r, w, dy in; the scratch and e^{max(cl, -80)} out), the scan (the
    scratch in and out, dS_in), the chunk pass (r, k, v, w, dy, the chunk
    states and dS_out in; dr, dk, dv, dw and du's partials out; its re-reads
    of r, k, w from L2 not counted) and du's sum."""
    N, C = B * S * H * K, -(-S // Q)
    P, E = B * H * C * K * K, B * H * C * K
    carry = 3 * N + P + E
    scan = 2 * P + E + B * H * K * K
    chunk = 5 * N + 2 * P + 4 * N + E
    return 4 * (carry + scan + chunk + E + H * K)


def _raw_launchers(torch, G, sl, pr, w, k):
    """Each kernel's bare launch through the C interface, on buffers
    allocated once: the kernel's own time, without the wrapper's checks,
    allocations and partial sums."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import brsgd_stats as kern
    from repro_torch.kernels import ref
    lib = _build.load()
    m, d = G.shape
    nb = max(1, min(-(-d // lib.brsgd_threads()), lib.brsgd_max_blocks()))
    col = {"fused_stats": kern.column_launch_plan(G, 3),
           "brsgd_stats": kern.column_launch_plan(G, kern.B4_VARIANT),
           "cwise_median": kern.column_launch_plan(G, kern.COLUMN_OUT),
           "trimmed_mean": kern.column_launch_plan(G, kern.TRIM_OUT)}
    f32 = {"dtype": torch.float32, "device": G.device}
    sc, l1 = (torch.empty((max(nb, col["fused_stats"].grid,
                                col["brsgd_stats"].grid), m), **f32)
              for _ in range(2))
    gram = torch.empty((nb, m, m), **f32)
    med, mean, out = (torch.empty(d, **f32) for _ in range(3))
    w_out = torch.empty(m, **f32)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def P(t):
        return ctypes.c_void_p(t.data_ptr())

    def check(rc):
        if rc != 0:
            fail(f"bare kernel launch returned CUDA error {rc}")

    # the fused launch on its plan, or on another grid (None where the
    # card cannot hold that grid at once)
    plan = kern.launch_plan(G)
    k_idx, q_idx = ref.brsgd_rank_indices(m, 0.5)
    small = torch.empty(3 * m + 2 + m, **f32)

    def select_at(rule):
        plan = kern.launch_plan(G, rule)
        args = dict(_select_cases(m))[rule]
        if rule == "geomedian":
            ia, ib, fa = args["iters"] - 1, 0, args["eps"]
        else:
            ia, ib, fa = args["n_close"], args.get("k", 0), 0.0
        parts = torch.empty(kern.partials_floats(m, rule, plan.grid), **f32)
        sm = torch.empty(2 * m + m * m + m, **f32)
        return lambda: check(lib.brsgd_select_aggregate(
            P(G), m, d, kern.RULE_IDS[rule], ia, ib, fa, int(plan.resident),
            P(parts), P(sm), P(out), plan.grid, stream))

    def fused_at(grid, resident):
        smem = kern.aggregate_smem(m, d, grid, resident)
        n = ctypes.c_int(0)
        check(lib.brsgd_select_aggregate_coresident(
            m, kern.RULE_IDS["brsgd"], smem, ctypes.byref(n)))
        if (grid > n.value or smem > kern.SMEM_BLOCK_LIMIT
                - kern.AGG_STATIC_SMEM or grid > -(-d // kern.THREADS)):
            return None
        parts = torch.empty(kern.partials_floats(m, "brsgd", grid), **f32)
        return lambda: check(lib.brsgd_select_aggregate(
            P(G), m, d, kern.RULE_IDS["brsgd"], k_idx, q_idx, 0.0,
            int(resident), P(parts), P(small), P(out), grid, stream))

    return {
        "fused_stats": lambda: check(lib.brsgd_fused_stats(
            P(G), m, d, 3, P(sc), P(l1), None, None, col["fused_stats"].grid,
            col["fused_stats"].stages, stream)),
        "fused_stats[gram]": lambda: check(lib.brsgd_fused_stats(
            P(G), m, d, 8, None, None, None, P(gram), nb, 0, stream)),
        "select_mean": lambda: check(lib.brsgd_select_mean(
            P(G), m, d, P(sl), P(pr), P(out), P(w_out), nb, stream)),
        "masked_mean": lambda: check(lib.brsgd_masked_mean(
            P(G), m, d, P(w), P(out), None, nb, stream)),
        "brsgd_stats": lambda: check(lib.brsgd_column_stats(
            P(G), m, d, P(med), P(mean), P(sc), P(l1),
            col["brsgd_stats"].grid, col["brsgd_stats"].stages, stream)),
        "cwise_median": lambda: check(lib.brsgd_cwise_median(
            P(G), m, d, P(med), col["cwise_median"].grid,
            col["cwise_median"].stages, stream)),
        "trimmed_mean": lambda: check(lib.brsgd_trimmed_mean(
            P(G), m, d, k, P(out), col["trimmed_mean"].grid,
            col["trimmed_mean"].stages, stream)),
        "brsgd_aggregate": fused_at(plan.grid, plan.resident),
        "brsgd_aggregate@": fused_at,
        **{f"select_aggregate[{rule}]": select_at(rule)
           for rule in GRAM_RULES},
    }


def ops_select_plain(ref, G, st, kth, T):
    sel, _, _ = ref.brsgd_masks(st["scores"], st["l1"], kth, T)
    w = sel.float()
    return ref.masked_mean_det(G, w), w


# ---------------------------------------------------------------------------

def _kernel_fns(torch, kern, ref, G) -> dict:
    """{timing row: one wrapper call} of every BrSGD kernel on G."""
    m = G.shape[0]
    ones = torch.ones(m, device="cuda")
    sc, l1 = kern.brsgd_partials(G)
    kth, T = ref.brsgd_thresholds(sc, l1, 0.5, 0.0)
    fns = {"fused_stats": lambda: kern.fused_stats(G, ("scores", "l1")),
           "brsgd_stats": lambda: kern.brsgd_stats(G),
           "cwise_median": lambda: kern.cwise_median(G),
           "fused_stats[gram]": lambda: kern.fused_stats(G, ("gram",)),
           "masked_mean": lambda: kern.masked_mean(G, ones),
           "select_mean": lambda: kern.select_mean(G, sc, l1, kth, T),
           "trimmed_mean": lambda: kern.trimmed_mean(G, 0.1),
           "brsgd_aggregate": lambda: kern.brsgd_aggregate(G, 0.5, 0.0)}
    if hasattr(kern, "select_aggregate"):
        for rule, args in _select_cases(m):
            fns[f"select_aggregate[{rule}]"] = (
                lambda rule=rule, args=args: kern.select_aggregate(
                    G, rule, **args))
    return fns


# three bucket instances beside their tuned neighbours, at the two timing
# widths
BUCKET_TIMING_M = (10, 12, 16, 32, 33, 63, 64)


def phase_bucket_timing(torch, kern, ref) -> dict:
    """Each BrSGD kernel's device time (torch.profiler) on the bucket
    instances of m = 12, 33 and 63 and on the tuned m = 10, 16, 32 and 64, at
    d = 61706 and 8388608; one line per shape.  Returns {kernel row:
    {"m,d": ms}}."""
    out = {}
    for d in (MAIN_SHAPE[1], HBM_SHAPE[1]):
        for m in BUCKET_TIMING_M:
            # drawn on the card: [64, 8388608] from numpy took seconds
            G = torch.randn(m, d, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(7))
            reps = 200 if d == MAIN_SHAPE[1] else 10
            row = {}
            for name, fn in _kernel_fns(torch, kern, ref, G).items():
                row[name] = _kernel_device_ms(torch, fn, reps,
                                              (KERNEL_NAMES[name],))
                out.setdefault(name, {})[f"{m},{d}"] = row[name]
            emit({"timing": "worker_counts", "shape": [m, d],
                  "instance": (f"tuned {m}" if m in kern.TUNED_M else
                               f"bucket {kern.instance_rows(m)}"),
                  "reps": reps, "device_ms": row})
            del G
            torch.cuda.empty_cache()
    return out


def kernel_times(torch, src: Path, shapes=()) -> int:
    """``--kernel-times SRC [M,D ...]``: the kernels of the repro_torch
    package under SRC (this tree's src, or another tree's, such as a
    parent commit's unpacked beside it) timed through their wrappers at
    MAIN_SHAPE and HBM_SHAPE, or at the shapes given: device ms by
    torch.profiler and CUDA-event ms over the same calls; without shapes,
    B7's backward too at WKV_BWD_TIMING's shapes.  One JSON line
    per kernel and shape.  Run it for two trees in turns (parent, change,
    change, parent) to compare kernels on one card; it checks nothing and
    prints no kernels line."""
    import numpy as np
    sys.path.insert(0, str(src))
    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import brsgd_stats as kern
    from repro_torch.kernels import ref
    resolve_device("cuda")
    _build.build_all()
    bwd = not shapes
    shapes = shapes or (MAIN_SHAPE, HBM_SHAPE)
    if bwd:
        from repro_torch.kernels import wkv6 as wkv_kern
        text = (src / "repro_torch/kernels/csrc/wkv6_bwd.cu").read_text()
        parts = (WKV_BWD_PARTS if "wkv6_bwd_chunk_kernel" in text
                 else WKV_BWD_PARTS_BEFORE)
        for label, (B, S, H, K) in WKV_BWD_TIMING:
            reps = 10 if label == "long" else 50
            _, fn = _wkv_bwd_call(torch, wkv_kern, B, S, H, K, 64)
            emit({"kernel_times": "wkv6_seq_bwd", "src": str(src),
                  "shape": [B, S, H, K], "chunk": 64,
                  "device_ms": _kernel_device_ms(torch, fn, reps, parts),
                  "events_ms": _time_ms(torch, fn, reps)})
            del fn
            torch.cuda.empty_cache()
    for m, d in shapes:
        reps = 200 if m * d <= MAIN_SHAPE[0] * MAIN_SHAPE[1] else 20
        G = torch.as_tensor(np.random.default_rng(7).standard_normal(
            (m, d), dtype=np.float32), device="cuda")
        for name, fn in _kernel_fns(torch, kern, ref, G).items():
            emit({"kernel_times": name, "src": str(src), "shape": [m, d],
                  "device_ms": _kernel_device_ms(torch, fn, reps,
                                                 (KERNEL_NAMES[name],)),
                  "events_ms": _time_ms(torch, fn, reps)})
        del G
        torch.cuda.empty_cache()
    return 0


def _instance_rows(timed_rows, name) -> dict:
    """The MLA instances' timing rows of B6 / B6-bwd, by instance and
    label."""
    keys = ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "fp32_bound_ms", "library_ms", "library_backend")
    return {inst: {label: {k: r[k] for k in keys if k in r}
                   for label, r in (
                       (key.split("/", 1)[1], r)
                       for key, r in timed_rows.items()
                       if key.startswith(f"{name}/{prefix}"))}
            for inst, prefix in INSTANCE_LABELS.items()}


def main() -> int:
    import torch
    smi_line = phase_device(torch)
    if len(sys.argv) >= 3 and sys.argv[1] == "--kernel-times":
        print(smi_line, flush=True)
        shapes = [tuple(int(x) for x in a.split(",")) for a in sys.argv[3:]]
        return kernel_times(torch, Path(sys.argv[2]).resolve(), shapes)
    sys.path.insert(0, str(SRC))
    from repro_torch import resolve_device
    from repro_torch.kernels import brsgd_stats as kern
    from repro_torch.kernels import ref
    resolve_device("cuda")                 # TF32 off for the whole run
    phase_s = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        emit({"phase": name, "seconds": phase_s[name]})
        return out
    # every nvcc starts at once; the phases that launch only B6, B7 and
    # their backward kernels, and no torch.profiler session, run while the
    # BrSGD libraries compile (every library is loaded before the first
    # profiler session: see phase_serve_profile)
    t_build = time.perf_counter()
    builds = phase_build_start()
    timed("build_sequence_libs", phase_build_wait, builds, SEQ_LIBS)
    worst = timed("seq_kernels", phase_seq_kernels, torch, ref)
    worst.update(timed("bwd_kernels", phase_bwd_kernels, torch, ref))
    serve_res, serve_launches, per_prefill = timed("serve", phase_serve,
                                                   torch)
    zoo = timed("zoo_serve", phase_zoo_serve, torch, ref, worst)
    hf = timed("hybrid_serve", phase_hybrid_serve, torch, ref, worst)
    timed("build", phase_build, builds, t_build)
    worst.update(timed("kernels", phase_kernels, torch, kern, ref))
    timed("loop", phase_loop, torch, kern, ref)
    agg_t = timed("aggregation", phase_aggregation, torch, kern, ref)
    launches = timed("main_path", phase_main_path, torch, kern)
    elastic_launches = timed("elastic", phase_elastic, torch, kern)
    timed("serve_profile", phase_serve_profile, torch, serve_res)
    loop_res, loop_launches, per_admission = timed(
        "serve_loop", phase_serve_loop, torch, ref, worst)
    grad_res, grad_launches = timed("grad", phase_grad, torch)
    train_res, train_launches = timed("train", phase_train, torch)
    blocked_res, blocked_launches = timed(
        "blocked", phase_blocked, torch, train_res[0]["peak_device_gb"])
    sharded_res, sharded_launches = timed("sharded", phase_sharded, torch)
    zoo = timed("zoo_train", phase_zoo_train, torch, zoo)
    hf = timed("hybrid_train", phase_hybrid_train, torch, hf)
    demos = timed("demos", phase_demos, torch)
    main_t = timed("timing_main", phase_timing, torch, kern, ref, MAIN_SHAPE,
                   reps=200, plain_reps=20, worst=worst)
    bucket_t = timed("timing_buckets", phase_bucket_timing, torch, kern, ref)
    hbm_t = timed("timing_hbm", phase_timing, torch, kern, ref, HBM_SHAPE,
                  reps=20, plain_reps=3, worst=worst)
    seq_t = timed("seq_timing", phase_seq_timing, torch, ref)
    bwd_t = timed("bwd_timing", phase_bwd_timing, torch, ref)
    kernels = []
    for name in REPLACES:
        # the fused select launch's headline numbers are krum's; every
        # rule's stand under "rules"
        key = "select_aggregate[krum]" if name == "select_aggregate" else name
        t, h = main_t[key], hbm_t[key]
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "elastic_launches": elastic_launches[name],
               "max_abs_err": worst[name], "ms": t["kernel_ms"],
               "device_ms": t["device_ms"],
               "wrapper_ms": t["wrapper_ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "library_call": LIBRARY_CALLS[name],
               "shape": list(MAIN_SHAPE), "hbm_shape": list(HBM_SHAPE),
               "hbm_ms": h["kernel_ms"], "hbm_device_ms": h["device_ms"],
               "hbm_wrapper_ms": h["wrapper_ms"],
               "hbm_bound_ms": h["bound_ms"], "hbm_plain_ms": h["plain_ms"],
               "hbm_library_ms": h["library_ms"],
               "worker_counts_device_ms": bucket_t[key],
               "train_launches": train_launches.get(name, 0),
               "blocked_launches": blocked_launches.get(name, 0),
               "sharded_launches": sharded_launches.get(name, 0)}
        if name == "brsgd_aggregate":
            row.update(also_replaces=ALSO_REPLACES[name],
                       grid=t["grid"], resident=t["resident"],
                       hbm_grid=h["grid"], hbm_resident=h["resident"],
                       two_pass_ms=t["two_pass_ms"],
                       two_pass_kernels_ms=t["two_pass_kernels_ms"],
                       hbm_two_pass_ms=h["two_pass_ms"],
                       hbm_two_pass_kernels_ms=h["two_pass_kernels_ms"],
                       device_kernels_per_aggregate_local={
                           k: v["per_call"] for k, v in
                           agg_t["brsgd"]["device_kernels_per_call"].items()})
        if name == "select_aggregate":
            row.update(also_replaces=ALSO_REPLACES[name], ms_rule="krum",
                       rules={rule: {
                           "ms": main_t[f"select_aggregate[{rule}]"]
                           ["kernel_ms"],
                           "device_ms": main_t[f"select_aggregate[{rule}]"]
                           ["device_ms"],
                           "hbm_device_ms": hbm_t[f"select_aggregate[{rule}]"]
                           ["device_ms"],
                           "plain_ms": main_t[f"select_aggregate[{rule}]"]
                           ["plain_ms"],
                           "bound_ms": main_t[f"select_aggregate[{rule}]"]
                           ["bound_ms"],
                           "hbm_ms": hbm_t[f"select_aggregate[{rule}]"]
                           ["kernel_ms"],
                           "hbm_bound_ms": hbm_t[f"select_aggregate[{rule}]"]
                           ["bound_ms"],
                           "hbm_plain_ms": hbm_t[f"select_aggregate[{rule}]"]
                           ["plain_ms"],
                           "device_kernels_per_aggregate_local": {
                               k: v["per_call"] for k, v in agg_t[rule]
                               ["device_kernels_per_call"].items()}}
                           for rule in GRAM_RULES})
        if name == "cwise_median":
            row.update(grid=t["grid"], stages=t["stages"],
                       hbm_grid=h["grid"], hbm_stages=h["stages"],
                       device_kernels_per_median_aggregate_local={
                           k: v["per_call"] for k, v in
                           agg_t["median"]["device_kernels_per_call"].items()})
        if name == "trimmed_mean":
            row.update(grid=t["grid"], stages=t["stages"],
                       hbm_grid=h["grid"], hbm_stages=h["stages"],
                       device_kernels_per_trimmed_mean_aggregate_local=agg_t[
                           "trimmed_mean"]["device_kernels_per_call"]["fused"]
                       ["per_call"])
        if name == "masked_mean":
            row.update(device_kernels_per_mean_aggregate_local={
                k: v["per_call"] for k, v in
                agg_t["mean"]["device_kernels_per_call"].items()})
        if name == "fused_stats":
            g, hg = main_t["fused_stats[gram]"], hbm_t["fused_stats[gram]"]
            row.update(gram_ms=g["kernel_ms"], gram_device_ms=g["device_ms"],
                       hbm_gram_device_ms=hg["device_ms"],
                       gram_library_ms=g["library_ms"],
                       gram_bound_ms=g["bound_ms"],
                       hbm_gram_ms=hg["kernel_ms"],
                       hbm_gram_library_ms=hg["library_ms"])
        kernels.append(row)
    for name, (source, replaces) in SEQ_KERNELS.items():
        t = seq_t[f"{name}/serve"]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": serve_launches[name],
               "launches_per_prefill": per_prefill[name],
               "serve_loop_launches": loop_launches[name],
               "serve_loop_launches_per_admission": per_admission[name],
               "train_launches": train_launches.get(name, 0),
               "blocked_launches": blocked_launches.get(name, 0),
               "sharded_launches": sharded_launches.get(name, 0),
               "max_abs_err": worst[name], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "library_call": ("F.scaled_dot_product_attention"
                                if name == "flash_attention" else "none"),
               "shape": t["shape"]}
        if name == "flash_attention":
            lt = seq_t["flash_attention/long"]
            row.update(fp32_bound_ms=t["fp32_bound_ms"],
                       long_shape=lt["shape"], long_ms=lt["ms"],
                       long_plain_ms=lt["plain_ms"],
                       long_bound_ms=lt["bound_ms"],
                       long_fp32_bound_ms=lt["fp32_bound_ms"],
                       long_library_ms=lt["library_ms"],
                       zoo_launches=zoo["launches"].get(name, 0),
                       zoo_launches_per_prefill={
                           a: p.get(name) for a, p in
                           zoo["per_prefill"].items()},
                       zoo_serve_loop_launches_per_admission=zoo[
                           "loop_per_admission"].get(name),
                       moe_serve_loop_launches_per_admission=zoo[
                           "loop_per_admission_moe"].get(name),
                       demo_train_100m_launches=demos["train_100m"]
                       ["launches"].get(name, 0),
                       hybrid_frontends_launches=hf["launches"].get(name, 0),
                       hybrid_frontends_launches_per_prefill={
                           a: p.get(name) for a, p in
                           hf["per_prefill"].items()},
                       zamba2_serve_loop_launches_per_admission=hf[
                           "loop_per_admission"].get(name),
                       instances=_instance_rows(seq_t, name))
        else:
            row.update(per="layer launch", chunk_ms=t["chunk_ms"],
                       chunk_plain_ms=t["chunk_plain_ms"],
                       chunk_bound_ms=t["chunk_bound_ms"])
        kernels.append(row)
    for name, (source, replaces) in BWD_KERNELS.items():
        t, lt = bwd_t[f"{name}/train"], bwd_t[f"{name}/long"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": grad_launches[name],
            "train_launches": train_launches.get(name, 0),
            "blocked_launches": blocked_launches.get(name, 0),
            "sharded_launches": sharded_launches.get(name, 0),
            "launches_per_gradient": {
                f"{r['arch']} [{r['batch']},{r['seq']}]"
                f"{' remat' if r['remat'] else ''}": r["launches"].get(name)
                for r in grad_res if name in r["launches"]},
            "max_abs_err": worst[name], "ms": lt["ms"],
            "device_ms": lt["device_ms"], "plain_ms": lt["plain_ms"],
            "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
            "fp32_bound_ms": lt["fp32_bound_ms"],
            "library_ms": lt["library_ms"],
            "library_call": ("backward of F.scaled_dot_product_attention"
                             if name == "flash_attention_bwd" else "none"),
            "library_backend": lt.get("library_backend"),
            "shape": lt["shape"], "train_shape": t["shape"],
            "train_ms": t["ms"], "train_device_ms": t["device_ms"],
            "train_plain_ms": t["plain_ms"], "train_bound_ms": t["bound_ms"],
            "train_library_ms": t["library_ms"],
            **({"zoo_train_launches": zoo["launches"].get(name, 0),
                "moe_gradient_launches": {
                    a: r["launches"].get(name)
                    for a, r in zoo["moe_gradient"].items()},
                "demo_train_100m_launches": demos["train_100m"]["launches"]
                .get(name, 0),
                "hybrid_frontends_launches": hf["launches"].get(name, 0),
                "hybrid_frontends_launches_per_gradient": {
                    f"{r['arch']} [{r['batch']},{r['seq']}]"
                    f"{' remat' if r['remat'] else ''}": r["launches"].get(
                        name) for r in hf["gradient"]},
                "zamba2_train_launches_per_step": hf["train"][
                    "launches_per_step"].get(name),
                "instances": _instance_rows(bwd_t, name)}
               if name == "flash_attention_bwd" else {}),
            **({"design_mbytes": lt["design_mbytes"],
                "design_bytes_ms": lt["design_bytes_ms"],
                "device_ms_by_kernel": lt["device_ms_by_kernel"],
                "train_k32": {k: bwd_t[f"{name}/train_k32"][k] for k in (
                    "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                    "design_bytes_ms")}}
               if name == "wkv6_seq_bwd" else {})})
    emit({"gradient": [{k: r[k] for k in (
        "arch", "batch", "seq", "remat", "host_ms", "peak_device_gb",
        "device_busy_ms", "device_ms_by_group", "launches")}
        for r in grad_res]})
    fixed, sup = train_res
    emit({"train": {"arch": fixed["arch"], "D": fixed["D"],
                    "workers": fixed["workers"],
                    "batch_per_worker": fixed["batch_per_worker"],
                    "seq": fixed["seq"], "host_ms": fixed["host_ms"],
                    "host_ms_runs": fixed["host_ms_runs"],
                    "split_ms": fixed["split_ms"],
                    "peak_device_gb": fixed["peak_device_gb"],
                    "launches_per_step": fixed["launches_per_step"],
                    "launches": train_launches,
                    "supervised": [{k: r[k] for k in (
                        "held", "step_ok", "n_active", "host_ms")}
                        for r in sup["rows"]],
                    "supervised_peak_device_gb": sup["peak_device_gb"]}})
    q, r = blocked_res["qwen3"], blocked_res["rwkv6"]
    emit({"blocked": {
        a: {k: x[k] for k in ("arch", "workers", "optimizer", "host_ms",
                              "host_ms_runs", "warmup_host_ms",
                              "peak_device_gb", "launches_per_step")}
        | {"n_selected": [s["n_selected"] for s in x["steps"]],
           "n_selected_min": [s["n_selected_min"] for s in x["steps"]]}
        for a, x in (("qwen3", q), ("rwkv6", r))}
        | {"global_scope_peak_device_gb": q["global_scope_peak_device_gb"],
           "card_vs_cpu": [{k: c[k] for k in (
               "arch", "rule", "n_layers", "n_selected", "loss_rel_err",
               "params_err_over_max_dp")} for c in blocked_res["card_vs_cpu"]],
           "supervised": [{k: x[k] for k in ("held", "step_ok", "n_active",
                                             "n_selected", "host_ms")}
                          for x in blocked_res["supervised"]["rows"]],
           "sub_seconds": blocked_res["sub_seconds"]}})
    emit({"zoo": {"serve": zoo["serve"],
                  "serve_loop": {k: zoo["serve_loop"][k] for k in (
                      "decode_tok_s", "step_ms_median", "tok_s", "requests",
                      "max_batch", "decode_graphs", "against_generate",
                      "peak_mem_gb")},
                  "moe_serve_loop": {k: zoo["moe_serve_loop"][k] for k in (
                      "arch", "n_layers", "capacity_factor", "decode_tok_s",
                      "step_ms_median", "tok_s", "requests", "max_batch",
                      "decode_graphs", "against_generate", "peak_mem_gb")},
                  "moe_gradient": zoo["moe_gradient"],
                  "train": {k: zoo["train"][k] for k in (
                      "arch", "D", "workers", "batch_per_worker", "seq",
                      "host_ms", "host_ms_runs", "split_ms",
                      "peak_device_gb", "launches_per_step")}},
          "demos": {k: v for k, v in demos.items()}})
    emit({"hybrid_frontends": {
        "serve": hf["serve"],
        "serve_loop": {k: hf["serve_loop"][k] for k in (
            "arch", "n_layers", "decode_tok_s", "step_ms_median", "tok_s",
            "requests", "max_batch", "decode_graphs", "against_generate",
            "peak_mem_gb")},
        "gradient": hf["gradient"],
        "train": {k: hf["train"][k] for k in (
            "arch", "D", "workers", "batch_per_worker", "seq", "optimizer",
            "host_ms", "host_ms_runs", "split_ms", "peak_device_gb",
            "launches_per_step")}}})
    emit({"phase_seconds": phase_s})
    emit({"sharded": {
        "backend": sharded_res["cases"][0]["backend"],
        "cases": [{k: c[k] for k in (
            "mesh", "argv_mesh", "layout", "entry", "workers", "host_ms",
            "host_ms_by_rank", "warmup_host_ms", "split_ms",
            "bytes_sent_per_rank", "peak_gb_by_rank", "card_used_gb",
            "collectives_per_step", "launches_per_step",
            "launches_all_steps_all_ranks", "check_launches", "check")}
            for c in sharded_res["cases"]],
        "card_vs_cpu": sharded_res["card_vs_cpu"],
        "sub_seconds": sharded_res["sub_seconds"]}})
    emit({"serve": {a: {k: r[k] for k in ("prefill_tok_s", "decode_tok_s",
                                          "prefill_s", "decode_s",
                                          "n_layers", "batch", "prompt_len",
                                          "gen", "repeat")}
                    for a, r in serve_res.items()},
          "serve_loop": {a: {k: loop_res[a][k] for k in (
              "decode_tok_s", "full_batch_tok_s", "step_ms_median",
              "decode_step_device_ms", "decode_bound_ms",
              "busy_share_event_ms",
              "busy_share_profiler_ms", "tok_s", "requests", "max_batch",
              "decode_graphs", "prefill_shapes", "equal_to_solo_loop",
              "against_generate")}
              for a in SERVE_LOOP_ARGS}})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
