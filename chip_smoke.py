#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one H100

Phases, each fatal on failure:
  1. build every CUDA kernel from the sources in the checkout (nvcc, one
     process per source, all started together) and print ptxas' report
     (registers, spills: the tensor-core tile kernels, int8 and fp16
     included, the float32 tile kernel, the float32 flash kernel, the four
     top-k selects and the two merge instantiations may not spill), and
     check that the SIMT tile library exports no bf16 / fp16 / fp8 / int8
     entry point;
  2. hold each kernel against its plain PyTorch version on the card, at
     small ragged shapes and at the main path's full shape;
  3. drive the main path, corr(x) at the paper's Table II shape (SEEK
     GPL570: n = 17,555 variables x l = 5,072 samples; artificial uniform
     data from seed 0, which the paper shows times like the real values),
     count the kernel's launches, and check the result: exact symmetry,
     64 sampled rows against float64, and bit-identity across pass splits;
  4. time the kernel, its bound, its plain version, one PyTorch library
     call for the same product, and corr end to end (CUDA events / host
     clock after torch.cuda.synchronize());
  5. the top-k kernel (select + merge) and the tile kernel's rectangular
     grid against their plain versions at small ragged shapes: values
     within tolerance, columns equal except at printed near-ties, and the
     top-k values bitwise those of pcc_tiles;
  6. symmetric top-k, corr(x, sink=DeviceTopKSink(10)) at the Table II
     shape: launch counts (the CUDA kernels, never a plain version),
     bit-identity with TopKSink(10) fed by pcc_tiles (one pass and
     300-tile passes), time, peak memory, host merge time per pass;
  7. symmetric top-k at Table I's largest shape (n = 64,000, l = 5,000,
     k = 10), once, with 16 sampled rows against a float64 top-k and the
     kernels against their plain version on the whole pass;
  8. rectangular X-vs-Y: 1,639 rows (the human transcription factors of
     Lambert et al., Cell 2018) against the 17,555 Table II rows, dense
     corr(x, y) (16 rows against float64) and DeviceTopKSink(10)
     (bit-identical to TopKSink(10)), launch counts, times, peak memory;
  9. hold the top-k kernels against their plain version on the passes the
     driven paths launch (Table II one pass and 300-tile passes, the
     rectangular grid; phase 7 does the same for its n = 64,000 pass) and
     the merge kernel alone bitwise against topk_merge_plain on the select
     kernel's scratch (Table II one pass, the grid), then time them
     (select, merge, both), their plain version and a library yardstick at
     the Table II shape, the merge and torch.topk of its scratch at the
     grid shape, and the grid mode of pcc_tiles at the rectangular shape,
     each with its bound;
 10. the bf16, fp16 and int8 operand modes of both kernels at phase 2's
     shapes, triangle and grid: bf16 and fp16 tiles (the tensor-core
     kernel) within the narrow gate of the plain version
     (kernels/narrow_gate.py),
     which refuses two planted faults (a 128-sample chunk of U zeroed, or
     counted twice) by at least 10x, int8 tiles (Kendall pair signs) and
     int8 top-k states bitwise the plain version's, top-k values bitwise
     pcc_tiles';
 11. Spearman at Table II: dense corr (launches, exact symmetry, 16 rows
     against float64 ranks then Pearson) and DeviceTopKSink(10),
     bit-identical to TopKSink(10); times, and the rank transform alone;
 12. bf16 Pearson at Table II, dense and DeviceTopKSink(10): the bf16
     kernels' launches, 16 rows against float64 within the reference's bf16
     bound, top-k bit-identical to TopKSink(10); times, peak memory; then
     its fp16 twin (the fp16 kernels' launches, 16 rows against float64
     within 2^-10 + 1e-5, argued from fp16's unit roundoff 2^-11);
 13. int8 Kendall tau-a over the 17,555 Table II genes and their first 64
     samples (below the reference's 96-sample merge crossover): the int8
     kernels' launches, bitwise the float32 sign-GEMM and the int16 run
     (compute_dtype=torch.int16, whose signs run the int8 kernel), 16 rows
     against a float64 direct count, top-k bit-identical to TopKSink(10);
     times;
 14. the bf16, fp16 and int8 kernels at those shapes against their plain
     versions (bf16 and fp16 within the narrow gate, the planted faults
     refused), timed with their bounds (989 TFLOP/s bf16 and fp16, 1,979
     TOP/s int8) and a library yardstick each (torch.matmul in the operand
     type, torch._int_mm);
 15. the scaled (int8, fp8 e4m3 and e5m2) and triangle second-operand modes
     of pcc_tiles at phase 2's shapes, triangle and grid: scaled int8 tiles
     bitwise the plain version's, fp8 tiles within the narrow gate of it
     (the planted faults refused), triangle tiles with a second operand
     bitwise the grid tiles at the same (y, x);
 16. masked Pearson at Table II (5 % of x missing at random, seed 2):
     corr(x, where="nan") with its six component launches per pass, exact
     symmetry, 16 rows against a float64 pairwise-complete Pearson, the same
     bits with 300-tile passes, TopKSink(10) (DeviceTopKSink refuses),
     times and peak memory; the 1,639 x 17,555 scan with where=(None,
     None); the triangle second-operand mode timed with its bound, plain
     version and library yardstick;
 17. int8- and fp8 (e4m3)-quantized Pearson at Table II: launches per dtype
     and with scales, 16 rows against float64 within the reference's
     budgets, TopKSink(10) (DeviceTopKSink refuses), times, peak memory;
     e5m2-quantized dense Pearson once (launches, 16 rows within the fp8
     budget); the scaled kernel modes (int8, e4m3, e5m2) at that shape
     against their plain versions (fp8 within the narrow gate, the planted
     faults refused), timed with their bounds and a library yardstick
     each;
 18. significance through the replica axis of pcc_tiles: the replica mode
     at phase 2's shapes for every operand type (each replica bitwise the
     2-D kernel's tiles; float32 within tolerance of plain, int8 and scaled
     int8 bitwise plain, bf16 / fp8 within the narrow gate of plain); the
     headline, corr(x_tf, pvalues=PermutationSpec(
     1000, key=0)) over phase 8's 1,639 TF rows (paper SSIV: >= 1,000
     permutations): launch counts (B replicas per pass, only through the
     kernel), r bitwise corr(x_tf), p exactly symmetric with 1/(B+1) on the
     diagonal, 8 rows' counts against float64 replicas except at printed
     near-ties, p bitwise at chunk 37 and at 5-tile passes (B = 200); the
     replica kernel alone against its plain version and 2-D launches,
     timed with its bound and a library yardstick, corr end to end and its
     peak memory; the headline again in bf16 and fp8 e4m3 (launches, r
     bitwise corr(x_tf, compute_dtype)) and their replica modes on one
     chunk (64 replicas x 28 tiles) within the narrow gate of plain, timed
     with bound, plain version and library call; then Table II at B = 8
     (the replica mode at the main
     path's full shape), TF x Table II at B = 32 with chunk 16 (the grid's
     replica mode) and the int8-quantized headline at B = 200;
 19. flash attention (kernels/ops.flash_mha): the kernels against their
     plain version at small shapes (float32, the SIMT kernel, within 2e-6;
     bf16 and fp16, the tensor-core kernel, within a gate scaled to each
     output row and never above the reference's atol = rtol = 3e-2; the
     windows the reference kernel drops also against mha_plain), then one
     layer at the head shapes of llama-3.2-3B (S = 4,096 and 32,768,
     causal) and of hymba-1.5B's sliding-window layers (S = 32,768, window
     1,024), float32 and bf16, and fp16 at S = 4,096: flash_mha's launches
     by dtype, every row against the plain version, rows against float64
     mha_plain (all at 4,096, the first and last 512 at 32,768), float32
     within 1e-5, bf16 / fp16 within the row-scaled gate, which must also
     fail the kernel's output with its rows past 3S/4 halved and with one
     key block of v zeroed; each kernel timed with its bound, TFLOP/s
     and share of the bound of its pipes (FP32 for float32, bf16 for bf16
     / fp16), its plain version and scaled_dot_product_attention, in one
     run on one card;
 20. multi-pass top-k at Table II (300-tile passes): DeviceTopKSink(10) and
     TopKSink(10) end to end against the sum and the larger of their
     kernels' and their sinks' times.  With --overlap-only SRC the script
     runs the build and this phase alone on the package under SRC (another
     tree of this repository), for a before / after comparison;
 21. the checkpointed host output at Table II in 300-tile passes (9):
     corr(x, sink=HostSink(path=...)) into a 1.23 GB np.memmap in a
     temporary directory (deleted after): pcc_tiles launches (9, float32),
     the result bitwise DenseSink's .cpu() and exactly symmetric, its time
     against HostSink() without a file and DenseSink plus .cpu(), and per
     pass the host's copy wait, tile write and commit beside the kernels';
     a run stopped once pass 4 is committed, then corr(x,
     resume_from=path): exactly 4 more launches (passes 5-8) and the same
     bits; bytes flipped inside pass 2's committed tiles, then a resume:
     the schedule reruns pass 2 alone (one launch) and the bits come back;
 22. streaming reductions and the transform cache at Table II, every check
     exact: EdgeCountSink(0.05, labels from seed 3, 10 groups) in one pass
     and in 300-tile passes (9), its edges, degrees and intra-group edges
     equal to the counts taken on the card from DenseSink's matrix
     (diagonal excluded), time and peak memory beside DenseSink's; a
     ReductionSink row max of |r| (host numpy callback, 9 passes) bitwise
     the row max of DenseSink's off-diagonal |r|; RowBlockSink over phase
     8's TF rows against the Table II rows, ranges [0, 500), [500, 1,100)
     and [1,100, 1,639), each bitwise DenseSink's cross rows;
     assemble_from_stream over stream_tiles(x, max_tiles_per_pass=300)
     bitwise DenseSink's .cpu(); Spearman corr twice on one card tensor
     (a cache miss, then a hit with the same bits) and after an in-place
     change (a miss, the bits of an uncached run); each run's float32
     pcc_tiles launches counted, no plain version; times;
 23. merge-sort Kendall at the paper's sample count (kendall_merge_tiles,
     csrc/kendall_merge.cu): the kernel bitwise its plain version at phase
     2's shapes (l in 96 / 97 / 130 / 257; normal and floor(8 u) rows with
     a constant row, a run of l - 1 and padding rows; triangle and grid;
     tau-a and tau-b) and on three full-width tiles of the TF triangle at
     l = 5,072 (the first, a diagonal, the last) and one of floor(8 u)
     rows (seed 4) in tau-b; then corr over phase 8's 1,639 TF rows in
     tau-a, tau-b, tau-b of the floor(8 u) rows, TopKSink(10) (the dense
     result's canonical top-k) and 5-tile passes (the same bits), and TF
     x Table II (483 grid tiles): merge launches counted, no pcc kernel
     and no plain version, exact symmetry, 8 rows x 64 columns against a
     float64 direct count (tau-a) or scipy (tau-b) within 1e-6; the Table
     II triangle once if the grid run extrapolates to under 60 s; the
     crossover of the float32 and int8 sign-GEMMs and the merge path over
     the TF rows at l in 64 / 96 / 128 / 256 / 512 / 1,024; the kernel's
     time at the TF triangle against its bound (l_p2 log2 l_p2 compares a
     pair merge at 64 x 132 lanes x the SM clock, or bytes at 3.35 TB/s),
     its plain version on one tile, and torch._int_mm on the int8 pair signs
     (whose C - D must give the same tau-a bits);
 24. the serving layer (repro_torch.serving) on the Table II corpus at
     t = 256, l_blk = 512: a CorrServer(max_wait_s=0.02) takes 6 client
     threads x 4 queries of 1-64 of phase 8's TF rows (row draws seed 1),
     half dense, half top-10; every answer bitwise standalone corr(probes,
     corpus) or corr(..., sink=TopKSink(10)); the float32 tiles and select
     launched, no plain version, fewer launches than requests, one corpus
     transform, a plan-cache hit on a repeat shape, queue and service ms;
     a Spearman query (a second corpus transform) and a kendall_merge
     query of 16 TF rows (its kernel launched), both bitwise standalone;
     significance of 16 TF rows at B = 32 in chunks of 16 (key 0), (r, p)
     bitwise corr(pvalues=), a repeat served from the cached null state
     with no stack built, peak memory; a LiveIndex over the corpus and a
     watch of 8 TF rows (top-10): an append of 64 rows (seed 5) launches
     only the 64 x 17,555 grid and the 64-row triangle (and the watch's
     8 x 64 grid), the index bitwise a cold corr of 17,619 rows, the
     watch bitwise its cold top-k; an update of 32 rows (seed 6) within
     DRIFT_TOL of cold; the phase's seconds;
 25. recovery (corr(recovery=RetryPolicy(sleep=no-op)), every check
     fatal, every fault at an exact arrival of its site, each run's
     plan.fired and policy.log printed, the float32 tile, select and
     Kendall launches counted and no plain version allowed): Table II in
     300-tile passes under two transient faults and an out-of-memory
     error at pass launches 2, 3 and 6, dense and DeviceTopKSink(10):
     the log retry, retry, shrink_pass 150, 18 launches, bitwise the
     fault-free runs; a real torch.cuda.OutOfMemoryError: the one-pass
     HostSink() run under an allocator cap (set_per_process_memory_
     fraction, after ballast fills the free blocks of held segments) of
     what is reserved plus the midpoint of the one-pass and 603-tile
     peaks, at least one real error classified oom, bitwise the uncapped
     run, the cap restored in any case; the 1,639 x 17,555 grid in 60-tile
     passes into HostSink(path=) under a partial write, an I/O error and
     a crash: the crash propagates, corr(resume_from=) launches exactly
     the passes the sidecar lacks, bitwise DenseSink's grid;
     ShardedHostSink at Table II over 3 simulated hosts in 300-tile
     passes, host 1 crashed at its third manifest commit and resumed
     (exactly the passes its manifest lacks), assemble and
     open_manifest(...).rows(0, 1,639) bitwise DenseSink's .cpu();
     kendall_merge over the TF rows in 5-tile passes under one transient
     fault, bitwise; TF significance at B = 32 (chunk 16, key 0) with p
     over HostSink(path=), crashed at a commit and resumed: replicas
     launched only for the passes the sidecar lacks, p bitwise; a
     LiveIndex(recovery=) append of 64 rows under one transient fault,
     bitwise a cold corr of 17,619 rows; Table II dense in 300-tile passes
     with and without recovery= (median of 3 each, printed, not gated);
     the phase's seconds;
 26. the mesh (corr(x, mesh=make_mesh((p,), ("d",), devices=...)), one
     process driving every rank): p = the card count over distinct cards
     (peer access printed) when there are two or more, else p = 4 logical
     ranks on cuda:0, printed as such.  At Table II, every result bitwise
     the one-device run, each mesh run's float32 tile, select and Kendall
     launches counted from 0 (one a rank with tiles in a pass, and one
     merge a side a pass folding DeviceTopKSink's rank states; no plain
     version), wall ms beside the one-device run's and peak memory per
     device: dense in one pass and in 300-tile passes, shard_u=True,
     DeviceTopKSink(10), the 1,639 x 17,555 grid dense and DeviceTopKSink
     (10), bf16 Pearson and int8 Kendall (64 samples), the TF kendall_merge
     triangle, TF significance at B = 32, ShardedHostSink over 2 hosts (one
     crashed at a manifest commit and resumed, assembled), recovery= with
     a device_loss at pass 1's launch of 300-tile passes (p -> p - 1), a
     CorrServer(mesh=) answering TF queries (bitwise standalone corr, one
     host occupancy a rank).  With logical ranks the wall times show the
     mesh machinery's cost on one card, not scaling;
 27. LM serving (repro_torch.launch.serve and repro_torch.models): hymba-
     1.5b, then llama3.2-3b, FULL configs at full width and depth,
     parameters from torch.Generator seed 0 on the card, one model held at
     a time: (a) serve() at its defaults (batch 4, prompt 64, 32 tokens),
     after a warm-up run: prefill ms, decode ms a step, tok/s, exactly one
     bf16 flash launch a layer in its prefill and none in decode; (b) one
     prefill of 4,096 tokens (seed 2), past hymba's window of 1,024: one
     bf16 flash launch a layer, the right window at each, no plain route
     and no plain flash version, every run's cache holding the prompt's
     last keys at their slots, a decode step launching no flash kernel,
     ms (median of 3) and peak, and one layer's attention / SSM / MLP ms;
     (c) every layer's flash output against the plain route on its inputs
     (bf16 within phase 19's row-scaled gate), the last-token logits of
     the flash and plain routes held against the float32 plain route
     (LM_BF16_RATIO), and in float32 at 1,024 tokens (each layer within
     TOL_ATTN, the logits within TOL_LM_LOGITS_F32); (d) decode after a
     prefill of S - 1 against the full forward (float32 within the
     reference's 2e-2; bf16 against the float32 plain route); (e) llama at
     32,768 tokens: ms, peak, launches.  Then the MoE configs at full
     width and cut depth (LM_MOE: qwen3-moe-30b-a3b at 24 of 48 layers,
     mixtral-8x22b at 4 of 56): (a) as above, with the share of routed
     assignments dropped in prefill and in decode at the config's
     capacity factor; (b) one prompt of 4,096 (qwen3) or 8,192 tokens
     (mixtral, past its window of 4,096): one bf16 flash launch a layer,
     no plain call, none in decode, two prefills bitwise equal, ms, peak,
     drops by layer (and of the same prompt in float32), and layer 1's
     attention / MoE / expert weight cast ms; (c)
     every layer's flash output against the plain route (bf16 gate); layer
     0's routing on LM_MOE_ROUTE_TOKENS tokens on the card bitwise the
     CPU's, its float32 output within TOL_MOE; (d) float32 at capacity
     factor E / k (nothing drops): every layer within TOL_ATTN, decode
     after a prefill of 1,023 against the full forward.  A record row a
     window class of each LM prefill (kernel, plain and library ms, bound,
     launches).
 28. LM training (models/steps.make_train_step, optim/adamw.py,
     runtime/train_loop.TrainLoop; no kernel: training attention takes the
     plain route, the flash kernel having no backward): (a) llama3.2-3b
     FULL (28 layers, 3.21 B float32 parameters and two float32 moments,
     bf16 activations) at launch/train.py's defaults, global batch 8 x
     256, three steps on one batch: every loss and gradient norm finite,
     the third loss below 1.05 x the first, every gradient leaf finite,
     every attention leaf's non-zero, no flash launch; the first (cold)
     step's ms and the warm steps' median, forward + backward and the
     AdamW update timed apart by CUDA events, peak memory above the
     parameters; (b) llama3.2-3b and
     qwen3-moe-30b-a3b SMOKE in float32, card against CPU: the loss and
     every gradient leaf within 1e-5 (of the leaf's largest |g|), the MoE
     routing equal, AdamW fed the CPU's gradients within 1e-6 of each
     leaf's largest value; (c) the TrainLoop at full width and 2 layers
     over mesh ["cuda:0"], pjit, 6 steps, checkpoints every 3, a failure
     injected at step 4: step 4 re-runs, the losses after the restore
     within 1e-6 relative of an uninterrupted run's, the checkpoint's MB,
     save, write, restore and resume ms (the directory removed after),
     the recovering run's peak memory within half the parameters and
     moments of the uninterrupted run's; (d) dp_compressed over
     ["cuda:0"] * 2 at SMOKE, 4 steps: the replicas bitwise equal, the
     loss falling; (e) launch/train.py's main at SMOKE on its default
     device: every leaf on the card, the loss falling; the phase's
     seconds.
 29. LM serving over a (data, model) mesh (models/parallel.py; alone:
     --lm-mesh-only): a rank a card on two or more cards, else TP_RANKS
     logical ranks on cuda:0.  (a) llama3.2-3b FULL at launch.serve's
     defaults and a TP_PROMPT prefill, against one device on the same
     parameters: flash launches layers x ranks at the head plan's shapes,
     none on a plain version, the float32 runs within TOL_LM_LOGITS_F32,
     bf16 within LM_BF16_RATIO of one device's distance from the float32
     truth, greedy tokens agreeing (reported), the collectives' ms a
     prefill and a decode step (CUDA events), each device's peak, and
     (e) a decode step under torch.cuda.set_sync_debug_mode("error");
     (b) hymba-1.5b FULL likewise (heads gathered to GQA groups, the
     vocabulary over d_model, d_inner split); (c) qwen3-moe-30b-a3b at
     TP_MOE_LAYERS layers, expert-parallel, the float32 prefill gated,
     and on two or more cards all 48 layers (finite logits, peak a
     card); (d) launch.serve --smoke --model-axis 4 over cuda:0 x 4 as a
     subprocess.  A record row a tensor-parallel flash shape.
 30. LM training over a (data, model) mesh (steps.make_train_step(
     policy=), TrainLoop pjit; alone: --lm-train-mesh-only, which builds
     no kernel): a rank a card on four cards, else logical ranks on
     cuda:0.  (a) llama3.2-3b FULL over (1, 4), the TrainLoop at
     launch.train's defaults for three steps beside one device's
     make_train_step from the same draw: step ms, the collectives' ms,
     each card's peak, the step-0 loss and gradient norm and the update
     held against one device's (MESH_TOL, MESH_UPDATE_TOL,
     MESH_LEAF_TOL, Adam's bound), the 38.5 GB step-0 checkpoint's
     assembly, write and restore ms, two leaves held to the file; (a')
     float32 SMOKE over (1, 4) and (2, 2), card vs CPU within 1e-5; (b)
     mixtral-8x22b at full width, fsdp_tp over (2, 2), 1 layer against one
     device (and 2 layers on four cards), each card's peak beside a
     replica's state; (c) a (2, 2) loop losing two ranks, shrunk to (1,
     2) and placed anew from the checkpoint: every step after the
     restore bitwise a resumed (1, 2) loop's, in bf16.  No flash launch
     in the phase.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it holds one JSON record per kernel.  Without a CUDA device, or without the
package src/repro_torch beside it (a copy of the script alone: it says
where it looked), the script exits non-zero before printing any result.
"""

from __future__ import annotations

import ctypes
import gc
import json
import os
import re
from math import gcd
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_SEEK, L_SEEK = 17_555, 5_072     # paper Table II (SEEK GPL570)
SPLIT = 300                        # 2,415 tiles = 8 x 300 + 15: ragged pass
SAMPLE_ROWS = 64
# Card peaks used for the bound (H100 SXM data sheet, at 700 W)
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# Kernel vs plain: the same float32 products summed in two orders.  Over
# l <= 1,024 samples the difference stays below the reference's own Pearson
# bound; over l_pad = 5,120 the diagonal's partial sums approach 1 and a
# rounding walk of ~sqrt(l) * 2^-24 ~ 4e-6 per path allows up to ~1e-5.
TOL_SMALL = 3e-6
TOL_FULL = 1e-5
# corr at float32 against float64 statistics and products on 64 rows.
TOL_F64 = 1e-5
# bf16 operands against float64: the reference's own bf16 bound
# (tests/test_fused_epilogue.py).
TOL_BF16 = 3e-2
# int8 Kendall against a float64 direct count: integer counts, one float32
# division, so only the division's rounding remains.
TOL_KENDALL = 1e-6
# fp16 operands against float64: each stored operand entry is the float32
# transform rounded to fp16, a relative error <= 2^-11 (fp16's unit
# roundoff; below fp16's normal range, 2^-14, an absolute one <= 2^-25).
# A Pearson value sum u_i v_i over unit rows then moves by at most
# 2 * 2^-11 * sum |u_i v_i| <= 2^-10 (Cauchy-Schwarz), plus at most
# 2 * 2^-25 * sqrt(l) (~4e-6 at l = 5,072) from subnormal entries, plus
# the float32 sums' TOL_F64.
TOL_F16 = 2.0 ** -10 + 2 * 2.0 ** -25 * L_SEEK ** 0.5 + TOL_F64
L_KENDALL = 64      # below the reference's 96-sample merge crossover
# Card peaks for the narrow modes' bounds (H100 SXM data sheet, dense, at
# 700 W): bf16 tensor cores, int8 tensor cores.
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP8_FLOPS = 1979e12
# bf16 and fp8 tiles (the tensor-core kernel, csrc/pcc_tile_sm90.cu) against
# the plain version on the same operands, per output, within the gate of
# kernels/narrow_gate.py:
#   |kernel - plain| <= (c * 2^-24 * sqrt(l_pad) + a * 2^-13) * G,
#   G = the plain version on |A|, |B| and |scales| (its division, no clip).
# Every reading prints as a share of the gate (<= 1 passes).  The gate must
# also refuse two planted faults (kernels/narrow_gate.py planted_faults) by
# at least its FAULT_SHARE, 10: the kernel on U with its first 128 samples
# zeroed, and with them counted twice (appended to U and V once more), both
# read without the epilogue's clip (which pins Pearson's diagonal at 1).
# One sample or a 2^-12 relative error is below what the fp8 gate can see
# at Table II (an r of ~0.014 moves by ~1 / l = 2e-4 a sample); a
# 128-sample chunk moves a diagonal value by ~128 / l = 0.025, ~12x the fp8
# gate and ~370x the bf16 one there.
# Masked Pearson against a float64 pairwise-complete computation: the
# combine cancels n * sxy - sx * sy.  With ~4,580 common samples of U[0, 1)
# values, sxy ~ 1.1e3 carries a float32 summation error of ~2e-6 relative
# (a sequential sum over 5,072 samples), n * sxy and sx * sy ~ 5e6 cancel to
# a covariance term of ~r * 1.7e6, so r moves by ~1e-5 per pair, a few
# times that in the tail of 16 x 17,555 pairs.  2e-4 is the reference's own
# bound for its masked path against its oracle (tests/test_api.py).
TOL_MASKED = 2e-4
MISSING = 0.05                     # share of entries missing at random
# Quantized Pearson against float64: the reference's error budgets
# (tests/test_quantized.py).
TOL_Q_INT8 = 8e-3
TOL_Q_FP8 = 5e-2
K_TOP = 10                         # examples/coexpression_network.py --topk 10
N_TF = 1_639                       # human TFs (Lambert et al., Cell 2018)
# Phase 22: EdgeCountSink's threshold (about 3.5 sd of |r| over l = 5,072
# uniform samples, ~1 / sqrt(l) = 0.014: some 10^5 of the 154 M pairs),
# its labels (EDGE_MODULES groups drawn from seed EDGE_LABEL_SEED) and the
# RowBlockSink ranges over the TF rows, straddling 256-row tile edges.
EDGE_THRESHOLD = 0.05
EDGE_MODULES, EDGE_LABEL_SEED = 10, 3
ROW_BLOCKS = [(0, 500), (500, 1_100), (1_100, 1_639)]
N_64K, L_64K = 64_000, 5_000       # paper Table I, configs ARTIFICIAL_64K
CHECK_ROWS = 16
# Phase 24, serving: SERVE_CLIENTS client threads x SERVE_QUERIES queries of
# 1-SERVE_MAX_ROWS TF probe rows each (row draws seed 1), half dense, half
# top-K_TOP; the batching window; significance of SERVE_SIG_ROWS TF rows at
# B = SERVE_B in chunks of SERVE_CHUNK (key 0); a LiveIndex delta of
# SERVE_APPEND appended rows (seed 5) and SERVE_UPDATE updated rows (seed
# 6), and a watch of SERVE_WATCH TF rows.
SERVE_CLIENTS, SERVE_QUERIES, SERVE_MAX_ROWS = 6, 4, 64
SERVE_WAIT_S = 0.02
SERVE_SIG_ROWS, SERVE_B, SERVE_CHUNK = 16, 32, 16
SERVE_APPEND, SERVE_UPDATE, SERVE_WATCH = 64, 32, 8
# Phase 25, recovery (each fault at an exact arrival of its site, counted
# as runtime/faults.py counts them):
# - Table II in REC_SPLIT-tile passes (9) under REC_FAULTS: transient faults
#   at the second and third pass launches (the second arrives while pass 0
#   is launched and not yet consumed, the double buffer; the third is pass
#   0's relaunch), then an out-of-memory error at the sixth (pass 2's
#   launch; passes 0 and 1 launched, pass 0 consumed): retry, retry, halve
#   to REC_SPLIT // 2;
# - a real out-of-memory error: the one-pass HostSink() run (2,415 tiles, a
#   633 MB pass buffer) under a cap halfway between its peak and that of
#   REC_OOM_SPLIT-tile passes (a quarter of the tiles, two buffers live):
#   1,207-tile passes (two 316 MB buffers) exceed it too, 603 fit;
# - the X-vs-Y grid (483 tiles) in REC_GRID_SPLIT-tile passes (9) into
#   HostSink(path=) under REC_GRID_FAULTS: a partial write at pass 2's
#   write, an I/O error at the fifth flush (pass 3's commit; open flushes
#   first), a crash at the eighth commit (open commits first, pass 3's
#   commit fell to the I/O error: pass 7's), so passes 7 and 8 remain;
# - ShardedHostSink over REC_HOSTS hosts, host REC_CRASH_HOST crashing at
#   its sink_commit arrival REC_CRASH_AT (open commits first, then one a
#   pass: the crash kills its second pass's manifest);
# - merge-sort Kendall and significance in REC_KENDALL_SPLIT-tile passes of
#   the TF triangle (28 tiles: 6 passes), the significance crash at
#   sink_commit REC_SIG_CRASH_AT (once passes 0 and 1 are committed).
REC_SPLIT = 300
REC_FAULTS = (("pass_launch", "transient", (2, 3)),
              ("pass_launch", "oom", (6,)))
REC_OOM_SPLIT = 603
REC_GRID_SPLIT = 60
REC_GRID_FAULTS = (("sink_write", "partial_write", (3,)),
                   ("sink_flush", "io", (5,)),
                   ("sink_commit", "crash", (8,)))
REC_HOSTS, REC_CRASH_HOST, REC_CRASH_AT = 3, 1, 3
REC_KENDALL_SPLIT = 5
REC_SIG_CRASH_AT = 4
# Phase 26, the mesh (launch/mesh.py): one rank a card when there are two
# or more, else MESH_LOGICAL logical ranks on cuda:0; 2-host ShardedHostSink
# with host MESH_CRASH_HOST crashing at its sink_commit arrival
# MESH_CRASH_AT (open commits first: its second pass's manifest); a
# device_loss at pass_launch arrival MESH_LOSS_AT (pass 1's launch, while
# pass 0 is launched and not consumed); MESH_QUERIES TF queries of 1-64
# rows (row draws seed 7) served over the mesh; significance at B =
# MESH_B, chunks of MESH_CHUNK (key 0); wall times the median of
# MESH_REPS runs after a warm-up.
MESH_LOGICAL = 4
MESH_CRASH_HOST, MESH_CRASH_AT = 1, 3
MESH_LOSS_AT = 2
MESH_QUERIES = 6
MESH_B, MESH_CHUNK = 32, 16
MESH_REPS = 3
# Significance (phase 18): B permutations (paper SSIV: >= 1,000), key 0.
B_SIG = 1_000
SIG_ROWS = 8
# A count compares two float32 values, each within ~TOL_F64 of its float64
# value: where a replica's float64 |r| lies within 2 * TOL_F64 of the
# observed one, the float32 comparison may go either way (a near-tie).
TIE_SIG = 2 * TOL_F64
# Flash attention (phase 19): one layer's attention at the head shapes of
# two shipped configurations (name, config, B, H, Hkv, D, window, S).
FLASH_CASES = [
    ("llama-4k", "src/repro/configs/llama3_2_3b.py", 1, 24, 8, 128, None,
     4_096),     # train_4k
    ("llama-32k", "src/repro/configs/llama3_2_3b.py", 1, 24, 8, 128, None,
     32_768),    # prefill_32k
    ("hymba-swa-32k", "src/repro/configs/hymba_1_5b.py", 1, 25, 5, 64,
     1_024, 32_768),   # the sliding-window layers at prefill_32k
]
FLASH_SMALL = [  # B, H, Hkv, S, D, window: the reference's test shapes,
    (1, 2, 2, 32, 16, None), (2, 4, 2, 70, 16, None),  # the windows it
    (1, 8, 1, 64, 32, None), (2, 2, 2, 17, 8, None),   # drops, and the
    (2, 4, 2, 96, 16, 16), (2, 4, 2, 96, 16, 32),      # model cases'
    (2, 4, 2, 96, 16, 48), (1, 2, 1, 32, 16, 16),      # head tiles
    (1, 2, 1, 96, 16, 80), (1, 2, 1, 40, 16, 32), (1, 3, 1, 300, 64, 64),
    (1, 4, 2, 200, 128, None), (1, 2, 1, 150, 100, None),
    (1, 1, 1, 130, 256, 128), (1, 2, 1, 257, 64, 16),
]
DROPPED_WINDOWS = {(32, 16), (96, 80), (40, 32)}   # (S, window), blk 16
FLASH_FP16 = ("llama-4k",)     # the cases also run in fp16
# Kernel against plain at the small shapes: the reference's own bound
# (tests/test_kernels.py).
TOL_ATTN_SMALL = 2e-6
# bf16 / fp16 (the tensor-core kernel) against the plain version on the
# same inputs, and against float64 on them, on every element:
#   |got - want| <= min(NARROW_ULP * |want| + NARROW_ROW * rms(want's row),
#                       TOL_ATTN_NARROW * (1 + |want|)).
# The second is the reference's own bf16 bound (tests/test_kernels.py).  At
# long rows it is as large as the output itself (row i averages ~i / e v
# rows, so its outputs are ~sqrt(e / i): 0.026 at row 4,096, 0.009 at row
# 32,767), so the first, scaled to each row, is what holds those rows.  The
# kernel rounds P to the input type before P V (unit roundoff u = 2^-8 in
# bf16, 2^-11 in fp16) where the plain version keeps float32: each weight
# moves by at most u of itself, so an output moves by ~u / sqrt(3) of its
# row's rms, some 3.5 u at the largest of 10^8 elements; NARROW_ROW = 8 u.
# Each output is rounded once to the dtype, so two of them may differ by an
# ulp, at most 2^-7 (bf16) or 2^-10 (fp16) of |want|: NARROW_ULP.
TOL_ATTN_NARROW = 3e-2
NARROW_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
NARROW_ROW = {"bfloat16": 2.0 ** -5, "float16": 2.0 ** -8}
# float32 attention against float64 and against the plain version at the
# full shapes: a logit is a float32 dot of D products (error ~1e-7 relative
# at D = 128), exp turns it into a relative weight error of that size, and
# an output row, a convex combination of v rows (|v| < 6), moves by at most
# that times their spread: ~1e-6.  The plain version measured 8.3e-7
# against float64 at S = 4,096, D = 128 on the CPU; 1e-5 leaves 10x.
TOL_ATTN = 1e-5
# Up to this S the plain version and the float64 check take every row at
# once; above it the plain version runs in row chunks and float64 checks
# ATTN_ROWS rows at each end (the whole logits of the 32k cases would not
# fit: 24 x 32,768^2 float32 is 103 GB).
ATTN_WHOLE = 4_096
ATTN_CHUNK = 2_048
ATTN_ROWS = 512

# LM serving (phase 27): hymba-1.5b, then llama3.2-3b, FULL (full width and
# depth; parameters from torch.Generator seed 0 on the card), one model held
# at a time.  (a) launch.serve's defaults; (b)-(d) one prompt of LM_PROMPT
# tokens (seed 2), past hymba's window of 1,024; the float32 route check at
# LM_F32_PROMPT tokens; (e) llama3.2-3b at LM_LONG tokens (prefill_32k).
LM_ARCHS = ("hymba-1.5b", "llama3.2-3b")
LM_BATCH, LM_SERVE_PROMPT, LM_GEN = 4, 64, 32
LM_PROMPT = 4_096
LM_F32_PROMPT = 1_024
LM_LONG = 32_768
# Every layer's flash output against the plain route (the reference's
# sdpa / _chunked_sdpa) on the same rotated q, k, v: float32 within phase
# 19's full-shape TOL_ATTN (the plain route scales the logits after the
# dot, the kernel q before it: a few ulps of a logit, ~1e-6 of an output
# row of |v| < 6, where the reference's 2e-6 is for its small test shapes);
# bf16 within phase 19's row-scaled gate (NARROW_ULP, NARROW_ROW).
# Last-token logits in bf16: a random model of 28-32 layers amplifies bf16
# roundings (2^-9 of each activation) from layer to layer, so the two
# routes' logits differ by much more than one rounding.  Both are held
# against the float32 truth (the plain route with float32 activations on
# the same parameters): the flash route's logits, and decode's after a
# prefill of S - 1, may be at most LM_BF16_RATIO times as far from it as
# the plain bf16 route's.  The kernel adds one rounding of P per layer (at
# most u / sqrt(3) of the row rms) to the route's own roundings of every
# matmul output, so its distance stays within a small factor of the plain
# route's; 3 leaves room for the spread of that amplification.
LM_BF16_RATIO = 3.0
# float32 logits of the two routes, relative to max |logit|: per layer
# <= TOL_ATTN (1e-5 of outputs ~1), amplified as bf16 noise is (2^-9 grows
# to ~4.5e-2 of max |logit| over hymba's 32 layers on an H100, phase 27
# (c), ~20x): ~2e-4, under 1e-3.
TOL_LM_LOGITS_F32 = 1e-3
TOL_LM_DECODE = 2e-2
# Phase 27, MoE (name, layers kept, (b) prompt): full width, depth cut to
# fit one card with float32 parameters (the reference draws them float32
# whatever param_dtype says: qwen3's 48 layers are 122 GB, mixtral's 56 are
# 564 GB), ~62 GB and ~42 GB; mixtral's prompt runs past its window of
# 4,096, so its layers take the band.  The routing check: one layer on
# LM_MOE_ROUTE_TOKENS standard normal tokens (numpy seed 3), on the card
# and on the CPU, the float32 outputs within TOL_MOE of the CPU's largest
# |value| (the same float32 products summed in other orders, as the CPU
# tests' 1e-5 against the reference).
LM_MOE = (("qwen3-moe-30b-a3b", 24, 4_096), ("mixtral-8x22b", 4, 8_192))
LM_MOE_ROUTE_TOKENS = 256
TOL_MOE = 1e-5
# Phase 27's float32 route check: each layer's flash output within
# TOL_ATTN of the plain route's, or TOL_ATTN of the layer's largest |output|
# where that exceeds 1 (the CPU tests' 1e-5 of the largest value).
# TOL_ATTN was argued for standard normal v, |v| < 6 and outputs ~1; a
# row's float32 sum over up to 1,024 keys errs in proportion to the v it
# adds, and mixtral's v (d_model 6,144 at weight scale 0.02: sd ~1.6)
# reach ~8 (absolute reading 1.454e-5 on an H100).
# Phase 27, the last two families (name, layers kept or None for all):
# qwen2-vl-72b at full width, depth cut to 12 of 80 layers to hold float32
# parameters on one card (80 layers are 281 GB), ~52 GB; the VLM prefills
# embeddings (torch.Generator seed 2) with broadcast 0..S-1 m-rope streams,
# as the reference's launcher passes them.  seamless-m4t-medium FULL (12
# encoder + 12 decoder layers), 3.5 GB; (b) encodes LM_PROMPT source
# frames and prefills LM_PROMPT target tokens.  The VLM witness (d): layer
# 0's attention on a prompt of LM_PROMPT positions laid out as Qwen2-VL's
# M-RoPE does (arXiv:2409.12191 SS2.1): LM_IMAGE_AT text positions, one
# LM_IMAGE_GRID x LM_IMAGE_GRID image block of patches sharing t, its h and
# w the grid coordinates offset by LM_IMAGE_AT, then text from
# LM_IMAGE_AT + LM_IMAGE_GRID.  Float32 on the card against the CPU within
# TOL_WITNESS of the CPU's largest |value| (the same float32 products
# summed in other orders, as the CPU tests' 1e-5 against the reference);
# the index-masked output must differ from it by more than that.
LM_FAMILIES = (("qwen2-vl-72b", 12), ("seamless-m4t-medium", None))
LM_IMAGE_AT, LM_IMAGE_GRID = 1_024, 32
TOL_WITNESS = 1e-5
# Phase 28, LM training: llama3.2-3b FULL (28 layers, 3.21 B parameters:
# float32 parameters, gradients and two float32 moments, ~51.4 GB) at
# launch/train.py's defaults, global batch 8 x sequence 256, three steps
# of make_train_step on one batch (the third loss below 1.05 x the first,
# as tests/test_arch_smoke.py:69 asks).  (b) card against CPU at SMOKE in
# float32, the CPU tests' tolerances: the loss and each gradient leaf
# within 1e-5 (of the leaf's largest |g|), AdamW fed the CPU's gradients
# within 1e-6 of each leaf's largest value (the same float32 arithmetic;
# sums in other orders).  (c) the TrainLoop at full width, depth cut to 2
# layers (~7.2 GB a checkpoint: parameters and two moments), a failure
# injected at step 4 of 6 with checkpoints every 3: the steps after the
# restore within TOL_RESUME relative of an uninterrupted run's (the card's
# backward sums in an order that may change from run to run).  (d)
# dp_compressed over two logical ranks on the card.  (e) launch/train.py's
# main at SMOKE, CLI_STEPS steps, on its default device.
TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 3
TRAIN_SMOKE = ("llama3.2-3b", "qwen3-moe-30b-a3b")
TOL_TRAIN, TOL_TRAIN_ADAM, TOL_RESUME = 1e-5, 1e-6, 1e-6
LOOP_LAYERS, LOOP_STEPS, LOOP_CKPT_EVERY, LOOP_FAIL_AT = 2, 6, 3, 4
DP_RANKS, DP_STEPS = 2, 4
CLI_STEPS = 3
# Phase 29, LM serving over a model axis (models/parallel.py): a (1, p)
# ("data", "model") mesh, one rank a card on two or more cards (p = the
# cards, at most TP_RANKS), else TP_RANKS logical ranks on cuda:0, whose
# times show the executor's cost, not scaling.  (a) llama3.2-3b FULL at
# launch.serve's defaults and one prompt of TP_PROMPT tokens (seed 2); (b)
# hymba-1.5b FULL at the defaults; (c) qwen3-moe-30b-a3b at full width,
# expert-parallel, depth cut to TP_MOE_LAYERS against one device (float32
# parameters: ~32 GB a copy), and on two or more cards all 48 layers
# (122 GB) over the mesh.  The gates: the float32 runs (the same
# parameters, float32 activations) of the mesh and of one device within
# TOL_LM_LOGITS_F32 of max |logit| (phase 27's float32 bound: the two differ
# by the order of the row-parallel layers' float32 sums, ~1e-7 a layer,
# grown over the layers); the bf16 runs held as phase 27 holds its routes:
# the mesh's last-token logits at most LM_BF16_RATIO times as far from the
# float32 truth as one device's.  The mesh rounds each row-parallel sum
# once, where a card's GEMM rounds its own; narrower GEMMs take other
# cuBLAS tilings, so many outputs round to the other neighbour, and a
# random model of 28-32 layers grows those ulps as it grows all bf16 noise
# (the first call read the bf16 runs 3.98e-2 of max apart at llama's
# serve): the bf16 runs differ from each other by about as much as each
# differs from the truth, never by O(1) as a wrong head, expert or
# partial would make them.  MoE in bf16: a flipped top-k choice moves a
# token's output by O(1), so (c) holds float32 and reports bf16.
TP_RANKS = 4
TP_PROMPT = 4_096
TP_MOE_ARCH, TP_MOE_LAYERS = "qwen3-moe-30b-a3b", 12
# Phase 29's bf16 last-token logits.  The mesh's run differs from one
# device's only where its row-parallel layers sum float32 partials in
# another order, each sum rounded once to bf16 as one device rounds its
# matmul, so both runs carry bf16 roundings of the same kind and number,
# amplified alike over the layers (and a near-tie of the MoE router flips
# as often on either).  The mesh's logits may be at most TP_BF16_RATIO
# times as far from the float32 truth (the same parameters, float32
# activations, one device) as one device's bf16 logits are.  Read before
# this gate was set (NVIDIA H100 80GB HBM3, 700 W): 1.002-1.044x for
# llama3.2-3b at the serving defaults and at 4,096 tokens and for
# hymba-1.5b.
TP_BF16_RATIO = 1.5
# Phase 30, LM training over a (data, model) mesh (models/parallel.py,
# steps.make_train_step(policy=), TrainLoop in pjit mode; alone:
# --lm-train-mesh-only): one rank a card where four cards are visible,
# else logical ranks on cuda:0.  (a) llama3.2-3b FULL over
# MESH_TRAIN_SHAPE, the TrainLoop at launch.train's defaults (8 x 256,
# its optimizer for TRAIN_STEPS steps), beside one device's
# make_train_step from the same draw over the same batches; bf16
# activations.  Gates: the step-0 loss and gradient norm (the same
# parameters and batch) within MESH_TOL relative of one device's: the two
# differ where a row-parallel layer sums float32 partials in another order
# and rounds once to bf16 (an element off by at most one bf16 ulp, 2^-8
# relative), and the loss, a mean over 2,048 tokens, and the norm, a sum
# over 3.2 B squares, average such roundings far below one ulp, where a
# wrong shard or a missing partial moves them by O(1).  The updates after
# TRAIN_STEPS steps: Adam moves an element by at most lr a step, so every
# element of the two runs lies within twice the summed lr (and decay) of
# the other (fatal above), and the relative L2 distance between the two
# runs' updates is at most MESH_UPDATE_TOL over the model and
# MESH_LEAF_TOL for any leaf: Adam's first step is lr sign(g), which
# bf16 noise flips only where |g| is below it (a flipped element moves 2
# lr); a leaf whose gradient never reached its shards would not move (a
# distance of 1).  The checkpoint (step 0, the reference's whole leaves:
# 38.5 GB) assembled, written and restored into the shards, two leaves
# held to the file.  (a') MESH_SMOKE, float32 SMOKE, card against CPU on
# the same draw over the same mesh shape: the loss and every gradient leaf
# within TOL_TRAIN.  (b) mixtral-8x22b at full width, fsdp_tp over (2, 2)
# (experts 4 a rank, FSDP over data, the global batch routed in each data
# group): MESH_MOE_LAYERS of 56 layers, the first held against one device
# by (a)'s gates, the second (four cards only: no card holds one device's
# 86 GB) finite; each card's peak beside a whole replica's state.  (c)
# llama3.2-3b at full width, LOOP_LAYERS layers, fsdp_tp, bf16, the
# TrainLoop over (2, 2) losing two ranks at LOOP_FAIL_AT: it shrinks to (1,
# 2), the shards placed anew from the checkpoint, and every step after the
# restore is bitwise a (1, 2) loop's resumed from the same checkpoint (a
# mesh's backward runs on one thread, so its sums keep their order from
# one run to the next, over cards too: steps.grads_of).
MESH_TRAIN_SHAPE = (1, 4)
MESH_SMOKE = (("llama3.2-3b", (1, 4)), ("qwen3-moe-30b-a3b", (2, 2)))
MESH_MOE_ARCH = "mixtral-8x22b"
MESH_MOE_LAYERS = ((1, True), (2, False))   # (layers, against one device)
MESH_TOL = 2.0 ** -8
# The update gates: the distance is about 2 sqrt(share of flipped
# elements), so 0.2 over the model is 1 % of its elements flipped and 0.5
# for a leaf 6 %, where a leaf that never moved reads 1 and one moved by
# unrelated gradients ~1.4.  Read before these gates were set (NVIDIA H100
# 80GB HBM3, 700 W, one card, 4 logical ranks): llama3.2-3b FULL 0.042
# over the model, 0.057 its worst leaf; mixtral-8x22b (1 layer) 0.039,
# 0.210 (its embedding, whose rows a batch of 2,048 tokens mostly leaves
# without a gradient).
MESH_UPDATE_TOL = 0.2
MESH_LEAF_TOL = 0.5


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def amax(x) -> float:
    """Largest element of a tensor as a float, 0 for an empty one."""
    return float(x.max()) if x.numel() else 0.0


def lookup64(u64, v64, rows, cols, spec, chunk=16_384):
    """float64 values (with the epilogue) of the pairs (rows[i], cols[i])
    of the padded operands, in chunks."""
    import torch
    out = torch.empty(rows.numel(), dtype=torch.float64, device=u64.device)
    for i in range(0, rows.numel(), chunk):
        r, c = rows[i:i + chunk], cols[i:i + chunk]
        out[i:i + chunk] = (u64[r] * v64[c]).sum(dim=1)
    return spec.apply(out) if spec is not None else out


def check_topk_state(got, want, u64, v64, spec, tol, label):
    """Hold one (vals, cols) state side of the kernel against the plain
    version's: the same empty slots, every value within `tol` of float64 at
    its own column, the |v| sequence within `tol` slot by slot, and the
    columns equal except where the two candidates' float64 |v| lie within
    2 * tol.  Returns (max |kernel - plain| where the columns agree, number
    of near-ties)."""
    import torch
    gv, gc = got
    wv, wc = want
    if not torch.equal(gc < 0, wc < 0):
        raise AssertionError(f"{label}: empty slots differ")
    ok = gc >= 0
    m, t, kk = gv.shape
    rows = (torch.arange(m * t, device=gv.device).view(m, t, 1)
            .expand(m, t, kk))[ok]
    d_got = lookup64(u64, v64, rows, gc[ok].long(), spec)
    d_want = lookup64(u64, v64, rows, wc[ok].long(), spec)
    errs = [amax((gv[ok].double() - d_got).abs()),
            amax((wv[ok].double() - d_want).abs()),
            amax((gv[ok].abs() - wv[ok].abs()).abs())]
    if not max(errs) <= tol:
        raise AssertionError(f"{label}: values off by {errs} (tol {tol:g})")
    differ = gc[ok] != wc[ok]
    gap = amax((d_got[differ].abs() - d_want[differ].abs()).abs())
    if not gap <= 2 * tol:
        raise AssertionError(f"{label}: columns differ beyond a near-tie "
                             f"(|v| gap {gap:.3e})")
    same = ok & (gc == wc)
    return amax((gv[same] - wv[same]).abs()), int(differ.sum())


def narrow_readings(u, j0, kw, label, faults=True):
    """The narrow kernel's tiles on (u, j0, **kw) against the plain
    version's within the gate, and (faults=True) the planted faults
    refused by at least FAULT_SHARE.  Returns (kernel tiles, share, max
    |kernel - plain|, max gate, fault shares)."""
    import torch
    from repro_torch.kernels.narrow_gate import (FAULT_SHARE, gate_share,
                                                 narrow_gate,
                                                 planted_fault_shares)
    from repro_torch.kernels.pcc_tile import pcc_tiles, pcc_tiles_plain
    got = pcc_tiles(u, j0, **kw)
    want = pcc_tiles_plain(u, j0, **kw)
    gate = narrow_gate(u, j0, **kw)
    torch.cuda.synchronize()
    share = gate_share(got, want, gate)
    err = float((got - want).abs().max())
    if not share <= 1.0:
        raise AssertionError(f"{label}: kernel outside the narrow gate "
                             f"({share:.4g} of it)")
    fault = planted_fault_shares(u, j0, **kw) if faults else {}
    for name, f in fault.items():
        if not f >= FAULT_SHARE:
            raise AssertionError(f"{label}: the gate let the planted fault "
                                 f"'{name}' through ({f:.4g} of it)")
    return got, share, err, float(gate.max()), fault


def scaled_mm_call(a, b, scale_a, scale_b, what):
    """The library yardstick of a scaled fp8 product: (a call of
    torch._scaled_mm(a, b) with these row-wise scales, its label), at the
    first out dtype this PyTorch takes of float32 and bf16; (None, None)
    if it takes neither (e5m2 x e5m2 is refused)."""
    import torch
    for out_dt in (torch.float32, torch.bfloat16):
        def call(out_dt=out_dt):
            return torch._scaled_mm(a, b, scale_a=scale_a, scale_b=scale_b,
                                    out_dtype=out_dt)
        try:
            call()
        except Exception as exc:   # version- and shape-dependent
            print(f"  torch._scaled_mm({what}) with row-wise scales, "
                  f"{out_dt} out: not supported here ({exc})")
            continue
        return call, (f"torch._scaled_mm({what}), row-wise scales, "
                      f"{str(out_dt).removeprefix('torch.')} out")
    return None, None


def check_rows_topk(res, rows, u64, v64, k, self_pairs, tol, label):
    """The port's top-k of `rows` against a float64 top-k of those rows:
    values within tol of float64 at their columns, the |v| sequence within
    tol, columns equal except at near-ties (|v| within 2 * tol).  Returns
    (max error, near-ties)."""
    import torch
    r64 = torch.clamp(u64[rows] @ v64.T, -1.0, 1.0)
    n_c = v64.shape[0]
    key = r64.abs()
    if self_pairs:
        key[torch.arange(len(rows)), rows] = -1.0
    want_c = torch.topk(key, k, dim=1).indices
    got_c = torch.as_tensor(res["indices"], device=u64.device)[rows]
    got_v = torch.as_tensor(res["values"], device=u64.device)[rows].double()
    if bool((got_c < 0).any()) or bool((got_c >= n_c).any()):
        raise AssertionError(f"{label}: empty or bad slots in sampled rows")
    at_got = torch.take_along_dim(r64, got_c, dim=1)
    at_want = torch.take_along_dim(r64, want_c, dim=1)
    err = max(float((got_v - at_got).abs().max()),
              float((got_v.abs() - at_want.abs()).abs().max()))
    if not err <= tol:
        raise AssertionError(f"{label}: values off by {err:.3e} (tol {tol:g})")
    differ = got_c != want_c
    gap = amax((at_got.abs() - at_want.abs())[differ].abs())
    if not gap <= 2 * tol:
        raise AssertionError(f"{label}: columns differ beyond a near-tie")
    return err, int(differ.sum())


def event_ms(fn, reps):
    """Median and all of `reps` CUDA-event times of fn() after one warm-up
    call, in ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def host_ms(fn, reps):
    """Median and all of `reps` host-clock times of fn() followed by
    torch.cuda.synchronize(), after one warm-up call, in ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(times), times


def library_attn(q_, k_, v_, w_, out_, reps):
    """(ms, label) of one PyTorch call that computes the same attention
    (scaled_dot_product_attention; the port never calls it), or (None,
    reason)."""
    import torch
    dev = q_.device
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if w_ is None:
        kw, what = dict(is_causal=True), "is_causal=True"
    else:
        i = torch.arange(q_.shape[2], device=dev)
        kw = dict(attn_mask=(i[None, :] <= i[:, None])
                  & (i[None, :] > i[:, None] - w_))
        what = "attn_mask=<boolean band>"
    tries = [(f"scaled_dot_product_attention({what}, enable_gqa=True)",
              lambda: sdpa(q_, k_, v_, enable_gqa=True, **kw))]
    rep = q_.shape[1] // k_.shape[1]
    tries.append((f"scaled_dot_product_attention({what}) on k, v "
                  f"expanded to H heads beforehand (not timed)",
                  lambda: sdpa(q_, ke, ve, **kw)))
    ke = ve = None
    fails = []
    for label, fn in tries:
        try:
            if "expanded" in label:
                ke = k_.repeat_interleave(rep, dim=1)
                ve = v_.repeat_interleave(rep, dim=1)
            got = fn()
            torch.cuda.synchronize()
        except Exception as exc:   # backend-, version- and size-dependent
            fails.append(f"{label}: {str(exc).splitlines()[0][:160]}")
            torch.cuda.empty_cache()
            continue
        diff = amax((got.float() - out_.float()).abs())
        del got
        ms = event_ms(fn, reps)[0]
        return ms, (f"{label}, max|library - kernel| {diff:.3e}"
                    + "".join(f"; refused first: {f}" for f in fails))
    return None, "none: " + "; ".join(fails)


def flash_record(arch, q, k, v, window, launches, label, tag):
    """One kernels-record row: the flash kernel at one layer's recorded
    inputs (q, k, v (B, S, H, D) as the layers hand them over), its plain
    version, the library call and the bound (phases 27 and 29)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models import layers
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    b_, h_, s_, d_ = qt.shape
    w_ = window or None
    # the wrapper's blk only validates the window (layers._flash_route)
    blk = {"blk_q": layers.FLASH_BLK, "blk_k": layers.FLASH_BLK} \
        if w_ is None else {"blk_q": gcd(w_, layers.FLASH_BLK),
                            "blk_k": gcd(w_, layers.FLASH_BLK)}
    chunk = None if s_ <= ATTN_WHOLE else ATTN_CHUNK
    out = flash_attention(qt, kt, vt, window=w_, **blk)
    want = flash_attention_plain(qt, kt, vt, window=w_, chunk=chunk)
    err = amax((out.float() - want.float()).abs())
    del want
    reps = 5 if s_ <= ATTN_WHOLE else 3
    k_ms = event_ms(lambda: flash_attention(qt, kt, vt, window=w_,
                                            **blk), reps)[0]
    p_ms = event_ms(lambda: flash_attention_plain(
        qt, kt, vt, window=w_, chunk=chunk), 3 if chunk is None else 1)[0]
    l_ms, l_label = library_attn(qt, kt, vt, w_, out, reps)
    pairs = b_ * h_ * (s_ * (s_ + 1) // 2 if w_ is None or w_ >= s_
                       else w_ * (w_ + 1) // 2 + (s_ - w_) * w_)
    peak_ops = FP32_FLOPS if qt.dtype == torch.float32 else BF16_FLOPS
    o_ms = 4 * d_ * pairs / peak_ops * 1e3
    b_ms = (2 * qt.numel() + 2 * kt.numel()) * qt.element_size() \
        / HBM_BYTES_S * 1e3
    dname = "bf16" if qt.dtype == torch.bfloat16 else "float32"
    print(f"    flash_attention at {label} ({dname}): {k_ms:.3f} ms, "
          f"bound {max(o_ms, b_ms):.3f} ms, plain {p_ms:.3f} ms, "
          f"library {'not measured' if l_ms is None else f'{l_ms:.3f}'}"
          f" ({l_label}); max|kernel - plain| {err:.3e}; {launches} "
          f"launches in the prefill {tag}")
    return {"name": f"flash_attention (LM prefill, {arch} {label}, "
                    f"{dname})",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention"
                      f"{'' if qt.dtype == torch.float32 else '_sm90'}"
                      ".cu",
            "replaces": "src/repro/kernels/flash_attention.py:118",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(o_ms, b_ms),
            "bound_by": "operations" if o_ms >= b_ms else "bytes",
            "library_ms": l_ms}


def route_gate(records, plain_route, cfg_, what):
    """Every recorded layer's flash output (q, k, v, window, out) against
    the plain route on its inputs: (max |flash - plain|, the largest share
    of the gate), raising above it (phases 27 and 29).  bf16: the
    row-scaled narrow gate.  float32: TOL_ATTN x max(1, the layer's largest
    |output|), which is TOL_ATTN itself for a layer whose outputs stay
    within 1."""
    import torch
    err = share = 0.0
    for q, k, v, window, out in records:
        pos = torch.arange(q.shape[1], device=q.device)[None, :].expand(
            q.shape[0], -1)
        want = plain_route(cfg_, q, k, v, pos, window)
        g4 = out.reshape(q.shape).transpose(1, 2).double()
        w4 = want.reshape(q.shape).transpose(1, 2).double()
        diff = (g4 - w4).abs()
        err = max(err, amax(diff))
        if out.dtype == torch.float32:
            share = max(share, amax(diff) / (
                TOL_ATTN * max(1.0, amax(w4.abs()))))
        else:
            rms = w4.square().mean(-1, keepdim=True).sqrt()
            gate = torch.minimum(
                NARROW_ULP["bfloat16"] * w4.abs()
                + NARROW_ROW["bfloat16"] * rms,
                TOL_ATTN_NARROW * (1 + w4.abs()))
            share = max(share, amax(diff / gate))
        del want, g4, w4, diff
    if not share <= 1:
        raise AssertionError(f"{what}: a layer's flash output is "
                             f"{err:.3e} from the plain route, "
                             f"{share:.3f} of its gate")
    return err, share


def overlap_runs(x_dev, k_top, split):
    """Multi-pass top-k at Table II (`split`-tile passes): each top-k sink's
    corr end to end (median of 3), against the sum and the larger of its
    passes' kernels (CUDA events, back to back) and its sink's work per pass
    (consume() and pass_complete(), each between two synchronisations:
    device pre-selection, copies, host merge).  The sinks' copies overlap
    the next pass's kernel only if they wait on their own pass."""
    import torch
    from repro_torch.core.allpairs import launch_tiles, launch_topk_tiles
    from repro_torch.core.api import corr
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.core.sinks import DeviceTopKSink, TopKSink

    plan = ExecutionPlan.create(N_SEEK, L_SEEK, max_tiles_per_pass=split)
    u = plan.prepare(x_dev)

    def kernels(device_state):
        for k, launch in enumerate(plan.launch_sizes):
            lo = plan.pass_offset(k)
            if device_state:
                launch_topk_tiles(plan, u, lo, plan.total_tiles, launch,
                                  k_top)
            else:
                launch_tiles(plan, u, lo, launch)

    out = {}
    for cls in (DeviceTopKSink, TopKSink):
        class Timed(cls):
            def __init__(self, k):
                super().__init__(k)
                self.ms = []

            def timed(self, fn, *args):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t1) * 1e3)

            def consume(self, ids, buf, *ready):
                self.timed(super().consume, ids, buf, *ready)

            def pass_complete(self, k):
                self.timed(super().pass_complete, k)

        wall, walls = host_ms(lambda: corr(x_dev, sink=cls(k_top),
                                           max_tiles_per_pass=split), 3)
        kern, _ = event_ms(lambda: kernels(cls is DeviceTopKSink), 3)
        sink_all = []
        for _ in range(3):
            snk = Timed(k_top)
            corr(x_dev, sink=snk, max_tiles_per_pass=split)
            sink_all.append(sum(snk.ms))
        sink = statistics.median(sink_all)
        out[cls.__name__] = dict(
            passes=plan.n_pass, corr_ms=wall, corr_runs=walls,
            kernels_ms=kern, sink_ms=sink, sum_ms=kern + sink,
            max_ms=max(kern, sink))
        print(f"  {cls.__name__}({k_top}), {plan.n_pass} passes of <= "
              f"{split} tiles: corr {wall:.3f} ms (runs "
              f"{[round(v, 3) for v in walls]}); kernels {kern:.3f} ms, sink "
              f"{sink:.3f} ms (runs {[round(v, 3) for v in sink_all]}): sum "
              f"{kern + sink:.3f}, larger {max(kern, sink):.3f}")
    return out


def host_sink_runs(x_dev, split, stop=4, bad=2):
    """Phase 21: HostSink(path=) and corr(resume_from=) at Table II in
    `split`-tile passes, every check fatal; returns the times (ms)."""
    import os
    import tempfile

    import torch
    from repro_torch.core.allpairs import launch_tiles
    from repro_torch.core.api import corr
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.core.sinks import HostSink
    from repro_torch.kernels.pcc_tile import pcc_tiles

    plan = ExecutionPlan.create(N_SEEK, L_SEEK, max_tiles_per_pass=split)

    def clock(ms, key, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        ms[key].append((time.perf_counter() - t1) * 1e3)
        return out

    class Timed(HostSink):
        """Host clock around each pass's consume (copy wait and tile
        write), tile write and commit."""

        def open(self, plan_, device):
            super().open(plan_, device)
            self.ms = {"consume": [], "write": [], "commit": []}

        def consume(self, ids, tiles, ready=None):
            clock(self.ms, "consume", super().consume, ids, tiles, ready)

        def _place(self, ids, vals):
            clock(self.ms, "write", super()._place, ids, vals)

        def pass_complete(self, k):
            clock(self.ms, "commit", super().pass_complete, k)

    class StopAfter(HostSink):
        """Stops the run once pass `stop` is committed."""

        def pass_complete(self, k):
            super().pass_complete(k)
            if k == stop:
                raise RuntimeError(f"stopped after pass {k}")

    class Probe(HostSink):
        """Keeps the resume schedule it read from its checkpoint."""

        def open(self, plan_, device):
            super().open(plan_, device)
            self.schedule = (self.resume_pass(), sorted(self.skip_passes()))

    def counted(fn):
        """fn()'s result and the pcc_tiles launches it made, the counts
        set to 0 just before."""
        pcc_tiles.launches = 0
        for d in pcc_tiles.launches_by_dtype:
            pcc_tiles.launches_by_dtype[d] = 0
        out = fn()
        torch.cuda.synchronize()
        if pcc_tiles.launches_by_dtype["float32"] != pcc_tiles.launches:
            raise AssertionError("HostSink run launched another kernel")
        return out, pcc_tiles.launches

    def same_bits(a, b, label):
        if a.shape != b.shape or not np.array_equal(
                np.ascontiguousarray(a).view(np.uint32),
                np.ascontiguousarray(b).view(np.uint32)):
            raise AssertionError(f"{label}: not DenseSink's bits")

    dense = corr(x_dev, max_tiles_per_pass=split).cpu().numpy()
    with tempfile.TemporaryDirectory(prefix="hostsink_") as tmp:
        path = os.path.join(tmp, "r.mm")
        sink = Timed(path=path)
        t1 = time.perf_counter()
        got, n_launch = counted(lambda: corr(x_dev, sink=sink,
                                             max_tiles_per_pass=split))
        host_ms_path = (time.perf_counter() - t1) * 1e3
        if n_launch != plan.n_pass:
            raise AssertionError(f"HostSink run: {n_launch} launches, "
                                 f"{plan.n_pass} passes")
        same_bits(got, dense, "HostSink(path)")
        if not np.array_equal(got, got.T):
            raise AssertionError("HostSink result is not exactly symmetric")
        del got
        mem_ms, mem_all = host_ms(lambda: corr(
            x_dev, sink=HostSink(), max_tiles_per_pass=split), 2)
        dense_ms, dense_all = host_ms(lambda: corr(
            x_dev, max_tiles_per_pass=split).cpu(), 3)
        u = plan.prepare(x_dev)
        kern_ms, _ = event_ms(lambda: [
            launch_tiles(plan, u, plan.pass_offset(k), n)
            for k, n in enumerate(plan.launch_sizes)], 3)
        del u
        ms = sink.ms
        wait = [c - w for c, w in zip(ms["consume"], ms["write"])]
        print(f"  HostSink(path=...), {plan.n_pass} passes of <= {split} "
              f"tiles into a {plan.n_pad}^2 float32 memmap "
              f"({plan.n_pad ** 2 * 4 / 1e9:.3f} GB): corr {host_ms_path:.3f}"
              f" ms, pcc_tiles launches {n_launch} (float32); bitwise "
              f"DenseSink's .cpu(), exactly symmetric")
        print(f"  HostSink() without a file: {mem_ms:.3f} ms (runs "
              f"{[round(v, 3) for v in mem_all]}); DenseSink + .cpu(): "
              f"{dense_ms:.3f} ms (runs {[round(v, 3) for v in dense_all]})")
        print(f"  per pass, ms: kernels {kern_ms / plan.n_pass:.3f} "
              f"(sum {kern_ms:.3f}, CUDA events); copy wait "
              f"{[round(v, 3) for v in wait]}; tile write "
              f"{[round(v, 3) for v in ms['write']]}; commit (CRC32, "
              f"flush, sidecar) {[round(v, 3) for v in ms['commit']]}")
        # a run stopped once pass `stop` is committed, then resumed
        path2 = os.path.join(tmp, "s.mm")
        try:
            corr(x_dev, sink=StopAfter(path=path2), max_tiles_per_pass=split)
        except RuntimeError as e:
            if f"after pass {stop}" not in str(e):
                raise
        else:
            raise AssertionError("the stopping sink did not stop")
        with open(path2 + ".progress.json") as f:
            if json.load(f)["completed"] != stop:
                raise AssertionError("the stopped run's watermark")
        t1 = time.perf_counter()
        got, n_resume = counted(lambda: corr(
            x_dev, resume_from=path2, max_tiles_per_pass=split))
        resume_ms = (time.perf_counter() - t1) * 1e3
        if n_resume != plan.n_pass - stop - 1:
            raise AssertionError(f"resume after pass {stop}: {n_resume} "
                                 f"launches")
        same_bits(got, dense, f"resumed after pass {stop}")
        del got
        os.remove(path2)
        print(f"  stopped once pass {stop} was committed, then corr(x, "
              f"resume_from=path): {n_resume} pcc_tiles launches (passes "
              f"{stop + 1}-{plan.n_pass - 1}), {resume_ms:.3f} ms, "
              f"DenseSink's bits")
        # bytes flipped inside a committed pass's tiles, then a resume
        ids = plan.pass_ids(bad)
        ys, xs = plan.workload.job_coord_batch(ids[len(ids) // 2:][:1])
        r0, c0 = int(ys[0]) * plan.t, int(xs[0]) * plan.t
        mm = np.memmap(path, dtype=np.float32, mode="r+",
                       shape=(plan.n_pad, plan.n_pad))
        mm[r0 + 5, c0:c0 + 16] = -mm[r0 + 5, c0:c0 + 16] - 1.0
        mm.flush()
        del mm
        probe = Probe(path=path)
        got, n_fix = counted(lambda: corr(x_dev, resume_from=path,
                                          sink=probe,
                                          max_tiles_per_pass=split))
        if probe.schedule != (bad, list(range(bad + 1, plan.n_pass))) or \
                n_fix != 1:
            raise AssertionError(f"corrupt pass {bad}: schedule "
                                 f"{probe.schedule}, {n_fix} launches")
        same_bits(got, dense, f"pass {bad} recomputed")
        del got
        print(f"  bytes flipped in pass {bad}'s tile ({ys[0]}, {xs[0]}), "
              f"then a resume: schedule {probe.schedule} (first pass, "
              f"passes skipped), {n_fix} pcc_tiles launch, DenseSink's "
              f"bits again")
    return dict(corr_ms=host_ms_path, memory_ms=mem_ms, dense_cpu_ms=dense_ms,
                kernels_ms=kern_ms, copy_wait_ms=wait, write_ms=ms["write"],
                commit_ms=ms["commit"], resume_ms=resume_ms)


def streaming_runs(x_dev, x_tf, split, reset, check, tag):
    """Phase 22: EdgeCountSink, ReductionSink, RowBlockSink, stream_tiles +
    assemble_from_stream and the transform cache at Table II, every check
    fatal and exact; `reset` / `check` are the launch counters' reset and
    check (float32 pcc_tiles only, no plain version).  Returns the times
    (ms) and peak memories (GB)."""
    import torch
    from repro_torch.core.allpairs import assemble_from_stream, stream_tiles
    from repro_torch.core.api import (clear_prepared_cache, corr,
                                      prepared_cache_stats)
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.core.sinks import (EdgeCountSink, ReductionSink,
                                        RowBlockSink)

    n = x_dev.shape[0]
    plan = ExecutionPlan.create(n, x_dev.shape[1])
    splan = ExecutionPlan.create(n, x_dev.shape[1], max_tiles_per_pass=split)
    labels = np.random.default_rng(EDGE_LABEL_SEED).integers(
        0, EDGE_MODULES, n)
    out = {}

    def run(label, fn, passes):
        """fn() with the launch counts set to 0 just before and checked
        just after: `passes` float32 pcc_tiles launches, nothing else."""
        reset()
        res = fn()
        torch.cuda.synchronize()
        check(label, passes, 0)
        return res

    def peak_run(fn, reps=3):
        """Median host time of fn() (after a warm-up) and the peak memory
        above what was held before it, in ms and GB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms, runs = host_ms(fn, reps)
        return ms, runs, (torch.cuda.max_memory_allocated() - base) / 1e9

    def same_bits(a, b, label):
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"{label}: not DenseSink's bits")

    # counts taken on the card from DenseSink's matrix, diagonal excluded
    dense = run("DenseSink, one pass", lambda: corr(x_dev), 1)
    thr = torch.tensor(EDGE_THRESHOLD, dtype=torch.float32, device=dense.device)
    lab = torch.as_tensor(labels, device=dense.device)
    deg = torch.zeros(n, dtype=torch.int64, device=dense.device)
    hits = intra2 = 0
    for r0 in range(0, n, 2048):
        r1 = min(n, r0 + 2048)
        adj = dense[r0:r1].abs() >= thr
        adj[torch.arange(r1 - r0, device=dense.device),
            torch.arange(r0, r1, device=dense.device)] = False
        deg[r0:r1] = adj.sum(1)
        hits += int(adj.sum())
        intra2 += int((adj & (lab[r0:r1, None] == lab[None, :])).sum())
    want = {"edges": hits // 2, "degrees": deg.cpu().numpy(),
            "intra_edges": intra2 // 2}
    print(f"  DenseSink's matrix, |r| >= {EDGE_THRESHOLD} off the diagonal "
          f"(float32 compare, on the card): {want['edges']} edges, "
          f"{want['intra_edges']} within {EDGE_MODULES} label groups "
          f"(labels from seed {EDGE_LABEL_SEED}), mean degree "
          f"{want['degrees'].mean():.3f}")
    if hits % 2 or intra2 % 2 or want["edges"] < 1:
        raise AssertionError("DenseSink's adjacency is not symmetric")

    def edges(mtp):
        return corr(x_dev, sink=EdgeCountSink(EDGE_THRESHOLD, labels=labels),
                    max_tiles_per_pass=mtp)

    for mtp, p_ in ((None, plan), (split, splan)):
        got = run(f"EdgeCountSink, {p_.n_pass} pass(es)",
                  lambda: edges(mtp), p_.n_pass)
        if not (got["edges"] == want["edges"]
                and got["intra_edges"] == want["intra_edges"]
                and got["inter_edges"] == got["edges"] - got["intra_edges"]
                and got["degrees"].dtype == np.int64
                and np.array_equal(got["degrees"], want["degrees"])):
            raise AssertionError(f"EdgeCountSink in {p_.n_pass} pass(es): "
                                 f"counts differ from DenseSink's matrix")
        ms, runs, peak = peak_run(lambda: edges(mtp))
        key = "edge_count_1pass" if mtp is None else "edge_count_split"
        out[key + "_ms"], out[key + "_peak_gb"] = ms, peak
        print(f"  EdgeCountSink({EDGE_THRESHOLD}, labels=...), {p_.n_pass} "
              f"pass(es): {got['edges']} edges, {got['intra_edges']} intra, "
              f"degrees equal: DenseSink's counts exactly; corr {ms:.3f} ms "
              f"(runs {[round(v, 3) for v in runs]}), peak {peak:.3f} GB "
              f"above held {tag}")
    del dense
    ms, runs, peak = peak_run(lambda: corr(x_dev))
    out["dense_ms"], out["dense_peak_gb"] = ms, peak
    print(f"  DenseSink for comparison: corr {ms:.3f} ms (runs "
          f"{[round(v, 3) for v in runs]}), peak {peak:.3f} GB above held")

    # ReductionSink: a host numpy row max of off-diagonal |r|
    def row_max(state, ids, tiles, ys, xs, plan_):
        t, nn = plan_.t, plan_.n
        a = np.abs(tiles)
        diag = np.nonzero(ys == xs)[0]
        a[diag[:, None], np.arange(t), np.arange(t)] = -1.0
        edge = nn - (plan_.m - 1) * t          # valid width of the last block
        a[xs == plan_.m - 1, :, edge:] = -1.0
        a[ys == plan_.m - 1, edge:, :] = -1.0
        span = np.arange(t)
        for v, rb in ((a.max(2), ys), (a.max(1), xs)):
            rows = (rb[:, None] * t + span).ravel()
            ok = rows < nn
            np.maximum.at(state, rows[ok], v.ravel()[ok])
        return state

    def reduce():
        return corr(x_dev, sink=ReductionSink(row_max, np.full(
            n, -1.0, np.float32)), max_tiles_per_pass=split)

    got = run(f"ReductionSink, {splan.n_pass} passes", reduce, splan.n_pass)
    dense = corr(x_dev)
    dense.abs_().fill_diagonal_(-1.0)
    want_max = dense.max(1).values.cpu().numpy()
    del dense
    same_bits(got, want_max, "ReductionSink row max")
    ms, runs = host_ms(reduce, 2)
    out["reduction_ms"] = ms
    print(f"  ReductionSink(row max of |r|, host numpy), {splan.n_pass} "
          f"passes: bitwise the row max of DenseSink's off-diagonal |r| "
          f"(min {float(got.min()):.6f}, max {float(got.max()):.6f}); corr "
          f"{ms:.3f} ms (runs {[round(v, 3) for v in runs]})")

    # RowBlockSink: TF rows x Table II, three ranges across tile edges
    cross = corr(x_tf, x_dev).cpu().numpy()
    rplan = ExecutionPlan.create(x_tf.shape[0], x_tf.shape[1], n_cols=n)
    got = run("RowBlockSink", lambda: corr(
        x_tf, x_dev, sink=RowBlockSink(ROW_BLOCKS)), rplan.n_pass)
    for (lo, hi), g in zip(ROW_BLOCKS, got):
        same_bits(g, cross[lo:hi], f"RowBlockSink rows [{lo}, {hi})")
    del got, cross
    ms, runs = host_ms(lambda: corr(x_tf, x_dev,
                                    sink=RowBlockSink(ROW_BLOCKS)), 3)
    out["row_block_ms"] = ms
    print(f"  RowBlockSink({ROW_BLOCKS}), {x_tf.shape[0]} x {n}, "
          f"{rplan.n_pass} pass: each range bitwise DenseSink's rows; corr "
          f"{ms:.3f} ms (runs {[round(v, 3) for v in runs]})")

    # the raw stream, assembled on the host
    def assembled():
        return assemble_from_stream(n, splan.t, splan.m, stream_tiles(
            x_dev, max_tiles_per_pass=split))

    got = run(f"stream_tiles + assemble_from_stream, {splan.n_pass} passes",
              assembled, splan.n_pass)
    same_bits(got, corr(x_dev).cpu().numpy(), "assemble_from_stream")
    del got
    ms, runs = host_ms(assembled, 2)
    out["assemble_ms"] = ms
    print(f"  assemble_from_stream(stream_tiles(x, max_tiles_per_pass="
          f"{split})): {splan.n_pass} launches, bitwise DenseSink's .cpu(); "
          f"{ms:.3f} ms (runs {[round(v, 3) for v in runs]})")

    # the transform cache: Spearman on one card tensor, then changed in
    # place (on a copy of x, so that x stays as the earlier phases had it)
    x_c = x_dev.clone()
    clear_prepared_cache()

    def spearman(label):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = run(label, lambda: corr(x_c, measure="spearman"), 1)
        return r, (time.perf_counter() - t1) * 1e3, prepared_cache_stats()

    first, ms1, st1 = spearman("Spearman, first call")
    second, ms2, st2 = spearman("Spearman, repeat call")
    if (st1["misses"], st1["hits"]) != (1, 0) or \
            (st2["misses"], st2["hits"]) != (1, 1):
        raise AssertionError(f"transform cache: {st1} then {st2}")
    if not torch.equal(first, second):
        raise AssertionError("the cached Spearman run differs")
    del second
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal(
        x_c.shape[1]).astype(np.float32)).to(x_c.device)
    x_c[0] += noise
    changed, ms3, st3 = spearman("Spearman, after an in-place change")
    if (st3["misses"], st3["hits"]) != (2, 1):
        raise AssertionError(f"in-place change: cache {st3}, not a miss")
    clear_prepared_cache()
    fresh = corr(x_c, measure="spearman")
    if not torch.equal(changed, fresh) or torch.equal(changed, first):
        raise AssertionError("the changed tensor's run is not its uncached "
                             "result")
    del first, changed, fresh, x_c
    clear_prepared_cache()
    out.update(spearman_first_ms=ms1, spearman_hit_ms=ms2,
               spearman_changed_ms=ms3)
    print(f"  Spearman corr on one card tensor: first {ms1:.3f} ms (a miss: "
          f"the rank transform), repeat {ms2:.3f} ms (a hit, bitwise the "
          f"first), after x[0] += noise in place {ms3:.3f} ms (a miss, "
          f"bitwise clear_prepared_cache() + corr); one launch each")
    return out


def sm_clock_mhz():
    """(current, maximum) SM clock in MHz, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    cur, top = (float(v) for v in out.split(","))
    return cur, top


def serving_runs(x_dev, x_tf, reset, plain_calls, tag):
    """Phase 24: the serving layer (repro_torch.serving) at full width on
    the Table II corpus, every check fatal.  `reset` sets the kernels'
    launch counts to 0; `plain_calls` counts the plain versions' calls.
    Returns the times (ms), counts and peak memories (GB)."""
    import threading

    import torch
    import repro_torch.core.allpairs as allpairs_mod
    import repro_torch.serving.corpus as corpus_mod
    from repro_torch.core.api import corr
    from repro_torch.core.significance import PermutationSpec
    from repro_torch.core.sinks import TopKSink
    from repro_torch.data.expression import ExpressionSpec, artificial
    from repro_torch.kernels.kendall_merge import kendall_merge_tiles
    from repro_torch.kernels.pcc_tile import pcc_tiles, pcc_topk_tiles
    from repro_torch.serving import DRIFT_TOL, CorrServer, LiveIndex

    t_phase = time.perf_counter()
    out = {}

    def same_dense(got, want, label):
        want = want.cpu().numpy()
        if got.shape != want.shape or got.tobytes() != want.tobytes():
            raise AssertionError(f"{label}: not standalone corr's bits")

    def same_top(got, want, label):
        if not (np.array_equal(got["indices"], want["indices"]) and
                got["values"].tobytes() == want["values"].tobytes()):
            raise AssertionError(f"{label}: not standalone corr's top-k")

    def no_plain(label):
        if any(plain_calls.values()):
            raise AssertionError(f"{label}: a plain version ran "
                                 f"({plain_calls})")

    rng = np.random.default_rng(1)
    n_tf = x_tf.shape[0]
    work = [[(np.sort(rng.choice(n_tf, int(rng.integers(
        1, SERVE_MAX_ROWS + 1)), replace=False)), (c + q) % 2 == 1)
        for q in range(SERVE_QUERIES)] for c in range(SERVE_CLIENTS)]
    requests = SERVE_CLIENTS * SERVE_QUERIES
    srv = CorrServer(x_dev, max_wait_s=SERVE_WAIT_S)
    li = None
    orig_launch = allpairs_mod.launch_tiles
    orig_replica = corpus_mod.replica_operand
    try:
        if srv.corpus.device.type != "cuda":
            raise AssertionError("the served corpus is not on the card")
        # -- concurrent dense and top-k queries --------------------------------
        answers = [[None] * SERVE_QUERIES for _ in range(SERVE_CLIENTS)]
        errors = []

        def client(c):
            try:
                for q, (idx, topk) in enumerate(work[c]):
                    probes = x_tf[torch.as_tensor(idx, device=x_tf.device)]
                    answers[c][q] = (probes, topk, srv.query(
                        probes, k=K_TOP if topk else None, timeout=120))
            except BaseException as e:   # noqa: BLE001 — raised below
                errors.append(e)

        reset()
        kendall0 = kendall_merge_tiles.launches
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        burst_ms = (time.perf_counter() - t0) * 1e3
        if errors:
            raise errors[0]
        torch.cuda.synchronize()
        tiles_by = dict(pcc_tiles.launches_by_dtype)
        select_by = dict(pcc_topk_tiles.select_by_dtype)
        launches = pcc_tiles.launches + pcc_topk_tiles.launches["select"]
        stats = srv.stats()
        print(f"  {requests} queries from {SERVE_CLIENTS} threads "
              f"({SERVE_QUERIES} each, 1-{SERVE_MAX_ROWS} TF rows, half "
              f"top-{K_TOP}) in {burst_ms:.1f} ms: {stats['batches']} "
              f"batches, pcc_tiles {tiles_by}, pcc_topk_tiles "
              f"{dict(pcc_topk_tiles.launches)} select {select_by}, plain "
              f"calls {plain_calls}; plan cache {stats['plan_cache']}; "
              f"corpus transforms {stats['corpus']['misses']}, hits "
              f"{stats['corpus']['hits']}")
        no_plain("served queries")
        if set(k for k, v in tiles_by.items() if v) != {"float32"} or \
                set(k for k, v in select_by.items() if v) != {"float32"} or \
                kendall_merge_tiles.launches != kendall0:
            raise AssertionError("served queries ran other kernels than "
                                 "the float32 tiles and select")
        if not 0 < launches < requests or \
                stats["requests"] != requests or \
                not stats["batches"] < requests:
            raise AssertionError(f"{launches} launches and "
                                 f"{stats['batches']} batches for {requests} "
                                 f"requests: nothing coalesced")
        if stats["corpus"]["misses"] != 1:
            raise AssertionError("the corpus was transformed more than once")
        queue = [a[2].stats["queue_s"] * 1e3 for row in answers for a in row]
        service = [a[2].stats["service_s"] * 1e3 for row in answers
                   for a in row]
        for row in answers:
            for probes, topk, res in row:
                if topk:
                    same_top(res.value, corr(probes, x_dev,
                                             sink=TopKSink(K_TOP)), "top-k")
                else:
                    same_dense(res.value, corr(probes, x_dev), "dense")
        print(f"  every answer bitwise standalone corr(probes, corpus) "
              f"(dense) or corr(..., sink=TopKSink({K_TOP})); queue ms "
              f"median {statistics.median(queue):.3f} max {max(queue):.3f},"
              f" service ms median {statistics.median(service):.3f} max "
              f"{max(service):.3f}; {requests / stats['batches']:.2f} "
              f"requests a batch, {requests / launches:.2f} a launch, mean "
              f"occupancy {stats['mean_batch_occupancy']:.3f}")
        # a repeat shape hits the plan cache (the first repeat may be the
        # first batch of its bucket; the second is not)
        probes0, topk0, _ = answers[0][0]
        for _ in range(2):
            again = srv.query(probes0, k=K_TOP if topk0 else None,
                              timeout=60)
        if not again.stats["plan_cache_hit"]:
            raise AssertionError("a repeat shape missed the plan cache")
        out.update(requests=requests, batches=stats["batches"],
                   launches=launches, burst_ms=burst_ms,
                   queue_ms_median=statistics.median(queue),
                   queue_ms_max=max(queue),
                   service_ms_median=statistics.median(service),
                   service_ms_max=max(service),
                   plan_cache=stats["plan_cache"])

        # -- a Spearman query: a second corpus transform -----------------------
        p16 = x_tf[:SERVE_SIG_ROWS]
        reset()
        sp = srv.query(p16, measure="spearman", timeout=120)
        torch.cuda.synchronize()
        no_plain("Spearman query")
        same_dense(sp.value, corr(p16, x_dev, measure="spearman"),
                   "Spearman")
        if srv.stats()["corpus"]["misses"] != 2:
            raise AssertionError("Spearman did not make one more transform")
        print(f"  Spearman query of {SERVE_SIG_ROWS} TF rows: bitwise "
              f"standalone corr, corpus transforms 2, pcc_tiles "
              f"{dict(pcc_tiles.launches_by_dtype)}")

        # -- a merge-sort Kendall query ---------------------------------------
        k0 = kendall_merge_tiles.launches
        t0 = time.perf_counter()
        km = srv.query(p16, measure="kendall_merge", timeout=300)
        km_ms = (time.perf_counter() - t0) * 1e3
        served_k = kendall_merge_tiles.launches - k0
        same_dense(km.value, corr(p16, x_dev, measure="kendall_merge"),
                   "kendall_merge")
        no_plain("kendall_merge query")
        if served_k < 1:
            raise AssertionError("the Kendall query skipped kendall_merge")
        print(f"  kendall_merge query of {SERVE_SIG_ROWS} TF rows: "
              f"{served_k} kendall_merge_tiles launch(es), bitwise "
              f"standalone corr, {km_ms:.3f} ms served")
        out.update(kendall_ms=km_ms, kendall_launches=served_k)

        # -- significance on the cached null state ------------------------------
        builds = [0]

        def counting_replica(*a, **kw):
            builds[0] += 1
            return orig_replica(*a, **kw)

        corpus_mod.replica_operand = counting_replica
        spec = PermutationSpec(SERVE_B, chunk=SERVE_CHUNK, key=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset()
        t0 = time.perf_counter()
        sig = srv.significance(p16, pvalues=spec)
        torch.cuda.synchronize()
        sig_ms = (time.perf_counter() - t0) * 1e3
        sig_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        rep_launches = pcc_tiles.replica_launches
        no_plain("significance")
        r_, p_ = sig.value
        r_w, p_w = corr(p16, x_dev, pvalues=PermutationSpec(
            SERVE_B, chunk=SERVE_CHUNK, key=0))
        if not (torch.equal(r_, r_w) and torch.equal(p_, p_w)):
            raise AssertionError("served significance is not corr's bits")
        built = builds[0]
        t0 = time.perf_counter()
        sig2 = srv.significance(p16, pvalues=spec)
        torch.cuda.synchronize()
        sig2_ms = (time.perf_counter() - t0) * 1e3
        if not sig2.stats["null_state_hit"] or builds[0] != built or \
                not (torch.equal(sig2.value[0], r_w)
                     and torch.equal(sig2.value[1], p_w)):
            raise AssertionError("the repeat significance query rebuilt "
                                 "its null state or changed its bits")
        print(f"  significance of {SERVE_SIG_ROWS} TF rows, B = {SERVE_B}, "
              f"chunk {SERVE_CHUNK}: (r, p) bitwise corr(pvalues=), "
              f"{rep_launches} replica launches, {built} stack builds, "
              f"{sig_ms:.3f} ms, peak {sig_peak:.3f} GB above the "
              f"{base / 1e9:.3f} GB held; again: null_state_hit, no build, "
              f"{sig2_ms:.3f} ms; cached null chunks "
              f"{srv.corpus.stats()['null_chunks']}")
        out.update(significance_ms=sig_ms, significance_again_ms=sig2_ms,
                   significance_peak_gb=sig_peak, stack_builds=built)
        corpus_mod.replica_operand = orig_replica

        # -- LiveIndex and a watch under an append and an update ---------------
        t0 = time.perf_counter()
        li = LiveIndex(srv.corpus, measure="pearson")
        build_ms = (time.perf_counter() - t0) * 1e3
        w_rows = x_tf[:SERVE_WATCH]
        watch = srv.watch(w_rows, K_TOP)
        same_top(watch.current(), corr(w_rows, x_dev, sink=TopKSink(K_TOP)),
                 "watch, initial")
        seen = []

        def spy(plan, u, j0, launch, v=None):
            seen.append((type(plan.workload).__name__,
                         plan.workload.job_count,
                         threading.current_thread().name))
            return orig_launch(plan, u, j0, launch, v=v)

        allpairs_mod.launch_tiles = spy
        new = torch.from_numpy(artificial(ExpressionSpec(
            n=SERVE_APPEND, l=x_dev.shape[1], seed=5))).to(x_dev.device)
        reset()
        t0 = time.perf_counter()
        srv.corpus.append(new)
        torch.cuda.synchronize()
        append_ms = (time.perf_counter() - t0) * 1e3
        srv.flush_watches(timeout=120)
        no_plain("append")
        n0, t = x_dev.shape[0], srv.batcher.t
        main = [(k, j) for k, j, th in seen if th != "corr-server-dispatch"]
        disp = [(k, j) for k, j, th in seen if th == "corr-server-dispatch"]
        want_main = [("GridWorkload", -(-SERVE_APPEND // t) * -(-n0 // t)),
                     ("TriangularWorkload", 1)]
        if main != want_main or disp != [("GridWorkload", 1)]:
            raise AssertionError(f"append launched {main} (LiveIndex) and "
                                 f"{disp} (watch)")
        cold = corr(srv.corpus.x)
        live = li.result()
        if live["r"].tobytes() != cold.cpu().numpy().tobytes():
            raise AssertionError("the appended LiveIndex is not a cold "
                                 "corr's bits")
        same_top(watch.current(), corr(w_rows, srv.corpus.x,
                                       sink=TopKSink(K_TOP)), "watch, append")
        del cold, live
        print(f"  LiveIndex over {n0} rows built in {build_ms:.1f} ms; an "
              f"append of {SERVE_APPEND} rows launched {main} "
              f"({append_ms:.1f} ms with the merge into the host matrix) "
              f"and the watch {disp}; the index bitwise a cold corr of "
              f"{srv.corpus.n} rows, the watch bitwise its cold top-k")
        upd = np.sort(np.random.default_rng(6).choice(
            srv.corpus.n, SERVE_UPDATE, replace=False))
        rows = torch.from_numpy(artificial(ExpressionSpec(
            n=SERVE_UPDATE, l=x_dev.shape[1], seed=6))).to(x_dev.device)
        seen.clear()
        t0 = time.perf_counter()
        srv.corpus.update(upd, rows)
        torch.cuda.synchronize()
        update_ms = (time.perf_counter() - t0) * 1e3
        srv.flush_watches(timeout=120)
        no_plain("update")
        upd_launches = [(k, j) for k, j, _ in seen]
        cold = corr(srv.corpus.x).cpu().numpy()
        drift = float(np.abs(li.result()["r"] - cold).max())
        del cold
        cold_w = corr(w_rows, srv.corpus.x, sink=TopKSink(K_TOP))
        cur = watch.current()
        w_drift = float(np.abs(cur["values"] - cold_w["values"]).max())
        if not (drift <= DRIFT_TOL and w_drift <= DRIFT_TOL and
                np.array_equal(cur["indices"], cold_w["indices"])):
            raise AssertionError(f"update drifted {drift:.3e} (index), "
                                 f"{w_drift:.3e} (watch) past DRIFT_TOL or "
                                 f"moved the watch's top-k")
        print(f"  an update of {SERVE_UPDATE} rows ({update_ms:.1f} ms; "
              f"launches {upd_launches}, the index's and the watch's): the "
              f"index within "
              f"{drift:.3e} of a cold corr, the watch's top-k indices equal, "
              f"values within {w_drift:.3e} (DRIFT_TOL {DRIFT_TOL:g}); "
              f"watch revalidations {watch.revalidations}")
        out.update(live_build_ms=build_ms, append_ms=append_ms,
                   update_ms=update_ms, update_drift=drift,
                   watch_drift=w_drift)
    finally:
        allpairs_mod.launch_tiles = orig_launch
        corpus_mod.replica_operand = orig_replica
        if li is not None:
            li.close()
        srv.close(timeout=300)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 24 took {out['seconds']:.1f} s {tag}")
    return out


def recovery_runs(x_dev, x_tf, reset, plain_calls, tag):
    """Phase 25: recovery on the card (corr(recovery=), the executor's and
    the sinks' fault sites, HostSink checkpoints, ShardedHostSink,
    LiveIndex(recovery=)), every check fatal.  `reset` sets the pcc
    kernels' launch counts and `plain_calls` to 0.  Returns the times (ms),
    counts and peaks (GB)."""
    import os
    import tempfile

    import torch
    from repro_torch.core.api import corr
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.core.significance import PermutationSpec
    from repro_torch.core.sinks import (DeviceTopKSink, HostSink,
                                        ShardedHostSink, assemble,
                                        open_manifest)
    from repro_torch.data.expression import ExpressionSpec, artificial
    from repro_torch.kernels import kendall_merge as kmm
    from repro_torch.kernels.pcc_tile import pcc_tiles, pcc_topk_tiles
    from repro_torch.runtime import faults
    from repro_torch.runtime.faults import (CrashFault, FaultPlan, FaultSpec,
                                            RetryPolicy)
    from repro_torch.serving import CorpusHandle, LiveIndex

    t_phase = time.perf_counter()
    out = {}
    kendall_plain = kmm.kendall_merge_tiles_plain
    kendall_plain_calls = [0]
    k_base = [kmm.kendall_merge_tiles.launches]

    def counted_kendall_plain(*args, **kwargs):
        kendall_plain_calls[0] += 1
        return kendall_plain(*args, **kwargs)

    def policy():
        return RetryPolicy(sleep=lambda s: None)

    def fresh_counts():
        reset()
        k_base[0] = kmm.kendall_merge_tiles.launches

    def launched(label):
        """The kernels' launches since fresh_counts(); no plain version may
        have run."""
        torch.cuda.synchronize()
        if any(plain_calls.values()) or kendall_plain_calls[0]:
            raise AssertionError(f"{label}: a plain version ran "
                                 f"({plain_calls}, kendall "
                                 f"{kendall_plain_calls[0]})")
        return {"pcc_tiles": pcc_tiles.launches,
                "select": pcc_topk_tiles.launches["select"],
                "merge": pcc_topk_tiles.launches["merge"],
                "kendall_merge": kmm.kendall_merge_tiles.launches - k_base[0]}

    def same_bits(a, b, label):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
        if a.shape != b.shape or not np.array_equal(
                np.ascontiguousarray(a).view(np.uint32),
                np.ascontiguousarray(b).view(np.uint32)):
            raise AssertionError(f"{label}: not the fault-free run's bits")

    def actions(pol):
        return [e["action"] for e in pol.log]

    def shown(pol):
        return [{k: v for k, v in e.items() if k != "error"} for e in pol.log]

    def crashes(label, fn):
        try:
            fn()
        except CrashFault:
            return
        raise AssertionError(f"{label}: the crash did not propagate")

    kmm.kendall_merge_tiles_plain = counted_kendall_plain
    orig_classify = faults.classify_failure
    try:
        # -- 25.1 injected faults at Table II ----------------------------------
        kw = dict(max_tiles_per_pass=REC_SPLIT)
        plan = ExecutionPlan.create(N_SEEK, L_SEEK, **kw)
        half = ExecutionPlan.create(N_SEEK, L_SEEK,
                                    max_tiles_per_pass=REC_SPLIT // 2)
        # launched: pass 0 (arrival 1), passes 0 and 1 (arrivals 4, 5), then
        # every pass of the halved plan but the two that pass 0 covers
        want_launches = 3 + half.n_pass - 2
        for name, sink in (("dense", None),
                           (f"DeviceTopKSink({K_TOP})", DeviceTopKSink)):
            clean = corr(x_dev, sink=None if sink is None else sink(K_TOP),
                         **kw)
            fp = FaultPlan([FaultSpec(*s) for s in REC_FAULTS])
            pol = policy()
            fresh_counts()
            t1 = time.perf_counter()
            with fp.armed():
                got = corr(x_dev, sink=None if sink is None else sink(K_TOP),
                           recovery=pol, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            n = launched(f"25.1 {name}")
            print(f"  25.1 {name} at Table II, {plan.n_pass} passes of <= "
                  f"{REC_SPLIT}, faults {REC_FAULTS}: fired {fp.fired}; log "
                  f"{shown(pol)}; launches {n}; {ms:.1f} ms {tag}")
            key = "pcc_tiles" if sink is None else "select"
            if actions(pol) != ["retry", "retry", "shrink_pass"] or \
                    pol.log[-1]["max_tiles_per_pass"] != REC_SPLIT // 2 or \
                    n[key] != want_launches:
                raise AssertionError(f"25.1 {name}: log {shown(pol)}, "
                                     f"{n[key]} launches (want "
                                     f"{want_launches})")
            if sink is None:
                same_bits(got, clean, "25.1 dense")
            elif not (np.array_equal(got["indices"], clean["indices"]) and
                      got["values"].tobytes() == clean["values"].tobytes()):
                raise AssertionError(f"25.1 {name}: not the fault-free "
                                     f"top-k")
            out["faults_dense_ms" if sink is None else "faults_topk_ms"] = ms
            del clean, got
        out["faults_launches"] = want_launches

        # -- 25.2 a real out-of-memory error -----------------------------------
        def host_peak(mtp):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            r = corr(x_dev, sink=HostSink(), max_tiles_per_pass=mtp)
            torch.cuda.synchronize()
            return r, torch.cuda.max_memory_allocated() - base

        host_one, peak_one = host_peak(None)
        peak_split = host_peak(REC_OOM_SPLIT)[1]
        torch.cuda.empty_cache()
        # the cap counts the allocator's segments, not its blocks: a pass
        # buffer that fits a free block of a segment already held would
        # never meet it.  Ballast takes every free large block (> 1 MiB)
        # first, so each pass buffer needs a new segment.
        ballast = [torch.empty(b["size"], dtype=torch.uint8,
                               device=x_dev.device)
                   for b in sorted((b for seg in torch.cuda.memory_snapshot()
                                    if seg["segment_type"] == "large"
                                    for b in seg["blocks"]
                                    if b["state"] == "inactive"
                                    and b["size"] > 2 ** 20),
                                   key=lambda b: -b["size"])]
        ballast_gb = sum(b.numel() for b in ballast) / 1e9
        reserved = torch.cuda.memory_reserved()
        cap = reserved + (peak_one + peak_split) // 2
        total = torch.cuda.get_device_properties(0).total_memory
        seen = []

        def recording(exc):
            kind = orig_classify(exc)
            seen.append((type(exc).__name__, kind,
                         str(exc).split("\n")[0][:120]))
            return kind

        faults.classify_failure = recording
        pol = policy()
        fresh_counts()
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            t1 = time.perf_counter()
            got = corr(x_dev, sink=HostSink(), recovery=pol)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            faults.classify_failure = orig_classify
            del ballast
        n = launched("25.2")
        real = [e for e in seen
                if e[0] == "OutOfMemoryError" and e[1] == "oom"]
        print(f"  25.2 HostSink() at Table II, peak above held: one pass "
              f"{peak_one / 1e9:.3f} GB, {REC_OOM_SPLIT}-tile passes "
              f"{peak_split / 1e9:.3f} GB; cap {cap / 1e9:.3f} GB "
              f"({reserved / 1e9:.3f} reserved, {ballast_gb:.3f} of it "
              f"ballast, + the midpoint); failures "
              f"{seen}; log {shown(pol)}; launches {n}; {ms:.1f} ms {tag}")
        if not real or any(e["kind"] != "oom" for e in pol.log):
            raise AssertionError(f"25.2: no real torch.cuda.OutOfMemoryError "
                                 f"recovered ({seen}, {pol.log})")
        same_bits(got, host_one, "25.2 capped HostSink()")
        out.update(oom_peak_one_gb=peak_one / 1e9,
                   oom_peak_split_gb=peak_split / 1e9, oom_cap_gb=cap / 1e9,
                   oom_log=shown(pol), oom_ms=ms)
        del host_one, got

        with tempfile.TemporaryDirectory(prefix="recovery_") as tmp:
            # -- 25.3 a checkpoint under faults on the X-vs-Y grid ------------
            gkw = dict(max_tiles_per_pass=REC_GRID_SPLIT)
            gplan = ExecutionPlan.create(N_TF, L_SEEK, n_cols=N_SEEK, **gkw)
            grid = corr(x_tf, x_dev, **gkw).cpu().numpy()
            path = os.path.join(tmp, "grid.mm")
            fp = FaultPlan([FaultSpec(*s) for s in REC_GRID_FAULTS])
            pol = policy()
            fresh_counts()
            with fp.armed():
                crashes("25.3", lambda: corr(
                    x_tf, x_dev, sink=HostSink(path=path), recovery=pol,
                    **gkw))
            n_crash = launched("25.3 crashed")["pcc_tiles"]
            with open(path + ".progress.json") as f:
                done = json.load(f)["completed"]
            fresh_counts()
            t1 = time.perf_counter()
            got = corr(x_tf, x_dev, resume_from=path, recovery=policy(),
                       **gkw)
            ms = (time.perf_counter() - t1) * 1e3
            n = launched("25.3 resumed")["pcc_tiles"]
            print(f"  25.3 HostSink(path=) on the {N_TF} x {N_SEEK} grid, "
                  f"{gplan.n_pass} passes of <= {REC_GRID_SPLIT} "
                  f"({gplan.n_pad * gplan.col_pad * 4 / 1e6:.1f} MB memmap), "
                  f"faults {REC_GRID_FAULTS}: fired {fp.fired}; log "
                  f"{shown(pol)}; {n_crash} launches, sidecar completed "
                  f"{done}; resume_from: {n} launches, {ms:.1f} ms {tag}")
            if actions(pol) != ["retry", "retry", "raise"] or \
                    n != gplan.n_pass - done - 1:
                raise AssertionError(f"25.3: log {shown(pol)}, the resume "
                                     f"launched {n} after pass {done}")
            same_bits(got, grid, "25.3 resumed grid")
            out.update(grid_completed=done, grid_resume_launches=n,
                       grid_resume_ms=ms)
            del grid, got

            # -- 25.4 ShardedHostSink at Table II, REC_HOSTS hosts -------------
            dense = corr(x_dev, **kw).cpu().numpy()
            d = os.path.join(tmp, "shards")

            def shard(h, resume=False, **extra):
                return corr(x_dev, sink=ShardedHostSink(
                    d, host=h, n_hosts=REC_HOSTS, resume=resume), **extra,
                    **kw)

            host_launches = []
            for h in range(REC_HOSTS):
                fresh_counts()
                if h != REC_CRASH_HOST:
                    r = shard(h)
                    host_launches.append(launched("25.4")["pcc_tiles"])
                    if not r["complete"]:
                        raise AssertionError(f"25.4: host {h} incomplete")
                    continue
                fp = FaultPlan([FaultSpec("sink_commit", "crash",
                                          (REC_CRASH_AT,))])
                with fp.armed():
                    crashes("25.4", lambda: shard(h, recovery=policy()))
                crashed = launched("25.4 crashed")["pcc_tiles"]
                probe = ShardedHostSink(d, host=h, n_hosts=REC_HOSTS,
                                        resume=True)
                probe.open(plan, x_dev.device)
                k0, skip = plan.coverage_schedule(probe.covered())
                lacks = [k for k in range(k0, plan.n_pass) if k not in skip]
                fresh_counts()
                r = shard(h, resume=True)
                resumed = launched("25.4 resumed")["pcc_tiles"]
                if resumed != len(lacks) or not r["complete"]:
                    raise AssertionError(f"25.4: the resume launched "
                                         f"{resumed}, the manifest lacks "
                                         f"passes {lacks}")
                host_launches.append((crashed, resumed))
            ranges = [plan.host_tile_range(h, REC_HOSTS)
                      for h in range(REC_HOSTS)]
            files_mb = sum(os.path.getsize(os.path.join(d, f))
                           for f in os.listdir(d)) / 1e6
            t1 = time.perf_counter()
            whole = assemble(d)
            ms = (time.perf_counter() - t1) * 1e3
            same_bits(whole, dense, "25.4 assemble")
            del whole
            same_bits(open_manifest(d).rows(0, N_TF), dense[:N_TF],
                      "25.4 open_manifest rows")
            print(f"  25.4 ShardedHostSink at Table II, {REC_HOSTS} hosts, "
                  f"ranges {ranges}, launches per host {host_launches} (host "
                  f"{REC_CRASH_HOST} crashed at sink_commit {REC_CRASH_AT}, "
                  f"then resumed: the passes its manifest lacked, {lacks}); "
                  f"{files_mb:.1f} MB of files; assemble {ms:.1f} ms, "
                  f"bitwise DenseSink's .cpu(), rows 0-{N_TF} too {tag}")
            out.update(shard_launches=host_launches, shard_mb=files_mb,
                       assemble_ms=ms)
            del dense

            # -- 25.5 Kendall and significance ---------------------------------
            kkw = dict(measure="kendall_merge",
                       max_tiles_per_pass=REC_KENDALL_SPLIT)
            kplan = ExecutionPlan.create(N_TF, L_SEEK, **kkw)
            clean = corr(x_tf, **kkw)
            fp = FaultPlan([FaultSpec("pass_launch", "transient", (2,))])
            pol = policy()
            fresh_counts()
            with fp.armed():
                got = corr(x_tf, recovery=pol, **kkw)
            n = launched("25.5 kendall")
            print(f"  25.5 kendall_merge over the TF rows, {kplan.n_pass} "
                  f"passes of <= {REC_KENDALL_SPLIT}: fired {fp.fired}; log "
                  f"{shown(pol)}; launches {n} {tag}")
            if actions(pol) != ["retry"] or n["pcc_tiles"] or \
                    n["kendall_merge"] != kplan.n_pass + 1:
                raise AssertionError(f"25.5 kendall: {shown(pol)}, {n}")
            same_bits(got, clean, "25.5 kendall_merge")
            del clean, got
            skw = dict(max_tiles_per_pass=REC_KENDALL_SPLIT)
            splan = ExecutionPlan.create(N_TF, L_SEEK, **skw)

            def spec(sink=None):
                return PermutationSpec(SERVE_B, key=0, chunk=SERVE_CHUNK,
                                       sink=sink)

            p_clean = corr(x_tf, pvalues=spec(), **skw)[1].cpu().numpy()
            ppath = os.path.join(tmp, "p.mm")
            fp = FaultPlan([FaultSpec("sink_commit", "crash",
                                      (REC_SIG_CRASH_AT,))])
            with fp.armed():
                crashes("25.5 significance", lambda: corr(
                    x_tf, pvalues=spec(HostSink(path=ppath)), **skw))
            with open(ppath + ".progress.json") as f:
                pdone = json.load(f)["completed"]
            fresh_counts()
            p_res = corr(x_tf, pvalues=spec(HostSink(path=ppath,
                                                     resume=True)), **skw)[1]
            n = launched("25.5 significance")["pcc_tiles"]
            reps = pcc_tiles.replica_launches
            want_reps = (splan.n_pass - pdone - 1) * -(-SERVE_B //
                                                       SERVE_CHUNK)
            print(f"  25.5 significance of the TF rows at B = {SERVE_B}, "
                  f"chunk {SERVE_CHUNK}, {splan.n_pass} passes, p over "
                  f"HostSink(path=): crashed at sink_commit "
                  f"{REC_SIG_CRASH_AT} (completed {pdone}), resumed: {n} "
                  f"launches, {reps} of them replica launches (the passes "
                  f"the sidecar lacked); p bitwise the uninterrupted run's "
                  f"{tag}")
            if reps != want_reps or n != splan.n_pass + reps:
                raise AssertionError(f"25.5: {n} launches, {reps} replica "
                                     f"launches, want {want_reps}")
            same_bits(p_res, p_clean, "25.5 resumed p")
            out.update(sig_completed=pdone, sig_replica_launches=reps)
            del p_clean, p_res

        # -- 25.6 LiveIndex(recovery=) on the Table II corpus ---------------------
        handle = CorpusHandle(x_dev)
        li = LiveIndex(handle, measure="pearson", recovery=policy())
        try:
            new = torch.from_numpy(artificial(ExpressionSpec(
                n=SERVE_APPEND, l=x_dev.shape[1], seed=5))).to(x_dev.device)
            fp = FaultPlan([FaultSpec("pass_launch", "transient", (1,))])
            fresh_counts()
            t1 = time.perf_counter()
            with fp.armed():
                handle.append(new)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            n = launched("25.6")
            same_bits(li.result()["r"], corr(handle.x), "25.6 LiveIndex")
            print(f"  25.6 LiveIndex(recovery=) on the Table II corpus, an "
                  f"append of {SERVE_APPEND} rows: fired {fp.fired}; log "
                  f"{shown(li.recovery)}; launches {n} (the grid, then the "
                  f"triangle); {ms:.1f} ms; bitwise a cold corr of "
                  f"{handle.n} rows {tag}")
            if fp.fired != [("pass_launch", 1, "transient")] or \
                    actions(li.recovery) != ["retry"] or \
                    n["pcc_tiles"] != 2:
                raise AssertionError(f"25.6: {fp.fired}, {li.recovery.log}, "
                                     f"{n}")
            out["live_append_ms"] = ms
        finally:
            li.close()

        # -- 25.7 recovery armed, no faults ----------------------------------------
        dense_ms, dense_all = host_ms(lambda: corr(x_dev, **kw), 3)
        armed_ms, armed_all = host_ms(lambda: corr(
            x_dev, recovery=policy(), **kw), 3)
        print(f"  25.7 Table II dense corr, {plan.n_pass} passes: "
              f"{dense_ms:.3f} ms (runs {[round(v, 3) for v in dense_all]}); "
              f"with recovery=RetryPolicy() and no fault {armed_ms:.3f} ms "
              f"(runs {[round(v, 3) for v in armed_all]}) {tag}")
        out.update(dense_ms=dense_ms, armed_ms=armed_ms)
    finally:
        kmm.kendall_merge_tiles_plain = kendall_plain
        faults.classify_failure = orig_classify
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 25 took {out['seconds']:.1f} s {tag}")
    return out


def mesh_runs(x_dev, x_tf, reset, plain_calls, tag):
    """Phase 26: the mesh at full width, every check fatal.  `reset` sets
    the pcc kernels' launch counts and `plain_calls` to 0.  Returns the
    mesh's layout and, per case, the wall times (ms) of the mesh and the
    one-device runs, the mesh run's launches and its peak memory per
    device (GB)."""
    import os
    import tempfile

    import torch
    from repro_torch.core.api import corr
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.core.significance import PermutationSpec
    from repro_torch.core.sinks import DeviceTopKSink, ShardedHostSink, \
        TopKSink, assemble
    from repro_torch.kernels import kendall_merge as kmm
    from repro_torch.kernels.pcc_tile import pcc_tiles, pcc_topk_tiles
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.runtime.faults import CrashFault, FaultPlan, RetryPolicy
    from repro_torch.serving import CorrServer

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        devices = [torch.device("cuda", i) for i in range(n_cards)]
        peer = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
                for i in range(n_cards) for j in range(n_cards) if i != j}
        layout = f"{n_cards} cards, one rank each"
        print(f"  26: {layout}; can_device_access_peer {peer}")
    else:
        devices = [torch.device("cuda", 0)] * MESH_LOGICAL
        peer = None
        layout = f"{MESH_LOGICAL} logical ranks on cuda:0 (one card)"
        print(f"  26: {layout}: the wall times below show the mesh "
              f"machinery's cost on one card, not scaling; no speed-up "
              f"is claimed")
    mesh = make_mesh((len(devices),), ("d",), devices=devices)
    p = mesh.size
    print(f"  {describe(mesh)}")
    out = {"layout": layout, "p": p, "peer_access": peer}
    kendall_plain = kmm.kendall_merge_tiles_plain
    kendall_plain_calls = [0]
    k_base = [0]

    def counted_kendall_plain(*args, **kwargs):
        kendall_plain_calls[0] += 1
        return kendall_plain(*args, **kwargs)

    def sync():
        for d in mesh.distinct_devices:
            torch.cuda.synchronize(d)

    def fresh_counts():
        reset()
        kendall_plain_calls[0] = 0
        k_base[0] = kmm.kendall_merge_tiles.launches

    def launched(label):
        sync()
        if any(plain_calls.values()) or kendall_plain_calls[0]:
            raise AssertionError(f"{label}: a plain version ran "
                                 f"({plain_calls}, kendall "
                                 f"{kendall_plain_calls[0]})")
        return {"pcc_tiles": pcc_tiles.launches,
                "replica": pcc_tiles.replica_launches,
                "select": pcc_topk_tiles.launches["select"],
                "merge": pcc_topk_tiles.launches["merge"],
                "kendall_merge": kmm.kendall_merge_tiles.launches - k_base[0],
                "by_dtype": {k: v for k, v in
                             pcc_tiles.launches_by_dtype.items() if v}}

    def rank_launches(plan):
        """One launch a rank with tiles in a pass."""
        return sum(1 for k in range(plan.n_pass)
                   for _, c in plan.rank_slots(k) if c)

    def folds(plan):
        """DeviceTopKSink's folds of the rank states: one merge a side
        (rows; on the triangle also the mirrored columns) a pass of two or
        more pieces."""
        sides = 1 if plan.workload.grid_cols is not None else 2
        return sides * sum(1 for k in range(plan.n_pass)
                           if sum(1 for _, c in plan.rank_slots(k) if c) > 1)

    def host(a):
        if isinstance(a, torch.Tensor):
            return a.cpu().numpy()
        if isinstance(a, (tuple, list)):
            return [host(v) for v in a]
        if isinstance(a, dict):
            return {k: host(v) for k, v in a.items()
                    if k in ("indices", "values")}
        return np.asarray(a)

    def same_bits(a, b, label):
        a, b = host(a), host(b)
        if isinstance(a, dict):
            a, b = [a["indices"], a["values"]], [b["indices"], b["values"]]
        if not isinstance(a, list):
            a, b = [a], [b]
        for x, y in zip(a, b):
            x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
            if x.shape != y.shape or x.dtype != y.dtype or \
                    x.tobytes() != y.tobytes():
                raise AssertionError(f"{label}: the mesh run is not the "
                                     f"one-device run's bits")

    def case(label, mesh_fn, one_fn, want):
        """Run mesh_fn with the counts from 0, check its launches against
        `want` (key -> count), its bits against one_fn's, then time both
        (host clock, synchronized)."""
        sync()
        base = {}
        for d in mesh.distinct_devices:
            torch.cuda.reset_peak_memory_stats(d)
            base[d] = torch.cuda.memory_allocated(d)
        fresh_counts()
        got = mesh_fn()
        n = launched(label)
        peak = {str(d): round((torch.cuda.max_memory_allocated(d)
                               - base[d]) / 1e9, 3)
                for d in mesh.distinct_devices}
        bad = {k: (n[k], v) for k, v in want.items() if n[k] != v}
        if bad:
            raise AssertionError(f"{label}: launches (got, want) {bad}")
        same_bits(got, one_fn(), label)
        del got
        mesh_ms, mesh_all = host_ms(mesh_fn, MESH_REPS)
        one_ms, one_all = host_ms(one_fn, MESH_REPS)
        print(f"  {label}: bitwise the one-device run; launches {n}; "
              f"mesh {mesh_ms:.3f} ms (runs "
              f"{[round(v, 3) for v in mesh_all]}), one device "
              f"{one_ms:.3f} ms (runs {[round(v, 3) for v in one_all]}); "
              f"peak GB per device {peak} {tag}")
        out[label] = {"mesh_ms": mesh_ms, "one_ms": one_ms,
                      "launches": n, "peak_gb": peak}

    kmm.kendall_merge_tiles_plain = counted_kendall_plain
    try:
        one = ExecutionPlan.create(N_SEEK, L_SEEK, p=p)
        split = ExecutionPlan.create(N_SEEK, L_SEEK, p=p,
                                     max_tiles_per_pass=SPLIT)
        print(f"  Table II over {p} ranks: per rank "
              f"{[hi - lo for lo, hi in one.device_ranges]} tiles; "
              f"{SPLIT}-tile passes {split.launch_sizes}")
        # -- 26.1 dense, one pass and SPLIT-tile passes; shard_u -----------
        case("dense, one pass", lambda: corr(x_dev, mesh=mesh),
             lambda: corr(x_dev), {"pcc_tiles": rank_launches(one)})
        case(f"dense, {SPLIT}-tile passes",
             lambda: corr(x_dev, mesh=mesh, max_tiles_per_pass=SPLIT),
             lambda: corr(x_dev, max_tiles_per_pass=SPLIT),
             {"pcc_tiles": rank_launches(split)})
        case(f"shard_u=True, {SPLIT}-tile passes",
             lambda: corr(x_dev, mesh=mesh, shard_u=True,
                          max_tiles_per_pass=SPLIT),
             lambda: corr(x_dev, max_tiles_per_pass=SPLIT),
             {"pcc_tiles": rank_launches(split)})
        # -- 26.2 top-k ---------------------------------------------------
        case(f"DeviceTopKSink({K_TOP})",
             lambda: corr(x_dev, mesh=mesh, sink=DeviceTopKSink(K_TOP)),
             lambda: corr(x_dev, sink=DeviceTopKSink(K_TOP)),
             {"select": rank_launches(one),
              "merge": rank_launches(one) + folds(one), "pcc_tiles": 0})
        # -- 26.3 the X-vs-Y grid ----------------------------------------
        grid = ExecutionPlan.create(N_TF, L_SEEK, n_cols=N_SEEK, p=p)
        print(f"  {N_TF} x {N_SEEK} grid: {grid.total_tiles} tiles, per "
              f"rank {[hi - lo for lo, hi in grid.device_ranges]}")
        case("grid dense", lambda: corr(x_tf, x_dev, mesh=mesh),
             lambda: corr(x_tf, x_dev), {"pcc_tiles": rank_launches(grid)})
        case(f"grid DeviceTopKSink({K_TOP})",
             lambda: corr(x_tf, x_dev, mesh=mesh,
                          sink=DeviceTopKSink(K_TOP)),
             lambda: corr(x_tf, x_dev, sink=DeviceTopKSink(K_TOP)),
             {"select": rank_launches(grid),
              "merge": rank_launches(grid) + folds(grid)})
        # -- 26.4 narrow operands -------------------------------------------
        case("bf16 Pearson dense",
             lambda: corr(x_dev, mesh=mesh, compute_dtype=torch.bfloat16),
             lambda: corr(x_dev, compute_dtype=torch.bfloat16),
             {"pcc_tiles": rank_launches(one)})
        x_k = x_dev[:, :L_KENDALL].contiguous()
        kplan = ExecutionPlan.create(N_SEEK, L_KENDALL, measure="kendall",
                                     compute_dtype=torch.int8, p=p)
        case(f"int8 Kendall dense ({L_KENDALL} samples)",
             lambda: corr(x_k, mesh=mesh, measure="kendall",
                          compute_dtype=torch.int8),
             lambda: corr(x_k, measure="kendall", compute_dtype=torch.int8),
             {"pcc_tiles": rank_launches(kplan)})
        if out[f"int8 Kendall dense ({L_KENDALL} samples)"]["launches"][
                "by_dtype"] != {"int8": rank_launches(kplan)}:
            raise AssertionError("int8 Kendall did not run the int8 kernel")
        # -- 26.5 merge-sort Kendall over the TF rows -----------------------
        tfk = ExecutionPlan.create(N_TF, L_SEEK, measure="kendall", p=p)
        case("TF kendall_merge triangle",
             lambda: corr(x_tf, mesh=mesh, measure="kendall"),
             lambda: corr(x_tf, measure="kendall"),
             {"kendall_merge": rank_launches(tfk), "pcc_tiles": 0})
        # -- 26.6 significance ------------------------------------------------
        spec = PermutationSpec(MESH_B, key=0, chunk=MESH_CHUNK)
        tfs = ExecutionPlan.create(N_TF, L_SEEK, p=p, replicas=MESH_B,
                                   replica_chunk=MESH_CHUNK)
        chunks = len(tfs.replica_chunk_sizes)
        case(f"TF significance, B = {MESH_B}",
             lambda: corr(x_tf, mesh=mesh, pvalues=spec),
             lambda: corr(x_tf, pvalues=spec),
             {"pcc_tiles": (1 + chunks) * rank_launches(tfs),
              "replica": chunks * rank_launches(tfs)})
        # -- 26.7 ShardedHostSink, two hosts, one crashed and resumed --------
        n_hosts = 2 if p % 2 == 0 else p
        dense = corr(x_dev, max_tiles_per_pass=SPLIT).cpu().numpy()
        with tempfile.TemporaryDirectory() as d:
            fresh_counts()
            t1 = time.perf_counter()
            for h in range(n_hosts):
                snk = ShardedHostSink(d, host=h, n_hosts=n_hosts)
                if h == MESH_CRASH_HOST:
                    try:
                        with FaultPlan.single("sink_commit", "crash",
                                              at=MESH_CRASH_AT).armed():
                            corr(x_dev, mesh=mesh, sink=snk,
                                 max_tiles_per_pass=SPLIT)
                    except CrashFault:
                        pass
                    else:
                        raise AssertionError("26.7: the crash did not "
                                             "propagate")
                    snk = ShardedHostSink(d, host=h, n_hosts=n_hosts,
                                          resume=True)
                res = corr(x_dev, mesh=mesh, sink=snk,
                           max_tiles_per_pass=SPLIT)
                if not res["complete"] or res["range"] != \
                        split.host_tile_range(h, n_hosts):
                    raise AssertionError(f"26.7: host {h}: {res}")
            n = launched("26.7")
            ms = (time.perf_counter() - t1) * 1e3
            same_bits(assemble(d), dense, "26.7 assemble")
        print(f"  ShardedHostSink over {n_hosts} hosts of {p} ranks, host "
              f"{MESH_CRASH_HOST} crashed at manifest commit "
              f"{MESH_CRASH_AT} and resumed: assemble bitwise DenseSink's "
              f".cpu(); launches {n}; {ms:.1f} ms {tag}")
        out["sharded"] = {"ms": ms, "launches": n, "hosts": n_hosts}
        del dense
        # -- 26.8 recovery: a lost device shrinks the mesh -------------------
        pol = RetryPolicy(sleep=lambda s: None)
        fp = FaultPlan.single("pass_launch", "device_loss", at=MESH_LOSS_AT)
        fresh_counts()
        t1 = time.perf_counter()
        with fp.armed():
            got = corr(x_dev, mesh=mesh, recovery=pol,
                       max_tiles_per_pass=SPLIT)
        n = launched("26.8")
        ms = (time.perf_counter() - t1) * 1e3
        log = [{k: v for k, v in e.items() if k != "error"}
               for e in pol.log]
        if fp.fired != [("pass_launch", MESH_LOSS_AT, "device_loss")] or \
                [(e["action"], e["p"]) for e in log] != \
                [("shrink_mesh", p - 1)]:
            raise AssertionError(f"26.8: {fp.fired}, {log}")
        same_bits(got, corr(x_dev, max_tiles_per_pass=SPLIT), "26.8")
        del got
        print(f"  recovery=: device_loss at pass_launch {MESH_LOSS_AT}, log "
              f"{log}, bitwise the fault-free run; launches {n}; "
              f"{ms:.1f} ms {tag}")
        out["device_loss"] = {"ms": ms, "launches": n, "log": log}
        # -- 26.9 serving over the mesh --------------------------------------
        rng = np.random.default_rng(7)
        sizes = rng.integers(1, 65, MESH_QUERIES)
        fresh_counts()
        t1 = time.perf_counter()
        with CorrServer(x_dev, max_wait_s=SERVE_WAIT_S, mesh=mesh) as srv:
            futs = []
            for i, m in enumerate(sizes):
                rows = np.sort(rng.choice(N_TF, int(m), replace=False))
                q = x_tf[torch.as_tensor(rows, device=x_tf.device)]
                k = K_TOP if i % 2 else None
                futs.append((q, k, srv.submit(q, k=k)))
            answers = [(q, k, f.result(timeout=120)) for q, k, f in futs]
            stats = srv.stats()
        ms = (time.perf_counter() - t1) * 1e3
        n = launched("26.9")
        if n["pcc_tiles"] + n["select"] == 0:
            raise AssertionError("26.9: no kernel launched")
        for i, (q, k, a) in enumerate(answers):
            if k is None:
                want = corr(q, x_dev, mesh=mesh)
                same_bits(a.value, want, f"26.9 query {i}")
                same_bits(a.value, corr(q, x_dev), f"26.9 query {i}")
            else:
                same_bits(a.value, corr(q, x_dev, mesh=mesh,
                                        sink=TopKSink(k)), f"26.9 query {i}")
        ho = stats["host_occupancy"]
        if ho is None or len(ho) != p:
            raise AssertionError(f"26.9: host_occupancy {ho}")
        print(f"  CorrServer(mesh=): {MESH_QUERIES} TF queries of "
              f"{sizes.tolist()} rows, half top-{K_TOP}, every answer "
              f"bitwise standalone corr; launches {n}; "
              f"{stats['batches']} batches; host_occupancy "
              f"{[round(v, 4) for v in ho]}; {ms:.1f} ms {tag}")
        out["serving"] = {"ms": ms, "launches": n, "host_occupancy": ho,
                          "batches": stats["batches"]}
    finally:
        kmm.kendall_merge_tiles_plain = kendall_plain
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 26 took {out['seconds']:.1f} s {tag}")
    return out


def lm_runs(dev, tag):
    """Phase 27, LM serving on the card (see LM_ARCHS): returns the flash
    rows of the kernels record (the LM prefills' launches) and the
    phase's numbers."""
    import torch

    from repro_torch.configs import get_config, override
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.launch.serve import serve, summary
    from repro_torch.models import layers, ssm, steps
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import layer_runs

    t_phase = time.perf_counter()
    flash_route, plain_route = layers._flash_route, layers._plain_route
    calls = {"plain_route": 0, "flash_attention_plain": 0}
    # the plain attention of the encoder and the cross-attention, counted
    # apart: an encoder-decoder's prefill runs both by design
    enc_attn, cross_attn = layers.encoder_attention_apply, \
        layers.cross_attention_apply
    bidir = {"encoder": 0, "cross": 0}
    records, recording = [], [0]   # keep up to recording[0] layers

    def counted_encoder(*args, **kwargs):
        bidir["encoder"] += 1
        return enc_attn(*args, **kwargs)

    def counted_cross(*args, **kwargs):
        bidir["cross"] += 1
        return cross_attn(*args, **kwargs)

    def counted_plain_route(*args, **kwargs):
        calls["plain_route"] += 1
        return plain_route(*args, **kwargs)

    def counted_flash_plain(*args, **kwargs):
        calls["flash_attention_plain"] += 1
        return flash_attention_plain(*args, **kwargs)

    def recorded_flash_route(cfg_, q, k, v, window):
        out = flash_route(cfg_, q, k, v, window)
        if len(records) < recording[0]:
            records.append((q, k, v, window, out))
        return out

    def plain_instead(cfg_, q, k, v, window):
        """The attention route replaced by its plain version: the
        reference's sdpa / _chunked_sdpa at positions 0..S-1."""
        pos = torch.arange(q.shape[1], device=q.device)[None, :].expand(
            q.shape[0], -1)
        return plain_route(cfg_, q, k, v, pos, window)

    def reset():
        flash_attention.launches = 0
        flash_attention.launches_by_dtype = {
            k: 0 for k in flash_attention.launches_by_dtype}
        for k in calls:
            calls[k] = 0
        for k in bidir:
            bidir[k] = 0
        routed.clear()

    def peak(fn):
        """fn()'s result, its host-clock ms to a synchronised card, and its
        peak device memory above what was allocated before it, in GB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        return out, ms, (torch.cuda.max_memory_allocated() - before) / 1e9

    def timed(fn, reps):
        """(median ms, all ms, largest peak GB) of `reps` runs of fn(),
        each result dropped before the next."""
        def drop():     # the result is freed on return
            fn()
        times, peaks = [], []
        for _ in range(reps):
            _, ms, gb = peak(drop)
            times.append(ms)
            peaks.append(gb)
        return statistics.median(times), times, max(peaks)

    def route_check(cfg_, what):
        return route_gate(records, plain_route, cfg_, what)

    def flash_row(arch, q, k, v, window, launches, label):
        return flash_record(arch, q, k, v, window, launches, label, tag)

    def class_rows(arch, cfg_, s_):
        """A row for the first recorded layer of each window class, its
        launches those of the class's layers in one prefill."""
        rows, seen = [], set()
        for q, k, v, window, _ in records:
            if window in seen:
                continue
            seen.add(window)
            label = f"S={s_} " + (f"window {window}" if window
                                  else "causal")
            rows.append(flash_row(arch, q, k, v, window,
                                  cfg_.layer_windows().count(window),
                                  label))
        return rows

    moe_route = layers.moe_route
    routed = []      # (assignments kept, assignments) a moe_route call

    def recorded_route(cfg_, router, x, cap):
        """moe_route, its keep mask kept on the card (read after the run:
        no host sync inside a timed region)."""
        res = moe_route(cfg_, router, x, cap)
        routed.append(res[3])
        return res

    def dropped(calls_):
        """The share of routed assignments dropped over `calls_`."""
        kept = sum(int(c.sum()) for c in calls_)
        return 1 - kept / max(sum(c.numel() for c in calls_), 1)

    def by_layer(calls_):
        return [round(dropped([c]), 4) for c in calls_]

    def prefill_checked(arch, cfg_, params, toks, capacity, inputs=None):
        """A prefill of `toks` (or of `inputs`, the prefill's keywords) into
        caches of `capacity` slots, every layer's flash inputs recorded: one
        flash launch a (decoder) layer in the activations' dtype, no plain
        call, the layers' windows, finite logits.  Returns (logits, caches,
        launches)."""
        n_attn = cfg_.n_layers
        dname = str(cfg_.activation_dtype()).removeprefix("torch.")
        inputs = inputs or {"tokens": toks}
        reset()
        records.clear()
        recording[0] = n_attn
        logits, cache = steps.make_prefill_step(
            cfg_, cache_capacity=capacity)(params, **inputs)
        torch.cuda.synchronize()
        recording[0] = 0
        lb = dict(flash_attention.launches_by_dtype)
        if lb[dname] != n_attn or sum(lb.values()) != n_attn or \
                any(calls.values()) or len(records) != n_attn:
            raise AssertionError(f"{arch} {dname} prefill: flash launches "
                                 f"{lb}, plain calls {calls}")
        if [r[3] for r in records] != list(cfg_.layer_windows()):
            raise AssertionError(f"{arch}: the layers' windows reached the "
                                 f"kernel wrong")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: non-finite prefill logits")
        return logits, cache, lb

    def decode_checked(arch, cfg_, params, toks, cache):
        """One decode step after the prefill of `toks`: it launches no
        flash kernel and gives finite logits."""
        before = dict(flash_attention.launches_by_dtype)
        step_logits, _ = steps.make_decode_step(cfg_)(
            params, token=toks[:, -1:], cache=cache,
            cache_index=toks.shape[1])
        torch.cuda.synchronize()
        if dict(flash_attention.launches_by_dtype) != before or \
                not bool(torch.isfinite(step_logits).all()):
            raise AssertionError(f"{arch}: decode launched the flash kernel "
                                 f"or gave non-finite logits")

    def decode_vs_forward(cfg_, params, toks, logits):
        """max |last logits of decode after a prefill of S - 1 - the full
        forward's `logits`|."""
        _, cache = steps.make_prefill_step(
            cfg_, cache_capacity=toks.shape[1] + LM_GEN)(
                params, tokens=toks[:, :-1])
        step_logits, _ = steps.make_decode_step(cfg_)(
            params, token=toks[:, -1:], cache=cache,
            cache_index=toks.shape[1] - 1)
        return amax((step_logits - logits).abs())

    def draw(cfg_):
        """Parameters from torch.Generator seed 0 on the card: (params,
        their count and GB, seconds)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = build_model(cfg_).init(
            torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        return params, {
            "params": sum(p.numel() for p in params.parameters()),
            "params_gb": (torch.cuda.memory_allocated() - base) / 1e9}, \
            time.perf_counter() - t0

    def serve_checked(arch, cfg_, params):
        """(a) serve() at its defaults after a warm-up run: exactly one bf16
        flash launch a layer in its prefill, none in decode, no plain
        version, tokens of the right shape, finite logits.  Returns (its
        numbers, the launches, the result)."""
        n_attn = cfg_.n_layers
        serve(cfg_, batch=LM_BATCH, prompt_len=LM_SERVE_PROMPT, gen=LM_GEN,
              device=dev, params=params)   # warm-up
        reset()
        sv, _, sv_peak = peak(lambda: serve(
            cfg_, batch=LM_BATCH, prompt_len=LM_SERVE_PROMPT, gen=LM_GEN,
            device=dev, params=params))
        lb = dict(flash_attention.launches_by_dtype)
        if lb["bfloat16"] != n_attn or sum(lb.values()) != n_attn or \
                any(calls.values()):
            raise AssertionError(f"{arch} serve: flash launches {lb}, plain "
                                 f"calls {calls}: want {n_attn} bf16 "
                                 f"launches (its prefill), none in decode, "
                                 f"no plain version")
        if tuple(sv["tokens"].shape) != (LM_BATCH, LM_GEN) or \
                not bool(torch.isfinite(sv["first_logits"]).all()):
            raise AssertionError(f"{arch} serve: bad output")
        return {"prefill_ms": sv["prefill_s"] * 1e3,
                "decode_ms_per_step": sv["decode_s"] * 1e3 / (LM_GEN - 1),
                "tok_s": sv["tok_s"], "peak_gb": sv_peak}, lb, sv

    def moe_arch(arch, n_layers, prompt):
        """Phase 27 for a MoE config at full width and `n_layers` layers:
        serve, a prefill of `prompt` tokens (launches, windows, the route
        gates, bitwise repeat, ms, one layer's parts), the full-width
        routing on the card against the CPU, drop shares, decode against
        the full forward in float32 where nothing drops.  Returns its flash
        rows and numbers."""
        cfg = override(get_config(arch), n_layers=n_layers)
        mrows = []
        params, res, draw_s = draw(cfg)
        print(f"  {arch} FULL width, {n_layers} of "
              f"{get_config(arch).n_layers} layers: d_model {cfg.d_model}, "
              f"H {cfg.n_heads}, Hkv {cfg.n_kv_heads}, hd {cfg.hd}, "
              f"windows {sorted(set(cfg.layer_windows()))}, {cfg.n_experts}"
              f" experts of d_ff {cfg.moe_d_ff}, top-{cfg.top_k}, capacity "
              f"factor {cfg.capacity_factor:g}, {cfg.moe_impl}; "
              f"{res['params']:,} parameters, {res['params_gb']:.3f} GB "
              f"float32 drawn in {draw_s:.1f} s; {cfg.dtype} activations "
              f"{tag}")

        # (a) the entry point's defaults, drop shares at the config's factor
        res["serve"], lb, sv = serve_checked(arch, cfg, params)
        if len(routed) != n_layers * LM_GEN:
            raise AssertionError(f"{arch} serve: {len(routed)} MoE calls")
        drop_pre, drop_dec = dropped(routed[:n_layers]), \
            dropped(routed[n_layers:])
        res["serve"].update(dropped_prefill=drop_pre,
                            dropped_decode=drop_dec)
        print(f"  (a) launch.serve batch {LM_BATCH}, prompt "
              f"{LM_SERVE_PROMPT}, gen {LM_GEN} (after a warm-up run): "
              f"{summary(sv)}; prefill {sv['prefill_s'] * 1e3:.3f} ms, "
              f"decode {res['serve']['decode_ms_per_step']:.3f} ms a step, "
              f"{sv['tok_s']:.1f} tok/s; flash launches {lb}; assignments "
              f"dropped at capacity factor {cfg.capacity_factor:g}: prefill "
              f"{drop_pre:.4f} (capacity "
              f"{layers.moe_capacity(cfg, LM_BATCH * LM_SERVE_PROMPT)}), "
              f"decode {drop_dec:.4f} (capacity "
              f"{layers.moe_capacity(cfg, LM_BATCH)}); peak "
              f"{res['serve']['peak_gb']:.3f} GB above held {tag}")

        # (b) one prompt: launches, windows, bitwise repeat, ms
        g = torch.Generator(device=dev).manual_seed(2)
        toks = torch.randint(0, cfg.vocab, (1, prompt), generator=g,
                             device=dev)
        logits_f, cache, lb = prefill_checked(arch, cfg, params, toks,
                                              prompt + LM_GEN)
        drop_b, drop_layers = dropped(routed), by_layer(routed)
        prefill = steps.make_prefill_step(cfg,
                                          cache_capacity=prompt + LM_GEN)
        logits_2, cache_2 = prefill(params, tokens=toks)
        same = torch.equal(logits_f, logits_2) and all(
            torch.equal(c1[n], c2[n]) for c1, c2 in zip(cache, cache_2)
            for n in c1)
        del logits_2, cache_2
        if not same:
            raise AssertionError(f"{arch}: two prefills on the card differ")
        decode_checked(arch, cfg, params, toks, cache)
        del cache
        pre_ms, pre_all, pb = timed(lambda: prefill(params, tokens=toks), 3)
        res["prefill"] = {"tokens": prompt, "ms": pre_ms, "runs": pre_all,
                          "peak_gb": pb, "launches": lb["bfloat16"],
                          "dropped": drop_b, "dropped_by_layer": drop_layers,
                          "bitwise_repeat": same}
        print(f"  (b) prefill batch 1, prompt {prompt}: {pre_ms:.3f} ms "
              f"(runs {[round(t, 3) for t in pre_all]}), flash launches "
              f"{lb} (one a layer), plain calls {calls}, a decode step "
              f"launches no flash kernel; two prefills give the same bits "
              f"(logits and caches); assignments dropped {drop_b:.4f} "
              f"(capacity {layers.moe_capacity(cfg, prompt)}; by layer "
              f"{drop_layers}); peak {pb:.3f} GB above held {tag}")
        mrows += class_rows(arch, cfg, prompt)
        err_l, share_l = route_check(cfg, f"{arch} bf16")
        # the same prompt in float32 at the config's own capacity factor:
        # are the drops the bf16 activations'?
        prefill_checked(arch, override(cfg, dtype="float32"), params, toks,
                        prompt)
        records.clear()
        res["prefill"].update(dropped_f32=dropped(routed),
                              dropped_f32_by_layer=by_layer(routed))
        print(f"  (b) the same prompt in float32 (capacity factor "
              f"{cfg.capacity_factor:g}): assignments dropped "
              f"{res['prefill']['dropped_f32']:.4f}; by layer "
              f"{res['prefill']['dropped_f32_by_layer']} {tag}")
        res["route_bf16"] = {"layer_err": err_l, "layer_share": share_l}
        print(f"  (c) bf16, every layer's flash output vs the plain route on "
              f"its inputs: max|diff| {err_l:.3e}, {share_l:.3f} of the "
              f"row-scaled gate {tag}")
        # where one layer's prefill time goes: layer 1 on a normed
        # embedding of the prompt
        blk = params.blocks[1]
        h = layers.rms_norm(params.embed[toks].to(cfg.activation_dtype()),
                            blk.ln1, cfg.norm_eps)
        w1 = cfg.layer_window(1)
        cap_b = layers.moe_capacity(cfg, prompt)
        xe = torch.zeros((cfg.n_experts, cap_b, cfg.d_model),
                         dtype=h.dtype, device=dev)
        parts = {"attention": lambda: layers.attention_apply(
            cfg, blk.attn, h, None, w1),
            "moe": lambda: layers.moe_apply(cfg, blk.moe, h),
            "routing": lambda: moe_route(cfg, blk.moe["router"], h, cap_b),
            "expert FFN": lambda: layers._expert_ffn(cfg, blk.moe, xe),
            "expert weight casts": lambda: [
                blk.moe[w].to(h.dtype) for w in ("w1", "w2", "w3")]}
        res["layer_ms"] = {k: event_ms(fn, 3)[0] for k, fn in parts.items()}
        del h, xe
        print(f"    one layer at prompt {prompt} (layer 1), CUDA events: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in
                          res["layer_ms"].items())
              + f" (the MoE holds routing, dispatch, the expert FFN with its "
              f"weight casts and the combine; x {n_layers} layers) {tag}")

        # the routing of one full-width MoE layer, card against CPU
        blk = params.blocks[0]
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (1, LM_MOE_ROUTE_TOKENS, cfg.d_model)).astype(np.float32))
        p_cpu = {k: v.cpu() for k, v in blk.moe.items()}
        cap = layers.moe_capacity(cfg, LM_MOE_ROUTE_TOKENS)
        r_cpu = moe_route(cfg, p_cpu["router"], x, cap)
        r_dev = moe_route(cfg, blk.moe["router"], x.to(dev), cap)
        route_same = {n: torch.equal(r_dev[i].cpu(), r_cpu[i]) for i, n in
                      ((0, "dest"), (1, "st"), (3, "keep"), (5, "flat_e"))}
        top = torch.sort(r_cpu[4], dim=-1, descending=True).values
        margin = amax(-(top[..., cfg.top_k - 1] - top[..., cfg.top_k]))
        cfg32 = override(cfg, dtype="float32")
        t1 = time.perf_counter()
        o_cpu, _ = layers.moe_apply(cfg32, p_cpu, x)
        cpu_s = time.perf_counter() - t1
        o_dev, _ = layers.moe_apply(cfg32, blk.moe, x.to(dev))
        err_r = amax((o_dev.cpu() - o_cpu).abs())
        scale_r = amax(o_cpu.abs())
        del p_cpu, o_cpu, o_dev
        res["routing_vs_cpu"] = {"tokens": LM_MOE_ROUTE_TOKENS,
                                 "capacity": cap, "bitwise": route_same,
                                 "kept": int(r_cpu[3].sum()),
                                 "min_kth_gap": -margin,
                                 "out_err": err_r, "out_max": scale_r}
        print(f"  routing of layer 0 at full width on {LM_MOE_ROUTE_TOKENS} "
              f"tokens (capacity {cap}), card vs CPU: bitwise {route_same}; "
              f"{int(r_cpu[3].sum())} of {r_cpu[3].numel()} assignments "
              f"kept; smallest gap of the k-th to the next probability "
              f"{-margin:.3e}; float32 output max|card - CPU| {err_r:.3e} "
              f"(tol {TOL_MOE:g} of {scale_r:.3e}; the CPU took {cpu_s:.1f}"
              f" s) {tag}")
        if not all(route_same.values()):
            raise AssertionError(f"{arch}: the card routes otherwise than "
                                 f"the CPU: {route_same}")
        if not err_r <= TOL_MOE * scale_r:
            raise AssertionError(f"{arch}: the MoE layer's float32 output "
                                 f"on the card is {err_r:.3e} from the CPU")

        # (d) float32, nothing dropped: decode against the full forward
        cfg32 = override(cfg, dtype="float32",
                         capacity_factor=cfg.n_experts / cfg.top_k)
        t32 = toks[:, :LM_F32_PROMPT]
        logits32, _, _ = prefill_checked(arch, cfg32, params, t32,
                                         LM_F32_PROMPT + LM_GEN)
        err32_l, share32 = route_check(cfg32, f"{arch} float32")
        mrows += class_rows(arch, cfg32, LM_F32_PROMPT)
        records.clear()
        err32_d = decode_vs_forward(cfg32, params, t32, logits32)
        drop32 = dropped(routed)
        del logits32
        res["f32"] = {"layer_err": err32_l, "layer_share": share32,
                      "decode_vs_forward": err32_d, "dropped": drop32}
        print(f"  (d) float32 at capacity factor E / k = "
              f"{cfg32.capacity_factor:g}, prompt {LM_F32_PROMPT}: every "
              f"layer's flash output vs the plain route max|diff| "
              f"{err32_l:.3e}, {share32:.3f} of the gate (TOL_ATTN x "
              f"max(1, the layer's max |output|)); decode after a prefill of "
              f"{LM_F32_PROMPT - 1} vs the full forward's last logits "
              f"{err32_d:.3e} (tol {TOL_LM_DECODE:g}); assignments dropped "
              f"{drop32:.4f} {tag}")
        if drop32 != 0 or not err32_d <= TOL_LM_DECODE:
            raise AssertionError(f"{arch}: decode disagrees with the full "
                                 f"forward, or assignments dropped")
        del params, logits_f
        torch.cuda.empty_cache()
        return mrows, res

    def family_inputs(cfg_, s_, batch, gen_):
        """A prefill's inputs of `s_` positions at `batch` rows and a
        decode step's m-rope keywords: the VLM's embeddings (bf16 normal
        draws) with broadcast 0..S-1 streams, the encoder-decoder's source
        frames and target tokens."""
        toks = torch.randint(0, cfg_.vocab, (batch, s_), generator=gen_,
                             device=dev)
        frames = torch.randn((batch, s_, cfg_.d_model), generator=gen_,
                             device=dev).to(cfg_.activation_dtype())
        if cfg_.enc_dec:
            return {"src": frames, "tokens": toks}, {}
        pos = torch.arange(s_, dtype=torch.int32, device=dev).expand(
            batch, 3, s_)
        return {"embeds": frames, "positions": pos}, {
            "positions": torch.full((batch, 3, 1), s_, dtype=torch.int32,
                                    device=dev)}

    def family_decode_vs_forward(cfg_, params, inputs, logits):
        """max |last logits of decode after a prefill of S - 1 - the full
        forward's `logits`|: the encoder-decoder decodes the last target
        token over the same source; the VLM the embedding of a token whose
        table row replaces the last embedding in the full forward."""
        s_ = inputs["tokens" if cfg_.enc_dec else "embeds"].shape[1]
        if cfg_.enc_dec:
            short = {"src": inputs["src"],
                     "tokens": inputs["tokens"][:, :-1]}
            tok, dkw = inputs["tokens"][:, -1:], {}
            full = logits
        else:
            tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
            embeds = inputs["embeds"].clone()
            embeds[:, -1] = params.embed[tok[:, 0]].to(embeds.dtype)
            whole = dict(inputs, embeds=embeds)
            full, _ = steps.make_prefill_step(cfg_)(params, **whole)
            short = {"embeds": embeds[:, :-1],
                     "positions": inputs["positions"][:, :, :-1]}
            dkw = {"positions": inputs["positions"][:, :, -1:]}
        _, cache = steps.make_prefill_step(
            cfg_, cache_capacity=s_ + LM_GEN)(params, **short)
        step_logits, _ = steps.make_decode_step(cfg_)(
            params, token=tok, cache=cache, cache_index=s_ - 1, **dkw)
        return amax((step_logits - full).abs())

    def vlm_witness(cfg, params):
        """(d): layer 0's attention in float32 on an image prompt, on the
        card (the mask decided as transformer.forward decides it: the plain
        route) against the CPU, and against the card's index mask."""
        cfg32 = override(cfg, dtype="float32")
        a_, g_ = LM_IMAGE_AT, LM_IMAGE_GRID
        grid = torch.arange(g_ * g_)
        text = torch.arange(a_ + g_, a_ + g_ + LM_PROMPT - a_ - g_ * g_)
        t = torch.cat([torch.arange(a_), torch.full((g_ * g_,), a_), text])
        h = torch.cat([torch.arange(a_), a_ + grid // g_, text])
        w = torch.cat([torch.arange(a_), a_ + grid % g_, text])
        pos = torch.stack([t, h, w]).to(torch.int32)[None]   # (1, 3, S)
        x = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (1, LM_PROMPT, cfg.d_model)).astype(np.float32))
        blk = params.blocks[0]
        p_cpu = {k: v.cpu() for k, v in blk.attn.items()}
        h_cpu = layers.rms_norm(x, blk.ln1.cpu(), cfg.norm_eps)
        h_dev, pos_dev = h_cpu.to(dev), pos.to(dev)
        reset()
        launched = sum(flash_attention.launches_by_dtype.values())
        index = layers.index_stream(pos_dev)   # transformer.forward's ask
        got, _ = layers.attention_apply(cfg32, blk.attn, h_dev, pos_dev, 0,
                                        index_mask=index)
        torch.cuda.synchronize()
        routes = {"plain": calls["plain_route"],
                  "flash": sum(flash_attention.launches_by_dtype.values())
                  - launched}
        t1 = time.perf_counter()
        want, _ = layers.attention_apply(cfg32, p_cpu, h_cpu, pos, 0)
        cpu_s = time.perf_counter() - t1
        by_index, _ = layers.attention_apply(cfg32, blk.attn, h_dev, pos_dev,
                                             0, index_mask=True)
        scale = amax(want.abs())
        err = amax((got.cpu() - want).abs())
        err_index = amax((by_index.cpu() - want).abs())
        del p_cpu, h_dev, got, by_index
        return {"index_stream": index, "routes": routes, "err": err,
                "err_index_mask": err_index, "out_max": scale,
                "cpu_s": cpu_s, "tol": TOL_WITNESS * scale}

    def family_arch(arch, n_layers):
        """Phase 27 for the VLM or the encoder-decoder at full width and
        `n_layers` layers (None: all): serve, a prefill of LM_PROMPT
        positions (launches, plain calls, ms, one layer's parts), the route
        checks in bf16 and float32, the VLM witness, a decode step at
        batch LM_BATCH.  Returns its flash rows and numbers."""
        full = get_config(arch)
        cfg = full if n_layers is None else override(full, n_layers=n_layers)
        frows = []
        params, res, draw_s = draw(cfg)
        depth = (f"{cfg.n_layers} of {full.n_layers} layers" if n_layers
                 else f"{cfg.enc_layers} encoder + {cfg.n_layers} decoder "
                      f"layers")
        print(f"  {arch} FULL width, {depth}: d_model {cfg.d_model}, H "
              f"{cfg.n_heads}, Hkv {cfg.n_kv_heads}, hd {cfg.hd}, d_ff "
              f"{cfg.d_ff}, rope {cfg.rope}; {res['params']:,} parameters, "
              f"{res['params_gb']:.3f} GB float32 drawn in {draw_s:.1f} s; "
              f"{cfg.dtype} activations {tag}")

        # (a) the entry point's defaults
        res["serve"], lb, sv = serve_checked(arch, cfg, params)
        res["serve"]["bidirectional_calls"] = dict(bidir)
        print(f"  (a) launch.serve batch {LM_BATCH}, prompt "
              f"{LM_SERVE_PROMPT}, gen {LM_GEN} (after a warm-up run): "
              f"{summary(sv)}; prefill {sv['prefill_s'] * 1e3:.3f} ms, "
              f"decode {res['serve']['decode_ms_per_step']:.3f} ms a step, "
              f"{sv['tok_s']:.1f} tok/s; flash launches {lb}; plain encoder "
              f"/ cross-attention calls {bidir}; peak "
              f"{res['serve']['peak_gb']:.3f} GB above held {tag}")
        if cfg.enc_dec and bidir != {"encoder": cfg.enc_layers,
                                     "cross": cfg.n_layers * LM_GEN}:
            raise AssertionError(f"{arch} serve: plain calls {bidir}")

        # (b) one prompt of LM_PROMPT positions at batch 1
        g = torch.Generator(device=dev).manual_seed(2)
        inputs, _ = family_inputs(cfg, LM_PROMPT, 1, g)
        logits_f, cache, lb = prefill_checked(arch, cfg, params, None,
                                              LM_PROMPT + LM_GEN, inputs)
        want_bidir = {"encoder": cfg.enc_layers if cfg.enc_dec else 0,
                      "cross": cfg.n_layers if cfg.enc_dec else 0}
        if bidir != want_bidir:
            raise AssertionError(f"{arch}: plain calls {bidir}, want "
                                 f"{want_bidir}")
        res["prefill"] = {"positions": LM_PROMPT, "launches": lb["bfloat16"],
                          "plain_route": calls["plain_route"],
                          "flash_attention_plain":
                              calls["flash_attention_plain"],
                          "bidirectional_calls": dict(bidir)}
        del cache
        prefill = steps.make_prefill_step(cfg,
                                          cache_capacity=LM_PROMPT + LM_GEN)
        pre_ms, pre_all, pb = timed(lambda: prefill(params, **inputs), 3)
        res["prefill"].update(ms=pre_ms, runs=pre_all, peak_gb=pb)
        what = "source frames and target tokens" if cfg.enc_dec else \
            "embeddings, broadcast 0..S-1 streams"
        print(f"  (b) prefill batch 1, {LM_PROMPT} positions ({what}): "
              f"{pre_ms:.3f} ms (runs {[round(t, 3) for t in pre_all]}), "
              f"flash launches {lb} (one a decoder layer), plain route calls "
              f"{calls['plain_route']}, the kernel's plain version "
              f"{calls['flash_attention_plain']}, plain encoder / cross-"
              f"attention calls {res['prefill']['bidirectional_calls']}; "
              f"peak {pb:.3f} GB above held {tag}")
        frows += class_rows(arch, cfg, LM_PROMPT)
        # where one layer's prefill time goes (layer 1)
        blk = params.blocks[1]
        x = inputs["tokens" if cfg.enc_dec else "embeds"]
        if cfg.enc_dec:
            x = params.embed[x].to(cfg.activation_dtype())
        h = layers.rms_norm(x, blk.ln1, cfg.norm_eps)
        pos = inputs.get("positions")   # the VLM's index streams
        parts = {"attention": lambda: layers.attention_apply(
            cfg, blk.attn, h, pos, 0, index_mask=True),
            "mlp": lambda: layers.mlp_apply(cfg, blk.mlp, h)}
        if cfg.enc_dec:
            e_blk = params.enc_blocks[1]
            e_h = layers.rms_norm(inputs["src"], e_blk.ln1, cfg.norm_eps)
            e_pos = torch.arange(LM_PROMPT, device=dev)[None, :]
            ek, ev = layers.cross_kv(cfg, blk.xattn, e_h)
            parts.update({
                "encoder attention": lambda: enc_attn(cfg, e_blk.attn, e_h,
                                                      e_pos),
                "cross K/V": lambda: layers.cross_kv(cfg, blk.xattn, e_h),
                "cross-attention": lambda: cross_attn(cfg, blk.xattn, h, ek,
                                                      ev)})
        res["layer_ms"] = {k: event_ms(fn, 3)[0] for k, fn in parts.items()}
        if cfg.enc_dec:
            lm = res["layer_ms"]
            res["bidirectional_share"] = (
                cfg.enc_layers * lm["encoder attention"] + cfg.n_layers * (
                    lm["cross K/V"] + lm["cross-attention"])) / pre_ms
        del h, parts
        print(f"    one layer at {LM_PROMPT} positions (layer 1), CUDA "
              f"events: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                      res["layer_ms"].items())
              + (f"; encoder attention x {cfg.enc_layers} and cross K/V + "
                 f"cross-attention x {cfg.n_layers} (plain route) are "
                 f"{100 * res['bidirectional_share']:.1f} % of the prefill"
                 if cfg.enc_dec else f" (x {cfg.n_layers} layers)")
              + f" {tag}")

        # (c) the route checks: bf16 at LM_PROMPT, float32 at LM_F32_PROMPT
        err_l, share_l = route_check(cfg, f"{arch} bf16")
        records.clear()
        cfg32 = override(cfg, dtype="float32")
        in32 = {k: (v[..., :LM_F32_PROMPT] if k == "positions"
                    else v[:, :LM_F32_PROMPT]) for k, v in inputs.items()}
        in32 = {k: v.float() if v.is_floating_point() else v
                for k, v in in32.items()}
        logits32, _, _ = prefill_checked(arch, cfg32, params, None,
                                         LM_F32_PROMPT + LM_GEN, in32)
        err32_l, share32 = route_check(cfg32, f"{arch} float32")
        frows += class_rows(arch, cfg32, LM_F32_PROMPT)
        records.clear()
        err32_d = family_decode_vs_forward(cfg32, params, in32, logits32)
        del logits32
        res["route"] = {"bf16_layer_err": err_l, "bf16_layer_share": share_l,
                        "f32_layer_err": err32_l, "f32_layer_share": share32,
                        "f32_decode_vs_forward": err32_d}
        print(f"  (c) every layer's flash output vs the plain route on its "
              f"inputs: bf16 at {LM_PROMPT} max|diff| {err_l:.3e}, "
              f"{share_l:.3f} of the row-scaled gate; float32 at "
              f"{LM_F32_PROMPT} max|diff| {err32_l:.3e}, {share32:.3f} of "
              f"the gate (TOL_ATTN x max(1, the layer's max |output|)); "
              f"float32 decode after a prefill of {LM_F32_PROMPT - 1} vs the "
              f"full forward's last logits {err32_d:.3e} (tol "
              f"{TOL_LM_DECODE:g}) {tag}")
        if not err32_d <= TOL_LM_DECODE:
            raise AssertionError(f"{arch}: decode disagrees with the full "
                                 f"forward")

        # (d) the VLM witness: an image block takes the plain route
        if cfg.rope == "mrope":
            wit = vlm_witness(cfg, params)
            res["witness"] = wit
            print(f"  (d) layer 0's attention, float32, {LM_PROMPT} "
                  f"positions with a {LM_IMAGE_GRID} x {LM_IMAGE_GRID} image "
                  f"block at t = {LM_IMAGE_AT}: index stream "
                  f"{wit['index_stream']}, routes {wit['routes']}; card vs "
                  f"CPU max|diff| {wit['err']:.3e} (tol {wit['tol']:.3e}, "
                  f"{TOL_WITNESS:g} of max |out| {wit['out_max']:.3e}; the "
                  f"CPU took {wit['cpu_s']:.1f} s); the index mask's output "
                  f"is {wit['err_index_mask']:.3e} from the CPU's {tag}")
            if wit["index_stream"] or wit["routes"] != {"plain": 1,
                                                        "flash": 0}:
                raise AssertionError(f"{arch}: the image prompt took the "
                                     f"flash route: {wit}")
            if not (wit["err"] <= wit["tol"] < wit["err_index_mask"]):
                raise AssertionError(f"{arch}: the witness does not hold: "
                                     f"{wit}")

        # (e) a decode step at batch LM_BATCH after a prompt of
        # LM_SERVE_PROMPT
        inputs_e, dkw = family_inputs(cfg, LM_SERVE_PROMPT, LM_BATCH, g)
        logits_e, cache = steps.make_prefill_step(
            cfg, cache_capacity=LM_SERVE_PROMPT + 8)(params, **inputs_e)
        tok = torch.argmax(logits_e[:, -1], dim=-1)[:, None]
        decode = steps.make_decode_step(cfg)
        reset()
        dec_ms = []
        for i in range(4):
            if "positions" in dkw:
                dkw = {"positions": torch.full(
                    (LM_BATCH, 3, 1), LM_SERVE_PROMPT + i, dtype=torch.int32,
                    device=dev)}
            (step_logits, cache), ms, _ = peak(lambda: decode(
                params, token=tok, cache=cache,
                cache_index=LM_SERVE_PROMPT + i, **dkw))
            tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None]
            dec_ms.append(ms)
        if sum(flash_attention.launches_by_dtype.values()) or \
                not bool(torch.isfinite(step_logits).all()) or \
                bidir["cross"] != (4 * cfg.n_layers if cfg.enc_dec else 0):
            raise AssertionError(f"{arch} decode: flash launched, plain "
                                 f"calls {bidir}, or non-finite logits")
        res["decode"] = {"batch": LM_BATCH, "ms": statistics.median(
            dec_ms[1:]), "runs": dec_ms}
        print(f"  (e) decode a step at batch {LM_BATCH} after a prompt of "
              f"{LM_SERVE_PROMPT}: {res['decode']['ms']:.3f} ms (steps "
              f"{[round(t, 3) for t in dec_ms]}, the first a warm-up); no "
              f"flash launch; cross-attention calls {bidir['cross']} (cross "
              f"K/V recomputed from enc_out each step) {tag}")
        del params, logits_f, cache, logits_e, step_logits
        torch.cuda.empty_cache()
        return frows, res

    rows, out = [], {}
    layers._flash_route = recorded_flash_route
    layers._plain_route = counted_plain_route
    layers.moe_route = recorded_route
    layers.encoder_attention_apply = counted_encoder
    layers.cross_attention_apply = counted_cross
    fmod.flash_attention_plain = counted_flash_plain
    try:
        for arch in LM_ARCHS:
            cfg = get_config(arch)
            params, res, draw_s = draw(cfg)
            print(f"  {arch} FULL: {cfg.n_layers} layers, d_model "
                  f"{cfg.d_model}, H {cfg.n_heads}, Hkv {cfg.n_kv_heads}, "
                  f"hd {cfg.hd}, windows {sorted(set(cfg.layer_windows()))}"
                  f"; {res['params']:,} parameters, {res['params_gb']:.3f} "
                  f"GB float32 drawn in {draw_s:.1f} s; {cfg.dtype} "
                  f"activations {tag}")
            n_attn = cfg.n_layers

            # (a) the entry point's defaults
            res["serve"], lb, sv = serve_checked(arch, cfg, params)
            print(f"  (a) launch.serve batch {LM_BATCH}, prompt "
                  f"{LM_SERVE_PROMPT}, gen {LM_GEN} (after a warm-up run): "
                  f"{summary(sv)}; prefill {sv['prefill_s'] * 1e3:.3f} ms, "
                  f"decode {res['serve']['decode_ms_per_step']:.3f} ms a "
                  f"step, {sv['tok_s']:.1f} tok/s; flash launches {lb}; "
                  f"peak {res['serve']['peak_gb']:.3f} GB above held {tag}")

            # (b) the windowed prefill at LM_PROMPT tokens
            g = torch.Generator(device=dev).manual_seed(2)
            toks = torch.randint(0, cfg.vocab, (1, LM_PROMPT), generator=g,
                                 device=dev)
            logits_f, cache, lb = prefill_checked(arch, cfg, params, toks,
                                                  LM_PROMPT + LM_GEN)
            # the cache holds the prompt's last positions at slot p % cap
            for run_idx, (w, start, cnt) in enumerate(layer_runs(cfg)):
                k_rec = records[start][1]                  # (1, S, Hkv, hd)
                kc = cache[run_idx]["k"][0]                # (1, Hkv, cap, hd)
                cap = kc.shape[2]
                take = min(LM_PROMPT, cap)
                p_ = torch.arange(LM_PROMPT - take, LM_PROMPT, device=dev)
                slots = p_ % cap if w > 0 else p_
                if not torch.equal(kc[:, :, slots],
                                   k_rec[:, LM_PROMPT - take:]
                                   .transpose(1, 2)):
                    raise AssertionError(f"{arch} run {run_idx}: the cache "
                                         f"does not hold the prompt's last "
                                         f"{take} keys at their slots")
            decode_checked(arch, cfg, params, toks, cache)
            del cache
            prefill = steps.make_prefill_step(
                cfg, cache_capacity=LM_PROMPT + LM_GEN)
            pre_ms, pre_all, pb = timed(lambda: prefill(params, tokens=toks),
                                        3)
            res["prefill_4k"] = {"ms": pre_ms, "runs": pre_all,
                                 "peak_gb": pb, "launches": lb["bfloat16"]}
            print(f"  (b) prefill batch 1, prompt {LM_PROMPT}: "
                  f"{pre_ms:.3f} ms (runs {[round(t, 3) for t in pre_all]})"
                  f", flash launches {lb} (one a layer), plain calls "
                  f"{calls}, the ring and full caches hold the prompt's "
                  f"last keys at their slots, a decode step launches no "
                  f"flash kernel; peak {pb:.3f} GB above held {tag}")
            rows += class_rows(arch, cfg, LM_PROMPT)
            # where one layer's prefill time goes: layer 1 (hymba: a
            # window layer) on a normed embedding of the prompt
            blk = params.blocks[1]
            h = layers.rms_norm(params.embed[toks].to(cfg.activation_dtype()),
                                blk.ln1, cfg.norm_eps)
            w1 = cfg.layer_window(1)
            parts = {"attention": lambda: layers.attention_apply(
                cfg, blk.attn, h, None, w1),
                "mlp": lambda: layers.mlp_apply(cfg, blk.mlp, h)}
            if hasattr(blk, "ssm"):
                parts["ssm"] = lambda: ssm.ssm_apply(cfg, blk.ssm, h)
            res["layer_ms"] = {k: event_ms(fn, 3)[0]
                               for k, fn in parts.items()}
            del h
            print(f"    one layer at prompt {LM_PROMPT} (layer 1, window "
                  f"{w1}), CUDA events: " + ", ".join(
                      f"{k} {v:.3f} ms" for k, v in res["layer_ms"].items())
                  + f" (x {cfg.n_layers} layers) {tag}")

            # (c) the route check, bf16 at LM_PROMPT, against the float32
            # truth: the plain route with float32 activations
            err_l, share_l = route_check(cfg, f"{arch} bf16")
            records.clear()
            cfg32 = override(cfg, dtype="float32")
            layers._flash_route = plain_instead
            (logits_p, _), _, pc_gb = peak(lambda: steps.make_prefill_step(
                cfg)(params, tokens=toks))
            (logits_t, _), _, pt_gb = peak(lambda: steps.make_prefill_step(
                cfg32)(params, tokens=toks))
            layers._flash_route = recorded_flash_route
            scale = amax(logits_t.abs())
            e_flash = amax((logits_f - logits_t).abs())
            e_plain = amax((logits_p - logits_t).abs())
            err_c = amax((logits_f - logits_p).abs())
            del logits_p

            # (d) decode consistency at full width, bf16
            _, cache_d = prefill(params, tokens=toks[:, :-1])
            before = dict(flash_attention.launches_by_dtype)
            (logits_d, _), _, pd_gb = peak(lambda: steps.make_decode_step(
                cfg)(params, token=toks[:, -1:], cache=cache_d,
                cache_index=LM_PROMPT - 1))
            if dict(flash_attention.launches_by_dtype) != before:
                raise AssertionError(f"{arch}: decode launched flash")
            err_d = amax((logits_d - logits_f).abs())
            e_dec = amax((logits_d - logits_t).abs())
            del cache_d, logits_d, logits_t
            res["route_bf16"] = {
                "layer_err": err_l, "layer_share": share_l,
                "logits_flash_vs_plain": err_c, "flash_vs_f32": e_flash,
                "plain_vs_f32": e_plain, "decode_vs_f32": e_dec,
                "decode_vs_forward": err_d, "logits_max_f32": scale}
            print(f"  (c) bf16, every layer's flash output vs the plain "
                  f"route on its inputs: max|diff| {err_l:.3e}, "
                  f"{share_l:.3f} of the row-scaled gate; last-token logits "
                  f"(max |logit| {scale:.3e} in float32) from the float32 "
                  f"plain route: flash route {e_flash:.3e}, plain route "
                  f"{e_plain:.3e} (gate {LM_BF16_RATIO:g}x that: "
                  f"{e_flash / e_plain:.3f}x); flash vs plain route "
                  f"{err_c:.3e}; peak above held: plain route {pc_gb:.3f} "
                  f"GB, float32 plain route {pt_gb:.3f} GB {tag}")
            print(f"  (d) bf16, decode after a prefill of {LM_PROMPT - 1}: "
                  f"from the float32 plain route {e_dec:.3e} "
                  f"({e_dec / e_plain:.3f}x the plain route's, gate "
                  f"{LM_BF16_RATIO:g}x), from the full forward's bf16 "
                  f"logits {err_d:.3e}; the step's peak above held (the "
                  f"cache of {LM_PROMPT - 1} tokens held) {pd_gb:.3f} GB "
                  f"{tag}")
            if not (e_flash <= LM_BF16_RATIO * e_plain
                    and e_dec <= LM_BF16_RATIO * e_plain):
                raise AssertionError(f"{arch}: bf16 logits further from "
                                     f"float32 than {LM_BF16_RATIO:g}x the "
                                     f"plain route's")

            # (c) and (d) in float32 at LM_F32_PROMPT
            t32 = toks[:, :LM_F32_PROMPT]
            logits32, _, _ = prefill_checked(arch, cfg32, params, t32,
                                             LM_F32_PROMPT + LM_GEN)
            err32_l, share32 = route_check(cfg32, f"{arch} float32")
            rows += class_rows(arch, cfg32, LM_F32_PROMPT)
            records.clear()
            layers._flash_route = plain_instead
            logits32_p, _ = steps.make_prefill_step(cfg32)(params,
                                                           tokens=t32)
            layers._flash_route = recorded_flash_route
            scale32 = amax(logits32_p.abs())
            err32_c = amax((logits32 - logits32_p).abs())
            err32_d = decode_vs_forward(cfg32, params, t32, logits32)
            del logits32_p, logits32
            res["route_f32"] = {"layer_err": err32_l, "layer_share": share32,
                                "logits_err": err32_c, "logits_max": scale32,
                                "decode_vs_forward": err32_d}
            print(f"  (c) float32 at prompt {LM_F32_PROMPT}: every layer's "
                  f"flash output vs the plain route: max|diff| "
                  f"{err32_l:.3e}, {share32:.3f} of the gate (TOL_ATTN x "
                  f"max(1, the layer's max |output|)); last-token logits "
                  f"flash vs plain route: max|diff| {err32_c:.3e} (max "
                  f"|logit| {scale32:.3e}; tol {TOL_LM_LOGITS_F32:g} of "
                  f"it) {tag}")
            print(f"  (d) float32, decode after a prefill of "
                  f"{LM_F32_PROMPT - 1} vs the full forward's last logits: "
                  f"{err32_d:.3e} (tol {TOL_LM_DECODE:g}) {tag}")
            if not err32_c <= TOL_LM_LOGITS_F32 * scale32:
                raise AssertionError(f"{arch}: float32 logits of the two "
                                     f"routes disagree")
            if not err32_d <= TOL_LM_DECODE:
                raise AssertionError(f"{arch}: decode disagrees with the "
                                     f"full forward")

            # (e) a long prefill, llama3.2-3b only
            if arch == "llama3.2-3b":
                toks_l = torch.randint(0, cfg.vocab, (1, LM_LONG),
                                       generator=g, device=dev)
                prefill_l = steps.make_prefill_step(
                    cfg, cache_capacity=LM_LONG + LM_GEN)
                reset()
                recording[0] = 1
                (logits_l, cache_l), first_ms, _ = peak(
                    lambda: prefill_l(params, tokens=toks_l))
                recording[0] = 0
                lb = dict(flash_attention.launches_by_dtype)
                if lb["bfloat16"] != n_attn or sum(lb.values()) != n_attn \
                        or any(calls.values()) or \
                        not bool(torch.isfinite(logits_l).all()):
                    raise AssertionError(f"{arch} prefill {LM_LONG}: flash "
                                         f"launches {lb}, plain calls "
                                         f"{calls}")
                del cache_l, logits_l
                long_ms, long_all, pl = timed(
                    lambda: prefill_l(params, tokens=toks_l), 2)
                res["prefill_32k"] = {"ms": long_ms, "runs": long_all,
                                      "first_ms": first_ms, "peak_gb": pl}
                print(f"  (e) prefill batch 1, prompt {LM_LONG}: "
                      f"{long_ms:.3f} ms (runs "
                      f"{[round(t, 3) for t in long_all]}; first run, one "
                      f"layer's inputs kept, {first_ms:.3f} ms), flash "
                      f"launches {lb}, peak {pl:.3f} GB above held {tag}")
                rows += class_rows(arch, cfg, LM_LONG)
                records.clear()
            out[arch] = res
            del params, logits_f
            torch.cuda.empty_cache()
        for arch, n_layers, prompt in LM_MOE:
            mrows, out[arch] = moe_arch(arch, n_layers, prompt)
            rows += mrows
        for arch, n_layers in LM_FAMILIES:
            frows, out[arch] = family_arch(arch, n_layers)
            rows += frows
    finally:
        layers._flash_route, layers._plain_route = flash_route, plain_route
        layers.moe_route = moe_route
        layers.encoder_attention_apply = enc_attn
        layers.cross_attention_apply = cross_attn
        fmod.flash_attention_plain = flash_attention_plain
        records.clear()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 27 took {out['seconds']:.1f} s {tag}")
    return rows, out


def train_runs(dev, tag):
    """Phase 28, LM training on the card (see TRAIN_ARCH): the train step
    at full width and depth, card against CPU at SMOKE, the fault-tolerant
    loop with a checkpoint restore, dp_compressed over logical ranks, and
    the launcher on its default device.
    Returns the phase's numbers; any failed check raises."""
    import copy
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import get_config, override
    from repro_torch.data.synthetic import TokenStreamSpec, batch_at
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import (FailureInjected, LoopConfig,
                                                TrainLoop)
    from repro_torch.tree import named_leaves

    t_phase = time.perf_counter()
    out = {}

    def gb(n_bytes):
        return n_bytes / 1e9

    # -- (a) the train step at full width and depth ---------------------------
    cfg = get_config(TRAIN_ARCH)
    # tests/test_arch_smoke.py's optimizer: the warmup of 100 steps
    opt = adamw.AdamWConfig(total_steps=10, moment_dtype=cfg.opt_state_dtype)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                  dev, trainable=True)
    names = [n for n, _ in named_leaves(model)]
    n_params = sum(p.numel() for p in model.parameters())
    state = adamw.init(opt, model)
    param_gb = gb(sum(p.numel() * p.element_size()
                      for p in model.parameters()))
    opt_gb = gb(sum(t.numel() * t.element_size()
                    for t in state["m"] + state["v"]))
    batch = batch_at(TokenStreamSpec(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH), 0)
    step = steps.make_train_step(cfg, opt, device=dev)
    real_update = steps.adamw.update
    marks, checks = [], []

    def timed_update(opt_cfg, grads, st, params):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()              # forward + backward done
        # every gradient leaf finite, every attention leaf's non-zero
        finite = torch.stack([torch.isfinite(g).all() for g in grads])
        amax = torch.stack([g.detach().abs().max() for g in grads])
        checks.append((finite, amax))
        events[1].record()
        res = real_update(opt_cfg, grads, st, params)
        events[2].record()
        marks[-1] += tuple(events)
        return res

    steps.adamw.update = timed_update
    flash_attention.launches = 0
    losses, norms = [], []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            marks.append((start,))
            _, state, m = step(model, state, **batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
    finally:
        steps.adamw.update = real_update
    peak_above = gb(torch.cuda.max_memory_allocated() - held) - param_gb
    flash_launches = flash_attention.launches
    # the step without the phase's own checks of the gradients; the first
    # step is cold (the process's first backward), the medians are of the
    # warm steps after it
    fwd_bwd = [s.elapsed_time(g) for s, g, _, _ in marks]
    upd = [b.elapsed_time(e) for _, _, b, e in marks]
    total = [a + b for a, b in zip(fwd_bwd, upd)]
    warm = {k: statistics.median(v[1:]) for k, v in
            (("step", total), ("fwd_bwd", fwd_bwd), ("adamw", upd))}
    attn = [i for i, n in enumerate(names) if ".attn." in n]
    out["step"] = {
        "arch": cfg.arch, "layers": cfg.n_layers, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
        "grad_norms": norms, "cold_step_ms": total[0],
        "warm_step_ms": warm["step"], "step_runs": total,
        "warm_fwd_bwd_ms": warm["fwd_bwd"], "fwd_bwd_runs": fwd_bwd,
        "warm_adamw_ms": warm["adamw"], "adamw_runs": upd,
        "param_gb": param_gb, "moment_gb": opt_gb,
        "peak_above_params_gb": peak_above,
        "peak_above_params_and_moments_gb": peak_above - opt_gb,
        "flash_launches": flash_launches,
        "attention_leaves": len(attn)}
    print(f"  (a) {cfg.arch} FULL ({cfg.n_layers} layers, {n_params:,} "
          f"parameters, {param_gb:.3f} GB + moments {opt_gb:.3f} GB, float32"
          f"; {cfg.dtype} activations), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: first (cold) step {total[0]:.3f} ms, warm steps' "
          f"median {warm['step']:.3f} (runs {[round(t, 3) for t in total]})"
          f", forward + backward {warm['fwd_bwd']:.3f} (runs "
          f"{[round(t, 3) for t in fwd_bwd]}), AdamW {warm['adamw']:.3f} "
          f"(runs {[round(t, 3) for t in upd]}); losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}; peak {peak_above:.3f} GB above "
          f"the parameters ({peak_above - opt_gb:.3f} above parameters and "
          f"moments); flash launches {flash_launches} {tag}")
    for i, (finite, amax) in enumerate(checks):
        bad = [names[j] for j in torch.nonzero(~finite).flatten().tolist()]
        if bad:
            raise RuntimeError(f"step {i}: non-finite gradients in {bad[:4]}")
        zero = [names[j] for j in attn if float(amax[j]) == 0.0]
        if zero:
            raise RuntimeError(f"step {i}: zero attention gradients in "
                               f"{zero[:4]}")
    if not all(np.isfinite(losses + norms)):
        raise RuntimeError(f"non-finite loss or norm: {losses} {norms}")
    if not losses[-1] < 1.05 * losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    if flash_launches:
        raise RuntimeError(f"{flash_launches} flash launches under autograd")
    print(f"      every gradient leaf finite in every step, each of the "
          f"{len(attn)} attention leaves' non-zero; the third loss below "
          f"1.05 x the first")
    del model, state, step, checks
    torch.cuda.empty_cache()

    # -- (b) card against CPU at SMOKE ---------------------------------------
    out["smoke"] = {}
    for arch in TRAIN_SMOKE:
        scfg = get_config(arch, smoke=True)
        cpu_model = build_model(scfg).init(torch.Generator().manual_seed(0),
                                           "cpu", trainable=True)
        card_model = copy.deepcopy(cpu_model).to(dev)
        sbatch = batch_at(TokenStreamSpec(vocab=scfg.vocab, seq_len=48,
                                          global_batch=2, seed=1), 0)
        routes = {"cpu": [], "cuda": []}
        side = ["cpu"]
        route = layers.moe_route

        def spy(c, router, x, cap):
            res = route(c, router, x, cap)
            routes[side[0]].append(res[5].cpu())
            return res
        layers.moe_route = spy
        try:
            m_cpu, g_cpu = steps.grads_of(scfg, cpu_model,
                                          steps.as_batch(sbatch, "cpu"))
            side[0] = "cuda"
            m_card, g_card = steps.grads_of(scfg, card_model,
                                            steps.as_batch(sbatch, dev))
        finally:
            layers.moe_route = route
        if len(routes["cpu"]) != len(routes["cuda"]) or not all(
                torch.equal(a, b) for a, b in zip(routes["cpu"],
                                                  routes["cuda"])):
            raise RuntimeError(f"{arch}: the card routes otherwise")
        loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / \
            abs(float(m_cpu["loss"]))
        shares = [float((gd.cpu() - gc).abs().max())
                  / max(float(gc.abs().max()), 1e-30)
                  for gc, gd in zip(g_cpu, g_card)]
        sopt = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1,
                                 total_steps=10)
        s_cpu, s_card = adamw.init(sopt, cpu_model), adamw.init(sopt,
                                                                card_model)
        adamw.update(sopt, g_cpu, s_cpu, cpu_model)
        adamw.update(sopt, [g.to(dev) for g in g_cpu], s_card, card_model)
        upd_shares = [float((b.detach().cpu() - a.detach()).abs().max())
                      / max(float(a.detach().abs().max()), 1e-30)
                      for a, b in zip(cpu_model.parameters(),
                                      card_model.parameters())]
        if loss_err > TOL_TRAIN or max(shares) > TOL_TRAIN or \
                max(upd_shares) > TOL_TRAIN_ADAM:
            raise RuntimeError(f"{arch}: card vs CPU loss {loss_err:.3e}, "
                               f"gradients {max(shares):.3e}, AdamW "
                               f"{max(upd_shares):.3e}")
        out["smoke"][arch] = {"loss_rel": loss_err,
                              "grad_share": max(shares),
                              "adamw_share": max(upd_shares),
                              "moe_calls": len(routes["cuda"])}
        print(f"  (b) {scfg.arch} float32, card vs CPU: loss {loss_err:.3e} "
              f"relative, gradients {max(shares):.3e} of each leaf's max "
              f"(tol {TOL_TRAIN}), AdamW fed the CPU's gradients "
              f"{max(upd_shares):.3e} (tol {TOL_TRAIN_ADAM}), MoE calls "
              f"{len(routes['cuda'])} routed alike {tag}")

    # -- (c) the fault-tolerant loop at full width ----------------------------
    lcfg = override(cfg, n_layers=LOOP_LAYERS)
    spec = TokenStreamSpec(vocab=lcfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH)
    lopt = adamw.AdamWConfig(total_steps=LOOP_STEPS)
    mesh = make_mesh((1, 1), ("data", "model"), devices=[str(dev)])
    times = {"save_call": [], "write": [], "restore": [], "recover": []}
    real_save = ckpt_io.save

    def timed_save(*a, **k):
        t1 = time.perf_counter()
        path = real_save(*a, **k)
        times["write"].append((time.perf_counter() - t1) * 1e3)
        return path

    class TimedLoop(TrainLoop):
        def _save(self, s):
            t1 = time.perf_counter()
            super()._save(s)
            times["save_call"].append((time.perf_counter() - t1) * 1e3)

        def _restore(self):
            t1 = time.perf_counter()
            s = super()._restore()
            torch.cuda.synchronize()
            times["restore"].append((time.perf_counter() - t1) * 1e3)
            return s

        def _recover(self, e):
            t1 = time.perf_counter()
            super()._recover(e)
            times["recover"].append((time.perf_counter() - t1) * 1e3)

    fired = []

    def hook(s):
        if s == LOOP_FAIL_AT and not fired:
            fired.append(s)
            raise FailureInjected("injected")

    root = tempfile.mkdtemp(prefix="repro_torch_phase28_")
    ckpt_io.save = timed_save
    peaks = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        clean = TrainLoop(lcfg, lopt, LoopConfig(
            total_steps=LOOP_STEPS, ckpt_every=LOOP_STEPS,
            ckpt_dir=os.path.join(root, "clean")), mesh, data_spec=spec)
        clean.run()
        peaks["clean"] = torch.cuda.max_memory_allocated()
        clean_losses = {m["step"]: m["loss"] for m in clean.metrics_log}
        state_bytes = sum(t.numel() * t.element_size() for t in
                          list(clean.params.parameters())
                          + clean.opt_state["m"] + clean.opt_state["v"])
        del clean
        torch.cuda.empty_cache()
        for k in times:
            times[k].clear()
        torch.cuda.reset_peak_memory_stats()
        loop = TimedLoop(lcfg, lopt, LoopConfig(
            total_steps=LOOP_STEPS, ckpt_every=LOOP_CKPT_EVERY,
            ckpt_dir=os.path.join(root, "failing")), mesh, data_spec=spec,
            failure_hook=hook)
        loop.run()
        peaks["failing"] = torch.cuda.max_memory_allocated()
        step_dir = os.path.join(root, "failing",
                                f"step_{LOOP_CKPT_EVERY:08d}")
        ckpt_mb = sum(os.path.getsize(os.path.join(step_dir, f))
                      for f in os.listdir(step_dir)) / 1e6
    finally:
        ckpt_io.save = real_save
        shutil.rmtree(root, ignore_errors=True)
    seen = [m["step"] for m in loop.metrics_log]
    if not fired or seen.count(LOOP_FAIL_AT) != 1 or seen != list(
            range(LOOP_STEPS)):
        raise RuntimeError(f"the loop ran steps {seen} (failure at "
                           f"{LOOP_FAIL_AT}, checkpoints every "
                           f"{LOOP_CKPT_EVERY})")
    diffs = {m["step"]: abs(m["loss"] - clean_losses[m["step"]])
             / abs(clean_losses[m["step"]]) for m in loop.metrics_log}
    after = max(diffs[s] for s in range(LOOP_FAIL_AT, LOOP_STEPS))
    if after > TOL_RESUME:
        raise RuntimeError(f"losses after the restore differ from the "
                           f"uninterrupted run's by {after:.3e} relative")
    # a recovery that drew a second model and moments before dropping the
    # first would add all of state_bytes to the uninterrupted run's peak
    peak_extra = peaks["failing"] - peaks["clean"]
    if peak_extra > state_bytes / 2:
        raise RuntimeError(f"the recovering run peaks {gb(peak_extra):.3f} "
                           f"GB above the uninterrupted run (parameters and "
                           f"moments {gb(state_bytes):.3f} GB)")
    lparams = sum(p.numel() for p in loop.params.parameters())
    # the failure to the loop ready again: recover, then restore
    resume_ms = times["recover"][0] + times["restore"][-1]
    out["loop"] = {"layers": LOOP_LAYERS, "params": lparams,
                   "steps": seen, "loss_diff_after_restore": after,
                   "ckpt_mb": ckpt_mb, "save_call_ms": times["save_call"],
                   "write_ms": times["write"], "restore_ms": times["restore"],
                   "recover_ms": times["recover"], "resume_ms": resume_ms,
                   "write_mb_s": [ckpt_mb / (t / 1e3) for t in times["write"]],
                   "peak_clean_gb": gb(peaks["clean"]),
                   "peak_recovering_gb": gb(peaks["failing"]),
                   "state_gb": gb(state_bytes),
                   "losses": [m["loss"] for m in loop.metrics_log]}
    print(f"  (c) TrainLoop pjit on {mesh}, {lcfg.arch} at {LOOP_LAYERS} "
          f"layers ({lparams:,} parameters), {LOOP_STEPS} steps, "
          f"checkpoints every {LOOP_CKPT_EVERY}, failure at "
          f"{LOOP_FAIL_AT}: steps {seen}, largest loss difference from the "
          f"uninterrupted run after the restore {after:.3e} relative (tol "
          f"{TOL_RESUME}); a checkpoint {ckpt_mb:.1f} MB, save call (host "
          f"copy) {[round(t, 1) for t in times['save_call']]} ms, writes "
          f"{[round(t, 1) for t in times['write']]} ms "
          f"({[round(ckpt_mb / (t / 1e3), 1) for t in times['write']]} "
          f"MB/s, warm page cache), restore (read, copy to the card) "
          f"{[round(t, 1) for t in times['restore']]} ms, recover "
          f"{[round(t, 1) for t in times['recover']]} ms, resume "
          f"{resume_ms:.1f} ms; peak {gb(peaks['failing']):.3f} GB through "
          f"the recovery against {gb(peaks['clean']):.3f} uninterrupted "
          f"(parameters and moments {gb(state_bytes):.3f}) {tag}")
    del loop
    torch.cuda.empty_cache()

    # -- (d) dp_compressed over logical ranks on one card ----------------------
    dcfg = get_config(TRAIN_ARCH, smoke=True)
    root = tempfile.mkdtemp(prefix="repro_torch_phase28_dp_")
    try:
        dp = TrainLoop(dcfg, adamw.AdamWConfig(total_steps=DP_STEPS,
                                               warmup_steps=1),
                       LoopConfig(total_steps=DP_STEPS, ckpt_every=DP_STEPS,
                                  ckpt_dir=root, mode="dp_compressed"),
                       make_mesh((DP_RANKS, 1), ("data", "model"),
                                 devices=[str(dev)] * DP_RANKS),
                       data_spec=TokenStreamSpec(vocab=dcfg.vocab,
                                                 seq_len=64,
                                                 global_batch=8))
        dp.run()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dlosses = [m["loss"] for m in dp.metrics_log]
    equal = all(torch.equal(a, b) for r in dp.replicas[1:]
                for a, b in zip(dp.replicas[0].parameters(), r.parameters()))
    if not equal or not dlosses[-1] < dlosses[0]:
        raise RuntimeError(f"dp_compressed: replicas equal {equal}, losses "
                           f"{dlosses}")
    out["dp_compressed"] = {"ranks": DP_RANKS, "losses": dlosses}
    print(f"  (d) dp_compressed over {DP_RANKS} logical ranks on {dev}, "
          f"{dcfg.arch}: losses {[round(x, 4) for x in dlosses]}, replicas "
          f"bitwise equal {tag}")

    # -- (e) the launcher as a user calls it, on its default device --------------
    argv = ["--arch", TRAIN_ARCH, "--smoke", "--steps", str(CLI_STEPS)]
    root = tempfile.mkdtemp(prefix="repro_torch_phase28_cli_")
    try:
        cli = train_cli.main(argv + ["--ckpt-dir", root])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    closses = [m["loss"] for m in cli.metrics_log]
    places = {p.device.type for p in cli.params.parameters()}
    if places != {"cuda"} or not np.isfinite(closses).all() or \
            not closses[-1] < closses[0]:
        raise RuntimeError(f"launch.train on {places}: losses {closses}")
    out["cli"] = {"argv": argv, "mesh": dict(cli.mesh.shape),
                  "losses": closses}
    print(f"  (e) python -m repro_torch.launch.train {' '.join(argv)} (its "
          f"default device, global batch 8 x 256): mesh "
          f"{dict(cli.mesh.shape)} on cuda, losses "
          f"{[round(x, 4) for x in closses]} {tag}")
    del cli
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 28 took {out['seconds']:.1f} s {tag}")
    return out


def tp_layout():
    """Phase 29's ranks: (cards, their devices, what they are)."""
    import torch
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        return n_cards, [torch.device("cuda", i) for i in range(
            min(TP_RANKS, n_cards))], \
            f"{min(TP_RANKS, n_cards)} cards, one rank each"
    return n_cards, [torch.device("cuda", 0)] * TP_RANKS, (
        f"{TP_RANKS} logical ranks on cuda:0 (one card): the times show "
        f"the executor's cost, not scaling; no speed-up is claimed")


def tp_runs(tag):
    """Phase 29, LM serving over a model axis (see TP_RANKS), every check
    fatal.  Returns the flash rows of the kernels record (one rank's
    inputs at each tensor-parallel shape) and the phase's numbers."""
    import torch

    from repro_torch.configs import get_config, override
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.launch.serve import serve, summary
    from repro_torch.models import layers, steps
    from repro_torch.models.registry import build_model

    t_phase = time.perf_counter()
    n_cards, ranks, layout = tp_layout()
    p = len(ranks)
    mesh = make_mesh((1, p), ("data", "model"), devices=ranks)
    cards = list(dict.fromkeys(ranks))
    dev0 = ranks[0]
    print(f"  29: {layout}; {describe(mesh)}")
    out = {"layout": layout, "p": p}
    rows = []

    flash_route, plain_route = layers._flash_route, layers._plain_route
    plain = {"route": 0, "flash_attention_plain": 0}
    shapes, first = {}, {}
    records, keep, worst = [], [False], {}
    flash_plain = fmod.flash_attention_plain

    def recording(cfg_, q, k, v, window):
        """The flash route, its calls counted by (dtype, B, H, Hkv, S, D,
        window) and each shape's first inputs kept; in a gated run (keep)
        every call's inputs and output."""
        res = flash_route(cfg_, q, k, v, window)
        key = (str(q.dtype).removeprefix("torch."), q.shape[0], q.shape[2],
               k.shape[2], q.shape[1], q.shape[3], window)
        shapes[key] = shapes.get(key, 0) + 1
        first.setdefault(key, (q, k, v, window))
        if keep[0]:
            records.append((q, k, v, window, res))
        return res

    def gated(arch, cfg_, what, fn):
        """fn()'s result, every flash launch in it (each rank's, each
        layer's) held against the plain route on its inputs by phase 27's
        gate (route_gate), fatal above it."""
        records.clear()
        keep[0] = True
        try:
            res = fn()
        finally:
            keep[0] = False
        sync()
        err, share = route_gate(records, plain_route, cfg_, f"{arch} {what}")
        records.clear()
        e0, s0 = worst.get(arch, (0.0, 0.0))
        worst[arch] = (max(e0, err), max(s0, share))
        return res

    def counted_plain_route(*args, **kwargs):
        plain["route"] += 1
        return plain_route(*args, **kwargs)

    def counted_flash_plain(*args, **kwargs):
        plain["flash_attention_plain"] += 1
        return flash_plain(*args, **kwargs)

    def reset():
        fmod.flash_attention.launches = 0
        fmod.flash_attention.launches_by_dtype = {
            k: 0 for k in fmod.flash_attention.launches_by_dtype}
        shapes.clear()
        first.clear()
        records.clear()
        for k in plain:
            plain[k] = 0

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def peaks(fn):
        """fn()'s result and each card's peak memory in it, GB."""
        sync()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        res = fn()
        sync()
        return res, {str(d): torch.cuda.max_memory_allocated(d) / 1e9
                     for d in cards}

    def launched(arch, cfg_, what):
        """Every prefill attention a flash launch a layer a rank, in the
        activations' dtype, none on a plain version.  Returns the shapes."""
        dname = cfg_.dtype
        lb = dict(fmod.flash_attention.launches_by_dtype)
        want = cfg_.n_layers * p
        if lb[dname] != want or sum(lb.values()) != want or \
                sum(shapes.values()) != want or any(plain.values()):
            raise AssertionError(f"{arch} {what}: flash launches {lb}, "
                                 f"shapes {shapes}, plain calls {plain}: "
                                 f"want {cfg_.n_layers} layers x {p} ranks "
                                 f"in {dname}, no plain version")
        return dict(shapes)

    def gate(arch, want, got, tol, what):
        """max |got - want| / max |want| of float32 copies, fatal above
        tol."""
        w, g = want.float().to(dev0), got.float().to(dev0)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{arch} {what}: non-finite logits")
        rel = amax((g - w).abs()) / max(amax(w.abs()), 1e-30)
        if not rel <= tol:
            raise AssertionError(f"{arch} {what}: the mesh's logits are "
                                 f"{rel:.3e} of max |logit| from one "
                                 f"device's, above {tol:g}")
        return rel

    def draw(cfg_, on_mesh):
        """Parameters from torch.Generator seed 0 on the first rank's card,
        on it alone or placed over the mesh: (params, seconds)."""
        sync()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = build_model(cfg_).init(
            torch.Generator(device=dev0).manual_seed(0), device=dev0,
            mesh=mesh if on_mesh else None)
        sync()
        return params, time.perf_counter() - t0

    def served(cfg_, params):
        """serve() at its defaults after a warm-up of two tokens, whose
        prefill is gated (the measured run keeps no inputs)."""
        where = "over the mesh" if hasattr(params, "px") else "on one device"
        gated(cfg_.arch, cfg_, f"serve warm-up {where}", lambda: serve(
            cfg_, batch=LM_BATCH, prompt_len=LM_SERVE_PROMPT, gen=2,
            params=params, device=dev0))
        reset()
        sv, pk = peaks(lambda: serve(cfg_, batch=LM_BATCH,
                                     prompt_len=LM_SERVE_PROMPT, gen=LM_GEN,
                                     params=params, device=dev0))
        return sv, pk

    def numbers(sv):
        return {"prefill_ms": sv["prefill_s"] * 1e3,
                "decode_ms_per_step": sv["decode_s"] * 1e3 / (LM_GEN - 1),
                "tok_s": sv["tok_s"]}

    def collectives(cfg_, sm, toks, cap):
        """The collectives' ms (CUDA events around each) in one prefill of
        toks and in one decode step after it."""
        pre = steps.make_prefill_step(cfg_, cache_capacity=cap,
                                      policy=sm.policy)
        dec = steps.make_decode_step(cfg_, policy=sm.policy)
        sm.px.timer = []
        logits, cache = pre(sm, tokens=toks)
        pre_ms, n_pre = sm.px.collective_ms(), len(sm.px.timer)
        sm.px.timer = []
        dec(sm, token=logits[:, -1].argmax(-1)[:, None], cache=cache,
            cache_index=toks.shape[1])
        dec_ms, n_dec = sm.px.collective_ms(), len(sm.px.timer)
        sm.px.timer = None
        return {"prefill_ms": pre_ms, "prefill_count": n_pre,
                "decode_ms": dec_ms, "decode_count": n_dec}

    def serve_prompts(cfg_):
        """launch.serve's prompts (numpy seed 0), as serve() draws them."""
        return torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg_.vocab, (LM_BATCH, LM_SERVE_PROMPT),
            dtype=np.int32)).long().to(dev0)

    def last_logits(cfg_, params, toks, policy=None):
        """A prefill's last-token logits (B, V), float32, on dev0."""
        logits, _ = steps.make_prefill_step(
            cfg_, cache_capacity=toks.shape[1] + 1, policy=policy)(
                params, tokens=toks)
        return logits[:, -1].float().to(dev0)

    def held(arch, truth, one, got, what):
        """The mesh's bf16 logits no more than TP_BF16_RATIO times as far
        from the float32 truth as one device's: (one device's distance,
        the mesh's, the two runs' own), relative to max |truth|."""
        scale = max(amax(truth.abs()), 1e-30)
        one, got = one.float().to(dev0), got.float().to(dev0)
        d_one = amax((one - truth).abs()) / scale
        d_mesh = amax((got - truth).abs()) / scale
        if not bool(torch.isfinite(got).all()) or \
                not d_mesh <= TP_BF16_RATIO * d_one:
            raise AssertionError(f"{arch} {what}: the mesh's bf16 logits are "
                                 f"{d_mesh:.3e} of max from the float32 "
                                 f"truth, one device's {d_one:.3e} (ratio "
                                 f"{TP_BF16_RATIO:g})")
        return d_one, d_mesh, amax((got - one).abs()) / scale

    def flash_gate(arch):
        err, share = worst[arch]
        return (f"every gated run's flash launches against the plain route: "
                f"max |err| {err:.3e}, {share:.3f} of the gate at most")

    def agree(a, b):
        return int((a["tokens"].to(dev0) == b["tokens"].to(dev0)).sum())

    def tp_rows(arch, launches_by_key):
        """A record row for each flash shape of the last run (its first
        rank's first layer), its launches that shape's in the run."""
        out_rows = []
        for key, (q, k, v, window) in sorted(first.items(),
                                            key=lambda kv: kv[0][-1]):
            _, b_, h_, hkv_, s_, d_, w_ = key
            out_rows.append(flash_record(
                arch, q, k, v, window, launches_by_key[key],
                f"S={s_} {f'window {w_}' if w_ else 'causal'}, tp {p} "
                f"(a rank: H {h_}, Hkv {hkv_}, D {d_})", tag))
        return out_rows

    layers._flash_route = recording
    layers._plain_route = counted_plain_route
    fmod.flash_attention_plain = counted_flash_plain
    try:
        # -- (a) llama3.2-3b FULL ------------------------------------------
        arch = "llama3.2-3b"
        cfg = get_config(arch)
        cfg32 = override(cfg, dtype="float32")
        g = torch.Generator(device=dev0).manual_seed(2)
        toks = torch.randint(0, cfg.vocab, (1, TP_PROMPT), generator=g,
                             device=dev0)
        sp = serve_prompts(cfg)
        one, one_draw = draw(cfg, False)
        one_sv, one_pk = served(cfg, one)
        truth = last_logits(cfg32, one, sp)
        one_long, truth_long = last_logits(cfg, one, toks), \
            last_logits(cfg32, one, toks)
        pre1 = steps.make_prefill_step(cfg, cache_capacity=TP_PROMPT + 1)
        one_long_ms = host_ms(lambda: pre1(one, tokens=toks), 3)[0]
        del one
        sm, sm_draw = draw(cfg, True)
        sv, pk = served(cfg, sm)
        serve_shapes = launched(arch, cfg, "serve")
        bf = held(arch, truth, one_sv["first_logits"][:, -1],
                  sv["first_logits"][:, -1], "serve")
        reset()
        rel32 = gate(arch, truth, gated(arch, cfg32, "float32 prefill",
                                        lambda: last_logits(
                                            cfg32, sm, sp, sm.policy)),
                     TOL_LM_LOGITS_F32, "float32 prefill")
        launched(arch, cfg32, "float32 prefill")
        pre = steps.make_prefill_step(cfg, cache_capacity=TP_PROMPT + 1,
                                      policy=sm.policy)
        reset()
        long_logits = gated(arch, cfg, f"prefill of {TP_PROMPT}",
                            lambda: last_logits(cfg, sm, toks, sm.policy))
        long_shapes = launched(arch, cfg, f"prefill of {TP_PROMPT}")
        plan = layers.head_plan(cfg, sm.px, "blocks/attn", True)
        want_shapes = {}
        for (q0, q1), (k0, k1) in zip(plan.q, plan.reads):
            key = ("bfloat16", 1, q1 - q0, k1 - k0, TP_PROMPT, cfg.hd, 0)
            want_shapes[key] = want_shapes.get(key, 0) + cfg.n_layers
        if cfg.n_kv_heads % p == 0 and set(want_shapes) != {
                ("bfloat16", 1, cfg.n_heads // p, cfg.n_kv_heads // p,
                 TP_PROMPT, cfg.hd, 0)}:
            raise AssertionError(f"{arch}: heads {plan} at {p} ranks")
        if long_shapes != want_shapes:
            raise AssertionError(f"{arch}: flash shapes {long_shapes}, want "
                                 f"{want_shapes}")
        bf_long = held(arch, truth_long, one_long, long_logits,
                       f"prefill of {TP_PROMPT}")
        rows += tp_rows(arch, long_shapes)
        reset()
        rel32_long = gate(arch, truth_long, gated(
            arch, cfg32, f"float32 prefill of {TP_PROMPT}",
            lambda: last_logits(cfg32, sm, toks, sm.policy)),
            TOL_LM_LOGITS_F32, f"float32 prefill of {TP_PROMPT}")
        launched(arch, cfg32, f"float32 prefill of {TP_PROMPT}")
        (long_ms, long_all), long_pk = peaks(
            lambda: host_ms(lambda: pre(sm, tokens=toks), 3))
        coll = collectives(cfg, sm, toks, TP_PROMPT + 1)
        coll_serve = collectives(cfg, sm, sp, LM_SERVE_PROMPT + 2)
        # (e) a decode step may not wait on the host
        logits, cache = steps.make_prefill_step(
            cfg, cache_capacity=LM_SERVE_PROMPT + 1, policy=sm.policy)(
                sm, tokens=sp)
        decode = steps.make_decode_step(cfg, policy=sm.policy)
        tok = logits[:, -1].argmax(-1)[:, None]
        sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step_logits, _ = decode(sm, token=tok, cache=cache,
                                    cache_index=LM_SERVE_PROMPT)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync()
        if not bool(torch.isfinite(step_logits).all()):
            raise AssertionError(f"{arch}: the checked decode step's logits "
                                 f"are not finite")
        del sm, cache, logits, step_logits
        out[arch] = {
            "one_device": dict(numbers(one_sv), draw_s=one_draw,
                               peak_gb=one_pk, prefill_long_ms=one_long_ms),
            "mesh": dict(numbers(sv), draw_s=sm_draw, peak_gb=pk,
                         prefill_long_ms=long_ms,
                         prefill_long_runs=long_all,
                         prefill_long_peak_gb=long_pk),
            "bf16_from_truth_one_mesh_apart": bf,
            "bf16_long_from_truth_one_mesh_apart": bf_long,
            "f32_rel": rel32, "f32_long_rel": rel32_long,
            "greedy_agree": agree(one_sv, sv),
            "greedy_tokens": LM_BATCH * LM_GEN,
            "flash_vs_plain_err_share": worst[arch],
            "collectives_long": coll, "collectives_serve": coll_serve,
            "flash_serve": {str(k): v for k, v in serve_shapes.items()},
            "flash_long": {str(k): v for k, v in long_shapes.items()}}
        print(f"  (a) {arch} FULL over {p} ranks: {summary(sv)}; prefill "
              f"{sv['prefill_s'] * 1e3:.3f} ms (one device "
              f"{one_sv['prefill_s'] * 1e3:.3f}), decode "
              f"{out[arch]['mesh']['decode_ms_per_step']:.3f} ms a step "
              f"(one device {out[arch]['one_device']['decode_ms_per_step']:.3f}"
              f"), {sv['tok_s']:.1f} tok/s; first logits from the float32 "
              f"truth: one device {bf[0]:.3e}, mesh {bf[1]:.3e} of max (the "
              f"two {bf[2]:.3e} apart); float32 mesh {rel32:.3e} from one "
              f"device (gate {TOL_LM_LOGITS_F32:g}); greedy tokens agreeing "
              f"{out[arch]['greedy_agree']} of {LM_BATCH * LM_GEN}; peak "
              f"{pk} GB (one device {one_pk}); flash launches "
              f"{serve_shapes} {tag}")
        print(f"      prefill of {TP_PROMPT}: {long_ms:.3f} ms (one device "
              f"{one_long_ms:.3f}); logits from the truth: one device "
              f"{bf_long[0]:.3e}, mesh {bf_long[1]:.3e} ({bf_long[2]:.3e} "
              f"apart), float32 mesh {rel32_long:.3e} from one device; "
              f"flash launches {long_shapes}; collectives "
              f"{coll['prefill_ms']:.3f} ms in {coll['prefill_count']} a "
              f"prefill, {coll['decode_ms']:.3f} ms in "
              f"{coll['decode_count']} a decode step (batch 1), "
              f"{coll_serve['decode_ms']:.3f} ms a decode step at batch "
              f"{LM_BATCH}; peak {long_pk} GB; a decode step under "
              f"set_sync_debug_mode('error'); {flash_gate(arch)} {tag}")

        # -- (b) hymba-1.5b FULL ---------------------------------------------
        arch = "hymba-1.5b"
        cfg = get_config(arch)
        cfg32 = override(cfg, dtype="float32")
        sp = serve_prompts(cfg)
        one, _ = draw(cfg, False)
        one_sv, one_pk = served(cfg, one)
        truth = last_logits(cfg32, one, sp)
        del one
        sm, sm_draw = draw(cfg, True)
        sv, pk = served(cfg, sm)
        serve_shapes = launched(arch, cfg, "serve")
        bf = held(arch, truth, one_sv["first_logits"][:, -1],
                  sv["first_logits"][:, -1], "serve")
        rows += tp_rows(arch, serve_shapes)
        reset()
        rel32 = gate(arch, truth, gated(arch, cfg32, "float32 prefill",
                                        lambda: last_logits(
                                            cfg32, sm, sp, sm.policy)),
                     TOL_LM_LOGITS_F32, "float32 prefill")
        launched(arch, cfg32, "float32 prefill")
        coll = collectives(cfg, sm, sp, LM_SERVE_PROMPT + 2)
        plan = layers.head_plan(cfg, sm.px, "blocks/attn", True)
        del sm
        out[arch] = {"one_device": dict(numbers(one_sv), peak_gb=one_pk),
                     "mesh": dict(numbers(sv), draw_s=sm_draw, peak_gb=pk),
                     "bf16_from_truth_one_mesh_apart": bf,
                     "f32_rel": rel32,
                     "greedy_agree": agree(one_sv, sv),
                     "greedy_tokens": LM_BATCH * LM_GEN,
                     "flash_vs_plain_err_share": worst[arch],
                     "collectives_serve": coll,
                     "heads": {"q": plan.q, "kv": plan.kv,
                               "gather": plan.gather},
                     "flash_serve": {str(k): v
                                     for k, v in serve_shapes.items()}}
        print(f"  (b) {arch} FULL over {p} ranks (H {cfg.n_heads}, Hkv "
              f"{cfg.n_kv_heads}: query heads a rank {plan.q}, KV {plan.kv}"
              f", gathered {plan.gather}; vocabulary {cfg.vocab} over "
              f"d_model; d_inner {cfg.d_inner} over the ranks): "
              f"{summary(sv)}; prefill {sv['prefill_s'] * 1e3:.3f} ms (one "
              f"device {one_sv['prefill_s'] * 1e3:.3f}), decode "
              f"{out[arch]['mesh']['decode_ms_per_step']:.3f} ms a step "
              f"(one device {out[arch]['one_device']['decode_ms_per_step']:.3f}"
              f"); first logits from the float32 truth: one device "
              f"{bf[0]:.3e}, mesh {bf[1]:.3e} ({bf[2]:.3e} apart); float32 "
              f"mesh {rel32:.3e} from one device; greedy tokens agreeing "
              f"{out[arch]['greedy_agree']} of {LM_BATCH * LM_GEN}; "
              f"collectives {coll['prefill_ms']:.3f} ms a prefill, "
              f"{coll['decode_ms']:.3f} ms a decode step; peak {pk} GB; "
              f"flash launches {serve_shapes}; {flash_gate(arch)} {tag}")

        # -- (c) qwen3-moe-30b-a3b, expert parallel ---------------------------
        arch = TP_MOE_ARCH
        cfg = override(get_config(arch), n_layers=TP_MOE_LAYERS)
        cfg32 = override(cfg, dtype="float32")
        prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SERVE_PROMPT),
                                generator=g, device=dev0)
        one, _ = draw(cfg, False)
        one_sv, one_pk = served(cfg, one)
        one32, _ = steps.make_prefill_step(cfg32, cache_capacity=(
            LM_SERVE_PROMPT + 1))(one, tokens=prompts)
        truth = last_logits(cfg32, one, serve_prompts(cfg))
        del one
        sm, sm_draw = draw(cfg, True)
        if sm.px.tp_dim("blocks/moe/w1") != 0:
            raise AssertionError(f"{arch}: not expert parallel")
        sv, pk = served(cfg, sm)
        serve_shapes = launched(arch, cfg, "serve")
        bf = held(arch, truth, one_sv["first_logits"][:, -1],
                  sv["first_logits"][:, -1], "serve")
        reset()
        got32, _ = gated(arch, cfg32, "float32 prefill", lambda: (
            steps.make_prefill_step(cfg32, cache_capacity=(
                LM_SERVE_PROMPT + 1), policy=sm.policy)(sm, tokens=prompts)))
        launched(arch, cfg32, "float32 prefill")
        rel32 = gate(arch, one32, got32, TOL_LM_LOGITS_F32,
                     "float32 prefill")
        coll = collectives(cfg, sm, prompts, LM_SERVE_PROMPT + 2)
        del sm
        out[arch] = {"layers": TP_MOE_LAYERS,
                     "experts_per_rank": cfg.n_experts // p,
                     "one_device": dict(numbers(one_sv), peak_gb=one_pk),
                     "mesh": dict(numbers(sv), draw_s=sm_draw, peak_gb=pk),
                     "bf16_from_truth_one_mesh_apart": bf,
                     "prefill_logits_rel_f32": rel32,
                     "greedy_agree": agree(one_sv, sv),
                     "greedy_tokens": LM_BATCH * LM_GEN,
                     "flash_vs_plain_err_share": worst[arch],
                     "collectives_serve": coll}
        print(f"  (c) {arch} full width, {TP_MOE_LAYERS} of "
              f"{get_config(arch).n_layers} layers, {cfg.n_experts // p} "
              f"experts a rank: {summary(sv)}; prefill "
              f"{sv['prefill_s'] * 1e3:.3f} ms (one device "
              f"{one_sv['prefill_s'] * 1e3:.3f}), decode "
              f"{out[arch]['mesh']['decode_ms_per_step']:.3f} ms a step "
              f"(one device {out[arch]['one_device']['decode_ms_per_step']:.3f}"
              f"); float32 prefill logits {rel32:.3e} of max from one "
              f"device's (gate {TOL_LM_LOGITS_F32:g}); first logits from "
              f"the float32 truth: one device {bf[0]:.3e}, mesh {bf[1]:.3e} "
              f"({bf[2]:.3e} apart); greedy tokens agreeing "
              f"{out[arch]['greedy_agree']} of {LM_BATCH * LM_GEN}; "
              f"collectives {coll['prefill_ms']:.3f} ms a prefill, "
              f"{coll['decode_ms']:.3f} ms a decode step; peak {pk} GB; "
              f"{flash_gate(arch)} {tag}")
        if n_cards >= 2:
            full = get_config(arch)
            sm, sm_draw = draw(full, True)
            sv, pk = served(full, sm)
            launched(arch, full, "serve, all layers")
            if not bool(torch.isfinite(sv["first_logits"]).all()):
                raise AssertionError(f"{arch}: non-finite logits at "
                                     f"{full.n_layers} layers")
            del sm
            out[arch]["all_layers"] = dict(numbers(sv), draw_s=sm_draw,
                                           peak_gb=pk)
            out[arch]["flash_vs_plain_err_share"] = worst[arch]
            print(f"      all {full.n_layers} layers over {p} cards: "
                  f"{summary(sv)}; drawn and placed in {sm_draw:.1f} s; "
                  f"peak per card {pk} GB; {flash_gate(arch)} {tag}")
    finally:
        layers._flash_route, layers._plain_route = flash_route, plain_route
        fmod.flash_attention_plain = flash_plain

    # -- (d) the launcher as a user runs it -----------------------------------
    src = Path(__file__).resolve().parent / "src"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "llama3.2-3b", "--smoke", "--model-axis", "4", "--devices",
           "cuda:0,cuda:0,cuda:0,cuda:0"]
    env = dict(os.environ, PYTHONPATH=str(src))
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300)
    line = res.stdout.strip().splitlines()[-1:] or [""]
    if res.returncode != 0 or not re.match(
            r"^\S+: prefill=\d+ms decode \d+ steps=\d+ms \(\d+ tok/s\)$",
            line[0]):
        raise AssertionError(f"(d) {' '.join(cmd[1:])}: exit "
                             f"{res.returncode}, {res.stdout[-500:]!r} "
                             f"{res.stderr[-2000:]}")
    out["cli"] = line[0]
    print(f"  (d) python {' '.join(cmd[1:])}: {line[0]}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 29 took {out['seconds']:.1f} s {tag}")
    return rows, out


def mesh_ranks(p):
    """p ranks: one a card where p cards are visible, else p logical ranks
    on cuda:0 (whose times show the executor's cost, not scaling)."""
    import torch
    if torch.cuda.device_count() >= p:
        return [torch.device("cuda", i) for i in range(p)], \
            f"{p} cards, one rank each"
    return [torch.device("cuda", 0)] * p, f"{p} logical ranks on cuda:0"


def train_mesh_runs(tag):
    """Phase 30, LM training over a (data, model) mesh (see
    MESH_TRAIN_SHAPE), every check fatal.  Returns the phase's numbers."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, override
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.data.synthetic import TokenStreamSpec, batch_at
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.models import steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import (FailureInjected, LoopConfig,
                                                TrainLoop)
    from repro_torch.tree import named_leaves, stacked_tree

    t_phase = time.perf_counter()
    out = {}
    dev0 = mesh_ranks(1)[0][0]
    fmod.flash_attention.launches = 0

    def gb(n_bytes):
        return n_bytes / 1e9

    def sync(devs):
        for d in dict.fromkeys(devs):
            torch.cuda.synchronize(d)

    def reset_peaks(devs):
        """Resets each card's peak; returns what each holds, GB."""
        gc.collect()
        sync(devs)
        torch.cuda.empty_cache()
        for d in dict.fromkeys(devs):
            torch.cuda.reset_peak_memory_stats(d)
        return {str(d): gb(torch.cuda.memory_allocated(d))
                for d in dict.fromkeys(devs)}

    def peaks(devs):
        sync(devs)
        return {str(d): gb(torch.cuda.max_memory_allocated(d))
                for d in dict.fromkeys(devs)}

    def train_opt(cfg_):
        """launch.train's optimizer for --steps TRAIN_STEPS."""
        return adamw.AdamWConfig(peak_lr=3e-4,
                                 warmup_steps=max(TRAIN_STEPS // 20, 5),
                                 total_steps=TRAIN_STEPS,
                                 moment_dtype=cfg_.opt_state_dtype)

    def draw(cfg_, mesh_=None):
        """Trainable parameters from torch.Generator seed 0 on cuda:0, on
        it alone or cut over `mesh_`: the same draws either way."""
        torch.cuda.empty_cache()
        return build_model(cfg_).init(
            torch.Generator(device=dev0).manual_seed(0), dev0,
            trainable=True, mesh=mesh_)

    def run(cfg_, params, step, spec_):
        """TRAIN_STEPS steps of `step` from adamw.init over batches 0..:
        (losses, grad norms, host ms a step to a synchronised card)."""
        opt = train_opt(cfg_)
        state = adamw.init(opt, params)
        devs = params.px.devices if hasattr(params, "px") else [dev0]
        losses, norms, ms = [], [], []
        for s in range(TRAIN_STEPS):
            batch = batch_at(spec_, s)
            sync(devs)
            t1 = time.perf_counter()
            _, state, m = step(params, state, **batch)
            sync(devs)
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return losses, norms, ms

    def one_device(cfg_, spec_):
        """make_train_step on cuda:0: (losses, norms, ms, peak GB, the
        final parameters on the host by name)."""
        model = draw(cfg_)
        reset_peaks([dev0])
        res = run(cfg_, model, steps.make_train_step(
            cfg_, train_opt(cfg_), device=dev0), spec_)
        peak = peaks([dev0])[str(dev0)]
        final = {n: p.detach().to("cpu") for n, p in named_leaves(model)}
        del model
        torch.cuda.empty_cache()
        return res + (peak, final)

    def held(arch, one, mesh_run, tol):
        """The mesh's step-0 loss and gradient norm (the same parameters,
        the same batch) within `tol` relative of one device's, every loss
        and norm finite; fatal else."""
        errs = [abs(m[0] - o[0]) / abs(o[0])
                for m, o in zip(mesh_run[:2], one[:2])]
        if not all(np.isfinite(mesh_run[0] + mesh_run[1])) or \
                max(errs) > tol:
            raise AssertionError(
                f"{arch}: losses {mesh_run[0]} against one device's "
                f"{one[0]}, grad norms {mesh_run[1]} against {one[1]}: step "
                f"0 {errs[0]:.3e} / {errs[1]:.3e} relative, above {tol:g}")
        return errs

    def adam_bound(cfg_):
        """Adam moves an element by at most lr_t a step (|mhat| <= sqrt(
        vhat) where 1 - b1 <= sqrt(1 - b2), Kingma & Ba 2.1), plus the
        decay's lr_t wd |p| (|p| < 1 here): two runs from one draw lie
        at most twice the sum apart."""
        opt = train_opt(cfg_)
        lrs = [float(adamw.schedule(opt, torch.tensor(s + 1)))
               for s in range(TRAIN_STEPS)]
        return 2 * sum(lrs) * (1 + opt.weight_decay)

    def updates_alike(cfg_, sm, final, what):
        """The mesh's update against one device's from the same draw (seed
        0, drawn again on cuda:0): the relative L2 distance between the
        two updates, over the model and the worst leaf, and the largest
        element difference against Adam's bound; fatal above the gates."""
        init = draw(cfg_)
        bound = adam_bound(cfg_)
        worst, num, den, far = (0.0, None), 0.0, 0.0, 0.0
        with torch.no_grad():
            for name, p0 in named_leaves(init):
                one_p = final[name].to(dev0)
                diff = sm.whole(name, sm.copies, dev0) - one_p
                n = float(diff.double().norm()) ** 2
                dn = float((one_p - p0).double().norm()) ** 2
                num, den = num + n, den + dn
                far = max(far, amax(diff.abs()))
                share = (n / max(dn, 1e-30)) ** 0.5
                if share > worst[0]:
                    worst = (share, name)
        del init
        torch.cuda.empty_cache()
        total = (num / den) ** 0.5
        if not (total <= MESH_UPDATE_TOL and worst[0] <= MESH_LEAF_TOL
                and far <= bound):
            raise AssertionError(
                f"{what}: the mesh's update lies {total:.3e} of one "
                f"device's from it (tol {MESH_UPDATE_TOL}), worst leaf "
                f"{worst[1]} {worst[0]:.3e} (tol {MESH_LEAF_TOL}), largest "
                f"element difference {far:.3e} (Adam's bound {bound:.3e})")
        return {"update_distance": total, "worst_leaf": worst[1],
                "worst_leaf_distance": worst[0], "max_abs_diff": far,
                "adam_bound": bound}

    def state_gb(cfg_):
        """A whole replica's float32 parameters and gradients and its two
        moments."""
        n = sum(p.numel() for p in build_model(cfg_).init_shapes()
                .parameters())
        moment = getattr(torch, cfg_.opt_state_dtype).itemsize
        return gb(n * (8 + 2 * moment))

    # -- (a) llama3.2-3b FULL over (1, 4): the TrainLoop ---------------------
    ranks, layout = mesh_ranks(int(np.prod(MESH_TRAIN_SHAPE)))
    mesh = make_mesh(MESH_TRAIN_SHAPE, ("data", "model"), devices=ranks)
    print(f"  30: {layout}; {describe(mesh)}")
    out["layout"] = layout
    cfg = get_config(TRAIN_ARCH)
    spec = TokenStreamSpec(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH)
    o_loss, o_norm, o_ms, o_peak, final = one_device(cfg, spec)
    times = {"save_call": [], "write": [], "restore": []}
    real_save = ckpt_io.save

    def timed_save(*a, **k):
        t1 = time.perf_counter()
        path = real_save(*a, **k)
        times["write"].append((time.perf_counter() - t1) * 1e3)
        return path

    class TimedLoop(TrainLoop):
        def _save(self, s):
            t1 = time.perf_counter()
            super()._save(s)
            times["save_call"].append((time.perf_counter() - t1) * 1e3)

    root = tempfile.mkdtemp(prefix="repro_torch_phase30_")
    ckpt_io.save = timed_save
    norms = []
    try:
        loop = TimedLoop(cfg, train_opt(cfg), LoopConfig(
            total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
            ckpt_dir=root), mesh, data_spec=spec)
        # the step-0 save written in the save call, not beside the next
        # steps (whose times it would take)
        loop.manager = CheckpointManager(root, async_save=False)
        sm, real_step = loop.params, loop.step_fn

        def step_fn(params, state, **batch):
            res = real_step(params, state, **batch)
            norms.append(res[2]["grad_norm"])
            return res
        loop.step_fn = step_fn
        held_gb = reset_peaks(ranks)
        sm.px.timer = []
        loop.run()
        coll_ms, n_spans = sm.px.collective_ms(), len(sm.px.timer)
        sm.px.timer = None
        peak = peaks(ranks)
        m_loss = [m["loss"] for m in loop.metrics_log]
        m_norm = [float(n) for n in norms]
        m_ms = [m["time_s"] * 1e3 for m in loop.metrics_log]
        errs = held(cfg.arch, (o_loss, o_norm), (m_loss, m_norm), MESH_TOL)
        alike = updates_alike(cfg, sm, final, f"{cfg.arch} FULL")
        del final
        step_dir = os.path.join(root, "step_00000000")
        ckpt_gb = gb(sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir)))
        t1 = time.perf_counter()
        loop._restore()
        sync(ranks)
        times["restore"].append((time.perf_counter() - t1) * 1e3)
        # the restore cut the step-0 checkpoint into the shards: a leaf
        # assembled from them is the file's
        with open(os.path.join(step_dir, "manifest.json")) as f:
            recs = {r["name"]: r for r in json.load(f)["leaves"]}
        for name, key in (("embed", "params/embed"),
                          ("blocks.0.attn.wq", "params/blocks/attn/wq")):
            arr = np.load(os.path.join(step_dir, recs[key]["file"]))
            got = sm.whole(name, sm.copies)
            want = torch.from_numpy(arr if arr.ndim == got.ndim else arr[0])
            if not torch.equal(got, want):
                raise AssertionError(f"the restored {name} is not the "
                                     f"checkpoint's")
    finally:
        ckpt_io.save = real_save
        shutil.rmtree(root, ignore_errors=True)
    n_params = sum(p.numel() for p in build_model(cfg).init_shapes()
                   .parameters())
    assemble_ms = times["save_call"][0] - times["write"][0]
    out["a"] = {"arch": cfg.arch, "params": n_params,
                "shape": MESH_TRAIN_SHAPE, "losses": m_loss,
                "grad_norms": m_norm, "one_losses": o_loss,
                "one_grad_norms": o_norm, "step0_rel": errs,
                "step_ms": m_ms, "cold_step_ms": m_ms[0],
                "warm_step_ms": statistics.median(m_ms[1:]),
                "one_step_ms": o_ms, "collective_ms": coll_ms,
                "collective_spans": n_spans, "peak_gb": peak,
                "held_gb": held_gb, "one_peak_gb": o_peak, "ckpt_gb": ckpt_gb,
                "assemble_ms": assemble_ms, **times, **alike}
    print(f"  (a) {cfg.arch} FULL ({n_params:,} parameters, {cfg.dtype} "
          f"activations) over {MESH_TRAIN_SHAPE}, TrainLoop pjit at "
          f"launch.train's defaults ({TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{TRAIN_STEPS} steps): step ms {[round(t, 1) for t in m_ms]} "
          f"(cold {m_ms[0]:.1f}, warm median "
          f"{statistics.median(m_ms[1:]):.1f}; one device "
          f"{[round(t, 1) for t in o_ms]}), collectives {coll_ms:.1f} ms in "
          f"{n_spans} spans over the {TRAIN_STEPS} steps (forward and "
          f"recomputed forward; the backward's copies untimed); losses "
          f"{[round(x, 5) for x in m_loss]} (one device "
          f"{[round(x, 5) for x in o_loss]}), grad norms "
          f"{[round(x, 5) for x in m_norm]} ({[round(x, 5) for x in o_norm]}"
          f"): step 0 {errs[0]:.2e} / {errs[1]:.2e} relative (tol "
          f"{MESH_TOL:g}); the update {alike['update_distance']:.3e} of one "
          f"device's from it (tol {MESH_UPDATE_TOL}), worst leaf "
          f"{alike['worst_leaf']} {alike['worst_leaf_distance']:.3e} (tol "
          f"{MESH_LEAF_TOL}), largest difference "
          f"{alike['max_abs_diff']:.3e} (Adam's bound "
          f"{alike['adam_bound']:.3e}); peak GB {peak}, held before the "
          f"loop {held_gb} (one device {o_peak:.3f}); checkpoint "
          f"{ckpt_gb:.2f} GB: assembled on the "
          f"host in {assemble_ms:.1f} ms, written in "
          f"{[round(t, 1) for t in times['write']]} ms, restore "
          f"{[round(t, 1) for t in times['restore']]} ms (warm page cache) "
          f"{tag}")
    del loop, sm, step_fn, real_step
    torch.cuda.empty_cache()

    # -- (a') float32 SMOKE over the meshes: card against CPU ------------------
    out["smoke"] = {}
    for arch, shape in MESH_SMOKE:
        scfg = get_config(arch, smoke=True)
        src = build_model(scfg).init(torch.Generator().manual_seed(0), "cpu")
        names = [n for n, _ in named_leaves(src)]
        tree = stacked_tree(names, [p for _, p in named_leaves(src)])
        card_ranks, _ = mesh_ranks(int(np.prod(shape)))
        sbatch = batch_at(TokenStreamSpec(vocab=scfg.vocab, seq_len=48,
                                          global_batch=4, seed=1), 0)
        got = {}
        for where, devs in (("cpu", ["cpu"] * len(card_ranks)),
                            ("cuda", card_ranks)):
            smesh = make_mesh(shape, ("data", "model"), devices=devs)
            placed = lm_params_from_reference(scfg, tree, mesh=smesh,
                                              trainable=True)
            m, g = steps.grads_of(scfg, placed, steps.as_batch(
                sbatch, placed.px.devices[0]))
            g = placed.sum_copies(g)
            got[where] = (float(m["loss"]), {n: placed.whole(n, g)
                                             for n in names})
        loss_err = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
        share = max(float((got["cuda"][1][n] - got["cpu"][1][n]).abs().max())
                    / max(float(got["cpu"][1][n].abs().max()), 1e-30)
                    for n in names)
        if loss_err > TOL_TRAIN or share > TOL_TRAIN:
            raise AssertionError(f"{arch} over {shape}: card vs CPU loss "
                                 f"{loss_err:.3e}, gradients {share:.3e} "
                                 f"(tol {TOL_TRAIN})")
        out["smoke"][arch] = {"shape": shape, "loss_rel": loss_err,
                              "grad_share": share}
        print(f"  (a') {arch} SMOKE float32 over {shape}, card vs CPU: loss "
              f"{loss_err:.3e} relative, gradients {share:.3e} of each "
              f"leaf's max (tol {TOL_TRAIN}) {tag}")

    # -- (b) mixtral-8x22b at full width, cut in depth, FSDP over (2, 2) -----
    ranks, layout = mesh_ranks(4)
    mesh = make_mesh((2, 2), ("data", "model"), devices=ranks)
    out["b"] = []
    for layers, one in MESH_MOE_LAYERS:
        if not one and len(set(ranks)) < 4:
            continue         # more than one card holds: four cards only
        mcfg = override(get_config(MESH_MOE_ARCH), n_layers=layers)
        mspec = TokenStreamSpec(vocab=mcfg.vocab, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
        o_run = one_device(mcfg, mspec) if one else None
        sm = draw(mcfg, mesh)
        if not (sm.px.dp == 2 and sm.px.tp_dim("blocks/moe/w1") == 0 and
                any(dp is not None for _, dp in sm.px.splits.values())):
            raise AssertionError(f"{mcfg.arch}: not FSDP over data with "
                                 f"experts over model: {sm.px.splits}")
        held_gb = reset_peaks(ranks)
        m_run = run(mcfg, sm, steps.make_train_step(
            mcfg, train_opt(mcfg), policy=sm.policy), mspec)
        peak = peaks(ranks)
        rec = {"layers": layers, "losses": m_run[0], "grad_norms": m_run[1],
               "step_ms": m_run[2], "peak_gb": peak, "held_gb": held_gb,
               "replica_state_gb": state_gb(mcfg)}
        note = "no card holds one device's run"
        if one:
            rec["one_losses"], rec["one_grad_norms"] = o_run[0], o_run[1]
            rec["one_step_ms"], rec["one_peak_gb"] = o_run[2], o_run[3]
            rec["step0_rel"] = held(mcfg.arch, o_run, m_run, MESH_TOL)
            rec.update(updates_alike(mcfg, sm, o_run[4],
                                     f"{mcfg.arch} {layers} layers"))
            note = (f"one device: losses {[round(x, 5) for x in o_run[0]]}, "
                    f"norms {[round(x, 5) for x in o_run[1]]}, step 0 "
                    f"{rec['step0_rel'][0]:.2e} / {rec['step0_rel'][1]:.2e} "
                    f"relative (tol {MESH_TOL:g}), the update "
                    f"{rec['update_distance']:.3e} of one device's from it, "
                    f"worst leaf {rec['worst_leaf']} "
                    f"{rec['worst_leaf_distance']:.3e}, largest difference "
                    f"{rec['max_abs_diff']:.3e} (bound "
                    f"{rec['adam_bound']:.3e}); one device's ms "
                    f"{[round(t, 1) for t in o_run[2]]}, peak "
                    f"{o_run[3]:.3f} GB")
        elif not all(np.isfinite(m_run[0] + m_run[1])):
            raise AssertionError(f"{mcfg.arch} {layers} layers: losses "
                                 f"{m_run[0]}, norms {m_run[1]}")
        out["b"].append(rec)
        print(f"  (b) {mcfg.arch} full width, {layers} of 56 layers, "
              f"fsdp_tp over (2, 2) ({layout}: experts 4 a rank, FSDP over "
              f"data, the {TRAIN_BATCH} x {TRAIN_SEQ} batch routed whole in "
              f"each data group), {TRAIN_STEPS} steps: ms "
              f"{[round(t, 1) for t in m_run[2]]}, losses "
              f"{[round(x, 5) for x in m_run[0]]}, norms "
              f"{[round(x, 5) for x in m_run[1]]}; {note}; peak GB {peak} "
              f"(the parameters held before the steps {held_gb}) against "
              f"a whole replica's parameters, gradients and moments "
              f"{rec['replica_state_gb']:.3f} {tag}")
        del sm, o_run
        torch.cuda.empty_cache()

    # -- (c) a lost host on (2, 2): the loop shrinks to (1, 2) ----------------
    ccfg = override(get_config(TRAIN_ARCH), n_layers=LOOP_LAYERS,
                    param_sharding="fsdp_tp")
    cspec = TokenStreamSpec(vocab=ccfg.vocab, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH)
    copt = adamw.AdamWConfig(total_steps=LOOP_STEPS)
    fired = []

    def hook(s):
        if s == LOOP_FAIL_AT and not fired:
            fired.append(s)
            raise FailureInjected("a host lost", lost_hosts=2)

    root = tempfile.mkdtemp(prefix="repro_torch_phase30_elastic_")
    try:
        loop = TrainLoop(ccfg, copt, LoopConfig(
            total_steps=LOOP_STEPS, ckpt_every=LOOP_CKPT_EVERY,
            ckpt_dir=root), mesh, data_spec=cspec, failure_hook=hook)
        before = {t.data_ptr() for t in loop.params.parameters()}
        t1 = time.perf_counter()
        loop.run()
        c_s = time.perf_counter() - t1
        shrunk = tuple(loop.mesh.shape.values())
        replaced = not ({t.data_ptr() for t in loop.params.parameters()}
                        <= before)
        got = {m["step"]: m["loss"] for m in loop.metrics_log}
        del loop
        torch.cuda.empty_cache()
        # an uninterrupted (1, 2) loop from the same checkpoint
        fresh = TrainLoop(ccfg, copt, LoopConfig(
            total_steps=LOOP_STEPS, ckpt_every=LOOP_CKPT_EVERY,
            ckpt_dir=root), make_mesh((1, 2), ("data", "model"),
                                      devices=ranks[:2]), data_spec=cspec)
        fresh.run()
        want = {m["step"]: m["loss"] for m in fresh.metrics_log}
        del fresh
    finally:
        shutil.rmtree(root, ignore_errors=True)
    after = sorted(want)
    if not fired or shrunk != (1, 2) or not replaced or \
            after != list(range(LOOP_CKPT_EVERY + 1, LOOP_STEPS)) or \
            any(got[s] != want[s] for s in after):
        raise AssertionError(
            f"lost host: fired {fired}, mesh {shrunk}, shards placed anew "
            f"{replaced}, steps after the restore {after}, losses {got} "
            f"against {want} (each must be bitwise)")
    out["c"] = {"mesh_after": shrunk, "steps": after, "losses": got,
                "fresh": want, "seconds": c_s}
    print(f"  (c) {ccfg.arch} full width, {LOOP_LAYERS} layers, fsdp_tp, "
          f"{ccfg.dtype}, TrainLoop over (2, 2), two ranks lost at step "
          f"{LOOP_FAIL_AT}: mesh {shrunk}, the shards placed anew from step "
          f"{LOOP_CKPT_EVERY}'s checkpoint; steps {after} bitwise an "
          f"uninterrupted (1, 2) loop's from it: losses "
          f"{[got[s] for s in after]}; the loop {c_s:.1f} s {tag}")
    if fmod.flash_attention.launches:
        raise AssertionError(f"{fmod.flash_attention.launches} flash "
                             f"launches under autograd")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 30 took {out['seconds']:.1f} s {tag}")
    return out


def kendall_runs(x_dev, x_tf, reset, tag):
    """Phase 23: merge-sort Kendall at the paper's sample count, every
    check fatal.  `reset` sets the pcc kernels' launch counts to 0.  Returns
    the kernel record and the times (ms)."""
    import scipy.stats
    import torch
    from repro_torch.core import measures
    from repro_torch.core.api import clear_prepared_cache, corr
    from repro_torch.core.mapping import job_coord_batch, job_id
    from repro_torch.core.plan import ExecutionPlan, pad_operands
    from repro_torch.core.sinks import TopKSink
    from repro_torch.data.expression import ExpressionSpec, artificial
    from repro_torch.kernels import _build
    from repro_torch.kernels import kendall_merge as kmm
    from repro_torch.kernels.kendall_merge import (MAX_KERNEL_L,
                                                   SHORT_RUN_MAX,
                                                   kendall_merge_tiles,
                                                   rank_structure)
    from repro_torch.kernels.pcc_tile import (EpilogueSpec, pcc_tiles,
                                              pcc_topk_tiles)

    dev = x_dev.device
    l = x_dev.shape[1]
    n0 = l * (l - 1) // 2
    lib = _build.load("kendall_merge")
    shapes = kendall_instantiations(lib)
    kernel_names = [f"<{p_}, {e}, {g}>" for p_, e, g in shapes]
    plain = kmm.kendall_merge_tiles_plain
    plain_calls = [0]

    def counted_plain(*args, **kwargs):
        plain_calls[0] += 1
        return plain(*args, **kwargs)

    # the wrapper reaches its plain version only through this name: any
    # call during the driven runs is counted (and must not happen)
    kmm.kendall_merge_tiles_plain = counted_plain
    out = {}
    max_err = 0.0

    def same(got, want, label):
        nonlocal max_err
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel != plain (max |d| "
                                 f"{err:.3e})")

    def operand(x, t, l_blk):
        return pad_operands(measures.kendall_rank_transform(x), t, l_blk)

    def rows_of(n, lk, kind, seed):
        """Normal ("float", "narrow") or floor(8 u) ("ties") rows on the
        card: row 1 constant, row 0 one tied pair (its only tie); above l =
        33 row 5 a run of exactly SHORT_RUN_MAX; "float" and "ties" also row
        4 one value in all but its last sample and row 6 a run of
        SHORT_RUN_MAX + 1 (the kernel's uint32 keys and two sorts),
        "narrow" neither (uint16 keys, one sort a pair)."""
        r = np.random.default_rng(seed)
        x = (r.standard_normal((n, lk)) if kind != "ties"
             else np.floor(8 * r.random((n, lk)))).astype(np.float32)
        x[1] = 2.5
        if kind != "ties":
            x[0, 1] = x[0, 0]
        if kind != "narrow":
            x[4, :-1] = -1.0
        if lk > SHORT_RUN_MAX + 1:
            x[5] = r.standard_normal(lk)
            x[5, :SHORT_RUN_MAX] = 7.0
            if kind != "narrow":
                x[6] = r.standard_normal(lk)
                x[6, :SHORT_RUN_MAX + 1] = 7.0
        return torch.from_numpy(x).to(dev)

    def bitwise(n, t, l_blk, j0, tiles, lk, seed, kinds, combos):
        """Kernel against plain at one shape, every kind, each (grid,
        tau_b) of `combos`; returns the launches checked."""
        done = 0
        for kind in kinds:
            u = operand(rows_of(n, lk, kind, seed), t, l_blk)
            v = operand(rows_of(n // 2 + 7, lk, kind, 50 + seed), t, l_blk)
            if kind == "narrow" and rank_structure(u[:, :lk].float()).wide:
                raise AssertionError(f"l={lk}: narrow rows took uint32 keys")
            for grid, tau_b in combos:
                spec = EpilogueSpec(div=None if tau_b else
                                    float(lk * (lk - 1) // 2),
                                    clip=(-1.0, 1.0))
                kw = dict(t=t, l_blk=l_blk, pass_tiles=tiles,
                          epilogue=spec, v_pad=v if grid else None,
                          grid_cols=v.shape[0] // t if grid else None,
                          l=lk, tau_b=tau_b)
                same(kendall_merge_tiles(u, j0, **kw), plain(u, j0, **kw),
                     f"n={n} l={lk} t={t} j0={j0} tiles={tiles} {kind} "
                     f"grid={grid} tau_b={tau_b}")
                done += 1
        return done

    # -- 23.1 kernel against plain, bitwise ---------------------------------
    small = [  # phase 2's (n, t, l_blk, j_start, pass_tiles)
        (37, 8, 8, 0, 15), (37, 8, 8, 12, 3), (37, 8, 8, 13, 6),
        (300, 96, 64, 1, 5), (130, 16, 64, 0, 45), (600, 256, 512, 0, 6),
        (600, 256, 512, 4, 5)]
    kinds = ("float", "ties", "narrow")
    every = [(g, b) for g in (False, True) for b in (False, True)]
    checked = 0
    for i, (n, t, l_blk, j0, tiles) in enumerate(small):
        checked += bitwise(n, t, l_blk, j0, tiles, (96, 97, 130, 257)[i % 4],
                           i, kinds, every)
    print(f"  kernel vs plain at phase 2's shapes, l in 96 / 97 / 130 / 257, "
          f"float, floor(8 u) and narrow rows (a constant row, one tied "
          f"pair, runs of {SHORT_RUN_MAX} and {SHORT_RUN_MAX + 1} and of "
          f"l - 1, padding rows), triangle and grid, tau-a and tau-b: "
          f"{checked} launches bitwise")
    # every instantiation's E at the top of its range and one past it (the
    # next E's first), the warp-a-pair limit, the smallest l and the largest
    edges = {2, 31, 32, 33, MAX_KERNEL_L}
    for p_, e, _ in shapes:
        edges |= {p_ * e, p_ * e + 1}
    edges = sorted(lk for lk in edges if lk <= MAX_KERNEL_L)
    full_combos = {2, 33, 1_024, 1_025, MAX_KERNEL_L}
    before = checked
    for i, lk in enumerate(edges):
        checked += bitwise(24, 8, 8, i % 3, 3, lk, 100 + i, kinds,
                           every if lk in full_combos else [every[i % 4]])
    # the triangle with a second operand of the same shape: its diagonal
    # tiles count both halves (the rows' own triangle mirrors them)
    for lk in (96, 1_100, 5_072):
        u = operand(rows_of(37, lk, "float", 200 + lk), 8, 8)
        v = operand(rows_of(37, lk, "float", 201 + lk), 8, 8)
        for tau_b in (False, True):
            kw = dict(t=8, l_blk=8, pass_tiles=15, v_pad=v, l=lk,
                      tau_b=tau_b)
            same(kendall_merge_tiles(u, 0, **kw), plain(u, 0, **kw),
                 f"triangle with a second operand, l={lk} tau_b={tau_b}")
            checked += 1
    print(f"  kernel vs plain at l = {edges[0]} .. {edges[-1]} "
          f"({len(edges)} edges of the {len(kernel_names)} instantiations "
          f"<P, E, groups> {kernel_names[0]} .. {kernel_names[-1]}), three "
          f"kinds of rows, and the triangle with a second operand at l = "
          f"96 / 1,100 / 5,072: {checked - before} launches bitwise")
    n_tf = x_tf.shape[0]
    tplan = ExecutionPlan.create(n_tf, l, measure="kendall")
    if tplan.measure is not measures.KENDALL_MERGE:
        raise AssertionError(f"kendall at l={l} planned {tplan.measure.name}")
    u_tf = tplan.prepare(x_tf)
    x_ties = torch.floor(8 * torch.from_numpy(artificial(ExpressionSpec(
        n=n_tf, l=l, seed=4))).to(dev))
    u_ties = tplan.prepare(x_ties)
    m = tplan.m
    full = [(0, u_tf, False), (job_id(m, m // 2, m // 2), u_tf, False),
            (tplan.total_tiles - 1, u_tf, False), (0, u_ties, True)]
    plain_ms = None
    for j0, u, tau_b in full:
        kw = dict(t=tplan.t, l_blk=tplan.l_blk, pass_tiles=1, l=l,
                  epilogue=tplan.epilogue_spec if not tau_b else
                  EpilogueSpec(clip=(-1.0, 1.0)), tau_b=tau_b)
        got = kendall_merge_tiles(u, j0, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = plain(u, j0, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        plain_ms = plain_ms or ms
        y, x = job_coord_batch(m, np.array([j0]))
        same(got, want, f"full-width tile {j0} ({int(y[0])}, {int(x[0])})")
        print(f"  full width l={l}: tile {j0} = ({int(y[0])}, {int(x[0])}) "
              f"of the TF triangle, {'floor(8 u) rows, tau-b' if tau_b else 'tau-a'}: "
              f"bitwise plain (plain {ms:.1f} ms)")
    tile_ms, tile_all = event_ms(lambda: kendall_merge_tiles(
        u_tf, 0, t=tplan.t, pass_tiles=1, l=l,
        epilogue=tplan.epilogue_spec), 3)

    # -- 23.2 the slice end to end at l = 5,072 -----------------------------
    out["peak_gb"] = {}

    def run(label, fn, want, mode):
        """fn() with every launch count set to 0 just before and read just
        after: `want` merge launches of `mode`, no pcc kernel, no plain
        version.  Returns the result and its host time (ms); keeps its peak
        device memory above what was held before it in out["peak_gb"]."""
        reset()
        kendall_merge_tiles.launches = 0
        kendall_merge_tiles.launches_by_mode = {"tau_a": 0, "tau_b": 0}
        plain_calls[0] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        out["peak_gb"][label] = peak
        got = (kendall_merge_tiles.launches,
               dict(kendall_merge_tiles.launches_by_mode),
               pcc_tiles.launches, dict(pcc_topk_tiles.launches),
               plain_calls[0])
        other = "tau_b" if mode == "tau_a" else "tau_a"
        print(f"  {label}: {ms:.3f} ms, peak {peak:.3f} GB above the "
              f"{held / 1e9:.3f} held; kendall_merge_tiles launches "
              f"{got[1]}, pcc_tiles {got[2]}, pcc_topk_tiles {got[3]}, "
              f"plain calls {got[4]}")
        if got != (want, {mode: want, other: 0}, 0,
                   {"select": 0, "merge": 0}, 0):
            raise AssertionError(f"{label}: did not run through the merge "
                                 f"kernel alone, {want} launch(es)")
        return res, ms

    def symmetric(r, n, label):
        if r.shape != (n, n) or r.device.type != "cuda" or \
                not bool(torch.isfinite(r).all()) or not torch.equal(r, r.T):
            raise AssertionError(f"{label}: bad result, or not exactly "
                                 f"symmetric")

    rng = np.random.default_rng(23)
    rows8 = np.sort(rng.choice(n_tf, 8, replace=False))
    cols64 = np.sort(rng.choice(n_tf, 64, replace=False))
    ia, ib = (torch.as_tensor(a, device=dev) for a in np.triu_indices(l, 1))

    def tau_a64(x, rows, cols):
        """float64 tau-a of rows x cols by a direct count of concordant
        and discordant sample pairs (phase 13's method)."""
        xr = x[torch.as_tensor(rows, device=dev)].double()
        sr = torch.sign(xr[:, ia] - xr[:, ib])
        want = torch.empty((len(rows), len(cols)), dtype=torch.float64,
                           device=dev)
        for j, c in enumerate(cols):
            xc = x[int(c)].double()
            want[:, j] = (sr * torch.sign(xc[ia] - xc[ib])).sum(1) / n0
        return want

    def sampled_err(r, x, label):
        err = float((r[rows8][:, cols64].double()
                     - tau_a64(x, rows8, cols64)).abs().max())
        print(f"  {label}: 8 rows x 64 columns against a float64 direct "
              f"count, max |d| = {err:.3e} (tol {TOL_KENDALL:g})")
        if not err <= TOL_KENDALL:
            raise AssertionError(f"{label}: disagrees with the direct count")
        return err

    def scipy_err(r, x, label):
        xh = x.cpu().numpy()
        rh = r[torch.as_tensor(rows8, device=dev)].cpu().numpy()
        err = 0.0
        for a, i in enumerate(rows8):
            for c in cols64:
                want = scipy.stats.kendalltau(xh[i], xh[c],
                                              variant="b").statistic
                want = 0.0 if np.isnan(want) else want
                err = max(err, abs(float(rh[a, c]) - want))
        print(f"  {label}: 8 rows x 64 columns against "
              f"scipy.stats.kendalltau(variant='b'), max |d| = {err:.3e} "
              f"(tol {TOL_KENDALL:g})")
        if not err <= TOL_KENDALL:
            raise AssertionError(f"{label}: disagrees with scipy")

    clear_prepared_cache()
    print(f"  corr over the {n_tf} TF rows at l={l}: {tplan.total_tiles} "
          f"tiles, {tplan.n_pass} pass")
    ra, out["tf_tau_a_ms"] = run("corr(x_tf, measure='kendall')",
                                 lambda: corr(x_tf, measure="kendall"),
                                 tplan.n_pass, "tau_a")
    main_launches = kendall_merge_tiles.launches
    symmetric(ra, n_tf, "TF tau-a")
    sampled_err(ra, x_tf, "TF tau-a")
    rb, out["tf_tau_b_ms"] = run("corr(x_tf, measure='kendall_tau_b')",
                                 lambda: corr(x_tf, measure="kendall_tau_b"),
                                 tplan.n_pass, "tau_b")
    symmetric(rb, n_tf, "TF tau-b")
    scipy_err(rb, x_tf, "TF tau-b")
    rt, out["tf_ties_tau_b_ms"] = run(
        "corr(floor(8 u), measure='kendall_tau_b')",
        lambda: corr(x_ties, measure="kendall_tau_b"), tplan.n_pass, "tau_b")
    symmetric(rt, n_tf, "floor(8 u) tau-b")
    scipy_err(rt, x_ties, "floor(8 u) tau-b")
    del rb, rt
    tk, out["tf_topk_ms"] = run(
        f"corr(x_tf, measure='kendall', sink=TopKSink({K_TOP}))",
        lambda: corr(x_tf, measure="kendall", sink=TopKSink(K_TOP)),
        tplan.n_pass, "tau_a")
    key = ra[torch.as_tensor(rows8, device=dev)].abs()
    key[torch.arange(8), torch.as_tensor(rows8, device=dev)] = -1.0
    want_c = torch.sort(key, dim=1, descending=True,
                        stable=True).indices[:, :K_TOP]
    got_c = torch.as_tensor(tk["indices"][rows8], device=dev).long()
    got_v = torch.as_tensor(tk["values"][rows8], device=dev)
    if not torch.equal(got_c, want_c) or not torch.equal(
            got_v, torch.take_along_dim(
                ra[torch.as_tensor(rows8, device=dev)], want_c, dim=1)):
        raise AssertionError("TopKSink over merge tiles is not the dense "
                             "result's canonical top-k")
    print(f"  TopKSink({K_TOP}): 8 rows' lists the dense tau-a's canonical "
          f"top-{K_TOP} (|v| descending, then column), values bitwise")
    r5, out["tf_5tile_ms"] = run(
        "corr(x_tf, measure='kendall', max_tiles_per_pass=5)",
        lambda: corr(x_tf, measure="kendall", max_tiles_per_pass=5),
        -(-tplan.total_tiles // 5), "tau_a")
    if not torch.equal(r5, ra):
        raise AssertionError("5-tile passes changed tau-a's bits")
    print("  5-tile passes: bitwise the one-pass result")
    del r5
    gplan = ExecutionPlan.create(n_tf, l, n_cols=x_dev.shape[0],
                                 measure="kendall")
    rg, out["grid_ms"] = run(
        f"corr(x_tf, x, measure='kendall'), {gplan.total_tiles} grid tiles",
        lambda: corr(x_tf, x_dev, measure="kendall"), gplan.n_pass, "tau_a")
    grid_launches = kendall_merge_tiles.launches
    if rg.shape != (n_tf, x_dev.shape[0]) or not bool(torch.isfinite(rg).all()):
        raise AssertionError("bad TF x Table II Kendall result")
    cols_g = np.sort(rng.choice(x_dev.shape[0], 64, replace=False))
    err = float((rg[rows8][:, cols_g].double()
                 - tau_a64(torch.cat([x_tf, x_dev]), rows8,
                           cols_g + n_tf)).abs().max())
    print(f"  TF x Table II: 8 rows x 64 columns against a float64 direct "
          f"count, max |d| = {err:.3e} (tol {TOL_KENDALL:g})")
    if not err <= TOL_KENDALL:
        raise AssertionError("TF x Table II Kendall disagrees with the count")
    del rg

    # -- 23.3 the Table II triangle, if the grid says it fits ---------------
    splan = ExecutionPlan.create(x_dev.shape[0], l, measure="kendall")
    extra = out["grid_ms"] * splan.total_tiles / gplan.total_tiles / 1e3
    print(f"  Table II triangle: {splan.total_tiles} tiles, extrapolated "
          f"from the grid run {extra:.1f} s")
    if extra < 60.0:
        rs, out["table2_ms"] = run(
            "corr(x, measure='kendall') at Table II",
            lambda: corr(x_dev, measure="kendall"), splan.n_pass, "tau_a")
        symmetric(rs, x_dev.shape[0], "Table II tau-a")
        sampled_err(rs, x_dev, "Table II tau-a")
        del rs
    else:
        out["table2_ms"] = None
        print("  Table II triangle not run: over 60 s")
    clear_prepared_cache()

    # -- 23.4 crossover: sign-GEMM (float32, int8) against the merge --------
    variants = {"kendall_sign_gemm": dict(measure="kendall_sign_gemm"),
                "kendall int8": dict(measure="kendall",
                                     compute_dtype=torch.int8),
                "kendall_merge": dict(measure="kendall_merge")}
    cross = {name: {} for name in variants}
    for lc in (64, 96, 128, 256, 512, 1024):
        xs = x_tf[:, :lc].contiguous()
        line = []
        for name, kw in variants.items():
            def call():
                clear_prepared_cache()
                return corr(xs, **kw)
            try:
                ms, _ = host_ms(call, 3)
            except ValueError as exc:
                ms = None
                line.append(f"{name} refused ({exc})")
            else:
                line.append(f"{name} {ms:.3f}")
            cross[name][lc] = ms
        print(f"  crossover, TF rows at l={lc} (corr with its transform, "
              f"median of 3, ms): " + "; ".join(line))
    clear_prepared_cache()

    def crossover(a, b):
        """The smallest l from which b is faster than a at every measured l
        after it (None: never)."""
        ls = sorted(l_ for l_ in cross[a] if cross[a][l_] is not None
                    and cross[b][l_] is not None)
        won = [cross[b][l_] < cross[a][l_] for l_ in ls]
        for i, l_ in enumerate(ls):
            if all(won[i:]):
                return l_
        return None

    out["crossover"] = {f"{a} -> {b}": crossover(a, b) for a, b in (
        ("kendall_sign_gemm", "kendall_merge"),
        ("kendall int8", "kendall_merge"),
        ("kendall_sign_gemm", "kendall int8"))}
    out["crossover_ms"] = cross
    print(f"  crossover (smallest measured l from which the second is "
          f"faster): {out['crossover']} [KENDALL_MERGE_CROSSOVER_L stays "
          f"{measures.KENDALL_MERGE_CROSSOVER_L}, the reference's]")

    # -- 23.5 times and bound ------------------------------------------------
    pass_ms, pass_all = event_ms(lambda: kendall_merge_tiles(
        u_tf, 0, t=tplan.t, pass_tiles=tplan.total_tiles, l=l,
        epilogue=tplan.epilogue_spec), 3)
    prep_ms, _ = event_ms(lambda: rank_structure(u_tf[:, :l]), 3)
    cur, top = sm_clock_mhz()
    int_ops_s = 64 * 132 * top * 1e6
    # the least compares this run's data needs: a sort of the l keys of
    # each pair of distinct non-constant rows (l log2 l), and before it, for
    # a row with ties, the sort of each of its tie runs (c log2 c a run of
    # c); a pair with a constant side is 0 by Knight's identity and needs
    # none.  A diagonal tile holds each of its pairs twice (and each row
    # with itself): there each pair i < j counts once, with the cheaper of
    # the two rows' tie-run sorts.
    st = rank_structure(u_tf[:, :l])
    runs = st.runs[:, :l].long()
    run_len = torch.zeros(runs.shape, dtype=torch.float64,
                          device=dev).scatter_add_(
        1, runs, torch.ones_like(runs, dtype=torch.float64))
    run_sort = (run_len * torch.log2(run_len.clamp(min=1.0))).sum(1)
    nc = (st.ties < n0).double().view(m, tplan.t)
    cost = (l * np.log2(l) + run_sort).view(m, tplan.t)
    ys, xs_ = job_coord_batch(m, np.arange(tplan.total_tiles))
    ops = pairs = 0.0
    for y, x in zip(ys.tolist(), xs_.tolist()):
        if y != x:
            ops += float((cost[y] * nc[y]).sum() * nc[x].sum())
            pairs += float(nc[y].sum() * nc[x].sum())
        else:
            both = torch.triu(nc[y][:, None] * nc[y][None, :], 1)
            ops += float((both * torch.minimum(cost[y][:, None],
                                               cost[y][None, :])).sum())
            pairs += float(both.sum())
    tied_rows = int(((st.ties > 0) & (st.ties < n0)).sum())
    st_bytes = sum(a.numel() * a.element_size() for a in (
        st.order, st.runs, st.codes, st.ties, st.longest))
    nbytes = u_tf.numel() * 4 + tplan.total_tiles * tplan.t ** 2 * 4
    bound = (ops / int_ops_s * 1e3, "operations")
    if nbytes / HBM_BYTES_S * 1e3 > bound[0]:
        bound = (nbytes / HBM_BYTES_S * 1e3, "bytes")
    del st

    # library yardstick: one torch._int_mm on the int8 pair signs of the
    # TF rows (C(l, 2) columns), built outside the timed window
    lib_ms = None
    try:
        n8 = -(-n_tf // 8) * 8
        signs = torch.zeros((n8, n0), dtype=torch.int8, device=dev)
        for r0 in range(0, n_tf, 32):
            xr = x_tf[r0:r0 + 32]
            signs[r0:r0 + xr.shape[0]] = torch.sign(
                xr[:, ia] - xr[:, ib]).to(torch.int8)
        cmd = torch._int_mm(signs, signs.t())
        torch.cuda.synchronize()
        # the library's exact C - D of every TF pair, through the same
        # epilogue: the merge kernel's tau-a, bit for bit
        if not torch.equal(tplan.epilogue_spec.apply(
                cmd[:n_tf, :n_tf].to(torch.float32)), ra):
            raise AssertionError("the merge kernel's tau-a differs from "
                                 "torch._int_mm's C - D on the pair signs")
        print("  torch._int_mm's C - D of all TF pairs, through the same "
              "epilogue: bitwise the merge kernel's tau-a")
        lib_ms, lib_all = event_ms(lambda: torch._int_mm(signs, signs.t()),
                                   3)
        print(f"  library yardstick torch._int_mm on the int8 pair signs "
              f"({n8} x {n0}, {signs.numel() / 1e9:.1f} GB): {lib_ms:.3f} ms "
              f"(runs {[round(v, 3) for v in lib_all]})")
        del signs, cmd
    except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
        print(f"  library yardstick: none (torch._int_mm: "
              f"{str(exc).splitlines()[0]})")
    torch.cuda.empty_cache()
    occupancy = kendall_occupancy(lib, shapes, tplan.t)
    main_occ = {}
    for u, data in ((u_tf, "TF rows"), (u_ties, "floor(8 u) rows")):
        wide = rank_structure(u[:, :l]).wide
        o = main_occ[data] = kendall_launch_shape(lib, l, tplan.t, wide)
        print(f"  at l={l} ({data}, {'uint32' if wide else 'uint16'} "
              f"keys): P {o['p']}, E {o['e']}, {o['groups']} group(s) a "
              f"CTA, {o['code_buffers']} code buffer(s), {o['smem']} bytes "
              f"of dynamic shared memory, {o['regs']} registers, "
              f"{o['ctas_per_sm']} CTAs an SM")
    out.update(pass_ms=pass_ms, tile_ms=tile_ms, plain_tile_ms=plain_ms,
               prep_ms=prep_ms, structure_mb=st_bytes / 1e6,
               bound_ms=bound[0], library_ms=lib_ms,
               occupancy={f"<{p_}, {e}> {'u32' if w else 'u16'}":
                          [o["ctas_per_sm"], o["regs"], o["smem"]]
                          for (p_, e, w), o in occupancy.items()})
    print(f"  kendall_merge_tiles at the TF triangle ({tplan.total_tiles} "
          f"tiles, one launch): {pass_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in pass_all]}; the rank structures, made "
          f"once per operand, {prep_ms:.3f} ms more, {st_bytes / 1e6:.1f} "
          f"MB kept); one tile {tile_ms:.3f} ms, its plain version "
          f"{plain_ms:.3f} ms; bound {bound[0]:.3f} ms ({bound[1]}: "
          f"{pairs:.6g} pairs of distinct non-constant rows, each once, x "
          f"{l} x log2 {l}, plus "
          f"the tie-run sorts of {tied_rows} rows with ties = {ops:.6g} "
          f"compares at 64 x 132 x {top:.0f} MHz = {int_ops_s:.4g}/s; "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; SM clock now {cur:.0f} MHz) "
          f"{tag}")
    kmm.kendall_merge_tiles_plain = plain
    record = {"name": "kendall_merge_tiles", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/kendall_merge.cu",
              "replaces": "src/repro/kernels/kendall_merge.py:125",
              "launches": main_launches, "max_abs_err": max_err,
              "ms": pass_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
              "bound_by": bound[1], "library_ms": lib_ms,
              "plain_ms_covers": "one of the launch's tiles",
              "grid_launches": grid_launches,
              "ctas_per_sm": main_occ["TF rows"]["ctas_per_sm"]}
    return record, out


def kendall_launch_shape(lib, l, t, wide):
    """The kendall_merge launch at l with tiles of t and uint16 or uint32
    (wide) keys, as the kernel library reports it: its geometry, code
    buffers, dynamic and static shared memory, registers and CTAs an SM by
    the occupancy calculator."""
    buf = (ctypes.c_int * 8)()
    err = lib.kendall_merge_occupancy(l, t, int(wide), buf)
    if err != 0:
        raise AssertionError(f"kendall_merge_occupancy({l}, {t}, {wide}): "
                             f"{lib.kendall_merge_error_string(err).decode()}")
    o = dict(zip(("p", "e", "groups", "code_buffers", "smem", "ctas_per_sm",
                  "regs", "static_smem"), list(buf)))
    if o["ctas_per_sm"] < 1:
        raise AssertionError(f"kendall_merge at l={l}: {o}")
    return o


def kendall_instantiations(lib):
    """The kendall_merge kernel's instantiations [(P, E, groups), ...], in
    the order a launch tries them, as its library lists them."""
    buf = (ctypes.c_int * 192)()
    n = lib.kendall_merge_instantiations(buf, 64)
    if not 0 < n <= 64:
        raise AssertionError(f"kendall_merge_instantiations: {n}")
    return [tuple(buf[3 * k:3 * k + 3]) for k in range(n)]


def kendall_occupancy(lib, shapes, t):
    """Each kendall_merge instantiation's launch at l = P E, tiles of t,
    uint16 and uint32 keys (kendall_launch_shape): {(P, E, wide): dict}.
    Prints one line per instantiation."""
    out = {}
    for p, e, groups in shapes:
        line = []
        for wide in (False, True):
            o = kendall_launch_shape(lib, p * e, t, wide)
            if (o["p"], o["e"], o["groups"]) != (p, e, groups):
                raise AssertionError(f"kendall_merge <{p}, {e}>: {o}")
            out[(p, e, wide)] = o
            line.append(f"{'uint32' if wide else 'uint16'} keys "
                        f"{o['smem']} + {o['static_smem']} bytes, "
                        f"{o['code_buffers']} code buffer(s), "
                        f"{o['ctas_per_sm']} CTAs an SM")
        print(f"  kendall_merge_kernel<{p}, {e}, {groups}> "
              f"(l <= {p * e}): {o['regs']} registers; " + "; ".join(line))
    return out


def main(argv) -> int:
    t_script = time.perf_counter()
    # --overlap-only SRC: phase 20 alone, on the package under SRC (an
    # earlier tree of this repository, for a before / after comparison)
    # --lm-mesh-only: the build and phase 29 alone (a call on several cards)
    # --lm-train-mesh-only: phase 30 alone (it launches no kernel: no build)
    overlap_only = argv[:1] == ["--overlap-only"]
    mesh_only = argv == ["--lm-mesh-only"]
    train_mesh_only = argv == ["--lm-train-mesh-only"]
    if (overlap_only and len(argv) != 2) or \
            (argv and not (overlap_only or mesh_only or train_mesh_only)):
        print("usage: chip_smoke.py [--overlap-only SRC | --lm-mesh-only | "
              "--lm-train-mesh-only]", file=sys.stderr)
        return 2
    src = (Path(argv[1]) if overlap_only
           else Path(__file__).resolve().parent / "src")
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no package at {(src / 'repro_torch').resolve()}"
              f": run the script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src.resolve()))
    import torch

    from repro_torch.core import measures, pcc
    from repro_torch.core.api import corr
    from repro_torch.core.mapping import job_coord_batch
    from repro_torch.core.plan import ExecutionPlan, pad_operands, pad_scales
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.core.significance import (PermutationSpec,
                                               iteration_indices,
                                               replica_operand)
    from repro_torch.data.expression import ExpressionSpec, artificial
    from repro_torch.core.sinks import DeviceTopKSink, TopKSink
    from repro_torch.kernels import _build
    from repro_torch.kernels import pcc_tile as kmod
    from repro_torch.kernels.narrow_gate import gate_share, narrow_gate
    from repro_torch.kernels.pcc_tile import (
        EpilogueSpec, pcc_tiles, pcc_tiles_plain, pcc_topk_tiles,
        pcc_topk_tiles_plain, topk_fold_plain, topk_merge, topk_merge_plain,
        topk_scratch_bytes, topk_select)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # The plain versions' products must stay IEEE float32, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; allow_tf32=False (matmul, cudnn)")

    if train_mesh_only:
        tag = f"[{card}]"
        print(f"LM training over a (data, model) mesh (make_train_step("
              f"policy=), TrainLoop pjit) {tag}:")
        print(json.dumps({"train_mesh": train_mesh_runs(tag)}, default=str))
        print(f"script time {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"kernels": []}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # -- 1. build -----------------------------------------------------------
    def watched(entry):
        """A readable name for the kernels redesigned on this path (the
        float32 tile kernel's four instantiations, the four selects, the
        merge kernel's two, the float32 flash kernel's five head tiles,
        the int8 and float16 tensor-core tile kernels' two each) and the
        merge-sort Kendall kernel's (one per instantiation <P, E, groups>),
        None for the others;
        `entry` is ptxas' "Compiling entry function" line."""
        if entry is None:
            return None
        if "flash_fwdILi" in entry:
            dp = entry.split("flash_fwdILi", 1)[1].split("E", 1)[0]
            return f"flash_fwd<{dp}>"
        # int8_t is mangled "a", __half "6__half"
        for mangled, name in (("IaLb", "int8_t"), ("I6__halfLb", "__half")):
            if "pcc_tiles_sm90" + mangled in entry:
                flag = entry.split("pcc_tiles_sm90" + mangled, 1)[1][0]
                return f"pcc_tiles_sm90<{name}, scaled={flag}>"
        if "pcc_tiles_f32_kernel" in entry:
            flags = entry.split("pcc_tiles_f32_kernel", 1)[1][:12]
            return (f"pcc_tiles_f32_kernel<scaled={flags[3]}, "
                    f"replica={flags[7]}>")
        if "pcc_topk_select_f32_kernel" in entry:
            return "pcc_topk_select_f32_kernel"
        if "pcc_topk_select_sm90" in entry:
            return "pcc_topk_select_sm90<%s>" % (
                "int8_t" if "pcc_topk_select_sm90IaE" in entry else
                "__half" if "pcc_topk_select_sm90I6__halfE" in entry
                else "bf16")
        if "pcc_topk_merge_kernelILi" in entry:
            kw = entry.split("pcc_topk_merge_kernelILi", 1)[1].split("E")[0]
            return f"pcc_topk_merge_kernel<{kw}>"
        if "kendall_merge_kernelILi" in entry:
            p, e, g = re.findall(r"Li(\d+)E", entry.split(
                "kendall_merge_kernel", 1)[1])[:3]
            return f"kendall_merge_kernel<{p}, {e}, {g}>"
        return None

    report = {}
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        entry = None
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"  {name}: {line.strip()}")
            if "Compiling entry function" in line:
                entry = line
            if "Used" in line and "registers" in line and watched(entry):
                regs = line.split("Used", 1)[1].split("registers")[0]
                report[watched(entry)] = int(regs)
            if "spill stores" in line:
                print(f"  {name}: {line.strip()}")
                # the tensor-core kernels, the float32 tile and flash
                # kernels, the selects and the merge may not spill
                new = name == "pcc_tile_sm90" or watched(entry)
                if new and not line.strip().startswith(
                        "0 bytes stack frame, 0 bytes spill stores, "
                        "0 bytes spill loads"):
                    raise AssertionError(f"{name}: {entry.strip()} "
                                         f"spills: {line.strip()}")
    print("  registers, no spills: " + "; ".join(
        f"{k} {v}" for k, v in sorted(report.items())))
    # the plain versions' calls are counted from here on (phases 6-26
    # require none), the kernels' launches set to 0 by reset_counts()
    plain_calls = {"pcc_tiles_plain": 0, "pcc_topk_tiles_plain": 0}

    def counted(name):
        fn = getattr(kmod, name)

        def wrapper(*args, **kwargs):
            plain_calls[name] += 1
            return fn(*args, **kwargs)
        setattr(kmod, name, wrapper)

    for name in plain_calls:
        counted(name)

    def reset_counts():
        pcc_tiles.launches = 0
        pcc_tiles.scaled_launches = 0
        pcc_tiles.triangle_pair_launches = 0
        pcc_tiles.replica_launches = 0
        pcc_tiles.replicas_launched = 0
        pcc_topk_tiles.launches = {"select": 0, "merge": 0}
        pcc_tiles.launches_by_dtype = {k: 0 for k in
                                       pcc_tiles.launches_by_dtype}
        pcc_topk_tiles.select_by_dtype = {k: 0 for k in
                                          pcc_topk_tiles.select_by_dtype}
        for name in plain_calls:
            plain_calls[name] = 0

    if overlap_only:
        x_dev = torch.from_numpy(artificial(ExpressionSpec(
            n=N_SEEK, l=L_SEEK, seed=0))).to(dev)
        print(f"multi-pass top-k at Table II, package {src} [{card}]:")
        res = overlap_runs(x_dev, K_TOP, SPLIT)
        print(f"script time {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"overlap": res, "src": str(src), "card": card}))
        return 0
    if mesh_only:
        tag = f"[{card}]"
        print(f"LM serving over a (data, model) mesh (models/parallel.py), "
              f"flash on each rank's heads {tag}:")
        tp_rows, tp_out = tp_runs(tag)
        print(json.dumps({"tp": tp_out}, default=str))
        print(f"script time {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"kernels": tp_rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    # (this tree's kernels: --overlap-only may build an earlier tree's)
    kendall_kernels = {f"kendall_merge_kernel<{p}, {e}, {g}>" for p, e, g
                       in kendall_instantiations(_build.load("kendall_merge"))}
    if len(report) != 19 + len(kendall_kernels) or \
            not kendall_kernels <= set(report):
        raise AssertionError(
            f"ptxas reported {sorted(report)}: expected the 4 float32 "
            f"tile, the 4 select (float32; int8, bf16 and fp16 on the "
            f"tensor cores), the 2 merge, the 5 float32 flash, the 2 int8 "
            f"and 2 fp16 tensor-core tile and the {len(kendall_kernels)} "
            f"kendall_merge kernels")
    simt = _build.load("pcc_tile")
    gone = [f"pcc_tiles_{s}" for s in ("bf16", "f16", "e4m3", "e5m2", "i8")]
    if any(hasattr(simt, fn) for fn in gone):
        raise AssertionError(f"the SIMT tile library still exports one "
                             f"of {gone}")
    print(f"  the SIMT tile library exports none of {gone}: bf16, fp16, "
          f"fp8 and int8 tiles run only on pcc_tile_sm90.cu")

    # -- 2. kernel against plain --------------------------------------------
    def operand(x: torch.Tensor, t: int, l_blk: int) -> torch.Tensor:
        return pad_operands(pcc.transform(x, dtype=torch.float32), t, l_blk)

    def compare(u, j_start, t, l_blk, pass_tiles, spec, tol, label):
        got = pcc_tiles(u, j_start, t=t, l_blk=l_blk, pass_tiles=pass_tiles,
                        epilogue=spec)
        want = pcc_tiles_plain(u, j_start, t=t, l_blk=l_blk,
                               pass_tiles=pass_tiles, epilogue=spec)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"  {label}: max|kernel - plain| = {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{label}: kernel disagrees with plain")
        if spec is not None:
            raw = pcc_tiles(u, j_start, t=t, l_blk=l_blk,
                            pass_tiles=pass_tiles)
            if not torch.equal(got, spec.apply(raw)):
                raise AssertionError(f"{label}: fused epilogue != unfused")
        return err

    epilogues = {"none": None, "clip": EpilogueSpec(clip=(-1.0, 1.0)),
                 "div_clip": EpilogueSpec(div=7.0, clip=(-0.05, 0.05))}
    rng = np.random.default_rng(0)
    small = [  # n, l, t, l_blk, j_start, pass_tiles
        (37, 29, 8, 8, 0, 15),        # every tile
        (37, 20, 8, 8, 12, 3),        # ragged pass, l_pad not a multiple of 16
        (37, 29, 8, 8, 13, 6),        # clamped ids past the end
        (300, 700, 96, 64, 1, 5),     # t not a multiple of a CTA's block
        (130, 300, 16, 64, 0, 45),
        (600, 1000, 256, 512, 0, 6),  # plan defaults, every tile
        (600, 1000, 256, 512, 4, 5),  # plan defaults, clamped
    ]
    max_err = 0.0
    print("kernel vs plain, small shapes:")
    for n, l, t, l_blk, j0, tiles in small:
        x = torch.from_numpy(rng.standard_normal((n, l)).astype(np.float32))
        u = operand(x.to(dev), t, l_blk)
        for name, spec in epilogues.items():
            max_err = max(max_err, compare(
                u, j0, t, l_blk, tiles, spec, TOL_SMALL,
                f"n={n} l={l} t={t} l_blk={l_blk} j0={j0} tiles={tiles} "
                f"{name}"))

    x_seek = artificial(ExpressionSpec(n=N_SEEK, l=L_SEEK, seed=0))
    x_dev = torch.from_numpy(x_seek).to(dev)
    plan = ExecutionPlan.create(N_SEEK, L_SEEK)
    u_seek = plan.prepare(x_dev)
    total = plan.total_tiles
    print(f"kernel vs plain, Table II operand {tuple(u_seek.shape)}, "
          f"{total} tiles:")
    max_err = max(max_err, compare(u_seek, 0, plan.t, plan.l_blk, total,
                                   plan.epilogue_spec, TOL_FULL,
                                   "full pass, Pearson epilogue"))
    max_err = max(max_err, compare(u_seek, total - 100, plan.t, plan.l_blk,
                                   SPLIT, None, TOL_FULL,
                                   "clamped pass, no epilogue"))

    # -- 3. the main path ---------------------------------------------------
    print(f"main path: corr(x) at n={N_SEEK} l={L_SEEK}, plan defaults "
          f"t={plan.t} l_blk={plan.l_blk}, {plan.n_pass} pass(es)")
    pcc_tiles.launches = 0
    r = corr(x_seek)
    torch.cuda.synchronize()
    launches = pcc_tiles.launches
    print(f"  pcc_tiles launches: {launches}")
    if launches < 1 or launches != plan.n_pass:
        raise AssertionError("corr did not run through the CUDA kernel")
    if r.shape != (N_SEEK, N_SEEK) or r.device.type != "cuda":
        raise AssertionError(f"bad result {tuple(r.shape)} on {r.device}")
    if not bool(torch.isfinite(r).all()):
        raise AssertionError("non-finite correlations")
    if not torch.equal(r, r.T):
        raise AssertionError("result is not exactly symmetric")
    rows = torch.as_tensor(np.sort(rng.choice(N_SEEK, SAMPLE_ROWS,
                                              replace=False)), device=dev)
    u64 = pcc.transform(x_dev.double())
    ref64 = torch.clamp(u64[rows] @ u64.T, -1.0, 1.0)
    err64 = float((r[rows].double() - ref64).abs().max())
    print(f"  {SAMPLE_ROWS} rows vs float64: max|d| = {err64:.3e} "
          f"(tol {TOL_F64:g})")
    if not err64 <= TOL_F64:
        raise AssertionError("corr disagrees with the float64 rows")
    del u64, ref64

    pcc_tiles.launches = 0
    r_split = corr(x_seek, max_tiles_per_pass=SPLIT)
    torch.cuda.synchronize()
    split_plan = ExecutionPlan.create(N_SEEK, L_SEEK, max_tiles_per_pass=SPLIT)
    print(f"  max_tiles_per_pass={SPLIT}: launch sizes "
          f"{split_plan.launch_sizes}, pcc_tiles launches "
          f"{pcc_tiles.launches}")
    if pcc_tiles.launches != split_plan.n_pass:
        raise AssertionError("split run did not launch once per pass")
    if not torch.equal(r, r_split):
        raise AssertionError("result depends on the pass split")
    del r_split

    x_small = rng.standard_normal((300, 200)).astype(np.float32)
    r_small = corr(x_small, t=64, l_blk=64, max_tiles_per_pass=4)
    want = np.corrcoef(x_small.astype(np.float64))
    err_small = float(np.abs(r_small.cpu().numpy() - want).max())
    print(f"  small corr (300 x 200) vs numpy float64: max|d| = "
          f"{err_small:.3e} (tol {TOL_SMALL:g})")
    if r_small.shape != (300, 300) or not err_small <= TOL_SMALL:
        raise AssertionError("small corr disagrees with numpy")

    # -- 4. times -----------------------------------------------------------
    spec = plan.epilogue_spec
    kern_ms, kern_all = event_ms(lambda: pcc_tiles(
        u_seek, 0, t=plan.t, l_blk=plan.l_blk, pass_tiles=total,
        epilogue=spec), 5)
    plain_ms, plain_all = event_ms(lambda: pcc_tiles_plain(
        u_seek, 0, t=plan.t, l_blk=plan.l_blk, pass_tiles=total,
        epilogue=spec), 3)
    lib_ms, lib_all = event_ms(lambda: torch.matmul(u_seek, u_seek.T), 5)
    del r
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    corr_ms, corr_all = host_ms(lambda: corr(x_dev), 3)
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    corr_np_ms, corr_np_all = host_ms(lambda: corr(x_seek), 3)

    flop = 2 * L_SEEK * plan.t * plan.t * total
    nbytes = u_seek.numel() * 4 + total * plan.t * plan.t * 4
    flop_ms = flop / FP32_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    bound_by = "operations" if flop_ms >= byte_ms else "bytes"
    tag = f"[{card}]"
    print(f"times at Table II shape {tag}:")
    print(f"  pcc_tiles, one pass of {total} tiles: {kern_ms:.3f} ms "
          f"(runs {[round(v, 3) for v in kern_all]}), "
          f"{flop / kern_ms / 1e9:.1f} TFLOP/s")
    print(f"  bound: {bound_ms:.3f} ms by {bound_by} ({flop:.4g} FLOP at "
          f"{FP32_FLOPS / 1e12:g} TFLOP/s = {flop_ms:.3f} ms; {nbytes:.4g} B "
          f"at {HBM_BYTES_S / 1e12:g} TB/s = {byte_ms:.3f} ms)")
    print(f"  pcc_tiles_plain: {plain_ms:.3f} ms "
          f"(runs {[round(v, 3) for v in plain_all]})")
    print(f"  library torch.matmul(u, u.T) {tuple(u_seek.shape)}, full "
          f"square: {lib_ms:.3f} ms (runs {[round(v, 3) for v in lib_all]})")
    print(f"  corr end to end, x on the card: {corr_ms:.3f} ms "
          f"(runs {[round(v, 3) for v in corr_all]}), peak "
          f"{peak_gb:.3f} GB above the {base_mem / 1e9:.3f} GB held")
    print(f"  corr end to end, x as host numpy: {corr_np_ms:.3f} ms "
          f"(runs {[round(v, 3) for v in corr_np_all]})")

    # -- 5. top-k and grid kernels against plain ---------------------------
    def bound(flop, nbytes):
        f_ms = flop / FP32_FLOPS * 1e3
        b_ms = nbytes / HBM_BYTES_S * 1e3
        return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes")

    def dense_from_tiles(tiles, m, t, cols, grid_cols):
        ids = np.arange(tiles.shape[0])
        ys, xs = (divmod(ids, grid_cols) if grid_cols
                  else job_coord_batch(m, ids))
        r_pad = torch.zeros(m * t, cols, device=dev)
        r_pad.view(m, t, -1, t)[torch.as_tensor(ys, device=dev), :,
                                torch.as_tensor(xs, device=dev), :] = tiles
        if grid_cols is None:
            upper = torch.ones_like(r_pad, dtype=torch.bool).triu()
            r_pad = torch.where(upper, r_pad, r_pad.T)
        return r_pad

    clip = EpilogueSpec(clip=(-1.0, 1.0))
    topk_err = grid_err = 0.0
    near_ties = 0
    print("top-k and grid kernels vs plain, small ragged shapes "
          f"(tol {TOL_SMALL:g}):")
    for n, n_cols, l, t, l_blk in [(1000, 700, 300, 64, 64),
                                   (1000, 700, 300, 256, 512)]:
        xs_ = torch.from_numpy(rng.standard_normal((n, l)).astype(
            np.float32)).to(dev)
        ys_ = torch.from_numpy(rng.standard_normal((n_cols, l)).astype(
            np.float32)).to(dev)
        u, v = operand(xs_, t, l_blk), operand(ys_, t, l_blk)
        m = u.shape[0] // t
        for grid in (False, True):
            gc = v.shape[0] // t if grid else None
            cols = v if grid else u
            total_s = m * gc if grid else m * (m + 1) // 2
            exact = dense_from_tiles(
                pcc_tiles(u, 0, t=t, l_blk=l_blk, pass_tiles=total_s,
                          epilogue=clip, v_pad=v if grid else None,
                          grid_cols=gc), m, t, cols.shape[0], gc)
            third = -(-total_s // 3)
            ties_here = 0
            for j0, pt, short in [(0, third, 0), (third, third, 0),
                                  (2 * third, total_s - 2 * third, 1)]:
                if grid:
                    gkw = dict(t=t, l_blk=l_blk, pass_tiles=pt,
                               epilogue=clip, v_pad=v, grid_cols=gc)
                    err = float((pcc_tiles(u, j0, **gkw)
                                 - pcc_tiles_plain(u, j0, **gkw))
                                .abs().max())
                    if not err <= TOL_SMALL:
                        raise AssertionError("grid kernel disagrees with "
                                             "plain")
                    grid_err = max(grid_err, err)
                for kk in (1, 10, 64):
                    kw = dict(t=t, l_blk=l_blk, pass_tiles=pt, kk=kk,
                              n_cols_valid=n_cols if grid else n,
                              symmetric_problem=not grid, epilogue=clip,
                              v_pad=v if grid else None, grid_cols=gc)
                    got = pcc_topk_tiles(u, j0, j0 + pt - short, **kw)
                    want = pcc_topk_tiles_plain(u, j0, j0 + pt - short,
                                                **kw)
                    torch.cuda.synchronize()
                    label = (f"{'grid' if grid else 'triangle'} n={n} "
                             f"t={t} j0={j0} tiles={pt} kk={kk}")
                    for side in range(len(got) // 2):
                        pair = got[2 * side:2 * side + 2]
                        err, ties = check_topk_state(
                            pair, want[2 * side:2 * side + 2], u.double(),
                            cols.double(), clip, TOL_SMALL, label)
                        topk_err = max(topk_err, err)
                        ties_here += ties
                        vals, cc = pair
                        ok = cc >= 0
                        rows = (torch.arange(vals.shape[0] * t, device=dev)
                                .view(-1, t, 1).expand_as(cc))
                        ref = (exact if side == 0 else exact.T)[
                            rows[ok], cc[ok].long()]
                        if not torch.equal(vals[ok], ref):
                            raise AssertionError(f"{label}: top-k values "
                                                 f"are not pcc_tiles' bits")
            near_ties += ties_here
            print(f"  {'grid' if grid else 'triangle'} n={n} "
                  f"n_cols={n_cols if grid else n} l={l} t={t}: "
                  f"{total_s} tiles in 3 passes (last dev_hi short by 1), "
                  f"kk 1/10/64 ok, {ties_here} near-tie column swaps")
    print(f"  top-k max|kernel - plain| = {topk_err:.3e}, grid max|kernel "
          f"- plain| = {grid_err:.3e}, near-ties allowed: {near_ties}; "
          f"top-k values bitwise equal to pcc_tiles")

    # -- 6. symmetric top-k at Table II --------------------------------------
    def check_launches(label, want_tiles, want_topk, dtype="float32"):
        """Since reset_counts(), the CUDA kernels of operand type `dtype`
        ran as planned, no kernel of another type ran, and no plain
        version did."""
        got = (pcc_tiles.launches, dict(pcc_tiles.launches_by_dtype),
               dict(pcc_topk_tiles.launches),
               dict(pcc_topk_tiles.select_by_dtype))
        print(f"  {label}: pcc_tiles launches {got[1]}, pcc_topk_tiles "
              f"launches {got[2]}, select by dtype {got[3]}, plain calls "
              f"{plain_calls}")
        want = (want_tiles,
                {k: want_tiles if k == dtype else 0 for k in got[1]},
                {"select": want_topk, "merge": want_topk},
                {k: want_topk if k == dtype else 0 for k in got[3]})
        if got != want or any(plain_calls.values()):
            raise AssertionError(f"{label}: did not run through the {dtype} "
                                 f"CUDA kernels as planned")

    def same_topk(a, b, label):
        if not (np.array_equal(a["indices"], b["indices"])
                and a["values"].tobytes() == b["values"].tobytes()):
            raise AssertionError(f"{label}: DeviceTopKSink differs from "
                                 f"TopKSink")

    def topk_vs_plain(u, j0, pt, dev_hi, *, t, l_blk, kk, n_cols_valid,
                      spec, v=None, gc=None, chunk=None, tol=TOL_FULL):
        """pcc_topk_tiles against pcc_topk_tiles_plain on one pass at
        `tol`; returns (max |kernel - plain|, near-ties).  With `chunk`,
        the plain version's two halves run as pcc_topk_tiles_plain runs
        them, pcc_tiles_plain then topk_fold_plain, with the tiles computed
        `chunk` at a time so that its batched gathers fit on the card."""
        kw = dict(t=t, l_blk=l_blk, pass_tiles=pt, kk=kk,
                  n_cols_valid=n_cols_valid, symmetric_problem=gc is None,
                  epilogue=spec, v_pad=v, grid_cols=gc)
        got = pcc_topk_tiles(u, j0, dev_hi, **kw)
        if chunk is None:
            want = pcc_topk_tiles_plain(u, j0, dev_hi, **kw)
        else:
            n_valid = min(pt, dev_hi - j0)
            tiles = torch.cat([pcc_tiles_plain(
                u, j0 + i, t=t, l_blk=l_blk,
                pass_tiles=min(chunk, n_valid - i), epilogue=spec, v_pad=v,
                grid_cols=gc) for i in range(0, n_valid, chunk)])
            want = topk_fold_plain(
                tiles, j0, m=u.shape[0] // t, t=t, kk=kk,
                n_cols_valid=n_cols_valid, symmetric_problem=gc is None,
                grid_cols=gc, device=dev)
            del tiles
        torch.cuda.synchronize()
        u64 = u.double()
        v64 = u64 if v is None else v.double()
        err = ties = 0
        for side in range(len(got) // 2):
            e, n_t = check_topk_state(
                got[2 * side:2 * side + 2], want[2 * side:2 * side + 2],
                u64, v64, spec, tol,
                f"top-k kernel vs plain {tuple(u.shape)} j0={j0} tiles={pt}")
            err, ties = max(err, e), ties + n_t
        return err, ties

    class TimedDeviceTopKSink(DeviceTopKSink):
        """Times the host merge of each pass's state (after the device has
        delivered it), which runs once the pass is complete."""

        def __init__(self, k):
            super().__init__(k)
            self.merge_ms = []

        def _merge_pending(self):
            if not self._pending:
                return
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            super()._merge_pending()
            self.merge_ms.append((time.perf_counter() - t1) * 1e3)

    print(f"symmetric top-k: corr(x, sink=DeviceTopKSink({K_TOP})) at "
          f"n={N_SEEK} l={L_SEEK}")
    reset_counts()
    res = corr(x_seek, sink=DeviceTopKSink(K_TOP))
    torch.cuda.synchronize()
    check_launches("one pass", 0, plan.n_pass)
    topk_launches = dict(pcc_topk_tiles.launches)
    if res["indices"].shape != (N_SEEK, K_TOP) or \
            (res["indices"] < 0).any() or \
            not np.isfinite(res["values"]).all():
        raise AssertionError("bad top-k result")
    same_topk(res, corr(x_seek, sink=TopKSink(K_TOP)), "one pass")
    reset_counts()
    res_split = corr(x_seek, sink=DeviceTopKSink(K_TOP),
                     max_tiles_per_pass=SPLIT)
    check_launches(f"max_tiles_per_pass={SPLIT}", 0, split_plan.n_pass)
    same_topk(res_split, corr(x_seek, sink=TopKSink(K_TOP),
                              max_tiles_per_pass=SPLIT), "split")
    same_topk(res, res_split, "pass split")
    print(f"  bit-identical to TopKSink({K_TOP}) fed by pcc_tiles, one pass "
          f"and {SPLIT}-tile passes")
    u64 = pcc.transform(x_dev.double())
    rows16 = torch.as_tensor(np.sort(rng.choice(N_SEEK, CHECK_ROWS,
                                                replace=False)), device=dev)
    err, ties = check_rows_topk(res, rows16, u64, u64, K_TOP, True, TOL_F64,
                                "Table II top-k")
    print(f"  {CHECK_ROWS} rows vs float64 top-k: max|d| = {err:.3e} "
          f"(tol {TOL_F64:g}), {ties} near-tie column swaps")
    del res_split
    scratch_b = topk_scratch_bytes(total, plan.t, K_TOP, True)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    topk_corr_ms, topk_corr_all = host_ms(
        lambda: corr(x_dev, sink=DeviceTopKSink(K_TOP)), 3)
    topk_peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    merge_pass = {}
    for mtp in (None, SPLIT):
        snk = TimedDeviceTopKSink(K_TOP)
        corr(x_dev, sink=snk, max_tiles_per_pass=mtp)
        merge_pass[mtp] = snk.merge_ms
    print(f"  corr with DeviceTopKSink({K_TOP}), x on the card: "
          f"{topk_corr_ms:.3f} ms (runs {[round(v, 3) for v in topk_corr_all]})"
          f", peak {topk_peak_gb:.3f} GB above the {base_mem / 1e9:.3f} GB "
          f"held (dense corr: {peak_gb:.3f} GB); pass scratch "
          f"{scratch_b} B ({scratch_b / total:.0f} B per tile, tile "
          f"{plan.t * plan.t * 4} B)")
    print(f"  host merge (DeviceTopKSink, at pass_complete) per pass: one "
          f"pass {[round(v, 3) for v in merge_pass[None]]} ms; {SPLIT}-tile "
          f"passes {[round(v, 3) for v in merge_pass[SPLIT]]} ms")

    # -- 7. symmetric top-k at n = 64,000 ------------------------------------
    x64k = torch.from_numpy(artificial(ExpressionSpec(
        n=N_64K, l=L_64K, seed=0))).to(dev)
    plan64 = ExecutionPlan.create(N_64K, L_64K)
    print(f"symmetric top-k at n={N_64K} l={L_64K}, k={K_TOP}: "
          f"{plan64.total_tiles} tiles, {plan64.n_pass} pass(es), scratch "
          f"{topk_scratch_bytes(plan64.max_tiles_per_pass, plan64.t, K_TOP, True)} B")
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    res64 = corr(x64k, sink=DeviceTopKSink(K_TOP))
    torch.cuda.synchronize()
    ms_64k = (time.perf_counter() - t1) * 1e3
    peak_64k = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    check_launches("n=64,000", 0, plan64.n_pass)
    rows64 = torch.as_tensor(np.sort(rng.choice(N_64K, CHECK_ROWS,
                                                replace=False)), device=dev)
    del u64
    u64k = pcc.transform(x64k.double())
    err, ties = check_rows_topk(res64, rows64, u64k, u64k, K_TOP, True,
                                TOL_F64, "n=64,000 top-k")
    del u64k
    u_pad64 = plan64.prepare(x64k)
    del x64k
    err64k, ties64k = topk_vs_plain(
        u_pad64, 0, plan64.total_tiles, plan64.total_tiles, t=plan64.t,
        l_blk=plan64.l_blk, kk=K_TOP, n_cols_valid=N_64K,
        spec=plan64.epilogue_spec, chunk=4_000)
    topk_err = max(topk_err, err64k)
    del u_pad64
    print(f"  top-k kernel vs plain on the whole {plan64.total_tiles}-tile "
          f"pass: max|kernel - plain| = {err64k:.3e} (tol {TOL_FULL:g}), "
          f"{ties64k} near-tie column swaps")
    flop_64k = 2 * L_64K * plan64.t ** 2 * plan64.total_tiles
    print(f"  {ms_64k:.3f} ms (one run, first at this shape, x on the card; "
          f"{flop_64k / ms_64k / 1e9:.1f} TFLOP/s), peak {peak_64k:.3f} GB "
          f"above the {base_mem / 1e9:.3f} GB held (the dense result alone "
          f"would be {N_64K ** 2 * 4 / 1e9:.1f} GB); {CHECK_ROWS} rows vs "
          f"float64 top-k: max|d| = {err:.3e} (tol {TOL_F64:g}), {ties} "
          f"near-tie column swaps")

    # -- 8. rectangular X-vs-Y -----------------------------------------------
    x_tf = torch.from_numpy(artificial(ExpressionSpec(
        n=N_TF, l=L_SEEK, seed=1))).to(dev)
    rplan = ExecutionPlan.create(N_TF, L_SEEK, n_cols=N_SEEK)
    print(f"rectangular: corr(x, y) with x {N_TF} x {L_SEEK}, y {N_SEEK} x "
          f"{L_SEEK}: {rplan.total_tiles} tiles ({rplan.m} x "
          f"{rplan.workload.grid_cols}), {rplan.n_pass} pass(es)")
    reset_counts()
    rr = corr(x_tf, x_dev)
    torch.cuda.synchronize()
    check_launches("dense", rplan.n_pass, 0)
    grid_launches = pcc_tiles.launches
    if rr.shape != (N_TF, N_SEEK) or not bool(torch.isfinite(rr).all()):
        raise AssertionError("bad rectangular result")
    rows_tf = torch.as_tensor(np.sort(rng.choice(N_TF, CHECK_ROWS,
                                                 replace=False)), device=dev)
    ux64 = pcc.transform(x_tf.double())
    uy64 = pcc.transform(x_dev.double())
    err = float((rr[rows_tf].double()
                 - torch.clamp(ux64[rows_tf] @ uy64.T, -1.0, 1.0))
                .abs().max())
    print(f"  {CHECK_ROWS} rows vs float64: max|d| = {err:.3e} "
          f"(tol {TOL_F64:g})")
    if not err <= TOL_F64:
        raise AssertionError("rectangular corr disagrees with float64")
    del rr
    reset_counts()
    rtk = corr(x_tf, x_dev, sink=DeviceTopKSink(K_TOP))
    torch.cuda.synchronize()
    check_launches(f"DeviceTopKSink({K_TOP})", 0, rplan.n_pass)
    grid_topk_launches = pcc_topk_tiles.launches["merge"]
    same_topk(rtk, corr(x_tf, x_dev, sink=TopKSink(K_TOP)), "rectangular")
    err, ties = check_rows_topk(rtk, rows_tf, ux64, uy64, K_TOP, False,
                                TOL_F64, "rectangular top-k")
    print(f"  bit-identical to TopKSink({K_TOP}); {CHECK_ROWS} rows vs "
          f"float64 top-k: max|d| = {err:.3e}, {ties} near-tie swaps")
    del ux64, uy64
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rect_ms, rect_all = host_ms(lambda: corr(x_tf, x_dev), 3)
    rect_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    torch.cuda.reset_peak_memory_stats()
    rtk_ms, rtk_all = host_ms(
        lambda: corr(x_tf, x_dev, sink=DeviceTopKSink(K_TOP)), 3)
    rtk_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    print(f"  dense corr(x, y), x and y on the card: {rect_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in rect_all]}), peak {rect_peak:.3f} GB; "
          f"with DeviceTopKSink({K_TOP}): {rtk_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in rtk_all]}), peak {rtk_peak:.3f} GB "
          f"above the {base_mem / 1e9:.3f} GB held")

    # -- 9. kernel times: top-k at Table II, grid at the rectangular shape ---
    u_tf, v_sk = rplan.prepare_pair(x_tf, x_dev)
    rtotal = rplan.total_tiles
    print(f"top-k kernel vs plain at the passes the driven paths launch "
          f"(tol {TOL_FULL:g}):")
    for label, args, kws in [
            ("Table II, one pass", (u_seek, 0, total, total), {}),
            (f"Table II, {SPLIT}-tile pass 5", (u_seek, 4 * SPLIT, SPLIT,
                                              total), {}),
            (f"Table II, last {SPLIT}-tile pass", (
                u_seek, sum(split_plan.launch_sizes[:-1]),
                split_plan.launch_sizes[-1], total), {}),
            ("rectangular, one pass", (u_tf, 0, rtotal, rtotal), dict(
                v=v_sk, gc=rplan.workload.grid_cols))]:
        p_ = rplan if kws else plan
        err, ties = topk_vs_plain(
            *args, t=p_.t, l_blk=p_.l_blk, kk=K_TOP,
            n_cols_valid=N_SEEK, spec=p_.epilogue_spec, **kws)
        topk_err = max(topk_err, err)
        print(f"  {label}: max|kernel - plain| = {err:.3e}, {ties} near-tie "
              f"column swaps")
    def merge_vs_plain(scratch, n_tiles, mkw, label):
        """The merge kernel on a select kernel's scratch of one whole pass
        from tile 0, bitwise topk_merge_plain's state on it; returns (max
        |kernel - plain| over the values, entries held, the bytes the merge
        must move: each list's head value, each held entry's value and
        column, the state written)."""
        got = topk_merge(scratch, 0, n_tiles, **mkw)
        want = topk_merge_plain(scratch, 0, n_tiles, **mkw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"{label}: the merge kernel's state is "
                                     f"not topk_merge_plain's bits")
        err = max(amax((got[i] - want[i]).abs())
                  for i in range(0, len(got), 2))
        held = sum(int((got[i] >= 0).sum()) for i in range(1, len(got), 2))
        m_, t_, kk_ = got[0].shape
        ids = np.arange(n_tiles)
        ys, xs = (divmod(ids, mkw["grid_cols"]) if mkw.get("grid_cols")
                  else job_coord_batch(m_, ids))
        lists = (n_tiles + (0 if mkw.get("grid_cols") else
                            int((ys != xs).sum()))) * t_ * -(-t_ // 64)
        need = 4 * lists + 8 * held + len(got) // 2 * m_ * t_ * kk_ * 8
        print(f"  merge kernel vs topk_merge_plain, {label}: bitwise "
              f"({held} entries held, {lists} lists)")
        return err, held, need

    kw = dict(t=plan.t, l_blk=plan.l_blk, pass_tiles=total, kk=K_TOP,
              n_cols_valid=N_SEEK, symmetric_problem=True, epilogue=spec)
    sel_ms, sel_all = event_ms(lambda: topk_select(u_seek, 0, total, **kw), 5)
    scratch = topk_select(u_seek, 0, total, **kw)
    mkw = dict(m=plan.m, t=plan.t, pass_tiles=total, kk=K_TOP)
    merge_err, _, merge_need = merge_vs_plain(scratch, total, mkw,
                                              "Table II one pass")
    merge_ms, merge_all = event_ms(lambda: topk_merge(
        scratch, 0, total, **mkw), 5)
    merge_plain_ms, merge_plain_all = event_ms(lambda: topk_merge_plain(
        scratch, 0, total, **mkw), 3)
    del scratch
    # the grid pass: the merge, and one library call ranking the same
    # candidates (|v| of each row's lists side by side, no columns and no
    # canonical tie order)
    g_gc = rplan.workload.grid_cols
    gtk = dict(t=rplan.t, l_blk=rplan.l_blk, pass_tiles=rtotal, kk=K_TOP,
               n_cols_valid=N_SEEK, symmetric_problem=False,
               epilogue=rplan.epilogue_spec, v_pad=v_sk, grid_cols=g_gc)
    g_scr = topk_select(u_tf, 0, rtotal, **gtk)
    g_mkw = dict(m=rplan.m, t=rplan.t, pass_tiles=rtotal, kk=K_TOP,
                 grid_cols=g_gc)
    g_merge_err, _, g_merge_need = merge_vs_plain(g_scr, rtotal, g_mkw,
                                                  "grid one pass")
    merge_err = max(merge_err, g_merge_err)
    g_merge_ms, g_merge_all = event_ms(lambda: topk_merge(
        g_scr, 0, rtotal, **g_mkw), 5)
    g_merge_plain_ms, _ = event_ms(lambda: topk_merge_plain(
        g_scr, 0, rtotal, **g_mkw), 3)
    g_keys = (g_scr[0].view(rplan.m, g_gc, rplan.t, -1).abs()
              .permute(0, 2, 1, 3).reshape(rplan.m * rplan.t, -1))
    g_lib_ms, g_lib_all = event_ms(
        lambda: torch.topk(g_keys, K_TOP, dim=1), 5)
    g_merge_bound, g_merge_by = bound(0, g_merge_need)
    del g_scr, g_keys
    both_ms, both_all = event_ms(
        lambda: pcc_topk_tiles(u_seek, 0, total, **kw), 5)
    ptk_ms, ptk_all = event_ms(
        lambda: pcc_topk_tiles_plain(u_seek, 0, total, **kw), 3)
    tiles_plain = pcc_tiles_plain(u_seek, 0, t=plan.t, l_blk=plan.l_blk,
                                  pass_tiles=total, epilogue=spec)
    fold_ms, fold_all = event_ms(lambda: topk_fold_plain(
        tiles_plain, 0, m=plan.m, t=plan.t, kk=K_TOP, n_cols_valid=N_SEEK,
        symmetric_problem=True, grid_cols=None, device=dev), 3)
    del tiles_plain
    libk_ms, libk_all = event_ms(lambda: torch.topk(
        torch.matmul(u_seek, u_seek.T).abs(), K_TOP, dim=1), 3)
    state_b = 4 * plan.m * plan.t * K_TOP * 4
    sel_bound, sel_by = bound(flop, u_seek.numel() * 4 + scratch_b)
    merge_bound, merge_by = bound(0, merge_need)
    both_bound, both_by = bound(flop, u_seek.numel() * 4 + state_b)
    print(f"top-k times at Table II shape, one pass, kk={K_TOP} {tag}:")
    print(f"  select kernel: {sel_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in sel_all]}), bound {sel_bound:.3f} ms by "
          f"{sel_by}")
    print(f"  merge kernel: {merge_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in merge_all]}), bound {merge_bound:.3f} ms "
          f"by {merge_by} ({merge_need:.4g} B it must move: list heads, "
          f"held entries, state; the whole scratch and state would be "
          f"{scratch_b + state_b:.4g} B, "
          f"{(scratch_b + state_b) / HBM_BYTES_S * 1e3:.3f} ms); "
          f"topk_merge_plain on its scratch: {merge_plain_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in merge_plain_all]})")
    print(f"  grid pass ({rplan.m} x {g_gc} tiles): merge kernel "
          f"{g_merge_ms:.3f} ms (runs {[round(v, 3) for v in g_merge_all]}),"
          f" bound {g_merge_bound:.3f} ms by {g_merge_by} ({g_merge_need:.4g}"
          f" B); topk_merge_plain {g_merge_plain_ms:.3f} ms; library "
          f"torch.topk(|scratch values| per row, {K_TOP}), no "
          f"columns, no canonical tie order: {g_lib_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in g_lib_all]})")
    print(f"  pcc_topk_tiles (both): {both_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in both_all]}), bound {both_bound:.3f} ms by "
          f"{both_by}")
    print(f"  pcc_topk_tiles_plain: {ptk_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in ptk_all]}), bound {both_bound:.3f} ms; "
          f"its fold alone (topk_fold_plain): {fold_ms:.3f} ms, bound "
          f"{merge_bound:.3f} ms")
    print(f"  library torch.topk(torch.matmul(u, u.T).abs(), {K_TOP}) "
          f"{tuple(u_seek.shape)}, full square, no canonical tie order, "
          f"self-pairs kept: {libk_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in libk_all]}), bound {both_bound:.3f} ms")

    gkw = dict(t=rplan.t, l_blk=rplan.l_blk, pass_tiles=rtotal,
               epilogue=rplan.epilogue_spec, v_pad=v_sk,
               grid_cols=rplan.workload.grid_cols)
    err = float((pcc_tiles(u_tf, 0, **gkw) - pcc_tiles_plain(u_tf, 0, **gkw))
                .abs().max())
    if not err <= TOL_FULL:
        raise AssertionError("grid kernel disagrees with plain at full shape")
    grid_err = max(grid_err, err)
    grid_ms, grid_all = event_ms(lambda: pcc_tiles(u_tf, 0, **gkw), 5)
    gplain_ms, gplain_all = event_ms(lambda: pcc_tiles_plain(u_tf, 0, **gkw),
                                     3)
    glib_ms, glib_all = event_ms(lambda: torch.matmul(u_tf, v_sk.T), 5)
    gflop = 2 * L_SEEK * rplan.t ** 2 * rtotal
    grid_bound, grid_by = bound(gflop, (u_tf.numel() + v_sk.numel()) * 4
                                + rtotal * rplan.t ** 2 * 4)
    print(f"grid times at {N_TF} x {N_SEEK} x {L_SEEK}, one pass of {rtotal} "
          f"tiles {tag}:")
    print(f"  pcc_tiles grid: {grid_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in grid_all]}), {gflop / grid_ms / 1e9:.1f} "
          f"TFLOP/s, bound {grid_bound:.3f} ms by {grid_by}; max|kernel - "
          f"plain| {err:.3e} (tol {TOL_FULL:g})")
    print(f"  pcc_tiles_plain grid: {gplain_ms:.3f} ms; library "
          f"torch.matmul(u, v.T) {tuple(u_tf.shape)} x {tuple(v_sk.shape)}: "
          f"{glib_ms:.3f} ms; bound {grid_bound:.3f} ms")

    # -- 10. bf16 / int8 operand modes against float32 and plain -------------
    def kendall_operand(x, t, l_blk):
        return pad_operands(measures.pair_sign_transform(
            x[:, :L_KENDALL], dtype=torch.int8), t, l_blk)

    print("bf16 / fp16 / int8 kernels at the phase 2 shapes: bf16 and fp16 "
          "within the narrow gate of the plain version (the planted faults "
          "refused), int8 (Kendall signs) bitwise the plain version, top-k "
          "values bitwise pcc_tiles':")
    narrow_err = {"bfloat16": 0.0, "float16": 0.0, "int8": 0.0}
    narrow_share = {"bfloat16": 0.0, "float16": 0.0}
    fault_min = {}
    narrow_ties = 0
    for n, l, t, l_blk, j0, tiles in small:
        n_cols = n // 2 + 3
        xs_ = torch.from_numpy(rng.standard_normal((n, l)).astype(
            np.float32)).to(dev)
        ys_ = torch.from_numpy(rng.standard_normal((n_cols, l)).astype(
            np.float32)).to(dev)
        ops = {"bfloat16": (operand(xs_, t, l_blk).to(torch.bfloat16),
                            operand(ys_, t, l_blk).to(torch.bfloat16)),
               "float16": (operand(xs_, t, l_blk).to(torch.float16),
                           operand(ys_, t, l_blk).to(torch.float16)),
               "int8": (kendall_operand(xs_, t, l_blk),
                        kendall_operand(ys_, t, l_blk))}
        for dname, (u, v) in ops.items():
            m = u.shape[0] // t
            for grid in (False, True):
                gc = v.shape[0] // t if grid else None
                vv = v if grid else None
                total_s = m * gc if grid else m * (m + 1) // 2
                label = (f"{dname} {'grid' if grid else 'triangle'} n={n} "
                         f"width={u.shape[1]} t={t} l_blk={l_blk} j0={j0} "
                         f"tiles={tiles}")
                slack = 0.0   # the largest gate: bf16 top-k value slack
                for spec in epilogues.values():
                    kw = dict(t=t, l_blk=l_blk, pass_tiles=tiles,
                              epilogue=spec, v_pad=vv, grid_cols=gc)
                    if dname in narrow_share:
                        got, share, err, gmax, fault = narrow_readings(
                            u, j0, kw, label, faults=spec is None)
                        narrow_share[dname] = max(narrow_share[dname], share)
                        slack = max(slack, gmax)
                        for name, f in fault.items():
                            fault_min[(dname, name)] = min(
                                fault_min.get((dname, name), f), f)
                    else:
                        got = pcc_tiles(u, j0, **kw)
                        want = pcc_tiles_plain(u, j0, **kw)
                        if not torch.equal(got, want):
                            raise AssertionError(f"{label}: int8 kernel != "
                                                 f"plain")
                        err = float((got - want).abs().max())
                    narrow_err[dname] = max(narrow_err[dname], err)
                exact = dense_from_tiles(
                    pcc_tiles(u, 0, t=t, l_blk=l_blk, pass_tiles=total_s,
                              epilogue=clip, v_pad=vv, grid_cols=gc),
                    m, t, (v if grid else u).shape[0], gc)
                dev_hi = min(j0 + tiles, total_s)
                for kk in (1, 10, 64):
                    kw = dict(t=t, l_blk=l_blk, pass_tiles=tiles, kk=kk,
                              n_cols_valid=n_cols if grid else n,
                              symmetric_problem=not grid, epilogue=clip,
                              v_pad=vv, grid_cols=gc)
                    got = pcc_topk_tiles(u, j0, dev_hi, **kw)
                    want = pcc_topk_tiles_plain(u, j0, dev_hi, **kw)
                    torch.cuda.synchronize()
                    if dname == "int8" and not all(
                            torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"{label} kk={kk}: int8 top-k "
                                             f"state != plain")
                    for side in range(len(got) // 2):
                        pair = got[2 * side:2 * side + 2]
                        if dname in narrow_share:
                            cols_op = (v if grid else u).double()
                            err, ties = check_topk_state(
                                pair, want[2 * side:2 * side + 2],
                                u.double(), cols_op, clip,
                                TOL_SMALL + slack, f"{label} kk={kk}")
                            narrow_err[dname] = max(narrow_err[dname], err)
                            narrow_ties += ties
                        vals, cc = pair
                        ok = cc >= 0
                        rows = (torch.arange(vals.shape[0] * t, device=dev)
                                .view(-1, t, 1).expand_as(cc))
                        ref = (exact if side == 0 else exact.T)[
                            rows[ok], cc[ok].long()]
                        if not torch.equal(vals[ok], ref):
                            raise AssertionError(f"{label} kk={kk}: top-k "
                                                 f"values are not pcc_tiles' "
                                                 f"bits")
    print(f"  {len(small)} shapes x (bf16, fp16, int8) x (triangle, grid): "
          f"all bitwise checks hold; " + "; ".join(
              f"{d} at most {narrow_share[d]:.4g} of the narrow gate, "
              f"max|kernel - plain| {narrow_err[d]:.3e}, planted faults "
              f"refused at >= {fault_min[(d, 'chunk zeroed')]:.4g} (chunk "
              f"zeroed) and {fault_min[(d, 'chunk twice')]:.4g} (chunk "
              f"twice) of it" for d in narrow_share)
          + f"; int8 {narrow_err['int8']:.3e}; bf16 / fp16 top-k values "
          f"within {TOL_SMALL:g} + the gate of float64, near-tie column "
          f"swaps {narrow_ties}; int8 top-k states equal to plain")

    def rows_err(r, ref64, rows):
        return float((r[rows].double() - ref64).abs().max())

    # -- 11. Spearman at Table II -------------------------------------------
    splan = ExecutionPlan.create(N_SEEK, L_SEEK, measure="spearman")
    print(f"Spearman: corr(x, measure='spearman') at n={N_SEEK} l={L_SEEK}, "
          f"{splan.n_pass} pass(es)")
    reset_counts()
    rsp = corr(x_dev, measure="spearman")
    torch.cuda.synchronize()
    check_launches("dense", splan.n_pass, 0)
    if rsp.shape != (N_SEEK, N_SEEK) or not bool(torch.isfinite(rsp).all()):
        raise AssertionError("bad Spearman result")
    if not torch.equal(rsp, rsp.T):
        raise AssertionError("Spearman result is not exactly symmetric")
    u64 = pcc.transform(measures.rank_rows(x_dev.double()))
    err_sp = rows_err(rsp, torch.clamp(u64[rows16] @ u64.T, -1.0, 1.0),
                      rows16)
    print(f"  {CHECK_ROWS} rows vs float64 Spearman (ranks, then Pearson): "
          f"max|d| = {err_sp:.3e} (tol {TOL_F64:g})")
    if not err_sp <= TOL_F64:
        raise AssertionError("Spearman disagrees with float64")
    del u64, rsp
    reset_counts()
    res_sp = corr(x_dev, measure="spearman", sink=DeviceTopKSink(K_TOP))
    torch.cuda.synchronize()
    check_launches(f"DeviceTopKSink({K_TOP})", 0, splan.n_pass)
    same_topk(res_sp, corr(x_dev, measure="spearman", sink=TopKSink(K_TOP)),
              "Spearman")
    print(f"  DeviceTopKSink({K_TOP}) bit-identical to TopKSink({K_TOP})")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    sp_ms, sp_all = host_ms(lambda: corr(x_dev, measure="spearman"), 3)
    sp_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    sptk_ms, sptk_all = host_ms(lambda: corr(
        x_dev, measure="spearman", sink=DeviceTopKSink(K_TOP)), 3)
    sptr_ms, sptr_all = host_ms(lambda: splan.prepare(x_dev), 3)
    print(f"  dense {sp_ms:.3f} ms (runs {[round(v, 3) for v in sp_all]}), "
          f"peak {sp_peak:.3f} GB; top-k {sptk_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in sptk_all]}); the rank transform alone "
          f"(plan.prepare) {sptr_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in sptr_all]}) {tag}")

    # -- 12. bf16 Pearson at Table II -----------------------------------------
    bplan = ExecutionPlan.create(N_SEEK, L_SEEK, compute_dtype=torch.bfloat16)
    u_bf = bplan.prepare(x_dev)
    print(f"bf16 Pearson: corr(x, compute_dtype=torch.bfloat16) at "
          f"n={N_SEEK} l={L_SEEK}: operand {u_bf.numel() * 2 / 1e6:.1f} MB "
          f"(float32 {u_seek.numel() * 4 / 1e6:.1f} MB)")
    reset_counts()
    rbf = corr(x_dev, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    check_launches("dense", bplan.n_pass, 0, "bfloat16")
    bf_tiles_launches = pcc_tiles.launches_by_dtype["bfloat16"]
    if not bool(torch.isfinite(rbf).all()) or not torch.equal(rbf, rbf.T):
        raise AssertionError("bad bf16 result")
    u64 = pcc.transform(x_dev.double())
    err_bf = rows_err(rbf, torch.clamp(u64[rows16] @ u64.T, -1.0, 1.0),
                      rows16)
    print(f"  {CHECK_ROWS} rows vs float64 Pearson: max|d| = {err_bf:.3e} "
          f"(the reference's bf16 bound {TOL_BF16:g})")
    if not err_bf <= TOL_BF16:
        raise AssertionError("bf16 corr disagrees with float64")
    del u64, rbf
    reset_counts()
    res_bf = corr(x_dev, compute_dtype=torch.bfloat16,
                  sink=DeviceTopKSink(K_TOP))
    torch.cuda.synchronize()
    check_launches(f"DeviceTopKSink({K_TOP})", 0, bplan.n_pass, "bfloat16")
    bf_select_launches = pcc_topk_tiles.select_by_dtype["bfloat16"]
    same_topk(res_bf, corr(x_dev, compute_dtype=torch.bfloat16,
                           sink=TopKSink(K_TOP)), "bf16")
    print(f"  DeviceTopKSink({K_TOP}) bit-identical to TopKSink({K_TOP}) "
          f"in bf16")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    bf_ms, bf_all = host_ms(lambda: corr(x_dev, compute_dtype=torch.bfloat16),
                            3)
    bf_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    torch.cuda.reset_peak_memory_stats()
    bftk_ms, bftk_all = host_ms(lambda: corr(
        x_dev, compute_dtype=torch.bfloat16, sink=DeviceTopKSink(K_TOP)), 3)
    bftk_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    print(f"  dense {bf_ms:.3f} ms (runs {[round(v, 3) for v in bf_all]}), "
          f"peak {bf_peak:.3f} GB; top-k {bftk_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in bftk_all]}), peak {bftk_peak:.3f} GB above "
          f"the {base_mem / 1e9:.3f} GB held {tag}")

    # -- 12'. fp16 Pearson at Table II: the bf16 run's twin -------------------
    fplan = ExecutionPlan.create(N_SEEK, L_SEEK, compute_dtype=torch.float16)
    u_f16 = fplan.prepare(x_dev)
    print(f"fp16 Pearson: corr(x, compute_dtype=torch.float16) at "
          f"n={N_SEEK} l={L_SEEK}: operand {u_f16.numel() * 2 / 1e6:.1f} MB")
    reset_counts()
    rf16 = corr(x_dev, compute_dtype=torch.float16)
    torch.cuda.synchronize()
    check_launches("dense", fplan.n_pass, 0, "float16")
    f16_tiles_launches = pcc_tiles.launches_by_dtype["float16"]
    if not bool(torch.isfinite(rf16).all()) or not torch.equal(rf16,
                                                                rf16.T):
        raise AssertionError("bad fp16 result")
    u64 = pcc.transform(x_dev.double())
    err_f16 = rows_err(rf16, torch.clamp(u64[rows16] @ u64.T, -1.0, 1.0),
                       rows16)
    print(f"  {CHECK_ROWS} rows vs float64 Pearson: max|d| = {err_f16:.3e} "
          f"(tol {TOL_F16:.4g}: 2^-10 from fp16's unit roundoff, "
          f"subnormals, float32 sums)")
    if not err_f16 <= TOL_F16:
        raise AssertionError("fp16 corr disagrees with float64")
    del u64, rf16
    reset_counts()
    res_f16 = corr(x_dev, compute_dtype=torch.float16,
                   sink=DeviceTopKSink(K_TOP))
    torch.cuda.synchronize()
    check_launches(f"DeviceTopKSink({K_TOP})", 0, fplan.n_pass, "float16")
    f16_select_launches = pcc_topk_tiles.select_by_dtype["float16"]
    same_topk(res_f16, corr(x_dev, compute_dtype=torch.float16,
                            sink=TopKSink(K_TOP)), "fp16")
    print(f"  DeviceTopKSink({K_TOP}) bit-identical to TopKSink({K_TOP}) "
          f"in fp16")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    f16_ms, f16_all = host_ms(lambda: corr(
        x_dev, compute_dtype=torch.float16), 3)
    f16_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    torch.cuda.reset_peak_memory_stats()
    f16tk_ms, f16tk_all = host_ms(lambda: corr(
        x_dev, compute_dtype=torch.float16, sink=DeviceTopKSink(K_TOP)), 3)
    f16tk_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    print(f"  dense {f16_ms:.3f} ms (runs {[round(v, 3) for v in f16_all]}), "
          f"peak {f16_peak:.3f} GB; top-k {f16tk_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in f16tk_all]}), peak {f16tk_peak:.3f} GB "
          f"above the {base_mem / 1e9:.3f} GB held {tag}")

    # -- 13. int8 Kendall tau-a, n = 17,555 genes x l = 64 samples ------------
    x_k = x_dev[:, :L_KENDALL].contiguous()
    kplan = ExecutionPlan.create(N_SEEK, L_KENDALL, measure="kendall",
                                 compute_dtype=torch.int8)
    u_k = kplan.prepare(x_k)
    n_pairs = L_KENDALL * (L_KENDALL - 1) // 2
    print(f"int8 Kendall tau-a: corr(x[:, :{L_KENDALL}], measure='kendall', "
          f"compute_dtype=torch.int8): {n_pairs} pair columns, operand "
          f"{tuple(u_k.shape)} int8 ({u_k.numel() / 1e6:.1f} MB)")
    reset_counts()
    rk8 = corr(x_k, measure="kendall", compute_dtype=torch.int8)
    torch.cuda.synchronize()
    check_launches("dense", kplan.n_pass, 0, "int8")
    k_tiles_launches = pcc_tiles.launches_by_dtype["int8"]
    rk32 = corr(x_k, measure="kendall")
    if not torch.equal(rk8, rk32):
        raise AssertionError("int8 Kendall != float32 sign-GEMM")
    # int16 stores the same exact signs; they run the int8 kernel narrowed
    reset_counts()
    rk16 = corr(x_k, measure="kendall", compute_dtype=torch.int16)
    torch.cuda.synchronize()
    check_launches("int16 signs (narrowed to int8)", kplan.n_pass, 0,
                   "int8")
    if not torch.equal(rk16, rk8):
        raise AssertionError("int16 Kendall != int8 Kendall")
    print("  compute_dtype=torch.int16: the int8 kernel on the narrowed "
          "signs, bitwise the int8 run")
    del rk16
    ia, ib = np.triu_indices(L_KENDALL, 1)
    xk64 = x_k.double()
    sgn = torch.sign(xk64[:, ia] - xk64[:, ib])
    tau64 = torch.empty((CHECK_ROWS, N_SEEK), dtype=torch.float64,
                        device=dev)
    for i, r_ in enumerate(rows16.tolist()):
        prod = sgn[r_] * sgn            # +1 concordant, -1 discordant pair
        tau64[i] = ((prod > 0).sum(-1) - (prod < 0).sum(-1)).double() \
            / n_pairs
    err_k = rows_err(rk8, tau64, rows16)
    print(f"  bitwise the float32 sign-GEMM; {CHECK_ROWS} rows vs float64 "
          f"tau-a by a direct count of concordant and discordant pairs: "
          f"max|d| = {err_k:.3e} (tol {TOL_KENDALL:g})")
    if not err_k <= TOL_KENDALL:
        raise AssertionError("int8 Kendall disagrees with the direct count")
    del rk8, rk32, sgn, prod, xk64
    reset_counts()
    res_k = corr(x_k, measure="kendall", compute_dtype=torch.int8,
                 sink=DeviceTopKSink(K_TOP))
    torch.cuda.synchronize()
    check_launches(f"DeviceTopKSink({K_TOP})", 0, kplan.n_pass, "int8")
    k_select_launches = pcc_topk_tiles.select_by_dtype["int8"]
    same_topk(res_k, corr(x_k, measure="kendall", compute_dtype=torch.int8,
                          sink=TopKSink(K_TOP)), "int8 Kendall")
    same_topk(res_k, corr(x_k, measure="kendall", sink=DeviceTopKSink(K_TOP)),
              "int8 vs float32 Kendall")
    print(f"  DeviceTopKSink({K_TOP}) bit-identical to TopKSink({K_TOP}) in "
          f"int8 and to the float32 sign-GEMM's")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    k8_ms, k8_all = host_ms(lambda: corr(x_k, measure="kendall",
                                         compute_dtype=torch.int8), 3)
    k8_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    k32_ms, k32_all = host_ms(lambda: corr(x_k, measure="kendall"), 3)
    k8tk_ms, k8tk_all = host_ms(lambda: corr(
        x_k, measure="kendall", compute_dtype=torch.int8,
        sink=DeviceTopKSink(K_TOP)), 3)
    print(f"  dense int8 {k8_ms:.3f} ms (runs {[round(v, 3) for v in k8_all]})"
          f", peak {k8_peak:.3f} GB; dense float32 sign-GEMM {k32_ms:.3f} ms "
          f"(runs {[round(v, 3) for v in k32_all]}); int8 top-k "
          f"{k8tk_ms:.3f} ms (runs {[round(v, 3) for v in k8tk_all]}) {tag}")

    # -- 14. the bf16, fp16 and int8 kernel modes at those shapes -------------
    # Bounds: operations at the tensor-core peak of the operand type (989
    # TFLOP/s bf16 and fp16, 1,979 TOP/s int8), bytes at 3.35 TB/s (each operand byte
    # read once, each output byte written once); the larger one bounds.
    def narrow_bound(ops_, nbytes, peak):
        o_ms = ops_ / peak * 1e3
        b_ms = nbytes / HBM_BYTES_S * 1e3
        return max(o_ms, b_ms), ("operations" if o_ms >= b_ms else "bytes")

    ktotal = kplan.total_tiles
    full = {}
    for dname, u, p_, width, peak in [
            ("bfloat16", u_bf, bplan, L_SEEK, BF16_FLOPS),
            ("float16", u_f16, fplan, L_SEEK, BF16_FLOPS),
            ("int8", u_k, kplan, n_pairs, INT8_OPS)]:
        tot = p_.total_tiles
        spec_ = p_.epilogue_spec
        kw = dict(t=p_.t, l_blk=p_.l_blk, pass_tiles=tot, epilogue=spec_)
        short = {"bfloat16": "bf16", "float16": "fp16"}.get(dname, dname)
        if dname != "int8":
            got, share, err, slack, fault = narrow_readings(
                u, 0, kw, f"{short} at the full shape")
            narrow_share[dname] = max(narrow_share[dname], share)
            print(f"  {short} tiles at the full pass: {share:.4g} of the "
                  f"narrow gate (max|kernel - plain| {err:.3e}, largest gate "
                  f"{slack:.3e}); planted faults refused at "
                  + ", ".join(f"{f:.4g} ({k})" for k, f in fault.items())
                  + " of it")
            full_fault = fault
        else:
            got = pcc_tiles(u, 0, **kw)
            want = pcc_tiles_plain(u, 0, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError("int8 kernel != plain at the full shape")
            del want
        del got
        tkw = dict(t=p_.t, l_blk=p_.l_blk, pass_tiles=tot, kk=K_TOP,
                   n_cols_valid=N_SEEK, symmetric_problem=True,
                   epilogue=spec_)
        if dname == "int8":
            if not all(torch.equal(a, b) for a, b in zip(
                    pcc_topk_tiles(u, 0, tot, **tkw),
                    pcc_topk_tiles_plain(u, 0, tot, **tkw))):
                raise AssertionError("int8 top-k != plain at the full shape")
        else:
            e2, ties = topk_vs_plain(u, 0, tot, tot, t=p_.t, l_blk=p_.l_blk,
                                     kk=K_TOP, n_cols_valid=N_SEEK,
                                     spec=spec_, tol=TOL_FULL + slack)
            err = max(err, e2)
            print(f"  {short} top-k vs plain at the full pass: max|kernel "
                  f"- plain| = {e2:.3e}, {ties} near-tie column swaps")
        narrow_err[dname] = max(narrow_err[dname], err)
        ops_ = 2 * width * p_.t ** 2 * tot
        op_b = u.numel() * u.element_size()
        k_ms, k_all = event_ms(lambda: pcc_tiles(u, 0, **kw), 5)
        p_ms, _ = event_ms(lambda: pcc_tiles_plain(u, 0, **kw), 3)
        # the library yardstick: one full-square product of the same type
        if dname == "int8":
            mm, ut = torch._int_mm, u.T.contiguous()
            lib_label = "torch._int_mm(u, u.T) (int32 out)"
        else:
            mm, ut = torch.matmul, u.T
            lib_label = f"torch.matmul(u, u.T) ({short} out)"
        l_ms, _ = event_ms(lambda: mm(u, ut), 5)
        t_bound = narrow_bound(ops_, op_b + tot * p_.t ** 2 * 4, peak)
        s_ms, s_all = event_ms(lambda: topk_select(u, 0, tot, **tkw), 5)
        sp_ms_, _ = event_ms(lambda: pcc_topk_tiles_plain(u, 0, tot, **tkw),
                             3)
        sl_ms, _ = event_ms(lambda: torch.topk(mm(u, ut).abs(), K_TOP, dim=1),
                            3)
        s_bound = narrow_bound(
            ops_, op_b + topk_scratch_bytes(tot, p_.t, K_TOP, True), peak)
        full[dname] = dict(ms=k_ms, plain=p_ms, lib=l_ms, bound=t_bound,
                           sel=s_ms, sel_plain=sp_ms_, sel_lib=sl_ms,
                           sel_bound=s_bound)
        if dname != "int8":
            full[dname]["fault"] = full_fault
        print(f"{dname} kernels, one pass of {tot} tiles over {tuple(u.shape)} "
              f"({width} real columns) {tag}:")
        print(f"  pcc_tiles {k_ms:.3f} ms (runs {[round(v, 3) for v in k_all]})"
              f", {ops_ / k_ms / 1e9:.1f} T ops/s, "
              f"{100 * t_bound[0] / k_ms:.1f} % of the bound "
              f"{t_bound[0]:.3f} ms by {t_bound[1]} ({ops_:.4g} ops at "
              f"{peak / 1e12:g} T/s; {op_b:.4g} B operand); plain "
              f"{p_ms:.3f} ms; library {lib_label} {l_ms:.3f} ms; "
              f"max|kernel - plain| {err:.3e}")
        print(f"  pcc_topk_select {s_ms:.3f} ms (runs "
              f"{[round(v, 3) for v in s_all]}), bound {s_bound[0]:.3f} ms by "
              f"{s_bound[1]}; plain pcc_topk_tiles_plain {sp_ms_:.3f} ms; "
              f"library torch.topk({lib_label}.abs(), {K_TOP}) (full square, "
              f"no canonical tie order, self-pairs kept) {sl_ms:.3f} ms")
    del u_k, ut

    # -- 15. the scaled, fp8 and triangle-pair modes at phase 2's shapes ------
    print("scaled int8 / fp8 and triangle second-operand tiles at the phase "
          "2 shapes: scaled int8 bitwise the plain version, fp8 within the "
          "narrow gate of it (the planted faults refused), triangle tiles "
          "bitwise the grid tiles:")
    new_err = {"int8": 0.0, "float8_e4m3fn": 0.0, "float8_e5m2": 0.0,
               "pair": 0.0}
    for n, l, t, l_blk, j0, tiles in small:
        xs_ = torch.from_numpy(rng.standard_normal((n, l)).astype(
            np.float32)).to(dev)
        ys_ = torch.from_numpy(rng.standard_normal((n // 2 + 3, l)).astype(
            np.float32)).to(dev)
        ws_ = torch.from_numpy(rng.standard_normal((n, l)).astype(
            np.float32)).to(dev)
        ux, uy = pcc.transform(xs_), pcc.transform(ys_)
        m = -(-n // t)
        for qname in ("int8", "float8_e4m3fn", "float8_e5m2"):
            (qx, sx_), (qy, sy_) = (quantize_rows(z, qname) for z in (ux, uy))
            u, su = pad_operands(qx, t, l_blk), pad_scales(sx_, t)
            v_, sv_ = pad_operands(qy, t, l_blk), pad_scales(sy_, t)
            for grid in (False, True):
                gc = v_.shape[0] // t if grid else None
                vv, sc = (v_, sv_) if grid else (None, su)
                label = (f"{qname} {'grid' if grid else 'triangle'} n={n} "
                         f"l={l} t={t} l_blk={l_blk} j0={j0} tiles={tiles}")
                for spec in epilogues.values():
                    kw = dict(t=t, l_blk=l_blk, pass_tiles=tiles,
                              epilogue=spec, v_pad=vv, grid_cols=gc,
                              row_scale=su, col_scale=sc)
                    if qname == "int8":
                        got = pcc_tiles(u, j0, **kw)
                        want = pcc_tiles_plain(u, j0, **kw)
                        if not torch.equal(got, want):
                            raise AssertionError(f"{label}: scaled int8 "
                                                 f"kernel != plain")
                        err = 0.0
                    else:
                        _, share, err, _, fault = narrow_readings(
                            u, j0, kw, label, faults=spec is None)
                        narrow_share[qname] = max(
                            narrow_share.get(qname, 0.0), share)
                        for name, f in fault.items():
                            fault_min[(qname, name)] = min(
                                fault_min.get((qname, name), f), f)
                    new_err[qname] = max(new_err[qname], err)
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            u = operand(xs_, t, l_blk).to(dt)
            w = operand(ws_, t, l_blk).to(dt)
            total_s = m * (m + 1) // 2
            kw = dict(t=t, l_blk=l_blk, epilogue=clip, v_pad=w)
            got = pcc_tiles(u, j0, pass_tiles=tiles, **kw)
            yc, xc = job_coord_batch(m, np.minimum(j0 + np.arange(tiles),
                                                   total_s - 1))
            grid_t = pcc_tiles(u, 0, pass_tiles=m * m, grid_cols=m, **kw)
            if not torch.equal(got, grid_t[torch.as_tensor(yc * m + xc,
                                                           device=dev)]):
                raise AssertionError(f"{dname} n={n} t={t}: triangle tile "
                                     f"with v_pad != grid tile")
            want = pcc_tiles_plain(u, j0, pass_tiles=tiles, **kw)
            err = float((got - want).abs().max())
            if dname == "bfloat16":
                share = gate_share(got, want, narrow_gate(
                    u, j0, pass_tiles=tiles, **kw))
                narrow_share[dname] = max(narrow_share[dname], share)
                if not share <= 1.0:
                    raise AssertionError(f"bf16 n={n} t={t}: triangle v_pad "
                                         f"kernel outside the narrow gate")
            else:
                if not err <= TOL_SMALL:
                    raise AssertionError(f"{dname} n={n} t={t}: triangle "
                                         f"v_pad kernel disagrees with plain")
                new_err["pair"] = max(new_err["pair"], err)
    print(f"  {len(small)} shapes x (int8, e4m3, e5m2) x (triangle, grid) "
          f"and (f32, bf16) triangle pairs: all bitwise checks hold; "
          f"max|kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in new_err.items())
          + "; shares of the narrow gate "
          + ", ".join(f"{k} {v:.4g}" for k, v in narrow_share.items())
          + "; planted faults refused at >= "
          + ", ".join(f"{d} {k} {v:.4g}" for (d, k), v in fault_min.items()))

    # -- 16. masked (pairwise-complete) Pearson at Table II ------------------
    # 5 % of the entries missing completely at random (seed 2).
    x_nan = x_seek.copy()
    x_nan[np.random.default_rng(2).random(x_seek.shape) < MISSING] = np.nan
    xn_dev = torch.from_numpy(x_nan).to(dev)
    del x_nan
    print(f"masked Pearson: corr(x, where='nan') at n={N_SEEK} l={L_SEEK}, "
          f"{int(torch.isnan(xn_dev).sum())} entries missing "
          f"({MISSING:.0%} at random, seed 2), {plan.n_pass} pass(es), "
          f"6 component streams")

    def masked_rows64(xr, y):
        """float64 pairwise-complete Pearson of rows xr against every row
        of y: each pair centred on its own common support (two passes),
        NaN = missing; fewer than 2 common samples or zero variance give
        0."""
        ym = ~torch.isnan(y)
        y0 = torch.where(ym, y, 0.0).double()
        ymd = ym.double()
        out = torch.empty((xr.shape[0], y.shape[0]), dtype=torch.float64,
                          device=y.device)
        for i in range(xr.shape[0]):
            mi = ~torch.isnan(xr[i])
            xi = torch.where(mi, xr[i], 0.0).double()
            cm = ymd * mi.double()
            n_c = cm.sum(1)
            safe = torch.clamp(n_c, min=1.0)
            dx = (xi[None, :] - ((cm * xi).sum(1) / safe)[:, None]) * cm
            dy = (y0 - ((cm * y0).sum(1) / safe)[:, None]) * cm
            den = torch.sqrt((dx * dx).sum(1) * (dy * dy).sum(1))
            ok = (n_c >= 2) & (den > 0)
            out[i] = torch.where(ok, (dx * dy).sum(1)
                                 / torch.where(ok, den, 1.0), 0.0)
            del cm, dx, dy
        return torch.clamp(out, -1.0, 1.0)

    reset_counts()
    rm = corr(xn_dev, where="nan")
    torch.cuda.synchronize()
    check_launches("dense", 6 * plan.n_pass, 0)
    pair_launches = pcc_tiles.triangle_pair_launches
    if pair_launches != 4 * plan.n_pass:
        raise AssertionError(f"masked run: {pair_launches} triangle launches "
                             f"with a second operand, want 4 per pass")
    if rm.shape != (N_SEEK, N_SEEK) or not bool(torch.isfinite(rm).all()):
        raise AssertionError("bad masked result")
    if not torch.equal(rm, rm.T):
        raise AssertionError("masked result is not exactly symmetric")
    err_m = rows_err(rm, masked_rows64(xn_dev[rows16], xn_dev), rows16)
    print(f"  {CHECK_ROWS} rows vs float64 pairwise-complete Pearson (each "
          f"pair centred on its common samples): max|d| = {err_m:.3e} (tol "
          f"{TOL_MASKED:g})")
    if not err_m <= TOL_MASKED:
        raise AssertionError("masked corr disagrees with float64")
    reset_counts()
    if not torch.equal(rm, corr(xn_dev, where="nan",
                                max_tiles_per_pass=SPLIT)):
        raise AssertionError("masked result depends on the pass split")
    check_launches(f"max_tiles_per_pass={SPLIT}", 6 * split_plan.n_pass, 0)
    class TimedTopKSink(TopKSink):
        """Times the host merge (topk_merge_rows) of each pass's candidates;
        the rest of consume() is the device pre-selection and the copy."""

        def __init__(self, k):
            super().__init__(k)
            self.merge_ms = 0.0

        def _merge(self, r_ids, c_ids, v):
            t1 = time.perf_counter()
            super()._merge(r_ids, c_ids, v)
            self.merge_ms += (time.perf_counter() - t1) * 1e3

    def timed_topk(fn):
        """(result, call ms, host merge ms) of one top-k corr, warm."""
        snk = TimedTopKSink(K_TOP)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res_ = fn(snk)
        torch.cuda.synchronize()
        return res_, (time.perf_counter() - t1) * 1e3, snk.merge_ms

    reset_counts()
    tkm, mktk_ms, mktk_merge = timed_topk(
        lambda snk: corr(xn_dev, where="nan", sink=snk))
    check_launches(f"TopKSink({K_TOP})", 6 * plan.n_pass, 0)
    idx = torch.as_tensor(tkm["indices"], device=dev)
    if bool((idx < 0).any()) or bool((idx == torch.arange(
            N_SEEK, device=dev)[:, None]).any()):
        raise AssertionError("masked top-k: empty slot or self-pair")
    if not torch.equal(torch.as_tensor(tkm["values"], device=dev),
                       torch.take_along_dim(rm, idx, dim=1)):
        raise AssertionError("masked top-k values are not the dense bits")
    key = rm[rows16].abs()
    key[torch.arange(CHECK_ROWS, device=dev), rows16] = -1.0
    kth = torch.topk(key, K_TOP + 1, dim=1).values
    got_min = torch.take_along_dim(key, idx[rows16], dim=1).min(dim=1).values
    if not bool((got_min >= kth[:, K_TOP - 1]).all()):
        raise AssertionError("masked top-k misses a stronger partner")
    try:
        corr(xn_dev, where="nan", sink=DeviceTopKSink(K_TOP))
    except ValueError as exc:
        print(f"  TopKSink({K_TOP}): no self-pairs, values the dense "
              f"result's bits, {CHECK_ROWS} rows hold their top {K_TOP}; "
              f"DeviceTopKSink({K_TOP}) refuses: {exc}")
    else:
        raise AssertionError("DeviceTopKSink accepted a masked run")
    del tkm, idx, key, rm
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    mk_ms, mk_all = host_ms(lambda: corr(xn_dev, where="nan"), 3)
    mk_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    print(f"  dense {mk_ms:.3f} ms (runs {[round(v, 3) for v in mk_all]}), "
          f"peak {mk_peak:.3f} GB above the {base_mem / 1e9:.3f} GB held; "
          f"TopKSink({K_TOP}) {mktk_ms:.3f} ms (one warm run), of which the "
          f"host merge "
          f"(topk_merge_rows) {mktk_merge:.3f} ms {tag}")
    # rectangular: the 1,639 TF rows (fully observed) against the masked
    # Table II rows, masks from NaNs on both sides
    mrplan = ExecutionPlan.create(N_TF, L_SEEK, n_cols=N_SEEK)
    reset_counts()
    rmr = corr(x_tf, xn_dev, where=(None, None))
    torch.cuda.synchronize()
    check_launches("rectangular dense", 6 * mrplan.n_pass, 0)
    if rmr.shape != (N_TF, N_SEEK) or not bool(torch.isfinite(rmr).all()):
        raise AssertionError("bad masked rectangular result")
    err_mr = rows_err(rmr, masked_rows64(x_tf[rows_tf], xn_dev), rows_tf)
    if not err_mr <= TOL_MASKED:
        raise AssertionError("masked rectangular corr disagrees with "
                             "float64")
    del rmr
    mr_ms, mr_all = host_ms(lambda: corr(x_tf, xn_dev, where=(None, None)), 3)
    print(f"  rectangular corr(x_tf, x, where=(None, None)), {N_TF} x "
          f"{N_SEEK}: {CHECK_ROWS} rows vs float64 max|d| = {err_mr:.3e}; "
          f"{mr_ms:.3f} ms (runs {[round(v, 3) for v in mr_all]})")
    # the triangle-pair mode alone: the sx = A M^T component's pass
    mops = measures.masked_operands(xn_dev, ~torch.isnan(xn_dev))
    a_pad = pad_operands(mops["a"], plan.t, plan.l_blk)
    m_pad = pad_operands(mops["m"], plan.t, plan.l_blk)
    del mops
    pkw = dict(t=plan.t, l_blk=plan.l_blk, pass_tiles=total, v_pad=m_pad)
    got = pcc_tiles(a_pad, 0, **pkw)
    err = float((got - pcc_tiles_plain(a_pad, 0, **pkw)).abs().max())
    del got
    # raw sums of up to ~4,800 values in [0, 1): TOL_FULL relative to L_SEEK
    if not err <= TOL_FULL * L_SEEK:
        raise AssertionError("triangle-pair kernel disagrees with plain")
    new_err["pair"] = max(new_err["pair"], err)
    pr_ms, pr_all = event_ms(lambda: pcc_tiles(a_pad, 0, **pkw), 5)
    pr_plain, _ = event_ms(lambda: pcc_tiles_plain(a_pad, 0, **pkw), 3)
    pr_lib, _ = event_ms(lambda: torch.matmul(a_pad, m_pad.T), 5)
    pr_bound = narrow_bound(2 * L_SEEK * plan.t ** 2 * total,
                            (a_pad.numel() + m_pad.numel()) * 4
                            + total * plan.t ** 2 * 4, FP32_FLOPS)
    print(f"  pcc_tiles triangle with a second operand (A M^T, one pass of "
          f"{total} tiles): {pr_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in pr_all]}), bound {pr_bound[0]:.3f} ms by "
          f"{pr_bound[1]}; plain {pr_plain:.3f} ms; library "
          f"torch.matmul(a, m.T) (full square) {pr_lib:.3f} ms; "
          f"max|kernel - plain| {err:.3e} on sums up to {L_SEEK} {tag}")
    del a_pad, m_pad, xn_dev

    # -- 17. int8- and fp8-quantized Pearson at Table II ----------------------
    def scaled_mode(qname, qplan, uq):
        """The scaled kernel mode at the Table II pass: int8 bitwise the
        plain version, fp8 within the narrow gate of it (the planted faults
        refused); times of the kernel, its plain version and the library
        call, and the bound."""
        qkw = dict(t=qplan.t, l_blk=qplan.l_blk, pass_tiles=total,
                   epilogue=qplan.epilogue_spec, row_scale=uq.scale,
                   col_scale=uq.scale)
        res = {}
        if qname == "int8":
            got = pcc_tiles(uq.data, 0, **qkw)
            want = pcc_tiles_plain(uq.data, 0, **qkw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError("scaled int8 != plain at the full shape")
            err = float((got - want).abs().max())
            del got, want
            gate_note = "bitwise the plain version"
        else:
            got, share, err, _, fault = narrow_readings(
                uq.data, 0, qkw, f"{qname} at the full shape")
            del got
            narrow_share[qname] = max(narrow_share.get(qname, 0.0), share)
            res.update(share=share, fault=fault)
            gate_note = (f"{share:.4g} of the narrow gate, planted faults "
                         f"refused at " + ", ".join(
                             f"{f:.4g} ({k})" for k, f in fault.items()))
        new_err[qname] = max(new_err[qname], err)
        k_ms, k_all = event_ms(lambda: pcc_tiles(uq.data, 0, **qkw), 5)
        p_ms, _ = event_ms(lambda: pcc_tiles_plain(uq.data, 0, **qkw), 3)
        s_ = uq.scale
        if qname == "int8":
            ut = uq.data.T.contiguous()
            lib_label = "torch._int_mm(u, u.T) * (s s^T)"

            def lib():
                return torch._int_mm(uq.data, ut) * (s_[:, None] * s_[None, :])
        else:
            lib, lib_label = scaled_mm_call(
                uq.data, uq.data.T, s_[:, None].contiguous(),
                s_[None, :].contiguous(), "u, u.T")
        l_ms = event_ms(lib, 5)[0] if lib_label else None
        ops_ = 2 * L_SEEK * qplan.t ** 2 * total
        q_bound = narrow_bound(ops_, uq.data.numel() + 2 * uq.scale.numel() * 4
                               + total * qplan.t ** 2 * 4,
                               INT8_OPS if qname == "int8" else FP8_FLOPS)
        res.update(ms=k_ms, plain=p_ms, lib=l_ms, bound=q_bound)
        print(f"  pcc_tiles {qname} with scales, one pass of {total} tiles "
              f"over {tuple(uq.shape)}: {k_ms:.3f} ms (runs "
              f"{[round(v, 3) for v in k_all]}), "
              f"{ops_ / k_ms / 1e9:.1f} T ops/s, "
              f"{100 * q_bound[0] / k_ms:.1f} % of the bound "
              f"{q_bound[0]:.3f} ms by {q_bound[1]}; plain {p_ms:.3f} ms; "
              f"library {lib_label or 'none'} "
              f"{'not measured' if l_ms is None else f'{l_ms:.3f} ms'}; "
              f"{gate_note}; max|kernel - plain| {err:.3e} {tag}")
        return res

    quant = {}
    u64 = pcc.transform(x_dev.double())
    ref16 = torch.clamp(u64[rows16] @ u64.T, -1.0, 1.0)
    del u64
    for qname, budget in (("int8", TOL_Q_INT8),
                          ("float8_e4m3fn", TOL_Q_FP8)):
        qd = getattr(torch, qname)
        qplan = ExecutionPlan.create(N_SEEK, L_SEEK, compute_dtype=qd)
        uq = qplan.prepare(x_dev)
        print(f"{qname}-quantized Pearson: corr(x, compute_dtype="
              f"torch.{qname}) at n={N_SEEK} l={L_SEEK}: operand "
              f"{uq.data.numel() / 1e6:.1f} MB + {uq.scale.numel() * 4} B of "
              f"row scales")
        reset_counts()
        rq_ = corr(x_dev, compute_dtype=qd)
        torch.cuda.synchronize()
        check_launches("dense", qplan.n_pass, 0, qname)
        q_launches = pcc_tiles.launches_by_dtype[qname]
        if pcc_tiles.scaled_launches != qplan.n_pass:
            raise AssertionError(f"{qname}: launches without scales")
        if not bool(torch.isfinite(rq_).all()) or not torch.equal(rq_, rq_.T):
            raise AssertionError(f"bad {qname} result")
        err_q = rows_err(rq_, ref16, rows16)
        print(f"  {CHECK_ROWS} rows vs float64 Pearson: max|d| = "
              f"{err_q:.3e} (the reference's {qname} budget {budget:g})")
        if not err_q <= budget:
            raise AssertionError(f"{qname} corr outside the budget")
        reset_counts()
        tkq, qtk_ms, qtk_merge = timed_topk(
            lambda snk: corr(x_dev, compute_dtype=qd, sink=snk))
        check_launches(f"TopKSink({K_TOP})", qplan.n_pass, 0, qname)
        idx = torch.as_tensor(tkq["indices"], device=dev)
        if not torch.equal(torch.as_tensor(tkq["values"], device=dev),
                           torch.take_along_dim(rq_, idx, dim=1)):
            raise AssertionError(f"{qname} top-k values are not the dense "
                                 f"bits")
        try:
            corr(x_dev, compute_dtype=qd, sink=DeviceTopKSink(K_TOP))
        except ValueError:
            pass
        else:
            raise AssertionError(f"DeviceTopKSink accepted {qname}")
        del rq_, tkq, idx
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        q_ms, q_all = host_ms(lambda: corr(x_dev, compute_dtype=qd), 3)
        q_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        qp_ms, qp_all = host_ms(lambda: qplan.prepare(x_dev), 3)
        print(f"  TopKSink({K_TOP}) values the dense bits; DeviceTopKSink "
              f"refuses; dense {q_ms:.3f} ms (runs "
              f"{[round(v, 3) for v in q_all]}), peak {q_peak:.3f} GB above "
              f"the {base_mem / 1e9:.3f} GB held; TopKSink({K_TOP}) "
              f"{qtk_ms:.3f} ms (one run), of which the host merge "
              f"{qtk_merge:.3f} ms; transform and quantization (plan.prepare) "
              f"{qp_ms:.3f} ms (runs {[round(v, 3) for v in qp_all]}) {tag}")
        quant[qname] = scaled_mode(qname, qplan, uq)
        quant[qname]["launches"] = q_launches
        del uq
    # e5m2: dense corr once (its launches), then the kernel mode
    q5 = torch.float8_e5m2
    q5plan = ExecutionPlan.create(N_SEEK, L_SEEK, compute_dtype=q5)
    reset_counts()
    r5 = corr(x_dev, compute_dtype=q5)
    torch.cuda.synchronize()
    check_launches("e5m2-quantized Pearson, dense", q5plan.n_pass, 0,
                   "float8_e5m2")
    e5_launches = pcc_tiles.launches_by_dtype["float8_e5m2"]
    if not bool(torch.isfinite(r5).all()) or not torch.equal(r5, r5.T):
        raise AssertionError("bad e5m2 result")
    err_q = rows_err(r5, ref16, rows16)
    print(f"  e5m2-quantized Pearson at n={N_SEEK} l={L_SEEK}: {CHECK_ROWS} "
          f"rows vs float64: max|d| = {err_q:.3e} (the reference's fp8 "
          f"budget {TOL_Q_FP8:g})")
    if not err_q <= TOL_Q_FP8:
        raise AssertionError("e5m2 corr outside the fp8 budget")
    del r5
    quant["float8_e5m2"] = scaled_mode("float8_e5m2", q5plan,
                                       q5plan.prepare(x_dev))
    quant["float8_e5m2"]["launches"] = e5_launches
    quant["pair"] = dict(launches=pair_launches, ms=pr_ms, plain=pr_plain,
                         lib=pr_lib, bound=pr_bound)

    # -- 18. significance: the replica axis of pcc_tiles ---------------------
    def replica_small(dname, n, l, t, l_blk, grid, reps):
        """(u, stack, row scales, col scales) of the replica mode at a small
        shape: `reps` column operands of type dname ("int8s": scaled int8,
        "int8": Kendall pair signs)."""
        rows = n // 2 + 3 if grid else n
        xs_ = torch.from_numpy(rng.standard_normal((n, l)).astype(
            np.float32)).to(dev)
        cs_ = [torch.from_numpy(rng.standard_normal((rows, l)).astype(
            np.float32)).to(dev) for _ in range(reps)]
        if dname == "int8":
            return (kendall_operand(xs_, t, l_blk),
                    torch.stack([kendall_operand(c, t, l_blk) for c in cs_]),
                    None, None)
        if dname in ("int8s", "float8_e4m3fn", "float8_e5m2"):
            qn = "int8" if dname == "int8s" else dname
            qx, sx_ = quantize_rows(pcc.transform(xs_), qn)
            qs = [quantize_rows(pcc.transform(c), qn) for c in cs_]
            stack = torch.stack([pad_operands(q, t, l_blk).view(torch.uint8)
                                 for q, _ in qs]).view(qx.dtype)
            return (pad_operands(qx, t, l_blk), stack, pad_scales(sx_, t),
                    torch.stack([pad_scales(s_, t) for _, s_ in qs]))
        dt = getattr(torch, dname)
        return (operand(xs_, t, l_blk).to(dt),
                torch.stack([operand(c, t, l_blk).to(dt) for c in cs_]),
                None, None)

    print("replica mode at phase 2's shapes: each replica bitwise the 2-D "
          "kernel's tiles; float32 within tolerance of plain, int8 and "
          "scaled int8 bitwise plain, bf16 / fp8 within the narrow gate of "
          "plain:")
    rep_err = 0.0
    rep_narrow = {}   # max |kernel - plain|, share of the gate
    rep_cases = 0
    for n, l, t, l_blk, j0, tiles in (small[1], small[3], small[6]):
        for dname in ("float32", "bfloat16", "int8", "int8s",
                      "float8_e4m3fn", "float8_e5m2"):
            for grid in (False, True):
                for reps in (1, 3, 5):
                    u, stack, su, scol = replica_small(dname, n, l, t, l_blk,
                                                       grid, reps)
                    m = u.shape[0] // t
                    gc = stack.shape[1] // t if grid else None
                    label = (f"replica {dname} "
                             f"{'grid' if grid else 'triangle'} R={reps} "
                             f"n={n} l={l} t={t} j0={j0}")
                    kw = dict(t=t, l_blk=l_blk, pass_tiles=tiles,
                              epilogue=epilogues["div_clip"], grid_cols=gc,
                              row_scale=su)
                    got = pcc_tiles(u, j0, v_pad=stack, col_scale=scol, **kw)
                    for r_ in range(reps):
                        if not torch.equal(got[r_], pcc_tiles(
                                u, j0, v_pad=stack[r_].contiguous(),
                                col_scale=None if scol is None else scol[r_],
                                **kw)):
                            raise AssertionError(f"{label}: replica {r_} != "
                                                 f"the 2-D kernel's tiles")
                    want = pcc_tiles_plain(u, j0, v_pad=stack,
                                           col_scale=scol, **kw)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    if dname in ("int8", "int8s"):
                        if not torch.equal(got, want):
                            raise AssertionError(f"{label}: != plain")
                    elif dname == "float32":
                        if not err <= TOL_SMALL:
                            raise AssertionError(f"{label}: kernel disagrees "
                                                 f"with plain ({err:.3e})")
                        rep_err = max(rep_err, err)
                    else:
                        share = gate_share(got, want, narrow_gate(
                            u, j0, v_pad=stack, col_scale=scol, **kw))
                        if not share <= 1.0:
                            raise AssertionError(f"{label}: outside the "
                                                 f"narrow gate ({share:.4g})")
                        e0, s0 = rep_narrow.get(dname, (0.0, 0.0))
                        rep_narrow[dname] = (max(e0, err), max(s0, share))
                    rep_cases += 1
    print(f"  {rep_cases} cases (3 shapes x 6 operand types x triangle / grid"
          f" x R 1, 3, 5): all bitwise checks hold; max|kernel - plain| "
          f"float32 {rep_err:.3e}; " + ", ".join(
              f"{d} {e:.3e} ({sh:.4g} of the narrow gate)"
              for d, (e, sh) in rep_narrow.items()))

    def check_sig_launches(label, p_, dtype="float32"):
        """Since reset_counts(), one observed launch and one replica launch
        per chunk in each pass, B replicas per pass, all of them CUDA
        launches of pcc_tiles in `dtype`, no plain version."""
        chunks = len(p_.replica_chunk_sizes)
        got = (pcc_tiles.launches, dict(pcc_tiles.launches_by_dtype),
               pcc_tiles.replica_launches, pcc_tiles.replicas_launched,
               pcc_tiles.scaled_launches, dict(pcc_topk_tiles.launches))
        total_l = p_.n_pass * (1 + chunks)
        want = (total_l, {k: total_l if k == dtype else 0 for k in got[1]},
                p_.n_pass * chunks, p_.n_pass * p_.replicas,
                total_l if p_.scaled else 0, {"select": 0, "merge": 0})
        print(f"  {label}: pcc_tiles launches {got[0]} ({got[2]} replica "
              f"launches, {got[3]} replicas, {got[4]} scaled), plain calls "
              f"{plain_calls}")
        if got != want or any(plain_calls.values()):
            raise AssertionError(f"{label}: did not run through the CUDA "
                                 f"replica kernel as planned ({got} != "
                                 f"{want})")

    def check_p(label, p, b, symmetric):
        if not bool(torch.isfinite(p).all()) or \
                not bool(((p > 0) & (p <= 1)).all()):
            raise AssertionError(f"{label}: p outside (0, 1]")
        if symmetric:
            if not torch.equal(p, p.T):
                raise AssertionError(f"{label}: p is not exactly symmetric")
            floor = (torch.tensor(1.0, device=dev)
                     / torch.tensor(float(b + 1), device=dev))
            if not bool((p.diagonal() == floor).all()):
                raise AssertionError(f"{label}: diagonal p != 1/(B+1)")

    sig_plan = ExecutionPlan.create(N_TF, L_SEEK, replicas=B_SIG)
    spec_sig = PermutationSpec(iterations=B_SIG, key=0)
    print(f"significance: corr(x_tf, pvalues=PermutationSpec({B_SIG}, "
          f"key=0)), {N_TF} TF rows x l={L_SEEK}: {sig_plan.total_tiles} "
          f"tiles, {sig_plan.n_pass} pass(es), replica chunks of "
          f"{sig_plan.replica_chunk} ({len(sig_plan.replica_chunk_sizes)} "
          f"launches, last {sig_plan.replica_chunk_sizes[-1]})")
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r_sig, p_sig = corr(x_tf, pvalues=spec_sig)
    torch.cuda.synchronize()
    sig_first_ms = (time.perf_counter() - t1) * 1e3
    check_sig_launches("headline", sig_plan)
    sig_launches = pcc_tiles.replica_launches
    if not torch.equal(r_sig, corr(x_tf)):
        raise AssertionError("significance r is not corr(x)'s bits")
    check_p("headline", p_sig, B_SIG, True)
    idx_sig = iteration_indices(spec_sig, L_SEEK).to(dev)
    inv_sig = torch.argsort(idx_sig, dim=1)
    u64 = pcc.transform(x_tf.double())
    rows8 = torch.as_tensor(np.sort(rng.choice(N_TF, SIG_ROWS,
                                               replace=False)), device=dev)
    ur = u64[rows8]
    obs64 = torch.clamp(ur @ u64.T, -1.0, 1.0).abs()
    upper = torch.arange(N_TF, device=dev)[None, :] >= rows8[:, None]
    cnt64 = torch.zeros_like(obs64, dtype=torch.int64)
    ties64 = torch.zeros_like(cnt64)
    for b0 in range(0, B_SIG, 100):
        # (i, j >= i): <u_i, pi(u_j)> = <u_i[inv], u_j>; (i, j < i), the
        # mirrored entry (j, i): <u_j, pi(u_i)> = <u_i[idx], u_j>
        a = torch.clamp(ur[:, inv_sig[b0:b0 + 100]] @ u64.T, -1.0, 1.0)
        bm = torch.clamp(ur[:, idx_sig[b0:b0 + 100]] @ u64.T, -1.0, 1.0)
        rep64 = torch.where(upper[:, None, :], a, bm).abs()
        cnt64 += (rep64 >= obs64[:, None, :]).sum(1)
        ties64 += ((rep64 - obs64[:, None, :]).abs() <= TIE_SIG).sum(1)
    del a, bm, rep64, u64, ur
    cnt = torch.round(p_sig[rows8].double() * (B_SIG + 1)).long() - 1
    dcnt = (cnt - cnt64).abs()
    if not bool((dcnt[ties64 == 0] == 0).all()) or \
            not bool((dcnt <= ties64).all()):
        raise AssertionError("significance counts disagree with float64 "
                             "replicas beyond near-ties")
    print(f"  r bitwise corr(x_tf); p exactly symmetric, diagonal 1/(B+1); "
          f"{SIG_ROWS} rows' counts vs float64 replicas: "
          f"{int((dcnt > 0).sum())} entries differ, by at most their "
          f"near-ties ({int(ties64.sum())} replica values within "
          f"{TIE_SIG:g} of the observed in these rows)")
    reset_counts()
    _, p200 = corr(x_tf, pvalues=PermutationSpec(200, key=0))
    _, p200c = corr(x_tf, pvalues=PermutationSpec(200, key=0, chunk=37))
    _, p200s = corr(x_tf, pvalues=PermutationSpec(200, key=0),
                    max_tiles_per_pass=5)
    if not (torch.equal(p200, p200c) and torch.equal(p200, p200s)):
        raise AssertionError("p depends on the chunk or the pass split")
    print(f"  B=200: p bitwise equal with chunk 64, chunk 37 and 5-tile "
          f"passes ({pcc_tiles.replica_launches} replica launches)")
    del p200, p200c, p200s

    u_sig = sig_plan.prepare(x_tf)
    stack = replica_operand(sig_plan, idx_sig[:sig_plan.replica_chunk].cpu(),
                            method="permute", columns=x_tf,
                            cols_prepared=u_sig)
    tiles_sig = sig_plan.total_tiles
    skw = dict(t=sig_plan.t, l_blk=sig_plan.l_blk, pass_tiles=tiles_sig)
    got = pcc_tiles(u_sig, 0, v_pad=stack, **skw)
    for r_ in range(stack.shape[0]):
        if not torch.equal(got[r_], pcc_tiles(u_sig, 0, v_pad=stack[r_],
                                              **skw)):
            raise AssertionError(f"headline replica {r_} != the 2-D "
                                 f"kernel's tiles")
    err = float((got - pcc_tiles_plain(u_sig, 0, v_pad=stack, **skw))
                .abs().max())
    if not err <= TOL_FULL:
        raise AssertionError(f"replica kernel disagrees with plain "
                             f"({err:.3e})")
    rep_err = max(rep_err, err)
    # the other steps of one chunk, as run_significance runs them for
    # Pearson: the host draw of all B index rows, the chunk's gather, and
    # the replica-by-replica compare into int32 counts
    abs_obs = torch.clamp(pcc_tiles(u_sig, 0, **skw), -1.0, 1.0).abs()
    counts = torch.zeros(abs_obs.shape, dtype=torch.int32, device=dev)

    def compare():
        for r_ in range(got.shape[0]):
            counts.add_(torch.clamp(got[r_], -1.0, 1.0).abs() >= abs_obs)

    draw_ms, _ = host_ms(lambda: iteration_indices(spec_sig, L_SEEK), 3)
    gather_ms, _ = event_ms(lambda: replica_operand(
        sig_plan, idx_sig[:sig_plan.replica_chunk].cpu(), method="permute",
        columns=x_tf, cols_prepared=u_sig), 3)
    cmp_ms, _ = event_ms(compare, 3)
    del got, abs_obs, counts
    rk_ms, rk_all = event_ms(lambda: pcc_tiles(u_sig, 0, v_pad=stack, **skw),
                             5)
    rp_ms, _ = event_ms(lambda: pcc_tiles_plain(u_sig, 0, v_pad=stack,
                                                **skw), 3)
    rl_ms, _ = event_ms(lambda: torch.matmul(u_sig, stack.transpose(1, 2)),
                        5)
    reps_ = stack.shape[0]
    rflop = 2 * L_SEEK * sig_plan.t ** 2 * tiles_sig * reps_
    rbound = bound(rflop, (u_sig.numel() + stack.numel()) * 4
                   + reps_ * tiles_sig * sig_plan.t ** 2 * 4)
    stack_gb = stack.numel() * 4 / 1e9
    del stack
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    sig_ms, sig_all = host_ms(lambda: corr(x_tf, pvalues=spec_sig), 3)
    sig_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    print(f"significance times at {N_TF} x {L_SEEK}, B={B_SIG} {tag}:")
    print(f"  pcc_tiles replica mode, {reps_} replicas x {tiles_sig} tiles: "
          f"{rk_ms:.3f} ms (runs {[round(v, 3) for v in rk_all]}), "
          f"{rflop / rk_ms / 1e9:.1f} TFLOP/s, bound {rbound[0]:.3f} ms by "
          f"{rbound[1]}; plain {rp_ms:.3f} ms; library torch.matmul(u, "
          f"stack.transpose(1, 2)) (full squares) {rl_ms:.3f} ms; "
          f"max|kernel - plain| {err:.3e} (tol {TOL_FULL:g})")
    print(f"  corr(x_tf, pvalues=...) end to end, x on the card: "
          f"{sig_ms:.3f} ms (runs {[round(v, 3) for v in sig_all]}; first "
          f"call {sig_first_ms:.3f} ms), {sig_launches} replica launches, "
          f"peak {sig_peak:.3f} GB above the {base_mem / 1e9:.3f} GB held "
          f"(one chunk's stack {stack_gb:.3f} GB)")
    print(f"  its steps alone: host draw of {B_SIG} index rows "
          f"{draw_ms:.3f} ms (host clock); per {reps_}-replica chunk: gather "
          f"{gather_ms:.3f} ms, replica kernel {rk_ms:.3f} ms, compare into "
          f"counts ({reps_} x 4 launches) {cmp_ms:.3f} ms (CUDA events)")

    # the bf16 and fp8 (e4m3) replica modes: the headline through them once
    # (their launches), then one chunk's stack timed as above
    rep_modes = {}
    for dname in ("bfloat16", "float8_e4m3fn"):
        dt = getattr(torch, dname)
        n_plan = ExecutionPlan.create(N_TF, L_SEEK, replicas=B_SIG,
                                      compute_dtype=dt)
        reset_counts()
        r_n, p_n = corr(x_tf, compute_dtype=dt, pvalues=spec_sig)
        torch.cuda.synchronize()
        check_sig_launches(f"headline, {dname}", n_plan, dname)
        n_launches = pcc_tiles.replica_launches
        if not torch.equal(r_n, corr(x_tf, compute_dtype=dt)):
            raise AssertionError(f"{dname} significance r is not corr(x)'s "
                                 f"bits")
        check_p(f"headline, {dname}", p_n, B_SIG, True)
        del r_n, p_n
        u_n = n_plan.prepare(x_tf)
        st_n = replica_operand(n_plan, idx_sig[:n_plan.replica_chunk].cpu(),
                               method="permute", columns=x_tf,
                               cols_prepared=u_n)
        ud, su_ = (u_n.data, u_n.scale) if n_plan.scaled else (u_n, None)
        sd, sv_ = (st_n.data, st_n.scale) if n_plan.scaled else (st_n, None)
        nkw = dict(t=n_plan.t, l_blk=n_plan.l_blk, pass_tiles=tiles_sig,
                   row_scale=su_, v_pad=sd, col_scale=sv_)
        got, share, err, _, _ = narrow_readings(
            ud, 0, nkw, f"{dname} replica headline chunk", faults=False)
        reps_n = sd.shape[0]
        for r_ in (0, reps_n - 1):
            if not torch.equal(got[r_], pcc_tiles(
                    ud, 0, **{**nkw, "v_pad": sd[r_],
                              "col_scale": None if sv_ is None
                              else sv_[r_]})):
                raise AssertionError(f"{dname} headline replica {r_} != "
                                     f"the 2-D kernel's tiles")
        del got
        k_ms, k_all = event_ms(lambda: pcc_tiles(ud, 0, **nkw), 5)
        p_ms, _ = event_ms(lambda: pcc_tiles_plain(ud, 0, **nkw), 3)
        if su_ is None:
            lib_label = "torch.matmul(u, stack.transpose(1, 2))"

            def lib():
                return torch.matmul(ud, sd.transpose(1, 2))
        else:
            lib, lib_label = scaled_mm_call(
                ud, sd.view(-1, sd.shape[-1]).T, su_[:, None].contiguous(),
                sv_.reshape(1, -1).contiguous(), "u, stack rows.T")
        l_ms = event_ms(lib, 5)[0] if lib_label else None
        nflop = 2 * L_SEEK * n_plan.t ** 2 * tiles_sig * reps_n
        n_bound = narrow_bound(
            nflop, ud.numel() * ud.element_size() + sd.numel()
            * sd.element_size() + reps_n * tiles_sig * n_plan.t ** 2 * 4,
            BF16_FLOPS if dt == torch.bfloat16 else FP8_FLOPS)
        rep_modes[dname] = dict(launches=n_launches, ms=k_ms, plain=p_ms,
                                lib=l_ms, bound=n_bound, err=err)
        print(f"  pcc_tiles replica mode, {dname}, {reps_n} replicas x "
              f"{tiles_sig} tiles: {k_ms:.3f} ms (runs "
              f"{[round(v, 3) for v in k_all]}), {nflop / k_ms / 1e9:.1f} "
              f"T ops/s, {100 * n_bound[0] / k_ms:.1f} % of the bound "
              f"{n_bound[0]:.3f} ms by {n_bound[1]}; plain {p_ms:.3f} ms; "
              f"library {lib_label or 'none'} "
              f"{'not measured' if l_ms is None else f'{l_ms:.3f} ms'}; "
              f"{share:.4g} of the narrow gate, max|kernel - plain| "
              f"{err:.3e}; headline corr's {n_launches} replica launches, r "
              f"bitwise corr(x, compute_dtype), replicas 0 and "
              f"{reps_n - 1} bitwise the 2-D kernel's {tag}")
        del u_n, st_n, ud, sd

    # Table II at B = 8: the replica mode at the main path's full shape
    t2_plan = ExecutionPlan.create(N_SEEK, L_SEEK, replicas=8)
    spec8 = PermutationSpec(8, key=0)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    r8, p8 = corr(x_dev, pvalues=spec8)
    torch.cuda.synchronize()
    t2_ms = (time.perf_counter() - t1) * 1e3
    t2_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    check_sig_launches("Table II, B=8", t2_plan)
    if not torch.equal(r8, corr(x_dev)):
        raise AssertionError("Table II significance r is not corr(x)'s bits")
    check_p("Table II, B=8", p8, 8, True)
    del r8, p8
    stack8 = replica_operand(
        t2_plan, iteration_indices(spec8, L_SEEK), method="permute",
        columns=x_dev, cols_prepared=u_seek)
    got = pcc_tiles(u_seek, 0, v_pad=stack8, t=plan.t, l_blk=plan.l_blk,
                    pass_tiles=total)
    for r_ in (0, 7):
        if not torch.equal(got[r_], pcc_tiles(
                u_seek, 0, v_pad=stack8[r_], t=plan.t, l_blk=plan.l_blk,
                pass_tiles=total)):
            raise AssertionError(f"Table II replica {r_} != the 2-D "
                                 f"kernel's tiles")
    del got
    t2k_ms, t2k_all = event_ms(lambda: pcc_tiles(
        u_seek, 0, v_pad=stack8, t=plan.t, l_blk=plan.l_blk,
        pass_tiles=total), 3)
    del stack8
    print(f"  Table II, B=8: corr {t2_ms:.3f} ms (one run), peak "
          f"{t2_peak:.3f} GB above the {base_mem / 1e9:.3f} GB held; "
          f"replica kernel, 8 x {total} tiles: {t2k_ms:.3f} ms (runs "
          f"{[round(v, 3) for v in t2k_all]}); r bitwise corr(x), p "
          f"symmetric, replicas 0 and 7 bitwise the 2-D kernel's {tag}")

    # X-vs-Y at B = 32, chunk 16: the grid's replica mode
    g_plan = ExecutionPlan.create(N_TF, L_SEEK, n_cols=N_SEEK, replicas=32,
                                  replica_chunk=16)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    rg, pg = corr(x_tf, x_dev, pvalues=PermutationSpec(32, key=0, chunk=16))
    torch.cuda.synchronize()
    g_ms = (time.perf_counter() - t1) * 1e3
    g_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    check_sig_launches("X-vs-Y, B=32, chunk 16", g_plan)
    if not torch.equal(rg, corr(x_tf, x_dev)):
        raise AssertionError("X-vs-Y significance r is not corr(x, y)'s bits")
    check_p("X-vs-Y", pg, 32, False)
    if pg.shape != (N_TF, N_SEEK):
        raise AssertionError(f"X-vs-Y p has shape {tuple(pg.shape)}")
    del rg, pg
    print(f"  X-vs-Y {N_TF} x {N_SEEK}, B=32, chunk 16: corr {g_ms:.3f} ms "
          f"(one run), peak {g_peak:.3f} GB above the {base_mem / 1e9:.3f} "
          f"GB held; r bitwise corr(x, y) {tag}")

    # int8-quantized headline at B = 200: gathered codes, one scale vector
    q_plan = ExecutionPlan.create(N_TF, L_SEEK, compute_dtype=torch.int8,
                                  replicas=200)
    spec_q = PermutationSpec(200, key=0)
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rq8, pq8 = corr(x_tf, compute_dtype=torch.int8, pvalues=spec_q)
    torch.cuda.synchronize()
    q8_ms = (time.perf_counter() - t1) * 1e3
    check_sig_launches("int8-quantized, B=200", q_plan, "int8")
    q8_launches = pcc_tiles.replica_launches
    if not torch.equal(rq8, corr(x_tf, compute_dtype=torch.int8)):
        raise AssertionError("int8 significance r is not corr(x)'s bits")
    check_p("int8-quantized", pq8, 200, True)
    del rq8, pq8
    uq8 = q_plan.prepare(x_tf)
    sq = replica_operand(q_plan, iteration_indices(spec_q, L_SEEK)[:64],
                         method="permute", columns=x_tf, cols_prepared=uq8)
    qkw = dict(t=q_plan.t, l_blk=q_plan.l_blk, pass_tiles=tiles_sig,
               v_pad=sq.data, row_scale=uq8.scale, col_scale=sq.scale)
    if not torch.equal(pcc_tiles(uq8.data, 0, **qkw),
                       pcc_tiles_plain(uq8.data, 0, **qkw)):
        raise AssertionError("scaled int8 replica kernel != plain at the "
                             "headline shape")
    q8k_ms, _ = event_ms(lambda: pcc_tiles(uq8.data, 0, **qkw), 3)
    q8p_ms, _ = event_ms(lambda: pcc_tiles_plain(uq8.data, 0, **qkw), 1)
    reps_q = sq.data.shape[0]
    st_q = sq.data.reshape(-1, sq.data.shape[-1]).T.contiguous()
    sc_q = uq8.scale[:, None] * sq.scale.reshape(1, -1)

    def lib_q8():
        return torch._int_mm(uq8.data, st_q) * sc_q
    q8l_ms = event_ms(lib_q8, 3)[0]
    q8_ops = 2 * L_SEEK * q_plan.t ** 2 * tiles_sig * reps_q
    q8_bound = narrow_bound(
        q8_ops, uq8.data.numel() + sq.data.numel() + 4 * (
            uq8.scale.numel() + sq.scale.numel())
        + reps_q * tiles_sig * q_plan.t ** 2 * 4, INT8_OPS)
    rep_modes["int8"] = dict(launches=q8_launches, ms=q8k_ms, plain=q8p_ms,
                             lib=q8l_ms, bound=q8_bound, err=0.0)
    del sq, uq8, st_q, sc_q
    print(f"  int8-quantized headline, B=200: corr {q8_ms:.3f} ms (one run);"
          f" r bitwise corr(x, compute_dtype=int8); scaled int8 replica "
          f"kernel ({reps_q} replicas x {tiles_sig} tiles, expanded scales) "
          f"bitwise plain, {q8k_ms:.3f} ms, {q8_ops / q8k_ms / 1e9:.1f} T "
          f"ops/s, {100 * q8_bound[0] / q8k_ms:.1f} % of the bound "
          f"{q8_bound[0]:.3f} ms by {q8_bound[1]}; plain {q8p_ms:.3f} ms; "
          f"library torch._int_mm(u, stack rows.T) * (s s^T) "
          f"{q8l_ms:.3f} ms {tag}")

    # -- 19. flash attention -------------------------------------------------
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     mha_plain)
    from repro_torch.kernels.ops import flash_mha

    attn_plain_calls = [0]

    def counted_attn_plain(*args, **kwargs):
        attn_plain_calls[0] += 1
        return flash_attention_plain(*args, **kwargs)
    fmod.flash_attention_plain = counted_attn_plain   # the wrapper's route

    def reset_flash():
        flash_attention.launches = 0
        flash_attention.launches_by_dtype = {
            k: 0 for k in flash_attention.launches_by_dtype}
        attn_plain_calls[0] = 0

    def randn_qkv(b_, h_, hkv_, s_, d_, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(shape, generator=g, device=dev)
                for shape in ((b_, h_, s_, d_), (b_, hkv_, s_, d_),
                              (b_, hkv_, s_, d_))]

    def narrow_shares(got, want, dname):
        """(largest |got - want| / gate, the same over the reference's bound
        TOL_ATTN_NARROW * (1 + |want|) alone, max |got - want|) for the bf16
        / fp16 gate min(NARROW_ULP * |want| + NARROW_ROW * rms(want's row),
        TOL_ATTN_NARROW * (1 + |want|)); the gate holds where the first is
        <= 1."""
        want = want.double()
        diff = (got.double() - want).abs()
        ref_bound = TOL_ATTN_NARROW * (1 + want.abs())
        rms = want.square().mean(-1, keepdim=True).sqrt()
        gate = torch.minimum(NARROW_ULP[dname] * want.abs()
                             + NARROW_ROW[dname] * rms, ref_bound)
        return amax(diff / gate), amax(diff / ref_bound), amax(diff)

    def attn_narrow_err(got, want, dname, label):
        """(max |got - want|, largest share of the gate) after the bf16 /
        fp16 gate on every element."""
        share, _, err = narrow_shares(got, want, dname)
        if not share <= 1:
            raise AssertionError(f"flash {label}: kernel outside the {dname}"
                                 f" gate ({share:.3f} of it; max |diff| "
                                 f"{err:.3e})")
        return err, share

    print(f"flash attention vs plain at small shapes: float32 within "
          f"{TOL_ATTN_SMALL:g}; bf16 / fp16 (tensor-core kernel) within "
          f"min(ulp * |plain| + row * rms(plain's row), {TOL_ATTN_NARROW:g} "
          f"* (1 + |plain|)), ulp {NARROW_ULP}, row {NARROW_ROW}; the "
          f"windows the reference kernel drops also vs mha_plain:")
    attn_small_err = 0.0
    small_narrow = {"bfloat16": (0.0, 0.0), "float16": (0.0, 0.0)}
    for b_, h_, hkv_, s_, d_, w_ in FLASH_SMALL:
        q_, k_, v_ = randn_qkv(b_, h_, hkv_, s_, d_, s_ * 1_000 + d_)
        label = f"B={b_} H={h_} Hkv={hkv_} S={s_} D={d_} window={w_}"
        got = flash_attention(q_, k_, v_, window=w_, blk_q=16, blk_k=16)
        err = amax((got - flash_attention_plain(q_, k_, v_, window=w_))
                   .abs())
        if (s_, w_) in DROPPED_WINDOWS:
            err = max(err, amax((got - mha_plain(q_, k_, v_, window=w_))
                                .abs()))
        if not err <= TOL_ATTN_SMALL:
            raise AssertionError(f"flash {label}: kernel disagrees with "
                                 f"plain ({err:.3e})")
        attn_small_err = max(attn_small_err, err)
        for dt in (torch.bfloat16, torch.float16):
            dname = str(dt).removeprefix("torch.")
            qn, kn, vn = q_.to(dt), k_.to(dt), v_.to(dt)
            narrow = flash_attention(qn, kn, vn, window=w_, blk_q=16,
                                     blk_k=16)
            if narrow.dtype != dt or narrow.shape != qn.shape:
                raise AssertionError(f"flash {label}: bad {dt} output")
            wants = [("", flash_attention_plain(qn, kn, vn, window=w_))]
            if (s_, w_) in DROPPED_WINDOWS:
                wants.append((" vs mha_plain", mha_plain(qn, kn, vn,
                                                         window=w_)))
            for what, want in wants:
                e, sh = attn_narrow_err(narrow, want, dname,
                                        f"{label} {dname}{what}")
                small_narrow[dname] = (max(small_narrow[dname][0], e),
                                       max(small_narrow[dname][1], sh))
    print(f"  {len(FLASH_SMALL)} shapes: max|kernel - plain| float32 "
          f"{attn_small_err:.3e} (gate {TOL_ATTN_SMALL:g}); bf16 "
          f"{small_narrow['bfloat16'][0]:.3e}, at most "
          f"{small_narrow['bfloat16'][1]:.3f} of the gate; fp16 "
          f"{small_narrow['float16'][0]:.3e}, at most "
          f"{small_narrow['float16'][1]:.3f} of the gate")

    flash_rows = []
    dtype_tag = {"bfloat16": ", bf16", "float16": ", fp16"}
    for name, cfg, b_, h_, hkv_, d_, w_, s_ in FLASH_CASES:
        q_, k_, v_ = randn_qkv(b_, h_, hkv_, s_, d_, 0)
        pairs = b_ * h_ * (s_ * (s_ + 1) // 2 if w_ is None
                           else w_ * (w_ + 1) // 2 + (s_ - w_) * w_)
        chunk = None if s_ <= ATTN_WHOLE else ATTN_CHUNK
        reps = 5 if s_ <= ATTN_WHOLE else 3
        print(f"flash attention, {name} ({cfg}): B={b_} H={h_} Hkv={hkv_} "
              f"D={d_} S={s_} window={w_}: {pairs:.6g} visible pairs, "
              f"{4 * d_ * pairs:.4g} FLOP {tag}")
        dtypes = (torch.float32, torch.bfloat16) + (
            (torch.float16,) if name in FLASH_FP16 else ())
        for dt in dtypes:
            dname = str(dt).removeprefix("torch.")
            qd, kd, vd = (a.to(dt) for a in (q_, k_, v_))
            reset_flash()
            out = flash_mha(qd, kd, vd, window=w_)
            torch.cuda.synchronize()
            launches_f = flash_attention.launches
            print(f"  {dname} flash_mha: flash_attention launches "
                  f"{dict(flash_attention.launches_by_dtype)}, plain calls "
                  f"{attn_plain_calls[0]}")
            if launches_f != 1 or attn_plain_calls[0] or \
                    flash_attention.launches_by_dtype[dname] != 1:
                raise AssertionError(f"{name} {dname}: flash_mha did not run "
                                     f"through the CUDA kernel")
            if out.shape != qd.shape or out.dtype != dt or \
                    not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} {dname}: bad output")
            want = flash_attention_plain(qd, kd, vd, window=w_, chunk=chunk)
            if dt == torch.float32:
                err = amax((out - want).abs())
                if not err <= TOL_ATTN:
                    raise AssertionError(f"{name}: kernel disagrees with "
                                         f"plain ({err:.3e})")
            else:
                err, share = attn_narrow_err(out, want, dname,
                                             f"{name} {dname}")
                # Two faulty outputs the gate must refuse, and what the
                # reference's bound alone makes of them: the rows past 3S/4
                # halved, and the kernel run on v with the key block
                # [S/2, S/2 + 128) zeroed, on the rows past that block.
                r_half, j0 = 3 * s_ // 4, s_ // 2
                halved = out.clone()
                halved[:, :, r_half:] *= 0.5
                v_hole = vd.clone()
                v_hole[:, :, j0:j0 + 128] = 0
                holed = flash_attention(qd, kd, v_hole, window=w_)
                faults = [
                    (f"rows >= {r_half} halved",
                     narrow_shares(halved, want, dname)),
                    (f"v keys {j0}-{j0 + 127} zeroed, rows >= {j0 + 128}",
                     narrow_shares(holed[:, :, j0 + 128:],
                                   want[:, :, j0 + 128:], dname))]
                del halved, v_hole, holed
                for what, (f_share, f_ref, f_err) in faults:
                    verdict = "refused" if f_ref > 1 else "passed"
                    print(f"  {dname} faulty output ({what}): max|diff| "
                          f"{f_err:.3e}, {f_share:.2f} of the gate "
                          f"(refused), {f_ref:.3f} of the reference's "
                          f"bound alone ({verdict})")
                    if not f_share > 1:
                        raise AssertionError(f"{name} {dname}: the gate "
                                             f"passed a faulty output "
                                             f"({what})")
            del want
            regions = ([(0, s_)] if s_ <= ATTN_WHOLE else
                       [(0, ATTN_ROWS), (s_ - ATTN_ROWS, s_)])
            err64 = share64 = 0.0
            for r0, r1 in regions:
                ref64 = mha_plain(qd[:, :, r0:r1].double(),
                                  kd[:, :, :r1].double(),
                                  vd[:, :, :r1].double(), window=w_)
                if dt == torch.float32:
                    err64 = max(err64, amax(
                        (out[:, :, r0:r1].double() - ref64).abs()))
                else:
                    e, sh = attn_narrow_err(
                        out[:, :, r0:r1], ref64, dname,
                        f"{name} {dname} rows {r0}-{r1} vs float64")
                    err64, share64 = max(err64, e), max(share64, sh)
                del ref64
            if dt == torch.float32:
                print(f"  {dname}: max|kernel - plain| {err:.3e} (every "
                      f"row); rows {regions} vs float64 mha_plain: "
                      f"{err64:.3e} (tol {TOL_ATTN:g})")
            else:
                print(f"  {dname}: max|kernel - plain| {err:.3e}, {share:.3f}"
                      f" of the gate (every row); rows {regions} vs float64 "
                      f"mha_plain: {err64:.3e}, {share64:.3f} of the gate")
            if dt == torch.float32 and not err64 <= TOL_ATTN:
                raise AssertionError(f"{name}: kernel disagrees with "
                                     f"float64")
            k_ms, k_all = event_ms(lambda: flash_attention(
                qd, kd, vd, window=w_), reps)
            p_ms, _ = event_ms(lambda: flash_attention_plain(
                qd, kd, vd, window=w_, chunk=chunk), 3 if chunk is None
                else 1)
            l_ms, l_label = library_attn(qd, kd, vd, w_, out, reps)
            del out
            peak = FP32_FLOPS if dt == torch.float32 else BF16_FLOPS
            a_bound = narrow_bound(
                4 * d_ * pairs,
                (2 * qd.numel() + 2 * kd.numel()) * qd.element_size(), peak)
            # the share of the operation bound of the kernel's own pipes:
            # FP32 for float32 (SIMT), bf16 for bf16 / fp16 (tensor cores)
            op_ms = 4 * d_ * pairs / peak * 1e3
            pipes = "FP32" if dt == torch.float32 else "bf16"
            print(f"  {dname} flash_attention: {k_ms:.3f} ms (runs "
                  f"{[round(v, 3) for v in k_all]}), "
                  f"{4 * d_ * pairs / k_ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * op_ms / k_ms:.1f} % of the {pipes} bound "
                  f"({op_ms:.3f} ms); bound {a_bound[0]:.3f} ms by "
                  f"{a_bound[1]} (at {peak / 1e12:g} TFLOP/s); plain "
                  f"{'' if chunk is None else f'(rows in chunks of {chunk}) '}"
                  f"{p_ms:.3f} ms; library "
                  f"{'not measured' if l_ms is None else f'{l_ms:.3f} ms'} "
                  f"({l_label})")
            flash_rows.append({
                "name": f"flash_attention ({name}{dtype_tag.get(dname, '')})",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention"
                          f"{'' if dt == torch.float32 else '_sm90'}.cu",
                "replaces": "src/repro/kernels/flash_attention.py:118",
                "launches": launches_f, "max_abs_err": err, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": a_bound[0],
                "bound_by": a_bound[1], "library_ms": l_ms})
        del q_, k_, v_, qd, kd, vd
    fmod.flash_attention_plain = flash_attention_plain

    # -- 20. multi-pass top-k: the sinks wait on their own pass only ---------
    print(f"multi-pass top-k at Table II, {SPLIT}-tile passes {tag}:")
    overlap_runs(x_dev, K_TOP, SPLIT)

    # -- 21. HostSink: a checkpointed host result, stopped and resumed -------
    print(f"HostSink at Table II, {SPLIT}-tile passes {tag}:")
    print(json.dumps({"host_sink": host_sink_runs(x_dev, SPLIT)}))

    # -- 22. streaming reductions and the transform cache ---------------------
    print(f"streaming reductions and the transform cache at Table II {tag}:")
    print(json.dumps({"streaming": streaming_runs(
        x_dev, x_tf, SPLIT, reset_counts, check_launches, tag)}))

    # -- 23. merge-sort Kendall at the paper's sample count --------------------
    print(f"merge-sort Kendall at l = {L_SEEK} {tag}:")
    kendall_record, kendall_times = kendall_runs(x_dev, x_tf, reset_counts,
                                                 tag)
    print(json.dumps({"kendall": kendall_times}))

    # -- 24. the serving layer at full width -----------------------------------
    print(f"serving (CorrServer, LiveIndex, watch) on the Table II corpus "
          f"{tag}:")
    print(json.dumps({"serving": serving_runs(x_dev, x_tf, reset_counts,
                                              plain_calls, tag)}))
    torch.cuda.empty_cache()

    # -- 25. recovery on the card ----------------------------------------------
    print(f"recovery (corr(recovery=), checkpoints and shards under faults, "
          f"a real out-of-memory error) at Table II {tag}:")
    print(json.dumps({"recovery": recovery_runs(x_dev, x_tf, reset_counts,
                                                plain_calls, tag)}))

    # -- 26. the mesh ----------------------------------------------------------
    print(f"the mesh (corr(mesh=), one process driving every rank) at "
          f"Table II {tag}:")
    print(json.dumps({"mesh": mesh_runs(x_dev, x_tf, reset_counts,
                                        plain_calls, tag)}))

    # -- 27. LM serving at full width ------------------------------------------
    torch.cuda.empty_cache()
    lm_names = LM_ARCHS + tuple(m[0] for m in LM_MOE) + \
        tuple(f[0] for f in LM_FAMILIES)
    print(f"LM serving (launch.serve, prefill on the flash kernel) at full "
          f"width: {', '.join(lm_names)} {tag}:")
    lm_rows, lm_out = lm_runs(dev, tag)
    print(json.dumps({"lm": lm_out}))

    # -- 28. LM training at full width -----------------------------------------
    torch.cuda.empty_cache()
    print(f"LM training (make_train_step, AdamW, TrainLoop with checkpoints) "
          f"at full width: {TRAIN_ARCH} {tag}:")
    print(json.dumps({"train": train_runs(dev, tag)}))

    # -- 29. LM serving over a model axis --------------------------------------
    torch.cuda.empty_cache()
    print(f"LM serving over a (data, model) mesh (models/parallel.py), "
          f"flash on each rank's heads {tag}:")
    tp_rows, tp_out = tp_runs(tag)
    print(json.dumps({"tp": tp_out}, default=str))

    # -- 30. LM training over a mesh -------------------------------------------
    torch.cuda.empty_cache()
    print(f"LM training over a (data, model) mesh (make_train_step("
          f"policy=), TrainLoop pjit) {tag}:")
    print(json.dumps({"train_mesh": train_mesh_runs(tag)}, default=str))

    source = "src/repro_torch/kernels/csrc/"
    narrow_records = []
    for dname, short, tiles_l, sel_l in [
            ("bfloat16", "bf16", bf_tiles_launches, bf_select_launches),
            ("float16", "fp16", f16_tiles_launches, f16_select_launches),
            ("int8", "int8", k_tiles_launches, k_select_launches)]:
        f = full[dname]
        narrow_records += [
            {"name": f"pcc_tiles ({short})", "route": "cuda",
             "source": source + "pcc_tile_sm90.cu",
             "replaces": "src/repro/kernels/pcc_tile.py:299",
             "launches": tiles_l, "max_abs_err": narrow_err[dname],
             "ms": f["ms"], "plain_ms": f["plain"], "bound_ms": f["bound"][0],
             "bound_by": f["bound"][1], "library_ms": f["lib"]},
            {"name": f"pcc_topk_select ({short})", "route": "cuda",
             "source": source + "pcc_topk.cu",
             "replaces": "src/repro/kernels/pcc_tile.py:612",
             "launches": sel_l, "max_abs_err": narrow_err[dname],
             "ms": f["sel"], "plain_ms": f["sel_plain"],
             "bound_ms": f["sel_bound"][0], "bound_by": f["sel_bound"][1],
             "library_ms": f["sel_lib"]}]
    record = {"kernels": [
        {"name": "pcc_tiles", "route": "cuda", "source": source + "pcc_tile.cu",
         "replaces": "src/repro/kernels/pcc_tile.py:299",
         "launches": launches, "max_abs_err": max_err,
         "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": lib_ms},
        {"name": "pcc_tiles (grid)", "route": "cuda",
         "source": source + "pcc_tile.cu",
         "replaces": "src/repro/kernels/pcc_tile.py:299",
         "launches": grid_launches, "max_abs_err": grid_err,
         "ms": grid_ms, "plain_ms": gplain_ms, "bound_ms": grid_bound,
         "bound_by": grid_by, "library_ms": glib_ms},
        {"name": "pcc_topk_select", "route": "cuda",
         "source": source + "pcc_topk.cu",
         "replaces": "src/repro/kernels/pcc_tile.py:612",
         "launches": topk_launches["select"], "max_abs_err": topk_err,
         "ms": sel_ms, "plain_ms": ptk_ms, "bound_ms": sel_bound,
         "bound_by": sel_by, "library_ms": libk_ms},
        {"name": "pcc_topk_merge", "route": "cuda",
         "source": source + "pcc_topk.cu",
         "replaces": "src/repro/kernels/pcc_tile.py:612",
         "launches": topk_launches["merge"], "max_abs_err": merge_err,
         "ms": merge_ms, "plain_ms": merge_plain_ms,
         "bound_ms": merge_bound,
         "bound_by": merge_by, "library_ms": None},
        {"name": "pcc_topk_merge (grid)", "route": "cuda",
         "source": source + "pcc_topk.cu",
         "replaces": "src/repro/kernels/pcc_tile.py:612",
         "launches": grid_topk_launches, "max_abs_err": merge_err,
         "ms": g_merge_ms, "plain_ms": g_merge_plain_ms,
         "bound_ms": g_merge_bound, "bound_by": g_merge_by,
         "library_ms": g_lib_ms},
        *narrow_records,
        *[{"name": name, "route": "cuda", "source": source + src_,
           "replaces": "src/repro/kernels/pcc_tile.py:299",
           "launches": quant[key]["launches"], "max_abs_err": new_err[key],
           "ms": quant[key]["ms"], "plain_ms": quant[key]["plain"],
           "bound_ms": quant[key]["bound"][0],
           "bound_by": quant[key]["bound"][1],
           "library_ms": quant[key]["lib"]}
          for name, key, src_ in (
              ("pcc_tiles (scaled int8)", "int8", "pcc_tile_sm90.cu"),
              ("pcc_tiles (scaled fp8 e4m3)", "float8_e4m3fn",
               "pcc_tile_sm90.cu"),
              ("pcc_tiles (scaled fp8 e5m2)", "float8_e5m2",
               "pcc_tile_sm90.cu"),
              ("pcc_tiles (triangle, second operand)", "pair",
               "pcc_tile.cu"))],
        {"name": "pcc_tiles (replica)", "route": "cuda",
         "source": source + "pcc_tile.cu",
         "replaces": "src/repro/kernels/pcc_tile.py:299",
         "launches": sig_launches, "max_abs_err": rep_err, "ms": rk_ms,
         "plain_ms": rp_ms, "bound_ms": rbound[0], "bound_by": rbound[1],
         "library_ms": rl_ms},
        *[{"name": name, "route": "cuda",
           "source": source + "pcc_tile_sm90.cu",
           "replaces": "src/repro/kernels/pcc_tile.py:299",
           "launches": rep_modes[key]["launches"],
           "max_abs_err": max(rep_modes[key]["err"],
                              rep_narrow.get(key, (0.0, 0.0))[0]),
           "ms": rep_modes[key]["ms"], "plain_ms": rep_modes[key]["plain"],
           "bound_ms": rep_modes[key]["bound"][0],
           "bound_by": rep_modes[key]["bound"][1],
           "library_ms": rep_modes[key]["lib"]}
          for name, key in (("pcc_tiles (replica bf16)", "bfloat16"),
                            ("pcc_tiles (replica fp8 e4m3)",
                             "float8_e4m3fn"),
                            ("pcc_tiles (replica scaled int8)", "int8"))],
        *flash_rows,
        *lm_rows,
        *tp_rows,
        kendall_record,
    ]}
    # the header holding each pcc kernel's mainloop, beside its source: the
    # tiles' by their file, the selects' by their dtype (float32 on the
    # SGEMM mainloop, bf16 and int8 on the tensor-core one)
    mainloops = {"pcc_tile.cu": "pcc_sgemm.cuh",
                 "pcc_tile_sm90.cu": "pcc_mma.cuh"}
    for rec in record["kernels"]:
        if rec["name"].startswith("pcc_topk_select"):
            rec["mainloop"] = source + (
                "pcc_mma.cuh" if any(d in rec["name"] for d in (
                    "bf16", "fp16", "int8")) else "pcc_sgemm.cuh")
        elif rec["name"].startswith("pcc_tiles"):
            rec["mainloop"] = source + mainloops[
                rec["source"].rsplit("/", 1)[1]]
    print(f"script time {time.perf_counter() - t_script:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
