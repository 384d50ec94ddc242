#!/usr/bin/env python3
"""Start deft_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # also torch.profiler decode breakdowns
    python3 chip_smoke.py --flatten-only [--profile] [--root DIR]
        # the card, the build and the flatten kernels' checks and times only
        # (B1, B1p, B4, B4p, B6, B11; B6 and B11 also at the wide heads, D 96
        # and 256, over bf16 and int8 pools; with --profile the batch path's
        # profiled flatten steps), over this checkout's package or DIR's:
        # a parent commit timed in turns with this one on one card
    python3 chip_smoke.py --seq-only [--root DIR]
        # the same for the seq kernels (B2, B2p, B5, B5p, B7; B7 also at
        # the wide heads, D 96 and 256, and its path edges at every width)
    python3 chip_smoke.py --prefill-only [--root DIR]
        # the same for B3 and B8 at head_dim 64, 96, 128 and 256: each
        # against its plain version, then its time beside its bound
    python3 chip_smoke.py --workloads-only [--profile]
        # the card, the build and the workloads phase (8 below) alone
    python3 chip_smoke.py --chain-only [--profile]
        # the card, the build and the chain phase (9 below) alone
    python3 chip_smoke.py --attention-only
        # the card, the build and the attention phase (4a below) alone
    python3 chip_smoke.py --replay-only
        # the card, the build and the replay phase (9a below) alone
    python3 chip_smoke.py --wide-only
        # the card, the build and the served runs that reach the wide heads'
        # kernel instances and the other ones first served beside them: B7
        # at the wide heads' batch seq plans against its plain version, 6's
        # int8 seq through BatchedEngine, 7's int8 KV engine runs, 15's
        # wide-head families (bf16, int8 KV, batched, grid 2x1x2), 11 and
        # 14's mixtral-6l on grid 2x1x2
    python3 chip_smoke.py --lab-only
        # the card, the build and the kernel lab phase (17a below) alone

Every phase runs the runtime's default decode path (replayed spans, as a
user's call does) but two, which set the per-step chain (DEFT_REPLAY_EXEC=0
DEFT_PLAN_PATCH=0) for their runs: 8 (workloads), whose mid-run holds and
merge read-backs hook forward_tree_decode and apply_kv_copies, which the
record path does not call step by step, and 9 (chain), which holds that
chain against the per-step path; 9a runs the three paths side by side.

Phases, each fatal on failure (the script then exits non-zero and prints no
result line):
  1. card:    nvidia-smi's name and power limit, torch's device name;
  2. build:   nvcc builds every kernel from csrc/, one process per source;
              the wgmma bodies (B1's among them, B3/B8's and B6's over bf16
              pools at D 96 and 256 too) must hold HGMMA, the mma.sync
              bodies of B2, B4, B5 and B7 (seq_q_wide at D 96 and 256 too)
              and B6's over int8 pools at every width HMMA (cuobjdump's
              SASS); ptxas's register and spill lines of B1's body and of
              the wide heads' bodies (B3/B8, B7, B6/B11), none with a
              spill; no flatten library instantiates the fp32-q staged body
              (flatten_body.cuh) over bf16 q;
  3. kernels: each kernel against its plain torch version on the card, on the
              shapes its path gives it (Llama-3.1-8B heads and matmuls, B10
              at Mixtral-8x7B's prefill; the partial entries B1p, B4p, B2p
              and B5p at rank 0's window of grid 1x2x2 on the main tree, B11
              at rank 0's window of grid 2x1x2 on the 16-token prompt's
              tree: 4 KV heads; bf16, tolerance 2e-2) and on small
              fp32 cases (tolerance 2e-5): trees with dead, FULL and
              few-leaf blocks, unaligned seq segments and a short prompt's
              plans that are not segment-aligned (B7 also on the main tree
              halfway, built as a gather seq plan), over bf16/fp32 pools and
              int8 pools with random codes and scales, live rows only; B10
              with an empty expert group and pad tiles past the last group;
              the partial entries on every rank's window of a dp 2 x sp 3
              grid (shifted leaf intervals, pad blocks; acc and l on live
              rows, m where a row saw a token); the sp merge of B1p's two
              halves of the main plan against B1 over the whole; the edges
              of the tensor-core bodies (b9_edges, seq_edges for B2 and B5,
              b7_edges, b4_edges, b1_edges, b6_edges, wgmma_edges; qpk 1, 4,
              7 (Qwen2.5-7B) and 8), each with a fault
              control through the plain version that must read above the
              tolerance; b1_edges and b6_edges also print the grids B1, B1p,
              B6 and B11 take at their path shapes.  B6 runs at the short
              tree and at the batch path's four trees halfway (their
              multi-tree gather plan), bf16 and int8 pools, with the row
              tiles the runner counts on the host; B4 also on those trees
              eight steps later, the plan paged under the batch engine's
              int8 rule (the batch path's int8 flatten steps).  The wide heads
              (WIDE_HEADS: Phi-3-mini 32/32 x D 96, Gemma-7B 16/16 x D 256,
              which take gather plans only) run B3, B8, B6, B7 and B11
              (B6, B7 and B11 over bf16 and int8 pools) at the same path
              shapes (wide_shapes), fp32 and bf16 edge cases and a fault
              control each (wide_edges; B3 at qpk 1, 2, 4 and 8, B7 also on
              b7_edges' synthetic paths at qpk 1, 2 and 8 with its
              controls; b6_edges: B6 and B11 at 4- and 8-warp blocks, 1,
              the rule's and twice its spans, DUMP_SLOT's row NaN, both dp
              windows, with controls), and B7 on the batch path's four
              trees halfway, the multi-tree seq plan the batched engine
              builds at their widths (wide_batch_seq: the plain version a
              chunk of leaves at a time; not timed); their rows in the
              kernels line are named <kernel>_d96 and <kernel>_d256;
  4. main:    the 8B model (random bf16 weights from a CUDA torch.Generator,
              all 32 layers) serves Simple_Tree few-shot, width 50, prompt
              4000, 64 generated tokens, block_len 256, in flatten then seq
              mode on the default path (replayed spans from plan slabs,
              its steps chained on the device), the runs under
              set_sync_debug_mode("error") (phase 9a holds the same runs'
              tokens against the decode windows and the per-step chain,
              phase 9 that chain against the per-step path); the kernels
              line's launches are this run's; B1-B3's launch counters must move
              during this run, and
              the first decode step's logits must agree between modes
              (relative L2 error below LOGITS_LIMIT), while two controls on
              the same step must land on either side of that limit: one ulp
              of noise in every layer's attention output below it, one plan
              block of the prompt hidden from every leaf above it (a rerun
              and a one-token mask fault are printed beside them); then
              checkpoint and restore (runtime/checkpoint.py): save mid-run,
              restore into a fresh runner on the same weights, the next
              step's logits against the uninterrupted run's below
              LOGITS_LIMIT (a dropped block above), greedy ids compared; the
              same at the 8B widths, 4 layers, fp32, where every leaf's
              greedy id must be equal;
 4a. attention: the runner's attention estimate (measure_attention's
              default, on for the card): the main path's workload, flatten
              and seq, each chained (under set_sync_debug_mode("error"),
              where the microbench's one wait a bucket goes through
              runner.bench_wait) then per-step: every step's attn_mem and
              attn_comp printed (by runs of equal steps: one bucket each),
              attention_latency and the seq / flatten attention speedup
              (bench.py's attn_speedup); every attn_comp > 0, attn_mem below
              STORE_LIMIT_MS, the chained flatten run's host waits those of
              the main phase's run (no estimate); each mode's attn_comp
              against torch.profiler's device time of its attention kernels
              in 4 profiled steps at the same bucket, within ESTIMATE_BAND;
              then
              bench.py's shape: the 3b preset at block_len 1024 (prompt
              4000, width 50): B1 and B2 at that plan against their plain
              versions (2e-2, live rows), and its flatten and seq runs'
              estimates and speedup, the paged kernels launched;
  5. int8:    the same weights and workload over an int8 KV cache, flatten
              then seq: B4 and B5 must launch and B1 and B2 must not; the
              first decode step's logits are compared with the bf16 cache's;
  6. short:   the same weights and workload over the CLI's default 16-token
              prompt, flatten then seq, bf16 then int8 KV: the steps whose
              plans are not segment-aligned run B6 and B7, which must launch;
              then int8 KV in seq mode through BatchedEngine, one request:
              its int8 rule (waste 3) gathers every step, so B7 runs over
              int8 pools (tree_generate's, waste 32, pages them: B5);
  7. batch:   four requests with distinct prompts of 4000, 3000, 2000 and
              1000 tokens (the 8B bf16 weights, bf16 KV, 40960 slots), each a
              width-50 Simple_Tree of 64 tokens a branch: first each alone
              (B3 prefill and its first decode step), then all four in one
              ragged prefill (B8) and one multi-tree step on the same branch
              tokens, whose rows must agree with the alone runs (relative L2
              below LOGITS_LIMIT); then BatchedEngine.add_requests + run() in
              flatten and in seq: B8 launches once a layer, B3 never, B1 or
              B6 (flatten) and B2 or B7 (seq) must launch; B6's launches at
              the flatten run's gather steps join the short path's in the
              kernels line; B8's outputs in the admission's first and last
              layers against its plain version on the same inputs (the
              prompts start inside 64-token tiles); then the two engine runs
              over an int8 KV cache on the same weights: B6 over int8 pools
              must launch, B4 at the steps whose multi-tree plan pages;
  8. workloads: every workload and decode mode on the main path's settings
              (bf16 weights, prompt 4000, 64 tokens, width 50), each run
              through tree_generate with its launches, TTFT, TPOT and peak
              memory printed: W1 Practical_Tree on the CLI's synthetic ToT
              template, W2 Speculative_Decoding on its synthetic token tree
              (merge copies read back equal to their sources, the root
              grown by the accept schedule, no lm_head after the prefill),
              W3 Beam_Search (50 live beams a step), W4 Random_Tree (the
              same schedule in both modes; W1, W2 and W4 on the per-step
              chain under set_sync_debug_mode("error"), their tokens held
              against the per-step path in phase 9), each flatten then seq with
              each mode's own decode kernels only, and a mid-run step held
              in the flatten run (the first after the first branch, prune
              or merge, and the first gather-plan step after it): seq
              against flatten below LOGITS_LIMIT, a dropped block above;
              W5 sampled Simple_Tree twice from RandomState(0), equal
              tokens; W6 the first decode step of node, node_chunk,
              tree_index, unpaged flatten/node/seq and Medusa against
              flatten's below LOGITS_LIMIT (the dropped block above), then
              a Simple_Tree run each of W6_GEN tokens (Medusa: no decode
              kernel), then node over int8 KV (B4 or B6); W7 four
              Speculative_Decoding
              requests through BatchedEngine (B8 at admission, each
              request's merges by its schedule); B6's and B7's launches
              join the kernels line;
  9. chain:   device-chained decode (runtime/generate.py, BatchedEngine's
              all-greedy fast path) against the per-step path (each
              workload wrapped in a plain function, which hides its
              structural_iters, logits_free_iters and supports_deferred) on
              the main path's settings: Simple_Tree, W1 Practical_Tree
              (deferred selection), W2 Speculative_Decoding (pipelined
              logits-free steps), W4 Random_Tree (deferred), flatten and
              seq: W1's, W2's and W4's chained runs are phase 8's, the
              others made here, all under
              set_sync_debug_mode("error"), where only the runner's
              host_wait (and the script's own checks inside the run) may
              wait, and this phase runs the per-step side on a runner built
              as theirs; then the main path over int8 KV (flatten) and the
              batch path's four requests through
              BatchedEngine in both modes, each per-step and chained here:
              equal branch token ids
              in every pair (if not, the per-step path is rerun twice as a
              control).  A .item() under the mode must raise first; the moe
              path runs one such pair too.  Each run prints TPOT, e2e, the
              sum of iter_time and its host waits (the main flatten path's
              turns are 9a's); the top-K tie rule (one int64 topk, no host
              read) is timed against the rule it replaced (fp32 topk, a host
              read of the tie width) at 50 rows of the vocabulary, k 50 and
              64; with --profile, 8 profiled main flatten steps of each path
              in turns (per-step, chained, chained, per-step);
 9a. replay:  deft_tpu's default decode path (runtime/generate.py's record
              path, runner.execute_recorded's slab windows and steps)
              against its decode windows (DEFT_REPLAY_EXEC=0) and the
              per-step chain (DEFT_REPLAY_EXEC=0 DEFT_PLAN_PATCH=0), each
              on a fresh runner under its switches and under
              set_sync_debug_mode("error"): main flatten and seq, W1
              Practical_Tree, W2 Speculative_Decoding and W4 Random_Tree
              (its gather plans, B6) in flatten, and main flatten over
              int8 KV; the launch counts set to 0 before
              each run, each path's decode kernel launched; branch token ids
              equal across the three paths (else the first position that
              differs and the top-2 margin there, from a per-step rerun with
              full logits, are printed, and the phase fails); TPOT, e2e, the
              sum of iter_time, host waits, plan copies to the card and
              plan_upload_bytes against plan_full_bytes of every run; the
              main flatten paths in turns (replay, windows, chain, chain,
              windows, replay);
 10. int8w:   the main path's workload over int8 weights made on the card
              (weight_dtype "int8-pallas"), flatten then seq: B9 launches 129
              times a decode step (4 matmuls x 32 layers + lm_head) and never
              in prefill; the first decode step's logits against the same
              codes and scales under "int8" (the plain expression, 0 B9
              launches) below LOGITS_LIMIT; the flatten run (the default,
              replayed path) against the decode windows and the per-step
              chain as in 9a: equal ids, B9 129 times a decode step on
              each;
 11. moe:     Mixtral-8x7B widths at deft_tpu's 6 layers (PRESETS
              ["mixtral-6l"], bf16 weights from a CUDA torch.Generator), the
              main path's workload over a prompt of ids below its 32000-token
              vocabulary: the prefill's MoE runs through B10 (gmm, 18
              launches a prefill, none in decode), decode through the dense
              expert route.  The route check holds the prefill's last-token
              logits through B10 against the port's dense route and against
              the dense sum in B10's rounding order on the same weights
              below MOE_LIMIT, between a noise control (one ulp on every
              layer's MoE output) and a fault control (the tile of the last
              token's first routed row sent to another expert in every
              layer), and each layer's MoE output against both on the same
              input below MOE_LAYER_LIMIT; it counts the (token,
              layer) pairs whose top-2 experts differ between the routes.
              The first decode step, seq against flatten, with the main
              path's attention controls, below MOE_STEP_LIMIT;
 12. moe-int8w: Mixtral-8x7B at all 32 layers over int8-pallas weights made
              on the card (about 47 GB): B10's scaled entry (gmm_scaled) 96
              launches a prefill, B9 65 a decode step (wqkv and wo x 32 +
              lm_head); the route check on the same codes and scales, the
              logits below MOE_INT8_LIMIT, the first
              step as above, TTFT and TPOT beside the moe path's, and the
              path's peak device memory;
 13. sharded: the multi-device engine (parallel/), four ranks started on the
              one card over gloo (NCCL refuses two ranks on one card; that
              refusal is checked), grid 1x2x2 (tp 2, sp 2): the 8B model at
              32 layers from the main path's seed (each rank draws its
              slices), the main path's workload flatten then seq: B3, B1p
              and B2p launch on every rank, B1 and B2 on none; the first
              step's logits against the main path's below LOGITS_LIMIT, and
              a fault control above it (in every layer sp rank 1's state,
              the prompt's end and the leaves' tokens, left out of the
              merge); the live plan tokens of each sp rank, each at least a
              quarter of them; 8 decode tokens a mode (SHARDED_GEN; the
              main path runs 63), their greedy ids against the main path's
              first 8, TTFT and TPOT (four processes sharing one card: no
              statement on several cards' speed); the prefill's 4000 tokens
              split over sp; then the batch path's four requests
              through BatchedEngine, flatten then seq (23 decode steps,
              SHARDED_BATCH_GEN): B8 on every rank's
              heads at admission, its last-token logits against the batch
              path's admission below LOGITS_LIMIT (the vocab join left out
              above it), B11 on the gather steps and B1p on the paged steps
              (both on every rank), B2p on every rank, no single-device
              decode kernel; then an int8 KV cache (B4p, B5p; 8 decode
              tokens, its first step against the int8 path's); then grid
              2x1x2 over the 16-token prompt, 8 decode tokens a mode:
              flatten (B11 with dp 2), node, tree_index and Medusa; every
              grid run, admission and
              prefill included, under set_sync_debug_mode("error");
 13a. sharded-dp: the 8B at 32 layers on grid 2x1x2 (DP_GRID: dp 2, tp
              2), the main prompt at width 50, each rank running its dp
              window of the plan's 64 rows (32: the 50 leaves and 14 pad
              rows, as deft_tpu's specs cut the padded batch) through
              every layer: the
              rows each rank sends through wqkv and wgu at the prefill and
              a decode step, the collectives a step and a prefill
              (Grid.staged) against the count the code gives for this
              layout and for the replicated one it replaced, the first
              step's ms and logits against the main path's below
              LOGITS_LIMIT (the dp join of the logits left out above it),
              then 8 decode tokens flatten then seq under
              set_sync_debug_mode("error"): B1p / B2p on every rank, no
              single-card decode kernel, greedy ids against the main
              path's, peak memory a rank; then the same grid over
              int8-pallas weights, flatten: B9 129 times a decode step on
              every rank at 32 rows, the first step against the int8w
              path's below LOGITS_LIMIT;
 14. sharded-moe: mixtral-6l on grid 1x2x2 (4 experts a rank): B10 on every
              rank's prefill, its last-token logits against the moe path's
              below MOE_LIMIT, then 8 decode tokens under
              set_sync_debug_mode("error"); then on grid 2x1x2 (DP_GRID, every
              expert on each rank): a decode rank's 32 of the plan's 64 rows
              through each layer's MoE block, B10 on every rank's prefill,
              the first step against the moe path's below MOE_STEP_LIMIT
              (the other dp window's rows left out above it), 8 tokens;
 15. families: Qwen2.5-7B (qkv bias, 7 q heads a KV head), Qwen3-8B
              (qk-norm), Gemma-7B (Gemma norms, GeGLU, tied lm_head,
              head_dim 256) and Phi-3-mini's widths (head_dim 96; its
              published sliding window set to null, which both packages
              refuse) at the widths typed into FAMILIES from their
              config.json: the first three each written at full width
              and 2 layers as a two-file safetensors checkpoint by the
              script's own writer,
              loaded through `python3 -m deft_tpu_torch.cli.run --model DIR
              --device cuda` and bit-exactly through load_params; then
              served at full depth from random weights on the main path's
              settings: the first step seq against flatten below the
              family's FAMILY_LIMITS (noise below, every other prompt block
              dropped above), B1/B2 (Qwen) or B6/B7 (Gemma and Phi-3,
              every step) launched, TTFT, TPOT and peak memory printed,
              and for the wide heads B6's (with its merge) and B7's device
              ms in 4 profiled steps of each mode against their device busy
              and wall time.  The wide heads on the same weights: (e) the
              same workload over int8 KV, int8 seq against int8 flatten
              below the family's limit between the same controls, B6 and B7
              over int8 pools; (f) the batch path's protocol (7) at their
              heads, below the family's limit: B8, B6 and B7, never B1/B2;
              then (g) each on grid 2x1x2 over the 16-token prompt (SHORT_GRID,
              full depth): the first step on rank 0 against the single
              card's below the family's limit (the other dp window's rows
              left out above it), 8 tokens flatten and seq over bf16 and
              flatten over int8 pools: B11 and B7 on every rank.  Their B3,
              B8, B6, B7 and B11 launches (rank 0's) fill the kernels line's
              _d96 and _d256 rows, none of which may read 0;
 16. tracing: one short CLI run under --trace-dir: the Chrome trace holds
              the decode_step spans and kernels of the port;
 17. timing:  (run after 14 and before 15, whose four Gemma-7B ranks need
              the card the kernel cases held) CUDA-event times of each
              kernel, its plain version and, where
              one PyTorch call computes the same function, that call, at its
              path's shapes, beside the least time the card could take
              (B6 at both its plans, B7 at the short tree and the main
              tree's gather plan, bf16 and int8 pools, the short plans'
              bf16 cases in the kernels line; the wide heads' kernels at
              their path shapes); B1, B1p, B4, B4p, B6 and B11
              also with one span and with a warm L2 (flat_q_tile_cost).
 17a. lab:   (run after 17 and before 15) the flatten kernel lab
              (deft_tpu_torch/experiments/kernel_lab.py, the port of
              deft_tpu's experiments/kernel_lab.py) through its entry at the
              full shapes, cases drawn on the card: B1 on each case, B12
              (vB_b512), B13 (vD_b512), B14 (k2_b1024s512, deep_tq64_b512),
              B15 (probe_exp2_b512) and full_b512, each timed by the lab a
              32-layer step; the lab exits non-zero if a variant fails to
              launch or disagrees with B1 on its case beyond 2e-2; B12-B15
              must launch, every output be finite; then each against its
              plain version on the same inputs (bf16 2e-2; the probe, fp32,
              1e-5 absolute), its CUDA-event time, plain time, B1's library
              call on the same case and bound (the probe's: its exp2 at 16 a
              clock per SM at the reported maximum SM clock); the build
              phase prints the MUFU.EX2 count of exp2f and the lab kernels'
              registers, and their bodies must hold HMMA;
Each path's counts are set to 0 just before it and read just after (the
short path's two runs each, summed; the batch path's two engine runs each).
Then one JSON line of kernels, the card's nvidia-smi line, and the last
line {"ok": true, "device": {...}}.

Tolerances: bf16 kernels round P to bf16 for the PV product and sum in
another order than the fp32 plain versions, so 2e-2 relative (deft_tpu
tests/test_kernels.py's bf16 bound); fp32 kernels differ by summation order
only, 2e-5.  Errors are max |kernel - plain| / max |plain| over live rows.
The batch path's four paths hold their B8 and multi-tree logits to the
main path's LOGITS_LIMIT, against the same requests run alone.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 and fp32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0
# relative L2 error allowed between the first decode step's logits in
# flatten and in seq mode (bf16, 32 random layers): the geometric mean of the
# one-ulp-noise control (1.835e-2) and the dropped-block fault (1.854e-1) on
# an H100, rounded down (logits_controls; PERF.md)
LOGITS_LIMIT = 5e-2
# Limits of the MoE paths (moe_route_check, moe_first_step), each set
# between its controls as measured on an H100 (PERF.md, the MoE findings).
# The prefill's last-token logits through B10 against the dense expert
# route and against the dense sum in B10's rounding order: the moe path
# keeps LOGITS_LIMIT (noise 1.259e-2, fault 8.558e-1; readings 8.795e-3 and
# 1.067e-2).  At 32 int8 layers top-2 choices flip at 4-6% of (token,
# layer) pairs against either reference and the readings are 2.480e-1 and
# 2.267e-1: the limit lies between those and the fault (6.599e-1; noise
# 1.932e-2).
MOE_LIMIT = LOGITS_LIMIT
MOE_INT8_LIMIT = 0.4
# each layer's MoE output through B10 against either reference on the same
# input: the geometric mean of the larger noise control (7.635e-3) and the
# smaller fault (1.480e-1), rounded down; readings 1.208e-5 and 6.039e-3
# against the dense route (bf16, int8), 1.126e-3 and 7.110e-4 against the
# sum in B10's order
MOE_LAYER_LIMIT = 3e-2
# the first decode step's logits, seq against flatten, MoE models: a router
# turns one ulp of attention noise into other experts for some leaves, so
# the noise control lands at 4.706e-2 (6 layers) and 1.667e-1 (32 layers);
# the geometric mean of the latter and the smaller dropped-block fault
# (4.018e-1), rounded down
MOE_STEP_LIMIT = 0.25
WIDTH, PROMPT_LEN, GEN_LEN = 50, 4000, 64
# bench.py's BLOCK_LEN (bench.py:51): the block length of the attention
# phase's 3b plans
BENCH_BLOCK_LEN = 1024
# the attention phase: each mode's estimate (attn_comp, the runner's
# microbench) against torch.profiler's device time of its attention kernels
# at the same bucket, relative.  Readings on an H100 (PERF.md): 1.060-1.080
# (flatten), 0.970-0.984 (seq); the band leaves room for the gaps between
# launches, which the events see and the kernel sums do not, while timing
# at the host's launch pace (6.4x the device time of a flatten step's
# attention in the same profile) lands far outside it.  And the most a
# bf16 step's KV stores (attn_mem) may take, ms
ESTIMATE_BAND = 0.3
STORE_LIMIT_MS = 1.0
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the batch path: four prompts; 40960 KV slots (5.4 GB), because each of the
# 200 leaves reserves a 128-slot chunk (core/kv_pool.py alloc_for), so the
# 10000 prompt tokens plus 200 chunks do not fit 32768
BATCH_LENS = (4000, 3000, 2000, 1000)
BATCH_SLOTS = 40960
# Llama-3.1-8B's matmul weights (H, I), as B9 sees them at decode
INT8_SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672),
               "wdown": (14336, 4096), "lm_head": (4096, 128256)}

# name -> (TPU kernel it replaces, source, plan kind, KV, plan layout)
KERNELS = {
    "prefill": ("deft_tpu/ops/prefill.py:82", "prefill.cu", None, None, None),
    "paged_flatten": ("deft_tpu/ops/paged_flatten_attn.py:63", "paged_flatten.cu",
                      "flatten", "inherit", "paged"),
    "paged_seq": ("deft_tpu/ops/paged_seq_attn.py:41", "paged_seq.cu", "seq",
                  "inherit", "paged"),
    "paged_flatten_q": ("deft_tpu/ops/paged_quant.py:32", "paged_flatten.cu",
                        "flatten", "int8", "paged"),
    "paged_seq_q": ("deft_tpu/ops/paged_seq_attn.py:41", "paged_seq.cu", "seq",
                    "int8", "paged"),
    "flatten_gather": ("deft_tpu/ops/flatten_attn.py:77", "flatten_gather.cu",
                       "flatten", None, "gather"),
    "seq_gather": ("deft_tpu/ops/seq_attn.py:28", "seq_gather.cu", "seq", None,
                   "gather"),
    "ragged_prefill": ("deft_tpu/ops/prefill.py:205", "prefill.cu", None, None, None),
    "int8_matmul": ("deft_tpu/ops/int8_matmul.py:44", "int8_matmul.cu", None, None,
                    None),
    "gmm": ("deft_tpu/ops/gmm.py:37", "gmm.cu", None, None, None),
    "gmm_scaled": ("deft_tpu/ops/gmm.py:58", "gmm.cu", None, None, None),
    # the partial entries of the multi-device engine (sharded paths)
    "paged_flatten_partial": ("deft_tpu/ops/paged_flatten_attn.py:408", "paged_flatten.cu",
                              "flatten", "inherit", "paged"),
    "paged_flatten_q_partial": ("deft_tpu/ops/paged_quant.py:321", "paged_flatten.cu",
                                "flatten", "int8", "paged"),
    "paged_seq_partial": ("deft_tpu/ops/paged_seq_attn.py:351", "paged_seq.cu", "seq",
                          "inherit", "paged"),
    "paged_seq_q_partial": ("deft_tpu/ops/paged_seq_attn.py:389", "paged_seq.cu", "seq",
                            "int8", "paged"),
    "flatten_gather_partial": ("deft_tpu/ops/sharded_flatten.py:37", "flatten_gather.cu",
                               "flatten", None, "gather"),
    # the flatten kernel lab's variants of B1 and its exp2 probe (B12-B15),
    # driven by the lab phase through the lab's entry
    "lab_passes": ("experiments/kernel_lab.py:142", "lab_flatten.cu", None, None, None),
    "lab_fused": ("experiments/kernel_lab.py:312", "lab_flatten.cu", None, None, None),
    "lab_k2": ("experiments/kernel_lab.py:544", "lab_flatten.cu", None, None, None),
    "lab_exp2_probe": ("experiments/kernel_lab.py:763", "lab_probe.cu", None, None, None),
}
# each partial entry -> the kernel whose plan and arguments it takes
PARTIAL_OF = {"paged_flatten_partial": "paged_flatten",
              "paged_flatten_q_partial": "paged_flatten_q",
              "paged_seq_partial": "paged_seq", "paged_seq_q_partial": "paged_seq_q",
              "flatten_gather_partial": "flatten_gather"}
# the sharded paths' grids, (dp, sp, tp): one H100, four ranks over gloo;
# the 16-token prompt's (B11) has dp 2
SHARDED_GRID = (1, 2, 2)
SHORT_GRID = (2, 1, 2)
# the 8B's main workload with its rows over dp (dp 2, tp 2)
DP_GRID = (2, 1, 2)
# tokens a branch of the grid runs (grid 1x2x2's main and int8 runs,
# SHORT_GRID's, DP_GRID's and the wide heads' grids): 8 decode steps, where
# the single card's paths run 63 (the grids share the script's time with
# the replay phase)
SHARDED_GEN = 9
# tokens a branch of the batch path's four requests on grid 1x2x2 (23
# decode steps; 63 on the single card, 31 before the wide heads' grids
# shared the script's time): its flatten plans are gather plans (B11) up to
# step 13 and paged (B1p on multi-tree windows) from step 14, its seq plans
# paged (B2p)
SHARDED_BATCH_GEN = 24
# tokens a branch of the workloads phase's W6 runs (node, node_chunk,
# tree_index, the unpaged modes, node over int8 KV; 16 decode steps, after
# each mode's first step is held against flatten's; 63 before: the host's
# speed varies by up to a fifth from run to run, 1072 to 1304 s for one
# script, and the full script has to stay within 1200 s)
W6_GEN = 17
# tokens a branch of the moe-int8w path's flatten and seq runs (16 decode
# steps of about 0.25 s; the other paths run 63)
MOE_INT8W_GEN = 17
# the wgmma bodies, whose C entries encode TMA tensor maps on the host per call
TMA_KERNELS = ("prefill", "ragged_prefill", "gmm", "gmm_scaled")
# the launch counter of a wrapper that counts two kernels (ops/gmm.py)
COUNT_ATTR = {"gmm_scaled": "scaled_launches"}
# Head widths whose row does not pack into 128 lanes: deft_tpu's runner
# gives such models gather plans only, so B3/B8 and the gather kernels
# B6, B7 and B11 take them (runner.packs_heads).  Each width's kernels
# are rows of their own in the kernels line, checked and timed at the
# heads of the model named: head_dim -> (model, Hq, Hkv)
WIDE_HEADS = {96: ("Phi-3-mini", 32, 32), 256: ("Gemma-7B", 16, 16)}
# the served family of each wide head width (FAMILIES)
WIDE_FAMILY = {96: "phi-3-mini", 256: "gemma-7b"}
WIDE_OF = {f"{base}_d{D}": base for D in WIDE_HEADS
           for base in ("prefill", "ragged_prefill", "flatten_gather", "seq_gather",
                        "flatten_gather_partial")}
KERNELS.update({wide: KERNELS[base] for wide, base in WIDE_OF.items()})
PARTIAL_OF.update({f"flatten_gather_partial_d{D}": f"flatten_gather_d{D}"
                   for D in WIDE_HEADS})


class Failure(Exception):
    pass


def release() -> None:
    """Free what a finished path held: the cycle collector first (a runner
    can sit in a reference cycle), then the allocator's cached blocks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-9))


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def wrappers():
    """name -> (kernel wrapper, its plain version): the wrappers carry the
    launch counters.  The wide heads' names (WIDE_OF) share their base
    kernel's wrapper and counter."""
    from deft_tpu_torch.ops import flatten_attn as fa
    from deft_tpu_torch.ops import gmm as gm
    from deft_tpu_torch.ops import int8_matmul as i8
    from deft_tpu_torch.ops import lab_flatten as lf
    from deft_tpu_torch.ops import lab_probe as lp
    from deft_tpu_torch.ops import paged_flatten_attn as pf
    from deft_tpu_torch.ops import paged_quant as pq
    from deft_tpu_torch.ops import paged_seq_attn as ps
    from deft_tpu_torch.ops import prefill as pr
    from deft_tpu_torch.ops import seq_attn as sa
    from deft_tpu_torch.ops import sharded_flatten as sf

    out = {
        "prefill": (pr.prefill_attention, pr.prefill_attention_plain),
        "paged_flatten": (pf.paged_flatten_attention, pf.paged_flatten_attention_plain),
        "paged_seq": (ps.paged_seq_attention, ps.paged_seq_attention_plain),
        "paged_flatten_q": (pq.paged_flatten_attention_q,
                            pq.paged_flatten_attention_q_plain),
        "paged_seq_q": (ps.paged_seq_attention_q, ps.paged_seq_attention_q_plain),
        "flatten_gather": (fa.flatten_attention, fa.flatten_attention_plain),
        "seq_gather": (sa.seq_attention, sa.seq_attention_plain),
        "ragged_prefill": (pr.ragged_prefill_attention, pr.ragged_prefill_attention_plain),
        "int8_matmul": (i8.int8_matmul, i8.int8_matmul_plain),
        "gmm": (gm.gmm, gm.gmm_plain),
        "gmm_scaled": (gm.gmm, gm.gmm_plain),
        "paged_flatten_partial": (pf.paged_flatten_attention_partial,
                                  pf.paged_flatten_attention_partial_plain),
        "paged_flatten_q_partial": (pq.paged_flatten_attention_q_partial,
                                    pq.paged_flatten_attention_q_partial_plain),
        "paged_seq_partial": (ps.paged_seq_attention_partial,
                              ps.paged_seq_attention_partial_plain),
        "paged_seq_q_partial": (ps.paged_seq_attention_q_partial,
                                ps.paged_seq_attention_q_partial_plain),
        "flatten_gather_partial": (sf.flatten_attention_partial,
                                   sf.flatten_attention_partial_plain),
        "lab_passes": (lf.lab_passes_attention, lf.lab_passes_attention_plain),
        "lab_fused": (lf.lab_fused_attention, lf.lab_fused_attention_plain),
        "lab_k2": (lf.lab_k2_attention, lf.lab_k2_attention_plain),
        "lab_exp2_probe": (lp.lab_exp2_probe, lp.lab_exp2_probe_plain),
    }
    return out | {wide: out[base] for wide, base in WIDE_OF.items()}


def counters() -> dict:
    """name -> wrapper of each launch counter (the base names only)."""
    return {name: fn for name, (fn, _) in wrappers().items() if name not in WIDE_OF}


def reset_counts() -> None:
    for name, fn in counters().items():
        setattr(fn, COUNT_ATTR.get(name, "launches"), 0)


def read_counts() -> dict:
    return {name: getattr(fn, COUNT_ATTR.get(name, "launches"))
            for name, fn in counters().items()}


def restore_counts(counts: dict) -> None:
    """Set every launch counter back to `counts` (read_counts' dict)."""
    for name, fn in counters().items():
        setattr(fn, COUNT_ATTR.get(name, "launches"), counts[name])


# lm_head products taken while generate_run counts them (models/llama.py
# lm_head: the decode step's and the prefill's)
LM_HEADS = [0]


# -- trees and kernel inputs ---------------------------------------------------------

def grow_tree(prompt_len: int, width: int, steps: int, slots: int, rng):
    """A Simple_Tree-shaped tree: prompt, `width` leaves, `steps` appends."""
    from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache

    tree = TreeCache(TokenKVPool(slots), ReqToTokenPool(max(64, 2 * width),
                                                        prompt_len + steps + 64))
    tree.init_prompt(list(rng.integers(4, 1000, prompt_len)))
    for i, c in enumerate(tree.branch(tree.root, width)):
        c.append_token(50 + i)
    for _ in range(steps):
        tree.alloc()
        for leaf in list(tree.leaves.values()):
            leaf.append_token(int(rng.integers(1, 400)))
    tree.alloc()
    return tree


def small_trees(rng):
    """Three small trees: the first has FULL, dead and few-leaf blocks; the
    second has leaves with 1-token runs at unaligned offsets
    (speculative-decoding accepts merged into the root), so its seq plan
    covers them with seg_off > 0; the third is the CLI's 16-token prompt at
    width 50, whose plans are not segment-aligned."""
    from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache

    a = grow_tree(700, 6, 10, 8192, rng)
    a.cut(sorted(a.leaves.values(), key=lambda x: x.id)[0])  # prune one leaf
    a.alloc()
    b = TreeCache(TokenKVPool(16384), ReqToTokenPool(64, 4096))
    b.init_prompt(list(range(300)))
    for i, c in enumerate(b.branch(b.root, 16)):
        c.append_token(50 + i)
    b.alloc()
    for _ in range(3):
        leaves = list(b.leaves.values())
        before = b.root.kv_len
        for i in range(2):
            b.merge_nodes(b.root, leaves[i], prune_b=False)
        for leaf in leaves:
            b.reset_node_KV(leaf, b.root.kv_len - before)
        b.sync_page_table()
        b.alloc()
    c = grow_tree(16, 50, 4, 8192, rng)
    return a, b, c


def to_dev(plan_arrays, dev):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in plan_arrays]


# int8 rules of runner.build_plan (deft_tpu runner.py:1227-1246)
INT8_RULES = {"flatten": dict(seg_len=(512, 256, 128), waste_limit=(1.1, 1.2, 3.0)),
              "seq": dict(seg_len=(128,), waste_limit=32.0)}


def kernel_case(name, tree, qpk, Hkv, D, dtype, dev, gen, block_len, kv=None,
                as_built=False):
    """(plan, args) of kernel `name` on this tree's plan, with random q and
    pools: of `dtype`, or int8 codes in [-127, 127] with scales in
    [0.01, 0.1) (deft_tpu tests/test_kernels.py:348-352).  Paged kernels get
    the plan the runner builds (int8 pools: the int8 segment rules).  Gather
    kernels get the tree's gather layout, or with `as_built` the plan the
    runner builds for bf16 pools, which must then not be paged; `kv` picks
    their pools."""
    import torch
    from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan

    _, _, kind, kv_kind, layout = KERNELS[name]
    kv = kv_kind or kv or "inherit"
    kw = {}
    if layout == "paged" and kv == "int8":
        kw = INT8_RULES[kind]
    elif layout == "gather" and not as_built:
        kw = {"seg_len": None} if kind == "flatten" else {"want_paged": False}
    if kind == "flatten":
        plan = build_flatten_plan(tree, q_per_kv=qpk, block_len=block_len,
                                  min_token_bucket=1024, **kw)
    else:
        plan = build_seq_plan(tree, q_per_kv=qpk, block_len=block_len,
                              min_token_bucket=1024, **kw)
    check(plan.paged == (layout == "paged"),
          f"{name}: expected a {layout} plan, got paged={plan.paged}")
    return plan, plan_args(name, plan, tree.token_to_kv_pool.size, qpk, Hkv, D, dtype,
                           dev, gen, kv)


def plan_args(name, plan, S, qpk, Hkv, D, dtype, dev, gen, kv):
    """Kernel `name`'s arguments on `plan` (kernel_case), with random q and
    pools of S slots (random_pools; `kv` "inherit" or "int8")."""
    import torch

    _, _, kind, _, layout = KERNELS[name]
    pools, scales = random_pools(kv, S, Hkv, D, dtype, dev, gen)
    q = torch.randn((plan.l_pad, qpk * Hkv, D), generator=gen, device=dev).to(dtype)
    scale = D ** -0.5
    if kind == "flatten" and layout == "paged":
        arrs = to_dev([plan.seg_src, plan.tok_lo, plan.tok_hi, plan.blk_lo,
                       plan.blk_hi], dev)
        tail = (scale, plan.block_len, plan.seg_len)
    elif kind == "flatten":
        return gather_args(plan, q, pools, scales, dev)
    elif layout == "paged":
        arrs = to_dev([plan.seg_src, plan.seg_off, plan.seg_live, plan.blk_live], dev)
        tail = (scale, plan.seg_len)
    else:
        arrs = to_dev([plan.paths, plan.seq_lens], dev)
        return (q, *pools, 0, *arrs, scale, *scales)
    if kv == "int8":
        return (q, *pools, *scales, 0, *arrs, *tail)
    return (q, *pools, 0, *arrs, *tail)


def random_pools(kv, S, Hkv, D, dtype, dev, gen):
    """(pools, scales): K and V pools (1, S, Hkv * D) of `dtype` N(0, 1), or
    int8 codes in [-127, 127] with (1, Hkv, S) scales in [0.01, 0.1)."""
    import torch

    shape = (1, S, Hkv * D)
    if kv == "int8":
        return ([torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                 for _ in range(2)],
                [torch.rand((1, Hkv, S), generator=gen, device=dev) * 0.09 + 0.01
                 for _ in range(2)])
    return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2)], \
        [None, None]


def gather_row_tiles(plan, qpk):
    """The row tiles' listed 64-token tiles that the runner hands B6 from
    the numpy plan (runtime/runner.py _step_batch), or None where the
    package has no such span input (a parent commit timed in turns with
    --flatten-only --root)."""
    from deft_tpu_torch.ops import paged_flatten_attn as pf

    count = getattr(pf, "row_tile_tiles", None)
    return None if count is None else count(plan.blk_lo, plan.blk_hi, plan.l_pad * qpk,
                                            qpk, plan.block_len)


def gather_args(plan, q, pools, scales, dev):
    """B6's arguments on a gather plan: q, the pools, layer 0, the plan
    arrays, the scale, the int8 scales, and the row tiles the runner
    counts (when the package takes them)."""
    qpk = q.shape[1] // (pools[0].shape[-1] // q.shape[-1])
    arrs = to_dev([plan.kv_idx, plan.tok_lo, plan.tok_hi, plan.blk_lo, plan.blk_hi], dev)
    tiles = gather_row_tiles(plan, qpk)
    return (q, *pools, 0, *arrs, q.shape[-1] ** -0.5, *scales) + (
        () if tiles is None else (tiles,))


def batch_trees(steps: int, rng, lens=None):
    """The batch path's four trees in one pool: prompts of `lens` tokens
    (default BATCH_LENS), WIDTH leaves each, `steps` tokens appended, every
    tree allocated before the next tokens as BatchedEngine.step does."""
    from deft_tpu_torch.core import ReqToTokenPool, TokenKVPool, TreeCache

    lens = lens or BATCH_LENS
    pool = TokenKVPool(BATCH_SLOTS)
    rtp = ReqToTokenPool(len(lens) * (WIDTH + 2), max(lens) + GEN_LEN + 64)
    trees = []
    for n in lens:
        t = TreeCache(pool, rtp)
        t.init_prompt(list(rng.integers(4, 1000, n)))
        for i, c in enumerate(t.branch(t.root, WIDTH)):
            c.append_token(50 + i)
        trees.append(t)
    for _ in range(steps):
        for t in trees:
            t.alloc()
            for leaf in list(t.leaves.values()):
                leaf.append_token(int(rng.integers(1, 400)))
    for t in trees:
        t.alloc()
    return trees


def batch_case(trees, kv, dev, gen, qpk=4, Hkv=8, D=128):
    """(plan, args) of B6 on the trees' multi-tree plan with the batch
    engine's rules for bf16 pools (runtime/batched.py build_plan: block_len
    256, min_token_bucket 1024), which must come out a gather plan; pools
    of bf16 or int8 (`kv`), bf16 q."""
    import torch
    from deft_tpu_torch.plan.multi import build_multi_flatten_plan

    plan = build_multi_flatten_plan(trees, q_per_kv=qpk, block_len=256, min_token_bucket=1024)
    check(not plan.paged, "the batch plan is paged: B6 would not run there")
    pools, scales = random_pools(kv, trees[0].token_to_kv_pool.size, Hkv, D, torch.bfloat16,
                                 dev, gen)
    q = torch.randn((plan.l_pad, qpk * Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    return plan, gather_args(plan, q, pools, scales, dev)


def b11_batch_spans(plan, grid, dev) -> None:
    """Print the spans B11's rule gives on `grid`'s rank window of the batch
    plan (parallel/engine.py host_window's row tiles, 4 KV heads) beside
    q_spans, the rule of the paged windows."""
    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.ops import paged_flatten_attn as pf
    from deft_tpu_torch.parallel.engine import host_window

    qpk, Hkv = 4, 4
    sms = _cuda.sm_count(dev.index)
    h = host_window(grid, plan.blk_lo, plan.blk_hi, plan.l_pad, plan.block_len, qpk)
    spans = pf.balanced_spans(h.row_tiles, Hkv, sms)
    qs = pf.q_spans(h.rows * qpk, Hkv, h.span, plan.block_len, sms)
    print(f"[kernels] B11 spans at rank {grid.coords} of grid {tuple(grid.shape.values())} "
          f"on the batch plan halfway ({plan.n_leaves} leaves, offsets "
          f"{list(plan.leaf_offsets)}; window rows {h.r0}..{h.r0 + h.rows}, blocks "
          f"{h.b0}..{h.b0 + h.span} of {h.B}): row tiles' 64-token tiles {h.row_tiles}, "
          f"balanced_spans {spans} (q_spans would give {qs}), {sms} SMs", flush=True)
    check(1 <= spans <= max(1, max(h.row_tiles)),
          f"B11's span rule gives {spans} spans for row tiles {h.row_tiles}")


def batch_partial_case(name, trees, dev, gen, grid):
    """The paged partial entry `name` (B1p or B2p) at `grid`'s rank window
    of the trees' multi-tree plan, built with the batch engine's rules for
    bf16 pools (runtime/batched.py build_plan: block_len 256,
    min_token_bucket 1024, seq plans asked paged), which must come out
    paged; 4 KV heads (8 over tp 2).  Returns path_shapes' (label, (plan,
    live leaves), args)."""
    import torch
    from deft_tpu_torch.plan.multi import build_multi_flatten_plan, build_multi_seq_plan

    base = PARTIAL_OF[name]
    kw = dict(q_per_kv=4, block_len=256, min_token_bucket=1024)
    plan = (build_multi_flatten_plan(trees, **kw) if KERNELS[base][2] == "flatten"
            else build_multi_seq_plan(trees, want_paged=True, **kw))
    check(plan.paged, f"{name}: the batch plan is not paged")
    args = plan_args(base, plan, trees[0].token_to_kv_pool.size, 4, 4, 128,
                     torch.bfloat16, dev, gen, "inherit")
    wargs, live = window_case(name, plan, args, grid)
    return (f"batch plan, rank {grid.rank} of grid {tuple(grid.shape.values())}",
            (plan, live), wargs)


def batch_int8_case(trees, dev, gen):
    """B4 (paged_flatten_q) on the trees' multi-tree flatten plan built with
    the batch engine's rules for int8 pools (runtime/batched.py build_plan:
    block_len 256, min_token_bucket 1024, 128-token segments at waste 3),
    which must come out paged; the 8B's heads (Hq 32, Hkv 8, D 128), int8
    pools.  Returns path_shapes' (label, plan, args)."""
    import torch
    from deft_tpu_torch.plan.multi import build_multi_flatten_plan

    plan = build_multi_flatten_plan(trees, q_per_kv=4, block_len=256, min_token_bucket=1024,
                                    seg_len=(128,), waste_limit=3.0)
    check(plan.paged, "the batch int8 plan is not paged: B4 would not run there")
    return ("batch int8 plan", plan,
            plan_args("paged_flatten_q", plan, trees[0].token_to_kv_pool.size, 4, 8, 128,
                      torch.bfloat16, dev, gen, "int8"))


def named_args(name, args) -> dict:
    """Kernel `name`'s arguments by the names of its wrapper's parameters,
    so that only the ops modules know their order."""
    return dict(inspect.signature(wrappers()[name][0]).bind(*args).arguments)


def window_case(name, plan, args, grid):
    """The partial kernel `name`'s arguments on `grid`'s rank window of the
    plan and arguments kernel_case built for PARTIAL_OF[name]: its dp rows
    of q and its sp span of blocks, cut by the engine (parallel/engine.py,
    parallel/seq_engine.py).  Returns (args, live leaves of the window)."""
    from types import SimpleNamespace

    import torch
    from deft_tpu_torch.parallel import engine, seq_engine

    kind, _, layout = KERNELS[name][2:]
    params = inspect.signature(wrappers()[name][0]).parameters
    a = {k: v for k, v in named_args(PARTIAL_OF[name], args).items() if k in params}
    R = a["q"].shape[0]
    # the plan's block arrays on the host, as the runner's batch carries them
    b = SimpleNamespace(**a, blk_host=tuple(a[n].cpu().numpy() for n in ("blk_lo", "blk_hi"))
                        if kind == "flatten" else None,
                        live_host=a["blk_live"].cpu().numpy() if kind != "flatten" else None)
    if kind == "flatten":
        # the window's row tiles, counted on the host as the engine counts
        # them for B11 (a parent commit's engine may not take qpk)
        qpk = {"qpk": a["q"].shape[1] // (a["k_pool"].shape[-1] // a["q"].shape[-1])}
        if "qpk" not in inspect.signature(engine.flatten_window).parameters:
            qpk = {}
        w = engine.flatten_window(grid, b, R, paged=layout == "paged", **qpk)
    else:
        w = seq_engine.seq_window(grid, b, R)
    a.update((k, v) for k, v in vars(w).items()
             if k in a or (k == "row_tiles" and k in params and v is not None))
    q = a["q"]  # the rank's dp window of the rows, zero rows past the last
    q = torch.cat([q, q.new_zeros((w.rows * grid.axis_size("dp") - q.shape[0],)
                                  + q.shape[1:])])
    a["q"] = q[w.r0:w.r0 + w.rows]
    return tuple(a.values()), max(0, min(w.rows, plan.n_leaves - w.r0))


def prefill_case(N, Hq, Hkv, D, dtype, dev, gen):
    import torch

    q = torch.randn((N, Hq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((N, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((N, Hkv, D), generator=gen, device=dev).to(dtype)
    return (q, k, v, D ** -0.5)


def ragged_case(lens, Hq, Hkv, D, dtype, dev, gen, pad=0):
    """B8's inputs: prompts of `lens` tokens joined, then `pad` pad tokens
    (seg -1); returns (args, live-row mask)."""
    import torch

    N = sum(lens) + pad
    q, k, v = (torch.randn((N, h, D), generator=gen, device=dev).to(dtype)
               for h in (Hq, Hkv, Hkv))
    seg = torch.full((N,), -1, dtype=torch.int32, device=dev)
    o = 0
    for i, n in enumerate(lens):
        seg[o:o + n] = i
        o += n
    return (q, k, v, seg, D ** -0.5), seg >= 0


def int8mm_case(R, H, I, dtype, dev, gen, w=None, s=None):
    """B9's inputs: x (R, H) N(0, 1), int8 codes in [-127, 127] and scales in
    [0.01, 0.1) (deft_tpu tests/test_kernels.py:651-660)."""
    import torch

    x = torch.randn((R, H), generator=gen, device=dev).to(dtype)
    if w is None:
        w = torch.randint(-127, 128, (H, I), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((I,), generator=gen, device=dev) * 0.09 + 0.01
    return (x, w, s)


def routed_rows(n, ne, dev, gen=None, top_i=None):
    """B10's grouped layout (models/llama.py moe_dispatch) of n tokens' top-2
    over ne experts: from the softmax of random router logits, or from given
    choices `top_i` (n, 2) with equal weights.  Returns (row_src, tok_pos,
    tile_eid)."""
    import torch
    from deft_tpu_torch.models.llama import moe_dispatch

    if top_i is None:
        probs = torch.softmax(torch.randn((n, ne), generator=gen, device=dev), dim=-1)
        top_p, top_i = probs.topk(2, dim=-1)
        top_w = top_p / top_p.sum(dim=-1, keepdim=True)
    else:
        top_w = torch.full(top_i.shape, 0.5, device=dev)
    row_src, tok_pos, _, tile_eid = moe_dispatch(top_i, top_w, ne)
    return row_src, tok_pos, tile_eid


def gmm_case(x, ne, E, F, dtype, scaled, dev, gen, tile_eid):
    """B10's (x, w, tile_eid, w_scale): w N(0, 1/E) in `dtype`, or int8
    codes in [-127, 127] with scales in [0.01, 0.1) (deft_tpu
    tests/test_kernels.py:651-660)."""
    import torch

    if scaled:
        w = torch.randint(-127, 128, (ne, E, F), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((ne, F), generator=gen, device=dev) * 0.09 + 0.01
        return (x, w, tile_eid, s)
    w = torch.randn((ne, E, F), generator=gen, device=dev).mul_(E ** -0.5).to(dtype)
    return (x, w, tile_eid, None)


def path_shapes(dev):
    """Kernel inputs at each path's shapes, Llama-3.1-8B heads (Hq 32, Hkv 8,
    D 128), bf16 q, block_len 256, width 50: B1/B2 (bf16 pools) and B4/B5
    (int8 pools) on the 4000-token prompt's tree halfway through its 64
    tokens; B6 (bf16 and int8 pools) on the CLI's 16-token prompt's tree
    halfway through, B7 at its fifth step, where their plans come out not
    segment-aligned, and B7 (bf16 and int8 pools) on the main tree halfway
    built as a gather seq plan (deft_tpu builds such plans on any tree
    under --kernels xla); the partial entries at rank 0's window of their grid
    (B1p, B2p, B4p, B5p on the main tree, B11 on the short one); B6 also
    on the batch path's four trees halfway (their multi-tree gather plan,
    ``batch_case``), B11 at rank 0's window of that plan on SHARDED_GRID,
    and B1p and B2p at that window of the batch plan eight steps later
    (paged multi-tree plans, ``batch_partial_case``), B4 on that whole plan
    under the batch engine's int8 rule (paged, ``batch_int8_case``);
    prefill of the 4000-token prompt; B8 over the batch
    path's four prompts; B9 at R = 64 (one width-50 tree) and 256 (the batch
    path's 200 leaves) for each of the 8B matmul weights; B10 at Mixtral's
    prefill of the 4000-token prompt (top-2 of random router logits over 8
    experts: M_pad = 9088 rows, the last tiles pad tiles), wg (E 4096, F
    14336) then wdown (E 14336, F 4096), bf16 weights (gmm) and int8 codes
    with scales (gmm_scaled).  name -> [(label, plan, args)]."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    main = grow_tree(PROMPT_LEN, WIDTH, GEN_LEN // 2, 16384, np.random.default_rng(SEED))
    bf16 = torch.bfloat16
    out = {"prefill": [("", None, prefill_case(PROMPT_LEN, 32, 8, 128, bf16, dev, gen))]}
    for name in ("paged_flatten", "paged_seq", "paged_flatten_q", "paged_seq_q"):
        out[name] = [("", *kernel_case(name, main, 4, 8, 128, bf16, dev, gen, 256))]
    # the partial entries at rank 0's window of the grid whose path runs
    # them, 4 KV heads (8 over tp 2): B1p, B2p, B4p, B5p on the main tree
    # at SHARDED_GRID (half the plan's blocks), B11 on the short tree at
    # SHORT_GRID (half the leaves, intervals shifted into the dp window)
    from deft_tpu_torch.parallel.mesh import Grid

    short = grow_tree(16, WIDTH, GEN_LEN // 2, 16384, np.random.default_rng(SEED))
    for name, base in PARTIAL_OF.items():
        if name in WIDE_OF:  # wide_shapes
            continue
        gather = KERNELS[name][4] == "gather"
        shape = SHORT_GRID if gather else SHARDED_GRID
        plan, args = kernel_case(base, short if gather else main, 4, 4, 128, bf16, dev,
                                 gen, 256, kv="inherit", as_built=gather)
        wargs, live = window_case(name, plan, args, Grid(shape, 0, dev))
        out[name] = [(f"rank 0 of grid {shape}", (plan, live), wargs)]
    seq_short = grow_tree(16, WIDTH, 4, 16384, np.random.default_rng(SEED))
    for name, tree in (("flatten_gather", short), ("seq_gather", seq_short)):
        out[name] = [(kv, *kernel_case(name, tree, 4, 8, 128, bf16, dev, gen, 256,
                                       kv=kv, as_built=True))
                     for kv in ("inherit", "int8")]
    # B7 also on the main tree halfway, its seq plan in the gather layout:
    # each leaf's 4000-token path read through its row of paths
    out["seq_gather"] += [(f"main {kv}", *kernel_case("seq_gather", main, 4, 8, 128, bf16,
                                                      dev, gen, 256, kv=kv))
                          for kv in ("inherit", "int8")]
    # B6 also at the batch path's multi-tree plan halfway (a gather plan)
    batch = batch_trees(GEN_LEN // 2, np.random.default_rng(SEED + 3))
    out["flatten_gather"] += [(f"batch {kv}", *batch_case(batch, kv, dev, gen))
                              for kv in ("inherit", "int8")]
    out["ragged_prefill"] = [("", None, ragged_case(BATCH_LENS, 32, 8, 128, bf16, dev,
                                                    gen)[0])]
    # B8 as a rank of the sharded batch path runs it: tp 2 leaves 16 query
    # and 4 KV heads (qpk 4, the single card's body)
    out["ragged_prefill"].append((f"rank heads 16/4 of grid {SHARDED_GRID}", None,
                                  ragged_case(BATCH_LENS, 16, 4, 128, bf16, dev, gen)[0]))
    # B11 at rank 0's window of the batch plan on the sharded batch path's
    # grid (sp 2 over its blocks, 4 KV heads): its very unequal row tiles
    # go through balanced_spans
    plan, args = batch_case(batch, "inherit", dev, gen, Hkv=4)
    grid0 = Grid(SHARDED_GRID, 0, dev)
    wargs, live = window_case("flatten_gather_partial", plan, args, grid0)
    out["flatten_gather_partial"].append(
        (f"batch plan, rank 0 of grid {SHARDED_GRID}", (plan, live), wargs))
    b11_batch_spans(plan, grid0, dev)
    # B1p and B2p at the same rank window of the batch plan eight steps
    # later, where its flatten plan comes out paged (the sharded batch
    # path's flatten steps run B1p at 45 of 63 steps, its seq steps B2p)
    paged = batch_trees(GEN_LEN // 2 + 8, np.random.default_rng(SEED + 3))
    for name in ("paged_flatten_partial", "paged_seq_partial"):
        out[name].append(batch_partial_case(name, paged, dev, gen, grid0))
    # B4 on the whole batch plan at that step under the engine's int8 rule,
    # which pages it: the batch path's int8 flatten steps run B4 there
    out["paged_flatten_q"].append(batch_int8_case(paged, dev, gen))
    out["int8_matmul"] = []
    for name, (H, I) in INT8_SHAPES.items():
        w = s = None
        for R in (64, 256):
            args = int8mm_case(R, H, I, bf16, dev, gen, w, s)
            w, s = args[1], args[2]
            out["int8_matmul"].append((f"R={R} {name}", None, args))
    ne, E, I = 8, 4096, 14336
    row_src, tok_pos, tile_eid = routed_rows(PROMPT_LEN, ne, dev, gen)
    M = row_src.shape[0]
    check(M == 9088 and bool((tok_pos[-128:] == PROMPT_LEN).all()),
          f"B10's path layout: {M} rows, last tile not a pad tile")
    GMM_LIVE_TILES[M] = int((tok_pos.view(-1, 128) < PROMPT_LEN).any(dim=1).sum())
    h = torch.randn((PROMPT_LEN, E), generator=gen, device=dev).to(bf16)
    xs = {"wg": (h[row_src], E, I),
          "wdown": (torch.randn((M, I), generator=gen, device=dev).to(bf16), I, E)}
    for name, scaled in (("gmm", False), ("gmm_scaled", True)):
        out[name] = [(f"{label} M={M} E={e} F={f}", None,
                      gmm_case(x, ne, e, f, bf16, scaled, dev, gen, tile_eid))
                     for label, (x, e, f) in xs.items()]
    return out


def wide_case(kind, tree, qpk, Hkv, D, kv, dev, gen):
    """(plan, args) of B6 (kind "flatten") or B7 ("seq") at a wide head
    width on `tree`, with the plan the runner builds there (block_len 256,
    int8 pools: the int8 segment rules): seq plans in the gather layout
    (runner.packs_heads), flatten plans as built, run through their kv_idx
    whether or not they are segment-aligned (runner._use_paged).  Random
    bf16 q, and pools of bf16 or int8 (`kv`), as kernel_case makes them."""
    import torch
    from deft_tpu_torch.plan import build_flatten_plan, build_seq_plan

    kw = INT8_RULES[kind] if kv == "int8" else {}
    if kind == "flatten":
        plan = build_flatten_plan(tree, q_per_kv=qpk, block_len=256, min_token_bucket=1024,
                                  **kw)
    else:
        plan = build_seq_plan(tree, q_per_kv=qpk, block_len=256, min_token_bucket=1024,
                              want_paged=False, **kw)
        check(not plan.paged, "a wide-head seq plan is paged")
    bf16 = torch.bfloat16
    pools, scales = random_pools(kv, tree.token_to_kv_pool.size, Hkv, D, bf16, dev, gen)
    q = torch.randn((plan.l_pad, qpk * Hkv, D), generator=gen, device=dev).to(bf16)
    if kind == "flatten":
        return plan, gather_args(plan, q, pools, scales, dev)
    return plan, (q, *pools, 0, *to_dev([plan.paths, plan.seq_lens], dev), D ** -0.5,
                  *scales)


def wide_shapes(dev):
    """Kernel inputs at the wide heads' path shapes (WIDE_HEADS: Phi-3-mini
    Hq 32, Hkv 32, D 96; Gemma-7B Hq 16, Hkv 16, D 256), bf16 q, width
    50: B3 on the 4000-token prompt; B8 over the batch path's prompts; B6
    on the 4000-token prompt's tree halfway (segment-aligned, run through
    kv_idx at these widths: the families phase's served shape, first) and
    on the CLI's 16-token prompt's tree halfway (a gather plan); B7 on the
    main tree halfway and at the short tree's fifth step (gather seq plans,
    the only ones at these widths); B11 at rank 0's window of SHORT_GRID on
    the short tree (tp 2: half the KV heads); each over bf16 pools, then
    int8; B6 also at the batch path's four trees halfway (their multi-tree
    gather plan, bf16 pools).  name -> [(label, plan, args)], as
    path_shapes."""
    import torch
    from deft_tpu_torch.parallel.mesh import Grid

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    bf16 = torch.bfloat16
    main = grow_tree(PROMPT_LEN, WIDTH, GEN_LEN // 2, 16384, np.random.default_rng(SEED))
    short = grow_tree(16, WIDTH, GEN_LEN // 2, 16384, np.random.default_rng(SEED))
    seq_short = grow_tree(16, WIDTH, 4, 16384, np.random.default_rng(SEED))
    batch = batch_trees(GEN_LEN // 2, np.random.default_rng(SEED + 3))
    out = {}
    for D, (model, Hq, Hkv) in WIDE_HEADS.items():
        qpk = Hq // Hkv
        out[f"prefill_d{D}"] = [(model, None, prefill_case(PROMPT_LEN, Hq, Hkv, D, bf16,
                                                           dev, gen))]
        out[f"ragged_prefill_d{D}"] = [(model, None, ragged_case(BATCH_LENS, Hq, Hkv, D,
                                                                 bf16, dev, gen)[0])]
        # the main tree first: the served path's shape, the kernels line's
        for name, kind, trees in ((f"flatten_gather_d{D}", "flatten",
                                   (("main", main), ("short", short))),
                                  (f"seq_gather_d{D}", "seq",
                                   (("main", main), ("short", seq_short)))):
            out[name] = [(f"{model} {label} {kv}", *wide_case(kind, tree, qpk, Hkv, D, kv,
                                                             dev, gen))
                         for label, tree in trees for kv in ("inherit", "int8")]
        # B6 also at the batch path's multi-tree plan halfway, as the
        # families phase's batched flatten run serves it
        out[f"flatten_gather_d{D}"].append((f"{model} batch inherit",
                                            *batch_case(batch, "inherit", dev, gen, qpk,
                                                        Hkv, D)))
        out[f"flatten_gather_partial_d{D}"] = []
        for kv in ("inherit", "int8"):
            plan, args = wide_case("flatten", short, qpk, Hkv // 2, D, kv, dev, gen)
            wargs, live = window_case(f"flatten_gather_partial_d{D}", plan, args,
                                      Grid(SHORT_GRID, 0, dev))
            out[f"flatten_gather_partial_d{D}"].append(
                (f"{model} rank 0 of grid {SHORT_GRID}{' int8' if kv == 'int8' else ''}",
                 (plan, live), wargs))
    return out


# -- phases -----------------------------------------------------------------------

def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    print(f"[card] nvidia-smi: {smi[0]}; torch: {name}; "
          f"devices: {torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return smi[0], name


@functools.lru_cache(maxsize=None)
def sass_of(name: str) -> str:
    """cuobjdump's SASS of the library of csrc/<name>.cu, dumped once."""
    from pathlib import Path

    from deft_tpu_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "--dump-sass", str(_cuda.library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def sass_count(name: str, opcode: str, function: str = "") -> int:
    """How many `opcode` instructions the library of csrc/<name>.cu holds,
    from cuobjdump's SASS; with `function`, only in the kernels whose
    mangled names contain it."""
    sass = sass_of(name)
    bodies = sass.split("Function : ")
    return sum(b.count(opcode) for b in bodies[1:] if function in b.split("\n", 1)[0]) \
        if function else sass.count(opcode)


# the tensor-core bodies over bf16 q of the decode kernels and of B3/B8 at
# the wide heads: label -> (library, the mangled-name fragment of its
# kernels, the SASS opcode it must hold: HMMA for mma.sync, HGMMA for wgmma)
MMA_BODIES = {"B2/B2p (deft_seq_q, bf16 KV)": ("paged_seq", "seq_q_mmaI13__nv_bfloat16",
                                                "HMMA"),
              "B5/B5p (deft_seq_q, int8 KV)": ("paged_seq", "seq_q_mmaIa", "HMMA"),
              "B1/B1p (deft_flat_q, bf16 KV)": ("paged_flatten",
                                                "flatten_q_mmaI13__nv_bfloat16", "HGMMA"),
              "B4/B4p (deft_flat_q, int8 KV)": ("paged_flatten", "flatten_q_mmaIa", "HMMA"),
              "B6/B11 (deft_flat_q, bf16 KV)": ("flatten_gather",
                                                "flatten_q_mmaI13__nv_bfloat16", "HGMMA"),
              "B6/B11 (deft_flat_q, int8 KV)": ("flatten_gather", "flatten_q_mmaIa", "HMMA"),
              "B7 (deft_seq_q, bf16 KV)": ("seq_gather", "seq_q_mmaI13__nv_bfloat16", "HMMA"),
              "B7 (deft_seq_q, int8 KV)": ("seq_gather", "seq_q_mmaIa", "HMMA"),
              # the wide heads (D 96, 256): B3/B8 on the wgmma body, B7 on
              # seq_q_wide (path tokens on M), B6/B11 on deft_flat_q (wgmma
              # over bf16 pools, mma.sync over int8)
              "B3/B8 at D 96 (wgmma, bf16)": ("prefill", "prefill_wgmmaILi96E", "HGMMA"),
              "B3/B8 at D 256 (wgmma, bf16)": ("prefill", "prefill_wgmmaILi256E", "HGMMA"),
              "B7 at D 96 and 256 (seq_q_wide, bf16 KV)": (
                  "seq_gather", "seq_q_wideI13__nv_bfloat16", "HMMA"),
              "B7 at D 96 and 256 (seq_q_wide, int8 KV)": ("seq_gather", "seq_q_wideIa",
                                                           "HMMA"),
              # the kernel lab's variants of B1 (mma.sync)
              "B12 (lab_passes)": ("lab_flatten", "lab_passes_kernel", "HMMA"),
              "B13 (lab_fused)": ("lab_flatten", "lab_fused_kernel", "HMMA"),
              "B14 (lab_k2)": ("lab_flatten", "lab_k2_kernel", "HMMA")}
# the wide heads' bodies whose registers and spills phase_build prints and
# which must not spill
WIDE_BODIES = {"B3/B8 D 96": ("prefill", "prefill_wgmmaILi96E"),
               "B3/B8 D 256": ("prefill", "prefill_wgmmaILi256E"),
               "B7": ("seq_gather", "seq_q_wide")}
MMA_BODIES.update({f"B6/B11 at D {D} (deft_flat_q, {kv} KV)": (
    "flatten_gather", f"flatten_q_mmaI{code}Li{D}E", op) for D in (96, 256)
    for kv, code, op in (("bf16", "13__nv_bfloat16", "HGMMA"), ("int8", "a", "HMMA"))})
WIDE_BODIES.update({label: body[:2] for label, body in MMA_BODIES.items()
                    if label.startswith("B6/B11 at D")})
# the fp32-q split-KV body (flatten_body.cuh), which over bf16 q no flatten
# library may instantiate any more
STAGED_BF16 = "flatten_partial_kernelI13__nv_bfloat16"


def spill_bytes(line: str) -> int:
    """The spill store and load bytes on one of ptxas -v's lines."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))


def ptxas_lines(name: str, function: str) -> list:
    """ptxas -v's register and spill lines of the kernels of csrc/<name>.cu
    whose mangled names contain ``function``, each behind its kernel's
    name."""
    from deft_tpu_torch.ops import _cuda

    out, current = [], None
    for line in _cuda.build_log.get(name, "").splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line
        elif current and function in current and ("registers" in line or "spill" in line):
            out.append(f"{current}: {line.strip()}")
    return out


def phase_build(bodies: bool = True):
    """Build every kernel and count their tensor-core instructions; with
    `bodies`, fail unless each tensor-core body holds its opcode (off for a
    parent commit's package, --root, whose bodies differ)."""
    from deft_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"[build] {len(_cuda.SOURCES)} kernel sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in sorted(_cuda.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
        for line in log.splitlines():  # ptxas serialising wgmma costs speed
            if "wgmma" in line:
                print(f"[build] {name}: {line.strip()}")
    # the bf16 bodies of B3/B8 (every width), B10, B9, B1 and B6 run on
    # wgmma (HGMMA in their SASS), B2's, B4's, B5's and B7's over bf16 q on
    # mma.sync (HMMA)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_cuda.SOURCES)) as pool:  # one cuobjdump a library
        list(pool.map(sass_of, _cuda.SOURCES))
    hgmma = {name: sass_count(name, "HGMMA") for name in _cuda.SOURCES}
    hmma = {name: sass_count(name, "HMMA") for name in _cuda.SOURCES}
    print(f"[build] SASS of the {len(_cuda.SOURCES)} libraries dumped in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[build] HGMMA instructions by library: {hgmma}", flush=True)
    print(f"[build] HMMA instructions by library: {hmma}", flush=True)
    if not bodies:
        return
    for name in ("gmm", "prefill", "int8_matmul", "paged_flatten", "flatten_gather"):
        check(hgmma[name] > 0, f"the {name} library holds no HGMMA instruction")
    for name in ("paged_seq", "seq_gather"):
        check(hmma[name] > 0, f"the {name} library holds no HMMA instruction")
    bodies = {label: (op, sass_count(lib, op, fn))
              for label, (lib, fn, op) in MMA_BODIES.items()}
    print(f"[build] tensor-core instructions by body: {bodies}", flush=True)
    for label, (op, n) in bodies.items():
        check(n > 0, f"the body of {label} holds no {op} instruction")
    for label in ("B1/B1p (deft_flat_q, bf16 KV)", "B6/B11 (deft_flat_q, bf16 KV)",
                  "B12 (lab_passes)", "B13 (lab_fused)", "B14 (lab_k2)"):
        for line in ptxas_lines(*MMA_BODIES[label][:2]):
            print(f"[build] {label.split()[0]} body: {line}", flush=True)
    # B15 times the instruction the flatten bodies' exp2f becomes
    ex2 = {name: sass_count(name, "MUFU.EX2") for name in ("lab_probe", "paged_flatten")}
    print(f"[build] MUFU.EX2 instructions (exp2f under ops/_cuda.py's flags): {ex2}; "
          f"B15: {ptxas_lines('lab_probe', 'lab_probe_kernel')}", flush=True)
    check(all(ex2.values()), f"exp2f did not become MUFU.EX2: {ex2}")
    for label, (lib, fn) in WIDE_BODIES.items():
        lines = ptxas_lines(lib, fn)
        for line in lines:
            print(f"[build] {label} wide-head body: {line}", flush=True)
        check(any("spill" in line for line in lines),
              f"no ptxas spill line for the {label} body")
        check(not any(spill_bytes(line) for line in lines),
              f"the {label} body spills registers")
    for name in ("paged_flatten", "flatten_gather"):
        check(not sass_count(name, "EXIT", STAGED_BF16),
              f"{name} instantiates flatten_body.cuh's staged body over bf16 q")


def phase_kernels(dev, shapes):
    """Kernel vs plain at each path's shapes and on the small fp32 trees.
    Returns {kernel: max_abs_err at its path's shapes}."""
    import torch

    fns = wrappers()

    def live(plan):
        return slice(0, plan.n_leaves) if plan is not None else slice(None)

    def compare(name, label, args, tol, rows=slice(None)):
        fn, plain = fns[name]
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        e = rel_err(got[rows], want[rows])
        print(f"[kernels] {name} {label}: rel err {e:.3e}, tol {tol:.0e}", flush=True)
        check(e < tol and bool(torch.isfinite(got[rows]).all()),
              f"{name} {label} disagrees with its plain version: {e}")
        if isinstance(rows, torch.Tensor):  # B8's pad rows give 0
            check(not bool(got[~rows].any()), f"{name} {label}: pad rows are not 0")
        return float((got[rows].double() - want[rows].double()).abs().max())

    def compare_state(name, label, args, tol, leaves):
        """A partial entry against its plain version: acc and l on the live
        leaves' rows, m where the row saw a token (dead rows' m is the
        kernels' finite floor), every output finite."""
        fn, plain = fns[name]
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        q, D = args[0], args[0].shape[-1]
        if KERNELS[name][2] == "flatten":  # folded (Hkv, R*qpk) rows
            rows = (slice(None), slice(0, leaves * q.shape[1] // (args[1].shape[-1] // D)))
        else:
            rows = (slice(0, leaves),)
        seen = want[2][rows] > 0
        pairs = [(got[0][rows], want[0][rows]), (got[2][rows], want[2][rows]),
                 (got[1][rows][seen], want[1][rows][seen])]
        e = max(rel_err(g, w) for g, w in pairs if w.numel())
        print(f"[kernels] {name} {label}: rel err (acc, l, m) {e:.3e}, tol {tol:.0e}",
              flush=True)
        check(e < tol and all(bool(torch.isfinite(t).all()) for t in got),
              f"{name} {label} disagrees with its plain version: {e}")
        return max(float((g.double() - w.double()).abs().max()) for g, w in pairs
                   if w.numel())

    errs = {}
    for name, cases in shapes.items():
        for label, plan, args in cases:
            if name in PARTIAL_OF:
                e = compare_state(name, f"bf16 path shapes {label}", args,
                                  TOL["bfloat16"], plan[1])
            else:
                e = compare(name, f"bf16 path shapes {label}", args, TOL["bfloat16"],
                            live(plan))
            errs[name] = max(errs.get(name, 0.0), e)
    phase_merge(dev, shapes)

    # small fp32 trees with every plan feature, both head dims
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    a, b, c = small_trees(np.random.default_rng(SEED + 1))
    f32 = torch.float32
    for D in (64, 128):
        for block_len in (128, 256):
            for tree, label in ((a, "FULL/dead/few-leaf tree"), (b, "unaligned tree")):
                for name in ("paged_flatten", "paged_flatten_q", "flatten_gather"):
                    for kv in (("inherit", "int8") if name == "flatten_gather"
                               else (None,)):
                        plan, args = kernel_case(name, tree, 4, 2, D, f32, dev, gen,
                                                 block_len, kv=kv)
                        if tree is a and block_len == 128:
                            full = plan.blk_lo < -(1 << 20)
                            dead = (plan.blk_lo >= plan.blk_hi) & ~full
                            narrow = ~full & ~dead & (plan.blk_hi - plan.blk_lo
                                                      < plan.n_leaves)
                            # the gather layout packs the short leaf suffixes
                            # into the prompt's last block: no few-leaf block
                            check(full.any() and dead.any() and (
                                narrow.any() or KERNELS[name][4] == "gather"),
                                  f"{name}: small plan lacks FULL, dead or "
                                  "few-leaf blocks")
                        compare(name, f"fp32 {kv or ''} D={D} block {block_len} "
                                f"{label}", args, TOL["float32"], live(plan))
                for name in ("paged_seq", "paged_seq_q", "seq_gather"):
                    for kv in (("inherit", "int8") if name == "seq_gather"
                               else (None,)):
                        plan, args = kernel_case(name, tree, 4, 2, D, f32, dev, gen,
                                                 block_len, kv=kv)
                        if tree is b and KERNELS[name][4] == "paged":
                            check(bool(plan.seg_off.any()),
                                  f"{name}: plan has no unaligned segment")
                        compare(name, f"fp32 {kv or ''} D={D} block {block_len} "
                                f"{label}", args, TOL["float32"], live(plan))
            # the short prompt's plans as the runner builds them: not paged
            for name in ("flatten_gather", "seq_gather"):
                for kv in ("inherit", "int8"):
                    plan, args = kernel_case(name, c, 4, 2, D, f32, dev, gen,
                                             block_len, kv=kv, as_built=True)
                    compare(name, f"fp32 {kv} D={D} block {block_len} short-prompt "
                            "plan", args, TOL["float32"], live(plan))
        for N in (300, 1000):
            args = prefill_case(N, 8, 2, D, f32, dev, gen)
            compare("prefill", f"fp32 D={D} N={N}", args, TOL["float32"])
        # B8: ragged lengths off the 64-token tiles, a padded tail, long
        # prompts (mask-free interior tiles), GQA and plain multi-head
        for Hq, Hkv in ((8, 2), (2, 2)):
            for lens, pad in (((60, 83, 100), 13), ((500, 300, 200), 24)):
                args, rows = ragged_case(lens, Hq, Hkv, D, f32, dev, gen, pad)
                compare("ragged_prefill", f"fp32 D={D} qpk {Hq // Hkv} lens {lens} "
                        f"pad {pad}", args, TOL["float32"], rows)
    # the partial entries on every rank's window of a (dp 2, sp 3) grid:
    # leaf intervals shifted into each dp window, blocks outside it, pad
    # blocks in the last sp span, FULL and dead blocks, int8 pools
    from deft_tpu_torch.parallel.mesh import Grid

    windows = [Grid((2, 3, 1), r, dev) for r in range(6)]
    for D in (64, 128):
        for block_len in (128, 256):
            for tree, label in ((a, "FULL/dead/few-leaf tree"), (b, "unaligned tree")):
                for name, base in PARTIAL_OF.items():
                    if name in WIDE_OF:  # wide_edges
                        continue
                    for kv in (("inherit", "int8") if base == "flatten_gather" else (None,)):
                        plan, args = kernel_case(base, tree, 4, 2, D, f32, dev, gen,
                                                 block_len, kv=kv)
                        for grid in windows:
                            wargs, leaves = window_case(name, plan, args, grid)
                            compare_state(name, f"fp32 {kv or ''} D={D} block {block_len} "
                                          f"{label}, rank {grid.coords}", wargs,
                                          TOL["float32"], leaves)
    # B9: R = 8, H not a multiple of 512, split and unsplit H, every row tile
    for R, H, I in ((8, 384, 256), (24, 4096, 4096), (64, 640, 384),
                    (16, 256, 128 * 264), (256, 512, 1536)):
        for dt in (f32, torch.bfloat16):
            compare("int8_matmul", f"{'fp32' if dt == f32 else 'bf16'} R={R} H={H} I={I}",
                    int8mm_case(R, H, I, dt, dev, gen),
                    TOL["float32" if dt == f32 else "bfloat16"])
    # B10: NE = 4 with expert 2 empty; 300 tokens x top-2 fill three groups,
    # and the static M_pad leaves pad tiles past the last group
    rng = np.random.default_rng(SEED + 1)
    top_i = torch.from_numpy(np.stack([rng.choice([0, 1, 3], size=2, replace=False)
                                       for _ in range(300)])).to(dev)
    _, tok_pos, tile_eid = routed_rows(300, 4, dev, top_i=top_i)
    eids = tile_eid.tolist()
    check(2 not in eids and eids[-1] == 3 and bool((tok_pos[-128:] == 300).all()),
          f"the small B10 case lacks an empty group or pad tiles: {eids}")
    for E, F in ((128, 256), (384, 640)):
        x = torch.randn((len(eids) * 128, E), generator=gen, device=dev)
        for name, scaled in (("gmm", False), ("gmm_scaled", True)):
            compare(name, f"fp32 NE=4 E={E} F={F} tiles {eids}",
                    gmm_case(x, 4, E, F, f32, scaled, dev, gen, tile_eid), TOL["float32"])
    wgmma_edges(dev, gen, compare)
    b9_edges(dev, gen)
    seq_edges(dev, gen, int8=True)  # B5, B5p
    seq_edges(dev, gen, int8=False)  # B2, B2p
    b7_edges(dev, gen)
    b4_edges(dev, gen)
    b1_edges(dev, gen, shapes)
    b6_edges(dev, gen, shapes)
    wide_edges(dev, gen)
    for name, e in wide_batch_seq(dev, gen).items():
        errs[name] = max(errs[name], e)
    return errs


@contextlib.contextmanager
def forced(module, name, value):
    """Within the block, ``module.name`` (a wrapper's launch choice, looked
    up at call time) returns ``value``: the edge cases force each split."""
    old = getattr(module, name)
    setattr(module, name, lambda *a, **k: value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def forced_spans(value):
    """Within the block, the bf16 flatten bodies take `value` spans under
    either span rule (q_spans; balanced_spans where B6 is given its row
    tiles)."""
    from deft_tpu_torch.ops import paged_flatten_attn as pf

    with forced(pf, "q_spans", value), forced(pf, "balanced_spans", value):
        yield


def flat_q_grid(name, args, sms):
    """The grid deft_flat_q takes for flatten kernel `name` on `args` over
    bf16 q: (the listed 64-token tiles of each row tile, the rows of a row
    tile, Hkv, spans by the wrapper's rule, q_spans' count)."""
    from deft_tpu_torch.ops import paged_flatten_attn as pf

    a = named_args(name, args)
    R, Hq, D = a["q"].shape
    Hkv = a["k_pool"].shape[-1] // D
    rq, nb, block_len = R * Hq // Hkv, a["blk_lo"].shape[0], plan_block_len(a)
    tiles = pf.row_tile_tiles(a["blk_lo"].cpu().numpy(), a["blk_hi"].cpu().numpy(), rq,
                              Hq // Hkv, block_len)
    qs = pf.q_spans(rq, Hkv, nb, block_len, sms)
    spans = qs if a.get("row_tiles") is None else pf.balanced_spans(a["row_tiles"], Hkv, sms)
    return tiles, pf.q_block_rows(rq), Hkv, spans, qs


def rel_err_control(name, label, got, want_fault, tol):
    """A fault control: the kernel's output against its plain version on
    faulted inputs must read above the tolerance the kernel is held to."""
    e = rel_err(got, want_fault)
    print(f"[kernels] {name} {label}: the kernel against the faulted plain version "
          f"{e:.3e}, tol {tol:.0e}", flush=True)
    check(e > tol, f"{name}: the {label} control reads under the tolerance ({e})")


def b9_edges(dev, gen):
    """B9's bf16 (wgmma, H split over a cluster) and fp32 (FMA) bodies
    against the plain version: R = 8, 64, 72 and 256 at every 8B matmul
    weight and Mixtral's lm_head; a ragged last split (H = 1408: 22 chunks
    of 64 over 8 splits of 3); every cluster size 1 .. 8 at I = 4096.
    Controls through the plain version on the same inputs: one 64-row
    H-chunk of one column tile left out (H = 256, so each of the 4 splits
    owns one chunk), and one column's scale taken from its neighbour."""
    import torch
    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.ops import int8_matmul as i8

    kern, plain = wrappers()["int8_matmul"]

    def run(label, args, tol, splits=None):
        if splits is None:
            got = kern(*args)
        else:
            with forced(i8, "launch_splits", splits):
                got = kern(*args)
        torch.cuda.synchronize()
        e = rel_err(got, plain(*args))
        print(f"[kernels] int8_matmul {label}: rel err {e:.3e}, tol {tol:.0e}", flush=True)
        check(e < tol and bool(torch.isfinite(got).all()),
              f"int8_matmul {label} disagrees with its plain version: {e}")
        return got

    shapes = dict(INT8_SHAPES, mixtral_lm_head=(4096, 32000))
    for name, (H, I) in shapes.items():
        w = s = None
        for R in (8, 64, 72, 256):
            for dt in (torch.bfloat16, torch.float32):
                args = int8mm_case(R, H, I, dt, dev, gen, w, s)
                w, s = args[1], args[2]
                sp = i8.launch_splits(dev.index, R, H, I, dt)
                run(f"{str(dt)[6:]} R={R} {name} (H, I) = ({H}, {I}), {sp} splits", args,
                    TOL[str(dt)[6:]])
        del w, s
        release()
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    args = int8mm_case(64, 1408, 4096, bf16, dev, gen)
    sp, per = i8.split_plan(64, 1408, 4096, _cuda.sm_count(dev.index))
    ranges = i8.split_ranges(1408, sp, per)
    check(ranges[-1][1] - ranges[-1][0] < per, f"H = 1408 gives no ragged split: {ranges}")
    run(f"bf16 R=64 (H, I) = (1408, 4096), splits {ranges}", args, tol, sp)
    for R in (64, 256):
        args = int8mm_case(R, 4096, 4096, bf16, dev, gen)
        for sp in range(1, 9):
            run(f"bf16 R={R} (H, I) = (4096, 4096), cluster of {sp}", args, tol, sp)
    x, w, s = int8mm_case(64, 256, 4096, bf16, dev, gen)
    check(i8.launch_splits(dev.index, 64, 256, 4096, bf16) == 4,
          "H = 256 at I = 4096 does not split 4 ways")
    got = run("bf16 R=64 (H, I) = (256, 4096), 4 splits of one chunk", (x, w, s), tol)
    wf = w.clone()
    wf[64:128, 256:512] = 0
    rel_err_control("int8_matmul", "H-chunk 1 of column tile 1 left out", got,
                    plain(x, wf, s), tol)
    want = plain(x, w, s).float()
    nb = torch.arange(s.numel(), device=dev) ^ 1
    j = int((want.abs().amax(0) * (s[nb] / s - 1).abs()).argmax())
    sf = s.clone()
    sf[j] = s[j ^ 1]
    rel_err_control("int8_matmul", f"column {j} scaled by column {j ^ 1}'s scale", got,
                    plain(x, w, sf), tol)


def synthetic_seq_plan(rng, R, nb, spb, seg_len, S, one_token_leaf=0):
    """Per-leaf segment tables (seg_src, seg_off, seg_live, blk_live) as
    int32 numpy: random live spans (some segments empty, path lengths off
    the 16-token tile, spans straddling tiles), one dead block a leaf where
    nb > 1, and leaf ``one_token_leaf`` holding one token."""
    nseg = nb * spb
    src = rng.integers(0, S // seg_len, (R, nseg)) * seg_len
    off = rng.integers(0, seg_len, (R, nseg))
    live = np.minimum(rng.integers(0, seg_len + 1, (R, nseg)), seg_len - off)
    live[rng.random((R, nseg)) < 0.2] = 0
    blk = np.ones((R, nb), np.int32)
    if nb > 1:
        blk[np.arange(R), rng.integers(0, nb, R)] = 0
    live[one_token_leaf] = 0
    blk[one_token_leaf] = 1
    live[one_token_leaf, spb - 1] = 1
    for r in range(R):  # every other leaf sees at least one token
        if r != one_token_leaf and not (live[r] * np.repeat(blk[r], spb)).any():
            j = int(np.nonzero(np.repeat(blk[r], spb))[0][0])
            off[r, j], live[r, j] = 0, 17
    return [a.astype(np.int32).reshape(-1) for a in (src, off, live, blk)]


def seq_edges(dev, gen, int8):
    """B5 and B5p (int8 pools), or B2 and B2p (bf16 / fp32 pools), against
    their plain versions on synthetic per-leaf tables: dead blocks,
    segments straddling the 16-token tiles, path lengths off the tile and a
    leaf of one token; qpk 1, 4, 7 (Qwen2.5-7B) and 8; D 64 and 128; bf16 q (the
    tensor-core body) with the path split over 1, 3 and 8 blocks of a
    cluster, fp32 q (the FMA body) unsplit.  Control: a 17-token path
    against the plain version with its last token hidden."""
    import torch
    from deft_tpu_torch.ops import paged_seq_attn as ps

    fns = wrappers()
    name = "paged_seq_q" if int8 else "paged_seq"
    rng = np.random.default_rng(SEED + (3 if int8 else 5))
    S, seg_len, nb, spb, Hkv, R = 4096, 128, 3, 2, 2, 6

    def tensors(tables, rows, Hq, D, dt):
        if int8:
            pools = [torch.randint(-127, 128, (1, S, Hkv * D), generator=gen, device=dev,
                                   dtype=torch.int8) for _ in range(2)]
            pools += [torch.rand((1, Hkv, S), generator=gen, device=dev) * 0.09 + 0.01
                      for _ in range(2)]
        else:
            pools = [torch.randn((1, S, Hkv * D), generator=gen, device=dev).to(dt)
                     for _ in range(2)]
        q = torch.randn((rows, Hq, D), generator=gen, device=dev).to(dt)
        return [q, *pools, 0, *to_dev(tables, dev)]

    for D in (64, 128):
        for qpk in (1, 4, 7, 8):
            tables = synthetic_seq_plan(rng, R, nb, spb, seg_len, S, one_token_leaf=2)
            lens = (tables[2].reshape(R, -1)
                    * np.repeat(tables[3].reshape(R, nb), spb, axis=1)).sum(1)
            for dt in (torch.bfloat16, torch.float32):
                dname = str(dt)[6:]
                tol = TOL[dname]
                args = tensors(tables, R, qpk * Hkv, D, dt) + [D ** -0.5, seg_len]
                for sp in ((1, 3, 8) if dt == torch.bfloat16 else (1,)):
                    label = f"{dname} D={D} qpk {qpk} path lengths {lens.tolist()}, splits {sp}"
                    with forced(ps, "seq_splits", sp):
                        got = fns[name][0](*args)
                        got_p = fns[f"{name}_partial"][0](*args)
                    torch.cuda.synchronize()
                    e = rel_err(got, fns[name][1](*args))
                    print(f"[kernels] {name} {label}: rel err {e:.3e}, tol {tol:.0e}",
                          flush=True)
                    check(e < tol and bool(torch.isfinite(got).all()),
                          f"{name} {label} disagrees with its plain version: {e}")
                    got = got_p
                    want = fns[f"{name}_partial"][1](*args)
                    e = max(rel_err(got[i], want[i]) for i in range(3))
                    print(f"[kernels] {name}_partial {label}: rel err (acc, m, l) "
                          f"{e:.3e}, tol {tol:.0e}", flush=True)
                    check(e < tol and all(bool(torch.isfinite(t).all()) for t in got),
                          f"{name}_partial {label} disagrees with its plain version: {e}")
    # the control: two leaves of one block of two segments; leaf 0's path
    # is 10 + 7 = 17 tokens, its queries small so that each token weighs
    # about a seventeenth
    src = np.array([0, 128, 256, 384], np.int32)
    off = np.array([100, 0, 5, 0], np.int32)
    live = np.array([10, 7, 20, 0], np.int32)
    args = tensors([src, off, live, np.ones(2, np.int32)], 2, 4 * Hkv, 128,
                   torch.bfloat16) + [128 ** -0.5, seg_len]
    args[0][0] *= 0.05
    named = named_args(name, args)
    got = fns[name][0](*args)
    hidden = live.copy()
    hidden[1] -= 1
    named["seg_live"] = torch.from_numpy(hidden).to(dev)
    rel_err_control(name, "17-token path with its last token hidden", got[:1],
                    fns[name][1](**named)[:1], TOL["bfloat16"])


def synthetic_gather_paths(rng, lens, C, S):
    """A gather seq plan's (paths (R, C), seq_lens (R,)) as int32 numpy:
    leaf r's path is lens[r] distinct pool rows in [1, S), scattered over
    the pool; the pads past it at DUMP_SLOT (row 0)."""
    paths = np.zeros((len(lens), C), np.int32)
    for r, n in enumerate(lens):
        paths[r, :n] = rng.choice(np.arange(1, S), n, replace=False)
    return paths, np.asarray(lens, np.int32)


def b7_split_tokens(length, splits, split):
    """The path tokens block `split` of `splits` takes in deft_seq_q: its
    share of the path's 16-token tiles."""
    tiles = -(-length // 16)
    return np.arange(16 * (tiles * split // splits),
                     min(16 * (tiles * (split + 1) // splits), length))


def b7_edges(dev, gen, widths=(64, 128), qpks=(1, 4, 7, 8)):
    """B7 over bf16 q (deft_seq_q with the path table as its path source;
    seq_q_wide at D 96 and 256) against its plain version beyond the path
    shapes, bf16, tolerance 2e-2, every row (padded leaves give 0 in both)
    and every output finite: synthetic gather plans with path lengths off
    the 16-token tile, a one-token leaf, a seq_len 0 leaf between live ones
    (its rows must be exactly 0) and a path as long as the padded width;
    qpk `qpks` (1, 4, 7 and 8); D `widths` (64 and 128); bf16 and int8
    pools; each path split over 1, 3 and 8 blocks of a cluster.  The pool
    rows at DUMP_SLOT (and for int8 their scales) hold NaN in the kernel's
    pools, so a pad read would show as a non-finite output; the plain
    version reads the same pools with row 0 finite.  Controls through the
    plain version, at the last width: leaf 0's and leaf 1's last path
    entries swapped between the leaves (17-token paths); leaf 0's last
    token hidden; the share of a 150-token path that the middle of three
    blocks takes left out."""
    import torch
    from deft_tpu_torch.ops import paged_seq_attn as ps

    kern, plain = wrappers()["seq_gather"]
    tol = TOL["bfloat16"]
    rng = np.random.default_rng(SEED + 11)
    S, C, Hkv = 4096, 192, 2
    bf16 = torch.bfloat16

    def case(lens, qpk, D, kv):
        """(kernel args with DUMP_SLOT poisoned, plain args)."""
        paths, seq_lens = synthetic_gather_paths(rng, lens, C, S)
        pools, scales = random_pools(kv, S, Hkv, D, bf16, dev, gen)
        q = torch.randn((len(lens), qpk * Hkv, D), generator=gen, device=dev).to(bf16)
        arrs = to_dev([paths, seq_lens], dev)
        clean = (q, *pools, 0, *arrs, D ** -0.5, *scales)
        if kv == "int8":
            scales = [x.clone().index_fill_(2, torch.tensor([0], device=dev), float("nan"))
                      for x in scales]
        else:
            pools = [x.clone().index_fill_(1, torch.tensor([0], device=dev), float("nan"))
                     for x in pools]
        return (q, *pools, 0, *arrs, D ** -0.5, *scales), clean

    lens = [37, 1, 0, C, 16, 100, 150, 0]
    for kv in ("inherit", "int8"):
        for D in widths:
            for qpk in qpks:
                args, clean = case(lens, qpk, D, kv)
                want = plain(*clean)
                for sp in (1, 3, 8):
                    with forced(ps, "seq_splits", sp):
                        got = kern(*args)
                    torch.cuda.synchronize()
                    e = rel_err(got, want)
                    label = f"{kv} D={D} qpk {qpk} path lengths {lens}, splits {sp}"
                    print(f"[b7] seq_gather {label}: rel err {e:.3e}, tol {tol:.0e}",
                          flush=True)
                    check(e < tol and bool(torch.isfinite(got).all()),
                          f"seq_gather {label} disagrees with its plain version (or read a "
                          f"pad row): {e}")
                    check(not bool(got[[2, 7]].any()),
                          f"seq_gather {label}: a seq_len 0 leaf is not 0")
    # controls: 17-token paths, queries small so each token weighs about a
    # seventeenth
    args, clean = case([17, 17, 150], 4, widths[-1], "inherit")
    args[0][:2] *= 0.05  # q, shared by both
    named = named_args("seq_gather", clean)
    got = kern(*args)
    swapped = named["paths"].clone()
    swapped[0, 16], swapped[1, 16] = named["paths"][1, 16], named["paths"][0, 16]
    rel_err_control("seq_gather", "17-token paths, leaf 0's and leaf 1's last entries "
                    "swapped", got[:2], plain(**dict(named, paths=swapped))[:2], tol)
    hidden = named["seq_lens"].clone()
    hidden[0] -= 1
    rel_err_control("seq_gather", "17-token path with its last token hidden", got[:1],
                    plain(**dict(named, seq_lens=hidden))[:1], tol)
    with forced(ps, "seq_splits", 3):
        got = kern(*args)
    share = torch.from_numpy(b7_split_tokens(150, 3, 1)).to(dev)
    live = torch.arange(C, device=dev)[None, :] < named["seq_lens"][:, None]
    live[2, share] = False
    want = ps.path_attention_plain(named["q"], named["k_pool"], named["v_pool"], 0,
                                   named["paths"], live, named["scale"])
    rel_err_control("seq_gather", f"150-token path over 3 blocks: block 1's share (tokens "
                    f"{int(share[0])}-{int(share[-1])}) left out", got[2:3], want[2:3], tol)


def check_edge(tag, name, label, args, leaves, qpk, tol, clean=None):
    """An attention kernel's edge case against its plain version: the first
    `leaves` leaves' rows (partial entries: acc and l on their rows, folded
    for a flatten kernel, m where a row saw a token), every output finite,
    pad rows included.  The plain version reads `clean` where given (the
    arguments with DUMP_SLOT's row finite).  Returns the kernel's output."""
    import torch

    fn, plain = wrappers()[name]
    got = fn(*args)
    torch.cuda.synchronize()
    want = plain(*(clean or args))
    if name in PARTIAL_OF:
        rows = ((slice(None), slice(0, leaves * qpk)) if KERNELS[name][2] == "flatten"
                else (slice(0, leaves),))
        seen = want[2][rows] > 0
        pairs = [(got[0][rows], want[0][rows]), (got[2][rows], want[2][rows]),
                 (got[1][rows][seen], want[1][rows][seen])]
        e = max(rel_err(g, w) for g, w in pairs if w.numel())
        ok = all(bool(torch.isfinite(t).all()) for t in got)
    else:
        e = rel_err(got[:leaves], want[:leaves])
        ok = bool(torch.isfinite(got).all())
    print(f"[{tag}] {name} {label}: rel err {e:.3e}, tol {tol:.0e}", flush=True)
    check(e < tol and ok, f"{name} {label} disagrees with its plain version: {e}")
    return got


def plan_block_len(plan_args) -> int:
    """block_len of a flatten kernel's named arguments: given (paged
    entries) or T / nb (gather entries)."""
    return plan_args.get("block_len") or plan_args["tok_lo"].shape[0] // plan_args["blk_lo"].shape[0]


def b4_span_tokens(plan_args, R, qpk, spans, span):
    """The plan tokens of one span of deft_flat_q's first row tile: the
    span's share of the 64-token tiles of the blocks that tile sees (none
    where the span holds no tile)."""
    from deft_tpu_torch.ops import paged_flatten_attn as pf

    blk_lo, blk_hi, block_len = plan_args["blk_lo"], plan_args["blk_hi"], plan_block_len(plan_args)
    lo, hi = blk_lo.cpu().numpy(), blk_hi.cpu().numpy()
    Rq = R * qpk
    leaf_b = (min(Rq, pf.q_block_rows(Rq)) - 1) // qpk
    full = lo < -(1 << 20)
    listed = [b for b in range(len(lo))
              if hi[b] > 0 and (full[b] or (lo[b] < hi[b] and lo[b] <= leaf_b))]
    tpb = block_len // 64
    total = len(listed) * tpb
    return np.concatenate([np.zeros(0, int)] + [
        listed[li // tpb] * block_len + (li % tpb) * 64 + np.arange(64)
        for li in range(total * span // spans, total * (span + 1) // spans)])


def b4_edges(dev, gen):
    """B4 and B4p (bf16 q: deft_flat_q; fp32 q: the staged body) against
    their plain versions on a width-40 tree over a 4000-token prompt: FULL
    prefix blocks, few-leaf suffix blocks, a dead bucket tail, and at qpk 4
    and 8 more than 128 folded rows, so row tiles differ in the blocks they
    see; seg_len 32, 128, 256 and 512; qpk 1 (64 rows: 4-warp blocks), 4, 7
    and 8; D 64 and 128; B4p also on windows of the plan's first 21 and 32
    blocks.  Control: B4's output against the plain version with the tokens
    of one span of the first row tile hidden."""
    import torch
    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.ops import paged_flatten_attn as pf
    from deft_tpu_torch.plan import build_flatten_plan

    fns = wrappers()
    tree = grow_tree(PROMPT_LEN, 40, 12, 16384, np.random.default_rng(SEED + 4))
    Hkv, S = 2, tree.token_to_kv_pool.size

    def run(name, label, args, tol, leaves, qpk):
        return check_edge("kernels", name, label, args, leaves, qpk, tol)

    for seg_len in (32, 128, 256, 512):
        block_len = max(128, seg_len)
        for qpk in (1, 4, 7, 8):
            plan = build_flatten_plan(tree, q_per_kv=qpk, block_len=block_len,
                                      min_token_bucket=1024, seg_len=(seg_len,),
                                      waste_limit=64.0)
            full = plan.blk_lo < -(1 << 20)
            check(plan.paged and plan.seg_len == seg_len and full.any()
                  and (~full & (plan.blk_lo >= plan.blk_hi)).any(),
                  f"b4 edge plan at seg_len {seg_len} lacks FULL or dead blocks")
            nb, nseg = len(plan.blk_lo), block_len // seg_len
            for D in (64, 128):
                pools = [torch.randint(-127, 128, (1, S, Hkv * D), generator=gen,
                                       device=dev, dtype=torch.int8) for _ in range(2)]
                pools += [torch.rand((1, Hkv, S), generator=gen, device=dev) * 0.09 + 0.01
                          for _ in range(2)]
                arrs = [plan.seg_src, plan.tok_lo, plan.tok_hi, plan.blk_lo, plan.blk_hi]
                for dt in (torch.bfloat16, torch.float32):
                    q = torch.randn((plan.l_pad, qpk * Hkv, D), generator=gen,
                                    device=dev).to(dt)
                    tol = TOL[str(dt)[6:]]
                    base = f"{str(dt)[6:]} seg_len {seg_len} qpk {qpk} D={D}"
                    args = (q, *pools, 0, *to_dev(arrs, dev), D ** -0.5, block_len, seg_len)
                    spans = pf.q_spans(plan.l_pad * qpk, Hkv, nb, block_len,
                                       _cuda.sm_count(dev.index))
                    run("paged_flatten_q", f"{base}, {nb} blocks, {spans} spans", args, tol,
                        plan.n_leaves, qpk)
                    for nblk in (nb, 21, 32):
                        if nblk > nb:
                            continue
                        warr = [plan.seg_src[:nblk * nseg], plan.tok_lo[:nblk * block_len],
                                plan.tok_hi[:nblk * block_len], plan.blk_lo[:nblk],
                                plan.blk_hi[:nblk]]
                        wargs = (q, *pools, 0, *to_dev(warr, dev), D ** -0.5, block_len,
                                 seg_len)
                        run("paged_flatten_q_partial", f"{base}, window of {nblk} blocks",
                            wargs, tol, plan.n_leaves, qpk)
                    if seg_len == 128 and qpk == 4 and D == 128 and dt == torch.bfloat16:
                        control = (args, plan, spans)
    # the control: span 0 of row tile 0 hidden from the plain version
    args, plan, spans = control
    named = named_args("paged_flatten_q", args)
    got = fns["paged_flatten_q"][0](*args)
    hidden = torch.from_numpy(b4_span_tokens(named, plan.l_pad, 4, spans, 0)).to(dev)
    rel_err_control("paged_flatten_q", f"span 0 of {spans} ({hidden.numel()} tokens) "
                    "hidden", got[:plan.n_leaves],
                    fns["paged_flatten_q"][1](**hidden_plan(named, hidden, plan.l_pad))
                    [:plan.n_leaves], TOL["bfloat16"])


def hidden_plan(named, tokens, R):
    """The plan arguments ``named`` with ``tokens`` (plan token positions)
    hidden from every row: their intervals emptied, FULL blocks spelled out
    as intervals."""
    import torch
    from deft_tpu_torch.ops import paged_flatten_attn as pf

    lo, hi = pf.leaf_intervals(named["tok_lo"], named["tok_hi"], named["blk_lo"],
                               named["blk_hi"], plan_block_len(named), R)
    lo, hi = lo.clone(), hi.clone()
    lo[tokens] = 0
    hi[tokens] = 0
    return dict(named, tok_lo=lo, tok_hi=hi, blk_lo=torch.zeros_like(named["blk_lo"]),
                blk_hi=torch.full_like(named["blk_hi"], R))


def partial_out(state):
    """acc / l of a partial state (0 where l = 0), to hold two states'
    outputs to each other."""
    acc, _, l = state
    return acc / l.clamp_min(1e-30)[..., None] * (l > 0)[..., None]


def b1_grids(dev, shapes):
    """The grid B1 and B1p take at their path shapes; returns {name: spans}."""
    from deft_tpu_torch.ops import _cuda

    sms, out = _cuda.sm_count(dev.index), {}
    for name in ("paged_flatten", "paged_flatten_partial"):
        args = shapes[name][0][2]
        a = named_args(name, args)
        tiles, rb, Hkv, spans, _ = flat_q_grid(name, args, sms)
        out[name] = spans
        print(f"[b1] {name} grid: {len(tiles)} row tiles of {rb} folded rows x {Hkv} KV "
              f"heads x {spans} spans = {len(tiles) * Hkv * spans} blocks of {rb // 16} "
              f"warps ({sms} SMs) over {a['blk_lo'].shape[0]} plan blocks of "
              f"{a['block_len']} tokens, seg_len {a['seg_len']}, then the merge kernel",
              flush=True)
    return out


def b1_edges(dev, gen, shapes):
    """B1 and B1p over bf16 q and bf16 pools (deft_flat_q's bf16 instance)
    against their plain versions, bf16, tolerance 2e-2: the width-40 tree
    over the 4000-token prompt (FULL prefix blocks, few-leaf suffix blocks,
    a dead bucket tail; at qpk 4 and 8 two or more row tiles) at seg_len 32,
    64 and 256, qpk 1, 4, 7 and 8, D 64 and 128, B1p also on windows of the
    plan's first 15 and 21 blocks; 1 span and twice the rule's spans,
    forced, at seg_len 64, qpk 4, D 128.  Controls through the plain
    version: span 0 of the first row tile hidden; a 17-token path (a
    16-token prompt and the leaf's token) with its last token hidden; the
    last span's tokens left out of B1p's merged state at the sharded path
    shape."""
    import torch
    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.ops import paged_flatten_attn as pf
    from deft_tpu_torch.plan import build_flatten_plan

    fns = wrappers()
    tol = TOL["bfloat16"]
    grids = b1_grids(dev, shapes)
    tree = grow_tree(PROMPT_LEN, 40, 12, 16384, np.random.default_rng(SEED + 5))
    Hkv, S = 8, tree.token_to_kv_pool.size

    def run(name, label, args, leaves, qpk):
        return check_edge("b1", name, label, args, leaves, qpk, tol)

    control = None
    for seg_len in (32, 64, 256):
        block_len = max(128, seg_len)
        for qpk in (1, 4, 7, 8):
            plan = build_flatten_plan(tree, q_per_kv=qpk, block_len=block_len,
                                      min_token_bucket=1024, seg_len=(seg_len,),
                                      waste_limit=64.0)
            full = plan.blk_lo < -(1 << 20)
            check(plan.paged and plan.seg_len == seg_len and full.any()
                  and (~full & (plan.blk_lo >= plan.blk_hi)).any(),
                  f"b1 edge plan at seg_len {seg_len} lacks FULL or dead blocks")
            nb, nseg = len(plan.blk_lo), block_len // seg_len
            for D in (64, 128):
                pools = [torch.randn((1, S, Hkv * D), generator=gen, device=dev)
                         .to(torch.bfloat16) for _ in range(2)]
                q = torch.randn((plan.l_pad, qpk * Hkv, D), generator=gen,
                                device=dev).to(torch.bfloat16)
                arrs = [plan.seg_src, plan.tok_lo, plan.tok_hi, plan.blk_lo, plan.blk_hi]
                args = (q, *pools, 0, *to_dev(arrs, dev), D ** -0.5, block_len, seg_len)
                spans = pf.q_spans(plan.l_pad * qpk, Hkv, nb, block_len,
                                   _cuda.sm_count(dev.index))
                base = f"seg_len {seg_len} qpk {qpk} D={D}"
                run("paged_flatten", f"{base}, {nb} blocks, {spans} spans", args,
                    plan.n_leaves, qpk)
                for nblk in (nb, 15, 21):
                    if nblk > nb:
                        continue
                    warr = [plan.seg_src[:nblk * nseg], plan.tok_lo[:nblk * block_len],
                            plan.tok_hi[:nblk * block_len], plan.blk_lo[:nblk],
                            plan.blk_hi[:nblk]]
                    wargs = (q, *pools, 0, *to_dev(warr, dev), D ** -0.5, block_len, seg_len)
                    run("paged_flatten_partial", f"{base}, window of {nblk} blocks", wargs,
                        plan.n_leaves, qpk)
                if seg_len == 64 and qpk == 4 and D == 128:
                    control = (args, plan, spans)
                    for s in (1, 2 * spans):
                        with forced(pf, "q_spans", s):
                            run("paged_flatten", f"{base}, {s} spans forced", args,
                                plan.n_leaves, qpk)
                            run("paged_flatten_partial", f"{base}, {s} spans forced", args,
                                plan.n_leaves, qpk)

    # control 1: span 0 of row tile 0 hidden from the plain version
    args, plan, spans = control
    named = named_args("paged_flatten", args)
    got = fns["paged_flatten"][0](*args)
    hidden = torch.from_numpy(b4_span_tokens(named, plan.l_pad, 4, spans, 0)).to(dev)
    rel_err_control("paged_flatten", f"span 0 of {spans} ({hidden.numel()} tokens) hidden",
                    got[:plan.n_leaves],
                    fns["paged_flatten"][1](**hidden_plan(named, hidden, plan.l_pad))
                    [:plan.n_leaves], tol)
    # control 2: a 17-token path, its last token (the leaf's own) hidden
    short = grow_tree(16, 8, 0, 4096, np.random.default_rng(SEED + 6))
    plan = build_flatten_plan(short, q_per_kv=4, block_len=128, min_token_bucket=128,
                              seg_len=(32,), waste_limit=64.0)
    check(plan.paged, "the 17-token-path plan is not paged")
    D = 128
    pools = [torch.randn((1, short.token_to_kv_pool.size, Hkv * D), generator=gen,
                         device=dev).to(torch.bfloat16) for _ in range(2)]
    q = torch.randn((plan.l_pad, 4 * Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    args = (q, *pools, 0, *to_dev([plan.seg_src, plan.tok_lo, plan.tok_hi, plan.blk_lo,
                                   plan.blk_hi], dev), D ** -0.5, 128, 32)
    named = named_args("paged_flatten", args)
    lo, hi = (named[k].cpu().numpy() for k in ("tok_lo", "tok_hi"))
    own = np.nonzero((lo == 0) & (hi == 1))[0]
    seen = pf.leaf_intervals(*(named[k] for k in ("tok_lo", "tok_hi", "blk_lo", "blk_hi")),
                             128, plan.l_pad)
    path = int(((seen[0] <= 0) & (0 < seen[1])).sum())
    check(len(own) == 1 and path == 17, f"leaf 0's path: {path} tokens, {len(own)} its own")
    got = run("paged_flatten", "17-token paths", args, plan.n_leaves, 4)
    rel_err_control("paged_flatten", "17-token path with its last token hidden", got[:1],
                    fns["paged_flatten"][1](**hidden_plan(named, torch.from_numpy(own)
                                                          .to(dev), plan.l_pad))[:1], tol)
    # control 3: the last span's tokens left out of B1p's merge
    label, (plan, leaves), args = shapes["paged_flatten_partial"][0]
    spans = grids["paged_flatten_partial"]
    named = named_args("paged_flatten_partial", args)
    R, Hq, D = named["q"].shape
    rows = slice(0, min(leaves * 4, pf.q_block_rows(R * 4)))  # row tile 0's live rows
    got = partial_out(fns["paged_flatten_partial"][0](*args))
    hidden = torch.from_numpy(b4_span_tokens(named, R, 4, spans, spans - 1)).to(dev)
    want = partial_out(fns["paged_flatten_partial"][1](**hidden_plan(named, hidden, R)))
    rel_err_control("paged_flatten_partial", f"{label}: span {spans - 1} of {spans} "
                    f"({hidden.numel()} tokens) left out", got[:, rows], want[:, rows], tol)


def b6_edges(dev, gen, shapes):
    """B6 and B11 over bf16 q (deft_flat_q with one pool index a token)
    against their plain versions beyond the path shapes, bf16, tolerance
    2e-2: B6 at the batch plan halfway with 1 span, q_spans' count and
    twice the rule's spans forced; B11 on the four windows of a dp 2 x sp 2
    grid over the batch plan and on both dp windows of the short tree,
    bf16 and int8 pools; a plan of at most 64 folded rows (4-warp blocks),
    B6 and B11 at D 64 and 128; qpk 8 at D 64 on the short tree.  Prints
    the grid each path shape takes.  Controls through the plain version: a
    leaf's own token's kv_idx swapped with another leaf's; a 17-token
    path's last token hidden; span 0 of the batch plan's first row tile
    hidden; the last of B11's spans left out of its merge at its path
    shape."""
    import torch
    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.ops import paged_flatten_attn as pf
    from deft_tpu_torch.parallel.mesh import Grid
    from deft_tpu_torch.plan import build_flatten_plan

    fns = wrappers()
    tol = TOL["bfloat16"]
    sms = _cuda.sm_count(dev.index)
    bf16 = torch.bfloat16
    cases = {label: (plan, args) for label, plan, args in shapes["flatten_gather"]}
    for name, label, args in ([("flatten_gather", label, args) for label, (_, args)
                               in cases.items()]
                              + [("flatten_gather_partial", *shapes["flatten_gather_partial"][0]
                                  [::2])]):
        tiles, rb, Hkv, spans, qs = flat_q_grid(name, args, sms)
        rule = ("balanced_spans" if named_args(name, args).get("row_tiles") is not None
                else "q_spans")
        print(f"[b6] {name} {label} grid: {len(tiles)} row tiles of {rb} folded rows x {Hkv} "
              f"KV heads x {spans} spans ({rule}) = {len(tiles) * Hkv * spans} blocks ({sms} "
              f"SMs); listed 64-token tiles a row tile {list(tiles)}; q_spans {qs}", flush=True)

    plan, args = cases["batch inherit"]
    _, _, _, spans, qs = flat_q_grid("flatten_gather", args, sms)
    for s in sorted({1, qs, 2 * spans}):
        with forced_spans(s):
            check_edge("b6", "flatten_gather", f"batch plan, {s} spans forced", args,
                       plan.n_leaves, 4, tol)
    for label in ("batch inherit", "batch int8", "inherit", "int8"):
        plan, args = cases[label]
        grids = ([Grid((2, 2, 1), r, dev) for r in range(4)] if label.startswith("batch")
                 else [Grid((2, 1, 1), r, dev) for r in range(2)])
        for grid in grids:
            wargs, leaves = window_case("flatten_gather_partial", plan, args, grid)
            check_edge("b6", "flatten_gather_partial", f"{label} plan, rank {grid.coords} of "
                       f"{grid.shape}", wargs, leaves, 4, tol)
    # at most 64 folded rows (4-warp blocks); qpk 8 on the short tree
    small = grow_tree(16, 12, 6, 4096, np.random.default_rng(SEED + 7))
    short = grow_tree(16, WIDTH, GEN_LEN // 2, 16384, np.random.default_rng(SEED))
    for tree, qpk, Hkv, D in ((small, 4, 2, 64), (small, 4, 2, 128), (short, 8, 4, 64)):
        for kv in ("inherit", "int8"):
            plan, args = kernel_case("flatten_gather", tree, qpk, Hkv, D, bf16, dev, gen, 128,
                                     kv=kv)
            check(tree is not small or plan.l_pad * qpk <= 64,
                  f"the small plan has {plan.l_pad * qpk} folded rows")
            label = f"{plan.l_pad * qpk} folded rows, qpk {qpk}, D={D}, {kv}"
            check_edge("b6", "flatten_gather", label, args, plan.n_leaves, qpk, tol)
            for r in range(2):
                grid = Grid((1, 2, 1), r, dev)
                wargs, leaves = window_case("flatten_gather_partial", plan, args, grid)
                check_edge("b6", "flatten_gather_partial", f"{label}, rank {grid.coords}",
                           wargs, leaves, qpk, tol)

    # controls 1 and 2: 17-token paths (a 16-token prompt and the leaf's own
    # token); leaf 0's own token swapped with leaf 1's, then hidden
    tree = grow_tree(16, 8, 0, 4096, np.random.default_rng(SEED + 6))
    plan = build_flatten_plan(tree, q_per_kv=4, block_len=128, min_token_bucket=128,
                              seg_len=None)
    check(not plan.paged, "the 17-token-path plan is paged")
    pools, scales = random_pools("inherit", tree.token_to_kv_pool.size, 8, 128, bf16, dev, gen)
    q = torch.randn((plan.l_pad, 32, 128), generator=gen, device=dev).to(bf16)
    args = gather_args(plan, q, pools, scales, dev)
    named = named_args("flatten_gather", args)
    own = [int(np.nonzero((plan.tok_lo == i) & (plan.tok_hi == i + 1))[0][0]) for i in (0, 1)]
    got = check_edge("b6", "flatten_gather", "17-token paths", args, plan.n_leaves, 4, tol)
    swapped = named["kv_idx"].clone()
    swapped[own[0]], swapped[own[1]] = named["kv_idx"][own[1]], named["kv_idx"][own[0]]
    rel_err_control("flatten_gather", "17-token paths, leaf 0's and leaf 1's own tokens' "
                    "kv_idx swapped", got[:2], fns["flatten_gather"][1](
                        **dict(named, kv_idx=swapped))[:2], tol)
    hidden = torch.tensor(own[:1], device=dev)
    rel_err_control("flatten_gather", "17-token path with its last token hidden", got[:1],
                    fns["flatten_gather"][1](**hidden_plan(named, hidden, plan.l_pad))[:1],
                    tol)
    # control 3: span 0 of the batch plan's first row tile hidden
    plan, args = cases["batch inherit"]
    named = named_args("flatten_gather", args)
    got = fns["flatten_gather"][0](*args)
    hidden = torch.from_numpy(b4_span_tokens(named, plan.l_pad, 4, spans, 0)).to(dev)
    rel_err_control("flatten_gather", f"batch plan: span 0 of {spans} ({hidden.numel()} "
                    "tokens) hidden", got[:plan.n_leaves],
                    fns["flatten_gather"][1](**hidden_plan(named, hidden, plan.l_pad))
                    [:plan.n_leaves], tol)
    # control 4: the last of B11's spans that holds a token row tile 0's
    # live rows see (a span of pad tokens alone changes nothing) left out
    label, (plan, leaves), args = shapes["flatten_gather_partial"][0]
    spans = flat_q_grid("flatten_gather_partial", args, sms)[3]
    named = named_args("flatten_gather_partial", args)
    R = named["q"].shape[0]
    live = min(leaves, pf.q_block_rows(R * 4) // 4)  # row tile 0's live leaves
    lo, hi = (t.cpu().numpy() for t in pf.leaf_intervals(
        *(named[k] for k in ("tok_lo", "tok_hi", "blk_lo", "blk_hi")), plan_block_len(named), R))
    span, hidden = next((sp, t) for sp in reversed(range(spans))
                        for t in [b4_span_tokens(named, R, 4, spans, sp)]
                        if ((lo[t] < live) & (hi[t] > lo[t])).any())
    rows = slice(0, live * 4)
    got = partial_out(fns["flatten_gather_partial"][0](*args))
    hidden = torch.from_numpy(hidden).to(dev)
    want = partial_out(fns["flatten_gather_partial"][1](**hidden_plan(named, hidden, R)))
    rel_err_control("flatten_gather_partial", f"{label}: span {span} of {spans} "
                    f"({hidden.numel()} tokens; the last one a live row sees) left out",
                    got[:, rows], want[:, rows], tol)
    b6_wide_edges(dev, gen)


def dump_poisoned(name, args):
    """Kernel `name`'s arguments with pool row DUMP_SLOT (0), where a gather
    plan's pads sit, NaN: K and V rows of bf16 pools, the scales of int8
    pools (their codes hold no NaN)."""
    import torch

    a = named_args(name, args)
    keys, dim = (("k_scale", "v_scale"), 2) if a.get("k_scale") is not None else \
        (("k_pool", "v_pool"), 1)
    zero = torch.zeros(1, dtype=torch.long, device=a["q"].device)
    a.update((k, a[k].clone().index_fill_(dim, zero, float("nan"))) for k in keys)
    return tuple(a.values())


def b6_wide_edges(dev, gen):
    """B6 and B11 over bf16 q at the wide heads (D 96 and 256: deft_flat_q's
    zeroed half box, staged Q and two-stage ring) against their plain
    versions, bf16, tolerance 2e-2, bf16 and int8 pools: a plan of at most
    64 folded rows (4-warp blocks: the 12-leaf tree, qpk 4) and one of more
    (8-warp blocks: the 16-token prompt's tree at width 50, qpk 4), each
    with q_spans' count, 1 span and twice the rule's spans forced, and B11
    on both dp windows of grid 2x1x1; DUMP_SLOT's row NaN in the kernel's
    pools (the pads' row: it must never reach a product), the plain version
    reading it finite; every output finite.  Fault controls through the
    plain version, each D: span 0 of the 64-row plan's row tile hidden (1
    span of 2 forced), the first leaf's own tokens hidden on the wider
    plan."""
    import torch
    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.ops import paged_flatten_attn as pf
    from deft_tpu_torch.parallel.mesh import Grid

    tol = TOL["bfloat16"]
    sms = _cuda.sm_count(dev.index)
    small = grow_tree(16, 12, 6, 4096, np.random.default_rng(SEED + 7))
    short = grow_tree(16, WIDTH, GEN_LEN // 2, 16384, np.random.default_rng(SEED))
    for D in WIDE_HEADS:
        B6, B11 = f"flatten_gather_d{D}", f"flatten_gather_partial_d{D}"
        for tree, rows in ((small, 64), (short, 128)):
            for kv in ("inherit", "int8"):
                plan, clean = kernel_case(B6, tree, 4, 2, D, torch.bfloat16, dev, gen, 128,
                                          kv=kv)
                rq = plan.l_pad * 4
                check(pf.q_block_rows(rq) == rows,
                      f"{B6}: the plan's {rq} folded rows take blocks of "
                      f"{pf.q_block_rows(rq)}, not {rows}")
                args = dump_poisoned(B6, clean)
                spans = flat_q_grid(B6, clean, sms)[3]
                for s in (spans, 1, 2 * spans):
                    with forced_spans(s):
                        check_edge("b6", B6, f"{rq} folded rows ({rows // 16} warps a block), "
                                   f"{kv}, D={D}, {s} spans{' (the rule)' if s == spans else ''}"
                                   f", DUMP_SLOT NaN", args, plan.n_leaves, 4, tol, clean)
                for r in range(2):
                    grid = Grid((2, 1, 1), r, dev)
                    wclean, leaves = window_case(B11, plan, clean, grid)
                    wargs = dump_poisoned(B11, wclean)
                    check_edge("b6", B11, f"{rq} folded rows, {kv}, D={D}, rank "
                               f"{grid.coords} of (2, 1, 1), DUMP_SLOT NaN", wargs, leaves, 4,
                               tol, wclean)
        # controls, bf16 pools: span 0 of 2 of the 64-row plan hidden; the
        # wider plan's leaf 0 without its own tokens
        plan, args = kernel_case(B6, small, 4, 2, D, torch.bfloat16, dev, gen, 128)
        named = named_args(B6, args)
        with forced_spans(2):
            got = wrappers()[B6][0](*args)
        hidden = torch.from_numpy(b4_span_tokens(named, plan.l_pad, 4, 2, 0)).to(dev)
        rel_err_control(B6, f"D={D} 64-row plan: span 0 of 2 ({hidden.numel()} tokens) "
                        "hidden", got[:plan.n_leaves], wrappers()[B6][1](
                            **hidden_plan(named, hidden, plan.l_pad))[:plan.n_leaves], tol)
        plan, args = kernel_case(B6, short, 4, 2, D, torch.bfloat16, dev, gen, 128)
        named = named_args(B6, args)
        own = np.nonzero((plan.tok_lo == 0) & (plan.tok_hi == 1))[0]
        got = wrappers()[B6][0](*args)
        hidden = torch.from_numpy(own).to(dev)
        rel_err_control(B6, f"D={D} {plan.l_pad * 4}-row plan: leaf 0's {own.size} own tokens "
                        "hidden",
                        got[:1], wrappers()[B6][1](**hidden_plan(named, hidden,
                                                                 plan.l_pad))[:1], tol)


def wide_batch_seq(dev, gen) -> dict:
    """B7 at each wide head width (WIDE_HEADS) on the batch path's four
    trees halfway: the multi-tree seq plan that BatchedEngine builds where
    the heads do not pack (runtime/batched.py build_plan: a gather plan,
    200 leaves over paths of up to 4000-odd tokens), bf16 q and pools, as
    the families phase's batched seq run serves it.  Checked against its
    plain version on the live leaves, a chunk of leaves at a time: the plain
    version gathers each path's K and V in fp32, over 10 GB for all the
    leaves at once.  Not timed.  Returns {name: max abs err}."""
    import torch
    from deft_tpu_torch.plan.multi import build_multi_seq_plan

    bf16 = torch.bfloat16
    trees = batch_trees(GEN_LEN // 2, np.random.default_rng(SEED + 3))
    S = trees[0].token_to_kv_pool.size
    errs = {}
    for D, (model, Hq, Hkv) in WIDE_HEADS.items():
        name = f"seq_gather_d{D}"
        fn, plain = wrappers()[name]
        plan = build_multi_seq_plan(trees, want_paged=False, q_per_kv=Hq // Hkv,
                                    block_len=256, min_token_bucket=1024)
        check(not plan.paged, f"{name}: the wide heads' batch seq plan is paged")
        pools, _ = random_pools("inherit", S, Hkv, D, bf16, dev, gen)
        q = torch.randn((plan.l_pad, Hq, D), generator=gen, device=dev).to(bf16)
        paths, seq_lens = to_dev([plan.paths, plan.seq_lens], dev)
        got = fn(q, *pools, 0, paths, seq_lens, D ** -0.5)
        torch.cuda.synchronize()
        n, C = plan.n_leaves, plan.paths.shape[1]
        chunk = max(1, int(2e9 // (C * Hkv * D * 8)))
        want = torch.cat([plain(q[r:e], *pools, 0, paths[r:e], seq_lens[r:e], D ** -0.5)
                          for r in range(0, n, chunk) for e in (min(r + chunk, n),)])
        e = rel_err(got[:n], want)
        print(f"[kernels] {name} {model} batch seq plan ({n} leaves, paths {C} wide, "
              f"{plan.total_kv} live path rows; plain {chunk} leaves at a time): rel err "
              f"{e:.3e}, tol {TOL['bfloat16']:.0e}", flush=True)
        check(e < TOL["bfloat16"] and bool(torch.isfinite(got[:n]).all()),
              f"{name} {model} batch seq plan disagrees with its plain version: {e}")
        errs[name] = float((got[:n].double() - want.double()).abs().max())
        del got, want, pools, q
        release()
    return errs


def wide_edges(dev, gen):
    """The wide heads' kernels (WIDE_HEADS: D 96 and 256) beyond their path
    shapes, each against its plain version, every output finite.  fp32
    (tolerance 2e-5): B3 at N 300 and 1017, qpk 4 and 1; B8 over prompts
    off the 64-token tiles with a pad tail; B6 and B7 over fp32 and int8
    pools on the FULL/dead/few-leaf tree in the gather layout and on the
    16-token prompt's tree as the runner builds it, at block_len 128 and
    256; B11 on every rank's window of a dp 2 x sp 3 grid.  bf16 (2e-2): B3
    at qpk 4, 2, 8 and 1 and B8 at qpk 4 and 1, N 1017; B6, B7 and B11 at
    qpk 4 over both pool types; B7 on b7_edges' synthetic gather paths at
    qpk 1, 2 and 8, over 1, 3 and 8 blocks a path.  Controls through the
    plain versions, each above the tolerance: B3 and B8 a causal mask off
    by one; B6 and B11 two leaves' own tokens' kv_idx swapped; B7 the last
    entries of two 17-token paths swapped between the leaves (and
    b7_edges' controls at D 256)."""
    import torch
    from deft_tpu_torch.parallel.mesh import Grid
    from deft_tpu_torch.plan import build_flatten_plan

    f32, bf16 = torch.float32, torch.bfloat16
    a, _, c = small_trees(np.random.default_rng(SEED + 21))
    windows = [Grid((2, 3, 1), r, dev) for r in range(6)]
    for D in WIDE_HEADS:
        B3, B8 = f"prefill_d{D}", f"ragged_prefill_d{D}"
        B6, B7, B11 = f"flatten_gather_d{D}", f"seq_gather_d{D}", f"flatten_gather_partial_d{D}"
        for dt, tol in ((f32, TOL["float32"]), (bf16, TOL["bfloat16"])):
            tag = "fp32" if dt == f32 else "bf16"
            for N, Hq, Hkv in ((300, 8, 2), (1017, 8, 2), (1017, 4, 2), (1017, 16, 2),
                               (1017, 2, 2)):
                # fp32 at qpk 4 and 1; bf16 at N 1017, qpk 4, 2, 8 and 1
                if dt == bf16 and N == 1017 or dt == f32 and Hq // Hkv in (4, 1):
                    args = prefill_case(N, Hq, Hkv, D, dt, dev, gen)
                    check_edge("wide", B3, f"{tag} D={D} qpk {Hq // Hkv} N={N}", args, N,
                               Hq // Hkv, tol)
            for Hq, Hkv in ((8, 2), (2, 2)):
                for lens, pad in (((60, 83, 100), 13), ((500, 300, 217), 24)):
                    rargs, rows = ragged_case(lens, Hq, Hkv, D, dt, dev, gen, pad)
                    got = check_edge("wide", B8, f"{tag} D={D} qpk {Hq // Hkv} lens {lens} "
                                     f"pad {pad}", rargs, int(rows.sum()), Hq // Hkv, tol)
                    check(not bool(got[~rows].any()), f"{B8}: pad rows are not 0")
            trees = ((a, "FULL/dead/few-leaf tree", False), (c, "short-prompt plan", True))
            for block_len in ((128, 256) if dt == f32 else (256,)):
                for tree, label, built in trees:
                    for name in (B6, B7):
                        for kv in ("inherit", "int8"):
                            plan, args = kernel_case(name, tree, 4, 2, D, dt, dev, gen,
                                                     block_len, kv=kv, as_built=built)
                            check_edge("wide", name, f"{tag} {kv} D={D} block {block_len} "
                                       f"{label}", args, plan.n_leaves, 4, tol)
                            if name != B6:
                                continue
                            for grid in (windows if dt == f32 else windows[:2]):
                                wargs, leaves = window_case(B11, plan, args, grid)
                                check_edge("wide", B11, f"{tag} {kv} D={D} block {block_len} "
                                           f"{label}, rank {grid.coords}", wargs, leaves, 4,
                                           tol)
        tol = TOL["bfloat16"]
        # controls, bf16: B3 and B8 on their last cases (qpk 1, N 1017; the
        # long ragged prompts), a causal mask off by one
        q, k, v, scale = args = prefill_case(1017, 2, 2, D, bf16, dev, gen)
        pos = torch.arange(q.shape[0], device=dev)
        rel_err_control(B3, f"D={D} one-token causal-mask fault (row i sees i + 1)",
                        wrappers()[B3][0](*args),
                        dense_masked(q, k, v, scale, pos[None, :] <= pos[:, None] + 1), tol)
        q, k, v, seg, scale = rargs
        pos = torch.arange(q.shape[0], device=dev)
        same = (seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
        rel_err_control(B8, f"D={D} one-token causal-mask fault (row i sees i + 1)",
                        wrappers()[B8][0](*rargs)[rows],
                        dense_masked(q, k, v, scale, same & (pos[None, :] <= pos[:, None] + 1))
                        [rows], tol)
        # B6 and B11: 17-token paths (a 16-token prompt and the leaf's own
        # token), leaf 0's and leaf 1's own tokens' kv_idx swapped
        tree = grow_tree(16, 8, 0, 4096, np.random.default_rng(SEED + 6))
        plan = build_flatten_plan(tree, q_per_kv=4, block_len=128, min_token_bucket=128,
                                  seg_len=None)
        pools, scales = random_pools("inherit", tree.token_to_kv_pool.size, 2, D, bf16, dev,
                                     gen)
        q = torch.randn((plan.l_pad, 8, D), generator=gen, device=dev).to(bf16)
        args = gather_args(plan, q, pools, scales, dev)
        own = [int(np.nonzero((plan.tok_lo == i) & (plan.tok_hi == i + 1))[0][0])
               for i in (0, 1)]
        got = check_edge("wide", B6, f"bf16 D={D} 17-token paths", args, plan.n_leaves, 4, tol)
        named = named_args(B6, args)
        swapped = named["kv_idx"].clone()
        swapped[own[0]], swapped[own[1]] = named["kv_idx"][own[1]], named["kv_idx"][own[0]]
        rel_err_control(B6, f"D={D} 17-token paths, leaf 0's and leaf 1's own tokens' kv_idx "
                        "swapped", got[:2], wrappers()[B6][1](**dict(named, kv_idx=swapped))[:2],
                        tol)
        wargs, leaves = window_case(B11, plan, args, Grid((1, 1, 1), 0, dev))
        got = partial_out(check_edge("wide", B11, f"bf16 D={D} 17-token paths, one window",
                                     wargs, leaves, 4, tol))
        wnamed = named_args(B11, wargs)
        want = partial_out(wrappers()[B11][1](**dict(wnamed, kv_idx=swapped)))
        rel_err_control(B11, f"D={D} 17-token paths, leaf 0's and leaf 1's own tokens' "
                        "kv_idx swapped", got[:, :8], want[:, :8], tol)
        # B7: the last entries of two 17-token paths swapped between the leaves
        rng = np.random.default_rng(SEED + 22)
        paths, seq_lens = synthetic_gather_paths(rng, [17, 17, 150], 192, 4096)
        pools, scales = random_pools("inherit", 4096, 2, D, bf16, dev, gen)
        q = torch.randn((3, 8, D), generator=gen, device=dev).to(bf16)
        q[:2] *= 0.05  # small queries: each token weighs about a seventeenth
        args = (q, *pools, 0, *to_dev([paths, seq_lens], dev), D ** -0.5, *scales)
        got = check_edge("wide", B7, f"bf16 D={D} 17-token paths", args, 3, 4, tol)
        named = named_args(B7, args)
        swapped = named["paths"].clone()
        swapped[0, 16], swapped[1, 16] = named["paths"][1, 16], named["paths"][0, 16]
        rel_err_control(B7, f"D={D} 17-token paths, leaf 0's and leaf 1's last entries "
                        "swapped", got[:2], wrappers()[B7][1](**dict(named, paths=swapped))[:2],
                        tol)
    # B7's wide body at the path edges, with its row mapping at several live rows
    b7_edges(dev, gen, widths=tuple(WIDE_HEADS), qpks=(1, 2, 8))


def dense_masked(q, k, v, scale, mask):
    """Attention of q (N, Hq, D) over k, v (N, Hkv, D) under a (N, N) mask
    of visible (row, key) pairs, fp32, cast to q's dtype; rows that see
    nothing give 0."""
    import torch

    N, Hq, D = q.shape
    Hkv = k.shape[1]
    qg = q.float().view(N, Hkv, Hq // Hkv, D)
    sc = torch.einsum("nhgd,thd->hgnt", qg, k.float()) * scale
    sc = sc.masked_fill(~mask, float("-inf"))
    p = torch.softmax(sc, dim=-1).nan_to_num(0.0)
    o = torch.einsum("hgnt,thd->nhgd", p, v.float())
    return o.reshape(N, Hq, D).to(q.dtype)


def wgmma_edges(dev, gen, compare):
    """bf16 cases at the edges of the wgmma bodies, each against its plain
    version, and the fault controls on the same inputs.  B3 and B8 take
    128 folded rows (128 / qpk tokens) a block and 128-token KV tiles: N =
    1017 is a multiple of neither at qpk 1 and 4, D 64 and 128; B8's prompts
    straddle tiles and end in a pad tail.  B10 takes 128 x 256 output tiles,
    64-deep stages and a persistent walk: E % 64 == 32, F = 128 and F % 256
    == 128 (a half tile), an empty expert group, pad tiles past the last
    group, an invalid tile_eid (its tile must be NaN) and 200 output tiles,
    more than the card's SMs.  Controls: each row also seeing the token
    after its own (a causal mask off by one) and one live row tile sent to
    another expert, both through the plain version; each must read above
    the tolerance the kernel is held to."""
    import torch

    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    fns = wrappers()

    def control(name, label, got, want_fault):
        e = rel_err(got, want_fault)
        print(f"[kernels] {name} {label}: the kernel against the faulted plain version "
              f"{e:.3e}, tol {tol:.0e}", flush=True)
        check(e > tol, f"{name}: the {label} control reads under the tolerance ({e})")

    for D in (64, 128):
        for Hq, Hkv in ((8, 2), (2, 2)):
            qpk = Hq // Hkv
            args = prefill_case(1017, Hq, Hkv, D, bf16, dev, gen)
            compare("prefill", f"bf16 D={D} qpk {qpk} N=1017", args, tol)
            for lens, pad in (((60, 83, 100), 13), ((500, 300, 217), 24)):
                rargs, rows = ragged_case(lens, Hq, Hkv, D, bf16, dev, gen, pad)
                compare("ragged_prefill", f"bf16 D={D} qpk {qpk} lens {lens} pad {pad}",
                        rargs, tol, rows)
    # the controls, on the last cases' inputs (D 128, qpk 1)
    q, k, v, scale = args
    pos = torch.arange(q.shape[0], device=dev)
    got = fns["prefill"][0](*args)
    control("prefill", "one-token causal-mask fault (row i sees i + 1)", got,
            dense_masked(q, k, v, scale, pos[None, :] <= pos[:, None] + 1))
    q, k, v, seg, scale = rargs
    pos = torch.arange(q.shape[0], device=dev)
    got = fns["ragged_prefill"][0](*rargs)
    same = (seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
    control("ragged_prefill", "one-token causal-mask fault (row i sees i + 1)", got[rows],
            dense_masked(q, k, v, scale, same & (pos[None, :] <= pos[:, None] + 1))[rows])

    rng = np.random.default_rng(SEED + 2)
    top_i = torch.from_numpy(np.stack([rng.choice([0, 1, 3], size=2, replace=False)
                                       for _ in range(300)])).to(dev)
    _, tok_pos, small = routed_rows(300, 4, dev, top_i=top_i)
    eids = small.tolist()
    check(2 not in eids and bool((tok_pos[-128:] == 300).all()),
          f"the B10 edge case lacks an empty group or pad tiles: {eids}")
    # 40 row tiles over 8 experts, expert 5 empty: 40 x 5 = 200 tiles of 256
    big = torch.tensor([e for e, n in zip((0, 1, 2, 3, 4, 6, 7), (4, 9, 3, 6, 8, 6, 4))
                        for _ in range(n)], dtype=torch.int32, device=dev)
    for name, scaled in (("gmm", False), ("gmm_scaled", True)):
        fn, plain = fns[name]
        for ne, E, F, tile_eid in ((4, 96, 128, small), (8, 160, 1152, big)):
            x = torch.randn((len(tile_eid) * 128, E), generator=gen, device=dev).to(bf16)
            gargs = gmm_case(x, ne, E, F, bf16, scaled, dev, gen, tile_eid)
            compare(name, f"bf16 NE={ne} E={E} F={F} tiles {tile_eid.tolist()}", gargs, tol)
        # an invalid tile_eid: NaN in its tile, the other tiles as before
        bad = small.clone()
        bad[1] = 4
        x = torch.randn((len(bad) * 128, 96), generator=gen, device=dev).to(bf16)
        x, w, _, ws = gmm_case(x, 4, 96, 128, bf16, scaled, dev, gen, small)
        got = fn(x, w, bad, ws)
        torch.cuda.synchronize()
        want = plain(x, w, small, ws)
        live = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
        live[128:256] = False
        e = rel_err(got[live], want[live])
        print(f"[kernels] {name} bf16 tile_eid {bad.tolist()}: rel err {e:.3e} on the "
              f"valid tiles, tol {tol:.0e}; invalid tile all NaN: "
              f"{bool(torch.isnan(got[~live]).all())}", flush=True)
        check(e < tol and bool(torch.isnan(got[~live]).all()),
              f"{name}: an invalid tile_eid is not a NaN tile beside right ones")
        wrong = small.clone()
        wrong[0] = (int(wrong[0]) + 1) % 4
        control(name, f"wrong expert on tile 0 ({int(small[0])} -> {int(wrong[0])})",
                fn(x, w, small, ws), plain(x, w, wrong, ws))


def stacked_reduce(t, op):
    """An all-reduce over the leading axis of a stack of ranks' tensors, in
    one process."""
    r = t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)
    return t.copy_(r.expand_as(t))


def phase_merge(dev, shapes):
    """The sp merge of B1p's state on the two halves of the main tree's
    blocks (engine.lse_merge over the stacked states) against B1 over the
    whole plan, both on the card: live rows, bf16 tolerance."""
    import torch
    from deft_tpu_torch.ops.paged_flatten_attn import unfold_rows
    from deft_tpu_torch.parallel import engine
    from deft_tpu_torch.parallel.mesh import Grid

    _, plan, args = shapes["paged_flatten"][0]
    fn = wrappers()["paged_flatten_partial"][0]
    states = []
    for r in range(2):
        wargs, _ = window_case("paged_flatten_partial", plan, args, Grid((1, 2, 1), r, dev))
        states.append(fn(*wargs))
    acc, m, l = (torch.stack(x) for x in zip(*states))
    o = unfold_rows(engine.lse_merge(acc, m, l, stacked_reduce)[0], plan.l_pad)
    whole = wrappers()["paged_flatten"][0](*args)
    torch.cuda.synchronize()
    live = slice(0, plan.n_leaves)
    e = rel_err(o[live], whole[live])
    print(f"[kernels] sp merge of B1p over two halves of the main plan vs B1 whole: "
          f"rel err {e:.3e}, tol {TOL['bfloat16']:.0e}", flush=True)
    check(e < TOL["bfloat16"], f"the sp merge of B1p's halves disagrees with B1: {e}")


def make_runner(cfg, params, dev, kv_dtype="inherit", prompt_len=PROMPT_LEN,
                slots=16384, max_requests=2 * WIDTH, mesh=None, use_tree_index=False,
                dtype="bfloat16", block_len=256, measure_attention=False,
                weight_dtype="inherit"):
    """A runner of the main path's settings.  measure_attention is off but
    in the attention phase (None: the runner's default), so that the other
    phases' times and profiles stay as they were."""
    from deft_tpu_torch.config import AttentionConfig, EngineConfig
    from deft_tpu_torch.runtime import ModelRunner

    ecfg = EngineConfig(attention=AttentionConfig(block_len=block_len),
                        kv_pool_slots=slots, max_requests=max_requests,
                        max_context_len=prompt_len + GEN_LEN + 64, kv_dtype=kv_dtype,
                        dtype=dtype, weight_dtype=weight_dtype)
    return ModelRunner(cfg, ecfg, device=dev, params=params,
                       topk_k=max(64, WIDTH), retain_full_logits=True, mesh=mesh,
                       use_tree_index=use_tree_index,
                       measure_attention=measure_attention)


def per_step(fn):
    """`fn` with its declarations (structural_iters, logits_free_iters,
    supports_deferred) hidden: tree_generate and BatchedEngine then run
    every step with host logits, the per-step path."""
    def wrapped(*a, **k):
        k.pop("deferred", None)
        return fn(*a, **k)
    return wrapped


@contextlib.contextmanager
def sync_mode(mode):
    """torch.cuda.set_sync_debug_mode(mode) while it is open, the mode
    before it restored after."""
    import torch

    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def sync_allowed():
    """The script's own reads of the card inside a sync_checked run
    (midrun_hold's controls, merge_watch's read-backs)."""
    return sync_mode(0)


@contextlib.contextmanager
def sync_checked(tag, on=True):
    """With `on`, the block runs under set_sync_debug_mode("error"), where
    any call that waits for the card raises except the runner's host_wait
    (which lowers the mode around its wait) and the script's checks inside
    the run (sync_allowed); such a wait fails the script, naming `tag`."""
    if not on:
        yield
        return
    try:
        with sync_mode("error"):
            yield
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        check(False, f"{tag}: a call outside the runner's host_wait waited for the "
              f"card: {e}")


def generate_run(runner, mode, prompt, fn=None, template=None, rng=None,
                 gen_len=GEN_LEN):
    """One generation of `gen_len` tokens through tree_generate, of the
    workload `fn` (default Simple_Tree) at WIDTH; returns {"pm", "seqs",
    "paged", "leaves", "launches", "lm_head", "waits"}: the finished
    branches' token ids, each
    step's plan layout and live leaves, the kernels launched and the lm_head
    products taken during the run, and the runner's host waits."""
    from unittest import mock

    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.models import llama
    from deft_tpu_torch.obs import PerfMetrics
    from deft_tpu_torch.runtime import tree_generate
    from deft_tpu_torch.runtime.runner import host_wait

    paged, leaves = [], []
    build, lm_head = runner.build_plan, llama.lm_head

    def recording_build(m):
        plan = build(m)
        paged.append(plan.paged)
        leaves.append(plan.n_leaves)
        return plan

    def counting_lm_head(*a, **k):
        LM_HEADS[0] += 1
        return lm_head(*a, **k)

    before, heads, waits = read_counts(), LM_HEADS[0], host_wait.waits
    with (mock.patch.object(runner, "build_plan", recording_build),
          mock.patch.object(llama, "lm_head", counting_lm_head)):
        pm = tree_generate(runner, mode, None, prompt,
                           max_seq_len=len(prompt) + gen_len, width=WIDTH, depth=1,
                           branch_controller=Branch_Controller(
                               fn or workloads.simple_tree),
                           tree_template=template, perf_metrics=PerfMetrics(),
                           rng=rng)
    return {"pm": pm, "seqs": [list(s.token_ids) for s in runner.tree.all_finished_seqs],
            "paged": paged, "leaves": leaves, "lm_head": LM_HEADS[0] - heads,
            "waits": host_wait.waits - waits,
            "launches": {k: v - before[k] for k, v in read_counts().items()
                         if v > before[k]}}


def generate_both(runner, prompt, tag, count_plans=False, sync_check=False,
                  gen_len=GEN_LEN):
    """Flatten then seq through tree_generate (under sync_checked with
    `sync_check`), `gen_len` tokens; checks each run finishes its branches
    and returns {mode: generate_run's dict}."""
    from deft_tpu_torch.runtime import ForwardMode

    out = {}
    for mode_name, mode in (("flatten", ForwardMode.TREE_DECODE_FLATTEN),
                            ("seq", ForwardMode.DECODE)):
        with sync_checked(f"{tag} {mode_name}", sync_check):
            run = out[mode_name] = generate_run(runner, mode, prompt, gen_len=gen_len)
        pm, seqs, paged, moved = run["pm"], run["seqs"], run["paged"], run["launches"]
        check(len(seqs) == WIDTH and all(len(s) == gen_len - 1 for s in seqs),
              f"{tag} {mode_name}: expected {WIDTH} branches of {gen_len - 1} tokens")
        check(np.isfinite(pm.TPOT) and pm.TPOT > 0, f"{tag} {mode_name}: bad TPOT")
        steps = (f", plans paged at {sum(paged)} of {len(paged)} steps"
                 if count_plans else "")
        print(f"[{tag}] {mode_name}: TTFT {pm.TTFT:.3f} ms, TPOT {pm.TPOT:.4f} ms, "
              f"decode {pm.decode_latency:.1f} ms, e2e {pm.e2e_latency:.1f} ms, "
              f"generated {pm.generated_len}, KV_IO {pm.KV_IO:.4e} B{steps}; "
              f"launches {moved}", flush=True)
    f, s = out["flatten"], out["seq"]
    same = np.mean([a == b for x, y in zip(f["seqs"], s["seqs"]) for a, b in zip(x, y)])
    print(f"[{tag}] kv_io_reduction (seq KV_IO / flatten KV_IO) "
          f"{s['pm'].KV_IO / f['pm'].KV_IO:.4f}; generated ids equal in "
          f"{same:.4f} of positions (bf16 near-ties may flip greedy tokens)",
          flush=True)
    return out


def first_step(runner, prompt, ids):
    """Prefill, branch the root into WIDTH leaves with tokens `ids`, alloc;
    returns the tree for the first decode step."""
    runner.forward_prefill(prompt)
    tree = runner.tree
    for c, child in enumerate(tree.branch(tree.root, WIDTH)):
        child.append_token(int(ids[c]))
    tree.alloc()
    return tree


def main_prompt() -> list:
    """The main path's PROMPT_LEN random token ids (seed SEED)."""
    from deft_tpu_torch.models import PRESETS

    rng = np.random.default_rng(SEED)
    return [int(t) for t in rng.integers(4, PRESETS["8b"].vocab_size - 4, PROMPT_LEN)]


def phase_main(dev, params, profile: bool = False):
    """Flatten then seq through the public entry points; returns the launch
    counts during that run and the first decode step's flatten logits and
    branch tokens."""
    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode

    cfg = PRESETS["8b"]
    runner = make_runner(cfg, params, dev)
    prompt = main_prompt()

    # first decode step in both modes on one tree state: logits must agree
    view = runner.forward_prefill(prompt)
    _, ids = view.topk(0, WIDTH)
    runner.reset_state()
    first_step(runner, prompt, ids)
    lf, ls, readings = logits_controls(runner, WIDTH)
    # the logits leave the lm_head in bf16, so single-ulp flips near the
    # largest logit move the max-abs error in steps of ~0.8%: the check uses
    # the relative L2 error over all rows; the max-abs error is printed beside it
    top1 = float((lf.argmax(-1) == ls.argmax(-1)).float().mean())
    print(f"[main] first decode step, relative L2 error of the logits against "
          f"flatten's: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
          + f" (limit {LOGITS_LIMIT:.0e}); flatten vs seq max-abs error "
          f"{rel_err(lf, ls):.3e} of the largest logit, top-1 agreement "
          f"{top1:.3f}", flush=True)
    check(readings["seq"] < LOGITS_LIMIT,
          f"flatten and seq logits disagree: {readings['seq']}")
    check(readings["flatten+ulp noise"] < LOGITS_LIMIT,
          "one ulp of attention noise moves the logits past the limit: the "
          "check cannot tell bf16 rounding from a fault on this card")
    check(readings["flatten, block dropped"] > LOGITS_LIMIT,
          "a dropped KV block stays under the limit: the check cannot see it")
    runner.reset_state()
    runner.retain_full_logits = False

    reset_counts()
    runs = generate_both(runner, prompt, "main", sync_check=True)
    launches = read_counts()
    print(f"[main] launches during the main path: {launches}", flush=True)
    for name in ("prefill", "paged_flatten", "paged_seq"):
        check(launches[name] > 0, f"kernel {name} was never launched on the main path")
    if profile:
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            profile_decode(runner, mode, prompt, WIDTH, steps=8)
    del runner
    release()
    return launches, prompt, ids, lf, runs


def estimate_line(tag, run, smi) -> None:
    """Print a run's attention estimate: attn_mem and attn_comp of every
    step, by runs of equal steps (each one bucket), and attention_latency."""
    pm = run["pm"]
    groups = []
    for i, mc in enumerate(zip(pm.attn_mem_per_iter, pm.attn_comp_per_iter), 1):
        if groups and groups[-1][2] == mc:
            groups[-1][1] = i
        else:
            groups.append([i, i, mc])
    print(f"[attention] {tag}: attention_latency {pm.attention_latency:.3f} ms over "
          f"{len(pm.attn_comp_per_iter)} steps (attn_is_estimate "
          f"{pm.attn_is_estimate}), TPOT {pm.TPOT:.4f} ms, e2e {pm.e2e_latency:.1f} ms, "
          f"host waits {run['waits']}; attn_mem / attn_comp ms a step: "
          + "; ".join(f"steps {a}-{b} {m:.4f} / {c:.4f}" for a, b, (m, c) in groups)
          + f"; {smi}", flush=True)


def estimate_runs(runner, prompt, tag, smi, paths=("chained", "per-step")):
    """The main path's workload through tree_generate on `runner`
    (measure_attention on), flatten then seq, each along `paths`: chained
    (under set_sync_debug_mode("error"); first, so that each bucket's
    microbench runs inside it) and per-step.  Checks each run's branches
    and estimate (attn_is_estimate, every attn_comp > 0, attn_mem below
    STORE_LIMIT_MS); prints them and the seq / flatten attention speedup.
    Returns {mode: {path: generate_run's dict}}."""
    from deft_tpu_torch.control import workloads
    from deft_tpu_torch.runtime import ForwardMode
    from deft_tpu_torch.runtime.runner import bench_wait

    out = {}
    for mode_name, mode in (("flatten", ForwardMode.TREE_DECODE_FLATTEN),
                            ("seq", ForwardMode.DECODE)):
        for path in paths:
            fn = (workloads.simple_tree if path == "chained"
                  else per_step(workloads.simple_tree))
            benched = bench_wait.waits
            with sync_checked(f"{tag} {mode_name} {path}", path == "chained"):
                run = generate_run(runner, mode, prompt, fn)
            out.setdefault(mode_name, {})[path] = run
            pm, seqs = run["pm"], run["seqs"]
            check(len(seqs) == WIDTH and all(len(x) == GEN_LEN - 1 for x in seqs),
                  f"{tag} {mode_name} {path}: expected {WIDTH} branches of "
                  f"{GEN_LEN - 1} tokens")
            estimate_line(f"{tag} {mode_name} {path} (microbench waits "
                          f"{bench_wait.waits - benched}, launches {run['launches']})",
                          run, smi)
            check(pm.attn_is_estimate and pm.attention_latency > 0
                  and all(c > 0 for c in pm.attn_comp_per_iter),
                  f"{tag} {mode_name} {path}: a step without an attention estimate")
            check(pm.attention_latency <= pm.e2e_latency,
                  f"{tag} {mode_name} {path}: attention latency above e2e")
            if runner.k_pool.scale is None:
                check(max(pm.attn_mem_per_iter) < STORE_LIMIT_MS,
                      f"{tag} {mode_name} {path}: attn_mem "
                      f"{max(pm.attn_mem_per_iter):.4f} ms a step, limit {STORE_LIMIT_MS}")
    for path in paths:
        f, q = out["flatten"][path]["pm"], out["seq"][path]["pm"]
        comp = sum(q.attn_comp_per_iter) / sum(f.attn_comp_per_iter)
        print(f"[attention] {tag} {path}: attention speedup (seq / flatten "
              f"attention_latency) {q.attention_latency / f.attention_latency:.4f}x "
              f"({q.attention_latency:.3f} / {f.attention_latency:.3f} ms; attn_comp "
              f"alone {comp:.4f}x); {smi}", flush=True)
    return out


def estimate_against_profile(runner, mode, prompt, tag, smi, steps=4) -> None:
    """torch.profiler over `steps` greedy decode steps right after branching
    (profile_decode), the microbench off: the device ms a step of the
    mode's attention kernels (the port's, in the deft namespaces: a bf16
    decode step launches no other) against the runner's estimate at the
    profiled steps' buckets (attn_comp, measured now where not cached yet),
    within ESTIMATE_BAND."""
    from unittest import mock

    from deft_tpu_torch.runtime.runner import plan_sizes

    build = runner.build_plan
    plans = []

    def recording(m):
        plans.append(build(m))
        return plans[-1]

    with (mock.patch.object(runner, "build_plan", recording),
          mock.patch.object(runner, "measure_attention", False)):
        kernels, _ = profile_decode(runner, mode, prompt, WIDTH, steps)
    attn = {k: ms for k, ms in kernels.items() if "deft" in k}
    est, keys = [], []
    for plan in plans:
        paged = runner._use_paged(plan, mode)
        keys.append((paged, plan_sizes(plan, paged)))
        est.append(runner._measure_attention_bucket(mode, plan, paged)[1] * 1e3)
    est_ms, prof_ms = float(np.mean(est)), sum(attn.values())
    check(prof_ms > 0, f"{tag}: the profiler saw no attention kernel")
    ratio = est_ms / prof_ms if prof_ms > 0 else float("inf")
    print(f"[attention] {tag}: estimate attn_comp {est_ms:.4f} ms a step against "
          f"torch.profiler's attention kernels {prof_ms:.4f} ms a step ("
          + ", ".join(f"{k.split('(')[0][:60]} {ms:.4f}" for k, ms in attn.items())
          + f"; {steps} steps, buckets {sorted(set(keys))}): ratio {ratio:.4f} (band 1 +- "
          f"{ESTIMATE_BAND}); {smi}", flush=True)
    check(abs(ratio - 1) <= ESTIMATE_BAND,
          f"{tag}: the estimate {est_ms:.4f} ms is off the profiler's {prof_ms:.4f} ms "
          f"by more than {ESTIMATE_BAND:.0%}")


def bench_shape(dev, smi) -> None:
    """bench.py's shape (MODEL 3b, BLOCK_LEN 1024, prompt 4000, width 50):
    B1 and B2 at the plan the runner builds at that block length, on a
    Simple_Tree tree halfway, against their plain versions (live rows,
    bf16 tolerance; these launches leave the counts as they were); then the
    3b runner's flatten and seq runs (chained) with their estimates, the
    paged kernels launched at every step's paged plan."""
    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.loader import random_params
    from deft_tpu_torch.runtime.runner import plan_sizes

    cfg = PRESETS["3b"]
    fns = wrappers()
    counts = read_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    tree = grow_tree(PROMPT_LEN, WIDTH, GEN_LEN // 2, 16384,
                     np.random.default_rng(SEED + 19))
    for name in ("paged_flatten", "paged_seq"):
        plan, args = kernel_case(name, tree, cfg.q_per_kv, cfg.num_kv_heads, cfg.head_dim,
                                 torch.bfloat16, dev, gen, BENCH_BLOCK_LEN)
        fn, plain = fns[name]
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        rows = slice(0, plan.n_leaves)
        e = rel_err(got[rows], want[rows])
        print(f"[attention] {name} at block_len {BENCH_BLOCK_LEN} (3b: {cfg.num_q_heads}/"
              f"{cfg.num_kv_heads} heads x D {cfg.head_dim}, {plan.n_leaves} leaves, "
              f"plan {plan_sizes(plan, plan.paged)}): rel err {e:.3e}, "
              f"tol {TOL['bfloat16']:.0e}", flush=True)
        check(e < TOL["bfloat16"] and bool(torch.isfinite(got[rows]).all()),
              f"{name} at block_len {BENCH_BLOCK_LEN} disagrees with its plain version: {e}")
    del tree, args, got, want
    restore_counts(counts)

    params = random_params(cfg, SEED, dev, torch.bfloat16)
    runner = make_runner(cfg, params, dev, block_len=BENCH_BLOCK_LEN,
                         measure_attention=None)
    runner.retain_full_logits = False
    runs = estimate_runs(runner, main_prompt(), f"3b block_len {BENCH_BLOCK_LEN}", smi,
                         paths=("chained",))
    for mode_name, kernel in (("flatten", "paged_flatten"), ("seq", "paged_seq")):
        run = runs[mode_name]["chained"]
        check(run["launches"].get(kernel, 0) > 0 and sum(run["paged"]) > 0,
              f"3b block_len {BENCH_BLOCK_LEN} {mode_name}: {kernel} never launched "
              f"(paged at {sum(run['paged'])} of {len(run['paged'])} steps)")
    del runner, params
    release()


def phase_attention(dev, params, prompt, smi, main_runs=None) -> None:
    """The runner's attention estimate on the card (phase 4a in the
    module's notes).  `main_runs`: phase_main's chained runs (no estimate),
    whose flatten run's host waits the estimated chained run must equal;
    without them (--attention-only) that run is made here."""
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode

    cfg = PRESETS["8b"]
    runner = make_runner(cfg, params, dev, measure_attention=None)
    runner.retain_full_logits = False
    check(runner.measure_attention, "measure_attention's default is off on the card")
    if main_runs is None:
        runner.measure_attention = False
        with sync_checked("attention control flatten"):
            main_runs = {"flatten": generate_run(runner, ForwardMode.TREE_DECODE_FLATTEN,
                                                 prompt)}
        runner.measure_attention = True
    runs = estimate_runs(runner, prompt, "main", smi)
    waits, want = runs["flatten"]["chained"]["waits"], main_runs["flatten"]["waits"]
    print(f"[attention] main flatten chained: {waits} host waits with the estimate, "
          f"{want} without (the main phase's run)", flush=True)
    check(waits == want, f"the estimate changed the chained run's host waits: {waits} "
          f"against {want}")
    for mode_name, mode in (("flatten", ForwardMode.TREE_DECODE_FLATTEN),
                            ("seq", ForwardMode.DECODE)):
        estimate_against_profile(runner, mode, prompt, f"main {mode_name}", smi)
    del runner
    release()
    bench_shape(dev, smi)


def phase_int8(dev, params, prompt, ids, lf_bf16, profile: bool = False):
    """The main path's workload over an int8 KV cache; B4 and B5 must
    launch, B1 and B2 must not."""
    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode

    runner = make_runner(PRESETS["8b"], params, dev, kv_dtype="int8")
    check(runner.k_pool.data.dtype == torch.int8 and runner.k_pool.quantized,
          "the int8 runner's pools are not int8")
    first_step(runner, prompt, ids)
    mode = ForwardMode.TREE_DECODE_FLATTEN
    plan = runner.build_plan(mode)
    check(plan.paged, "the int8 first-step flatten plan is not paged")
    view, _ = runner.forward_tree_decode(mode, plan)
    lq = view.full_logits()[:WIDTH].float()
    err = float((lq - lf_bf16).norm() / lf_bf16.norm())
    top1 = float((lq.argmax(-1) == lf_bf16.argmax(-1)).float().mean())
    print(f"[int8] first decode step, int8 KV flatten vs bf16 KV flatten: "
          f"relative L2 error of the logits {err:.3e}, top-1 agreement {top1:.3f}, "
          f"plan seg_len {plan.seg_len}", flush=True)
    check(bool(torch.isfinite(lq).all()), "int8 first-step logits are not finite")
    runner.reset_state()
    runner.retain_full_logits = False

    reset_counts()
    generate_both(runner, prompt, "int8")
    launches = read_counts()
    print(f"[int8] launches during the int8 path: {launches}", flush=True)
    for name in ("paged_flatten_q", "paged_seq_q", "prefill"):
        check(launches[name] > 0, f"kernel {name} was never launched on the int8 path")
    for name in ("paged_flatten", "paged_seq"):
        check(launches[name] == 0, f"kernel {name} ran on the int8 path")
    if profile:
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            profile_decode(runner, mode, prompt, WIDTH, steps=8)
    del runner
    release()
    return launches, lq.cpu()


def phase_short(dev, params, profile: bool = False):
    """The CLI's default 16-token prompt, bf16 then int8 KV, flatten then
    seq: B6 must launch in both flatten runs, B7 in the bf16 seq run."""
    from unittest import mock

    from deft_tpu_torch.cli.run import make_prompt
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode

    cfg = PRESETS["8b"]
    prompt = make_prompt(None, 16 + GEN_LEN, cfg.vocab_size, SEED)
    check(len(prompt) == 16, f"the default prompt has {len(prompt)} tokens")
    runs, launches = {}, {}
    for kv in ("inherit", "int8"):
        runner = make_runner(cfg, params, dev, kv_dtype=kv, prompt_len=len(prompt))
        # first decode step, flatten against seq (bf16 pools: both plans
        # gather plans; int8 pools: seq's plan is paged from the start)
        view = runner.forward_prefill(prompt)
        _, ids = view.topk(0, WIDTH)
        runner.reset_state()
        first_step(runner, prompt, ids)
        logits, paged = {}, {}
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            plan = runner.build_plan(mode)
            paged[mode.name] = plan.paged
            check(kv == "int8" or not plan.paged,
                  f"the short prompt's first {mode.name} plan is paged")
            v, _ = runner.forward_tree_decode(mode, plan)
            logits[mode] = v.full_logits()[:WIDTH].float()
        lf, ls = logits.values()
        err = float((ls - lf).norm() / lf.norm())
        # control: each leaf's own token hidden from it in flatten mode.  A
        # leaf sees 17 tokens here, so the fault must clear the limit that
        # bf16 noise stays under (at the 4000-token step it does not)
        flatten = ForwardMode.TREE_DECODE_FLATTEN
        plan = runner.build_plan(flatten)
        attn = plan_edited(runner._attn_fn(flatten, runner._use_paged(plan)),
                           hide_own_token(WIDTH))
        with mock.patch.object(runner, "_attn_fn", lambda m, p: attn):
            v, _ = runner.forward_tree_decode(flatten, plan)
        hidden = float((v.full_logits()[:WIDTH].float() - lf).norm() / lf.norm())
        print(f"[short {kv}] first decode step (plans paged: {paged}), relative L2 error "
              f"of the logits against flatten's: seq {err:.3e}, flatten with each leaf's "
              f"own token hidden {hidden:.3e} (limit {LOGITS_LIMIT:.0e}); top-1 "
              f"agreement seq {float((lf.argmax(-1) == ls.argmax(-1)).float().mean()):.3f}",
              flush=True)
        # the main path's limit: its controls put bf16 noise well below it
        check(err < LOGITS_LIMIT, f"short {kv}: flatten and seq logits disagree: {err}")
        check(hidden > LOGITS_LIMIT, f"short {kv}: a leaf's own token hidden stays under "
              f"the limit ({hidden}): the check cannot see a one-token fault")
        runner.reset_state()
        runner.retain_full_logits = False
        reset_counts()
        runs[kv] = generate_both(runner, prompt, f"short {kv}", count_plans=True)
        for k, n in read_counts().items():
            launches[k] = launches.get(k, 0) + n
        del runner
        release()
    print(f"[short] launches during the short-prompt path (bf16 and int8 runs): "
          f"{launches}", flush=True)
    if profile:  # bf16 KV: the first 8 steps take gather plans
        runner = make_runner(cfg, params, dev, prompt_len=len(prompt))
        runner.retain_full_logits = False
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            profile_decode(runner, mode, prompt, WIDTH, steps=8)
        del runner
        release()
    for kv in ("inherit", "int8"):
        check(runs[kv]["flatten"]["launches"].get("flatten_gather", 0) > 0,
              f"flatten_gather was never launched in the {kv} short flatten run")
    check(runs["inherit"]["seq"]["launches"].get("seq_gather", 0) > 0,
          "seq_gather was never launched in the bf16 short seq run")
    for k, n in short_int8_seq(dev, params, prompt, runs["int8"]["seq"]["seqs"]).items():
        launches[k] = launches.get(k, 0) + n
    return launches


def short_int8_seq(dev, params, prompt, want) -> dict:
    """The 16-token prompt over an int8 KV cache in seq mode through
    BatchedEngine, one request: the engine's int8 rule (128-token segments
    at waste 3) leaves every step of this tree a gather seq plan, so B7
    runs over int8 pools; tree_generate's rule (waste 32) pages the same
    plans (B5, the short int8 run above).  WIDTH branches of GEN_LEN - 1
    tokens, B7 launched, B5 never; greedy ids against that run (`want`)
    printed.  Returns the run's launches."""
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request

    runner = make_runner(PRESETS["8b"], params, dev, kv_dtype="int8",
                         prompt_len=len(prompt))
    runner.retain_full_logits = False
    eng = BatchedEngine(runner, ForwardMode.DECODE)
    paged = []

    def recording_build(trees, build=eng.build_plan):
        plan = build(trees)
        paged.append(plan.paged)
        return plan

    eng.build_plan = recording_build
    req = Request(prompt, Branch_Controller(workloads.simple_tree), len(prompt) + GEN_LEN,
                  width=WIDTH, depth=1)
    reset_counts()
    eng.add_requests([req])
    steps = eng.run()
    launches = read_counts()
    seqs = [list(s.token_ids) for s in req.finished_seqs]
    same = (np.mean([a == b for x, y in zip(sorted(seqs), sorted(want))
                     for a, b in zip(x, y)]) if want else float("nan"))
    print(f"[short int8] seq through BatchedEngine: {steps} steps, plans paged at "
          f"{sum(paged)} of {len(paged)}; B7 over int8 pools (seq_gather) "
          f"{launches['seq_gather']} launches, B5 {launches['paged_seq_q']}; greedy ids "
          f"equal to the tree_generate int8 seq run's (B5) at {same:.4f} of positions "
          f"(branches sorted); launches { {k: n for k, n in launches.items() if n} }",
          flush=True)
    check(len(seqs) == WIDTH and all(len(x) == GEN_LEN - 1 for x in seqs),
          f"short int8 seq (batched engine): expected {WIDTH} branches of {GEN_LEN - 1} "
          "tokens")
    check(launches["seq_gather"] > 0 and launches["paged_seq_q"] == 0,
          f"short int8 seq (batched engine): B7 did not take the gather plans: {launches}")
    del runner
    release()
    return launches


def batch_prompts() -> list:
    """The batch path's four prompts of BATCH_LENS random token ids (seed
    SEED + 3)."""
    from deft_tpu_torch.models import PRESETS

    rng = np.random.default_rng(SEED + 3)
    return [[int(t) for t in rng.integers(4, PRESETS["8b"].vocab_size - 4, n)]
            for n in BATCH_LENS]


def batch_admission(runner, prompts, tag, limit):
    """Each of `prompts` alone (its prefill, B3, and its first decode step
    of WIDTH leaves on its top-WIDTH tokens), then all of them through one
    ragged prefill (B8: once a layer, B3 never) and one multi-tree step
    whose leaves carry the alone runs' branch tokens: each request's
    prefill logits and first-step rows against its alone run's, relative
    L2 below `limit`; B8's output in the first and last layers against its
    plain version on the same inputs, within TOL.  Returns the ragged
    prefill's last-token logits, (n, V) fp32 on the host."""
    from unittest import mock

    import torch
    from deft_tpu_torch.core import TreeCache
    from deft_tpu_torch.ops import attn_impls
    from deft_tpu_torch.ops.prefill import ragged_prefill_attention_plain
    from deft_tpu_torch.runtime import ForwardMode
    from deft_tpu_torch.runtime.batched import BatchedEngine

    flatten = ForwardMode.TREE_DECODE_FLATTEN
    alone = []
    for p in prompts:
        runner.reset_state()
        view = runner.forward_prefill(p)
        _, ids = view.topk(0, WIDTH)
        tree = runner.tree
        for c, child in enumerate(tree.branch(tree.root, WIDTH)):
            child.append_token(int(ids[c]))
        tree.alloc()
        v, _ = runner.forward_tree_decode(flatten, runner.build_plan(flatten))
        alone.append((view.full_logits()[0].float(), ids, v.full_logits()[:WIDTH].float()))
    runner.reset_state()

    # the first and last layers' B8 outputs against its plain version on the
    # same inputs: the served shapes, prompts starting inside 64-token tiles
    L, held = runner.cfg.num_layers, {}
    attn = attn_impls.ragged_prefill_attn

    def holding(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
        o = attn(q, k_new, v_new, k_pool, v_pool, li, batch, scale)
        if li in (0, L - 1):
            held[li] = rel_err(o, ragged_prefill_attention_plain(q, k_new, v_new,
                                                                 batch.seg_ids, scale))
        return o

    trees = [TreeCache(runner.token_to_kv_pool, runner.req_to_token_pool)
             for _ in prompts]
    reset_counts()
    with mock.patch.object(attn_impls, "ragged_prefill_attn", holding):
        view = runner.forward_prefill_batch(prompts, trees)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["ragged_prefill"] == L and counts["prefill"] == 0,
          f"{tag}: one ragged prefill launched {counts}")
    starts = [int(x) for x in np.cumsum([0] + [len(p) for p in prompts[:-1]])]
    print(f"[{tag}] B8 in the admission ({sum(map(len, prompts))} tokens, prompts from "
          f"tokens {starts}, {[x % 64 for x in starts]} into a 64-token tile) "
          f"against its plain version, max error relative to the largest output: "
          + ", ".join(f"layer {li} {e:.3e}" for li, e in sorted(held.items()))
          + f" (tolerance {TOL['bfloat16']:.0e})", flush=True)
    check(all(e < TOL["bfloat16"] for e in held.values()),
          f"{tag}: B8 in the admission strays from its plain version: {held}")
    for t, (_, ids, _) in zip(trees, alone):
        for c, child in enumerate(t.branch(t.root, WIDTH)):
            child.append_token(int(ids[c]))
        t.alloc()
    plan = BatchedEngine(runner, flatten).build_plan(trees)
    v, _ = runner.forward_tree_decode(flatten, plan)
    step_logits = v.full_logits().float()
    for i, (lp, _, lf) in enumerate(alone):
        lb = step_logits[plan.leaf_offsets[i]:plan.leaf_offsets[i] + WIDTH]
        e_pre = rel_l2(view.full_logits()[i].float(), lp)
        e_dec = rel_l2(lb, lf)
        top1 = float((lb.argmax(-1) == lf.argmax(-1)).float().mean())
        print(f"[{tag}] request {i} (prompt {len(prompts[i])}): relative L2 against "
              f"alone, ragged prefill (B8) vs prefill (B3) {e_pre:.3e}, first "
              f"multi-tree step (plan paged={plan.paged}) vs alone {e_dec:.3e} "
              f"(limit {limit:.0e}); top-1 agreement {top1:.3f}, "
              f"prefill top-1 {int(view.ids[i, 0]) == int(lp.argmax())}", flush=True)
        check(e_pre < limit, f"{tag} request {i}: ragged prefill logits {e_pre}")
        check(e_dec < limit, f"{tag} request {i}: first batched step logits {e_dec}")
    for t in trees:
        t.free()
    runner.reset_state()
    return view.full_logits().float().cpu()


def batch_engine(runner, prompts, tag, paged_kernels=True):
    """BatchedEngine.add_requests + run() over `prompts` (each a width-50
    Simple_Tree of GEN_LEN tokens), flatten then seq, each on a fresh pool:
    B8 once a layer and B3 never in the admission, every request WIDTH
    branches of GEN_LEN - 1 tokens, a decode kernel of the mode's side
    (FLATTEN_SIDE / SEQ_SIDE) launched; with paged_kernels=False (heads
    that do not pack) B6 or B7 launched and B1/B2/B4/B5 never.  Returns
    (the runs' launches summed, {mode: (each request's branches, KV tokens
    read)}, {mode: each step's plan.paged})."""
    import torch
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.runtime import ForwardMode
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request

    launches, out, layouts = {}, {}, {}
    for mode_name, mode in (("flatten", ForwardMode.TREE_DECODE_FLATTEN),
                            ("seq", ForwardMode.DECODE)):
        # a fresh pool for each mode: the slots the previous run's requests
        # freed come back scattered, and prompts laid on them are not
        # segment-aligned, which sends every step to the gather kernels
        runner.reset_state()
        eng = BatchedEngine(runner, mode)
        plans = []

        def recording_build(trees, build=eng.build_plan):
            plans.append(build(trees))
            return plans[-1]

        eng.build_plan = recording_build
        reqs = [Request(p, Branch_Controller(workloads.simple_tree), len(p) + GEN_LEN,
                        width=WIDTH, depth=1) for p in prompts]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.add_requests(reqs)
        torch.cuda.synchronize()
        t_adm = time.perf_counter() - t0
        steps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        seqs = [[list(s.token_ids) for s in r.finished_seqs] for r in reqs]
        check(all(len(b) == WIDTH and all(len(x) == GEN_LEN - 1 for x in b) for b in seqs),
              f"{tag} {mode_name}: expected {WIDTH} branches of {GEN_LEN - 1} tokens "
              "per request")
        tok = sum(len(x) for b in seqs for x in b)
        paged = sum(p.paged for p in plans)
        kv = sum(p.n_tokens if mode_name == "flatten" else p.total_kv for p in plans)
        moved = {k: n for k, n in counts.items() if n}
        print(f"[{tag}] {mode_name}: admission (one ragged prefill of "
              f"{sum(map(len, prompts))} tokens + root branching) {t_adm * 1e3:.3f} ms, "
              f"{steps} steps, {tok} generated tokens in {wall * 1e3:.1f} ms, "
              f"{wall * 1e3 / tok:.4f} ms/token aggregate; plans paged at {paged} "
              f"of {len(plans)} steps (gather at {len(plans) - paged}); "
              f"launches {moved}", flush=True)
        check(counts["ragged_prefill"] == runner.cfg.num_layers,
              f"{tag} {mode_name}: B8 launched {counts['ragged_prefill']} times, "
              f"not once a layer")
        check(counts["prefill"] == 0, f"{tag} {mode_name}: B3 ran on the batch path")
        side = FLATTEN_SIDE if mode_name == "flatten" else SEQ_SIDE
        check(any(counts[k] for k in side),
              f"{tag} {mode_name}: no kernel of {side} launched")
        check(paged_kernels or (counts[side[-1]] > 0 and not any(counts[k]
                                                                  for k in side[:-1])),
              f"{tag} {mode_name}: heads that do not pack ran {moved}, not {side[-1]} alone")
        out[mode_name] = (seqs, kv)
        layouts[mode_name] = [p.paged for p in plans]
    print(f"[{tag}] kv_io_reduction (seq KV tokens read / flatten's, over the "
          f"run's plans) {out['seq'][1] / out['flatten'][1]:.4f}", flush=True)
    return launches, out, layouts


def batch_runner(cfg, params, dev, kv_dtype="inherit"):
    """A runner of the batch path's pools (BATCH_SLOTS) and requests."""
    return make_runner(cfg, params, dev, kv_dtype=kv_dtype, prompt_len=max(BATCH_LENS),
                       slots=BATCH_SLOTS, max_requests=4 * (WIDTH + 2))


def phase_batch(dev, params, profile: bool = False):
    """Four requests with distinct prompts (BATCH_LENS), each a width-50
    Simple_Tree: each alone, then all four through one ragged prefill (B8)
    and one multi-tree step on the same branch tokens, held against the
    alone runs (batch_admission); then BatchedEngine.add_requests + run()
    in flatten and in seq (batch_engine); then the same engine runs over
    an int8 KV cache on the same weights (batch_int8).  Returns the launch
    counts of the engine runs, summed, and {mode: (each request's branches,
    KV tokens read)} of the bf16 runs, with "admission": the ragged
    prefill's last-token logits, (4, V) fp32 on the host."""
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.obs import PerfMetrics
    from deft_tpu_torch.runtime import ForwardMode, tree_generate

    cfg = PRESETS["8b"]
    prompts = batch_prompts()
    runner = batch_runner(cfg, params, dev)
    out = {"admission": batch_admission(runner, prompts, "batch", LOGITS_LIMIT)}
    runner.retain_full_logits = False
    launches, runs, _ = batch_engine(runner, prompts, "batch")
    out.update(runs)

    # greedy ids of the flatten engine against each request alone, printed
    # and not held: the batched step's matmuls run at 256 rows, not 64, so
    # cuBLAS rounds every layer differently, and bf16 near-ties flip tokens
    # (PERF.md).  Branches are matched by sorting: a near-tie in the
    # prefill's top-50 reorders the root's children, so the i-th branch of
    # one run need not start with the i-th branch's token of the other
    flatten = ForwardMode.TREE_DECODE_FLATTEN
    same, whole = [], 0
    for p, got in zip(prompts, out["flatten"][0]):
        runner.reset_state()
        tree_generate(runner, flatten, None, p, max_seq_len=len(p) + GEN_LEN,
                      width=WIDTH, depth=1,
                      branch_controller=Branch_Controller(workloads.simple_tree),
                      perf_metrics=PerfMetrics())
        want = [list(s.token_ids) for s in runner.tree.all_finished_seqs]
        same += [a == b for x, y in zip(sorted(got), sorted(want)) for a, b in zip(x, y)]
        whole += sum(x in want for x in got)
    print(f"[batch] flatten engine vs each request alone: greedy ids equal at "
          f"{np.mean(same):.4f} of positions (branches sorted), {whole} of "
          f"{len(prompts) * WIDTH} branches identical", flush=True)
    print(f"[batch] launches during the batch path (both engine runs): {launches}",
          flush=True)
    if profile:
        profile_batch(runner, prompts, WIDTH, steps=8)
    del runner
    release()
    for k, n in batch_int8(dev, params, prompts).items():
        launches[k] = launches.get(k, 0) + n
    return launches, out


def batch_int8(dev, params, prompts) -> dict:
    """The batch path's four requests through BatchedEngine over an int8 KV
    cache (the 8B's `params`), flatten then seq, gated as the bf16 runs
    are; B6 over int8 pools must launch on the multi-tree gather plans.
    The engine's int8 rule (128-token segments at waste 3) pages some
    flatten steps: those run B4, counted and not gated.  Returns the
    runs' launches."""
    import torch
    from deft_tpu_torch.models import PRESETS

    runner = batch_runner(PRESETS["8b"], params, dev, kv_dtype="int8")
    check(runner.k_pool.data.dtype == torch.int8,
          "the batch int8 runner's pools are not int8")
    runner.retain_full_logits = False
    launches, _, layouts = batch_engine(runner, prompts, "batch int8")
    flat = layouts["flatten"]
    print(f"[batch int8] multi-tree flatten plans paged at {sum(flat)} of {len(flat)} "
          f"steps: B4 (paged_flatten_q) {launches['paged_flatten_q']} launches on one "
          f"card, B6 over int8 pools (flatten_gather) {launches['flatten_gather']}; seq "
          f"B5 {launches['paged_seq_q']}, B7 {launches['seq_gather']}", flush=True)
    check(launches["flatten_gather"] > 0,
          "batch int8: B6 over int8 pools never launched on the multi-tree gather plans")
    check(launches["paged_flatten"] == 0 and launches["paged_seq"] == 0,
          f"batch int8: a bf16-pool paged kernel ran: {launches}")
    del runner
    release()
    return launches


# -- the workloads phase: every workload and decode mode on the card ------------------

# W1-W5's runner: the random tree reaches 200 leaves and about twice as many
# live nodes, each holding a request row; the tree-index pool takes a row a
# node too
WL_REQUESTS = 1024
# SamplingParams of the sampled Simple_Tree run (W5)
SAMPLED = dict(temperature=0.8, top_p=0.95, top_k=50)


@contextlib.contextmanager
def midrun_hold(runner, held):
    """While a flatten-mode generation runs on `runner`: hold the first step
    after the tree's first structural event (a branch, a prune or a merge
    since the step before), and the first step after it whose flatten plan
    is a gather plan if that comes later, with logits_controls(midrun=True):
    seq against flatten on the same tree and pools, beside the noise and
    dropped-block controls.  The holds' launches, lm_head products and host
    waits are taken back out of the run's counts, and the holds may wait
    for the card inside a sync_checked run.  Appends one dict a hold to
    `held`."""
    import functools
    from unittest import mock

    from deft_tpu_torch.runtime.runner import ModelRunner, host_wait

    forward = runner.forward_tree_decode
    last = {"sig": None, "event": False, "step": 0}

    def hooked(mode, plan, **kw):
        tree = runner.tree
        # the live leaves and the KV of the inner nodes: appends to leaves
        # leave both alone, branches, prunes and merges do not
        sig = (tuple(tree.leaves),
               sum(n.kv_len for n in tree.nodes.values() if n.children))
        last["event"] |= last["sig"] is not None and sig != last["sig"]
        last["sig"] = sig
        last["step"] += 1
        gather_held = any(not h["paged"] for h in held)
        if last["event"] and (not held or (not plan.paged and not gather_held)):
            saved, heads, retain = read_counts(), LM_HEADS[0], runner.retain_full_logits
            waits = host_wait.waits
            runner.retain_full_logits = True
            try:
                with (mock.patch.object(runner, "build_plan", functools.partial(
                          ModelRunner.build_plan, runner)),
                      mock.patch.object(runner, "forward_tree_decode", forward),
                      sync_allowed()):
                    lf, ls, readings = logits_controls(runner, plan.n_leaves,
                                                       midrun=True)
                    top1 = float((lf.argmax(-1) == ls.argmax(-1)).float().mean())
            finally:
                runner.retain_full_logits = retain
                restore_counts(saved)
                LM_HEADS[0] = heads
                host_wait.waits = waits
            held.append({"step": last["step"], "paged": plan.paged,
                         "leaves": plan.n_leaves, "readings": readings, "top1": top1})
        return forward(mode, plan, **kw)

    with mock.patch.object(runner, "forward_tree_decode", hooked):
        yield


@contextlib.contextmanager
def merge_watch(runner, records):
    """While it is open, each apply_kv_copies that has queued merge copies
    (speculative decoding's accepts) appends (tree, the root's KV length,
    copies, rows equal): the copied K and V rows of every layer read back
    from the pools equal their sources as they were before the copy (these
    reads may wait for the card inside a sync_checked run; the copy may
    not)."""
    from unittest import mock

    import torch

    apply = runner.apply_kv_copies

    def watched(tree=None):
        t = tree if tree is not None else runner.tree
        if not t.pending_kv_copies:
            return apply(tree)
        with sync_allowed():
            src, dst = (torch.from_numpy(np.concatenate(a).astype(np.int64))
                        .to(runner.device) for a in zip(*t.pending_kv_copies))
            want = [p.data.index_select(1, src) for p in (runner.k_pool, runner.v_pool)]
        apply(tree)
        with sync_allowed():
            same = all(torch.equal(p.data.index_select(1, dst), w)
                       for p, w in zip((runner.k_pool, runner.v_pool), want))
        records.append((t, t.root.kv_len, len(src), same))

    with mock.patch.object(runner, "apply_kv_copies", watched):
        yield


def check_accepts(tag, records, accepted, prompt_len):
    """A speculative run's merge records (merge_watch, one tree) against its
    accept schedule: iteration k >= 1 merges accepted[k] leaves, so the
    k-th copy batch moves accepted[k] rows and leaves the root at
    prompt_len + accepted[1] + ... + accepted[k] tokens."""
    grown = list(prompt_len + np.cumsum(accepted[1:]))
    got = [(kv, n) for _, kv, n, _ in records]
    check(got == list(zip(grown, accepted[1:])),
          f"{tag}: merges (root KV, copies) {got[:6]}... against the schedule "
          f"{list(zip(grown, accepted[1:]))[:6]}...")
    check(all(same for *_, same in records),
          f"{tag}: a merge copy's rows differ from their source")


def workload_line(tag, run, smi):
    """One [workloads] line: TTFT, TPOT, launches, peak memory, the card."""
    pm = run["pm"]
    check(np.isfinite(pm.TPOT) and pm.TPOT > 0, f"{tag}: bad TPOT")
    paged = run["paged"]
    print(f"[workloads] {tag}: TTFT {pm.TTFT:.3f} ms, TPOT {pm.TPOT:.4f} ms, "
          f"{len(paged)} steps (plans paged at {sum(paged)}), generated "
          f"{pm.generated_len}, {len(run['seqs'])} branches, KV_IO {pm.KV_IO:.4e} B; "
          f"launches {run['launches']} (B6 {run['launches'].get('flatten_gather', 0)}, "
          f"B7 {run['launches'].get('seq_gather', 0)}); peak "
          f"{run['peak_gb']:.2f} GB; {smi}", flush=True)


FLATTEN_SIDE = ("paged_flatten", "paged_flatten_q", "flatten_gather")
SEQ_SIDE = ("paged_seq", "paged_seq_q", "seq_gather")


def check_side(tag, launches, side):
    """The run launched a decode kernel of `side` ("flatten" or "seq") and
    none of the other side's."""
    mine, other = ((FLATTEN_SIDE, SEQ_SIDE) if side == "flatten"
                   else (SEQ_SIDE, FLATTEN_SIDE))
    check(sum(launches.get(k, 0) for k in mine) > 0,
          f"{tag}: none of {mine} launched")
    check(not any(launches.get(k, 0) for k in other),
          f"{tag}: {other} launched in a {side} run: {launches}")


def check_holds(tag, held):
    """midrun_hold's readings, each against LOGITS_LIMIT."""
    check(held, f"{tag}: no structural event, so no mid-run step was held")
    for h in held:
        r = h["readings"]
        print(f"[workloads] {tag} mid-run step {h['step']} ({h['leaves']} leaves, "
              f"flatten plan {'paged' if h['paged'] else 'gather'}): relative L2 "
              f"error of the logits against flatten's: "
              + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
              + f" (limit {LOGITS_LIMIT:.0e}); top-1 agreement seq {h['top1']:.3f}",
              flush=True)
        check(r["seq"] < LOGITS_LIMIT, f"{tag}: mid-run seq logits {r['seq']}")
        check(r["flatten+ulp noise"] < LOGITS_LIMIT,
              f"{tag}: mid-run ulp noise {r['flatten+ulp noise']} above the limit")
        check(r["flatten, block dropped"] > LOGITS_LIMIT,
              f"{tag}: mid-run dropped block {r['flatten, block dropped']} under "
              "the limit")
    if all(h["paged"] for h in held):
        print(f"[workloads] {tag}: every flatten plan after the first structural "
              "event was segment-aligned (no gather plan to hold)", flush=True)


def peak_run(runner, *args, **kw):
    """generate_run with the run's peak device memory ("peak_gb")."""
    import torch

    torch.cuda.reset_peak_memory_stats(runner.device)
    run = generate_run(runner, *args, **kw)
    run["peak_gb"] = torch.cuda.max_memory_allocated(runner.device) / 1e9
    return run


def workload_pair(runner, prompt, tag, fn, template, smi, watch=False,
                  sync_check=False):
    """Workload `fn` in flatten (with midrun_hold) then seq mode (under
    sync_checked with `sync_check`); each run launches its own side's
    decode kernels only.  Returns {mode: generate_run's dict, with
    "peak_gb", the holds ("held") and, with watch=True, merge_watch's
    records ("merges")}."""
    from deft_tpu_torch.runtime import ForwardMode

    out = {}
    for mode_name, mode in (("flatten", ForwardMode.TREE_DECODE_FLATTEN),
                            ("seq", ForwardMode.DECODE)):
        held, merges = [], []
        with (midrun_hold(runner, held) if mode_name == "flatten"
              else contextlib.nullcontext()), \
             (merge_watch(runner, merges) if watch else contextlib.nullcontext()), \
             sync_checked(f"{tag} {mode_name}", sync_check):
            run = out[mode_name] = peak_run(runner, mode, prompt, fn, template)
        run["held"], run["merges"] = held, merges
        workload_line(f"{tag} {mode_name}", run, smi)
        check_side(f"{tag} {mode_name}", run["launches"], mode_name)
        if mode_name == "flatten":
            check_holds(f"{tag} {mode_name}", held)
    return out


def with_chunk(ecfg, chunk):
    """ecfg with attention.node_chunk_len = chunk (node_chunk mode)."""
    import dataclasses

    return dataclasses.replace(ecfg, attention=dataclasses.replace(
        ecfg.attention, node_chunk_len=chunk))


def first_step_against_flatten(runner, tag, modes, lf, block_dropped):
    """The first decode step of the runner's current tree in each of `modes`
    ({name: (mode, node_chunk_len)}) against flatten's logits lf, below
    LOGITS_LIMIT; block_dropped, the dropped-block control's reading at the
    same step, above it."""
    check(block_dropped > LOGITS_LIMIT,
          f"{tag}: a dropped block reads {block_dropped}, under the limit")
    ecfg = runner.ecfg
    for name, (mode, chunk) in modes.items():
        runner.ecfg = with_chunk(ecfg, chunk)
        plan = runner.build_plan(mode)
        v, _ = runner.forward_tree_decode(mode, plan)
        runner.ecfg = ecfg
        lm = v.full_logits()[:WIDTH].float()
        err = float((lm - lf).norm() / lf.norm())
        size = (f"paths padded to {plan.c_pad}" if mode.is_sequential
                else f"{plan.t_pad} plan tokens")
        print(f"[workloads] {tag} first decode step, {name} (plan paged={plan.paged}, "
              f"{size}): relative L2 error of the logits against "
              f"flatten's {err:.3e}, the dropped-block control {block_dropped:.3e} "
              f"(limit {LOGITS_LIMIT:.0e}); top-1 agreement "
              f"{float((lm.argmax(-1) == lf.argmax(-1)).float().mean()):.3f}",
              flush=True)
        check(err < LOGITS_LIMIT, f"{tag}: {name} first-step logits {err}")


def phase_workloads(dev, params, prompt, smi, profile: bool = False):
    """Every workload and decode mode through tree_generate on the main
    path's settings (Llama-3.1-8B, prompt 4000, 64 tokens, block_len 256):
    W1 Practical_Tree on the CLI's synthetic ToT template, W2
    Speculative_Decoding on its synthetic token tree, W3 Beam_Search, W4
    Random_Tree, each flatten then seq, with a mid-run step held (seq
    against flatten, with controls); W1, W2 and W4, which chain their
    steps on the device, under sync_checked; W5 sampled Simple_Tree twice
    from one seed; W6 Simple_Tree in node, node_chunk, tree_index and the
    unpaged modes, Medusa among them, then node over int8 KV; W7 four
    Speculative_Decoding requests through BatchedEngine.  Returns the
    launches of every run, summed, and {tag: workload_pair's dict} of W1,
    W2 and W4 (the chain phase's chained runs), and of W3 and W4 the
    flatten run's gather plan halfway through its gather steps, beside its
    slots, gather steps and B6 launches (workload_gather_cases)."""
    import functools
    from unittest import mock

    from deft_tpu_torch.plan.flatten import FlattenPlan

    from deft_tpu_torch.control import workloads
    from deft_tpu_torch.data import generate_accepted_len_list
    from deft_tpu_torch.data.synthetic import synth_spec_tree, synth_tot_tree
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode, mode_from_cli
    from deft_tpu_torch.runtime.sampling import SamplingParams

    cfg = PRESETS["8b"]
    flatten = ForwardMode.TREE_DECODE_FLATTEN
    total, chained = {}, {}

    def add(run):
        for k, n in run["launches"].items():
            total[k] = total.get(k, 0) + n

    gathers, plans = {}, []

    def keeping_gathers():
        """runner.build_plan keeping each flatten gather plan, by step."""
        build, step = runner.build_plan, [0]
        plans.clear()

        def keep(m):
            plan = build(m)
            step[0] += 1
            if m is flatten and isinstance(plan, FlattenPlan) and not plan.paged:
                plans.append((step[0], plan))
            return plan
        return mock.patch.object(runner, "build_plan", keep)

    def gather_case(tag, runs):
        b6 = runs["flatten"]["launches"].get("flatten_gather", 0)
        if not plans:  # a workload whose plans all came out segment-aligned
            print(f"[workloads] {tag} flatten: no gather plan, {b6} B6 launches",
                  flush=True)
            return
        step, plan = plans[len(plans) // 2]
        gathers[tag] = (step, plan, runner.token_to_kv_pool.size, len(plans), b6)

    runner = make_runner(cfg, params, dev, slots=BATCH_SLOTS, max_requests=WL_REQUESTS,
                         use_tree_index=True)
    runner.retain_full_logits = False

    # W1: the CLI's synthetic ToT template at --max_width 50
    tot = synth_tot_tree(seed=SEED, width=4, max_leaves=WIDTH, total_iters=GEN_LEN - 1)
    runs = chained["W1 tot"] = workload_pair(runner, prompt, "W1 tot",
                                             workloads.practical_tree, tot, smi,
                                             sync_check=True)
    for r in runs.values():
        add(r)
    lens = {m: sorted(len(x) for x in r["seqs"]) for m, r in runs.items()}
    check(lens["flatten"] == lens["seq"] and lens["flatten"],
          f"W1 tot: finished lengths differ between the modes: {lens}")

    # W2: the synthetic token tree and its accept schedule
    spec = synth_spec_tree(token_tree_size=WIDTH, gen_len=GEN_LEN - 1, seed=SEED)
    generate_accepted_len_list(GEN_LEN, spec, seed=SEED)
    acc = spec.accepted_len_list
    runs = chained["W2 spec"] = workload_pair(runner, prompt, "W2 spec",
                                              workloads.speculative_decoding, spec,
                                              smi, watch=True, sync_check=True)
    for m, r in runs.items():
        add(r)
        check_accepts(f"W2 spec {m}", r["merges"], acc, len(prompt))
        check(len(r["seqs"]) == WIDTH, f"W2 spec {m}: {len(r['seqs'])} branches")
        print(f"[workloads] W2 spec {m}: {len(r['merges'])} merge batches applied "
              f"({sum(n for _, _, n, _ in r['merges'])} rows, each read back equal "
              f"to its source), root KV {len(prompt)} -> {r['merges'][-1][1]} "
              f"tokens by the schedule {acc}; lm_head products {r['lm_head']} "
              f"(the prefill's; {len(r['paged'])} decode steps skip it)", flush=True)
        check(r["lm_head"] == 1, f"W2 spec {m}: {r['lm_head']} lm_head products, "
              "expected the prefill's alone")

    # W3: beam search, width 50
    with keeping_gathers():
        runs = workload_pair(runner, prompt, "W3 beam", workloads.beam_search, None, smi)
    gather_case("W3 beam", runs)
    for m, r in runs.items():
        add(r)
        check(all(n == WIDTH for n in r["leaves"]) and len(r["seqs"]) == WIDTH,
              f"W3 beam {m}: live leaves {sorted(set(r['leaves']))}, "
              f"{len(r['seqs'])} finished")

    # W4: random tree, seed 0
    with keeping_gathers():
        runs = chained["W4 random"] = workload_pair(runner, prompt, "W4 random",
                                                    workloads.random_tree, None, smi,
                                                    sync_check=True)
    gather_case("W4 random", runs)
    for r in runs.values():
        add(r)
    lens = {m: sorted(len(x) for x in r["seqs"]) for m, r in runs.items()}
    check(lens["flatten"] == lens["seq"]
          and runs["flatten"]["leaves"] == runs["seq"]["leaves"],
          "W4 random: the branch/prune schedule differs between the modes")
    print(f"[workloads] W4 random: live leaves by step {runs['flatten']['leaves']}",
          flush=True)

    # W5: sampled Simple_Tree, twice from RandomState(0)
    sampled = functools.partial(workloads.simple_tree,
                                sampling_params=SamplingParams(**SAMPLED))
    seqs = []
    for i in range(2):
        r = peak_run(runner, flatten, prompt, sampled, rng=np.random.RandomState(SEED))
        add(r)
        workload_line(f"W5 sampled run {i + 1}", r, smi)
        check(len(r["seqs"]) == WIDTH and all(len(x) == GEN_LEN - 1 for x in r["seqs"]),
              f"W5 sampled: expected {WIDTH} branches of {GEN_LEN - 1} tokens")
        seqs.append(r["seqs"])
    parted = [(j, next(i for i, (a, b) in enumerate(zip(x, y)) if a != b))
              for j, (x, y) in enumerate(zip(*seqs)) if x != y]
    print(f"[workloads] W5 sampled {SAMPLED}: the two runs' tokens "
          f"{'equal' if not parted else 'part'}"
          + (f"; first at token {min(p for _, p in parted)} "
             f"(branches {[j for j, _ in parted][:8]})" if parted else ""), flush=True)
    check(not parted, "W5 sampled: two runs from one seed gave other tokens")

    if profile:
        profile_generate(runner, flatten, prompt, workloads.practical_tree, tot, 48, 8,
                         "W1 tot, TREE_DECODE_FLATTEN, steps 48-55, prompt 4000, bf16 KV")
        profile_generate(runner, flatten, prompt, workloads.speculative_decoding, spec,
                         8, 8, "W2 spec, TREE_DECODE_FLATTEN, steps 8-15, prompt 4000, "
                         "bf16 KV")

    # W6: the other decode modes, first step against flatten, then a run each
    modes = {"node": (mode_from_cli("node"), None),
             "node_chunk": (mode_from_cli("node_chunk"), 256),
             "tree_index": (mode_from_cli("tree_index"), None),
             "unpaged flatten": (mode_from_cli("flatten", "unpaged"), None),
             "unpaged node": (mode_from_cli("node", "unpaged"), None),
             "unpaged seq": (mode_from_cli("seq", "unpaged"), None),
             "unpaged tree (Medusa)": (mode_from_cli("tree", "unpaged"), None)}
    runner.retain_full_logits = True
    view = runner.forward_prefill(prompt)
    _, ids = view.topk(0, WIDTH)
    runner.reset_state()
    first_step(runner, prompt, ids)
    lf, _, readings = logits_controls(runner, WIDTH)
    first_step_against_flatten(runner, "W6", modes, lf,
                               readings["flatten, block dropped"])
    runner.reset_state()
    runner.retain_full_logits = False
    ecfg = runner.ecfg
    for name, (mode, chunk) in modes.items():
        runner.ecfg = with_chunk(ecfg, chunk)
        r = peak_run(runner, mode, prompt, gen_len=W6_GEN)
        add(r)
        workload_line(f"W6 {name}", r, smi)
        check(len(r["seqs"]) == WIDTH and all(len(x) == W6_GEN - 1 for x in r["seqs"]),
              f"W6 {name}: expected {WIDTH} branches of {W6_GEN - 1} tokens")
        if mode is ForwardMode.UNPAGED_MEDUSA:
            check(not any(r["launches"].get(k, 0) for k in FLATTEN_SIDE + SEQ_SIDE),
                  f"W6 {name}: a decode kernel launched: {r['launches']}")
        else:
            check_side(f"W6 {name}", r["launches"],
                       "seq" if mode.is_sequential else "flatten")
    del runner
    release()

    # W6, int8 KV: node against flatten on the first step, then a node run
    runner = make_runner(cfg, params, dev, kv_dtype="int8")
    first_step(runner, prompt, ids)
    lf, _, readings = logits_controls(runner, WIDTH)
    first_step_against_flatten(runner, "W6 int8", {"node": modes["node"]},
                               lf, readings["flatten, block dropped"])
    runner.reset_state()
    runner.retain_full_logits = False
    r = peak_run(runner, modes["node"][0], prompt, gen_len=W6_GEN)
    add(r)
    workload_line("W6 node, int8 KV", r, smi)
    check_side("W6 node, int8 KV", r["launches"], "flatten")
    check(not r["launches"].get("paged_flatten"), "W6 node, int8 KV: B1 launched")
    del runner
    release()

    add({"launches": phase_batch_spec(dev, params, spec, smi)})
    print(f"[workloads] launches during the workloads phase (every run): {total}",
          flush=True)
    return total, chained, gathers


def workload_gather_cases(dev, gathers, shapes) -> None:
    """B6 (flatten_gather, bf16 pools) at the W3 and W4 gather plans that
    phase_workloads kept, the 8B's heads (Hq 32, Hkv 8, D 128), random q and
    pools of the runner's slots: checked against its plain version on the
    live rows, then added to `shapes` for the timing phase's rows."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    fn, plain = wrappers()["flatten_gather"]
    for tag, (step, plan, slots, steps, b6) in gathers.items():
        args = plan_args("flatten_gather", plan, slots, 4, 8, 128, torch.bfloat16, dev,
                         gen, "inherit")
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        live = slice(0, plan.n_leaves)
        e = rel_err(got[live], want[live])
        label = f"{tag}, step {step} of prompt {PROMPT_LEN}"
        print(f"[kernels] flatten_gather {label} ({plan.n_leaves} leaves, {plan.n_tokens} "
              f"plan tokens, {plan.num_blocks} blocks; the flatten run's {steps} gather "
              f"steps launched B6 {b6} times): rel err {e:.3e}, tol "
              f"{TOL['bfloat16']:.0e}", flush=True)
        check(e < TOL["bfloat16"] and bool(torch.isfinite(got[live]).all()),
              f"flatten_gather {label} disagrees with its plain version: {e}")
        shapes["flatten_gather"].append((label, plan, args))


def phase_batch_spec(dev, params, spec, smi):
    """W7: four Speculative_Decoding requests (the batch path's prompts,
    the W2 template) admitted by one ragged prefill (B8) and run by
    BatchedEngine in flatten mode; each request's merges follow its accept
    schedule.  Returns the run's launches."""
    import torch
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request

    cfg = PRESETS["8b"]
    prompts = batch_prompts()
    runner = make_runner(cfg, params, dev, prompt_len=max(BATCH_LENS),
                         slots=BATCH_SLOTS, max_requests=4 * (WIDTH + 2))
    runner.retain_full_logits = False
    eng = BatchedEngine(runner, ForwardMode.TREE_DECODE_FLATTEN)
    reqs = [Request(p, Branch_Controller(workloads.speculative_decoding),
                    len(p) + GEN_LEN, width=WIDTH, depth=1, template=spec)
            for p in prompts]
    merges = []
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with merge_watch(runner, merges):
        t0 = time.perf_counter()
        eng.add_requests(reqs)
        torch.cuda.synchronize()
        t_adm = time.perf_counter() - t0
        admission = read_counts()
        steps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: n for k, n in read_counts().items() if n}
    for i, req in enumerate(reqs):
        check_accepts(f"W7 batch-spec request {i}",
                      [m for m in merges if m[0] is req.tree],
                      spec.accepted_len_list, len(req.prompt_ids))
    tok = sum(len(x.token_ids) for r in reqs for x in r.finished_seqs)
    print(f"[workloads] W7 batch-spec: admission (one ragged prefill of "
          f"{sum(BATCH_LENS)} tokens + root branching) {t_adm * 1e3:.3f} ms, "
          f"B8 {admission['ragged_prefill']} launches there; {steps} steps, "
          f"{len(merges)} merge batches ({sum(n for _, _, n, _ in merges)} rows) "
          f"applied, each request's root grown by its accept schedule "
          f"({sum(spec.accepted_len_list[1:])} tokens a request); {tok} "
          f"branch tokens in {wall * 1e3:.1f} ms; launches {counts}; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; {smi}", flush=True)
    check(admission["ragged_prefill"] == cfg.num_layers and counts.get("prefill", 0) == 0,
          f"W7: B8 launched {admission['ragged_prefill']} times at admission, B3 "
          f"{counts.get('prefill', 0)}")
    check(all(len(r.finished_seqs) == WIDTH for r in reqs),
          "W7: a request did not finish its branches")
    check_side("W7 batch-spec", counts, "flatten")
    del runner, eng
    release()
    return counts


# -- the chain phase: per-step against device-chained decode ------------------------

def chain_line(tag, path, run, smi, extra=""):
    pm = run["pm"]
    print(f"[chain] {tag} {path}: TPOT {pm.TPOT:.4f} ms, e2e {pm.e2e_latency:.1f} ms, "
          f"sum of iter_time {sum(pm.iter_time):.1f} ms, decode {pm.decode_latency:.1f} "
          f"ms, {len(pm.iter_time)} steps, {run['waits']} host waits{extra}; {smi}",
          flush=True)


def chain_pair(runner, mode, prompt, tag, fn, template, smi, chained=None, origin=""):
    """`fn` through tree_generate on the per-step path, against its chained
    run: `chained`, generate_run's dict of a run that the script made
    under sync_checked on a runner built as `runner` is (`origin` says
    which, printed beside its numbers), or if None a run made here, under
    sync_checked.  The branches' token ids must be equal.
    If they are not, the per-step path is rerun twice first, as a control
    of the card's determinism, and what it shows is printed.  Returns
    {"per-step": run, "chained": run}."""
    out = {"per-step": generate_run(runner, mode, prompt, per_step(fn), template)}
    if chained is None:
        with sync_checked(f"{tag} chained"):
            chained = generate_run(runner, mode, prompt, fn, template)
    out["chained"] = chained
    for path, run in out.items():
        chain_line(tag, path, run, smi, f", under set_sync_debug_mode('error'){origin}"
                   if path == "chained" else "")
    same = out["per-step"]["seqs"] == out["chained"]["seqs"]
    if not same:
        reruns = [generate_run(runner, mode, prompt, per_step(fn), template)["seqs"]
                  for _ in range(2)]
        print(f"[chain] {tag}: chained tokens differ from per-step; the per-step "
              f"path rerun twice gives {[r == out['per-step']['seqs'] for r in reruns]} "
              "(equal to its first run)", flush=True)
    n = sum(len(x) for x in out["chained"]["seqs"])
    print(f"[chain] {tag}: per-step and chained branch tokens "
          f"{'equal' if same else 'DIFFER'} ({len(out['chained']['seqs'])} branches, "
          f"{n} tokens); launches chained {out['chained']['launches']}", flush=True)
    check(same and n > 0, f"{tag}: chained branch tokens differ from per-step")
    return out


def batch_chain_pair(runner, prompts, mode, tag, smi):
    """The batch path's four requests through BatchedEngine, per-step then
    on the all-greedy fast path (under sync_checked); each request's
    branches must be equal."""
    import torch
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request
    from deft_tpu_torch.runtime.runner import host_wait

    out = {}
    for path in ("per-step", "chained"):
        fn = per_step(workloads.simple_tree) if path == "per-step" else workloads.simple_tree
        runner.reset_state()
        eng = BatchedEngine(runner, mode)
        reqs = [Request(p, Branch_Controller(fn), len(p) + GEN_LEN, width=WIDTH, depth=1)
                for p in prompts]
        w0 = host_wait.waits
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sync_checked(f"{tag} chained", path == "chained"):
            eng.add_requests(reqs)
            steps = eng.run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        out[path] = [[list(s.token_ids) for s in r.finished_seqs] for r in reqs]
        tok = sum(len(x) for b in out[path] for x in b)
        note = ", under set_sync_debug_mode('error')" if path == "chained" else ""
        print(f"[chain] {tag} {path}: {steps} steps, {tok} tokens in {wall:.1f} ms "
              f"(admission included), {wall / steps:.3f} ms/step, "
              f"{host_wait.waits - w0} host waits{note}; launches "
              f"{ {k: n for k, n in read_counts().items() if n} }; {smi}", flush=True)
    same = out["per-step"] == out["chained"]
    print(f"[chain] {tag}: per-step and chained branch tokens "
          f"{'equal' if same else 'DIFFER'} in every request", flush=True)
    check(same and all(len(b) == WIDTH for b in out["chained"]),
          f"{tag}: chained branch tokens differ from per-step")


def topk_widened(probs, k):
    """The runner's top-K tie rule before the chain (topk_lowest_index as
    it was): torch.topk widened to every entry tied with a row's k-th
    value, the width read on the host, then sorted by (value descending,
    index ascending).  Timed beside the device rule, used nowhere else."""
    import torch

    vals, ids = torch.topk(probs, k, dim=-1)
    m = int((probs >= vals[:, -1:]).sum(dim=-1).max())
    if m > k:
        vals, ids = torch.topk(probs, m, dim=-1)
    ids, perm = ids.sort(dim=-1)
    vals, perm2 = vals.gather(-1, perm).sort(dim=-1, descending=True, stable=True)
    return vals[:, :k], ids.gather(-1, perm2)[:, :k]


def topk_rule_timing(dev, vocab, smi):
    """The decode step's top-K, ties lowest index first, over WIDTH rows of
    the vocabulary at k = WIDTH and the runner's 64: the device rule
    (runner.topk_lowest_index, one int64 topk of packed keys) against the
    one it replaced (topk_widened), on softmax + 1e-6 of bf16 logits
    widened to fp32, as the runner's _logits_view takes them.  Both must
    give the same ids and values.  Prints each one's CUDA-event time
    (primed: the device's time; topk_widened's host read empties the
    queue, so its time also holds the host's launches after the read) and
    the host's wall time of a call and its synchronize."""
    import torch
    from deft_tpu_torch.runtime.runner import topk_lowest_index

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    logits = (3 * torch.randn(WIDTH, vocab, generator=gen, device=dev)).bfloat16().float()
    probs = torch.softmax(logits, dim=-1) + 1e-6
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for k in (WIDTH, 64):
        (nv, ni), (ov, oi) = topk_lowest_index(probs, k), topk_widened(probs, k)
        check(torch.equal(ni, oi) and torch.equal(nv, ov),
              f"top-{k}: the device tie rule and the widened one disagree")
        tied = int((probs >= nv[:, -1:]).sum(dim=-1).max())
        times = []
        for fn in (lambda: topk_lowest_index(probs, k), lambda: topk_widened(probs, k)):
            ev = time_ms(fn, 20, flush)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
                torch.cuda.synchronize()
            times.append((ev, (time.perf_counter() - t0) / 20 * 1e3))
        (dn, dw), (wn, ww) = times
        print(f"[chain] top-{k} of {WIDTH} x {vocab} fp32 probabilities (up to {tied} "
              f"entries at or above a row's k-th value; both rules give the same ids "
              f"and values): device rule {dn:.4f} ms device, {dw:.4f} ms host call + "
              f"sync; widened rule with its host read {wn:.4f} ms device, {ww:.4f} ms "
              f"host call + sync; {smi}", flush=True)


def phase_chain(dev, params, prompt, smi, chained=None, profile: bool = False):
    """The per-step device chain (runtime/generate.py under
    DEFT_REPLAY_EXEC=0 DEFT_PLAN_PATCH=0, which the caller sets;
    BatchedEngine's all-greedy fast path) against the per-step path, on
    the main path's settings (8B bf16, prompt 4000, width 50, 64 tokens):
    Simple_Tree, W1 Practical_Tree (deferred selection), W2
    Speculative_Decoding (pipelined logits-free steps) and W4 Random_Tree
    (deferred), each flatten and seq, the main path over int8 KV in
    flatten, and the batch path's four requests through BatchedEngine:
    equal branch token ids in every pair.  (The main flatten path's turns
    are the replay phase's.)  `chained`: {tag: {mode: run}}, the chained
    runs that phase_workloads ("W1 tot", "W2 spec", "W4 random") made
    under sync_checked on the same chain; the per-step runs here take
    runners built as theirs were.  The others (all of them with
    --chain-only) are made here.  Every chained run goes under
    set_sync_debug_mode("error"), after a control that the mode raises on
    a .item().  Prints TPOT, e2e, the sum of iter_time and the host waits
    of each run, and the top-K tie rule's time against the rule it
    replaced; with `profile`, 8 profiled main flatten steps of each path in
    turns."""
    import torch
    from deft_tpu_torch.control import workloads
    from deft_tpu_torch.data import generate_accepted_len_list
    from deft_tpu_torch.data.synthetic import synth_spec_tree, synth_tot_tree
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode

    t_phase = time.perf_counter()
    chained = chained or {}
    cfg = PRESETS["8b"]
    flatten = ForwardMode.TREE_DECODE_FLATTEN
    modes = (("flatten", flatten), ("seq", ForwardMode.DECODE))
    try:
        with sync_mode("error"):
            torch.zeros(1, device=dev).item()
        raised = False
    except RuntimeError:
        raised = True
    print(f"[chain] control: .item() under set_sync_debug_mode('error') "
          f"{'raises' if raised else 'does not raise'}", flush=True)
    check(raised, "set_sync_debug_mode('error') lets a .item() through: the sync "
          "check cannot see a hidden wait")
    topk_rule_timing(dev, cfg.vocab_size, smi)

    runner = make_runner(cfg, params, dev)  # as phase_main's
    runner.retain_full_logits = False
    for mode_name, mode in modes:
        chain_pair(runner, mode, prompt, f"main {mode_name}", workloads.simple_tree,
                   None, smi)
    if profile:
        for path in ("per-step", "chained", "chained", "per-step"):
            fn = (per_step(workloads.simple_tree) if path == "per-step"
                  else workloads.simple_tree)
            profile_generate(runner, flatten, prompt, fn, None, 8, 8,
                             f"main {path}, TREE_DECODE_FLATTEN, steps 8-15, prompt "
                             f"4000, bf16 KV")
    del runner
    release()

    # phase_workloads' runner
    runner = make_runner(cfg, params, dev, slots=BATCH_SLOTS, max_requests=WL_REQUESTS,
                         use_tree_index=True)
    runner.retain_full_logits = False
    tot = synth_tot_tree(seed=SEED, width=4, max_leaves=WIDTH, total_iters=GEN_LEN - 1)
    spec = synth_spec_tree(token_tree_size=WIDTH, gen_len=GEN_LEN - 1, seed=SEED)
    generate_accepted_len_list(GEN_LEN, spec, seed=SEED)
    for tag, fn, template in (("W1 tot", workloads.practical_tree, tot),
                              ("W2 spec", workloads.speculative_decoding, spec),
                              ("W4 random", workloads.random_tree, None)):
        for mode_name, mode in modes:
            chain_pair(runner, mode, prompt, f"{tag} {mode_name}", fn, template, smi,
                       chained.get(tag, {}).get(mode_name),
                       ", the workloads phase's run (the time of its mid-run hold or "
                       "merge read-backs included)")
    del runner
    release()

    runner = make_runner(cfg, params, dev, kv_dtype="int8")
    runner.retain_full_logits = False
    chain_pair(runner, flatten, prompt, "main flatten, int8 KV", workloads.simple_tree,
               None, smi)
    del runner
    release()

    prompts = batch_prompts()
    runner = make_runner(cfg, params, dev, prompt_len=max(BATCH_LENS),
                         slots=BATCH_SLOTS, max_requests=4 * (WIDTH + 2))
    runner.retain_full_logits = False
    for mode_name, mode in modes:
        batch_chain_pair(runner, prompts, mode, f"batch {mode_name}", smi)
    del runner
    release()
    print(f"[chain] the phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


# the switch settings of the replay phase (runtime/generate.py): deft_tpu's
# default path (replayed spans), its decode windows, and the per-step chain,
# which the workloads and chain phases run (main sets PER_STEP_CHAIN there)
PATHS = {"replay": {},
         "windows": {"DEFT_REPLAY_EXEC": "0"},
         "per-step chain": {"DEFT_REPLAY_EXEC": "0", "DEFT_PLAN_PATCH": "0"}}
PER_STEP_CHAIN = PATHS["per-step chain"]
SWITCHES = ("DEFT_REPLAY_EXEC", "DEFT_PLAN_PATCH", "DEFT_COMPACT_PLAN",
            "DEFT_REPLAY_WINDOWS", "DEFT_REPLAY_UNIFORM")


@contextlib.contextmanager
def switched(env: dict):
    """The runtime's switches set to `env` (the others unset) while open,
    as they were after."""
    before = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def first_difference(a, b):
    """(branch, position) of the first token where two runs' sorted branches
    differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (s, t) in enumerate(zip(x, y)):
            if s != t:
                return i, j
        if len(x) != len(y):
            return i, min(len(x), len(y))
    return None if len(a) == len(b) else (min(len(a), len(b)), 0)


def top2_margins(runner, mode, prompt, fn, template):
    """The per-step chain rerun with full logits kept: each decode step's
    top-2 probability margin of every row (the control printed where two
    paths' tokens differ)."""
    from unittest import mock

    import torch

    margins, forward = [], runner.forward_tree_decode

    def hooked(mode, plan, **kw):
        view, t = forward(mode, plan, **kw)
        with sync_allowed():
            p = torch.softmax(view.full_logits().float(), dim=-1)
            top = torch.topk(p, 2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).cpu().numpy()[:plan.n_leaves])
        return view, t

    runner.retain_full_logits, runner._plan_patch = True, False
    with switched(PER_STEP_CHAIN), mock.patch.object(runner, "forward_tree_decode", hooked):
        generate_run(runner, mode, prompt, fn, template)
    runner.retain_full_logits = False
    return margins


def replay_line(tag, path, run, smi):
    pm, c = run["pm"], run["copies"]
    print(f"[replay] {tag} {path}: TPOT {pm.TPOT:.4f} ms, e2e {pm.e2e_latency:.1f} ms, "
          f"sum of iter_time {sum(pm.iter_time):.1f} ms, {run['waits']} host waits, "
          f"{c['plan_copies']} plan copies to the card, plan bytes shipped "
          f"{c['plan_upload_bytes']} of {c['plan_full_bytes']} in full uploads "
          f"({c['plan_upload_bytes'] / max(c['plan_full_bytes'], 1):.4f}), slab windows "
          f"{c['win']}, slab steps {c['step']}, {len(pm.iter_time)} steps; "
          f"under set_sync_debug_mode('error'); launches {run['launches']}; {smi}",
          flush=True)


def replay_run(cfg, params, dev, prompt, tag, path, mode, fn, template, kw):
    """One generation of `fn` on a fresh runner built (and run) under the
    path's switches, under sync_checked, the launch counts set to 0 just
    before it; generate_run's dict with the runner's plan copies, bytes
    and slab items ("copies")."""
    with switched(PATHS[path]):
        runner = make_runner(cfg, params, dev, **kw)
        runner.retain_full_logits = False
        reset_counts()
        with sync_checked(f"replay {tag} {path}"):
            run = generate_run(runner, mode, prompt, fn, template)
    run["copies"] = {k: getattr(runner, k) for k in ("plan_copies", "plan_upload_bytes",
                                                      "plan_full_bytes")}
    run["copies"].update(runner.replay_stats)
    run["runner"] = runner
    return run


def replay_paths(cfg, params, dev, prompt, tag, mode, fn, template, kw, kernel, paths,
                 smi, want=None):
    """`fn` on each of `paths` in turn (replay_run: a fresh runner, the
    sync check, the launch counts from 0), each run's line printed; each
    run launched a decode kernel of its mode's side and `kernel` (if not
    None), the replay path ran slab items, and the branch token ids equal
    the first run's, or `want` (a default-path run made before, its
    branches sorted).  Where they differ, the first position that differs
    and the top-2 margin at that decode step (a per-step rerun with full
    logits) are printed, and the phase fails.  Returns the runs in
    order."""
    sides = SEQ_SIDE if mode.is_sequential else FLATTEN_SIDE
    runs = []
    for path in paths:
        run = replay_run(cfg, params, dev, prompt, tag, path, mode, fn, template, kw)
        replay_line(tag, path, run, smi)
        check(any(run["launches"].get(k, 0) for k in sides),
              f"replay {tag} {path}: no {sides} kernel launched")
        if kernel is not None:
            check(run["launches"].get(kernel, 0) > 0,
                  f"replay {tag} {path}: {kernel} never launched")
        if path == "replay":
            check(run["copies"]["win"] + run["copies"]["step"] > 0,
                  f"replay {tag}: no span ran from slabs")
        seqs = sorted(map(tuple, run["seqs"]))
        want = seqs if want is None else want
        where = first_difference(seqs, want)
        if where is not None:
            margins = top2_margins(run["runner"], mode, prompt, fn, template)
            # token j of a branch comes from iteration j, decode step j - 1
            step = where[1] - 1
            m = margins[step] if 0 <= step < len(margins) else None
            print(f"[replay] {tag}: {path} differs from the first run at branch "
                  f"{where[0]} token {where[1]}; top-2 probability margin at that "
                  f"decode step: min {np.min(m) if m is not None else 'n/a'}, "
                  f"per row {None if m is None else np.round(m, 6).tolist()}",
                  flush=True)
        check(where is None and seqs, f"replay {tag}: {path} branch tokens differ "
              "from the first run's")
        del run["runner"]
        release()
        runs.append(run)
    print(f"[replay] {tag}: branch tokens equal on every path ({len(want)} branches, "
          f"{sum(len(x) for x in want)} tokens)", flush=True)
    return runs


def phase_replay(dev, params, prompt, smi):
    """deft_tpu's default decode path on the card (runtime/generate.py's
    record path and runner.execute_recorded; DEFT_REPLAY_EXEC, on by
    default) against its decode windows (DEFT_REPLAY_EXEC=0) and the
    per-step chain (DEFT_REPLAY_EXEC=0 DEFT_PLAN_PATCH=0), on the main
    path's settings (8B bf16, prompt 4000, width 50, 64 tokens): main
    flatten and seq (Simple_Tree), W1 Practical_Tree, W2
    Speculative_Decoding and W4 Random_Tree (gather plans: B6) in flatten,
    and the main flatten path over int8 KV.  Each run is made on a fresh
    runner under its path's switches and under
    set_sync_debug_mode("error") (after the chain phase's control): only
    runner.host_wait may wait, so a span's dispatch, from its slab upload
    to its first chunk fetch, never does; the launch counts are set to 0
    just before each run and read after it, and each path's decode kernel
    must have launched.  The branch token ids must be equal across the
    three paths of every run (replay_paths).  Prints TPOT, e2e, the sum of
    iter_time, host waits, the plan copies to the card and
    plan_upload_bytes against plan_full_bytes of each run; the main
    flatten paths run in turns (replay, windows, per-step chain, then
    back)."""
    from deft_tpu_torch.control import workloads
    from deft_tpu_torch.data import generate_accepted_len_list
    from deft_tpu_torch.data.synthetic import synth_spec_tree, synth_tot_tree
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.runtime import ForwardMode

    t_phase = time.perf_counter()
    cfg = PRESETS["8b"]
    flatten, seq = ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE
    tot = synth_tot_tree(seed=SEED, width=4, max_leaves=WIDTH, total_iters=GEN_LEN - 1)
    spec = synth_spec_tree(token_tree_size=WIDTH, gen_len=GEN_LEN - 1, seed=SEED)
    generate_accepted_len_list(GEN_LEN, spec, seed=SEED)
    wl = dict(slots=BATCH_SLOTS, max_requests=WL_REQUESTS, use_tree_index=True)
    order = list(PATHS)
    # tag -> (mode, workload, template, make_runner's kwargs, kernel, paths)
    runs = {
        "main flatten": (flatten, workloads.simple_tree, None, {}, "paged_flatten",
                         order + order[::-1]),
        "main seq": (seq, workloads.simple_tree, None, {}, "paged_seq", order),
        "W1 tot flatten": (flatten, workloads.practical_tree, tot, wl, None, order),
        "W2 spec flatten": (flatten, workloads.speculative_decoding, spec, wl, None, order),
        "W4 random flatten": (flatten, workloads.random_tree, None, wl, "flatten_gather",
                              order),
        "main flatten, int8 KV": (flatten, workloads.simple_tree, None,
                                  {"kv_dtype": "int8"}, "paged_flatten_q", order),
    }
    for tag, (mode, fn, template, kw, kernel, paths) in runs.items():
        replay_paths(cfg, params, dev, prompt, tag, mode, fn, template, kw, kernel, paths,
                     smi)
    print(f"[replay] the phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_int8w(dev, prompt, ids, main_runs, smi):
    """The main path's workload over int8 weights made on the card
    (weight_dtype "int8-pallas"): B9 launches 129 times a decode step, and
    the first step agrees with the same codes and scales under "int8";
    the flatten run (the default path, replayed spans) gives the ids of
    the decode windows and the per-step chain (replay_paths), each with
    129 B9 launches a step.  Returns the path's launches and its first
    step's logits (B9's), for the 2x1x2 grid's int8-weight run."""
    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.loader import random_params
    from deft_tpu_torch.runtime import ForwardMode

    cfg = PRESETS["8b"]
    per_step = 4 * cfg.num_layers + 1
    t0 = time.perf_counter()
    params = random_params(cfg, SEED, dev, torch.bfloat16, "int8-pallas")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
    print(f"[int8w] 8b int8-pallas weights ({gb:.2f} GB, int8 codes + fp32 scales, "
          f"bf16 embed and norms) made on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the same codes and scales, routed to the plain expression
    expr = {(k[:-3] + "_s" if k.endswith("_sp") else k): t for k, t in params.items()}
    runner = make_runner(cfg, params, dev)
    check(runner.params["wqkv"].dtype == torch.int8 and "wqkv_sp" in runner.params,
          "the int8w runner's weights are not int8-pallas")
    first_step(runner, prompt, ids)
    flatten = ForwardMode.TREE_DECODE_FLATTEN
    plan = runner.build_plan(flatten)
    logits, n_b9 = {}, {}
    for name, p in (("int8-pallas", params), ("int8", expr)):
        runner.params = p
        reset_counts()
        v, _ = runner.forward_tree_decode(flatten, plan)
        n_b9[name] = read_counts()["int8_matmul"]
        logits[name] = v.full_logits()[:WIDTH].float()
    runner.params = params
    err = rel_l2(logits["int8-pallas"], logits["int8"])
    top1 = float((logits["int8-pallas"].argmax(-1) == logits["int8"].argmax(-1))
                 .float().mean())
    print(f"[int8w] first decode step, B9 ({n_b9['int8-pallas']} launches) vs the "
          f"plain expression ({n_b9['int8']} launches) on the same codes: relative "
          f"L2 of the logits {err:.3e} (limit {LOGITS_LIMIT:.0e}), top-1 agreement "
          f"{top1:.3f}", flush=True)
    check(n_b9["int8-pallas"] == per_step and n_b9["int8"] == 0,
          f"B9 launches in one decode step: {n_b9}, expected {per_step} and 0")
    check(err < LOGITS_LIMIT, f"int8-pallas and int8 logits disagree: {err}")
    check(bool(torch.isfinite(logits["int8-pallas"]).all()), "int8w logits not finite")
    runner.reset_state()
    runner.retain_full_logits = False

    reset_counts()
    runs = generate_both(runner, prompt, "int8w")
    launches = read_counts()
    for mode_name, r in runs.items():
        n, steps = r["launches"].get("int8_matmul", 0), len(r["paged"])
        check(n == per_step * steps,
              f"int8w {mode_name}: B9 launched {n} times in {steps} decode steps, "
              f"not {per_step} a step")
        m = main_runs[mode_name]["pm"]
        print(f"[int8w] {mode_name}: {n} B9 launches over {steps} decode steps; TTFT "
              f"{r['pm'].TTFT:.3f} ms, TPOT {r['pm'].TPOT:.4f} ms against bf16 "
              f"weights' {m.TTFT:.3f} / {m.TPOT:.4f} ms (main path, this run)",
              flush=True)
    print(f"[int8w] launches during the int8-weight path: {launches}", flush=True)
    first = logits["int8-pallas"].cpu()
    del runner, expr, logits
    release()
    want = sorted(map(tuple, runs["flatten"]["seqs"]))
    for path, r in zip(("windows", "per-step chain"), replay_paths(
            cfg, params, dev, prompt, "int8w flatten", flatten,
            None, None, {}, "int8_matmul", ("windows", "per-step chain"), smi, want)):
        n, steps = r["launches"].get("int8_matmul", 0), len(r["paged"])
        check(n == per_step * steps,
              f"int8w flatten {path}: B9 launched {n} times in {steps} decode steps, "
              f"not {per_step} a step")
    del params
    release()
    return launches, first


def dense_sum_scaled(cfg, lp, h):
    """The MoE block dense over the stacked experts, as models/llama.py's
    _moe_mlp, but in B10's (and the Pallas kernel's) rounding order: each
    expert's product summed in fp32 from the exact fp32 widening of h and of
    the bf16 weight or int8 code, times the fp32 scale, one cast.  _moe_mlp
    rounds the product to h's dtype before the scale.  The sums are fp32
    matmuls (no TF32), not the tensor cores' fp32 accumulation of B10 and
    of cuBLAS on bf16.  One expert at a time, so its fp32 transients stay a
    few hundred MB at Mixtral's widths."""
    import torch
    from deft_tpu_torch.models import llama

    K = cfg.experts_per_tok
    probs = llama._router_probs(lp, h)
    top_i = probs.topk(K, dim=-1).indices
    rw = probs * torch.zeros_like(probs).scatter_(1, top_i, 1.0)
    rw = rw / rw.sum(dim=-1, keepdim=True)

    def emm(x, name, e):
        y = x.float() @ lp[name][e].float()
        s = llama._expert_scale(lp, name)
        return (y if s is None else y * s[e]).to(h.dtype)

    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in range(cfg.num_experts):
        z = torch.nn.functional.silu(emm(h, "wg", e).float()).to(h.dtype) * emm(h, "wu", e)
        out += emm(z, "wdown", e).float() * rw[:, e:e + 1]
    return out.to(h.dtype)


def moe_route_check(runner, prompt, tag, limit):
    """The prefill's last-token logits through B10 against two dense expert
    routes on the same weights: the port's own (_moe_mlp, taken where
    llama._moe_gmm_ok fails) and dense_sum_scaled, the same sum in B10's
    rounding order.  Two controls on the B10 route bracket them: one ulp of
    noise (-1, 0 or +1 at random) on each nonzero element of every layer's
    MoE output, and a fault: in every layer, the row tile that holds the
    last token's first routed row is sent to another expert (the tile_eid
    entry plus one).  Both references are held to `limit`.  In the B10 runs
    every layer's MoE output is also compared with both references on the
    same input (no error carried from layer to layer), the largest relative
    L2 over the layers held to MOE_LAYER_LIMIT.  Returns ({run: logits
    relative L2 against the B10 run}, {run: {reference: largest layer
    error}}, {reference: the (token, layer) pairs whose top-2 experts
    differ between it and B10})."""
    from unittest import mock

    import torch
    from deft_tpu_torch.models import llama

    gen = torch.Generator(device=runner.device)
    gen.manual_seed(SEED + 4)
    moe, dense = llama._moe_mlp_gmm, llama._moe_mlp
    dispatch, router = llama.moe_dispatch, llama._router_probs
    K = runner.cfg.experts_per_tok
    ordered = "dense, B10's rounding order"

    def ulp_noise(cfg, lp, h):
        o = moe(cfg, lp, h)
        step = torch.randint(-1, 2, o.shape, generator=gen, device=o.device,
                             dtype=torch.int16)
        return (o.view(torch.int16) + step * (o != 0)).view(o.dtype)

    def wrong_expert(top_i, top_w, ne, *a):
        row_src, tok_pos, w_pos, tile_eid = dispatch(top_i, top_w, ne, *a)
        t = int((tok_pos == top_i.shape[0] - 1).nonzero()[0]) // llama._GMM_TILE_M
        tile_eid = tile_eid.clone()
        tile_eid[t] = (tile_eid[t] + 1) % ne
        return row_src, tok_pos, w_pos, tile_eid

    def chosen_experts(lp, h):
        return router(lp, h).topk(K, dim=-1).indices.sort(dim=-1).values

    runs = (("B10", moe), ("dense", dense), (ordered, dense_sum_scaled),
            ("B10+ulp noise", ulp_noise), ("B10, a tile to another expert", moe))
    logits, top, layer = {}, {}, {}
    for name, fn in runs:
        chosen, errs = top.setdefault(name, []), layer.setdefault(name, [])

        def compared(cfg, lp, h, fn=fn, chosen=chosen, errs=errs):
            chosen.append(chosen_experts(lp, h))
            o = fn(cfg, lp, h)
            errs.append({"dense": rel_l2(o, dense(cfg, lp, h)),
                         ordered: rel_l2(o, dense_sum_scaled(cfg, lp, h))})
            return o

        def recorded(cfg, lp, h, fn=fn, chosen=chosen):
            chosen.append(chosen_experts(lp, h))
            return fn(cfg, lp, h)

        if name.startswith("B10"):
            patches = {"_moe_mlp_gmm": compared}
            if "another expert" in name:
                patches["moe_dispatch"] = wrong_expert
        else:  # every layer takes the dense route
            patches = {"_moe_gmm_ok": lambda cfg, n: False, "_moe_mlp": recorded}
        runner.reset_state()
        with mock.patch.multiple(llama, **patches):
            view = runner.forward_prefill(prompt)
        logits[name] = view.full_logits()[0].float()
        check(bool(torch.isfinite(logits[name]).all()), f"{tag} {name}: logits not finite")
    runner.reset_state()
    readings = {k: rel_l2(v, logits["B10"]) for k, v in logits.items() if k != "B10"}
    refs = ("dense", ordered)
    worst = {k: {r: max(e[r] for e in v) for r in refs} for k, v in layer.items() if v}
    flips = {r: sum(int((a != b).any(dim=-1).sum()) for a, b in zip(top["B10"], top[r]))
             for r in refs}
    pairs = len(prompt) * runner.cfg.num_layers
    print(f"[{tag}] route check, prefill last-token logits, relative L2 against "
          f"B10's: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
          + f" (limit {limit:g}); each layer's MoE output against each reference on "
          f"the same input, largest relative L2 over the layers: "
          + "; ".join(f"{k}: " + ", ".join(f"{r} {v[r]:.3e}" for r in refs)
                      for k, v in worst.items())
          + f" (limit {MOE_LAYER_LIMIT:g}); top-2 experts differ from B10's at "
          + ", ".join(f"{flips[r]} ({r})" for r in refs)
          + f" of {pairs} (token, layer) pairs; top-1 token equal "
          + ", ".join(f"{r} {int(logits['B10'].argmax()) == int(logits[r].argmax())}"
                      for r in refs), flush=True)
    for r in refs:
        check(readings[r] < limit, f"{tag}: B10 and {r} disagree: {readings[r]}")
        check(worst["B10"][r] < MOE_LAYER_LIMIT
              and worst["B10+ulp noise"][r] < MOE_LAYER_LIMIT,
              f"{tag}: a layer's MoE output through B10 strays from {r}")
        check(worst["B10, a tile to another expert"][r] > MOE_LAYER_LIMIT,
              f"{tag}: the layer check against {r} does not see a tile sent to "
              "the wrong expert")
    check(readings["B10+ulp noise"] < limit,
          f"{tag}: one ulp of MoE noise moves the logits past the limit")
    check(readings["B10, a tile to another expert"] > limit,
          f"{tag}: a tile sent to the wrong expert stays under the limit")
    return readings, worst, flips


def moe_first_step(runner, prompt, tag):
    """The first decode step of a MoE model in flatten and in seq mode, with
    the attention controls of logits_controls on the same step; counts the
    (leaf, layer) pairs whose top-2 experts differ between the two modes.
    Holds seq, the noise control and the dropped block to MOE_STEP_LIMIT.
    Returns the launch counts of one more flatten step on the same tree,
    the branch tokens and the flatten step's (WIDTH, V) logits on the host."""
    from unittest import mock

    from deft_tpu_torch.models import llama
    from deft_tpu_torch.runtime import ForwardMode

    view = runner.forward_prefill(prompt)
    _, ids = view.topk(0, WIDTH)
    runner.reset_state()
    first_step(runner, prompt, ids)
    router, K, L = llama._router_probs, runner.cfg.experts_per_tok, runner.cfg.num_layers
    top = []

    def recording_router(lp, h):
        p = router(lp, h)
        top.append(p[:WIDTH].topk(K, dim=-1).indices.sort(dim=-1).values)
        return p

    with mock.patch.object(llama, "_router_probs", recording_router):
        lf, ls, readings = logits_controls(runner, WIDTH)
    differ = [(a != b).any(dim=-1) for a, b in zip(top[:L], top[L:2 * L])]
    flipped = sum(differ).bool()  # leaves with another expert at some layer
    same = ~flipped
    kept = rel_l2(ls[same], lf[same]) if bool(same.any()) else float("nan")
    print(f"[{tag}] first decode step, relative L2 of the logits against "
          f"flatten's: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
          + f" (limit {MOE_STEP_LIMIT:g}); top-2 experts differ between flatten "
          f"and seq at {int(sum(d.sum() for d in differ))} of {WIDTH * L} (leaf, "
          f"layer) pairs, in {int(flipped.sum())} of {WIDTH} leaves; seq over the "
          f"other leaves {kept:.3e}; top-1 agreement "
          f"{float((lf.argmax(-1) == ls.argmax(-1)).float().mean()):.3f}", flush=True)
    check(readings["seq"] < MOE_STEP_LIMIT,
          f"{tag}: flatten and seq logits disagree: {readings['seq']}")
    check(readings["flatten+ulp noise"] < MOE_STEP_LIMIT,
          f"{tag}: one ulp of attention noise moves the logits past the limit")
    check(readings["flatten, block dropped"] > MOE_STEP_LIMIT,
          f"{tag}: a dropped KV block stays under the limit")
    flatten = ForwardMode.TREE_DECODE_FLATTEN
    reset_counts()
    runner.forward_tree_decode(flatten, runner.build_plan(flatten))
    counts = {k: n for k, n in read_counts().items() if n}
    runner.reset_state()
    return counts, ids, lf.cpu()


def generate_counting_prefills(runner, prompt, tag, gen_len=GEN_LEN):
    """generate_both (`gen_len` tokens), with each prefill's launches
    recorded apart: returns (runs, [launches of each prefill], launches of
    the whole run)."""
    prefills = []
    real = runner.forward_prefill

    def counted(*a, **k):
        before = read_counts()
        out = real(*a, **k)
        prefills.append({n: c - before[n] for n, c in read_counts().items()
                         if c > before[n]})
        return out

    runner.forward_prefill = counted
    try:
        reset_counts()
        runs = generate_both(runner, prompt, tag, gen_len=gen_len)
        launches = read_counts()
    finally:
        del runner.forward_prefill
    print(f"[{tag}] launches of each prefill {prefills}; of the whole path "
          f"{ {k: n for k, n in launches.items() if n} }", flush=True)
    return runs, prefills, launches


def phase_moe(dev, smi, profile: bool = False):
    """Mixtral-8x7B widths at 6 layers, bf16 weights: B10 (gmm) takes every
    prefill's MoE, 3 launches a layer, and no decode step's; then the
    flatten run per-step against chained (chain_pair: the dense MoE decode
    route under set_sync_debug_mode("error"))."""
    import torch
    from deft_tpu_torch.control import workloads
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.loader import random_params
    from deft_tpu_torch.runtime import ForwardMode

    cfg = PRESETS["mixtral-6l"]
    t0 = time.perf_counter()
    params = random_params(cfg, SEED, dev, torch.bfloat16)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
    print(f"[moe] mixtral-6l bf16 weights ({gb:.2f} GB) made on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runner = make_runner(cfg, params, dev)
    prompt = moe_prompt(cfg)
    moe_route_check(runner, prompt, "moe", MOE_LIMIT)
    # the prefill's last-token logits, for the sharded-moe path
    prefill_logits = runner.forward_prefill(prompt).full_logits()[0].float().cpu()
    runner.reset_state()
    _, ids, lf = moe_first_step(runner, prompt, "moe")
    runner.retain_full_logits = False
    runs, prefills, launches = generate_counting_prefills(runner, prompt, "moe")
    per = 3 * cfg.num_layers
    check(len(prefills) == 2 and all(p.get("gmm") == per and not p.get("gmm_scaled")
                                     for p in prefills),
          f"moe: B10 launches a prefill {prefills}, expected gmm {per}")
    check(launches["gmm"] == 2 * per and launches["gmm_scaled"] == 0,
          f"moe: B10 launched outside the prefills: {launches}")
    check(launches["prefill"] > 0
          and runs["flatten"]["launches"].get("paged_flatten", 0)
          + runs["flatten"]["launches"].get("flatten_gather", 0) > 0
          and runs["seq"]["launches"].get("paged_seq", 0)
          + runs["seq"]["launches"].get("seq_gather", 0) > 0,
          f"moe: attention kernels did not launch: {launches}")
    chain_pair(runner, ForwardMode.TREE_DECODE_FLATTEN, prompt, "moe flatten",
               workloads.simple_tree, None, smi)
    if profile:
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            profile_decode(runner, mode, prompt, WIDTH, steps=8)
    del runner, params
    release()
    return launches, runs, {"prefill": prefill_logits, "ids": ids, "first": lf}


def moe_prompt(cfg):
    """The MoE paths' prompt: PROMPT_LEN ids below the model's vocabulary."""
    return [int(t) for t in np.random.default_rng(SEED).integers(4, cfg.vocab_size - 4,
                                                                 PROMPT_LEN)]


def phase_moe_int8w(dev, moe_runs, profile: bool = False):
    """Mixtral-8x7B at all 32 layers over int8-pallas weights: B10's scaled
    entry takes every prefill's MoE (96 launches), B9 wqkv, wo and lm_head
    at decode (65 a step); route check against the dense expression on the
    same codes and scales."""
    import dataclasses

    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.loader import random_params
    from deft_tpu_torch.runtime import ForwardMode

    cfg = dataclasses.replace(PRESETS["mixtral-6l"], num_layers=32)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = random_params(cfg, SEED, dev, torch.bfloat16, "int8-pallas")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
    print(f"[moe-int8w] Mixtral-8x7B, 32 layers, int8-pallas weights ({gb:.2f} GB, "
          f"int8 codes + fp32 scales, bf16 embed, router and norms) made on the card "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    runner = make_runner(cfg, params, dev)
    prompt = moe_prompt(cfg)
    moe_route_check(runner, prompt, "moe-int8w", MOE_INT8_LIMIT)
    per_step = 2 * cfg.num_layers + 1
    step, _, _ = moe_first_step(runner, prompt, "moe-int8w")
    check(step.get("int8_matmul") == per_step and not step.get("gmm")
          and not step.get("gmm_scaled"),
          f"moe-int8w: one decode step launched {step}, expected B9 {per_step}, B10 0")
    runner.retain_full_logits = False
    runs, prefills, launches = generate_counting_prefills(runner, prompt, "moe-int8w",
                                                          gen_len=MOE_INT8W_GEN)
    per = 3 * cfg.num_layers
    check(len(prefills) == 2 and all(p.get("gmm_scaled") == per and not p.get("gmm")
                                     for p in prefills),
          f"moe-int8w: B10 launches a prefill {prefills}, expected gmm_scaled {per}")
    check(launches["gmm_scaled"] == 2 * per and launches["gmm"] == 0,
          f"moe-int8w: B10 launched outside the prefills: {launches}")
    for mode_name, r in runs.items():
        n, steps = r["launches"].get("int8_matmul", 0), len(r["paged"])
        check(n == per_step * steps,
              f"moe-int8w {mode_name}: B9 launched {n} times in {steps} decode steps")
        m = moe_runs[mode_name]["pm"]
        print(f"[moe-int8w] {mode_name}: TTFT {r['pm'].TTFT:.3f} ms, TPOT "
              f"{r['pm'].TPOT:.4f} ms against the 6-layer bf16 moe path's "
              f"{m.TTFT:.3f} / {m.TPOT:.4f} ms (this run)", flush=True)
    kv = {name: runs["seq"]["pm"].KV_IO / runs["flatten"]["pm"].KV_IO
          for name, runs in (("moe", moe_runs), ("moe-int8w", runs))}
    print(f"[moe-int8w] kv_io_reduction {kv['moe-int8w']:.4f} (moe path "
          f"{kv['moe']:.4f}); peak device memory of this path "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    if profile:
        for mode in (ForwardMode.TREE_DECODE_FLATTEN, ForwardMode.DECODE):
            profile_decode(runner, mode, prompt, WIDTH, steps=8)
    del runner, params
    release()
    return launches


# -- the sharded paths: four ranks on the one card ------------------------------------
#
# The rank functions below run in processes that parallel.launch spawns
# (they import this script as their main module); each returns what rank 0
# saw, its launch counts beside every other rank's.


def rank_counts(grid) -> list:
    """Every rank's launch counts, gathered to each rank."""
    return rank_counts_of(grid, read_counts())


def rank_counts_of(grid, counts: dict) -> list:
    """Every rank's `counts`, gathered to each rank."""
    import torch.distributed as dist

    out = [None] * grid.size
    dist.all_gather_object(out, counts)
    return out


def rank_generate(grid, runner, prompt, gen_len, modes):
    """tree_generate in each mode on a rank's runner, under sync_checked,
    counts set to 0 just before each run and gathered just after; branch
    tokens, TTFT, TPOT and each step's plan.paged of each run.  A mode is
    the CLI's --mode name, or a (--mode, --mem) pair, keyed "mem mode" in
    the result."""
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.obs import PerfMetrics
    from deft_tpu_torch.runtime import mode_from_cli, tree_generate

    build = runner.build_plan
    out = {}
    for spec in modes:
        name, mem = spec if isinstance(spec, tuple) else (spec, "paged")
        paged = []

        def recording_build(m):
            plan = build(m)
            paged.append(plan.paged)
            return plan

        runner.build_plan = recording_build
        key = name if mem == "paged" else f"{mem} {name}"
        reset_counts()
        try:
            with sync_checked(f"sharded {key}"):
                pm = tree_generate(runner, mode_from_cli(name, mem), None, prompt,
                                   max_seq_len=len(prompt) + gen_len, width=WIDTH, depth=1,
                                   branch_controller=Branch_Controller(workloads.simple_tree),
                                   perf_metrics=PerfMetrics())
        finally:
            del runner.build_plan
        out[key] = dict(seqs=[list(s.token_ids) for s in runner.tree.all_finished_seqs],
                        TTFT=pm.TTFT, TPOT=pm.TPOT, e2e=pm.e2e_latency, paged=paged,
                        counts=rank_counts(grid))
    return out


def rank_batch(grid, cfg, prompts):
    """The batch path on a rank: its four requests through BatchedEngine on
    a runner of the batch path's pools, flatten then seq, the all-greedy
    steps chained on the card, each run (admission included) under
    sync_checked.  Counts set to 0 before the admission and gathered after
    it (B8) and after the run; each request's branches, the admission's
    last-token logits (joined over tp; the runner retains them for the
    admission only), its time, the run's wall time and steps, each step's
    plan.paged, the collectives gloo staged through the host (count and
    seconds, in the admission and in all) and the runner's host waits.
    Controls first: a
    .item() under the check must raise; whether a plain gloo all_reduce of a
    CUDA tensor does too (its staging waits in gloo's thread) is reported."""
    import torch
    import torch.distributed as dist
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.runtime import ForwardMode
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request
    from deft_tpu_torch.runtime.runner import host_wait

    with sync_mode("error"):  # the check must see a wait in this process
        try:
            torch.ones(1, device=grid.device).item()
            raise Failure("a .item() under set_sync_debug_mode('error') did not raise")
        except RuntimeError:
            pass
        try:
            dist.all_reduce(torch.ones(4, device=grid.device))
            raw_gloo = "passes"
        except RuntimeError:
            raw_gloo = "raises"
    runner = make_runner(cfg, None, grid.device, prompt_len=max(BATCH_LENS),
                         slots=BATCH_SLOTS, max_requests=4 * (WIDTH + 2), mesh=grid)
    runner.retain_full_logits = False
    prefill, admitted = runner.forward_prefill_batch, []

    def retaining_prefill(*a, **k):
        runner.retain_full_logits = True
        try:
            admitted.append(prefill(*a, **k))
        finally:
            runner.retain_full_logits = False
        return admitted[-1]

    runner.forward_prefill_batch = retaining_prefill
    out = {"raw gloo": raw_gloo}
    for mode_name, mode in (("flatten", ForwardMode.TREE_DECODE_FLATTEN),
                            ("seq", ForwardMode.DECODE)):
        runner.reset_state()
        eng = BatchedEngine(runner, mode)
        paged = []

        def recording_build(trees, build=eng.build_plan):
            plan = build(trees)
            paged.append(plan.paged)
            return plan

        eng.build_plan = recording_build
        reqs = [Request(p, Branch_Controller(workloads.simple_tree),
                        len(p) + SHARDED_BATCH_GEN, width=WIDTH, depth=1) for p in prompts]
        reset_counts()
        torch.cuda.synchronize()
        staged, staged_s, waits = grid.staged, grid.staged_s, host_wait.waits
        t0 = time.perf_counter()
        with sync_checked(f"sharded batch {mode_name}"):
            eng.add_requests(reqs)
            t_adm = time.perf_counter() - t0
            adm_staged_s = grid.staged_s - staged_s
            admission = read_counts()
            steps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[mode_name] = dict(
            seqs=[[list(s.token_ids) for s in r.finished_seqs] for r in reqs],
            admission_ms=t_adm * 1e3, wall_ms=wall * 1e3, steps=steps, paged=paged,
            staged=grid.staged - staged, staged_ms=(grid.staged_s - staged_s) * 1e3,
            admission_staged_ms=adm_staged_s * 1e3, waits=host_wait.waits - waits,
            admission=rank_counts_of(grid, admission), counts=rank_counts(grid),
            logits=admitted.pop().full_logits().float().cpu())
    del runner.forward_prefill_batch
    return out


def sharded_rank(grid, prompt, ids, prompts):
    """The sharded path on one rank: the 8B model's slices from the main
    path's seed, the first decode step on the main path's tree (and with
    sp rank 1's state left out of every layer's merge: the span that holds
    the prompt's end and the leaves' tokens), flatten then seq over 64
    tokens; then the batch path's four `prompts` through BatchedEngine
    (rank_batch); then an int8 KV cache: its first step and SHARDED_GEN - 1
    decode tokens a mode.  The collectives gloo staged in the bf16 prefill and first step
    are gathered from every rank."""
    import contextlib
    from unittest import mock

    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.ops.dense_oracle import M_EMPTY
    from deft_tpu_torch.parallel import engine
    from deft_tpu_torch.parallel.mesh import Grid
    from deft_tpu_torch.runtime import ForwardMode

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, flatten = PRESETS["8b"], ForwardMode.TREE_DECODE_FLATTEN
    merge = engine.lse_merge

    def drop_sp_rank_1(acc, m, l, reduce):
        if grid.index("sp") == 1:
            acc, l, m = torch.zeros_like(acc), torch.zeros_like(l), torch.full_like(m, M_EMPTY)
        return merge(acc, m, l, reduce)

    out = {}
    for kv in ("inherit", "int8"):
        t0 = time.perf_counter()
        runner = make_runner(cfg, None, grid.device, kv_dtype=kv, mesh=grid)
        torch.cuda.synchronize()
        out[f"{kv} setup s"] = time.perf_counter() - t0
        out[f"{kv} weights GB"] = sum(t.numel() * t.element_size()
                                      for t in runner.params.values()) / 1e9
        staged = grid.staged
        first_step(runner, prompt, ids)
        prefill_staged = grid.staged - staged
        plan = runner.build_plan(flatten)
        out[f"{kv} first paged"] = plan.paged
        # live plan tokens in each sp rank's window, cut by the engine
        batch, tp = runner._step_batch(plan), grid.axis_size("tp")
        wins = [engine.flatten_window(Grid(grid.shape.values(), s * tp, grid.device),
                                      batch, plan.l_pad, plan.paged)
                for s in range(grid.axis_size("sp"))]
        out[f"{kv} live tokens by sp rank"] = [int((w.tok_hi > w.tok_lo).sum()) for w in wins]
        out[f"{kv} plan tokens"] = len(plan.tok_lo)
        for name, fault in (("first", None), ("first, sp rank 1 dropped", drop_sp_rank_1)):
            if kv == "int8" and fault is not None:
                continue
            staged = grid.staged
            with (mock.patch.object(engine, "lse_merge", fault) if fault
                  else contextlib.nullcontext()):
                v, _ = runner.forward_tree_decode(flatten, plan)
            out[f"{kv} {name}"] = v.full_logits()[:WIDTH].float().cpu()
            if fault is None and kv == "inherit":
                out["collectives"] = rank_counts_of(
                    grid, {"prefill": prefill_staged, "decode": grid.staged - staged})
        runner.reset_state()
        runner.retain_full_logits = False
        out[f"{kv} runs"] = rank_generate(grid, runner, prompt,
                                          SHARDED_GEN,
                                          ("flatten", "seq"))
        out[f"{kv} peak GB"] = torch.cuda.max_memory_allocated(grid.device) / 1e9
        del runner
        release()
        if kv == "inherit":
            out["batch"] = rank_batch(grid, cfg, prompts)
            out["batch peak GB"] = torch.cuda.max_memory_allocated(grid.device) / 1e9
            # the batch runner sits in a cycle (its engine's recording
            # build_plan): freed once rank_batch has returned
            release()
    return out


def sharded_short_rank(grid):
    """The 16-token prompt on one rank of a grid with dp 2, bf16: flatten
    (its plans are not segment-aligned at the first steps: B11), then node,
    tree_index (on a runner with the tree-index pool) and Medusa (--mem
    unpaged --mode tree: the dense baseline on the rank's heads)."""
    import torch
    from deft_tpu_torch.cli.run import make_prompt
    from deft_tpu_torch.models import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS["8b"]
    prompt = make_prompt(None, 16 + GEN_LEN, cfg.vocab_size, SEED)
    out = {}
    for modes, index in ((("flatten", "node", ("tree", "unpaged")), False),
                         (("tree_index",), True)):
        runner = make_runner(cfg, None, grid.device, prompt_len=len(prompt), mesh=grid,
                             use_tree_index=index)
        runner.retain_full_logits = False
        out.update(rank_generate(grid, runner, prompt, SHARDED_GEN, modes))
        del runner
        release()
    return out


def sharded_moe_rank(grid):
    """mixtral-6l on one rank (2 of the 8 experts' tp halves): the moe
    path's prefill (its last-token logits and each rank's launches), then 8
    decode tokens in flatten mode."""
    import torch
    from deft_tpu_torch.models import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS["mixtral-6l"]
    runner = make_runner(cfg, None, grid.device, mesh=grid)
    prompt = moe_prompt(cfg)
    reset_counts()
    logits = runner.forward_prefill(prompt).full_logits()[0].float().cpu()
    torch.cuda.synchronize()
    counts = rank_counts(grid)
    runner.reset_state()
    runner.retain_full_logits = False
    return dict(logits=logits, prefill=counts,
                runs=rank_generate(grid, runner, prompt, SHARDED_GEN, ("flatten",)))


def layout_collectives(shape, step: str, layers: int, dp_rows: bool = True) -> int:
    """The collectives one forward of a rank makes on a (dp, sp, tp) grid,
    counted from the code: the tp sums after wo and wdown (2 a layer), at a
    decode step the sp merge (a MAX and a SUM a layer) and the dp join (of
    the new K/V rows a layer, and of the top-K once, with the rows over dp;
    of o a layer in the parent's layout, dp_rows=False), at a prefill with
    the tokens over sp the q/k/v join a layer and the last-token logits'
    sum over sp; the vocab join of the lm_head over tp once."""
    dp, sp, tp = shape
    n = 2 * layers * (tp > 1) + (tp > 1)
    if step == "decode":
        return n + 2 * layers * (sp > 1) + (layers + dp_rows) * (dp > 1)
    return n + (layers + 1) * (sp > 1 and dp_rows)


def sharded_dp_rank(grid, prompt, ids, weight_dtype, modes):
    """The 8B at 32 layers on one rank of DP_GRID, weights `weight_dtype`:
    the main prompt's prefill and first decode step (the rank's rows through
    the dense layers, models/llama.py forward_layers.last_rows, and the
    collectives gloo staged, each counted around that forward; the step's
    launches and ms; its logits, every row joined over dp), then
    SHARDED_GEN - 1 decode tokens in each of `modes` (rank_generate, under sync_checked).  Every
    rank's readings are gathered."""
    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.llama import forward_layers
    from deft_tpu_torch.runtime import ForwardMode

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, flatten = PRESETS["8b"], ForwardMode.TREE_DECODE_FLATTEN
    t0 = time.perf_counter()
    runner = make_runner(cfg, None, grid.device, mesh=grid, weight_dtype=weight_dtype)
    torch.cuda.synchronize()
    mine = {"setup s": time.perf_counter() - t0,
            "weights GB": sum(t.numel() * t.element_size()
                              for t in runner.params.values()) / 1e9}
    staged = grid.staged
    first_step(runner, prompt, ids)
    mine.update({"prefill rows": forward_layers.last_rows,
                 "prefill collectives": grid.staged - staged})
    plan = runner.build_plan(flatten)
    staged = grid.staged
    reset_counts()
    view, secs = runner.forward_tree_decode(flatten, plan)
    mine.update({"step rows": forward_layers.last_rows, "step ms": secs * 1e3,
                 "step collectives": grid.staged - staged, "step launches": read_counts(),
                 "leaves": plan.n_leaves, "l_pad": plan.l_pad})
    out = {"first": view.full_logits()[:WIDTH].float().cpu()}
    runner.reset_state()
    runner.retain_full_logits = False
    out["runs"] = rank_generate(grid, runner, prompt, SHARDED_GEN, modes)
    mine["peak GB"] = torch.cuda.max_memory_allocated(grid.device) / 1e9
    out["ranks"] = rank_counts_of(grid, mine)
    del runner
    release()
    return out


def run_grid(fn, shape, args=()):
    """parallel.launch over gloo on the one card; a failure in any rank
    fails the script."""
    from deft_tpu_torch.parallel import launch

    try:
        return launch(fn, shape, "cuda", "gloo", args=args, timeout=900)
    except RuntimeError as e:
        raise Failure(f"grid {shape}: {e}") from e


def phase_sharded(prompt, ids, lf, lq, main_runs, batch_runs):
    """Four ranks on the one card over gloo, grid 1x2x2 (tp 2 over heads
    and Megatron columns, sp 2 over the plan's blocks): the 8B model at 32
    layers from the main path's seed.  B3 prefill, B1p flatten and B2p seq
    decode on each rank, B1 and B2 never; the first step's logits against
    the single-card main path's below LOGITS_LIMIT, the dropped-span fault
    above it; then the batch path's four requests through BatchedEngine,
    flatten then seq, chained under set_sync_debug_mode("error"): B8 on
    every rank's admission, B1p or B11 (flatten) and B2p or B7 (seq) on
    every rank, no single-device decode kernel, the admission's logits
    against the single-card batch path's below LOGITS_LIMIT (the vocab join
    left out above it), greedy ids against its runs (`batch_runs`); then
    the int8 KV cache (B4p,
    B5p), its first step against the int8 path's; then a 2x1x2 grid over
    the 16-token prompt: flatten (B11, dp 2), node, tree_index and Medusa.
    Times are those of four processes sharing one card."""
    from deft_tpu_torch.parallel.multihost import check_backend

    try:
        check_backend("nccl", 4, "cuda")
        raise Failure("nccl was not refused for four ranks on one card")
    except ValueError as e:
        check("gloo" in str(e), f"the nccl refusal does not name gloo: {e}")
    t0 = time.perf_counter()
    out = run_grid(sharded_rank, SHARDED_GRID, (prompt, ids, batch_prompts()))
    wall = time.perf_counter() - t0
    readings = {name: rel_l2(out[f"inherit {name}"], lf)
                for name in ("first", "first, sp rank 1 dropped")}
    by_sp = out["inherit live tokens by sp rank"]
    readings["int8 first"] = rel_l2(out["int8 first"], lq)
    print(f"[sharded] grid {SHARDED_GRID} on one card over gloo, 8b at 32 layers: "
          f"{out['inherit weights GB']:.2f} GB of weights a rank, set-up "
          f"{out['inherit setup s']:.1f} s, peak {out['inherit peak GB']:.2f} GB a rank "
          f"(rank 0); whole launch {wall:.1f} s", flush=True)
    print(f"[sharded] first decode step (plan paged={out['inherit first paged']}, "
          f"{out['inherit plan tokens']} plan tokens, live tokens by sp rank "
          f"{by_sp}), relative L2 of the logits against "
          f"the single-card main path's: sharded {readings['first']:.3e}, sp rank 1's "
          f"span left out of every merge {readings['first, sp rank 1 dropped']:.3e} "
          f"(limit {LOGITS_LIMIT:.0e}); int8 KV against the int8 path's "
          f"{readings['int8 first']:.3e}", flush=True)
    from deft_tpu_torch.models import PRESETS

    L = PRESETS["8b"].num_layers
    print(f"[sharded] collectives gloo staged by rank: the prefill (its 4000 tokens "
          f"over sp) {[c['prefill'] for c in out['collectives']]}, the first decode step "
          f"{[c['decode'] for c in out['collectives']]} (the code's count: prefill "
          f"{layout_collectives(SHARDED_GRID, 'prefill', L)} on the ranks holding the "
          f"last token, one fewer on the others, decode "
          f"{layout_collectives(SHARDED_GRID, 'decode', L)}; the parent's replicated "
          f"rows: {layout_collectives(SHARDED_GRID, 'prefill', L, dp_rows=False)} / "
          f"{layout_collectives(SHARDED_GRID, 'decode', L, dp_rows=False)})", flush=True)
    # the check covers every span only if every span holds a real share
    check(min(by_sp) >= 0.25 * sum(by_sp),
          f"an sp span holds under a quarter of the live tokens: {by_sp}")
    check(readings["first"] < LOGITS_LIMIT,
          f"sharded first-step logits stray from the single card's: {readings['first']}")
    check(readings["first, sp rank 1 dropped"] > LOGITS_LIMIT,
          "a dropped sp span stays under the limit: the check cannot see it")
    check(readings["int8 first"] < LOGITS_LIMIT,
          f"sharded int8 first-step logits stray: {readings['int8 first']}")
    launches = {}
    for kv, gen in (("inherit", SHARDED_GEN - 1), ("int8", SHARDED_GEN - 1)):
        for mode, r in out[f"{kv} runs"].items():
            check(len(r["seqs"]) == WIDTH and all(len(x) == gen for x in r["seqs"]),
                  f"sharded {kv} {mode}: expected {WIDTH} branches of {gen} tokens")
            rank0 = r["counts"][0]
            for k, n in rank0.items():
                launches[k] = launches.get(k, 0) + n
            same = ""
            if kv == "inherit":
                want = main_runs[mode]["seqs"]
                share = np.mean([a == b for x, y in zip(r["seqs"], want)
                                 for a, b in zip(x, y)])
                same = f", greedy ids equal to the main path's at {share:.4f} of positions"
            print(f"[sharded] {kv} {mode}: TTFT {r['TTFT']:.3f} ms, TPOT {r['TPOT']:.4f} ms "
                  f"(four ranks sharing one card), plans paged at {sum(r['paged'])} of "
                  f"{len(r['paged'])} steps{same}; launches by rank "
                  f"{[{k: n for k, n in c.items() if n} for c in r['counts']]}", flush=True)
            for c in r["counts"]:
                check(c["paged_flatten"] == 0 and c["paged_seq"] == 0
                      and c["paged_flatten_q"] == 0 and c["paged_seq_q"] == 0,
                      f"sharded {kv} {mode}: a single-device decode kernel launched: {c}")
                check(c["prefill"] > 0, f"sharded {kv} {mode}: B3 did not launch: {c}")
                want = {("inherit", "flatten"): "paged_flatten_partial",
                        ("inherit", "seq"): "paged_seq_partial",
                        ("int8", "flatten"): "paged_flatten_q_partial",
                        ("int8", "seq"): "paged_seq_q_partial"}[kv, mode]
                check(c[want] > 0, f"sharded {kv} {mode}: {want} did not launch: {c}")
    sharded_batch(out, batch_runs, launches)
    t0 = time.perf_counter()
    short_runs = run_grid(sharded_short_rank, SHORT_GRID)
    short = short_runs["flatten"]
    c0 = short["counts"][0]
    print(f"[sharded] 16-token prompt, grid {SHORT_GRID}, flatten:TTFT {short['TTFT']:.3f} ms, "
          f"TPOT {short['TPOT']:.4f} ms (four ranks sharing one card), plans paged at "
          f"{sum(short['paged'])} of {len(short['paged'])} steps; launches by rank "
          f"{[{k: n for k, n in c.items() if n} for c in short['counts']]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(len(short["seqs"]) == WIDTH, "sharded short: wrong branch count")
    for c in short["counts"]:
        check(c["flatten_gather_partial"] > 0 and c["flatten_gather"] == 0,
              f"sharded short: B11 did not launch on every rank (dp 2): {c}")
    launches["flatten_gather_partial"] += c0["flatten_gather_partial"]
    sharded_modes(short_runs, launches)
    return launches


SINGLE_DECODE = ("paged_flatten", "paged_seq", "paged_flatten_q", "paged_seq_q",
                 "flatten_gather")


def sharded_batch(out, batch_runs, launches) -> None:
    """Check and print the sharded batch path (rank_batch): the admission's
    last-token logits on rank 0 (joined over tp) against the single-card
    batch path's admission (`batch_runs["admission"]`) below LOGITS_LIMIT
    for every request, and above it with the vocab join left out (rank 0's
    own vocab block, zeros elsewhere: what rank 0 holds without the join);
    on every rank B8 once a layer at admission and B3 never, the mode's
    partial kernels launched (flatten: B11 on the gather steps and B1p on
    the paged ones; seq: B2p), the single-device decode kernels never; the greedy ids' share equal to
    the single-card batch path's, printed (branches sorted, as phase_batch
    compares them; bf16 near-ties flip tokens, PERF.md); rank 0's launches
    of the partial entries and B8 join `launches`."""
    from deft_tpu_torch.models import PRESETS

    L = PRESETS["8b"].num_layers
    pairs = {"flatten": ("paged_flatten_partial", "flatten_gather_partial"),
             "seq": ("paged_seq_partial", "seq_gather")}
    runs = {m: r for m, r in out["batch"].items() if m != "raw gloo"}
    print(f"[sharded-batch] grid {SHARDED_GRID}, the batch path's {len(BATCH_LENS)} "
          f"requests ({'/'.join(map(str, BATCH_LENS))} tokens, width {WIDTH}) through "
          f"BatchedEngine, peak {out['batch peak GB']:.2f} GB a rank (rank 0); a plain "
          f"gloo all_reduce of a CUDA tensor under set_sync_debug_mode('error') "
          f"{out['batch']['raw gloo']} (Grid.all_reduce lowers the check around gloo's "
          f"staging and counts it)", flush=True)
    want = batch_runs["admission"]
    for mode, r in runs.items():
        got = r["logits"]
        block = got.shape[-1] // SHARDED_GRID[2]
        unjoined = got.clone()
        unjoined[:, block:] = 0
        err = max(rel_l2(got[i], want[i]) for i in range(len(want)))
        err_fault = min(rel_l2(unjoined[i], want[i]) for i in range(len(want)))
        print(f"[sharded-batch] {mode}: admission's last-token logits against the "
              f"single-card batch path's, relative L2 at most {err:.3e} over the "
              f"{len(want)} requests, with the vocab join left out at least "
              f"{err_fault:.3e} (limit {LOGITS_LIMIT:.0e})", flush=True)
        check(tuple(got.shape) == tuple(want.shape) and bool(got.isfinite().all()),
              f"sharded batch {mode}: admission logits {tuple(got.shape)}, not finite "
              f"or not {tuple(want.shape)}")
        check(err < LOGITS_LIMIT,
              f"sharded batch {mode}: admission logits stray from the single card's: {err}")
        check(err_fault > LOGITS_LIMIT,
              f"sharded batch {mode}: the vocab join left out stays under the limit")
        seqs = r["seqs"]
        check(all(len(b) == WIDTH and all(len(x) == SHARDED_BATCH_GEN - 1 for x in b)
                  for b in seqs),
              f"sharded batch {mode}: expected {WIDTH} branches of "
              f"{SHARDED_BATCH_GEN - 1} tokens per request")
        tok = sum(len(x) for b in seqs for x in b)
        same = [a == b for got, want in zip(seqs, batch_runs[mode][0])
                for x, y in zip(sorted(got), sorted(want)) for a, b in zip(x, y)]
        print(f"[sharded-batch] {mode}: admission (one ragged prefill, B8 on each rank's "
              f"16 query / 4 KV heads) {r['admission_ms']:.3f} ms, {r['steps']} steps, "
              f"{tok} generated tokens in {r['wall_ms']:.1f} ms, "
              f"{r['wall_ms'] / tok:.4f} ms/token aggregate (four ranks sharing one "
              f"card), plans paged at {sum(r['paged'])} of {len(r['paged'])} steps "
              f"({[i for i, p in enumerate(r['paged']) if p]}); "
              f"rank 0's host waits {r['waits']}, collectives gloo staged through the "
              f"host {r['staged']} taking {r['staged_ms']:.1f} ms "
              f"({r['admission_staged_ms']:.1f} of them in the admission); greedy ids "
              f"equal to the single-card batch path's at "
              f"{np.mean(same):.4f} of positions (branches sorted); chained under "
              f"set_sync_debug_mode('error'); admission launches by rank "
              f"{[{k: n for k, n in c.items() if n} for c in r['admission']]}; run "
              f"launches by rank {[{k: n for k, n in c.items() if n} for c in r['counts']]}",
              flush=True)
        # flatten: B11 on the gather plans, B1p once the plans come out paged
        need = pairs[mode] if mode == "flatten" else pairs[mode][:1]
        for a, c in zip(r["admission"], r["counts"]):
            check(a["ragged_prefill"] == L and a["prefill"] == 0,
                  f"sharded batch {mode}: admission launched {a}, not B8 once a layer")
            check(all(c[k] > 0 for k in need),
                  f"sharded batch {mode}: not all of {need} launched: {c}")
            check(all(c[k] == 0 for k in SINGLE_DECODE),
                  f"sharded batch {mode}: a single-device decode kernel launched: {c}")
        for k, n in r["counts"][0].items():
            if k in PARTIAL_OF or k == "ragged_prefill":
                launches[k] = launches.get(k, 0) + n


def sharded_modes(runs, launches) -> None:
    """Check and print the short grid's node, tree_index and Medusa runs:
    WIDTH branches of SHARDED_GEN - 1 tokens each, as the short path checks its
    runs; node and tree_index through B1p or B11 on every rank, Medusa
    through no decode kernel (the dense baseline); no single-device decode
    kernel; greedy ids against the grid's flatten run.  Rank 0's partial
    launches join `launches`."""
    flat = runs["flatten"]["seqs"]
    for mode in ("node", "tree_index", "unpaged tree"):
        r = runs[mode]
        same = np.mean([a == b for x, y in zip(r["seqs"], flat) for a, b in zip(x, y)])
        print(f"[sharded] 16-token prompt, grid {SHORT_GRID}, {mode}: TTFT "
              f"{r['TTFT']:.3f} ms, TPOT {r['TPOT']:.4f} ms, e2e {r['e2e']:.1f} ms (four "
              f"ranks sharing one card), "
              f"plans paged at {sum(r['paged'])} of {len(r['paged'])} steps, greedy ids "
              f"equal to flatten's at {same:.4f} of positions; launches by rank "
              f"{[{k: n for k, n in c.items() if n} for c in r['counts']]}", flush=True)
        check(len(r["seqs"]) == WIDTH and all(len(x) == SHARDED_GEN - 1 for x in r["seqs"]),
              f"sharded short {mode}: expected {WIDTH} branches of {SHARDED_GEN - 1} "
              "tokens")
        for c in r["counts"]:
            check(all(c[k] == 0 for k in SINGLE_DECODE + ("seq_gather",)),
                  f"sharded short {mode}: a single-device decode kernel launched: {c}")
            partial = c["paged_flatten_partial"] + c["flatten_gather_partial"]
            check(c["prefill"] > 0 and (partial == 0 if mode == "unpaged tree"
                                        else partial > 0),
                  f"sharded short {mode}: launches by rank {c}")
        for k, n in r["counts"][0].items():
            if k in PARTIAL_OF:
                launches[k] = launches.get(k, 0) + n


def phase_sharded_moe(moe_ref, grids=(SHARDED_GRID, DP_GRID)):
    """mixtral-6l on grid 1x2x2 over gloo on the one card: 4 experts a rank
    (sp 2), their inner dims over tp 2; the prefill's B10 launches on every
    rank, its last-token logits against the moe path's (`moe_ref`, phase_moe)
    below MOE_LIMIT; then SHARDED_GEN - 1 decode tokens.  Then on DP_GRID, the MoE block
    on its dp rows (sharded_moe_dp).  `grids`: which of the two run."""
    from deft_tpu_torch.models import PRESETS

    per = 3 * PRESETS["mixtral-6l"].num_layers
    if SHARDED_GRID in grids:
        t0 = time.perf_counter()
        out = run_grid(sharded_moe_rank, SHARDED_GRID)
        e = rel_l2(out["logits"], moe_ref["prefill"])
        run = out["runs"]["flatten"]
        print(f"[sharded-moe] grid {SHARDED_GRID}: prefill last-token logits against the "
              f"moe path's, relative L2 {e:.3e} (limit {MOE_LIMIT:g}), top-1 equal "
              f"{int(out['logits'].argmax()) == int(moe_ref['prefill'].argmax())}; prefill "
              f"launches by rank {[{k: n for k, n in c.items() if n} for c in out['prefill']]}; "
              f"{SHARDED_GEN - 1} decode tokens: TTFT {run['TTFT']:.3f} ms, TPOT {run['TPOT']:.4f} ms (four "
              f"ranks sharing one card); {time.perf_counter() - t0:.1f} s", flush=True)
        check(e < MOE_LIMIT, f"sharded MoE prefill logits stray from the moe path's: {e}")
        for c in out["prefill"]:
            check(c["gmm"] == per and c["gmm_scaled"] == 0,
                  f"sharded-moe: B10 launches of a rank's prefill {c}, expected gmm {per}")
        check(len(run["seqs"]) == WIDTH and all(len(x) == SHARDED_GEN - 1 for x in run["seqs"]),
              f"sharded-moe: expected {WIDTH} branches of {SHARDED_GEN - 1} tokens")
    if DP_GRID in grids:
        sharded_moe_dp(moe_ref, per)


def sharded_moe_dp_rank(grid, prompt, ids):
    """mixtral-6l on one rank of DP_GRID (every expert, its inner dims over
    tp 2): the moe path's prefill and first decode step on its branch
    tokens `ids`, with the rows each MoE block call took (runner._shard.moe)
    and the launches counted around the prefill; the step's logits, every
    row joined over dp; then SHARDED_GEN tokens in flatten (rank_generate).
    Every rank's readings are gathered."""
    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.llama import forward_layers
    from deft_tpu_torch.runtime import ForwardMode

    torch.backends.cuda.matmul.allow_tf32 = False
    flatten = ForwardMode.TREE_DECODE_FLATTEN
    runner = make_runner(PRESETS["mixtral-6l"], None, grid.device, mesh=grid)
    moe, rows = runner._shard.moe, []

    def counting_moe(cfg, lp, h, window):
        rows.append(h.shape[0])
        return moe(cfg, lp, h, window)

    runner._shard.moe = counting_moe
    reset_counts()
    first_step(runner, prompt, ids)
    mine = {"prefill": read_counts(), "prefill moe rows": sorted(set(rows))}
    rows.clear()
    plan = runner.build_plan(flatten)
    view, _ = runner.forward_tree_decode(flatten, plan)
    mine.update({"step moe rows": list(rows), "step rows": forward_layers.last_rows,
                 "l_pad": plan.l_pad})
    runner._shard.moe = moe
    out = {"first": view.full_logits()[:WIDTH].float().cpu()}
    runner.reset_state()
    runner.retain_full_logits = False
    out["runs"] = rank_generate(grid, runner, prompt, SHARDED_GEN, ("flatten",))
    out["ranks"] = rank_counts_of(grid, mine)
    del runner
    release()
    return out


def sharded_moe_dp(moe_ref, per) -> None:
    """(h) mixtral-6l on DP_GRID (sharded_moe_dp_rank): each rank runs its
    dp window, half the plan's padded rows, through every layer's MoE block
    at the first decode step; B10 (gmm) takes every rank's prefill, `per`
    launches; the step's logits against the moe path's flatten step
    (`moe_ref`) below MOE_STEP_LIMIT, with the other dp window's rows left
    out above it; SHARDED_GEN tokens in flatten: WIDTH branches, B11 or B1p
    on every rank."""
    from deft_tpu_torch.models import PRESETS

    L, dp = PRESETS["mixtral-6l"].num_layers, DP_GRID[0]
    t0 = time.perf_counter()
    out = run_grid(sharded_moe_dp_rank, DP_GRID, (moe_prompt(PRESETS["mixtral-6l"]),
                                                   moe_ref["ids"]))
    tag = f"[sharded-moe] grid {DP_GRID}"
    ranks, first, want = out["ranks"], out["first"], moe_ref["first"]
    unjoined = first.clone()
    unjoined[ranks[0]["l_pad"] // dp:] = 0
    err, err_fault = rel_l2(first, want), rel_l2(unjoined, want)
    run = out["runs"]["flatten"]
    print(f"{tag}: rows through the MoE block by rank, a decode step "
          f"{[r['step moe rows'] for r in ranks]} (plan {ranks[0]['l_pad']} rows; dense "
          f"layers {[r['step rows'] for r in ranks]}), the prefill "
          f"{[r['prefill moe rows'] for r in ranks]}; prefill launches by rank "
          f"{[{k: n for k, n in r['prefill'].items() if n} for r in ranks]}; first decode "
          f"step's logits against the moe path's, relative L2 {err:.3e}, with the other dp "
          f"window's rows left out {err_fault:.3e} (limit {MOE_STEP_LIMIT:g}); "
          f"{SHARDED_GEN - 1} decode tokens: TTFT {run['TTFT']:.3f} ms, TPOT "
          f"{run['TPOT']:.4f} ms (four ranks sharing one card), launches by rank "
          f"{[{k: n for k, n in c.items() if n} for c in run['counts']]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(tuple(first.shape) == tuple(want.shape) and bool(first.isfinite().all()),
          f"{tag}: first-step logits {tuple(first.shape)} not finite or not "
          f"{tuple(want.shape)}")
    check(err < MOE_STEP_LIMIT, f"{tag}: first-step logits stray from the moe path's: {err}")
    check(err_fault > MOE_STEP_LIMIT,
          f"{tag}: the dp join left out stays under the limit: {err_fault}")
    for r in ranks:
        half = r["l_pad"] // dp
        check(r["step moe rows"] == [half] * L and r["step rows"] == half,
              f"{tag}: a rank's MoE blocks took {r['step moe rows']} rows at a decode step "
              f"(dense layers {r['step rows']}), not {half} in each of {L} layers")
        check(r["prefill"]["gmm"] == per and r["prefill"]["gmm_scaled"] == 0,
              f"{tag}: B10 launches of a rank's prefill {r['prefill']}, expected gmm {per}")
    check(len(run["seqs"]) == WIDTH and all(len(x) == SHARDED_GEN - 1 for x in run["seqs"]),
          f"{tag}: expected {WIDTH} branches of {SHARDED_GEN - 1} tokens")
    for c in run["counts"]:
        check(c["paged_flatten_partial"] + c["flatten_gather_partial"] > 0
              and all(c[k] == 0 for k in SINGLE_DECODE),
              f"{tag} flatten: launches of a rank {c}")


def phase_sharded_dp(prompt, ids, lf, lw, main_runs):
    """The 8B on DP_GRID, four ranks on the one card over gloo: each dp rank
    runs its window of the plan's rows (64 for the 50 leaves: 32 a rank)
    through every layer, as deft_tpu's batch specs lay a decode step out
    (parallel/sharding.py).
    bf16 weights: the rows at the prefill and a decode step, the
    collectives against layout_collectives' counts (this layout's, and the
    replicated one's of the parent), the first step's logits against the
    main path's `lf` below LOGITS_LIMIT and, with the other dp window's rows
    left out (what rank 0 holds without the join), above it; 8 tokens
    flatten then seq: B1p / B2p and B3 on every rank, no single-card decode
    kernel, greedy ids against `main_runs`.  int8-pallas weights, flatten:
    B9 129 times a decode step on every rank, the first step against the
    int8w path's `lw`.  Returns rank 0's launches of the runs."""
    from deft_tpu_torch.models import PRESETS

    L = PRESETS["8b"].num_layers
    dp = DP_GRID[0]
    launches = {}
    for wdt, modes, want_first in (("inherit", ("flatten", "seq"), lf),
                                   ("int8-pallas", ("flatten",), lw)):
        t0 = time.perf_counter()
        out = run_grid(sharded_dp_rank, DP_GRID, (prompt, ids, wdt, modes))
        wall = time.perf_counter() - t0
        tag = f"[sharded-dp] grid {DP_GRID}, {wdt} weights"
        ranks = out["ranks"]
        got = out["first"]
        unjoined = got.clone()
        unjoined[ranks[0]["l_pad"] // dp:] = 0  # what rank 0 holds without the dp join
        err, err_fault = rel_l2(got, want_first), rel_l2(unjoined, want_first)
        want = {step: layout_collectives(DP_GRID, step, L) for step in ("prefill", "decode")}
        parent = {step: layout_collectives(DP_GRID, step, L, dp_rows=False)
                  for step in ("prefill", "decode")}
        r0 = ranks[0]
        rows = r0["l_pad"] // dp  # the plan's rows (the leaves and its pad rows) over dp
        print(f"{tag}: {r0['weights GB']:.2f} GB of weights a rank, set-up "
              f"{r0['setup s']:.1f} s, peak {[round(r['peak GB'], 2) for r in ranks]} GB by "
              f"rank; whole launch {wall:.1f} s", flush=True)
        print(f"{tag}: rows through wqkv and wgu by rank: prefill "
              f"{[r['prefill rows'] for r in ranks]}, a decode step "
              f"{[r['step rows'] for r in ranks]} ({r0['leaves']} leaves, plan "
              f"{r0['l_pad']} rows); collectives gloo staged by rank: prefill "
              f"{[r['prefill collectives'] for r in ranks]}, the first decode step "
              f"{[r['step collectives'] for r in ranks]} (the code's count: {want['prefill']} "
              f"/ {want['decode']}; the parent's replicated rows: {parent['prefill']} / "
              f"{parent['decode']}); first step {[round(r['step ms'], 3) for r in ranks]} ms "
              f"by rank (four ranks sharing one card); its launches by rank "
              f"{[{k: n for k, n in r['step launches'].items() if n} for r in ranks]}",
              flush=True)
        print(f"{tag}: first decode step's logits against the single card's "
              f"({'main' if wdt == 'inherit' else 'int8w'} path), relative L2 {err:.3e}, "
              f"with the other dp window's rows left out {err_fault:.3e} (limit "
              f"{LOGITS_LIMIT:.0e})", flush=True)
        check(tuple(got.shape) == tuple(want_first.shape) and bool(got.isfinite().all()),
              f"{tag}: first-step logits {tuple(got.shape)} not finite or not "
              f"{tuple(want_first.shape)}")
        check(err < LOGITS_LIMIT, f"{tag}: first-step logits stray: {err}")
        check(err_fault > LOGITS_LIMIT,
              f"{tag}: the dp join left out stays under the limit: {err_fault}")
        for r in ranks:
            check(r["step rows"] == rows and r["prefill rows"] == PROMPT_LEN,
                  f"{tag}: a rank ran {r['prefill rows']} prefill rows and "
                  f"{r['step rows']} decode rows, not {PROMPT_LEN} and {rows}")
            check(r["prefill collectives"] == want["prefill"]
                  and r["step collectives"] == want["decode"],
                  f"{tag}: collectives {r['prefill collectives']} / "
                  f"{r['step collectives']}, the code says {want}")
            if wdt != "inherit":
                per_step = 4 * L + 1
                check(r["step launches"].get("int8_matmul", 0) == per_step,
                      f"{tag}: B9 launched {r['step launches'].get('int8_matmul', 0)} "
                      f"times in a decode step, not {per_step}")
        for mode, run in out["runs"].items():
            check(len(run["seqs"]) == WIDTH and all(len(x) == SHARDED_GEN - 1
                                                    for x in run["seqs"]),
                  f"{tag} {mode}: expected {WIDTH} branches of {SHARDED_GEN - 1} tokens")
            share = np.mean([a == b for x, y in zip(run["seqs"], main_runs[mode]["seqs"])
                             for a, b in zip(x, y)])
            print(f"{tag} {mode}: TTFT {run['TTFT']:.3f} ms, TPOT {run['TPOT']:.4f} ms "
                  f"(four ranks sharing one card), plans paged at {sum(run['paged'])} of "
                  f"{len(run['paged'])} steps, greedy ids equal to the main path's at "
                  f"{share:.4f} of positions; under set_sync_debug_mode('error'); "
                  f"launches by rank "
                  f"{[{k: n for k, n in c.items() if n} for c in run['counts']]}", flush=True)
            want_k = "paged_flatten_partial" if mode == "flatten" else "paged_seq_partial"
            for c in run["counts"]:
                check(all(c[k] == 0 for k in SINGLE_DECODE + ("seq_gather",)),
                      f"{tag} {mode}: a single-card decode kernel launched: {c}")
                check(c["prefill"] > 0 and c[want_k] > 0,
                      f"{tag} {mode}: B3 or {want_k} did not launch: {c}")
            for k, n in run["counts"][0].items():
                if k in PARTIAL_OF or k == "int8_matmul":
                    launches[k] = launches.get(k, 0) + n
    return launches


# -- checkpoint and restore, model families, tracing ---------------------------------

def grow_greedy(runner, prompt, steps):
    """Prefill `prompt`, branch the root into WIDTH leaves (the prefill's
    top WIDTH tokens), then `steps` greedy flatten steps, each leaf taking
    its argmax: the main path's Simple_Tree up to mid-run."""
    from deft_tpu_torch.runtime import ForwardMode

    flatten = ForwardMode.TREE_DECODE_FLATTEN
    _, ids = runner.forward_prefill(prompt).topk(0, WIDTH)
    tree = runner.tree
    for c, child in enumerate(tree.branch(tree.root, WIDTH)):
        child.append_token(int(ids[c]))
    for _ in range(steps):
        tree.alloc()
        view, _ = runner.forward_tree_decode(flatten, runner.build_plan(flatten),
                                             logits_kind="greedy")
        tok, _ = view.argmax()
        for leaf in list(tree.leaves.values()):
            leaf.append_token(int(tok[tree.leaf_to_q[leaf.id]]))


def next_step_logits(runner, fault=False):
    """The next flatten step's (WIDTH, V) fp32 logits on the runner's tree
    (alloc, plan, forward); with `fault` also the same step with one FULL
    block of the prompt hidden (``drop_block``), run second."""
    from unittest import mock

    from deft_tpu_torch.runtime import ForwardMode

    flatten = ForwardMode.TREE_DECODE_FLATTEN
    runner.tree.alloc()
    plan = runner.build_plan(flatten)
    out = [runner.forward_tree_decode(flatten, plan)[0].full_logits()[:WIDTH].float()]
    if fault:
        attn = plan_edited(runner._attn_fn(flatten, runner._use_paged(plan, flatten)),
                           drop_block)
        with mock.patch.object(runner, "_attn_fn", lambda m, paged: attn):
            out.append(runner.forward_tree_decode(flatten, plan)[0].full_logits()[:WIDTH]
                       .float())
    return out


def phase_checkpoint(dev, params, prompt):
    """Checkpoint and restore (runtime/checkpoint.py) mid-run on the main
    path: the 8B bf16 weights at 32 layers, prompt 4000, WIDTH leaves,
    GEN_LEN // 2 greedy flatten steps, then save_checkpoint; a fresh runner
    on the same weights restores the file (each root-to-leaf path
    re-prefilled through B3) and takes the next step beside the
    uninterrupted runner.  The restored tree's nodes must equal the saved
    ones; the next step's logits must lie below LOGITS_LIMIT of the
    uninterrupted run's, with a dropped prompt block above it; the greedy
    ids are compared and printed (bf16: the restored KV of the decoded
    tokens went through B3's rounding, not B1's).  Then the same on the 8B
    widths at 4 layers in fp32 (depth cut for the fp32 weights' and
    re-prefills' time), where rounding cannot move an argmax: every leaf's
    next greedy id must equal the uninterrupted run's."""
    import dataclasses

    import torch
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.loader import random_params
    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.runtime.checkpoint import restore, save_checkpoint

    path = str(_cuda.BUILD / "checkpoint.json")
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    cfg32 = dataclasses.replace(PRESETS["8b"], num_layers=4)
    for tag, cfg, weights, dtype in (("bf16", PRESETS["8b"], params, "bfloat16"),
                                     ("fp32 4 layers", cfg32, None, "float32")):
        if weights is None:
            weights = random_params(cfg, SEED, dev, torch.float32)
        t0 = time.perf_counter()
        runner = make_runner(cfg, weights, dev, dtype=dtype)
        grow_greedy(runner, prompt, GEN_LEN // 2 - 1)
        save_checkpoint(runner.tree, path)
        saved = {n.id: (list(n.token_ids), n.kv_len, n.position_offset)
                 for n in runner.tree.nodes.values()}
        want, fault = next_step_logits(runner, fault=True)
        del runner
        fresh = make_runner(cfg, weights, dev, dtype=dtype)
        t1 = time.perf_counter()
        restore(fresh, path)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t1
        got = {n.id: (list(n.token_ids), n.kv_len, n.position_offset)
               for n in fresh.tree.nodes.values()}
        check(got == saved, f"checkpoint {tag}: the restored tree differs from the saved one")
        (logits,) = next_step_logits(fresh)
        err, err_fault = rel_l2(logits, want), rel_l2(fault, want)
        same = int((logits.argmax(-1) == want.argmax(-1)).sum())
        print(f"[checkpoint] {tag}: {len(saved)} nodes, {fresh.tree.get_tree_kv_len()} KV "
              f"tokens saved after {GEN_LEN // 2 - 1} steps ({os.path.getsize(path)} bytes); "
              f"restore (re-prefill of {WIDTH} paths) {t_restore:.2f} s; next step's "
              f"logits against the uninterrupted run's: relative L2 {err:.3e}, the "
              f"uninterrupted step with a prompt block dropped {err_fault:.3e} (limit "
              f"{LOGITS_LIMIT:.0e}); greedy ids equal on {same} of {WIDTH} leaves; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(err < LOGITS_LIMIT, f"checkpoint {tag}: restored logits stray: {err}")
        check(err_fault > LOGITS_LIMIT, f"checkpoint {tag}: a dropped block stays under "
              f"the limit ({err_fault})")
        if dtype == "float32":
            check(same == WIDTH, f"checkpoint {tag}: greedy ids differ on "
                  f"{WIDTH - same} leaves after restore")
        del fresh, weights
        release()
    os.remove(path)


# Published configurations (each model's config.json on the Hugging Face
# hub, as named), typed in: the families phase serves them at full width
# and depth from random weights, and writes and loads each at full width
# and 2 layers.  name -> (source, config.json fields)
FAMILIES = {
    "qwen2.5-7b": ("huggingface.co/Qwen/Qwen2.5-7B config.json", {
        "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
        "hidden_size": 3584, "intermediate_size": 18944, "num_hidden_layers": 28,
        "num_attention_heads": 28, "num_key_value_heads": 4, "vocab_size": 152064,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-06, "max_position_embeddings": 131072,
        "sliding_window": 131072, "use_sliding_window": False, "max_window_layers": 28,
        "tie_word_embeddings": False, "hidden_act": "silu", "torch_dtype": "bfloat16"}),
    "qwen3-8b": ("huggingface.co/Qwen/Qwen3-8B config.json", {
        "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
        "hidden_size": 4096, "intermediate_size": 12288, "num_hidden_layers": 36,
        "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
        "vocab_size": 151936, "rope_theta": 1000000, "rms_norm_eps": 1e-06,
        "max_position_embeddings": 40960, "sliding_window": None,
        "use_sliding_window": False, "attention_bias": False,
        "tie_word_embeddings": False, "hidden_act": "silu", "torch_dtype": "bfloat16"}),
    "gemma-7b": ("huggingface.co/google/gemma-7b config.json", {
        "architectures": ["GemmaForCausalLM"], "model_type": "gemma",
        "hidden_size": 3072, "intermediate_size": 24576, "num_hidden_layers": 28,
        "num_attention_heads": 16, "num_key_value_heads": 16, "head_dim": 256,
        "vocab_size": 256000, "rope_theta": 10000.0, "rms_norm_eps": 1e-06,
        "max_position_embeddings": 8192, "attention_bias": False, "hidden_act": "gelu",
        "hidden_activation": "gelu_pytorch_tanh", "torch_dtype": "bfloat16"}),
    # Phi-3-mini's widths at D 96; both packages refuse its active window
    "phi-3-mini": ("huggingface.co/microsoft/Phi-3-mini-4k-instruct config.json, not the "
                   "published config: sliding_window 2047 set to null", {
        "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
        "hidden_size": 3072, "intermediate_size": 8192, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 32, "vocab_size": 32064,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-05, "max_position_embeddings": 4096,
        "original_max_position_embeddings": 4096, "rope_scaling": None,
        "sliding_window": None, "attention_bias": False, "tie_word_embeddings": False,
        "hidden_act": "silu", "torch_dtype": "bfloat16"}),
}
CHECKPOINT_LAYERS = 2
# the families phase_families also writes and loads at CHECKPOINT_LAYERS
# (the others are served only: the loader is covered, and the script keeps
# inside its time limit)
LOADED_FAMILIES = ("qwen2.5-7b", "qwen3-8b", "gemma-7b")
# Each family's first-step limit (family_serve): the geometric mean of its
# one-ulp noise control and its every-other-prompt-block fault on an H100
# (PERF.md §4), rounded down.  Qwen2.5-7B: 1.597e-2 and 7.300e-2
# (one dropped block only 2.260e-2: its random V bias is most of each
# attention output); Qwen3-8B: 2.232e-2 and 6.427e-1; Gemma-7B: 8.997e-2
# and 1.366 (its (1 + w) norms at w = 1 and sqrt(3072)-scaled embeddings
# amplify one ulp of noise past the 8B path's LOGITS_LIMIT); Phi-3-mini's
# widths: 1.972e-2 and 5.375e-1
FAMILY_LIMITS = {"qwen2.5-7b": 3e-2, "qwen3-8b": 1e-1, "gemma-7b": 3e-1, "phi-3-mini": 1e-1}


def write_safetensors(path, tensors: dict) -> None:
    """A ``.safetensors`` file, written without the safetensors package (the
    card's machine has none): an 8-byte little-endian header length, the
    JSON header (name -> dtype, shape, byte offsets), padded with spaces to
    8 bytes, then each tensor's raw little-endian bytes in order."""
    import torch

    codes = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, o = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [o, o + n]}
        o += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())


def family_checkpoint(cfg, dev, gen) -> tuple:
    """Random bf16 tensors of `cfg` under their HF names (N(0, 1) / sqrt(fan
    in); norms 1 + N(0, 0.1)), and the port's fused parameters they must load
    as, built here from the HF layout without the loader."""
    import torch

    E, D, I, V = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.vocab_size
    qd, kvd = cfg.num_q_heads * D, cfg.num_kv_heads * D

    def w(*shape):
        fan_in = shape[-1] if len(shape) > 1 else 1
        return (torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5).to(
            torch.bfloat16)

    def norm(n):
        return (1 + 0.1 * torch.randn((n,), generator=gen, device=dev)).to(torch.bfloat16)

    hf = {"model.embed_tokens.weight": w(V, E)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        hf |= {p + "input_layernorm.weight": norm(E),
               p + "self_attn.q_proj.weight": w(qd, E),
               p + "self_attn.k_proj.weight": w(kvd, E),
               p + "self_attn.v_proj.weight": w(kvd, E),
               p + "self_attn.o_proj.weight": w(E, qd),
               p + "post_attention_layernorm.weight": norm(E),
               p + "mlp.gate_proj.weight": w(I, E), p + "mlp.up_proj.weight": w(I, E),
               p + "mlp.down_proj.weight": w(E, I)}
        if cfg.qkv_bias:
            hf |= {p + f"self_attn.{x}_proj.bias": norm(n) - 1
                   for x, n in (("q", qd), ("k", kvd), ("v", kvd))}
        if cfg.qk_norm:
            hf |= {p + "self_attn.q_norm.weight": norm(D), p + "self_attn.k_norm.weight": norm(D)}
    hf["model.norm.weight"] = norm(E)
    if not cfg.tie_word_embeddings:
        hf["lm_head.weight"] = w(V, E)

    def layers(fn):
        return torch.stack([fn(f"model.layers.{i}.") for i in range(cfg.num_layers)])

    want = {"embed": hf["model.embed_tokens.weight"],
            "ln1": layers(lambda p: hf[p + "input_layernorm.weight"]),
            "wqkv": layers(lambda p: torch.cat([hf[p + f"self_attn.{x}_proj.weight"].t()
                                                for x in "qkv"], dim=1)),
            "wo": layers(lambda p: hf[p + "self_attn.o_proj.weight"].t()),
            "ln2": layers(lambda p: hf[p + "post_attention_layernorm.weight"]),
            "wgu": layers(lambda p: torch.cat([hf[p + f"mlp.{x}_proj.weight"].t()
                                               for x in ("gate", "up")], dim=1)),
            "wdown": layers(lambda p: hf[p + "mlp.down_proj.weight"].t()),
            "ln_f": hf["model.norm.weight"],
            "lm_head": hf.get("lm_head.weight", hf["model.embed_tokens.weight"]).t()}
    if cfg.qkv_bias:
        want["bqkv"] = layers(lambda p: torch.cat([hf[p + f"self_attn.{x}_proj.bias"]
                                                   for x in "qkv"]))
    if cfg.qk_norm:
        want |= {f"ln_{x}": layers(lambda p, x=x: hf[p + f"self_attn.{x}_norm.weight"])
                 for x in "qk"}
    return hf, want


def family_write(name, hf_cfg, dev) -> dict:
    """(a) The family at full width and CHECKPOINT_LAYERS layers: its
    config.json and random bf16 weights written in two ``.safetensors``
    files under build/families/<name>; returns the directory, the config,
    the port's parameters the files must load as, the tensor count and the
    files' bytes."""
    import shutil

    import torch
    from deft_tpu_torch.models.config import LlamaConfig
    from deft_tpu_torch.ops import _cuda

    d = _cuda.BUILD / "families" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    hf_cfg = dict(hf_cfg, num_hidden_layers=CHECKPOINT_LAYERS)
    (d / "config.json").write_text(json.dumps(hf_cfg))
    cfg = LlamaConfig.from_hf_config(hf_cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 30)
    hf, want = family_checkpoint(cfg, dev, gen)
    layer_names = [n for n in hf if n.startswith("model.layers.")]
    write_safetensors(d / "model-00001-of-00002.safetensors", {n: hf[n] for n in layer_names})
    write_safetensors(d / "model-00002-of-00002.safetensors",
                      {n: t for n, t in hf.items() if n not in layer_names})
    size = sum(f.stat().st_size for f in d.glob("*.safetensors"))
    return dict(dir=d, cfg=cfg, want=want, tensors=len(hf), size=size)


def family_cli(written: dict) -> subprocess.Popen:
    """Start ``python3 -m deft_tpu_torch.cli.run --model DIR --device cuda``
    (a short run that must finish its branches) over a written checkpoint;
    the loaded families' runs go together, each in its own process."""
    from deft_tpu_torch.ops import _cuda

    return subprocess.Popen([sys.executable, "-m", "deft_tpu_torch.cli.run", "--model",
                             str(written["dir"]), "--device", "cuda", "--max_width", "4",
                             "--max_seq_len", "40", "--kv_pool_slots", "4096",
                             "--print-branches"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(_cuda.BUILD.parent))


def family_load(name, source, written: dict, proc, t_start, dev) -> None:
    """(a, continued) The CLI run over the checkpoint (started at `t_start`)
    must finish its branches; then the checkpoint loads through the loader
    in this process, every tensor bit-equal to what was written."""
    import shutil

    import torch
    from deft_tpu_torch.models.loader import load_params

    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise Failure(f"families {name}: the CLI run over the checkpoint did not end "
                      "within 600 s")
    t_cli = time.perf_counter() - t_start
    tail = "\n".join((stdout + stderr).splitlines()[-6:])
    check(proc.returncode == 0 and "TPOT (ms/token)" in stdout
          and stdout.count("Branch ID") == 4,
          f"families {name}: the CLI run over the checkpoint failed (rc "
          f"{proc.returncode}):\n{tail}")
    for line in (stdout + stderr).splitlines():  # the run's own clock
        if "INFO" in line or "TTFT" in line or "TPOT" in line:
            print(f"[families] {name} CLI: {line.strip()}", flush=True)
    d, want = written["dir"], written["want"]
    params = load_params(str(d), written["cfg"], dev, torch.bfloat16)
    check(sorted(params) == sorted(want),
          f"families {name}: loaded {sorted(params)}, expected {sorted(want)}")
    for k, t in want.items():
        check(torch.equal(params[k], t), f"families {name}: {k} loads unlike the file")
    print(f"[families] {name} ({source}): config.json and {written['tensors']} bf16 tensors "
          f"at full width, {CHECKPOINT_LAYERS} layers, {written['size'] / 1e9:.2f} GB in two "
          f"safetensors files; python3 -m deft_tpu_torch.cli.run --model {d.name} --device "
          f"cuda ran in {t_cli:.1f} s (the {len(LOADED_FAMILIES)} families' runs at once); "
          f"load_params bit-equal on {len(want)} parameters", flush=True)
    del params
    shutil.rmtree(d)


def family_serve(name, source, hf_cfg, dev, smi) -> dict:
    """(b)-(d) The family at full width and depth from random bf16 weights
    made on the card: the main path's workload (Simple_Tree, prompt 4000,
    width 50, 64 tokens, flatten then seq) through ModelRunner and
    tree_generate; first the first decode step's logits, seq against
    flatten below the family's FAMILY_LIMITS, one ulp of attention noise
    below it and every other prompt block dropped above it (one dropped
    block printed);
    the decode kernels each mode must run (B1/B2 where the heads pack, B6/B7
    at the wide heads, never the other layout's); TTFT, TPOT and peak
    memory printed.  At the wide heads, on the same weights: (e) the same
    workload over int8 KV (wide_int8), (f) the batch path's four requests
    through BatchedEngine (wide_batch) and the 16-token prompt's first
    step, the grids' reference (short_first_step).  Returns {"serve": the
    served runs' launches} and, at the wide heads, "int8", "batch" (their
    launches) and "short"."""
    import torch
    from deft_tpu_torch.models.config import LlamaConfig
    from deft_tpu_torch.models.loader import random_params
    from deft_tpu_torch.runtime.runner import packs_heads

    cfg = LlamaConfig.from_hf_config(hf_cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = random_params(cfg, SEED, dev, torch.bfloat16)
    runner = make_runner(cfg, params, dev)
    rng = np.random.default_rng(SEED)
    prompt = [int(t) for t in rng.integers(4, cfg.vocab_size - 4, PROMPT_LEN)]
    _, ids = runner.forward_prefill(prompt).topk(0, WIDTH)
    runner.reset_state()
    first_step(runner, prompt, ids)
    paged = packs_heads(cfg.head_dim)
    lf, ls, readings = logits_controls(runner, WIDTH, midrun=not paged,
                                       extra=((HALF_DROPPED, lambda b: drop_block(b, every=2)),))
    limit = FAMILY_LIMITS[name]
    print(f"[families] {name}: first decode step, relative L2 error of the logits "
          f"against flatten's: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
          + f" (limit {limit:.0e}); top-1 agreement seq "
          f"{float((lf.argmax(-1) == ls.argmax(-1)).float().mean()):.3f}", flush=True)
    family_controls(f"families {name}", readings, limit)
    runner.reset_state()
    runner.retain_full_logits = False
    reset_counts()
    runs = generate_both(runner, prompt, f"families {name}", count_plans=True)
    launches = read_counts()
    mine = {"flatten": "paged_flatten" if paged else "flatten_gather",
            "seq": "paged_seq" if paged else "seq_gather"}
    other = {"flatten": "flatten_gather" if paged else "paged_flatten",
             "seq": "seq_gather" if paged else "paged_seq"}
    for mode in ("flatten", "seq"):
        moved = runs[mode]["launches"]
        check(moved.get(mine[mode], 0) > 0, f"families {name} {mode}: {mine[mode]} "
              f"never launched: {moved}")
        check(paged or not moved.get(other[mode], 0), f"families {name} {mode}: "
              f"{other[mode]} launched at head_dim {cfg.head_dim}: {moved}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not paged:  # B6's and B7's share of a step (every step a gather plan)
        step_share(runner, prompt, name, smi)
    f, s = runs["flatten"]["pm"], runs["seq"]["pm"]
    print(f"[families] {name} ({source}; {cfg.num_layers} layers, {cfg.num_q_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}): TTFT {f.TTFT:.3f} / {s.TTFT:.3f} ms, "
          f"TPOT {f.TPOT:.4f} / {s.TPOT:.4f} ms (flatten / seq), peak {peak:.2f} GB, launches "
          f"{ {k: n for k, n in launches.items() if n} }; {time.perf_counter() - t0:.1f} s; "
          f"{smi}", flush=True)
    del runner
    release()
    out = {"serve": launches}
    if not paged:
        out["int8"] = wide_int8(name, cfg, params, prompt, ids, lf, dev, smi)
        out["batch"] = wide_batch(name, cfg, params, dev, smi)
        out["short"] = short_first_step(cfg, params, dev)
    del params
    release()
    return out


# the every-other-prompt-block fault of the families' first steps
HALF_DROPPED = "flatten, every other prompt block dropped"


def family_controls(tag, readings, limit) -> None:
    """A family's first-step gate: seq and one ulp of attention noise below
    its limit, every other prompt block dropped above it (logits_controls'
    readings with HALF_DROPPED)."""
    check(readings["seq"] < limit, f"{tag}: flatten and seq logits disagree: "
          f"{readings['seq']}")
    check(readings["flatten+ulp noise"] < limit,
          f"{tag}: one ulp of attention noise moves the logits past the limit")
    # the fault the limit must see: half the prompt's blocks lost (a split-KV
    # merge that drops every other span); one dropped block is printed beside
    check(readings[HALF_DROPPED] > limit,
          f"{tag}: half the prompt's blocks dropped stay under the limit")


# decode kernels that read the paged layout (B1, B2, B4, B5): never at heads
# that do not pack
PAGED_DECODE = ("paged_flatten", "paged_seq", "paged_flatten_q", "paged_seq_q")


def wide_int8(name, cfg, params, prompt, ids, lf_bf16, dev, smi) -> dict:
    """(e) The family's main workload over an int8 KV cache on the bf16
    serve's weights: the first decode step (the bf16 serve's branch tokens
    `ids`) int8 seq against int8 flatten below FAMILY_LIMITS, between the
    same two controls as the bf16 step (family_controls); int8 flatten
    against the bf16 serve's flatten (`lf_bf16`) printed, not gated; then
    flatten and seq through tree_generate: B6 and B7 launch over int8
    pools, the paged kernels never.  Returns the runs' launches."""
    import torch

    tag = f"families {name} int8"
    runner = make_runner(cfg, params, dev, kv_dtype="int8")
    check(runner.k_pool.data.dtype == torch.int8 and runner.k_pool.quantized,
          f"{tag}: the runner's pools are not int8")
    first_step(runner, prompt, ids)
    lq, lqs, readings = logits_controls(runner, WIDTH, midrun=True,
                                        extra=((HALF_DROPPED, lambda b: drop_block(b, every=2)),))
    limit = FAMILY_LIMITS[name]
    print(f"[{tag}] first decode step over int8 pools, relative L2 error of the logits "
          f"against int8 flatten's: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
          + f" (limit {limit:.0e}); int8 flatten against bf16 flatten {rel_l2(lq, lf_bf16):.3e}"
          f" (not gated); top-1 agreement seq "
          f"{float((lq.argmax(-1) == lqs.argmax(-1)).float().mean()):.3f}, against bf16 "
          f"{float((lq.argmax(-1) == lf_bf16.argmax(-1)).float().mean()):.3f}", flush=True)
    family_controls(tag, readings, limit)
    runner.reset_state()
    runner.retain_full_logits = False
    reset_counts()
    runs = generate_both(runner, prompt, tag, count_plans=True)
    launches = read_counts()
    for mode, k in (("flatten", "flatten_gather"), ("seq", "seq_gather")):
        moved = runs[mode]["launches"]
        check(moved.get(k, 0) > 0 and not any(moved.get(p, 0) for p in PAGED_DECODE),
              f"{tag} {mode}: {k} did not take every step over int8 pools: {moved}")
    print(f"[{tag}] over int8 pools: flatten_gather_d{cfg.head_dim} "
          f"{launches['flatten_gather']}, seq_gather_d{cfg.head_dim} "
          f"{launches['seq_gather']} launches; {smi}", flush=True)
    del runner
    release()
    return launches


def wide_batch(name, cfg, params, dev, smi) -> dict:
    """(f) The batch path's protocol at the family's heads, on the bf16
    serve's weights: the four requests of BATCH_LENS alone, then through
    one ragged prefill (B8 at the family's width, once a layer) and one
    multi-tree step held against the alone runs below FAMILY_LIMITS
    (batch_admission); then BatchedEngine flatten and seq (batch_engine):
    B6 and B7 on the multi-tree gather plans, B1/B2 never.  Returns the
    engine runs' launches."""
    rng = np.random.default_rng(SEED + 3)
    prompts = [[int(t) for t in rng.integers(4, cfg.vocab_size - 4, n)] for n in BATCH_LENS]
    tag = f"families {name} batch"
    runner = batch_runner(cfg, params, dev)
    batch_admission(runner, prompts, tag, FAMILY_LIMITS[name])
    runner.retain_full_logits = False
    launches, _, _ = batch_engine(runner, prompts, tag, paged_kernels=False)
    print(f"[{tag}] ragged_prefill_d{cfg.head_dim} {launches['ragged_prefill']}, "
          f"flatten_gather_d{cfg.head_dim} {launches['flatten_gather']}, "
          f"seq_gather_d{cfg.head_dim} {launches['seq_gather']} launches; {smi}", flush=True)
    del runner
    release()
    return launches


def short_first_step(cfg, params, dev) -> tuple:
    """The CLI's 16-token prompt on one card: (prompt, the prefill's top
    WIDTH ids, the first flatten decode step's (WIDTH, V) fp32 logits on
    the host), the wide grids' reference."""
    from deft_tpu_torch.cli.run import make_prompt
    from deft_tpu_torch.runtime import ForwardMode

    prompt = make_prompt(None, 16 + GEN_LEN, cfg.vocab_size, SEED)
    runner = make_runner(cfg, params, dev, prompt_len=len(prompt))
    _, ids = runner.forward_prefill(prompt).topk(0, WIDTH)
    runner.reset_state()
    first_step(runner, prompt, ids)
    flatten = ForwardMode.TREE_DECODE_FLATTEN
    view, _ = runner.forward_tree_decode(flatten, runner.build_plan(flatten))
    lf = view.full_logits()[:WIDTH].float().cpu()
    del runner
    release()
    return prompt, ids, lf


def step_share(runner, prompt, name, smi, steps=4) -> None:
    """torch.profiler over `steps` decode steps of each mode right after
    branching (profile_decode): the attention kernels' device ms a step
    (flatten: B6 and its merge kernel, csrc/flatten_gather.cu's
    deft_flat_q; seq: B7, csrc/seq_gather.cu's deft_seq_q) against the
    step's device busy time and its wall time."""
    from deft_tpu_torch.runtime import ForwardMode

    for mode, label, keys in ((ForwardMode.TREE_DECODE_FLATTEN, "flatten: B6 + merge",
                               ("deft_flat_q", "flatten_merge_kernel")),
                              (ForwardMode.DECODE, "seq: B7", ("deft_seq",))):
        kernels, wall = profile_decode(runner, mode, prompt, WIDTH, steps)
        attn = sum(ms for key, ms in kernels.items() if any(k in key for k in keys))
        busy = sum(kernels.values())
        check(attn > 0, f"families {name}: no {label} kernel in the profiled steps")
        print(f"[families] {name} {label} {attn:.3f} ms of a step's {busy:.3f} device ms "
              f"({attn / busy:.1%}) and {wall:.3f} wall ms ({attn / wall:.1%}; profiled, "
              f"{steps} steps); {smi}", flush=True)


def phase_families(dev, smi, wide_only: bool = False) -> dict:
    """LOADED_FAMILIES written at 2 layers (family_write), each loaded by a
    CLI run, the runs at once (family_cli), and checked (family_load); then
    each of FAMILIES served at full width and depth (family_serve), the
    wide heads also over int8 KV and batched; then the wide heads on a grid
    (phase_wide_grids).  wide_only: the wide heads' families alone, no
    checkpoint.  Returns the kernels line's launches of the wide heads'
    kernels: B3, B6 and B7 of the served runs (bf16 and int8 KV), B8, B6
    and B7 of the batched runs, B11, B7 and B3 of rank 0's grid runs, at
    Phi-3-mini's widths (D 96) and Gemma-7B's (D 256)."""
    if not wide_only:
        written = {name: family_write(name, FAMILIES[name][1], dev)
                   for name in LOADED_FAMILIES}
        t0 = time.perf_counter()
        procs = {name: family_cli(w) for name, w in written.items()}
        try:
            for name, w in written.items():
                family_load(name, FAMILIES[name][0], w, procs[name], t0, dev)
        finally:
            for proc in procs.values():  # a failed check leaves no process behind
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        del written
        release()
    served = {name: family_serve(name, *FAMILIES[name], dev, smi) for name in FAMILIES
              if not wide_only or name in WIDE_FAMILY.values()}
    grids = phase_wide_grids({name: served[name]["short"] for name in WIDE_FAMILY.values()})
    out = {}
    for D, family in WIDE_FAMILY.items():
        runs = [served[family][k] for k in ("serve", "int8", "batch")] + [grids[family]]
        for base in ("prefill", "ragged_prefill", "flatten_gather", "seq_gather",
                     "flatten_gather_partial"):
            out[f"{base}_d{D}"] = sum(r.get(base, 0) for r in runs)
    return out


def wide_grid_rank(grid, refs):
    """The wide-head families on one rank of SHORT_GRID at full depth, one
    after the other (`refs`: {name: (prompt, ids)}), each from the rank's
    slices of family_serve's weights (the seed): the 16-token prompt's
    first flatten decode step on the single card's branch tokens `ids`
    (its logits, every row joined over dp, and the step's launches), then
    SHARDED_GEN tokens flatten and seq over bf16 pools and flatten over
    int8 pools (rank_generate, under sync_checked)."""
    import torch
    from deft_tpu_torch.models.config import LlamaConfig
    from deft_tpu_torch.runtime import ForwardMode

    torch.backends.cuda.matmul.allow_tf32 = False
    flatten, out = ForwardMode.TREE_DECODE_FLATTEN, {}
    for name, (prompt, ids) in refs.items():
        cfg, got = LlamaConfig.from_hf_config(FAMILIES[name][1]), {}
        torch.cuda.reset_peak_memory_stats(grid.device)
        for kv, modes in (("inherit", ("flatten", "seq")), ("int8", ("flatten",))):
            # 8192 slots: the prompt and each leaf's 128-slot chunk; four
            # Gemma ranks share the card with the script's own tensors
            runner = make_runner(cfg, None, grid.device, kv_dtype=kv,
                                 prompt_len=len(prompt), slots=8192, mesh=grid)
            if kv == "inherit":
                first_step(runner, prompt, ids)
                plan = runner.build_plan(flatten)
                reset_counts()
                view, _ = runner.forward_tree_decode(flatten, plan)
                got.update(first=view.full_logits()[:WIDTH].float().cpu(), l_pad=plan.l_pad,
                           first_counts=rank_counts(grid))
                runner.reset_state()
            runner.retain_full_logits = False
            got[kv] = rank_generate(grid, runner, prompt, SHARDED_GEN, modes)
            del runner
            release()
        got["peak GB"] = rank_counts_of(grid,
                                        torch.cuda.max_memory_allocated(grid.device) / 1e9)
        out[name] = got
    return out


def phase_wide_grids(refs) -> dict:
    """(g) The wide-head families (WIDE_FAMILY) on SHORT_GRID, four gloo
    ranks on the one card, one launch, full depth (wide_grid_rank): rank 0's first-step
    logits against the single card's (`refs[name]`: short_first_step)
    below FAMILY_LIMITS, with the other dp window's rows left out (what
    rank 0 holds without the join) above it; on every rank B11 in each
    flatten run (bf16 and int8 pools) and B7 in the seq run, on the rank's
    heads, and no single-card decode kernel; WIDTH branches of
    SHARDED_GEN - 1 tokens.  Returns {name: rank 0's launches of the
    runs}."""
    import torch

    held = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    runs = run_grid(wide_grid_rank, SHORT_GRID, ({name: refs[name][:2]
                                                  for name in WIDE_FAMILY.values()},))
    print(f"[wide-grid] one launch of grid {SHORT_GRID} for {list(runs)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    for D, name in WIDE_FAMILY.items():
        got, lf = runs[name], refs[name][2]
        tag = f"[wide-grid] {name}, grid {SHORT_GRID}"
        first = got["first"]
        unjoined = first.clone()
        unjoined[got["l_pad"] // SHORT_GRID[0]:] = 0
        err, err_fault = rel_l2(first, lf), rel_l2(unjoined, lf)
        limit = FAMILY_LIMITS[name]
        print(f"{tag}: first decode step (16-token prompt, plan {got['l_pad']} rows) "
              f"against the single card's, relative L2 {err:.3e}, with the other dp "
              f"window's rows left out {err_fault:.3e} (limit {limit:.0e}); top-1 "
              f"agreement {float((first.argmax(-1) == lf.argmax(-1)).float().mean()):.3f}; "
              f"its launches by rank "
              f"{[{k: n for k, n in c.items() if n} for c in got['first_counts']]}; peak "
              f"{[round(g, 2) for g in got['peak GB']]} GB by rank beside the script's "
              f"{held:.2f} GB", flush=True)
        check(tuple(first.shape) == tuple(lf.shape) and bool(first.isfinite().all()),
              f"{tag}: first-step logits {tuple(first.shape)} not finite or not "
              f"{tuple(lf.shape)}")
        check(err < limit, f"{tag}: first-step logits stray from the single card's: {err}")
        check(err_fault > limit, f"{tag}: the dp join left out stays under the limit: "
              f"{err_fault}")
        launches = {}
        for kv, mode, want in (("inherit", "flatten", "flatten_gather_partial"),
                               ("inherit", "seq", "seq_gather"),
                               ("int8", "flatten", "flatten_gather_partial")):
            r = got[kv][mode]
            print(f"{tag} {'int8' if kv == 'int8' else 'bf16'} KV {mode}: TTFT "
                  f"{r['TTFT']:.3f} ms, TPOT {r['TPOT']:.4f} ms (four ranks sharing one "
                  f"card), plans paged at {sum(r['paged'])} of {len(r['paged'])} steps; "
                  f"launches by rank "
                  f"{[{k: n for k, n in c.items() if n} for c in r['counts']]}", flush=True)
            check(len(r["seqs"]) == WIDTH and all(len(x) == SHARDED_GEN - 1 for x in r["seqs"]),
                  f"{tag} {kv} {mode}: expected {WIDTH} branches of {SHARDED_GEN - 1} tokens")
            for c in r["counts"]:
                check(c[want] > 0 and c["prefill"] > 0,
                      f"{tag} {kv} {mode}: {want} or B3 did not launch on a rank: {c}")
                check(all(c[k] == 0 for k in SINGLE_DECODE + ("paged_flatten_partial",
                                                              "paged_flatten_q_partial",
                                                              "paged_seq_partial",
                                                              "paged_seq_q_partial")),
                      f"{tag} {kv} {mode}: a single-card or paged decode kernel ran: {c}")
            for k, n in r["counts"][0].items():
                launches[k] = launches.get(k, 0) + n
        out[name] = launches
    return out


def phase_tracing(dev) -> None:
    """One short run under ``--trace-dir`` (the CLI's main in this
    process: the 8b-8l preset, the 16-token prompt, width 4): its Chrome
    trace must hold the decode_step spans and kernels of the port (CUDA
    kernel events in the deft namespaces)."""
    import shutil

    from deft_tpu_torch.cli import run
    from deft_tpu_torch.ops import _cuda

    d = _cuda.BUILD / "trace"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    rc = run.main(["--random-model", "8b-8l", "--device", "cuda", "--max_width", "4",
                   "--max_seq_len", "40", "--kv_pool_slots", "4096", "--trace-dir", str(d)])
    files = list(d.glob("*.json"))
    check(rc == 0 and len(files) == 1, f"tracing: rc {rc}, trace files {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    steps = sum(e.get("name") == "decode_step" for e in events)
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel" and "deft" in e.get("name", "")})
    print(f"[tracing] --trace-dir wrote {files[0].name} ({files[0].stat().st_size / 1e6:.1f} "
          f"MB, {len(events)} events): {steps} decode_step spans, "
          f"{sum(e.get('name') == 'plan_build' for e in events)} plan_build, "
          f"{sum(e.get('name') == 'prefill' for e in events)} prefill; port kernels "
          f"{[k[:60] for k in kernels]}; {time.perf_counter() - t0:.1f} s", flush=True)
    check(steps > 0, "tracing: the trace holds no decode_step span")
    check(kernels, "tracing: the trace holds no kernel of the port")
    shutil.rmtree(d)
    release()


def logits_controls(runner, width, midrun=False, extra=()):
    """The first decode step on the runner's current tree, run in flatten
    mode, in seq mode and under three controls; returns flatten's and seq's
    (width, V) logits and each run's relative L2 error against flatten's.
    midrun=True: a step of a tree that has branched or pruned since, whose
    plans may be segment-aligned or gather plans (the controls then run on
    B6's entry); no own-token control there, since a leaf then owns more
    tokens than its newest.
    Controls: flatten again (the noise of a rerun), flatten with each
    nonzero element of every layer's attention output moved by -1, 0 or +1
    ulp at random (bf16 rounding noise), and two planted faults: one plan
    block of the shared prompt hidden from every leaf (what a split-KV
    merge that lost a span does, at the grain of one block), and each
    leaf's own newest token hidden from it (a mask off by one).  Each step
    rewrites the new tokens' KV before any layer reads it, so the runs do
    not disturb one another.  ``extra``: more (name, plan edit) faults,
    run on the flatten entry after these."""
    import contextlib
    from unittest import mock

    import torch
    from deft_tpu_torch.runtime import ForwardMode

    gen = torch.Generator(device=runner.device)
    gen.manual_seed(SEED + 2)

    flatten = ForwardMode.TREE_DECODE_FLATTEN
    plans = {m: runner.build_plan(m) for m in (flatten, ForwardMode.DECODE)}
    check(midrun or all(p.paged for p in plans.values()),
          "the first step's plans are not paged")
    base = runner._attn_fn(flatten, runner._use_paged(plans[flatten], flatten))

    def ulp_noise(*args):
        o = base(*args)
        step = torch.randint(-1, 2, o.shape, generator=gen, device=o.device,
                             dtype=torch.int16)
        return (o.view(torch.int16) + step * (o != 0)).view(o.dtype)

    def with_plan(edit):
        return plan_edited(base, edit)

    runs = (("flatten", flatten, None), ("seq", ForwardMode.DECODE, None),
            ("flatten again", flatten, None),
            ("flatten+ulp noise", flatten, ulp_noise),
            ("flatten, block dropped", flatten, with_plan(drop_block)))
    if not midrun:
        runs += (("flatten, own token hidden", flatten,
                  with_plan(hide_own_token(width))),)
    runs += tuple((name, flatten, with_plan(edit)) for name, edit in extra)
    logits = {}
    for name, mode, attn in runs:
        with (mock.patch.object(runner, "_attn_fn", lambda m, paged, a=attn: a)
              if attn is not None else contextlib.nullcontext()):
            v, _ = runner.forward_tree_decode(mode, plans[mode])
        logits[name] = v.full_logits()[:width].float()
    lf = logits["flatten"]
    readings = {name: float((x - lf).norm() / lf.norm())
                for name, x in logits.items() if name != "flatten"}
    return lf, logits["seq"], readings


def drop_block(b, every=None):
    """A flatten plan edit: the middle one of the FULL (prompt-only) blocks
    hidden from every leaf; with `every`, each `every`-th FULL block."""
    full = (b.blk_lo < -(1 << 20)).nonzero().flatten()
    check(len(full) > 0, "the flatten plan has no FULL block")
    gone = full[::every] if every else full[len(full) // 2:len(full) // 2 + 1]
    b.blk_lo, b.blk_hi = b.blk_lo.clone(), b.blk_hi.clone()
    b.blk_lo[gone] = b.blk_hi[gone] = 0


def plan_edited(attn, edit):
    """The AttnFn `attn` run on a copy of its plan batch that `edit` changed
    (a planted fault)."""
    from types import SimpleNamespace

    def run(q, k_new, v_new, k_pool, v_pool, li, batch, scale):
        b = SimpleNamespace(**vars(batch))
        edit(b)
        return attn(q, k_new, v_new, k_pool, v_pool, li, b, scale)
    return run


def hide_own_token(width):
    """A flatten plan edit: each leaf's own newest token, the one token only
    it sees, hidden from it (a mask off by one)."""
    import torch

    def edit(b):
        own = b.tok_hi - b.tok_lo == 1
        check(int(own.sum()) == width, "expected one own token per leaf")
        b.tok_hi = torch.where(own, b.tok_lo, b.tok_hi)
    return edit


RANGES = ("build_plan", "forward", "kv_store", "moe")


def profile_decode(runner, mode, prompt, width, steps):
    """torch.profiler over `steps` greedy decode steps of a fresh tree (see
    profile_steps)."""
    import torch
    from torch.profiler import record_function

    runner.reset_state()
    view = runner.forward_prefill(prompt)
    tree = runner.tree
    _, ids = view.topk(0, width)
    for c, child in enumerate(tree.branch(tree.root, width)):
        child.append_token(int(ids[c]))
    torch.cuda.synchronize()

    def step():
        tree.alloc()
        with record_function("build_plan"):
            plan = runner.build_plan(mode)
        with record_function("forward"):
            v, _ = runner.forward_tree_decode(mode, plan, logits_kind="greedy")
        nxt, _ = v.argmax()
        for leaf in tree.leaves.values():
            leaf.append_token(int(nxt[tree.leaf_to_q[leaf.id]]))

    kv = "int8" if runner.k_pool.quantized else "bf16"
    cfg = runner.cfg
    model = (f"{'MoE ' if cfg.num_experts else ''}{cfg.num_layers} layers, "
             f"{str(runner.params['wo'].dtype).split('.')[-1]} wo")
    out = profile_steps(f"{mode.name}, prompt {len(prompt)}, {kv} KV, {model}", step, steps)
    runner.reset_state()
    return out


def profile_batch(runner, prompts, width, steps):
    """torch.profiler over `steps` BatchedEngine flatten steps right after
    the requests' admission (see profile_steps)."""
    from unittest import mock

    import torch
    from deft_tpu_torch.control import Branch_Controller, workloads
    from deft_tpu_torch.runtime import ForwardMode
    from deft_tpu_torch.runtime.batched import BatchedEngine, Request
    from torch.profiler import record_function

    runner.reset_state()
    eng = BatchedEngine(runner, ForwardMode.TREE_DECODE_FLATTEN)
    eng.add_requests([Request(p, Branch_Controller(workloads.simple_tree),
                              len(p) + GEN_LEN, width=width, depth=1) for p in prompts])
    torch.cuda.synchronize()
    build, forward = eng.build_plan, runner.forward_tree_decode

    def marked_build(trees):
        with record_function("build_plan"):
            return build(trees)

    def marked_forward(*a, **k):
        with record_function("forward"):
            return forward(*a, **k)

    with (mock.patch.object(eng, "build_plan", marked_build),
          mock.patch.object(runner, "forward_tree_decode", marked_forward)):
        profile_steps(f"batched TREE_DECODE_FLATTEN, {len(prompts)} requests "
                      f"(prompts {'/'.join(str(len(p)) for p in prompts)}), bf16 KV",
                      eng.step, steps)
    for req in eng.active:
        req.tree.free()
    runner.reset_state()


def marked(name, fn):
    """fn inside a record_function range `name`."""
    from torch.profiler import record_function

    def run(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return run


@contextlib.contextmanager
def model_ranges():
    """The model's kv_store calls and MoE blocks (either route) marked."""
    from unittest import mock

    from deft_tpu_torch.models import llama

    with (mock.patch.object(llama, "kv_store", marked("kv_store", llama.kv_store)),
          mock.patch.object(llama, "_moe_mlp", marked("moe", llama._moe_mlp)),
          mock.patch.object(llama, "_moe_mlp_gmm", marked("moe", llama._moe_mlp_gmm))):
        yield


def profile_steps(label, step, steps):
    """torch.profiler over `steps` calls of step(): device time by kernel,
    the device's busy share of the wall time, and the host and device time
    of each step's plan building, its forward and the model's kv_store calls
    and MoE blocks (either route) within it (RANGES, marked with
    record_function while the profiler runs).  Returns (kernel name ->
    device ms a step, wall ms a step)."""
    from torch.profiler import ProfilerActivity, profile

    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof,
          model_ranges()):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_report(label, prof, steps, wall_ms), wall_ms / steps


def profile_generate(runner, mode, prompt, fn, template, start, steps, label):
    """torch.profiler over decode steps start .. start + steps - 1 of one
    generation of workload `fn` through tree_generate: each step's alloc,
    plan (build_plan), merge copies (apply_kv_copies, within forward),
    forward and branching, reported as profile_steps does."""
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    n, wall = [0], []
    alloc = runner.tree.alloc

    def alloc_at_step():  # each decode step starts with the tree's alloc
        n[0] += 1
        if n[0] == start:
            prof.start()  # its set-up lies outside the timed window
        if n[0] in (start, start + steps):
            torch.cuda.synchronize()
            wall.append(time.perf_counter())
        if n[0] == start + steps:
            prof.stop()
        return alloc()

    with (mock.patch.object(runner.tree, "alloc", alloc_at_step),
          mock.patch.object(runner, "build_plan", marked("build_plan", runner.build_plan)),
          mock.patch.object(runner, "forward_tree_decode",
                            marked("forward", runner.forward_tree_decode)),
          mock.patch.object(runner, "apply_kv_copies",
                            marked("apply_kv_copies", runner.apply_kv_copies)),
          model_ranges()):
        generate_run(runner, mode, prompt, fn, template)
    check(len(wall) == 2, f"{label}: the run took fewer than {start + steps} steps")
    profile_report(label, prof, steps, (wall[1] - wall[0]) * 1e3,
                   RANGES + ("apply_kv_copies",))


def profile_report(label, prof, steps, wall_ms, ranges=RANGES):
    """Print a profile of `steps` steps that took wall_ms (see
    profile_steps); returns kernel name -> device ms a step."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    def dev_total_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)

    avgs = prof.key_averages()
    # kernel entries only (CPU-op entries also carry their kernels' time; a
    # range's device-side copy spans its kernels)
    evs = [e for e in avgs
           if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0
           and e.key not in ranges]
    busy_ms = sum(dev_us(e) for e in evs) / 1e3
    print(f"[profile] {label}: {steps} steps, "
          f"wall {wall_ms / steps:.3f} ms/step, "
          f"device busy {busy_ms / steps:.3f} ms/step "
          f"({busy_ms / wall_ms:.1%}; idle {1 - busy_ms / wall_ms:.1%})", flush=True)
    for key in ranges:
        st = [e for e in avgs if e.key == key
              and str(getattr(e, "device_type", "")).endswith("CPU")]
        if not st:
            if key != "moe":  # dense models have no MoE block
                print(f"[profile]   {key}: no range recorded (not measured)", flush=True)
            continue
        host_ms, dev_ms = st[0].cpu_time_total / 1e3, dev_total_us(st[0]) / 1e3
        print(f"[profile]   {key}: {st[0].count // steps}/step, host "
              f"{host_ms / steps:.3f} ms/step ({host_ms / wall_ms:.1%} of wall), "
              f"device {dev_ms / steps:.3f} ms/step ({dev_ms / max(busy_ms, 1e-9):.1%} "
              f"of busy)", flush=True)
    for e in sorted(evs, key=dev_us, reverse=True)[:12]:
        print(f"[profile]   {dev_us(e) / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d}/step  {e.key[:90]}")
    # the CUDA runtime calls the host made (launches, copies, host
    # allocations, waits), by host time
    api = [e for e in avgs if e.key.startswith("cuda")
           and str(getattr(e, "device_type", "")).endswith("CPU")]
    print(f"[profile]   host, CUDA runtime calls: " + ", ".join(
        f"{e.key} {e.count / steps:.1f}/step {e.cpu_time_total / 1e3 / steps:.3f} ms/step"
        for e in sorted(api, key=lambda e: e.cpu_time_total, reverse=True)[:6]),
        flush=True)
    return {e.key: dev_us(e) / 1e3 / steps for e in evs}


def profile_kv_store(dev, reps: int = 20):
    """One decode step's kv_store calls (K and V of 32 layers, WIDTH new
    tokens, 8 KV heads of 128) into bf16 and int8 pools, without the
    profiler: host ms a step (host clock, synchronised at the end of each
    step) and device ms a step (CUDA events); then the int8 store's torch
    ops by host time under torch.profiler."""
    import torch
    from deft_tpu_torch.models.llama import KVPool, kv_store
    from torch.profiler import ProfilerActivity, profile

    L, S, Hkv, D = 32, 16384, 8, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn((WIDTH, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    loc = torch.randperm(S, generator=gen, device=dev)[:WIDTH]

    def step(pools):
        for li in range(L):
            for p in pools:
                kv_store(p, li, loc, x)

    for kv in ("bf16", "int8"):
        if kv == "int8":
            pools = [KVPool(torch.zeros((L, S, Hkv * D), dtype=torch.int8, device=dev),
                            torch.ones((L, Hkv, S), device=dev)) for _ in range(2)]
        else:
            pools = [KVPool(torch.zeros((L, S, Hkv * D), dtype=torch.bfloat16,
                                        device=dev)) for _ in range(2)]
        step(pools)
        torch.cuda.synchronize()
        host, devs = [], []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            step(pools)
            b.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            devs.append(a.elapsed_time(b))
        print(f"[profile] kv_store, {kv} pools, one step ({2 * L} calls of "
              f"{WIDTH} tokens), no profiler: host {np.mean(host):.3f} ms/step "
              f"(median {np.median(host):.3f}), device span {np.mean(devs):.3f} "
              f"ms/step", flush=True)
        if kv == "int8":
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                step(pools)
                torch.cuda.synchronize()
            ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                         reverse=True)
            for e in ops[:10]:
                print(f"[profile]   {e.self_cpu_time_total / 1e3:8.3f} ms/step "
                      f"{e.count:5d}/step  {e.key[:60]}")
        del pools
    release()


# ~1 ms of sleep kernel at the H100's 1.98 GHz boost clock: longer than any
# timed call's host work apart from the plain versions'
PRIME_CYCLES = 2_000_000


def time_ms(fn, reps: int, flush, primed: bool = True) -> float:
    """Mean CUDA-event time of fn() over reps launches, L2 flushed before
    each (the decode step's weight streaming leaves the cache cold).
    primed: a sleep kernel ahead of each launch keeps the device busy while
    the host runs the wrapper (argument checks, allocations, the ctypes
    call), so the events time the device work alone; unprimed, the device
    waits for the host between the events, and a call shorter than its
    wrapper's host time reads as the host time."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        if primed:
            torch.cuda._sleep(PRIME_CYCLES)
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in zip(starts, ends)]))


# name -> the library call timed beside a kernel, as found on this card
LIBRARY = {}
# B10's path cases: M_pad -> the row tiles up to the end of the last group
# (path_shapes), which bound B10's work in this run
GMM_LIVE_TILES = {}


def ragged_timing_row(fns, shapes, bound, name="ragged_prefill"):
    """B8 (or its wide heads' row `name`) at the batch path's shapes:
    kernel, plain and library callables, bound.  Library: torch.nn.attention.varlen's varlen_attn where the
    installed torch has it and it agrees with the plain version, else
    scaled_dot_product_attention with the block-diagonal causal mask as a
    boolean attn_mask."""
    import torch
    import torch.nn.functional as F

    q, k, v, seg, scale = shapes[name][0][2]
    N, Hq, D = q.shape
    qpk = Hq // k.shape[1]
    want = fns[name][1](q, k, v, seg, scale)
    cu = torch.tensor(np.cumsum((0,) + BATCH_LENS), dtype=torch.int32, device=q.device)
    lib = None
    try:
        from torch.nn.attention.varlen import varlen_attn

        params = inspect.signature(varlen_attn).parameters
        kw = {"scale": scale} if "scale" in params else {}
        kw.update({"is_causal": True} if "is_causal" in params
                  else {"window_size": (-1, 0)})
        kk, vv = k, v
        if "enable_gqa" in params:
            kw["enable_gqa"] = True
        else:
            kk, vv = (x.repeat_interleave(qpk, dim=1) for x in (k, v))
        L = max(BATCH_LENS)

        def lib():
            return varlen_attn(q, kk, vv, cu, cu, L, L, **kw)

        e = rel_err(lib(), want)
        print(f"[timing] {name} library: varlen_attn({', '.join(kw)}) vs "
              f"plain rel err {e:.3e}", flush=True)
        check(e < TOL["bfloat16"], "varlen_attn disagrees")
        LIBRARY[name] = "torch.nn.attention.varlen.varlen_attn"
    except (ImportError, TypeError, RuntimeError, Failure) as err:
        print(f"[timing] {name} library: varlen_attn not usable here "
              f"({type(err).__name__}: {str(err)[:120]}); SDPA with a boolean "
              "block-diagonal causal mask instead", flush=True)
        pos = torch.arange(N, device=q.device)
        mask = (seg[:, None] == seg[None, :]) & (pos[:, None] >= pos[None, :])
        qt = q.transpose(0, 1)[None]
        kt, vt = (x.repeat_interleave(qpk, dim=1).transpose(0, 1)[None] for x in (k, v))

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)

        LIBRARY[name] = "SDPA, boolean block-diagonal causal attn_mask"
    pairs = sum(n * (n + 1) // 2 for n in BATCH_LENS)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + 4 * N
    kern, plain = fns[name]
    return (lambda: kern(q, k, v, seg, scale), lambda: plain(q, k, v, seg, scale), lib,
            *bound(nbytes, 2 * 2 * Hq * D * pairs))


def int8mm_timing_row(fns, shapes, bound, flush):
    """B9 as one decode step's layer sees it: the five 8B matmul weights in
    turn (wqkv, wo, wgu, wdown, then lm_head) at R = 64, as one timed
    function.  Library: torch._weight_int8pack_mm where the card's torch has
    a CUDA kernel for it, else cuBLAS x @ w with the weight dequantised to
    bf16 ahead of time.  Each shape at R = 64 and 256 is also timed alone
    (printed), beside cuBLAS on the dequantised bf16 weight, which reads
    twice B9's weight bytes."""
    import torch
    from deft_tpu_torch.ops import int8_matmul as i8

    kern, plain = fns["int8_matmul"]
    cases = {label: args for label, _, args in shapes["int8_matmul"]}
    deq = {}  # R = 64 and 256 share each weight
    for x, w, s in cases.values():
        if id(w) not in deq:
            deq[id(w)] = (w.float() * s).to(x.dtype)
    if torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm",
                                                      "CUDA"):
        prep = {label: (x, w.t().contiguous(), s.to(x.dtype))
                for label, (x, w, s) in cases.items()}

        def lib_call(x, wt, sb):
            return torch._weight_int8pack_mm(x, wt, sb)

        LIBRARY["int8_matmul"] = "torch._weight_int8pack_mm"
    else:
        prep = {label: (x, deq[id(w)], None) for label, (x, w, s) in cases.items()}

        def lib_call(x, wd, _):
            return x @ wd

        LIBRARY["int8_matmul"] = "cuBLAS x @ w, w dequantised to bf16 ahead of time"

    def cost(x, w, s):
        R, H = x.shape
        I = w.shape[1]
        return (H * I + 2 * R * H + 4 * I + 2 * R * I), 2 * R * H * I

    for label, args in cases.items():
        nb, fl = cost(*args)
        b_ms, b_by = bound(nb, fl)
        ms = time_ms(lambda a=args: kern(*a), 20, flush)
        host_ms = time_ms(lambda a=args: kern(*a), 20, flush, primed=False)
        lib_ms = time_ms(lambda a=prep[label]: lib_call(*a), 20, flush)
        bf16_ms = time_ms(lambda x=args[0], wd=deq[id(args[1])]: x @ wd, 20, flush)
        sp = i8.launch_splits(args[0].device.index, *args[0].shape, args[1].shape[1],
                              args[0].dtype)
        print(f"[timing] int8_matmul {label} (H, I) = {tuple(args[1].shape)}, "
              f"{sp} splits: kernel "
              f"{ms:.4f} ms ({host_ms:.4f} ms unprimed), library {lib_ms:.4f} ms, "
              f"cuBLAS on the bf16 weight "
              f"{bf16_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.1%} of the bound", flush=True)
    step = [cases[f"R=64 {n}"] for n in INT8_SHAPES]
    step_lib = [prep[f"R=64 {n}"] for n in INT8_SHAPES]
    nb, fl = (sum(c) for c in zip(*(cost(*a) for a in step)))
    return (lambda: [kern(*a) for a in step], lambda: [plain(*a) for a in step],
            lambda: [lib_call(*a) for a in step_lib], *bound(nb, fl))


def attention_library_row(name, plan, args, flush):
    """The library call beside an attention kernel B1, B2, B4-B7:
    scaled_dot_product_attention with a boolean mask over KV gathered (and
    dequantised to q's dtype) ahead of time, K/V repeated to the query
    heads: the tree's flattened KV with each leaf's visibility (flatten), or
    each leaf's padded path with its live tokens (seq).  Returns (callable
    or None, description); the gather's time is printed."""
    import torch
    import torch.nn.functional as F
    from deft_tpu_torch.models.llama import KVPool, kv_gather_heads
    from deft_tpu_torch.ops.paged_flatten_attn import segment_rows
    from deft_tpu_torch.ops.paged_seq_attn import segment_paths

    _, _, kind, kv, layout = KERNELS[name]
    a = named_args(name, args)
    q, kp, vp, ks, vs = (a.get(k) for k in ("q", "k_pool", "v_pool", "k_scale", "v_scale"))
    kv = "int8" if kp.dtype == torch.int8 else kv  # B6, B7 take either pool type
    R, Hq, D = q.shape
    qpk = Hq // (kp.shape[-1] // D)
    dev = q.device

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)

    if kind == "flatten":
        rows = segment_rows(t(plan.seg_src), plan.seg_len) if layout == "paged" \
            else t(plan.kv_idx)
        blk_lo, blk_hi = t(plan.blk_lo), t(plan.blk_hi)
        full = (blk_lo < -(1 << 20)).repeat_interleave(plan.block_len)
        dead = ((blk_lo >= blk_hi).repeat_interleave(plan.block_len)) & ~full
        lo = torch.where(full, 0, t(plan.tok_lo))
        hi = torch.where(dead, 0, torch.where(full, R, t(plan.tok_hi)))
        r = torch.arange(R, device=dev)[:, None]
        mask = (lo[None, :] <= r) & (r < hi[None, :])  # (R, T)
    elif layout == "paged":
        rows, mask = segment_paths(t(plan.seg_src), t(plan.seg_off), t(plan.seg_live),
                                   t(plan.blk_live), R, plan.seg_len)
    else:
        rows = t(plan.paths)
        mask = torch.arange(rows.shape[1], device=dev)[None, :] < t(plan.seq_lens)[:, None]

    def gather():
        k, v = (kv_gather_heads(KVPool(p, s), 0, rows, D, q.dtype).repeat_interleave(
            qpk, dim=-2) for p, s in ((kp, ks), (vp, vs)))
        if kind == "flatten":  # (1, Hq, T, D), q (1, Hq, R, D), mask (R, T)
            return (q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                    v.transpose(0, 1)[None], mask)
        # one batch row a leaf: (R, Hq, C, D), q (R, Hq, 1, D), mask (R, 1, 1, C)
        return q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), mask[:, None, None]

    gather_ms = time_ms(gather, 3, flush)
    qq, kk, vv, mm = gather()
    scale = D ** -0.5

    def lib():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mm, scale=scale)

    try:
        o = lib()
    except RuntimeError as err:
        print(f"[timing] {name} library: SDPA raised {str(err)[:160]}", flush=True)
        return None, "none: SDPA with this mask raised on this card"
    got = o[0].transpose(0, 1) if kind == "flatten" else o[:, :, 0]
    live = slice(0, plan.n_leaves)
    want = wrappers()[name][1](*args)
    e = rel_err(got[live], want[live])
    desc = (f"SDPA, boolean {'tree-visibility' if kind == 'flatten' else 'per-leaf path'} "
            f"mask, KV gathered{' and dequantised' if kv == 'int8' else ''} ahead of time")
    print(f"[timing] {name} library: {desc}: gather {gather_ms:.4f} ms (not timed), "
          f"rel err vs plain {e:.3e} on live rows", flush=True)
    if not e < TOL["bfloat16"]:
        return None, f"none: SDPA over the gathered KV disagrees ({e:.3e})"
    return lib, desc


def unique_path_rows(name, plan, args) -> int:
    """The distinct pool rows the leaves' live paths hold (a seq kernel's
    KV input, each row counted once)."""
    import torch
    from deft_tpu_torch.ops.paged_seq_attn import segment_paths

    a = named_args(name, args)
    if KERNELS[name][4] == "gather":
        paths = torch.from_numpy(np.asarray(plan.paths, np.int64))
        lens = torch.from_numpy(np.asarray(plan.seq_lens, np.int64))
        mask = torch.arange(paths.shape[1])[None, :] < lens[:, None]
        return int(torch.unique(paths[mask]).numel())
    rows, mask = segment_paths(a["seg_src"], a["seg_off"], a["seg_live"], a["blk_live"],
                               a["q"].shape[0], a["seg_len"])
    return int(torch.unique(rows[mask]).numel())


def partial_visibility(name, args):
    """What a partial entry attends at its window: (k, v, mask, live
    tokens, visible (row, token) pairs per KV head and query head group)
    with k, v gathered from the pools in q's dtype (int8 dequantised):
    flatten (T, Hkv, D) and mask (R, T); seq (R, C, Hkv, D) and (R, C)."""
    import torch
    from deft_tpu_torch.models.llama import KVPool, kv_gather_heads
    from deft_tpu_torch.ops import paged_flatten_attn as pf
    from deft_tpu_torch.ops.paged_seq_attn import segment_paths

    a = named_args(name, args)
    q = a["q"]
    R, D = q.shape[0], q.shape[-1]
    if KERNELS[name][2] == "flatten":
        if "seg_src" in a:
            rows, block_len = pf.segment_rows(a["seg_src"], a["seg_len"]), a["block_len"]
        else:
            rows = a["kv_idx"]
            block_len = rows.shape[0] // a["blk_lo"].shape[0]
        lo, hi = pf.leaf_intervals(a["tok_lo"], a["tok_hi"], a["blk_lo"], a["blk_hi"],
                                   block_len, R)
        r = torch.arange(R, device=q.device)[:, None]
        mask = (lo[None, :] <= r) & (r < hi[None, :])
        tokens = int(mask.any(dim=0).sum())
    else:  # each live path row once (the guide's rule)
        rows, mask = segment_paths(a["seg_src"], a["seg_off"], a["seg_live"],
                                   a["blk_live"], R, a["seg_len"])
        tokens = int(torch.unique(rows[mask]).numel())
    k, v = (kv_gather_heads(KVPool(a[f"{x}_pool"], a.get(f"{x}_scale")), a["li"], rows, D,
                            q.dtype) for x in "kv")
    return k, v, mask, tokens, int(mask.sum())


def partial_timing_row(name, args, bound, flush, key=None):
    """A partial entry at its path window: kernel, plain and library
    callables and the bound (its library line under ``key``, else
    ``name``).  Bytes: the window's live KV tokens read once
    (int8: codes and fp32 scales), q and the plan read, the state (acc, m,
    l in fp32) written; operations: 4 D per visible (row, token) pair and
    query head.  Library: torch.ops.aten._scaled_dot_product_efficient_attention
    with compute_log_sumexp (the same state: o = acc / l, lse = m + log l)
    and a float mask, over KV gathered (dequantised) and repeated to the
    query heads ahead of time, untimed."""
    import torch

    kind = KERNELS[name][2]
    int8 = args[1].dtype == torch.int8
    q = args[0]
    R, Hq, D = q.shape
    Hkv = args[1].shape[-1] // D
    qpk = Hq // Hkv
    t0 = time.perf_counter()
    k, v, mask, tokens, pairs = partial_visibility(name, args)
    kv_bytes = Hkv * (2 * D + 8) if int8 else Hkv * D * 2 * q.element_size()
    plan_bytes = sum(a.numel() * 4 for a in args
                     if isinstance(a, torch.Tensor) and a.dtype == torch.int32)
    nbytes = (tokens * kv_bytes + q.numel() * q.element_size() + plan_bytes
              + R * Hq * (D + 2) * 4)
    bnd = bound(nbytes, pairs * Hq * 4 * D)
    if kind == "seq":
        reread = nbytes + (pairs - tokens) * kv_bytes
        print(f"[timing] {name} bound by bytes: {tokens} unique live path rows "
              f"{nbytes / PEAK_BYTES * 1e3:.4f} ms; each leaf re-reading its path "
              f"({pairs} rows) {reread / PEAK_BYTES * 1e3:.4f} ms", flush=True)
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill_(
        ~mask, float("-inf"))
    if kind == "flatten":  # one batch: (1, Hq, R, D) over (1, Hq, T, D)
        qq = q.transpose(0, 1)[None]
        kk, vv = (x.repeat_interleave(qpk, dim=1).transpose(0, 1)[None].contiguous()
                  for x in (k, v))
        bb = bias[None, None].expand(1, Hq, -1, -1).contiguous()
    else:  # one batch row a leaf: (R, Hq, 1, D) over (R, Hq, C, D)
        qq = q[:, :, None]
        kk, vv = (x.repeat_interleave(qpk, dim=2).transpose(1, 2).contiguous()
                  for x in (k, v))
        bb = bias[:, None, None].expand(-1, Hq, -1, -1).contiguous()
    gather_s = time.perf_counter() - t0
    kern, plain = wrappers()[name]

    def lib():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qq, kk, vv, bb, True, scale=D ** -0.5)

    desc = ("aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True), "
            "float mask, KV gathered" + (" and dequantised" if int8 else "")
            + " ahead of time")
    try:
        o = lib()[0]
        acc, _, l = plain(*args)
        if kind == "flatten":  # to (R, Hq, D), the plain state unfolded
            from deft_tpu_torch.ops.paged_flatten_attn import unfold_rows

            o, acc, l = o[0].transpose(0, 1), unfold_rows(acc, R), unfold_rows(l, R)
        else:
            o = o[:, :, 0]
        seen = l > 0
        e = rel_err(o[seen].float(), (acc / l.clamp_min(1e-30)[..., None])[seen])
        print(f"[timing] {name} library: {desc}: gather {gather_s * 1e3:.1f} ms (host "
              f"clock, not timed), rel err of o vs the plain state's acc / l {e:.3e}",
              flush=True)
        if not e < TOL["bfloat16"]:
            lib, desc = None, f"none: the efficient attention disagrees ({e:.3e})"
    except RuntimeError as err:
        print(f"[timing] {name} library: {str(err)[:160]}", flush=True)
        lib, desc = None, "none: the efficient attention raised on this card"
    LIBRARY[key or name] = desc
    return (lambda: kern(*args), lambda: plain(*args), lib, *bnd)


def gmm_timing_rows(fns, shapes, bound):
    """B10 at its wg shape (Mixtral prefill, M_pad 9088, E 4096, F 14336),
    unscaled and scaled: kernel, plain and library callables and the bound
    over the row tiles up to the end of the last group, which this run's
    routing needs (each expert that owns a tile read once, those rows of x
    and out once); the bound over all M_pad rows, trailing pad tiles
    included, is printed beside it.  Library:
    torch._grouped_mm over bf16 weights (int8 codes dequantised ahead of
    time) with offs at the padded group ends, the pad tiles past the last
    group counted in the last group, as B10 runs them."""
    import torch

    rows = {}
    for name in ("gmm", "gmm_scaled"):
        x, w, tile_eid, s = shapes[name][0][2]
        kern, plain = fns[name]
        M, E = x.shape
        ne, _, F = w.shape
        tiles = torch.bincount(tile_eid.long(), minlength=ne)
        owners = int((tiles > 0).sum())

        def gmm_bound(rows):
            nbytes = rows * (E + F) * x.element_size() + owners * E * F * w.element_size() \
                + (owners * F * 4 if s is not None else 0) + tile_eid.numel() * 4
            return bound(nbytes, 2 * rows * E * F)

        live = GMM_LIVE_TILES[M] * 128
        (lb, lby), (pb, pby) = gmm_bound(live), gmm_bound(M)
        print(f"[timing] {name} bound: {lb:.4f} ms ({lby}) over the {live} rows up to "
              f"the end of the last group; {pb:.4f} ms ({pby}) over all {M} rows",
              flush=True)
        wb = w if s is None else (w.float() * s[:, None, :]).to(x.dtype)
        offs = (torch.cumsum(tiles, 0) * 128).to(torch.int32)
        want = plain(x, w, tile_eid, s)
        lib = None
        for layout, wl in (("row-major", wb), ("column-major", wb.transpose(1, 2)
                                                .contiguous().transpose(1, 2))):
            try:
                e = rel_err(torch._grouped_mm(x, wl, offs=offs), want)
            except (AttributeError, RuntimeError, TypeError) as err:
                print(f"[timing] {name} library: torch._grouped_mm, {layout} weights: "
                      f"{type(err).__name__}: {str(err)[:160]}", flush=True)
                continue
            print(f"[timing] {name} library: torch._grouped_mm, {layout} bf16 weights"
                  f"{' (dequantised ahead of time)' if s is not None else ''}, rel err "
                  f"vs plain {e:.3e}", flush=True)
            if e < TOL["bfloat16"]:
                lib = (lambda a=x, b=wl, o=offs: torch._grouped_mm(a, b, offs=o))
                LIBRARY[name] = (f"torch._grouped_mm, {layout} bf16 weights"
                                 + (", dequantised ahead of time" if s is not None else ""))
                break
        if lib is None:
            LIBRARY[name] = "none: torch._grouped_mm is missing or disagrees here"
        rows[name] = (lambda k=kern, a=(x, w, tile_eid, s): k(*a),
                      lambda p=plain, a=(x, w, tile_eid, s): p(*a), lib, lb, lby)
    return rows


def flat_q_tile_cost(dev, shapes, flush):
    """B1, B1p, B4, B4p, B6 (short and batch plans, bf16 pools; at the wide
    heads the main tree, both pools) and B11 at their path shapes with one
    span forced (a block walks every listed
    64-token tile of its row tile, so time over tiles is what a tile costs
    a block), and on the rule's grid with a warm L2 (what the cold reads
    cost)."""
    from deft_tpu_torch.ops import _cuda

    fns = wrappers()
    sms = _cuda.sm_count(dev.index)
    cases = [(name, "", shapes[name][0][2]) for name in (
        "paged_flatten", "paged_flatten_partial", "paged_flatten_q", "paged_flatten_q_partial",
        "flatten_gather_partial")]
    cases += [("flatten_gather", label, args) for label, _, args in shapes["flatten_gather"]
              if label in ("inherit", "batch inherit")]
    cases += [(name, label, args) for name in WIDE_FLAT[:len(WIDE_HEADS)] if name in shapes
              for label, _, args in shapes[name] if " main " in label]
    for name, label, args in cases:
        tiles, _, _, spans, _ = flat_q_grid(name, args, sms)
        fn = fns[name][0]
        with forced_spans(1):
            one = time_ms(lambda: fn(*args), 20, flush)
        warm = time_ms(lambda: fn(*args), 20, flush[:16])
        print(f"[timing] {name}{' ' + label if label else ''}: one span {one:.4f} ms over "
              f"{max(tiles)} tiles a row tile ({one / max(tiles) * 1e3:.2f} us a tile); the "
              f"rule's grid ({spans} spans) with a warm L2 {warm:.4f} ms", flush=True)


SEQ_NAMES = ("paged_seq", "paged_seq_partial", "paged_seq_q", "paged_seq_q_partial",
             "seq_gather")


# B7 at the wide heads, and B6 and B11: their rows in the kernels line
WIDE_SEQ = tuple(f"seq_gather_d{D}" for D in WIDE_HEADS)
WIDE_FLAT = tuple(f"{base}_d{D}" for base in ("flatten_gather", "flatten_gather_partial")
                  for D in WIDE_HEADS)


def seq_grids(shapes, sms, tag):
    """Print the grid each seq kernel takes over bf16 q at its path shapes:
    leaves x KV heads x the blocks of a cluster a path is split over."""
    from deft_tpu_torch.ops import paged_seq_attn as ps

    for name in SEQ_NAMES + WIDE_SEQ:
        for label, _, args in shapes.get(name, ()):
            a = named_args(name, args)
            R, D = a["q"].shape[0], a["q"].shape[-1]
            Hkv = a["k_pool"].shape[-1] // D
            int8 = a.get("k_scale") is not None
            print(f"[{tag}] {name}{' ' + label if label else ''} grid: {R} rows x {Hkv} KV "
                  f"heads, each path over {ps.seq_splits(R, Hkv, sms, int8, D)} blocks of a "
                  f"cluster", flush=True)


def phase_timing(dev, shapes):
    """Per kernel at its path's shapes (B6 at the short and the batch plan,
    B7 at the short tree and the main tree's gather plan, each over bf16 and
    int8 pools, the short plans' bf16 cases in the kernels line; B9: one
    layer's four matmuls and lm_head at R = 64): kernel, plain and library
    times, the least time the card could take and what bounds it."""
    import torch
    import torch.nn.functional as F

    fns = wrappers()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def bound(nbytes, flops):
        tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    def plan_bytes(args):
        return sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor) and a.dtype == torch.int32)

    def kv_token_bytes(args, Hkv, D):
        """K and V bytes of one token: int8 codes plus fp32 (token, head)
        scales, or two rows of the pool's dtype."""
        pool = args[1]
        if pool.dtype == torch.int8:
            return Hkv * (2 * D + 8)
        return Hkv * D * 2 * pool.element_size()

    def attention_row(name, key, plan, args):
        q = args[0]
        R, Hq, D = q.shape
        Hkv = args[1].shape[-1] // D
        qpk = Hq // Hkv
        io = 2 * q.numel() * q.element_size()
        if KERNELS[name][2] == "flatten":
            # live KV read once, q and the plan read, o written; FLOPs over
            # the (row, token) pairs the plan's intervals make visible
            lo, hi = plan.tok_lo.astype(np.int64), plan.tok_hi.astype(np.int64)
            live = hi > lo
            pairs = int((hi[live] - lo[live]).sum()) * qpk * Hkv
            nbytes = plan.n_tokens * kv_token_bytes(args, Hkv, D) + io + plan_bytes(args)
        else:
            # the bound counts each live path row once (the guide's rule);
            # each leaf re-reading its whole path (the baseline's own work)
            # is printed beside it
            pairs = plan.total_kv * qpk * Hkv
            unique = unique_path_rows(name, plan, args)
            nbytes = unique * kv_token_bytes(args, Hkv, D) + io
            if KERNELS[name][4] == "gather":  # the live entries of paths
                nbytes += 4 * plan.total_kv + 4 * R
            else:
                nbytes += plan_bytes(args)
            reread = nbytes + (plan.total_kv - unique) * kv_token_bytes(args, Hkv, D)
            print(f"[timing] {name} bound by bytes: {unique} unique live path rows "
                  f"{nbytes / PEAK_BYTES * 1e3:.4f} ms; each leaf re-reading its path "
                  f"({plan.total_kv} rows) {reread / PEAK_BYTES * 1e3:.4f} ms", flush=True)
        fn, plain = fns[name]
        lib, LIBRARY[key] = attention_library_row(name, plan, args, flush)
        rows[key] = (lambda f=fn, a=args: f(*a), lambda p=plain, a=args: p(*a), lib,
                     *bound(nbytes, pairs * 4 * D))

    rows = {}
    for name, cases in shapes.items():
        if name in PARTIAL_OF:
            rows[name] = partial_timing_row(name, cases[0][2], bound, flush)
        elif KERNELS[name][2] is not None:  # prefill, B8, B9: below
            attention_row(name, name, *cases[0][1:])
    # B6 also over int8 pools and at the batch plan (its other path shape),
    # B7 over int8 pools and at the main tree's gather plan; the wide heads'
    # B6, B7 and B11 at their other cases
    for name in shapes:
        if WIDE_OF.get(name, name) in ("flatten_gather", "seq_gather"):
            for label, plan, args in shapes[name][1:]:
                attention_row(name, f"{name} ({label})", plan, args)
        elif WIDE_OF.get(name) == "flatten_gather_partial":
            for label, _, args in shapes[name][1:]:
                key = f"{name} ({label})"
                rows[key] = partial_timing_row(name, args, bound, flush, key)
    # prefill: causal FLOPs 2 * 2 * Hq * N^2 * D / 2
    for name in shapes:
        if WIDE_OF.get(name, name) != "prefill":
            continue
        q, k, v, scale = shapes[name][0][2]
        N, Hq, D = q.shape
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        # SDPA takes (batch, heads, N, D) with every query head's K/V spelled out
        qt = q.transpose(0, 1).contiguous()[None]
        kt, vt = (x.repeat_interleave(Hq // x.shape[1], dim=1).transpose(0, 1)
                  .contiguous()[None] for x in (k, v))
        fn, plain = fns[name]
        LIBRARY[name] = "SDPA is_causal, K/V repeated to the query heads"
        rows[name] = (lambda f=fn, a=(q, k, v, scale): f(*a),
                      lambda p=plain, a=(q, k, v, scale): p(*a),
                      lambda a=(qt, kt, vt), sc=scale: F.scaled_dot_product_attention(
                          *a, is_causal=True, scale=sc),
                      *bound(nbytes, 2 * 2 * Hq * N * N * D / 2))

    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.ops import paged_flatten_attn as pf

    sms = _cuda.sm_count(dev.index)
    seq_grids(shapes, sms, "timing")
    for name in ("paged_flatten", "paged_flatten_partial", "paged_flatten_q",
                 "paged_flatten_q_partial"):
        a = named_args(name, shapes[name][0][2])
        tiles, rb, Hkv, spans, _ = flat_q_grid(name, shapes[name][0][2], sms)
        R, Hq, D = a["q"].shape
        rq, nb = R * Hq // Hkv, a["blk_lo"].shape[0]
        T = nb * a["block_len"]  # the staged body's spans (fp32 q), launch_flatten's rule
        staged = pf.num_spans(nb, T * Hkv * (4 * D if "k_scale" not in a else 2 * D + 8),
                              Hkv * rq * (D + 2) * 4)
        print(f"[timing] {name} grid: {len(tiles)} row tiles of {rb} folded rows x {Hkv} "
              f"KV heads x {spans} spans = {len(tiles) * Hkv * spans} blocks of "
              f"{rb // 16} warps over {nb} plan blocks of {a['block_len']} tokens "
              f"({sms} SMs), then the merge kernel; the staged body's rule would take "
              f"{-(-rq // 64)} row tiles of 64 x {Hkv} x {staged} spans = "
              f"{-(-rq // 64) * Hkv * staged} blocks of 4 warps", flush=True)
    flat_q_tile_cost(dev, shapes, flush)
    for name in shapes:
        if WIDE_OF.get(name, name) == "ragged_prefill":
            rows[name] = ragged_timing_row(fns, shapes, bound, name)
    rows["int8_matmul"] = int8mm_timing_row(fns, shapes, bound, flush)
    rows.update(gmm_timing_rows(fns, shapes, bound))

    out = {}
    for name, (kern, plain_fn, lib, bound_ms, bound_by) in rows.items():
        ms = time_ms(kern, 20, flush)
        host_ms = time_ms(kern, 20, flush, primed=False)
        plain_ms = time_ms(plain_fn, 3, flush)
        lib_ms = time_ms(lib, 20, flush) if lib is not None else None
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        lib_txt = (f", library {lib_ms:.4f} ms ({LIBRARY[name]})"
                   if lib_ms is not None else f", library {LIBRARY[name]}")
        host = ("the wrapper's host work, the tensor maps' encoding included"
                if name in TMA_KERNELS else "the wrapper's host work")
        print(f"[timing] {name}: kernel {ms:.4f} ms ({host_ms:.4f} ms unprimed: "
              f"the device waits for {host}), plain {plain_ms:.4f} ms"
              f"{lib_txt}, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of the bound", flush=True)
    return out


# the lab phase: the kernel lab's variants it drives at the full shapes,
# B1 on each case first (the lab holds every variant against the first
# output of its case), and each lab kernel's row in the kernels line: the
# variant its check, times and bound are taken at
LAB_RUN = ("v0_b512", "vB_b512", "vD_b512", "k2_b1024s512", "full_b512", "deep_qw0_b512",
           "deep_tq64_b512", "probe_exp2_b512")
LAB_ROWS = {"lab_passes": "vB_b512", "lab_fused": "vD_b512", "lab_k2": "k2_b1024s512",
            "lab_exp2_probe": "probe_exp2_b512"}
# B14's other checked case: the deep tree with row tiles of 64
LAB_K2_DEEP = "deep_tq64_b512"
# B15 against its plain version: fp32 exp2 chains, absolute
PROBE_TOL = 1e-5
# B15 also at few sweeps, (nb, passes), from a random start tile: x <-
# exp2(-0.9999 x) contracts by about 0.44 a sweep, so after some 14 sweeps
# every chain sits within PROBE_TOL of one fixed point (the lab's 72 cannot
# tell a wrong sweep count or one chain broadcast); at these counts each
# sweep moves the output, and the chains differ, by far more than PROBE_TOL
PROBE_FEW = tuple((1, p) for p in range(1, 9)) + ((3, 3), (2, 5), (5, 2), (2, 6))
# the lab kernels and B1 also against their plain versions at this many
# times the case's q
LAB_SHARP = 8


def probe_few_sweeps(dev) -> float:
    """B15 against its plain version at PROBE_FEW's sweep counts, from a
    start tile drawn per element (uniform in [-4, 2]) at the lab's (Rq,
    512) shape.  Each case must also be sharp: one sweep more or less, or
    every chain replaced by one, moves the plain output by more than 10 x
    PROBE_TOL.  Returns the largest absolute error."""
    import torch

    from deft_tpu_torch.experiments import kernel_lab as kl
    from deft_tpu_torch.ops import lab_probe as lp

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    x0 = torch.rand((kl.RQ, 512), generator=gen, device=dev) * 6 - 4
    worst = 0.0
    for nb, passes in PROBE_FEW:
        got = lp.lab_exp2_probe(x0, nb, passes, kl.D)
        want = lp.lab_exp2_probe_plain(x0, nb, passes, kl.D)
        e = float((got - want).abs().max())
        fewer = lp.lab_exp2_probe_plain(x0, 1, nb * passes - 1, kl.D)
        more = lp.lab_exp2_probe_plain(x0, 1, nb * passes + 1, kl.D)
        step = float(torch.minimum((want - fewer).abs().max(), (want - more).abs().max()))
        spread = float(want.max() - want.min())
        print(f"[lab] lab_exp2_probe nb {nb} x passes {passes} from a random tile vs plain: "
              f"abs err {e:.3e}; one sweep moves it {step:.3e}, its chains span {spread:.3e}",
              flush=True)
        check(bool(torch.isfinite(got).all()) and e < PROBE_TOL,
              f"lab_exp2_probe at nb {nb} x passes {passes} disagrees with its plain "
              f"version: {e}")
        check(min(step, spread) > 10 * PROBE_TOL,
              f"lab_exp2_probe at nb {nb} x passes {passes}: the check is not sharp")
        worst = max(worst, e)
    return worst


def phase_lab(dev, smi):
    """The flatten kernel lab (deft_tpu_torch/experiments/kernel_lab.py) on
    the card: its entry drives LAB_RUN at the full shapes (cases drawn on the
    card), counts set to 0 just before and read just after: B12-B15 (and
    B1) must launch, every output is finite and B12-B14 agree with B1's
    output on the same case within 2e-2 (the lab exits non-zero else).
    Then, on the cases and calls the entry hands back, each lab kernel
    against its plain version on the same inputs (bf16 2e-2; the probe,
    fp32, within PROBE_TOL absolute, also at few sweeps: probe_few_sweeps),
    and at LAB_ROWS' cases its CUDA-event time, the plain version's, B1's
    library call on the same case (SDPA over KV gathered ahead of time;
    none for the probe) and its bound.  The cases are freed on return.
    Returns (errs, timing, launches) of the four lab kernels."""
    import torch
    from types import SimpleNamespace

    from deft_tpu_torch.experiments import kernel_lab as kl

    t0 = time.perf_counter()
    reset_counts()
    results = {}
    rc = kl.main(list(LAB_RUN), results=results)
    counts = read_counts()
    launches = {n: counts[n] for n in LAB_ROWS}
    print(f"[lab] entry exit code {rc}; launches {launches}, B1 "
          f"{counts['paged_flatten']}; {time.perf_counter() - t0:.1f} s", flush=True)
    check(rc == 0, "the kernel lab failed a variant")
    check(all(launches.values()) and counts["paged_flatten"] > 0,
          f"a lab kernel never launched: {launches}")
    for name, r in results.items():
        check((r["layers"], r["t_pad"]) == (32, 8192),
              f"lab {name} ran at {r['layers']} layers, T_PAD {r['t_pad']}: not the full shapes")
        check(bool(torch.isfinite(r["out"]).all()), f"lab {name}: non-finite output")
        if r["kernel"] in ("B12", "B13", "B14"):
            check(r["rel"] < TOL["bfloat16"], f"lab {name} disagrees with B1: {r['rel']}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    fns = wrappers()
    rate = kl.exp2_rate(dev)
    errs = {"lab_exp2_probe": probe_few_sweeps(dev)}
    timing = {}
    for name, variant in list(LAB_ROWS.items()) + [("lab_k2", LAB_K2_DEEP)]:
        make, bl, _ = kl.VARIANTS[variant]
        case, call = results[variant]["case"], results[variant]["call"]
        fn, plain = fns[name]
        check(call.fn is fn, f"{variant} does not run {name}")
        args = call.args(kl.LAYERS - 1)
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        finite = bool(torch.isfinite(got).all())
        if name == "lab_exp2_probe":
            e = float((got.double() - want.double()).abs().max())
            ok = e < PROBE_TOL
        else:
            e = rel_err(got, want)
            ok = e < TOL["bfloat16"]
        print(f"[lab] {name} ({variant}) vs plain: {'abs' if name == 'lab_exp2_probe' else 'rel'} "
              f"err {e:.3e}, finite {finite}", flush=True)
        check(ok and finite, f"{name} ({variant}) disagrees with its plain version: {e}")
        errs[name] = max(errs.get(name, 0.0), float((got.double() - want.double()).abs().max()))
        if name != "lab_exp2_probe":
            # the lab's q and K give nearly uniform weights (scores ~0.09
            # N(0, 1)); at LAB_SHARP x q each row leans on its own largest
            # scores: the kernel, and B1 on the same case, against plain
            sharp = dict(case, q=(case["q"].float() * LAB_SHARP).to(torch.bfloat16))
            for label, c in ((name, make(sharp)), ("B1", kl._b1(sharp))):
                a = c.args(kl.LAYERS - 1)
                e = rel_err(c.fn(*a), c.plain(*a))
                print(f"[lab] {label} ({variant}, q x{LAB_SHARP}) vs plain: rel err {e:.3e}",
                      flush=True)
                check(e < TOL["bfloat16"], f"{label} ({variant}, sharp q) disagrees: {e}")
            del sharp, c, a
        if variant != LAB_ROWS[name]:
            del case, call, args, got, want
            continue
        bound, by = kl.bound_ms(kl.work(call, case), rate)
        lib = None
        if name != "lab_exp2_probe":
            b1 = kl._b1(case)
            h = case["host"]
            plan = SimpleNamespace(seg_src=h["seg_src"], seg_len=min(kl.SEG, bl),
                                   tok_lo=h["tok_lo"], tok_hi=h["tok_hi"], blk_lo=h["blk_lo"],
                                   blk_hi=h["blk_hi"], block_len=bl, n_leaves=kl.LEAVES)
            lib, LIBRARY[name] = attention_library_row("paged_flatten", plan, b1.args(0), flush)
        else:
            LIBRARY[name] = ("none: no one PyTorch call computes the probe's chains of "
                             "dependent exp2 (torch.exp2 is one sweep a launch)")
        ms = time_ms(lambda: fn(*args), 20, flush)
        plain_ms = time_ms(lambda: plain(*args), 3, flush)
        lib_ms = time_ms(lib, 20, flush) if lib is not None else None
        timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                            bound_by=by)
        lib_txt = f"{lib_ms:.4f} ms ({LIBRARY[name]})" if lib_ms is not None else LIBRARY[name]
        step = results[variant]["ms"]
        print(f"[lab] {name} ({variant}, {results[variant]['kernel']}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {lib_txt}, bound {bound:.4f} ms ({by}"
              f"{', exp2 at the SM clock nvidia-smi reports' if name == 'lab_exp2_probe' else ''})"
              f", {bound / ms:.1%} of the bound; in the lab "
              f"{'not timed' if step is None else f'{step:.4f} ms'} a {kl.LAYERS}-layer "
              f"step; {smi}", flush=True)
        del case, call, args, got, want, lib
    del results, flush
    release()
    print(f"[lab] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return errs, timing, launches


def phase_flatten_only(dev, shapes, profile: bool, edges: bool = True):
    """--flatten-only: the flatten kernels (B1, B1p, B4, B4p, B6 at the
    short and batch plans over bf16 and int8 pools, B11; B6 and B11 at the
    wide heads, WIDE_FLAT: the main and short trees, bf16 and int8 pools)
    at their path shapes against their plain versions, then their
    CUDA-event times; with `edges` (this checkout's package), also
    b6_edges (the wide heads' edges among them), the B6/B11 tile cost and
    sweeps of forced span counts (B6 at the batch plan, its requests also
    admitted shortest prompt first, and at the short plan; B11; B6 at the
    wide heads' main tree, both pools); with `profile`, the batch path's profiled
    flatten steps (8B, bf16).  Runs on the package of --root too, so a
    parent commit is timed in turns with this one on one card."""
    import torch
    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.ops import paged_flatten_attn as pf

    fns = wrappers()
    names = ("paged_flatten", "paged_flatten_partial", "paged_flatten_q",
             "paged_flatten_q_partial", "flatten_gather", "flatten_gather_partial") + WIDE_FLAT
    for name in names:
        for label, plan, args in shapes[name]:
            leaves = plan[1] if name in PARTIAL_OF else plan.n_leaves
            qpk = args[0].shape[1] // (args[1].shape[-1] // args[0].shape[-1])
            check_edge("flatten", name, f"bf16 path shapes {label}", args, leaves, qpk,
                       TOL["bfloat16"])
    rule = edges and hasattr(pf, "balanced_spans")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    if rule:
        b6_edges(dev, gen, shapes)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for name in names:
        for label, _, args in shapes[name]:
            ms = time_ms(lambda: fns[name][0](*args), 20, flush)
            print(f"[flatten] {name} {label}: kernel {ms:.4f} ms", flush=True)
    if rule:
        flat_q_tile_cost(dev, shapes, flush)
        sms = _cuda.sm_count(dev.index)
        gather = {label: a for label, _, a in shapes["flatten_gather"]}
        # the batch path's requests also admitted shortest prompt first
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 9)
        rev = batch_trees(GEN_LEN // 2, np.random.default_rng(SEED + 3), BATCH_LENS[::-1])
        sweeps = [("flatten_gather", "batch inherit", gather["batch inherit"],
                   (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)),
                  ("flatten_gather", f"batch inherit, prompts "
                   f"{'/'.join(map(str, BATCH_LENS[::-1]))}",
                   batch_case(rev, "inherit", dev, gen)[1], (2, 3, 4, 5, 6, 8)),
                  ("flatten_gather", "inherit", gather["inherit"], (2, 4, 6, 8, 9, 10, 12, 16)),
                  ("flatten_gather_partial", shapes["flatten_gather_partial"][0][0],
                   shapes["flatten_gather_partial"][0][2], (4, 8, 12, 16, 20, 24, 28, 33))]
        sweeps += [(f"flatten_gather_d{D}", label, args, (4, 6, 8, 12, 16))
                   for D in WIDE_HEADS
                   for label, _, args in shapes[f"flatten_gather_d{D}"] if " main " in label]
        for name, label, args, counts in sweeps:
            tiles, _, _, spans, _ = flat_q_grid(name, args, sms)
            for s in sorted(set(counts) | {spans}):  # the rule's count among them
                with forced_spans(s):
                    ms = time_ms(lambda: fns[name][0](*args), 20, flush)
                print(f"[flatten] {name} {label} (listed tiles {list(tiles)}), {s} spans "
                      f"forced{' (the rule)' if s == spans else ''}: kernel {ms:.4f} ms",
                      flush=True)
    if profile:
        from deft_tpu_torch.models import PRESETS
        from deft_tpu_torch.models.loader import random_params

        cfg = PRESETS["8b"]
        params = random_params(cfg, SEED, dev, torch.bfloat16)
        runner = make_runner(cfg, params, dev, prompt_len=max(BATCH_LENS), slots=BATCH_SLOTS,
                             max_requests=4 * (WIDTH + 2))
        runner.retain_full_logits = False
        prompts = batch_prompts()
        profile_batch(runner, prompts, WIDTH, steps=8)
        del runner, params
        release()


def phase_seq_only(dev, shapes, edges: bool):
    """--seq-only: the seq kernels (B2, B2p, B5, B5p on the main tree and
    rank 0's window of grid 1x2x2; B7 at the short tree and the main tree's
    gather plan, bf16 and int8 pools, at Llama-3.1-8B's heads and at the
    wide heads, WIDE_SEQ) at their path shapes against their plain
    versions, then their CUDA-event times; with `edges` (this checkout's
    package) also b7_edges at every width and B7 over forced splits.  Runs
    on the package of --root too, so a parent commit is timed in turns with
    this one on one card."""
    import torch
    from deft_tpu_torch.ops import _cuda
    from deft_tpu_torch.ops import paged_seq_attn as ps

    fns = wrappers()
    names = SEQ_NAMES + WIDE_SEQ
    for name in names:
        for label, plan, args in shapes[name]:
            leaves = plan[1] if name in PARTIAL_OF else plan.n_leaves
            check_edge("seq", name, f"bf16 path shapes {label}", args, leaves, 4,
                       TOL["bfloat16"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    if edges:
        b7_edges(dev, gen)
        b7_edges(dev, gen, widths=tuple(WIDE_HEADS), qpks=(1, 2, 8))
        seq_grids(shapes, _cuda.sm_count(dev.index), "seq")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for name in names:
        for label, _, args in shapes[name]:
            ms = time_ms(lambda: fns[name][0](*args), 20, flush)
            print(f"[seq] {name}{' ' + label if label else ''}: kernel {ms:.4f} ms",
                  flush=True)
    if edges:
        for name in ("seq_gather",) + WIDE_SEQ:
            for label, _, args in shapes[name]:
                for sp in (1, 2, 4, 8):
                    with forced(ps, "seq_splits", sp):
                        ms = time_ms(lambda: fns[name][0](*args), 20, flush)
                    print(f"[seq] {name} {label}, {sp} splits forced: kernel {ms:.4f} ms",
                          flush=True)


# the prefill kernels' head widths in --prefill-only: head_dim -> (model,
# Hq, Hkv); Llama-3.2-1B's and Llama-3.1-8B's config.json beside WIDE_HEADS
PREFILL_HEADS = {64: ("Llama-3.2-1B", 32, 8), 96: WIDE_HEADS[96],
                 128: ("Llama-3.1-8B", 32, 8), 256: WIDE_HEADS[256]}


def phase_prefill_only(dev):
    """--prefill-only: B3 on the 4000-token prompt and B8 over the batch
    path's four prompts at every head width (PREFILL_HEADS), bf16, against
    their plain versions (2e-2; B8's pad rows, none here, would give 0),
    then their CUDA-event times beside the least time the card could take
    (operations: 4 Hq D FLOPs a causal pair).  Runs on the package of
    --root too, so a parent commit is timed in turns with this one on one
    card."""
    import torch

    fns = wrappers()
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 30)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for D, (model, Hq, Hkv) in sorted(PREFILL_HEADS.items()):
        cases = (("prefill", prefill_case(PROMPT_LEN, Hq, Hkv, D, bf16, dev, gen),
                  PROMPT_LEN * (PROMPT_LEN + 1) // 2),
                 ("ragged_prefill", ragged_case(BATCH_LENS, Hq, Hkv, D, bf16, dev, gen)[0],
                  sum(n * (n + 1) // 2 for n in BATCH_LENS)))
        for name, args, pairs in cases:
            fn, plain = fns[name]
            got = fn(*args)
            torch.cuda.synchronize()
            e = rel_err(got, plain(*args))
            check(e < TOL["bfloat16"] and bool(torch.isfinite(got).all()),
                  f"{name} D={D} disagrees with its plain version: {e}")
            ms = time_ms(lambda: fn(*args), 20, flush)
            bound = 4 * Hq * D * pairs / PEAK_FLOPS["bfloat16"] * 1e3
            print(f"[prefill] {name} D={D} ({model}, {Hq}/{Hkv} heads, tokens "
                  f"{args[0].shape[0]}): rel err {e:.3e}, kernel {ms:.4f} ms, bound "
                  f"{bound:.4f} ms (operations), {bound / ms:.1%} of the bound", flush=True)


def phase_wide_only(dev, smi) -> None:
    """--wide-only: this script's runs of the wide heads' served paths and
    of the other kernel instances they brought to a served run, each phase
    as in the full run: the 16-token prompt's int8 seq through BatchedEngine
    (B7 over int8 pools) and the 8B batch path over int8 KV (B6 over int8
    pools, B4 where a plan pages) on the 8B weights; Phi-3-mini's widths
    and Gemma-7B served (bf16, int8 KV, batched, grid 2x1x2:
    phase_families(wide_only=True)); mixtral-6l's moe path and the MoE
    block on grid 2x1x2's dp rows.  First B7 at the wide heads' batch seq
    plans against its plain version (wide_batch_seq), as the kernels phase
    holds it."""
    import torch
    from deft_tpu_torch.cli.run import make_prompt
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.loader import random_params

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    wide_batch_seq(dev, gen)
    cfg = PRESETS["8b"]
    params = random_params(cfg, SEED, dev, torch.bfloat16)
    with timed_phase("short int8 seq"):
        prompt = make_prompt(None, 16 + GEN_LEN, cfg.vocab_size, SEED)
        short_int8_seq(dev, params, prompt, [])
    with timed_phase("batch int8"):
        batch_int8(dev, params, batch_prompts())
    del params
    release()
    with timed_phase("families (wide)"):
        wide = phase_families(dev, smi, wide_only=True)
    print(f"[wide] the wide heads' launches: {wide}", flush=True)
    for name, n in wide.items():
        check(n > 0, f"wide: {name} never launched on a served run")
    with timed_phase("moe"):
        _, _, moe_ref = phase_moe(dev, smi)
    with timed_phase("sharded-moe (dp)"):
        phase_sharded_moe(moe_ref, grids=(DP_GRID,))


@contextlib.contextmanager
def timed_phase(name):
    """Print the seconds the block took, as "[time] name: s"."""
    t0 = time.perf_counter()
    yield
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace 8 decode steps per mode with torch.profiler "
                         "(the 4000-token prompt over bf16 and int8 KV, the "
                         "16-token prompt over bf16 KV, the two MoE paths), "
                         "8 batched flatten steps of the batch path's four "
                         "requests, 8 flatten steps each of the workloads "
                         "phase's ToT and speculative runs (W1, W2), and 8 main "
                         "flatten steps per-step and chained in turns (the chain "
                         "phase)")
    ap.add_argument("--flatten-only", action="store_true",
                    help="only the card, the build and the flatten kernels' checks and "
                         "times (phase_flatten_only); prints no result line")
    ap.add_argument("--seq-only", action="store_true",
                    help="only the card, the build and the seq kernels' checks and "
                         "times (phase_seq_only); prints no result line")
    ap.add_argument("--prefill-only", action="store_true",
                    help="only the card, the build and B3's and B8's checks and times "
                         "at head_dim 64, 96, 128 and 256 (phase_prefill_only); prints no "
                         "result line")
    ap.add_argument("--workloads-only", action="store_true",
                    help="only the card, the build and the workloads phase "
                         "(phase_workloads); prints no result line")
    ap.add_argument("--chain-only", action="store_true",
                    help="only the card, the build and the chain phase (per-step "
                         "against device-chained decode, phase_chain); prints no "
                         "result line")
    ap.add_argument("--attention-only", action="store_true",
                    help="only the card, the build and the attention phase "
                         "(phase_attention); prints no result line")
    ap.add_argument("--replay-only", action="store_true",
                    help="only the card, the build and the replay phase (the replay, "
                         "window and per-step chain paths, phase_replay); prints no "
                         "result line")
    ap.add_argument("--wide-only", action="store_true",
                    help="only the card, the build and the wide heads' served paths: "
                         "Phi-3-mini's widths and Gemma-7B over int8 KV, batched and on "
                         "grid 2x1x2, the 8B batch path and the 16-token prompt's seq "
                         "over int8 KV, mixtral-6l on grid 2x1x2 (phase_wide_only); "
                         "prints no result line")
    ap.add_argument("--lab-only", action="store_true",
                    help="only the card, the build and the kernel lab phase (B12-B15 "
                         "through the lab's entry, phase_lab); prints no result line")
    ap.add_argument("--root", default=None,
                    help="with --flatten-only, --seq-only or --prefill-only: import "
                         "deft_tpu_torch from this checkout (a parent commit timed in "
                         "turns with this one)")
    args = ap.parse_args(argv)
    only = (args.flatten_only + args.seq_only + args.prefill_only + args.workloads_only
            + args.chain_only + args.attention_only + args.replay_only + args.wide_only
            + args.lab_only)
    if only > 1:
        ap.error("--flatten-only, --seq-only, --prefill-only, --workloads-only, "
                 "--chain-only, --attention-only, --replay-only, --wide-only and "
                 "--lab-only are separate runs")
    if args.root is not None:
        if not (args.flatten_only or args.seq_only or args.prefill_only):
            ap.error("--root goes with --flatten-only, --seq-only or --prefill-only")
        sys.path.insert(0, args.root)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import deft_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the deft_tpu_torch package is missing ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    from deft_tpu_torch.models import PRESETS
    from deft_tpu_torch.models.loader import random_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        smi, device_kind = phase_card()
        phase_build(bodies=args.root is None)
        if args.lab_only:
            phase_lab(dev, smi)
            print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
            return 0
        if args.prefill_only:
            phase_prefill_only(dev)
            print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
            return 0
        with timed_phase("shapes"):
            shapes = path_shapes(dev)
        if args.flatten_only or args.seq_only:
            if args.flatten_only:
                shapes.update({k: v for k, v in wide_shapes(dev).items() if k in WIDE_FLAT})
                phase_flatten_only(dev, shapes, args.profile, edges=args.root is None)
            else:
                shapes.update({k: v for k, v in wide_shapes(dev).items() if k in WIDE_SEQ})
                phase_seq_only(dev, shapes, edges=args.root is None)
            print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
            return 0
        if args.wide_only:
            phase_wide_only(dev, smi)
            print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
            return 0
        if not (args.workloads_only or args.chain_only or args.attention_only
                or args.replay_only):
            with timed_phase("wide shapes"):
                shapes.update(wide_shapes(dev))
            with timed_phase("kernels"):
                errs = phase_kernels(dev, shapes)
        t0 = time.perf_counter()
        params = random_params(PRESETS["8b"], SEED, dev, torch.bfloat16)
        torch.cuda.synchronize()
        print(f"[main] 8b random bf16 weights made on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if args.attention_only:
            phase_attention(dev, params, main_prompt(), smi)
            print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
            return 0
        if args.workloads_only or args.chain_only:
            phase = phase_workloads if args.workloads_only else phase_chain
            with switched(PER_STEP_CHAIN):
                phase(dev, params, main_prompt(), smi, profile=args.profile)
            print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
            return 0
        if args.replay_only:
            phase_replay(dev, params, main_prompt(), smi)
            print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
            return 0
        with timed_phase("main"):
            launches, prompt, ids, lf, main_runs = phase_main(dev, params, args.profile)
        with timed_phase("attention"):
            phase_attention(dev, params, prompt, smi, main_runs)
        with timed_phase("checkpoint"):
            phase_checkpoint(dev, params, prompt)
        with timed_phase("int8"):
            int8_launches, lq = phase_int8(dev, params, prompt, ids, lf, args.profile)
        launches.update({k: v for k, v in int8_launches.items()
                         if k in ("paged_flatten_q", "paged_seq_q")})
        lf = lf.cpu()
        with timed_phase("short"):
            launches.update({k: v for k, v in phase_short(dev, params, args.profile).items()
                             if k in ("flatten_gather", "seq_gather")})
        with timed_phase("batch"):
            batch, batch_runs = phase_batch(dev, params, args.profile)
        launches["ragged_prefill"] = batch["ragged_prefill"]
        # its multi-tree gather steps (bf16 and int8 pools), and B4 at its
        # paged int8 steps
        launches["flatten_gather"] += batch["flatten_gather"]
        launches["paged_flatten_q"] += batch["paged_flatten_q"]
        with timed_phase("workloads"), switched(PER_STEP_CHAIN):
            wl, wl_chained, wl_gathers = phase_workloads(dev, params, prompt, smi,
                                                         args.profile)
            workload_gather_cases(dev, wl_gathers, shapes)
        for k in ("flatten_gather", "seq_gather"):  # their driven gather plans
            launches[k] += wl.get(k, 0)
        with timed_phase("chain"), switched(PER_STEP_CHAIN):
            phase_chain(dev, params, prompt, smi, wl_chained, args.profile)
        with timed_phase("replay"):
            phase_replay(dev, params, prompt, smi)
        del params
        release()
        with timed_phase("int8w"):
            int8w_launches, lw = phase_int8w(dev, prompt, ids, main_runs, smi)
        launches["int8_matmul"] = int8w_launches["int8_matmul"]
        with timed_phase("moe"):
            moe_launches, moe_runs, moe_ref = phase_moe(dev, smi, args.profile)
        launches["gmm"] = moe_launches["gmm"]
        with timed_phase("moe-int8w"):
            launches["gmm_scaled"] = phase_moe_int8w(dev, moe_runs,
                                                     args.profile)["gmm_scaled"]
        with timed_phase("sharded"):
            sharded = phase_sharded(prompt, ids, lf, lq, main_runs, batch_runs)
        launches.update({k: v for k, v in sharded.items() if k in PARTIAL_OF})
        launches["ragged_prefill"] += sharded["ragged_prefill"]  # rank 0's, on its heads
        with timed_phase("sharded-dp"):
            dp_launches = phase_sharded_dp(prompt, ids, lf, lw, main_runs)
        for k, n in dp_launches.items():
            launches[k] = launches.get(k, 0) + n
        with timed_phase("sharded-moe"):
            phase_sharded_moe(moe_ref)
        with timed_phase("timing"):
            timing = phase_timing(dev, shapes)
        # four Gemma-7B ranks of the wide grids need the card
        del shapes
        release()
        with timed_phase("lab"):
            lab_errs, lab_timing, lab_launches = phase_lab(dev, smi)
        errs.update(lab_errs)
        timing.update(lab_timing)
        launches.update(lab_launches)
        with timed_phase("families"):
            launches.update(phase_families(dev, smi))
        idle = [n for n in KERNELS if not launches.get(n)]
        check(not idle, f"kernels no served path launched: {idle}")
        with timed_phase("tracing"):
            phase_tracing(dev)
        if args.profile:
            profile_kv_store(dev)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [dict(name=n, route="cuda", source=f"deft_tpu_torch/csrc/{KERNELS[n][1]}",
                    replaces=KERNELS[n][0], launches=launches[n],
                    max_abs_err=errs[n], ms=timing[n]["ms"],
                    plain_ms=timing[n]["plain_ms"], bound_ms=timing[n]["bound_ms"],
                    bound_by=timing[n]["bound_by"],
                    library_ms=timing[n]["library_ms"])
               for n in KERNELS]
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
