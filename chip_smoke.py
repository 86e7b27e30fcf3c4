"""Drive the PyTorch/CUDA port on one CUDA card: the planner in both
gaits, the repo's benchmarked planner scenarios, Spark/Tez DAG classes,
the multi-tenant solver service, the private-cloud deployment plane, the
TPU capacity planner, the paper's Table 3 and its serving analogue, the LM serving path (dense,
Mamba2, hybrid, MoE, vision and encoder-decoder models, and the two-buffer
decode cache), LM training (granite-3-2b and mamba2-780m at full width
and depth, through the flash and SSD backward kernels), a GPipe pipeline
over granite-3-2b's 40 layers and DiLoCo over mamba2-780m's pods.

    python3 chip_smoke.py

Phases, each printing one line or a few:
  1. the device, the card's name and power limit from nvidia-smi, and the
     matmul settings (TF32 and reduced-precision bf16 reductions off);
  2. build the CUDA kernels from src/repro_torch/csrc (one nvcc process per
     source, all at once); print the registers and spills (ptxas) of the
     qn_event kernels (qn_event_fast's two instances, qn_event_wide's
     eight, qn_event_many's twenty, qn_event_general; it fails without
     any of them), of the DAG's
     two event loops (dag_event_fast's six instances, dag_event_kernel),
     of both draw-table kernels, of each flash_attention instance (the
     float32 wgmma route's split and fa_fwd_parts_kernel among them; it
     fails without them) and of each ssd_scan kernel and of the flash
     backward's wgmma instances, and the flash, flash backward and
     ssd_scan instances' wgmma (HGMMA) and TMA (UTMALDG) instruction
     counts (cuobjdump -sass), and fail if a wgmma kernel (flash's bf16
     and float32 ones, each of the backward's, the SSD scan's) has none
     of either;
  3. hold each kernel against its plain PyTorch version on the card, on
     identical inputs: the draw tables (event_streams) bit-identical in
     both modes; qn_event in exponential and replay mode (padding,
     single-slot and short-budget lanes) at a reduced event budget, both
     kernels (qn_event_fast and, asked for, qn_event_general), and at
     H = 2049 users (qn_event_general in shared memory) and H = 12000
     (its state in a global scratch slice); qn_event_wide at S = 600 and
     8192 (H = 20) and 16384 (H = 32), both modes, caps from 1 to 16384,
     queues backed up by maps of 500, replay lists of a few distinct
     values (tied slot ends), against one plain run each (both timed)
     and against qn_event_general asked for at the same inputs; amva
     at several sizes, both bit-identical; mva (exact MVA) at N = 1 ..
     4097 and H = 0, 1, 4, 5, 25, bit-identical; flash_attention at granite's
     prefill (S = 1024, a ragged 777, and the two serving rounds' prompt
     lengths), gemma3's local window, stablelm's head dim 80, zamba2's
     shared attention (H = KV = 32, head dim 112), a non-causal case, the
     wgmma kernel's edges (head dims 8 and 256, S = 1 and 65, GQA group
     8), and float32 rows (the wgmma route at head dims 8, 64 and 128,
     S = 1 and 65, ragged S, non-causal, GQA group 8 with a window;
     nemotron-4-340b's heads at S = 1024, head dim 192, past its limit,
     on fa_f32_kernel), each float32 row also holding lse against plain
     (1e-4) and printing its share of the tolerance, and each wgmma
     float32 row its split's parts bit for bit, and the prefill
     shapes of both rounds of every serving drive below (qwen2-moe's head
     dim 128, llama4-scout's GQA group 5, phi-3-vision's head dim 96 over
     576 patches and its prompts, whisper's decoder and its encoder's
     non-causal 1500 frames, a ragged last block), within the reference's
     tolerances (2e-2 bf16, 2e-5 f32); ssd_scan at the reference's four
     SSD cases in f32 and bf16, the mamba2 serving rounds' shapes (S = 896
     and 512, 48 heads, N = 128) and zamba2's (112 heads, N = 64), a
     sequence shorter than the chunk, strided inputs and mamba2's shape
     in float32, the bf16 route's edges (chunk 16, S = 40 under the chunk
     of 128, P = 128, N = 16 and 64, S = 8192, dt in bf16) and an
     unaligned view (the parts route, as every float32 row), each twice
     (bit-identical), within the reference's tolerances (5e-2 bf16, 1e-4
     f32), each case on the route its dtypes and layout name (wgmma for
     bf16 x/B/C that TMA can read, else float32);
  4. the planner's main path at real size: the paper's §4.3 scenario
     (TPC-DS Q1 on 250 GB, 10 users, 160 s deadline, m4.xlarge + CINECA,
     JMT-replayer mode) through DSpace4Cloud.run() and .run_fast() at the
     defaults, and the quickstart problem (exponential mode) through
     .run(); the point-wise gait (DSpace4Cloud(batched=False).run(), one
     single-lane qn_event launch per probe and replication) on Q1-10u at
     the defaults (32 launches) and on quickstart, its two classes walked
     in two threads; every decision must equal the reference's, and every
     predicted response time too: exactly in replay mode (Q1-10u), within
     a relative 1e-3 in exponential mode (quickstart).  The point-wise
     simulator's degenerate case (one map, one tiny reduce, one slot: a
     single-station closed network) through the scalar simulate() and
     through response_time_batch, each within 0.08 of exact MVA on the mva
     kernel (itself held bit-identical to its plain version there).  A
     small replay problem is also planned on the card and on the CPU
     (plain versions): decisions and response times must be equal;
  5. the serving path at full width and depth with seeded random weights,
     BatchingEngine(max_batch=4, greedy) serving 8 requests of 32
     generated tokens in 2 rounds: granite-3-2b (40 layers; prompts of
     256-1024 tokens; 80 flash launches), mamba2-780m (48 Mamba2 layers;
     prompts of 128 x 2..8 tokens, since a Mamba2 prefill length must be a
     multiple of the SSD chunk; 96 ssd_scan launches and no other) and
     zamba2-7b (81 layers, 27 x (2 Mamba2 + 1 shared attention); the same
     prompts; 108 ssd_scan and 54 flash launches; every ssd_scan launch on
     its wgmma route), qwen2-moe-a2.7b (24 MoE layers of 60 experts
     top-4 and a shared expert, 14.0 B parameters; 48 flash launches),
     llama4-scout-17b-a16e (full width, its depth cut to 8 of 48 layers:
     213.5 GB in bf16 whole; 16 flash launches), whisper-tiny (4 encoder
     + 4 decoder layers over 1500 zero frames; prompts of 4..32 tokens,
     128 generated; 16 flash launches) and phi-3-vision-4.2b (32 layers,
     576 zero patches before granite's prompts; 64 flash launches); each
     model's weights are drawn on the card straight into its working
     dtypes (bf16, norms and the MoE router f32), with the drive's peak
     memory printed; each is profiled (device busy share, launches per
     layer, the kernels' share of the prefill's device time, and for an
     MoE model its router, dispatch, experts and combine) and then
     compared with the CPU at depth 2 (granite, mamba2, qwen2-moe,
     phi-3-vision), 3 (zamba2, one group), 1 (llama4-scout, its
     vocabulary cut to 8192 tokens) or 2 + 2 (whisper) with the same
     weights and prompts, whose logits must agree
     (a model with a front end also on random frames or patches; a step
     whose MoE routing differs at a near tie of the CPU's gates is printed
     and not compared); then granite-3-2b's two-buffer decode at full
     width and depth (TWO_BUFFER: two prompts of 1024 tokens prefilled,
     40 flash launches, the caches copied into an init_caches(recent_len=
     32) layout, 32 greedy tokens decoded on the single ring and on the
     two buffers: the logits within the reference's 5e-2, the tokens
     equal, the main buffers bitwise unchanged, ms per decode step of
     each);
  6. qn_event held bit-identical to its plain version at every dispatch
     shape of the Q1-10u drives (the batched run's B = 32 lanes and the
     point-wise walk's single lanes), both kernels, the depth cut to 16384
     events (every lane completes jobs past the warm-up), and the draw
     tables at those shapes at full depth; each kernel's time at the main
     path's shapes (CUDA events, after a warm-up; qn_event (and
     qn_event_general asked for at the same shapes, and alone at H = 2049
     and 12000) and the draw tables at B = 32 and B = 1, beside the
     figures of the kernel they replaced; qn_event_wide against
     qn_event_general in turns at cost_deadline's probe shape past 512
     slots (Q1, cap 8000 of 8192 slots, 37725 active events, H = 10 and
     20), with its bound and its step's collective floor; qn_event_many
     against qn_event_general in turns at H = 64 (64 slots) and 2048 (384
     slots), 16384 events, with its collective floor; mva at N = 4097,
     H = 25 and
     at the degenerate case's N = 1,
     H = 5; for mva and flash_attention also the kernel's own device time
     from torch.profiler), its bound, its plain version's time and, for
     flash_attention, the time of torch's scaled_dot_product_attention on
     the same tensors (a yardstick only: the port never calls it), at
     granite's and zamba2's prefill shapes and at qwen2-moe's, llama4-
     scout's, whisper's encoder's and phi-3-vision's (FLASH_TIMES);
     ssd_scan's wgmma route at mamba2's and zamba2's prefill shapes (and
     its device time alone), each beside its bound; amva's device time alone and its share of a
     run_fast plan's wall;
  7. (after phase 4) [scenarios] the repo's public-cloud planner
     benchmarks at their own budgets (benchmarks/torch_scenarios.py):
     batched_qn (an 8-point frontier scalar against batched, the
     optimizer point-wise, batched and run_fast), cost_deadline (Figures
     5-7 on the reference's quick grids: initial solution, the amva
     frontier, Algorithm 1 on the point-wise evaluator; every qn_event
     launch past 512 slots on qn_event_wide, none on qn_event_general;
     the launches by route printed beside those before the slot cut),
     hc_convergence
     (race=False in three gaits) and vm_race (a four-type catalog locked
     against raced, lower-bound pruning, mixed fusion groups, per-lane
     parity, the one-type catalog's degenerate race); every decision,
     dispatch count, pruned lane and crossover must equal the reference's,
     every replay-mode response time exactly and an exponential-mode one
     within a relative 1e-3; each scenario's wall is taken without the
     profiler, then a second, profiled drive gives each kernel's device
     time (not measured where the profiler saw fewer launches than the
     wrapper counted);
  8. (after phase 7) [table3] the paper's Table 3: per row T from the
     host's cluster simulator and tau from the scalar QN on the card (up
     to 524288 events a lane), each equal to the reference's; per row the
     event budget, the event-loop kernel that ran (as qn_event counts the
     library's report of it), launches, host ms and, from a second,
     profiled drive, device ms; mean and max |theta| beside the paper's
     12.27% / 30.59%; phase 3 holds one lane of its largest row against
     the plain version with the budget cut;
  9. (after phase 5) [serving-qn] the serving analogue: tau at the
     reference's fixed round times, equal to its tau; then profiled
     rounds, tau and the engine's closed-loop T at granite-3-2b's smoke
     config and at its full width and depth (40 layers), theta beside the
     paper's +-30% (recorded, not gated).
 10. [dag] (phase 3) dag_streams held torch.equal to its plain version
     and dag_event bit-identical to its own on both routes (dag_event_fast,
     and dag_event_kernel asked for; past the fast route's limits
     dag_event_kernel alone) against one plain run of each check, in both
     modes, at E = 4096: chains of 1..4 stages in one batch padded to the
     stage bucket, padding, single-slot and short-budget lanes, H = 1, 3,
     32 (S = 512; in replay mode tie-heavy, one repeated sample) and 2049,
     and 32768 slots (the lane's state in a global scratch slice), every
     lane with a budget finishing jobs past its warm-up; (after phase 8)
     benchmarks/dag_sweep.py at its own budgets (the 16-point frontier
     scalar against batched, 16 -> 1 dispatches, bit for bit; the
     optimizer point-wise and batched) and the solo part of
     examples/spark_dag_plan.py (run() in both gaits, run_fast()), each
     decision, dispatch count and flag equal to the reference's and each
     response time within a relative 1e-3 (exponential mode), every
     dag_event launch on the route ops.route names for its shape
     (dag_event_fast), timed without the profiler and then profiled;
     (phase 6) the step's collectives alone (a redux, a ballot with
     __ffs, a shuffle) and from them dag_event_fast's step floor; both
     routes timed in turns at dag_sweep's frontier shape (B = 16,
     E = 8192, K = 4, H = 3, 128 slots; against the plain version once
     more) and at E = 16384, with bounds, and amva's and mva's
     dependent-chain bounds from one thread's long launch against a
     short one.
 11. [service] (after the DAG drives) the multi-tenant SolverService on
     the card, each drive through benchmarks/torch_scenarios.py with the
     launch counts set to 0 before it: service_throughput at its full
     size (eight tenants solo, then in one service: 8 -> 1 dispatches,
     every job bit-identical to its solo run; a fresh service on the
     cache spill: 0 dispatches and 0 launches, hit rate 1.0; the live
     service scraped over HTTP on localhost, /statz's per-tenant split
     equal to the scheduler's totals, /metrics parsed; traced, its span
     chain reaching kernel:cuda under service.run through
     fused_dispatch), examples/serve_many.py's five tenants (one a JSON
     submission), examples/spark_dag_plan.py's service half (one
     qn_event and one dag_event launch a round of each kind, the repeat
     job folded into the same lanes, decisions equal to the solo run's)
     and four tenants planning the §4.3 scenario (TPC-DS Q1 on 250 GB,
     10 users, 131072-event replay lanes) at deadlines 300, 200, 160 and
     130 s in one service (window 16), each job bit-identical to its solo
     run; every decision, state, round, dispatch and point count, cache
     and admission stat and per-tenant split equal to REFERENCE["service"]
     (exact in replay mode, response times within a relative 1e-3 in
     exponential mode); the launches by phase and route, each drive's
     wall, service.round_ms's mean and largest round; serve_many and the
     Q1 service once more under the profiler (each kernel's device ms
     against the service's wall).
 12. [cloud] (after [service]) the private-cloud plane on the card
     through benchmarks/torch_scenarios.py, each drive with the launch
     counts set to 0 before it: benchmarks/private_cloud.py at its full
     size (three classes on roomy and dense; the over-committed cluster
     of about half the public plan's cores coordinated by run(); an
     unbounded cluster whose run_fast() must equal the public one bit
     for bit; the 24-window day, and the same day on the over-committed
     cluster, windows_feasible from the card), then the paper's §4.3
     classes Q1 (160 s) and Q3 (220 s) in one problem (TPC-DS 250 GB,
     131072-event replay lanes, m4.xlarge + CINECA) on 20-core hosts
     holding about half the public plan's cores, through run(),
     run_fast() and the point-wise run(), and as a private job in a
     SolverService beside a public Q1 tenant, admitted against the
     cluster's cores (the job equal to its solo run bit for bit); every
     decision, deployment summary, assignment, dispatch and round count
     equal to REFERENCE["cloud"] (exact in replay mode, response times
     within a relative 1e-3 in exponential mode); every packing the
     drives checked on the card (each feasibility_batch call recorded)
     equal to the check's CPU version; the launches by kernel and route,
     each plan's wall, and for the over-committed day and the real-size
     private run() the host's packers and checks against the kernels'
     device time (a profiled pass).
 14. [capacity] (after [cloud]) the TPU capacity planner on the card
     (benchmarks/torch_scenarios.py capacity, the launch counts set to 0
     before it): tests/test_capacity.py's synthetic costs; five serving
     classes (its two granite-3-2b classes of 32 and 256 sessions,
     examples/capacity_planning.py's chat class, the same traffic on
     mamba2-780m, 57209 slots a v5e-16, and a 2048-session crowd that
     leaves v5e-16) planned by the KKT ranking alone and QN-verified (one
     qn_event dispatch a probe, its slots cut to those its users can
     fill: qn_event_fast for 32 users, qn_event_many past 32); the
     training plans at 24 and 12 h; a synthetic dry-run record through
     load_dryrun, ElasticPlan.replan_capacity and the plan CLI; every
     number equal to REFERENCE["capacity"] (the QN plans' predicted_ms
     within a relative 1e-3), each dispatch's route (CAPACITY_ROUTES,
     printed beside the routes before the cut), each plan's wall, a
     profiled pass (the kernels' device ms, qn_event_many's launches x
     (time - bound)); each qn_event_many lane's draw tables and event
     loop held bit-identical to their plain versions on the uncut lane
     and to qn_event_general asked for, and timed in turns against
     qn_event_general on the cut and the uncut lane beside its bound
     (its collective floor in [time]); then launch/qn_record's quick cells on the
     card, the plain and CUDA versions bit-identical, and their roofline
     rows.  Phase 6 also times the float32 forward at granite-3-2b's
     heads (B = 4, S = 1024): the wgmma route's call, its split and
     fa_fwd_parts_kernel alone and on the device, and fa_f32_kernel on
     the same inputs, in turns, beside the function's float32 bound, the
     parts terms' and the split's bounds, the plain versions and SDPA in
     float32; ssd_scan in float32 at mamba2's prefill shape (B = 4, S =
     1024, SSD_F32_TIME): the parts route's call, its split and its four
     kernels alone and each on the device, and ssd_f32_kernel on the same
     inputs, in turns, beside the function's float32 bound, the parts
     terms' and the split's bounds and the plain versions; and
     fa_f32_kernel and the SIMT flash backward at nemotron-4-340b's heads
     in float32 (FA_F32_WIDE_TIME) beside SDPA's float32 forward and
     backward.
 13. [train] (after phase 6) the flash backward's two routes (wgmma:
     for bf16 at head dim <= 128 its pair, fa_bwd_dq_wgmma, which writes
     delta, then fa_bwd_dkdv_wgmma; for bf16 past 128 and float32 up to
     128 its parts kernels, fa_bwd_prep, fa_bwd_dq_parts,
     fa_bwd_dkdv_parts; simt: fa_bwd_delta, fa_bwd_dkdv, fa_bwd_dq), and
     the forward's lse from both routes, held against their plain
     versions at granite-3-2b's training shape (B = 8, S = 1024, H = 32,
     KV = 8, head dim 64, bf16, causal), gemma3-27b's local window,
     llama4-scout's GQA group 5 at head dim 128, zamba2's head dim 112,
     whisper's non-causal encoder, nemotron-4-340b's training attention
     (B = 1, S = 4096, H = 96, KV = 8, head dim 192, bf16), the training
     shape's heads and the four other shapes in float32, nemotron's
     heads at S = 1024 in float32 and the float32 step's own attention
     (B = 2, S = 256) (FA_BWD_CHECKS: each wgmma row on its
     kernels and on the simt route, the route's delta against the einsum
     and two of its calls bit for bit; the float32 Dh 192 row on simt),
     within 2e-2 (bf16) and 1e-4 (f32), each printing its share of the
     tolerance; the pair timed at the training shape, the parts kernels,
     the simt kernels and SDPA's backward at the float32 check row and at
     nemotron's shape, each beside its bound, the plain version and
     torch's SDPA backward (a yardstick; for the delta kernels the einsum
     that computes delta); the SSD backward's two
     routes (wgmma: csrc/ssd_scan_bwd_wgmma.cuh, five kernels on TMA and
     wgmma behind ssd_bwd for bf16 x, B, C and dy; simt:
     csrc/ssd_scan_bwd.cu, six kernels, float32 and other layouts) against
     ref.ssd_bwd at mamba2-780m's and zamba2-7b's training shapes, in
     float32, under the chunk, at 8 chunks with a nonzero dstate, at P = N
     = 128 in both dtypes, at chunks of 64 and 32 and on strided views
     (SSD_BWD_CHECKS; every bf16 row on both routes), within 1e-4 of each
     output's largest magnitude (and one bf16 step of a bf16 output), two
     calls bit for bit, and both routes timed in turns at both training
     shapes with each kernel's device ms beside the bound, PR 28's times
     and the plain version ([build] fails unless each of the wgmma route's
     instances shows HGMMA and UTMALDG in the SASS); then granite-3-2b and
     mamba2-780m trained at
     full width and depth through Trainer (B = 8, S = 1024, 4 steps, the
     fp32 AdamW, remat on): each step's loss, grad norm and wall, the
     peak memory, the launches a step (granite: 80 flash forward under
     remat, 40 of each wgmma backward kernel and none of the simt
     route's; mamba2: 96 ssd_scan forwards, 48 SSD backwards, all on the
     wgmma route, and no flash), one more step profiled (the backwards' shares of the device
     time), the model FLOP/s against 989 TFLOP/s; at full width and a
     cut depth (granite and mamba2 2, zamba2 3: the SSD and the flash
     backward in one model), one step on the card against the CPU (loss,
     grad norm, every gradient leaf, the update), and for granite a
     restart from a checkpoint on the card against the uninterrupted
     run; granite and mamba2 at depth 2 in float32 (TRAIN_F32_ARCHS):
     one Trainer step each on the card with its launches counted by
     kernel and route (granite: 4 forwards, each a fa_fwd_split and a
     fa_fwd_parts_kernel launch, none of fa_f32_kernel, 2 of each flash
     parts kernel, none of the simt route's; mamba2: 4 ssd_scan forwards
     on the parts route, each after an ssd_split, none of
     ssd_f32_kernel, 2 SSD backwards on the SIMT route), then each step
     against the CPU's within TRAIN_F32_TOL.
 15. [distributed] (after [train]) GPipe over granite-3-2b's 40 layers at
     full width (PIPELINE: 4 stages of 10 layer groups stacked with
     stack_stage_params, 8 microbatches of 1 x 1024 tokens in bf16, the
     embedding before stage 0 and the final norm and logits after the
     last stage): 11 ticks, bubble fraction 3/11, 440 flash launches; the
     output bit-identical to the same stage function applied stage after
     stage to each microbatch, microbatch 0's logits equal to the model's
     own forward; then DiLoCo over mamba2-780m at full width and depth
     (DILOCO: 2 pods fed the Zipf stream from seeds 10 and 11, 2 inner
     steps of B = 8, S = 1024 a round with [train]'s settings, 2 rounds;
     768 ssd_scan and 384 SSD backward launches, all on the wgmma route):
     each round's loss and wall, the pods bit-identical to the anchor
     after every re-sync, the last outer update within one float32 ulp of
     its formula in float64 on DILOCO_CHECK_LEAVES, the peak memory.
Each phase prints its seconds ([phase]).  Each drive of a main path sets the kernels' launch counts to 0 just before
it and reads them just after.  The second-to-last line is the kernels'
JSON record, the last line {"ok": true, "device": {...}}.  Any failure
exits nonzero before it.  Needs one CUDA card, nvcc, and the repository's
src/ and benchmarks/ beside this file.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # non-tensor float32, H100 SXM data sheet
# one non-tensor instruction per lane per clock: the float32 rate above
# counts an FMA as two operations; a compare or a max is one instruction
H100_INSTR_PER_S = H100_FP32_OPS_PER_S / 2
# 32-bit integer adds, shifts and logic: Hopper's SM has 64 INT32 lanes
# against its 128 float32 lanes, so half the rate above
H100_INT32_OPS_PER_S = H100_INSTR_PER_S / 2
H100_BF16_OPS_PER_S = 989e12    # dense tensor cores, H100 SXM data sheet
# the reference's own tolerances (tests/test_kernels.py).  The plain
# version computes in float32; the bf16 kernel rounds P to bf16 for its
# P.V product (relative 2^-9 on weights that sum to one) and rounds the
# output, both well inside 2e-2.  The float32 kernel computes in float32
# throughout, so its cases at 2e-5 are the ones that would see a key tile
# dropped from a row's band
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the reference's (tests/test_kernels.py), on y and on the final state
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the largest share of the float32 tolerance, tol + tol |want|, that the
# SSD scan's parts route may take on float32 inputs (y and the final
# state): the aim its bf16 terms were chosen by (tests/test_torch_ssd_f32.py)
SSD_F32_AIM = 0.5
# card vs CPU logits at depth 2 (3 for zamba2, 1 for llama4-scout), full
# width: the logits are bf16, and cuBLAS and the CPU's GEMMs sum in other
# orders, so a logit may round to the neighbouring bf16 value.  Measured
# on an NVIDIA H100 80GB HBM3 (700 W), with the comparisons' weights drawn
# on the card: granite 1.56e-2, mamba2 7.8e-3, qwen2-moe 1.06e-2, llama4
# 7.8e-3, whisper 2.9e-3, and zamba2 and phi-3-vision 3.125e-2, on the
# tolerance.  Each of those maxima is one rounding (one bf16 ulp) of a
# single logit: of one in [4, 8), whose ulp is 0.03125, for zamba2 and
# phi-3-vision.  One rounding of a logit of 8 or more would differ by
# 0.0625; serve_card_vs_cpu prints where its largest difference sits and
# the largest logit it compared
CARD_CPU_TOL = 0.03125
# (arch, launches each kernel must show over the 8-request drive, the
# drive's cut of the config ({}: full width and depth), the card-vs-CPU
# comparison's cut); a kernel not named must show none.  llama4-scout's
# 48 layers hold 213.5 GB in bf16, so its drive keeps 8 (37.4 GB); its
# comparison (top-1 routing at capacity factor 1.25 beside a shared
# expert) keeps one layer and 8192 of the 202048 tokens of its
# vocabulary: the CPU's pass over the whole vocabulary took 56 s
SERVE_CASES = [
    ("granite-3-2b", {"flash_attention": 80}, {}, {"n_layers": 2}),
    ("mamba2-780m", {"ssd_scan": 96}, {}, {"n_layers": 2}),
    ("zamba2-7b", {"ssd_scan": 108, "flash_attention": 54}, {},
     {"n_layers": 3}),
    ("qwen2-moe-a2.7b", {"flash_attention": 48}, {}, {"n_layers": 2}),
    ("llama4-scout-17b-a16e", {"flash_attention": 16}, {"n_layers": 8},
     {"n_layers": 1, "vocab_size": 8192}),
    ("whisper-tiny", {"flash_attention": 16}, {},
     {"n_layers": 2, "n_enc_layers": 2}),
    ("phi-3-vision-4.2b", {"flash_attention": 64}, {}, {"n_layers": 2}),
]
# sizes of the mva check: the reference's kernel test (tests/test_kernels.py)
# and the degenerate case's H = 5 below; H = 0 returns the demand
MVA_NS = (1, 7, 128, 1000, 1024, 4096, 4097)
MVA_HS = (0, 1, 4, 5, 25)
# the point-wise simulator's degenerate case (tests/test_qn_sim.py and
# tests/test_batched_qn.py of the reference): one map of 1000 ms, one
# reduce of 1 ms, one slot, 5 users thinking 10 s: a single-station closed
# network of demand 1001 ms, whose exact MVA response both simulations
# must meet within the reference's own 0.08
DEGENERATE = dict(n_map=1, n_reduce=1, m_avg=1000.0, r_avg=1.0,
                  think_ms=10_000.0, h_users=5)
DEGENERATE_TOL = 0.08
# Table 3's row with the largest event budget (1560 maps, 1009 reduces:
# 524288 events a lane) and the cut budget of its kernel-vs-plain check
T3_ROW = 10
E_T3 = 6144
# the event loop's and the draw tables' times before this kernel design,
# and the Q1-10u plan walls they gave (chip_smoke.py on an NVIDIA H100
# 80GB HBM3 at 700 W; PERF.md), printed beside this run's in the [time]
# lines only (the kernels line holds this run's measurements)
QN_BEFORE = {"qn_event_b32_ms": 115.261, "qn_event_b1_ms": 103.359,
             "event_streams_b32_ms": 41.252, "event_streams_b1_ms": 19.160,
             "run_s": 0.305, "run_pointwise_s": 4.004}
# qn_event_wide's checks against the plain version (and against
# qn_event_general asked for at the same inputs): (H, max_slots, E, modes,
# caps, n_map, n_reduce).  H = 20 as cost_deadline's fig7 at S = 600 and
# 8192, H = 32 at the route's limit of 16384 slots; maps of 500 on the
# small caps back the queue up (each completion then takes the dispatch
# after it), and on the large caps the busy slots span many threads'
# blocks (a cap of 600 or 2000 spreads its slots over all 32 threads, a
# cap of 16384 fills thread 0's 32 groups first).  Every lane must finish
# jobs past the warm-up within the cut budget E (the S = 8192 check's
# 12288 events keep its two plain runs to ~17 s each on an H100's host,
# against ~27 s at 16384; its slowest lane, a cap of 600 under maps of
# 500 with 8 reduces, finishes 3 jobs there in exponential mode, none at
# 8192)
WIDE_CHECKS = [
    (20, 600, 8192, (False, True), [1, 17, 300, 600, 599],
     [500, 500, 500, 64, 120], [1, 1, 8, 1, 4]),
    (20, 8192, 12288, (False, True), [1, 17, 600, 8000, 4000, 8192],
     [500, 500, 500, 64, 120, 32], [1, 1, 8, 1, 16, 4]),
    (32, 16384, 8192, (False, True), [1, 16384, 9000, 600, 2000],
     [500, 32, 64, 200, 64], [1, 1, 2, 1, 8]),
]
WIDE_WARMUP = 1
# qn_event_fast's instances (one a mode) and qn_event_wide's (its groups
# of 16 slots a thread, as the batch's slots need, and the mode)
QN_INSTANCES = [f"qn_event_fast<{m}>" for m in ("false", "true")] + [
    f"qn_event_wide<{g}, {m}>" for g in (4, 8, 16, 32)
    for m in ("false", "true")] + [
    f"qn_event_many<{g}, {ug}, {m}>" for g in (0, 4, 8, 16, 32)
    for ug in (1, 4) for m in ("false", "true")]
# cost_deadline's probe shape past 512 slots (Q1: 500 maps, 1 reduce, 10 s
# think; cap 8000 in a batch of 8192 slots, 65536 events of which 37725
# active, Q1's events_needed), timed for qn_event_wide against
# qn_event_general at H = 10 (figures 5-6) and 20 (figure 7).  Since the
# slot cut (core/qn_sim.py slots_in_use) a probe of 10 users runs at most
# 5000 of them; the kernels are timed on this lane as given
WIDE_TIME = dict(cap=8000, max_slots=8192, n_events=65536, active=37725)
# qn_event_many against qn_event_general at the capacity planner's widths,
# deeper than its 512 events: (H, slots, think ms), one map and one reduce
# a job, exponential mode
MANY_TIME = [(64, 64, 150.0), (2048, 384, 330.0)]
MANY_TIME_E = 16384
# the routes before the slot cut (this script's run on the tree before
# it): the capacity drive's dispatches in order and cost_deadline's
# launches by route
ROUTES_BEFORE_CUT = {
    "capacity": ("qn_event_wide",) + ("qn_event_general",) * 5,
    "cost_deadline": {"qn_event_general": 0, "qn_event_fast": 102,
                      "qn_event_wide": 1155}}


def wide_lanes(dev, caps, n_map, n_reduce, E, H, replay):
    """The lanes, seeds and draw tables of one qn_event_wide check, drawn
    from their own generator (exponential-mode means, think times; in
    replay mode lists of a few distinct values, so that slot ends tie)."""
    gen = np.random.default_rng(len(caps) + H + E)
    B = len(caps)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    lanes = (i32(n_map), i32(n_reduce), i32(caps), i32([E] * B),
             f32(gen.uniform(20, 60, B)), f32(gen.uniform(10, 30, B)),
             f32(gen.uniform(100, 1000, B)))
    seeds = torch.tensor(1000 * np.arange(B) + 1, dtype=torch.int64,
                         device=dev)
    smp = (f32(20.0 * gen.integers(1, 4, 29)),
           f32(10.0 * gen.integers(1, 3, 7))) if replay else (None, None)
    return lanes, seeds, smp


def plain_in_one_run(qn_ref, checks, warmup_jobs, replay):
    """The plain event loop over the lanes of several checks at once:
    ``checks`` is a list of (qn_event's positional tensors, max_slots).  A
    lane's result depends neither on the other lanes nor on slots past its
    cap, and a lane stops at its own event budget, so one run at the
    widest check's slots, the shorter checks' draw tables padded to the
    longest, gives each check its own lanes' results; the plain loop costs
    ~2 ms an event whatever the lanes.  Returns ((sums, counts) a check,
    the run's ms, its shape)."""
    S_max = max(s for _, s in checks)
    E_max = max(a[8].shape[1] for a, _ in checks)        # st_m: (B, E)
    args = tuple(torch.cat([
        torch.nn.functional.pad(a[j], (0, E_max - a[j].shape[1])) if j > 7
        else a[j] for a, _ in checks]) for j in range(len(checks[0][0])))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, pc = qn_ref.qn_event(*args, max_slots=S_max, warmup_jobs=warmup_jobs,
                             replay=replay)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out, off = [], 0
    for a, _ in checks:
        out.append((ps[off:off + len(a[0])], pc[off:off + len(a[0])]))
        off += len(a[0])
    return out, ms, f"B={off} E={E_max} S={S_max} H={args[7].shape[1]}"


# the integer-pipe instructions a threefry2x32 needs: its 20 rounds'
# rotates (funnel shifts, SHF) and xors (LOP3), the key schedule's xor
# (one three-input LOP3) and the output xor: 20 + 20 + 1 + 1.  Its adds
# (in the rounds and the key injections) issue mostly as IMAD on the FMA
# pipe beside them (the [build] line counts the kernel's SASS), so they
# are not counted against the integer pipe
THREEFRY_INT32_OPS = 42
# the draw tables' threefry calls: per event 4 (exponential mode: key_i,
# its bits, the think key, its bits) or 7 (replay mode: key_i, the two
# halves of split(key_i), their bits, the think key and its bits); per
# lane split(key); per user its bits
THREEFRY_PER_EVENT = {False: 4, True: 7}
# the QN event loop's kernels (qn_event's routes, kernels/qn_event/ops.py
# ROUTES), as the profiler names them
QN_ROUTE_KERNELS = ("qn_event_fast", "qn_event_wide", "qn_event_many",
                    "qn_event_general")
# the device kernels' names (every route's), for their share of a
# profiled prefill; a kernel's share counts every launch whose name holds
# one of them
DEVICE_KERNELS = {"flash_attention": ("fa_wgmma_kernel", "fa_fwd_parts_kernel",
                                      "fa_fwd_split_kernel", "fa_f32_kernel"),
                  "ssd_scan": ("ssd_wgmma_kernel", "ssd_parts_",
                               "ssd_f32_kernel")}

# Decisions and numbers of the JAX reference (src/repro) for the same calls
# and scenarios, printed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m benchmarks.port_reference_decisions
# on a CPU host (JAX 0.9.0).
REFERENCE = {'Q1-10u.run': {'qn_dispatches': 2,
  'classes': {'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
              'cost_per_h': 7.0, 'predicted_ms': 158747.29693983402,
              'feasible': True}}},
 'Q1-10u.run_fast': {'qn_dispatches': 2,
  'classes': {'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
              'cost_per_h': 7.0, 'predicted_ms': 158747.29693983402,
              'feasible': True}}},
 'quickstart.run': {'qn_dispatches': 2,
  'classes': {'bi-dashboards': {'vm_type': 'm4.xlarge', 'nu': 5, 'reserved': 4, 'spot': 1,
                     'cost_per_h': 0.95, 'predicted_ms': 49770.77734375,
                     'feasible': True},
   'nightly-etl': {'vm_type': 'm4.xlarge', 'nu': 2, 'reserved': 1, 'spot': 1,
                   'cost_per_h': 0.29000000000000004,
                   'predicted_ms': 409866.53125, 'feasible': True}}},
 'Q1-10u.run_pointwise': {'qn_dispatches': 32,
  'classes': {'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
              'cost_per_h': 7.0, 'predicted_ms': 158747.29693983402,
              'feasible': True}}},
 'quickstart.run_pointwise': {'qn_dispatches': 4,
  'classes': {'bi-dashboards': {'vm_type': 'm4.xlarge', 'nu': 5, 'reserved': 4, 'spot': 1,
                     'cost_per_h': 0.95, 'predicted_ms': 49770.77734375,
                     'feasible': True},
   'nightly-etl': {'vm_type': 'm4.xlarge', 'nu': 2, 'reserved': 1, 'spot': 1,
                   'cost_per_h': 0.29000000000000004,
                   'predicted_ms': 409866.53125, 'feasible': True}}},
 'batched_qn': {'frontier': {'points': 8,
   'scalar_ms': [3269627.5, 2177950.75, 1630223.125, 1301342.25, 1086250.25,
                 928012.5625, 812556.875, 719421.0625],
   'batched_ms': [3269627.5, 2177950.75, 1630223.125, 1301342.25, 1086250.25,
                  928012.5625, 812556.875, 719421.0625],
   'scalar_dispatches': 8,
   'batched_dispatches': 1,
   'parity_max_rel_err': 0.0},
  'optimizer': {'scalar': {'evals': 16,
    'dispatches': 16,
    'cost': 7.0,
    'nu': {'Q1-10u': 40},
    'classes': {'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
                'cost_per_h': 7.0, 'predicted_ms': 157892.640625,
                'feasible': True}}},
   'batched': {'evals': 31,
    'dispatches': 2,
    'cost': 7.0,
    'nu': {'Q1-10u': 40},
    'classes': {'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
                'cost_per_h': 7.0, 'predicted_ms': 157892.640625,
                'feasible': True}}},
   'fast_batched': {'evals': 31,
    'dispatches': 2,
    'cost': 7.0,
    'nu': {'Q1-10u': 40},
    'classes': {'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
                'cost_per_h': 7.0, 'predicted_ms': 157892.640625,
                'feasible': True}}}},
  'dispatch_ratio': 8.0},
 'cost_deadline': {'fig5': [{'deadline_s': 300, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 22,
    'cost_per_h': 3.94, 'reserved': 16, 'spot': 6, 'T_s': 293.001375},
   {'deadline_s': 300, 'vm': 'CINECA', 'feasible': True, 'nu': 7,
    'cost_per_h': 5.2, 'reserved': 5, 'spot': 2, 'T_s': 274.328125},
   {'deadline_s': 200, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 32,
    'cost_per_h': 5.6899999999999995, 'reserved': 23, 'spot': 9,
    'T_s': 197.4996875},
   {'deadline_s': 200, 'vm': 'CINECA', 'feasible': True, 'nu': 10,
    'cost_per_h': 7.35, 'reserved': 7, 'spot': 3, 'T_s': 189.62896875},
   {'deadline_s': 130, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 49,
    'cost_per_h': 8.68, 'reserved': 35, 'spot': 14, 'T_s': 125.5866015625},
   {'deadline_s': 130, 'vm': 'CINECA', 'feasible': True, 'nu': 15,
    'cost_per_h': 11.3, 'reserved': 11, 'spot': 4, 'T_s': 121.1645625}],
  'fig6': [{'deadline_s': 420, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 27,
    'cost_per_h': 4.74, 'reserved': 19, 'spot': 8, 'T_s': 417.74159375},
   {'deadline_s': 420, 'vm': 'CINECA', 'feasible': True, 'nu': 8,
    'cost_per_h': 6.1000000000000005, 'reserved': 6, 'spot': 2,
    'T_s': 417.98990625},
   {'deadline_s': 270, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 42,
    'cost_per_h': 7.4399999999999995, 'reserved': 30, 'spot': 12,
    'T_s': 261.123109375},
   {'deadline_s': 270, 'vm': 'CINECA', 'feasible': True, 'nu': 13,
    'cost_per_h': 10.05, 'reserved': 10, 'spot': 3, 'T_s': 254.03603125},
   {'deadline_s': 180, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 63,
    'cost_per_h': 11.16, 'reserved': 45, 'spot': 18, 'T_s': 174.83071875},
   {'deadline_s': 180, 'vm': 'CINECA', 'feasible': True, 'nu': 18,
    'cost_per_h': 13.450000000000001, 'reserved': 13, 'spot': 5,
    'T_s': 177.694078125}],
  'fig7': [{'deadline_s': 300, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 43,
    'cost_per_h': 7.66, 'reserved': 31, 'spot': 12, 'T_s': 294.5915625},
   {'deadline_s': 300, 'vm': 'CINECA', 'feasible': True, 'nu': 13,
    'cost_per_h': 10.05, 'reserved': 10, 'spot': 3, 'T_s': 287.3035},
   {'deadline_s': 200, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 64,
    'cost_per_h': 11.23, 'reserved': 45, 'spot': 19, 'T_s': 197.588328125},
   {'deadline_s': 200, 'vm': 'CINECA', 'feasible': True, 'nu': 19,
    'cost_per_h': 14.35, 'reserved': 14, 'spot': 5, 'T_s': 195.767828125},
   {'deadline_s': 130, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 96,
    'cost_per_h': 16.92, 'reserved': 68, 'spot': 28, 'T_s': 127.3591015625},
   {'deadline_s': 130, 'vm': 'CINECA', 'feasible': True, 'nu': 28,
    'cost_per_h': 20.8, 'reserved': 20, 'spot': 8, 'T_s': 126.5567265625},
   {'deadline_s': 95, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 132,
    'cost_per_h': 23.19, 'reserved': 93, 'spot': 39, 'T_s': 93.36471875},
   {'deadline_s': 95, 'vm': 'CINECA', 'feasible': True, 'nu': 39,
    'cost_per_h': 29.049999999999997, 'reserved': 28, 'spot': 11,
    'T_s': 92.258734375},
   {'deadline_s': 75, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 170,
    'cost_per_h': 29.75, 'reserved': 119, 'spot': 51, 'T_s': 74.7521171875},
   {'deadline_s': 75, 'vm': 'CINECA', 'feasible': True, 'nu': 49,
    'cost_per_h': 36.4, 'reserved': 35, 'spot': 14, 'T_s': 71.8184375},
   {'deadline_s': 62, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 203,
    'cost_per_h': 35.660000000000004, 'reserved': 143, 'spot': 60,
    'T_s': 59.99526171875},
   {'deadline_s': 62, 'vm': 'CINECA', 'feasible': True, 'nu': 57,
    'cost_per_h': 41.95, 'reserved': 40, 'spot': 17, 'T_s': 61.94483984375},
   {'deadline_s': 50, 'vm': 'm4.xlarge', 'feasible': True, 'nu': 728,
    'cost_per_h': 127.46000000000001, 'reserved': 510, 'spot': 218,
    'T_s': 48.29650390625},
   {'deadline_s': 50, 'vm': 'CINECA', 'feasible': True, 'nu': 71,
    'cost_per_h': 52.35, 'reserved': 50, 'spot': 21, 'T_s': 48.53174609375}],
  'summary': {'fig5': {'query': 'Q1', 'users': 10, 'points': 6,
            'crossover_deadline_s': None, 'mono_cost': True, 'dispatches': 53},
   'fig6': {'query': 'Q3', 'users': 10, 'points': 6,
            'crossover_deadline_s': None, 'mono_cost': True, 'dispatches': 52},
   'fig7': {'query': 'Q1', 'users': 20, 'points': 14,
            'crossover_deadline_s': 50, 'mono_cost': True, 'dispatches': 1152}}},
 'hc_convergence': {'classic': {'evals': 16,
   'dispatches': 16,
   'cost': 7.0,
   'nu': {'Q1-10u': 40},
   'classes': {'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
               'cost_per_h': 7.0, 'predicted_ms': 157892.640625,
               'feasible': True}}},
  'batched': {'evals': 16,
   'dispatches': 1,
   'cost': 7.0,
   'nu': {'Q1-10u': 40},
   'classes': {'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
               'cost_per_h': 7.0, 'predicted_ms': 157892.640625,
               'feasible': True}}},
  'fast': {'evals': 16,
   'dispatches': 1,
   'cost': 7.0,
   'nu': {'Q1-10u': 40},
   'classes': {'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
               'cost_per_h': 7.0, 'predicted_ms': 157892.640625,
               'feasible': True}}}},
 'vm_race': {'catalog_size': 4,
  'locked': {'vm_type': 'steady', 'nu': 10, 'reserved': 8, 'spot': 2,
             'cost_per_h': 1.7000000000000002,
             'predicted_ms': 10872.7802734375, 'feasible': True,
             'dispatches': 2, 'evals': 24},
  'raced': {'vm_type': 'turbo', 'nu': 10, 'reserved': 8, 'spot': 2,
            'cost_per_h': 1.445, 'predicted_ms': 10872.7802734375,
            'feasible': True, 'dispatches': 2, 'evals': 32},
  'lanes': {'etl@steady': {'bound': 1.7000000000000002,
    'pruned': True,
    'evals': 8,
    'nus': [2, 3, 4, 5, 6, 7, 8, 9],
    'predicted_ms': [45701.720703125, 29305.2548828125, 19142.828311820653,
                     16683.0830078125, 14064.7939453125, 12356.126180366848,
                     11322.096433423912, 11094.0],
    'feasible': [False, False, False, False, False, False, False, False]},
   'etl@turbo': {'bound': 1.445,
    'pruned': False,
    'evals': 8,
    'nus': [4, 5, 6, 7, 8, 9, 10, 11],
    'predicted_ms': [19142.828311820653, 16683.0830078125, 14064.7939453125,
                     12356.126180366848, 11322.096433423912, 11094.0,
                     10872.7802734375, 10301.147257133152],
    'feasible': [False, False, False, False, False, False, True, True]},
   'etl@value': {'bound': 1.615,
    'pruned': False,
    'evals': 8,
    'nus': [3, 4, 5, 6, 7, 8, 9, 10],
    'predicted_ms': [29305.2548828125, 19142.828311820653, 16683.0830078125,
                     14064.7939453125, 12356.126180366848, 11322.096433423912,
                     11094.0, 10872.7802734375],
    'feasible': [False, False, False, False, False, False, False, True]},
   'etl@micro': {'bound': 2.4,
    'pruned': True,
    'evals': 8,
    'nus': [8, 9, 10, 11, 12, 13, 14, 15],
    'predicted_ms': [48258.58984375, 43058.8125, 36881.40625, 32782.3818359375,
                     29101.548828125, 26457.994140625, 25241.701171875,
                     22299.076171875],
    'feasible': [False, False, False, False, False, False, False, False]}},
  'single_type': {'locked': {'vm_type': 'steady', 'nu': 10, 'reserved': 8, 'spot': 2,
              'cost_per_h': 1.7000000000000002,
              'predicted_ms': 10872.7802734375, 'feasible': True,
              'dispatches': 2, 'evals': 24},
   'raced': {'vm_type': 'steady', 'nu': 10, 'reserved': 8, 'spot': 2,
             'cost_per_h': 1.7000000000000002,
             'predicted_ms': 10872.7802734375, 'feasible': True,
             'dispatches': 2, 'evals': 24}},
  'lanes_pruned': 2,
  'parity_bit_exact': True,
  'degenerate_single_type': True},
 'table3': {'rows': [{'row': 0, 'query': 'Q1', 'users': 1, 'cores': 240, 'dataset_gb': 250,
    'n_map': 500, 'n_reduce': 1, 'events': 131072, 'max_slots': 256,
    'T_ms': 56565.6889959794, 'tau_ms': 55956.546875,
    'theta_pct': -1.0768756321923274},
   {'row': 1, 'query': 'Q1', 'users': 5, 'cores': 40, 'dataset_gb': 250,
    'n_map': 144, 'n_reduce': 151, 'events': 65536, 'max_slots': 48,
    'T_ms': 647001.1559847814, 'tau_ms': 653459.4375,
    'theta_pct': 0.9981870133429036},
   {'row': 2, 'query': 'Q2', 'users': 1, 'cores': 240, 'dataset_gb': 250,
    'n_map': 65, 'n_reduce': 5, 'events': 16384, 'max_slots': 256,
    'T_ms': 34720.35533252957, 'tau_ms': 34937.41015625,
    'theta_pct': 0.6251515044751527},
   {'row': 3, 'query': 'Q2', 'users': 3, 'cores': 20, 'dataset_gb': 250,
    'n_map': 4, 'n_reduce': 4, 'events': 2048, 'max_slots': 24,
    'T_ms': 106089.7655597094, 'tau_ms': 109668.78853699552,
    'theta_pct': 3.37357987210536},
   {'row': 4, 'query': 'Q3', 'users': 1, 'cores': 240, 'dataset_gb': 250,
    'n_map': 750, 'n_reduce': 1, 'events': 131072, 'max_slots': 256,
    'T_ms': 78279.08301385435, 'tau_ms': 74534.375,
    'theta_pct': -4.783791365046509},
   {'row': 5, 'query': 'Q4', 'users': 1, 'cores': 240, 'dataset_gb': 250,
    'n_map': 524, 'n_reduce': 384, 'events': 131072, 'max_slots': 256,
    'T_ms': 90715.23113269667, 'tau_ms': 93471.234375,
    'theta_pct': 3.038082147717722},
   {'row': 6, 'query': 'Q1', 'users': 1, 'cores': 60, 'dataset_gb': 500,
    'n_map': 287, 'n_reduce': 300, 'events': 131072, 'max_slots': 64,
    'T_ms': 383289.21291400865, 'tau_ms': 389564.0625,
    'theta_pct': 1.6371057088421432},
   {'row': 7, 'query': 'Q3', 'users': 1, 'cores': 100, 'dataset_gb': 500,
    'n_map': 757, 'n_reduce': 793, 'events': 262144, 'max_slots': 128,
    'T_ms': 388382.15897552815, 'tau_ms': 408958.03125,
    'theta_pct': 5.2978417774767905},
   {'row': 8, 'query': 'Q3', 'users': 1, 'cores': 120, 'dataset_gb': 750,
    'n_map': 1148, 'n_reduce': 1009, 'events': 524288, 'max_slots': 128,
    'T_ms': 671285.9701335928, 'tau_ms': 658587.375,
    'theta_pct': -1.8916818909630553},
   {'row': 9, 'query': 'Q4', 'users': 1, 'cores': 60, 'dataset_gb': 750,
    'n_map': 868, 'n_reduce': 910, 'events': 262144, 'max_slots': 64,
    'T_ms': 821368.9972806626, 'tau_ms': 814317.375,
    'theta_pct': -0.8585206288536235},
   {'row': 10, 'query': 'Q3', 'users': 1, 'cores': 80, 'dataset_gb': 1000,
    'n_map': 1560, 'n_reduce': 1009, 'events': 524288, 'max_slots': 96,
    'T_ms': 1015141.8560173161, 'tau_ms': 1016119.78125,
    'theta_pct': 0.09633384998236239},
   {'row': 11, 'query': 'Q5', 'users': 1, 'cores': 80, 'dataset_gb': 1000,
    'n_map': 64, 'n_reduce': 68, 'events': 32768, 'max_slots': 96,
    'T_ms': 38557.02898293836, 'tau_ms': 41583.919921875,
    'theta_pct': 7.850425768738689}],
  'mean_abs_theta_pct': 2.62729809664472,
  'max_abs_theta_pct': 7.850425768738689,
  'paper_mean_pct': 12.27,
  'paper_max_pct': 30.59},
 'serving_qn': {'n_requests': 12,
  'slots': 3,
  'solo_ms': [150.0, 2500.0],
  'tau_ms': [599.0405578613281, 9999.0283203125]},
 'dag_sweep': {
  'frontier': {'points': 16, 'scalar_dispatches': 16,
               'batched_dispatches': 1, 'parity_bit_exact': True,
               'predicted_ms': [23929.9140625, 15290.25, 13779.095703125,
                 14001.2529296875, 13338.9052734375, 13555.033203125,
                 13237.091796875, 13689.8388671875, 13681.91796875,
                 13777.8583984375, 13962.0224609375, 13962.0224609375,
                 13962.0224609375, 13962.0224609375, 13962.0224609375,
                 13962.0224609375]},
  'optimizer': {
   'pointwise': {'evals': 11, 'dispatches': 11, 'cost': 2.41,
     'nu': {'spark-etl': 13},
     'classes': {
      'spark-etl': {'vm_type': 'm4.xlarge', 'nu': 13, 'reserved': 10,
        'spot': 3, 'cost_per_h': 2.41, 'predicted_ms': 13997.10546875,
        'feasible': False}}},
   'batched': {'evals': 27, 'dispatches': 4, 'cost': 4.74,
     'nu': {'spark-etl': 27},
     'classes': {
      'spark-etl': {'vm_type': 'm4.xlarge', 'nu': 27, 'reserved': 19,
        'spot': 8, 'cost_per_h': 4.74, 'predicted_ms': 13997.10546875,
        'feasible': False}}}},
  'dispatch_ratio': 2.75, 'nu_agree': False},
 'spark_dag_plan': {
  'run': {'evals': 23, 'dispatches': 3, 'cost': 1.56,
    'nu': {'bi-dashboards': 3, 'spark-etl': 1},
    'classes': {
     'bi-dashboards': {'vm_type': 'm4.xlarge', 'nu': 3, 'reserved': 3,
       'spot': 0, 'cost_per_h': 0.66, 'predicted_ms': 51276.21484375,
       'feasible': True},
     'spark-etl': {'vm_type': 'c20.node', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.9, 'predicted_ms': 11387.7890625, 'feasible': True}}},
  'run_pointwise': {'evals': 4, 'dispatches': 4, 'cost': 1.32,
    'nu': {'bi-dashboards': 3, 'spark-etl': 3},
    'classes': {
     'bi-dashboards': {'vm_type': 'm4.xlarge', 'nu': 3, 'reserved': 3,
       'spot': 0, 'cost_per_h': 0.66, 'predicted_ms': 51276.21484375,
       'feasible': True},
     'spark-etl': {'vm_type': 'm4.xlarge', 'nu': 3, 'reserved': 3, 'spot': 0,
       'cost_per_h': 0.66, 'predicted_ms': 13835.5166015625, 'feasible': True}}},
  'run_fast': {'evals': 23, 'dispatches': 3, 'cost': 1.56,
    'nu': {'bi-dashboards': 3, 'spark-etl': 1},
    'classes': {
     'bi-dashboards': {'vm_type': 'm4.xlarge', 'nu': 3, 'reserved': 3,
       'spot': 0, 'cost_per_h': 0.66, 'predicted_ms': 51276.21484375,
       'feasible': True},
     'spark-etl': {'vm_type': 'c20.node', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.9, 'predicted_ms': 11387.7890625, 'feasible': True}}}}}

# the live reference's service drives (benchmarks/port_reference_decisions.py
# service)
REFERENCE["service"] = {
 'service_throughput': {'solo_dispatches': [1, 1, 1, 1, 1, 1, 1, 1], 'service_dispatches': 1,
  'warm_dispatches': 0, 'warm_hit_rate': 1.0, 'parity': True,
  'warm_parity': True,
  'service': {'rounds': 1,
   'scheduler': {'fused_dispatches': 1, 'points_requested': 8, 'points_dispatched': 8},
   'points_cached': 0, 'points_deduped': 0,
   'cache': {'entries': 8, 'hits': 0, 'misses': 8, 'hit_rate': 0.0},
   'admission': {'admitted': 8, 'deferred': 0, 'shed': 0, 'released': 8,
    'oversize_admitted': 0, 'inflight_events': 0,
    'peak_inflight_events': 1048576, 'inflight_cores': 0,
    'peak_inflight_cores': 0},
   'tenants': {
    'tenant-0': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 1,
     'points_cached': 0, 'points_dispatched': 1},
    'tenant-1': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 1,
     'points_cached': 0, 'points_dispatched': 1},
    'tenant-2': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 1,
     'points_cached': 0, 'points_dispatched': 1},
    'tenant-3': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 1,
     'points_cached': 0, 'points_dispatched': 1},
    'tenant-4': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 1,
     'points_cached': 0, 'points_dispatched': 1},
    'tenant-5': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 1,
     'points_cached': 0, 'points_dispatched': 1},
    'tenant-6': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 1,
     'points_cached': 0, 'points_dispatched': 1},
    'tenant-7': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 1,
     'points_cached': 0, 'points_dispatched': 1}},
   'jobs': {
    'job-0000': {'tenant': 'tenant-0', 'state': 'done',
     'classes': {
      'tenant-0': {'vm_type': 'm4.xlarge', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.22, 'predicted_ms': 11151.067641469595,
       'feasible': True}}},
    'job-0001': {'tenant': 'tenant-1', 'state': 'done',
     'classes': {
      'tenant-1': {'vm_type': 'm4.xlarge', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.22, 'predicted_ms': 12450.30419921875, 'feasible': True}}},
    'job-0002': {'tenant': 'tenant-2', 'state': 'done',
     'classes': {
      'tenant-2': {'vm_type': 'm4.xlarge', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.22, 'predicted_ms': 13221.380859375, 'feasible': True}}},
    'job-0003': {'tenant': 'tenant-3', 'state': 'done',
     'classes': {
      'tenant-3': {'vm_type': 'm4.xlarge', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.22, 'predicted_ms': 14893.716796875, 'feasible': True}}},
    'job-0004': {'tenant': 'tenant-4', 'state': 'done',
     'classes': {
      'tenant-4': {'vm_type': 'm4.xlarge', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.22, 'predicted_ms': 15790.10986328125, 'feasible': True}}},
    'job-0005': {'tenant': 'tenant-5', 'state': 'done',
     'classes': {
      'tenant-5': {'vm_type': 'm4.xlarge', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.22, 'predicted_ms': 17455.1572265625, 'feasible': True}}},
    'job-0006': {'tenant': 'tenant-6', 'state': 'done',
     'classes': {
      'tenant-6': {'vm_type': 'm4.xlarge', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.22, 'predicted_ms': 17987.7666015625, 'feasible': True}}},
    'job-0007': {'tenant': 'tenant-7', 'state': 'done',
     'classes': {
      'tenant-7': {'vm_type': 'm4.xlarge', 'nu': 1, 'reserved': 1, 'spot': 0,
       'cost_per_h': 0.22, 'predicted_ms': 19063.15625, 'feasible': True}}}}}},
 'serve_many': {'rounds': 4,
  'scheduler': {'fused_dispatches': 4, 'points_requested': 63, 'points_dispatched': 60},
  'points_cached': 3, 'points_deduped': 0,
  'cache': {'entries': 60, 'hits': 3, 'misses': 60, 'hit_rate': 0.047619047619047616},
  'admission': {'admitted': 5, 'deferred': 0, 'shed': 0, 'released': 5,
   'oversize_admitted': 0, 'inflight_events': 0,
   'peak_inflight_events': 196608, 'inflight_cores': 0,
   'peak_inflight_cores': 0},
  'tenants': {
   'job-0000': {'jobs': 1, 'states': {'done': 1}, 'rounds': 3, 'points': 10,
    'points_cached': 1, 'points_dispatched': 9},
   'job-0001': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 2,
    'points_cached': 0, 'points_dispatched': 2},
   'job-0002': {'jobs': 1, 'states': {'done': 1}, 'rounds': 3, 'points': 12,
    'points_cached': 2, 'points_dispatched': 10},
   'job-0003': {'jobs': 1, 'states': {'done': 1}, 'rounds': 2, 'points': 11,
    'points_cached': 0, 'points_dispatched': 11},
   'json-tenant': {'jobs': 1, 'states': {'infeasible': 1}, 'rounds': 4, 'points': 28,
    'points_cached': 0, 'points_dispatched': 28}},
  'jobs': {
   'job-0000': {'tenant': 'job-0000', 'state': 'done',
    'classes': {
     'tenant-0': {'vm_type': 'm4.xlarge', 'nu': 2, 'reserved': 2, 'spot': 0,
      'cost_per_h': 0.44, 'predicted_ms': 7287.31787109375, 'feasible': True}}},
   'job-0001': {'tenant': 'job-0001', 'state': 'done',
    'classes': {
     'tenant-1': {'vm_type': 'm4.xlarge', 'nu': 2, 'reserved': 2, 'spot': 0,
      'cost_per_h': 0.44, 'predicted_ms': 8799.810546875, 'feasible': True}}},
   'job-0002': {'tenant': 'job-0002', 'state': 'done',
    'classes': {
     'tenant-2': {'vm_type': 'm4.xlarge', 'nu': 3, 'reserved': 3, 'spot': 0,
      'cost_per_h': 0.66, 'predicted_ms': 8987.1826171875, 'feasible': True}}},
   'job-0003': {'tenant': 'job-0003', 'state': 'done',
    'classes': {
     'tenant-3': {'vm_type': 'm4.xlarge', 'nu': 5, 'reserved': 4, 'spot': 1,
      'cost_per_h': 0.95, 'predicted_ms': 9777.02734375, 'feasible': True}}},
   'job-0004': {'tenant': 'json-tenant', 'state': 'infeasible',
    'classes': {
     'tenant-4': {'vm_type': 'm4.xlarge', 'nu': 28, 'reserved': 20, 'spot': 8,
      'cost_per_h': 4.960000000000001, 'predicted_ms': 10818.5224609375,
      'feasible': False}}}}},
 'spark_dag_service': {'rounds': 2,
  'scheduler': {'fused_dispatches': 3, 'points_requested': 30, 'points_dispatched': 15},
  'points_cached': 0, 'points_deduped': 15,
  'cache': {'entries': 15, 'hits': 0, 'misses': 30, 'hit_rate': 0.0},
  'admission': {'admitted': 2, 'deferred': 0, 'shed': 0, 'released': 2,
   'oversize_admitted': 0, 'inflight_events': 0,
   'peak_inflight_events': 524288, 'inflight_cores': 0,
   'peak_inflight_cores': 0},
  'tenants': {
   'job-0000': {'jobs': 1, 'states': {'done': 1}, 'rounds': 2, 'points': 15,
    'points_cached': 0, 'points_dispatched': 15},
   'job-0001': {'jobs': 1, 'states': {'done': 1}, 'rounds': 2, 'points': 15,
    'points_cached': 0, 'points_dispatched': 0}},
  'jobs': {
   'job-0000': {'tenant': 'job-0000', 'state': 'done',
    'classes': {
     'bi-dashboards': {'vm_type': 'm4.xlarge', 'nu': 3, 'reserved': 3, 'spot': 0,
      'cost_per_h': 0.66, 'predicted_ms': 51276.21484375, 'feasible': True},
     'spark-etl': {'vm_type': 'c20.node', 'nu': 1, 'reserved': 1, 'spot': 0,
      'cost_per_h': 0.9, 'predicted_ms': 11387.7890625, 'feasible': True}}},
   'job-0001': {'tenant': 'job-0001', 'state': 'done',
    'classes': {
     'bi-dashboards': {'vm_type': 'm4.xlarge', 'nu': 3, 'reserved': 3, 'spot': 0,
      'cost_per_h': 0.66, 'predicted_ms': 51276.21484375, 'feasible': True},
     'spark-etl': {'vm_type': 'c20.node', 'nu': 1, 'reserved': 1, 'spot': 0,
      'cost_per_h': 0.9, 'predicted_ms': 11387.7890625, 'feasible': True}}}}},
 'q1_tenants': {'rounds': 5,
  'scheduler': {'fused_dispatches': 8, 'points_requested': 131, 'points_dispatched': 79},
  'points_cached': 52, 'points_deduped': 0,
  'cache': {'entries': 79, 'hits': 52, 'misses': 79, 'hit_rate': 0.3969465648854962},
  'admission': {'admitted': 4, 'deferred': 3, 'shed': 0, 'released': 4,
   'oversize_admitted': 0, 'inflight_events': 0,
   'peak_inflight_events': 8388608, 'inflight_cores': 0,
   'peak_inflight_cores': 0},
  'tenants': {
   'Q1-300s': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 24,
    'points_cached': 0, 'points_dispatched': 24},
   'Q1-200s': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 28,
    'points_cached': 9, 'points_dispatched': 19},
   'Q1-160s': {'jobs': 1, 'states': {'done': 1}, 'rounds': 1, 'points': 31,
    'points_cached': 15, 'points_dispatched': 16},
   'Q1-130s': {'jobs': 1, 'states': {'done': 1}, 'rounds': 2, 'points': 48,
    'points_cached': 28, 'points_dispatched': 20}},
  'jobs': {
   'job-0000': {'tenant': 'Q1-300s', 'state': 'done',
    'classes': {
     'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 22, 'reserved': 16, 'spot': 6,
      'cost_per_h': 3.94, 'predicted_ms': 296486.640625, 'feasible': True}}},
   'job-0001': {'tenant': 'Q1-200s', 'state': 'done',
    'classes': {
     'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 33, 'reserved': 24, 'spot': 9,
      'cost_per_h': 5.91, 'predicted_ms': 194410.5734569502, 'feasible': True}}},
   'job-0002': {'tenant': 'Q1-160s', 'state': 'done',
    'classes': {
     'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 40, 'reserved': 28, 'spot': 12,
      'cost_per_h': 7.0, 'predicted_ms': 158747.29693983402, 'feasible': True}}},
   'job-0003': {'tenant': 'Q1-130s', 'state': 'done',
    'classes': {
     'Q1-10u': {'vm_type': 'm4.xlarge', 'nu': 49, 'reserved': 35, 'spot': 14,
      'cost_per_h': 8.68, 'predicted_ms': 127836.6484375, 'feasible': True}}}}}}

# the live reference's numbers for the [cloud] drives (JSON from
# benchmarks/port_reference_decisions.py private_cloud, JAX 0.9.0)
REFERENCE["cloud"] = json.loads("""
{"bench": {"demand_cores": 60, "capacity_cores": 28, "public": {"qn_dispatches": 1,
"classes": {"c0": {"vm_type": "roomy", "nu": 5, "reserved": 4, "spot": 1,
"cost_per_h": 0.8500000000000001, "predicted_ms": 10872.7802734375, "feasible": true},
"c1": {"vm_type": "roomy", "nu": 5, "reserved": 4, "spot": 1, "cost_per_h": 0.8500000000000001,
"predicted_ms": 10872.7802734375, "feasible": true}, "c2": {"vm_type": "roomy",
"nu": 5, "reserved": 4, "spot": 1, "cost_per_h": 0.8500000000000001, "predicted_ms": 10872.7802734375,
"feasible": true}}, "deployment": null, "assignment": []}, "private": {"qn_dispatches": 1,
"classes": {"c0": {"vm_type": "dense", "nu": 4, "reserved": 3, "spot": 1,
"cost_per_h": 0.7150000000000001, "predicted_ms": 11412.185982716377, "feasible": false},
"c1": {"vm_type": "dense", "nu": 5, "reserved": 4, "spot": 1, "cost_per_h": 0.935,
"predicted_ms": 10872.7802734375, "feasible": true}, "c2": {"vm_type": "dense",
"nu": 5, "reserved": 4, "spot": 1, "cost_per_h": 0.935, "predicted_ms": 10872.7802734375,
"feasible": true}}, "deployment": {"cost_per_h": 2.585, "violations": 1,
"objective": 6.17, "baseline_cost_per_h": 1.4000000000000001, "baseline_violations": 3,
"baseline_objective": 12.155, "dual_price": 10.88, "price_rounds": 10,
"probe_rounds": 1, "lanes_verified": 3, "coordinated": true, "used_fallback": true,
"placement": {"feasible": true, "hosts_used": 7, "energy_cost_per_h": 2.1,
"cores_used": 28, "cores_total": 28, "unplaced": 0, "strategy": "ffd-energy"}},
"assignment": [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6]}, "unbounded": {"bit_exact": true,
"coordinated": false, "classes": {"c0": {"vm_type": "roomy", "nu": 5, "reserved": 4,
"spot": 1, "cost_per_h": 0.8500000000000001, "predicted_ms": 10872.7802734375,
"feasible": true}, "c1": {"vm_type": "roomy", "nu": 5, "reserved": 4, "spot": 1,
"cost_per_h": 0.8500000000000001, "predicted_ms": 10872.7802734375, "feasible": true},
"c2": {"vm_type": "roomy", "nu": 5, "reserved": 4, "spot": 1, "cost_per_h": 0.8500000000000001,
"predicted_ms": 10872.7802734375, "feasible": true}}}, "single_window_dispatches": 1,
"day": {"windows": 24, "vm_day_cost": 72.6, "energy_day_cost": 0.0, "naive_hourly_cost": 54.60000000000001,
"qn_dispatches": 5, "rounds": 3, "windows_feasible": [true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true], "coordinated": [false,
false, false, false, false, false, false, false, false, false, false, false,
false, false, false, false, false, false, false, false, false, false, false,
false], "contracts": [{"cls": "c0", "vm_type": "roomy", "reserved": 5,
"spots": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
1, 1, 1], "nus": [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 5, 5, 5, 5, 5, 5,
5, 5, 6, 6, 6, 6], "day_cost": 24.2}, {"cls": "c1", "vm_type": "roomy",
"reserved": 5, "spots": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
0, 0, 0, 0, 1, 1, 1, 1], "nus": [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 5,
5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6], "day_cost": 24.2}, {"cls": "c2", "vm_type": "roomy",
"reserved": 5, "spots": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
0, 0, 0, 0, 1, 1, 1, 1], "nus": [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 5,
5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6], "day_cost": 24.2}]}, "day_private": {"windows": 24,
"vm_day_cost": 93.00000000000001, "energy_day_cost": 43.2, "naive_hourly_cost": 50.04,
"qn_dispatches": 5, "rounds": 6, "windows_feasible": [true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true], "coordinated": [true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true], "contracts": [{"cls": "c0",
"vm_type": "dense", "reserved": 3, "spots": [0, 0, 0, 0, 0, 0, 0, 0, 0,
0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0], "nus": [3, 3, 3, 3, 3, 3,
3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 0, 0, 0, 0], "day_cost": 16.28},
{"cls": "c0", "vm_type": "roomy", "reserved": 2, "spots": [0, 0, 0, 0,
0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], "nus": [0,
0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 2], "day_cost": 9.600000000000001},
{"cls": "c1", "vm_type": "dense", "reserved": 4, "spots": [0, 0, 0, 0,
0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0], "nus": [3,
3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 5, 5, 5, 5, 5, 5, 5, 5, 0, 0, 0, 0], "day_cost": 21.560000000000002},
{"cls": "c1", "vm_type": "roomy", "reserved": 2, "spots": [0, 0, 0, 0,
0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], "nus": [0,
0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 2], "day_cost": 9.600000000000001},
{"cls": "c2", "vm_type": "dense", "reserved": 4, "spots": [0, 0, 0, 0,
0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0], "nus": [3,
3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 5, 5, 5, 5, 5, 5, 5, 5, 0, 0, 0, 0], "day_cost": 21.560000000000002},
{"cls": "c2", "vm_type": "roomy", "reserved": 3, "spots": [0, 0, 0, 0,
0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], "nus": [0,
0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 3, 3], "day_cost": 14.400000000000002}]}},
"real": {"demand_cores": 360, "capacity_cores": 180, "public": {"qn_dispatches": 4,
"classes": {"Q1-10u": {"vm_type": "m4.xlarge", "nu": 40, "reserved": 28,
"spot": 12, "cost_per_h": 7.0, "predicted_ms": 158747.29693983402, "feasible": true},
"Q3-10u": {"vm_type": "m4.xlarge", "nu": 50, "reserved": 35, "spot": 15,
"cost_per_h": 8.75, "predicted_ms": 220000.0, "feasible": true}}, "deployment": null,
"assignment": []}, "run": {"qn_dispatches": 4, "classes": {"Q1-10u": {"vm_type": "m4.xlarge",
"nu": 22, "reserved": 16, "spot": 6, "cost_per_h": 3.94, "predicted_ms": 341751.0405864507,
"feasible": false}, "Q3-10u": {"vm_type": "m4.xlarge", "nu": 22, "reserved": 16,
"spot": 6, "cost_per_h": 3.94, "predicted_ms": 563172.2423400783, "feasible": false}},
"deployment": {"cost_per_h": 7.88, "violations": 2, "objective": 25.639999999999997,
"baseline_cost_per_h": 7.88, "baseline_violations": 2, "baseline_objective": 25.639999999999997,
"dual_price": 11.2, "price_rounds": 10, "probe_rounds": 0, "lanes_verified": 0,
"coordinated": true, "used_fallback": true, "placement": {"feasible": true,
"hosts_used": 9, "energy_cost_per_h": 2.6999999999999997, "cores_used": 176,
"cores_total": 180, "unplaced": 0, "strategy": "ffd-energy"}}, "assignment": [0,
0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4,
5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 8, 8, 8, 8]}, "run_fast": {"qn_dispatches": 4,
"classes": {"Q1-10u": {"vm_type": "m4.xlarge", "nu": 22, "reserved": 16,
"spot": 6, "cost_per_h": 3.94, "predicted_ms": 341751.0405864507, "feasible": false},
"Q3-10u": {"vm_type": "m4.xlarge", "nu": 22, "reserved": 16, "spot": 6,
"cost_per_h": 3.94, "predicted_ms": 563172.2423400783, "feasible": false}},
"deployment": {"cost_per_h": 7.88, "violations": 2, "objective": 25.639999999999997,
"baseline_cost_per_h": 7.88, "baseline_violations": 2, "baseline_objective": 25.639999999999997,
"dual_price": 11.2, "price_rounds": 10, "probe_rounds": 0, "lanes_verified": 0,
"coordinated": true, "used_fallback": true, "placement": {"feasible": true,
"hosts_used": 9, "energy_cost_per_h": 2.6999999999999997, "cores_used": 176,
"cores_total": 180, "unplaced": 0, "strategy": "ffd-energy"}}, "assignment": [0,
0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4,
5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 8, 8, 8, 8]}, "run_pointwise": {"qn_dispatches": 64,
"classes": {"Q1-10u": {"vm_type": "m4.xlarge", "nu": 22, "reserved": 16,
"spot": 6, "cost_per_h": 3.94, "predicted_ms": 341751.0405864507, "feasible": false},
"Q3-10u": {"vm_type": "m4.xlarge", "nu": 22, "reserved": 16, "spot": 6,
"cost_per_h": 3.94, "predicted_ms": 563172.2423400783, "feasible": false}},
"deployment": {"cost_per_h": 7.88, "violations": 2, "objective": 25.639999999999997,
"baseline_cost_per_h": 7.88, "baseline_violations": 2, "baseline_objective": 25.639999999999997,
"dual_price": 11.2, "price_rounds": 10, "probe_rounds": 0, "lanes_verified": 0,
"coordinated": true, "used_fallback": true, "placement": {"feasible": true,
"hosts_used": 9, "energy_cost_per_h": 2.6999999999999997, "cores_used": 176,
"cores_total": 180, "unplaced": 0, "strategy": "ffd-energy"}}, "assignment": [0,
0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4,
5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 8, 8, 8, 8]}, "service": {"rounds": 1,
"scheduler": {"fused_dispatches": 4, "points_requested": 94, "points_dispatched": 63},
"points_cached": 0, "points_deduped": 31, "cache": {"entries": 63, "hits": 0,
"misses": 94, "hit_rate": 0.0}, "admission": {"admitted": 2, "deferred": 0,
"shed": 0, "released": 2, "oversize_admitted": 0, "inflight_events": 0,
"peak_inflight_events": 25165824, "inflight_cores": 0, "peak_inflight_cores": 180},
"tenants": {"private": {"jobs": 1, "states": {"infeasible": 1}, "rounds": 1,
"points": 63, "points_cached": 0, "points_dispatched": 63}, "Q1-public": {"jobs": 1,
"states": {"done": 1}, "rounds": 1, "points": 31, "points_cached": 0, "points_dispatched": 0}},
"jobs": {"job-0000": {"tenant": "private", "state": "infeasible", "classes": {"Q1-10u": {"vm_type": "m4.xlarge",
"nu": 22, "reserved": 16, "spot": 6, "cost_per_h": 3.94, "predicted_ms": 341751.0405864507,
"feasible": false}, "Q3-10u": {"vm_type": "m4.xlarge", "nu": 22, "reserved": 16,
"spot": 6, "cost_per_h": 3.94, "predicted_ms": 563172.2423400783, "feasible": false}}},
"job-0001": {"tenant": "Q1-public", "state": "done", "classes": {"Q1-10u": {"vm_type": "m4.xlarge",
"nu": 40, "reserved": 28, "spot": 12, "cost_per_h": 7.0, "predicted_ms": 158747.29693983402,
"feasible": true}}}}}, "service_private": {"qn_dispatches": 4, "classes": {"Q1-10u": {"vm_type": "m4.xlarge",
"nu": 22, "reserved": 16, "spot": 6, "cost_per_h": 3.94, "predicted_ms": 341751.0405864507,
"feasible": false}, "Q3-10u": {"vm_type": "m4.xlarge", "nu": 22, "reserved": 16,
"spot": 6, "cost_per_h": 3.94, "predicted_ms": 563172.2423400783, "feasible": false}},
"deployment": {"cost_per_h": 7.88, "violations": 2, "objective": 25.639999999999997,
"baseline_cost_per_h": 7.88, "baseline_violations": 2, "baseline_objective": 25.639999999999997,
"dual_price": 11.2, "price_rounds": 10, "probe_rounds": 0, "lanes_verified": 0,
"coordinated": true, "used_fallback": true, "placement": {"feasible": true,
"hosts_used": 9, "energy_cost_per_h": 2.6999999999999997, "cores_used": 176,
"cores_total": 180, "unplaced": 0, "strategy": "ffd-energy"}}, "assignment": [0,
0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4,
5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 8, 8, 8, 8]}}}
""")

# the live reference's numbers for the [capacity] drive (JSON from
# benchmarks/port_reference_decisions.py capacity, JAX 0.9.0)
REFERENCE["capacity"] = json.loads("""
{"slots": {"s": {"v5e-16": 1264, "v5e-64": 5141, "v5e-256": 20651, "v5p-128":
61365}, "s256": {"v5e-16": 1264, "v5e-64": 5141, "v5e-256": 20651, "v5p-128":
61365}, "chat-granite": {"v5e-16": 632, "v5e-64": 2570, "v5e-256": 10325,
"v5p-128": 30682}, "chat-mamba2": {"v5e-16": 57209, "v5e-64": 230009,
"v5e-256": 921209, "v5p-128": 2735609}, "crowd-granite": {"v5e-16": 82,
"v5e-64": 336, "v5e-256": 1350, "v5p-128": 4012}}, "serving": {"s": {"kkt":
{"vm_type": "v5e-16", "nu": 1, "reserved": 1, "spot": 0, "cost_per_h": 19.2,
"predicted_ms": 45.472057414923704, "feasible": true, "dispatches": 0}, "qn":
{"vm_type": "v5e-16", "nu": 1, "reserved": 1, "spot": 0, "cost_per_h": 19.2,
"predicted_ms": 59.69597625732422, "feasible": true, "dispatches": 1}},
"s256": {"kkt": {"vm_type": "v5e-16", "nu": 1, "reserved": 1, "spot": 0,
"cost_per_h": 19.2, "predicted_ms": 45.50749884278334, "feasible": true,
"dispatches": 0}, "qn": {"vm_type": "v5e-16", "nu": 1, "reserved": 1, "spot":
0, "cost_per_h": 19.2, "predicted_ms": 64.27202606201172, "feasible": true,
"dispatches": 1}}, "chat-granite": {"kkt": {"vm_type": "v5e-16", "nu": 1,
"reserved": 1, "spot": 0, "cost_per_h": 19.2, "predicted_ms":
90.99826650436057, "feasible": true, "dispatches": 0}, "qn": {"vm_type":
"v5e-16", "nu": 1, "reserved": 1, "spot": 0, "cost_per_h": 19.2,
"predicted_ms": 133.88221740722656, "feasible": true, "dispatches": 1}},
"chat-mamba2": {"kkt": {"vm_type": "v5e-16", "nu": 1, "reserved": 1, "spot":
0, "cost_per_h": 19.2, "predicted_ms": 0.91413752937612, "feasible": true,
"dispatches": 0}, "qn": {"vm_type": "v5e-16", "nu": 1, "reserved": 1, "spot":
0, "cost_per_h": 19.2, "predicted_ms": 1.2605408430099487, "feasible": true,
"dispatches": 1}}, "crowd-granite": {"kkt": {"vm_type": "v5e-64", "nu": 1,
"reserved": 1, "spot": 0, "cost_per_h": 76.8, "predicted_ms":
71.72195957168897, "feasible": true, "dispatches": 0}, "qn": {"vm_type":
"v5e-64", "nu": 1, "reserved": 1, "spot": 0, "cost_per_h": 76.8,
"predicted_ms": 71.19148254394531, "feasible": true, "dispatches": 1}}},
"training": {"t24": {"vm_type": "v5e-16", "nu": 29, "reserved": 15, "spot":
14, "cost_per_h": 408.96000000000004, "predicted_ms": 84088319.38028494,
"feasible": true}, "t12": {"vm_type": "v5e-16", "nu": 57, "reserved": 29,
"spot": 28, "cost_per_h": 798.72, "predicted_ms": 42811949.3119493,
"feasible": true}}, "record": {"granite-3-2b|decode_32k": [2000000000.0,
1975820800.0, 5000000.0, 256], "granite-3-2b|prefill_32k": [1200000000000.0,
2311366672.0, 10000000.0, 256], "granite-3-2b|train_4k": [4500000000000.0,
4975469248.0, 20000000.0, 256], "mamba2-780m|decode_32k": [6000000.0,
348753984.0, 100000.0, 256]}, "replan": {"replan-granite-3-2b": {"vm_type":
"v5e-16", "nu": 2, "reserved": 1, "spot": 1, "cost_per_h": 27.84,
"predicted_ms": 22861389.593908627, "feasible": true}}, "cli": {"serve-qn":
{"printed": {"class": "serve-granite-3-2b", "vm_type": "v5e-16", "nu": 1,
"reserved": 1, "spot": 0, "cost_per_h": 19.2, "predicted_ms":
81.47190856933594, "feasible": true}, "dispatches": 1}, "serve-kkt":
{"printed": {"class": "serve-mamba2-780m", "vm_type": "v5e-16", "nu": 1,
"reserved": 1, "spot": 0, "cost_per_h": 19.2, "predicted_ms":
9.414087459199461, "feasible": true}, "dispatches": 0}, "train": {"printed":
{"class": "train-granite-3-2b", "vm_type": "v5e-16", "nu": 1, "reserved": 1,
"spot": 0, "cost_per_h": 19.2, "predicted_ms": 73156446.70050761, "feasible":
true}, "dispatches": 0}}}
""")

def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


_PHASE = {"name": "start", "t0": time.perf_counter()}


def phase(name: str) -> None:
    """Print the seconds of the phase that ends here; ``name`` starts."""
    now = time.perf_counter()
    print(f"[phase] {_PHASE['name']}: {now - _PHASE['t0']:.1f} s", flush=True)
    _PHASE.update(name=name, t0=now)


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the current stream, after one
    warm-up call."""
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


def quickstart_problem(P):
    """The two-class, two-VM problem of examples/quickstart.py."""
    JobProfile, VMType, AC = P.JobProfile, P.VMType, P.ApplicationClass
    interactive = JobProfile(n_map=64, n_reduce=16, m_avg=4000, m_max=9000,
                             r_avg=2000, r_max=4500)
    batchy = JobProfile(n_map=400, n_reduce=64, m_avg=8000, m_max=18000,
                        r_avg=5000, r_max=11000)
    small = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                   containers_per_core=2)
    big = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
    return P.Problem(classes=[
        AC(name="bi-dashboards", h_users=8, think_ms=10_000,
           deadline_ms=60_000, eta=0.3,
           profiles={"m4.xlarge": interactive,
                     "c20.node": interactive.scaled(1.35)}),
        AC(name="nightly-etl", h_users=2, think_ms=30_000,
           deadline_ms=600_000, eta=0.5,
           profiles={"m4.xlarge": batchy, "c20.node": batchy.scaled(1.35)}),
    ], vm_types=[small, big])


def small_replay_problem(P):
    """One class, two VM types, task counts small enough for the plain
    versions on the CPU; replay lists made from a numpy seed."""
    JobProfile, VMType = P.JobProfile, P.VMType
    prof = JobProfile(n_map=8, n_reduce=2, m_avg=3000, m_max=7000,
                      r_avg=1500, r_max=3500)
    vms = [VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                  containers_per_core=2),
           VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90,
                  speed=1.35)]
    cls = P.ApplicationClass(
        name="small", h_users=4, think_ms=10_000, deadline_ms=9_000,
        eta=0.3, profiles={"m4.xlarge": prof, "c20.node": prof.scaled(1.35)})
    rng = np.random.default_rng(3)
    samples = {}
    for vm in vms:
        f = 1.0 / vm.speed
        samples[("small", vm.name)] = (
            (rng.lognormal(np.log(3000), 0.4, 256) * f).astype(np.float32),
            (rng.lognormal(np.log(1500), 0.4, 128) * f).astype(np.float32))
    return P.Problem(classes=[cls], vm_types=vms), samples


def decisions(report) -> dict:
    return {name: {k: s.as_dict()[k] for k in
                   ("vm_type", "nu", "reserved", "spot", "cost_per_h",
                    "predicted_ms", "feasible")}
            for name, s in report.solutions.items()}


# ------------------------------------------------- benchmarked scenarios
# the repo's public-cloud planner benchmarks, in the order they run
SCENARIOS = ("batched_qn", "cost_deadline", "hc_convergence", "vm_race")
# the scenarios whose drives launch the amva kernel (run_fast's seeding,
# cost_deadline's frontiers)
AMVA_SCENARIOS = ("batched_qn", "cost_deadline", "hc_convergence")
# the paper's Table 3 band and the serving analogue's (percent)
PAPER_THETA = {"mean": 12.27, "max": 30.59, "serving_band": 30.0}


def check_launches(name, got, n_disp, amva: bool, dag: bool = False):
    """A planner drive's launches: one event-loop launch a counted
    dispatch (qn_event for a MapReduce group, dag_event for a DAG group),
    each beside one launch of its draw-table kernel (event_streams,
    dag_streams), amva where the drive seeds from the AMVA frontier,
    dag_event where it plans a DAG class, nothing else."""
    if got["qn_event"] + got["dag_event"] != n_disp or n_disp <= 0:
        fail(f"{name}: qn_event {got['qn_event']} and dag_event "
             f"{got['dag_event']} launches != counted dispatches {n_disp}")
    if got["event_streams"] != got["qn_event"]:
        fail(f"{name}: event_streams launches {got['event_streams']} != "
             f"qn_event launches {got['qn_event']}")
    if got["dag_streams"] != got["dag_event"]:
        fail(f"{name}: dag_streams launches {got['dag_streams']} != "
             f"dag_event launches {got['dag_event']}")
    if (got["amva"] > 0) != amva:
        fail(f"{name}: amva launches {got['amva']} (expected "
             f"{'some' if amva else 'none'})")
    if (got["dag_event"] > 0) != dag:
        fail(f"{name}: dag_event launches {got['dag_event']} (expected "
             f"{'some' if dag else 'none'})")
    if got["flash_attention"] or got["mva"] or got["ssd_scan"] or \
            got["amva_tensors"]:
        fail(f"{name}: launches off its path: {got}")


def check_scenario(scen, name, out, ref, got, n_disp, wall):
    """Print a benchmarked scenario's decisions beside the reference's and
    fail on any difference: exact, except vm_race's exponential-mode
    response times (the three exponential lanes and the decisions they
    give), within a relative 1e-3; its replay lane (micro) is exact."""
    rel = 1e-3 if name == "vm_race" else 0.0
    diff = scen.mismatches(ref, out, rel=rel)
    if name == "vm_race":
        diff += [f"lanes.etl@micro.{m}" for m in scen.mismatches(
            ref["lanes"]["etl@micro"], out["lanes"]["etl@micro"])]
    print(f"[scenarios] {name}: wall {wall:.3f} s, {n_disp} dispatches, "
          f"launches {got}", flush=True)
    if name == "batched_qn":
        fr, op = out["frontier"], out["optimizer"]
        print(f"[scenarios] batched_qn frontier ({fr['points']} points): "
              f"dispatches {fr['scalar_dispatches']} -> "
              f"{fr['batched_dispatches']}, parity_err "
              f"{fr['parity_max_rel_err']:.2e}, scalar {fr['scalar_s']:.3f} "
              f"s, batched {fr['batched_s']:.3f} s", flush=True)
        for mode, r in op.items():
            print(f"[scenarios] batched_qn {mode}: {r['dispatches']} "
                  f"dispatches, {r['evals']} evals, wall {r['wall_s']:.3f} "
                  f"s, decisions {json.dumps(r['classes'])}", flush=True)
    elif name == "cost_deadline":
        for fig, sm in out["summary"].items():
            pts = [(p["deadline_s"], p["vm"], p.get("nu"),
                    p.get("cost_per_h"), p["feasible"]) for p in out[fig]]
            print(f"[scenarios] cost_deadline {fig} ({sm['query']}, "
                  f"{sm['users']} users): crossover_deadline_s "
                  f"{sm['crossover_deadline_s']} (reference "
                  f"{ref['summary'][fig]['crossover_deadline_s']}), "
                  f"mono_cost {sm['mono_cost']}, {sm['dispatches']} "
                  f"dispatches, wall {sm['wall_s']:.3f} s; (deadline s, vm, "
                  f"nu, cost, feasible): {pts}", flush=True)
    elif name == "hc_convergence":
        for mode, r in out.items():
            print(f"[scenarios] hc_convergence {mode}: {r['dispatches']} "
                  f"dispatches, {r['evals']} evals, wall {r['wall_s']:.3f} "
                  f"s, decisions {json.dumps(r['classes'])}", flush=True)
    else:
        lo, ra = out["locked"], out["raced"]
        print(f"[scenarios] vm_race: cost {lo['cost_per_h']:.3f} -> "
              f"{ra['cost_per_h']:.3f} ({lo['vm_type']} -> "
              f"{ra['vm_type']}), dispatches {lo['dispatches']} -> "
              f"{ra['dispatches']}, pruned {out['lanes_pruned']}/"
              f"{len(out['lanes'])} "
              f"{ {k: (v['bound'], v['pruned']) for k, v in out['lanes'].items()} }"
              f", parity {out['parity_bit_exact']}, single type degenerate "
              f"{out['degenerate_single_type']}; predicted_ms locked "
              f"{lo['predicted_ms']!r} (reference "
              f"{ref['locked']['predicted_ms']!r}), raced "
              f"{ra['predicted_ms']!r} (reference "
              f"{ref['raced']['predicted_ms']!r})", flush=True)
    print(f"[scenarios] {name} against the reference: "
          f"{'equal' if not diff else diff}", flush=True)
    if diff:
        fail(f"{name} differs from the reference at {diff}")
    check_launches(name, got, n_disp, name in AMVA_SCENARIOS)


def planner_counts(kernels) -> dict:
    """The planner kernels' launches since their counts were set to 0, by
    the name the profiler gives each (qn_event's as the library reports
    the kernel it ran)."""
    dag_routes = kernels["dag_event"].routes
    return {**kernels["qn_event"].routes,
            "qn_streams_kernel": kernels["event_streams"].launches,
            "dag_event_fast": dag_routes["dag_event_fast"],
            "dag_event_kernel": dag_routes["dag_event_general"],
            "dag_streams_kernel": kernels["dag_streams"].launches,
            "amva_ps_frontier_kernel": kernels["amva"].launches}


def profiled_pass(kernels, fn, counted, label):
    """Drive ``fn`` once more, under torch.profiler; it must count the
    launches ``counted`` of the drive before it.  A kernel's device time
    is the sum over its profiled launches, or None (not measured) where
    the profiler saw another number of launches than the wrapper counted.
    Returns ``(fn's result, {kernel: ms or None}, note)``, the note with
    the pass's wall, its kernels' device events ``(start, kernel, ms)`` in
    order and a printable summary."""
    from torch.profiler import ProfilerActivity, profile

    reset_launches(*kernels.values())
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    again = planner_counts(kernels)
    if again != counted:
        fail(f"{label}: the profiled pass counted {again}, the drive "
             f"before it {counted}")
    events = sorted(
        (ev.time_range.start, k, ev.time_range.elapsed_us() / 1e3)
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and (k := qn_instance(ev.name) or (
            "amva_ps_frontier_kernel" if "amva_ps_frontier_kernel"
            in ev.name else None)))
    seen = collections.Counter(e[1] for e in events)
    dev_ms, parts = {}, []
    for k, n in counted.items():
        if not n and not seen[k]:
            continue
        ms = sum(e[2] for e in events if e[1] == k) \
            if seen[k] == n else None
        dev_ms[k] = ms
        seen_ms = sum(e[2] for e in events if e[1] == k)
        parts.append(f"{k} {n} launches, " + (
            f"{ms:.3f} ms on the device" if ms is not None else
            f"device time not measured (the profiler saw {seen[k]}, "
            f"{seen_ms:.3f} ms on the device)"))
    return out, dev_ms, {"wall_s": wall, "events": events,
                         "text": ", ".join(parts)
                         + f" (profiled wall {wall:.3f} s)"}


def check_table3(scen, t3, ref, got, wall, note):
    """Print Table 3 per row (event budget, the event-loop kernel that
    ran as the wrapper counts it, launches, host ms, device ms from the
    profiled pass ``note``, T, tau, theta) and fail on any T or tau that
    differs from the reference's.  The profiled qn_event launches go to
    the rows in order only when the profiler saw as many as the wrapper
    counted, else no row's device ms is measured; a row whose profiled
    kernels differ from those the wrapper counted fails."""
    diff = scen.mismatches(ref, t3)
    qn_events = [e for e in note["events"]
                 if e[1] in QN_ROUTE_KERNELS]
    measured = len(qn_events) == got["qn_event"]
    names = iter(qn_events)
    rows = []
    for r in t3["rows"]:
        dev_ms = None
        if measured:
            mine = [next(names) for _ in range(r["launches"])]
            dev_ms = sum(m[2] for m in mine)
            seen = dict(collections.Counter(m[1] for m in mine))
            if seen != r["kernels"]:
                fail(f"Table 3 row {r['row']}: the profiler saw {seen}, "
                     f"the wrapper counted {r['kernels']}")
        rows.append({k: r[k] for k in ("row", "events", "max_slots",
                                       "kernels", "launches", "qn_s",
                                       "cluster_sim_s", "T_ms", "tau_ms",
                                       "theta_pct")}
                    | {"device_ms": dev_ms})
        print(f"[table3] row {r['row']} {r['query']} {r['users']}u "
              f"{r['cores']} cores {r['n_map']}/{r['n_reduce']} tasks: "
              f"E={r['events']} S={r['max_slots']} kernels {r['kernels']}, "
              f"{r['launches']} launches, qn {r['qn_s'] * 1e3:.3f} ms "
              f"(device {'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}"
              f"), cluster_sim {r['cluster_sim_s'] * 1e3:.1f} ms (host); T "
              f"{r['T_ms']!r} tau {r['tau_ms']!r} theta "
              f"{r['theta_pct']:+.2f}%", flush=True)
    host_s = sum(r["cluster_sim_s"] for r in t3["rows"])
    qn_s = sum(r["qn_s"] for r in t3["rows"])
    dev = (f"{sum(m[2] for m in qn_events) / 1e3:.3f} s" if measured else
           f"not measured (the profiler saw {len(qn_events)} of "
           f"{got['qn_event']} launches)")
    print(f"[table3] mean |theta| {t3['mean_abs_theta_pct']:.2f}% max "
          f"{t3['max_abs_theta_pct']:.2f}% (paper {PAPER_THETA['mean']}% / "
          f"{PAPER_THETA['max']}%); wall {wall:.3f} s (without the "
          f"profiler): cluster_sim (host) {host_s:.3f} s "
          f"({100 * host_s / wall:.1f}%), the QN calls {qn_s:.3f} s "
          f"({100 * qn_s / wall:.1f}%), of which qn_event on the device "
          f"{dev} (profiled pass: {note['text']}); launches {got}",
          flush=True)
    print(f"[table3] against the reference: "
          f"{'equal' if not diff else diff}", flush=True)
    if diff:
        fail(f"Table 3 differs from the reference at {diff}")
    check_launches("table3", got, sum(r["launches"] for r in t3["rows"]),
                   False)
    if got["qn_event"] != 2 * len(t3["rows"]):
        fail(f"Table 3: {got['qn_event']} qn_event launches for "
             f"{len(t3['rows'])} rows of 2 replications")
    return rows


def check_serving_qn(scen, label, sq, got, wall):
    """The serving analogue's numbers: tau from the engine's profiled
    round time (two qn_event launches), the engine's closed-loop T, theta
    (recorded beside the paper's band, not gated), and one flash launch a
    layer a prefill."""
    tau = scen.serving_tau(sq["solo_latency_ms"],
                           n_requests=sq["n_requests"], slots=sq["slots"],
                           device=torch.device("cuda", 0))
    band = PAPER_THETA["serving_band"]
    inside = abs(sq["theta_pct"]) <= band
    print(f"[serving-qn] {label} {sq['arch']} ({sq['n_layers']} layers, "
          f"d_model {sq['d_model']}; {sq['n_requests']} requests, "
          f"{sq['slots']} slots, prompt {sq['prompt_len']}, gen "
          f"{sq['gen_len']}): solo {sq['solo_latency_ms']:.3f} ms, tau "
          f"{sq['qn_tau_ms']:.3f} ms, T {sq['engine_T_ms']:.3f} ms, theta "
          f"{sq['theta_pct']:+.2f}% ({'inside' if inside else 'outside'} the "
          f"paper's +-{band:g}%); wall {wall:.3f} s (profile "
          f"{sq['profile_s']:.3f}, qn {sq['qn_s']:.3f}, closed loop "
          f"{sq['closed_loop_s']:.3f}); {sq['prefills']} prefills; "
          f"launches {got}", flush=True)
    if tau != sq["qn_tau_ms"] or not all(
            np.isfinite(sq[k]) and sq[k] > 0 for k in
            ("solo_latency_ms", "qn_tau_ms", "engine_T_ms")):
        fail(f"serving-qn {label}: malformed numbers {sq} (tau again: "
             f"{tau})")
    if got["qn_event"] != 2 or got["event_streams"] != 2 or got["amva"] \
            or got["amva_tensors"] or got["mva"] or got["ssd_scan"] or \
            got["dag_event"] or \
            got["dag_streams"] or \
            got["flash_attention"] != sq["n_layers"] * sq["prefills"]:
        fail(f"serving-qn {label}: launches {got}, expected 2 qn_event and "
             f"{sq['n_layers']} flash_attention a prefill")


# ------------------------------------------------------------------ DAG
# the DAG event loop's checks against its plain version: chains of 1..4
# stages in one exponential-mode batch (padded to the stage bucket, 4),
# 4-stage chains of several sizes in replay mode (a replay batch shares
# its stage count); lane 3 pads (zero budget), lane 1 has one slot, lane 4
# a third of the budget
DAG_E = 4096
DAG_CHAINS = {False: [(6,), (8, 4), (10, 4, 2), (6, 5, 3, 2), (12, 6, 3, 1),
                      (5, 5), (7,), (9, 3, 3)],
              True: [(6, 5, 3, 2), (12, 6, 3, 1), (4, 4, 4, 4), (8, 2, 2, 2),
                     (6, 5, 3, 2), (3, 3, 3, 3), (9, 4, 2, 1), (5, 5, 5, 5)]}
DAG_CAPS = [64, 1, 17, 40, 3, 64, 8, 2]
DAG_WIDE_CAPS = [512, 1, 300, 512, 3, 256, 33, 2]
DAG_NEA = [DAG_E, DAG_E, DAG_E, 0, DAG_E // 3, DAG_E, DAG_E, DAG_E]
# past the card's 227 KB of shared memory a lane: 32768 slots (two blocks
# of 1024 slot words a thread and the free masks), the scratch route
DAG_SCRATCH_SLOTS = 32768
DAG_SCENARIOS = ("dag_sweep", "spark_dag_plan")
# dag_event_fast's instances, by the slots a thread holds and the mode
DAG_FAST_INSTANCES = tuple(f"dag_event_fast<{w}, {r}>" for w in (4, 8, 16)
                           for r in ("false", "true"))
# the draw tables' threefry calls at least (csrc/dag_streams.cu): per
# event 4 (exponential mode: key_i, its bits, the think key, its bits) or 7
# (replay mode: key_i, split(key_i)'s two halves and their bits, the think
# key, its bits); per lane the two halves of split(key); per user its bits
DAG_THREEFRY_PER_EVENT = {False: 4, True: 7}
# the draw-table kernel's edges, each against one plain run in both modes:
# (B, E, H, n_samples) -- E ragged against its runs of 4 events, one event,
# H = 2049, more lanes than a block's tile of runs, one replay sample
DAG_STREAMS_EDGES = [(3, 4097, 5, 97), (1, 1, 1, 1), (2, 3, 2049, 5),
                     (300, 2, 1, 3)]
# the AMVA frontier entry's checks: (VM slots, points) from nu = 20
AMVA_FRONTIERS = [(8, 1), (8, 97), (20, 97), (20, 8192)]


def dag_threefries(root) -> dict:
    """The draw-table kernel's threefry calls per event, by mode, counted
    in its source: the calls in ``exponential_event`` and
    ``replay_event`` (csrc/dag_streams.cu)."""
    src = open(os.path.join(root, "src", "repro_torch", "csrc",
                            "dag_streams.cu")).read()
    out = {}
    for replay, fn in ((False, "exponential_event"), (True, "replay_event")):
        body = re.search(rf"void {fn}\([^)]*\) \{{(.*?)\n\}}", src, re.S)
        out[replay] = len(re.findall(r"\b(?:derive|bits_at|threefry2x32)\(",
                                     body[1])) if body else None
    return out


def dag_lanes(dev, gen, chains, caps, nea, think):
    """The DAG event loop's per-lane inputs: ``(n_tasks, t_avg, n_stages,
    slots_cap, n_events_active, think_ms)``, the chains padded to their
    stage bucket, task means drawn from ``gen``."""
    from repro_torch.core.shapes import bucket_stages
    B, K = len(chains), bucket_stages(max(map(len, chains)))
    nt = np.zeros((B, K), np.int32)
    ta = np.zeros((B, K), np.float32)
    for b, c in enumerate(chains):
        nt[b, :len(c)] = c
        ta[b, :len(c)] = gen.uniform(20, 90, len(c))
    t = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt, device=dev)
    return (t(nt, torch.int32), t(ta, torch.float32),
            t([len(c) for c in chains], torch.int32),
            t(caps, torch.int32), t(nea, torch.int32),
            t(gen.uniform(*think, B), torch.float32))


def check_dag(dev, dag_ops, dag_ref, build, gen):
    """[dag] both kernels against their plain versions on the card:
    dag_streams torch.equal in both modes, dag_event bit-identical at E =
    DAG_E on the mixed lanes (H = 1 and 3, both modes; replay lists with
    fewer rows than the chains' stages, whose row clamps), at H = 32 and
    S = 512 (the fast route's widest lanes, exponential mode, and
    tie-heavy: one repeated sample, whole-second think clocks), at H =
    2049 (opt-in shared memory) and past the card's shared memory (the
    scratch route).  Each check holds every route the batch can take (the
    one ``route`` names and, where that is dag_event_fast, the general
    one asked for) against one plain run; every lane with a budget
    finishes jobs past its warm-up, a padding lane none.  Returns ``(max
    abs err of dag_event, of dag_streams, the shapes checked)``."""
    err = {"dag_event": 0.0, "dag_streams": 0.0}
    checked = []

    def one(tag, lanes, H, S, smp, seeds, tie=False):
        ns = None if smp is None else smp.shape[1]
        kw = dict(h_users=H, n_events=DAG_E, n_samples=ns)
        tables = dag_ops.dag_streams(lanes[5], seeds, lanes[4], **kw)
        want = dag_ref.dag_streams(lanes[5], seeds, lanes[4], **kw)
        if not all(torch.equal(a, b) for a, b in zip(tables, want)):
            fail(f"dag_streams differs from its plain version ({tag})")
        err["dag_streams"] = max([err["dag_streams"]] + [
            float((a.double() - b.double()).abs().max()) for a, b in
            zip(tables, want) if a.numel()])
        if tie:             # whole-second think clocks: thinks tie too
            tables = (torch.round(tables[0] / 1e3) * 1e3, *tables[1:])
        ek = dict(max_slots=S, warmup_jobs=2)
        ps, pc = dag_ref.dag_event(*lanes, *tables, smp, **ek)
        K = lanes[0].shape[1]
        took = []
        for general in (False, True):
            r = dag_ops.route(H, S, K, DAG_E, general)
            if r in took:
                continue
            before = dict(dag_ops.dag_event.routes)
            ks, kc = dag_ops.dag_event(*lanes, *tables, smp, general=general,
                                       **ek)
            moved = {k: v - before[k] for k, v in
                     dag_ops.dag_event.routes.items()}
            if moved != {k: int(k == r) for k in moved}:
                fail(f"dag_event ({tag}) took {moved}, not {r}")
            same = torch.equal(ks, ps) and torch.equal(kc, pc)
            err["dag_event"] = max(err["dag_event"],
                                   float((ks - ps).abs().max()),
                                   float((kc - pc).abs().max()))
            if not same:
                fail(f"dag_event differs from its plain version ({tag}, {r})")
            took.append(r)
        checked.append(tag)
        print(f"[dag] check {tag}: dag_streams bit-identical=True, "
              f"dag_event bit-identical=True on {' and '.join(took)}, jobs "
              f"past the warm-up {pc.tolist()}", flush=True)
        live = lanes[4] > 0
        if bool((pc[live] <= 0).any()) or bool((pc[~live] != 0).any()):
            fail(f"dag_event ({tag}): a lane with a budget finished no job "
                 f"past its warm-up, or a padding lane reported one")

    seeds = torch.arange(len(DAG_CAPS), device=dev) * 1000 + 1
    for replay in (False, True):
        smp = torch.tensor(gen.lognormal(np.log(50.0), 0.4, (4, 97)),
                           dtype=torch.float32, device=dev) \
            if replay else None
        for H in (1, 3):
            lanes = dag_lanes(dev, gen, DAG_CHAINS[replay], DAG_CAPS,
                              DAG_NEA, (500.0, 4000.0))
            one(f"B=8 E={DAG_E} S=64 H={H} K={int(lanes[2].max())} mixed "
                f"lanes replay={replay}", lanes, H, 64, smp, seeds)
        if replay:          # fewer sample rows than stages: the gather clamps
            one(f"B=8 E={DAG_E} S=64 H=3 K=4 replay=True from 2 sample "
                f"rows (the row clamps)", lanes, 3, 64, smp[:2], seeds)
        # the fast route's widest lanes: 32 users, 512 slots; in replay
        # mode tie-heavy (every sample 50 ms, whole-second think clocks),
        # so that arrivals and completions tie and the queue key's rank
        # and user fields decide
        lanes = dag_lanes(dev, gen, DAG_CHAINS[replay], DAG_WIDE_CAPS,
                          DAG_NEA, (500.0, 4000.0))
        one(f"B=8 E={DAG_E} S=512 H=32 K={int(lanes[2].max())} "
            + ("tie-heavy replay (one repeated sample)" if replay else
               "mixed lanes replay=False"), lanes, 32, 512,
            torch.full((4, 97), 50.0, device=dev) if replay else None,
            seeds, tie=replay)
        # H = 2049 users: the state in opt-in shared memory; long thinks
        lanes = dag_lanes(dev, gen, DAG_CHAINS[replay][2:4], [64, 7],
                          [DAG_E, DAG_E], (1.0e5, 2.0e5))
        one(f"B=2 E={DAG_E} S=64 H=2049 replay={replay}", lanes, 2049, 64,
            smp, seeds[:2])
    scratch = build.library().dag_event_scratch_bytes(3, DAG_SCRATCH_SLOTS)
    if scratch <= 0:
        fail(f"dag_event at {DAG_SCRATCH_SLOTS} slots does not take the "
             f"global scratch")
    lanes = dag_lanes(dev, gen, DAG_CHAINS[True][:2], [DAG_SCRATCH_SLOTS, 5],
                      [DAG_E, DAG_E], (500.0, 4000.0))
    one(f"B=2 E={DAG_E} S={DAG_SCRATCH_SLOTS} H=3 replay=True (global "
        f"scratch, {scratch} bytes a lane)", lanes, 3, DAG_SCRATCH_SLOTS,
        smp, seeds[:2])

    # the draw-table kernel at its edges, both modes; seeds outside int32
    # (the kernel takes them modulo 2**32: the plain version gets the same
    # words as int32 seeds)
    for B, E, H, NS in DAG_STREAMS_EDGES:
        sd = gen.integers(-2 ** 40, 2 ** 40, B)
        words = (sd % 2 ** 32 + 2 ** 31) % 2 ** 32 - 2 ** 31
        nea = torch.tensor(gen.integers(0, 2 * E + 1, B), dtype=torch.int32,
                           device=dev)
        nea[0] = 0
        tm = torch.tensor(gen.uniform(100, 5000, B), dtype=torch.float32,
                          device=dev)
        for replay in (False, True):
            kw = dict(h_users=H, n_events=E, n_samples=NS if replay else None)
            got = dag_ops.dag_streams(tm, torch.tensor(sd, device=dev), nea,
                                      **kw)
            want = dag_ref.dag_streams(tm, torch.tensor(words, device=dev),
                                       nea, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"dag_streams differs from its plain version at B={B} "
                     f"E={E} H={H} replay={replay}")
    checked.append(f"dag_streams edges (B, E, H, n_samples) "
                   f"{DAG_STREAMS_EDGES}, both modes, seeds outside int32")
    print(f"[dag] check dag_streams at its edges (B, E, H, n_samples) "
          f"{DAG_STREAMS_EDGES}, both modes, seeds outside int32: "
          f"bit-identical=True", flush=True)

    # the combined entry (sim_batch: both kernels from one C entry point)
    # against the two wrappers and the plain versions, on the mixed lanes
    # and on lanes deeper than their stage arrays (40 and 5 stages over K
    # = 4; replay lists of 6 rows, so a deep stage's row passes K: the
    # general route, from the depth the caller reads on the host or from
    # the lanes)
    def combined(tag, lanes, smp, want_route, depth):
        ns = None if smp is None else smp.shape[1]
        sk = dict(h_users=3, n_events=DAG_E, n_samples=ns)
        seeds_c = seeds[:lanes[0].shape[0]]
        ek = dict(max_slots=64, warmup_jobs=2)
        ps, pc = dag_ref.dag_event(*lanes, *dag_ref.dag_streams(
            lanes[5], seeds_c, lanes[4], **sk), smp, **ek)
        before = (dag_ops.dag_streams.launches,
                  dict(dag_ops.dag_event.routes))
        mean, cnt = dag_ops.sim_batch(
            lanes[0], lanes[1], lanes[2], lanes[5], lanes[3], seeds_c,
            lanes[4], smp, h_users=3, n_events=DAG_E, depth=depth, **ek)
        s2, c2 = dag_ops.dag_event(*lanes, *dag_ops.dag_streams(
            lanes[5], seeds_c, lanes[4], **sk), smp, depth=depth, **ek)
        moved = {k: v - before[1][k] for k, v in
                 dag_ops.dag_event.routes.items()}
        if dag_ops.dag_streams.launches - before[0] != 2 or moved != {
                k: 2 * int(k == want_route) for k in moved}:
            fail(f"sim_batch ({tag}) launched {moved}, not {want_route}")
        if not (torch.equal(cnt, pc) and torch.equal(c2, pc)
                and torch.equal(s2, ps) and torch.equal(
                    mean, ps / torch.clamp(pc, min=1.0))
                and bool(torch.isfinite(ps).all())):
            fail(f"sim_batch or dag_event differs from the plain version "
                 f"({tag})")
        checked.append(f"sim_batch {tag}")
        print(f"[dag] check sim_batch {tag}: one entry point, bit-identical "
              f"to dag_streams then dag_event and the plain version=True on "
              f"{want_route}; jobs {pc.tolist()}", flush=True)

    for replay in (False, True):
        smp = torch.tensor(gen.lognormal(np.log(50.0), 0.4, (4, 97)),
                           dtype=torch.float32, device=dev) \
            if replay else None
        lanes = dag_lanes(dev, gen, DAG_CHAINS[replay], DAG_CAPS, DAG_NEA,
                          (500.0, 4000.0))
        combined(f"B=8 E={DAG_E} S=64 H=3 mixed lanes replay={replay}",
                 lanes, smp, "dag_event_fast", int(lanes[2].max()))
        deep = dag_lanes(dev, gen, [(6, 3, 2, 2)] * 4, [64, 7, 17, 3],
                         [DAG_E] * 4, (500.0, 4000.0))
        deep = deep[:2] + (torch.tensor([40, 4, 5, 2], dtype=torch.int32,
                                        device=dev),) + deep[3:]
        for depth in (40, None):
            combined(f"B=4 E={DAG_E} S=64 H=3 lanes of 40 and 5 stages over "
                     f"K=4 replay={replay}"
                     + (" from 6 sample rows" if replay else "")
                     + ", depth "
                     f"{'from the host' if depth else 'read on the card'}",
                     deep, None if smp is None else torch.cat([smp, smp[:2]]),
                     "dag_event_general", depth)
    return err["dag_event"], err["dag_streams"], checked


def check_dag_scenario(scen, name, out, ref, got, n_disp, wall):
    """Print a DAG scenario's decisions beside the reference's and fail on
    any difference (exponential mode: response times within a relative
    1e-3; decisions, dispatch counts and flags exact)."""
    diff = scen.mismatches(ref, out, rel=1e-3)
    print(f"[dag] {name}: wall {wall:.3f} s, {n_disp} dispatches, "
          f"launches {got}", flush=True)
    plans = out.get("optimizer", out)
    if name == "dag_sweep":
        fr = out["frontier"]
        print(f"[dag] dag_sweep frontier ({fr['points']} points): "
              f"dispatches {fr['scalar_dispatches']} -> "
              f"{fr['batched_dispatches']}, scalar = batched bit for bit: "
              f"{fr['parity_bit_exact']}, scalar {fr['scalar_s']:.3f} s, "
              f"batched {fr['batched_s']:.3f} s; predicted_ms "
              f"{fr['predicted_ms']}", flush=True)
        print(f"[dag] dag_sweep dispatch_ratio {out['dispatch_ratio']:.2f}"
              f" (reference {ref['dispatch_ratio']:.2f}), nu_agree "
              f"{out['nu_agree']} (reference {ref['nu_agree']})", flush=True)
    for mode, r in plans.items():
        print(f"[dag] {name} {mode}: {r['dispatches']} dispatches, "
              f"{r['evals']} evals, cost {r['cost']}, wall "
              f"{r['wall_s']:.3f} s, decisions {json.dumps(r['classes'])}; "
              f"reference {ref.get('optimizer', ref)[mode]['dispatches']} "
              f"dispatches, {json.dumps(ref.get('optimizer', ref)[mode]['classes'])}",
              flush=True)
    print(f"[dag] {name} against the reference: "
          f"{'equal' if not diff else diff}", flush=True)
    if diff:
        fail(f"{name} differs from the reference at {diff}")
    check_launches(name, got, n_disp, name == "spark_dag_plan", dag=True)
    if name == "spark_dag_plan" and got["qn_event"] <= 0:
        fail("spark_dag_plan: its MapReduce class launched no qn_event")


# ----------------------------------------------------- the solver service
# the service's drives (benchmarks/torch_scenarios.py), in the order they
# run; the Q1 tenants replay their lists (exact), the rest draw
# exponentials (response times within a relative 1e-3)
SERVICE_DRIVES = ("service_throughput", "serve_many", "spark_dag_service",
                  "q1_tenants")


def event_loops(counted) -> tuple:
    """(qn_event, dag_event) launches of a planner_counts dict."""
    return (sum(counted[k] for k in QN_ROUTE_KERNELS),
            counted["dag_event_fast"] + counted["dag_event_kernel"])


def check_service(dev, scen, kernels, launches, qn_routes, dag_routes):
    """[service] the multi-tenant solver service on the card: each drive
    with the launch counts set to 0 before it, its numbers against the
    reference's, its launches by route, and the service phase's event-loop
    launches one a fused dispatch; then the Q1 tenants once more under the
    profiler.  Adds the launches to the three totals; returns the drives'
    record."""
    from repro_torch.core import qn_sim
    from repro_torch.kernels.dag_event import ops as dag_ops
    from repro_torch.kernels.qn_event import ops as qn_ops

    wrappers = tuple(kernels.values())
    counts = lambda: planner_counts(kernels)
    runs = {}
    for name in SERVICE_DRIVES:
        kw = {} if name == "serve_many" else {"counts": counts}
        if name == "service_throughput":
            kw.update(trace=True, http=True)
        reset_launches(*wrappers)
        qn_sim.reset_sim_stats()
        t0 = time.perf_counter()
        out = scen.SCENARIOS[name](dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: w.launches for k, w in kernels.items()}
        for k, n in got.items():
            launches[k] += n
        for r, n in qn_ops.qn_event.routes.items():
            qn_routes[r] += n
        for r, n in dag_ops.dag_event.routes.items():
            dag_routes[r] += n
        n_disp = qn_sim.sim_stats()["dispatches"]
        ref = REFERENCE["service"][name]
        diff = scen.mismatches(ref, out,
                               rel=0.0 if name == "q1_tenants" else 1e-3)
        svc = out.get("service", out)
        timing = out.get("timing")
        sched = svc["scheduler"]
        phases = out.get("launches", {"service": counts()})
        by_route = {ph: {k: n for k, n in c.items() if n}
                    for ph, c in phases.items()}
        print(f"[service] {name}: wall {wall:.3f} s (host clock, ending in "
              f"torch.cuda.synchronize()), {n_disp} dispatches; service "
              f"{svc['rounds']} rounds, {sched['fused_dispatches']} fused "
              f"dispatches, points requested {sched['points_requested']}, "
              f"dispatched {sched['points_dispatched']}, cached "
              f"{svc['points_cached']}, deduplicated "
              f"{svc['points_deduped']}; cache {svc['cache']['entries']} "
              f"entries, hit rate {svc['cache']['hit_rate']:.4f}; "
              f"peak_inflight_events "
              f"{svc['admission']['peak_inflight_events']}; launches by "
              f"phase and route {by_route}", flush=True)
        if timing is not None:
            rm = timing["round_ms"]
            print(f"[service] {name}: service.run wall "
                  f"{timing['wall_s']:.4f} s, service.round_ms mean "
                  f"{rm['mean']:.3f} max {rm['max']:.3f} over {rm['count']} "
                  f"rounds", flush=True)
        for jid, job in svc["jobs"].items():
            print(f"[service] {name} {jid} ({job['tenant']}): "
                  f"{job['state']} {json.dumps(job['classes'])}",
                  flush=True)
        print(f"[service] {name} against the reference: "
              f"{'equal' if not diff else diff}", flush=True)
        if diff:
            fail(f"{name} differs from the reference at {diff}")
        check_launches(name, got, n_disp, False,
                       dag=name == "spark_dag_service")
        qn_n, dag_n = event_loops(phases["service"])
        if qn_n + dag_n != sched["fused_dispatches"]:
            fail(f"{name}: the service launched {qn_n} qn_event and {dag_n} "
                 f"dag_event kernels for {sched['fused_dispatches']} fused "
                 f"dispatches")
        if dag_routes["dag_event_general"]:
            fail(f"{name}: a DAG lane took dag_event_kernel")
        if name == "service_throughput":
            tr, sc = out["trace"], out["scrape"]
            print(f"[service] service_throughput: solo dispatches "
                  f"{out['solo_dispatches']} (the 8 solo runs' wall "
                  f"{out['solo_wall_s']:.4f} s) -> service "
                  f"{out['service_dispatches']} ({timing['wall_s']:.4f} s), "
                  f"warm "
                  f"{out['warm_dispatches']} dispatches and launches "
                  f"{by_route['warm']}, hit rate {out['warm_hit_rate']}; "
                  f"parity with solo (bit for bit) {out['parity']}, warm "
                  f"{out['warm_parity']}; /statz split {sc['split']} against "
                  f"the scheduler's {sc['scheduler']}; /metrics "
                  f"{sc['metric_families']} families parsed; trace "
                  f"{tr['chrome_events']} Chrome events, chain "
                  f"{' -> '.join(tr['deepest_kernel_chain'])}", flush=True)
            if not (out["parity"] and out["warm_parity"]) or \
                    any(phases["warm"].values()) or \
                    tr["deepest_kernel_chain"][-1] != "kernel:cuda":
                fail("service_throughput: parity, the warm resubmission's "
                     "launches or the trace chain")
        if name == "spark_dag_service":
            if not (qn_n and dag_n) or out["solo_equal"] != [True, True]:
                fail(f"spark_dag_service: qn_event {qn_n}, dag_event "
                     f"{dag_n}, decisions equal to the solo run's "
                     f"{out['solo_equal']}")
        if name == "q1_tenants":
            print(f"[service] q1_tenants: solo walls "
                  f"{out['solo_wall_s']:.3f} s for dispatches "
                  f"{out['solo_dispatches']}; every job equal to its solo "
                  f"run bit for bit: {out['solo_equal']}", flush=True)
            if out["solo_equal"] != [True] * len(out["solo_equal"]):
                fail("q1_tenants: a job differs from its solo run")
        runs[name] = {"wall_s": wall, "dispatches": n_disp,
                      "solo_wall_s": out.get("solo_wall_s"),
                      "timing": timing, "launches": got,
                      "launches_by_phase_and_route": by_route}

    # serve_many and the Q1 tenants' service (no solo runs) once more under
    # the profiler: each kernel's device time, against the service's wall
    # without the profiler (the rest is the host's marshaling, the rounds'
    # bookkeeping and the one read-back a round)
    for name, fn in (("serve_many", lambda: scen.serve_many(dev)),
                     ("q1_tenants", lambda: scen.q1_tenants(dev,
                                                            solo=False))):
        counted = runs[name]["launches_by_phase_and_route"]["service"]
        counted = {k: counted.get(k, 0) for k in counts()}
        _, dev_ms, note = profiled_pass(kernels, fn, counted, name)
        wall = runs[name]["timing"]["wall_s"]
        busy = sum(e[2] for e in note["events"]) / 1e3
        print(f"[service] {name} profiled again: {note['text']}; the "
              f"kernels' device time {1e3 * busy:.3f} ms is "
              f"{100 * busy / wall:.2f}% of the {wall:.4f} s service wall "
              f"without the profiler; host and the rest "
              f"{wall - busy:.4f} s", flush=True)
        runs[name].update(profiled_device_ms=dev_ms,
                          profiled_wall_s=note["wall_s"],
                          kernels_device_s=busy,
                          kernels_share_of_service_wall=busy / wall,
                          host_s=wall - busy)
    return runs


# --------------------------------------------------------- private cloud
# the private-cloud drives (benchmarks/torch_scenarios.py), in the order
# they run: benchmarks/private_cloud.py at its full size with its day on
# the over-committed cluster (exponential mode: response times within a
# relative 1e-3), then the §4.3 classes Q1 and Q3 in one problem (replay
# mode: exact)
CLOUD_DRIVES = {"bench": 1e-3, "real": 0.0}


def check_cloud(dev, scen, kernels, launches, qn_routes, dag_routes):
    """[cloud] the private-cloud plane on the card: each drive with the
    launch counts set to 0 before it, its numbers against
    REFERENCE["cloud"], its launches by route; every packing the drives
    checked on the card (each ``feasibility_batch`` call is recorded) held
    against the CPU version of the check; then the over-committed day and
    the real-size private ``run()`` once more, timed by layer (the host's
    packers and checks against the kernels' device time from a profiled
    pass).  Adds the launches to the three totals; returns the record."""
    from repro_torch.cloud import PrivateCloud, homogeneous_hosts, joint, \
        placement, windows
    from repro_torch.core import qn_sim
    from repro_torch.core.optimizer import DSpace4Cloud
    from repro_torch.kernels.dag_event import ops as dag_ops
    from repro_torch.kernels.qn_event import ops as qn_ops

    wrappers = tuple(kernels.values())
    counts = lambda: planner_counts(kernels)
    checked = []                 # (inputs, the card's mask) of every check
    host = {}
    feasibility, pack = placement.feasibility_batch, placement.pack

    def recorded_feasibility(*args, device=None):
        t0 = time.perf_counter()
        mask = feasibility(*args, device=device)
        host["check_s"] += time.perf_counter() - t0
        host["checks"] += 1
        if torch.device(device).type != "cuda":
            fail(f"a packing was checked on {device}, not on the card")
        checked.append(([np.array(a, copy=True) for a in args], mask))
        return mask

    def timed_pack(*args, **kw):
        t0 = time.perf_counter()
        out = pack(*args, **kw)
        host["pack_s"] += time.perf_counter() - t0
        host["packs"] += 1
        return out

    def reset_host():
        host.update(pack_s=0.0, packs=0, check_s=0.0, checks=0)

    hooks = [(placement, "feasibility_batch", recorded_feasibility),
             (windows, "feasibility_batch", recorded_feasibility),
             (joint, "pack", timed_pack), (windows, "pack", timed_pack)]
    saved = [(m, a, getattr(m, a)) for m, a, _ in hooks]
    for m, a, f in hooks:
        setattr(m, a, f)
    runs = {}
    try:
        for name, rel in CLOUD_DRIVES.items():
            reset_launches(*wrappers)
            qn_sim.reset_sim_stats()
            reset_host()
            n_checked = len(checked)
            t0 = time.perf_counter()
            out = scen.private_cloud_bench(dev) if name == "bench" else \
                scen.private_cloud_real(dev, counts=counts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: w.launches for k, w in kernels.items()}
            for k, n in got.items():
                launches[k] += n
            for r, n in qn_ops.qn_event.routes.items():
                qn_routes[r] += n
            for r, n in dag_ops.dag_event.routes.items():
                dag_routes[r] += n
            by_route = {k: n for k, n in counts().items() if n}
            n_disp = qn_sim.sim_stats()["dispatches"]
            diff = scen.mismatches(REFERENCE["cloud"][name], out, rel=rel)
            print(f"[cloud] {name}: wall {wall:.3f} s (host clock, ending "
                  f"in torch.cuda.synchronize()), {n_disp} dispatches, "
                  f"launches by kernel and route {by_route}; walls "
                  f"{json.dumps({k: round(v, 4) for k, v in out['walls'].items()})}"
                  f"; the host's packers {host['pack_s']:.4f} s over "
                  f"{host['packs']} packs, feasibility checks "
                  f"{host['check_s']:.4f} s over {host['checks']} calls "
                  f"(each one read-back)", flush=True)
            for plan in ("private", "run", "run_fast", "run_pointwise",
                         "service_private"):
                if plan in out:
                    dep = out[plan]["deployment"]
                    print(f"[cloud] {name} {plan}: {out[plan]['qn_dispatches']}"
                          f" dispatches, decisions "
                          f"{json.dumps(out[plan]['classes'])}; deployment "
                          f"{json.dumps(dep)}", flush=True)
            print(f"[cloud] {name} against the reference: "
                  f"{'equal' if not diff else diff}", flush=True)
            if diff:
                fail(f"cloud {name} differs from the reference at {diff}")
            check_launches(f"cloud {name}", got, n_disp, True)
            if name == "bench":
                un = out["unbounded"]
                ratios = {d: out[d]["qn_dispatches"]
                          / out["single_window_dispatches"]
                          for d in ("day", "day_private")}
                print(f"[cloud] bench: unbounded run_fast bit-exact with the "
                      f"public one {un['bit_exact']} (coordinated "
                      f"{un['coordinated']}); the 24-window day "
                      f"{out['day']['qn_dispatches']} dispatches in "
                      f"{out['day']['rounds']} rounds, on the over-committed "
                      f"cluster {out['day_private']['qn_dispatches']} in "
                      f"{out['day_private']['rounds']}, against one window's "
                      f"{out['single_window_dispatches']} (ratios {ratios}; "
                      f"the reference's own); windows_feasible from the card "
                      f"{out['day_private']['windows_feasible']}", flush=True)
                if not un["bit_exact"] or un["coordinated"]:
                    fail("the unbounded cluster's run_fast differs from the "
                         "public one")
            else:
                svc = out["service"]
                phases = {ph: {k: n for k, n in c.items() if n}
                          for ph, c in out["launches"].items()}
                print(f"[cloud] real: demand {out['demand_cores']} cores, "
                      f"cluster {out['capacity_cores']} cores; the service "
                      f"{svc['rounds']} rounds, {svc['scheduler']} , "
                      f"admission {svc['admission']}; the private job equal "
                      f"to its solo run() bit for bit "
                      f"{out['service_equal_solo']}; service.run wall "
                      f"{out['timing']['wall_s']:.4f} s; launches by phase "
                      f"and route {phases}", flush=True)
                if not out["service_equal_solo"]:
                    fail("the service's private job differs from its solo "
                         "run")
                qn_n, dag_n = event_loops(out["launches"]["service"])
                if qn_n + dag_n != svc["scheduler"]["fused_dispatches"]:
                    fail(f"cloud real: the service launched {qn_n + dag_n} "
                         f"event loops for "
                         f"{svc['scheduler']['fused_dispatches']} fused "
                         f"dispatches")
            runs[name] = {"wall_s": wall, "dispatches": n_disp,
                          "launches": got, "launches_by_route": by_route,
                          "walls": out["walls"],
                          "host_packers_s": host["pack_s"],
                          "packs": host["packs"],
                          "feasibility_s": host["check_s"],
                          "feasibility_calls": host["checks"],
                          "packings_checked": len(checked) - n_checked}

        # every packing the drives checked on the card, against the CPU
        rows = 0
        for args, mask in checked:
            cpu = feasibility(*args, device="cpu")
            rows += len(mask)
            if mask.dtype != np.bool_ or mask.tolist() != cpu.tolist():
                fail(f"feasibility_batch on the card {mask.tolist()} != "
                     f"its CPU version {cpu.tolist()} (shapes "
                     f"{[a.shape for a in args]})")
        shapes = collections.Counter(tuple(args[0].shape)
                                     for args, _ in checked)
        print(f"[cloud] feasibility_batch: {len(checked)} calls, {rows} "
              f"packings, every mask on the card equal to its CPU version "
              f"(shapes (B, V) by count: {dict(shapes.most_common(8))})",
              flush=True)

        # where the time goes: the over-committed day and the real-size
        # private run(), each driven once, then once more under the
        # profiler for the kernels' device time
        bench, real = REFERENCE["cloud"]["bench"], REFERENCE["cloud"]["real"]
        day_cloud = PrivateCloud(hosts=homogeneous_hosts(
            bench["capacity_cores"] // 4, 4, energy_cost_per_h=0.3))
        day_prob = scen.private_cloud_problem(3)
        day = {c.name: scen.DAY_LEVELS for c in day_prob.classes}
        real_prob, real_samples = scen.real_cloud_problem()
        real_cloud = PrivateCloud(hosts=homogeneous_hosts(
            real["capacity_cores"] // scen.REAL_HOST_CORES,
            scen.REAL_HOST_CORES, energy_cost_per_h=scen.REAL_ENERGY_PER_H))
        layered = {
            "day_private": lambda: windows.plan_day(
                day_prob, day, deployment=day_cloud, device=dev,
                **scen.PRIVATE_CLOUD_KW),
            "real_run": lambda: DSpace4Cloud(
                real_prob, samples=real_samples, deployment=real_cloud,
                device=dev).run()}
        for name, fn in layered.items():
            reset_launches(*wrappers)
            reset_host()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            packers = dict(host)
            _, dev_ms, note = profiled_pass(kernels, fn, counts(), name)
            busy = sum(e[2] for e in note["events"]) / 1e3
            print(f"[cloud] {name}: wall {wall:.4f} s; the kernels "
                  f"{1e3 * busy:.3f} ms on the device "
                  f"({100 * busy / wall:.2f}% of the wall: {note['text']}); "
                  f"the host's packers {packers['pack_s']:.4f} s "
                  f"({100 * packers['pack_s'] / wall:.2f}%: {packers['packs']}"
                  f" packs, their feasibility checks {packers['check_s']:.4f}"
                  f" s over {packers['checks']} calls); the rest "
                  f"{wall - busy - packers['pack_s']:.4f} s", flush=True)
            runs[name] = {"wall_s": wall, "kernels_device_s": busy,
                          "profiled_device_ms": dev_ms,
                          "profiled_wall_s": note["wall_s"],
                          "host_packers_s": packers["pack_s"],
                          "packs": packers["packs"],
                          "feasibility_s": packers["check_s"],
                          "feasibility_calls": packers["checks"],
                          "rest_s": wall - busy - packers["pack_s"]}
    finally:
        for m, a, f in saved:
            setattr(m, a, f)
    runs["feasibility_calls_checked"] = len(checked)
    return runs


# [capacity] the route each QN dispatch of the drive must take, in the
# drive's order (the QN-verified plans of benchmarks/torch_scenarios.py's
# CAPACITY_SERVING, then the plan CLI's serve-qn), each lane's slots cut
# to those its users can fill (core/qn_sim.py slots_in_use; one map and
# one reduce a job, so one slot a session): the 32-session class at 32
# slots takes qn_event_fast, every class past 32 users qn_event_many (64,
# 256 and 336 slots, flat blocks).  Before the cut (ROUTES_BEFORE_CUT) the
# 32-session class took qn_event_wide at 1536 slots and the rest
# qn_event_general, chat-mamba2's 65536 slots in its global scratch
CAPACITY_ROUTES = ("qn_event_fast",) + ("qn_event_many",) * 5


def qn_lane_bound(B: int, E: int, H: int, S: int, active: int,
                  user_ops: int = None) -> tuple:
    """The least time of a qn_event launch of B lanes (E events, H users,
    S slots, ``active`` events in all): its tables and per-lane inputs read
    and outputs written once at the card's memory rate, or its events'
    instructions (a slot search of 2 log2 S and ``user_ops``, by default
    4 H a user's clocks, each) at one instruction a lane a clock.  Returns
    (ms, bytes, operations)."""
    nbytes = 4 * (3 * B * E + B * H + 9 * B)
    n_ops = active * (2 * max(1, (S - 1).bit_length())
                      + (4 * H if user_ops is None else user_ops))
    return (1e3 * max(nbytes / H100_BYTES_PER_S, n_ops / H100_INSTR_PER_S),
            nbytes, n_ops)


def many_lane_bound(B: int, E: int, H: int, S: int, active: int) -> tuple:
    """qn_lane_bound for qn_event_many's lanes (33 to 2048 users), whose
    step scans no user: an event's user search is that of a heap of the
    users, 2 log2 H (a pop and a push), as its slot search is 2 log2 S."""
    return qn_lane_bound(B, E, H, S, active,
                         user_ops=2 * max(1, (H - 1).bit_length()))


def many_floor_ns(redux_ns: float, ballot_ns: float, n_map: int,
                  n_reduce: int) -> float:
    """qn_event_many's least time a step from its collectives alone: every
    step opens with the queue's and the earliest end's reductions and the
    free slots' ballot, issued together (the longer of a redux and a
    ballot); a completion and a think end then wait on a second redux, the
    earliest end's thread and user.  A job of m maps and r reduces is m + r
    dispatches, m + r completions and one think end: (2(m + r) + 1) steps
    and (m + r + 1) second reductions."""
    n = n_map + n_reduce
    return max(redux_ns, ballot_ns) + (n + 1) * redux_ns / (2 * n + 1)


def check_capacity(dev, scen, kernels, launches, qn_routes):
    """[capacity] the TPU capacity planner on the card
    (``benchmarks/torch_scenarios.py`` ``capacity``: five serving classes
    planned by the KKT ranking and QN-verified, the training plans, the
    synthetic dry-run record through ``load_dryrun``,
    ``ElasticPlan.replan_capacity`` and the ``plan`` CLI), with the launch
    counts set to 0 before it: every number against
    REFERENCE["capacity"] (the QN plans' predicted_ms within a relative
    1e-3, the rest exact), each QN dispatch's route (``CAPACITY_ROUTES``;
    ``sim_batch`` is wrapped to record each call, ``qn_sim.slots_in_use``
    to record each lane's slots before the cut), each plan's wall; each
    lane that took qn_event_many once more: its draw tables against the
    plain version, the kernel on the cut lane against the plain version of
    the uncut lane and against qn_event_general asked for on the cut and
    on the uncut lane (past 16384 slots in its global scratch), bit for
    bit, and timed in turns against qn_event_general on the cut and on the
    uncut lane, beside its bound; then ``launch/qn_record``'s quick cells
    on the card, both implementations bit-identical.  Adds the launches to
    the totals; returns the record."""
    from repro_torch.core import qn_sim
    from repro_torch.core.shapes import bucket_slots
    from repro_torch.kernels import build
    from repro_torch.kernels.qn_event import ops as qn_ops
    from repro_torch.kernels.qn_event import ref as qn_ref
    from repro_torch.launch import qn_record, roofline

    wrappers = tuple(kernels.values())
    calls = []
    sim_batch = qn_ops.sim_batch
    slots_in_use = qn_sim.slots_in_use
    uncut = []

    def recording_slots_in_use(slots, *args):
        uncut.append(np.asarray(slots))
        return slots_in_use(slots, *args)

    def recording_sim_batch(*args, **kw):
        before = dict(qn_ops.qn_event.routes)
        out = sim_batch(*args, **kw)
        calls.append({"args": args, "kw": kw, "uncut": uncut[-1], "route": [
            r for r, n in qn_ops.qn_event.routes.items() if n > before[r]]})
        return out

    reset_launches(*wrappers)
    qn_sim.reset_sim_stats()
    qn_ops.sim_batch = recording_sim_batch
    qn_sim.slots_in_use = recording_slots_in_use
    t0 = time.perf_counter()
    try:
        got = scen.capacity(dev)
    finally:
        qn_ops.sim_batch = sim_batch
        qn_sim.slots_in_use = slots_in_use
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = {k: w.launches for k, w in kernels.items()}
    by_route = dict(qn_ops.qn_event.routes)
    for k, n in counted.items():
        launches[k] += n
    for r, n in by_route.items():
        qn_routes[r] += n
    names = [c[0] for c in scen.CAPACITY_SERVING] + ["cli.serve-qn"]
    shapes = [{"name": name, "lanes": int(c["args"][0].shape[0]),
               "h_users": c["kw"]["h_users"],
               "slots_cap": c["args"][5].tolist(),
               "slots_before_cut": c["uncut"].tolist(),
               "max_slots": c["kw"]["max_slots"],
               "n_events": c["kw"]["n_events"], "route": c["route"]}
              for name, c in zip(names, calls)]
    print(f"[capacity] drive: wall {wall:.3f} s; qn_event launches by route "
          f"{by_route}; the dispatches in order: "
          f"{json.dumps(shapes)}", flush=True)
    for name, modes in got["serving"].items():
        print(f"[capacity] {name}: slots {got['slots'][name]}; " + "; ".join(
            f"{mode} {json.dumps(sol)} in "
            f"{got['walls'][f'{name}.{mode}']:.4f} s"
            for mode, sol in modes.items()), flush=True)
    print(f"[capacity] training {json.dumps(got['training'])}; the record's "
          f"costs {json.dumps(got['record'])}; replan "
          f"{json.dumps(got['replan'])}; CLI {json.dumps(got['cli'])} (walls "
          f"{json.dumps({k: round(v, 4) for k, v in got['walls'].items() if k.startswith('cli.')})})",
          flush=True)
    mism = scen.capacity_mismatches(REFERENCE["capacity"], got)
    print(f"[capacity] numbers differing from the reference's: "
          f"{mism or 'none'}", flush=True)
    if mism:
        fail(f"capacity: the port differs from the reference at {mism}")
    n_disp = sum(v["qn"]["dispatches"] for v in got["serving"].values()) + \
        got["cli"]["serve-qn"]["dispatches"]
    want = dict.fromkeys(kernels, 0)
    want.update(qn_event=n_disp, event_streams=n_disp)
    if counted != want or len(calls) != n_disp:
        fail(f"capacity: launches {counted} over {len(calls)} sim_batch "
             f"calls, expected {want}")
    took_routes = [c["route"] for c in calls]
    print(f"[capacity] the dispatches' routes {took_routes}; before the slot "
          f"cut {list(ROUTES_BEFORE_CUT['capacity'])}", flush=True)
    if took_routes != [[r] for r in CAPACITY_ROUTES]:
        fail(f"capacity: the dispatches took {took_routes}, expected "
             f"{list(CAPACITY_ROUTES)}")
    # once more under the profiler: each kernel's device ms over the drive,
    # and qn_event_many's launches x (time - bound)
    _, dev_ms, note = profiled_pass(kernels, lambda: scen.capacity(dev),
                                    planner_counts(kernels), "capacity")
    many_bound = sum(many_lane_bound(s["lanes"], s["n_events"],
                                     s["h_users"], s["max_slots"],
                                     s["lanes"] * s["n_events"])[0]
                     for s in shapes if s["route"] == ["qn_event_many"])
    many_ms = dev_ms.get("qn_event_many")
    print(f"[capacity] profiled again: {note['text']}; qn_event_many's "
          f"launches x (time - bound): "
          + ("not measured" if many_ms is None else
             f"{many_ms - many_bound:.4f} ms"), flush=True)
    lanes = {}
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    for name, c in zip(names, calls):
        if c["route"] != ["qn_event_many"]:
            continue
        nm, nr, ma, ra, tk, cap, seed, nea, m_s, r_s = c["args"]
        H, S, E = (c["kw"][k] for k in ("h_users", "max_slots", "n_events"))
        cap_u = i32(np.broadcast_to(c["uncut"], cap.shape).copy())
        S_u = bucket_slots(int(cap_u.max()))
        kw = dict(max_slots=S, warmup_jobs=c["kw"]["warmup_jobs"],
                  replay=m_s is not None)
        kw_u = {**kw, "max_slots": S_u}
        tables = qn_ops.event_streams(tk, seed, nea, h_users=H, n_events=E,
                                      m_samples=m_s, r_samples=r_s)
        same_tables = all(torch.equal(a, b) for a, b in zip(
            tables, qn_ref.event_streams(tk, seed, nea, h_users=H,
                                         n_events=E, m_samples=m_s,
                                         r_samples=r_s)))
        args = (nm, nr, cap, nea, ma, ra, tk, *tables)
        args_u = (nm, nr, cap_u, nea, ma, ra, tk, *tables)
        k0 = dict(qn_ops.qn_event.routes)
        ks, kc = qn_ops.qn_event(*args, **kw)
        took = [r for r, n in qn_ops.qn_event.routes.items() if n > k0[r]]
        gs, gc = qn_ops.qn_event(*args, general=True, **kw)
        # qn_event_general on the uncut lane: past 16384 slots its state
        # lies in a global scratch slice a lane
        gus, guc = qn_ops.qn_event(*args_u, general=True, **kw_u)
        scratch = build.library().qn_event_scratch_bytes(H, S_u, E)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ps, pc = qn_ref.qn_event(*args_u, **kw_u)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same = torch.equal(ks, ps) and torch.equal(kc, pc)
        same_general = torch.equal(gs, ps) and torch.equal(gc, pc)
        same_general_uncut = torch.equal(gus, ps) and torch.equal(guc, pc)
        err = max(float((x - y).abs().max()) for x, y in
                  ((ks, ps), (kc, pc), (gs, ps), (gc, pc), (gus, ps),
                   (guc, pc)))
        # in turns: the new route on the cut lane, the general kernel on the
        # cut lane and on the uncut one (the cut's share, then the kernel's)
        runs = (lambda: qn_ops.qn_event(*args, **kw),
                lambda: qn_ops.qn_event(*args, general=True, **kw),
                lambda: qn_ops.qn_event(*args_u, general=True, **kw_u))
        turns = [cuda_ms(runs[j], 20) for j in (0, 1, 2, 2, 1, 0)]
        ms, general_ms, general_uncut_ms = (
            (turns[j] + turns[5 - j]) / 2 for j in range(3))
        B = int(nm.shape[0])
        bound, nbytes, n_ops = many_lane_bound(B, E, H, S, int(nea.sum()))
        lanes[name] = {
            "shape": f"B={B} E={E} S={S} H={H} "
                     f"{'replay' if kw['replay'] else 'exponential'}",
            "slots_cap": int(cap[0]), "slots_before_cut": int(cap_u[0]),
            "max_slots_before_cut": S_u, "route": took, "n_events": E,
            "n_map": int(nm[0]), "n_reduce": int(nr[0]),
            "bit_identical_to_plain_uncut": same,
            "general_bit_identical": same_general,
            "general_uncut_bit_identical": same_general_uncut,
            "general_uncut_scratch_bytes_a_lane": scratch,
            "tables_bit_identical": same_tables, "jobs": kc.tolist(),
            "max_abs_err": err, "ms": ms, "ns_per_event": ms * 1e6 / E,
            "general_ms": general_ms,
            "general_ns_per_event": general_ms * 1e6 / E,
            "general_uncut_ms": general_uncut_ms,
            "general_uncut_ns_per_event": general_uncut_ms * 1e6 / E,
            "turns_ms": turns, "plain_uncut_ms": plain_ms,
            "bound_ms": bound, "bound_bytes": nbytes,
            "bound_operations": n_ops,
            "bound_by": ("operations" if n_ops / H100_INSTR_PER_S
                         > nbytes / H100_BYTES_PER_S else "bytes")}
        print(f"[capacity] {name}'s lane ({lanes[name]['shape']}, cap "
              f"{int(cap[0])}, {int(cap_u[0])} before the cut in "
              f"{S_u}; {', '.join(took)}): event_streams bit-identical="
              f"{same_tables}, qn_event_many bit-identical to the plain "
              f"uncut lane={same} (qn_event_general: {same_general}; "
              f"qn_event_general on the uncut lane, global scratch "
              f"{scratch} bytes a lane: {same_general_uncut}) "
              f"jobs={kc.tolist()}; qn_event_many {ms:.4f} ms "
              f"({ms * 1e6 / E:.1f} ns an event), qn_event_general on the "
              f"cut lane {general_ms:.4f} ms ({general_ms * 1e6 / E:.1f} "
              f"ns), on the uncut lane {general_uncut_ms:.4f} ms "
              f"({general_uncut_ms * 1e6 / E:.1f} ns) (in turns: "
              f"{', '.join(f'{t:.4f}' for t in turns)} ms); plain on the "
              f"uncut lane {plain_ms:.1f} ms; bound {bound:.6f} ms "
              f"({lanes[name]['bound_by']}: {nbytes} bytes, {n_ops} "
              f"operations)", flush=True)
        if not (same and same_general and same_general_uncut
                and same_tables) or \
                took != ["qn_event_many"] or float(kc.min()) <= 0:
            fail(f"capacity: {name}'s lane on {took} is not bit-identical "
                 f"to the plain version of its uncut lane, or "
                 f"qn_event_general on either lane is not, or the lane "
                 f"completed no job")
        if S_u > 16384 and scratch <= 0:
            fail(f"capacity: {name}'s uncut lane of {S_u} slots took no "
                 f"global scratch")
    # launch/qn_record's quick cells: the plain and the CUDA versions on the
    # same tensors, bit-identical
    reset_launches(*wrappers)
    rec_path = build.BUILD_DIR / "dryrun_qn_torch.json"
    t0 = time.perf_counter()
    recs = qn_record.record_qn_cells(out=str(rec_path), quick=True,
                                     device=dev)
    rec_wall = time.perf_counter() - t0
    rec_counted = {k: w.launches for k, w in kernels.items() if w.launches}
    for k, n in rec_counted.items():
        launches[k] += n
    for r, n in qn_ops.qn_event.routes.items():
        qn_routes[r] += n
    cells = [r for r in recs if r["cell"] != "meta"]
    print(f"[capacity] qn_record quick: wall {rec_wall:.3f} s, launches "
          f"{rec_counted}\n" + roofline.format_kernel_table(
              roofline.analyze_qn_file(str(rec_path))), flush=True)
    if sorted((r["cell"], r["impl"]) for r in cells) != [
            ("amva_ps", "cuda"), ("amva_ps", "plain"), ("qn_event", "cuda"),
            ("qn_event", "plain")] or \
            not all(r["parity_bit_exact"] is True for r in cells):
        fail(f"capacity: qn_record's cells {cells} are not bit-identical "
             f"in both implementations")
    return {"wall_s": wall, "walls": got["walls"],
            "launches": counted, "launches_by_route": by_route,
            "profiled_device_ms": dev_ms,
            "profiled_wall_s": note["wall_s"],
            "many_bound_ms": many_bound,
            "many_launches_x_time_minus_bound_ms": (
                None if many_ms is None else many_ms - many_bound),
            "routes_before_cut": list(ROUTES_BEFORE_CUT["capacity"]),
            "dispatches": shapes, "lanes": lanes,
            "qn_record": {"wall_s": rec_wall, "launches": rec_counted,
                          "cells": [{k: r[k] for k in (
                              "cell", "impl", "batch", "wall_s",
                              "events_per_s", "candidates_per_s",
                              "parity_bit_exact") if k in r}
                              for r in cells]}}


def chain_ns(fn, short: int, long: int) -> float:
    """ns a step of a single thread's dependent chain: ``fn(n)`` launches a
    one-element kernel of ``n`` dependent steps; the difference of a long
    and a short launch over the steps between them, so that the launch's
    own time drops out."""
    return (cuda_ms(lambda: fn(long), 20) - cuda_ms(lambda: fn(short), 20)) \
        * 1e6 / (long - short)


# ----------------------------------------------------------- LM serving
# flash_attention checks: (name, B, S, H, KV, Dh, dtype, causal, window)
FA_CHECKS = [
    ("granite prefill", 4, 1024, 32, 8, 64, torch.bfloat16, True, 0),
    ("granite prefill, ragged S", 4, 777, 32, 8, 64, torch.bfloat16, True,
     0),
    ("gemma3 local", 1, 2048, 32, 16, 128, torch.bfloat16, True, 1024),
    ("stablelm", 2, 512, 32, 32, 80, torch.bfloat16, True, 0),
    ("zamba2 shared attention prefill", 4, 896, 32, 32, 112,
     torch.bfloat16, True, 0),
    ("non-causal", 2, 300, 8, 2, 64, torch.bfloat16, False, 0),
    ("head dim 8", 2, 300, 8, 2, 8, torch.bfloat16, True, 0),
    ("head dim 256, GQA group 8", 1, 777, 8, 1, 256, torch.bfloat16, True,
     0),
    ("S = 1", 4, 1, 32, 8, 64, torch.bfloat16, True, 0),
    ("S = 65", 2, 65, 32, 8, 64, torch.bfloat16, True, 0),
    ("GQA group 8, window", 2, 512, 32, 4, 128, torch.bfloat16, True, 64),
    ("float32", 2, 513, 8, 4, 128, torch.float32, True, 128),
    ("granite prefill, float32", 4, 777, 32, 8, 64, torch.float32, True, 0),
]
# float32 rows at the edges of the float32 wgmma route and one past its
# head-dim limit (fa_f32_kernel), checked after the served shapes so that
# every earlier row keeps its seed (its index)
FA_F32_CHECKS = [
    ("S = 1, float32", 4, 1, 32, 8, 64, torch.float32, True, 0),
    ("S = 65, float32", 2, 65, 32, 8, 64, torch.float32, True, 0),
    ("head dim 8, float32", 2, 300, 8, 2, 8, torch.float32, True, 0),
    ("non-causal, float32", 2, 300, 8, 2, 64, torch.float32, False, 0),
    ("GQA group 8, window, float32", 2, 512, 32, 4, 128, torch.float32,
     True, 64),
    ("ragged S at head dim 128, float32", 2, 777, 8, 2, 128, torch.float32,
     True, 0),
    ("nemotron-4-340b heads past the wgmma limit, float32", 1, 1024, 96, 8,
     192, torch.float32, True, 0),
]
# the SSD scan's parts route's wgmma instances (csrc/ssd_scan_parts.cu,
# <NP>: N rounded up to 64): [build] fails without their ptxas lines,
# HGMMA and UTMALDG
SSD_PARTS_INSTANCES = tuple(f"ssd_parts_{k}_kernel<{np_}>"
                            for k in ("g", "state", "y") for np_ in (64, 128))
# the float32 wgmma forward's instances (fa_fwd_parts_kernel<DP, WGS, BK,
# STAGES>): [build] fails without their ptxas lines, HGMMA and UTMALDG
FA_FWD_INSTANCES = ("fa_fwd_parts_kernel<64, 2, 64, 3>",
                    "fa_fwd_parts_kernel<128, 2, 32, 2>")


# flash_attention timed at the prefill shapes the MoE, encoder-decoder
# and vision drives bring: (B, S, H, KV, Dh, causal), S the drives' longest
# prompt (and a vision model's 576 patches on top; whisper's encoder over
# its 1500 frames)
FLASH_TIMES = {
    "qwen2_moe_prefill": (4, 1024, 16, 16, 128, True),
    "llama4_scout_prefill_gqa_group_5": (4, 1024, 40, 8, 128, True),
    "whisper_encoder": (4, 1500, 6, 6, 64, False),
    "phi3_vision_prefill": (4, 1600, 32, 32, 96, True),
}


def serve_prompts(cfg):
    """The 8 requests of a serving drive, from numpy seed 0: lengths in
    [256, 1024] for a decoder-only model (a vision model's 576 patches come
    on top); for a Mamba2 or hybrid model 128 x [2, 8] (896, 768, 640,
    384, 512, 256, 256, 256), since the reference's engine left-pads each
    round to its longest prompt and a Mamba2 prefill length must be a
    multiple of the SSD chunk (128); for the encoder-decoder (whisper) a
    transcript's prompt of [4, 32] tokens."""
    rng = np.random.default_rng(0)
    if cfg.ssm:
        lens = 128 * rng.integers(2, 9, size=8)
    elif cfg.is_encoder_decoder:
        lens = rng.integers(4, 33, size=8)
    else:
        lens = rng.integers(256, 1025, size=8)
    return lens, [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
                  for n in lens]


def gen_len(cfg) -> int:
    """Tokens generated a request: 32, or 128 for whisper (a 30 s clip's
    transcript)."""
    return 128 if cfg.is_encoder_decoder else 32


def layer_counts(cfg):
    """(Mamba2 layers, attention layers) of a config: one ssd_scan or one
    flash launch each per prefill (an encoder-decoder's encoder layers
    and decoder self-attention layers each take one)."""
    n_ssd = cfg.all_layer_kinds().count("mamba")
    return n_ssd, cfg.n_layers + cfg.n_enc_layers - n_ssd


def describe(cfg) -> str:
    """A config's widths, without reading attention fields an SSM lacks."""
    D = cfg.d_model
    parts = [f"{cfg.n_layers} layers", f"d_model {D}"]
    if cfg.is_encoder_decoder:
        parts[0] = (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder "
                    "layers")
    if cfg.ssm:
        ssm = cfg.ssm
        parts.append(f"Mamba2 d_inner {ssm.d_inner(D)}, {ssm.n_heads(D)} SSD "
                     f"heads of {ssm.head_dim}, state {ssm.d_state}, chunk "
                     f"{ssm.chunk}")
    if cfg.family != "ssm":
        parts.append(f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                     f"{cfg.head_dim}, d_ff {cfg.d_ff}"
                     + (" (one shared block)" if cfg.shared_attn else ""))
    if cfg.moe:
        m = cfg.moe
        parts.append(f"{m.n_experts} routed experts of {m.d_ff_expert} "
                     f"top-{m.top_k} (capacity factor {m.capacity_factor})"
                     + (f" + shared {m.d_ff_shared}" if m.n_shared_experts
                        else ""))
    if cfg.frontend != "none":
        parts.append(f"{cfg.frontend_len} zero {cfg.frontend} (stub)")
    parts.append(f"vocab {cfg.vocab_size} (padded {cfg.padded_vocab})")
    return ", ".join(parts)


def flash_instance(mangled: str):
    """'fa_wgmma_kernel<64, 2, 128>' (or 'fa_fwd_parts_kernel<64, 2, 64,
    3>', or 'fa_fwd_split_kernel') for a line naming a flash_attention
    kernel instance by its mangled name, else None."""
    if "fa_fwd_split_kernel" in mangled:
        return "fa_fwd_split_kernel"
    m = re.search(r"(fa_(?:wgmma|f32|fwd_parts)_kernel)I((?:Li\d+E)+)",
                  mangled)
    if m is None:
        return None
    return f"{m.group(1)}<{', '.join(re.findall(r'Li([0-9]+)E', m.group(2)))}>"


def flash_bwd_instance(mangled: str):
    """'fa_bwd_dq_wgmma_kernel<64, 128>' (or 'fa_bwd_dkdv_wgmma_kernel<64>',
    or a parts kernel's 'fa_bwd_dq_parts_kernel<192, 2, 2, 1>') for a line
    naming an instance of the flash backward's wgmma route by its mangled
    name, else None."""
    m = re.search(r"(fa_bwd_(?:dq|dkdv)_(?:wgmma|parts)_kernel)I"
                  r"((?:Li\d+E)+)", mangled)
    if m is None:
        return None
    return f"{m.group(1)}<{', '.join(re.findall(r'Li([0-9]+)E', m.group(2)))}>"


def ssd_instance(mangled: str):
    """'ssd_wgmma_kernel<64, 128>' or 'ssd_parts_y_kernel<128>' (or
    'ssd_f32_kernel', 'ssd_parts_split_kernel', 'ssd_parts_scan_kernel')
    for a line naming an ssd_scan kernel by its mangled name, else None."""
    m = re.search(r"(ssd_wgmma_kernel|ssd_parts_(?:g|state|y)_kernel)I"
                  r"((?:Li\d+E)+)", mangled)
    if m:
        return (f"{m.group(1)}<"
                f"{', '.join(re.findall(r'Li([0-9]+)E', m.group(2)))}>")
    return next((k for k in ("ssd_f32_kernel", "ssd_parts_split_kernel",
                             "ssd_parts_scan_kernel") if k in mangled), None)


def qn_instance(mangled: str):
    """'qn_event_fast' (or another of the QN event loop's kernels, or
    a draw-table kernel, or one of the DAG's two event loops) for a line
    naming it by its mangled name, else None."""
    m = re.search(r"(qn_event_fast|qn_event_wide|qn_event_many|"
                  r"qn_event_general|"
                  r"qn_streams_kernel|dag_event_fast|dag_event_kernel|"
                  r"dag_streams_kernel)", mangled)
    return m.group(1) if m else None


def qn_template_instance(mangled: str):
    """'qn_event_wide<16, true>' (or 'qn_event_fast<false>', or
    'qn_event_many<0, 4, true>') for a line naming an instance of the QN
    event loop's fast, wide or many kernel (its groups of 16 slots a
    thread, 0 for a flat block; its groups of 16 users a thread; replay
    mode or not) by its mangled name, else None."""
    m = re.search(r"(qn_event_(?:fast|wide|many))I((?:L[ib]\d+E)+)E",
                  mangled)
    if m is None:
        return None
    args = [("true" if v == "1" else "false") if k == "b" else v
            for k, v in re.findall(r"L([ib])(\d+)E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def fast_instance(mangled: str):
    """'dag_event_fast<4, false>' for a line naming an instance of the
    DAG's fast event loop (its block of 4, 8 or 16 slots a thread; replay
    mode or not) by its mangled name, else None."""
    m = re.search(r"dag_event_fastILi([0-9]+)ELb([01])E", mangled)
    return (f"dag_event_fast<{m.group(1)}, "
            f"{'true' if m.group(2) == '1' else 'false'}>") if m else None


def streams_instance(mangled: str):
    """'dag_streams_kernel<true>' (replay mode) or '<false>' for a line
    naming an instance of the DAG's draw-table kernel, else None."""
    m = re.search(r"dag_streams_kernelILb([01])E", mangled)
    return (f"dag_streams_kernel<{'true' if m.group(1) == '1' else 'false'}>"
            if m else None)


def flash_ptxas(log: str, namer=flash_instance) -> dict:
    """Registers, spills and static shared memory of each flash_attention
    kernel instance (or of each kernel ``namer`` names), from the ptxas
    log of the build (-Xptxas -v)."""
    usage, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = namer(ln)
        elif name and ("spill" in ln or ": Used" in ln):
            key = "spill" if "spill" in ln else "used"
            usage.setdefault(name, {}).setdefault(
                key, ln.split(": ", 1)[-1].strip())
    return {k: "; ".join(v.values()) for k, v in usage.items()}


@functools.lru_cache(maxsize=None)
def sass_lines(lib) -> tuple:
    """The built library's SASS (cuobjdump -sass), dumped once: a dump of
    the whole library takes ~14 s."""
    from repro_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return tuple(subprocess.run([cuobjdump, "-sass", str(lib)],
                                capture_output=True, text=True,
                                check=True).stdout.splitlines())


# the instructions [build] counts in the SASS, over every caller
SASS_OPS = ("HGMMA", "UTMALDG", "SHF", "LOP3", "IMAD", "IADD3", "MUFU",
            "FCHK", "BSSY", "CALL", "BRA")


@functools.lru_cache(maxsize=None)
def sass_functions(lib) -> tuple:
    """(function line, {op: count of SASS_OPS}) for each function of the
    built library's SASS, in one pass over the dump (a pass a caller took
    ~4 s of the build phase once the SSD backward's wgmma instances were
    in)."""
    out, counts = [], None
    for ln in sass_lines(lib):
        if "Function :" in ln:
            counts = dict.fromkeys(SASS_OPS, 0)
            out.append((ln, counts))
        elif counts is not None:
            for op in SASS_OPS:
                counts[op] += f" {op}." in ln or f" {op} " in ln
    return tuple(out)


def sass_counts(lib, namer, ops) -> dict:
    """Counts of the instructions ``ops`` (of SASS_OPS) in each kernel of
    the built library's SASS that ``namer`` names: for the flash
    instances, wgmma (HGMMA) and TMA tile loads (UTMALDG)."""
    return {namer(ln): {op: c[op] for op in ops}
            for ln, c in sass_functions(lib) if namer(ln)}


def fa_inputs(dev, B, S, H, KV, Dh, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((B, S, n, Dh), generator=g, device=dev
                             ).to(dtype) for n in (H, KV, KV))


def served_flash_shapes():
    """The flash shapes of serve_full's two rounds for each SERVE_CASES
    config with attention: (name, B, S, H, KV, Dh, dtype, causal, window);
    S counts a vision model's patches; an encoder-decoder adds its
    encoder's non-causal prefill over the frames."""
    from repro_torch.configs.registry import get_config

    shapes = []
    for arch, expect, cut, _ in SERVE_CASES:
        cfg = get_config(arch).replace(**cut)
        if "flash_attention" not in expect:
            continue
        lens, _ = serve_prompts(cfg)
        extra = cfg.frontend_len if cfg.frontend == "patches" else 0
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                 torch.bfloat16)
        for r in (0, 1):
            S = int(lens[4 * r:4 * r + 4].max()) + extra
            shapes.append((f"{arch} serving round {r}", 4, S, *heads, True,
                           0))
        if cfg.is_encoder_decoder:
            shapes.append((f"{arch} encoder", 4, cfg.frontend_len, *heads,
                           False, 0))
    return shapes


def check_flash(dev, fa_ops, fa_ref) -> dict:
    """Kernel against plain at FA_CHECKS, at the prefill shapes of
    serve_full's two rounds for every served config and at
    FA_F32_CHECKS, each row on the
    kernel ``fa_ops.fwd_kernel`` names (bf16 as served, without lse); a
    float32 row also holds lse against plain (LSE_TOL) and prints its
    share of the tolerance, and a
    row of the float32 wgmma route holds its split's parts bit for bit
    against ``ref.split_parts``.  Returns the largest abs error ("all",
    and by kernel), the largest share of the tolerance by kernel, the
    largest lse error and the split's."""
    res = {"all": 0.0, "share": {}, "lse": 0.0, "fa_fwd_split": 0.0}
    for i, (name, B, S, H, KV, Dh, dtype, causal, window) in \
            enumerate(FA_CHECKS + served_flash_shapes() + FA_F32_CHECKS):
        q, k, v = fa_inputs(dev, B, S, H, KV, Dh, dtype, i)
        kernel = fa_ops.fwd_kernel(q)
        if dtype == torch.float32:
            out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                                  window=window)
        else:                        # as served: no lse
            out, lse = fa_ops.flash_attention(q, k, v, causal=causal,
                                              window=window), None
        torch.cuda.synchronize()
        want, want_lse = fa_ref.flash_attention_fwd(q, k, v, causal=causal,
                                                    window=window)
        tol = FA_TOL[dtype]
        err, ok, share = close_err(out, want, tol)
        ok = ok and out.dtype == dtype and bool(torch.isfinite(out).all())
        extra = ""
        if dtype == torch.float32:
            lse_err, lse_ok, _ = close_err(lse, want_lse, LSE_TOL)
            ok = ok and lse_ok
            res["lse"] = max(res["lse"], lse_err)
            extra = f"; {share:.3f} of the tolerance; lse {lse_err:.3e} " \
                    f"(tol {LSE_TOL})"
        if kernel == "fa_fwd_parts_kernel":
            split = max(float((a.float() - fa_ref.split_parts(x).float())
                              .abs().max())
                        for a, x in zip(fa_ops.fa_fwd_split(q, k, v),
                                        (q, k, v)))
            ok = ok and split == 0.0
            res["fa_fwd_split"] = max(res["fa_fwd_split"], split)
            extra += f"; split parts off plain by {split:.1e}"
        res["all"] = max(res["all"], err)
        res[kernel] = max(res.get(kernel, 0.0), err)
        res["share"][kernel] = max(res["share"].get(kernel, 0.0), share)
        print(f"[check] flash_attention {name}: B={B} S={S} H={H} KV={KV} "
              f"Dh={Dh} {str(dtype)[6:]} causal={causal} window={window} "
              f"({kernel}): max_abs_err={err:.3e} (tol {tol:g} abs + rel)"
              f"{extra} ok={ok}", flush=True)
        if not ok:
            fail(f"flash_attention differs from its plain version ({name})")
        del q, k, v, out, lse, want, want_lse
    return res


def left_pad(prompts):
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int64)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    return torch.from_numpy(toks)


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def reset_launches(*wrappers):
    for w in wrappers:
        w.launches = 0
        for r in getattr(w, "routes", {}):
            w.routes[r] = 0


def serve_full(dev, kernels, arch, expect, cut):
    """``arch`` at full width (and depth, unless ``cut`` names fewer
    layers) through BatchingEngine on the card: 8 requests, 2 rounds.
    The weights are drawn on the card straight into their working dtypes
    (``init_working_params``: no float32 copy of a stacked leaf).
    ``expect`` names the launches each kernel must show over the drive
    (the others none).  Returns (the launches by kernel, the ssd_scan
    launches by route, the engine, the prompts, the drive's figures)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import param_count
    from repro_torch.models import api
    from repro_torch.serve import step
    from repro_torch.serve.engine import BatchingEngine

    cfg = get_config(arch).replace(**cut)
    specs = api.param_specs(cfg)
    n_gen = gen_len(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = step.init_working_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    eng = BatchingEngine(cfg, params, max_batch=4, temperature=0.0)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    tree_bytes = sum(t.numel() * t.element_size()
                     for t in leaves(eng.params))
    torch.cuda.empty_cache()
    lens, prompts = serve_prompts(cfg)
    cut_txt = (f" (depth cut to {cfg.n_layers} of "
               f"{get_config(arch).n_layers})" if cut else "")
    print(f"[serve] {cfg.name}: {describe(cfg)}{cut_txt}; "
          f"{param_count(specs)} parameters, drawn into the working dtypes "
          f"in {init_s:.2f} s: tree {tree_bytes / 1e9:.3f} GB, peak "
          f"{init_peak / 1e9:.3f} GB; prompt lengths {lens.tolist()}, "
          f"gen_len {n_gen}, max_batch 4", flush=True)
    for p in prompts:
        eng.submit(p, gen_len=n_gen)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*kernels.values())
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {name: w.launches for name, w in kernels.items()}
    ssd_routes = dict(kernels["ssd_scan"].routes)
    peak = torch.cuda.max_memory_allocated()
    for r in done:
        print(f"[serve] {cfg.name} request {r.rid}: prompt {len(r.tokens)} "
              f"tokens, latency {r.latency_s * 1e3:.1f} ms, output "
              f"{r.output[:8]}...", flush=True)
    for i, st in enumerate(eng.round_stats):
        print(f"[serve] {cfg.name} round {i}: batch {st['batch']}, "
              f"prompt_len {st['prompt_len']}, prefill "
              f"{st['prefill_s'] * 1e3:.2f} ms, decode "
              f"{st['decode_s_per_step'] * 1e3:.3f} ms/step over "
              f"{st['decode_steps']} steps", flush=True)
    want = {name: expect.get(name, 0) for name in kernels}
    summary = BatchingEngine.summarize(done)
    print(f"[serve] {cfg.name} summarize: {json.dumps(summary)}; wall "
          f"{wall:.3f} s; max_memory_allocated {peak} B "
          f"({peak / 1e9:.3f} GB); launches {got} (expected {want}); "
          f"ssd_scan routes {ssd_routes}", flush=True)
    if got != want:
        fail(f"{cfg.name}: kernel launches {got}, expected {want} (one per "
             "prefill layer of its kind per round)")
    if ssd_routes["parts"]:
        fail(f"{cfg.name}: a served prefill took an SSD scan route other "
             f"than wgmma: {ssd_routes}")
    if len(done) != 8 or any(
            len(r.output) != n_gen or not all(0 <= t < cfg.vocab_size
                                              for t in r.output)
            for r in done):
        fail(f"{cfg.name}: serving returned malformed outputs")
    # round 0's first-step logits: finite, and their argmax is the first
    # token the engine chose for each request
    toks = left_pad(prompts[:4]).to(dev)
    logits, _ = step.make_prefill_step(cfg, cache_len=toks.shape[1] + n_gen)(
        eng.params, step.model_inputs(cfg, toks))
    first = [r.output[0] for r in done[:4]]
    if tuple(logits.shape) != (4, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()) or \
            logits[:, 0].argmax(-1).tolist() != first:
        fail(f"{cfg.name}: round 0's prefill logits are not finite or "
             "disagree with the engine's first tokens")
    figures = {**summary, "wall_s": wall, "peak_bytes": peak,
               "init_peak_bytes": init_peak, "tree_bytes": tree_bytes,
               "n_layers": cfg.n_layers, "gen_len": n_gen,
               "prefill_ms": [st["prefill_s"] * 1e3 for st in eng.round_stats],
               "decode_ms_per_step": [st["decode_s_per_step"] * 1e3
                                      for st in eng.round_stats]}
    return got, ssd_routes, eng, prompts, figures


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def serve_drives(dev, kernels, cases):
    """Each case of ``cases`` (SERVE_CASES' form): its drive at full width
    (serve_full), profiled, then against the CPU.  Returns the launches by
    kernel and by path, the ssd_scan routes, the card-vs-CPU differences,
    each drive's figures and the wall of them all."""
    t0 = time.perf_counter()
    launches = collections.Counter()
    out = {"by_path": {}, "card_vs_cpu": {}, "figures": {},
           "ssd_routes": dict.fromkeys(kernels["ssd_scan"].routes, 0)}
    for arch, expect, cut, cpu_cut in cases:
        walls = [time.perf_counter()]
        got, routes, eng, prompts, figures = serve_full(dev, kernels, arch,
                                                        expect, cut)
        launches.update(got)
        for r, n in routes.items():
            out["ssd_routes"][r] += n
        out["by_path"][arch] = {k: n for k, n in got.items() if n}
        walls.append(time.perf_counter())
        figures["profile"] = profile_serving(dev, eng, prompts)
        out["figures"][arch] = figures
        del eng
        torch.cuda.empty_cache()
        walls.append(time.perf_counter())
        out["card_vs_cpu"][arch] = serve_card_vs_cpu(dev, kernels, arch,
                                                     cpu_cut)
        torch.cuda.empty_cache()
        walls.append(time.perf_counter())
        figures["phase_s"] = dict(zip(("drive", "profile", "card_vs_cpu"),
                                      np.diff(walls).tolist()))
        print(f"[serve] {arch} walls (s): {figures['phase_s']}", flush=True)
    out["launches"] = dict(launches)
    out["wall_s"] = time.perf_counter() - t0
    return out


def serve_card_vs_cpu(dev, kernels, arch, cut):
    """The same engine at full width, cut to ``cut``'s layers, on the
    card and on the CPU with the same weights (drawn on the card in their
    working dtypes and copied to the CPU) and prompts; the CPU engine's
    logits at every step against the card's along the CPU's greedy tokens
    (teacher-forced).  A model with a front end is also compared on
    random frames or patches at its token embeddings' scale (the engine
    feeds zeros, through which an encoder computes zeros)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.serve import step
    from repro_torch.serve.engine import BatchingEngine

    cfg = get_config(arch).replace(**cut)
    n_ssd, n_attn = layer_counts(cfg)
    t0 = time.perf_counter()
    params = to_device(step.init_working_params(
        cfg, torch.Generator(device=dev).manual_seed(1)), "cpu")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in ((32, 17) if cfg.is_encoder_decoder else (256, 201))]
    n_gen = 8
    devices = (dev, torch.device("cpu"))
    outs, secs = [], []
    # the CPU engine's logits and each MoE layer's routing at the compared
    # positions (the prompt's last, then each decoded token), step by step
    cpu_steps, cpu_routes = [], []
    for d in devices:
        eng = BatchingEngine(cfg, to_device(params, d), max_batch=2)
        for p in prompts:
            eng.submit(p, gen_len=n_gen)
        reset_launches(*kernels.values())
        with routing_log() if d.type == "cpu" else \
                contextlib.nullcontext([]) as log:
            if d.type == "cpu":
                eng._sample = recording(eng._sample, log, cpu_steps,
                                        cpu_routes)
            t0 = time.perf_counter()
            outs.append([r.output for r in eng.run()])
            secs.append(time.perf_counter() - t0)
        got = {name: w.launches for name, w in kernels.items()}
        want = {name: 0 for name in kernels}
        if d.type == "cuda":
            want.update(flash_attention=n_attn, ssd_scan=n_ssd)
        if got != want:
            fail(f"{cfg.name} cut {cut} engine on {d}: launches {got}, "
                 f"expected {want}")
        if kernels["ssd_scan"].routes["parts"]:
            fail(f"{cfg.name} cut {cut}: the SSD scan took a route other "
                 "than wgmma")
    card, cpu = outs
    # the card teacher-forced along the CPU's tokens
    t0 = time.perf_counter()
    w = to_device(params, dev)
    toks = left_pad(prompts).to(dev)
    card_steps, card_routes = [], []
    with routing_log() as log:
        logits, caches = step.make_prefill_step(
            cfg, cache_len=toks.shape[1] + n_gen)(
                w, step.model_inputs(cfg, toks))
        decode = step.make_decode_step(cfg)
        for t in range(n_gen):
            if t:
                tok = torch.tensor([[o[t - 1]] for o in cpu], device=dev)
                logits, caches = decode(w, tok, caches,
                                        toks.shape[1] + t - 1)
            card_steps.append(logits[:, 0].float().cpu())
            card_routes.append(log[:])
            del log[:]
    forced_s = time.perf_counter() - t0
    # a request whose expert choice at a compared position differs between
    # the devices, at a near tie of the CPU's gates, routes to the other
    # expert on a rounding (as two XLA builds could): that step's logits
    # are not compared; a choice that differs away from a tie fails
    flips = set()
    for t, (card_t, cpu_t) in enumerate(zip(card_routes, cpu_routes)):
        for (e_card, _), (e_cpu, gap) in zip(card_t, cpu_t):
            for b in torch.nonzero((e_card[:, -1] != e_cpu[:, -1]).any(-1)
                                   ).flatten().tolist():
                print(f"[serve] {cfg.name} request {b} step {t}: an MoE "
                      f"layer routes to {e_card[b, -1].tolist()} on the "
                      f"card, {e_cpu[b, -1].tolist()} on the cpu (the "
                      f"cpu's gate gap {float(gap[b, -1]):.3e}, near tie "
                      f"below {ROUTE_TIE})", flush=True)
                if float(gap[b, -1]) >= ROUTE_TIE:
                    fail(f"{cfg.name}: card and cpu route a token to other "
                         "experts away from a near tie")
                flips.add((b, t))
    steps = (card_steps, cpu_steps)
    diffs = [max([float((a[b] - c[b]).abs().max()) for b in range(len(a))
                  if (b, t) not in flips], default=0.0)
             for t, (a, c) in enumerate(zip(*steps))]
    where = largest_difference(
        [(f"step {t} request {b}", a[b], c[b])
         for t, (a, c) in enumerate(zip(*steps)) for b in range(len(a))
         if (b, t) not in flips], cfg.vocab_size)
    front = ""
    if cfg.frontend != "none":
        g = torch.Generator().manual_seed(2)
        batch = step.model_inputs(cfg, left_pad(prompts))
        scale = float(params["embed"].float().std())
        batch[cfg.frontend] = (torch.randn(batch[cfg.frontend].shape,
                                           generator=g) * scale
                               ).to(torch.bfloat16)
        fwd = [api.forward_logits(cfg, to_device(params, d),
                                  to_device(batch, d))[0].float().cpu()
               for d in devices]
        diffs.append(float((fwd[0] - fwd[1]).abs().max()))
        front = (f"; on random {cfg.frontend} ({cfg.frontend_len}) the "
                 f"forward's logits max abs diff {diffs[-1]:.4e} ("
                 + largest_difference([(f"position {p} request {b}",
                                        fwd[0][b, p], fwd[1][b, p])
                                       for b in range(fwd[0].shape[0])
                                       for p in range(fwd[0].shape[1])],
                                      cfg.vocab_size)
                 + ")")
    print(f"[serve] card vs cpu, {cfg.name} cut {cut}, prompts "
          f"{[len(p) for p in prompts]}, {n_gen} tokens: engine "
          f"{secs[0]:.2f} s on the card, {secs[1]:.2f} s on the cpu "
          f"(weights drawn on the card and copied in {init_s:.2f} s, the "
          f"card's teacher-forced pass {forced_s:.2f} s); first-step logits "
          f"max abs diff "
          f"{diffs[0]:.4e}, over all {n_gen} steps "
          f"{max(diffs[:n_gen]):.4e} ({where}){front} (tol "
          f"{CARD_CPU_TOL}); greedy tokens equal: {card == cpu}", flush=True)
    if max(diffs) > CARD_CPU_TOL:
        fail(f"{cfg.name}: card and cpu logits differ beyond the tolerance")
    for i, (a, b) in enumerate(zip(card, cpu)):
        at = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if at is None:
            continue
        lg = steps[1][at][i]
        margin = float(lg[b[at]] - lg[a[at]])
        print(f"[serve] {cfg.name} request {i} diverges at token {at}: cpu "
              f"{b[at]}, card {a[at]}, cpu margin {margin:.4e}", flush=True)
        if margin > CARD_CPU_TOL and (i, at) not in flips:
            fail(f"{cfg.name}: card and cpu greedy tokens differ beyond a "
                 "near tie")
    return max(diffs)


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at magnitude |x| (8 bits of
    mantissa)."""
    return 0.0 if x == 0 else 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def largest_difference(rows, vocab: int) -> str:
    """Where the largest |card - cpu| of (label, card logits (V,), cpu
    logits (V,)) rows sits: its label and vocab id, the two logits, the
    bfloat16 ulp at their magnitude (one rounding apart when the
    difference equals it), how many logits differ by as much, and the
    largest |logit| compared with the ulp there; over the first ``vocab``
    ids (the padded ones hold -1e9 on both devices)."""
    best, n_at, top = None, 0, 0.0
    for label, a, c in rows:
        a, c = a[:vocab], c[:vocab]
        d = (a.float() - c.float()).abs()
        m = float(d.max())
        top = max(top, float(a.float().abs().max()),
                  float(c.float().abs().max()))
        if best is None or m > best[0]:
            v = int(d.argmax())
            best, n_at = (m, label, v, float(a[v]), float(c[v])), 0
        n_at += int((d == best[0]).sum()) if m == best[0] else 0
    if best is None:
        return "nothing compared"
    m, label, v, x, y = best
    ulp = bf16_ulp(max(abs(x), abs(y)))
    return (f"largest at {label}, vocab id {v}: card {x!r}, cpu {y!r}, "
            f"{m / ulp if ulp else 0:g} bf16 ulp at that magnitude "
            f"({ulp:g}); {n_at} logits differ by {m:g}; largest |logit| "
            f"{top:.4g} (ulp {bf16_ulp(top):g})")


def recording(sample, log, steps, routes):
    """``sample`` (an engine's ``_sample``) that first records the step's
    logits (B, V) and the MoE routing ``log`` holds since the last step."""
    def record(logits):
        steps.append(logits[:, 0].float().cpu())
        routes.append(log[:])
        del log[:]
        return sample(logits)
    return record


# a near tie of an MoE router's float32 gates: a kept expert's gate within
# this of the next expert's (tests/test_torch_serving.py's ROUTE_TIE)
ROUTE_TIE = 1e-3


@contextlib.contextmanager
def routing_log():
    """Record, on the CPU, each MoE layer's routing as the forward runs:
    (the chosen experts (B', c, k) in expert order, the smallest gap
    between a kept choice's gate and the next expert's (B', c))."""
    from repro_torch.models import moe

    log, dispatch = [], moe._top_k_dispatch

    def spy(gates, top_k, capacity):
        out = dispatch(gates, top_k, capacity)
        g = torch.sort(gates, dim=-1, descending=True).values
        gap = (g[..., :top_k] - g[..., 1:top_k + 1]).min(dim=-1).values
        log.append((out[0].cpu(), gap.cpu()))
        return out
    moe._top_k_dispatch = spy
    try:
        yield log
    finally:
        moe._top_k_dispatch = dispatch


MOE_PHASES = {"router": "_route", "dispatch": "_dispatch",
              "experts": "_experts", "combine": "_combine"}


@contextlib.contextmanager
def moe_ranges():
    """Each MoE phase function (``models/moe.py``: the router with its
    top-k, the dispatch gather, the experts' bmm, the combine) inside a
    profiler range ``moe.<phase>`` while the context lasts."""
    from repro_torch.models import moe

    saved = {name: getattr(moe, fn) for name, fn in MOE_PHASES.items()}

    def ranged(name, fn):
        def call(*args):
            with torch.profiler.record_function(f"moe.{name}"):
                return fn(*args)
        return call
    for name, fn in saved.items():
        setattr(moe, MOE_PHASES[name], ranged(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, MOE_PHASES[name], fn)


def profile_serving(dev, eng, prompts):
    """Device busy share and top kernels of one prefill (round 0's
    prompts) and of 4 decode steps after it, torch.profiler; for an MoE
    model each phase's device time (the kernels launched inside its
    range).  Returns {phase: {device busy ms, wall ms, moe ms}}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import step

    cfg = eng.cfg
    toks = left_pad(prompts[:4]).to(dev)
    batch = step.model_inputs(cfg, toks)
    prefill = step.make_prefill_step(cfg, cache_len=toks.shape[1] + 32)
    decode = step.make_decode_step(cfg)
    logits, caches = prefill(eng.params, batch)
    torch.cuda.synchronize()

    def decode_4():
        nonlocal logits, caches
        token = step.greedy_sample(logits[:, 0])[:, None]
        for t in range(4):
            logits, caches = decode(eng.params, token, caches,
                                    toks.shape[1] + t)
            token = step.greedy_sample(logits[:, 0])[:, None]
            token.tolist()

    n_layers = cfg.n_layers + cfg.n_enc_layers
    ranges = [f"moe.{k}" for k in MOE_PHASES]
    phases = [("prefill", lambda: prefill(eng.params, batch), 1),
              ("decode x4", decode_4, 4)]
    out = {}
    for name, fn, steps in phases:
        with moe_ranges(), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]
                                   ) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = collections.Counter()
        by_range = collections.Counter()
        n_kernels = 0
        for ev in prof.events():
            if ev.name in ranges:       # a range, not a kernel
                if ev.device_type == torch.autograd.DeviceType.CPU:
                    us = getattr(ev, "device_time_total", None)
                    by_range[ev.name] += (ev.cuda_time_total if us is None
                                          else us) / 1e3
            elif ev.device_type == torch.autograd.DeviceType.CUDA:
                by_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3
                n_kernels += 1
        busy = sum(by_kernel.values())
        top = ", ".join(f"{k[:48]}={v:.3f}"
                        for k, v in by_kernel.most_common(6))
        per_layer = n_kernels / n_layers / steps
        shares = {k: sum(v for kn, v in by_kernel.items()
                         if any(d in kn for d in dk))
                  for k, dk in DEVICE_KERNELS.items()}
        share = "; ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}% of device "
                          f"time)" for k, v in shares.items() if v)
        moe_txt = ""
        if cfg.moe and busy > 0:
            experts = by_range["moe.experts"]
            moe_txt = "; MoE " + ", ".join(
                f"{r[4:]} {v:.3f} ms ({100 * v / busy:.1f}%)"
                for r, v in by_range.items()) + (
                f"; router + dispatch + combine against the experts' bmm: "
                f"{(sum(by_range.values()) - experts) / max(experts, 1e-9):.3f}x")
        front = (f" after {cfg.frontend_len} {cfg.frontend}"
                 if cfg.frontend == "patches" else "")
        print(f"[profile] {cfg.name} serve {name} (B=4, S={toks.shape[1]}"
              f"{front}): "
              f"wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / wall_ms:.1f}%), {n_kernels} kernels "
              f"({per_layer:.1f} per layer{' per step' if steps > 1 else ''}"
              f"); {share or 'no port kernel'}{moe_txt}; top ms: {top}"
              if busy > 0 else f"[profile] {cfg.name} serve {name}: wall "
              f"{wall_ms:.2f} ms, device time not measured (no device "
              f"activity recorded)", flush=True)
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                     "kernels_per_layer": per_layer,
                     **{f"{k}_ms": v for k, v in shares.items()},
                     **{f"{r}_ms": v for r, v in by_range.items()}}
    return out


def queued_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of ``fn`` on the device with no host gap:
    the calls are queued behind a spin of ~``reps`` ms on the stream, so
    the events around them time the kernels back to back (a check on the
    profiler's device times, and a device time where it records none)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * reps)       # ~1 ms a call at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn, reps: int = 50) -> float:
    """Milliseconds of the host per call of ``fn``: the calls issued back to
    back on the host clock, with no wait for the device between them but
    the call's own (a read-back): the call's cost where the device is
    busier than the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def device_ms(fn, kernel: str, reps: int = 20, per_call=None):
    """The mean device time (ms) of the launches of ``kernel`` over
    ``reps`` calls of ``fn`` (torch.profiler), None if the profiler saw
    none, and the first such launch's attributes in the trace (registers
    per thread, shared memory, blocks per SM; {} where absent).  Given
    ``per_call``, the launches of ``kernel`` a call makes, the figure
    stands only where the profiler's events and the trace's kernel records
    both count reps * per_call launches and their means agree within 1%;
    else None, and a [profile] line says what each returned."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and kernel in ev.name]
    path = build.BUILD_DIR / f"trace_{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    recs = [e for e in events
            if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    args = recs[0].get("args", {}) if recs else {}
    launch = {k: args[k] for k in ("registers per thread", "shared memory",
                                   "blocks per SM", "grid", "block")
              if k in args}
    ms = sum(us) / len(us) / 1e3 if us else None
    if per_call is None:
        return ms, launch
    durs = [float(e.get("dur", 0.0)) for e in recs]
    want = reps * per_call
    if len(us) == len(durs) == want and \
            abs(sum(durs) / want / 1e3 - ms) <= 0.01 * ms:
        return ms, launch
    host0 = min((e["ts"] for e in events if "ts" in e and e.get("cat") in
                 ("cpu_op", "cuda_runtime", "cuda_driver")), default=None)
    early = sum(host0 is not None and e.get("ts", host0) < host0
                for e in recs)
    spread = lambda xs: ("none" if not xs else f"min {min(xs):.1f}, median "
                         f"{sorted(xs)[len(xs) // 2]:.1f}, max "
                         f"{max(xs):.1f} us")
    names = sorted({ev.name for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and kernel in ev.name})
    print(f"[profile] device_ms {kernel}: {want} launched; the profiler's "
          f"events {len(us)} ({spread(us)}), the trace's kernel records "
          f"{len(durs)} ({spread(durs)}), {early} of them before the "
          f"session's first host event; names {names}: not measured",
          flush=True)
    return None, launch


def time_flash(dev, fa_ops, fa_ref, B, S, H, KV, Dh, causal=True):
    """The flash kernel at a prefill shape (bf16): kernel (CUDA events
    around the call, and its device time alone), plain version, torch's
    SDPA (yardstick) and the bound (float32: time_flash_f32)."""
    import torch.nn.functional as F

    q, k, v = fa_inputs(dev, B, S, H, KV, Dh, torch.bfloat16, 99)
    kw = dict(causal=causal)
    out = fa_ops.flash_attention(q, k, v, **kw)
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True)
    lib_err = float((sdpa().transpose(1, 2).float() - out.float())
                    .abs().max())
    ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), 20)
    dev_ms, launch = device_ms(lambda: fa_ops.flash_attention(q, k, v, **kw),
                               "fa_wgmma_kernel", per_call=1)
    plain_ms = cuda_ms(lambda: fa_ref.flash_attention(q, k, v, **kw), 5)
    lib_ms = cuda_ms(sdpa, 20)
    # bytes: q, k, v read once, o written once; operations: the live
    # query-key pairs (causal: the lower triangle), 2 flops each for q.k
    # and for p.v per Dh
    nbytes = 2 * (2 * B * S * H * Dh + 2 * B * S * KV * Dh)
    flops = 4 * B * H * Dh * (S * (S + 1) // 2 if causal else S * S)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_OPS_PER_S
    bound = 1e3 * max(t_bytes, t_ops)
    dev_txt = "not measured" if dev_ms is None else \
        f"{dev_ms:.4f} ms ({flops / dev_ms / 1e9:.2f} TFLOP/s)"
    print(f"[time] flash_attention B={B} S={S} H={H} KV={KV} Dh={Dh} bf16 "
          f"{'causal' if causal else 'non-causal'}: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.2f} TFLOP/s; on "
          f"the device alone {dev_txt}; launch {launch}), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (max abs diff to the "
          f"kernel {lib_err:.3e}), bound {bound:.5f} ms ({nbytes} bytes, "
          f"{flops} flops)", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


# the float32 forward timed (time_flash_f32): granite-3-2b's heads at the
# bf16 time's prefill shape (B, S, H, KV, Dh), causal
FA_F32_TIME = (4, 1024, 32, 8, 64)
# the fewest bf16 terms that meet the reference's 2e-5 (the bound's):
# S = Q.K^T six, P.V the backward's three (lo.hi, hi.mid, hi.hi); and
# the terms fa_fwd_parts_kernel runs (P.V five, for margin), its work rate
FA_F32_BOUND_TERMS = 6 + 3
FA_F32_KERNEL_TERMS = 6 + 5


def fa_f32_bounds(B, S, H, KV, Dh, causal=True) -> dict:
    """Bounds of the float32 forward, ms, with what bounds each: the
    function's (its two products at the CUDA cores' float32 rate, or q,
    k, v and o in float32 at the memory's), the split pass's (bytes: 4
    read and 6 written an element of q, k and v, DP columns a part),
    fa_fwd_parts_kernel's (the FA_F32_BOUND_TERMS bf16 products that meet
    the tolerance at the tensor cores' rate, or the parts and o) and the
    route's (their sum); and the FA_F32_KERNEL_TERMS products' flops."""
    DP = -(-Dh // 64) * 64
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * Dh * pairs            # q.k and p.v, 2 a term each
    elems = B * S * (H + 2 * KV)              # of q, k and v
    out = 4 * B * S * H * Dh
    f32_ops, f32_bytes = flops / H100_FP32_OPS_PER_S, \
        (4 * elems * Dh + out) / H100_BYTES_PER_S
    split_bytes = elems * (4 * Dh + 6 * DP)
    terms = FA_F32_BOUND_TERMS * (flops / 2) / H100_BF16_OPS_PER_S
    parts_bytes = (6 * elems * DP + out) / H100_BYTES_PER_S
    by = lambda o, b: "operations" if o > b else "bytes"
    split = 1e3 * split_bytes / H100_BYTES_PER_S
    parts = 1e3 * max(terms, parts_bytes)
    return {"function": (1e3 * max(f32_ops, f32_bytes), by(f32_ops, f32_bytes)),
            "fa_fwd_split": (split, "bytes", split_bytes),
            "fa_fwd_parts": (parts, by(terms, parts_bytes)),
            "route": (split + parts, "operations and bytes"),
            "flops": flops, "term_flops": FA_F32_KERNEL_TERMS * flops // 2}


def time_flash_f32(dev, fa_ops, fa_ref, B, S, H, KV, Dh, causal=True):
    """The float32 forward at (B, S, H, KV, Dh): the wgmma route's call
    (fa_fwd_split, then fa_fwd_parts_kernel) and fa_f32_kernel's (route
    "simt") on the same inputs in turns (wgmma, simt, simt, wgmma), each
    kernel alone (CUDA events around the call, and queued back to back
    behind a spin: its device time where the profiler records none) and on
    the device (profiler), the plain
    version and the split's, torch's SDPA in float32 (a yardstick the
    port never calls), the bounds, and each route's largest error against
    plain with its share of FA_TOL."""
    import torch.nn.functional as F

    q, k, v = fa_inputs(dev, B, S, H, KV, Dh, torch.float32, 99)
    kw = dict(causal=causal)
    wgmma = lambda: fa_ops.flash_attention(q, k, v, **kw)
    simt = lambda: fa_ops.flash_attention_simt(q, k, v, **kw)
    turns = [cuda_ms(f, 10) for f in (wgmma, simt, simt, wgmma)]
    parts = fa_ops.fa_fwd_split(q, k, v)
    split_ms = cuda_ms(lambda: fa_ops.fa_fwd_split(q, k, v), 20)
    parts_ms = cuda_ms(lambda: fa_ops.fa_fwd_parts(q, k, parts, causal, 0,
                                                   False), 20)
    split_queued = queued_ms(lambda: fa_ops.fa_fwd_split(q, k, v))
    parts_queued = queued_ms(lambda: fa_ops.fa_fwd_parts(q, k, parts, causal,
                                                         0, False))
    split_dev, _ = device_ms(wgmma, "fa_fwd_split_kernel", 10, per_call=1)
    parts_dev, launch = device_ms(wgmma, "fa_fwd_parts_kernel", 10,
                                  per_call=1)
    simt_dev, _ = device_ms(simt, "fa_f32_kernel", 5, per_call=1)
    split_plain_ms = cuda_ms(lambda: [fa_ref.split_parts(x)
                                      for x in (q, k, v)], 3)
    plain_ms = cuda_ms(lambda: fa_ref.flash_attention(q, k, v, **kw), 3)
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True)
    lib_ms = cuda_ms(sdpa, 5)
    want = fa_ref.flash_attention(q, k, v, **kw)
    tol = FA_TOL[torch.float32]
    err, _, share = close_err(wgmma(), want, tol)
    simt_err, _, simt_share = close_err(simt(), want, tol)
    split_err = max(float((a.float() - fa_ref.split_parts(x).float())
                          .abs().max()) for a, x in zip(parts, (q, k, v)))
    b = fa_f32_bounds(B, S, H, KV, Dh, causal)
    ms, simt_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    print(f"[time] flash_attention B={B} S={S} H={H} KV={KV} Dh={Dh} "
          f"float32 {'causal' if causal else 'non-causal'}: the wgmma route "
          f"{ms:.4f} ms a call ({b['flops'] / ms / 1e9:.2f} TFLOP/s of the "
          f"function; split {split_ms:.4f} ms alone, {split_queued:.4f} ms "
          f"queued back to back, device {fmt(split_dev)}; "
          f"fa_fwd_parts_kernel {parts_ms:.4f} ms alone, {parts_queued:.4f} "
          f"ms queued, device {fmt(parts_dev)}, "
          f"{b['term_flops'] / parts_ms / 1e9:.2f} "
          f"TFLOP/s of its {FA_F32_KERNEL_TERMS} bf16 terms, "
          f"{parts_ms / b['fa_fwd_parts'][0]:.2f}x its bound; launch "
          f"{launch}); "
          f"fa_f32_kernel {simt_ms:.4f} ms a call (device {fmt(simt_dev)}); "
          f"in turns {', '.join(f'{t:.4f}' for t in turns)} ms (wgmma, "
          f"simt, simt, wgmma): {simt_ms / ms:.2f}x; plain {plain_ms:.4f} "
          f"ms, the split's plain {split_plain_ms:.4f} ms; sdpa in float32 "
          f"{lib_ms:.4f} ms; bounds: the function {b['function'][0]:.5f} ms "
          f"({b['function'][1]}, float32 rate), the split "
          f"{b['fa_fwd_split'][0]:.5f} ms ({b['fa_fwd_split'][2]} bytes), "
          f"fa_fwd_parts_kernel {b['fa_fwd_parts'][0]:.5f} ms "
          f"({b['fa_fwd_parts'][1]}: the {FA_F32_BOUND_TERMS} bf16 terms "
          f"that meet the tolerance), the route {b['route'][0]:.5f} ms; max "
          f"abs err against plain: wgmma {err:.3e} ({share:.3f} of "
          f"tolerance {tol:g} abs + rel), simt {simt_err:.3e} "
          f"({simt_share:.3f}), split {split_err:.1e}", flush=True)
    return {"ms": ms, "simt_ms": simt_ms, "turns_ms": turns,
            "split_ms": split_ms, "split_queued_ms": split_queued,
            "split_device_ms": split_dev, "parts_ms": parts_ms,
            "parts_queued_ms": parts_queued, "parts_device_ms": parts_dev,
            "simt_device_ms": simt_dev, "launch": launch,
            "plain_ms": plain_ms, "split_plain_ms": split_plain_ms,
            "library_ms": lib_ms, "bounds": b, "max_abs_err": err,
            "max_share_of_tolerance": share, "simt_max_abs_err": simt_err,
            "simt_max_share_of_tolerance": simt_share,
            "split_max_abs_err": split_err,
            "shape": f"B={B} S={S} H={H} KV={KV} Dh={Dh} float32 "
                     f"{'causal' if causal else 'non-causal'}"}


# fa_f32_kernel and the SIMT flash backward where they run, float32 past
# Dh 128: nemotron-4-340b's heads (B, S, H, KV, Dh), causal
FA_F32_WIDE_TIME = (1, 1024, 96, 8, 192)


def time_flash_f32_wide(dev, fa_ops, B, S, H, KV, Dh):
    """fa_f32_kernel (the forward's simt route) and the SIMT backward's
    three kernels at a float32 shape past Dh 128, each beside torch's
    SDPA forward or backward in float32 on the same tensors (yardsticks
    the port never calls) and the function's bound at the float32 rate."""
    import torch.nn.functional as F

    q, k, v, dout = fa_bwd_inputs(dev, B, S, H, KV, Dh, torch.float32, 11)
    if fa_ops.fwd_kernel(q) != "fa_f32_kernel" or \
            fa_ops.bwd_route(q, k, v) != "simt":
        fail(f"float32 at Dh {Dh} does not take the simt routes")
    fwd_ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True), 5)
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    sdpa_ms = cuda_ms(sdpa, 5)
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=True)
    bwd_ms = cuda_ms(lambda: run_bwd_route(fa_ops, "simt", q, k, v, out, lse,
                                           dout, True, 0), 3)
    sdpa_bwd = sdpa_bwd_ms(q, k, v, dout, True, 3)
    fb = fa_f32_bounds(B, S, H, KV, Dh)["function"]
    bb = fa_bwd_bounds(B, S, H, KV, Dh, True, 0, torch.float32)["function"]
    shape = fa_bwd_shape(B, S, H, KV, Dh, True, torch.float32)
    print(f"[time] flash float32 past Dh 128 at {shape}: fa_f32_kernel "
          f"{fwd_ms:.4f} ms (bound {fb[0]:.5f} ms, {fb[1]}), torch's SDPA "
          f"forward {sdpa_ms:.4f} ms ({sdpa_ms / fwd_ms:.2f}x the kernel's "
          f"time); the SIMT backward's three kernels {bwd_ms:.4f} ms (bound "
          f"{bb[0]:.5f} ms, {bb[1]}), SDPA's backward {sdpa_bwd:.4f} ms "
          f"({sdpa_bwd / bwd_ms:.2f}x)", flush=True)
    return {"shape": shape, "fwd_ms": fwd_ms, "sdpa_fwd_ms": sdpa_ms,
            "fwd_bound_ms": fb[0], "bwd_ms": bwd_ms,
            "sdpa_bwd_ms": sdpa_bwd, "bwd_bound_ms": bb[0]}


# ------------------------------------------------------------------ [train]
# the flash backward's kernels held to the plain version:
# (label, B, S, H, KV, Dh, causal, window, dtype).  The training shape,
# gemma3-27b's local window, llama4-scout's GQA group 5 at head dim 128,
# zamba2-7b's head dim 112, whisper-tiny's non-causal encoder,
# nemotron-4-340b's training attention (head dim 192, GQA group 12: the
# parts kernels' bf16 shape), the training shape's heads in float32, the
# same four other shapes in float32, nemotron's heads at S = 1024 in
# float32 (head dim 192: the simt route) and the float32 training step's
# own attention (train_f32: B=2, S=256)
FA_BWD_CHECKS = [
    ("granite-3-2b training", 8, 1024, 32, 8, 64, True, 0, torch.bfloat16),
    ("gemma3-27b local window", 1, 2048, 32, 16, 128, True, 1024,
     torch.bfloat16),
    ("llama4-scout GQA group 5", 1, 1024, 40, 8, 128, True, 0,
     torch.bfloat16),
    ("zamba2-7b head dim 112", 2, 896, 32, 32, 112, True, 0, torch.bfloat16),
    ("whisper-tiny encoder", 4, 1500, 6, 6, 64, False, 0, torch.bfloat16),
    ("nemotron-4-340b training", 1, 4096, 96, 8, 192, True, 0,
     torch.bfloat16),
    ("granite-3-2b heads in float32", 2, 1024, 32, 8, 64, True, 0,
     torch.float32),
    ("gemma3-27b local window in float32", 1, 2048, 32, 16, 128, True, 1024,
     torch.float32),
    ("llama4-scout GQA group 5 in float32", 1, 1024, 40, 8, 128, True, 0,
     torch.float32),
    ("zamba2-7b head dim 112 in float32", 2, 896, 32, 32, 112, True, 0,
     torch.float32),
    ("whisper-tiny encoder in float32", 4, 1500, 6, 6, 64, False, 0,
     torch.float32),
    ("nemotron-4-340b heads in float32", 1, 1024, 96, 8, 192, True, 0,
     torch.float32),
    ("granite-3-2b float32 step", 2, 256, 32, 8, 64, True, 0,
     torch.float32),
]
# the rows time_flash_bwd times: the bf16 pair's training shape, the
# float32 check row, nemotron's training attention
FA_BWD_TRAINING_ROW = "granite-3-2b training"
FA_BWD_F32_ROW = "granite-3-2b heads in float32"
FA_BWD_NEMOTRON_ROW = "nemotron-4-340b training"
# kernel against plain on identical inputs: float32 sums in other orders;
# in bfloat16 a p or ds on a rounding edge may round the other way, and
# the outputs round to bfloat16 (2**-8 relative).  lse is float32 either
# way (absolute, on values of magnitude ~log S)
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
# the wrappers of each backward route's kernels, in launch order: the
# wgmma route's pair (bf16 at Dh <= 128; its dq pass writes delta) or its
# parts kernels (bf16 past Dh 128, float32 up to 128: fa_bwd_prep writes
# delta and float32's bf16 parts), ops.wgmma_kernels choosing; the simt
# route (float32 past Dh 128) has a delta kernel.  Each wrapper launches
# the kernel of its name
BWD_ROUTE_KERNELS = {"pair": ("fa_bwd_dq_wgmma", "fa_bwd_dkdv_wgmma"),
                     "parts": ("fa_bwd_prep", "fa_bwd_dq_parts",
                               "fa_bwd_dkdv_parts"),
                     "simt": ("fa_bwd_delta", "fa_bwd_dkdv", "fa_bwd_dq")}
BWD_KERNELS = tuple(n for names in BWD_ROUTE_KERNELS.values()
                    for n in names)
# the wgmma route's instances (pair: dq <DP, BK>, dkdv <DP>; parts: dq
# <DP, WGS, STAGES, PARTS>, dkdv <DP, STAGES, PARTS>): [build] fails
# without their ptxas lines, HGMMA and UTMALDG
FA_BWD_INSTANCES = ("fa_bwd_dq_wgmma_kernel<64, 128>",
                    "fa_bwd_dq_wgmma_kernel<128, 64>",
                    "fa_bwd_dkdv_wgmma_kernel<64>",
                    "fa_bwd_dkdv_wgmma_kernel<128>",
                    "fa_bwd_dq_parts_kernel<192, 2, 2, 1>",
                    "fa_bwd_dq_parts_kernel<256, 1, 2, 1>",
                    "fa_bwd_dq_parts_kernel<64, 2, 2, 3>",
                    "fa_bwd_dq_parts_kernel<128, 1, 1, 3>",
                    "fa_bwd_dkdv_parts_kernel<192, 3, 1>",
                    "fa_bwd_dkdv_parts_kernel<256, 2, 1>",
                    "fa_bwd_dkdv_parts_kernel<64, 3, 3>",
                    "fa_bwd_dkdv_parts_kernel<128, 1, 3>")
# the archs trained at full width and depth: Trainer with TRAIN_RUN, the
# launcher's AdamW (lr 3e-4, warm-up max(10, steps // 20)) in the config's
# fp32 mode, remat on
TRAIN_ARCHS = ("granite-3-2b", "mamba2-780m")
TRAIN_RUN = dict(steps=4, global_batch=8, seq_len=1024)
# the card-vs-CPU step at full width and a cut depth, on a batch the CPU
# computes in seconds: granite and mamba2 at depth 2, zamba2 at 3 (one
# unit: two Mamba2 blocks and the shared attention at head dim 112); a
# restart from a checkpoint is checked on granite's
TRAIN_SMALL = {"granite-3-2b": 2, "mamba2-780m": 2, "zamba2-7b": 3}
TRAIN_SMALL_RUN = dict(global_batch=2, seq_len=256)
# the SSM archs' CPU step at one sequence of two chunks (zamba2's took 35
# s at two sequences)
TRAIN_SMALL_BATCH = {"mamba2-780m": 1, "zamba2-7b": 1}
TRAIN_RESTART_ARCH = "granite-3-2b"
# card against CPU, one step at the cut depth (bfloat16 activations, the
# config's): the loss (absolute), the gradient norm (relative), each
# gradient leaf relative to its largest magnitude (as
# tests/test_torch_cuda.py's model backward), and the step's update
# (relative L2 over all leaves: an element whose gradient is near zero may
# take the other sign, and Adam's first step moves it by lr either way)
TRAIN_CARD_CPU_TOL = {"loss": 0.02, "grad_norm": 0.02, "grad_leaf": 0.06,
                      "update_l2": 0.1}
# the float32 steps: granite-3-2b (the flash parts kernels' model path)
# and mamba2-780m (the SSD scan's parts route and the SIMT SSD backward)
# at depth 2 and full width with compute dtype float32, one step each on
# the card through Trainer (the launch counts set to 0 before and read
# after) and one against the CPU from the same state and batch,
# TRAIN_SMALL_RUN; both sides in float32, sums in other orders (the
# argument: CHANGES.md)
TRAIN_F32_ARCHS = ("granite-3-2b", "mamba2-780m")
TRAIN_F32_TOL = {"loss": 1e-4, "grad_norm": 1e-4, "grad_leaf": 1e-3,
                 "update_l2": 0.02}


def live_pairs(S, causal, window) -> int:
    """The query-key pairs inside the band, per (batch, head)."""
    from repro_torch.kernels.flash_attention import ref
    return int(ref.band_mask(S, causal, window).sum())


def fa_bwd_bounds(B, S, H, KV, Dh, causal, window, dtype):
    """Each backward kernel's bound, and the whole function's: {wrapper:
    (ms, by, ops, bytes), "function": ...}.
    Operations at the card's peak for the type (the products each kernel
    runs: dkdv recomputes q.k and do.v and runs P^T.dO and dS^T.Q, dq
    recomputes both and runs dS.K; the function's five), bytes each input
    read once and each output written once (the pair's dq pass reads out
    and writes delta besides; the simt one reads the delta kernel's).  The
    parts kernels on float32 run bf16 products on the tensor cores: each
    recomputation six terms and each accumulation three over three bf16
    parts an operand (6 bytes an element), so their operations are those
    terms at the bf16 peak; fa_bwd_prep moves bytes only (it reads out,
    dout and lse and writes the rows buffer; for float32 it also reads q,
    k and v and writes their parts and dout's)."""
    e = 2 if dtype == torch.bfloat16 else 4
    peak = H100_BF16_OPS_PER_S if dtype == torch.bfloat16 else \
        H100_FP32_OPS_PER_S
    prod = 2 * B * H * Dh * live_pairs(S, causal, window)
    q = B * S * H * Dh * e                   # q, out, dout or dq
    kv = B * S * KV * Dh * e                 # k, v, dk or dv
    rows = B * H * S * 4                     # lse or delta, float32
    dkdv = (4 * prod, 2 * q + 2 * kv + 2 * rows + 2 * kv)
    # the parts kernels: operands in bf16 parts, the rows buffer (lse,
    # delta) read, outputs in the inputs' type
    f32 = dtype == torch.float32
    pe = 6 if f32 else 2                     # bytes an operand element
    pq, pkv = q // e * pe, kv // e * pe
    rterms, aterms = (6, 3) if f32 else (1, 1)
    parts_dq = ((2 * rterms + aterms) * prod,
                2 * pq + 2 * pkv + 2 * rows + q)
    parts_dkdv = ((2 * rterms + 2 * aterms) * prod,
                  2 * pq + 2 * pkv + 2 * rows + 2 * kv)
    prep = (0, 2 * q + rows + 2 * rows
            + ((q + 2 * kv + 2 * pq + 2 * pkv) if f32 else 0))
    work = {"fa_bwd_dq_wgmma": (3 * prod, 3 * q + 2 * kv + rows + q + rows),
            "fa_bwd_dkdv_wgmma": dkdv,
            "fa_bwd_delta": (0, 2 * q + rows),
            "fa_bwd_dkdv": dkdv,
            "fa_bwd_dq": (3 * prod, 2 * q + 2 * kv + 2 * rows + q),
            "function": (5 * prod, 3 * q + 2 * kv + rows + q + 2 * kv)}

    def bound(ops, nbytes, rate=peak):
        t_ops, t_bytes = ops / rate, nbytes / H100_BYTES_PER_S
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops > t_bytes else "bytes", ops, nbytes)
    out = {n: bound(*w) for n, w in work.items()}
    out.update({"fa_bwd_prep": bound(*prep),
                "fa_bwd_dq_parts": bound(*parts_dq, H100_BF16_OPS_PER_S),
                "fa_bwd_dkdv_parts": bound(*parts_dkdv,
                                           H100_BF16_OPS_PER_S)})
    return out


def fa_bwd_inputs(dev, B, S, H, KV, Dh, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((B, S, n, Dh), generator=g, device=dev
                             ).to(dtype) for n in (H, KV, KV, H))


def fa_bwd_row(label):
    return next(r for r in FA_BWD_CHECKS if r[0] == label)


def close_err(got, want, tol):
    """(max |got - want|, whether every element is within tol + tol *
    |want| (torch.testing's atol = rtol = tol), the largest share of that
    tolerance an element takes)."""
    d = (got.float() - want.float()).abs()
    room = tol + tol * want.float().abs()
    return float(d.max()), bool((d <= room).all()), float((d / room).max())


def run_bwd_route(fa_ops, route, q, k, v, out, lse, dout, causal, window):
    """One backward through ``route``'s kernel wrappers ("pair", "parts"
    or "simt"): (dq, dk, dv, delta); the pair's dq pass and fa_bwd_prep
    write delta (into the rows buffer, beside lse), the simt route's
    delta kernel does."""
    if route == "pair":
        dq, rows = fa_ops.fa_bwd_dq_wgmma(q, k, v, out, dout, lse, causal,
                                          window)
        dk, dv = fa_ops.fa_bwd_dkdv_wgmma(q, k, v, dout, rows, causal,
                                          window)
        return dq, dk, dv, fa_ops.rows_delta(rows, q.shape[1])
    if route == "parts":
        rows, operands = fa_ops.fa_bwd_prep(q, k, v, out, dout, lse)
        dq = fa_ops.fa_bwd_dq_parts(q, operands, rows, causal, window)
        dk, dv = fa_ops.fa_bwd_dkdv_parts(q, k, operands, rows, causal,
                                          window)
        return dq, dk, dv, fa_ops.rows_delta(rows, q.shape[1])
    delta = fa_ops.fa_bwd_delta(out, dout)
    dk, dv = fa_ops.fa_bwd_dkdv(q, k, v, dout, lse, delta, causal, window)
    dq = fa_ops.fa_bwd_dq(q, k, v, dout, lse, delta, causal, window)
    return dq, dk, dv, delta


# the error keys of each route's (delta, dq, dkdv): the pair's delta is
# its dq pass's, the parts kernels' fa_bwd_prep's
BWD_ERR_NAMES = {"pair": ("wgmma_delta", "fa_bwd_dq_wgmma",
                          "fa_bwd_dkdv_wgmma"),
                 "parts": ("fa_bwd_prep", "fa_bwd_dq_parts",
                           "fa_bwd_dkdv_parts"),
                 "simt": ("fa_bwd_delta", "fa_bwd_dq", "fa_bwd_dkdv")}


def check_flash_bwd(dev, fa_ops, fa_ref):
    """The forward's lse (both routes) and each backward route's kernels
    against the plain versions at FA_BWD_CHECKS, on identical inputs: the
    kernels' forward output and lse feed both backwards.  A row whose
    route is wgmma runs its kernels (the pair or the parts kernels) and
    the simt route beside them, and a second wgmma backward
    (flash_attention_bwd's own choice) must equal the first bit for bit;
    a float32 row past Dh 128 runs the simt route.  Each route's delta is
    held to the einsum.  Returns ({key: the largest absolute error} over
    every row, and over the float32 rows, {key: the largest share of its
    tolerance}): the keys are lse and BWD_ERR_NAMES' (the pair's delta
    under "wgmma_delta", the parts kernels' under "fa_bwd_prep")."""
    err, err_f32, share = {"lse": 0.0}, {}, {}
    for label, B, S, H, KV, Dh, causal, window, dtype in FA_BWD_CHECKS:
        q, k, v, dout = fa_bwd_inputs(dev, B, S, H, KV, Dh, dtype, S + H)
        kw = dict(causal=causal, window=window)
        out, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
        want_out, want_lse = fa_ref.flash_attention_fwd(q, k, v, **kw)
        tol = FA_BWD_TOL[dtype]
        checks = {"lse": close_err(lse, want_lse, LSE_TOL)}
        routes = (fa_ops.wgmma_kernels(q), "simt") \
            if fa_ops.bwd_route(q, k, v) == "wgmma" else ("simt",)
        want_delta = torch.einsum("bshd,bshd->bhs", dout.float(),
                                  out.float())
        wq, wk, wv = fa_ref.flash_attention_bwd(q, k, v, out, lse, dout,
                                                **kw)
        same = None
        for route in routes:
            dq, dk, dv, delta = run_bwd_route(fa_ops, route, q, k, v, out,
                                              lse, dout, causal, window)
            torch.cuda.synchronize()
            n_delta, n_dq, n_dkdv = BWD_ERR_NAMES[route]
            checks[n_delta] = close_err(delta, want_delta, 1e-4)
            ek, okk, sk = close_err(dk, wk, tol)
            ev, okv, sv = close_err(dv, wv, tol)
            checks[n_dkdv] = (max(ek, ev), okk and okv, max(sk, sv))
            checks[n_dq] = close_err(dq, wq, tol)
            if route != "simt":
                again = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   **kw)
                same = all(torch.equal(a, b) for a, b in
                           zip(again, (dq, dk, dv)))
                del again
            del dq, dk, dv, delta
        for name, (e, _, sh) in checks.items():
            err[name] = max(err.get(name, 0.0), e)
            share[name] = max(share.get(name, 0.0), sh)
            if dtype == torch.float32:
                err_f32[name] = max(err_f32.get(name, 0.0), e)
        print(f"[train] flash backward against its plain version, {label} "
              f"(B={B} S={S} H={H} KV={KV} Dh={Dh} "
              f"{'causal' if causal else 'non-causal'} window={window} "
              f"{str(dtype)[6:]}; routes {routes}): max abs err lse "
              f"{checks['lse'][0]:.3e} (tol {LSE_TOL}); "
              + "; ".join(f"{n} {e:.3e} ({sh:.3f} of its tolerance)"
                          for n, (e, _, sh) in checks.items() if n != "lse")
              + f" (tol {tol}, delta 1e-4); forward "
              f"{close_err(out, want_out, FA_TOL[dtype])[0]:.3e}"
              + ("" if same is None else
                 f"; two wgmma backwards bit-identical: {same}"),
              flush=True)
        bad = [n for n, (_, ok, _) in checks.items() if not ok]
        if bad:
            fail(f"flash backward {label}: {bad} beyond the tolerance")
        if same is False:
            fail(f"flash backward {label}: two wgmma backwards differ")
        del q, k, v, dout, out, lse, wq, wk, wv
        torch.cuda.empty_cache()
    return err, err_f32, share


def sdpa_bwd_ms(q, k, v, dout, causal, reps):
    """torch's SDPA backward on these tensors (a yardstick: the port never
    calls it), ms a call."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                       enable_gqa=True)
    dot = dout.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True), reps)


def fa_bwd_shape(B, S, H, KV, Dh, causal, dtype):
    return (f"B={B} S={S} H={H} KV={KV} Dh={Dh} {str(dtype)[6:]} "
            f"{'causal' if causal else 'non-causal'}")


def bwd_time_row(name, t, b, shape, plain_ms, plain_d, sdpa):
    """One kernel's [time] line and its figures: ms beside its bound,
    the plain version (the delta kernels': the einsum) and SDPA's
    backward (delta's library call: the einsum)."""
    b_ms, by, ops, nbytes = b[name]
    print(f"[time] {name} at {shape}: {t:.4f} ms, bound {b_ms:.5f} ms "
          f"({by}: {ops} flops, {nbytes} bytes)"
          + (f", {ops / t / 1e9:.2f} TFLOP/s" if ops else ""), flush=True)
    delta = name in ("fa_bwd_delta", "fa_bwd_prep")
    return {"ms": t, "bound_ms": b_ms, "bound_by": by, "shape": shape,
            "plain_ms": plain_d if delta else plain_ms,
            "library_ms": plain_d if delta else sdpa}


def time_routes_at(dev, fa_ops, fa_ref, label, reps_simt):
    """At FA_BWD_CHECKS' row ``label``: the parts kernels one by one and
    flash_attention_bwd (its route), the simt kernels, the plain version,
    the delta einsum and SDPA's backward, CUDA events after a warm-up.
    Returns (the figures, the bounds, the shape)."""
    _, B, S, H, KV, Dh, causal, window, dtype = fa_bwd_row(label)
    q, k, v, dout = fa_bwd_inputs(dev, B, S, H, KV, Dh, dtype, 7)
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    wargs = (causal, window)
    rows, operands = fa_ops.fa_bwd_prep(q, k, v, out, dout, lse)
    parts = {"fa_bwd_prep": cuda_ms(lambda: fa_ops.fa_bwd_prep(
                 q, k, v, out, dout, lse), 20),
             "fa_bwd_dq_parts": cuda_ms(lambda: fa_ops.fa_bwd_dq_parts(
                 q, operands, rows, *wargs), 10),
             "fa_bwd_dkdv_parts": cuda_ms(lambda: fa_ops.fa_bwd_dkdv_parts(
                 q, k, operands, rows, *wargs), 10)}
    call = cuda_ms(lambda: fa_ops.flash_attention_bwd(
        q, k, v, out, lse, dout, causal=causal, window=window), 10)
    sdelta = fa_ops.fa_bwd_delta(out, dout)
    sargs = (q, k, v, dout, lse, sdelta, *wargs)
    simt = {"fa_bwd_delta": cuda_ms(lambda: fa_ops.fa_bwd_delta(out, dout),
                                    20),
            "fa_bwd_dkdv": cuda_ms(lambda: fa_ops.fa_bwd_dkdv(*sargs),
                                   reps_simt),
            "fa_bwd_dq": cuda_ms(lambda: fa_ops.fa_bwd_dq(*sargs),
                                 reps_simt)}
    plain_delta = cuda_ms(lambda: torch.einsum(
        "bshd,bshd->bhs", dout.float(), out.float()), 5)
    plain = cuda_ms(lambda: fa_ref.flash_attention_bwd(
        q, k, v, out, lse, dout, causal=causal, window=window), 1)
    sdpa = sdpa_bwd_ms(q, k, v, dout, causal, 10)
    del q, k, v, dout, out, lse, rows, operands, sdelta
    torch.cuda.empty_cache()
    return ({"parts": parts, "call": call, "simt": simt, "plain": plain,
             "plain_delta": plain_delta, "sdpa": sdpa},
            fa_bwd_bounds(B, S, H, KV, Dh, causal, window, dtype),
            fa_bwd_shape(B, S, H, KV, Dh, causal, dtype))


def time_flash_bwd(dev, fa_ops, fa_ref):
    """The pair at the training shape (and the simt kernels there), the
    parts kernels, the simt kernels and SDPA's backward at the float32
    check row and at nemotron-4-340b's training attention, each beside its
    bound and the plain version (CUDA events, after a warm-up).  Returns
    ({wrapper: row}, the function's figures)."""
    rows = {}
    _, B, S, H, KV, Dh, causal, window, dtype = fa_bwd_row(
        FA_BWD_TRAINING_ROW)
    q, k, v, dout = fa_bwd_inputs(dev, B, S, H, KV, Dh, dtype, 7)
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal)
    wargs = (causal, window)
    _, rbuf = fa_ops.fa_bwd_dq_wgmma(q, k, v, out, dout, lse, *wargs)
    ms = {"fa_bwd_dq_wgmma": cuda_ms(lambda: fa_ops.fa_bwd_dq_wgmma(
              q, k, v, out, dout, lse, *wargs), 20),
          "fa_bwd_dkdv_wgmma": cuda_ms(lambda: fa_ops.fa_bwd_dkdv_wgmma(
              q, k, v, dout, rbuf, *wargs), 20)}
    both = cuda_ms(lambda: fa_ops.flash_attention_bwd(
        q, k, v, out, lse, dout, causal=causal, window=window), 20)
    sdelta = fa_ops.fa_bwd_delta(out, dout)
    sargs = (q, k, v, dout, lse, sdelta, causal, window)
    simt_bf16 = {"fa_bwd_delta": cuda_ms(lambda: fa_ops.fa_bwd_delta(
                     out, dout), 20),
                 "fa_bwd_dkdv": cuda_ms(lambda: fa_ops.fa_bwd_dkdv(*sargs), 5),
                 "fa_bwd_dq": cuda_ms(lambda: fa_ops.fa_bwd_dq(*sargs), 5)}
    plain_delta = cuda_ms(lambda: torch.einsum(
        "bshd,bshd->bhs", dout.float(), out.float()), 5)
    plain = cuda_ms(lambda: fa_ref.flash_attention_bwd(
        q, k, v, out, lse, dout, causal=causal), 2)
    sdpa_bwd = sdpa_bwd_ms(q, k, v, dout, causal, 10)
    bounds = fa_bwd_bounds(B, S, H, KV, Dh, causal, window, dtype)
    shape = fa_bwd_shape(B, S, H, KV, Dh, causal, dtype)
    for name, t in ms.items():
        rows[name] = bwd_time_row(name, t, bounds, shape, plain, plain_delta,
                                  sdpa_bwd)
    del q, k, v, dout, out, lse, rbuf, sdelta
    torch.cuda.empty_cache()

    # the parts kernels and the simt route at the float32 check row (the
    # float32 step's dtype) and at nemotron's shape (bf16, Dh 192), SDPA's
    # backward beside them
    f32, f_bounds, f_shape = time_routes_at(dev, fa_ops, fa_ref,
                                            FA_BWD_F32_ROW, 5)
    nem, n_bounds, n_shape = time_routes_at(dev, fa_ops, fa_ref,
                                            FA_BWD_NEMOTRON_ROW, 2)
    for name in BWD_ROUTE_KERNELS["parts"]:
        rows[name] = bwd_time_row(name, f32["parts"][name], f_bounds, f_shape,
                                  f32["plain"], f32["plain_delta"],
                                  f32["sdpa"])
        rows[name]["at_nemotron_training"] = bwd_time_row(
            name, nem["parts"][name], n_bounds, n_shape, nem["plain"],
            nem["plain_delta"], nem["sdpa"])
    for name in BWD_ROUTE_KERNELS["simt"]:
        rows[name] = bwd_time_row(name, f32["simt"][name], f_bounds, f_shape,
                                  f32["plain"], f32["plain_delta"],
                                  f32["sdpa"])
        rows[name]["at_bf16_training_shape"] = {
            "shape": shape, "ms": simt_bf16[name],
            "bound_ms": bounds[name][0],
            "library_ms": plain_delta if name == "fa_bwd_delta"
            else sdpa_bwd}
        rows[name]["at_nemotron_training"] = bwd_time_row(
            name, nem["simt"][name], n_bounds, n_shape, nem["plain"],
            nem["plain_delta"], nem["sdpa"])

    total = sum(ms.values())
    simt_total = sum(simt_bf16.values())
    f_ms, f_by, f_ops, f_bytes = bounds["function"]
    print(f"[time] flash backward at {shape}: the pair's two kernels "
          f"{total:.4f} ms ({f_ops / total / 1e9:.2f} TFLOP/s of the "
          f"function's five products; flash_attention_bwd {both:.4f} ms a "
          f"call), the simt route's three {simt_total:.4f} ms "
          f"({simt_bf16}), bound {f_ms:.5f} ms ({f_by}; the pair's seven "
          f"products {1.4 * f_ms:.5f} ms); plain {plain:.3f} ms (delta "
          f"alone, one einsum {plain_delta:.4f} ms); torch's SDPA backward "
          f"{sdpa_bwd:.4f} ms", flush=True)
    routes = {}
    for tag, fig, bnd, shp in (("float32", f32, f_bounds, f_shape),
                               ("nemotron", nem, n_bounds, n_shape)):
        p_total, s_total = sum(fig["parts"].values()), sum(
            fig["simt"].values())
        fb = bnd["function"]
        routes[tag] = {"shape": shp, "parts_ms": p_total,
                       "call_ms": fig["call"], "simt_ms": s_total,
                       "sdpa_backward_ms": fig["sdpa"],
                       "plain_ms": fig["plain"], "bound_ms": fb[0],
                       "bound_by": fb[1],
                       "parts_vs_sdpa": fig["sdpa"] / fig["call"],
                       "simt_vs_parts": s_total / fig["call"]}
        print(f"[time] flash backward at {shp}: the parts kernels "
              f"{p_total:.4f} ms ({fig['parts']}; flash_attention_bwd "
              f"{fig['call']:.4f} ms a call), the simt route "
              f"{s_total:.4f} ms ({fig['simt']}); the function's bound "
              f"{fb[0]:.5f} ms ({fb[1]}: five products at the "
              f"{'float32' if 'float32' in shp else 'bf16'} peak); plain "
              f"{fig['plain']:.3f} ms; torch's SDPA backward "
              f"{fig['sdpa']:.4f} ms: flash_attention_bwd "
              f"{fig['sdpa'] / fig['call']:.2f}x SDPA's speed, "
              f"{s_total / fig['call']:.2f}x the simt route's", flush=True)
    return rows, {"ms": total, "call_ms": both, "bound_ms": f_ms,
                  "bound_by": f_by, "plain_ms": plain,
                  "sdpa_backward_ms": sdpa_bwd, "shape": shape,
                  "simt_route_ms": simt_total, "parts_routes": routes}


def model_flops(cfg, B, S):
    """A training step's model FLOPs: 3x the forward's (forward and
    backward; remat's recompute not counted), and 4x with the recompute.
    The forward's: every weight once a token (2 n B S; the embedding table
    as the tied unembedding's matmul, norms negligible); causal attention,
    4 B H Dh pairs a layer (q.k and p.v over the pairs s <= l); and per
    Mamba2 layer the chunked scan's products, as ssd_bound counts them
    (per (b, head, chunk) Q(Q+1) P for (C B^T o L) xdt over the pairs and
    4 Q P N for C S^T and the state's update; C B^T once per (b, chunk),
    Q(Q+1) N)."""
    from repro_torch.distributed.sharding import param_count
    from repro_torch.models import api
    n = param_count(api.param_specs(cfg))
    kinds = cfg.all_layer_kinds()
    n_ssd = kinds.count("mamba")
    matmul = 2 * n * B * S
    n_attn = len(kinds) - n_ssd
    attn = 4 * B * cfg.n_heads * cfg.head_dim * live_pairs(S, True, 0) \
        * n_attn if n_attn else 0
    ssd = 0
    if n_ssd:
        ssm = cfg.ssm
        H, P, N = ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state
        Q = min(ssm.chunk, S)
        nc = S // Q
        ssd = n_ssd * (B * H * nc * (Q * (Q + 1) * P + 4 * Q * P * N)
                       + B * nc * Q * (Q + 1) * N)
    fwd = matmul + attn + ssd
    return 3 * fwd, 4 * fwd, n


# the profiled step's device time, by group: a kernel goes to the first
# group one of whose patterns its name holds
TRAIN_GROUPS = (("flash backward", ("fa_bwd",)),
                ("flash forward", ("fa_wgmma", "fa_fwd", "fa_f32")),
                ("SSD backward", ("ssd_bwd",)),
                ("SSD forward", ("ssd_wgmma", "ssd_parts", "ssd_f32")),
                ("matmuls", ("gemm", "gemv", "nvjet", "sm90_xmma", "cutlass",
                             "cublas", "Kernel2")))


def profile_train_step(run_step):
    """One step under torch.profiler: the device time by kernel, grouped."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3
    groups = collections.Counter()
    for name, t in by_kernel.items():
        key = next((g for g, pats in TRAIN_GROUPS
                    if any(p in name for p in pats)),
                   "elementwise and the rest")
        groups[key] += t
    return wall_ms, sum(by_kernel.values()), groups, by_kernel


def train_launches(cfg) -> dict:
    """The launches a training step must show, by wrapper: the flash
    forward twice an attention layer under remat and each backward kernel
    that ``ops.bwd_kernels`` names for the config's dtype and head dim
    once; the SSD scan twice a Mamba2 layer and its backward once."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    kinds = cfg.all_layer_kinds()
    n_ssd = kinds.count("mamba")
    n_attn = len(kinds) - n_ssd
    want = {}
    if n_attn:
        route = fa_ops.bwd_kernels(getattr(torch, cfg.dtype), cfg.head_dim)
        want.update({"flash_attention": 2 * n_attn,
                     **dict.fromkeys(BWD_ROUTE_KERNELS[route], n_attn)})
    if n_ssd:
        want.update(ssd_scan=2 * n_ssd, ssd_bwd=n_ssd)
    return want


def _ssd_meta(cfg):
    """x, B_, C_ of a config's SSD scan as meta tensors of its dtype."""
    dtype, ssm = getattr(torch, cfg.dtype), cfg.ssm
    H, P, N = ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state
    return (torch.empty((1, 1, H, P), dtype=dtype, device="meta"),
            torch.empty((1, 1, N), dtype=dtype, device="meta"),
            torch.empty((1, 1, N), dtype=dtype, device="meta"))


def train_ssd_routes(cfg) -> dict:
    """The SSD scan's launches a training step must show, by route
    (``ops.ROUTES``): two a Mamba2 layer under remat, all on the route
    ``ops.route`` names for the config's dtype."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    n_ssd = cfg.all_layer_kinds().count("mamba")
    want = dict.fromkeys(ssd_ops.ROUTES, 0)
    if n_ssd:
        want[ssd_ops.route(*_ssd_meta(cfg))] = 2 * n_ssd
    return want


def train_ssd_bwd_routes(cfg) -> dict:
    """The SSD backward's calls a training step must show, by route: one a
    Mamba2 layer, on the route ``ops.bwd_route`` names for the config's
    dtype."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    n_ssd = cfg.all_layer_kinds().count("mamba")
    want = dict.fromkeys(ssd_ops.BWD_ROUTES, 0)
    if n_ssd:
        x, B_, C_ = _ssd_meta(cfg)
        want[ssd_ops.bwd_route(x, B_, C_, x)] = n_ssd
    return want


def train_fwd_routes(cfg) -> dict:
    """The flash forward's launches a training step must show, by kernel
    (``ops.FWD_KERNELS``): two an attention layer under remat, all on the
    kernel ``ops.fwd_kernel`` names for the config's dtype and head dim."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    n_attn = sum(k != "mamba" for k in cfg.all_layer_kinds())
    want = dict.fromkeys(fa_ops.FWD_KERNELS, 0)
    if n_attn:
        q = torch.empty((0, cfg.head_dim), dtype=getattr(torch, cfg.dtype),
                        device="meta")
        want[fa_ops.fwd_kernel(q)] = 2 * n_attn
    return want


def train_full(dev, kernels, fa_ops, arch):
    """``arch`` at full width and depth through Trainer: TRAIN_RUN's
    steps, the launch counts set to 0 before and read after; then one more
    step under the profiler.  Returns the drive's figures."""
    import dataclasses
    import signal

    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_drive = time.perf_counter()
    cfg = get_config(arch)
    if not (cfg.remat and cfg.param_dtype == "float32"
            and cfg.optimizer_mode == "fp32"):
        fail(f"{arch}: expected remat, float32 parameters and the fp32 "
             "optimizer")
    steps = TRAIN_RUN["steps"]
    tc = TrainerConfig(steps=steps, global_batch=TRAIN_RUN["global_batch"],
                       seq_len=TRAIN_RUN["seq_len"], log_every=1,
                       opt=AdamWConfig(total_steps=steps + 1,
                                       warmup=max(10, steps // 20),
                                       mode=cfg.optimizer_mode))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, device=dev)
    state = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bwd = [getattr(fa_ops, n) for n in BWD_KERNELS]
    reset_launches(*kernels.values(), *bwd)
    t0 = time.perf_counter()
    state, _ = tr.run(state, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {name: w.launches for name, w in kernels.items()}
    got.update({n: w.launches for n, w in zip(BWD_KERNELS, bwd)})
    peak = torch.cuda.max_memory_allocated()
    hist = list(tr.history)
    for h in hist:
        print(f"[train] {cfg.name} step {h['step']}: loss {h['loss']!r}, "
              f"grad_norm {h['grad_norm']!r}, lr {h['lr']:.3e}, wall "
              f"{h['step_time_s']:.4f} s", flush=True)
    per_step = {n: c / steps for n, c in got.items() if c}
    want = train_launches(cfg)
    launched = {n: c for n, c in got.items() if c}
    print(f"[train] {cfg.name} (full width and depth, {cfg.n_layers} "
          f"layers, remat on): {steps} steps of B={tc.global_batch} "
          f"S={tc.seq_len} in {wall:.3f} s; state {state_bytes / 1e9:.3f} GB "
          f"(params, m, v) drawn in {init_s:.2f} s (peak "
          f"{init_peak / 1e9:.3f} GB); peak during the steps {peak} B "
          f"({peak / 1e9:.3f} GB); launches a step {per_step} (expected "
          f"{want})", flush=True)
    if per_step != want:
        fail(f"{cfg.name} training: launches a step {per_step}, expected "
             f"{want} (each forward kernel twice a layer of its kind under "
             f"remat, each backward kernel once)")
    ssd_routes = dict(kernels["ssd_bwd"].routes)
    if ssd_routes != {"simt": 0, "wgmma": got["ssd_bwd"]}:
        fail(f"{cfg.name} training: the SSD backward's calls by route "
             f"{ssd_routes}, expected all {got['ssd_bwd']} on the wgmma "
             "route")
    losses = [h["loss"] for h in hist]
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            not all(np.isfinite(h["grad_norm"]) for h in hist):
        fail(f"{cfg.name} training: losses {losses} are not finite")
    # one more step under the profiler: where the device time goes
    tr.tc = dataclasses.replace(tc, steps=steps + 1, log_every=0)
    holder = [state]

    def one_step():
        holder[0], _ = tr.run(holder[0], steps)
    prof_wall, busy, groups, by_kernel = profile_train_step(one_step)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)   # the trainer's handler
    flops, flops_remat, n_params = model_flops(cfg, tc.global_batch,
                                               tc.seq_len)
    step_s = float(np.median([h["step_time_s"] for h in hist[1:steps]]))
    mfu = flops / step_s / H100_BF16_OPS_PER_S
    share = {g: t / busy for g, t in groups.items()}
    top = ", ".join(f"{k[:48]}={v:.2f}" for k, v in by_kernel.most_common(8))
    print(f"[train] {cfg.name} profiled step: wall {prof_wall:.2f} ms, "
          f"device busy {busy:.2f} ms; by group (ms) "
          f"{ {g: round(t, 3) for g, t in groups.items()} }; top kernels "
          f"(ms): {top}", flush=True)
    backward = {g: share.get(g, 0.0) for g in ("flash backward",
                                               "SSD backward")}
    n_ssd = cfg.all_layer_kinds().count("mamba")
    ssd_bwd_ms = kernel_ms(by_kernel, SSD_BWD_ROUTE_KERNELS["wgmma"],
                           n_ssd) if n_ssd else {}
    if ssd_bwd_ms:
        print(f"[train] {cfg.name} profiled step: the SSD backward's kernels, "
              f"device ms a call {ssd_bwd_ms} (sum "
              f"{sum(ssd_bwd_ms.values()):.4f} ms)", flush=True)
    drive_s = time.perf_counter() - t_drive
    print(f"[train] {cfg.name}: {n_params} parameters; a step's model "
          f"FLOPs {flops:.4e} ({flops_remat:.4e} with the recompute); "
          f"median step {step_s:.4f} s of steps 1-{steps - 1} -> "
          f"{flops / step_s / 1e12:.2f} TFLOP/s, {100 * mfu:.2f}% of "
          f"989 TFLOP/s; share of the device time: "
          + ", ".join(f"{g} {100 * v:.1f}%" for g, v in backward.items())
          + f"; drive {drive_s:.1f} s", flush=True)
    del state, holder, tr
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "global_batch": tc.global_batch, "seq_len": tc.seq_len,
            "steps": steps, "losses": losses,
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_s": [h["step_time_s"] for h in hist],
            "median_step_s": step_s, "peak_bytes": peak,
            "init_peak_bytes": init_peak, "state_bytes": state_bytes,
            "launches": launched, "launches_per_step": per_step,
            "ssd_bwd_routes": ssd_routes,
            "model_flops": flops,
            "model_flops_with_recompute": flops_remat,
            "model_tflops_per_s": flops / step_s / 1e12, "mfu": mfu,
            "profiled_step": {"wall_ms": prof_wall, "busy_ms": busy,
                              "ms_by_group": dict(groups)},
            "flash_backward_share": backward["flash backward"],
            "ssd_backward_share": backward["SSD backward"],
            "ssd_bwd_device_ms_by_kernel": ssd_bwd_ms,
            "drive_s": drive_s}


def train_small(dev, arch):
    """At full width and TRAIN_SMALL[arch]'s depth: one step on the card
    against the CPU (the same state and batch); for TRAIN_RESTART_ARCH also
    a restart on the card from a checkpoint against the uninterrupted
    run."""
    import signal
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train import step as tstep
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(arch).replace(n_layers=TRAIN_SMALL[arch])
    opt = AdamWConfig(total_steps=4, warmup=2)
    tc = TrainerConfig(steps=4, log_every=0, opt=opt, **{
        **TRAIN_SMALL_RUN, "global_batch": TRAIN_SMALL_BATCH.get(
            arch, TRAIN_SMALL_RUN["global_batch"])})
    base = Trainer(cfg, tc, device=dev)
    state = base.init_state()
    batch = base.pipeline.batch_at(0)
    out = {}
    t0 = time.perf_counter()
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        st = copy_to(state, d)               # the optimizer writes in place
        b = to_device(batch, d)
        (loss, _), grads = tstep.value_and_grad(cfg, st["params"], b)
        before = copy_to(st["params"], "cpu")
        params, _, m = adamw_update(opt, st["params"], grads, st["opt"])
        out[label] = {"loss": float(loss), "grad_norm": float(m["grad_norm"]),
                       "grads": to_device(grads, "cpu"),
                       "update": {k: (a.float() - b_.float()) for (k, a), (_, b_)
                                  in zip(flat_leaves(to_device(params, "cpu")),
                                         flat_leaves(before))}}
        del st, params, grads
    del state
    cpu_s = time.perf_counter() - t0
    card, cpu = out["card"], out["cpu"]
    worst_leaf = max(((float((a.float() - b_.float()).abs().max())
                       / max(float(b_.float().abs().max()), 1e-30), k)
                      for (k, a), (_, b_) in zip(flat_leaves(card["grads"]),
                                                 flat_leaves(cpu["grads"]))))
    diffs = {"loss": abs(card["loss"] - cpu["loss"]),
             "grad_norm": abs(card["grad_norm"] - cpu["grad_norm"])
             / cpu["grad_norm"],
             "grad_leaf": worst_leaf[0],
             "update_l2": float(torch.sqrt(sum(
                 ((card["update"][k] - u) ** 2).sum()
                 for k, u in cpu["update"].items())) / torch.sqrt(sum(
                     (u ** 2).sum() for u in cpu["update"].values())))}
    zero = [k for k, g in flat_leaves(card["grads"])
            if float(g.abs().max()) == 0.0]
    print(f"[train] card vs cpu, {cfg.name} at depth {cfg.n_layers} (full "
          f"width), B={tc.global_batch} S={tc.seq_len}, one step: loss card "
          f"{card['loss']!r} cpu {cpu['loss']!r}, grad_norm card "
          f"{card['grad_norm']!r} cpu {cpu['grad_norm']!r}; differences "
          f"{ {k: float(f'{v:.4e}') for k, v in diffs.items()} } (largest "
          f"leaf difference at {worst_leaf[1]}; tol {TRAIN_CARD_CPU_TOL}); "
          f"leaves without a gradient on the card: {zero or 'none'} "
          f"({cpu_s:.1f} s)", flush=True)
    if zero or any(diffs[k] > TRAIN_CARD_CPU_TOL[k] for k in diffs):
        fail(f"{cfg.name}: training on the card and on the cpu differ "
             f"beyond the tolerance, or a leaf got no gradient: {diffs}")
    res = {"card_vs_cpu": diffs, "depth": cfg.n_layers, "seconds": cpu_s}
    if arch != TRAIN_RESTART_ARCH:
        return res
    # restart: 4 steps uninterrupted against 2, a checkpoint, and 2 more in
    # a new trainer restored from it
    t0 = time.perf_counter()
    state = base.init_state()
    full = Trainer(cfg, tc, device=dev)
    full.run(copy_to(state, dev), 0)
    with tempfile.TemporaryDirectory() as tmp:
        first = Trainer(cfg, TrainerConfig(**{**tc.__dict__, "steps": 2,
                                              "ckpt_dir": tmp}), device=dev)
        first.run(copy_to(state, dev), 0)
        second = Trainer(cfg, TrainerConfig(**{**tc.__dict__,
                                               "ckpt_dir": tmp}), device=dev)
        resumed, start = second.restore_or_init()
        second.run(resumed, start)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    want, got = full.losses()[2:], second.losses()
    print(f"[train] restart on the card, {cfg.name} at depth "
          f"{cfg.n_layers}: resumed at step {start}, losses {got.tolist()} "
          f"against the uninterrupted {want.tolist()} (bit-identical: "
          f"{bool(np.array_equal(got, want))}; {time.perf_counter() - t0:.1f}"
          f" s)", flush=True)
    if start != 2 or not np.allclose(got, want, rtol=1e-5, atol=0):
        fail(f"{cfg.name}: the resumed run's losses {got} differ from the "
             f"uninterrupted run's {want}")
    return {**res, "restart_losses": got.tolist(),
            "uninterrupted_losses": want.tolist()}


def train_f32(dev, kernels, fa_ops, ssd_ops, arch):
    """``arch`` (of TRAIN_F32_ARCHS) at full width and TRAIN_SMALL's depth
    with compute dtype float32: one step through Trainer on the card, the
    launch counts set to 0 before and read after (granite: the flash
    forward's float32 wgmma route, fa_fwd_split and fa_fwd_parts_kernel,
    and none of fa_f32_kernel, and the backward's parts kernels; mamba2:
    the SSD scan's parts route, ssd_split and its kernels, and none of
    ssd_f32_kernel, and the SIMT SSD backward), then one step on the card
    against the CPU from the same state and batch, held to TRAIN_F32_TOL.
    Returns the figures."""
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train import step as tstep
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(arch).replace(n_layers=TRAIN_SMALL[arch],
                                   dtype="float32")
    opt = AdamWConfig(total_steps=4, warmup=2)
    tc = TrainerConfig(steps=1, log_every=0, opt=opt, **TRAIN_SMALL_RUN)
    tr = Trainer(cfg, tc, device=dev)
    state = tr.init_state()
    batch = tr.pipeline.batch_at(0)
    bwd = [getattr(fa_ops, n) for n in BWD_KERNELS]
    reset_launches(*kernels.values(), *bwd, fa_ops.fa_fwd_split,
                   ssd_ops.ssd_split)
    t0 = time.perf_counter()
    tr.run(copy_to(state, dev), 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: w.launches for n, w in kernels.items() if w.launches}
    got.update({n: w.launches for n, w in zip(BWD_KERNELS, bwd)
                if w.launches})
    routes = {"flash forward": dict(fa_ops.flash_attention.routes),
              "fa_fwd_split": fa_ops.fa_fwd_split.launches,
              "ssd_scan": dict(ssd_ops.ssd.routes),
              "ssd_split": ssd_ops.ssd_split.launches,
              "ssd_bwd": dict(ssd_ops.ssd_bwd.routes)}
    fwd, ssd_fwd = train_fwd_routes(cfg), train_ssd_routes(cfg)
    want_routes = {"flash forward": fwd,
                   "fa_fwd_split": fwd["fa_fwd_parts_kernel"],
                   "ssd_scan": ssd_fwd, "ssd_split": ssd_fwd["parts"],
                   "ssd_bwd": train_ssd_bwd_routes(cfg)}
    want = train_launches(cfg)
    print(f"[train] {cfg.name} in float32 at depth {cfg.n_layers} (full "
          f"width), B={tc.global_batch} S={tc.seq_len}: one Trainer step on "
          f"the card in {wall:.2f} s, loss {tr.history[-1]['loss']!r}; "
          f"launches {got} (expected {want}); by kernel and route {routes} "
          f"(expected {want_routes})", flush=True)
    if got != want:
        fail(f"{cfg.name} float32 step: launches {got}, expected {want}")
    if routes != want_routes:
        fail(f"{cfg.name} float32 step: launches by kernel and route "
             f"{routes}, expected {want_routes}")
    out = {}
    t0 = time.perf_counter()
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        st = copy_to(state, d)               # the optimizer writes in place
        b = to_device(batch, d)
        (loss, _), grads = tstep.value_and_grad(cfg, st["params"], b)
        before = copy_to(st["params"], "cpu")
        params, _, m = adamw_update(opt, st["params"], grads, st["opt"])
        out[label] = {"loss": float(loss), "grad_norm": float(m["grad_norm"]),
                      "grads": to_device(grads, "cpu"),
                      "update": {k: (a.float() - b_.float()) for (k, a), (_, b_)
                                 in zip(flat_leaves(to_device(params, "cpu")),
                                        flat_leaves(before))}}
        del st, params, grads
    cmp_s = time.perf_counter() - t0
    card, cpu = out["card"], out["cpu"]
    worst_leaf = max(((float((a - b_).abs().max())
                       / max(float(b_.abs().max()), 1e-30), k)
                      for (k, a), (_, b_) in zip(flat_leaves(card["grads"]),
                                                 flat_leaves(cpu["grads"]))))
    diffs = {"loss": abs(card["loss"] - cpu["loss"]),
             "grad_norm": abs(card["grad_norm"] - cpu["grad_norm"])
             / cpu["grad_norm"],
             "grad_leaf": worst_leaf[0],
             "update_l2": float(torch.sqrt(sum(
                 ((card["update"][k] - u) ** 2).sum()
                 for k, u in cpu["update"].items())) / torch.sqrt(sum(
                     (u ** 2).sum() for u in cpu["update"].values())))}
    print(f"[train] card vs cpu in float32, {cfg.name} at depth "
          f"{cfg.n_layers}: loss card {card['loss']!r} cpu {cpu['loss']!r}, "
          f"grad_norm card {card['grad_norm']!r} cpu {cpu['grad_norm']!r}; "
          f"differences { {k: float(f'{v:.4e}') for k, v in diffs.items()} } "
          f"(largest leaf difference at {worst_leaf[1]}; tol "
          f"{TRAIN_F32_TOL}; {cmp_s:.1f} s)", flush=True)
    if any(diffs[k] > TRAIN_F32_TOL[k] for k in diffs):
        fail(f"{cfg.name} in float32: the card's step and the cpu's differ "
             f"beyond the tolerance: {diffs}")
    import signal

    signal.signal(signal.SIGTERM, signal.SIG_DFL)    # Trainer's handler
    return {"launches": got, "forward_routes": routes["flash forward"],
            "split_launches": routes["fa_fwd_split"],
            "ssd_routes": routes["ssd_scan"],
            "ssd_split_launches": routes["ssd_split"],
            "ssd_bwd_routes": routes["ssd_bwd"], "card_vs_cpu": diffs,
            "tol": TRAIN_F32_TOL, "depth": cfg.n_layers, "wall_s": wall,
            "compare_s": cmp_s, "loss": tr.history[-1]["loss"]}


def copy_to(tree, dev):
    """A copy of a tree of tensors on ``dev`` (a new tensor even where a
    leaf is there already)."""
    if isinstance(tree, dict):
        return {k: copy_to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# [serve]'s two-buffer decode: granite-3-2b at full width and depth, two
# prompts of 1024 tokens prefilled, the prefill's caches copied into an
# init_caches(recent_len=) layout (tests/test_two_buffer_decode.py's
# _copy_into), then `steps` greedy tokens decoded on the single ring and
# on the two buffers.  The recent ring holds every decoded token (recent =
# steps): the reference's engine never folds it into the main cache.  The
# logits within the reference's own bound, the tokens equal
TWO_BUFFER = dict(arch="granite-3-2b", batch=2, prompt=1024, recent=32,
                  steps=32)
TWO_BUFFER_TOL = 5e-2
# the GPipe drive: granite-3-2b's 40 layers in 4 stages of 10 groups, 8
# microbatches of 1 x 1024 tokens in bf16, without gradients; 11 ticks of
# 4 stages of 10 layers: 440 flash launches, bubbles included
PIPELINE = dict(arch="granite-3-2b", stages=4, microbatches=8, seq=1024)
# the DiLoCo drive: mamba2-780m at full width and depth, [train]'s settings
# (float32 parameters, the fp32 AdamW, remat), 2 pods fed the Zipf stream
# from the seeds of tests/test_compression_diloco.py, 2 inner steps a
# round, 2 rounds at B=8, S=1024; the leaves whose last outer update is
# held to its formula in float64
DILOCO = dict(arch="mamba2-780m", seeds=(10, 11), inner_steps=2, rounds=2,
              batch=8, seq=1024)
DILOCO_CHECK_LEAVES = ("/final_ln", "/groups/l0/A_log", "/groups/l0/dt_bias",
                       "/groups/l0/wdt")


def copy_into(two_buf, caches):
    """tests/test_two_buffer_decode.py's _copy_into on the port's trees:
    each leaf of ``two_buf`` that ``caches`` has at the same path and
    shape takes its values (a copy)."""
    src = dict(flat_leaves(caches))
    for path, leaf in flat_leaves(two_buf):
        s = src.get(path)
        if s is not None and s.shape == leaf.shape:
            leaf.copy_(s)
    return two_buf


def two_buffer_decode(dev, kernels):
    """TWO_BUFFER's drive: the prefill's launches (the counts set to 0
    before it), the decode on one ring and on two buffers (no kernel
    launch in either), each step's logits and tokens compared, the main
    buffers bitwise unchanged, ms per decode step of each."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.serve import step

    t_drive = time.perf_counter()
    tb = TWO_BUFFER
    cfg = get_config(tb["arch"])
    B, S, T = tb["batch"], tb["prompt"], tb["steps"]
    params = step.init_working_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (B, S))).to(dev)
    decode = step.make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        reset_launches(*kernels.values())
        logits, one = step.make_prefill_step(cfg, cache_len=S + T)(
            params, step.model_inputs(cfg, toks))
        torch.cuda.synchronize()
        prefill = {k: w.launches for k, w in kernels.items() if w.launches}
        with torch.device(dev):
            two = copy_into(api.init_caches(cfg, B, S + T,
                                            recent_len=tb["recent"]), one)
        main = {p: t.clone() for p, t in flat_leaves(two)
                if p.endswith(("/k", "/v", "/pos"))}
        single = [p for p in main if p.endswith("/k")
                  and p[:-1] + "rk" not in dict(flat_leaves(two))]
        if single or not main:
            fail(f"{cfg.name}: init_caches(recent_len=) left single rings "
                 f"at {single or 'every layer'}")

        def run(caches, forced=None):
            """Each step's logits, greedy picks and seconds; the next
            token is the pick, or ``forced``'s."""
            tok = logits[:, -1].argmax(-1, keepdim=True)
            outs, picks, secs = [], [], []
            for t in range(T):
                t0 = time.perf_counter()
                lg, caches = decode(params, tok, caches, S + t)
                pick = lg[:, -1].argmax(-1, keepdim=True)
                tok = pick if forced is None else forced[:, t:t + 1]
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                outs.append(lg[:, -1].float())
                picks.append(pick)
            return torch.stack(outs), torch.cat(picks, 1), secs

        # the two buffers decode the single ring's tokens: a pick that
        # differs at a near tie would otherwise feed each path other
        # tokens from there on
        reset_launches(*kernels.values())
        ring_logits, ring_toks, ring_s = run(one)
        two_logits, two_toks, two_s = run(two, forced=ring_toks)
        decode_launches = {k: w.launches for k, w in kernels.items()
                           if w.launches}
    diff = float((ring_logits - two_logits).abs().max())
    per_step = [float((a - b).abs().max())
                for a, b in zip(ring_logits, two_logits)]
    unchanged = all(torch.equal(main[p], t) for p, t in flat_leaves(two)
                    if p in main)
    rpos = sorted({int(x) for p, t in flat_leaves(two)
                   if p.endswith("/rpos") for x in t.flatten().tolist()})
    peak = torch.cuda.max_memory_allocated()
    ring_ms = float(np.median(ring_s)) * 1e3
    two_ms = float(np.median(two_s)) * 1e3
    # a pick that differs is a near tie when the single ring's own logits
    # of the two picks lie within the logits' bound of each other
    ties, flips = [], []
    for b, t in torch.nonzero(ring_toks != two_toks).tolist():
        row = ring_logits[t, b]
        gap = float(row[ring_toks[b, t]] - row[two_toks[b, t]])
        (ties if gap <= TWO_BUFFER_TOL else flips).append((t, b, gap))
    tokens_equal = not ties and not flips
    drive_s = time.perf_counter() - t_drive
    print(f"[serve] two-buffer decode, {cfg.name} (full width and depth, "
          f"{cfg.n_layers} layers): B={B}, prompts of {S} tokens, recent "
          f"ring {tb['recent']}, {T} greedy tokens; prefill launches "
          f"{prefill}, decode launches {decode_launches or 'none'}; logits "
          f"against the single ring max abs diff {diff:.4e} (by step "
          f"{[float(f'{d:.3e}') for d in per_step]}; tol {TWO_BUFFER_TOL}; "
          f"the two buffers fed the single ring's tokens); greedy tokens "
          f"equal: {tokens_equal} (near ties, (step, request, the single "
          f"ring's gap): {ties or 'none'}); main buffers bitwise "
          f"unchanged: {unchanged}; recent rings hold positions "
          f"{rpos[0]}..{rpos[-1]} ({len(rpos)} distinct); ms per "
          f"decode step (median of {T}, host clock to a synchronize): "
          f"single ring {ring_ms:.3f}, two buffers {two_ms:.3f} "
          f"({two_ms / ring_ms:.3f}x); peak {peak / 1e9:.3f} GB; drive "
          f"{drive_s:.1f} s", flush=True)
    if prefill != {"flash_attention": cfg.n_layers} or decode_launches:
        fail(f"{cfg.name} two-buffer drive: prefill launches {prefill}, "
             f"decode launches {decode_launches}; expected "
             f"{cfg.n_layers} flash launches and none in decode")
    if diff > TWO_BUFFER_TOL or flips or not unchanged or \
            rpos != [-1] * (tb["recent"] > T) + list(range(S, S + T)) or \
            not bool(torch.isfinite(two_logits).all()):
        fail(f"{cfg.name}: two-buffer decode differs from the single ring "
             f"(logits {diff}, picks off a near tie {flips}), moved its main "
             f"buffers ({not unchanged}) or holds positions {rpos}")
    del params, one, two, main
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "batch": B, "prompt": S, "recent": tb["recent"],
            "steps": T, "max_abs_diff": diff, "tokens_equal": tokens_equal,
            "near_ties": ties,
            "main_unchanged": unchanged, "prefill_launches": prefill,
            "single_ring_ms_per_step": ring_ms,
            "two_buffer_ms_per_step": two_ms, "peak_bytes": peak,
            "drive_s": drive_s}


def pipeline_drive(dev, kernels):
    """PIPELINE's drive: the embedding before stage 0, pipeline_forward
    (the counts set to 0 before it), the final norm and logits after the
    last stage; against the same stage function applied stage after stage
    to each microbatch (bit-identical: the same kernels at the same
    shapes) and microbatch 0's logits against the model's own forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.pipeline import (PipelineConfig,
                                                  pipeline_forward,
                                                  pipeline_stats,
                                                  split_microbatches,
                                                  stack_stage_params)
    from repro_torch.distributed.sharding import map_tree
    from repro_torch.models import api
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import step

    t_drive = time.perf_counter()
    pc = PIPELINE
    cfg = get_config(pc["arch"])
    n_st, M, S = pc["stages"], pc["microbatches"], pc["seq"]
    per = cfg.n_groups // n_st
    kinds = cfg.layer_kinds()
    params = step.init_working_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    stacked = stack_stage_params(tuple(
        map_tree(lambda t, s=s: t[s * per:(s + 1) * per], params["groups"])
        for s in range(n_st)))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (M, S))).to(dev)
    positions = torch.arange(S, device=dev).expand(1, S)

    def stage_fn(sp, h):
        for gp in T.unbind(sp, per):
            for i, kind in enumerate(kinds):
                h = T.apply_block_full(cfg, kind, gp[f"l{i}"], None, h,
                                       positions)[0]
        return h

    pcfg = PipelineConfig(n_stages=n_st, n_microbatches=M)
    stats = pipeline_stats(pcfg)
    flash = kernels["flash_attention"]
    torch.cuda.reset_peak_memory_stats()
    def sequential():
        seq = []
        for m in range(M):
            h = mbs[m]
            for sp in T.unbind(stacked, n_st):
                h = stage_fn(sp, h)
            seq.append(h)
        return torch.stack(seq)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        mbs = split_microbatches(T._embed(cfg, params["embed"], toks), M)
        torch.cuda.synchronize()
        reset_launches(*kernels.values())
        out, first = timed(lambda: pipeline_forward(stage_fn, stacked, mbs,
                                                    pcfg))
        got = {k: w.launches for k, w in kernels.items() if w.launches}
        reset_launches(*kernels.values())
        seq, _ = timed(sequential)
        seq_launches = flash.launches
        # walls in turns, both warm: stages one after another, pipeline,
        # pipeline, one after another
        turns = [timed(fn)[1] for fn in (
            sequential, lambda: pipeline_forward(stage_fn, stacked, mbs, pcfg),
            lambda: pipeline_forward(stage_fn, stacked, mbs, pcfg),
            sequential)]
        wall, seq_wall = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        logits = [T._logits_from_hidden(cfg, L.rms_norm(
            out[m], params["final_ln"], cfg.norm_eps), params["embed"])
            for m in range(M)]
        own, _, _ = api.forward_logits(cfg, params, {"tokens": toks[:1]})
    equal = torch.equal(out, seq)
    diff = float((out.float() - seq.float()).abs().max())
    finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    own_equal = torch.equal(logits[0], own)
    peak = torch.cuda.max_memory_allocated()
    want = stats["ticks"] * n_st * per * len(kinds)
    drive_s = time.perf_counter() - t_drive
    print(f"[distributed] pipeline, {cfg.name} (full width and depth, "
          f"{cfg.n_layers} layers): {n_st} stages of {per} groups, {M} "
          f"microbatches of 1 x {S} tokens, bf16; {stats['ticks']} ticks, "
          f"bubble fraction {stats['bubble_fraction']:.6f}; launches {got} "
          f"(expected flash_attention {want}); the stages one after "
          f"another: {seq_launches} flash launches, bit-identical: {equal} "
          f"(max abs diff {diff:.3e}); wall {wall:.4f} s against "
          f"{seq_wall:.4f} s one after another ({wall / seq_wall:.3f}x; "
          f"in turns {[round(t, 4) for t in turns]}, the first, cold "
          f"pipeline {first:.4f} s); "
          f"logits after the last stage {tuple(logits[0].shape)} x {M}, "
          f"finite: {finite}; microbatch 0's logits equal to the model's "
          f"forward: {own_equal}; peak {peak / 1e9:.3f} GB; drive "
          f"{drive_s:.1f} s", flush=True)
    if got != {"flash_attention": want} or \
            seq_launches != M * n_st * per * len(kinds):
        fail(f"{cfg.name} pipeline: launches {got} and {seq_launches} "
             f"(stage after stage), expected {want} and "
             f"{M * n_st * per * len(kinds)} flash launches")
    if not (equal and finite and own_equal):
        fail(f"{cfg.name} pipeline: output differs from the stages applied "
             f"one after another (max {diff}) or from the model's forward, "
             "or its logits are not finite")
    del params, stacked, out, seq, logits
    torch.cuda.empty_cache()
    return {"arch": cfg.name, **stats, "stages": n_st, "groups_per_stage": per,
            "microbatches": M, "seq_len": S, "wall_s": wall,
            "sequential_wall_s": seq_wall, "walls_in_turns_s": turns,
            "first_wall_s": first, "launches": got,
            "sequential_launches": seq_launches, "bit_identical": equal,
            "forward_equal": own_equal, "peak_bytes": peak,
            "drive_s": drive_s}


def outer_formula(beta: float, lr: float, a, m, pp):
    """The outer update of one leaf in float64 on the CPU, each operation
    rounded to float32 as the reference's float32 arithmetic rounds it
    (its Python floats taken in float32, XLA's mean the sum times 1/n):
    (new anchor, new momentum) as float64 tensors."""
    r = lambda x: x.to(torch.float32).to(torch.float64)
    f32 = lambda v: float(np.float32(v))
    a, m, pp = (t.to("cpu", torch.float64) for t in (a, m, pp))
    total = pp[0]
    for p in pp[1:]:
        total = r(total + p)
    delta = r(a - r(total * f32(1.0 / pp.shape[0])))
    m_new = r(r(f32(beta) * m) + delta)
    step_ = r(r(f32(beta) * m_new) + delta)
    return r(a - r(f32(lr) * step_)), m_new


def diloco_drive(dev, kernels):
    """DILOCO's drive: the pods replicated from one seeded state, the
    rounds (the counts set to 0 before the first, read after the last),
    each round's wall and loss, the pods bit-identical to each other and to
    the anchor after every re-sync, the last outer update held to
    ``outer_formula`` on DILOCO_CHECK_LEAVES within one float32 ulp."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import pipeline_for_model
    from repro_torch.distributed import diloco
    from repro_torch.distributed.sharding import init_params
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.train.step import init_train_state, make_train_step

    t_drive = time.perf_counter()
    dc = DILOCO
    cfg = get_config(dc["arch"])
    n_pods, K, R = len(dc["seeds"]), dc["inner_steps"], dc["rounds"]
    opt = AdamWConfig(total_steps=K * R + 1, warmup=max(10, K * R // 20),
                      mode=cfg.optimizer_mode)
    dcfg = diloco.DiLoCoConfig(n_pods=n_pods, inner_steps=K)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(api.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0))
    pods = diloco.replicate_for_pods(init_train_state(cfg, opt, params),
                                     n_pods)
    outer = diloco.init_outer_state(params)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    pipes = [pipeline_for_model(cfg, dc["batch"], dc["seq"], seed=s,
                                device=dev) for s in dc["seeds"]]

    def batch_fn(r):
        steps = [[p.batch_at(r * K + i) for i in range(K)] for p in pipes]
        return {name: torch.stack([torch.stack([b[name] for b in pod])
                                   for pod in steps])
                for name in steps[0][0]}

    round_fn = diloco.make_diloco_round(dcfg, make_train_step(cfg, opt),
                                        batch_fn)
    # the last round's outer update: the checked leaves' inputs and outputs
    real, seen = diloco.outer_update, {}

    def spied(c, o, pod_params):
        before = {p: [dict(flat_leaves(t))[p].to("cpu", copy=True)
                      for t in (o["anchor"], o["momentum"], pod_params)]
                  for p in DILOCO_CHECK_LEAVES}
        out = real(c, o, pod_params)
        seen.update({p: (*before[p], dict(flat_leaves(o["anchor"]))[p].cpu(),
                         dict(flat_leaves(o["momentum"]))[p].cpu())
                     for p in DILOCO_CHECK_LEAVES})
        return out

    torch.cuda.reset_peak_memory_stats()
    reset_launches(*kernels.values())
    losses, walls, resynced = [], [], []
    diloco.outer_update = spied
    try:
        for r in range(R):
            t0 = time.perf_counter()
            pods, outer, metrics = round_fn(pods, outer, r)
            losses.append(float(metrics["loss"]))
            walls.append(time.perf_counter() - t0)
            resynced.append(all(
                torch.equal(leaf[p], anchor)
                for leaf, anchor in zip(tree_leaves(pods["params"]),
                                        tree_leaves(outer["anchor"]))
                for p in range(n_pods)))
    finally:
        diloco.outer_update = real
    got = {k: w.launches for k, w in kernels.items() if w.launches}
    routes = dict(kernels["ssd_bwd"].routes)
    peak = torch.cuda.max_memory_allocated()
    ulps = {}
    for p, (a, m, pp, a_new, m_new) in seen.items():
        want_a, want_m = outer_formula(dcfg.outer_beta, dcfg.outer_lr, a, m,
                                       pp)
        ulps[p] = max(
            float(((got_t.double() - want) / torch.from_numpy(np.spacing(
                want.abs().to(torch.float32).numpy())).double()).abs().max())
            for got_t, want in ((a_new, want_a), (m_new, want_m)))
    n_ssd = cfg.all_layer_kinds().count("mamba")
    want_launches = {"ssd_scan": 2 * n_ssd * n_pods * K * R,
                     "ssd_bwd": n_ssd * n_pods * K * R}
    drive_s = time.perf_counter() - t_drive
    print(f"[distributed] DiLoCo, {cfg.name} (full width and depth, "
          f"{cfg.n_layers} layers, remat on, {cfg.optimizer_mode} AdamW): "
          f"{n_pods} pods (streams {dc['seeds']}), {K} inner steps of "
          f"B={dc['batch']} S={dc['seq']} a round, {R} rounds; state drawn "
          f"and replicated in {init_s:.2f} s (peak {init_peak / 1e9:.3f} "
          f"GB); round losses {losses}, walls {[round(w, 4) for w in walls]} "
          f"s; pods bit-identical to the anchor after each re-sync: "
          f"{resynced}; launches {got} (expected {want_launches}), SSD "
          f"backward by route {routes}; the last outer update against its "
          f"formula in float64 (each operation rounded to float32) on "
          f"{list(DILOCO_CHECK_LEAVES)}: largest difference in float32 ulps "
          f"{ulps}; peak during the rounds {peak} B ({peak / 1e9:.3f} GB); "
          f"drive {drive_s:.1f} s", flush=True)
    if got != want_launches or routes != {"simt": 0,
                                          "wgmma": want_launches["ssd_bwd"]}:
        fail(f"{cfg.name} DiLoCo: launches {got}, SSD backward routes "
             f"{routes}; expected {want_launches}, all on the wgmma route")
    if not all(resynced) or not all(np.isfinite(losses)) or \
            len(seen) != len(DILOCO_CHECK_LEAVES) or \
            max(ulps.values()) > 1.0:
        fail(f"{cfg.name} DiLoCo: re-sync {resynced}, losses {losses}, "
             f"outer update off its formula by {ulps} float32 ulps")
    del pods, outer
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "pods": n_pods, "inner_steps": K, "rounds": R,
            "global_batch": dc["batch"], "seq_len": dc["seq"],
            "losses": losses, "round_walls_s": walls, "resynced": resynced,
            "launches": got, "ssd_bwd_routes": routes,
            "outer_update_ulps": ulps, "peak_bytes": peak,
            "init_peak_bytes": init_peak, "drive_s": drive_s}


# ssd_scan checks: (name, B, S, H, P, N, chunk, dtypes of x, dt and B/C).
# x, B and C in bfloat16 take the wgmma route, the rest the parts route
F32_3, BF16_3 = (torch.float32,) * 3, (torch.bfloat16,) * 3
SERVING = (torch.bfloat16, torch.float32, torch.bfloat16)
SSD_CHECKS = [(f"reference case {i} {str(t[0])[6:]}", *case, t)
              for t in (F32_3, BF16_3)
              for i, case in enumerate([(2, 64, 3, 16, 16, 16),
                                        (1, 128, 4, 32, 64, 32),
                                        (1, 96, 2, 64, 128, 32),
                                        (2, 64, 5, 16, 32, 64)])] + [
    ("mamba2 serving round 0", 4, 896, 48, 64, 128, 128, SERVING),
    ("mamba2 serving round 1", 4, 512, 48, 64, 128, 128, SERVING),
    ("zamba2 serving round 0", 4, 896, 112, 64, 64, 128, SERVING),
    ("S < chunk (clamped to 96)", 2, 96, 48, 64, 128, 128, SERVING),
    ("mamba2 shape, float32", 2, 512, 48, 64, 128, 128, F32_3),
    # the wgmma route's edges: a chunk under wgmma's 64 rows (the smoke
    # configs' 16, and S = 40 under the chunk of 128), P = 128, N = 16 and
    # 64, a long sequence (64 chunks, the state's rounded copies feeding
    # every one), dt in bfloat16
    ("chunk 16", 2, 256, 8, 64, 128, 16, SERVING),
    ("S = 40 < chunk (clamped to 40)", 3, 40, 4, 64, 128, 128, SERVING),
    ("P = 128", 2, 512, 16, 128, 128, 128, SERVING),
    ("P = 128, N = 64", 2, 512, 16, 128, 64, 128, SERVING),
    ("N = 16", 2, 256, 8, 64, 16, 128, SERVING),
    ("N = 64", 2, 512, 8, 64, 64, 128, SERVING),
    ("S = 8192 (64 chunks)", 1, 8192, 8, 64, 128, 128, SERVING),
    ("dt bfloat16", 2, 512, 8, 64, 128, 128, BF16_3),
]


def ssd_inputs(dev, B, S, H, P, N, types, seed):
    """x, dt, A, B_, C_ as the reference's SSD test makes them: normal x,
    B, C; dt = softplus(normal); A = -exp(0.3 normal) in float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    tx, tdt, tbc = types
    return (rnd(B, S, H, P).to(tx),
            torch.nn.functional.softplus(rnd(B, S, H)).to(tdt),
            -torch.exp(rnd(H) * 0.3), rnd(B, S, N).to(tbc),
            rnd(B, S, N).to(tbc))


def check_ssd(dev, ssd_ops, ssd_ref) -> dict:
    """Kernels against plain at SSD_CHECKS, on strided views and on an
    unaligned view; each case must take the route its dtypes and layout
    name (wgmma for bfloat16 x/B/C that TMA can read, else parts) and give
    the same bits in a second call.  The largest abs error over y and the
    final state, in all and by route, and by route the largest share of
    the tolerance (tol + tol |want|), which on a float32 row of the parts
    route must not pass SSD_F32_AIM."""
    out = {"max_abs_err": 0.0, "by_route": {}}
    cases = [(name, (B, S, H, P, N, types), chunk, None)
             for name, B, S, H, P, N, chunk, types in SSD_CHECKS]
    cases.append(("strided x, B and C views", (4, 512, 96, 64, 128, SERVING),
                  128, "strided"))
    cases.append(("x one element past an aligned base", (2, 256, 8, 64, 128,
                                                         SERVING), 128,
                  "unaligned"))
    for i, (name, (B, S, H, P, N, types), chunk, how) in enumerate(cases):
        x, dt, A, Bm, Cm = ssd_inputs(dev, B, S, H, P, N, types, 100 + i)
        if how == "strided":           # every other head; B, C of one tensor
            bc = torch.cat([Bm, Cm], dim=-1)
            x, dt, A = x[:, :, ::2], dt[:, :, ::2], A[::2]
            Bm, Cm = bc[..., :N], bc[..., N:]
            H //= 2
        if how == "unaligned":         # TMA cannot read it: the parts route
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            x = buf[1:].view(x.shape).copy_(x)
        want_route = ("wgmma" if types[0] == types[2] == torch.bfloat16
                      and how != "unaligned" else "parts")
        before = dict(ssd_ops.ssd.routes)
        y, st = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        took = [r for r, n in ssd_ops.ssd.routes.items() if n != before[r]]
        y2, st2 = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
        same = torch.equal(y, y2) and torch.equal(st, st2)
        want_y, want_st = ssd_ref.ssd(x, dt, A, Bm, Cm, chunk=chunk)
        tol = SSD_TOL[types[0]]
        err = max(float((y.float() - want_y.float()).abs().max()),
                  float((st - want_st).abs().max()))
        # the largest error as a share of its tolerance, tol + tol |want|
        shares = [float(((got.float() - want.float()).abs()
                         / (tol + tol * want.float().abs())).max())
                  for got, want in ((y, want_y), (st, want_st))]
        ok = y.dtype == x.dtype and st.dtype == torch.float32 and \
            bool(torch.isfinite(y).all()) and \
            torch.allclose(y.float(), want_y.float(), atol=tol, rtol=tol) \
            and torch.allclose(st, want_st, atol=tol, rtol=tol)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        r = out["by_route"].setdefault(want_route, {
            "max_abs_err": 0.0, "max_share": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        kind = str(types[0])[6:]
        r["max_share"][kind] = max(r["max_share"].get(kind, 0.0), *shares)
        print(f"[check] ssd_scan {name}: B={B} S={S} H={H} P={P} N={N} "
              f"chunk={chunk} x/dt/B {'/'.join(str(t)[6:] for t in types)}"
              f", route {took}: max_abs_err={err:.3e} (tol {tol:g} abs + "
              f"rel; y {shares[0]:.3f}, state {shares[1]:.3f} of it; a "
              f"second call bit-identical {same}) ok={ok}", flush=True)
        if took != [want_route]:
            fail(f"ssd_scan took route {took} for {name}, not "
                 f"{want_route}")
        if not ok:
            fail(f"ssd_scan differs from its plain version ({name})")
        if not same:
            fail(f"ssd_scan's two calls differ ({name})")
        if want_route == "parts" and types[0] == torch.float32 and \
                not max(shares) <= SSD_F32_AIM:
            fail(f"ssd_scan's parts route at {max(shares):.3f} of the "
                 f"float32 tolerance, past {SSD_F32_AIM} ({name})")
    return out


def ssd_bound(args, Q):
    """(bound ms, bound_by, bytes, flops) of the SSD scan on ``args``:
    bytes, every input read once and y and the final state written once;
    operations, per (b, h, chunk), (C B^T o L) xdt over the Q(Q+1)/2
    pairs s <= l, C state^T and the state update, 2 flops per
    multiply-add, and C B^T over the same pairs once per (b, chunk), since
    the heads share it; at the bf16 tensor cores' rate."""
    x, Bm = args[0], args[3]
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + x.numel() * x.element_size() + 4 * B * H * P * N
    nc = S // Q
    flops = B * H * nc * (Q * (Q + 1) * P + 4 * Q * P * N) \
        + B * nc * Q * (Q + 1) * N
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops > t_bytes else "bytes", nbytes, flops)


def time_ssd(dev, ssd_ops, ssd_ref):
    """The SSD kernel at mamba2-780m's prefill shape (B=4, S=1024; x, B, C
    bf16, dt f32): the wgmma route (CUDA events around the call; its
    device time alone, from the profiler and queued back to back; the
    host's time a call), the plain version, and the bound; and the wgmma
    route at zamba2-7b's prefill shape (B=4, S=896, H=112, N=64) with its
    bound (float32: time_ssd_f32)."""
    Q = 128
    out = {}
    for cell, (B, S, H, P, N) in (("mamba2", (4, 1024, 48, 64, 128)),
                                  ("zamba2", (4, 896, 112, 64, 64))):
        args = ssd_inputs(dev, B, S, H, P, N, SERVING, 7)
        if ssd_ops.route(args[0], args[3], args[4]) != "wgmma":
            fail(f"the SSD timing inputs at {cell}'s shape do not take the "
                 "wgmma route")
        call = lambda: ssd_ops.ssd(*args, chunk=Q)
        ms = cuda_ms(call, 20)
        dev_ms, launch = device_ms(call, "ssd_wgmma_kernel", per_call=1)
        queued, host = queued_ms(call), enqueue_ms(call)
        bound, bound_by, nbytes, flops = ssd_bound(args, Q)
        row = {"ms": ms, "device_ms": dev_ms, "queued_ms": queued,
               "host_ms": host, "bound_ms": bound, "bound_by": bound_by,
               "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={Q}, x/B/C "
                        "bf16, dt f32"}
        if cell == "mamba2":
            row["plain_ms"] = cuda_ms(lambda: ssd_ref.ssd(*args, chunk=Q), 3)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        extra = "" if cell != "mamba2" else f"; plain {row['plain_ms']:.4f} ms"
        print(f"[time] ssd_scan {cell} prefill {row['shape']}: wgmma route "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s; on the device "
              f"alone {dev_txt}, queued {queued:.4f} ms; the host "
              f"{host:.4f} ms a call; launch {launch}), bound {bound:.5f} ms "
              f"({nbytes} bytes, {flops} flops; {bound_by}){extra}",
              flush=True)
        out[cell] = row
    m = out["mamba2"]
    return {"ms": m["ms"], "device_ms": m["device_ms"],
            "queued_ms": m["queued_ms"], "host_ms": m["host_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the chunked "
                            "SSD scan",
            "shape": m["shape"],
            "at_zamba2_prefill": {k: out["zamba2"][k] for k in
                                  ("shape", "ms", "device_ms", "queued_ms",
                                   "host_ms", "bound_ms", "bound_by")}}


# the SSD scan's float32 forward timed (time_ssd_f32): mamba2-780m's
# prefill shape (B, S, H, P, N), chunk 128, every input float32
SSD_F32_TIME = (4, 1024, 48, 64, 128)
# the bf16 terms a product of the parts route sums (csrc/ssd_scan_parts.cu
# TERMS: the six down to 2^-16, the fewest that meet the float32
# tolerance, tests/test_torch_ssd_f32.py), counted by its bound
SSD_F32_TERMS = 6
# the parts route's kernels after the split, in launch order
SSD_PARTS_KERNELS = ("ssd_parts_g_kernel", "ssd_parts_state_kernel",
                     "ssd_parts_scan_kernel", "ssd_parts_y_kernel")


def ssd_f32_bounds(B, S, H, P, N, Q) -> dict:
    """Bounds of the float32 SSD forward, ms, with what bounds each: the
    function's (ssd_bound's products at the CUDA cores' float32 rate, or
    its float32 inputs and outputs at the memory's), the split's (bytes:
    4 read and 6 written an element of x, B and C, P and N rounded up to
    64 a part), the parts kernels' (the SSD_F32_TERMS bf16 terms of every
    product at the tensor cores' rate, or the parts, dt, y and the state)
    and the route's (their sum); the function's flops and the terms'."""
    nc = S // Q
    pad = lambda d: -(-d // 64) * 64
    flops = B * H * nc * (Q * (Q + 1) * P + 4 * Q * P * N) \
        + B * nc * Q * (Q + 1) * N
    io = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N
              + B * H * P * N)
    by = lambda o, b: "operations" if o > b else "bytes"
    f_ops, f_bytes = flops / H100_FP32_OPS_PER_S, io / H100_BYTES_PER_S
    parts_elems = B * S * (H * pad(P) + 2 * pad(N))
    split_bytes = 4 * B * S * (H * P + 2 * N) + 6 * parts_elems
    split = 1e3 * split_bytes / H100_BYTES_PER_S
    t_ops = SSD_F32_TERMS * flops / H100_BF16_OPS_PER_S
    t_bytes = (6 * parts_elems + 4 * (B * S * H + B * S * H * P
                                      + B * H * P * N)) / H100_BYTES_PER_S
    parts = 1e3 * max(t_ops, t_bytes)
    return {"function": (1e3 * max(f_ops, f_bytes), by(f_ops, f_bytes)),
            "split": (split, "bytes", split_bytes),
            "parts": (parts, by(t_ops, t_bytes)),
            "route": (split + parts, "operations and bytes"),
            "flops": flops, "term_flops": SSD_F32_TERMS * flops}


def time_ssd_f32(dev, ssd_ops, ssd_ref, B, S, H, P, N, Q=128):
    """The float32 SSD forward at (B, S, H, P, N): the parts route's call
    (ssd_split, then the four parts kernels) and ssd_f32_kernel's
    (``launch(..., "f32")``) on the same float32 inputs in turns (parts,
    f32, f32, parts), the split and the parts kernels alone (CUDA events,
    and queued back to back) and each kernel on the device (profiler),
    the plain version and the split's, the bounds, and each route's
    largest error against plain with its share of 1e-4 + 1e-4 |want|.
    Fails where the parts route's share passes SSD_F32_AIM,
    ssd_f32_kernel's passes 1, or the split's parts differ from its plain
    version's."""
    args = ssd_inputs(dev, B, S, H, P, N, F32_3, 7)
    x, dt, A, Bm, Cm = args
    if ssd_ops.route(x, Bm, Cm) != "parts":
        fail("the float32 SSD timing inputs do not take the parts route")
    new = lambda: ssd_ops.ssd(*args, chunk=Q)
    old = lambda: ssd_ops.launch(*args, Q, "f32")
    turns = [cuda_ms(f, 10) for f in (new, old, old, new)]
    parts = ssd_ops.ssd_split(x, Bm, Cm)
    split = lambda: ssd_ops.ssd_split(x, Bm, Cm)
    kernels = lambda: ssd_ops.ssd_parts(*args, parts, Q)
    split_ms, parts_ms = cuda_ms(split, 20), cuda_ms(kernels, 20)
    split_queued, parts_queued = queued_ms(split), queued_ms(kernels)
    dev_ms = {k: device_ms(new, k, 10, per_call=1)[0]
              for k in ("ssd_parts_split_kernel", *SSD_PARTS_KERNELS)}
    old_dev, _ = device_ms(old, "ssd_f32_kernel", 5, per_call=1)
    plain_ms = cuda_ms(lambda: ssd_ref.ssd(*args, chunk=Q), 3)
    split_plain_ms = cuda_ms(lambda: ssd_ref.split(x, Bm, Cm), 3)
    want = ssd_ref.ssd(*args, chunk=Q)
    tol = SSD_TOL[torch.float32]
    errs = {}
    for name, fn in (("parts", new), ("f32", old)):
        got = fn()
        errs[name] = (max(float((g - w).abs().max())
                          for g, w in zip(got, want)),
                      max(float(((g - w).abs() / (tol + tol * w.abs())).max())
                          for g, w in zip(got, want)))
    split_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(parts, ssd_ref.split(x, Bm, Cm)))
    if not errs["parts"][1] <= SSD_F32_AIM or not errs["f32"][1] <= 1.0 or \
            split_err != 0:
        fail(f"the float32 SSD forward at mamba2's prefill shape: the parts "
             f"route at {errs['parts'][1]:.3f} of its tolerance (at most "
             f"{SSD_F32_AIM}), ssd_f32_kernel at {errs['f32'][1]:.3f} (at "
             f"most 1), the split {split_err:.1e} off its plain version")
    b = ssd_f32_bounds(B, S, H, P, N, Q)
    ms, f32_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    shape = f"B={B} S={S} H={H} P={P} N={N} chunk={Q}, every input float32"
    print(f"[time] ssd_scan float32 at {shape}: the parts route {ms:.4f} ms "
          f"a call ({b['flops'] / ms / 1e9:.2f} TFLOP/s of the function; "
          f"split {split_ms:.4f} ms alone, {split_queued:.4f} queued; the "
          f"four parts kernels {parts_ms:.4f} ms alone, {parts_queued:.4f} "
          f"queued, {b['term_flops'] / parts_ms / 1e9:.2f} TFLOP/s of their "
          f"{SSD_F32_TERMS} bf16 terms a product, "
          f"{parts_ms / b['parts'][0]:.2f}x their bound; device ms by "
          f"kernel { {k: fmt(v) for k, v in dev_ms.items()} }); "
          f"ssd_f32_kernel {f32_ms:.4f} ms a call (device {fmt(old_dev)}); "
          f"in turns {', '.join(f'{t:.4f}' for t in turns)} ms (parts, f32, "
          f"f32, parts): {f32_ms / ms:.2f}x; plain {plain_ms:.4f} ms, the "
          f"split's plain {split_plain_ms:.4f} ms; bounds: the function "
          f"{b['function'][0]:.5f} ms ({b['function'][1]}, float32 rate), "
          f"the split {b['split'][0]:.5f} ms ({b['split'][2]} bytes), the "
          f"parts kernels {b['parts'][0]:.5f} ms ({b['parts'][1]}), the "
          f"route {b['route'][0]:.5f} ms ({b['route'][0] / ms:.3f} of its "
          f"time); max abs err against plain: parts {errs['parts'][0]:.3e} "
          f"({errs['parts'][1]:.3f} of tolerance {tol:g} abs + rel), f32 "
          f"{errs['f32'][0]:.3e} ({errs['f32'][1]:.3f}), split "
          f"{split_err:.1e}", flush=True)
    return {"ms": ms, "f32_ms": f32_ms, "turns_ms": turns,
            "split_ms": split_ms, "split_queued_ms": split_queued,
            "parts_ms": parts_ms, "parts_queued_ms": parts_queued,
            "device_ms_by_kernel": dev_ms, "f32_device_ms": old_dev,
            "plain_ms": plain_ms, "split_plain_ms": split_plain_ms,
            "bounds": b, "max_abs_err": errs["parts"][0],
            "max_share_of_tolerance": errs["parts"][1],
            "f32_max_abs_err": errs["f32"][0],
            "f32_max_share_of_tolerance": errs["f32"][1],
            "split_max_abs_err": split_err, "shape": shape}


# the SSD backward's checks: (name, B, S, H, P, N, chunk, dtypes of x/dy,
# dt and B/C, a nonzero dstate, layout).  The training shapes come as
# training gives them: bf16 x, B, C and dy, float32 dt and A, and a zero
# dstate (the final state feeds no loss)
SSD_BWD_CHECKS = [
    ("mamba2-780m training", 8, 1024, 48, 64, 128, 128, SERVING, False,
     None),
    ("zamba2-7b training", 2, 1024, 112, 64, 64, 128, SERVING, False, None),
    ("float32", 2, 512, 8, 64, 128, 128, F32_3, True, None),
    ("S < chunk (clamped to 96)", 2, 96, 8, 64, 128, 128, SERVING, True,
     None),
    ("8 chunks of 64, dstate", 2, 512, 4, 32, 48, 64, F32_3, True, None),
    ("P = N = 128 (the scan kernels' largest tiles)", 1, 256, 4, 128, 128,
     128, F32_3, True, None),
    ("strided x (every other head), B and C views of one tensor", 2, 512,
     8, 64, 128, 128, SERVING, True, "strided"),
    # the wgmma route's largest tiles, and chunks under its tile of 128
    # rows (one warpgroup of two idle) with a nonzero dstate
    ("P = N = 128, bf16 (the wgmma route's largest tiles)", 1, 256, 4, 128,
     128, 128, SERVING, True, None),
    ("4 chunks of 64, dstate, bf16", 2, 256, 4, 64, 128, 64, SERVING, True,
     None),
    ("3 chunks of 32, dstate, bf16", 1, 96, 2, 64, 128, 32, SERVING, True,
     None),
]
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")
# the SSD backward's kernels, the wgmma route's five (ops.BWD_WGMMA_KERNELS,
# csrc/ssd_scan_bwd_wgmma.cu) and the SIMT route's six (csrc/ssd_scan_bwd.cu)
SSD_BWD_KERNELS = ("ssd_bwd_wgmma_state_kernel<true>",
                   "ssd_bwd_wgmma_state_kernel<false>",
                   "ssd_bwd_wgmma_chunk_kernel", "ssd_bwd_wgmma_dbdc_kernel",
                   "ssd_bwd_wgmma_reduce_kernel",
                   "ssd_bwd_scan_kernel<false>", "ssd_bwd_scan_kernel<true>",
                   "ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel",
                   "ssd_bwd_dt_kernel", "ssd_bwd_reduce_kernel")
SSD_BWD_ROUTE_KERNELS = {"wgmma": SSD_BWD_KERNELS[:5],
                         "simt": SSD_BWD_KERNELS[5:]}
# the wgmma route's instances that must show wgmma (HGMMA) and TMA tile
# loads (UTMALDG) in the library's SASS: the state walks, the chunk pass
# and the dB/dC pass at P and N padded to 64 or 128 (the reduce kernel
# only sums)
SSD_BWD_INSTANCES = tuple(
    f"ssd_bwd_wgmma_{k}<{pp}, {nn}{', ' + r if r else ''}>"
    for pp in (64, 128) for nn in (64, 128)
    for k, r in (("state_kernel", "true"), ("state_kernel", "false"),
                 ("chunk_kernel", ""), ("dbdc_kernel", "")))
# PR 28's SIMT route, a call at the training shapes on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md)
SSD_BWD_PR28_MS = {"mamba2": 9.6438, "zamba2": 3.5869}
# kernels against plain on identical inputs, each output against its own
# largest magnitude: both compute in float32 from the same inputs and
# differ only in the order of their sums (a product over up to 128 terms,
# a cumulative sum over a chunk, a sum over heads or over (b, s)), so
# SSD_BWD_ATOL x max|plain|, as the port's float32 backward is held to the
# reference's.  An output in bfloat16 (dx, dB, dC at the training shapes)
# is the same float32 value rounded by both, so where it sits on a rounding
# edge the two differ by one bfloat16 step, up to 2^-7 of the value (at
# the bottom of a binade: 1.0 on a dB of 128-256 at mamba2's training
# shape): SSD_BWD_BF16_RTOL x |plain| besides
SSD_BWD_ATOL = 1e-4
SSD_BWD_BF16_RTOL = 2.0 ** -7


def ssd_bwd_inputs(dev, B, S, H, P, N, types, nonzero, seed):
    """x, dt, A, B_, C_ as ssd_inputs makes them, then dy (normal, in x's
    dtype) and dstate (normal, or zeros), float32."""
    x, dt, A, Bm, Cm = ssd_inputs(dev, B, S, H, P, N, types, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn((B, S, H, P), generator=g, device=dev).to(types[0])
    ds = torch.randn((B, H, P, N), generator=g, device=dev) if nonzero \
        else torch.zeros((B, H, P, N), device=dev)
    return x, dt, A, Bm, Cm, dy, ds


def ssd_bwd_instance(mangled: str):
    """'ssd_bwd_wgmma_state_kernel<64, 128, true>' (or a chunk, dbdc or
    reduce kernel of the SSD backward's wgmma route) for a line naming it
    by its mangled name, else None."""
    m = re.search(r"(ssd_bwd_wgmma_\w+?_kernel)(I((?:L[ib]\d+E)+)E)?",
                  mangled)
    if m is None:
        return None
    if not m.group(3):
        return m.group(1)
    args = [("true" if v == "1" else "false") if k == "b" else v
            for k, v in re.findall(r"L([ib])(\d+)E", m.group(3))]
    return f"{m.group(1)}<{', '.join(args)}>"


def ssd_bwd_close(got, want):
    """{output: (max abs err, the largest error as a share of its
    tolerance, within it and of the input's dtype)}."""
    out = {}
    for name, g_, w in zip(SSD_BWD_NAMES, got, want):
        w32 = w.float()
        tol = SSD_BWD_ATOL * float(w32.abs().max()) + (
            SSD_BWD_BF16_RTOL * w32.abs() if w.dtype == torch.bfloat16
            else 0.0)
        d = (g_.float() - w32).abs()
        share = float((d / (tol + 1e-30)).max()) if d.numel() else 0.0
        out[name] = (float(d.max()) if d.numel() else 0.0, share,
                     share <= 1.0 and g_.dtype == w.dtype
                     and bool(torch.isfinite(g_).all()))
    return out


def check_ssd_bwd(dev, ssd_ops, ssd_ref):
    """The backward kernels against ref.ssd_bwd at SSD_BWD_CHECKS, on
    identical inputs, and a second call bit-identical to the first: a bf16
    row on both routes (ssd_bwd, which must take the wgmma route, then the
    SIMT route's kernels through ops.bwd_launch), a float32 row on the
    SIMT route.  Returns the largest absolute error of each output, by
    route."""
    worst = {r: dict.fromkeys(SSD_BWD_NAMES, 0.0) for r in ("wgmma", "simt")}
    for i, (label, B, S, H, P, N, chunk, types, nonzero, how) in \
            enumerate(SSD_BWD_CHECKS):
        args = ssd_bwd_inputs(dev, B, S, H * (2 if how else 1), P, N,
                              types, nonzero, 300 + i)
        x, dt, A, Bm, Cm, dy, ds = args
        if how == "strided":
            bc = torch.cat([Bm, Cm], dim=-1)
            x, dt, A = x[:, :, ::2], dt[:, :, ::2], A[::2]
            dy, ds = dy[:, :, ::2].contiguous(), ds[:, ::2].contiguous()
            Bm, Cm = bc[..., :N], bc[..., N:]
        args = (x, dt, A, Bm, Cm, dy, ds)
        want = ssd_ref.ssd_bwd(*args, chunk=chunk)
        bf16 = types[0] == torch.bfloat16
        for route in ("wgmma", "simt") if bf16 else ("simt",):
            n0, r0 = ssd_ops.ssd_bwd.launches, dict(ssd_ops.ssd_bwd.routes)
            if route == "simt" and bf16:   # the SIMT kernels on bf16 inputs
                call = lambda: ssd_ops.bwd_launch(*args, min(chunk, S), "simt")
            else:
                call = lambda: ssd_ops.ssd_bwd(*args, chunk=chunk)
            got = call()
            again = call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            res = ssd_bwd_close(got, want)
            for name, (e, _, _) in res.items():
                worst[route][name] = max(worst[route][name], e)
            counted = {r: n - r0[r] for r, n in ssd_ops.ssd_bwd.routes.items()}
            print(f"[train] ssd backward against its plain version, {label} "
                  f"(B={B} S={S} H={H} P={P} N={N} chunk={chunk}, x/dt/B "
                  f"{'/'.join(str(t)[6:] for t in types)}, dstate "
                  f"{'normal' if nonzero else 'zero'}), {route} route: "
                  + "; ".join(f"{n} {e:.3e} ({s:.3f} of its tolerance)"
                              for n, (e, s, _) in res.items())
                  + f" (atol {SSD_BWD_ATOL} x max|plain|, bf16 outputs + "
                  f"{SSD_BWD_BF16_RTOL} |plain|); two calls bit-identical: "
                  f"{same}; counted {ssd_ops.ssd_bwd.launches - n0} calls, "
                  f"by route {counted}", flush=True)
            bad = [n for n, (_, _, ok) in res.items() if not ok]
            if bad:
                fail(f"ssd backward {label} ({route}): {bad} beyond the "
                     "tolerance")
            if not same:
                fail(f"ssd backward {label} ({route}): two calls differ")
            want_counted = {r: 2 * (r == route) for r in counted} \
                if route == "wgmma" or not bf16 else dict.fromkeys(counted, 0)
            if counted != want_counted:
                fail(f"ssd backward {label}: the wrapper counted {counted} "
                     f"for 2 calls on the {route} route, expected "
                     f"{want_counted}")
            del got
        del args, want, x, dt, A, Bm, Cm, dy, ds
        torch.cuda.empty_cache()
    return worst


def ssd_bwd_bound(args, Q):
    """(bound ms, bound_by, bytes, flops) of the SSD backward on ``args``
    (x, dt, A, B_, C_, dy, dstate): bytes, every input read once and dx,
    ddt, dA, dB, dC written once in the inputs' dtypes; operations, per (b,
    chunk, head) the two triangle products of width P (dy xdt^T, (G o L)^T
    dy) and two of width N (dG B, dG^T C) over the Q(Q+1)/2 pairs s <= l
    and five P x N x Q products (the states' replay, dy S0, B dS^T, xdt dS,
    the cotangent's update), and G = C B^T once per (b, chunk), 2 flops per
    multiply-add; at the bf16 tensor cores' rate for bf16 x, else the
    float32 rate."""
    x, dt, A, Bm, Cm, dy, ds = args
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nbytes = sum(a.numel() * a.element_size() for a in args) + \
        sum(a.numel() * a.element_size() for a in (x, dt, A, Bm, Cm))
    nc, tri = S // Q, Q * (Q + 1) // 2
    flops = 2 * (B * nc * H * (2 * tri * P + 2 * tri * N + 5 * Q * P * N)
                 + B * nc * tri * N)
    peak = H100_BF16_OPS_PER_S if x.dtype == torch.bfloat16 else \
        H100_FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops > t_bytes else "bytes", nbytes, flops)


def kernel_ms(by_kernel, names, calls):
    """{kernel: device ms a call} from a profile's ms by kernel name, for
    the kernels ``names`` name (a template argument in <> must match too),
    over ``calls`` calls."""
    def match(n, ev):
        base, _, arg = n.partition("<")
        return base in ev and (not arg or f"<{arg}" in ev
                               or f", {arg}" in ev)
    return {n: sum(t for ev, t in by_kernel.items() if match(n, ev)) / calls
            for n in names}


def route_kernel_ms(fn, names, reps: int = 3) -> dict:
    """{kernel: device ms a call} of ``reps`` calls of ``fn`` under the
    profiler (profile_train_step's), for the kernels ``names`` name
    (kernel_ms's matching); None for a kernel the profiler recorded no
    launch of (it sometimes records no device event at all)."""
    by_kernel = profile_train_step(lambda: [fn() for _ in range(reps)])[3]
    return {n: ms or None for n, ms in
            kernel_ms(by_kernel, names, reps).items()}


def time_ssd_bwd(dev, ssd_ops, ssd_ref):
    """The backward at mamba2-780m's and zamba2-7b's training shapes on
    both routes, in turns (wgmma, simt, wgmma, simt: CUDA events around
    the call, after a warm-up), each route's kernels' device ms a call
    (the profiler) and the wgmma route's scratch, beside the bound, PR
    28's figures and, at mamba2's shape, the plain version's time."""
    out = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for cell, i in (("mamba2", 0), ("zamba2", 1)):
        _, B, S, H, P, N, Q, types, nonzero, _ = SSD_BWD_CHECKS[i]
        args = ssd_bwd_inputs(dev, B, S, H, P, N, types, nonzero, 7)
        if ssd_ops.bwd_route(args[0], args[3], args[4], args[5]) != "wgmma":
            fail(f"the SSD backward's timing inputs at {cell}'s shape do not "
                 "take the wgmma route")
        calls = {"wgmma": lambda: ssd_ops.ssd_bwd(*args, chunk=Q),
                 "simt": lambda: ssd_ops.bwd_launch(*args, Q, "simt")}
        turns = {r: [] for r in calls}
        for r in ("wgmma", "simt", "wgmma", "simt"):
            turns[r].append(cuda_ms(calls[r], 10 if r == "wgmma" else 3))
        bound, bound_by, nbytes, flops = ssd_bwd_bound(args, Q)
        by_kernel = {r: route_kernel_ms(calls[r], SSD_BWD_ROUTE_KERNELS[r])
                     for r in calls}
        G2, G3 = ssd_ops.bwd_groups(B, S // Q, H, sms)
        scratch = sum(math.prod(shape) * torch.empty((), dtype=d).element_size()
                      for shape, d in ssd_ops.bwd_scratch_shapes(
                          B, S, H, P, N, Q, G2, G3).values())
        row = {"ms": min(turns["wgmma"]), "ms_turns": turns["wgmma"],
               "simt_ms": min(turns["simt"]), "simt_ms_turns": turns["simt"],
               "pr28_simt_ms": SSD_BWD_PR28_MS[cell],
               "device_ms_by_kernel": by_kernel["wgmma"],
               "simt_device_ms_by_kernel": by_kernel["simt"],
               "bound_ms": bound, "bound_by": bound_by,
               "bytes": nbytes, "flops": flops, "head_groups": [G2, G3],
               "scratch_bytes": scratch,
               "float32_bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S,
                                             flops / H100_FP32_OPS_PER_S),
               "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={Q}, x/B/C/dy "
                        "bf16, dt/A f32, dstate 0"}
        if cell == "mamba2":
            row["plain_ms"] = cuda_ms(lambda: ssd_ref.ssd_bwd(*args, chunk=Q),
                                      2)
        print(f"[time] ssd backward {cell} training {row['shape']}: wgmma "
              f"route {turns['wgmma']} ms ({flops / row['ms'] / 1e9:.2f} "
              f"TFLOP/s; device ms a call by kernel {by_kernel['wgmma']}; "
              f"scratch {scratch} B, head groups {G2}, {G3}), simt route "
              f"{turns['simt']} ms (PR 28: {SSD_BWD_PR28_MS[cell]} ms; by "
              f"kernel {by_kernel['simt']}), bound {bound:.5f} ms "
              f"({nbytes} bytes, {flops} flops; {bound_by}; at the float32 "
              f"rate {row['float32_bound_ms']:.4f} ms)"
              + ("" if cell != "mamba2" else
                 f"; plain {row['plain_ms']:.3f} ms"), flush=True)
        out[cell] = row
        del args
        torch.cuda.empty_cache()
    # the SIMT route where it runs: the float32 mamba2 step's shape
    # (TRAIN_SMALL_RUN, full width), every input float32, dstate 0
    B, S = TRAIN_SMALL_RUN["global_batch"], TRAIN_SMALL_RUN["seq_len"]
    _, _, _, H, P, N, Q, _, _, _ = SSD_BWD_CHECKS[0]
    args = ssd_bwd_inputs(dev, B, S, H, P, N, F32_3, False, 7)
    if ssd_ops.bwd_route(args[0], args[3], args[4], args[5]) != "simt":
        fail("the float32 SSD backward's timing inputs do not take the simt "
             "route")
    call = lambda: ssd_ops.ssd_bwd(*args, chunk=Q)
    _, _, nbytes, flops = ssd_bwd_bound(args, Q)
    f32_step = {"shape": f"B={B} S={S} H={H} P={P} N={N} chunk={Q}, every "
                         "input float32, dstate 0",
                "ms": cuda_ms(call, 10),
                "device_ms_by_kernel": route_kernel_ms(
                    call, SSD_BWD_ROUTE_KERNELS["simt"]),
                "bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S,
                                      flops / H100_FP32_OPS_PER_S),
                "bound_by": "operations at the float32 rate"
                if flops / H100_FP32_OPS_PER_S > nbytes / H100_BYTES_PER_S
                else "bytes"}
    print(f"[time] ssd backward at the float32 mamba2 step's shape "
          f"{f32_step['shape']}: the simt route {f32_step['ms']:.4f} ms "
          f"(device ms a call by kernel {f32_step['device_ms_by_kernel']}), "
          f"bound {f32_step['bound_ms']:.5f} ms ({f32_step['bound_by']})",
          flush=True)
    del args
    m = out["mamba2"]
    keep = ("shape", "ms", "ms_turns", "simt_ms", "simt_ms_turns",
            "pr28_simt_ms", "device_ms_by_kernel", "simt_device_ms_by_kernel",
            "bound_ms", "bound_by", "scratch_bytes", "head_groups")
    return {**{k: m[k] for k in keep}, "plain_ms": m["plain_ms"],
            "float32_bound_ms": m["float32_bound_ms"], "library_ms": None,
            "library_note": "no PyTorch call computes the SSD scan's "
                            "backward",
            "at_zamba2_training": {k: out["zamba2"][k] for k in keep},
            "simt_at_float32_step": f32_step}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path[:0] = [os.path.join(root, "src"), root]

    from repro_torch.core import cluster_sim, mva, optimizer, problem, \
        qn_sim, tpcds
    from repro_torch.core.shapes import bucket_slots
    from repro_torch.kernels import build
    from repro_torch.kernels.amva import ops as amva_ops
    from repro_torch.kernels.amva import ref as amva_ref
    from repro_torch.kernels.dag_event import ops as dag_ops
    from repro_torch.kernels.dag_event import ref as dag_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.qn_event import ops as qn_ops
    from repro_torch.kernels.qn_event import ref as qn_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.obs import trace

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{kind} x{torch.cuda.device_count()}; matmul allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}",
          flush=True)
    print(smi, flush=True)

    # ---------------------------------------------------------------- build
    phase("build")
    t0 = time.perf_counter()
    build.library()
    usage = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] {time.perf_counter() - t0:.2f} s "
          f"(libqn_{build.source_hash()}.so); ptxas: {' | '.join(usage)}",
          flush=True)
    qn_usage = flash_ptxas(build.build_log,
                           lambda ln: fast_instance(ln)
                           or qn_template_instance(ln) or qn_instance(ln))
    for name, props in qn_usage.items():
        print(f"[build] {name}: {props}", flush=True)
    if not {*DAG_FAST_INSTANCES, "dag_event_kernel"} <= set(qn_usage):
        fail("ptxas reported no registers for a dag_event kernel")
    if not {*QN_INSTANCES, "qn_event_general"} <= set(qn_usage):
        fail(f"ptxas reported no registers for a qn_event kernel: "
             f"{sorted(set(QN_INSTANCES) - set(qn_usage))}")
    fa_usage = flash_ptxas(build.build_log)
    for name, props in fa_usage.items():
        print(f"[build] {name}: {props}", flush=True)
    if not {*FA_FWD_INSTANCES, "fa_fwd_split_kernel"} <= set(fa_usage):
        fail(f"ptxas reported no registers for a float32 wgmma forward "
             f"kernel: {sorted(fa_usage)}")
    lib_path = build.BUILD_DIR / f"libqn_{build.source_hash()}.so"
    sass = sass_counts(lib_path, flash_instance, ("HGMMA", "UTMALDG"))
    print(f"[build] SASS of the flash kernels (cuobjdump -sass): {sass}",
          flush=True)
    if any(not all(c.values()) for n, c in sass.items()
           if "wgmma" in n or "parts" in n) \
            or not any("wgmma" in n for n in sass) \
            or not set(FA_FWD_INSTANCES) <= set(sass):
        fail("a wgmma flash forward kernel (bf16, or float32 on its parts) "
             "issues no wgmma (HGMMA) or no TMA load (UTMALDG)")
    bwd_usage = flash_ptxas(build.build_log, flash_bwd_instance)
    for name, props in bwd_usage.items():
        print(f"[build] {name}: {props}", flush=True)
    if set(bwd_usage) != set(FA_BWD_INSTANCES):
        fail(f"ptxas reported {sorted(bwd_usage)} for the flash backward's "
             f"wgmma instances, expected {FA_BWD_INSTANCES}")
    bwd_notes = collections.Counter(
        (flash_bwd_instance(ln), ln[ln.index("(C75"):][:7])
        for ln in build.build_log.splitlines()
        if "(C75" in ln and flash_bwd_instance(ln))
    print(f"[build] ptxas performance notes on the flash backward's wgmma "
          f"instances: {dict(bwd_notes) or 'none'}", flush=True)
    bwd_sass = sass_counts(lib_path, flash_bwd_instance, ("HGMMA", "UTMALDG"))
    print(f"[build] SASS of the flash backward's wgmma kernels (cuobjdump "
          f"-sass): {bwd_sass}", flush=True)
    if set(bwd_sass) != set(FA_BWD_INSTANCES) or \
            any(not all(c.values()) for c in bwd_sass.values()):
        fail("a flash backward wgmma kernel issues no wgmma (HGMMA) or no "
             "TMA load (UTMALDG)")
    ssd_usage = flash_ptxas(build.build_log, ssd_instance)
    for name, props in ssd_usage.items():
        print(f"[build] {name}: {props}", flush=True)
    ssd_sass = sass_counts(lib_path, ssd_instance, ("HGMMA", "UTMALDG"))
    print(f"[build] SASS of the ssd_scan kernels (cuobjdump -sass): "
          f"{ssd_sass}", flush=True)
    if any(not all(c.values()) for n, c in ssd_sass.items()
           if "wgmma" in n or n in SSD_PARTS_INSTANCES) \
            or not any("wgmma" in n for n in ssd_sass) \
            or not set(SSD_PARTS_INSTANCES) <= set(ssd_sass) \
            or not {*SSD_PARTS_INSTANCES, "ssd_parts_split_kernel",
                    "ssd_parts_scan_kernel"} <= set(ssd_usage):
        fail("an SSD forward kernel on wgmma (bf16, or float32 on its "
             "parts) has no ptxas line, no wgmma (HGMMA) or no TMA load "
             f"(UTMALDG): {sorted(ssd_usage)}")
    ssd_bwd_usage = flash_ptxas(build.build_log, ssd_bwd_instance)
    for name, props in ssd_bwd_usage.items():
        print(f"[build] {name}: {props}", flush=True)
    ssd_bwd_sass = sass_counts(lib_path, ssd_bwd_instance,
                               ("HGMMA", "UTMALDG"))
    print(f"[build] SASS of the SSD backward's wgmma route (cuobjdump "
          f"-sass): {ssd_bwd_sass}", flush=True)
    if not set(SSD_BWD_INSTANCES) <= set(ssd_bwd_usage) or any(
            not all(ssd_bwd_sass.get(n, {}).values()) or n not in ssd_bwd_sass
            for n in SSD_BWD_INSTANCES):
        fail("an SSD backward wgmma kernel has no ptxas line, no wgmma "
             "(HGMMA) or no TMA load (UTMALDG)")
    streams_sass = sass_counts(
        lib_path, lambda ln: "qn_streams_kernel" if "qn_streams_kernel"
        in ln else None, ("SHF", "LOP3", "IMAD", "IADD3"))
    print(f"[build] SASS of the draw-table kernel (its threefry2x32 "
          f"instances: rotates SHF and xors LOP3 on the integer pipe, adds "
          f"mostly IMAD on the FMA pipe): {streams_sass}", flush=True)
    per_event = dag_threefries(root)
    print(f"[build] dag_streams_kernel's threefry calls per event in its "
          f"source (exponential, replay): {per_event[False]}, "
          f"{per_event[True]}; the bound counts "
          f"{DAG_THREEFRY_PER_EVENT[False]}, {DAG_THREEFRY_PER_EVENT[True]}",
          flush=True)
    if per_event != DAG_THREEFRY_PER_EVENT:
        fail(f"dag_streams_kernel draws {per_event} threefries an event, "
             f"the bound counts {DAG_THREEFRY_PER_EVENT}")
    print(f"[build] ptxas of the DAG draw tables: "
          f"{flash_ptxas(build.build_log, streams_instance)}", flush=True)
    # the AMVA round's division: no range check (FCHK), convergence
    # barrier (BSSY) or slow-path call on the fast rounds; the rounds
    # again with __fdiv_rn (its FCHK and call) only after them
    amva_sass = sass_counts(
        lib_path, lambda ln: next((k for k in (
            "amva_ps_frontier_kernel", "amva_ps_kernel", "amva_mva_kernel")
            if k in ln), None), ("MUFU", "FCHK", "BSSY", "CALL", "BRA"))
    print(f"[build] SASS of the amva kernels: {amva_sass}", flush=True)

    # ----------------------------------------------- kernels vs plain (card)
    phase("checks")
    gen = np.random.default_rng(11)
    H, S, E = 10, 512, 4096
    lanes = [  # (n_map, n_reduce, slots_cap, n_events_active)
        (500, 1, 432, E), (500, 1, 300, E), (64, 16, 40, E), (64, 16, 7, E),
        (8, 2, 1, E), (8, 2, 3, E // 3), (400, 64, 512, E), (1, 1, 1, 0),
        (32, 8, 16, E // 2), (3, 0, 2, E), (16, 4, 64, 1), (500, 1, 512, E),
    ]
    B = len(lanes)
    cols = list(zip(*lanes))
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    nm, nr, cap, nea = (i32(c) for c in cols)
    ma = f32(gen.uniform(2000, 9000, B))
    ra = f32(gen.uniform(1000, 5000, B))
    tm = f32(gen.uniform(5000, 30000, B))
    seeds = torch.tensor(1000 * np.arange(B), dtype=torch.int64, device=dev)
    m_list = f32(gen.lognormal(np.log(5000), 0.5, 2048))
    r_list = f32(gen.lognormal(np.log(2500), 0.5, 2048))
    qn_err = 0.0
    streams_checked = []
    streams_err = [0.0]

    def check_streams(tm_, seeds_, nea_, H_, E_, smp_, tag):
        """The draw-table kernel against its plain version: every table
        bit for bit (torch.equal); returns the kernel's tables."""
        kw_ = dict(h_users=H_, n_events=E_, m_samples=smp_[0],
                   r_samples=smp_[1])
        got_ = qn_ops.event_streams(tm_, seeds_, nea_, **kw_)
        want_ = qn_ref.event_streams(tm_, seeds_, nea_, **kw_)
        same_ = all(torch.equal(a, b) for a, b in zip(got_, want_))
        streams_err[0] = max([streams_err[0]] + [
            float((a - b).abs().max()) for a, b in zip(got_, want_)
            if a.numel()])
        streams_checked.append(tag)
        if not same_:
            fail(f"event_streams differs from its plain version ({tag})")
        return got_

    for replay in (False, True):
        smp = (m_list, r_list) if replay else (None, None)
        tables = check_streams(tm, seeds, nea, H, E, smp,
                               f"B={B} E={E} H={H} replay={replay}")
        print(f"[check] event_streams replay={replay} B={B} E={E} H={H}: "
              f"bit-identical=True", flush=True)
        args = (nm, nr, cap, nea, ma, ra, tm, *tables)
        kw = dict(max_slots=S, warmup_jobs=8, replay=replay)
        k0 = dict(qn_ops.qn_event.routes)
        ks, kc = qn_ops.qn_event(*args, **kw)
        gs, gc = qn_ops.qn_event(*args, general=True, **kw)
        if {k: n - k0[k] for k, n in qn_ops.qn_event.routes.items()} != \
                {"qn_event_fast": 1, "qn_event_general": 1,
                 "qn_event_wide": 0, "qn_event_many": 0}:
            fail(f"qn_event reported the kernels {qn_ops.qn_event.routes} "
                 f"(from {k0}) for one launch without and one with "
                 f"general=True")
        ps, pc = qn_ref.qn_event(*args, **kw)
        same = torch.equal(ks, ps) and torch.equal(kc, pc)
        same_general = torch.equal(gs, ps) and torch.equal(gc, pc)
        qn_err = max(qn_err, float((ks - ps).abs().max()),
                     float((kc - pc).abs().max()),
                     float((gs - ps).abs().max()),
                     float((gc - pc).abs().max()))
        print(f"[check] qn_event replay={replay} B={B} E={E} S={S} H={H}: "
              f"bit-identical={same} (qn_event_general: {same_general}) "
              f"jobs={kc.tolist()}", flush=True)
        if not (same and same_general):
            fail(f"qn_event differs from its plain version (replay={replay})")
        if float(kc.sum()) <= 0:
            fail("qn_event check completed no job")
    if float(kc[7]) != 0.0:
        fail("a padding lane (zero budget) reported jobs")
    # more than 32 users (and a slot count past the main path's) take the
    # kernel for any H; H = 2049 once raised on the card.  Long thinks let
    # jobs finish within the budget
    H_big, E_big = 2049, 4096
    lanes_big = (i32([8, 30]), i32([2, 3]), i32([64, 7]), i32([E_big, E_big]),
                 f32([60.0, 80.0]), f32([30.0, 45.0]), f32([1.5e5, 1.0e5]))
    seeds_big = torch.tensor([7, 1007], dtype=torch.int64, device=dev)
    smp_big = (f32(gen.uniform(30, 90, 37)), f32(gen.uniform(20, 50, 11)))
    tables_big = check_streams(lanes_big[6], seeds_big, lanes_big[3], H_big,
                               E_big, smp_big, f"B=2 E={E_big} H={H_big}")
    kw = dict(max_slots=64, warmup_jobs=2, replay=True)
    ks, kc = qn_ops.qn_event(*lanes_big, *tables_big, **kw)
    ps, pc = qn_ref.qn_event(*lanes_big, *tables_big, **kw)
    same = torch.equal(ks, ps) and torch.equal(kc, pc)
    qn_err = max(qn_err, float((ks - ps).abs().max()),
                 float((kc - pc).abs().max()))
    print(f"[check] event_streams and qn_event B=2 E={E_big} S=64 "
          f"H={H_big}: bit-identical={same} jobs={kc.tolist()}", flush=True)
    if not same:
        fail(f"qn_event differs from its plain version at H={H_big}")
    if float(kc.min()) <= 0:
        fail(f"qn_event at H={H_big} completed no job in a lane")
    # H = 12000 users outgrow the card's 227 KB of shared memory a block:
    # qn_event_general keeps the lane's state in a global scratch slice
    H_huge, E_huge = 12000, 1024
    lanes_huge = (*lanes_big[:3], i32([E_huge, E_huge]), *lanes_big[4:])
    tables_huge = check_streams(lanes_huge[6], seeds_big, lanes_huge[3],
                                H_huge, E_huge, smp_big,
                                f"B=2 E={E_huge} H={H_huge}")
    scratch_bytes = build.library().qn_event_scratch_bytes(H_huge, 64,
                                                           E_huge)
    if scratch_bytes <= 0:
        fail(f"qn_event at H={H_huge} does not take the global scratch")
    ks, kc = qn_ops.qn_event(*lanes_huge, *tables_huge, **kw)
    ps, pc = qn_ref.qn_event(*lanes_huge, *tables_huge, **kw)
    same = torch.equal(ks, ps) and torch.equal(kc, pc)
    qn_err = max(qn_err, float((ks - ps).abs().max()),
                 float((kc - pc).abs().max()))
    print(f"[check] event_streams and qn_event B=2 E={E_huge} S=64 "
          f"H={H_huge} (global scratch, {scratch_bytes} bytes a lane): "
          f"bit-identical={same} jobs={kc.tolist()}", flush=True)
    if not same:
        fail(f"qn_event differs from its plain version at H={H_huge}")
    if float(kc.min()) <= 0:
        fail(f"qn_event at H={H_huge} completed no job in a lane")
    # qn_event_wide (at most 32 users past 512 slots, up to 16384:
    # cost_deadline's probes) against the plain version, and
    # qn_event_general asked for at the same inputs: every lane bit for
    # bit, each lane finishing jobs past the warm-up; the checks with the
    # same users and mode share one plain run (plain_in_one_run)
    wide_checked = {}    # each check's kernel and plain ms, by shape
    wide_runs = collections.defaultdict(list)
    for H_w, S_w, E_w, modes, caps_w, nm_w, nr_w in WIDE_CHECKS:
        for replay in modes:
            lanes_w, seeds_w, smp_w = wide_lanes(dev, caps_w, nm_w, nr_w,
                                                 E_w, H_w, replay)
            tag = (f"B={len(caps_w)} E={E_w} S={S_w} H={H_w} "
                   f"replay={replay}")
            tables_w = check_streams(lanes_w[6], seeds_w, lanes_w[3], H_w,
                                     E_w, smp_w, tag)
            args_w = (*lanes_w, *tables_w)
            kw = dict(max_slots=S_w, warmup_jobs=WIDE_WARMUP, replay=replay)
            k0 = dict(qn_ops.qn_event.routes)
            ks, kc = qn_ops.qn_event(*args_w, **kw)
            took = [k for k, n in qn_ops.qn_event.routes.items()
                    if n > k0[k]]
            gs, gc = qn_ops.qn_event(*args_w, general=True, **kw)
            kernel_ms = cuda_ms(lambda: qn_ops.qn_event(*args_w, **kw), 3)
            if took != ["qn_event_wide"]:
                fail(f"qn_event at {tag} took {took}, not qn_event_wide")
            wide_runs[(H_w, replay)].append(
                (tag, S_w, args_w, (ks, kc, gs, gc), kernel_ms, took,
                 caps_w, nm_w))
    for (H_w, replay), group in wide_runs.items():
        plain, plain_ms, plain_shape = plain_in_one_run(
            qn_ref, [(g[2], g[1]) for g in group], WIDE_WARMUP, replay)
        for (tag, _, _, (ks, kc, gs, gc), kernel_ms, took, caps_w, nm_w), \
                (ps, pc) in zip(group, plain):
            same = torch.equal(ks, ps) and torch.equal(kc, pc)
            same_general = torch.equal(gs, ps) and torch.equal(gc, pc)
            qn_err = max(qn_err, float((ks - ps).abs().max()),
                         float((kc - pc).abs().max()),
                         float((gs - ps).abs().max()),
                         float((gc - pc).abs().max()))
            print(f"[check] qn_event {tag} caps {caps_w} maps {nm_w} "
                  f"({', '.join(took)}): bit-identical={same} "
                  f"(qn_event_general: {same_general}) jobs={kc.tolist()}; "
                  f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms (one "
                  f"run of {len(group)} checks' lanes, {plain_shape})",
                  flush=True)
            if not (same and same_general):
                fail(f"qn_event differs from its plain version at {tag}")
            if float(kc.min()) <= 0:
                fail(f"qn_event at {tag} left a lane without jobs past the "
                     f"warm-up")
            wide_checked[tag] = {"ms": kernel_ms, "plain_ms": plain_ms}
    # one lane of Table 3's largest row (1560 maps, 1009 reduces, 80
    # containers, one user, its replay lists): the draw tables at the row's
    # full budget, the event loop with the budget cut to E_T3 events (the
    # plain loop takes ~2 ms an event) and no warm-up, so that its first
    # job (~5142 events) completes inside the cut
    t3_row = tpcds.TABLE3[T3_ROW]
    t3_spec = tpcds.calibrated_specs()[T3_ROW]
    t3_full = qn_sim.padded_event_budget(t3_row.n_map, t3_row.n_reduce,
                                         min_jobs=40, warmup_jobs=8)
    t3_lists = tuple(f32(np.asarray(x, np.float32))
                     for x in cluster_sim.replayer_lists(
                         t3_spec, runs=20, slots=t3_row.containers, seed=55))
    t3_lane = (i32([t3_row.n_map]), i32([t3_row.n_reduce]),
               i32([t3_row.containers]), i32([t3_full]), f32([0.0]),
               f32([0.0]), f32([tpcds.THINK_MS]))
    t3_seed = torch.tensor([3], dtype=torch.int64, device=dev)
    t3_tables = check_streams(t3_lane[6], t3_seed, t3_lane[3],
                              t3_row.users, t3_full, t3_lists,
                              f"Table 3 row {T3_ROW}: B=1 E={t3_full} "
                              f"H={t3_row.users}")
    t3_cut = (*t3_lane[:3], i32([E_T3]), *t3_lane[4:], t3_tables[0],
              *(t[:, :E_T3].contiguous() for t in t3_tables[1:]))
    t3_slots = bucket_slots(t3_row.containers)
    t3_kw = dict(max_slots=t3_slots, warmup_jobs=0, replay=True)
    k0 = dict(qn_ops.qn_event.routes)
    ks, kc = qn_ops.qn_event(*t3_cut, **t3_kw)
    t3_took = [k for k, n in qn_ops.qn_event.routes.items() if n > k0[k]]
    ps, pc = qn_ref.qn_event(*t3_cut, **t3_kw)
    same = torch.equal(ks, ps) and torch.equal(kc, pc)
    qn_err = max(qn_err, float((ks - ps).abs().max()),
                 float((kc - pc).abs().max()))
    print(f"[check] Table 3 row {T3_ROW} lane ({t3_row.n_map} maps, "
          f"{t3_row.n_reduce} reduces, {t3_row.containers} slots of "
          f"{t3_slots}, H={t3_row.users}, replay): event_streams at its full "
          f"E={t3_full} bit-identical=True; qn_event "
          f"({', '.join(t3_took)}) at E={E_T3}, "
          f"the budget cut {t3_full / E_T3:.0f}x: bit-identical={same} "
          f"jobs={kc.tolist()}", flush=True)
    if not same:
        fail(f"qn_event differs from its plain version on Table 3 row "
             f"{T3_ROW}'s lane")
    if float(kc.min()) <= 0:
        fail(f"qn_event on Table 3 row {T3_ROW}'s lane completed no job")
    amva_err = 0.0
    for n in (1, 7, 97, 128, 1000, 4097):
        a = f32(np.abs(gen.normal(size=n)) * 1e4)
        b = f32(np.abs(gen.normal(size=n)) * 1e3)
        z = f32(np.full(n, 1e4))
        h = f32(np.round(np.abs(gen.normal(size=n)) * 10 + 1))
        k = amva_ops.ps_fixed_point(a, b, z, h)
        p = amva_ref.ps_fixed_point(a, b, z, h)
        amva_err = max(amva_err, float((k - p).abs().max()))
        if not torch.equal(k, p):
            fail(f"amva differs from its plain version at N={n}")
    print(f"[check] amva N=1,7,97,128,1000,4097: bit-identical=True",
          flush=True)
    # the frontier entry (the scalars by value, a_over_c divided in float64
    # on the card) against ps_fixed_point on host-built tensors and the
    # plain version; Q1-10u's m4.xlarge demand, think time and users
    a_q, b_q, z_q, h_q = 5488087.17967804, 38792.787047447186, 1e4, 10.0
    for slots_q, n_q in AMVA_FRONTIERS:
        nus_q = np.arange(20, 20 + n_q)
        host = (f32(a_q / (nus_q * slots_q)), f32(np.full(n_q, b_q)),
                f32(np.full(n_q, z_q)), f32(np.full(n_q, h_q)))
        k = amva_ops.ps_frontier(a_q, slots_q, 20, n_q, b_q, z_q, h_q,
                                 device=dev)
        p = amva_ref.ps_frontier(a_q, slots_q, 20, n_q, b_q, z_q, h_q,
                                 device=dev)
        amva_err = max(amva_err, float((k - p).abs().max()))
        if not (torch.equal(k, amva_ops.ps_fixed_point(*host))
                and torch.equal(k, p)):
            fail(f"the amva frontier entry differs from ps_fixed_point or "
                 f"its plain version at {slots_q} slots, N={n_q}")
    # the round's quotient without its range check: one round at a = 1,
    # b = 0 returns max(1, h / (1 + z)), over 2**22 random pairs inside
    # the fast path's range and a few thousand outside it (which run the
    # rounds again with __fdiv_rn), against the plain version on the CPU
    n_q = 1 << 22
    y_q = np.ldexp(gen.uniform(1, 2, n_q), gen.integers(-20, 58, n_q))
    x_q = (y_q * np.ldexp(gen.uniform(1, 2, n_q), gen.integers(0, 40, n_q))
           ).astype(np.float32)
    z_q = (y_q - 1.0).astype(np.float32)
    odd = gen.choice(n_q, 4096, replace=False)
    x_q[odd[:1024]] = np.float32(1e-40)
    z_q[odd[1024:2048]] = np.float32(3e38)
    x_q[odd[2048:]] = gen.choice(np.array([0.0, np.inf, np.nan, 3e38],
                                          np.float32), 2048)
    one_q = [torch.tensor(v) for v in (np.ones(n_q, np.float32),
                                       np.zeros(n_q, np.float32), z_q, x_q)]
    for iters in (1, 40):
        k = amva_ops.ps_fixed_point(*(v.to(dev) for v in one_q),
                                    iters=iters).cpu()
        p = amva_ref.ps_fixed_point(*one_q, iters=iters)
        if not bool(((k == p) | (k.isnan() & p.isnan())).all()):
            fail(f"amva's round quotient differs from the IEEE division "
                 f"({iters} rounds, random operands)")
    print(f"[check] amva frontier entry (slots, N) "
          f"{AMVA_FRONTIERS}: bit-identical to ps_fixed_point and the plain "
          f"version=True; the round's quotient over {n_q} random operand "
          f"pairs (4096 outside the fast range): IEEE bits=True (NaN where "
          f"the plain version gives NaN)", flush=True)
    # exact MVA at the reference's kernel-test sizes (tests/test_kernels.py)
    mva_err = 0.0
    for n in MVA_NS:
        d = f32(np.abs(gen.normal(size=n)) * 10 + 1)
        z = f32(np.full(n, 1e4))
        for h_users in MVA_HS:
            k = amva_ops.mva_response(d, z, h_users)
            p = amva_ref.mva_response(d, z, h_users)
            mva_err = max(mva_err, float((k - p).abs().max()))
            if not torch.equal(k, p) or (h_users == 0
                                         and not torch.equal(k, d)):
                fail(f"mva differs from its plain version at N={n} "
                     f"H={h_users}")
    print(f"[check] mva N={','.join(map(str, MVA_NS))} x H="
          f"{','.join(map(str, MVA_HS))}: "
          f"bit-identical=True (H=0 returns the demand)", flush=True)
    dag_err, dag_streams_err, dag_checked = check_dag(dev, dag_ops, dag_ref,
                                                      build, gen)
    fa_checked = check_flash(dev, fa_ops, fa_ref)
    ssd_err = check_ssd(dev, ssd_ops, ssd_ref)
    kernels = {"qn_event": qn_ops.qn_event,
               "event_streams": qn_ops.event_streams,
               "dag_event": dag_ops.dag_event,
               "dag_streams": dag_ops.dag_streams,
               "amva": amva_ops.ps_frontier,
               "amva_tensors": amva_ops.ps_fixed_point,
               "mva": amva_ops.mva_response,
               "flash_attention": fa_ops.flash_attention,
               "ssd_scan": ssd_ops.ssd,
               "ssd_bwd": ssd_ops.ssd_bwd}
    wrappers = tuple(kernels.values())

    # ------------------------------------------------------------ main path
    phase("main path")
    DSpace4Cloud = optimizer.DSpace4Cloud
    prob, samples, _ = tpcds.scenario_problem("Q1", 10, 160_000.0)
    quick = quickstart_problem(problem)
    drives = [("Q1-10u.run", lambda: DSpace4Cloud(
                   prob, samples=samples).run()),
              ("Q1-10u.run_fast", lambda: DSpace4Cloud(
                   prob, samples=samples).run_fast()),
              ("quickstart.run", lambda: DSpace4Cloud(
                   quick, min_jobs=20, replications=1).run()),
              # the point-wise gait: one qn_event launch per probe and
              # replication; quickstart's two classes walk in two threads
              ("Q1-10u.run_pointwise", lambda: DSpace4Cloud(
                   prob, samples=samples, batched=False).run()),
              ("quickstart.run_pointwise", lambda: DSpace4Cloud(
                   quick, min_jobs=20, replications=1,
                   batched=False).run(parallel=True))]
    launches = dict.fromkeys(kernels, 0)
    # every drive's qn_event launches, by route
    qn_route_launches = dict.fromkeys(qn_ops.ROUTES, 0)
    # the DAG drives' dag_event launches, by route
    dag_route_launches = dict.fromkeys(dag_ops.ROUTES, 0)
    mismatches = []
    shape_count = collections.Counter()
    pw_shape_count = collections.Counter()   # the point-wise walk's B=1
    plans = {}
    for name, drive in drives:
        reset_launches(*wrappers)
        qn_sim.reset_sim_stats()
        t0 = time.perf_counter()
        with trace.tracing() as tracer:
            rep = drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "Q1-10u.run":
            shape_count.update(
                (sp.args["lanes"], sp.args["scan_len"], sp.args["max_slots"],
                 sp.args["h_users"]) for sp in tracer.by_name("kernel:cuda"))
        if name == "Q1-10u.run_pointwise":
            # each probe is one single-lane launch per replication, at the
            # bucketed slots of its nu and the class's event budget
            probes = [(tr.cls, nu) for tr in rep.traces.values()
                      for nu, _, _ in tr.moves]
            reps, e_pw = (rep.qn_dispatches // len(probes),
                          rep.telemetry["qn"]["events_total"]
                          // rep.qn_dispatches)
            for cname, nu in probes:
                c_pw = next(c for c in prob.classes if c.name == cname)
                vm_pw = prob.vm_by_name(rep.initial[cname].vm_type)
                pw_shape_count[(1, e_pw, bucket_slots(nu * vm_pw.slots),
                                c_pw.h_users)] += reps
            if sum(pw_shape_count.values()) != rep.qn_dispatches:
                fail(f"{name}: the probes {probes} do not account for "
                     f"{rep.qn_dispatches} dispatches")
        got_launches = {k: w.launches for k, w in kernels.items()}
        for k, n in got_launches.items():
            launches[k] += n
        for r, n in qn_ops.qn_event.routes.items():
            qn_route_launches[r] += n
        n_qn = got_launches["qn_event"]
        n_amva = got_launches["amva"]
        got = decisions(rep)
        plans[name] = {"wall_s": wall, "qn_dispatches": rep.qn_dispatches,
                       "qn_event_launches": n_qn, "amva_launches": n_amva,
                       "ms_per_dispatch": 1e3 * wall / max(1,
                                                           rep.qn_dispatches)}
        print(f"[main] {name}: wall={wall:.3f} s qn_dispatches="
              f"{rep.qn_dispatches} ({plans[name]['ms_per_dispatch']:.2f} ms "
              f"of wall each) launches qn_event={n_qn} event_streams="
              f"{got_launches['event_streams']} amva={n_amva} "
              f"events={rep.telemetry['qn']['events_total']} "
              f"decisions={json.dumps(got)}", flush=True)
        if name.endswith("pointwise"):
            print(f"[main] {name} probes: "
                  f"{ {k: [m[0] for m in t.moves] for k, t in rep.traces.items()} }",
                  flush=True)
        ref = REFERENCE[name]
        # replay mode (Q1-10u) draws no logarithm: its response times must
        # be the reference's bit for bit; exponential mode (quickstart)
        # within the relative 1e-3 that last-ulp draws leave
        rel_tol = 0.0 if name.startswith("Q1-10u") else 1e-3
        print(f"[main] {name} reference: qn_dispatches="
              f"{ref['qn_dispatches']} decisions="
              f"{json.dumps(ref['classes'])}", flush=True)
        for cls, want in ref["classes"].items():
            have = got[cls]
            same = all(have[k] == want[k] for k in
                       ("vm_type", "nu", "reserved", "spot", "cost_per_h",
                        "feasible"))
            rel = abs(have["predicted_ms"] - want["predicted_ms"]) \
                / want["predicted_ms"]
            if not same or ref["qn_dispatches"] != rep.qn_dispatches \
                    or rel > rel_tol:
                mismatches.append(name)
            print(f"[main] {name} {cls}: predicted_ms port "
                  f"{have['predicted_ms']!r} reference "
                  f"{want['predicted_ms']!r} rel {rel:.3e} (tol {rel_tol})",
                  flush=True)
        if n_qn != rep.qn_dispatches or n_qn <= 0:
            fail(f"{name}: qn_event launches {n_qn} != fused dispatches "
                 f"{rep.qn_dispatches}")
        if got_launches["event_streams"] != n_qn:
            fail(f"{name}: event_streams launches "
                 f"{got_launches['event_streams']} != qn_event launches "
                 f"{n_qn} (one table draw a dispatch)")
        if name.endswith("run_fast") and n_amva <= 0:
            fail(f"{name}: the amva kernel was not launched")
        if any(got_launches[k] for k in ("mva", "flash_attention",
                                         "ssd_scan", "dag_event",
                                         "dag_streams")):
            fail(f"{name}: the planner launched a kernel off its path: "
                 f"{got_launches}")
        for cls, sol in got.items():
            if not (np.isfinite(sol["predicted_ms"]) and sol["nu"] >= 1
                    and sol["reserved"] + sol["spot"] == sol["nu"]):
                fail(f"{name}: malformed solution for {cls}: {sol}")
    print(f"[main] decisions differing from the reference: "
          f"{sorted(set(mismatches)) or 'none'}", flush=True)
    if mismatches:
        fail(f"decisions differ from the reference's: {sorted(set(mismatches))}")

    # device busy share of one plan in each gait (torch.profiler, CUDA
    # activity)
    from torch.profiler import ProfilerActivity, profile
    for label, plan in [
            ("Q1-10u.run", lambda: DSpace4Cloud(prob, samples=samples).run()),
            ("Q1-10u.run_pointwise", lambda: DSpace4Cloud(
                prob, samples=samples, batched=False).run())]:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_run:
            t0 = time.perf_counter()
            plan()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = collections.Counter()
        for ev in prof_run.events():       # device-side kernel records only
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3
        busy_ms = sum(by_kernel.values())
        top = ", ".join(f"{k[:40]}={v:.2f}"
                        for k, v in by_kernel.most_common(5))
        print(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy "
              f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
              f"{100 * (1 - busy_ms / wall_ms):.1f}%; top ms: {top}"
              if busy_ms > 0 else
              f"[profile] {label}: wall {wall_ms:.2f} ms, device time not "
              f"measured (the profiler recorded no device activity)",
              flush=True)

    # the point-wise simulator's degenerate case against exact MVA on the
    # card: the scalar simulate() (3 replications, one launch each) and
    # response_time_batch (one launch), the reference's own two checks
    reset_launches(*wrappers)
    m_scalar, c_scalar = qn_sim.simulate(qn_sim.QNParams(
        **DEGENERATE, slots=1, n_events=60_000, warmup_jobs=50, seed=1), 3)
    t_batch = float(qn_sim.response_time_batch(
        **DEGENERATE, slots=np.array([1]), min_jobs=400, warmup_jobs=50,
        seed=1, replications=3)[0])
    demand = DEGENERATE["m_avg"] + DEGENERATE["r_avg"]
    mva_args = (f32([demand]), f32([DEGENERATE["think_ms"]]),
                DEGENERATE["h_users"])
    exact_t = amva_ops.mva_response(*mva_args)
    torch.cuda.synchronize()
    got_launches = {k: w.launches for k, w in kernels.items()}
    if not torch.equal(exact_t, amva_ref.mva_response(*mva_args)):
        fail("mva differs from its plain version at the degenerate case")
    exact = float(exact_t[0])
    want_launches = dict.fromkeys(kernels, 0)
    want_launches.update(qn_event=4, event_streams=4, mva=1)
    for k, n in got_launches.items():
        launches[k] += n
    for r, n in qn_ops.qn_event.routes.items():
        qn_route_launches[r] += n
    rel = {"simulate": abs(m_scalar - exact) / exact,
           "response_time_batch": abs(t_batch - exact) / exact}
    host_exact = mva.mva_response(demand, DEGENERATE["think_ms"],
                                  DEGENERATE["h_users"])
    print(f"[pointwise] degenerate case (demand {demand:g} ms, think "
          f"{DEGENERATE['think_ms']:g} ms, H={DEGENERATE['h_users']}, one "
          f"slot): exact MVA on the card {exact!r} (host float64 "
          f"{host_exact!r}); simulate(3 replications) {m_scalar!r} over "
          f"{c_scalar:g} jobs, rel {rel['simulate']:.4f}; "
          f"response_time_batch {t_batch!r}, rel "
          f"{rel['response_time_batch']:.4f} (tol {DEGENERATE_TOL}); "
          f"launches {got_launches}", flush=True)
    if got_launches != want_launches:
        fail(f"degenerate case: launches {got_launches}, expected "
             f"{want_launches}")
    if not (c_scalar > 1000 and max(rel.values()) <= DEGENERATE_TOL):
        fail("the point-wise simulator's degenerate case is not within "
             f"{DEGENERATE_TOL} of exact MVA")

    small, small_samples = small_replay_problem(problem)
    on_card = decisions(DSpace4Cloud(small, samples=small_samples,
                                     min_jobs=10).run())
    on_cpu = decisions(DSpace4Cloud(small, samples=small_samples,
                                    min_jobs=10, device="cpu").run())
    for cls in on_cpu:
        a, b = on_card[cls], on_cpu[cls]
        if any(a[k] != b[k] for k in ("vm_type", "nu", "reserved", "spot",
                                      "predicted_ms")):
            fail(f"small replay problem: card {a} != cpu {b}")
    print(f"[main] small replay problem, card vs cpu: decisions and "
          f"response times equal; "
          f"predicted_ms card={[v['predicted_ms'] for v in on_card.values()]}"
          f" cpu={[v['predicted_ms'] for v in on_cpu.values()]}", flush=True)

    # ------------------------------------------------ benchmarked scenarios
    phase("scenarios")
    # the repo's public-cloud planner benchmarks at their own budgets
    # (benchmarks/torch_scenarios.py), each a drive of its own: counts set
    # to 0 just before it and read just after, its wall without the
    # profiler; then once more under the profiler for each kernel's device
    # time
    from benchmarks import torch_scenarios as scen
    added_wall = {}
    scenario_runs = {}
    # the qn_event launches past 512 slots, tallied by wrapping sim_batch
    # (the one caller of qn_event on these paths)
    wide_calls = [0]
    qn_sim_batch = qn_ops.sim_batch

    def tallying_sim_batch(*args, max_slots, **kw):
        wide_calls[0] += max_slots > 512
        return qn_sim_batch(*args, max_slots=max_slots, **kw)

    qn_ops.sim_batch = tallying_sim_batch
    for name in SCENARIOS:
        reset_launches(*wrappers)
        qn_sim.reset_sim_stats()
        wide_calls[0] = 0
        t0 = time.perf_counter()
        out = scen.SCENARIOS[name](dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        added_wall[name] = wall
        got_launches = {k: w.launches for k, w in kernels.items()}
        for k, n in got_launches.items():
            launches[k] += n
        for r, n in qn_ops.qn_event.routes.items():
            qn_route_launches[r] += n
        counted = planner_counts(kernels)
        by_route = dict(qn_ops.qn_event.routes)
        past_512 = wide_calls[0]
        n_disp = qn_sim.sim_stats()["dispatches"]
        check_scenario(scen, name, out, REFERENCE[name], got_launches,
                       n_disp, wall)
        print(f"[scenarios] {name}: qn_event launches by route {by_route}, "
              f"{past_512} of them past 512 slots (their slots cut to those "
              f"the users can fill)"
              + (f"; before the cut {ROUTES_BEFORE_CUT[name]}"
                 if name in ROUTES_BEFORE_CUT else ""), flush=True)
        # cost_deadline's probes past 512 slots (at most 20 users) must
        # take qn_event_wide, and none qn_event_general
        if name == "cost_deadline" and (
                by_route["qn_event_general"] or
                by_route["qn_event_wide"] != past_512 or past_512 <= 0):
            fail(f"cost_deadline: qn_event launches by route {by_route}, "
                 f"{past_512} of them past 512 slots (each must take "
                 f"qn_event_wide)")
        _, dev_ms, note = profiled_pass(
            kernels, lambda: scen.SCENARIOS[name](dev), counted, name)
        added_wall[f"{name}.profiled"] = note["wall_s"]
        scenario_runs[name] = {"wall_s": wall, "dispatches": n_disp,
                               "launches": got_launches,
                               "launches_by_kernel": counted,
                               "qn_event_past_512_slots": past_512,
                               "profiled_device_ms": dev_ms,
                               "profiled_wall_s": note["wall_s"]}
        print(f"[scenarios] {name} profiled again: {note['text']}"
              + (f"; host and the rest {wall - sum(dev_ms.values()) / 1e3:.3f}"
                 f" s of the {wall:.3f} s wall (without the profiler)"
                 if None not in dev_ms.values() else ""), flush=True)

    qn_ops.sim_batch = qn_sim_batch

    # the paper's Table 3: T on the host's cluster simulator, tau from the
    # scalar QN on the card (one qn_event launch a replication); then once
    # more under the profiler for each row's device time
    reset_launches(*wrappers)
    qn_sim.reset_sim_stats()
    t0 = time.perf_counter()
    t3 = scen.table3(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    added_wall["table3"] = wall
    got_launches = {k: w.launches for k, w in kernels.items()}
    for k, n in got_launches.items():
        launches[k] += n
    for r, n in qn_ops.qn_event.routes.items():
        qn_route_launches[r] += n
    _, _, note = profiled_pass(kernels, lambda: scen.table3(dev),
                               planner_counts(kernels), "table3")
    added_wall["table3.profiled"] = note["wall_s"]
    table3_rows = check_table3(scen, t3, REFERENCE["table3"], got_launches,
                               wall, note)

    # [dag] the Spark/Tez chains at their own budgets: dag_sweep (the
    # frontier scalar against batched, the optimizer in both gaits) and the
    # solo part of examples/spark_dag_plan.py (a MapReduce class and a
    # 4-stage chain in one problem: run() in both gaits, run_fast()), each
    # a drive of its own, then once more under the profiler
    # Every dag_event launch must take the route ops.route names for its
    # shape: sim_batch (the one caller of dag_event on these paths) is
    # wrapped to tally the route named for each launch's (H, max_slots, K,
    # E, depth), against the routes the wrapper counted and, in the profiled
    # pass, the kernels the profiler saw
    named = collections.Counter()
    sim_batch = dag_ops.sim_batch

    def naming_sim_batch(n_tasks, *args, h_users, max_slots, n_events,
                         **kw):
        named[dag_ops.route(h_users, max_slots, n_tasks.shape[1],
                            n_events, depth=kw.get("depth") or 0)] += 1
        return sim_batch(n_tasks, *args, h_users=h_users,
                         max_slots=max_slots, n_events=n_events, **kw)

    dag_runs = {}
    dag_ops.sim_batch = naming_sim_batch
    for name in DAG_SCENARIOS:
        reset_launches(*wrappers)
        named.clear()
        qn_sim.reset_sim_stats()
        t0 = time.perf_counter()
        out = scen.SCENARIOS[name](dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        added_wall[name] = wall
        got_launches = {k: w.launches for k, w in kernels.items()}
        for k, n in got_launches.items():
            launches[k] += n
        for r, n in qn_ops.qn_event.routes.items():
            qn_route_launches[r] += n
        by_route = dict(dag_ops.dag_event.routes)
        for r, n in by_route.items():
            dag_route_launches[r] += n
        counted = planner_counts(kernels)
        n_disp = qn_sim.sim_stats()["dispatches"]
        check_dag_scenario(scen, name, out, REFERENCE[name], got_launches,
                           n_disp, wall)
        print(f"[dag] {name}: dag_event launches by route {by_route}, "
              f"ops.route named {dict(named)}", flush=True)
        if by_route != {r: named[r] for r in by_route} or \
                by_route["dag_event_general"]:
            fail(f"{name}: dag_event launches by route {by_route}, but "
                 f"ops.route named {dict(named)} (every DAG drive fits "
                 f"dag_event_fast)")
        _, dev_ms, note = profiled_pass(
            kernels, lambda: scen.SCENARIOS[name](dev), counted, name)
        added_wall[f"{name}.profiled"] = note["wall_s"]
        dag_runs[name] = {"wall_s": wall, "dispatches": n_disp,
                          "launches": got_launches,
                          "launches_by_kernel": counted,
                          "launches_by_route": by_route,
                          "profiled_device_ms": dev_ms,
                          "profiled_wall_s": note["wall_s"]}
        print(f"[dag] {name} profiled again: {note['text']}"
              + (f"; host and the rest {wall - sum(dev_ms.values()) / 1e3:.3f}"
                 f" s of the {wall:.3f} s wall (without the profiler)"
                 if None not in dev_ms.values() else ""), flush=True)
    dag_ops.sim_batch = sim_batch

    # [service] the multi-tenant solver service: service_throughput at its
    # full size (solo, service, warm; traced and scraped), serve_many,
    # spark_dag_plan's service half and four Q1 tenants at real size
    t0 = time.perf_counter()
    service_runs = check_service(dev, scen, kernels, launches,
                                 qn_route_launches, dag_route_launches)
    added_wall["service"] = time.perf_counter() - t0

    # [cloud] the private-cloud plane: benchmarks/private_cloud.py at its
    # full size with its day on the over-committed cluster, then the §4.3
    # classes Q1 and Q3 on a cluster of half their public cores in three
    # gaits and in the service
    t0 = time.perf_counter()
    cloud_runs = check_cloud(dev, scen, kernels, launches,
                             qn_route_launches, dag_route_launches)
    added_wall["cloud"] = time.perf_counter() - t0

    # [capacity] the TPU capacity planner: five serving classes in both
    # modes, the training plans, the synthetic record through load_dryrun,
    # replan_capacity and the plan CLI; then launch/qn_record on the card
    phase("capacity")
    t0 = time.perf_counter()
    capacity_run = check_capacity(dev, scen, kernels, launches,
                                  qn_route_launches)
    added_wall["capacity"] = time.perf_counter() - t0

    # --------------------------------------------------------- LM serving
    phase("serving")
    serving = serve_drives(dev, kernels, SERVE_CASES)
    by_path, card_cpu_diff = serving["by_path"], serving["card_vs_cpu"]
    ssd_routes = serving["ssd_routes"]
    for name, n in serving["launches"].items():
        launches[name] += n
    added_wall["serving"] = serving["wall_s"]
    two_buffer = two_buffer_decode(dev, kernels)
    for name, n in two_buffer["prefill_launches"].items():
        launches[name] += n
    by_path["serve.two_buffer"] = two_buffer["prefill_launches"]
    added_wall["serving.two_buffer"] = two_buffer["drive_s"]

    # the serving analogue of Table 3: tau from profiled BatchingEngine
    # rounds against the engine's closed-loop T, at granite-3-2b's smoke
    # config (the reference's) and at its full width and depth; tau from
    # the reference's fixed round times first, which must equal its tau
    ref_sq = REFERENCE["serving_qn"]
    reset_launches(*wrappers)
    taus = [scen.serving_tau(solo, n_requests=ref_sq["n_requests"],
                             slots=ref_sq["slots"], device=dev)
            for solo in ref_sq["solo_ms"]]
    print(f"[serving-qn] tau at the fixed round times {ref_sq['solo_ms']} "
          f"ms: port {taus}, reference {ref_sq['tau_ms']}", flush=True)
    if taus != ref_sq["tau_ms"]:
        fail(f"serving tau {taus} differs from the reference's "
             f"{ref_sq['tau_ms']}")
    for k, n in ((k, w.launches) for k, w in kernels.items()):
        launches[k] += n
    for r, n in qn_ops.qn_event.routes.items():
        qn_route_launches[r] += n
    serving_qn = {}
    for label, smoke in (("smoke", True), ("full", False)):
        reset_launches(*wrappers)
        t0 = time.perf_counter()
        sq = scen.serving_qn(dev, smoke=smoke)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        added_wall[f"serving_qn.{label}"] = wall
        got_launches = {k: w.launches for k, w in kernels.items()}
        for k, n in got_launches.items():
            launches[k] += n
        for r, n in qn_ops.qn_event.routes.items():
            qn_route_launches[r] += n
        by_path[f"serving_qn.{label}"] = {k: n for k, n in
                                          got_launches.items() if n}
        serving_qn[label] = {**sq, "wall_s": wall,
                             "launches": got_launches}
        check_serving_qn(scen, label, sq, got_launches, wall)
        torch.cuda.empty_cache()
    print(f"[scenarios] wall of the added phases: "
          f"{json.dumps({k: round(v, 3) for k, v in added_wall.items()})}, "
          f"{sum(added_wall.values()):.3f} s in all", flush=True)

    # ---------------------------------------------------------------- times
    phase("time")
    # qn_event at every dispatch shape of the Q1 run() above: lanes of
    # m4.xlarge candidates up to the shape's max_slots, 2 replications.
    # Each shape is held against the plain version with the depth cut to
    # E_cut events, deep enough that every lane completes jobs past the
    # main path's 8 warm-up jobs (a Q1 job is ~1000 events: 500 maps
    # dispatched and completed); the commonest one is also timed at full
    # depth.
    cls = prob.classes[0]
    vm = prob.vm_types[0]
    prof = cls.profile_for(vm)
    m_s, r_s = samples[(cls.name, vm.name)]
    E_cut = 16384

    def main_lanes(Bm, E_main, S_main, H_main):
        nu_top = max(1, S_main // vm.slots)
        caps = [max(1, nu_top - k // 2) * vm.slots for k in range(Bm)]
        lane_args = (i32([prof.n_map] * Bm), i32([prof.n_reduce] * Bm),
                     i32(caps), i32([E_main] * Bm), f32([0.0] * Bm),
                     f32([0.0] * Bm), f32([cls.think_ms] * Bm))
        seeds_m = torch.tensor(1000 * (np.arange(Bm) % 2),
                               dtype=torch.int64, device=dev)
        streams_kw = dict(h_users=H_main, n_events=E_main,
                          m_samples=f32(m_s), r_samples=f32(r_s))
        make = lambda: qn_ops.event_streams(lane_args[6], seeds_m,
                                            lane_args[3], **streams_kw)
        make.plain = lambda: qn_ref.event_streams(lane_args[6], seeds_m,
                                                  lane_args[3], **streams_kw)
        make.seeds_nea = (seeds_m, lane_args[3])
        make.samples = (streams_kw["m_samples"], streams_kw["r_samples"])
        return lane_args, make

    # the point-wise walk's single-lane shapes too (B=1, one per bucket of
    # slots it probed); the shapes with the same events and users share
    # one plain run (plain_in_one_run: ~43 s at the cut, not one a shape)
    shapes = [s for s, _ in shape_count.most_common()] + \
        [s for s, _ in pw_shape_count.most_common()]
    runs = []
    for Bm, E_main, S_main, H_main in shapes:
        lane_args, make = main_lanes(Bm, E_main, S_main, H_main)
        tables = check_streams(lane_args[6], *make.seeds_nea, H_main, E_main,
                               make.samples, f"B={Bm} E={E_main} H={H_main}")
        cut = (*lane_args[:3], i32([E_cut] * Bm), *lane_args[4:], tables[0],
               *(t[:, :E_cut].contiguous() for t in tables[1:]))
        cut_kw = dict(max_slots=S_main, warmup_jobs=8, replay=True)
        ks, kc = qn_ops.qn_event(*cut, **cut_kw)
        gs, gc = qn_ops.qn_event(*cut, general=True, **cut_kw)
        cut_ms = cuda_ms(lambda: qn_ops.qn_event(*cut, **cut_kw), 3)
        runs.append(((Bm, E_main, S_main, H_main), cut, (ks, kc, gs, gc),
                     cut_ms))
    checked = {}
    for E_main, H_main in dict.fromkeys((sh[1], sh[3]) for sh in shapes):
        group = [r for r in runs if (r[0][1], r[0][3]) == (E_main, H_main)]
        plain, plain_ms, plain_shape = plain_in_one_run(
            qn_ref, [(r[1], r[0][2]) for r in group], 8, True)
        for ((Bm, _, S_main, _), _, (ks, kc, gs, gc), cut_ms), (ps, pc) in \
                zip(group, plain):
            if not (torch.equal(ks, ps) and torch.equal(kc, pc)
                    and torch.equal(gs, ps) and torch.equal(gc, pc)):
                fail(f"qn_event differs from its plain version at the main "
                     f"path's widths B={Bm} S={S_main} H={H_main}")
            if float(kc.min()) <= 0:
                fail(f"qn_event at the main path's widths B={Bm} S={S_main} "
                     f"E={E_cut} left a lane without jobs past the warm-up")
            qn_err = max(qn_err, float((ks - ps).abs().max()),
                         float((kc - pc).abs().max()),
                         float((gs - ps).abs().max()),
                         float((gc - pc).abs().max()))
            checked[(Bm, E_main, S_main, H_main)] = (plain_ms, cut_ms,
                                                     plain_shape)
            n_disp = (shape_count + pw_shape_count)[(Bm, E_main, S_main,
                                                     H_main)]
            print(f"[check] qn_event at the main path's widths B={Bm} "
                  f"S={S_main} H={H_main}, E={E_cut} ({n_disp} of the "
                  f"drives' dispatches): bit-identical=True (qn_event_general "
                  f"too), jobs a lane {int(kc.min())}-{int(kc.max())}; kernel "
                  f"{cut_ms:.3f} ms, plain {plain_ms:.1f} ms (one run of the "
                  f"{len(group)} shapes' lanes, {plain_shape}); event_streams "
                  f"at E={E_main}: bit-identical=True", flush=True)

    (Bm, E_main, S_main, H_main), n_shape = shape_count.most_common(1)[0]
    lane_args, make = main_lanes(Bm, E_main, S_main, H_main)
    tables = make()
    streams_ms = cuda_ms(make, 20)
    streams_plain_ms = cuda_ms(make.plain, 2)
    run_qn = lambda: qn_ops.qn_event(*lane_args, *tables, max_slots=S_main,
                                     warmup_jobs=8, replay=True)
    qn_ms = cuda_ms(run_qn, 3)
    # the kernel for any H and slot count, asked for at the same shape
    qn_general_ms = cuda_ms(lambda: qn_ops.qn_event(
        *lane_args, *tables, max_slots=S_main, warmup_jobs=8, replay=True,
        general=True), 3)
    _, cnt = run_qn()
    if not bool((cnt > 0).all()):
        fail("qn_event at the main path's shape left a lane without jobs")
    qn_plain_ms, qn_cut_ms, qn_plain_shape = checked[(Bm, E_main, S_main,
                                                      H_main)]
    # bound: each table and parameter read once, each output written once;
    # per active event the least work the function needs: a log2(S)
    # selection among the slots for each of the two slot choices (first
    # free, earliest end, as from a heap) and 4*H user compares (reduce
    # key, map key, think end, pending), one instruction each
    active = int(lane_args[3].sum())
    qn_bound, qn_bytes, qn_ops_n = qn_lane_bound(Bm, E_main, H_main, S_main,
                                                 active)
    # the draw tables' bound: the tables written (and the per-lane inputs
    # read) at the card's memory rate, or their threefry work on the
    # integer pipe at the card's INT32 rate, whichever is larger
    streams_bytes = 4 * (Bm * H_main + 3 * Bm * E_main) + 16 * Bm \
        + 4 * sum(len(x) for x in make.samples)
    streams_ops = THREEFRY_INT32_OPS * (THREEFRY_PER_EVENT[True] * Bm
                                        * E_main + Bm * H_main + Bm)
    streams_bound = 1e3 * max(streams_bytes / H100_BYTES_PER_S,
                              streams_ops / H100_INT32_OPS_PER_S)
    print(f"[time] qn_event B={Bm} E={E_main} S={S_main} H={H_main} "
          f"({n_shape} of the run's dispatches had this shape): "
          f"{qn_ms:.3f} ms/launch, {qn_ms * 1e6 / E_main:.1f} ns an event "
          f"(before: {QN_BEFORE['qn_event_b32_ms']} ms; "
          f"{active / qn_ms * 1e3:.3e} lane-events/s); qn_event_general "
          f"at this shape {qn_general_ms:.3f} ms; bound "
          f"{qn_bound:.4f} ms ({qn_bytes} bytes, {qn_ops_n} operations); "
          f"at E={E_cut}: kernel {qn_cut_ms:.3f} ms, plain "
          f"{qn_plain_ms:.1f} ms ({qn_plain_shape})", flush=True)
    print(f"[time] event_streams B={Bm} E={E_main} H={H_main} (replay): "
          f"kernel {streams_ms:.4f} ms (before, eager: "
          f"{QN_BEFORE['event_streams_b32_ms']} ms), plain {streams_plain_ms:.3f}"
          f" ms, bound {streams_bound:.4f} ms ({streams_bytes} bytes, "
          f"{streams_ops} integer-pipe instructions)", flush=True)
    # the kernel for any H and slot count where it alone runs: H = 2049
    # (shared memory) and H = 12000 (global scratch), the checks' lanes
    general_ms = {}
    for H_g, E_g, lanes_g, tables_g in (
            (H_big, E_big, lanes_big, tables_big),
            (H_huge, E_huge, lanes_huge, tables_huge)):
        general_ms[H_g] = cuda_ms(lambda: qn_ops.qn_event(
            *lanes_g, *tables_g, max_slots=64, warmup_jobs=2,
            replay=True), 3)
        print(f"[time] qn_event_general B=2 E={E_g} S=64 H={H_g}: "
              f"{general_ms[H_g]:.3f} ms/launch, "
              f"{general_ms[H_g] * 1e6 / E_g:.1f} ns an event", flush=True)

    # the launch floor: an empty kernel queued back to back (its device
    # time a launch), and its call from Python (build.launch and ctypes)
    lib = build.library()
    run_floor = lambda: build.check(build.launch(dev, lib.launch_floor_launch),
                                    "launch_floor")
    floor_ms = queued_ms(run_floor, 50)
    floor_call_ms = enqueue_ms(run_floor, 200)
    print(f"[time] launch floor (an empty kernel, one warp): {floor_ms:.5f} "
          f"ms queued back to back, {floor_call_ms:.5f} ms a call on the "
          f"host", flush=True)

    # amva at the frontier of run_fast: span 64 -> 97 points, through the
    # frontier entry (the main path's: the scalars by value) and through
    # ps_fixed_point on the same points (tensors)
    n_am = 97
    nus_am = np.arange(20, 20 + n_am)
    a_am = f32(2.0e6 / (nus_am * 8))
    am_args = (a_am, f32([9000.0] * n_am), f32([10000.0] * n_am),
               f32([10.0] * n_am))
    run_am = lambda: amva_ops.ps_frontier(2.0e6, 8, 20, n_am, 9000.0,
                                          10000.0, 10.0, device=dev)
    run_am_t = lambda: amva_ops.ps_fixed_point(*am_args)
    if not torch.equal(run_am(), run_am_t()):
        fail("the amva frontier entry differs from ps_fixed_point at N=97")
    am_ms = cuda_ms(run_am, 50)
    am_tensors_ms = cuda_ms(run_am_t, 50)
    am_call_ms = enqueue_ms(run_am, 200)
    am_tensors_call_ms = enqueue_ms(run_am_t, 200)
    am_plain_ms = cuda_ms(lambda: amva_ref.ps_fixed_point(*am_args), 5)
    am_bytes = 4 * n_am               # the frontier reads no tensor
    am_ops_n = n_am * 40 * 6       # mul, add, div, max, fma (2) per round
    am_bound = 1e3 * max(am_bytes / H100_BYTES_PER_S,
                         am_ops_n / H100_FP32_OPS_PER_S)
    # the kernels' own device times, apart from the wrappers' host time,
    # and the two launches' share of a run_fast plan's wall
    am_dev_ms, _ = device_ms(run_am, "amva_ps_frontier_kernel", 100)
    am_tensors_dev_ms, _ = device_ms(run_am_t, "amva_ps_kernel", 100)
    am_queued_ms = queued_ms(run_am)
    am_tensors_queued_ms = queued_ms(run_am_t)
    # amva_frontier as the planner calls it (the entry and its read-back;
    # host clock), and the same frontier built as before the frontier
    # entry: four float32 tensors on the host, four copies, ps_fixed_point
    # and the read-back; in turns
    a_fr, b_fr = mva.workload_demand(cls.profile_for(vm))

    def frontier_by_copies():
        nus = np.arange(20, 20 + n_am)
        full = lambda v: torch.full((n_am,), v, dtype=torch.float32)
        args = [x.to(dev) for x in (
            torch.as_tensor(a_fr / (nus * vm.slots), dtype=torch.float32),
            full(b_fr), full(cls.think_ms), full(float(cls.h_users)))]
        return amva_ops.ps_fixed_point(*args).cpu().numpy()

    from repro_torch.core import evaluators
    frontier = lambda: evaluators.amva_frontier(cls, vm, 20, 19 + n_am,
                                                device=dev)
    if not np.array_equal(frontier(), frontier_by_copies()):
        fail("amva_frontier differs from the same frontier built by copies")
    fr_turns = [enqueue_ms(fn, 200) for fn in (frontier, frontier_by_copies,
                                               frontier_by_copies, frontier)]
    fast_wall_ms = 1e3 * plans["Q1-10u.run_fast"]["wall_s"]
    am_share = plans["Q1-10u.run_fast"]["amva_launches"] * am_ms \
        / fast_wall_ms
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    print(f"[time] amva N={n_am} frontier entry (amva_ps_frontier_kernel): "
          f"{am_ms:.4f} ms/call (CUDA events), {am_call_ms:.4f} ms on the "
          f"host; the kernel alone {fmt(am_dev_ms)} by the profiler, "
          f"{am_queued_ms:.4f} ms queued back to back; ps_fixed_point "
          f"(amva_ps_kernel, four tensors) {am_tensors_ms:.4f} ms/call, "
          f"{am_tensors_call_ms:.4f} ms on the host, "
          f"{fmt(am_tensors_dev_ms)} by the profiler, "
          f"{am_tensors_queued_ms:.4f} ms queued; plain {am_plain_ms:.3f} "
          f"ms; bound {am_bound:.6f} ms; launch floor {floor_ms:.5f} ms "
          f"queued; {plans['Q1-10u.run_fast']['amva_launches']} launches "
          f"are {100 * am_share:.2f}% of Q1-10u run_fast's "
          f"{fast_wall_ms:.2f} ms wall", flush=True)
    print(f"[time] amva_frontier (Q1-10u, {vm.name}, {n_am} points, with "
          f"its read-back; host clock): the frontier entry "
          f"{(fr_turns[0] + fr_turns[3]) / 2:.4f} ms a call, built by four "
          f"copies and ps_fixed_point {(fr_turns[1] + fr_turns[2]) / 2:.4f}"
          f" ms (in turns: {', '.join(f'{t:.4f}' for t in fr_turns)})",
          flush=True)

    # mva at the reference test's largest size and at the degenerate case
    def time_mva(n, h_users):
        d = f32(np.abs(gen.normal(size=n)) * 10 + 1)
        z = f32(np.full(n, 1e4))
        ms = cuda_ms(lambda: amva_ops.mva_response(d, z, h_users), 200)
        plain_ms = cuda_ms(lambda: amva_ref.mva_response(d, z, h_users), 5)
        # the kernel's own device time, apart from the wrapper's host time
        dev_ms, _ = device_ms(lambda: amva_ops.mva_response(d, z, h_users),
                              "amva_mva_kernel")
        # bytes: d and z read, R written; operations: 1+q, d*(.), r+z, the
        # division and x*r per user per candidate
        nbytes, flops = 12 * n, 5 * h_users * n
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_OPS_PER_S
        bound = 1e3 * max(t_bytes, t_ops)
        print(f"[time] mva N={n} H={h_users}: {ms:.4f} ms/launch (the "
              f"kernel alone on the device: "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}"
              f"), plain {plain_ms:.3f} ms, bound {bound:.3e} ms ({nbytes} "
              f"bytes, {flops} flops)", flush=True)
        return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "operations" if t_ops > t_bytes else "bytes"}

    mva_time = time_mva(4097, 25)
    mva_degenerate = time_mva(1, DEGENERATE["h_users"])
    # one point-wise dispatch: a single lane of the Q1 drive's shape
    S_pw = bucket_slots(REFERENCE["Q1-10u.run_pointwise"]["classes"][
        cls.name]["nu"] * vm.slots)
    lane_pw, make_pw = main_lanes(1, E_main, S_pw, H_main)
    tables_pw = make_pw()
    streams_pw_ms = cuda_ms(make_pw, 20)
    streams_pw_plain_ms = cuda_ms(make_pw.plain, 3)
    qn_pw_ms = cuda_ms(lambda: qn_ops.qn_event(
        *lane_pw, *tables_pw, max_slots=S_pw, warmup_jobs=8, replay=True), 3)
    qn_pw_general_ms = cuda_ms(lambda: qn_ops.qn_event(
        *lane_pw, *tables_pw, max_slots=S_pw, warmup_jobs=8, replay=True,
        general=True), 3)
    pw = plans["Q1-10u.run_pointwise"]
    pw.update(qn_event_ms_b1=qn_pw_ms, event_streams_ms_b1=streams_pw_ms)
    print(f"[time] qn_event B=1 E={E_main} S={S_pw} H={H_main} (a point-wise "
          f"dispatch): {qn_pw_ms:.3f} ms/launch, "
          f"{qn_pw_ms * 1e6 / E_main:.1f} ns an event (before: "
          f"{QN_BEFORE['qn_event_b1_ms']} ms; qn_event_general "
          f"{qn_pw_general_ms:.3f} ms); event_streams kernel "
          f"{streams_pw_ms:.4f} ms (before, eager: "
          f"{QN_BEFORE['event_streams_b1_ms']} ms), plain "
          f"{streams_pw_plain_ms:.3f} ms", flush=True)
    print(f"[time] point-wise plan Q1-10u: wall {pw['wall_s']:.3f} s for "
          f"{pw['qn_dispatches']} dispatches, {pw['ms_per_dispatch']:.2f} ms "
          f"each (before: {QN_BEFORE['run_pointwise_s']} s); batched run(): "
          f"{plans['Q1-10u.run']['wall_s']:.3f} s for "
          f"{plans['Q1-10u.run']['qn_dispatches']} dispatches (before: "
          f"{QN_BEFORE['run_s']} s)", flush=True)

    # amva's and mva's dependent chains on one thread (N = 1): a long
    # launch against a short one, so the launch's own time drops out; the
    # chain bound of a call is its steps times a step's latency (amva: 40
    # rounds of fmul, fadd, __fdiv_rn and fma; mva: H steps)
    one_am = (f32([2.0e6 / 160]), f32([9000.0]), f32([10000.0]), f32([10.0]))
    am_round_ns = chain_ns(
        lambda n: amva_ops.ps_fixed_point(*one_am, iters=n), 40, 40040)
    am_chain_ms = 40 * am_round_ns * 1e-6
    am_fr_round_ns = chain_ns(lambda n: amva_ops.ps_frontier(
        2.0e6, 8, 20, 1, 9000.0, 10000.0, 10.0, device=dev, iters=n),
        40, 40040)
    mva_step_ns = chain_ns(lambda n: amva_ops.mva_response(
        f32([10.0]), f32([1e4]), n), 25, 25025)
    mva_chain_ms = 25 * mva_step_ns * 1e-6
    print(f"[time] amva dependent chain: {am_round_ns:.2f} ns a round on one "
          f"thread ({am_fr_round_ns:.2f} through the frontier entry); 40 "
          f"rounds: chain bound {am_chain_ms:.6f} ms (byte bound "
          f"{am_bound:.2e} ms; launch floor {floor_ms:.5f} ms); the "
          f"frontier kernel alone on the device {fmt(am_dev_ms)}, queued "
          f"{am_queued_ms:.4f} ms: its chain bound is "
          f"{am_chain_ms / am_queued_ms:.2f} of that, and the larger of the "
          f"chain bound and the launch floor "
          f"{max(am_chain_ms, floor_ms) / am_queued_ms:.2f}", flush=True)
    mva_dev = mva_time["device_ms"]
    print(f"[time] mva dependent chain: {mva_step_ns:.2f} ns a step on one "
          f"thread; H=25: chain bound {mva_chain_ms:.6f} ms (byte bound "
          f"{mva_time['bound_ms']:.2e} ms); the kernel alone on the device "
          f"{'not measured' if mva_dev is None else f'{mva_dev:.4f} ms'}",
          flush=True)

    # [dag] the step's collectives alone, each round with the one integer
    # op that feeds the next (csrc/dag_event.cu dag_collective_chain): a
    # 32-bit redux, a ballot with __ffs, a shuffle; from them the least
    # time a step made of dag_event_fast's collectives could take.  A
    # dispatch waits on one redux (the queue's, the advance's and the
    # free ballot go out together) and then the shuffle of its mean;
    # a completion on two reductions (the earliest end, then its lane and
    # user); one that takes the dispatch after it adds two shuffles (the
    # forked user's key, the mean) for that second event.  So an event
    # costs at least a redux and a shuffle.
    chain_out = torch.empty(32, dtype=torch.int32, device=dev)

    def collective(op):
        def launch(n):
            build.check(lib.dag_collective_chain_launch(
                chain_out.data_ptr(), n, op,
                torch.cuda.current_stream(dev).cuda_stream),
                "dag_collective_chain")
        return chain_ns(launch, 1000, 201000)

    redux_ns, ballot_ns, shfl_ns = (collective(op) for op in range(3))
    floor_ns = redux_ns + shfl_ns
    print(f"[time] dag_event step's collectives (one warp, a dependent "
          f"chain, each round with its feeding integer op): "
          f"__reduce_min_sync {redux_ns:.2f} ns, __ballot_sync + __ffs "
          f"{ballot_ns:.2f} ns, __shfl_sync {shfl_ns:.2f} ns a round; "
          f"dag_event_fast's step floor {floor_ns:.2f} ns an event (a "
          f"redux and a shuffle; {1.5 * redux_ns + 0.5 * shfl_ns:.2f} ns "
          f"where no completion takes the dispatch after it)", flush=True)

    # qn_event_wide against qn_event_general at cost_deadline's probe
    # shape past 512 slots (Q1, cap 8000 of 8192 slots, 37725 active
    # events of 65536, replay mode), H = 10 and 20, in turns (wide,
    # general, general, wide).  Bound: the draw tables read once (12 bytes
    # an active step), think0 and the lane's parameters, or per active step
    # the selection work of the B=32 bound above, whichever is larger.
    # Its step's collective floor: a dispatch waits on the queue's redux
    # and the free ballot (issued together, so the longer of the two); a
    # completion (or a think end) on two reductions, the earliest end and
    # then g_who, which needs it; a completion that takes the dispatch
    # after it adds a vote and a shuffle for that second event.  A task is
    # a dispatch and a completion, so a step costs at least half of
    # max(redux, ballot) + 2 redux
    wide_floor_ns = (max(redux_ns, ballot_ns) + 2 * redux_ns) / 2
    wide_time = {}
    cap_w, S_wt, E_wt, act_w = (WIDE_TIME[k] for k in (
        "cap", "max_slots", "n_events", "active"))
    for H_wt in (10, 20):
        lane_wt = (i32([prof.n_map]), i32([prof.n_reduce]), i32([cap_w]),
                   i32([act_w]), f32([0.0]), f32([0.0]), f32([cls.think_ms]))
        tables_wt = qn_ops.event_streams(
            lane_wt[6], torch.tensor([1], dtype=torch.int64, device=dev),
            lane_wt[3], h_users=H_wt, n_events=E_wt, m_samples=f32(m_s),
            r_samples=f32(r_s))
        run_w = lambda g: qn_ops.qn_event(
            *lane_wt, *tables_wt, max_slots=S_wt, warmup_jobs=8,
            replay=True, general=g)
        k0 = dict(qn_ops.qn_event.routes)
        ws, wc = run_w(False)
        took_w = [k for k, n in qn_ops.qn_event.routes.items() if n > k0[k]]
        gs, gc = run_w(True)
        if took_w != ["qn_event_wide"] or not (
                torch.equal(ws, gs) and torch.equal(wc, gc)) \
                or float(wc[0]) <= 0:
            fail(f"qn_event at cost_deadline's shape H={H_wt}: took "
                 f"{took_w}, jobs {wc.tolist()}, the general kernel's bits "
                 f"{'equal' if torch.equal(ws, gs) else 'differ'}")
        turns = [cuda_ms(lambda g=g: run_w(g), 3)
                 for g in (False, True, True, False)]
        w_bytes = 12 * act_w + 4 * H_wt + 4 * 9
        w_ops = act_w * (2 * max(1, (S_wt - 1).bit_length()) + 4 * H_wt)
        t_b, t_o = w_bytes / H100_BYTES_PER_S, w_ops / H100_INSTR_PER_S
        row = {"shape": f"B=1 E={E_wt} ({act_w} active) S={S_wt} "
                        f"cap={cap_w} H={H_wt} replay",
               "ms": (turns[0] + turns[3]) / 2,
               "general_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
               "bound_ms": 1e3 * max(t_b, t_o),
               "bound_by": "operations" if t_o > t_b else "bytes",
               "step_floor_ms": wide_floor_ns * act_w * 1e-6,
               "jobs": float(wc[0])}
        row.update(ns_per_step=row["ms"] * 1e6 / act_w,
                   general_ns_per_step=row["general_ms"] * 1e6 / act_w)
        wide_time[H_wt] = row
        print(f"[time] qn_event {row['shape']} (a cost_deadline probe past "
              f"512 slots): qn_event_wide {row['ms']:.3f} ms/launch, "
              f"{row['ns_per_step']:.1f} ns an active step; "
              f"qn_event_general (asked for) {row['general_ms']:.3f} ms, "
              f"{row['general_ns_per_step']:.1f} ns (in turns: "
              f"{', '.join(f'{t:.3f}' for t in turns)} ms); step floor "
              f"{row['step_floor_ms']:.4f} ms ({wide_floor_ns:.2f} ns a "
              f"step: max(redux, ballot) and two reductions a task); bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {w_bytes} "
              f"bytes, {w_ops} operations); {int(wc[0])} jobs past the "
              f"warm-up", flush=True)

    # qn_event_many against qn_event_general at the capacity planner's
    # widths (MANY_TIME: 64 users in 64 slots, 2048 in 384; one map and one
    # reduce a job) past the planner's 512 events, in turns (many,
    # general, general, many), beside the bound and the step's collective
    # floor (many_floor_ns); then the floor of each planner lane that
    # [capacity] timed
    many_time = {}
    for H_mt, S_mt, think_mt in MANY_TIME:
        lane_mt = (i32([1]), i32([1]), i32([S_mt]), i32([MANY_TIME_E]),
                   f32([40.0]), f32([60.0]), f32([think_mt]))
        tables_mt = qn_ops.event_streams(
            lane_mt[6], torch.tensor([5], dtype=torch.int64, device=dev),
            lane_mt[3], h_users=H_mt, n_events=MANY_TIME_E)
        run_m = lambda g: qn_ops.qn_event(
            *lane_mt, *tables_mt, max_slots=S_mt, warmup_jobs=8,
            replay=False, general=g)
        k0 = dict(qn_ops.qn_event.routes)
        ms_, mc_ = run_m(False)
        took_m = [k for k, n in qn_ops.qn_event.routes.items() if n > k0[k]]
        gs, gc = run_m(True)
        if took_m != ["qn_event_many"] or not (
                torch.equal(ms_, gs) and torch.equal(mc_, gc)) \
                or float(mc_[0]) <= 0:
            fail(f"qn_event at H={H_mt} S={S_mt}: took {took_m}, jobs "
                 f"{mc_.tolist()}, the general kernel's bits "
                 f"{'equal' if torch.equal(ms_, gs) else 'differ'}")
        turns = [cuda_ms(lambda g=g: run_m(g), 5)
                 for g in (False, True, True, False)]
        bound, nbytes, n_ops = many_lane_bound(1, MANY_TIME_E, H_mt, S_mt,
                                               MANY_TIME_E)
        floor_ns = many_floor_ns(redux_ns, ballot_ns, 1, 1)
        row = {"shape": f"B=1 E={MANY_TIME_E} S={S_mt} H={H_mt} think "
                        f"{think_mt} ms exponential",
               "ms": (turns[0] + turns[3]) / 2,
               "general_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
               "bound_ms": bound,
               "bound_by": ("operations" if n_ops / H100_INSTR_PER_S
                            > nbytes / H100_BYTES_PER_S else "bytes"),
               "step_floor_ns": floor_ns,
               "step_floor_ms": floor_ns * MANY_TIME_E * 1e-6,
               "jobs": float(mc_[0])}
        row.update(ns_per_event=row["ms"] * 1e6 / MANY_TIME_E,
                   general_ns_per_event=row["general_ms"] * 1e6
                   / MANY_TIME_E)
        many_time[H_mt] = row
        print(f"[time] qn_event {row['shape']}: qn_event_many "
              f"{row['ms']:.4f} ms/launch, {row['ns_per_event']:.1f} ns an "
              f"event; qn_event_general (asked for) {row['general_ms']:.4f} "
              f"ms, {row['general_ns_per_event']:.1f} ns (in turns: "
              f"{', '.join(f'{t:.4f}' for t in turns)} ms); step floor "
              f"{row['step_floor_ms']:.4f} ms ({floor_ns:.2f} ns a step: "
              f"max(redux, ballot) a step and a second redux a completion "
              f"or think end); bound {bound:.6f} ms ({row['bound_by']}: "
              f"{nbytes} bytes, {n_ops} operations); {int(mc_[0])} jobs "
              f"past the warm-up", flush=True)
    for name, row in capacity_run["lanes"].items():
        row["step_floor_ns"] = many_floor_ns(redux_ns, ballot_ns,
                                             row["n_map"], row["n_reduce"])
        row["step_floor_ms"] = row["step_floor_ns"] * row["n_events"] * 1e-6
        print(f"[time] qn_event_many at {name}'s lane ({row['shape']}): "
              f"{row['ms']:.4f} ms, step floor {row['step_floor_ms']:.4f} "
              f"ms ({row['step_floor_ns']:.2f} ns a step), bound "
              f"{row['bound_ms']:.6f} ms", flush=True)

    # [dag] both routes at dag_sweep's frontier shape (the Spark chain at
    # nu = 1..16 on m4.xlarge: B = 16, E = 8192, K = 4, H = 3, slots up to
    # 128, seed 0, exponential mode; held against the plain version once
    # more) and at the default budget (min_jobs 40, warmup 8: E = 16384)
    spark = scen.SPARK
    nus_f = np.arange(1, 17)
    B_f, K_f, H_f = len(nus_f), len(spark.stages), scen.DAG_SWEEP_USERS
    S_f = bucket_slots(int(nus_f.max()) * 8)
    if dag_ops.route(H_f, S_f, K_f, 16384) != "dag_event_fast":
        fail("dag_sweep's frontier shape does not fit dag_event_fast")
    dag_time = {}
    for E_f, warm in ((8192, 4), (16384, 8)):
        lanes_f = (i32([[st.n_tasks for st in spark.stages]] * B_f),
                   f32([[st.t_avg for st in spark.stages]] * B_f),
                   i32([K_f] * B_f), i32(nus_f * 8), i32([E_f] * B_f),
                   f32([scen.DAG_SWEEP_THINK_MS] * B_f))
        seeds_f = torch.zeros(B_f, dtype=torch.int64, device=dev)
        skw = dict(h_users=H_f, n_events=E_f)
        make_f = lambda: dag_ops.dag_streams(lanes_f[5], seeds_f, lanes_f[4],
                                             **skw)
        tables_f = make_f()
        # the depth given, as core/dag.py gives it: no read on the card
        run_f = lambda: dag_ops.dag_event(*lanes_f, *tables_f, None,
                                          max_slots=S_f, warmup_jobs=warm,
                                          depth=K_f)
        run_g = lambda: dag_ops.dag_event(*lanes_f, *tables_f, None,
                                          max_slots=S_f, warmup_jobs=warm,
                                          general=True, depth=K_f)
        ks, kc = run_f()
        gs, gc = run_g()
        if float(kc.min()) <= 0:
            fail(f"dag_event at the frontier shape E={E_f} left a lane "
                 f"without jobs past the warm-up")
        if not (torch.equal(ks, gs) and torch.equal(kc, gc)):
            fail(f"dag_event's two routes differ at the frontier shape "
                 f"E={E_f}")
        # the routes in turns (fast, general, general, fast); the tables'
        # call is mostly the wrapper's host work: queued back to back
        # behind a spin, the launches give the kernel's own time
        turns = [cuda_ms(fn, 3) for fn in (run_f, run_g, run_g, run_f)]
        row = {"shape": f"B={B_f} E={E_f} K={K_f} S={S_f} H={H_f} "
                        f"exponential",
               "ms": (turns[0] + turns[3]) / 2,
               "general_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
               "streams_ms": cuda_ms(make_f, 20),
               "streams_call_ms": enqueue_ms(make_f, 200),
               "streams_queued_ms": queued_ms(make_f),
               "streams_device_ms": device_ms(make_f, "dag_streams_kernel",
                                              100)[0],
               "launch_floor_ms": floor_ms}
        # the fused simulation as core/dag.py calls it: one entry point
        # for both kernels (sim_batch), against the two wrappers called in
        # turn, in turns; the host's cost of a call (enqueue) beside the
        # time to its end (CUDA events, bound by the event loop)
        run_sim = lambda: dag_ops.sim_batch(
            lanes_f[0], lanes_f[1], lanes_f[2], lanes_f[5], lanes_f[3],
            seeds_f, lanes_f[4], None, h_users=H_f, max_slots=S_f,
            n_events=E_f, warmup_jobs=warm, depth=K_f)
        run_two = lambda: dag_ops.dag_event(*lanes_f, *make_f(), None,
                                            max_slots=S_f, warmup_jobs=warm,
                                            depth=K_f)
        mean_s, cnt_s = run_sim()
        if not (torch.equal(cnt_s, kc)
                and torch.equal(mean_s, ks / torch.clamp(kc, min=1.0))):
            fail(f"sim_batch differs from dag_streams then dag_event at "
                 f"the frontier shape E={E_f}")
        sim_turns = [enqueue_ms(fn, 20) for fn in (run_sim, run_two,
                                                   run_two, run_sim)]
        row.update(sim_call_ms=(sim_turns[0] + sim_turns[3]) / 2,
                   two_calls_ms=(sim_turns[1] + sim_turns[2]) / 2,
                   sim_turns_ms=sim_turns, sim_ms=cuda_ms(run_sim, 3))
        if E_f == 8192:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ps, pc = dag_ref.dag_event(*lanes_f, *tables_f, None,
                                       max_slots=S_f, warmup_jobs=warm)
            torch.cuda.synchronize()
            row["plain_ms"] = (time.perf_counter() - t0) * 1e3
            want_f = dag_ref.dag_streams(lanes_f[5], seeds_f, lanes_f[4],
                                         **skw)
            if not (torch.equal(ks, ps) and torch.equal(kc, pc) and all(
                    torch.equal(a, b) for a, b in zip(tables_f, want_f))):
                fail("dag_event or dag_streams differs from its plain "
                     "version at dag_sweep's frontier shape")
            dag_checked.append(row["shape"] + " (both routes)")
            row["streams_plain_ms"] = cuda_ms(
                lambda: dag_ref.dag_streams(lanes_f[5], seeds_f, lanes_f[4],
                                            **skw), 2)
        # bound: each table, stage array and parameter read once, each
        # output written once; per event the least work the function needs:
        # a log2(S) selection among the slots for each of the two slot
        # choices (first free, earliest end) and 4*H user compares (the
        # queue key's stage and arrival, the think end, pending), one
        # instruction each
        active = B_f * E_f
        nbytes = 4 * (2 * B_f * E_f + B_f * H_f + 2 * B_f * K_f + 4 * B_f
                      + 2 * B_f)
        n_ops = active * (2 * max(1, (S_f - 1).bit_length()) + 4 * H_f)
        t_b, t_o = nbytes / H100_BYTES_PER_S, n_ops / H100_INSTR_PER_S
        row.update(bound_ms=1e3 * max(t_b, t_o),
                   bound_by="operations" if t_o > t_b else "bytes",
                   ns_per_event=row["ms"] * 1e6 / E_f,
                   general_ns_per_event=row["general_ms"] * 1e6 / E_f,
                   step_floor_ms=floor_ns * E_f * 1e-6)
        # the tables' bound: written once at the memory rate, or their
        # threefry work on the integer pipe
        s_bytes = 4 * (B_f * H_f + 2 * B_f * E_f) + 16 * B_f
        s_ops = THREEFRY_INT32_OPS * (DAG_THREEFRY_PER_EVENT[False] * B_f
                                      * E_f + 2 * B_f + B_f * H_f)
        t_b, t_o = s_bytes / H100_BYTES_PER_S, s_ops / H100_INT32_OPS_PER_S
        row.update(streams_bound_ms=1e3 * max(t_b, t_o),
                   streams_bound_by="operations" if t_o > t_b else "bytes")
        dag_time[E_f] = row
        print(f"[time] dag_event {row['shape']}: dag_event_fast "
              f"{row['ms']:.3f} ms/launch, {row['ns_per_event']:.1f} ns an "
              f"event; dag_event_kernel (the general route, asked for) "
              f"{row['general_ms']:.3f} ms, {row['general_ns_per_event']:.1f}"
              f" ns an event (in turns: {', '.join(f'{t:.3f}' for t in turns)}"
              f" ms); step floor {row['step_floor_ms']:.4f} ms "
              f"({floor_ns:.2f} ns an event); bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}: {nbytes} bytes, {n_ops} operations)"
              + (f", plain {row['plain_ms']:.1f} ms" if "plain_ms" in row
                 else "") + f"; dag_streams {row['streams_ms']:.4f} ms a "
              f"call (CUDA events), {row['streams_call_ms']:.4f} ms on the "
              f"host, {row['streams_queued_ms']:.4f} ms queued back to "
              f"back, {fmt(row['streams_device_ms'])} by the profiler, "
              f"bound {row['streams_bound_ms']:.4f} ms ({s_ops} "
              f"integer-pipe instructions), launch floor {floor_ms:.5f} ms "
              f"queued"
              + (f", plain {row['streams_plain_ms']:.3f} ms"
                 if "streams_plain_ms" in row else "")
              + f"; sim_batch (one entry point) {row['sim_call_ms']:.4f} ms "
              f"a call on the host, dag_streams then dag_event "
              f"{row['two_calls_ms']:.4f} ms (in turns: "
              f"{', '.join(f'{t:.4f}' for t in row['sim_turns_ms'])} ms), "
              f"sim_batch to its end {row['sim_ms']:.3f} ms", flush=True)
    dag_per_drive = {k: v["launches_by_route"] for k, v in dag_runs.items()}
    print(f"[time] dag_event launches per drive, by route: {dag_per_drive} "
          f"(one dag_streams launch each)", flush=True)

    fa_time = time_flash(dev, fa_ops, fa_ref, 4, 1024, 32, 8, 64)
    fa_f32_time = time_flash_f32(dev, fa_ops, fa_ref, *FA_F32_TIME)
    fa_zamba2 = time_flash(dev, fa_ops, fa_ref, 4, 896, 32, 32, 112)
    fa_more = {f"at_{name}": {"shape": f"B={a[0]} S={a[1]} H={a[2]} "
                                       f"KV={a[3]} Dh={a[4]} bf16 "
                                       f"{'causal' if a[5] else 'non-causal'}",
                              **time_flash(dev, fa_ops, fa_ref, *a)}
               for name, a in FLASH_TIMES.items()}
    ssd_time = time_ssd(dev, ssd_ops, ssd_ref)
    ssd_f32_time = time_ssd_f32(dev, ssd_ops, ssd_ref, *SSD_F32_TIME)
    fa_wide_time = time_flash_f32_wide(dev, fa_ops, *FA_F32_WIDE_TIME)

    # -------------------------------------------------------------- [train]
    # the flash and SSD backwards against their plain versions, then
    # granite-3-2b and mamba2-780m trained at full width and depth (the
    # launch counts set to 0 just before each drive), then the card against
    # the CPU at a cut depth (granite and mamba2 2, zamba2 3) and a restart
    # (granite)
    phase("train")
    t0 = time.perf_counter()
    fa_bwd_err, fa_bwd_err_f32, fa_bwd_share = check_flash_bwd(dev, fa_ops,
                                                               fa_ref)
    fa_bwd_rows, fa_bwd_function = time_flash_bwd(dev, fa_ops, fa_ref)
    ssd_bwd_err = check_ssd_bwd(dev, ssd_ops, ssd_ref)
    ssd_bwd_time = time_ssd_bwd(dev, ssd_ops, ssd_ref)
    print(f"[train] the backward kernels' checks and times: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    train = {}
    for arch in TRAIN_ARCHS:
        train[arch] = train_full(dev, kernels, fa_ops, arch)
        for k, n in train[arch]["launches"].items():
            if k in launches:
                launches[k] += n
        by_path[f"train.{arch}"] = train[arch]["launches"]
    train_cut = {arch: train_small(dev, arch) for arch in TRAIN_SMALL}
    train_f32_runs = {arch: train_f32(dev, kernels, fa_ops, ssd_ops, arch)
                      for arch in TRAIN_F32_ARCHS}
    train_f32_run = train_f32_runs["granite-3-2b"]
    for arch, run in train_f32_runs.items():
        for k, n in run["launches"].items():
            if k in launches:
                launches[k] += n
        by_path[f"train.float32.{arch}"] = run["launches"]
    train_s = time.perf_counter() - t0
    print(f"[train] wall of the phase {train_s:.1f} s", flush=True)

    # --------------------------------------------------------- [distributed]
    # GPipe over granite-3-2b's 40 layers, DiLoCo over mamba2-780m's pods,
    # each at full width and depth, the launch counts set to 0 just before
    # each drive
    phase("distributed")
    pipeline_run = pipeline_drive(dev, kernels)
    diloco_run = diloco_drive(dev, kernels)
    for run, path in ((pipeline_run, "distributed.pipeline"),
                      (diloco_run, "distributed.diloco")):
        for k, n in run["launches"].items():
            launches[k] += n
        by_path[path] = run["launches"]
    path_launches = lambda k: {a: n[k] for a, n in by_path.items() if k in n}
    train_launch = lambda name: sum(t["launches"].get(name, 0) for t in (
        *train.values(), *train_f32_runs.values()))
    ssd_route_launch = lambda r: sum(t["ssd_bwd_routes"][r] for t in (
        *train.values(), train_f32_runs["mamba2-780m"], diloco_run))
    phase("record")

    many_lane = capacity_run["lanes"]["chat-granite"]
    record = {"kernels": [
        {"name": "qn_event", "route": "cuda",
         "source": "src/repro_torch/csrc/qn_event.cu",
         "replaces": "src/repro/kernels/qn_event/kernel.py:255",
         "launches": launches["qn_event"], "max_abs_err": qn_err,
         "ms": qn_ms, "plain_ms": qn_plain_ms,
         "plain_shape": qn_plain_shape,
         "plain_note": "one plain run of the lanes of every main-path "
                       "dispatch shape at the widest shape's slots",
         "ms_at_plain_shape": qn_cut_ms,
         "bound_ms": qn_bound,
         "bound_by": ("operations" if qn_ops_n / H100_INSTR_PER_S
                      > qn_bytes / H100_BYTES_PER_S else "bytes"),
         "library_ms": None,
         "library_note": "no single PyTorch call simulates the network",
         "ns_per_event": qn_ms * 1e6 / E_main,
         "general_ms": qn_general_ms,
         "kernels": {"qn_event_fast": "at most 32 users, 512 slots",
                     "qn_event_wide": "at most 32 users, 513-16384 slots",
                     "qn_event_many": "33-2048 users, at most 16384 "
                                      "slots, fewer than 2**20 events",
                     "qn_event_general": "any lane"},
         "launches_by_route": qn_route_launches,
         "wide_checked": wide_checked,
         "wide_at_cost_deadline_shape": {f"H={H}": row for H, row in
                                         wide_time.items()},
         "at_b1": {"shape": f"B=1 E={E_main} S={S_pw} H={H_main}",
                   "ms": qn_pw_ms, "ns_per_event": qn_pw_ms * 1e6 / E_main,
                   "general_ms": qn_pw_general_ms},
         "general_only": {f"B=2 E={E_g} S=64 H={H_g}": general_ms[H_g]
                          for H_g, E_g in ((H_big, E_big),
                                           (H_huge, E_huge))},
         "plans": plans, "scenarios": scenario_runs,
         "service": service_runs, "cloud": cloud_runs,
         "capacity": capacity_run,
         "many_at_capacity_lanes": capacity_run["lanes"],
         "table3_rows": table3_rows,
         "serving_qn": {k: {f: v[f] for f in
                            ("arch", "n_layers", "solo_latency_ms",
                             "qn_tau_ms", "engine_T_ms", "theta_pct",
                             "wall_s", "launches")}
                        for k, v in serving_qn.items()}},
        {"name": "qn_event_many", "route": "cuda",
         "source": "src/repro_torch/csrc/qn_event.cu",
         "replaces": "src/repro/kernels/qn_event/kernel.py:255",
         "kernel": "qn_event_many<G, UG, REPLAY>",
         "wrapper": "ops.qn_event, the route plan() picks for 33-2048 "
                    "users (qn_event.routes['qn_event_many'])",
         "launches": qn_route_launches["qn_event_many"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in capacity_run["lanes"].values()),
         **{k: many_lane[k] for k in (
             "ms", "shape", "ns_per_event", "general_ms", "general_uncut_ms",
             "bound_ms", "bound_by", "step_floor_ms")},
         "plain_ms": many_lane["plain_uncut_ms"],
         "plain_note": "chat-granite's lane; the plain version on the "
                       "uncut lane (632 slots in 768), the same bits",
         "library_ms": None,
         "library_note": "no PyTorch call simulates the network",
         "at_capacity_lanes": capacity_run["lanes"],
         "at_depth": {f"H={H}": row for H, row in many_time.items()}},
        {"name": "event_streams", "route": "cuda",
         "source": "src/repro_torch/csrc/qn_streams.cu",
         "replaces": "src/repro/kernels/qn_event/kernel.py:63",
         "replaces_note": "the reference's draw tables (event_streams), "
                          "computed by XLA: no Pallas kernel",
         "launches": launches["event_streams"],
         "max_abs_err": streams_err[0],
         "checked": streams_checked,
         "ms": streams_ms, "plain_ms": streams_plain_ms,
         "shape": f"B={Bm} E={E_main} H={H_main} replay",
         "bound_ms": streams_bound,
         "bound_by": ("operations" if streams_ops / H100_INT32_OPS_PER_S
                      > streams_bytes / H100_BYTES_PER_S else "bytes"),
         "library_ms": None,
         "library_note": "no PyTorch call draws jax.random's threefry "
                         "streams",
         "at_b1": {"ms": streams_pw_ms, "plain_ms": streams_pw_plain_ms}},
        {"name": "dag_event", "route": "cuda",
         "source": "src/repro_torch/csrc/dag_event.cu",
         "replaces": "src/repro/core/dag.py:74",
         "replaces_note": "the reference's _dag_sim, a lax.scan that XLA "
                          "compiles into a device loop: no Pallas kernel",
         "kernels": {"dag_event_fast": "at most 32 users, 512 slots, 31 "
                                       "stages, 2**22 - 1 events",
                     "dag_event_general": "dag_event_kernel, any lane"},
         "launches": launches["dag_event"],
         "launches_by_route": dag_route_launches,
         "max_abs_err": dag_err, "checked": dag_checked,
         "ms": dag_time[8192]["ms"], "plain_ms": dag_time[8192]["plain_ms"],
         "shape": dag_time[8192]["shape"],
         "ns_per_event": dag_time[8192]["ns_per_event"],
         "bound_ms": dag_time[8192]["bound_ms"],
         "bound_by": dag_time[8192]["bound_by"],
         "step_floor_ms": dag_time[8192]["step_floor_ms"],
         "step_collectives_ns": {"reduce_min": redux_ns,
                                 "ballot_ffs": ballot_ns, "shfl": shfl_ns,
                                 "floor_per_event": floor_ns},
         "library_ms": None,
         "library_note": "no PyTorch call simulates the network",
         "routes": {r: {f"E={E}": {"ms": row[f"{key}ms"],
                                   "ns_per_event":
                                       row[f"{key}ns_per_event"]}
                        for E, row in dag_time.items()}
                    for r, key in (("dag_event_fast", ""),
                                   ("dag_event_general", "general_"))},
         "at_default_budget": {k: dag_time[16384][k] for k in
                               ("shape", "ms", "ns_per_event", "general_ms",
                                "general_ns_per_event", "bound_ms",
                                "bound_by", "step_floor_ms")},
         "launches_per_drive": dag_per_drive, "drives": dag_runs},
        {"name": "dag_streams", "route": "cuda",
         "source": "src/repro_torch/csrc/dag_streams.cu",
         "replaces": "src/repro/core/dag.py:91",
         "replaces_note": "the draw tables _dag_sim computes before its "
                          "scan, by XLA: no Pallas kernel",
         "launches": launches["dag_streams"],
         "max_abs_err": dag_streams_err,
         "ms": dag_time[8192]["streams_ms"],
         "call_ms": dag_time[8192]["streams_call_ms"],
         "queued_ms": dag_time[8192]["streams_queued_ms"],
         "device_ms": dag_time[8192]["streams_device_ms"],
         "launch_floor_ms": floor_ms,
         "threefries_per_event": {"exponential": DAG_THREEFRY_PER_EVENT[False],
                                  "replay": DAG_THREEFRY_PER_EVENT[True]},
         "sim_batch": {k: dag_time[8192][k] for k in (
             "sim_call_ms", "two_calls_ms", "sim_turns_ms", "sim_ms")},
         "plain_ms": dag_time[8192]["streams_plain_ms"],
         "shape": dag_time[8192]["shape"],
         "bound_ms": dag_time[8192]["streams_bound_ms"],
         "bound_by": dag_time[8192]["streams_bound_by"],
         "library_ms": None,
         "library_note": "no PyTorch call draws jax.random's threefry "
                         "streams",
         "at_default_budget": {
             "ms": dag_time[16384]["streams_ms"],
             "call_ms": dag_time[16384]["streams_call_ms"],
             "queued_ms": dag_time[16384]["streams_queued_ms"],
             "device_ms": dag_time[16384]["streams_device_ms"],
             "bound_ms": dag_time[16384]["streams_bound_ms"]}},
        {"name": "amva", "route": "cuda",
         "source": "src/repro_torch/csrc/amva.cu",
         "replaces": "src/repro/kernels/amva/kernel.py:94",
         "kernels": {"amva_ps_frontier_kernel": "ps_frontier, the main "
                                                "path's: the scalars by value",
                     "amva_ps_kernel": "ps_fixed_point: four (N,) tensors"},
         "launches": launches["amva"],
         "launches_by_entry": {"ps_frontier": launches["amva"],
                               "ps_fixed_point": launches["amva_tensors"]},
         "max_abs_err": amva_err, "shape": f"N={n_am}",
         "ms": am_ms, "call_ms": am_call_ms, "device_ms": am_dev_ms,
         "queued_ms": am_queued_ms, "plain_ms": am_plain_ms,
         "launch_floor_ms": floor_ms,
         "ps_fixed_point": {"ms": am_tensors_ms,
                            "call_ms": am_tensors_call_ms,
                            "device_ms": am_tensors_dev_ms,
                            "queued_ms": am_tensors_queued_ms},
         "amva_frontier_host_ms": {"frontier_entry": (fr_turns[0]
                                                      + fr_turns[3]) / 2,
                                   "four_copies": (fr_turns[1]
                                                   + fr_turns[2]) / 2,
                                   "turns": fr_turns},
         "share_of_run_fast_wall": am_share,
         "chain_ns_per_round": am_round_ns,
         "chain_ns_per_round_frontier": am_fr_round_ns,
         "chain_bound_ms": am_chain_ms,
         "bound_ms": am_bound,
         "bound_by": ("operations" if am_ops_n / H100_FP32_OPS_PER_S
                      > am_bytes / H100_BYTES_PER_S else "bytes"),
         "library_ms": None,
         "library_note": "no single PyTorch call iterates the fixed point"},
        {"name": "mva", "route": "cuda",
         "source": "src/repro_torch/csrc/amva.cu",
         "replaces": "src/repro/kernels/amva/kernel.py:103",
         "launches": launches["mva"], "max_abs_err": mva_err,
         **mva_time, "shape": "N=4097 H=25",
         "chain_ns_per_step": mva_step_ns, "chain_bound_ms_h25": mva_chain_ms,
         "library_ms": None,
         "library_note": "no PyTorch call runs the MVA recursion",
         "at_degenerate_case": {"shape": "N=1 H=5", **mva_degenerate}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
         "kernels": {"bfloat16": "fa_wgmma_kernel",
                     "float32 at Dh <= 128": "fa_fwd_split_kernel, then "
                                             "fa_fwd_parts_kernel (entries "
                                             "fa_fwd_split, fa_fwd_parts)",
                     "float32 past Dh 128": "fa_f32_kernel (entry "
                                            "flash_attention_simt)"},
         "launches": launches["flash_attention"],
         "launches_note": "forwards on any route; every drive but the "
                          "float32 step runs bf16 (fa_wgmma_kernel)",
         "launches_by_kernel_in_the_float32_step":
             train_f32_run["forward_routes"],
         "max_abs_err": fa_checked["all"],
         "max_abs_err_by_kernel": {k: v for k, v in fa_checked.items()
                                   if k.endswith("_kernel")},
         "max_share_of_tolerance_by_kernel": fa_checked["share"],
         "lse_max_abs_err": max(fa_bwd_err["lse"], fa_checked["lse"]),
         **fa_time,
         "shape": "B=4 S=1024 H=32 KV=8 Dh=64 bf16 causal",
         "library_note": "torch.nn.functional.scaled_dot_product_attention"
                         "(is_causal=True, enable_gqa=True)",
         "launches_by_path": path_launches("flash_attention"),
         "card_vs_cpu_logits_max_abs_diff": card_cpu_diff,
         "at_zamba2_prefill": {"shape": "B=4 S=896 H=32 KV=32 Dh=112 bf16 "
                                        "causal", **fa_zamba2},
         **fa_more, "serving_drives": serving["figures"],
         "two_buffer_decode": two_buffer, "pipeline": pipeline_run},
        {"name": "fa_fwd_parts", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_fwd_parts.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
         "kernel": "fa_fwd_parts_kernel",
         "wrapper": "ops.fa_fwd_parts, from ops.flash_attention on "
                    "fwd_route 'wgmma' (float32 at Dh <= 128), after "
                    "ops.fa_fwd_split",
         "launches": train_f32_run["forward_routes"]["fa_fwd_parts_kernel"],
         "launches_by_path": {"train.float32": train_f32_run[
             "forward_routes"]["fa_fwd_parts_kernel"]},
         "max_abs_err": fa_checked.get("fa_fwd_parts_kernel"),
         "max_share_of_tolerance": fa_checked["share"].get(
             "fa_fwd_parts_kernel"),
         "lse_max_abs_err": fa_checked["lse"],
         "ms": fa_f32_time["parts_ms"],
         "queued_ms": fa_f32_time["parts_queued_ms"],
         "device_ms": fa_f32_time["parts_device_ms"],
         "route_call_ms": fa_f32_time["ms"],
         "turns_ms": fa_f32_time["turns_ms"],
         "turns_note": "a call of the wgmma route, fa_f32_kernel's, "
                       "fa_f32_kernel's, the wgmma route's",
         "plain_ms": fa_f32_time["plain_ms"],
         "bound_ms": fa_f32_time["bounds"]["fa_fwd_parts"][0],
         "bound_by": fa_f32_time["bounds"]["fa_fwd_parts"][1],
         "bound_note": f"the {FA_F32_BOUND_TERMS} bf16 terms that meet 2e-5 "
                       f"at 989 TFLOP/s (it runs {FA_F32_KERNEL_TERMS}); the "
                       f"function's float32 bound (67 TFLOP/s) "
                       f"{fa_f32_time['bounds']['function'][0]:.5f} ms, the "
                       f"route's (with the split) "
                       f"{fa_f32_time['bounds']['route'][0]:.5f} ms",
         "library_ms": fa_f32_time["library_ms"],
         "library_note": "scaled_dot_product_attention in float32 on the "
                         "same tensors (is_causal, enable_gqa)",
         "shape": fa_f32_time["shape"], "float32_train_step":
             {k: train_f32_run[k] for k in ("forward_routes",
                                            "split_launches")}},
        {"name": "fa_fwd_split", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_fwd_parts.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
         "replaces_note": "no Pallas kernel of its own: the float32 wgmma "
                          "route's first pass",
         "kernel": "fa_fwd_split_kernel", "wrapper": "ops.fa_fwd_split",
         "launches": train_f32_run["split_launches"],
         "launches_by_path": {"train.float32":
                              train_f32_run["split_launches"]},
         "max_abs_err": fa_checked["fa_fwd_split"],
         "ms": fa_f32_time["split_ms"],
         "queued_ms": fa_f32_time["split_queued_ms"],
         "device_ms": fa_f32_time["split_device_ms"],
         "plain_ms": fa_f32_time["split_plain_ms"],
         "plain_note": "ref.split_parts on q, k and v",
         "bound_ms": fa_f32_time["bounds"]["fa_fwd_split"][0],
         "bound_by": "bytes", "library_ms": None,
         "library_note": "no single PyTorch call writes the three bf16 parts",
         "shape": fa_f32_time["shape"]},
        {"name": "flash_attention_simt", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
         "kernel": "fa_f32_kernel",
         "wrapper": "ops.flash_attention on fwd_route 'simt' (float32 "
                    "past Dh 128), or ops.flash_attention_simt",
         "launches": train_f32_run["forward_routes"]["fa_f32_kernel"],
         "launches_note": "none on the driven paths: the float32 step "
                          "takes the wgmma route",
         "max_abs_err": fa_checked.get("fa_f32_kernel"),
         "max_share_of_tolerance": fa_checked["share"].get("fa_f32_kernel"),
         "max_abs_err_at_the_timed_shape": fa_f32_time["simt_max_abs_err"],
         "ms": fa_f32_time["simt_ms"],
         "device_ms": fa_f32_time["simt_device_ms"],
         "plain_ms": fa_f32_time["plain_ms"],
         "bound_ms": fa_f32_time["bounds"]["function"][0],
         "bound_by": fa_f32_time["bounds"]["function"][1],
         "library_ms": fa_f32_time["library_ms"],
         "library_note": "scaled_dot_product_attention in float32",
         "shape": fa_f32_time["shape"],
         "at_float32_past_dh128": fa_wide_time},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:81",
         "kernels": {"bfloat16 TMA can read": "ssd_wgmma_kernel",
                     "float32, mixed, or a layout TMA cannot read":
                         "ssd_parts_split_kernel, then the four parts "
                         "kernels (entries ssd_split, ssd_parts)",
                     "no caller (launch(..., 'f32') only)":
                         "ssd_f32_kernel"},
         "launches": launches["ssd_scan"],
         "launches_note": "forwards on any route; every drive but the "
                          "float32 mamba2 step runs bf16 (ssd_wgmma_kernel)",
         "max_abs_err": ssd_err["by_route"]["wgmma"]["max_abs_err"],
         "max_share_of_tolerance": ssd_err["by_route"]["wgmma"]["max_share"],
         **ssd_time, "launches_by_path": path_launches("ssd_scan"),
         "launches_by_route_in_serving": ssd_routes, "diloco": diloco_run,
         "card_vs_cpu_logits_max_abs_diff": card_cpu_diff},
        {"name": "ssd_parts", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan_parts.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:81",
         "kernels": list(SSD_PARTS_KERNELS),
         "wrapper": "ops.ssd_parts, from ops.ssd on route 'parts' (float32, "
                    "mixed dtypes, layouts TMA cannot read), after "
                    "ops.ssd_split",
         "launches": train_f32_runs["mamba2-780m"]["ssd_routes"]["parts"],
         "launches_by_path": {"train.float32.mamba2-780m": train_f32_runs[
             "mamba2-780m"]["ssd_routes"]["parts"]},
         "max_abs_err": ssd_err["by_route"]["parts"]["max_abs_err"],
         "max_share_of_tolerance": ssd_err["by_route"]["parts"]["max_share"],
         "ms": ssd_f32_time["parts_ms"],
         "queued_ms": ssd_f32_time["parts_queued_ms"],
         "device_ms_by_kernel": ssd_f32_time["device_ms_by_kernel"],
         "route_call_ms": ssd_f32_time["ms"],
         "turns_ms": ssd_f32_time["turns_ms"],
         "turns_note": "a call of the parts route, ssd_f32_kernel's, "
                       "ssd_f32_kernel's, the parts route's",
         "plain_ms": ssd_f32_time["plain_ms"],
         "bound_ms": ssd_f32_time["bounds"]["parts"][0],
         "bound_by": ssd_f32_time["bounds"]["parts"][1],
         "bound_note": f"the {SSD_F32_TERMS} bf16 terms of each product "
                       f"(the fewest that meet 1e-4) at 989 TFLOP/s; the "
                       f"function's float32 bound (67 TFLOP/s) "
                       f"{ssd_f32_time['bounds']['function'][0]:.5f} ms, the "
                       f"route's (with the split) "
                       f"{ssd_f32_time['bounds']['route'][0]:.5f} ms",
         "library_ms": None,
         "library_note": "no single PyTorch call computes the chunked SSD "
                         "scan",
         "shape": ssd_f32_time["shape"],
         "float32_train_step": train_f32_runs["mamba2-780m"]},
        {"name": "ssd_split", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan_parts.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:81",
         "replaces_note": "no Pallas kernel of its own: the parts route's "
                          "first pass",
         "kernel": "ssd_parts_split_kernel", "wrapper": "ops.ssd_split",
         "launches": train_f32_runs["mamba2-780m"]["ssd_split_launches"],
         "launches_by_path": {"train.float32.mamba2-780m": train_f32_runs[
             "mamba2-780m"]["ssd_split_launches"]},
         "max_abs_err": ssd_f32_time["split_max_abs_err"],
         "ms": ssd_f32_time["split_ms"],
         "queued_ms": ssd_f32_time["split_queued_ms"],
         "plain_ms": ssd_f32_time["split_plain_ms"],
         "plain_note": "ref.split on x, B and C",
         "bound_ms": ssd_f32_time["bounds"]["split"][0],
         "bound_by": "bytes", "library_ms": None,
         "library_note": "no single PyTorch call writes the three bf16 parts",
         "shape": ssd_f32_time["shape"]},
        {"name": "ssd_scan_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:81",
         "kernel": "ssd_f32_kernel",
         "wrapper": "ops.launch(..., 'f32') only: no route of ops.ssd takes "
                    "it since the parts route",
         "launches": 0,
         "launches_note": "no caller: no route of ops.ssd (ops.ROUTES) "
                          "reaches it, so no driven path launches it; the "
                          "float32 step takes the parts route",
         "max_abs_err": ssd_f32_time["f32_max_abs_err"],
         "max_share_of_tolerance": ssd_f32_time["f32_max_share_of_tolerance"],
         "ms": ssd_f32_time["f32_ms"],
         "device_ms": ssd_f32_time["f32_device_ms"],
         "plain_ms": ssd_f32_time["plain_ms"],
         "bound_ms": ssd_f32_time["bounds"]["function"][0],
         "bound_by": ssd_f32_time["bounds"]["function"][1],
         "library_ms": None,
         "library_note": "no single PyTorch call computes the chunked SSD "
                         "scan",
         "shape": ssd_f32_time["shape"]},
        *({"name": name if route != "simt" or name == "fa_bwd_delta" else
           f"{name}_{route}",
           "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd_parts.cuh"
                     if route == "parts" else
                     "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention/jnp_impl.py:117",
           "replaces_note": "the reference's flash backward _bwd_vjp, jnp "
                            "under the custom VJP of kernels/flash_attention/"
                            "ops.py: no Pallas kernel",
           "kernel": f"{name}_kernel",
           "wrapper": f"ops.{name}",
           "bwd_route": "simt" if route == "simt" else "wgmma",
           "bwd_route_note": {
               "pair": "wgmma, its pair: bfloat16 with a head dim of at "
                       "most 128 (ops.bwd_route, ops.wgmma_kernels)",
               "parts": "wgmma, its parts kernels: bfloat16 with a head "
                        "dim in (128, 256], float32 up to 128 (three bf16 "
                        "parts an operand); timed at the float32 check "
                        "row and at nemotron-4-340b's training attention",
               "simt": "float32 with a head dim in (128, 256]; timed on "
                       "the float32 check row's inputs and beside the "
                       "parts kernels at nemotron's"}[route],
           "launches": train_launch(name),
           "launches_by_path": path_launches(name),
           "max_abs_err": fa_bwd_err[name],
           "max_share_of_tolerance": fa_bwd_share[name],
           **({"max_abs_err_float32": fa_bwd_err_f32[name]}
              if name in fa_bwd_err_f32 else {}),
           **({"delta_max_abs_err": fa_bwd_err["wgmma_delta"]}
              if name == "fa_bwd_dq_wgmma" else {}),
           **fa_bwd_rows[name],
           "plain_note": "the plain rowsum (one einsum)"
                         if name in ("fa_bwd_delta", "fa_bwd_prep") else
                         "the plain backward (ref.flash_attention_bwd), "
                         "which computes dq, dk and dv at once",
           "library_note": "torch.einsum('bshd,bshd->bhs', dout, out), the "
                           "plain rowsum's one call" if name in
                           ("fa_bwd_delta", "fa_bwd_prep") else
                           "scaled_dot_product_attention's backward "
                           "(torch.autograd.grad; dq, dk and dv at once)",
           **({"function": fa_bwd_function,
               "train_drive": train["granite-3-2b"],
               "card_vs_cpu": train_cut}
              if name == "fa_bwd_dkdv_wgmma" else {}),
           **({"float32_train_step": train_f32_run}
              if name == "fa_bwd_dkdv_parts" else {})}
          for route, names in BWD_ROUTE_KERNELS.items() for name in names),
        {"name": "ssd_bwd_wgmma", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan_bwd_wgmma.cuh",
         "sources": ["src/repro_torch/csrc/ssd_scan_bwd_wgmma.cuh",
                     "src/repro_torch/csrc/ssd_scan_bwd_wgmma.cu",
                     "src/repro_torch/csrc/ssd_scan_bwd_wgmma_p128.cu"],
         "replaces": "src/repro/kernels/ssd_scan/ops.py:28",
         "replaces_note": "the reference's SSD backward _bwd, a jax.vjp "
                          "through the plain chunked scan ssd_chunked "
                          "(src/repro/models/mamba2.py:107) under the custom "
                          "VJP of kernels/ssd_scan/ops.py: no Pallas kernel",
         "kernels": list(SSD_BWD_ROUTE_KERNELS["wgmma"]),
         "wrapper": "ops.ssd_bwd, route ops.bwd_route 'wgmma' (bf16 x, B, C "
                    "and dy TMA can read; one entry point, "
                    "ssd_bwd_wgmma_launch, five kernels)",
         "launches": ssd_route_launch("wgmma"),
         "launches_by_path": {k: n for k, n in path_launches("ssd_bwd").items()
                              if k != "train.float32.mamba2-780m"},
         "max_abs_err": max(ssd_bwd_err["wgmma"].values()),
         "max_abs_err_by_output": ssd_bwd_err["wgmma"],
         **{k: v for k, v in ssd_bwd_time.items()
            if not k.startswith("simt_")},
         "device_ms_by_kernel_in_training": train["mamba2-780m"][
             "ssd_bwd_device_ms_by_kernel"],
         "plain_note": "ref.ssd_bwd, the vjp written out in plain PyTorch",
         "train_drive": train["mamba2-780m"]},
        {"name": "ssd_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
         "replaces": "src/repro/kernels/ssd_scan/ops.py:28",
         "kernels": list(SSD_BWD_ROUTE_KERNELS["simt"]),
         "wrapper": "ops.ssd_bwd, route ops.bwd_route 'simt' (float32 and "
                    "any layout TMA cannot read; one entry point, "
                    "ssd_bwd_launch, six kernels): the float32 training "
                    "step's; timed on the bf16 training inputs through "
                    "ops.bwd_launch",
         "launches": ssd_route_launch("simt"),
         "launches_by_path": {"train.float32.mamba2-780m": train_f32_runs[
             "mamba2-780m"]["ssd_bwd_routes"]["simt"]},
         "max_abs_err": max(ssd_bwd_err["simt"].values()),
         "max_abs_err_by_output": ssd_bwd_err["simt"],
         "ms": ssd_bwd_time["simt_ms"],
         "ms_turns": ssd_bwd_time["simt_ms_turns"],
         "pr28_ms": ssd_bwd_time["pr28_simt_ms"],
         "device_ms_by_kernel": ssd_bwd_time["simt_device_ms_by_kernel"],
         "plain_ms": ssd_bwd_time["plain_ms"],
         "bound_ms": ssd_bwd_time["bound_ms"],
         "bound_by": ssd_bwd_time["bound_by"], "library_ms": None,
         "library_note": ssd_bwd_time["library_note"],
         "shape": ssd_bwd_time["shape"],
         "at_float32_step": ssd_bwd_time["simt_at_float32_step"],
         "at_zamba2_training": {
             "ms": ssd_bwd_time["at_zamba2_training"]["simt_ms"],
             "bound_ms": ssd_bwd_time["at_zamba2_training"]["bound_ms"]}},
    ]}
    phase("end")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
