#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches its own error):
  1. device   -- the card's name, and its name and power limit from nvidia-smi;
                 memory that another process still holds on the card (one
                 that is ending, say) is waited for, up to MEMORY_WAIT_S,
                 until the script's peak fits beside it;
  2. build    -- compile the CUDA kernels from src/repro_torch/kernels/csrc;
  3. kernels  -- every kernel against its plain PyTorch twin at the paper's
                 scale (U=1250 users, N=16 APs, M=250 subchannels): both links,
                 forward and backward, dense and with a CellLayout (the intra
                 term both by the dense per-cell kernel the main path runs and
                 by the CSR kernel on either tile list), the dense kernel also
                 on skewed cells (half the users in one cell, one cell empty);
                 two per_ap launches on the same inputs bit-identical in both
                 layouts; then the rates and their gradients, kernel backend
                 against einsum; then each kernel's time beside its plain
                 twin's, a one-call PyTorch yardstick's where there is one, and
                 its bound and share of it (per_ap in both layouts, uplink
                 table A and downlink table D, beside a streaming yardstick of
                 the same gain bytes, a torch.sum over them; and the CSR intra
                 kernel on the dense tile list, timed in turns with the dense
                 kernel, which must beat it);
  4. main path -- PlannerEngine(nin, sinr_backend="kernel").plan on a sampled
                 env, then two replans on gains perturbed by a few percent, with
                 the kernel launch counters read around them (the engine's
                 programs: each GD step and the plan assembly CUDA graphs,
                 captured on the first call of a kind and replayed after; the
                 counters count replays, by what each graph's capture
                 counted, held to the device trace in 5); the plan is
                 checked for finiteness and feasibility, and at the cold start
                 of one split the utility and its gradient under "kernel" are
                 held against "einsum"; each program's graphs, capture
                 seconds and the graph pool's bytes;
  5. profile  -- 40 GD steps of one split under torch.profiler, eagerly and
                 as replays of the engine's captured step: wall time per
                 step, device busy time and share, and the top kernels by
                 device time; the NOMA kernels on the replays' device trace
                 equal to the launches their bookkeeping counted;
  6. serve    -- split serving of recurrentgemma-9b at full width and depth
                 (38 layers, 8.5e9 parameters, random weights from a seed):
                 the flash_attention and rg_lru kernels against their plain
                 twins at the served shapes (flash also at hd 32 to 256 with
                 ragged Sq/Sk, windows, kv_len < Sk, and on its float32
                 path), rg_lru also bit-equal (torch.equal) to its twin, and
                 its cp.async path (operands off a 16-byte boundary) to its
                 TMA path, and their times (bf16 flash no slower than
                 scaled_dot_product_attention; rg_lru beside a streaming
                 yardstick, torch.add(log_a, b, out=buf)); then the
                 serving entry point (plan s*, cut, serve 4 requests of 3072
                 tokens, greedy continuation) with the launch counters read
                 around it; split logits at s* and at s=19 equal to the
                 unsplit forward's to the bit, 12 flash_attention and 26
                 rg_lru launches a forward; prefill + 8 cached decode steps
                 against the forward; the same prefill and decode through
                 the compiled serve steps (graph_serve_checks: jit_prefill
                 captured and replayed, 8 jit_decode_step and 8
                 jit_masked_decode_step steps, each bit-equal to the eager
                 step with its launches, one replay of each program
                 profiled and its device trace's kernels held to the
                 eager call's launches, no blocking sync in a program
                 call, ms a step and busy share graphed and eager, capture
                 seconds and pool bytes); one forward under torch.profiler; the
                 reduced model on the card against its plain twins on the
                 CPU; and the serving times;
  7. fleet    -- B=8 members of a Scenario at the paper's width (U=1250, N=16,
                 M=250, dense_urban's motion and churn, Jakes rho ~0.92): the
                 three NOMA kernels' fleet launches, each member bit-identical
                 to a single launch on it, members 0 and 7 against the plain
                 twins, each operand set of both links and directions timed
                 beside eight single launches (no slower) and its bound; then
                 plan_many and one epoch of step_many -> env_many ->
                 replan_many (one fewer, for phase 15's time)
                 with exact launch counts (6 / 3 / 3 a fleet GD
                 step) and every member's plan feasible; members 0 and 1
                 planned alone beside the fleet (utility gate); 40 fixed GD
                 steps of the fleet against member 0 alone; 40 fleet GD steps
                 under torch.profiler, eagerly and as replays of the fleet
                 program's captured step; the fleet programs' graphs and pool;
  8. compare  -- planner.compare_all, the paper's six arms (ECC-NOMA, ECC-OMA,
                 Device-Only, Edge-Only, Neurosurgeon, DNN-Surgery), for NiN on
                 phase 4's env with the figure harness's GdConfig and the NOMA
                 kernels as the SINR backend: finite positive T and E, the
                 reference's invariants, ECC-NOMA's outcome under the kernels
                 against the same plan under einsum (at s* and at s = 0),
                 exact NOMA launch counts
                 around each arm (none for the OMA arms and Device-Only);
                 the per-arm table (mean T and E, speed-up and E-reduction
                 against Device-Only, s*, wall);
  9. online   -- an OnlineSplitServer over recurrentgemma-9b at full width and
                 depth (phase 6's model) planning on the arch's profile on a
                 Scenario at the paper's width, with phase 4's GdConfig cut to
                 max_iters 60: 3 scheduled epochs, a forced
                 epoch with a measured profile that moves s*, a NaN profile
                 (rejected, the last good plan held) and a user-count change
                 (cold reset); exact NOMA launch counts around each replan,
                 and after each re-cut the programs' logits on a request of
                 ONLINE_S tokens equal to the unsplit forward's, with 12
                 flash_attention and 26 rg_lru launches;
 10. loop     -- the closed online loop (online.OnlineLoop): 10.1 the three
                 NOMA kernels against their twins on phase 4's env with one
                 AP blacked out and a fifth of the users faded by 1e-6 (both
                 links, forward and backward; the dead cell's intra terms
                 exactly 0, its users' rates at the 1e-9 floor); 10.2 the
                 hardened loop (faults, ladder, feedback) on
                 "paper_scale_urban" for 20 epochs with exact NOMA launch
                 counts and host reads each epoch, no program built once the
                 engine holds its plan and replan programs (compile_log; in
                 every gated epoch of 10 and 11), and every served plan
                 finite, requests conserved, one non-replan epoch under
                 torch.profiler; every gated epoch of 10-11 also holds the
                 online_epoch program (a CUDA graph after the loop's first
                 epoch, which builds it) to the eager epoch on the same
                 draws and state, leaf for leaf, with no blocking sync
                 inside a program call; 10.2 times epochs without a
                 replan graphed and eager in turns and profiles one of
                 each (the NOMA kernels on its device trace equal to the
                 counted launches); 10.3 the unguarded arm on the same traffic
                 and faults for 6 epochs (launch counts gated only); 10.4
                 DecodeBatcher and EdgeBatcher over phase 6's model:
                 prompts of 512, 448 and 384 tokens, 12 / 26 launches an
                 admission, none a decode step, a masked slot's caches
                 frozen, logits within 0.05 * max(1, max |logits|) of each
                 request's own serving, the batcher's admission program one
                 CUDA graph a prompt length (its pool printed after each
                 admission) and its masked step one;
 11. durable  -- durable serving (repro_torch.state) around the hardened loop
                 at the recovery benchmark's operating point
                 (benchmarks/recovery_serve.py) at U=1250, 24 epochs, a
                 snapshot every 6, a crash before epoch 16: 11.1 two
                 crash-free episodes (bare; asynchronous snapshots and a
                 flight recorder) bit-equal leaf for leaf, with the
                 snapshot's bytes, capture and write times and overhead;
                 11.2 the crash and a durable resume, bit-equal to them,
                 recovery within the cadence, the history rewound, exact
                 launches and host reads in the re-executed epochs as in
                 the original ones; 11.3 the no-checkpoint arm (a cold
                 restart, the same goodput), goodput per wall second of
                 both arms; 11.4 integrity: a flipped byte in the newest
                 snapshot escalates to the previous one, all corrupt
                 cold-starts, another configuration is refused by
                 fingerprint, a stored leaf of the wrong dtype or shape is
                 refused before anything loads; 11.5 replay of 11.2's
                 journal without divergence, a tampered word caught, a
                 torn tail read clean=False; 11.6 DecodeBatcher cache
                 export / import over phase 6's model, the same decode
                 steps bit-equal after the import;
 12. programs -- the engine's CUDA graphs against the eager path
                 (programs.solve_state / resolve_state without a runner:
                 li_gd.gd_loop + assemble_plan) on the same inputs, leaf for
                 leaf with torch.equal and with the same launches and GD
                 steps: 12.1 phase 4's plan and second replan (the first
                 replan's eager rerun left out for phase 15's time: its
                 graphs are captured by it and replayed by the second, and
                 12.2 holds its replay to it); 12.2 the plan and
                 the first replan again (pure replays: bit-equal to the
                 capturing calls, exact launches, no blocking sync inside a
                 replayed step, the others' origins printed); 12.3 phase 7's
                 plan_many and first replan_many (the eager fleet runs once);
                 12.4 graphs, capture seconds and pool bytes; the walls of
                 both paths;
 13. moe/xlstm -- the MoE and xLSTM families at full width and depth,
                 random weights from a seed, 4 requests of 3072 tokens:
                 13.1 deepseek-moe-16b (28 layers, 16.3e9 parameters, built
                 at the serving driver's capacity 4.0): flash_attention
                 against its twin at its shape (hd 128, G = 1, full causal)
                 and timed beside scaled_dot_product_attention (is_causal)
                 and its bound; the serving entry point with exact launch
                 counts (28 flash_attention a forward); split logits at s*
                 and s=14 equal to the unsplit forward's to the bit; two runs
                 of the forward bit-equal (the combine adds without
                 atomics); the slots dropped at capacity 4.0, printed;
                 sorted MoE against dense on the first MoE layer's input of
                 1024 served tokens at capacity E; prefill + 8 cached decode
                 steps against the forward at a capacity where no slot can
                 drop, with free routing (printed, with the top-6 choices
                 that moved) and with each layer's experts pinned to the
                 forward's (held to 0.05 * max(1, max |logits|)); one
                 forward under torch.profiler (busy share; expert bmm,
                 dispatch and flash shares); the compiled serve steps as
                 in 6, their MoE dropped-slot counts equal to eager;
                 13.2 xlstm-125m (12 layers, mLSTM / sLSTM; 4 requests
                 of XLSTM_S tokens): the entry point (no TPU kernel on its
                 path), split logits at s* and s=6 bit-equal, prefill of
                 3 chunks + 8 decode steps against the forward, a
                 DecodeBatcher's caches exported after 8 steps and
                 imported into a fresh one, 4 more steps bit-equal to the
                 live batcher's, the compiled serve steps as in 6 on a
                 prompt of 512 tokens, and a profiled forward of 4 x 512
                 tokens (the sLSTM loop's launch rate);
 14. vlm/audio -- the vision and audio families at full size, random
                 weights from a seed, each with a make_batch frontend:
                 14.1 llama-3.2-vision-11b (40 layers: 8 groups of 4 attn +
                 1 cross, 9.8e9 parameters, every xgate at 0.5): the flash
                 kernel against its twin at its self-attention (hd 128,
                 G = 4, causal) and cross-attention (3072 queries over 1601
                 keys, no mask) shapes, each timed beside
                 scaled_dot_product_attention (enable_gqa) and its bound;
                 the entry point with exact launch counts (40 flash a
                 forward; no frontend, as the JAX entry point); a forward over a
                 1601 x 4096 frontend (40 launches) whose logits a redrawn
                 frontend moves; split logits at s* and s=22 (inside a
                 group) bit-equal to it; prefill + 8 cached decode steps
                 against it; a profiled forward (busy share, GEMM and flash
                 shares); 14.2 whisper-small (12 enc + 12 dec, 4 x 448
                 decoder tokens over 1500 frames): the kernel at the
                 encoder (hd 64, bidirectional), decoder self and decoder
                 cross shapes; the entry point (36 flash a forward); a
                 forward with the frontend (36), prefill + 8 decode steps
                 through the enc_out cache against it; the reference's
                 split (the encoder over the token embeddings, cross
                 attention to the raw frontend) bit-equal between s* and
                 s=18; a profiled forward. 14.1 and 14.2 also run the
                 compiled serve steps as in 6, with the frontend, the
                 compiled prefill's flash shapes among the checked ones
                 (not counted on the kernels line: a check, not a path).
 15. train    -- training qwen1.5-0.5b at full width and depth (24 layers,
                 0.62e9 parameters, float32 masters from a seed): 15.1 the
                 flash_attention_bwd kernel against its plain twin at the
                 train step's shapes (8 x 16 query head rows over 2048 keys,
                 hd 64, G = 1, causal, bf16, and the check batches' shapes)
                 and a grid of small shapes (window, bidirectional, G = 4,
                 Sq != Sk, kv_len < Sk, hd 32 / 128 / 256, float32), two
                 launches bit-equal at each, the forward's log-sum-exp
                 against its twin and its output bit-equal to the serving
                 call's, the backward's time beside its twin's, SDPA's
                 backward (is_causal) and its bound, and each of its three
                 kernels' device time in one call (torch.profiler), at the
                 train shape and at WIDE_ARCH's hd-128 layout (8 x 12 query
                 heads over 2 KV heads, G = 6, 2048, causal; checked too);
                 each backward kernel's registers and spills from ptxas
                 (a spill in a wgmma kernel fails) and the shared memory
                 each opts in to against bwd_smem_bytes; 15.2 TRAIN_STEPS steps of
                 make_train_step (chunked cross-entropy) on SyntheticLM's 8 x
                 2048 tokens at base_lr 3e-3 (float32 masters, bf16 compute,
                 remat): exact flash launches a step (2
                 forwards a layer under remat, 1 backward), a finite loss
                 every step and lower at the end, step ms, tokens/s, model
                 FLOPs utilisation, one profiled step (busy share), peak
                 reserve; the chunked against the unchunked cross-entropy
                 at 2 x 512 tokens; 4 microbatches against 1 on one batch;
                 two steps from one state bit-equal; 15.3 the entry point,
                 launch.train.main at its defaults (8 x 128) with
                 --ckpt-every 3, a 4-step run that crosses it and ends, a
                 restart that resumes from its final checkpoint, the
                 resumed losses bit-equal to an uninterrupted run's.
 16. families -- training the hybrid, MoE, vision, xLSTM and audio families
                 at full width (FAMILIES: recurrentgemma-9b cut to rec, rec,
                 attn; deepseek-moe-16b to its dense layer and 2 MoE layers;
                 llama-3.2-vision-11b to 4 self + 1 cross layers over a
                 1601 x 4096 frontend, every xgate 0.5; xlstm-125m and
                 whisper-small whole), float32 masters and AdamW in place:
                 16.0 rg_lru_bwd bit-equal to its twin at the hybrid's
                 (2, 3072, 4096) with and without h0, at a ragged S and W,
                 at W % 4 != 0 and with dh off 16 bytes (cp.async), two
                 launches bit-equal at each, timed beside its twin, its bound
                 and a same-bytes yardstick; for each family the flash
                 forward and backward against their twins at every shape its
                 step launches (window 2048 hd 256 G = 16; causal hd 128 G = 1
                 and G = 4; vlm cross 2048 over 1601; whisper's encoder,
                 decoder self and cross) with two backward launches bit-equal,
                 each backward timed beside SDPA's backward; 16.1 an untimed
                 step, then two gradient passes from one state and batch
                 bit-equal in every leaf; 16.2 FAMILY_STEPS timed steps
                 (exact flash, rg_lru and rg_lru_bwd launches a step: 2
                 forwards and 1 backward a layer under remat; one MoE drop
                 count a MoE layer; no launch at an unchecked shape): step
                 ms, tokens/s, MFU, a profiled step's busy share and kernel
                 shares, peak reserve; 16.3 the reduced model in float32 on
                 the card against the CPU's plain twins (loss and every
                 gradient leaf); 16.4 launch.train.main for each family
                 (xlstm-125m and whisper-small at full size, the others
                 --reduced), whisper-small resumed from its final checkpoint
                 bit-equal to an uninterrupted run.
 17. sharding -- run after 15 and before 16 (xlstm's profile in 16 leaves
                 later traces short of kernel records), on an NCCL group
                 of world size 1 (one card: a mesh of one device, not a
                 multi-device result; the CPU tests run the ranks): 17.1 phase 7's fleet planned and replanned through
                 plan_many_sharded / replan_many_sharded on fleet_mesh(),
                 every leaf bit-equal to phase 7's unsharded states, exact
                 NOMA launches, a graphed step's traced launches against the
                 counted ones and the replays that ran; 17.2
                 jit_train_step on a ("data",) mesh at qwen1.5-0.5b 8 x 2048,
                 3 steps with ZeRO-1 off and 3 on, bit-equal to
                 make_train_step's from the same state and batches, step
                 ms, MFU, peak reserve; 17.3 compressed_psum bit-equal to
                 error_feedback_update's g_hat; 17.4 launch.train.main
                 --mesh 1x1 --reduced under the group, resumed bit-equal to
                 an uninterrupted run, flash checked at its shapes.
 18. tensor-parallel serving (models/tp.py) -- 18.1 after phase 11, over
                 phase 6's model (its weights shared by a model built on a
                 (1, 1) ("data", "model") mesh of a world-1 NCCL group):
                 graphed jit_prefill / jit_decode_step / jit_masked_decode_step
                 with their collectives captured, bit-equal to the unsharded
                 programs, a traced replay's kernels against the counted
                 ones, the all-reduces a call issues counted; 18.3 and 18.2
                 last: 18.3 flash and rg_lru at the per-rank shapes of model
                 axes of 2 and 4 (recurrentgemma-9b's flat layout at G = 1
                 with window 2048 and its RG-LRU channels, qwen1.5-0.5b's
                 grouped layout) against their twins and timed; 18.2 two
                 ranks on the one card over gloo (NCCL refuses two ranks on
                 one GPU), eager: recurrentgemma-9b cut to rec, rec, attn
                 (flat, a sequence-split decode cache, split RG-LRU
                 channels) and qwen1.5-0.5b whole (grouped), 4 x 3072 and 8
                 decode steps, within 0.05 * max(1, max |logits|) of the
                 unsharded Model(cfg, tp_size=2) on the same weights, the
                 ranks' flash and rg_lru launches twice the unsharded
                 prefill's; gloo stages through the host, so 18.2's times
                 are no tensor-parallel performance number.
 19. tensor-parallel serving of the MoE, xLSTM, vision and audio families
                 (expert parallelism, xLSTM heads, cross attention and the
                 encoder over "model") -- 19.1 inside 13.1, 13.2, 14.1 and
                 14.2, over each phase's model (deepseek-moe-16b,
                 xlstm-125m on its 512-token graphed prompt,
                 llama-3.2-vision-11b, whisper-small): 18.1's checks on a
                 world-1 NCCL mesh (mesh_graph_checks: graphed prefill, 8
                 decode and 8 masked steps bit-equal to the unsharded
                 programs, the all-reduces of a capturing call counted
                 against tp_collectives, none in a replay, a traced
                 replay's kernels against the counted ones); 19.3 and 19.2
                 last: 19.3 flash at the per-rank shapes of M = 2 and 4
                 (deepseek's and the vlm's self attention over 1024, the
                 vlm's cross attention over 1601 at 1024 and 3072 queries,
                 whisper's encoder over 1500, decoder self over 448 and
                 cross 448 over 1500), each against its twin and timed
                 beside SDPA and its bound; deepseek's also in float32;
                 19.2 two gloo ranks sharing the card, eager, at published
                 widths with phase 16's depth cuts (deepseek 3 layers, the
                 vlm 4 self + 1 cross over 1601 image tokens; xlstm and
                 whisper whole), 4 requests of 1024 tokens (xlstm 512,
                 whisper 448 over 1500 frames) and 8 decode steps against
                 the unsharded Model(cfg, tp_size=2): the vlm, whisper and
                 xlstm within 0.05 * max(1, max |logits|), deepseek's and
                 xlstm's float32 compute within 1e-4 of it (deepseek's MoE
                 drops equal; its bf16 share printed beside its flipped
                 top-6 choices), flash launches twice the unsharded
                 serve's.
Every profiled window that records no device time is measured once more
(profiled); a phase fails only if the retry is empty too. A graphed
window whose trace is short of the replays that CUDA events saw run is
measured once more too (profile_graph_steps).
The last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

U, N, M = 1250, 16, 250            # the paper's users and subchannels; 16 APs
MAX_ITERS = 200
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM, bf16 tensor cores, dense
# Non-FMA float32 instructions a second: the 67 TFLOP/s counts an FMA as two
# operations, so one lane-instruction per clock is half of it.
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
# Every check holds each element to its own scale, never to the largest
# output: own gains span many orders of magnitude (path-loss exponent 5),
# so a far user's row would hide under a whole-array maximum.
# Kernel vs plain twin: the same float32 terms summed in another order (up
# to U=1250 terms); the scale of an element is the sum of the magnitudes of
# its terms (the plain twin on absolute weights), the float32 summation bound.
KERNEL_RTOL = 1e-4
# Kernel backend vs einsum for whole rates, utilities and gradients: the
# einsum path sums the pairwise terms through matmuls in another order. The
# scale of a (U, M) element is the largest magnitude in its user's row; of a
# per-user power gradient, the magnitude of its chain-rule terms through
# tx = beta * p (power_scale).
PATH_RTOL = 1e-4
# Phase 6: per-element scales of the served kernels. flash_attention: the
# bf16 output rounds at 2^-8 of sum_k p_k |v_k| (the twin on |v|), and p is
# rounded to bf16 before the AV product. rg_lru: the float32 summation
# bound, the twin on (log_a, |b|, |h0|).
FLASH_RTOL = 1e-2
# The float32 path (FMA kernel): only the order of the sums differs.
FLASH_F32_RTOL = 1e-5
RG_LRU_RTOL = 1e-5
# Phase 7: a fleet at the paper's width. The fleet's plan utility (at s*
# and at every split) may be worse than a member's own plan's by at most
# this fraction: the two solves
# run the same kernels (the same bits per member) but reduce other sums in
# another order, and at U >= 200 a split's stopping step follows float32
# summation order (ROADMAP section 3) while the utility it stops at does not
# (utilities within 1.2e-6 there across 167-step differences): 1e-4 is
# about 100 times that.
FLEET_UTILITY_RTOL = 1e-4
# 40 fixed GD steps of the fleet and of member 0 alone: each row of a
# normalized variable (a user's beta row, or its power or compute unit)
# within this fraction of the row's largest magnitude. Only the order of
# non-kernel sums differs, which Adam's normalized steps carry forward.
FLEET_STEP_RTOL = 1e-3
FLEET_B = 8
FLEET_CALLS = 2                    # plan_many, then one epoch's replan_many
FLEET_SCENARIO = dict(n_users=1250, n_aps=16, n_sub=250, epoch_dt_s=0.01, doppler_hz=9.0,
                      speed_mps=1.4, arrival_rate_hz=2.0, cluster_frac=0.5, n_clusters=3,
                      cluster_radius_m=40.0, name="paper_scale_urban")
# Phase 3's single-launch times of the main operand sets before the three
# NOMA kernels took a member dim (ms, H100 80GB HBM3 at 700 W): intra,
# per_ap up, per_ap dn, contract. Printed beside this run's.
BEFORE_MEMBER_DIM_MS = {"noma_cell_intra": 0.027266, "noma_per_ap": 0.012206,
                        "noma_per_ap dn": 0.011464, "noma_ap_contract": 0.010245}
# The script's peak in PyTorch's allocator is 56.8 GiB reserved on an H100
# 80GB, in phase 13.1 (32.6 GB of deepseek-moe-16b's weights, its compiled
# prefill's 10.3 GB graph pool, the eager prefill's caches and a replay's
# own copy of them, 2.8 GB each); phase 6's is 54.2 GiB (19 GB of bf16
# weights beside the split and the unsplit forward's float32 logits, 12.6
# GB each, and phase 4's engine with its graph pool) and phase 14.1's 50.1
# GiB (the flash twin's float32 scores at 128 x 3072 x 3072 captured in a
# timing graph). Printed at the end, by phase.
# With the CUDA context and a margin it needs this much free at the start.
MEMORY_NEED_BYTES = 58 << 30
MEMORY_WAIT_S = 300.0              # the script takes 450-710 s of its 1200
SERVE_ARCH = "recurrentgemma-9b"
SERVE_B, SERVE_S = 4, 3072         # 4 requests of 3072 tokens
SERVE_SPLIT = 19                   # the second split point held to the bit
DECODE_STEPS = 8
# Phase 8: the paper-figure harness's GdConfig (plain GD, step 5e-3).
COMPARE_MAX_ITERS = 250
ARMS = ("ecc_noma", "ecc_oma", "device_only", "edge_only", "neurosurgeon", "dnn_surgery")
# NOMA launches of one forward evaluation of the rates (user_rates): the
# uplink's intra and per_ap, the downlink's intra and contract.
FORWARD_EVAL_LAUNCHES = {"noma_cell_intra": 2, "noma_per_ap": 1, "noma_ap_contract": 1}
# Phase 9: tokens of the request served after each re-cut, and the server's
# GD cap (phase 4's GdConfig cut to the closed loop's max_iters: the NaN
# epoch runs every one of the 39 splits to the cap).
ONLINE_S = 512
ONLINE_MAX_ITERS = 60
# Phase 10: the closed online loop at the paper's width, the chaos
# benchmark's operating point (benchmarks/chaos_serve.py: 6 users x 30 Hz x
# 0.02 s = 3.6 requests an epoch) with the population raised to U=1250, so
# 0.144 Hz a user; the "full" fault mix at a 20 % link-outage rate.
LOOP_GD = dict(step_size=3e-2, eps=1e-4, max_iters=60, optimizer="adam")
LOOP_STREAM = dict(arrival_rate_hz=0.144, epoch_dt_s=0.02, deadline_s=0.2)
LOOP_SERVICE = dict(edge_capacity=4, queue_depth=32, load_gain=4.0, replan_every=5,
                    max_work_epochs=200)
LOOP_LADDER = dict(quarantine_epochs=15, baseline_after=2)
LOOP_FAULTS = dict(link_outage_rate=0.2, fade_depth=1e-6, ap_outage_rate=0.05,
                   telemetry_drop_rate=0.1, telemetry_spike_rate=0.05, service_spike_rate=0.02)
LOOP_EPOCHS, UNGUARDED_EPOCHS = 20, 6
# 10.1: the AP blacked out and the share of users faded by 1e-6.
DEAD_AP, FADED_SHARE = 3, 0.2
# 10.4: slot batching over phase 6's model; logits within the JAX package's
# bound 0.05 * max(1, max |logits|) of each request's own serving.
BATCH_SLOTS, BATCH_STEPS, BATCH_TOL = 4, 4, 0.05
# Phase 11: durable serving at the recovery benchmark's operating point
# (benchmarks/recovery_serve.py: phase 10's stream, service and ladder, its
# own fault mix, seed 7) at U=1250; cut in depth to 24 epochs, a snapshot
# every 6 (3 kept), a crash before epoch 16.
DURABLE_FAULTS = dict(link_outage_rate=0.1, fade_depth=1e-6, ap_outage_rate=0.02,
                      telemetry_drop_rate=0.05, service_spike_rate=0.02)
DURABLE_SEED, DURABLE_EPOCHS, DURABLE_EVERY, DURABLE_CRASH = 7, 24, 6, 16
DURABLE_TAMPER_T = 3               # the journal epoch whose word 11.5 flips
# Phase 13: the MoE and xLSTM families at full width and depth, 4 requests of
# 3072 tokens as phase 6 (xlstm: XLSTM_S); the second split point each holds
# to the bit, and the served tokens on which sorted MoE is held to dense.
MOE_ARCH, XLSTM_ARCH = "deepseek-moe-16b", "xlstm-125m"
MOE_SPLIT, XLSTM_SPLIT = 14, 6
MOE_DENSE_TOKENS = 1024
# 13.2's graphed serve steps: a prompt of two mLSTM chunks
XLSTM_GRAPH_S = 512
# 13.2's requests: 1024 tokens (4 mLSTM chunks), cut from the other
# families' SERVE_S for the script's time (its sLSTM loop is host-bound,
# about 2.3 ms a token of a 4-request forward); phase 16 trains it at 512.
XLSTM_S = 1024
# Phase 14: the vision and audio families. llama-3.2-vision-11b serves 4 x
# 3072 tokens over its 1601 image tokens with every cross block's gate at
# VLM_XGATE, and is held to the bit at a split inside a group of 4 attn + 1
# cross layers; whisper-small serves 4 x 448 decoder tokens (its published
# text context, n_text_ctx) over 1500 frames, and its reference-shaped split
# is held to the bit between s* and a split inside the decoder.
VLM_ARCH, AUDIO_ARCH = "llama-3.2-vision-11b", "whisper-small"
VLM_SPLIT, VLM_XGATE = 22, 0.5
AUDIO_S, AUDIO_SPLIT = 448, 18
# Phase 15: training qwen1.5-0.5b at full size on SyntheticLM, TRAIN_B x
# TRAIN_S tokens a step, chunked cross-entropy; the cross-entropy check's
# batch (small enough for the unchunked (B, S, V) float32 logits), and the
# entry point's defaults (8 x 128) with its checkpoint cadence crossed once.
TRAIN_ARCH, TRAIN_SEED = "qwen1.5-0.5b", 0
# 15.1 also checks and times the backward at this arch's hd-128 GQA layout
# (the other dense archs' head dim) at TRAIN_B x TRAIN_S
WIDE_ARCH = "qwen2-1.5b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR, TRAIN_CHUNK = 8, 2048, 20, 3e-3, 512
CE_B, CE_S, CE_CHUNK = 2, 512, 128
# 15.3: a first run of 4 steps crosses --ckpt-every 3 (each checkpoint of
# the 0.62e9-parameter state is 7.4 GB: params, m and v in float32), then a
# restart trains 2 more, writing only its final checkpoint.
ENTRY_STEPS, ENTRY_RESUMED, ENTRY_EVERY = 4, 2, 3
# Phase 17: the data-parallel step's steps at TRAIN_B x TRAIN_S (with ZeRO-1
# off and on) and compressed_psum's gradient (the unembedding's shape)
DP_STEPS = 3
PSUM_SHAPE = (151936, 1024)
# 15.1: flash_attention_bwd against its twin, each gradient element within
# this fraction of the sum of the magnitudes of its terms
# (flash_attention_bwd_scale): in bf16 both round P and dS to bf16 before
# the products (a rounding may fall on the other side: 2^-8 of a term) and
# the gradients at 2^-8; in float32 only the order of the sums differs. The
# forward's log-sum-exp within LSE_RTOL of 1 + |lse| (exp2 against exp).
FLASH_BWD_RTOL, FLASH_BWD_F32_RTOL, LSE_RTOL = 1e-2, 1e-5, 1e-5
# Phase 16: training the other five families, each at full width (depth cut
# to fit float32 masters and AdamW, 16 bytes a parameter, where listed):
# family -> (arch, layers kept or None, batch, tokens a sequence, frontend
# tokens or None). The hybrid keeps rec, rec, attn (window 2048); deepseek
# its dense first layer and two MoE layers; the vlm four self-attention
# layers and one cross layer over a 1601 x 4096 frontend; xlstm-125m and
# whisper-small (over 1500 frames) are whole.
FAMILIES = {
    "hybrid": ("recurrentgemma-9b", 3, 2, 3072, None),
    "moe": ("deepseek-moe-16b", 3, 4, 2048, None),
    "vlm": ("llama-3.2-vision-11b", 5, 2, 2048, 1601),
    "audio": ("whisper-small", None, 4, 448, 1500),
    # last: its profiled step records about a million events, after which a
    # window may come back empty
    "ssm": ("xlstm-125m", None, 4, 512, None),
}
FAMILY_SEED, FAMILY_STEPS, FAMILY_LR, FAMILY_CHUNK = 16, 5, 3e-3, 512
FAMILY_CAPACITY, FAMILY_XGATE = 2.0, 0.5     # the launcher's capacity; every xgate
# 16.3: the reduced model in float32 compute on the card against itself on
# the CPU (the plain twins): the loss within REDUCED_LOSS_RTOL, each
# gradient leaf within REDUCED_GRAD_RTOL of its largest value (a
# one-element leaf, xgate, of its block's largest: a sum over every output
# of the block, whose terms cancel): the same float32 terms summed in
# another order by the kernels and cuBLAS.
REDUCED_B, REDUCED_S, REDUCED_LOSS_RTOL, REDUCED_GRAD_RTOL = 2, 64, 1e-5, 1e-4
# 16.4: the entry point for every family (whisper-small and xlstm-125m at
# full size, the others --reduced), 2 steps at 8 x 128 each; whisper-small
# then resumed for 1 step from its final checkpoint.
ENTRY_FAMILY_STEPS, ENTRY_FAMILY_RESUMED = 2, 1
# Phase 18: tensor-parallel serving. 18.2 runs TP_M ranks on the one card
# (gloo: NCCL refuses two ranks on one GPU): each arch of TP_ARCHS at
# published width, its depth cut where given (arch -> layers kept or None:
# recurrentgemma-9b keeps rec, rec, attn), a prefill of TP_B x TP_S and
# TP_DECODE decode steps; 18.3 times the kernels at the per-rank shapes of
# a model axis of each of TP_RANK_MS. Gloo all-reduces the card's tensors
# itself (staged through the host).
TP_M, TP_B, TP_S, TP_DECODE, TP_SEED = 2, 4, 3072, 8, 18
TP_ARCHS = {"recurrentgemma-9b": 3, "qwen1.5-0.5b": None}
TP_RANK_MS = (2, 4)
# Phase 19: tensor-parallel serving of the MoE, xLSTM, vision and audio
# families. 19.1 runs inside each family's serve phase (13.1, 13.2, 14.1,
# 14.2) over its model; its mesh programs' launches collect in
# TP19_LAUNCHES. 19.2 runs TP_M gloo ranks on the card for each family:
# arch -> (layers kept or None, prompt tokens, frontend tokens or None),
# the depths phase 16 keeps (deepseek its dense layer and two MoE layers,
# the vlm four self layers and one cross layer over a 1601 x 4096
# frontend), TP_B requests and TP_DECODE decode steps; deepseek's and
# xlstm's float32 compute runs within TP19_F32_RTOL. 19.3 times flash at
# the per-rank shapes.
TP19_FAMILIES = {
    "deepseek-moe-16b": (3, 1024, None),
    "llama-3.2-vision-11b": (5, 1024, 1601),
    "xlstm-125m": (None, 512, None),
    "whisper-small": (None, 448, 1500),
}
TP19_SEED, TP19_F32_RTOL = 19, 1e-4
TP19_LAUNCHES: dict = {}
# TPU kernel each CUDA kernel replaces, and its source in this repo.
NOMA_SOURCE = "src/repro_torch/kernels/csrc/noma_rates.cu"
TPU_KERNELS = {
    "noma_cell_intra": ("src/repro/kernels/noma_rates.py:280", NOMA_SOURCE),
    "noma_per_ap": ("src/repro/kernels/noma_rates.py:355", NOMA_SOURCE),
    "noma_ap_contract": ("src/repro/kernels/noma_rates.py:409", NOMA_SOURCE),
    "flash_attention": ("src/repro/kernels/flash_attention.py:75",
                        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "rg_lru": ("src/repro/kernels/rg_lru.py:41", "src/repro_torch/kernels/csrc/rg_lru.cu"),
    # no TPU kernel: the JAX package takes jax.grad through its jnp core
    "flash_attention_bwd": ("src/repro/models/attention.py:46 (_chunked_mha's gradient; "
                            "no pallas_call)",
                            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"),
    # no TPU kernel: the JAX package takes jax.grad through its associative scan
    "rg_lru_bwd": ("src/repro/models/recurrent.py:56 (_rglru_scan's gradient; no "
                   "pallas_call)", "src/repro_torch/kernels/csrc/rg_lru_bwd.cu"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def wait_for_memory(torch) -> None:
    """Wait, at most MEMORY_WAIT_S, until MEMORY_NEED_BYTES of the card are
    free: a process that is ending may still hold most of its memory. Go on
    after the wait either way, and say what was found."""
    t0 = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    first = free
    while free < MEMORY_NEED_BYTES and time.perf_counter() - t0 < MEMORY_WAIT_S:
        time.sleep(2.0)
        free, total = torch.cuda.mem_get_info()
    waited = time.perf_counter() - t0
    note = "" if free >= MEMORY_NEED_BYTES else (
        f"; still short of the {MEMORY_NEED_BYTES / 2**30:.0f} GiB the script needs")
    print(f"memory: {first / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB at the start, "
          f"{free / 2**30:.2f} GiB after {waited:.1f} s{note}")


# the peak reserve a sub-phase that measures its own (mesh_graph_checks)
# found before it reset the allocator's peak, for the next memory_mark
PEAK_BEFORE = {"bytes": 0}


def memory_mark(torch, label: str, peaks: dict) -> None:
    """Keep the allocator's peak reserve since the last mark under label."""
    peaks[label] = max(torch.cuda.max_memory_reserved(), PEAK_BEFORE["bytes"])
    PEAK_BEFORE["bytes"] = 0
    torch.cuda.reset_peak_memory_stats()


def row_scale(want):
    """Per-element scale of a (U, M) tensor: the largest magnitude in its
    row; of a vector or scalar: its own magnitude."""
    import torch
    a = want.detach().abs()
    return torch.amax(a, dim=-1, keepdim=True) if a.ndim >= 2 else a


def power_scale(g_p, g_beta, beta, p, dp_dx: float = 1.0):
    """Per-user scale of a power gradient g_p whose power p also enters
    through tx = beta * p: |g_p| plus dp/dx * sum_m |g_beta| * beta / p,
    the magnitude of its terms through tx. Its terms have both signs, so
    |g_p| alone can sit far below the rounding of its sum."""
    import torch
    return g_p.abs() + dp_dx * torch.sum(g_beta.abs() * beta, dim=-1) / p


def check(name: str, got, want, rtol: float, scale, errs: dict | None = None,
          key=None):
    """Fail unless |got - want| <= rtol * scale element by element."""
    import torch
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    diff = torch.abs(got - want)
    err = float(torch.max(diff))
    worst = float(torch.max(diff / torch.clamp_min(scale, 1e-38)))
    print(f"check {name}: max_abs_err={err:.3e} max_scaled_err={worst:.3e} tol={rtol:g}")
    if not bool((diff <= rtol * scale).all()):
        fail(f"{name}: error {worst:.3e} of the element's scale, above {rtol:g}")
    if errs is not None:
        errs[key] = max(errs.get(key, 0.0), err)


def check_plan(name: str, st, env, n_layers: int) -> None:
    """Fail unless one environment's plan is finite and feasible: beta rows
    on the floored simplex, powers and compute units in their boxes,
    subchannels in range."""
    import torch
    plan, rc, cc = st.plan, env.radio, env.comp
    for field in ("p_up", "p_dn", "r", "utility", "per_layer_utility"):
        if not bool(torch.isfinite(getattr(plan, field)).all()):
            fail(f"{name}: {field} not finite")
    s = int(plan.s)
    if not 0 <= s <= n_layers:
        fail(f"{name}: s*={s} out of range")
    for key in ("beta_up", "beta_dn"):
        b = st.norms[key][s]
        if float((b.sum(1) - 1).abs().max()) > 1e-4 or float(b.min()) < rc.beta_min - 1e-6:
            fail(f"{name}: {key} rows off the floored simplex")
    for field, lo, hi in (("p_up", rc.p_up_min_w, rc.p_up_max_w),
                          ("p_dn", rc.p_dn_min_w, rc.p_dn_max_w),
                          ("r", cc.r_min, cc.r_max)):
        x = getattr(plan, field)
        if float(x.min()) < lo * (1 - 1e-6) or float(x.max()) > hi * (1 + 1e-6):
            fail(f"{name}: {field} outside [{lo}, {hi}]")
    for field in ("sub_up", "sub_dn"):
        x = getattr(plan, field)
        if int(x.min()) < 0 or int(x.max()) >= env.n_sub:
            fail(f"{name}: {field} outside [0, {env.n_sub})")


def device_ms(fns, reps: int = 20, trials: int = 7) -> float:
    """Median device milliseconds of one call, from CUDA events around a
    CUDA graph of `reps` calls cycling through `fns` (so no host gap sits
    between launches)."""
    import torch
    for f in fns:
        f()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


# Labels of the profiled windows that recorded no device time and were
# measured once more (printed at the end).
PROFILE_RETRIES: list = []


class KernelRow:
    """One kernel name's device time in a profiled window (the fields of a
    key_averages row that the phases read)."""
    __slots__ = ("key", "count", "self_device_time_total", "device_type")

    def __init__(self, key, device_type):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0
        self.device_type = device_type


def kernel_rows(prof) -> list:
    """The device rows of a profiled window straight from its kineto
    events, by kernel name: what key_averages gives for them, without
    building the host events (minutes for the sLSTM loop's million). The
    window's pads (graphs.traced) are left out."""
    from torch.autograd import DeviceType
    from repro_torch import graphs
    rows: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or graphs.PAD_KERNEL in e.name():
            continue
        row = rows.setdefault(e.name(), KernelRow(e.name(), DeviceType.CUDA))
        row.count += 1
        row.self_device_time_total += e.duration_ns() / 1e3
    return list(rows.values())


def profiled(fn, label: str, prep=None, fast: bool = False):
    """fn() in a graphs.traced() window (torch.profiler, CPU and CUDA
    activities), timed to a synchronize: (profile, wall s, fn's result, the
    device rows of key_averages, busy us); with ``fast``, the rows of
    kernel_rows. The window's pads are outside the wall and the rows. A
    window that records no device time is measured once more, after
    prep() when given (to reset what fn counts); the phase fails only if
    the retry is empty too. Each retry is printed and kept in
    PROFILE_RETRIES."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch import graphs
    for attempt in range(2):
        if attempt:
            PROFILE_RETRIES.append(label)
            print(f"profile {label}: torch.profiler recorded no device time; the window is "
                  f"measured once more")
            if prep is not None:
                prep()
        with graphs.traced() as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = kernel_rows(prof) if fast else [
            e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and graphs.PAD_KERNEL not in e.key]
        busy_us = sum(e.self_device_time_total for e in rows)
        if busy_us > 0:
            return prof, wall, out, rows, busy_us
    fail(f"{label}: torch.profiler recorded no device time, in the window and in its retry")


def pool_bytes(torch, pool) -> int | None:
    """Bytes of the allocator's segments in one graph memory pool (None if
    this torch's memory snapshot does not name pools)."""
    segs = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segs):
        return None
    return sum(seg["total_size"] for seg in segs if tuple(seg["segment_pool_id"]) == tuple(pool))


def program_report(label: str, eng, smi: str) -> dict:
    """Print each compiled program of an engine (kind, env shape, graphs,
    capture seconds) and the engine's graph pool; return them."""
    import torch
    progs = [dict(kind=key[0], shape=key[1], graphs=prog.graph_count,
                  capture_s=prog.capture_s) for key, prog in eng._cache.items()]
    report = dict(programs=progs, pool_bytes=pool_bytes(torch, eng._pool))
    for p in progs:
        print(f"{label} program {p['kind']} {p['shape']}: {p['graphs']} CUDA graphs, "
              f"capture_s={p['capture_s']:.4f}")
    print(f"{label} graph pool: {report['pool_bytes']} bytes | {smi}")
    return report


def graph_steps(eng, kind: str, env, n_steps: int):
    """(replays, per_replay) for n_steps replays of the engine's captured GD
    step of split 4 (the program of (kind, env), already built) in
    gd_solve's chunks, one read of the stop flag a chunk: replays() runs
    them with a pair of CUDA events recorded around each replay and returns
    the pairs; per_replay is what one replay adds to the NOMA counters."""
    import torch
    from repro_torch.core import li_gd
    from repro_torch.kernels import noma_rates as nr
    prog = eng.program(kind, env)
    step_graph = prog._graphs[(4, env.radio, env.comp)]
    per_replay = {k: v for c, added in step_graph.added if c is nr.LAUNCHES
                  for k, v in added.items()}
    done = prog._live["done"]
    chunks, k = [], 1
    while sum(chunks) < n_steps:
        chunks.append(min(k, n_steps - sum(chunks)))
        k = min(2 * k, li_gd.SYNC_EVERY)

    def replays():
        marks = []
        for k in chunks:
            for _ in range(k):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                step_graph.replay()
                b.record()
                marks.append((a, b))
            bool(done.all())
        return marks
    return replays, per_replay, chunks


def replays_ran(marks) -> tuple[int, list]:
    """(replays the device ran, their ms): a replay ran when its events span
    at least half the median replay (one that launched nothing spans
    microseconds). The events must have completed."""
    ms = [a.elapsed_time(b) for a, b in marks]
    med = statistics.median(ms)
    return sum(t >= 0.5 * med for t in ms), ms


def trace_ends(prof, n: int = 8) -> tuple[list, list, int]:
    """(first n, last n) device kernel names of a profiled window in start
    order, and how many of its records are the window's pads."""
    from torch.autograd import DeviceType
    from repro_torch import graphs
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA), key=lambda e: e.start_ns())
    pads = sum(graphs.PAD_KERNEL in e.name() for e in evs)
    names = [e.name()[:48] for e in evs]
    return names[:n], names[-n:], pads


# (windows, replay counts) of the census profile_graph_steps takes before
# it traces, set by census_main; None in a run of main.
CENSUS: tuple | None = None


def profile_graph_steps(eng, kind: str, env, n_steps: int, label: str, eager: tuple | None,
                        smi: str) -> float:
    """n_steps replays of the engine's captured GD step of split 4 (the
    program of (kind, env), already built) in a traced window (profiled);
    printed beside the eager (ms a step, busy share). What the replays'
    bookkeeping added to the counters must equal the replays the device
    ran (CUDA events around each) times the launches one replay captured,
    and the NOMA kernels on the device trace must equal it too. A trace
    that comes back short while every replay ran (the profiler lost kernel
    records: ROADMAP section 3) is measured once more, and kept in
    PROFILE_RETRIES; a second short trace fails. ``eager`` (ms a step, busy
    share) is printed beside when given. Returns the profiled wall ms a
    step."""
    from repro_torch import graphs
    from repro_torch.kernels import noma_rates as nr
    if CENSUS is not None:
        for pad in (False, True):
            for n in CENSUS[1]:
                window_census(eng, kind, env, n, CENSUS[0], label, smi, pad)
    replays, per_replay, chunks = graph_steps(eng, kind, env, n_steps)
    want = {k: v * n_steps for k, v in per_replay.items()}
    for attempt in range(2):
        nr.reset_launches()
        prof_g, wall, marks, rows, busy = profiled(replays, f"{label} (graphed steps)",
                                                   nr.reset_launches)
        ran, _ = replays_ran(marks)
        print(f"check {label}: {ran} of {n_steps} replays ran on the device (CUDA events); "
              f"the replays counted {dict(nr.LAUNCHES)}, {per_replay} a replay")
        if ran != n_steps or nr.LAUNCHES != want:
            fail(f"{label}: the device ran {ran} of {n_steps} replays, counted "
                 f"{dict(nr.LAUNCHES)} for {want}")
        seen = {k: n for k, n in graphs.kernel_launches(prof_g).items() if k in nr.LAUNCHES}
        print(f"check {label}: NOMA kernels on the device trace of the replays {seen}, counted "
              f"by the replays {dict(nr.LAUNCHES)}: {seen == nr.LAUNCHES}")
        if seen == nr.LAUNCHES:
            break
        first, last, pads = trace_ends(prof_g)
        print(f"profile {label}: the short trace's first kernels {first}, last {last}, "
              f"{pads} of its {2 * graphs.PAD_KERNELS} pad records")
        if attempt:
            fail(f"{label}: the trace held {seen} twice, the replays ran {dict(nr.LAUNCHES)}")
        PROFILE_RETRIES.append(f"{label} (trace short of the replays that ran)")
        print(f"profile {label}: the trace is short of the {n_steps} replays that ran; the "
              "window is measured once more")
    busy /= 1e6
    kernels = sum(e.count for e in rows)
    beside = "" if eager is None else (f"; eager per_step_ms={eager[0] * 1e3:.3f} "
                                       f"busy_share={eager[1]:.4f}")
    print(f"{label} {n_steps} step replays in chunks {chunks} (profiled): wall_s={wall:.4f} "
          f"per_step_ms={wall / n_steps * 1e3:.4f} device_busy_s={busy:.4f} "
          f"busy_ms_per_step={busy / n_steps * 1e3:.4f} busy_share={busy / wall:.4f} "
          f"kernels_per_step={kernels / n_steps:.1f}{beside} | {smi}")
    return wall / n_steps * 1e3


def window_census(eng, kind: str, env, n_steps: int, n_windows: int, label: str,
                  smi: str, pad: bool) -> list[dict]:
    """n_windows traced windows of graph_steps' n_steps replays, each
    counted three ways: the NOMA kernels on the torch.profiler trace, what
    the replays' bookkeeping (graphs.Graph.replay) added to LAUNCHES, and
    the replays the device ran by their CUDA events (replays_ran); and the
    device's kernel records on the trace, pads left out. ``pad``: the
    windows are graphs.traced()'s, else bare torch.profiler windows (as
    the traces were taken before the pads). Returns a dict a window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import graphs
    from repro_torch.kernels import noma_rates as nr
    replays, per_replay, _ = graph_steps(eng, kind, env, n_steps)
    out = []
    for _ in range(n_windows):
        nr.reset_launches()
        if pad:
            with graphs.traced() as prof:
                marks = replays()
        else:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                marks = replays()
                torch.cuda.synchronize()
        ran, _ = replays_ran(marks)
        out.append(dict(trace={k: n for k, n in graphs.kernel_launches(prof).items()
                               if k in nr.LAUNCHES},
                        counted=dict(nr.LAUNCHES), ran=ran,
                        records=sum(r.count for r in kernel_rows(prof)),
                        pads=trace_ends(prof)[2]))
    want = {k: v * n_steps for k, v in per_replay.items()}
    short = [i for i, w in enumerate(out) if w["trace"] != w["counted"]]
    missed = [i for i, w in enumerate(out) if w["ran"] != n_steps or w["counted"] != want]
    recs = [w["records"] for w in out]
    print(f"census {label} {'padded' if pad else 'bare'}: {n_windows} traced windows of "
          f"{n_steps} replays, a replay {per_replay}; windows whose trace differs from the "
          f"counted launches {len(short)} ({[out[i]['trace'] for i in short]}); windows "
          f"where fewer replays ran on the device than were counted {len(missed)}; kernel "
          f"records a window min/median/max {min(recs)} / {statistics.median(recs)} / "
          f"{max(recs)}, pad records kept min {min(w['pads'] for w in out)} of "
          f"{2 * graphs.PAD_KERNELS if pad else 0} | {smi}")
    return out


def census_main(windows: int = 8, lengths: tuple = (40, 8)) -> int:
    """The census behind ROADMAP section 3's fleet-window entry (not a phase
    of main): main, with window_census taken before each graphed window
    that profile_graph_steps traces (phase 4's one env, phase 7's fleet,
    17.1's sharded fleet): ``windows`` windows of each of ``lengths``
    replays, bare and padded. Run on the card:
    python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.census_main())"."""
    global CENSUS
    CENSUS = (windows, lengths)
    return main()


def main() -> int:
    import gc
    t_start = time.perf_counter()
    # phase 6 holds 12.6 GB logit tensors beside 19 GB of weights: let the
    # allocator grow segments rather than fragment them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import GdConfig, channel, li_gd, make_env, profiles
    from repro_torch.core.utility import utility
    from repro_torch.kernels import build, build_cell_layout, ops
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.planning import PlannerEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # einsum reference in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # -- 1. device ------------------------------------------------------------
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    wait_for_memory(torch)
    peaks: dict = {}

    # -- 2. build: one nvcc per source, all at once ---------------------------
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(build.SIGNATURES)}; sm_90a)")
    for name, info in build.BUILD_INFO.items():
        print(f"  {name}.cu: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    # -- 3. kernels against their plain twins --------------------------------
    env = make_env(U, N, M, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    e = torch.empty((U, M), device=dev).exponential_(generator=gen)
    beta = e / e.sum(1, keepdim=True)
    p_up = 1e-3 + 0.3 * torch.rand(U, device=dev, generator=gen)
    p_dn = 0.1 + 9.9 * torch.rand(U, device=dev, generator=gen)
    cot = torch.randn((U, M), device=dev, generator=gen)
    layout = build_cell_layout(env)
    print(f"env: U={U} N={N} M={M}; CellLayout {layout.n_tiles} tiles vs "
          f"{layout.dense_n_tiles()} dense (blocks {layout.block_u}x{layout.block_v})")
    errs: dict = {}
    for uplink in (True, False):
        link = "up" if uplink else "dn"
        p = p_up if uplink else p_dn
        for sched in ("dense", "layout"):
            used = env if sched == "dense" else layout.env
            own, g_raw, ap = ops._inputs(used, uplink)
            tx = (beta * p[:, None])
            if sched == "layout":
                tx = tx.index_select(0, layout.perm)
            tx = tx.contiguous()
            w_in = (tx * own).contiguous() if uplink else tx
            bu = bv = nr.BLOCK_U
            if sched == "dense":
                fwd = nr.dense_csr(-(-U // bu), -(-U // bv), dev)
                bwd = fwd
            else:
                fwd = (layout.fwd_row_ptr, layout.fwd_col)
                bwd = (layout.bwd_row_ptr, layout.bwd_col)
            for direction, csr, w_s, desc in (("fwd", fwd, w_in, uplink),
                                              ("bwd", bwd, cot, not uplink)):
                args = (own, own, w_s, ap, ap, *csr, bu, bv, desc)
                scale = nr.noma_cell_intra_plain(own, own, w_s.abs(), *args[3:])
                check(f"noma_cell_intra {link} {direction} {sched}",
                      nr.noma_cell_intra(*args), nr.noma_cell_intra_plain(*args),
                      KERNEL_RTOL, scale, errs, "noma_cell_intra")
                if sched == "dense":   # the main path's kernel: per-cell work
                    d_args = (own, own, w_s, ap, ap, N, desc)
                    check(f"noma_cell_intra_dense {link} {direction}",
                          nr.noma_cell_intra_dense(*d_args),
                          nr.noma_cell_intra_dense_plain(*d_args), KERNEL_RTOL, scale, errs,
                          "noma_cell_intra")
        own, g_raw, ap = ops._inputs(env, uplink)
        tx = (beta * p[:, None]).contiguous()
        if uplink:   # forward table A, backward contraction of C
            check("noma_per_ap up fwd", nr.noma_per_ap(ap, tx, g_raw, True),
                  nr.noma_per_ap_plain(ap, tx, g_raw, True), KERNEL_RTOL,
                  nr.noma_per_ap_plain(ap, tx, g_raw, True), errs, "noma_per_ap")
            c_nm = nr.segment_table(cot, ap, N)
            check("noma_ap_contract up bwd", nr.noma_ap_contract(ap, c_nm, g_raw, True),
                  nr.noma_ap_contract_plain(ap, c_nm, g_raw, True), KERNEL_RTOL,
                  nr.noma_ap_contract_plain(ap, c_nm.abs(), g_raw, True), errs,
                  "noma_ap_contract")
        else:        # forward contraction of B, backward table D
            b_nm = nr.segment_table(tx, ap, N)
            check("noma_ap_contract dn fwd", nr.noma_ap_contract(ap, b_nm, g_raw, False),
                  nr.noma_ap_contract_plain(ap, b_nm, g_raw, False), KERNEL_RTOL,
                  nr.noma_ap_contract_plain(ap, b_nm, g_raw, False), errs,
                  "noma_ap_contract")
            check("noma_per_ap dn bwd", nr.noma_per_ap(ap, cot, g_raw, False),
                  nr.noma_per_ap_plain(ap, cot, g_raw, False), KERNEL_RTOL,
                  nr.noma_per_ap_plain(ap, cot.abs(), g_raw, False), errs, "noma_per_ap")

    # per_ap sums in an order fixed by the shapes alone: two launches on the
    # same inputs give the same bits, in both layouts.
    for uplink in (True, False):
        own, g_raw, ap = ops._inputs(env, uplink)
        w_t = (beta * p_up[:, None]).contiguous() if uplink else cot
        first = nr.noma_per_ap(ap, w_t, g_raw, uplink)
        second = nr.noma_per_ap(ap, w_t, g_raw, uplink)
        print(f"check noma_per_ap {'up' if uplink else 'dn'} two launches bit-identical: "
              f"{torch.equal(first, second)}")
        if not torch.equal(first, second):
            fail("noma_per_ap: two launches on the same inputs differ")
    del first, second

    # The dense kernel on skewed cells: one cell holding half the users, one
    # cell empty (its users moved to cell 0), both SIC orders.
    own_sk, _, ap_sk = ops._inputs(env, True)
    ap_sk = ap_sk.clone()
    ap_sk[: U // 2] = 1
    ap_sk[ap_sk == N - 1] = 0
    sizes = torch.bincount(ap_sk.long(), minlength=N)
    w_sk = (beta * p_up[:, None] * own_sk).contiguous()
    for desc in (True, False):
        d_args = (own_sk, own_sk, w_sk, ap_sk, ap_sk, N, desc)
        check(f"noma_cell_intra_dense skewed cells {sizes.tolist()} descending={desc}",
              nr.noma_cell_intra_dense(*d_args), nr.noma_cell_intra_dense_plain(*d_args),
              KERNEL_RTOL, nr.noma_cell_intra_dense_plain(*d_args), errs, "noma_cell_intra")
    del own_sk, ap_sk, w_sk

    # Whole rates and their gradients, through the channel functions the
    # engine drives: kernel backend vs einsum.
    for uplink in (True, False):
        link = "up" if uplink else "dn"
        p = p_up if uplink else p_dn
        rate_fn = channel.uplink_rates if uplink else channel.downlink_rates
        b0 = beta.clone().requires_grad_(True)
        q0 = p.clone().requires_grad_(True)
        want = rate_fn(env, b0, q0, backend="einsum")
        g_want = torch.autograd.grad((want * cot).sum(), [b0, q0])
        p_scale = power_scale(g_want[1], g_want[0], beta, p)
        for sched, lay in (("dense", None), ("layout", layout)):
            got = rate_fn(env, b0, q0, backend="kernel", layout=lay)
            g_got = torch.autograd.grad((got * cot).sum(), [b0, q0])
            check(f"rates {link} {sched}", got.detach(), want.detach(), PATH_RTOL,
                  row_scale(want))
            check(f"d rates/d beta {link} {sched}", g_got[0], g_want[0], PATH_RTOL,
                  row_scale(g_want[0]))
            check(f"d rates/d p {link} {sched}", g_got[1], g_want[1], PATH_RTOL, p_scale)
        del want, g_want
    torch.cuda.empty_cache()

    # Times at the main path's shapes (dense schedule): the uplink intra, the
    # per-AP table in both layouts (uplink forward table A, downlink backward
    # table D), the downlink contraction. The gain
    # kernels cycle through 4 copies of their inputs (85 MB) so the gain is
    # not served from the 50 MB L2 cache on every launch.
    own_up, g_up, ap = ops._inputs(env, True)
    _, g_dn, _ = ops._inputs(env, False)
    tx_up = (beta * p_up[:, None]).contiguous()
    tx_dn = (beta * p_dn[:, None]).contiguous()
    w_in = (tx_up * own_up).contiguous()
    csr = nr.dense_csr(-(-U // nr.BLOCK_U), -(-U // nr.BLOCK_V), dev)
    intra_args = (own_up, own_up, w_in, ap, ap, *csr, nr.BLOCK_U, nr.BLOCK_V, True)
    dense_args = (own_up, own_up, w_in, ap, ap, N, True)
    copies = 4
    g_ups = [g_up.clone() for _ in range(copies)]
    g_dns = [g_dn.clone() for _ in range(copies)]
    b_nm = nr.segment_table(tx_dn, ap, N)
    other = (ap[:, None] != torch.arange(N, device=dev, dtype=ap.dtype)).float()
    counts = torch.bincount(ap.long(), minlength=N).double()
    same_triples = float((counts * counts).sum()) * M
    # The intra term as one library call: the (r, s, m) mask same & cmp is
    # fixed while the gains are (a whole GD solve), so it is built once,
    # outside the timed window, and stored (M, R, S) so the einsum is one
    # batched matrix-vector product with no copy of the 1.56 GB mask.
    same = ap[:, None] == ap[None, :]
    mask = ((own_up[None, :, :] < own_up[:, None, :]) & same[:, :, None])
    mask = mask.permute(2, 0, 1).float().contiguous()
    check("noma_cell_intra library einsum vs plain",
          torch.einsum("mrs,sm->rm", mask, w_in), nr.noma_cell_intra_dense_plain(*dense_args),
          KERNEL_RTOL, nr.noma_cell_intra_dense_plain(own_up, own_up, w_in.abs(),
                                                      *dense_args[3:]))
    f4 = 4
    # Bytes each input read once, each output written once; own and ap are
    # one tensor in both roles. The operations of intra are instructions
    # (compare, select, add) per same-cell triple at the non-FMA rate; of
    # per_ap and contract, a multiply-add per (w, n, m) at the FLOP rate.
    # intra is timed as the main path runs it (the dense per-cell kernel);
    # the CSR kernel on the dense tile list is timed beside it.
    timing = {
        "noma_cell_intra": dict(
            kernel=[lambda: nr.noma_cell_intra_dense(*dense_args)],
            plain=[lambda: nr.noma_cell_intra_dense_plain(*dense_args)],
            library=[lambda: torch.einsum("mrs,sm->rm", mask, w_in)],
            bytes=f4 * (3 * U * M + U),
            ops_s=3 * same_triples / FP32_INSTR_PER_S),
        "noma_per_ap": dict(
            kernel=[lambda g=g: nr.noma_per_ap(ap, tx_up, g, True) for g in g_ups],
            plain=[lambda g=g: nr.noma_per_ap_plain(ap, tx_up, g, True) for g in g_ups],
            library=[lambda g=g: torch.einsum("wn,wm,wnm->nm", other, tx_up, g)
                     for g in g_ups],
            bytes=f4 * (U * N * M + U * M + U + N * M),
            ops_s=2 * U * N * M / FP32_OPS_PER_S),
        "noma_per_ap dn": dict(
            kernel=[lambda g=g: nr.noma_per_ap(ap, cot, g, False) for g in g_dns],
            plain=[lambda g=g: nr.noma_per_ap_plain(ap, cot, g, False) for g in g_dns],
            library=[lambda g=g: torch.einsum("wn,wm,nwm->nm", other, cot, g)
                     for g in g_dns],
            bytes=f4 * (U * N * M + U * M + U + N * M),
            ops_s=2 * U * N * M / FP32_OPS_PER_S),
        "noma_ap_contract": dict(
            kernel=[lambda g=g: nr.noma_ap_contract(ap, b_nm, g, False) for g in g_dns],
            plain=[lambda g=g: nr.noma_ap_contract_plain(ap, b_nm, g, False)
                   for g in g_dns],
            library=[lambda g=g: torch.einsum("wn,nwm,nm->wm", other, g, b_nm)
                     for g in g_dns],
            bytes=f4 * (U * N * M + N * M + U + U * M),
            ops_s=2 * U * N * M / FP32_OPS_PER_S),
    }
    # A streaming yardstick for per_ap: one reduction over the same gain
    # bytes (what this card streams at that size; never called by the port).
    timing["noma_per_ap"]["stream"] = [lambda g=g: torch.sum(g, 0) for g in g_ups]
    timing["noma_per_ap dn"]["stream"] = [lambda g=g: torch.sum(g, 1) for g in g_dns]
    rows = {}
    for name, t in timing.items():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["ops_s"] * 1e3
        rows[name] = {
            "ms": device_ms(t["kernel"]),
            "plain_ms": device_ms(t["plain"], reps=4),
            "library_ms": device_ms(t["library"]),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        if "stream" in t:
            rows[name]["stream_ms"] = device_ms(t["stream"])
        rows[name]["bound_share"] = rows[name]["bound_ms"] / rows[name]["ms"]
        print(f"time {name}: " + " ".join(f"{k}={v}" for k, v in rows[name].items())
              + f" | {smi}")
    # The downlink layout (backward table D) rides in the per_ap row.
    rows["noma_per_ap"]["downlink"] = rows.pop("noma_per_ap dn")
    # The CSR kernel on the dense tile list, in turns with the dense kernel.
    csr_ms = [device_ms([lambda: nr.noma_cell_intra(*intra_args)]),
              device_ms([lambda: nr.noma_cell_intra_dense(*dense_args)]),
              device_ms([lambda: nr.noma_cell_intra(*intra_args)])]
    rows["noma_cell_intra"]["csr_dense_ms"] = min(csr_ms[0], csr_ms[2])
    print(f"time noma_cell_intra: CSR kernel on the dense tile list {csr_ms[0]} / {csr_ms[2]} "
          f"ms against the dense per-cell kernel {rows['noma_cell_intra']['ms']} / {csr_ms[1]} "
          f"ms; the tile list visits {U * U * M:.3e} (r,s,m) triples, "
          f"{3 * U * U * M / FP32_INSTR_PER_S * 1e3:.4f} ms of instructions; the data "
          f"needs {same_triples:.3e} same-cell triples")
    if not rows["noma_cell_intra"]["ms"] < rows["noma_cell_intra"]["csr_dense_ms"]:
        fail("the dense per-cell intra kernel is not faster than the CSR kernel on the "
             "dense tile list")
    del g_ups, g_dns, timing, mask
    torch.cuda.empty_cache()

    memory_mark(torch, "1-3", peaks)
    # -- 4. the main path ------------------------------------------------------
    prof = profiles.nin()
    eng = PlannerEngine(prof, cfg=GdConfig(optimizer="adam", max_iters=MAX_ITERS),
                        sinr_backend="kernel")

    def perturb(e0, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        up = e0.g_up * torch.exp(0.03 * torch.randn(e0.g_up.shape, device=dev, generator=g))
        dn = e0.g_dn * torch.exp(0.03 * torch.randn(e0.g_dn.shape, device=dev, generator=g))
        return type(e0)(g_up=up, g_dn=dn, ap=e0.ap, radio=e0.radio, comp=e0.comp)

    env1 = perturb(env, 11)
    env2 = perturb(env1, 12)
    torch.cuda.synchronize()
    nr.reset_launches()
    li_gd.reset_counts()
    walls, states, steps, reads, call_launches = [], [], [], [], []
    prev = None
    for e_i in (env, env1, env2):
        t0 = time.perf_counter()
        before, l0 = dict(li_gd.COUNTS), dict(nr.LAUNCHES)
        prev = eng.plan(e_i) if prev is None else eng.replan(prev, e_i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        steps.append(li_gd.COUNTS["steps"] - before["steps"])
        reads.append(li_gd.COUNTS["host_reads"] - before["host_reads"])
        call_launches.append({k: v - l0[k] for k, v in nr.LAUNCHES.items()})
        states.append(prev)
    launches = dict(nr.LAUNCHES)
    splits = prof.n_layers + 1
    for name, st, wall, n_steps, n_reads in zip(("plan", "replan1", "replan2"), states,
                                                walls, steps, reads):
        plan = st.plan
        rho = None if st.warm_rho is None else float(st.warm_rho)
        print(f"main {name}: s*={int(plan.s)} total_iters={int(st.total_iters)} "
              f"iters={plan.iters.tolist()} warm_rho={rho} "
              f"wall_s={wall:.3f} steps_run={n_steps} host_reads={n_reads} "
              f"utility={float(plan.utility):.6g}")
    print(f"main launches: {launches}")
    # Every utility evaluation goes through the kernels (plan_launches): per
    # split one start evaluation; per plan two discrete-utility
    # evaluations; per replan split two warm probes.
    total_steps = sum(steps)
    expect = plan_launches(total_steps, splits * 3 + 2 * 3 + 2 * splits * 2)
    print(f"main launches expected from {total_steps} steps: {expect}; per GD step "
          f"intra 6, per_ap 3, contract 3")
    for k, v in launches.items():
        if v <= 0:
            fail(f"{k} was not launched on the main path")
        if v != expect[k]:
            fail(f"{k}: {v} launches on the main path, expected {expect[k]}")

    for name, st in zip(("plan", "replan1", "replan2"), states):
        check_plan(name, st, env, prof.n_layers)
    print("main plan checks: finite, beta rows on the floored simplex, powers and r in "
          "their boxes, subchannels in range")
    graphs = program_report("main", eng, smi)
    main = dict(eng=eng, envs=(env, env1, env2), states=states, walls=walls, steps=steps,
                launches=call_launches, graphs=graphs)

    # The utility and its gradient at the cold start of split 3: kernel vs einsum.
    norm0 = li_gd._project(li_gd.cold_init(env), env.radio.beta_min)
    w = eng._w(env, None)
    vals = {}
    for backend in ("kernel", "einsum"):
        x = {k: v.clone().requires_grad_(True) for k, v in norm0.items()}
        gamma = utility(env, eng.prof, 3, li_gd.to_physical(x, env), w, backend=backend)
        grads = torch.autograd.grad(gamma, [x[k] for k in li_gd.KEYS])
        vals[backend] = (gamma.detach(), grads)
    want = vals["einsum"][0].reshape(1)
    check("utility kernel vs einsum", vals["kernel"][0].reshape(1), want, PATH_RTOL,
          want.abs())
    g_e = dict(zip(li_gd.KEYS, vals["einsum"][1]))
    phys = li_gd.to_physical(norm0, env)
    rc = env.radio
    scales = {
        "beta_up": row_scale(g_e["beta_up"]), "beta_dn": row_scale(g_e["beta_dn"]),
        "p_up": power_scale(g_e["p_up"], g_e["beta_up"], phys.beta_up, phys.p_up,
                            rc.p_up_max_w - rc.p_up_min_w),
        "p_dn": power_scale(g_e["p_dn"], g_e["beta_dn"], phys.beta_dn, phys.p_dn,
                            rc.p_dn_max_w - rc.p_dn_min_w),
        "r": row_scale(g_e["r"])}
    for k, gk in zip(li_gd.KEYS, vals["kernel"][1]):
        check(f"d utility/d {k} kernel vs einsum", gk, g_e[k], PATH_RTOL, scales[k])

    memory_mark(torch, "4", peaks)
    # -- 5. where the time goes: 40 GD steps under torch.profiler -------------
    # A window of the step that dominates the path (a full replan yields
    # ~0.5 M kernel events, minutes of profiler post-processing).
    prof_cfg = GdConfig(optimizer="adam", max_iters=40, eps=0.0, sinr_backend="kernel")
    start = li_gd.cold_init(env2)
    li_gd.gd_solve(env2, eng.prof, 4, w, start, prof_cfg)      # warm-up
    li_gd.reset_counts()
    prof, wall, _, rows_k, busy_us = profiled(
        lambda: li_gd.gd_solve(env2, eng.prof, 4, w, start, prof_cfg), "gd_solve split 4",
        li_gd.reset_counts)
    n_steps = li_gd.COUNTS["steps"]
    launches_k = sum(e.count for e in rows_k)
    print(f"profile gd_solve split 4, {n_steps} steps (profiled): wall_s={wall:.4f} "
          f"per_step_ms={wall / n_steps * 1e3:.3f} device_busy_s={busy_us / 1e6:.4f} "
          f"busy_share={busy_us / 1e6 / wall:.4f} kernel_launches={launches_k} "
          f"launches_per_step={launches_k / n_steps:.1f}")
    for e in sorted(rows_k, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile kernel {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.self_device_time_total / busy_us:6.1%} {e.count:6d} launches  {e.key[:80]}")
    eager_step = (wall / n_steps, busy_us / 1e6 / wall)
    del prof, rows_k
    profile_graph_steps(eng, "plan", env, n_steps, "profile graphed gd_solve split 4",
                        eager_step, smi)
    torch.cuda.empty_cache()

    memory_mark(torch, "5", peaks)
    # -- 6. serve recurrentgemma-9b --------------------------------------------
    serve_rows, serve_launches, model = serve_phase(dev, kind, smi, errs)
    rows.update(serve_rows)
    launches.update(serve_launches)

    memory_mark(torch, "6", peaks)
    # -- 7. a fleet ------------------------------------------------------------
    fleet_rows, fleet_path = fleet_phase(dev, smi, rows, eng.cfg)
    for name, fr in fleet_rows.items():
        rows[name].update(fr)

    memory_mark(torch, "7", peaks)
    # -- 8. the paper's comparison arms ---------------------------------------
    compare_phase(env, smi)

    memory_mark(torch, "8", peaks)
    # -- 9. the online split server over phase 6's model ----------------------
    online_phase(dev, smi, model, eng.cfg)

    memory_mark(torch, "9", peaks)
    # -- 10. the closed online loop -------------------------------------------
    loop_phase(dev, smi, model, env, errs)

    memory_mark(torch, "10", peaks)
    # -- 11. durable serving ---------------------------------------------------
    durable_phase(dev, smi, model)
    memory_mark(torch, "11", peaks)
    # -- 18.1 the compiled serve steps on a world-1 NCCL mesh, over phase 6's
    # weights (the rest of phase 18 runs last)
    for name, n in tp_graph_phase(dev, smi, model, errs).items():
        launches[name] = launches.get(name, 0) + n
    del model
    torch.cuda.empty_cache()

    memory_mark(torch, "18.1", peaks)
    # -- 12. the engine's compiled programs against the eager path -------------
    programs_phase(dev, smi, main, fleet_path)
    # phase 17 holds its sharded fleet to phase 7's states
    fleet_kept = {k: fleet_path[k] for k in ("cfg", "envs", "states", "walls")}
    del main, fleet_path
    torch.cuda.empty_cache()

    memory_mark(torch, "12", peaks)
    # -- 13. MoE and xLSTM serving ---------------------------------------------
    moe_row, moe_launches = moe_phase(dev, smi, errs)
    rows["flash_attention"]["deepseek"] = moe_row
    launches["flash_attention"] += moe_launches
    memory_mark(torch, "13.1", peaks)
    xlstm_phase(dev, smi)

    memory_mark(torch, "13.2", peaks)
    # -- 14. vision and audio serving -----------------------------------------
    for label, phase in (("14.1", vlm_phase), ("14.2", audio_phase)):
        phase_rows, phase_launches = phase(dev, smi, errs)
        rows["flash_attention"].update(phase_rows)
        launches["flash_attention"] += phase_launches
        memory_mark(torch, label, peaks)
    # -- 15. training ------------------------------------------------------------
    bwd_row, fwd_rows, train_launches = train_phase(dev, smi, errs, peaks)
    rows["flash_attention_bwd"] = bwd_row
    rows["flash_attention"].update(fwd_rows)
    launches["flash_attention"] += train_launches["flash_attention"]
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    # -- 17. sharding on a world-1 NCCL group, before 16: xlstm's million-event
    # profile in 16 leaves later traces short of kernel records (PR 26's final
    # call traced 238 of 240 intra launches there, twice)
    for name, n in sharding_phase(dev, smi, fleet_kept, errs, peaks).items():
        launches[name] += n
    del fleet_kept
    # -- 16. training the hybrid, MoE, vision, xLSTM and audio families --------------
    rows["rg_lru_bwd"], family_bwd_rows, family_launches = families_phase(dev, smi, errs, peaks)
    rows["flash_attention_bwd"].update(family_bwd_rows)
    for name in ("flash_attention", "flash_attention_bwd", "rg_lru"):
        launches[name] += family_launches[name]
    launches["rg_lru_bwd"] = family_launches["rg_lru_bwd"]
    memory_mark(torch, "16", peaks)
    # -- 18.3 the kernels at the per-rank shapes, then 18.2 two ranks on the
    # card over gloo, last: the main process holds little by now
    tp_flash, tp_rg, tp_keys = tp_kernel_phase(dev, smi, errs)
    gc.collect()
    torch.cuda.empty_cache()
    memory_mark(torch, "18.3", peaks)
    ranks = tp_ranks_phase(dev, smi)
    unchecked = sorted(k for k in ranks["shapes"] if k not in tp_keys.values())
    if unchecked:
        fail(f"tp 18.2: the ranks launched flash_attention at shapes 18.3 does not check "
             f"(query rows, Sq, Sk, hd, G, causal, window, kv_len): {unchecked}")
    for name, key in tp_keys.items():
        tp_flash[name]["launches"] = ranks["shapes"].get(key, 0)
    print(f"tp 18.2 flash_attention launches at 18.3's shapes: "
          f"{ {n: r['launches'] for n, r in tp_flash.items()} } (M=4's shapes run on no path "
          f"of one card)")
    rows["flash_attention"].update(tp_flash)
    rows["rg_lru"].update(tp_rg)
    for name, n in ranks["launched"].items():
        launches[name] = launches.get(name, 0) + n
    memory_mark(torch, "18.2 (main process)", peaks)
    # -- 19.3 flash at the other families' per-rank shapes, then 19.2 their
    # two ranks on the card over gloo; 19.1's mesh programs ran in 13-14
    tp19_flash, tp19_keys = tp_family_kernel_phase(dev, smi, errs)
    gc.collect()
    torch.cuda.empty_cache()
    memory_mark(torch, "19.3", peaks)
    ranks19 = tp_family_ranks_phase(dev, smi)
    unchecked = sorted(k for k in ranks19["shapes"] if k not in tp19_keys.values())
    if unchecked:
        fail(f"tp 19.2: the ranks launched flash_attention at shapes 19.3 does not check "
             f"(query rows, Sq, Sk, hd, G, causal, window, kv_len): {unchecked}")
    for name, key in tp19_keys.items():
        tp19_flash[name]["launches"] = ranks19["shapes"].get(key, 0)
    print(f"tp 19.2 flash_attention launches at 19.3's shapes: "
          f"{ {n: r['launches'] for n, r in tp19_flash.items()} } (M=4's shapes and the "
          f"served cross attention run on no path of one card)")
    rows["flash_attention"].update(tp19_flash)
    for source in (ranks19["launched"], TP19_LAUNCHES):
        for name, n in source.items():
            launches[name] = launches.get(name, 0) + n
    print(f"tp 19.1 mesh programs' launches (13.1, 13.2, 14.1, 14.2): {TP19_LAUNCHES}")
    memory_mark(torch, "19.2 (main process)", peaks)
    print(f"profile retries (windows with no device time, measured once more): "
          f"{PROFILE_RETRIES or 'none'}")
    print("memory: peak reserved by phase (GiB): " + ", ".join(
        f"{k} {v / 2**30:.2f}" for k, v in peaks.items()))
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": tpu, **rows[name],
                "launches": launches[name], "max_abs_err": errs[name]}
               for name, (tpu, src) in TPU_KERNELS.items()]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, peak "
          f"{max(peaks.values()) / 2**30:.2f} GiB reserved | {smi}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def serve_phase(dev, kind: str, smi: str, errs: dict):
    """Phase 6. Returns (timing rows, main-path launch counts) of the two
    served kernels and the full-size model (phase 9 serves it again); adds
    the kernels' worst errors to errs."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.kernels import rg_lru as rl
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Model, stages_for
    from repro_torch.runtime.serve import make_split_serve

    cfg = configs.get(SERVE_ARCH)
    H, KV, HD, W = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window
    B, S = SERVE_B, SERVE_S
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    # 6.1 the kernels against their plain twins at the served shapes
    def check_flash(tag, b, s_q, s_k, h, kv, hd, causal, window, kv_len=None,
                    dtype=torch.bfloat16):
        q = randn(b * h, s_q, hd, dtype=dtype)
        k = randn(b * kv, s_k, hd, dtype=dtype)
        v = randn(b * kv, s_k, hd, dtype=dtype)
        args = (h // kv, causal, window, kv_len)
        got = fa.flash_attention(q, k, v, *args)
        torch.cuda.synchronize()
        scale = fa.flash_attention_plain(q, k, v.abs(), *args).float()
        rtol = FLASH_RTOL if dtype == torch.bfloat16 else FLASH_F32_RTOL
        check(f"flash_attention {tag}", got.float(), fa.flash_attention_plain(q, k, v, *args)
              .float(), rtol, scale, errs, "flash_attention")
        return q, k, v, scale

    q, k, v, f_scale = check_flash(f"served B={B} S={S} H={H}/{KV} hd={HD} window {W}",
                                   B, S, S, H, KV, HD, True, W)
    check_flash("ragged S=1000 hd=64 G=4 causal", 2, 1000, 1000, 8, 2, 64, True, 0)
    check_flash("bidirectional S=1500 hd=128 G=4", 2, 1500, 1500, 8, 2, 128, False, 0)
    check_flash("ragged S=999 hd=32 G=1 causal", 2, 999, 999, 4, 4, 32, True, 0)
    check_flash("ragged Sq=1000 Sk=1100 hd=256 G=16 window 700", 1, 1000, 1100, 16, 1, 256,
                True, 700)
    check_flash("kv_len=1801 < Sk=2000 hd=256 G=16 bidirectional", 1, 1500, 2000, 16, 1, 256,
                False, 0, 1801)
    check_flash("kv_len=900 < Sk=1000 hd=32 G=4 causal", 2, 1000, 1000, 8, 2, 32, True, 0, 900)
    check_flash("float32 path S=1000 hd=128 G=4 causal", 2, 1000, 1000, 8, 2, 128, True, 0,
                None, torch.float32)

    log_a = -8.0 * torch.rand((B, S, cfg.rglru_dim), device=dev, generator=gen)
    x_b = randn(B, S, cfg.rglru_dim)
    h0 = randn(B, cfg.rglru_dim)
    for tag, h_init in (("no h0", None), ("h0", h0)):
        got = rl.rg_lru(log_a, x_b, h_init)
        torch.cuda.synchronize()
        scale = rl.rg_lru_plain(log_a, x_b.abs(), None if h_init is None else h_init.abs())
        want = rl.rg_lru_plain(log_a, x_b, h_init)
        check(f"rg_lru (B, S, W)=({B}, {S}, {cfg.rglru_dim}) {tag}", got, want,
              RG_LRU_RTOL, scale, errs, "rg_lru")
        # The kernel rounds as its twin, step by step: the same bits.
        print(f"check rg_lru {tag} bit-equal to its twin: {torch.equal(got, want)}")
        if not torch.equal(got, want):
            fail(f"rg_lru {tag}: not bit-equal to its plain twin at the served shape")
        del got, want, scale

    # The library yardstick for attention: one SDPA call with the boolean
    # band mask built outside the timed window (never called by the port).
    qs = q.view(B, H, S, HD)
    ks, vs = k.view(B, KV, S, HD), v.view(B, KV, S, HD)
    band = fa.attention_mask(S, S, True, W, S, dev)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=band, enable_gqa=True)

    check("flash_attention library sdpa vs plain", sdpa().reshape(B * H, S, HD).float(),
          fa.flash_attention_plain(q, k, v, H // KV, True, W).float(), FLASH_RTOL, f_scale)
    del f_scale
    pairs = int(band.sum())             # unmasked (q, k) pairs of a head row
    flash_bytes = 2 * (2 * B * H * S * HD + 2 * B * KV * S * HD)
    flash_ops = 4 * HD * pairs * B * H
    rg_bytes = 4 * (3 * B * S * cfg.rglru_dim + B * cfg.rglru_dim)
    rg_ops = 3 * B * S * cfg.rglru_dim      # exp, multiply, add
    timing = {
        "flash_attention": dict(
            kernel=[lambda: fa.flash_attention(q, k, v, H // KV, True, W)],
            plain=[lambda: fa.flash_attention_plain(q, k, v, H // KV, True, W)],
            library=[sdpa], bytes=flash_bytes, ops_s=flash_ops / BF16_OPS_PER_S, reps=5),
        "rg_lru": dict(
            kernel=[lambda: rl.rg_lru(log_a, x_b, h0)],
            plain=[lambda: rl.rg_lru_plain(log_a, x_b, h0)],
            library=None, bytes=rg_bytes, ops_s=rg_ops / FP32_INSTR_PER_S, reps=20,
            stream=[lambda: torch.add(log_a, x_b, out=rg_buf)]),
    }
    rg_buf = torch.empty_like(log_a)    # the yardstick reads two tensors, writes one
    rows = {}
    for name, t in timing.items():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["ops_s"] * 1e3
        rows[name] = {
            "ms": device_ms(t["kernel"], reps=t["reps"]),
            "plain_ms": device_ms(t["plain"], reps=1, trials=3),
            "library_ms": None if t["library"] is None else device_ms(t["library"], reps=5),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        if "stream" in t:
            rows[name]["stream_ms"] = device_ms(t["stream"], reps=t["reps"])
        rows[name]["bound_share"] = rows[name]["bound_ms"] / rows[name]["ms"]
        print(f"time {name}: " + " ".join(f"{k}={v}" for k, v in rows[name].items())
              + f" | {smi}")
    # The cp.async path at the served shape: operands 4 bytes past a 16-byte
    # boundary cannot back a tensor map, so the ring is filled by cp.async.
    n_el = log_a.numel()
    shifted = torch.empty(2 * n_el + 1, device=dev)
    la_c = shifted[1:1 + n_el].view_as(log_a).copy_(log_a)
    xb_c = shifted[1 + n_el:].view_as(x_b).copy_(x_b)
    if rl.uses_tma(cfg.rglru_dim, la_c.data_ptr(), xb_c.data_ptr()):
        fail("rg_lru: a misaligned operand would be filled by TMA")
    same = torch.equal(rl.rg_lru(la_c, xb_c, h0), rl.rg_lru(log_a, x_b, h0))
    print(f"check rg_lru cp.async path bit-equal to the TMA path at the served shape: {same}")
    if not same:
        fail("rg_lru: the cp.async and TMA paths differ at the served shape")
    rows["rg_lru"]["cp_async_ms"] = device_ms([lambda: rl.rg_lru(la_c, xb_c, h0)])
    print(f"time rg_lru cp.async path: {rows['rg_lru']['cp_async_ms']} ms | {smi}")
    del shifted, la_c, xb_c
    if not rows["flash_attention"]["ms"] <= rows["flash_attention"]["library_ms"]:
        fail("the bf16 flash_attention kernel is slower than scaled_dot_product_attention "
             "at the served shape")
    rows["rg_lru"]["library_note"] = (
        "no single PyTorch call computes a first-order recurrence with per-step "
        "decay; the closed form through cumsum(log_a) underflows (exp of about "
        f"{float(log_a.sum(1).min()):.0f} over {S} steps)")
    print(f"time flash_attention: {pairs} unmasked pairs a head row, {flash_ops:.4e} FLOP, "
          f"{flash_bytes / 1e6:.1f} MB; rg_lru: {rg_bytes / 1e6:.1f} MB")
    print(f"time rg_lru library_ms=None: {rows['rg_lru']['library_note']}")
    del q, k, v, qs, ks, vs, band, log_a, x_b, h0, timing, rg_buf
    torch.cuda.empty_cache()

    # 6.2 the main path: the serving entry point, plan + cut + serve
    counters = (nr.reset_launches, fa.reset_launches, rl.reset_launches)
    for reset in counters:
        reset()
    argv = ["--arch", SERVE_ARCH, "--requests", str(B), "--seq", str(S),
            "--new-tokens", "2", "--seed", "0"]
    print(f"serve main: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    out = launch_serve.main(argv)
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    main_launches = {**nr.LAUNCHES, **fa.LAUNCHES, **rl.LAUNCHES}
    s_star = out["split"]
    n_attn = sum(sp.n_layers for sp in stages_for(cfg) if sp.kind == "attn")
    n_rec = cfg.n_layers - n_attn
    print(f"serve main: s*={s_star} wall_s={main_wall:.3f} device_s={out['device_s']:.4f} "
          f"edge_s={out['edge_s']:.4f} link_s={out['link_s']:.4f} (simulated) "
          f"launches={main_launches}")
    if not 0 <= s_star <= cfg.n_layers:
        fail(f"serve: s*={s_star} out of range")
    if main_launches["flash_attention_bwd"] or main_launches["rg_lru_bwd"]:
        fail("serving launched a backward kernel")
    for name in ("flash_attention", "rg_lru", *nr.LAUNCHES):
        if main_launches[name] <= 0:
            fail(f"{name} was not launched on the serving main path")
    want = {"flash_attention": 2 * n_attn, "rg_lru": 2 * n_rec}   # 2 split passes
    for name, n in want.items():
        if main_launches[name] != n:
            fail(f"{name}: {main_launches[name]} launches on the serving main path, "
                 f"expected {n}")
    new_toks = out["new_tokens"]
    if tuple(new_toks.shape) != (B, 2) or int(new_toks.min()) < 0 or \
            int(new_toks.max()) >= cfg.vocab_size:
        fail(f"serve: new tokens {new_toks.tolist()} outside the vocabulary")
    del out
    torch.cuda.empty_cache()

    # 6.3 the same weights again: split logits against the unsplit forward
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(launch_serve.PARAM_SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve model: {SERVE_ARCH} {cfg.n_layers} layers ({n_rec} rec, {n_attn} attn), "
          f"{n_params} parameters, {model.param_bytes()} bytes on the card, "
          f"init {time.perf_counter() - t0:.2f} s")
    tokens = make_batch(0, 0, B, S, cfg.vocab_size, device=dev)["tokens"]
    t0 = time.perf_counter()
    full, _, _ = model(tokens)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    if tuple(full.shape) != (B, S, model.vocab_padded) or not bool(torch.isfinite(full).all()):
        fail(f"forward logits: shape {tuple(full.shape)} or not finite")
    full_absmax = float(full.abs().max())
    print(f"serve forward: logits {tuple(full.shape)} finite, max |logit| {full_absmax:.4f}, "
          f"{fwd_s:.3f} s")
    split_times = {}
    for s in (s_star, SERVE_SPLIT):
        progs = make_split_serve(model, s)
        for reset in counters:
            reset()
        t0 = time.perf_counter()
        act = progs.device_fn(tokens)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        logits = progs.edge_fn(act)
        torch.cuda.synchronize()
        t_edge = time.perf_counter() - t0
        split_times[s] = (t_dev, t_edge)
        n_fa, n_rl = fa.LAUNCHES["flash_attention"], rl.LAUNCHES["rg_lru"]
        act_desc = f"act {tuple(act.shape)} {act.dtype}"
        del act
        # positions (not elements) that differ: a count of elements would
        # need an int64 sum over 3.1e9 entries
        n_diff = int((logits != full).any(-1).sum())
        print(f"serve split s={s}: device_s={t_dev:.4f} edge_s={t_edge:.4f} {act_desc}; "
              f"launches flash_attention={n_fa} rg_lru={n_rl}; positions whose logits "
              f"differ from the forward's: {n_diff}")
        if n_diff or not torch.equal(logits, full):
            fail(f"split s={s}: logits at {n_diff} positions differ from the unsplit forward")
        if (n_fa, n_rl) != (n_attn, n_rec):
            fail(f"split s={s}: {n_fa} flash_attention / {n_rl} rg_lru launches a "
                 f"forward, expected {n_attn} / {n_rec}")
        del logits, progs
        torch.cuda.empty_cache()
    ref = full[:, S - DECODE_STEPS - 1:].clone()
    del full
    torch.cuda.empty_cache()

    # 6.4 cached decode against the forward
    tol = 0.05 * max(1.0, full_absmax)
    p_len = S - DECODE_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches = model.prefill({"tokens": tokens[:, :p_len]}, max_len=S)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    errs_dec = [float((last - ref[:, 0]).abs().max())]
    step_s = []
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        logits, caches = model.decode_step(caches, tokens[:, p_len + i:p_len + i + 1])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        errs_dec.append(float((logits - ref[:, i + 1]).abs().max()))
    worst = max(errs_dec)
    print(f"serve decode: prefill {p_len} tokens then {DECODE_STEPS} steps; max |decode - "
          f"forward| per step {[f'{e:.4f}' for e in errs_dec]}; worst {worst:.4f}, "
          f"{worst / tol:.3f} of the bound 0.05*max(1, max|logits|) = {tol:.4f}")
    if not worst <= tol:
        fail(f"cached decode differs from the forward by {worst:.4f} > {tol:.4f}")
    del caches, ref, last, logits
    torch.cuda.empty_cache()
    # the same prefill and decode steps through the compiled serve steps
    graphed = graph_serve_checks(
        model, {"tokens": tokens[:, :p_len]},
        [tokens[:, p_len + i:p_len + i + 1] for i in range(DECODE_STEPS)], S, "serve 6.4", smi)

    # 6.5 where a forward's time goes: one forward under torch.profiler
    profile_forward(lambda: model(tokens), f"profile forward ({B} x {S} tokens)", smi)
    torch.cuda.empty_cache()     # the model stays for phase 9

    # 6.6 a small input against the plain twins on the CPU
    small = configs.get(SERVE_ARCH).reduced()
    m_card = Model(small, device=dev).init(torch.Generator(device=dev).manual_seed(1))
    m_cpu = Model(small, device="cpu")
    m_cpu.load_state_dict({k: t.cpu() for k, t in m_card.state_dict().items()})
    toks = make_batch(0, 0, 2, 96, small.vocab_size, device=dev)["tokens"]
    got, _, _ = m_card(toks)
    want, _, _ = m_cpu(toks.cpu())
    check("serve reduced model: card vs CPU plain twins", got.cpu(), want, 2e-2,
          want.abs().amax(-1, keepdim=True))

    # 6.7 serving times
    t_dev, t_edge = split_times[s_star]
    dec_ms = statistics.median(step_s) * 1e3
    print(f"serve times ({smi}): prefill_s={prefill_s:.4f} ({B}x{p_len} tokens, "
          f"{B * p_len / prefill_s:.1f} tokens/s); decode_ms_per_step={dec_ms:.3f} "
          f"({B / dec_ms * 1e3:.1f} tokens/s over {B} requests); split s*={s_star} "
          f"device_s={t_dev:.4f} edge_s={t_edge:.4f} "
          f"({B * S / (t_dev + t_edge):.1f} tokens/s through both halves); "
          f"forward_s={fwd_s:.4f}; main wall_s={main_wall:.3f}; graphed: prefill_s="
          f"{graphed['prefill_s']:.4f} decode_ms_per_step={graphed['decode_ms']:.3f}")
    launches = {k: main_launches[k] for k in ("flash_attention", "rg_lru")}
    del m_card, m_cpu, got, want
    return rows, launches, model


def fleet_phase(dev, smi: str, rows: dict, cfg) -> dict:
    """Phase 7. Returns the fleet fields of the three NOMA kernels' rows."""
    import torch
    from repro_torch.core import GdConfig, li_gd, profiles
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.kernels import ops
    from repro_torch.planning import PlannerEngine, member
    from repro_torch.scenarios import Scenario, ScenarioConfig

    b = FLEET_B
    seeds = list(range(b))
    sc = Scenario(ScenarioConfig(**FLEET_SCENARIO))
    t0 = time.perf_counter()
    states = sc.init_many(seeds)
    envs = sc.env_many(states)
    torch.cuda.synchronize()
    counts = torch.stack([torch.bincount(a.long(), minlength=N) for a in envs.ap])
    print(f"fleet: {FLEET_SCENARIO['name']} B={b} U={U} N={N} M={M} rho={sc.cfg.rho:.6f}; "
          f"init_many + env_many {time.perf_counter() - t0:.3f} s; cell sizes of member 0 "
          f"{counts[0].tolist()}, largest cell in the fleet {int(counts.max())}")

    # 7.1 the kernels' fleet launches
    gen = torch.Generator(device=dev).manual_seed(7)
    e = torch.empty((b, U, M), device=dev).exponential_(generator=gen)
    beta = e / e.sum(-1, keepdim=True)
    p_up = 1e-3 + 0.3 * torch.rand((b, U), device=dev, generator=gen)
    p_dn = 0.1 + 9.9 * torch.rand((b, U), device=dev, generator=gen)
    cot = torch.randn((b, U, M), device=dev, generator=gen)
    f4 = 4
    same_triples = float((counts.double() ** 2).sum()) * M
    intra_bound = (b * f4 * (3 * U * M + U) / HBM_BYTES_PER_S,
                   3 * same_triples / FP32_INSTR_PER_S)
    table_bound = (b * f4 * (U * N * M + U * M + U + N * M) / HBM_BYTES_PER_S,
                   b * 2 * U * N * M / FP32_OPS_PER_S)
    sets = []     # (kernel name, label, wrapper, twin, tensors, rest, index of the weight)
    for uplink in (True, False):
        link = "up" if uplink else "dn"
        own, g_raw, ap = ops._inputs(envs, uplink)
        tx = (beta * (p_up if uplink else p_dn)[..., None]).contiguous()
        w_in = (tx * own).contiguous() if uplink else tx
        sets += [("noma_cell_intra", f"intra {link} fwd", nr.noma_cell_intra_dense,
                  nr.noma_cell_intra_dense_plain, (own, own, w_in, ap, ap), (N, uplink), 2),
                 ("noma_cell_intra", f"intra {link} bwd", nr.noma_cell_intra_dense,
                  nr.noma_cell_intra_dense_plain, (own, own, cot, ap, ap), (N, not uplink), 2)]
        if uplink:
            c_nm = nr.segment_table(cot, ap, N).contiguous()
            sets += [("noma_per_ap", "per_ap up fwd", nr.noma_per_ap, nr.noma_per_ap_plain,
                      (ap, tx, g_raw), (True,), 1),
                     ("noma_ap_contract", "contract up bwd", nr.noma_ap_contract,
                      nr.noma_ap_contract_plain, (ap, c_nm, g_raw), (True,), 1)]
        else:
            b_nm = nr.segment_table(tx, ap, N).contiguous()
            sets += [("noma_ap_contract", "contract dn fwd", nr.noma_ap_contract,
                      nr.noma_ap_contract_plain, (ap, b_nm, g_raw), (False,), 1),
                     ("noma_per_ap", "per_ap dn bwd", nr.noma_per_ap, nr.noma_per_ap_plain,
                      (ap, cot, g_raw), (False,), 1)]
    fleet = {k: {"fleet_max_abs_err": 0.0, "fleet": {}} for k in
             ("noma_cell_intra", "noma_per_ap", "noma_ap_contract")}
    for name, label, kernel, twin, tensors, rest, w_pos in sets:
        before = dict(nr.LAUNCHES)
        got = kernel(*tensors, *rest)
        torch.cuda.synchronize()
        if nr.LAUNCHES[name] != before[name] + 1:
            fail(f"{label}: a fleet launch did not count once")
        singles = [kernel(*(t[i] for t in tensors), *rest) for i in range(b)]
        same = [torch.equal(got[i], one) for i, one in enumerate(singles)]
        print(f"check {label} fleet of {b}: each member bit-identical to its single launch: "
              f"{all(same)}")
        if not all(same):
            fail(f"{label}: members {[i for i, x in enumerate(same) if not x]} of the fleet "
                 "launch differ from their single launches")
        errs = {}
        for i in (0, b - 1):
            args = tuple(t[i] for t in tensors)
            scale = twin(*(t.abs() if j == w_pos else t for j, t in enumerate(args)), *rest)
            check(f"{label} member {i} vs plain twin", got[i], twin(*args, *rest),
                  KERNEL_RTOL, scale, errs, name)
            del scale
        fleet[name]["fleet_max_abs_err"] = max(fleet[name]["fleet_max_abs_err"], errs[name])
        del got, singles
        members = [tuple(t[i] for t in tensors) for i in range(b)]
        f_ms = device_ms([lambda: kernel(*tensors, *rest)])
        s_ms = device_ms([lambda: [kernel(*a, *rest) for a in members]])
        t_bytes, t_ops = intra_bound if name == "noma_cell_intra" else table_bound
        bound = max(t_bytes, t_ops) * 1e3
        fleet[name]["fleet"][label] = {
            "fleet_ms": f_ms, "eight_singles_ms": s_ms, "fleet_bound_ms": bound,
            "fleet_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fleet_bound_share": bound / f_ms}
        print(f"time {label} fleet of {b}: fleet_ms={f_ms} eight_singles_ms={s_ms} "
              f"({s_ms / f_ms:.2f}x) fleet_bound_ms={bound} share={bound / f_ms:.4f} | {smi}")
        if not f_ms <= s_ms:
            fail(f"{label}: the fleet launch ({f_ms} ms) is slower than {b} single launches "
                 f"({s_ms} ms)")
    main_sets = {"noma_cell_intra": "intra up fwd", "noma_per_ap": "per_ap up fwd",
                 "noma_ap_contract": "contract dn fwd"}
    for name, label in main_sets.items():
        fleet[name].update({k: fleet[name]["fleet"][label][k] for k in
                            ("fleet_ms", "eight_singles_ms", "fleet_bound_ms")})
    now = {"noma_cell_intra": rows["noma_cell_intra"]["ms"],
           "noma_per_ap": rows["noma_per_ap"]["ms"],
           "noma_per_ap dn": rows["noma_per_ap"]["downlink"]["ms"],
           "noma_ap_contract": rows["noma_ap_contract"]["ms"]}
    print(f"time phase 3 single launches (ms) beside those before the member dim | {smi}: "
          + ", ".join(f"{k} {now[k]} (before {v})" for k, v in BEFORE_MEMBER_DIM_MS.items()))
    del sets, beta, p_up, p_dn, cot, e, members
    torch.cuda.empty_cache()

    # 7.2 the main path: plan_many, then FLEET_CALLS - 1 epochs of step_many ->
    # env_many -> replan_many, with the launch counters read around them
    prof = profiles.nin()
    eng = PlannerEngine(prof, cfg=cfg, sinr_backend="kernel")
    torch.cuda.synchronize()
    nr.reset_launches()
    li_gd.reset_counts()
    walls, fleet_states, steps, env_list, call_launches = [], [], [], [], []
    prev = None
    for epoch in range(FLEET_CALLS):
        t0 = time.perf_counter()
        before, l0 = li_gd.COUNTS["steps"], dict(nr.LAUNCHES)
        if epoch:
            states = sc.step_many(seeds, states)
            envs = sc.env_many(states)
        prev = eng.plan_many(envs) if prev is None else eng.replan_many(prev, envs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        steps.append(li_gd.COUNTS["steps"] - before)
        call_launches.append({k: v - l0[k] for k, v in nr.LAUNCHES.items()})
        fleet_states.append(prev)
        env_list.append(envs)
    launches = dict(nr.LAUNCHES)
    graphs = program_report("fleet", eng, smi)
    splits = prof.n_layers + 1
    names = ["plan_many"] + [f"replan_many{i}" for i in range(1, FLEET_CALLS)]
    for name, st, wall, n_steps in zip(names, fleet_states, walls, steps):
        rho = None if st.warm_rho is None else [round(x, 6) for x in st.warm_rho.tolist()]
        used = (st.opt_steps > st.plan.iters).int().tolist()
        print(f"fleet {name}: wall_s={wall:.3f} fleet_steps={n_steps} s*={st.plan.s.tolist()} "
              f"total_iters={st.total_iters.tolist()} warm_rho={rho}")
        print(f"fleet {name}: used_warm per member {used}")
        print(f"fleet {name}: utility {[f'{x:.7g}' for x in st.plan.utility.tolist()]}")
    total_steps = sum(steps)
    n = FLEET_CALLS
    expect = plan_launches(total_steps, splits * n + 2 * n + 2 * splits * (n - 1))
    print(f"fleet launches: {launches}; expected from {total_steps} fleet GD steps: {expect} "
          f"(6 / 3 / 3 a fleet step, whatever B)")
    for k, v in launches.items():
        if v != expect[k]:
            fail(f"fleet: {k} launched {v} times on the fleet path, expected {expect[k]}")
        fleet[k]["fleet_launches"] = v
    for name, st, e_i in zip(names, fleet_states, env_list):
        for i in range(b):
            check_plan(f"fleet {name} member {i}", member(st, i), member(e_i, i), prof.n_layers)
    print(f"fleet plan checks: all {b} members of the {FLEET_CALLS} epochs finite and "
          "feasible")

    # 7.3 against sequential plans of members 0 and 1
    first, env0 = fleet_states[0], env_list[0]
    for i in (0, 1):
        t0 = time.perf_counter()
        one = eng.plan(member(env0, i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f_u, s_u = float(first.plan.utility[i]), float(one.plan.utility)
        # every split's utility too: s* = F (no offload) leaves the radio out
        f_split, s_split = first.plan.per_layer_utility[i], one.plan.per_layer_utility
        worst = float(torch.max(f_split / s_split - 1))
        print(f"fleet vs sequential member {i}: fleet s*={int(first.plan.s[i])} "
              f"total_iters={int(first.total_iters[i])} iters={first.plan.iters[i].tolist()} "
              f"utility={f_u:.9g} | alone s*={int(one.plan.s)} "
              f"total_iters={int(one.total_iters)} iters={one.plan.iters.tolist()} "
              f"utility={s_u:.9g} wall_s={wall:.3f}; fleet/alone - 1 = {f_u / s_u - 1:.3e}, "
              f"worst split {worst:.3e}")
        if not (f_u <= s_u * (1 + FLEET_UTILITY_RTOL) and worst <= FLEET_UTILITY_RTOL):
            fail(f"fleet member {i}: utility worse than its own plan's by more than "
                 f"{FLEET_UTILITY_RTOL} (s* {f_u} vs {s_u}; worst split {worst:.3e})")
    step_cfg = GdConfig(optimizer="adam", max_iters=40, eps=0.0, sinr_backend="kernel")
    w = eng._w(env0, None)
    fleet_res = li_gd.gd_solve(env0, prof, 4, w, li_gd.cold_init(env0), step_cfg)
    one_env = member(env0, 0)
    one_res = li_gd.gd_solve(one_env, prof, 4, w, li_gd.cold_init(one_env), step_cfg)
    for k in li_gd.KEYS:
        got, want = fleet_res.norm[k][0], one_res.norm[k]
        scale = want.abs().amax(-1, keepdim=True) if want.ndim == 2 else want.abs()
        check(f"fleet 40 fixed steps, member 0 vs alone: {k}", got, want, FLEET_STEP_RTOL,
              scale)
    print(f"fleet 40 fixed steps: member 0 bit-identical to alone in "
          f"{sum(torch.equal(fleet_res.norm[k][0], one_res.norm[k]) for k in li_gd.KEYS)} "
          f"of {len(li_gd.KEYS)} variables")
    del fleet_res, one_res

    # 7.4 where a fleet GD step's time goes
    env2 = env_list[-1]
    start = li_gd.cold_init(env2)
    li_gd.gd_solve(env2, prof, 4, w, start, step_cfg)      # warm-up
    li_gd.reset_counts()
    prof_run, wall, _, rows_k, busy_us = profiled(
        lambda: li_gd.gd_solve(env2, prof, 4, w, start, step_cfg), "fleet gd_solve split 4",
        li_gd.reset_counts)
    n_steps = li_gd.COUNTS["steps"]
    launches_k = sum(e.count for e in rows_k)
    print(f"profile fleet gd_solve split 4, B={b}, {n_steps} steps (profiled): "
          f"wall_s={wall:.4f} per_step_ms={wall / n_steps * 1e3:.3f} "
          f"device_busy_s={busy_us / 1e6:.4f} busy_ms_per_step={busy_us / 1e3 / n_steps:.3f} "
          f"busy_share={busy_us / 1e6 / wall:.4f} kernel_launches={launches_k} "
          f"launches_per_step={launches_k / n_steps:.1f}")
    for e in sorted(rows_k, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile fleet kernel {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.self_device_time_total / busy_us:6.1%} {e.count:6d} launches  {e.key[:80]}")
    del prof_run, rows_k
    profile_graph_steps(eng, "plan_many", env_list[0], n_steps,
                        f"profile graphed fleet gd_solve split 4, B={b},",
                        (wall / n_steps, busy_us / 1e6 / wall), smi)
    torch.cuda.empty_cache()
    # Phase 12 holds the graphed plan_many and first replan_many against the
    # eager path; the rest goes with the engine.
    path = dict(cfg=cfg, envs=env_list[:2], states=fleet_states[:2], walls=walls[:2],
                steps=steps[:2], launches=call_launches[:2], graphs=graphs)
    return fleet, path


def plan_launches(steps: int, evals: int) -> dict:
    """NOMA launches of a solve: per GD step one value_and_grad (2 forward,
    2 backward pairwise calls) and one re-evaluation (2 forward), and one
    forward pair for each of `evals` further utility evaluations."""
    return {k: (6 if k == "noma_cell_intra" else 3) * steps + n * evals
            for k, n in FORWARD_EVAL_LAUNCHES.items()}


def compare_phase(env, smi: str) -> None:
    """Phase 8: planner.compare_all at the paper's width, each arm's launch
    counts, wall and GD steps read around it."""
    import torch
    from repro_torch.core import GdConfig, baselines, channel, li_gd, make_weights, planner
    from repro_torch.core import profiles
    from repro_torch.kernels import noma_rates as nr

    prof = profiles.nin()
    w = make_weights(U, 0.5, device=env.device)
    cfg = GdConfig(step_size=5e-3, max_iters=COMPARE_MAX_ITERS, sinr_backend="kernel")
    # Each arm's counters and wall, read around the calls compare_all makes
    # (the entry point runs as a user calls it; the wrappers only read).
    seen, originals = {}, []

    def instrument(module, fn_name, arm):
        fn = getattr(module, fn_name)
        originals.append((module, fn_name, fn))

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            before = (dict(nr.LAUNCHES), dict(li_gd.COUNTS), dict(baselines.COUNTS))
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seen[arm] = dict(
                wall=time.perf_counter() - t0, out=out,
                launches={k: v - before[0][k] for k, v in nr.LAUNCHES.items()},
                steps=li_gd.COUNTS["steps"] - before[1]["steps"],
                host_reads=li_gd.COUNTS["host_reads"] - before[1]["host_reads"],
                oma_steps=baselines.COUNTS["steps"] - before[2]["steps"],
                oma_reads=baselines.COUNTS["host_reads"] - before[2]["host_reads"])
            return out
        setattr(module, fn_name, wrapped)

    instrument(planner, "plan", "plan")
    for arm, fn_name in (("ecc_noma", "evaluate_plan"), ("ecc_oma", "ecc_oma"),
                         ("device_only", "device_only"), ("edge_only", "edge_only"),
                         ("neurosurgeon", "neurosurgeon"), ("dnn_surgery", "dnn_surgery")):
        instrument(baselines, fn_name, arm)
    prev = channel.set_sinr_backend("kernel")
    try:
        nr.reset_launches()
        t0 = time.perf_counter()
        res = planner.compare_all(env, prof, w, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        channel.set_sinr_backend(prev)
        for module, fn_name, fn in originals:
            setattr(module, fn_name, fn)
    print(f"compare: planner.compare_all(nin, U={U} N={N} M={M}, GdConfig(step_size=5e-3, "
          f"max_iters={COMPARE_MAX_ITERS}, sinr_backend='kernel')) wall_s={wall:.3f} | {smi}")
    if tuple(res) != ARMS:
        fail(f"compare_all returned {tuple(res)}, expected {ARMS}")
    for arm, o in res.items():
        for field in ("T", "E"):
            x = getattr(o, field)
            if tuple(x.shape) != (U,) or not bool(torch.isfinite(x).all()) or \
                    not bool((x > 0).all()):
                fail(f"compare {arm}: {field} not finite and positive for every user")

    # The reference's own invariants (tests/test_core_baselines.py).
    dev_o, ns, ds = res["device_only"], res["neurosurgeon"], res["dnn_surgery"]
    want_t = float(prof.fl.double().sum()) / env.comp.c_device
    dev_err = float((dev_o.T.double() - want_t).abs().max()) / want_t
    print(f"check device_only T = sum(fl) / c_device = {want_t:.9g} s: relative error "
          f"{dev_err:.3e} (tol 1e-06)")
    if dev_err > 1e-6:
        fail("device_only T differs from sum(fl) / c_device")
    if not bool((ns.T <= dev_o.T + 1e-9).all()):
        fail("neurosurgeon is slower than device_only for some user")
    if not float(ds.T.mean()) >= float(ns.T.mean()) - 1e-9:
        fail("dnn_surgery is faster on average than neurosurgeon")
    print("check neurosurgeon T <= device_only T for every user; mean dnn_surgery T >= mean "
          "neurosurgeon T: True")

    # ECC-NOMA's outcome under the kernels against the same plan under einsum.
    plan = seen["plan"]["out"]
    prev = channel.set_sinr_backend("einsum")
    try:
        ref = baselines.evaluate_plan(env, prof, plan, w)
    finally:
        channel.set_sinr_backend(prev)
    for field in ("T", "E"):
        want = getattr(ref, field)
        check(f"compare ecc_noma {field}: kernel vs einsum", getattr(res["ecc_noma"], field),
              want, PATH_RTOL, want.abs())
    # At s* = F nothing crosses the radio (w[F] = m_down[F] = 0), so the
    # same allocation is also priced at s = 0, where every user's T and E
    # hang on its rates.
    at0 = {}
    for backend in ("kernel", "einsum"):
        prev = channel.set_sinr_backend(backend)
        try:
            at0[backend] = baselines.evaluate_plan(env, prof, dataclasses.replace(
                plan, s=torch.zeros_like(plan.s)), w)
        finally:
            channel.set_sinr_backend(prev)
    for field in ("T", "E"):
        want = getattr(at0["einsum"], field)
        check(f"compare ecc_noma allocation at s=0 {field}: kernel vs einsum",
              getattr(at0["kernel"], field), want, PATH_RTOL, want.abs())

    # Launch counts around each arm.
    splits = prof.n_layers + 1
    want = {arm: {k: 0 for k in nr.LAUNCHES} for arm in ARMS}
    want["edge_only"] = want["ecc_noma"] = dict(FORWARD_EVAL_LAUNCHES)
    # the plan: every GD step, one start evaluation a split, two discrete
    # evaluations in the best-of rounding
    want["plan"] = plan_launches(seen["plan"]["steps"], splits + 2)
    for arm, counts in want.items():
        if seen[arm]["launches"] != counts:
            fail(f"compare {arm}: NOMA launches {seen[arm]['launches']}, expected {counts}")
    print(f"check compare launch counts exact: plan {seen['plan']['launches']} for "
          f"{seen['plan']['steps']} GD steps ({seen['plan']['host_reads']} host reads); "
          f"ecc_noma and edge_only {FORWARD_EVAL_LAUNCHES} each; none for ecc_oma, "
          "device_only, neurosurgeon, dnn_surgery")
    print(f"compare plan: s*={int(plan.s)} iters={plan.iters.tolist()} "
          f"wall_s={seen['plan']['wall']:.3f}")
    print(f"compare ecc_oma: {seen['ecc_oma']['oma_steps']} GD steps executed, "
          f"{seen['ecc_oma']['oma_reads']} host reads, s*={int(res['ecc_oma'].s)}")

    # The figures' table (examples/quickstart.py): normalized to Device-Only.
    dev_t, dev_e = float(dev_o.T.double().mean()), float(dev_o.E.double().mean())
    print(f"compare table ({smi}):")
    print("  method          mean T (ms)   mean E (mJ)   speed-up   E-reduction   s    wall s")
    for arm, o in res.items():
        t, e = float(o.T.double().mean()), float(o.E.double().mean())
        if o.s.ndim:
            hist = torch.bincount(o.s.long(), minlength=prof.n_layers + 1).tolist()
            split = "per user " + str({i: c for i, c in enumerate(hist) if c})
        else:
            split = str(int(o.s))
        arm_wall = seen[arm]["wall"] + (seen["plan"]["wall"] if arm == "ecc_noma" else 0.0)
        print(f"  {arm:15s} {t * 1e3:12.4f} {e * 1e3:13.4f} {dev_t / t:10.4f} "
              f"{dev_e / e:13.4f}   {split}   {arm_wall:.4f}")


def online_phase(dev, smi: str, model, cfg) -> None:
    """Phase 9: the online split server over the full-size model."""
    import torch
    from repro_torch import configs
    from repro_torch.core import li_gd, make_env, profiles
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.kernels import rg_lru as rl
    from repro_torch.models import stages_for
    from repro_torch.planning import PlannerEngine
    from repro_torch.runtime import OnlineSplitServer
    from repro_torch.scenarios import Scenario, ScenarioConfig

    arch = configs.get(SERVE_ARCH)
    prof = profiles.from_arch_config(arch, seq=SERVE_S, batch=SERVE_B)
    cfg = dataclasses.replace(cfg, max_iters=ONLINE_MAX_ITERS)
    eng = PlannerEngine(prof, cfg=cfg, sinr_backend="kernel")
    srv = OnlineSplitServer(eng, model=model, replan_every=1)
    splits = prof.n_layers + 1
    n_attn = sum(sp.n_layers for sp in stages_for(arch) if sp.kind == "attn")
    n_rec = arch.n_layers - n_attn
    tokens = make_batch(0, 0, 1, ONLINE_S, arch.vocab_size, device=dev)["tokens"]
    full, _, _ = model(tokens)
    torch.cuda.synchronize()
    sc = Scenario(ScenarioConfig(**FLEET_SCENARIO))
    print(f"online: OnlineSplitServer(replan_every=1) over {SERVE_ARCH} ({arch.n_layers} "
          f"layers, {splits} splits; profile at seq={SERVE_S}, batch={SERVE_B}) on "
          f"{FLEET_SCENARIO['name']} seed 0 (U={U} N={N} M={M}), GdConfig({cfg.optimizer}, "
          f"max_iters={cfg.max_iters}, kernel) | {smi}")
    changes = 0

    def observe(label, env, **kw):
        nonlocal changes
        held_state, held_progs, cold = srv.state, srv.programs, srv.state is None
        resets, last_s = srv.cold_resets, srv.split_layer
        iters0 = srv.total_iters
        torch.cuda.synchronize()
        nr.reset_launches()
        steps0 = li_gd.COUNTS["steps"]
        t0 = time.perf_counter()
        progs = srv.observe(env, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = li_gd.COUNTS["steps"] - steps0
        cold = cold or srv.cold_resets > resets
        # a cold plan evaluates once a split; a warm one adds two warm probes
        expect = plan_launches(steps, (1 if cold else 3) * splits + 2)
        got = dict(nr.LAUNCHES)
        rho = None if not srv.last_plan_ok or srv.state.warm_rho is None \
            else round(float(srv.state.warm_rho), 6)
        print(f"online {label}: wall_s={wall:.3f} s*={srv.split_layer} "
              f"plan_ok={srv.last_plan_ok} {'cold' if cold else 'warm'} GD iterations="
              f"{srv.total_iters - iters0} steps_run={steps} warm_rho={rho} launches={got}")
        if got != expect:
            fail(f"online {label}: NOMA launches {got}, expected {expect}")
        if srv.last_plan_ok and srv.split_layer != last_s:
            changes += 1
            for reset in (fa.reset_launches, rl.reset_launches):
                reset()
            logits = progs.edge_fn(progs.device_fn(tokens))
            torch.cuda.synchronize()
            n_fa, n_rl = fa.LAUNCHES["flash_attention"], rl.LAUNCHES["rg_lru"]
            same = torch.equal(logits, full)
            print(f"online {label}: re-cut at s={srv.split_layer}; logits on 1 x {ONLINE_S} "
                  f"tokens equal to the unsplit forward: {same}; launches flash_attention="
                  f"{n_fa} rg_lru={n_rl}")
            if not same:
                fail(f"online {label}: re-cut logits differ from the unsplit forward")
            if (n_fa, n_rl) != (n_attn, n_rec):
                fail(f"online {label}: {n_fa} / {n_rl} launches a split forward, expected "
                     f"{n_attn} / {n_rec}")
            del logits
        if srv.recuts != changes:
            fail(f"online {label}: {srv.recuts} re-cuts for {changes} changes of s*")
        return held_state, held_progs

    state = sc.init(0)
    env = sc.env(state)
    for epoch in range(3):
        if epoch:
            state = sc.step(0, state)
            env = sc.env(state)
        observe(f"epoch {epoch} (scheduled)", env)
        check_plan(f"online epoch {epoch}", srv.state, env, prof.n_layers)

    # A measured profile that moves s*: with 1e3x the FLOPs compute dominates
    # the utility and the edge (a third of the device's energy per FLOP at
    # its smallest allocation) takes the layers; with 1e3x the transfers, the
    # device keeps them.
    s_before = srv.split_layer
    scale = (1e3, 1.0) if s_before > 0 else (1.0, 1e3)
    measured = prof.like(eng.prof.fl * scale[0], eng.prof.w * scale[1],
                         eng.prof.m_down * scale[1])
    print(f"online measured profile: fl x {scale[0]:g}, w and m_down x {scale[1]:g} "
          f"(s* was {s_before})")
    observe("epoch 3 (forced, measured profile)", env, prof=measured, force=True)
    check_plan("online epoch 3", srv.state, env, prof.n_layers)
    if srv.split_layer == s_before:
        fail(f"online: the measured profile did not move s* from {s_before}")

    # A NaN profile: the plan is rejected, the last good state held.
    p = eng.prof
    held_state, held_progs = observe("epoch 4 (NaN profile)", env,
                                     prof=p.like(p.fl * float("nan"), p.w, p.m_down))
    ok = (srv.bad_plans == 1 and srv.last_plan_ok is False and srv.state is held_state
          and srv.programs is held_progs)
    print(f"check online NaN profile: bad_plans={srv.bad_plans} last_plan_ok="
          f"{srv.last_plan_ok}, state and programs held: {ok}")
    if not ok:
        fail("online: the NaN plan was not rejected with the last good state held")

    # Another user count: the warm state no longer fits, a cold plan.
    env2 = make_env(1000, N, M, seed=1, device=dev)
    observe("epoch 5 (1000 users)", env2)
    check_plan("online epoch 5", srv.state, env2, prof.n_layers)
    if srv.cold_resets != 1:
        fail(f"online: {srv.cold_resets} cold resets after one shape change")
    m = srv.metrics()
    attrs = {k: getattr(srv, k) for k in m}
    print(f"online metrics: {m}")
    # replan_every=1: every epoch is scheduled, so none counts as forced
    if m != attrs or m["epoch"] != 6 or m["replans"] != 6 or m["forced_replans"] != 0:
        fail(f"online: metrics() {m} disagree with the attributes {attrs}")


def fault_kernel_phase(dev, env, errs: dict) -> None:
    """Phase 10.1: the NOMA kernels on fault-masked gains, with the operands
    the main path gives them (ops._Pairwise), against their plain twins."""
    import torch
    from repro_torch.core import channel
    from repro_torch.faults import FaultConfig, apply_env_faults, injectors
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(10)
    rates = FaultConfig(**LOOP_FAULTS).rates(dev)
    faded = torch.rand(U, device=dev, generator=gen) < FADED_SHARE
    ap_down = torch.arange(N, device=dev) == DEAD_AP
    draw = injectors.FaultDraw(link_down=faded, ap_down=ap_down,
                               tel_drop=torch.zeros((), dtype=torch.bool, device=dev),
                               tel_spike=torch.zeros((), dtype=torch.bool, device=dev),
                               svc_mult=torch.ones(U, device=dev))
    menv = apply_env_faults(env, draw, rates)
    dead = menv.ap == DEAD_AP
    print(f"loop 10.1: phase 4's env with AP {DEAD_AP} blacked out ({int(dead.sum())} users) "
          f"and {int(faded.sum())} of {U} users faded by {LOOP_FAULTS['fade_depth']:g}")
    e = torch.empty((U, M), device=dev).exponential_(generator=gen)
    beta = e / e.sum(1, keepdim=True)
    p = {True: 1e-3 + 0.3 * torch.rand(U, device=dev, generator=gen),
         False: 0.1 + 9.9 * torch.rand(U, device=dev, generator=gen)}
    cot = torch.randn((2, U, M), device=dev, generator=gen)
    for uplink in (True, False):
        link = "uplink" if uplink else "downlink"
        own, g_raw, ap = ops._inputs(menv, uplink)
        tx = (beta * p[uplink][:, None]).contiguous()
        w_fwd = (tx * own).contiguous() if uplink else tx
        # the intra term, forward (w_intra) and backward (a cotangent, the
        # comparison flipped): the dead cell has no SIC pair, so exactly 0
        for role, w, desc in (("forward", w_fwd, uplink), ("backward", cot[0], not uplink)):
            got = nr.noma_cell_intra_dense(own, own, w, ap, ap, N, desc)
            want = nr.noma_cell_intra_dense_plain(own, own, w, ap, ap, N, desc)
            scale = nr.noma_cell_intra_dense_plain(own, own, w.abs(), ap, ap, N, desc)
            check(f"loop masked intra {link} {role}", got, want, KERNEL_RTOL, scale, errs,
                  "noma_cell_intra")
            if not bool((got[dead] == 0).all()):
                fail(f"loop masked intra {link} {role}: the blacked-out cell is not 0")
        # the inter term: per_ap builds uplink A and downlink D, contract
        # consumes downlink B and uplink C (gain-free segment tables)
        fwd_w, bwd_w = tx, cot[1]
        for role, w in (("forward", fwd_w), ("backward", bwd_w)):
            if uplink == (role == "forward"):
                got = nr.noma_per_ap(ap, w.contiguous(), g_raw, uplink)
                want = nr.noma_per_ap_plain(ap, w, g_raw, uplink)
                scale = nr.noma_per_ap_plain(ap, w.abs(), g_raw, uplink)
                check(f"loop masked per_ap {link} {role}", got, want, KERNEL_RTOL, scale, errs,
                      "noma_per_ap")
            else:
                tab = nr.segment_table(w, ap, N)
                got = nr.noma_ap_contract(ap, tab, g_raw, uplink)
                want = nr.noma_ap_contract_plain(ap, tab, g_raw, uplink)
                scale = nr.noma_ap_contract_plain(ap, nr.segment_table(w.abs(), ap, N), g_raw,
                                                  uplink)
                check(f"loop masked contract {link} {role}", got, want, KERNEL_RTOL, scale,
                      errs, "noma_ap_contract")
    r_up, r_dn = channel.user_rates(menv, beta, beta, p[True], p[False], backend="kernel")
    floor = r_up.new_tensor(1e-9)
    for name, r in (("uplink", r_up), ("downlink", r_dn)):
        ok = (bool(torch.isfinite(r).all()) and bool((r[dead] == floor).all())
              and bool((r >= floor).all()))
        print(f"check loop masked {name} rates: finite, the blacked-out cell's at the 1e-9 "
              f"floor, none below it: {ok} (faded users' median "
              f"{float(r[faded & ~dead].median()):.4g} bit/s)")
        if not ok:
            fail(f"loop masked {name} rates")


class HostReads:
    """Counts Python-level reads of CUDA tensor values (bool, int, float,
    index, item, tolist) while active: the host reads a loop epoch makes."""

    NAMES = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist")

    def __enter__(self):
        import torch
        self.n, self.saved = 0, {}
        for name in self.NAMES:
            orig = self.saved[name] = getattr(torch.Tensor, name)

            def wrap(t, *a, _orig=orig, **k):
                self.n += t.is_cuda
                return _orig(t, *a, **k)
            setattr(torch.Tensor, name, wrap)
        return self

    def __exit__(self, *exc):
        import torch
        for name, orig in self.saved.items():
            setattr(torch.Tensor, name, orig)
        return False


def loop_epochs(loop, n_epochs: int, label: str, splits: int) -> list:
    """Drive n_epochs of an OnlineLoop through gated_epoch; returns one row
    of host-side readings an epoch."""
    rows = []
    for _ in range(n_epochs):
        rows.append(gated_epoch(loop, label, splits)[2])
    return rows


def gated_epoch(loop, label: str, splits: int, step=None) -> tuple:
    """One epoch of an OnlineLoop (``step``: its step_epoch, by default the
    loop's own), gating its NOMA launches and host reads exactly (an
    attached flight recorder reads one word more), its builds (the loop's
    online_epoch program on its first epoch, nothing else once the engine
    holds its plan and replan programs), no blocking sync inside a program
    call (the epoch and fallback programs' calls whole, and the engine's
    replayed GD steps), and the epoch program's results against the eager
    epoch on the same draws and state, leaf for leaf; returns (out,
    trigger, row of host-side readings)."""
    import torch
    from repro_torch import graphs
    from repro_torch.core import li_gd
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.online import loop as looplib
    from repro_torch.planning import compile_log, programs
    from repro_torch.runtime import serve

    # Once the engine holds its plan and replan programs (the reset's cold
    # plan and the first replan built them), an epoch builds nothing.
    steady = {k[0] for k in loop.engine.cache_keys()} >= {"plan", "replan"}
    hardened = loop.ladder is not None
    recorded = loop._recorder is not None
    prev_state = loop.server.state
    cold0 = loop.ladder.cold_replans if hardened else 0
    before = (dict(li_gd.COUNTS), dict(looplib.COUNTS), dict(serve.COUNTS))
    first = not loop.epoch_program.keys()
    # the epoch's operands, for the eager epoch after the gates
    operands = (loop.epoch_draws(loop._st.epoch), *loop.epoch_args())
    torch.cuda.synchronize()
    nr.reset_launches()
    t0 = time.perf_counter()
    with HostReads() as reads, compile_log() as built:
        (out, trigger), inside, outside = graphs.blocking_syncs(
            step or loop.step_epoch, program_calls(graphs, programs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = li_gd.COUNTS["steps"] - before[0]["steps"]
    gd_reads = li_gd.COUNTS["host_reads"] - before[0]["host_reads"]
    loop_reads = looplib.COUNTS["host_reads"] - before[1]["host_reads"]
    rec_reads = looplib.COUNTS["recorder_reads"] - before[1]["recorder_reads"]
    fallbacks = looplib.COUNTS["fallback_plans"] - before[1]["fallback_plans"]
    plan_reads = serve.COUNTS["host_reads"] - before[2]["host_reads"]
    replanned = loop.server.last_replanned
    cold = prev_state is None or (hardened and loop.ladder.cold_replans > cold0)
    # the service model's two rate evaluations, each fallback plan's
    # pricing, and a replan's solve (a cold plan evaluates once a split;
    # a warm one adds two warm probes; two discrete evaluations)
    want = {k: n * (1 + fallbacks) for k, n in FORWARD_EVAL_LAUNCHES.items()}
    if replanned:
        solve = plan_launches(steps, (1 if cold else 3) * splits + 2)
        want = {k: want[k] + solve[k] for k in want}
    got = dict(nr.LAUNCHES)
    budget = 1 + hardened
    t = loop.host_epoch - 1
    if got != want:
        fail(f"{label} epoch {t}: NOMA launches {got}, expected {want}")
    if loop_reads != budget or plan_reads != int(replanned) or rec_reads != int(recorded):
        fail(f"{label} epoch {t}: {loop_reads} loop reads, {plan_reads} plan words and "
             f"{rec_reads} recorder words, expected {budget}, {int(replanned)} and "
             f"{int(recorded)}")
    if reads.n != loop_reads + plan_reads + gd_reads + rec_reads:
        fail(f"{label} epoch {t}: {reads.n} host reads of device values, expected "
             f"{loop_reads} (loop) + {plan_reads} (plan word) + {gd_reads} (GD stop flags) "
             f"+ {rec_reads} (recorder)")
    epoch_built = [k for k in built if k == "online_epoch"]
    if epoch_built != (["online_epoch"] if first else []):
        fail(f"{label} epoch {t}: the epoch program built {epoch_built} on "
             f"{'its first' if first else 'a later'} epoch")
    rest = [k for k in built if k != "online_epoch"]
    if steady and rest:
        fail(f"{label} epoch {t}: {rest} built in the steady state")
    if inside:
        fail(f"{label} epoch {t}: {inside} blocking syncs inside program calls")
    with torch.no_grad():
        want = loop._epoch(*operands)
    got = (loop._sc, loop._st, loop._bt, loop._qs, loop._tel, loop._fs, out)
    bad = graphs.differing(got, want)
    if bad or (want[0].epoch, want[1].epoch) != (got[0].epoch, got[1].epoch):
        fail(f"{label} epoch {t}: the epoch program's leaves {bad} differ from the eager "
             "epoch's on the same draws and state")
    finite = bool(torch.isfinite(loop._plan.utility))
    row = dict(epoch=t, wall=wall, replanned=replanned, cold=cold, steps=steps,
               stage=loop.ladder.stage if hardened else "-", s=int(loop._plan.s),
               health=int(out.health), trigger=trigger, finite=finite,
               fallbacks=fallbacks, reads=reads.n, syncs=inside + sum(outside.values()),
               completed=int(out.completed), occupancy=int(out.occupancy),
               backlog=int(out.backlog), faulted=int(out.faulted), built=built)
    print(f"{label} epoch {t:2d}: wall_s={wall:.4f} replanned={int(replanned)}"
          f"{' cold' if replanned and cold else ''} gd_steps={steps} stage={row['stage']} "
          f"s*={row['s']} health={row['health']} trigger={int(trigger)} "
          f"plan_finite={finite} fallbacks={fallbacks} host_reads={reads.n} "
          f"blocking_syncs={row['syncs']} (in program calls {inside}) "
          f"graphed_epoch={not first} eager_epoch_equal=True completed={row['completed']} "
          f"occupancy={row['occupancy']} backlog={row['backlog']} faulted={row['faulted']} "
          f"built={built}")
    return out, trigger, row


def loop_phase(dev, smi: str, model, env, errs: dict) -> None:
    """Phase 10: the closed online loop at the paper's width (10.1-10.3) and
    slot batching over the full-size model (10.4)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import graphs
    from repro_torch.core import GdConfig, channel, profiles
    from repro_torch.faults import FaultConfig, LadderConfig
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.online import OnlineLoop, ServiceConfig, StreamConfig
    from repro_torch.planning import PlannerEngine
    from repro_torch.scenarios import Scenario, ScenarioConfig

    t_phase = time.perf_counter()
    fault_kernel_phase(dev, env, errs)

    prof = profiles.nin()
    splits = prof.n_layers + 1

    def build(degrade):
        eng = PlannerEngine(prof, cfg=GdConfig(**LOOP_GD), sinr_backend="kernel")
        return OnlineLoop(Scenario(ScenarioConfig(**FLEET_SCENARIO)), eng,
                          StreamConfig(**LOOP_STREAM), ServiceConfig(**LOOP_SERVICE),
                          feedback=True, faults=FaultConfig(**LOOP_FAULTS),
                          degrade=degrade)

    prev = channel.set_sinr_backend("kernel")
    try:
        # -- 10.2 the hardened loop ----------------------------------------------
        loop = build(LadderConfig(**LOOP_LADDER))
        print(f"loop 10.2: OnlineLoop(feedback, faults, ladder) on {FLEET_SCENARIO['name']} "
              f"seed 0 (U={U} N={N} M={M}), NiN, GdConfig{tuple(LOOP_GD.values())}, "
              f"kernel; {LOOP_STREAM}, {LOOP_SERVICE}, ladder {LOOP_LADDER}, faults "
              f"{LOOP_FAULTS} | {smi}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.reset(0)
        torch.cuda.synchronize()
        print(f"loop 10.2 reset (cold plan): wall_s={time.perf_counter() - t0:.4f} "
              f"s*={int(loop._plan.s)}")
        rows = loop_epochs(loop, LOOP_EPOCHS, "loop 10.2", splits)
        m = loop.metrics()
        bt = loop._bt
        in_flight, queued = int(bt.active.sum()), int(bt.q_size)
        conserved = m["offered"] == (m["completed"] + m["dropped"] + m["shed"] + in_flight
                                     + queued)
        availability = sum(r["finite"] for r in rows) / len(rows)
        print(f"check loop 10.2 requests conserved (offered {m['offered']} = completed "
              f"{m['completed']} + dropped {m['dropped']} + shed {m['shed']} + in flight "
              f"{in_flight} + queued {queued}): {conserved}; every served plan finite: "
              f"{availability == 1.0}")
        if not conserved or availability != 1.0:
            fail("loop 10.2: requests not conserved or a non-finite plan served")
        walls = {k: [r["wall"] for r in rows if r["replanned"] == k] for k in (True, False)}
        print(f"loop 10.2 metrics: goodput_per_s={m['goodput_per_s']} availability="
              f"{availability} recoveries={m['recoveries']} bad_plans={m['bad_plans']} "
              f"shed={m['shed']} quarantines={m['quarantines']} holds={m['holds']} "
              f"baseline_fallbacks={m['baseline_fallbacks']} cold_replans="
              f"{m['ladder_cold_replans']} replans={m['replans']} qos_triggers="
              f"{m['qos_triggers']} completed={m['completed']} deadline_missed="
              f"{m['deadline_missed']} | {smi}")
        print(f"loop 10.2 epoch walls: replan epochs {len(walls[True])} median "
              f"{statistics.median(walls[True]) if walls[True] else float('nan'):.4f} s, "
              f"others {len(walls[False])} median "
              f"{statistics.median(walls[False]) if walls[False] else float('nan'):.4f} s")

        prog = loop.epoch_program
        print(f"loop 10.2 online_epoch program: {prog.graph_count} CUDA graph, capture_s="
              f"{prog.capture_s:.4f}, pool_bytes={pool_bytes(torch, prog.pool)}; "
              f"fallback_plan program: {loop.fallback_program.graph_count} CUDA graph, "
              f"capture_s={loop.fallback_program.capture_s:.4f}, pool_bytes="
              f"{pool_bytes(torch, loop.fallback_program.pool)}")
        if prog.graph_count != 1:
            fail(f"loop 10.2: the epoch program holds {prog.graph_count} graphs, expected 1")
        # epoch walls without a replan, the epoch graphed and eager in turns
        walls_by = {"graphed": [], "eager": []}
        for mode in ("graphed", "eager", "graphed", "eager"):
            loop.epoch_program = prog if mode == "graphed" else prog.eager()
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.step_epoch()
                torch.cuda.synchronize()
                if not loop.server.last_replanned:
                    walls_by[mode].append(time.perf_counter() - t0)
        print(f"loop 10.2 epoch walls without a replan (ms), in turns graphed, eager, graphed, "
              f"eager: graphed {[round(w * 1e3, 3) for w in walls_by['graphed']]} median "
              f"{statistics.median(walls_by['graphed']) * 1e3:.3f}; eager "
              f"{[round(w * 1e3, 3) for w in walls_by['eager']]} median "
              f"{statistics.median(walls_by['eager']) * 1e3:.3f} | {smi}")
        # one epoch that does not replan under torch.profiler, each way
        for mode in ("graphed", "eager"):
            loop.epoch_program = prog if mode == "graphed" else prog.eager()
            def to_plain_epoch():
                for _ in range(3):
                    if loop.server.epoch % loop.server.replan_every:
                        break
                    loop.step_epoch()
                torch.cuda.synchronize()
                nr.reset_launches()

            to_plain_epoch()
            pr, wall, _, rows_k, busy_us = profiled(loop.step_epoch, f"loop 10.2 {mode} epoch",
                                                    to_plain_epoch)
            seen = {k: n for k, n in graphs.kernel_launches(pr).items() if k in nr.LAUNCHES}
            print(f"check loop 10.2 {mode} epoch: NOMA kernels on the device trace {seen}, "
                  f"counted {dict(nr.LAUNCHES)}: {seen == nr.LAUNCHES}")
            if seen != nr.LAUNCHES or not sum(seen.values()):
                fail(f"loop 10.2 {mode} epoch: {seen} on the device trace, counted "
                     f"{dict(nr.LAUNCHES)}")
            print(f"profile loop epoch, {mode} (replanned={int(loop.server.last_replanned)}): "
                  f"wall_s={wall:.4f} device_busy_s={busy_us / 1e6:.6f} busy_share="
                  f"{busy_us / 1e6 / wall:.4f} kernel_launches={sum(e.count for e in rows_k)}"
                  f" | {smi}")
            for e in sorted(rows_k, key=lambda e: -e.self_device_time_total)[:8]:
                print(f"profile loop kernel ({mode}) {e.self_device_time_total / 1e3:9.3f} ms "
                      f"{e.self_device_time_total / busy_us:6.1%} {e.count:6d} launches  "
                      f"{e.key[:80]}")
            del pr, rows_k
        loop.epoch_program = prog

        # -- 10.3 the unguarded arm ---------------------------------------------
        arm = build(None)
        print(f"loop 10.3: the unguarded arm (degrade=None), same traffic and faults")
        arm.reset(0)
        rows_u = loop_epochs(arm, UNGUARDED_EPOCHS, "loop 10.3", splits)
        mu = arm.metrics()
        hard10 = sum(r["completed"] for r in rows[:UNGUARDED_EPOCHS])
        print(f"loop 10.3 metrics: goodput_per_s={mu['goodput_per_s']} (hardened, "
              f"{LOOP_EPOCHS} epochs: {m['goodput_per_s']}) availability="
              f"{sum(r['finite'] for r in rows_u) / len(rows_u)} served a non-finite plan: "
              f"{not all(r['finite'] for r in rows_u)} bad_plans={mu['bad_plans']} "
              f"completed={mu['completed']} (hardened's first {UNGUARDED_EPOCHS} epochs: "
              f"{hard10}) | {smi}")
    finally:
        channel.set_sinr_backend(prev)
    del loop, arm
    torch.cuda.empty_cache()
    batch_phase(dev, smi, model)
    print(f"loop: phase 10 took {time.perf_counter() - t_phase:.1f} s | {smi}")


def batch_phase(dev, smi: str, model) -> None:
    """Phase 10.4: DecodeBatcher and EdgeBatcher over phase 6's model."""
    import torch
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.kernels import rg_lru as rl
    from repro_torch.models import stages_for
    from repro_torch.online import DecodeBatcher, EdgeBatcher
    from repro_torch.runtime import make_split_serve

    arch = model.cfg
    n_attn = sum(sp.n_layers for sp in stages_for(arch) if sp.kind == "attn")
    n_rec = arch.n_layers - n_attn
    b, max_len = BATCH_SLOTS, ONLINE_S + 8
    toks = make_batch(10, 0, b, ONLINE_S, arch.vocab_size, device=dev)["tokens"]

    def counted(fn):
        for reset in (fa.reset_launches, rl.reset_launches, nr.reset_launches):
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, (fa.LAUNCHES["flash_attention"],
                                               rl.LAUNCHES["rg_lru"], sum(nr.LAUNCHES.values()))

    def near(got, want, what):
        tol = BATCH_TOL * max(1.0, float(want.abs().max()))
        err = float((got.float() - want.float()).abs().max())
        print(f"check {what}: max_abs_err={err:.4e} bound={tol:.4e}")
        if not err <= tol:
            fail(f"{what}: {err:.4e} above {tol:.4e}")

    # prompts of three lengths (three prefill graphs in the batcher's
    # admission program); each request served alone: its prefill and greedy
    # decode steps
    lens = [ONLINE_S - 64 * (i % 3) for i in range(b)]
    refs = []
    for i in range(b):
        logits, caches = model.prefill({"tokens": toks[i:i + 1, :lens[i]]}, max_len)
        steps = [logits[0]]
        for _ in range(BATCH_STEPS):
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            logits, caches = model.decode_step(caches, tok)
            steps.append(logits[0])
        refs.append(steps)
        del caches
    db = DecodeBatcher(model, None, capacity=b, max_len=max_len)
    print(f"loop 10.4: DecodeBatcher(capacity={b}, max_len={max_len}) over {SERVE_ARCH} "
          f"({arch.n_layers} layers), {b} requests of {lens} tokens | {smi}")
    for i in range(b):
        logits, wall, (n_fa, n_rl, n_nr) = counted(
            lambda i=i: db.admit(i, toks[i:i + 1, :lens[i]]))
        print(f"loop 10.4 admit slot {i} ({lens[i]} tokens): wall_s={wall:.4f} launches "
              f"flash_attention={n_fa} rg_lru={n_rl}; the admission program's pool "
              f"{pool_bytes(torch, db.programs[0].pool)} bytes over "
              f"{db.programs[0].graph_count} graph(s)")
        if (n_fa, n_rl, n_nr) != (n_attn, n_rec, 0):
            fail(f"loop 10.4 admit: {n_fa} / {n_rl} / {n_nr} launches, expected "
                 f"{n_attn} / {n_rec} / 0")
        near(logits, refs[i][0], f"loop 10.4 slot {i} prefill vs its own")

    def slot_leaves(i):
        out = [db.caches["pos"][i].clone()]
        for st in db.caches["stages"]:
            for leaf in next(iter(st.values())).values():
                out.append(leaf[:, i].clone())
        return out

    for k in range(BATCH_STEPS):
        active = torch.tensor([True, True, k < 2, True], device=dev)
        tok = torch.stack([torch.argmax(r[k]) for r in refs])[:, None].to(torch.int32)
        frozen = slot_leaves(2) if k >= 2 else None
        logits, wall, launched = counted(lambda: db.step(tok, active))
        print(f"loop 10.4 decode step {k}: wall_s={wall:.4f} active={active.tolist()} "
              f"launches={launched}")
        if launched != (0, 0, 0):
            fail(f"loop 10.4 decode step {k} launched kernels {launched}")
        for i in range(b):
            if bool(active[i]):
                near(logits[i], refs[i][k + 1], f"loop 10.4 step {k} slot {i} vs its own")
        if frozen is not None:
            same = all(torch.equal(a, b_) for a, b_ in zip(frozen, slot_leaves(2)))
            print(f"check loop 10.4 step {k}: inactive slot 2's caches unchanged: {same}")
            if not same:
                fail("loop 10.4: an inactive slot's caches changed")
    batcher_programs(db, "loop 10.4", smi, len(set(lens)))
    del db, refs

    progs = make_split_serve(model, SERVE_SPLIT)
    acts = [progs.device_fn(toks[i:i + 1]) for i in range(b)]
    eb = EdgeBatcher(b, ONLINE_S, arch.d_model, dtype=acts[0].dtype, device=dev)
    buf = eb.buf
    for i, a in enumerate(acts):
        buf = eb.write(buf, i, a)
    batched, wall, launched = counted(lambda: eb.run(progs.edge_fn, buf))
    print(f"loop 10.4 EdgeBatcher.run at s={SERVE_SPLIT}: wall_s={wall:.4f} launches "
          f"flash_attention={launched[0]} rg_lru={launched[1]}")
    for i, a in enumerate(acts):
        near(batched[i], progs.edge_fn(a)[0], f"loop 10.4 edge batch slot {i} vs alone")
    del batched, acts, buf
    torch.cuda.empty_cache()


def batcher_programs(db, label: str, smi: str, lengths: int = 1) -> None:
    """A DecodeBatcher's admission and masked-step programs: one CUDA graph
    a prompt length and one, their capture seconds and pool bytes; then
    released."""
    import torch
    for name, prog, want in zip(("admission", "masked decode step"), db.programs,
                                (lengths, 1)):
        print(f"{label} DecodeBatcher {name} program: {prog.graph_count} CUDA graph(s), "
              f"capture_s={prog.capture_s:.4f}, pool_bytes={pool_bytes(torch, prog.pool)} | "
              f"{smi}")
        if prog.graph_count != want:
            fail(f"{label}: the batcher's {name} program holds {prog.graph_count} graphs, "
                 f"expected {want}")
    db.release()
    torch.cuda.empty_cache()


def durable_phase(dev, smi: str, model) -> None:
    """Phase 11: snapshots, crash supervision, integrity and replay around
    the hardened loop at U=1250 (11.1-11.5); cache export / import over the
    full-size model (11.6). Snapshots go to a temporary directory removed
    at the end."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core import GdConfig, channel, profiles
    from repro_torch.core.types import tree_flatten
    from repro_torch.faults import FaultConfig, LadderConfig
    from repro_torch.online import OnlineLoop, ServiceConfig, StreamConfig
    from repro_torch.planning import PlannerEngine
    from repro_torch.scenarios import Scenario, ScenarioConfig
    from repro_torch.state import (
        CrashSupervisor,
        FlightRecorder,
        SimulatedCrash,
        SnapshotConfig,
        SnapshotIntegrityError,
        SnapshotStore,
        list_snapshots,
        load_snapshot,
        read_journal,
        replay,
    )
    from repro_torch.state import snapshot as snaplib

    t_phase = time.perf_counter()
    prof = profiles.nin()
    splits = prof.n_layers + 1
    rows: dict[str, list] = {}
    snap_cfg = SnapshotConfig(every=DURABLE_EVERY, keep_n=3, asynchronous=True)

    def build(stream=None):
        eng = PlannerEngine(prof, cfg=GdConfig(**LOOP_GD), sinr_backend="kernel")
        return OnlineLoop(Scenario(ScenarioConfig(**FLEET_SCENARIO)), eng,
                          StreamConfig(**(stream or LOOP_STREAM)),
                          ServiceConfig(**LOOP_SERVICE), feedback=True,
                          faults=FaultConfig(**DURABLE_FAULTS),
                          degrade=LadderConfig(**LOOP_LADDER))

    def factory(label: str):
        """Loops whose every epoch runs through gated_epoch (exact launches
        and host reads), its row kept under ``label``."""
        def make():
            loop = build()
            step = loop.step_epoch

            def gated(draws=None):
                out, trigger, row = gated_epoch(loop, label, splits, step)
                rows.setdefault(label, []).append(row)
                return out, trigger
            loop.step_epoch = gated
            return loop
        return make

    def crash_once(at: int):
        armed = [True]

        def chaos(next_epoch: int) -> None:
            if next_epoch == at and armed[0]:
                armed[0] = False
                raise SimulatedCrash(f"injected kill before epoch {at}")
        return chaos

    def state_of(loop) -> tuple:
        dev_tree, host = loop.serving_state()
        flat, treedef = tree_flatten(dev_tree)
        return str(treedef), flat, json.loads(json.dumps(host))

    def differ(a: tuple, b: tuple) -> list:
        """Leaves (and parts) of two serving states that are not equal:
        tensors torch.equal with equal dtypes, scalars, the host dicts."""
        bad = [] if a[0] == b[0] and len(a[1]) == len(b[1]) else ["structure"]
        for i, (x, y) in enumerate(zip(a[1], b[1])):
            if isinstance(x, torch.Tensor):
                ok = x.dtype == y.dtype and torch.equal(x, y)
            else:
                ok = type(x) is type(y) and x == y
            if not ok:
                bad.append(i)
        return bad + ([] if a[2] == b[2] else ["host"])

    def same_history(a: dict, b: dict) -> bool:
        def eq(x, y):
            return x == y or (isinstance(x, float) and isinstance(y, float) and x != x
                              and y != y)
        return a.keys() == b.keys() and all(
            len(a[k]) == len(b[k]) and all(eq(x, y) for x, y in zip(a[k], b[k])) for k in a)

    def run(sup, label, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = sup.run(DURABLE_SEED, DURABLE_EPOCHS, record=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"durable {label}: wall_s={wall:.4f} goodput={m['goodput']} "
              f"goodput_per_wall_s={m['goodput'] / wall:.4f} restarts={m['restarts']} "
              f"cold_restarts={m['cold_restarts']} restored_from={m['restored_from']} "
              f"recovery_epochs={m['supervisor_recovery_epochs']} corrupt_snapshots="
              f"{m['corrupt_snapshots']} snapshots_saved={m['snapshots_saved']} "
              f"completed={m['completed']} replans={m['replans']} | {smi}")
        return m, wall

    def flip_byte(path: str) -> None:
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))

    td = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    prev = channel.set_sinr_backend("kernel")
    try:
        print(f"durable 11: CrashSupervisor over OnlineLoop(feedback, faults, ladder) on "
              f"{FLEET_SCENARIO['name']} seed {DURABLE_SEED} (U={U} N={N} M={M}), NiN, "
              f"GdConfig{tuple(LOOP_GD.values())}, kernel; {LOOP_STREAM}, {LOOP_SERVICE}, "
              f"ladder {LOOP_LADDER}, faults {DURABLE_FAULTS}; {DURABLE_EPOCHS} epochs, "
              f"snapshot every {DURABLE_EVERY}, crash before epoch {DURABLE_CRASH} | {smi}")
        # -- 11.1 determinism and the snapshot tax ----------------------------
        sup0 = CrashSupervisor(factory("durable 11.1 bare"))
        m_bare, wall_bare = run(sup0, "11.1 bare")
        bare = state_of(sup0.loop)
        del sup0
        snaplib.reset_counts()
        store1 = SnapshotStore(os.path.join(td, "snaps_11_1"), snap_cfg)
        rec1 = FlightRecorder(os.path.join(td, "flight_11_1.jsonl"))
        sup1 = CrashSupervisor(factory("durable 11.1 snapshots"), store=store1, recorder=rec1)
        m_snap, wall_snap = run(sup1, "11.1 snapshots + recorder")
        store1.wait()
        rec1.close()
        snapped = state_of(sup1.loop)
        del sup1
        bad = differ(snapped, bare)
        n_bytes = snaplib.COUNTS["bytes"] // max(snaplib.COUNTS["captures"], 1)
        overhead = 100.0 * (wall_snap - wall_bare) / wall_bare
        on_thread = 100.0 * sum(store1.capture_s) / wall_bare
        print(f"check durable 11.1 two crash-free episodes bit-equal ({len(bare[1])} leaves, "
              f"host dicts, histories): "
              f"{not bad and same_history(m_snap['history'], m_bare['history'])}"
              f"{'' if not bad else f' (differ: {bad[:8]})'}")
        if bad or not same_history(m_snap["history"], m_bare["history"]):
            fail(f"durable 11.1: the two crash-free episodes differ at leaves {bad[:8]}")
        print(f"durable 11.1 snapshot tax: {snaplib.COUNTS['captures']} snapshots of "
              f"{n_bytes} bytes ({n_bytes / 2**20:.2f} MiB), capture_s="
              f"{[round(x, 4) for x in store1.capture_s]} write_s="
              f"{[round(x, 4) for x in store1.write_s]}, wall bare {wall_bare:.4f} s, with "
              f"snapshots + recorder {wall_snap:.4f} s, overhead {overhead:.2f} % (the "
              f"captures on the loop's thread: {on_thread:.3f} % of the bare wall) | {smi}")

        # -- 11.2 crash and durable resume ------------------------------------
        store2 = SnapshotStore(os.path.join(td, "snaps"), snap_cfg)
        journal = os.path.join(td, "flight.jsonl")
        rec2 = FlightRecorder(journal)
        sup2 = CrashSupervisor(factory("durable 11.2"), store=store2, recorder=rec2)
        m2, wall2 = run(sup2, "11.2 durable arm", chaos=crash_once(DURABLE_CRASH))
        store2.wait()
        rec2.close()
        bad = differ(state_of(sup2.loop), bare)
        r2 = rows["durable 11.2"]
        cut = next(i for i in range(1, len(r2)) if r2[i]["epoch"] <= r2[i - 1]["epoch"])
        orig, again = r2[:cut], r2[cut:]
        keys = ("steps", "s", "health", "trigger", "replanned", "stage", "completed",
                "occupancy", "backlog", "faulted", "reads")
        same_rows = all({k: a[k] for k in keys} == {k: b[k] for k in keys}
                        for a in orig for b in again if a["epoch"] == b["epoch"])
        ok = (not bad and sup2.restarts == 1 and sup2.cold_restarts == 0
              and sup2.restored_from == [2 * DURABLE_EVERY]
              and sup2.recovery_epochs == DURABLE_CRASH - 1 - 2 * DURABLE_EVERY
              and sup2.recovery_epochs <= DURABLE_EVERY
              and all(len(c) == DURABLE_EPOCHS for c in m2["history"].values())
              and same_history(m2["history"], m_bare["history"])
              and [r["epoch"] for r in again] == list(range(2 * DURABLE_EVERY, DURABLE_EPOCHS))
              and same_rows)
        print(f"check durable 11.2 resume bit-equal to 11.1 and recovery within the cadence "
              f"(restored from {sup2.restored_from}, {sup2.recovery_epochs} epochs re-executed, "
              f"history of {len(m2['history']['s'])} epochs equal to 11.1's, re-executed "
              f"epochs {again[0]['epoch']}-{again[-1]['epoch']} launch- and read-gated, "
              f"those run twice read the same): {ok}{'' if not bad else f' (differ: {bad[:8]})'}")
        if not ok:
            fail("durable 11.2: the durable resume is not bit-exact or its accounting is off")
        print(f"durable 11.2 restore: load_snapshot_s={[round(x, 4) for x in store2.restore_s]} "
              f"recovery_s (new loop, reset, restore)={[round(x, 4) for x in sup2.recover_s]}; "
              f"snapshots at {list_snapshots(store2.directory)}; capture_s="
              f"{[round(x, 4) for x in store2.capture_s]} write_s="
              f"{[round(x, 4) for x in store2.write_s]} | {smi}")

        # -- 11.3 the no-checkpoint arm ---------------------------------------
        sup3 = CrashSupervisor(factory("durable 11.3"))
        m3, wall3 = run(sup3, "11.3 no-checkpoint arm", chaos=crash_once(DURABLE_CRASH))
        bad = differ(state_of(sup3.loop), bare)
        ok = (not bad and sup3.cold_restarts == 1 and sup3.restored_from == [0]
              and sup3.recovery_epochs == DURABLE_CRASH - 1 and m3["goodput"] == m2["goodput"])
        print(f"check durable 11.3 cold restart ({sup3.recovery_epochs} epochs re-executed), "
              f"goodput {m3['goodput']} equal to 11.2's {m2['goodput']}, final state bit-equal: "
              f"{ok}")
        if not ok:
            fail("durable 11.3: the no-checkpoint arm did not cold-start to the same episode")
        print(f"durable 11.3 goodput per wall second: durable {m2['goodput'] / wall2:.4f} "
              f"({wall2:.4f} s), no-checkpoint {m3['goodput'] / wall3:.4f} ({wall3:.4f} s), "
              f"crash-free {m_bare['goodput'] / wall_bare:.4f} ({wall_bare:.4f} s) | {smi}")
        del sup2, sup3

        # -- 11.4 integrity ------------------------------------------------------
        # Cases on files: 11.2's snapshots themselves (11.5 needs only its
        # journal), and directories of meta.json copies beside leaves.npz
        # files that are not zip archives, so no snapshot's bytes are copied.
        kept = list_snapshots(store2.directory)

        def meta_only(name: str, epochs) -> str:
            d = os.path.join(td, name)
            for e in epochs:
                os.makedirs(os.path.join(d, f"snap_{e:08d}"))
                shutil.copy(os.path.join(store2.directory, f"snap_{e:08d}", "meta.json"),
                            os.path.join(d, f"snap_{e:08d}", "meta.json"))
                with open(os.path.join(d, f"snap_{e:08d}", "leaves.npz"), "wb") as f:
                    f.write(b"not a zip archive")
            return d

        flip_byte(os.path.join(store2.directory, f"snap_{kept[-1]:08d}", "leaves.npz"))
        loop4 = factory("durable 11.4")()
        loop4.reset(DURABLE_SEED)
        restored, skipped = SnapshotStore(store2.directory,
                                          snap_cfg).restore_newest_valid(loop4)
        print(f"durable 11.4 newest snapshot {kept[-1]} with a flipped byte: restored "
              f"{restored}, skipped {skipped}")
        if restored != kept[-2] or skipped != [kept[-1]]:
            fail(f"durable 11.4: restored {restored} skipping {skipped}, expected {kept[-2]} "
                 f"skipping [{kept[-1]}]")
        while loop4.host_epoch < DURABLE_EPOCHS:
            loop4.step_epoch()
        bad = differ(state_of(loop4), bare)
        print(f"check durable 11.4 the previous snapshot resumed to epoch {DURABLE_EPOCHS} "
              f"bit-equal to 11.1: {not bad}")
        if bad:
            fail(f"durable 11.4: resume from the previous snapshot differs at {bad[:8]}")

        sup4 = CrashSupervisor(factory("durable 11.4 all corrupt"),
                               store=SnapshotStore(meta_only("snaps_all_rot", kept), snap_cfg))
        sup4.run(DURABLE_SEED, 1, chaos=crash_once(1))
        ok = (sup4.cold_restarts == 1 and sup4.corrupt_snapshots == len(kept)
              and sup4.restored_from == [0])
        print(f"check durable 11.4 every snapshot corrupt: cold start "
              f"(cold_restarts={sup4.cold_restarts}, skipped {sup4.corrupt_snapshots} of "
              f"{len(kept)}): {ok}")
        if not ok:
            fail("durable 11.4: with every snapshot corrupt the supervisor did not cold-start")
        del sup4

        other = build(stream=dict(LOOP_STREAM, deadline_s=0.3))
        try:
            load_snapshot(store2.directory, other, kept[-1])
            fail("durable 11.4: a loop of another configuration accepted the snapshot")
        except SnapshotIntegrityError as e:
            print(f"check durable 11.4 another configuration refused: {str(e)[-90:]}")
            if "fingerprint" not in str(e):
                fail(f"durable 11.4: refused, but not by fingerprint: {e}")
        del other

        before = state_of(loop4)
        for what in ("dtype", "shape"):
            bad_dir = meta_only(f"snaps_bad_{what}", kept[-1:])
            path = os.path.join(bad_dir, f"snap_{kept[-1]:08d}")
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            i = meta["dtypes"].index("complex64")          # the scenario's h_up
            if what == "dtype":
                meta["dtypes"][i] = "complex128"
            else:
                meta["shapes"][i][-1] += 1
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f)
            try:
                load_snapshot(bad_dir, loop4, kept[-1])
                fail(f"durable 11.4: a leaf of the wrong {what} was accepted")
            except SnapshotIntegrityError as e:
                refused = "live loop expects" in str(e)
                print(f"check durable 11.4 leaf {i} of the wrong {what} refused before "
                      f"leaves.npz (not a zip archive) is read: {refused} ({str(e)[-80:]})")
                if not refused:
                    fail(f"durable 11.4: the wrong {what} was not refused by the template: {e}")
        bad = differ(state_of(loop4), before)
        print(f"check durable 11.4 the refused loop unchanged: {not bad}")
        if bad:
            fail(f"durable 11.4: a refused restore changed the loop at {bad[:8]}")
        del loop4, before

        # -- 11.5 replay ---------------------------------------------------------
        records, clean = read_journal(journal)
        kinds = [r["kind"] for r in records]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = replay(records, factory("durable 11.5 replay"))
        wall5 = time.perf_counter() - t0
        ok = clean and res == {"epochs": DURABLE_EPOCHS, "divergence": None}
        print(f"check durable 11.5 replay of 11.2's journal ({len(records)} records: "
              f"{kinds.count('epoch')} epoch, {kinds.count('snapshot')} snapshot, "
              f"{kinds.count('restore')} restore) without divergence: {ok} ({res}; "
              f"wall_s={wall5:.4f})")
        if not ok:
            fail(f"durable 11.5: replay diverged or the journal is not clean: {res}")
        tampered = [dict(r) for r in records]
        victim = next(r for r in tampered if r["kind"] == "epoch" and r["t"] == DURABLE_TAMPER_T)
        victim["word"] ^= 1
        res = replay(tampered, factory("durable 11.5 tampered"))
        ok = res["divergence"] is not None and res["divergence"]["t"] == DURABLE_TAMPER_T
        print(f"check durable 11.5 a word changed at epoch {DURABLE_TAMPER_T} diverges there: "
              f"{ok} ({res['divergence']})")
        if not ok:
            fail("durable 11.5: a tampered journal word was not caught")
        torn = os.path.join(td, "torn.jsonl")
        shutil.copy(journal, torn)
        with open(torn, "a") as f:
            f.write('{"kind": "epoch", "t": 25, "wo')
        got, clean_t = read_journal(torn)
        ok = not clean_t and got == records
        print(f"check durable 11.5 a torn last line reads clean=False with all "
              f"{len(records)} earlier records: {ok}")
        if not ok:
            fail("durable 11.5: a torn journal tail was not read as specified")
    finally:
        channel.set_sinr_backend(prev)
        shutil.rmtree(td, ignore_errors=True)
    torch.cuda.empty_cache()
    cache_phase(dev, smi, model)
    print(f"durable: phase 11 took {time.perf_counter() - t_phase:.1f} s | {smi}")


def cache_phase(dev, smi: str, model) -> None:
    """Phase 11.6: DecodeBatcher cache export / import over phase 6's model."""
    import torch
    from repro_torch.core.types import tree_flatten
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru as rl
    from repro_torch.models import stages_for
    from repro_torch.online import DecodeBatcher

    arch = model.cfg
    n_attn = sum(sp.n_layers for sp in stages_for(arch) if sp.kind == "attn")
    n_rec = arch.n_layers - n_attn
    b, max_len = BATCH_SLOTS, ONLINE_S + 8
    toks = make_batch(11, 0, b, ONLINE_S, arch.vocab_size, device=dev)["tokens"]
    db = DecodeBatcher(model, None, capacity=b, max_len=max_len)
    print(f"durable 11.6: DecodeBatcher(capacity={b}, max_len={max_len}) over {SERVE_ARCH}, "
          f"{b} requests of {ONLINE_S} tokens | {smi}")
    for i in range(b):
        fa.reset_launches()
        rl.reset_launches()
        db.admit(i, toks[i:i + 1])
        launched = (fa.LAUNCHES["flash_attention"], rl.LAUNCHES["rg_lru"])
        if launched != (n_attn, n_rec):
            fail(f"durable 11.6 admit slot {i}: {launched} launches, expected "
                 f"{(n_attn, n_rec)}")
    print(f"check durable 11.6 {n_attn} / {n_rec} launches an admission: True")

    def flat(tree):
        return tree_flatten(tree)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = db.export_caches()
    t_export = time.perf_counter() - t0
    n_bytes = sum(x.numel() * x.element_size() for x in flat(snap)[0])
    live = [x.clone() for x in flat(db.caches)[0]]
    tok = torch.stack([toks[i, -1] for i in range(b)])[:, None].to(torch.int32)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    first = [db.step(tok, active) for _ in range(2)]
    after = [x.clone() for x in flat(db.caches)[0]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.import_caches(snap)
    torch.cuda.synchronize()
    t_import = time.perf_counter() - t0
    restored = all(torch.equal(x, y) for x, y in zip(flat(db.caches)[0], live))
    again = [db.step(tok, active) for _ in range(2)]
    same = (restored and all(torch.equal(x, y) for x, y in zip(first, again))
            and all(torch.equal(x, y) for x, y in zip(flat(db.caches)[0], after)))
    print(f"check durable 11.6 export ({n_bytes / 2**20:.2f} MiB, {t_export:.4f} s), 2 decode "
          f"steps, import ({t_import:.4f} s), the same 2 steps: logits and caches bit-equal: "
          f"{same}")
    if not same:
        fail("durable 11.6: decode after a cache import differs from decode after the export")
    try:
        db.import_caches(dict(snap, pos=snap["pos"][:1]))
        fail("durable 11.6: a cache of the wrong shape was imported")
    except ValueError as e:
        print(f"check durable 11.6 a cache of the wrong shape refused: {e}")
    batcher_programs(db, "durable 11.6", smi)
    del db, snap, live, after, first, again
    torch.cuda.empty_cache()


def programs_phase(dev, smi: str, main: dict, fleet: dict) -> None:
    """Phase 12: the engine's compiled programs (CUDA graphs) against the
    eager path on the same inputs (programs.solve_state / resolve_state
    without a runner: li_gd.gd_loop + assemble_plan). 12.1 phase 4's plan
    and two replans, 12.2 replays of the plan and the first replan with the
    blocking syncs counted inside the replayed steps, 12.3 phase 7's
    plan_many and first replan_many; leaf for leaf with torch.equal, and
    the same NOMA launches, GD steps and host reads."""
    import gc

    import torch
    from repro_torch import graphs
    from repro_torch.core import li_gd
    from repro_torch.core.types import tree_flatten
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.planning import PlannerEngine, programs

    def eager(eng, kind, env, prev=None):
        args = eng.program_args(kind, env, prev=prev)
        if kind.startswith("plan"):
            return programs.solve_state(*args, eng.cfg, eng.method, eng.rounding)
        return programs.resolve_state(*args, eng.cfg, eng.rounding, eng.warm_rho_min,
                                      eng.warm_moment_decay)

    def counted(fn):
        torch.cuda.synchronize()
        nr.reset_launches()
        li_gd.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(nr.LAUNCHES), dict(li_gd.COUNTS)

    def differ(a, b) -> list:
        la, ta = tree_flatten(a)
        lb, tb = tree_flatten(b)
        if str(ta) != str(tb):
            return ["structure"]
        return [i for i, (x, y) in enumerate(zip(la, lb))
                if x.dtype != y.dtype or not torch.equal(x, y)]

    def hold(label, got, want, launches, steps, wall_g, wall_e, e_launch, e_count):
        bad = differ(got, want)
        same = launches == e_launch and steps == e_count["steps"]
        print(f"check programs {label}: graphed bit-equal to eager: {not bad} "
              f"({len(tree_flatten(got)[0])} leaves); launches {launches} and {steps} GD "
              f"steps, eager {e_launch} and {e_count['steps']}: {same}; wall graphed "
              f"{wall_g:.4f} s, eager {wall_e:.4f} s ({wall_e / wall_g:.2f}x) | {smi}")
        if bad:
            fail(f"programs {label}: leaves {bad[:8]} differ from the eager path")
        if not same:
            fail(f"programs {label}: launches or GD steps differ from the eager path")

    t_phase = time.perf_counter()
    eng = main["eng"]
    env, env1, env2 = main["envs"]
    states = main["states"]
    # -- 12.1 phase 4's calls against the eager path --------------------------------
    calls = ((0, "plan", "plan (captures)", env, None),
             (2, "replan", "replan2 (replays replan1's graphs)", env2, states[1]))
    for i, kind, label, e_i, prev in calls:
        want, wall, e_launch, e_count = counted(lambda: eager(eng, kind, e_i, prev))
        hold(f"12.1 {label}", states[i], want, main["launches"][i], main["steps"][i],
             main["walls"][i], wall, e_launch, e_count)
        del want
    # -- 12.2 replays, blocking syncs counted ---------------------------------------
    for kind, label, e_i, prev, want in (("plan", "plan", env, None, states[0]),
                                         ("replan", "replan1", env1, states[0], states[1])):
        call = (lambda: eng.plan(e_i)) if prev is None else (lambda: eng.replan(prev, e_i))
        gc.collect()     # destroying dead engines' graphs syncs: not in the window
        (got, inside, where), wall, launch, count = counted(
            lambda: graphs.blocking_syncs(call, ((programs.Program, "advance"),)))
        bad = differ(got, want)
        reads = count["host_reads"]
        print(f"check programs 12.2 {label} replayed: bit-equal to its capturing call: "
              f"{not bad}; wall {wall:.4f} s, {count['steps']} GD steps "
              f"({wall / count['steps'] * 1e3:.4f} ms a step), launches {launch}; blocking "
              f"syncs inside the replayed steps: {inside}; outside: {dict(where)} "
              f"({reads} host reads of the stop flags) | {smi}")
        if bad:
            fail(f"programs 12.2 {label}: a replay differs from the capturing call at {bad[:8]}")
        if inside:
            fail(f"programs 12.2 {label}: {inside} blocking syncs inside replayed GD steps")
        if launch != plan_launches(count["steps"], (1 if kind == "plan" else 3)
                                   * (eng.prof.n_layers + 1) + 2):
            fail(f"programs 12.2 {label}: launches {launch} across replays are not exact")
        del got
    # -- 12.3 the fleet: phase 7's plan_many and first replan_many -------------------
    feng = PlannerEngine(eng.prof, cfg=fleet["cfg"], sinr_backend="kernel")
    f_calls = (("plan_many", "plan_many (captures)", fleet["envs"][0], None),
               ("replan_many", "replan_many1 (captures)", fleet["envs"][1],
                fleet["states"][0]))
    for i, (kind, label, e_i, prev) in enumerate(f_calls):
        want, wall, e_launch, e_count = counted(lambda: eager(feng, kind, e_i, prev))
        hold(f"12.3 fleet of {FLEET_B} {label}", fleet["states"][i], want,
             fleet["launches"][i], fleet["steps"][i], fleet["walls"][i], wall, e_launch,
             e_count)
        del want
    for name, rep in (("main (phase 4)", main["graphs"]), ("fleet (phase 7)", fleet["graphs"])):
        print(f"programs 12.4 {name}: " + "; ".join(
            f"{p['kind']} {p['shape']} {p['graphs']} graphs captured in {p['capture_s']:.4f} s"
            for p in rep["programs"]) + f"; graph pool {rep['pool_bytes']} bytes | {smi}")
    print(f"programs: phase 12 took {time.perf_counter() - t_phase:.1f} s | {smi}")


def profile_forward(fn, label: str, smi: str, ops: dict | None = None) -> dict:
    """One call of fn under torch.profiler: wall, device busy time and
    share, kernel count, the top kernels, and for each group of ``ops``
    (label -> aten op names, or a kernel-name fragment after "kernel:") its
    share of the busy time. Returns the numbers."""
    from torch.autograd import DeviceType
    prof, wall, _, rows_k, busy_us = profiled(fn, label)
    avg = prof.key_averages()
    n_kernels = sum(e.count for e in rows_k)
    print(f"{label} (profiled): wall_s={wall:.4f} device_busy_s={busy_us / 1e6:.4f} "
          f"busy_share={busy_us / 1e6 / wall:.4f} kernel_launches={n_kernels} | {smi}")
    shares = {}
    for group, names in (ops or {}).items():
        if isinstance(names, str):      # "kernel:<fragment>"
            us = sum(e.self_device_time_total for e in rows_k if names[7:] in e.key)
        else:                           # aten ops: their kernels' device time
            us = sum(e.device_time_total for e in avg
                     if e.device_type == DeviceType.CPU and e.key in names)
        shares[group] = us / busy_us
        print(f"{label} share {group}: {us / 1e3:.3f} ms, {us / busy_us:.4f} of the busy time")
    for e in sorted(rows_k, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"{label} kernel {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.self_device_time_total / busy_us:6.1%} {e.count:6d} launches  {e.key[:80]}")
    return dict(wall_s=wall, busy_s=busy_us / 1e6, busy_share=busy_us / 1e6 / wall,
                kernels=n_kernels, shares=shares)


def split_checks(model, tokens, full, splits, label: str, want_flash: int, smi: str,
                 frontend=None) -> dict:
    """Split logits at each split point against ``full`` (the unsplit
    forward's; None: the first split's, for a split that is not the
    forward), to the bit, with want_flash flash_attention launches through
    both halves, which get ``frontend``. Returns {s: (device_s, edge_s)}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.serve import make_split_serve
    times, what = {}, "the forward's"
    for s in splits:
        progs = make_split_serve(model, s)
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act = progs.device_fn(tokens, frontend)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        logits = progs.edge_fn(act, frontend)
        torch.cuda.synchronize()
        times[s] = (t_dev, time.perf_counter() - t0)
        n_fa = fa.LAUNCHES["flash_attention"]
        if full is None:
            full, what = logits, f"s={s}'s"
        n_diff = int((logits != full).any(-1).sum())
        print(f"{label} split s={s}: device_s={times[s][0]:.4f} edge_s={times[s][1]:.4f}; "
              f"flash_attention launches {n_fa}; positions whose logits differ from "
              f"{what}: {n_diff} | {smi}")
        if n_diff or not torch.equal(logits, full):
            fail(f"{label} split s={s}: logits at {n_diff} positions differ from {what}")
        if n_fa != want_flash:
            fail(f"{label} split s={s}: {n_fa} flash_attention launches, expected {want_flash}")
        del act, logits, progs
        torch.cuda.empty_cache()
    return times


class Routes:
    """Within a with-block, moe._router records each call's expert choices
    in ``seen``; given ``pin`` (a list of (N, k) choices consumed in call
    order) it takes those experts instead, the gates then being the call's
    own router probabilities at them, normalized as the router does."""

    def __init__(self, pin=None):
        self.pin = None if pin is None else list(pin)
        self.seen = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._router

        def router(p, xt, cfg):
            gates, idx, aux = self.orig(p, xt, cfg)
            if self.pin is not None:
                idx = self.pin.pop(0)
                probs = torch.softmax((xt @ p["router"].to(moe.COMPUTE_DTYPE)).float(), -1)
                g = probs.gather(1, idx)
                gates = g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
            self.seen.append(idx)
            return gates, idx, aux

        moe._router = router
        return self

    def __exit__(self, *exc):
        self.moe._router = self.orig


def decode_checks(model, tokens, ref, p_len: int, absmax: float, label: str, smi: str,
                  gate: bool = True, frontend=None):
    """Prefill the first p_len tokens (with ``frontend`` when given), then
    DECODE_STEPS cached decode steps, each against the forward's logits
    (ref: its positions p_len - 1 to p_len + DECODE_STEPS - 1) within 0.05 *
    max(1, max |logits|) (printed; a failure unless gate is False). Returns
    (prefill s, median decode ms a step, the worst error)."""
    import torch
    from repro_torch.models import moe
    tol = 0.05 * max(1.0, absmax)
    b, s = tokens.shape
    torch.cuda.synchronize()
    with moe.drop_log() as drops:
        t0 = time.perf_counter()
        batch = {"tokens": tokens[:, :p_len]}
        if frontend is not None:
            batch["frontend"] = frontend
        last, caches = model.prefill(batch, max_len=s)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        errs_dec = [float((last - ref[:, 0]).abs().max())]
        step_s = []
        for i in range(DECODE_STEPS):
            t0 = time.perf_counter()
            logits, caches = model.decode_step(caches, tokens[:, p_len + i:p_len + i + 1])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            errs_dec.append(float((logits - ref[:, i + 1]).abs().max()))
    dropped = sum(int(d) for d in drops)
    worst = max(errs_dec)
    print(f"{label} decode: prefill {b}x{p_len} tokens then {DECODE_STEPS} steps; max |decode - "
          f"forward| per step {[f'{e:.4f}' for e in errs_dec]}; worst {worst:.4f}, "
          f"{worst / tol:.3f} of the bound 0.05*max(1, max|logits|) = {tol:.4f}; MoE slots "
          f"dropped {dropped} | {smi}")
    if dropped:
        fail(f"{label} decode: {dropped} MoE slots dropped: decode cannot match the forward")
    if gate and not worst <= tol:
        fail(f"{label}: cached decode differs from the forward by {worst:.4f} > {tol:.4f}")
    return prefill_s, statistics.median(step_s) * 1e3, worst


def counted_call(fn):
    """fn()'s result, its wall seconds (to a synchronize), and what it
    launched: every kernel's count, flash_attention's by shape, and the MoE
    dropped-slot counts (read after the call)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.kernels import rg_lru as rl
    from repro_torch.models import moe
    torch.cuda.synchronize()
    for reset in (nr.reset_launches, fa.reset_launches, rl.reset_launches):
        reset()
    with moe.drop_log() as drops:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, ({**nr.LAUNCHES, **fa.LAUNCHES, **rl.LAUNCHES}, dict(fa.SHAPES),
                       [int(d) for d in drops])


def program_calls(graphs, programs) -> tuple:
    """The methods whose blocking syncs count as a program call's for
    graphs.blocking_syncs: a compiled program's call, whole (operand
    copies, the replay, the output copies), and the engine's replayed GD
    steps."""
    return ((graphs.Compiled, "__call__"), (programs.Program, "advance"))


def profile_steps(step, n: int, label: str, smi: str) -> dict:
    """n calls of step() under torch.profiler: ms a step, device busy ms a
    step and busy share, kernels a step."""
    def steps():
        for _ in range(n):
            step()

    prof, wall, _, rows, busy = profiled(steps, label)
    busy /= 1e6
    kernels = sum(e.count for e in rows)
    print(f"{label} {n} steps (profiled): ms_per_step={wall / n * 1e3:.4f} busy_ms_per_step="
          f"{busy / n * 1e3:.4f} busy_share={busy / wall:.4f} kernels_per_step={kernels / n:.1f}"
          f" | {smi}")
    return dict(ms=wall / n * 1e3, busy_ms=busy / n * 1e3, busy_share=busy / wall,
                kernels=kernels / n)


def graph_serve_checks(model, batch: dict, toks: list, max_len: int, label: str,
                       smi: str) -> dict:
    """The compiled serve steps (runtime/serve.py) against the eager steps
    on the same inputs, at the phase's full-size model: jit_prefill of
    ``batch`` called three times (the first call runs eagerly and captures,
    the others replay); jit_decode_step for len(toks) steps from the last
    replay's caches and jit_masked_decode_step for as many more,
    slot 1 idle every other step, from the decode's caches after 4
    profiled steps (the eager reference takes the same 4). Each graph's
    logits and caches equal Model.prefill / decode_step (slot_where over it
    for the masked step) leaf for leaf with torch.equal. One replay of each
    program runs under torch.profiler: the port's kernels its device trace
    holds must equal what the eager call launched and what the replay's
    bookkeeping added to the counters (graphs.traced_launches). Every
    replay's by-shape flash counts and MoE dropped-slot counts equal the
    eager call's, and no program call, whole, makes a blocking sync.
    Prints admission seconds and ms a decode step graphed and eager
    (median of the untraced replays and of the eager steps), 4 profiled
    steps of each (busy share), and each program's graphs, capture seconds
    and pool bytes; releases the programs. Returns the numbers and the
    flash_attention shapes of the prefill program's first call (launched
    by the wrapper as it ran eagerly)."""
    import gc

    import torch
    from repro_torch import graphs
    from repro_torch.online import slot_where
    from repro_torch.runtime.serve import (
        jit_decode_step,
        jit_masked_decode_step,
        jit_prefill,
    )
    b = batch["tokens"].shape[0]
    out: dict = {}
    syncs = {"n": 0}

    def call(fn):
        """fn() (one program call) through counted_call, its blocking
        syncs added to syncs["n"]."""
        (res, inside, where), wall, launched = counted_call(
            lambda: graphs.blocking_syncs(fn, ((graphs.Compiled, "__call__"),)))
        syncs["n"] += inside + sum(where.values())
        return res, wall, launched

    def traced(fn, what, eager):
        """One replay under torch.profiler: the port's kernels on its
        device trace against the eager call's launches and the replay's
        own count."""
        (res, _, booked), seen = graphs.traced_launches(lambda: counted_call(fn))
        print(f"check {label} graphs {what} replay, traced: the port's kernels on the device "
              f"{seen}; the eager call launched {eager[0]}; the replay counted {booked[0]}: "
              f"{seen == eager[0] == booked[0]}")
        if not seen == eager[0] == booked[0]:
            fail(f"{label} graphs {what}: the replay ran {seen} on the device, the eager call "
                 f"launched {eager[0]}, the replay counted {booked[0]}")
        gate(what, True, eager, booked)
        return res

    def gate(what, same, eager, replay):
        """Leaves equal, and the replay's by-shape flash counts and MoE
        dropped-slot counts equal the eager call's."""
        if same is not True or replay[1:] != eager[1:]:
            fail(f"{label} graphs {what}: graphed differs from eager (leaves {same}) or its "
                 f"flash shapes / MoE drops {replay[1:]} differ from eager's {eager[1:]}")

    def report(name, prog):
        out[name] = dict(graphs=prog.graph_count, capture_s=prog.capture_s,
                         pool_bytes=pool_bytes(torch, prog.pool))
        print(f"{label} graphs {name}: {prog.graph_count} CUDA graph(s), capture_s="
              f"{prog.capture_s:.4f}, pool_bytes={out[name]['pool_bytes']}")

    # prefill: eager, then the program's capturing call and two replays
    (e_log, e_caches), e_wall, e_launched = counted_call(lambda: model.prefill(batch, max_len))
    # the eager prefill's blocks go back to the card before the program's
    # first call allocates its own (on its stream) and its graph's pool
    torch.cuda.empty_cache()
    pre, _ = jit_prefill(model, None, max_len)
    (l1, c1), first_wall, first_launched = call(lambda: pre(None, batch))
    bad = graphs.differing(c1, e_caches)
    same = torch.equal(l1, e_log)
    del c1, l1
    torch.cuda.empty_cache()
    (l2, caches), g_wall, g_launched = call(lambda: pre(None, batch))
    bad += graphs.differing(caches, e_caches)
    same = (same and torch.equal(l2, e_log) and not bad) or (bad or "logits")
    gate("prefill", same, e_launched, g_launched)
    del caches
    torch.cuda.empty_cache()
    l3, c3 = traced(lambda: pre(None, batch), "prefill", e_launched)
    same = (torch.equal(l3, e_log) and not graphs.differing(c3, e_caches)) or "traced replay"
    print(f"check {label} graphs prefill ({b} x {batch['tokens'].shape[1]} tokens): the "
          f"capturing call and two replays equal the eager prefill leaf for leaf: {same is True}; "
          f"launches {g_launched[0]} (eager {e_launched[0]}), MoE drops {sum(g_launched[2])} "
          f"(eager {sum(e_launched[2])}); admission_s graphed={g_wall:.4f} eager={e_wall:.4f} "
          f"capturing call={first_wall:.4f}; blocking syncs in the program calls {syncs['n']} "
          f"| {smi}")
    gate("prefill (traced replay)", same, e_launched, e_launched)
    if syncs["n"]:
        fail(f"{label} graphs prefill: {syncs['n']} blocking syncs in the program calls")
    out.update(prefill_s=g_wall, prefill_eager_s=e_wall, prefill_shapes=first_launched[1])
    report("prefill", pre.program)
    del l2, l3, e_log
    pre.program.release()
    del pre
    gc.collect()
    torch.cuda.empty_cache()

    # decode: len(toks) steps from the traced replay's caches (the program
    # adopts them as its buffers); the first captures, the second is traced
    dec, _, _ = jit_decode_step(model, None, b, max_len)
    want, caches, e_ms, g_ms = e_caches, c3, [], []
    del e_caches, c3
    for k, tok in enumerate(toks):
        (w_log, want), e_wall, e_launched = counted_call(lambda: model.decode_step(want, tok))
        if k == 1:
            log, caches = traced(lambda: dec(None, caches, tok), "decode step", e_launched)
        else:
            (log, caches), g_wall, g_launched = call(lambda: dec(None, caches, tok))
            gate(f"decode step {k}", True, e_launched, g_launched)
            if k:
                g_ms.append(g_wall * 1e3)
        e_ms.append(e_wall * 1e3)
        if not torch.equal(log, w_log):
            fail(f"{label} graphs decode step {k}: logits differ from the eager step's")
    bad = graphs.differing(caches, want)
    print(f"check {label} graphs decode: {len(toks)} steps (the first captures) logits equal "
          f"the eager steps' and the caches after them leaf for leaf: {not bad}; blocking syncs "
          f"in the program calls {syncs['n']}; ms a step graphed={statistics.median(g_ms):.4f} "
          f"eager={statistics.median(e_ms):.4f} | {smi}")
    if bad or syncs["n"]:
        fail(f"{label} graphs decode: cache leaves {bad} differ, or {syncs['n']} blocking syncs")
    out.update(decode_ms=statistics.median(g_ms), decode_eager_ms=statistics.median(e_ms))
    report("decode_step", dec.program)
    tok = toks[0]
    state = {"c": caches, "w": want}
    del caches, want

    def graphed_step():
        _, state["c"] = dec(None, state["c"], tok)

    def eager_step():
        _, state["w"] = model.decode_step(state["w"], tok)
    out["decode_profile"] = profile_steps(graphed_step, 4, f"{label} graphs decode replays",
                                          smi)
    out["decode_eager_profile"] = profile_steps(eager_step, 4, f"{label} eager decode", smi)

    # masked: slot 1 idle every other step, from the decode program's caches
    # and the eager steps' (both 4 profiled steps on)
    masked, _, _ = jit_masked_decode_step(model, None, b, max_len)
    caches, want = state["c"], state["w"]
    m_ms = []
    for k, tok in enumerate(toks):
        active = torch.tensor([i != 1 or k % 2 == 1 for i in range(b)], device=tok.device)

        def eager():
            logits, new = model.decode_step(want, torch.where(active[:, None], tok, 0))
            return logits, slot_where(active, new, want)
        (w_log, want), _, e_launched = counted_call(eager)
        if k == 1:
            log, caches = traced(lambda: masked(None, caches, tok, active), "masked step",
                                 e_launched)
        else:
            (log, caches), g_wall, g_launched = call(lambda: masked(None, caches, tok, active))
            gate(f"masked step {k}", True, e_launched, g_launched)
            if k:
                m_ms.append(g_wall * 1e3)
        if k == 0:
            dec.program.release()
        bad = graphs.differing(caches, want)
        if bad or not torch.equal(log, w_log):
            fail(f"{label} graphs masked step {k}: cache leaves {bad} or the logits differ "
                 "from eager")
    print(f"check {label} graphs masked decode: {len(toks)} steps, slot 1 idle every other "
          f"step, logits and caches leaf for leaf equal to decode_step + slot_where: True; "
          f"blocking syncs in the program calls {syncs['n']}; ms a step graphed="
          f"{statistics.median(m_ms):.4f} | {smi}")
    if syncs["n"]:
        fail(f"{label} graphs masked decode: {syncs['n']} blocking syncs in the program calls")
    out["masked_ms"] = statistics.median(m_ms)
    report("masked_decode_step", masked.program)
    masked.program.release()
    del dec, masked, caches, want, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flash_row(dev, label: str, b: int, h: int, kv: int, sq: int, sk: int, hd: int,
              causal: bool, errs: dict, smi: str, seed: int, window: int = 0) -> dict:
    """The bf16 flash kernel at one served shape, q (b*h, sq, hd) over k/v
    (b*kv, sk, hd), with ``window`` or none (causal only at sq == sk):
    against its plain twin within FLASH_RTOL of the twin on |v|, then its
    time beside the twin's, one scaled_dot_product_attention call's
    (is_causal, the boolean band mask of a window, or no mask; enable_gqa
    where G > 1) and its bound, the larger of 4 hd FLOP an unmasked (q, k)
    pair at the bf16 rate and the bytes of q, k, v and the output once at
    the HBM rate. Returns the timing row; adds the check's error to
    errs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b * h, sq, hd), device=dev, generator=gen).bfloat16()
    k, v = (torch.randn((b * kv, sk, hd), device=dev, generator=gen).bfloat16()
            for _ in range(2))
    args = (h // kv, causal, window)
    mask = (f"window {window}" if window else "causal") if causal else "no mask"
    got = fa.flash_attention(q, k, v, *args)
    torch.cuda.synchronize()
    check(f"flash_attention {label} B={b} Sq={sq} Sk={sk} H={h}/{kv} hd={hd} {mask}",
          got.float(), fa.flash_attention_plain(q, k, v, *args).float(), FLASH_RTOL,
          fa.flash_attention_plain(q, k, v.abs(), *args).float(), errs, "flash_attention")
    del got
    qs, ks, vs = q.view(b, h, sq, hd), k.view(b, kv, sk, hd), v.view(b, kv, sk, hd)
    pairs = attention_pairs(sq, sk, causal, window)
    flash_ops = 4 * hd * pairs * b * h
    flash_bytes = 2 * (2 * b * h * sq * hd + 2 * b * kv * sk * hd)
    t_bytes = flash_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flash_ops / BF16_OPS_PER_S * 1e3
    gqa = h != kv
    band = fa.attention_mask(sq, sk, causal, window, sk, dev) if window else None
    row = {
        "ms": device_ms([lambda: fa.flash_attention(q, k, v, *args)], reps=5),
        "plain_ms": device_ms([lambda: fa.flash_attention_plain(q, k, v, *args)], reps=1,
                              trials=3),
        "library_ms": device_ms([lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=band, is_causal=causal and band is None, enable_gqa=gqa)],
            reps=5),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print(f"time flash_attention at {label}'s shape ({b * h}, {sq}, {hd}) over ({b * kv}, {sk}) "
          f"G={h // kv} {mask}: " + " ".join(f"{k}={v}" for k, v in row.items())
          + f" ({flash_ops:.4e} FLOP, {flash_bytes / 1e6:.1f} MB; library: "
          f"scaled_dot_product_attention, "
          f"{'band mask' if window else 'is_causal' if causal else 'no mask'}"
          f"{', enable_gqa' if gqa else ''}) | {smi}")
    return row


def flash_rows(dev, arch: str, b: int, h: int, kv: int, hd: int, shapes: dict, errs: dict,
               smi: str, seed: int) -> tuple[dict, dict]:
    """flash_row at each of ``shapes`` (label -> (sq, sk, causal)). Returns
    the rows, named "<arch> <label>", and each row's key in
    flash_attention.SHAPES."""
    rows, keys = {}, {}
    for i, (label, (sq, sk, causal)) in enumerate(shapes.items()):
        name = f"{arch} {label}"
        rows[name] = flash_row(dev, name, b, h, kv, sq, sk, hd, causal, errs, smi, seed + i)
        keys[name] = (b * h, sq, sk, hd, h // kv, causal, 0, sk)
    return rows, keys


def attach_launches(rows: dict, keys: dict, paths: dict, label: str,
                    checks: dict | None = None) -> int:
    """Gives each row the flash_attention launches at its shape on each of
    ``paths`` (name -> a flash_attention.SHAPES snapshot taken over that
    path alone): "launches" their sum, "launches_by_path" each. Fails where
    a path, or one of ``checks`` (runs that compare a path with another,
    whose launches are not counted), launched a shape that no row checked,
    or a row's shape was launched on none of the paths. Returns the
    launches over all the paths."""
    checked = set(keys.values())
    for path, shapes in {**paths, **(checks or {})}.items():
        unchecked = sorted(k for k in shapes if k not in checked)
        if unchecked:
            fail(f"{label}: the {path} launched flash_attention at shapes no check covers "
                 f"(query rows, Sq, Sk, hd, G, causal, window, kv_len): {unchecked}")
    for name, key in keys.items():
        by_path = {path: shapes.get(key, 0) for path, shapes in paths.items()}
        rows[name]["launches"] = sum(by_path.values())
        rows[name]["launches_by_path"] = by_path
        print(f"{label} flash_attention launches at {name}'s shape: {by_path}")
        if not rows[name]["launches"]:
            fail(f"{label}: no path launched flash_attention at {name}'s shape")
    return sum(sum(shapes.values()) for shapes in paths.values())


def moe_phase(dev, smi: str, errs: dict) -> tuple[dict, int]:
    """Phase 13.1: deepseek-moe-16b at full width and depth. Returns the
    flash_attention timing row at its shape and the serving main path's
    flash_attention launches; adds the flash check's error to errs."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Model, moe

    t_phase = time.perf_counter()
    cfg = configs.get(MOE_ARCH)
    B, S = SERVE_B, SERVE_S
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    # the flash kernel at this model's prefill shape (G = 1, hd 128, causal)
    row = flash_row(dev, MOE_ARCH, B, H, KV, S, S, HD, True, errs, smi, 13)
    torch.cuda.empty_cache()

    # the main path: the serving entry point, plan + cut + serve
    n_attn = cfg.n_layers
    main = serve_main(MOE_ARCH, B, S, "moe 13.1", 2 * n_attn)
    main_wall, main_launches, s_star = main["wall_s"], main["launches"], main["split"]
    gc.collect()
    torch.cuda.empty_cache()

    # the same weights again
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, moe_capacity=launch_serve.MOE_CAPACITY).init(
        torch.Generator(device=dev).manual_seed(launch_serve.PARAM_SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"moe 13.1 model: {MOE_ARCH} {cfg.n_layers} layers ({cfg.first_dense_layers} dense, "
          f"{cfg.n_layers - cfg.first_dense_layers} MoE: {cfg.n_experts} experts top-"
          f"{cfg.top_k}, {cfg.n_shared_experts} shared), {n_params} parameters, "
          f"{model.param_bytes()} bytes on the card, init {time.perf_counter() - t0:.2f} s, "
          f"capacity factor {model.moe_capacity}")
    tokens = make_batch(0, 0, B, S, cfg.vocab_size, device=dev)["tokens"]
    fa.reset_launches()
    with moe.drop_log() as drops:
        t0 = time.perf_counter()
        full, _, aux = model(tokens)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    dropped = sum(int(d) for d in drops)
    if tuple(full.shape) != (B, S, model.vocab_padded) or not bool(torch.isfinite(full).all()):
        fail(f"moe 13.1 forward logits: shape {tuple(full.shape)} or not finite")
    absmax = float(full[..., :cfg.vocab_size].abs().max())    # past the vocab: -1e30
    print(f"moe 13.1 forward: logits {tuple(full.shape)} finite, max |logit| {absmax:.4f}, "
          f"aux loss {float(aux):.6f}, {fwd_s:.3f} s; flash_attention launches "
          f"{fa.LAUNCHES['flash_attention']}; MoE slots dropped at the served capacity "
          f"{dropped} of {len(drops) * B * S * cfg.top_k} in {len(drops)} layers, by layer "
          f"{[int(d) for d in drops]}")
    if fa.LAUNCHES["flash_attention"] != n_attn:
        fail(f"moe 13.1 forward: {fa.LAUNCHES['flash_attention']} flash_attention launches, "
             f"expected {n_attn}")
    split_times = split_checks(model, tokens, full, (s_star, MOE_SPLIT), "moe 13.1", n_attn,
                               smi)
    again, _, _ = model(tokens)
    same = torch.equal(again, full)
    print(f"check moe 13.1 two runs of the same forward bit-equal: {same}")
    if not same:
        fail("moe 13.1: two runs of the same forward differ (the combine must not use atomics)")
    del again, full
    torch.cuda.empty_cache()

    # sorted against dense on the first MoE layer's input of 1024 served tokens
    taken = []
    apply = moe.moe_apply

    def capture(p, x, c, **kw):
        if not taken:
            taken.append((p, x.clone()))
        return apply(p, x, c, **kw)

    moe.moe_apply = capture
    try:
        model(tokens[:, :MOE_DENSE_TOKENS // B])
    finally:
        moe.moe_apply = apply
    p1, x1 = taken[0]
    with moe.drop_log() as drops:
        y_s, aux_s = moe.moe_apply(p1, x1, cfg, impl="sorted", capacity_factor=cfg.n_experts)
    y_d, aux_d = moe.moe_apply(p1, x1, cfg, impl="dense")
    diff = (y_s.float() - y_d.float()).abs()
    ok = bool((diff <= 0.03 + 0.05 * y_d.float().abs()).all()) and int(drops[0]) == 0 and \
        abs(float(aux_s) - float(aux_d)) <= 1e-5 * abs(float(aux_d))
    print(f"check moe 13.1 sorted vs dense on layer 1's input ({MOE_DENSE_TOKENS} served "
          f"tokens, capacity factor {cfg.n_experts}, {int(drops[0])} dropped): max_abs_err="
          f"{float(diff.max()):.3e} (max |y| {float(y_d.abs().max()):.3e}; atol 0.03, rtol "
          f"0.05); aux {float(aux_s):.6f} vs {float(aux_d):.6f}: {ok}")
    if not ok:
        fail("moe 13.1: sorted and dense MoE differ beyond atol 0.03 / rtol 0.05")
    del taken, p1, x1, y_s, y_d, diff

    # Decode against the forward needs both to drop no slot: the capacity is
    # a function of the token count, so a prefill and a decode step would
    # drop other slots than the forward. At E / k every expert holds all N
    # tokens and none can drop.
    model.moe_capacity = cfg.n_experts / cfg.top_k
    with moe.drop_log() as drops, Routes() as fwd_routes:
        full, _, _ = model(tokens)
    dropped_none = sum(int(d) for d in drops)
    print(f"moe 13.1 decode reference: the forward at capacity factor {model.moe_capacity:.4f} "
          f"(every expert holds all {B * S} tokens): MoE slots dropped {dropped_none}")
    if dropped_none:
        fail(f"moe 13.1: {dropped_none} slots dropped at a capacity where none can")
    p_len = S - DECODE_STEPS
    ref = full[:, p_len - 1:].clone()
    absmax_ref = float(full[..., :cfg.vocab_size].abs().max())
    del full
    torch.cuda.empty_cache()
    # Free routing: a bf16 ulp between the decode path (single-pass
    # attention, 4-row GEMMs) and the forward moves a router logit across a
    # near-tie of the top 6 of 64, and the token's later layers follow
    # another expert. Printed with the choices that moved; then the same
    # decode with each layer's experts pinned to the forward's choices for
    # that token (the gates still its own), held to the bound.
    k = cfg.top_k
    per_layer = [r.view(B, S, k) for r in fwd_routes.seen]
    n_moe = len(per_layer)
    with Routes() as free:
        prefill_s, dec_ms, worst_free = decode_checks(
            model, tokens, ref, p_len, absmax_ref, "moe 13.1 free routing", smi, gate=False)
    moved = [sum(int((torch.sort(free.seen[n_moe * (i + 1) + l], -1)[0] != torch.sort(
        per_layer[l][:, p_len + i], -1)[0]).any(-1).sum()) for l in range(n_moe))
        for i in range(DECODE_STEPS)]
    print(f"moe 13.1 free routing: (request, layer) choices of the decoded tokens whose top-{k} "
          f"set differs from the forward's, by step: {moved} of {B * n_moe} each")
    pin = [r[:, :p_len].reshape(-1, k) for r in per_layer]
    pin += [r[:, p_len + i] for i in range(DECODE_STEPS) for r in per_layer]
    with Routes(pin=pin):
        decode_checks(model, tokens, ref, p_len, absmax_ref, "moe 13.1 routing pinned", smi)
    model.moe_capacity = launch_serve.MOE_CAPACITY
    del ref, fwd_routes, per_layer, free, pin
    torch.cuda.empty_cache()
    # the compiled serve steps at the served capacity (free routing)
    graphed = graph_serve_checks(
        model, {"tokens": tokens[:, :p_len]},
        [tokens[:, p_len + i:p_len + i + 1] for i in range(DECODE_STEPS)], S, "moe 13.1", smi)
    # 19.1: the same programs on a world-1 mesh over these weights
    tp_family_graphs(dev, smi, model, {"tokens": tokens[:, :p_len]},
                     [tokens[:, p_len + i:p_len + i + 1] for i in range(DECODE_STEPS)], S,
                     "moe", MOE_ARCH)
    prof = profile_forward(lambda: model(tokens), f"moe 13.1 profile forward ({B} x {S})", smi,
                           {"expert bmm": {"aten::bmm"},
                            "dispatch and combine (sort, searchsorted, gathers, index_put)":
                            {"aten::sort", "aten::searchsorted", "aten::index",
                             "aten::index_put_", "aten::gather"},
                            "flash_attention": "kernel:flash_wgmma"})
    t_dev, t_edge = split_times[s_star]
    print(f"moe 13.1 times ({smi}): prefill_s={prefill_s:.4f} ({B}x{p_len} "
          f"tokens); decode_ms_per_step={dec_ms:.3f}; split s*={s_star} device_s={t_dev:.4f} "
          f"edge_s={t_edge:.4f}; forward_s={fwd_s:.4f}; busy_share={prof['busy_share']:.4f}; "
          f"free-routing decode worst {worst_free:.4f}; graphed: prefill_s="
          f"{graphed['prefill_s']:.4f} decode_ms_per_step={graphed['decode_ms']:.3f}; main "
          f"wall_s={main_wall:.3f}; phase 13.1 {time.perf_counter() - t_phase:.1f} s")
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    row["launches"] = main_launches["flash_attention"]
    return row, main_launches["flash_attention"]


def xlstm_phase(dev, smi: str) -> None:
    """Phase 13.2: xlstm-125m at full width and depth (no TPU kernel on its
    path): the entry point, split logits to the bit, cached decode, and a
    DecodeBatcher's caches exported and imported mid-run."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.core.types import tree_flatten
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.kernels import rg_lru as rl
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Model, xlstm
    from repro_torch.online import DecodeBatcher

    t_phase = time.perf_counter()
    cfg = configs.get(XLSTM_ARCH)
    B, S = SERVE_B, XLSTM_S
    for reset in (nr.reset_launches, fa.reset_launches, rl.reset_launches):
        reset()
    argv = ["--arch", XLSTM_ARCH, "--requests", str(B), "--seq", str(S), "--new-tokens", "1",
            "--seed", "0"]
    print(f"xlstm 13.2 main: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    out = launch_serve.main(argv)
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    launched = {**nr.LAUNCHES, **fa.LAUNCHES, **rl.LAUNCHES}
    s_star = out["split"]
    print(f"xlstm 13.2 main: s*={s_star} wall_s={main_wall:.3f} device_s={out['device_s']:.4f} "
          f"edge_s={out['edge_s']:.4f} link_s={out['link_s']:.4f} (simulated) "
          f"launches={launched}")
    if not 0 <= s_star <= cfg.n_layers:
        fail(f"xlstm 13.2: s*={s_star} out of range")
    if launched["flash_attention"] or launched["rg_lru"] or not launched["noma_cell_intra"]:
        fail(f"xlstm 13.2: launches {launched}: the plan runs the NOMA kernels, the model none")
    new_toks = out["new_tokens"]
    if tuple(new_toks.shape) != (B, 1) or int(new_toks.min()) < 0 or \
            int(new_toks.max()) >= cfg.vocab_size:
        fail(f"xlstm 13.2: new tokens {new_toks.tolist()} outside the vocabulary")
    del out
    gc.collect()

    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(launch_serve.PARAM_SEED))
    print(f"xlstm 13.2 model: {XLSTM_ARCH} {cfg.n_layers} layers (mlstm, slstm alternating), "
          f"{sum(p.numel() for p in model.parameters())} parameters, {model.param_bytes()} "
          f"bytes on the card")
    tokens = make_batch(0, 0, B, S, cfg.vocab_size, device=dev)["tokens"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, _, _ = model(tokens)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    if tuple(full.shape) != (B, S, model.vocab_padded) or not bool(torch.isfinite(full).all()):
        fail(f"xlstm 13.2 forward logits: shape {tuple(full.shape)} or not finite")
    absmax = float(full[..., :cfg.vocab_size].abs().max())    # past the vocab: -1e30
    print(f"xlstm 13.2 forward: logits {tuple(full.shape)} finite, max |logit| {absmax:.4f}, "
          f"{fwd_s:.3f} s")
    split_times = split_checks(model, tokens, full, (s_star, XLSTM_SPLIT), "xlstm 13.2", 0, smi)
    # a prefill is a whole number of mLSTM chunks (the reference asserts it)
    p_len = S - xlstm.CHUNK
    ref = full[:, p_len - 1:p_len + DECODE_STEPS].clone()
    del full
    prefill_s, dec_ms, _ = decode_checks(model, tokens, ref, p_len, absmax, "xlstm 13.2", smi)
    del ref
    # graphed against eager on a prompt of XLSTM_GRAPH_S tokens: capturing
    # the sLSTM loop over p_len steps takes 9.2 s (PERF.md section 6)
    graphed = graph_serve_checks(
        model, {"tokens": tokens[:, :XLSTM_GRAPH_S]},
        [tokens[:, XLSTM_GRAPH_S + i:XLSTM_GRAPH_S + i + 1] for i in range(DECODE_STEPS)], S,
        "xlstm 13.2", smi)
    tp_family_graphs(dev, smi, model, {"tokens": tokens[:, :XLSTM_GRAPH_S]},
                     [tokens[:, XLSTM_GRAPH_S + i:XLSTM_GRAPH_S + i + 1]
                      for i in range(DECODE_STEPS)], S, "xlstm", XLSTM_ARCH)

    # DecodeBatcher: 8 steps, the caches exported, 4 more steps on the live
    # batcher and on a fresh one that imported the export
    b, max_len = BATCH_SLOTS, ONLINE_S + 16
    toks = make_batch(13, 0, b, ONLINE_S, cfg.vocab_size, device=dev)["tokens"]
    db = DecodeBatcher(model, None, capacity=b, max_len=max_len)
    for i in range(b):
        db.admit(i, toks[i:i + 1])
    gen = torch.Generator(device=dev).manual_seed(13)
    steps = [torch.randint(0, cfg.vocab_size, (b, 1), device=dev, generator=gen,
                           dtype=torch.int32) for _ in range(12)]
    masks = [torch.tensor([j != i % (b + 1) for j in range(b)], device=dev)
             for i in range(12)]
    t_steps = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db.step(steps[i], masks[i])
        torch.cuda.synchronize()
        t_steps.append(time.perf_counter() - t0)
    snap = db.export_caches()
    fresh = DecodeBatcher(model, None, capacity=b, max_len=max_len)
    fresh.import_caches(snap)
    same = True
    for i in range(8, 12):
        same &= torch.equal(db.step(steps[i], masks[i]), fresh.step(steps[i], masks[i]))
    same &= all(torch.equal(x, y) for x, y in zip(tree_flatten(db.caches)[0],
                                                  tree_flatten(fresh.caches)[0]))
    n_bytes = sum(x.numel() * x.element_size() for x in tree_flatten(snap)[0])
    print(f"check xlstm 13.2 DecodeBatcher(capacity={b}) {b} admissions of {ONLINE_S} tokens, "
          f"8 masked steps ({statistics.median(t_steps) * 1e3:.3f} ms a step), export "
          f"({n_bytes / 2**20:.2f} MiB) -> import into a fresh batcher, 4 more steps: logits "
          f"and caches bit-equal to the uninterrupted batcher's: {same}")
    if not same:
        fail("xlstm 13.2: the batcher after an export / import differs from the live one")
    del db, fresh, snap
    prof = profile_forward(lambda: model(tokens[:, :ONLINE_S]),
                           f"xlstm 13.2 profile forward ({B} x {ONLINE_S})", smi)
    n_slstm = sum(sp.n_layers for sp in model.stages if sp.kind == "slstm")
    t_dev, t_edge = split_times[s_star]
    print(f"xlstm 13.2 times ({smi}): prefill_s={prefill_s:.4f} ({B}x{p_len} "
          f"tokens; {n_slstm} sLSTM layers x {p_len} steps, "
          f"{prefill_s / (n_slstm * p_len) * 1e6:.1f} us a layer-step); "
          f"decode_ms_per_step={dec_ms:.3f}; graphed ({B}x{XLSTM_GRAPH_S} prompt): prefill_s="
          f"{graphed['prefill_s']:.4f} (eager {graphed['prefill_eager_s']:.4f}) "
          f"decode_ms_per_step={graphed['decode_ms']:.3f}; split s*={s_star} "
          f"device_s={t_dev:.4f} edge_s={t_edge:.4f}; forward_s={fwd_s:.4f}; profiled "
          f"{B}x{ONLINE_S} forward: "
          f"busy_share={prof['busy_share']:.4f}, {prof['kernels']} kernels, "
          f"{prof['kernels'] / prof['wall_s']:.0f} launches a second; main wall_s="
          f"{main_wall:.3f}; phase 13.2 {time.perf_counter() - t_phase:.1f} s")
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()


def serve_main(arch: str, b: int, s: int, label: str, want_flash: int) -> dict:
    """The serving entry point (plan s*, cut, serve b requests of s tokens,
    one greedy continuation) with the launch counters set to 0 just before
    it and read just after: the NOMA kernels launched by the plan,
    want_flash flash_attention launches over both passes. Returns the
    entry point's split, its wall, its launches and its flash_attention
    launches by shape."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.launch import serve as launch_serve
    cfg = configs.get(arch)
    for reset in (nr.reset_launches, fa.reset_launches):
        reset()
    argv = ["--arch", arch, "--requests", str(b), "--seq", str(s), "--new-tokens", "2",
            "--seed", "0"]
    print(f"{label} main: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    out = launch_serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {**nr.LAUNCHES, **fa.LAUNCHES}
    shapes = dict(fa.SHAPES)
    print(f"{label} main: s*={out['split']} wall_s={wall:.3f} device_s={out['device_s']:.4f} "
          f"edge_s={out['edge_s']:.4f} link_s={out['link_s']:.4f} (simulated) "
          f"launches={launched}")
    if not 0 <= out["split"] <= cfg.n_layers:
        fail(f"{label}: s*={out['split']} out of range")
    if launched.pop("flash_attention_bwd"):
        fail(f"{label}: serving launched the attention backward")
    for name, n in launched.items():
        if n <= 0:
            fail(f"{label}: {name} was not launched on the serving main path")
    if launched["flash_attention"] != want_flash:
        fail(f"{label}: {launched['flash_attention']} flash_attention launches on the serving "
             f"main path, expected {want_flash}")
    new_toks = out["new_tokens"]
    if tuple(new_toks.shape) != (b, 2) or int(new_toks.min()) < 0 or \
            int(new_toks.max()) >= cfg.vocab_size:
        fail(f"{label}: new tokens {new_toks.tolist()} outside the vocabulary")
    return dict(split=out["split"], wall_s=wall, launches=launched, shapes=shapes)


def frontend_forward(model, tokens, frontend, label: str, want_flash: int):
    """One forward with a frontend: finite logits of the full shape and
    exactly want_flash flash_attention launches. Returns (logits, the
    largest |logit| in the vocabulary, seconds, the flash_attention
    launches by shape)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, s = tokens.shape
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, _, _ = model(tokens, frontend)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    if tuple(full.shape) != (b, s, model.vocab_padded) or not bool(torch.isfinite(full).all()):
        fail(f"{label} forward logits: shape {tuple(full.shape)} or not finite")
    absmax = float(full[..., :model.cfg.vocab_size].abs().max())
    n_fa = fa.LAUNCHES["flash_attention"]
    print(f"{label} forward with a frontend {tuple(frontend.shape)}: logits {tuple(full.shape)} "
          f"finite, max |logit| {absmax:.4f}, {fwd_s:.3f} s; flash_attention launches {n_fa}")
    if n_fa != want_flash:
        fail(f"{label} forward: {n_fa} flash_attention launches, expected {want_flash}")
    return full, absmax, fwd_s, dict(fa.SHAPES)


class SinglePassAttention:
    """Within a with-block, ops.flash_attention computes what a decode step
    computes instead: the models' single pass (attention._single_pass,
    scores rounded to bf16) over the whole sequence, 256 queries at a time.
    A forward then rounds its attention where the cached decode does."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops
        from repro_torch.models import attention
        self.ops, self.orig = ops, ops.flash_attention

        def single(q, k, v, causal=True, window=0):
            b, sq, h, hd = q.shape
            sk, kv = k.shape[1], k.shape[2]
            k, v = k.to(attention.COMPUTE_DTYPE), v.to(attention.COMPUTE_DTYPE)
            k_pos = torch.arange(sk, dtype=torch.int32, device=q.device)[None].expand(b, sk)
            outs = []
            for i in range(0, sq, 256):
                qc = q[:, i:i + 256]
                n = qc.shape[1]
                q_pos = torch.arange(i, i + n, dtype=torch.int32, device=q.device)[None]
                outs.append(attention._single_pass(
                    qc.reshape(b, n, kv, h // kv, hd), k, v, q_pos.expand(b, n), k_pos,
                    causal, window).reshape(b, n, h, hd))
            return torch.cat(outs, 1)

        ops.flash_attention = single
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.orig


def vlm_phase(dev, smi: str, errs: dict) -> tuple[dict, int]:
    """Phase 14.1: llama-3.2-vision-11b at full width and depth, its cross
    blocks' gates set to VLM_XGATE (the reference starts them at 0, where a
    cross block adds nothing). Returns the flash timing rows at every shape
    its paths launch and the flash_attention launches of the serving main
    path, the forward with a frontend and the prefill; adds the flash
    checks' errors to errs."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Model

    t_phase = time.perf_counter()
    cfg = configs.get(VLM_ARCH)
    B, S, SF = SERVE_B, SERVE_S, cfg.frontend_tokens
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p_len = S - DECODE_STEPS
    # the entry point has no frontend (the reference's has none), so each
    # cross block attends over its own input, unmasked; its second pass is the
    # greedy continuation's, one token longer
    rows, keys = flash_rows(dev, VLM_ARCH, B, H, KV, HD, {
        "self-attention": (S, S, True),
        "self-attention, continuation": (S + 1, S + 1, True),
        "self-attention, prefill": (p_len, p_len, True),
        "cross block over its own input": (S, S, False),
        "cross block over its own input, continuation": (S + 1, S + 1, False),
        "cross-attention": (S, SF, False),
        "cross-attention, prefill": (p_len, SF, False)}, errs, smi, 140)
    torch.cuda.empty_cache()

    n_blocks = cfg.n_layers
    main = serve_main(VLM_ARCH, B, S, "vlm 14.1", 2 * n_blocks)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(launch_serve.PARAM_SEED))
    for spec, layers in zip(model.stages, model.stage_layers):
        if spec.kind == "cross":
            for blk in layers:
                blk.p.xgate.fill_(VLM_XGATE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vlm 14.1 model: {VLM_ARCH} {n_blocks} layers "
          f"({[(sp.kind, sp.n_layers) for sp in model.stages[:2]]} x {len(model.stages) // 2}), "
          f"{n_params} parameters, {model.param_bytes()} bytes on the card, init "
          f"{time.perf_counter() - t0:.2f} s, xgate {VLM_XGATE}")
    batch = make_batch(0, 0, B, S, cfg.vocab_size, frontend_shape=(SF, cfg.d_model), device=dev)
    tokens, frontend = batch["tokens"], batch["frontend"]
    full, absmax, fwd_s, fwd_shapes = frontend_forward(model, tokens, frontend, "vlm 14.1",
                                                       n_blocks)
    # the cross path is live: a redrawn frontend moves the logits
    other = make_batch(1, 0, B, 1, cfg.vocab_size, frontend_shape=(SF, cfg.d_model),
                       device=dev)["frontend"]
    moved, _, _ = model(tokens, other)
    diff = (moved - full).abs()
    share = float((diff.amax(-1) > 0).float().mean())
    print(f"check vlm 14.1 a redrawn frontend moves the logits: max |diff| "
          f"{float(diff.max()):.4f}, at {share:.4f} of the positions")
    if not share >= 0.5:
        fail(f"vlm 14.1: a redrawn frontend moves the logits at only {share:.4f} of the "
             "positions: the cross path is not live")
    del moved, diff, other
    torch.cuda.empty_cache()
    split_times = split_checks(model, tokens, full, (main["split"], VLM_SPLIT), "vlm 14.1",
                               n_blocks, smi, frontend)
    ref = full[:, p_len - 1:].clone()
    del full
    torch.cuda.empty_cache()
    # a witness for the size of rounding noise: request 0's forward alone (the
    # same function, its GEMMs a quarter as tall)
    alone = float((model(tokens[:1], frontend[:1])[0][0, p_len - 1:] - ref[0]).abs().max())
    torch.cuda.empty_cache()
    fa.reset_launches()
    prefill_s, dec_ms, worst = decode_checks(model, tokens, ref, p_len, absmax, "vlm 14.1", smi,
                                             frontend=frontend)
    pre_shapes = dict(fa.SHAPES)
    graphed = graph_serve_checks(
        model, {"tokens": tokens[:, :p_len], "frontend": frontend},
        [tokens[:, p_len + i:p_len + i + 1] for i in range(DECODE_STEPS)], S, "vlm 14.1", smi)
    tp_family_graphs(dev, smi, model, {"tokens": tokens[:, :p_len], "frontend": frontend},
                     [tokens[:, p_len + i:p_len + i + 1] for i in range(DECODE_STEPS)], S,
                     "vlm", VLM_ARCH)
    # a witness for the decode's distance from the forward: the same forward,
    # prefill and decode with every attention taking the decode's single pass
    with SinglePassAttention():
        sp_full, _, _ = model(tokens, frontend)
        sp_ref = sp_full[:, p_len - 1:].clone()
        del sp_full
        torch.cuda.empty_cache()
        gap = float((sp_ref - ref).abs().max())
        _, _, sp_worst = decode_checks(model, tokens, sp_ref, p_len, absmax,
                                       "vlm 14.1 witness, single-pass attention throughout",
                                       smi, gate=False, frontend=frontend)
    tol = 0.05 * max(1.0, absmax)
    print(f"vlm 14.1 witness: request 0's forward alone against the batch's at the last "
          f"{DECODE_STEPS + 1} positions {alone:.4f} ({alone / tol:.3f} of the bound); the "
          f"single-pass forward against the kernel's {gap:.4f} ({gap / tol:.3f}); decode "
          f"against the kernel's forward {worst:.4f} ({worst / tol:.3f}), against the "
          f"single-pass forward {sp_worst:.4f} ({sp_worst / tol:.3f}) | {smi}")
    del ref, sp_ref
    prof = profile_forward(lambda: model(tokens, frontend),
                           f"vlm 14.1 profile forward ({B} x {S}, frontend {SF})", smi,
                           {"GEMMs (aten::mm)": {"aten::mm"},
                            "flash_attention": "kernel:flash_wgmma"})
    t_dev, t_edge = split_times[main["split"]]
    print(f"vlm 14.1 times ({smi}): prefill_s={prefill_s:.4f} ({B}x{p_len} tokens); "
          f"decode_ms_per_step={dec_ms:.3f}; graphed: prefill_s={graphed['prefill_s']:.4f} "
          f"decode_ms_per_step={graphed['decode_ms']:.3f}; split s*={main['split']} "
          f"device_s={t_dev:.4f} "
          f"edge_s={t_edge:.4f}; forward_s={fwd_s:.4f}; busy_share={prof['busy_share']:.4f}; "
          f"main wall_s={main['wall_s']:.3f}; phase 14.1 {time.perf_counter() - t_phase:.1f} s")
    del model, tokens, frontend, batch
    gc.collect()
    torch.cuda.empty_cache()
    launches = attach_launches(rows, keys, {"entry point": main["shapes"],
                                            "forward with a frontend": fwd_shapes,
                                            "prefill and decode": pre_shapes},
                               "vlm 14.1", {"compiled prefill": graphed["prefill_shapes"]})
    return rows, launches


def audio_phase(dev, smi: str, errs: dict) -> tuple[dict, int]:
    """Phase 14.2: whisper-small at full size, 4 requests of AUDIO_S decoder
    tokens over a frontend of its 1500 frames. Returns the flash timing
    rows at every shape its paths launch and the flash_attention launches
    of the serving main path, the forward with a frontend and the prefill;
    adds the flash checks' errors to errs."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Model

    t_phase = time.perf_counter()
    cfg = configs.get(AUDIO_ARCH)
    B, S, SF = SERVE_B, AUDIO_S, cfg.frontend_tokens
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p_len = S - DECODE_STEPS
    # the entry point runs the reference's split: the encoder's blocks over the
    # token embeddings and the decoder's cross-attention over its own input,
    # both unmasked over S tokens; its second pass is one token longer
    rows, keys = flash_rows(dev, AUDIO_ARCH, B, H, KV, HD, {
        "encoder": (SF, SF, False),
        "decoder self-attention": (S, S, True),
        "decoder self-attention, continuation": (S + 1, S + 1, True),
        "decoder self-attention, prefill": (p_len, p_len, True),
        "decoder cross-attention": (S, SF, False),
        "decoder cross-attention, prefill": (p_len, SF, False),
        "split over its own input": (S, S, False),
        "split over its own input, continuation": (S + 1, S + 1, False)}, errs, smi, 160)
    torch.cuda.empty_cache()

    n_flash = cfg.encoder_layers + 2 * cfg.n_layers
    main = serve_main(AUDIO_ARCH, B, S, "audio 14.2", 2 * n_flash)
    gc.collect()

    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(launch_serve.PARAM_SEED))
    print(f"audio 14.2 model: {AUDIO_ARCH} {[(sp.kind, sp.n_layers) for sp in model.stages]}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, {model.param_bytes()} "
          f"bytes on the card")
    batch = make_batch(0, 0, B, S, cfg.vocab_size, frontend_shape=(SF, cfg.d_model), device=dev)
    tokens, frontend = batch["tokens"], batch["frontend"]
    full, absmax, fwd_s, fwd_shapes = frontend_forward(model, tokens, frontend, "audio 14.2",
                                                       n_flash)
    fa.reset_launches()
    prefill_s, dec_ms, _ = decode_checks(model, tokens, full[:, p_len - 1:].clone(), p_len,
                                         absmax, "audio 14.2 (decode through enc_out)", smi,
                                         frontend=frontend)
    pre_shapes = dict(fa.SHAPES)
    del full
    graphed = graph_serve_checks(
        model, {"tokens": tokens[:, :p_len], "frontend": frontend},
        [tokens[:, p_len + i:p_len + i + 1] for i in range(DECODE_STEPS)], S, "audio 14.2", smi)
    tp_family_graphs(dev, smi, model, {"tokens": tokens[:, :p_len], "frontend": frontend},
                     [tokens[:, p_len + i:p_len + i + 1] for i in range(DECODE_STEPS)], S,
                     "audio", AUDIO_ARCH)
    # the reference's split (not its forward): the second split point bit-equal
    # to the first
    split_times = split_checks(model, tokens, None, (main["split"], AUDIO_SPLIT),
                               "audio 14.2 reference-shaped", n_flash, smi, frontend)
    prof = profile_forward(lambda: model(tokens, frontend),
                           f"audio 14.2 profile forward ({B} x {S}, frontend {SF})", smi,
                           {"GEMMs (aten::mm)": {"aten::mm"},
                            "flash_attention": "kernel:flash_wgmma"})
    t_dev, t_edge = split_times[main["split"]]
    print(f"audio 14.2 times ({smi}): prefill_s={prefill_s:.4f} ({B}x{p_len} tokens and the "
          f"encoder over {SF} frames); decode_ms_per_step={dec_ms:.3f}; graphed: prefill_s="
          f"{graphed['prefill_s']:.4f} decode_ms_per_step={graphed['decode_ms']:.3f}; split s*="
          f"{main['split']} device_s={t_dev:.4f} edge_s={t_edge:.4f}; forward_s={fwd_s:.4f}; "
          f"busy_share={prof['busy_share']:.4f}; main wall_s={main['wall_s']:.3f}; "
          f"phase 14.2 {time.perf_counter() - t_phase:.1f} s")
    del model, tokens, frontend, batch
    gc.collect()
    torch.cuda.empty_cache()
    launches = attach_launches(rows, keys, {"entry point": main["shapes"],
                                            "forward with a frontend": fwd_shapes,
                                            "prefill and decode": pre_shapes},
                               "audio 14.2", {"compiled prefill": graphed["prefill_shapes"]})
    return rows, launches



def event_ms(fn, reps: int = 5, trials: int = 5) -> float:
    """Median device milliseconds of one call, from CUDA events around
    `reps` eager calls: for a call that a CUDA graph cannot capture (an
    autograd backward runs on its forward's stream), long enough that the
    host stays ahead of the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bwd_ptxas(log: str) -> list[tuple]:
    """(kernel, registers, (spill store bytes, spill load bytes)) of every
    flash_bwd_ kernel in a ptxas -v log: the kernel named by its
    template arguments (dtype, head dim)."""
    out, name, spills = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            sym = m.group(1)
            k = re.search(r"(flash_bwd_[a-z_]+kernel)", sym)
            name = None
            if k:
                hd = re.search(r"Li(\d+)E", sym)
                dt = "bf16" if "bfloat16" in sym else ("float32" if "IfLi" in sym else "")
                name = " ".join(x for x in (k.group(1), dt, f"hd {hd.group(1)}" if hd else "")
                                if x)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Paths of a tree's leaves in tree_flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


def check_bwd(dev, gen, errs: dict, tag: str, bh, g, sq, sk, hd, causal, window, kv_len=None,
              dtype=None):
    """flash_attention's forward (with the log-sum-exp) and
    flash_attention_bwd against their twins at one shape of random bf16 (or
    ``dtype``) inputs drawn from ``gen``: the forward bit-equal to the
    serving call's, two backward launches bit-equal, each gradient within
    FLASH_BWD_RTOL of its terms' scale. Adds the worst errors to errs;
    returns (q, k, v, out, lse, dout)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    dtype = dtype or torch.bfloat16
    q = torch.randn((bh, sq, hd), device=dev, generator=gen).to(dtype)
    k, v = (torch.randn((bh // g, sk, hd), device=dev, generator=gen).to(dtype)
            for _ in range(2))
    dout = torch.randn((bh, sq, hd), device=dev, generator=gen).to(dtype)
    args = (g, causal, window, kv_len)
    f32 = dtype == torch.float32
    out, lse = fa.flash_attention(q, k, v, *args, return_lse=True)
    served = fa.flash_attention(q, k, v, *args)
    torch.cuda.synchronize()
    if not torch.equal(out, served):
        fail(f"flash_attention {tag}: the output with the log-sum-exp differs from the "
             "serving call's")
    want_out, want_lse = fa.flash_attention_plain(q, k, v, *args, return_lse=True)
    check(f"flash_attention {tag} (with lse)", out.float(), want_out.float(),
          FLASH_F32_RTOL if f32 else FLASH_RTOL,
          fa.flash_attention_plain(q, k, v.abs(), *args).float(), errs, "flash_attention")
    check(f"flash_attention {tag} lse", lse, want_lse, LSE_RTOL, 1 + want_lse.abs())
    del want_out, want_lse, served
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, *args)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, *args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"check flash_attention_bwd {tag}: two launches bit-equal: {same}")
    if not same:
        fail(f"flash_attention_bwd {tag}: two launches on the same inputs differ")
    del again
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, *args)
    scales = fa.flash_attention_bwd_scale(q, k, v, out, lse, dout, *args)
    for name, x, w, sc in zip(("dq", "dk", "dv"), got, want, scales):
        check(f"flash_attention_bwd {tag} {name}", x.float(), w.float(),
              FLASH_BWD_F32_RTOL if f32 else FLASH_BWD_RTOL, sc, errs,
              "flash_attention_bwd")
    return q, k, v, out, lse, dout


def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: query i (at position i)
    sees keys j <= i (causal) within ``window`` (when set), or every key."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk, window or sk) for i in range(sq))


def time_bwd(label: str, b: int, h: int, kv: int, hd: int, tensors, smi: str,
             causal: bool = True, window: int = 0) -> dict:
    """flash_attention_bwd at one (b * h, Sq, hd) shape over Sk keys beside
    its twin, SDPA's backward (enable_gqa where G > 1; is_causal, a band
    mask for a window, no mask for a bidirectional or cross call) and its
    bound; each of its three kernels' device time within one call
    (torch.profiler over 5 calls). Returns the row."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType

    from repro_torch import graphs
    from repro_torch.kernels import flash_attention as fa
    q, k, v, out, lse, dout = tensors
    bh, sq, sk, g = b * h, q.shape[1], k.shape[1], h // kv
    args = (g, causal, window, None)
    pairs = bh * attention_pairs(sq, sk, causal, window)
    bwd_ops = 10 * hd * pairs
    # q out dout dq (query head rows), k v dk dv (KV rows), lse
    bwd_bytes = 2 * (4 * bh * sq + 4 * b * kv * sk) * hd + 4 * bh * sq
    t_ops, t_bytes = bwd_ops / BF16_OPS_PER_S * 1e3, bwd_bytes / HBM_BYTES_PER_S * 1e3
    qs = q.view(b, h, sq, hd).detach().requires_grad_(True)
    ks, vs = (t.view(b, kv, sk, hd).detach().requires_grad_(True) for t in (k, v))
    mask, mask_name = None, "no mask"
    if causal and window:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None]
        mask, mask_name = (kj <= qi) & (qi - kj < window), f"band mask (window {window})"
    elif causal:
        mask_name = "is_causal"
    o_s = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         is_causal=causal and not window, enable_gqa=g > 1)
    do_s = dout.view(b, h, sq, hd)

    def sdpa_bwd():
        return torch.autograd.grad(o_s, (qs, ks, vs), do_s, retain_graph=True)

    lib_grads = sdpa_bwd()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, *args)
    scales = fa.flash_attention_bwd_scale(q, k, v, out, lse, dout, *args)
    lib_err = [float(((x.reshape(w.shape).float() - w.float()).abs() / sc).max())
               for x, w, sc in zip(lib_grads, want, scales)]
    del lib_grads, want, scales
    print(f"flash_attention_bwd library yardstick at {label}: SDPA's backward ({mask_name}"
          f"{', enable_gqa' if g > 1 else ''}) against the twin (its own forward, not the "
          f"kernel's): dq/dk/dv worst {lib_err} of the terms' scale")
    torch.cuda.empty_cache()
    row = {
        "ms": device_ms([lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, *args)],
                        reps=5),
        "plain_ms": device_ms([lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                                    *args)],
                              reps=1, trials=3),
        "library_ms": event_ms(sdpa_bwd),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print(f"time flash_attention_bwd at {label} ({bh}, {sq}, {hd}) over {sk} keys G={g} "
          f"{'causal' if causal else 'no mask'}{f' window {window}' if window else ''}: "
          + " ".join(f"{k_}={v_}" for k_, v_ in row.items())
          + f" ({bwd_ops:.4e} FLOP = 10 hd x {pairs} unmasked pairs, "
          f"{bwd_bytes / 1e6:.1f} MB; one call = 3 CUDA launches, D, dK/dV, dQ; library: "
          f"torch.autograd.grad of scaled_dot_product_attention, {mask_name}, CUDA events "
          f"around 5 eager calls) | {smi}")

    def five():
        for _ in range(5):
            fa.flash_attention_bwd(q, k, v, out, lse, dout, *args)

    split = {}
    for _ in range(3):   # a window the profiler returns empty is taken again
        fa.flash_attention_bwd(q, k, v, out, lse, dout, *args)
        with graphs.traced() as prof:
            five()
        split = {e.key.split("<")[0].split("::")[-1].split(" ")[-1]:
                 e.self_device_time_total / 5e3 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "flash_bwd_" in e.key}
        if split:
            break
    print(f"time flash_attention_bwd at {label}: device ms a call by kernel (torch.profiler, "
          f"5 calls): " + (" ".join(f"{k_}={v_}" for k_, v_ in split.items()) or
                           "not measured (three windows with no device record)") + f" | {smi}")
    return row


def train_phase(dev, smi: str, errs: dict, peaks: dict) -> tuple[dict, dict, dict]:
    """Phase 15: training qwen1.5-0.5b at full size. Returns the
    flash_attention_bwd timing row, the forward's timing row at the train
    step's shape, and the main paths' launches of both kernels (15.2's
    steps and 15.3's entry point, each counted from 0 around it); adds the
    kernels' worst errors to errs and the sub-phases' peak reserves to
    peaks."""
    import gc
    import math
    import shutil
    import tempfile
    from collections import Counter

    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.checkpoint import list_steps
    from repro_torch.core.types import tree_flatten
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import clip_by_global_norm
    from repro_torch.runtime import train as rt

    t_phase = time.perf_counter()
    cfg = configs.get(TRAIN_ARCH)
    H, KV, HD, L = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    G = H // KV
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(15)
    entry = launch_train.parse_args([])

    # -- 15.1 the backward kernel against its plain twin -----------------------------
    def check_bwd_(tag, bh, g, sq, sk, hd, causal, window, kv_len=None, dtype=bf16):
        return check_bwd(dev, gen, errs, tag, bh, g, sq, sk, hd, causal, window, kv_len, dtype)

    # every shape the paths below launch (hd 64, G = 1, causal): label -> (rows, S)
    train_shapes = {"train step": (TRAIN_B * H, TRAIN_S),
                    "microbatch": (TRAIN_B // 4 * H, TRAIN_S),
                    "cross-entropy check": (CE_B * H, CE_S),
                    "entry point": (entry.batch * H, entry.seq)}
    checked = set()
    for label, (bh, s_) in reversed(train_shapes.items()):
        tensors = check_bwd_(f"{TRAIN_ARCH} {label} ({bh}, {s_}, {HD}) G={G} causal", bh, G,
                            s_, s_, HD, True, 0)
        checked.add((bh, s_, s_, HD, G, True, 0, s_))
    grid = [("window 100 G=1 hd 64", 8, 1, 300, 300, 64, True, 100),
            ("bidirectional G=4 hd 64", 8, 4, 200, 200, 64, False, 0),
            ("causal G=4 hd 128 ragged", 8, 4, 257, 257, 128, True, 0),
            ("causal Sq=100 < Sk=150 G=2 hd 32", 4, 2, 100, 150, 32, True, 0),
            ("bidirectional Sq=150 > Sk=100 G=2 hd 32", 4, 2, 150, 100, 32, False, 0),
            ("causal kv_len=170 < Sk=200 hd 64", 4, 1, 200, 200, 64, True, 0, 170),
            ("bidirectional kv_len=150 < Sk=200 G=4 hd 256", 4, 4, 130, 200, 256, False, 0,
             150),
            ("window 77 G=2 hd 256", 4, 2, 300, 300, 256, True, 77),
            ("causal hd 32", 4, 1, 130, 130, 32, True, 0)]
    grid += [(f"float32 causal Sq=150 Sk=170 G=2 hd {hd}", 4, 2, 150, 170, hd, True, 0, None,
              torch.float32) for hd in fa.HEAD_DIMS]
    grid.append(("float32 window 33 bidirectional kv_len=101 G=4 hd 64", 4, 4, 120, 130, 64,
                 False, 33, 101, torch.float32))
    for case in grid:
        check_bwd_(*case)
        torch.cuda.empty_cache()

    # the backward's build: each kernel's registers and spills from ptxas, and
    # the dynamic shared memory each bf16 kernel opts in to against the
    # block table's mirror of it (flash_attention.bwd_smem_bytes)
    for kern, regs, spills in bwd_ptxas(build.BUILD_INFO["flash_attention_bwd"]["log"]):
        print(f"build flash_attention_bwd {kern}: {regs} registers, spills {spills}")
        if "wgmma" in kern and spills != (0, 0):
            fail(f"flash_attention_bwd {kern}: ptxas spills {spills} (stores, loads) bytes")
    lib = build.load("flash_attention_bwd")
    for hd in fa.HEAD_DIMS:
        for dt in fa.DTYPES:
            got_smem = tuple(lib.flash_attention_bwd_smem(hd, int(dt == bf16), kernel)
                             for kernel in (0, 1))
            print(f"build flash_attention_bwd shared memory hd {hd} {dt}: (dK/dV, dQ) "
                  f"{got_smem} bytes")
            if got_smem != fa.bwd_smem_bytes(hd, dt):
                fail(f"flash_attention_bwd hd {hd} {dt}: the kernels opt in to {got_smem} "
                     f"bytes, bwd_smem_bytes says {fa.bwd_smem_bytes(hd, dt)}")

    def time_bwd_(label, b, h, kv, hd, tensors):
        return time_bwd(label, b, h, kv, hd, tensors, smi)

    bwd_row = time_bwd_(f"{TRAIN_ARCH}'s train shape", TRAIN_B, H, KV, HD, tensors)
    del tensors
    gc.collect()
    torch.cuda.empty_cache()
    # the hd-128 layout of the other dense archs: qwen2-1.5b, 8 x 12 query
    # heads over 2 KV heads (G = 6), S 2048, causal
    w_cfg = configs.get(WIDE_ARCH)
    w_b, w_h, w_kv, w_hd = TRAIN_B, w_cfg.n_heads, w_cfg.n_kv_heads, w_cfg.hd
    wide = check_bwd_(f"{WIDE_ARCH} ({w_b * w_h}, {TRAIN_S}, {w_hd}) G={w_h // w_kv} causal",
                     w_b * w_h, w_h // w_kv, TRAIN_S, TRAIN_S, w_hd, True, 0)
    time_bwd_(f"{WIDE_ARCH}'s layout", w_b, w_h, w_kv, w_hd, wide)
    del wide
    gc.collect()
    torch.cuda.empty_cache()
    fwd_row = flash_row(dev, f"{TRAIN_ARCH} train", TRAIN_B, H, KV, TRAIN_S, TRAIN_S, HD, True,
                        errs, smi, 151)
    torch.cuda.empty_cache()
    memory_mark(torch, "15.1", peaks)
    print(f"train: 15.1 took {time.perf_counter() - t_phase:.1f} s")

    # -- 15.2 the train step at full size ---------------------------------------------
    t_sub = t0 = time.perf_counter()
    model = Model(cfg, device=dev, trainable=True, remat=True)
    state = rt.init_state(model, torch.Generator(device=dev).manual_seed(TRAIN_SEED))
    torch.cuda.synchronize()
    leaves = tree_flatten(model.param_tree())[0]
    n_params = sum(x.numel() for x in leaves)
    # matmul parameters: every block's 2-D weight and the unembedding (the
    # embedding is a lookup)
    mm_params = sum(blk.p.tree()[grp][w].numel() for layers in model.stage_layers
                    for blk in layers for grp in ("attn", "mlp") for w in blk.p.tree()[grp]
                    if blk.p.tree()[grp][w].ndim == 2) + model.top.unembed.numel()
    tokens = TRAIN_B * TRAIN_S
    att_pairs = L * TRAIN_B * H * TRAIN_S * (TRAIN_S + 1) // 2
    flops = 6 * mm_params * tokens + 12 * HD * att_pairs
    print(f"train 15.2 model: {TRAIN_ARCH} {L} layers, {n_params} parameters (float32 masters, "
          f"{model.param_bytes()} bytes), init {time.perf_counter() - t0:.2f} s; model FLOPs a "
          f"step: 6 x {mm_params} matmul parameters x {tokens} tokens = "
          f"{6 * mm_params * tokens:.4e} + attention 12 hd x {att_pairs} unmasked pairs "
          f"(forward 4 hd, backward 8 hd; remat's recomputation not counted) = "
          f"{12 * HD * att_pairs:.4e}: {flops:.4e}")
    step = rt.make_train_step(model, n_microbatches=1, base_lr=TRAIN_LR, seq_chunk=TRAIN_CHUNK)
    want_launches = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    data = SyntheticLM(TRAIN_SEED, TRAIN_B, TRAIN_S, cfg.vocab_size, device=dev)
    losses, walls = [], []
    launches = Counter()
    shapes = {"forward": Counter(), "backward": Counter()}
    try:
        for i in range(TRAIN_STEPS):
            batch = next(data)
            torch.cuda.synchronize()
            fa.reset_launches()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = dict(fa.LAUNCHES)
            launches.update(got)
            shapes["forward"].update(fa.SHAPES)
            shapes["backward"].update(fa.BWD_SHAPES)
            losses.append(float(met["loss"]))
            if got != want_launches:
                fail(f"train 15.2 step {i}: flash launches {got}, expected {want_launches}")
            if not math.isfinite(losses[-1]):
                fail(f"train 15.2 step {i}: loss {losses[-1]}")
        prof_batch = next(data)
    finally:
        data.close()
    print(f"train 15.2 losses over {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens "
          f"(base_lr {TRAIN_LR}, warmup 100): {[round(x, 4) for x in losses]}")
    if not losses[-1] < losses[0]:
        fail(f"train 15.2: the loss did not fall ({losses[0]} -> {losses[-1]})")
    for kind, seen in shapes.items():
        unchecked = sorted(k for k in seen if k not in checked)
        if unchecked:
            fail(f"train 15.2: the {kind} kernel ran at shapes 15.1 did not check: {unchecked}")
    step_s = statistics.median(walls[1:])
    # one profiled step: the busy share and where the time goes
    prof, prof_wall, (state, met), rows_k, busy_us = profiled(
        lambda: step(state, prof_batch), "train 15.2 step")
    fwd_us = sum(e.self_device_time_total for e in rows_k if "flash_wgmma_kernel" in e.key)
    bwd_us = sum(e.self_device_time_total for e in rows_k if "flash_bwd_" in e.key)
    gemm_us = sum(e.self_device_time_total for e in rows_k
                  if any(t in e.key.lower() for t in ("gemm", "cutlass", "sm90_xmma", "nvjet")))
    for e in sorted(rows_k, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"train 15.2 profile kernel {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.self_device_time_total / busy_us:6.1%} {e.count:6d} launches  {e.key[:80]}")
    peak = torch.cuda.max_memory_reserved()
    train_row = dict(step_ms=step_s * 1e3, step_ms_min=min(walls) * 1e3,
                     tokens_per_s=tokens / step_s, mfu=flops / step_s / BF16_OPS_PER_S,
                     busy_share=busy_us / 1e6 / prof_wall, profiled_step_ms=prof_wall * 1e3,
                     flash_fwd_share=fwd_us / busy_us, flash_bwd_share=bwd_us / busy_us,
                     gemm_share=gemm_us / busy_us, peak_reserved_gib=peak / 2**30,
                     loss_first=losses[0], loss_last=losses[-1])
    print(f"time train 15.2 ({TRAIN_B} x {TRAIN_S} tokens a step, chunked cross-entropy "
          f"{TRAIN_CHUNK}): " + " ".join(f"{k}={v}" for k, v in train_row.items())
          + f" | {smi}")

    # two passes from one state and batch: the same bits?
    g_a = rt.loss_and_grads(model, prof_batch, seq_chunk=TRAIN_CHUNK)
    g_b = rt.loss_and_grads(model, prof_batch, seq_chunk=TRAIN_CHUNK)
    differ = [name for name, a, b in zip(leaf_names(g_a[2]), tree_flatten(g_a[2])[0],
                                         tree_flatten(g_b[2])[0]) if not torch.equal(a, b)]
    print(f"check train 15.2 two gradient passes from one state and batch bit-equal: loss "
          f"{torch.equal(g_a[0], g_b[0])}, gradient leaves differing: {differ or 'none'}")
    del g_a, g_b

    # chunked against unchunked cross-entropy where (B, S, V) logits fit
    ce_batch = make_batch(TRAIN_SEED + 1, 0, CE_B, CE_S, cfg.vocab_size, device=dev)
    fa.reset_launches()
    nll_c, _, g_c = rt.loss_and_grads(model, ce_batch, seq_chunk=CE_CHUNK)
    gn_c = float(clip_by_global_norm(g_c)[1])
    del g_c
    nll_u, _, g_u = rt.loss_and_grads(model, ce_batch)
    gn_u = float(clip_by_global_norm(g_u)[1])
    del g_u
    nll_c, nll_u = float(nll_c), float(nll_u)
    print(f"check train 15.2 chunked ({CE_CHUNK}) against unchunked cross-entropy at {CE_B} x "
          f"{CE_S}: loss {nll_c!r} / {nll_u!r} (rel {abs(nll_c - nll_u) / abs(nll_u):.3e}), "
          f"grad norm {gn_c!r} / {gn_u!r} (rel {abs(gn_c - gn_u) / gn_u:.3e})")
    if abs(nll_c - nll_u) > 1e-5 * abs(nll_u) or abs(gn_c - gn_u) > 1e-3 * gn_u:
        fail("train 15.2: chunked and unchunked cross-entropy differ beyond loss rtol 1e-5 / "
             "grad norm rtol 1e-3")

    # 4 microbatches against 1 on one batch from a fresh state (lr 0 at step 0)
    mb_batch = make_batch(TRAIN_SEED + 2, 0, TRAIN_B, TRAIN_S, cfg.vocab_size, device=dev)
    results = []
    for n in (1, 4):
        st0 = rt.init_state(model, torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        p0 = [x.detach().clone() for x in tree_flatten(st0.params)[0]]
        st1, m1 = rt.make_train_step(model, n_microbatches=n, base_lr=TRAIN_LR,
                                     seq_chunk=TRAIN_CHUNK)(st0, mb_batch)
        same_p = all(torch.equal(a, b) for a, b in zip(p0, tree_flatten(st1.params)[0]))
        results.append((float(m1["loss"]), float(m1["grad_norm"]), st1.opt.m, same_p))
        del p0, st0, st1
    (l1, gn1, mom1, same1), (l4, gn4, mom4, same4) = results
    mom_err = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                  for a, b in zip(tree_flatten(mom1)[0], tree_flatten(mom4)[0]))
    print(f"check train 15.2 4 microbatches against 1 at {TRAIN_B} x {TRAIN_S}: loss {l4!r} / "
          f"{l1!r} (rel {abs(l4 - l1) / abs(l1):.3e}), grad norm {gn4!r} / {gn1!r} "
          f"(rel {abs(gn4 - gn1) / gn1:.3e}), first moments worst {mom_err:.3e} of the leaf's "
          f"largest; params unchanged by the lr-0 step {same1} / {same4}")
    if abs(l4 - l1) > 1e-4 * abs(l1) or not (same1 and same4):
        fail("train 15.2: 4 microbatches and 1 differ beyond the reference's loss rtol 1e-4, "
             "or a step at lr 0 moved a parameter")
    del results, mom1, mom4, model, state, step, batch, prof_batch, prof
    gc.collect()
    torch.cuda.empty_cache()
    memory_mark(torch, "15.2", peaks)
    print(f"train: 15.2 took {time.perf_counter() - t_sub:.1f} s")

    # -- 15.3 the entry point: a run that crosses --ckpt-every, a restart ----------------
    t_sub = t0 = time.perf_counter()
    model = Model(cfg, device=dev, moe_capacity=2.0, trainable=True, remat=True)
    state = rt.init_state(model, torch.Generator(device=dev).manual_seed(entry.seed))
    step = rt.make_train_step(model, entry.microbatches)
    data = SyntheticLM(entry.seed, entry.batch, entry.seq, cfg.vocab_size, device=dev)
    ref = []
    try:
        for _ in range(ENTRY_STEPS + ENTRY_RESUMED):
            state, met = step(state, next(data))
            ref.append(float(met["loss"]))
    finally:
        data.close()
    ref_s = time.perf_counter() - t0
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    base = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = ["--log-every", "1", "--ckpt-every", str(ENTRY_EVERY), "--ckpt-dir", base]
    runs = {}
    try:
        for name, n in (("first", ENTRY_STEPS), ("resumed", ENTRY_RESUMED)):
            print(f"train 15.3 {name}: python -m repro_torch.launch.train "
                  f"{' '.join(argv + ['--steps', str(n)])}")
            fa.reset_launches()
            t0 = time.perf_counter()
            out_run = launch_train.main(argv + ["--steps", str(n)])
            torch.cuda.synchronize()
            runs[name] = dict(out_run, wall=time.perf_counter() - t0, launched=dict(fa.LAUNCHES),
                              shapes=dict(fa.SHAPES), bwd_shapes=dict(fa.BWD_SHAPES),
                              saved=list_steps(base))
            del out_run
            print(f"train 15.3 {name}: {runs[name]['done']} steps from {runs[name]['start']} in "
                  f"{runs[name]['wall']:.2f} s (with its checkpoint writes), launches "
                  f"{runs[name]['launched']}, checkpoints {runs[name]['saved']}")
            if name == "first":    # the periodic checkpoint is not the one resumed from
                for s_ in runs[name]["saved"][:-1]:
                    shutil.rmtree(os.path.join(base, f"step_{s_:08d}"))
            runs[name].pop("state")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    first, resumed = runs["first"], runs["resumed"]
    every = ENTRY_EVERY
    for name, r, n, start in (("first", first, ENTRY_STEPS, 0),
                              ("resumed", resumed, ENTRY_RESUMED, ENTRY_STEPS)):
        want = {"flash_attention": 2 * L * n, "flash_attention_bwd": L * n}
        if r["done"] != n or r["start"] != start or r["launched"] != want:
            fail(f"train 15.3 {name}: {r['done']} steps from {r['start']}, launches "
                 f"{r['launched']}; expected {n} from {start}, {want}")
        for seen in (r["shapes"], r["bwd_shapes"]):
            if set(seen) - checked:
                fail(f"train 15.3 {name}: flash shapes 15.1 did not check: {set(seen) - checked}")
    if first["saved"] != [every * (ENTRY_STEPS // every), ENTRY_STEPS]:
        fail(f"train 15.3: the first run wrote checkpoints {first['saved']}, expected "
             f"{[every * (ENTRY_STEPS // every), ENTRY_STEPS]}")
    got_first = [first["losses"][s_] for s_ in range(ENTRY_STEPS)]
    got_resumed = [resumed["losses"][ENTRY_STEPS + i] for i in range(ENTRY_RESUMED)]
    same_first = got_first == ref[:ENTRY_STEPS]
    same_resumed = got_resumed == ref[ENTRY_STEPS:]
    print(f"check train 15.3: the first run's {ENTRY_STEPS} losses bit-equal to an "
          f"uninterrupted run's: {same_first}; the resumed run's losses {got_resumed} against "
          f"the uninterrupted run's {ref[ENTRY_STEPS:]}: bit-equal {same_resumed}; the "
          f"uninterrupted reference run {ref_s:.2f} s (no checkpoint)")
    if not (same_first and same_resumed):
        fail("train 15.3: the entry point's losses differ from an uninterrupted run's")
    print(f"train: 15.3 took {time.perf_counter() - t_sub:.1f} s; phase 15 took "
          f"{time.perf_counter() - t_phase:.1f} s | {smi}")
    memory_mark(torch, "15.3", peaks)
    fwd_row["launches"] = (shapes["forward"][(TRAIN_B * H, TRAIN_S, TRAIN_S, HD, G, True, 0,
                                              TRAIN_S)])
    bwd_row["train_step"] = train_row
    total = {k: launches[k] + first["launched"][k] + resumed["launched"][k]
             for k in ("flash_attention", "flash_attention_bwd")}
    return bwd_row, {f"{TRAIN_ARCH} train": fwd_row}, total


def family_config(family: str):
    """(config with its depth cut, batch, tokens, frontend tokens or None)."""
    from repro_torch import configs
    arch, layers, b, s, f = FAMILIES[family]
    cfg = configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, b, s, f


def family_attention(model, b: int, s: int, f) -> list[tuple]:
    """Every flash_attention call of the model's training forward: (label,
    query rows, G, Sq, Sk, hd, causal, window), one per call site kind, with
    how many times a forward makes it."""
    cfg = model.cfg
    h, g, hd = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    calls: dict = {}

    def add(label, sq, sk, causal, window, n):
        key = (label, b * h, g, sq, sk, hd, causal, window)
        calls[key] = calls.get(key, 0) + n

    for spec in model.stages:
        if spec.kind == "enc":
            add("encoder", f, f, False, 0, spec.n_layers)
        elif spec.kind in ("attn", "dec"):
            add("self" + (f", window {spec.window}" if spec.window else ""), s, s, spec.causal,
                spec.window, spec.n_layers)
        if spec.kind in ("dec", "cross"):
            add(f"cross over {f}", s, f, False, 0, spec.n_layers)
    return [(*key, n) for key, n in calls.items()]


def train_flops(model, b: int, s: int, f) -> tuple[float, int, int]:
    """Model FLOPs of one training step, counted as phase 15 counts them: 6
    x (each matmul parameter x the tokens it multiplies: text tokens, or
    frontend tokens for the encoder and the cross attention's K and V) + 12
    hd a head's unmasked attention pair (forward 4 hd, backward 8 hd).
    MoE counts the router, the shared experts and top_k of the routed
    experts a token (not the capacity's padding); the sLSTM's recurrent
    matrix counts a token; the depthwise conv, the norms and the mLSTM's
    chunk products are not counted. Returns (FLOPs, parameter-token
    products, attention pairs)."""
    cfg = model.cfg
    t_text, t_front = b * s, b * (f or 0)
    mm = t_text * model.top.unembed.numel()
    numel = lambda tree, keys: sum(tree[k].numel() for k in keys if k in tree)  # noqa: E731
    for spec, layers in zip(model.stages, model.stage_layers):
        tok = t_front if spec.kind == "enc" else t_text
        for blk in layers:
            p = blk.p.tree()
            if "attn" in p:
                mm += tok * numel(p["attn"], ("wq", "wk", "wv", "wo"))
            if "xattn" in p:
                mm += t_text * numel(p["xattn"], ("wq", "wo"))
                mm += t_front * numel(p["xattn"], ("wk", "wv"))
            if "mlp" in p:
                mm += tok * numel(p["mlp"], ("w1", "w2", "w3"))
            if "moe" in p:
                q = p["moe"]
                mm += tok * numel(q, ("router", "sw1", "sw2", "sw3"))
                mm += tok * cfg.top_k * numel(q, ("w1", "w2", "w3")) // cfg.n_experts
            if "rglru" in p:
                mm += tok * numel(p["rglru"], ("w_in", "w_gate", "w_r", "w_i", "w_out"))
            if "mlstm" in p:
                mm += tok * numel(p["mlstm"], ("wq", "wk", "wv", "wi", "wf", "wo_gate", "wo"))
            if "slstm" in p:
                mm += tok * numel(p["slstm"], ("w_zifo", "r_zifo", "w_out"))
    pairs = sum(n * rows * attention_pairs(sq, sk, causal, window)
                for _, rows, _, sq, sk, _, causal, window, n in family_attention(model, b, s, f))
    return 6 * mm + 12 * cfg.hd * pairs, mm, pairs


def rg_lru_bwd_checks(dev, errs: dict, smi: str) -> dict:
    """16.0 for the hybrid: rg_lru at the train step's (2, 3072, 4096) and
    rg_lru_bwd against its twin, bit for bit, there (with and without h0,
    TMA), at a ragged S and W, at W % 4 != 0 (cp.async) and with dh off a
    16-byte boundary (cp.async at the train shape); two launches bit-equal
    at each. Then its time beside its twin's, its bound and a same-bytes
    yardstick. Returns the timing row."""
    import torch

    from repro_torch.kernels import rg_lru as rl
    cfg, b, s, _ = family_config("hybrid")
    w = cfg.rglru_dim
    gen = torch.Generator(device=dev).manual_seed(FAMILY_SEED)
    # label, B, S, W, h0, dh's offset in floats, filled by TMA
    cases = [("train shape", b, s, w, False, 0, True), ("train shape, h0", b, s, w, True, 0, True),
             ("ragged S and W, h0", 3, 1000, 200, True, 0, True),
             ("W % 4 != 0, h0", 2, 77, 30, True, 0, False),
             ("train shape, dh off 16 bytes", b, s, w, False, 1, False)]
    for label, bb, ss, ww, with_h0, off, want_tma in cases:
        log_a = -8.0 * torch.rand((bb, ss, ww), device=dev, generator=gen)
        x = torch.randn((bb, ss, ww), device=dev, generator=gen)
        h0 = torch.randn((bb, ww), device=dev, generator=gen) if with_h0 else None
        dh = torch.randn(bb * ss * ww + off, device=dev, generator=gen)[off:].view(bb, ss, ww)
        h = rl.rg_lru(log_a, x, h0)
        if (bb, ss, ww) == (b, s, w) and not with_h0 and not off:
            same = torch.equal(h, rl.rg_lru_plain(log_a, x, h0))
            print(f"check rg_lru at the hybrid train shape ({b}, {s}, {w}) bit-equal to its "
                  f"twin: {same}")
            if not same:
                fail("rg_lru: the kernel differs from its twin at the hybrid train shape")
        tma = rl.uses_tma(ww, log_a.data_ptr(), h.data_ptr(), dh.data_ptr())
        got = rl.rg_lru_bwd(log_a, h, h0, dh)
        again = rl.rg_lru_bwd(log_a, h, h0, dh)
        want = rl.rg_lru_bwd_plain(log_a, h, h0, dh)
        torch.cuda.synchronize()
        pairs = [(n, a, c, d) for n, a, c, d in zip(("dlog_a", "db", "dh0"), got, again, want)
                 if d is not None]
        equal = all(torch.equal(a, d) for _, a, _, d in pairs)
        repeat = all(torch.equal(a, c) for _, a, c, _ in pairs)
        err = max(float((a - d).abs().max()) for _, a, _, d in pairs)
        errs["rg_lru_bwd"] = max(errs.get("rg_lru_bwd", 0.0), err)
        print(f"check rg_lru_bwd {label} ({bb}, {ss}, {ww}) {'TMA' if tma else 'cp.async'}: "
              f"bit-equal to its twin {equal} (max_abs_err={err:.3e}), two launches "
              f"bit-equal {repeat}, dh0 {'returned' if got[2] is not None else 'None'}")
        if not (equal and repeat) or (got[2] is None) != (h0 is None):
            fail(f"rg_lru_bwd {label}: differs from its twin or from itself")
        if tma != want_tma:
            fail(f"rg_lru_bwd {label}: filled by {'TMA' if tma else 'cp.async'}")
        del log_a, x, h0, dh, h, got, again, want, pairs
    # time at the train shape (the path's: no h0)
    log_a = -8.0 * torch.rand((b, s, w), device=dev, generator=gen)
    h = rl.rg_lru(log_a, torch.randn((b, s, w), device=dev, generator=gen))
    dh = torch.randn((b, s, w), device=dev, generator=gen)
    buf = torch.empty_like(log_a)
    n_el = b * s * w
    t_bytes = 20 * n_el / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * n_el / FP32_INSTR_PER_S * 1e3   # exp, a multiply-add (2), 2 multiplies
    row = {"ms": device_ms([lambda: rl.rg_lru_bwd(log_a, h, None, dh)], reps=20),
           "plain_ms": device_ms([lambda: rl.rg_lru_bwd_plain(log_a, h, None, dh)], reps=1,
                                 trials=3),
           "library_ms": None, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "stream_ms": device_ms([lambda: torch.addcmul(log_a, h, dh, out=buf)], reps=20)}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    # the cp.async path at the same shape: dh 4 bytes past a 16-byte boundary
    dh_c = torch.empty(n_el + 1, device=dev)[1:].view_as(dh).copy_(dh)
    if rl.uses_tma(w, log_a.data_ptr(), h.data_ptr(), dh_c.data_ptr()):
        fail("rg_lru_bwd: a misaligned dh would be filled by TMA")
    row["cp_async_ms"] = device_ms([lambda: rl.rg_lru_bwd(log_a, h, None, dh_c)], reps=20)
    row["library_note"] = (
        "no single PyTorch call computes the reverse recurrence; the closed form through "
        "cumsum(log_a) underflows as the forward's does; stream_ms is torch.addcmul(log_a, h, "
        "dh, out=buf), 16 of the kernel's 20 bytes an element")
    print(f"time rg_lru_bwd at ({b}, {s}, {w}): " + " ".join(f"{k}={v}" for k, v in row.items())
          + f" ({20 * n_el / 1e6:.1f} MB: log_a, h, dh read, dlog_a, db written) | {smi}")
    return row


def grad_gaps(card, host) -> tuple[float, str]:
    """Worst |card - host| of the gradient trees' leaves over each leaf's
    largest |host| value (a one-element leaf: over its block's largest)."""
    from repro_torch.core.types import tree_flatten
    names = leaf_names(host)
    ca, ho = tree_flatten(card)[0], tree_flatten(host)[0]
    block_max: dict = {}
    for n, x in zip(names, ho):
        blk = n.rsplit("/", 2)[0]
        block_max[blk] = max(block_max.get(blk, 0.0), float(x.abs().max()))
    worst, where = 0.0, ""
    for n, a, x in zip(names, ca, ho):
        scale = block_max[n.rsplit("/", 2)[0]] if x.numel() == 1 else float(x.abs().max())
        e = float((a.cpu() - x).abs().max()) / max(scale, 1e-30)
        if e > worst:
            worst, where = e, n
    return worst, where


def reduced_check(dev, family: str, smi: str) -> None:
    """16.3: the family's reduced model with COMPUTE_DTYPE float32, on the
    card (the kernels) against the same parameters on the CPU (the plain
    twins): loss and every gradient leaf (REDUCED_*_RTOL)."""
    import importlib

    import torch

    from repro_torch import configs
    from repro_torch.data import make_batch
    from repro_torch.launch.train import frontend_shape
    from repro_torch.models import Model
    from repro_torch.runtime import train as rt
    mods = [importlib.import_module(f"repro_torch.models.{m}")
            for m in ("layers", "attention", "moe", "recurrent", "xlstm", "model")]
    saved = [m.COMPUTE_DTYPE for m in mods]
    try:
        for m in mods:
            m.COMPUTE_DTYPE = torch.float32
        cfg = configs.get(FAMILIES[family][0]).reduced()
        batch = make_batch(FAMILY_SEED, 0, REDUCED_B, REDUCED_S, cfg.vocab_size,
                           frontend_shape(cfg, REDUCED_S), device="cpu")
        out = []
        for d in (dev, torch.device("cpu")):
            model = Model(cfg, device=d, trainable=True, moe_capacity=FAMILY_CAPACITY)
            if d.type == "cuda":
                model.init(torch.Generator(device=d).manual_seed(FAMILY_SEED))
                set_xgate(model)
                params = model.param_tree()
            else:
                model.load_params_(to_cpu(params))
            nll, aux, g = rt.loss_and_grads(model, {k: v.to(d) for k, v in batch.items()},
                                            seq_chunk=32)
            out.append((float(nll), float(aux), g))
        worst, where = grad_gaps(out[0][2], out[1][2])
        print(f"check family 16.3 {family} reduced, float32 compute, card against CPU: loss "
              f"{out[0][0]!r} / {out[1][0]!r}, aux {out[0][1]!r} / {out[1][1]!r}, worst "
              f"gradient leaf {worst:.3e} of its scale at {where} (tol {REDUCED_GRAD_RTOL:g})")
        if (abs(out[0][0] - out[1][0]) > REDUCED_LOSS_RTOL * abs(out[1][0])
                or abs(out[0][1] - out[1][1]) > REDUCED_LOSS_RTOL * max(1.0, abs(out[1][1]))
                or worst > REDUCED_GRAD_RTOL):
            fail(f"family 16.3 {family}: the card's reduced train pass differs from the CPU's")
    finally:
        for m, dt in zip(mods, saved):
            m.COMPUTE_DTYPE = dt


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.detach().cpu()


def set_xgate(model) -> None:
    """Every cross block's xgate to FAMILY_XGATE (the reference initialises
    it to 0, where the block adds nothing and its weights get no
    gradient)."""
    import torch
    with torch.no_grad():
        for layers in model.stage_layers:
            for blk in layers:
                if "xgate" in blk.p.tree():
                    blk.p.tree()["xgate"].fill_(FAMILY_XGATE)


def family_train(dev, family: str, smi: str, errs: dict, bwd_rows: dict) -> dict:
    """16.0-16.3 for one family. Returns the launches of the timed steps
    (16.2, counted from 0 around them) of each kernel."""
    import gc
    import math

    import torch

    from repro_torch.core.types import tree_flatten
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru as rl
    from repro_torch.models import Model, moe
    from repro_torch.runtime import train as rt

    t_fam = time.perf_counter()
    cfg, b, s, f = family_config(family)
    gen = torch.Generator(device=dev).manual_seed(FAMILY_SEED + 1)
    model = Model(cfg, device=dev, trainable=True, remat=True, moe_capacity=FAMILY_CAPACITY)
    calls = family_attention(model, b, s, f)
    # -- 16.0 the kernels at every shape the step launches ---------------------------
    checked = set()
    for label, rows, g, sq, sk, hd, causal, window, n in calls:
        tag = f"{cfg.name} {label} ({rows}, {sq}, {hd}) over {sk} G={g}"
        tensors = check_bwd(dev, gen, errs, tag, rows, g, sq, sk, hd, causal, window)
        checked.add((rows, sq, sk, hd, g, causal, window, sk))
        row = time_bwd(f"{cfg.name} {label}", b, cfg.n_heads, cfg.n_kv_heads, hd, tensors, smi,
                       causal, window)
        bwd_rows[f"{cfg.name} {label}"] = row
        del tensors
        torch.cuda.empty_cache()
    n_rec = sum(sp.n_layers for sp in model.stages if sp.kind == "rec")
    n_moe = sum(sp.n_layers for sp in model.stages if sp.moe)
    n_calls = sum(c[-1] for c in calls)
    want = {"flash_attention": 2 * n_calls, "flash_attention_bwd": n_calls,
            "rg_lru": 2 * n_rec, "rg_lru_bwd": n_rec}
    print(f"family 16.0 {family}: {cfg.name}, {len(calls)} attention shapes checked and timed "
          f"in {time.perf_counter() - t_fam:.1f} s; launches a step expected {want}")

    # -- 16.1 one untimed step, then two gradient passes from one state and batch ---------
    t0 = time.perf_counter()
    state = rt.init_state(model, torch.Generator(device=dev).manual_seed(FAMILY_SEED))
    set_xgate(model)
    n_params = sum(p.numel() for p in model.parameters())
    flops, mm, pairs = train_flops(model, b, s, f)
    torch.cuda.synchronize()
    print(f"family 16.1 {family}: {cfg.name}, {cfg.n_layers} layers at full width, {n_params} "
          f"parameters ({16 * n_params / 1e9:.2f} GB at 16 bytes a parameter), {b} x {s} "
          f"tokens{f' over {f} frontend tokens' if f else ''}, init "
          f"{time.perf_counter() - t0:.2f} s; model FLOPs a step 6 x {mm} parameter-tokens + "
          f"12 x {cfg.hd} x {pairs} attention pairs = {flops:.4e}")
    step = rt.make_train_step(model, base_lr=FAMILY_LR, seq_chunk=FAMILY_CHUNK)
    fs = None if f is None else (f, cfg.d_model)
    batches = [make_batch(FAMILY_SEED, i, b, s, cfg.vocab_size, fs, device=dev)
               for i in range(FAMILY_STEPS + 2)]
    state, met = step(state, batches[0])
    torch.cuda.synchronize()
    first = float(met["loss"])
    # pass A's gradients go to the host: two trees would not fit beside the state
    nll_a, aux_a, g_a = rt.loss_and_grads(model, batches[1], seq_chunk=FAMILY_CHUNK)
    host_a = [x.cpu() for x in tree_flatten(g_a)[0]]
    del g_a
    nll_b, aux_b, g_b = rt.loss_and_grads(model, batches[1], seq_chunk=FAMILY_CHUNK)
    names = leaf_names(g_b)
    differ = [n for n, a, x in zip(names, host_a, tree_flatten(g_b)[0])
              if not torch.equal(a, x.cpu())]
    same_loss = torch.equal(nll_a, nll_b) and torch.equal(aux_a, aux_b)
    print(f"check family 16.1 {family}: two gradient passes from one state and batch bit-equal: "
          f"loss and aux {same_loss}, {len(names)} leaves, differing: {differ or 'none'} "
          f"(first step's loss {first!r})")
    del host_a, g_b
    if differ or not same_loss:
        fail(f"family 16.1 {family}: two gradient passes differ")

    # -- 16.2 timed steps ------------------------------------------------------------
    walls, losses, launches = [], [], {k: 0 for k in want}
    shapes = {"forward": set(), "backward": set()}
    for i in range(FAMILY_STEPS):
        torch.cuda.synchronize()
        fa.reset_launches()
        rl.reset_launches()
        with moe.drop_log() as drops:
            t0 = time.perf_counter()
            state, met = step(state, batches[2 + i])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        got = {**fa.LAUNCHES, **rl.LAUNCHES}
        shapes["forward"] |= set(fa.SHAPES)
        shapes["backward"] |= set(fa.BWD_SHAPES)
        for k in launches:
            launches[k] += got[k]
        losses.append(float(met["loss"]))
        if got != want:
            fail(f"family 16.2 {family} step {i}: launches {got}, expected {want}")
        if len(drops) != n_moe:
            fail(f"family 16.2 {family} step {i}: {len(drops)} dropped-slot counts logged, "
                 f"expected one a MoE layer ({n_moe})")
        if not math.isfinite(losses[-1]):
            fail(f"family 16.2 {family} step {i}: loss {losses[-1]}")
    for kind, seen in shapes.items():
        if seen - checked:
            fail(f"family 16.2 {family}: the {kind} flash kernel ran at shapes 16.0 did not "
                 f"check: {sorted(seen - checked)}")
    step_s = statistics.median(walls)
    prof, prof_wall, (state, met), rows_k, busy_us = profiled(
        lambda: step(state, batches[-1]), f"family 16.2 {family} step", fast=True)

    def share(*frags):
        return sum(e.self_device_time_total for e in rows_k
                   if any(fr in e.key for fr in frags)) / busy_us

    gemm = sum(e.self_device_time_total for e in rows_k
               if any(t in e.key.lower() for t in ("gemm", "cutlass", "sm90_xmma", "nvjet")))
    for e in sorted(rows_k, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"family 16.2 {family} profile kernel {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.self_device_time_total / busy_us:6.1%} {e.count:6d} launches  {e.key[:80]}")
    peak = torch.cuda.max_memory_reserved()
    row = dict(step_ms=step_s * 1e3, step_ms_min=min(walls) * 1e3, tokens_per_s=b * s / step_s,
               mfu=flops / step_s / BF16_OPS_PER_S, busy_share=busy_us / 1e6 / prof_wall,
               profiled_step_ms=prof_wall * 1e3,
               flash_fwd_share=share("flash_wgmma_kernel", "flash_f32_kernel"),
               flash_bwd_share=share("flash_bwd_"),
               rg_lru_share=share("rg_lru_kernel"), rg_lru_bwd_share=share("rg_lru_bwd_kernel"),
               gemm_share=gemm / busy_us, peak_reserved_gib=peak / 2**30,
               loss_first=first, loss_last=losses[-1], parameters=n_params)
    print(f"time family 16.2 {family} ({cfg.name}, {b} x {s} tokens a step, median of "
          f"{FAMILY_STEPS}; launches a step {want}): "
          + " ".join(f"{k}={v}" for k, v in row.items()) + f" | {smi}")
    del prof, rows_k, state, step, batches, met, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16.3 the reduced model on the card against the CPU ----------------------------
    reduced_check(dev, family, smi)
    print(f"family: {family} took {time.perf_counter() - t_fam:.1f} s")
    return {**launches, "row": row}


def family_entry_points(dev, smi: str) -> dict:
    """16.4: launch.train.main for every family (xlstm-125m and
    whisper-small at full size, the others --reduced), ENTRY_FAMILY_STEPS
    steps at the launcher's 8 x 128; whisper-small then resumed for
    ENTRY_FAMILY_RESUMED step from its final checkpoint, its losses
    bit-equal to an uninterrupted run's. Returns the launches of the runs."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru as rl
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.runtime import train as rt

    total: dict = {}
    entry = launch_train.parse_args([])
    for family, (arch, _, _, _, _) in FAMILIES.items():
        full = family in ("ssm", "audio")
        base = tempfile.mkdtemp(prefix="chip_smoke_family_")
        argv = ["--arch", arch, "--log-every", "1", "--ckpt-dir", base] + (
            [] if full else ["--reduced"])
        try:
            runs = []
            for n in ((ENTRY_FAMILY_STEPS, ENTRY_FAMILY_RESUMED) if family == "audio"
                      else (ENTRY_FAMILY_STEPS,)):
                fa.reset_launches()
                rl.reset_launches()
                t0 = time.perf_counter()
                out = launch_train.main(argv + ["--steps", str(n)])
                torch.cuda.synchronize()
                launched = {**fa.LAUNCHES, **rl.LAUNCHES}
                for k, v in launched.items():
                    total[k] = total.get(k, 0) + v
                out.pop("state")
                runs.append(out)
                print(f"family 16.4 {family}: python -m repro_torch.launch.train "
                      f"{' '.join(argv + ['--steps', str(n)])}: {out['done']} steps from "
                      f"{out['start']} in {time.perf_counter() - t0:.2f} s, losses "
                      f"{out['losses']}, launches {launched}")
                if out["done"] != n or not all(map(math_isfinite, out["losses"].values())):
                    fail(f"family 16.4 {family}: the entry point trained {out['done']} of {n} "
                         f"steps, losses {out['losses']}")
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(base, ignore_errors=True)
        if family != "audio":
            continue
        # the uninterrupted reference run of whisper-small
        cfg = configs.get(arch)
        model = Model(cfg, device=dev, moe_capacity=FAMILY_CAPACITY, trainable=True, remat=True)
        state = rt.init_state(model, torch.Generator(device=dev).manual_seed(entry.seed))
        step = rt.make_train_step(model, entry.microbatches)
        data = SyntheticLM(entry.seed, entry.batch, entry.seq, cfg.vocab_size,
                           launch_train.frontend_shape(cfg, entry.seq), device=dev)
        ref = []
        try:
            for _ in range(ENTRY_FAMILY_STEPS + ENTRY_FAMILY_RESUMED):
                state, met = step(state, next(data))
                ref.append(float(met["loss"]))
        finally:
            data.close()
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
        got = [runs[0]["losses"][i] for i in range(ENTRY_FAMILY_STEPS)] + [
            runs[1]["losses"][ENTRY_FAMILY_STEPS + i] for i in range(ENTRY_FAMILY_RESUMED)]
        print(f"check family 16.4 audio: whisper-small's losses, {ENTRY_FAMILY_STEPS} steps and "
              f"{ENTRY_FAMILY_RESUMED} resumed from the final checkpoint, {got} against an "
              f"uninterrupted run's {ref}: bit-equal {got == ref} | {smi}")
        if got != ref or runs[1]["start"] != ENTRY_FAMILY_STEPS:
            fail("family 16.4: whisper-small's resumed losses differ from an uninterrupted run's")
    return total


def math_isfinite(x) -> bool:
    import math
    return math.isfinite(x)


def families_phase(dev, smi: str, errs: dict, peaks: dict) -> tuple[dict, dict, dict]:
    """Phase 16: training the hybrid, MoE, vision, xLSTM and audio families
    on the card. Returns the rg_lru_bwd timing row, the flash backward's
    rows at the new shapes, and the main paths' launches of each kernel
    (16.2's timed steps, and 16.4's entry points)."""
    import torch
    t_phase = time.perf_counter()
    bwd_row = rg_lru_bwd_checks(dev, errs, smi)
    launches: dict = {}
    bwd_rows: dict = {}
    steps: dict = {}
    for family in FAMILIES:
        got = family_train(dev, family, smi, errs, bwd_rows)
        steps[family] = got.pop("row")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        memory_mark(torch, f"16 {family}", peaks)
    for k, v in family_entry_points(dev, smi).items():
        launches[k] = launches.get(k, 0) + v
    memory_mark(torch, "16.4", peaks)
    bwd_row["train_steps"] = steps
    print(f"families: phase 16 took {time.perf_counter() - t_phase:.1f} s | {smi}")
    return bwd_row, bwd_rows, launches


def sharding_phase(dev, smi: str, fleet: dict, errs: dict, peaks: dict) -> dict:
    """Phase 17: sharding on the card, on an NCCL group of world size 1 (the
    one card: NCCL refuses two ranks on one GPU, so this is a one-device
    mesh, not a multi-device result). 17.1 phase 7's fleet planned and
    replanned through plan_many_sharded / replan_many_sharded on
    fleet_mesh(), every leaf bit-equal to phase 7's unsharded states,
    exact NOMA launches, one graphed step's traced launches against the
    counted ones; 17.2 jit_train_step on a ("data",) mesh of one at
    qwen1.5-0.5b 8 x 2048, 3 steps with ZeRO-1 off and 3 on, both bit-equal
    to make_train_step's (phase 15.2's step) from the same state and
    batches; 17.3 compressed_psum over the group bit-equal to
    error_feedback_update's g_hat; 17.4 launch/train.py --mesh 1x1
    --reduced under the group, resumed bit-equal to an uninterrupted run,
    and flash checked at the reduced model's shapes (check_bwd). Returns
    the main paths' launches (NOMA kernels of 17.1, flash of 17.2 and
    17.4)."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch import configs, graphs
    from repro_torch.core import li_gd, profiles
    from repro_torch.core.types import tree_flatten
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import noma_rates as nr
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.optim import compressed_psum, error_feedback_update
    from repro_torch.planning import PlannerEngine
    from repro_torch.pshard import fleet_mesh, shard_fleet, unshard
    from repro_torch.runtime import train as rt

    t_phase = time.perf_counter()
    lmesh.init_process_group(device=dev)
    print(f"sharding 17: an NCCL group of world size {torch.distributed.get_world_size()} on "
          f"{dev} (one card: a one-device mesh) | {smi}")
    out: dict = {}
    try:
        # -- 17.1 the fleet over a fleet mesh ---------------------------------------
        t_sub = time.perf_counter()
        mesh = fleet_mesh()
        prof = profiles.nin()
        sh = PlannerEngine(prof, cfg=fleet["cfg"], sinr_backend="kernel", mesh=mesh)
        nr.reset_launches()
        li_gd.reset_counts()
        walls, steps, states, prev = [], [], [], None
        for e_i in fleet["envs"]:
            torch.cuda.synchronize()
            t0, before = time.perf_counter(), li_gd.COUNTS["steps"]
            placed = shard_fleet(e_i, mesh)
            prev = sh.plan_many(placed) if prev is None else sh.replan_many(prev, placed)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            steps.append(li_gd.COUNTS["steps"] - before)
            states.append(prev)
        launches = dict(nr.LAUNCHES)
        n, splits = len(walls), prof.n_layers + 1
        expect = plan_launches(sum(steps), splits * n + 2 * n + 2 * splits * (n - 1))
        print(f"sharding 17.1 fleet of {FLEET_B} on {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}: "
              f"kinds {sorted(k[0] for k in sh.cache_keys())}; launches {launches}, expected "
              f"from {sum(steps)} fleet GD steps {expect}")
        if launches != expect:
            fail(f"sharding 17.1: the sharded fleet launched {launches}, expected {expect}")
        for name, got, want in zip(("plan_many", "replan_many1"), states, fleet["states"]):
            bad = graphs.differing(unshard(got), want)
            print(f"check sharding 17.1 {name}_sharded: every leaf of all {FLEET_B} members "
                  f"bit-equal to phase 7's unsharded {name}: {not bad}")
            if bad:
                fail(f"sharding 17.1 {name}: leaves {bad} differ from the unsharded engine's")
        step_ms = profile_graph_steps(sh, "plan_many_sharded", fleet["envs"][0], 40,
                                      f"sharding 17.1 graphed sharded fleet GD step split 4, "
                                      f"B={FLEET_B},", None, smi)
        print(f"time sharding 17.1: plan_many_sharded {walls[0]:.4f} s, replan_many_sharded "
              f"{walls[1]:.4f} s (each capturing its graphs); phase 7's unsharded graphed "
              f"plan_many {fleet['walls'][0]:.4f} s, replan_many {fleet['walls'][1]:.4f} s "
              f"(printed again in 12.3); a graphed step {step_ms:.4f} ms; 17.1 took "
              f"{time.perf_counter() - t_sub:.1f} s | {smi}")
        out.update(launches)
        del sh, states, prev, placed
        gc.collect()
        torch.cuda.empty_cache()
        memory_mark(torch, "17.1", peaks)

        # -- 17.2 the data-parallel train step ---------------------------------------
        t_sub = time.perf_counter()
        cfg = configs.get(TRAIN_ARCH)
        L = cfg.n_layers
        model = Model(cfg, device=dev, trainable=True, remat=True)
        data = SyntheticLM(TRAIN_SEED, TRAIN_B, TRAIN_S, cfg.vocab_size, device=dev)
        try:
            batches = [next(data) for _ in range(DP_STEPS)]
        finally:
            data.close()

        def fresh():
            return rt.init_state(model, torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        state = fresh()
        step = rt.make_train_step(model, seq_chunk=TRAIN_CHUNK)
        ref_mets, ref_walls = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, b)
            torch.cuda.synchronize()
            ref_walls.append(time.perf_counter() - t0)
            ref_mets.append(met)
        ref = [x.detach().clone() for x in tree_flatten(state)[0]]
        del state, step
        flops = train_flops(model, TRAIN_B, TRAIN_S, None)[0]
        ref_s = statistics.median(ref_walls[1:])
        print(f"time sharding 17.2 make_train_step (one device, no mesh): step_ms="
              f"{ref_s * 1e3:.2f} ({[round(w * 1e3, 2) for w in ref_walls]}) "
              f"mfu={flops / ref_s / BF16_OPS_PER_S:.4f} | {smi}")
        dmesh = lmesh.make_mesh((1,), ("data",))
        want = {"flash_attention": 2 * L * DP_STEPS, "flash_attention_bwd": L * DP_STEPS}
        for zero1 in (False, True):
            state = fresh()
            make, _ = rt.jit_train_step(model, dmesh, zero1=zero1, seq_chunk=TRAIN_CHUNK)
            step = make({k: v.shape for k, v in batches[0].items()})
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            walls, mets = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, b)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                mets.append(met)
            launched = dict(fa.LAUNCHES)
            peak = torch.cuda.max_memory_reserved()
            sharded = sum(type(x).__name__ == "DTensor" for x in tree_flatten(state.opt.m)[0])
            differ = [i for i, (a, b) in enumerate(zip(tree_flatten(unshard(state))[0], ref,
                                                       strict=True)) if not torch.equal(a, b)]
            same_met = all(torch.equal(a[k], b[k]) for a, b in zip(mets, ref_mets) for k in a)
            step_s = statistics.median(walls[1:])
            print(f"check sharding 17.2 jit_train_step zero1={zero1} ({sharded} moment leaves "
                  f"sharded): {DP_STEPS} steps' params, moments and steps bit-equal to "
                  f"make_train_step's: {not differ}, metrics bit-equal: {same_met}; flash "
                  f"launches {launched}")
            print(f"time sharding 17.2 zero1={zero1}: step_ms={step_s * 1e3:.2f} (median of "
                  f"steps 2-{DP_STEPS}; {[round(w * 1e3, 2) for w in walls]}) "
                  f"mfu={flops / step_s / BF16_OPS_PER_S:.4f} "
                  f"peak_reserved_gib={peak / 2**30:.2f} | {smi}")
            if differ or not same_met:
                fail(f"sharding 17.2 zero1={zero1}: leaves {differ} (metrics equal {same_met}) "
                     "differ from make_train_step's")
            if launched != want:
                fail(f"sharding 17.2 zero1={zero1}: flash launches {launched}, expected {want}")
            if zero1 and not sharded:
                fail("sharding 17.2: ZeRO-1 sharded no moment leaf")
            if zero1:     # where a ZeRO-1 step's time goes
                _, p_wall, _, rows_k, busy_us = profiled(lambda: step(state, batches[0]),
                                                         "sharding 17.2 zero1 step", fast=True)
                print(f"profile sharding 17.2 zero1 step: wall_ms={p_wall * 1e3:.2f} "
                      f"busy_share={busy_us / 1e6 / p_wall:.4f}")
                for e in sorted(rows_k, key=lambda e: -e.self_device_time_total)[:6]:
                    print(f"profile sharding 17.2 kernel {e.self_device_time_total / 1e3:9.2f} ms "
                          f"{e.self_device_time_total / busy_us:6.1%} {e.count:6d} launches  "
                          f"{e.key[:80]}")
            for k, v in launched.items():
                out[k] = out.get(k, 0) + v
            del state, step, make
        del model, batches, ref
        gc.collect()
        torch.cuda.empty_cache()
        memory_mark(torch, "17.2", peaks)
        print(f"sharding: 17.2 took {time.perf_counter() - t_sub:.1f} s")

        # -- 17.3 compressed_psum over the group --------------------------------------
        gen = torch.Generator(device=dev).manual_seed(17)
        g = torch.randn(PSUM_SHAPE, device=dev, generator=gen)
        res = 1e-2 * torch.randn(PSUM_SHAPE, device=dev, generator=gen)
        got, got_res = compressed_psum(g, None, res)
        hat, new_res = error_feedback_update(g, res)
        again = compressed_psum(g, None, res)[0]
        print(f"check sharding 17.3 compressed_psum of {PSUM_SHAPE} over the group bit-equal to "
              f"error_feedback_update's g_hat: {torch.equal(got, hat)}, residual "
              f"{torch.equal(got_res, new_res)}, two calls {torch.equal(got, again)}")
        if not (torch.equal(got, hat) and torch.equal(got_res, new_res)
                and torch.equal(got, again)):
            fail("sharding 17.3: compressed_psum differs from error_feedback_update")
        del g, res, got, got_res, hat, new_res, again

        # -- 17.4 the entry point under the group ----------------------------------------
        t_sub = time.perf_counter()
        base = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        common = ["--reduced", "--mesh", "1x1", "--log-every", "1", "--ckpt-every", "100"]
        try:
            fa.reset_launches()
            full = launch_train.main(common + ["--steps", "3", "--ckpt-dir", f"{base}/a"])
            first = launch_train.main(common + ["--steps", "2", "--ckpt-dir", f"{base}/b"])
            again = launch_train.main(common + ["--steps", "1", "--ckpt-dir", f"{base}/b"])
            launched = dict(fa.LAUNCHES)
            seen = set(fa.SHAPES) | set(fa.BWD_SHAPES)
        finally:
            shutil.rmtree(base, ignore_errors=True)
        gen = torch.Generator(device=dev).manual_seed(174)
        for bh, sq, sk, hd, g, causal, window, kv_len in sorted(seen):
            check_bwd(dev, gen, errs, f"17.4 reduced {TRAIN_ARCH} ({bh}, {sq}, {hd}) G={g}", bh,
                      g, sq, sk, hd, causal, window, None if kv_len == sk else kv_len)
        same = (again["start"] == 2 and [first["losses"][i] for i in range(2)]
                == [full["losses"][i] for i in range(2)] and again["losses"] == {2: full["losses"][2]})
        print(f"check sharding 17.4 launch.train --mesh 1x1 --reduced under the group: 3 steps "
              f"{full['losses']}; 2 steps and a restart from step {again['start']}: "
              f"{first['losses']} {again['losses']}: bit-equal {same}; flash launches {launched}; "
              f"17.4 took {time.perf_counter() - t_sub:.1f} s")
        if not same:
            fail("sharding 17.4: the resumed run's losses differ from the uninterrupted run's")
        for k, v in launched.items():
            out[k] = out.get(k, 0) + v
    finally:
        lmesh.destroy_process_group()
    print(f"sharding: phase 17 took {time.perf_counter() - t_phase:.1f} s | {smi}")
    return out


# --------------------------------------------------------------------------
# Phase 18: tensor-parallel serving (models/tp.py)
# --------------------------------------------------------------------------
class CountedAllReduce:
    """torch.distributed.all_reduce that counts its calls: the collectives a
    model on a mesh issues (tp.TP takes its all-reduce as an argument)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x, op=None, group=None):
        import torch.distributed as dist
        self.calls += 1
        dist.all_reduce(x, op=op, group=group)


# The all-reduces of one block of each kind on a model axis of size 1 (every
# leaf splits): the mixer's output and the MLP's (or the MoE's: its experts'
# and shared experts' partial outputs summed in one); an RG-LRU's gates;
# a decoder block's cross attention; an mLSTM's C and n and an sLSTM's c, n,
# h and m gathered over hd at the call's start and over heads at its end.
TP_BLOCK_COLLECTIVES = {"attn": 2, "rec": 3, "cross": 2, "enc": 2, "dec": 3, "mlstm": 5,
                        "slstm": 9}


def tp_collectives(cfg, prefill: bool = True) -> int:
    """The all-reduces of one forward of a model on a model axis of size 1:
    the embedding and the logits, then TP_BLOCK_COLLECTIVES a block; the
    audio encoder runs only in a prefill (a decode step reads enc_out)."""
    from repro_torch.models import stages_for
    return 2 + sum(spec.n_layers * TP_BLOCK_COLLECTIVES[spec.kind] for spec in stages_for(cfg)
                   if prefill or spec.kind != "enc")


def moved(tree, device):
    """A tree of tensors (None entries kept) copied to ``device``."""
    from repro_torch.core.types import tree_map
    return tree_map(lambda x: x.to(device), tree)


def differing_held(tree, held) -> list:
    """graphs.differing of a tree on the card against one held on the host,
    each held leaf brought back to the card alone for its comparison."""
    from repro_torch import graphs
    got, want = graphs.tensors(tree), graphs.tensors(held)
    if len(got) != len(want):
        return ["structure"]
    return [i for i, (x, y) in enumerate(zip(got, want))
            if graphs.differing(x, y.to(x.device))]


def tp_graph_phase(dev, smi: str, model, errs: dict) -> dict:
    """Phase 18.1: the compiled serve steps on a mesh (1, 1) ("data",
    "model") of a world-1 NCCL group, over phase 6's model: mesh_graph_checks
    on 4 x 3064 tokens and 8 + 8 steps. Returns the mesh programs'
    launches."""
    from repro_torch.data import make_batch
    B, S = SERVE_B, SERVE_S
    p_len = S - DECODE_STEPS
    tokens = make_batch(0, 0, B, S, model.cfg.vocab_size, device=dev)["tokens"]
    return mesh_graph_checks(dev, smi, model, {"tokens": tokens[:, :p_len]},
                             [tokens[:, p_len + i:p_len + i + 1] for i in range(DECODE_STEPS)],
                             S, "tp 18.1", SERVE_ARCH)


def mesh_graph_checks(dev, smi: str, model, batch: dict, toks: list, max_len: int, label: str,
                      arch: str) -> dict:
    """The compiled serve steps on a mesh (1, 1) ("data", "model") of a
    world-1 NCCL group, over ``model``'s weights (shared, not copied:
    Model(mesh=).load_params_(share=True)): jit_prefill of ``batch`` (its
    frontend too), len(toks) jit_decode_step and as many
    jit_masked_decode_step (slot 1 idle every other step), each CUDA graph
    captured with its collectives (a world-1 all-reduce is the identity),
    logits and caches bit-equal to the unsharded programs' at every call, a
    traced replay's kernels equal to what its bookkeeping counted, the
    collectives a call issues counted (a capturing call twice
    tp_collectives, a replay none). Returns the mesh programs' launches."""
    import gc

    import torch
    from repro_torch import graphs
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import Model
    from repro_torch.runtime.serve import jit_decode_step, jit_masked_decode_step, jit_prefill

    t_phase = time.perf_counter()
    PEAK_BEFORE["bytes"] = max(PEAK_BEFORE["bytes"], torch.cuda.max_memory_reserved())
    torch.cuda.reset_peak_memory_stats()
    lmesh.init_process_group(device=dev)
    launched_total: dict = {}
    try:
        mesh = lmesh.make_mesh((1, 1), ("data", "model"))
        counted = CountedAllReduce()
        tm = Model(model.cfg, device="meta", mesh=mesh, all_reduce=counted,
                   moe_capacity=model.moe_capacity)
        tm.load_params_(model.param_tree(), share=True)
        shared = tm.device == model.device and all(
            a.data_ptr() == b.data_ptr() for a, b in zip(tm.parameters(), model.parameters(),
                                                         strict=True))
        per_pre, per_dec = tp_collectives(tm.cfg, True), tp_collectives(tm.cfg, False)
        print(f"{label}: an NCCL group of world size {torch.distributed.get_world_size()}, "
              f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}; {arch} on it sharing "
              f"the phase's {model.param_bytes()} bytes of weights: {shared}; layout "
              f"{tm.cfg.attn_layout}; {per_pre} all-reduces a prefill, {per_dec} a decode step "
              f"| {smi}")
        if not shared:
            fail(f"{label}: the mesh model does not share the phase's weights")
        b = batch["tokens"].shape[0]
        p_len = batch["tokens"].shape[1]

        def add(launched):
            for k, v in launched[0].items():
                launched_total[k] = launched_total.get(k, 0) + v

        def mesh_call(fn, what, n_calls):
            """fn() (a mesh program call) counted; its all-reduces held to
            n_calls (the capturing call runs fn eagerly, then captures it:
            twice; a replay runs no Python)."""
            before = counted.calls
            res, wall, launched = counted_call(fn)
            if counted.calls - before != n_calls:
                fail(f"{label} {what}: {counted.calls - before} all-reduces issued, expected "
                     f"{n_calls}")
            add(launched)
            return res, wall, launched

        def traced_mesh(fn, what, eager):
            with graphs.traced() as prof:
                res, _, booked = counted_call(fn)
            seen = graphs.kernel_launches(prof)
            from torch.autograd import DeviceType
            nccl = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower())
            print(f"check {label} {what} replay, traced: the port's kernels on the device "
                  f"{seen}, the capturing call's eager run launched {eager[0]}, the replay "
                  f"counted {booked[0]}: {seen == eager[0] == booked[0]}; NCCL device records "
                  f"{nccl} (a world-1 in-place all-reduce moves no bytes)")
            if not seen == eager[0] == booked[0]:
                fail(f"{label} {what}: the replay ran {seen}, its eager run launched "
                     f"{eager[0]}, the replay counted {booked[0]}")
            if booked[1:] != eager[1:]:
                fail(f"{label} {what}: the replay's flash shapes / MoE drops {booked[1:]} "
                     f"differ from its eager run's {eager[1:]}")
            add(booked)
            return res

        # prefill: the unsharded program's capturing call and a replay (its
        # graph released and its outputs held on the host during the mesh's
        # captures: one pool and one set of caches on the card at a time),
        # then the mesh program's capturing call and replays, its last
        # replay traced
        pre_u, _ = jit_prefill(model, None, max_len)
        (lu, cu), _, u_first = counted_call(lambda: pre_u(None, batch))
        del lu, cu
        (lu, cu), u_wall, _ = counted_call(lambda: pre_u(None, batch))
        lu, cu = moved((lu, cu), "cpu")
        pre_u.program.release()
        del pre_u
        gc.collect()
        torch.cuda.empty_cache()
        pre_m, _ = jit_prefill(tm, mesh, max_len)
        (lm, cm), cap_wall, cap_launched = mesh_call(lambda: pre_m(None, batch),
                                                     "prefill capture", 2 * per_pre)
        bad = differing_held((lm, cm), (lu, cu))
        if cap_launched[1:] != u_first[1:]:
            fail(f"{label} prefill: the mesh's flash shapes / MoE drops {cap_launched[1:]} "
                 f"differ from the unsharded program's {u_first[1:]}")
        del lm, cm
        (lm, cm), m_wall, _ = mesh_call(lambda: pre_m(None, batch), "prefill replay", 0)
        bad += differing_held((lm, cm), (lu, cu))
        del lm, cm
        lm, cm = traced_mesh(lambda: pre_m(None, batch), "prefill", cap_launched)
        bad += differing_held((lm, cm), (lu, cu))
        print(f"check {label} graphs prefill ({b} x {p_len} tokens) on the mesh: the capturing "
              f"call and two replays bit-equal to the unsharded program's, logits and caches: "
              f"{not bad}; admission_s mesh={m_wall:.4f} unsharded={u_wall:.4f} capturing "
              f"call={cap_wall:.4f}; capture_s={pre_m.program.capture_s:.4f}, pool_bytes="
              f"{pool_bytes(torch, pre_m.program.pool)}; MoE drops {sum(cap_launched[2])} "
              f"| {smi}")
        if bad:
            fail(f"{label} prefill: leaves {bad} differ from the unsharded program's")
        pre_m.program.release()
        del pre_m, lm, lu
        gc.collect()
        torch.cuda.empty_cache()
        cu = moved(cu, dev)         # the unsharded decode's caches, back on the card

        # decode: both programs adopt their prefill's caches; the mesh's
        # second step is traced
        dec_u, _, _ = jit_decode_step(model, None, b, max_len)
        dec_m, _, _ = jit_decode_step(tm, mesh, b, max_len)
        m_ms, u_ms = [], []
        for k, tok in enumerate(toks):
            (lu, cu), u_wall, _ = counted_call(lambda: dec_u(None, cu, tok))
            if k == 1:
                lm, cm = traced_mesh(lambda: dec_m(None, cm, tok), "decode step", d_eager)
            else:
                (lm, cm), m_wall, launched = mesh_call(lambda: dec_m(None, cm, tok),
                                                       f"decode step {k}",
                                                       2 * per_dec if k == 0 else 0)
                if k == 0:
                    d_eager = launched
                else:
                    m_ms.append(m_wall * 1e3)
                    u_ms.append(u_wall * 1e3)
            if not torch.equal(lm, lu):
                fail(f"{label} decode step {k}: the mesh program's logits differ")
        bad = graphs.differing(cm, cu)
        print(f"check {label} graphs decode on the mesh: {len(toks)} steps' logits and the "
              f"caches after them bit-equal to the unsharded program's: {not bad}; ms a step "
              f"mesh={statistics.median(m_ms):.4f} unsharded={statistics.median(u_ms):.4f} "
              f"| {smi}")
        if bad:
            fail(f"{label} decode: cache leaves {bad} differ")
        dec_u.program.release()
        dec_m.program.release()

        # masked: slot 1 idle every other step
        mk_u, _, _ = jit_masked_decode_step(model, None, b, max_len)
        mk_m, _, _ = jit_masked_decode_step(tm, mesh, b, max_len)
        mk_ms = []
        for k, tok in enumerate(toks):
            active = torch.tensor([i != 1 or k % 2 == 1 for i in range(b)], device=dev)
            (lu, cu), _, _ = counted_call(lambda: mk_u(None, cu, tok, active))
            if k == 1:
                lm, cm = traced_mesh(lambda: mk_m(None, cm, tok, active), "masked step",
                                     k_eager)
            else:
                (lm, cm), m_wall, launched = mesh_call(lambda: mk_m(None, cm, tok, active),
                                                       f"masked step {k}",
                                                       2 * per_dec if k == 0 else 0)
                if k == 0:
                    k_eager = launched
                else:
                    mk_ms.append(m_wall * 1e3)
            bad = graphs.differing((lm, cm), (lu, cu))
            if bad:
                fail(f"{label} masked step {k}: leaves {bad} differ from the unsharded "
                     "program's")
        print(f"check {label} graphs masked decode on the mesh: {len(toks)} steps, slot 1 "
              f"idle every other step, logits and caches bit-equal to the unsharded "
              f"program's: True; ms a step mesh={statistics.median(mk_ms):.4f}; all-reduces "
              f"issued {counted.calls} (a capturing call {2 * per_pre} / {2 * per_dec}, a "
              f"replay 0) | {smi}")
        mk_u.program.release()
        mk_m.program.release()
        del dec_u, dec_m, mk_u, mk_m, cu, cm, lu, lm, tm
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        lmesh.destroy_process_group()
    print(f"{label} took {time.perf_counter() - t_phase:.1f} s; peak reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB; mesh launches "
          f"{launched_total} | {smi}")
    return launched_total


def tp_config(arch: str):
    """18.2's config: published widths, the depth of TP_ARCHS."""
    from repro_torch import configs
    cfg = configs.get(arch)
    depth = TP_ARCHS[arch]
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def tp_serve(model, tokens, max_len: int, s: int | None = None, frontend=None) -> tuple:
    """Prefill tokens[:, :s] (TP_S by default; over ``frontend`` when
    given), then TP_DECODE cached decode steps (eager): (the logits of each,
    float32 on the host; prefill s; decode ms a step; the prefill's launches
    and flash shapes; each call's MoE drops)."""
    import torch
    s = TP_S if s is None else s
    first = {"tokens": tokens[:, :s]}
    if frontend is not None:
        first["frontend"] = frontend
    res, prefill_s, launched = counted_call(lambda: model.prefill(first, max_len))
    logits, caches = res
    out, walls, drops = [logits.float().cpu()], [], [launched[2]]
    for i in range(TP_DECODE):
        (logits, caches), wall, step = counted_call(lambda: model.decode_step(
            caches, tokens[:, s + i:s + i + 1], max_len=max_len))
        out.append(logits.float().cpu())
        walls.append(wall * 1e3)
        drops.append(step[2])
    del caches
    torch.cuda.empty_cache()
    return out, prefill_s, statistics.median(walls), launched[0], launched[1], drops


def tp_rank(rank: int, tmp: str) -> None:
    """One of 18.2's ranks: a gloo group (launch.mesh.spawn with device
    "cpu"; its mesh's device type is the CPU's) whose collectives take the
    card's tensors; each TP_ARCHS model built on the mesh on the card, then
    tp_serve. Writes what it saw to tmp/rank<r>.pt."""
    import torch
    import torch.distributed as dist
    from repro_torch.data import make_batch
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import Model
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = lmesh.make_mesh((1, TP_M), ("data", "model"), device="cpu")
    probe = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.full((4,), float(rank + 1), dtype=dt, device=dev)
        dist.all_reduce(x)
        probe[str(dt)] = float(x[0])
    out = {"probe": probe}
    for arch in TP_ARCHS:
        cfg = tp_config(arch)
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg, device=dev, mesh=mesh).init(
            torch.Generator(device=dev).manual_seed(TP_SEED))
        tokens = make_batch(0, 0, TP_B, TP_S + TP_DECODE, cfg.vocab_size, device=dev)["tokens"]
        logits, prefill_s, dec_ms, launched, shapes, _ = tp_serve(model, tokens,
                                                                  TP_S + TP_DECODE)
        out[arch] = dict(logits=logits, prefill_s=prefill_s, decode_ms=dec_ms,
                         launched=launched, shapes=shapes, layout=model.cfg.attn_layout,
                         bytes=model.param_bytes(), peak=torch.cuda.max_memory_reserved())
        del model
        torch.cuda.empty_cache()
    torch.save(out, f"{tmp}/rank{rank}.pt")


def tp_ranks_phase(dev, smi: str) -> dict:
    """Phase 18.2: TP_M ranks on the one card over gloo (NCCL refuses two
    ranks on one GPU), eager: each TP_ARCHS model at published width
    (recurrentgemma-9b cut to rec, rec, attn: the flat layout, a
    sequence-split decode cache, split RG-LRU channels; qwen1.5-0.5b whole,
    grouped), a prefill of TP_B x TP_S and TP_DECODE decode steps, against
    the unsharded Model(cfg, tp_size=TP_M) on the same weights in this
    process within 0.05 * max(1, max |logits|); the ranks' summed flash and
    rg_lru launches equal to TP_M times the unsharded prefill's. Gloo
    stages CUDA tensors through the host, so the times are no
    tensor-parallel performance number. Returns the ranks' launches and
    flash shapes."""
    import shutil
    import tempfile

    import torch
    from repro_torch.data import make_batch
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import Model

    t_phase = time.perf_counter()
    refs = {}
    for arch in TP_ARCHS:
        cfg = tp_config(arch)
        model = Model(cfg, device=dev, tp_size=TP_M).init(
            torch.Generator(device=dev).manual_seed(TP_SEED))
        tokens = make_batch(0, 0, TP_B, TP_S + TP_DECODE, cfg.vocab_size, device=dev)["tokens"]
        refs[arch] = tp_serve(model, tokens, TP_S + TP_DECODE)
        print(f"tp 18.2 unsharded {arch} ({cfg.n_layers} layers, layout "
              f"{model.cfg.attn_layout}, Hp {model.cfg.heads_padded}): prefill {TP_B} x {TP_S} "
              f"{refs[arch][1]:.4f} s, decode {refs[arch][2]:.4f} ms a step; launches "
              f"{refs[arch][3]} | {smi}")
        del model
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        t0 = time.perf_counter()
        lmesh.spawn(tp_rank, TP_M, (tmp,), init_method=f"file://{tmp}/rendezvous", device="cpu")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(TP_M)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"tp 18.2: {TP_M} ranks on {torch.cuda.get_device_name(0)} over gloo, {spawn_s:.1f} s "
          f"from spawn to exit; gloo all_reduce of CUDA tensors in each rank (bf16, float32; "
          f"a sum of rank + 1 over the ranks): {[r['probe'] for r in ranks]} | {smi}")
    want_sum = float(sum(range(1, TP_M + 1)))
    if any(v != want_sum for r in ranks for v in r["probe"].values()):
        fail(f"tp 18.2: gloo's all-reduce of the card's tensors gave {[r['probe'] for r in ranks]}")
    out: dict = {"launched": {}, "shapes": {}}
    for arch in TP_ARCHS:
        want, ref_pre, ref_dec, ref_launched, _, _ = refs[arch]
        vocab = tp_config(arch).vocab_size      # the padded columns hold -1e30
        bound = 0.05 * max(1.0, max(float(w[..., :vocab].abs().max()) for w in want))
        worst = 0.0
        for r, rk in enumerate(ranks):
            got = rk[arch]["logits"]
            for k, (g, w) in enumerate(zip(got, want, strict=True)):
                if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                    fail(f"tp 18.2 {arch} rank {r} call {k}: logits {tuple(g.shape)} not finite "
                         f"or not {tuple(w.shape)}")
                worst = max(worst, float((g - w).abs().max()))
            print(f"time tp 18.2 {arch} rank {r} ({rk[arch]['layout']}; {rk[arch]['bytes']} "
                  f"bytes of weights): prefill_s={rk[arch]['prefill_s']:.4f} decode_ms="
                  f"{rk[arch]['decode_ms']:.4f} (gloo through the host: not a tensor-parallel "
                  f"performance number) peak_reserved_gib={rk[arch]['peak'] / 2**30:.2f}; "
                  f"launches {rk[arch]['launched']} | {smi}")
        summed = {k: sum(rk[arch]["launched"][k] for rk in ranks) for k in ref_launched}
        want_l = {k: TP_M * ref_launched[k] for k in ("flash_attention", "rg_lru")}
        print(f"check tp 18.2 {arch}: {len(want)} calls (prefill + {TP_DECODE} decode steps) of "
              f"{TP_M} ranks against the unsharded path: max |difference| {worst:.5f}, "
              f"{worst / bound:.4f} of the bound 0.05*max(1, max|logits|) = {bound:.4f}; "
              f"the ranks' flash / rg_lru launches {summed['flash_attention']} / "
              f"{summed['rg_lru']}, {TP_M} x the unsharded prefill's: {want_l}")
        if not worst <= bound:
            fail(f"tp 18.2 {arch}: the ranks' logits differ from the unsharded path's by "
                 f"{worst:.5f} > {bound:.5f}")
        if any(summed[k] != v for k, v in want_l.items()):
            fail(f"tp 18.2 {arch}: the ranks launched {summed}, expected {want_l}")
        for k in want_l:
            out["launched"][k] = out["launched"].get(k, 0) + summed[k]
        for rk in ranks:
            for key, n in rk[arch]["shapes"].items():
                out["shapes"][key] = out["shapes"].get(key, 0) + n
    print(f"tp: 18.2 took {time.perf_counter() - t_phase:.1f} s | {smi}")
    return out


def tp_kernel_phase(dev, smi: str, errs: dict) -> tuple[dict, dict, dict]:
    """Phase 18.3: flash_attention and rg_lru at the per-rank shapes of a
    model axis of M = 2 and 4 (TP_RANK_MS): recurrentgemma-9b's flat
    layout, (4 * 16 / M, 3072, 256) at G = 1 (its KV head repeated a query
    head) with window 2048, and its RG-LRU channels (4, 3072, 4096 / M);
    qwen1.5-0.5b's grouped layout, (4 * 16 / M, 3072, 64) at G = 1, causal.
    Each against its twin (rg_lru bit-equal) and timed beside its twin, a
    library call (SDPA; none for rg_lru) and its bound. Returns (flash rows,
    rg_lru rows, each flash row's key in flash_attention.SHAPES)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import rg_lru as rl
    t_phase = time.perf_counter()
    flash, keys, rg = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(183)
    for m in TP_RANK_MS:
        for arch, window in (("recurrentgemma-9b", 2048), ("qwen1.5-0.5b", 0)):
            cfg = configs.get(arch)
            h = TP_B * cfg.n_heads // m
            name = f"{arch} per rank M={m}"
            flash[name] = flash_row(dev, name, 1, h, h, TP_S, TP_S, cfg.hd, True, errs, smi,
                                    180 + m, window=window)
            keys[name] = (h, TP_S, TP_S, cfg.hd, 1, True, window, TP_S)
        w = configs.get("recurrentgemma-9b").rglru_dim // m
        log_a = -8.0 * torch.rand((TP_B, TP_S, w), device=dev, generator=gen)
        x_b = torch.randn((TP_B, TP_S, w), device=dev, generator=gen)
        h0 = torch.randn((TP_B, w), device=dev, generator=gen)
        got, want = rl.rg_lru(log_a, x_b, h0), rl.rg_lru_plain(log_a, x_b, h0)
        check(f"rg_lru per rank M={m} (B, S, W)=({TP_B}, {TP_S}, {w})", got, want, RG_LRU_RTOL,
              rl.rg_lru_plain(log_a, x_b.abs(), h0.abs()), errs, "rg_lru")
        print(f"check rg_lru per rank M={m} bit-equal to its twin: {torch.equal(got, want)}")
        if not torch.equal(got, want):
            fail(f"rg_lru per rank M={m}: not bit-equal to its twin")
        buf = torch.empty_like(log_a)
        t_bytes = 4 * (3 * TP_B * TP_S * w + TP_B * w) / HBM_BYTES_PER_S * 1e3
        t_ops = 3 * TP_B * TP_S * w / FP32_INSTR_PER_S * 1e3
        row = {"ms": device_ms([lambda: rl.rg_lru(log_a, x_b, h0)]),
               "plain_ms": device_ms([lambda: rl.rg_lru_plain(log_a, x_b, h0)], reps=1,
                                     trials=3),
               "library_ms": None, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "stream_ms": device_ms([lambda: torch.add(log_a, x_b, out=buf)])}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rg[f"recurrentgemma-9b per rank M={m}"] = row
        print(f"time rg_lru per rank M={m} ({TP_B}, {TP_S}, {w}): "
              + " ".join(f"{k}={v}" for k, v in row.items()) + f" | {smi}")
        del log_a, x_b, h0, got, want, buf
    torch.cuda.empty_cache()
    print(f"tp: 18.3 took {time.perf_counter() - t_phase:.1f} s | {smi}")
    return flash, rg, keys



# --------------------------------------------------------------------------
# Phase 19: tensor-parallel serving of the MoE, xLSTM, vision and audio
# families (expert parallelism, xLSTM heads, cross attention, the encoder)
# --------------------------------------------------------------------------
def tp_family_graphs(dev, smi: str, model, batch: dict, toks: list, max_len: int,
                     label: str, arch: str) -> None:
    """Phase 19.1, run inside a family's serve phase over its model:
    mesh_graph_checks on the phase's graphed prompt and steps; the mesh
    programs' launches are added to TP19_LAUNCHES."""
    for name, n in mesh_graph_checks(dev, smi, model, batch, toks, max_len, f"tp 19.1 {label}",
                                     arch).items():
        TP19_LAUNCHES[name] = TP19_LAUNCHES.get(name, 0) + n


class F32Compute:
    """Within the block, the port's models compute in float32 (COMPUTE_DTYPE
    of every model module set to float32, as the CPU tests set it)."""

    MODULES = ("layers", "attention", "recurrent", "model", "moe", "xlstm")

    def __enter__(self):
        import importlib

        import torch
        self.saved = []
        for name in self.MODULES:
            mod = importlib.import_module(f"repro_torch.models.{name}")
            self.saved.append((mod, mod.COMPUTE_DTYPE))
            mod.COMPUTE_DTYPE = torch.float32
        return self

    def __exit__(self, *exc):
        for mod, dt in self.saved:
            mod.COMPUTE_DTYPE = dt


def tp19_config(arch: str):
    """19.2's config: published widths, the depth of TP19_FAMILIES."""
    from repro_torch import configs
    cfg = configs.get(arch)
    depth, _, sf = TP19_FAMILIES[arch]
    over = {} if depth is None else {"n_layers": depth}
    if sf is not None:
        over["frontend_tokens"] = sf
    return dataclasses.replace(cfg, **over)


def tp19_serve(dev, arch: str, f32: bool, mesh=None) -> dict:
    """19.2's serve of one family: the model (unsharded with tp_size=TP_M,
    or on ``mesh``) drawn from TP19_SEED, in float32 compute with ``f32``;
    a prefill of TP_B x S tokens (its frontend too) and TP_DECODE cached
    decode steps, eager, at the served MoE capacity, with the expert choices
    recorded (Routes). Returns the logits (float32 on the host), times,
    launches, flash shapes, MoE drops and routes."""
    import contextlib

    import torch
    from repro_torch.data import make_batch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import Model
    cfg = tp19_config(arch)
    _, s, sf = TP19_FAMILIES[arch]
    torch.cuda.reset_peak_memory_stats()
    with F32Compute() if f32 else contextlib.nullcontext():
        kw = dict(tp_size=TP_M) if mesh is None else dict(mesh=mesh)
        model = Model(cfg, device=dev, moe_capacity=launch_serve.MOE_CAPACITY, **kw)
        if f32:
            model = model.float()
        model.init(torch.Generator(device=dev).manual_seed(TP19_SEED))
        for spec, layers in zip(model.stages, model.stage_layers):
            if spec.kind == "cross":
                for blk in layers:
                    blk.p.xgate.fill_(VLM_XGATE)
        batch = make_batch(0, 0, TP_B, s + TP_DECODE, cfg.vocab_size, device=dev,
                           frontend_shape=None if sf is None else (sf, cfg.d_model))
        frontend = None if sf is None else model.local_rows(batch["frontend"])
        with Routes() as routes:
            out, prefill_s, dec_ms, launched, shapes, drops = tp_serve(
                model, model.local_rows(batch["tokens"]), s + TP_DECODE, s, frontend)
        res = dict(logits=out, prefill_s=prefill_s, decode_ms=dec_ms, launched=launched,
                   shapes=shapes, drops=drops, routes=[r.cpu() for r in routes.seen],
                   layout=model.cfg.attn_layout, bytes=model.param_bytes(),
                   vocab=cfg.vocab_size)
        del model
    torch.cuda.empty_cache()
    res["peak"] = torch.cuda.max_memory_reserved()
    return res


def tp19_rank(rank: int, tmp: str, dev) -> None:
    """One of 19.2's ranks: a gloo group whose collectives take the card's
    tensors (as 18.2's tp_rank), on ``dev``; each family of TP19_FAMILIES
    served on the (1, TP_M) mesh, in each of tp19_dtypes. Writes what it
    saw to tmp/rank<r>.pt."""
    import torch
    from repro_torch.launch import mesh as lmesh
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = lmesh.make_mesh((1, TP_M), ("data", "model"), device="cpu")
    out = {}
    for arch in TP19_FAMILIES:
        for f32 in tp19_dtypes(arch):
            out[arch, f32] = tp19_serve(dev, arch, f32, mesh)
    torch.save(out, f"{tmp}/rank{rank}.pt")


def tp19_dtypes(arch: str) -> tuple:
    """bf16 for every family; the MoE also in float32 compute, where its
    routing does not flip at bf16 near-ties, and xlstm-125m (a witness:
    its bf16 gap, the largest of the bound-gated three, is rounding)."""
    return (False, True) if arch in (MOE_ARCH, XLSTM_ARCH) else (False,)


def tp_family_ranks_phase(dev, smi: str) -> dict:
    """Phase 19.2: TP_M gloo ranks sharing the card, eager, each family of
    TP19_FAMILIES at published width (depth cut as phase 16 cuts it),
    against the unsharded Model(cfg, tp_size=TP_M) on the same weights in
    this process: the vlm, whisper and xlstm logits within 0.05 * max(1,
    max |logits|), printed as a share of it; deepseek-moe-16b's and
    xlstm-125m's float32 compute within TP19_F32_RTOL * max(1, max
    |logits|), deepseek's bf16 share printed beside the (token, layer) top-k
    choices that differ from the unsharded model's; the ranks' flash launches exactly TP_M times the
    unsharded serve's; each rank's MoE drops equal to the unsharded model's
    in float32 (bf16's printed). Gloo stages every all-reduce through the
    host: no time here is a tensor-parallelism number. Returns the ranks'
    launches and flash shapes."""
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import mesh as lmesh

    t_phase = time.perf_counter()
    refs = {}
    for arch in TP19_FAMILIES:
        for f32 in tp19_dtypes(arch):
            refs[arch, f32] = r = tp19_serve(dev, arch, f32)
            print(f"tp 19.2 unsharded {arch} ({tp19_config(arch).n_layers} layers, layout "
                  f"{r['layout']}, {'float32' if f32 else 'bf16'} compute): prefill {TP_B} x "
                  f"{TP19_FAMILIES[arch][1]} {r['prefill_s']:.4f} s, decode {r['decode_ms']:.4f} "
                  f"ms a step; launches {r['launched']}, MoE drops {sum(map(sum, r['drops']))}; "
                  f"peak_reserved_gib={r['peak'] / 2**30:.2f} | {smi}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp19_")
    try:
        t0 = time.perf_counter()
        lmesh.spawn(tp19_rank, TP_M, (tmp, dev), init_method=f"file://{tmp}/rendezvous",
                    device="cpu")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(TP_M)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"tp 19.2: {TP_M} ranks on {torch.cuda.get_device_name(0)} over gloo, {spawn_s:.1f} s "
          f"from spawn to exit | {smi}")
    out: dict = {"launched": {}, "shapes": {}}
    for (arch, f32), ref in refs.items():
        want, vocab = ref["logits"], ref["vocab"]
        absmax = max(float(w[..., :vocab].abs().max()) for w in want)
        tol = (TP19_F32_RTOL if f32 else 0.05) * max(1.0, absmax)
        what = "float32 compute" if f32 else "bf16"
        worst = 0.0
        for r, rk in enumerate(ranks):
            got = rk[arch, f32]
            for k, (g, w) in enumerate(zip(got["logits"], want, strict=True)):
                if g.shape != w.shape or not bool(torch.isfinite(g[..., :vocab]).all()):
                    fail(f"tp 19.2 {arch} {what} rank {r} call {k}: logits {tuple(g.shape)} not "
                         f"finite or not {tuple(w.shape)}")
                worst = max(worst, float((g - w).abs().max()))
            print(f"time tp 19.2 {arch} {what} rank {r} ({got['layout']}; {got['bytes']} bytes "
                  f"of weights): prefill_s={got['prefill_s']:.4f} decode_ms="
                  f"{got['decode_ms']:.4f} (gloo through the host: not a tensor-parallel "
                  f"performance number) peak_reserved_gib={got['peak'] / 2**30:.2f}; launches "
                  f"{got['launched']} | {smi}")
        summed = {k: sum(rk[arch, f32]["launched"][k] for rk in ranks) for k in ref["launched"]}
        flips = 0
        for g, w in zip(ranks[0][arch, f32]["routes"], ref["routes"], strict=True):
            flips += int((torch.sort(g, -1)[0] != torch.sort(w, -1)[0]).any(-1).sum())
        drops = [rk[arch, f32]["drops"] for rk in ranks]
        same_drops = all(d == ref["drops"] for d in drops)
        print(f"check tp 19.2 {arch} {what}: {len(want)} calls (prefill + {TP_DECODE} decode "
              f"steps) of {TP_M} ranks against the unsharded path: max |difference| "
              f"{worst:.6f}, {worst / tol:.4f} of the bound "
              f"{TP19_F32_RTOL if f32 else 0.05:g}*max(1, max|logits|) = {tol:.5f}; flash "
              f"launches {summed['flash_attention']}, "
              f"{TP_M} x the unsharded {ref['launched']['flash_attention']}; (token, layer) "
              f"top-k choices of rank 0 that differ from the unsharded model's: {flips} of "
              f"{sum(r.shape[0] for r in ref['routes'])}; MoE drops by call "
              f"{[sum(d) for d in drops[0]]} (unsharded {[sum(d) for d in ref['drops']]}), "
              f"equal on every rank: {same_drops}")
        if summed["flash_attention"] != TP_M * ref["launched"]["flash_attention"]:
            fail(f"tp 19.2 {arch} {what}: the ranks launched {summed['flash_attention']} flash "
                 f"kernels, expected {TP_M} x {ref['launched']['flash_attention']}")
        if (arch != MOE_ARCH or f32) and not worst <= tol:
            fail(f"tp 19.2 {arch} {what}: the ranks' logits differ from the unsharded path's by "
                 f"{worst:.6f} > {tol:.6f}")
        if (arch != MOE_ARCH or f32) and not same_drops:
            fail(f"tp 19.2 {arch} {what}: the ranks' MoE drops {drops} differ from the "
                 f"unsharded model's {ref['drops']}")
        for k, n in summed.items():
            out["launched"][k] = out["launched"].get(k, 0) + n
        for rk in ranks:
            for key, n in rk[arch, f32]["shapes"].items():
                out["shapes"][key] = out["shapes"].get(key, 0) + n
    print(f"tp: 19.2 took {time.perf_counter() - t_phase:.1f} s | {smi}")
    return out


def tp_family_kernel_phase(dev, smi: str, errs: dict) -> tuple[dict, dict]:
    """Phase 19.3: flash_attention at the per-rank shapes of a model axis of
    M = 2 and 4 (TP_RANK_MS), every one grouped (KV heads divide): 19.2's
    prompts (deepseek-moe-16b's self attention, 16 / M of 16 heads at G = 1,
    and llama-3.2-vision-11b's, 32 / M over 8 / M at G = 4, causal over
    1024 tokens; the vlm's cross attention, 1024 over 1601; whisper-small's
    encoder over 1500 frames, its decoder's causal self attention over 448
    and cross attention, 448 over 1500, 12 / M heads at G = 1) and the
    vlm's served cross attention, 3072 over 1601. Each against its twin and
    timed beside its twin, SDPA and its bound (flash_row); deepseek's also
    in float32 (19.2's float32-compute run) against its twin within
    KERNEL_RTOL. Returns (rows, each row's key in flash_attention.SHAPES)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    t_phase = time.perf_counter()
    rows, keys = {}, {}
    for m in TP_RANK_MS:
        for arch, label, sq, sk, causal in (
                (MOE_ARCH, "self-attention", 1024, 1024, True),
                (VLM_ARCH, "self-attention", 1024, 1024, True),
                (VLM_ARCH, "cross-attention", 1024, 1601, False),
                (VLM_ARCH, "cross-attention, served", 3072, 1601, False),
                (AUDIO_ARCH, "encoder", 1500, 1500, False),
                (AUDIO_ARCH, "decoder self-attention", 448, 448, True),
                (AUDIO_ARCH, "decoder cross-attention", 448, 1500, False)):
            cfg = configs.get(arch)
            h, kv = cfg.n_heads // m, cfg.n_kv_heads // m
            name = f"{arch} {label} per rank M={m}"
            rows[name] = flash_row(dev, name, TP_B, h, kv, sq, sk, cfg.hd, causal, errs, smi,
                                   190 + len(rows))
            keys[name] = (TP_B * h, sq, sk, cfg.hd, h // kv, causal, 0, sk)
    cfg = configs.get(MOE_ARCH)
    h = cfg.n_heads // TP_M
    gen = torch.Generator(device=dev).manual_seed(192)
    q, k, v = (torch.randn((TP_B * h, 1024, cfg.hd), device=dev, generator=gen)
               for _ in range(3))
    check(f"flash_attention {MOE_ARCH} self-attention per rank M={TP_M} float32",
          fa.flash_attention(q, k, v, 1, True), fa.flash_attention_plain(q, k, v, 1, True),
          KERNEL_RTOL, fa.flash_attention_plain(q, k, v.abs(), 1, True), errs,
          "flash_attention")
    del q, k, v
    torch.cuda.empty_cache()
    print(f"tp: 19.3 took {time.perf_counter() - t_phase:.1f} s | {smi}")
    return rows, keys

if __name__ == "__main__":
    sys.exit(main())
