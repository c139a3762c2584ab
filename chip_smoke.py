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
                 plan_many and two epochs of step_many -> env_many ->
                 replan_many with exact launch counts (6 / 3 / 3 a fleet GD
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
                 steps: 12.1 phase 4's plan and two replans; 12.2 the plan and
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
                 13.2 xlstm-125m (12 layers,
                 mLSTM / sLSTM): the entry point (no TPU kernel on its
                 path), split logits at s* and s=6 bit-equal, prefill of
                 11 chunks + 8 decode steps against the forward, a
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
The last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""
import dataclasses
import json
import os
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
# 3072 tokens as phase 6; the second split point each holds to the bit, and
# the served tokens on which sorted MoE is held to dense.
MOE_ARCH, XLSTM_ARCH = "deepseek-moe-16b", "xlstm-125m"
MOE_SPLIT, XLSTM_SPLIT = 14, 6
MOE_DENSE_TOKENS = 1024
# 13.2's graphed serve steps: a prompt of two mLSTM chunks
XLSTM_GRAPH_S = 512
# Phase 14: the vision and audio families. llama-3.2-vision-11b serves 4 x
# 3072 tokens over its 1601 image tokens with every cross block's gate at
# VLM_XGATE, and is held to the bit at a split inside a group of 4 attn + 1
# cross layers; whisper-small serves 4 x 448 decoder tokens (its published
# text context, n_text_ctx) over 1500 frames, and its reference-shaped split
# is held to the bit between s* and a split inside the decoder.
VLM_ARCH, AUDIO_ARCH = "llama-3.2-vision-11b", "whisper-small"
VLM_SPLIT, VLM_XGATE = 22, 0.5
AUDIO_S, AUDIO_SPLIT = 448, 18
# TPU kernel each CUDA kernel replaces, and its source in this repo.
NOMA_SOURCE = "src/repro_torch/kernels/csrc/noma_rates.cu"
TPU_KERNELS = {
    "noma_cell_intra": ("src/repro/kernels/noma_rates.py:280", NOMA_SOURCE),
    "noma_per_ap": ("src/repro/kernels/noma_rates.py:355", NOMA_SOURCE),
    "noma_ap_contract": ("src/repro/kernels/noma_rates.py:409", NOMA_SOURCE),
    "flash_attention": ("src/repro/kernels/flash_attention.py:75",
                        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "rg_lru": ("src/repro/kernels/rg_lru.py:41", "src/repro_torch/kernels/csrc/rg_lru.cu"),
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


def memory_mark(torch, label: str, peaks: dict) -> None:
    """Keep the allocator's peak reserve since the last mark under label."""
    peaks[label] = torch.cuda.max_memory_reserved()
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


def profile_graph_steps(eng, kind: str, env, n_steps: int, label: str, eager: tuple,
                        smi: str) -> None:
    """n_steps replays of the engine's captured GD step of split 4 (the
    program of (kind, env), already built) in gd_solve's chunks, one read
    of the stop flag a chunk, under torch.profiler; printed beside the
    eager (ms a step, busy share). The NOMA kernels on the device trace
    must equal what the replays' bookkeeping added to the counters."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import graphs
    from repro_torch.core import li_gd
    from repro_torch.kernels import noma_rates as nr
    prog = eng.program(kind, env)
    step_graph = prog._graphs[(4, env.radio, env.comp)]
    done = prog._live["done"]
    chunks, k = [], 1
    while sum(chunks) < n_steps:
        chunks.append(min(k, n_steps - sum(chunks)))
        k = min(2 * k, li_gd.SYNC_EVERY)
    torch.cuda.synchronize()
    nr.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_g:
        t0 = time.perf_counter()
        for k in chunks:
            for _ in range(k):
                step_graph.replay()
            bool(done.all())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof_g.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    if busy <= 0:
        fail(f"{label}: torch.profiler recorded no device time for the graphed steps")
    kernels = sum(e.count for e in rows)
    seen = {k: n for k, n in graphs.kernel_launches(prof_g).items() if k in nr.LAUNCHES}
    print(f"check {label}: NOMA kernels on the device trace of the replays {seen}, counted "
          f"by the replays {dict(nr.LAUNCHES)}: {seen == nr.LAUNCHES}")
    if seen != nr.LAUNCHES or not sum(seen.values()):
        fail(f"{label}: the replays ran {seen} on the device but counted {dict(nr.LAUNCHES)}")
    print(f"{label} {n_steps} step replays in chunks {chunks} (profiled): wall_s={wall:.4f} "
          f"per_step_ms={wall / n_steps * 1e3:.4f} device_busy_s={busy:.4f} "
          f"busy_ms_per_step={busy / n_steps * 1e3:.4f} busy_share={busy / wall:.4f} "
          f"kernels_per_step={kernels / n_steps:.1f}; eager per_step_ms="
          f"{eager[0] * 1e3:.3f} busy_share={eager[1]:.4f} | {smi}")


def main() -> int:
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof_cfg = GdConfig(optimizer="adam", max_iters=40, eps=0.0, sinr_backend="kernel")
    start = li_gd.cold_init(env2)
    li_gd.gd_solve(env2, eng.prof, 4, w, start, prof_cfg)      # warm-up
    torch.cuda.synchronize()
    li_gd.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        li_gd.gd_solve(env2, eng.prof, 4, w, start, prof_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_steps = li_gd.COUNTS["steps"]
    rows_k = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows_k)
    if busy_us <= 0:
        fail("torch.profiler recorded no device time")
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
    del model
    torch.cuda.empty_cache()

    memory_mark(torch, "11", peaks)
    # -- 12. the engine's compiled programs against the eager path -------------
    programs_phase(dev, smi, main, fleet_path)
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
    print("memory: peak reserved by phase (GiB): " + ", ".join(
        f"{k} {v / 2**30:.2f}" for k, v in peaks.items()))
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[name], "max_abs_err": errs[name], **rows[name]}
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

    # 7.2 the main path: plan_many, then two epochs of step_many -> env_many
    # -> replan_many, with the launch counters read around them
    prof = profiles.nin()
    eng = PlannerEngine(prof, cfg=cfg, sinr_backend="kernel")
    torch.cuda.synchronize()
    nr.reset_launches()
    li_gd.reset_counts()
    walls, fleet_states, steps, env_list, call_launches = [], [], [], [], []
    prev = None
    for epoch in range(3):
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
    for name, st, wall, n_steps in zip(("plan_many", "replan_many1", "replan_many2"),
                                       fleet_states, walls, steps):
        rho = None if st.warm_rho is None else [round(x, 6) for x in st.warm_rho.tolist()]
        used = (st.opt_steps > st.plan.iters).int().tolist()
        print(f"fleet {name}: wall_s={wall:.3f} fleet_steps={n_steps} s*={st.plan.s.tolist()} "
              f"total_iters={st.total_iters.tolist()} warm_rho={rho}")
        print(f"fleet {name}: used_warm per member {used}")
        print(f"fleet {name}: utility {[f'{x:.7g}' for x in st.plan.utility.tolist()]}")
    total_steps = sum(steps)
    expect = plan_launches(total_steps, splits * 3 + 2 * 3 + 2 * splits * 2)
    print(f"fleet launches: {launches}; expected from {total_steps} fleet GD steps: {expect} "
          f"(6 / 3 / 3 a fleet step, whatever B)")
    for k, v in launches.items():
        if v != expect[k]:
            fail(f"fleet: {k} launched {v} times on the fleet path, expected {expect[k]}")
        fleet[k]["fleet_launches"] = v
    for name, st, e_i in zip(("plan_many", "replan_many1", "replan_many2"), fleet_states,
                             env_list):
        for i in range(b):
            check_plan(f"fleet {name} member {i}", member(st, i), member(e_i, i), prof.n_layers)
    print(f"fleet plan checks: all {b} members of the 3 epochs finite and feasible")

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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    env2 = env_list[-1]
    start = li_gd.cold_init(env2)
    li_gd.gd_solve(env2, prof, 4, w, start, step_cfg)      # warm-up
    torch.cuda.synchronize()
    li_gd.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_run:
        t0 = time.perf_counter()
        li_gd.gd_solve(env2, prof, 4, w, start, step_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_steps = li_gd.COUNTS["steps"]
    rows_k = [e for e in prof_run.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows_k)
    if busy_us <= 0:
        fail("torch.profiler recorded no device time for the fleet")
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
            for _ in range(3):
                if loop.server.epoch % loop.server.replan_every:
                    break
                loop.step_epoch()
            torch.cuda.synchronize()
            nr.reset_launches()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
                t0 = time.perf_counter()
                loop.step_epoch()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows_k = [e for e in pr.key_averages() if e.device_type == DeviceType.CUDA]
            busy_us = sum(e.self_device_time_total for e in rows_k)
            if busy_us <= 0:
                fail("loop 10.2: torch.profiler recorded no device time")
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
    calls = (("plan", "plan (captures)", env, None), ("replan", "replan1 (captures)", env1,
                                                      states[0]),
             ("replan", "replan2 (replays)", env2, states[1]))
    for i, (kind, label, e_i, prev) in enumerate(calls):
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
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    rows_k = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows_k)
    if busy_us <= 0:
        fail(f"{label}: torch.profiler recorded no device time")
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
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    if busy <= 0:
        fail(f"{label}: torch.profiler recorded no device time")
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
              causal: bool, errs: dict, smi: str, seed: int) -> dict:
    """The bf16 flash kernel at one served shape, q (b*h, sq, hd) over k/v
    (b*kv, sk, hd), no window (causal only at sq == sk): against its plain
    twin within FLASH_RTOL of the twin on |v|, then its time beside the
    twin's, one scaled_dot_product_attention call's (is_causal, or no mask;
    enable_gqa where G > 1) and its bound, the larger of 4 hd FLOP an
    unmasked (q, k) pair at the bf16 rate and the bytes of q, k, v and the
    output once at the HBM rate. Returns the timing row; adds the check's
    error to errs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b * h, sq, hd), device=dev, generator=gen).bfloat16()
    k, v = (torch.randn((b * kv, sk, hd), device=dev, generator=gen).bfloat16()
            for _ in range(2))
    args = (h // kv, causal, 0)
    mask = "causal" if causal else "no mask"
    got = fa.flash_attention(q, k, v, *args)
    torch.cuda.synchronize()
    check(f"flash_attention {label} B={b} Sq={sq} Sk={sk} H={h}/{kv} hd={hd} {mask}",
          got.float(), fa.flash_attention_plain(q, k, v, *args).float(), FLASH_RTOL,
          fa.flash_attention_plain(q, k, v.abs(), *args).float(), errs, "flash_attention")
    del got
    qs, ks, vs = q.view(b, h, sq, hd), k.view(b, kv, sk, hd), v.view(b, kv, sk, hd)
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    flash_ops = 4 * hd * pairs * b * h
    flash_bytes = 2 * (2 * b * h * sq * hd + 2 * b * kv * sk * hd)
    t_bytes = flash_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flash_ops / BF16_OPS_PER_S * 1e3
    gqa = h != kv
    row = {
        "ms": device_ms([lambda: fa.flash_attention(q, k, v, *args)], reps=5),
        "plain_ms": device_ms([lambda: fa.flash_attention_plain(q, k, v, *args)], reps=1,
                              trials=3),
        "library_ms": device_ms([lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, enable_gqa=gqa)], reps=5),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print(f"time flash_attention at {label}'s shape ({b * h}, {sq}, {hd}) over ({b * kv}, {sk}) "
          f"G={h // kv} {mask}: " + " ".join(f"{k}={v}" for k, v in row.items())
          + f" ({flash_ops:.4e} FLOP, {flash_bytes / 1e6:.1f} MB; library: "
          f"scaled_dot_product_attention, {'is_causal' if causal else 'no mask'}"
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
    B, S = SERVE_B, SERVE_S
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


if __name__ == "__main__":
    sys.exit(main())
