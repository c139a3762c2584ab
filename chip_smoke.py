#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches its own error):
  1. device   -- the card's name, and its name and power limit from nvidia-smi;
  2. build    -- compile the CUDA kernels from src/repro_torch/kernels/csrc;
  3. kernels  -- every kernel against its plain PyTorch twin at the paper's
                 scale (U=1250 users, N=16 APs, M=250 subchannels): both links,
                 forward and backward, dense and with a CellLayout; then the
                 rates and their gradients, kernel backend against einsum; then
                 each kernel's time beside its plain twin's, a one-call PyTorch
                 yardstick's where there is one, and its bound;
  4. main path -- PlannerEngine(nin, sinr_backend="kernel").plan on a sampled
                 env, then two replans on gains perturbed by a few percent, with
                 the kernel launch counters read around them; the plan is
                 checked for finiteness and feasibility, and at the cold start
                 of one split the utility and its gradient under "kernel" are
                 held against "einsum";
  5. profile  -- 40 GD steps of one split under torch.profiler: wall time
                 per step, device busy time and share, and the top kernels
                 by device time.
The last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

U, N, M = 1250, 16, 250            # the paper's users and subchannels; 16 APs
MAX_ITERS = 200
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside the tensor cores
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
TPU_KERNELS = {
    "noma_cell_intra": "src/repro/kernels/noma_rates.py:280",
    "noma_per_ap": "src/repro/kernels/noma_rates.py:355",
    "noma_ap_contract": "src/repro/kernels/noma_rates.py:409",
}
SOURCE = "src/repro_torch/kernels/csrc/noma_rates.cu"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def main() -> int:
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

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (noma_rates.cu, sm_90a)")
    for line in build.BUILD_INFO.get("noma_rates", {}).get("log", "").splitlines():
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

    # Times at the main path's shapes (dense schedule, forward): the uplink
    # intra, the uplink per-AP table, the downlink contraction. The gain
    # kernels cycle through 4 copies of their inputs (85 MB) so the gain is
    # not served from the 50 MB L2 cache on every launch.
    own_up, g_up, ap = ops._inputs(env, True)
    _, g_dn, _ = ops._inputs(env, False)
    tx_up = (beta * p_up[:, None]).contiguous()
    tx_dn = (beta * p_dn[:, None]).contiguous()
    w_in = (tx_up * own_up).contiguous()
    csr = nr.dense_csr(-(-U // nr.BLOCK_U), -(-U // nr.BLOCK_V), dev)
    intra_args = (own_up, own_up, w_in, ap, ap, *csr, nr.BLOCK_U, nr.BLOCK_V, True)
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
          torch.einsum("mrs,sm->rm", mask, w_in), nr.noma_cell_intra_plain(*intra_args),
          KERNEL_RTOL, nr.noma_cell_intra_plain(own_up, own_up, w_in.abs(),
                                                *intra_args[3:]))
    f4 = 4
    # Bytes each input read once, each output written once; own and ap are
    # one tensor in both roles. The operations of intra are instructions
    # (compare, select, add) per same-cell triple at the non-FMA rate; of
    # per_ap and contract, a multiply-add per (w, n, m) at the FLOP rate.
    timing = {
        "noma_cell_intra": dict(
            kernel=[lambda: nr.noma_cell_intra(*intra_args)],
            plain=[lambda: nr.noma_cell_intra_plain(*intra_args)],
            library=[lambda: torch.einsum("mrs,sm->rm", mask, w_in)],
            bytes=f4 * (3 * U * M + U) + 4 * (csr[0].numel() + csr[1].numel()),
            ops_s=3 * same_triples / FP32_INSTR_PER_S),
        "noma_per_ap": dict(
            kernel=[lambda g=g: nr.noma_per_ap(ap, tx_up, g, True) for g in g_ups],
            plain=[lambda g=g: nr.noma_per_ap_plain(ap, tx_up, g, True) for g in g_ups],
            library=[lambda g=g: torch.einsum("wn,wm,wnm->nm", other, tx_up, g)
                     for g in g_ups],
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
        print(f"time {name}: " + " ".join(f"{k}={v}" for k, v in rows[name].items()))
    print(f"time noma_cell_intra: dense schedule visits {U * U * M:.3e} (r,s,m) triples, "
          f"{3 * U * U * M / FP32_INSTR_PER_S * 1e3:.4f} ms of instructions; the data "
          f"needs {same_triples:.3e} same-cell triples")
    del g_ups, g_dns, timing, mask
    torch.cuda.empty_cache()

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
    walls, states, steps, reads = [], [], [], []
    prev = None
    for e_i in (env, env1, env2):
        t0 = time.perf_counter()
        before = dict(li_gd.COUNTS)
        prev = eng.plan(e_i) if prev is None else eng.replan(prev, e_i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        steps.append(li_gd.COUNTS["steps"] - before["steps"])
        reads.append(li_gd.COUNTS["host_reads"] - before["host_reads"])
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
    # Every utility evaluation goes through the kernels: per GD step one
    # value_and_grad (2 forward + 2 backward pairwise calls) and one
    # re-evaluation (2 forward); per split one start evaluation; per plan
    # two discrete-utility evaluations; per replan split two warm probes.
    total_steps = sum(steps)
    n_evals = total_steps + splits * 3 + 2 * 3 + 2 * splits * 2
    expect = {"noma_cell_intra": 4 * total_steps + 2 * n_evals,
              "noma_per_ap": 2 * total_steps + n_evals,
              "noma_ap_contract": 2 * total_steps + n_evals}
    print(f"main launches expected from {total_steps} steps: {expect}; per GD step "
          f"intra 6, per_ap 3, contract 3")
    for k, v in launches.items():
        if v <= 0:
            fail(f"{k} was not launched on the main path")
        if v != expect[k]:
            fail(f"{k}: {v} launches on the main path, expected {expect[k]}")

    for name, st in zip(("plan", "replan1", "replan2"), states):
        plan, rc, cc = st.plan, env.radio, env.comp
        for field in ("p_up", "p_dn", "r", "utility", "per_layer_utility"):
            if not bool(torch.isfinite(getattr(plan, field)).all()):
                fail(f"{name}: {field} not finite")
        s = int(plan.s)
        if not 0 <= s <= prof.n_layers:
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
            if int(x.min()) < 0 or int(x.max()) >= M:
                fail(f"{name}: {field} outside [0, {M})")
    print("main plan checks: finite, beta rows on the floored simplex, powers and r in "
          "their boxes, subchannels in range")

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

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": TPU_KERNELS[name], "launches": launches[name],
                "max_abs_err": errs[name], **rows[name]} for name in TPU_KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
