"""Serving driver with ECC split inference.

The ECC planner (the paper's contribution) picks the split layer s* and the
radio resource allocation for a fleet of devices sharing a NOMA cell; the
runtime then cuts the model at s*, serves a batch of requests through the
device and edge halves, and reports per-phase times including the
simulated NOMA uplink. Runs on the card unless --device says otherwise.
The vision and audio archs run as the JAX entry point runs them, with no
frontend: their cross attention reads the token stream itself
(runtime.serve.make_split_serve).

  python -m repro_torch.launch.serve --arch recurrentgemma-9b
  python -m repro_torch.launch.serve --arch deepseek-moe-16b --seq 3072 --new-tokens 2
  python -m repro_torch.launch.serve --arch xlstm-125m --seq 3072 --new-tokens 1
  python -m repro_torch.launch.serve --arch llama-3.2-vision-11b --seq 3072 --new-tokens 2
  python -m repro_torch.launch.serve --arch whisper-small --seq 448 --new-tokens 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \\
      --reduced --device cpu --requests 2 --seq 48 --new-tokens 2
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.core import GdConfig, channel, make_env, make_weights, profiles
from repro_torch.data import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.planning import PlannerEngine
from repro_torch.runtime.serve import SplitPrograms, make_split_serve, transfer_seconds

PARAM_SEED = 1   # the weights' generator seed, as the JAX driver's PRNGKey(1)
MOE_CAPACITY = 4.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--users", type=int, default=12)
    ap.add_argument("--aps", type=int, default=3)
    ap.add_argument("--subchannels", type=int, default=4)
    ap.add_argument("--w-delay", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    return ap.parse_args(argv)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def plan_split(cfg, args: argparse.Namespace, device: torch.device):
    """ECC planning over the arch's per-block profile, on the env of
    (--users, --aps, --subchannels) drawn from --seed, with the SINR through
    the NOMA kernels. Returns (the engine's SplitPlan, user 0's uplink rate
    in bit/s under it)."""
    env = make_env(args.users, args.aps, args.subchannels, seed=args.seed, device=device)
    prof = profiles.from_arch_config(cfg, seq=args.seq)
    w = make_weights(env.n_users, args.w_delay, device=device)
    engine = PlannerEngine(prof, weights=w, cfg=GdConfig(max_iters=150),
                           sinr_backend="kernel", device=device)
    plan = engine.plan(env).plan
    beta_up, beta_dn = (F.one_hot(sub.long(), env.n_sub).float()
                        for sub in (plan.sub_up, plan.sub_dn))
    r_up, _ = channel.user_rates(env, beta_up, beta_dn, plan.p_up, plan.p_dn)
    return plan, float(r_up[0])


def serve(progs: SplitPrograms, tokens, new_tokens: int, rate_bps: float,
          d_model: int) -> dict:
    """Serve a batch of requests through the split: device half, simulated
    NOMA uplink, edge half, then greedy continuation (each new token repeats
    the split path over the grown sequence). Returns the phase seconds of
    the first pass, the wall seconds of the whole and the new tokens
    (B, new_tokens)."""
    dev = tokens.device
    sync(dev)
    t_all = t0 = time.perf_counter()
    act = progs.device_fn(tokens)
    sync(dev)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = progs.edge_fn(act)
    nxt = torch.argmax(logits[:, -1], dim=-1)
    sync(dev)
    t_edge = time.perf_counter() - t0
    del act, logits
    generated = [nxt]
    seq = tokens
    for _ in range(new_tokens - 1):
        seq = torch.cat([seq, nxt[:, None].to(seq.dtype)], dim=1)
        logits = progs.edge_fn(progs.device_fn(seq))
        nxt = torch.argmax(logits[:, -1], dim=-1)
        del logits
        generated.append(nxt)
    sync(dev)
    return {"device_s": t_dev, "edge_s": t_edge,
            "link_s": transfer_seconds(tokens.numel(), d_model, rate_bps),
            "wall_s": time.perf_counter() - t_all,
            "new_tokens": torch.stack(generated, dim=1)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    # 1. plan: s* and the radio allocation
    plan, rate0 = plan_split(cfg, args, dev)
    s = int(plan.s)
    print(f"[plan] split layer s*={s}/{cfg.n_layers}, uplink rate {rate0 / 1e6:.2f} Mb/s, "
          f"utility {float(plan.utility):.4f}")

    # 2. cut the model at s* (MoE capacity 4.0, as the JAX driver's)
    model = Model(cfg, device=dev, moe_capacity=MOE_CAPACITY).init(
        torch.Generator(device=dev).manual_seed(PARAM_SEED))
    progs = make_split_serve(model, s)

    # 3. serve the batch of requests
    tokens = make_batch(args.seed, 0, args.requests, args.seq, cfg.vocab_size,
                        device=dev)["tokens"]
    out = serve(progs, tokens, args.new_tokens, rate0, cfg.d_model)
    print(f"[serve] {args.requests} reqs x {args.seq} tok: device {out['device_s']:.3f}s"
          f" + NOMA uplink {out['link_s']:.3f}s (simulated) + edge {out['edge_s']:.3f}s")
    print(f"[serve] first new tokens: {out['new_tokens'][:8, 0].tolist()}")
    print(f"[serve] generated {args.new_tokens} tokens/request in {out['wall_s']:.3f}s; done")
    return {"plan": plan, "split": s, **out}


if __name__ == "__main__":
    main()
