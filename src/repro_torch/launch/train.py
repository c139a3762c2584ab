"""Fault-tolerant training entry point, on one device.

  python -m repro_torch.launch.train
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \\
      --device cpu --steps 4 --batch 2 --seq 32

Runs on the card unless --device says otherwise. The data stream is a pure
function of (seed, step), so a restarted job picks it up at the step of
its checkpoint. As in the JAX package's launcher, a checkpoint written during the run
is labelled with the step whose batch it has just trained (the state after
step + 1 updates), and the one written at the end with the number of steps
done; a run resumed from a label reads the stream from that step. --mesh
takes 1x1 only: a mesh of more devices waits for the port of
runtime/sharding (ROADMAP.md section 1, item 5).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.runtime import ft
from repro_torch.runtime.train import init_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    return ap.parse_args(argv)


def check_mesh(spec: str) -> None:
    """Accept a mesh of one device ("1", "1x1", "1x1x1"); raise for more."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) not in (1, 2, 3):
        raise ValueError(f"--mesh {spec}: 1 to 3 axes")
    if any(d != 1 for d in dims):
        raise NotImplementedError(
            f"--mesh {spec}: a mesh of more than one device waits for the port of "
            "runtime/sharding (ROADMAP.md section 1, item 5)")


def frontend_shape(cfg, seq: int):
    """The frontend a batch of this arch carries, or None."""
    if cfg.family not in ("audio", "vlm"):
        return None
    return (cfg.frontend_tokens if cfg.family == "vlm" else seq, cfg.d_model)


def main(argv=None) -> dict:
    """Train; returns the steps done, the start step, each logged step's
    loss (step -> float), retries, straggler steps, the final TrainState
    and the wall seconds. Every family trains; vlm and audio batches carry
    a frontend drawn as the JAX package's launcher draws it:
    (frontend_tokens, d_model) image tokens for vlm, (seq, d_model) frames
    for audio."""
    args = parse_args(argv)
    check_mesh(args.mesh)
    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=dev, moe_capacity=2.0, trainable=True, remat=True)
    step_fn = make_train_step(model, args.microbatches)

    mgr = CheckpointManager(args.ckpt_dir)
    state = init_state(model, torch.Generator(device=dev).manual_seed(args.seed))
    start = mgr.latest_step()
    if start is not None:
        state, start = mgr.restore(state, device=dev)
        print(f"[resume] from step {start}")
    else:
        start = 0

    data = SyntheticLM(args.seed, args.batch, args.seq, cfg.vocab_size,
                       frontend_shape(cfg, args.seq), start_step=start, device=dev)
    holder = {"state": state}
    losses: dict[int, float] = {}

    def step_once(i):
        batch = next(data)
        holder["state"], metrics = step_fn(holder["state"], batch)
        s = start + i
        if s % args.log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            losses[s] = m["loss"]
            print(f"step {s:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
                  f"lr {m['lr']:.2e}", flush=True)
        if s and s % args.ckpt_every == 0:
            mgr.save_async(s, holder["state"])

    def restore_fn():
        mgr.wait()
        st = mgr.latest_step() or 0
        if mgr.latest_step() is not None:
            holder["state"], st = mgr.restore(holder["state"], device=dev)
        return max(0, st - start)

    t0 = time.time()
    try:
        done, retries, stragglers = ft.run_with_retries(
            step_once, args.steps, restore_fn, step_timeout_s=1800.0,
            on_straggler=lambda i, dt: print(f"[straggler] step {i} took {dt:.2f}s"))
        mgr.save_async(start + done, holder["state"])
        mgr.wait()
    finally:
        data.close()
    dt = time.time() - t0
    print(f"trained {done} steps in {dt:.1f}s "
          f"({args.batch * args.seq * done / dt:.0f} tok/s); "
          f"retries={retries} straggler_steps={stragglers}")
    return {"done": done, "start": start, "losses": losses, "retries": retries,
            "stragglers": stragglers, "state": holder["state"], "wall_s": dt}


if __name__ == "__main__":
    main()
