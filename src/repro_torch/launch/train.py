"""Fault-tolerant training entry point, on one device or data-parallel over
a mesh of D ranks.

  python -m repro_torch.launch.train
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \\
      --device cpu --steps 4 --batch 2 --seq 32
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --reduced \\
      --device cpu --mesh 2x1 --steps 4 --batch 2 --seq 32

Runs on the card unless --device says otherwise. The data stream is a pure
function of (seed, step), so a restarted job picks it up at the step of
its checkpoint. As in the JAX package's launcher, a checkpoint written during the run
is labelled with the step whose batch it has just trained (the state after
step + 1 updates), and the one written at the end with the number of steps
done; a run resumed from a label reads the stream from that step.

--mesh D, DxM or PxDxM names the ("data",), ("data", "model") or ("pod",
"data", "model") mesh. The model is built on the mesh (each rank its
shard): a model axis above 1 trains any family tensor-parallel, and a MoE
layer takes the whole global batch's capacity and aux loss; each rank
takes its rows of the tokens and of the frontend (a vlm's image tokens,
whisper's frames), the ranks of one model index across ("pod", "data")
their own rows.
Under torchrun, or inside a process group the caller made, each process is
a rank; a mesh of more than one device without either starts its ranks
itself (launch.mesh.spawn) and returns rank 0's result. Under a process
group the step is runtime.train.jit_train_step over launch.mesh.make_mesh;
without one it is make_train_step on the one device (the same bits). Every
rank draws the whole global batch, as the one-device run does, and trains
on its rows. Rank 0 writes the checkpoints, of whole tensors (the model
axis's shards gathered, convert.train_state_whole); every rank restores
them and cuts its shard (the state's shardings), so a checkpoint restores
on any mesh whose model axis gives the model the same parameter shapes (no
mesh, too, where that is M = 1's: a flat layout that pads the heads holds
wider wq / wo).
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import configs, convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as lmesh
from repro_torch.models import Model
from repro_torch.runtime import ft
from repro_torch.runtime.train import (
    TrainState,
    init_state,
    jit_train_step,
    make_train_step,
)

MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


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


def check_mesh(spec: str) -> tuple[tuple, tuple]:
    """(dims, axes) of a --mesh spec."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) not in MESH_AXES or any(d < 1 for d in dims):
        raise ValueError(f"--mesh {spec}: 1 to 3 axes of at least one device")
    return dims, MESH_AXES[len(dims)]


def _config(args):
    cfg = configs.get(args.arch)
    return cfg.reduced() if args.reduced else cfg


def frontend_shape(cfg, seq: int):
    """The frontend a batch of this arch carries, or None."""
    if cfg.family not in ("audio", "vlm"):
        return None
    return (cfg.frontend_tokens if cfg.family == "vlm" else seq, cfg.d_model)


def main(argv=None) -> dict:
    """Train; returns the steps done, the start step, each logged step's
    loss (step -> float), retries, straggler steps, the final TrainState
    (in a run that started its ranks itself: none) and the wall seconds.
    Every family trains; vlm and audio batches carry a frontend drawn as
    the JAX package's launcher draws it: (frontend_tokens, d_model) image
    tokens for vlm, (seq, d_model) frames for audio."""
    args = parse_args(argv)
    dims, axes = check_mesh(args.mesh)
    if dist.is_initialized():
        return _train(args, dims, axes)
    if "RANK" in os.environ:            # torchrun: each process a rank
        lmesh.init_process_group(device=args.device)
        try:
            return _train(args, dims, axes)
        finally:
            lmesh.destroy_process_group()
    if math.prod(dims) > 1:
        return _spawn(argv, math.prod(dims), args.device)
    return _train(args, None, None)


def _rank_main(rank: int, argv, out: str) -> None:
    result = main(argv)
    if rank == 0:
        torch.save({k: v for k, v in result.items() if k != "state"}, out)


def _spawn(argv, world: int, device) -> dict:
    """Run main(argv) on ``world`` ranks started here; rank 0's result."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        lmesh.spawn(_rank_main, world, (argv, out),
                    init_method=f"file://{os.path.join(tmp, 'rendezvous')}", device=device)
        result = torch.load(out, weights_only=False)
    return {**result, "state": None}


def _train(args, dims, axes) -> dict:
    """The training loop: on the mesh (dims, axes) of the process group, or
    on one device when dims is None."""
    dev = resolve_device(args.device)
    cfg = _config(args)
    mesh = None if dims is None else lmesh.make_mesh(dims, axes, device=dev)
    model = Model(cfg, device=dev, moe_capacity=2.0, trainable=True, remat=True, mesh=mesh)
    fs = frontend_shape(cfg, args.seq)
    rank0 = dims is None or dist.get_rank() == 0
    if dims is None:
        step_fn, state_shard = make_train_step(model, args.microbatches), None
    else:
        make, state_shard = jit_train_step(model, mesh, args.microbatches)
        shapes = {"tokens": (args.batch, args.seq), "targets": (args.batch, args.seq)}
        if fs is not None:
            shapes["frontend"] = (args.batch, *fs)
        step_fn = make(shapes)

    mgr = CheckpointManager(args.ckpt_dir)

    def save(step: int, state) -> None:
        whole = convert.train_state_whole(model, state) if dims is not None else state
        if rank0:
            mgr.save_async(step, whole)

    def settle() -> None:
        """Rank 0's writes done, and every rank past them."""
        mgr.wait()
        if dims is not None:
            dist.barrier()

    state = init_state(model, torch.Generator(device=dev).manual_seed(args.seed))
    # what a checkpoint holds: every leaf whole
    like = state if dims is None else whole_like(model, state)
    start = mgr.latest_step()
    if start is not None:
        state, start = mgr.restore(like, device=dev, shardings=state_shard)
        if rank0:
            print(f"[resume] from step {start}")
    else:
        start = 0

    data = SyntheticLM(args.seed, args.batch, args.seq, cfg.vocab_size, fs,
                       start_step=start, device=dev)
    holder = {"state": state}
    losses: dict[int, float] = {}

    def step_once(i):
        batch = next(data)
        holder["state"], metrics = step_fn(holder["state"], batch)
        s = start + i
        if s % args.log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            losses[s] = m["loss"]
            if rank0:
                print(f"step {s:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
                      f"lr {m['lr']:.2e}", flush=True)
        if s and s % args.ckpt_every == 0:
            save(s, holder["state"])

    def restore_fn():
        settle()
        st = mgr.latest_step() or 0
        if mgr.latest_step() is not None:
            holder["state"], st = mgr.restore(like, device=dev, shardings=state_shard)
        return max(0, st - start)

    t0 = time.time()
    try:
        done, retries, stragglers = ft.run_with_retries(
            step_once, args.steps, restore_fn, step_timeout_s=1800.0,
            on_straggler=lambda i, dt: print(f"[straggler] step {i} took {dt:.2f}s"))
        save(start + done, holder["state"])
        settle()
    finally:
        data.close()
    dt = time.time() - t0
    if rank0:
        print(f"trained {done} steps in {dt:.1f}s "
              f"({args.batch * args.seq * done / dt:.0f} tok/s); "
              f"retries={retries} straggler_steps={stragglers}")
    return {"done": done, "start": start, "losses": losses, "retries": retries,
            "stragglers": stragglers, "state": holder["state"], "wall_s": dt}


def whole_like(model, state) -> TrainState:
    """A TrainState of meta tensors shaped as ``state`` with every params, m
    and v leaf whole (Model.param_shapes) and float32: what a checkpoint of
    a model's state holds, whatever shard this rank trains."""
    shapes = model.param_shapes()

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [meta(v) for v in tree]
        return torch.empty(tree.shape, dtype=torch.float32, device="meta")
    return TrainState(params=meta(shapes),
                      opt=state.opt._replace(m=meta(shapes), v=meta(shapes)),
                      step=state.step)


if __name__ == "__main__":
    main()
