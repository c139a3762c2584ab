"""Meshes and process groups on torch.distributed. Functions, not module
constants: importing this module starts no process group.

A run of D ranks starts under ``torchrun --nproc-per-node D`` (rank and
world size from its environment) or through ``spawn``, which starts the D
ranks itself. Every rank calls ``init_process_group`` before it builds a
mesh; the group rendezvous at an explicit ``tcp://127.0.0.1:<port>`` or
``file://<path>`` address, never by host name. The card's group is NCCL,
the CPU's gloo. A card runs one rank: NCCL refuses two ranks on one GPU,
so a machine with one card shows a mesh of one device.
"""
from __future__ import annotations

import math
import os
import socket

import torch

from repro_torch.device import resolve_device

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(init_method: str | None = None, rank: int | None = None,
                       world_size: int | None = None, device=None) -> torch.device:
    """Join the default process group: NCCL on the card (device None or
    cuda, each rank on the card of its LOCAL_RANK), gloo on the CPU
    (device="cpu"). ``rank`` and ``world_size`` default to torchrun's
    RANK and WORLD_SIZE, and a single process is rank 0 of 1;
    ``init_method`` defaults to tcp://127.0.0.1:MASTER_PORT under torchrun,
    else a free port (world size 1 only: other ranks could not find it).
    Returns this rank's device."""
    import torch.distributed as dist
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if init_method is None:
        if "MASTER_PORT" in env:
            init_method = f"tcp://127.0.0.1:{env['MASTER_PORT']}"
        elif world_size == 1:
            init_method = f"tcp://127.0.0.1:{free_port()}"
        else:
            raise ValueError("init_process_group: a group of more than one rank needs an "
                             "init_method (tcp://127.0.0.1:<port> or file://<path>) or "
                             "torchrun's MASTER_PORT")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local if device is None else dev.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    return dev


def destroy_process_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn, world_size: int, init_method: str, device, args) -> None:
    torch.set_num_threads(1)
    init_process_group(init_method, rank, world_size, device)
    try:
        fn(rank, *args)
    finally:
        destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), init_method: str | None = None,
          device=None) -> None:
    """Run fn(rank, *args) in ``world_size`` new processes (spawn), each a
    rank of a fresh default group (init_process_group with ``device``; one
    torch thread a rank), and wait for all of them; a rank that fails makes
    this raise. fn must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp
    if init_method is None:
        init_method = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(_rank_main, args=(fn, world_size, init_method, device, args),
                       nprocs=world_size, start_method="spawn")


def make_mesh(shape: tuple, axes: tuple, device=None):
    """A DeviceMesh of ``shape`` with dims named ``axes`` over the ranks of
    the default group, row-major, on the card unless ``device`` says "cpu".
    Raises when the group's world size is not the product of the shape. A
    "cpu" mesh's sub-groups are gloo's, whose all_reduce also takes CUDA
    tensors (staged through the host): several ranks sharing one card,
    which NCCL refuses, can run the tensor-parallel layers that way."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(d) for d in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"make_mesh: a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the process group has {world}")
    return DeviceMesh(resolve_device(device).type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False, device=None):
    """The production mesh: 16x16 ("data", "model"), or 2x16x16 ("pod",
    "data", "model") with ``multi_pod``."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device)
    return make_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device)
