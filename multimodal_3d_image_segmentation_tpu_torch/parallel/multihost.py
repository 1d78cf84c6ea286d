"""Process-group set-up, the port of
``multimodal_3d_image_segmentation_tpu/parallel/multihost.py``.

The JAX package starts its distributed runtime with
``jax.distributed.initialize``. Here each rank is a process started by
``torch.distributed.run`` (torchrun), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and the rendezvous address;
``initialize`` joins the default process group from them:

  * a rank runs on ``cuda:LOCAL_RANK % device_count``, or on the CPU where
    the caller asks for it (``visible_devices = 'cpu'``);
  * the backend is NCCL when every rank of the host has a card of its own,
    and gloo on the CPU or when ranks share a card (NCCL takes one rank a
    card). Rank 0 prints the choice on a line of its own;
  * a rank meant for a card that finds none raises: nothing moves to the
    CPU unasked.

A process group that is already initialized (a test's ``FileStore``
group) is used as it is.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

__all__ = ["initialize", "process_index", "choose_backend"]


def choose_backend(on_cpu: bool, local_ranks: int, device_count: int) -> str:
    """'nccl' when each of ``local_ranks`` ranks has a card of its own,
    else 'gloo'."""
    if on_cpu or local_ranks > device_count:
        return "gloo"
    return "nccl"


def _device(on_cpu: bool, local_rank: int) -> torch.device:
    if on_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank with LOCAL_RANK {local_rank} needs CUDA, which is not "
            "available; set [main] visible_devices = 'cpu' to run on the "
            "CPU")
    return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")


def initialize(visible_devices=None) -> Tuple[int, int, torch.device]:
    """Join (or reuse) the default process group; returns (rank, world
    size, this rank's device). ``visible_devices`` 'cpu' runs the ranks on
    the CPU over gloo; anything else puts them on the cards (module
    docstring)."""
    on_cpu = str(visible_devices).strip().lower() == "cpu"
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        device = _device(on_cpu, int(os.environ.get("LOCAL_RANK", rank)))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return rank, world, device
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        raise RuntimeError("no process group: start the ranks with "
                           "python -m torch.distributed.run --nproc-per-node "
                           "N ... (it sets RANK and WORLD_SIZE)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = _device(on_cpu, int(os.environ.get("LOCAL_RANK", 0)))
    count = 0 if on_cpu else torch.cuda.device_count()
    backend = choose_backend(on_cpu, local_world, count)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, rank=rank, world_size=world)
    if rank == 0:
        print(f"torch.distributed: {world} ranks, backend {backend} "
              f"({local_world} ranks on this host, {count} card(s))",
              flush=True)
    return rank, world, device


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0
