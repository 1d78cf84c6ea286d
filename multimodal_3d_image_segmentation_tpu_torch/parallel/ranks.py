"""Run a function on the ranks of a gloo process group.

``run_ranks(fn, world, workdir, *args)`` starts ``world`` processes
(``torch.multiprocessing``, spawned), joins them to one gloo process group
through a ``FileStore`` in ``workdir``, pins each to one thread, calls
``fn(*args)`` on every rank and returns each rank's result. ``fn`` must be
importable by name (a module-level function) and its arguments and result
picklable; the spawned processes inherit ``sys.path``. The tests run the
sharded conv and the sharded V-Net-DS this way on the CPU;
``chip_smoke.py`` runs its ranks on one card this way.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any, Callable, List

import torch
import torch.distributed as dist

__all__ = ["run_ranks"]


def _rank_main(rank: int, fn: Callable, world: int, workdir: str,
               args: tuple, backend: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        out = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, workdir, *args,
              backend: str = "gloo") -> List[Any]:
    """``fn(*args)`` on each of ``world`` spawned ranks (module docstring);
    a rank that raises makes this raise."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for r in range(world):
        (workdir / f"rank{r}.pkl").unlink(missing_ok=True)
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, str(workdir), args, backend),
        nprocs=world, join=True, start_method="spawn")
    out = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
