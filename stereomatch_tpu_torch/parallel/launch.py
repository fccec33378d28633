"""Spawned CPU process groups: one function on every rank of a new world.

    out = spawn(fn, 4, *args)   # 4 CPU processes over gloo

Starts `world_size` processes with the `spawn` start method (nothing of the
parent's threads is inherited), joins them into one gloo process group
through a file store in a temporary directory, runs `fn(*args)` on each
with torch at one thread, and returns what rank 0 returned. `fn` must be a
module-level function (it is pickled by its import path) and return a dict
of tensors (saved with `torch.save`, loaded with `weights_only=True`). A
collective that waits past COLLECTIVE_TIMEOUT raises, and past `timeout`
the whole world is killed. This is how the tests run a mesh on the CPU; on
cards, torchrun starts the ranks and `multihost.distributed_init` joins
them.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn"]

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _rank_main(rank: int, world_size: int, tmp: str, fn, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                            rank=rank, world_size=world_size, timeout=COLLECTIVE_TIMEOUT)
    try:
        out = fn(*args)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *args, timeout: float = 300.0) -> dict:
    """Run fn(*args) on `world_size` new CPU processes in one gloo group and
    return rank 0's result. A rank's exception is raised here
    (`torch.multiprocessing.ProcessRaisedException`) after the other ranks
    are stopped; past `timeout` seconds every rank is killed and
    TimeoutError raised."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(world_size, tmp, fn, args), nprocs=world_size,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=True)
