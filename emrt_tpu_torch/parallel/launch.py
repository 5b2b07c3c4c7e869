"""Run a function on N ranks, each in a process of its own, from one Python
process: what ``torchrun`` does for the CLIs, for callers that drive the
data-parallel path from inside a program (the card's smoke run, the tests).

Each rank is a ``spawn`` child of ``torch.multiprocessing`` (it imports the
module that defines the function, so keep that module free of heavy imports)
with one intra-op thread, RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE
set as torchrun sets them, and a process group over a file store in a
temporary directory (no TCP port).
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, fn, world, backend, init_method, timeout_s, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    results.put((rank, fn(rank, world, *args)))
    # not on an error: the group stays up until the failed rank's traceback is
    # written, so that the rank is reported rather than a peer that lost it
    dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), backend: str = "gloo", timeout: float = 900.0):
    """Run ``fn(rank, world, *args)`` on ``world`` ranks and return their
    results in rank order. ``fn`` is a module-level function; its arguments
    and result cross processes by pickle (numpy arrays and Python values, not
    tensors). Raises with the rank's traceback as soon as one rank fails or
    dies, or once ``timeout`` seconds have passed; every child is stopped
    before this returns or raises."""
    results = mp.get_context("spawn").SimpleQueue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="emrt_ranks_") as store:
        ranks = mp.start_processes(
            _rank_main, (fn, world, backend, f"file://{store}/store", timeout, args, results),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            # join raises the first failed rank's traceback and stops the others;
            # the results are read as they come, as a child that writes a large
            # one waits for the reader
            while not ranks.join(timeout=1.0):
                while not results.empty():
                    out.update([results.get()])
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} did not finish "
                                       f"in {timeout:.0f} s")
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        while not results.empty():
            out.update([results.get()])
    return [out[r] for r in range(world)]
