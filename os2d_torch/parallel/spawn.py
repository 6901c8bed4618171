"""Run a function on a group of local ranks, one process each, and return
what each rank returned.

    results = run_local_group(fn, world_size=2, args=(...,), devices=["cpu"] * 2)

Each rank is a spawned process that joins a new process group on a free
localhost port (`mesh.init_distributed`, with the backend and device asked
for: nccl for CUDA devices and gloo for the CPU unless `backend` says
otherwise), builds the mesh over all ranks and calls `fn(mesh, *args)`;
`fn` must be importable by name from the child. A rank that raises, exits
without a result or outlives `timeout_s` fails the call: every rank is then
stopped, and the rank's traceback is in the error. On a node, launch
`python -m os2d_torch.main` with torchrun instead.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_module
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence

from .mesh import DEFAULT_TIMEOUT_S


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, backend, device, timeout_s, args, results):
    import torch.distributed as dist

    from .mesh import init_distributed, make_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        device = init_distributed(backend=backend, device=device, timeout_s=timeout_s)
        try:
            results.put((rank, True, fn(make_mesh(device=device), *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def run_local_group(fn: Callable, world_size: int, args: Sequence = (),
                    devices: Optional[Sequence] = None, backend: Optional[str] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> List:
    """[fn(mesh, *args) of rank 0, of rank 1, ...]. `devices` lists each
    rank's device (default cuda:rank); `timeout_s` bounds the whole call and
    each collective."""
    devices = list(devices) if devices is not None else [f"cuda:{r}" for r in range(world_size)]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, port, backend, devices[r], timeout_s,
                               tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out, last_dead = {}, []
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_module.Empty:
                # a rank's result is flushed before it exits: one that exited
                # and whose result has not come within a grace period sent none
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead and dead == last_dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                last_dead = dead
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {world_size}-rank group did not finish in "
                                       f"{timeout_s} s; ranks without a result: "
                                       f"{sorted(set(range(world_size)) - set(out))}")
                continue
            if not ok:
                # a rank that fails breaks the others' collectives: collect
                # their errors too, so that the first cause is in the message
                errors = {rank: value}
                try:
                    while len(errors) < world_size - len(out):
                        r, ok, v = results.get(timeout=5.0)
                        if not ok:
                            errors[r] = v
                except queue_module.Empty:
                    pass
                raise RuntimeError("\n".join(f"rank {r} of {world_size} failed:\n{v}"
                                             for r, v in sorted(errors.items())))
            out[rank] = value
        for r, p in enumerate(procs):
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
    finally:
        _stop(procs)
    return [out[r] for r in range(world_size)]
