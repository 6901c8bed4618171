"""Process mesh and sharding strategy over torch.distributed.

Counterpart of `os2d_tpu/parallel/mesh.py`. The JAX package scales through
jax.sharding: one program over a device mesh, with XLA inserting the
collectives. Here each rank is one process that drives one device, and the
collectives are explicit:

  - TRAINING: data parallelism. Every rank holds the same global batch (the
    train loaders are seeded alike) and runs the backbone and the head on its
    own contiguous rows; the head's outputs are gathered so that targets and
    the objective are computed on the global batch, identically on every
    rank; the gradients are summed over the ranks (engine/train.py).
  - EVAL: the class axis (each rank scores its slice of every class chunk,
    and the per-class outputs are gathered before the decode) or the image
    axis (each rank detects its rows of the batch, and the packed detections
    are gathered) (engine/evaluate.py).

Only `all_reduce`, `broadcast` and `all_gather` into a list are used: gloo
supports them on CUDA tensors too, so two ranks may share one card over
gloo, and the code path is the same under nccl.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group along the data axis. `group` is None
    for the default (world) group; `device` is this rank's device."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def barrier(self) -> None:
        """Wait for every rank (an all_reduce, which every backend supports
        on the rank's device)."""
        dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group that torchrun describes (main.py:107-115 for
    JAX's runtime): RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT from the environment. The device is `device` if given, else
    cuda:LOCAL_RANK; the backend is `backend` if given, else nccl for a CUDA
    device and gloo for the CPU. The group times out after `timeout_s`, so
    that a rank that died before a collective fails the others instead of
    hanging them. Returns this rank's device."""
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device(f"cuda:{local_rank}" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu' to run "
                               "the ranks on the CPU over gloo")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    # env:// reads MASTER_ADDR and MASTER_PORT, and under torchrun joins the
    # store its agent already serves on that port
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def launched_world_size() -> int:
    """The number of processes torchrun started for this job (WORLD_SIZE),
    1 for a process started on its own."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(n_devices: Optional[int] = None, device=None) -> Optional[Mesh]:
    """A mesh over the first `n_devices` ranks of the initialized group (all
    of them by default), as `os2d_tpu.parallel.make_mesh` takes the first
    n devices. Every rank must call it. A rank outside the mesh gets None
    and has no part in it (JAX leaves the other devices idle). `device` is
    this rank's device (init_distributed's result), by default the current
    CUDA device under nccl and the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_distributed)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"need {n} ranks, have {world}")
    if device is None:
        device = f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" else "cpu"
    device = torch.device(device)
    if n == world:
        return Mesh(None, dist.get_rank(), world, device)
    group = dist.new_group(ranks=list(range(n)))  # every rank takes part in new_group
    if dist.get_rank() >= n:
        return None
    return Mesh(group, dist.get_rank(group), n, device)


def primary_host() -> bool:
    """True on the process that owns host-side writes (checkpoints, logs,
    figures): rank 0, and always without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of an axis of length `n` (`put_global`'s
    slice, os2d_tpu/parallel/mesh.py:46-61: every rank holds the whole
    value, from identically seeded loaders, and works on its own rows)."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not shard over {mesh.size} ranks")
    per_rank = n // mesh.size
    return slice(mesh.rank * per_rank, (mesh.rank + 1) * per_rank)


def all_gather_cat(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` (one shape on all ranks) concatenated along `dim` in
    rank order, on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def all_gather_chunked(mesh: Mesh, x: torch.Tensor, n_chunks: int, dim: int = 1) -> torch.Tensor:
    """Inverse of sharding every chunk of an axis: `x` holds along `dim`
    this rank's slice of each of `n_chunks` chunks, back to back; returns
    the whole axis, chunk by chunk, each chunk's slices in rank order."""
    gathered = all_gather_cat(mesh, x.unsqueeze(dim), dim)  # [..., size, n_chunks*local, ...]
    shape = list(x.shape)
    local = shape[dim] // n_chunks
    split = gathered.reshape(shape[:dim] + [mesh.size, n_chunks, local] + shape[dim + 1:])
    merged = split.transpose(dim, dim + 1)  # [..., n_chunks, size, local, ...]
    return merged.reshape(shape[:dim] + [n_chunks * mesh.size * local] + shape[dim + 1:])


class _GatherRows(torch.autograd.Function):
    """all_gather_cat whose backward returns this rank's slice of the
    incoming gradient. Every rank computes the same loss from the gathered
    tensor, so each rank's slice already holds the whole gradient of its
    rows: a reduce-scatter (torch.distributed.nn's all_gather) would count
    it once per rank."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.rows = mesh, dim, x.shape[dim]
        return all_gather_cat(mesh, x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.mesh.rank * ctx.rows, ctx.rows), None, None


def gather_rows(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Differentiable all_gather_cat (see _GatherRows)."""
    return _GatherRows.apply(x, mesh, dim)


class _AllReduceSum(torch.autograd.Function):
    """The sum of `x` over the ranks. Every rank uses the sum, so the
    gradient of each rank's `x` is the sum over the ranks of the incoming
    gradients: the backward is the same all_reduce (SyncBatchNorm's rule)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.mesh.group)
        return grad, None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks (see _AllReduceSum): the
    pretrainer's global BatchNorm statistics."""
    return _AllReduceSum.apply(x, mesh)


def all_reduce_sum_(mesh: Mesh, tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, in one collective per dtype.
    Every rank ends with the same bits."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        for t, f in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(f.view_as(t))
