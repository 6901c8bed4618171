"""Multi-process execution over torch.distributed (counterpart of
os2d_tpu/parallel)."""

from .mesh import (
    Mesh,
    all_gather_cat,
    all_gather_chunked,
    all_reduce_sum,
    all_reduce_sum_,
    gather_rows,
    init_distributed,
    local_rows,
    make_mesh,
    primary_host,
)
