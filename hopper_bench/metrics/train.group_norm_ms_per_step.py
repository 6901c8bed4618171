"""train.group_norm_ms_per_step (ms): the device time of the GroupNorm
kernels, forward and backward, of both backbone passes per step of the
traced window: the port's channels-last kernels or ATen's, by name
(counts/group_norm.py: KERNEL_KEYS). Inside the backbone's CUDA graphs no
host span replays, so the kernels are read by name. None where the window
ran none."""

from hopper_bench.counts.group_norm import is_group_norm_kernel
from hopper_bench.harness.trace import window_events


def read(ctx):
    events = window_events(ctx.trace, is_group_norm_kernel)
    if not events:
        return None
    lo, hi = ctx.trace.window
    return sum(min(e, hi) - max(s, lo) for s, e, _, _ in events) * 1e-3 / ctx.requests
