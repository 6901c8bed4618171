"""train.group_norm_roofline (%): the least time in which the card could
run the GroupNorm forward and backward of the traced window's steps (every
slot of both backbone passes: bytes over HBM bandwidth,
counts/group_norm.py) over the time of the GroupNorm kernels in the trace
(the port's or ATen's, by name). None where the window ran none."""

from hopper_bench.counts.flops import bound_s
from hopper_bench.counts.group_norm import is_group_norm_kernel, train_bytes_per_step
from hopper_bench.harness.trace import window_events


def read(ctx):
    events = window_events(ctx.trace, is_group_norm_kernel)
    if not events:
        return None
    least = bound_s(train_bytes_per_step(ctx.config, ctx.traffic), 0) * ctx.requests
    spent = sum(e - s for s, e, _, _ in events) * 1e-6
    return 100.0 * least / spent
