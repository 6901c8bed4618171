"""train.device_idle (%): the share of the traced training window in which no
kernel, memcpy or memset ran on the card."""

from hopper_bench.harness.trace import busy_us


def read(ctx):
    if not ctx.trace.device:
        return None
    window = ctx.trace.window[1] - ctx.trace.window[0]
    return 100.0 * (1.0 - busy_us(ctx.trace) / window)
