"""train.mfu (%): the forward and backward FLOPs of the traced window's
steps (the mix's real classes; counts/flops.py) over the window's time,
against the card's peak of the configuration's compute dtype
(counts/flops.py: compute_peak_flops)."""

from hopper_bench.counts.flops import compute_peak_flops, train_flops_per_step


def read(ctx):
    if not ctx.trace.device:
        return None
    flops = train_flops_per_step(ctx.config, ctx.traffic) * ctx.requests
    return 100.0 * flops / (ctx.trace.window_s * compute_peak_flops(ctx.config))
