"""eval.mfu (%): the model FLOPs of the traced window's images (every
pyramid level, the classes asked for, no padding; counts/flops.py) over the
window's time, against the card's peak of the configuration's compute
dtype (counts/flops.py: compute_peak_flops)."""

from hopper_bench.counts.flops import compute_peak_flops, eval_flops_per_image


def read(ctx):
    if not ctx.trace.device:
        return None
    flops = eval_flops_per_image(ctx.config, ctx.traffic) * ctx.images
    return 100.0 * flops / (ctx.trace.window_s * compute_peak_flops(ctx.config))
