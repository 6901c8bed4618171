"""eval.coae_mfu (%): the model FLOPs of the traced window's CoAE images
(the backbone and scene terms of each image, and per (image, query) pair
the co-attention, the gate, the RPN, layer4 over the RoIs and the query,
the predictors; counts/coae.py) over the window's time, against the card's
fp32 peak (counts/flops.py: compute_peak_flops)."""

from hopper_bench.counts.coae import eval_flops_per_image
from hopper_bench.counts.flops import compute_peak_flops


def read(ctx):
    if not ctx.trace.device or not ctx.images:
        return None
    flops = eval_flops_per_image(ctx.config, ctx.traffic) * ctx.images
    return 100.0 * flops / (ctx.trace.window_s * compute_peak_flops(ctx.config))
