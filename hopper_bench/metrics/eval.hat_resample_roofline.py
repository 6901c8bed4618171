"""eval.hat_resample_roofline (%): the least time in which the card could
run the hat resample of the traced window's requests (each level's launch:
max(bytes / HBM bandwidth, operations / fp32 peak), counts/flops.py) over
the time of the hat kernel's launches in the trace. None where the window
ran no hat kernel."""

from hopper_bench.counts.flops import bound_s, feature_map, hat_bytes_ops, level_sizes
from hopper_bench.harness.trace import window_events


def read(ctx):
    events = window_events(ctx.trace, lambda name: "HatResample" in name)
    if not events:
        return None
    t, c = ctx.traffic, ctx.config
    t_int = (c["template_size"] - 2 * c["pool_border"]) ** 2
    least = 0.0
    for w, h in level_sizes(t):
        fh, fw = feature_map(h, w)
        least += bound_s(*hat_bytes_ops(t["batch"], t["classes"], fh * fw, t_int))
    least *= ctx.requests
    spent = sum(e - s for s, e, _, _ in events) * 1e-6
    return 100.0 * least / spent
