"""train.resample_backward_roofline (%): the least time in which the card
could run the resample's backward of the traced window's steps (one launch
a step at the padded class count: max(bytes / HBM bandwidth, operations /
fp32 peak), counts/flops.py) over the time of its three kernels (scatter,
dcorr, transpose) in the trace. None where the window ran none."""

from hopper_bench.counts.flops import backward_bytes_ops, bound_s, feature_map
from hopper_bench.harness.trace import window_events


def read(ctx):
    events = window_events(ctx.trace, lambda name: "resample_backward" in name)
    if not events:
        return None
    t, c = ctx.traffic, ctx.config
    m = t["class_pad_multiple"]
    c_pad = max(m, -(-t["classes"] // m) * m)
    fh, fw = feature_map(t["patch"], t["patch"])
    n = c["template_size"]
    t_int = (n - 2 * c["pool_border"]) ** 2
    least = bound_s(*backward_bytes_ops(t["batch"], c_pad, fh * fw, t_int, n * n)) * ctx.requests
    spent = sum(e - s for s, e, _, _ in events) * 1e-6
    return 100.0 * least / spent
