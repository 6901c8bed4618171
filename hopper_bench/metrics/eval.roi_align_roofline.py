"""eval.roi_align_roofline (%): the least time in which the card could run
the RoIAlign of the traced window's requests (its bytes over the HBM
bandwidth: each output written once, each pair's map read once, the cap of
counts/coae.py: roi_align_bytes, which the cell's 300 RoIs a pair reach)
over the time of the RoIAlign kernel's launches in the trace. None where
the window ran no RoIAlign kernel.

The bound counts bytes only; the kernel's time also grows with its
bilinear samples (ceil(roi / 7)^2 a bin, four corner reads each), which
the RoI sizes of the seed's proposals set. So the share moves with the
seed and judges a kernel change only beside the kernel table's fixed RoIs
(tools/bench_torch_kernels.py)."""

from hopper_bench.counts.coae import roi_align_bytes
from hopper_bench.counts.flops import bound_s, feature_map, level_sizes
from hopper_bench.harness.trace import window_events


def read(ctx):
    events = window_events(ctx.trace, lambda name: "RoiAlignNhwc" in name)
    if not events:
        return None
    c, t = ctx.config, ctx.traffic
    least = 0.0
    for w, h in level_sizes(t):
        fh, fw = feature_map(h, w)
        least += bound_s(roi_align_bytes(t["batch"] * t["classes"], c["rpn_post_nms"], fh, fw,
                                         c["feature_dim"], c["pool_size"]), 0)
    spent = sum(e - s for s, e, _, _ in events) * 1e-6
    return 100.0 * least * ctx.requests / spent
