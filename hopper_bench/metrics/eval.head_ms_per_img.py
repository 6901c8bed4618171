"""eval.head_ms_per_img (ms): device time of the kernels launched inside
the harness's ranges around the model instance's apply_head, per image of the traced
window."""

from hopper_bench.harness.trace import device_events_in, union_length


def read(ctx):
    events = device_events_in(ctx.trace, "hb.head")
    if not events or not ctx.images:
        return None
    return union_length([(s, e) for s, e, _, _ in events]) * 1e-3 / ctx.images
