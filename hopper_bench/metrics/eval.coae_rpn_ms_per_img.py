"""eval.coae_rpn_ms_per_img (ms): device time of the kernels, copies and sets
launched inside the program's spans `os2d.coae.rpn` (the RPN: its
convolutions, the decode, the top-6000 sort and its NMS), per image of the
traced window."""

from hopper_bench.harness.spans import launched_in, span_union
from hopper_bench.harness.trace import union_length


def read(ctx):
    union = span_union(ctx.trace, "os2d.coae.rpn")
    events = launched_in(ctx.trace, union)
    if not events or not ctx.images:
        return None
    return union_length([(s, e) for s, e, _, _ in events]) * 1e-3 / ctx.images
