"""eval.coae_attention_ms_per_img (ms): device time of the kernels, copies and
sets launched inside the program's spans `os2d.coae.attention` (co-
attention and co-excitation: the scene terms once per image batch, the
pairs' terms, W, Q and the gate once per class chunk), per image of the
traced window."""

from hopper_bench.harness.spans import launched_in, span_union
from hopper_bench.harness.trace import union_length


def read(ctx):
    union = span_union(ctx.trace, "os2d.coae.attention")
    events = launched_in(ctx.trace, union)
    if not events or not ctx.images:
        return None
    return union_length([(s, e) for s, e, _, _ in events]) * 1e-3 / ctx.images
