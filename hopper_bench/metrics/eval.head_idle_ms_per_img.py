"""eval.head_idle_ms_per_img (ms): the time inside the program's spans
`os2d.head` in which the card ran nothing, per image of the traced window:
the head's launch-bound gaps."""

from hopper_bench.harness.spans import idle_us, span_union


def read(ctx):
    union = span_union(ctx.trace, "os2d.head")
    if not union or not ctx.trace.device or not ctx.images:
        return None
    return idle_us(ctx.trace, union) * 1e-3 / ctx.images
