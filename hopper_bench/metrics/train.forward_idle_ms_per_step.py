"""train.forward_idle_ms_per_step (ms): the time inside the program's spans
`os2d.train.forward` (normalization, backbone, label branch, head) in which
the card ran nothing, per step of the traced window."""

from hopper_bench.harness.spans import idle_us, span_union


def read(ctx):
    union = span_union(ctx.trace, "os2d.train.forward")
    if not union or not ctx.trace.device or not ctx.requests:
        return None
    return idle_us(ctx.trace, union) * 1e-3 / ctx.requests
