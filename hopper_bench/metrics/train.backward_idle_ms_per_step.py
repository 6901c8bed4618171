"""train.backward_idle_ms_per_step (ms): the time inside the program's spans
`os2d.train.backward` in which the card ran nothing, per step of the traced
window: the host's cost of the backward (the autograd thread's launches and
the repeatable convolution's Python backward)."""

from hopper_bench.harness.spans import idle_us, span_union


def read(ctx):
    union = span_union(ctx.trace, "os2d.train.backward")
    if not union or not ctx.trace.device or not ctx.requests:
        return None
    return idle_us(ctx.trace, union) * 1e-3 / ctx.requests
