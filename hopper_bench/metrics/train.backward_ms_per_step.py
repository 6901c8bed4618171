"""train.backward_ms_per_step (ms): device time of the kernels, copies and
sets launched inside the program's spans `os2d.train.backward`, per step of
the traced window. The span is on the step's thread, which waits there
while the autograd thread launches the backward: kernels are matched to it
by the launch's host time, on any thread."""

from hopper_bench.harness.spans import launched_in, span_union
from hopper_bench.harness.trace import union_length


def read(ctx):
    union = span_union(ctx.trace, "os2d.train.backward")
    events = launched_in(ctx.trace, union)
    if not events or not ctx.requests:
        return None
    return union_length([(s, e) for s, e, _, _ in events]) * 1e-3 / ctx.requests
