"""train.device_ms_per_step (ms): the time a training step keeps the card
busy, the union of its kernel, memcpy and memset intervals over the traced
window per step. The device's share of `train_step_ms`, steady where the
host's speed is not (PERF.md, End-to-end metrics)."""

from hopper_bench.harness.trace import busy_us


def read(ctx):
    if not ctx.trace.device:
        return None
    return busy_us(ctx.trace) * 1e-3 / ctx.requests
