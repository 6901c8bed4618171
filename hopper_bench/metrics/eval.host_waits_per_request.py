"""eval.host_waits_per_request (waits): the program's `os2d.wait.*` spans in
the traced window, per request. Each marks one point where the host waits
for the card to drain (an NMS fixpoint sweep, a host constant's blocking
copy, the image upload, the read-back of the detections)."""

from hopper_bench.harness.spans import has_spans, spans


def read(ctx):
    if not has_spans(ctx.trace) or not ctx.trace.device or not ctx.requests:
        return None
    return len(spans(ctx.trace, prefix="os2d.wait.")) / ctx.requests
