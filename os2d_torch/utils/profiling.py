"""Profiling and tracing hooks: the twin of `os2d_tpu/utils/profiling.py`
on torch.profiler.

- `trace(logdir)` profiles a region (the CPU, and CUDA where a card is
  present) and writes a Chrome trace (`trace.json`, readable in Perfetto or
  chrome://tracing) into `logdir`;
- `annotate(name)` names a region in that trace (`record_function`) and, on
  a card, pushes an NVTX range of the same name for other CUDA tools;
- `maybe_trace_from_env()` traces its region iff OS2D_PROFILE_DIR names a
  directory: an observability hook that changes nothing of what runs;
- `StageTimer` sums wall time per named stage and synchronizes the card
  before it reads the clock, so that a stage's time includes its device work.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def maybe_trace_from_env():
    """Trace the region into $OS2D_PROFILE_DIR when it is set."""
    logdir = os.environ.get("OS2D_PROFILE_DIR", "")
    if not logdir:
        yield None
        return
    with trace(logdir) as prof:
        yield prof


class StageTimer:
    """Named stage timers; a stage's time ends after the card has finished
    the work enqueued in it (`torch.cuda.synchronize` where a card is
    present, or only on `sync_value`'s device when it is a tensor)."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if isinstance(sync_value, torch.Tensor):
            if sync_value.is_cuda:
                torch.cuda.synchronize(sync_value.device)
        elif torch.cuda.is_available():
            torch.cuda.synchronize()
        self.totals[name] = self.totals.get(name, 0.0) + (time.perf_counter() - t0)
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {name: {"total_s": self.totals[name], "count": self.counts[name],
                       "mean_s": self.totals[name] / max(self.counts[name], 1)}
                for name in self.totals}
