"""Profiling and tracing hooks: the twin of `os2d_tpu/utils/profiling.py`
on torch.profiler.

- `trace(logdir)` profiles a region (the CPU, and CUDA where a card is
  present) and writes a Chrome trace (`trace.json`, readable in Perfetto or
  chrome://tracing) into `logdir`;
- `annotate(name)` is the port's one way to open a span: a
  `record_function` of that name while a profiler records on the calling
  thread (nothing otherwise), and on a card an NVTX range of the same name
  for other CUDA tools. The port's spans, named `os2d.<layer>[.<part>]`,
  mark its layer boundaries (README, "Tooling"); `os2d.wait.<why>` spans
  mark each point where the host waits for the card to drain;
- `host_constant(values, ...)` is `torch.tensor` of host values inside an
  `os2d.wait.constant` span: on a card such a copy waits for the stream;
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


class annotate:
    """`with annotate(name):` opens the span `name` (see the module
    docstring)."""

    __slots__ = ("name", "_record", "_nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the profiler's state is thread-local: a span costs no
        # record_function where no profiler records
        self._record = None
        if torch._C._autograd._profiler_enabled():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._record is not None:
            self._record.__exit__(*exc)
        return False


def host_constant(values, dtype=None, device=None) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`: a pageable copy,
    which on a card waits for the stream to drain (span
    `os2d.wait.constant`)."""
    with annotate("os2d.wait.constant"):
        return torch.tensor(values, dtype=dtype, device=device)


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
