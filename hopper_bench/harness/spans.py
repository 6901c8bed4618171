"""The program's own spans in the traced window: `os2d.<layer>[.<part>]`
ranges that the port opens itself (`os2d_torch/utils/profiling.py:
annotate`), on the profiler's clock, the one the device events are on.

`Trace.ranges` keeps only the harness's `hb.` ranges; these helpers read
the host events of every thread (`Trace.host` and `Trace.other`).

- `span_union`: the union of a span name's intervals, clipped to the window;
- `launched_in`: the device events launched inside such a union, matched
  to the launch's host time (on any thread, so that the autograd thread's
  launches during `os2d.train.backward` count) by correlation id;
- `idle_us`: the time of such a union in which the device ran nothing, the
  union less the device's busy union within it (a device event queued
  before the span and running inside it counts as busy).
"""

from __future__ import annotations

import bisect

from .trace import Trace, clipped

PREFIX = "os2d."


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def spans(trace: Trace, name: str = None, prefix: str = None, threads: str = "all"):
    """(start, end) of the window's spans named `name` (or every span whose
    name starts with `prefix`), on the window's thread ("window") or on any
    thread ("all"), clipped to the window; nested spans stay apart."""
    events = trace.host if threads == "window" else trace.host + trace.other
    hit = [(s, e) for s, e, n in events
           if (n == name if name is not None else n.startswith(prefix))]
    return clipped(hit, trace.window)


def has_spans(trace: Trace) -> bool:
    """Whether the window holds any span of the program."""
    return bool(spans(trace, prefix=PREFIX))


def span_union(trace: Trace, name: str, threads: str = "all"):
    """The union of the intervals of spans named `name`, clipped to the
    window, as sorted disjoint (start, end)."""
    return _merged(spans(trace, name, threads=threads))


def launched_in(trace: Trace, union):
    """The device events whose launch (the runtime call of the same
    correlation id, on any host thread) lies inside `union` (sorted
    disjoint intervals)."""
    starts = [s for s, _ in union]
    out = []
    for ev in trace.device:
        t = trace.launches.get(ev[3])
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= union[i][1]:
            out.append(ev)
    return out


def busy_within_us(trace: Trace, union) -> float:
    """Microseconds of `union` in which the device ran something, whatever
    launched it."""
    busy = _merged([(s, e) for s, e, _, _ in trace.device])
    total, j = 0.0, 0
    for s, e in union:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            total += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return total


def idle_us(trace: Trace, union) -> float:
    """Microseconds of `union` in which the device ran nothing."""
    return sum(e - s for s, e in union) - busy_within_us(trace, union)
