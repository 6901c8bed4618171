"""The traced window: a torch.profiler trace (Chrome trace format) reduced
to what the per-layer readers and the breakdown need.

The window is the harness's range "hb.window" on the host. Device work is
every kernel, memcpy and memset event; its busy time is the union of their
intervals inside the window. A kernel belongs to a harness range
("hb.backbone", "hb.head", ...) when the host call that launched it (the
runtime event of the same correlation id) lies inside that range.
"""

from __future__ import annotations

import bisect
import heapq
import json
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
RANGE_PREFIX = "hb."

# kernel families of the device time, by substring of the kernel's name,
# the first match wins (the families of chip_smoke.py, with the port's own
# kernels first)
KERNEL_FAMILIES = (
    ("resample backward kernel", ("resample_backward",)),
    ("hat resample kernel", ("HatResample",)),
    ("int8 resample kernel", ("int8_resample",)),
    ("resample kernel", ("GatherResample",)),
    ("conv FFT", ("fft", "pointwise_mult_and_sum_complex")),
    ("conv backward (dgrad, wgrad)", ("dgrad", "wgrad")),
    ("conv implicit GEMM", ("fprop", "convolve", "implicit_gemm")),
    ("GEMM", ("gemm", "Gemm")),
    ("memcpy", ("Memcpy",)),
    ("memset", ("Memset",)),
    ("layout and copies", ("Nhwc", "Nchw", "copy")),
    ("reduce", ("reduce",)),
)
OTHER_FAMILY = "elementwise and other"
TOP = 10


def kernel_family(name: str) -> str:
    for family, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return family
    return OTHER_FAMILY


@dataclass
class Trace:
    """Times in microseconds of the trace's clock."""

    window: tuple  # (start, end)
    device: list  # (start, end, name, correlation) of device events
    ranges: dict  # range name -> [(start, end)] on the host
    launches: dict  # correlation -> host time of the runtime call
    host: list = field(default_factory=list)  # (start, end, name) on the window's thread
    other: list = field(default_factory=list)  # the same on the other host threads

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def from_chrome(doc) -> Trace:
    """Trace of a Chrome-trace dict (torch.profiler's export_chrome_trace)."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == RANGE_PREFIX + "window"
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError("the trace has no hb.window range")
    win = windows[0]
    start, end = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device, ranges, launches, host, other = [], {}, {}, [], []
    for e in events:
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATEGORIES:
            device.append((ts, ts + dur, e.get("name", ""), corr))
        elif cat in HOST_CATEGORIES:
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = ts
            if cat == "user_annotation" and e.get("name", "").startswith(RANGE_PREFIX):
                ranges.setdefault(e["name"], []).append((ts, ts + dur))
            same = e.get("tid") == win.get("tid") and e.get("pid") == win.get("pid")
            (host if same else other).append((ts, ts + dur, e.get("name", "")))
    device.sort()
    return Trace((start, end), device, ranges, launches, host, other)


def load(path) -> Trace:
    with open(path) as f:
        return from_chrome(json.load(f))


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clipped(intervals, window):
    lo, hi = window
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_us(trace: Trace) -> float:
    """Microseconds of the window in which the device ran something."""
    return union_length(clipped([(s, e) for s, e, _, _ in trace.device], trace.window))


def device_events_in(trace: Trace, range_name: str):
    """The device events launched from inside the host ranges `range_name`
    (and inside the window)."""
    spans = sorted(clipped(trace.ranges.get(range_name, []), trace.window))
    starts = [s for s, _ in spans]
    out = []
    for ev in trace.device:
        t = trace.launches.get(ev[3])
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            out.append(ev)
    return out


def window_events(trace: Trace, name_filter=None):
    """Device events that overlap the window, optionally filtered by name."""
    lo, hi = trace.window
    return [ev for ev in trace.device if ev[1] > lo and ev[0] < hi
            and (name_filter is None or name_filter(ev[2]))]


def family_breakdown(trace: Trace):
    """[[family, seconds]] of the window's device time, largest first."""
    sums = {}
    for s, e, name, _ in window_events(trace):
        s, e = max(s, trace.window[0]), min(e, trace.window[1])
        fam = kernel_family(name)
        sums[fam] = sums.get(fam, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])][:TOP]


class _Innermost:
    """The innermost of nested (start, end, name) events in progress at
    increasing times: the one that started last among those not ended."""

    def __init__(self, events):
        self.events, self.heap, self.next = sorted(events), [], 0

    def at(self, t):
        while self.next < len(self.events) and self.events[self.next][0] <= t:
            s, e, name = self.events[self.next]
            heapq.heappush(self.heap, (-s, e, name))
            self.next += 1
        while self.heap and self.heap[0][1] < t:
            heapq.heappop(self.heap)
        return self.heap[0][2] if self.heap else None


def idle_gaps(trace: Trace):
    """[[host activity, seconds]] of the window's idle device time, by the
    innermost host event of the window's thread in progress at the middle
    of each gap, after the harness range it lies in; where that thread is
    in no op of its own (it waits, as for the autograd thread's backward),
    by the innermost event of the other host threads, marked "(other
    thread)". Largest first."""
    lo, hi = trace.window
    busy = sorted(clipped([(s, e) for s, e, _, _ in trace.device], trace.window))
    gaps, cursor = [], lo
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < hi:
        gaps.append((cursor, hi))
    host, other = _Innermost(trace.host), _Innermost(trace.other)
    ranges = _Innermost([(s, e, n) for n, spans in trace.ranges.items() for s, e in spans
                         if n != RANGE_PREFIX + "window"])
    named = {}
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        what, elsewhere, span = host.at(mid) or "host, no event", other.at(mid), ranges.at(mid)
        if what.startswith(RANGE_PREFIX) and elsewhere is not None:
            what = f"{elsewhere} (other thread)"
        if span is not None and span != what:
            what = f"{span}: {what}"
        named[what] = named.get(what, 0.0) + (g1 - g0) * 1e-6
    return [[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])][:TOP]
