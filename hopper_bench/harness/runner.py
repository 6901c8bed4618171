"""One run of one cell: set-up, the measured window (or the traced one),
the release of the program, the check against the reference, the result.
The cell's driver is the module that its traffic's "kind" names
(harness/drivers/<kind>.py; the interface is in drivers/__init__.py).
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import torch

from . import drivers
from . import trace as tr
from .spec import ROOT, Cell, load_reader

TRACE_FILE = ROOT / "build" / "hopper_bench" / "trace.json"


def make_driver(cell: Cell, seed: int, device):
    module = drivers.load(cell.traffic["kind"])
    return module.Driver(cell.config, cell.traffic, cell.limits, seed, device)


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(driver, seconds=None, count=None, ranges=False):
    """Requests one after another from driver.first on, while the window
    lasts (`seconds`) or `count` times. Returns ([(start, end, output)],
    window start, window end); the window closes when its last request
    ends."""
    records, i = [], driver.first
    start = time.perf_counter()
    while (time.perf_counter() - start < seconds) if count is None else len(records) < count:
        t0 = time.perf_counter()
        if ranges:
            with torch.profiler.record_function("hb.request"):
                out = driver.request(i)
        else:
            out = driver.request(i)
        records.append((t0, time.perf_counter(), out))
        i += 1
    return records, start, time.perf_counter()


class Spans:
    """The harness's host ranges around calls into the program's layers: a
    forward hook on model.backbone and a wrapper on the instance's
    apply_head, removed again by `remove`."""

    def __init__(self, model):
        self.model = model
        self.handles, self.open = [], []

    def install(self):
        def enter(module, args):
            rf = torch.profiler.record_function("hb.backbone")
            rf.__enter__()
            self.open.append(rf)

        self.handles.append(self.model.backbone.register_forward_pre_hook(enter))
        self.handles.append(self.model.backbone.register_forward_hook(
            lambda m, a, o: self.open.pop().__exit__(None, None, None)))
        apply_head = self.model.apply_head

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function("hb.head"):
                return apply_head(*args, **kwargs)

        self.model.apply_head = wrapped
        return self

    def remove(self):
        for h in self.handles:
            h.remove()
        self.model.__dict__.pop("apply_head", None)


@dataclass
class ReaderContext:
    """What a per-layer reader reads: the traced window and the cell."""

    trace: tr.Trace
    config: dict
    traffic: dict
    requests: int
    images: int


@dataclass
class RunResult:
    correct: bool
    attempted: int
    metrics: dict  # name -> value
    checks: dict  # name -> (value, limit)
    device: dict
    breakdown: dict = None
    setup_phases: dict = None
    request_ms: list = None


def traced_window(driver, device):
    """The traced window: (records, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    spans = Spans(driver.model).install()
    try:
        with profile(activities=activities) as prof:
            with torch.profiler.record_function("hb.window"):
                records, _, _ = closed_loop(driver, count=driver.trace_count, ranges=True)
                synchronize(device)
    finally:
        spans.remove()
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_FILE))
    return records, tr.load(TRACE_FILE)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             driver=None) -> RunResult:
    driver = driver or make_driver(cell, seed, device)
    driver.setup()
    synchronize(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        kind, count = torch.cuda.get_device_name(0), cell.chips
    else:
        kind, count = "cpu", 0
    if trace:
        records, trace_data = traced_window(driver, device)
    else:
        records, start, end = closed_loop(driver, seconds=seconds)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": count,
                   "memory_peak_bytes": int(memory_peak)}
    metrics, breakdown = {}, None
    if trace:
        ctx = ReaderContext(trace_data, driver.config, driver.traffic, len(records),
                            len(records) * driver.images_per_request)
        for m in cell.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = value
        device_info["busy_s"] = tr.busy_us(trace_data) * 1e-6
        device_info["window_s"] = trace_data.window_s
        breakdown = {"device_ops": tr.family_breakdown(trace_data),
                     "idle_gaps": tr.idle_gaps(trace_data)}
    else:
        values = driver.end_to_end(records, start, end)
        values["setup_s"] = start - t0
        metrics = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, checks = driver.check(records)
    times = sorted((t1 - t0) * 1e3 for t0, t1, _ in records)
    return RunResult(correct, len(records), metrics, checks, device_info, breakdown,
                     driver.setup_phases, [times[0], times[len(times) // 2], times[-1]])


def result_line(cell: Cell, result: RunResult) -> dict:
    """The run's last line: correct, attempted, failed, metrics, device,
    breakdown (traced runs), and last the checks, each number with its
    limit."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    line = {"correct": bool(result.correct), "attempted": result.attempted, "failed": 0,
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in result.metrics.items()},
            "device": result.device}
    if result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in result.checks.items()}
    return line
