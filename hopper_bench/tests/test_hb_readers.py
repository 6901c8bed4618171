"""Each per-layer reader, the breakdown and the idle gaps on a small
synthetic trace whose answers are worked out by hand."""

import json

import pytest

from hopper_bench.counts import flops as F
from hopper_bench.harness import spec, trace
from hopper_bench.harness.runner import ReaderContext
from hopper_bench.tests.tiny import ROOT

V2 = json.loads((ROOT / "hopper_bench/configs/os2d-v2-r50.json").read_text())
EVAL_TRAFFIC = {"batch": 2, "image_w": 32, "image_h": 32, "pyramid_scales": [1.0],
                "classes": 1}
TRAIN_TRAFFIC = {"batch": 1, "patch": 32, "classes": 3, "class_pad_multiple": 4,
                 "class_image_size": 32}


def x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def chrome(kernels):
    """A window of 1000 us; the backbone's range 100-300, the head's
    400-700; one launch and one device event per entry of `kernels`
    (name, launch time, start, duration)."""
    events = [x("hb.window", "user_annotation", 0, 1000),
              x("hb.backbone", "user_annotation", 100, 200),
              x("hb.head", "user_annotation", 400, 300),
              x("aten::item", "cpu_op", 0, 150),
              x("aten::conv2d", "cpu_op", 300, 100),
              x("autograd::engine::evaluate_function", "cpu_op", 840, 160, tid=2)]
    for corr, (name, launch, start, dur) in enumerate(kernels):
        events.append(x("cudaLaunchKernel", "cuda_runtime", launch, 5, correlation=corr))
        events.append(x(name, "kernel", start, dur, tid=7, correlation=corr))
    return trace.from_chrome({"traceEvents": events})


KERNELS = [("sm90_xmma_fprop_implicit_gemm", 150, 160, 100),
           ("void os2d::resample_tile_kernel<(anonymous namespace)::HatResample>", 450, 460, 50),
           ("ampere_sgemm_128x64", 500, 520, 100),
           ("void at::native::elementwise_kernel", 800, 810, 40)]


def read(metric, tr, config=V2, traffic=EVAL_TRAFFIC, requests=1, images=2):
    return spec.load_reader(metric)(ReaderContext(tr, config, traffic, requests, images))


def test_busy_idle_and_ranges():
    tr = chrome(KERNELS)
    assert trace.busy_us(tr) == 290
    assert read("eval.device_idle", tr) == pytest.approx(71.0)
    assert read("train.device_idle", tr) == pytest.approx(71.0)
    assert read("train.device_ms_per_step", tr, traffic=TRAIN_TRAFFIC, requests=2) == \
        pytest.approx(0.290 / 2)
    assert read("eval.backbone_ms_per_img", tr) == pytest.approx(0.100 / 2)
    assert read("eval.head_ms_per_img", tr) == pytest.approx(0.150 / 2)


def test_mfu():
    tr = chrome(KERNELS)
    flops = F.eval_flops_per_image(V2, EVAL_TRAFFIC) * 2
    assert read("eval.mfu", tr) == pytest.approx(100 * flops / (1e-3 * 67e12))
    step = F.train_flops_per_step(V2, TRAIN_TRAFFIC) * 3
    assert read("train.mfu", tr, traffic=TRAIN_TRAFFIC, requests=3) == pytest.approx(
        100 * step / (1e-3 * 67e12))


def test_mfu_takes_the_peak_of_the_compute_dtype():
    tr = chrome(KERNELS)
    bf16 = dict(V2, compute_dtype="bfloat16")
    flops = F.eval_flops_per_image(V2, EVAL_TRAFFIC) * 2
    assert read("eval.mfu", tr, config=bf16) == pytest.approx(100 * flops / (1e-3 * 989e12))
    step = F.train_flops_per_step(V2, TRAIN_TRAFFIC)
    assert read("train.mfu", tr, config=bf16, traffic=TRAIN_TRAFFIC) == pytest.approx(
        100 * step / (1e-3 * 989e12))


def test_rooflines():
    tr = chrome(KERNELS)
    least = F.bound_s(*F.hat_bytes_ops(2, 1, 4, 121))  # 32 px -> 2x2 anchors
    assert read("eval.hat_resample_roofline", tr) == pytest.approx(100 * least / 50e-6)
    assert read("train.resample_backward_roofline", tr, traffic=TRAIN_TRAFFIC) is None
    backward = [("resample_backward_scatter_kernel", 600, 610, 30),
                ("resample_backward_dcorr_kernel", 640, 650, 20)]
    tr = chrome(backward)
    least = F.bound_s(*F.backward_bytes_ops(1, 4, 4, 121, 225))
    assert read("train.resample_backward_roofline", tr, traffic=TRAIN_TRAFFIC,
                requests=2) == pytest.approx(100 * 2 * least / 50e-6)
    assert read("eval.hat_resample_roofline", tr) is None


def test_readers_without_device_events_read_nothing():
    tr = chrome([])
    for m in spec.load_benchmark()["per_layer"]:
        assert read(m["name"], tr) is None, m["name"]


def test_breakdown_and_idle_gaps():
    tr = chrome(KERNELS)
    fams = dict(trace.family_breakdown(tr))
    assert fams == pytest.approx({"conv implicit GEMM": 100e-6, "hat resample kernel": 50e-6,
                                  "GEMM": 100e-6, "elementwise and other": 40e-6})
    gaps = dict(trace.idle_gaps(tr))
    # 0-160 under aten::item; 260-460 mid 360 under aten::conv2d; 510-520 in
    # the head's range, 620-810 after it; 850-1000 while the main thread
    # waits and another thread runs the backward
    assert gaps["aten::item"] == pytest.approx(160e-6)
    assert gaps["aten::conv2d"] == pytest.approx(200e-6)
    assert gaps["hb.head"] == pytest.approx(10e-6)
    assert gaps["hb.window"] == pytest.approx(190e-6)
    assert gaps["autograd::engine::evaluate_function (other thread)"] == pytest.approx(150e-6)
    assert sum(gaps.values()) == pytest.approx(710e-6)
