"""The readers of the program's own spans (`os2d.*`) and their helpers
(harness/spans.py) on small synthetic traces whose answers are worked out
by hand."""

import pytest

from hopper_bench.harness import spans, spec, trace
from hopper_bench.harness.runner import ReaderContext
from hopper_bench.tests.test_hb_readers import EVAL_TRAFFIC, TRAIN_TRAFFIC, V2, chrome, x

NEW = ("eval.pyramid_ms_per_img", "eval.decode_ms_per_img", "eval.head_idle_ms_per_img",
       "eval.host_waits_per_request", "train.backward_ms_per_step",
       "train.backward_idle_ms_per_step", "train.forward_idle_ms_per_step")


def build(spans_, kernels, threads=()):
    """A window of 1000 us on thread 1. spans_: (name, start, end) on thread
    1; threads: (name, start, end, tid) host events on other threads;
    kernels: (category, launch time, launching thread, start, duration)."""
    events = [x("hb.window", "user_annotation", 0, 1000)]
    events += [x(n, "user_annotation", s, e - s) for n, s, e in spans_]
    events += [x(n, "cpu_op", s, e - s, tid=t) for n, s, e, t in threads]
    for corr, (cat, launch, tid, start, dur) in enumerate(kernels):
        events.append(x("cudaLaunchKernel", "cuda_runtime", launch, 2, tid=tid, correlation=corr))
        events.append(x(f"k{corr}", cat, start, dur, tid=7, correlation=corr))
    return trace.from_chrome({"traceEvents": events})


# one eval request: the pyramid (an upload, a constant), the backbone, a
# head span holding a nested head span of the same name and a second chunk,
# decode with NMS and two sweeps, the read-back
EVAL_SPANS = [("os2d.eval.pyramid", 0, 100), ("os2d.wait.upload", 10, 30),
              ("os2d.wait.constant", 40, 45), ("os2d.backbone", 100, 300),
              ("os2d.head", 300, 400), ("os2d.head", 350, 380), ("os2d.head", 400, 500),
              ("os2d.eval.decode", 500, 700), ("os2d.nms", 550, 690),
              ("os2d.wait.nms_sweep", 600, 610), ("os2d.wait.nms_sweep", 620, 630),
              ("os2d.wait.unpack", 700, 720)]
EVAL_KERNELS = [("gpu_memcpy", 20, 1, 25, 10),  # the upload
                ("kernel", 50, 1, 60, 30),  # a resize
                ("kernel", 150, 1, 160, 100),  # backbone
                ("kernel", 290, 1, 295, 20),  # backbone, queued before the head, runs into it
                ("kernel", 310, 1, 315, 20),  # head
                ("kernel", 360, 1, 370, 50),  # head, the nested span
                ("kernel", 450, 1, 480, 10),  # head, second chunk
                ("kernel", 560, 1, 565, 35),  # NMS
                ("kernel", 640, 1, 650, 10),  # pack
                ("gpu_memcpy", 705, 1, 706, 6)]  # read-back

# one training step: forward (backbone and head inside), then the backward
# span on thread 1 while thread 2 launches; a forward kernel queued before
# the backward runs into it
TRAIN_SPANS = [("os2d.train.forward", 0, 300), ("os2d.backbone", 10, 200),
               ("os2d.head", 200, 290), ("os2d.train.backward", 300, 700),
               ("os2d.wait.step_metrics", 700, 720), ("os2d.train.optimizer", 720, 800)]
TRAIN_THREADS = [("autograd::engine::evaluate_function", 310, 690, 2)]
TRAIN_KERNELS = [("kernel", 20, 1, 30, 120),
                 ("kernel", 280, 1, 290, 90),
                 ("kernel", 400, 2, 420, 100),
                 ("kernel", 600, 2, 610, 40),
                 ("kernel", 730, 1, 735, 25)]


def read(metric, tr, traffic=EVAL_TRAFFIC, requests=1, images=2):
    return spec.load_reader(metric)(ReaderContext(tr, V2, traffic, requests, images))


def test_nested_spans_of_one_name_count_once():
    tr = build(EVAL_SPANS, EVAL_KERNELS)
    assert spans.span_union(tr, "os2d.head") == [(300, 500)]
    assert len(spans.spans(tr, "os2d.head")) == 3
    # the head's 200 us less the busy 300-315 (a backbone kernel queued
    # before it), 315-335, 370-420 and 480-490
    assert spans.busy_within_us(tr, [(300, 500)]) == 95
    assert spans.idle_us(tr, [(300, 500)]) == 105


def test_eval_readers():
    tr = build(EVAL_SPANS, EVAL_KERNELS)
    # the upload's 10 us and the resize's 30 us over 2 images
    assert read("eval.pyramid_ms_per_img", tr) == pytest.approx(0.040 / 2)
    # NMS 35 us and the pack 10 us
    assert read("eval.decode_ms_per_img", tr) == pytest.approx(0.045 / 2)
    assert read("eval.head_idle_ms_per_img", tr) == pytest.approx(0.105 / 2)
    # upload, constant, two sweeps, read-back
    assert read("eval.host_waits_per_request", tr) == pytest.approx(5.0)
    assert read("eval.host_waits_per_request", tr, requests=2) == pytest.approx(2.5)
    # the existing range readers are untouched by the program's spans
    assert read("eval.head_ms_per_img", tr) is None


def test_backward_launched_from_another_thread():
    tr = build(TRAIN_SPANS, TRAIN_KERNELS, TRAIN_THREADS)
    union = spans.span_union(tr, "os2d.train.backward")
    assert union == [(300, 700)]
    assert spans.span_union(tr, "os2d.train.backward", threads="window") == union
    # the two launches of thread 2, not the forward's kernel running inside
    launched = spans.launched_in(tr, union)
    assert [ev[2] for ev in launched] == ["k2", "k3"]
    assert read("train.backward_ms_per_step", tr, TRAIN_TRAFFIC, requests=2) == \
        pytest.approx(0.140 / 2)
    # 400 us less the forward kernel's 80 inside it and the backward's 140
    assert read("train.backward_idle_ms_per_step", tr, TRAIN_TRAFFIC, requests=2) == \
        pytest.approx(0.180 / 2)
    # 300 us less 30-150 and 290-300
    assert read("train.forward_idle_ms_per_step", tr, TRAIN_TRAFFIC, requests=2) == \
        pytest.approx(0.170 / 2)


def test_spans_are_clipped_to_the_window_and_read_by_thread():
    tr = build([("os2d.head", 900, 1200)], [("kernel", 950, 1, 960, 10)],
               [("os2d.head", 100, 200, 3)])
    assert spans.span_union(tr, "os2d.head") == [(100, 200), (900, 1000)]
    assert spans.span_union(tr, "os2d.head", threads="window") == [(900, 1000)]
    assert spans.idle_us(tr, [(900, 1000)]) == 90


def test_a_window_without_program_spans_reads_nothing():
    tr = chrome([("sm90_xmma_fprop_implicit_gemm", 150, 160, 100),
                 ("ampere_sgemm_128x64", 500, 520, 100)])
    assert not spans.has_spans(tr)
    for metric in NEW:
        assert read(metric, tr) is None, metric
        assert read(metric, tr, TRAIN_TRAFFIC) is None, metric


def test_spans_without_device_events_read_nothing():
    tr = build(EVAL_SPANS + TRAIN_SPANS, [])
    for metric in NEW:
        assert read(metric, tr) is None, metric


def test_each_new_metric_is_in_the_benchmark_with_its_cell():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in NEW:
        cell = "os2d-v2-r50.eval-c16-b2" if metric.startswith("eval.") else \
            "os2d-v1-r101.train-b4"
        assert entries[metric]["workloads"] == [cell]
        assert callable(spec.load_reader(metric))
