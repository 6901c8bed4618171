"""CoAE's counts (counts/coae.py) by hand at small shapes and at the cell's,
its readers on a synthetic trace, and the reference against the port at a
tiny size, on the CPU."""

import json

import pytest
import torch

from hopper_bench.counts import coae as counts
from hopper_bench.counts.flops import PEAKS
from hopper_bench.harness.drivers import coae_eval_closed_loop as coae_driver
from hopper_bench.tests.test_hb_readers import read
from hopper_bench.tests.test_hb_span_readers import build
from hopper_bench.tests.tiny import ROOT

CONFIG = json.loads((ROOT / "hopper_bench/configs/coae-r50.json").read_text())
TRAFFIC = json.loads((ROOT / "hopper_bench/traffic/coae-eval-c16-b2.json").read_text())
SMALL = {"feature_dim": 8, "inter_channels": 4, "gate_reduction": 4, "rpn_channels": 2,
         "anchor_scales": [8], "anchor_ratios": [1.0], "pool_size": 2, "rpn_post_nms": 3,
         "layer4_blocks": 2, "layer4_width": 2}


def test_layer4_flops_by_hand():
    # a 2 x 2 map, stride 2 to 1 x 1: block 0 conv1 8->2 at 2x2 (2*8*2*4),
    # conv2 3x3 2->2 (2*2*2*9), conv3 2->8 (2*2*8), downsample 8->8
    # (2*8*8); block 1 conv1 8->2 at 1x1 (2*8*2), conv2, conv3
    assert counts.layer4_flops(SMALL, 2, 2) == (128 + 72 + 32 + 128) + (32 + 72 + 32)
    # the cell's RoI: 0.513 GFLOP
    assert counts.layer4_flops(CONFIG, 7, 7) == 512_753_664


def test_pair_flops_by_hand():
    scene, query = (3, 4), (2, 2)  # N_d 12, N_a 4
    # f and its two products (3 * 2*4*12*4), W on the query's 4 cells
    # (2*4*8*4), Q on the scene's 12 (2*4*8*12), the gate's MLP on both
    # pools (2 * 2 * (8*2 + 2*8))
    attention = 1152 + 256 + 768 + 128
    assert counts.attention_flops(SMALL, scene, query) == attention
    # the 3x3 8->2, cls 2->2, bbox 2->4, each on 12 cells
    rpn = 2 * 8 * 2 * 9 * 12 + 2 * 2 * 2 * 12 + 2 * 2 * 4 * 12
    assert counts.rpn_flops(SMALL, scene) == rpn
    # 3 RoIs of 2 x 2 through layer4 and the predictors, the query's 2 x 2
    predictors = 2 * 2048 * 4 + 2 * 4096 * 8 + 2 * 8 * 2
    roi = 3 * (496 + predictors) + 496
    assert counts.roi_head_flops(SMALL, query) == roi
    assert counts.pair_flops(SMALL, scene, query) == attention + rpn + roi


def test_the_cells_flops():
    """A hand count from the shapes: ~8.6, ~45.6 and ~154 GFLOP a pair, ~3.53
    TFLOP an image."""
    scene, query = (60, 80), (15, 15)
    assert counts.attention_flops(CONFIG, scene, query) == pytest.approx(8.6e9, rel=0.01)
    assert counts.rpn_flops(CONFIG, scene) == pytest.approx(45.6e9, rel=0.01)
    assert counts.roi_head_flops(CONFIG, query) == pytest.approx(156e9, rel=0.01)
    assert counts.eval_flops_per_image(CONFIG, TRAFFIC) == pytest.approx(3.53e12, rel=0.01)


def test_roi_align_bytes_by_hand():
    # 2 pairs of 3 RoIs, pool 2, 8 channels: outputs 2*3*2*2*8 floats, the
    # RoIs 2*3*5; the maps 2 * 4*5*8
    out, rois = 2 * 3 * 2 * 2 * 8, 2 * 3 * 5
    assert counts.roi_align_bytes(2, 3, 4, 5, 8, 2) == 4 * (out + rois + 2 * 20 * 8)
    # touched cells 10 and 30 (capped at the map's 20)
    assert counts.roi_align_bytes(2, 3, 4, 5, 8, 2, [10, 30]) == 4 * (out + rois + 30 * 8)
    # rows 0..floor(15/16)+1, columns 0..floor(31/16)+1; one past the map
    # clipped; a degenerate RoI reads at least one cell
    assert counts.touched_cells([(0, 0, 31, 15), (40, 40, 200, 200), (30, 30, 5, 5)],
                                1 / 16, 4, 5) == [2 * 3, 2 * 3, 1]


# one request of 2 images: the scene's attention terms, then a chunk's
# attention, RPN (its NMS sweep nested) and RoI head, then decode
COAE_SPANS = [("os2d.coae.attention", 100, 150), ("os2d.coae.attention", 200, 250),
              ("os2d.coae.rpn", 250, 500), ("os2d.wait.nms_sweep", 400, 410),
              ("os2d.coae.roi_head", 500, 800), ("os2d.eval.decode", 800, 900)]
COAE_KERNELS = [("kernel", 110, 1, 120, 20),  # phi_, g
                ("kernel", 210, 1, 215, 30),  # the pairs' products
                ("kernel", 260, 1, 265, 100),  # the RPN's 3x3
                ("kernel", 420, 1, 430, 40),  # NMS
                ("kernel", 510, 1, 515, 60),  # RoIAlign
                ("kernel", 600, 1, 600, 150),  # layer4
                ("kernel", 810, 1, 820, 10)]  # decode


def test_span_readers():
    tr = build(COAE_SPANS, COAE_KERNELS)
    assert read("eval.coae_attention_ms_per_img", tr) == pytest.approx(0.050 / 2)
    assert read("eval.coae_rpn_ms_per_img", tr) == pytest.approx(0.140 / 2)
    assert read("eval.coae_roi_head_ms_per_img", tr) == pytest.approx(0.210 / 2)
    assert read("eval.host_waits_per_request", tr) == pytest.approx(1.0)


def test_mfu_and_roofline():
    events = [("hb.window", 0, 1000)]
    tr = build([], [("kernel", 10, 1, 20, 100)])
    assert read("eval.roi_align_roofline", tr, CONFIG, TRAFFIC) is None
    flops = counts.eval_flops_per_image(CONFIG, TRAFFIC) * 2
    assert read("eval.coae_mfu", tr, CONFIG, TRAFFIC, images=2) == pytest.approx(
        100 * flops / (1e-3 * PEAKS["float32_flops"]))
    from hopper_bench.harness import trace

    doc = {"traceEvents": [
        {"ph": "X", "name": name, "cat": "user_annotation", "ts": s, "dur": e - s, "pid": 1,
         "tid": 1, "args": {}} for name, s, e in events] + [
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 5, "dur": 2,
         "pid": 1, "tid": 1, "args": {"correlation": 0}},
        {"ph": "X", "name": "void (anonymous namespace)::RoiAlignNhwc(float4 const*)",
         "cat": "kernel", "ts": 10, "dur": 800, "pid": 1, "tid": 7, "args": {"correlation": 0}}]}
    least = counts.roi_align_bytes(32, 300, 60, 80, 1024, 7) / PEAKS["hbm_bytes_per_s"]
    assert read("eval.roi_align_roofline", trace.from_chrome(doc), CONFIG, TRAFFIC) == \
        pytest.approx(100 * least / 800e-6)


def test_the_reference_against_the_port_at_a_tiny_size():
    """One 64 x 96 scene and one 32-px query (a 4 x 6 and a 2 x 2 map), the
    RPN's pre/post NMS at 32/8: the check's numbers within fp32 round-off."""
    config = dict(CONFIG, rpn_pre_nms=32, rpn_post_nms=8)
    traffic = dict(TRAFFIC, batch=1, image_w=96, image_h=64, classes=1, class_chunk=1,
                   class_image_size=32, top_k=4, pool_batches=1, check_requests=1)
    torch.manual_seed(0)
    driver = coae_driver.Driver(config, traffic, {}, 4000000007, "cpu")
    driver.setup()
    numbers = coae_driver.program_numbers(driver)
    assert numbers["proposal_score_gap"] < 1e-5 and numbers["score_gap"] < 1e-5, numbers
    assert numbers["proposal_box_gap_px"] < 5e-3 and numbers["box_gap_px"] < 5e-3, numbers
    band = 2 * coae_driver.IOU_BAND  # a kept box may lie within the band under the threshold
    assert numbers["proposal_iou_excess"] <= band and numbers["iou_excess"] <= band, numbers
