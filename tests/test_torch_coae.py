"""CoAE on the port (`os2d_torch/models/coae.py`) through
`Evaluator.detect_images`, on the CPU, against the plain reference
`hopper_bench/reference/coae.py`, on the benchmark's seeded weights
(`hopper_bench/harness/coae_weights.py`) at a small size: two 96 x 128
scenes, two queries of 48 px (6 x 8 and 3 x 3 maps, four pairs), the RPN's
pre/post NMS at 64/16. The check is the benchmark's own
(`harness/drivers/coae_eval_closed_loop.py: judge_requests`): the
request's proposals against the reference's RPN candidates (numbers
"proposal_*"), its detections against the reference's second stage on
those proposals.

Tolerances (`TOLERANCE`), each a few hundred times what fp32 round-off
gives here and far under what a fault gives: scores are probabilities in
[0, 1] that the port and the reference compute with the same operations in
other batchings (convolutions of a pair batch, batched matrix products),
which moves them by ~1e-7; boxes are clipped pixels decoded from such
numbers (~1e-5 px); rank gaps of an exact greedy NMS are score gaps; the
check judges at the NMS threshold less its band (IOU_BAND, 1e-3), so an
exact greedy NMS reads an IoU excess of up to the band (8.8e-4 here), and
its tolerance is twice the band.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hopper_bench.harness.drivers import coae_eval_closed_loop as coae_driver

ROOT = Path(__file__).resolve().parents[1]
TOLERANCE = {"score_gap": 1e-5, "box_gap_px": 5e-3, "rank_gap": 1e-5, "iou_excess": 2e-3}
SEED = 3141592653


def _config():
    config = json.loads((ROOT / "hopper_bench/configs/coae-r50.json").read_text())
    config.update(rpn_pre_nms=64, rpn_post_nms=16)
    return config


def _traffic():
    traffic = json.loads((ROOT / "hopper_bench/traffic/coae-eval-c16-b2.json").read_text())
    traffic.update(image_w=128, image_h=96, classes=2, class_chunk=2, class_image_size=48,
                   top_k=8, pool_batches=1, check_requests=1, trace_requests=1)
    return traffic


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the check runs thousands of small operations,
    each of which, beside the other test workers, waits for every thread of
    the pool to be scheduled (383 s on 8 threads in a 6-worker run, ~20 s
    on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def driver(one_thread):
    torch.manual_seed(0)
    d = coae_driver.Driver(_config(), _traffic(), {}, SEED, "cpu")
    d.setup()
    return d


def _numbers(driver):
    outputs = {0: driver.request(0)}
    return coae_driver.judge_requests(outputs, {0: 0}, driver.state, driver.config,
                                      driver.traffic, driver.class_u8, driver.pool, "cpu")


def _over(numbers):
    """The numbers above their tolerance, by name ("proposal_x" holds to x's)."""
    return {k: v for k, v in numbers.items() if v > TOLERANCE[k.replace("proposal_", "")]}


def test_detect_images_matches_the_reference(driver):
    from os2d_torch.models.coae import CoaeModel

    assert isinstance(driver.evaluator.model, CoaeModel)
    out = driver.request(0)
    assert out["boxes"].shape == (2, 2, 8, 4) and out["scores"].shape == (2, 2, 8)
    # each pair keeps at least its best RoI; NMS at 0.3 on a 96 x 128 scene
    # keeps few of the 16
    assert out["valid"][..., 0].all() and np.isfinite(out["scores"][out["valid"]]).all()
    assert tuple(out["proposals"].shape) == (2, 2, 16, 6)
    numbers = _numbers(driver)
    assert set(numbers) == {p + k for p in ("", "proposal_") for k in TOLERANCE}
    assert not _over(numbers), numbers


@pytest.mark.parametrize("fault", sorted(coae_driver.MODEL_FAULTS))
def test_each_fault_fails_the_check(driver, fault):
    model = driver.model
    saved = dict(model.__dict__)
    try:
        coae_driver.MODEL_FAULTS[fault](model)
        numbers = _numbers(driver)
    finally:
        for key in set(model.__dict__) - set(saved):
            del model.__dict__[key]
        model.__dict__.update(saved)
    assert _over(numbers), (fault, numbers)


def test_base_anchors_are_py_faster_rcnns():
    from hopper_bench.reference.coae import base_anchors
    from os2d_torch.models.coae import generate_anchors

    want = [[-84, -40, 99, 55], [-176, -88, 191, 103], [-360, -184, 375, 199],
            [-56, -56, 71, 71], [-120, -120, 135, 135], [-248, -248, 263, 263],
            [-36, -80, 51, 95], [-80, -168, 95, 183], [-168, -344, 183, 359]]
    assert generate_anchors() == want
    assert base_anchors(_config()).tolist() == want


def _scalar_roi_align(feats, rois, pooled, scale):
    """torchvision's roi_align_forward_kernel_impl, one output at a time, in
    numpy float32 scalars."""
    f32 = np.float32
    n, h, w, c = feats.shape
    fm = feats.numpy()
    out = np.zeros((len(rois), pooled, pooled, c), np.float32)
    for r, (idx, x1, y1, x2, y2) in enumerate(rois.numpy()):
        sw, sh = f32(x1) * f32(scale), f32(y1) * f32(scale)
        rw = max(f32(x2) * f32(scale) - sw, f32(1))
        rh = max(f32(y2) * f32(scale) - sh, f32(1))
        bw, bh = rw / f32(pooled), rh / f32(pooled)
        gw, gh = int(np.ceil(rw / f32(pooled))), int(np.ceil(rh / f32(pooled)))
        for ph in range(pooled):
            for pw in range(pooled):
                acc = np.zeros(c, np.float32)
                for iy in range(gh):
                    y = sh + f32(ph) * bh + (f32(iy) + f32(0.5)) * bh / f32(gh)
                    for ix in range(gw):
                        x = sw + f32(pw) * bw + (f32(ix) + f32(0.5)) * bw / f32(gw)
                        if y < -1 or y > h or x < -1 or x > w:
                            continue
                        yy, xx = max(y, f32(0)), max(x, f32(0))
                        yl, xl = int(yy), int(xx)
                        if yl >= h - 1:
                            yl = yh = h - 1
                            yy = f32(yl)
                        else:
                            yh = yl + 1
                        if xl >= w - 1:
                            xl = xh = w - 1
                            xx = f32(xl)
                        else:
                            xh = xl + 1
                        ly, lx = yy - f32(yl), xx - f32(xl)
                        hy, hx = f32(1) - ly, f32(1) - lx
                        v = fm[int(idx)]
                        acc = acc + ((hy * hx) * v[yl, xl] + (hy * lx) * v[yl, xh]
                                     + (ly * hx) * v[yh, xl] + (ly * lx) * v[yh, xh])
                out[r, ph, pw] = acc / f32(max(gh * gw, 1))
    return torch.from_numpy(out)


ROIS = {  # (map index, x1, y1, x2, y2) in pixels of a 7 x 9 map at stride 16
    "inside": [[0, 20.5, 10.25, 100.0, 90.75], [1, 3.0, 40.0, 140.0, 60.0]],
    "across_the_border": [[0, -30.0, -20.0, 50.0, 40.0], [1, 100.0, 80.0, 170.0, 130.0],
                          [0, -40.0, 90.0, 20.0, 200.0]],
    "under_a_cell": [[0, 33.0, 47.0, 38.0, 50.0], [1, 143.9, 111.5, 144.0, 111.9]],
    "degenerate": [[0, 60.0, 60.0, 60.0, 60.0], [1, 80.0, 70.0, 40.0, 20.0]],
    "over_the_map": [[0, -50.0, -35.0, 190.0, 150.0], [1, -8.0, 5.0, 300.0, 120.0]],
}


@pytest.mark.parametrize("pooled", [3, 7])
@pytest.mark.parametrize("case", sorted(ROIS))
def test_plain_roi_align_equals_a_scalar_loop(case, pooled):
    from os2d_torch.ops.roi_align import roi_align

    gen = torch.Generator().manual_seed(5)
    feats = torch.randn(2, 7, 9, 8, generator=gen)
    rois = torch.tensor(ROIS[case], dtype=torch.float32)
    got = roi_align(feats, rois, pooled, 1.0 / 16)
    assert torch.equal(got, _scalar_roi_align(feats, rois, pooled, 1.0 / 16))


def test_spans_and_counters_fire_once_per_chunk(driver):
    from os2d_torch.models import coae
    from os2d_torch.ops import nms

    evaluator = copy.copy(driver.evaluator)
    evaluator.cfg = driver.evaluator.cfg.clone()
    evaluator.cfg.tpu.eval_class_chunk = 1  # two chunks of one query
    coae.counters.reset()
    sweeps = nms.fixpoint_sweeps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, extra = evaluator.detect_images(driver.pool[0], driver.bank, driver.sizes,
                                           driver.inverse, driver.norm)
    names = [e.name for e in prof.events()]
    assert names.count("os2d.coae.attention") == 1 + 2  # the scene's terms, then each chunk
    assert names.count("os2d.coae.rpn") == 2
    assert names.count("os2d.coae.roi_head") == 2
    assert names.count("os2d.backbone") == 1 and names.count("os2d.eval.decode") == 1
    assert coae.counters.pairs == 2 * 2
    assert coae.counters.proposals_kept() == int(extra["proposals"][..., 5].sum())
    assert nms.fixpoint_sweeps - sweeps == names.count("os2d.wait.nms_sweep") > 0
