"""CoAE on the card (`os2d_torch/models/coae.py`, the RoIAlign kernel
`csrc/roi_align_nhwc.cu` through `ops/roi_align.py`). Without a card every
test here skips. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_coae_card.py -q

- The RoIAlign kernel at the CoAE cell's shapes (32 pairs of 60 x 80 x 1024
  maps, 300 RoIs each, of the anchors' sizes, some across the border, some
  under a cell, some degenerate) equals its plain version run on the card
  (`roi_align_reference`, the same operations in the same order) to the
  bit, and two launches give the same bits.
- A whole CoAE request on the card (B=2 480 x 640 scenes, 4 queries of 240
  px, RPN pre/post NMS 1000/50) judged by the benchmark's check
  (`judge_requests`) against the plain reference run on the CPU, within the
  cell's limits (hopper_bench/limits/coae-r50.eval-c16-b2.json).
- One request at the cell's protocol launches RoIAlign once (one class
  chunk) and the frozen BatchNorm kernel 58 times: 40 for the scenes'
  backbone pass, 9 for layer4 over the RoIs and 9 over the queries' maps.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_card_scenes import Launches

from hopper_bench.harness.drivers import coae_eval_closed_loop as coae_driver

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
CELL = "coae-r50.eval-c16-b2"
PAIRS, FM_H, FM_W, CHANNELS, POST = 32, 60, 80, 1024, 300
FBN_PER_REQUEST = 40 + 9 + 9


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(17)


def cell_rois(gen, pairs=PAIRS, post=POST, image_hw=(960, 1280)):
    """[pairs * post, 5] RoIs: centres over the image, sides of the anchors'
    sizes (64-736 px) by up to a factor e^+-1, clipped as the RPN clips; a
    tenth left unclipped across the border, a tenth under a cell, a tenth
    degenerate (x2 < x1)."""
    h, w = image_hw
    n = pairs * post
    u = torch.rand(n, 6, generator=gen, device="cuda")
    cx, cy = u[:, 0] * w, u[:, 1] * h
    bw = 64 * torch.exp(u[:, 2] * 2.5) * torch.exp(u[:, 4] * 2 - 1)
    bh = 64 * torch.exp(u[:, 3] * 2.5) * torch.exp(u[:, 5] * 2 - 1)
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    clipped = torch.stack([boxes[:, 0].clamp(0, w - 1), boxes[:, 1].clamp(0, h - 1),
                           boxes[:, 2].clamp(0, w - 1), boxes[:, 3].clamp(0, h - 1)], 1)
    kind = torch.arange(n, device="cuda") % 10
    boxes = torch.where((kind == 0)[:, None], boxes, clipped)
    small = torch.stack([cx, cy, cx + u[:, 4] * 12, cy + u[:, 5] * 12], 1)
    boxes = torch.where((kind == 1)[:, None], small, boxes)
    boxes = torch.where((kind == 2)[:, None], boxes[:, [2, 3, 0, 1]], boxes)
    index = torch.arange(pairs, device="cuda").repeat_interleave(post).float()
    return torch.cat([index[:, None], boxes], 1)


def test_roi_align_kernel_matches_its_plain_version_at_the_cell_shape(cuda_gen):
    from os2d_torch.ops.roi_align import KERNEL, roi_align, roi_align_reference

    feats = torch.randn(PAIRS, FM_H, FM_W, CHANNELS, generator=cuda_gen, device="cuda")
    rois = cell_rois(cuda_gen)
    before = KERNEL.launches
    got = roi_align(feats, rois, 7, 1.0 / 16)
    again = roi_align(feats, rois, 7, 1.0 / 16)
    torch.cuda.synchronize()
    assert KERNEL.launches - before == 2
    assert tuple(got.shape) == (PAIRS * POST, 7, 7, CHANNELS)
    assert torch.equal(got, again)
    for part in torch.arange(PAIRS * POST, device="cuda").chunk(8):
        want = roi_align_reference(feats, rois[part], 7, 1.0 / 16)
        assert torch.equal(got[part], want), float((got[part] - want).abs().max())


def _small_request_traffic():
    traffic = json.loads((ROOT / "hopper_bench/traffic/coae-eval-c16-b2.json").read_text())
    traffic.update(image_w=640, image_h=480, classes=4, class_chunk=4, pool_batches=1,
                   check_requests=1, trace_requests=1)
    return traffic


def test_coae_request_matches_the_cpu(cuda_gen):
    config = json.loads((ROOT / "hopper_bench/configs/coae-r50.json").read_text())
    config.update(rpn_pre_nms=1000, rpn_post_nms=50)
    limits = json.loads((ROOT / f"hopper_bench/limits/{CELL}.json").read_text())
    driver = coae_driver.Driver(config, _small_request_traffic(), limits, 2718281829, "cuda")
    driver.setup()
    out = driver.request(0)
    assert tuple(out["proposals"].shape) == (2, 4, 50, 6)
    assert np.isfinite(out["scores"][out["valid"]]).all() and out["valid"][..., 0].all()
    state = {k: v.cpu() for k, v in driver.state.items()}
    worst = coae_driver.judge_requests({0: out}, {0: 0}, state, config, driver.traffic,
                                       driver.class_u8, driver.pool, "cpu")
    correct, checks = coae_driver.verdict(worst, limits)
    assert correct, checks


def test_coae_request_launches_its_kernels(cuda_gen, record_property):
    """One request at the cell's protocol after a warm-up (set-up runs one)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    config = json.loads((ROOT / f"hopper_bench/configs/{cell['config']}.json").read_text())
    traffic = json.loads((ROOT / f"hopper_bench/traffic/{cell['traffic']}.json").read_text())
    traffic.update(pool_batches=2)
    driver = coae_driver.Driver(config, traffic, {}, 1618033988, "cuda")
    driver.setup()
    with Launches() as launched:
        out = driver.request(0)
    record_property("launches", dict(launched))  # chip_smoke.py's kernels line
    assert launched["roi_align"] == 1
    assert launched["frozen_bn"] == FBN_PER_REQUEST
    assert out["boxes"].shape == (2, 16, traffic["top_k"], 4)
    assert np.isfinite(out["scores"][out["valid"]]).all() and out["valid"][..., 0].all()
