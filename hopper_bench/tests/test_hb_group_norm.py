"""The GroupNorm training cell's additions: the two readers of the
GroupNorm kernels on a small synthetic trace, the byte count of its slots
against a hand count, and a tiny run of the cell's configuration at its
recipe (loc_weight 0) on the CPU."""

import json
import time

import pytest

from hopper_bench.counts import group_norm as G
from hopper_bench.harness.runner import run_cell
from hopper_bench.tests.test_hb_readers import chrome, read
from hopper_bench.tests.test_hb_reference import TINY_GN_TRAIN_LIMITS
from hopper_bench.tests.tiny import ROOT, tiny_cell

GN_CELL = "os2d-v2-r50-gn.train-b4-v2"
GN = json.loads((ROOT / "hopper_bench/configs/os2d-v2-r50-gn.json").read_text())
SMALL = dict(GN, backbone_blocks=[1, 1, 1])  # one bottleneck a layer
TRAFFIC = {"batch": 1, "patch": 32, "classes": 3, "class_pad_multiple": 4,
           "class_image_size": 32}

# the port's kernels and ATen's, each 50 us, and two kernels of other ops
KERNELS = [("GroupNormChannelsLastStats(float const*, float*, int, int, int, int, int, int)",
            150, 160, 50),
           ("GroupNormChannelsLastGradApply(float const*, float const*, int, int, int)",
            300, 310, 50),
           ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>"
            "(long, float, float const*, float*, float*)", 400, 420, 50),
           ("void at::native::elementwise_kernel<128, 2, at::native::"
            "GroupNormKernelImplInternal<float, float>(...)::{lambda(float, float, float)#1}>",
            500, 520, 50),
           ("sm90_xmma_fprop_implicit_gemm", 600, 610, 100),
           ("void at::native::vectorized_elementwise_kernel<4, at::native::copy_kernel>",
            700, 710, 30)]


def test_slots_of_one_block_a_layer_at_32_px():
    # stem 16x16 (64 ch); after the pool 8x8: layer1 bn1-3 and downsample,
    # layer2 (bn1 at the block's input side, the rest strided), layer3 alike
    assert G.group_norm_slots(SMALL, 32, 32) == [
        (64, 16, 16), (64, 8, 8), (64, 8, 8), (256, 8, 8), (256, 8, 8),
        (128, 8, 8), (128, 4, 4), (512, 4, 4), (512, 4, 4),
        (256, 4, 4), (256, 2, 2), (1024, 2, 2), (1024, 2, 2)]
    assert len(G.group_norm_slots(GN, 600, 600)) == 43


def test_one_slot_bytes_by_hand():
    # the stem's slot of a 600-px scene pass: 4 images of 64 x 300 x 300
    size = 4 * 64 * 300 * 300
    forward = 4 * size + 4 * size + 4 * 64 * 2 + 4 * 4 * 32 * 2  # x, y, gamma/beta, mean/rstd
    backward = 3 * 4 * size + 4 * 64 * 3 + 4 * 4 * 32 * 2  # x, dy, dx; gamma, dgamma, dbeta
    assert G.slot_bytes(4, 64, 300, 300) == (forward, backward) == (184_321_536, 276_481_792)


def test_train_bytes_per_step_at_32_px():
    # one scene image of 32 px, 3 classes padded to 4 class images of 32 px
    slots = G.group_norm_slots(SMALL, 32, 32)
    # 5 passes of each activation (2 forward, 3 backward) on 1 + 4 images;
    # per pass and slot 5 per-channel tensors and 4 per-(image, group) ones
    want = sum(4 * (5 * 5 * c * h * w + 2 * 5 * c + 4 * 5 * 32) for c, h, w in slots)
    assert G.train_bytes_per_step(SMALL, TRAFFIC) == want


def test_the_group_norm_kernels_by_name():
    names = [k[0] for k in KERNELS]
    assert [G.is_group_norm_kernel(n) for n in names] == [True] * 4 + [False] * 2


def test_group_norm_ms_per_step_and_roofline():
    tr = chrome(KERNELS)
    assert read("train.group_norm_ms_per_step", tr, SMALL, TRAFFIC, requests=2) == \
        pytest.approx(200e-3 / 2)
    least = G.train_bytes_per_step(SMALL, TRAFFIC) * 2 / 3.35e12
    assert read("train.group_norm_roofline", tr, SMALL, TRAFFIC, requests=2) == \
        pytest.approx(100 * least / 200e-6)
    none = chrome([k for k in KERNELS if not G.is_group_norm_kernel(k[0])])
    assert read("train.group_norm_ms_per_step", none, SMALL, TRAFFIC) is None
    assert read("train.group_norm_roofline", none, SMALL, TRAFFIC) is None


def test_a_tiny_run_of_the_group_norm_cell_is_correct():
    cell = tiny_cell(GN_CELL)
    assert cell.config["use_group_norm"] and cell.traffic["objective"]["loc_weight"] == 0.0
    cell.limits = dict(cell.limits, **TINY_GN_TRAIN_LIMITS)
    result = run_cell(cell, 2**31 + 13, 1.0, False, "cpu", time.perf_counter())
    assert result.correct, result.checks
    assert set(result.metrics) == {"train_step_ms", "setup_s"}
