"""The FLOP and byte counts against shapes worked out by hand."""

import json

import pytest

from hopper_bench.counts import flops as F
from hopper_bench.tests.tiny import ROOT

V2 = json.loads((ROOT / "hopper_bench/configs/os2d-v2-r50.json").read_text())
SMALL = dict(V2, backbone_blocks=[1, 1, 1])  # one bottleneck a layer


def test_feature_map_sides():
    assert F.feature_map(960, 1280) == (60, 80)
    assert F.feature_map(600, 600) == (38, 38)
    assert F.feature_map(240, 240) == (15, 15)


def test_backbone_of_one_block_a_layer_at_32_px():
    stem = 2 * 3 * 64 * 49 * 16 * 16  # 7x7 s2 -> 16x16, then the pool to 8x8
    layer1 = 2 * 64 * (64 + 64 * 9 + 256 + 256) * 64  # conv1, conv2, conv3, downsample at 8x8
    layer2 = 2 * 256 * 128 * 64 + 2 * (128 * 128 * 9 + 128 * 512 + 256 * 512) * 16
    layer3 = 2 * 512 * 256 * 16 + 2 * (256 * 256 * 9 + 256 * 1024 + 512 * 1024) * 4
    assert stem + layer1 + layer2 + layer3 == 44_662_784
    assert F.backbone_flops(SMALL, 32, 32) == 44_662_784


def test_head_of_one_anchor_and_class():
    corr = 2 * 225 * 1024
    tnet = 2 * (7 * 7 * 225 * 128 + 5 * 5 * 128 * 64 + 5 * 5 * 64 * 6)
    assert F.head_flops_per_anchor_class(V2) == corr + tnet + 28 * 121 == 3_715_388


def test_eval_and_train_counts_at_32_px():
    traffic = {"image_w": 32, "image_h": 32, "pyramid_scales": [1.0], "classes": 1}
    assert F.eval_flops_per_image(SMALL, traffic) == 44_662_784 + 4 * 3_715_388
    train = {"batch": 1, "patch": 32, "classes": 1, "class_image_size": 32}
    fwd = 2 * 44_662_784 + 4 * 3_715_388
    bwd = 2 * (2 * 44_662_784 - 4_816_896) + 4 * (2 * 3_712_000 + 90 * 121)
    assert F.train_flops_per_step(SMALL, train) == fwd + bwd == 302_944_024


def test_kernel_bytes_and_bounds():
    b, ops = F.hat_bytes_ops(2, 16, 4800, 121)
    assert b == 4 * (3 * 2 * 16 * 121 * 4800 + 16 * 121 + 2 * 16 * 4800) == 223_649_344
    assert ops == 520_396_800
    assert F.bound_s(b, ops) == pytest.approx(223_649_344 / 3.35e12)  # bound by bytes
    b, ops = F.backward_bytes_ops(4, 16, 1444, 121, 225)
    assert b == 307_568_192 and ops == 1_006_410_240


def test_the_cells_counts():
    traffic = json.loads((ROOT / "hopper_bench/traffic/eval-c16-b2.json").read_text())
    assert sum(h * w for h, w in (F.feature_map(h, w) for w, h in F.level_sizes(traffic))) \
        == 39_580
    assert F.eval_flops_per_image(V2, traffic) == pytest.approx(3.676e12, rel=1e-3)
