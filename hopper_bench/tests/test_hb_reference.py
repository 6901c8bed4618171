"""The plain reference against the port (os2d_torch) at a tiny size on the
CPU, for both configurations, and whole runs of both cells there: the
reference itself imports no port code (test_hb_names), this test imports
both."""

import time

import pytest
import torch

from hopper_bench.harness.common import build_model
from hopper_bench.harness.runner import run_cell
from hopper_bench.harness.weights import make_state_dict
from hopper_bench.reference import model as ref
from hopper_bench.tests.tiny import EVAL, TRAIN, tiny_cell


@pytest.mark.parametrize("name", [EVAL, TRAIN])
def test_head_outputs_match_the_port(name):
    from os2d_torch.models.head import build_class_head

    config = tiny_cell(name).config
    state = make_state_dict(config, 2**31 + 5, "cpu")
    model = build_model(config, state, "cpu")
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(2, 96, 128, 3, generator=gen) * 4 - 2
    class_images = torch.rand(3, 64, 64, 3, generator=gen) * 4 - 2
    with torch.no_grad():
        fm = model.backbone(images)
        head = build_class_head(model.backbone(class_images))
        out = model.apply_head(fm, head)
        r_fm = ref.backbone(images.permute(0, 3, 1, 2), state, config, torch.float32)
        feats = ref.class_features(class_images.permute(0, 3, 1, 2), state, config,
                                   torch.float32)
        loc, cls = ref.head(r_fm, feats, state, config, torch.float32)
    assert torch.allclose(r_fm.permute(0, 2, 3, 1), fm, rtol=1e-5, atol=1e-5)
    assert torch.allclose(feats, head.class_feats, atol=1e-6)
    # the default tier rounds each row hat weight to bf16: coordinates that
    # differ in their last bits can round one weight across a bf16 step
    # (2^-8 below 1), and V1's simplified affine model shares one row weight
    # among the template's 11 columns: 11 * 2^-8 * 0.95 / 121 = 3.4e-4
    assert torch.allclose(cls, out["cls"], atol=5e-4)
    assert torch.allclose(loc, out["loc"].transpose(2, 3), atol=5e-5)


def test_a_configuration_with_fold_bn_builds_the_folded_model():
    config = dict(tiny_cell(EVAL).config, fold_bn=True)
    state = make_state_dict(config, 2**31 + 6, "cpu")
    model = build_model(config, state, "cpu")
    images = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1)) * 4 - 2
    with torch.no_grad():
        fm = model.backbone(images)
        r_fm = ref.backbone(images.permute(0, 3, 1, 2), state, config, torch.float32)
    kinds = {type(m).__name__ for m in model.backbone.modules()}
    assert "FoldedBatchNorm2d" in kinds and "FrozenBatchNorm2d" not in kinds
    assert torch.allclose(r_fm.permute(0, 2, 3, 1), fm, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", [EVAL, TRAIN])
def test_a_tiny_run_is_correct(name):
    cell = tiny_cell(name)
    result = run_cell(cell, 2**31 + 11, 1.0, False, "cpu", time.perf_counter())
    assert result.correct, result.checks
    assert result.attempted >= 1
    assert set(result.metrics) == {m["name"] for m in cell.end_to_end}
