"""The plain reference against the port (os2d_torch) at a tiny size on the
CPU, for both configurations and their GroupNorm(32) variants, and whole
runs of both cells and of those variants there: the reference itself
imports no port code (test_hb_names), this test imports both."""

import time

import pytest
import torch

from hopper_bench.harness.common import build_model
from hopper_bench.harness.runner import run_cell
from hopper_bench.harness.weights import make_state_dict
from hopper_bench.reference import model as ref
from hopper_bench.tests.tiny import EVAL, TRAIN, tiny_cell


CELLS = [(EVAL, False), (TRAIN, False), (EVAL, True), (TRAIN, True)]
CELL_IDS = [f"{name}{'-gn' if gn else ''}" for name, gn in CELLS]


# The tiny training cell with GroupNorm reads gradient gaps that the cell's
# limits do not hold: the port's GroupNorm (F.group_norm on channels-last
# memory, one-pass statistics) and the reference's (two-pass) differ in the
# last bits, which flips a few ReLUs whose activations lie that close to 0;
# on 2 images of 128 px a flipped unit carries 1/2048 of a layer1 weight's
# gradient, 1/128 of a layer3 one's. The reference against itself with
# one-pass statistics reads the same on the seed of test_a_tiny_run_is_correct
# (grad_gap 2.0e-3 beside the port's 2.1e-3); with BatchNorm both sides run
# the same operations and read 1.8e-6. Sound runs over 9 seeds read at most
# grad_gap 4.4e-3 and update_gap 1.5e-3; 16 groups in place of 32 read
# loss_gap 0.047-0.056 and grad_gap 0.33-0.57 (4 seeds). At the cell's size
# (600 px, 4 images) a flip carries 1/90,000 of a layer1 gradient.
TINY_GN_TRAIN_LIMITS = {"grad_gap": 2e-2, "update_gap": 1e-2}


def cell_of(name, group_norm):
    """The tiny cell, its configuration with GroupNorm(32) backbones where
    `group_norm` (training: with TINY_GN_TRAIN_LIMITS)."""
    cell = tiny_cell(name)
    if group_norm:
        cell.config = dict(cell.config, use_group_norm=True)
        if cell.traffic["kind"] == "train_steps":
            cell.limits = dict(cell.limits, **TINY_GN_TRAIN_LIMITS)
    return cell


@pytest.mark.parametrize("name,group_norm", CELLS, ids=CELL_IDS)
def test_head_outputs_match_the_port(name, group_norm):
    from os2d_torch.models.head import build_class_head

    config = cell_of(name, group_norm).config
    state = make_state_dict(config, 2**31 + 5, "cpu")
    model = build_model(config, state, "cpu")  # loads the state strictly
    kinds = {type(m).__name__ for m in model.backbone.modules()}
    assert ("GroupNorm2d" in kinds) == group_norm
    assert ("FrozenBatchNorm2d" in kinds) != group_norm
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


@pytest.mark.parametrize("name,group_norm", CELLS, ids=CELL_IDS)
def test_a_tiny_run_is_correct(name, group_norm):
    cell = cell_of(name, group_norm)
    result = run_cell(cell, 2**31 + 11, 1.0, False, "cpu", time.perf_counter())
    assert result.correct, result.checks
    assert result.attempted >= 1
    assert set(result.metrics) == {m["name"] for m in cell.end_to_end}


def test_a_tiny_group_norm_run_with_16_groups_is_not_correct(monkeypatch):
    import os2d_torch.models.resnet as resnet

    monkeypatch.setattr(resnet, "GROUPNORM_NUMGROUPS", 16)
    result = run_cell(cell_of(TRAIN, True), 2**31 + 11, 1.0, False, "cpu", time.perf_counter())
    assert not result.correct, result.checks
