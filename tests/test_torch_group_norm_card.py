"""The channels-last GroupNorm kernels (`csrc/group_norm_nhwc.cu` through
`ops/group_norm.py`) on the card. Without a card every test here skips.
The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_group_norm_card.py -q -s

- Forward and backward against the benchmark reference's two-pass
  `group_norm` (hopper_bench/reference/model.py) under fp64 autograd, at
  the slot shapes of the stem, layer1 and layer3 of a 600-px scene and of
  layer3 of a 240-px class image, a width whose group holds 3 channels, one
  of 2048 channels, and a group far from zero. Each error is held to twice
  ATen's fp32 F.group_norm's on the same input, plus 1e-6 of the largest
  value: the kernels' fp32 arithmetic is to be no worse than the library's.
- Output and gradients keep channels-last memory, no call falls back, each
  direction is one launch of its entry point.
- Two calls give the same bits, forward and backward.
- NCHW, strided and misaligned input takes the kernels too, on a
  channels-last copy, to the same bits as channels-last input.
- A GroupNorm ResNet50-C4 TrainStep with the backbone's passes graphed
  equals the eager steps to the bit (the pattern of
  tests/test_torch_train_graphs_card.py), and no GroupNorm falls back.
"""

import pytest
import torch
import torch.nn.functional as F

from test_torch_train_graphs_card import (
    _advance,
    _assert_bit_equal,
    _batches,
    _counters,
    _record,
    _restore,
    _state,
)

pytestmark = pytest.mark.cuda

EPS = 1e-5
# (N, C, H, W): the stem's, layer1's (bn3) and layer3's (bn3) slots of the
# scene pass (4 x 600 px), layer3's of the class pass (16 x 240 px), groups
# of 3 channels (a row of 24 threads), a row of 512 threads
SHAPES = [(4, 64, 300, 300), (4, 256, 150, 150), (4, 1024, 38, 38), (16, 1024, 15, 15),
          (2, 96, 7, 5), (1, 2048, 3, 3)]


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(5)


def _inputs(gen, shape, offset=3.0, scale=2.0):
    """x channels-last fp32 with a per-channel offset in +-offset, weight,
    bias and a cotangent."""
    n, c, h, w = shape
    x = (torch.randn(shape, generator=gen, device="cuda") * scale
         + (torch.rand(1, c, 1, 1, generator=gen, device="cuda") * 2 - 1) * offset)
    x = x.contiguous(memory_format=torch.channels_last)
    weight = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.randn(c, generator=gen, device="cuda") * 0.1
    dy = torch.randn(shape, generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    return x, weight, bias, dy


def _fp64(x, weight, bias, dy):
    from hopper_bench.reference.model import group_norm

    leaves = [t.double().requires_grad_(True) for t in (x, weight, bias)]
    y = group_norm(leaves[0], {"p.weight": leaves[1], "p.bias": leaves[2]}, "p.", torch.float64)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy.double()))


def _errors(got, want):
    return [float((g.double() - w).abs().max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("shape, offset, scale", [(s, 3.0, 2.0) for s in SHAPES]
                         + [((2, 256, 20, 20), 100.0, 0.1)])
def test_kernels_against_fp64_within_atens_error(shape, offset, scale, cuda_gen):
    from os2d_torch.ops import group_norm as gn

    x, weight, bias, dy = _inputs(cuda_gen, shape, offset, scale)
    want = _fp64(x, weight, bias, dy)
    before = dict(gn.fallbacks)
    launches = gn.FORWARD.launches, gn.BACKWARD.launches
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    y = gn.group_norm(leaves[0], 32, leaves[1], leaves[2], EPS)
    got = (y.detach(), *torch.autograd.grad(y, leaves, dy))
    assert dict(gn.fallbacks) == before
    assert (gn.FORWARD.launches, gn.BACKWARD.launches) == (launches[0] + 1, launches[1] + 1)
    for t in (got[0], got[1]):
        assert t.is_contiguous(memory_format=torch.channels_last)

    aten = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    ya = F.group_norm(aten[0], 32, aten[1], aten[2], EPS)
    ref = (ya.detach(), *torch.autograd.grad(ya, aten, dy))
    err, err_aten = _errors(got, want), _errors(ref, want)
    print(f"\n{shape} offset {offset}: kernel {err} ATen {err_aten}")
    for name, e, ea, w in zip(("y", "dx", "dweight", "dbias"), err, err_aten, want):
        assert e <= 2 * ea + 1e-6 * float(w.abs().max()), (name, e, ea)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_two_calls_give_the_same_bits(shape, cuda_gen):
    from os2d_torch.ops import group_norm as gn

    x, weight, bias, dy = _inputs(cuda_gen, shape)
    y1, mean1, rstd1 = gn.group_norm_forward(x, 32, weight, bias, EPS)
    y2, mean2, rstd2 = gn.group_norm_forward(x, 32, weight, bias, EPS)
    assert torch.equal(y1, y2) and torch.equal(mean1, mean2) and torch.equal(rstd1, rstd2)
    g1 = gn.group_norm_backward(dy, x, 32, weight, mean1, rstd1)
    g2 = gn.group_norm_backward(dy, x, 32, weight, mean1, rstd1)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_other_layouts_take_the_kernels_on_a_channels_last_copy(cuda_gen):
    from os2d_torch.ops import group_norm as gn

    x, weight, bias, dy = _inputs(cuda_gen, (2, 64, 9, 7))
    want = gn.group_norm_forward(x, 32, weight, bias, EPS)[0]
    flat = torch.empty(x.numel() + 1, device="cuda")
    shifted = flat.as_strided(x.shape, x.stride(), storage_offset=1)
    shifted.copy_(x)
    wide = torch.zeros(2, 64, 9, 8, device="cuda")
    wide[..., :7] = x
    for other in (x.contiguous(), shifted, wide[..., :7]):
        before, launches = dict(gn.fallbacks), gn.FORWARD.launches
        got = gn.group_norm(other, 32, weight, bias, EPS)
        assert dict(gn.fallbacks) == before and gn.FORWARD.launches == launches + 1
        assert torch.equal(got, want)
    leaf = x.contiguous().requires_grad_(True)
    got = torch.autograd.grad(gn.group_norm(leaf, 32, weight, bias, EPS), leaf, dy)[0]
    mean, rstd = gn.group_norm_forward(x, 32, weight, bias, EPS)[1:]
    assert torch.equal(got, gn.group_norm_backward(dy, x, 32, weight, mean, rstd)[0])


def _gn_step():
    """A GroupNorm ResNet50-C4 OS2D V2 from seed 3, its SGD and TrainStep."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = get_default_cfg()
    model = Os2dModel(Os2dConfig(class_image_size=128, use_group_norm=True), seed=3)
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    return TrainStep(model, ObjectiveConfig(margin_pos=1.0), optimizer, cfg.train)


def test_group_norm_graphed_steps_equal_the_eager_steps_to_the_bit(cuda_gen):
    from os2d_torch.ops import group_norm as gn

    batches = _batches(cuda_gen)
    step = _gn_step()
    start = _state(step)
    before, fallbacks = _counters(), dict(gn.fallbacks)
    graphed = _record(step, batches)
    signatures = 4  # two shapes, two slots each
    assert _advance(before) == (signatures, 2 * (len(batches) - 2), {"first_sight": signatures})
    assert dict(gn.fallbacks) == fallbacks
    assert graphed[0][0]["cls_RLL_pos"] > 0

    _restore(step, start)
    step.backbone_graphs = type(step.backbone_graphs)(max_graphs=0)
    launches = gn.FORWARD.launches, gn.BACKWARD.launches
    eager = _record(step, batches)
    # eager: 43 slots a pass, two passes a step, each forward and backward
    assert gn.FORWARD.launches - launches[0] == 2 * 43 * len(batches)
    assert gn.BACKWARD.launches - launches[1] == 2 * 43 * len(batches)
    _assert_bit_equal(graphed, eager)
