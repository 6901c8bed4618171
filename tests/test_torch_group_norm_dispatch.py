"""Which path computes GroupNorm (`os2d_torch/ops/group_norm.py`), on the
CPU: `GroupNorm2d` goes through `group_norm`, which takes the channels-last
kernels for every CUDA tensor (made channels-last and aligned first) and
F.group_norm for the CPU's, counting each such call in `fallbacks["cpu"]`.
The kernels themselves run on the card (tests/test_torch_group_norm_card.
py); here the plain versions of their arithmetic are held to fp64
autograd."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from os2d_torch.models.resnet import GroupNorm2d, ResNetC4
from os2d_torch.ops import group_norm as gn


def _channels_last(n, c, h, w, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(2.0, 3.0, (n, c, h, w))).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _advance(before):
    return {k: v - before.get(k, 0) for k, v in gn.fallbacks.items() if v != before.get(k, 0)}


def test_on_the_cpu_group_norm2d_is_f_group_norm_and_counts_cpu():
    norm = GroupNorm2d(64)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.normal_()
    x = _channels_last(2, 64, 5, 7)
    before = dict(gn.fallbacks)
    y = norm(x)
    assert _advance(before) == {"cpu": 1}
    assert torch.equal(y, F.group_norm(x, 32, norm.weight, norm.bias, 1e-5))
    # a bf16 activation is normalized in fp32 and comes out fp32
    before = dict(gn.fallbacks)
    yb = norm(x.bfloat16())
    assert yb.dtype == torch.float32 and _advance(before) == {"cpu": 1}


def test_every_slot_of_a_group_norm_backbone_takes_the_dispatch():
    backbone = ResNetC4("resnet50", device="cpu", use_group_norm=True)
    backbone.reset_parameters(torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 32, 32, 3))).float()
    before = dict(gn.fallbacks)
    with torch.no_grad():
        backbone(images)
    assert _advance(before) == {"cpu": 43}  # 1 + 3 * (3 + 4 + 6) + 3 slots of ResNet50-C4


def test_the_kernels_take_fp32_channels_last_and_nothing_else():
    w = torch.ones(64)
    x = _channels_last(2, 64, 4, 4)
    assert gn.refusal(x, w, w) == "CUDA tensors"  # the only want of a CPU tensor
    assert gn.refusal(x.double(), w.double(), w.double()) == "fp32 tensors"
    assert gn.refusal(x, w.bfloat16(), w) == "fp32 tensors"
    layout = "channels-last x and 16-byte aligned tensors"
    assert gn.refusal(x.contiguous(), w, w) == layout  # NCHW memory
    assert gn.refusal(x[:, :, :, 1:], w, w) == layout  # a strided view
    # channels-last strides on memory that is not 16-byte aligned
    flat = torch.zeros(2 * 64 * 16 + 1)
    shifted = flat.as_strided(x.shape, x.stride(), storage_offset=1)
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    assert gn.refusal(shifted, w, w) == layout
    with pytest.raises(ValueError, match="fp32"):
        gn.group_norm_forward(x.double(), 32, w, w, 1e-5)
    with pytest.raises(ValueError, match="channels-last"):
        gn.group_norm_forward(x.contiguous(), 32, w, w, 1e-5)


def test_what_the_kernels_refuse_for_layout_is_made_channels_last_and_aligned():
    """`group_norm` hands the kernels `aligned(x, channels_last)`: x itself
    where it already is, else a channels-last, aligned copy of its values."""
    w = torch.ones(64)
    x = _channels_last(2, 64, 4, 4)
    assert gn.aligned(x, torch.channels_last) is x
    flat = torch.zeros(2 * 64 * 16 + 1)
    shifted = flat.as_strided(x.shape, x.stride(), storage_offset=1)
    shifted.copy_(x)
    for t in (x.contiguous(), x[:, :, :, 1:], shifted):
        got = gn.aligned(t, torch.channels_last)
        assert gn.refusal(got, w, w) == "CUDA tensors"
        assert torch.equal(got, t)
    assert gn.aligned(w) is w


def test_the_kernel_wrappers_refuse_cpu_tensors():
    w = torch.ones(64)
    x = _channels_last(2, 64, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_forward(x, 32, w, w, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_backward(x, x, 32, w, torch.zeros(64), torch.ones(64))


@pytest.mark.parametrize("channels, rows, want", [
    (64, 300 * 300, (16, 256, 352)),  # the stem's slot of a 600-px scene
    (256, 150 * 150, (4, 64, 352)),
    (1024, 38 * 38, (1, 16, 91)),
    (2048, 10, (1, 16, 1)),  # a row of 512 threads
])
def test_row_tiling(channels, rows, want):
    assert gn.row_tiling(channels, rows) == want


def test_a_row_beyond_one_block_is_refused():
    with pytest.raises(ValueError, match="2048 channels"):
        gn.row_tiling(4096, 10)


@pytest.mark.parametrize("shape", [(2, 64, 9, 7), (3, 256, 5, 4), (1, 1024, 3, 3)])
def test_plain_versions_match_fp64_autograd(shape):
    """The plain forward (two-pass statistics) and backward (the kernels'
    sums and coefficients) against F.group_norm's autograd, all in fp64:
    the formulas are exact, so only fp64 rounding separates them."""
    x = _channels_last(*shape, dtype=torch.float64).requires_grad_(True)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, shape[1])).requires_grad_(True)
    b = torch.from_numpy(rng.normal(size=shape[1])).requires_grad_(True)
    y = F.group_norm(x, 32, w, b, 1e-5)
    dy = torch.from_numpy(rng.normal(size=shape))
    want = torch.autograd.grad(y, (x, w, b), dy)
    y2, mean, rstd = gn.group_norm_reference(x.detach(), 32, w.detach(), b.detach(), 1e-5)
    got = gn.group_norm_backward_reference(dy, x.detach(), 32, w.detach(), mean, rstd)
    torch.testing.assert_close(y2, y.detach(), rtol=1e-12, atol=1e-12)
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, rtol=1e-10, atol=1e-10)
