"""Which path computes a frozen BatchNorm slot (`os2d_torch/ops/frozen_bn.py`),
on the CPU: `frozen_bn_act` takes the kernel only for `FrozenBatchNorm2d`
slots on the card with no gradient recorded, and ATen's eager chain
otherwise, counting each such call in `eager` by its reason. The kernel
itself runs on the card (tests/test_torch_frozen_bn_card.py); here its
plain version is held to the eager backbone to the bit, and the operands it
would read are checked."""

from unittest import mock

import numpy as np
import pytest
import torch

from os2d_torch.models import resnet
from os2d_torch.models.resnet import ResNetC4, fold_batchnorm_c4
from os2d_torch.ops import frozen_bn as fb

# 1 stem slot + 3 slots in each of ResNet50-C4's 3 + 4 + 6 bottlenecks
SLOTS = 40


def _backbone(use_group_norm=False, compute_dtype=torch.float32):
    """A ResNet50-C4 with seeded convolutions and norms away from identity."""
    backbone = ResNetC4("resnet50", device="cpu", compute_dtype=compute_dtype,
                        use_group_norm=use_group_norm)
    backbone.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in backbone.modules():
            if isinstance(m, fb.FrozenBatchNorm2d):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
    return backbone


def _images(seed=2, h=40, w=56):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(1, h, w, 3))).float()


def _advance(before):
    return {k: v - before.get(k, 0) for k, v in fb.eager.items() if v != before.get(k, 0)}


def test_on_the_cpu_every_slot_takes_the_eager_chain_and_counts_cpu():
    backbone = _backbone()
    before = dict(fb.eager)
    with torch.no_grad():
        backbone(_images())
    assert _advance(before) == {"cpu": SLOTS}


def test_grad_mode_with_parameters_that_require_grad_takes_the_eager_chain():
    backbone = _backbone()
    before = dict(fb.eager)
    backbone(_images()).sum().backward()
    assert _advance(before) == {"grad": SLOTS}
    # with nothing that requires grad, grad mode alone does not send it there
    for p in backbone.parameters():
        p.requires_grad_(False)
    before = dict(fb.eager)
    backbone(_images())
    assert _advance(before) == {"cpu": SLOTS}


@pytest.mark.parametrize("kind", ["group_norm", "folded"])
def test_group_norm_and_folded_slots_take_the_eager_chain(kind):
    backbone = _backbone(use_group_norm=kind == "group_norm")
    if kind == "folded":
        backbone = fold_batchnorm_c4(backbone)
    before = dict(fb.eager)
    with torch.no_grad():
        backbone(_images())
    assert _advance(before) == {"norm_type": SLOTS}


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_the_plain_version_equals_the_eager_backbone_to_the_bit(compute_dtype):
    """ResNetC4 with every slot computed by `frozen_bn_act_reference`, the
    kernel's arithmetic written in torch, equals the eager chain's output
    bit for bit (with bfloat16 convolutions the slots read bf16 and add in
    fp32)."""
    backbone = _backbone(compute_dtype=compute_dtype)
    images = _images(h=48, w=40)
    with torch.no_grad():
        want = backbone(images)
        with mock.patch.object(resnet, "frozen_bn_act", fb.frozen_bn_act_reference):
            got = backbone(images)
    assert want.dtype == got.dtype == torch.float32
    assert torch.equal(got, want)


def test_the_plain_version_keeps_nan_and_zeroes_negatives():
    bn = fb.FrozenBatchNorm2d(4)
    with torch.no_grad():
        bn.reset_parameters()
    x = torch.tensor([float("nan"), -1.0, 2.0, -0.0]).reshape(1, 4, 1, 1)
    got = fb.frozen_bn_act_reference(x, bn)
    torch.testing.assert_close(got, fb.frozen_bn_act_eager(x, bn), rtol=0, atol=0,
                               equal_nan=True)
    assert torch.isnan(got[0, 0]).item()
    assert got[0, 1].item() == got[0, 3].item() == 0.0 and got[0, 2].item() > 1.99


def _channels_last(n, c, h, w, dtype=torch.float32):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(n, c, h, w))).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _misaligned(x):
    """x's values on channels-last strides at an address 4 bytes past 16."""
    flat = torch.zeros(x.numel() + 1)
    shifted = flat.as_strided(x.shape, x.stride(), storage_offset=1)
    shifted.copy_(x)
    return shifted


@pytest.mark.parametrize("case, keeps, channels_last", [
    ("channels_last", True, True),
    ("nchw", True, False),  # H * W = 48, a multiple of 4
    ("nchw_odd_hw", False, True),  # H * W = 35: a vector would cross planes
    ("strided", False, True),
    ("misaligned", False, True),
    ("bf16", False, True),
])
def test_operands_keep_what_the_kernel_reads_and_copy_the_rest(case, keeps, channels_last):
    base = _channels_last(2, 64, 6, 8)
    x = {"channels_last": base, "nchw": base.contiguous(),
         "nchw_odd_hw": _channels_last(2, 64, 5, 7).contiguous(),
         "strided": _channels_last(2, 64, 6, 9)[:, :, :, 1:],
         "misaligned": _misaligned(base), "bf16": base.bfloat16()}[case]
    identity = x.float().contiguous()  # NCHW memory: follows x's format
    got, got_identity, got_channels_last = fb.operands(x, identity)
    assert (got is x) == keeps
    assert got_channels_last == channels_last
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    for t in (got, got_identity):
        assert t.dtype == torch.float32 and t.data_ptr() % 16 == 0
        assert t.is_contiguous(memory_format=fmt)
    assert torch.equal(got, x.float()) and torch.equal(got_identity, identity)


def test_the_kernel_wrapper_refuses_what_it_cannot_take():
    bn = fb.FrozenBatchNorm2d(64)
    x = _channels_last(2, 64, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fb.frozen_bn_act_forward(x, bn)
    # the kernel computes in fp32: wider operands and BatchNorm tensors that
    # are not fp32 are refused before anything is copied or launched
    with pytest.raises(ValueError, match="fp32"):
        fb.frozen_bn_act_forward(x.double(), bn)
    with pytest.raises(ValueError, match="fp32"):
        fb.frozen_bn_act_forward(x, bn, x.double())
    with pytest.raises(ValueError, match="fp32"):
        fb.frozen_bn_act_forward(x, fb.FrozenBatchNorm2d(64).double())
    with pytest.raises(ValueError, match="differ"):
        fb.operands(x, x[:1])
