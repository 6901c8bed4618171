"""The frozen BatchNorm kernel (`csrc/frozen_bn_act_nhwc.cu` through
`ops/frozen_bn.py`) on the card, held to ATen's eager chain to the bit.
Without a card every test here skips. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_frozen_bn_card.py -q

- Every slot shape of ResNet50-C4 on the bench's 1280 x 960 scenes (B=2) at
  the pyramid's 0.5 and 1.6 levels, in each of the three forms, channels-last
  and NCHW-contiguous: the kernel's output equals `frozen_bn_act_eager`'s
  bit for bit, in the input's memory format, one launch a slot.
- An odd H x W (NCHW taken on a channels-last copy), strided, misaligned
  and bf16 input: equal to the eager chain to the bit; fp64 input refused.
- The fold: for every one of the 2^32 bit patterns of running_var the
  kernel's scale (weight 1, bias and mean 0, x 1) equals ATen's to the bit,
  so `rsqrtf` in the kernel rounds as ATen's `torch.rsqrt`; and a million
  random channels of every parameter.
- The whole `ResNetC4.forward` under no_grad (the kernel, 40 launches a
  level, nothing eager) equals the same forward with grad enabled (the
  eager chain, counted "grad") to the bit; two calls give the same bits.
"""

from unittest import mock

import pytest
import torch

pytestmark = pytest.mark.cuda

# (H, W) of the bench's 1280 x 960 scenes at the pyramid's 0.5 and 1.6 levels
LEVELS = {"0.5": (480, 640), "1.6": (1536, 2048)}
BATCH = 2
SLOTS = 40  # ResNet50-C4: the stem and 3 slots in each of 13 bottlenecks


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(11)


def _norm(c, gen):
    from os2d_torch.ops.frozen_bn import FrozenBatchNorm2d

    bn = FrozenBatchNorm2d(c, device="cuda")
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen, device="cuda") + 0.5)
        bn.bias.copy_(torch.randn(c, generator=gen, device="cuda") * 0.5)
        bn.running_mean.copy_(torch.randn(c, generator=gen, device="cuda"))
        bn.running_var.copy_(torch.rand(c, generator=gen, device="cuda") * 2 + 0.01)
    return bn


def _slots(h, w):
    """The distinct (form, NCHW shape) of ResNet50-C4's frozen BatchNorm
    slots on a BATCH x h x w level, read off a forward on meta tensors."""
    from os2d_torch.models import resnet
    from os2d_torch.ops import frozen_bn as fb

    seen = []

    def record(x, bn, identity=None, identity_bn=None):
        seen.append((0 if identity is None else 1 if identity_bn is None else 2,
                     tuple(x.shape)))
        return fb.frozen_bn_act_eager(x, bn, identity, identity_bn)

    backbone = resnet.ResNetC4("resnet50", device="meta")
    with torch.no_grad(), mock.patch.object(resnet, "frozen_bn_act", record):
        backbone(torch.empty(BATCH, h, w, 3, device="meta"))
    assert len(seen) == SLOTS
    return sorted(set(seen))


def _operands(gen, form, shape, memory_format=torch.channels_last):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2).contiguous(
        memory_format=memory_format)
    identity = None if form == 0 else torch.randn(
        shape, generator=gen, device="cuda").contiguous(memory_format=memory_format)
    return x, _norm(shape[1], gen), identity, _norm(shape[1], gen) if form == 2 else None


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_every_slot_of_a_level_equals_the_eager_chain_to_the_bit(level, layout, cuda_gen):
    from os2d_torch.ops import frozen_bn as fb

    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    for form, shape in _slots(*LEVELS[level]):
        x, bn, identity, identity_bn = _operands(cuda_gen, form, shape, fmt)
        eager, launches = dict(fb.eager), fb.KERNEL.launches
        with torch.no_grad():
            got = fb.frozen_bn_act(x, bn, identity, identity_bn)
        assert dict(fb.eager) == eager and fb.KERNEL.launches == launches + 1
        assert got.is_contiguous(memory_format=fmt)
        want = fb.frozen_bn_act_eager(x, bn, identity, identity_bn)
        assert torch.equal(_bits(got), _bits(want)), (form, shape)
        del x, identity, got, want


@pytest.mark.parametrize("form", [0, 1, 2])
def test_other_layouts_and_dtypes_equal_the_eager_chain_to_the_bit(form, cuda_gen):
    from os2d_torch.ops import frozen_bn as fb

    x, bn, identity, identity_bn = _operands(cuda_gen, form, (2, 64, 75, 51))
    flat = torch.empty(x.numel() + 1, device="cuda")
    shifted = flat.as_strided(x.shape, x.stride(), storage_offset=1)
    shifted.copy_(x)
    wide = torch.zeros(2, 64, 75, 52, device="cuda")
    wide[..., :51] = x
    for other in (x, x.contiguous(), shifted, wide[..., :51], x.bfloat16()):
        launches = fb.KERNEL.launches
        with torch.no_grad():
            got = fb.frozen_bn_act(other, bn, identity, identity_bn)
        assert fb.KERNEL.launches == launches + 1
        want = fb.frozen_bn_act_eager(other, bn, identity, identity_bn)
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(_bits(got), _bits(want)), (other.dtype, other.stride())
    # the kernel computes in fp32: fp64 operands on the card are refused,
    # not handed to the eager chain
    before = dict(fb.eager)
    with torch.no_grad(), pytest.raises(ValueError, match="fp32"):
        fb.frozen_bn_act(x.double(), bn, identity, identity_bn)
    assert dict(fb.eager) == before


def test_the_fold_equals_atens_for_every_running_var(cuda_gen):
    """weight 1, bias 0, mean 0 and x 1: each output is the kernel's scale,
    weight * rsqrtf(var + eps), ReLU'd; every var bit pattern, NaN and
    infinities among them, in 64 chunks of 2^26 channels."""
    from os2d_torch.ops import frozen_bn as fb

    chunk = 1 << 26
    bn = fb.FrozenBatchNorm2d(chunk, device="cuda")
    x = torch.ones(1, chunk, 1, 4, device="cuda")  # NCHW, one vector a channel
    mismatched = 0
    with torch.no_grad():
        bn.reset_parameters()
        for start in range(0, 1 << 32, chunk):
            bits = torch.arange(start, start + chunk, device="cuda", dtype=torch.int64)
            bn.running_var.copy_((bits - (1 << 31)).to(torch.int32).view(torch.float32))
            got = fb.frozen_bn_act(x, bn)
            want = fb.frozen_bn_act_eager(x, bn)
            mismatched += int((_bits(got) != _bits(want)).sum())
    assert mismatched == 0


def test_a_million_random_channels_equal_the_eager_chain_to_the_bit(cuda_gen):
    from os2d_torch.ops import frozen_bn as fb

    c = 1 << 20
    for form in (0, 1, 2):
        x, bn, identity, identity_bn = _operands(cuda_gen, form, (1, c, 1, 4),
                                                 torch.contiguous_format)
        with torch.no_grad():
            for m in (bn, identity_bn):
                if m is not None:
                    for p in (m.weight, m.bias, m.running_mean):
                        p.copy_(torch.randn(c, generator=cuda_gen, device="cuda") * 3)
                    m.running_var.copy_(torch.randn(c, generator=cuda_gen, device="cuda").abs())
            got = fb.frozen_bn_act(x, bn, identity, identity_bn)
        want = fb.frozen_bn_act_eager(x, bn, identity, identity_bn)
        assert torch.equal(_bits(got), _bits(want)), form


def _backbone(gen):
    """A seeded ResNet50-C4 whose BatchNorms are away from identity."""
    from os2d_torch.models.resnet import ResNetC4
    from os2d_torch.ops.frozen_bn import FrozenBatchNorm2d

    backbone = ResNetC4("resnet50", device="cuda")
    backbone.reset_parameters(gen)
    with torch.no_grad():
        for m in backbone.modules():
            if isinstance(m, FrozenBatchNorm2d):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen, device="cuda") + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen, device="cuda") * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen, device="cuda") * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen, device="cuda") * 2 + 0.5)
    return backbone


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_the_no_grad_backbone_equals_the_eager_backbone_to_the_bit(level, cuda_gen):
    from os2d_torch.ops import frozen_bn as fb

    backbone = _backbone(cuda_gen)
    images = torch.randn(BATCH, *LEVELS[level], 3, generator=cuda_gen, device="cuda")
    eager, launches = dict(fb.eager), fb.KERNEL.launches
    with torch.no_grad():
        got = backbone(images)
        again = backbone(images)
    assert fb.KERNEL.launches == launches + 2 * SLOTS and dict(fb.eager) == eager
    assert torch.equal(_bits(got), _bits(again))
    assert torch.isfinite(got).all() and float(got.abs().max()) > 0
    want = backbone(images)  # grad enabled, every parameter requires grad
    assert fb.KERNEL.launches == launches + 2 * SLOTS
    assert fb.eager["grad"] == eager.get("grad", 0) + SLOTS
    assert torch.equal(_bits(got), _bits(want.detach()))
