"""The backbone's frozen BatchNorm, and its slots with their ReLU and
residual add: on the card, where no gradient is recorded, one launch of
`csrc/frozen_bn_act_nhwc.cu` a slot; everywhere else ATen's eager chain.

`frozen_bn_act(x, bn, identity=None, identity_bn=None)` is the one entry:

    relu(bn(x))                          identity None (the stem, bn1, bn2)
    relu(bn(x) + identity)               identity_bn None (a bottleneck's
                                         tail without downsample)
    relu(bn(x) + identity_bn(identity))  a tail with downsample

It takes the kernel when every norm is a `FrozenBatchNorm2d`, x is on the
card and no gradient is recorded (grad mode off, or nothing involved
requires grad). Else it runs the eager chain (`frozen_bn_act_eager`,
today's `Bottleneck.forward` expressions, to the bit) and counts the call
in `eager` by its reason: the first that holds of "norm_type" (a
`GroupNorm2d` or `FoldedBatchNorm2d` slot), "grad" (training, `TrainStep`'s
graphed passes among them) and "cpu". So eval, serving and the class heads'
build run the kernel, and training keeps its bits. The kernel computes in
fp32: on the card it refuses (ValueError) operands the eager chain would
compute in a wider dtype (fp64 x or identity) and BatchNorm tensors that
are not fp32.

The kernel reads x (and identity) in their memory: channels-last, as every
activation of `models/resnet.py: ResNetC4` is, or NCHW-contiguous with
H * W a multiple of 4; anything else, a misaligned view or a bf16 value
goes on an fp32 channels-last copy (`operands`). It folds each channel's
scale and shift from the four parameter vectors as `folding_factor` does
and rounds every operation as the eager chain does, so the two agree to the
bit on the card (tests/test_torch_frozen_bn_card.py). It launches on the
current stream, allocates only its output and never synchronises.

`frozen_bn_act_reference` is the plain version of the kernel's arithmetic,
for the tests.

Counters since import, read and reset by whoever measures them:
`KERNEL.launches` (the kernel's launches: 40 a ResNet50-C4 pass, 1 for the
stem and 3 for each bottleneck) and `eager` (calls that took the eager
chain, by reason).
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from .cuda import CudaKernel, aligned

BN_EPS = 1e-5

_P = ctypes.c_void_p
# x, weight, bias, mean, var, identity, id_weight, id_bias, id_mean, id_var,
# y, vecs, channels, plane_vecs, form, eps, stream
KERNEL = CudaKernel("frozen_bn_act_nhwc.cu", "os2d_frozen_bn_act",
                    [_P] * 11 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_float, _P])
# the kernel's forms: relu(bn(x)), relu(bn(x) + identity),
# relu(bn(x) + bn'(identity))
RELU, ADD_RELU, BN_ADD_RELU = 0, 1, 2
# channels-last rows of at most this many channels (a block's 1024 threads
# of four channels each)
MAX_CHANNELS_LAST = 4096

eager = collections.Counter()


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm in inference form (running statistics), as the reference
    freezes it (os2d/modeling/model.py:159-160), computed in the `_norm` form
    of the JAX package: x * (scale * rsqrt(var + eps)) + (bias - mean * that).

    All four tensors are parameters: the JAX trainer differentiates and
    updates every leaf of its params, BatchNorm's mean and var included
    (os2d_tpu/engine/train.py:202-217), and the port takes the same step.
    They keep torchvision's names, so checkpoints map one to one."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_parameter(name, nn.Parameter(torch.empty(channels, device=device)))

    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def folding_factor(self):
        """f = scale * rsqrt(var + eps): BN(y) = y * f + (bias - mean * f)."""
        return self.weight * torch.rsqrt(self.running_var + BN_EPS)

    def forward(self, x):
        scale = self.folding_factor()
        shift = self.bias - self.running_mean * scale
        # fp32 for fp32 and bf16 inputs (fp64 stays fp64)
        return (x.to(torch.promote_types(x.dtype, torch.float32)) * scale[:, None, None]
                + shift[:, None, None])


def _tensors(bn):
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


def eager_reason(x, bn, identity=None, identity_bn=None):
    """Why `frozen_bn_act` takes the eager chain for these operands, or None
    where it takes the kernel."""
    norms = (bn,) if identity_bn is None else (bn, identity_bn)
    if not all(isinstance(m, FrozenBatchNorm2d) for m in norms):
        return "norm_type"
    params = [t for m in norms for t in _tensors(m)]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params, *([] if identity is None else [identity]))):
        return "grad"
    if x.device.type != "cuda":
        return "cpu"
    return None


def frozen_bn_act(x, bn, identity=None, identity_bn=None):
    """relu(bn(x)), relu(bn(x) + identity) or relu(bn(x) +
    identity_bn(identity)), fp32: the kernel or the eager chain (see the
    module docstring)."""
    reason = eager_reason(x, bn, identity, identity_bn)
    if reason is None:
        return frozen_bn_act_forward(x, bn, identity, identity_bn)
    eager[reason] += 1
    return frozen_bn_act_eager(x, bn, identity, identity_bn)


def frozen_bn_act_eager(x, bn, identity=None, identity_bn=None):
    """The slot as ATen computes it, one operation at a time."""
    out = bn(x)
    if identity is not None:
        out = out + (identity if identity_bn is None else identity_bn(identity))
    return F.relu(out)


def operands(x, identity=None):
    """(x, identity, channels_last) as the kernel reads them: fp32 (a lower
    float dtype converted, as the eager chain converts it), both in one
    memory format, 16-byte aligned. x keeps its memory where it is
    channels-last, or NCHW-contiguous with H * W % 4 == 0; anything else
    becomes a channels-last copy. identity follows x's format."""
    x = x.float()
    channels_last = (x.is_contiguous(memory_format=torch.channels_last)
                     or not x.is_contiguous() or x.shape[2] * x.shape[3] % 4 != 0)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = aligned(x, fmt)
    if identity is not None:
        if identity.shape != x.shape:
            raise ValueError(f"identity {tuple(identity.shape)} and x {tuple(x.shape)} differ")
        identity = aligned(identity.float(), fmt)
    return x, identity, channels_last


def frozen_bn_act_forward(x, bn, identity=None, identity_bn=None):
    """The slot through the kernel, for x on the card (see the module
    docstring); y fp32 in the memory format the kernel read x in."""
    params = [p for m in ((bn,) if identity_bn is None else (bn, identity_bn))
              for p in _tensors(m)]
    for t in (x,) if identity is None else (x, identity):
        if torch.promote_types(t.dtype, torch.float32) != torch.float32:
            raise ValueError(f"the frozen BatchNorm kernel computes in fp32, got {t.dtype} "
                             f"operands")
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError("the frozen BatchNorm kernel computes in fp32, got BatchNorm tensors "
                         "that are not fp32")
    if x.device.type != "cuda":
        raise ValueError(f"the frozen BatchNorm kernel takes CUDA tensors, got {x.device}")
    x, identity, channels_last = operands(x, identity)
    n, c, h, w = x.shape
    if channels_last and (c % 4 or c > MAX_CHANNELS_LAST):
        raise ValueError(f"the frozen BatchNorm kernel takes channels-last rows of a multiple "
                         f"of 4 channels, at most {MAX_CHANNELS_LAST}, got {c}")
    for p in params:
        if p.shape != (c,) or not p.is_contiguous():
            raise ValueError(f"BatchNorm tensors must be contiguous [{c}]")
    for t in ([] if identity is None else [identity]) + params:
        if t.device != x.device:
            raise ValueError(f"the frozen BatchNorm kernel takes tensors on one device, got "
                             f"{t.device} and {x.device}")
    form = RELU if identity is None else (ADD_RELU if identity_bn is None else BN_ADD_RELU)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    ptrs = [p.data_ptr() for p in params]
    with torch.cuda.device(x.device):
        # the identity's BatchNorm is bn's where the form reads none
        KERNEL.launch(x.data_ptr(), *ptrs[:4], (x if identity is None else identity).data_ptr(),
                      *ptrs[-4:], y.data_ptr(), x.numel() // 4, c,
                      0 if channels_last else h * w // 4, form, BN_EPS,
                      torch.cuda.current_stream(x.device).cuda_stream)
    return y


def frozen_bn_act_reference(x, bn, identity=None, identity_bn=None):
    """The plain version of the kernel's arithmetic: per channel scale =
    weight * rsqrt(var + eps), shift = bias - mean * scale; then x * scale,
    + shift, + identity (or its own BatchNorm's value), ReLU, each rounded
    on its own; in fp32 (fp64 for fp64 operands, as a truth to hold the
    kernel to)."""

    def widened(t):
        return t.to(torch.promote_types(t.dtype, torch.float32))

    def affine(t, m):
        scale = m.weight * torch.rsqrt(m.running_var + BN_EPS)
        shift = m.bias - m.running_mean * scale
        return widened(t) * scale[:, None, None] + shift[:, None, None]

    y = affine(x, bn)
    if identity is not None:
        y = y + (widened(identity) if identity_bn is None else affine(identity, identity_bn))
    return torch.relu(y)
