"""TransformationNet, the weakalign-style affine-parameter regressor:
counterpart of `os2d_tpu/models/transform_net.py` (the reference's
os2d/modeling/head.py:604-661).

[ReLU -> L2-norm(channels)] -> Conv7x7(225->128)+BN+ReLU ->
Conv5x5(128->64)+BN+ReLU -> Conv5x5(64->out), all padded to keep the spatial
size; the final layer is zero-init with an identity-transform bias. BatchNorm
runs frozen, as the reference training recipe freezes it.

Compute dtype, as the JAX package rounds: each convolution runs on its input
and weight cast to the compute dtype WITHOUT its bias, the output is cast to
fp32 and the fp32 bias added (os2d_tpu/models/transform_net.py:28-39); the
BatchNorms compute in fp32, so the output is fp32 in every mode.
`fold_batchnorm_transform_net` folds both BatchNorms into their convolutions
(conv bias and BN collapse into one bias; the bn modules are gone).
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.geometry import l2_normalize_channels
from .resnet import Conv2d, FrozenBatchNorm2d

KERNEL_SIZES = (7, 5)
CHANNELS = (128, 64)
INPUT_DIM = 15 * 15


def _conv_bias(conv: Conv2d, x, dtype, weight=None):
    """conv(x, w) + b: in fp32 the bias rides in the convolution; in another
    compute dtype the convolution runs there without it and the fp32 bias is
    added to its fp32-cast output."""
    w = conv.weight if weight is None else weight
    if dtype == torch.float32:
        return F.conv2d(x, w, conv.bias, padding=conv.padding)
    out = F.conv2d(x.to(dtype), w.to(dtype), padding=conv.padding)
    return out.float() + conv.bias[:, None, None]


class TransformNet(nn.Module):
    def __init__(self, output_dim: int = 6, device=None, compute_dtype=torch.float32):
        super().__init__()
        self.output_dim = output_dim
        self.compute_dtype = compute_dtype
        self.conv0 = Conv2d(INPUT_DIM, CHANNELS[0], KERNEL_SIZES[0], padding=3,
                            bias=True, device=device)
        self.bn0 = FrozenBatchNorm2d(CHANNELS[0], device)
        self.conv1 = Conv2d(CHANNELS[0], CHANNELS[1], KERNEL_SIZES[1], padding=2,
                            bias=True, device=device)
        self.bn1 = FrozenBatchNorm2d(CHANNELS[1], device)
        self.linear = Conv2d(CHANNELS[1], output_dim, 5, padding=2, bias=True,
                             device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The distributions of `init_transform_net_params`: torch's default
        conv init for the trunk (kaiming_uniform_(a=sqrt(5)), bias bound
        1/sqrt(fan_in)), zero weights and an identity bias for the final
        layer (os2d/modeling/head.py:631-642)."""
        for conv in (self.conv0, self.conv1):
            cout, cin, kh, kw = conv.weight.shape
            fan_in = kh * kw * cin
            bound_w = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
            bound_b = 1.0 / math.sqrt(fan_in)
            dev = conv.weight.device
            conv.weight.copy_((torch.rand(conv.weight.shape, generator=generator, device=dev)
                               * 2 - 1) * bound_w)
            conv.bias.copy_((torch.rand(cout, generator=generator, device=dev) * 2 - 1) * bound_b)
        self.bn0.reset_parameters()
        self.bn1.reset_parameters()
        self.linear.weight.zero_()
        self.linear.bias.zero_()
        identity = {6: (0, 4), 4: (0, 2)}.get(self.output_dim, ())
        for i in identity:
            self.linear.bias[i] = 1.0

    def forward(self, corr_nhwc, conv0_channel_perm=None):
        """corr maps [N, H, W, 225] -> transform params [N, H, W, output_dim].

        conv0_channel_perm: the order of the 225 input channels when they are
        not the natural t = tx * 15 + ty (the head's interior-first order);
        conv0's input rows are permuted to match."""
        dtype = self.compute_dtype
        x = l2_normalize_channels(F.relu(corr_nhwc.permute(0, 3, 1, 2)), eps=1e-6, dim=1)
        w0 = self.conv0.weight
        if conv0_channel_perm is not None:
            w0 = w0[:, conv0_channel_perm]
        x = _conv_bias(self.conv0, x, dtype, w0)
        x = F.relu(x if self.bn0 is None else self.bn0(x))
        x = _conv_bias(self.conv1, x, dtype)
        x = F.relu(x if self.bn1 is None else self.bn1(x))
        return _conv_bias(self.linear, x, dtype).permute(0, 2, 3, 1)


@torch.no_grad()
def fold_batchnorm_transform_net(net: TransformNet) -> TransformNet:
    """Inference-only: a copy of `net` with both frozen BatchNorms folded into
    their convolutions, BN(conv(x, W) + b) = conv(x, W * f) + (b * f + bias -
    mean * f) (os2d_tpu/models/transform_net.py:64-84); `bn0` and `bn1` become
    None, as JAX's folded params drop their "bn*" keys. The caller's module
    is left as it was."""
    folded = copy.deepcopy(net)
    for conv, bn_name in ((folded.conv0, "bn0"), (folded.conv1, "bn1")):
        bn = getattr(folded, bn_name)
        f = bn.folding_factor()
        conv.weight = nn.Parameter(conv.weight * f[:, None, None, None], requires_grad=False)
        conv.bias = nn.Parameter(conv.bias * f + bn.bias - bn.running_mean * f,
                                 requires_grad=False)
        setattr(folded, bn_name, None)
    return folded
