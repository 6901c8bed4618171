"""TransformationNet, the weakalign-style affine-parameter regressor:
counterpart of `os2d_tpu/models/transform_net.py` (the reference's
os2d/modeling/head.py:604-661).

[ReLU -> L2-norm(channels)] -> Conv7x7(225->128)+BN+ReLU ->
Conv5x5(128->64)+BN+ReLU -> Conv5x5(64->out), all padded to keep the spatial
size; the final layer is zero-init with an identity-transform bias. BatchNorm
runs frozen, as the reference training recipe freezes it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.geometry import l2_normalize_channels
from .resnet import Conv2d, FrozenBatchNorm2d

KERNEL_SIZES = (7, 5)
CHANNELS = (128, 64)
INPUT_DIM = 15 * 15


class TransformNet(nn.Module):
    def __init__(self, output_dim: int = 6, device=None):
        super().__init__()
        self.output_dim = output_dim
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
        x = l2_normalize_channels(F.relu(corr_nhwc.permute(0, 3, 1, 2)), eps=1e-6, dim=1)
        w0 = self.conv0.weight
        if conv0_channel_perm is not None:
            w0 = w0[:, conv0_channel_perm]
        x = F.relu(self.bn0(F.conv2d(x, w0, self.conv0.bias, padding=self.conv0.padding)))
        x = F.relu(self.bn1(self.conv1(x)))
        return self.linear(x).permute(0, 2, 3, 1)
