"""ResNet50/101-C4 feature extractor with frozen BatchNorm: counterpart of
`os2d_tpu/models/resnet.py` (the reference backbone,
os2d/modeling/feature_extractor.py:23-130).

torchvision ResNet v1.5 bottlenecks (stride on the 3x3 conv), stem +
layer1..3, C4 output with 1024 channels at stride 16. Parameter names follow
torchvision's (`layer1.0.conv1.weight`, `layer1.0.downsample.1.running_var`,
...), so reference checkpoints map onto the state_dict one to one. The public
layout is the JAX package's NHWC; inside, the tensors are NCHW views of NHWC
memory (channels_last), which cuDNN runs without a relayout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# number of bottleneck blocks per layer, through layer3 (C4)
RESNET_DEPTHS = {
    "resnet50": (3, 4, 6),
    "resnet101": (3, 4, 23),
}

BN_EPS = 1e-5


class Conv2d(nn.Module):
    """A convolution that owns an OIHW weight (and optionally a bias) and is
    initialized by its parent, never from the global random state."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = False, device=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device)) if bias else None

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


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

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, device=None):
        super().__init__()
        cout = width * 4
        self.conv1 = Conv2d(cin, width, 1, device=device)
        self.bn1 = FrozenBatchNorm2d(width, device)
        self.conv2 = Conv2d(width, width, 3, stride, 1, device=device)
        self.bn2 = FrozenBatchNorm2d(width, device)
        self.conv3 = Conv2d(width, cout, 1, device=device)
        self.bn3 = FrozenBatchNorm2d(cout, device)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, device=device),
                FrozenBatchNorm2d(cout, device),
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _he_normal_(weight, generator):
    # torch kaiming_normal_(mode='fan_out', nonlinearity='relu'), as the JAX
    # package's _he_conv
    cout, _, kh, kw = weight.shape
    std = math.sqrt(2.0 / (kh * kw * cout))
    weight.copy_(std * torch.randn(weight.shape, generator=generator,
                                   device=weight.device))


class ResNetC4(nn.Module):
    """images [N, H, W, 3] (already normalized) -> C4 features
    [N, ceil(H/16), ceil(W/16), 1024]."""

    def __init__(self, arch: str = "resnet50", device=None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, device=device)
        self.bn1 = FrozenBatchNorm2d(64, device)
        cin = 64
        for li, (blocks, width) in enumerate(zip(RESNET_DEPTHS[arch], (64, 128, 256))):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(cin, width, stride if bi == 0 else 1, device))
                cin = width * 4
            self.add_module(f"layer{li + 1}", nn.Sequential(*layer))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """He-normal convolutions and identity BatchNorms, the distributions of
        `init_resnet_c4_params` (the numbers differ from JAX's)."""
        for module in self.modules():
            if isinstance(module, Conv2d):
                _he_normal_(module.weight, generator)
            elif isinstance(module, FrozenBatchNorm2d):
                module.reset_parameters()

    def forward(self, images_nhwc):
        x = images_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)  # pads with -inf
        x = self.layer3(self.layer2(self.layer1(x)))
        return x.permute(0, 2, 3, 1)
