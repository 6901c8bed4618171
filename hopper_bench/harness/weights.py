"""The weights of a configuration, made from the seed on the device.

`make_state_dict` draws every tensor of the model from two calls of one
`torch.Generator` on the device (a normal and a uniform draw, each as long as
all the tensors that take it), in the distributions of the configuration's
`weights` entry, under torchvision's and OS2D's key names. The harness loads
the result into the program and hands the same tensors to the reference.

A norm slot is frozen BatchNorm (weight, bias, running mean and variance)
or, where the configuration sets `"use_group_norm": true`, GroupNorm(32)
in every slot of the backbone: a weight and a bias only, drawn as a
BatchNorm slot's weight and bias are (`bn_weight`, `bn_residual_weight`,
`bn_bias_std`). The TransformNet's two norms are frozen BatchNorm in every
configuration.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch

BN_KEYS = ("weight", "bias", "running_mean", "running_var")
GN_KEYS = ("weight", "bias")
# kinds drawn uniformly in [lo, hi], by the `weights` key that gives the range
UNIFORM_RANGES = {"bn_weight": "bn_weight", "bn_residual_weight": "bn_residual_weight",
                  "bn_running_var": "bn_var"}


def param_specs(config):
    """[(name, shape, kind, fan)] of every tensor, in the model's key order;
    kind tells `make_state_dict` its distribution, fan its scale."""
    specs = []
    backbone_keys = GN_KEYS if config.get("use_group_norm", False) else BN_KEYS

    def conv(name, cin, cout, k):
        specs.append((name + ".weight", (cout, cin, k, k), "conv", k * k * cout))

    def bn(name, c, residual=False, keys=BN_KEYS):
        for key in keys:
            kind = "bn_residual_weight" if residual and key == "weight" else "bn_" + key
            specs.append((f"{name}.{key}", (c,), kind, c))

    def norm(name, c, residual=False):
        bn(name, c, residual, backbone_keys)

    conv("backbone.conv1", 3, 64, 7)
    norm("backbone.bn1", 64)
    cin = 64
    for li, (blocks, width) in enumerate(zip(config["backbone_blocks"],
                                             config["backbone_widths"])):
        for bi in range(blocks):
            p = f"backbone.layer{li + 1}.{bi}"
            conv(p + ".conv1", cin, width, 1)
            norm(p + ".bn1", width)
            conv(p + ".conv2", width, width, 3)
            norm(p + ".bn2", width)
            conv(p + ".conv3", width, width * 4, 1)
            norm(p + ".bn3", width * 4, residual=True)
            if bi == 0:
                conv(p + ".downsample.0", cin, width * 4, 1)
                norm(p + ".downsample.1", width * 4)
            cin = width * 4
    n = config["template_size"]
    k0, k1, k2 = config["transform_kernels"]
    c0, c1 = config["transform_channels"]
    for name, ci, co, k in (("conv0", n * n, c0, k0), ("conv1", c0, c1, k1)):
        specs.append((f"transform_net.{name}.weight", (co, ci, k, k), "tn_weight", ci * k * k))
        specs.append((f"transform_net.{name}.bias", (co,), "tn_bias", ci * k * k))
        bn(f"transform_net.bn{name[-1]}", co)
    out = config["transform_outputs"]
    specs.append(("transform_net.linear.weight", (out, c1, k2, k2), "linear_weight", c1 * k2 * k2))
    specs.append(("transform_net.linear.bias", (out,), "linear_bias", out))
    return specs


def identity_bias(outputs):
    """The transform parameters of the identity: [1, 0, 0, 0, 1, 0] for the
    full affine model, [1, 0, 1, 0] for the simplified one."""
    return [1.0, 0.0, 0.0, 0.0, 1.0, 0.0] if outputs == 6 else [1.0, 0.0, 1.0, 0.0]


def make_state_dict(config, seed, device):
    """{name: float32 tensor on `device`} drawn from `seed`: convolutions
    He-normal (fan out), BatchNorm's weight (the last of each residual
    branch in a smaller range), bias, running mean and variance as the
    configuration's `weights` says (a GroupNorm slot's weight and bias
    alike), the TransformNet's trunk uniform in +-1/sqrt(fan_in), its last
    layer normal around the identity transform."""
    w = config["weights"]
    specs = param_specs(config)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    normal_kinds = ("conv", "bn_bias", "bn_running_mean", "linear_weight")
    n_normal = sum(s for s, (_, _, kind, _) in zip(sizes, specs) if kind in normal_kinds)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(sum(sizes) - n_normal, generator=gen, device=device)
    state = OrderedDict()
    at_n = at_u = 0
    for (name, shape, kind, fan), size in zip(specs, sizes):
        if kind in normal_kinds:
            x, at_n = normal[at_n:at_n + size].view(shape), at_n + size
        else:
            x, at_u = uniform[at_u:at_u + size].view(shape), at_u + size
        if kind == "conv":
            x = x * math.sqrt(2.0 / fan)
        elif kind in UNIFORM_RANGES:
            lo, hi = w[UNIFORM_RANGES[kind]]
            x = lo + (hi - lo) * x
        elif kind == "bn_bias":
            x = x * w["bn_bias_std"]
        elif kind == "bn_running_mean":
            x = x * w["bn_mean_std"]
        elif kind in ("tn_weight", "tn_bias"):
            x = (2.0 * x - 1.0) / math.sqrt(fan)
        elif kind == "linear_weight":
            x = x * w["transform_linear_std"]
        elif kind == "linear_bias":
            x = torch.tensor(identity_bias(shape[0]), device=device)
        state[name] = x.contiguous()
    return state
