"""The weights of a CoAE configuration, made from the seed on the device.

As `weights.py` does for OS2D: every tensor drawn from two calls of one
`torch.Generator` on the device (a normal and a uniform draw, each as long
as all the tensors that take it), in the distributions of the
configuration's `weights` entry, under the public code's key names
(`backbone.*` torchvision's, as the port's `CoaeModel` has them). The
backbone and layer4 (`RCNN_top`) are drawn as an OS2D backbone is (He
normal convolutions, frozen BatchNorms in the configuration's ranges); the
co-attention's W and Q BatchNorms like every other slot. A kind that names
a key of `weights` holding a number is a normal draw with that standard
deviation; "fan_in" is uniform in +-1/sqrt(fan in), torch's default range
for a Linear layer.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch

from .weights import BN_KEYS, UNIFORM_RANGES

# kinds of the uniform draw; every other kind takes the normal draw
UNIFORM_KINDS = tuple(UNIFORM_RANGES) + ("fan_in",)


def param_specs(config):
    """[(name, shape, kind, fan)] of every tensor of CoaeModel's state dict,
    in its key order."""
    specs = []

    def conv(name, cin, cout, k, bias=None):
        specs.append((name + ".weight", (cout, cin, k, k), "conv" if bias is None else bias[0],
                      k * k * cout))
        if bias is not None:
            specs.append((name + ".bias", (cout,), bias[1], cin * k * k))

    def bn(name, c, residual=False):
        for key in BN_KEYS:
            kind = "bn_residual_weight" if residual and key == "weight" else "bn_" + key
            specs.append((f"{name}.{key}", (c,), kind, c))

    def bottleneck(p, cin, width, first):
        conv(p + ".conv1", cin, width, 1)
        bn(p + ".bn1", width)
        conv(p + ".conv2", width, width, 3)
        bn(p + ".bn2", width)
        conv(p + ".conv3", width, width * 4, 1)
        bn(p + ".bn3", width * 4, residual=True)
        if first:
            conv(p + ".downsample.0", cin, width * 4, 1)
            bn(p + ".downsample.1", width * 4)

    conv("backbone.conv1", 3, 64, 7)
    bn("backbone.bn1", 64)
    cin = 64
    for li, (blocks, width) in enumerate(zip(config["backbone_blocks"],
                                             config["backbone_widths"])):
        for bi in range(blocks):
            bottleneck(f"backbone.layer{li + 1}.{bi}", cin, width, bi == 0)
            cin = width * 4
    f, inter = config["feature_dim"], config["inter_channels"]
    for name in ("g", "theta", "phi"):
        conv(f"match_net.{name}", f, inter, 1, ("attention_std", "attention_bias_std"))
    for name in ("W", "Q"):
        conv(f"match_net.{name}.0", inter, f, 1, ("attention_out_std", "attention_bias_std"))
        bn(f"match_net.{name}.1", f)
    hidden = f // config["gate_reduction"]
    for i, (cin_, cout) in (("1", (f, hidden)), ("3", (hidden, f))):
        specs.append((f"match_net.ChannelGate.mlp.{i}.weight", (cout, cin_), "fan_in", cin_))
        specs.append((f"match_net.ChannelGate.mlp.{i}.bias", (cout,), "fan_in", cin_))
    n_anchors = len(config["anchor_scales"]) * len(config["anchor_ratios"])
    rpn = config["rpn_channels"]
    conv("RCNN_rpn.RPN_Conv", f, rpn, 3, ("rpn_conv_std", "rpn_bias_std"))
    conv("RCNN_rpn.RPN_cls_score", rpn, 2 * n_anchors, 1, ("rpn_cls_std", "rpn_bias_std"))
    conv("RCNN_rpn.RPN_bbox_pred", rpn, 4 * n_anchors, 1, ("rpn_bbox_std", "rpn_bias_std"))
    cin = f
    for bi in range(config["layer4_blocks"]):
        bottleneck(f"RCNN_top.{bi}", cin, config["layer4_width"], bi == 0)
        cin = config["layer4_width"] * 4
    for name, shape, std in (("RCNN_bbox_pred", (4, cin), "bbox_pred_std"),
                             ("RCNN_cls_score.0", (8, 2 * cin), "cls_score_std"),
                             ("RCNN_cls_score.1", (2, 8), "cls_score_out_std")):
        specs.append((name + ".weight", shape, std, shape[1]))
        specs.append((name + ".bias", (shape[0],), "predictor_bias_std", shape[1]))
    return specs


def make_state_dict(config, seed, device):
    """{name: float32 tensor on `device`} drawn from `seed` (see the module
    docstring)."""
    w = config["weights"]
    specs = param_specs(config)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    n_uniform = sum(s for s, (_, _, kind, _) in zip(sizes, specs) if kind in UNIFORM_KINDS)
    normal = torch.randn(sum(sizes) - n_uniform, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    state = OrderedDict()
    at_n = at_u = 0
    for (name, shape, kind, fan), size in zip(specs, sizes):
        if kind in UNIFORM_KINDS:
            x, at_u = uniform[at_u:at_u + size].view(shape), at_u + size
        else:
            x, at_n = normal[at_n:at_n + size].view(shape), at_n + size
        if kind == "conv":
            x = x * math.sqrt(2.0 / fan)
        elif kind in UNIFORM_RANGES:
            lo, hi = w[UNIFORM_RANGES[kind]]
            x = lo + (hi - lo) * x
        elif kind == "fan_in":
            x = (2.0 * x - 1.0) / math.sqrt(fan)
        elif kind == "bn_bias":
            x = x * w["bn_bias_std"]
        elif kind == "bn_running_mean":
            x = x * w["bn_mean_std"]
        else:
            x = x * w[kind]
        state[name] = x.contiguous()
    return state
