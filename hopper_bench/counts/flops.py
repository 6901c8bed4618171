"""Operations and bytes from shapes.

Model FLOPs count each multiply-add of a convolution or a matrix product
as two operations and the resample by its operations per template-point
sample; elementwise work (BatchNorm, ReLU, normalization) is not counted.
A kernel's bytes count each input byte read once and each output byte
written once. Peaks come from peaks.json.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())

# operations per template-point sample of the hat resample: floor x2, four
# hat weights (two subtracts and a max each), four mask products, four row
# products and two row sums, two column products and their sum, the
# accumulate (chip_smoke.py's HAT_FLOPS_PER_SAMPLE)
HAT_OPS_PER_SAMPLE = 28
# and of its backward: the hat weights and derivatives of 4 rows and 4
# columns, dpx, dpy, the 4 dcorr products and the two cotangent products
# (chip_smoke.py's BACKWARD_FLOPS_PER_SAMPLE)
BACKWARD_OPS_PER_SAMPLE = 90


def half_up(x: int) -> int:
    """A stride-2 convolution's (or pool's) output side: ceil(x / 2)."""
    return (x + 1) // 2


def conv_flops(cin, cout, k, h_out, w_out):
    return 2 * cin * cout * k * k * h_out * w_out


def backbone_convs(config, h, w):
    """[(flops, needs_input_grad)] of every convolution of the ResNet-C4
    backbone on one h x w image (the stem's input is the image)."""
    out = []
    h, w = half_up(h), half_up(w)
    out.append((conv_flops(3, 64, 7, h, w), False))
    h, w = half_up(h), half_up(w)  # max pool
    cin = 64
    for li, (blocks, width) in enumerate(zip(config["backbone_blocks"],
                                             config["backbone_widths"])):
        for bi in range(blocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            ho, wo = (half_up(h), half_up(w)) if stride == 2 else (h, w)
            out.append((conv_flops(cin, width, 1, h, w), True))
            out.append((conv_flops(width, width, 3, ho, wo), True))
            out.append((conv_flops(width, width * 4, 1, ho, wo), True))
            if bi == 0:
                out.append((conv_flops(cin, width * 4, 1, ho, wo), True))
            h, w, cin = ho, wo, width * 4
    return out


def feature_map(h, w):
    for _ in range(4):
        h, w = half_up(h), half_up(w)
    return h, w


def backbone_flops(config, h, w):
    return sum(f for f, _ in backbone_convs(config, h, w))


def head_flops_per_anchor_class(config):
    """The correlation, the TransformNet and the resample of one anchor of
    one class."""
    n, f = config["template_size"], config["feature_dim"]
    t_int = (n - 2 * config["pool_border"]) ** 2
    k0, k1, k2 = config["transform_kernels"]
    c0, c1 = config["transform_channels"]
    corr = 2 * n * n * f
    tnet = 2 * (k0 * k0 * n * n * c0 + k1 * k1 * c0 * c1 + k2 * k2 * c1
                * config["transform_outputs"])
    return corr + tnet + HAT_OPS_PER_SAMPLE * t_int


def level_sizes(traffic):
    """(w, h) of each pyramid level of an eval mix."""
    return [(int(traffic["image_w"] * s), int(traffic["image_h"] * s))
            for s in traffic["pyramid_scales"]]


def eval_flops_per_image(config, traffic):
    """One image at every level, the classes of the mix (no padding)."""
    total = 0
    for w, h in level_sizes(traffic):
        fh, fw = feature_map(h, w)
        total += backbone_flops(config, h, w)
        total += head_flops_per_anchor_class(config) * fh * fw * traffic["classes"]
    return total


def train_flops_per_step(config, traffic):
    """Forward and backward of one step on the mix's real classes: the
    backward of a convolution or a product is twice its forward (input and
    weight gradients), once where its input takes no gradient (the stem on
    the images); the resample's backward by its own operations."""
    b, side, c = traffic["batch"], traffic["patch"], traffic["classes"]
    ci = traffic["class_image_size"]
    fwd = bwd = 0
    for n_img, size in ((b, side), (c, ci)):
        for flops, needs_dx in backbone_convs(config, size, size):
            fwd += n_img * flops
            bwd += n_img * flops * (2 if needs_dx else 1)
    fh, fw = feature_map(side, side)
    n = config["template_size"]
    t_int = (n - 2 * config["pool_border"]) ** 2
    head = head_flops_per_anchor_class(config) - HAT_OPS_PER_SAMPLE * t_int
    anchors = b * c * fh * fw
    fwd += anchors * (head + HAT_OPS_PER_SAMPLE * t_int)
    bwd += anchors * (2 * head + BACKWARD_OPS_PER_SAMPLE * t_int)
    return fwd + bwd


def compute_peak_flops(config):
    """The card's published dense peak of the configuration's compute dtype
    (peaks.json "<compute_dtype>_flops"): float32 outside the tensor cores,
    since the port turns TF32 off, or bfloat16."""
    return PEAKS[f"{config['compute_dtype']}_flops"]


def bound_s(bytes_, ops, flops_peak=None):
    """The least time: the larger of bytes over HBM bandwidth and operations
    over the fp32 peak."""
    peak = flops_peak or PEAKS["float32_flops"]
    return max(bytes_ / PEAKS["hbm_bytes_per_s"], ops / peak)


def hat_bytes_ops(b, c, a, t):
    """The hat resample kernel on B images, C classes, A anchors and T
    template points: the fp32 corr prefix, px and py read, the mask read,
    the scores written; its operations."""
    return 4 * (3 * b * c * t * a + c * t + b * c * a), HAT_OPS_PER_SAMPLE * b * c * t * a


def backward_bytes_ops(b, c, a, t, t_full):
    """The resample backward: dcorr (all t_full channels) written, the corr
    prefix, px and py read, dpx and dpy written, the two cotangents and the
    mask read; its operations."""
    bytes_ = 4 * (b * c * a * t_full + b * c * a * t + 4 * b * c * t * a + 2 * b * c * a + c * t)
    return bytes_, BACKWARD_OPS_PER_SAMPLE * b * c * t * a
