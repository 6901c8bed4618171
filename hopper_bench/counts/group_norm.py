"""GroupNorm's bytes from shapes: the slots of a GroupNorm ResNet-C4
backbone, and the least memory traffic of their forward and backward.

A slot's forward reads x and writes y, reads the weight and the bias and
writes the statistics (a mean and a reciprocal standard deviation per
sample and group); its backward reads x and dy and writes dx, reads the
weight and the statistics and writes the weight's and the bias's
gradients. Each byte is counted once, fp32 throughout (counts/flops.py's
rule for a kernel's bytes).
"""

from __future__ import annotations

from .flops import half_up

GROUPS = 32

# substrings of the names of the kernels that compute GroupNorm on the card:
# the port's channels-last kernels (os2d_torch/csrc/group_norm_nhwc.cu) and
# ATen's (its moments, fused parameters, internal gradients, gamma/beta
# gradients and the elementwise kernels of its GroupNorm functions)
KERNEL_KEYS = ("GroupNorm", "RowwiseMomentsCUDAKernel", "ComputeFusedParamsCUDAKernel",
               "ComputeInternalGradientsCUDAKernel", "ComputeBackwardFusedParamsCUDAKernel",
               "GammaBetaBackwardCUDAKernel")


def is_group_norm_kernel(name: str) -> bool:
    return any(k in name for k in KERNEL_KEYS)


def group_norm_slots(config, h, w):
    """[(channels, h_out, w_out)] of every norm slot of the ResNet-C4
    backbone on one h x w image, in the order the forward runs them: the
    stem's, then per bottleneck bn1, bn2, bn3 and the downsample's."""
    h, w = half_up(h), half_up(w)
    out = [(64, h, w)]
    h, w = half_up(h), half_up(w)  # max pool
    for li, (blocks, width) in enumerate(zip(config["backbone_blocks"],
                                             config["backbone_widths"])):
        for bi in range(blocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            ho, wo = (half_up(h), half_up(w)) if stride == 2 else (h, w)
            out += [(width, h, w), (width, ho, wo), (width * 4, ho, wo)]
            if bi == 0:
                out.append((width * 4, ho, wo))
            h, w = ho, wo
    return out


def slot_bytes(n, c, h, w, groups=GROUPS):
    """(forward bytes, backward bytes) of one slot on n images."""
    size = n * c * h * w
    return 4 * (2 * size + 2 * c + 2 * n * groups), 4 * (3 * size + 3 * c + 2 * n * groups)


def padded_classes(traffic):
    """The class pass's images: the mix's classes padded to its multiple,
    as `harness/drivers/train_steps.py: padded_classes` pads them."""
    m, c = traffic["class_pad_multiple"], traffic["classes"]
    return max(m, -(-c // m) * m)


def train_bytes_per_step(config, traffic):
    """The least bytes of every slot's forward and backward in one training
    step: the scene pass (batch x patch) and the class pass (the padded
    class count x class image size)."""
    total = 0
    for n, side in ((traffic["batch"], traffic["patch"]),
                    (padded_classes(traffic), traffic["class_image_size"])):
        for c, h, w in group_norm_slots(config, side, side):
            total += sum(slot_bytes(n, c, h, w))
    return total
