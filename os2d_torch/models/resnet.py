"""ResNet50/101-C4 feature extractor with frozen BatchNorm or GroupNorm(32):
counterpart of `os2d_tpu/models/resnet.py` (the reference backbone,
os2d/modeling/feature_extractor.py:23-130).

torchvision ResNet v1.5 bottlenecks (stride on the 3x3 conv), stem +
layer1..3, C4 output with 1024 channels at stride 16. Parameter names follow
torchvision's (`layer1.0.conv1.weight`, `layer1.0.downsample.1.running_var`,
...), so reference checkpoints map onto the state_dict one to one. The public
layout is the JAX package's NHWC; inside, the tensors are NCHW views of NHWC
memory (channels_last). With fp32 and TF32 off cuDNN has only NCHW kernels
for them, so it transposes the activations around each convolution
(`nhwcToNchwKernel`, `nchwToNhwcKernel` in a trace); the port's own kernels
(frozen BatchNorm, GroupNorm) read the channels-last memory as it is.

Compute dtype (`Os2dConfig.compute_dtype`), as the JAX package rounds: each
convolution casts its input and weight to the compute dtype and outputs in
it; a frozen BatchNorm computes in fp32 (so with bfloat16 the residual sums
and the C4 output are fp32). `fold_batchnorm_c4` folds every BatchNorm into
its convolution for inference; a folded bias is rounded to the compute dtype
and added in it, so the folded bfloat16 backbone is bfloat16 end to end.

Each frozen BatchNorm slot (`FrozenBatchNorm2d`, defined in
`ops/frozen_bn.py`) with its ReLU, and bn3 with a bottleneck's residual add,
goes through `ops/frozen_bn.py: frozen_bn_act`: one CUDA kernel launch a
slot on the card where no gradient is recorded, ATen's eager chain
elsewhere, the two equal to the bit.

With `use_group_norm` every normalization is GroupNorm(32) (the reference's
alternative, feature_extractor.py:96-105; os2d_tpu/models/resnet.py:70-77):
statistics of the activations over (H, W, C/32) in fp32, eps 1e-5, a weight
and a bias (state_dict keys `<bn>.weight`, `<bn>.bias`, no running stats),
fp32 output in every compute dtype. It depends on the activations and does
not fold. On the card it runs the port's channels-last kernels
(`ops/group_norm.py`, `csrc/group_norm_nhwc.cu`: Welford statistics merged
by Chan's rule in a fixed order, channels-last in and out, a repeatable
backward); on the CPU, F.group_norm (two-pass statistics).

Every convolution of the port goes through `conv2d`, whose fp32 gradients
repeat to the bit on the card (`conv2d_backward`: the 1x1 weight gradients
as per-image cuBLAS GEMMs in a fixed sum, cuDNN's deterministic algorithms
for the gradients whose default algorithms add with atomics), so that
training repeats at a seed.

`build_layer4` is torchvision's layer4 (width 512, 2048 channels, stride 2
on its first block's 3x3): the top of `ResNetClassifier` and CoAE's RoI head
(models/coae.py). `ResNetClassifier` is the full torchvision ResNet50/101
(layer4, global average pooling, fc) that the ImageNet pretrainer trains
(os2d_tpu/models/resnet.py:167-266), with BatchNorm in train mode as JAX
defines it (`batch_norm_train`: F.batch_norm in one process, the global
batch's statistics over a mesh); its state_dict has torchvision's keys, so
its trunk loads into `ResNetC4` as it is.
"""

from __future__ import annotations

import contextlib
import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.frozen_bn import BN_EPS, FrozenBatchNorm2d, frozen_bn_act
from ..ops.group_norm import group_norm
from ..parallel.mesh import all_reduce_sum
from ..utils.profiling import annotate

# number of bottleneck blocks per layer, through layer3 (C4)
RESNET_DEPTHS = {
    "resnet50": (3, 4, 6),
    "resnet101": (3, 4, 23),
}

# full classifier depths (layer4 included) for ImageNet pretraining
RESNET_FULL_DEPTHS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}

GROUPNORM_NUMGROUPS = 32


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms (no heuristic search) for the block;
    the two flags are process-global and autograd runs a CUDA backward on a
    thread of its own, so they are restored on every exit."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


# the shortest run of an image's rows in one product of `wgrad_1x1_gemm`
WGRAD_MIN_ROWS = 2048


def _tree_sum(t):
    """t summed over its first dim in a fixed pairwise tree: adjacent pairs
    added level by level, an odd last one carried up a level."""
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t[:-1].view(-1, 2, *t.shape[1:]).sum(1), t[-1:]])
        else:
            t = t.view(-1, 2, *t.shape[1:]).sum(1)
    return t[0]


def wgrad_1x1_gemm(grad, x, stride: int = 1):
    """The weight gradient of a 1x1 convolution without padding, in x's
    dtype (a stride takes every stride-th row and column of x), summed so
    that over a batch of 2^k images it is the sum of its two halves' sums,
    as a data-parallel step over two ranks adds them (parallel/mesh.py):
    each image's rows are cut into the most runs, a power of two, of at
    least WGRAD_MIN_ROWS rows, one batched cuBLAS GEMM takes every run's
    [rows, Cout]^T x [rows, Cin] product, and `_tree_sum` adds them in
    image order."""
    xs = x[:, :, ::stride, ::stride] if stride > 1 else x
    n, cout, cin = grad.shape[0], grad.shape[1], x.shape[1]
    rows = grad.shape[2] * grad.shape[3]
    runs = 1
    while rows % (2 * runs) == 0 and rows // (2 * runs) >= WGRAD_MIN_ROWS:
        runs *= 2
    g3 = grad.permute(0, 2, 3, 1).reshape(n * runs, rows // runs, cout)
    x3 = xs.permute(0, 2, 3, 1).reshape(n * runs, rows // runs, cin)
    return _tree_sum(torch.bmm(g3.transpose(1, 2), x3)).view(cout, cin, 1, 1)


def dgrad_by_phases(grad, weight, stride: int, padding: int, x):
    """The input gradient of conv2d(x, weight, stride=stride,
    padding=padding) as stride**2 forward convolutions of `grad`, one for
    each phase (i mod stride, j mod stride) of x's rows and columns, each
    with the taps of `weight` that reach that phase (flipped, channels
    swapped); returned in x's shape, dtype and memory format."""
    s, p = stride, padding
    kh, kw = weight.shape[2:]
    h, w = x.shape[2:]
    swapped = weight.transpose(0, 1)
    dx = torch.empty_like(x)
    for a in range(min(s, h)):
        for b in range(min(s, w)):
            rows, cols = len(range(a, h, s)), len(range(b, w, s))
            ka, kb = (a + p) % s, (b + p) % s
            if ka >= kh or kb >= kw:
                dx[:, :, a::s, b::s] = 0
                continue
            taps = swapped[:, :, ka::s, kb::s].flip(2, 3)
            ta, tb = taps.shape[2:]
            # phase row m takes grad rows m + (a + p - ka) / s - t, t < ta
            top, left = ta - 1 - (a + p - ka) // s, tb - 1 - (b + p - kb) // s
            bottom = rows + ta - 1 - grad.shape[2] - top
            right = cols + tb - 1 - grad.shape[3] - left
            dx[:, :, a::s, b::s] = F.conv2d(F.pad(grad, (left, right, top, bottom)), taps)
    return dx


def conv2d_backward(grad, x, weight, has_bias: bool, stride: int, padding: int, output_mask):
    """(dx, dweight, dbias) of conv2d(x, weight, bias, stride, padding) for
    the cotangent `grad`, each None where `output_mask` does not ask for it.

    On the card the gradients repeat to the bit from run to run. cuDNN's
    default fp32 algorithms do not: its ALGO_0 kernels add partial sums with
    atomics (tools/trace_conv_determinism_torch.py, PERF.md). So, by the
    convolution's shape: a weight gradient of a 1x1 convolution is
    `wgrad_1x1_gemm`'s (cuBLAS, in a fixed sum); the input gradient of a
    strided kernel larger than 1x1 is `dgrad_by_phases`' (forward
    convolutions, which cuDNN runs without atomics; its deterministic
    input-gradient algorithm there is an FFT several times slower); any
    other weight gradient, and the input gradient of any other kernel
    larger than 1x1 (whose windows overlap), run cuDNN's deterministic
    algorithms; the input gradient of a 1x1 convolution, where each input
    element takes one window's terms, stays on cuDNN's default algorithm.
    On the CPU every gradient is ATen's one `convolution_backward`, as
    autograd takes it."""
    bias_sizes = [weight.shape[0]] if has_bias else None

    def aten(mask):
        return torch.ops.aten.convolution_backward(
            grad, x, weight, bias_sizes, [stride, stride], [padding, padding], [1, 1], False,
            [0, 0], 1, mask)

    if grad.device.type != "cuda":
        return aten(list(output_mask))
    return _repeatable_backward(aten, grad, x, weight, stride, padding, output_mask)


def _repeatable_backward(aten, grad, x, weight, stride, padding, output_mask):
    """conv2d_backward's rule on the card; `aten(mask)` is ATen's
    convolution_backward of the same convolution."""
    need_dx, need_dw, need_db = output_mask
    if tuple(weight.shape[2:]) == (1, 1) and padding == 0:
        dx = aten([True, False, False])[0] if need_dx else None
        dw = wgrad_1x1_gemm(grad, x, stride) if need_dw else None
        return dx, dw, grad.sum((0, 2, 3)) if need_db else None
    dx = None
    if need_dx and stride > 1:
        dx, need_dx = dgrad_by_phases(grad, weight, stride, padding, x), False
    with _cudnn_deterministic():
        out = aten([need_dx, need_dw, need_db])
    return dx if dx is not None else out[0], out[1], out[2]


class _RepeatableConv2d(torch.autograd.Function):
    """F.conv2d whose backward is `conv2d_backward`: the forward is the
    convolution as it is, to the bit."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conv = (bias is not None, stride, padding)
        return F.conv2d(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        dx, dw, db = conv2d_backward(grad, x, weight, *ctx.conv, ctx.needs_input_grad[:3])
        return dx, dw, db, None, None


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 0):
    """F.conv2d(x, weight, bias, stride, padding); every convolution of the
    port goes through here. Where autograd records an fp32 convolution, its
    gradients are `conv2d_backward`'s, which repeat to the bit on the card.
    A bf16 convolution keeps F.conv2d's own gradients: cuDNN's bf16 kernels
    repeat to the bit as they are (the trace of PERF.md, the pretrainer's
    and the bf16 TrainStep's convolutions)."""
    if x.dtype == torch.float32 and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _RepeatableConv2d.apply(x, weight, bias, stride, padding)
    return F.conv2d(x, weight, bias, stride, padding)


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

    def forward(self, x, dtype=torch.float32):
        """The convolution on x and the weight cast to `dtype`, output in it."""
        return conv2d(x.to(dtype), self.weight.to(dtype), self.bias, self.stride, self.padding)


class GroupNorm2d(nn.Module):
    """GroupNorm(32) over the channels of an NCHW tensor (a view of
    channels-last memory), as the JAX package's `_norm` computes it for a
    slot without running statistics: the statistics and the output in fp32,
    eps 1e-5, on the fp32 input (`ops/group_norm.py: group_norm`).

    On the card the port's kernels compute it, on channels-last memory (as
    every slot of `ResNetC4` has it; other input is copied to it first), and
    keep the layout: per sample and group the mean and biased variance over
    (H, W, C/32) by Welford's running moments, each thread's over its rows,
    merged by Chan's rule in a fixed order (the block's rows, the group's
    channels, then the chunks of rows in a fixed tree); the backward's sums
    in a fixed order, so it repeats to the bit. On the CPU F.group_norm
    computes it (counted in `ops.group_norm.fallbacks`), with two-pass
    statistics: JAX's up to the order of the fp32 sums
    (tests/test_torch_group_norm.py holds the C4 features to JAX's within
    rtol and atol 1e-4)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return group_norm(x.float(), GROUPNORM_NUMGROUPS, self.weight, self.bias, BN_EPS)


class FoldedBatchNorm2d(nn.Module):
    """What remains of a frozen BatchNorm folded into the preceding
    convolution (`fold_batchnorm_c4`): a bias, `folded_bias`, rounded to the
    input's dtype and added in it (os2d_tpu/models/resnet.py:59-64)."""

    def __init__(self, folded_bias):
        super().__init__()
        self.folded_bias = nn.Parameter(folded_bias, requires_grad=False)

    def forward(self, x):
        return x + self.folded_bias.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, device=None,
                 norm=FrozenBatchNorm2d):
        super().__init__()
        cout = width * 4
        self.conv1 = Conv2d(cin, width, 1, device=device)
        self.bn1 = norm(width, device)
        self.conv2 = Conv2d(width, width, 3, stride, 1, device=device)
        self.bn2 = norm(width, device)
        self.conv3 = Conv2d(width, cout, 1, device=device)
        self.bn3 = norm(cout, device)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, device=device),
                norm(cout, device),
            )

    def forward(self, x, dtype=torch.float32):
        """Each norm with its ReLU, and bn3 with the residual add, through
        `ops/frozen_bn.py: frozen_bn_act` (one kernel launch a slot where it
        applies)."""
        out = frozen_bn_act(self.conv1(x, dtype), self.bn1)
        out = frozen_bn_act(self.conv2(out, dtype), self.bn2)
        out = self.conv3(out, dtype)
        if self.downsample is None:
            return frozen_bn_act(out, self.bn3, x)
        return frozen_bn_act(out, self.bn3, self.downsample[0](x, dtype), self.downsample[1])


def _he_normal_(weight, generator):
    # torch kaiming_normal_(mode='fan_out', nonlinearity='relu'), as the JAX
    # package's _he_conv
    cout, _, kh, kw = weight.shape
    std = math.sqrt(2.0 / (kh * kw * cout))
    weight.copy_(std * torch.randn(weight.shape, generator=generator,
                                   device=weight.device))


def build_layer4(arch: str = "resnet50", device=None, cin: int = 1024) -> nn.Sequential:
    """torchvision's layer4 of `arch` on C4 features of `cin` channels:
    RESNET_FULL_DEPTHS[arch][3] frozen-BatchNorm bottlenecks of width 512
    (2048 channels), the first with stride 2 on its 3x3 and a downsample.
    Its parent initializes it."""
    blocks = []
    for bi in range(RESNET_FULL_DEPTHS[arch][3]):
        blocks.append(Bottleneck(cin, 512, 2 if bi == 0 else 1, device))
        cin = 2048
    return nn.Sequential(*blocks)


class ResNetC4(nn.Module):
    """images [N, H, W, 3] (already normalized) -> C4 features
    [N, ceil(H/16), ceil(W/16), 1024]; each call runs in span
    `os2d.backbone`."""

    def __init__(self, arch: str = "resnet50", device=None, compute_dtype=torch.float32,
                 use_group_norm: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        norm = GroupNorm2d if use_group_norm else FrozenBatchNorm2d
        self.conv1 = Conv2d(3, 64, 7, 2, 3, device=device)
        self.bn1 = norm(64, device)
        cin = 64
        for li, (blocks, width) in enumerate(zip(RESNET_DEPTHS[arch], (64, 128, 256))):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(cin, width, stride if bi == 0 else 1, device, norm))
                cin = width * 4
            self.add_module(f"layer{li + 1}", nn.Sequential(*layer))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """He-normal convolutions, identity BatchNorms and GroupNorms (weight
        1, bias 0), the distributions of `init_resnet_c4_params` (the numbers
        differ from JAX's)."""
        for module in self.modules():
            if isinstance(module, Conv2d):
                _he_normal_(module.weight, generator)
            elif isinstance(module, (FrozenBatchNorm2d, GroupNorm2d)):
                module.reset_parameters()

    def blocks(self):
        """The bottlenecks of layer1..3 in order."""
        return (*self.layer1, *self.layer2, *self.layer3)

    def stem(self, x):
        """conv1, bn1, ReLU and the 3x3 max pool on NCHW x."""
        x = frozen_bn_act(self.conv1(x, self.compute_dtype), self.bn1)
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)  # pads with -inf

    def forward(self, images_nhwc):
        with annotate("os2d.backbone"):
            x = self.stem(images_nhwc.permute(0, 3, 1, 2))
            for block in self.blocks():
                x = block(x, self.compute_dtype)
            return x.permute(0, 2, 3, 1)


def _fold_conv_bn(conv: Conv2d, bn):
    """Scales conv's output channels by bn's factor f in place and returns
    the remaining bias - mean * f (os2d_tpu/models/resnet.py:94-109), fp32.
    A GroupNorm depends on the activations and cannot fold: it is returned
    as it is, and conv is left alone."""
    if isinstance(bn, GroupNorm2d):
        return bn
    f = bn.folding_factor()
    conv.weight = nn.Parameter(conv.weight * f[:, None, None, None], requires_grad=False)
    return FoldedBatchNorm2d(bn.bias - bn.running_mean * f)


@torch.no_grad()
def fold_batchnorm_c4(backbone: ResNetC4) -> ResNetC4:
    """Inference-only: a copy of `backbone` with every frozen BatchNorm
    folded into its convolution (os2d_tpu/models/resnet.py:112-144); the
    caller's module is left as it was. The BatchNorm slots become
    `FoldedBatchNorm2d` (state_dict key `<bn>.folded_bias`); GroupNorm slots
    stay as they are. Folded weights are not for training: the fold freezes
    the statistics into them."""
    folded = copy.deepcopy(backbone)
    folded.bn1 = _fold_conv_bn(folded.conv1, folded.bn1)
    for block in folded.blocks():
        for i in (1, 2, 3):
            setattr(block, f"bn{i}", _fold_conv_bn(getattr(block, f"conv{i}"),
                                                   getattr(block, f"bn{i}")))
        if block.downsample is not None:
            block.downsample[1] = _fold_conv_bn(block.downsample[0], block.downsample[1])
    return folded


def batch_norm_train(x, bn: FrozenBatchNorm2d, mesh=None, momentum: float = 0.1):
    """BatchNorm in train mode as the JAX package defines it
    (os2d_tpu/models/resnet.py:178-192) on NCHW x: in fp32 (whatever the
    convolutions' dtype), with the batch's mean and biased variance, and new
    running statistics by torch's momentum rule, run = (1 - m) * run +
    m * batch, from the unbiased variance. Without a mesh that is
    F.batch_norm in training mode (one fused kernel on the card), run on
    copies of the running statistics. Over a `mesh` the statistics are the
    global batch's, as a jnp.mean over a batch sharded on a mesh computes
    them: two passes, each pass's sum summed over the ranks
    (differentiably), with every rank holding an equal share of rows.
    Returns (y, new running mean, new running var), the last two detached.
    An fp64 input computes in fp64."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if mesh is None:
        new_mean, new_var = (t.detach().to(xf.dtype, copy=True)
                             for t in (bn.running_mean, bn.running_var))
        y = F.batch_norm(xf, new_mean, new_var, bn.weight.to(xf.dtype), bn.bias.to(xf.dtype),
                         training=True, momentum=momentum, eps=BN_EPS)
        return y, new_mean, new_var
    n = x.shape[0] * x.shape[2] * x.shape[3]
    total, n = all_reduce_sum(mesh, xf.sum(dim=(0, 2, 3))), n * mesh.size
    mean = total / n
    centered = xf - mean[:, None, None]
    var = all_reduce_sum(mesh, centered.square().sum(dim=(0, 2, 3))) / n
    with torch.no_grad():
        unbiased = var * n / max(n - 1, 1)
        new_mean = (1 - momentum) * bn.running_mean + momentum * mean
        new_var = (1 - momentum) * bn.running_var + momentum * unbiased
    inv = torch.rsqrt(var + BN_EPS)
    y = centered * inv[:, None, None] * bn.weight[:, None, None] + bn.bias[:, None, None]
    return y, new_mean, new_var


class Linear(nn.Module):
    """y = x @ weight.T + bias, weight [out, in] as torchvision's fc; its
    parent initializes it."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class ResNetClassifier(ResNetC4):
    """The full ResNet classifier (os2d_tpu/models/resnet.py:167-266):
    ResNetC4's stem and layer1..3, layer4 (width 512, 2048 channels, stride
    2 on its first block), global average pooling and an fc layer. Frozen
    BatchNorm only (the pretrainer's; no GroupNorm). All four tensors of
    each BatchNorm are parameters, as they are leaves of JAX's params: the
    pretrainer's optimizer updates the running statistics too."""

    def __init__(self, arch: str = "resnet101", num_classes: int = 1000, device=None,
                 compute_dtype=torch.float32):
        super().__init__(arch, device, compute_dtype)
        self.layer4 = build_layer4(arch, device)
        self.fc = Linear(2048, num_classes, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """`init_resnet_classifier_params`' distributions: He-normal
        convolutions, identity BatchNorms, fc uniform in +-1/sqrt(2048) and
        a zero bias (the numbers differ from JAX's)."""
        super().reset_parameters(generator)
        bound = 1.0 / math.sqrt(2048)
        self.fc.weight.uniform_(-bound, bound, generator=generator)
        self.fc.bias.zero_()

    def forward(self, images_nhwc, train_bn: bool = False, mesh=None, bn_momentum: float = 0.1,
                compute_dtype=None):
        """images [N, H, W, 3] (normalized) -> (logits [N, num_classes] in
        fp32, new running statistics), as `resnet_classifier_forward`: the
        convolutions in `compute_dtype` (default the module's), each
        BatchNorm in fp32. With train_bn the BatchNorms normalize with batch
        statistics (`batch_norm_train`, global over `mesh`), and the second
        result maps each BatchNorm's module name to its (new running mean,
        new running var); without, they use their running statistics and it
        is empty. The module's tensors are not changed."""
        dtype = compute_dtype or self.compute_dtype
        stats = {}

        def norm_train(x, name):
            y, mean, var = batch_norm_train(x, self.get_submodule(name), mesh, bn_momentum)
            stats[name] = (mean, var)
            return y

        norm = norm_train if train_bn else (lambda x, name: self.get_submodule(name)(x))
        x = F.relu(norm(self.conv1(images_nhwc.permute(0, 3, 1, 2), dtype), "bn1"))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for layer in ("layer1", "layer2", "layer3", "layer4"):
            for i, block in enumerate(getattr(self, layer)):
                base = f"{layer}.{i}."
                out = F.relu(norm(block.conv1(x, dtype), base + "bn1"))
                out = F.relu(norm(block.conv2(out, dtype), base + "bn2"))
                out = norm(block.conv3(out, dtype), base + "bn3")
                identity = x if block.downsample is None else norm(
                    block.downsample[0](x, dtype), base + "downsample.1")
                x = F.relu(out + identity)
        return self.fc(x.mean(dim=(2, 3))), stats
