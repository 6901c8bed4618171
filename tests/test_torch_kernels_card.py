"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode: without a card every test here skips. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_card.py -q

Gather kernel (`csrc/resample.cu`): rounds each product and sum as the
plain version does, in the same order, so on the card the two agree to the
bit; that is asserted, beside the tolerance (rtol 1e-5, atol 1e-6) that the
plain version meets against JAX.

Hat kernel (`csrc/hat_resample.cu`): sums the two non-zero hat rows and
columns of each sample with the plain version's roundings, so the two agree
to the bit as well; it is held to rtol 1e-5, atol 1e-5, and to within 4e-3
(the `"default"` prescreen margin) of the exact gather.

int8 kernel (`csrc/int8_hat_resample.cu`): quantizes each corner as it
reads it and sums the two non-zero rows and columns of each sample with the
plain version's roundings, so the two agree to the bit (asserted beside
rtol 1e-5, atol 1e-6), from px/py on the forward cases, half-way hat
weights and B*C above 65535, and from theta (forming px/py in registers
with the card's roundings of the head's chain) on the ragged shapes and
every bench level with identity, near-identity, random and
outside-the-map theta; the int8 head on the card equals the CPU's, and
with a graph recorded it runs the hat kernel instead.

Backward (`csrc/resample_backward.cu`: a scatter kernel, a dcorr kernel and
a transpose kernel behind one entry point): computes dpx and dpy with the
plain version's roundings in its order, so those agree to the bit (asserted
beside rtol 1e-5, atol 1e-6); dcorr adds each cell's terms one at a time in
the plain version's order, with no two threads adding into one value, so it
equals the plain version run on the CPU to the bit (the card's
scatter_add_ keeps no order: against the plain version on the card it is
held to rtol 1e-5, atol 1e-6), with its channels >= T exactly zero, and two
calls agree to the bit. Cases: the ragged shapes, the training shape (B=4,
C=16, 38x38, T=121 of 225) on uniform, near-identity, exact identity and
collapsed inputs, integer coordinates and the borders, t_full 128 and
t_full == T, B*C above 65535, and two calls in a row. Two 3-step runs of
TrainStep from one seed give the same weights to the bit under
cudnn.deterministic (cuDNN's default algorithms sum the convolutions'
gradients in no fixed order).

The yuv420 wire (ops/pixel_format.py): its decode on the card equals the
CPU's; an eval dispatch on a wire uploaded to the card launches the hat
kernel and detects as on the CPU. The pretrainer's step (pretrain/, cuDNN
and cuBLAS, no hand kernel) on the card against the CPU.

Two kinds of inputs bracket the kernels' memory traffic: "uniform" px/py
spread over the whole map (almost no corr sector is used twice), and
"near_identity" px/py, the anchor's position plus the template offset of
the head's identity transform plus a small jitter (the 8 anchors of one
tile column share each sector, as on the main path); "outside" reaches 0.5
past the borders. The backward also takes "identity", the same without
jitter (a train step's first inputs), and "collapsed", every sample of a
(b, c) plane on one point (non-integer where the map is wider than one
cell): all of a plane's adds land on four cells.
"""

import pytest
import torch

from os2d_torch.ops import hat_resample, int8_resample, resample, resample_grad
from os2d_torch.ops.sampling import (
    hat_resample_reference,
    int8_hat_resample_reference,
    resample_backward_reference,
    resample_correlation_from_pxpy_reference,
)

RTOL, ATOL = 1e-5, 1e-6
HAT_RTOL, HAT_ATOL = 1e-5, 1e-5
DEFAULT_TIER_MARGIN = 4e-3
INT8_HEAD_STEPS = 4
INT8_HEAD_LOC_ATOL = 2e-4
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(b, c, h, w, gen, kind, t_full=225, t_side=11):
    """corr [B, C, H, W, t_full] in tanh range, px/py [B, C, T, H*W] of the
    given kind, mask_t [C, T] normalized per class as the pool mask."""
    t = t_side * t_side
    corr = torch.tanh(torch.randn(b, c, h, w, t_full, generator=gen, device="cuda"))
    shape = (b, c, t, h * w)
    if kind in ("uniform", "outside", "half"):
        # "outside" reaches 0.5 past each border: the gather clamps, the hat
        # form drops what lies outside the map
        pad = 0.5 if kind == "outside" else 0.0
        px = torch.rand(shape, generator=gen, device="cuda") * (w - 1 + 2 * pad) - pad
        py = torch.rand(shape, generator=gen, device="cuda") * (h - 1 + 2 * pad) - pad
        px[:, :, :5], py[:, :, 5:10] = 0.0, h - 1.0  # exactly on the borders
        py[:, :, 20:25] = torch.floor(py[:, :, 20:25])  # integer rows
        if kind == "half":  # half-way hat weights: 127 * 0.5 rounds half to even
            px = (torch.floor(px) + 0.5).clamp(max=w - 1)
            py = (torch.floor(py) + 0.5).clamp(max=h - 1)
    elif kind == "collapsed":
        px = (torch.rand(b, c, 1, 1, generator=gen, device="cuda") * (w - 1)).expand(shape)
        py = (torch.rand(b, c, 1, 1, generator=gen, device="cuda") * (h - 1)).expand(shape)
    else:
        # px = x + 0.5 + (tx - 5) * 15/14 for the identity transform
        # (models/head.py: 15-px anchor boxes, template lattice t = tx*11 + ty)
        ti = torch.arange(t, device="cuda")
        off_x = ((ti // t_side) - t_side // 2).float() * (15 / 14) + 0.5
        off_y = ((ti % t_side) - t_side // 2).float() * (15 / 14) + 0.5
        ys, xs = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                                indexing="ij")

        def jitter():
            if kind == "identity":
                return torch.zeros(shape, device="cuda")
            return (torch.rand(shape, generator=gen, device="cuda") - 0.5) * 0.5

        px = (xs.reshape(-1).float() + off_x[:, None] + jitter()).clamp(0, w - 1)
        py = (ys.reshape(-1).float() + off_y[:, None] + jitter()).clamp(0, h - 1)
    mask_t = torch.rand(c, t, generator=gen, device="cuda")
    mask_t /= mask_t.sum(1, keepdim=True)
    return corr, px.contiguous(), py.contiguous(), mask_t


# every level of the bench protocol (1280x960 at [0.5, 0.625, 0.8, 1, 1.2,
# 1.4, 1.6], B=2, C=16)
BENCH_FMS = [(30, 40), (38, 50), (48, 64), (60, 80), (72, 96), (84, 112), (96, 128)]
# ragged shapes (not multiples of the 8-row by 32-column anchor tile), a
# single row and a single column, the bench levels and C=128 at the largest
RAGGED = [(2, 3, 6, 7), (2, 3, 19, 23), (1, 2, 1, 7), (1, 2, 6, 1)]
SHAPES = RAGGED + [(2, 16, h, w) for h, w in BENCH_FMS] + [(2, 128, 96, 128)]
KINDS = ["uniform", "near_identity"]
CASES = ([(shape, kind) for shape in SHAPES for kind in KINDS]
         + [(shape, "outside") for shape in RAGGED])
# a map taller than 256 rows, and half-way coordinates on the ragged shapes
# and the largest level
MORE_CASES = ([((1, 2, 300, 7), "uniform")]
              + [(shape, "half") for shape in RAGGED + [(2, 16, 96, 128)]])


@pytest.mark.parametrize("shape,kind", CASES + MORE_CASES)
def test_resample_kernel_matches_plain(shape, kind, cuda_gen):
    corr, px, py, mask_t = _inputs(*shape, cuda_gen, kind)
    before = resample.KERNEL.launches
    for corr_arg in (corr, corr[..., :121]):  # row stride 225 either way
        got = resample.resample_correlation(corr_arg, px, py, mask_t)
        torch.cuda.synchronize()
        want = resample_correlation_from_pxpy_reference(corr_arg, px, py, mask_t)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        assert torch.equal(got, want)
    assert resample.KERNEL.launches == before + 2


def test_resample_kernel_rejects_mixed_devices(cuda_gen):
    corr, px, py, mask_t = _inputs(1, 2, 4, 5, cuda_gen, "uniform")
    with pytest.raises(ValueError, match="is on"):
        resample.resample_correlation(corr, px.cpu(), py, mask_t)


@pytest.mark.parametrize("shape,kind", CASES + MORE_CASES)
def test_hat_kernel_matches_plain(shape, kind, cuda_gen):
    corr, px, py, mask_t = _inputs(*shape, cuda_gen, kind)
    before = hat_resample.KERNEL.launches
    got = hat_resample.resample_correlation_hat(corr[..., :121], px, py, mask_t)
    torch.cuda.synchronize()
    want = hat_resample_reference(corr[..., :121], px, py, mask_t)
    torch.testing.assert_close(got, want, rtol=HAT_RTOL, atol=HAT_ATOL)
    assert hat_resample.KERNEL.launches == before + 1
    if kind != "outside":  # inside the map the hat form is the bilinear sample
        exact = resample_correlation_from_pxpy_reference(corr[..., :121], px, py, mask_t)
        assert float((got - exact).abs().max()) <= DEFAULT_TIER_MARGIN


def test_kernels_take_more_than_65535_planes(cuda_gen):
    """B*C above the old gridDim.y limit, on a small map."""
    corr, px, py, mask_t = _inputs(2, 32800, 3, 2, cuda_gen, "uniform", t_full=128)
    got = resample.resample_correlation(corr, px, py, mask_t)
    torch.cuda.synchronize()
    assert torch.equal(got, resample_correlation_from_pxpy_reference(corr, px, py, mask_t))
    got = hat_resample.resample_correlation_hat(corr, px, py, mask_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, hat_resample_reference(corr, px, py, mask_t),
                               rtol=HAT_RTOL, atol=HAT_ATOL)


def _theta_inputs(b, c, h, w, gen, kind):
    """theta [B, C, H*W, 6] of the kind, the anchors' feature-map boxes and
    the template lattice, as the interior-first head builds them."""
    from os2d_torch.ops.sampling import linspace
    from os2d_torch.structures.boxes import strided_anchor_grid
    from os2d_torch.structures.feature_map import ALIGNER_RECEPTIVE_FIELD, ALIGNER_STRIDE

    a = h * w
    theta = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device="cuda").repeat(b, c, a, 1)
    if kind == "near_identity":
        theta += (torch.rand(b, c, a, 6, generator=gen, device="cuda") - 0.5) * 0.1
    elif kind == "random":
        theta = torch.rand(b, c, a, 6, generator=gen, device="cuda") * 2.0 - 1.0
    elif kind == "outside":  # many samples clipped to the border
        theta[..., 2] += (torch.rand(b, c, a, generator=gen, device="cuda") - 0.5) * 6.0
        theta[..., 5] += (torch.rand(b, c, a, generator=gen, device="cuda") - 0.5) * 6.0
    boxes = strided_anchor_grid(w, h, float(ALIGNER_RECEPTIVE_FIELD.w),
                                float(ALIGNER_RECEPTIVE_FIELD.h), float(ALIGNER_STRIDE.w),
                                float(ALIGNER_STRIDE.h), device="cuda")
    lattice = torch.stack([linspace(-1.0, 1.0, 15, device="cuda")[2:13]] * 2)
    return theta.contiguous(), boxes, lattice


THETA_KINDS = ["identity", "near_identity", "random", "outside"]
THETA_CASES = ([(shape, kind) for shape in RAGGED + [(2, 16, h, w) for h, w in BENCH_FMS]
                for kind in THETA_KINDS] + [((2, 128, 96, 128), "identity")])


@pytest.mark.parametrize("shape,kind", THETA_CASES)
def test_int8_theta_kernel_matches_plain(shape, kind, cuda_gen):
    """From theta, to the bit, with one launch; and equal to the kernel
    from the px/py that the head's coordinate function forms on the card."""
    from os2d_torch.ops.geometry import interior_sample_coords
    from os2d_torch.ops.sampling import int8_hat_resample_theta_reference

    b, c, h, w = shape
    corr = _inputs(b, c, h, w, cuda_gen, "uniform")[0][..., :121]
    mask_t = torch.rand(c, 121, generator=cuda_gen, device="cuda")
    theta, boxes, lattice = _theta_inputs(b, c, h, w, cuda_gen, kind)
    before = int8_resample.KERNEL.launches
    got = int8_resample.resample_correlation_int8_theta(corr, theta, boxes, lattice, mask_t)
    torch.cuda.synchronize()
    assert int8_resample.KERNEL.launches == before + 1
    want = int8_hat_resample_theta_reference(corr, theta, boxes, lattice, mask_t)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, want)
    px, py = interior_sample_coords(theta, boxes, lattice, h, w)
    assert torch.equal(got, int8_resample.resample_correlation_int8(corr, px, py, mask_t))


@pytest.mark.parametrize("shape,kind", CASES + MORE_CASES + [((2, 32800, 3, 2), "uniform")])
def test_int8_kernel_matches_plain(shape, kind, cuda_gen):
    corr, px, py, mask_t = _inputs(*shape, cuda_gen, kind)
    before = int8_resample.KERNEL.launches
    got = int8_resample.resample_correlation_int8(corr[..., :121], px, py, mask_t)
    torch.cuda.synchronize()
    want = int8_hat_resample_reference(corr[..., :121], px, py, mask_t)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, want)
    assert int8_resample.KERNEL.launches == before + 1


def test_int8_head_on_the_card_matches_the_cpu(cuda_gen):
    """The head at "int8" on the card against the CPU; with a graph
    recorded the hat kernel runs. The kernel itself is held to the bit
    above: here the TransformNet's convolutions sum in another order on the
    two devices, theta and px/py differ in their last bits, and a hat weight
    or a corr value then rounds to the neighbouring 1/127 step now and then,
    which moves a score by at most 1/127 * the largest mask value (1/121):
    cls is held within INT8_HEAD_STEPS such steps. loc does not pass
    through the resample: it equals the fp32 ("highest") head's loc on the
    card to the bit, and both differ from the CPU's by the convolutions'
    order alone, 9.388e-05 at most for either head on these inputs
    (NVIDIA H100 80GB HBM3, 700 W); loc is held within INT8_HEAD_LOC_ATOL,
    about twice that, as is the fp32 head's."""
    from os2d_torch.models import TransformNet
    from os2d_torch.models import head as thead

    fm = torch.randn(2, 9, 11, 64, generator=cuda_gen, device="cuda")
    maps = torch.randn(3, 15, 15, 64, generator=cuda_gen, device="cuda")
    net = TransformNet(6, device="cuda")
    net.reset_parameters(torch.Generator(device="cuda").manual_seed(1))
    with torch.no_grad():
        net.linear.weight.normal_(0, 0.02, generator=cuda_gen)
        before = int8_resample.KERNEL.launches
        got = thead.head_forward(net, fm, thead.build_class_head(maps), resample_precision="int8")
        torch.cuda.synchronize()
        assert int8_resample.KERNEL.launches == before + 1
        cpu_net = TransformNet(6, device="cpu")
        cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        want = thead.head_forward(cpu_net, fm.cpu(), thead.build_class_head(maps.cpu()),
                                  resample_precision="int8")
    torch.testing.assert_close(got["cls"].cpu(), want["cls"], rtol=0,
                               atol=INT8_HEAD_STEPS / 127 / 121)
    # loc does not pass through the resample: it is the fp32 head's loc on
    # the card, and differs from the CPU's as that one does
    with torch.no_grad():
        fp32 = thead.head_forward(net, fm, thead.build_class_head(maps),
                                  resample_precision="highest")
        fp32_cpu = thead.head_forward(cpu_net, fm.cpu(), thead.build_class_head(maps.cpu()),
                                      resample_precision="highest")
    assert torch.equal(got["loc"], fp32["loc"])
    fp32_err = float((fp32["loc"].cpu() - fp32_cpu["loc"]).abs().max())
    int8_err = float((got["loc"].cpu() - want["loc"]).abs().max())
    print(f"loc card vs CPU: fp32 head {fp32_err:.3e}, int8 head {int8_err:.3e}")
    assert fp32_err <= INT8_HEAD_LOC_ATOL
    torch.testing.assert_close(got["loc"].cpu(), want["loc"], rtol=0, atol=INT8_HEAD_LOC_ATOL)
    net.requires_grad_(True)
    before = (int8_resample.KERNEL.launches, hat_resample.KERNEL.launches)
    thead.head_forward(net, fm, thead.build_class_head(maps), resample_precision="int8")
    assert (int8_resample.KERNEL.launches, hat_resample.KERNEL.launches) == (
        before[0], before[1] + 1)


BACKWARD_KINDS = KINDS + ["identity", "collapsed"]
BACKWARD_CASES = ([(shape, kind) for shape in RAGGED for kind in BACKWARD_KINDS + ["outside"]]
                  + [((4, 16, 38, 38), kind) for kind in BACKWARD_KINDS])


def _backward_inputs(shape, gen, kind, t_full=225):
    corr, px, py, mask_t = _inputs(*shape, gen, kind, t_full=t_full)
    if kind == "outside":  # the head clips px/py to the map; integers instead
        px, py = px.clamp(0, shape[3] - 1).floor(), py.clamp(0, shape[2] - 1).floor()
    b, c, h, w = shape
    g = torch.randn(b, c, h * w, generator=gen, device="cuda")
    g_sum = g + torch.randn(b, c, h * w, generator=gen, device="cuda")
    return g, g_sum, corr, px.contiguous(), py.contiguous(), mask_t


def _backward_checked(inputs):
    """One wrapper call, held against the plain version: dpx/dpy to the bit,
    dcorr at the tolerance (the card's plain version sums in no fixed
    order) and to the bit against the plain version on the CPU, with
    channels >= T exactly zero, one launch."""
    before = resample_grad.KERNEL.launches
    got = resample_grad.resample_correlation_backward(*inputs)
    torch.cuda.synchronize()
    assert resample_grad.KERNEL.launches == before + 1
    t = inputs[3].shape[2]
    want = resample_backward_reference(*inputs, t)
    for name, x, y in zip(("dcorr", "dpx", "dpy"), got, want):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL, msg=lambda m: f"{name}: {m}")
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    cpu_dcorr = resample_backward_reference(*(x.cpu() for x in inputs), t)[0]
    torch.testing.assert_close(got[0].cpu(), cpu_dcorr, rtol=0, atol=0)
    assert not got[0][..., t:].any()
    return got


@pytest.mark.parametrize("shape,kind", BACKWARD_CASES)
def test_backward_kernel_matches_plain(shape, kind, cuda_gen):
    _backward_checked(_backward_inputs(shape, cuda_gen, kind))


@pytest.mark.parametrize("t_full", [128, 121])  # 121: T == t_full, no zero channel
def test_backward_kernel_channel_counts(t_full, cuda_gen):
    _backward_checked(_backward_inputs((2, 3, 19, 23), cuda_gen, "near_identity", t_full))


def test_backward_kernel_takes_more_than_65535_planes(cuda_gen):
    _backward_checked(_backward_inputs((2, 32800, 3, 2), cuda_gen, "uniform", t_full=128))


def test_backward_kernel_clears_its_scratch(cuda_gen):
    """Two calls in a row on the same inputs: the second must not see the
    first's sums."""
    inputs = _backward_inputs((4, 16, 38, 38), cuda_gen, "near_identity")
    first = _backward_checked(inputs)
    second = _backward_checked(inputs)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("shape,kind,t_full", [((4, 16, 38, 38), k, 225) for k in BACKWARD_KINDS]
                         + [((2, 3, 19, 23), "near_identity", t) for t in (128, 121)]
                         + [((2, 32800, 3, 2), "uniform", 128)]
                         + [(shape, k, 225) for shape in RAGGED for k in BACKWARD_KINDS])
def test_backward_two_calls_equal_to_the_bit(shape, kind, t_full, cuda_gen):
    """dcorr, dpx and dpy repeat to the bit: no two threads add into one
    value."""
    inputs = _backward_inputs(shape, cuda_gen, kind, t_full)
    first = resample_grad.resample_correlation_backward(*inputs)
    second = resample_grad.resample_correlation_backward(*inputs)
    torch.cuda.synchronize()
    for name, x, y in zip(("dcorr", "dpx", "dpy"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_train_function_launches_the_backward_kernel(precision, cuda_gen):
    """The autograd Function on the card: one forward launch of the tier's
    kernel for cls and cls_detached, one backward launch for both."""
    corr, px, py, mask_t = _inputs(2, 3, 6, 7, cuda_gen, "near_identity")
    corr, px, py = (x.requires_grad_(True) for x in (corr, px, py))
    forward = hat_resample.KERNEL if precision == "default" else resample.KERNEL
    before = (forward.launches, resample_grad.KERNEL.launches)
    cls, cls_det = resample_grad.resample_correlation_autograd(corr, px, py, mask_t, precision)
    g = torch.randn(cls.shape, generator=cuda_gen, device="cuda")
    g_det = torch.randn(cls.shape, generator=cuda_gen, device="cuda")
    ((cls * g).sum() + (cls_det * g_det).sum()).backward()
    torch.cuda.synchronize()
    assert (forward.launches, resample_grad.KERNEL.launches) == (before[0] + 1, before[1] + 1)
    flat = (g.reshape(2, 3, -1), (g + g_det).reshape(2, 3, -1))
    want = resample_backward_reference(*flat, corr.detach(), px.detach(), py.detach(), mask_t,
                                       px.shape[2])
    for got, w in zip((corr.grad, px.grad, py.grad), want):
        torch.testing.assert_close(got, w, rtol=RTOL, atol=ATOL)


# ---- the numeric modes and the blocked NMS on the card ----
BF16_RULE = 0.25  # each backbone convolution on the CPU's own input
# stages of several bf16 convolutions (the stem, a bottleneck, the head
# through the TransformNet's three convolutions): cuDNN sums each
# convolution's fp32 products in another order than the CPU, a few
# roundings flip, and the flips spread through the convolutions that follow
# (measured up to 0.36 for a bottleneck and 0.47 for the head on random
# inputs, 0.28 and 0.38 on the planted crop); the port's CPU stages sit
# within 0.25 of JAX's (tests/test_torch_numeric_modes.py)
BF16_STAGE_RULE = 0.6


def _crowded_boxes(lead, k, gen):
    """k boxes of 16-64 px in a 480x480 field (on the CPU), scores on a
    1/64 grid (exact ties), 1% invalid."""
    xy = torch.rand(lead + (k, 2), generator=gen) * 480
    boxes = torch.cat([xy, xy + 16 + torch.rand(lead + (k, 2), generator=gen) * 48], -1)
    scores = torch.round(torch.rand(lead + (k,), generator=gen) * 64) / 64
    return boxes, scores, torch.rand(lead + (k,), generator=gen) > 0.01


def _decoded_boxes(which):
    """Decoded candidates of random loc and cls on the CPU: "cross_class",
    33 class rows of one 320x320 level after a pre_top_k of 1024 and a
    top_k of 256, flattened for the cross-class NMS (8448 boxes); or
    "bench_rows", every anchor of a benchmark image (1280x960, 7 levels,
    39,580 anchors) for 2 class rows."""
    import numpy as np

    from os2d_torch.engine.decode import (
        decode_pyramid,
        decode_single_level,
        default_boxes_for_image_size,
    )
    from os2d_torch.structures.feature_map import FeatureMapSize, feature_map_size_for_image

    rng = np.random.default_rng(0)

    def draws(*shape):
        return (torch.from_numpy(rng.normal(0, 0.1, shape[:-1] + (4, shape[-1])).astype(
            np.float32)), torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)))

    loc, cls = draws(33, 400)  # drawn first either way
    if which == "cross_class":
        rows = decode_pyramid([loc], [cls], [FeatureMapSize(w=320, h=320)], [(1.0, 1.0)],
                              nms_iou_threshold=0.3, pre_top_k=1024, top_k=256)
        return rows["boxes"].reshape(-1, 4), rows["scores"].reshape(-1), rows["valid"].reshape(-1)
    levels = []
    for s in (0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6):
        size = FeatureMapSize(w=int(1280 * s), h=int(960 * s))
        fm = feature_map_size_for_image(size)
        loc, cls = draws(1, 2, fm.h * fm.w)
        levels.append(decode_single_level(loc, cls, default_boxes_for_image_size(size),
                                          (size.w, size.h), (1280 / size.w, 960 / size.h),
                                          float("-inf")))
    return [torch.cat(parts, dim=-2 if parts[0].dim() == 4 else -1) for parts in zip(*levels)]


@pytest.mark.parametrize("lead,k,dense_limit,block", [
    ((), 8193, 8192, 2048), ((2,), 10000, 8192, 2048), ((3,), 700, 100, 64),
    ("cross_class", None, None, None), ("bench_rows", None, None, None)])
def test_nms_blocked_card_matches_cpu(lead, k, dense_limit, block, cuda_gen):
    """Above dense_limit, the same candidates keep the same boxes on the card
    as on the CPU (each IoU is one rounded op per step on both): crowded
    random boxes with tied scores, and decoded candidates at the default
    dense_limit and block."""
    from os2d_torch.ops import nms

    if isinstance(lead, str):
        args, limits = _decoded_boxes(lead), {}
    else:
        args = _crowded_boxes(lead, k, torch.Generator().manual_seed(k))
        limits = {"dense_limit": dense_limit, "block": block}
    want = nms.nms_keep_mask(*args, 0.3, **limits)
    got = nms.nms_keep_mask(*(x.cuda() for x in args), 0.3, **limits)
    assert torch.equal(got.cpu(), want)
    if lead != "bench_rows":
        assert 0 < int(want.sum()) < int(args[2].sum())


def _rms(x):
    return float(x.double().pow(2).mean().sqrt())


def _bf16_rule(got, want16, want32, exact_ok=False):
    """RMS(got - want16) / RMS(want16 - want32); with `exact_ok`, 0 where
    bf16 and fp32 agree exactly and `got` does too."""
    assert got.dtype == want16.dtype
    scale = _rms(want16.float() - want32.float())
    diff = _rms(got.cpu().float() - want16.float())
    if exact_ok and scale == 0:
        assert diff == 0
        return 0.0
    assert scale > 0, "bf16 and fp32 agree exactly: the rule holds nothing"
    return diff / scale


@pytest.mark.parametrize("inputs", ["random", "planted"])
@pytest.mark.parametrize("folded", [False, True])
def test_bf16_modes_card_match_cpu(folded, inputs, cuda_gen):
    """bf16 compute, folded and unfolded: the stem, every bottleneck, the
    class bank (where the features are bf16) and the head on the card
    against the CPU on the CPU's own inputs, by the bf16 rule (RMS(card -
    cpu_bf16) <= 0.25 RMS(cpu_bf16 - cpu_fp32) for each convolution, 0.6 for
    the stages); the head launches the hat kernel once. Inputs: random
    images and a CPU-seeded model, or a 256x320 crop of the first planted
    scene (tests/torch_card_scenes.py) holding its patch and the card-seeded
    model of the eval card tests."""
    from os2d_torch.models import Os2dConfig, Os2dModel, head
    from os2d_torch.models.os2d import fold_inference_params
    from os2d_torch.models.resnet import Conv2d

    if inputs == "planted":
        from torch_card_scenes import normalized, planted_scenes

        state = {k: v.cpu() for k, v in Os2dModel(Os2dConfig(), seed=0).state_dict().items()}
        x = normalized(Os2dConfig(), planted_scenes()[0][:1, :256, :320])[0][None]
        x = x.permute(0, 3, 1, 2)
    else:
        state = Os2dModel(Os2dConfig(), device="cpu").state_dict()
        x = torch.randn(2, 3, 128, 160, generator=torch.Generator().manual_seed(0))
    # a non-zero final TransformNet layer: theta, loc and corners vary
    state["transform_net.linear.weight"] = 0.02 * torch.randn(
        state["transform_net.linear.weight"].shape, generator=torch.Generator().manual_seed(1))

    def build(dtype, device):
        m = Os2dModel(Os2dConfig(compute_dtype=dtype), device=device)
        m.load_state_dict({k: v.to(device) for k, v in state.items()})
        return fold_inference_params(m) if folded else m

    card, cpu16 = build("bfloat16", "cuda"), build("bfloat16", "cpu")
    cpu32 = build("float32", "cpu")
    ratios, conv_ratios = {}, {}
    with torch.no_grad():
        convs = [{n: c for n, c in m.backbone.named_modules() if isinstance(c, Conv2d)}
                 for m in (card, cpu16, cpu32)]
        seen = []
        hooks = [c.register_forward_hook(lambda mod, args, out, n=n: seen.append((n, args[0], out)))
                 for n, c in convs[1].items()]
        cpu16.backbone(x.permute(0, 2, 3, 1))
        for h in hooks:
            h.remove()
        for n, xc, out16 in seen:
            conv_ratios[n] = _bf16_rule(convs[0][n](xc.cuda(), torch.bfloat16), out16,
                                        convs[2][n](xc.float(), torch.float32))
        want16, want32 = cpu16.backbone.stem(x), cpu32.backbone.stem(x)
        ratios["stem"] = _bf16_rule(card.backbone.stem(x.cuda()), want16, want32)
        for i, (bc, b16, b32) in enumerate(zip(card.backbone.blocks(), cpu16.backbone.blocks(),
                                              cpu32.backbone.blocks())):
            x = want16
            want16, want32 = b16(x, torch.bfloat16), b32(x.float(), torch.float32)
            ratios[f"block{i}"] = _bf16_rule(bc(x.cuda(), torch.bfloat16), want16, want32)
        fm = want16.permute(0, 2, 3, 1)
        bank = head.build_class_head(fm)
        assert bank.class_feats.dtype == fm.dtype == (torch.bfloat16 if folded else torch.float32)
        if folded:
            ratios["class_feats"] = _bf16_rule(
                head.build_class_head(fm.cuda()).class_feats, bank.class_feats,
                head.build_class_head(fm.float()).class_feats, exact_ok=True)
        out16 = cpu16.apply_head(fm, bank)
        out32 = cpu32.apply_head(fm.float(), head.ClassHead(bank.class_feats.float(),
                                                            bank.pool_mask.float()))
        before = hat_resample.KERNEL.launches
        got = card.apply_head(fm.cuda(), head.ClassHead(bank.class_feats.cuda(),
                                                        bank.pool_mask.cuda()))
        torch.cuda.synchronize()
        assert hat_resample.KERNEL.launches == before + 1
        for key in ("cls", "loc", "corners"):
            ratios[key] = _bf16_rule(got[key], out16[key], out32[key])
    assert len(conv_ratios) == len(convs[1]) == 43  # ResNet50-C4's convolutions
    assert max(conv_ratios.values()) <= BF16_RULE, conv_ratios
    assert max(ratios.values()) <= BF16_STAGE_RULE, ratios


def test_correlation_gemm_bf16_on_card(cuda_gen):
    """The card's bf16 GEMM with an fp32 output agrees with the CPU's
    upcast GEMM to fp32 summation order, not to bf16 rounding."""
    from os2d_torch.models.head import correlation_gemm

    a = torch.randn(300, 1024, generator=cuda_gen, device="cuda")
    b = torch.randn(225, 1024, generator=cuda_gen, device="cuda")
    got = correlation_gemm(a, b, torch.bfloat16)
    want = correlation_gemm(a.cpu(), b.cpu(), torch.bfloat16)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


def test_class_cache_gather_card_matches_cpu(cuda_gen):
    """The device class cache's gather (plain indexing and torch.flip) on the
    card equals its result on the CPU for every method and flip, padded rows
    included."""
    from os2d_torch.data.class_cache import DeviceClassCache

    stack = torch.randint(0, 256, (5, 6, 16, 12, 3), dtype=torch.uint8, generator=cuda_gen,
                          device="cuda")
    ids = [3, 7, 11, 12, 20]
    index_of = {c: i for i, c in enumerate(ids)}
    card = DeviceClassCache(ids, index_of, {}, stack)
    cpu = DeviceClassCache(ids, index_of, {}, stack.cpu())
    for hflip in (False, True):
        for vflip in (False, True):
            for m in range(6):
                batch_ids, methods = [20, 3, 11], [m, (m + 2) % 6, (m + 5) % 6]
                got = card.gather(batch_ids, methods, hflip, vflip, 4)
                assert got.device.type == "cuda"
                assert torch.equal(got.cpu(), cpu.gather(batch_ids, methods, hflip, vflip, 4))


@pytest.mark.parametrize("precision,kernel", [("default", "hat"), ("highest", "gather")])
def test_score_pyramid_launches_once_per_level_and_chunk(precision, kernel, cuda_gen):
    """Evaluator.score_pyramid (host pyramid, mining) launches the kernel of
    its tier once per (level, class chunk), and scores as on the CPU."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.evaluate import Evaluator
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = 2
    gen = torch.Generator().manual_seed(0)
    class_images = [torch.randn(64, 64, 3, generator=gen) for _ in range(5)]  # 3 chunks
    pyramid = [torch.randn(1, h, w, 3, generator=gen) for h, w in ((128, 160), (96, 128))]
    card = Os2dModel(Os2dConfig(resample_precision=precision))
    cpu = Os2dModel(Os2dConfig(resample_precision=precision), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    counters = {"hat": hat_resample.KERNEL, "gather": resample.KERNEL}
    out = {}
    for dev, m in (("cuda", card), ("cpu", cpu)):
        ev = Evaluator(m, cfg)
        with torch.no_grad():
            head, _ = ev.build_class_heads(class_images)
        before = {k: c.launches for k, c in counters.items()}
        out[dev] = ev.score_pyramid(pyramid, head, want_corners=True)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = {k: c.launches - before[k] for k, c in counters.items()}
    assert launched[kernel] == len(pyramid) * 3
    assert sum(launched.values()) == launched[kernel]
    for got, want in zip(out["cuda"], out["cpu"]):
        for key in ("loc", "cls", "corners"):
            torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4,
                                       atol=1e-2 if key == "corners" else 1e-4)


# the serving shapes: detect() of a 4:3 image at the service's 1500-px target
# (B=1, fm 71x94) and detect_batch on the 1500x1500 canvas (B=8, fm 94x94),
# 16 classes; neither width is a multiple of the tile's 32 columns
SERVING_SHAPES = [(1, 16, 71, 94), (8, 16, 94, 94)]


@pytest.mark.parametrize("shape,kind", [(s, k) for s in SERVING_SHAPES for k in KINDS])
def test_hat_kernel_bit_equal_at_serving_shapes(shape, kind, cuda_gen):
    corr, px, py, mask_t = _inputs(*shape, cuda_gen, kind)
    got = hat_resample.resample_correlation_hat(corr[..., :121], px, py, mask_t)
    torch.cuda.synchronize()
    want = hat_resample_reference(corr[..., :121], px, py, mask_t)
    torch.testing.assert_close(got, want, rtol=HAT_RTOL, atol=HAT_ATOL)
    assert torch.equal(got, want)


def test_service_on_the_card_matches_the_cpu(cuda_gen):
    """A DetectionService on a card model launches the hat kernel once per
    dispatch (one level, one class chunk) and answers as on the CPU."""
    import numpy as np
    from PIL import Image

    from os2d_torch.api import service as service_mod
    from os2d_torch.models import Os2dModel

    rng = np.random.RandomState(0)
    patch = np.kron(rng.randint(0, 255, (30, 30, 3), np.uint8), np.ones((8, 8, 1), np.uint8))
    scene = rng.randint(0, 60, (480, 640, 3), np.uint8)
    scene[112:352, 48:288] = patch
    card = Os2dModel()
    cpu = Os2dModel(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    before = hat_resample.KERNEL.launches
    got = service_mod.DetectionService(card, score_threshold=0.3).detect(
        Image.fromarray(scene), [Image.fromarray(patch)])
    assert hat_resample.KERNEL.launches == before + 1
    want = service_mod.DetectionService(cpu, score_threshold=0.3).detect(
        Image.fromarray(scene), [Image.fromarray(patch)])
    assert len(got["scores"]) == len(want["scores"]) > 0
    scale = np.array([640, 480, 640, 480])
    ws, wb = np.array(want["scores"]), np.array(want["bboxes"]) * scale
    for score, box in zip(got["scores"], np.array(got["bboxes"]) * scale):
        assert ((np.abs(ws - score) <= 1e-4) & (np.abs(wb - box).max(-1) <= 1e-2)).any()


def _train_arrays(gen, b=2, side=320, classes=4):
    """A synthetic train batch as prepare_batch_arrays gives it, on the card:
    uint8 images and class images, and two GT boxes per image near the
    anchors' 240 px, so that some anchors are positives."""
    from os2d_torch.engine.decode import default_boxes_for_image_size
    from os2d_torch.structures.feature_map import FeatureMapSize

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)

    gt_boxes = torch.zeros((b, 8, 4), device="cuda")
    gt_boxes[:, 0] = torch.tensor([40.0, 40.0, 280.0, 280.0])
    gt_boxes[:, 1] = torch.tensor([64.0, 48.0, 304.0, 288.0])
    gt_valid = torch.zeros((b, 8), dtype=torch.bool, device="cuda")
    gt_valid[:, :2] = True
    return {"images": u8(b, side, side, 3), "class_images": u8(classes, 128, 128, 3),
            "class_valid": torch.ones(classes, dtype=torch.bool, device="cuda"),
            "gt_boxes": gt_boxes,
            "gt_labels": torch.tensor([[0, 1] + [-1] * 6] * b, device="cuda"),
            "gt_difficult": torch.zeros((b, 8), dtype=torch.bool, device="cuda"),
            "gt_valid": gt_valid,
            "default_boxes": default_boxes_for_image_size(FeatureMapSize(w=side, h=side),
                                                          device="cuda")}


def test_one_rank_nccl_step_matches_the_plain_step(cuda_gen, monkeypatch):
    """The data-parallel TrainStep over a one-rank nccl group (the gather
    and the gradient all_reduce through NCCL) takes the plain step's steps:
    losses within rtol 2e-5, weights within rtol 1e-4, atol 1e-6. Both run
    under cudnn.deterministic, so that each run of the test compares the
    same numbers (under cuDNN's default algorithms the weights part in their
    last bits from run to run, which moves the later steps' losses). The
    gradient norm is not held: the data-parallel step sums the gradients in
    another order."""
    import torch.distributed as dist

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.parallel import init_distributed, make_mesh
    from os2d_torch.parallel.spawn import free_port

    cfg = get_default_cfg()
    arrays = [_train_arrays(cuda_gen) for _ in range(3)]
    models = [Os2dModel(Os2dConfig(class_image_size=128), seed=3) for _ in range(2)]
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(free_port()))):
        monkeypatch.setenv(k, v)
    init_distributed(backend="nccl", device="cuda:0", timeout_s=120)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        metrics = {}
        for name, model in zip(("dp", "plain"), models):
            optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
            step = TrainStep(model, ObjectiveConfig(margin_pos=1.0), optimizer, cfg.train,
                             mesh=mesh if name == "dp" else None)
            metrics[name] = [step(a, 4) for a in arrays]
    finally:
        dist.destroy_process_group()
    assert metrics["plain"][0]["cls_RLL_pos"] > 0  # positives have a loss
    for got, want in zip(metrics["dp"], metrics["plain"]):
        for k in want:
            if k != "grad_norm":
                assert got[k] == pytest.approx(want[k], rel=2e-5), k
    plain = models[1].state_dict()
    for k, v in models[0].state_dict().items():
        torch.testing.assert_close(v, plain[k], rtol=1e-4, atol=1e-6)


# ---- the mAP gate's repeatability (tools/gate_repeatability_torch.py) ----
# With the backward's dcorr summed in a fixed order and every convolution's
# gradients through models/resnet.py: conv2d_backward (cuBLAS for the 1x1
# weight gradients, cuDNN's deterministic algorithms where its default ones
# add with atomics), two models from one seed on the same batches have equal
# weights under the port's defaults, as under cudnn.deterministic.


@pytest.mark.parametrize("recipe", ["synthetic", "planted"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["default", "cudnn_deterministic"])
def test_train_steps_repeat(deterministic, recipe, cuda_gen, tmp_path):
    """Two TrainSteps from the same weights on the same batches over 3
    steps: every loss term and every weight equal to the bit, under the
    port's defaults and under cudnn.deterministic. Recipes: synthetic
    320-px batches with 128-px class images, or the default recipe at full
    width on 3 batches of the planted training set
    (tests/torch_card_scenes.py), seed-1 weights."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = get_default_cfg()
    if recipe == "planted":
        from os2d_torch.data.dataloader import build_train_dataloader_from_config
        from torch_card_scenes import train_cfg, train_dataset

        loader, _ = build_train_dataloader_from_config(train_cfg(), train_dataset(str(tmp_path)),
                                                       seed=0)
        arrays = [prepare_batch_arrays(loader.get_batch(i % len(loader)), "cuda")
                  for i in range(3)]
        config, seed = Os2dConfig(), 1
    else:
        arrays = [(_train_arrays(cuda_gen), 4) for _ in range(3)]
        config, seed = Os2dConfig(class_image_size=128), 3
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        runs = []
        for _ in range(2):
            model = Os2dModel(config, seed=seed)
            optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
            step = TrainStep(model, ObjectiveConfig(margin_pos=1.0), optimizer, cfg.train)
            runs.append((model, [step(*a) for a in arrays]))
    finally:
        torch.backends.cudnn.deterministic = saved
    (model_a, metrics_a), (model_b, metrics_b) = runs
    assert metrics_a[0]["cls_RLL_pos"] > 0  # the backward kernel's dpx/dpy are not zero
    assert metrics_a == metrics_b
    state_b = model_b.state_dict()
    for k, v in model_a.state_dict().items():
        assert torch.equal(v, state_b[k]), k


# (N, Cin, H, W, Cout, kernel, stride, padding, bias): the backbone's 1x1 at
# 150x150 (runs of rows), its strided 1x1 and 3x3, a 3x3 and the
# TransformNet's biased 7x7
CONV_CASES = [(4, 64, 150, 150, 256, 1, 1, 0, False), (4, 256, 150, 150, 512, 1, 2, 0, False),
              (4, 128, 150, 150, 128, 3, 2, 1, False), (4, 256, 38, 38, 256, 3, 1, 1, False),
              (64, 225, 38, 38, 128, 7, 1, 3, True)]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c[:8])))
def test_conv2d_backward_repeats_and_matches_cudnn(case, cuda_gen):
    """models/resnet.py: conv2d_backward on the card, fp32, channels-last:
    two calls equal to the bit, each gradient within fp32 rounding of
    cuDNN's (the sums' orders differ), and the 1x1 weight gradient of a
    batch equal to the sum of its halves' to the bit."""
    from os2d_torch.models.resnet import conv2d_backward, wgrad_1x1_gemm

    n, cin, h, w, cout, k, stride, padding, bias = case
    x = torch.randn(n, cin, h, w, generator=cuda_gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    weight = torch.randn(cout, cin, k, k, generator=cuda_gen, device="cuda") / (cin * k * k)
    out = torch.nn.functional.conv2d(x, weight, None, stride, padding)
    g = torch.randn(out.shape, generator=cuda_gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    mask = (True, True, bias)
    first = conv2d_backward(g, x, weight, bias, stride, padding, mask)
    again = conv2d_backward(g, x, weight, bias, stride, padding, mask)
    want = torch.ops.aten.convolution_backward(
        g, x, weight, [cout] if bias else None, [stride] * 2, [padding] * 2, [1, 1], False,
        [0, 0], 1, list(mask))
    for part, a, b, e in zip(("dx", "dw", "db"), first, again, want):
        assert (a is None) == (e is None), part
        if e is not None:
            assert torch.equal(a, b), part
            torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4 * float(e.abs().max()))
    if k == 1:
        halves = (wgrad_1x1_gemm(g[:n // 2], x[:n // 2], stride)
                  + wgrad_1x1_gemm(g[n // 2:], x[n // 2:], stride))
        assert torch.equal(first[1], halves)


def test_bf16_fold_eval_repeats_to_the_bit(cuda_gen):
    """The eval forward has no atomics: two dispatches of one batch at
    bf16+fold (the gate's bf16_fold_default) give equal packed detections."""
    import numpy as np

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.evaluate import Evaluator
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models.os2d import fold_inference_params
    from os2d_torch.structures.feature_map import FeatureMapSize

    model = fold_inference_params(Os2dModel(Os2dConfig(compute_dtype="bfloat16"), seed=0))
    ev = Evaluator(model, get_default_cfg())
    rng = np.random.RandomState(0)
    head, _ = ev.build_class_heads([rng.randn(128, 128, 3).astype(np.float32)
                                    for _ in range(4)])
    images = torch.randint(0, 256, (2, 480, 640, 3), generator=cuda_gen, device="cuda",
                           dtype=torch.uint8)
    sizes = [FeatureMapSize(w=512, h=384), FeatureMapSize(w=640, h=480)]
    inv = [(640 / 512, 480 / 384), (1.0, 1.0)]
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    first = ev.detect_images(images, head, sizes, inv, norm)
    second = ev.detect_images(images, head, sizes, inv, norm)
    assert first[..., 5].any() and torch.equal(first, second)


@pytest.mark.parametrize("inputs", ["random", "planted"])
def test_yuv420_decode_on_the_card_matches_the_cpu(inputs, cuda_gen, tmp_path):
    """The wire's decode on the card: the float RGB equal to the CPU's (both
    divide by K_G as IEEE fp32 does; held within 1e-4, as against JAX) and
    the uint8 RGB equal. Inputs: random 1280x960 images, or the batch of
    the planted scenes written at 1280x960 (each pixel replicated 2x2) as
    JPEG files and read back through the data layer."""
    import numpy as np

    from os2d_torch.ops.pixel_format import (
        PackedYuv420,
        decode_wire_to_u8,
        rgb_to_yuv420,
        yuv420_to_rgb_f32,
    )

    if inputs == "planted":
        from os2d_torch.data.dataloader import DataloaderOneShotDetection
        from torch_card_scenes import dataset, write_planted_dataset

        root = str(tmp_path)
        loader = DataloaderOneShotDetection(
            dataset(root, write_planted_dataset(root, 2), "planted-wire", 1280), batch_size=2,
            pyramid_scales_eval=[0.5, 1.0])
        img = np.stack(next(loader.make_raw_iterator_for_all_images(2))[1])
    else:
        img = np.random.RandomState(0).randint(0, 256, (2, 960, 1280, 3), np.uint8)
    packed = rgb_to_yuv420(img)
    flat_cpu = torch.from_numpy(packed.data)
    flat_card = flat_cpu.cuda()
    got = yuv420_to_rgb_f32(flat_card, packed.shape)
    want = yuv420_to_rgb_f32(flat_cpu, packed.shape)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    assert torch.equal(decode_wire_to_u8(PackedYuv420(flat_card, packed.shape)).cpu(),
                       decode_wire_to_u8(PackedYuv420(flat_cpu, packed.shape)))


def test_yuv420_eval_dispatch_on_the_card_matches_the_cpu(cuda_gen):
    """Evaluator.detect_images on a planted scene uploaded as the yuv420
    wire: the hat kernel once per dispatch (one level, one chunk), and the
    packed detections of the card within scores 1e-4, boxes 1e-2 px of the
    CPU's on the planted patch's class, which tops at the patch."""
    import numpy as np

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.evaluate import Evaluator, unpack_detections
    from os2d_torch.models import Os2dModel
    from os2d_torch.ops.pixel_format import upload_images
    from os2d_torch.structures.feature_map import FeatureMapSize
    from os2d_torch.utils.upload import uploader_for

    rng = np.random.RandomState(0)
    patch = np.kron(rng.randint(0, 255, (30, 30, 3), np.uint8), np.ones((8, 8, 1), np.uint8))
    scenes = rng.randint(0, 60, (2, 480, 640, 3), np.uint8)
    scenes[:, 112:352, 48:288] = patch
    card = Os2dModel()
    cpu = Os2dModel(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    cfg = get_default_cfg()
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 16
    norm = {"mean": card.config.normalization_mean, "std": card.config.normalization_std}
    mean, std = np.asarray(norm["mean"], np.float32), np.asarray(norm["std"], np.float32)
    class_image = torch.from_numpy((patch / 255.0 - mean) / std).float()
    out = {}
    for name, model in (("card", card), ("cpu", cpu)):
        ev = Evaluator(model, cfg)
        head, _ = ev.build_class_heads([class_image])
        images = upload_images(uploader_for(model.device), scenes, "yuv420")
        before = hat_resample.KERNEL.launches
        packed = ev.detect_images(images, head, [FeatureMapSize(w=640, h=480)], [(1.0, 1.0)],
                                  norm)
        out[name] = unpack_detections(packed)
        if name == "card":
            assert hat_resample.KERNEL.launches == before + 1
    for i in range(2):
        got_valid, want_valid = out["card"]["valid"][i, 0], out["cpu"]["valid"][i, 0]
        got_box = out["card"]["boxes"][i, 0][got_valid][0]
        want_box = out["cpu"]["boxes"][i, 0][want_valid][0]
        assert abs(out["card"]["scores"][i, 0][got_valid][0]
                   - out["cpu"]["scores"][i, 0][want_valid][0]) <= 1e-4
        assert np.abs(got_box - want_box).max() <= 1e-2
        assert np.abs(want_box - [48, 112, 288, 352]).max() <= 16


def test_pretrain_step_on_the_card_matches_the_cpu(cuda_gen):
    """One fp32 step of the pretrainer (ResNet50 classifier at 64x64, batch
    4, 3 classes) on the card and on the CPU from the same weights: the loss
    within rtol 1e-4, the update within 5% in norm and each running
    statistic within rtol 1e-4 of its largest magnitude (the rounding noise
    of this step, tests/test_torch_pretrain.py); then a bf16 step on the
    card: a finite loss."""
    import numpy as np

    from os2d_torch.pretrain import train_imagenet as tpre

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(4, 64, 64, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 3, 4))
    start = tpre.init_classifier("resnet50", 3, "cpu", seed=0).state_dict()
    states, losses = {}, {}
    for device in ("cuda", "cpu"):
        model = tpre.init_classifier("resnet50", 3, device, seed=1)
        model.load_state_dict(start)
        chain = tpre.ChainSGD(model.parameters(), tpre.piecewise_constant_schedule(0.1, {}))
        step = tpre.make_train_step(model, chain, torch.float32)
        losses[device] = float(step(images.to(device), labels.to(device))["loss"])
        states[device] = {k: v.detach().cpu().double() for k, v in model.state_dict().items()}
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-4)
    weights = [k for k in start if "running" not in k]
    num = sum((states["cuda"][k] - states["cpu"][k]).square().sum() for k in weights)
    den = sum((states["cpu"][k] - start[k].double()).square().sum() for k in weights)
    assert float((num / den).sqrt()) <= 5e-2
    for k in start:
        if "running" in k:
            torch.testing.assert_close(states["cuda"][k], states["cpu"][k], rtol=0,
                                       atol=1e-4 * float(states["cpu"][k].abs().max()))
    model = tpre.init_classifier("resnet50", 3, "cuda", seed=0)
    chain = tpre.ChainSGD(model.parameters(), tpre.piecewise_constant_schedule(0.1, {}))
    loss = tpre.make_train_step(model, chain)(images.cuda(), labels.cuda())["loss"]
    assert torch.isfinite(loss)
