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

Backward kernel (`csrc/resample_backward.cu`): computes dpx and dpy with the
plain version's roundings in its order, so those agree to the bit (asserted
beside rtol 1e-5, atol 1e-6); dcorr is a scatter of fp32 atomic adds, whose
order changes the last bits, so it is held to rtol 1e-5, atol 1e-6. Cases:
the ragged shapes, the training shape (B=4, C=16, 38x38, T=121 of 225) on
uniform and near-identity inputs, integer coordinates and the borders.

Two kinds of inputs bracket the kernels' memory traffic: "uniform" px/py
spread over the whole map (almost no corr sector is used twice), and
"near_identity" px/py, the anchor's position plus the template offset of
the head's identity transform plus a small jitter (the 8 anchors of one
tile column share each sector, as on the main path); "outside" reaches 0.5
past the borders.
"""

import pytest
import torch

from os2d_torch.ops import hat_resample, resample, resample_grad
from os2d_torch.ops.sampling import (
    hat_resample_reference,
    resample_backward_reference,
    resample_correlation_from_pxpy_reference,
)

RTOL, ATOL = 1e-5, 1e-6
HAT_RTOL, HAT_ATOL = 1e-5, 1e-5
DEFAULT_TIER_MARGIN = 4e-3
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
    if kind in ("uniform", "outside"):
        # "outside" reaches 0.5 past each border: the gather clamps, the hat
        # form drops what lies outside the map
        pad = 0.5 if kind == "outside" else 0.0
        px = torch.rand(shape, generator=gen, device="cuda") * (w - 1 + 2 * pad) - pad
        py = torch.rand(shape, generator=gen, device="cuda") * (h - 1 + 2 * pad) - pad
        px[:, :, :5], py[:, :, 5:10] = 0.0, h - 1.0  # exactly on the borders
        py[:, :, 20:25] = torch.floor(py[:, :, 20:25])  # integer rows
    else:
        # px = x + 0.5 + (tx - 5) * 15/14 for the identity transform
        # (models/head.py: 15-px anchor boxes, template lattice t = tx*11 + ty)
        ti = torch.arange(t, device="cuda")
        off_x = ((ti // t_side) - t_side // 2).float() * (15 / 14) + 0.5
        off_y = ((ti % t_side) - t_side // 2).float() * (15 / 14) + 0.5
        ys, xs = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                                indexing="ij")

        def jitter():
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


@pytest.mark.parametrize("shape,kind", CASES)
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


@pytest.mark.parametrize("shape,kind", CASES + [((1, 2, 300, 7), "uniform")])  # and H > 256
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


BACKWARD_CASES = ([(shape, kind) for shape in RAGGED for kind in KINDS + ["outside"]]
                  + [((4, 16, 38, 38), kind) for kind in KINDS])


@pytest.mark.parametrize("shape,kind", BACKWARD_CASES)
def test_backward_kernel_matches_plain(shape, kind, cuda_gen):
    corr, px, py, mask_t = _inputs(*shape, cuda_gen, kind)
    if kind == "outside":  # the head clips px/py to the map; integers instead
        px, py = px.clamp(0, shape[3] - 1).floor(), py.clamp(0, shape[2] - 1).floor()
    b, c, h, w = shape
    g = torch.randn(b, c, h * w, generator=cuda_gen, device="cuda")
    g_sum = g + torch.randn(b, c, h * w, generator=cuda_gen, device="cuda")
    before = resample_grad.KERNEL.launches
    got = resample_grad.resample_correlation_backward(g, g_sum, corr, px, py, mask_t)
    torch.cuda.synchronize()
    assert resample_grad.KERNEL.launches == before + 1
    want = resample_backward_reference(g, g_sum, corr, px, py, mask_t, px.shape[2])
    for name, x, y in zip(("dcorr", "dpx", "dpy"), got, want):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL, msg=lambda m: f"{name}: {m}")
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert not got[0][..., px.shape[2]:].any()


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
