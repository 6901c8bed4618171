"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode: without a card every test here skips. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_card.py -q

Gather kernel (`csrc/resample.cu`): rtol 1e-5, atol 1e-6. The kernel rounds
each product and sum as the plain version does, in the same order, so on the
card the two agree to the bit; the tolerance is the one the plain version
meets against JAX.

Hat kernel (`csrc/hat_resample.cu`): rtol 1e-5, atol 1e-5. It rounds its
operands to bf16 at the plain version's points, but its tensor cores add the
product's terms in their own order, so the two agree to a few fp32 ulps.
"""

import pytest
import torch

from os2d_torch.ops import hat_resample, resample
from os2d_torch.ops.sampling import (
    hat_resample_reference,
    resample_correlation_from_pxpy_reference,
)

RTOL, ATOL = 1e-5, 1e-6
HAT_RTOL, HAT_ATOL = 1e-5, 1e-5
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(b, c, h, w, gen, t_full=225, t=121):
    corr = torch.tanh(torch.randn(b, c, h, w, t_full, generator=gen, device="cuda"))
    px = torch.rand(b, c, t, h * w, generator=gen, device="cuda") * (w - 1)
    py = torch.rand(b, c, t, h * w, generator=gen, device="cuda") * (h - 1)
    px[:, :, :5], py[:, :, 5:10] = 0.0, h - 1.0  # exactly on the borders
    mask_t = torch.rand(c, t, generator=gen, device="cuda")
    mask_t /= mask_t.sum(1, keepdim=True)  # spatially normalized, as the pool mask
    return corr, px, py, mask_t


# a ragged small shape and the bench protocol's largest level
@pytest.mark.parametrize("b,c,h,w", [(2, 3, 6, 7), (2, 16, 96, 128)])
def test_resample_kernel_matches_plain(b, c, h, w, cuda_gen):
    corr, px, py, mask_t = _inputs(b, c, h, w, cuda_gen)
    before = resample.KERNEL.launches
    for corr_arg in (corr, corr[..., :121]):  # row stride 225 either way
        got = resample.resample_correlation(corr_arg, px, py, mask_t)
        torch.cuda.synchronize()
        want = resample_correlation_from_pxpy_reference(corr_arg, px, py, mask_t)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert resample.KERNEL.launches == before + 2


def test_resample_kernel_rejects_mixed_devices(cuda_gen):
    corr, px, py, mask_t = _inputs(1, 2, 4, 5, cuda_gen)
    with pytest.raises(ValueError, match="is on"):
        resample.resample_correlation(corr, px.cpu(), py, mask_t)


# ragged small shapes (H not a multiple of 16, W not of 8) and every level
# of the bench protocol (1280x960 at [0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6],
# B=2, C=16): the kernel is compiled once per 16 rows of H, and these
# levels need five of those versions
BENCH_FMS = [(30, 40), (38, 50), (48, 64), (60, 80), (72, 96), (84, 112), (96, 128)]


@pytest.mark.parametrize("b,c,h,w", [(2, 3, 6, 7), (2, 3, 19, 23)]
                         + [(2, 16, h, w) for h, w in BENCH_FMS])
def test_hat_kernel_matches_plain(b, c, h, w, cuda_gen):
    corr, px, py, mask_t = _inputs(b, c, h, w, cuda_gen)
    before = hat_resample.KERNEL.launches
    got = hat_resample.resample_correlation_hat(corr[..., :121], px, py, mask_t)
    torch.cuda.synchronize()
    want = hat_resample_reference(corr[..., :121], px, py, mask_t)
    torch.testing.assert_close(got, want, rtol=HAT_RTOL, atol=HAT_ATOL)
    assert hat_resample.KERNEL.launches == before + 1
    exact = resample_correlation_from_pxpy_reference(corr[..., :121], px, py, mask_t)
    assert float((got - exact).abs().max()) <= 4e-3
