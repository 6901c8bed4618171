"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode: without a card every test here skips. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_card.py -q

Tolerance rtol 1e-5, atol 1e-6. The kernel rounds each product and sum as
the plain version does, in the same order, so on the card the two agree to
the bit; the tolerance is the one the plain version meets against JAX.
"""

import pytest
import torch

from os2d_torch.ops import resample
from os2d_torch.ops.sampling import resample_correlation_from_pxpy_reference

RTOL, ATOL = 1e-5, 1e-6
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
