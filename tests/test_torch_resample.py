"""The port's correlation resample (`os2d_torch.ops.resample`) against both
JAX contracts. On the CPU the wrapper runs its plain PyTorch version; the
CUDA kernel is held against that plain version on the card by
tests/test_torch_kernels_card.py and by chip_smoke.py.

Tolerance rtol 1e-5, atol 1e-6, as tests/test_pallas_resample.py: both sides
are fp32 bilinear samples summed over t in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from os2d_tpu.ops.pallas_resample import resample_correlation_map_pallas
from os2d_tpu.ops.sampling import resample_correlation_from_pxpy
from os2d_torch.ops.resample import resample_correlation

RTOL, ATOL = 1e-5, 1e-6
TH = TW = 15


def _pool_mask_t(c, t_order_interior):
    """[C, T] t-major pool mask: the full 225 (border zero) or the 121 interior."""
    mask = np.zeros((c, TH, TW), np.float32)
    mask[:, 2:-2, 2:-2] = 1
    mask /= mask.reshape(c, -1).sum(1)[:, None, None]
    if t_order_interior:
        return mask[:, 2:-2, 2:-2].transpose(0, 2, 1).reshape(c, -1)
    return mask.transpose(0, 2, 1).reshape(c, -1)


@pytest.mark.parametrize("b,c,h,w", [(1, 2, 8, 16), (2, 3, 6, 7), (1, 1, 15, 15)])
def test_matches_pallas_kernel_grid_contract(b, c, h, w):
    rng = np.random.RandomState(0)
    t = TH * TW
    corr = rng.randn(b, c, h, w, t).astype(np.float32)
    grids = np.clip(rng.uniform(-1.1, 1.1, (b, c, h, w, TH, TW, 2)), -1, 1).astype(np.float32)
    mask = np.zeros((c, TH, TW), np.float32)
    mask[:, 2:-2, 2:-2] = 1
    mask /= mask.reshape(c, -1).sum(1)[:, None, None]
    want = np.asarray(resample_correlation_map_pallas(
        jnp.asarray(corr), jnp.asarray(grids), jnp.asarray(mask), interpret=True))

    # the Pallas wrapper's own grid -> t-major pixel coordinates
    g = grids.reshape(b, c, h * w, TH, TW, 2)
    px = ((g[..., 0] + 1.0) * 0.5 * (w - 1)).transpose(0, 1, 4, 3, 2).reshape(b, c, t, h * w)
    py = ((g[..., 1] + 1.0) * 0.5 * (h - 1)).transpose(0, 1, 4, 3, 2).reshape(b, c, t, h * w)
    got = resample_correlation(torch.from_numpy(corr), torch.from_numpy(px.copy()),
                               torch.from_numpy(py.copy()),
                               torch.from_numpy(_pool_mask_t(c, False)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _interior_inputs(b, c, h, w, seed=1):
    """Full 225-channel corr plus t-major px/py over the 121 interior points,
    with some coordinates exactly on the borders 0 and w-1 / h-1."""
    rng = np.random.RandomState(seed)
    corr = np.tanh(rng.randn(b, c, h, w, TH * TW)).astype(np.float32)
    a, t = h * w, 121
    px = rng.uniform(0, w - 1, (b, c, t, a)).astype(np.float32)
    py = rng.uniform(0, h - 1, (b, c, t, a)).astype(np.float32)
    px[:, :, :7] = 0.0
    px[:, :, 7:14] = w - 1
    py[:, :, 3:10] = 0.0
    py[:, :, 10:17] = h - 1
    px[:, :, 20:25] = np.floor(px[:, :, 20:25])  # integer coordinates
    return corr, px, py, _pool_mask_t(c, True)


@pytest.mark.parametrize("b,c,h,w", [(2, 3, 6, 7), (1, 2, 8, 16)])
def test_matches_xla_pxpy_contract_on_interior_prefix(b, c, h, w):
    corr, px, py, mask_t = _interior_inputs(b, c, h, w)
    want = np.asarray(resample_correlation_from_pxpy(
        jnp.asarray(corr[..., :121]), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(mask_t), precision="highest"))
    corr_t = torch.from_numpy(corr)
    args = (torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(mask_t))
    # the full tensor (read through its row stride) and a prefix view agree
    for corr_arg in (corr_t, corr_t[..., :121]):
        got = resample_correlation(corr_arg, *args)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_contract_violations_raise():
    corr, px, py, mask_t = (torch.from_numpy(x) for x in _interior_inputs(1, 2, 4, 5))
    resample_correlation(corr, px, py, mask_t)
    with pytest.raises(ValueError, match="px/py"):
        resample_correlation(corr, px[..., :-1], py, mask_t)
    with pytest.raises(ValueError, match="contiguous"):
        resample_correlation(corr, px.transpose(2, 3).contiguous().transpose(2, 3), py, mask_t)
    with pytest.raises(ValueError, match="float32"):
        resample_correlation(corr.double(), px, py, mask_t)
    with pytest.raises(ValueError, match="mask_t"):
        resample_correlation(corr, px, py, mask_t[:1])
    with pytest.raises(ValueError, match="fewer than"):
        resample_correlation(corr[..., :100], px, py, mask_t)
    with pytest.raises(ValueError, match="strides"):
        resample_correlation(corr.transpose(2, 3), px, py, mask_t)
