"""The port's `"default"`-tier resample (`os2d_torch.ops.hat_resample`) on the
CPU, where the wrapper runs its plain version `hat_resample_reference`; the
CUDA kernel is held against that plain version on the card by
tests/test_torch_kernels_card.py and chip_smoke.py.

- Against the JAX hat kernel `hat_resample_correlation_map_pallas` in
  interpret mode, at the shapes of tests/test_pallas_resample.py plus an
  11x11 template (the interior size of the main path). Both round corr*mask
  and the hat rows to bf16 at the same points and sum in fp32, so the
  tolerance is tight: rtol 1e-5, atol 2e-6.
- Against the exact fp32 gather (`resample_correlation_from_pxpy_reference`)
  on tanh-range corr at a bench-like 30x40 feature map: within 4e-3, the
  `"default"` prescreen margin (two bf16 roundings of 2^-9 relative each).
- The identity the CUDA kernel relies on: a banded formulation that reads
  only the two rows and two columns around each sample (indices outside the
  map dropped) and rounds each product and sum on its own equals the plain
  version to the bit (atol 0, rtol 0), on ragged maps, a single row or
  column, integer coordinates, the borders and up to 0.5 outside them.
- The wrapper's contract: a prefix view with row stride 225 is taken as it
  is; a non-contiguous px or a mismatched mask is refused.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from os2d_tpu.ops.pallas_hat_resample import hat_resample_correlation_map_pallas
from os2d_torch.ops.hat_resample import resample_correlation_hat
from os2d_torch.ops.sampling import (
    hat_resample_operand,
    hat_resample_reference,
    resample_correlation_from_pxpy_reference,
)

RTOL, ATOL = 1e-5, 2e-6
EXACT_ATOL = 4e-3


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These tests run many small torch ops; with one intra-op thread they
    do not wait on OpenMP barriers when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t_major(grids, h, w):
    """The Pallas wrapper's grid -> t-major px/py (pallas_hat_resample.py:91-96)."""
    b, c, _, _, th, tw, _ = grids.shape
    t, a = th * tw, h * w
    g = grids.reshape(b, c, a, th, tw, 2)
    px = ((g[..., 0] + 1.0) * 0.5 * (w - 1)).transpose(0, 1, 4, 3, 2).reshape(b, c, t, a)
    py = ((g[..., 1] + 1.0) * 0.5 * (h - 1)).transpose(0, 1, 4, 3, 2).reshape(b, c, t, a)
    return np.ascontiguousarray(px), np.ascontiguousarray(py)


@pytest.mark.parametrize("b,c,h,w,th", [(1, 2, 8, 16, 5), (2, 3, 12, 16, 5), (2, 2, 10, 13, 11)])
def test_plain_matches_pallas_hat_kernel(b, c, h, w, th):
    rng = np.random.RandomState(1)
    t = th * th
    corr = np.tanh(rng.randn(b, c, h, w, t)).astype(np.float32)
    grids = np.clip(rng.uniform(-1, 1, (b, c, h, w, th, th, 2)), -1, 1).astype(np.float32)
    mask = rng.rand(c, th, th).astype(np.float32)
    mask /= mask.reshape(c, -1).sum(1)[:, None, None]
    want = np.asarray(hat_resample_correlation_map_pallas(
        jnp.asarray(corr), jnp.asarray(grids), jnp.asarray(mask), a_blk=64, interpret=True))

    px, py = _t_major(grids, h, w)
    mask_t = np.ascontiguousarray(mask.transpose(0, 2, 1).reshape(c, t))
    got = resample_correlation_hat(torch.from_numpy(corr), torch.from_numpy(px),
                                   torch.from_numpy(py), torch.from_numpy(mask_t))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _interior_inputs(b, c, h, w, seed=2):
    rng = np.random.RandomState(seed)
    corr = np.tanh(rng.randn(b, c, h, w, 225)).astype(np.float32)
    t, a = 121, h * w
    px = rng.uniform(0, w - 1, (b, c, t, a)).astype(np.float32)
    py = rng.uniform(0, h - 1, (b, c, t, a)).astype(np.float32)
    px[:, :, :7], py[:, :, 3:10] = 0.0, h - 1.0  # exactly on the borders
    py[:, :, 20:25] = np.floor(py[:, :, 20:25])  # integer rows
    mask_t = np.full((c, t), 1.0 / t, np.float32)
    return (torch.from_numpy(x) for x in (corr, px, py, mask_t))


def test_plain_within_default_margin_of_exact_gather():
    corr, px, py, mask_t = _interior_inputs(1, 2, 30, 40)
    hat = resample_correlation_hat(corr[..., :121], px, py, mask_t)
    exact = resample_correlation_from_pxpy_reference(corr[..., :121], px, py, mask_t)
    err = float((hat - exact).abs().max())
    assert 0.0 < err <= EXACT_ATOL, err


def _banded(corr, px, py, mask_t):
    """The hat form on its non-zero weights only, as csrc/hat_resample.cu
    computes it: r(x) = wy0*M[y0, x] + wy1*M[y0+1, x], then
    r(x0)*wx0 + r(x0+1)*wx1, acc += that, t in order; a term whose row or
    column lies outside the map is left out."""
    b, c, h, w, _ = corr.shape
    f32 = torch.float32
    m = hat_resample_operand(corr, mask_t).to(f32).reshape(b, c, -1, h * w)  # [B, C, T, A]

    def hat(p, i):
        return torch.clamp(1.0 - (p - i.to(f32)).abs(), min=0.0)

    acc = torch.zeros((b, c, h * w), dtype=f32)
    for t in range(px.shape[2]):
        x, y = px[:, :, t], py[:, :, t]
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        zero = torch.zeros_like(x)

        def value(yi, xi, valid):
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
            return torch.where(valid, torch.gather(m[:, :, t], 2, idx), zero)

        def r(xi):
            terms = []
            for yi in (y0, y0 + 1):
                wy = hat(y, yi).to(torch.bfloat16).to(f32)
                inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                terms.append(torch.where(inside, wy * value(yi, xi, inside), zero))
            return terms[0] + terms[1]

        s = [torch.where((xi >= 0) & (xi < w), r(xi) * hat(x, xi), zero) for xi in (x0, x0 + 1)]
        acc = acc + (s[0] + s[1])
    return acc.reshape(b, c, h, w)


@pytest.mark.parametrize("b,c,h,w", [(2, 3, 6, 7), (1, 2, 19, 23), (1, 2, 1, 7), (1, 2, 6, 1),
                                     (1, 1, 1, 1)])
def test_banded_form_equals_plain_to_the_bit(b, c, h, w):
    rng = np.random.RandomState(3)
    t, a = 121, h * w
    corr = np.tanh(rng.randn(b, c, h, w, 225)).astype(np.float32)
    # up to 0.5 outside each border, then borders and integer coordinates
    px = rng.uniform(-0.5, w - 0.5, (b, c, t, a)).astype(np.float32)
    py = rng.uniform(-0.5, h - 0.5, (b, c, t, a)).astype(np.float32)
    px[:, :, :5], px[:, :, 5:10] = 0.0, w - 1.0
    py[:, :, 10:15], py[:, :, 15:20] = 0.0, h - 1.0
    px[:, :, 20:30] = np.floor(px[:, :, 20:30])
    py[:, :, 25:35] = np.floor(py[:, :, 25:35])
    px[:, :, 35:40], py[:, :, 40:45] = -0.5, h - 0.5
    mask_t = rng.rand(c, t).astype(np.float32)
    mask_t /= mask_t.sum(1, keepdims=True)
    corr, px, py, mask_t = (torch.from_numpy(v) for v in (corr, px, py, mask_t))
    want = hat_resample_reference(corr[..., :121], px, py, mask_t)
    got = _banded(corr[..., :121], px, py, mask_t)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_contract():
    corr, px, py, mask_t = _interior_inputs(1, 2, 5, 6)
    prefix = corr[..., :121]
    assert prefix.stride(3) == 225
    torch.testing.assert_close(resample_correlation_hat(prefix, px, py, mask_t),
                               hat_resample_reference(corr[..., :121].contiguous(), px, py,
                                                      mask_t), rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        resample_correlation_hat(prefix, px.transpose(2, 3).contiguous().transpose(2, 3),
                                 py, mask_t)
    with pytest.raises(ValueError, match="mask_t"):
        resample_correlation_hat(prefix, px, py, mask_t[:1])
    with pytest.raises(ValueError, match="mask_t"):
        resample_correlation_hat(prefix, px, py, mask_t[:, :100].contiguous())
