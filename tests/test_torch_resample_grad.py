"""The gradient of the port's resample + masked pool on the CPU, where the
wrapper `ops.resample_grad.resample_correlation_backward` runs its plain
version `ops.sampling.resample_backward_reference`; the CUDA kernel
(csrc/resample_backward.cu) is held against that plain version on the card by
tests/test_torch_kernels_card.py and chip_smoke.py.

- Against `jax.vjp` of `os2d_tpu.ops.sampling.resample_correlation_from_pxpy`
  at `precision="highest"` (JAX on the CPU, fp32), the form the JAX trainer
  differentiates at every tier, with the gradient taken through the prefix
  corr[..., :121] of a 225-channel tensor: dcorr, dpx and dpy at rtol 1e-5,
  atol 1e-6 on ragged maps, a single row (H=1) and column (W=1), uniform,
  near-identity and integer coordinates, coordinates on the borders (0
  and W-1 / H-1), and collapsed planes (every sample of a (b, c) plane on
  one point, so that all of its dcorr sums land on four cells).
- The rule that makes this necessary: torch autograd of the plain hat
  expression (torch.abs' (0) = 0) gives another dpx at integer coordinates.
- The autograd Function `resample_correlation_autograd`: its cls takes the
  gradient to corr, px and py, its cls_detached to corr only, and its
  forward is the tier's.
- The order of dcorr's sums, which the kernel reproduces: on the CPU
  `scatter_add_` adds along the index dimension in order, and the plain
  version's dcorr equals, to the bit, each cell's terms added one at a
  time per t in corner order (1,1), (1,2), (2,1), (2,2) and, within a
  corner, over the anchors in ascending order (numpy's unbuffered
  `np.add.at`, the order of the kernel's dcorr warps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from os2d_tpu.ops.sampling import resample_correlation_from_pxpy
from os2d_torch.ops.resample_grad import (
    resample_correlation_autograd,
    resample_correlation_backward,
)
from os2d_torch.ops.sampling import hat_resample_reference, resample_correlation_from_pxpy_reference

RTOL, ATOL = 1e-5, 1e-6
T_SIDE, T_FULL = 11, 225


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(b, c, h, w, kind, seed):
    """corr [B, C, H, W, 225] in tanh range, px/py [B, C, 121, H*W], mask
    [C, 121], and a cotangent [B, C, H*W], all from a numpy seed.
    kind: "uniform" spread over the map; "near_identity" the anchor plus the
    identity transform's template offset, jittered by 0.25 px and clipped to
    the map (many samples on the border); "integer" whole-number coordinates;
    "border" every coordinate at 0 or at W-1 / H-1; "collapsed" every
  sample of a (b, c) plane on one non-integer point."""
    rng = np.random.RandomState(seed)
    t = T_SIDE * T_SIDE
    shape = (b, c, t, h * w)
    corr = np.tanh(rng.randn(b, c, h, w, T_FULL)).astype(np.float32)
    if kind == "uniform":
        px = rng.rand(*shape) * (w - 1)
        py = rng.rand(*shape) * (h - 1)
    elif kind == "near_identity":
        ti = np.arange(t)
        off_x = ((ti // T_SIDE) - T_SIDE // 2) * (15 / 14) + 0.5
        off_y = ((ti % T_SIDE) - T_SIDE // 2) * (15 / 14) + 0.5
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        px = np.clip(xs.reshape(-1) + off_x[:, None] + (rng.rand(*shape) - 0.5) * 0.5, 0, w - 1)
        py = np.clip(ys.reshape(-1) + off_y[:, None] + (rng.rand(*shape) - 0.5) * 0.5, 0, h - 1)
    elif kind == "integer":
        px = rng.randint(0, w, shape)
        py = rng.randint(0, h, shape)
    elif kind == "border":
        px = rng.randint(0, 2, shape) * (w - 1)
        py = rng.randint(0, 2, shape) * (h - 1)
    elif kind == "collapsed":
        px = np.broadcast_to(rng.rand(b, c, 1, 1) * (w - 1), shape)
        py = np.broadcast_to(rng.rand(b, c, 1, 1) * (h - 1), shape)
    else:
        raise ValueError(kind)
    mask = rng.rand(c, t).astype(np.float32) / t
    g = rng.randn(b, c, h * w).astype(np.float32)
    return (corr, px.astype(np.float32), py.astype(np.float32), mask, g)


def jax_vjp(corr, px, py, mask, g):
    b, c, h, w, _ = corr.shape
    t = px.shape[2]

    def f(corr_full, px_, py_):
        return resample_correlation_from_pxpy(corr_full[..., :t], px_, py_, jnp.asarray(mask),
                                              precision="highest")

    _, vjp = jax.vjp(f, jnp.asarray(corr), jnp.asarray(px), jnp.asarray(py))
    return [np.asarray(x) for x in vjp(jnp.asarray(g.reshape(b, c, h, w)))]


CASES = [((2, 3, 6, 7), kind) for kind in ("uniform", "near_identity", "integer", "border")]
CASES += [((1, 2, 1, 7), "uniform"), ((1, 2, 6, 1), "uniform"), ((1, 2, 1, 7), "integer"),
          ((1, 2, 6, 1), "border"), ((1, 2, 9, 11), "near_identity"),
          ((2, 3, 6, 7), "collapsed"), ((1, 2, 9, 11), "collapsed")]


@pytest.mark.parametrize("shape,kind", CASES, ids=[f"{k}_{'x'.join(map(str, s))}"
                                                   for s, k in CASES])
def test_backward_matches_jax_vjp(shape, kind):
    corr, px, py, mask, g = make_inputs(*shape, kind, seed=sum(shape))
    want = jax_vjp(corr, px, py, mask, g)
    gt = torch.from_numpy(g)
    got = resample_correlation_backward(gt, gt, torch.from_numpy(corr), torch.from_numpy(px),
                                        torch.from_numpy(py), torch.from_numpy(mask))
    for name, x, y in zip(("dcorr", "dpx", "dpy"), got, want):
        np.testing.assert_allclose(x.numpy(), y, rtol=RTOL, atol=ATOL, err_msg=name)
    assert not got[0][..., px.shape[2]:].any(), "channels >= T must stay zero"


def test_torch_autograd_of_the_hat_differs_at_integers():
    """torch.abs has derivative 0 at 0, JAX's +1: autograd of the plain hat
    expression misses the -1 of the column a sample sits on."""
    corr, px, py, mask, g = make_inputs(1, 2, 6, 7, "integer", seed=3)
    want_dpx = jax_vjp(corr, px, py, mask, g)[1]
    pxt = torch.from_numpy(px).requires_grad_(True)
    out = hat_form_torch_autograd(torch.from_numpy(corr), pxt, torch.from_numpy(py),
                                  torch.from_numpy(mask))
    out.backward(torch.from_numpy(g).reshape(out.shape))
    assert np.abs(pxt.grad.numpy() - want_dpx).max() > 1e-3
    _, dpx, _ = resample_correlation_backward(
        torch.from_numpy(g), torch.from_numpy(g), torch.from_numpy(corr), torch.from_numpy(px),
        torch.from_numpy(py), torch.from_numpy(mask))
    np.testing.assert_allclose(dpx.numpy(), want_dpx, rtol=RTOL, atol=ATOL)


def hat_form_torch_autograd(corr, px, py, mask_t):
    """The fp32 hat form written in torch ops, to be differentiated by torch."""
    b, c, h, w, _ = corr.shape
    t = px.shape[2]
    hy = torch.clamp(1 - (py[..., None] - torch.arange(h, dtype=torch.float32)).abs(), min=0)
    hx = torch.clamp(1 - (px[..., None] - torch.arange(w, dtype=torch.float32)).abs(), min=0)
    planes = corr[..., :t].permute(0, 1, 4, 2, 3)  # [B, C, T, H, W]
    r = torch.einsum("bctah,bcthw->bctaw", hy, planes)
    return ((r * hx).sum(-1) * mask_t[None, :, :, None]).sum(2).reshape(b, c, h, w)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_train_function_routes_the_gradients(precision):
    corr, px, py, mask, g = make_inputs(2, 3, 6, 7, "near_identity", seed=11)
    _, _, _, _, g_det = make_inputs(2, 3, 6, 7, "near_identity", seed=12)
    corr_t = torch.from_numpy(corr).requires_grad_(True)
    px_t = torch.from_numpy(px).requires_grad_(True)
    py_t = torch.from_numpy(py).requires_grad_(True)
    mask_t = torch.from_numpy(mask)
    cls, cls_det = resample_correlation_autograd(corr_t, px_t, py_t, mask_t, precision)
    forward = hat_resample_reference if precision == "default" else \
        resample_correlation_from_pxpy_reference
    want = forward(torch.from_numpy(corr)[..., :121], torch.from_numpy(px),
                   torch.from_numpy(py), mask_t)
    torch.testing.assert_close(cls, want, rtol=0, atol=0)
    torch.testing.assert_close(cls_det, want, rtol=0, atol=0)
    ((cls * torch.from_numpy(g).reshape(cls.shape)).sum()
     + (cls_det * torch.from_numpy(g_det).reshape(cls.shape)).sum()).backward()
    g_t, gd_t = torch.from_numpy(g), torch.from_numpy(g_det)
    dcorr, dpx, dpy = resample_correlation_backward(
        g_t, g_t + gd_t, torch.from_numpy(corr), torch.from_numpy(px), torch.from_numpy(py),
        mask_t)
    torch.testing.assert_close(corr_t.grad, dcorr, rtol=0, atol=0)
    torch.testing.assert_close(px_t.grad, dpx, rtol=0, atol=0)
    torch.testing.assert_close(py_t.grad, dpy, rtol=0, atol=0)
    # cls_detached alone moves corr but not px/py
    want_det = jax_vjp(corr, px, py, mask, g_det)
    corr_t.grad = px_t.grad = py_t.grad = None
    cls, cls_det = resample_correlation_autograd(corr_t, px_t, py_t, mask_t, precision)
    (cls_det * gd_t.reshape(cls.shape)).sum().backward()
    np.testing.assert_allclose(corr_t.grad.numpy(), want_det[0], rtol=RTOL, atol=ATOL)
    assert not px_t.grad.any() and not py_t.grad.any()


def test_backward_refuses_a_bad_cotangent():
    corr, px, py, mask, g = make_inputs(1, 2, 6, 7, "uniform", seed=0)
    with pytest.raises(ValueError):
        resample_correlation_backward(
            torch.from_numpy(g)[:, :1], torch.from_numpy(g), torch.from_numpy(corr),
            torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(mask))


def test_cpu_scatter_add_adds_in_index_order():
    """fp32 sums whose value depends on their order: 1 + 2^25 - 2^25 is 0
    in order and 1 in any order that adds the 1 last; every (b, c) row of a
    wide tensor takes them in index order."""
    src = torch.zeros(3, 4, 6000)
    src[..., 0::3], src[..., 1::3], src[..., 2::3] = 1.0, 2.0 ** 25, -(2.0 ** 25)
    index = torch.arange(6000).div(3, rounding_mode="floor").expand(3, 4, 6000).contiguous()
    out = torch.zeros(3, 4, 2000).scatter_add_(2, index, src)
    assert not out.any()


def _dcorr_in_kernel_order(g_sum, px, py, mask, h, w, t_full):
    """dcorr as the kernel's dcorr warps add it, in numpy: per (b, c, t),
    per corner (i, j) in order (1,1), (1,2), (2,1), (2,2), each anchor's
    term hy_i * (gd * hx_j) (both weights non-zero) added into its cell in
    ascending anchor order."""
    b, c, t, a = px.shape
    f32 = np.float32
    dcorr = np.zeros((b, c, a, t_full), f32)

    def weight(p, k, n):
        i = (np.floor(p) - f32(1)) + f32(k)
        r = f32(1) - np.abs(p - i)
        inside = (i >= 0) & (i < n)
        return np.where(inside, np.maximum(r, f32(0)), f32(0)).astype(f32), i

    for bi in range(b):
        for ci in range(c):
            for ti in range(t):
                acc = np.zeros(a, f32)
                x, y = px[bi, ci, ti], py[bi, ci, ti]
                gd = (g_sum[bi, ci] * mask[ci, ti]).astype(f32)
                for ki, kj in ((1, 1), (1, 2), (2, 1), (2, 2)):
                    hx, xi = weight(x, kj, w)
                    hy, yi = weight(y, ki, h)
                    keep = (hx != 0) & (hy != 0)
                    term = (hy * (gd * hx).astype(f32)).astype(f32)
                    cells = (yi * w + xi)[keep].astype(np.int64)
                    np.add.at(acc, cells, term[keep])
                dcorr[bi, ci, :, ti] = acc
    return dcorr.reshape(b, c, h, w, t_full)


@pytest.mark.parametrize("shape,kind", [((2, 3, 6, 7), k) for k in
                                        ("uniform", "near_identity", "integer", "collapsed")]
                         + [((1, 2, 1, 7), "uniform"), ((1, 2, 6, 1), "border")])
def test_dcorr_sums_in_the_kernels_order(shape, kind):
    corr, px, py, mask, g = make_inputs(*shape, kind, seed=5)
    g_sum = (g + np.random.RandomState(6).randn(*g.shape)).astype(np.float32)
    dcorr = resample_correlation_backward(
        torch.from_numpy(g), torch.from_numpy(g_sum), torch.from_numpy(corr),
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(mask))[0]
    want = _dcorr_in_kernel_order(g_sum, px, py, mask, shape[2], shape[3], T_FULL)
    np.testing.assert_array_equal(dcorr.numpy(), want)
