"""Bilinear sampling ops: align-corners resize, the antialiased pyramid
resize, the plain versions of the three correlation-map resamples and the
grid contract of the resample.

Counterpart of `os2d_tpu/ops/sampling.py`. The resample itself runs through
`ops/resample.py` (fp32 gather; its CUDA kernel is held against
`resample_correlation_from_pxpy_reference` below), `ops/hat_resample.py`
(bf16 hat-weight form; its CUDA kernel is held against
`hat_resample_reference` below) or `ops/int8_resample.py` (the int8 hat
form; its CUDA kernel is held against `int8_hat_resample_reference` below).
`resample_correlation_map` and `resample_correlation_map_masked` take
the [B, C, H, W, th, tw, 2] sampling grids of the Pallas kernels' contract
(the head's `corr_interior_first=False` path) and run the tier's forward.
"""

from __future__ import annotations

import numpy as np
import torch


def linspace(start: float, stop: float, num: int, device=None):
    """float32 linspace, value for value as JAX computes `jnp.linspace` with
    constant ends: start * (1 - i*r) + i * (r*stop) with r = 1/(num-1) in
    float32 (XLA turns the division into a multiply by r and folds r*stop),
    and the endpoint exact. torch.linspace and numpy round some points
    differently by an ulp, which moves align-corners weights by ~1e-6."""
    f32 = torch.float32
    if num == 1:
        return torch.full((1,), start, dtype=f32, device=device)
    r = torch.tensor(1.0 / (num - 1), dtype=f32, device=device)
    i = torch.arange(num - 1, dtype=f32, device=device)
    out = start * (1 - i * r) + i * (r * stop)
    return torch.cat([out, torch.full((1,), stop, dtype=f32, device=device)])


def _interp_matrix(out_size: int, in_size: int, device=None, dtype=torch.float32):
    """[out, in] bilinear interpolation matrix with align_corners=True, in
    `dtype` (the input's, as JAX builds it): positions and weights in fp32,
    each weight rounded to `dtype` and added into the matrix in it."""
    if in_size == 1:
        return torch.ones((out_size, 1), dtype=dtype, device=device)
    if out_size == 1:
        # align_corners with a single output point samples coordinate -1 -> 0
        m = torch.zeros((1, in_size), dtype=dtype, device=device)
        m[0, 0] = 1.0
        return m
    pos = linspace(0.0, in_size - 1.0, out_size, device=device)
    i0 = torch.floor(pos).clamp(0, in_size - 1).long()
    i1 = (i0 + 1).clamp(0, in_size - 1)
    w1 = pos - i0.float()
    w0 = 1.0 - w1
    rows = torch.arange(out_size, device=device)
    m = torch.zeros((out_size, in_size), dtype=dtype, device=device)
    m.index_put_((rows, i0), w0.to(dtype), accumulate=True)
    m.index_put_((rows, i1), w1.to(dtype), accumulate=True)
    return m


def resize_bilinear_align_corners(x, out_h: int, out_w: int):
    """Bilinear resize with align_corners=True on NHWC (or HWC) input.

    Exactly equivalent to F.grid_sample over an identity F.affine_grid
    (both align_corners=True), the way the reference resizes class feature
    maps to 15x15 (os2d/modeling/head.py:240-259). Two dense matmuls.
    """
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    m_h = _interp_matrix(out_h, h, x.device, x.dtype)
    m_w = _interp_matrix(out_w, w, x.device, x.dtype)
    y = torch.einsum("oh,nhwc->nowc", m_h, x)
    y = torch.einsum("pw,nowc->nopc", m_w, y)
    return y[0] if squeeze else y


def _antialias_weight_matrix(in_size: int, out_size: int, device=None):
    """[in, out] weights of `jax.image.resize(method="bilinear",
    antialias=True)` along one axis (jax/_src/image/scale.py,
    compute_weight_mat): the triangle kernel, widened by 1/scale when
    downsampling, normalized over the input axis and zeroed where the sample
    falls outside the input. Every step runs in float32 as JAX runs it."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)
    inv_scale_t = torch.tensor(inv_scale, dtype=f32, device=device)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32, device=device)
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale_t - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None])
    weights = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear_antialias(images, out_h: int, out_w: int):
    """[B, H, W, C] float -> [B, out_h, out_w, C], matching
    `jax.image.resize(images, (B, out_h, out_w, C), "bilinear",
    antialias=True)` to fp32 rounding: one weight matrix per resized axis,
    applied as two matmuls. An axis whose size does not change is skipped,
    as JAX skips it (its weights would be the identity)."""
    _, h, w, _ = images.shape
    y = images
    if out_h != h:
        y = torch.einsum("bhwc,ho->bowc", y, _antialias_weight_matrix(h, out_h, y.device))
    if out_w != w:
        y = torch.einsum("bhwc,wp->bhpc", y, _antialias_weight_matrix(w, out_w, y.device))
    return y


def resample_correlation_from_pxpy_reference(corr, px, py, mask_t):
    """Plain PyTorch resample + masked pool of the correlation tensor, on the
    t-major contract of `os2d_tpu.ops.sampling.resample_correlation_from_pxpy`
    in the gather form of `resample_correlation_map_gather`.

    For every (b, c, anchor) and template point t, samples channel t of corr
    bilinearly at (px, py): floor, weights from the unclamped floor, corner
    indices clamped to the map (border padding, align_corners), then weights
    the sample by mask_t[c, t] and sums over t in fp32.

    The sum runs over t in order, one rounded multiply or add at a time, as
    the CUDA kernel computes it, so the two agree to the last bit on the card.

    Args:
      corr: [B, C, H, W, T_full] with T_full >= T; channel t < T is read (a
        prefix view such as corr[..., :121] is taken as it is, not copied).
      px, py: [B, C, T, A] pixel-space sample coordinates, A = H * W.
      mask_t: [C, T] pool mask in the same t order.
    Returns scores [B, C, H, W].
    """
    b, c, h, w, _ = corr.shape
    a = h * w
    planes = corr.reshape(b, c, a, corr.shape[-1])  # [B, C, A, T_full]

    def gather(plane, yi, xi):
        return torch.gather(plane, 2, yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))

    scores = torch.zeros((b, c, a), dtype=torch.float32, device=corr.device)
    for t in range(px.shape[2]):
        plane = planes[..., t]  # [B, C, A]
        x0 = torch.floor(px[:, :, t])
        y0 = torch.floor(py[:, :, t])
        wx = px[:, :, t] - x0
        wy = py[:, :, t] - y0
        x0i = x0.long()
        y0i = y0.long()
        sampled = (
            gather(plane, y0i, x0i) * (1 - wx) * (1 - wy)
            + gather(plane, y0i, x0i + 1) * wx * (1 - wy)
            + gather(plane, y0i + 1, x0i) * (1 - wx) * wy
            + gather(plane, y0i + 1, x0i + 1) * wx * wy
        )  # [B, C, A]
        scores = scores + sampled * mask_t[None, :, t, None]
    return scores.reshape(b, c, h, w)


def hat_resample_operand(corr, mask_t):
    """The hat resample's bf16 values M [B, C, T, H, W], contiguous, for the
    plain version: corr[..., t] * mask_t[c, t] multiplied in fp32, then
    rounded to bf16 (the order of `os2d_tpu/ops/pallas_hat_resample.py`,
    which folds the mask into corr before its in-kernel cast). The CUDA
    kernel forms the same values as it loads corr and builds no such
    tensor."""
    b, c, h, w, _ = corr.shape
    t = mask_t.shape[1]
    m = torch.empty((b, c, t, h, w), dtype=torch.bfloat16, device=corr.device)
    torch.mul(corr[..., :t].permute(0, 1, 4, 2, 3), mask_t[None, :, :, None, None], out=m)
    return m


def _hat(p, iota):
    return torch.clamp(1.0 - (p[..., None] - iota).abs(), min=0.0)


def _hat_axis_terms(p, n: int):
    """The four indices floor(p) - 1 .. floor(p) + 2 of one axis, each with
    its hat weight max(0, 1 - |p - i|) and the derivative of that weight by
    p under JAX's rules (abs' (0) = +1, a max tie split 0.5): -sign(p - i)
    where |p - i| < 1, half of it where |p - i| == 1, 0 elsewhere. The
    difference p - i is taken rounded in fp32, as JAX takes it. Indices
    outside [0, n) get weight and derivative 0 (the hat form drops them) and
    are returned clamped. Only offsets 1 and 2 can carry a non-zero weight;
    a derivative can sit at any of the four (at ties)."""
    base = torch.floor(p) - 1.0
    idx, weights, derivs = [], [], []
    for k in range(4):
        i = base + k
        diff = p - i
        ad = diff.abs()
        sign = torch.where(diff >= 0, -1.0, 1.0)
        der = torch.where(ad < 1.0, sign, torch.where(ad == 1.0, 0.5 * sign, 0.0))
        ii = i.long()
        inside = (ii >= 0) & (ii < n)
        idx.append(ii.clamp(0, n - 1))
        weights.append(torch.where(inside, torch.clamp(1.0 - ad, min=0.0), 0.0))
        derivs.append(torch.where(inside, der, 0.0))
    return idx, weights, derivs


def resample_backward_reference(g, g_sum, corr, px, py, mask_t, t_count: int):
    """Plain PyTorch gradient of the resample + masked pool in the hat form,
    under JAX's differentiation rules: what `jax.vjp` of
    `os2d_tpu.ops.sampling.resample_correlation_from_pxpy` gives (the JAX
    trainer differentiates that form at every tier), written out as a formula
    rather than taken by torch autograd, whose tie rules differ.

    With go = g * mask[c, t], gd = g_sum * mask[c, t] and the hat weights
    hy_i(py), hx_j(px) and their derivatives dhy_i, dhx_j of `_hat_axis_terms`:
      dpx     = sum_j dhx_j * (go * r_j),  r_j = hy_1 v[1, j] + hy_2 v[2, j]
      dpy     = sum_i dhy_i * ((go * hx_1) v[i, 1] + (go * hx_2) v[i, 2])
      dcorr  += hy_i * (gd * hx_j) at the (at most 2x2) cells with both
                weights non-zero, v[i, j] = corr at row y0 - 1 + i, column
                x0 - 1 + j, channel t,
    each product and sum rounded on its own, the sums over i and j in index
    order; the CUDA kernel (csrc/resample_backward.cu) computes dpx and dpy
    in exactly this order and so agrees with this function to the bit, and
    dcorr up to the order of its atomic sums.

    Args:
      g: [B, C, A] gradient of the scores, for dpx/dpy and dcorr.
      g_sum: [B, C, A] gradient for dcorr: g plus that of a second output
        whose sample coordinates are detached (the head's cls_detached).
      corr: [B, C, H, W, T_full] full correlation tensor; channels < t_count
        are read.
      px, py: [B, C, T, A]; mask_t: [C, T], T = t_count.
    Returns (dcorr [B, C, H, W, T_full] with channels >= T zero, dpx, dpy).
    """
    b, c, h, w, t_full = corr.shape
    a = h * w
    planes = corr.reshape(b, c, a, t_full)
    dcorr = torch.zeros((b, c, a, t_full), dtype=torch.float32, device=corr.device)
    dpx = torch.empty_like(px)
    dpy = torch.empty_like(py)
    for t in range(t_count):
        plane = planes[..., t]
        m = mask_t[None, :, t, None]
        go = g * m
        gd = g_sum * m
        xi, hx, dhx = _hat_axis_terms(px[:, :, t], w)
        yi, hy, dhy = _hat_axis_terms(py[:, :, t], h)

        def v(i, j):
            return torch.gather(plane, 2, yi[i] * w + xi[j])

        sx = torch.zeros_like(go)
        for j in range(4):
            r = hy[1] * v(1, j) + hy[2] * v(2, j)
            sx = sx + dhx[j] * (go * r)
        sy = torch.zeros_like(go)
        gx1, gx2 = go * hx[1], go * hx[2]
        for i in range(4):
            sy = sy + dhy[i] * (gx1 * v(i, 1) + gx2 * v(i, 2))
        dpx[:, :, t] = sx
        dpy[:, :, t] = sy
        acc = torch.zeros_like(go)
        for i in (1, 2):
            for j in (1, 2):
                contrib = torch.where((hy[i] != 0) & (hx[j] != 0), hy[i] * (gd * hx[j]), 0.0)
                acc.scatter_add_(2, yi[i] * w + xi[j], contrib)
        dcorr[..., t] = acc
    return dcorr.reshape(b, c, h, w, t_full), dpx, dpy


def hat_resample_reference(corr, px, py, mask_t):
    """Plain PyTorch version of the `"default"`-tier resample + masked pool
    (the hat-weight form of `os2d_tpu/ops/pallas_hat_resample.py`), on the
    t-major contract of `resample_correlation_from_pxpy_reference`:

      out[b, c, a] = sum_t sum_w (wy_t @ M_t)[a, w] * wx_t[a, w]

    with M = `hat_resample_operand(corr, mask_t)` (bf16), the hat rows
    wy_t[a, h] = max(0, 1 - |py - h|) rounded to bf16, wx_t[a, w] =
    max(0, 1 - |px - w|) in fp32, and every sum in fp32, t in order. A hat
    row has two non-zero weights at most, the products of bf16 values are
    exact in fp32, and the other terms are exact zeros, so this equals the
    banded sum that the CUDA kernel computes (two rows, then two columns,
    each product and sum rounded on its own) to the bit.

    Args:
      corr: [B, C, H, W, T_full] with T_full >= T (a prefix view is taken
        as it is).
      px, py: [B, C, T, A] pixel-space sample coordinates, A = H * W.
      mask_t: [C, T] pool mask in the same t order.
    Returns scores [B, C, H, W].
    """
    b, c, h, w, _ = corr.shape
    f32 = torch.float32
    m = hat_resample_operand(corr, mask_t).to(f32)  # bf16 values, exact in fp32
    iota_h = torch.arange(h, dtype=f32, device=corr.device)
    iota_w = torch.arange(w, dtype=f32, device=corr.device)
    scores = torch.zeros((b, c, h * w), dtype=f32, device=corr.device)
    for t in range(px.shape[2]):
        wy = _hat(py[:, :, t], iota_h).to(torch.bfloat16).to(f32)  # [B, C, A, H]
        r = torch.matmul(wy, m[:, :, t])  # [B, C, A, W]: exact products, fp32 sums
        scores = scores + (r * _hat(px[:, :, t], iota_w)).sum(-1)
    return scores.reshape(b, c, h, w)


# JAX's 1.0 / (127.0 * 127.0), the Python float cast to the fp32 of the row
# sums it scales (os2d_tpu/ops/sampling.py:227)
INT8_ROW_SCALE = float(np.float32(1.0 / (127.0 * 127.0)))


def quantize_int8(x):
    """clamp(round(x * 127), -127, 127) in fp32: the int8 tier's corr values
    (round half to even, as jnp.round and the kernel's rintf)."""
    return torch.clamp(torch.round(x * 127.0), -127.0, 127.0)


def int8_hat_resample_reference(corr, px, py, mask_t):
    """Plain PyTorch version of the `"int8"`-tier resample + masked pool
    (the int8 branch of `os2d_tpu.ops.sampling.resample_correlation_from_pxpy`,
    which JAX runs as XLA einsums on the int8 matrix unit), on the t-major
    contract of `resample_correlation_from_pxpy_reference`:

      q[h, w]    = clamp(round(corr[b, c, h, w, t] * 127), -127, 127)
      wq_t[a, h] = round(max(0, 1 - |py - h|) * 127)
      r_t[a, w]  = sum_h wq_t[a, h] q[h, w]                      (exact integers)
      out[b, c, a] = sum_t (sum_w (r_t[a, w] * K) * wx_t[a, w]) * mask_t[c, t]

    with K = fp32(1 / (127 * 127)), wx_t[a, w] = max(0, 1 - |px - w|) in
    fp32, every product and sum rounded in fp32, t in order. q and wq are
    integers held in fp32: their products and the sum of a hat row's two
    non-zero terms are exact, and the other terms of the matrix product and
    of the sum over w are exact zeros, so this equals the banded sum that
    the CUDA kernel computes to the bit. JAX sums each chunk of 8 template
    points before adding it, so the two packages differ in the last bits.

    Args and result: those of `hat_resample_reference`.
    """
    b, c, h, w, _ = corr.shape
    f32 = torch.float32
    t_count = px.shape[2]
    q = quantize_int8(corr[..., :t_count].permute(0, 1, 4, 2, 3))  # [B, C, T, H, W]
    iota_h = torch.arange(h, dtype=f32, device=corr.device)
    iota_w = torch.arange(w, dtype=f32, device=corr.device)
    k = torch.tensor(INT8_ROW_SCALE, dtype=f32, device=corr.device)
    scores = torch.zeros((b, c, h * w), dtype=f32, device=corr.device)
    for t in range(t_count):
        wq = torch.round(_hat(py[:, :, t], iota_h) * 127.0)  # [B, C, A, H]
        r = torch.matmul(wq, q[:, :, t]) * k  # [B, C, A, W]: exact integer sums, scaled
        term = (r * _hat(px[:, :, t], iota_w)).sum(-1)
        scores = scores + term * mask_t[None, :, t, None]
    return scores.reshape(b, c, h, w)


def grid_resample_operands(corr, grids_unit, pool_mask, border: int = 0):
    """The grid contract of both Pallas kernels (os2d_tpu/ops/sampling.py:
    109-145, 317-335) -> the t-major operands of the resample kernels.

    Args:
      corr: [B, C, H, W, T] correlation maps in the NATURAL template order,
        channel t = tx * th + ty.
      grids_unit: [B, C, H, W, th, tw, 2] normalized (x, y) in [-1, 1].
      pool_mask: [C, th, tw].
      border: template points within `border` of the edge are left out (the
        pool mask is zero there): the (th - 2 border) x (tw - 2 border)
        interior channels are compacted out of corr by a strided copy.
    Returns (corr_in [B, C, H, W, T'] contiguous, px, py [B, C, T', A],
    mask_t [C, T']), t' = tx' * th' + ty' over the kept lattice.
    """
    th, tw = grids_unit.shape[-3], grids_unit.shape[-2]
    if border:
        ts = slice(border, th - border)
        lead = corr.shape[:-1]
        corr = corr.reshape(lead + (tw, th))[..., ts, ts]
        th, tw = th - 2 * border, tw - 2 * border
        corr = corr.reshape(lead + (tw * th,))
        grids_unit = grids_unit[..., ts, ts, :]
        pool_mask = pool_mask[..., ts, ts]
    b, c, h, w, t = corr.shape
    if th * tw != t:
        raise ValueError(f"grids of {th}x{tw} template points for {t} corr channels")
    a = h * w
    grids = grids_unit.reshape(b, c, a, th, tw, 2)
    px = (grids[..., 0] + 1.0) * 0.5 * (w - 1)
    py = (grids[..., 1] + 1.0) * 0.5 * (h - 1)
    # [B, C, A, th, tw] -> [B, C, T, A] with T-index = tx*th + ty
    px = px.permute(0, 1, 4, 3, 2).reshape(b, c, t, a).contiguous()
    py = py.permute(0, 1, 4, 3, 2).reshape(b, c, t, a).contiguous()
    mask_t = pool_mask.transpose(1, 2).reshape(c, t).float().contiguous()
    return corr.contiguous(), px, py, mask_t


def resample_correlation_map(corr, grids_unit, pool_mask, precision: str = "default"):
    """Scores [B, C, H, W] of the resample + masked pool on the grid contract
    of the Pallas kernels (`os2d_tpu.ops.sampling.resample_correlation_map`):
    the grids turned into t-major px/py, then the tier's forward
    (`ops/resample_grad.py`, differentiable by corr and the grids)."""
    from .resample_grad import resample_correlation_autograd

    return resample_correlation_autograd(
        *grid_resample_operands(corr, grids_unit, pool_mask), precision)[0]


def resample_correlation_map_masked(corr, grids_unit, pool_mask, border: int,
                                    precision: str = "high"):
    """`resample_correlation_map` over the pool mask's interior only
    (`os2d_tpu.ops.sampling.resample_correlation_map_masked`): the interior
    channels are compacted out of the natural 225-channel order, and the
    border's template points, whose mask is zero, are not sampled."""
    from .resample_grad import resample_correlation_autograd

    return resample_correlation_autograd(
        *grid_resample_operands(corr, grids_unit, pool_mask, border), precision)[0]
