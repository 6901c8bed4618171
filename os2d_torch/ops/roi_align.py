"""RoIAlign over channels-last fp32 feature maps: on the card one launch of
`csrc/roi_align_nhwc.cu`, for CPU tensors the plain version; no fallback
from one to the other.

`roi_align(feats, rois, pooled, spatial_scale)`:

  feats  [N, H, W, C] fp32 (NHWC), C a multiple of 4 on the card;
  rois   [R, 5] fp32: (map index, x1, y1, x2, y2) in image pixels;
  ->     [R, pooled, pooled, C] fp32.

The semantics are torchvision's `roi_align(..., sampling_ratio=0,
aligned=False)`, CoAE's legacy coordinates: the RoI scaled by
`spatial_scale`, at least 1 x 1, cut into pooled x pooled bins; each bin the mean of ceil(size / pooled) x ceil(size / pooled)
bilinear samples at the centres of its sub-cells, a sample 0 outside
[-1, H] x [-1, W] and clamped to the last row or column at the border.
Each bin sums its samples in one order (rows of samples outer, columns
inner), every operation rounded on its own, in the kernel and in the plain
version alike, so the two give the same sums and two launches the same
bits (tests/test_torch_coae_card.py).

`KERNEL.launches` counts the kernel's launches since import (the counter
`roi_align.launches`: one a class chunk of a CoAE request); read and reset
by whoever measures them.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import CudaKernel, aligned

_P = ctypes.c_void_p
# feats, rois, out, num_rois, height, width, channels, pooled, spatial_scale,
# stream
KERNEL = CudaKernel("roi_align_nhwc.cu", "os2d_roi_align",
                    [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_float, _P])


def _check(feats, rois, pooled):
    if feats.dim() != 4 or feats.dtype != torch.float32:
        raise ValueError(f"feats must be fp32 [N, H, W, C], got {feats.dtype} "
                         f"{tuple(feats.shape)}")
    if rois.dim() != 2 or rois.shape[1] != 5 or rois.dtype != torch.float32:
        raise ValueError(f"rois must be fp32 [R, 5], got {rois.dtype} {tuple(rois.shape)}")
    if rois.device != feats.device:
        raise ValueError(f"feats on {feats.device} and rois on {rois.device}")
    if pooled < 1:
        raise ValueError(f"pooled must be positive, got {pooled}")


def roi_align(feats, rois, pooled: int = 7, spatial_scale: float = 1.0 / 16):
    """RoIAlign (see the module docstring): the kernel for CUDA tensors,
    the plain version for CPU tensors. The map indices of `rois` must lie in
    [0, N): the kernel does not check them."""
    _check(feats, rois, pooled)
    if feats.device.type == "cpu":
        return roi_align_reference(feats, rois, pooled, spatial_scale)
    if feats.device.type != "cuda":
        raise ValueError(f"roi_align takes CPU or CUDA tensors, got {feats.device}")
    n, h, w, c = feats.shape
    if c % 4:
        raise ValueError(f"the RoIAlign kernel takes a multiple of 4 channels, got {c}")
    r = rois.shape[0]
    out = torch.empty((r, pooled, pooled, c), dtype=torch.float32, device=feats.device)
    if r == 0 or n == 0:
        return out
    feats = aligned(feats)
    rois = rois.contiguous()
    with torch.cuda.device(feats.device):
        KERNEL.launch(feats.data_ptr(), rois.data_ptr(), out.data_ptr(), r, h, w, c, pooled,
                      float(spatial_scale), torch.cuda.current_stream(feats.device).cuda_stream)
    return out


def _axis(v, size: int):
    """torchvision's bilinear_interpolate along one axis: (inside, lo, hi,
    weight of lo, weight of hi) of sample coordinates v."""
    inside = ~((v < -1.0) | (v > size))
    v = torch.where(v <= 0, torch.zeros_like(v), v)
    lo = v.to(torch.int64)
    last = lo >= size - 1
    lo = torch.where(last, size - 1, lo)
    hi = torch.where(last, lo, lo + 1)
    v = torch.where(last, lo.to(v.dtype), v)
    l = v - lo.to(v.dtype)
    return inside, lo, hi, 1.0 - l, l


def roi_align_reference(feats, rois, pooled: int = 7, spatial_scale: float = 1.0 / 16):
    """The plain version of the kernel, for any device: every bin of every
    RoI at once, its samples added one sub-cell at a time (rows outer,
    columns inner, a RoI whose grid is smaller adding nothing past it)."""
    _check(feats, rois, pooled)
    n, h, w, c = feats.shape
    r = rois.shape[0]
    out = feats.new_zeros((r, pooled, pooled, c))
    if r == 0:
        return out
    index = rois[:, 0].to(torch.int64)
    start_w = rois[:, 1] * spatial_scale
    start_h = rois[:, 2] * spatial_scale
    roi_w = (rois[:, 3] * spatial_scale - start_w).clamp(min=1.0)
    roi_h = (rois[:, 4] * spatial_scale - start_h).clamp(min=1.0)
    # divisions by tensors: a CUDA tensor divided by a Python number is
    # multiplied by its reciprocal, which rounds otherwise
    sides = torch.full_like(roi_w, float(pooled))
    bin_w, bin_h = roi_w / sides, roi_h / sides
    grid_w = torch.ceil(roi_w / sides).to(torch.int64)
    grid_h = torch.ceil(roi_h / sides).to(torch.int64)
    count = (grid_h * grid_w).clamp(min=1).to(feats.dtype)
    steps = torch.arange(pooled, dtype=feats.dtype, device=feats.device)
    base_h = start_h[:, None] + steps * bin_h[:, None]  # [R, pooled]
    base_w = start_w[:, None] + steps * bin_w[:, None]
    flat = feats.reshape(n * h * w, c)
    rows = index * (h * w)
    for iy in range(int(grid_h.max())):
        y = base_h + ((iy + 0.5) * bin_h / grid_h.to(feats.dtype))[:, None]
        in_y, y_lo, y_hi, hy, ly = _axis(y, h)
        for ix in range(int(grid_w.max())):
            x = base_w + ((ix + 0.5) * bin_w / grid_w.to(feats.dtype))[:, None]
            in_x, x_lo, x_hi, hx, lx = _axis(x, w)
            use = ((iy < grid_h) & (ix < grid_w))[:, None, None] & in_y[:, :, None] \
                & in_x[:, None, :]  # [R, pooled, pooled]

            def corner(yi, xi):
                return flat[rows[:, None, None] + yi[:, :, None] * w + xi[:, None, :]]

            val = ((hy[:, :, None] * hx[:, None, :])[..., None] * corner(y_lo, x_lo)
                   + (hy[:, :, None] * lx[:, None, :])[..., None] * corner(y_lo, x_hi)
                   + (ly[:, :, None] * hx[:, None, :])[..., None] * corner(y_hi, x_lo)
                   + (ly[:, :, None] * lx[:, None, :])[..., None] * corner(y_hi, x_hi))
            out = torch.where(use[..., None], out + val, out)
    return out / count[:, None, None, None]
