"""Grid/transform geometry ops: counterpart of `os2d_tpu/ops/geometry.py`.

Replacements for F.affine_grid (align_corners=True) and the batched 3x3
torch.inverse used by the reference aligner (os2d/modeling/head.py:111-151,
:184). The closed-form adjugate inverse needs no LAPACK call and no chunking.
"""

from __future__ import annotations

import torch

from .sampling import linspace


def abs_jax_grad(x):
    """|x| whose derivative at 0 is +1, as JAX differentiates `jnp.abs`
    (torch.abs has derivative 0 there). The value equals |x| (a negative
    zero stays -0.0)."""
    return torch.where(x >= 0, x, -x)


def clip_jax_grad(x, lo=None, hi=None):
    """`jnp.clip(x, lo, hi)` with JAX's derivative: through torch.maximum and
    torch.minimum with tensor bounds, which split a tie 0.5/0.5 as JAX's
    max/min do (torch.clamp passes the whole gradient at the bound). The
    bounds are filled on x's device: no copy from the host, no wait."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def l2_normalize_channels(x, eps: float = 1e-6, dim: int = -1):
    """x / (||x||_2 + eps) along `dim`.

    Port of normalize_feature_map_L2 (os2d/modeling/head.py:597-601); note the
    epsilon is added to the norm (not under the sqrt).
    """
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / (norm + eps)


def affine_grid_2d(theta, out_h: int, out_w: int):
    """F.affine_grid(theta, (N, 1, out_h, out_w), align_corners=True), as
    `os2d_tpu.ops.geometry.affine_grid_2d` computes it: explicit
    multiply-adds (t0 * gx + t1 * gy) + t2 over JAX's linspace lattice.

    Args:
      theta: [..., 2, 3] affine matrices mapping OUTPUT grid coords (x, y in
        [-1, 1]) to input coords.
    Returns:
      grid [..., out_h, out_w, 2] with (x, y) coordinates.
    """
    xs = linspace(-1.0, 1.0, out_w, device=theta.device).to(theta.dtype)
    ys = linspace(-1.0, 1.0, out_h, device=theta.device).to(theta.dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [h, w]
    t = theta[..., None, None]  # [..., 2, 3, 1, 1]
    grid_x = t[..., 0, 0, :, :] * gx + t[..., 0, 1, :, :] * gy + t[..., 0, 2, :, :]
    grid_y = t[..., 1, 0, :, :] * gx + t[..., 1, 1, :, :] * gy + t[..., 1, 2, :, :]
    return torch.stack([grid_x, grid_y], dim=-1)


def local_to_global_grid(grids_local, boxes_xyxy):
    """Map grids from box-local [-1, 1] coords to global coordinates
    (os2d/modeling/head.py:18-40; os2d_tpu/ops/geometry.py:123-142).

    Args:
      grids_local: [..., gh, gw, 2] local (x, y) in [-1, 1].
      boxes_xyxy:  [..., 4] boxes, broadcastable against grids_local's leading
        dims (without the gh, gw, 2 suffix).
    Returns:
      [..., gh, gw, 2] global coordinates.
    """
    x_a = (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) / 2.0
    x_b = (boxes_xyxy[..., 2] + boxes_xyxy[..., 0]) / 2.0
    y_a = (boxes_xyxy[..., 3] - boxes_xyxy[..., 1]) / 2.0
    y_b = (boxes_xyxy[..., 3] + boxes_xyxy[..., 1]) / 2.0
    gx = grids_local[..., 0] * x_a[..., None, None] + x_b[..., None, None]
    gy = grids_local[..., 1] * y_a[..., None, None] + y_b[..., None, None]
    return torch.stack([gx, gy], dim=-1)


def interior_sample_coords(theta, anchor_boxes, lattice, h: int, w: int):
    """The resample's sample coordinates px, py [B, C, T, A] of the
    interior-first head (os2d_tpu/models/head.py:254-299), straight from
    theta as an outer product over the template lattice, t = tx * n + ty.

    The same scalar expression per point as the grid path, each product and
    sum a torch op of its own: box-local (t00*ux + t01*uy) + t02 (and row 1
    for y), then ((l * half + center) / (w - 1)) * 2 - 1 clipped to [-1, 1]
    with JAX's derivative, then ((g + 1) * 0.5) * (w - 1). On a CUDA tensor
    ATen divides by the Python scalar (w - 1) as a multiply by fp32(1 /
    fp32(w - 1)), on the CPU it divides; the int8 kernel
    (csrc/int8_hat_resample.cu) forms these coordinates in registers with
    the card's roundings.

    Args:
      theta: [B, C, A, 6] inverted affine transforms, rows (t00, t01, t02,
        t10, t11, t12), A = H * W.
      anchor_boxes: [A, 4] the anchors' feature-map boxes (x0, y0, x1, y1).
      lattice: [2, n] the template points' abscissae and ordinates (the
        interior of `linspace(-1, 1, 15)`), T = n * n.
    Returns (px, py), each [B, C, T, A] float32.
    """
    b, c, a, _ = theta.shape
    n = lattice.shape[1]
    th = theta.reshape(b, c, 1, a, 6)
    ux = lattice[0].repeat_interleave(n)[None, None, :, None]
    uy = lattice[1].repeat(n)[None, None, :, None]
    lx = th[..., 0] * ux + th[..., 1] * uy + th[..., 2]
    ly = th[..., 3] * ux + th[..., 4] * uy + th[..., 5]
    fb = anchor_boxes.reshape(1, 1, 1, a, 4)
    fx_a = (fb[..., 2] - fb[..., 0]) / 2.0
    fx_b = (fb[..., 2] + fb[..., 0]) / 2.0
    fy_a = (fb[..., 3] - fb[..., 1]) / 2.0
    fy_b = (fb[..., 3] + fb[..., 1]) / 2.0
    gx = clip_jax_grad((lx * fx_a + fx_b) / (w - 1) * 2.0 - 1.0, -1.0, 1.0)
    gy = clip_jax_grad((ly * fy_a + fy_b) / (h - 1) * 2.0 - 1.0, -1.0, 1.0)
    px = (gx + 1.0) * 0.5 * (w - 1)
    py = (gy + 1.0) * 0.5 * (h - 1)
    return px, py


def affine_grid_envelope(theta):
    """Tight per-axis envelope of the affine lattice theta @ [ux, uy, 1] over
    (ux, uy) in [-1, 1]^2: each output coordinate is extremized at the +-1
    corners, min = t2 - (|t0| + |t1|), max = t2 + (|t0| + |t1|) per row.

    Args: theta [..., 2, 3]. Returns (mins, maxs), each [..., 2] as (x, y).
    The identity transform puts exact zeros in |t0| + |t1|, so the abs takes
    JAX's derivative +1 at 0 (`abs_jax_grad`).
    """
    ext = abs_jax_grad(theta[..., 0]) + abs_jax_grad(theta[..., 1])
    ctr = theta[..., 2]
    return ctr - ext, ctr + ext


def affine_grid_corners(theta):
    """The 4 corner points of the affine lattice, (t0 * ux + t1 * uy) + t2 at
    (ux, uy) = (+-1, +-1), in the order (uy, ux) in ((-1,-1), (-1,+1),
    (+1,-1), (+1,+1)) (os2d/modeling/head.py:421-425).

    Args: theta [..., 2, 3]. Returns [..., 4, 2] of (x, y) per corner.
    """
    rows = []
    for sy in (-1.0, 1.0):
        for sx in (-1.0, 1.0):
            x = theta[..., 0, 0] * sx + theta[..., 0, 1] * sy + theta[..., 0, 2]
            y = theta[..., 1, 0] * sx + theta[..., 1, 1] * sy + theta[..., 1, 2]
            rows.append(torch.stack([x, y], dim=-1))
    return torch.stack(rows, dim=-2)


def invert_affine_2x3(theta, reg: float = 1e-5):
    """Invert [..., 2, 3] affine transforms (appending the implicit [0,0,1] row).

    Closed form via the 2x2 adjugate; matches torch.inverse on the 3x3 with
    the reference's 1e-5 diagonal regularization retry applied only where the
    2x2 block is (near-)singular, |det| < 1e-12 (os2d/modeling/head.py:125-134).
    Returns [..., 2, 3].
    """
    a, b, c = theta[..., 0, 0], theta[..., 0, 1], theta[..., 0, 2]
    d, e, f = theta[..., 1, 0], theta[..., 1, 1], theta[..., 1, 2]

    det = a * e - b * d
    bad = torch.abs(det) < 1e-12
    # regularized retry: theta_reg = theta + 1e-5 * I (applied to the 3x3, but
    # the [0,0,1+1e-5] bottom row only rescales the inverse translation)
    a_r = torch.where(bad, a + reg, a)
    e_r = torch.where(bad, e + reg, e)
    one = torch.ones_like(a)
    scale_t = torch.where(bad, one * (1.0 / (1.0 + reg)), one)
    det_r = a_r * e_r - b * d

    inv_det = 1.0 / det_r
    ia = e_r * inv_det
    ib = -b * inv_det
    id_ = -d * inv_det
    ie = a_r * inv_det
    # translation of the inverse: -A^{-1} t, rescaled when the regularized
    # bottom-right entry is 1+reg
    ic = -(ia * c + ib * f) * scale_t
    if_ = -(id_ * c + ie * f) * scale_t

    row0 = torch.stack([ia, ib, ic], dim=-1)
    row1 = torch.stack([id_, ie, if_], dim=-1)
    return torch.stack([row0, row1], dim=-2)
