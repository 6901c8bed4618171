"""Grid/transform geometry ops: the eval-path part of `os2d_tpu/ops/geometry.py`.

Replacements for F.affine_grid (align_corners=True) and the batched 3x3
torch.inverse used by the reference aligner (os2d/modeling/head.py:111-151,
:184). The closed-form adjugate inverse needs no LAPACK call and no chunking.
"""

from __future__ import annotations

import torch


def l2_normalize_channels(x, eps: float = 1e-6, dim: int = -1):
    """x / (||x||_2 + eps) along `dim`.

    Port of normalize_feature_map_L2 (os2d/modeling/head.py:597-601); note the
    epsilon is added to the norm (not under the sqrt).
    """
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / (norm + eps)


def affine_grid_envelope(theta):
    """Tight per-axis envelope of the affine lattice theta @ [ux, uy, 1] over
    (ux, uy) in [-1, 1]^2: each output coordinate is extremized at the +-1
    corners, min = t2 - (|t0| + |t1|), max = t2 + (|t0| + |t1|) per row.

    Args: theta [..., 2, 3]. Returns (mins, maxs), each [..., 2] as (x, y).
    """
    ext = torch.abs(theta[..., 0]) + torch.abs(theta[..., 1])
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
