"""OS2D detection head: dense correlation + affine alignment + resampled
pooling. Counterpart of `os2d_tpu/models/head.py` (the reference's
Os2dHead / Os2dAlignment, os2d/modeling/head.py:43-435), eval and train mode.

Classes are a batch axis: class feature maps are precomputed once as
[C, 15, 15, F], and `head_forward` scores any (image batch, class batch)
pair, with C chunked by the caller to bound the correlation tensor.

Anchor geometry: the composed receptive field of backbone (rf 16 / stride 16)
and aligner (rf 15 / stride 1) gives image-level anchors of 240x240 at
stride 16 (os2d/modeling/head.py:222-238).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.geometry import (
    affine_grid_corners,
    affine_grid_envelope,
    clip_jax_grad,
    invert_affine_2x3,
    l2_normalize_channels,
)
from ..ops.resample_grad import FORWARD as RESAMPLE_FORWARD
from ..ops.resample_grad import resample_correlation_autograd
from ..ops.sampling import linspace, resize_bilinear_align_corners
from ..structures.boxes import clip_to_min_size, encode_boxes, strided_anchor_grid
from ..structures.feature_map import (
    ALIGNER_GRID_SIZE,
    ALIGNER_RECEPTIVE_FIELD,
    ALIGNER_STRIDE,
    FEATURE_MAP_RECEPTIVE_FIELD,
    FEATURE_MAP_STRIDE,
    compose_receptive_field,
)

TEMPLATE_H = ALIGNER_GRID_SIZE.h
TEMPLATE_W = ALIGNER_GRID_SIZE.w

# image-level anchor box / stride (240x240, stride 16 with default geometry)
ANCHOR_BOX, ANCHOR_STRIDE = compose_receptive_field(
    FEATURE_MAP_RECEPTIVE_FIELD,
    FEATURE_MAP_STRIDE,
    ALIGNER_RECEPTIVE_FIELD,
    ALIGNER_STRIDE,
)

POOL_BORDER_WIDTH = 2


def _interior_permutation(border: int = POOL_BORDER_WIDTH):
    """Permutation of the t = tx*th + ty template axis that places the
    (15-2*border)^2 INTERIOR points first (in the order the resample consumes)
    and the border points last. The pool mask zeroes the border, so the
    resample reads only the contiguous prefix; the TransformationNet's conv0
    rows are permuted to match."""
    interior = [tx * TEMPLATE_H + ty
                for tx in range(border, TEMPLATE_W - border)
                for ty in range(border, TEMPLATE_H - border)]
    inside = set(interior)
    border_idx = [t for t in range(TEMPLATE_W * TEMPLATE_H) if t not in inside]
    return interior + border_idx


def make_class_pool_mask(num_classes: int, device=None, dtype=torch.float32):
    """[C, 15, 15] pooling mask: border of width 2 zeroed, spatially normalized
    (os2d/modeling/head.py:296-302)."""
    m = torch.zeros((TEMPLATE_H, TEMPLATE_W), dtype=dtype, device=device)
    m[POOL_BORDER_WIDTH: TEMPLATE_H - POOL_BORDER_WIDTH,
      POOL_BORDER_WIDTH: TEMPLATE_W - POOL_BORDER_WIDTH] = 1.0
    m = m / torch.sum(m)
    return m[None].expand(num_classes, TEMPLATE_H, TEMPLATE_W).contiguous()


class ClassHead(NamedTuple):
    """Precomputed per-class state (the reference's Os2dHead closure contents)."""

    class_feats: torch.Tensor  # [C, 15, 15, F], L2-normalized over F
    pool_mask: torch.Tensor  # [C, 15, 15]


def build_class_head(class_feature_maps) -> ClassHead:
    """Resize per-class feature maps to the 15x15 reference size and normalize.

    Args:
      class_feature_maps: list of [h_i, w_i, F] tensors (or [1, h_i, w_i, F]),
        or a single stacked [C, h, w, F] tensor.
    """
    if isinstance(class_feature_maps, (list, tuple)):
        feats = torch.stack([
            resize_bilinear_align_corners(fm[0] if fm.dim() == 4 else fm, TEMPLATE_H, TEMPLATE_W)
            for fm in class_feature_maps
        ])
    else:
        feats = resize_bilinear_align_corners(class_feature_maps, TEMPLATE_H, TEMPLATE_W)
    feats = l2_normalize_channels(feats, eps=1e-5, dim=-1)
    return ClassHead(feats, make_class_pool_mask(feats.shape[0], feats.device, feats.dtype))


def _prepare_theta(tparams, simple_affine: bool):
    """[N, p] regressor outputs -> [N, 2, 3] affine matrices
    (os2d/modeling/head.py:81-107)."""
    if simple_affine:
        z = torch.zeros_like(tparams[:, 0])
        tparams = torch.stack(
            [tparams[:, 0], z, tparams[:, 1], z, tparams[:, 2], tparams[:, 3]], dim=1)
    return tparams.reshape(-1, 2, 3)


def head_forward(
    transform_net,
    image_feature_maps,
    class_head: ClassHead,
    *,
    simple_affine: bool = False,
    use_inverse_geom_model: bool = True,
    resample_precision: str = "default",
    corr_interior_first: bool = True,
):
    """Score every (image, class, anchor) triple.

    Args:
      transform_net: the TransformNet module.
      image_feature_maps: [B, H, W, F] backbone features (not yet normalized).
      class_head: ClassHead with [C, 15, 15, F] normalized feats.
      resample_precision: "default" runs the resample as the bf16 hat-weight
        product with fp32 sums (ops/hat_resample.py, the one-pass bf16 tier of
        os2d_tpu/ops/sampling.py); "high" and "highest" run the fp32 gather
        (ops/resample.py); "int8" is not ported.
      corr_interior_first: only the interior-first channel order (the JAX
        default) is ported.

    The resample goes through `ops.resample_grad` (the tier's forward kernel;
    the hat-form gradient kernel backward), and cls_detached is the same
    scores with px/py detached (os2d_tpu/models/head.py:300-302). Whether a
    graph is recorded follows torch's grad mode: eval runs under no_grad.
    Where JAX differentiates through abs or clip, the port takes JAX's
    derivatives at the ties (ops/geometry.py); the values are torch's.

    Returns dict with:
      loc:           [B, C, 4, A]  SSD-encoded localization w.r.t. 240/16 anchors
      cls:           [B, C, A]     recognition scores in [-1, 1]
      cls_detached:  [B, C, A]     the same, transform detached (cls at eval)
      corners:       [B, C, 8, A]  transformed box corners (detached)
      fm_size:       (H, W)
    with A = H * W, anchor a = h * W + w.
    """
    if resample_precision == "int8":
        raise NotImplementedError("the int8 resample tier is not ported")
    if resample_precision not in RESAMPLE_FORWARD:
        raise ValueError(f"unknown resample_precision {resample_precision!r}")
    if not corr_interior_first:
        raise NotImplementedError(
            "only corr_interior_first=True is ported; the grid path is not")

    b, h, w, f = image_feature_maps.shape
    c = class_head.class_feats.shape[0]
    a = h * w
    t_dim = TEMPLATE_W * TEMPLATE_H
    device = image_feature_maps.device

    fm = l2_normalize_channels(image_feature_maps, eps=1e-5, dim=-1)

    # dense correlation in the interior-first channel order; corr channel of
    # template point (x_c, y_c) is t = x_c * 15 + y_c before the permutation
    # (weakalign order, os2d/modeling/head.py:342-350)
    perm = torch.tensor(_interior_permutation(), device=device)
    feats_t = class_head.class_feats.transpose(1, 2).reshape(c, t_dim, f)[:, perm]
    corr = (fm.reshape(b * a, f) @ feats_t.reshape(c * t_dim, f).T)
    corr = corr.reshape(b, h, w, c, t_dim).permute(0, 3, 1, 2, 4).contiguous()  # [B, C, H, W, T]

    # regress transformation parameters per (image, class, anchor)
    tparams = transform_net(corr.reshape(b * c, h, w, t_dim), conv0_channel_perm=perm)
    theta = _prepare_theta(tparams.reshape(-1, tparams.shape[-1]), simple_affine)
    if use_inverse_geom_model:
        theta = invert_affine_2x3(theta)

    # (1) recognition: sample coordinates straight from theta as an outer
    # product over the interior template lattice, in the resample's t-major
    # [B, C, T, A] layout, w.r.t. feature-map-level anchors (box 15, stride 1)
    bw = POOL_BORDER_WIDTH
    ts = slice(bw, TEMPLATE_H - bw)
    n_side = TEMPLATE_H - 2 * bw
    n_int = n_side * (TEMPLATE_W - 2 * bw)
    mask_t = class_head.pool_mask[:, ts, ts].transpose(1, 2).reshape(c, n_int).contiguous()

    th6 = theta.reshape(b, c, 1, a, 2, 3)
    xs_int = linspace(-1.0, 1.0, TEMPLATE_W, device=device)[ts]
    ys_int = linspace(-1.0, 1.0, TEMPLATE_H, device=device)[ts]
    # t = tx * th_int + ty (the _interior_permutation / weakalign order)
    ux = xs_int.repeat_interleave(n_side)[None, None, :, None]
    uy = ys_int.repeat(TEMPLATE_W - 2 * bw)[None, None, :, None]
    lx = th6[..., 0, 0] * ux + th6[..., 0, 1] * uy + th6[..., 0, 2]
    ly = th6[..., 1, 0] * ux + th6[..., 1, 1] * uy + th6[..., 1, 2]
    fb = strided_anchor_grid(
        w, h, float(ALIGNER_RECEPTIVE_FIELD.w), float(ALIGNER_RECEPTIVE_FIELD.h),
        float(ALIGNER_STRIDE.w), float(ALIGNER_STRIDE.h), device=device,
    ).reshape(1, 1, 1, a, 4)
    fx_a = (fb[..., 2] - fb[..., 0]) / 2.0
    fx_b = (fb[..., 2] + fb[..., 0]) / 2.0
    fy_a = (fb[..., 3] - fb[..., 1]) / 2.0
    fy_b = (fb[..., 3] + fb[..., 1]) / 2.0
    gx = clip_jax_grad((lx * fx_a + fx_b) / (w - 1) * 2.0 - 1.0, -1.0, 1.0)
    gy = clip_jax_grad((ly * fy_a + fy_b) / (h - 1) * 2.0 - 1.0, -1.0, 1.0)
    px = (gx + 1.0) * 0.5 * (w - 1)
    py = (gy + 1.0) * 0.5 * (h - 1)
    cls, cls_detached = resample_correlation_autograd(corr, px, py, mask_t, resample_precision)

    # (2) localization: envelope + corners in closed form from theta w.r.t.
    # image-level anchors (box 240, stride 16)
    boxes_img = strided_anchor_grid(
        w, h, float(ANCHOR_BOX.w), float(ANCHOR_BOX.h),
        float(ANCHOR_STRIDE.w), float(ANCHOR_STRIDE.h), device=device,
    ).reshape(1, 1, h, w, 4)
    th4 = theta.reshape(b, c, h, w, 2, 3)
    ix_a = (boxes_img[..., 2] - boxes_img[..., 0]) / 2.0  # [1, 1, h, w]
    ix_b = (boxes_img[..., 2] + boxes_img[..., 0]) / 2.0
    iy_a = (boxes_img[..., 3] - boxes_img[..., 1]) / 2.0
    iy_b = (boxes_img[..., 3] + boxes_img[..., 1]) / 2.0

    lmin, lmax = affine_grid_envelope(th4)  # [b, c, h, w, 2] each
    class_boxes = torch.stack(
        [
            lmin[..., 0] * ix_a + ix_b,
            lmin[..., 1] * iy_a + iy_b,
            lmax[..., 0] * ix_a + ix_b,
            lmax[..., 1] * iy_a + iy_b,
        ],
        dim=-1,
    )  # [B, C, H, W, 4]
    class_boxes = clip_to_min_size(class_boxes, 1.0)
    default_boxes = clip_to_min_size(boxes_img, 1.0)
    loc = encode_boxes(class_boxes, default_boxes)  # [B, C, H, W, 4]

    cl = affine_grid_corners(th4.detach())  # [b, c, h, w, 4, 2]
    corners = torch.stack(
        [cl[..., 0] * ix_a[..., None] + ix_b[..., None],
         cl[..., 1] * iy_a[..., None] + iy_b[..., None]],
        dim=-1,
    ).reshape(b, c, h, w, 8)

    return {
        "loc": loc.permute(0, 1, 4, 2, 3).reshape(b, c, 4, a),
        "cls": cls.reshape(b, c, a),
        "cls_detached": cls_detached.reshape(b, c, a),
        "corners": corners.permute(0, 1, 4, 2, 3).reshape(b, c, 8, a),
        "fm_size": (h, w),
    }
