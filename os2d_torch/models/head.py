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

import collections
import threading
from typing import NamedTuple

import torch

from ..ops.geometry import (
    affine_grid_2d,
    affine_grid_corners,
    affine_grid_envelope,
    clip_jax_grad,
    interior_sample_coords,
    invert_affine_2x3,
    l2_normalize_channels,
    local_to_global_grid,
)
from ..ops.int8_resample import resample_correlation_int8_theta
from ..ops.resample_grad import FORWARD as RESAMPLE_FORWARD
from ..ops.resample_grad import records_graph, resample_correlation_autograd
from ..ops.sampling import grid_resample_operands, linspace, resize_bilinear_align_corners
from ..structures.boxes import clip_to_min_size, encode_boxes, strided_anchor_grid
from ..structures.feature_map import (
    ALIGNER_GRID_SIZE,
    ALIGNER_RECEPTIVE_FIELD,
    ALIGNER_STRIDE,
    FEATURE_MAP_RECEPTIVE_FIELD,
    FEATURE_MAP_STRIDE,
    compose_receptive_field,
)
from ..utils.profiling import annotate, host_constant

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


class HeadConstants(NamedTuple):
    """The head's tensors that depend only on the device and the feature
    map's (h, w), read-only."""

    perm: torch.Tensor  # [225] int64: `_interior_permutation()`
    lattice: torch.Tensor  # [2, 11] fp32: the interior template lattice, x then y
    fb: torch.Tensor  # [h*w, 4]: feature-map-level anchors (box 15, stride 1)
    # [1, 1, h, w] each, of the image-level anchors (box 240, stride 16):
    ix_a: torch.Tensor  # half width
    ix_b: torch.Tensor  # x centre
    iy_a: torch.Tensor  # half height
    iy_b: torch.Tensor  # y centre
    default_boxes: torch.Tensor  # [1, 1, h, w, 4]: the anchors, clip_to_min_size(., 1.0)


class HeadConstantCache:
    """`lookup(device, h, w)` -> HeadConstants, built on the device at the
    first lookup of its key and then reused.

    None of these tensors depends on the input. Building them copies host
    values (`host_constant`: the permutation and the two lattice rows), and
    on a card each such copy waits for the stream to drain; a lookup of a
    built entry copies nothing and waits for nothing, so a head call's
    launches queue behind the work before it.

    - A build runs `host_constant`, `linspace` and `strided_anchor_grid` on
      the device, so the values are those of the same expressions computed
      per call, to the bit. The permutation and the lattice are built once
      per device, the anchors once per (device, h, w).
    - On a card a build ends in one wait for its stream (span
      `os2d.wait.constant`), so an entry is complete before any stream
      reads it: serving and mining run the head on threads of their own.
    - The tensors are read-only: no caller writes them in place.
    - At most MAX_SHAPES shape entries are held, the least recently used
      evicted first, so varied image sizes do not grow the cache without
      bound.

    Counters since it was made, read and reset by whoever measures them:
    `lookups` (head calls) and `builds` (shape entries built)."""

    MAX_SHAPES = 64

    def __init__(self):
        self.lookups = 0
        self.builds = 0
        self._lock = threading.Lock()
        self._by_device = {}  # device -> (perm, lattice)
        self._by_shape = collections.OrderedDict()  # (device, h, w) -> HeadConstants

    def lookup(self, device, h: int, w: int) -> HeadConstants:
        key = (torch.device(device), h, w)
        with self._lock:
            self.lookups += 1
            entry = self._by_shape.get(key)
            if entry is None:
                entry = self._by_shape[key] = self._build(*key)
                self.builds += 1
                if len(self._by_shape) > self.MAX_SHAPES:
                    self._by_shape.popitem(last=False)
            else:
                self._by_shape.move_to_end(key)
            return entry

    def clear(self) -> None:
        """Drop every entry (the counters stay)."""
        with self._lock:
            self._by_device.clear()
            self._by_shape.clear()

    def _build(self, device, h, w) -> HeadConstants:
        if device not in self._by_device:
            ts = slice(POOL_BORDER_WIDTH, TEMPLATE_H - POOL_BORDER_WIDTH)
            # t = tx * th_int + ty (the _interior_permutation / weakalign order)
            self._by_device[device] = (
                host_constant(_interior_permutation(), device=device),
                torch.stack([linspace(-1.0, 1.0, TEMPLATE_W, device=device)[ts],
                             linspace(-1.0, 1.0, TEMPLATE_H, device=device)[ts]]))
        perm, lattice = self._by_device[device]
        fb = strided_anchor_grid(
            w, h, float(ALIGNER_RECEPTIVE_FIELD.w), float(ALIGNER_RECEPTIVE_FIELD.h),
            float(ALIGNER_STRIDE.w), float(ALIGNER_STRIDE.h), device=device,
        )
        boxes_img = strided_anchor_grid(
            w, h, float(ANCHOR_BOX.w), float(ANCHOR_BOX.h),
            float(ANCHOR_STRIDE.w), float(ANCHOR_STRIDE.h), device=device,
        ).reshape(1, 1, h, w, 4)
        entry = HeadConstants(
            perm, lattice, fb,
            (boxes_img[..., 2] - boxes_img[..., 0]) / 2.0,
            (boxes_img[..., 2] + boxes_img[..., 0]) / 2.0,
            (boxes_img[..., 3] - boxes_img[..., 1]) / 2.0,
            (boxes_img[..., 3] + boxes_img[..., 1]) / 2.0,
            clip_to_min_size(boxes_img, 1.0))
        if device.type == "cuda":
            with annotate("os2d.wait.constant"):
                torch.cuda.current_stream(device).synchronize()
        return entry


head_constants = HeadConstantCache()


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


class QuantizedClassHead(NamedTuple):
    """int8-quantized class-feature bank (os2d_tpu/models/head.py:118-133):
    a quarter of the fp32 bank's device memory. Features are L2-normalized
    over F, so per-class absmax scaling keeps the quantization step near
    absmax/127. The bank stays int8 on the device; each class chunk is
    dequantized there when the head runs (`Os2dModel.apply_head`)."""

    class_feats_q: torch.Tensor  # [C, 15, 15, F] int8
    scales: torch.Tensor  # [C] fp32: absmax / 127
    pool_mask: torch.Tensor  # [C, 15, 15]


def quantize_class_head(head: ClassHead) -> QuantizedClassHead:
    """Per-class absmax / 127 scales and round-half-to-even int8 values, as
    `os2d_tpu.models.head.quantize_class_head` (torch.round rounds half to
    even, as jnp.round)."""
    absmax = head.class_feats.abs().amax(dim=(1, 2, 3))
    scales = (torch.clamp(absmax, min=1e-12) / 127.0).float()
    q = torch.clamp(torch.round(head.class_feats / scales[:, None, None, None]), -127, 127)
    return QuantizedClassHead(q.to(torch.int8), scales, head.pool_mask)


def dequantize_class_head(qhead: QuantizedClassHead) -> ClassHead:
    """int8 values times their class's scale, in fp32."""
    feats = qhead.class_feats_q.float() * qhead.scales[:, None, None, None]
    return ClassHead(feats, qhead.pool_mask)


def correlation_gemm(a, b, compute_dtype=torch.float32):
    """a [M, F] @ b [N, F].T with both operands rounded to `compute_dtype`
    and an fp32 result: JAX's einsum with preferred_element_type=float32
    (os2d_tpu/models/head.py:219-224). The correlation stays fp32 in every
    mode (the prescreen's margins and both resample kernels take fp32 corr);
    torch.matmul on bf16 operands would return bf16, rounding corr to 8 bits.
    With bfloat16 operands on the card and no gradient to record, this is
    cuBLAS's bf16 GEMM with fp32 sums and an fp32 output
    (`torch.mm(..., out_dtype=torch.float32)`; Os2dModel forbids bf16
    reductions). Elsewhere, on the CPU (which has no such GEMM) and in
    training (it has no autograd formula), the bf16-rounded operands are
    upcast for one fp32 GEMM with TF32 off: their products are exact in
    fp32, so only the order of the fp32 sums differs."""
    if compute_dtype == torch.float32:
        return a @ b.T
    a, b = a.to(compute_dtype), b.to(compute_dtype)
    if a.is_cuda and not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a.float() @ b.float().T


def _prepare_theta(tparams, simple_affine: bool):
    """[N, p] regressor outputs -> [N, 2, 3] affine matrices
    (os2d/modeling/head.py:81-107)."""
    if simple_affine:
        z = torch.zeros_like(tparams[:, 0])
        tparams = torch.stack(
            [tparams[:, 0], z, tparams[:, 1], z, tparams[:, 2], tparams[:, 3]], dim=1)
    return tparams.reshape(-1, 2, 3)


def _interior_first_resample(corr, theta, anchor_boxes, lattice, pool_mask, precision: str):
    """(cls, cls_detached) on the interior-first corr: sample coordinates
    straight from theta over the interior template lattice
    (`ops.geometry.interior_sample_coords`, the same scalar expression per
    point as the grid path, os2d_tpu/models/head.py:254-299), and the
    resample reads the interior prefix of corr as it is. The int8 tier,
    where no graph is recorded, takes theta itself: its kernel forms the
    coordinates in registers, and no [B, C, T, A] px/py is built."""
    b, c, h, w, _ = corr.shape
    a = h * w
    bw = POOL_BORDER_WIDTH
    ts = slice(bw, TEMPLATE_H - bw)
    n_int = (TEMPLATE_H - 2 * bw) * (TEMPLATE_W - 2 * bw)
    # a bfloat16 bank's pool mask takes the fp32 of its rounded values, as
    # JAX casts it to corr's dtype (os2d_tpu/ops/sampling.py:182)
    mask_t = pool_mask[:, ts, ts].transpose(1, 2).reshape(c, n_int)
    mask_t = mask_t.float().contiguous()
    theta = theta.reshape(b, c, a, 6)
    if precision == "int8" and not records_graph(corr, theta):
        cls = resample_correlation_int8_theta(corr[..., :n_int], theta.contiguous(),
                                              anchor_boxes, lattice, mask_t)
        return cls, cls.clone()
    px, py = interior_sample_coords(theta, anchor_boxes, lattice, h, w)
    return resample_correlation_autograd(corr, px, py, mask_t, precision)


def head_forward(
    transform_net,
    image_feature_maps,
    class_head: ClassHead,
    *,
    simple_affine: bool = False,
    use_inverse_geom_model: bool = True,
    resample_precision: str = "default",
    corr_interior_first: bool = True,
    compute_dtype=torch.float32,
):
    """Score every (image, class, anchor) triple.

    Args:
      transform_net: the TransformNet module.
      image_feature_maps: [B, H, W, F] backbone features (not yet normalized).
      class_head: ClassHead with [C, 15, 15, F] normalized feats.
      resample_precision: "default" runs the resample as the bf16 hat-weight
        product with fp32 sums (ops/hat_resample.py, the one-pass bf16 tier of
        os2d_tpu/ops/sampling.py); "high" and "highest" run the fp32 gather
        (ops/resample.py); "int8" runs the int8 hat form (ops/int8_resample.py)
        and, where a graph is recorded, "default" in its place (it has no
        gradient, os2d_tpu/models/head.py:248-251).
      corr_interior_first: True (the JAX default) emits corr with the pool
        mask's interior channels first, so the resample reads a prefix view,
        and computes px/py straight from theta; False keeps the natural
        channel order and runs the grid path of os2d_tpu/models/head.py:
        305-322 (affine grids, box-local to global, normalize, clip, then
        the interior compacted out of corr by a strided copy).
      compute_dtype: the correlation's operands are rounded to it and its
        output is fp32 (`correlation_gemm`); the TransformNet follows its own
        compute dtype. The feature maps are L2-normalized in their own dtype.

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
    if resample_precision not in RESAMPLE_FORWARD:
        raise ValueError(f"unknown resample_precision {resample_precision!r}")

    b, h, w, f = image_feature_maps.shape
    c = class_head.class_feats.shape[0]
    a = h * w
    t_dim = TEMPLATE_W * TEMPLATE_H

    consts = head_constants.lookup(image_feature_maps.device, h, w)
    fm = l2_normalize_channels(image_feature_maps, eps=1e-5, dim=-1)

    # dense correlation; corr channel of template point (x_c, y_c) is
    # t = x_c * 15 + y_c in the natural order (weakalign order,
    # os2d/modeling/head.py:342-350), then permuted interior-first
    feats_t = class_head.class_feats.transpose(1, 2).reshape(c, t_dim, f)
    perm = None
    if corr_interior_first:
        perm = consts.perm
        feats_t = feats_t[:, perm]
    corr = correlation_gemm(fm.reshape(b * a, f), feats_t.reshape(c * t_dim, f), compute_dtype)
    corr = corr.reshape(b, h, w, c, t_dim).permute(0, 3, 1, 2, 4).contiguous()  # [B, C, H, W, T]

    # regress transformation parameters per (image, class, anchor)
    tparams = transform_net(corr.reshape(b * c, h, w, t_dim), conv0_channel_perm=perm)
    theta = _prepare_theta(tparams.reshape(-1, tparams.shape[-1]), simple_affine)
    if use_inverse_geom_model:
        theta = invert_affine_2x3(theta)

    # (1) recognition w.r.t. feature-map-level anchors (box 15, stride 1)
    fb = consts.fb
    if perm is None:
        # the grid path: [B, C, H, W, 15, 15, 2] grids, the interior
        # compacted out of the natural channel order
        grids_local = affine_grid_2d(theta, TEMPLATE_H, TEMPLATE_W).reshape(
            b, c, h, w, TEMPLATE_H, TEMPLATE_W, 2)
        grids_fm = local_to_global_grid(grids_local, fb.reshape(1, 1, h, w, 4))
        gx = grids_fm[..., 0] / (w - 1) * 2.0 - 1.0
        gy = grids_fm[..., 1] / (h - 1) * 2.0 - 1.0
        grids_unit = clip_jax_grad(torch.stack([gx, gy], dim=-1), -1.0, 1.0)
        cls, cls_detached = resample_correlation_autograd(
            *grid_resample_operands(corr, grids_unit, class_head.pool_mask, POOL_BORDER_WIDTH),
            resample_precision)
    else:
        cls, cls_detached = _interior_first_resample(
            corr, theta, fb, consts.lattice, class_head.pool_mask, resample_precision)

    # (2) localization: envelope + corners in closed form from theta w.r.t.
    # image-level anchors (box 240, stride 16)
    th4 = theta.reshape(b, c, h, w, 2, 3)
    ix_a, ix_b, iy_a, iy_b = consts.ix_a, consts.ix_b, consts.iy_a, consts.iy_b

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
    loc = encode_boxes(class_boxes, consts.default_boxes)  # [B, C, H, W, 4]

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
