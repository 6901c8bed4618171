"""The port's box, geometry and resize ops against the JAX package's, on the
same numpy inputs (CPU, fp32).

Tolerances: atol 1e-6 for the elementwise ops (same fp32 formulas; only the
order of a few additions may differ; decoded boxes go through exp, whose
float32 results differ by an ulp or two between XLA and PyTorch, and reach
~1e4 px past the log(1000/16) clip, so they also get rtol 1e-5), atol 1e-5 for the antialiased pyramid
resize (two matmuls over up to ~8 taps of normalized pixel values ~|2.6|,
summed in another order than JAX's einsum).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.ops import geometry as jgeo
from os2d_tpu.ops import sampling as jsamp
from os2d_tpu.structures import boxes as jboxes
from os2d_torch.ops import geometry as tgeo
from os2d_torch.ops import sampling as tsamp
from os2d_torch.structures import boxes as tboxes

ATOL = 1e-6


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _random_boxes(rng, n, lo=-20.0, hi=300.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(-5.0, 120.0, (n, 2))  # some degenerate boxes
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def test_box_iou_area_clip_and_empty():
    rng = np.random.RandomState(0)
    b1, b2 = _random_boxes(rng, 37), _random_boxes(rng, 23)
    b2[:3] = b1[:3]  # identical pairs
    _close(tboxes.box_iou(torch.from_numpy(b1), torch.from_numpy(b2)),
           jboxes.box_iou(jnp.asarray(b1), jnp.asarray(b2)))
    _close(tboxes.box_area(torch.from_numpy(b1)), jboxes.box_area(jnp.asarray(b1)))
    _close(tboxes.clip_boxes_to_image(torch.from_numpy(b1), 200.0, 150.0),
           jboxes.clip_boxes_to_image(jnp.asarray(b1), 200.0, 150.0))
    np.testing.assert_array_equal(
        tboxes.mask_empty_boxes(torch.from_numpy(b1)).numpy(),
        np.asarray(jboxes.mask_empty_boxes(jnp.asarray(b1))))
    _close(tboxes.clip_to_min_size(torch.from_numpy(b1), 1.0),
           jboxes.clip_to_min_size(jnp.asarray(b1), 1.0))


def test_box_codec_and_anchor_grid():
    rng = np.random.RandomState(1)
    anchors = np.array(jboxes.strided_anchor_grid(7, 5, 240.0, 240.0, 16.0, 16.0))
    _close(tboxes.strided_anchor_grid(7, 5, 240.0, 240.0, 16.0, 16.0), anchors)
    gt = anchors + rng.uniform(-30, 30, anchors.shape).astype(np.float32)
    _close(tboxes.encode_boxes(torch.from_numpy(gt), torch.from_numpy(anchors)),
           jboxes.encode_boxes(jnp.asarray(gt), jnp.asarray(anchors)))
    codes = rng.randn(3, anchors.shape[0], 4).astype(np.float32) * 4.0
    codes[0, :4, 2:] = 40.0  # past the log(1000/16) clip
    _close(tboxes.decode_boxes(torch.from_numpy(codes), torch.from_numpy(anchors)),
           jboxes.decode_boxes(jnp.asarray(codes), jnp.asarray(anchors)), rtol=1e-5)


def test_geometry_ops():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 64).astype(np.float32)
    _close(tgeo.l2_normalize_channels(torch.from_numpy(x), eps=1e-5),
           jgeo.l2_normalize_channels(jnp.asarray(x), eps=1e-5))
    theta = rng.randn(50, 2, 3).astype(np.float32)
    theta[:4, :, :2] = [[1.0, 2.0], [2.0, 4.0]]  # singular 2x2 block: the retry path
    theta[4, :, :2] = 0.0
    t_t, t_j = torch.from_numpy(theta), jnp.asarray(theta)
    _close(tgeo.invert_affine_2x3(t_t), jgeo.invert_affine_2x3(t_j), atol=1e-6, rtol=1e-6)
    for got, want in zip(tgeo.affine_grid_envelope(t_t), jgeo.affine_grid_envelope(t_j)):
        _close(got, want)
    _close(tgeo.affine_grid_corners(t_t), jgeo.affine_grid_corners(t_j))


@pytest.mark.parametrize("in_hw,out_hw", [((15, 15), (15, 15)), ((16, 20), (15, 15)),
                                          ((9, 4), (15, 15)), ((1, 6), (15, 15))])
def test_resize_bilinear_align_corners(in_hw, out_hw):
    x = np.random.RandomState(3).randn(2, *in_hw, 8).astype(np.float32)
    _close(tsamp.resize_bilinear_align_corners(torch.from_numpy(x), *out_hw),
           jsamp.resize_bilinear_align_corners(jnp.asarray(x), *out_hw))


# the bench pyramid (os2d_tpu config eval.scales_of_image_pyramid) on a small
# base image: downsampling and upsampling, odd and even sizes
PYRAMID = [0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6]


@pytest.mark.parametrize("scale", PYRAMID)
def test_pyramid_resize_matches_jax_image_resize(scale):
    base_w, base_h = 80, 60
    img = np.random.RandomState(4).randn(2, base_h, base_w, 3).astype(np.float32)
    out_h, out_w = int(base_h * scale), int(base_w * scale)
    want = jax.image.resize(jnp.asarray(img), (2, out_h, out_w, 3), method="bilinear",
                            antialias=True)
    got = tsamp.resize_bilinear_antialias(torch.from_numpy(img), out_h, out_w)
    assert tuple(got.shape) == (2, out_h, out_w, 3)
    _close(got, want, atol=1e-5)
