"""The port's pyramid decode and NMS against the JAX package's, with exact
score ties and invalid boxes, on two pyramid levels with pre_top_k=64 and
top_k=16.

Survivor sets, scores and valid flags must be equal; boxes rtol 1e-5 (they
go through exp, which XLA and PyTorch round differently by an ulp or two).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.engine import decode as jdecode
from os2d_tpu.ops import nms as jnms
from os2d_tpu.structures.feature_map import FeatureMapSize as JSize
from os2d_torch.engine import decode as tdecode
from os2d_torch.ops import nms as tnms
from os2d_torch.structures.feature_map import FeatureMapSize as TSize

LEVELS = [(160, 128), (128, 96)]  # (w, h): fm 10x8 and 8x6, 128 anchors
INVERSE = [(1.0, 1.0), (1.25, 4.0 / 3.0)]
G = 5


def _level_inputs(seed):
    rng = np.random.RandomState(seed)
    locs, clss = [], []
    for w, h in LEVELS:
        a = ((w + 15) // 16) * ((h + 15) // 16)
        loc = (0.5 * rng.randn(G, 4, a)).astype(np.float32)
        loc[:, 0, :5] = 60.0  # centers far outside: empty after clipping
        # scores on a coarse grid: many exact ties
        cls = (np.round(rng.uniform(-1, 1, (G, a)) * 4) / 4).astype(np.float32)
        locs.append(loc)
        clss.append(cls)
    return locs, clss


def _decode_both(locs, clss, **kw):
    want = jdecode.decode_pyramid(
        [jnp.asarray(x) for x in locs], [jnp.asarray(x) for x in clss],
        [JSize(w=w, h=h) for w, h in LEVELS], INVERSE, **kw)
    got = tdecode.decode_pyramid(
        [torch.from_numpy(x) for x in locs], [torch.from_numpy(x) for x in clss],
        [TSize(w=w, h=h) for w, h in LEVELS], INVERSE, **kw)
    return got, want


def _assert_same(got, want):
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["scores"].numpy(), np.asarray(want["scores"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("score_threshold", [float("-inf"), -0.3])
@pytest.mark.parametrize("nms_across_classes", [False, True])
def test_decode_pyramid_matches_jax(score_threshold, nms_across_classes):
    locs, clss = _level_inputs(0)
    got, want = _decode_both(locs, clss, nms_iou_threshold=0.3,
                             score_threshold=score_threshold, pre_top_k=64, top_k=16,
                             nms_across_classes=nms_across_classes)
    assert tuple(got["boxes"].shape) == (G, 16, 4)
    assert 0 < int(got["valid"].sum()) < G * 16
    _assert_same(got, want)


def test_decode_pyramid_batches_leading_dims():
    """A leading batch dimension decodes each entry as JAX's vmap does."""
    inputs = [_level_inputs(s) for s in (1, 2)]
    kw = dict(nms_iou_threshold=0.3, pre_top_k=64, top_k=16, nms_across_classes=True)
    got = tdecode.decode_pyramid(
        [torch.stack([torch.from_numpy(i[0][lvl]) for i in inputs]) for lvl in range(2)],
        [torch.stack([torch.from_numpy(i[1][lvl]) for i in inputs]) for lvl in range(2)],
        [TSize(w=w, h=h) for w, h in LEVELS], INVERSE, **kw)
    for j, (locs, clss) in enumerate(inputs):
        _, want = _decode_both(locs, clss, **kw)
        _assert_same({k: v[j] for k, v in got.items()}, want)


@pytest.mark.parametrize("k,top_k", [(200, 32), (12, 20)])
def test_nms_matches_jax(k, top_k):
    rng = np.random.RandomState(5)
    xy = rng.uniform(0, 100, (k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (k, 2))], 1).astype(np.float32)
    boxes[k // 2:k // 2 + 3] = boxes[0]  # duplicates of one box
    scores = (np.round(rng.uniform(0, 1, k) * 8) / 8).astype(np.float32)
    valid = rng.uniform(size=k) > 0.2
    jargs = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    targs = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid))
    np.testing.assert_array_equal(tnms.nms_keep_mask(*targs, 0.3).numpy(),
                                  np.asarray(jnms.nms_keep_mask(*jargs, 0.3)))
    for got, want in zip(tnms.nms_topk(*targs, 0.3, top_k), jnms.nms_topk(*jargs, 0.3, top_k)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _crowded_boxes(rng, lead, k, n_invalid=0):
    """k boxes of 16-64 px in a 480x480 field (long suppression chains that
    cross the blocks), scores on a 1/64 grid (many exact ties), n_invalid of
    them invalid."""
    xy = rng.uniform(0, 480, lead + (k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(16, 64, lead + (k, 2))], -1).astype(np.float32)
    scores = (np.round(rng.uniform(0, 1, lead + (k,)) * 64) / 64).astype(np.float32)
    valid = np.ones(lead + (k,), bool)
    for idx in np.ndindex(*lead):
        valid[idx][rng.choice(k, n_invalid, replace=False)] = False
    return boxes, scores, valid


# (leading dims, K, invalid boxes, dense_limit, block): just above the
# limit (a 1-box last block), exactly 3 blocks, ~10k with the last block all
# invalid, leading dims batched, many small blocks
BLOCKED_CASES = {
    "k8193": ((), 8193, 0, 8192, 2048),
    "k3x2048": ((), 3 * 2048, 0, 2048, 2048),
    "k10000_invalid_block": ((), 10000, 2100, 8192, 2048),
    "lead2x1_k8200": ((2, 1), 8200, 30, 8192, 2048),
    "k700_blocks64": ((3,), 700, 40, 100, 64),
}


@pytest.mark.parametrize("case", BLOCKED_CASES)
def test_nms_blocked_matches_jax(case):
    """Above dense_limit the block-sequential path keeps exactly JAX's boxes."""
    lead, k, n_invalid, dense_limit, block = BLOCKED_CASES[case]
    boxes, scores, valid = _crowded_boxes(np.random.RandomState(k), lead, k, n_invalid)
    jfn = lambda b, s, v: jnms.nms_keep_mask(b, s, v, 0.3, dense_limit=dense_limit,
                                             block=block)
    for _ in lead:
        jfn = jax.vmap(jfn)
    want = np.asarray(jfn(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)))
    got = tnms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(valid), 0.3, dense_limit=dense_limit,
                             block=block).numpy()
    np.testing.assert_array_equal(got, want)
    # suppression did happen, and not of everything
    assert 0 < got.sum() < valid.sum()


def test_nms_blocked_prior_pieces(monkeypatch):
    """The prior suppression in several pieces keeps what one piece keeps."""
    boxes, scores, valid = (torch.from_numpy(x) for x in
                            _crowded_boxes(np.random.RandomState(0), (2,), 600, 20))
    whole = tnms.nms_keep_mask(boxes, scores, valid, 0.3, dense_limit=64, block=64)
    monkeypatch.setattr(tnms, "PRIOR_IOU_PAIRS", 2 * 64 * 64)  # one block of rows a piece
    np.testing.assert_array_equal(
        tnms.nms_keep_mask(boxes, scores, valid, 0.3, dense_limit=64, block=64).numpy(),
        whole.numpy())


def test_decode_across_classes_above_dense_limit_matches_jax():
    """nms_across_classes over G * top_k = 33 * 256 = 8448 > 8192 boxes (the
    blocked path): one 320x320 level, pre_top_k 1024, top_k 256, JAX's
    detections exactly."""
    rng = np.random.default_rng(0)
    g, a = 33, 20 * 20
    loc = rng.normal(0, 0.1, (g, 4, a)).astype(np.float32)
    cls = rng.uniform(-1, 1, (g, a)).astype(np.float32)
    kw = dict(nms_iou_threshold=0.3, pre_top_k=1024, top_k=256, nms_across_classes=True)
    # one compiled program (op by op, XLA compiles for ~10 s)
    want = jax.jit(lambda lc, cl: jdecode.decode_pyramid(
        [lc], [cl], [JSize(w=320, h=320)], [(1.0, 1.0)], **kw))(jnp.asarray(loc),
                                                                jnp.asarray(cls))
    got = tdecode.decode_pyramid([torch.from_numpy(loc)], [torch.from_numpy(cls)],
                                 [TSize(w=320, h=320)], [(1.0, 1.0)], **kw)
    assert tuple(got["valid"].shape) == (g, 256)
    assert 0 < int(got["valid"].sum()) < int(np.asarray(want["scores"] > -np.inf).sum())
    _assert_same(got, want)
