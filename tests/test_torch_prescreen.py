"""The port's no-miss class prescreen (`Evaluator.detect_images_prescreened`),
mirroring tests/test_prescreen.py, at the default tier (the bf16 hat
resample, margin 4e-3) with the full-width model on the CPU, and one partial
prune held against the JAX package's prescreen at "highest" on the same
params.

Random-init backbone features are near-constant vectors (every class's cosine
ceiling is ~0.99), so partial pruning is exercised with one-hot class-feature
banks: class k correlates with feature channel 240+k, so its ceiling is the
max of one channel and has real spread. Surviving detections must match the
full path to 1e-4 score / 1e-3 box tolerance, as in the JAX tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.config import get_default_cfg as jax_cfg
from os2d_tpu.engine import evaluate as jeval
from os2d_tpu.models import os2d as jos2d
from os2d_tpu.models.head import ClassHead as JaxClassHead
from os2d_torch.config import get_default_cfg
from os2d_torch.engine.evaluate import Evaluator, unpack_detections
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.models.head import ClassHead, make_class_pool_mask
from os2d_torch.structures.feature_map import FeatureMapSize

IMG_W, IMG_H = 320, 256
N_CLS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These tests run many small torch ops; with one intra-op thread they
    do not wait on OpenMP barriers when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    model = Os2dModel(Os2dConfig(), device="cpu", seed=0)
    scene = rng.randint(0, 255, (1, IMG_H, IMG_W, 3), np.uint8)
    feats = torch.zeros(N_CLS, 15, 15, 1024)
    for k in range(N_CLS):
        feats[k, :, :, 240 + k] = 1.0
    head = ClassHead(feats, make_class_pool_mask(N_CLS))
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    return model, scene, head, norm


def _cfg(chunk=2, cfg=None, **eval_overrides):
    cfg = get_default_cfg() if cfg is None else cfg
    cfg.tpu.eval_class_chunk = chunk
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    for key, value in eval_overrides.items():
        cfg.eval[key] = value
    return cfg


def _run(ev, setup, sizes=((IMG_W, IMG_H),), num_views=1, head=None, prescreened=False):
    model, scene, head0, norm = setup
    levels = [FeatureMapSize(w=w, h=h) for w, h in sizes]
    inv = [(IMG_W / s.w, IMG_H / s.h) for s in levels]
    fn = ev.detect_images_prescreened if prescreened else ev.detect_images
    return fn(scene, head0 if head is None else head, levels, inv, norm, num_views=num_views)


def _assert_rows_equal(full, pre):
    f, p = unpack_detections(full), unpack_detections(pre)
    assert f["valid"].shape == p["valid"].shape
    for row in range(f["valid"].shape[1]):
        fv, pv = f["valid"][0, row], p["valid"][0, row]
        assert fv.sum() == pv.sum(), (row, fv.sum(), pv.sum())
        if fv.sum():
            np.testing.assert_allclose(f["boxes"][0, row][fv], p["boxes"][0, row][pv], atol=1e-3)
            np.testing.assert_allclose(f["scores"][0, row][fv], p["scores"][0, row][pv], atol=1e-4)


def _median_class_max(setup, **eval_overrides):
    full0 = _run(Evaluator(setup[0], _cfg(**eval_overrides)), setup)
    return float(np.median(unpack_detections(full0)["scores"][0].max(1)))


@pytest.mark.parametrize("across", [False, True])
def test_prescreen_partial_prune_matches_full(setup, across):
    """Under nms_across_classes too: the padded duplicate rows are
    score-masked to -inf, so they cannot suppress genuine detections."""
    cfg = _cfg(nms_across_classes=across,
               nms_score_threshold=_median_class_max(setup, nms_across_classes=across))
    ev = Evaluator(setup[0], cfg)
    assert ev.prescreen_applicable()
    full = _run(ev, setup)
    pre = _run(ev, setup, prescreened=True)
    kept = unpack_detections(pre)["valid"][0].sum(1) > 0
    # the median split must actually prune: some rows empty, some kept
    assert 0 < kept.sum() < N_CLS, kept
    assert 0 < ev.prescreen_pruned < N_CLS
    _assert_rows_equal(full, pre)


def test_prescreen_partial_prune_matches_jax(setup):
    """The same partial prune through the JAX package's prescreen, with its
    params carried over, at "highest" (the JAX package runs every tier in
    exact fp32 on the CPU): the same rows survive, with the scores and boxes
    of tests/test_torch_detect.py's tolerances (1e-4, 1e-2 px)."""
    _, scene, head, norm = setup
    jconfig = jos2d.Os2dConfig(resample_precision="highest")
    params = jos2d.init_os2d_params(jax.random.PRNGKey(0), jconfig)
    model = Os2dModel(Os2dConfig(resample_precision="highest"), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    ported = (model, scene, head, norm)
    threshold = _median_class_max(ported)
    ev = Evaluator(model, _cfg(nms_score_threshold=threshold))
    pre = _run(ev, ported, prescreened=True)
    assert 0 < ev.prescreen_pruned < N_CLS

    jev = jeval.Evaluator(jos2d.Os2dModel(jconfig),
                          _cfg(cfg=jax_cfg(), nms_score_threshold=threshold))
    jhead = JaxClassHead(jnp.asarray(head.class_feats.numpy()),
                         jnp.asarray(head.pool_mask.numpy()))
    want = np.asarray(jev.detect_images_prescreened(
        params, scene, jhead, [FeatureMapSize(w=IMG_W, h=IMG_H)], [(1.0, 1.0)], norm))
    got, want = unpack_detections(pre), unpack_detections(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["scores"][got["valid"]], want["scores"][want["valid"]],
                               atol=1e-4)
    np.testing.assert_allclose(got["boxes"][got["valid"]], want["boxes"][want["valid"]],
                               atol=1e-2)


def test_prescreen_all_pruned(setup):
    ev = Evaluator(setup[0], _cfg(nms_score_threshold=1.5))  # above the cosine ceiling
    pre = _run(ev, setup, prescreened=True)
    assert tuple(pre.shape) == (1, N_CLS, 32, 6)
    assert unpack_detections(pre)["valid"].sum() == 0
    assert ev.prescreen_pruned == N_CLS


def test_prescreen_not_applicable_cases(setup):
    assert not Evaluator(setup[0], _cfg()).prescreen_applicable()  # -inf threshold
    assert Evaluator(setup[0], _cfg(nms_score_threshold=0.5)).prescreen_applicable()
    cfg = _cfg(nms_score_threshold=0.5, nms_across_classes=True)
    assert Evaluator(setup[0], cfg).prescreen_applicable()
    cfg.tpu.eval_class_prescreen = False
    assert not Evaluator(setup[0], cfg).prescreen_applicable()


def test_prescreen_with_tta_views(setup):
    """TTA (num_views=4) with a chunk size that does NOT divide the padded
    row count: the view split must trim to view-aligned rows and match the
    full path, over two pyramid levels."""
    model, _, head, _ = setup
    views = []
    for f in head.class_feats[:2]:
        views += [torch.rot90(f, k, (0, 1)) for k in range(4)]
    tta_head = ClassHead(torch.stack(views), make_class_pool_mask(8))
    ev = Evaluator(model, _cfg(chunk=3, nms_score_threshold=-1.0))  # finite, keeps all
    sizes = ((IMG_W, IMG_H), (IMG_W // 2, IMG_H // 2))
    full = _run(ev, setup, sizes=sizes, num_views=4, head=tta_head)
    pre = _run(ev, setup, sizes=sizes, num_views=4, head=tta_head, prescreened=True)
    assert tuple(pre.shape) == tuple(full.shape) == (1, 2, 32, 6)
    assert ev.prescreen_pruned == 0
    _assert_rows_equal(full, pre)
