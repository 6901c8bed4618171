"""The slice as a whole: `Evaluator.detect_images` of the port against the JAX
package's, with the full-width model (ResNet50-C4, 1024 channels) converted
from `os2d_tpu.models.init_os2d_params` (with a random final aligner layer in
place of the zero init), on a uint8 batch (B=2), C=3 classes in chunks of 2
(the last one zero-padded) and two pyramid levels (one down, one up). Both
sides run the resample at precision "highest": JAX on the CPU runs every tier
in exact fp32, while the port's "default" tier rounds to bf16 as its kernel
does (that tier is held against the JAX hat kernel in
tests/test_torch_hat_resample.py).

Tolerances: identical valid flags; scores atol 1e-4 (fp32 backbone and head
sums in another order, ~1e-6 measured); boxes 1e-2 px on valid detections.

Then the planted-patch scenario of tests/test_end_to_end_eval.py on the port
alone, at the default tier (`Os2dConfig()`, the bf16 hat resample) and at
"highest": each planted 240x240 class patch must be the top valid detection
of its class, with IoU > 0.5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.config import get_default_cfg as jax_cfg
from os2d_tpu.engine.evaluate import Evaluator as JaxEvaluator
from os2d_tpu.models import os2d as jos2d
from os2d_tpu.structures.feature_map import FeatureMapSize as JSize
from os2d_torch.config import get_default_cfg
from os2d_torch.engine.evaluate import Evaluator, unpack_detections
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.structures.boxes import box_iou
from os2d_torch.structures.feature_map import FeatureMapSize

IMG_W, IMG_H = 256, 192
LEVELS = [(192, 144), (320, 240)]
NUM_CLASSES = 3


def _cfgs():
    cfgs = []
    for cfg in (jax_cfg(), get_default_cfg()):
        cfg.tpu.eval_class_chunk = 2
        cfg.tpu.eval_pre_top_k = 128
        cfg.tpu.eval_top_k = 16
        cfgs.append(cfg)
    return cfgs


@pytest.fixture(scope="module")
def both_packed():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (2, IMG_H, IMG_W, 3), np.uint8)
    class_images = [rng.randn(s, s, 3).astype(np.float32) for s in (240, 240, 192)]
    inv = [(IMG_W / w, IMG_H / h) for w, h in LEVELS]
    norm = {"mean": jos2d.IMG_NORMALIZATION_MEAN, "std": jos2d.IMG_NORMALIZATION_STD}
    jcfg, tcfg = _cfgs()

    jconfig = jos2d.Os2dConfig(resample_precision="highest")
    jmodel = jos2d.Os2dModel(jconfig)
    params = jos2d.init_os2d_params(jax.random.PRNGKey(0), jconfig)
    # a non-zero final aligner layer, so boxes move off the anchors
    lin = params["transform_net"]["linear"]
    lin["w"] = jnp.asarray(0.02 * rng.randn(*lin["w"].shape).astype(np.float32))
    jev = JaxEvaluator(jmodel, jcfg)
    jhead, _ = jev.build_class_heads(params, [jnp.asarray(c) for c in class_images])
    want = np.asarray(jev.detect_images(params, images, jhead,
                                        [JSize(w=w, h=h) for w, h in LEVELS], inv, norm))

    model = Os2dModel(Os2dConfig(resample_precision="highest"), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    ev = Evaluator(model, tcfg)
    head, num_views = ev.build_class_heads([torch.from_numpy(c) for c in class_images])
    assert num_views == 1
    got = ev.detect_images(images, head, [FeatureMapSize(w=w, h=h) for w, h in LEVELS],
                           inv, norm)
    return got, want


def test_detect_images_matches_jax(both_packed):
    got, want = both_packed
    assert tuple(got.shape) == want.shape == (2, NUM_CLASSES, 16, 6)
    g, w = unpack_detections(got), unpack_detections(want)
    np.testing.assert_array_equal(g["valid"], w["valid"])
    assert g["valid"].sum() > 2 * NUM_CLASSES
    np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
    np.testing.assert_allclose(g["boxes"][g["valid"]], w["boxes"][w["valid"]], atol=1e-2)


PATCH = 240
# (x0, y0, class) per 640x480 scene, as in tests/test_end_to_end_eval.py
PLANTED = {0: [(48, 48, 0)], 1: [(336, 176, 1), (48, 112, 0)]}


def _planted_scenes():
    """The scenes of tests/test_end_to_end_eval.py: blocky random class
    textures pasted at anchor-aligned positions into dark noise."""
    rng = np.random.RandomState(0)
    patches = []
    for _ in range(2):
        p = rng.randint(0, 255, (PATCH // 8, PATCH // 8, 3), np.uint8)
        patches.append(np.kron(p, np.ones((8, 8, 1), np.uint8)))
    scenes = []
    for image_id in sorted(PLANTED):
        scene = rng.randint(0, 60, (480, 640, 3), np.uint8)
        for x0, y0, cid in PLANTED[image_id]:
            scene[y0:y0 + PATCH, x0:x0 + PATCH] = patches[cid]
        scenes.append(scene)
    return np.stack(scenes), patches


def _check_planted(config):
    scenes, patches = _planted_scenes()
    cfg = get_default_cfg()
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 16
    model = Os2dModel(config, device="cpu", seed=0)
    mean = torch.tensor(model.config.normalization_mean)
    std = torch.tensor(model.config.normalization_std)
    class_images = [(torch.from_numpy(p).float() / 255.0 - mean) / std for p in patches]
    ev = Evaluator(model, cfg)
    head, _ = ev.build_class_heads(class_images)
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    det = unpack_detections(ev.detect_images(scenes, head, [FeatureMapSize(w=640, h=480)],
                                             [(1.0, 1.0)], norm))
    for image_id, plants in PLANTED.items():
        for x0, y0, cid in plants:
            valid = det["valid"][image_id, cid]
            assert valid.any()
            top = int(np.argmax(np.where(valid, det["scores"][image_id, cid], -np.inf)))
            box = det["boxes"][image_id, cid, top]
            iou = box_iou(torch.tensor(box[None]),
                          torch.tensor([[x0, y0, x0 + PATCH, y0 + PATCH]], dtype=torch.float32))
            assert float(iou) > 0.5, (image_id, cid, box, float(iou))


def test_planted_patches_are_top_detections():
    _check_planted(Os2dConfig())  # the default tier: the bf16 hat resample


def test_planted_patches_highest_tier():
    _check_planted(Os2dConfig(resample_precision="highest"))
