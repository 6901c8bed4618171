"""The port's hard-patch mining against the JAX package's, on the CPU.

tests/test_mining.py needs the PyTorch reference, which is not installed
here, so the port is held to the JAX functions directly, on the planted
dataset of tests/test_train.py (three 480x384 scenes, two classes) at the
recipe of tests/test_mining.py (320x320 crops, class images of 128 px,
B=2, class chunk 4, one random pyramid scale, 2 random negative classes, 3
patches per image) with the resample at "highest":

- `get_box_to_cut_anchor` (crops narrower and wider than the image) and
  `_nms_topk_host`: exact;
- `compute_objective(patch_mining_mode=True)` and `want_per_anchor`: the
  per-anchor masks exact, the losses rtol 1e-5;
- `make_iterator_for_all_images` with random scales: the same scales and
  pyramids, exactly;
- `mine_hard_patches`, seeded alike (random.seed(s) for JAX, seed=s for the
  port): the same records in the same order (ids, roles, levels, labels,
  anchors, crop and anchor boxes exact; losses and scores rtol 1e-4, atol
  1e-5; corners atol 1e-3 px), then three consecutive mined-crop batches
  after `set_hard_negative_data`, with batch flips, equal (images, class
  ids and GT exact); with show_mined_patches, the same figures' image and
  records;
- a mined crop box past the image's borders: JAX's zero padding, crop,
  boxes, masks and inverse transform, exactly.
The training loop with mining is in tests/test_torch_mining_loop.py.
"""

import os
import random

import jax
import numpy as np
import pytest
import torch

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.engine import mining as jmining
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.engine.objective import compute_objective as jax_compute_objective
from os2d_tpu.models import Os2dConfig as JaxOs2dConfig
from os2d_tpu.models import Os2dModel as JaxOs2dModel
from os2d_tpu.models import init_os2d_params
from os2d_tpu.structures.feature_map import FeatureMapSize as JaxFMS
from os2d_tpu.utils import visualization as jviz
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import build_train_dataloader_from_config
from os2d_torch.engine import mining
from os2d_torch.engine.objective import ObjectiveConfig, compute_objective
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.structures.feature_map import FeatureMapSize, feature_map_size_for_image
from os2d_torch.utils import visualization as tviz
from test_torch_train_data import port_dataset, train_cfg
from test_train import make_dataset

SEED = 5
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
CORNER_ATOL = 1e-3


def mining_cfg(cfg):
    """tests/test_mining.py:50-66."""
    cfg = train_cfg(cfg, augment=False)
    cfg.eval.scales_of_image_pyramid = [1.0]
    cfg.train.mining.num_random_pyramid_scales = 1
    cfg.train.mining.num_random_negative_classes = 2
    cfg.train.mining.num_hard_patches_per_image = 3
    cfg.tpu.eval_class_chunk = 4
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jds = make_dataset(str(tmp_path_factory.mktemp("mining")), np.random.RandomState(0))
    params = init_os2d_params(jax.random.PRNGKey(1),
                              JaxOs2dConfig(class_image_size=128, resample_precision="highest"))
    return jds, port_dataset(jds), params


def _port_model(params):
    model = Os2dModel(Os2dConfig(class_image_size=128, resample_precision="highest"),
                      device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.mark.parametrize("img,crop", [((960, 720), (600, 600)), ((400, 600), (600, 600)),
                                      ((300, 280), (320, 320)), ((500, 500), (320, 480)),
                                      ((250, 700), (600, 200))])
def test_get_box_to_cut_anchor_matches_jax(img, crop):
    img_size = FeatureMapSize(w=img[0], h=img[1])
    fm = feature_map_size_for_image(img_size)
    got = mining.get_box_to_cut_anchor(img_size, FeatureMapSize(w=crop[0], h=crop[1]), fm)
    want = jmining.get_box_to_cut_anchor(JaxFMS(w=img[0], h=img[1]),
                                         JaxFMS(w=crop[0], h=crop[1]), JaxFMS(w=fm.w, h=fm.h))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("top_k,iou", [(3, 0.5), (50, 0.3), (1, 0.9)])
def test_nms_topk_host_matches_jax(top_k, iou):
    rng = np.random.RandomState(top_k)
    xy = rng.uniform(0, 300, (200, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(20, 120, (200, 2))], 1).astype(np.float32)
    scores = np.round(rng.rand(200), 2).astype(np.float32)  # ties among them
    got = mining._nms_topk_host(boxes, scores, iou, top_k)
    want = jmining._nms_topk_host(boxes, scores, iou, top_k)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) <= top_k


@pytest.mark.parametrize("class_loss,mining_mode", [("RLL", True), ("ContrastiveLoss", True),
                                                    ("RLL", False), ("ContrastiveLoss", False)])
def test_patch_mining_objective_matches_jax(class_loss, mining_mode):
    """patch_mining_mode, and want_per_anchor at the training semantics."""
    rng = np.random.RandomState(0)
    b, num_labels, a = 2, 3, 57
    loc_p = rng.normal(0, 0.5, (b, num_labels, 4, a)).astype(np.float32)
    loc_t = rng.normal(0, 0.5, (b, num_labels, 4, a)).astype(np.float32)
    cls_p = rng.uniform(-1, 1, (b, num_labels, a)).astype(np.float32)
    cls_t = rng.choice([-1, 0, 1], (b, num_labels, a), p=[0.2, 0.6, 0.2]).astype(np.int32)
    cls_r = rng.choice([-1, 0, 1], (b, num_labels, a), p=[0.2, 0.6, 0.2]).astype(np.int32)
    kw = {"patch_mining_mode": True} if mining_mode else {"want_per_anchor": True}
    losses, per_anchor = compute_objective(
        ObjectiveConfig(class_loss=class_loss), *map(torch.from_numpy, (loc_p, loc_t, cls_p, cls_t)),
        cls_targets_remapped=torch.from_numpy(cls_r), **kw)
    j_losses, j_per_anchor = jax_compute_objective(
        JaxObjectiveConfig(class_loss=class_loss), loc_p, loc_t, cls_p, cls_t,
        cls_targets_remapped=cls_r, **kw)
    assert sorted(per_anchor) == sorted(j_per_anchor)
    for key in ("pos_mask", "neg_mask", "pos_for_regression"):
        np.testing.assert_array_equal(per_anchor[key].numpy(), np.asarray(j_per_anchor[key]))
    for key in ("cls_loss", "loc_loss"):
        assert not per_anchor[key].requires_grad
        np.testing.assert_allclose(per_anchor[key].numpy(), np.asarray(j_per_anchor[key]),
                                   rtol=1e-5, atol=0)
    assert sorted(losses) == sorted(j_losses)
    for key in losses:
        np.testing.assert_allclose(float(losses[key]), float(j_losses[key]), rtol=1e-5)
    # without either flag the return value stays the losses dict
    assert isinstance(compute_objective(ObjectiveConfig(class_loss=class_loss),
                                        *map(torch.from_numpy, (loc_p, loc_t, cls_p, cls_t))),
                      dict)


def test_random_scale_pyramids_match_jax(setup):
    """Two batches of random-scale pyramids (scales drawn from the batch
    stream between the eval scales 0.7 and 1.1): the same scales, levels,
    pixels, inverse scales and sizes."""
    jds, tds, _ = setup
    jcfg, cfg = mining_cfg(jax_default_cfg()), mining_cfg(get_default_cfg())
    for c in (jcfg, cfg):
        c.eval.scales_of_image_pyramid = [0.7, 1.1]
    random.seed(SEED)
    jloader, _ = jax_build(jcfg, dataset_train=jds)
    loader, _ = build_train_dataloader_from_config(cfg, tds, seed=SEED)
    want = list(jloader.make_iterator_for_all_images(2, num_random_pyramid_scales=2))
    got = list(loader.make_iterator_for_all_images(2, num_random_pyramid_scales=2))
    assert len(got) == len(want) == 2
    sizes = set()
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert len(g[1]) == len(w[1]) == 2
        for a, b in zip(g[1], w[1]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            sizes.add(a.shape)
        assert g[2] == w[2]
        assert [tuple(s) for s in g[4]] == [tuple(s) for s in w[4]]
    assert len(sizes) == 4  # the scales were drawn, and differ


def _mine_both(setup, out):
    """Both packages' mining, seeded alike, with show_mined_patches drawing
    under out/jax and out/torch."""
    jds, tds, params = setup
    random.seed(SEED)
    jcfg = mining_cfg(jax_default_cfg())
    jcfg.output.path = str(out / "jax")
    jcfg.visualization.mining.show_mined_patches = True
    jloader, _ = jax_build(jcfg, dataset_train=jds)
    jmodel = JaxOs2dModel(JaxOs2dConfig(class_image_size=128, resample_precision="highest"))
    want = jmining.mine_hard_patches(jloader, jmodel, params, jcfg, JaxObjectiveConfig())
    cfg = mining_cfg(get_default_cfg())
    cfg.output.path = str(out / "torch")
    cfg.visualization.mining.show_mined_patches = True
    loader, _ = build_train_dataloader_from_config(cfg, tds, seed=SEED)
    model = _port_model(params).train_mode(True)
    got = mining.mine_hard_patches(loader, model, cfg, ObjectiveConfig())
    return (jloader, want), (loader, got, model)


def test_mining_and_mined_batches_match_jax(setup, tmp_path, monkeypatch):
    """Also the mined-patch figures (show_mined_patches): each package's
    drawing function replaced by a recorder, the same figures of the same
    image and records (tests/test_torch_visualization.py has the others)."""
    figures = {"jax": {}, "torch": {}}
    for name, module in (("jax", jviz), ("torch", tviz)):
        monkeypatch.setattr(module, "show_mined_patches",
                            lambda image, records, save_path, calls=figures[name]:
                            calls.setdefault(os.path.basename(save_path), (image, records)))
    (jloader, want), (loader, got, model) = _mine_both(setup, tmp_path)
    assert list(got) == list(want)
    assert set(figures["torch"]) == set(figures["jax"]) == {f"mined_{i}.png" for i in want}
    for key, (image, records) in figures["torch"].items():
        j_image, j_records = figures["jax"][key]
        np.testing.assert_array_equal(image, j_image)
        assert [r["role"] for r in records] == [r["role"] for r in j_records]
        for r, jr in zip(records, j_records):
            np.testing.assert_array_equal(r["crop_position_xyxy"], jr["crop_position_xyxy"])
    roles = set()
    for image_id in want:
        g_recs, w_recs = got[image_id], want[image_id]
        assert len(g_recs) == len(w_recs) > 0
        for g, w in zip(g_recs, w_recs):
            assert list(g) == list(w)
            for key in ("pyramid_level", "label_local", "anchor_index", "role", "label_global",
                        "image_id"):
                assert g[key] == w[key], (image_id, key)
            for key in ("crop_position_xyxy", "anchor_position_xyxy"):
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])
            for key in ("loss", "loss_loc", "score"):
                np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                           err_msg=key)
            np.testing.assert_allclose(g["transform_corners"], w["transform_corners"],
                                       rtol=0, atol=CORNER_ATOL)
            roles.add(g["role"])
    assert roles == {"neg", "pos", "pos_loc"}
    # mining leaves the training model as it was: parameters that train
    assert all(p.requires_grad for p in model.parameters())

    # the records replayed: three consecutive batches, the same crops
    # (flipped with their batch), classes (the mined labels among them) and GT
    jloader.set_hard_negative_data(want)
    loader.set_hard_negative_data(got)
    for augmentation in (jloader.data_augmentation, loader.data_augmentation):
        augmentation.batch_random_hflip = augmentation.batch_random_vflip = True
    flipped = []
    transform = loader._transform_image

    def spy(image_id, boxes, hflip=False, vflip=False, **kwargs):
        flipped.append(hflip or vflip)
        return transform(image_id, boxes, hflip=hflip, vflip=vflip, **kwargs)

    loader._transform_image = spy
    mined_labels = {r["label_global"] for recs in want.values() for r in recs}
    for i in range(3):
        index = i % len(loader)
        w, g = jloader.get_batch(index), loader.get_batch(index)
        assert g["class_ids"] == w["class_ids"]
        assert mined_labels & set(g["class_ids"])
        assert g["images"].shape[1:] == (320, 320, 3)
        np.testing.assert_array_equal(g["images"], w["images"])
        for a, b in zip(g["class_images"], w["class_images"]):
            np.testing.assert_array_equal(a, b)
        for key in ("gt_boxes", "gt_labels", "gt_difficult", "gt_valid"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert any(flipped)


@pytest.mark.parametrize("xyxy", [(-40, -24, 280, 296), (300, 200, 620, 520),
                                  (-16, 100, 520, 420)])
def test_mined_crop_outside_the_image_matches_jax(xyxy):
    """A mined crop box that exceeds the image (left/top, right/bottom, both
    sides of one axis): the same zero padding, crop, boxes, masks and
    inverse transform as the JAX package's crop."""
    from PIL import Image

    from os2d_tpu.data import transforms as jT
    from os2d_tpu.structures.host_boxes import HostBoxes as JaxBoxes
    from os2d_tpu.structures.host_boxes import TransformList as JaxTransforms
    from os2d_torch.data import transforms as T
    from os2d_torch.structures.host_boxes import HostBoxes, TransformList

    rng = np.random.RandomState(0)
    img = Image.fromarray(rng.randint(0, 255, (384, 480, 3), np.uint8))
    boxes = np.asarray([[10, 20, 200, 220], [250, 150, 470, 380], [0, 0, 30, 30]], np.float32)
    size, j_size = FeatureMapSize(w=480, h=384), JaxFMS(w=480, h=384)
    t_list, j_list = TransformList(), JaxTransforms()
    got = T.crop(img, crop_position=HostBoxes(np.asarray([xyxy], np.float32), size),
                 boxes=HostBoxes(boxes, size), transform_list=t_list)
    want = jT.crop(img, crop_position=JaxBoxes(np.asarray([xyxy], np.float32), j_size),
                   boxes=JaxBoxes(boxes, j_size), transform_list=j_list)
    assert got[0].size == want[0].size == (xyxy[2] - xyxy[0], xyxy[3] - xyxy[1])
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].bbox_xyxy, want[1].bbox_xyxy)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(t_list(got[1]).bbox_xyxy, j_list(want[1]).bbox_xyxy)
    assert (np.asarray(got[0]) == 0).all(-1).any()  # the padding is in the crop


def test_mining_visualisation_is_not_ported(setup, tmp_path):
    """The flag that this test once saw refused now draws: one figure of
    mined patches per image under <output.path>/viz_mining (its arrays are
    held to JAX's in tests/test_torch_visualization.py)."""
    _, tds, params = setup
    cfg = mining_cfg(get_default_cfg())
    cfg.visualization.mining.show_mined_patches = True
    cfg.output.path = str(tmp_path)
    loader, _ = build_train_dataloader_from_config(cfg, tds, seed=SEED)
    got = mining.mine_hard_patches(loader, _port_model(params), cfg, ObjectiveConfig())
    assert sorted(os.listdir(tmp_path / "viz_mining")) == sorted(f"mined_{i}.png" for i in got)
