"""The port's eval entry point against the JAX package's, on the synthetic
planted-patch dataset of tests/test_end_to_end_eval.py (two 640x480 scenes,
two classes), read through both packages' data layers.

- The dataloaders give equal class arrays (palette resize, normalization)
  and equal raw-iterator batches (uint8 base images, level sizes, inverse
  scales, initial sizes).
- `augment_class_images` gives equal TTA views for every mode.
- `do_voc_evaluation` gives equal results on seeded random predictions.
- `evaluate()` at resample precision "highest", with TTA "horflip" and a
  finite nms_score_threshold (so the class prescreen runs), with the JAX
  params converted by `models/from_jax.py`: equal mAP, mAPw and recall, and
  the saved detections agree (scores atol 1e-4, boxes 1e-2 px, as
  tests/test_torch_detect.py).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from os2d_tpu.config import get_default_cfg as jax_cfg
from os2d_tpu.data import voc_eval as jvoc
from os2d_tpu.data.dataloader import DataloaderOneShotDetection as JaxLoader
from os2d_tpu.data.dataset import DatasetOneShotDetection as JaxDataset
from os2d_tpu.engine import evaluate as jeval
from os2d_tpu.models import os2d as jos2d
from os2d_torch.config import get_default_cfg
from os2d_torch.data import voc_eval
from os2d_torch.data.dataloader import DataloaderOneShotDetection
from os2d_torch.data.dataset import DatasetOneShotDetection
from os2d_torch.engine import evaluate as teval
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from test_end_to_end_eval import IMG_W, make_synthetic_dataset


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These tests run many small torch ops; with one intra-op thread they
    do not wait on OpenMP barriers when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_torch"))
    df = make_synthetic_dataset(root)
    kwargs = dict(gt_path=os.path.join(root, "classes", "images"),
                  image_path=os.path.join(root, "src"), name="synth-torch",
                  image_size=IMG_W, eval_scale=IMG_W, cache_images=True)
    jax_loader = JaxLoader(dataset=JaxDataset(df, **kwargs), batch_size=1,
                           pyramid_scales_eval=[1.0], do_augmentation=False)
    loader = DataloaderOneShotDetection(dataset=DatasetOneShotDetection(df, **kwargs),
                                        batch_size=1, pyramid_scales_eval=[1.0])
    return jax_loader, loader


def test_class_images_match(loaders):
    jax_loader, loader = loaders
    j_arrays, j_sizes, j_ids = jax_loader.get_all_class_images()
    arrays, sizes, ids = loader.get_all_class_images()
    assert ids == j_ids and sizes == j_sizes
    for a, b in zip(arrays, j_arrays):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_raw_iterator_matches(loaders):
    jax_loader, loader = loaders
    for batch_size in (1, 2):
        got = list(loader.make_raw_iterator_for_all_images(batch_size))
        want = list(jax_loader.make_raw_iterator_for_all_images(batch_size))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            batch_ids, base_images, level_sizes, inverse_scales, initial_sizes = g
            assert batch_ids == w[0]
            for a, b in zip(base_images, w[1]):
                assert a.dtype == b.dtype == np.uint8
                np.testing.assert_array_equal(a, b)
            assert [tuple(s) for s in level_sizes] == [tuple(s) for s in w[2]]
            assert inverse_scales == w[3]
            assert [tuple(s) for s in initial_sizes] == [tuple(s) for s in w[4]]


@pytest.mark.parametrize("mode", ["", "rotation90", "horflip", "horflip_rotation90"])
def test_augment_class_images_matches(mode):
    rng = np.random.RandomState(0)
    images = [rng.randn(h, w, 3).astype(np.float32) for h, w in ((6, 9), (5, 5))]
    views, n = teval.augment_class_images(images, mode)
    j_views, j_n = jeval.augment_class_images(images, mode)
    assert n == j_n and len(views) == len(j_views) == n * len(images)
    for a, b in zip(views, j_views):
        np.testing.assert_array_equal(a, b)


def test_voc_evaluation_matches():
    rng = np.random.RandomState(0)
    preds, gts = [], []
    for _ in range(4):
        n_gt, n_det = rng.randint(1, 5), rng.randint(0, 12)
        xy = rng.uniform(0, 200, (n_gt, 2))
        gt_boxes = np.concatenate([xy, xy + rng.uniform(20, 80, (n_gt, 2))], 1)
        gts.append({"boxes": gt_boxes.astype(np.float32), "labels": rng.randint(0, 3, n_gt),
                    "difficult": rng.rand(n_gt) < 0.2, "image_size": (320, 240)})
        src = gt_boxes[rng.randint(0, n_gt, n_det)] + rng.normal(0, 8, (n_det, 4))
        preds.append({"boxes": src.astype(np.float32), "labels": rng.randint(0, 3, n_det),
                      "scores": rng.rand(n_det).astype(np.float32),
                      "image_size": (640, 480)})
    for iou in (0.5, 0.7):
        for use_07 in (False, True):
            got = voc_eval.do_voc_evaluation(preds, gts, iou, use_07)
            want = jvoc.do_voc_evaluation(preds, gts, iou, use_07)
            assert sorted(got) == sorted(want)
            for key in ("map", "map_weighted", "recall", "ap_joint_classes"):
                np.testing.assert_equal(got[key], want[key])
            np.testing.assert_array_equal(got["ap_per_class"], want["ap_per_class"])
            np.testing.assert_array_equal(got["n_pos"], want["n_pos"])


def _eval_cfg(cfg, save_dir):
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.class_image_augmentation = "horflip"
    cfg.eval.nms_score_threshold = 0.5
    cfg.tpu.eval_class_chunk = 4
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    cfg.visualization.eval.path_to_save_detections = str(save_dir)
    return cfg


def test_evaluate_matches_jax_with_tta_and_prescreen(loaders, tmp_path):
    jax_loader, loader = loaders
    jconfig = jos2d.Os2dConfig(resample_precision="highest")
    params = jos2d.init_os2d_params(jax.random.PRNGKey(0), jconfig)
    want = jeval.evaluate(jax_loader, jos2d.Os2dModel(jconfig), params,
                          _eval_cfg(jax_cfg(), tmp_path / "jax"))

    model = Os2dModel(Os2dConfig(resample_precision="highest"), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = teval.evaluate(loader, model, _eval_cfg(get_default_cfg(), tmp_path / "torch"))

    assert want["mAP@0.50"] == 1.0
    for key in ("mAP@0.50", "mAPw@0.50", "recall@0.50", "AP_joint_classes@0.50"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["prescreen_pruned"] >= 0

    name = f"{loader.get_name()}_detections.pkl"
    with open(tmp_path / "jax" / name, "rb") as f:
        j_dets = pickle.load(f)
    with open(tmp_path / "torch" / name, "rb") as f:
        t_dets = pickle.load(f)
    assert t_dets["image_ids"] == j_dets["image_ids"]
    for i in range(len(j_dets["image_ids"])):
        np.testing.assert_array_equal(t_dets["labels"][i], j_dets["labels"][i])
        np.testing.assert_allclose(t_dets["scores"][i], j_dets["scores"][i], atol=1e-4)
        np.testing.assert_allclose(t_dets["boxes_xyxy"][i], j_dets["boxes_xyxy"][i], atol=1e-2)
        np.testing.assert_array_equal(t_dets["gt_boxes_xyxy"][i], j_dets["gt_boxes_xyxy"][i])


def test_evaluate_rejects_unported_options(loaders):
    """Every option of the JAX eval path runs (the visualisation flags:
    tests/test_torch_visualization.py): upload_pixel_format "yuv420" finds
    the planted patches as rgb8 does (tests/test_torch_pixel_format.py holds
    it to JAX); a format that neither package knows raises."""
    _, loader = loaders
    model = Os2dModel(Os2dConfig(), device="cpu")
    maps = {}
    for value in ("rgb8", "yuv420"):
        cfg = get_default_cfg()
        cfg.eval.mAP_iou_thresholds = [0.5]
        cfg.merge_from_list(["tpu.upload_pixel_format", value])
        maps[value] = teval.evaluate(loader, model, cfg)["mAP@0.50"]
    assert maps == {"rgb8": 1.0, "yuv420": 1.0}
    cfg = get_default_cfg()
    cfg.merge_from_list(["tpu.upload_pixel_format", "yuv444"])
    with pytest.raises(ValueError, match="upload_pixel_format"):
        teval.evaluate(loader, model, cfg)
    # a mesh runs now; its size rules raise before any collective
    from os2d_torch.parallel import Mesh

    cfg = get_default_cfg()
    cfg.tpu.eval_shard_axis = "images"
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        teval.evaluate(loader, model, cfg, mesh=Mesh(None, 0, 2, torch.device("cpu")))
