"""The port's host-pyramid eval path against the JAX package's, on the CPU,
on the planted dataset of tests/test_end_to_end_eval.py (two 640x480 scenes,
two classes) at pyramid scales [0.8, 1.0], resample "highest", with the JAX
params converted by `models/from_jax.py`:

- `make_iterator_for_all_images`: the same pyramids (normalized float32,
  PIL bilinear), inverse scales and sizes, exactly;
- `Evaluator.score_pyramid` with corners, three classes in chunks of two
  (the last chunk padded): loc and cls atol 1e-5, corners atol 1e-3 px; no
  graph is recorded for a model in train mode;
- `evaluate()` with cfg.tpu.device_side_pyramid=False, TTA "horflip" and
  the objective as criterion: mAP, mAPw and recall equal to JAX's host path,
  the loss terms rtol 1e-4, the saved detections as tests/test_torch_evaluate.py
  holds them (scores atol 1e-4, boxes 1e-2 px).
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from os2d_tpu.config import get_default_cfg as jax_cfg
from os2d_tpu.data.dataloader import DataloaderOneShotDetection as JaxLoader
from os2d_tpu.data.dataset import DatasetOneShotDetection as JaxDataset
from os2d_tpu.engine import evaluate as jeval
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.models import os2d as jos2d
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import DataloaderOneShotDetection
from os2d_torch.data.dataset import DatasetOneShotDetection
from os2d_torch.engine import evaluate as teval
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from test_end_to_end_eval import IMG_W, make_synthetic_dataset

PYRAMID = [0.8, 1.0]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small torch ops: one intra-op thread keeps them off OpenMP
    barriers when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("host_pyramid"))
    df = make_synthetic_dataset(root)
    kwargs = dict(gt_path=os.path.join(root, "classes", "images"),
                  image_path=os.path.join(root, "src"), name="synth-host",
                  image_size=IMG_W, eval_scale=IMG_W, cache_images=True)
    jax_loader = JaxLoader(dataset=JaxDataset(df, **kwargs), batch_size=1,
                           pyramid_scales_eval=PYRAMID, do_augmentation=False)
    loader = DataloaderOneShotDetection(dataset=DatasetOneShotDetection(df, **kwargs),
                                        batch_size=1, pyramid_scales_eval=PYRAMID)
    jconfig = jos2d.Os2dConfig(resample_precision="highest")
    params = jos2d.init_os2d_params(jax.random.PRNGKey(0), jconfig)
    model = Os2dModel(Os2dConfig(resample_precision="highest"), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_loader, loader, jos2d.Os2dModel(jconfig), params, model


def test_host_pyramid_iterator_matches_jax(setup):
    jax_loader, loader = setup[:2]
    for batch_size in (1, 2):
        got = list(loader.make_iterator_for_all_images(batch_size))
        want = list(jax_loader.make_iterator_for_all_images(batch_size))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g[0] == w[0]
            assert len(g[1]) == len(PYRAMID)
            for a, b in zip(g[1], w[1]):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            assert g[2] == w[2]
            assert [tuple(s) for s in g[4]] == [tuple(s) for s in w[4]]


def test_score_pyramid_matches_jax(setup):
    jax_loader, loader, jmodel, params, model = setup
    cfg, jcfg = get_default_cfg(), jax_cfg()
    cfg.tpu.eval_class_chunk = jcfg.tpu.eval_class_chunk = 2
    class_images, _, _ = loader.get_all_class_images()
    class_images = class_images + class_images[:1]  # three classes, chunks of two
    _, pyramids, _, _, _ = next(loader.make_iterator_for_all_images(2))

    jev = jeval.Evaluator(jmodel, jcfg)
    jhead, _ = jev.build_class_heads(params, class_images, "")
    want = jev.score_pyramid(params, pyramids, jhead, want_corners=True)
    model.train_mode(True)
    try:
        ev = teval.Evaluator(model, cfg)
        with torch.no_grad():
            head, _ = ev.build_class_heads(class_images)
        got = ev.score_pyramid(pyramids, head, want_corners=True)
    finally:
        model.train_mode(False)
    assert len(got) == len(want) == len(PYRAMID)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["cls", "corners", "loc"]
        for key, atol in (("loc", 1e-5), ("cls", 1e-5), ("corners", 1e-3)):
            assert not g[key].requires_grad
            assert tuple(g[key].shape) == w[key].shape
            np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]), rtol=0, atol=atol,
                                       err_msg=key)


def _eval_cfg(cfg, save_dir):
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.class_image_augmentation = "horflip"
    cfg.tpu.device_side_pyramid = False
    cfg.tpu.eval_class_chunk = 4
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    cfg.visualization.eval.path_to_save_detections = str(save_dir)
    return cfg


def test_evaluate_host_pyramid_matches_jax(setup, tmp_path):
    jax_loader, loader, jmodel, params, model = setup
    want = jeval.evaluate(jax_loader, jmodel, params, _eval_cfg(jax_cfg(), tmp_path / "jax"),
                          criterion=JaxObjectiveConfig())
    got = teval.evaluate(loader, model, _eval_cfg(get_default_cfg(), tmp_path / "torch"),
                         criterion=ObjectiveConfig())

    assert want["mAP@0.50"] == 1.0
    for key in ("mAP@0.50", "mAPw@0.50", "recall@0.50", "AP_joint_classes@0.50"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert "prescreen_pruned" not in got
    loss_keys = [k for k in want if k.startswith(("loss", "cls_", "loc_"))]
    assert loss_keys and sorted(loss_keys) == sorted(
        k for k in got if k.startswith(("loss", "cls_", "loc_")))
    for key in loss_keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-7, err_msg=key)

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
