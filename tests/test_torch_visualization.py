"""The visualisation flags of the port against the JAX package's, on the CPU
at resample precision "highest". Each package's `show_*` functions are
replaced by a recorder, both packages run the same entry point with the
flags set, and the arrays each figure would be drawn from are compared
(pixels are not):

- `evaluate()` with cfg.visualization.eval.show_detections, show_gt_boxes and
  show_class_heatmaps (the chunked per-level path) on the planted scenes of
  tests/test_end_to_end_eval.py: the same figures under the same names; the
  images and GT boxes exactly, detections' labels exactly, scores within
  1e-4 and boxes within 1e-2 px (the packages' fp32 sums run in other
  orders, as tests/test_torch_evaluate.py), heatmaps within 1e-5;
- `trainval_loop` with cfg.visualization.train.show_gt_boxes_dataloader and
  show_target_remapping (no training step) at the recipe of
  tests/test_torch_train_loop.py cut to one image and two classes: GT boxes and targets exactly, the score,
  IoU and per-anchor loss maps within 1e-5, the loss gradients at rtol 1e-4,
  atol 1e-6; cfg.visualization.train.show_detections is accepted and draws
  nothing, as in JAX;
- `mine_hard_patches` with cfg.visualization.mining.show_mined_patches:
  in tests/test_torch_mining.py::test_mining_and_mined_batches_match_jax,
  beside the records, on the same mining runs;
- every real drawing function writes its file from the recorded arrays;
- demo_torch.py's staged pipeline on a small planted image against demo.py's
  with the same weights: labels exactly, scores within 1e-4, boxes within
  1e-2 px, corners within 1e-3 px; and `demo_torch.main` on the CPU writes
  its figure.
"""

import functools
import os
import random

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import demo_torch
from os2d_tpu.config import get_default_cfg as jax_cfg
from os2d_tpu.data.dataloader import DataloaderOneShotDetection as JaxLoader
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.data.dataset import DatasetOneShotDetection as JaxDataset
from os2d_tpu.engine import evaluate as jeval
from os2d_tpu.engine import train as jtrain
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.engine.optimization import create_optimizer as jax_create_optimizer
from os2d_tpu.models import os2d as jos2d
from os2d_tpu.utils import visualization as jviz
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import DataloaderOneShotDetection, build_train_dataloader_from_config
from os2d_torch.data.dataset import DatasetOneShotDetection
from os2d_torch.engine import evaluate as teval
from os2d_torch.engine import train as ttrain
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.utils import visualization as tviz
from test_end_to_end_eval import IMG_W, make_synthetic_dataset
from test_torch_train_data import port_dataset, train_cfg
from test_train import make_dataset

NAMES = ("show_detections", "show_gt_boxes", "show_class_heatmap", "show_mined_patches",
         "show_target_remapping", "plot_train_log")
SEED = 5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (as tests/test_torch_evaluate.py): under the
    suite's workers sharing the cores, torch's OpenMP teams otherwise wait on
    each other's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, jax.Array):
        return np.asarray(x)
    return x


class Recorder:
    """Stands in for a package's drawing functions; keeps their arguments
    by (function name, file name)."""

    def __init__(self, monkeypatch, module):
        self.calls = {}
        for name in NAMES:
            monkeypatch.setattr(module, name, self._recorder(name))

    def _recorder(self, name):
        def record(*args, **kwargs):
            path = kwargs.pop("save_path")
            self.calls[(name, os.path.basename(path))] = (
                [_host(a) for a in args], {k: _host(v) for k, v in kwargs.items()},
                os.path.dirname(path))
            return path
        return record


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, jos2d.init_os2d_params(
        jax.random.PRNGKey(1), jos2d.Os2dConfig(resample_precision="highest")))


def _port_model(params, **kw):
    model = Os2dModel(Os2dConfig(resample_precision="highest", **kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


@functools.lru_cache(maxsize=None)
def _jax_model(**kw):
    """One JAX model per config for the module: its jitted functions keep
    their compiled programs across the tests (the demo's feature map and
    class head are the eval figures' shapes)."""
    return jos2d.Os2dModel(jos2d.Os2dConfig(resample_precision="highest", **kw))


def _close(got, want, **tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if tol:
        np.testing.assert_allclose(got, want, **tol)
    else:
        np.testing.assert_array_equal(got, want)


def _eval_cfg(cfg, out):
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    cfg.output.path = str(out)
    viz = cfg.visualization.eval
    viz.show_detections = viz.show_gt_boxes = viz.show_class_heatmaps = True
    return cfg


def test_evaluate_figures_match_jax(params, tmp_path, monkeypatch, caplog):
    root = str(tmp_path / "data")
    df = make_synthetic_dataset(root)
    kwargs = dict(gt_path=os.path.join(root, "classes", "images"),
                  image_path=os.path.join(root, "src"), name="viz", image_size=IMG_W,
                  eval_scale=IMG_W, cache_images=True)
    jloader = JaxLoader(dataset=JaxDataset(df, **kwargs), batch_size=1,
                        pyramid_scales_eval=[1.0], do_augmentation=False)
    loader = DataloaderOneShotDetection(dataset=DatasetOneShotDetection(df, **kwargs),
                                        batch_size=1, pyramid_scales_eval=[1.0])
    jrec, trec = Recorder(monkeypatch, jviz), Recorder(monkeypatch, tviz)
    want = jeval.evaluate(jloader, _jax_model(), params, _eval_cfg(jax_cfg(), tmp_path / "jax"))
    with caplog.at_level("INFO"):
        got = teval.evaluate(loader, _port_model(params),
                             _eval_cfg(get_default_cfg(), tmp_path / "torch"))
    assert "chunked per-level (fused blocked by: show_class_heatmaps" in caplog.text
    assert got["mAP@0.50"] == want["mAP@0.50"] == 1.0
    assert set(trec.calls) == set(jrec.calls)
    kinds = {name for name, _ in trec.calls}
    assert kinds == {"show_detections", "show_gt_boxes", "show_class_heatmap"}
    for key, (t_args, t_kw, t_dir) in trec.calls.items():
        j_args, j_kw, _ = jrec.calls[key]
        assert t_dir == str(tmp_path / "torch" / "viz_viz")
        _close(t_args[0], j_args[0])  # the image
        if key[0] == "show_detections":
            _close(t_args[3], j_args[3])
            _close(t_args[2], j_args[2], atol=1e-4)
            _close(t_args[1], j_args[1], atol=1e-2)
            assert t_kw == j_kw
        elif key[0] == "show_gt_boxes":
            for a, b in zip(t_args[1:], j_args[1:]):
                _close(a, b)
        else:
            _close(t_args[1], j_args[1], rtol=0, atol=1e-5)


def _loop_cfg(cfg, out):
    cfg = train_cfg(cfg, augment=False)
    cfg.train.batch_size = 1
    cfg.train.class_batch_size = 2
    cfg.train.optim.max_iter = 0
    cfg.tpu.device_class_cache = "off"
    cfg.output.path = str(out)
    viz = cfg.visualization.train
    viz.show_gt_boxes_dataloader = viz.show_target_remapping = viz.show_detections = True
    return cfg


def test_trainval_loop_figures_match_jax(params, tmp_path, monkeypatch):
    jds = make_dataset(str(tmp_path / "data"), np.random.RandomState(0))
    jrec, trec = Recorder(monkeypatch, jviz), Recorder(monkeypatch, tviz)
    jcfg = _loop_cfg(jax_cfg(), tmp_path / "jax")
    random.seed(SEED)
    jloader, _ = jax_build(jcfg, dataset_train=jds)
    optimizer = jax_create_optimizer(jcfg.train.optim,
                                     jtrain.build_trainable_mask(params, jcfg.train))
    jax_params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    # margin_pos 1.0: random weights score every anchor above the default
    # 0.6, where the positives' gradient would be zero
    jtrain.trainval_loop(jloader, _jax_model(class_image_size=128), jax_params, jcfg,
                         JaxObjectiveConfig(margin_pos=1.0), optimizer,
                         optimizer.init(jax_params))

    cfg = _loop_cfg(get_default_cfg(), tmp_path / "torch")
    loader, _ = build_train_dataloader_from_config(cfg, port_dataset(jds), seed=SEED)
    model = _port_model(params, class_image_size=128)
    ttrain.trainval_loop(loader, model, cfg, ObjectiveConfig(margin_pos=1.0),
                         create_optimizer(cfg.train.optim,
                                          ttrain.trainable_parameters(model, cfg.train)))

    assert set(trec.calls) == set(jrec.calls)
    gt = [k for k in trec.calls if k[0] == "show_gt_boxes"]
    remap = [k for k in trec.calls if k[0] == "show_target_remapping"]
    assert len(gt) == 1 and len(remap) >= 1
    for key in gt:
        (t_args, t_kw, t_dir), (j_args, j_kw, _) = trec.calls[key], jrec.calls[key]
        assert t_dir == str(tmp_path / "torch" / "viz_dataloader")
        for a, b in zip(t_args + list(t_kw.values()), j_args + list(j_kw.values())):
            _close(a, b)
    for key in remap:
        (t_args, t_kw, t_dir), (j_args, j_kw, _) = trec.calls[key], jrec.calls[key]
        assert t_dir == str(tmp_path / "torch" / "viz_remapping")
        _close(t_args[0], j_args[0], rtol=0, atol=1e-5)  # the normalized image
        _close(t_args[1], j_args[1], rtol=0, atol=1e-5)  # scores
        _close(t_args[2], j_args[2])  # targets
        _close(t_args[3], j_args[3])  # remapped targets
        assert set(t_kw) == set(j_kw)
        for name in ("ious_anchor", "ious_corrected", "loss_per_anchor"):
            _close(t_kw[name], j_kw[name], rtol=0, atol=1e-5)
        for name in ("grad_scores", "grad_scores_detached"):
            _close(t_kw[name], j_kw[name], rtol=1e-4, atol=1e-6)
    for name in ("grad_scores", "grad_scores_detached"):
        assert max(np.abs(trec.calls[k][1][name]).max() for k in remap) > 0


def test_drawing_functions_write_their_files(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.rand(48, 64, 3).astype(np.float32)
    fm = rng.uniform(-1, 1, (3, 4)).astype(np.float32)
    boxes = np.array([[4, 4, 30, 40], [10, 2, 60, 20]], np.float32)
    records = [{"role": "neg", "crop_position_xyxy": boxes[0], "label_global": 3, "loss": 0.5}]
    calls = {
        "det.png": lambda p: tviz.show_detections(img, boxes, np.array([0.9, 0.4]), [0, 1],
                                                  corners=np.tile(boxes, 2), save_path=p),
        "gt.png": lambda p: tviz.show_gt_boxes(img, boxes, [0, 1], [False, True], save_path=p),
        "heat.png": lambda p: tviz.show_class_heatmap(img, fm, targets_fm=fm, save_path=p),
        "mined.png": lambda p: tviz.show_mined_patches(img, records, save_path=p),
        "remap.png": lambda p: tviz.show_target_remapping(img, fm, fm, fm, ious_anchor=fm,
                                                          grad_scores=fm, save_path=p),
        "log.png": lambda p: tviz.plot_train_log({"iter": [0, 1], "loss": [1.0, 0.5]},
                                                 save_path=p),
    }
    for name, draw in calls.items():
        path = str(tmp_path / name)
        assert draw(path) == path
        assert os.path.getsize(path) > 1000


def _jax_staged_demo(params, input_pil, query_pils, input_size, class_size, threshold):
    """demo.py's staged pipeline (feature map, class head, head, decode) with
    the figure's arrays returned."""
    from os2d_tpu.data.dataloader import image_to_normalized_array
    from os2d_tpu.engine.decode import decode_pyramid
    from os2d_tpu.structures.feature_map import FeatureMapSize, exact_resize_area

    model = _jax_model()
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    ow, oh = input_pil.size
    ratio = input_size / max(ow, oh)
    resized = input_pil.resize((int(ow * ratio), int(oh * ratio)), Image.BILINEAR)
    feature_map = model.extract_features(
        params, jax.numpy.asarray(image_to_normalized_array(resized, norm)[None]))
    queries = []
    for q in query_pils:
        qs = exact_resize_area(w=q.size[0], h=q.size[1], target_area_side=class_size)
        queries.append(jax.numpy.asarray(image_to_normalized_array(
            q.resize((qs.w, qs.h), Image.BILINEAR), norm)))
    out = model.apply_head(params, feature_map, model.build_class_head_from_images(params,
                                                                                   queries))
    img_size = FeatureMapSize(w=resized.size[0], h=resized.size[1])
    det = decode_pyramid([out["loc"][0]], [out["cls"][0]], [img_size],
                         [(ow / img_size.w, oh / img_size.h)], nms_iou_threshold=0.3,
                         top_k=64, corners_pyramid=[out["corners"][0]])
    det = {k: np.asarray(v) for k, v in det.items()}
    keep = det["valid"] & (det["scores"] > threshold)
    return {"boxes": det["boxes"][keep], "scores": det["scores"][keep],
            "labels": np.nonzero(keep)[0], "corners": det["corners"][keep]}


def test_demo_matches_jax_staged_pipeline(params, tmp_path):
    rng = np.random.RandomState(3)
    patch = rng.randint(0, 255, (30, 30, 3), np.uint8).repeat(8, 0).repeat(8, 1)
    scene = rng.randint(0, 255, (480, 640, 3), np.uint8)
    scene[112:352, 48:288] = patch  # on the 16-px anchor grid (x0 = 16k - 112)
    scene_pil = Image.fromarray(scene)
    queries = [Image.fromarray(patch), Image.fromarray(rng.randint(0, 255, (240, 240, 3),
                                                                   np.uint8))]
    want = _jax_staged_demo(params, scene_pil, queries, 640, 240, -1.0)
    got = demo_torch.detect(_port_model(params), scene_pil, queries, input_size=640,
                            class_size=240, score_threshold=-1.0)
    _close(got["labels"], want["labels"])
    assert set(got["labels"]) == {0, 1}
    _close(got["scores"], want["scores"], rtol=0, atol=1e-4)
    _close(got["boxes"], want["boxes"], rtol=0, atol=1e-2)
    _close(got["corners"], want["corners"], rtol=0, atol=1e-3)

    scene_pil.save(tmp_path / "scene.png")
    queries[0].save(tmp_path / "query.png")
    out = tmp_path / "demo.png"
    det = demo_torch.main(["--input", str(tmp_path / "scene.png"), "--query",
                           str(tmp_path / "query.png"), "--input-size", "320", "--class-size",
                           "128", "--device", "cpu", "--output", str(out)])
    assert os.path.getsize(out) > 1000 and det["boxes"].shape[1] == 4
