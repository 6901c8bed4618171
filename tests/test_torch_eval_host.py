"""The host side of the port's `evaluate()` and its per-level class chunks,
on the CPU.

- `evaluate()` with the producer thread (cfg.tpu.eval_prefetch_depth 1)
  equals the serial loop (depth 0) to the bit, and the JAX package's
  `evaluate()` at resample precision "highest" on the planted scenes of
  tests/test_end_to_end_eval.py (batch 1, one pyramid level, two class
  chunks): mAP, mAPw and recall
  exactly, the saved detections' image ids and labels exactly, scores within
  1e-4 and boxes within 1e-2 px (as tests/test_torch_evaluate.py: the two
  packages' fp32 sums run in other orders). A partial tail batch (batch 3 of
  2 images) gives the same detections through either loop.
- An exception of the producer (the dataloader's iterator) reaches the
  caller, and a consumer that stops early stops the producer.
- `level_class_chunks` equals JAX's rule (os2d_tpu/engine/evaluate.py:
  540-551, restated here as written there) on the bench's 7 levels and on
  ragged sizes; `Evaluator.level_chunks` applies it only without a mesh,
  with more than one chunk and with eval_class_chunk_per_level.
- `Evaluator.detect_images` with per-level chunks is `torch.equal` to
  uniform chunks and to one chunk, at C=20 and chunk 8.
- `prepare_batch_arrays` through the upload twin (`utils.upload.Uploader`)
  equals the plain `torch.as_tensor` upload it replaced, to the bit.
"""

import os
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

from os2d_tpu.config import get_default_cfg as jax_cfg
from os2d_tpu.data.dataloader import DataloaderOneShotDetection as JaxLoader
from os2d_tpu.data.dataset import DatasetOneShotDetection as JaxDataset
from os2d_tpu.engine import evaluate as jeval
from os2d_tpu.models import os2d as jos2d
from os2d_tpu.structures.feature_map import FeatureMapSize as JaxSize
from os2d_tpu.structures.feature_map import feature_map_size_for_image as jax_fm_size
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import DataloaderOneShotDetection
from os2d_torch.data.dataset import DatasetOneShotDetection
from os2d_torch.engine import evaluate as teval
from os2d_torch.engine.train import prepare_batch_arrays
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.models.head import ClassHead
from os2d_torch.structures.feature_map import FeatureMapSize
from os2d_torch.utils.upload import Uploader, uploader_for
from test_end_to_end_eval import IMG_W, make_synthetic_dataset

PYRAMID = [1.0]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (as tests/test_torch_evaluate.py): under the
    suite's workers sharing the cores, torch's OpenMP teams otherwise wait on
    each other's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_host"))
    df = make_synthetic_dataset(root)
    kwargs = dict(gt_path=os.path.join(root, "classes", "images"),
                  image_path=os.path.join(root, "src"), name="eval-host",
                  image_size=IMG_W, eval_scale=IMG_W, cache_images=True)
    jax_loader = JaxLoader(dataset=JaxDataset(df, **kwargs), batch_size=1,
                           pyramid_scales_eval=PYRAMID, do_augmentation=False)
    loader = DataloaderOneShotDetection(dataset=DatasetOneShotDetection(df, **kwargs),
                                        batch_size=1, pyramid_scales_eval=PYRAMID)
    params = jos2d.init_os2d_params(jax.random.PRNGKey(0),
                                    jos2d.Os2dConfig(resample_precision="highest"))
    model = Os2dModel(Os2dConfig(resample_precision="highest"), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_loader, loader, params, model


def _cfg(cfg, save_dir, depth=1, batch_size=1):
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.batch_size = batch_size
    cfg.tpu.eval_class_chunk = 1
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    cfg.tpu.eval_prefetch_depth = depth
    cfg.visualization.eval.path_to_save_detections = str(save_dir)
    return cfg


def _detections(save_dir, loader):
    with open(os.path.join(save_dir, f"{loader.get_name()}_detections.pkl"), "rb") as f:
        return pickle.load(f)


def test_prefetched_evaluate_matches_serial_and_jax(setup, tmp_path):
    jax_loader, loader, params, model = setup
    want = jeval.evaluate(jax_loader, jos2d.Os2dModel(jos2d.Os2dConfig(
        resample_precision="highest")), params, _cfg(jax_cfg(), tmp_path / "jax"))
    got = teval.evaluate(loader, model, _cfg(get_default_cfg(), tmp_path / "depth1"))
    serial = teval.evaluate(loader, model, _cfg(get_default_cfg(), tmp_path / "depth0", depth=0))

    assert want["mAP@0.50"] == 1.0
    for key in ("mAP@0.50", "mAPw@0.50", "recall@0.50", "AP_joint_classes@0.50"):
        assert got[key] == serial[key] == want[key], key
    j_dets = _detections(tmp_path / "jax", loader)
    t_dets = _detections(tmp_path / "depth1", loader)
    s_dets = _detections(tmp_path / "depth0", loader)
    assert t_dets["image_ids"] == s_dets["image_ids"] == j_dets["image_ids"]
    for i in range(len(j_dets["image_ids"])):
        for key in ("labels", "scores", "boxes_xyxy"):
            np.testing.assert_array_equal(t_dets[key][i], s_dets[key][i])
        np.testing.assert_array_equal(t_dets["labels"][i], j_dets["labels"][i])
        np.testing.assert_allclose(t_dets["scores"][i], j_dets["scores"][i], atol=1e-4)
        np.testing.assert_allclose(t_dets["boxes_xyxy"][i], j_dets["boxes_xyxy"][i], atol=1e-2)


def test_padded_tail_batch_through_the_producer(setup, tmp_path):
    """Batch 3 over 2 images: one batch whose tail row repeats the last
    image; the producer's loop records the genuine rows as the serial one."""
    _, loader, _, model = setup
    got = teval.evaluate(loader, model, _cfg(get_default_cfg(), tmp_path / "p", batch_size=3))
    serial = teval.evaluate(loader, model, _cfg(get_default_cfg(), tmp_path / "s", depth=0,
                                                batch_size=3))
    assert got["mAP@0.50"] == serial["mAP@0.50"] == 1.0
    p_dets, s_dets = _detections(tmp_path / "p", loader), _detections(tmp_path / "s", loader)
    assert p_dets["image_ids"] == s_dets["image_ids"] and len(p_dets["image_ids"]) == 2
    for key in ("labels", "scores", "boxes_xyxy"):
        for a, b in zip(p_dets[key], s_dets[key]):
            np.testing.assert_array_equal(a, b)


class _FailingLoader:
    """The planted loader whose raw iterator fails at its first batch."""

    def __init__(self, loader):
        self._loader = loader

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def make_raw_iterator_for_all_images(self, batch_size):
        raise OSError("image file unreadable")
        yield  # a generator, as the loader's


def test_producer_exception_reaches_the_caller(setup):
    _, loader, _, model = setup
    n_threads = threading.active_count()
    with pytest.raises(OSError, match="image file unreadable"):
        teval.evaluate(_FailingLoader(loader), model, _cfg(get_default_cfg(), ""))
    assert threading.active_count() == n_threads


def test_consumer_stopping_early_stops_the_producer():
    produced = []

    def items():
        for i in range(100):
            produced.append(i)
            yield i

    gen = teval._prefetched(items(), depth=2)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()  # joins the producer thread
    assert len(produced) <= 3 + 2 + 1
    assert list(teval._prefetched(iter(range(5)), depth=1)) == list(range(5))
    assert list(teval._prefetched(iter(range(5)), depth=0)) == list(range(5))


def _jax_rule(level_sizes, chunk, c_total):
    """os2d_tpu/engine/evaluate.py:540-551 as written there."""
    areas = []
    for sz in level_sizes:
        fm_sz = jax_fm_size(JaxSize(w=sz.w, h=sz.h))
        areas.append(fm_sz.h * fm_sz.w)
    a_max = max(areas)
    cap = (c_total + 7) // 8 * 8

    def _level_chunk(a_l):
        c_l = (chunk * a_max // a_l) // 8 * 8
        return min(max(chunk, c_l), cap)

    return [_level_chunk(a) for a in areas]


BENCH_LEVELS = [FeatureMapSize(w=int(1280 * s), h=int(960 * s))
                for s in (0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6)]
RAGGED_LEVELS = [FeatureMapSize(w=w, h=h) for w, h in ((17, 33), (240, 240), (601, 97),
                                                       (1500, 1125), (33, 900))]


@pytest.mark.parametrize("levels", [BENCH_LEVELS, RAGGED_LEVELS], ids=["bench", "ragged"])
@pytest.mark.parametrize("chunk,c_total", [(8, 20), (16, 256), (32, 256), (128, 1024),
                                           (5, 7), (3, 1000)])
def test_level_chunks_match_jax_rule(levels, chunk, c_total):
    got = teval.level_class_chunks(levels, chunk, c_total)
    assert got == _jax_rule(levels, chunk, c_total)
    assert all(c >= chunk for c in got) and max(got) <= -(-c_total // 8) * 8


def test_level_chunks_apply_as_in_jax(setup):
    model = setup[3]
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = 8
    ev = teval.Evaluator(model, cfg)
    assert ev.level_chunks(BENCH_LEVELS, 20) == teval.level_class_chunks(BENCH_LEVELS, 8, 20)
    assert ev.level_chunks(BENCH_LEVELS, 8) is None  # one chunk
    cfg.tpu.eval_class_chunk_per_level = False
    assert teval.Evaluator(model, cfg).level_chunks(BENCH_LEVELS, 20) is None
    cfg.tpu.eval_class_chunk_per_level = True
    from os2d_torch.parallel import Mesh

    meshed = teval.Evaluator(model, cfg, mesh=Mesh(None, 0, 2, torch.device("cpu")))
    assert meshed.level_chunks(BENCH_LEVELS, 20) is None


def test_detect_images_per_level_chunks_equal_uniform_and_one_chunk(setup):
    """C=20 classes at chunk 8 over two levels whose feature maps differ 4x
    in area (12x10 and 6x5): the small level runs one chunk of 24
    (= ceil8(20)) rows, the large one three chunks of 8; every class's
    scores are bit-equal to uniform chunks of 8 and to one chunk of 20."""
    model = setup[3]
    gen = torch.Generator().manual_seed(0)
    feats = torch.nn.functional.normalize(torch.randn(20, 15, 15, 1024, generator=gen), dim=-1)
    head = ClassHead(feats, model.build_class_head_from_images(
        [np.zeros((64, 64, 3), np.float32)]).pool_mask.repeat(20, 1, 1))
    image = torch.as_tensor(np.random.RandomState(0).randint(0, 255, (1, 160, 192, 3), np.uint8))
    sizes = [FeatureMapSize(w=192, h=160), FeatureMapSize(w=96, h=80)]
    inv = [(1.0, 1.0), (2.0, 2.0)]
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    outs = {}
    for name, chunk, per_level in (("per_level", 8, True), ("uniform", 8, False),
                                   ("one", 20, True)):
        cfg = get_default_cfg()
        cfg.tpu.eval_class_chunk = chunk
        cfg.tpu.eval_class_chunk_per_level = per_level
        ev = teval.Evaluator(model, cfg)
        if name == "per_level":
            assert ev.level_chunks(sizes, 20) == [8, 24]
        outs[name] = ev.detect_images(image, head, sizes, inv, norm)
    assert (outs["per_level"][..., 5] > 0).any()
    assert torch.equal(outs["per_level"], outs["uniform"])
    assert torch.equal(outs["per_level"], outs["one"])


def test_prepare_batch_arrays_through_the_upload_twin_is_unchanged():
    rng = np.random.RandomState(0)
    batch = {"images": rng.randint(0, 255, (2, 48, 64, 3), np.uint8),
             "class_images": [rng.randint(0, 255, (32, 32, 3), np.uint8) for _ in range(3)],
             "class_ids": [4, 7, 9],
             "gt_boxes": rng.rand(2, 5, 4).astype(np.float32),
             "gt_labels": rng.randint(-1, 3, (2, 5)).astype(np.int32),
             "gt_difficult": rng.rand(2, 5) < 0.3, "gt_valid": rng.rand(2, 5) < 0.7,
             "img_size": FeatureMapSize(w=64, h=48)}
    got, c_pad = prepare_batch_arrays(batch, "cpu", uploader=Uploader("cpu"))
    again, _ = prepare_batch_arrays(batch, "cpu")
    assert c_pad == 4
    want = {"images": torch.as_tensor(batch["images"]),
            "gt_boxes": torch.as_tensor(batch["gt_boxes"]),
            "gt_labels": torch.as_tensor(batch["gt_labels"]).long(),
            "gt_difficult": torch.as_tensor(batch["gt_difficult"]),
            "gt_valid": torch.as_tensor(batch["gt_valid"])}
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        assert torch.equal(again[k], v), k
    assert got["class_images"].dtype == torch.uint8
    assert torch.equal(got["class_images"][:3], torch.as_tensor(np.stack(batch["class_images"])))
    assert not got["class_images"][3].any()
    assert got["class_valid"].tolist() == [True, True, True, False]
    up = Uploader("cpu").upload(batch["gt_boxes"])
    assert up.device.type == "cpu" and torch.equal(up, torch.as_tensor(batch["gt_boxes"]))
    assert uploader_for("cpu") is uploader_for(torch.device("cpu"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        Uploader("meta")
