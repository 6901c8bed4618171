"""The port's yuv420 upload wire (os2d_torch/ops/pixel_format.py) against the
JAX package's (os2d_tpu/ops/pixel_format.py), on seeded numpy inputs.

- The host encode gives JAX's bytes; the decode is within 1e-4 of JAX's
  jitted decode as floats (XLA reorders the fused arithmetic: JAX's own
  eager decode differs from its jitted one by up to 6.1e-5, and equals the
  port's to the bit), and as uint8 equal on at least 99.9% of the values
  and within 1 everywhere; odd shapes are refused by both.
- "auto" is rgb8 in the port (JAX's is yuv420 on accelerators), on every
  device; an unknown format raises.
- evaluate() with upload_pixel_format "yuv420" against JAX's on the planted
  scenes of tests/test_end_to_end_eval.py at resample precision "highest",
  with TTA and the class prescreen (detect_images_prescreened), and without
  a score threshold (detect_images): every batch goes up as the wire, the
  mAP, weighted mAP and recall are equal, and each planted patch's hit (the
  best detection of its class overlapping it) is within the tolerances that
  tests/test_torch_evaluate.py holds rgb8 to (scores atol 1e-4, boxes 1e-2
  px). The other detections are not compared one by one: JAX's jitted
  decode fuses its multiply-adds, so its images differ from the port's by
  up to 6.1e-5 (of 255), and away from the patches random weights score
  neighbouring anchors within ~1e-5, so which of them NMS keeps follows
  those last bits. An odd-sized batch goes up as rgb8, as in JAX.
- prepare_batch_arrays under yuv420 uploads JAX's wire, and the first
  TrainStep on it equals JAX's at tests/test_torch_train_step.py's recipe
  (loss rtol 1e-5, every loss term and the gradient norm rtol 1e-4).
"""

import logging
import os
import pickle
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.config import get_default_cfg as jax_cfg
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.data.dataloader import DataloaderOneShotDetection as JaxLoader
from os2d_tpu.data.dataset import DatasetOneShotDetection as JaxDataset
from os2d_tpu.engine import evaluate as jeval
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.engine.optimization import create_optimizer as jax_create_optimizer
from os2d_tpu.engine.train import TrainStep as JaxTrainStep
from os2d_tpu.engine.train import build_trainable_mask as jax_trainable_mask
from os2d_tpu.engine.train import prepare_batch_arrays as jax_prepare
from os2d_tpu.models import os2d as jos2d
from os2d_tpu.ops import pixel_format as jpix
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import DataloaderOneShotDetection
from os2d_torch.data.dataset import DatasetOneShotDetection
from os2d_torch.engine import evaluate as teval
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.ops import pixel_format as tpix
from os2d_torch.utils.upload import Uploader
from test_end_to_end_eval import IMG_W, make_synthetic_dataset
from test_torch_train_data import train_cfg
from test_train import make_dataset

FLOAT_ATOL = 1e-4
U8_EQUAL_SHARE = 0.999
SCORE_ATOL, BOX_ATOL = 1e-4, 1e-2  # tests/test_torch_evaluate.py
LOSS_RTOL, TERM_RTOL = 1e-5, 1e-4
SHAPES = [(2, 96, 128, 3), (1, 48, 64, 3), (3, 2, 2, 3)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_encode_equals_jax_bytes(shape):
    img = _images(shape)
    got, want = tpix.rgb_to_yuv420(img), jpix.rgb_to_yuv420(img)
    assert got.shape == want.shape == shape
    assert got.data.dtype == np.uint8 and got.nbytes * 2 == img.nbytes
    np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_matches_jax(shape):
    packed = jpix.rgb_to_yuv420(_images(shape, 1))
    flat = torch.from_numpy(packed.data)
    got = tpix.yuv420_to_rgb_f32(flat, packed.shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    want = np.asarray(jax.jit(jpix.yuv420_to_rgb_f32, static_argnums=1)(
        jnp.asarray(packed.data), packed.shape))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_array_equal(tpix.decode_to_float_rgb(tpix.PackedYuv420(flat, shape)),
                                  got)
    # a plain uint8 batch is the rgb8 passthrough
    rgb = torch.from_numpy(_images(shape, 1))
    np.testing.assert_array_equal(tpix.decode_to_float_rgb(rgb), rgb.float())

    got_u8 = tpix.decode_wire_to_u8(tpix.PackedYuv420(flat, shape)).numpy()
    want_u8 = np.asarray(jpix.decode_wire_to_u8_device(
        jpix.PackedYuv420(jnp.asarray(packed.data), packed.shape)))
    assert got_u8.dtype == np.uint8
    assert (got_u8 == want_u8).mean() >= U8_EQUAL_SHARE
    assert np.abs(got_u8.astype(int) - want_u8).max() <= 1


def test_odd_shapes_refused_as_in_jax():
    for make in (lambda m: m.PackedYuv420(np.zeros(10, np.uint8), (1, 15, 16, 3)),
                 lambda m: m.rgb_to_yuv420(np.zeros((1, 16, 15, 3), np.uint8))):
        with pytest.raises(AssertionError):
            make(jpix)
        with pytest.raises(ValueError, match="even"):
            make(tpix)
    with pytest.raises(ValueError, match="flat uint8"):
        tpix.PackedYuv420(np.zeros(24, np.float32), (1, 4, 4, 3))


def test_auto_is_rgb8():
    assert tpix.resolve_pixel_format("auto") == "rgb8"
    assert tpix.resolve_pixel_format("rgb8") == "rgb8"
    assert tpix.resolve_pixel_format("yuv420") == "yuv420"
    with pytest.raises(ValueError, match="upload_pixel_format"):
        tpix.resolve_pixel_format("yuv444")
    img = _images((1, 4, 6, 3))
    up = Uploader("cpu")
    got = tpix.upload_images(up, img, "auto")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    packed = tpix.upload_images(up, img, "yuv420")
    assert isinstance(packed, tpix.PackedYuv420) and packed.data.dtype == torch.uint8
    np.testing.assert_array_equal(packed.data.numpy(), jpix.rgb_to_yuv420(img).data)
    # float images, and anything else the wire does not take, go up as they are
    floats = img.astype(np.float32)
    assert tpix.upload_images(up, floats, "yuv420").dtype == torch.float32


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_pix_torch"))
    df = make_synthetic_dataset(root)
    kwargs = dict(gt_path=os.path.join(root, "classes", "images"),
                  image_path=os.path.join(root, "src"), name="synth-pix-torch",
                  image_size=IMG_W, eval_scale=IMG_W, cache_images=True)
    jax_loader = JaxLoader(dataset=JaxDataset(df, **kwargs), batch_size=1,
                           pyramid_scales_eval=[1.0], do_augmentation=False)
    loader = DataloaderOneShotDetection(dataset=DatasetOneShotDetection(df, **kwargs),
                                        batch_size=1, pyramid_scales_eval=[1.0])
    return jax_loader, loader


def _eval_cfg(cfg, save_dir, prescreen):
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.class_image_augmentation = "horflip" if prescreen else ""
    cfg.eval.nms_score_threshold = 0.5 if prescreen else float("-inf")
    cfg.eval.batch_size = 2
    cfg.tpu.eval_class_chunk = 4
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    cfg.tpu.upload_pixel_format = "yuv420"
    cfg.visualization.eval.path_to_save_detections = str(save_dir)
    return cfg


@pytest.mark.parametrize("prescreen", [True, False], ids=["prescreened", "detect_images"])
def test_evaluate_yuv420_matches_jax(loaders, prescreen, tmp_path):
    jax_loader, loader = loaders
    jconfig = jos2d.Os2dConfig(resample_precision="highest")
    params = jos2d.init_os2d_params(jax.random.PRNGKey(0), jconfig)
    want = jeval.evaluate(jax_loader, jos2d.Os2dModel(jconfig), params,
                          _eval_cfg(jax_cfg(), tmp_path / "jax", prescreen))
    model = Os2dModel(Os2dConfig(resample_precision="highest"), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    uploads = []
    upload = tpix.upload_images

    def recording(uploader, images, pixel_format, logger=None):
        out = upload(uploader, images, pixel_format, logger)
        uploads.append(type(out).__name__)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teval, "upload_images", recording)
        got = teval.evaluate(loader, model, _eval_cfg(get_default_cfg(), tmp_path / "torch",
                                                      prescreen))
    assert uploads and set(uploads) == {"PackedYuv420"}
    assert want["mAP@0.50"] == 1.0
    for key in ("mAP@0.50", "mAPw@0.50", "recall@0.50"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert ("prescreen_pruned" in got) == prescreen

    name = f"{loader.get_name()}_detections.pkl"
    with open(tmp_path / "jax" / name, "rb") as f:
        j_dets = pickle.load(f)
    with open(tmp_path / "torch" / name, "rb") as f:
        t_dets = pickle.load(f)
    assert t_dets["image_ids"] == j_dets["image_ids"]
    n_hits = 0
    for i in range(len(j_dets["image_ids"])):
        for gt_box, label in zip(j_dets["gt_boxes_xyxy"][i], j_dets["gt_labels"][i]):
            got_score, got_box = _planted_hit(t_dets, i, gt_box, label)
            want_score, want_box = _planted_hit(j_dets, i, gt_box, label)
            assert abs(got_score - want_score) <= SCORE_ATOL, (i, label, got_score, want_score)
            np.testing.assert_allclose(got_box, want_box, atol=BOX_ATOL)
            n_hits += 1
    assert n_hits >= 3


def _planted_hit(dets, i, gt_box, label):
    """The best-scoring detection of `label` overlapping gt_box (IoU > 0.5)
    in image i of an evaluate() detections file."""
    same = dets["labels"][i] == label
    boxes, scores = dets["boxes_xyxy"][i][same], dets["scores"][i][same]
    lt = np.maximum(boxes[:, :2], gt_box[:2])
    rb = np.minimum(boxes[:, 2:], gt_box[2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iou = inter / (area + (gt_box[2] - gt_box[0]) * (gt_box[3] - gt_box[1]) - inter)
    assert (iou > 0.5).any(), (i, label)
    k = int(np.argmax(np.where(iou > 0.5, scores, -np.inf)))
    return scores[k], boxes[k]


def test_odd_batch_goes_up_as_rgb8(caplog):
    """A batch of odd H or W takes the rgb8 wire, as JAX's producer does, and
    the fallback is logged."""
    img = _images((2, 33, 48, 3))
    with caplog.at_level(logging.INFO):
        out = tpix.upload_images(Uploader("cpu"), img, "yuv420",
                                 logging.getLogger("OS2D.test"))
    assert isinstance(out, torch.Tensor) and torch.equal(out, torch.from_numpy(img))
    assert "odd side" in caplog.text


@pytest.fixture(scope="module")
def train_batch(tmp_path_factory):
    jds = make_dataset(str(tmp_path_factory.mktemp("train_pix")), np.random.RandomState(0))
    jcfg = train_cfg(jax_cfg(), augment=False)
    jcfg.train.optim.lr = 1e-3
    random.seed(3)
    jloader, _ = jax_build(jcfg, dataset_train=jds)
    return jloader.get_batch(0), jcfg


def test_prepare_and_first_train_step_yuv420_match_jax(train_batch):
    batch, jcfg = train_batch
    want_arrays, j_pad = jax_prepare(batch, pixel_format="yuv420")
    got_arrays, c_pad = prepare_batch_arrays(batch, "cpu", pixel_format="yuv420")
    assert c_pad == j_pad
    assert isinstance(got_arrays["images"], tpix.PackedYuv420)
    assert got_arrays["images"].shape == want_arrays["images"].shape
    np.testing.assert_array_equal(got_arrays["images"].data.numpy(),
                                  np.asarray(want_arrays["images"].data))
    for key in ("class_images", "gt_boxes", "gt_labels", "gt_valid", "default_boxes"):
        np.testing.assert_array_equal(got_arrays[key].numpy(), np.asarray(want_arrays[key]))

    model_cfg = jos2d.Os2dConfig(class_image_size=128, resample_precision="highest")
    params = jos2d.init_os2d_params(jax.random.PRNGKey(1), model_cfg)
    optimizer = jax_create_optimizer(jcfg.train.optim, jax_trainable_mask(params, jcfg.train))
    step = JaxTrainStep(model_cfg, JaxObjectiveConfig(), optimizer, jcfg.train)
    start = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    _, _, want = step(params, optimizer.init(params), want_arrays, j_pad)
    want = dict(want.items())

    tcfg = train_cfg(get_default_cfg(), augment=False)
    tcfg.train.optim.lr = 1e-3
    model = Os2dModel(Os2dConfig(class_image_size=128, resample_precision="highest"),
                      device="cpu")
    model.load_state_dict(start)
    t_opt = create_optimizer(tcfg.train.optim, trainable_parameters(model, tcfg.train))
    got = TrainStep(model, ObjectiveConfig(), t_opt, tcfg.train)(got_arrays, c_pad)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TERM_RTOL, err_msg=k)


def test_nan_reproducer_keeps_the_wire(tmp_path):
    """A step's reproducer dump keeps a yuv420 batch as its wire and shape,
    and its reload gives the PackedYuv420 back."""
    from os2d_torch.engine.train import dump_nan_reproducer, load_nan_reproducer

    img = _images((2, 8, 12, 3))
    arrays = {"images": tpix.upload_images(Uploader("cpu"), img, "yuv420"),
              "gt_boxes": torch.zeros(2, 8, 4)}
    net = torch.nn.Linear(2, 2)
    path = dump_nan_reproducer(str(tmp_path), arrays, net, torch.optim.SGD(net.parameters(),
                                                                           lr=0.1), 4)
    loaded = load_nan_reproducer(path, device="cpu")["batch_arrays"]
    assert isinstance(loaded["images"], tpix.PackedYuv420)
    assert loaded["images"].shape == img.shape
    assert torch.equal(loaded["images"].data, arrays["images"].data)
    assert torch.equal(loaded["gt_boxes"], arrays["gt_boxes"])
