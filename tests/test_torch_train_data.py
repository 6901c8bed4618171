"""The port's train dataloader against the JAX package's, on the planted
dataset of tests/test_train.py at its recipe (320x320 patches with scale and
aspect jitter, class images of 128 px, B=2, class_batch_size 4), with
random flips, color distortion and class-image crops switched on so every
random draw is exercised.

The JAX loader draws its augmentations from the global `random` and seeds
its batch-level generator from it; the port owns both generators, seeded
from `seed`. With the global stream seeded as the port's seed, the two make
the same calls in the same order, so the batches are equal: images, class
images and padded GT exactly, across a shuffle. Also: the batch arrays on
the device (`prepare_batch_arrays`, rgb8 and the yuv420 wire) and the
trainer's options, taken or refused as the JAX trainer's are.
"""

import random

import numpy as np
import pytest
import torch

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.engine.train import prepare_batch_arrays as jax_prepare
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import build_train_dataloader_from_config
from os2d_torch.data.dataset import DatasetOneShotDetection
from os2d_torch.engine.train import prepare_batch_arrays
from test_train import make_dataset

SEED = 7


def train_cfg(cfg, augment=True):
    cfg.train.batch_size = 2
    cfg.train.class_batch_size = 4
    cfg.train.augment.train_patch_width = 320
    cfg.train.augment.train_patch_height = 320
    cfg.model.class_image_size = 128
    cfg.eval.train_subset_for_eval_size = 0
    if augment:
        cfg.train.augment.random_flip_batches = True
        cfg.train.augment.random_color_distortion = True
        cfg.train.augment.random_crop_class_images = True
    else:
        cfg.train.augment.scale_jitter = 1.0
        cfg.train.augment.jitter_aspect_ratio = 1.0
    return cfg


def port_dataset(jax_dataset):
    return DatasetOneShotDetection(
        jax_dataset.gtboxframe, gt_path=jax_dataset.gt_path,
        image_path=jax_dataset.image_path, name=jax_dataset.name,
        image_size=jax_dataset.image_size, eval_scale=jax_dataset.eval_scale,
        cache_images=True)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    jds = make_dataset(str(tmp_path_factory.mktemp("train_data")), np.random.RandomState(0))
    return jds, port_dataset(jds)


def _batches(loader, n):
    out = []
    for i in range(n):
        if i == len(loader):
            loader.shuffle()
        out.append(loader.get_batch(i % len(loader)))
    return out


def test_train_batches_match_jax(datasets):
    jds, tds = datasets
    random.seed(SEED)
    jloader, _ = jax_build(train_cfg(jax_default_cfg()), dataset_train=jds)
    want = _batches(jloader, 4)
    loader, _ = build_train_dataloader_from_config(train_cfg(get_default_cfg()), tds, seed=SEED)
    got = _batches(loader, 4)
    for g, w in zip(got, want):
        assert g["class_ids"] == w["class_ids"]
        assert g["img_size"] == w["img_size"]
        assert g["images"].dtype == w["images"].dtype == np.uint8
        np.testing.assert_array_equal(g["images"], w["images"])
        assert len(g["class_images"]) == len(w["class_images"])
        for a, b in zip(g["class_images"], w["class_images"]):
            assert a.dtype == np.uint8 and a.shape == (128, 128, 3)
            np.testing.assert_array_equal(a, b)
        for key in ("gt_boxes", "gt_labels", "gt_difficult", "gt_valid"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    # the recipe's draws moved something: images differ between the batches
    assert not np.array_equal(got[0]["images"], got[-1]["images"][:len(got[0]["images"])])


def test_prepared_arrays_match_jax(datasets):
    jds, tds = datasets
    random.seed(SEED)
    jloader, _ = jax_build(train_cfg(jax_default_cfg(), augment=False), dataset_train=jds)
    batch = jloader.get_batch(0)
    want, j_pad = jax_prepare(batch)
    got, c_pad = prepare_batch_arrays(batch, "cpu")
    assert c_pad == j_pad == 4
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    assert got["images"].dtype == torch.uint8 and got["class_images"].dtype == torch.uint8
    # the yuv420 wire: JAX's bytes, every other array as with rgb8
    # (tests/test_torch_pixel_format.py takes a train step on it)
    want_yuv, _ = jax_prepare(batch, pixel_format="yuv420")
    got_yuv, _ = prepare_batch_arrays(batch, "cpu", pixel_format="yuv420")
    assert got_yuv["images"].shape == want_yuv["images"].shape == tuple(got["images"].shape)
    np.testing.assert_array_equal(got_yuv["images"].data.numpy(),
                                  np.asarray(want_yuv["images"].data))
    for key in want:
        if key != "images":
            np.testing.assert_array_equal(got_yuv[key].numpy(), got[key].numpy(), err_msg=key)
    with pytest.raises(ValueError, match="upload_pixel_format"):
        prepare_batch_arrays(batch, "cpu", pixel_format="yuv444")


def test_batch_prefetcher_pool_ordering_and_errors():
    """The multi-worker BatchPrefetcher (tests/test_train.py's case): in-order
    delivery, a worker's exception surfaced to the consumer, and the pool
    alive after it."""
    import time

    from os2d_torch.engine.train import BatchPrefetcher

    class SlowLoader:
        def get_batch(self, index):
            time.sleep(0.05 * (3 - (index % 4)))  # later indices finish first
            if index == 11:
                raise ValueError("boom-11")
            return {"index": index}

    pf = BatchPrefetcher(SlowLoader(), depth=4, prepare_fn=lambda b: ("prep", b["index"]),
                         workers=3)
    for i in range(8):
        pf.schedule(i)
    got = [pf.get() for _ in range(8)]
    assert [g[0] for g in got] == list(range(8))
    assert [g[2] for g in got] == [("prep", i) for i in range(8)]
    for i in (10, 11, 12):
        pf.schedule(i)
    assert pf.get()[0] == 10
    with pytest.raises(ValueError, match="boom-11"):
        pf.get()
    assert pf.get()[0] == 12
    pf.close()


@pytest.mark.parametrize("key,value", [("tpu.upload_pixel_format", "yuv420"),
                                       ("tpu.checkpoint_backend", "orbax")])
def test_trainval_loop_refuses_unported_options(key, value):
    """Every option of the JAX trainer runs (the visualisation flags:
    tests/test_torch_visualization.py; the wire's step:
    tests/test_torch_pixel_format.py; the "orbax" backend's files:
    tests/test_torch_checkpoint.py): trainval_loop takes the value and runs
    to its final evaluation, here with no training and no eval loader. A
    value that neither package knows raises before any work."""
    from os2d_torch.engine.train import trainval_loop
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = get_default_cfg()
    cfg.merge_from_list([key, str(value), "train.do_training", "False"])
    full_log, meters_eval = trainval_loop(None, Os2dModel(Os2dConfig(), device="cpu"), cfg,
                                          None, None)
    assert full_log == {} and meters_eval == {}
    cfg = get_default_cfg()
    cfg.merge_from_list([key, "tensorstore"])
    with pytest.raises(ValueError, match=key.split(".")[-1]):
        trainval_loop(None, None, cfg, None, None)
    # a mesh runs now; a batch that does not divide over it raises first
    from os2d_torch.parallel import Mesh

    cfg = get_default_cfg()
    cfg.train.batch_size = 3
    with pytest.raises(ValueError, match="divisible by the mesh size 2"):
        trainval_loop(None, None, cfg, None, None, mesh=Mesh(None, 0, 2, torch.device("cpu")))


@pytest.mark.parametrize("frozen_blocks,freeze_transform,train_features",
                         [(0, False, True), (5, True, True), (2, False, False)])
def test_trainable_mask_matches_jax(frozen_blocks, freeze_transform, train_features):
    """`build_trainable_mask` names the leaves JAX's mask freezes: the first
    blocks of each backbone (conv1 + bn1 the first), the TransformationNet,
    every backbone without train_features; BatchNorm's tensors train."""
    import jax

    from os2d_tpu.engine.train import build_trainable_mask as jax_mask
    from os2d_tpu.models import Os2dConfig as JaxOs2dConfig
    from os2d_tpu.models import init_os2d_params
    from os2d_torch.engine.train import build_trainable_mask
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models.from_jax import state_dict_from_jax

    jcfg, cfg = jax_default_cfg(), get_default_cfg()
    for c in (jcfg, cfg):
        c.train.model.num_frozen_extractor_blocks = frozen_blocks
        c.train.model.freeze_transform = freeze_transform
        c.train.model.train_features = train_features
    params = jax.tree_util.tree_map(np.asarray, init_os2d_params(
        jax.random.PRNGKey(0), JaxOs2dConfig(merge_branch_parameters=False)))
    mask = jax_mask(params, jcfg.train)
    # the mask as arrays shaped like the params, mapped to torch names
    mask_arrays = jax.tree_util.tree_map(lambda p, m: np.full(p.shape, m, np.float32),
                                         params, mask)
    want = {k: bool(v.all()) for k, v in state_dict_from_jax(mask_arrays).items()}
    got = build_trainable_mask(Os2dModel(Os2dConfig(merge_branch_parameters=False),
                                         device="cpu"), cfg.train)
    assert got == want
    assert (not all(got.values())) == (frozen_blocks > 0 or freeze_transform
                                       or not train_features)
