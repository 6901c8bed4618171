"""The port's device class cache against the JAX package's and against the
port's own host path, on the CPU, on the dataset of tests/test_class_cache.py
(four 240-px class patches, three 480x384 scenes) at its recipe (B=2,
class_batch_size 4, 320x320 crops, class images of 128 px):

- the [C, M, S, S, 3] stack equals JAX's, and `gather` equals JAX's
  gather for every method and flip (exact);
- loaders seeded alike, one with the cache and one without, draw the same
  batches (images, GT, class ids); their class tensors are equal on
  unflipped batches for all six methods, and equal to JAX's cache on the
  flipped ones (where BOX/NEAREST differ from the host path);
- `prepare_batch_arrays` of a cache batch equals JAX's, padded rows
  included;
- refusals: an incompatible augmentation recipe, a stack over budget
  (before any per-class resize), two class-image shapes;
- `trainval_loop`: "required" attaches the cache and its step's loss equals
  the host path's ("off") exactly; "auto" on an incompatible recipe falls
  back to host-built class images and logs why; "required" there raises.
"""

import logging
import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data.class_cache import DeviceClassCache as JaxCache
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.engine.train import prepare_batch_arrays as jax_prepare
from os2d_tpu.models import Os2dConfig as JaxOs2dConfig
from os2d_tpu.models import init_os2d_params
from os2d_torch.config import get_default_cfg
from os2d_torch.data.class_cache import DeviceClassCache
from os2d_torch.data.dataloader import DataloaderOneShotDetection, build_train_dataloader_from_config
from os2d_torch.data.transforms import RESAMPLE_CHOICES
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import prepare_batch_arrays, trainable_parameters, trainval_loop
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from test_class_cache import _make_cfg, _make_dataset
from test_torch_train_data import port_dataset

SEED = 123
BATCHES = 12


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    jds = _make_dataset(str(tmp_path_factory.mktemp("class_cache")), np.random.RandomState(0))
    return jds, port_dataset(jds)


def _loader(tds, cfg, cache=True):
    loader, _ = build_train_dataloader_from_config(cfg, tds, seed=SEED)
    if cache:
        loader.attach_device_class_cache(DeviceClassCache.build(loader, "cpu", budget_mb=256))
    return loader


def test_stack_and_gather_match_jax(datasets):
    jds, tds = datasets
    random.seed(SEED)
    jloader, _ = jax_build(_make_cfg(flips=True), dataset_train=jds)
    jcache = JaxCache.build(jloader, budget_mb=256)
    cache = _loader(tds, _make_cfg(flips=True)).device_class_cache
    assert cache.class_ids == jcache.class_ids and cache.index_of == jcache.index_of
    assert cache.sizes == jcache.sizes and cache.nbytes == jcache.nbytes
    assert cache.stack.dtype == torch.uint8
    np.testing.assert_array_equal(cache.stack.numpy(), np.asarray(jcache.stack))
    cids = cache.class_ids[::-1][:3]
    for hflip in (False, True):
        for vflip in (False, True):
            for m in range(len(RESAMPLE_CHOICES)):
                methods = [m, (m + 1) % 6, (m + 4) % 6]
                got = cache.gather(cids, methods, hflip, vflip, 4)
                want = jcache.gather(cids, methods, hflip, vflip, 4)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cache_batches_match_host_path(datasets):
    jds, tds = datasets
    cfg = _make_cfg(flips=True)
    host, cached = _loader(tds, cfg, cache=False), _loader(tds, cfg)
    random.seed(SEED)
    jloader, _ = jax_build(_make_cfg(flips=True), dataset_train=jds)
    jcache = JaxCache.build(jloader, budget_mb=256)
    unflipped_methods, flipped = set(), 0
    for i in range(BATCHES):
        if i and i % len(host) == 0:
            host.shuffle()
            cached.shuffle()
        hb, cb = host.get_batch(i % len(host)), cached.get_batch(i % len(host))
        assert cb["class_images"] is None
        g = cb["class_gather"]
        assert hb["class_ids"] == cb["class_ids"] == g["class_ids"]
        np.testing.assert_array_equal(hb["images"], cb["images"])
        for key in ("gt_boxes", "gt_labels", "gt_difficult", "gt_valid"):
            np.testing.assert_array_equal(hb[key], cb[key])
        got = g["cache"].gather(g["class_ids"], g["method_idx"], g["hflip"], g["vflip"],
                                len(g["class_ids"])).numpy()
        if g["hflip"] or g["vflip"]:
            flipped += 1
            want = np.asarray(jcache.gather(g["class_ids"], g["method_idx"], g["hflip"],
                                            g["vflip"], len(g["class_ids"])))
            np.testing.assert_array_equal(got, want)
        else:
            unflipped_methods.update(g["method_idx"])
            for row, host_img in enumerate(hb["class_images"]):
                np.testing.assert_array_equal(got[row], host_img)
    assert unflipped_methods == set(range(len(RESAMPLE_CHOICES)))
    assert flipped


def test_prepared_arrays_match_jax(datasets):
    jds, tds = datasets
    random.seed(SEED)
    jloader, _ = jax_build(_make_cfg(flips=True), dataset_train=jds)
    jloader.attach_device_class_cache(JaxCache.build(jloader, budget_mb=256))
    loader = _loader(tds, _make_cfg(flips=True))
    for i in range(2):
        jb, b = jloader.get_batch(i), loader.get_batch(i)
        want, j_pad = jax_prepare(jb, class_pad_multiple=8)
        got, c_pad = prepare_batch_arrays(b, "cpu", class_pad_multiple=8)
        assert c_pad == j_pad == 8
        for key, value in want.items():
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


@pytest.mark.parametrize("option", ["random_color_distortion", "random_crop_class_images",
                                    "mine_extra_class_images"])
def test_refuses_incompatible_recipe(datasets, option):
    _, tds = datasets
    cfg = _make_cfg(flips=False)
    cfg.train.augment[option] = True
    loader, _ = build_train_dataloader_from_config(cfg, tds, seed=SEED)
    with pytest.raises(ValueError, match=option):
        DeviceClassCache.build(loader, "cpu", budget_mb=256)
    ok_loader = _loader(tds, _make_cfg(flips=False))
    with pytest.raises(ValueError, match=option):
        loader.attach_device_class_cache(ok_loader.device_class_cache)


def test_refuses_over_budget_before_resizing(datasets, monkeypatch):
    _, tds = datasets
    loader = _loader(tds, _make_cfg(flips=False), cache=False)

    def no_resize(*args, **kwargs):
        raise AssertionError("a class image was resized before the budget check")

    monkeypatch.setattr(Image.Image, "resize", no_resize)
    with pytest.raises(ValueError, match="budget"):
        DeviceClassCache.build(loader, "cpu", budget_mb=0)


def test_refuses_two_class_shapes(datasets):
    _, tds = datasets
    loader = DataloaderOneShotDetection(tds, batch_size=2, gt_image_size=128, seed=SEED)
    cid = sorted(int(c) for c in tds.get_class_ids())[-1]
    original = tds.gt_images_per_classid[cid]
    tds.gt_images_per_classid[cid] = original.resize((240, 80))
    try:
        with pytest.raises(ValueError, match="single class-image shape"):
            DeviceClassCache.build(loader, "cpu")
    finally:
        tds.gt_images_per_classid[cid] = original


def _loop(tds, cfg, mode, params=None):
    cfg.tpu.device_class_cache = mode
    loader, _ = build_train_dataloader_from_config(cfg, tds, seed=SEED)
    model = Os2dModel(Os2dConfig(class_image_size=128, resample_precision="highest"),
                      device="cpu")
    if params is not None:
        model.load_state_dict(state_dict_from_jax(params))
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    log, _ = trainval_loop(loader, model, cfg, ObjectiveConfig(), optimizer)
    return loader, log


def test_trainval_loop_cache_modes(datasets, caplog):
    _, tds = datasets
    params = jax.tree_util.tree_map(np.asarray, init_os2d_params(
        jax.random.PRNGKey(1), JaxOs2dConfig(class_image_size=128)))
    losses = {}
    for mode in ("required", "off"):
        cfg = _make_cfg(flips=False)
        cfg.train.optim.max_iter = 1
        cfg.eval.iter = 1
        loader, log = _loop(tds, cfg, mode, params)
        assert (loader.device_class_cache is not None) == (mode == "required")
        losses[mode] = [v for v in log["train_loss"] if np.isfinite(v)]
    assert len(losses["off"]) == 1 and losses["required"] == losses["off"]

    cfg = _make_cfg(flips=False)
    cfg.train.augment.random_color_distortion = True
    cfg.train.optim.max_iter = 0
    with caplog.at_level(logging.INFO, logger="OS2D.train"):
        loader, _ = _loop(tds, cfg.clone(), "auto")
    assert loader.device_class_cache is None
    assert any("device class cache disabled (auto)" in r.getMessage()
               and "random_color_distortion" in r.getMessage() for r in caplog.records)
    with pytest.raises(ValueError, match="random_color_distortion"):
        _loop(tds, cfg.clone(), "True")
    with pytest.raises(ValueError, match="device_class_cache"):
        _loop(tds, cfg.clone(), "sometimes")
