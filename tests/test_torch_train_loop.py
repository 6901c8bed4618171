"""The port's training loop on the CPU, at the recipe of tests/test_train.py
(full-width ResNet50-C4, 320x320 patches, class images of 128 px, B=2,
class_batch_size 4, resample at "highest"):

- `trainval_loop` for two iterations against the JAX package's from the same
  weights and the same seeded batches, with an eval dataloader over the
  planted scenes and cfg.eval.iter = 2: the loop evaluates with the
  objective as `criterion` before training and after the second step, and a
  final time without it. The metric logs have the same series; the training
  losses, the eval loss terms and the mAP agree (rtol 1e-3: two steps of
  fp32 training through another summation order), and the checkpoints and
  the learning rate are in place.
- freeze_transform: the TransformationNet stays fixed, the backbone moves,
  and the frozen weights' gradients still count in the clipping norm, as
  under JAX's post-chain mask (the first step's norm equals the unfrozen
  run's).
- A non-finite gradient: the update is skipped with the weights and the
  momentum state untouched, a reproducer is written, and replaying it gives
  the non-finite norm again.
"""

import copy
import math
import os
import random

import jax
import numpy as np
import pytest
import torch

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data.dataloader import DataloaderOneShotDetection as JaxLoader
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.engine.optimization import create_optimizer as jax_create_optimizer
from os2d_tpu.engine.train import build_trainable_mask as jax_trainable_mask
from os2d_tpu.engine.train import trainval_loop as jax_trainval_loop
from os2d_tpu.models import Os2dConfig as JaxOs2dConfig
from os2d_tpu.models import Os2dModel as JaxOs2dModel
from os2d_tpu.models import init_os2d_params
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import DataloaderOneShotDetection, build_train_dataloader_from_config
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer, get_learning_rate
from os2d_torch.engine.train import (
    TrainStep,
    load_nan_reproducer,
    prepare_batch_arrays,
    train_one_batch,
    trainable_parameters,
    trainval_loop,
)
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.utils.logger import load_checkpoint, setup_logger
from test_torch_train_data import port_dataset, train_cfg
from test_train import make_dataset

SEED = 11
RTOL = 1e-3


def _loop_cfg(cfg, out_dir):
    cfg = train_cfg(cfg, augment=False)
    cfg.train.optim.lr = 1e-3
    cfg.train.optim.max_iter = 2
    cfg.eval.iter = 2
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    cfg.tpu.device_class_cache = "off"
    cfg.output.path = str(out_dir)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jds = make_dataset(str(tmp_path_factory.mktemp("train_loop")), np.random.RandomState(0))
    params = init_os2d_params(jax.random.PRNGKey(1),
                              JaxOs2dConfig(class_image_size=128, resample_precision="highest"))
    return jds, port_dataset(jds), params


def _port_model(params):
    model = Os2dModel(Os2dConfig(class_image_size=128, resample_precision="highest"),
                      device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def test_trainval_loop_matches_jax(setup, tmp_path):
    jds, tds, params = setup
    jcfg = _loop_cfg(jax_default_cfg(), tmp_path / "jax")
    # the JAX loaders seed from the global stream, from which its train
    # augmentations then draw: the eval loader is made first
    jeval_loader = JaxLoader(jds, batch_size=1, gt_image_size=128, pyramid_scales_eval=[1.0])
    random.seed(SEED)
    jloader, _ = jax_build(jcfg, dataset_train=jds)
    jmodel_cfg = JaxOs2dConfig(class_image_size=128, resample_precision="highest")
    optimizer = jax_create_optimizer(jcfg.train.optim, jax_trainable_mask(params, jcfg.train))
    _, _, want_log, want_eval = jax_trainval_loop(
        jloader, JaxOs2dModel(jmodel_cfg), params, jcfg, JaxObjectiveConfig(), optimizer,
        optimizer.init(params), dataloaders_eval=[jeval_loader])

    cfg = _loop_cfg(get_default_cfg(), tmp_path / "torch")
    loader, _ = build_train_dataloader_from_config(cfg, tds, seed=SEED)
    eval_loader = DataloaderOneShotDetection(tds, batch_size=1, gt_image_size=128,
                                             pyramid_scales_eval=[1.0])
    model = _port_model(params)
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    got_log, got_eval = trainval_loop(loader, model, cfg, ObjectiveConfig(), optimizer,
                                      dataloaders_eval=[eval_loader])

    assert set(got_log) == set(want_log)
    name = tds.get_name()
    assert f"loss_{name}" in got_log and "train_loss" in got_log
    for key, want in want_log.items():
        if "time" in key:
            continue
        np.testing.assert_allclose(np.asarray(got_log[key], np.float64),
                                   np.asarray(want, np.float64), rtol=RTOL, atol=1e-6,
                                   err_msg=key)
    assert got_eval[name]["mAP@0.50"] == pytest.approx(want_eval[name]["mAP@0.50"], abs=1e-6)
    assert get_learning_rate(optimizer) == pytest.approx(1e-3)
    for i_iter in (0, 2):
        ckpt = load_checkpoint(os.path.join(cfg.output.path, f"checkpoint_iter_{i_iter}.pth"))
        assert ckpt["i_iter"] == i_iter and "net" in ckpt and "optimizer" in ckpt
    torch.testing.assert_close(ckpt["net"]["backbone.conv1.weight"],
                               model.backbone.conv1.weight.detach())


def _batch(tds):
    cfg = train_cfg(get_default_cfg(), augment=False)
    loader, _ = build_train_dataloader_from_config(cfg, tds, seed=SEED)
    return cfg, loader.get_batch(0)


def test_freeze_transform_keeps_it_fixed_and_in_the_norm(setup):
    _, tds, params = setup
    cfg, batch = _batch(tds)
    norms = {}
    for freeze in (False, True):
        cfg2 = copy.deepcopy(cfg)
        cfg2.train.model.freeze_transform = freeze
        model = _port_model(params)
        trainable = trainable_parameters(model, cfg2.train)
        assert (len(trainable) < len(list(model.parameters()))) == freeze
        optimizer = create_optimizer(cfg2.train.optim, trainable)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        step = TrainStep(model, ObjectiveConfig(), optimizer, cfg2.train)
        norms[freeze] = step(*prepare_batch_arrays(batch, "cpu"))["grad_norm"]
        after = model.state_dict()
        changed_tn = [k for k in before if k.startswith("transform_net.")
                      and not torch.equal(before[k], after[k])]
        assert bool(changed_tn) != freeze
        assert not torch.equal(before["backbone.conv1.weight"], after["backbone.conv1.weight"])
    assert norms[True] == pytest.approx(norms[False], rel=1e-6)


def test_nonfinite_gradient_skips_the_update(setup, tmp_path):
    _, tds, params = setup
    cfg, batch = _batch(tds)
    model = _port_model(params)
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    step = TrainStep(model, ObjectiveConfig(), optimizer, cfg.train)
    logger = setup_logger("OS2D.test_torch_nan")
    assert math.isfinite(train_one_batch(batch, step, logger)["grad_norm"])  # momentum exists
    with torch.no_grad():
        model.transform_net.conv0.weight.fill_(float("nan"))
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    momentum = {id(p): optimizer.state[p]["momentum_buffer"].clone()
                for p in trainable_parameters(model, cfg.train)}
    meters = train_one_batch(batch, step, logger, dump_dir=str(tmp_path))
    assert not math.isfinite(meters["grad_norm"])
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, weights[k], rtol=0, atol=0, equal_nan=True)
    for p in trainable_parameters(model, cfg.train):
        assert torch.equal(optimizer.state[p]["momentum_buffer"], momentum[id(p)])
    dumps = list(tmp_path.glob("error_nan_appeared-*.pth"))
    assert len(dumps) == 1
    payload = load_nan_reproducer(dumps[0], device="cpu")
    assert payload["num_classes"] == 4
    replay = _port_model(params)
    replay.load_state_dict(payload["net"])
    replay_opt = create_optimizer(cfg.train.optim, trainable_parameters(replay, cfg.train))
    replay_opt.load_state_dict(payload["optimizer"])
    metrics = TrainStep(replay, ObjectiveConfig(), replay_opt, cfg.train)(
        payload["batch_arrays"], payload["num_classes"])
    assert not math.isfinite(metrics["grad_norm"])


def test_nan_reproducer_loads_onto_the_card_by_default(monkeypatch):
    """JAX's loader puts the dump on the default device; the port's takes
    the card unless told otherwise, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_nan_reproducer("error_nan_appeared-missing.pth")
