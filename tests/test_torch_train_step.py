"""The port's `TrainStep` against the JAX package's on the CPU, at the sizes of
tests/test_train.py: full-width ResNet50-C4 OS2D, 320x320 patches, class
images of 128 px, B=2, class_batch_size 4 (padded to 4), SGD with momentum
0.9 and weight decay 1e-4, lr 1e-3, max_grad_norm 100, the RLL objective with
target remapping and train_features. Both start from the same weights (the
JAX params through `state_dict_from_jax`) and take the same batches, which
the JAX train dataloader prepared; the resample runs at "highest" (fp32 on
both sides).

- After one step: the loss and every loss term (rtol 1e-4), the gradient
  norm (rtol 1e-4) and every updated parameter, BatchNorm's scale, bias,
  mean and var included (rtol 1e-4, atol 1e-6: the JAX trainer updates
  every leaf, and the port does too).
- The loss trajectory over 3 steps (rtol 1e-3).
The tolerances cover fp32 convolutions and reductions summed in another
order by XLA and by torch through a 50-layer network and its backward.
"""

import jax
import numpy as np
import pytest

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.engine.optimization import create_optimizer as jax_create_optimizer
from os2d_tpu.engine.train import TrainStep as JaxTrainStep
from os2d_tpu.engine.train import build_trainable_mask as jax_trainable_mask
from os2d_tpu.engine.train import prepare_batch_arrays as jax_prepare
from os2d_tpu.models import Os2dConfig as JaxOs2dConfig
from os2d_tpu.models import init_os2d_params
from os2d_torch.config import get_default_cfg
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.from_jax import state_dict_from_jax
from test_torch_train_data import train_cfg
from test_train import make_dataset

STEPS = 3
RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
TRAJECTORY_RTOL = 1e-3


def _cfg(cfg):
    cfg = train_cfg(cfg, augment=False)
    cfg.train.optim.lr = 1e-3
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three steps of each package from the same weights on the same
    batches: per step the metrics, and the state_dict after step 1."""
    jds = make_dataset(str(tmp_path_factory.mktemp("train_step")), np.random.RandomState(0))
    jcfg = _cfg(jax_default_cfg())
    import random

    random.seed(3)
    jloader, _ = jax_build(jcfg, dataset_train=jds)
    batches = [jloader.get_batch(0) for _ in range(STEPS)]

    model_cfg = JaxOs2dConfig(class_image_size=128, resample_precision="highest")
    params = init_os2d_params(jax.random.PRNGKey(1), model_cfg)
    start = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    optimizer = jax_create_optimizer(jcfg.train.optim, jax_trainable_mask(params, jcfg.train))
    opt_state = optimizer.init(params)
    step = JaxTrainStep(model_cfg, JaxObjectiveConfig(), optimizer, jcfg.train)
    jax_metrics, jax_after_1 = [], None
    for batch in batches:
        arrays, c_pad = jax_prepare(batch)
        params, opt_state, m = step(params, opt_state, arrays, c_pad)
        jax_metrics.append(dict(m.items()))
        if jax_after_1 is None:
            jax_after_1 = {k: v.numpy() for k, v in state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, params)).items()}

    tcfg = _cfg(get_default_cfg())
    model = Os2dModel(Os2dConfig(class_image_size=128, resample_precision="highest"),
                      device="cpu")
    model.load_state_dict(start)
    optimizer = create_optimizer(tcfg.train.optim, trainable_parameters(model, tcfg.train))
    step = TrainStep(model, ObjectiveConfig(), optimizer, tcfg.train)
    torch_metrics, torch_after_1 = [], None
    for batch in batches:
        arrays, c_pad = prepare_batch_arrays(batch, "cpu")
        torch_metrics.append(step(arrays, c_pad))
        if torch_after_1 is None:
            torch_after_1 = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return {"jax": jax_metrics, "torch": torch_metrics, "jax_after_1": jax_after_1,
            "torch_after_1": torch_after_1, "start": start}


def test_first_step_matches_jax(runs):
    got, want = runs["torch"][0], runs["jax"][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert want["loss"] > 0 and want["grad_norm"] > 0


def test_first_step_updates_match_jax(runs):
    got, want, start = runs["torch_after_1"], runs["jax_after_1"], runs["start"]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
    # the BN running statistics move too
    for name in ("backbone.bn1.running_mean", "backbone.layer3.5.bn3.running_var",
                 "transform_net.bn0.running_var", "transform_net.linear.weight"):
        assert not np.array_equal(got[name], start[name].numpy()), name


def test_loss_trajectory_matches_jax(runs):
    got = [m["loss"] for m in runs["torch"]]
    want = [m["loss"] for m in runs["jax"]]
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL)
    np.testing.assert_allclose([m["grad_norm"] for m in runs["torch"]],
                               [m["grad_norm"] for m in runs["jax"]], rtol=TRAJECTORY_RTOL)
