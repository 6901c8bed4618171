"""The grid path of the port's head (`corr_interior_first=False`: the natural
225-channel order, affine grids, the interior compacted out of corr) and the
grid contract of the resample, against the JAX package on the CPU.

- `affine_grid_2d` and `local_to_global_grid` at atol 1e-6.
- The grid contract `resample_correlation_map` against the Pallas kernels
  in interpret mode, run as tests/test_pallas_resample.py runs them: the
  gather (`resample_correlation_map_pallas`) at "highest", rtol 1e-5, atol
  1e-6; the hat kernel (`hat_resample_correlation_map_pallas`) at
  "default", rtol 1e-5, atol 2e-6 (tests/test_torch_hat_resample.py's
  tolerance). `resample_correlation_map_masked` against JAX's at "highest"
  and on its interior-first twin to the bit.
- The head with `corr_interior_first=False` against JAX's at "highest"
  (atol 1e-5) and "default" (cls within 4e-3, the tier's prescreen margin),
  and against the port's interior-first head.
- A first `TrainStep` on the grid path against JAX's, at the recipe and the
  tolerances of tests/test_torch_train_step.py (loss terms and gradient norm
  rtol 1e-4; parameters rtol 1e-4, atol 1e-6).
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.engine.optimization import create_optimizer as jax_create_optimizer
from os2d_tpu.engine.train import TrainStep as JaxTrainStep
from os2d_tpu.engine.train import build_trainable_mask as jax_trainable_mask
from os2d_tpu.engine.train import prepare_batch_arrays as jax_prepare
from os2d_tpu.models import Os2dConfig as JaxOs2dConfig
from os2d_tpu.models import head as jhead
from os2d_tpu.models import init_os2d_params
from os2d_tpu.models.transform_net import init_transform_net_params
from os2d_tpu.ops import geometry as jgeom
from os2d_tpu.ops import sampling as jsampling
from os2d_tpu.ops.pallas_hat_resample import hat_resample_correlation_map_pallas
from os2d_tpu.ops.pallas_resample import resample_correlation_map_pallas
from os2d_torch.config import get_default_cfg
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
from os2d_torch.models import Os2dConfig, Os2dModel, TransformNet
from os2d_torch.models import head as thead
from os2d_torch.models.from_jax import state_dict_from_jax, transform_net_state_dict_from_jax
from os2d_torch.ops import geometry as tgeom
from os2d_torch.ops import sampling as tsampling
from test_torch_train_data import train_cfg
from test_train import make_dataset

ATOL = 1e-5
DEFAULT_TIER_ATOL = 4e-3
STEP_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These tests run many small torch ops; with one intra-op thread they
    do not wait on OpenMP barriers when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_affine_grid_and_local_to_global_match_jax():
    rng = np.random.RandomState(0)
    theta = rng.randn(2, 3, 2, 3).astype(np.float32)
    for gh, gw in ((15, 15), (4, 7), (1, 5)):
        np.testing.assert_allclose(
            tgeom.affine_grid_2d(torch.from_numpy(theta), gh, gw).numpy(),
            np.asarray(jgeom.affine_grid_2d(jnp.asarray(theta), gh, gw)), atol=1e-6)
    grids = rng.uniform(-1, 1, (2, 3, 15, 15, 2)).astype(np.float32)
    boxes = rng.uniform(0, 50, (2, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tgeom.local_to_global_grid(torch.from_numpy(grids), torch.from_numpy(boxes)).numpy(),
        np.asarray(jgeom.local_to_global_grid(jnp.asarray(grids), jnp.asarray(boxes))),
        atol=1e-6)


def _grid_inputs(b, c, h, w, th, seed, mask_border=True):
    rng = np.random.RandomState(seed)
    corr = np.tanh(rng.randn(b, c, h, w, th * th)).astype(np.float32)
    grids = np.clip(rng.uniform(-1.1, 1.1, (b, c, h, w, th, th, 2)), -1, 1).astype(np.float32)
    mask = rng.rand(c, th, th).astype(np.float32)
    if mask_border:
        mask[:, :2], mask[:, -2:], mask[:, :, :2], mask[:, :, -2:] = 0, 0, 0, 0
    mask /= mask.reshape(c, -1).sum(1)[:, None, None]
    return corr, grids, mask


@pytest.mark.parametrize("b,c,h,w", [(1, 2, 8, 16), (2, 3, 6, 7)])
def test_grid_contract_matches_pallas_gather(b, c, h, w):
    corr, grids, mask = _grid_inputs(b, c, h, w, 15, seed=1)
    want = np.asarray(resample_correlation_map_pallas(
        jnp.asarray(corr), jnp.asarray(grids), jnp.asarray(mask), interpret=True))
    got = tsampling.resample_correlation_map(torch.from_numpy(corr), torch.from_numpy(grids),
                                             torch.from_numpy(mask), "highest")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,c,h,w,th", [(1, 2, 8, 16, 5), (2, 2, 10, 13, 11)])
def test_grid_contract_matches_pallas_hat(b, c, h, w, th):
    corr, grids, mask = _grid_inputs(b, c, h, w, th, seed=2, mask_border=False)
    want = np.asarray(hat_resample_correlation_map_pallas(
        jnp.asarray(corr), jnp.asarray(grids), jnp.asarray(mask), a_blk=64, interpret=True))
    got = tsampling.resample_correlation_map(torch.from_numpy(corr), torch.from_numpy(grids),
                                             torch.from_numpy(mask), "default")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-6)


def test_masked_grid_contract_matches_jax():
    """The interior compacted out of the natural order, against JAX's
    `resample_correlation_map_masked` and against the same samples taken
    from an interior-first corr by the t-major contract (bit-equal)."""
    b, c, h, w = 2, 3, 6, 7
    corr, grids, mask = _grid_inputs(b, c, h, w, 15, seed=3)
    want = np.asarray(jsampling.resample_correlation_map_masked(
        jnp.asarray(corr), jnp.asarray(grids), jnp.asarray(mask), 2, precision="highest"))
    corr_t, grids_t, mask_t = (torch.from_numpy(x) for x in (corr, grids, mask))
    got = tsampling.resample_correlation_map_masked(corr_t, grids_t, mask_t, 2, "highest")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    perm = torch.tensor(thead._interior_permutation())
    _, px, py, m = tsampling.grid_resample_operands(corr_t, grids_t, mask_t, 2)
    prefix = tsampling.resample_correlation_from_pxpy_reference(
        corr_t[..., perm][..., :121], px, py, m)
    torch.testing.assert_close(got, prefix, rtol=0, atol=0)


def _head_inputs(seed=3, b=2, h=6, w=7, f=64):
    rng = np.random.RandomState(seed)
    fm = rng.randn(b, h, w, f).astype(np.float32)
    maps = [rng.randn(hh, ww, f).astype(np.float32) for hh, ww in ((15, 15), (9, 12), (4, 5))]
    params = jax.tree_util.tree_map(np.asarray,
                                    init_transform_net_params(jax.random.PRNGKey(seed), 6))
    params["linear"]["w"] = (0.02 * rng.randn(*params["linear"]["w"].shape)).astype(np.float32)
    net = TransformNet(6, device="cpu")
    net.load_state_dict(transform_net_state_dict_from_jax(params))
    return fm, maps, params, net


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_grid_path_head_matches_jax(precision):
    fm, maps, params, net = _head_inputs()
    want = jhead.head_forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(fm),
                              jhead.build_class_head([jnp.asarray(m) for m in maps]),
                              resample_precision=precision, corr_interior_first=False)
    head = thead.build_class_head([torch.from_numpy(m) for m in maps])
    with torch.no_grad():
        got = thead.head_forward(net, torch.from_numpy(fm), head, resample_precision=precision,
                                 corr_interior_first=False)
        first = thead.head_forward(net, torch.from_numpy(fm), head,
                                   resample_precision=precision)
    cls_atol = ATOL if precision == "highest" else DEFAULT_TIER_ATOL
    for key, atol, rtol in (("loc", ATOL, 0.0), ("cls", cls_atol, 0.0),
                            ("corners", ATOL, 1e-5)):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol,
                                   rtol=rtol, err_msg=key)
        # the two channel orders compute the same function (the TransformNet
        # sums its 225 input channels in another order)
        np.testing.assert_allclose(got[key].numpy(), first[key].numpy(), atol=ATOL,
                                   rtol=rtol, err_msg=key)


def first_step(tmp_dir, seed=1, prepare=None, **model_kwargs):
    """One TrainStep of each package from the same weights on the same batch,
    at the recipe of tests/test_torch_train_step.py with the model options
    `model_kwargs` (and JAX's initial params passed through `prepare`):
    (JAX's metrics, the port's, JAX's state_dict after the step, the
    port's, the start)."""
    jds = make_dataset(str(tmp_dir), np.random.RandomState(0))
    jcfg = train_cfg(jax_default_cfg(), augment=False)
    jcfg.train.optim.lr = 1e-3
    random.seed(3)
    jloader, _ = jax_build(jcfg, dataset_train=jds)
    batch = jloader.get_batch(0)

    kwargs = dict(class_image_size=128, resample_precision="highest", **model_kwargs)
    model_cfg = JaxOs2dConfig(**kwargs)
    params = init_os2d_params(jax.random.PRNGKey(seed), model_cfg)
    if prepare is not None:
        params = prepare(params)
    start = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    optimizer = jax_create_optimizer(jcfg.train.optim, jax_trainable_mask(params, jcfg.train))
    step = JaxTrainStep(model_cfg, JaxObjectiveConfig(), optimizer, jcfg.train)
    params, _, jax_metrics = step(params, optimizer.init(params), *jax_prepare(batch))
    jax_after = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}

    tcfg = train_cfg(get_default_cfg(), augment=False)
    tcfg.train.optim.lr = 1e-3
    model = Os2dModel(Os2dConfig(**kwargs), device="cpu")
    model.load_state_dict(start)
    optimizer = create_optimizer(tcfg.train.optim, trainable_parameters(model, tcfg.train))
    torch_metrics = TrainStep(model, ObjectiveConfig(), optimizer, tcfg.train)(
        *prepare_batch_arrays(batch, "cpu"))
    torch_after = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return dict(jax_metrics.items()), torch_metrics, jax_after, torch_after, start


def check_first_step(want, got, want_after, got_after, start, moved):
    """The port's step (got) against JAX's (want)."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_RTOL, err_msg=k)
    assert want["loss"] > 0 and want["grad_norm"] > 0
    assert set(got_after) == set(want_after)
    for name in want_after:
        np.testing.assert_allclose(got_after[name], want_after[name], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
    for name in moved:
        assert not np.array_equal(got_after[name], start[name].numpy()), name


def test_grid_path_first_step_matches_jax(tmp_path):
    check_first_step(*first_step(tmp_path, corr_interior_first=False),
                     moved=("transform_net.conv0.weight", "transform_net.linear.weight",
                            "backbone.layer3.5.conv3.weight"))
