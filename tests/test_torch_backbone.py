"""The port's ResNet50-C4 and TransformationNet against the JAX package's,
with the JAX init converted through the weight bridge (models/from_jax.py).

Tolerances: rtol 1e-4, atol 1e-4 on C4 features: fp32 convolutions over 13
bottleneck blocks sum in another order in XLA and in PyTorch's CPU kernels,
and the randomly initialized activations reach magnitudes of ~1e1.
TransformationNet outputs: rtol 1e-5, atol 1e-5 (three convolutions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.models import os2d as jos2d
from os2d_tpu.models.resnet import resnet_c4_forward
from os2d_tpu.models.transform_net import transform_net_forward
from os2d_torch.models import Os2dConfig, Os2dModel, TransformNet
from os2d_torch.models.from_jax import state_dict_from_jax, transform_net_state_dict_from_jax


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    return jos2d.init_os2d_params(jax.random.PRNGKey(0), jos2d.Os2dConfig())


def test_bridge_fills_every_weight(jax_params):
    model = Os2dModel(Os2dConfig(), device="cpu")
    sd = state_dict_from_jax(_numpy_tree(jax_params))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)

    separate = jos2d.init_os2d_params(
        jax.random.PRNGKey(1), jos2d.Os2dConfig(merge_branch_parameters=False))
    model2 = Os2dModel(Os2dConfig(merge_branch_parameters=False), device="cpu")
    sd2 = state_dict_from_jax(_numpy_tree(separate))
    model2.load_state_dict(sd2)
    assert any(k.startswith("label_backbone.") for k in sd2)
    np.testing.assert_array_equal(
        model2.label_backbone.conv1.weight.numpy(),
        np.transpose(np.asarray(separate["label_backbone"]["conv1"]), (3, 2, 0, 1)))


def test_resnet50_c4_matches_jax(jax_params):
    model = Os2dModel(Os2dConfig(), device="cpu")
    model.load_state_dict(state_dict_from_jax(_numpy_tree(jax_params)))
    img = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    want = np.asarray(resnet_c4_forward(jax_params["backbone"], jnp.asarray(img)))
    got = model.extract_features(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 4, 6, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("output_dim", [6, 4])
def test_transform_net_matches_jax(output_dim):
    from os2d_tpu.models.transform_net import init_transform_net_params

    rng = np.random.RandomState(1)
    params = _numpy_tree(init_transform_net_params(jax.random.PRNGKey(2), output_dim))
    # a non-zero final layer and BatchNorm statistics, so every stage counts
    params["linear"]["w"] = (0.01 * rng.randn(*params["linear"]["w"].shape)).astype(np.float32)
    for bn in ("bn0", "bn1"):
        n = params[bn]["mean"].shape[0]
        params[bn] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                      "bias": rng.randn(n).astype(np.float32) * 0.1,
                      "mean": rng.randn(n).astype(np.float32) * 0.1,
                      "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    x = rng.randn(3, 6, 7, 225).astype(np.float32)
    want = np.asarray(transform_net_forward(jax.tree_util.tree_map(jnp.asarray, params),
                                            jnp.asarray(x)))
    net = TransformNet(output_dim, device="cpu")
    net.load_state_dict(transform_net_state_dict_from_jax(params))
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
