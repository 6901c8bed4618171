"""The port's head (correlation, TransformationNet, theta, px/py, resample,
localization) against the JAX package's `head_forward`, for the three
affine variants, at narrow widths (F=64, C=3, B=2, fm 6x7).

At resample precision "highest" both sides resample in fp32. Tolerance atol
1e-5 on loc, cls and corners: fp32 sums over F=64 and the 225-channel
convolutions run in another order. Corners are image coordinates up to
~240 px, where one fp32 ulp is already 1.5e-5, so they get rtol 1e-5 beside
the atol (measured: ~1e-6 relative, a few ulps).

At the "default" tier the port rounds corr*mask and the hat rows to bf16, as
its kernel does, while JAX on the CPU runs every tier in exact fp32: cls is
held at 4e-3 (the tier's prescreen margin); loc and corners do not pass
through the resample and keep 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.models import head as jhead
from os2d_tpu.models.transform_net import init_transform_net_params
from os2d_torch.models import TransformNet
from os2d_torch.models import head as thead
from os2d_torch.models.from_jax import transform_net_state_dict_from_jax

B, C, H, W, F = 2, 3, 6, 7, 64
ATOL = 1e-5
DEFAULT_TIER_ATOL = 4e-3


def _tn_params(output_dim, seed):
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        np.asarray, init_transform_net_params(jax.random.PRNGKey(seed), output_dim))
    # a non-zero final layer, so theta varies per anchor and class
    params["linear"]["w"] = (0.02 * rng.randn(*params["linear"]["w"].shape)).astype(np.float32)
    return params


AFFINE_VARIANTS = [(False, True), (False, False), (True, True)]


def _head_both(simple_affine, inverse, precision):
    rng = np.random.RandomState(3)
    fm = rng.randn(B, H, W, F).astype(np.float32)
    class_maps = [rng.randn(h, w, F).astype(np.float32) for h, w in ((15, 15), (9, 12), (4, 5))]
    params = _tn_params(4 if simple_affine else 6, seed=4)

    jhead_ = jhead.build_class_head([jnp.asarray(m) for m in class_maps])
    want = jhead.head_forward(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(fm), jhead_,
        simple_affine=simple_affine, use_inverse_geom_model=inverse,
        resample_precision=precision)

    net = TransformNet(4 if simple_affine else 6, device="cpu")
    net.load_state_dict(transform_net_state_dict_from_jax(params))
    thead_ = thead.build_class_head([torch.from_numpy(m) for m in class_maps])
    np.testing.assert_allclose(thead_.class_feats.numpy(), np.asarray(jhead_.class_feats),
                               atol=1e-6)
    np.testing.assert_array_equal(thead_.pool_mask.numpy(), np.asarray(jhead_.pool_mask))
    with torch.no_grad():
        got = thead.head_forward(net, torch.from_numpy(fm), thead_,
                                 simple_affine=simple_affine, use_inverse_geom_model=inverse,
                                 resample_precision=precision)
    assert got["fm_size"] == (H, W)
    return got, want


@pytest.mark.parametrize("simple_affine,inverse", AFFINE_VARIANTS)
def test_head_forward_matches_jax(simple_affine, inverse):
    got, want = _head_both(simple_affine, inverse, "highest")
    for key, rtol in (("loc", 0.0), ("cls", 0.0), ("corners", 1e-5)):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   rtol=rtol, err_msg=key)


@pytest.mark.parametrize("simple_affine,inverse", AFFINE_VARIANTS)
def test_head_forward_default_tier_matches_jax(simple_affine, inverse):
    got, want = _head_both(simple_affine, inverse, "default")
    for key, atol, rtol in (("loc", ATOL, 0.0), ("cls", DEFAULT_TIER_ATOL, 0.0),
                            ("corners", ATOL, 1e-5)):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol,
                                   rtol=rtol, err_msg=key)
    # the bf16 rounding is there: the tiers differ, by less than the margin
    assert float(np.abs(got["cls"].numpy() - np.asarray(want["cls"])).max()) > ATOL


def test_head_rejects_unported_options():
    net = TransformNet(6, device="cpu")
    fm = torch.zeros(1, 4, 5, 8)
    ch = thead.build_class_head(torch.ones(2, 15, 15, 8))
    with pytest.raises(NotImplementedError, match="int8"):
        thead.head_forward(net, fm, ch, resample_precision="int8")
    with pytest.raises(NotImplementedError, match="corr_interior_first"):
        thead.head_forward(net, fm, ch, corr_interior_first=False)


def test_interior_permutation_and_mask_match_jax():
    assert thead._interior_permutation() == jhead._interior_permutation()
    np.testing.assert_array_equal(thead.make_class_pool_mask(3).numpy(),
                                  np.asarray(jhead.make_class_pool_mask(3)))
    assert thead.ANCHOR_BOX == jhead.ANCHOR_BOX and thead.ANCHOR_STRIDE == jhead.ANCHOR_STRIDE


def test_head_forward_single_class_matches_jax():
    """One class: the permuted corr keeps an odd stride on its size-1 class
    dimension, which the resample's contract accepts."""
    rng = np.random.RandomState(5)
    fm = rng.randn(1, H, W, F).astype(np.float32)
    class_map = rng.randn(15, 15, F).astype(np.float32)
    params = _tn_params(6, seed=6)
    want = jhead.head_forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(fm),
                              jhead.build_class_head([jnp.asarray(class_map)]),
                              resample_precision="highest")
    net = TransformNet(6, device="cpu")
    net.load_state_dict(transform_net_state_dict_from_jax(params))
    with torch.no_grad():
        got = thead.head_forward(net, torch.from_numpy(fm),
                                 thead.build_class_head([torch.from_numpy(class_map)]),
                                 resample_precision="highest")
    for key in ("loc", "cls"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, err_msg=key)
