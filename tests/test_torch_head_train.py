"""The port's head in train mode against the JAX package's
`head_forward(train_mode=True)` (the port's head takes no mode: it records
a graph whenever grad mode is on): the vector-Jacobian product of (loc, cls,
cls_detached) with a seeded cotangent, taken by the image features, the
class feature maps (before the 15x15 resize) and every TransformationNet
weight, BatchNorm's four tensors included. Narrow widths (F=16, C=3, B=2,
fm 6x7); the port runs its plain versions on the CPU.

- Identity theta (the TransformationNet's zero last layer, how every
  training run starts): the envelope |t0| + |t1| then holds exact zeros,
  where the port needs JAX's abs' (0) = +1 to give JAX's last-layer
  gradient. Also a random last layer (px/py spread, many clipped to the
  map's border, where the clip's tie rule matters).
- At "highest" both sides resample in fp32: outputs at atol 1e-5 (as
  tests/test_torch_head.py), gradients at rtol 1e-4, atol 1e-5: they sum
  over F, over the 225 correlation channels of the 7x7 and 5x5
  convolutions and over every anchor in another order (measured errors are
  ~1e-6 relative).
- At "default" the port's forward rounds to bf16 (cls within 4e-3 of JAX's
  fp32 forward, the tier's margin), while its backward is the same fp32
  hat-form gradient at every tier, as JAX's: the gradients keep the
  "highest" tolerance.
- The eval form is unchanged: with a graph recorded the head gives the
  values it gives under no_grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from os2d_tpu.models import head as jhead
from os2d_tpu.models.transform_net import init_transform_net_params
from os2d_torch.models import TransformNet
from os2d_torch.models import head as thead
from os2d_torch.models.from_jax import transform_net_state_dict_from_jax

B, C, H, W, F = 2, 3, 6, 7, 16
ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
DEFAULT_TIER_ATOL = 4e-3
CLASS_SHAPES = ((15, 15), (9, 12), (4, 5))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(identity_theta):
    rng = np.random.RandomState(5)
    fm = rng.randn(B, H, W, F).astype(np.float32)
    class_maps = [rng.randn(h, w, F).astype(np.float32) for h, w in CLASS_SHAPES]
    params = jax.tree_util.tree_map(np.asarray,
                                    init_transform_net_params(jax.random.PRNGKey(6), 6))
    if not identity_theta:
        params["linear"]["w"] = (0.05 * rng.randn(*params["linear"]["w"].shape)).astype(
            np.float32)
    # BN statistics away from the identity, so their gradients are exercised
    for bn in ("bn0", "bn1"):
        n = params[bn]["mean"].shape[0]
        params[bn] = {"scale": (1 + 0.1 * rng.randn(n)).astype(np.float32),
                      "bias": (0.1 * rng.randn(n)).astype(np.float32),
                      "mean": (0.1 * rng.randn(n)).astype(np.float32),
                      "var": (1 + 0.1 * rng.rand(n)).astype(np.float32)}
    cot = {"loc": rng.randn(B, C, 4, H * W).astype(np.float32),
           "cls": rng.randn(B, C, H * W).astype(np.float32),
           "cls_detached": rng.randn(B, C, H * W).astype(np.float32)}
    return fm, class_maps, params, cot


def _jax_vjp(fm, class_maps, params, cot, precision):
    def f(fm_, maps_, params_):
        out = jhead.head_forward(params_, fm_, jhead.build_class_head(list(maps_)),
                                 train_mode=True, resample_precision=precision)
        return {k: out[k] for k in cot}

    out, vjp = jax.vjp(f, jnp.asarray(fm), [jnp.asarray(m) for m in class_maps],
                       jax.tree_util.tree_map(jnp.asarray, params))
    d_fm, d_maps, d_params = vjp({k: jnp.asarray(v) for k, v in cot.items()})
    grads = transform_net_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, d_params))
    return ({k: np.asarray(v) for k, v in out.items()}, np.asarray(d_fm),
            [np.asarray(d) for d in d_maps], {k: v.numpy() for k, v in grads.items()})


def _torch_vjp(fm, class_maps, params, cot, precision):
    net = TransformNet(6, device="cpu")
    net.load_state_dict(transform_net_state_dict_from_jax(params))
    fm_t = torch.from_numpy(fm).requires_grad_(True)
    maps_t = [torch.from_numpy(m).requires_grad_(True) for m in class_maps]
    out = thead.head_forward(net, fm_t, thead.build_class_head(maps_t),
                             resample_precision=precision)
    assert not out["corners"].requires_grad
    sum(((out[k] * torch.from_numpy(v)).sum() for k, v in cot.items())).backward()
    return ({k: out[k].detach().numpy() for k in cot}, fm_t.grad.numpy(),
            [m.grad.numpy() for m in maps_t],
            {k: p.grad.numpy() for k, p in net.named_parameters()})


@pytest.fixture(scope="module", params=["identity_theta", "random_theta"])
def inputs(request):
    return _inputs(request.param == "identity_theta")


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_head_vjp_matches_jax(inputs, precision):
    fm, class_maps, params, cot = inputs
    out_w, dfm_w, dmaps_w, dparams_w = _jax_vjp(fm, class_maps, params, cot, "highest")
    out_g, dfm_g, dmaps_g, dparams_g = _torch_vjp(fm, class_maps, params, cot, precision)
    cls_atol = ATOL if precision == "highest" else DEFAULT_TIER_ATOL
    for key, atol in (("loc", ATOL), ("cls", cls_atol), ("cls_detached", cls_atol)):
        np.testing.assert_allclose(out_g[key], out_w[key], atol=atol, err_msg=key)
    np.testing.assert_allclose(dfm_g, dfm_w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg="d fm")
    for i, (x, y) in enumerate(zip(dmaps_g, dmaps_w)):
        np.testing.assert_allclose(x, y, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"d class map {i}")
    assert set(dparams_g) == set(dparams_w)
    for name in dparams_w:
        np.testing.assert_allclose(dparams_g[name], dparams_w[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"d {name}")


def test_identity_theta_needs_jax_abs_rule():
    """At identity theta the last layer's gradient through the envelope
    depends on abs' (0): with torch.abs (derivative 0) it is another."""
    fm, class_maps, params, cot = _inputs(identity_theta=True)
    cot = dict(cot, cls=np.zeros_like(cot["cls"]),
               cls_detached=np.zeros_like(cot["cls_detached"]))
    _, _, _, want = _jax_vjp(fm, class_maps, params, cot, "highest")
    _, _, _, got = _torch_vjp(fm, class_maps, params, cot, "highest")
    np.testing.assert_allclose(got["linear.weight"], want["linear.weight"], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    from os2d_torch.ops import geometry

    original = geometry.abs_jax_grad
    geometry.abs_jax_grad = torch.abs
    try:
        _, _, _, plain_abs = _torch_vjp(fm, class_maps, params, cot, "highest")
    finally:
        geometry.abs_jax_grad = original
    assert np.abs(plain_abs["linear.weight"] - want["linear.weight"]).max() > 1e-3


def test_train_mode_gives_the_eval_values(inputs):
    fm, class_maps, params, _ = inputs
    net = TransformNet(6, device="cpu")
    net.load_state_dict(transform_net_state_dict_from_jax(params))
    head = thead.build_class_head([torch.from_numpy(m) for m in class_maps])
    with torch.no_grad():
        ev = thead.head_forward(net, torch.from_numpy(fm), head)
    tr = thead.head_forward(net, torch.from_numpy(fm).requires_grad_(True), head)
    assert tr["cls"].requires_grad and not ev["cls"].requires_grad
    for key in ("loc", "cls", "cls_detached", "corners"):
        torch.testing.assert_close(tr[key].detach(), ev[key], rtol=0, atol=0)
