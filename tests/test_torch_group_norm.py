"""GroupNorm(32) backbones and ResNet101-C4 in the port against the JAX
package on the CPU (`Os2dConfig(use_group_norm=True)`, `backbone_arch=
"resnet101"`), with the JAX params converted through `models/from_jax.py`.

- ResNet50-C4 with GN and ResNet101-C4 with BN and with GN against
  `resnet_c4_forward` on a 64x96 image, the normalizations' weights and
  biases randomized as a trained network's (`_norm_params`): rtol and atol
  1e-4 (the tolerance of tests/test_torch_backbone.py; the port's GroupNorm
  is F.group_norm, whose statistics equal JAX's two-pass ones up to the
  order of the fp32 sums).
- `from_jax` turns GN slots {scale, bias} into `<bn>.weight`, `<bn>.bias`
  and fills every weight of a GN model.
- `fold_inference_params` leaves GN as it is (it depends on the
  activations) and equals JAX's `fold_inference_params`.
- bf16 compute with GN, the bf16 rule of tests/test_torch_numeric_modes.py
  stage by stage (stem, each bottleneck) on JAX's own inputs; GN's output
  is fp32 in every compute dtype.
- The checkpoint cascade with GN (a reference "net", weakalign, a reference
  state_dict, a torchvision backbone and a converted caffe2 GroupNorm dump)
  equal to JAX's import to the bit.
- A first GN `TrainStep` against JAX's at the recipe and tolerances of
  tests/test_torch_train_step.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from os2d_tpu.models import os2d as jos2d
from os2d_tpu.models import resnet as jresnet
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.checkpoint import load_checkpoint_file
from os2d_torch.models.from_jax import resnet_state_dict_from_jax, state_dict_from_jax
from os2d_torch.models.os2d import fold_inference_params
from os2d_torch.models.resnet import GroupNorm2d, ResNetC4
from test_torch_checkpoint import (
    ALIGNER,
    FOREIGN,
    _random_like,
    _tensors,
    aligner_weights,
)
from test_torch_grid_path import check_first_step, first_step
from test_torch_numeric_modes import BF16, F32, _jax_stem, _torch, assert_bf16_rule

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small torch ops: with one intra-op thread they do not wait on
    OpenMP barriers when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _norm_params(arch, use_group_norm, seed=0):
    """JAX ResNet-C4 params with the normalizations' weights and biases
    randomized as a trained network's: each block's last normalization
    damps its residual branch (weights 0.05-0.15), so that the residual
    stream of the 23 blocks of ResNet101 stays at the magnitude of real C4
    features (a few units) instead of the ~1e4 that identity normalizations
    over He-initialized convolutions reach."""
    params = _np_tree(jresnet.init_resnet_c4_params(jax.random.PRNGKey(seed), arch,
                                                    use_group_norm))
    rng = np.random.RandomState(seed)

    def randomize(p, lo, hi):
        p["scale"] = rng.uniform(lo, hi, p["scale"].shape).astype(np.float32)
        p["bias"] = (0.1 * rng.randn(*p["bias"].shape)).astype(np.float32)

    randomize(params["bn1"], 0.5, 1.5)
    for layer in ("layer1", "layer2", "layer3"):
        for block in params[layer]:
            for k in ("bn1", "bn2", "downsample_bn"):
                if k in block:
                    randomize(block[k], 0.5, 1.5)
            randomize(block["bn3"], 0.05, 0.15)
    return params


@pytest.mark.parametrize("arch,use_group_norm", [("resnet50", True), ("resnet101", False),
                                                 ("resnet101", True)])
def test_resnet_c4_matches_jax(arch, use_group_norm):
    params = _norm_params(arch, use_group_norm)
    net = ResNetC4(arch, "cpu", use_group_norm=use_group_norm)
    net.load_state_dict(resnet_state_dict_from_jax(params))
    assert len(net.layer3) == {"resnet50": 6, "resnet101": 23}[arch]
    assert isinstance(net.layer3[0].bn1, GroupNorm2d) == use_group_norm
    img = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)
    want = np.asarray(jresnet.resnet_c4_forward(jax.tree_util.tree_map(jnp.asarray, params),
                                                jnp.asarray(img)))
    with torch.no_grad():
        got = net(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 4, 6, 1024)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def gn_params():
    return _np_tree(jos2d.init_os2d_params(
        jax.random.PRNGKey(2), jos2d.Os2dConfig(use_group_norm=True,
                                                merge_branch_parameters=False)))


def test_from_jax_group_norm_slots(gn_params):
    sd = state_dict_from_jax(gn_params)
    model = Os2dModel(Os2dConfig(use_group_norm=True, merge_branch_parameters=False),
                      device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    assert not any("running" in k for k in sd if "backbone" in k)
    np.testing.assert_array_equal(sd["label_backbone.layer2.1.bn2.weight"].numpy(),
                                  gn_params["label_backbone"]["layer2"][1]["bn2"]["scale"])
    np.testing.assert_array_equal(sd["backbone.bn1.bias"].numpy(),
                                  gn_params["backbone"]["bn1"]["bias"])
    # a fresh GN model starts from the identity GroupNorm
    assert torch.equal(model.backbone.layer1[0].bn3.weight, sd["backbone.layer1.0.bn3.weight"])
    fresh = Os2dModel(Os2dConfig(use_group_norm=True), device="cpu")
    assert (fresh.backbone.bn1.weight == 1).all() and (fresh.backbone.bn1.bias == 0).all()


def test_fold_leaves_group_norm_and_matches_jax(gn_params):
    model = Os2dModel(Os2dConfig(use_group_norm=True, merge_branch_parameters=False),
                      device="cpu")
    model.load_state_dict(state_dict_from_jax(gn_params))
    got = fold_inference_params(model).state_dict()
    want = state_dict_from_jax(_np_tree(jos2d.fold_inference_params(gn_params)))
    assert set(got) == set(want)
    assert not any(k.endswith("folded_bias") for k in want if "backbone" in k)
    for name in want:
        if "backbone" in name:  # GN and its convolutions pass through unchanged
            assert torch.equal(got[name], model.state_dict()[name]), name
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want[name].abs().max()), err_msg=name)


def test_bf16_group_norm_backbone_rounds_as_jax():
    params = _norm_params("resnet50", True, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    net = ResNetC4("resnet50", "cpu", torch.bfloat16, use_group_norm=True)
    net.load_state_dict(resnet_state_dict_from_jax(params))
    img = np.random.RandomState(4).randn(2, 64, 96, 3).astype(np.float32)
    x = jnp.asarray(img)
    want16, want32 = _jax_stem(jp, x, BF16), _jax_stem(jp, x, F32)
    with torch.no_grad():
        got = net.stem(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert_bf16_rule(got.permute(0, 2, 3, 1), want16, want32, "stem")
    strides = [1] * 3 + [2] + [1] * 3 + [2] + [1] * 5
    jblocks = jp["layer1"] + jp["layer2"] + jp["layer3"]
    for i, (block, p, stride) in enumerate(zip(net.blocks(), jblocks, strides)):
        x = want16
        want16 = jresnet._bottleneck(x, p, stride, BF16)
        want32 = jresnet._bottleneck(x.astype(F32), p, stride, F32)
        with torch.no_grad():
            got = block(_torch(x).permute(0, 3, 1, 2), torch.bfloat16)
        assert_bf16_rule(got.permute(0, 2, 3, 1), want16, want32, f"block {i}")
    assert str(want16.dtype) == "float32"  # GN's output is fp32


def _gn_resnet_weights(seed):
    shapes = {k: tuple(v.shape) for k, v in ResNetC4(
        "resnet50", torch.device("meta"), use_group_norm=True).state_dict().items()}
    return _random_like(shapes, seed)


def _gn_payload(branch, merge):
    """Checkpoints of a GN model in the reference's layouts."""
    if branch in ("net", "state_dict"):
        sd = {"net_feature_maps." + k: v for k, v in _gn_resnet_weights(1).items()}
        sd.update({ALIGNER + k: v for k, v in aligner_weights(2).items()})
        if not merge:
            sd.update({"net_label_features.net_class_features." + k: v
                       for k, v in _gn_resnet_weights(3).items()})
        return {"net": _tensors(sd)} if branch == "net" else _tensors(sd)
    if branch == "weakalign":
        prefixes = {"conv1.": "0.", "bn1.": "1.", "layer1.": "4.", "layer2.": "5.",
                    "layer3.": "6."}
        sd = {}
        for k, v in _gn_resnet_weights(4).items():
            p = next(p for p in prefixes if k.startswith(p))
            sd["FeatureExtraction.model." + prefixes[p] + k[len(p):]] = v
        for k, v in aligner_weights(5).items():
            sd["FeatureRegression." + k] = v.reshape(v.shape[0], -1) if k == "linear.weight" else v
        return {"state_dict": _tensors(sd)}
    sd = _gn_resnet_weights(6)
    if branch == "backbone_torchvision":
        return _tensors(sd)
    # a caffe2 GroupNorm dump, numeric prefixes (converters.convert_caffe2_cirtorch)
    prefixes = FOREIGN["caffe2_cirtorch"]
    return _tensors({prefixes[p] + k[len(p):]: v for k, v in sd.items()
                     for p in prefixes if k.startswith(p)})


@pytest.mark.parametrize("merge", [True, False], ids=["merged", "separate"])
@pytest.mark.parametrize("branch", ["net", "state_dict", "weakalign", "backbone_torchvision",
                                    "backbone_caffe2_groupnorm"])
def test_group_norm_cascade_matches_jax(branch, merge, tmp_path):
    path = str(tmp_path / f"{branch}.pth")
    torch.save(_gn_payload(branch, merge), path)
    jconfig = jos2d.Os2dConfig(use_group_norm=True, merge_branch_parameters=merge)
    params = _np_tree(jos2d.init_os2d_params(jax.random.PRNGKey(0), jconfig))
    want_params, _ = jos2d.load_checkpoint_file(path, jconfig, params=params)
    want = state_dict_from_jax(_np_tree(want_params))

    config = Os2dConfig(use_group_norm=True, merge_branch_parameters=merge)
    model = Os2dModel(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    sd, _ = load_checkpoint_file(path, config, model)
    model.load_state_dict(sd)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_group_norm_first_step_matches_jax(tmp_path):
    """From JAX's GN init with the backbone's normalizations as
    `_norm_params` sets them. At the init itself (GN weights 1, biases 0
    over He-initialized convolutions) the step's gradient is ill-conditioned
    in fp32: two fp32 GroupNorm formulas of the port (F.group_norm and JAX's
    two-pass one) give layer1's GN gradients 8e-3 apart, and JAX's own
    gradient norm moves by 7.7e-5 between its jitted and op-by-op runs, so
    no fp32 implementation meets rtol 1e-4 there; with damped residual
    branches the two packages' gradient norms agree to ~3e-6."""

    def prepare(params):
        backbone = _norm_params("resnet50", True, seed=5)
        return dict(params, backbone=jax.tree_util.tree_map(jnp.asarray, backbone))

    check_first_step(*first_step(tmp_path, prepare=prepare, use_group_norm=True),
                     moved=("backbone.bn1.weight", "backbone.layer3.5.bn3.bias",
                            "transform_net.linear.weight"))
