"""The port's eval numeric modes against the JAX package's on the CPU: BN
folding (`fold_inference_params`, cfg.tpu.fold_bn) and bfloat16 compute
(`Os2dConfig.compute_dtype="bfloat16"`), at the sizes of tests/test_bn_fold.py
(full-width ResNet50-C4 on a 64x96 image, BatchNorm statistics randomized,
a non-zero final TransformNet layer), numpy-seeded inputs, the JAX params
converted through `models/from_jax.py`.

fp32 folded against folded: within the tolerances of tests/test_bn_fold.py
(backbone rtol 1e-3 / atol 5e-3, TransformNet 2e-4 / 2e-4, head cls 1e-3 /
1e-3, loc 1e-3 / 2e-3).

bfloat16, the bf16 rule: on the same inputs,
    RMS(port_bf16 - jax_bf16) <= 0.25 * RMS(jax_bf16 - jax_fp32),
i.e. the port rounds where JAX rounds (a port that stayed fp32 sits at 1).
Two bf16 computations that differ in a single rounding decorrelate their
rounding noise downstream: in JAX itself, one bf16 ulp on 0.1% of the input
pixels moves the bf16 C4 features by 0.91-1.00 of RMS(bf16 - fp32) (fp32
moves 100x less), and a bf16 convolution here and in XLA flips about 1e-4
of its roundings by summation order. So the rule is applied stage by stage
on JAX's own inputs (the stem and each of the 13 bottlenecks, the class
bank, the head), where it holds with room; every intermediate's dtype is
asserted equal to JAX's. The end-to-end outputs (mAP of `evaluate()`, one
TrainStep's losses and gradient norm) are held to JAX by the measures their
tests state.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from os2d_tpu.config import get_default_cfg as jax_default_cfg
from os2d_tpu.data.dataloader import DataloaderOneShotDetection as JaxLoader
from os2d_tpu.data.dataloader import build_train_dataloader_from_config as jax_build
from os2d_tpu.data.dataset import DatasetOneShotDetection as JaxDataset
from os2d_tpu.engine import evaluate as jeval
from os2d_tpu.engine.objective import ObjectiveConfig as JaxObjectiveConfig
from os2d_tpu.engine.optimization import create_optimizer as jax_create_optimizer
from os2d_tpu.engine.train import TrainStep as JaxTrainStep
from os2d_tpu.engine.train import build_trainable_mask as jax_trainable_mask
from os2d_tpu.engine.train import prepare_batch_arrays as jax_prepare
from os2d_tpu.models import head as jhead
from os2d_tpu.models import os2d as jos2d
from os2d_tpu.models import resnet as jresnet
from os2d_tpu.models import transform_net as jtn
from os2d_torch.config import get_default_cfg
from os2d_torch.data.dataloader import DataloaderOneShotDetection
from os2d_torch.data.dataset import DatasetOneShotDetection
from os2d_torch.engine import evaluate as teval
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models import head as thead
from os2d_torch.models.os2d import fold_inference_params
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.ops import resample_grad
from test_bn_fold import _randomize_bn_stats
from test_end_to_end_eval import IMG_W, make_synthetic_dataset
from test_torch_train_data import train_cfg
from test_train import make_dataset

BF16_RULE = 0.25
BF16, F32 = jnp.bfloat16, jnp.float32
MODES = ["unfolded", "folded"]


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


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def _np(x):
    """A torch tensor or JAX array as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(F32))


def _torch(x):
    """A JAX array as a torch tensor of the same dtype (bf16 values exactly)."""
    t = torch.from_numpy(np.asarray(jnp.asarray(x).astype(F32)).copy())
    return t.to(torch.bfloat16) if x.dtype == BF16 else t


def _dtype_name(x):
    return str(x.dtype).removeprefix("torch.")


def assert_bf16_rule(got, want_bf16, want_fp32, what):
    """The port's bf16 output against JAX's, by the bf16 rule; the dtypes
    must be equal."""
    assert _dtype_name(got) == str(want_bf16.dtype), (what, got.dtype, want_bf16.dtype)
    diff = _rms(_np(got) - _np(want_bf16))
    scale = _rms(_np(want_bf16) - _np(want_fp32))
    assert scale > 0, f"{what}: bf16 and fp32 agree exactly, the rule holds nothing"
    assert diff <= BF16_RULE * scale, (what, diff / scale, diff, scale)


@pytest.fixture(scope="module")
def jparams():
    rng = np.random.RandomState(3)
    params = _randomize_bn_stats(jos2d.init_os2d_params(jax.random.PRNGKey(3),
                                                        jos2d.Os2dConfig()), rng)
    params["transform_net"]["linear"]["w"] = jnp.asarray(
        rng.randn(5, 5, 64, 6).astype(np.float32) * 0.05)
    return {"unfolded": params, "folded": jos2d.fold_inference_params(params)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(4)
    # two images, the scenes and (their C4 features) the two classes
    return {"images": rng.randn(2, 64, 96, 3).astype(np.float32),
            "corr": rng.randn(1, 6, 8, 225).astype(np.float32)}


def _port_model(jparams, mode, compute_dtype="float32"):
    model = Os2dModel(Os2dConfig(compute_dtype=compute_dtype, resample_precision="highest"),
                      device="cpu")
    model.load_state_dict(state_dict_from_jax(_np_tree(jparams["unfolded"])))
    return fold_inference_params(model) if mode == "folded" else model


def test_fold_of_converted_weights_matches_jax_fold(jparams):
    """Folding the converted weights gives JAX's folded params converted
    through the bridge, which load into a folded model one to one."""
    unfolded = _port_model(jparams, "unfolded")
    folded = fold_inference_params(unfolded)
    got = folded.state_dict()
    want = state_dict_from_jax(_np_tree(jparams["folded"]))
    assert set(got) == set(want)
    assert any(k.endswith(".folded_bias") for k in want)
    assert not any(k.startswith("transform_net.bn") for k in want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want[name].abs().max()), err_msg=name)
    # the caller's model is left unfolded, and the bridge loads strictly
    assert "backbone.bn1.running_var" in unfolded.state_dict()
    fold_inference_params(Os2dModel(Os2dConfig(), device="cpu")).load_state_dict(want)


def test_folded_fp32_matches_jax(jparams, inputs):
    """fp32 folded against folded: backbone, TransformNet and head_forward."""
    jp = jparams["folded"]
    model = _port_model(jparams, "folded")
    img = inputs["images"]
    with torch.no_grad():
        fm = model.extract_features(torch.from_numpy(img))
        want_fm = jresnet.resnet_c4_forward(jp["backbone"], jnp.asarray(img))
        np.testing.assert_allclose(fm.numpy(), np.asarray(want_fm), rtol=1e-3, atol=5e-3)

        corr = inputs["corr"]
        np.testing.assert_allclose(
            model.transform_net(torch.from_numpy(corr)).numpy(),
            np.asarray(jtn.transform_net_forward(jp["transform_net"], jnp.asarray(corr))),
            rtol=2e-4, atol=2e-4)

        out = model.apply_head(fm, thead.build_class_head(fm))
    want = jhead.head_forward(jp["transform_net"], want_fm, jhead.build_class_head(want_fm),
                              resample_precision="highest")
    np.testing.assert_allclose(out["cls"].numpy(), np.asarray(want["cls"]), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out["loc"].numpy(), np.asarray(want["loc"]), rtol=1e-3, atol=2e-3)


def _jax_stem(p, x, dtype):
    return jresnet.resnet_c4_forward(
        {"conv1": p["conv1"], "bn1": p["bn1"], "layer1": [], "layer2": [], "layer3": []}, x,
        dtype)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_backbone_rounds_as_jax(jparams, inputs, mode):
    """Stem and every bottleneck on JAX's own bf16-mode input: the port's
    output dtype is JAX's and its values follow the bf16 rule."""
    jp = jparams[mode]["backbone"]
    backbone = _port_model(jparams, mode, "bfloat16").backbone
    x = jnp.asarray(inputs["images"])
    want16, want32 = _jax_stem(jp, x, BF16), _jax_stem(jp, x, F32)
    with torch.no_grad():
        got = backbone.stem(torch.from_numpy(inputs["images"]).permute(0, 3, 1, 2))
    assert_bf16_rule(got.permute(0, 2, 3, 1), want16, want32, "stem")
    strides = [1] * 3 + [2] + [1] * 3 + [2] + [1] * 5
    jblocks = jp["layer1"] + jp["layer2"] + jp["layer3"]
    for i, (block, p, stride) in enumerate(zip(backbone.blocks(), jblocks, strides)):
        x = want16
        want16 = jresnet._bottleneck(x, p, stride, BF16)
        want32 = jresnet._bottleneck(x.astype(F32), p, stride, F32)
        with torch.no_grad():
            got = block(_torch(x).permute(0, 3, 1, 2), torch.bfloat16)
        assert_bf16_rule(got.permute(0, 2, 3, 1), want16, want32, f"block {i}")
    # folded, the backbone is bf16 end to end; unfolded, BN makes it fp32
    assert str(want16.dtype) == ("bfloat16" if mode == "folded" else "float32")


@pytest.mark.parametrize("mode", MODES)
def test_bf16_class_bank_and_head_round_as_jax(jparams, inputs, mode, monkeypatch):
    """The class bank (resize to 15x15 and L2 norm in the features' dtype,
    the pool mask in it too) and head_forward (bf16 correlation operands
    with an fp32 result, the TransformNet's bf16 convolutions) on JAX's own
    bf16-mode features."""
    jp = jparams[mode]
    model = _port_model(jparams, mode, "bfloat16")
    fm16 = jresnet.resnet_c4_forward(jp["backbone"], jnp.asarray(inputs["images"]), BF16)

    bank16 = jhead.build_class_head(fm16)
    bank32 = jhead.build_class_head(fm16.astype(F32))
    bank = thead.build_class_head(_torch(fm16))
    assert _dtype_name(bank.pool_mask) == str(bank16.pool_mask.dtype)
    np.testing.assert_array_equal(_np(bank.pool_mask), _np(bank16.pool_mask))
    if mode == "folded":
        assert_bf16_rule(bank.class_feats, bank16.class_feats, bank32.class_feats, "class_feats")
    else:  # fp32 features: the fp32 bank
        assert _dtype_name(bank.class_feats) == str(bank16.class_feats.dtype) == "float32"
        np.testing.assert_allclose(_np(bank.class_feats), _np(bank16.class_feats), atol=1e-6)

    seen = []
    forward = resample_grad.FORWARD["highest"]

    def record(corr, px, py, mask_t):
        seen.append((corr.dtype, mask_t.dtype))
        return forward(corr, px, py, mask_t)

    monkeypatch.setitem(resample_grad.FORWARD, "highest", record)
    want16 = jhead.head_forward(jp["transform_net"], fm16, bank16, compute_dtype=BF16,
                                resample_precision="highest")
    want32 = jhead.head_forward(
        jp["transform_net"], fm16.astype(F32),
        jhead.ClassHead(bank16.class_feats.astype(F32), bank16.pool_mask.astype(F32)),
        compute_dtype=F32, resample_precision="highest")
    with torch.no_grad():
        got = model.apply_head(_torch(fm16), thead.ClassHead(_torch(bank16.class_feats),
                                                             _torch(bank16.pool_mask)))
    assert seen == [(torch.float32, torch.float32)]  # the resample takes fp32 corr
    for key in ("cls", "loc", "corners"):
        assert_bf16_rule(got[key], want16[key], want32[key], key)


def test_correlation_gemm_keeps_fp32():
    """bf16 operands, fp32 products and sums: the result equals the exact
    product of the rounded operands to fp32 rounding, far inside bf16's."""
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.randn(n, 64).astype(np.float32)) for n in (30, 20))
    got = thead.correlation_gemm(a, b, torch.bfloat16)
    exact = a.bfloat16().double() @ b.bfloat16().double().T
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-6, atol=1e-5)
    assert float((got - exact.bfloat16().float()).abs().max()) > 1e-3  # not rounded to bf16
    np.testing.assert_array_equal(thead.correlation_gemm(a, b).numpy(), (a @ b.T).numpy())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_prescreen_margin_matches_jax(tier, compute_dtype):
    assert teval.prescreen_margin(tier, compute_dtype) == jeval.prescreen_margin(
        tier, jnp.dtype(compute_dtype))


@pytest.fixture(scope="module")
def planted_loaders(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_numeric"))
    df = make_synthetic_dataset(root)
    kwargs = dict(gt_path=os.path.join(root, "classes", "images"),
                  image_path=os.path.join(root, "src"), name="synth-numeric",
                  image_size=IMG_W, eval_scale=IMG_W, cache_images=True)
    return (JaxLoader(dataset=JaxDataset(df, **kwargs), batch_size=1,
                      pyramid_scales_eval=[1.0], do_augmentation=False),
            DataloaderOneShotDetection(dataset=DatasetOneShotDetection(df, **kwargs),
                                       batch_size=1, pyramid_scales_eval=[1.0]))


def _fold_cfg(cfg):
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.nms_score_threshold = 0.5  # the prescreen runs, with its bf16 margin
    cfg.tpu.fold_bn = True
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    return cfg


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_evaluate_with_fold_bn_matches_jax(planted_loaders, compute_dtype):
    """evaluate() with cfg.tpu.fold_bn on the planted dataset at "highest":
    JAX's mAP@0.50 and recall; the caller's model stays unfolded."""
    jax_loader, loader = planted_loaders
    jconfig = jos2d.Os2dConfig(resample_precision="highest", compute_dtype=compute_dtype)
    params = jos2d.init_os2d_params(jax.random.PRNGKey(0), jconfig)
    want = jeval.evaluate(jax_loader, jos2d.Os2dModel(jconfig), params,
                          _fold_cfg(jax_default_cfg()))
    model = Os2dModel(Os2dConfig(resample_precision="highest", compute_dtype=compute_dtype),
                      device="cpu")
    model.load_state_dict(state_dict_from_jax(_np_tree(params)))
    got = teval.evaluate(loader, model, _fold_cfg(get_default_cfg()))
    assert want["mAP@0.50"] == 1.0
    for key in ("mAP@0.50", "recall@0.50"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert not model.folded and "backbone.bn1.running_var" in model.state_dict()


def test_folded_model_refuses_training(jparams):
    folded = _port_model(jparams, "folded")
    assert folded.folded
    with pytest.raises(ValueError, match="inference only"):
        folded.train_mode(True)
    cfg = train_cfg(get_default_cfg(), augment=False)
    with pytest.raises(ValueError, match="inference only"):
        TrainStep(folded, ObjectiveConfig(), torch.optim.SGD(folded.parameters(), lr=0.1),
                  cfg.train)
    assert not any(p.requires_grad for p in folded.parameters())


@pytest.fixture(scope="module")
def train_batch(tmp_path_factory):
    cfg = train_cfg(jax_default_cfg(), augment=False)
    random.seed(3)
    loader, _ = jax_build(cfg, dataset_train=make_dataset(
        str(tmp_path_factory.mktemp("train_bf16")), np.random.RandomState(0)))
    return loader.get_batch(0)


# One train step runs the whole backbone forward and backward in bf16: its
# scalars carry the decorrelated rounding noise of the module docstring, and
# the port's bf16 step sat 0.38 (gradient norm) to 1.97 (the RLL terms) times
# |jax_bf16 - jax_fp32| from JAX's bf16 step (this test's inputs, measured
# against JAX's fp32 step). The
# step's scalars are therefore held within BF16_STEP_RULE times that
# distance, and must have moved from the port's own fp32 step by at least
# BF16_RULE times it (the step did round); the rounding points themselves
# are held by the stage tests above.
BF16_STEP_RULE = 3.0


def test_train_step_bf16_matches_jax(train_batch):
    """One TrainStep at bf16 from the same weights and batch as JAX's (the
    recipe of tests/test_torch_train_step.py, "highest"): every loss term and
    the gradient norm against JAX's bf16 step, with the port's fp32 step (held
    to JAX's within 1e-4 by tests/test_torch_train_step.py) as the fp32 side;
    parameters stay fp32."""
    params = jos2d.init_os2d_params(jax.random.PRNGKey(1), jos2d.Os2dConfig())
    start = state_dict_from_jax(_np_tree(params))
    jcfg = train_cfg(jax_default_cfg(), augment=False)
    config = jos2d.Os2dConfig(class_image_size=128, resample_precision="highest",
                              compute_dtype="bfloat16")
    optimizer = jax_create_optimizer(jcfg.train.optim, jax_trainable_mask(params, jcfg.train))
    step = JaxTrainStep(config, JaxObjectiveConfig(), optimizer, jcfg.train)
    _, _, want = step(params, optimizer.init(params), *jax_prepare(train_batch))
    want = dict(want.items())

    got = {}
    for dtype in ("float32", "bfloat16"):
        tcfg = train_cfg(get_default_cfg(), augment=False)
        model = Os2dModel(Os2dConfig(class_image_size=128, resample_precision="highest",
                                     compute_dtype=dtype), device="cpu")
        model.load_state_dict(start)
        optimizer = create_optimizer(tcfg.train.optim, trainable_parameters(model, tcfg.train))
        got[dtype] = TrainStep(model, ObjectiveConfig(), optimizer, tcfg.train)(
            *prepare_batch_arrays(train_batch, "cpu"))
        assert all(p.dtype == torch.float32 for p in model.parameters())
    assert set(got["bfloat16"]) == set(want)
    moved = [k for k in want if want[k] != got["float32"][k]]
    assert {"loss", "grad_norm"} <= set(moved)
    for k in moved:
        scale = abs(want[k] - got["float32"][k])
        assert abs(got["bfloat16"][k] - want[k]) <= BF16_STEP_RULE * scale, (k, got, want)
        assert abs(got["bfloat16"][k] - got["float32"][k]) >= BF16_RULE * scale, (k, got, want)
