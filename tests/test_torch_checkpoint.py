"""The checkpoint cascade of the port (`os2d_torch.models.checkpoint`) against
the JAX package's (`os2d_tpu.models.os2d.load_checkpoint_file`) at full width
(ResNet50-C4, 1024 channels).

Files are written with torch.save to tmp_path from seeded numpy weights in
the reference's key layout (`num_batches_tracked` included, and a layer4
key that neither package reads). Each branch of the cascade loads through
both packages; the JAX params, converted with `state_dict_from_jax`, must
equal the port model's state_dict() bit for bit, since the import is copies
only. Branches that keep weights the file lacks (weakalign, a backbone
alone) start both packages from the same params. Then the converters on
synthetic dicts, the errors, the port's own `.pth`, and a JAX `.pkl` with an
optax state that loads in a process which never imports jax or optax.
"""

import copy
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import optax

from os2d_tpu.models import converters as jconverters
from os2d_tpu.models import os2d as jos2d
from os2d_tpu.utils import logger as jlogger
from os2d_torch.models import Os2dConfig, Os2dModel, converters
from os2d_torch.models.checkpoint import load_checkpoint_file, load_jax_checkpoint
from os2d_torch.models.from_jax import state_dict_from_jax
from os2d_torch.models.resnet import ResNetC4
from os2d_torch.models.transform_net import TransformNet
from os2d_torch.utils.logger import checkpoint_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIGNER = "os2d_head_creator.aligner.parameter_regressor."
TN_NAMES = {"conv0": "conv.0", "bn0": "conv.1", "conv1": "conv.3", "bn1": "conv.4",
            "linear": "linear"}
# the foreign backbone layouts of models/converters.py: the torchvision name
# prefix -> each layout's
FOREIGN = {
    "caffe2_cirtorch": {"conv1.": "0.", "bn1.": "1.", "layer1.": "4.", "layer2.": "5.",
                        "layer3.": "6."},
    "cirtorch": {"conv1.": "features.0.", "bn1.": "features.1.", "layer1.": "features.4.",
                 "layer2.": "features.5.", "layer3.": "features.6."},
    "maskrcnn": {"conv1.": "module.backbone.body.stem.conv1.",
                 "bn1.": "module.backbone.body.stem.bn1.",
                 **{f"layer{i}.": f"module.backbone.body.layer{i}." for i in (1, 2, 3)}},
}


def _random_like(shapes, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        v = rng.standard_normal(shape, dtype=np.float32)
        out[k] = np.abs(v) + 0.5 if k.endswith("running_var") else v
    return out


def _with_counters(sd):
    """Adds a num_batches_tracked entry beside every BatchNorm."""
    out = dict(sd)
    for k in sd:
        if k.endswith(".running_var"):
            out[k[: -len("running_var")] + "num_batches_tracked"] = np.array(7, np.int64)
    return out


def _tensors(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _seeded_resnet_weights(seed):
    shapes = {k: tuple(v.shape) for k, v in ResNetC4("resnet50", torch.device("meta"))
              .state_dict().items()}
    return _with_counters(_random_like(shapes, seed))


def resnet_weights(seed):
    """torchvision-named ResNet50-C4 weights (seeded numpy) with BN counters;
    drawn once per seed, a new dict each call."""
    return dict(_seeded_resnet_weights(seed))


@functools.lru_cache(maxsize=None)
def _seeded_aligner_weights(seed):
    shapes = {}
    for k, v in TransformNet(6, torch.device("meta")).state_dict().items():
        module, field = k.split(".", 1)
        shapes[f"{TN_NAMES[module]}.{field}"] = tuple(v.shape)
    return _with_counters(_random_like(shapes, seed))


def aligner_weights(seed):
    """The reference TransformationNet's weights (conv.0 ... linear); drawn
    once per seed, a new dict each call."""
    return dict(_seeded_aligner_weights(seed))


def reference_net(merge):
    """A reference Os2dModel state_dict."""
    sd = {"net_feature_maps." + k: v for k, v in resnet_weights(1).items()}
    sd["net_feature_maps.layer4.0.conv1.weight"] = np.ones((2, 2, 1, 1), np.float32)
    sd.update({ALIGNER + k: v for k, v in aligner_weights(2).items()})
    if not merge:
        sd.update({"net_label_features.net_class_features." + k: v
                   for k, v in resnet_weights(3).items()})
    return _tensors(sd)


def weakalign_state_dict(whole=True):
    """A weakalign state_dict; not whole: its FeatureExtraction stops after
    layer1."""
    prefixes = {"conv1.": "FeatureExtraction.model.0.", "bn1.": "FeatureExtraction.model.1.",
                "layer1.": "FeatureExtraction.model.4.", "layer2.": "FeatureExtraction.model.5.",
                "layer3.": "FeatureExtraction.model.6."}
    sd = {}
    for k, v in resnet_weights(4).items():
        p = next(p for p in prefixes if k.startswith(p))
        if whole or p in ("conv1.", "bn1.", "layer1."):
            sd[prefixes[p] + k[len(p):]] = v
    for k, v in aligner_weights(5).items():
        if k == "linear.weight":
            v = v.reshape(v.shape[0], -1)  # weakalign's Linear(64*5*5, 6)
        sd["FeatureRegression." + k] = v
    return _tensors(sd)


def backbone_file(layout):
    sd = resnet_weights(6)
    sd["fc.weight"] = np.ones((3, 2), np.float32)
    if layout == "torchvision":
        return _tensors(sd)
    prefixes = FOREIGN[layout]
    renamed = {}
    for k, v in sd.items():
        p = next((p for p in prefixes if k.startswith(p)), None)
        if p is not None:
            renamed[prefixes[p] + k[len(p):]] = v
    renamed = _tensors(renamed)
    return {"cirtorch": {"state_dict": renamed, "meta": {"architecture": "resnet50"}},
            "maskrcnn": {"model": renamed, "iteration": 3}}.get(layout, renamed)


def checkpoint_payload(branch, merge):
    if branch == "net":
        return {"net": reference_net(merge)}
    if branch == "net_optimizer":
        return {"net": reference_net(merge),
                "optimizer": {"state": {0: {"momentum_buffer": torch.ones(3)}},
                              "param_groups": [{"lr": 0.01, "params": [0]}]}}
    if branch == "weakalign":
        return {"state_dict": weakalign_state_dict()}
    if branch == "weakalign_partial":
        return {"state_dict": weakalign_state_dict(whole=False)}
    if branch == "nested_state_dict":
        return {"state_dict": reference_net(merge)}
    if branch == "nested_model":
        return {"model": reference_net(merge), "iteration": 5}
    if branch == "state_dict":
        return reference_net(merge)
    return backbone_file(branch.removeprefix("backbone_"))


BRANCHES = ["net", "net_optimizer", "weakalign", "weakalign_partial", "nested_state_dict",
            "nested_model", "state_dict", "backbone_torchvision", "backbone_caffe2_cirtorch",
            "backbone_cirtorch", "backbone_maskrcnn"]


@pytest.fixture(scope="module")
def start_params():
    """The JAX params that partial checkpoints keep, for both branch
    layouts, with a random final aligner layer."""
    out = {}
    for merge in (True, False):
        params = jos2d.init_os2d_params(
            jax.random.PRNGKey(0), jos2d.Os2dConfig(merge_branch_parameters=merge))
        params = jax.tree_util.tree_map(np.asarray, params)
        rng = np.random.RandomState(0)
        lin = params["transform_net"]["linear"]
        lin["w"] = (0.02 * rng.randn(*lin["w"].shape)).astype(np.float32)
        out[merge] = params
    return out


@pytest.fixture(scope="module")
def start_models(start_params):
    """Port models holding the start params, copied by each test."""
    models = {}
    for merge, params in start_params.items():
        models[merge] = Os2dModel(Os2dConfig(merge_branch_parameters=merge), device="cpu")
        models[merge].load_state_dict(state_dict_from_jax(params))
    return models


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("merge", [True, False], ids=["merged", "separate"])
@pytest.mark.parametrize("branch", BRANCHES)
def test_cascade_matches_jax(branch, merge, start_params, start_models, tmp_path):
    path = str(tmp_path / f"{branch}.pth")
    torch.save(checkpoint_payload(branch, merge), path)
    params = start_params[merge]

    want_params, want_opt = jos2d.load_checkpoint_file(
        path, jos2d.Os2dConfig(merge_branch_parameters=merge), params=params)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want_params))

    config = Os2dConfig(merge_branch_parameters=merge)
    model = copy.deepcopy(start_models[merge])
    sd, opt = load_checkpoint_file(path, config, model)
    model.load_state_dict(sd)
    _assert_state_equal(model.state_dict(), want)
    if branch == "net_optimizer":
        assert torch.equal(opt["state"][0]["momentum_buffer"],
                           want_opt["state"][0]["momentum_buffer"])
        assert opt["param_groups"] == want_opt["param_groups"]
    else:
        assert opt is None and want_opt is None
    if branch == "weakalign_partial":  # the backbone was kept, the aligner replaced
        start = start_models[merge].state_dict()
        assert torch.equal(sd["backbone.layer3.5.conv3.weight"],
                           start["backbone.layer3.5.conv3.weight"])
        assert not torch.equal(sd["transform_net.linear.weight"],
                               start["transform_net.linear.weight"])


def _missing(payload, key):
    payload = dict(payload)
    del payload[key]
    return payload


ERROR_CASES = {
    # a reference "net" without one of the aligner's BatchNorms
    "net_missing_key": lambda: {"net": _missing(reference_net(True), ALIGNER + "conv.1.weight")},
    # a weakalign regressor without its second convolution
    "weakalign_missing_regressor": lambda: {"state_dict": _missing(
        weakalign_state_dict(), "FeatureRegression.conv.3.weight")},
    # a torchvision backbone without its last block
    "backbone_missing_block": lambda: {k: v for k, v in backbone_file("torchvision").items()
                                       if not k.startswith("layer3.5.")},
    "backbone_unknown_layout": lambda: {"encoder.weight": torch.ones(2)},
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_match_jax(case, start_params, start_models, tmp_path):
    path = str(tmp_path / f"{case}.pth")
    torch.save(ERROR_CASES[case](), path)
    with pytest.raises((KeyError, ValueError)) as jax_error:
        jos2d.load_checkpoint_file(path, jos2d.Os2dConfig(), params=start_params[True])
    with pytest.raises(jax_error.type):
        load_checkpoint_file(path, Os2dConfig(), copy.deepcopy(start_models[True]))


CONVERTERS = ["convert_caffe2_cirtorch", "convert_cirtorch", "convert_maskrcnn_benchmark",
              "convert_any_backbone"]


@pytest.mark.parametrize("name", CONVERTERS)
def test_converter_matches_jax(name):
    small = {k: v[..., :1] if v.ndim else v for k, v in resnet_weights(7).items()
             if k.startswith(("conv1", "bn1", "layer1.0"))}
    layout = {"convert_caffe2_cirtorch": "caffe2_cirtorch", "convert_cirtorch": "cirtorch",
              "convert_maskrcnn_benchmark": "maskrcnn", "convert_any_backbone": "maskrcnn"}[name]
    prefixes = FOREIGN[layout]
    sd = {}
    for k, v in small.items():
        p = next(p for p in prefixes if k.startswith(p))
        sd[prefixes[p] + k[len(p):]] = torch.from_numpy(np.asarray(v))
    sd["unmatched.weight"] = torch.zeros(1)
    arg = {"convert_cirtorch": {"state_dict": sd}, "convert_maskrcnn_benchmark": {"model": sd},
           "convert_any_backbone": {"model": sd}}.get(name, sd)
    got = getattr(converters, name)(arg)
    want = getattr(jconverters, name)(arg)
    assert list(got) == list(want)
    assert not any(k.endswith("num_batches_tracked") for k in got)
    for k in want:
        assert np.array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        getattr(jconverters, name)({"other.weight": torch.zeros(1)})
    with pytest.raises(ValueError):
        getattr(converters, name)({"other.weight": torch.zeros(1)})


def test_rename_by_prefix_matches_jax():
    sd = {"0.weight": np.ones(2), "1.num_batches_tracked": np.array(1), "9.x": np.zeros(1)}
    got = converters._rename_by_prefix(sd, converters.CAFFE2_CIRTORCH_PREFIX_MAP)
    want = jconverters._rename_by_prefix(sd, jconverters.CAFFE2_CIRTORCH_PREFIX_MAP)
    assert list(got[0]) == list(want[0]) == ["conv1.weight"]
    assert got[1] == want[1] == ["9.x"]


def test_port_checkpoint_round_trips(tmp_path):
    model = Os2dModel(Os2dConfig(), device="cpu", seed=3).train_mode(True)
    params = list(model.parameters())[:4]
    optimizer = torch.optim.SGD(params, lr=0.1, momentum=0.9)
    sum(p.sum() for p in params).backward()
    optimizer.step()
    path = checkpoint_model(model, optimizer, str(tmp_path), i_iter=12)
    loaded = Os2dModel(Os2dConfig(), device="cpu", seed=4)
    sd, opt = load_checkpoint_file(path, Os2dConfig(), loaded)
    loaded.load_state_dict(sd)
    _assert_state_equal(loaded.state_dict(), model.state_dict())
    want = optimizer.state_dict()
    assert opt["param_groups"] == want["param_groups"]
    for k, v in want["state"].items():
        assert torch.equal(opt["state"][k]["momentum_buffer"], v["momentum_buffer"])


LOAD_WITHOUT_JAX = """
import sys
import torch
from os2d_torch.models import Os2dConfig
from os2d_torch.models.checkpoint import load_checkpoint_file
sd, opt = load_checkpoint_file(sys.argv[1], Os2dConfig())
assert opt is None
torch.save(sd, sys.argv[2])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax"))
assert not bad, bad
"""


def test_jax_pkl_loads_in_a_process_without_jax(start_params, tmp_path):
    params = start_params[True]
    opt_state = optax.sgd(0.01, momentum=0.9).init(params)
    path = jlogger.checkpoint_model(params, opt_state, str(tmp_path), model_name="best")
    with open(path, "rb") as f:
        assert b"optax" in f.read()  # a plain pickle.load would import it
    out = str(tmp_path / "sd.pth")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", LOAD_WITHOUT_JAX, path, out], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    model = Os2dModel(Os2dConfig(), device="cpu")
    model.load_state_dict(torch.load(out, weights_only=True))
    _assert_state_equal(model.state_dict(), state_dict_from_jax(params))
    # the optimizer entry loaded as inert placeholders of optax's classes
    payload = load_jax_checkpoint(path)
    assert {type(s).__name__ for s in payload["optimizer"]} >= {"TraceState"}


class _Shell:
    def __reduce__(self):
        return (os.system, ("echo ran > ran.txt",))


def test_jax_pkl_imports_and_runs_nothing_foreign(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"net": {"w": _Shell()}}))
    with pytest.raises(ValueError, match="posix.system|os.system"):
        load_jax_checkpoint(str(path))
    assert not (tmp_path / "ran.txt").exists()
    path.write_bytes(pickle.dumps({"net": None, "optimizer": None, "orbax_dir": "/x.orbax"}))
    with pytest.raises(NotImplementedError, match="orbax"):
        load_checkpoint_file(str(path), Os2dConfig())
