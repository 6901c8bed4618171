"""Checkpoint import: counterpart of the cascade of
`os2d_tpu/models/os2d.py:210-331` (the reference loader,
os2d/modeling/model.py:290-426).

Every importer returns a state_dict with the keys of `Os2dModel.state_dict()`
(CPU tensors); `model.load_state_dict(sd)` puts it on the model's device. The
reference layout is OIHW like the port's, so the import is renames and copies
only:

  net_feature_maps.*                               -> backbone.*
  net_label_features.net_class_features.*          -> label_backbone.*
                                                      (merge_branch_parameters=False)
  os2d_head_creator.aligner.parameter_regressor.
    conv.0 / conv.1 (BN) / conv.3 / conv.4 (BN) / linear
                                                   -> transform_net.conv0 / bn0 /
                                                      conv1 / bn1 / linear

Keys the port has no place for (`num_batches_tracked`, layer4, fc) are
dropped; a key the port needs and the file lacks raises KeyError. With
`config.use_group_norm` the backbones' normalizations are GroupNorm(32),
whose keys are `<bn>.weight` and `<bn>.bias` only (the reference's GN
backbones and the converted caffe2 GroupNorm dumps of `models/converters.py`).

`load_checkpoint_file` reads a file through the reference's cascade and the
formats of this repo: the port's own `.pth` (`utils.logger.checkpoint_model`,
told apart by its keys; with either backend, a "dcp_dir" stub read through
torch.distributed.checkpoint), the JAX package's pickled `.pkl`
(`os2d_tpu/utils/logger.py:129-204`) and the torchvision-named backbone that
either package's ImageNet pretrainer exports (`backbone_torchvision.pkl`,
`pretrain/train_imagenet.py`), the two `.pkl`s read without importing what
they pickle beyond numpy (`load_numpy_pickle`). A JAX checkpoint of the
orbax backend ("orbax_dir": an OCDBT tree that only orbax reads) is refused
with the way to convert it.
"""

from __future__ import annotations

import functools
import pickle

import numpy as np
import torch

from ..utils.logger import restore_dcp_stub
from .converters import convert_any_backbone
from .from_jax import state_dict_from_jax
from .resnet import ResNetC4

BACKBONE_PREFIX = "net_feature_maps."
LABEL_BACKBONE_PREFIX = "net_label_features.net_class_features."
ALIGNER_PREFIX = "os2d_head_creator.aligner.parameter_regressor."
# the port's TransformNet modules and the reference's (os2d/modeling/head.py:
# 608-629; the ReLUs at conv.2 and conv.5 hold no weights)
TRANSFORM_NET_MODULES = {"conv0": "conv.0", "bn0": "conv.1", "conv1": "conv.3",
                         "bn1": "conv.4", "linear": "linear"}
BN_FIELDS = ("weight", "bias", "running_mean", "running_var")
PORT_PREFIXES = ("backbone.", "label_backbone.", "transform_net.")


@functools.lru_cache(maxsize=None)
def _resnet_keys(arch: str, use_group_norm: bool):
    return tuple(ResNetC4(arch, torch.device("meta"), use_group_norm=use_group_norm).state_dict())


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(v))


def resnet_state_dict(sd, config, prefix: str = "", target: str = "backbone."):
    """{target + k: sd[prefix + k]} for every key k of the config's
    `ResNetC4` (its arch, BatchNorm or GroupNorm)."""
    keys = _resnet_keys(config.backbone_arch, bool(config.use_group_norm))
    return {target + k: _tensor(sd[prefix + k]) for k in keys}


def transform_net_state_dict(sd, prefix: str = ""):
    """The reference TransformationNet's keys under `prefix` -> the port's
    `transform_net.*` keys."""
    out = {}
    for port, ref in TRANSFORM_NET_MODULES.items():
        for field in (BN_FIELDS if port.startswith("bn") else ("weight", "bias")):
            out[f"transform_net.{port}.{field}"] = _tensor(sd[f"{prefix}{ref}.{field}"])
    return out


def import_os2d_torch_checkpoint(state_dict, config):
    """A reference Os2dModel state_dict (the "net" entry of its checkpoint,
    os2d/utils/logger.py:137-160) -> the port's state_dict
    (os2d_tpu/models/os2d.py:210-232)."""
    sd = resnet_state_dict(state_dict, config, BACKBONE_PREFIX)
    sd.update(transform_net_state_dict(state_dict, ALIGNER_PREFIX))
    if not config.merge_branch_parameters:
        sd.update(resnet_state_dict(state_dict, config, LABEL_BACKBONE_PREFIX,
                                    "label_backbone."))
    return sd


def _current_state_dict(model, config):
    """The weights that a partial checkpoint leaves as they are: `model`'s,
    or a fresh model's from seed 0 (the JAX package's PRNGKey(0) init)."""
    if model is None:
        from .os2d import Os2dModel

        model = Os2dModel(config, device="cpu", seed=0)
    return {k: _tensor(v) for k, v in model.state_dict().items()}


def _with_backbone(sd, backbone, config):
    sd.update(backbone)
    if not config.merge_branch_parameters:
        sd.update({"label_" + k: v for k, v in backbone.items()})
    return sd


def import_weakalign_checkpoint(state_dict, config, model):
    """A weakalign checkpoint's state_dict (os2d/modeling/model.py:389-426;
    os2d_tpu/models/os2d.py:235-281) over `model`'s current weights:
    FeatureExtraction.model.{0,1,4,5,6}.* -> conv1, bn1, layer1-3 of the
    backbone (and of the label backbone when the branches are separate);
    FeatureRegression.* -> the TransformNet, linear.weight reshaped to a
    [-1, 64, 5, 5] convolution. A file that lacks backbone layers keeps the
    model's backbone whole."""
    remap = {"conv1.": "FeatureExtraction.model.0.", "bn1.": "FeatureExtraction.model.1."}
    for layer, src, blocks in (("layer1", 4, 3), ("layer2", 5, 4), ("layer3", 6, 23)):
        for idx in range(blocks):
            remap[f"{layer}.{idx}."] = f"FeatureExtraction.model.{src}.{idx}."
    resnet_sd = {}
    for tgt, src in remap.items():
        for k in state_dict:
            if k.startswith(src):
                resnet_sd[tgt + k[len(src):]] = state_dict[k]
    sd = _current_state_dict(model, config)
    try:
        _with_backbone(sd, resnet_state_dict(resnet_sd, config), config)
    except KeyError:
        pass  # partial init: keep the backbone where weakalign lacks layers

    reg_sd = {}
    for k, v in state_dict.items():
        if k.startswith("FeatureRegression."):
            name = k[len("FeatureRegression."):]
            if name == "linear.weight":
                v = _tensor(v).reshape(-1, 64, 5, 5)  # the conv-ified linear (model.py:426)
            reg_sd[name] = v
    if reg_sd:
        sd.update(transform_net_state_dict(reg_sd))
    return sd


class _Unloaded:
    """Stands for an object of a class that `load_jax_checkpoint` does not
    import (an optax state); it keeps the pickled arguments and state."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs = args, kwargs
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


# the globals a pickled tree of numpy arrays needs (numpy 1 and 2 module
# paths); every other global loads as an _Unloaded placeholder, so no other
# module is imported and no callable runs
_ALLOWED_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("collections", "OrderedDict"),
}


class _NumpyUnpickler(pickle.Unpickler):
    def __init__(self, file):
        super().__init__(file)
        self._placeholders = {}

    def find_class(self, module, name):
        if (module, name) in _ALLOWED_GLOBALS:
            return super().find_class(module, name)
        key = (module, name)
        if key not in self._placeholders:
            self._placeholders[key] = type(name, (_Unloaded,), {"pickled_as": f"{module}.{name}"})
        return self._placeholders[key]


def _check_numpy_tree(tree, where="net"):
    if isinstance(tree, _Unloaded):
        raise ValueError(f"{where} holds a {type(tree).pickled_as}, not numpy arrays")
    if isinstance(tree, dict):
        for k, v in tree.items():
            _check_numpy_tree(v, f"{where}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _check_numpy_tree(v, f"{where}[{i}]")


def load_numpy_pickle(path):
    """A pickle of numpy arrays in containers, loaded with only numpy's array
    types and OrderedDict imported: any other global loads as an inert
    `_Unloaded` placeholder, so no other module is imported and no callable
    runs."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def load_jax_checkpoint(path, payload=None):
    """The payload of a JAX package checkpoint (`os2d_tpu.utils.logger.
    checkpoint_model`, pickle backend): {"net": params of numpy arrays,
    "optimizer", "i_iter", "full_log", ...}, read by `load_numpy_pickle`
    (or taken as `payload`, what it already read): the optax state classes
    of "optimizer" load as placeholders, and "net" must hold none. A payload
    of the orbax backend raises NotImplementedError, which says how to
    convert it."""
    if payload is None:
        payload = load_numpy_pickle(path)
    if not isinstance(payload, dict) or "net" not in payload:
        raise ValueError(f"{path} is not a checkpoint of os2d_tpu.utils.logger")
    if payload.get("orbax_dir"):
        raise NotImplementedError(
            f"{path} stores its trees with orbax in {payload['orbax_dir']}, which os2d_torch "
            "does not read. Convert it under the JAX package: payload = "
            "os2d_tpu.utils.logger.load_checkpoint(path), then os2d_tpu.utils.logger."
            "checkpoint_model(payload['net'], payload['optimizer'], out_dir, ..., "
            "backend='pickle'), and load that .pkl")
    _check_numpy_tree(payload["net"])
    return payload


def load_checkpoint_file(path, config, model=None):
    """Read a checkpoint file -> (state_dict, optimizer state or None)
    (os2d_tpu/models/os2d.py:284-331). The cascade:
      0. a `.pkl`: a JAX package checkpoint, its "net" through
         `from_jax.state_dict_from_jax` (no optimizer state: optax's has no
         counterpart here); or, without "net", a pretrainer's
         torchvision-named backbone export, as in step 4;
      1. a dict with "net" [+ "optimizer"]: the port's own checkpoint
         (`utils.logger.checkpoint_model`, either backend) as it is, or a
         reference one through `import_os2d_torch_checkpoint`;
      2. weakalign ("state_dict" with FeatureExtraction*);
      3. a full reference state_dict, possibly nested in "state_dict" or
         "model";
      4. a backbone alone (torchvision names, or a foreign layout through
         `converters.convert_any_backbone`), the rest of the model kept.
    Steps 2 and 4 keep the weights of `model` where the file has none (the
    JAX package's `params`), or of a fresh seed-0 model when it is None.

    Files are read with torch.load(weights_only=True): the reference's
    checkpoints and backbones hold tensors, numbers, strings and containers.
    """
    if str(path).endswith(".pkl"):
        payload = load_numpy_pickle(path)
        if isinstance(payload, dict) and "net" in payload:
            return state_dict_from_jax(load_jax_checkpoint(path, payload)["net"]), None
        _check_numpy_tree(payload, "the backbone")
        backbone = resnet_state_dict(convert_any_backbone(payload), config)
        return _with_backbone(_current_state_dict(model, config), backbone, config), None
    checkpoint = restore_dcp_stub(torch.load(path, map_location="cpu", weights_only=True), path)
    if isinstance(checkpoint, dict) and "net" in checkpoint:
        net = checkpoint["net"]
        if any(k.startswith(PORT_PREFIXES) for k in net):
            return {k: _tensor(v) for k, v in net.items()}, checkpoint.get("optimizer")
        return import_os2d_torch_checkpoint(net, config), checkpoint.get("optimizer")
    if isinstance(checkpoint, dict) and "state_dict" in checkpoint and any(
            k.startswith("FeatureExtraction") for k in checkpoint["state_dict"]):
        return import_weakalign_checkpoint(checkpoint["state_dict"], config, model), None
    sd = checkpoint
    for nested in ("state_dict", "model"):
        if isinstance(sd, dict) and nested in sd and isinstance(sd[nested], dict):
            sd = sd[nested]
    if any(k.startswith(BACKBONE_PREFIX) for k in sd):
        return import_os2d_torch_checkpoint(sd, config), None

    # a backbone alone (step 4 of the reference cascade)
    backbone = resnet_state_dict(convert_any_backbone(sd), config)
    return _with_backbone(_current_state_dict(model, config), backbone, config), None
