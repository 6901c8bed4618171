"""Weight bridge: the `os2d_tpu` params pytree, given as numpy arrays, ->
the `Os2dModel` state_dict.

Convolutions go from HWIO to OIHW; BatchNorm's scale/bias/mean/var become
weight/bias/running_mean/running_var, and a GroupNorm slot's scale/bias
(no running statistics) weight/bias; the TransformationNet's conv biases map
across; `label_backbone` is read when present (os2d_tpu/models/os2d.py:6-16).
The ImageNet pretrainer's classifier params convert with
`classifier_state_dict_from_jax`. Folded params
(`os2d_tpu.models.os2d.fold_inference_params`) convert too:
a `{"folded_bias": b}` slot becomes `<bn>.folded_bias` and a TransformNet
without "bn*" keys has no bn entries, which is the state_dict of
`os2d_torch.models.os2d.fold_inference_params(model)`.
The leaves must be numpy arrays (call np.asarray on JAX arrays first), so
this package never imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1))))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _bn(sd, prefix: str, p) -> None:
    if "folded_bias" in p:
        sd[prefix + ".folded_bias"] = _vec(p["folded_bias"])
        return
    if set(p) not in ({"scale", "bias", "mean", "var"}, {"scale", "bias"}):
        raise ValueError(
            f"{prefix}: expected frozen BatchNorm (scale/bias/mean/var), GroupNorm "
            f"(scale/bias) or a folded bias, got keys {sorted(p)}")
    sd[prefix + ".weight"] = _vec(p["scale"])
    sd[prefix + ".bias"] = _vec(p["bias"])
    if "mean" in p:
        sd[prefix + ".running_mean"] = _vec(p["mean"])
        sd[prefix + ".running_var"] = _vec(p["var"])


def resnet_state_dict_from_jax(params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """ResNet-C4 params {conv1, bn1, layer1..3: [block dicts]} -> ResNetC4
    keys; a classifier's layer4, when present, maps alike."""
    sd = {prefix + "conv1.weight": _oihw(params["conv1"])}
    _bn(sd, prefix + "bn1", params["bn1"])
    for layer in ("layer1", "layer2", "layer3", "layer4"):
        for bi, block in enumerate(params.get(layer, ())):
            base = f"{prefix}{layer}.{bi}."
            for ci in (1, 2, 3):
                sd[base + f"conv{ci}.weight"] = _oihw(block[f"conv{ci}"])
                _bn(sd, base + f"bn{ci}", block[f"bn{ci}"])
            if "downsample_conv" in block:
                sd[base + "downsample.0.weight"] = _oihw(block["downsample_conv"])
                _bn(sd, base + "downsample.1", block["downsample_bn"])
    return sd


def classifier_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """Full classifier params (`os2d_tpu.models.resnet.
    init_resnet_classifier_params`: the C4 layers, layer4 and fc {w [2048,
    num_classes], b}) -> `ResNetClassifier` keys, fc's weight transposed."""
    sd = resnet_state_dict_from_jax(params)
    sd["fc.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(params["fc"]["w"]).T))
    sd["fc.bias"] = _vec(params["fc"]["b"])
    return sd


def transform_net_state_dict_from_jax(params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """TransformationNet params {conv0, bn0, conv1, bn1, linear} -> TransformNet keys."""
    sd = {}
    for name in ("conv0", "conv1", "linear"):
        sd[f"{prefix}{name}.weight"] = _oihw(params[name]["w"])
        sd[f"{prefix}{name}.bias"] = _vec(params[name]["b"])
    for name in ("bn0", "bn1"):
        if name in params:
            _bn(sd, prefix + name, params[name])
    return sd


def state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """Whole-model params {backbone, [label_backbone], transform_net} ->
    Os2dModel.state_dict() keys."""
    sd = resnet_state_dict_from_jax(params["backbone"], "backbone.")
    if "label_backbone" in params:
        sd.update(resnet_state_dict_from_jax(params["label_backbone"], "label_backbone."))
    sd.update(transform_net_state_dict_from_jax(params["transform_net"], "transform_net."))
    return sd
