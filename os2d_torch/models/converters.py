"""Foreign checkpoint converters -> torchvision-style state dicts: the
port's copy of `os2d_tpu/models/converters.py` (numpy only).

Ports of the reference's weight-surgery scripts (models/convert_*.py):
  - caffe2-cirtorch dumps: numeric prefixes 0./1./4./5./6./7.
    (convert_resnet_caffe2_cirtorch_to_pytorch.py:8-49)
  - cirtorch checkpoints: features.N. prefixes under "state_dict"
    (convert_resnet_cirtorch_to_pytorch.py)
  - maskrcnn-benchmark backbones: module.backbone.body.* under "model"
    (convert_resnet_maskrcnnbenchmark_to_pytorch.py)
  - GroupNorm caffe2 dumps (convert_resnet_caffe2_groupnorm_to_pytorch.py)

Each converter returns a torchvision-named state dict (numpy values), the
key layout of `models.resnet.ResNetC4`, so any of the reference's published
backbone inits loads into the port's backbone (`models.checkpoint`).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

CAFFE2_CIRTORCH_PREFIX_MAP = OrderedDict(
    [
        ("0.", "conv1."),
        ("1.", "bn1."),
        ("4.", "layer1."),
        ("5.", "layer2."),
        ("6.", "layer3."),
        ("7.", "layer4."),
    ]
)

CIRTORCH_PREFIX_MAP = OrderedDict(
    [
        ("features.0.", "conv1."),
        ("features.1.", "bn1."),
        ("features.4.", "layer1."),
        ("features.5.", "layer2."),
        ("features.6.", "layer3."),
        ("features.7.", "layer4."),
    ]
)

MASKRCNN_PREFIX_MAP = OrderedDict(
    [
        ("module.backbone.body.stem.conv1.", "conv1."),
        ("module.backbone.body.stem.bn1.", "bn1."),
        ("module.backbone.body.layer1.", "layer1."),
        ("module.backbone.body.layer2.", "layer2."),
        ("module.backbone.body.layer3.", "layer3."),
        ("module.backbone.body.layer4.", "layer4."),
    ]
)


def _rename_by_prefix(state_dict, prefix_map, strict=True):
    out = OrderedDict()
    skipped = []
    for k, v in state_dict.items():
        match = None
        for p in prefix_map:
            if k.startswith(p):
                match = p
                break
        if match is None:
            skipped.append(k)
            continue
        if k.endswith("num_batches_tracked"):
            continue
        out[prefix_map[match] + k[len(match):]] = np.asarray(v)
    if strict and not out:
        raise ValueError(f"no keys matched the prefix map; got {list(state_dict)[:5]}")
    return out, skipped


def convert_caffe2_cirtorch(state_dict):
    """Caffe2-cirtorch ResNet dump -> torchvision names."""
    out, _ = _rename_by_prefix(state_dict, CAFFE2_CIRTORCH_PREFIX_MAP)
    return out


def convert_cirtorch(checkpoint):
    """cirtorch checkpoint (has 'state_dict' with features.N. names)."""
    sd = checkpoint["state_dict"] if "state_dict" in checkpoint else checkpoint
    out, _ = _rename_by_prefix(sd, CIRTORCH_PREFIX_MAP)
    return out


def convert_maskrcnn_benchmark(checkpoint):
    """maskrcnn-benchmark checkpoint (has 'model' with module.backbone.body.*)."""
    sd = checkpoint["model"] if "model" in checkpoint else checkpoint
    out, _ = _rename_by_prefix(sd, MASKRCNN_PREFIX_MAP)
    return out


def convert_any_backbone(obj):
    """Heuristic dispatch over all known foreign formats."""
    sd = obj
    for key in ("model", "state_dict", "net"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    keys = list(sd.keys())
    if any(k.startswith("module.backbone.body.") for k in keys):
        return convert_maskrcnn_benchmark({"model": sd})
    if any(k.startswith("features.") for k in keys):
        return convert_cirtorch({"state_dict": sd})
    if any(k.startswith(("0.", "1.", "4.")) for k in keys):
        return convert_caffe2_cirtorch(sd)
    if any(k.startswith(("conv1.", "layer1.")) for k in keys):
        return OrderedDict(
            (k, np.asarray(v))
            for k, v in sd.items()
            if not k.endswith("num_batches_tracked")
        )
    raise ValueError(f"unrecognized backbone checkpoint format; keys: {keys[:5]}")


def main():  # pragma: no cover - CLI convenience
    import argparse
    import pickle

    import torch

    parser = argparse.ArgumentParser(
        description="Convert foreign ResNet checkpoints to torchvision names"
    )
    parser.add_argument("model", help="Path to the checkpoint to convert")
    args = parser.parse_args()
    # run by hand on a file its user chose: foreign training checkpoints may
    # pickle objects beyond tensors (a scheduler, numpy metadata), which
    # weights_only=True refuses
    obj = torch.load(args.model, map_location="cpu", weights_only=False)
    converted = convert_any_backbone(obj)
    import os

    base, ext = os.path.splitext(args.model)
    target = base + "-converted.pkl"
    with open(target, "wb") as f:
        pickle.dump(converted, f)
    print(f"Converted {len(converted)} tensors -> {target}")


if __name__ == "__main__":  # pragma: no cover
    main()
