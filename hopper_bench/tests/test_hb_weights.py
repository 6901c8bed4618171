"""The seed's weights: a BatchNorm configuration's tensors are fixed to the
bit (a digest of the full-size state dict of each configuration file), and
a GroupNorm configuration's norm slots get a weight and a bias only."""

import hashlib
import json

import pytest
import torch

from hopper_bench.harness.weights import make_state_dict, param_specs
from hopper_bench.tests.tiny import ROOT

# sha256 over each tensor of make_state_dict(config, 0, "cpu") in key order:
# its key, its shape and its float32 bytes
DIGESTS = {
    "os2d-v2-r50": "49acefd9a9a815f8bc684950aa9bb38544c76f1319942b1e5bf1481fd651aaab",
    "os2d-v1-r101": "eaa6c36f4927b285ebaaacf0898f02ff42bcafdfda440c6a0b5123b7360d3e26",
}


def config_file(name):
    return json.loads((ROOT / "hopper_bench" / "configs" / f"{name}.json").read_text())


def digest(state):
    h = hashlib.sha256()
    for key, tensor in state.items():
        h.update(key.encode())
        h.update(repr(tuple(tensor.shape)).encode())
        h.update(tensor.to(torch.float32).contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_batchnorm_weights_keep_their_keys_shapes_and_bytes(name):
    config = config_file(name)
    assert digest(make_state_dict(config, 0, "cpu")) == DIGESTS[name]
    assert digest(make_state_dict(dict(config, use_group_norm=False), 0, "cpu")) == DIGESTS[name]


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_group_norm_slots_take_a_weight_and_a_bias(name):
    config = dict(config_file(name), use_group_norm=True)
    specs = {key: (shape, kind) for key, shape, kind, _ in param_specs(config)}
    bn_specs = {key: (shape, kind) for key, shape, kind, _ in param_specs(config_file(name))}
    backbone_norms = [k for k in bn_specs if k.startswith("backbone.") and
                      (".bn" in k or ".downsample.1." in k or k.startswith("backbone.bn1."))]
    # every backbone slot keeps weight and bias with BatchNorm's kinds, and
    # loses its running statistics; everything else is as with BatchNorm
    for key in backbone_norms:
        if key.endswith((".running_mean", ".running_var")):
            assert key not in specs, key
        else:
            assert specs[key] == bn_specs[key], key
    assert {k: v for k, v in bn_specs.items() if k not in backbone_norms} == \
        {k: v for k, v in specs.items() if k not in backbone_norms}
    slots = sum(1 for k in specs if k.startswith("backbone.") and k.endswith(".bias"))
    assert slots == 1 + 3 * sum(config["backbone_blocks"]) + len(config["backbone_blocks"])
    state = make_state_dict(config, 2**31 + 3, "cpu")
    assert list(state) == list(specs)
    lo, hi = config["weights"]["bn_residual_weight"]
    for key, tensor in state.items():
        if key.startswith("backbone.") and key.endswith("bn3.weight"):
            assert lo <= float(tensor.min()) and float(tensor.max()) <= hi, key
