"""The policy of `engine/train_graphs.py` (CUDA graphs of the backbone's
training pass) on the CPU, where no graph is recorded:

- a `TrainStep` on the CPU runs both backbone passes eager, with reason
  "cpu", and captures nothing; with train_features off the reason is
  "detached"; under no_grad it is "no_grad";
- `pass_signature` is the same for the same call, and changes with the
  slot, the input's shape and dtype, the parameters' requires-grad mask and
  their storage;
- on a miss (`BackboneGraphs._miss`, with the capture replaced by a stand-in,
  since a CPU has no graphs): the first sight of a signature runs eager, the
  second captures, a new signature past the bound runs eager, and parameters
  given new storage drop their slot's pairs on the old storage.

On the card, tests/test_torch_train_graphs_card.py holds a graphed step to
the eager step to the bit.
"""

import numpy as np
import pytest
import torch

from os2d_torch.config import get_default_cfg
from os2d_torch.engine import train_graphs
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
from os2d_torch.engine.train_graphs import BackboneGraphs, pass_signature
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.resnet import Conv2d
from os2d_torch.structures.feature_map import FeatureMapSize


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (as tests/test_torch_spans.py): under the suite's
    workers sharing the cores, torch's OpenMP teams otherwise wait on each
    other's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.RandomState(2)
    boxes = np.zeros((2, 2, 4), np.float32)
    boxes[:, 0] = (10, 20, 90, 110)
    return {"images": rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8),
            "class_images": [rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
                             for _ in range(3)],
            "class_ids": [0, 1, 2], "gt_boxes": boxes,
            "gt_labels": np.array([[0, -1], [2, -1]], np.int64),
            "gt_difficult": np.zeros((2, 2), bool),
            "gt_valid": np.array([[True, False]] * 2),
            "img_size": FeatureMapSize(w=128, h=128)}


def _counters():
    return train_graphs.captures, train_graphs.replays, dict(train_graphs.eager_passes)


def _advance(before, after):
    (c0, r0, e0), (c1, r1, e1) = before, after
    return c1 - c0, r1 - r0, {k: v - e0.get(k, 0) for k, v in e1.items() if v != e0.get(k, 0)}


@pytest.mark.parametrize("train_features,reason", [(True, "cpu"), (False, "detached")])
def test_a_cpu_step_runs_both_passes_eager(train_features, reason):
    model = Os2dModel(Os2dConfig(class_image_size=64), device="cpu")
    cfg = get_default_cfg()
    cfg.train.model.train_features = train_features
    step = TrainStep(model, ObjectiveConfig(), create_optimizer(
        cfg.train.optim, trainable_parameters(model, cfg.train)), cfg.train)
    before = _counters()
    metrics = step(*prepare_batch_arrays(_batch(), "cpu"))
    assert np.isfinite(metrics["loss"])
    assert _advance(before, _counters()) == (0, 0, {reason: 2})
    assert step.backbone_graphs.graphs == {}


def _conv(cin=3, cout=4):
    conv = Conv2d(cin, cout, 3, 1, 1)
    with torch.no_grad():
        conv.weight.normal_()
    return conv


def test_a_pass_under_no_grad_runs_eager():
    conv, x = _conv(), torch.ones(1, 3, 8, 8)
    before = _counters()
    with torch.no_grad():
        out = BackboneGraphs()("backbone", conv, x)
    assert torch.equal(out, conv(x))
    assert _advance(before, _counters()) == (0, 0, {"no_grad": 1})


def _replace_storage(module):
    module.weight.data = module.weight.data.clone()


def _freeze(module):
    module.weight.requires_grad_(False)


@pytest.mark.parametrize("change", ["slot", "shape", "dtype", "requires_grad", "storage"])
def test_the_signature_changes_with_what_the_graph_depends_on(change):
    conv, x = _conv(), torch.zeros(2, 3, 8, 8)
    sig = pass_signature("backbone", conv, x)
    assert pass_signature("backbone", conv, x.clone()) == sig
    slot = "label_branch" if change == "slot" else "backbone"
    if change == "shape":
        x = torch.zeros(2, 3, 8, 16)
    elif change == "dtype":
        x = x.double()
    elif change == "requires_grad":
        _freeze(conv)
    elif change == "storage":
        _replace_storage(conv)
    assert pass_signature(slot, conv, x) != sig


class _StandIn:
    """In the place of a captured pair: records nothing."""

    def __init__(self, module, x, params, grad_stride):
        pass


def test_a_miss_runs_eager_once_captures_then_keeps_to_its_bound(monkeypatch):
    monkeypatch.setattr(train_graphs, "_GraphedPass", _StandIn)
    graphs, conv = BackboneGraphs(max_graphs=2), _conv()
    params = tuple(conv.parameters())

    def miss(slot, x):
        sig = pass_signature(slot, conv, x, params)
        return graphs._miss(sig, conv, x, params) if sig not in graphs.graphs else "replay"

    a, b, c = (torch.zeros(1, 3, s, s) for s in (8, 16, 24))
    captures = train_graphs.captures
    assert [miss("backbone", a), miss("backbone", a), miss("backbone", a)] == \
        ["first_sight", None, "replay"]
    assert [miss("label_branch", b), miss("label_branch", b)] == ["first_sight", None]
    assert train_graphs.captures == captures + 2
    assert [miss("backbone", c), miss("backbone", c)] == ["cache_full", "cache_full"]
    # new storage: the slot's pair on the old storage goes, and the new one
    # is captured on its second sight
    _replace_storage(conv)
    params = tuple(conv.parameters())
    assert [miss("backbone", a), miss("backbone", a), miss("backbone", a)] == \
        ["first_sight", None, "replay"]
    assert sorted(s[0] for s in graphs.graphs) == ["backbone", "label_branch"]
    assert train_graphs.captures == captures + 3
