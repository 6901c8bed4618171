"""TrainStep's CUDA graphs of the backbone (engine/train_graphs.py) on the
card. Without a card every test here skips. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_train_graphs_card.py -q

On a ResNet50-C4 OS2D at two scene shapes and two padded class counts
(batch 2 of 320x320 with 4 classes, batch 2 of 384x384 with 8; class images
of 128 px), interleaved, three steps each:
- the graphed steps (each signature eager once, captured on its second
  step, replayed on its third) equal the eager steps from the same state to
  the bit: every loss term and the gradient norm, every gradient, every
  updated weight and momentum buffer;
- a second graphed run from that state replays every pass, and equals the
  first to the bit;
- the counters: one capture per signature, two replays a step once
  captured, an eager pass past the bound of pairs, and after a parameter is
  given new storage, one eager step and a capture again;
- a capture beside a thread that keeps uploading arrays of new sizes (the
  train loop's prefetcher: pinned staging, a copy stream of its own) takes
  none of them into its graph: the steps equal the eager steps to the bit,
  and every upload arrives whole.
"""

import copy
import threading

import numpy as np

import pytest
import torch

from test_torch_kernels_card import _train_arrays

pytestmark = pytest.mark.cuda

# (batch, side, padded classes) of the two signatures of each slot
SHAPES = [(2, 320, 4), (2, 384, 8)]
STEPS_PER_SHAPE = 3


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.Generator(device="cuda").manual_seed(11)


def _step(max_graphs=None):
    """A ResNet50-C4 model from seed 3, its SGD and its TrainStep; with
    `max_graphs`, a graph helper of that bound."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, trainable_parameters
    from os2d_torch.engine.train_graphs import BackboneGraphs
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = get_default_cfg()
    model = Os2dModel(Os2dConfig(class_image_size=128), seed=3)
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    step = TrainStep(model, ObjectiveConfig(margin_pos=1.0), optimizer, cfg.train)
    if max_graphs is not None:
        step.backbone_graphs = BackboneGraphs(max_graphs)
    return step


def _batches(gen):
    """The two shapes' batches, interleaved: [(arrays, classes)]."""
    per_shape = [[(_train_arrays(gen, b, side, c), c) for _ in range(STEPS_PER_SHAPE)]
                 for b, side, c in SHAPES]
    return [run[i] for i in range(STEPS_PER_SHAPE) for run in per_shape]


def _state(step):
    model, optimizer = step.model, step.optimizer
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            copy.deepcopy(optimizer.state_dict()))


def _restore(step, state):
    weights, optimizer_state = state
    with torch.no_grad():
        for k, v in step.model.state_dict().items():
            v.copy_(weights[k])  # in place: the parameters keep their storage
    step.optimizer.load_state_dict(optimizer_state)


def _record(step, batches):
    """Per step: the metrics, and every gradient, weight and momentum buffer."""
    out = []
    for arrays, classes in batches:
        metrics = step(arrays, classes)
        params = dict(step.model.named_parameters())
        out.append((metrics,
                    {k: p.grad.clone() for k, p in params.items() if p.grad is not None},
                    {k: p.detach().clone() for k, p in params.items()},
                    {k: step.optimizer.state[p]["momentum_buffer"].clone()
                     for k, p in params.items() if p in step.optimizer.state}))
    return out


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], i
        for part in (1, 2, 3):
            assert g[part].keys() == w[part].keys(), (i, part)
            for k in w[part]:
                assert torch.equal(g[part][k], w[part][k]), (i, part, k)


def _counters():
    from os2d_torch.engine import train_graphs

    return (train_graphs.captures, train_graphs.replays, dict(train_graphs.eager_passes))


def _advance(before):
    (c0, r0, e0), (c1, r1, e1) = before, _counters()
    return c1 - c0, r1 - r0, {k: v - e0.get(k, 0) for k, v in e1.items() if v != e0.get(k, 0)}


def test_graphed_steps_equal_the_eager_steps_to_the_bit(cuda_gen):
    batches = _batches(cuda_gen)
    step = _step()
    start = _state(step)
    before = _counters()
    graphed = _record(step, batches)
    signatures = 2 * len(SHAPES)
    # the first step of each shape eager, the second captured and replayed
    assert _advance(before) == (signatures, 2 * (len(batches) - len(SHAPES)),
                                {"first_sight": signatures})
    assert graphed[0][0]["cls_RLL_pos"] > 0  # positives have a loss

    _restore(step, start)
    graphs = step.backbone_graphs
    step.backbone_graphs = type(graphs)(max_graphs=0)
    before = _counters()
    eager = _record(step, batches)
    assert _advance(before) == (0, 0, {"cache_full": 2 * len(batches)})
    _assert_bit_equal(graphed, eager)

    _restore(step, start)
    step.backbone_graphs = graphs
    before = _counters()
    again = _record(step, batches)
    assert _advance(before) == (0, 2 * len(batches), {})
    _assert_bit_equal(again, graphed)


def test_the_counters_follow_the_rule(cuda_gen):
    batches = _batches(cuda_gen)
    step = _step(max_graphs=2)
    a = [x for i, x in enumerate(batches) if i % 2 == 0]
    b = [x for i, x in enumerate(batches) if i % 2 == 1]

    def advance(arrays):
        before = _counters()
        step(*arrays)
        return _advance(before)

    assert advance(a[0]) == (0, 0, {"first_sight": 2})
    assert advance(a[1]) == (2, 2, {})  # one capture per signature, then replayed
    assert advance(a[2]) == (0, 2, {})
    assert advance(b[0]) == (0, 0, {"cache_full": 2})  # past the bound: eager
    weight = step.model.backbone.conv1.weight
    weight.data = weight.data.clone()  # new storage: the pairs on the old one go
    assert advance(a[0]) == (0, 0, {"first_sight": 2})
    assert advance(a[1]) == (2, 2, {})
    assert len(step.backbone_graphs.graphs) == 2


def test_a_capture_beside_uploads_from_another_thread(cuda_gen):
    from os2d_torch.utils.upload import Uploader

    batches = _batches(cuda_gen)[0::2]  # the first shape's three steps
    step = _step()
    start = _state(step)
    uploader = Uploader("cuda")
    stop, uploaded, errors = threading.Event(), [], []

    def uploads():
        rng = np.random.default_rng(0)
        try:
            while not stop.is_set():
                # a new size each time: new pinned and device blocks
                arr = rng.integers(0, 256, int(rng.integers(1 << 16, 1 << 22)), dtype=np.uint8)
                uploaded.append((arr, uploader.upload(arr)))
                del uploaded[:-8]
        except Exception as e:  # surfaced below
            errors.append(e)

    worker = threading.Thread(target=uploads, daemon=True)
    worker.start()
    try:
        before = _counters()
        graphed = _record(step, batches)
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive() and not errors, errors
    assert _advance(before)[:2] == (2, 4)
    torch.cuda.synchronize()
    for arr, dev in uploaded:
        assert np.array_equal(dev.cpu().numpy(), arr)

    _restore(step, start)
    step.backbone_graphs = type(step.backbone_graphs)(max_graphs=0)
    _assert_bit_equal(graphed, _record(step, batches))
