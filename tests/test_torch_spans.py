"""The port's spans (`utils/profiling.annotate`) on the CPU at a tiny size:

- an eval request (`Evaluator.detect_images`, then `unpack_detections`) and
  a training step (`prepare_batch_arrays`, then `TrainStep`) under
  torch.profiler open the spans of the layer boundaries, each inside the
  span it belongs to; `os2d.head` opens once per (level, class chunk),
  inside `os2d.eval.scores`;
- `os2d.wait.nms_sweep` opens once per fixpoint sweep, as
  `ops.nms.fixpoint_sweeps` advances, on the dense and the blocked NMS;
- what the program computes is the same to the bit with the profiler on
  and off;
- with no profiler recording, `annotate` never enters `record_function`.

On the card, tests/test_torch_spans_card.py holds the `os2d.wait.*` spans
of a request against the synchronizing calls that CUDA's sync debug mode
reports.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from os2d_torch.config import get_default_cfg
from os2d_torch.engine.evaluate import Evaluator, unpack_detections
from os2d_torch.engine.objective import ObjectiveConfig
from os2d_torch.engine.optimization import create_optimizer
from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.ops import nms
from os2d_torch.structures.feature_map import FeatureMapSize
from os2d_torch.utils import profiling

SIZES = [FeatureMapSize(w=192, h=160), FeatureMapSize(w=96, h=80)]
CLASSES, CHUNK = 3, 2
TRAIN_PHASES = ["os2d.train.upload", "os2d.train.zero_grad", "os2d.train.forward",
                "os2d.train.targets", "os2d.train.objective", "os2d.train.backward",
                "os2d.train.clip", "os2d.wait.step_metrics", "os2d.train.optimizer",
                "os2d.train.release"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (as tests/test_torch_evaluate.py): under the
    suite's workers sharing the cores, torch's OpenMP teams otherwise wait on
    each other's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spans_of(fn):
    """(fn's result, [(start, end, name)] of the os2d.* spans it opened on
    this thread, by start, outer first)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    found = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.name.startswith("os2d.")]
    return out, sorted(found, key=lambda s: (s[0], -s[1]))


def parent(span, spans):
    """The name of the innermost other span enclosing `span`, or None."""
    around = [s for s in spans if s is not span and s[0] <= span[0] and span[1] <= s[1]
              and (s[1] - s[0]) > (span[1] - span[0])]
    return min(around, key=lambda s: s[1] - s[0])[2] if around else None


def names(spans, name):
    return [s for s in spans if s[2] == name]


@pytest.fixture(scope="module")
def request_setup():
    model = Os2dModel(Os2dConfig(), device="cpu")
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = CHUNK
    cfg.tpu.eval_pre_top_k = 64
    cfg.tpu.eval_top_k = 16
    ev = Evaluator(model, cfg)
    rng = np.random.RandomState(0)
    mean = np.asarray(model.config.normalization_mean, np.float32)
    std = np.asarray(model.config.normalization_std, np.float32)
    classes = [(rng.randint(0, 256, (64, 64, 3)).astype(np.float32) / 255 - mean) / std
               for _ in range(CLASSES)]
    head, _ = ev.build_class_heads(classes)
    image = rng.randint(0, 256, (1, 160, 192, 3)).astype(np.uint8)
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    inverse = [(192 / s.w, 160 / s.h) for s in SIZES]

    def request():
        return unpack_detections(ev.detect_images(image, head, SIZES, inverse, norm))
    return ev, request


def test_a_request_opens_the_spans_of_its_layers(request_setup):
    ev, request = request_setup
    request()  # builds the head's constants (`models/head.py: HeadConstantCache`)
    sweeps = nms.fixpoint_sweeps
    out, spans = spans_of(request)
    sweeps = nms.fixpoint_sweeps - sweeps
    chunks = ev.level_chunks(SIZES, CLASSES) or [CHUNK] * len(SIZES)
    head_calls = sum(-(-CLASSES // c) for c in chunks)
    assert head_calls == 3  # two chunks of 2 at the larger level, one of 8 at the smaller
    assert out["valid"].any()
    counts = {}
    for s in spans:
        counts[s[2]] = counts.get(s[2], 0) + 1
    # constants: mean and std, two per resized axis of the second level, a
    # scale per level; none in the head, whose constants the first request built
    assert counts == {"os2d.eval.pyramid": 1, "os2d.wait.upload": 1, "os2d.backbone": 2,
                      "os2d.eval.scores": 1, "os2d.head": head_calls, "os2d.eval.decode": 1,
                      "os2d.nms": 1, "os2d.wait.nms_sweep": sweeps, "os2d.wait.unpack": 1,
                      "os2d.wait.constant": 2 + 4 + 2}
    assert sweeps >= 2
    want_parent = {"os2d.eval.pyramid": None, "os2d.wait.upload": "os2d.eval.pyramid",
                   "os2d.backbone": None, "os2d.eval.scores": None,
                   "os2d.head": "os2d.eval.scores", "os2d.eval.decode": None,
                   "os2d.nms": "os2d.eval.decode", "os2d.wait.nms_sweep": "os2d.nms",
                   "os2d.wait.unpack": None}
    for s in spans:
        if s[2] == "os2d.wait.constant":
            assert parent(s, spans) in ("os2d.eval.pyramid", "os2d.eval.decode")
        else:
            assert parent(s, spans) == want_parent[s[2]], s
    order = [s[2] for s in spans if parent(s, spans) is None]
    assert order == ["os2d.eval.pyramid"] + ["os2d.backbone"] * 2 + [
        "os2d.eval.scores", "os2d.eval.decode", "os2d.wait.unpack"]


def test_a_request_is_the_same_with_the_profiler_on_and_off(request_setup):
    _, request = request_setup
    off = request()
    on, _ = spans_of(request)
    for k in ("boxes", "scores", "valid"):
        assert np.array_equal(off[k], on[k]), k


def train_batch():
    rng = np.random.RandomState(1)
    boxes = np.zeros((2, 3, 4), np.float32)
    boxes[:, 0] = (10, 20, 90, 110)
    boxes[:, 1] = (40, 8, 120, 60)
    return {"images": rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8),
            "class_images": [rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
                             for _ in range(CLASSES)],
            "class_ids": list(range(CLASSES)),
            "gt_boxes": boxes, "gt_labels": np.array([[0, 2, -1], [1, 0, -1]], np.int64),
            "gt_difficult": np.zeros((2, 3), bool),
            "gt_valid": np.array([[True, True, False]] * 2),
            "img_size": FeatureMapSize(w=128, h=128)}


def train_once(profiled):
    """One step from the seed-0 weights: (metrics, state_dict, spans)."""
    model = Os2dModel(Os2dConfig(class_image_size=64), device="cpu")
    cfg = get_default_cfg()
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    step = TrainStep(model, ObjectiveConfig(), optimizer, cfg.train)
    batch = train_batch()

    def run():
        arrays, c_pad = prepare_batch_arrays(batch, "cpu")
        return step(arrays, c_pad)
    metrics, spans = spans_of(run) if profiled else (run(), [])
    return metrics, {k: v.clone() for k, v in model.state_dict().items()}, spans


def test_a_train_step_opens_its_phases_and_is_the_same_with_the_profiler_on_and_off():
    metrics, state, spans = train_once(profiled=True)
    top = [s[2] for s in spans if parent(s, spans) is None]
    assert top == TRAIN_PHASES
    assert [parent(s, spans) for s in names(spans, "os2d.backbone")] == \
        ["os2d.train.forward"] * 2  # the images, then the class images
    assert [parent(s, spans) for s in names(spans, "os2d.head")] == ["os2d.train.forward"]
    waits = [s for s in spans if s[2].startswith("os2d.wait.")]
    assert {s[2] for s in waits} == {"os2d.wait.constant", "os2d.wait.step_metrics"}
    assert all(parent(s, spans) in ("os2d.train.forward", "os2d.head")
               for s in names(spans, "os2d.wait.constant"))
    off_metrics, off_state, _ = train_once(profiled=False)
    assert metrics == off_metrics
    assert all(torch.equal(state[k], off_state[k]) for k in state)


@pytest.mark.parametrize("dense_limit", [8192, 8])
def test_each_nms_sweep_opens_one_wait_span(dense_limit):
    gen = torch.Generator().manual_seed(0)
    xy = torch.rand(2, 24, 2, generator=gen) * 40
    boxes = torch.cat([xy, xy + 10 + torch.rand(2, 24, 2, generator=gen) * 20], dim=-1)
    scores = torch.rand(2, 24, generator=gen)
    valid = torch.ones(2, 24, dtype=torch.bool)
    sweeps = nms.fixpoint_sweeps
    keep, spans = spans_of(lambda: nms.nms_keep_mask(boxes, scores, valid, 0.3,
                                                      dense_limit=dense_limit, block=8))
    sweeps = nms.fixpoint_sweeps - sweeps
    assert sweeps >= (3 if dense_limit == 8 else 2)
    assert len(names(spans, "os2d.wait.nms_sweep")) == sweeps
    assert len(names(spans, "os2d.nms")) == 1
    assert all(parent(s, spans) == "os2d.nms" for s in names(spans, "os2d.wait.nms_sweep"))
    assert torch.equal(keep, nms.nms_keep_mask(boxes, scores, valid, 0.3))


def test_annotate_enters_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.annotate("os2d.test"):
        value = profiling.host_constant([1.0, 2.0])
    assert value.tolist() == [1.0, 2.0]
    boxes = torch.tensor([[0.0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]])
    keep = nms.nms_keep_mask(boxes, torch.tensor([0.9, 0.8, 0.7]), torch.ones(3, dtype=bool),
                             0.3)
    assert keep.tolist() == [True, False, True]
    # with a profiler recording, the same span does enter it
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="os2d.test"):
            with profiling.annotate("os2d.test"):
                pass
