"""The port's `os2d.wait.*` spans against the card's synchronizing calls.

Without a card every test here skips. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_spans_card.py -q

One eval request (`Evaluator.detect_images`, then `unpack_detections`)
and one `TrainStep` run under torch.profiler with CUDA's sync debug mode
set to "warn": each synchronizing call warns once, and each lies in one
`os2d.wait.*` span, so the two counts are equal. The NMS sweeps' spans
equal `ops.nms.fixpoint_sweeps`' advance.
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def syncs_and_waits(fn):
    """(fn's result, synchronizing calls that warn, os2d.wait.* spans by
    name) of one call of fn."""
    # the first switch to "warn" in a process warns once by itself
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    waits = {}
    for e in prof.events():
        if e.name.startswith("os2d.wait.") and e.device_type == torch.autograd.DeviceType.CPU:
            waits[e.name] = waits.get(e.name, 0) + 1
    return out, syncs, waits


def test_a_requests_waits_are_its_synchronizing_calls(card):
    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.evaluate import Evaluator, unpack_detections
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.ops import nms
    from os2d_torch.structures.feature_map import FeatureMapSize

    model = Os2dModel(Os2dConfig(), device=card)
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = 4
    ev = Evaluator(model, cfg)
    rng = np.random.RandomState(0)
    mean = np.asarray(model.config.normalization_mean, np.float32)
    std = np.asarray(model.config.normalization_std, np.float32)
    head, _ = ev.build_class_heads(
        [(rng.randint(0, 256, (240, 240, 3)).astype(np.float32) / 255 - mean) / std
         for _ in range(6)])
    image = rng.randint(0, 256, (2, 480, 640, 3)).astype(np.uint8)
    sizes = [FeatureMapSize(w=int(640 * s), h=int(480 * s)) for s in (0.5, 1.0, 1.4)]
    inverse = [(640 / s.w, 480 / s.h) for s in sizes]
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}

    def request():
        return unpack_detections(ev.detect_images(image, head, sizes, inverse, norm))

    request()
    sweeps = nms.fixpoint_sweeps
    out, syncs, waits = syncs_and_waits(request)
    sweeps = nms.fixpoint_sweeps - sweeps
    assert out["valid"].any()
    assert waits["os2d.wait.nms_sweep"] == sweeps
    assert waits["os2d.wait.upload"] == 1 and waits["os2d.wait.unpack"] == 1
    assert sum(waits.values()) == len(syncs), (waits, [str(w.message) for w in syncs])


def test_a_train_steps_waits_are_its_synchronizing_calls(card):
    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.structures.feature_map import FeatureMapSize

    model = Os2dModel(Os2dConfig(class_image_size=128), device=card)
    cfg = get_default_cfg()
    step = TrainStep(model, ObjectiveConfig(),
                     create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train)),
                     cfg.train)
    rng = np.random.RandomState(1)
    boxes = np.zeros((2, 2, 4), np.float32)
    boxes[:, 0] = (20, 30, 180, 200)
    batch = {"images": rng.randint(0, 256, (2, 256, 256, 3)).astype(np.uint8),
             "class_images": [rng.randint(0, 256, (128, 128, 3)).astype(np.uint8)
                              for _ in range(3)],
             "class_ids": [0, 1, 2], "gt_boxes": boxes,
             "gt_labels": np.array([[1, -1], [0, -1]], np.int64),
             "gt_difficult": np.zeros((2, 2), bool),
             "gt_valid": np.array([[True, False]] * 2), "img_size": FeatureMapSize(w=256, h=256)}

    def one_step():
        arrays, c_pad = prepare_batch_arrays(batch, card)
        return step(arrays, c_pad)

    one_step()
    metrics, syncs, waits = syncs_and_waits(one_step)
    assert np.isfinite(metrics["loss"])
    assert waits["os2d.wait.step_metrics"] == 1
    assert sum(waits.values()) == len(syncs), (waits, [str(w.message) for w in syncs])
