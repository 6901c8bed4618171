"""The driver of a training mix ("kind": "train_steps"): `TrainStep` at the
mix's recipe, each step uploading a host batch through
`prepare_batch_arrays`.

Set-up builds the model from the seed's weights, its optimizer and step, and
a pool of host batches drawn from the seed, then drives that same step
object through the mix's first `check_steps` steps on distinct batches (they
warm up every shape of the window) and keeps its readings: each step's
loss; each tensor's gradient norm as the optimizer gets it after the first
step; each tensor's update over those steps (the SGD momentum buffers that
the steps applied, summed: the change before it is rounded to fp32); and
each tensor's change over those steps as the fp32 weights hold it, read in
fp64. The window goes on from there; its steps after those are timed and
not checked. The check has the reference follow the same steps from the
same weights and compares the readings.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from ...reference import model as ref
from ...reference import train as ref_train
from ..common import PhaseClock, build_model, verdict
from ..weights import make_state_dict

# a tensor's change counts where one value's change of one fp32 spacing
# moves its change norm by at most this share (the reference's flip_shares):
# where more, the change is an update at or below the weights' own spacing,
# rounded, and two sound runs that round one value apart read apart
# (PERF.md, End-to-end metrics)
RESOLVED_SHARE = 1e-4


def make_batch(rng, traffic):
    """One host batch as the port's train loader gives it."""
    from os2d_torch.structures.feature_map import FeatureMapSize

    b, side, c, s = traffic["batch"], traffic["patch"], traffic["classes"], \
        traffic["class_image_size"]
    lo, hi = traffic["gt_boxes_per_image"]
    smin, smax = traffic["gt_box_side"]
    boxes = np.zeros((b, hi, 4), np.float32)
    labels = np.full((b, hi), -1, np.int64)
    valid = np.zeros((b, hi), bool)
    for i in range(b):
        for g in range(int(rng.integers(lo, hi + 1))):
            w, h = rng.integers(smin, smax + 1, size=2)
            x0, y0 = rng.integers(0, side - w + 1), rng.integers(0, side - h + 1)
            boxes[i, g] = (x0, y0, x0 + w, y0 + h)
            labels[i, g] = rng.integers(0, c)
            valid[i, g] = True
    return {"images": rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8),
            "class_images": list(rng.integers(0, 256, (c, s, s, 3), dtype=np.uint8)),
            "class_ids": list(range(c)),
            "gt_boxes": boxes, "gt_labels": labels, "gt_difficult": np.zeros((b, hi), bool),
            "gt_valid": valid, "img_size": FeatureMapSize(w=side, h=side)}


def padded_classes(traffic):
    m, c = traffic["class_pad_multiple"], traffic["classes"]
    return max(m, -(-c // m) * m)


def reference_batch(batch, traffic, device):
    """The host batch's tensors for the reference, the class images padded
    with zero images to the padded class count."""
    c_pad = padded_classes(traffic)
    classes = np.stack(batch["class_images"])
    pad = np.zeros((c_pad - len(classes),) + classes.shape[1:], np.uint8)
    as_t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return {"images": as_t(batch["images"]), "class_images": as_t(np.concatenate([classes, pad])),
            "class_valid": as_t(np.arange(c_pad) < len(classes)),
            "gt_boxes": as_t(batch["gt_boxes"]), "gt_labels": as_t(batch["gt_labels"]),
            "gt_difficult": as_t(batch["gt_difficult"]), "gt_valid": as_t(batch["gt_valid"])}


def leaf_gaps(got, want, keys=None):
    """{key: |got - want| / max(|want|, median |want|)} over `keys` (all of
    want's by default); inf where got is not finite."""
    keys = list(want) if keys is None else list(keys)
    floor = statistics.median(abs(want[k]) for k in keys)
    return {k: abs(got[k] - want[k]) / max(abs(want[k]), floor) if math.isfinite(got[k])
            else math.inf for k in keys}


def moved_tensors(reference):
    """The tensors whose reference gradient is at least 1e-3 of the median
    tensor's (the others move by weight decay alone)."""
    median_grad = statistics.median(reference["grads"].values())
    return [k for k, v in reference["grads"].items() if v >= 1e-3 * median_grad]


def resolved_tensors(reference, share=RESOLVED_SHARE):
    """The moved tensors whose change one rounding moves by at most
    `share` of its norm."""
    return [k for k in moved_tensors(reference) if reference["flip_shares"][k] <= share]


def compare(readings, reference):
    """The four numbers of a training cell from the program's readings and
    the reference's (dicts of losses, grads, updates, changes):
      loss_gap     the worst step's |loss - reference| / |reference|;
      grad_gap     the worst tensor's gap of first-gradient norms, against
                   the larger of its reference norm and the median tensor's;
      update_gap   the same of the update over the steps (the momentum
                   buffers applied), over the moved tensors;
      change_gap   the same of the weights' change over the steps, read in
                   fp64 from the fp32 weights, over the moved tensors whose
                   change one rounding moves by RESOLVED_SHARE or less (inf
                   if there is none)."""
    loss_gap = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
                   for a, b in zip(readings["losses"], reference["losses"]))
    resolved = resolved_tensors(reference)
    return {"loss_gap": loss_gap,
            "grad_gap": max(leaf_gaps(readings["grads"], reference["grads"]).values()),
            "update_gap": max(leaf_gaps(readings["updates"], reference["updates"],
                                        moved_tensors(reference)).values()),
            "change_gap": max(leaf_gaps(readings["changes"], reference["changes"],
                                        resolved).values()) if resolved else math.inf}


def change_detail(readings, reference, shares=(1e-3, 1e-4, 1e-5, 1e-6, 1e-7, 1e-8)):
    """For calibration: at each bound of flip shares, the tensors counted,
    the worst gap of their change (with its tensor, its flip share and its
    reference and program norms), the median tensor's gap, and the gap of
    the norm of all of them together."""
    out = {}
    for s in shares:
        keys = resolved_tensors(reference, s)
        if not keys:
            out[str(s)] = [0]
            continue
        gaps = leaf_gaps(readings["changes"], reference["changes"], keys)
        worst = max(gaps, key=gaps.get)
        pooled_ref = math.sqrt(sum(reference["changes"][k] ** 2 for k in keys))
        pooled = math.sqrt(sum(readings["changes"][k] ** 2 for k in keys))
        out[str(s)] = [len(keys), gaps[worst], worst, reference["flip_shares"][worst],
                       reference["changes"][worst], readings["changes"][worst],
                       statistics.median(gaps.values()), abs(pooled - pooled_ref) / pooled_ref]
    return out


def reference_readings(state, batches, config, traffic, device, dtype=torch.float32):
    ref.set_exact_float32()
    ref_batches = [reference_batch(b, traffic, device) for b in batches]
    return ref_train.train_steps(state, ref_batches, config, traffic, dtype)


class Driver:
    def __init__(self, config, traffic, limits, seed, device):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device = seed, torch.device(device)
        self.first = traffic["check_steps"]
        self.trace_count = traffic["trace_steps"]
        self.images_per_request = traffic["batch"]

    def recipe(self):
        """The port's config tree at the mix's recipe."""
        from os2d_torch.config import get_default_cfg

        cfg = get_default_cfg()
        o, t = self.traffic["objective"], self.traffic["optim"]
        cfg.train.batch_size = self.traffic["batch"]
        cfg.train.class_batch_size = self.traffic["classes"]
        cfg.train.optim.optim_method = t["method"]
        cfg.train.optim.lr = t["lr"]
        cfg.train.optim.sgd_momentum = t["momentum"]
        cfg.train.optim.weight_decay = t["weight_decay"]
        cfg.train.optim.max_grad_norm = t["max_grad_norm"]
        obj = cfg.train.objective
        obj.class_objective = o["class_loss"]
        obj.neg_margin, obj.pos_margin, obj.loc_weight = (o["neg_margin"], o["pos_margin"],
                                                          o["loc_weight"])
        obj.positive_iou_threshold = o["positive_iou_threshold"]
        obj.negative_iou_threshold = o["negative_iou_threshold"]
        obj.class_neg_weight = o["class_neg_weight"]
        obj.rll_neg_weight_ratio = o["rll_neg_weight_ratio"]
        obj.remap_classification_targets = o["remap_classification_targets"]
        obj.remap_classification_targets_iou_pos = o["remap_iou_pos"]
        obj.remap_classification_targets_iou_neg = o["remap_iou_neg"]
        cfg.train.model.train_transform_on_negs = o["train_transform_on_negs"]
        return cfg

    def setup(self):
        from os2d_torch.engine.optimization import create_optimizer
        from os2d_torch.engine.train import TrainStep, trainable_parameters
        from os2d_torch.main import objective_config_from_cfg

        clock = PhaseClock()
        cfg = self.recipe()
        self.state = make_state_dict(self.config, self.seed, self.device)
        clock.mark("weights")
        self.model = build_model(self.config, self.state, self.device)
        optimizer = create_optimizer(cfg.train.optim, trainable_parameters(self.model, cfg.train))
        self.step = TrainStep(self.model, objective_config_from_cfg(cfg), optimizer, cfg.train)
        clock.mark("model")
        rng = np.random.default_rng([int(self.seed), 0])
        self.pool = [make_batch(rng, self.traffic) for _ in range(self.traffic["pool_batches"])]
        clock.mark("batches")
        losses, grads = [], None
        before = {name: p.detach().clone() for name, p in self.model.named_parameters()}
        applied = {name: torch.zeros_like(p) for name, p in self.model.named_parameters()}
        for i in range(self.first):
            losses.append(self.request(i)["loss"])
            if i == 0:
                grads = self.tensor_norms(lambda name, p: p.grad)
            for name, p in self.model.named_parameters():
                buf = self.step.optimizer.state.get(p, {}).get("momentum_buffer")
                if buf is not None:
                    applied[name] += buf
            clock.mark(f"step {i + 1}")
        self.readings = {
            "losses": losses, "grads": grads,
            "updates": self.tensor_norms(lambda name, p: applied[name]),
            "changes": self.tensor_norms(lambda name, p: p.detach().double()
                                         - before[name].double())}
        self.setup_phases = clock.phases

    def tensor_norms(self, of):
        names = [name for name, _ in self.model.named_parameters()]
        norms = torch.stack([of(name, p).norm() for name, p in self.model.named_parameters()])
        return dict(zip(names, norms.tolist()))

    def request(self, i):
        from os2d_torch.engine.train import prepare_batch_arrays

        arrays, c_pad = prepare_batch_arrays(self.pool[i % len(self.pool)], self.device,
                                             self.traffic["class_pad_multiple"])
        return self.step(arrays, c_pad)

    def end_to_end(self, records, start, end):
        return {"train_step_ms": (end - start) / len(records) * 1e3}

    def release(self):
        self.model = self.step = None

    def check(self, records):
        reference = reference_readings(self.state, self.pool[:self.first], self.config,
                                       self.traffic, self.device)
        return verdict(compare(self.readings, reference), self.limits)


def program_numbers(driver):
    """The check's numbers of the driver's first steps, the driver set up;
    with `change_detail` beside them."""
    driver.release()
    reference = reference_readings(driver.state, driver.pool[:driver.first], driver.config,
                                   driver.traffic, driver.device)
    return dict(compare(driver.readings, reference),
                change_detail=change_detail(driver.readings, reference))


def control_numbers(config, traffic, seed, device):
    """The check's numbers of the reference in bfloat16 in the program's
    place, over the same first steps."""
    device = torch.device(device)
    state = make_state_dict(config, seed, device)
    rng = np.random.default_rng([int(seed), 0])
    batches = [make_batch(rng, traffic) for _ in range(traffic["check_steps"])]
    control = reference_readings(state, batches, config, traffic, device, torch.bfloat16)
    reference = reference_readings(state, batches, config, traffic, device)
    return dict(compare(control, reference), change_detail=change_detail(control, reference))


def _wrap_step(driver, wrap):
    """Plant `wrap(step)` on the TrainStep that the driver's set-up builds:
    it runs on each TrainStep made while the set-up runs."""
    setup = driver.setup

    def broken_setup():
        import os2d_torch.engine.train as train

        step_cls = train.TrainStep

        class Broken(step_cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                wrap(self)

        train.TrainStep = Broken
        try:
            setup()
        finally:
            train.TrainStep = step_cls
    driver.setup = broken_setup


def _state_unchanged(driver):
    """TrainStep's optimizer never steps: the state stays as it was."""
    def wrap(step):
        step.optimizer.step = lambda *args, **kwargs: None
    _wrap_step(driver, wrap)


def _weights_unwritten(driver):
    """The optimizer steps, so its momentum buffers fill as in a sound
    step, but the weights are put back: nothing is written to them."""
    def wrap(step):
        optimizer_step = step.optimizer.step

        def broken(*args, **kwargs):
            params = [p for g in step.optimizer.param_groups for p in g["params"]]
            kept = [p.detach().clone() for p in params]
            out = optimizer_step(*args, **kwargs)
            with torch.no_grad():
                for p, k in zip(params, kept):
                    p.copy_(k)
            return out
        step.optimizer.step = broken
    _wrap_step(driver, wrap)


def _half_batch(driver):
    """Each step sees the first half of its images only (the mean taken
    over the rest)."""
    request = driver.request

    def broken(i):
        batch = driver.pool[i % len(driver.pool)]
        half = batch["images"].shape[0] // 2
        cut = dict(batch, **{k: batch[k][:half] for k in
                             ("images", "gt_boxes", "gt_labels", "gt_difficult", "gt_valid")})
        driver.pool[i % len(driver.pool)] = cut
        try:
            return request(i)
        finally:
            driver.pool[i % len(driver.pool)] = batch
    driver.request = broken


FAULTS = {"state_unchanged": _state_unchanged, "weights_unwritten": _weights_unwritten,
          "half_batch": _half_batch}
