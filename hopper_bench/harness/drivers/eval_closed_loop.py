"""The driver of an eval mix ("kind": "eval_closed_loop"): one client that
sends each request, B uint8 scene images, through `Evaluator.detect_images`
and unpacks its detections on the host (`unpack_detections`), then the next.

Set-up builds the model from the seed's weights, the class heads of the
mix's class images (once, as `evaluate()` does for a catalog) and a pool of
distinct image batches, and runs one request to warm up. The check draws
requests from the seed among those the window finished, runs the reference
over their images and judges their detections (`reference.decode.judge`).
"""

from __future__ import annotations

import numpy as np
import torch

from ...counts.flops import level_sizes
from ...reference import decode as ref_decode
from ...reference import model as ref
from ..common import PhaseClock, build_model, verdict
from ..weights import make_state_dict


def eval_inputs(traffic, seed):
    """(class images uint8 [C, s, s, 3], pool of uint8 [B, H, W, 3] batches)
    drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0])
    s = traffic["class_image_size"]
    classes = rng.integers(0, 256, (traffic["classes"], s, s, 3), dtype=np.uint8)
    shape = (traffic["batch"], traffic["image_h"], traffic["image_w"], 3)
    pool = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(traffic["pool_batches"])]
    return classes, pool


def check_sample(n_done, traffic, seed):
    """Indices of the finished requests that the check judges, drawn from the
    seed."""
    rng = np.random.default_rng([int(seed), 1])
    k = min(traffic["check_requests"], n_done)
    return sorted(int(i) for i in rng.choice(n_done, size=k, replace=False))


def reference_candidates(state, config, traffic, images_u8, class_feats, dtype):
    """The reference's candidates of one batch: boxes [B*C, M, 4], scores
    [B*C, M]."""
    x = ref.normalize_u8(images_u8, config)
    w0, h0 = traffic["image_w"], traffic["image_h"]
    levels = []
    for w, h in level_sizes(traffic):
        fm = ref.backbone(ref.pyramid_level(x, h, w), state, config, dtype)
        loc, cls = ref.head(fm, class_feats, state, config, dtype)
        levels.append((loc, cls, tuple(fm.shape[-2:]), (w, h), (w0 / w, h0 / h)))
        del fm
    boxes, scores = ref_decode.candidates(levels, config)
    b, c = scores.shape[:2]
    return boxes.reshape(b * c, -1, 4), scores.reshape(b * c, -1)


def judge_requests(outputs, batches_of, state, config, traffic, class_u8, pool, device):
    """Judge each sampled request's detections against the reference.
    outputs: {request index: {"boxes", "scores", "valid"} numpy};
    batches_of: {request index: pool index}. Returns the worst of each
    number of `reference.decode.judge`."""
    ref.set_exact_float32()
    with torch.no_grad():
        feats = ref.class_features(ref.normalize_u8(torch.as_tensor(class_u8, device=device),
                                                    config), state, config, torch.float32)
        worst = {}
        for p in sorted(set(batches_of.values())):
            images = torch.as_tensor(pool[p], device=device)
            cand = reference_candidates(state, config, traffic, images, feats, torch.float32)
            for i, out in outputs.items():
                if batches_of[i] != p:
                    continue
                b, g, k = out["scores"].shape
                got = ref_decode.judge(
                    *cand,
                    torch.as_tensor(out["boxes"], device=device).reshape(b * g, k, 4).float(),
                    torch.as_tensor(out["scores"], device=device).reshape(b * g, k).float(),
                    torch.as_tensor(out["valid"], device=device).reshape(b * g, k),
                    traffic["nms_iou_threshold"], traffic["pre_top_k"])
                for name, v in got.items():
                    worst[name] = max(worst.get(name, 0.0), v)
            del cand
    return worst


class Driver:
    def __init__(self, config, traffic, limits, seed, device):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device = seed, torch.device(device)
        self.first = 0
        self.trace_count = traffic["trace_requests"]
        self.images_per_request = traffic["batch"]

    def setup(self):
        from os2d_torch.config import get_default_cfg
        from os2d_torch.engine.evaluate import Evaluator
        from os2d_torch.structures.feature_map import FeatureMapSize

        t = self.traffic
        clock = PhaseClock()
        self.state = make_state_dict(self.config, self.seed, self.device)
        clock.mark("weights")
        self.model = build_model(self.config, self.state, self.device)
        clock.mark("model")
        cfg = get_default_cfg()
        cfg.tpu.eval_class_chunk = t["class_chunk"]
        cfg.eval.nms_iou_threshold = t["nms_iou_threshold"]
        cfg.tpu.eval_pre_top_k = t["pre_top_k"]
        cfg.tpu.eval_top_k = t["top_k"]
        self.evaluator = Evaluator(self.model, cfg)
        self.class_u8, self.pool = eval_inputs(t, self.seed)
        clock.mark("inputs")
        mean = np.asarray(self.config["normalization_mean"], np.float32)
        std = np.asarray(self.config["normalization_std"], np.float32)
        class_images = [(im.astype(np.float32) / 255.0 - mean) / std for im in self.class_u8]
        self.class_head, _ = self.evaluator.build_class_heads(class_images)
        clock.mark("class heads")
        self.sizes = [FeatureMapSize(w=w, h=h) for w, h in level_sizes(t)]
        self.inverse = [(t["image_w"] / s.w, t["image_h"] / s.h) for s in self.sizes]
        self.norm = {"mean": self.config["normalization_mean"],
                     "std": self.config["normalization_std"]}
        self.request(len(self.pool) - 1)
        clock.mark("warm-up request")
        self.setup_phases = clock.phases

    def request(self, i):
        from os2d_torch.engine.evaluate import unpack_detections

        packed = self.evaluator.detect_images(self.pool[i % len(self.pool)], self.class_head,
                                              self.sizes, self.inverse, self.norm)
        return unpack_detections(packed)

    def end_to_end(self, records, start, end):
        latencies = [t1 - t0 for t0, t1, _ in records]
        p90 = float(np.quantile(np.asarray(latencies), 0.9, method="inverted_cdf"))
        return {"eval_img_per_s": self.images_per_request * len(records) / (end - start),
                "eval_latency_ms_p90": p90 * 1e3}

    def release(self):
        self.model = self.evaluator = self.class_head = None

    def check(self, records):
        picked = check_sample(len(records), self.traffic, self.seed)
        outputs = {i: records[i][2] for i in picked}
        batches_of = {i: (self.first + i) % len(self.pool) for i in picked}
        worst = judge_requests(outputs, batches_of, self.state, self.config, self.traffic,
                               self.class_u8, self.pool, self.device)
        return verdict(worst, self.limits)


def program_numbers(driver):
    """The check's numbers of one request on each batch of the pool, the
    driver set up."""
    n = driver.traffic["pool_batches"]
    outputs = {i: driver.request(i) for i in range(n)}
    driver.release()
    return judge_requests(outputs, {i: i for i in range(n)}, driver.state, driver.config,
                          driver.traffic, driver.class_u8, driver.pool, driver.device)


def control_numbers(config, traffic, seed, device):
    """The check's numbers of the reference in bfloat16, its detections
    through the plain greedy NMS, in the program's place."""
    device = torch.device(device)
    state = make_state_dict(config, seed, device)
    class_u8, pool = eval_inputs(traffic, seed)
    outputs = {}
    with torch.no_grad():
        feats = ref.class_features(ref.normalize_u8(torch.as_tensor(class_u8, device=device),
                                                    config), state, config, torch.bfloat16)
        for i, batch in enumerate(pool):
            boxes, scores = reference_candidates(state, config, traffic,
                                                 torch.as_tensor(batch, device=device), feats,
                                                 torch.bfloat16)
            b, s, v = ref_decode.nms_topk(boxes, scores, traffic["nms_iou_threshold"],
                                          traffic["pre_top_k"], traffic["top_k"])
            n_img = traffic["batch"]
            outputs[i] = {"boxes": b.reshape(n_img, -1, *b.shape[1:]).cpu().numpy(),
                          "scores": s.reshape(n_img, -1, s.shape[1]).cpu().numpy(),
                          "valid": v.reshape(n_img, -1, v.shape[1]).cpu().numpy()}
    return judge_requests(outputs, {i: i for i in outputs}, state, config, traffic, class_u8,
                          pool, device)


def _altered_answer(driver):
    """One detection's score of each request moved by 0.01 where it is
    produced."""
    request = driver.request

    def broken(i):
        out = request(i)
        out["scores"] = out["scores"].copy()
        out["scores"][0, 0, 0] += 0.01
        return out
    driver.request = broken


def _nms_threshold(value):
    def plant(driver):
        """The program's NMS run at IoU threshold `value` in place of the
        mix's."""
        setup = driver.setup

        def broken_setup():
            setup()
            driver.evaluator.cfg.eval.nms_iou_threshold = value
        driver.setup = broken_setup
    return plant


FAULTS = {"altered_answer": _altered_answer,
          # nothing suppressed: IoU is never above 1
          "nms_skipped": _nms_threshold(1.0),
          "nms_loose": _nms_threshold(0.5)}
