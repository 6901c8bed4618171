"""The driver of a CoAE eval mix ("kind": "coae_eval_closed_loop"): one client
that sends each request, B uint8 scene images, through the port's
`Evaluator.detect_images` with a `CoaeModel` against the mix's queries,
unpacks its detections on the host (`unpack_detections`) and keeps the
request's proposals, which the call returns beside them, on the device
with them, then sends the next.

Set-up builds the model from the seed's weights (harness/coae_weights.py),
the class bank of the mix's query images (once, as for a catalog) and a pool
of distinct image batches, and runs one request to warm up. The check draws
requests from the seed among those the window finished and judges, for
each, what the request itself produced (`reference.decode.judge`):
(a) its proposals against the reference's RPN candidates of the same
(image, query) pairs, at the RPN's NMS threshold and pre-NMS cap (numbers
"proposal_*"); (b) its detections against the reference's second stage run
on those same proposals, at the mix's NMS threshold (the other numbers).
Both are judged at the NMS threshold less IOU_BAND: a candidate whose IoU
with a box kept earlier lies within the band under the threshold counts as
suppressed either way, since round-off in the boxes (~1e-3 px) moves an
IoU by up to ~1e-4 and can flip such a suppression; without the band one
flip leaves that candidate available to every later rank and its score
gap counts against each (1.6e-3 read on one of 128 calibration batches).
So a sound list reads an `iou_excess` of up to IOU_BAND. The mix runs one
pyramid level at scale 1, so the proposals' pixels are the level's.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ...counts.flops import level_sizes
from ...reference import coae as ref
from ...reference import decode as ref_decode
from ...reference import model as ref_model
from ..coae_weights import make_state_dict
from ..common import PhaseClock, verdict
from .eval_closed_loop import check_sample, eval_inputs

IOU_BAND = 1e-3


def coae_config(config):
    """The port's CoaeConfig of a configuration file: every key that names
    one of its fields (lists as tuples)."""
    from os2d_torch.models.coae import CoaeConfig

    fields = {f.name for f in dataclasses.fields(CoaeConfig)}
    return CoaeConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in config.items() if k in fields})


def build_model(config, state, device):
    from os2d_torch.models.coae import CoaeModel

    model = CoaeModel(coae_config(config), device=device)
    model.load_state_dict(state, strict=True)
    return model


def _check_traffic(traffic):
    if list(traffic["pyramid_scales"]) != [1.0]:
        raise ValueError("a CoAE mix runs one pyramid level at scale 1, got "
                         f"{traffic['pyramid_scales']}")


def _pairs(out, key):
    """[B, G, ...] of a request's output -> [B * G, ...]."""
    x = out[key]
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def judge_requests(outputs, batches_of, state, config, traffic, class_u8, pool, device):
    """Judge each sampled request against the reference (see the module
    docstring). outputs: {request index: {"boxes", "scores", "valid"}
    numpy, "proposals" [B, G, post, 6] tensor}; batches_of: {request index:
    pool index}. Returns the worst of each number."""
    ref_model.set_exact_float32()
    f32 = torch.float32
    hw = (traffic["image_h"], traffic["image_w"])
    worst = {}
    with torch.no_grad():
        queries = ref_model.backbone(ref_model.normalize_u8(
            torch.as_tensor(class_u8, device=device), config), state, config, f32)
        for p in sorted(set(batches_of.values())):
            scenes = ref_model.backbone(ref_model.normalize_u8(
                torch.as_tensor(pool[p], device=device), config), state, config, f32)
            cand_boxes, cand_scores, maps = [], [], []
            for b in range(scenes.shape[0]):
                for c in range(queries.shape[0]):
                    non_det, act_det, act_aim = ref.co_attention(scenes[b:b + 1],
                                                                 queries[c:c + 1], state, f32)
                    boxes, scores = ref.rpn_candidates(non_det, state, hw, config, f32)
                    cand_boxes.append(boxes)
                    cand_scores.append(scores)
                    maps.append((act_det, act_aim))
                    del non_det
            cand_boxes, cand_scores = torch.stack(cand_boxes), torch.stack(cand_scores)
            second = {}  # proposals' bytes -> the reference's second stage on them
            for i, out in outputs.items():
                if batches_of[i] != p:
                    continue
                props = _pairs(out, "proposals").to(device=device, dtype=f32)
                got = ref_decode.judge(cand_boxes, cand_scores, props[..., :4], props[..., 4],
                                       props[..., 5] > 0.5, config["rpn_nms_iou"] - IOU_BAND,
                                       config["rpn_pre_nms"])
                numbers = {"proposal_" + k: v for k, v in got.items()}
                key = hashlib.sha1(props.cpu().numpy().tobytes()).hexdigest()
                if key not in second:
                    stage = [ref.second_stage(act_det, act_aim, props[j, :, :4],
                                              props[j, :, 5] > 0.5, state, hw, config, f32)
                             for j, (act_det, act_aim) in enumerate(maps)]
                    second[key] = (torch.stack([s[0] for s in stage]),
                                   torch.stack([s[1] for s in stage]))
                boxes = torch.as_tensor(_pairs(out, "boxes"), device=device).float()
                numbers.update(ref_decode.judge(
                    *second[key], boxes, torch.as_tensor(_pairs(out, "scores"),
                                                         device=device).float(),
                    torch.as_tensor(_pairs(out, "valid"), device=device),
                    traffic["nms_iou_threshold"] - IOU_BAND, config["rpn_post_nms"]))
                for name, v in numbers.items():
                    worst[name] = max(worst.get(name, 0.0), v)
            del maps, second, cand_boxes, cand_scores
    return worst


class Driver:
    def __init__(self, config, traffic, limits, seed, device):
        _check_traffic(traffic)
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
        cfg.tpu.eval_top_k = t["top_k"]
        self.evaluator = Evaluator(self.model, cfg)
        self.class_u8, self.pool = eval_inputs(t, self.seed)
        clock.mark("inputs")
        mean = np.asarray(self.config["normalization_mean"], np.float32)
        std = np.asarray(self.config["normalization_std"], np.float32)
        query_images = [(im.astype(np.float32) / 255.0 - mean) / std for im in self.class_u8]
        self.bank, _ = self.evaluator.build_class_heads(query_images)
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

        packed, extra = self.evaluator.detect_images(self.pool[i % len(self.pool)], self.bank,
                                                     self.sizes, self.inverse, self.norm)
        out = unpack_detections(packed)
        out["proposals"] = extra["proposals"]
        return out

    def end_to_end(self, records, start, end):
        latencies = [t1 - t0 for t0, t1, _ in records]
        p90 = float(np.quantile(np.asarray(latencies), 0.9, method="inverted_cdf"))
        return {"eval_img_per_s": self.images_per_request * len(records) / (end - start),
                "eval_latency_ms_p90": p90 * 1e3}

    def release(self):
        self.model = self.evaluator = self.bank = None

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
    """The check's numbers of the reference in bfloat16 (`ref.detect_pair`,
    pair by pair, its NMS the plain greedy one) in the program's place."""
    _check_traffic(traffic)
    device = torch.device(device)
    state = make_state_dict(config, seed, device)
    class_u8, pool = eval_inputs(traffic, seed)
    hw = (traffic["image_h"], traffic["image_w"])
    bf16 = torch.bfloat16
    outputs = {}
    with torch.no_grad():
        queries = ref_model.backbone(ref_model.normalize_u8(
            torch.as_tensor(class_u8, device=device), config), state, config, bf16)
        for i, batch in enumerate(pool):
            scenes = ref_model.backbone(ref_model.normalize_u8(
                torch.as_tensor(batch, device=device), config), state, config, bf16)
            rows = []
            for b in range(scenes.shape[0]):
                for c in range(queries.shape[0]):
                    rois, roi_s, roi_v, fb, fs, fv = ref.detect_pair(
                        scenes[b:b + 1], queries[c:c + 1], state, hw, config,
                        traffic["nms_iou_threshold"], traffic["top_k"], bf16)
                    rows.append((torch.cat([rois.float(), roi_s.float()[:, None],
                                            roi_v.float()[:, None]], 1), fb, fs, fv))
            n_img, n_q = scenes.shape[0], queries.shape[0]

            def stacked(k, rows=rows, n_img=n_img, n_q=n_q):
                x = torch.stack([r[k] for r in rows])
                return x.reshape(n_img, n_q, *x.shape[1:])

            outputs[i] = {"proposals": stacked(0), "boxes": stacked(1).cpu().numpy(),
                          "scores": stacked(2).cpu().numpy(), "valid": stacked(3).cpu().numpy()}
    return judge_requests(outputs, {i: i for i in outputs}, state, config, traffic, class_u8,
                          pool, device)


def _coattention_skipped(model):
    """non_det = x: each pair's RPN and RoI head on the scene's map as the
    backbone gives it."""
    attend = model.attend

    def broken(scene, bank):
        non_det, non_aim = attend(scene, bank)
        x = scene.feats[:, None].expand(-1, bank.feats.shape[0], -1, -1, -1)
        return x.reshape(non_det.shape), non_aim
    model.attend = broken


def _gate_skipped(model):
    """c = 1: no co-excitation."""
    model.excite = lambda non_det, non_aim: (non_det, non_aim)


def _roi_align_aligned(model):
    """RoIAlign's samples half a cell up and left of CoAE's, where
    torchvision's aligned=True puts them: each pair's RoIs shifted by half
    the stride before they are pooled (the boxes still decoded on the RoIs
    themselves)."""
    pool_rois, half = model.pool_rois, 0.5 * model.config.feat_stride
    model.pool_rois = lambda act_det, rois: pool_rois(act_det, rois - half)


def _rpn_nms_skipped(model):
    """The RPN keeps its top rpn_post_nms candidates with no NMS (IoU is
    never above 1)."""
    model.config = dataclasses.replace(model.config, rpn_nms_iou=1.0)


def _next_query(model):
    """Each query's RoIs scored with the next query's vector q (the chunk's
    last with its first)."""
    apply_head, query_vectors = model.apply_head, model.query_vectors
    chunk = {}

    def head(scene, bank):
        chunk["queries"] = bank.feats.shape[0]
        return apply_head(scene, bank)

    def vectors(act_aim):
        q = query_vectors(act_aim)
        return q.reshape(-1, chunk["queries"], q.shape[-1]).roll(-1, 1).reshape(q.shape)
    model.apply_head, model.query_vectors = head, vectors


# faults planted in a built CoaeModel, which the check has to catch
MODEL_FAULTS = {"coattention_skipped": _coattention_skipped, "gate_skipped": _gate_skipped,
                "roi_align_aligned": _roi_align_aligned, "rpn_nms_skipped": _rpn_nms_skipped,
                "next_query": _next_query}


def _planted(break_model):
    def plant(driver):
        setup = driver.setup

        def broken_setup():
            setup()
            break_model(driver.model)
        driver.setup = broken_setup
    plant.__doc__ = break_model.__doc__
    return plant


FAULTS = {name: _planted(fn) for name, fn in MODEL_FAULTS.items()}
