"""One-shot detection service core (framework-agnostic): counterpart of
`os2d_tpu/api/service.py` (the reference FastAPI app's handler logic,
app.py:48-103, with the model built once and not per request).

The model owns its weights, so `DetectionService(model, ...)` takes no
params. Every request runs on the model's device through the eval engine
(`Evaluator.detect_images`, or `detect_images_prescreened` for large
catalogs); the packed detections cross to the host once per dispatch. The
HTTP wrapper is `os2d_torch/api/app.py`.
"""

from __future__ import annotations

import base64
import collections
import hashlib
import queue
import threading
import time
from io import BytesIO
from typing import List

import numpy as np
import torch
from PIL import Image

from ..config import get_default_cfg
from ..data.dataloader import image_to_normalized_array
from ..engine.evaluate import Evaluator, augment_class_images, unpack_detections
from ..structures.feature_map import FeatureMapSize, exact_resize_area

TARGET_IMAGE_SIZE = 1500  # longer side (reference app.py:74-76)
TARGET_QUERY_AREA_SIDE = 240
SCORE_THRESHOLD = 0.45
MAX_DETECTIONS = 30


def decode_base64_to_image(b64: str) -> Image.Image:
    img = Image.open(BytesIO(base64.b64decode(b64)))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return img


def parse_request_payload(payload: dict, image_key: str = "image"):
    """THE request-schema parser (app.py wraps it into a 400). Schemas
    (reference app.py:48):
      image_key="image":  {"image": {"content": b64}, "query": [...]}
      image_key="images": {"images": [{"content": b64}, ...], "query": [...]}
    Returns (images, queries) as lists of PIL images; raises ValueError on a
    malformed payload or an empty query list."""
    try:
        entries = payload[image_key]
        if image_key == "image":
            entries = [entries]
        images = [decode_base64_to_image(e["content"]) for e in entries]
        queries = [decode_base64_to_image(q["content"])
                   for q in payload["query"]]
    except (KeyError, TypeError, ValueError, OSError) as e:
        raise ValueError(
            f"malformed payload ({type(e).__name__}: {e}); expected "
            f'{{"{image_key}": ..., "query": [{{"content": b64}}]}}'
        ) from e
    if not queries:
        raise ValueError("empty query list")
    return images, queries


class DetectionService:
    """Holds the model; thread-safe for inference (no graph is recorded,
    whatever the model's training state, and `stats` is updated under a
    lock).

    Serving features beyond the reference handler (app.py:48-103):
      - pyramid_scales: multiscale input pyramid;
      - class_image_augmentation: test-time query augmentation
        ("rotation90" | "horflip" | "horflip_rotation90"), the view merge of
        engine/evaluate.py;
      - detect_batch: N images x one query set as ONE dispatch (shared class
        head, common padded canvas).

    Requests go through the eval engine (`Evaluator.detect_images`: uint8
    in, pyramid + backbone + head + decode + NMS on the device, packed
    detections out) and take the no-miss class prescreen for catalogs of at
    least `prescreen_min_classes` query groups. `stats` counts the
    dispatches of each kind."""

    def __init__(self, model, score_threshold=SCORE_THRESHOLD,
                 max_detections=MAX_DETECTIONS, pyramid_scales=(1.0,),
                 class_image_augmentation: str = "",
                 prescreen_min_classes: int = 64):
        self.model = model
        self.score_threshold = score_threshold
        self.max_detections = max_detections
        self.pyramid_scales = tuple(pyramid_scales)
        self.class_image_augmentation = class_image_augmentation
        self.prescreen_min_classes = int(prescreen_min_classes)
        self.img_normalization = {
            "mean": model.config.normalization_mean,
            "std": model.config.normalization_std,
        }
        cfg = get_default_cfg()
        # decode on the device with the service's own thresholds; the host-side
        # response filter re-applies score_threshold (same `>` cut)
        cfg.eval.nms_iou_threshold = 0.3
        cfg.eval.nms_score_threshold = float(score_threshold)
        cfg.tpu.eval_top_k = max(int(max_detections), 64)
        self.eval_cfg = cfg
        self.evaluator = Evaluator(model, cfg, logger_prefix="OS2D.serve")
        self.stats = {"prescreen_dispatches": 0, "full_dispatches": 0}
        self._stats_lock = threading.Lock()

    def _count(self, key):
        with self._stats_lock:
            self.stats[key] += 1

    def _detect_packed(self, images_u8, class_head, level_sizes, inv_scales,
                       num_views):
        """One dispatch (prescreened for large catalogs) -> the unpacked
        detections on the host."""
        ev = self.evaluator
        n_groups = class_head.class_feats.shape[0] // max(num_views, 1)
        if n_groups >= self.prescreen_min_classes and ev.prescreen_applicable(class_head):
            self._count("prescreen_dispatches")
            packed = ev.detect_images_prescreened(
                images_u8, class_head, level_sizes, inv_scales,
                self.img_normalization, num_views)
        else:
            self._count("full_dispatches")
            packed = ev.detect_images(
                images_u8, class_head, level_sizes, inv_scales,
                self.img_normalization, num_views)
        return unpack_detections(packed.cpu())

    def _prepare_query(self, query: Image.Image):
        w, h = query.size
        new = exact_resize_area(w=w, h=h, target_area_side=TARGET_QUERY_AREA_SIDE)
        resized = query.resize((new.w, new.h), Image.BILINEAR)
        return image_to_normalized_array(resized, self.img_normalization)

    def _build_class_head(self, queries: List[Image.Image]):
        """Prepared query arrays -> (ClassHead, num_views) with optional TTA."""
        query_arrays = [self._prepare_query(q) for q in queries]
        views, num_views = augment_class_images(
            query_arrays, self.class_image_augmentation
        )
        class_head = self.model.build_class_head_from_images(
            [torch.from_numpy(v) for v in views])
        return class_head, num_views

    def _packed_to_response(self, det, image_index, sx, sy, orig_w, orig_h):
        """One image of an unpacked detection dict -> the reference response
        schema. Boxes arrive in base-canvas coordinates; (sx, sy) maps them
        to original pixels, relative coords divide by the original size."""
        boxes = det["boxes"][image_index]
        scores = det["scores"][image_index]
        valid = det["valid"][image_index]

        flat = []
        for row in range(boxes.shape[0]):
            m = valid[row] & (scores[row] > self.score_threshold)
            for b, s in zip(boxes[row][m], scores[row][m]):
                bx = (float(b[0]) * sx, float(b[1]) * sy,
                      float(b[2]) * sx, float(b[3]) * sy)
                # drop boxes whose center left the original image (batched
                # canvases have padding to the right/bottom)
                cx = 0.5 * (bx[0] + bx[2])
                cy = 0.5 * (bx[1] + bx[3])
                if 0 <= cx <= orig_w and 0 <= cy <= orig_h:
                    flat.append((float(s), bx))
        flat.sort(key=lambda x: -x[0])
        flat = flat[: self.max_detections]

        return {
            "scores": [s for s, _ in flat],
            "bboxes": [
                [b[0] / orig_w, b[1] / orig_h, b[2] / orig_w, b[3] / orig_h]
                for _, b in flat
            ],
        }

    def _level_plan(self, base_w, base_h):
        """Pyramid level sizes for a base canvas at max(pyramid_scales);
        inverse scales map each level's boxes back to base-canvas coords."""
        base_scale = max(self.pyramid_scales)
        level_sizes, inv_scales = [], []
        for scale in self.pyramid_scales:
            r = scale / base_scale
            lw = max(1, int(round(base_w * r)))
            lh = max(1, int(round(base_h * r)))
            level_sizes.append(FeatureMapSize(w=lw, h=lh))
            inv_scales.append((base_w / lw, base_h / lh))
        return level_sizes, inv_scales

    @torch.no_grad()
    def detect(self, image: Image.Image, queries: List[Image.Image]):
        """Returns {"scores": [...], "bboxes": [[lx, ty, rx, by], ...]} with
        RELATIVE coordinates (reference app.py:83-103).

        Aspect-preserving: the image resizes (longer side ->
        TARGET_IMAGE_SIZE * max_scale) with no canvas padding; smaller
        pyramid levels are built on the device."""
        orig_w, orig_h = image.size
        class_head, num_views = self._build_class_head(queries)

        ratio = TARGET_IMAGE_SIZE * max(self.pyramid_scales) / max(orig_w, orig_h)
        base_w = max(1, int(orig_w * ratio))
        base_h = max(1, int(orig_h * ratio))
        resized = image.resize((base_w, base_h), Image.BILINEAR)
        images_u8 = np.array(resized, np.uint8)[None]

        level_sizes, inv_scales = self._level_plan(base_w, base_h)
        det = self._detect_packed(
            images_u8, class_head, level_sizes, inv_scales, num_views)
        return self._packed_to_response(
            det, 0, orig_w / base_w, orig_h / base_h, orig_w, orig_h)

    @torch.no_grad()
    def detect_batch(self, images: List[Image.Image],
                     queries: List[Image.Image]):
        """N images against ONE query set in ONE dispatch.

        All images of a batch are resized (longer side -> base canvas side)
        and pasted top-left onto a common uint8 [B, S, S, 3] canvas; the
        device builds every pyramid level and returns the packed detections
        of the whole batch — the production serving shape: a fixed catalog
        of queries against a stream of images. Returns a list of per-image
        {"scores", "bboxes"} responses.
        """
        if not images:
            return []
        class_head, num_views = self._build_class_head(queries)

        base_side = int(round(TARGET_IMAGE_SIZE * max(self.pyramid_scales)))
        # pad with the dataset-mean color so the padding normalizes to ~0
        # (neutral), not to a hard black edge (-mean/std) that shifts
        # detections near image borders
        mean_u8 = np.clip(
            np.round(np.asarray(self.img_normalization["mean"]) * 255.0),
            0, 255).astype(np.uint8)
        batch = np.broadcast_to(
            mean_u8, (len(images), base_side, base_side, 3)).copy()
        resized_sizes = []
        for i, image in enumerate(images):
            w, h = image.size
            ratio = base_side / max(w, h)
            new_size = (max(1, int(w * ratio)), max(1, int(h * ratio)))
            resized = image.resize(new_size, Image.BILINEAR)
            arr = np.asarray(resized, np.uint8)
            batch[i, : arr.shape[0], : arr.shape[1]] = arr
            resized_sizes.append(new_size)

        level_sizes, inv_scales = self._level_plan(base_side, base_side)
        det = self._detect_packed(
            batch, class_head, level_sizes, inv_scales, num_views)
        return [
            self._packed_to_response(
                det, i, image.size[0] / rw, image.size[1] / rh,
                image.size[0], image.size[1],
            )
            for i, (image, (rw, rh)) in enumerate(zip(images, resized_sizes))
        ]

    def queries_signature(self, queries: List[Image.Image]) -> tuple:
        """Cheap identity key for a query set (dynamic batching groups only
        requests that share the exact same catalog)."""
        sig = []
        for q in queries:
            h = hashlib.sha1(q.tobytes()).hexdigest()[:16]
            sig.append((q.size, q.mode, h))
        return tuple(sig)

    def detect_from_request(self, payload: dict):
        """Request schema of the reference (app.py:48):
        {"image": {"content": b64}, "query": [{"content": b64}, ...]}"""
        images, queries = parse_request_payload(payload, "image")
        return self.detect(images[0], queries)

    def detect_batch_from_request(self, payload: dict):
        """Batched schema: {"images": [{"content": b64}, ...],
        "query": [{"content": b64}, ...]} -> {"results": [per-image dicts]}."""
        images, queries = parse_request_payload(payload, "images")
        return {"results": self.detect_batch(images, queries)}


class DynamicBatcher:
    """Cross-request dynamic batching.

    Concurrent `detect()` calls whose query sets are identical (byte-wise)
    are grouped within a small window and dispatched as ONE
    `DetectionService.detect_batch` call — the production shape for a fixed
    catalog served against a stream of images. Requests with different query
    sets never share a batch.

    Thread-based and framework-agnostic: the app's handlers call `detect()`
    through a thread pool (see app.py); any other server can do the same.
    """

    def __init__(self, service: DetectionService, max_batch: int = 8,
                 max_wait_ms: float = 10.0):
        self.service = service
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        # requests pulled out of a window whose catalog differed from the
        # window's head; served FIRST next round (FIFO — re-queuing them at
        # the tail would let a sustained majority-catalog stream starve them)
        self._deferred = collections.deque()
        self._closed = False
        # slot completion is claim-once: close() may race a worker that is
        # mid-batch (join below uses a timeout), so both paths must agree on
        # a single winner per request
        self._slot_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _finish(self, item, result=None, error=None):
        """Complete a request exactly once; later attempts are no-ops."""
        slot, done = item[3], item[4]
        with self._slot_lock:
            if slot.get("claimed"):
                return
            slot["claimed"] = True
        slot["result"] = result
        slot["error"] = error
        done.set()

    def detect(self, image: Image.Image, queries: List[Image.Image]) -> dict:
        """Blocking: enqueue and wait for the grouped result."""
        if self._closed:
            raise RuntimeError("DynamicBatcher is closed")
        done = threading.Event()
        slot = {"result": None, "error": None}
        sig = self.service.queries_signature(queries)
        self._queue.put((sig, image, queries, slot, done))
        done.wait()
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def close(self):
        self._closed = True
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout=30)
        # fail any requests the worker left behind instead of letting their
        # detect() calls block forever; the worker also fails its own
        # leftovers on exit, and _finish claims each slot exactly once, so
        # this is safe even if the join timed out mid-batch
        self._fail_pending(
            RuntimeError("DynamicBatcher closed before request was served"))

    def _fail_pending(self, err):
        leftovers = list(self._deferred)
        self._deferred.clear()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                leftovers.append(item)
        for item in leftovers:
            self._finish(item, error=err)

    # ---- worker ----
    def _run(self):
        while not self._closed:
            if self._deferred:
                head = self._deferred.popleft()
            else:
                head = self._queue.get()
                if head is None:
                    continue
            group = [head]
            deadline = time.monotonic() + self.max_wait_s
            # absorb same-catalog deferred requests first, then gather from
            # the live queue until the window closes
            i = 0
            while i < len(self._deferred) and len(group) < self.max_batch:
                if self._deferred[i][0] == head[0]:
                    group.append(self._deferred[i])
                    del self._deferred[i]
                else:
                    i += 1
            while len(group) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:
                    continue
                if item[0] == head[0]:
                    group.append(item)
                else:
                    self._deferred.append(item)

            images = [g[1] for g in group]
            queries = group[0][2]
            try:
                # always the batched path, even for a group of one: detect()
                # (aspect-preserving resize) and detect_batch() (shared
                # square canvas) differ numerically at the margins, and a
                # request's result must not depend on concurrent traffic
                results = self.service.detect_batch(images, queries)
                for g, res in zip(group, results):
                    self._finish(g, result=res)
            except Exception as e:  # noqa: BLE001 - the worker serves on; each caller gets it
                for g in group:
                    self._finish(g, error=e)
        # loop exited because _closed was set: fail anything still pending
        # (covers requests deferred AFTER close() drained the queues)
        self._fail_pending(
            RuntimeError("DynamicBatcher closed before request was served"))
