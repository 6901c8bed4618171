"""Training engine: the train step and the train+val loop.

Counterpart of `os2d_tpu/engine/train.py` (the reference's
os2d/engine/train.py:28-567). One step: normalize the uint8 batch on the
device -> backbone and label branch -> head in train mode -> encode targets
-> remap them on the detached predictions -> objective -> backward (the
resample's gradient is the CUDA kernel csrc/resample_backward.cu on the
card) -> global-norm clip -> optimizer step, skipped when the gradient norm
is not finite (the reference dumps a reproducer and skips,
os2d/engine/train.py:116-131; the momentum state is left as it was).

The model owns its weights and the optimizer its state: the functions here
update both in place where the JAX package returns new pytrees. Gradients
are taken for every parameter, frozen ones included, as JAX differentiates
every leaf (they count in the clipping norm); the optimizer holds only the
trainable ones (`trainable_parameters`). The loop mines hard patches at
cfg.train.mining's boundaries (engine/mining.py) and serves class images
from a device class cache as cfg.tpu.device_class_cache asks
(data/class_cache.py). Over a mesh (parallel/mesh.py) the step is data
parallel and equals the single-process step on the global batch; the loop
evaluates with the mesh and writes its logs and checkpoints on rank 0 only.
Batches go up through pinned host memory on a card (utils/upload.py), their
images as rgb8 or, with cfg.tpu.upload_pixel_format "yuv420", as JAX's 4:2:0
wire (ops/pixel_format.py), which the step decodes straight to float.
cfg.visualization.train's show_gt_boxes_dataloader and show_target_remapping
draw figures of the first batch before training
(`visualize_target_remapping_for_batch`); its show_detections is accepted
and read by nothing, as in the JAX trainer. Checkpoints are written as one
torch.save file (cfg.tpu.checkpoint_backend "pickle") or, for "orbax", as a
torch.distributed.checkpoint tree beside a small stub (utils/logger.py).
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from functools import partial
from typing import Dict, List

import numpy as np
import torch

from ..data.class_cache import DeviceClassCache
from ..models.head import build_class_head
from ..ops.pixel_format import (
    PackedYuv420,
    decode_to_float_rgb,
    decode_wire_to_u8,
    resolve_pixel_format,
    upload_images,
)
from ..parallel.mesh import all_reduce_sum_, gather_rows, local_rows, primary_host
from .decode import default_boxes_for_image_size
from .mining import mine_hard_patches
from .objective import ObjectiveConfig, compute_objective
from .optimization import get_learning_rate, set_learning_rate, setup_lr
from .targets import encode_targets, remap_targets
from .train_graphs import BackboneGraphs
from ..utils.logger import (
    CHECKPOINT_BACKENDS,
    add_to_meters_in_dict,
    checkpoint_model,
    init_log,
    load_checkpoint,
    log_meters,
    print_meters,
    time_since,
)
from ..utils.profiling import annotate
from ..utils.upload import uploader_for


def build_trainable_mask(model, train_cfg) -> Dict[str, bool]:
    """{parameter name: trainable} (os2d_tpu/engine/train.py:503-535; the
    reference's freeze_transform / num_frozen_extractor_blocks,
    os2d/modeling/model.py:56-63): the TransformationNet with
    freeze_transform, the first num_frozen_extractor_blocks blocks of each
    backbone (conv1 + bn1 counts as the first), and both backbones without
    train_features are frozen. BatchNorm's and GroupNorm's tensors train
    like the rest."""
    mask = {name: True for name, _ in model.named_parameters()}

    def freeze(prefix):
        for name in mask:
            if name.startswith(prefix):
                mask[name] = False

    if train_cfg.model.freeze_transform:
        freeze("transform_net.")
    branches = [b for b in ("backbone", "label_backbone") if getattr(model, b) is not None]
    n_frozen = int(train_cfg.model.num_frozen_extractor_blocks)
    for branch in branches:
        net = getattr(model, branch)
        blocks = [[f"{branch}.conv1.", f"{branch}.bn1."]] + [
            [f"{branch}.{layer}.{i}."] for layer in ("layer1", "layer2", "layer3")
            for i in range(len(getattr(net, layer)))]
        for prefixes in blocks[:max(n_frozen, 0)]:
            for prefix in prefixes:
                freeze(prefix)
        if not train_cfg.model.train_features:
            freeze(branch + ".")
    return mask


def trainable_parameters(model, train_cfg) -> List[torch.nn.Parameter]:
    """The parameters the optimizer updates (see `build_trainable_mask`)."""
    mask = build_trainable_mask(model, train_cfg)
    return [p for name, p in model.named_parameters() if mask[name]]


def _normalize_u8(x, mean, std):
    """uint8 RGB, or a PackedYuv420 wire decoded straight to float (JAX's
    loss_fn._norm, os2d_tpu/engine/train.py:131-141), -> normalized float."""
    return (decode_to_float_rgb(x) / 255.0 - mean) / std


class TrainStep:
    """One optimizer step per call on a prepared batch
    (os2d_tpu/engine/train.py:93-233). The model is put in train mode (every
    parameter requires a gradient); a folded model raises there. The forward
    runs at the model's compute dtype, as JAX's step runs at
    model_cfg.dtype (os2d_tpu/engine/train.py:149-166): parameters and the
    optimizer's state stay fp32, the bf16 casts sit inside the forward, and
    autograd returns fp32 gradients to the fp32 leaves, as jax.grad does.
    At resample_precision "int8", which has no gradient, the step runs the
    "default" tier, as JAX's train-mode head does (ops/resample_grad.py).

    With a `mesh` the step is data parallel, and computes what the
    single-process step computes on the global batch (as XLA's sharded step
    does, os2d_tpu/engine/train.py:859-935). Every rank gets the whole batch
    and runs the backbone, the label branch and the head on its own rows of
    images. `loc`, `cls` and `cls_detached` of the whole batch are then
    gathered (`gather_rows`, whose backward keeps the rank's own rows), and
    targets, remapping and the objective are computed on the global batch,
    identically on every rank: the objective couples the batch (one
    hard-negative ranking over every image, class and anchor; num_pos and
    RLL's negative weights summed over it), so a mean of per-rank losses
    would not equal it. The gradients are summed over the ranks before the
    clip, so every rank takes the same update and the ranks' weights stay
    equal to the bit."""

    def __init__(self, model, objective_cfg: ObjectiveConfig, optimizer, train_cfg, mesh=None):
        self.model = model.train_mode(True)
        self.mesh = mesh
        self.objective_cfg = objective_cfg
        self.optimizer = optimizer
        self.train_cfg = train_cfg
        config = model.config
        self.mean = torch.tensor(config.normalization_mean, dtype=torch.float32,
                                 device=model.device)
        self.std = torch.tensor(config.normalization_std, dtype=torch.float32,
                                device=model.device)
        self.backbone_graphs = BackboneGraphs()

    def __call__(self, batch_arrays, num_classes: int) -> Dict[str, float]:
        """Forward, backward, clip and update on `batch_arrays` (from
        `prepare_batch_arrays`, num_classes its padded class count). Returns
        the loss terms and the gradient norm (before clipping) as floats:
        reading them, and deciding whether the update is finite, is the
        step's one read-back (span `os2d.wait.step_metrics`); its other
        host waits are the copies of a few host constants in the class head
        and the head (`os2d.wait.constant`). Its phases run in spans
        `os2d.train.zero_grad`, `.forward`, `.targets`, `.objective`,
        `.backward`, `.clip`, `.optimizer` and `.release` (the graph and
        the activations freed).

        On a card the backbone's two passes (the scenes, the class images)
        replay CUDA graphs of their forward and backward
        (`backbone_graphs`, engine/train_graphs.py): a new shape runs eager
        once, is recorded the next time and replayed after, the same kernels
        as the eager pass without their launches from Python.

        Two steps from one state on one batch agree to the bit under the
        port's defaults: the resample's backward sums in a fixed order, and
        every convolution's gradients repeat (models/resnet.py:
        conv2d_backward), at about 2% more time a step than cuDNN's default
        algorithms at the default recipe on an H100 (PERF.md)."""
        model, tcfg, mesh = self.model, self.train_cfg, self.mesh
        mean, std = self.mean, self.std
        with annotate("os2d.train.zero_grad"):
            for p in model.parameters():
                p.grad = None

        with annotate("os2d.train.forward"):
            images = batch_arrays["images"]
            if mesh is not None:
                # rows of a wire cannot be sliced: it decodes to uint8 up
                # front, as JAX's mesh paths do (os2d_tpu/engine/train.py:677-688)
                if isinstance(images, PackedYuv420):
                    images = decode_wire_to_u8(images)
                images = images[local_rows(mesh, images.shape[0])]
            detached = not tcfg.model.train_features
            graphs = self.backbone_graphs
            fm = graphs("backbone", model.backbone, _normalize_u8(images, mean, std), detached)
            class_fm = graphs("label_branch", model.label_branch,
                              _normalize_u8(batch_arrays["class_images"], mean, std), detached)
            if detached:
                fm, class_fm = fm.detach(), class_fm.detach()
            out = model.apply_head(fm, build_class_head(class_fm))
            if mesh is not None:
                out = {k: gather_rows(mesh, out[k]) for k in ("loc", "cls", "cls_detached")}

        with annotate("os2d.train.targets"):
            obj = tcfg.objective
            gt = (batch_arrays["gt_boxes"], batch_arrays["gt_labels"],
                  batch_arrays["gt_difficult"], batch_arrays["gt_valid"])
            default_boxes = batch_arrays["default_boxes"]
            loc_t, cls_t = encode_targets(*gt, default_boxes, num_classes,
                                          float(obj.positive_iou_threshold),
                                          float(obj.negative_iou_threshold))
            cls_remapped, _, _ = remap_targets(
                out["loc"].detach(), *gt, default_boxes,
                float(obj.remap_classification_targets_iou_pos),
                float(obj.remap_classification_targets_iou_neg))
            # padded class rows are ignored everywhere
            cvalid = batch_arrays["class_valid"][None, :, None]
            cls_t = torch.where(cvalid, cls_t, -1)
            cls_remapped = torch.where(cvalid, cls_remapped, -1)
        with annotate("os2d.train.objective"):
            losses = compute_objective(
                self.objective_cfg, out["loc"], loc_t, out["cls"], cls_t,
                cls_targets_remapped=cls_remapped,
                cls_preds_for_neg=(None if tcfg.model.train_transform_on_negs
                                   else out["cls_detached"]))
        with annotate("os2d.train.backward"):
            losses["loss"].backward()

        with annotate("os2d.train.clip"):
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            if mesh is not None:
                all_reduce_sum_(mesh, grads)
            grad_norm = torch.sqrt(torch.stack([g.square().sum() for g in grads]).sum())
            # torch-style clip_grad_norm_
            scale = torch.clamp(float(tcfg.optim.max_grad_norm) / (grad_norm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, scale)
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["grad_norm"] = grad_norm
            keys = sorted(metrics)
        with annotate("os2d.wait.step_metrics"):
            values = dict(zip(keys, torch.stack([metrics[k] for k in keys]).tolist()))
        if math.isfinite(values["grad_norm"]):
            with annotate("os2d.train.optimizer"):
                self.optimizer.step()
        with annotate("os2d.train.release"):
            # the graph and the activations go here, not as the frame returns
            del fm, class_fm, out, losses
        return values


def pad_class_batch(class_images, num_real: int, pad_to: int):
    """Stack same-shape class images and pad to a static class count (dtype
    kept: uint8 batches normalize on the device)."""
    arr = np.stack(class_images, 0)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.float32)
    if num_real < pad_to:
        arr = np.concatenate([arr, np.zeros((pad_to - num_real,) + arr.shape[1:], arr.dtype)], 0)
    valid = np.zeros((pad_to,), bool)
    valid[:num_real] = True
    return arr, valid


def prepare_batch_arrays(batch, device, class_pad_multiple: int = 4, pixel_format: str = "auto",
                         uploader=None):
    """Host batch dict (from the dataloader) -> (tensors on `device`, padded
    class count), uploaded by `uploader` (a `utils.upload.Uploader` for
    `device`; None takes `uploader_for(device)` of the calling thread), as
    JAX's go through parallel_device_put (os2d_tpu/engine/train.py:573-662).
    The images go up as uint8 RGB for pixel_format "auto" and "rgb8"; for
    "yuv420" a uint8 batch of even H and W goes up as JAX's wire and comes
    back as a PackedYuv420, which `TrainStep` decodes in its preamble
    (`ops.pixel_format.upload_images`). A batch from a loader with a device
    class cache carries no class images: its class_gather resolves them on
    the cache's device (os2d_tpu/engine/train.py:607-620). Runs in span
    `os2d.train.upload`."""
    with annotate("os2d.train.upload"):
        resolve_pixel_format(pixel_format)
        class_images = batch["class_images"]
        c_real = len(batch["class_ids"])
        c_pad = max(class_pad_multiple,
                    math.ceil(c_real / class_pad_multiple) * class_pad_multiple)
        uploader = uploader or uploader_for(device)
        up = uploader.upload

        if class_images is None:
            # a device class cache (data/class_cache.py): the class tensor is
            # picked and flipped on its device, only the indices cross
            g = batch["class_gather"]
            class_tensor = g["cache"].gather(g["class_ids"], g["method_idx"], g["hflip"],
                                             g["vflip"], c_pad).to(device)
            class_valid = np.arange(c_pad) < c_real
        else:
            if len({im.shape for im in class_images}) != 1:
                raise ValueError("train batches need one class-image shape; configure the train "
                                 "dataloader with a one-entry class shape palette")
            class_arr, class_valid = pad_class_batch(class_images, c_real, c_pad)
            class_tensor = up(class_arr)

        arrays = {
            "images": upload_images(uploader, batch["images"], pixel_format),
            "class_images": class_tensor,
            "class_valid": up(class_valid),
            "gt_boxes": up(batch["gt_boxes"]),
            "gt_labels": up(batch["gt_labels"]).long(),
            "gt_difficult": up(batch["gt_difficult"]),
            "gt_valid": up(batch["gt_valid"]),
            "default_boxes": default_boxes_for_image_size(batch["img_size"], device=device),
        }
        return arrays, c_pad


def dump_nan_reproducer(dump_dir, batch_arrays, model, optimizer, num_classes, extra=None,
                        mesh=None):
    """Everything needed to replay a step whose gradient was not finite, in
    error_nan_appeared-<timestamp>.pth (the reference's dump,
    os2d/engine/train.py:116-129): the batch, the weights and the optimizer
    state (both as they were before the step: its update was skipped).
    Reload with `load_nan_reproducer`. Over a mesh every rank reaches the
    dump (the gradient norm is summed over the ranks) and `batch_arrays` is
    the global batch that every rank holds, so a replay needs no other
    rank; each rank's file ends in -p<rank>, so that equal dumps on shared
    storage do not overwrite each other (os2d_tpu/engine/train.py:451-464)."""
    import datetime

    ts = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    proc = f"-p{mesh.rank}" if mesh is not None and mesh.size > 1 else ""
    path = os.path.join(dump_dir or ".", f"error_nan_appeared-{ts}{proc}.pth")
    # a yuv420 wire is kept as it was uploaded, with its logical shape
    wire_shapes = {k: list(v.shape) for k, v in batch_arrays.items()
                   if isinstance(v, PackedYuv420)}
    torch.save({
        "batch_arrays": {k: (v.data if k in wire_shapes else v).cpu()
                         for k, v in batch_arrays.items()},
        "wire_shapes": wire_shapes,
        "net": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "num_classes": int(num_classes),
        "extra": extra,
    }, path)
    return path


def load_nan_reproducer(path, device="cuda"):
    """A dump of `dump_nan_reproducer` with the batch on `device`, the card
    by default (as JAX's loader puts it on the default device,
    os2d_tpu/engine/train.py:480-495); it raises without one rather than
    load onto the CPU, which device="cpu" asks for. Replay:
        d = load_nan_reproducer(path, model.device)
        model.load_state_dict(d["net"]); optimizer.load_state_dict(d["optimizer"])
        train_step(d["batch_arrays"], d["num_classes"])
    (the reference's reload snippet, os2d/engine/train.py:131-139)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_nan_reproducer targets CUDA by default and no CUDA device "
                           "is available; pass device='cpu' to load the batch on the CPU")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    shapes = payload.get("wire_shapes", {})
    payload["batch_arrays"] = {
        k: PackedYuv420(v.to(device), shapes[k]) if k in shapes else v.to(device)
        for k, v in payload["batch_arrays"].items()}
    return payload


class BatchPrefetcher:
    """Background-thread batch preparation (os2d_tpu/engine/train.py:751-856):
    overlaps the host-side PIL augmentation with the device step.
    `prepare_fn(batch)`, if given, runs in the worker thread after the host
    pipeline (the upload). With `workers > 1` batches are built in a thread
    pool and still delivered in scheduled order; the augmentation draws then
    interleave across threads, so batch contents are no longer reproducible
    (cfg.tpu.train_loader_workers, off by default)."""

    def __init__(self, dataloader, depth: int = 2, prepare_fn=None, workers: int = 1):
        self.dataloader = dataloader
        self.prepare_fn = prepare_fn
        self.workers = max(1, int(workers))
        self._request = queue.Queue()
        if self.workers == 1:
            self._queue = queue.Queue(maxsize=depth)
            self._threads = [threading.Thread(target=self._worker, daemon=True)]
        else:
            self._cv = threading.Condition()
            self._results = {}
            self._order = []
            self._next_ticket = 0
            self._slots = threading.Semaphore(max(depth, self.workers))
            self._threads = [threading.Thread(target=self._pool_worker, daemon=True)
                             for _ in range(self.workers)]
        for t in self._threads:
            t.start()

    def _build(self, index):
        try:
            batch = self.dataloader.get_batch(index)
            return index, batch, self.prepare_fn(batch) if self.prepare_fn else None
        except Exception as e:  # surfaced to the consumer by get()
            return index, e, None

    def _worker(self):
        while True:
            index = self._request.get()
            if index is None:
                return
            self._queue.put(self._build(index))

    def _pool_worker(self):
        while True:
            item = self._request.get()
            if item is None:
                return
            ticket, index = item
            self._slots.acquire()
            result = self._build(index)
            with self._cv:
                self._results[ticket] = result
                self._cv.notify_all()

    def schedule(self, index: int):
        if self.workers == 1:
            self._request.put(index)
        else:
            self._request.put((self._next_ticket, index))
            self._order.append(self._next_ticket)
            self._next_ticket += 1

    def get(self):
        if self.workers == 1:
            index, batch, prepared = self._queue.get()
        else:
            ticket = self._order.pop(0)
            with self._cv:
                while ticket not in self._results:
                    self._cv.wait()
                index, batch, prepared = self._results.pop(ticket)
            self._slots.release()
        if isinstance(batch, Exception):
            raise batch
        return index, batch, prepared

    def close(self):
        for _ in self._threads:
            self._request.put(None)


def train_one_batch(batch, train_step: TrainStep, logger, dump_dir=None, prepared=None):
    """One training iteration (os2d/engine/train.py:47-139). `prepared` takes
    (arrays, c_pad) from prepare_batch_arrays when a prefetcher already
    uploaded the batch; over the train step's mesh, `batch` is the global
    batch on every rank. Returns the meters (losses, grad_norm, batch_time)."""
    t_start = time.time()
    model = train_step.model
    arrays, c_pad = prepared if prepared is not None else prepare_batch_arrays(
        batch, model.device)
    meters = train_step(arrays, c_pad)
    if not math.isfinite(meters["grad_norm"]):
        # the step skipped the update; the weights and optimizer state are the
        # step's inputs
        dump_path = dump_nan_reproducer(dump_dir, arrays, model, train_step.optimizer, c_pad,
                                        extra={"meters": meters}, mesh=train_step.mesh)
        logger.error(f"gradient is not finite; the update was skipped. Saved reproducer to "
                     f"{dump_path}; reload with os2d_torch.engine.train.load_nan_reproducer")
    meters["batch_time"] = time.time() - t_start
    return meters


def evaluate_model(dataloaders_eval, model, cfg, criterion=None, print_per_class_results=False,
                   mesh=None):
    from .evaluate import evaluate

    return {loader.get_name(): evaluate(loader, model, cfg, criterion=criterion,
                                        print_per_class_results=print_per_class_results,
                                        mesh=mesh)
            for loader in dataloaders_eval if loader is not None}


def visualize_target_remapping_for_batch(batch_arrays, num_classes, model, train_cfg, out_dir,
                                         objective_cfg=None):
    """Figures of the step's target encoding and remapping for one prepared
    batch, one per (image, label) with a positive target, saved under
    `out_dir` (the reference's train.py:96-97 -> visualization.py:85-137;
    os2d_tpu/engine/train.py:318-430). Runs the forward once with the model
    in train mode, as the step does (so the "int8" tier runs "default").
    With `objective_cfg` the figures add the anchor IoU maps, the per-anchor
    classification loss and the loss's gradients with respect to the score
    maps, with and without the transform detached (`torch.autograd.grad`
    with the targets fixed, where JAX takes jax.grad). A yuv420 wire decodes
    to uint8 first, as JAX's figures do (os2d_tpu/engine/train.py:333).
    Returns the paths."""
    from ..utils.visualization import show_target_remapping

    mean = torch.tensor(model.config.normalization_mean, dtype=torch.float32,
                        device=model.device)
    std = torch.tensor(model.config.normalization_std, dtype=torch.float32, device=model.device)
    if isinstance(batch_arrays["images"], PackedYuv420):
        batch_arrays = dict(batch_arrays, images=decode_wire_to_u8(batch_arrays["images"]))

    def _norm(x):
        return _normalize_u8(x, mean, std) if x.dtype == torch.uint8 else x

    model.train_mode(True)
    images_n = _norm(batch_arrays["images"])
    fm = model.backbone(images_n)
    class_head = build_class_head(model.label_branch(_norm(batch_arrays["class_images"])))
    out = {k: v.detach() if torch.is_tensor(v) else v
           for k, v in model.apply_head(fm, class_head).items()}
    obj = train_cfg.objective
    gt = (batch_arrays["gt_boxes"], batch_arrays["gt_labels"], batch_arrays["gt_difficult"],
          batch_arrays["gt_valid"])
    default_boxes = batch_arrays["default_boxes"]
    loc_t, cls_t = encode_targets(*gt, default_boxes, num_classes,
                                  float(obj.positive_iou_threshold),
                                  float(obj.negative_iou_threshold))
    cls_remapped, ious_anchor, ious_corrected = remap_targets(
        out["loc"], *gt, default_boxes, float(obj.remap_classification_targets_iou_pos),
        float(obj.remap_classification_targets_iou_neg))

    loss_map = grad_map = grad_det_map = None
    if objective_cfg is not None:
        cvalid = batch_arrays["class_valid"][None, :, None]
        scores = out["cls"].clone().requires_grad_()
        scores_detached = out["cls_detached"].clone().requires_grad_()
        losses, per_anchor = compute_objective(
            objective_cfg, out["loc"], loc_t, scores, torch.where(cvalid, cls_t, -1),
            cls_targets_remapped=torch.where(cvalid, cls_remapped, -1),
            cls_preds_for_neg=scores_detached, want_per_anchor=True)
        grad_map, grad_det_map = (g.cpu().numpy() for g in torch.autograd.grad(
            losses["loss"], [scores, scores_detached]))
        loss_map = per_anchor["cls_loss"].cpu().numpy()

    fm_h, fm_w = fm.shape[1], fm.shape[2]
    os.makedirs(out_dir, exist_ok=True)
    class_valid = batch_arrays["class_valid"].cpu().numpy()
    cls_scores = out["cls"].cpu().numpy()
    cls_t = cls_t.cpu().numpy()
    cls_remapped = cls_remapped.cpu().numpy()
    ious_anchor = ious_anchor.cpu().numpy()
    ious_corrected = ious_corrected.cpu().numpy()
    images_n = images_n.detach().cpu().numpy()

    def _fm(arr, i, l):
        return None if arr is None else arr[i, l].reshape(fm_h, fm_w)

    saved = []
    for i in range(cls_scores.shape[0]):
        for l in range(cls_scores.shape[1]):
            # only the labels with a positive target somewhere
            if not class_valid[l] or not (cls_t[i, l] == 1).any():
                continue
            saved.append(show_target_remapping(
                images_n[i], _fm(cls_scores, i, l), _fm(cls_t, i, l), _fm(cls_remapped, i, l),
                ious_anchor=_fm(ious_anchor, i, l), ious_corrected=_fm(ious_corrected, i, l),
                loss_per_anchor=_fm(loss_map, i, l), grad_scores=_fm(grad_map, i, l),
                grad_scores_detached=_fm(grad_det_map, i, l),
                save_path=os.path.join(out_dir, f"remap_img{i}_lbl{l}.png")))
    return saved


def show_batch_gt_boxes(batch0, out_dir):
    """Figures of the GT boxes of a train batch (reference dataloader.py:135;
    os2d_tpu/engine/train.py:1048-1065)."""
    from ..utils.visualization import show_gt_boxes

    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(batch0["images"])):
        valid = np.asarray(batch0["gt_valid"][i])
        show_gt_boxes(np.asarray(batch0["images"][i]), np.asarray(batch0["gt_boxes"][i])[valid],
                      labels=np.asarray(batch0["gt_labels"][i])[valid],
                      difficult=np.asarray(batch0["gt_difficult"][i])[valid],
                      save_path=os.path.join(out_dir, f"gt_batch0_img{i}.png"))


def attach_device_class_cache(dataloader, cfg, device, logger):
    """Build the device class cache on `device` and attach it to the train
    dataloader when training, as cfg.tpu.device_class_cache asks (case and
    synonyms normalized as the JAX package does, so that an override such
    as 'False' or 'OFF' cannot fall through to "auto";
    os2d_tpu/engine/train.py:1016-1041): "required" (or True) raises where
    the cache cannot serve the recipe; "auto" falls back to class images
    built on the host, and logs why, on an incompatible augmentation recipe
    or a stack over cfg.tpu.device_class_cache_budget_mb; "off" (or False)
    builds none."""
    mode = str(cfg.tpu.device_class_cache).lower()
    if mode in ("false", "off", "0", "no", "none"):
        mode = "off"
    elif mode in ("true", "1", "yes", "required"):
        mode = "required"
    elif mode != "auto":
        raise ValueError(f"tpu.device_class_cache={cfg.tpu.device_class_cache!r}: expected "
                         "one of auto / True (required) / False (off)")
    if mode == "off" or not cfg.train.do_training:
        return
    try:
        dataloader.attach_device_class_cache(DeviceClassCache.build(
            dataloader, device, budget_mb=int(cfg.tpu.device_class_cache_budget_mb)))
    except ValueError as e:
        if mode == "required":
            raise
        logger.info("device class cache disabled (auto): %s", e)


def trainval_loop(dataloader_train, model, cfg, objective_cfg, optimizer, dataloaders_eval=(),
                  start_iter=0, full_log=None, mesh=None):
    """Main train+val loop (os2d/engine/train.py:400-567;
    os2d_tpu/engine/train.py:986-1374): evaluation (with the loss metrics of
    `criterion=objective_cfg`) every cfg.eval.iter iterations, the LR
    schedule, best-model and periodic checkpoints, then a final evaluation.
    start_iter / full_log resume from a checkpoint. The model and optimizer
    are updated in place. Batches are prepared and uploaded by a background
    thread up to cfg.tpu.train_steps_per_dispatch ahead, never past a mining
    boundary; the steps run one after another (the JAX package's K-step
    dispatch computes the same steps). With cfg.train.mining.do_mining,
    hard patches are mined (from the model as it trains) at every
    mine_hard_patches_iter-th iteration, iteration 0 included, and the
    batches after replay them. cfg.tpu.device_class_cache ("auto" by
    default) attaches a device class cache (`attach_device_class_cache`).

    With a `mesh` (parallel/mesh.py; main.py builds it from
    cfg.tpu.mesh_data_axis) every rank runs this loop on the same global
    batches: the step is data parallel (`TrainStep`), evaluation shards
    classes or images as cfg.tpu.eval_shard_axis says, mining runs whole on
    every rank from its identically seeded loader, and only rank 0 writes
    logs and checkpoints (os2d_tpu/engine/train.py:986-1078). A one-rank
    mesh is dropped; train.batch_size must divide over the ranks.
    Returns (full_log, meters_eval of the final evaluation)."""
    pixel_format = resolve_pixel_format(cfg.tpu.upload_pixel_format)
    backend = str(cfg.tpu.checkpoint_backend)
    if backend not in CHECKPOINT_BACKENDS:
        raise ValueError(f"unknown cfg.tpu.checkpoint_backend {backend!r}: expected one of "
                         f"{CHECKPOINT_BACKENDS}")
    checkpoint = partial(checkpoint_model, backend=backend)
    logger = logging.getLogger("OS2D.train")
    if mesh is not None:
        if mesh.size <= 1:
            mesh = None
        elif cfg.train.do_training and cfg.train.batch_size % mesh.size:
            raise ValueError(f"train.batch_size={cfg.train.batch_size} must be divisible by "
                             f"the mesh size {mesh.size} for data-parallel training")
        else:
            logger.info(f"Data-parallel training over {mesh.size} ranks "
                        f"({cfg.train.batch_size // mesh.size} images/rank)")
    t_start = time.time()
    do_mining = bool(cfg.train.mining.do_mining)
    mine_iter = int(cfg.train.mining.mine_hard_patches_iter)
    attach_device_class_cache(dataloader_train, cfg, model.device, logger)
    prep = partial(prepare_batch_arrays, device=model.device, pixel_format=pixel_format,
                   uploader=uploader_for(model.device))
    # figures of the first batch, each drawing it again from the loader as
    # JAX's loop does; every rank draws it, so that the ranks' loaders stay
    # in step, and rank 0 draws the figures
    viz = cfg.visualization.train
    if viz.show_gt_boxes_dataloader and cfg.output.path and len(dataloader_train) > 0:
        batch0 = dataloader_train.get_batch(0)
        if primary_host():
            show_batch_gt_boxes(batch0, os.path.join(cfg.output.path, "viz_dataloader"))
    if viz.show_target_remapping and cfg.output.path and len(dataloader_train) > 0:
        batch0 = dataloader_train.get_batch(0)
        if primary_host():
            batch_arrays, n_cls = prep(batch0)
            visualize_target_remapping_for_batch(batch_arrays, n_cls, model, cfg.train,
                                                 os.path.join(cfg.output.path, "viz_remapping"),
                                                 objective_cfg=objective_cfg)
    full_log = full_log if full_log is not None else init_log()
    num_steps_for_logging, meters_running = 0, {}
    train_step = TrainStep(model, objective_cfg, optimizer, cfg.train, mesh=mesh)
    best_model_metric = best_model_dataset_name = None
    checkpoint_best_model_name = checkpoint_best_model_path = None
    max_iter = int(cfg.train.optim.max_iter)

    if max_iter > 0 and cfg.train.do_training:
        logger.info("Start training")
        anneal_lr_func = setup_lr(full_log, cfg.train.optim.anneal_lr, cfg.eval.iter,
                                  initial_steps=start_iter // max(cfg.eval.iter, 1))
        meters_eval = evaluate_model(dataloaders_eval, model, cfg, criterion=objective_cfg,
                                     mesh=mesh)
        best = cfg.output.best_model
        if best.do_get_best_model:
            if not cfg.output.path:
                raise RuntimeError("cfg.output.best_model.do_get_best_model requires "
                                   "cfg.output.path")
            best_model_dataset_name = best.dataset or cfg.eval.dataset_names[0]
            best_model_metric = meters_eval[best_model_dataset_name][best.metric]
            logger.info(f"Init model is the current best on {best_model_dataset_name} by "
                        f"{best.metric}, value {best_model_metric:.4f}")
            checkpoint_best_model_name = f"best_model_{best_model_dataset_name}_{best.metric}"
            checkpoint_best_model_path = checkpoint(
                model, optimizer, cfg.output.path, model_name=checkpoint_best_model_name,
                extra_fields={"criterion_value": best_model_metric})
        if start_iter == 0:
            log_meters(full_log, t_start, -1, cfg.output.path, meters_eval=meters_eval)
            if cfg.output.path:
                checkpoint(model, optimizer, cfg.output.path, i_iter=0,
                                 full_log=full_log)

        ahead_max = max(1, int(cfg.tpu.train_steps_per_dispatch))
        prefetcher = BatchPrefetcher(dataloader_train, depth=ahead_max + 1, prepare_fn=prep,
                                     workers=int(cfg.tpu.train_loader_workers))
        pending = 0  # batches scheduled on the prefetcher, not yet fetched
        i_epoch, i_batch, i_iter = 0, len(dataloader_train), start_iter
        while i_iter < max_iter:
            if i_batch >= len(dataloader_train):
                i_epoch += 1
                i_batch = 0
                dataloader_train.shuffle()  # nothing is scheduled here
            if do_mining and i_iter % mine_iter == 0:
                # nothing is scheduled here either: a batch built before
                # mining would replay stale records
                dataloader_train.set_hard_negative_data(
                    mine_hard_patches(dataloader_train, model, cfg, objective_cfg))
            logger.info(f"Iter {i_iter} ({max_iter}), epoch {i_epoch}, "
                        f"time {time_since(t_start)}")
            t_load = time.time()
            if pending == 0:
                prefetcher.schedule(i_batch)
                pending = 1
            pending -= 1
            _, batch, prepared = prefetcher.get()
            loading_time = time.time() - t_load
            i_batch += 1
            # schedule ahead within this epoch and never past a mining boundary
            ahead = min(ahead_max, len(dataloader_train) - i_batch, max_iter - i_iter - 1)
            if do_mining:
                ahead = min(ahead, (mine_iter - (i_iter + 1) % mine_iter) % mine_iter)
            while pending < ahead:
                prefetcher.schedule(i_batch + pending)
                pending += 1

            meters = train_one_batch(batch, train_step, logger,
                                     dump_dir=cfg.output.path or None, prepared=prepared)
            meters["loading_time"] = loading_time
            if i_iter % cfg.output.print_iter == 0:
                print_meters(meters, logger)
            add_to_meters_in_dict(meters, meters_running)
            num_steps_for_logging += 1

            if (i_iter + 1) % cfg.eval.iter == 0:
                meters_eval = evaluate_model(dataloaders_eval, model, cfg,
                                             criterion=objective_cfg, mesh=mesh)
                if best.do_get_best_model:
                    cur = meters_eval[best_model_dataset_name][best.metric]
                    if (cur > best_model_metric if best.mode == "max"
                            else cur < best_model_metric):
                        logger.info(f"New best model on {best_model_dataset_name}: "
                                    f"{cur:.4f}")
                        checkpoint_best_model_path = checkpoint(
                            model, optimizer, cfg.output.path,
                            model_name=checkpoint_best_model_name,
                            extra_fields={"criterion_value": cur})
                        best_model_metric = cur
                for k in meters_running:
                    meters_running[k] /= num_steps_for_logging
                old_lr = get_learning_rate(optimizer)
                meters_running["lr"] = old_lr
                log_meters(full_log, t_start, i_iter, cfg.output.path,
                           meters_running=meters_running, meters_eval=meters_eval)
                new_lr = anneal_lr_func(
                    i_iter + 1, old_lr,
                    anneal_now=i_iter > cfg.train.optim.anneal_lr.initial_patience)
                if new_lr != old_lr:
                    if (cfg.train.optim.anneal_lr.reload_best_model_after_anneal_lr
                            and checkpoint_best_model_path):
                        if mesh is not None:
                            mesh.barrier()  # rank 0 has written the best model
                        ckpt = load_checkpoint(checkpoint_best_model_path)
                        model.load_state_dict(ckpt["net"])
                        if ckpt.get("optimizer") is not None:
                            optimizer.load_state_dict(ckpt["optimizer"])
                    set_learning_rate(optimizer, new_lr)
                num_steps_for_logging, meters_running = 0, {}

            if (cfg.output.path and cfg.output.save_iter
                    and i_iter % cfg.output.save_iter == 0):
                checkpoint(model, optimizer, cfg.output.path, i_iter=i_iter,
                                 full_log=full_log)
            i_iter += 1
        while pending:
            prefetcher.get()
            pending -= 1
        prefetcher.close()

    logger.info("Final evaluation")
    meters_eval = evaluate_model(dataloaders_eval, model, cfg, print_per_class_results=True,
                                 mesh=mesh)
    if max_iter > 0 and cfg.train.do_training:
        log_meters(full_log, t_start, max_iter, cfg.output.path, meters_eval=meters_eval)
        if cfg.output.path:
            checkpoint(model, optimizer, cfg.output.path, i_iter=max_iter,
                             full_log=full_log)
    return full_log, meters_eval
