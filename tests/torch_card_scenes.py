"""Scenes, datasets, recipes and comparisons shared by the card tests
(tests/test_torch_*_card.py); tests/test_torch_card_scenes.py holds the
writers to their contents on the CPU. Nothing is written at import: each
writer takes a directory, and the card modules call them inside fixtures.
The module imports the port, torch, numpy, pandas and PIL, and no JAX.

- The planted scenes of tests/test_end_to_end_eval.py: two 640x480 noise
  scenes, three 240-px patches of two classes at anchor-aligned places.
  With random weights and the identity-initialized aligner a planted patch
  is the top detection of its class.
- A planted training set: TRAIN_CLASSES 240-px class patches in
  TRAIN_IMAGES scenes of TRAIN_SIZE px, one patch in each cell of a 2x2
  grid, so that the default recipe's 600-px crops keep the patches near
  the 240-px anchor size and the remapped targets hold positives.
- HOST_SCENES planted 1280x960 scenes for evaluate()'s host side, a
  synthetic ImageFolder for the pretrainer, and a planted tree in the GroZi
  layout for the experiment launchers and the release runbook.
"""

import base64
import os
from io import BytesIO

import numpy as np
import pandas as pd
import torch
from PIL import Image

PATCH = 240
PLANTED = {0: [(48, 48, 0)], 1: [(336, 176, 1), (48, 112, 0)]}  # image: [(x0, y0, class)]
EVAL_PYRAMID = [0.8, 1.0]
EVAL_TTA = "horflip_rotation90"
EVAL_SCORE_THRESHOLD = 0.5
IMG_W, IMG_H = 1280, 960
PYRAMID = [0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6]  # the benchmark's eval protocol
NUM_CLASSES, BATCH = 16, 2
TRAIN_CLASSES, TRAIN_IMAGES, TRAIN_SIZE = 16, 8, 640
TRAIN_STEPS = 4
TRAIN_CPU_RTOL = 2e-3  # a train step's loss and gradient norm, card against CPU
# random weights score every anchor far above the recipe's margin_pos 0.6,
# so no positive has a loss and the cls gradient (the backward kernel's
# dpx/dpy) is zero; a first step held card against CPU takes 1.0
FIRST_STEP_MARGIN_POS = 1.0
HOST_SCENES = 48
PRETRAIN_CLASSES, PRETRAIN_PER_CLASS = 10, 32
# the GroZi layout: scenes at GroZi's source size read at the published
# 1280 px, where a source pixel is 1280/3264 of a level-1.0 pixel; class
# patches of GROZI_BLOCKS x GROZI_BLOCKS blocks of GROZI_SOURCE_BLOCK px
# (GROZI_LEVEL_BLOCK px at level 1.0: 240 px a patch), planted at level-1.0
# positions on multiples of 80 px, as (x0, y0, class) per image
GROZI_SOURCE = (3264, 2448)
GROZI_BLOCKS, GROZI_LEVEL_BLOCK, GROZI_SOURCE_BLOCK = 12, 20, 51
GROZI_PLANTED = {
    0: ("val-new-cl", [(80, 80, 0), (720, 400, 1)]),
    1: ("val-new-cl", [(400, 160, 2), (880, 560, 3)]),
    2: ("train", [(80, 80, 0), (720, 400, 1)]),
    3: ("train", [(400, 160, 2), (880, 560, 3)]),
    4: ("train", [(160, 400, 1), (800, 80, 3)]),
    5: ("train", [(560, 480, 0), (80, 640, 2)]),
}
# the reference TransformationNet's modules for the port's (models/checkpoint.py)
REFERENCE_TRANSFORM_NET = {"conv0": "conv.0", "bn0": "conv.1", "conv1": "conv.3",
                           "bn1": "conv.4", "linear": "linear"}


# ---- the writers ----

def _patch(rng, side=PATCH):
    """A patch of 8-px blocks of seeded random colours."""
    return np.kron(rng.randint(0, 255, (side // 8, side // 8, 3), np.uint8),
                   np.ones((8, 8, 1), np.uint8))


def _row(image_id, image_file, cid, class_file, n, box, split=None):
    lx, ty, rx, by = box
    row = dict(imageid=image_id, imagefilename=image_file, classid=cid,
               classfilename=class_file, gtbboxid=n, difficult=0, lx=lx, ty=ty, rx=rx, by=by)
    if split is not None:
        row["split"] = split
    return row


def _save(array, *parts):
    path = os.path.join(*parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(array).save(path, quality=95)


def planted_scenes():
    """(the two 640x480 scenes [2, 480, 640, 3], the two class patches) of
    tests/test_end_to_end_eval.py (same seed, same draws)."""
    rng = np.random.RandomState(0)
    patches = [_patch(rng) for _ in range(2)]
    scenes = []
    for image_id in sorted(PLANTED):
        scene = rng.randint(0, 60, (480, 640, 3), np.uint8)
        for x0, y0, cid in PLANTED[image_id]:
            scene[y0:y0 + PATCH, x0:x0 + PATCH] = patches[cid]
        scenes.append(scene)
    return np.stack(scenes), patches


def write_planted_dataset(root, scale=1):
    """The planted scenes as JPEG files (quality 95) under root/src, the
    patches under root/classes/images, and their CSV-schema dataframe; with
    an integer `scale` the scenes are written that many times larger (pixel
    replication), the class patches as they are."""
    scenes, patches = planted_scenes()
    scenes = np.kron(scenes, np.ones((1, scale, scale, 1), np.uint8))
    for cid, patch in enumerate(patches):
        _save(patch, root, "classes", "images", f"class{cid}.jpg")
    rows = []
    for image_id, plants in sorted(PLANTED.items()):
        for x0, y0, cid in plants:
            rows.append(_row(image_id, f"img{image_id}.jpg", cid, f"class{cid}.jpg", len(rows),
                             (x0 / 640, y0 / 480, (x0 + PATCH) / 640, (y0 + PATCH) / 480)))
        _save(scenes[image_id], root, "src", f"img{image_id}.jpg")
    return pd.DataFrame(rows)


def write_train_dataset(root):
    """The planted training set (module docstring) as JPEG files and a
    CSV-schema dataframe; every class is in TRAIN_IMAGES * 4 / TRAIN_CLASSES
    scenes."""
    rng = np.random.RandomState(1)
    patches = []
    for cid in range(TRAIN_CLASSES):
        patches.append(_patch(rng))
        _save(patches[-1], root, "classes", "images", f"class{cid}.jpg")
    cell = TRAIN_SIZE // 2
    rows = []
    for image_id in range(TRAIN_IMAGES):
        scene = rng.randint(0, 60, (TRAIN_SIZE, TRAIN_SIZE, 3), np.uint8)
        for k in range(4):
            cid = (image_id * 4 + k) % TRAIN_CLASSES
            x0 = (k % 2) * cell + rng.randint(0, cell - PATCH + 1)
            y0 = (k // 2) * cell + rng.randint(0, cell - PATCH + 1)
            scene[y0:y0 + PATCH, x0:x0 + PATCH] = patches[cid]
            rows.append(_row(image_id, f"img{image_id}.jpg", cid, f"class{cid}.jpg", len(rows),
                             (x0 / TRAIN_SIZE, y0 / TRAIN_SIZE, (x0 + PATCH) / TRAIN_SIZE,
                              (y0 + PATCH) / TRAIN_SIZE)))
        _save(scene, root, "src", f"img{image_id}.jpg")
    return pd.DataFrame(rows)


def write_host_dataset(root):
    """HOST_SCENES noise scenes of IMG_W x IMG_H, each with the two planted
    class patches at anchor-aligned positions (x0 = 16k - 112), as JPEG
    files and a CSV-schema dataframe."""
    _, patches = planted_scenes()
    rng = np.random.RandomState(2)
    for cid, patch in enumerate(patches):
        _save(patch, root, "classes", "images", f"class{cid}.jpg")
    rows = []
    for image_id in range(HOST_SCENES):
        scene = rng.randint(0, 60, (IMG_H, IMG_W, 3), np.uint8)
        k = image_id % 8
        for cid, (x0, y0) in enumerate(((48 + 64 * k, 112), (688, 432 + 32 * k))):
            scene[y0:y0 + PATCH, x0:x0 + PATCH] = patches[cid]
            rows.append(_row(image_id, f"img{image_id}.jpg", cid, f"class{cid}.jpg", len(rows),
                             (x0 / IMG_W, y0 / IMG_H, (x0 + PATCH) / IMG_W,
                              (y0 + PATCH) / IMG_H)))
        _save(scene, root, "src", f"img{image_id}.jpg")
    return pd.DataFrame(rows)


def write_image_folder(root):
    """PRETRAIN_CLASSES class directories of PRETRAIN_PER_CLASS 256x320
    JPEGs (a class colour under seeded noise) and an exclusion file naming
    the last class, as tests/test_pretrain.py's folder; returns the
    exclusion file's path."""
    rng = np.random.RandomState(4)
    for c in range(PRETRAIN_CLASSES):
        colour = rng.randint(0, 256, 3)
        for i in range(PRETRAIN_PER_CLASS):
            img = np.clip(colour + rng.randint(-60, 61, (256, 320, 3)), 0, 255).astype(np.uint8)
            path = os.path.join(root, f"n{c:08d}", f"img{i}.JPEG")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(img).save(path, quality=90)
    exclude = os.path.join(root, "exclude.txt")
    with open(exclude, "w") as f:
        f.write(f"n{PRETRAIN_CLASSES - 1:08d}\n")
    return exclude


def write_grozi_planted_tree(data_path):
    """GROZI_PLANTED under data_path in the GroZi layout that
    os2d_torch.data.dataset.build_grozi_dataset reads (grozi/src/3264/*.jpg,
    grozi/classes/grozi.csv, grozi/classes/images)."""
    rng = np.random.RandomState(33)
    root = os.path.join(data_path, "grozi")
    classes = sorted({cid for _, plants in GROZI_PLANTED.values() for _, _, cid in plants})
    patches = {}
    for cid in classes:
        blocks = rng.randint(0, 255, (GROZI_BLOCKS, GROZI_BLOCKS, 3), np.uint8)
        patches[cid] = np.kron(blocks, np.ones((GROZI_SOURCE_BLOCK, GROZI_SOURCE_BLOCK, 1),
                                               np.uint8))
        _save(patches[cid], root, "classes", "images", f"{cid}.jpg")
    w, h = GROZI_SOURCE
    side = GROZI_BLOCKS * GROZI_SOURCE_BLOCK
    to_source = GROZI_SOURCE_BLOCK / GROZI_LEVEL_BLOCK
    rows = []
    for image_id, (split, plants) in sorted(GROZI_PLANTED.items()):
        scene = np.kron(rng.randint(0, 60, (h // 3, w // 3, 3), np.uint8),
                        np.ones((3, 3, 1), np.uint8))
        for x0, y0, cid in plants:
            sx, sy = round(x0 * to_source), round(y0 * to_source)
            scene[sy:sy + side, sx:sx + side] = patches[cid]
            rows.append(_row(image_id, f"{image_id}.jpg", cid, f"{cid}.jpg", len(rows),
                             (sx / w, sy / h, (sx + side) / w, (sy + side) / h), split))
        _save(scene, root, "src", str(GROZI_SOURCE[0]), f"{image_id}.jpg")
    pd.DataFrame(rows).to_csv(os.path.join(root, "classes", "grozi.csv"), index=False)


# ---- datasets, loaders and recipes ----

def dataset(root, df, name, image_size):
    from os2d_torch.data.dataset import DatasetOneShotDetection

    return DatasetOneShotDetection(df, gt_path=os.path.join(root, "classes", "images"),
                                   image_path=os.path.join(root, "src"), name=name,
                                   image_size=image_size, eval_scale=image_size,
                                   cache_images=True)


def planted_eval_loader(root, batch_size=1):
    """The planted dataset written under `root`, read through the port's
    data layer at EVAL_PYRAMID."""
    from os2d_torch.data.dataloader import DataloaderOneShotDetection

    return DataloaderOneShotDetection(dataset(root, write_planted_dataset(root), "planted", 640),
                                      batch_size=batch_size, pyramid_scales_eval=EVAL_PYRAMID)


def train_dataset(root):
    return dataset(root, write_train_dataset(root), "planted-train", TRAIN_SIZE)


def planted_cfg():
    """The config of the planted detections: the defaults, top-k cut to 256
    and 16."""
    from os2d_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 16
    return cfg


def eval_cfg():
    """evaluate() over the planted files: mAP@0.50, TTA "horflip_rotation90"
    (8 views a class), a finite nms_score_threshold (the class prescreen
    runs)."""
    from os2d_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.class_image_augmentation = EVAL_TTA
    cfg.eval.nms_score_threshold = EVAL_SCORE_THRESHOLD
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    return cfg


def train_cfg():
    """get_default_cfg()'s train recipe (batch 4, 600x600 patches,
    class_batch_size 15 padded to 16, class images of 240 px, SGD lr 1e-4,
    momentum 0.9, weight decay 1e-4, max_grad_norm 100, RLL with remapping)
    with TRAIN_STEPS steps, evals with the criterion before and after them,
    and no device class cache."""
    from os2d_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.train.optim.max_iter = TRAIN_STEPS
    cfg.eval.iter = TRAIN_STEPS
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.tpu.device_class_cache = "off"
    return cfg


def normalized(config, images):
    """uint8 HWC arrays normalized as a model of `config` takes its class
    images."""
    mean = torch.tensor(config.normalization_mean)
    std = torch.tensor(config.normalization_std)
    return [(torch.from_numpy(p).float() / 255.0 - mean) / std for p in images]


def norm_of(model):
    return {"mean": model.config.normalization_mean, "std": model.config.normalization_std}


def planted_detections(model, cfg=None):
    """The planted scenes through Evaluator.detect_images at one 640x480
    level, unpacked on the host."""
    from os2d_torch.engine.evaluate import Evaluator, unpack_detections
    from os2d_torch.structures.feature_map import FeatureMapSize

    scenes, patches = planted_scenes()
    ev = Evaluator(model, cfg or planted_cfg())
    head, _ = ev.build_class_heads(normalized(model.config, patches))
    return unpack_detections(ev.detect_images(scenes, head, [FeatureMapSize(w=640, h=480)],
                                              [(1.0, 1.0)], norm_of(model)))


def twin(model_or_state, config=None, device="cpu", folded=False):
    """A model of `config` on `device` holding the weights of a model or a
    state_dict."""
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models.os2d import fold_inference_params

    state = (model_or_state.state_dict() if hasattr(model_or_state, "state_dict")
             else model_or_state)
    if config is None:
        config = model_or_state.config if hasattr(model_or_state, "config") else Os2dConfig()
    m = Os2dModel(config, device=device)
    m.load_state_dict({k: v.to(device) for k, v in state.items()})
    return fold_inference_params(m) if folded else m


def first_step(model, cfg, batch, pixel_format=None, objective=None):
    """One TrainStep of `model` at the recipe on the train batch (RLL's
    margin_pos at FIRST_STEP_MARGIN_POS): its metrics."""
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters

    opt = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    step = TrainStep(model, objective or ObjectiveConfig(margin_pos=FIRST_STEP_MARGIN_POS), opt,
                     cfg.train)
    kwargs = {} if pixel_format is None else {"pixel_format": pixel_format}
    return step(*prepare_batch_arrays(batch, model.device, **kwargs))


def relative_errors(got, want):
    return {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}


# ---- the port's kernel launches ----

def kernels():
    from os2d_torch.ops import (
        frozen_bn,
        group_norm,
        hat_resample,
        int8_resample,
        resample,
        resample_grad,
        roi_align,
    )

    return {"gather": resample.KERNEL, "hat": hat_resample.KERNEL, "int8": int8_resample.KERNEL,
            "backward": resample_grad.KERNEL, "gn_forward": group_norm.FORWARD,
            "gn_backward": group_norm.BACKWARD, "frozen_bn": frozen_bn.KERNEL,
            "roi_align": roi_align.KERNEL}


class Launches(dict):
    """The launches of each of the port's kernels inside a with-block
    (synchronized at its end)."""

    def __enter__(self):
        self._before = {k: v.launches for k, v in kernels().items()}
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.update({k: v.launches - self._before[k] for k, v in kernels().items()})


# ---- comparisons ----

def detections_agree(got, want, box_atol=1e-2, score_atol=1e-4):
    """Every valid detection of `got` has one in `want` of the same image and
    class with score within score_atol and box within box_atol px, and the
    counts match (robust to the order of near-tied scores)."""
    for b in range(got["valid"].shape[0]):
        for g in range(got["valid"].shape[1]):
            gv, wv = got["valid"][b, g], want["valid"][b, g]
            if gv.sum() != wv.sum():
                return False
            ws, wb = want["scores"][b, g][wv], want["boxes"][b, g][wv]
            for s, box in zip(got["scores"][b, g][gv], got["boxes"][b, g][gv]):
                hit = (np.abs(ws - s) <= score_atol) & (np.abs(wb - box).max(-1) <= box_atol)
                if not hit.any():
                    return False
    return True


def planted_found(det):
    """For each planted patch, whether its class's top valid detection of
    its scene lies on it (IoU > 0.5)."""
    from os2d_torch.structures.boxes import box_iou

    found = []
    for image_id, plants in PLANTED.items():
        for x0, y0, cid in plants:
            valid = det["valid"][image_id, cid]
            top = int(np.argmax(np.where(valid, det["scores"][image_id, cid], -np.inf)))
            iou = float(box_iou(torch.tensor(det["boxes"][image_id, cid, top][None]),
                                torch.tensor([[x0, y0, x0 + PATCH, y0 + PATCH]],
                                             dtype=torch.float32)))
            found.append(bool(valid.any()) and iou > 0.5)
    return found


def planted_hits_agree(got, want, score_atol=1e-4, box_atol=1.0):
    """Two detection files of evaluate() (per image: boxes, scores, labels
    and the GT): for every GT box, the best-scoring detection of its class
    that overlaps it (IoU > 0.5) in each, within score_atol and box_atol px
    of each other. Away from the planted patches random weights score
    neighbouring anchors within ~1e-5, so which of them NMS keeps follows
    the last bits and is not compared. Returns (agree, the largest score and
    box differences of the hits)."""
    def iou(boxes, box):
        lt = np.maximum(boxes[:, :2], box[:2])
        rb = np.minimum(boxes[:, 2:], box[2:])
        inter = np.clip(rb - lt, 0, None).prod(-1)
        area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
        return inter / (area(boxes) + area(box) - inter)

    def hit(dets, i, gt_box, label):
        same = dets["labels"][i] == label
        boxes, scores = dets["boxes_xyxy"][i][same], dets["scores"][i][same]
        on = iou(boxes, gt_box) > 0.5 if len(boxes) else np.zeros(0, bool)
        if not on.any():
            return None
        k = int(np.argmax(np.where(on, scores, -np.inf)))
        return scores[k], boxes[k]

    worst = [0.0, 0.0]
    for i, (gt_boxes, gt_labels) in enumerate(zip(want["gt_boxes_xyxy"], want["gt_labels"])):
        for gt_box, label in zip(gt_boxes, gt_labels):
            a, b = hit(got, i, gt_box, label), hit(want, i, gt_box, label)
            if a is None or b is None:
                return False, [float("inf")] * 2
            worst = [max(worst[0], abs(float(a[0] - b[0]))),
                     max(worst[1], float(np.abs(a[1] - b[1]).max()))]
    return worst[0] <= score_atol and worst[1] <= box_atol, worst


def mined_records_disagree(got, want, rtol, atol):
    """The first disagreement between two mining results, or None: image
    ids, the order of the records, roles, levels, labels, anchor indices and
    crop and anchor boxes exactly; loss, loss_loc and score within rtol and
    atol."""
    if list(got) != list(want):
        return f"image ids {list(got)} against {list(want)}"
    for image_id, w_recs in want.items():
        g_recs = got[image_id]
        if len(g_recs) != len(w_recs):
            return f"image {image_id}: {len(g_recs)} records against {len(w_recs)}"
        for i, (g, w) in enumerate(zip(g_recs, w_recs)):
            for key in ("role", "pyramid_level", "label_local", "label_global", "anchor_index"):
                if g[key] != w[key]:
                    return f"image {image_id} record {i}: {key} {g[key]} against {w[key]}"
            for key in ("crop_position_xyxy", "anchor_position_xyxy"):
                if not np.array_equal(g[key], w[key]):
                    return f"image {image_id} record {i}: {key} {g[key]} against {w[key]}"
            for key in ("loss", "loss_loc", "score"):
                if not abs(g[key] - w[key]) <= atol + rtol * abs(w[key]):
                    return f"image {image_id} record {i}: {key} {g[key]} against {w[key]}"
    return None


def reference_layout(state_dict):
    """A port state_dict renamed to the reference's Os2dModel layout (the
    "net" of its checkpoints), with a num_batches_tracked beside every
    BatchNorm, on the CPU."""
    out = {}
    for k, v in state_dict.items():
        head, rest = k.split(".", 1)
        if head == "backbone":
            name = "net_feature_maps." + rest
        elif head == "label_backbone":
            name = "net_label_features.net_class_features." + rest
        else:
            module, field = rest.split(".", 1)
            name = (f"os2d_head_creator.aligner.parameter_regressor."
                    f"{REFERENCE_TRANSFORM_NET[module]}.{field}")
        out[name] = v.detach().to("cpu", copy=True)
        if name.endswith(".running_var"):
            out[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def serve_patches(n, seed):
    """n class patches of PATCH px, 8-px blocks of seeded random colours."""
    rng = np.random.RandomState(seed)
    return [_patch(rng) for _ in range(n)]


def planted_scene(w, h, patch, rng, scale=1.0):
    """A dark noise scene of w x h with `patch` at a random position that
    the service's resize by `scale` puts on the 16-px anchor grid; returns
    (PIL image, planted box [x0, y0, x1, y1])."""
    scene = rng.randint(0, 60, (h, w, 3), np.uint8)
    side = patch.shape[0]

    def position(n):
        k = rng.randint(0, int((n - side) * scale) // 16 + 1)
        return min(int(round(16 * k / scale)), n - side)

    x0, y0 = position(w), position(h)
    scene[y0:y0 + side, x0:x0 + side] = patch
    return Image.fromarray(scene), [x0, y0, x0 + side, y0 + side]


def png_b64(img):
    buf = BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def top_iou(response, w, h, box):
    """IoU of a response's top box (relative coordinates) with `box` (px)."""
    from os2d_torch.structures.boxes import box_iou

    if not response["scores"]:
        return 0.0
    top = torch.tensor([response["bboxes"][0]]) * torch.tensor([w, h, w, h])
    return float(box_iou(top, torch.tensor([box], dtype=torch.float32)))


def responses_agree(got, want, w, h, score_atol=1e-4, box_px=1e-2):
    """Equal detection counts, and each detection of `got` has one in `want`
    with its score within score_atol and its box within box_px pixels."""
    if len(got["scores"]) != len(want["scores"]):
        return False
    scale = np.array([w, h, w, h])
    ws, wb = np.array(want["scores"]), np.array(want["bboxes"]).reshape(-1, 4) * scale
    for s, b in zip(got["scores"], np.array(got["bboxes"]).reshape(-1, 4) * scale):
        if not ((np.abs(ws - s) <= score_atol) & (np.abs(wb - b).max(-1) <= box_px)).any():
            return False
    return True


# ---- one rank of the distributed card test, in a process of its own ----

def distributed_rank(mesh, inputs):
    """The data-parallel TrainSteps from inputs["start_path"]'s weights on
    inputs["batches"] (RLL's margin_pos at FIRST_STEP_MARGIN_POS), then the
    planted eval at "highest" sharded along each of inputs["eval_axes"].
    Returns the step metrics, a digest of the weights, each eval's packed
    detections and mAP@0.50, and each part's kernel launches; rank 0 writes
    its final weights to inputs["final_path"]."""
    import hashlib

    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel

    cfg = inputs["train_cfg"]
    model = Os2dModel(Os2dConfig(), device=mesh.device)
    model.load_state_dict(torch.load(inputs["start_path"], weights_only=True))
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    step = TrainStep(model, ObjectiveConfig(margin_pos=FIRST_STEP_MARGIN_POS), optimizer,
                     cfg.train, mesh=mesh)
    out = {"backend": torch.distributed.get_backend()}
    with Launches() as out["train_launches"]:
        out["metrics"] = [step(*prepare_batch_arrays(b, mesh.device)) for b in inputs["batches"]]
    digest = hashlib.sha256()
    for k, v in model.state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().contiguous().numpy().tobytes())
    out["digest"] = digest.hexdigest()
    if mesh.rank == 0:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   inputs["final_path"])
    del model, step, optimizer

    out["eval"] = {}
    for axis in inputs["eval_axes"]:
        with Launches() as launched:
            out["eval"][axis] = detect_and_evaluate(mesh.device, inputs["eval_root"],
                                                    inputs["eval_df"], axis, mesh)
        out["eval"][axis]["launches"] = launched
    return out


def detect_and_evaluate(device, root, df, axis, mesh=None):
    """The distributed test's eval: the planted set at "highest" (the
    gather kernel), seed 0, both scenes in one batch of 2: the batch through
    Evaluator.detect_images (packed, on the host) and the set through
    evaluate() (its mAP@0.50), sharded along `axis` under a mesh."""
    from os2d_torch.data.dataloader import DataloaderOneShotDetection
    from os2d_torch.engine.evaluate import Evaluator, evaluate
    from os2d_torch.models import Os2dConfig, Os2dModel

    loader = DataloaderOneShotDetection(dataset(root, df, "planted", 640), batch_size=2,
                                        pyramid_scales_eval=EVAL_PYRAMID)
    model = Os2dModel(Os2dConfig(resample_precision="highest"), device=device, seed=0)
    cfg = eval_cfg()
    cfg.eval.batch_size = 2
    cfg.tpu.eval_shard_axis = axis
    evaluator = Evaluator(model, cfg, mesh=mesh)
    class_images, _, _ = loader.get_all_class_images()
    head, views = evaluator.build_class_heads(class_images, cfg.eval.class_image_augmentation)
    _, images, sizes, inv, _ = next(iter(loader.make_raw_iterator_for_all_images(2)))
    packed = evaluator.detect_images(np.stack(images), head, sizes, inv[0],
                                     loader.img_normalization, views)
    return {"packed": packed.cpu().numpy(),
            "mAP@0.50": evaluate(loader, model, cfg, mesh=mesh)["mAP@0.50"]}
