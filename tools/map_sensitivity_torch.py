"""mAP gate of the PyTorch port's eval numeric modes: the twin of
tools/map_sensitivity.py for `os2d_torch`.

It builds the same synthetic detection task (planted, scale-jittered,
noise-blended class patches, seed 0), trains the port's model on it for
`--train-steps` steps at fp32 (batch 4, 480x480 patches, SGD, lr 1e-4), then
evaluates the SAME weights under each numeric config and prints, per config:
mAP@0.50, dmAP against "fp32_high", the matched detections' score deltas
(mean, max), the match IoU and the unmatched count. A mode is mAP-safe when
dmAP is 0 and the score deltas stay well below the score scale (~1).

Configs: the JAX tool's five, fp32_high, fp32_default, bf16_fold_default,
fp32_high_int8bank (the int8 class bank, cfg.tpu.quantize_class_feats) and
fp32_default_noperm (the natural channel order and the grid path,
corr_interior_first=False), plus the port's fp32_fold_default and
bf16_default (unfolded).

    python3 tools/map_sensitivity_torch.py                 # one card
    python3 tools/map_sensitivity_torch.py --device cpu --train-steps 2 \\
        --image-size 320 240 --num-images 2 --scales 1     # a small CPU run

Imports only os2d_torch, numpy, PIL and pandas. The last line is one JSON
object with every number printed.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np
from PIL import Image

IMG_W, IMG_H = 960, 720
PATCH = 240
NUM_CLASSES = 8
NUM_IMAGES = 6

# the five configs of tools/map_sensitivity.py, then the port's two
CONFIGS = {
    "fp32_high": dict(compute_dtype="float32", resample_precision="high"),
    "fp32_default": dict(compute_dtype="float32", resample_precision="default"),
    "bf16_fold_default": dict(compute_dtype="bfloat16", resample_precision="default",
                              fold_bn=True),
    "fp32_high_int8bank": dict(compute_dtype="float32", resample_precision="high",
                               quantize=True),
    "fp32_default_noperm": dict(compute_dtype="float32", resample_precision="default",
                                corr_interior_first=False),
    "fp32_fold_default": dict(compute_dtype="float32", resample_precision="default",
                              fold_bn=True),
    "bf16_default": dict(compute_dtype="bfloat16", resample_precision="default"),
}


def make_dataset(root, rng, jitter=True, img_w=IMG_W, img_h=IMG_H, num_images=NUM_IMAGES):
    """Planted textured patches with scale jitter and noise, so detection
    scores are not saturated at 1.0; the draws of tools/map_sensitivity.py,
    so at the default sizes the files and the dataframe are the same."""
    import pandas as pd

    os.makedirs(os.path.join(root, "classes", "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "src"), exist_ok=True)
    patches = {}
    for cid in range(NUM_CLASSES):
        p = rng.randint(0, 255, (PATCH // 8, PATCH // 8, 3), np.uint8)
        patches[cid] = np.kron(p, np.ones((8, 8, 1), np.uint8))
        Image.fromarray(patches[cid]).save(
            os.path.join(root, "classes", "images", f"class{cid}.jpg"), quality=95)
    rows = []
    for image_id in range(num_images):
        img = rng.randint(0, 120, (img_h, img_w, 3), np.uint8)
        for _ in range(3):
            cid = int(rng.randint(NUM_CLASSES))
            scale = rng.uniform(0.8, 1.25) if jitter else 1.0
            size = min(int(PATCH * scale), img_w - 1, img_h - 1)
            x0 = int(rng.randint(0, img_w - size))
            y0 = int(rng.randint(0, img_h - size))
            patch = np.asarray(Image.fromarray(patches[cid]).resize((size, size), Image.BILINEAR))
            # blended into the scene: correlation high but not exact
            noise = rng.randint(-20, 20, patch.shape).astype(np.int16)
            img[y0:y0 + size, x0:x0 + size] = np.clip(
                patch.astype(np.int16) + noise, 0, 255).astype(np.uint8)
            rows.append(dict(imageid=image_id, imagefilename=f"img{image_id}.jpg",
                             classid=cid, classfilename=f"class{cid}.jpg",
                             gtbboxid=len(rows), difficult=0,
                             lx=x0 / img_w, ty=y0 / img_h,
                             rx=(x0 + size) / img_w, by=(y0 + size) / img_h,
                             split="train"))
        Image.fromarray(img).save(os.path.join(root, "src", f"img{image_id}.jpg"), quality=95)
    return pd.DataFrame(rows)


def match_detections(ref, cur):
    """Greedy per-class matching of current detections to reference ones
    (each a list of (boxes, scores, labels) per image).

    Returns (score deltas of matched pairs, IoUs of matched pairs, n_unmatched).
    """
    from os2d_torch.data.voc_eval import _box_iou_np

    deltas, ious, unmatched = [], [], 0
    for (rb, rs, rl), (cb, cs, cl) in zip(ref, cur):
        for lab in np.unique(rl):
            r_idx = np.where(rl == lab)[0]
            c_idx = np.where(cl == lab)[0]
            if len(c_idx) == 0:
                unmatched += len(r_idx)
                continue
            iou = _box_iou_np(rb[r_idx], cb[c_idx])
            for i_r in np.argsort(-rs[r_idx]):
                j = int(np.argmax(iou[i_r]))
                if iou[i_r, j] > 0.5:
                    deltas.append(abs(rs[r_idx[i_r]] - cs[c_idx[j]]))
                    ious.append(iou[i_r, j])
                    iou[:, j] = -1
                else:
                    unmatched += 1
    return np.asarray(deltas), np.asarray(ious), unmatched


def train(dataset, args, logger):
    """The port's model trained at fp32 for args.train_steps steps, under
    cuDNN's deterministic algorithms (so that a seed gives one trained
    state, and the configs' dmAPs repeat from run to run); returns its
    state_dict."""
    import torch

    from os2d_torch.config import get_default_cfg
    from os2d_torch.data.dataloader import build_train_dataloader_from_config
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, train_one_batch, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel

    model = Os2dModel(Os2dConfig(), device=args.device, seed=0)
    if args.train_steps > 0:
        cfg = get_default_cfg()
        cfg.train.batch_size = args.batch_size
        cfg.train.class_batch_size = NUM_CLASSES
        cfg.train.augment.train_patch_width = args.train_patch
        cfg.train.augment.train_patch_height = args.train_patch
        cfg.train.optim.lr = 1e-4
        loader, _ = build_train_dataloader_from_config(cfg, dataset, seed=0)
        optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
        step = TrainStep(model, ObjectiveConfig(), optimizer, cfg.train)
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        t0 = time.time()
        try:
            for i in range(args.train_steps):
                meters = train_one_batch(loader.get_batch(i % len(loader)), step, logger)
                if i % 50 == 0:
                    print(f"train step {i}: loss={meters['loss']:.4f}", flush=True)
        finally:
            torch.backends.cudnn.deterministic = saved
        print(f"trained {args.train_steps} steps in {time.time() - t0:.1f}s, "
              f"final loss {meters['loss']:.4f}", flush=True)
        model.train_mode(False)
    return model.state_dict()


def evaluate_configs(dataset, state, args):
    """The same weights under each config -> ({name: results}, {name:
    detections as (boxes, scores, labels) per image})."""
    from os2d_torch.config import get_default_cfg
    from os2d_torch.data.dataloader import DataloaderOneShotDetection
    from os2d_torch.engine.evaluate import evaluate
    from os2d_torch.models import Os2dConfig, Os2dModel

    lo = max(0.6, 1.0 - 0.2 * (args.scales // 2))
    scales = list(np.linspace(lo, 2.0 - lo, args.scales))
    eval_loader = DataloaderOneShotDetection(dataset=dataset, batch_size=1,
                                             pyramid_scales_eval=scales)
    results, detections = {}, {}
    for name, nc in CONFIGS.items():
        cfg = get_default_cfg()
        cfg.eval.mAP_iou_thresholds = [0.5]
        cfg.tpu.eval_class_chunk = NUM_CLASSES
        cfg.tpu.fold_bn = bool(nc.get("fold_bn", False))
        cfg.tpu.quantize_class_feats = bool(nc.get("quantize", False))
        save_dir = os.path.join(args.root, f"dets_{name}")
        cfg.visualization.eval.path_to_save_detections = save_dir
        model = Os2dModel(Os2dConfig(compute_dtype=nc["compute_dtype"],
                                     resample_precision=nc["resample_precision"],
                                     corr_interior_first=nc.get("corr_interior_first", True)),
                          device=args.device)
        model.load_state_dict(state)
        t0 = time.time()
        results[name] = evaluate(eval_loader, model, cfg)
        results[name]["seconds"] = time.time() - t0
        with open(os.path.join(save_dir, f"{dataset.name}_detections.pkl"), "rb") as f:
            d = pickle.load(f)
        detections[name] = list(zip(d["boxes_xyxy"], d["scores"], d["labels"]))
        print(f"{name}: mAP@0.50={results[name]['mAP@0.50']:.4f} "
              f"recall={results[name]['recall@0.50']:.4f}", flush=True)
    return results, detections


def gate(results, detections):
    """Per config against fp32_high: dmAP, score deltas, match IoU, unmatched."""
    base = detections["fp32_high"]
    n_base = sum(len(b[1]) for b in base)
    rows = {}
    for name in CONFIGS:
        if name == "fp32_high":
            continue
        deltas, ious, unmatched = match_detections(base, detections[name])
        rows[name] = {
            "mAP@0.50": results[name]["mAP@0.50"],
            "dmAP": results[name]["mAP@0.50"] - results["fp32_high"]["mAP@0.50"],
            "score_delta_mean": float(deltas.mean()) if len(deltas) else 0.0,
            "score_delta_max": float(deltas.max()) if len(deltas) else 0.0,
            "match_iou_mean": float(ious.mean()) if len(ious) else 0.0,
            "unmatched": unmatched, "reference_detections": n_base,
        }
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--scales", type=int, default=3, help="pyramid levels around 1.0 for eval")
    ap.add_argument("--root", default=os.path.join("build", "map_sensitivity_torch"),
                    help="where the dataset and the detections are written")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--train-patch", type=int, default=480)
    ap.add_argument("--image-size", type=int, nargs=2, default=(IMG_W, IMG_H),
                    metavar=("W", "H"))
    ap.add_argument("--num-images", type=int, default=NUM_IMAGES)
    args = ap.parse_args(argv)

    from os2d_torch.data.dataset import DatasetOneShotDetection
    from os2d_torch.utils.logger import setup_logger

    logger = setup_logger("OS2D.sens", None)
    os.makedirs(args.root, exist_ok=True)
    img_w, img_h = args.image_size
    df = make_dataset(args.root, np.random.RandomState(0), img_w=img_w, img_h=img_h,
                      num_images=args.num_images)
    dataset = DatasetOneShotDetection(
        df, gt_path=os.path.join(args.root, "classes", "images"),
        image_path=os.path.join(args.root, "src"), name="sens", image_size=img_w,
        eval_scale=img_w, cache_images=True)

    state = train(dataset, args, logger)
    results, detections = evaluate_configs(dataset, state, args)
    rows = gate(results, detections)
    print("\n=== deltas vs fp32_high ===")
    for name, r in rows.items():
        print(f"{name}: dmAP={r['dmAP']:+.4f} score_delta mean={r['score_delta_mean']:.2e} "
              f"max={r['score_delta_max']:.2e} match_iou_mean={r['match_iou_mean']:.4f} "
              f"unmatched={r['unmatched']}/{r['reference_detections']}")
    device = args.device
    if device.startswith("cuda"):
        device = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": device, "train_steps": args.train_steps,
                      "fp32_high": {"mAP@0.50": results["fp32_high"]["mAP@0.50"]},
                      **rows,
                      "eval_seconds": {k: v["seconds"] for k, v in results.items()}}))
    return rows


if __name__ == "__main__":
    main()
