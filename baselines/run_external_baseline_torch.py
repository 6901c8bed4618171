"""End-to-end external-baseline demo through the PyTorch port (twin of
run_external_baseline.py): the COCO-export + VOC-eval interface that replaces
the reference's per-baseline dataset adapters
(baselines/detector_retrieval/detector/detector_data.py:20-76 and
baselines/CoAE/lib/datasets/os2d.py:20-80 in the reference).

Flow (the same three-step contract an external detector integration uses):
  1. export a dataset of the port to COCO JSON + query-image manifest
     (baselines/export_dataset_torch.py) — the ONLY thing the external side
     sees;
  2. run an off-the-shelf detector on the exported files: a self-contained
     multi-scale normalized-cross-correlation template matcher in plain torch
     (CPU), the same code as run_external_baseline.py's, independent of
     either package's model stack; it reads the COCO JSON and the query
     JPEGs from disk and emits detections in the COCO results format;
  3. score the COCO-format detections with the port's VOC evaluator
     (os2d_torch/data/voc_eval.py), the protocol OS2D itself is scored with
     (difficult handling, +1px convention).

Run: python baselines/run_external_baseline_torch.py [--root DIR]
With no --root, a synthetic planted-patch dataset is generated (the scenes of
tests/test_end_to_end_eval.py, same seed), so the demo runs anywhere. Exit
code 0 iff mAP@0.5 >= 0.5 on it.
"""

import argparse
import json
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

IMG_W, IMG_H = 640, 480
PATCH = 240
PLANTED = {0: [(48, 48, 0)], 1: [(336, 176, 1), (48, 112, 0)]}


# ---------------------------------------------------------------------------
# step 2: the "external detector" — template matching over the COCO export.
# Touches ONLY files produced by export_dataset_torch.py (no os2d imports).
# ---------------------------------------------------------------------------

def run_template_matching_detector(coco_json, query_dir, image_root,
                                   scales=(0.8, 1.0, 1.25), score_min=0.3,
                                   downsample=4):
    import torch
    import torch.nn.functional as F

    with open(coco_json) as f:
        coco = json.load(f)

    queries = {}
    for cat in coco["categories"]:
        qpath = os.path.join(query_dir, f"{cat['id']}.jpg")
        if os.path.isfile(qpath):
            q = np.asarray(Image.open(qpath).convert("RGB"), np.float32) / 255.0
            queries[cat["id"]] = torch.as_tensor(q).permute(2, 0, 1)

    d = downsample  # match at reduced resolution (CPU budget), report full-res
    results = []
    for im in coco["images"]:
        path = im["file_name"]
        if not os.path.isabs(path):
            path = os.path.join(image_root, path)
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        x = torch.as_tensor(img).permute(2, 0, 1)[None]  # [1, 3, H, W]
        x = F.avg_pool2d(x, d)
        x = x - x.mean()
        for cid, q in queries.items():
            qs = F.avg_pool2d(q[None], d)[0]
            for s in scales:
                th = max(4, int(round(qs.shape[1] * s)))
                tw = max(4, int(round(qs.shape[2] * s)))
                if th > x.shape[2] or tw > x.shape[3]:
                    continue
                t = F.interpolate(qs[None], size=(th, tw), mode="bilinear",
                                  align_corners=False)[0]
                t = t - t.mean()
                t = t / (t.norm() + 1e-6)
                # normalized cross-correlation: corr / local L2 norm
                corr = F.conv2d(x, t[None])  # [1, 1, H', W']
                sq = F.conv2d(x * x, torch.ones_like(t)[None])
                ncc = corr / (sq.clamp_min(1e-6).sqrt())
                v, idx = ncc.flatten().max(dim=0)
                score = float(v)
                if score < score_min:
                    continue
                wo = ncc.shape[-1]
                y0, x0 = divmod(int(idx), wo)
                results.append(
                    {
                        "image_id": im["id"],
                        "category_id": cid,
                        "bbox": [float(x0 * d), float(y0 * d),
                                 float(tw * d), float(th * d)],
                        "score": score,
                    }
                )
    return results


# ---------------------------------------------------------------------------
# step 3: score COCO-format detections with the port's VOC evaluator
# ---------------------------------------------------------------------------

def score_coco_results(coco_json, results):
    from os2d_torch.data.voc_eval import do_voc_evaluation

    with open(coco_json) as f:
        coco = json.load(f)
    cat_ids = sorted(c["id"] for c in coco["categories"])
    cat_to_local = {cid: i for i, cid in enumerate(cat_ids)}

    gt_by_img = {im["id"]: {"boxes": [], "labels": [], "difficult": []}
                 for im in coco["images"]}
    for ann in coco["annotations"]:
        g = gt_by_img[ann["image_id"]]
        x, y, w, h = ann["bbox"]
        g["boxes"].append([x, y, x + w, y + h])
        g["labels"].append(cat_to_local[ann["category_id"]])
        g["difficult"].append(bool(ann.get("iscrowd", 0)))

    det_by_img = {im["id"]: {"boxes": [], "labels": [], "scores": []}
                  for im in coco["images"]}
    for r in results:
        d = det_by_img[r["image_id"]]
        x, y, w, h = r["bbox"]
        d["boxes"].append([x, y, x + w, y + h])
        d["labels"].append(cat_to_local[r["category_id"]])
        d["scores"].append(r["score"])

    predictions, gt = [], []
    for im in coco["images"]:
        d, g = det_by_img[im["id"]], gt_by_img[im["id"]]
        predictions.append(
            {
                "boxes": np.asarray(d["boxes"], np.float32).reshape(-1, 4),
                "labels": np.asarray(d["labels"], np.int64),
                "scores": np.asarray(d["scores"], np.float32),
            }
        )
        gt.append(
            {
                "boxes": np.asarray(g["boxes"], np.float32).reshape(-1, 4),
                "labels": np.asarray(g["labels"], np.int64),
                "difficult": np.asarray(g["difficult"], bool),
            }
        )
    return do_voc_evaluation(predictions, gt, iou_thresh=0.5)


def make_synthetic_dataset(root):
    """Two 640x480 noise scenes with the blocky 240-px class patches planted
    at anchor-aligned positions, as JPEG files and a CSV-schema dataframe
    (tests/test_end_to_end_eval.py's make_synthetic_dataset: same seed, same
    draws, same files)."""
    import pandas as pd

    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "classes", "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "src"), exist_ok=True)
    class_patches = {}
    for cid in (0, 1):
        patch = rng.randint(0, 255, (PATCH // 8, PATCH // 8, 3), np.uint8)
        class_patches[cid] = np.kron(patch, np.ones((8, 8, 1), np.uint8))
        Image.fromarray(class_patches[cid]).save(
            os.path.join(root, "classes", "images", f"class{cid}.jpg"), quality=95)
    rows = []
    for image_id, plants in PLANTED.items():
        img = rng.randint(0, 60, (IMG_H, IMG_W, 3), np.uint8)
        for (x0, y0, cid) in plants:
            img[y0: y0 + PATCH, x0: x0 + PATCH] = class_patches[cid]
            rows.append(dict(imageid=image_id, imagefilename=f"img{image_id}.jpg",
                             classid=cid, classfilename=f"class{cid}.jpg",
                             gtbboxid=len(rows), difficult=0,
                             lx=x0 / IMG_W, ty=y0 / IMG_H,
                             rx=(x0 + PATCH) / IMG_W, by=(y0 + PATCH) / IMG_H))
        Image.fromarray(img).save(os.path.join(root, "src", f"img{image_id}.jpg"), quality=95)
    return pd.DataFrame(rows)


def run_demo(root, output_dir):
    """Synthetic dataset -> COCO export -> external detector -> VOC score."""
    from os2d_torch.data.dataset import DatasetOneShotDetection

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from export_dataset_torch import export

    df = make_synthetic_dataset(root)
    dataset = DatasetOneShotDetection(
        df,
        gt_path=os.path.join(root, "classes", "images"),
        image_path=os.path.join(root, "src"),
        name="synth-baseline-demo",
        image_size=IMG_W,
        eval_scale=IMG_W,
        cache_images=True,
    )
    coco_json, n_img, n_ann = export(dataset, output_dir)
    results = run_template_matching_detector(
        coco_json, os.path.join(output_dir, "queries"),
        os.path.join(root, "src"),
    )
    res_file = os.path.join(output_dir, "external_detections.json")
    with open(res_file, "w") as f:
        json.dump(results, f)
    metrics = score_coco_results(coco_json, results)
    return coco_json, res_file, metrics


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default="",
                        help="dataset root (default: generate synthetic)")
    parser.add_argument("--output", default="out/baseline_demo")
    args = parser.parse_args(argv)

    import tempfile

    root = args.root or tempfile.mkdtemp(prefix="os2d_baseline_demo_")
    coco_json, res_file, metrics = run_demo(root, args.output)
    print(f"COCO export: {coco_json}")
    print(f"external detections: {res_file}")
    print(f"mAP@0.5 = {metrics['map']:.4f} "
          f"(per-class AP: {np.round(metrics['ap_per_class'], 3)})")
    sys.exit(0 if metrics["map"] >= 0.5 else 1)


if __name__ == "__main__":
    main()
