"""Export a one-shot detection dataset to COCO JSON + a query-image manifest,
through the PyTorch port's data layer (twin of export_dataset.py).

The os2d-side interface for external baselines (baselines/README.md): a
dataset of `os2d_torch.data.dataset` (GroZi, retail, INSTRE, ImageNet-RepMet
episodes) as COCO-format JSON and one query JPEG per class, the files that
an external detector or retrieval pipeline reads.
Run: python baselines/export_dataset_torch.py --dataset grozi-val-new-cl --output out/coco
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from os2d_torch.data.dataset import build_dataset_by_name
from os2d_torch.utils.logger import setup_logger


def export(dataset, output_dir):
    """Write <output_dir>/<name>.json and <output_dir>/queries/<classid>.jpg;
    returns (json path, number of images, number of annotations)."""
    os.makedirs(output_dir, exist_ok=True)
    query_dir = os.path.join(output_dir, "queries")
    os.makedirs(query_dir, exist_ok=True)

    class_ids = sorted(int(c) for c in dataset.get_class_ids())
    categories = [{"id": int(cid), "name": f"class_{cid}"} for cid in class_ids]
    for cid in class_ids:
        img = dataset.gt_images_per_classid.get(cid)
        if img is not None:
            img.save(os.path.join(query_dir, f"{cid}.jpg"), quality=95)

    images, annotations = [], []
    ann_id = 0
    for image_id in dataset.image_ids:
        size = dataset.get_image_size_for_image_id(image_id)
        images.append({"id": int(image_id),
                       "file_name": dataset.image_path_per_image_id[image_id],
                       "width": size.w, "height": size.h})
        boxes = dataset.get_image_annotation_for_imageid(image_id)
        labels = boxes.get_field("labels")
        difficult = boxes.get_field("difficult")
        for i in range(len(boxes)):
            x1, y1, x2, y2 = boxes.bbox_xyxy[i]
            annotations.append({
                "id": ann_id,
                "image_id": int(image_id),
                "category_id": int(labels[i]),
                "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                "area": float((x2 - x1) * (y2 - y1)),
                "iscrowd": int(bool(difficult[i])),
            })
            ann_id += 1

    coco = {
        "info": {"description": f"os2d-tpu export of {dataset.get_name()}"},
        "images": images,
        "annotations": annotations,
        "categories": categories,
    }
    out_file = os.path.join(output_dir, f"{dataset.get_name()}.json")
    with open(out_file, "w") as f:
        json.dump(coco, f)
    return out_file, len(images), len(annotations)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export dataset to COCO JSON")
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--data-path", default=os.environ.get("DATA_PATH", "data"))
    parser.add_argument("--eval-scale", type=float, default=None)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    logger = setup_logger("OS2D.export")
    dataset = build_dataset_by_name(args.data_path, args.dataset, eval_scale=args.eval_scale)
    out_file, n_img, n_ann = export(dataset, args.output)
    logger.info(f"Wrote {out_file}: {n_img} images, {n_ann} annotations")


if __name__ == "__main__":
    main()
