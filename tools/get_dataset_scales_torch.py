"""Per-dataset eval scales that bring the median object to ~240 px, over the
port's datasets: the twin of tools/get_dataset_scales.py (the reference's
data/get_dataset_scales.py:1-66) on `os2d_torch.data.dataset.
build_dataset_by_name`.

    python tools/get_dataset_scales_torch.py [--data-path DIR] [--datasets NAME ...]

For each dataset it measures the (non-difficult) GT object sizes at the
stored image size and reports the image scale at which the median object
has the anchor's size (240 px).
"""

import argparse
import math
import os
import sys
from collections import OrderedDict

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from os2d_torch.data.dataset import build_dataset_by_name  # noqa: E402
from os2d_torch.structures.feature_map import FeatureMapSize  # noqa: E402
from os2d_torch.utils.logger import setup_logger  # noqa: E402

DATASET_LIST = [
    "grozi-train", "grozi-val-new-cl", "dairy", "paste-v", "paste-f",
    "instre-s1-train", "instre-s1-val", "instre-s2-train", "instre-s2-val",
]


def get_image_sizes(dataset):
    sizes = OrderedDict()
    images = dataset.gtboxframe.groupby(["imageid", "imagefilename"]).size().reset_index()
    for _, datum in images.iterrows():
        img = dataset._get_dataset_image_by_id(datum["imageid"])
        sizes[datum["imageid"]] = FeatureMapSize.from_image(img)
    return sizes


def compute_object_size_stats(gtboxframe, image_sizes_by_id):
    """(mean, median, 10th and 90th percentile) of sqrt(box area) in pixels
    over the non-difficult boxes."""
    object_sizes = []
    for _, datum in gtboxframe.iterrows():
        img_size = image_sizes_by_id[datum["imageid"]]
        box_w = (datum["rx"] - datum["lx"]) * img_size.w
        box_h = (datum["by"] - datum["ty"]) * img_size.h
        if not datum["difficult"]:
            object_sizes.append(math.sqrt(max(box_w * box_h, 0.0)))
    object_sizes.sort()
    n = len(object_sizes)
    return (sum(object_sizes) / n, object_sizes[n // 2], object_sizes[n // 10],
            object_sizes[n * 9 // 10])


def dataset_scale(data_path, name, target_object_size=240):
    """{avg, median, q10, q90, image_size, eval_scale} of one dataset."""
    dataset = build_dataset_by_name(data_path, name, eval_scale=None)
    avg, median, q10, q90 = compute_object_size_stats(dataset.gtboxframe,
                                                      get_image_sizes(dataset))
    return {"avg": avg, "median": median, "q10": q10, "q90": q90,
            "image_size": dataset.image_size,
            "eval_scale": int(dataset.image_size * target_object_size / median)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-path", default=os.environ.get("DATA_PATH", "data"))
    parser.add_argument("--target-object-size", type=int, default=240)
    parser.add_argument("--datasets", nargs="+", default=DATASET_LIST)
    args = parser.parse_args(argv)

    logger = setup_logger("get_dataset_scales")
    results = {}
    for name in args.datasets:
        try:
            r = dataset_scale(args.data_path, name, args.target_object_size)
        except (FileNotFoundError, OSError) as e:
            logger.warning(f"Skipping {name}: {e}")
            continue
        results[name] = r
        logger.info(f"{name}: avg object {r['avg']:0.1f}px (median {r['median']:0.1f}, "
                    f"q10 {r['q10']:0.1f}, q90 {r['q90']:0.1f}) at image size {r['image_size']}")
        logger.info(f"{name}: recommended eval scale = {r['eval_scale']}")
    return results


if __name__ == "__main__":
    main()
