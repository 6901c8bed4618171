"""End-to-end demo of the PyTorch port: detect query classes in an input image.

The twin of demo.py (the reference's demo.ipynb, a single image and its
query classes through the staged API: feature extraction, class head, head
application, decoding, visualization), with the same arguments and
`--device` (default cuda; `--device cpu` runs on the CPU):

    python demo_torch.py --input scene.jpg --query a.jpg b.jpg [--checkpoint F]
"""

import argparse

import numpy as np
import torch
from PIL import Image

from os2d_torch.data.dataloader import image_to_normalized_array
from os2d_torch.engine.decode import decode_pyramid
from os2d_torch.models import Os2dConfig, Os2dModel
from os2d_torch.models.checkpoint import load_checkpoint_file
from os2d_torch.structures.feature_map import FeatureMapSize, exact_resize_area
from os2d_torch.utils.logger import setup_logger


def load_image(path):
    with open(path, "rb") as f:
        img = Image.open(f)
        if img.mode != "RGB":
            img = img.convert("RGB")
        img.load()
    return img


@torch.no_grad()
def detect(model, input_pil, query_pils, input_size=1500, class_size=240, score_threshold=0.4):
    """The staged pipeline on one image -> {boxes [N, 4], scores [N], labels
    [N] (the query's index), corners [N, 8]} in the input's pixels, numpy,
    for the detections above score_threshold."""
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    ow, oh = input_pil.size
    ratio = input_size / max(ow, oh)
    resized = input_pil.resize((int(ow * ratio), int(oh * ratio)), Image.BILINEAR)
    img = torch.as_tensor(image_to_normalized_array(resized, norm)[None], device=model.device)

    # (1) the input's feature map, (2) the class head of the queries
    feature_map = model.extract_features(img)
    queries = []
    for q in query_pils:
        qs = exact_resize_area(w=q.size[0], h=q.size[1], target_area_side=class_size)
        queries.append(image_to_normalized_array(q.resize((qs.w, qs.h), Image.BILINEAR), norm))
    class_head = model.build_class_head_from_images(queries)

    # (3) the head, (4) the decode
    out = model.apply_head(feature_map, class_head)
    img_size = FeatureMapSize(w=resized.size[0], h=resized.size[1])
    det = decode_pyramid([out["loc"][0]], [out["cls"][0]], [img_size],
                         [(ow / img_size.w, oh / img_size.h)], nms_iou_threshold=0.3, top_k=64,
                         corners_pyramid=[out["corners"][0]])
    det = {k: v.cpu().numpy() for k, v in det.items()}
    keep = det["valid"] & (det["scores"] > score_threshold)  # [G, K]
    return {"boxes": det["boxes"][keep], "scores": det["scores"][keep],
            "labels": np.nonzero(keep)[0], "corners": det["corners"][keep],
            "feature_map": tuple(feature_map.shape), "class_feats": tuple(class_head.class_feats.shape),
            "resized": resized.size}


def main(argv=None):
    parser = argparse.ArgumentParser(description="OS2D one-shot detection demo (PyTorch port)")
    parser.add_argument("--input", required=True, help="input image")
    parser.add_argument("--query", required=True, nargs="+", help="class images")
    parser.add_argument("--checkpoint", default="", help="model checkpoint")
    parser.add_argument("--input-size", type=int, default=1500,
                        help="longer side for the input image")
    parser.add_argument("--class-size", type=int, default=240)
    parser.add_argument("--score-threshold", type=float, default=0.4)
    parser.add_argument("--max-detections", type=int, default=10)
    parser.add_argument("--output", default="demo_detections.png")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logger = setup_logger("OS2D.demo")
    model_cfg = Os2dConfig()
    model = Os2dModel(model_cfg, device=args.device)
    if args.checkpoint:
        state_dict, _ = load_checkpoint_file(args.checkpoint, model_cfg, model)
        model.load_state_dict(state_dict)
        logger.info(f"Loaded checkpoint {args.checkpoint}")
    else:
        logger.info("No checkpoint provided - using random init (for smoke runs)")

    input_pil = load_image(args.input)
    det = detect(model, input_pil, [load_image(q) for q in args.query],
                 input_size=args.input_size, class_size=args.class_size,
                 score_threshold=args.score_threshold)
    logger.info(f"Input {input_pil.size[0]}x{input_pil.size[1]} -> {det['resized']}")
    logger.info(f"Feature map: {det['feature_map']}")
    logger.info(f"Class feature bank: {det['class_feats']}")
    for s, b, l in zip(det["scores"], det["boxes"], det["labels"]):
        logger.info(f"class {int(l)}: score {s:.3f} box {b.round(1).tolist()}")
    from os2d_torch.utils.visualization import show_detections  # needs matplotlib

    out_path = show_detections(np.asarray(input_pil, np.float32) / 255.0, det["boxes"],
                               det["scores"], det["labels"], corners=det["corners"],
                               max_detections=args.max_detections, save_path=args.output)
    logger.info(f"Saved visualization to {out_path}")
    return det


if __name__ == "__main__":
    main()
