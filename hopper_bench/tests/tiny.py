"""The cells cut to a size the CPU runs in seconds: the traffic's sizes
shrink, the configurations, limits and every other setting stay."""

from pathlib import Path

from hopper_bench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
EVAL = "os2d-v2-r50.eval-c16-b2"
TRAIN = "os2d-v1-r101.train-b4"
TINY = {
    "eval_closed_loop": dict(image_w=320, image_h=256, pyramid_scales=[1.0, 0.55], classes=3,
                             class_chunk=3, class_image_size=64, pool_batches=2,
                             check_requests=2, trace_requests=2, top_k=16, pre_top_k=64),
    "train_steps": dict(batch=2, patch=128, classes=3, class_image_size=64, pool_batches=4,
                        trace_steps=2, gt_box_side=[20, 80]),
}


def tiny_cell(name):
    cell = spec.Cell(spec.load_benchmark(), name)
    cell.traffic.update(TINY[cell.traffic["kind"]])
    return cell
