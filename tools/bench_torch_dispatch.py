#!/usr/bin/env python3
"""Time the PyTorch port's eval dispatch of several checkouts in turns on
one NVIDIA card.

    python3 tools/bench_torch_dispatch.py --parent DIR [--rounds 2] [--dispatches 6]
    python3 tools/bench_torch_dispatch.py --train --parent DIR [--rounds 2] [--dispatches 6]

The dispatch is phase `main` of chip_smoke.py: `Evaluator.detect_images` at
the bench.py protocol (B=2 uint8 images of 1280x960, the 7-level pyramid, 16
classes in one chunk, `Os2dConfig()` with seeded random weights, default
tier), synchronized. Each run is its own process on one checkout (this one,
"tree", or an unpacked checkout DIR of another commit, e.g. `git archive` of
the parent), which builds its own kernels under its own build/. Each round
runs parent, tree, tree, parent, so that neither gains from running later.
Each run prints one JSON line: the seconds of the timed dispatches after one
warmup, their median, img/s, and over one more dispatch traced with
torch.profiler the device time (the sum of its CUDA kernels' times), the
device's idle share against the untraced median, the kernel launches and
the 12 kernels that took the most time, and the host's calls of the CUDA
runtime that copy or wait (cudaMemcpyAsync, cudaStreamSynchronize, ...).
With --train each run times `TrainStep` instead, at the default train
recipe's shapes (batch 4 of 600x600 uint8 images, 16 classes of 240x240,
two ground-truth boxes an image, `get_default_cfg()`'s SGD, RLL's margin_pos
at 1.0 so that every positive has a loss) on a synthetic batch from a fixed
generator, `Os2dConfig()` with seed-1 weights: one warmup step, then
--dispatches timed steps (each ends in the step's own wait for its
metrics); one JSON line with the seconds of each step and their median.
The last line is the card's nvidia-smi name and power limit. Needs a card.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
IMG_W, IMG_H = 1280, 960
PYRAMID = [0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6]
NUM_CLASSES = 16
BATCH = 2
# CUDA runtime calls that make the host wait for the device or copy through it
HOST_WAITS = ("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
TOP_KERNELS = 12


def run_one(root, name, dispatches):
    """Time the dispatch of root/os2d_torch; prints one JSON line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.evaluate import Evaluator
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.structures.feature_map import FeatureMapSize

    if not Path(sys.modules["os2d_torch"].__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {sys.modules['os2d_torch'].__file__}, not {root}'s")
    model = Os2dModel(Os2dConfig(), seed=0)
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = NUM_CLASSES
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    sizes = [FeatureMapSize(w=int(IMG_W * s), h=int(IMG_H * s)) for s in PYRAMID]
    inv = [(IMG_W / sz.w, IMG_H / sz.h) for sz in sizes]
    rng = np.random.RandomState(0)
    class_images = [rng.randn(240, 240, 3).astype(np.float32) for _ in range(NUM_CLASSES)]
    batches = [np.random.RandomState(i).randint(0, 255, (BATCH, IMG_H, IMG_W, 3), np.uint8)
               for i in range(dispatches + 1)]
    ev = Evaluator(model, cfg)
    class_head, _ = ev.build_class_heads(class_images)
    ev.detect_images(batches[-1], class_head, sizes, inv, norm)
    torch.cuda.synchronize()
    times = []
    for i in range(dispatches):
        t0 = time.perf_counter()
        ev.detect_images(batches[i], class_head, sizes, inv, norm)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median = float(np.median(times))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.detect_images(batches[0], class_head, sizes, inv, norm)
        torch.cuda.synchronize()
    # chip_smoke.py of this checkout, not of `root`, tells ranges from kernels
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kernels, waits = [], {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and not smoke.is_annotation(evt):
            us = getattr(evt, "device_time_total", 0) or getattr(evt, "cuda_time_total", 0)
            kernels.append((us / 1e3, evt.key, evt.count))
        elif evt.key.startswith(HOST_WAITS):
            waits[evt.key] = waits.get(evt.key, 0) + evt.count
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    print(json.dumps({"checkout": name, "dispatch_s": times, "median_dispatch_s": median,
                      "img_per_s": BATCH / median,
                      "img_per_s_spread": [BATCH / max(times), BATCH / min(times)],
                      "device_ms": device_ms,
                      "device_idle_share": 1 - device_ms / (median * 1e3),
                      "host_waits_per_dispatch": waits,
                      "kernel_launches": sum(k[2] for k in kernels),
                      "top": [{"kernel": k[:100], "ms": ms, "calls": n}
                              for ms, k, n in kernels[:TOP_KERNELS]]}), flush=True)


def run_train(root, name, steps):
    """Time TrainStep of root/os2d_torch; prints one JSON line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.decode import default_boxes_for_image_size
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.structures.feature_map import FeatureMapSize

    if not Path(sys.modules["os2d_torch"].__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {sys.modules['os2d_torch'].__file__}, not {root}'s")
    b, side, classes = 4, 600, NUM_CLASSES
    gen = torch.Generator(device="cuda").manual_seed(0)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)

    gt_boxes = torch.zeros((b, 8, 4), device="cuda")
    gt_boxes[:, 0] = torch.tensor([40.0, 40.0, 280.0, 280.0])
    gt_boxes[:, 1] = torch.tensor([264.0, 248.0, 504.0, 488.0])
    gt_valid = torch.zeros((b, 8), dtype=torch.bool, device="cuda")
    gt_valid[:, :2] = True
    arrays = {"images": u8(b, side, side, 3), "class_images": u8(classes, 240, 240, 3),
              "class_valid": torch.ones(classes, dtype=torch.bool, device="cuda"),
              "gt_boxes": gt_boxes,
              "gt_labels": torch.tensor([[0, 1] + [-1] * 6] * b, device="cuda"),
              "gt_difficult": torch.zeros((b, 8), dtype=torch.bool, device="cuda"),
              "gt_valid": gt_valid,
              "default_boxes": default_boxes_for_image_size(FeatureMapSize(w=side, h=side),
                                                            device="cuda")}
    cfg = get_default_cfg()
    model = Os2dModel(Os2dConfig(), seed=1)
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    step = TrainStep(model, ObjectiveConfig(margin_pos=1.0), optimizer, cfg.train)
    step(arrays, classes)
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(arrays, classes)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(json.dumps({"checkout": name, "train_step_s": times,
                      "median_step_s": float(np.median(times))}), flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an unpacked checkout of another commit (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dispatches", type=int, default=6)
    ap.add_argument("--train", action="store_true", help="time TrainStep, not a dispatch")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run is not None:
        (run_train if args.train else run_one)(args.run, args.name, args.dispatches)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_dispatch: needs an NVIDIA card", file=sys.stderr)
        return 1
    order = []
    for _ in range(args.rounds):
        for parent in args.parent:
            order += [(parent, parent.name), (ROOT, "tree"), (ROOT, "tree"), (parent, parent.name)]
    if not args.parent:
        order = [(ROOT, "tree")] * args.rounds
    for root, name in order:
        subprocess.run([sys.executable, __file__, "--run", str(root.resolve()), "--name", name,
                        "--dispatches", str(args.dispatches)] + ["--train"] * args.train,
                       check=True, timeout=900)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
