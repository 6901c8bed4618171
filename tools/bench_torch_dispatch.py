#!/usr/bin/env python3
"""Time the PyTorch port's eval dispatch of several checkouts in turns on
one NVIDIA card.

    python3 tools/bench_torch_dispatch.py --parent DIR [--rounds 2] [--dispatches 6]
    python3 tools/bench_torch_dispatch.py --train --parent DIR [--rounds 2] [--dispatches 6]
    python3 tools/bench_torch_dispatch.py --pretrain --parent DIR [--rounds 2] [--dispatches 6]

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
metrics); one JSON line with the seconds of each step and their median,
and whether two trainings of 3 steps from the same weights on that batch end
with equal losses and weights to the bit; on a checkout whose convolutions
go through `models/resnet.py: conv2d`, also that step with it and with
F.conv2d's own gradients (cuDNN's default algorithms) in turns in one
process.
With --pretrain each run times the ImageNet pretrainer's step
(`pretrain/train_imagenet.py: make_train_step`, ResNet101, 224 px, bf16,
batch 64 of seeded random images, 1000 classes) in the same way.
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
REPEAT_STEPS = 3  # --train: the steps of each of two trainings compared to the bit
# --train on a checkout whose convolutions go through models/resnet.py:
# conv2d: AB_ROUNDS rounds of (conv2d, F.conv2d, F.conv2d, conv2d), AB_STEPS
# timed steps each (after one step that selects the algorithms)
AB_ROUNDS, AB_STEPS = 8, 3


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


def default_recipe_train_arrays(device="cuda"):
    """A prepared batch at the default train recipe's shapes: 4 uint8 images
    of 600x600, 16 classes of 240x240, two ground-truth boxes an image, from
    a fixed generator. Returns (arrays, padded class count)."""
    import torch

    from os2d_torch.engine.decode import default_boxes_for_image_size
    from os2d_torch.structures.feature_map import FeatureMapSize

    b, side, classes = 4, 600, NUM_CLASSES
    gen = torch.Generator(device=device).manual_seed(0)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)

    gt_boxes = torch.zeros((b, 8, 4), device=device)
    gt_boxes[:, 0] = torch.tensor([40.0, 40.0, 280.0, 280.0])
    gt_boxes[:, 1] = torch.tensor([264.0, 248.0, 504.0, 488.0])
    gt_valid = torch.zeros((b, 8), dtype=torch.bool, device=device)
    gt_valid[:, :2] = True
    arrays = {"images": u8(b, side, side, 3), "class_images": u8(classes, 240, 240, 3),
              "class_valid": torch.ones(classes, dtype=torch.bool, device=device),
              "gt_boxes": gt_boxes,
              "gt_labels": torch.tensor([[0, 1] + [-1] * 6] * b, device=device),
              "gt_difficult": torch.zeros((b, 8), dtype=torch.bool, device=device),
              "gt_valid": gt_valid,
              "default_boxes": default_boxes_for_image_size(FeatureMapSize(w=side, h=side),
                                                            device=device)}
    return arrays, classes


def _timed(step, steps):
    import torch

    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def run_train(root, name, steps):
    """Time TrainStep of root/os2d_torch; prints one JSON line."""
    sys.path.insert(0, str(root))
    import numpy as np

    from os2d_torch.config import get_default_cfg
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel

    if not Path(sys.modules["os2d_torch"].__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {sys.modules['os2d_torch'].__file__}, not {root}'s")
    arrays, classes = default_recipe_train_arrays()
    cfg = get_default_cfg()

    def train_step():
        model = Os2dModel(Os2dConfig(), seed=1)
        optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
        return model, TrainStep(model, ObjectiveConfig(margin_pos=1.0), optimizer, cfg.train)

    _, step = train_step()
    times = _timed(lambda: step(arrays, classes), steps)
    del step
    # two trainings of REPEAT_STEPS steps from one seed, compared to the bit
    runs = []
    for _ in range(2):
        model, step = train_step()
        losses = [step(arrays, classes)["loss"] for _ in range(REPEAT_STEPS)]
        runs.append((losses, model.state_dict()))
        del model, step
    (losses_a, state_a), (losses_b, state_b) = runs
    diff = max(float((v - state_b[k]).abs().max()) for k, v in state_a.items())
    out = {"checkout": name, "train_step_s": times, "median_step_s": float(np.median(times)),
           "repeat_steps": REPEAT_STEPS, "repeat_losses_equal": losses_a == losses_b,
           "repeat_weights_bit_equal": diff == 0.0, "repeat_max_weight_diff": diff}
    from os2d_torch.models import resnet, transform_net

    if hasattr(resnet, "conv2d"):
        # the checkout's convolution against F.conv2d's own gradients (cuDNN's
        # default algorithms), in turns in this process on the same step
        import torch.nn.functional as F

        port_conv2d = resnet.conv2d
        _, step = train_step()
        ab = {"port": [], "f_conv2d": []}
        try:
            for _ in range(AB_ROUNDS):
                for arm in ("port", "f_conv2d", "f_conv2d", "port"):
                    resnet.conv2d = transform_net.conv2d = (
                        F.conv2d if arm == "f_conv2d" else port_conv2d)
                    ab[arm] += _timed(lambda: step(arrays, classes), AB_STEPS)
        finally:
            resnet.conv2d = transform_net.conv2d = port_conv2d
        out["in_process_step_s"] = ab
        out["in_process_median_step_s"] = {k: float(np.median(v)) for k, v in ab.items()}
        out["in_process_min_step_s"] = {k: min(v) for k, v in ab.items()}
    print(json.dumps(out), flush=True)


def run_pretrain(root, name, steps):
    """Time the pretrainer's step of root/os2d_torch (ResNet101, 224 px,
    bf16, batch 64 of seeded random images and labels, 1000 classes, its
    ChainSGD); prints one JSON line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from os2d_torch.pretrain import train_imagenet as pretrain

    if not Path(sys.modules["os2d_torch"].__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {sys.modules['os2d_torch'].__file__}, not {root}'s")
    model = pretrain.init_classifier("resnet101", 1000, "cuda", seed=0)
    chain = pretrain.ChainSGD(model.parameters(), pretrain.piecewise_constant_schedule(0.1, {}))
    step = pretrain.make_train_step(model, chain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(64, 224, 224, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (64,), generator=gen, device="cuda")
    times = _timed(lambda: step(images, labels), steps)
    print(json.dumps({"checkout": name, "pretrain_step_s": times,
                      "median_step_s": float(np.median(times))}), flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an unpacked checkout of another commit (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dispatches", type=int, default=6)
    ap.add_argument("--train", action="store_true", help="time TrainStep, not a dispatch")
    ap.add_argument("--pretrain", action="store_true",
                    help="time the pretrainer's step, not a dispatch")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run is not None:
        run = run_train if args.train else run_pretrain if args.pretrain else run_one
        run(args.run, args.name, args.dispatches)
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
                        "--dispatches", str(args.dispatches)] + ["--train"] * args.train
                       + ["--pretrain"] * args.pretrain,
                       check=True, timeout=900)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
